"""The system under test: a cell's `SceneSpec` as an `rpt_tpu_torch.Renderer`,
made through the port's public constructors only (`Scene`, `Object`,
`Material`, `Mesh`, `plane`, `sphere`, `PointLight`, `ObjectLight`,
`Environment`, `Camera`), as a user's script makes it."""

from __future__ import annotations

from portbench.spec import SceneSpec


def renderer(spec: SceneSpec, device):
    """The `Renderer` of `spec` on `device` (float32, no filter)."""
    import rpt_tpu_torch as rt

    scene = rt.Scene()
    if spec.hdri is not None:
        scene.set_environment(rt.Environment.from_hdri(spec.hdri))
    elif any(spec.env_color):
        scene.set_environment(rt.Environment.from_color(spec.env_color))
    meshes = [rt.Mesh(m.vertices, m.normals) for m in spec.meshes]
    for o in spec.objects:
        m = o.material
        mat = rt.Material(color=tuple(m.color), index=m.index, roughness=m.roughness, metallic=m.metallic,
                          emittance=m.emittance, transparent=m.transparent)
        shape = rt.plane(list(o.normal), o.value) if o.mesh is None else meshes[o.mesh].transform(o.matrix)
        scene.add(rt.Object(shape, mat))
    for light in spec.lights:
        if light.kind == "point":
            scene.add(rt.PointLight(light.color, light.position))
        elif light.kind == "sphere":
            emitter = rt.Object(rt.sphere().transform(light.matrix), rt.Material.light(light.color, light.emittance))
            scene.add(rt.ObjectLight(emitter))
        else:
            raise ValueError(f"unknown light kind {light.kind!r}")
    cam = spec.camera
    camera = rt.Camera.look_at(cam.eye, cam.center, cam.up, cam.fov)
    return rt.Renderer(scene, camera, width=spec.width, height=spec.height, exposure_value=spec.exposure_value,
                       max_bounces=spec.max_bounces, num_samples=spec.spp, epsilon=spec.epsilon, device=device)
