"""The ray arithmetic of every rate (`rpt_tpu_torch/profiling.py`
`rays_per_sample`, copied): one closest-hit ray per path depth, plus one
shadow ray per shadow-casting light per depth, for every pixel and sample."""

from __future__ import annotations

from portbench.spec import SceneSpec


def rays_per_sample(bounces: int, shadow_lights: int) -> int:
    return (bounces + 1) * (1 + shadow_lights)


def frame_rays(spec: SceneSpec, spp: int) -> int:
    return rays_per_sample(spec.max_bounces, spec.shadow_lights()) * spec.width * spec.height * spp
