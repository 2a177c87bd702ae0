"""The example programs of `examples/`, on the port.

One module per script, with the script's name, flags, defaults and
functions (`build_scene(...)`, `make_camera()`, ...), each ending in the
script's `Renderer(...)` call. Each runs as

    python -m rpt_tpu_torch.examples.<name> [the script's flags] [--device DEVICE]

and exposes `main(argv=None)`, which returns the (last) image it saved. The
render runs on the CUDA card unless `--device` names another device
(`--device cpu` takes the plain torch path); without a card and without
`--device` it raises. Images are written with `io.image.save_png` and HDRIs
read with `io.image.load_hdr`; meshes and HDRIs are read from the same files,
at the same default paths, as the scripts read them.
"""
