"""Asset loading (`rpt_tpu/io`): Wavefront .OBJ and .MTL so far."""

from .obj import load_mtl, load_obj, load_obj_with_mtl

__all__ = ["load_obj", "load_obj_with_mtl", "load_mtl"]
