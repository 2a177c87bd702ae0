"""Asset loading (`rpt_tpu/io`): Wavefront .OBJ and .MTL, STL, and
Radiance .hdr / PNG images."""

from .image import load_hdr, save_hdr, save_png
from .obj import load_mtl, load_obj, load_obj_with_mtl
from .stl import load_stl

__all__ = ["load_obj", "load_obj_with_mtl", "load_mtl", "load_stl", "load_hdr", "save_hdr", "save_png"]
