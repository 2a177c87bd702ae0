"""The inputs of a cell, as plain numpy: what both sides are handed.

A configuration's builder (`configs/<name>.py`) makes a `SceneSpec`. The
harness turns it into the port's scene through the port's public
constructors (`portbench.port`), and the plain reference
(`portbench.reference`) reads the same arrays and works out its own
geometry from them. Nothing here imports torch or the port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

__all__ = ["MaterialSpec", "MeshSpec", "ObjectSpec", "LightSpec", "CameraSpec", "SceneSpec", "hex_color",
           "rotation", "scaling", "translation", "flat_normals"]

SRGB_GAMMA = 2.2


def hex_color(x: int) -> tuple:
    """An sRGB hex color as linear float32 values (gamma 2.2), as floats."""
    rgb = [((x >> s) & 0xFF) / 255.0 for s in (16, 8, 0)]
    return tuple(float(v) for v in np.asarray([c ** SRGB_GAMMA for c in rgb], np.float32))


def rotation(angle: float, axis) -> np.ndarray:
    """4x4 rotation by `angle` about `axis` (Rodrigues, row-major)."""
    axis = np.asarray(axis, np.float64)
    x, y, z = axis / np.linalg.norm(axis)
    c, s = math.cos(angle), math.sin(angle)
    C = 1 - c
    m = np.eye(4)
    m[:3, :3] = np.array([
        [x * x * C + c, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, z * z * C + c],
    ])
    return m


def scaling(v) -> np.ndarray:
    m = np.eye(4)
    m[0, 0], m[1, 1], m[2, 2] = np.asarray(v, np.float64)
    return m


def translation(v) -> np.ndarray:
    m = np.eye(4)
    m[:3, 3] = np.asarray(v, np.float64)
    return m


def flat_normals(vertices: np.ndarray) -> np.ndarray:
    """Per-vertex normals of a triangle soup that has none: each triangle's
    unit geometric normal on all three vertices."""
    v = np.asarray(vertices, np.float64)
    fn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    ln = np.linalg.norm(fn, axis=-1, keepdims=True)
    fn = fn / np.where(ln > 0, ln, 1.0)
    return np.repeat(fn[:, None, :], 3, axis=1)


@dataclasses.dataclass(frozen=True)
class MaterialSpec:
    color: tuple
    index: float
    roughness: float
    metallic: float
    emittance: float
    transparent: bool


@dataclasses.dataclass
class MeshSpec:
    vertices: np.ndarray  # (T, 3, 3) float64, the mesh's own frame
    normals: np.ndarray  # (T, 3, 3) float64 shading normals


@dataclasses.dataclass
class ObjectSpec:
    """A mesh instance (`mesh` an index into `SceneSpec.meshes`, placed by
    `matrix`) or an infinite plane (`mesh` None: x . normal = value)."""

    material: MaterialSpec
    mesh: Optional[int] = None
    matrix: Optional[np.ndarray] = None  # (4, 4) local -> world
    normal: Optional[tuple] = None
    value: float = 0.0


@dataclasses.dataclass
class LightSpec:
    """A point light (`kind` "point": `color`, `position`) or an invisible
    emissive unit sphere placed by `matrix` (`kind` "sphere": `color`,
    `emittance`)."""

    kind: str
    color: tuple
    position: Optional[tuple] = None
    matrix: Optional[np.ndarray] = None
    emittance: float = 0.0


@dataclasses.dataclass
class CameraSpec:
    eye: tuple
    center: tuple
    up: tuple
    fov: float


@dataclasses.dataclass
class SceneSpec:
    """A whole render: geometry, lights, environment, camera and settings."""

    meshes: List[MeshSpec]
    objects: List[ObjectSpec]
    lights: List[LightSpec]
    camera: CameraSpec
    width: int
    height: int
    spp: int
    max_bounces: int
    exposure_value: float = 0.0
    epsilon: float = 1e-3
    hdri: Optional[np.ndarray] = None  # (H, W, 3) float32 equirectangular map
    env_color: tuple = (0.0, 0.0, 0.0)

    def shadow_lights(self) -> int:
        """Lights that cast a shadow ray per path vertex (every kind here)."""
        return len(self.lights)
