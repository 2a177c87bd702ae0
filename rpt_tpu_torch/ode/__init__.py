"""Particle-system ODEs for physics-driven animation (`rpt_tpu/ode`)."""

from .particle import (
    MarblesSystem,
    ParticleState,
    ParticleSystem,
    SimpleCircleSystem,
    SolidGravitySystem,
)

__all__ = [
    "ParticleState",
    "ParticleSystem",
    "SimpleCircleSystem",
    "SolidGravitySystem",
    "MarblesSystem",
]
