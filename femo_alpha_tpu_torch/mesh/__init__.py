"""Mesh containers and built-in mesh generation (host numpy).

Copies of femo_alpha_tpu/mesh/{mesh,generation,structured,wing}.py:
importing the JAX package runs its __init__, which imports jax, so the port
carries its own copy of these numpy-only layers."""

from .mesh import Mesh, LOCAL_EDGES
from .structured import StructuredQuadMesh
from .generation import (
    createIntervalMesh,
    createRectangleMesh,
    createUnitSquareMesh,
    readFEAMesh,
    reconstructFEAMesh,
)
from .wing import createWingShellMesh

__all__ = [
    "Mesh",
    "LOCAL_EDGES",
    "StructuredQuadMesh",
    "createIntervalMesh",
    "createRectangleMesh",
    "createUnitSquareMesh",
    "createWingShellMesh",
    "readFEAMesh",
    "reconstructFEAMesh",
]
