"""Mesh file I/O (port of femo_alpha_tpu/io): the gmsh ASCII reader. The
XDMF reader is not ported (it reads HDF5; ROADMAP.md)."""

from .gmsh import read_msh

__all__ = ["read_msh"]
