"""Mesh file I/O and checkpoints (port of femo_alpha_tpu/io): the gmsh
ASCII reader and the npz checkpoint. The XDMF reader and the Recorder
(which writes XDMF) are not ported (they need HDF5; ROADMAP.md)."""

from .checkpoint import load_checkpoint, save_checkpoint
from .gmsh import read_msh

__all__ = ["read_msh", "save_checkpoint", "load_checkpoint"]
