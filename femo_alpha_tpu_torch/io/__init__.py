"""Mesh and field I/O and checkpoints (port of femo_alpha_tpu/io): the
gmsh ASCII reader and writer, the XDMF/VTU writers and the XDMF mesh
reader, the Recorder and the npz checkpoint."""

from .checkpoint import load_checkpoint, save_checkpoint
from .gmsh import read_msh, write_msh
from .recorder import Recorder
from .xdmf import XDMFWriter, read_xdmf_mesh, write_vtu, write_xdmf_mesh

__all__ = ["XDMFWriter", "write_vtu", "write_xdmf_mesh", "read_xdmf_mesh",
           "read_msh", "write_msh", "Recorder", "save_checkpoint",
           "load_checkpoint"]
