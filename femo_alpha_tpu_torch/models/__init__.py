"""Models (port of femo_alpha_tpu/models): the RM shell."""

from .rm_shell import RMShellModel

__all__ = ["RMShellModel"]
