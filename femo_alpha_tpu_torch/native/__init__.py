"""Setup-time mesh topology (host numpy).

The numpy path of femo_alpha_tpu/native/topology.py; the g++ meshops
library is not carried over."""

from .topology import build_edges

__all__ = ["build_edges"]
