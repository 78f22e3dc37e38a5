"""Setup-time mesh topology (host numpy).

The numpy path of femo_alpha_tpu/native/topology.py and its RCM loop in
Python; the g++ meshops library is not carried over."""

from .topology import build_csr_pattern, build_edges, rcm_order

__all__ = ["build_csr_pattern", "build_edges", "rcm_order"]
