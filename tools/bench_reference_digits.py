"""The JAX package's digits of LibraryBench on a 32x16 plate, the constants
of tests/test_torch_bench.py:

    FEMO_PLATFORM=cpu FEMO_COMPILE_CACHE=0 python tools/bench_reference_digits.py

femo_alpha_tpu.benchmarks.LibraryBench(nx=32, ny=16) (strong clamp, the
CG + geometric-MG path, f64; FEMO_MG_F32, FEMO_LANE_MAJOR, FEMO_HOSTLOOP,
FEMO_CG_DF and FEMO_OP_STORAGE unset) at its nominal design: prints the
compliance J, the 2-norm of its thickness gradient and the tip
displacement max|u|.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

for flag in ("FEMO_MG_F32", "FEMO_LANE_MAJOR", "FEMO_HOSTLOOP", "FEMO_CG_DF",
             "FEMO_OP_STORAGE"):
    os.environ.pop(flag, None)

import jax.numpy as jnp  # noqa: E402

from femo_alpha_tpu.benchmarks import LibraryBench  # noqa: E402


def main():
    b = LibraryBench(nx=32, ny=16)
    out = b.forward_adjoint(b.th0)
    print(f"n_dofs {b.n_dofs}")
    print(f"J {float(out['J']):.15e}")
    print(f"grad_norm {float(jnp.linalg.norm(out['grad'])):.15e}")
    print(f"tip {float(jnp.max(jnp.abs(out['u']))):.15e}")


if __name__ == "__main__":
    main()
