"""Million-dof RM shell forward + adjoint on one card: the cantilever
plate workload at 512x128 (988,806 mixed dofs) through the port's
LibraryBench: per-design affine re-assembly, f64 CG preconditioned by a
five-level geometric V-cycle, and the exact adjoint gradient of the
compliance in the per-cell thickness.

    python -m femo_alpha_tpu_torch.examples.ex_million_dof_shell [--NX 512] [--NY 128] [--device cpu]
"""

from __future__ import annotations

import time

import torch

from ..benchmarks import LibraryBench
from ..utils import quality
from ..utils.timing import sync
from ._common import numpy_of, parse_args

NX, NY = 512, 128


def build(NX=NX, NY=NY, device=None):
    """The plate bench (its model, forward_adjoint and nominal design)."""
    bench = LibraryBench(nx=NX, ny=NY, device=device)
    return dict(bench=bench, model=bench.model,
                evaluate=bench.forward_adjoint, problem=None)


def main(argv=None):
    args = parse_args(argv, __doc__, NX=NX, NY=NY)
    t0 = time.time()
    bench = build(args.NX, args.NY, args.device)["bench"]
    print(f"built {bench.n_dofs} dofs in {time.time() - t0:.1f}s "
          f"({bench.device})")
    t0 = time.time()
    out = bench.forward_adjoint(bench.th0)
    sync(out["grad"])
    first_s = time.time() - t0
    print(f"first forward+adjoint (incl. kernel build): {first_s:.1f}s")
    t0 = time.time()
    out = bench.forward_adjoint(bench.th0)
    sync(out["grad"])
    steady_s = time.time() - t0
    print(f"steady forward+adjoint: {steady_s:.3f}s")
    info = bench.pde.last_info or {}
    iters = {k: int(info[k]["iters"]) if info.get(k) else -1
             for k in ("forward", "adjoint")}
    rel_res, _ = quality.residual_and_floor(bench.pde, bench.params(
        bench.th0), out["u"])
    J = float(out["J"])
    g_norm = float(torch.linalg.norm(out["grad"]))
    tip = float(out["u"].abs().max())
    print(f"iters fwd/adj {iters['forward']}/{iters['adjoint']}  "
          f"rel_res {rel_res:.2e}")
    print(f"J = {J:.9e}  |dJ/dth| = {g_norm:.6e}  tip = {tip:.6e}")
    return {"n_dofs": bench.n_dofs, "J": J, "grad_norm": g_norm, "tip": tip,
            "grad": numpy_of(out["grad"]), "iters_fwd": iters["forward"],
            "iters_adj": iters["adjoint"], "rel_res": rel_res,
            "first_s": first_s, "steady_s": steady_s}


if __name__ == "__main__":
    main()
