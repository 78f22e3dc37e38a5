"""Where the port's 512x128 solve stands against the committed host-f64
SuperLU golden (tests/data/golden_u_512x128_strong.npz), on the card:

    python tools/scale_nodal_probe.py [--refine N] [--perturb EPS]
                                      [--superlu]

LibraryBench(512, 128) on the CUDA card (988,806 dofs, strong clamp,
geometric MG) solves the nominal design from a zero start, as its first
call does. For that state and after each of N further refinement steps
(u <- u - B^{-1} r(u), each correction solved by the same MG-PCG with the
model's tolerance and restart rule) it prints the nodal relative L2 error
against the golden, the relative error of max |u| against the golden's,
rel_res, and the normwise (eta) and componentwise (omega) backward errors
on the card, |A| unconstrained as in utils/quality.py; and the same
backward errors of the golden itself under the port's operator.

--perturb EPS: how far rounding-sized changes of the assembly move the
solution. Each cell's element matrix is scaled entry by entry by
(1 + EPS*xi), xi symmetric per cell and uniform in [-1, 1] (seed 0); the
perturbed system is solved from the refined state by the same MG-PCG
(preconditioner of the unperturbed system) and refined to its fixed
point; prints its nodal distance from the refined state and from the
golden.

--band: the port's own assembled system solved on the card by the f64
band Cholesky of solvers/band.py (RCM order) and 2 refinement steps on the
fused operator's residual; prints its time, peak memory and nodal
distances, and its backward errors. Its band holds about
2 * n_dofs * bandwidth * 8 bytes: ~75 GB of the H100's 80 GB here.

--superlu: the port's own assembled system (utils/quality.sparse_operator)
solved by host SuperLU with two refinement steps, as tools/make_golden.py
solves the JAX package's; prints the nodal distance of the golden, the
first call's state and the refined state from it.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from femo_alpha_tpu_torch.benchmarks import LibraryBench  # noqa: E402
from femo_alpha_tpu_torch.assembly.assemble import (  # noqa: E402
    make_constrained_matvec_T,
)
from femo_alpha_tpu_torch.utils.quality import (  # noqa: E402
    make_abs_matvec,
    sparse_operator,
)

GOLDEN = os.path.join(os.path.dirname(HERE), "tests", "data",
                      "golden_u_512x128_strong.npz")


def band_direct_solve(pde, params, ops, refinements=2):
    """The state of the linear ImplicitPDE by a direct solve on the
    operator's device: the band Cholesky of the constrained operator with
    element blocks `ops`, then `refinements` steps of iterative refinement
    on the residual of the solve's own operator (the fused operator)."""
    from femo_alpha_tpu_torch.solvers.band import BandCholPrecond
    from femo_alpha_tpu_torch.solvers.linear import LinearSolver

    with torch.no_grad():
        free = pde.free_mask
        band = BandCholPrecond(pde._op_specs[0],
                               [np.asarray(sp.dofmap) for sp in pde._op_specs],
                               free=free)
        state = band.setup(ops)
        matvec = LinearSolver(list(zip(ops, pde._op_specs)), pde.n_dofs,
                              free_mask=free).matvec
        b = -pde.residual(torch.zeros_like(free), params)
        u = band.apply(state, b)
        for _ in range(refinements):
            u = u + band.apply(state, b - matvec(u))
    return u


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--refine", type=int, default=3)
    ap.add_argument("--perturb", type=float, default=0.0)
    ap.add_argument("--superlu", action="store_true")
    ap.add_argument("--band", action="store_true")
    args = ap.parse_args()
    with np.load(GOLDEN) as z:
        ug_np = z["u"]
        meta = json.loads(str(z["meta"]))
    b = LibraryBench(nx=512, ny=128)
    pde = b.pde
    params = b.params(b.th0)
    ug = torch.as_tensor(ug_np, device=b.device)
    with torch.no_grad():
        zero = torch.zeros_like(ug)
        r0 = pde.residual(zero, params)
        emb, _, fops = pde._prepare_aux(params)
        ops = pde._assemble_ops(zero, params, emf_basis=emb, facet_ops=fops)
        absA = make_abs_matvec(pde)

        def report(label, u, info=None):
            r = pde.residual(u, params)
            scale = absA(ops, u) + r0.abs()
            line = {
                "state": label,
                "nodal_vs_golden": float(torch.linalg.norm(u - ug)
                                         / torch.linalg.norm(ug)),
                "tip_rel_err": abs(float(u.abs().max()) / meta["u_max"]
                                   - 1.0),
                "rel_res": float(torch.linalg.norm(r)
                                 / torch.linalg.norm(r0)),
                "eta": float(torch.linalg.norm(r) / torch.linalg.norm(scale)),
                "omega": float((r.abs() / scale.clamp_min(1e-300)).max()),
            }
            if info is not None:
                line["cg"] = info
            print(json.dumps(line), flush=True)

    def rel(a, b_):
        return float(torch.linalg.norm(a - b_) / torch.linalg.norm(b_))

    report("golden", ug)
    out = b.forward_adjoint(b.th0)
    u1 = u = out["u"]
    report("first call (zero start)", u, pde.last_info.get("forward"))
    with torch.no_grad():
        for k in range(args.refine):
            solver = pde.make_solver(u, params)
            u = u - solver.solve(pde.residual(u, params))
            report(f"refinement {k + 1}", u, solver.last_info)

        if args.perturb > 0.0:
            Ae = ops[0]
            g = torch.Generator(device=Ae.device).manual_seed(0)
            xi = 2.0 * torch.rand(Ae.shape, generator=g, device=Ae.device,
                                  dtype=Ae.dtype) - 1.0
            xi = 0.5 * (xi + xi.transpose(0, 1))
            matvec = make_constrained_matvec_T(Ae * (1.0 + args.perturb * xi),
                                               pde._op_specs[0],
                                               pde.free_mask)
            del xi
            solver = pde.make_solver(u, params)
            solver.matvec = matvec
            up = u
            for k in range(4):
                up = up - solver.solve(matvec(up) + r0)
                print(json.dumps({
                    "state": f"perturbed {args.perturb:g}, refinement {k + 1}",
                    "nodal_vs_refined": rel(up, u),
                    "nodal_vs_golden": rel(up, ug),
                    "cg": solver.last_info}), flush=True)

    ud_band = None
    if args.band:
        import time

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ud_band = band_direct_solve(pde, params, ops)
        torch.cuda.synchronize()
        print(json.dumps({
            "state": "port system, band Cholesky on the card + 2 "
                     "refinements",
            "seconds": time.perf_counter() - t0,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "golden_vs_it": rel(ug, ud_band),
            "first_call_vs_it": rel(u1, ud_band),
            "refined_vs_it": rel(u, ud_band)}), flush=True)
        report("band direct", ud_band)

    if args.superlu:
        import time

        import scipy.sparse.linalg as spla

        t0 = time.perf_counter()
        B, rhs = sparse_operator(pde, params)
        lu = spla.splu(B)
        ud = lu.solve(rhs)
        for _ in range(2):
            ud = ud + lu.solve(rhs - B @ ud)
        ud = torch.as_tensor(ud, device=b.device)
        print(json.dumps({
            "state": "port system, host SuperLU + 2 refinements",
            "seconds": time.perf_counter() - t0, "nnz": int(B.nnz),
            "golden_vs_it": rel(ug, ud), "first_call_vs_it": rel(u1, ud),
            "refined_vs_it": rel(u, ud),
            "band_vs_it": None if ud_band is None else rel(ud_band, ud)}),
            flush=True)


if __name__ == "__main__":
    main()
