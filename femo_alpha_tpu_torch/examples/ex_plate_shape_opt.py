"""Shape optimization of a cantilever plate planform: node_disp (the mesh
motion field uhat) as the SLSQP design variable. Geometry changes enter
the PDE through the J(uhat) / F(uhat) pullbacks instead of remeshing.

A transversely loaded cantilever (10 x 2, 32x8 mesh, clamped at x = 0)
may move its nodes in y by up to +-0.2 (root nodes fixed): widening where
the bending moment is largest stiffens it, so the compliance drops. For a
flat plate an out-of-plane node motion changes the surface metric only at
second order, so the in-plane moves are the shape directions. The shape
derivative is first checked against a Richardson central difference
along a seeded direction (rel err < 1e-5).

    python -m femo_alpha_tpu_torch.examples.ex_plate_shape_opt [--maxiter 80] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh import createRectangleMesh
from ..models import RMShellModel
from ..opt import OptimizationProblem
from ._common import f64, numpy_of, parse_args, solve_recorded

RUN_CHECK_DERIVATIVES = 1
NX, NY = 32, 8
L, W = 10.0, 2.0
E_val, nu_val, rho_val, h_val = 4.32e8, 0.0, 100.0, 0.2
SHAPE_BOUND = 0.2  # +-y per node (the row spacing W/NY keeps cells valid)
MAXITER = 80


def build(device=None):
    """The plate, its RMShellModel (strong BCs), evaluate(dvs) of the y
    motion dy, the baseline compliance J0 and the SLSQP problem."""
    kw = f64(device)
    mesh = createRectangleMesh(NX, NY, (0, 0), (L, W), "quad", gdim=3)
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 0] < 1e-12,
                         element_wise_material=True, PENALTY_BC=False,
                         device=device)
    nel, nn = mesh.n_cells, mesh.n_nodes
    E = torch.full((nel,), E_val, **kw)
    nu = torch.full((nel,), nu_val, **kw)
    rho = torch.full((nel,), rho_val, **kw)
    th = torch.full((nel,), h_val, **kw)
    force = torch.zeros(3 * nn, **kw)
    force[2::3] = 2.0

    def evaluate(dvs):
        dy = dvs["dy"]
        z = torch.zeros_like(dy)
        return model.evaluate(force, th, E, nu, rho,
                              node_disp=torch.stack([z, dy, z], dim=1),
                              is_pressure=True)

    with torch.no_grad():
        J0 = float(evaluate({"dy": torch.zeros(nn, **kw)}).compliance)
    root = np.asarray(mesh.coords[:, 0]) < 1e-12
    prob = OptimizationProblem(evaluate, device=device)
    prob.add_design_variable("dy", np.zeros(nn),
                             lower=np.where(root, 0.0, -SHAPE_BOUND),
                             upper=np.where(root, 0.0, SHAPE_BOUND))
    prob.set_objective("compliance", scaler=1.0 / J0)
    return dict(mesh=mesh, model=model, evaluate=evaluate, problem=prob,
                J0=J0, root=root, kw=kw)


def main(argv=None):
    args = parse_args(argv, __doc__, maxiter=MAXITER,
                      run_check_derivatives=RUN_CHECK_DERIVATIVES)
    ex = build(args.device)
    nn, kw, J0 = ex["mesh"].n_nodes, ex["kw"], ex["J0"]
    print(f"baseline compliance: {J0:.8e}")
    result = {"n_dofs": ex["model"].shell_pde.W.n_dofs, "J0": J0}

    def Jfn(dy):
        return ex["evaluate"]({"dy": dy}).compliance

    if args.run_check_derivatives:
        rng = np.random.default_rng(0)
        dy0 = torch.as_tensor(0.02 * rng.standard_normal(nn), **kw)
        leaf = dy0.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(Jfn(leaf), leaf)
        d = rng.standard_normal(nn)
        d = torch.as_tensor(d / np.linalg.norm(d), **kw)

        def fd(eps):
            with torch.no_grad():
                return (float(Jfn(dy0 + eps * d))
                        - float(Jfn(dy0 - eps * d))) / (2 * eps)

        fdR = (4.0 * fd(1e-3) - fd(2e-3)) / 3.0
        ad = float(torch.dot(g, d))
        rel = abs(ad - fdR) / max(abs(fdR), 1e-300)
        print(f"shape derivative check: adjoint {ad:.8e}  FD {fdR:.8e}  "
              f"rel err {rel:.2e}")
        if not rel < 1e-5:
            raise AssertionError(f"shape derivative: rel err {rel:.3e}")
        result.update(grad=numpy_of(g), dir_deriv=ad, fd_richardson=fdR,
                      fd_rel_err=rel)
    dvs, res, record = solve_recorded(ex["problem"], args.maxiter, 1e-12)
    with torch.no_grad():
        J1 = float(Jfn(dvs["dy"]))
    print(f"optimized compliance: {J1:.8e}  ({100 * (1 - J1 / J0):.2f}% "
          f"reduction, {res.nit} SLSQP iterations)")
    dy = numpy_of(dvs["dy"])
    print("max |dy| =", float(np.max(np.abs(dy))))
    result.update(record, dy=dy, compliance=J1)
    return result


if __name__ == "__main__":
    main()
