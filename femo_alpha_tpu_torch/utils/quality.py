"""Solve-quality metrics that mean what they say.

Port of femo_alpha_tpu/utils/quality.py. The naive quality metric
||r||/||b|| saturates at eps*rho with rho = |||A||u||| / ||b|| — the
cancellation floor of EVALUATING the residual — long before the solution
stops improving (on the 128x32 shell plate rho ~ 1e8, so the floor sits
near 1e-8 in f64, and a SuperLU direct solve measures the same floor).
The metrics below are the ones direct solvers report (MUMPS BERR,
Oettli–Prager), plus a nodal match against a host f64 direct solve:

  eta    normwise backward error  ||r|| / (|||A||u||| + ||b||)
  omega  componentwise backward error  max_i |r_i| / (|A||u| + |b|)_i
  nodal  ||u - u_direct|| / ||u_direct||  vs host SuperLU (+1 refinement)

The H100 computes in native f64, so the device's unit roundoff is f64's
(the JAX package's TPU branch, a float-float pair, has no counterpart).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..assembly.assemble import make_constrained_matvec_T, make_matvec_T


def device_f64_eps() -> float:
    """Unit roundoff of the device's f64 arithmetic (native on the H100 and
    on the CPU)."""
    return float(np.finfo(np.float64).eps)


def make_abs_matvec(pde):
    """x -> |A| @ |x| for an ImplicitPDE's element operators: the
    row-magnitude scale against which residual cancellation is measured.
    Returns fn(ops_Ae, x) over the lane-major blocks of `pde._op_specs`:
    the cell block through make_matvec_T (the standalone K1 on the card),
    facet blocks through the fused operator with no mask. Unconstrained,
    as in the reference: the BC rows count their couplings too."""
    specs = pde._op_specs

    def abs_matvec(ops_Ae, x):
        ax = x.abs()
        y = make_matvec_T(ops_Ae[0].abs(), specs[0])(ax)
        for Ae, spec in zip(ops_Ae[1:], specs[1:]):
            ones = torch.ones_like(ax)
            y = y + make_constrained_matvec_T(Ae.abs(), spec, ones)(ax)
        return y

    return abs_matvec


def _operator_blocks(pde, params, u):
    """The element blocks of `pde` at u and params, as the solve assembles
    them (the affine basis and the facet blocks prepared once)."""
    emf_basis, _, facet_ops = pde._prepare_aux(params)
    return pde._assemble_ops(u, params, emf_basis=emf_basis,
                             facet_ops=facet_ops)


def constrained_csr(blocks, free):
    """The constrained operator B = f*A*f + (1-f)*I as a torch sparse CSR
    tensor (int32 indices, duplicates summed, exact zeros dropped) on
    free's device, for A the sum of lane-major element blocks
    [(Ae (nd, nd, nc), spec with a (nc, nd) `dofmap`)] and a 0/1 mask
    free (n,)."""
    dev, n = free.device, free.shape[0]
    rows, cols, vals = [], [], []
    for Ae, spec in blocks:
        dm = torch.as_tensor(np.asarray(spec.dofmap), dtype=torch.int64,
                             device=dev)
        nc, nd = dm.shape
        r = dm[:, :, None].expand(nc, nd, nd).reshape(-1)
        c = dm[:, None, :].expand(nc, nd, nd).reshape(-1)
        v = Ae.permute(2, 0, 1).reshape(-1).to(free.dtype)
        rows.append(r)
        cols.append(c)
        vals.append(free[r] * v * free[c])
    d = torch.arange(n, device=dev)
    rows.append(d)
    cols.append(d)
    vals.append(1.0 - free)
    coo = torch.sparse_coo_tensor(
        torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
        (n, n), check_invariants=False).coalesce()
    idx, v = coo.indices(), coo.values()
    keep = v != 0
    csr = torch.sparse_coo_tensor(idx[:, keep], v[keep], (n, n),
                                  is_coalesced=True,
                                  check_invariants=False).to_sparse_csr()
    if csr.values().numel() >= 2 ** 31:
        raise ValueError(f"constrained_csr: {csr.values().numel()} entries "
                         "overflow int32 indices")
    return torch.sparse_csr_tensor(csr.crow_indices().to(torch.int32),
                                   csr.col_indices().to(torch.int32),
                                   csr.values(), (n, n),
                                   check_invariants=False)


def to_scipy(csr):
    """A torch sparse CSR tensor as a host scipy CSR matrix."""
    n = csr.shape[0]
    return sp.csr_matrix((csr.values().cpu().numpy(),
                          csr.col_indices().cpu().numpy(),
                          csr.crow_indices().cpu().numpy()), shape=(n, n))


def sparse_operator(pde, params, u0=None):
    """Host scipy CSC of the CONSTRAINED operator B = f*A*f + (1-f)*I and
    the linear problem's right-hand side b = -residual(u0) (u0 = 0 by
    default; adjoint/implicit.py's BC convention). Setup-only: the direct
    cross-check and the tests use it, never a hot path."""
    with torch.no_grad():
        if u0 is None:
            u0 = torch.zeros_like(pde.free_mask)
        extra = getattr(pde, "extra_residual", None)
        if extra is not None:
            # load-like (point forces) terms belong in b, not in B: check
            # with one linearization probe and refuse a state-dependent one
            zero = torch.zeros_like(u0)
            _, probe = torch.func.jvp(lambda v: extra(v, params), (zero,),
                                      (torch.ones_like(u0),))
            if float(probe.abs().max()) > 0.0:
                raise NotImplementedError(
                    "sparse_operator: state-dependent extra_residual is not "
                    "representable here")
        ops = _operator_blocks(pde, params, u0)
        B = constrained_csr(list(zip(ops, pde._op_specs)), pde.free_mask)
        b = -pde.residual(u0, params)
    return to_scipy(B).tocsc(), b.cpu().numpy().astype(np.float64)


def backward_errors(B, b, u):
    """(eta, omega, rel_res) of u for the host sparse system."""
    u = np.asarray(u, dtype=np.float64)
    r = b - B @ u
    scale = abs(B) @ np.abs(u) + np.abs(b)
    omega = float(np.max(np.abs(r) / np.maximum(scale, 1e-300)))
    eta = float(np.linalg.norm(r) / max(float(np.linalg.norm(scale)),
                                        1e-300))
    rel = float(np.linalg.norm(r) / max(float(np.linalg.norm(b)), 1e-300))
    return eta, omega, rel


def direct_crosscheck(pde, params, u, max_dofs=300_000):
    """Nodal agreement of `u` with a host f64 SuperLU direct solve (+1
    refinement step, MUMPS-class). Returns a dict with the nodal errors
    and the backward errors of both solutions, or {'skipped': reason}
    above `max_dofs` (direct factorization memory)."""
    import scipy.sparse.linalg as spla

    if pde.n_dofs > max_dofs:
        return {"skipped": f"n_dofs {pde.n_dofs} > {max_dofs}"}
    B, b = sparse_operator(pde, params)
    lu = spla.splu(B)
    ud = lu.solve(b)
    ud = ud + lu.solve(b - B @ ud)
    if isinstance(u, torch.Tensor):
        u = u.detach().cpu().numpy()
    u = np.asarray(u, dtype=np.float64)
    eta_u, omega_u, rel_u = backward_errors(B, b, u)
    eta_d, omega_d, rel_d = backward_errors(B, b, ud)
    un = max(float(np.linalg.norm(ud)), 1e-300)
    return {
        "nodal_l2": float(np.linalg.norm(u - ud)) / un,
        "nodal_inf": float(np.max(np.abs(u - ud)))
        / max(float(np.max(np.abs(ud))), 1e-300),
        "eta": eta_u, "omega": omega_u, "rel_res": rel_u,
        "direct_eta": eta_d, "direct_omega": omega_d,
        "direct_rel_res": rel_d,
    }


def residual_and_floor(pde, params, u):
    """(rel_res, res_floor) of the state u, on u's device: the constrained
    residual ||r(u)|| relative to ||r(0)|| (the right-hand side of these
    linear problems), and the floor that ratio saturates at for any
    backward-stable solve, eps * (|||A||u||| + ||r(0)||) / ||r(0)||
    (benchmarks.py's measure)."""
    with torch.no_grad():
        zero = torch.zeros_like(u)
        r0 = float(torch.linalg.norm(pde.residual(zero, params)))
        rn = float(torch.linalg.norm(pde.residual(u, params)))
        ops = _operator_blocks(pde, params, zero)
        scale = float(torch.linalg.norm(make_abs_matvec(pde)(ops, u)))
    return rn / r0, device_f64_eps() * (scale + r0) / r0
