"""Design-affine element-operator decomposition (lane-major).

Port of femo_alpha_tpu/assembly/affine.py. For forms whose element matrices
are a polynomial in a per-cell (DG0) design field — the MID-plane RM shell
stiffness with element-wise thickness is exactly h*M1 + h^3*M3 —

    Ae(theta)[:, :, c] = sum_k theta_c**powers[k] * M_k[:, :, c],

the basis M_k is extracted once from len(powers) probe assemblies and a
small Vandermonde solve; each new design then costs one K2 combine
(cuda_kernels.affine_combine) instead of a jacfwd assembly.

The port stores the basis lane-major (K, nd, nd, nc) in native f64 (the
default) or f32: `dtype=float32` (the f32 MG levels: the probes assembled
by an f32 form, combined in f64, then rounded) or `storage="f32"` (the
fine operator's basis rounded to f32, selected on the model by
FEMO_OP_STORAGE=f32), whose combine is K2's f32 build and whose Ae then
runs the fused operator's f32 build. The JAX package's float-float
storage ("df") exists for the TPU's lack of f64 and is not carried over.
With FEMO_SETUP_CACHE=1, CachedAffineAssembler stores each basis it builds
on disk and loads one that an earlier process built from the same inputs
(utils/diskcache.py).

The design gradient of a product A(theta) x is the closed-form
`vjp_theta`; `AffineOperator` / `AffineApply` make such a product (one
K2 combine per design, one fused-operator pass per product)
differentiable in theta and x through it.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .assemble import element_matrices, make_constrained_matvec_T
from .cuda_kernels import affine_combine, cell_matvec_T


def _affine_combine(B, theta, powers):
    """Ae(theta) = sum_k theta^p_k * B[k] for a lane-major basis (K2)."""
    return affine_combine(B, theta.to(B.dtype), powers)


class AffineDesignOperator:
    """Element matrices affine in powers of a scalar per-cell design field.

    form: FemForm with the design field among its params; u0: linearization
    state (zeros for linear problems); params_of: theta -> full params dict;
    powers: exponents of the polynomial dependence; probe_scale: magnitude
    of the probe values; dtype: dtype of the stored basis (None = the
    assembly dtype); storage: "f32" rounds the finished basis to f32 (an
    f32-accurate operator), None keeps it. The probes are assembled in the
    form's dtype and combined in f64, as the JAX package combines them."""

    def __init__(self, form, u0, params_of, key="thickness", powers=(1, 3),
                 probe_scale=1.0, chunk=8192, dtype=None, storage=None,
                 cells=None):
        if storage not in (None, "f32"):
            raise ValueError(f"AffineDesignOperator: storage={storage!r} "
                             "(None or 'f32'; the float-float 'df' is a "
                             "TPU storage and is not ported)")
        self.form = form
        self.key = key
        self.storage = storage
        self.cells = cells
        self.powers = tuple(int(p) for p in powers)
        K = len(self.powers)
        nc = form.space.mesh.n_cells
        probes = probe_scale * np.arange(1.0, K + 1.0)
        G = np.stack([probes ** p for p in self.powers], axis=1)  # (K, K)
        Ginv = np.linalg.inv(G)
        Ae_probes = [
            element_matrices(form, u0, params_of(torch.full(
                (nc,), float(t), dtype=u0.dtype, device=u0.device)),
                chunk=chunk, cells=cells)
            for t in probes]
        basis = []
        for k in range(K):
            Mk = sum(float(Ginv[k, i]) * Ae_probes[i].double()
                     for i in range(K))
            Mk = Mk.permute(1, 2, 0)  # (nd, nd, nc)
            basis.append(Mk if dtype is None else Mk.to(dtype))
        basis = torch.stack(basis).contiguous()
        self.basis = basis.float() if storage == "f32" else basis
        self.nc = nc

    def astype(self, dtype):
        """A view of this operator with the basis cast to `dtype` (e.g. an
        f32 copy feeding a preconditioner hierarchy)."""
        return AffineDesignOperator.from_basis(
            self.form, self.key, self.powers, self.storage, self.cells,
            self.basis.to(dtype))

    @staticmethod
    def from_basis(form, key, powers, storage, cells, basis):
        """An operator over a basis built already (no probe assembly)."""
        out = object.__new__(AffineDesignOperator)
        out.form, out.key, out.powers = form, key, tuple(powers)
        out.storage, out.cells = storage, cells
        out.basis = basis
        out.nc = form.space.mesh.n_cells
        return out

    def element_matrices(self, theta, basis=None):
        """Ae(theta): (nd, nd, nc) lane-major (the range's cells of a
        basis built on a cell range, from theta over every cell)."""
        B = self.basis if basis is None else basis
        return _affine_combine(B, _cut(theta, self.cells), self.powers)

    def matvec(self, theta, space, x):
        """A(theta) @ x without materializing Ae: one per-cell pass per
        basis term (K1 on basis[k], in x's dtype, on the card), each
        scaled by theta^p_k, then the space's lane-major scatter (fixed
        order). The basis is read in x's dtype, as the JAX package reads
        it."""
        th = theta.to(x.dtype)
        xcT = space.gather_T(x).contiguous()
        ycT = None
        for k, p in enumerate(self.powers):
            term = (th ** p)[None, :] * cell_matvec_T(
                self.basis[k].to(x.dtype).contiguous(), xcT)
            ycT = term if ycT is None else ycT + term
        return space.scatter_add_T(ycT)

    def vjp_theta(self, theta, u, lam, space, basis=None):
        """lam^T dA(theta)/dtheta u per cell, in closed form:
        sum_k p_k theta_c^(p_k - 1) lam_c^T B_k[:, :, c] u_c, from the
        lane-major gathers of u and lam (no (nd, nd, nc) cotangent)."""
        return _vjp_theta(self.basis if basis is None else basis,
                          self.powers, theta, u, lam, space)

    def verify(self, theta, u0, params_of, rtol=1e-9, chunk=8192):
        """Check the decomposition against one direct assembly at `theta`;
        raises if the design dependence is not the declared polynomial.
        Returns the relative max-abs error."""
        direct = element_matrices(self.form, u0, params_of(theta),
                                  chunk=chunk, cells=self.cells)
        pred = self.element_matrices(theta).to(direct.dtype).permute(2, 0, 1)
        err = float(torch.max(torch.abs(pred - direct)))
        scale = float(torch.max(torch.abs(direct)))
        rtol = max(rtol, 100.0 * float(torch.finfo(self.basis.dtype).eps))
        if err > rtol * max(scale, 1e-300):
            raise ValueError(
                f"affine decomposition mismatch: max abs err {err:.3e} vs "
                f"scale {scale:.3e} — design dependence is not polynomial "
                f"with powers {self.powers}")
        return err / max(scale, 1e-300)


def _cut(theta, cells):
    """theta over every cell -> the cells (c0, c1) of a range (None: all)."""
    return theta if cells is None else theta[cells[0]:cells[1]]


def _digest(params):
    h = hashlib.sha1()
    for k in sorted(params):
        h.update(k.encode())
        h.update(params[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


class CachedAffineAssembler:
    """Exact affine re-assembly in the design field, with the basis cached
    over the remaining parameters (rebuilt when one of them changes value,
    detected by content hash). Emits lane-major (nd, nd, nc) element
    matrices. `verify=True` checks the decomposition against one direct
    assembly when the basis is built. Parameters in `ignore_keys` do not
    enter the Jacobian (pure load terms) and are zeroed in the probes.
    dtype / storage: see AffineDesignOperator.

    When a parameter that enters the Jacobian, other than the design field,
    requires grad (`grad_keys`: a shape study differentiates uhat), no
    basis is built: every design there is a new geometry, and two probe
    assemblies plus a verify would cost three assemblies where one direct
    assembly does (`direct`)."""

    def __init__(self, form, key="thickness", powers=(1, 3),
                 probe_scale=None, chunk=8192, dtype=None, verify=True,
                 ignore_keys=("F_solid",), storage=None):
        self.form = form
        self.key = key
        self.storage = storage
        self.powers = tuple(int(p) for p in powers)
        self.chunk = chunk
        self.dtype = dtype
        self.verify = verify
        self.probe_scale = probe_scale
        self.ignore_keys = tuple(ignore_keys)
        self._cache_key = None
        self._aff = None
        self.cells = None  # spaces.CellRange under a cell split

    def shard(self, cells):
        """Build and combine over one rank's cells from now on (a
        spaces.CellRange of the form's space; parallel/product.py): the
        probes and the verify assemble those cells only, the basis holds
        them, K2 combines them from theta's slice, `direct` assembles
        them."""
        self.cells = cells
        self._aff, self._cache_key = None, None

    def _range(self):
        return None if self.cells is None else self.cells.cells

    def prepare(self, params, grad_keys=frozenset()):
        """The affine basis for these parameters (built or reused), or None
        when one of grad_keys enters the Jacobian besides the design field
        (the caller then assembles directly)."""
        if any(k != self.key and k not in self.ignore_keys
               for k in grad_keys if k in params):
            return None
        others = {k: (torch.zeros_like(v) if k in self.ignore_keys
                      else v.detach())
                  for k, v in params.items() if k != self.key}
        relevant = {k: v for k, v in others.items()
                    if k not in self.ignore_keys}
        ck = _digest(relevant)
        if self._aff is None or ck != self._cache_key:
            theta = params[self.key].detach()
            ps = self.probe_scale
            if ps is None:
                ps = max(abs(float(np.median(theta.cpu().numpy()))), 1e-8)

            def params_of(th):
                return {**others, self.key: th}

            u0 = torch.zeros(self.form.space.n_dofs, dtype=theta.dtype,
                             device=theta.device)
            # utils/diskcache.py (FEMO_SETUP_CACHE=1): a basis an earlier
            # process built from the same inputs, bit for bit
            dk = self._disk_key(relevant, ps, u0, params_of)
            self._aff = self._disk_load(dk, theta.device)
            if self._aff is None:
                self._aff = AffineDesignOperator(
                    self.form, u0, params_of, key=self.key,
                    powers=self.powers, probe_scale=ps, chunk=self.chunk,
                    dtype=self.dtype, storage=self.storage,
                    cells=self._range())
                if self.verify:
                    self._aff.verify(theta, u0, params_of, chunk=self.chunk)
                if dk is not None:
                    from ..utils import diskcache

                    diskcache.store("affine", dk, [self._aff.basis])
            self._cache_key = ck
        return self._aff.basis

    def _disk_key(self, relevant, ps, u0, params_of):
        """The disk cache's key of the basis these inputs build (None with
        the cache off): see utils/diskcache.py for what it covers."""
        from ..utils import diskcache

        if not diskcache.enabled():
            return None
        form, space = self.form, self.form.space
        nc = space.dofmap.shape[0]
        c0, c1 = self._range() or (0, nc)
        probe = params_of(torch.full((nc,), float(ps), dtype=u0.dtype,
                                     device=u0.device))
        sample = [element_matrices(form, u0, probe, chunk=self.chunk,
                                   cells=cells)
                  for cells in ((c0, c0 + 1), (c1 - 1, c1))]
        return diskcache.key(
            form._coords_np, np.asarray(space.dofmap), space.n_dofs,
            form.energy_kernel is None, sorted(form.param_specs),
            str(form.dtype), *[form.cell_consts[k]
                               for k in sorted(form.cell_consts)],
            *sample, *[relevant[k] for k in sorted(relevant)], float(ps),
            self.key, self.powers, self.storage, str(self.dtype),
            self.verify, (c0, c1), u0.device.type)

    def _disk_load(self, dk, device):
        """The cached basis of key dk as an AffineDesignOperator on
        `device`, or None."""
        from ..utils import diskcache

        arrs = None if dk is None else diskcache.load("affine", dk)
        if arrs is None:
            return None
        return AffineDesignOperator.from_basis(
            self.form, self.key, self.powers, self.storage, self._range(),
            torch.as_tensor(arrs[0], device=device))

    def combine(self, theta, basis):
        """Affine combine with an explicit basis -> (nd, nd, nc) (the
        range's cells under a split, from theta over every cell)."""
        return _affine_combine(basis, _cut(theta, self._range()),
                               self.powers)

    def vjp_theta(self, theta, u, lam, space, basis=None):
        """AffineDesignOperator.vjp_theta on the prepared basis (or an
        explicit one)."""
        B = self._aff.basis if basis is None else basis
        return _vjp_theta(B, self.powers, theta, u, lam,
                          space if self.cells is None else self.cells)

    def direct(self, u, params):
        """One direct assembly, lane-major (nd, nd, nc); u None means the
        zero state (the Jacobian of a linear form does not depend on it)."""
        th = params[self.key]
        if u is None:
            u = torch.zeros(self.form.space.n_dofs, dtype=th.dtype,
                            device=th.device)
        Ae = element_matrices(self.form, u, params, chunk=self.chunk,
                              cells=self._range())
        return Ae.permute(1, 2, 0).contiguous()

    def __call__(self, u, params, basis=None):
        if basis is None:
            basis = self.prepare(params)
        return self.combine(params[self.key], basis)


def _vjp_theta(B, powers, theta, u, lam, space):
    """Per cell of B's cells: space a CellRange gives the range's values,
    from theta over every cell (_padded puts them on the whole axis)."""
    cells = getattr(space, "cells", None)
    theta = _cut(theta, cells)
    ucT = space.gather_T(u).to(B.dtype)
    lcT = space.gather_T(lam).to(B.dtype)
    g = torch.zeros_like(theta)
    for k, p in enumerate(powers):
        MuT = torch.sum(B[k] * ucT[None, :, :], dim=1)  # (nd, nc)
        lam_Mu = torch.sum(lcT * MuT, dim=0).to(theta.dtype)  # (nc,)
        g = g + (p * theta ** (p - 1)) * lam_Mu
    return g


def _padded(g, space, nc):
    """Per-cell values of a CellRange's cells on the whole cell axis,
    zero elsewhere (g itself for a whole space): each rank's share of a
    DG0 gradient, summed over the ranks by parallel.grad_all_reduce."""
    cells = getattr(space, "cells", None)
    if cells is None:
        return g
    full = g.new_zeros(nc)
    full[cells[0]:cells[1]] = g
    return full


class AffineOperator:
    """x -> A(theta) x for one design, A affine in theta over a lane-major
    basis: Ae(theta) is combined once by K2 (under no_grad) and applied by
    the fused operator with free = ones. Calls are differentiable in theta
    and x through AffineApply. On one rank's cells (space a CellRange, the
    basis on its range) K2 combines theta's slice, each product ends in
    the ranks' all_reduce, and d theta is the range's values, zero
    elsewhere."""

    def __init__(self, basis, powers, theta, space):
        self.basis, self.powers, self.space = basis, tuple(powers), space
        self.theta = theta
        with torch.no_grad():
            self.Ae = _affine_combine(
                basis, _cut(theta.detach(), getattr(space, "cells", None)),
                self.powers)
        ones = torch.ones(space.n_dofs, dtype=self.Ae.dtype,
                          device=self.Ae.device)
        self.matvec = make_constrained_matvec_T(self.Ae, space, ones)

    def __call__(self, x):
        return AffineApply.apply(self.theta, x, self)


class AffineApply(torch.autograd.Function):
    """y = A(theta) x. A is symmetric, so dx = A g (one more fused-operator
    pass); d theta is the closed-form vjp_theta(theta, x, g), never the
    (nd, nd, nc) cotangent that AffineCombine.backward would form."""

    @staticmethod
    def forward(ctx, theta, x, op):
        ctx.op = op
        ctx.save_for_backward(theta, x)
        return op.matvec(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        theta, x = ctx.saved_tensors
        op = ctx.op
        g = g.contiguous()
        dth = dx = None
        if ctx.needs_input_grad[0]:
            dth = _padded(_vjp_theta(op.basis, op.powers, theta, x, g,
                                     op.space), op.space, theta.shape[0])
        if ctx.needs_input_grad[1]:
            dx = op.matvec(g)
        return dth, dx, None
