"""Design-affine element-operator decomposition (lane-major).

Port of femo_alpha_tpu/assembly/affine.py. For forms whose element matrices
are a polynomial in a per-cell (DG0) design field — the MID-plane RM shell
stiffness with element-wise thickness is exactly h*M1 + h^3*M3 —

    Ae(theta)[:, :, c] = sum_k theta_c**powers[k] * M_k[:, :, c],

the basis M_k is extracted once from len(powers) probe assemblies and a
small Vandermonde solve; each new design then costs one K2 combine
(cuda_kernels.affine_combine) instead of a jacfwd assembly.

The port stores the basis lane-major (K, nd, nd, nc) in native f64 or f32:
the JAX package's float-float storage and its disk cache exist for the
TPU's lack of f64 and for its compile times, and are not carried over.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .assemble import element_matrices
from .cuda_kernels import affine_combine


def _affine_combine(B, theta, powers):
    """Ae(theta) = sum_k theta^p_k * B[k] for a lane-major basis (K2)."""
    return affine_combine(B, theta.to(B.dtype), powers)


class AffineDesignOperator:
    """Element matrices affine in powers of a scalar per-cell design field.

    form: FemForm with the design field among its params; u0: linearization
    state (zeros for linear problems); params_of: theta -> full params dict;
    powers: exponents of the polynomial dependence; probe_scale: magnitude
    of the probe values; dtype: dtype of the stored basis (None = the
    assembly dtype)."""

    def __init__(self, form, u0, params_of, key="thickness", powers=(1, 3),
                 probe_scale=1.0, chunk=8192, dtype=None):
        self.form = form
        self.key = key
        self.powers = tuple(int(p) for p in powers)
        K = len(self.powers)
        nc = form.space.mesh.n_cells
        probes = probe_scale * np.arange(1.0, K + 1.0)
        G = np.stack([probes ** p for p in self.powers], axis=1)  # (K, K)
        Ginv = np.linalg.inv(G)
        Ae_probes = [
            element_matrices(form, u0, params_of(torch.full(
                (nc,), float(t), dtype=u0.dtype, device=u0.device)),
                chunk=chunk)
            for t in probes]
        basis = []
        for k in range(K):
            Mk = sum(float(Ginv[k, i]) * Ae_probes[i] for i in range(K))
            Mk = Mk.permute(1, 2, 0)  # (nd, nd, nc)
            basis.append(Mk if dtype is None else Mk.to(dtype))
        self.basis = torch.stack(basis).contiguous()
        self.nc = nc

    def element_matrices(self, theta, basis=None):
        """Ae(theta): (nd, nd, nc) lane-major."""
        B = self.basis if basis is None else basis
        return _affine_combine(B, theta, self.powers)

    def verify(self, theta, u0, params_of, rtol=1e-9, chunk=8192):
        """Check the decomposition against one direct assembly at `theta`;
        raises if the design dependence is not the declared polynomial.
        Returns the relative max-abs error."""
        direct = element_matrices(self.form, u0, params_of(theta),
                                  chunk=chunk)
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
    enter the Jacobian (pure load terms) and are zeroed in the probes."""

    def __init__(self, form, key="thickness", powers=(1, 3),
                 probe_scale=None, chunk=8192, dtype=None, verify=True,
                 ignore_keys=("F_solid",)):
        self.form = form
        self.key = key
        self.powers = tuple(int(p) for p in powers)
        self.chunk = chunk
        self.dtype = dtype
        self.verify = verify
        self.probe_scale = probe_scale
        self.ignore_keys = tuple(ignore_keys)
        self._cache_key = None
        self._aff = None

    def prepare(self, params):
        """The affine basis for these parameters (built or reused)."""
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
            self._aff = AffineDesignOperator(
                self.form, u0, params_of, key=self.key, powers=self.powers,
                probe_scale=ps, chunk=self.chunk, dtype=self.dtype)
            if self.verify:
                self._aff.verify(theta, u0, params_of, chunk=self.chunk)
            self._cache_key = ck
        return self._aff.basis

    def combine(self, theta, basis):
        """Affine combine with an explicit basis -> (nd, nd, nc)."""
        return _affine_combine(basis, theta, self.powers)

    def __call__(self, u, params, basis=None):
        if basis is None:
            basis = self.prepare(params)
        return self.combine(params[self.key], basis)
