"""The two kernels' plain twins (the CPU path of cuda_kernels.py) against
the JAX package: K1 cell_matvec_T against the reference sum-form and the
Pallas kernel in interpret mode; K2 affine_combine against the reference's
f64 lane combine and the float-float Pallas kernel in interpret mode; and
K2's reverse rule through torch.autograd.gradcheck. The kernels
themselves run only on the card (tests/test_torch_gpu.py and
chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from femo_alpha_tpu.assembly import pallas_kernels as pk
from femo_alpha_tpu.assembly.affine import _affine_combine as ref_combine
from femo_alpha_tpu.assembly.assemble import cell_matvec_T as ref_matvec_T
from femo_alpha_tpu.solvers.dfloat import DF, df_from_f64, df_to_f64

from femo_alpha_tpu_torch import interop
from femo_alpha_tpu_torch.assembly import cuda_kernels as ck

# relative-norm bars: a length-nd dot product in the working dtype
K1_BAR = {np.float32: 1e-6, np.float64: 1e-14}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _pallas_matvec(A, x, bc=128):
    nd, _, nc = A.shape
    return pl.pallas_call(
        pk._matvec_kernel,
        out_shape=jax.ShapeDtypeStruct((nd, nc), x.dtype),
        grid=(nc // bc,),
        in_specs=[pl.BlockSpec((nd, nd, bc), lambda i: (i * 0, i * 0, i)),
                  pl.BlockSpec((nd, bc), lambda i: (i * 0, i))],
        out_specs=pl.BlockSpec((nd, bc), lambda i: (i * 0, i)),
        interpret=True,
    )(A, x)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nd,nc", [(39, 512), (12, 256), (3, 128)])
def test_k1_twin_matches_reference_and_pallas(nd, nc, dtype):
    rng = np.random.default_rng(nd * 1000 + nc)
    A = rng.standard_normal((nd, nd, nc)).astype(dtype)
    x = rng.standard_normal((nd, nc)).astype(dtype)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    y = ck.cell_matvec_T(interop.element_matrices_to_lane(A, "lane", tdt),
                         interop.to_tensor(x, tdt)).numpy()
    assert y.dtype == dtype
    y_ref = np.asarray(ref_matvec_T(jnp.asarray(A), jnp.asarray(x)))
    y_pal = np.asarray(_pallas_matvec(jnp.asarray(A), jnp.asarray(x)))
    assert _rel(y, y_ref) <= K1_BAR[dtype]
    assert _rel(y, y_pal) <= K1_BAR[dtype]


def _basis(nd=13, nc=256, K=2, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((K, nd, nd, nc)) * 1e3,
            rng.uniform(0.1, 0.3, nc))


@pytest.mark.parametrize("powers", [(1,), (1, 3), (1, 2, 3), (0, 1, 2, 3)])
def test_k2_twin_matches_reference_f64_combine(powers):
    B, th = _basis(K=len(powers))
    out = ck.affine_combine(interop.affine_basis_to_lane(B, "lane"),
                            interop.to_tensor(th), powers).numpy()
    ref = np.asarray(ref_combine(jnp.asarray(B), jnp.asarray(th), powers,
                                 "lane"))
    assert _rel(out, ref) <= 1e-15


def test_k2_twin_matches_pallas_float_float_combine():
    B, th = _basis()
    powers = (1, 3)
    Bdf = df_from_f64(jnp.asarray(B))
    cs = [df_from_f64(jnp.asarray(th) ** p) for p in powers]
    bc = pk.use_pallas_combine(Bdf.hi, force=True)
    hi, lo = pk.combine_df_pallas(
        Bdf.hi, Bdf.lo, jnp.stack([c.hi for c in cs])[:, None, :],
        jnp.stack([c.lo for c in cs])[:, None, :], bc, interpret=True)
    fused = np.asarray(df_to_f64(DF(hi, lo)))
    out = ck.affine_combine(interop.affine_basis_to_lane(B, "lane"),
                            interop.to_tensor(th), powers).numpy()
    # the TPU kernel carries ~2^-48 relative (float-float): the repo's own
    # precedent bar for it against the exact f64 combine
    assert np.max(np.abs(out - fused)) / np.max(np.abs(out)) <= 1e-13


@pytest.mark.parametrize("powers", [(1, 3), (1, 2, 3)])
def test_k2_reverse_rule_gradcheck(powers):
    rng = np.random.default_rng(4)
    B = torch.as_tensor(rng.standard_normal((len(powers), 3, 3, 5)),
                        dtype=torch.float64).requires_grad_(True)
    th = torch.as_tensor(rng.uniform(0.5, 1.5, 5),
                         dtype=torch.float64).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda b, t: ck.affine_combine(b, t, powers), (B, th))


def test_k2_reverse_rule_matches_twin_autograd():
    B, th = _basis(nd=7, nc=64)
    Bt = interop.affine_basis_to_lane(B, "lane")
    G = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (7, 7, 64)))
    t1 = interop.to_tensor(th).requires_grad_(True)
    (g1,) = torch.autograd.grad(ck.AffineCombine.apply(Bt, t1, (1, 3)), t1,
                                G)
    t2 = interop.to_tensor(th).requires_grad_(True)
    (g2,) = torch.autograd.grad(ck.affine_combine_plain(Bt, t2, (1, 3)), t2,
                                G)
    assert _rel(g1.numpy(), g2.numpy()) <= 1e-12
