"""Which SLSQP iterates of the example studies follow rounding: the same
study run twice with only the arithmetic's order changed.

    FEMO_PLATFORM=cpu python tools/examples_rounding_probe.py [lpc|beam|static]

`lpc`: the port's ex_lpc_gust_like_opt at its own configuration (16
steps) for 2 SLSQP iterations on the CPU with 1, 2, 4 and 8 torch threads:
the scaled objective at each iterate and the last design (~1 min).
`beam`: the JAX package's beam study of ex_thickness_opt_cantilever_beam
for 2 iterations, jitted and eager (~10 s). `static`: on the penalty-BC
wing of ex_lpc_static_multicase_opt (2,322 dofs, the dense path) at the
initial thickness, each load case's state by the port's dense Cholesky
and by a host SuperLU solve of the same assembled system, and the
case's tip p-norm from each against the JAX digits (~10 s): what two
f64 direct solves of this system can agree on. Where two runs part, the
examples' tests and chip_smoke.py's `examples` phase compare fewer
iterates (tests/test_torch_examples.py, tools/examples_reference_digits.py).
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))


def lpc():
    import torch

    from femo_alpha_tpu_torch.examples import ex_lpc_gust_like_opt

    for n in (1, 2, 4, 8):
        torch.set_num_threads(n)
        r = ex_lpc_gust_like_opt.main(["--maxiter", "2", "--device", "cpu"])
        print(f"lpc threads {n}: history "
              + " ".join(f"{v:.9e}" for v in r["history"])
              + f", last design {np.array2string(r['designs'][-1])}, "
              f"counts {r['counts'].tolist()}", flush=True)


def beam():
    from opt_reference_digits import RecordingProblem

    from femo_alpha_tpu.models import EulerBernoulliBeamModel

    b = EulerBernoulliBeamModel(nel=50, L=1.0, E=1.0, width=0.1,
                                tip_load=-1.0)
    for jit in (True, False):
        prob = RecordingProblem(lambda dv: b.evaluate(dv["thickness"]),
                                jit=jit)
        prob.add_design_variable("thickness", 0.1 * np.ones(50), lower=1e-2,
                                 upper=10.0)
        prob.set_objective("compliance")
        prob.add_constraint("volume", equals=0.01)
        xs = []
        _, res = prob.solve(maxiter=2, ftol=1e-9, report=False,
                            callback=lambda x: xs.append(np.array(x)))
        hist = [prob.seen[x.tobytes()] for x in xs]
        print(f"beam jit={jit}: history "
              + " ".join(f"{v:.9e}" for v in hist)
              + f", counts {[res.nit, res.nfev, res.njev]}", flush=True)


def static():
    import scipy.sparse.linalg as spla
    import torch

    from femo_alpha_tpu_torch.examples import ex_lpc_static_multicase_opt as m
    from femo_alpha_tpu_torch.models.rm_shell.model import (
        DisplacementExtractionModel,
    )
    from femo_alpha_tpu_torch.utils.quality import sparse_operator

    torch.set_num_threads(1)
    ex = m.build(device="cpu")
    model, mesh = ex["model"], ex["mesh"]
    pde = model.fea.states["disp_solid"].pde
    ext = DisplacementExtractionModel(model.shell_pde)
    nel, kw = mesh.n_cells, dict(dtype=torch.float64)
    th = torch.full((nel,), m.INITIAL_THICKNESS, **kw)
    E, nu = torch.full((nel,), 69e9, **kw), torch.full((nel,), 0.33, **kw)
    span = float(np.max(mesh.coords[:, 1]))
    tip = np.where(np.asarray(mesh.coords[:, 1]) > span * (1 - 1e-9))[0]
    eta = np.clip(np.asarray(mesh.coords[:, 1]) / span, 0.0, 1.0)
    coords, conn = np.asarray(mesh.coords), np.asarray(mesh.conn)
    skin = np.asarray(mesh.cell_tags.get(1))
    planform = float(np.sum(np.linalg.norm(np.cross(
        coords[conn[skin, 1]] - coords[conn[skin, 0]],
        coords[conn[skin, 3]] - coords[conn[skin, 0]]), axis=1)))
    p1g = m.SYSTEM_MASS / 2.0 * m.G / max(planform, 1.0)
    with np.load(os.path.join(ROOT, "tests", "reference_digits",
                              "examples.npz")) as z:
        ref = {k: float(z[f"chip.ex_lpc_static_multicase_opt.{k}_tip_disp0"])
               for k in m.CASE_FACTORS}

    def pnorm(u):
        uz = ext.evaluate(torch.as_tensor(u))[tip, 2].numpy()
        return float(np.sum(np.abs(uz) ** 20.0) ** (1.0 / 20.0))

    for name, fac in m.CASE_FACTORS.items():
        p = np.zeros((mesh.n_nodes, 3))
        p[:, 2] = fac * p1g * np.sqrt(1.0 - eta**2)
        with torch.no_grad():
            u = model.evaluate(p, thickness=th, E=E, nu=nu,
                               density=torch.full((nel,), 2700.0, **kw)
                               ).disp_solid.numpy()
        B, b = sparse_operator(pde, model.fe_inputs(torch.as_tensor(p), th,
                                                     E, nu))
        ud = spla.splu(B, permc_spec="MMD_AT_PLUS_A").solve(b)
        t, td = pnorm(u), pnorm(ud)
        print(f"static {name}: state dense vs SuperLU "
              f"{np.linalg.norm(u - ud) / np.linalg.norm(ud):.3e}; tip "
              f"p-norm dense {t!r}, SuperLU {td!r} ({td / t - 1:.3e}), "
              f"JAX {ref[name]!r} (dense {t / ref[name] - 1:.3e}, "
              f"SuperLU {td / ref[name] - 1:.3e})", flush=True)


if __name__ == "__main__":
    for part in sys.argv[1:] or ["lpc", "beam", "static"]:
        {"lpc": lpc, "beam": beam, "static": static}[part]()
