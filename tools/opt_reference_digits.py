"""The JAX package's digits on the PAV wing thickness study, the constants
OPT_DIGITS of chip_smoke.py's `opt` phase, and the reference side of
tests/test_torch_opt.py (`tests`):

    FEMO_PLATFORM=cpu FEMO_COMPILE_CACHE=0 python tools/opt_reference_digits.py [MAXITER]
    FEMO_PLATFORM=cpu FEMO_COMPILE_CACHE=0 python tools/opt_reference_digits.py tests

`tests` (~1.5 min) writes tests/reference_digits/opt.npz: the JAX
package's OptimizationProblem on tests/test_opt_vector.py's two vector
problems (x*, nit / nfev / njev); its StateOperation, OutputOperation
and OutputFieldOperation on the test's 8x4 strong-BC plate (2 x 1,
element-wise, the dense path) at the test's seeded inputs
(default_rng(0): thickness, E; then the test's draws in its order: g_u,
the tangents, the cotangent of the stress field), jitted as the test
calls them; and tests/test_wing_opt.py's study (6x12 generated wing,
ribs at 6, shuffle 3, penalty root clamp, E 69e9, nu 0.33, rho 2,700,
the elliptic 2,000 Pa lift, h0 = 0.006 in [0.002, 0.02], min mass s.t.
aggregated stress <= 1.10 x its value at h0, maxiter 3, ftol 1e-8),
jitted: the objective at each iterate and nit / nfev / njev.

femo_alpha_tpu's OptimizationProblem (scipy SLSQP) on the problem of
examples/advanced_examples/pav_shell_opt/ex_pav_wing_thickness_opt.py:
RMShellModel with penalty BCs and the file's mesh tags on
tests/data/pav_like_wing_2388.msh (2,388 quads, 35,370 dofs), E 71.7e9,
nu 0.33, rho 2780, the elliptic 4,000 Pa lift pressure; min mass/mass0
subject to aggregated_stress <= 503e6/1.5 (scaler 1.5/503e6), 2,388
thicknesses in [0.001, 0.02] from h0 = 0.005, ftol 1e-8, maxiter
MAXITER (by default 1, chip_smoke.py's OPT_MAXITER). It prints the scaled objective at each SLSQP
iteration (callback order), the final mass and aggregated stress, and
nit / nfev / njev, with the scipy version (the SLSQP trajectory depends
on it). Runs eagerly (jit=False: the same numbers without compiling the
whole band path); each evaluation solves the full system by
band-preconditioned CG, so expect ~10-20 min on 8 cores.
"""

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import jax.numpy as jnp  # noqa: E402
import scipy  # noqa: E402

from femo_alpha_tpu.mesh import readFEAMesh  # noqa: E402
from femo_alpha_tpu.models import RMShellModel  # noqa: E402
from femo_alpha_tpu.opt import OptimizationProblem  # noqa: E402

MAXITER = 1


class RecordingProblem(OptimizationProblem):
    """Keeps the objective value of every point it evaluates, so the
    per-iteration history costs no extra solve."""

    seen: dict

    def _scalar_fn(self, name, scaler=1.0):
        vg = super()._scalar_fn(name, scaler)
        self.seen = {}

        def rec(x):
            v, g = vg(x)
            self.seen[np.asarray(x, dtype=np.float64).tobytes()] = float(v)
            return v, g

        return rec


def _vector_problem(case):
    """tests/test_opt_vector.py's two problems, in jax.numpy."""
    class Out:
        pass

    if case == "lower":
        def ev(dv):
            out = Out()
            out.obj = jnp.sum(dv["x"] ** 2)
            out.con = dv["x"]
            return out

        def build(prob):
            prob.add_design_variable("x", np.array([5.0, 5.0, 5.0]))
            prob.set_objective("obj")
            prob.add_constraint("con", lower=np.array([1.0, 2.0, 3.0]))
        return ev, build, 100

    def ev(dv):
        x = dv["x"]
        out = Out()
        out.obj = jnp.sum((x - 2.0) ** 2)
        out.eqs = jnp.stack([x[0] + x[1], x[2]])
        out.x3 = x[3]
        return out

    def build(prob):
        prob.add_design_variable("x", np.zeros(4))
        prob.set_objective("obj")
        prob.add_constraint("eqs", equals=np.array([1.0, 0.5]))
        prob.add_constraint("x3", upper=0.0)
    return ev, build, 200


def _plate_digits(out):
    """The csdl contracts on the 8x4 plate, in the test's order of draws."""
    import jax

    from femo_alpha_tpu.csdl_opt import (
        OutputFieldOperation,
        OutputOperation,
        StateOperation,
    )
    from femo_alpha_tpu.mesh import createRectangleMesh

    mesh = createRectangleMesh(8, 4, (0, 0), (2.0, 1.0), "quad", gdim=3)
    ref = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 0] < 1e-12,
                       element_wise_material=True, PENALTY_BC=False)
    rng = np.random.default_rng(0)
    nel, nn = mesh.n_cells, mesh.n_nodes
    f = np.zeros(3 * nn)
    f[2::3] = 5e3
    inputs = {"thickness": 0.02 + 0.01 * rng.random(nel), "F_solid": f,
              "E": 7e10 * (1 + 0.1 * rng.random(nel)),
              "nu": np.full(nel, 0.3), "uhat": np.zeros(3 * nn)}
    rop = StateOperation(ref.fea, "disp_solid")
    u_r = rop.solve_residual_equations(
        {k: jnp.asarray(v) for k, v in inputs.items()})
    g_u = rng.standard_normal(u_r.shape[0])
    lam_r = rop.apply_inverse_jacobian(jnp.asarray(g_u), "rev")
    tangents = {k: rng.standard_normal(np.shape(v))
                for k, v in inputs.items()}
    tangents["uhat"] = np.zeros_like(inputs["uhat"])
    dr_r = jax.jit(lambda t: rop.compute_jacvec_product(
        inputs, "fwd", t))(tangents)
    out["state_u"] = np.asarray(u_r)
    out["state_lam"] = np.asarray(lam_r)
    out["state_dr"] = np.asarray(dr_r)
    out["state_du"] = np.asarray(rop.apply_inverse_jacobian(dr_r, "fwd"))
    d_in_r = jax.jit(lambda lr: rop.compute_jacvec_product(
        inputs, "rev", lr))(lam_r)
    for k, v in d_in_r.items():
        out[f"state_d_in_{k}"] = np.asarray(v)
    # the output operations at the reference's state
    u = StateOperation(ref.fea, "disp_solid").solve_residual_equations(
        {k: jnp.asarray(v) for k, v in inputs.items()})
    vals = dict(inputs, disp_solid=np.asarray(u))
    cop = OutputOperation(ref.fea, "compliance")
    out["output_compliance"] = np.asarray(float(cop.compute(vals)))
    g = jax.jit(cop.compute_derivatives)(vals)
    for k in ("disp_solid", "thickness"):
        out[f"output_d_{k}"] = np.asarray(g[k])
    fop = OutputFieldOperation(ref.fea, "stress")
    s = np.asarray(fop.compute(vals))
    out["output_stress"] = s
    ct = rng.standard_normal(s.shape[0])
    wrt = ["disp_solid", "thickness", "E"]
    v = jax.jit(lambda vs, c: fop.compute_vjp(vs, c, wrt))(vals, ct)
    for k in wrt:
        out[f"output_vjp_{k}"] = np.asarray(v[k])


def _wing_digits(out):
    """tests/test_wing_opt.py's study at maxiter 3, jitted."""
    from femo_alpha_tpu.mesh import createWingShellMesh

    mesh = createWingShellMesh(n_chord=6, n_span=12, rib_stations=(6,),
                               shuffle_seed=3)
    nel, nn = mesh.n_cells, mesh.n_nodes
    span = float(np.max(mesh.coords[:, 1]))
    eta = np.clip(np.asarray(mesh.coords[:, 1]) / span, 0.0, 1.0)
    pressure = np.zeros((nn, 3))
    pressure[:, 2] = 2000.0 * np.sqrt(1.0 - eta ** 2)
    base = dict(E=np.full(nel, 69e9), nu=np.full(nel, 0.33),
                density=np.full(nel, 2700.0))
    h0 = 0.006
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 1] < 1e-9,
                         element_wise_material=True, record=False)

    def ev(dv):
        return model.evaluate(pressure, thickness=dv["thickness"],
                              is_pressure=True, **base)

    out0 = ev({"thickness": np.full(nel, h0)})
    mass0, agg0 = float(out0.mass), float(out0.aggregated_stress)
    prob = RecordingProblem(ev)
    prob.add_design_variable("thickness", h0 * np.ones(nel), lower=0.002,
                             upper=0.02)
    prob.add_constraint("aggregated_stress", upper=1.10 * agg0,
                        scaler=1.0 / agg0)
    prob.set_objective("mass", scaler=1.0 / mass0)
    xs = []
    _, res = prob.solve(maxiter=3, ftol=1e-8, report=False,
                        callback=lambda x: xs.append(np.array(x)))
    out["wing_history"] = np.asarray(
        [prob.seen[np.asarray(x, dtype=np.float64).tobytes()] for x in xs])
    out["wing_counts"] = np.asarray([res.nit, res.nfev, res.njev])


def tests():
    t_start = time.perf_counter()
    out = {}
    for case in ("lower", "equality_and_upper"):
        ev, build, maxiter = _vector_problem(case)
        prob = OptimizationProblem(ev)
        build(prob)
        dvs, res = prob.solve(maxiter=maxiter, report=False)
        out[f"vector_{case}_x"] = np.asarray(dvs["x"])
        out[f"vector_{case}_counts"] = np.asarray([res.nit, res.nfev,
                                                   res.njev])
    _plate_digits(out)
    _wing_digits(out)
    path = os.path.join(os.path.dirname(HERE), "tests", "reference_digits",
                        "opt.npz")
    np.savez_compressed(path, **out)
    print(f"scipy {scipy.__version__}")
    for k, v in out.items():
        print(k, v.tolist() if v.size <= 6 else f"{v.shape}")
    print(f"wrote {os.path.relpath(path, os.path.dirname(HERE))}")
    print(f"seconds {time.perf_counter() - t_start:.1f}")


def main():
    if sys.argv[1:] == ["tests"]:
        tests()
        return
    t_start = time.perf_counter()
    mesh = readFEAMesh(os.path.join(os.path.dirname(HERE), "tests", "data",
                                    "pav_like_wing_2388.msh"))
    nel, nn = mesh.n_cells, mesh.n_nodes
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 1] < 1e-9,
                         element_wise_material=True, record=False,
                         mesh_tags={t: np.asarray(c)
                                    for t, c in mesh.cell_tags.items()})
    span = float(np.max(mesh.coords[:, 1]))
    eta = np.clip(np.asarray(mesh.coords[:, 1]) / span, 0.0, 1.0)
    pressure = np.zeros((nn, 3))
    pressure[:, 2] = 4000.0 * np.sqrt(1.0 - eta ** 2)
    base = dict(E=jnp.full(nel, 71.7e9), nu=jnp.full(nel, 0.33),
                density=jnp.full(nel, 2780.0))
    sigma_y, safety, h0 = 503.0e6, 1.5, 0.005

    def ev(dv):
        return model.evaluate(jnp.asarray(pressure),
                              thickness=dv["thickness"], is_pressure=True,
                              **base)

    out0 = ev({"thickness": jnp.full(nel, h0)})
    mass0 = float(out0.mass)
    prob = RecordingProblem(ev, jit=False)
    prob.add_design_variable("thickness", h0 * np.ones(nel), lower=0.001,
                             upper=0.02)
    prob.add_constraint("aggregated_stress", upper=sigma_y / safety,
                        scaler=safety / sigma_y)
    prob.set_objective("mass", scaler=1.0 / mass0)
    xs = []
    maxiter = int(sys.argv[1]) if len(sys.argv) > 1 else MAXITER
    dvs, res = prob.solve(maxiter=maxiter, ftol=1e-8,
                          callback=lambda xk: xs.append(np.array(xk)),
                          report=False)
    hist = [prob.seen[x.tobytes()] for x in xs]
    out = ev({"thickness": jnp.asarray(dvs["thickness"])})
    print(f"scipy {scipy.__version__}, maxiter {maxiter}")
    print(f"mass0 {mass0:.15e}")
    print("history " + " ".join(f"{v:.15e}" for v in hist))
    print(f"mass {float(out.mass):.15e}")
    print(f"aggregated_stress {float(out.aggregated_stress):.15e}")
    print(f"nit {res.nit} nfev {res.nfev} njev {res.njev}")
    print(f"message {res.message!r}")
    print(f"seconds {time.perf_counter() - t_start:.1f}")


if __name__ == "__main__":
    main()
