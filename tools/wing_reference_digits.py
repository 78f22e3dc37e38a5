"""The JAX package's digits on the PAV wing, the constants WING_DIGITS of
chip_smoke.py's `wing` phase, and the reference side of
tests/test_torch_wing.py and tests/test_torch_band.py (`tests`):

    FEMO_PLATFORM=cpu FEMO_COMPILE_CACHE=0 python tools/wing_reference_digits.py
    FEMO_PLATFORM=cpu FEMO_COMPILE_CACHE=0 python tools/wing_reference_digits.py tests

`tests` (~1 min) writes tests/reference_digits/wing.npz: at the tests'
seeded inputs (drawn here in the tests' order), with the JAX package's
FEMO_* solver flags unset, the penalty facet form's residual, energy,
element blocks and dofmap on the 6x10 wing (ribs at 5) under a mesh
motion; the p-norm (plain, masked, over a cell subset), elastic energy,
volume and surface area and the von Mises DG1 projection on the 4x6 wing
(rib at 3); every output of RMShellModel on the tiny tagged 4x6 wing and
the gradient of its aggregated stress; the f64 BandCholPrecond apply on
the 6x10 penalty wing; and disp_solid and d compliance / d thickness of
RMShellModel on the 8x36 wing (band-preconditioned CG).

femo_alpha_tpu's RMShellModel (penalty BCs, band-preconditioned CG, f64)
on tests/data/pav_like_wing_2388.msh at the PAV example's material and
elliptic 4,000 Pa pressure, uniform h = 0.005: prints aggregated_stress,
mass, compliance and |d aggregated_stress / d h| (2-norm over the cells).
It solves the full 35,370-dof system (about 1.3 GB of band storage), so
run it on a machine with a few GB to spare.
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from femo_alpha_tpu.mesh import readFEAMesh  # noqa: E402
from femo_alpha_tpu.models import RMShellModel  # noqa: E402


REF_FLAGS = ("FEMO_MG_F32", "FEMO_LANE_MAJOR", "FEMO_HOSTLOOP", "FEMO_CG_DF",
             "FEMO_OP_STORAGE", "FEMO_BAND_MEM_GB")


def _root(x):
    return np.abs(x[:, 1]) < 1e-9


def _root_and_rib(x):
    return (np.abs(x[:, 1]) < 1e-9) | (np.abs(x[:, 1] - 5.0) < 1e-9)


def _facet_form(out):
    """tests/test_torch_wing.py::test_penalty_facet_form_matches_reference"""
    from femo_alpha_tpu.mesh import createWingShellMesh
    from femo_alpha_tpu.models.rm_shell.pde import RMShellPDE

    ref = RMShellPDE(createWingShellMesh(n_chord=6, n_span=10,
                                         rib_stations=(5,)),
                     element_wise_material=True)
    rf = ref.make_penalty_facet_form(_root_and_rib)
    rng = np.random.default_rng(0)
    u = 1e-3 * rng.standard_normal(ref.W.n_dofs)
    pj = {"uhat": jnp.asarray(1e-3 * rng.standard_normal(
        3 * ref.mesh.n_nodes))}
    out["facet_residual"] = np.asarray(jax.jit(rf.assemble_residual)(
        jnp.asarray(u), pj))
    out["facet_energy"] = np.asarray(float(jax.jit(rf.assemble_scalar)(
        jnp.asarray(u), pj)))
    ops = jax.jit(rf.element_ops)(jnp.asarray(u), pj)
    out["facet_blocks"] = np.concatenate([np.asarray(a) for a, _ in ops])
    out["facet_dofmap"] = np.concatenate([np.asarray(d) for _, d in ops])


def _stress_forms(out):
    """tests/test_torch_wing.py::test_stress_and_scalar_forms_match_reference"""
    from femo_alpha_tpu.assembly.assemble import assemble_scalar
    from femo_alpha_tpu.assembly.assemble import assemble_scalar_subset
    from femo_alpha_tpu.mesh import createWingShellMesh
    from femo_alpha_tpu.models.rm_shell.pde import RMShellPDE

    ref = RMShellPDE(createWingShellMesh(n_chord=4, n_span=6,
                                         rib_stations=(3,)),
                     element_wise_material=True)
    mesh = ref.mesh
    nel, nn = mesh.n_cells, mesh.n_nodes
    rng = np.random.default_rng(1)
    u = 1e-5 * rng.standard_normal(ref.W.n_dofs)
    p = {"thickness": 0.005 * (1 + 0.2 * rng.uniform(size=nel)),
         "E": np.full(nel, 71.7e9), "nu": np.full(nel, 0.33),
         "uhat": 1e-3 * rng.standard_normal(3 * nn)}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    uj = jnp.asarray(u)
    cells = mesh.cell_tags[2]
    mask = np.zeros(nel)
    mask[cells] = 1.0
    jscalar = jax.jit(assemble_scalar, static_argnums=0)
    pn = ref.pnorm_stress_form()
    out["surface_area"] = np.asarray(ref.surface_area())
    out["scalar_forms"] = np.asarray([float(v) for v in (
        jscalar(pn, uj, pj),
        jscalar(ref.pnorm_stress_form(cell_mask=mask), uj,
                {**pj, "_mask": jnp.asarray(mask)}),
        jax.jit(lambda u_, p_: assemble_scalar_subset(pn, u_, p_, cells))(
            uj, pj),
        jscalar(ref.elastic_energy_form(), uj, pj),
        jscalar(ref.volume_form(), pj["thickness"], {"uhat": pj["uhat"]}))])
    project, _ = ref.von_mises_dg1_projection()
    out["von_mises_dg1"] = np.asarray(jax.jit(project)(uj, pj))


TINY = dict(n_chord=4, n_span=6, rib_stations=(3,))
TINY_OUTPUTS = ("disp_solid", "disp_extracted", "compliance", "mass",
                "volume", "elastic_energy", "pnorm_stress", "stress",
                "pnorm_stress_1", "pnorm_stress_2")


def _tiny_model(out):
    """tests/test_torch_wing.py's tiny tagged wing (dense path)"""
    from femo_alpha_tpu.mesh import createWingShellMesh

    mesh = createWingShellMesh(**TINY)
    model = RMShellModel(mesh, shell_bc_func=_root,
                         element_wise_material=True,
                         mesh_tags={t: np.asarray(c)
                                    for t, c in mesh.cell_tags.items()})
    nel, nn = mesh.n_cells, mesh.n_nodes
    rng = np.random.default_rng(2)
    f = np.zeros((nn, 3))
    f[:, 2] = 4000.0 * (1.0 + 0.1 * rng.standard_normal(nn))
    th = 0.005 * (1.0 + 0.2 * rng.uniform(size=nel))
    E, nu, rho = (jnp.full(nel, v) for v in (71.7e9, 0.33, 2780.0))

    def agg(th_):
        o = model.evaluate(jnp.asarray(f), th_, E, nu, rho)
        d = o.to_dict()
        return o.aggregated_stress, {k: d[k] for k in TINY_OUTPUTS}

    (val, outs), g = jax.value_and_grad(agg, has_aux=True)(jnp.asarray(th))
    for k, v in outs.items():
        out[f"tiny_{k}"] = np.asarray(v)
    out["tiny_aggregated_stress"] = np.asarray(float(val))
    out["tiny_grad"] = np.asarray(g)


def _band_apply(out):
    """tests/test_torch_band.py::test_band_precond_on_penalty_wing_matches_reference"""
    from femo_alpha_tpu.assembly.assemble import element_matrices
    from femo_alpha_tpu.mesh import createWingShellMesh
    from femo_alpha_tpu.models.rm_shell.pde import RMShellPDE
    from femo_alpha_tpu.solvers import band as RB

    ref = RMShellPDE(createWingShellMesh(6, 10, rib_stations=(5,)),
                     element_wise_material=True)
    nel, nn, n = ref.mesh.n_cells, ref.mesh.n_nodes, ref.W.n_dofs
    rng = np.random.default_rng(3)
    p = {"thickness": 0.01 * (1 + 0.2 * rng.uniform(size=nel)),
         "E": np.full(nel, 7e10), "nu": np.full(nel, 0.33),
         "uhat": np.zeros(3 * nn), "F_solid": np.zeros(3 * nn)}
    b = rng.standard_normal(n)
    rf = ref.make_penalty_facet_form(_root)
    form = ref.make_residual_form()
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    f_ops = jax.jit(rf.element_ops)(jnp.zeros(n), pj)
    specs = [ref.W] + [d for _, d in f_ops]
    dms = [np.asarray(ref.W.dofmap)] + [np.asarray(d) for _, d in f_ops]
    rband = RB.BandCholPrecond(ref.W, dms, dtype=jnp.float64)

    @jax.jit
    def ref_apply(p_, b_):
        Ae = element_matrices(form, jnp.zeros(n), p_)
        mats = [Ae] + [a for a, _ in f_ops]
        return rband.apply(rband.setup(list(zip(mats, specs))), b_)

    out["band_apply"] = np.asarray(ref_apply(pj, jnp.asarray(b)))


def _band_model(out):
    """tests/test_torch_band.py's 8x36 wing (band-preconditioned CG)"""
    from femo_alpha_tpu.mesh import createWingShellMesh

    mesh = createWingShellMesh(n_chord=8, n_span=36, rib_stations=(18,))
    model = RMShellModel(mesh, shell_bc_func=_root,
                         element_wise_material=True)
    assert "precond_factory" in model.fea.states["disp_solid"].solver_opts
    nel, nn = mesh.n_cells, mesh.n_nodes
    rng = np.random.default_rng(4)
    f = np.zeros(3 * nn)
    f[2::3] = 50.0 * (1.0 + 0.1 * rng.standard_normal(nn))
    th = 0.02 * (1.0 + 0.2 * rng.uniform(size=nel))
    E, nu, rho = (jnp.full(nel, v) for v in (7e10, 0.33, 2700.0))

    def J(th_):
        o = model.evaluate(jnp.asarray(f), th_, E, nu, rho)
        return o.compliance, o.disp_solid

    (_, u), g = jax.value_and_grad(J, has_aux=True)(jnp.asarray(th))
    out["band_model_u"] = np.asarray(u)
    out["band_model_grad"] = np.asarray(g)


def tests():
    for flag in REF_FLAGS:
        os.environ.pop(flag, None)
    out = {}
    for part in (_facet_form, _stress_forms, _tiny_model, _band_apply,
                 _band_model):
        part(out)
    path = os.path.join(os.path.dirname(HERE), "tests", "reference_digits",
                        "wing.npz")
    np.savez_compressed(path, **out)
    for k, v in out.items():
        print(k, v.tolist() if v.size <= 6 else v.shape)
    print(f"wrote {os.path.relpath(path, os.path.dirname(HERE))}")


def main():
    if sys.argv[1:] == ["tests"]:
        tests()
        return
    mesh = readFEAMesh(os.path.join(os.path.dirname(HERE), "tests", "data",
                                    "pav_like_wing_2388.msh"))
    nel, nn = mesh.n_cells, mesh.n_nodes
    model = RMShellModel(mesh, shell_bc_func=lambda x: x[:, 1] < 1e-9,
                         element_wise_material=True,
                         mesh_tags={t: np.asarray(c)
                                    for t, c in mesh.cell_tags.items()})
    span = float(np.max(mesh.coords[:, 1]))
    eta = np.clip(np.asarray(mesh.coords[:, 1]) / span, 0.0, 1.0)
    pressure = np.zeros((nn, 3))
    pressure[:, 2] = 4000.0 * np.sqrt(1.0 - eta ** 2)
    E, nu, rho = (jnp.full(nel, v) for v in (71.7e9, 0.33, 2780.0))

    def agg(th):
        out = model.evaluate(jnp.asarray(pressure), th, E, nu, rho)
        return out.aggregated_stress, (out.mass, out.compliance)

    (a, (mass, comp)), g = jax.value_and_grad(agg, has_aux=True)(
        jnp.full(nel, 0.005))
    print(f"aggregated_stress {float(a):.9e}")
    print(f"mass {float(mass):.9e}")
    print(f"compliance {float(comp):.9e}")
    print(f"grad_norm {float(jnp.linalg.norm(g)):.9e}")


if __name__ == "__main__":
    main()
