"""Public names of the JAX package that the port now carries, each against
its JAX counterpart on the CPU: io.write_msh, LinearSolver.lift,
DenseSolver, solve_spd_small, shell_mg_precond_factory,
ForceReshapingModel, MixedSpace.function and
RMShellModel(additional_outputs=).

Inputs are made with numpy from a seed and handed to both packages; f64
throughout; the reference runs with its FEMO_* solver flags unset. Where
a live JAX call costs more than ~10 s (the MG-preconditioned plate, the
model with additional_outputs) the test reads the JAX package's results
from tests/reference_digits/api.npz (tools/api_reference_digits.py).
Tolerances: the gmsh text equal character for character; the dense
solves at 1e-12; the Poisson lift and solve at 1e-12; the MG-preconditioned
plate's state at the reference test's 1e-9 (max abs) with the same CG
iterations; the force reshaping and the function vectors exactly; the
8x2 model with additional_outputs at 1e-9."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from femo_alpha_tpu.assembly import (
    FemForm as RefForm,
    assemble_residual as ref_residual,
    combine_bcs as ref_combine,
    DirichletBC as RefBC,
    element_matrices as ref_elmats,
)
from femo_alpha_tpu.assembly.geometry import map_gradients as ref_map
from femo_alpha_tpu.io.gmsh import write_msh as ref_write_msh
from femo_alpha_tpu.mesh import (
    Mesh as RefMesh,
    createRectangleMesh as ref_rect,
    createUnitSquareMesh as ref_unit,
)
from femo_alpha_tpu.models.rm_shell.model import (
    ForceReshapingModel as RefReshape,
)
from femo_alpha_tpu.models.rm_shell.pde import RMShellPDE as RefPDE
from femo_alpha_tpu.solvers.direct import (
    DenseSolver as RefDense,
    solve_spd_small as ref_spd_small,
)
from femo_alpha_tpu.solvers.linear import LinearSolver as RefSolver
from femo_alpha_tpu.spaces import (
    FunctionSpace as RefSpace,
    MixedSpace as RefMixed,
    locate_dofs_geometric as ref_locate,
)

from femo_alpha_tpu_torch.assembly import (
    DirichletBC,
    FemForm,
    assemble_residual,
    combine_bcs,
    element_matrices,
)
from femo_alpha_tpu_torch.assembly.geometry import map_gradients
from femo_alpha_tpu_torch.io import read_msh, write_msh
from femo_alpha_tpu_torch.mesh import (
    Mesh,
    StructuredQuadMesh,
    createRectangleMesh,
    createUnitSquareMesh,
)
from femo_alpha_tpu_torch.models import ForceReshapingModel, RMShellModel
from femo_alpha_tpu_torch.models.rm_shell.mg import (
    build_shell_mg,
    shell_mg_precond_factory,
)
from femo_alpha_tpu_torch.models.rm_shell.pde import RMShellPDE
from femo_alpha_tpu_torch.solvers import DenseSolver, LinearSolver
from femo_alpha_tpu_torch.solvers.direct import solve_spd_small
from femo_alpha_tpu_torch.spaces import (
    FunctionSpace,
    MixedSpace,
    locate_dofs_geometric,
)

REF_FLAGS = ("FEMO_MG_F32", "FEMO_LANE_MAJOR", "FEMO_HOSTLOOP", "FEMO_CG_DF",
             "FEMO_OP_STORAGE")


def _bc(x):
    return x[:, 0] < 1e-12


def _rel(a, b):
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                   dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def api_digits():
    with np.load(os.path.join(os.path.dirname(__file__), "reference_digits",
                              "api.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def ref_env():
    with pytest.MonkeyPatch.context() as mp:
        for flag in REF_FLAGS:
            mp.delenv(flag, raising=False)
        yield


@pytest.mark.parametrize("version", ["2.2", "4.1"])
@pytest.mark.parametrize("cell_type", ["quad", "triangle"])
def test_write_msh_matches_reference(tmp_path, version, cell_type):
    """The port's writer emits the JAX writer's text for the same mesh
    (seeded out-of-plane coordinates, two physical tags in two runs of
    cells, named), and the port's read_msh gives the mesh, its tags and
    names back."""
    base = createRectangleMesh(4, 3, (0, 0), (2.0, 1.5), cell_type, gdim=3,
                               structured=False)
    coords = np.asarray(base.coords).copy()
    coords[:, 2] = 0.1 * np.random.default_rng(0).standard_normal(
        len(coords))
    mesh = Mesh(coords, base.conn, cell_type)
    tags = np.ones(mesh.n_cells, dtype=np.int64)
    tags[mesh.n_cells // 2:] = 7
    names = {1: "a", 7: "b"}
    path, ref_path = tmp_path / "port.msh", tmp_path / "ref.msh"
    write_msh(str(path), mesh, version=version, cell_tags=tags,
              physical_names=names)
    ref_write_msh(str(ref_path), RefMesh(coords, base.conn, cell_type),
                  version=version, cell_tags=tags, physical_names=names)
    assert path.read_text() == ref_path.read_text()
    r = read_msh(str(path))
    assert r.cell_type == cell_type
    assert r.n_nodes == mesh.n_nodes and r.n_cells == mesh.n_cells
    np.testing.assert_allclose(r.coords, coords, rtol=0, atol=1e-14)
    np.testing.assert_array_equal(r.conn, mesh.conn)
    np.testing.assert_array_equal(r.cell_tags[7],
                                  np.arange(mesh.n_cells // 2, mesh.n_cells))
    assert r.physical_names == names


def _poisson_port(n, bc_value):
    mesh = createUnitSquareMesh(n, n, "quad")
    V = FunctionSpace(mesh, "P", 1)
    tab = V.tabulate(quad_degree=4)
    phi = torch.as_tensor(np.asarray(tab.phi), dtype=torch.float64)

    def energy(u_cell, x_cell, p):
        dphi_x, wdet = map_gradients(x_cell, tab)
        gu = torch.einsum("qag,a->qg", dphi_x, u_cell)
        return torch.sum(wdet * (0.5 * torch.sum(gu * gu, dim=1)
                                 - (phi @ p["f"]) * (phi @ u_cell)))

    return mesh, V, FemForm(V, energy, kind="energy", param_specs={"f": V})


def _poisson_ref(n):
    mesh = ref_unit(n, n, "quad")
    V = RefSpace(mesh, "P", 1)
    tab = V.tabulate(quad_degree=4)
    phi = jnp.asarray(tab.phi)

    def energy(u_cell, x_cell, p):
        dphi_x, wdet = ref_map(x_cell, tab)
        gu = jnp.einsum("qag,a->qg", dphi_x, u_cell)
        return jnp.sum(wdet * (0.5 * jnp.sum(gu * gu, axis=1)
                               - (phi @ p["f"]) * (phi @ u_cell)))

    return V, RefForm(V, energy, kind="energy", param_specs={"f": V})


def _boundary(x):
    return ((np.abs(x[:, 0]) < 1e-12) | (np.abs(x[:, 0] - 1) < 1e-12)
            | (np.abs(x[:, 1]) < 1e-12) | (np.abs(x[:, 1] - 1) < 1e-12))


@pytest.mark.parametrize("bc_value", [0.0, 0.7])
def test_linear_solver_lift_matches_reference(bc_value, ref_env):
    """tests/test_poisson.py's manufactured Poisson solve (P1 quads 8x8,
    f = 2 pi^2 sin(pi x) sin(pi y), Dirichlet on the boundary; CG at
    1e-12) with the BC values 0 (the reference's case) and 0.7: the lifted
    right-hand side and the solution equal the JAX package's to 1e-12 and
    the solve satisfies the constrained system."""
    mesh, V, form = _poisson_port(8, bc_value)
    Vr, form_r = _poisson_ref(8)
    x = V.dof_coords
    f = 2 * np.pi ** 2 * np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1])
    bdofs = locate_dofs_geometric(V, _boundary)
    free, bcv = combine_bcs(V.n_dofs, [DirichletBC(bdofs, bc_value)])
    u0 = torch.zeros(V.n_dofs, dtype=torch.float64)
    p = {"f": torch.as_tensor(f)}
    r = assemble_residual(form, u0, p)
    Ae = element_matrices(form, u0, p).permute(1, 2, 0).contiguous()
    solver = LinearSolver([(Ae, V)], V.n_dofs, free_mask=free, method="cg",
                          tol=1e-12)
    b = solver.lift(-r, bcv)
    u = solver.solve(b)
    assert float(torch.linalg.norm(solver.matvec(u) - b)) < 1e-9 * max(
        1.0, float(torch.linalg.norm(b)))
    assert float((u[bdofs] - bc_value).abs().max()) <= 1e-12

    rb = ref_locate(Vr, _boundary)
    free_r, bcv_r = ref_combine(Vr.n_dofs, [RefBC(rb, bc_value)])
    pr = {"f": jnp.asarray(f)}
    r_r = ref_residual(form_r, jnp.zeros(Vr.n_dofs), pr)
    sol_r = RefSolver([(ref_elmats(form_r, jnp.zeros(Vr.n_dofs), pr),
                        Vr.dofmap_d)], Vr.n_dofs, free_mask=free_r,
                      method="cg", tol=1e-12)
    b_r = sol_r.lift(-r_r, bcv_r)
    assert _rel(b, b_r) <= 1e-12
    assert _rel(u, sol_r.solve(b_r)) <= 1e-12


@pytest.mark.parametrize("spd", [True, False])
def test_dense_solver_matches_reference(spd):
    """DenseSolver.solve / solve_transpose (a Cholesky when spd, else an
    LU) on a seeded 40x40 matrix, one and three right-hand sides, against
    the JAX package's at 1e-12; solve_spd_small on a seeded batch of 4x4
    SPD systems likewise."""
    rng = np.random.default_rng(9)
    n = 40
    Q = rng.standard_normal((n, n))
    A = Q @ Q.T + n * np.eye(n) if spd else Q + n * np.eye(n)
    port, ref = DenseSolver(torch.as_tensor(A), spd=spd), \
        RefDense(jnp.asarray(A), spd=spd)
    for b in (rng.standard_normal(n), rng.standard_normal((n, 3))):
        bt, bj = torch.as_tensor(b), jnp.asarray(b)
        assert _rel(port.solve(bt), ref.solve(bj)) <= 1e-12
        assert _rel(port.solve_transpose(bt), ref.solve_transpose(bj)) \
            <= 1e-12
        want = np.linalg.solve(A.T, b)
        assert _rel(port.solve_transpose(bt), want) <= 1e-12
    M = rng.standard_normal((6, 4, 4))
    M = M @ np.swapaxes(M, 1, 2) + 4.0 * np.eye(4)
    b = rng.standard_normal((6, 4))
    got = solve_spd_small(torch.as_tensor(M), torch.as_tensor(b))
    assert _rel(got, ref_spd_small(jnp.asarray(M), jnp.asarray(b))) <= 1e-12
    assert _rel(got, np.linalg.solve(M, b[..., None])[..., 0]) <= 1e-12


def test_shell_mg_precond_factory_matches_reference(api_digits):
    """tests/test_multigrid.py's model-level case: the 32x8 strong-BC plate
    (element-wise, h = 0.2, E = 4.32e8, nu = 0, f_z = 2) with its solve
    options replaced by CG at 1e-11 preconditioned by
    shell_mg_precond_factory(build_shell_mg(..., coarsest_cells=64)): the
    state within the reference test's 1e-9 (max abs; the tip deflection is
    ~1e-2) of the dense solve and of the JAX package's, and the CG
    iterations equal to the JAX run's (tools/api_reference_digits.py);
    with the f32 hierarchy (dtype=float32) the same state. The
    state's ImplicitPDE is rebuilt after the options change
    (FEA._build_pde): the assignment alone, as the reference test makes
    it, leaves the dense solve built at construction in place, in both
    packages."""
    m = StructuredQuadMesh(32, 8, (0, 0), (10.0, 2.0), gdim=3)
    nel, nn = m.n_cells, m.n_nodes
    p = np.zeros((nn, 3))
    p[:, 2] = 2.0
    args = (p, np.full(nel, 0.2), np.full(nel, 4.32e8), np.zeros(nel),
            np.ones(nel))
    kw = dict(shell_bc_func=_bc, element_wise_material=True,
              PENALTY_BC=False, device="cpu")
    u_dense = RMShellModel(m, **kw).evaluate(*args).disp_solid
    model = RMShellModel(m, **kw)
    mg = build_shell_mg(model.shell_pde, _bc, coarsest_cells=64,
                        device="cpu")
    model.fea.states["disp_solid"].solver_opts = {
        "method": "cg", "tol": 1e-11,
        "precond_factory": shell_mg_precond_factory(mg)}
    model.fea._build_pde("disp_solid")
    u = model.evaluate(*args).disp_solid
    pde = model.fea.states["disp_solid"].pde
    assert pde.solver_opts["method"] == "cg"
    assert float((u - u_dense).abs().max()) < 1e-9
    assert float(np.abs(u.numpy() - api_digits["mg_factory_u"]).max()) \
        < 1e-9
    assert [pde.last_info["forward"]["iters"]] == \
        api_digits["mg_factory_iters"].tolist()
    # the f32 hierarchy, which this factory refused before the f32
    # configuration was ported: the same solve preconditioned by its f32
    # V-cycle lands on the dense solve's state at the same bar
    mg32 = build_shell_mg(model.shell_pde, _bc, coarsest_cells=64,
                          dtype=torch.float32, device="cpu")
    model.fea.states["disp_solid"].solver_opts = {
        "method": "cg", "tol": 1e-11,
        "precond_factory": shell_mg_precond_factory(mg32,
                                                    dtype=torch.float32)}
    model.fea._build_pde("disp_solid")
    u32 = model.evaluate(*args).disp_solid
    assert float((u32 - u_dense).abs().max()) < 1e-9


def test_force_reshaping_model_matches_reference():
    """ForceReshapingModel on a mesh whose caller node order differs from
    the FE order (a seeded permutation as input_global_indices, as a gmsh
    reader sets it): seeded nodal forces in the caller's order become the
    same interleaved FE-order vector as in the JAX package."""
    mesh = createRectangleMesh(6, 2, (0, 0), (10.0, 2.0), "quad", gdim=3)
    mesh_r = ref_rect(6, 2, (0, 0), (10.0, 2.0), "quad", gdim=3)
    rng = np.random.default_rng(5)
    mesh.input_global_indices = mesh_r.input_global_indices = \
        rng.permutation(mesh.n_nodes)
    F = rng.standard_normal((mesh.n_nodes, 3))
    got = ForceReshapingModel(RMShellPDE(mesh, device="cpu")).evaluate(
        torch.as_tensor(F))
    want = np.asarray(RefReshape(RefPDE(mesh_r)).evaluate(jnp.asarray(F)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), F[mesh.input_global_indices].reshape(-1))
    assert not np.array_equal(want, F.reshape(-1))
    # A numpy force matrix, as the reference's callers pass, lands on the
    # PDE's device (here the PDE's device set to meta) in f64.
    pde = RMShellPDE(mesh, device="cpu")
    got = ForceReshapingModel(pde).evaluate(F)
    np.testing.assert_array_equal(got.numpy(), want)
    pde.device = torch.device("meta")
    got = ForceReshapingModel(pde).evaluate(F.astype(np.float32))
    assert got.device.type == "meta" and got.dtype == torch.float64
    assert got.shape == (3 * mesh.n_nodes,)


def test_mixed_space_function(monkeypatch):
    """MixedSpace.function: zeros or the given array (n_dofs values) on
    the named device, as the JAX package's; without a card and without
    `device` it raises, as FunctionSpace.function does."""
    mesh = createRectangleMesh(4, 2, (0, 0), (2.0, 1.0), "quad", gdim=3)
    W = MixedSpace(FunctionSpace(mesh, "P", 2, value_size=3),
                   FunctionSpace(mesh, "P", 1, value_size=3))
    mr = ref_rect(4, 2, (0, 0), (2.0, 1.0), "quad", gdim=3)
    Wr = RefMixed(RefSpace(mr, "P", 2, value_size=3),
                  RefSpace(mr, "P", 1, value_size=3))
    a = np.random.default_rng(2).standard_normal(W.n_dofs)
    fn = W.function(a, name="w", device="cpu")
    fr = Wr.function(a, name="w")
    assert fn.name == fr.name == "w" and fn.space is W
    np.testing.assert_array_equal(fn.x.numpy(), np.asarray(fr.x))
    z = W.function(device="cpu")
    assert z.x.shape == (W.n_dofs,) and not bool(z.x.any())
    assert z.x.dtype == torch.float64
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        W.function(a)


def test_additional_outputs_is_accepted_and_ignored(api_digits):
    """RMShellModel(additional_outputs=[...]) constructs and evaluates as
    without it (the same bits), and as the JAX package's model with the
    same argument (state and compliance at 1e-9,
    tools/api_reference_digits.py), on the 8x2 plate (penalty BCs, the
    dense path)."""
    mesh = createRectangleMesh(8, 2, (0, 0), (10.0, 2.0), "quad", gdim=3)
    nel, nn = mesh.n_cells, mesh.n_nodes
    f = np.zeros((nn, 3))
    f[:, 2] = 2.0
    args = (f, np.full(nel, 0.2), np.full(nel, 4.32e8), np.full(nel, 0.3),
            np.full(nel, 100.0))
    kw = dict(shell_bc_func=_bc, element_wise_material=True)
    outs = [RMShellModel(mesh, device="cpu", **extra, **kw).evaluate(*args)
            for extra in ({}, {"additional_outputs": ["stress", "mass"]})]
    assert torch.equal(outs[0].disp_solid, outs[1].disp_solid)
    assert torch.equal(outs[0].compliance, outs[1].compliance)
    assert _rel(outs[1].disp_solid, api_digits["additional_outputs_u"]) \
        <= 1e-9
    assert abs(float(outs[1].compliance)
               / float(api_digits["additional_outputs_compliance"])
               - 1.0) <= 1e-9
