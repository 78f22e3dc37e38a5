"""femo_alpha_tpu_torch imports torch and never jax; its kernel module
imports without nvcc or a GPU and dispatches on each tensor's device; the
configurations it has not ported raise NotImplementedError, and past the
band memory guard the model selects the aggregation AMG."""

import glob
import importlib
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import femo_alpha_tpu_torch
from femo_alpha_tpu_torch.assembly import cuda_kernels as ck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _all_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            femo_alpha_tpu_torch.__path__, "femo_alpha_tpu_torch."))


def test_every_module_imports_without_jax():
    mods = _all_modules()
    assert "femo_alpha_tpu_torch.assembly.cuda_kernels" in mods
    assert "femo_alpha_tpu_torch.models.rm_shell.model" in mods
    # the default aircraft configuration's, the transient shell's, the
    # optimization and modal path's, the benchmark's and the generic FEA
    # library's modules, among them
    for m in ("io.gmsh", "mesh.wing", "solvers.band", "assembly.facets",
              "models.dynamic_rm_shell", "models.dynamic_rm_shell.plate_sim",
              "models.dynamic_rm_shell.mg", "spaces.pointeval",
              "adjoint.check", "opt", "opt.problem", "csdl_opt",
              "csdl_opt.state_operation", "csdl_opt.output_operation",
              "utils", "utils.logging", "utils.timing", "io.checkpoint",
              "solvers.eigen", "solvers.direct",
              "models.rm_shell.buckling", "utils.quality", "benchmarks",
              "bench", "config", "io.xdmf", "io.recorder", "models.poisson",
              "models.elasticity", "models.beam", "solvers.newton",
              "solvers.precond", "solvers.amg", "assembly.sparse",
              "native.topology", "parallel", "parallel.product",
              "parallel.sharding", "parallel.ranks"):
        assert "femo_alpha_tpu_torch." + m in mods
    # the example studies: one module per script under examples/
    from femo_alpha_tpu_torch.examples import EXAMPLES

    scripts = sorted(os.path.basename(p)[:-3] for p in glob.glob(
        os.path.join(REPO, "examples", "**", "ex_*.py"), recursive=True))
    assert sorted(EXAMPLES) == scripts and len(scripts) == 14
    for m in EXAMPLES:
        assert "femo_alpha_tpu_torch.examples." + m in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' "
        "or k.startswith(('jax.', 'jaxlib', 'femo_alpha_tpu.')) "
        "or k == 'femo_alpha_tpu')\n"
        "assert not bad, bad\n"
        "from femo_alpha_tpu_torch.assembly import cuda_kernels as ck\n"
        "assert ck._LIB is None  # nothing is built at import\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_cpu_tensors_take_the_twins_and_count_no_launch():
    rng = np.random.default_rng(0)
    A = torch.as_tensor(rng.standard_normal((5, 5, 7)))
    x = torch.as_tensor(rng.standard_normal((5, 7)))
    B = torch.as_tensor(rng.standard_normal((2, 5, 5, 7)))
    th = torch.as_tensor(rng.uniform(0.1, 0.3, 7))
    ck.reset_launch_counts()
    y = ck.cell_matvec_T(A, x)
    Ae = ck.affine_combine(B, th, (1, 3))
    assert ck.launch_counts() == {"cell_matvec_T": 0, "affine_combine": 0,
                                  "constrained_matvec_T": 0}
    torch.testing.assert_close(y, ck.cell_matvec_T_plain(A, x), rtol=0,
                               atol=0)
    torch.testing.assert_close(Ae, ck.affine_combine_plain(B, th, (1, 3)),
                               rtol=0, atol=0)


@pytest.mark.parametrize("case", ["shape", "grad", "device"])
def test_kernel_wrappers_refuse_bad_input(case):
    A = torch.zeros((4, 4, 6), dtype=torch.float64)
    x = torch.zeros((4, 6), dtype=torch.float64)
    if case == "shape":
        with pytest.raises(ValueError):
            ck.cell_matvec_T(A, x[:3])
        with pytest.raises(ValueError):
            ck.affine_combine(A[None], torch.zeros(5, dtype=A.dtype), (1,))
    elif case == "grad":
        with pytest.raises(RuntimeError):
            ck.cell_matvec_T(A.requires_grad_(True), x)
    else:
        # a non-CPU, non-CUDA tensor neither runs the twin nor a kernel
        with pytest.raises(ValueError):
            ck.cell_matvec_T(A.to("meta"), x.to("meta"))


@pytest.mark.parametrize("what", ["penalty", "unstructured", "dense",
                                  "composite", "nodal_material"])
def test_unported_configurations_raise(what, monkeypatch):
    """Configurations that once raised and are ported now. A composite
    laminate (a real from_layup 1-ply laminate at 64x16, on the MG path
    with every level assembled directly) gives the isotropic cantilever's
    compliance anchor. Nodal material (the reference's default) evaluates
    on the MG path at 64x16:
    uniform fields give the cantilever's compliance anchor less the L2
    regularization that only element-wise thickness carries (the H1 term
    of a uniform field is zero). Past the band memory guard (penalty BCs, or strong
    BCs on an unstructured mesh) the model selects the reference's
    aggregation AMG (AMGPrecondFactory) and evaluates finite outputs; the
    plate for these two cases is the smallest above the dense path's 6000
    dofs (48x8, 6,270 dofs), since the AMG's CG takes ~500 iterations on
    the CPU twins. On the dense path a solver of the caller's
    choice (solver_opts) is ported: the options reach the LinearSolver as
    given (Jacobi-GMRES(50) here, which stagnates on this shell as the
    reference's does, and stops after its maxiter // 50 cycles)."""
    from femo_alpha_tpu_torch.mesh import createRectangleMesh
    from femo_alpha_tpu_torch.models import RMShellModel

    structured = what != "unstructured"
    nx, ny = {"dense": (8, 2), "penalty": (48, 8),
              "unstructured": (48, 8)}.get(what, (64, 16))
    mesh = createRectangleMesh(nx, ny, (0, 0), (10.0, 2.0), "quad", gdim=3,
                               structured=structured)
    kw = dict(shell_bc_func=lambda x: x[:, 0] < 1e-12,
              element_wise_material=what != "nodal_material",
              PENALTY_BC=what == "penalty", device="cpu")
    if what == "composite":
        from femo_alpha_tpu_torch.models import CompositeCLT

        kw["composite_clt"] = CompositeCLT.from_layup(
            mesh.n_cells, [4.32e8], [0.0], [-0.1, 0.1])
    if what == "dense":
        kw["solver_opts"] = {"method": "gmres", "pc": "jacobi"}
    if what in ("penalty", "unstructured"):
        monkeypatch.setenv("FEMO_BAND_MEM_GB", "0.001")
    if what == "nodal_material":
        model = RMShellModel(mesh, **kw)
        nn = mesh.n_nodes
        f = np.zeros((nn, 3))
        f[:, 2] = 2.0
        out = model.evaluate(f, np.full(nn, 0.2), np.full(nn, 4.32e8),
                             np.zeros(nn), np.full(nn, 100.0))
        pde = model.fea.states["disp_solid"].pde
        assert pde.element_matrices_fn is None and model.mg is not None
        # the anchor 4.387e-3 includes 0.5e-2 int h^2 dx = 4e-3 (10 x 2)
        l2_reg = 0.5e-2 * 0.2 ** 2 * 20.0
        assert abs((float(out.compliance) + l2_reg) / 4.387e-3 - 1.0) < 1e-3
        assert bool(torch.isfinite(out.disp_solid).all())
        return
    if what in ("dense", "penalty", "unstructured", "composite"):
        model = RMShellModel(mesh, **kw)
        pde = model.fea.states["disp_solid"].pde
        if what == "composite":
            assert pde.element_matrices_fn is None and model.mg is not None
            assert not any("affine_asm" in lev for lev in model.mg.levels)
        elif what == "dense":
            assert pde.solver_opts == {"method": "gmres", "pc": "jacobi",
                                       "tol": 1e-12}
        else:
            from femo_alpha_tpu_torch.solvers.amg import AMGPrecondFactory

            assert isinstance(pde._pc, AMGPrecondFactory)
            assert pde.n_dofs > 6000
        nel, nn = mesh.n_cells, mesh.n_nodes
        f = np.zeros((nn, 3))
        f[:, 2] = 2.0
        out = model.evaluate(f, np.full(nel, 0.2), np.full(nel, 4.32e8),
                             np.zeros(nel), np.full(nel, 100.0))
        assert bool(torch.isfinite(out.disp_solid).all())
        assert bool(torch.isfinite(out.compliance))
        info = pde.last_info["forward"]
        if what != "dense":
            # the cantilever's compliance anchor (chip_smoke.J_ANCHOR); the
            # 1-ply laminate is the isotropic plate
            assert abs(float(out.compliance) / 4.387e-3 - 1.0) < 1e-3
            assert 0 < info["iters"] < pde.solver_opts["maxiter"]
            return
        assert info["cycles"] == max(2, min(max(500, 10 * pde.n_dofs),
                                            200_000) // 50)
        return


# the JAX package's public names that the port replaces instead of porting
# them (ROADMAP.md, "Replace, do not port")
REPLACED_NAMES = {"solvers": {"cg_solve_hostloop"}, "assembly": set(),
                  "parallel": set()}


def _reference_all(package):
    """The `__all__` of femo_alpha_tpu.<package>, read from its source
    (no JAX import)."""
    import ast

    path = os.path.join(REPO, "femo_alpha_tpu", package, "__init__.py")
    tree = ast.parse(open(path).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return set(ast.literal_eval(node.value))
    raise AssertionError(f"no __all__ in {path}")


@pytest.mark.parametrize("package", ["assembly", "solvers", "parallel"])
def test_public_names_cover_the_reference(package):
    """The port's assembly, solvers and parallel export every public name
    of the JAX package's (make_matvec, scatter_add, BandCholPrecond,
    band_precond_factory, make_space_transfer, make_device_mesh and the
    three demo classes among them), less the ones it replaces."""
    mod = importlib.import_module("femo_alpha_tpu_torch." + package)
    missing = _reference_all(package) - REPLACED_NAMES[package] - set(
        mod.__all__)
    assert not missing, missing
    assert all(hasattr(mod, name) for name in mod.__all__)


def test_shard_model_rejects_an_unknown_target():
    """shard_model takes an RMShellModel, FEA, ImplicitPDE or PlateSim and
    raises TypeError on anything else, as the reference's does; the port's
    product module exports the reference's names."""
    from femo_alpha_tpu_torch.parallel import product

    for name in ("CellShardSpec", "shard_aux", "shard_ops",
                 "shard_mg_state", "shard_model", "make_device_mesh"):
        assert hasattr(product, name)
    with pytest.raises(TypeError, match="shard"):
        product.shard_model(object())
    mesh = product.make_device_mesh()
    assert (mesh.size, mesh.rank) == (1, 0)


def test_df_operator_storage_raises(monkeypatch):
    """FEMO_OP_STORAGE=df, the TPU's float-float operator storage, is not
    ported: the model raises NotImplementedError at construction; f32 and
    f64 are taken."""
    from femo_alpha_tpu_torch.mesh import createRectangleMesh
    from femo_alpha_tpu_torch.models import RMShellModel

    mesh = createRectangleMesh(8, 2, (0, 0), (10.0, 2.0), "quad", gdim=3)
    kw = dict(shell_bc_func=lambda x: x[:, 0] < 1e-12,
              element_wise_material=True, device="cpu")
    monkeypatch.setenv("FEMO_OP_STORAGE", "df")
    with pytest.raises(NotImplementedError, match="df"):
        RMShellModel(mesh, **kw)
    for sto, want in (("f32", "f32"), ("f64", None)):
        monkeypatch.setenv("FEMO_OP_STORAGE", sto)
        model = RMShellModel(mesh, **kw)
        assert model.fea.states["disp_solid"].pde.element_matrices_fn \
            .storage == want


def test_platesim_without_a_card_raises(monkeypatch):
    """PlateSim takes the card when `device` is not given and raises where
    there is none (the test takes the card away itself), with element-wise
    thickness and with its default, nodal thickness."""
    from femo_alpha_tpu_torch.mesh import createRectangleMesh
    from femo_alpha_tpu_torch.models.dynamic_rm_shell import PlateSim

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = createRectangleMesh(4, 2, (0, 0), (10.0, 2.0), "quad", gdim=3)
    kw = dict(E=4.32e8, nu=0.0, rho=10.0, dt=0.01, Nsteps=2)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        PlateSim(mesh, element_wise_thickness=True, **kw)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        PlateSim(mesh, **kw)


@pytest.mark.parametrize("name", sorted(__import__(
    "femo_alpha_tpu_torch.examples", fromlist=["EXAMPLES"]).EXAMPLES))
def test_example_without_a_card_raises(name, monkeypatch):
    """Each example study's main takes the card when --device is not
    given and raises where there is none (the test takes the card away
    itself), before it solves anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"femo_alpha_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mod.main([])
