"""The rank jobs of tests/test_torch_parallel.py (parallel.ranks.RankPool
imports this module in every rank): each builds one model of the port on
the CPU, splits it over the job's DeviceMesh with shard_model (or leaves it
whole, `split=False`), runs it on the seeded inputs that
tools/parallel_reference_digits.py gives the JAX package, and returns
numpy results. No JAX here."""

import numpy as np
import torch


def inputs_model(nel, nn, load, seed=11):
    rng = np.random.default_rng(seed)
    f = np.zeros(3 * nn)
    f[2::3] = load * (1.0 + 0.1 * rng.standard_normal(nn))
    th = 0.2 * (1.0 + 0.1 * rng.uniform(size=nel))
    return (f, th, np.full(nel, 4.32e8), np.zeros(nel), np.full(nel, 100.0))


def inputs_modal(nel, seed=3):
    """tests/test_modal.py::_setup's material, density as a field."""
    rng = np.random.default_rng(seed)
    th = 0.02 + 0.01 * rng.random(nel)
    E = 7.0e10 * (1.0 + 0.1 * rng.random(nel))
    return th, E, np.full(nel, 0.3), np.full(nel, 2700.0)


def inputs_sim(num_var, time_levels, nf, seed=12):
    rng = np.random.default_rng(seed)
    f_hist = np.zeros((time_levels, nf))
    f_hist[:, 2::3] = 2.0 * (1.0 + 0.1 * rng.standard_normal(
        (time_levels, nf // 3)))
    th = 0.1 * (1.0 + 0.1 * rng.uniform(size=num_var))
    return th, f_hist


def inputs_demo_thickness(th0, seed=13):
    rng = np.random.default_rng(seed)
    return th0 * (1.0 + 0.1 * rng.uniform(size=th0.shape[0]))


WING = dict(n_chord=8, n_span=36, rib_stations=(18,))


def _route(pde):
    from femo_alpha_tpu_torch.models.rm_shell.mg import ShellMGPrecond
    from femo_alpha_tpu_torch.solvers.amg import AMGPrecondFactory
    from femo_alpha_tpu_torch.solvers.band import BandPrecond

    if pde.solver_opts.get("method") == "dense":
        return "dense"
    return {ShellMGPrecond: "mg", BandPrecond: "band",
            AMGPrecondFactory: "amg"}.get(type(pde._pc), "cg")


def _held_cells(pde):
    """(cells this rank holds, cell count) of the fine Ae, the affine basis
    and each MG level's basis, from the model as it stands after a
    solve."""
    out = {}
    nc = pde.form.space.dofmap.shape[0]
    fn = pde.element_matrices_fn
    if fn is not None and fn._aff is not None:
        B = fn._aff.basis
        out["basis"] = (B.shape[-1], nc)
    mg = getattr(pde._pc, "mg", None)
    if mg is not None:
        for k, lev in enumerate(mg.levels[1:], 1):
            aff = lev["asm"]._aff
            n_k = lev["space"].dofmap.shape[0]
            if aff is not None:
                out[f"level{k}"] = (aff.basis.shape[-1], n_k)
    return out


def model_case(mesh, kind, split=True, threads=None):
    """RMShellModel: kind 'plate64' (64x16 MG), 'plate16' (16x4 dense) or
    'wing' (the 8x36 wing, penalty BCs, band). threads: torch's thread
    count for this case (the rank's own otherwise)."""
    if threads is not None:
        before = torch.get_num_threads()
        torch.set_num_threads(threads)
        try:
            return model_case(mesh, kind, split)
        finally:
            torch.set_num_threads(before)
    from femo_alpha_tpu_torch.mesh import createRectangleMesh, \
        createWingShellMesh
    from femo_alpha_tpu_torch.models import RMShellModel

    if kind == "wing":
        fe = createWingShellMesh(**WING)
        model = RMShellModel(fe, shell_bc_func=lambda x: x[:, 1] < 1e-9,
                             element_wise_material=True, device="cpu")
        load = 200.0
    else:
        nx, ny = {"plate64": (64, 16), "plate16": (16, 4)}[kind]
        fe = createRectangleMesh(nx, ny, (0, 0), (10.0, 2.0), "quad", gdim=3)
        model = RMShellModel(fe, shell_bc_func=lambda x: x[:, 0] < 1e-12,
                             element_wise_material=True, PENALTY_BC=False,
                             device="cpu")
        load = 2.0
    if split:
        from femo_alpha_tpu_torch.parallel import shard_model

        shard_model(model, mesh)
    pde = model.fea.states["disp_solid"].pde
    f, th, E, nu, rho = inputs_model(model.nel, model.nn, load)
    tt = torch.tensor(th, requires_grad=True)
    out = model.evaluate(f, tt, E, nu, rho)
    J = out.compliance
    u = out.disp_solid.detach().numpy().copy()
    J.backward()
    res = {"J": float(J), "u": u, "g": tt.grad.numpy().copy(),
           "route": _route(pde), "held": _held_cells(pde) if split else {},
           "iters": pde.last_info["forward"].get("iters")
           if pde.last_info.get("forward") else None}
    spec = getattr(pde, "shard_spec", None)
    if spec is not None:
        res["cells"] = spec.cell_range(model.nel)
        res["all_reduce"] = spec.n_all_reduce
        # the fine operator as the solve assembles it: this rank's cells
        p = {k: v.detach() for k, v in model.fe_inputs(
            f, th, E, nu).items()}
        ops = pde._assemble_ops(torch.zeros(pde.n_dofs, dtype=torch.float64),
                                p, *pde._prepare_aux(p)[::2])
        res["held"]["Ae"] = (ops[0].shape[-1], model.nel)
    return res


def sim_case(mesh, split=True):
    """PlateSim 16x4, element-wise thickness, step MG (coarsest 16), 2
    steps: the summed strain energy and its thickness gradient."""
    from femo_alpha_tpu_torch.mesh import createRectangleMesh
    from femo_alpha_tpu_torch.models.dynamic_rm_shell import PlateSim

    fe = createRectangleMesh(16, 4, (0, 0), (10.0, 2.0), "quad", gdim=3)
    sim = PlateSim(fe, E=4.32e8, nu=0.0, rho=100.0, dt=0.01, Nsteps=2,
                   element_wise_thickness=True, solver_method="mg",
                   mg_coarsest_cells=16, device="cpu")
    if split:
        from femo_alpha_tpu_torch.parallel import shard_model

        shard_model(sim, mesh)
    th, f_hist = inputs_sim(sim.num_var, sim.time_levels, sim.W_f.n_dofs)
    tt = torch.tensor(th, requires_grad=True)
    wh = sim.simulate(tt, torch.as_tensor(f_hist))
    J = torch.sum(sim.strain_energy_history(wh, tt))
    J.backward()
    res = {"J": float(J), "g": tt.grad.numpy().copy(),
           "w": wh.detach().numpy().copy(), "route": sim.solver_method,
           "solve_log": list(sim.solve_log)}
    if split:
        nc = sim.nel
        res["held"] = {"K": (sim._K_asm._aff.basis.shape[-1], nc),
                       "A": (sim._BA.shape[-1], nc)}
        for k, lev in enumerate(sim.mg.levels[1:], 1):
            res["held"][f"level{k}"] = (lev["asm"]._aff.basis.shape[-1],
                                        lev["space"].dofmap.shape[0])
    return res


def demo_case(mesh, what):
    """The demo classes: 'residual' (ShardedAssembler on 8x4),
    'shell' (ShardedShellStep 8x2, no preconditioner), 'shell_mg'
    (16x4, MG with coarsest 4: three levels), 'plate' (ShardedPlateStep
    4x2, 2 steps)."""
    from femo_alpha_tpu_torch.parallel import (
        ShardedAssembler,
        ShardedPlateStep,
        ShardedShellStep,
    )

    if what == "residual":
        step = ShardedShellStep(nx=8, ny=4, jmesh=mesh, device="cpu")
        nel = step.mesh.n_cells
        th = inputs_demo_thickness(np.full(nel, 0.2))
        params = {"thickness": torch.as_tensor(th),
                  "E": torch.full((nel,), 4.32e8, dtype=torch.float64),
                  "nu": torch.zeros(nel, dtype=torch.float64),
                  "uhat": torch.zeros(step.pde.VU.n_dofs,
                                      dtype=torch.float64),
                  "F_solid": step.example_force}
        rng = np.random.default_rng(0)
        u = 1e-3 * rng.standard_normal(step.pde.W.n_dofs)
        asm = ShardedAssembler(step.form, mesh)
        r = asm.residual(torch.as_tensor(u), params)
        return {"r": r.numpy().copy(), "cells": asm.cells.cells}
    if what == "plate":
        s = ShardedPlateStep(nx=4, ny=2, dt=0.01, nsteps=2, jmesh=mesh,
                             device="cpu")
        th = inputs_demo_thickness(s.example_thickness.numpy())
        v, g = s.train_step(torch.as_tensor(th), s.example_f_history)
        return {"J": float(v), "g": g.numpy().copy()}
    kw = (dict(nx=8, ny=2) if what == "shell" else
          dict(nx=16, ny=4, precond="mg", coarsest_cells=4))
    s = ShardedShellStep(jmesh=mesh, device="cpu", **kw)
    th = inputs_demo_thickness(s.example_thickness.numpy())
    v, g = s.train_step(torch.as_tensor(th), s.example_force)
    return {"J": float(v), "g": g.numpy().copy(),
            "levels": 0 if s.mg is None else len(s.mg.levels),
            "iters": s.implicit.last_info["forward"]["iters"]}



def operator_case(mesh):
    """The split fused operator of a 16x4 strong-BC plate against the
    whole one on a seeded vector: (x, y_split, y_whole, free, this rank's
    cell range)."""
    from femo_alpha_tpu_torch.assembly.affine import CachedAffineAssembler
    from femo_alpha_tpu_torch.assembly.assemble import \
        make_constrained_matvec_T
    from femo_alpha_tpu_torch.assembly.bc import DirichletBC, combine_bcs
    from femo_alpha_tpu_torch.mesh import createRectangleMesh
    from femo_alpha_tpu_torch.models.rm_shell.mg import strong_bc_dofs
    from femo_alpha_tpu_torch.models.rm_shell.pde import RMShellPDE
    from femo_alpha_tpu_torch.parallel import CellShardSpec

    fe = createRectangleMesh(16, 4, (0, 0), (10.0, 2.0), "quad", gdim=3)
    pde = RMShellPDE(fe, element_wise_material=True, device="cpu")
    W = pde.W
    free, _ = combine_bcs(W.n_dofs, [DirichletBC(strong_bc_dofs(
        pde, lambda x: x[:, 0] < 1e-12))], device="cpu")
    f, th, E, nu, _ = inputs_model(fe.n_cells, fe.n_nodes, 2.0)
    params = {"thickness": torch.as_tensor(th), "E": torch.as_tensor(E),
              "nu": torch.as_tensor(nu), "F_solid": torch.as_tensor(f),
              "uhat": torch.zeros(3 * fe.n_nodes, dtype=torch.float64)}
    whole = CachedAffineAssembler(pde.make_residual_form())
    split = CachedAffineAssembler(pde.make_residual_form())
    spec = CellShardSpec(mesh)
    view = spec.cells_of(W)
    split.shard(view)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(W.n_dofs))
    y_whole = make_constrained_matvec_T(whole(None, params), W, free)(x)
    y_split = make_constrained_matvec_T(split(None, params), view, free)(x)
    return {"x": x.numpy(), "free": free.numpy(),
            "y_whole": y_whole.numpy(), "y_split": y_split.numpy(),
            "cells": view.cells, "all_reduce": spec.n_all_reduce}


def _bc(x):
    return x[:, 0] < 1e-12


def _plate_model(nx, ny, size=(10.0, 2.0), **kw):
    from femo_alpha_tpu_torch.mesh import createRectangleMesh
    from femo_alpha_tpu_torch.models import RMShellModel

    fe = createRectangleMesh(nx, ny, (0, 0), size, "quad", gdim=3)
    return RMShellModel(fe, shell_bc_func=_bc, element_wise_material=True,
                        PENALTY_BC=False, device="cpu", **kw)


def _split(model, mesh, split):
    """shard_model(model, mesh) when split; the state's ImplicitPDE and
    its CellShardSpec (None unsplit)."""
    if split:
        from femo_alpha_tpu_torch.parallel import shard_model

        shard_model(model, mesh)
    pde = model.fea.states["disp_solid"].pde
    return pde, pde.shard_spec


def modal_case(mesh, kind, split=True):
    """RMShellModel.evaluate_modal on a split model: kind 'modal8' (the 8x4
    plate 2 x 1 of tests/test_modal.py, seed 3: the dense route's 5
    modes, modal_eigenvalues' first-mode gradient in the four inputs and
    its memo, LOBPCG's 4 modes at tol 1e-10 on the dense solve's Cholesky)
    or 'modal64' (the 64x16 MG plate, LOBPCG on the V-cycle, 3 modes)."""
    if kind == "modal8":
        model = _plate_model(8, 4, size=(2.0, 1.0))
        args = inputs_modal(model.nel)
    else:
        model = _plate_model(64, 16)
        args = inputs_model(model.nel, model.nn, 2.0)[1:]
    pde, spec = _split(model, mesh, split)
    res = {}
    if kind == "modal8":
        dense = model.evaluate_modal(*args, n_modes=5, solver="dense")
        res["dense"] = dense.eigenvalues.detach().numpy().copy()
        res["modes_extracted"] = dense.modes_extracted.numpy().copy()
        leaves = [torch.tensor(a, requires_grad=True) for a in args]
        lam = model.modal_eigenvalues(*leaves, n_modes=1)[0]
        lam.backward()
        res["grads"] = [t.grad.numpy().copy() for t in leaves]
        n_cached = len(model._modal_modes_cache)
        again = model.modal_eigenvalues(*args, n_modes=1)
        res["memo"] = (len(model._modal_modes_cache) == n_cached
                       and float(again[0]) == float(lam.detach()))
        kw = dict(n_modes=4, solver="lobpcg", tol=1e-10, maxiter=100,
                  seed=0)
    else:
        kw = dict(n_modes=3, solver="lobpcg", tol=1e-8, maxiter=200, seed=0)
    lob = model.evaluate_modal(*args, **kw)
    res.update(lobpcg=lob.eigenvalues.detach().numpy().copy(),
               iterations=lob.iterations,
               res_norms=lob.res_norms.numpy().copy(),
               route=_route(pde))
    if spec is not None:
        res["all_reduce"] = spec.n_all_reduce
        res["held"] = {"M": (model._modal_m[2]._aff.basis.shape[-1],
                             model.nel),
                       **_held_cells(pde)}
    return res


def factory_case(mesh, split=True):
    """The plain precond_factory shell_mg_precond_factory on the 32x8
    StructuredQuadMesh of tests/test_torch_api.py (CG at 1e-11, coarsest
    64 cells, the state's ImplicitPDE rebuilt by FEA._build_pde), split
    after the rebuild: the state, the CG iterations, the factory's calls
    (its hierarchy set up once per linearization) and, split, each
    level's cells in the state it built."""
    from femo_alpha_tpu_torch.mesh import StructuredQuadMesh
    from femo_alpha_tpu_torch.models import RMShellModel
    from femo_alpha_tpu_torch.models.rm_shell.mg import (
        build_shell_mg,
        shell_mg_precond_factory,
    )

    m = StructuredQuadMesh(32, 8, (0, 0), (10.0, 2.0), gdim=3)
    model = RMShellModel(m, shell_bc_func=_bc, element_wise_material=True,
                         PENALTY_BC=False, device="cpu")
    mg = build_shell_mg(model.shell_pde, _bc, coarsest_cells=64,
                        device="cpu")
    model.fea.states["disp_solid"].solver_opts = {
        "method": "cg", "tol": 1e-11,
        "precond_factory": shell_mg_precond_factory(mg)}
    model.fea._build_pde("disp_solid")
    calls, level_cells = [], []
    setup = mg.setup

    def counted(*a, **k):
        state = setup(*a, **k)
        calls.append(1)
        level_cells.append([Ae.shape[-1] for Ae in state["Ae"]])
        return state

    mg.setup = counted
    pde, spec = _split(model, mesh, split)
    nel, nn = m.n_cells, m.n_nodes
    f = np.zeros((nn, 3))
    f[:, 2] = 2.0
    th = torch.full((nel,), 0.2, dtype=torch.float64, requires_grad=True)
    out = model.evaluate(f, th, np.full(nel, 4.32e8), np.zeros(nel),
                         np.ones(nel))
    u = out.disp_solid.detach().numpy().copy()
    out.compliance.backward()
    return {"u": u, "g": th.grad.numpy().copy(),
            "iters": [pde.last_info["forward"]["iters"],
                      pde.last_info["adjoint"]["iters"]],
            "calls": len(calls), "level_cells": level_cells,
            "level_nc": [lev["space"].dofmap.shape[0] for lev in mg.levels],
            "plain": pde._pc is None and pde._pf is not None,
            "all_reduce": None if spec is None else spec.n_all_reduce}


class WholeJacobi:
    """A user's split-protocol preconditioner without shard_state: point
    Jacobi from the assembled diagonal of the whole fine block (which it
    records the cell count of)."""

    def __init__(self, space, free):
        self.space, self.free, self.seen = space, free, []

    def prepare(self, params, grad_keys=frozenset()):
        return ()

    def setup_state(self, u, params, ops_Ae, aux):
        Ae = ops_Ae[0]
        self.seen.append(Ae.shape[-1])
        d = self.space.scatter_add(torch.diagonal(Ae, dim1=0, dim2=1))
        d = torch.where(d != 0.0, d, torch.ones_like(d))
        return self.free / d + (1.0 - self.free)

    def apply_state(self, state, v):
        return state * v


def pieces_case(mesh, kind, split=True):
    """User-built pieces under shard_model on the 16x4 plate (CG at 1e-12):
    kind 'emf' (an element_matrices_fn without .shard, a whole jacfwd
    assembly; point Jacobi), 'mg_level' (ShellMGPrecond over build_shell_mg
    with coarsest 4 cells, its level 1 rebuilt as a bare make_Ae of a whole
    direct assembly) or 'pc' (WholeJacobi, no shard_state): compliance,
    state, d compliance / d thickness, CG iterations and the cell counts
    each piece saw."""
    from femo_alpha_tpu_torch.assembly.affine import CachedAffineAssembler
    from femo_alpha_tpu_torch.assembly.assemble import element_matrices
    from femo_alpha_tpu_torch.mesh import createRectangleMesh
    from femo_alpha_tpu_torch.models.rm_shell.mg import (
        ShellMGPrecond,
        build_shell_mg,
    )
    from femo_alpha_tpu_torch.models.rm_shell.pde import RMShellPDE

    opts = {"method": "cg", "tol": 1e-12, "maxiter": 4000}
    seen = []
    if kind == "mg_level":
        fe = createRectangleMesh(16, 4, (0, 0), (10.0, 2.0), "quad", gdim=3)
        mg = build_shell_mg(RMShellPDE(fe, element_wise_material=True,
                                       device="cpu"), _bc, coarsest_cells=4,
                            device="cpu")
        lev = mg.levels[1]
        whole = CachedAffineAssembler(lev.pop("asm").form, verify=False)
        lev.pop("affine_asm")

        def make_Ae(p):
            Ae = whole.direct(None, {k: v for k, v in p.items()
                                     if k != "_affine_basis"})
            seen.append(Ae.shape[-1])
            return Ae

        lev["make_Ae"] = make_Ae
        opts["precond_factory"] = ShellMGPrecond(mg)
    model = _plate_model(16, 4, solver_opts=opts)
    pde = model.fea.states["disp_solid"].pde
    if kind == "emf":
        def whole_elmats(u, params, basis=None):
            Ae = element_matrices(pde.form, u, params)
            seen.append(Ae.shape[0])
            return Ae.permute(1, 2, 0).contiguous()

        pde.element_matrices_fn = whole_elmats
    elif kind == "pc":
        pde._pc = WholeJacobi(pde.form.space, pde.free_mask)
    pde, spec = _split(model, mesh, split)
    f, th, E, nu, rho = inputs_model(model.nel, model.nn, 2.0)
    tt = torch.tensor(th, requires_grad=True)
    out = model.evaluate(f, tt, E, nu, rho)
    out.compliance.backward()
    if kind == "pc":
        seen = pde._pc.seen
    ops = pde._assemble_ops(torch.zeros(pde.n_dofs, dtype=torch.float64),
                            {k: v.detach() for k, v in model.fe_inputs(
                                f, th, E, nu).items()})
    return {"J": float(out.compliance), "u": out.disp_solid.detach().numpy(),
            "g": tt.grad.numpy().copy(), "seen": seen,
            "held_Ae": ops[0].shape[-1], "nel": model.nel,
            "iters": [pde.last_info["forward"]["iters"],
                      pde.last_info["adjoint"]["iters"]],
            "all_reduce": None if spec is None else spec.n_all_reduce}
