"""The port's benchmark workloads, each with its solve-quality measures.

- `LibraryBench`: port of femo_alpha_tpu/benchmarks.py::LibraryBench, the
  product path — `RMShellModel.evaluate` + the compliance backward (plain
  autograd through the implicit adjoint) on the structured cantilever
  plate, one optimizer iteration per call.
- `WingBench`: the workload of tools/wing_bench.py — a penalty-BC wing
  shell through the band-Cholesky path, evaluate + compliance backward.
- `TransientBench`: the workload of tools/transient_bench.py — PlateSim's
  checkpointed forward and forward + adjoint on a 1-cos gust.

Each reports its solve quality through utils/quality.py and
`quality_verdict`, bench.py's gate. `python -m femo_alpha_tpu_torch.bench`
prints their JSON lines. Every workload runs on the CUDA card unless
`device` names another; host clocks end in a synchronize.
"""

from __future__ import annotations

import json
import statistics
import time

import numpy as np
import torch

from .assembly import cuda_kernels as ck
from .assembly.assemble import make_constrained_matvec_T
from .device import resolve_device
from .utils import quality

QUALITY_BAR = 1e-8
# The 512x128 plate against its committed golden (a host SuperLU solve of
# the JAX package's assembly): nodal relative L2 error and the relative
# error of max |u|. At 988,806 dofs rounding-sized differences between two
# assemblies of the same system move a direct solution by ~1.5e-7
# (tools/scale_nodal_probe.py: a direct solve of the port's assembly sits
# 1.5e-7 / 1.8e-7 from the golden, a 1e-15 relative perturbation of the
# element matrices moves the port's state to 2.2e-7), so 1e-7 is below
# what the golden resolves; the bar sits above those readings.
GOLDEN_BAR = 2.5e-7


def quality_verdict(rel_res, res_floor, nodal=None, bar=QUALITY_BAR):
    """bench.py's solve-quality gate: "OK" when rel_res is within the bar,
    or within 2x of the residual-measurement floor when that floor itself
    sits above the bar (rel_res saturates there for any backward-stable
    solve), or when the nodal error against an f64 direct solve is within
    the bar; else "FAIL"."""
    floor_ok = res_floor > bar and rel_res <= 2.0 * res_floor
    nodal_ok = nodal is not None and nodal <= bar
    return "OK" if rel_res <= bar or floor_ok or nodal_ok else "FAIL"


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def _iters(info, phase):
    st = (info or {}).get(phase)
    return int(st["iters"]) if st else -1


def _clamped_x0(x):
    return x[:, 0] < 1e-12


class LibraryBench:
    """The product path on the north-star workload: a structured nx x ny
    cantilever plate (10 x 2), f_z = 2, E = 4.32e8, nu = 0, rho = 100,
    thickness 0.2, compliance and its exact thickness gradient by
    `out.compliance.backward()`. penalty=False (the default) clamps by
    strong-BC elimination (the geometric-MG solve path); penalty=True by
    the reference-default penalty facets (band Cholesky). mg_cycle ("V" or
    "W") and mg_smoother ("block_jacobi" or "schwarz") configure the MG
    hierarchy (build_shell_mg), as femo_alpha_tpu's ShellBench takes
    them."""

    def __init__(self, nx=128, ny=32, penalty=False, device=None,
                 mg_cycle="V", mg_smoother="block_jacobi"):
        from .mesh import createRectangleMesh
        from .models import RMShellModel

        self.device = resolve_device(device)
        mesh = createRectangleMesh(nx, ny, (0, 0), (10.0, 2.0), "quad",
                                   gdim=3)
        self.model = RMShellModel(mesh, shell_bc_func=_clamped_x0,
                                  element_wise_material=True,
                                  PENALTY_BC=penalty, device=self.device,
                                  mg_opts={"cycle": mg_cycle,
                                           "smoother": mg_smoother})
        self.pde = self.model.fea.states["disp_solid"].pde
        self.n_dofs = self.model.shell_pde.W.n_dofs
        nel, nn = mesh.n_cells, mesh.n_nodes
        kw = dict(dtype=torch.float64, device=self.device)
        self.f = torch.zeros(3 * nn, **kw)
        self.f[2::3] = 2.0
        self.E = torch.full((nel,), 4.32e8, **kw)
        self.nu = torch.zeros(nel, **kw)
        self.rho = torch.full((nel,), 100.0, **kw)
        self.th0 = torch.full((nel,), 0.2, **kw)
        self.last_u = self.last_grad = None

    def params(self, th):
        """The displacement state's parameters at thickness th."""
        return self.model.fe_inputs(self.f, th, self.E, self.nu)

    def forward_adjoint(self, th):
        th = th.detach().clone().requires_grad_(True)
        out = self.model.evaluate(self.f, th, self.E, self.nu, self.rho)
        out.compliance.backward()
        return dict(J=out.compliance.detach(), grad=th.grad,
                    u=out.disp_solid.detach())

    def timed_run(self, repeats=3):
        """The first call (kernels built or loaded), then `repeats` new
        designs th0*(1 + 0.01(i+1)) timed one by one (each solve
        warm-started from the previous design's solution, as in an SLSQP
        loop); then, untimed, the nominal design again for the quality
        measures and the assembly timing. `launches` counts the kernel
        launches of the first and the timed calls. `assembly_s` is the
        per-design re-assembly (`_assemble_ops`: one K2 combine of the
        fine operator) streamed over 8 designs with one synchronize;
        `assembly_latency_s` is one call and its synchronize."""
        dev = self.device
        before = ck.launch_counts()
        _, compile_s = _timed(lambda: self.forward_adjoint(self.th0), dev)
        times = []
        for i in range(repeats):
            th = self.th0 * (1.0 + 0.01 * (i + 1))
            times.append(_timed(lambda: self.forward_adjoint(th), dev)[1])
        launches = {k: v - before[k] for k, v in ck.launch_counts().items()}

        out, _ = _timed(lambda: self.forward_adjoint(self.th0), dev)
        info = self.pde.last_info
        params = self.params(self.th0)
        rel, res_floor = quality.residual_and_floor(self.pde, params,
                                                    out["u"])
        self.last_u = out["u"].cpu().numpy()
        self.last_grad = out["grad"].cpu().numpy()

        with torch.no_grad():
            zero = torch.zeros_like(out["u"])
            emf_basis, _, facet_ops = self.pde._prepare_aux(params)

            def assemble(th):
                p = dict(params, thickness=th)
                return self.pde._assemble_ops(zero, p, emf_basis=emf_basis,
                                              facet_ops=facet_ops)

            _timed(lambda: assemble(self.th0), dev)
            _, latency_s = _timed(lambda: assemble(self.th0), dev)
            reps = 8
            ths = [self.th0 * (1.0 + 1e-4 * (j + 1)) for j in range(reps)]
            _sync(dev)
            t0 = time.perf_counter()
            for th in ths:
                assemble(th)
            _sync(dev)
            stream_s = (time.perf_counter() - t0) / reps
        return dict(
            wall_s=float(np.median(times)),
            warm_s=times,
            compile_s=compile_s,
            n_dofs=int(self.n_dofs),
            iters_fwd=_iters(info, "forward"),
            iters_adj=_iters(info, "adjoint"),
            solver_stats=json.dumps(info, default=str),
            res_fwd=rel, res_adj=rel, res_floor=res_floor,
            tip=float(out["u"].abs().max()),
            J=float(out["J"]),
            grad_norm=float(torch.linalg.norm(out["grad"])),
            assembly_s=stream_s,
            assembly_latency_s=latency_s,
            assembly_stream_s=stream_s,
            assembly_mdof_s=self.n_dofs / max(stream_s, 1e-12) / 1e6,
            assembly_stream_mdof_s=self.n_dofs / max(stream_s, 1e-12) / 1e6,
            launches=launches,
        )


def wing_inputs(mesh, device, amplitude, E, nu, rho):
    """An elliptic lift pressure amplitude*sqrt(1 - (y/span)^2) in z at
    every node, and uniform E, nu, rho per cell."""
    span = float(np.max(mesh.coords[:, 1]))
    eta = np.clip(np.asarray(mesh.coords[:, 1]) / span, 0.0, 1.0)
    pressure = np.zeros((mesh.n_nodes, 3))
    pressure[:, 2] = amplitude * np.sqrt(1.0 - eta ** 2)
    kw = dict(dtype=torch.float64, device=device)
    nel = mesh.n_cells
    return (torch.as_tensor(pressure, **kw), torch.full((nel,), E, **kw),
            torch.full((nel,), nu, **kw), torch.full((nel,), rho, **kw))


def planform_shape(coords, length=10.0, width=2.0, amplitude=0.1):
    """A smooth in-plane planform change of the cantilever plate, zero at
    the root and the tip: dy = amplitude s (1 - s) (2 y / W - 1), s = x / L
    (max |dy| = amplitude / 4; at 128x32 it changes no cell Jacobian by
    more than 2.5 %). numpy (n_nodes,)."""
    s = coords[:, 0] / length
    return amplitude * s * (1.0 - s) * (2.0 * coords[:, 1] / width - 1.0)


def nodal_thickness(coords, h0=0.2, length=10.0, width=2.0,
                    amplitude=0.3):
    """A smooth non-uniform nodal (CG1) thickness of the cantilever plate,
    h = h0 (1 + amplitude sin(pi s) cos(pi y / W)), s = x / L: h0 at the
    root and the tip, with a nonzero gradient (so the H1 regularization
    of nodal thickness is not zero). numpy (n_nodes,)."""
    s = coords[:, 0] / length
    return h0 * (1.0 + amplitude * np.sin(np.pi * s)
                 * np.cos(np.pi * coords[:, 1] / width))


def composite_laminate(mesh, h=0.2, E=4.32e8, nu=0.3, x_split=10.0 / 3.0):
    """The composite laminate of chip_smoke.py's `composite` phase, per cell
    in the mesh's FE cell order (CompositeCLT.from_layup, numpy f64): where
    the cell's centroid lies at x < x_split (10/3 on the 10 x 2 plate, on
    no level's cell edge, so the MG levels' 2x2 means mix the two) the
    unsymmetric 2-ply [E, E/10] on z = [-h/2, 0, h/2] (B != 0: membrane and
    bending couple), elsewhere the 3-ply sandwich [E, E/10, E] on
    z = [-h/2, -h/4, h/4, h/2]. mesh: any mesh with `coords` and `conn`."""
    from .models.rm_shell.material import CompositeCLT

    xc = np.asarray(mesh.coords)[np.asarray(mesh.conn)].mean(axis=1)[:, 0]
    nc = len(xc)
    two = CompositeCLT.from_layup(nc, [E, E / 10.0], [nu, nu],
                                  [-h / 2.0, 0.0, h / 2.0])
    three = CompositeCLT.from_layup(nc, [E, E / 10.0, E], [nu, nu, nu],
                                    [-h / 2.0, -h / 4.0, h / 4.0, h / 2.0])
    near = (xc < x_split)[:, None, None]
    return CompositeCLT(*(np.where(near, getattr(two, k), getattr(three, k))
                          for k in ("A", "B", "D", "As")))


# The element configurations of chip_smoke.py's `elements_cg1` and
# `elements_cr` phases: (nx, ny, cell type) of the createRectangleMesh
# 10 x 2 plate and RMShellModel's keywords beside shell_bc_func (the clamp
# at x = 0) and element_wise_material=True. elements_cg1 is the reference
# test's "fixed" CG1CG1 model (reduced shear) with the strong clamp: 100,230
# dofs, geometric MG on 4 levels; elements_cr is CG2CR1 with penalty BCs,
# the reference's default: 87,459 dofs, the band Cholesky under the default
# band memory guard.
ELEMENT_PLATES = {
    "elements_cg1": ((256, 64, "quad"),
                     dict(element_type="CG1CG1", PENALTY_BC=False,
                          inplane_deg=2, shear_deg=1)),
    "elements_cr": ((128, 32, "triangle"),
                    dict(element_type="CG2CR1", PENALTY_BC=True)),
}


def element_plate(name, device=None):
    """(mesh, model): the port's RMShellModel of ELEMENT_PLATES[name] on its
    plate."""
    from .mesh import createRectangleMesh
    from .models import RMShellModel

    (nx, ny, cell), kw = ELEMENT_PLATES[name]
    mesh = createRectangleMesh(nx, ny, (0, 0), (10.0, 2.0), cell, gdim=3)
    return mesh, RMShellModel(mesh, shell_bc_func=_clamped_x0,
                              element_wise_material=True, device=device,
                              **kw)


def element_inputs(mesh, design=0):
    """The element phases' inputs, numpy in the FE order: the nodal
    pressure f_z = 2 (n_nodes, 3) and, per cell, the thickness, E = 4.32e8,
    nu = 0 and rho = 100. design 0: h = 0.2; design 1 (the warm call's new
    design): nodal_thickness's profile at the cell centroids with amplitude
    0.2."""
    nn, nel = mesh.n_nodes, mesh.n_cells
    f = np.zeros((nn, 3))
    f[:, 2] = 2.0
    if design == 0:
        th = np.full(nel, 0.2)
    else:
        xc = np.asarray(mesh.coords)[np.asarray(mesh.conn)].mean(axis=1)
        th = nodal_thickness(xc, amplitude=0.2)
    return (f, th, np.full(nel, 4.32e8), np.zeros(nel), np.full(nel, 100.0))


# How far each CG pass of a geometric-MG solve of the element plates may
# lie from the span of the JAX runs' passes: (first pass, restart pass).
# Both follow rounding there. The first pass stops where the recurrence
# residual, falling ~0.8 per iteration, crosses the target; the restart
# pass starts from the true residual at the f64 evaluation floor. Set from
# the readings in PERF.md: at most +3 and +5 on the H100, 0 and +1
# on the CPU. The band's passes must equal the JAX runs' (slack (0, 0)).
MG_PASS_SLACK = (5, 8)


def cg_passes_agree(got, runs, slack=(0, 0)):
    """Whether one solve's CG passes `got` = [first, restart] lie within
    the span of the JAX runs' (`runs`: one [first, restart] per run),
    widened by `slack` = (first, restart); each pass takes at least one
    iteration."""
    if len(got) != 2:
        return False
    for k, (n, s) in enumerate(zip(got, slack)):
        lo, hi = min(int(r[k]) for r in runs), max(int(r[k]) for r in runs)
        if not max(1, lo - s) <= int(n) <= hi + s:
            return False
    return True


def l2_regularization_grad(mesh, thickness):
    """d/dh of the compliance's L2 thickness regularization 0.5e-2 int h^2
    for an element-wise thickness: 1e-2 h_c |cell c| per cell, exact on
    flat quads and triangles. On a laminate h reaches the state only
    through drilling, so this term is nearly all of dJ/dh and the rest is
    the adjoint's part. numpy (n_cells,)."""
    x = np.asarray(mesh.coords)[np.asarray(mesh.conn)]  # (nc, 3 or 4, 3)
    if x.shape[1] == 3:
        d0, d1 = x[:, 1] - x[:, 0], x[:, 2] - x[:, 0]
    else:  # a flat quad's area is half its diagonals' cross product
        d0, d1 = x[:, 2] - x[:, 0], x[:, 3] - x[:, 1]
    area = 0.5 * np.linalg.norm(np.cross(d0, d1), axis=1)
    return 1e-2 * np.asarray(thickness, dtype=np.float64) * area


def planform_direction(coords, length=10.0, width=2.0):
    """A smooth unit in-plane (y) direction for shape finite differences,
    d = s cos(pi y / W) normalised, zero at the root. numpy (n_nodes,)."""
    d = coords[:, 0] / length * np.cos(np.pi * coords[:, 1] / width)
    return d / np.linalg.norm(d)


def wing_nodal_forces(mesh, amplitude):
    """The elliptic lift pressure of `wing_inputs` as nodal forces: at each
    node the pressure times its lumped area (a quarter of each adjacent
    quad's area). numpy (n_nodes, 3)."""
    x = np.asarray(mesh.coords)[np.asarray(mesh.conn)]  # (nc, 4, 3)
    area = 0.5 * np.linalg.norm(np.cross(x[:, 2] - x[:, 0],
                                         x[:, 3] - x[:, 1]), axis=1)
    node_area = np.zeros(mesh.n_nodes)
    np.add.at(node_area, np.asarray(mesh.conn).ravel(),
              np.repeat(area / 4.0, 4))
    span = float(np.max(mesh.coords[:, 1]))
    eta = np.clip(np.asarray(mesh.coords[:, 1]) / span, 0.0, 1.0)
    forces = np.zeros((mesh.n_nodes, 3))
    forces[:, 2] = amplitude * np.sqrt(1.0 - eta ** 2) * node_area
    return forces


def wing_sweep(mesh, amplitude=0.02):
    """A small in-plane mesh motion of a wing, zero at the root: a sweep
    change dx = amplitude (y / span)^2. numpy (n_nodes, 3)."""
    span = float(np.max(mesh.coords[:, 1]))
    disp = np.zeros((mesh.n_nodes, 3))
    disp[:, 0] = amplitude * (np.asarray(mesh.coords[:, 1]) / span) ** 2
    return disp


class WingBench:
    """tools/wing_bench.py's workload: a penalty-BC wing shell
    (createWingShellMesh, root clamped at y = 0), an elliptic 2,000 Pa lift,
    E = 69e9, nu = 0.33, rho = 2700, thickness 0.006; evaluate + compliance
    backward through the band-Cholesky-preconditioned CG."""

    def __init__(self, n_chord=18, n_span=66, rib_stations=None,
                 shuffle_seed=3, device=None):
        from .mesh import createWingShellMesh
        from .models import RMShellModel

        self.device = resolve_device(device)
        if rib_stations is None:
            rib_stations = (n_span // 3, 2 * n_span // 3)
        self.mesh = createWingShellMesh(n_chord=n_chord, n_span=n_span,
                                        rib_stations=tuple(rib_stations),
                                        shuffle_seed=shuffle_seed)
        self.model = RMShellModel(self.mesh,
                                  shell_bc_func=lambda x: x[:, 1] < 1e-9,
                                  element_wise_material=True,
                                  device=self.device)
        self.pde = self.model.fea.states["disp_solid"].pde
        self.n_dofs = self.model.shell_pde.W.n_dofs
        self.P, self.E, self.nu, self.rho = wing_inputs(
            self.mesh, self.device, 2000.0, 69e9, 0.33, 2700.0)
        self.th0 = torch.full((self.mesh.n_cells,), 0.006,
                              dtype=torch.float64, device=self.device)

    def forward_adjoint(self, th):
        th = th.detach().clone().requires_grad_(True)
        out = self.model.evaluate(self.P, th, self.E, self.nu, self.rho)
        out.compliance.backward()
        return out, th.grad

    def run(self, repeats=3):
        """The script's line: the first call, then `repeats` designs
        th0*(1 + 0.01 i), i = 0.., the fastest as `value`; then the
        quality of the nominal solve (rel_res, res_floor and the nodal
        error against host SuperLU)."""
        dev = self.device
        first = _timed(lambda: self.forward_adjoint(self.th0), dev)[1]
        walls = [_timed(lambda: self.forward_adjoint(
            self.th0 * (1.0 + 0.01 * i)), dev)[1] for i in range(repeats)]
        wall = min(walls)
        out, grad = self.forward_adjoint(self.th0)
        u = out.disp_solid.detach()
        params = self.model.fe_inputs(self.P, self.th0, self.E, self.nu)
        rel, res_floor = quality.residual_and_floor(self.pde, params, u)
        nodal = quality.direct_crosscheck(self.pde, params, u)["nodal_l2"]
        return {
            "metric": f"wing_fwd_adjoint_{self.n_dofs}dofs_wall",
            "value": round(wall, 4),
            "unit": "s",
            "n_cells": self.mesh.n_cells,
            "backend": dev.type,
            "compile_s": round(first - wall, 1),
            "precond": type(self.pde._pc).__name__,
            "solver_stats": self.pde.last_info,
            "compliance": float(out.compliance.detach()),
            "grad_norm": float(torch.linalg.norm(grad)),
            "rel_res": float(f"{rel:.2e}"),
            "res_floor": float(f"{res_floor:.2e}"),
            "nodal_err_vs_direct": float(f"{nodal:.2e}"),
            "quality": quality_verdict(rel, res_floor, nodal),
        }


def gust_history(n_nodes, nsteps, dt):
    """tools/transient_bench.py's load history (nsteps + 1, 3 n_nodes):
    f_z = 10 per node times a 1-cos pulse over the first half of the
    horizon, then zero."""
    f_base = np.zeros(3 * n_nodes)
    f_base[2::3] = 10.0
    t = np.arange(nsteps + 1) * dt
    T_gust = 0.5 * nsteps * dt
    amp = np.where(t <= T_gust,
                   0.5 * (1.0 - np.cos(2.0 * np.pi * t / T_gust)), 0.0)
    return amp[:, None] * f_base[None, :]


class TransientBench:
    """tools/transient_bench.py's workload: PlateSim on an nx x ny plate
    (10 x 2), E = 4.32e8, nu = 0, rho = 100, dt = 0.01, thickness 0.1,
    `nsteps` implicit-midpoint steps of the gust; the total strain energy
    by `simulate_outputs` (checkpointed segments) and its backward."""

    def __init__(self, nx=40, ny=20, nsteps=50, device=None):
        from .mesh import createRectangleMesh
        from .models.dynamic_rm_shell import PlateSim

        self.device = resolve_device(device)
        mesh = createRectangleMesh(nx, ny, (0, 0), (10.0, 2.0), "quad",
                                   gdim=3)
        self.nsteps = nsteps
        self.sim = PlateSim(mesh, E=4.32e8, nu=0.0, rho=100.0, dt=0.01,
                            Nsteps=nsteps, element_wise_thickness=True,
                            device=self.device)
        self.fh = torch.as_tensor(gust_history(mesh.n_nodes, nsteps,
                                               self.sim.dt),
                                  device=self.device)
        self.th0 = torch.full((self.sim.num_var,), 0.1, dtype=torch.float64,
                              device=self.device)

    def energy(self, th):
        return self.sim.simulate_outputs(th, self.fh)["total_strain_energy"]

    def forward(self, th):
        with torch.no_grad():
            return self.energy(th)

    def forward_adjoint(self, th):
        th = th.detach().clone().requires_grad_(True)
        e = self.energy(th)
        e.backward()
        return e.detach(), th.grad

    def step_quality(self, th):
        """(rel_res, res_floor) of the worst step solve of one forward run:
        ||b - A_c w|| / ||b|| and eps (|||A_c||w||| + ||b||) / ||b|| per
        step, A_c the constrained step operator, |A_c| = f|A|f + (1-f)I."""
        sim = self.sim
        with torch.no_grad():
            ops = sim._operators(th)
            abs_op = make_constrained_matvec_T(ops.Ae.abs(), sim.W,
                                               sim.free_mask)
            w = torch.zeros(sim.fe_dofs, dtype=torch.float64,
                            device=self.device)
            wdot = torch.zeros_like(w)
            rel = res_floor = 0.0
            for F_i in sim._all_loads(th, self.fh)[1:]:
                w, wdot, b = sim._step(ops, th, w, wdot, F_i)
                bn = float(torch.linalg.norm(b))
                if bn == 0.0:
                    continue
                r = float(torch.linalg.norm(b - ops.A_c(w.contiguous())))
                scale = float(torch.linalg.norm(abs_op(w.abs())))
                rel = max(rel, r / bn)
                res_floor = max(res_floor,
                                quality.device_f64_eps() * (scale + bn) / bn)
        return rel, res_floor

    def run(self, repeats=3):
        """The script's line: forward first and `repeats` new designs
        th0*(1 + 0.01(i+1)) (median), then the same for forward + adjoint
        (median as `value`); then the step solves' quality at th0."""
        dev = self.device

        def designs(fn):
            first = _timed(lambda: fn(self.th0), dev)
            walls = [_timed(lambda: fn(self.th0 * (1.0 + 0.01 * (i + 1))),
                            dev)[1] for i in range(repeats)]
            return first, float(statistics.median(walls))

        (e0, fwd_first), fwd_wall = designs(self.forward)
        ((_, g), vg_first), wall = designs(self.forward_adjoint)
        rel, res_floor = self.step_quality(self.th0)
        n = self.sim.fe_dofs
        return {
            "metric": f"transient_fwd_adjoint_{n}dofs_{self.nsteps}steps_wall",
            "value": round(wall, 4),
            "unit": "s",
            "mode": "checkpointed",
            "fwd_wall_s": round(fwd_wall, 4),
            "backend": dev.type,
            "compile_s": round(vg_first - wall, 1),
            "total_strain_energy": float(e0),
            "grad_norm": float(torch.linalg.norm(g)),
            "rel_res": float(f"{rel:.2e}"),
            "res_floor": float(f"{res_floor:.2e}"),
            "quality": quality_verdict(rel, res_floor),
        }
