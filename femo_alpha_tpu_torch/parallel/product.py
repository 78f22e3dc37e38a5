"""Multi-device product path: the library models' cell-indexed operators
split over the ranks of a torch.distributed process group.

Port of femo_alpha_tpu/parallel/product.py. The JAX package commits every
cell-indexed operator array to a sharding over the cell axis and lets
XLA's SPMD partitioner turn each consumer into partial work plus one
all-reduce. Here the split is explicit:

- Each rank of the caller's group owns one contiguous range of cells on
  every level (`CellShardSpec.cell_range`: ranges as equal as possible,
  no divisibility needed) and holds only those cells of the fine operator
  `Ae`, of each MG level's `Ae` and of the affine bases. Where the
  assembler can build over a subset of cells (FemForm.cell_values(cells=)),
  it builds only the rank's cells.
- Dof vectors stay replicated and every rank runs the same Krylov loop.
  Each application of a cell-split operator is the fused operator
  (assembly/cuda_kernels.py::constrained_matvec_T) over the rank's cells
  and lane tables (spaces/space.py::CellRange), then one `all_reduce`;
  the kernel's identity term (1 - free) x is taken off on every rank but
  rank 0 before the sum, which is exact for a 0/1 mask
  (`split_operator`). The penalty facet blocks (O(boundary)) stay
  replicated and are added once, after the sum.
- Setup that assembles global entries from element matrices (node-block
  Jacobi blocks, Jacobi diagonal, the coarse level's dense matrix, the
  dense route's matrix, the band before its Cholesky, the AMG's coarse
  Galerkin matrix and Schwarz diagonal) sums the rank's cells, then one
  `all_reduce`; what follows is replicated. The Schwarz smoother's
  per-cell solves (K1) run over the rank's cells, a partial sum, then the
  `all_reduce`.
- K2 (`affine_combine`) runs on each rank over its slice of the basis and
  of theta. PlateSim's design gradients through the K, M and step
  operators come back per cell on the rank's cells, zero-padded, and one
  `all_reduce` in the backward (`grad_all_reduce`) sums them: exact for
  the DG0 field, whose supports are disjoint.
- ImplicitPDE's Newton residual and its parameter vjp (RMShellModel's
  and FEA's design gradients) are split the same way: each rank
  assembles its own cells (rank 0 adds the facet and extra terms) and
  one all_reduce sums the residual, or the gradients.
- What stays replicated: the outputs (compliance, mass, stresses), the
  loads and energies of PlateSim, transfers, smoother inverses after
  their reduction, the coarse inverse, the band factor and its solves,
  the AMG's aggregation and apply outside its smoother and operator.

Every rank reaches bit-identical iterates: every reduction is one
`all_reduce`, whose result is the same on every rank, and everything
else is the same code on the same replicated inputs.

Devices: a rank's tensors live where the model was built (the caller
passes device=; on a card, `cuda:(rank % device_count)` is the usual
choice). One H100 takes two ranks only over gloo (NCCL refuses two ranks
on one card); gloo reduces CUDA tensors through the host. With one card
per rank NCCL would work the same way, untested. Nothing falls back: a
failed collective or kernel launch raises.

Usage:
    mesh = make_device_mesh()          # the initialized default group
    model = RMShellModel(mesh_fe, ...)
    shard_model(model, mesh)           # in place, before the first solve
    out = model.evaluate(...)          # every rank, the same inputs
"""

from __future__ import annotations

import time

import torch

from ..spaces.space import CellRange


class DeviceMesh:
    """The ranks a model is split over: a torch.distributed process group
    and this process's rank in it (`size` ranks), or one rank and no group
    when torch.distributed is not initialized."""

    def __init__(self, group=None, size=1, rank=0):
        self.group, self.size, self.rank = group, int(size), int(rank)

    def __repr__(self):
        return f"DeviceMesh(rank {self.rank} of {self.size})"


def make_device_mesh(n_devices=None, group=None):
    """The caller's process group as a DeviceMesh: `group` (default: the
    default group) or, with n_devices below the world size, a new group of
    ranks 0 .. n_devices - 1 (every rank must call it then; ranks outside
    get None). Without torch.distributed initialized: one rank."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        if n_devices not in (None, 1):
            raise RuntimeError(
                f"make_device_mesh({n_devices}): torch.distributed is not "
                "initialized (init_process_group first)")
        return DeviceMesh()
    if group is None and n_devices is not None \
            and n_devices != dist.get_world_size():
        group = dist.new_group(list(range(int(n_devices))))
        if dist.get_rank() >= n_devices:
            return None
    return DeviceMesh(group, dist.get_world_size(group),
                      dist.get_rank(group))


class CellShardSpec:
    """The cell split of one DeviceMesh: each rank's contiguous cell range
    per cell count, the CellRange views the split operators run on, and
    the one collective of the path (`all_reduce`, a sum), with its count
    and host seconds (`stats`).

    The JAX package splits an array only over a device count that divides
    its cell extent (XLA needs it); here ranges are as equal as possible
    and every level splits over every rank."""

    def __init__(self, mesh, axis="cells"):
        self.mesh = mesh
        self.axis = axis
        self.n_devices = mesh.size
        self.rank = mesh.rank
        self.group = mesh.group
        self._views = {}
        self.n_all_reduce = 0
        self.all_reduce_s = 0.0

    def cell_range(self, nc):
        """(c0, c1): this rank's cells of an nc-cell axis; the first
        nc % n_devices ranks take one cell more."""
        base, rem = divmod(int(nc), self.n_devices)
        r = self.rank
        c0 = r * base + min(r, rem)
        return c0, c0 + base + (1 if r < rem else 0)

    def cells_of(self, space):
        """The CellRange of this rank over `space`'s cells (one per
        space)."""
        view = self._views.get(id(space))
        if view is None or view.space is not space:
            c0, c1 = self.cell_range(space.dofmap.shape[0])
            view = self._views[id(space)] = CellRange(space, c0, c1, self)
        return view

    def all_reduce(self, t):
        """Sum `t` over the ranks, in place (t contiguous); returns t. One
        rank: t as it is."""
        if self.n_devices == 1:
            return t
        import torch.distributed as dist

        if not t.is_contiguous():
            raise ValueError("all_reduce: non-contiguous tensor")
        t0 = time.perf_counter()
        dist.all_reduce(t, group=self.group)
        self.all_reduce_s += time.perf_counter() - t0
        self.n_all_reduce += 1
        return t

    def split_operator(self, op, free):
        """The operator of every rank's cells from `op`, the fused
        constrained operator over this rank's cells (which adds
        (1 - free) x): every rank but rank 0 takes that term off again,
        then one all_reduce. Exact for a 0/1 mask: a free dof subtracts 0,
        a constrained one gives x - x = 0."""
        if self.rank == 0:
            return lambda x: self.all_reduce(op(x))
        dead = 1.0 - free

        def mv(x):
            return self.all_reduce(op(x) - dead * x)

        return mv

    def gather_cells(self, a, view):
        """A block on this rank's cells of `view` (cell axis last) as the
        whole array on every rank: placed at its range in zeros, then one
        all_reduce (exact: every entry is one rank's value plus zeros)."""
        nc = view.space.dofmap.shape[0]
        whole = a.new_zeros(a.shape[:-1] + (nc,))
        whole[..., view.cells[0]:view.cells[1]] = a
        return self.all_reduce(whole)

    def stats(self):
        return {"all_reduce": self.n_all_reduce,
                "all_reduce_s": self.all_reduce_s}

    def reset_stats(self):
        self.n_all_reduce, self.all_reduce_s = 0, 0.0


class _GradAllReduce(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the ranks."""

    @staticmethod
    def forward(ctx, x, spec):
        ctx.spec = spec
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.spec.all_reduce(g.contiguous().clone()), None


class _SumOverRanks(torch.autograd.Function):
    """Forward: the sum over the ranks; the backward passes the gradient
    to this rank's share as it is."""

    @staticmethod
    def forward(ctx, x, spec):
        return spec.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over_ranks(x, spec):
    """The sum of every rank's x, differentiable: each rank's share gets
    the gradient of the sum unchanged, so a design that entered the share
    through grad_all_reduce gets its gradient summed once."""
    if spec is None or spec.n_devices == 1:
        return x
    return _SumOverRanks.apply(x, spec)


def grad_all_reduce(x, spec):
    """x itself, whose gradient is summed over the ranks: the entry of a
    design into the rank's share of split operators, whose backward gives
    the rank's cells only (zero-padded per cell, or partial nodal sums)."""
    if spec is None or spec.n_devices == 1 or not x.requires_grad:
        return x
    return _GradAllReduce.apply(x, spec)


def _cell_axis_cut(a, view):
    """A cell-indexed array with the cell axis last: the rank's range of
    it (a whole array is cut, one already on the range passes)."""
    c0, c1 = view.cells
    nc = view.space.dofmap.shape[0]
    if a.shape[-1] == view.nc and view.nc != nc:
        return a
    if a.shape[-1] != nc:
        raise ValueError(f"shard: cell axis {a.shape[-1]}, expected {nc} "
                         f"or the range's {view.nc}")
    return a[..., c0:c1].contiguous()


def shard_aux(pde, aux):
    """A prepared aux (cell basis, preconditioner aux, facet blocks) with
    the cell-indexed bases of the pieces that split on this rank's range:
    the bases the port prepares under a split are built on the range
    already and pass; a whole one is cut. A piece that runs whole (no
    `shard` / `shard_state` hook) keeps its aux whole. Facet blocks
    (O(boundary)) stay replicated."""
    spec = getattr(pde, "shard_spec", None)
    if spec is None or aux is None:
        return aux
    emb, pca, fops = aux
    if emb is not None and not pde._emf_whole:
        emb = _cell_axis_cut(emb, spec.cells_of(pde.form.space))
    if pca and pde._pc is not None and not pde._pc_whole:
        levels = getattr(getattr(pde._pc, "mg", None), "levels", None)
        pca = tuple(b if b is None or levels is None else
                    _cell_axis_cut(b, spec.cells_of(levels[k]["space"]))
                    for k, b in enumerate(pca))
    return emb, pca, fops


def shard_ops(pde, ops_Ae):
    """Element blocks in the ImplicitPDE's op layout with the cell block
    on this rank's range (built there already, or cut); the facet blocks
    stay replicated."""
    spec = getattr(pde, "shard_spec", None)
    if spec is None:
        return ops_Ae
    return [_cell_axis_cut(ops_Ae[0], spec.cells_of(pde.form.space))] + \
        list(ops_Ae[1:])


def shard_mg_state(mg, spec):
    """Install the cell split on a GeometricMG (solvers/multigrid.py):
    every later `setup` builds this rank's cells of each level (its Ae
    through the level's assembler, its smoother blocks, its operator) and
    reduces what it assembles globally. Returns mg. (The JAX package
    constrains a state it traced whole; the port builds it split.)"""
    mg.shard(spec)
    return mg


def _shard_implicit_pde(pde, spec):
    """Install the split on one ImplicitPDE: its cell block on the rank's
    range (the op spec), and each user piece split by its own hook where
    it has one: the element-matrix function's `shard(view)`, the
    preconditioner's or the plain factory's `shard_state(spec)`. A piece
    without a hook runs whole on every rank, as under the JAX package's
    GSPMD, and does not split its work: an element-matrix function's
    whole blocks are cut to the rank's cells (shard_ops), a plain factory
    is called with the replicated (u, params) at each linearization, and a
    split-protocol preconditioner is handed the whole fine block,
    gathered from the ranks' blocks once per linearization
    (ImplicitPDE._linearize)."""
    fn = pde.element_matrices_fn
    pde._emf_whole = fn is not None and not hasattr(fn, "shard")
    pde._pc_whole = pde._pc is not None and not hasattr(pde._pc,
                                                        "shard_state")
    if fn is not None and not pde._emf_whole:
        fn.shard(spec.cells_of(pde.form.space))
    for pc in (pde._pc, pde._pf):
        if hasattr(pc, "shard_state"):
            pc.shard_state(spec)
    pde._op_specs[0] = spec.cells_of(pde.form.space)
    pde.shard_spec = spec


def shard_model(target, mesh=None, axis="cells"):
    """Split a library model over the ranks of a DeviceMesh, in place
    (mesh None: make_device_mesh()). target: RMShellModel, FEA,
    ImplicitPDE or PlateSim. Returns target. Every rank calls it, builds
    the same model and evaluates it on the same inputs."""
    from ..adjoint.implicit import ImplicitPDE
    from ..fea.fea import FEA

    mesh = mesh or make_device_mesh()
    spec = CellShardSpec(mesh, axis)
    if isinstance(target, ImplicitPDE):
        _shard_implicit_pde(target, spec)
        return target
    if isinstance(target, FEA):
        for st in target.states.values():
            _shard_implicit_pde(st.pde, spec)
        return target
    if hasattr(target, "fea") and isinstance(target.fea, FEA):
        shard_model(target.fea, mesh, axis)
        target.shard_spec = target.fea.states[
            next(iter(target.fea.states))].pde.shard_spec
        return target
    if hasattr(target, "simulate") and hasattr(target, "_element_mats"):
        target.shard(spec)
        return target
    raise TypeError(f"don't know how to shard {type(target).__name__}")
