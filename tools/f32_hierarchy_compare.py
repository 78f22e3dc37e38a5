"""The f32 geometric-MG hierarchies of the JAX package and of the port,
entry by entry, on one design (FEMO_MG_F32=1 in both, the strong-BC
cantilever of LibraryBench: 10 x 2, element-wise h = 0.2, E = 4.32e8,
nu = 0, f_z = 2):

    FEMO_PLATFORM=cpu FEMO_SETUP_CACHE=0 FEMO_COMPILE_CACHE=0 \
        python tools/f32_hierarchy_compare.py [NX NY]    (default 64 16)

Each package's RMShellModel builds its own hierarchy (f32 RMShellPDE and
f32 affine bases on the coarser levels); the state of one linearization
(ShellMGPrecond.setup_state on the fine operator of its own assembly) is
compared level by level, in the order setup makes it: the level's element
matrices, its block-Jacobi inverses, its Chebyshev lmax estimate, then
the coarse level's scaling and scaled dense inverse. Each entry prints
the max-abs difference over the max-abs of the JAX entry, and the first
entry past the f32 rounding floor (1e-5) is named. The coarse level's
scaled matrix is assembled again in f64 from the port's f32 element
matrices: its condition number, and each f32 inverse's residual
max|I - As X| and distance from the f64 inverse. Then the port solves
the plate on its f32 hierarchy and prints its CG passes (the first pass
and the restart from the true residual) of the forward and adjoint
solves beside the JAX package's pinned ones at 64x16
(tests/reference_digits/f32.npz).
The JAX package runs with its other FEMO_* flags unset and its setup and
compile caches off (the script sets them).
"""

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

for _flag in ("FEMO_LANE_MAJOR", "FEMO_HOSTLOOP", "FEMO_CG_DF",
              "FEMO_OP_STORAGE", "FEMO_BAND_MEM_GB"):
    os.environ.pop(_flag, None)
os.environ["FEMO_MG_F32"] = "1"
os.environ["FEMO_SETUP_CACHE"] = "0"
os.environ["FEMO_COMPILE_CACHE"] = "0"
os.environ.setdefault("FEMO_PLATFORM", "cpu")

FLOOR = 1e-5  # f32 entries summed in two orders part by a few ulps


def _bc(x):
    return x[:, 0] < 1e-12


def _inputs(nel, nn):
    f = np.zeros(3 * nn)
    f[2::3] = 2.0
    return {"thickness": np.full(nel, 0.2), "E": np.full(nel, 4.32e8),
            "nu": np.zeros(nel), "F_solid": f, "uhat": np.zeros(3 * nn)}


def jax_state(nx, ny):
    import jax.numpy as jnp

    from femo_alpha_tpu.mesh import createRectangleMesh
    from femo_alpha_tpu.models import RMShellModel

    mesh = createRectangleMesh(nx, ny, (0, 0), (10.0, 2.0), "quad", gdim=3)
    model = RMShellModel(mesh, shell_bc_func=_bc, element_wise_material=True,
                         PENALTY_BC=False)
    pde = model.fea.states["disp_solid"].pde
    p = {k: jnp.asarray(v) for k, v in
         _inputs(mesh.n_cells, mesh.n_nodes).items()}
    u0 = jnp.zeros(pde.n_dofs)
    emb, pca, fops = pde._prepare_aux(p)
    ops = pde._assemble_ops(u0, p, emf_basis=emb)
    st = pde._pc.setup_state(u0, p, ops, pca)
    out = {"Ae": [np.asarray(a) for a in st["Ae"]],  # cell-major on the CPU
           "blocks": [[np.asarray(d) for d in b] for b in st["blocks"]],
           "lmax": [float(v) for v in st["lmax"]],
           "coarse_scale": np.asarray(st["coarse_scale"]),
           "coarse_inv": np.asarray(st["coarse_inv"]),
           "dtype": str(st["Ae"][1].dtype)}
    return model, out


def port_state(nx, ny):
    import torch

    from femo_alpha_tpu_torch.mesh import createRectangleMesh
    from femo_alpha_tpu_torch.models import RMShellModel

    mesh = createRectangleMesh(nx, ny, (0, 0), (10.0, 2.0), "quad", gdim=3)
    model = RMShellModel(mesh, shell_bc_func=_bc, element_wise_material=True,
                         PENALTY_BC=False, device="cpu")
    pde = model.fea.states["disp_solid"].pde
    p = {k: torch.as_tensor(v) for k, v in
         _inputs(mesh.n_cells, mesh.n_nodes).items()}
    u0 = torch.zeros(pde.n_dofs, dtype=torch.float64)
    with torch.no_grad():
        emb, pca, fops = pde._prepare_aux(p)
        ops = pde._assemble_ops(u0, p, emf_basis=emb, facet_ops=fops)
        st = pde._pc.setup_state(u0, p, ops, pca)
        # the coarse level's scaled matrix, assembled again in f64 from
        # its f32 element matrices: how far each f32 inverse is from the
        # inverse of the matrix it inverts
        from femo_alpha_tpu_torch.solvers.multigrid import dense_constrained

        lev = pde._pc.mg.levels[-1]
        A = dense_constrained(st["Ae"][-1].double().permute(2, 0, 1),
                              lev["space"], lev["free"].double())
        s_c = st["coarse_scale"].double()
        As = (A * s_c[:, None] * s_c[None, :]).numpy()
    out = {"Ae": [a.permute(2, 0, 1).numpy() for a in st["Ae"]],
           "blocks": [[d.permute(2, 0, 1).numpy() for d in b]
                      for b in st["blocks"]],
           "lmax": [float(v) for v in st["lmax"]],
           "coarse_scale": st["coarse_scale"].numpy(),
           "coarse_inv": st["coarse_inv"].numpy(),
           "dtype": str(st["Ae"][1].dtype), "As64": As}
    return model, out


def rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def compare(j, t):
    """[(entry, rel)] in setup's order."""
    rows = []
    n_levels = len(j["Ae"])
    for k in range(n_levels):
        rows.append((f"level {k} Ae", rel(t["Ae"][k], j["Ae"][k])))
        if k < n_levels - 1:
            for i, (dj, dt) in enumerate(zip(j["blocks"][k], t["blocks"][k])):
                rows.append((f"level {k} block-Jacobi inverse {i}",
                             rel(dt, dj)))
            rows.append((f"level {k} lmax", rel(t["lmax"][k], j["lmax"][k])))
    rows.append(("coarse scale", rel(t["coarse_scale"], j["coarse_scale"])))
    rows.append(("coarse inverse", rel(t["coarse_inv"], j["coarse_inv"])))
    return rows


def port_passes(model):
    """The port's forward and adjoint CG passes (first pass, restart from
    the true residual) and J on its f32 hierarchy."""
    import torch

    nel, nn = model.nel, model.nn
    p = _inputs(nel, nn)
    th = torch.tensor(p["thickness"], requires_grad=True)
    out = model.evaluate(p["F_solid"], th, p["E"], p["nu"],
                         np.full(nel, 100.0))
    out.compliance.backward()
    info = model.fea.states["disp_solid"].pde.last_info
    return ([info["forward"]["passes"], info["adjoint"]["passes"]],
            float(out.compliance))


def main():
    nx, ny = (int(a) for a in sys.argv[1:3]) if len(sys.argv) > 2 \
        else (64, 16)
    t0 = time.perf_counter()
    mj, j = jax_state(nx, ny)
    mt, t = port_state(nx, ny)
    print(f"f32 hierarchies at {nx}x{ny}: {len(j['Ae'])} levels, coarser "
          f"levels in {j['dtype']} (JAX) / {t['dtype']} (port)")
    first = None
    for name, r in compare(j, t):
        print(f"  {name}: {r:.3e}")
        if first is None and r > FLOOR:
            first = (name, r)
    print(f"lmax JAX {j['lmax']} port {t['lmax']}")
    As = t["As64"]
    print(f"coarse level: {As.shape[0]} dofs, 2-norm condition number of "
          f"the scaled matrix {np.linalg.cond(As):.3e}")
    X = np.linalg.inv(As)
    for name, Xi in (("JAX", j["coarse_inv"]), ("port", t["coarse_inv"])):
        Xi = Xi.astype(np.float64)
        print(f"  {name} f32 inverse: max|I - As X| "
              f"{np.abs(np.eye(As.shape[0]) - As @ Xi).max():.3e}, "
              f"from the f64 inverse {rel(Xi, X):.3e}")
    print("first entry past the f32 floor "
          f"({FLOOR:.0e}): {first[0]} ({first[1]:.3e})" if first else
          f"no entry past the f32 floor ({FLOOR:.0e})")
    pt, Jt = port_passes(mt)
    print(f"CG passes [forward, adjoint]: port {pt} (J {Jt!r})")
    if (nx, ny) == (64, 16):
        ref = np.load(os.path.join(ROOT, "tests", "reference_digits",
                                   "f32.npz"))
        print("JAX (tools/f32_reference_digits.py, 8 / 1 / 4 cores): "
              f"{ref['mg_passes'].tolist()} {ref['mg_passes_1'].tolist()} "
              f"{ref['mg_passes_4'].tolist()}")
    print(f"seconds {time.perf_counter() - t0:.1f}")


if __name__ == "__main__":
    main()
