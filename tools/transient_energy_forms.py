"""The per-step strain energy of the transient gust workload by three
routes on one and the same trajectory, to show how far 0.5 w^T K w by the
operator cancels:

    python tools/transient_energy_forms.py [cpu|cuda]

The port's PlateSim with dense step solves at the inputs of chip_smoke.py's
`transient` phase (40x20, 50 steps, h = 0.1) runs one forward; on its
displacement history it sums the energy form (PlateSim.strain_energy,
squared strains at the quadrature points), 0.5 w^T K w with K from the
affine basis (one K2 combine, the fused operator) and 0.5 w^T K w with K
from a direct jacfwd assembly, and prints the three totals, their
relative differences and the largest difference between the two K.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import _gust  # noqa: E402
from femo_alpha_tpu_torch.assembly.affine import AffineOperator  # noqa
from femo_alpha_tpu_torch.assembly.assemble import (  # noqa: E402
    element_matrices,
    make_constrained_matvec_T,
)
from femo_alpha_tpu_torch.mesh import createRectangleMesh  # noqa: E402
from femo_alpha_tpu_torch.models.dynamic_rm_shell import PlateSim  # noqa


def main():
    dev = sys.argv[1] if len(sys.argv) > 1 else "cpu"
    mesh = createRectangleMesh(40, 20, (0, 0), (10.0, 2.0), "quad", gdim=3)
    sim = PlateSim(mesh, E=4.32e8, nu=0.0, rho=100.0, dt=0.01, Nsteps=50,
                   element_wise_thickness=True, solver_method="dense",
                   device=dev)
    t64 = dict(dtype=torch.float64, device=dev)
    fh = torch.as_tensor(_gust(mesh.n_nodes, 50, sim.dt), **t64)
    th = torch.full((mesh.n_cells,), 0.1, **t64)
    with torch.no_grad():
        wh = sim.simulate(th, fh)
        e_form = float(sim.strain_energy_history(wh, th).sum())
        K = AffineOperator(sim._bases(th)[0], (1, 3), th, sim.W)
        Ke = element_matrices(sim.K_form, torch.zeros(sim.fe_dofs, **t64),
                              sim._k_params(th)).permute(1, 2, 0)
        Ke = Ke.contiguous()
        Kd = make_constrained_matvec_T(Ke, sim.W,
                                       torch.ones(sim.fe_dofs, **t64))
        e_aff = sum(float(0.5 * torch.dot(w, K.matvec(w))) for w in wh)
        e_dir = sum(float(0.5 * torch.dot(w, Kd(w))) for w in wh)
        dK = float((K.Ae - Ke).abs().max() / Ke.abs().max())
    print(f"energy form {e_form:.15e}")
    print(f"0.5 w^T K w, affine K {e_aff:.15e} "
          f"(rel {e_aff / e_form - 1:+.3e})")
    print(f"0.5 w^T K w, direct K {e_dir:.15e} "
          f"(rel {e_dir / e_form - 1:+.3e}; affine vs direct "
          f"{e_aff / e_dir - 1:+.3e})")
    print(f"max |K_affine - K_direct| / max |K| {dK:.3e}")


if __name__ == "__main__":
    main()
