"""Which preconditioner RMShellModel picks on the wing bench's meshes and
on the element plates, and why: for each createWingShellMesh(n_chord,
n_span) (ribs at n_span/3 and 2 n_span/3, shuffle 3, penalty BCs, as
benchmarks.WingBench builds them) and each penalty-BC plate of
benchmarks.ELEMENT_PLATES (elements_cr: the 128x32 CG2CR1 triangle plate
of chip_smoke.py) the cells, dofs, the band memory estimate of the
reference's guard (n_pad (m+1) w 12 bytes, `FEMO_BAND_MEM_GB`, default 6)
and the selected preconditioner. Host work only (the models are built on
the CPU and never solve):

    python tools/band_guard_table.py [n_chord x n_span | elements_cr ...]
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from femo_alpha_tpu_torch.benchmarks import (  # noqa: E402
    WingBench,
    element_plate,
)

MESHES = ("18x66", "30x120", "40x160", "50x200", "elements_cr")


def main():
    guard = os.environ.get("FEMO_BAND_MEM_GB", "6")
    print(f"guard FEMO_BAND_MEM_GB={guard}")
    for arg in sys.argv[1:] or MESHES:
        if arg.startswith("elements_"):
            mesh, model = element_plate(arg, device="cpu")
            pde = model.fea.states["disp_solid"].pde
            label, n = f"{arg} ({model.element_type})", pde.n_dofs
        else:
            nc, ns = (int(v) for v in arg.split("x"))
            b = WingBench(n_chord=nc, n_span=ns, device="cpu")
            mesh, model, pde = b.mesh, b.model, b.pde
            label, n = arg, b.n_dofs
        print(f"{label} cells={mesh.n_cells} dofs={n} "
              f"band_estimate_gb={model.band_estimate_gb:.2f} "
              f"precond={type(pde._pc).__name__}", flush=True)


if __name__ == "__main__":
    main()
