"""Which preconditioner RMShellModel picks on the wing bench's meshes, and
why: for each createWingShellMesh(n_chord, n_span) (ribs at n_span/3 and
2 n_span/3, shuffle 3, penalty BCs, as benchmarks.WingBench builds them)
the cells, dofs, the band memory estimate of the reference's guard
(n_pad (m+1) w 12 bytes, `FEMO_BAND_MEM_GB`, default 6) and the selected
preconditioner. Host work only (the models are built on the CPU and never
solve):

    python tools/band_guard_table.py [n_chord x n_span ...]
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from femo_alpha_tpu_torch.benchmarks import WingBench  # noqa: E402

MESHES = ((18, 66), (30, 120), (40, 160), (50, 200))


def main():
    meshes = [tuple(int(v) for v in a.split("x")) for a in sys.argv[1:]]
    guard = os.environ.get("FEMO_BAND_MEM_GB", "6")
    print(f"guard FEMO_BAND_MEM_GB={guard}")
    for nc, ns in meshes or MESHES:
        b = WingBench(n_chord=nc, n_span=ns, device="cpu")
        print(f"{nc}x{ns} cells={b.mesh.n_cells} dofs={b.n_dofs} "
              f"band_estimate_gb={b.model.band_estimate_gb:.2f} "
              f"precond={type(b.pde._pc).__name__}", flush=True)


if __name__ == "__main__":
    main()
