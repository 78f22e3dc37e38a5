"""Generated aircraft-like wing shell meshes.

Copy of femo_alpha_tpu/mesh/wing.py (numpy only).

The reference ships its aircraft meshes (c172_650/2106.msh, pav wing 2374
quads, lpc left_wing_*.msh) as git-lfs pointer stubs with no payload in the
snapshot, so they cannot be loaded by ANY reader. These generators produce
geometrically comparable unstructured quad shell meshes at the same scales:
a closed, tapered, cambered wing skin (tube topology) with optional interior
ribs (non-manifold junction edges, like the lpc/pav rib-stiffened wings) —
the mesh regime the reference's MUMPS + PENALTY_BC default workload runs on
(rm_shell_model.py:35, utils_dolfinx.py:495-531).

Node and cell orderings are shuffled (seeded) so nothing downstream can
accidentally exploit grid structure — these meshes exercise the genuinely
unstructured code paths.
"""

from __future__ import annotations

import numpy as np

from .mesh import Mesh

# physical tags used by the generated wings
SKIN_TAG = 1
RIB_TAG = 2
ROOT_FACET_TAG = 100  # root section edges (the clamped BC in the examples)
RIB_FACET_TAG = 200  # skin-rib junction edges (interior, non-manifold)


def _section(n_chord, chord, camber, tratio):
    """Closed airfoil-like loop: (2*n_chord, 2) of (x, z), LE->TE on top,
    TE->LE underneath. Biconvex section with camber."""
    s = np.linspace(0.0, 1.0, n_chord + 1)
    half = tratio * chord * 2.0 * s * (1.0 - s)
    cam = camber * chord * np.sin(np.pi * s)
    x = s * chord
    top = np.stack([x, cam + half], axis=1)
    bot = np.stack([x, cam - half], axis=1)
    # loop: top LE->TE (n_chord+1 pts) then bottom TE->LE interior pts
    loop = np.concatenate([top, bot[-2:0:-1]], axis=0)
    return loop  # (2*n_chord, 2)


def createWingShellMesh(n_chord=10, n_span=32, span=10.0, root_chord=1.6,
                        taper=0.5, sweep=0.3, dihedral=0.05, camber=0.03,
                        thickness_ratio=0.12, rib_stations=(),
                        shuffle_seed=0):
    """Closed-skin wing shell mesh of quads embedded in R^3.

    Skin cells: 2*n_chord*n_span quads (tube between n_span+1 sections).
    Each station in `rib_stations` (ints in [1, n_span-1]) adds a ladder of
    n_chord-2 rib quads joining top and bottom skin nodes — the junction
    edges are non-manifold (3 incident cells), as in rib-stiffened aircraft
    wings. Returns a Mesh with cell_tags {SKIN_TAG, RIB_TAG}, facet_tags
    {ROOT_FACET_TAG: root edges, RIB_FACET_TAG: junction edges}.
    """
    nl = 2 * n_chord  # loop length
    stations = np.linspace(0.0, 1.0, n_span + 1)
    coords = np.empty(((n_span + 1) * nl, 3), dtype=np.float64)
    for j, t in enumerate(stations):
        chord = root_chord * (1.0 - (1.0 - taper) * t)
        loop = _section(n_chord, chord, camber, thickness_ratio)
        x = loop[:, 0] + sweep * span * t
        y = np.full(nl, span * t)
        z = loop[:, 1] + dihedral * span * t
        coords[j * nl:(j + 1) * nl] = np.stack([x, y, z], axis=1)

    def nid(j, i):
        return j * nl + (i % nl)

    cells = []
    tags = []
    for j in range(n_span):
        for i in range(nl):
            cells.append([nid(j, i), nid(j, i + 1),
                          nid(j + 1, i + 1), nid(j + 1, i)])
            tags.append(SKIN_TAG)

    # loop index of top_i is i; of bot_i is (nl - i) % nl
    rib_edges = []
    for j in rib_stations:
        assert 1 <= j <= n_span, f"rib station {j} outside [1, {n_span}]"
        for i in range(1, n_chord - 1):
            t0, t1 = nid(j, i), nid(j, i + 1)
            b0, b1 = nid(j, (nl - i) % nl), nid(j, (nl - i - 1) % nl)
            cells.append([t0, t1, b1, b0])
            tags.append(RIB_TAG)
            rib_edges.append((t0, t1))
            rib_edges.append((b0, b1))

    conn = np.asarray(cells, dtype=np.int32)
    tags = np.asarray(tags, dtype=np.int64)

    # shuffle node and cell order (destroy structure)
    rng = np.random.default_rng(shuffle_seed)
    nperm = rng.permutation(len(coords))
    inv = np.empty_like(nperm)
    inv[nperm] = np.arange(len(coords))
    coords = coords[nperm]
    conn = inv[conn].astype(np.int32)
    cperm = rng.permutation(len(conn))
    conn = conn[cperm]
    tags = tags[cperm]

    m = Mesh(coords, conn, "quad")
    m.input_global_indices = np.arange(m.n_nodes, dtype=np.int64)
    m.original_cell_index = np.arange(m.n_cells, dtype=np.int64)
    m.cell_tags = {
        int(t): np.where(tags == t)[0].astype(np.int32)
        for t in np.unique(tags)
    }
    root_edges = np.asarray(
        [[inv[nid(0, i)], inv[nid(0, i + 1)]] for i in range(nl)],
        dtype=np.int32)
    m.facet_tags = {ROOT_FACET_TAG: root_edges}
    if rib_edges:
        m.facet_tags[RIB_FACET_TAG] = inv[
            np.asarray(rib_edges, dtype=np.int64)].astype(np.int32)
    m.physical_names = {SKIN_TAG: "skin", RIB_TAG: "rib",
                        ROOT_FACET_TAG: "root", RIB_FACET_TAG: "rib_junction"}
    return m
