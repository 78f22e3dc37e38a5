"""Gmsh `.msh` ASCII reader and writer (MSH 2.2 and 4.1).

Copy of femo_alpha_tpu/io/gmsh.py (numpy only; the JAX package cannot be
imported without jax). The reorder maps the reader sets are the ones the
model's caller-ordered inputs go through, so they are kept exactly; the
writer emits the same text as the reference's for the same mesh.

It stands in for the reference FEMO's meshio/dolfinx-gmsh import path
(readFEAMesh / import_mesh, utils_dolfinx.py:34-128): the reference ships
its aircraft shell meshes as gmsh files.

Surface shells: we read the highest-dimensional element family present
(quads and/or triangles for shells, lines for interval meshes); physical
tags become `cell_tags` dicts (tag -> cell indices) compatible with
createCustomMeasure-style subdomain selection (utils_dolfinx.py:555-565),
and facet elements of dimension rdim-1 become `facet_tags`
(tag -> (n, 2|1) vertex arrays in OUR node numbering).
"""

from __future__ import annotations

import os

import numpy as np

# gmsh element type id -> (name, n_nodes, topological dim)
_GMSH_TYPES = {
    1: ("interval", 2, 1),
    2: ("triangle", 3, 2),
    3: ("quad", 4, 2),
    15: ("point", 1, 0),
}
_TYPE_OF_CELL = {"interval": 1, "triangle": 2, "quad": 3}


def _read_sections(filename):
    """Split a .msh file into {section_name: [lines]}."""
    sections = {}
    name = None
    buf = None
    with open(filename, "r", errors="replace") as f:
        first = f.readline()
        if first.startswith("version https://git-lfs"):
            raise ValueError(
                f"{filename} is a git-lfs pointer stub, not mesh data "
                "(the reference snapshot ships meshes without LFS payload)")
        f.seek(0)
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("$End"):
                sections[name] = buf
                name, buf = None, None
            elif line.startswith("$"):
                name = line[1:]
                buf = []
            elif buf is not None:
                buf.append(line)
    return sections


def read_msh(filename, gdim=3):
    """Read an ASCII gmsh v2.2 or v4.1 file into a Mesh.

    Returns a Mesh with `.cell_tags` (dict physical-tag -> cell index
    array), `.facet_tags` (dict physical-tag -> facet vertex array),
    `.physical_names` (dict tag -> name), and the CADDEE-contract reorder
    maps `input_global_indices` / `original_cell_index` reflecting the
    file's node/element tag order (rm_shell_model.py:398-412)."""
    sections = _read_sections(filename)
    if "MeshFormat" not in sections:
        raise ValueError(f"{filename}: missing $MeshFormat")
    version = float(sections["MeshFormat"][0].split()[0])
    is_binary = sections["MeshFormat"][0].split()[1] != "0"
    if is_binary:
        raise NotImplementedError("binary .msh not supported (ASCII only)")
    if version >= 4.0:
        node_tags, coords, elems = _parse_v4(sections)
        ent_phys = _parse_entities_v4(sections)
        # v4 elements carry (dim, entity-tag); map to physical tags
        for e in elems:
            phys = ent_phys.get((e["dim"], e["entity"]), e["entity"])
            e["phys_arr"] = np.full(len(e["tags"]), phys, dtype=np.int64)
    elif version >= 2.0:
        node_tags, coords, elems = _parse_v2(sections)
    else:
        raise NotImplementedError(f"msh version {version}")

    physical_names = {}
    for line in sections.get("PhysicalNames", [])[1:]:
        parts = line.split(None, 2)
        if len(parts) == 3:
            physical_names[int(parts[1])] = parts[2].strip().strip('"')

    # node tag -> contiguous index (gmsh tags are arbitrary, often 1-based)
    node_tags = np.asarray(node_tags, dtype=np.int64)
    order = np.argsort(node_tags, kind="stable")
    sorted_tags = node_tags[order]
    coords = np.asarray(coords, dtype=np.float64)[order]

    def to_index(tags):
        idx = np.searchsorted(sorted_tags, tags)
        if np.any(idx >= len(sorted_tags)) or np.any(
                sorted_tags[np.minimum(idx, len(sorted_tags) - 1)] != tags):
            raise ValueError(f"{filename}: element references unknown node")
        return idx.astype(np.int32)

    # pick the highest topological dimension present as the cell family
    max_dim = max((e["dim"] for e in elems), default=-1)
    if max_dim < 1:
        raise ValueError(f"{filename}: no 1D/2D elements found")
    cell_blocks = [e for e in elems if e["dim"] == max_dim]
    kinds = sorted({e["cell_type"] for e in cell_blocks})
    # file position of each cell among the max-dim elements, in file order
    # (what original_cell_index must hold — see below)
    pos = 0
    for e in cell_blocks:
        e["file_pos"] = np.arange(pos, pos + len(e["conn"]), dtype=np.int64)
        pos += len(e["conn"])
    if len(kinds) > 1:
        # mixed tri/quad shell: split quads into triangles (the reference's
        # dolfinx path would reject this too; splitting preserves geometry)
        tris = []
        phys = []
        fpos = []
        etags = []
        for e in cell_blocks:
            c = e["conn"]
            if e["cell_type"] == "quad":
                # concat order is [all first halves, all second halves] —
                # per-quad data must TILE (not repeat) to stay aligned
                tris.append(np.concatenate([c[:, [0, 1, 2]],
                                            c[:, [0, 2, 3]]], axis=0))
                phys.append(np.tile(e["phys_arr"], 2))
                fpos.append(np.tile(e["file_pos"], 2))
                etags.append(np.tile(e["tags"], 2))
            else:
                tris.append(c)
                phys.append(e["phys_arr"])
                fpos.append(e["file_pos"])
                etags.append(e["tags"])
        conn_tags = np.concatenate(tris, axis=0)
        phys_all = np.concatenate(phys)
        cell_file_pos = np.concatenate(fpos)
        elem_tags = np.concatenate(etags)
        cell_type = "triangle"
    else:
        cell_type = kinds[0]
        conn_tags = np.concatenate([e["conn"] for e in cell_blocks], axis=0)
        phys_all = np.concatenate([e["phys_arr"] for e in cell_blocks])
        cell_file_pos = np.concatenate(
            [e["file_pos"] for e in cell_blocks])
        elem_tags = np.concatenate([e["tags"] for e in cell_blocks])

    conn = to_index(conn_tags.ravel()).reshape(conn_tags.shape)

    coords_out = coords[:, :gdim]
    if gdim > coords.shape[1]:
        coords_out = np.concatenate(
            [coords, np.zeros((len(coords), gdim - coords.shape[1]))],
            axis=1)

    from ..mesh import Mesh

    m = Mesh(coords_out, conn, cell_type)
    # CADDEE-contract reorder maps are 0-BASED FILE POSITIONS, not gmsh
    # tags: input_global_indices[i] = file row of FE node i (FE order is
    # tag-sorted, so this is exactly `order`), original_cell_index[i] =
    # file position of FE cell i among the max-dim elements (identity
    # except for quad->tri splitting, where each source quad repeats).
    # Callers pass per-node/per-cell arrays in FILE order and the model
    # gathers with v[map] (rm_shell_model.py:398-412 semantics); storing
    # raw 1-based tags here silently shifted every input by one.
    m.input_global_indices = order.astype(np.int64)
    m.original_cell_index = cell_file_pos.astype(np.int64)
    # raw gmsh element tags, for provenance/debugging only
    m.cell_gmsh_tags = elem_tags.astype(np.int64)
    m.cell_tags = {
        int(t): np.where(phys_all == t)[0].astype(np.int32)
        for t in np.unique(phys_all)
    }
    # facet elements one dimension down -> facet vertex sets per tag
    m.facet_tags = {}
    for e in elems:
        if e["dim"] != max_dim - 1 or e["dim"] < 1:
            continue
        verts = to_index(e["conn"].ravel()).reshape(e["conn"].shape)
        for t in np.unique(e["phys_arr"]):
            sel = verts[e["phys_arr"] == t]
            prev = m.facet_tags.get(int(t))
            m.facet_tags[int(t)] = (
                sel if prev is None
                else np.concatenate([prev, sel], axis=0))
    m.physical_names = physical_names
    return m


def _parse_v2(sections):
    nodes = sections["Nodes"]
    n = int(nodes[0])
    node_tags = np.empty(n, dtype=np.int64)
    coords = np.empty((n, 3), dtype=np.float64)
    for i, line in enumerate(nodes[1:1 + n]):
        parts = line.split()
        node_tags[i] = int(parts[0])
        coords[i] = [float(parts[1]), float(parts[2]), float(parts[3])]

    elems = []
    by_type = {}
    for line in sections["Elements"][1:]:
        parts = line.split()
        etag, etype, ntags = int(parts[0]), int(parts[1]), int(parts[2])
        if etype not in _GMSH_TYPES:
            continue
        name, nv, dim = _GMSH_TYPES[etype]
        phys = int(parts[3]) if ntags >= 1 else 0
        conn = [int(x) for x in parts[3 + ntags:3 + ntags + nv]]
        by_type.setdefault(etype, []).append((etag, phys, conn))
    for etype, rows in by_type.items():
        name, nv, dim = _GMSH_TYPES[etype]
        elems.append({
            "dim": dim, "cell_type": name, "entity": 0,
            "tags": np.asarray([r[0] for r in rows], dtype=np.int64),
            "phys_arr": np.asarray([r[1] for r in rows], dtype=np.int64),
            "conn": np.asarray([r[2] for r in rows], dtype=np.int64),
        })
    return node_tags, coords, elems


def _parse_entities_v4(sections):
    """(dim, entity_tag) -> first physical tag (0 if none)."""
    out = {}
    lines = sections.get("Entities")
    if not lines:
        return out
    counts = [int(x) for x in lines[0].split()]  # nPoints nCurves nSurf nVol
    i = 1
    for dim, cnt in enumerate(counts):
        for _ in range(cnt):
            parts = lines[i].split()
            i += 1
            tag = int(parts[0])
            # point: tag x y z numPhys phys...; others: tag 6 bbox floats
            off = 4 if dim == 0 else 7
            nphys = int(parts[off])
            phys = int(parts[off + 1]) if nphys > 0 else 0
            out[(dim, tag)] = phys
    return out


def _parse_v4(sections):
    lines = sections["Nodes"]
    header = lines[0].split()
    n_blocks, n_nodes = int(header[0]), int(header[1])
    node_tags = np.empty(n_nodes, dtype=np.int64)
    coords = np.empty((n_nodes, 3), dtype=np.float64)
    i, k = 1, 0
    for _ in range(n_blocks):
        _dim, _ent, parametric, nb = (int(x) for x in lines[i].split())
        i += 1
        tags = [int(lines[i + j]) for j in range(nb)]
        i += nb
        for j in range(nb):
            parts = lines[i + j].split()
            coords[k + j] = [float(parts[0]), float(parts[1]),
                             float(parts[2])]
        i += nb
        node_tags[k:k + nb] = tags
        k += nb

    lines = sections["Elements"]
    header = lines[0].split()
    n_blocks = int(header[0])
    elems = []
    i = 1
    for _ in range(n_blocks):
        dim, ent, etype, nb = (int(x) for x in lines[i].split())
        i += 1
        if etype not in _GMSH_TYPES:
            i += nb
            continue
        name, nv, tdim = _GMSH_TYPES[etype]
        tags = np.empty(nb, dtype=np.int64)
        conn = np.empty((nb, nv), dtype=np.int64)
        for j in range(nb):
            parts = lines[i + j].split()
            tags[j] = int(parts[0])
            conn[j] = [int(x) for x in parts[1:1 + nv]]
        i += nb
        elems.append({
            "dim": tdim, "cell_type": name, "entity": ent,
            "tags": tags,
            "phys_arr": np.zeros(nb, dtype=np.int64),  # filled from entities
            "conn": conn,
        })
    return node_tags, coords, elems


def write_msh(filename, mesh, version="2.2", cell_tags=None,
              physical_names=None):
    """Write an ASCII gmsh file (v2.2 or v4.1) from a Mesh.

    cell_tags: optional (n_cells,) int physical tag per cell (default 1);
    physical_names: optional {tag: name}. v4.1 writes one geometric entity
    per physical tag and the elements in blocks of consecutive equal tags,
    so read_msh gives the cells back in their order."""
    coords = np.asarray(mesh.coords, dtype=np.float64)
    if coords.shape[1] < 3:
        coords = np.concatenate(
            [coords, np.zeros((len(coords), 3 - coords.shape[1]))], axis=1)
    conn = np.asarray(mesh.conn)
    etype = _TYPE_OF_CELL[mesh.cell_type]
    tags = (np.ones(mesh.n_cells, dtype=np.int64) if cell_tags is None
            else np.asarray(cell_tags, dtype=np.int64))
    out = []
    if str(version).startswith("2"):
        out += ["$MeshFormat", "2.2 0 8", "$EndMeshFormat"]
        if physical_names:
            out += ["$PhysicalNames", str(len(physical_names))]
            dim = 1 if mesh.cell_type == "interval" else 2
            for t, nm in sorted(physical_names.items()):
                out.append(f'{dim} {t} "{nm}"')
            out += ["$EndPhysicalNames"]
        out += ["$Nodes", str(mesh.n_nodes)]
        for i, p in enumerate(coords):
            out.append(f"{i + 1} {p[0]:.16g} {p[1]:.16g} {p[2]:.16g}")
        out += ["$EndNodes", "$Elements", str(mesh.n_cells)]
        for c in range(mesh.n_cells):
            nodes = " ".join(str(v + 1) for v in conn[c])
            out.append(f"{c + 1} {etype} 2 {tags[c]} {tags[c]} {nodes}")
        out += ["$EndElements"]
    else:
        dim = 1 if mesh.cell_type == "interval" else 2
        utags = np.unique(tags)
        out += ["$MeshFormat", "4.1 0 8", "$EndMeshFormat"]
        if physical_names:
            out += ["$PhysicalNames", str(len(physical_names))]
            for t, nm in sorted(physical_names.items()):
                out.append(f'{dim} {t} "{nm}"')
            out += ["$EndPhysicalNames"]
        # one geometric entity per physical tag, entity tag == physical tag
        lo, hi = coords.min(axis=0), coords.max(axis=0)
        bbox = (f"{lo[0]:.16g} {lo[1]:.16g} {lo[2]:.16g} "
                f"{hi[0]:.16g} {hi[1]:.16g} {hi[2]:.16g}")
        counts = [0, 0, 0, 0]
        counts[dim] = len(utags)
        out += ["$Entities", " ".join(str(c) for c in counts)]
        for t in utags:
            out.append(f"{t} {bbox} 1 {t} 0")
        out += ["$EndEntities"]
        out += ["$Nodes",
                f"1 {mesh.n_nodes} 1 {mesh.n_nodes}",
                f"{dim} {utags[0]} 0 {mesh.n_nodes}"]
        out += [str(i + 1) for i in range(mesh.n_nodes)]
        out += [f"{p[0]:.16g} {p[1]:.16g} {p[2]:.16g}" for p in coords]
        out += ["$EndNodes"]
        # blocks = runs of consecutive equal tags (preserves cell order;
        # per-tag grouping would permute cells on read-back)
        splits = np.where(np.diff(tags) != 0)[0] + 1
        starts = np.concatenate([[0], splits, [mesh.n_cells]])
        blocks = [(tags[starts[k]], np.arange(starts[k], starts[k + 1]))
                  for k in range(len(starts) - 1)]
        out += ["$Elements",
                f"{len(blocks)} {mesh.n_cells} 1 {mesh.n_cells}"]
        eid = 1
        for t, cells in blocks:
            out.append(f"{dim} {t} {etype} {len(cells)}")
            for c in cells:
                nodes = " ".join(str(v + 1) for v in conn[c])
                out.append(f"{eid} {nodes}")
                eid += 1
        out += ["$EndElements"]
    d = os.path.dirname(os.path.abspath(filename))
    os.makedirs(d, exist_ok=True)
    with open(filename, "w") as f:
        f.write("\n".join(out) + "\n")
