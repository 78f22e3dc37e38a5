"""Analytic basis tabulation for Lagrange / DG / Crouzeix-Raviart elements.

Local node ordering conventions (must match mesh topology in
femo_alpha_tpu.mesh and dofmap construction in femo_alpha_tpu.spaces):

interval: vertices 0:(0), 1:(1)
triangle: vertices 0:(0,0), 1:(1,0), 2:(0,1); edges (0,1),(1,2),(2,0)
quad    : vertices 0:(0,0), 1:(1,0), 2:(1,1), 3:(0,1) CCW;
          edges (0,1),(1,2),(2,3),(3,0)

P2 triangle: 3 vertex dofs + 1 midpoint dof per edge (nodes 3,4,5 on edges
(0,1),(1,2),(2,0)). Q2 quad: 4 vertex + 4 edge-midpoint + 1 center dof.
Edge-midpoint dofs are orientation independent, so no dof transforms are
needed (the reference delegates this to basix; SURVEY.md §2.2).
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------- 1D pieces
def _lin1d(x, order):
    if order == 0:
        return np.stack([1.0 - x, x], axis=-1)
    if order == 1:
        return np.stack([-np.ones_like(x), np.ones_like(x)], axis=-1)
    return np.zeros(x.shape + (2,))


def _quad1d(x, order):
    # nodes at 0, 1, 1/2 (vertex, vertex, midpoint)
    if order == 0:
        return np.stack(
            [2 * x * x - 3 * x + 1, x * (2 * x - 1), 4 * x * (1 - x)], axis=-1
        )
    if order == 1:
        return np.stack([4 * x - 3, 4 * x - 1, 4 - 8 * x], axis=-1)
    if order == 2:
        o = np.ones_like(x)
        return np.stack([4 * o, 4 * o, -8 * o], axis=-1)
    return np.zeros(x.shape + (3,))


# ----------------------------------------------------------- element defs
class RefElement:
    """A reference element: tabulation + entity-dof layout.

    entity_dofs = (ndof_per_vertex, ndof_per_edge, ndof_per_cell); continuous
    spaces share vertex/edge dofs across cells, DG spaces put everything on
    the cell.
    """

    def __init__(self, name, cell_type, ndof, entity_dofs, node_coords, evaler,
                 continuous=True):
        self.name = name
        self.cell_type = cell_type
        self.ndof = ndof
        self.entity_dofs = entity_dofs
        self.node_coords = np.asarray(node_coords, dtype=np.float64)
        self._evaler = evaler
        self.continuous = continuous
        self.rdim = {"interval": 1, "triangle": 2, "quad": 2}[cell_type]

    def tabulate(self, points, order=0):
        """Return basis derivative table of given order at `points` (nq, rdim).

        order 0 -> (nq, ndof); order 1 -> (nq, ndof, rdim);
        order 2 -> (nq, ndof, rdim, rdim).
        """
        points = np.asarray(points, dtype=np.float64)
        if points.ndim == 1:
            points = points.reshape(-1, 1)
        return self._evaler(points, order)


# interval P1
def _p1_interval(pts, order):
    x = pts[:, 0]
    t = _lin1d(x, order)
    if order == 0:
        return t
    if order == 1:
        return t[:, :, None]
    return np.zeros((len(x), 2, 1, 1))


# interval Hermite cubic (value, slope per vertex): dofs [u0, u0', u1, u1']
def _hermite_interval(pts, order):
    x = pts[:, 0]
    if order == 0:
        tab = np.stack(
            [
                1 - 3 * x**2 + 2 * x**3,
                x - 2 * x**2 + x**3,
                3 * x**2 - 2 * x**3,
                -(x**2) + x**3,
            ],
            axis=-1,
        )
        return tab
    if order == 1:
        tab = np.stack(
            [
                -6 * x + 6 * x**2,
                1 - 4 * x + 3 * x**2,
                6 * x - 6 * x**2,
                -2 * x + 3 * x**2,
            ],
            axis=-1,
        )
        return tab[:, :, None]
    if order == 2:
        tab = np.stack(
            [-6 + 12 * x, -4 + 6 * x, 6 - 12 * x, -2 + 6 * x], axis=-1
        )
        return tab[:, :, None, None]
    raise ValueError(order)


# triangle barycentric helpers
def _tri_L(pts):
    x, y = pts[:, 0], pts[:, 1]
    L = np.stack([1 - x - y, x, y], axis=-1)  # (nq, 3)
    dL = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])  # (3, 2)
    return L, dL


def _p1_triangle(pts, order):
    L, dL = _tri_L(pts)
    if order == 0:
        return L
    if order == 1:
        return np.broadcast_to(dL, (len(pts), 3, 2)).copy()
    return np.zeros((len(pts), 3, 2, 2))


def _p2_triangle(pts, order):
    L, dL = _tri_L(pts)
    nq = len(pts)
    edges = [(0, 1), (1, 2), (2, 0)]
    if order == 0:
        vert = L * (2 * L - 1)
        edge = np.stack([4 * L[:, i] * L[:, j] for i, j in edges], axis=-1)
        return np.concatenate([vert, edge], axis=-1)
    if order == 1:
        dvert = (4 * L - 1)[:, :, None] * dL[None, :, :]
        dedge = np.stack(
            [
                4 * (L[:, j, None] * dL[None, i] + L[:, i, None] * dL[None, j])
                for i, j in edges
            ],
            axis=1,
        )
        return np.concatenate([dvert, dedge], axis=1)
    if order == 2:
        d2vert = 4 * dL[:, :, None] * dL[:, None, :]  # (3,2,2)
        d2vert = np.broadcast_to(d2vert, (nq, 3, 2, 2))
        d2edge = np.stack(
            [
                4 * (dL[i][:, None] * dL[j][None, :] + dL[j][:, None] * dL[i][None, :])
                for i, j in edges
            ],
            axis=0,
        )
        d2edge = np.broadcast_to(d2edge, (nq, 3, 2, 2))
        return np.concatenate([d2vert, d2edge], axis=1)
    raise ValueError(order)


def _cr1_triangle(pts, order):
    # Crouzeix-Raviart: dofs at edge midpoints; phi_e = 1 - 2*L_opposite
    # edge (0,1) opposite vertex 2, edge (1,2) opposite 0, edge (2,0) opposite 1
    L, dL = _tri_L(pts)
    opp = [2, 0, 1]
    if order == 0:
        return np.stack([1 - 2 * L[:, o] for o in opp], axis=-1)
    if order == 1:
        return np.broadcast_to(
            np.stack([-2 * dL[o] for o in opp], axis=0), (len(pts), 3, 2)
        ).copy()
    return np.zeros((len(pts), 3, 2, 2))


# quad tensor-product elements
def _q_tensor(pts, order, f1d, idx_pairs):
    x, y = pts[:, 0], pts[:, 1]
    fx0, fy0 = f1d(x, 0), f1d(y, 0)
    if order == 0:
        return np.stack([fx0[:, i] * fy0[:, j] for i, j in idx_pairs], axis=-1)
    fx1, fy1 = f1d(x, 1), f1d(y, 1)
    if order == 1:
        gx = np.stack([fx1[:, i] * fy0[:, j] for i, j in idx_pairs], axis=-1)
        gy = np.stack([fx0[:, i] * fy1[:, j] for i, j in idx_pairs], axis=-1)
        return np.stack([gx, gy], axis=-1)
    if order == 2:
        fx2, fy2 = f1d(x, 2), f1d(y, 2)
        hxx = np.stack([fx2[:, i] * fy0[:, j] for i, j in idx_pairs], axis=-1)
        hxy = np.stack([fx1[:, i] * fy1[:, j] for i, j in idx_pairs], axis=-1)
        hyy = np.stack([fx0[:, i] * fy2[:, j] for i, j in idx_pairs], axis=-1)
        h = np.empty(hxx.shape + (2, 2))
        h[..., 0, 0] = hxx
        h[..., 0, 1] = hxy
        h[..., 1, 0] = hxy
        h[..., 1, 1] = hyy
        return h
    raise ValueError(order)


# Q1 vertices CCW: (0,0),(1,0),(1,1),(0,1) -> 1D indices (i for x, j for y)
_Q1_PAIRS = [(0, 0), (1, 0), (1, 1), (0, 1)]
# Q2: vertices, then edge mids on edges (0,1),(1,2),(2,3),(3,0), then center.
# 1D index 2 = midpoint node of _quad1d.
_Q2_PAIRS = _Q1_PAIRS + [(2, 0), (1, 2), (2, 1), (0, 2)] + [(2, 2)]


def _q1_quad(pts, order):
    return _q_tensor(pts, order, _lin1d, _Q1_PAIRS)


def _q2_quad(pts, order):
    return _q_tensor(pts, order, _quad1d, _Q2_PAIRS)


_NODE_1D = {0: 0.0, 1: 1.0, 2: 0.5}


def _pairs_coords(pairs):
    return [[_NODE_1D[i], _NODE_1D[j]] for i, j in pairs]


def make_element(family: str, cell_type: str, degree: int) -> RefElement:
    """Factory. family in {'P'/'CG', 'DG', 'Hermite', 'CR'}.

    'P'/'CG' on quads means the tensor-product Q family.
    """
    fam = {"CG": "P", "Lagrange": "P", "Q": "P"}.get(family, family)
    key = (fam, cell_type, degree)

    if key == ("P", "interval", 1):
        return RefElement("P1", "interval", 2, (1, 0, 0), [[0.0], [1.0]], _p1_interval)
    if key == ("Hermite", "interval", 3):
        return RefElement(
            "Hermite3", "interval", 4, (2, 0, 0), [[0.0], [0.0], [1.0], [1.0]],
            _hermite_interval,
        )
    if key == ("P", "triangle", 1):
        return RefElement(
            "P1", "triangle", 3, (1, 0, 0), [[0, 0], [1, 0], [0, 1]], _p1_triangle
        )
    if key == ("P", "triangle", 2):
        coords = [[0, 0], [1, 0], [0, 1], [0.5, 0], [0.5, 0.5], [0, 0.5]]
        return RefElement("P2", "triangle", 6, (1, 1, 0), coords, _p2_triangle)
    if key == ("CR", "triangle", 1):
        return RefElement(
            "CR1", "triangle", 3, (0, 1, 0), [[0.5, 0], [0.5, 0.5], [0, 0.5]],
            _cr1_triangle,
        )
    if key == ("P", "quad", 1):
        return RefElement(
            "Q1", "quad", 4, (1, 0, 0), _pairs_coords(_Q1_PAIRS), _q1_quad
        )
    if key == ("P", "quad", 2):
        return RefElement(
            "Q2", "quad", 9, (1, 1, 1), _pairs_coords(_Q2_PAIRS), _q2_quad
        )
    if fam == "DG" and degree == 0:
        centroid = {
            "interval": [[0.5]],
            "triangle": [[1 / 3, 1 / 3]],
            "quad": [[0.5, 0.5]],
        }[cell_type]

        def _dg0(pts, order):
            if order == 0:
                return np.ones((len(pts), 1))
            rdim = pts.shape[1]
            return np.zeros((len(pts), 1) + (rdim,) * order)

        return RefElement("DG0", cell_type, 1, (0, 0, 1), centroid, _dg0,
                          continuous=False)
    if fam == "DG" and degree == 1:
        base = make_element("P", cell_type, 1)
        return RefElement(
            "DG1", cell_type, base.ndof, (0, 0, base.ndof), base.node_coords,
            base._evaler, continuous=False,
        )
    raise ValueError(f"unsupported element {family} {cell_type} degree {degree}")
