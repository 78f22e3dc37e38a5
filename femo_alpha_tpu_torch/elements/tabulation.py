"""ElementTables: an element tabulated at a quadrature rule.

The tables are plain numpy arrays computed at setup time; kernels close over
them as static constants (XLA bakes them in). This replaces the FFCx-generated
C tabulation kernels of the reference (SURVEY.md §2.2).
"""

from __future__ import annotations

import numpy as np

from .lagrange import RefElement, make_element
from .quadrature import quadrature_rule

_ELEMENT_CACHE: dict = {}


def reference_element(family: str, cell_type: str, degree: int) -> RefElement:
    key = (family, cell_type, degree)
    if key not in _ELEMENT_CACHE:
        _ELEMENT_CACHE[key] = make_element(family, cell_type, degree)
    return _ELEMENT_CACHE[key]


class ElementTables:
    """Basis tables of one element at one quadrature rule.

    Attributes (numpy, static):
      points  (nq, rdim)   quadrature points on the reference cell
      weights (nq,)        quadrature weights
      phi     (nq, nd)     basis values
      dphi    (nq, nd, rdim) basis reference gradients
      d2phi   (nq, nd, rdim, rdim) optional reference Hessians
      geom_phi / geom_dphi tables of the geometry (P1/Q1) element at the same
                           points, for computing the cell Jacobian
    """

    def __init__(self, element: RefElement, points, weights, with_hessian=False):
        self.element = element
        self.points = np.asarray(points, dtype=np.float64)
        self.weights = np.asarray(weights, dtype=np.float64)
        self.nq = len(self.weights)
        self.nd = element.ndof
        self.rdim = element.rdim
        self.phi = element.tabulate(self.points, 0)
        self.dphi = element.tabulate(self.points, 1)
        self.d2phi = element.tabulate(self.points, 2) if with_hessian else None
        geom = reference_element("P", element.cell_type, 1)
        self.geom_nd = geom.ndof
        self.geom_phi = geom.tabulate(self.points, 0)
        self.geom_dphi = geom.tabulate(self.points, 1)

    def astype(self, dtype):
        """Shallow copy with all tables cast to `dtype` (numpy). Under
        jax_enable_x64, f64 tables silently promote f32 tracers to f64 in
        every kernel op; casting the static tables is what makes a genuinely
        single-precision compute path possible on TPU."""
        import copy

        t = copy.copy(self)
        for name in ("points", "weights", "phi", "dphi", "d2phi",
                     "geom_phi", "geom_dphi"):
            v = getattr(self, name)
            if v is not None:
                setattr(t, name, np.asarray(v, dtype=dtype))
        return t


def tabulate(
    family: str,
    cell_type: str,
    degree: int,
    quad_degree: int | None = None,
    with_hessian: bool = False,
    points=None,
    weights=None,
) -> ElementTables:
    """Tabulate an element at a Gauss rule of the given degree (default:
    2*degree, matching the reference's default form degree estimation), or at
    explicit (points, weights)."""
    elem = reference_element(family, cell_type, degree)
    if points is None:
        if quad_degree is None:
            quad_degree = max(1, 2 * degree)
        points, weights = quadrature_rule(cell_type, quad_degree)
    return ElementTables(elem, points, weights, with_hessian=with_hessian)
