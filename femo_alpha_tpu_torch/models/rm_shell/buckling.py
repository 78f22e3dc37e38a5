"""Closed-form panel-buckling critical stresses for bay-wise wing design
(port of femo_alpha_tpu/models/rm_shell/buckling.py).

The reference's most advanced workload (lpc gust-response optimization)
constrains per-bay skin buckling with classical handbook formulas evaluated
on rectangular bay approximations between ribs and spars:
`examples/advanced_examples/lpc_gust_response_opt/utils.py:398-434`
(`compute_buckling_loads`: flat-plate compression + shear with
aspect-ratio k lookups) and `:435-468` (`compute_curved_buckling_loads`:
axially compressed curved panel). The geometry side there is CADDEE
(parametric surface evaluation — out of rebuild scope, SURVEY.md §2.2);
this module keeps the structural content as plain functions of the
thickness design variable, differentiable by autograd when t, E or nu are
tensors, so buckling margins drop straight into `OptimizationProblem`
constraints with exact gradients.

Formulas (simply supported panels, classical plate buckling):
  sigma_cr = k_c * E / (1 - nu^2) * (t/b)^2
  tau_cr   = k_s * E / (1 - nu^2) * (t/b)^2
  curved:  sigma_cr = (E / (6 (1-nu^2))) * ( sqrt(12 (1-nu^2) (t/r)^2
                          + (pi t / b)^4) + (pi t / b)^2 )
with k looked up from the same aspect-ratio tables the reference embeds.
k depends only on bay GEOMETRY (static at setup), so the lookup is plain
Python/numpy; t, E, nu may be floats or tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# handbook k tables (simply supported flat plates), keyed by aspect ratio
# a/b — identical data to the reference's compression_k_lookup /
# shear_k_lookup (lpc utils.py:399-404).
COMPRESSION_K = {
    0.2: 22.2, 0.3: 10.9, 0.4: 6.92, 0.6: 4.23, 0.8: 3.45,
    1.0: 3.29, 1.2: 3.40, 1.4: 3.68, 1.6: 3.45, 1.8: 3.32,
    2.0: 3.29, 2.2: 3.32, 2.4: 3.40, 2.7: 3.32, 3.0: 3.29,
}
SHEAR_K = {
    1.0: 7.75, 1.2: 6.58, 1.4: 6.00, 1.5: 5.84, 1.6: 5.76,
    1.8: 5.59, 2.0: 5.43, 2.5: 5.18, 3.0: 5.02,
}


def _nearest_key(table, x):
    return table[min(table, key=lambda k: abs(k - x))]


def compression_k(aspect_ratio):
    """Nearest-key compression buckling coefficient (lpc utils.py:426)."""
    return _nearest_key(COMPRESSION_K, float(aspect_ratio))


def shear_k(aspect_ratio):
    """Nearest-key shear buckling coefficient; the table is symmetric in
    a<->b so ratios < 1 are inverted first (lpc utils.py:427-429)."""
    ar = float(aspect_ratio)
    if ar < 1.0:
        ar = 1.0 / ar
    return _nearest_key(SHEAR_K, ar)


def bay_dimensions(corners):
    """(a, b, aspect_ratio) of the rectangular bay approximation.

    corners: (4, gdim) array ordered [lower_0, lower_1, upper_0, upper_1]
    (lower/upper = the two bounding rib stations, 0/1 = the two spar-side
    points), exactly the reference's corner_points contract
    (lpc utils.py:416-424): b spans the rib direction (0-1, 2-3 averaged),
    a spans the spar direction (0-2, 1-3 averaged).
    """
    c = np.asarray(corners, dtype=np.float64)
    b = 0.5 * (np.linalg.norm(c[0] - c[1]) + np.linalg.norm(c[2] - c[3]))
    a = 0.5 * (np.linalg.norm(c[0] - c[2]) + np.linalg.norm(c[1] - c[3]))
    return a, b, a / b


def flat_plate_sigma_cr(E, nu, t, b, aspect_ratio):
    """Critical compressive stress k_c*E/(1-nu^2)*(t/b)^2 — differentiable
    in t/E/nu; k_c static from geometry (lpc utils.py:431)."""
    k = compression_k(aspect_ratio)
    return k * E / (1.0 - nu**2) * (t / b) ** 2


def flat_plate_tau_cr(E, nu, t, b, aspect_ratio):
    """Critical shear stress k_s*E/(1-nu^2)*(t/b)^2 (lpc utils.py:432)."""
    k = shear_k(aspect_ratio)
    return k * E / (1.0 - nu**2) * (t / b) ** 2


def curved_panel_sigma_cr(E, nu, t, b, r):
    """Axially compressed curved-panel critical stress
    (lpc utils.py:467-468): combines the cylinder term (t/r) with the
    flat-plate term (pi t/b)^2. Differentiable in t/E/nu."""
    tb = math.pi * t / b
    s = 12.0 * (1.0 - nu**2) * (t / r) ** 2 + tb**4
    root = torch.sqrt(s) if isinstance(s, torch.Tensor) else math.sqrt(s)
    return (E / (6.0 * (1.0 - nu**2))) * (root + tb**2)


def bay_buckling_margins(sigma_applied, tau_applied, E, nu, t, corners,
                         knockdown=1.0):
    """Combined-load buckling margin for one bay.

    Interaction criterion R_c + R_s^2 <= 1 (classical compression+shear
    interaction for flat panels): returns
      margin = 1 - (sigma/sigma_cr + (tau/tau_cr)^2) * 1/knockdown
    Positive margin = no buckling. All stress/thickness args may be
    tensors; `corners` is static geometry.
    """
    a, b, ar = bay_dimensions(corners)
    s_cr = flat_plate_sigma_cr(E, nu, t, b, ar)
    t_cr = flat_plate_tau_cr(E, nu, t, b, ar)
    Rc = sigma_applied / s_cr
    Rs = tau_applied / t_cr
    return 1.0 - (Rc + Rs**2) / knockdown
