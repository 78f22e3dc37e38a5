"""What the ported example studies share: the repo's mesh files, the
command line, the 1-cos gust, the bay-wise thickness layout of the wing
studies and an SLSQP run that keeps every iterate."""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def data_path(name):
    """A mesh file under the repo's tests/data/."""
    return os.path.join(REPO, "tests", "data", name)


def parse_args(argv, doc, **constants):
    """The study constants as options (`--name value`, the script's value
    by default) and `--device` (the CUDA card unless given)."""
    p = argparse.ArgumentParser(description=(doc or "").split("\n\n")[0])
    for name, default in constants.items():
        p.add_argument(f"--{name}", type=type(default), default=default)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def f64(device):
    """Tensor keywords for f64 on `device` (None: the CUDA card)."""
    return dict(dtype=torch.float64, device=resolve_device(device))


def one_minus_cos(Nsteps, dt, ramp):
    """0.5 (1 - cos(2 pi clip(t / ramp, 0, 1))) at t = 0, dt, ...,
    Nsteps dt."""
    t_axis = np.arange(Nsteps + 1) * dt
    return 0.5 * (1 - np.cos(2 * np.pi * np.clip(t_axis / ramp, 0, 1)))


def bay_layout(mesh, span, n_span, rib_stations, rib_tag):
    """Skin cells grouped by the spanwise bay between rib stations, rib
    cells in one group: (P (nel, n_bays + 1) with P[c, group(c)] = 1,
    cell_bay (nel,), is_rib (nel,), bay_edges (n_bays + 1,))."""
    nel = mesh.n_cells
    bay_edges = np.array([0.0] + [span * j / n_span for j in rib_stations]
                         + [span * 1.001])
    cell_y = np.asarray(mesh.coords)[np.asarray(mesh.conn)].mean(axis=1)[:, 1]
    cell_bay = np.searchsorted(bay_edges, cell_y, side="right") - 1
    n_bays = len(bay_edges) - 1
    is_rib = np.zeros(nel, dtype=bool)
    rib_cells = mesh.cell_tags.get(rib_tag)
    if rib_cells is not None:
        is_rib[np.asarray(rib_cells)] = True
    P = np.zeros((nel, n_bays + 1))
    for c in range(nel):
        P[c, n_bays if is_rib[c] else int(cell_bay[c])] = 1.0
    return P, cell_bay, is_rib, bay_edges


def solve_recorded(prob, maxiter, ftol):
    """prob.solve with every SLSQP iterate kept: (dvs, res, record) with
    record = {history: the scaled objective at each iterate, designs: each
    iterate's x, counts: [nit, nfev, njev], fun}."""
    designs = []
    dvs, res = prob.solve(maxiter=maxiter, ftol=ftol,
                          callback=lambda xk: designs.append(np.array(xk)))
    record = {"history": np.asarray(prob.history, dtype=np.float64),
              "designs": np.asarray(designs, dtype=np.float64),
              "counts": np.asarray([res.nit, res.nfev, res.njev]),
              "fun": float(res.fun)}
    return dvs, res, record


def numpy_of(t):
    return t.detach().cpu().numpy()
