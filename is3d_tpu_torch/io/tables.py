"""Quadrature tables and momentum grids.

The reference loads fixed quadrature tables from ``tables/*.dat`` (reference:
src/cpp/Table.cpp, src/cpp/readindata.cpp:19-83):

* pT / phi Gauss-Legendre tables (value, weight) per row,
* y / eta trapezoid tables,
* a generalized Gauss-Laguerre file with blocks for alpha = 0..20.

Both are supported: loading reference-format files, and native generation of
the same quadratures (numpy/scipy host-side).  All grids end up as a
MomentumGrid of tensors; the Gauss-Laguerre rules of the feqmod thermal
moments as a {alpha: (nodes, weights)} dict of tensors (laguerre_device).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..tensors import TensorContainer


# ---------------------------------------------------------------- raw tables

def load_block_table(path: str) -> np.ndarray:
    """Load a whitespace-separated numeric block file as a 2D array.

    Equivalent of the reference's Table::loadTableFromFile (src/cpp/Table.cpp):
    tolerant of trailing blank lines, every row must have the same column count.
    """
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            rows.append([float(p) for p in parts])
    if not rows:
        return np.zeros((0, 0))
    ncol = len(rows[0])
    if any(len(r) != ncol for r in rows):
        raise ValueError(f"ragged table: {path}")
    return np.asarray(rows, dtype=np.float64)


def load_gauss_laguerre_file(
        path: str) -> dict[int, tuple[np.ndarray, np.ndarray]]:
    """Load the reference's multi-alpha generalized Gauss-Laguerre file.

    Format (reference: src/cpp/readindata.cpp:24-54): first line
    ``n_alpha  n_points``; then n_alpha blocks of n_points rows
    ``alpha_index  root  weight``.
    Returns {alpha: (roots, weights)}.
    """
    with open(path) as f:
        toks = f.read().split()
    n_alpha, n_points = int(toks[0]), int(toks[1])
    vals = np.asarray(toks[2:], dtype=np.float64).reshape(n_alpha, n_points, 3)
    return {a: (vals[a, :, 1], vals[a, :, 2]) for a in range(n_alpha)}


def gauss_laguerre(n_points: int, alphas=(0, 1, 2, 3)) -> dict[int, tuple[np.ndarray, np.ndarray]]:
    """Natively generate generalized Gauss-Laguerre roots/weights.

    Matches the reference's table file (weight function x^alpha e^-x).
    """
    from scipy.special import roots_genlaguerre

    out = {}
    for a in alphas:
        r, w = roots_genlaguerre(n_points, a)
        out[int(a)] = (np.asarray(r, dtype=np.float64), np.asarray(w, dtype=np.float64))
    return out


def gauss_legendre(n_points: int, a: float = -1.0, b: float = 1.0):
    """Gauss-Legendre nodes/weights on [a, b] (native generation)."""
    x, w = np.polynomial.legendre.leggauss(n_points)
    xm, xr = 0.5 * (b + a), 0.5 * (b - a)
    return xm + xr * x, xr * w


def laguerre_device(n_points: int = 32, alphas=(1, 2), dtype=torch.float64,
                    device="cpu") -> dict:
    """Gauss-Laguerre {alpha: (nodes, weights)} as tensors on ``device``,
    the one source of the rules for every kernel path that integrates
    thermal moments on the device (the feqmod spectra and dN/dX)."""
    raw = gauss_laguerre(n_points, alphas=tuple(alphas))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return {a: (t(r), t(w)) for a, (r, w) in raw.items()}


def laguerre_in_precision(laguerre, dtype, device=None) -> dict:
    """Cast (or build, if None) a ``laguerre_device()`` dict to the
    surface's dtype and device.  The thermal moments of the feqmod
    renormalization are computed in the surface's precision: an f64 table
    against f32 cells would promote every (cell, species, node) term, and
    the kernels take one dtype.  Every feqmod path casts through this one
    helper (kernels/feqmod.smooth_spectra_feqmod,
    kernels/dndx.spacetime_distributions)."""
    if laguerre is None:
        laguerre = laguerre_device(dtype=dtype,
                                   device="cpu" if device is None else device)
    return {a: (torch.as_tensor(r, dtype=dtype, device=device),
                torch.as_tensor(w, dtype=dtype, device=device))
            for a, (r, w) in laguerre.items()}


# ------------------------------------------------------------- momentum grid

@dataclass(frozen=True)
class MomentumGrid(TensorContainer):
    """Momentum-space grid for smooth Cooper-Frye spectra.

    In (2+1)D runs y is the single value 0 and eta carries the quadrature; in
    (3+1)D the y table carries the grid and eta is the single value 0 with
    weight 1 (reference: src/cpp/emissionfunction_smooth_kernels.cpp:58-92).
    """

    pT: torch.Tensor          # (n_pT,)
    pT_weight: torch.Tensor   # (n_pT,)
    phi: torch.Tensor         # (n_phi,)
    phi_weight: torch.Tensor  # (n_phi,)
    y: torch.Tensor           # (n_y,)
    y_weight: torch.Tensor    # (n_y,)
    eta: torch.Tensor         # (n_eta,)
    eta_weight: torch.Tensor  # (n_eta,)
    # 2+1D eta nodes are remapped per (cell, species, pT) as
    # eta -> y_flow(cell) + s(mT) * eta with s = sqrt(T_ref/max(mT, T_ref))
    # (exact substitution; jacobian in the kernel).  True for native grids;
    # False for reference table files (node-exact reference semantics).
    eta_mT_rescale: bool = False

    @property
    def n_pT(self):
        return self.pT.shape[0]

    @property
    def n_phi(self):
        return self.phi.shape[0]

    @property
    def n_y(self):
        return self.y.shape[0]

    @property
    def n_eta(self):
        return self.eta.shape[0]


def _vw(table: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(value, weight) columns; weight defaults to 1 if the file has one column."""
    v = table[:, 0]
    w = table[:, 1] if table.shape[1] > 1 else np.ones_like(v)
    return v, w


def momentum_grid_from_tables(pT_tab, phi_tab, y_tab, eta_tab, dimension: int,
                              dtype=torch.float64, device="cpu",
                              eta_mT_rescale: bool = False) -> MomentumGrid:
    """Build the kernel grid from 4 (value, weight) tables, applying the
    reference's dimension rules (y = {0} in 2+1D; eta = {0}, w = 1 in 3+1D)."""
    pT, pTw = _vw(np.asarray(pT_tab))
    phi, phiw = _vw(np.asarray(phi_tab))
    yv, yw = _vw(np.asarray(y_tab))
    etav, etaw = _vw(np.asarray(eta_tab))

    if dimension == 2:
        yv, yw = np.array([0.0]), np.array([1.0])
    elif dimension == 3:
        etav, etaw = np.array([0.0]), np.array([1.0])
    else:
        raise ValueError(f"dimension must be 2 or 3, got {dimension}")

    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return MomentumGrid(
        pT=t(pT), pT_weight=t(pTw), phi=t(phi), phi_weight=t(phiw),
        y=t(yv), y_weight=t(yw), eta=t(etav), eta_weight=t(etaw),
        eta_mT_rescale=bool(eta_mT_rescale))


def load_momentum_grid(tables_dir: str, dimension: int, operation: int,
                       dtype=torch.float64, device="cpu") -> MomentumGrid:
    """Load the exact default tables the reference uses
    (reference: src/cpp/iS3D.cpp:161-167)."""
    pT_tab = load_block_table(f"{tables_dir}/pT_gauss_legendre_table.dat")
    phi_tab = load_block_table(f"{tables_dir}/phi_gauss_legendre_table.dat")
    y_tab = load_block_table(f"{tables_dir}/y_trapezoid_table_21pt.dat")
    eta_name = ("eta/eta_trapezoid_table_41pt.dat" if operation == 2
                else "eta/eta_trapezoid_table_241pt.dat")
    eta_tab = load_block_table(f"{tables_dir}/{eta_name}")
    return momentum_grid_from_tables(pT_tab, phi_tab, y_tab, eta_tab,
                                     dimension, dtype=dtype, device=device)


def native_momentum_grid(dimension: int,
                         n_pT: int = 32, pT_max: float = 4.0,
                         n_phi: int = 24,
                         n_y: int = 21, y_max: float = 5.0,
                         n_eta: int = 48, eta_max: float = 7.0,
                         dtype=torch.float64, device="cpu",
                         eta_mT_rescale: bool | None = None) -> MomentumGrid:
    """Generate a self-contained grid (no table files needed): Gauss-Legendre
    in pT on [0, pT_max] and phi on [0, 2pi]; trapezoid y; Gauss-Legendre eta.

    2+1D native grids default to the mT-adaptive eta-node remap (see
    MomentumGrid.eta_mT_rescale) so the spectra are quadrature-converged
    out to the pT grid edge; pass eta_mT_rescale=False for fixed-node
    (reference-table-like) semantics."""
    pT, pTw = gauss_legendre(n_pT, 0.0, pT_max)
    phi, phiw = gauss_legendre(n_phi, 0.0, 2.0 * np.pi)
    yv = np.linspace(-y_max, y_max, n_y)
    yw = np.full(n_y, yv[1] - yv[0]) if n_y > 1 else np.ones(1)
    if n_y > 1:
        yw[0] *= 0.5
        yw[-1] *= 0.5
    etav, etaw = gauss_legendre(n_eta, -eta_max, eta_max)
    if eta_mT_rescale is None:
        eta_mT_rescale = dimension == 2
    return momentum_grid_from_tables(
        np.stack([pT, pTw], 1), np.stack([phi, phiw], 1),
        np.stack([yv, yw], 1), np.stack([etav, etaw], 1),
        dimension, dtype=dtype, device=device,
        eta_mT_rescale=bool(eta_mT_rescale))
