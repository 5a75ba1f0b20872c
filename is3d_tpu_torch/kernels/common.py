"""Shared cell-side preparation for the Cooper-Frye kernels.

Everything here is plain torch over (C,) cell tensors on the surface's
device: velocity completion, shear-stress closure, diffusion completion,
delta-f coefficient evaluation, and the padding helper of the cell
reduction.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..io.surface import Surface
from ..io.deltaf import DeltafData, evaluate_df_coefficients
from ..physics import lrf


def fermi_bose(x, s):
    """f = 1 / (e^x + s), the Fermi/Bose/Boltzmann occupation (s = +1/-1/0).
    exp overflow gives 1/(inf + s) = 0 exactly."""
    return 1.0 / (torch.exp(x) + s)


def surface_columns(surface: Surface, cfg) -> dict:
    """Extract the cell columns a VH kernel needs, zero-filling switched-off
    viscous blocks exactly like the reference's SoA unpack
    (emissionfunction.cpp:1420-1499 + kernel-side zero defaults)."""
    z = torch.zeros_like(surface.tau)
    get = lambda name: getattr(surface, name)
    cols = {k: get(k) for k in ("tau", "dat", "dax", "day", "dan",
                                "ux", "uy", "un", "T")}
    cols["eta"] = get("eta") if surface.eta is not None else z
    cols["E"] = get("E") if surface.E is not None else z
    cols["P"] = get("P") if surface.P is not None else z
    for name in ("pixx", "pixy", "pixn", "piyy", "piyn"):
        v = get(name)
        cols[name] = v if (cfg.include_shear_deltaf and v is not None) else z
    v = surface.bulkPi
    cols["bulkPi"] = v if (cfg.include_bulk_deltaf and v is not None) else z
    use_bdiff = cfg.include_baryon and cfg.include_baryondiff_deltaf
    cols["muB"] = surface.muB if (cfg.include_baryon and surface.muB is not None) else z
    for name in ("nB", "Vx", "Vy", "Vn"):
        v = get(name)
        cols[name] = v if (use_bdiff and v is not None) else z
    return cols


def prepare_cells(cols: dict, cfg, df_data: Optional[DeltafData]) -> dict:
    """Complete the hydro fields per cell.

    Adds: ut, udsigma, valid mask (u.dsigma > 0, reference
    emissionfunction_smooth_kernels.cpp:137), the reconstructed pi^munu
    closure, V^tau, alphaB, nB/(E+P), and the delta-f coefficient bundle.
    """
    c = dict(cols)
    tau, ux, uy, un = c["tau"], c["ux"], c["uy"], c["un"]
    ut = lrf.u_tau(ux, uy, un, tau)
    c["ut"] = ut
    udsigma = ut * c["dat"] + ux * c["dax"] + uy * c["day"] + un * c["dan"]
    c["udsigma"] = udsigma
    c["valid"] = udsigma > 0.0

    zl = torch.zeros_like(tau)
    if cfg.include_shear_deltaf:
        (c["pitt"], c["pitx"], c["pity"], c["pitn"],
         c["pinn"]) = lrf.reconstruct_pimunu(
            c["pixx"], c["pixy"], c["pixn"], c["piyy"], c["piyn"],
            ut, ux, uy, un, tau)
    else:
        c["pitt"] = c["pitx"] = c["pity"] = c["pitn"] = c["pinn"] = zl

    use_bdiff = cfg.include_baryon and cfg.include_baryondiff_deltaf
    if use_bdiff:
        c["Vt"] = lrf.complete_Vmu(c["Vx"], c["Vy"], c["Vn"], ut, ux, uy, un, tau)
        c["baryon_enthalpy_ratio"] = c["nB"] / (c["E"] + c["P"])
        c["alphaB"] = c["muB"] / c["T"]
    else:
        c["Vt"] = zl
        c["baryon_enthalpy_ratio"] = zl
        c["alphaB"] = (c["muB"] / c["T"]) if cfg.include_baryon else zl

    if df_data is not None:
        c["df"] = evaluate_df_coefficients(
            df_data, cfg.df_mode, bool(cfg.include_baryon),
            c["T"], c["muB"], c["E"], c["P"], c["bulkPi"])
    return c


# columns that must pad with a physical (non-zero) value so kernels stay
# finite on inert pad cells (they appear in denominators / sqrt arguments);
# everything else pads with 0, and dsigma = 0 makes a pad cell's
# contribution exactly zero via the u.dsigma > 0 validity mask.
PAD_ONE_COLUMNS = ("tau", "T", "E", "P")


# element budget of one chunk of the plain (torch) spectra path's
# (chunk x rapidity x species x momentum) block: each of its ~30 live
# temporaries holds this many elements
CHUNK_ELEMENT_BUDGET = 1 << 22


def effective_chunk(requested: int, n_cells: int, per_cell_elems: int) -> int:
    """Bound the cell chunk so the (chunk x species x momentum) elementwise
    block stays within CHUNK_ELEMENT_BUDGET."""
    return max(1, min(requested, max(n_cells, 1),
                      max(1, CHUNK_ELEMENT_BUDGET // max(per_cell_elems, 1))))


def pad_and_chunk(cols: dict, chunk: int) -> tuple[dict, torch.Tensor, int]:
    """Pad cell columns to a multiple of ``chunk`` and reshape to
    (n_chunks, chunk).  Returns (chunked columns, valid mask, n_chunks).

    Padding uses benign values (T = 1 to avoid division by zero); callers
    fold the mask into the dsigma columns so pad cells contribute exactly
    zero -- the analog of the reference's FO_chunk remainder handling
    (emissionfunction_smooth_kernels.cpp:102-105).
    """
    n = cols["tau"].shape[0]
    n_chunks = max(1, math.ceil(n / chunk))
    padded = n_chunks * chunk
    pad = padded - n
    mask = torch.arange(padded, device=cols["tau"].device) < n

    out = {}
    for k, v in cols.items():
        if pad:
            fill = 1.0 if k in PAD_ONE_COLUMNS else 0.0
            v = torch.cat([v, v.new_full((pad,), fill)])
        out[k] = v.reshape(n_chunks, chunk)
    return out, mask.reshape(n_chunks, chunk), n_chunks
