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


class _FermiBose(torch.autograd.Function):
    """1 / (e^x + s) with the JAX package's derivative (custom_jvp,
    is3d_tpu/kernels/common.py:27-51): df/dx = -f (1 - s f), df/ds = -f^2,
    exact zeros where e^x overflows (autograd's -e^x / (e^x + s)^2 is
    inf / inf = NaN there)."""

    @staticmethod
    def forward(ctx, x, s):
        f = 1.0 / (torch.exp(x) + s)
        ctx.save_for_backward(f, _as_tensor(s, f))
        ctx.x_shape = x.shape
        return f

    @staticmethod
    def backward(ctx, g):
        f, s = ctx.saved_tensors
        gx = gs = None
        if ctx.needs_input_grad[0]:
            gx = _sum_to(-g * f * (1.0 - s * f), ctx.x_shape)
        if ctx.needs_input_grad[1]:
            gs = _sum_to(-g * f * f, s.shape)
        return gx, gs


class _ScaledFermiBose(torch.autograd.Function):
    """a / (e^x + s) with the JAX package's derivative (custom_jvp,
    is3d_tpu/kernels/common.py:54-72): with g = 1 / (e^x + s), df/da = g,
    df/dx = -a g (1 - s g), df/ds = -a g^2, exact zeros where e^x
    overflows."""

    @staticmethod
    def forward(ctx, a, x, s):
        ex = torch.exp(x)
        ctx.save_for_backward(_as_tensor(a, ex), ex, _as_tensor(s, ex))
        return a / (ex + s)

    @staticmethod
    def backward(ctx, grad):
        a, ex, s = ctx.saved_tensors
        g = 1.0 / (ex + s)
        ga = gx = gs = None
        if ctx.needs_input_grad[0]:
            ga = _sum_to(grad * g, a.shape)
        if ctx.needs_input_grad[1]:
            gx = _sum_to(-grad * a * g * (1.0 - s * g), ex.shape)
        if ctx.needs_input_grad[2]:
            gs = _sum_to(-grad * a * g * g, s.shape)
        return ga, gx, gs


def _as_tensor(v, like: torch.Tensor) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        v, dtype=like.dtype, device=like.device)


def _sum_to(t: torch.Tensor, shape) -> torch.Tensor:
    """Reduce a broadcast gradient to an input's shape."""
    shape = tuple(shape)
    if tuple(t.shape) == shape:
        return t
    lead = t.dim() - len(shape)
    t = t.sum(tuple(range(lead))) if lead else t
    dims = tuple(i for i, n in enumerate(shape) if n == 1 and t.shape[i] != 1)
    return t.sum(dims, keepdim=True) if dims else t


def _tracked(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in ts)


def fermi_bose(x, s):
    """f = 1 / (e^x + s), the Fermi/Bose/Boltzmann occupation (s = +1/-1/0).
    exp overflow gives 1/(inf + s) = 0 exactly.  Under autograd the
    derivative is the JAX package's (_FermiBose); the forward expression is
    the same either way."""
    if _tracked(x, s):
        return _FermiBose.apply(x, s)
    return 1.0 / (torch.exp(x) + s)


def scaled_fermi_bose(a, x, s):
    """f = a / (e^x + s): the occupation with a folded-in scale (the feqmod
    kernel's renormalized f_mod), one division as in the JAX package; under
    autograd with its derivative (_ScaledFermiBose)."""
    if _tracked(a, x, s):
        return _ScaledFermiBose.apply(a, x, s)
    return a / (torch.exp(x) + s)


def required_fields(cfg) -> list:
    """The surface columns a VH run of ``cfg`` reads (is3d_tpu's
    kernels/common.required_fields): the geometry, flow and temperature,
    eta in 3+1D, the switched-on viscous and baryon blocks, and E and P
    where the df mode's coefficients need them."""
    req = ["tau", "dat", "dax", "day", "dan", "ux", "uy", "un", "T"]
    if cfg.dimension == 3:
        req.append("eta")
    if cfg.include_shear_deltaf:
        req += ["pixx", "pixy", "pixn", "piyy", "piyn"]
    if cfg.include_bulk_deltaf:
        req += ["bulkPi"]
    if cfg.include_baryon:
        req += ["muB"]
        if cfg.include_baryondiff_deltaf:
            req += ["nB", "Vx", "Vy", "Vn"]
    if cfg.df_mode in (1, 2, 3, 4) and cfg.mode in (0, 1, 4, 5, 6, 7):
        req += ["E", "P"]
    return req


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
        bulkPi = c["bulkPi"]
        if cfg.df_mode == 4:
            # clamp bulkPi into the Jonah spline domain
            # (reference: emissionfunction_smooth_kernels.cpp:586-594)
            P = c["P"]
            bmax = df_data.bulkPi_over_Peq_max
            bulkPi = torch.where(bulkPi < -P, -(1.0 - 1.0e-5) * P, bulkPi)
            bulkPi = torch.where(bulkPi / P > bmax, P * (bmax - 1.0e-5),
                                 bulkPi)
            c["bulkPi"] = bulkPi
        c["df"] = evaluate_df_coefficients(
            df_data, cfg.df_mode, bool(cfg.include_baryon),
            c["T"], c["muB"], c["E"], c["P"], bulkPi)
    return c


# columns that must pad with a physical (non-zero) value so kernels stay
# finite on inert pad cells (they appear in denominators / sqrt arguments:
# with Lambda = aL = 0 the VAH kernels' 1/Lambda and xi_L = 1/aL^2 - 1
# would be inf, and the zero dsigma would turn them into 0 inf = NaN);
# everything else pads with 0, and dsigma = 0 makes a pad cell's
# contribution exactly zero.
PAD_ONE_COLUMNS = ("tau", "T", "E", "P", "Lambda", "aL")


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
