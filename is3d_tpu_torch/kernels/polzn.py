"""Thermal-vorticity spin polarization (mode 5).

Port of ``is3d_tpu.kernels.polzn`` (the reference's calculate_spin_polzn,
src/cpp/emissionfunction_polzn_kernels.cpp:27-265): per momentum point the
covariant polarization vector

    S_mu(p) = -(1 - sign f0) / (8 m) 2 eps_{mu nu rho sigma} p^nu w^{rho sigma}

is integrated over the surface with the measure p.dsigma f0 and normalized
by Snorm = int p.dsigma f0.  f0 = 1 / (exp(u.p / T_avg) + sign) takes the
surface-averaged temperature (the plasma's, which honours
set_FO_temperature), not each cell's.  Every cell counts: there is no
u.dsigma filter (the reference's kernel has none, :120-141).

One group of cells goes through:

1. ``pack_polzn_cells``: the kernels' input, a (C, NW) matrix of per-cell
   scalars (field order PW_FIELDS);
2. ``polzn_cuda`` (csrc/polzn.cu: ``fixed_kernel`` at fixed nodes,
   ``remap_kernel`` with the 2+1D mT remap) for CUDA tensors,
   ``polzn_plain`` for CPU tensors: the five sums (St, Sx, Sy, Sn, Snorm),
   each (S, n_pT, n_phi, n_y_out).

``spin_polarization`` folds the groups' five sums leaf by leaf in group
order (``parallel.mesh.grouped_cell_reduce``) and ``polzn_normalize``
divides by Snorm.

Gradients (``diff.polarization_fn``): on CUDA tensors under autograd the
kernels run inside ``_PolznKernel``, whose backward is ``polzn_bwd_cuda``
(csrc/polzn_bwd.cu: K12a ``polzn_bwd_kernel`` at fixed nodes, K12b
``polzn_remap_bwd_kernel`` with the remap), the gradient of the five sums
with respect to the packed cells; torch autograd of ``pack_polzn_cells``
takes it to the surface's columns.  On CPU tensors autograd runs through
``polzn_plain``, each cell chunk recomputed in the backward
(torch.utils.checkpoint, the JAX package's remat_scan).

Quadrature, as the JAX package: 2+1D fixed nodes weigh eta_weight x
(eta[1] - eta[0]) (the reference's quirk, :62-71; it divides out of
S/Snorm); the 2+1D remap moves the nodes to Delta = y_flow - s eta_r with
s = sqrt(T_ref / max(mT, T_ref)) per (species, pT), and the jacobian s
multiplies the reduced sums.  A massless species has pref = -0.25/m = -inf:
its S sums are inf or NaN as the JAX package's are, Snorm stays finite.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ..config import Config
from ..data import SpeciesArrays
from ..io.tables import MomentumGrid
from ..physics import lrf
from .common import fermi_bose, effective_chunk
from .launch import (PROPS, check_float, check_tensor, require_cuda,
                     launch, kernel_grid, tile_split)
from .smooth import (ETA_REMAP_T_REF, MomentumConstants, momentum_constants,
                     remap_scale, remap_node_table)

# per-cell scalar field order of the packed (C, NW) matrix; the CUDA
# sources' `enum PwField` (csrc/polzn.cuh) must list the same names in the
# same order.  ut_T, tun_T, ux_T, uy_T carry 1/T_avg; dant = dan / tau,
# itau = 1 / tau
PW_FIELDS = ("tau", "eta", "dat", "dant", "dax", "day", "ut_T", "tun_T",
             "ux_T", "uy_T", "itau", "wtx", "wty", "wtn", "wxy", "wxn", "wyn",
             "yflow")
NW = len(PW_FIELDS)
PW = {n: i for i, n in enumerate(PW_FIELDS)}
SUMS = ("St", "Sx", "Sy", "Sn", "Snorm")

# launches of the CUDA kernels in this process
LAUNCHES = 0
REMAP_LAUNCHES = 0
BWD_LAUNCHES = 0
BWD_REMAP_LAUNCHES = 0

# The bound's yardstick, counted once from the formula, an FMA as one
# operation, factors of fewer indices hoisted.  Per evaluation (cell,
# node, species, momentum point), (FP32, SFU): p.dsigma 1, u.p / T 1 |
# exp (SFU), + sign 1 | 1/(...) (SFU), pref = pm (1 - sign f0) 1, meas =
# p.dsigma f0 w 2, mp = meas pref 1, the four eps-contractions mT s1 + s2 4,
# the five sums 5                                               = (16, 2)
FORMULA_OPS = (16, 2)
# The 2+1D remap, per (cell, node, species, pT) and shared by the n_phi
# angles: e^Delta and e^-Delta from the node table 2, ch and sh 2,
# p.dsigma's and u.p's node terms 2 each, the four s1 6
REMAP_NODE_OPS = (14, 0)


def polzn_formula_ops(remap: bool, n_phi: int) -> tuple[float, float]:
    """(FP32, SFU) per evaluation: the yardstick above plus, with the
    remap, the node kinematics' share of one of n_phi points."""
    fp32, sfu = FORMULA_OPS
    if not remap:
        return float(fp32), float(sfu)
    return fp32 + REMAP_NODE_OPS[0] / n_phi, sfu + REMAP_NODE_OPS[1] / n_phi


# The backward kernels' yardstick (csrc/polzn_bwd.cu), counted from the
# formula as FORMULA_OPS is, an FMA as one operation, factors of fewer
# indices hoisted.  Per evaluation (cell, node, species, point), (FP32,
# SFU): the forward recomputed: p.dsigma 1, u.p / T 1 | exp, + sign 1 |
# 1/(...), q = 1 - sign f0 1, pref 1, meas 1, mp 1; the four T_k = mT s1 +
# s2 4; the chain: g_mp 4, g_meas 1, g_pref 1, g_f0 2, g_arg 2, g_pds 1;
# the sums: g_pds and g_arg once over the species (their px, py factors
# per point) and once with mT 4, the four g_T_k = g_k mp the same way,
# each product fused into its sum's FMA (mp mT once) 9           = (35, 2)
# (an earlier count, 38, took g_T_k's four products apart from their
# sums: an FMA is one operation, so they fuse)
POLZN_BWD_OPS = (35, 2)
# Per row (cell, node, species, pT), shared by its n_phi points.  Fixed
# nodes: none (the sums with mT are the per-evaluation FMAs above, cosh
# and sinh hoisted to the (cell, node); the order that multiplies six
# angle sums by mT a row needs 6).  The remap: e^+-Delta from the node
# table 2, mT cosh and mT sinh 2, x itau 1, the row terms of p.dsigma and
# u.p 4, the four s1 6, the weight x jacobian on the six sums 6, their
# products with the row's factors 12, d/dDelta 13
POLZN_BWD_ROW_OPS = 0
POLZN_BWD_REMAP_ROW_OPS = 46


def polzn_backward_formula_ops(remap: bool, n_phi: int
                               ) -> tuple[float, float]:
    """(FP32, SFU) per evaluation of a backward launch: the yardstick above
    plus the row's share of one of n_phi points."""
    fp32, sfu = POLZN_BWD_OPS
    row = POLZN_BWD_REMAP_ROW_OPS if remap else POLZN_BWD_ROW_OPS
    return fp32 + row / n_phi, float(sfu)


@dataclass(frozen=True)
class PolznFlags:
    dimension: int
    remap: bool


def polzn_flags(cfg: Config, grid: MomentumGrid) -> PolznFlags:
    return PolznFlags(dimension=int(cfg.dimension),
                      remap=bool(cfg.dimension == 2 and grid.eta_mT_rescale))


def polzn_cols(surface) -> dict:
    """Cell columns the polarization kernel reduces over."""
    if surface.wtx is None:
        raise ValueError("spin polarization needs a mode-5 surface with "
                         "thermal vorticity components")
    cols = {k: getattr(surface, k) for k in (
        "tau", "dat", "dax", "day", "dan", "ux", "uy", "un", "wtx", "wty",
        "wtn", "wxy", "wxn", "wyn")}
    cols["eta"] = (surface.eta if surface.eta is not None
                   else torch.zeros_like(surface.tau))
    return cols


def pack_polzn_cells(cols: dict, T_avg: float,
                     flags: PolznFlags) -> torch.Tensor:
    """(C, NW) kernel input from ``polzn_cols`` output (3+1D keeps the
    cells' eta; 2+1D takes 0)."""
    tau = cols["tau"]
    ut = lrf.u_tau(cols["ux"], cols["uy"], cols["un"], tau)
    inv_T = 1.0 / T_avg
    vals = dict(cols)
    vals.update(
        eta=cols["eta"] if flags.dimension == 3 else torch.zeros_like(tau),
        dant=cols["dan"] / tau, ut_T=ut * inv_T,
        tun_T=tau * cols["un"] * inv_T, ux_T=cols["ux"] * inv_T,
        uy_T=cols["uy"] * inv_T, itau=1.0 / tau,
        yflow=lrf.flow_rapidity(tau, ut, cols["un"]))
    return torch.stack([vals[n] for n in PW_FIELDS], dim=1).contiguous()


def node_weights(grid: MomentumGrid, flags: PolznFlags) -> torch.Tensor:
    """The weight of each rapidity node in the cell sum: 3+1D 1; 2+1D
    fixed nodes eta_weight x (eta[1] - eta[0]) (the reference's quirk);
    2+1D remap eta_weight."""
    if flags.dimension == 3:
        return torch.ones_like(grid.y)
    if flags.remap:
        return grid.eta_weight.contiguous()
    eta = grid.eta
    d_eta = (eta[1] - eta[0]) if eta.shape[0] > 1 else 1.0
    return (grid.eta_weight * d_eta).contiguous()


# ------------------------------------------------------------ plain version

def polzn_block(x: torch.Tensor, mom: MomentumConstants, pm: torch.Tensor,
                flags: PolznFlags) -> tuple[torch.Tensor, ...]:
    """(mp St', mp Sx', mp Sy', mp Sn', meas) of a chunk of packed cells at
    every (cell, node, species, pT, phi), meas = p.dsigma f0 and mp = meas
    pref, without node weights; pm = -0.25 / m per species."""
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    g = lambda name: x[:, PW[name]].view(-1, 1, 1, 1, 1)
    sp = lambda t: t.view(1, 1, S, 1, 1)
    mT = torch.sqrt(mom.mass[:, None] ** 2 + mom.pT[None, :] ** 2)
    mT5 = mT.view(1, 1, S, P, 1)
    px5 = mom.px.view(1, 1, 1, P, F)
    py5 = mom.py.view(1, 1, 1, P, F)
    nodes = mom.nodes.view(1, -1, 1, 1, 1)
    if flags.remap:
        delta = g("yflow") - remap_scale(mom).view(1, 1, S, P, 1) * nodes
    elif flags.dimension == 3:
        delta = nodes - g("eta")
    else:
        delta = -nodes
    ch, sh = torch.cosh(delta), torch.sinh(delta)
    # p^eta (not tau p^eta) contracts the vorticity: sh / tau
    sh_t = sh * g("itau")
    pds = mT5 * (ch * g("dat") + sh * g("dant")) + (g("dax") * px5
                                                     + g("day") * py5)
    arg = mT5 * (ch * g("ut_T") - sh * g("tun_T")) - (g("ux_T") * px5
                                                       + g("uy_T") * py5)
    sign = sp(mom.sign)
    f0 = fermi_bose(arg, sign)
    pref = sp(pm) * (1.0 - sign * f0)
    meas = pds * f0
    mp = meas * pref
    wxy, wxn, wyn = g("wxy"), g("wxn"), g("wyn")
    wtx, wty, wtn = g("wtx"), g("wty"), g("wtn")
    St = mp * (mT5 * (wxy * sh_t) + (wyn * px5 - wxn * py5))
    Sx = mp * (mT5 * (wyn * ch + wty * sh_t) - wtn * py5)
    Sy = mp * (-mT5 * (wxn * ch + wtx * sh_t) + wtn * px5)
    Sn = mp * (mT5 * (wxy * ch) + (wtx * py5 - wty * px5))
    return St, Sx, Sy, Sn, meas


def _plain_chunk(x: torch.Tensor, mom: MomentumConstants, pm: torch.Tensor,
                 wR: torch.Tensor, flags: PolznFlags
                 ) -> tuple[torch.Tensor, ...]:
    """A chunk's five polzn_block sums reduced over cells (3+1D: (R, S, P,
    F)) or over cells and weighted nodes (2+1D: (S, P, F))."""
    R = mom.nodes.shape[0]
    if flags.dimension == 3:
        return tuple(b.sum(0) for b in polzn_block(x, mom, pm, flags))
    return tuple((b * wR.view(1, R, 1, 1, 1)).sum((0, 1))
                 for b in polzn_block(x, mom, pm, flags))


def polzn_plain(x: torch.Tensor, mom: MomentumConstants, pm: torch.Tensor,
                wR: torch.Tensor, flags: PolznFlags,
                cell_chunk: int = 65536) -> tuple[torch.Tensor, ...]:
    """Plain torch version of the kernels on the same inputs: the five
    sums (St, Sx, Sy, Sn, Snorm), each (S, n_pT, n_phi, n_y_out), cells
    reduced in chunks within common.CHUNK_ELEMENT_BUDGET (the block holds
    about 8 live copies)."""
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    R = mom.nodes.shape[0]
    C = x.shape[0]
    chunk = effective_chunk(cell_chunk, C, 8 * R * S * P * F)
    # under autograd each chunk is recomputed in the backward
    # (torch.utils.checkpoint, JAX's remat_scan); the small per-chunk sums
    # add out of place
    run = _plain_chunk
    if torch.is_grad_enabled() and x.requires_grad:
        run = functools.partial(torch.utils.checkpoint.checkpoint,
                                _plain_chunk, use_reentrant=False)
    acc = None
    for c0 in range(0, max(C, 1), chunk):
        parts = run(x[c0:c0 + chunk], mom, pm, wR, flags)
        acc = parts if acc is None else [a + p for a, p in zip(acc, parts)]
    out = []
    for a in acc:
        if flags.dimension == 3:
            a = a.permute(1, 2, 3, 0)
        else:
            if flags.remap:
                # the substitution's jacobian s(mT), on the reduced sums
                a = a * remap_scale(mom)[:, :, None]
            a = a[..., None]
        out.append(a.contiguous())
    return tuple(out)


def polzn_normalize(sums) -> dict:
    """(St, Sx, Sy, Sn, Snorm) -> the result dict with the S/Snorm arrays
    (Snorm == 0 guarded: the ratio is 0 there)."""
    St, Sx, Sy, Sn, Snorm = sums
    safe = torch.where(Snorm == 0.0, torch.ones_like(Snorm), Snorm)
    return dict(St=St, Sx=Sx, Sy=Sy, Sn=Sn, Snorm=Snorm,
                St_over_Snorm=St / safe, Sx_over_Snorm=Sx / safe,
                Sy_over_Snorm=Sy / safe, Sn_over_Snorm=Sn / safe)


# ------------------------------------------------------------- CUDA kernel

def _library():
    from ..native.build import cuda_library
    lib = cuda_library("polzn")
    if not getattr(lib, "_is3d_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.is3d_polzn_grid_f32, lib.is3d_polzn_grid_f64):
            fn.restype = ci
            fn.argtypes = [ci] * 6 + [ctypes.POINTER(ci)]  # S P F R dim remap
        for fn in (lib.is3d_polzn_f32, lib.is3d_polzn_f64):
            fn.restype = ci
            fn.argtypes = [vp, ci, ci,                 # cells, C, nw
                           vp, vp, vp, ci,             # mass sign pm, S
                           vp, vp, vp, ci, ci,         # pT px py n_pT n_phi
                           vp, vp, ci, ci,             # nodes, wR, R, dim
                           ci, ci, vp,                 # per, parts, partial
                           vp, vp]                     # out, stream
        for fn in (lib.is3d_polzn_remap_f32, lib.is3d_polzn_remap_f64):
            fn.restype = ci
            fn.argtypes = [vp, ci, ci,                 # cells, C, nw
                           vp, vp, vp, ci,             # mass sign pm, S
                           vp, ci, vp, vp, ci,         # pT, n_pT, cos, sin, F
                           vp, vp, ci,                 # table, wR, R
                           ctypes.c_double,            # T_ref
                           ci, ci, vp,                 # per, parts, partial
                           vp, vp]                     # out, stream
        lib.is3d_cuda_error_string.restype = ctypes.c_char_p
        lib.is3d_cuda_error_string.argtypes = [ci]
        lib._is3d_bound = True
    return lib


def polzn_grid(lib, device: torch.device, f64: bool, n_species: int,
               n_pT: int, n_phi: int, n_nodes: int, flags: PolznFlags):
    """A polarization kernel's launch.KernelGrid for one shape on one card
    (csrc/polzn.cu:polzn_grid owns the blocking)."""
    return kernel_grid(
        lib, "polzn",
        lib.is3d_polzn_grid_f64 if f64 else lib.is3d_polzn_grid_f32,
        device, n_species, n_pT, n_phi, n_nodes, flags.dimension,
        int(flags.remap))


def polzn_cuda(x: torch.Tensor, mom: MomentumConstants, pm: torch.Tensor,
               wR: torch.Tensor, flags: PolznFlags,
               table: torch.Tensor | None = None) -> tuple[torch.Tensor, ...]:
    """Launch the hand-written kernel (csrc/polzn.cu) on the current
    stream: the five sums, each (S, n_pT, n_phi, n_y_out) in the cells'
    dtype.  With ``flags.remap``, ``table`` is
    ``smooth.remap_node_table(mom)``, built here if not given, and the
    angles must be separable as ``momentum_constants`` builds them."""
    return tuple(_polzn_sums(x, mom, pm, wR, flags, table).unbind(0))


def _polzn_sums(x: torch.Tensor, mom: MomentumConstants, pm: torch.Tensor,
                wR: torch.Tensor, flags: PolznFlags,
                table: torch.Tensor | None) -> torch.Tensor:
    """polzn_cuda's five sums as one (5, S, n_pT, n_phi, n_y_out) tensor."""
    global LAUNCHES, REMAP_LAUNCHES
    check_float("polzn_cuda", x)
    C = x.shape[0]
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    R = mom.nodes.shape[0]
    check_tensor("cells", x, (C, NW), x)
    check_tensor("pm", pm, (S,), x)
    check_tensor("wR", wR, (R,), x)
    for name, n in dict(mass=S, sign=S, pT=P, px=P * F, py=P * F, nodes=R,
                        cos_phi=F, sin_phi=F).items():
        check_tensor(f"momentum constant {name}", getattr(mom, name), (n,),
                     x)
    if flags.remap and table is not None:
        check_tensor("remap node table", table, (S, P, R, 2), x)
    if flags.remap and flags.dimension != 2:
        raise ValueError("polzn_cuda: the remap is 2+1D only")
    require_cuda("polzn_cuda", x)
    lib = _library()
    f64 = x.dtype == torch.float64
    grid = polzn_grid(lib, x.device, f64, S, P, F, R, flags)
    per, n_split = tile_split(C, grid)
    n_parts = n_split * grid.parts
    n_out = R if flags.dimension == 3 else 1
    out = x.new_empty((5, S, P, F, n_out))
    partial = x.new_empty((n_parts, 5, S, P, F, n_out))
    head = (x.data_ptr(), C, NW, mom.mass.data_ptr(), mom.sign.data_ptr(),
            pm.data_ptr(), S)
    if flags.remap:
        if table is None:
            table = remap_node_table(mom)
        launch(lib, "polzn remap",
               lib.is3d_polzn_remap_f64 if f64 else lib.is3d_polzn_remap_f32,
               x.device, *head, mom.pT.data_ptr(), P,
               mom.cos_phi.data_ptr(), mom.sin_phi.data_ptr(), F,
               table.data_ptr(), wR.data_ptr(), R, ETA_REMAP_T_REF, per,
               n_parts, partial.data_ptr(), out.data_ptr())
        REMAP_LAUNCHES += 1
    else:
        launch(lib, "polzn", lib.is3d_polzn_f64 if f64 else lib.is3d_polzn_f32,
               x.device, *head, mom.pT.data_ptr(), mom.px.data_ptr(),
               mom.py.data_ptr(), P, F, mom.nodes.data_ptr(), wR.data_ptr(),
               R, flags.dimension, per, n_parts, partial.data_ptr(),
               out.data_ptr())
        LAUNCHES += 1
    return out


# ------------------------------------------------------ backward kernels

def polzn_bwd_plain(x: torch.Tensor, G: torch.Tensor, mom: MomentumConstants,
                    pm: torch.Tensor, wR: torch.Tensor, flags: PolznFlags,
                    cell_chunk: int = 65536) -> torch.Tensor:
    """Plain version of the backward kernels: the gradient (C, NW) of <G,
    polzn_plain(x)> with respect to the packed cells, G (5, S, n_pT, n_phi,
    n_y_out) the five sums' cotangents, by torch autograd of the plain
    version."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        out = polzn_plain(xg, mom, pm, wR, flags, cell_chunk)
        return torch.autograd.grad(out, xg, tuple(G.unbind(0)))[0]


def _bwd_library():
    from ..native.build import cuda_library
    lib = cuda_library("polzn_bwd")
    if not getattr(lib, "_is3d_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.is3d_polzn_bwd_f32, lib.is3d_polzn_bwd_f64):
            fn.restype = ci
            fn.argtypes = [vp, ci, ci,                 # cells, C, nw
                           ci, ci, ci,                 # S, n_pT, n_phi
                           vp, vp, vp, vp, ci, ci,     # px py nodes wR, R, dim
                           ci, vp, vp, vp, vp]         # RU, rows, Gst, grad, stream
        for fn in (lib.is3d_polzn_bwd_remap_f32,
                   lib.is3d_polzn_bwd_remap_f64):
            fn.restype = ci
            fn.argtypes = [vp, ci, ci,                 # cells, C, nw
                           vp, vp, vp, ci,             # mass sign pm, S
                           vp, ci, vp, vp, ci,         # pT, n_pT, cos, sin, F
                           vp, vp, ci,                 # table, wR, R
                           vp, vp, vp]                 # Gs, grad, stream
        lib.is3d_polzn_bwd_layout.restype = ci
        lib.is3d_polzn_bwd_layout.argtypes = [ci] * 3 + [vp]
        lib.is3d_polzn_bwd_props.restype = ci
        lib.is3d_polzn_bwd_props.argtypes = [ci] * 7 + [vp]
        lib.is3d_cuda_error_string.restype = ctypes.c_char_p
        lib.is3d_cuda_error_string.argtypes = [ci]
        lib._is3d_bound = True
    return lib


# what the backward kernels' plan reports (csrc/polzn_bwd.cu:props):
# launch.PROPS, then the species a stage, the pT rows a stage, the angles a
# thread evaluates at once (K12b: the phi loop's unroll), the values a
# species' stage row (K12a) or a point (K12b) holds, and the waves of
# resident blocks
BWD_PLAN = PROPS + ("species_per_stage", "pT_rows_per_stage", "angles",
                    "stage_row", "waves")


def bwd_props(device: torch.device, f64: bool, mom: MomentumConstants,
              flags: PolznFlags, n_cells: int) -> dict:
    """The launch plan and resources of the backward kernel of ``flags`` at
    mom's shape for ``n_cells`` cells (BWD_PLAN).  For reports:
    polzn_bwd_cuda's launch makes its own plan."""
    lib = _bwd_library()
    dim = 0 if flags.remap else flags.dimension
    out = (ctypes.c_int * len(BWD_PLAN))()
    with torch.cuda.device(device):
        rc = lib.is3d_polzn_bwd_props(
            int(f64), dim, mom.mass.shape[0], mom.pT.shape[0], mom.n_phi,
            mom.nodes.shape[0], max(int(n_cells), 1), out)
    if rc != 0:
        raise RuntimeError("polzn_bwd: no launch configuration: "
                           f"{lib.is3d_cuda_error_string(rc).decode()}")
    return dict(zip(BWD_PLAN, out))


def fixed_bwd_stage(G: torch.Tensor, mom: MomentumConstants,
                    pm: torch.Tensor, angles: int, stage_row: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """K12a's inputs from the five sums' cotangents G (5, S, P, F, n_out),
    on G's device and dtype: rows (P, S, 4) = mT, sign, pm, pm sign of each
    (pT, species), and Gst (P, ceil(F / angles), S, stage_row): per (pT,
    angle group, species) first g0..g3 of each (angle, node), angle-major,
    then g4 of each (node, angle), node-major, padded with zeros to
    stage_row (the angles too, to a whole group), so that one stage of the
    kernel (a pT row, an angle group, a chunk of species) is one contiguous
    run and a (species, node, angle)'s g0..g3 one 16-byte vector."""
    _, S, P, F, R = G.shape
    nfg = -(-F // angles)
    g = torch.nn.functional.pad(G, (0, 0, 0, nfg * angles - F))
    g = g.view(5, S, P, nfg, angles, R)
    quads = g[:4].permute(2, 3, 1, 4, 5, 0).reshape(P, nfg, S, -1)
    g4 = g[4].permute(1, 2, 0, 4, 3).reshape(P, nfg, S, -1)
    st = torch.nn.functional.pad(torch.cat([quads, g4], dim=3),
                                 (0, stage_row - 5 * angles * R))
    mT = torch.sqrt(mom.mass[None, :] ** 2 + mom.pT[:, None] ** 2)
    rows = torch.stack([mT, mom.sign.expand(P, S), pm.expand(P, S),
                        (pm * mom.sign).expand(P, S)], dim=2)
    return rows.to(G.dtype).contiguous(), st.contiguous()


def remap_bwd_stage(G: torch.Tensor, mom: MomentumConstants) -> torch.Tensor:
    """K12b's cotangent from the five sums' cotangents G (5, S, P, F, 1),
    on G's device and dtype: Gs (S, P, F, 8) = the five G's times the
    remap's jacobian s(mT) of the (species, pT) row, then cos phi, sin phi
    and 0, so that a point is two 16-byte vectors."""
    _, S, P, F, _ = G.shape
    g = G[..., 0] * remap_scale(mom).to(G.dtype)[None, :, :, None]
    ang = torch.stack([mom.cos_phi, mom.sin_phi,
                       torch.zeros_like(mom.cos_phi)], dim=1).to(G.dtype)
    return torch.cat([g.permute(1, 2, 3, 0),
                      ang.expand(S, P, F, 3)], dim=3).contiguous()


def polzn_bwd_cuda(x: torch.Tensor, G: torch.Tensor, mom: MomentumConstants,
                   pm: torch.Tensor, wR: torch.Tensor, flags: PolznFlags,
                   table: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the backward kernel (csrc/polzn_bwd.cu) on the current
    stream: the gradient (C, NW) of <G, polzn_cuda(x, mom, pm, wR, flags)>
    with respect to the packed cells, G (5, S, n_pT, n_phi, n_y_out) the
    five sums' cotangents.  With ``flags.remap``, ``table`` is
    ``smooth.remap_node_table(mom)``, built here if not given, and the
    angles must be separable as ``momentum_constants`` builds them."""
    global BWD_LAUNCHES, BWD_REMAP_LAUNCHES
    check_float("polzn_bwd_cuda", x)
    C = x.shape[0]
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    R = mom.nodes.shape[0]
    check_tensor("cells", x, (C, NW), x)
    check_tensor("G", G, (5, S, P, F, R if flags.dimension == 3 else 1), x)
    check_tensor("pm", pm, (S,), x)
    check_tensor("wR", wR, (R,), x)
    for name, n in dict(mass=S, sign=S, pT=P, px=P * F, py=P * F, nodes=R,
                        cos_phi=F, sin_phi=F).items():
        check_tensor(f"momentum constant {name}", getattr(mom, name), (n,),
                     x)
    if flags.remap and table is not None:
        check_tensor("remap node table", table, (S, P, R, 2), x)
    if flags.remap and flags.dimension != 2:
        raise ValueError("polzn_bwd_cuda: the remap is 2+1D only")
    require_cuda("polzn_bwd_cuda", x)
    lib = _bwd_library()
    f64 = x.dtype == torch.float64
    grad = torch.empty_like(x)
    if flags.remap:
        if table is None:
            table = remap_node_table(mom)
        Gs = remap_bwd_stage(G, mom)
        launch(lib, "polzn_bwd remap",
               lib.is3d_polzn_bwd_remap_f64 if f64
               else lib.is3d_polzn_bwd_remap_f32, x.device, x.data_ptr(), C,
               NW, mom.mass.data_ptr(), mom.sign.data_ptr(), pm.data_ptr(),
               S, mom.pT.data_ptr(), P, mom.cos_phi.data_ptr(),
               mom.sin_phi.data_ptr(), F, table.data_ptr(), wR.data_ptr(), R,
               Gs.data_ptr(), grad.data_ptr())
        BWD_REMAP_LAUNCHES += 1
        return grad
    layout = (ctypes.c_int * 2)()
    lib.is3d_polzn_bwd_layout(int(f64), flags.dimension, R, layout)
    angles, stage_row = layout
    rows, Gst = fixed_bwd_stage(G, mom, pm, angles, stage_row)
    launch(lib, "polzn_bwd", lib.is3d_polzn_bwd_f64 if f64
           else lib.is3d_polzn_bwd_f32, x.device, x.data_ptr(), C, NW, S, P,
           F, mom.px.data_ptr(), mom.py.data_ptr(), mom.nodes.data_ptr(),
           wR.data_ptr(), R, flags.dimension, stage_row, rows.data_ptr(),
           Gst.data_ptr(), grad.data_ptr())
    BWD_LAUNCHES += 1
    return grad


class _PolznKernel(torch.autograd.Function):
    """polzn_cuda with its backward kernel: the forward keeps only the
    packed cells, and the backward recomputes everything else inside
    polzn_bwd_cuda."""

    @staticmethod
    def forward(ctx, x, mom, pm, wR, flags, table):
        ctx.save_for_backward(x)
        ctx.args = (mom, pm, wR, flags, table)
        return _polzn_sums(x, mom, pm, wR, flags, table)

    @staticmethod
    def backward(ctx, G):
        (x,) = ctx.saved_tensors
        return (polzn_bwd_cuda(x, G.contiguous(), *ctx.args),) + (None,) * 5


# ------------------------------------------------------------ entry point

def species_pm(species: SpeciesArrays) -> torch.Tensor:
    """pm = -0.25 / m per species (-inf for a massless one)."""
    return (-0.25 / species.mass).contiguous()


def _group_sums(cols: dict, mom: MomentumConstants, pm: torch.Tensor,
                wR: torch.Tensor, flags: PolznFlags,
                table: torch.Tensor | None, T_avg: float,
                cfg: Config) -> dict:
    x = pack_polzn_cells(cols, T_avg, flags)
    if x.device.type == "cuda":
        if torch.is_grad_enabled() and x.requires_grad:
            sums = _PolznKernel.apply(x, mom, pm, wR, flags,
                                      table).unbind(0)
        else:
            sums = polzn_cuda(x, mom, pm, wR, flags, table)
    elif x.device.type == "cpu":
        sums = polzn_plain(x, mom, pm, wR, flags, cfg.cell_chunk)
    else:
        raise ValueError(f"no polarization path for device {x.device}")
    return dict(zip(SUMS, sums))


def polzn_reduction(cols: dict, species: SpeciesArrays, grid: MomentumGrid,
                    cfg: Config, plasma) -> tuple:
    """(kernel_fn, replicated) of the polarization's cell reduction over
    ``cols`` (the whole surface's or a rank's slice); T_avg is
    ``plasma.temperature``."""
    flags = polzn_flags(cfg, grid)
    mom = momentum_constants(species, grid, cfg.dimension)
    pm = species_pm(species)
    wR = node_weights(grid, flags)
    table = (remap_node_table(mom)
             if flags.remap and cols["tau"].device.type == "cuda" else None)
    T_avg = float(plasma.temperature)
    return ((lambda c, m, p, w, fl, t: _group_sums(c, m, p, w, fl, t, T_avg,
                                                   cfg)),
            (mom, pm, wR, flags, table))


def spin_polarization(surface, species: SpeciesArrays, grid: MomentumGrid,
                      cfg: Config, plasma, mesh=None) -> dict:
    """St, Sx, Sy, Sn (unnormalized sums), Snorm and the normalized
    S{t,x,y,n}_over_Snorm, each (S, n_pT, n_phi, n_y_out), on the surface's
    device.  ``plasma.temperature`` is T_avg (it honours
    set_FO_temperature).  The cell reduction runs through the canonical
    group tree: one launch per group, the five sums folded in group
    order (with ``mesh``, each rank launches its own groups and every rank
    folds all of them)."""
    from ..parallel.mesh import grouped_cell_reduce
    cols = polzn_cols(surface)
    fn, replicated = polzn_reduction(cols, species, grid, cfg, plasma)
    acc = grouped_cell_reduce(fn, cols, replicated, cfg, mesh=mesh)
    return polzn_normalize(tuple(acc[k] for k in SUMS))
