"""Smooth Cooper-Frye spectra: dN / (pT dpT dphi dy), linear df modes 1-2.

Port of ``is3d_tpu.kernels.smooth`` (the reference's hot loop,
emissionfunction_smooth_kernels.cpp:28-393).  One group of cells goes
through three steps:

1. ``prepare_cells`` completes the hydro fields and evaluates the df
   coefficients per cell (kernels/common.py);
2. ``pack_cells`` folds them into the kernel's input, a (Cp, NF) matrix of
   per-cell scalars (Cp a multiple of CELL_BLOCK, pad rows inert);
3. ``smooth_spectra_cuda`` (the hand-written kernels of
   csrc/smooth_spectra.cu: ``spectra_kernel`` at fixed nodes,
   ``remap_kernel`` with the 2+1D remap, fed ``remap_node_table`` and a
   cell split from ``remap_cell_split``) reduces the group for CUDA
   tensors, ``smooth_spectra_plain`` (chunked tensor algebra, the port of
   ``_chunk_contribution``) for CPU tensors.

Both take the same inputs and return (S, n_pT, n_phi, n_y_out).  The
group partials are folded by ``parallel.mesh.grouped_cell_reduce``.

Per (cell, rapidity node) the kinematics enter through cosh/sinh of
Delta = y - eta, so every per-point quantity is a short fma chain:

    p.dsigma   = mT A1(c,r) + W1(c,m)
    u.p        = mT B1(c,r) - W2(c,m)
    pi:pp      = mT^2 C1 + mT px C2 + mT py C3 + C4(c,m)
    V.p        = mT D1(c,r) - D2(c,m)

2+1D: y = 0 and the nodes are the eta quadrature (weighted, summed);
3+1D: the nodes are the output rapidities and eta comes from the cell.
With the 2+1D mT-adaptive remap (MomentumGrid.eta_mT_rescale) the nodes
move per (cell, species, pT) to Delta = y_flow(cell) - s(mT) eta_r with
s = sqrt(T_ref / max(mT, T_ref)), and the jacobian s multiplies the sum.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.utils.checkpoint

from ..units import CF_PREFACTOR
from ..config import Config
from ..data import SpeciesArrays
from ..io.tables import MomentumGrid
from ..io.deltaf import DeltafData
from ..tensors import TensorContainer
from .common import surface_columns, prepare_cells, fermi_bose, effective_chunk
from .launch import (PROPS, check_float, check_tensor, kernel_props,
                     require_cuda, launch, split_to_fill)

# reference temperature of the eta-node remap's s(mT) = sqrt(T_ref/mT)
ETA_REMAP_T_REF = 0.15
# pack_cells pads the cell axis to a multiple of this
CELL_BLOCK = 16

# per-cell scalar field order of the packed (Cp, NF) matrix; the CUDA
# source's `enum Field` must list the same names in the same order
FIELDS = ("tau", "dat", "dax", "day", "dant", "ut", "ux", "uy", "tun",
          "invT", "alphaB", "pitt", "pitx", "pity", "pitn", "pixx", "pixy",
          "pixn", "piyy", "piyn", "pinn", "Vt", "Vx", "Vy", "Vn", "benth",
          "bulkPi", "eta", "yflow", "k_sc", "k_b0", "k_b1", "k_b2", "k_dv",
          "k_c3", "k_c4")
NF = len(FIELDS)
IDX = {n: i for i, n in enumerate(FIELDS)}
# inert pad row: no dsigma, so every contribution is exactly 0; these
# fields are 1 so every denominator stays finite
_PAD_ONE_FIELDS = ("tau", "ut", "invT")

# launches of the CUDA kernels in this process (smooth_spectra_cuda): all
# of them, and those that took the 2+1D remap kernel; and of the backward
# kernels (spectra_bwd_cuda: csrc/smooth_spectra_bwd.cu), fixed nodes and
# remap
LAUNCHES = 0
REMAP_LAUNCHES = 0
BWD_LAUNCHES = 0
BWD_REMAP_LAUNCHES = 0

# The yardstick of the emission kernels' bounds: the FP32 and SFU
# operations per evaluation that depend on cell, node, species and momentum
# point all at once, counted once from the emission formula (plain_block)
# at the main paths' flags (regulate and outflow on), an FMA as one
# operation.  A factor or term of fewer indices is hoisted and not counted:
# it is formed once per cell, (cell, node), (cell, species) or (cell,
# point) and folded into the staged values (1/T and log2 e into B1 and W2,
# k_sc into C1-C4, bulkPi into the k_b, k_dv into benth and the diffusion
# terms, the (cell, species) constants into C4's sum).  Per evaluation,
# (FP32, SFU):
#   both:  p.dsigma 1, u.p 1, pi:pp 3 (its addend carries the hoisted
#          terms), V.p 1, exponent 1 | exp (SFU), + sign 1 | 1/(...) (SFU),
#          1 - sign feq 1                                           = 9
#   df 1:  kb2 u.p + kb1 b 1, (...) u.p + pi:pp 1, kc4 u.p + kc3 b 1,
#          (...) V.p + (...) 1                                      = 4
#   df 2:  1/u.p (SFU); as r (pi:pp - kb2 m2 - kdv b V.p) + kb' u.p +
#          (kb1 b + kdv benth V.p): pi:pp - (...) V.p 1,
#          kdv benth V.p + kb1 b 1, kb' u.p + (...) 1, r (...) + (...) 1 = 4
#   both:  feqbar df 1, clip 2, feq df + feq 1, max(p.dsigma, 0) 1  = 5
# so the emission value takes (18, 2) for df 1 and (18, 3) for df 2.  Each
# kernel adds its sum over the cells or momentum points, 1 FMA (the
# momentum weight folds into p.dsigma; the 2+1D node weight and the dN/dX
# kernel's sums of that per (cell, node, species) are not counted).  The
# bound is the larger of FP32 / (SMs x 128 lanes x clock), SFU / (SMs x 16
# lanes x clock) and the bytes over the memory rate.
EMISSION_OPS = {1: (18, 2), 2: (18, 3)}
FORMULA_OPS = {df: (fp32 + 1, sfu) for df, (fp32, sfu) in EMISSION_OPS.items()}
# With the 2+1D mT remap the nodes move with (cell, species, pT), so the
# node kinematics cannot be hoisted out of the species: per (cell, node,
# species, pT), shared by the n_phi points of that pT.  exp(+-Delta) is the
# product of mT/2 exp(+-y_flow), of indices (cell, species, pT), and
# exp(-+s eta_r), of indices (species, pT, node): both exponentials are
# hoisted, so no SFU operation is left.  Counted from the formula with
# ch = mT cosh Delta, sh = mT sinh Delta and the per-cell factors folded:
# the two products 2, ch and sh 2, A1 2, B1 2, D1 2, C1 6 (ch^2, sh^2,
# ch sh and three FMAs), pT ch and pT sh 2 (mT px C2 + mT py C3 = pT ch
# g(cell, phi) + pT sh h(cell, phi), so C2 and C3 are not formed per node;
# the sum joins pi:pp's three FMAs per evaluation).
REMAP_NODE_OPS = (18, 0)


# The yardstick of the backward kernels' bounds (csrc/smooth_spectra_bwd.cu):
# the FP32 and SFU operations per evaluation (cell, node, species, point) of
# the gradient of <G, spectra> with respect to the packed cells, counted from
# the formula as FORMULA_OPS is, an FMA as one operation, terms of fewer
# indices hoisted.  The backward recomputes the emission value (its
# EMISSION_OPS less the hoisted sum) and adds, per evaluation:
#   g = G x weight (staged, 0), the outflow mask and g f 1, g max(p.ds, 0)
#   1, the clip mask and g' feq 1, g' (1 + dfc) - sign g'' df 2,
#   g'' feqbar 1, g_arg = -g_feq feq feqbar 2                      = 8
#   df 1: g_pi:pp 1, g_V.p 2, g_u.p 3 (g_arg/T + g_df ((kb1 b + 2 kb2 u.p)
#         Pi + kc4 V.p)); df 2: g_pi:pp 1, g_V.p 2, g_u.p 4        = 6 / 7
#   the sums a thread carries: g_arg u.p, g_arg b, six of the df chain
#   (df 1: g_df pi:pp, m^2, b u.p, u.p^2, b V.p, u.p V.p; df 2:
#   g_df pi:pp r, u.p, b, u.p - m^2 r, V.p, b r V.p: 2 each where two
#   factors multiply) ~10, the four point terms' cotangents 4, and their
#   node sums with mT (gp mT, gu mT, gq mT^2, gq mT, gv mT) 6        = 20
# so (18 + 8 + 6 + 20, 2) = (52, 2) for df 1 and (18 + 8 + 7 + 20, 3) =
# (53, 3) for df 2.  With the remap the node kinematics move with (cell,
# species, pT), so a node sum cannot be hoisted out of the species: either
# the 13 sums with mT cosh and mT sinh apart run per evaluation (the node
# sums' 6 become 13 + 4 cotangents), or, species outermost, the row sums
# of the 6 cotangents (gp, gu, gq, gq px, gq py, gv) run per evaluation
# and the 9 sums with px, py (gp px, gp py, gu px, gu py, gq px^2, gq py^2,
# gq px py, gv px, gv py) cannot wait for a species sum: 15 against the
# fixed node's 10, the cheaper, + 5; and pi:pp's px part is mT cosh g +
# mT sinh h of the (cell, phi) terms at unit pT, + 1: REMAP_BACKWARD_EXTRA
# a evaluation.  Per row (cell, node, species, pT), shared by its n_phi
# points (REMAP_BACKWARD_ROW_OPS): the node kinematics (mT/2 exp(+-y_flow)
# x the node table 4, mT cosh, mT sinh 2) 6, the composites (tau sinh 1,
# A 2, B 2, D 2, C1 6, pT mT cosh, pT mT sinh, pT^2 3) 16, the 13 node
# sums from the row's 6 (cp tQ, sp tQ 2, 13 FMAs) 15 = 37.
BACKWARD_FORMULA_OPS = {1: (52, 2), 2: (53, 3)}
REMAP_BACKWARD_EXTRA = 6
REMAP_BACKWARD_ROW_OPS = 37


def backward_formula_ops(df_mode: int, remap: bool,
                         n_phi: int) -> tuple[float, int]:
    """(FP32, SFU) per evaluation of the backward kernel: with the remap
    the fixed-node count plus the per-evaluation extra and the row's share
    of one of n_phi points."""
    fp32, sfu = BACKWARD_FORMULA_OPS[df_mode]
    if remap:
        fp32 += REMAP_BACKWARD_EXTRA + REMAP_BACKWARD_ROW_OPS / n_phi
    return fp32, sfu


def remap_formula_ops(df_mode: int, n_phi: int) -> tuple[float, float]:
    """(FP32, SFU) per evaluation of the 2+1D remap path: the fixed-node
    yardstick plus the node kinematics' share of one of n_phi points."""
    fp32, sfu = FORMULA_OPS[df_mode]
    return fp32 + REMAP_NODE_OPS[0] / n_phi, sfu + REMAP_NODE_OPS[1] / n_phi


@dataclass(frozen=True)
class MomentumConstants(TensorContainer):
    """Species and momentum inputs of the kernel and its plain version."""

    mass: torch.Tensor        # (S,)
    sign: torch.Tensor        # (S,)
    baryon: torch.Tensor      # (S,)
    degeneracy: torch.Tensor  # (S,)
    pT: torch.Tensor          # (P,)
    px: torch.Tensor          # (P*F,) pT cos(phi), flattened m = p*F + f
    py: torch.Tensor          # (P*F,) pT sin(phi)
    nodes: torch.Tensor       # (R,) 3+1D: output y; 2+1D: eta nodes
    weights: torch.Tensor     # (R,) 2+1D eta weights (unused in 3+1D)
    cos_phi: torch.Tensor     # (F,) px = pT cos_phi, py = pT sin_phi
    sin_phi: torch.Tensor     # (F,)
    n_phi: int


@dataclass(frozen=True)
class SpectraFlags:
    df_mode: int
    dimension: int
    remap: bool
    regulate: bool
    outflow: bool


def df_switches(cfg: Config) -> tuple[bool, bool, bool]:
    """(shear_on, bulk_on, diff_on)."""
    return (bool(cfg.include_shear_deltaf),
            bool(cfg.include_bulk_deltaf),
            bool(cfg.include_baryon and cfg.include_baryondiff_deltaf))


def spectra_flags(cfg: Config, grid: MomentumGrid) -> SpectraFlags:
    if cfg.df_mode not in (1, 2):
        raise ValueError("smooth_spectra handles df modes 1-2")
    return SpectraFlags(df_mode=int(cfg.df_mode), dimension=int(cfg.dimension),
                        remap=bool(cfg.dimension == 2 and grid.eta_mT_rescale),
                        regulate=bool(cfg.regulate_deltaf),
                        outflow=bool(cfg.outflow))


def momentum_constants(species: SpeciesArrays, grid: MomentumGrid,
                       dimension: int) -> MomentumConstants:
    P, F = grid.n_pT, grid.n_phi
    cos_phi, sin_phi = torch.cos(grid.phi), torch.sin(grid.phi)
    px = grid.pT[:, None] * cos_phi[None, :]
    py = grid.pT[:, None] * sin_phi[None, :]
    nodes, weights = ((grid.y, torch.ones_like(grid.y)) if dimension == 3
                      else (grid.eta, grid.eta_weight))
    c = lambda t: t.contiguous()
    return MomentumConstants(
        mass=c(species.mass), sign=c(species.sign), baryon=c(species.baryon),
        degeneracy=c(species.degeneracy), pT=c(grid.pT),
        px=px.reshape(P * F).contiguous(), py=py.reshape(P * F).contiguous(),
        nodes=nodes.contiguous(), weights=weights.contiguous(),
        cos_phi=c(cos_phi), sin_phi=c(sin_phi), n_phi=F)


def remap_scale(mom: MomentumConstants) -> torch.Tensor:
    """s(mT) = sqrt(T_ref / max(mT, T_ref)) of the 2+1D eta-node remap,
    (S, P): the nodes' scale and the jacobian of the node map."""
    mT = torch.sqrt(mom.mass[:, None] ** 2 + mom.pT[None, :] ** 2)
    return torch.sqrt(ETA_REMAP_T_REF / torch.clamp(mT, min=ETA_REMAP_T_REF))


def remap_node_table(mom: MomentumConstants) -> torch.Tensor:
    """The remap kernel's node factors, (S, P, R, 2) = exp(-s eta_r),
    exp(+s eta_r) with s = remap_scale: exp(+-Delta) at Delta = y_flow -
    s eta_r is exp(+-y_flow) times one of them."""
    se = remap_scale(mom)[:, :, None] * mom.nodes[None, None, :]
    return torch.stack([torch.exp(-se), torch.exp(se)], dim=3).contiguous()


def pack_cells(c: dict, cfg: Config) -> torch.Tensor:
    """(Cp, NF) kernel input from ``prepare_cells`` output.

    The validity mask (u.dsigma > 0) is folded into the dsigma columns,
    the df coefficients into the k_* columns (df 1: k_sc = 0.5/(T^2(E+P)),
    k_b0 = c0-c2, k_b1 = c1, k_b2 = 4c2-c0, k_c3 = c3, k_c4 = c4; df 2:
    k_sc = 0.5/(betapi T), k_b0 = F/(T^2 betabulk), k_b1 = G/betabulk,
    k_b2 = 1/(3 T betabulk), k_dv = 1/betaV), with switched-off terms
    zeroed.  Rows are padded to a multiple of CELL_BLOCK with inert rows."""
    tau, T = c["tau"], c["T"]
    df = c["df"]
    z = torch.zeros_like(T)
    shear_on, bulk_on, diff_on = df_switches(cfg)
    if cfg.df_mode == 1:
        k = dict(k_sc=0.5 / (T ** 2 * (c["E"] + c["P"])),
                 k_b0=df.c0 - df.c2, k_b1=df.c1, k_b2=4.0 * df.c2 - df.c0,
                 k_dv=z, k_c3=df.c3, k_c4=df.c4)
    elif cfg.df_mode == 2:
        inv_bb = 1.0 / df.betabulk
        k = dict(k_sc=0.5 / (df.betapi * T), k_b0=df.F / T ** 2 * inv_bb,
                 k_b1=df.G * inv_bb, k_b2=inv_bb / (3.0 * T),
                 k_dv=1.0 / df.betaV, k_c3=z, k_c4=z)
    else:
        raise ValueError("pack_cells handles df modes 1-2")
    for name, on in (("k_sc", shear_on), ("k_b0", bulk_on), ("k_b1", bulk_on),
                     ("k_b2", bulk_on), ("k_dv", diff_on), ("k_c3", diff_on),
                     ("k_c4", diff_on)):
        if not on:
            k[name] = z

    mask = c["valid"].to(T.dtype)
    u0p = torch.sqrt(1.0 + c["ux"] ** 2 + c["uy"] ** 2)
    vals = dict(c, **k)
    vals.update(
        dat=c["dat"] * mask, dax=c["dax"] * mask, day=c["day"] * mask,
        dant=c["dan"] * mask / tau, tun=tau * c["un"], invT=1.0 / T,
        benth=c["baryon_enthalpy_ratio"],
        eta=c["eta"] if cfg.dimension == 3 else z,
        # longitudinal flow rapidity: cosh = u^tau/u0p, sinh = tau u^eta/u0p
        yflow=torch.asinh(tau * c["un"] / u0p))
    cells = torch.stack([vals[name] for name in FIELDS], dim=1)
    pad = -cells.shape[0] % CELL_BLOCK
    if pad or cells.shape[0] == 0:
        pad = pad or CELL_BLOCK
        rows = cells.new_zeros((pad, NF))
        for name in _PAD_ONE_FIELDS:
            rows[:, IDX[name]] = 1.0
        cells = torch.cat([cells, rows])
    return cells.contiguous()


# ------------------------------------------------------------ plain version

def node_delta(g, mom: MomentumConstants, flags: SpectraFlags):
    """Delta = y - eta of the plain block at every (cell, node[, species,
    pT]): 3+1D y_r - eta_c, 2+1D -eta_r, with the 2+1D remap y_flow(cell) -
    s(mT) eta_r.  ``g(name)`` is a per-cell field shaped (c, 1, 1, 1, 1)."""
    S, P = mom.mass.shape[0], mom.pT.shape[0]
    nodes = mom.nodes.view(1, -1, 1, 1, 1)
    if flags.remap:
        return g("yflow") - remap_scale(mom).view(1, 1, S, P, 1) * nodes
    if flags.dimension == 3:
        return nodes - g("eta")
    return -nodes


def emission_terms(g, mom: MomentumConstants, delta: torch.Tensor):
    """(p.dsigma, u.p, pi:pp, V.p) at every (cell, node, species, pT, phi)
    for the rapidity differences ``delta`` (node_delta's shape), from the
    per-cell fields ``g(name)`` of FIELDS' names (the linear-df kinematics
    the feqmod fallback shares)."""
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    mT = torch.sqrt(mom.mass[:, None] ** 2 + mom.pT[None, :] ** 2)
    mT5 = mT.view(1, 1, S, P, 1)
    px5 = mom.px.view(1, 1, 1, P, F)
    py5 = mom.py.view(1, 1, 1, P, F)
    ch, sh = torch.cosh(delta), torch.sinh(delta)
    t_sh = sh * g("tau")
    A1 = ch * g("dat") + sh * g("dant")
    B1 = ch * g("ut") - sh * g("tun")
    C1 = (ch * ch * g("pitt") + t_sh * t_sh * g("pinn")
          - 2.0 * ch * t_sh * g("pitn"))
    C2 = -2.0 * (ch * g("pitx") - t_sh * g("pixn"))
    C3 = -2.0 * (ch * g("pity") - t_sh * g("piyn"))
    D1 = ch * g("Vt") - t_sh * g("Vn")
    W1 = g("dax") * px5 + g("day") * py5
    W2 = g("ux") * px5 + g("uy") * py5
    C4 = (g("pixx") * px5 * px5 + g("piyy") * py5 * py5
          + 2.0 * g("pixy") * px5 * py5)
    D2 = g("Vx") * px5 + g("Vy") * py5

    pds = mT5 * A1 + W1
    pdotu = mT5 * B1 - W2
    pipp = mT5 * mT5 * C1 + mT5 * px5 * C2 + mT5 * py5 * C3 + C4
    Vp = mT5 * D1 - D2
    return pds, pdotu, pipp, Vp


def plain_block(x: torch.Tensor, mom: MomentumConstants,
                flags: SpectraFlags) -> torch.Tensor:
    """p.dsigma f_eq (1 + df) of a chunk of packed cells at every (cell,
    node, species, pT, phi): the (c, R, S, P, F) block, without node
    weights, prefactor or degeneracy (the port of _chunk_contribution's
    reduce=False block)."""
    S = mom.mass.shape[0]
    g = lambda name: x[:, IDX[name]].view(-1, 1, 1, 1, 1)
    sp = lambda v: v.view(1, 1, S, 1, 1)
    sign, bary, m2 = sp(mom.sign), sp(mom.baryon), sp(mom.mass ** 2)
    pds, pdotu, pipp, Vp = emission_terms(g, mom, node_delta(g, mom, flags))

    feq = fermi_bose(pdotu * g("invT") - bary * g("alphaB"), sign)
    feqbar = 1.0 - sign * feq
    if flags.df_mode == 1:
        df = (g("k_sc") * pipp
              + (g("k_b0") * m2 + (g("k_b1") * bary + g("k_b2") * pdotu)
                 * pdotu) * g("bulkPi")
              + (g("k_c3") * bary + g("k_c4") * pdotu) * Vp)
    else:
        r = 1.0 / pdotu
        df = (g("k_sc") * pipp * r
              + (g("k_b0") * pdotu + g("k_b1") * bary
                 + g("k_b2") * (pdotu - m2 * r)) * g("bulkPi")
              + (g("benth") - bary * r) * Vp * g("k_dv"))
    df = feqbar * df
    if flags.regulate:
        df = torch.clamp(df, -1.0, 1.0)
    f = feq * df + feq
    return (torch.clamp(pds, min=0.0) if flags.outflow else pds) * f


def _plain_chunk(x: torch.Tensor, mom: MomentumConstants,
                 flags: SpectraFlags) -> torch.Tensor:
    """Contribution of a chunk of packed cells, the plain_block reduced
    over cells (3+1D: (R, S, P, F)) or over cells and weighted nodes (2+1D:
    (S, P, F), before the remap jacobian)."""
    contrib = plain_block(x, mom, flags)
    if flags.dimension == 3:
        return contrib.sum(0)
    R = mom.nodes.shape[0]
    return (contrib * mom.weights.view(1, R, 1, 1, 1)).sum((0, 1))


def smooth_spectra_plain(cells: torch.Tensor, mom: MomentumConstants,
                         flags: SpectraFlags,
                         cell_chunk: int = 65536) -> torch.Tensor:
    """Plain torch version of the kernel on the same inputs:
    (S, n_pT, n_phi, n_y_out), cells reduced in chunks that keep each
    (chunk, R, S, P, F) block within common.CHUNK_ELEMENT_BUDGET."""
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    R = mom.nodes.shape[0]
    C = cells.shape[0]
    chunk = effective_chunk(cell_chunk, C, R * S * P * F)
    # under autograd each chunk is recomputed in the backward
    # (torch.utils.checkpoint, JAX's remat_scan), so the reverse pass keeps
    # one chunk's block at a time; the sums are the same
    tracked = torch.is_grad_enabled() and cells.requires_grad
    acc = None
    for c0 in range(0, C, chunk):
        x = cells[c0:c0 + chunk]
        if tracked:
            part = torch.utils.checkpoint.checkpoint(
                _plain_chunk, x, mom, flags, use_reentrant=False)
            acc = part if acc is None else acc + part
        else:
            part = _plain_chunk(x, mom, flags)
            acc = part if acc is None else acc.add_(part)
    if flags.dimension == 3:
        out = acc.permute(1, 2, 3, 0)
    else:
        if flags.remap:
            acc = acc * remap_scale(mom)[:, :, None]
        out = acc[..., None]
    deg = mom.degeneracy.view(S, 1, 1, 1)
    return (CF_PREFACTOR * deg * out).contiguous()


# ------------------------------------------------------------- CUDA kernel

def _spectra_library():
    from ..native.build import cuda_library
    lib = cuda_library("smooth_spectra")
    if not getattr(lib, "_is3d_bound", False):
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for fn in (lib.is3d_smooth_spectra_f32, lib.is3d_smooth_spectra_f64):
            fn.restype = ci
            fn.argtypes = [vp, ci, ci,                 # cells, n_cells, nf
                           vp, vp, vp, vp, ci,         # species, n_species
                           vp, vp, vp, ci, ci,         # pT, px, py, n_pT, n_phi
                           vp, vp, ci,                 # nodes, weights, n_nodes
                           ci, ci, ci, ci,             # df, dim, reg, outflow
                           cd, ci, vp,                 # prefactor, n_split, partials
                           vp, vp]                     # out, stream
        for fn in (lib.is3d_smooth_spectra_splits_f32,
                   lib.is3d_smooth_spectra_splits_f64):
            fn.restype = ci
            fn.argtypes = [ci] * 7       # n_cells, S, P, F, R, df, dim
        for fn in (lib.is3d_smooth_spectra_remap_f32,
                   lib.is3d_smooth_spectra_remap_f64):
            fn.restype = ci
            fn.argtypes = [vp, ci, ci,                 # cells, n_cells, nf
                           vp, vp, vp, vp, ci,         # species, n_species
                           vp, ci, vp, vp, ci,         # pT, n_pT, cos, sin, n_phi
                           vp, vp, ci,                 # node table, weights, n_nodes
                           ci, ci, ci,                 # df, reg, outflow
                           cd, cd, ci, ci,             # prefactor, T_ref, split, parts
                           vp, vp, vp]                 # partials, out, stream
        for fn in (lib.is3d_smooth_spectra_remap_grid_f32,
                   lib.is3d_smooth_spectra_remap_grid_f64):
            fn.restype = ci
            fn.argtypes = [ci] * 5 + [ctypes.POINTER(ci)]  # S, P, F, R, df, out
        lib.is3d_cuda_error_string.restype = ctypes.c_char_p
        lib.is3d_cuda_error_string.argtypes = [ci]
        lib._is3d_bound = True
    return lib


@dataclass(frozen=True)
class RemapGrid:
    """The remap kernel's grid for one shape on one card, as the C side
    (csrc/smooth_spectra.cu:remap_grid, the owner of the blocking) reports
    it."""

    blocks: int        # blocks for each range of cells
    slots: int         # blocks the card holds at once
    node_chunks: int   # chunks of nodes: partial sums for each range of cells
    tile: int          # cells per shared-memory tile
    max_split: int     # most ranges of cells
    phi_width: int     # angles per thread: the kernel's instantiation


def remap_grid(lib, device: torch.device, f64: bool, n_species: int,
               n_pT: int, n_phi: int, n_nodes: int, df_mode: int) -> RemapGrid:
    out = (ctypes.c_int * 6)()
    fn = (lib.is3d_smooth_spectra_remap_grid_f64 if f64
          else lib.is3d_smooth_spectra_remap_grid_f32)
    with torch.cuda.device(device):
        rc = fn(n_species, n_pT, n_phi, n_nodes, df_mode, out)
    if rc != 0:
        raise RuntimeError("smooth_spectra remap: no launch configuration: "
                           f"{lib.is3d_cuda_error_string(rc).decode()}")
    return RemapGrid(*out)


def remap_cell_split(n_cells: int, grid: RemapGrid) -> tuple[int, int]:
    """(cells per split, splits) of the remap kernel's grid: whole tiles
    per split, the fewest splits that fill the card's waves
    (launch.split_to_fill)."""
    n_tiles = -(-max(n_cells, 1) // grid.tile)
    per, n_split = split_to_fill(n_tiles, max(grid.blocks, 1), grid.slots,
                                 grid.max_split)
    return per * grid.tile, n_split


def smooth_spectra_cuda(cells: torch.Tensor, mom: MomentumConstants,
                        flags: SpectraFlags,
                        table: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the hand-written kernel (csrc/smooth_spectra.cu) on the
    current stream: (S, n_pT, n_phi, n_y_out) in the cells' dtype.  With
    ``flags.remap`` the angles must be separable as ``momentum_constants``
    builds them (px = pT cos_phi, py = pT sin_phi), and ``table`` is
    ``remap_node_table(mom)``, which depends on ``mom`` alone: a caller
    with many groups builds it once, else it is built here."""
    global LAUNCHES, REMAP_LAUNCHES
    check_float("smooth_spectra_cuda", cells)
    check_tensor("cells", cells, (cells.shape[0], NF), cells)
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    R = mom.nodes.shape[0]
    for name, n in dict(mass=S, sign=S, baryon=S, degeneracy=S, pT=P,
                        px=P * F, py=P * F, nodes=R, weights=R, cos_phi=F,
                        sin_phi=F).items():
        check_tensor(f"momentum constant {name}", getattr(mom, name), (n,),
                     cells)
    remap = flags.dimension == 2 and flags.remap
    if remap and table is not None:
        check_tensor("remap node table", table, (S, P, R, 2), cells)
    require_cuda("smooth_spectra_cuda", cells)
    n_out = R if flags.dimension == 3 else 1
    out = torch.empty((S, P, F, n_out), device=cells.device,
                      dtype=cells.dtype)
    lib = _spectra_library()
    f64 = cells.dtype == torch.float64
    species = (mom.mass.data_ptr(), mom.sign.data_ptr(),
               mom.baryon.data_ptr(), mom.degeneracy.data_ptr(), S)
    if remap:
        # the kernel's grid spans chunks of nodes and ranges of cells (one
        # partial each, folded in order); the split depends on the card
        grid = remap_grid(lib, cells.device, f64, S, P, F, R, flags.df_mode)
        per, n_split = remap_cell_split(cells.shape[0], grid)
        if table is None:
            table = remap_node_table(mom)
        n_parts = n_split * grid.node_chunks
        partial = cells.new_empty((n_parts, S, P, F))
        launch(lib, "smooth_spectra remap",
               lib.is3d_smooth_spectra_remap_f64 if f64
               else lib.is3d_smooth_spectra_remap_f32, cells.device,
               cells.data_ptr(), cells.shape[0], NF, *species,
               mom.pT.data_ptr(), P, mom.cos_phi.data_ptr(),
               mom.sin_phi.data_ptr(), F, table.data_ptr(),
               mom.weights.data_ptr(), R, flags.df_mode,
               int(flags.regulate), int(flags.outflow), CF_PREFACTOR,
               ETA_REMAP_T_REF, per, n_parts, partial.data_ptr(),
               out.data_ptr())
        LAUNCHES += 1
        REMAP_LAUNCHES += 1
        return out
    shape = (cells.shape[0], S, P, F, R, flags.df_mode, flags.dimension)
    # the kernel splits the cells to fill the card's waves (one partial
    # per split, folded in split order); the count depends on the card
    with torch.cuda.device(cells.device):
        n_split = (lib.is3d_smooth_spectra_splits_f64 if f64
                   else lib.is3d_smooth_spectra_splits_f32)(*shape)
    if n_split < 1:
        raise RuntimeError("smooth_spectra: no launch configuration: "
                           f"{lib.is3d_cuda_error_string(-n_split).decode()}")
    partial = (cells.new_empty((n_split, S, P, F, n_out)) if n_split > 1
               else None)
    fn = lib.is3d_smooth_spectra_f64 if f64 else lib.is3d_smooth_spectra_f32
    launch(lib, "smooth_spectra", fn, cells.device,
           cells.data_ptr(), cells.shape[0], NF, *species,
           mom.pT.data_ptr(), mom.px.data_ptr(), mom.py.data_ptr(), P, F,
           mom.nodes.data_ptr(), mom.weights.data_ptr(), R,
           flags.df_mode, flags.dimension,
           int(flags.regulate), int(flags.outflow),
           CF_PREFACTOR, n_split,
           None if partial is None else partial.data_ptr(), out.data_ptr())
    LAUNCHES += 1
    return out


# ------------------------------------------------------ backward kernels

def spectra_bwd_plain(cells: torch.Tensor, G: torch.Tensor,
                      mom: MomentumConstants, flags: SpectraFlags,
                      cell_chunk: int = 65536) -> torch.Tensor:
    """Plain version of the backward kernels: the gradient (Cp, NF) of
    <G, smooth_spectra_plain(cells)> with respect to the packed cells, by
    torch autograd of the plain version."""
    with torch.enable_grad():
        x = cells.detach().requires_grad_(True)
        out = smooth_spectra_plain(x, mom, flags, cell_chunk)
        return torch.autograd.grad(out, x, G)[0]


def _bwd_library():
    from ..native.build import cuda_library
    lib = cuda_library("smooth_spectra_bwd")
    if not getattr(lib, "_is3d_bound", False):
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for fn in (lib.is3d_spectra_bwd_f32, lib.is3d_spectra_bwd_f64):
            fn.restype = ci
            fn.argtypes = [vp, ci, ci,                 # cells, n_cells, nf
                           ci, ci, ci,                 # n_species, n_pT, n_phi
                           vp, vp, vp, vp, ci,         # px, py, nodes, weights, R
                           ci, ci, ci, ci,             # df, dim, reg, outflow
                           ci, vp, vp, vp, vp]         # RU, rows, Gw, grad, stream
        lib.is3d_spectra_bwd_props.restype = ci
        lib.is3d_spectra_bwd_props.argtypes = [ci] * 8 + [vp]
        lib.is3d_spectra_bwd_layout.restype = ci
        lib.is3d_spectra_bwd_layout.argtypes = [ci] * 3 + [vp]
        for fn in (lib.is3d_spectra_bwd_remap_f32,
                   lib.is3d_spectra_bwd_remap_f64):
            fn.restype = ci
            fn.argtypes = [vp, ci, ci,                 # cells, n_cells, nf
                           vp, vp, vp, vp, ci,         # species, n_species
                           vp, ci, vp, vp, ci,         # pT, n_pT, cos, sin, n_phi
                           vp, vp, ci,                 # node table, weights, n_nodes
                           ci, ci, ci,                 # df, reg, outflow
                           cd, cd, vp, vp, vp]         # prefactor, T_ref, G, grad, stream
        lib.is3d_spectra_bwd_remap_props.restype = ci
        lib.is3d_spectra_bwd_remap_props.argtypes = [ci] * 5 + [vp]
        lib.is3d_cuda_error_string.restype = ctypes.c_char_p
        lib.is3d_cuda_error_string.argtypes = [ci]
        lib._is3d_bound = True
    return lib


# what the fixed-node backward kernel's plan reports (csrc/
# smooth_spectra_bwd.cu:fixed_props): launch.PROPS, then the species a
# stage, the angles a thread evaluates at once, the values a species' stage
# row holds and the waves of resident blocks
FIXED_BWD_PLAN = PROPS + ("species_per_stage", "angles", "stage_row",
                          "waves")


def bwd_props(device: torch.device, f64: bool, mom: MomentumConstants,
              flags: SpectraFlags, n_cells: int | None = None) -> dict:
    """The launch shape and resources (launch.kernel_props) of the backward
    kernel of ``flags``' df mode at mom's shape: the remap's (K9b), or with
    fixed nodes K9a's plan for ``n_cells`` cells (FIXED_BWD_PLAN; its
    waves depend on the count).  For reports: spectra_bwd_cuda's launch
    makes its own plan."""
    lib = _bwd_library()
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    R = mom.nodes.shape[0]
    if flags.dimension == 2 and flags.remap:
        return kernel_props(lib, "spectra_bwd remap",
                            lib.is3d_spectra_bwd_remap_props, device,
                            int(f64), flags.df_mode, P, F, R)
    if n_cells is None:
        raise ValueError("the fixed-node backward kernel's plan needs "
                         "n_cells")
    out = (ctypes.c_int * len(FIXED_BWD_PLAN))()
    with torch.cuda.device(device):
        rc = lib.is3d_spectra_bwd_props(int(f64), flags.dimension,
                                        flags.df_mode, S, P, F, R,
                                        max(int(n_cells), 1), out)
    if rc != 0:
        raise RuntimeError("spectra_bwd: no launch configuration: "
                           f"{lib.is3d_cuda_error_string(rc).decode()}")
    return dict(zip(FIXED_BWD_PLAN, out))


def fixed_bwd_stage(G: torch.Tensor, mom: MomentumConstants, angles: int,
                    stage_row: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The fixed-node backward kernel's inputs from the cotangent G (S, P,
    F, n_out), on G's device and dtype: rows (P, S, 4) = mT, m^2, sign,
    baryon of each (pT, species), and Gw (P, ceil(F / angles), S,
    stage_row) = prefactor x degeneracy x G, angles padded with zeros to a
    whole group, each species' (node, angle) values node-major and padded
    with zeros to stage_row, so that one stage of the kernel (a pT row, an
    angle group, a chunk of species) is one contiguous run."""
    S, P, F, R = G.shape
    nfg = -(-F // angles)
    w = (CF_PREFACTOR * mom.degeneracy).to(G.dtype).view(S, 1, 1, 1)
    g = torch.nn.functional.pad(G * w, (0, 0, 0, nfg * angles - F))
    g = g.view(S, P, nfg, angles, R).permute(1, 2, 0, 4, 3)
    g = torch.nn.functional.pad(g.reshape(P, nfg, S, R * angles),
                                (0, stage_row - R * angles))
    m2 = mom.mass ** 2
    mT = torch.sqrt(m2[None, :] + mom.pT[:, None] ** 2)
    rows = torch.stack([mT, m2.expand(P, S), mom.sign.expand(P, S),
                        mom.baryon.expand(P, S)], dim=2)
    return rows.to(G.dtype).contiguous(), g.contiguous()


def spectra_bwd_cuda(cells: torch.Tensor, G: torch.Tensor,
                     mom: MomentumConstants, flags: SpectraFlags,
                     table: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the backward kernel (csrc/smooth_spectra_bwd.cu) on the
    current stream: the gradient (Cp, NF) of <G, smooth_spectra_cuda(cells,
    mom, flags)> with respect to the packed cells, G of the output's shape
    (S, n_pT, n_phi, n_y_out).  With ``flags.remap`` the remap kernel's
    ``table`` (remap_node_table(mom), built here if None)."""
    global BWD_LAUNCHES, BWD_REMAP_LAUNCHES
    check_float("spectra_bwd_cuda", cells)
    check_tensor("cells", cells, (cells.shape[0], NF), cells)
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    R = mom.nodes.shape[0]
    n_out = R if flags.dimension == 3 else 1
    check_tensor("G", G, (S, P, F, n_out), cells)
    for name, n in dict(mass=S, sign=S, baryon=S, degeneracy=S, pT=P,
                        px=P * F, py=P * F, nodes=R, weights=R, cos_phi=F,
                        sin_phi=F).items():
        check_tensor(f"momentum constant {name}", getattr(mom, name), (n,),
                     cells)
    remap = flags.dimension == 2 and flags.remap
    if remap and table is not None:
        check_tensor("remap node table", table, (S, P, R, 2), cells)
    require_cuda("spectra_bwd_cuda", cells)
    grad = torch.empty_like(cells)
    lib = _bwd_library()
    f64 = cells.dtype == torch.float64
    if remap:
        if table is None:
            table = remap_node_table(mom)
        launch(lib, "spectra_bwd remap",
               lib.is3d_spectra_bwd_remap_f64 if f64
               else lib.is3d_spectra_bwd_remap_f32, cells.device,
               cells.data_ptr(), cells.shape[0], NF, mom.mass.data_ptr(),
               mom.sign.data_ptr(), mom.baryon.data_ptr(),
               mom.degeneracy.data_ptr(), S, mom.pT.data_ptr(), P,
               mom.cos_phi.data_ptr(), mom.sin_phi.data_ptr(), F,
               table.data_ptr(), mom.weights.data_ptr(), R, flags.df_mode,
               int(flags.regulate), int(flags.outflow), CF_PREFACTOR,
               ETA_REMAP_T_REF, G.data_ptr(), grad.data_ptr())
        BWD_LAUNCHES += 1
        BWD_REMAP_LAUNCHES += 1
        return grad
    if cells.shape[0] == 0 or S == 0 or P == 0 or F == 0:
        return grad.zero_()           # no term: the plan needs a point
    layout = (ctypes.c_int * 2)()
    lib.is3d_spectra_bwd_layout(int(f64), flags.dimension, R, layout)
    angles, stage_row = layout
    rows, Gw = fixed_bwd_stage(G, mom, angles, stage_row)
    launch(lib, "spectra_bwd",
           lib.is3d_spectra_bwd_f64 if f64 else lib.is3d_spectra_bwd_f32,
           cells.device, cells.data_ptr(), cells.shape[0], NF, S, P, F,
           mom.px.data_ptr(), mom.py.data_ptr(), mom.nodes.data_ptr(),
           mom.weights.data_ptr(), R, flags.df_mode, flags.dimension,
           int(flags.regulate), int(flags.outflow), stage_row,
           rows.data_ptr(), Gw.data_ptr(), grad.data_ptr())
    BWD_LAUNCHES += 1
    return grad


class _SpectraKernel(torch.autograd.Function):
    """smooth_spectra_cuda with its backward kernel: the forward keeps only
    the packed cells (as JAX's remat keeps a chunk's inputs), and the
    backward recomputes everything else inside spectra_bwd_cuda."""

    @staticmethod
    def forward(ctx, cells, mom, flags, table):
        ctx.save_for_backward(cells)
        ctx.mom, ctx.flags, ctx.table = mom, flags, table
        return smooth_spectra_cuda(cells, mom, flags, table)

    @staticmethod
    def backward(ctx, G):
        (cells,) = ctx.saved_tensors
        return (spectra_bwd_cuda(cells, G.contiguous(), ctx.mom, ctx.flags,
                                 ctx.table), None, None, None)


def group_spectra(cells: torch.Tensor, mom: MomentumConstants,
                  flags: SpectraFlags, table: torch.Tensor | None = None,
                  cell_chunk: int = 65536) -> torch.Tensor:
    """One group's spectra from its packed cells on their device: the
    kernel (with its backward kernel under autograd) for CUDA tensors, the
    plain version (autograd through it) for CPU tensors."""
    if cells.device.type == "cuda":
        if torch.is_grad_enabled() and cells.requires_grad:
            return _SpectraKernel.apply(cells, mom, flags, table)
        return smooth_spectra_cuda(cells, mom, flags, table)
    if cells.device.type == "cpu":
        return smooth_spectra_plain(cells, mom, flags, cell_chunk)
    raise ValueError(f"no spectra path for device {cells.device}")


# ------------------------------------------------------------ entry point

def _group_spectra(cols: dict, mom: MomentumConstants, flags: SpectraFlags,
                   df_data: DeltafData, table: torch.Tensor | None,
                   cfg: Config) -> torch.Tensor:
    cells = pack_cells(prepare_cells(cols, cfg, df_data), cfg)
    return group_spectra(cells, mom, flags, table, cfg.cell_chunk)


def spectra_reduction(cols: dict, species: SpeciesArrays, grid: MomentumGrid,
                      df_data: DeltafData, cfg: Config) -> tuple:
    """(kernel_fn, replicated) of the linear-df spectra's cell reduction
    over ``cols`` (the whole surface's or a rank's slice)."""
    flags = spectra_flags(cfg, grid)
    mom = momentum_constants(species, grid, cfg.dimension)
    # the remap kernel's node table, once for every group
    table = (remap_node_table(mom)
             if flags.remap and cols["tau"].device.type == "cuda" else None)
    return ((lambda c, m, fl, d, t: _group_spectra(c, m, fl, d, t, cfg)),
            (mom, flags, df_data, table))


def smooth_spectra(surface, species: SpeciesArrays, grid: MomentumGrid,
                   df_data: DeltafData, cfg: Config,
                   mesh=None) -> torch.Tensor:
    """dN/(pT dpT dphi dy) with linear df (modes 1-2), shape
    (S, n_pT, n_phi, n_y_out), on the surface's device.

    The cell reduction runs through the canonical group tree
    (parallel/mesh.grouped_cell_reduce): one kernel launch per group,
    partials folded in group order; with ``mesh`` (a CellMesh) each rank
    launches its own groups and returns the full spectra."""
    from ..parallel.mesh import grouped_cell_reduce
    cols = surface_columns(surface, cfg)
    fn, replicated = spectra_reduction(cols, species, grid, df_data, cfg)
    return grouped_cell_reduce(fn, cols, replicated, cfg, mesh=mesh)
