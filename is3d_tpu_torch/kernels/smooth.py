"""Smooth Cooper-Frye spectra: dN / (pT dpT dphi dy), linear df modes 1-2.

Port of ``is3d_tpu.kernels.smooth`` (the reference's hot loop,
emissionfunction_smooth_kernels.cpp:28-393).  One group of cells goes
through three steps:

1. ``prepare_cells`` completes the hydro fields and evaluates the df
   coefficients per cell (kernels/common.py);
2. ``pack_cells`` folds them into the kernel's input, a (Cp, NF) matrix of
   per-cell scalars (Cp a multiple of CELL_BLOCK, pad rows inert);
3. ``smooth_spectra_cuda`` (the hand-written kernel csrc/smooth_spectra.cu)
   reduces the group for CUDA tensors, ``smooth_spectra_plain`` (chunked
   tensor algebra, the port of ``_chunk_contribution``) for CPU tensors.

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

from ..units import CF_PREFACTOR
from ..config import Config
from ..data import SpeciesArrays
from ..io.tables import MomentumGrid
from ..io.deltaf import DeltafData
from ..tensors import TensorContainer
from .common import surface_columns, prepare_cells, fermi_bose, effective_chunk
from .launch import check_float, check_tensor, require_cuda, launch

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

# launches of the CUDA kernel in this process (smooth_spectra_cuda)
LAUNCHES = 0

# per (cell, species, pT, phi, rapidity) evaluation of the 3+1D float32
# kernel, by df mode, counted in its sm_90a SASS (the cell loop's body:
# FFMA, FMUL, FADD, FSETP, FSEL, FMNMX, ... and MUFU.EX2 + MUFU.RCP); the
# body issues 134 (df 1) and 159 (df 2) instructions in all, 24 of them
# shared-memory loads.  chip_smoke.py divides these by the card's FP32
# and SFU issue rates for the kernel's bound
FP32_PER_EVAL = {1: 46, 2: 56}
SFU_PER_EVAL = {1: 2, 2: 3}


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
    px = grid.pT[:, None] * torch.cos(grid.phi)[None, :]
    py = grid.pT[:, None] * torch.sin(grid.phi)[None, :]
    nodes, weights = ((grid.y, torch.ones_like(grid.y)) if dimension == 3
                      else (grid.eta, grid.eta_weight))
    c = lambda t: t.contiguous()
    return MomentumConstants(
        mass=c(species.mass), sign=c(species.sign), baryon=c(species.baryon),
        degeneracy=c(species.degeneracy), pT=c(grid.pT),
        px=px.reshape(P * F).contiguous(), py=py.reshape(P * F).contiguous(),
        nodes=nodes.contiguous(), weights=weights.contiguous(), n_phi=F)


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

def plain_block(x: torch.Tensor, mom: MomentumConstants,
                flags: SpectraFlags) -> torch.Tensor:
    """p.dsigma f_eq (1 + df) of a chunk of packed cells at every (cell,
    node, species, pT, phi): the (c, R, S, P, F) block, without node
    weights, prefactor or degeneracy (the port of _chunk_contribution's
    reduce=False block)."""
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    R = mom.nodes.shape[0]
    g = lambda name: x[:, IDX[name]].view(-1, 1, 1, 1, 1)
    mT = torch.sqrt(mom.mass[:, None] ** 2 + mom.pT[None, :] ** 2)
    mT5 = mT.view(1, 1, S, P, 1)
    px5 = mom.px.view(1, 1, 1, P, F)
    py5 = mom.py.view(1, 1, 1, P, F)
    sp = lambda v: v.view(1, 1, S, 1, 1)
    sign, bary, m2 = sp(mom.sign), sp(mom.baryon), sp(mom.mass ** 2)
    nodes = mom.nodes.view(1, R, 1, 1, 1)

    if flags.remap:
        s = torch.sqrt(ETA_REMAP_T_REF / torch.clamp(mT, min=ETA_REMAP_T_REF))
        delta = g("yflow") - s.view(1, 1, S, P, 1) * nodes
    elif flags.dimension == 3:
        delta = nodes - g("eta")
    else:
        delta = -nodes
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
    acc = None
    for c0 in range(0, C, chunk):
        part = _plain_chunk(cells[c0:c0 + chunk], mom, flags)
        acc = part if acc is None else acc.add_(part)
    if flags.dimension == 3:
        out = acc.permute(1, 2, 3, 0)
    else:
        if flags.remap:
            mT = torch.sqrt(mom.mass[:, None] ** 2 + mom.pT[None, :] ** 2)
            s = torch.sqrt(ETA_REMAP_T_REF
                           / torch.clamp(mT, min=ETA_REMAP_T_REF))
            acc = acc * s[:, :, None]
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
                           ci, ci, ci, ci, ci,         # df, dim, remap, reg, outflow
                           cd, cd,                     # prefactor, T_ref
                           vp, vp]                     # out, stream
        lib.is3d_cuda_error_string.restype = ctypes.c_char_p
        lib.is3d_cuda_error_string.argtypes = [ci]
        lib._is3d_bound = True
    return lib


def smooth_spectra_cuda(cells: torch.Tensor, mom: MomentumConstants,
                        flags: SpectraFlags) -> torch.Tensor:
    """Launch the hand-written kernel (csrc/smooth_spectra.cu) on the
    current stream: (S, n_pT, n_phi, n_y_out) in the cells' dtype."""
    global LAUNCHES
    check_float("smooth_spectra_cuda", cells)
    check_tensor("cells", cells, (cells.shape[0], NF), cells)
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    R = mom.nodes.shape[0]
    for name, n in dict(mass=S, sign=S, baryon=S, degeneracy=S, pT=P,
                        px=P * F, py=P * F, nodes=R, weights=R).items():
        check_tensor(f"momentum constant {name}", getattr(mom, name), (n,),
                     cells)
    require_cuda("smooth_spectra_cuda", cells)
    n_out = R if flags.dimension == 3 else 1
    out = torch.empty((S, P, F, n_out), device=cells.device,
                      dtype=cells.dtype)
    lib = _spectra_library()
    fn = (lib.is3d_smooth_spectra_f32 if cells.dtype == torch.float32
          else lib.is3d_smooth_spectra_f64)
    launch(lib, "smooth_spectra", fn, cells.device,
           cells.data_ptr(), cells.shape[0], NF,
           mom.mass.data_ptr(), mom.sign.data_ptr(),
           mom.baryon.data_ptr(), mom.degeneracy.data_ptr(), S,
           mom.pT.data_ptr(), mom.px.data_ptr(), mom.py.data_ptr(), P, F,
           mom.nodes.data_ptr(), mom.weights.data_ptr(), R,
           flags.df_mode, flags.dimension, int(flags.remap),
           int(flags.regulate), int(flags.outflow),
           CF_PREFACTOR, ETA_REMAP_T_REF, out.data_ptr())
    LAUNCHES += 1
    return out


# ------------------------------------------------------------ entry point

def _group_spectra(cols: dict, mom: MomentumConstants, flags: SpectraFlags,
                   df_data: DeltafData, cfg: Config) -> torch.Tensor:
    cells = pack_cells(prepare_cells(cols, cfg, df_data), cfg)
    if cells.device.type == "cuda":
        return smooth_spectra_cuda(cells, mom, flags)
    if cells.device.type == "cpu":
        return smooth_spectra_plain(cells, mom, flags, cfg.cell_chunk)
    raise ValueError(f"no spectra path for device {cells.device}")


def smooth_spectra(surface, species: SpeciesArrays, grid: MomentumGrid,
                   df_data: DeltafData, cfg: Config) -> torch.Tensor:
    """dN/(pT dpT dphi dy) with linear df (modes 1-2), shape
    (S, n_pT, n_phi, n_y_out), on the surface's device.

    The cell reduction runs through the canonical group tree
    (parallel/mesh.grouped_cell_reduce): one kernel launch per group,
    partials folded in group order."""
    from ..parallel.mesh import grouped_cell_reduce
    flags = spectra_flags(cfg, grid)
    mom = momentum_constants(species, grid, cfg.dimension)
    cols = surface_columns(surface, cfg)
    return grouped_cell_reduce(
        lambda c, m, fl, d: _group_spectra(c, m, fl, d, cfg),
        cols, (mom, flags, df_data), cfg)
