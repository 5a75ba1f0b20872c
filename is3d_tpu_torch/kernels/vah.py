"""Anisotropic-hydro (VAH) smooth Cooper-Frye spectra, mode 2-3 surfaces.

Port of ``is3d_tpu.kernels.vah`` (the reference's
calculate_dN_pTdpTdphidy_VAH_PL, emissionfunction_smooth_kernels.cpp:
2140-2393).  The anisotropic distribution

    f_a = 1 / (exp(sqrt((u.p)^2 + xi_L (z.p)^2) / Lambda) + sign),
    xi_L = 1/a_L^2 - 1

with the residual 14-moment corrections

    df = c3 (z.p)(W.p) + c4 pi_perp:pp          (shear)
       + (c0 m^2 + c1 (z.p)^2 + c2 (u.p)^2) Pi  (bulk)

and f = f_a (1 + clip(fabar df, -1, 1)) (regulated) or f_a (1 + fabar df).
Every cell emits (no u.dsigma filter); pad cells of the canonical group
tree have dsigma = 0, Lambda = a_L = 1 and emit exactly 0.

One group of cells goes through:

1. ``complete_vah_cells``: u^tau, the longitudinal basis vector z^mu and
   the W^mu orthogonality completion, torch on the device;
2. ``pack_vah_cells``: the kernels' input, a (C, NV) matrix of per-cell
   scalars (field order VF_FIELDS), c4 folded into pi_perp and Pi into
   c0..c2;
3. ``vah_spectra_cuda`` (csrc/vah.cu: ``fixed_kernel`` at fixed nodes,
   ``remap_kernel`` with the 2+1D mT remap) for CUDA tensors,
   ``vah_spectra_plain`` for CPU tensors.  The group partials are folded by
   ``parallel.mesh.grouped_cell_reduce``.

The residual chains are switches of the launch: ``effective_vah_cfg``
drops a chain whose coefficient columns are exact zeros (every real
mode-2/3 surface: no VAH format carries c0..c4), which leaves the
production case, f_a alone.

2+1D remap: the eta nodes move per (cell, species, pT) to Delta = y_flow
- s eta_r with s = a_L sqrt(Lambda / max(mT, Lambda)), the width of the
anisotropic integrand in y - eta; the jacobian s multiplies inside the
cell sum.
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
from ..physics import lrf
from .common import fermi_bose, effective_chunk
from .launch import (check_float, check_tensor, require_cuda, launch,
                     kernel_grid, kernel_props, tile_split)
from .smooth import MomentumConstants, momentum_constants

# per-cell scalar field order of the packed (C, NV) matrix; the CUDA
# header's `enum VahField` (csrc/vah.cuh) must list the same names in the
# same order.  k* = c4 pi_perp^munu; bc* = Pi c0..c2
VF_FIELDS = (
    "tau", "eta", "dat", "dant", "dax", "day", "ut", "tun", "zt", "tzn",
    "ux", "uy", "xiL", "invLam", "aL", "Lam", "yflow",
    "c3", "Wt", "tWn", "Wx", "Wy", "kpitt", "kpinn", "kpitn", "kpitx",
    "kpixn", "kpity", "kpiyn", "kpixx", "kpiyy", "kpixy",
    "bc0", "bc1", "bc2")
NV = len(VF_FIELDS)
VF = {n: i for i, n in enumerate(VF_FIELDS)}

# launches of the CUDA kernels in this process: at fixed nodes
# (fixed_kernel) and with the 2+1D mT remap (remap_kernel); and of the
# backward kernels (vah_bwd_cuda: csrc/vah_bwd.cu), fixed nodes and remap
LAUNCHES = 0
REMAP_LAUNCHES = 0
BWD_LAUNCHES = 0
BWD_REMAP_LAUNCHES = 0

# The bound's yardstick, counted once from the formula, an FMA as one
# operation, factors of fewer indices hoisted.  Per evaluation (cell,
# node, species, momentum point), (FP32, SFU):
#   f_a:   p.dsigma 1, u.p 1, E_a^2 = (u.p)^2 + mT^2 xi_L Z1^2 2 (xi_L Z1^2
#          per (cell, node)) | sqrt (SFU), E_a / Lambda 1 | exp (SFU),
#          + sign 1 | 1/(...) (SFU), max(p.dsigma, 0) 1, x f 1, the
#          weighted sum 1                                         = (9, 3)
#   shear: pi:pp 2 (px C2 + py C3 per (cell, node, point)), W.p 1,
#          c3 (z.p)(W.p) 2                                        = 5
#   bulk:  Pi c1 (z.p)^2 1 (per (cell, node) x mT^2), Pi c2 (u.p)^2 2
#          (Pi c0 m^2 per (cell, species))                         = 3
#   a chain on: fabar 1, fabar df 1, clip 2, f_a clip + f_a 1      = 5
EMISSION_OPS = (9, 3)
SHEAR_OPS = 5
BULK_OPS = 3
DF_OPS = 5
# The 2+1D remap: (u.p)^2 + xi_L (z.p)^2 takes one FMA (xi_L (z.p)^2 per
# (cell, node, species, pT)), and per (cell, node, species, pT), shared by
# the n_phi angles: s eta_r 1, exp (SFU), x e^y_flow 1, e^-Delta = 1/e^Delta
# (SFU), p.dsigma's, u.p's and z.p's node terms 2 each, xi_L (z.p)^2 2, the
# weight x s 1; with shear pi:pp's mT^2 C1 6, W.p's E1 2, pT ch and pT sh
# 2; with bulk Pi c1 (z.p)^2 1.
REMAP_NODE_OPS = (12, 2)
REMAP_SHEAR_NODE_OPS = 10
REMAP_BULK_NODE_OPS = 1


def vah_formula_ops(flags: "VahFlags", n_phi: int) -> tuple[float, float]:
    """(FP32, SFU) per evaluation of a launch with ``flags``: the yardstick
    above plus, with the remap, the node kinematics' share of one of n_phi
    points."""
    fp32, sfu = EMISSION_OPS
    if flags.shear:
        fp32 += SHEAR_OPS
    if flags.bulk:
        fp32 += BULK_OPS
    if flags.shear or flags.bulk:
        fp32 += DF_OPS
    if not flags.remap:
        return float(fp32), float(sfu)
    node = REMAP_NODE_OPS[0] + (REMAP_SHEAR_NODE_OPS if flags.shear else 0) \
        + (REMAP_BULK_NODE_OPS if flags.bulk else 0)
    return fp32 - 1 + node / n_phi, sfu + REMAP_NODE_OPS[1] / n_phi


# The backward kernels' yardstick (csrc/vah_bwd.cu), counted from the
# formula as EMISSION_OPS is, an FMA as one operation.  Per evaluation
# (cell, node, species, point), (FP32, SFU):
#   f_a:   the forward's recomputed value: p.dsigma 2, u.p 2, E_a^2 1 |
#          sqrt, the exponent 1 | exp, + sign 1 | 1/(...), 1 - sign f_a 1,
#          max(p.dsigma, 0) 1, the outflow mask 1 (10, 3); the chain: g = G
#          w 1, g f 1, g max(p.dsigma, 0) 1, g_arg 3, its sum (E_a) 1,
#          g_arg / Lambda / E_a 2 | 1/E_a, g_u.p 1, g_z.p 2, xi_L's sum 3,
#          the point sums (p.dsigma 3, u.p 3, z.p 1) 7 (22, 1)   = (32, 4)
#   a chain on: fabar df 1, clip 2, f_a clip + f_a 1, the clip mask 2,
#          g_f_a 3, g_df 1                                       = 10
#   shear: pi:pp 5, W.p 2, c3 (z.p)(W.p) 2; g_W.p 2, g_z.p 2, c3's sum 2,
#          pi:pp's point sums (g, g px, g py, g px^2, g py^2, g px py) 9,
#          W.p's (g, g px, g py) 5                               = 29
#   bulk:  the three terms 4; their sums 5, g_z.p 2, g_u.p 2     = 13
# Per row (species, pT) of a thread, shared by its n_phi points: mT 1 |
# sqrt, the node kinematics 2 and the composites (3, with shear 14 more),
# the float64 sums the row adds (12, with shear 20 more, with bulk 3) and
# the node derivative's (8, with shear 14 more); with the remap the scale
# s, its derivative, the node's exp and reciprocal (6 | 3 SFU) and the
# scale's three sums 6.
VAH_BWD_OPS = (32, 4)
VAH_BWD_CHAIN_OPS = 10
VAH_BWD_SHEAR_OPS = 29
VAH_BWD_BULK_OPS = 13
VAH_BWD_ROW_OPS = (25, 1)
VAH_BWD_ROW_SHEAR_OPS = 48
VAH_BWD_ROW_BULK_OPS = 3
VAH_BWD_ROW_REMAP_OPS = (12, 3)


def vah_backward_formula_ops(flags: "VahFlags", n_phi: int
                             ) -> tuple[float, float]:
    """(FP32, SFU) per evaluation of a backward launch with ``flags``: the
    yardstick above plus the row's share of one of n_phi points."""
    fp32, sfu = VAH_BWD_OPS
    rf, rs = VAH_BWD_ROW_OPS
    if flags.shear or flags.bulk:
        fp32 += VAH_BWD_CHAIN_OPS
    if flags.shear:
        fp32, rf = fp32 + VAH_BWD_SHEAR_OPS, rf + VAH_BWD_ROW_SHEAR_OPS
    if flags.bulk:
        fp32, rf = fp32 + VAH_BWD_BULK_OPS, rf + VAH_BWD_ROW_BULK_OPS
    if flags.remap:
        fp32 += 2
        rf, rs = rf + VAH_BWD_ROW_REMAP_OPS[0], rs + VAH_BWD_ROW_REMAP_OPS[1]
    return fp32 + rf / n_phi, sfu + rs / n_phi


@dataclass(frozen=True)
class VahFlags:
    dimension: int
    remap: bool
    shear: bool
    bulk: bool
    regulate: bool
    outflow: bool

    @property
    def switches(self) -> int:
        """The residual chains as the kernels' bit mask: shear 1, bulk 2."""
        return int(self.shear) | 2 * int(self.bulk)


def vah_flags(cfg: Config, grid: MomentumGrid) -> VahFlags:
    """The launch flags of ``cfg`` (after ``effective_vah_cfg``)."""
    return VahFlags(dimension=int(cfg.dimension),
                    remap=bool(cfg.dimension == 2 and grid.eta_mT_rescale),
                    shear=bool(cfg.include_shear_deltaf),
                    bulk=bool(cfg.include_bulk_deltaf),
                    regulate=bool(cfg.regulate_deltaf),
                    outflow=bool(cfg.outflow))


# ------------------------------------------------------ per-cell algebra

_OPTIONAL = ("pitt", "pitx", "pity", "pitn", "pixx", "pixy", "pixn", "piyy",
             "piyn", "pinn", "bulkPi", "Wx", "Wy", "c0", "c1", "c2", "c3",
             "c4")


def vah_surface_cols(surface) -> dict:
    """Column dict for the VAH kernels from a mode-2/3 Surface (zeros for
    absent optional fields; raises without Lambda/aL)."""
    if surface.Lambda is None or surface.aL is None:
        raise ValueError("VAH kernel needs Lambda and aL (mode 2/3 surface)")
    z = torch.zeros_like(surface.tau)
    cols = {k: getattr(surface, k) for k in ("tau", "dat", "dax", "day",
                                             "dan", "ux", "uy", "un")}
    cols["eta"] = surface.eta if surface.eta is not None else z
    for name in _OPTIONAL:
        v = getattr(surface, name, None)
        cols[name] = v if v is not None else z
    cols["Lambda"] = surface.Lambda
    cols["aL"] = surface.aL
    return cols


def _any_nonzero(*cols) -> bool:
    """Can any of ``cols`` be nonzero?  A column that requires grad (under
    grad mode) counts as nonzero, as a JAX tracer does: its chain is kept
    and its gradient is exact, also where its values are zeros.  Else one
    device-to-host read: does any hold a nonzero?"""
    if torch.is_grad_enabled() and any(c.requires_grad for c in cols):
        return True
    return bool(torch.count_nonzero(torch.stack(cols)).item())


def effective_vah_cfg(cols: dict, cfg: Config) -> Config:
    """Drop the VAH residual-df chains whose coefficient columns are exact
    zeros from the launch (bit-identical: the dropped terms are exact
    zeros), as is3d_tpu's effective_vah_cfg does; one count of nonzeros
    per column group, none for a group with a column under grad (kept, as
    JAX keeps a traced column).  ``cfg.vah_df_gate = 0`` keeps the
    chains."""
    if not (cfg.vah_df_gate and cfg.mode in (2, 3)):
        return cfg
    shear = bool(cfg.include_shear_deltaf) and _any_nonzero(cols["c3"],
                                                             cols["c4"])
    bulk = (bool(cfg.include_bulk_deltaf) and _any_nonzero(cols["bulkPi"])
            and _any_nonzero(cols["c0"], cols["c1"], cols["c2"]))
    return _gate(cfg, shear, bulk)


def _gate(cfg: Config, shear: bool, bulk: bool) -> Config:
    if (shear, bulk) != (bool(cfg.include_shear_deltaf),
                         bool(cfg.include_bulk_deltaf)):
        cfg = cfg.replace(include_shear_deltaf=int(shear),
                          include_bulk_deltaf=int(bulk))
    return cfg


def agreed_vah_cfg(cols: dict, cfg: Config, mesh) -> Config:
    """effective_vah_cfg's decision from every rank's slice of the columns
    (parallel/multihost.py): one all_reduce(MAX) of the rank's three flags
    (c3/c4, bulkPi and c0..c2 nonzero), so every rank launches the
    instantiation the one-process run launches (is3d_tpu leaves the gate
    off on its slice-local path)."""
    if not (cfg.vah_df_gate and cfg.mode in (2, 3)):
        return cfg
    from ..parallel.mesh import all_reduce_max
    on_s, on_b = bool(cfg.include_shear_deltaf), bool(cfg.include_bulk_deltaf)
    shear, pi, coef = all_reduce_max(
        [on_s and _any_nonzero(cols["c3"], cols["c4"]),
         on_b and _any_nonzero(cols["bulkPi"]),
         on_b and _any_nonzero(cols["c0"], cols["c1"], cols["c2"])], mesh)
    return _gate(cfg, shear, pi and coef)


def complete_vah_cells(cols: dict) -> dict:
    """Per-cell completion: u^tau, the longitudinal basis vector z = (zt,
    0, 0, zn), and the W^mu orthogonality completion (reference:
    emissionfunction_smooth_kernels.cpp:2247-2251)."""
    c = dict(cols)
    tau = c["tau"]
    ut = lrf.u_tau(c["ux"], c["uy"], c["un"], tau)
    u0 = torch.sqrt(1.0 + c["ux"] ** 2 + c["uy"] ** 2)
    c["ut"] = ut
    c["zt"] = tau * c["un"] / u0
    c["zn"] = ut / (u0 * tau)
    c["Wt"] = (c["ux"] * c["Wx"] + c["uy"] * c["Wy"]) * ut / (u0 * u0)
    c["Wn"] = c["Wt"] * c["un"] / ut
    return c


def pack_vah_cells(c: dict, flags: VahFlags) -> torch.Tensor:
    """(C, NV) kernel input from ``complete_vah_cells`` output (3+1D keeps
    the cells' eta; 2+1D takes 0)."""
    tau = c["tau"]
    c4, bulk = c["c4"], c["bulkPi"]
    vals = dict(c)
    vals.update(
        eta=c["eta"] if flags.dimension == 3 else torch.zeros_like(tau),
        dant=c["dan"] / tau, tun=tau * c["un"], tzn=tau * c["zn"],
        xiL=1.0 / (c["aL"] ** 2) - 1.0, invLam=1.0 / c["Lambda"],
        Lam=c["Lambda"], yflow=lrf.flow_rapidity(tau, c["ut"], c["un"]),
        tWn=tau * c["Wn"],
        **{f"k{n}": c4 * c[n] for n in ("pitt", "pinn", "pitn", "pitx",
                                         "pixn", "pity", "piyn", "pixx",
                                         "piyy", "pixy")},
        bc0=bulk * c["c0"], bc1=bulk * c["c1"], bc2=bulk * c["c2"])
    return torch.stack([vals[n] for n in VF_FIELDS], dim=1).contiguous()


# ------------------------------------------------------------ plain version

def remap_vah_scale(x: torch.Tensor, mom: MomentumConstants) -> torch.Tensor:
    """s = a_L sqrt(Lambda / max(mT, Lambda)) per (cell, species, pT),
    (c, S, P): the remap's node scale and its jacobian."""
    mT = torch.sqrt(mom.mass[:, None] ** 2 + mom.pT[None, :] ** 2)
    lam = x[:, VF["Lam"]].view(-1, 1, 1)
    return x[:, VF["aL"]].view(-1, 1, 1) * torch.sqrt(
        lam / torch.maximum(mT[None], lam))


def vah_block(x: torch.Tensor, mom: MomentumConstants,
              flags: VahFlags) -> torch.Tensor:
    """p.dsigma f of a chunk of packed cells at every (cell, node, species,
    pT, phi): the (c, R, S, P, F) block, without node weights, prefactor
    or degeneracy (the port of _chunk_vah_spectra's reduce=False block;
    with the remap at the cell's own nodes)."""
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    g = lambda name: x[:, VF[name]].view(-1, 1, 1, 1, 1)
    sp = lambda t: t.view(1, 1, S, 1, 1)
    mT = torch.sqrt(mom.mass[:, None] ** 2 + mom.pT[None, :] ** 2)
    mT5 = mT.view(1, 1, S, P, 1)
    px5 = mom.px.view(1, 1, 1, P, F)
    py5 = mom.py.view(1, 1, 1, P, F)
    nodes = mom.nodes.view(1, -1, 1, 1, 1)
    if flags.remap:
        delta = g("yflow") - remap_vah_scale(x, mom)[:, None, :, :, None] \
            * nodes
    elif flags.dimension == 3:
        delta = nodes - g("eta")
    else:
        delta = -nodes
    ch, sh = torch.cosh(delta), torch.sinh(delta)

    pds = mT5 * (ch * g("dat") + sh * g("dant")) + (g("dax") * px5
                                                     + g("day") * py5)
    pdu = mT5 * (ch * g("ut") - sh * g("tun")) - (g("ux") * px5
                                                   + g("uy") * py5)
    zp = mT5 * (ch * g("zt") - sh * g("tzn"))
    Ea = torch.sqrt(pdu * pdu + g("xiL") * zp * zp)
    sign = sp(mom.sign)
    fa = fermi_bose(Ea * g("invLam"), sign)

    df = None
    if flags.shear:
        tsh = sh * g("tau")
        C1 = (ch * ch * g("kpitt") + tsh * tsh * g("kpinn")
              - 2.0 * ch * tsh * g("kpitn"))
        C2 = -2.0 * (ch * g("kpitx") - tsh * g("kpixn"))
        C3 = -2.0 * (ch * g("kpity") - tsh * g("kpiyn"))
        C4 = (g("kpixx") * px5 * px5 + g("kpiyy") * py5 * py5
              + 2.0 * g("kpixy") * px5 * py5)
        pipp = mT5 * mT5 * C1 + mT5 * (px5 * C2 + py5 * C3) + C4
        Wp = mT5 * (ch * g("Wt") - sh * g("tWn")) - (g("Wx") * px5
                                                      + g("Wy") * py5)
        df = pipp + g("c3") * zp * Wp
    if flags.bulk:
        dfb = (g("bc0") * sp(mom.mass ** 2) + g("bc1") * zp * zp
               + g("bc2") * pdu * pdu)
        df = dfb if df is None else df + dfb
    if df is None:
        f = fa
    else:
        d = (1.0 - sign * fa) * df
        if flags.regulate:
            d = torch.clamp(d, -1.0, 1.0)
        f = fa * d + fa
    return (torch.clamp(pds, min=0.0) if flags.outflow else pds) * f


def _plain_chunk(x: torch.Tensor, mom: MomentumConstants,
                 flags: VahFlags) -> torch.Tensor:
    """A chunk's vah_block reduced over cells (3+1D: (R, S, P, F)) or over
    cells and weighted nodes (2+1D: (S, P, F))."""
    block = vah_block(x, mom, flags)
    if flags.dimension == 3:
        return block.sum(0)
    R = mom.nodes.shape[0]
    w = mom.weights.view(1, R, 1, 1, 1)
    if flags.remap:
        # the jacobian of the eta -> y_flow - s eta_r substitution, per
        # cell: inside the cell sum
        w = w * remap_vah_scale(x, mom)[:, None, :, :, None]
    return (block * w).sum((0, 1))


def vah_spectra_plain(x: torch.Tensor, mom: MomentumConstants,
                      flags: VahFlags,
                      cell_chunk: int = 65536) -> torch.Tensor:
    """Plain torch version of the kernels on the same inputs:
    (S, n_pT, n_phi, n_y_out), cells reduced in chunks whose block (of
    about 4 live copies) stays within common.CHUNK_ELEMENT_BUDGET."""
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    R = mom.nodes.shape[0]
    C = x.shape[0]
    chunk = effective_chunk(cell_chunk, C, 4 * R * S * P * F)
    # under autograd each chunk is recomputed in the backward
    # (torch.utils.checkpoint, JAX's remat_scan)
    tracked = torch.is_grad_enabled() and x.requires_grad
    acc = None
    for c0 in range(0, max(C, 1), chunk):
        xc = x[c0:c0 + chunk]
        if tracked:
            part = torch.utils.checkpoint.checkpoint(
                _plain_chunk, xc, mom, flags, use_reentrant=False)
            acc = part if acc is None else acc + part
        else:
            part = _plain_chunk(xc, mom, flags)
            acc = part if acc is None else acc.add_(part)
    out = acc.permute(1, 2, 3, 0) if flags.dimension == 3 else acc[..., None]
    deg = mom.degeneracy.view(S, 1, 1, 1)
    return (CF_PREFACTOR * deg * out).contiguous()


# ------------------------------------------------------------- CUDA kernel

def _library():
    from ..native.build import cuda_library
    lib = cuda_library("vah")
    if not getattr(lib, "_is3d_bound", False):
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for fn in (lib.is3d_vah_grid_f32, lib.is3d_vah_grid_f64):
            fn.restype = ci
            fn.argtypes = [ci] * 7 + [ctypes.POINTER(ci)]  # S P F R dim remap sw
        for fn in (lib.is3d_vah_f32, lib.is3d_vah_f64):
            fn.restype = ci
            fn.argtypes = [vp, ci, ci,                 # cells, C, nv
                           vp, vp, vp, ci,             # mass sign deg, S
                           vp, vp, vp, ci, ci,         # pT px py n_pT n_phi
                           vp, vp, ci,                 # nodes, weights, R
                           ci, ci, ci, ci,             # dim, sw, reg, outflow
                           cd, ci, ci, vp,             # prefactor, per, parts
                           vp, vp]                     # out, stream
        for fn in (lib.is3d_vah_remap_f32, lib.is3d_vah_remap_f64):
            fn.restype = ci
            fn.argtypes = [vp, ci, ci,                 # cells, C, nv
                           vp, vp, vp, ci,             # mass sign deg, S
                           vp, ci, vp, vp, ci,         # pT, n_pT, cos, sin, F
                           vp, vp, ci,                 # nodes, weights, R
                           ci, ci, ci,                 # sw, reg, outflow
                           cd, ci, ci, vp,             # prefactor, per, parts
                           vp, vp]                     # out, stream
        lib.is3d_cuda_error_string.restype = ctypes.c_char_p
        lib.is3d_cuda_error_string.argtypes = [ci]
        lib._is3d_bound = True
    return lib


def vah_grid(lib, device: torch.device, f64: bool, n_species: int,
             n_pT: int, n_phi: int, n_nodes: int, flags: VahFlags):
    """A VAH kernel's launch.KernelGrid for one shape and set of chains on
    one card (csrc/vah.cu:vah_grid owns the blocking)."""
    return kernel_grid(
        lib, "vah", lib.is3d_vah_grid_f64 if f64 else lib.is3d_vah_grid_f32,
        device, n_species, n_pT, n_phi, n_nodes, flags.dimension,
        int(flags.remap), flags.switches)


def vah_spectra_cuda(x: torch.Tensor, mom: MomentumConstants,
                     flags: VahFlags) -> torch.Tensor:
    """Launch the hand-written kernel (csrc/vah.cu) on the current stream:
    (S, n_pT, n_phi, n_y_out) in the cells' dtype.  With ``flags.remap``
    the angles must be separable as ``momentum_constants`` builds them (px
    = pT cos_phi, py = pT sin_phi)."""
    global LAUNCHES, REMAP_LAUNCHES
    check_float("vah_spectra_cuda", x)
    C = x.shape[0]
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    R = mom.nodes.shape[0]
    check_tensor("cells", x, (C, NV), x)
    for name, n in dict(mass=S, sign=S, degeneracy=S, pT=P, px=P * F,
                        py=P * F, nodes=R, weights=R, cos_phi=F,
                        sin_phi=F).items():
        check_tensor(f"momentum constant {name}", getattr(mom, name), (n,),
                     x)
    if flags.remap and flags.dimension != 2:
        raise ValueError("vah_spectra_cuda: the remap is 2+1D only")
    require_cuda("vah_spectra_cuda", x)
    lib = _library()
    f64 = x.dtype == torch.float64
    grid = vah_grid(lib, x.device, f64, S, P, F, R, flags)
    per, n_split = tile_split(C, grid)
    n_parts = n_split * grid.parts
    n_out = R if flags.dimension == 3 else 1
    out = x.new_empty((S, P, F, n_out))
    partial = x.new_empty((n_parts, S, P, F, n_out))
    head = (x.data_ptr(), C, NV, mom.mass.data_ptr(), mom.sign.data_ptr(),
            mom.degeneracy.data_ptr(), S)
    sw = (flags.switches, int(flags.regulate), int(flags.outflow))
    if flags.remap:
        launch(lib, "vah remap",
               lib.is3d_vah_remap_f64 if f64 else lib.is3d_vah_remap_f32,
               x.device, *head, mom.pT.data_ptr(), P,
               mom.cos_phi.data_ptr(), mom.sin_phi.data_ptr(), F,
               mom.nodes.data_ptr(), mom.weights.data_ptr(), R, *sw,
               CF_PREFACTOR, per, n_parts, partial.data_ptr(),
               out.data_ptr())
        REMAP_LAUNCHES += 1
        return out
    launch(lib, "vah", lib.is3d_vah_f64 if f64 else lib.is3d_vah_f32,
           x.device, *head, mom.pT.data_ptr(), mom.px.data_ptr(),
           mom.py.data_ptr(), P, F, mom.nodes.data_ptr(),
           mom.weights.data_ptr(), R, flags.dimension, *sw, CF_PREFACTOR,
           per, n_parts, partial.data_ptr(), out.data_ptr())
    LAUNCHES += 1
    return out


# ------------------------------------------------------ backward kernels

def vah_bwd_plain(x: torch.Tensor, G: torch.Tensor, mom: MomentumConstants,
                  flags: VahFlags, cell_chunk: int = 65536) -> torch.Tensor:
    """Plain version of the backward kernels: the gradient (C, NV) of <G,
    vah_spectra_plain(x)> with respect to the packed cells, by torch
    autograd of the plain version."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        out = vah_spectra_plain(xg, mom, flags, cell_chunk)
        return torch.autograd.grad(out, xg, G)[0]


def _bwd_library():
    from ..native.build import cuda_library
    lib = cuda_library("vah_bwd")
    if not getattr(lib, "_is3d_bound", False):
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for fn in (lib.is3d_vah_bwd_f32, lib.is3d_vah_bwd_f64):
            fn.restype = ci
            fn.argtypes = [vp, ci, ci,                 # cells, C, nv
                           vp, vp, vp, ci,             # mass sign deg, S
                           vp, vp, vp, ci, ci,         # pT px py n_pT n_phi
                           vp, vp, ci,                 # nodes, weights, R
                           ci, ci, ci, ci,             # dim, sw, reg, outflow
                           cd, vp, vp, vp]             # CF, G, grad, stream
        for fn in (lib.is3d_vah_bwd_remap_f32, lib.is3d_vah_bwd_remap_f64):
            fn.restype = ci
            fn.argtypes = [vp, ci, ci,                 # cells, C, nv
                           vp, vp, vp, ci,             # mass sign deg, S
                           vp, ci, vp, vp, ci,         # pT, n_pT, cos, sin, F
                           vp, vp, ci,                 # nodes, weights, R
                           ci, ci, ci,                 # sw, reg, outflow
                           cd, vp, vp, vp]             # CF, G, grad, stream
        lib.is3d_vah_bwd_props.restype = ci
        lib.is3d_vah_bwd_props.argtypes = [ci] * 6 + [vp]
        lib.is3d_cuda_error_string.restype = ctypes.c_char_p
        lib.is3d_cuda_error_string.argtypes = [ci]
        lib._is3d_bound = True
    return lib


def bwd_props(device: torch.device, f64: bool, mom: MomentumConstants,
              flags: VahFlags) -> dict:
    """The launch shape and resources (launch.kernel_props) of the backward
    kernel of ``flags``' chains at mom's shape."""
    lib = _bwd_library()
    dim = 0 if flags.remap else flags.dimension
    return kernel_props(lib, "vah_bwd", lib.is3d_vah_bwd_props, device,
                        int(f64), dim, flags.switches, mom.pT.shape[0],
                        mom.n_phi, mom.nodes.shape[0])


def vah_bwd_cuda(x: torch.Tensor, G: torch.Tensor, mom: MomentumConstants,
                 flags: VahFlags) -> torch.Tensor:
    """Launch the backward kernel (csrc/vah_bwd.cu) on the current stream:
    the gradient (C, NV) of <G, vah_spectra_cuda(x, mom, flags)> with
    respect to the packed cells, for the same chains, G of the output's
    shape (S, n_pT, n_phi, n_y_out)."""
    global BWD_LAUNCHES, BWD_REMAP_LAUNCHES
    check_float("vah_bwd_cuda", x)
    C = x.shape[0]
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    R = mom.nodes.shape[0]
    check_tensor("cells", x, (C, NV), x)
    check_tensor("G", G, (S, P, F, R if flags.dimension == 3 else 1), x)
    for name, n in dict(mass=S, sign=S, degeneracy=S, pT=P, px=P * F,
                        py=P * F, nodes=R, weights=R, cos_phi=F,
                        sin_phi=F).items():
        check_tensor(f"momentum constant {name}", getattr(mom, name), (n,),
                     x)
    if flags.remap and flags.dimension != 2:
        raise ValueError("vah_bwd_cuda: the remap is 2+1D only")
    require_cuda("vah_bwd_cuda", x)
    lib = _bwd_library()
    f64 = x.dtype == torch.float64
    grad = torch.empty_like(x)
    head = (x.data_ptr(), C, NV, mom.mass.data_ptr(), mom.sign.data_ptr(),
            mom.degeneracy.data_ptr(), S)
    tail = (flags.switches, int(flags.regulate), int(flags.outflow),
            CF_PREFACTOR, G.data_ptr(), grad.data_ptr())
    if flags.remap:
        launch(lib, "vah_bwd remap",
               lib.is3d_vah_bwd_remap_f64 if f64
               else lib.is3d_vah_bwd_remap_f32, x.device, *head,
               mom.pT.data_ptr(), P, mom.cos_phi.data_ptr(),
               mom.sin_phi.data_ptr(), F, mom.nodes.data_ptr(),
               mom.weights.data_ptr(), R, *tail)
        BWD_REMAP_LAUNCHES += 1
        return grad
    launch(lib, "vah_bwd", lib.is3d_vah_bwd_f64 if f64
           else lib.is3d_vah_bwd_f32, x.device, *head, mom.pT.data_ptr(),
           mom.px.data_ptr(), mom.py.data_ptr(), P, F, mom.nodes.data_ptr(),
           mom.weights.data_ptr(), R, flags.dimension, *tail)
    BWD_LAUNCHES += 1
    return grad


class _VahKernel(torch.autograd.Function):
    """vah_spectra_cuda with its backward kernel: the forward keeps only the
    packed cells, and the backward recomputes everything else inside
    vah_bwd_cuda for the same chains."""

    @staticmethod
    def forward(ctx, x, mom, flags):
        ctx.save_for_backward(x)
        ctx.mom, ctx.flags = mom, flags
        return vah_spectra_cuda(x, mom, flags)

    @staticmethod
    def backward(ctx, G):
        (x,) = ctx.saved_tensors
        return vah_bwd_cuda(x, G.contiguous(), ctx.mom, ctx.flags), None, None


def group_spectra(x: torch.Tensor, mom: MomentumConstants, flags: VahFlags,
                  cell_chunk: int = 65536) -> torch.Tensor:
    """One group's spectra from its packed cells on their device: the kernel
    (with its backward kernel under autograd) for CUDA tensors, the plain
    version (autograd through it) for CPU tensors."""
    if x.device.type == "cuda":
        if torch.is_grad_enabled() and x.requires_grad:
            return _VahKernel.apply(x, mom, flags)
        return vah_spectra_cuda(x, mom, flags)
    if x.device.type == "cpu":
        return vah_spectra_plain(x, mom, flags, cell_chunk)
    raise ValueError(f"no VAH spectra path for device {x.device}")


# ------------------------------------------------------------ entry point

def group_inputs(cols: dict, flags: VahFlags) -> torch.Tensor:
    """The packed cells of one group of raw cell columns."""
    return pack_vah_cells(complete_vah_cells(cols), flags)


def _group_spectra(cols: dict, mom: MomentumConstants, flags: VahFlags,
                   cfg: Config) -> torch.Tensor:
    return group_spectra(group_inputs(cols, flags), mom, flags,
                         cfg.cell_chunk)


def _check_chains(cols: dict, cfg: Config, flags: VahFlags):
    """Refuse a launch that drops a chain whose coefficient column wants a
    gradient that is not provably 0 (effective_vah_cfg keeps such chains:
    the backward kernels differentiate only the chains the forward
    launched).  A bulk chain dropped for bulkPi = 0 has exact zero
    derivatives with respect to c0..c2."""
    if not torch.is_grad_enabled():
        return
    for on, kept, names, live in (
            (cfg.include_shear_deltaf, flags.shear, ("c3", "c4"), True),
            (cfg.include_bulk_deltaf, flags.bulk, ("c0", "c1", "c2"),
             None)):
        wanted = [n for n in names if cols[n].requires_grad]
        if not on or kept or not wanted:
            continue
        if live is None:
            live = _any_nonzero(cols["bulkPi"])
        if live:
            raise ValueError(f"VAH: the chain of {', '.join(wanted)} is off "
                             "in the launch while its columns want a "
                             "gradient")


def vah_reduction(species: SpeciesArrays, grid: MomentumGrid,
                  gated: Config) -> tuple:
    """(kernel_fn, replicated) of the VAH spectra's cell reduction under
    the gated config (effective_vah_cfg's)."""
    flags = vah_flags(gated, grid)
    mom = momentum_constants(species, grid, gated.dimension)
    return ((lambda c, m, fl: _group_spectra(c, m, fl, gated)),
            (mom, flags))


def smooth_spectra_vah(surface, species: SpeciesArrays, grid: MomentumGrid,
                       cfg: Config, mesh=None) -> torch.Tensor:
    """VAH smooth spectra from a mode-2/3 surface: (S, n_pT, n_phi,
    n_y_out) on the surface's device, the cell reduction through the
    canonical group tree (one launch per group, partials folded in group
    order; with ``mesh`` each rank launches its own groups and returns the
    full spectra, the gate decided on the full columns)."""
    from ..parallel.mesh import grouped_cell_reduce
    cols = vah_surface_cols(surface)
    gated = effective_vah_cfg(cols, cfg)
    fn, replicated = vah_reduction(species, grid, gated)
    _check_chains(cols, cfg, replicated[1])
    return grouped_cell_reduce(fn, cols, replicated, gated, mesh=mesh)
