"""Smooth Cooper-Frye spectra with modified equilibrium distributions
(df modes 3 "Mike" and 4 "Jonah").

Port of ``is3d_tpu.kernels.feqmod`` (the reference's
calculate_dN_ptdptdphidy_feqmod, emissionfunction_smooth_kernels.cpp:
396-996).  One group of cells goes through:

1. ``prepare_cells`` (kernels/common.py) and ``prepare_feqmod_cells``:
   torch on the device.  Per cell the Milne tetrad, pi in the local rest
   frame, the symmetric momentum transform A = (1 + bulk_mod) 1 +
   shear_mod pi_LRF, its adjugate inverse with the fixed 2-pass residual
   refinement folded into one operator Minv (``refined_inverse``),
   T_mod / alphaB_mod, the breakdown flag (detA <= deta_min; df 3 also a
   negative linearized pi0 density) and, per (cell, species), the
   renormalization n_linear / n_mod (df 3, Gauss-Laguerre moments in the
   surface's precision) or z (df 4);
2. ``pack_feqmod_cells``: the kernels' inputs, a (C, NQ) matrix of
   per-cell scalars (field order FQ_FIELDS) and two (C, S) tables: rn =
   |renorm| (0 where it is not finite) and wcs = validity x finite renorm.
   x = Minv p is linear in the momentum p_LRF = mT (alpha ch + beta sh) +
   gamma(px, py), so only its coefficients come in: a = Minv alpha, b =
   Minv beta and gx, gy with Minv gamma = px gx + py gy;
3. ``feqmod_spectra_cuda`` (csrc/feqmod.cu: ``fixed_kernel`` at fixed
   nodes, ``remap_kernel`` with the 2+1D mT remap; the group sorted by
   chain on the card, ``chain_split``, and laid out by ``fixed_stage`` or
   ``remap_stage``, one instantiation a chain) for CUDA tensors,
   ``feqmod_spectra_plain`` for CPU tensors.  The group partials are folded
   by ``parallel.mesh.grouped_cell_reduce``.  Under autograd the CUDA path
   runs ``_FeqmodKernel``, whose backward is ``feqmod_bwd_cuda``
   (csrc/feqmod_bwd.cu: the gradients with respect to the packed cells and
   rn), and the plain version recomputes each chunk in the backward
   (torch.utils.checkpoint); the per-cell algebra of steps 1-2 is torch
   autograd on either device.

The plain version evaluates both chains (f_mod at the scaled nodes, the
linearized fallback at the unscaled ones) at every point and selects per
(cell, node), as the JAX "both" branch does.  Both evaluate |Minv p|^2 as
the sum of the squares of x's three components, where the JAX package
expands it into a quadratic form (qaa, qab, qbb per cell and qag, qbg, qgg
per point): the two are equal, but the expansion cancels on cells near
breakdown (|Minv| large, |Minv p| small), where in float32 it loses up to
0.1 of x2 and moves spectra by 1e-3 of their maximum (testing.FEQMOD_EDGES
"3d_df4_mixed", against float64).  JAX's ``routed_switch`` and
``_routing_sort`` only choose which chains a chunk traces, and its three
branches give the same values by construction (is3d_tpu/kernels/
feqmod.py:606-629); their counterpart is ``chain_split``, which sorts a
group's cells by chain for the CUDA kernels.  Where f_mod is exactly 0
(|x|^2 or the exponential overflowed) the point emits exactly 0, also
where p.dsigma overflowed (2+1D fixed nodes scaled by a large detA in
float32), which the JAX package leaves as 0 inf = NaN.  The CUDA kernels
take one chain a cell instead, the reference's own scalar semantics
(emissionfunction_smooth_kernels.cpp:811-877): a breakdown cell evaluates
only the fallback, and in 3+1D a cell with detA < 0.01 also takes it at
the nodes where |y - eta| < detA; each chain's instantiation walks its own
part of the sorted cells.  The JAX Config keys feqmod_partition and
feqmod_partition_min_cells are accepted and change nothing.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch
import torch.utils.checkpoint

from ..units import CF_PREFACTOR, TWO_PI2_HBARC3
from ..config import Config
from ..data import SpeciesArrays
from ..io.tables import MomentumGrid, laguerre_in_precision
from ..io.deltaf import DeltafData
from ..physics import lrf, thermal
from .common import (surface_columns, prepare_cells, scaled_fermi_bose,
                     fermi_bose, effective_chunk, CHUNK_ELEMENT_BUDGET)
from .launch import (check_float, check_tensor, require_cuda, launch,
                     kernel_grid, kernel_props, tile_split)
from .smooth import (ETA_REMAP_T_REF, MomentumConstants, df_switches,
                     emission_terms, node_delta, momentum_constants,
                     remap_scale, remap_node_table, REMAP_NODE_OPS)

# per-cell scalar field order of the packed (C, NQ) matrix; the CUDA
# header's `enum FqField` (csrc/feqmod.cuh) must list the same names in the
# same order.  The fallback's fields keep smooth.FIELDS' names, so the
# linear kinematics (smooth.emission_terms) read them as they are.
FQ_FIELDS = (
    # both chains
    "tau", "eta", "dat", "dant", "dax", "day",
    # the momentum transform: breakdown flag, detA, node scale (2+1D fixed
    # nodes eta_scale, remap zscale, 3+1D 1), flow rapidity of the mod
    # nodes, x = Minv p's coefficients, 1/T_mod, alphaB_mod
    "bd", "detA", "scale", "yfm", "a0", "a1", "a2", "b0", "b1", "b2", "gx0",
    "gx1", "gx2", "gy0", "gy1", "gy2", "invTm", "abm",
    # the linearized fallback
    "ut", "tun", "ux", "uy", "pitt", "pitx", "pity", "pitn", "pinn", "pixx",
    "pixy", "pixn", "piyy", "piyn", "Vt", "Vx", "Vy", "Vn", "invT", "alphaB",
    "ksh", "kF", "kG", "k3", "bulkPi", "benth", "kV", "dz", "dl", "yflow")
NQ = len(FQ_FIELDS)
FQ = {n: i for i, n in enumerate(FQ_FIELDS)}

# 3+1D cells whose detA is below this take the fallback at the nodes where
# |y - eta| < detA (JAX _chunk_contribution_feqmod's narrow-cell mask)
NARROW_DETA = 0.01

# launches of the CUDA kernels in this process: at fixed nodes
# (fixed_kernel) and with the 2+1D mT remap (remap_kernel); and of the
# backward kernels (feqmod_bwd_cuda: csrc/feqmod_bwd.cu), fixed nodes and
# remap
LAUNCHES = 0
REMAP_LAUNCHES = 0
BWD_LAUNCHES = 0
BWD_REMAP_LAUNCHES = 0

# The bound's yardstick, counted once from the formula at the main paths'
# flags (shear + bulk, regulate and outflow on), an FMA as one operation,
# factors of fewer indices hoisted as in kernels/smooth.py.  Per evaluation
# (cell, node, species, momentum point), (FP32, SFU):
#   f_mod:    x = Minv p = mT alpha(c,r) + gamma(c,m) 3 (alpha per (cell,
#             node), gamma per (cell, point), shared by the species and
#             nodes), |x|^2 3, saturation of NaN/-inf 1, max(., 0) and
#             + m^2 2 | sqrt (SFU), the exponent 1 | exp (SFU), + sign 1 |
#             1/(...) (SFU), x |renorm| 1, p.dsigma 1, the outflow select 1,
#             x validity 1, the sum 1                           = (16, 3)
#   fallback: u.p, pi:pp (3) and p.dsigma as the linear kernels 5,
#             exponent 1 (b alphaB hoisted per (cell, species)) | exp,
#             + sign 1 | rcp, 1 - sign feq 1, 1/u.p | rcp; df 3
#             unregrouped: shear 2, bulk 5, the sum 1, x feqbar 1; clip
#             2, feq df + feq 1, select 1, x validity 1, the sum 1
#                                                               = (23, 3)
#             df 4: shear 3, bulk 5 (its constant hoisted), sum 1, clip 2,
#             feq df + feq 1, select 1, x validity 1, sum 1     = (23, 3)
#             (an earlier count took the diffusion term (3 and its
#             sum 1) and V.p (1) in, which the main paths' flags do not
#             evaluate, and the exponent as 2: 29 and 24)
# The work depends on the data: a breakdown cell evaluates only the
# fallback, a clean one only f_mod (the 3+1D narrow nodes take the
# fallback), so a bound counts each kind of evaluation this run makes.
MOD_OPS = (16, 3)
FALLBACK_OPS = {3: (23, 3), 4: (23, 3)}
# The 2+1D remap adds per (cell, node, species, pT), shared by the n_phi
# angles: the mod node's exp 1 SFU and its reciprocal 1 SFU, e^delta =
# e^y_flow e^(...) 1, p.dsigma's and x's node terms mT (h+ e^delta + h-
# e^-delta) 2 each, 8; per angle x takes pT gamma1(c, phi) + alpha, as at
# fixed nodes.  The fallback's node composites are smooth.REMAP_NODE_OPS.
REMAP_MOD_NODE_OPS = (9, 2)


def feqmod_formula_ops(df_mode: int, remap: bool, n_phi: int,
                       fallback: bool) -> tuple[float, float]:
    """(FP32, SFU) per evaluation of one chain (f_mod, or the fallback
    with ``fallback``): the yardstick above plus, with the remap, the node
    kinematics' share of one of n_phi points."""
    if fallback:
        fp32, sfu = FALLBACK_OPS[df_mode]
        node = REMAP_NODE_OPS
    else:
        fp32, sfu = MOD_OPS
        node = REMAP_MOD_NODE_OPS
    if not remap:
        return float(fp32), float(sfu)
    return fp32 + node[0] / n_phi, sfu + node[1] / n_phi


# The backward kernels' yardstick (csrc/feqmod_bwd.cu), counted from the
# formula as MOD_OPS is, an FMA as one operation, at the main paths' flags.
# Per evaluation (cell, node, species, point), (FP32, SFU):
#   f_mod:    the forward's recomputed value: p.dsigma 2, x 6, |x|^2 3,
#             the saturation 1, m^2 + |x|^2 1 | sqrt, the exponent 1 | exp,
#             + sign 1 | 1/(...), x rn 1, the two selects 2     = (18, 3)
#             the chain: g = G w 1, g f 1, g p.dsigma 1, the p.dsigma sums
#             (g, g px, g py) 3, rn's sum 2, g_arg 4, its sums (E, 1) 2,
#             g_arg / T_mod / E 2 | 1/E, g_x 3, their sums (g, g px, g py
#             for 3 components) 9                               = (29, 1)
#             with the remap zscale's direct term 2
#   fallback: the forward's (df 3, shear + bulk): p.dsigma 2, u.p 2, pi:pp
#             5, the exponent 1 | exp, + sign 1 | 1/(...), 1 - sign feq 1
#             | 1/u.p, u.p - m^2 r 1, shear 2, bulk 4, x feqbar 1, clip 2,
#             feq df + feq 1                                    = (23, 3)
#             the chain: g 3, g_feq 2, the clip mask 2, g_sum and g_feqbar
#             2, shear 6, bulk 14, g_feq -= 1, g_u -= g_r r^2 2, g_arg 3,
#             its sums 3, the point sums (p.dsigma 3, u.p 3, pi:pp 9) 15
#                                                               = (53, 0)
#             df 4: its bracket (dz - 3 dl + feqbar dl (u.p - m^2 r) / T)
#             and chain take 6 fewer                            = (70, 3)
# Per row (species, pT) of a thread, shared by its n_phi points: mT 1 |
# sqrt, the node kinematics 2 and the chain's composites (f_mod: p.dsigma's
# and x's 8; fallback 14), and the float64 sums the row adds (f_mod 22,
# fallback 34, the node derivative's 10 each); with the remap the node's
# exp and reciprocal (2 SFU) and 4 FP32.
MOD_BWD_OPS = (47, 4)
FALLBACK_BWD_OPS = {3: (76, 3), 4: (70, 3)}
MOD_BWD_ROW_OPS = (42, 1)
FALLBACK_BWD_ROW_OPS = (60, 1)
REMAP_BWD_ROW_OPS = (4, 2)
REMAP_MOD_BWD_EXTRA = 2


def feqmod_backward_formula_ops(df_mode: int, remap: bool, n_phi: int,
                                fallback: bool) -> tuple[float, float]:
    """(FP32, SFU) per evaluation of one chain of the backward kernels (f_mod,
    or the fallback with ``fallback``): the yardstick above plus the row's
    share of one of n_phi points."""
    if fallback:
        (fp32, sfu), row = FALLBACK_BWD_OPS[df_mode], FALLBACK_BWD_ROW_OPS
    else:
        (fp32, sfu), row = MOD_BWD_OPS, MOD_BWD_ROW_OPS
        fp32 += REMAP_MOD_BWD_EXTRA if remap else 0
    rf, rs = row
    if remap:
        rf, rs = rf + REMAP_BWD_ROW_OPS[0], rs + REMAP_BWD_ROW_OPS[1]
    return fp32 + rf / n_phi, sfu + rs / n_phi


@dataclass(frozen=True)
class FeqmodFlags:
    df_mode: int
    dimension: int
    remap: bool
    regulate: bool
    outflow: bool
    shear: bool
    bulk: bool
    diff: bool

    @property
    def switches(self) -> int:
        """The fallback's terms as the kernels' bit mask: shear 1, bulk 2,
        diffusion 4 (df 4's fallback has no diffusion term)."""
        return (int(self.shear) | 2 * int(self.bulk)
                | 4 * int(self.diff and self.df_mode == 3))


def feqmod_flags(cfg: Config, grid: MomentumGrid) -> FeqmodFlags:
    if cfg.df_mode not in (3, 4):
        raise ValueError("smooth_spectra_feqmod handles df modes 3-4")
    shear, bulk, diff = df_switches(cfg)
    return FeqmodFlags(df_mode=int(cfg.df_mode), dimension=int(cfg.dimension),
                       remap=bool(cfg.dimension == 2 and grid.eta_mT_rescale),
                       regulate=bool(cfg.regulate_deltaf),
                       outflow=bool(cfg.outflow), shear=shear, bulk=bulk,
                       diff=diff)


# ------------------------------------------------------ per-cell algebra

def adjugate_sym(A):
    Axx, Axy, Axz, Ayy, Ayz, Azz = A
    adj_xx = Ayy * Azz - Ayz * Ayz
    adj_xy = Axz * Ayz - Axy * Azz
    adj_xz = Axy * Ayz - Ayy * Axz
    adj_yy = Axx * Azz - Axz * Axz
    adj_yz = Axy * Axz - Axx * Ayz
    adj_zz = Axx * Ayy - Axy * Axy
    det = Axx * adj_xx + Axy * adj_xy + Axz * adj_xz
    return (adj_xx, adj_xy, adj_xz, adj_yy, adj_yz, adj_zz), det


def sym_to_gen(S):
    """Symmetric 6-tuple (xx, xy, xz, yy, yz, zz) -> row-major 9-tuple."""
    xx, xy, xz, yy, yz, zz = S
    return (xx, xy, xz, xy, yy, yz, xz, yz, zz)


def gen_matmul(P, Q):
    """Row-major 9-tuple 3x3 product P @ Q, broadcastable entries."""
    p11, p12, p13, p21, p22, p23, p31, p32, p33 = P
    q11, q12, q13, q21, q22, q23, q31, q32, q33 = Q
    return (p11 * q11 + p12 * q21 + p13 * q31,
            p11 * q12 + p12 * q22 + p13 * q32,
            p11 * q13 + p12 * q23 + p13 * q33,
            p21 * q11 + p22 * q21 + p23 * q31,
            p21 * q12 + p22 * q22 + p23 * q32,
            p21 * q13 + p22 * q23 + p23 * q33,
            p31 * q11 + p32 * q21 + p33 * q31,
            p31 * q12 + p32 * q22 + p33 * q32,
            p31 * q13 + p32 * q23 + p33 * q33)


def gen_matvec(M, v):
    m11, m12, m13, m21, m22, m23, m31, m32, m33 = M
    vx, vy, vz = v
    return (m11 * vx + m12 * vy + m13 * vz,
            m21 * vx + m22 * vy + m23 * vz,
            m31 * vx + m32 * vy + m33 * vz)


def refined_inverse(A_sym, B_sym):
    """The fixed 2-pass residual refinement of x = A^-1 p folded into one
    per-cell operator: with B the adjugate inverse and e = I - B A,
    x2 = (I + e + e^2) B p.  Cells where the series does not contract
    (Frobenius^2 of e at least 0.25: detA near the breakdown threshold, or
    indefinite transforms) keep the plain adjugate inverse, exact in exact
    arithmetic; they are breakdown cells or masked downstream anyway."""
    B = sym_to_gen(B_sym)
    BA = gen_matmul(B, sym_to_gen(A_sym))
    one = 1.0 + 0.0 * BA[0]
    zero = 0.0 * BA[0]
    eye = (one, zero, zero, zero, one, zero, zero, zero, one)
    e = tuple(i - ba for i, ba in zip(eye, BA))
    EB = gen_matmul(e, B)
    EEB = gen_matmul(e, EB)
    ok = sum(x * x for x in e) < 0.25
    return tuple(torch.where(ok, b + eb + eeb, b)
                 for b, eb, eeb in zip(B, EB, EEB))


def mode3_renorm(c: dict, species: SpeciesArrays, laguerre: dict
                 ) -> torch.Tensor:
    """n_linear / n_mod per (cell, species), (C, S) (reference:
    emissionfunction_smooth_kernels.cpp:744-765), the cells taken in
    chunks that keep each (chunk, S, nodes) quadrature block within
    common.CHUNK_ELEMENT_BUDGET."""
    C, S = c["T"].shape[0], species.mass.shape[0]
    n_q = laguerre[1][0].shape[0]
    chunk = max(1, CHUNK_ELEMENT_BUDGET // max(S * n_q, 1))
    return torch.cat([_mode3_renorm_chunk(
        {k: c[k][c0:c0 + chunk] for k in ("T", "bulkPi", "T_mod",
                                          "alphaB", "alphaB_mod")},
        {k: getattr(c["df"], k)[c0:c0 + chunk]
         for k in ("betabulk", "G", "F")}, species, laguerre)
        for c0 in range(0, max(C, 1), chunk)])[:C]


def _mode3_renorm_chunk(c, df, species, laguerre):
    r1, w1 = laguerre[1]
    r2, w2 = laguerre[2]
    T, bulkPi = c["T"], c["bulkPi"]
    T_mod = c["T_mod"]
    alphaB = c["alphaB"][:, None]
    alphaB_mod = c["alphaB_mod"][:, None]

    mbar = species.mass[None, :] / T[:, None]           # (C,S)
    mbar_mod = species.mass[None, :] / T_mod[:, None]
    baryon = species.baryon[None, :]
    sign = species.sign[None, :]
    deg = species.degeneracy[None, :]

    neq_fact = (T**3 / TWO_PI2_HBARC3)[:, None]
    J20_fact = (T**4 / TWO_PI2_HBARC3)[:, None]
    nmod_fact = (T_mod**3 / TWO_PI2_HBARC3)[:, None]
    dn_fact = (bulkPi / df["betabulk"])[:, None]

    gt = lambda f, r, w, mb, aB: thermal.gauss_thermal(f, r, w, mb, aB,
                                                       baryon, sign)
    neq = neq_fact * deg * gt(thermal.neq_int, r1, w1, mbar, alphaB)
    N10 = baryon * neq_fact * deg * gt(thermal.J10_int, r1, w1, mbar, alphaB)
    J20 = J20_fact * deg * gt(thermal.J20_int, r2, w2, mbar, alphaB)
    n_linear = neq + dn_fact * (neq + N10 * df["G"][:, None]
                                + J20 * (df["F"] / T / T)[:, None])
    n_mod = nmod_fact * deg * gt(thermal.neq_int, r1, w1, mbar_mod,
                                 alphaB_mod)
    return n_linear / n_mod


def mode3_breakdown(c: dict, laguerre: dict, cfg: Config) -> torch.Tensor:
    """Per-cell breakdown flag: detA <= deta_min or a negative linearized
    pi0 density (reference: emissionfunction.cpp:109-150 with fast = 0)."""
    r1, w1 = laguerre[1]
    r2, w2 = laguerre[2]
    T, bulkPi, df = c["T"], c["bulkPi"], c["df"]
    mbar_pi = cfg.mass_pion0 / T
    zero = torch.zeros_like(T)
    neq_fact = T**3 / TWO_PI2_HBARC3
    J20_fact = T * neq_fact
    neq_pi = neq_fact * thermal.gauss_thermal(
        thermal.neq_int, r1, w1, mbar_pi, zero, zero, -torch.ones_like(T))
    J20_pi = J20_fact * thermal.gauss_thermal(
        thermal.J20_int, r2, w2, mbar_pi, zero, zero, -torch.ones_like(T))
    dn_pi = bulkPi * (neq_pi + J20_pi * df.F / T / T) / df.betabulk
    pion_negative = (neq_pi + dn_pi) < 0.0
    return (c["detA"] <= cfg.deta_min) | pion_negative


def feqmod_transform(c: dict, laguerre: dict, cfg: Config) -> dict:
    """Per-cell momentum transform and breakdown flag: the LRF basis, A =
    (1 + bulk_mod) 1 + shear_mod pi_LRF, its adjugate inverse, detA,
    T_mod / alphaB_mod."""
    df = c["df"]
    tau = c["tau"]
    basis = lrf.milne_basis(c["ut"], c["ux"], c["uy"], c["un"], tau)
    c["basis"] = basis
    pixx_L, pixy_L, pixz_L, piyy_L, piyz_L, pizz_L = lrf.boost_pimunu_to_lrf(
        basis, c["pitt"], c["pitx"], c["pity"], c["pitn"], c["pixx"],
        c["pixy"], c["pixn"], c["piyy"], c["piyn"], c["pinn"], tau)

    if cfg.df_mode == 3:
        c["T_mod"] = c["T"] + c["bulkPi"] * df.F / df.betabulk
        c["alphaB_mod"] = c["alphaB"] + c["bulkPi"] * df.G / df.betabulk
        bulk_mod = c["bulkPi"] / (3.0 * df.betabulk)
    else:
        c["T_mod"] = c["T"]
        c["alphaB_mod"] = c["alphaB"]
        bulk_mod = df.lam
    shear_mod = 0.5 / df.betapi

    A = (1.0 + pixx_L * shear_mod + bulk_mod,
         pixy_L * shear_mod,
         pixz_L * shear_mod,
         1.0 + piyy_L * shear_mod + bulk_mod,
         piyz_L * shear_mod,
         1.0 + pizz_L * shear_mod + bulk_mod)
    adj, detA = adjugate_sym(A)
    c["A"] = A
    c["detA"] = detA
    safe_det = torch.where(torch.abs(detA) < 1e-300,
                           torch.ones_like(detA), detA)
    c["A_inv"] = tuple(a / safe_det for a in adj)
    if cfg.df_mode == 3:
        c["breakdown"] = mode3_breakdown(c, laguerre, cfg)
    else:
        # mode 4 falls back only where the modified distribution stops
        # being defined (A no longer positive definite); the JAX package's
        # deliberate divergence from the reference
        c["breakdown"] = detA <= cfg.deta_min
    return c


def prepare_feqmod_cells(c: dict, species: SpeciesArrays, laguerre: dict,
                         cfg: Config, eta_rescaled: bool = False) -> dict:
    """Extend ``prepare_cells``' bundle with the feqmod per-cell data:
    Minv, renorm (C, S), renorm_ok and, in 2+1D, eta_scale."""
    c = feqmod_transform(c, laguerre, cfg)
    df = c["df"]
    detA = c["detA"]
    c["Minv"] = refined_inverse(c["A"], c["A_inv"])
    C, S = detA.shape[0], species.mass.shape[0]
    if cfg.include_bulk_deltaf:
        if cfg.df_mode == 3:
            renorm = mode3_renorm(c, species, laguerre)
        else:
            renorm = df.z[:, None].expand(C, S)
    else:
        renorm = detA.new_ones((C, S))
    finite = torch.isfinite(renorm)
    if cfg.dimension == 3 or eta_rescaled:
        # the explicit 1/detA momentum-space jacobian (with 2+1D fixed
        # nodes the eta -> detA eta substitution supplies it instead)
        renorm = renorm / detA[:, None]
    c["renorm"] = torch.where(finite, renorm, torch.zeros_like(renorm))
    c["renorm_ok"] = finite
    if cfg.dimension == 2:
        # the 2+1D eta -> detA eta substitution; the reference spectra
        # kernel skips it for detA >= 1 (reference_compat_feqmod_eta)
        use = detA > cfg.deta_min
        if cfg.reference_compat_feqmod_eta:
            use = use & (detA < 1.0)
        c["eta_scale"] = torch.where(use, detA, torch.ones_like(detA))
    return c


def _zscale(c: dict) -> torch.Tensor:
    """The 2+1D remap's per-cell longitudinal compression of the f_mod
    nodes, A_zz sqrt(T_mod / T), sanitized: A_zz <= 1e-3 (A indefinite)
    reverts to the shared map, NaN / inf go to 1, clipped to [1e-3, 10]."""
    Azz = c["A"][5]
    Azz = torch.where(Azz > 1e-3, Azz, torch.ones_like(Azz))
    z = Azz * torch.sqrt(torch.clamp(c["T_mod"], min=1e-6) / c["T"])
    z = torch.nan_to_num(z, nan=1.0, posinf=1.0, neginf=1.0)
    return torch.clamp(z, 1e-3, 10.0)


def pack_feqmod_cells(c: dict, cfg: Config, flags: FeqmodFlags
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(x (C, NQ), rn (C, S), wcs (C, S)) from ``prepare_feqmod_cells``'
    output: the kernels' inputs and the plain version's."""
    df, T, tau = c["df"], c["T"], c["tau"]
    z = torch.zeros_like(T)
    b = c["basis"]
    M = c["Minv"]
    Ma = gen_matvec(M, (-b.Xt, z, -b.Zt))
    Mb = gen_matvec(M, (b.Xn * tau, z, b.Zn * tau))
    # Minv (E2, F2, 0) = px Gx + py Gy with E2 = Xx px + Xy py, F2 = Yx px
    # + Yy py (the zero component kept: a non-finite Minv poisons x as in
    # the JAX package, and the saturation then gives f_mod = 0)
    Gx = gen_matvec(M, (b.Xx, b.Yx, z))
    Gy = gen_matvec(M, (b.Xy, b.Yy, z))
    if flags.remap:
        scale = _zscale(c)
    elif flags.dimension == 2:
        scale = c["eta_scale"]
    else:
        scale = torch.ones_like(T)
    u0p = torch.sqrt(1.0 + c["ux"] ** 2 + c["uy"] ** 2)
    vals = dict(c)
    vals.update(
        eta=c["eta"] if flags.dimension == 3 else z, dant=c["dan"] / tau,
        bd=c["breakdown"].to(T.dtype), scale=scale,
        yfm=lrf.flow_rapidity(tau, c["ut"], c["un"]),
        **{f"{n}{i}": v[i] for n, v in (("a", Ma), ("b", Mb), ("gx", Gx),
                                        ("gy", Gy)) for i in range(3)},
        invTm=1.0 / c["T_mod"], abm=c["alphaB_mod"],
        tun=tau * c["un"], invT=1.0 / T,
        ksh=0.5 / (df.betapi * T), benth=c["baryon_enthalpy_ratio"],
        yflow=torch.asinh(tau * c["un"] / u0p))
    if flags.df_mode == 3:
        vals.update(kF=df.F / (T ** 2 * df.betabulk), kG=df.G / df.betabulk,
                    k3=1.0 / (3.0 * T * df.betabulk), kV=1.0 / df.betaV,
                    dz=z, dl=z)
    else:
        vals.update(kF=z, kG=z, k3=z, kV=z, dz=df.delta_z,
                    dl=df.delta_lambda)
    x = torch.stack([vals[name] for name in FQ_FIELDS], dim=1).contiguous()
    rn = torch.abs(c["renorm"]).contiguous()
    wcs = (c["valid"][:, None] & c["renorm_ok"]).to(T.dtype).contiguous()
    return x, rn, wcs


# ------------------------------------------------------------ plain version

class _ZeroSafeMul(torch.autograd.Function):
    """a b whose derivative is exactly 0 where the cotangent is: the df 3
    bracket's clip-regulated +-inf (1/betaV = inf) would otherwise give
    0 inf = NaN under autograd (the CUDA backward skips such terms)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return a * b

    @staticmethod
    def backward(ctx, g):
        from .common import _sum_to
        a, b = ctx.saved_tensors
        live = g != 0
        zero = torch.zeros_like(g)
        ga = _sum_to(torch.where(live, g * b, zero), a.shape)
        gb = _sum_to(torch.where(live, g * a, zero), b.shape)
        return ga, gb


def _zero_safe_mul(a, b):
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _ZeroSafeMul.apply(a, b)
    return a * b


def fallback_f(g, sp, pdotu, pipp, Vp, flags: FeqmodFlags):
    """The linearized fallback f_eq (1 + df) (JAX _chunk_contribution_
    feqmod): df 3 the Chapman-Enskog form, deliberately not regrouped (a
    clip-regulated +-inf must not become 0 inf = NaN on degenerate tables,
    betaV = 0 with baryon number 0); df 4 Jonah's, without the chemical
    potential.  ``g`` the per-cell fields, ``sp`` the species'."""
    sign, bary, m2 = sp("sign"), sp("baryon"), sp("m2")
    arg = pdotu * g("invT")
    if flags.df_mode == 3:
        arg = arg - bary * g("alphaB")
    feq = fermi_bose(arg, sign)
    feqbar = 1.0 - sign * feq
    r = 1.0 / pdotu
    terms = []
    if flags.df_mode == 3:
        if flags.shear:
            terms.append(g("ksh") * pipp * r)
        if flags.bulk:
            terms.append((g("kF") * pdotu + g("kG") * bary
                          + g("k3") * (pdotu - m2 * r)) * g("bulkPi"))
        if flags.diff:
            terms.append(_zero_safe_mul((g("benth") - bary * r) * Vp,
                                        g("kV")))
        out_df = (_zero_safe_mul(feqbar, sum(terms[1:], terms[0]))
                  if terms else None)
    else:
        if flags.shear:
            terms.append(feqbar * g("ksh") * pipp * r)
        if flags.bulk:
            terms.append(g("dz") - 3.0 * g("dl")
                         + feqbar * g("dl") * (pdotu - m2 * r) * g("invT"))
        out_df = sum(terms[1:], terms[0]) if terms else None
    if out_df is None:
        return feq
    if flags.regulate:
        out_df = torch.clamp(out_df, -1.0, 1.0)
    return feq * out_df + feq


def feqmod_block(x: torch.Tensor, rn: torch.Tensor, wcs: torch.Tensor,
                 mom: MomentumConstants, flags: FeqmodFlags) -> torch.Tensor:
    """p.dsigma f of a chunk of packed cells at every (cell, node, species,
    pT, phi): the (c, R, S, P, F) block with validity and the renorm mask
    applied, without node weights, prefactor or degeneracy (the port of
    _chunk_contribution_feqmod's "both" branch; with reduce=False, what the
    dN/dX reduction takes)."""
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    R = mom.nodes.shape[0]
    g = lambda name: x[:, FQ[name]].view(-1, 1, 1, 1, 1)
    spv = dict(sign=mom.sign, baryon=mom.baryon, m2=mom.mass ** 2)
    sp = lambda name: spv[name].view(1, 1, S, 1, 1)
    cs = lambda t: t.view(-1, 1, S, 1, 1)
    mT = torch.sqrt(mom.mass[:, None] ** 2 + mom.pT[None, :] ** 2)
    mT5 = mT.view(1, 1, S, P, 1)
    px5 = mom.px.view(1, 1, 1, P, F)
    py5 = mom.py.view(1, 1, 1, P, F)
    nodes = mom.nodes.view(1, R, 1, 1, 1)

    # the fallback at the unscaled nodes (the linear kernels' kinematics)
    delta_u = node_delta(g, mom, flags)
    pds_u, pdotu, pipp, Vp = emission_terms(g, mom, delta_u)
    f_fb = fallback_f(g, sp, pdotu, pipp, Vp, flags)

    # f_mod at the scaled nodes: x = Minv p = mT (a ch + b sh) + px gx
    # + py gy, |x|^2 its sum of squares
    W1 = g("dax") * px5 + g("day") * py5
    abg = [(g(f"a{i}"), g(f"b{i}"), g(f"gx{i}") * px5 + g(f"gy{i}") * py5)
           for i in range(3)]
    if flags.remap:
        # f_mod's nodes y_flow + zscale s(mT) eta_r: one exp, ch and sh
        # refactored into e^delta and e^-delta
        s5 = remap_scale(mom).view(1, 1, S, P, 1)
        eq = torch.exp(g("yfm") + g("scale") * nodes * s5)
        rq = 1.0 / eq
        pds_s = (mT5 * (0.5 * (g("dat") + g("dant")) * eq
                        + 0.5 * (g("dat") - g("dant")) * rq) + W1)
        xs = [mT5 * (0.5 * (a + b) * eq + 0.5 * (a - b) * rq) + gam
              for a, b, gam in abg]
    else:
        delta_s = (delta_u if flags.dimension == 3
                   else -g("scale") * nodes)
        ch, sh = torch.cosh(delta_s), torch.sinh(delta_s)
        pds_s = mT5 * (ch * g("dat") + sh * g("dant")) + W1
        xs = [mT5 * (ch * a + sh * b) + gam for a, b, gam in abg]
    x2 = xs[0] * xs[0] + xs[1] * xs[1] + xs[2] * xs[2]
    # saturate: NaN and +-inf mean |x|^2 overflowed, so E_mod = inf and
    # f_mod = 0 exactly
    x2 = torch.nan_to_num(x2, nan=math.inf, posinf=math.inf,
                          neginf=math.inf)
    E_mod = torch.sqrt(sp("m2") + torch.clamp(x2, min=0.0))
    arg = E_mod * g("invTm") - sp("baryon") * g("abm")
    if torch.is_grad_enabled() and (x.requires_grad or rn.requires_grad):
        # the double where: where |x|^2 saturated (E_mod = inf) f_mod is
        # rn / (e^(+-inf) + sign), whose derivative by the exponent is
        # exactly 0, but by 1/T_mod 0 inf = NaN; the exponent is cut from
        # the graph there and E_mod kept finite elsewhere in it
        sat = torch.isinf(x2)
        E_ok = torch.sqrt(sp("m2") + torch.clamp(
            torch.where(sat, torch.zeros_like(x2), x2), min=0.0))
        f_mod = torch.where(
            sat, scaled_fermi_bose(cs(rn), arg.detach(), sp("sign")),
            scaled_fermi_bose(cs(rn), E_ok * g("invTm")
                              - sp("baryon") * g("abm"), sp("sign")))
    else:
        f_mod = scaled_fermi_bose(cs(rn), arg, sp("sign"))
    if flags.remap:
        f_mod = f_mod * g("scale")

    bd = g("bd") > 0
    if flags.dimension == 3:
        detA = g("detA")
        bd = bd | ((detA < NARROW_DETA) & (torch.abs(delta_u) < detA))
    pds = torch.where(bd, pds_u, pds_s)
    contrib = pds * torch.where(bd, f_fb, f_mod)
    zero = torch.zeros_like(contrib)
    # an f_mod of exactly 0 emits nothing, also where p.dsigma overflowed
    # (2+1D fixed nodes at a large eta_scale: cosh is inf in float32), where
    # the JAX package's 0 inf is NaN
    contrib = torch.where(~bd & (f_mod == 0), zero, contrib)
    if flags.outflow:
        contrib = torch.where(pds > 0.0, contrib, zero)
    return contrib * cs(wcs)


def _plain_chunk(x, rn, wcs, mom: MomentumConstants,
                 flags: FeqmodFlags) -> torch.Tensor:
    """A chunk's feqmod_block reduced over cells (3+1D: (R, S, P, F)) or
    over cells and weighted nodes (2+1D: (S, P, F))."""
    block = feqmod_block(x, rn, wcs, mom, flags)
    if flags.dimension == 3:
        return block.sum(0)
    R = mom.nodes.shape[0]
    return (block * mom.weights.view(1, R, 1, 1, 1)).sum((0, 1))


def feqmod_spectra_plain(x: torch.Tensor, rn: torch.Tensor,
                         wcs: torch.Tensor, mom: MomentumConstants,
                         flags: FeqmodFlags,
                         cell_chunk: int = 65536) -> torch.Tensor:
    """Plain torch version of the kernels on the same inputs:
    (S, n_pT, n_phi, n_y_out), cells reduced in chunks whose block (of
    about 4 live copies) stays within common.CHUNK_ELEMENT_BUDGET."""
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    R = mom.nodes.shape[0]
    C = x.shape[0]
    chunk = effective_chunk(cell_chunk, C, 4 * R * S * P * F)
    # under autograd each chunk is recomputed in the backward
    # (torch.utils.checkpoint, JAX's remat_scan), so the reverse pass keeps
    # one chunk's block at a time; the sums are the same
    tracked = torch.is_grad_enabled() and (x.requires_grad
                                           or rn.requires_grad)
    acc = None
    for c0 in range(0, max(C, 1), chunk):
        args = (x[c0:c0 + chunk], rn[c0:c0 + chunk], wcs[c0:c0 + chunk],
                mom, flags)
        if tracked:
            part = torch.utils.checkpoint.checkpoint(
                _plain_chunk, *args, use_reentrant=False)
            acc = part if acc is None else acc + part
        else:
            part = _plain_chunk(*args)
            acc = part if acc is None else acc.add_(part)
    if flags.dimension == 3:
        out = acc.permute(1, 2, 3, 0)
    else:
        if flags.remap:
            # jacobian of the eta -> shift + s(mT) eta substitution
            acc = acc * remap_scale(mom)[:, :, None]
        out = acc[..., None]
    deg = mom.degeneracy.view(S, 1, 1, 1)
    return (CF_PREFACTOR * deg * out).contiguous()


# ------------------------------------------------------------- CUDA kernel

# the kernels' chains (csrc/feqmod.cu and feqmod_bwd.cu, Chain): f_mod, the
# fallback, and the 3+1D cells whose narrow nodes take the fallback
CHAINS = ("mod", "fallback", "narrow")


def chain_split(x: torch.Tensor, dimension: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(order, offs): the packed cells x of a group split by the kernels'
    chain, on x's device and without a host read.  Breakdown cells (bd !=
    0) take the fallback, clean cells f_mod and, in 3+1D, clean cells with
    detA < NARROW_DETA (whose nodes with |y - eta| < detA take the
    fallback) the two-chain body: ``order`` (int32, a permutation of the
    cells) holds chain j's cells at offs[j] .. offs[j + 1], each chain's in
    the group's order (a stable sort)."""
    bd = x[:, FQ["bd"]] != 0
    key = bd.to(torch.int32)
    if dimension == 3:
        narrow = (~bd) & (x[:, FQ["detA"]] < NARROW_DETA)
        key = torch.where(narrow, torch.full_like(key, 2), key)
    order = torch.sort(key, stable=True).indices.to(torch.int32)
    counts = (key[:, None] == torch.arange(
        len(CHAINS), dtype=torch.int32, device=x.device)).sum(0)
    offs = torch.zeros(len(CHAINS) + 1, dtype=torch.int32, device=x.device)
    offs[1:] = torch.cumsum(counts, 0)
    return order, offs


# The fixed-node kernel's staged layout (csrc/feqmod.cu ModRow, FbRow and
# the composites; fixed_stage): names of each slot, "" for padding.  "L"
# is log2 e in float32 (the kernels' ex2.approx on a pre-scaled argument),
# 1 in float64.
MOD_ROW = ("dax", "day", "gx0", "gx1", "gx2", "gy0", "gy1", "gy2",
           "L/T_mod", "-L alphaB_mod", "", "")
FB_ROW = ("dax", "day", "-ux", "-uy", "pixx", "piyy", "2 pixy", "L/T",
          "-L alphaB", "ksh", "kF bulkPi", "kG bulkPi", "k3 bulkPi", "benth",
          "kV", "dz - 3 dl", "dl/T", "-Vx", "-Vy", "")
MOD_COMP = ("A1", "a0", "a1", "a2")
FB_COMP = ("A1", "B1", "C1", "C2", "C3", "D1", "narrow", "")
# species a thread and nodes a register block of the fixed-node kernel
# (csrc/feqmod.cu J, YC): the staged tables pad the species to a multiple
# of J and the nodes to a multiple of YC
FIXED_J, FIXED_YC = 4, 3


def _fb_coefficients(g) -> list:
    """The fallback's per-cell coefficients as the kernels stage them
    (csrc/feqmod.cuh FbFold): ksh; df 3's kF, kG and k3 times bulkPi;
    benth, kV; df 4's dz - 3 dl and dl / T."""
    bulk = g("bulkPi")
    return [g("ksh"), g("kF") * bulk, g("kG") * bulk, g("k3") * bulk,
            g("benth"), g("kV"), g("dz") - 3.0 * g("dl"),
            g("dl") * g("invT")]


@dataclass(frozen=True)
class FixedStage:
    """What the fixed-node kernel reads of one group (fixed_stage), every
    table in the chain order of chain_split: row k is cell order[k]."""

    offs: torch.Tensor      # (4,) int32: chain j's rows offs[j] .. offs[j+1]
    mrow: torch.Tensor      # (C, 12) MOD_ROW
    frow: torch.Tensor      # (C, 20) FB_ROW
    mcomp: torch.Tensor     # (C, rp, 4) MOD_COMP at each (padded) node
    fcomp: torch.Tensor     # (C, rp, 8) FB_COMP
    rnw: torch.Tensor       # (C, s4) |renorm| x validity, 0 past S
    wj: torch.Tensor        # (C, s4) validity, 0 past S
    weights: torch.Tensor   # (rp,) node weights, 0 past the last node


def fixed_stage(x: torch.Tensor, rn: torch.Tensor, wcs: torch.Tensor,
                mom: MomentumConstants, flags: FeqmodFlags) -> FixedStage:
    """The fixed-node kernel's inputs (csrc/feqmod.cu fixed_kernel) from a
    group's packed cells, on their device: the cells sorted by chain
    (chain_split), each cell's constants folded into its rows (bulkPi and
    1/T into the fallback's bulk coefficients), the per-(cell, node)
    composites of both chains at the nodes padded to a multiple of
    FIXED_YC (the last node repeated), and the (cell, species) tables
    padded to a multiple of FIXED_J species.  Each chain's
    instantiation reads its own row, composites and species table; every
    row is a whole number of 16-byte vectors."""
    order, offs = chain_split(x, flags.dimension)
    xo = x[order.long()]
    g = lambda name: xo[:, FQ[name]]
    L = math.log2(math.e) if x.dtype == torch.float32 else 1.0
    z = torch.zeros_like(g("tau"))
    mrow = torch.stack([g("dax"), g("day"), g("gx0"), g("gx1"), g("gx2"),
                        g("gy0"), g("gy1"), g("gy2"), L * g("invTm"),
                        -(L * g("abm")), z, z], dim=1)
    frow = torch.stack([g("dax"), g("day"), -g("ux"), -g("uy"), g("pixx"),
                        g("piyy"), 2.0 * g("pixy"), L * g("invT"),
                        -(L * g("alphaB"))] + _fb_coefficients(g)
                       + [-g("Vx"), -g("Vy"), z], dim=1)
    R = mom.nodes.shape[0]
    rp = -(-R // FIXED_YC) * FIXED_YC
    ri = torch.clamp(torch.arange(rp, device=x.device), max=R - 1)
    node = mom.nodes[ri][None, :]
    c = lambda name: g(name)[:, None]
    # 3+1D: Delta = y - eta for both chains; 2+1D: f_mod at -scale eta, the
    # fallback at -eta (csrc/feqmod.cuh feqmod_node)
    du = node - c("eta") if flags.dimension == 3 else (-node).expand(
        xo.shape[0], rp)
    ds = du if flags.dimension == 3 else -(c("scale") * node)
    cs, ss = torch.cosh(ds), torch.sinh(ds)
    mcomp = torch.stack([cs * c("dat") + ss * c("dant")]
                        + [cs * c(f"a{i}") + ss * c(f"b{i}")
                           for i in range(3)], dim=2)
    ch, sh = torch.cosh(du), torch.sinh(du)
    tsh = sh * c("tau")
    narrow = ((du.abs() < c("detA")) if flags.dimension == 3
              else torch.zeros_like(du, dtype=torch.bool)).to(x.dtype)
    fcomp = torch.stack([
        ch * c("dat") + sh * c("dant"), ch * c("ut") - sh * c("tun"),
        ch * ch * c("pitt") + tsh * tsh * c("pinn")
        - 2.0 * ch * tsh * c("pitn"),
        -2.0 * (ch * c("pitx") - tsh * c("pixn")),
        -2.0 * (ch * c("pity") - tsh * c("piyn")),
        ch * c("Vt") - tsh * c("Vn"), narrow, torch.zeros_like(du)], dim=2)
    S = rn.shape[1]
    s4 = -(-S // FIXED_J) * FIXED_J
    pad = lambda t: torch.nn.functional.pad(t[order.long()], (0, s4 - S))
    live = torch.arange(rp, device=x.device) < R
    weights = torch.where(live, mom.weights[ri], torch.zeros_like(
        mom.weights[ri]))
    return FixedStage(offs=offs, mrow=mrow.contiguous(),
                      frow=frow.contiguous(), mcomp=mcomp.contiguous(),
                      fcomp=fcomp.contiguous(), rnw=pad(rn * wcs).contiguous(),
                      wj=pad(wcs).contiguous(), weights=weights.contiguous())


# The remap kernel's staged rows (csrc/feqmod.cu RemapModRow, RemapFbRow;
# remap_stage), "" for padding
REMAP_MOD_ROW = ("exp(yfm)", "zscale", "L/T_mod", "-L alphaB_mod",
                 "(dat+dant)/2", "(dat-dant)/2", "(a0+b0)/2", "(a0-b0)/2",
                 "(a1+b1)/2", "(a1-b1)/2", "(a2+b2)/2", "(a2-b2)/2", "dax",
                 "day", "gx0", "gx1", "gx2", "gy0", "gy1", "gy2")
REMAP_FB_ROW = ("exp(yflow)", "exp(-yflow)", "dat", "dant", "ut", "-tun",
                "Vt", "-tau Vn", "pitt", "tau^2 pinn", "-2 tau pitn", "",
                "L/T", "-L alphaB", "ksh", "kF bulkPi", "kG bulkPi",
                "k3 bulkPi", "benth", "kV", "dz - 3 dl", "dl/T", "dax", "day",
                "ux", "uy", "Vx", "Vy", "pixx", "piyy", "pixy", "pitx", "pity",
                "tau", "pixn", "piyn")


@dataclass(frozen=True)
class RemapStage:
    """What the remap kernel reads of one group besides the node table
    (remap_stage), every table in the chain order of chain_split."""

    offs: torch.Tensor      # (4,) int32: chain j's rows offs[j] .. offs[j+1]
    mrow: torch.Tensor      # (C, 20) REMAP_MOD_ROW
    frow: torch.Tensor      # (C, 36) REMAP_FB_ROW
    rnzw: torch.Tensor      # (C, S) |renorm| x zscale x validity
    wj: torch.Tensor        # (C, S) validity


def remap_stage(x: torch.Tensor, rn: torch.Tensor, wcs: torch.Tensor
                ) -> RemapStage:
    """The remap kernel's inputs (csrc/feqmod.cu remap_kernel) from a
    group's packed cells, on their device: the cells sorted by chain
    (chain_split), the per-cell constants of each chain folded into its
    row (exp(+-y_flow), L / T, the half sums of the node terms, the
    fallback's coefficients with bulkPi and 1/T folded in), and the (cell,
    species) tables in that order; every row a whole number of 16-byte
    vectors."""
    order, offs = chain_split(x, 2)
    xo = x[order.long()]
    g = lambda name: xo[:, FQ[name]]
    L = math.log2(math.e) if x.dtype == torch.float32 else 1.0
    z = torch.zeros_like(g("tau"))
    half = lambda a, b, sign: (g(a) + sign * g(b)) * 0.5
    mrow = torch.stack(
        [torch.exp(g("yfm")), g("scale"), L * g("invTm"), -(L * g("abm")),
         half("dat", "dant", 1), half("dat", "dant", -1)]
        + [half(f"a{i}", f"b{i}", sgn) for i in range(3) for sgn in (1, -1)]
        + [g(n) for n in ("dax", "day", "gx0", "gx1", "gx2", "gy0", "gy1",
                          "gy2")], dim=1)
    tau = g("tau")
    frow = torch.stack(
        [torch.exp(g("yflow")), torch.exp(-g("yflow")), g("dat"), g("dant"),
         g("ut"), -g("tun"), g("Vt"), -(tau * g("Vn")), g("pitt"),
         tau * tau * g("pinn"), -2.0 * tau * g("pitn"), z, L * g("invT"),
         -(L * g("alphaB"))] + _fb_coefficients(g)
        + [g(n) for n in ("dax", "day", "ux", "uy", "Vx", "Vy", "pixx",
                          "piyy", "pixy", "pitx", "pity", "tau", "pixn",
                          "piyn")], dim=1)
    o = order.long()
    return RemapStage(offs=offs, mrow=mrow.contiguous(),
                      frow=frow.contiguous(),
                      rnzw=((rn * x[:, FQ["scale"], None]) * wcs)[o]
                      .contiguous(), wj=wcs[o].contiguous())


def _library():
    from ..native.build import cuda_library
    lib = cuda_library("feqmod")
    if not getattr(lib, "_is3d_bound", False):
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for fn in (lib.is3d_feqmod_grid_f32, lib.is3d_feqmod_grid_f64):
            fn.restype = ci
            fn.argtypes = [ci] * 6 + [ctypes.POINTER(ci)]  # S P F R dim remap
        for fn in (lib.is3d_feqmod_f32, lib.is3d_feqmod_f64):
            fn.restype = ci
            fn.argtypes = [vp, vp, vp, vp, vp, vp,     # fixed_stage's tables
                           vp, ci, ci, ci,             # offs, C, s4, rp
                           vp, vp, vp, vp, ci,         # species, n_species
                           vp, vp, vp, ci, ci,         # pT px py n_pT n_phi
                           vp, ci,                     # weights (rp), R
                           ci, ci, ci, ci, ci,         # df, dim, sw, reg, out
                           cd, ci, vp,                 # prefactor, parts
                           vp, vp]                     # out, stream
        lib.is3d_feqmod_props.restype = ci
        lib.is3d_feqmod_props.argtypes = [ci] * 6 + [vp]
        for fn in (lib.is3d_feqmod_remap_f32, lib.is3d_feqmod_remap_f64):
            fn.restype = ci
            fn.argtypes = [vp, vp, vp, vp, vp, ci,     # remap_stage, offs, C
                           vp, vp, vp, vp, ci,         # species, n_species
                           vp, ci, vp, vp, ci,         # pT, n_pT, cos, sin, F
                           vp, vp, vp, ci,             # table, nodes, wts, R
                           ci, ci, ci, ci,             # df, sw, reg, outflow
                           cd, cd, ci, ci, vp,         # CF T_ref splits parts
                           vp, vp]                     # out, stream
        lib.is3d_cuda_error_string.restype = ctypes.c_char_p
        lib.is3d_cuda_error_string.argtypes = [ci]
        lib._is3d_bound = True
    return lib


def feqmod_grid(lib, device: torch.device, f64: bool, n_species: int,
                n_pT: int, n_phi: int, n_nodes: int, dimension: int,
                remap: bool):
    """A feqmod kernel's launch.KernelGrid for one shape on one card
    (csrc/feqmod.cu:feqmod_grid owns the blocking)."""
    return kernel_grid(
        lib, "feqmod",
        lib.is3d_feqmod_grid_f64 if f64 else lib.is3d_feqmod_grid_f32,
        device, n_species, n_pT, n_phi, n_nodes, dimension, int(remap))


def _main_switches(flags: FeqmodFlags) -> bool:
    """Whether the kernels' instantiations compile the switches in: the
    main paths' shear + bulk, regulate and outflow (csrc/feqmod.cu
    main_switches)."""
    return flags.switches == 3 and flags.regulate and flags.outflow


def chain_props(device: torch.device, f64: bool, flags: FeqmodFlags,
                chain: int, n_phi: int) -> dict:
    """The launch shape and resources (launch.kernel_props) of the
    instantiation of ``chain`` (an index of CHAINS) that ``flags`` launch
    (the remap kernel's at n_phi angles)."""
    lib = _library()
    return kernel_props(lib, "feqmod", lib.is3d_feqmod_props, device,
                        int(f64), 0 if flags.remap else flags.dimension,
                        chain, flags.df_mode, int(_main_switches(flags)),
                        n_phi)


def chain_kernel_name(flags: FeqmodFlags, chain: int, n_phi: int) -> str:
    """The mangled name's part that picks the float32 kernel of ``chain``
    that ``flags`` launch (for tools/sass_count.py): csrc/feqmod.cu
    fixed_kernel<T, DIM, CHAIN, DF, MAIN> or remap_kernel<T, NPHI, CHAIN,
    DF, MAIN> (f_mod with DF = 0)."""
    df = 0 if chain == 0 else flags.df_mode
    tail = f"Li{chain}ELi{df}ELb{int(_main_switches(flags))}EE"
    if flags.remap:
        width = min((8, 16, 24), key=lambda w: (-(-n_phi // w) * w, -w))
        return f"remap_kernelIfLi{width}E" + tail
    return f"fixed_kernelIfLi{flags.dimension}E" + tail


def feqmod_spectra_cuda(x: torch.Tensor, rn: torch.Tensor, wcs: torch.Tensor,
                        mom: MomentumConstants, flags: FeqmodFlags,
                        table: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the hand-written kernel (csrc/feqmod.cu) on the current
    stream: (S, n_pT, n_phi, n_y_out) in the cells' dtype.  The group is
    laid out by fixed_stage (remap_stage with the remap), sorted by chain
    on the card, and each chain's instantiation launched over its part, no
    host read between.  With ``flags.remap``, ``table`` is
    ``smooth.remap_node_table(mom)`` (the fallback's shared nodes), built
    here if not given."""
    global LAUNCHES, REMAP_LAUNCHES
    check_float("feqmod_spectra_cuda", x)
    C = x.shape[0]
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    R = mom.nodes.shape[0]
    check_tensor("cells", x, (C, NQ), x)
    check_tensor("rn", rn, (C, S), x)
    check_tensor("wcs", wcs, (C, S), x)
    for name, n in dict(mass=S, sign=S, baryon=S, degeneracy=S, pT=P,
                        px=P * F, py=P * F, nodes=R, weights=R, cos_phi=F,
                        sin_phi=F).items():
        check_tensor(f"momentum constant {name}", getattr(mom, name), (n,),
                     x)
    if flags.remap and table is not None:
        check_tensor("remap node table", table, (S, P, R, 2), x)
    require_cuda("feqmod_spectra_cuda", x)
    lib = _library()
    f64 = x.dtype == torch.float64
    grid = feqmod_grid(lib, x.device, f64, S, P, F, R, flags.dimension,
                       flags.remap)
    _, n_split = tile_split(C, grid)
    n_parts = n_split * grid.parts
    n_out = R if flags.dimension == 3 else 1
    out = x.new_empty((S, P, F, n_out))
    partial = x.new_empty((n_parts, S, P, F, n_out))
    species = (mom.mass.data_ptr(), mom.sign.data_ptr(),
               mom.baryon.data_ptr(), mom.degeneracy.data_ptr(), S)
    sw = (flags.df_mode, flags.switches, int(flags.regulate),
          int(flags.outflow))
    if flags.remap:
        if table is None:
            table = remap_node_table(mom)
        st = remap_stage(x, rn, wcs)
        launch(lib, "feqmod remap",
               lib.is3d_feqmod_remap_f64 if f64 else lib.is3d_feqmod_remap_f32,
               x.device, st.mrow.data_ptr(), st.frow.data_ptr(),
               st.rnzw.data_ptr(), st.wj.data_ptr(), st.offs.data_ptr(), C,
               *species, mom.pT.data_ptr(), P, mom.cos_phi.data_ptr(),
               mom.sin_phi.data_ptr(), F, table.data_ptr(),
               mom.nodes.data_ptr(), mom.weights.data_ptr(), R, *sw,
               CF_PREFACTOR, ETA_REMAP_T_REF, n_split, n_parts,
               partial.data_ptr(), out.data_ptr())
        REMAP_LAUNCHES += 1
        return out
    st = fixed_stage(x, rn, wcs, mom, flags)
    launch(lib, "feqmod", lib.is3d_feqmod_f64 if f64 else lib.is3d_feqmod_f32,
           x.device, st.mrow.data_ptr(), st.frow.data_ptr(),
           st.mcomp.data_ptr(), st.fcomp.data_ptr(), st.rnw.data_ptr(),
           st.wj.data_ptr(), st.offs.data_ptr(), C, st.rnw.shape[1],
           st.mcomp.shape[1], *species, mom.pT.data_ptr(), mom.px.data_ptr(),
           mom.py.data_ptr(), P, F, st.weights.data_ptr(), R, flags.df_mode,
           flags.dimension, *sw[1:], CF_PREFACTOR, n_parts,
           partial.data_ptr(), out.data_ptr())
    LAUNCHES += 1
    return out


# ------------------------------------------------------ backward kernels

def feqmod_bwd_plain(x: torch.Tensor, rn: torch.Tensor, wcs: torch.Tensor,
                     G: torch.Tensor, mom: MomentumConstants,
                     flags: FeqmodFlags, cell_chunk: int = 65536
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels: the gradients (C, NQ) and
    (C, S) of <G, feqmod_spectra_plain(x, rn, wcs)> with respect to the
    packed cells and rn, by torch autograd of the plain version."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        rg = rn.detach().requires_grad_(True)
        out = feqmod_spectra_plain(xg, rg, wcs, mom, flags, cell_chunk)
        return torch.autograd.grad(out, (xg, rg), G)


def _bwd_library():
    from ..native.build import cuda_library
    lib = cuda_library("feqmod_bwd")
    if not getattr(lib, "_is3d_bound", False):
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for fn in (lib.is3d_feqmod_bwd_f32, lib.is3d_feqmod_bwd_f64):
            fn.restype = ci
            fn.argtypes = [vp, ci, ci,                 # cells, C, nq
                           vp, vp, ci,                 # order, offs, chain
                           vp, vp,                     # rn, wcs
                           vp, vp, vp, vp, ci,         # species, n_species
                           vp, ci, vp, vp, ci,         # pT n_pT px/cos py F
                           vp, vp, ci,                 # nodes, weights, R
                           ci, ci, ci, ci, ci,         # df dim sw reg out
                           cd, cd, vp, vp, vp, vp]     # CF T_ref G grads strm
        lib.is3d_feqmod_bwd_props.restype = ci
        lib.is3d_feqmod_bwd_props.argtypes = [ci] * 8 + [vp]
        lib.is3d_cuda_error_string.restype = ctypes.c_char_p
        lib.is3d_cuda_error_string.argtypes = [ci]
        lib._is3d_bound = True
    return lib


def bwd_props(device: torch.device, f64: bool, mom: MomentumConstants,
              flags: FeqmodFlags, chain: int) -> dict:
    """The launch shape and resources (launch.kernel_props) of the backward
    kernel of ``chain`` (an index of CHAINS) at mom's shape."""
    lib = _bwd_library()
    dim = 0 if flags.remap else flags.dimension
    return kernel_props(lib, "feqmod_bwd", lib.is3d_feqmod_bwd_props, device,
                        int(f64), dim, flags.df_mode, chain, flags.switches,
                        mom.pT.shape[0], mom.n_phi, mom.nodes.shape[0])


def bwd_kernel_name(flags: FeqmodFlags, chain: int) -> str:
    """The mangled name's part that picks the float32 backward kernel of
    ``chain`` in the library (for tools/sass_count.py): csrc/feqmod_bwd.cu
    compiles the fallback's terms in where they are shear + bulk (FSW)."""
    fsw = "Li3E" if chain != 0 and flags.switches == 3 else "Lin1E"
    if flags.remap:
        return f"feqmod_remap_bwd_kernelIfLi{flags.df_mode}ELi{chain}E{fsw}E"
    return (f"feqmod_bwd_kernelIfLi{flags.dimension}ELi{flags.df_mode}E"
            f"Li{chain}E{fsw}E")


def feqmod_bwd_cuda(x: torch.Tensor, rn: torch.Tensor, wcs: torch.Tensor,
                    G: torch.Tensor, mom: MomentumConstants,
                    flags: FeqmodFlags) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernel (csrc/feqmod_bwd.cu) on the current
    stream: the gradients (C, NQ) and (C, S) of <G, feqmod_spectra_cuda(x,
    rn, wcs, mom, flags)> with respect to the packed cells and rn, G of the
    output's shape (S, n_pT, n_phi, n_y_out).  The cells are split by chain
    on the card (chain_split) and each chain's instantiation launched
    over its part (two launches, three in 3+1D), no host read between."""
    global BWD_LAUNCHES, BWD_REMAP_LAUNCHES
    check_float("feqmod_bwd_cuda", x)
    C = x.shape[0]
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    R = mom.nodes.shape[0]
    n_out = R if flags.dimension == 3 else 1
    check_tensor("cells", x, (C, NQ), x)
    check_tensor("rn", rn, (C, S), x)
    check_tensor("wcs", wcs, (C, S), x)
    check_tensor("G", G, (S, P, F, n_out), x)
    for name, n in dict(mass=S, sign=S, baryon=S, degeneracy=S, pT=P,
                        px=P * F, py=P * F, nodes=R, weights=R, cos_phi=F,
                        sin_phi=F).items():
        check_tensor(f"momentum constant {name}", getattr(mom, name), (n,),
                     x)
    require_cuda("feqmod_bwd_cuda", x)
    lib = _bwd_library()
    f64 = x.dtype == torch.float64
    grad = torch.empty_like(x)
    grad_rn = torch.empty_like(rn)
    order, offs = chain_split(x, flags.dimension)
    fn = lib.is3d_feqmod_bwd_f64 if f64 else lib.is3d_feqmod_bwd_f32
    if flags.remap:
        xy, dim = (mom.cos_phi, mom.sin_phi), 0
    else:
        xy, dim = (mom.px, mom.py), flags.dimension
    for chain in range(3 if dim == 3 else 2):
        launch(lib, "feqmod_bwd remap" if flags.remap else "feqmod_bwd", fn,
               x.device, x.data_ptr(), C, NQ, order.data_ptr(),
               offs.data_ptr(), chain, rn.data_ptr(), wcs.data_ptr(),
               mom.mass.data_ptr(), mom.sign.data_ptr(),
               mom.baryon.data_ptr(), mom.degeneracy.data_ptr(), S,
               mom.pT.data_ptr(), P, xy[0].data_ptr(), xy[1].data_ptr(), F,
               mom.nodes.data_ptr(), mom.weights.data_ptr(), R,
               flags.df_mode, dim, flags.switches, int(flags.regulate),
               int(flags.outflow), CF_PREFACTOR, ETA_REMAP_T_REF,
               G.data_ptr(), grad.data_ptr(), grad_rn.data_ptr())
    if flags.remap:
        BWD_REMAP_LAUNCHES += 1
    else:
        BWD_LAUNCHES += 1
    return grad, grad_rn


class _FeqmodKernel(torch.autograd.Function):
    """feqmod_spectra_cuda with its backward kernel: the forward keeps only
    the packed cells, rn and wcs (as JAX's remat keeps a chunk's inputs),
    and the backward recomputes everything else inside feqmod_bwd_cuda."""

    @staticmethod
    def forward(ctx, x, rn, wcs, mom, flags, table):
        ctx.save_for_backward(x, rn, wcs)
        ctx.mom, ctx.flags = mom, flags
        return feqmod_spectra_cuda(x, rn, wcs, mom, flags, table)

    @staticmethod
    def backward(ctx, G):
        x, rn, wcs = ctx.saved_tensors
        gx, grn = feqmod_bwd_cuda(x, rn, wcs, G.contiguous(), ctx.mom,
                                  ctx.flags)
        return gx, grn, None, None, None, None


def group_spectra(x: torch.Tensor, rn: torch.Tensor, wcs: torch.Tensor,
                  mom: MomentumConstants, flags: FeqmodFlags,
                  table: torch.Tensor | None = None,
                  cell_chunk: int = 65536) -> torch.Tensor:
    """One group's spectra from its packed inputs on their device: the
    kernel (with its backward kernel under autograd) for CUDA tensors, the
    plain version (autograd through it) for CPU tensors."""
    if x.device.type == "cuda":
        if torch.is_grad_enabled() and (x.requires_grad or rn.requires_grad):
            return _FeqmodKernel.apply(x, rn, wcs, mom, flags, table)
        return feqmod_spectra_cuda(x, rn, wcs, mom, flags, table)
    if x.device.type == "cpu":
        return feqmod_spectra_plain(x, rn, wcs, mom, flags, cell_chunk)
    raise ValueError(f"no feqmod spectra path for device {x.device}")


# ------------------------------------------------------------ entry point

def group_inputs(cols: dict, species: SpeciesArrays, laguerre: dict,
                 df_data: DeltafData, cfg: Config, flags: FeqmodFlags):
    """(x, rn, wcs) of one group of raw cell columns."""
    c = prepare_cells(cols, cfg, df_data)
    c = prepare_feqmod_cells(c, species, laguerre, cfg,
                             eta_rescaled=flags.remap)
    return pack_feqmod_cells(c, cfg, flags)


def _group_spectra(cols: dict, species: SpeciesArrays, mom: MomentumConstants,
                   flags: FeqmodFlags, laguerre: dict, df_data: DeltafData,
                   table: torch.Tensor | None, cfg: Config) -> torch.Tensor:
    if torch.is_grad_enabled() and any(v.requires_grad
                                       for v in cols.values()):
        # under autograd the per-cell algebra is recomputed in the backward
        # (JAX's remat of the chunk body): a group's (cell, species)
        # Gauss-Laguerre blocks are not kept across the groups
        x, rn, wcs = torch.utils.checkpoint.checkpoint(
            group_inputs, cols, species, laguerre, df_data, cfg, flags,
            use_reentrant=False)
    else:
        x, rn, wcs = group_inputs(cols, species, laguerre, df_data, cfg,
                                  flags)
    return group_spectra(x, rn, wcs, mom, flags, table, cfg.cell_chunk)


def feqmod_reduction(cols: dict, species: SpeciesArrays, grid: MomentumGrid,
                     df_data: DeltafData, cfg: Config,
                     laguerre: dict | None = None) -> tuple:
    """(kernel_fn, replicated) of the df 3-4 spectra's cell reduction over
    ``cols`` (the whole surface's or a rank's slice)."""
    flags = feqmod_flags(cfg, grid)
    dev, dt = cols["tau"].device, cols["tau"].dtype
    laguerre = laguerre_in_precision(laguerre, dt, dev)
    mom = momentum_constants(species, grid, cfg.dimension)
    # the remap kernel's fallback node table, once for every group
    table = (remap_node_table(mom)
             if flags.remap and dev.type == "cuda" else None)
    return ((lambda c, sp, m, fl, lag, d, t: _group_spectra(
        c, sp, m, fl, lag, d, t, cfg)),
        (species, mom, flags, laguerre, df_data, table))


def smooth_spectra_feqmod(surface, species: SpeciesArrays, grid: MomentumGrid,
                          df_data: DeltafData, cfg: Config,
                          laguerre: dict | None = None,
                          mesh=None) -> torch.Tensor:
    """dN/(pT dpT dphi dy) with modified equilibrium df (modes 3-4), shape
    (S, n_pT, n_phi, n_y_out), on the surface's device.

    The cell reduction runs through the canonical group tree
    (parallel/mesh.grouped_cell_reduce): one kernel launch per group,
    partials folded in group order; with ``mesh`` (a CellMesh) each rank
    launches its own groups and returns the full spectra.  The
    Gauss-Laguerre table (default 32 nodes, alphas 1 and 2) is replicated
    to every group like df_data, in the surface's precision."""
    from ..parallel.mesh import grouped_cell_reduce
    cols = surface_columns(surface, cfg)
    fn, replicated = feqmod_reduction(cols, species, grid, df_data, cfg,
                                      laguerre)
    return grouped_cell_reduce(fn, cols, replicated, cfg, mesh=mesh)
