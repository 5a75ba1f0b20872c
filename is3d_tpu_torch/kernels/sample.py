"""Monte-Carlo particle sampler (operation 2): discrete hadron lists from
the Cooper-Frye emission function of a viscous-hydro surface (df 1-4) or
an anisotropic-hydro one (modes 2-3).

Port of is3d_tpu/kernels/sample.py (the reference's sampler,
emissionfunction_sampling_kernels.cpp:653-1225, restructured for a
data-parallel device; its VAH sampler is a stub there, so is3d_tpu is the
only oracle of that branch):

* Phase A (``cell_data``, ``vah_cell_data``): per cell the LRF tetrad,
  dsigma / pi / V (VAH: W) in the LRF, the df coefficients, the feqmod
  transform and breakdown, and the (cell, species) densities dn by
  Gauss-Laguerre quadrature (``species_yields``, kernel K7b on the card,
  csrc/yields.cu); then the tables of the (cell, species) draw: the
  Walker-alias tables (``build_alias_tables``, kernel K7a), or with
  ``sampler_alias = 0`` the cumulative sums the binary searches read
  (``build_search_tables``).
* Phase B, one batch of B events x n_cap hadron slots
  (``event_batch_packed``): by Poisson superposition one count n ~
  Poisson(sum dn) an event, each slot < n drawing its cell and species
  (alias picks or binary searches), its LRF momentum by rejection, the
  feqmod rescale or the VAH stretch pz = a_L qz, the viscous and flux
  keep, and the lab boost; the kept slots compacted to event-major packed
  arrays.  On the card this is kernel K7 (csrc/sample.cuh), tiles of slots
  with the compaction in the same launch, one library per surface kind
  and draw (``_library``); its plain version is ``event_batch_plain``
  (every slot) and ``pack_batch`` (a cumsum and an index copy), and its
  per-slot mode (``event_batch_cuda``) is what the plain version is held
  to slot by slot.
* The host drains batches (``_drain_event_range``): the device-to-host
  copy of batch k runs on a side stream while batch k+1's kernel runs, and
  a batch whose kept hadrons overflow the packed capacity is run again at
  twice the capacity (its streams are counter-keyed: the same hadrons).
* Surfaces above ``sampler_cell_chunk`` cells (by default 2^19-cell chunks
  above 2^20 cells) run chunk by chunk (``_sample_cell_chunked``): each
  chunk an independent sub-surface under its own seed, one chunk's tables
  on the device at a time, the events merged in chunk order.

Random numbers: the port's own Philox streams (kernels/rng.py), keyed on
(seed, global event, slot, rejection round, purpose); the per-event count
is drawn on the host from numpy's Philox keyed on (seed, event).  Event i
depends only on (seed, i), so ``event_partition`` slices concatenate to
the unpartitioned run byte for byte.  The lists equal is3d_tpu's in
distribution, not event by event (its streams are Threefry's).

Over several GPUs (``mesh=``, a parallel.mesh.CellMesh;
``sample_particles_sharded``) the cell axis is cut into one chunk a rank:
rank r runs the chunked driver's chunk r alone and the ranks gather their
event lists in rank order, so every rank returns one process's
``_sample_cell_chunked`` list with ``sampler_cell_chunk = ceil(C / W)``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import time
import warnings
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..data import SpeciesArrays
from ..io.deltaf import DeltafData, evaluate_df_coefficients
from ..io.tables import laguerre_device
from ..physics import lrf, thermal
from ..parallel.mesh import _pad_inert
from ..units import TWO_PI2_HBARC3
from . import rng
from .common import CHUNK_ELEMENT_BUDGET, prepare_cells, surface_columns
from .feqmod import adjugate_sym, mode3_breakdown
from .launch import check_float, check_tensor, launch, require_cuda
from .vah import complete_vah_cells, effective_vah_cfg

TWO_PI = 2.0 * math.pi
MBAR_LIGHT = 1.008        # light/heavy proposal split (reference :481)
MAX_REJECTION_ROUNDS = 256
CELL_BLOCK = 512          # cells per row of the 2-level cell alias table

# kernel launches.  K7, event batches, per-slot and packed, by surface and
# draw: viscous hydro with alias draws (LAUNCHES, PACKED_LAUNCHES), VAH
# with alias draws (VAH_*), either with the binary-search draws
# (SEARCH_*); K7a, alias tables; K7b, the densities, viscous hydro and
# VAH
LAUNCHES = 0
PACKED_LAUNCHES = 0
VAH_LAUNCHES = 0
VAH_PACKED_LAUNCHES = 0
SEARCH_LAUNCHES = 0
SEARCH_PACKED_LAUNCHES = 0
ALIAS_LAUNCHES = 0
YIELDS_LAUNCHES = 0
YIELDS_VAH_LAUNCHES = 0


def _count(name: str):
    globals()[name] += 1


def resolve_cell_chunk(cfg: Config, n_cells: int):
    """Chunk size in cells, or None for the single phase A
    (is3d_tpu/kernels/sample.py:_resolve_cell_chunk)."""
    v = int(cfg.sampler_cell_chunk)
    if v < 0:
        return None
    if v == 0:
        return (1 << 19) if n_cells > (1 << 20) else None
    return v if n_cells > v else None


def pion_thermal_weight_max(x):
    """Max of the light-hadron equilibrium weight for m/T < 0.8554
    (rational fit, reference: emissionfunction_sampling_kernels.cpp:172-195)."""
    x2 = x * x
    x3 = x2 * x
    x4 = x3 * x
    num = (143206.88623164667 - 95956.76008684626 * x - 21341.937407169076 * x2
           + 14388.446116867359 * x3 - 6083.775788504437 * x4)
    den = (-0.3541350577684533 + 143218.69233952634 * x - 24516.803600065778 * x2
           - 115811.59391199696 * x3 + 35814.36403387459 * x4)
    return 1.00001 * num / den


# ======================================================================
# Alias tables (K7a)
# ======================================================================

def _next_pow2_int(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def alias_scale(weights: torch.Tensor) -> torch.Tensor:
    """Each row scaled to mean 1 (zero rows: all ones)."""
    R, K = weights.shape
    W = weights.sum(dim=1, keepdim=True)
    safe = torch.where(W > 0.0, W, torch.ones_like(W))
    return torch.where(W > 0.0, weights * (float(K) / safe),
                       torch.ones_like(weights)).contiguous()


def _sort_rows(q0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows sorted descending, stably, with the original index of each
    sorted entry (int32)."""
    qs, order = torch.sort(-q0, dim=1, stable=True)
    return (-qs).contiguous(), order.to(torch.int32).contiguous()


def alias_sort(weights: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The input of the Vose pass: ``alias_scale``'s rows sorted
    descending, stably, with the original index of each sorted entry."""
    return _sort_rows(alias_scale(weights))


def alias_tables_plain(qs: torch.Tensor, order: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Vose two-pointer pass of is3d_tpu's _alias_build (:92-162) over
    rows sorted descending (``alias_sort``), vectorized over rows: each of
    the K steps finalizes one slot of every row, the donor i when it has
    dropped below 1, else the smallest untouched entry j against it.
    Returns (prob, alias) in the rows' original slot order."""
    R, K = qs.shape
    qs = qs.clone()
    order = order.long()
    rows = torch.arange(R, device=qs.device)
    prob_s = torch.ones_like(qs)
    alias_s = torch.zeros((R, K), dtype=torch.long, device=qs.device)
    i = torch.zeros(R, dtype=torch.long, device=qs.device)
    j = torch.full((R,), K - 1, dtype=torch.long, device=qs.device)
    one = torch.ones((), dtype=qs.dtype, device=qs.device)
    for _ in range(K):
        qi = qs[rows, i]
        last = i == j
        small_i = (qi < 1.0) & ~last
        ip1 = torch.clamp(i + 1, max=K - 1)
        qj = qs[rows, j]
        pos = torch.where(last | small_i, i, j)
        prob_val = torch.where(last, one, torch.clamp(
            torch.where(small_i, qi, qj), 0.0, 1.0))
        alias_pos = torch.where(last, i, torch.where(small_i, ip1, i))
        alias_val = order[rows, alias_pos]
        upd_idx = torch.where(small_i, ip1, i)
        upd_val = torch.where(small_i, qs[rows, ip1] - (1.0 - qi),
                              torch.where(last, qi, qi - (1.0 - qj)))
        qs[rows, upd_idx] = upd_val
        prob_s[rows, pos] = prob_val
        alias_s[rows, pos] = alias_val
        step = small_i | last
        i = torch.where(step, i + 1, i)
        j = torch.where(step, j, j - 1)
    prob = torch.ones_like(prob_s).scatter_(1, order, prob_s)
    alias = torch.zeros_like(alias_s).scatter_(1, order, alias_s)
    return prob, alias.to(torch.int32)


def _pair_views(pairs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(prob, alias) of an interleaved (R, K, 2) table: an entry is prob,
    then alias (int32) in the next 32-bit word, 2 x itemsize bytes."""
    return pairs[..., 0], pairs.view(torch.int32)[..., pairs.element_size()
                                                 // 4]


def pair_table(prob: torch.Tensor, alias: torch.Tensor) -> torch.Tensor:
    """The interleaved (R, K, 2) table the event kernel reads a (prob,
    alias) entry of in one load: the storage of ``prob`` and ``alias``
    where they are K7a's views of one (``alias_tables_cuda``), else a copy
    into a new one."""
    R, K = prob.shape
    w = prob.element_size() // 4
    if (prob.stride() == (2 * K, 2) and alias.stride() == (2 * K * w, 2 * w)
            and alias.dtype == torch.int32
            and alias.data_ptr() == prob.data_ptr() + prob.element_size()
            and prob.storage_offset() == 0):
        return prob.as_strided((R, K, 2), (2 * K, 2, 1))
    pairs = torch.zeros((R, K, 2), dtype=prob.dtype, device=prob.device)
    p, a = _pair_views(pairs)
    p.copy_(prob)
    a.copy_(alias)
    return pairs


def alias_tables_cuda(q0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K7a (csrc/sample.cu, alias_kernel) on ``alias_scale``'s rows: the
    stable descending sort and the pass of ``alias_tables_plain`` in one
    launch, rows staged in shared memory (rows too long for it: torch's
    sort, then a thread a row in device memory).  Returns (prob, alias) as
    strided views of one interleaved table (``pair_table``)."""
    global ALIAS_LAUNCHES
    check_float("alias_tables_cuda", q0)
    R, K = q0.shape
    check_tensor("scaled weights", q0, (R, K), q0)
    require_cuda("alias_tables_cuda", q0)
    lib = _library()
    f64 = q0.dtype == torch.float64
    per_block = lib.is3d_alias_rows_per_block(K, int(f64))
    if per_block < 0:
        raise RuntimeError("alias tables: no launch configuration: "
                           f"{lib.is3d_cuda_error_string(-per_block)}")
    pairs = torch.empty((R, K, 2), dtype=q0.dtype, device=q0.device)
    if per_block:
        fn = lib.is3d_alias_build_f64 if f64 else lib.is3d_alias_build_f32
        launch(lib, "alias tables", fn, q0.device, q0.data_ptr(), R, K,
               pairs.data_ptr())
    else:
        qs, order = _sort_rows(q0)
        fn = (lib.is3d_alias_build_sorted_f64 if f64
              else lib.is3d_alias_build_sorted_f32)
        launch(lib, "alias tables", fn, q0.device, qs.data_ptr(),
               order.data_ptr(), R, K, pairs.data_ptr())
    ALIAS_LAUNCHES += 1
    return _pair_views(pairs)


def alias_build(weights: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Walker alias tables (prob (R, K), alias (R, K) int32) of R
    categorical rows of nonnegative ``weights``: u in [0, 1) picks
    b = floor(u K), then b if frac(u K) < prob[b] else alias[b].  Rows of
    zero total weight get uniform tables.  K7a on CUDA tensors, the plain
    pass on CPU ones."""
    if weights.device.type == "cpu":
        return alias_tables_plain(*alias_sort(weights))
    return alias_tables_cuda(alias_scale(weights))


def alias_pick(prob, alias, row_idx, u):
    """One alias draw per query: u in [0, 1) -> column index of row_idx."""
    K = prob.shape[1]
    x = u * K
    b = torch.clamp(x.to(torch.int32), max=K - 1).long()
    f = x - b.to(x.dtype)
    row_idx = row_idx.long()
    return torch.where(f < prob[row_idx, b], b,
                       alias[row_idx, b].long()).to(torch.int32)


def build_alias_tables(dn_list: torch.Tensor, dn_tot: torch.Tensor) -> dict:
    """The 2-level cell draw (rows of CELL_BLOCK cells and one row over
    the blocks) and the per-cell species draw
    (is3d_tpu/kernels/sample.py:_build_alias_tables)."""
    C = dn_tot.shape[0]
    CB = min(CELL_BLOCK, _next_pow2_int(C))
    G = -(-C // CB)
    blocks = torch.cat([dn_tot, dn_tot.new_zeros(G * CB - C)]).reshape(G, CB)
    grp_prob, grp_alias = alias_build(blocks.sum(dim=1)[None])
    blk_prob, blk_alias = alias_build(blocks)
    sp_prob, sp_alias = alias_build(dn_list)
    return dict(grp_prob=grp_prob, grp_alias=grp_alias, blk_prob=blk_prob,
                blk_alias=blk_alias, sp_prob=sp_prob, sp_alias=sp_alias)


def build_search_tables(dn_list: torch.Tensor, dn_tot: torch.Tensor,
                        lam: float) -> dict:
    """The tables of the binary-search draws (``sampler_alias = 0``,
    is3d_tpu/kernels/sample.py:468-472): each cell's cumulative species
    row ``rowcum`` (C, S), the cumulative cell weights ``cum_dn`` (C,) and
    ``lam``, the Poisson mean the cell draw scales its uniform by."""
    return dict(rowcum=torch.cumsum(dn_list, dim=1), cum_dn=torch.cumsum(
        dn_tot, dim=0), lam=float(lam))


def build_draw_tables(dn_list: torch.Tensor, dn_tot: torch.Tensor,
                      cfg: Config, lam: float) -> dict:
    """The (cell, species) draw's tables: alias tables, or with
    ``sampler_alias = 0`` the searches' cumulative sums."""
    if cfg.sampler_alias:
        return build_alias_tables(dn_list, dn_tot)
    return build_search_tables(dn_list, dn_tot, lam)


def _search(tables: dict) -> bool:
    return "rowcum" in tables


def row_categorical(rowcum: torch.Tensor, cidx: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """The first s with rowcum[cidx, s] >= v, by binary search in
    S.bit_length() halvings, one gather each
    (is3d_tpu/kernels/sample.py:_row_categorical: the interval has width
    S, so pinning it takes ceil(log2(S + 1)) <= S.bit_length() halvings).
    v <= rowcum[cidx, S - 1], so no halving reads past the row."""
    S = rowcum.shape[1]
    flat = rowcum.reshape(-1)
    base = cidx.long() * S
    lo = torch.zeros_like(base)
    hi = torch.full_like(base, S)
    for _ in range(S.bit_length()):
        mid = (lo + hi) // 2
        right = flat[base + torch.clamp(mid, max=S - 1)] < v
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(right, hi, mid)
    return torch.clamp(lo, 0, S - 1)


# ======================================================================
# Phase A: the (cell, species) densities (K7b)
# ======================================================================

# the per-cell columns of K7b's input, by kernel mode (csrc/yields.cu:
# VhCol, VahCol)
YIELDS_VH_COLS = ("T", "alphaB", "bulkPi", "breakdown", "F", "G", "z",
                  "betabulk")
YIELDS_VAH_COLS = ("Lambda", "aL")
# K7b's yardstick: an evaluation (a cell, species and node of one
# quadrature) takes ~4 special functions (two exps, a square root, a
# division; csrc/yields.cu)
YIELDS_SFU = 4


def _yields_mode(cfg: Config) -> int:
    """K7b's mode: 0 df 1-2, 1 df 3, 2 df 4, 3 VAH (modes 2-3)."""
    if cfg.mode in (2, 3):
        return 3
    return {1: 0, 2: 0, 3: 1, 4: 2}[cfg.df_mode]


def _yields_cols(cfg: Config) -> tuple:
    return YIELDS_VAH_COLS if cfg.mode in (2, 3) else YIELDS_VH_COLS


def _yields_block(c, species, laguerre, cfg):
    """(C, S) densities of one block of cells, before the clamp
    (is3d_tpu/kernels/sample.py:_species_yields_exact_block, reference
    max_particle_number, sampling_kernels.cpp:282-357; VAH:
    _species_yields_vah, 2 a_L neq(Lambda) at zero chemical potential, the
    d^3p = a_L d^3q jacobian of the Romatschke-Strickland stretch)."""
    r1, w1 = laguerre[1]
    gt = thermal.gauss_thermal
    sign = species.sign[None, :]
    deg = species.degeneracy[None, :]
    if cfg.mode in (2, 3):
        Lam = c["Lambda"][:, None]
        mbar = species.mass[None, :] / Lam
        zero = torch.zeros_like(mbar)
        neq = (Lam ** 3 / TWO_PI2_HBARC3 * deg
               * gt(thermal.neq_int, r1, w1, mbar, zero, zero, sign))
        return 2.0 * c["aL"][:, None] * neq
    r2, w2 = laguerre[2]
    T = c["T"][:, None]
    alphaB = c["alphaB"][:, None]
    mbar = species.mass[None, :] / T
    baryon = species.baryon[None, :]
    neq_fact = T**3 / TWO_PI2_HBARC3
    neq = neq_fact * deg * gt(thermal.neq_int, r1, w1, mbar, alphaB, baryon,
                              sign)
    linear = 2.0 * neq
    if cfg.df_mode in (1, 2):
        return linear
    if cfg.df_mode == 3:
        J20_fact = T * neq_fact
        if cfg.include_baryon:
            J10 = neq_fact * deg * gt(thermal.J10_int, r1, w1, mbar, alphaB,
                                      baryon, sign)
        else:
            J10 = torch.zeros_like(neq)
        J20 = J20_fact * deg * gt(thermal.J20_int, r2, w2, mbar, alphaB,
                                  baryon, sign)
        bulk_density = (neq + baryon * J10 * c["G"][:, None]
                        + J20 * (c["F"] / T[:, 0] ** 2)[:, None]
                        ) / c["betabulk"][:, None]
        mod = neq + c["bulkPi"][:, None] * bulk_density
    else:   # mode 4: z . neq at zero chemical potential
        neq0 = neq_fact * deg * gt(thermal.neq_int, r1, w1, mbar,
                                   torch.zeros_like(alphaB),
                                   torch.zeros_like(baryon), sign)
        mod = c["z"][:, None] * neq0
    return torch.where(c["breakdown"][:, None], linear, mod)


def _drawable(dn: torch.Tensor, species: SpeciesArrays) -> torch.Tensor:
    """Negative densities clamped to 0 (negative weights: UB in C++) and
    the massless species zeroed (the reference exits at :479)."""
    dn = torch.clamp(dn, min=0.0)
    return torch.where(species.mass[None, :] > 0.0, dn,
                       torch.zeros_like(dn))


def species_yields_plain(c: dict, species: SpeciesArrays, laguerre: dict,
                         cfg: Config, sums_only: bool = False):
    """The plain version of K7b: the (C, S) densities, clamped at 0 with
    the massless species zeroed, and their row sums (C,), cells in chunks
    that keep each (chunk, S, nodes) quadrature block within
    common.CHUNK_ELEMENT_BUDGET.  ``c`` holds the mode's per-cell columns
    (YIELDS_VH_COLS or YIELDS_VAH_COLS).  Returns (dn or None with
    ``sums_only``, sums)."""
    names = _yields_cols(cfg)
    C, S = c[names[0]].shape[0], species.n_species
    Q = laguerre[1][0].shape[0]
    chunk = max(1, CHUNK_ELEMENT_BUDGET // max(S * Q, 1))
    parts, sums = [], []
    for c0 in range(0, max(C, 1), chunk):
        blk = _drawable(_yields_block({k: c[k][c0:c0 + chunk] for k in names},
                                      species, laguerre, cfg), species)
        sums.append(blk.sum(dim=1))
        if not sums_only:
            parts.append(blk)
    return (None if sums_only else torch.cat(parts)[:C]), torch.cat(sums)[:C]


def species_yields_cuda(c: dict, species: SpeciesArrays, laguerre: dict,
                        cfg: Config, sums_only: bool = False):
    """K7b (csrc/yields.cu): the outputs of ``species_yields_plain`` in one
    launch (``sums_only``: the row sums alone, no (C, S) table)."""
    mode = _yields_mode(cfg)
    names = _yields_cols(cfg)
    ref = c[names[0]]
    check_float("species_yields_cuda", ref)
    dtype, dev = ref.dtype, ref.device
    C, S = ref.shape[0], species.mass.shape[0]
    (r1, w1), (r2, w2) = laguerre[1], laguerre[2]
    if r1.shape != r2.shape:
        raise ValueError("species_yields_cuda: the alpha = 1 and alpha = 2 "
                         f"rules need as many nodes, got {r1.shape[0]} and "
                         f"{r2.shape[0]}")
    cells = torch.stack([c[k].to(dtype) for k in names]).contiguous()
    sp = torch.stack([species.mass, species.sign, species.degeneracy,
                      species.baryon]).to(dtype).contiguous()
    lag = torch.stack([r1, w1, r2, w2]).to(dtype).contiguous()
    for name, t in (("cells", cells), ("species", sp), ("laguerre", lag)):
        check_tensor(name, t, tuple(t.shape), ref)
    require_cuda("species_yields_cuda", ref)
    out = None if sums_only else torch.empty((C, S), dtype=dtype, device=dev)
    sums = torch.empty(C, dtype=dtype, device=dev)
    lib = _library("yields")
    fn = (lib.is3d_species_yields_f64 if dtype == torch.float64
          else lib.is3d_species_yields_f32)
    launch(lib, "species yields", fn, dev, cells.data_ptr(), C,
           sp.data_ptr(), S, lag.data_ptr(), r1.shape[0], mode,
           int(bool(cfg.include_baryon)), 1.0 / TWO_PI2_HBARC3,
           None if out is None else out.data_ptr(), sums.data_ptr())
    _count("YIELDS_VAH_LAUNCHES" if mode == 3 else "YIELDS_LAUNCHES")
    return out, sums


def species_yields(c: dict, species: SpeciesArrays, laguerre: dict,
                   cfg: Config, sums_only: bool = False):
    """Phase A's densities and their row sums: K7b on CUDA tensors, the
    plain version on CPU ones."""
    if c[_yields_cols(cfg)[0]].device.type == "cpu":
        return species_yields_plain(c, species, laguerre, cfg, sums_only)
    return species_yields_cuda(c, species, laguerre, cfg, sums_only)


def yields_formula_ops(n_cells: int, n_species: int, n_nodes: int,
                       cfg: Config, itemsize: int, n_broken: int = 0,
                       sums_only: bool = False) -> dict:
    """The work of one K7b launch as its inputs need it: YIELDS_SFU special
    functions for each (cell, species, node) of each quadrature the cell
    takes (df 3: neq and J10 share one, J20 another, one on the
    ``n_broken`` broken-down cells; every other mode one), the per-cell
    columns and species read once, the table (unless ``sums_only``) and
    the row sums written once."""
    sets = (2 * (n_cells - n_broken) + n_broken if _yields_mode(cfg) == 1
            else n_cells)
    ncol = len(_yields_cols(cfg))
    out = 0 if sums_only else n_cells * n_species * itemsize
    return dict(bytes=(ncol * n_cells + 4 * n_species + 4 * n_nodes
                       + n_cells) * itemsize + out,
                sfu=YIELDS_SFU * sets * n_species * n_nodes)


def _species_yields_fast(c, species, cfg):
    """Fast mode: densities at the surface-averaged state, shared by all
    cells (reference fast_max_particle_number, sampling_kernels.cpp:239-279)."""
    neq = species.equilibrium_density[None, :]
    C = c["T"].shape[0]
    if cfg.df_mode in (1, 2):
        return (2.0 * neq).expand(C, species.n_species).clone()
    if cfg.df_mode == 3:
        mod = neq + c["bulkPi"][:, None] * species.bulk_density[None, :]
    else:
        mod = c["df"].z[:, None] * neq
    return torch.where(c["breakdown"][:, None], 2.0 * neq, mod)


# ======================================================================
# Phase A: per-cell data
# ======================================================================

# per-cell df coefficients read by the hadron-level viscous weight
DF_FIELDS = ("c0", "c1", "c2", "c3", "c4", "shear14", "F", "G", "betabulk",
             "betaV", "betapi", "delta_lambda", "delta_z")


def cell_data(cols: dict, species: SpeciesArrays, df_data: DeltafData,
              laguerre: dict, plasma_avg: tuple, cfg: Config,
              scalars_only: bool = False) -> dict:
    """Every per-cell sampler input, (C,) and (C, S) tensors
    (is3d_tpu/kernels/sample.py:_cell_data_impl, viscous hydro): the LRF
    fields, the df and feqmod per-cell values, the breakdown flag,
    ``dn_list`` (C, S), ``dn_tot`` and ``mean_cell``.  ``scalars_only``:
    the cell-chunked sampler's pre-pass (_cell_scalars_jit), {lam: sum
    dn_tot, mean: sum mean_cell} without keeping a (C, S) table."""
    c = prepare_cells(cols, cfg, df_data)
    tau = c["tau"]
    basis = lrf.milne_basis(c["ut"], c["ux"], c["uy"], c["un"], tau)
    dst, dsx, dsy, dsz = lrf.boost_dsigma_to_lrf(
        basis, c["dat"], c["dax"], c["day"], c["dan"],
        c["ut"], c["ux"], c["uy"], c["un"])
    ds_space, ds_max = lrf.dsigma_magnitude(dst, dsx, dsy, dsz)
    piL = lrf.boost_pimunu_to_lrf(basis, c["pitt"], c["pitx"], c["pity"],
                                  c["pitn"], c["pixx"], c["pixy"], c["pixn"],
                                  c["piyy"], c["piyn"], c["pinn"], tau)
    VL = lrf.boost_Vmu_to_lrf(basis, c["Vt"], c["Vx"], c["Vy"], c["Vn"], tau)
    Vdsigma = (c["Vt"] * c["dat"] + c["Vx"] * c["dax"] + c["Vy"] * c["day"]
               + c["Vn"] * c["dan"])

    df = c["df"]
    zl = torch.zeros_like(tau)
    if cfg.df_mode == 3:
        T_mod = c["T"] + c["bulkPi"] * df.F / df.betabulk
        alphaB_mod = c["alphaB"] + c["bulkPi"] * df.G / df.betabulk
        shear_mod = 0.5 / df.betapi
        bulk_mod = c["bulkPi"] / (3.0 * df.betabulk)
        diff_mod = c["T"] / df.betaV
    elif cfg.df_mode == 4:
        T_mod, alphaB_mod = c["T"], zl
        shear_mod = 0.5 / df.betapi
        bulk_mod = df.lam
        diff_mod = zl
    else:
        T_mod, alphaB_mod = c["T"], c["alphaB"]
        shear_mod = bulk_mod = diff_mod = zl

    if cfg.df_mode in (3, 4):
        A = (1.0 + piL[0] * shear_mod + bulk_mod,
             piL[1] * shear_mod, piL[2] * shear_mod,
             1.0 + piL[3] * shear_mod + bulk_mod,
             piL[4] * shear_mod,
             1.0 + piL[5] * shear_mod + bulk_mod)
        _, detA = adjugate_sym(A)
        c["detA"] = detA
        if cfg.df_mode == 3:
            if cfg.fast:
                # breakdown from the average state (reference fast path,
                # does_feqmod_breakdown with fast = 1, emissionfunction.cpp:114-120)
                T_avg, muB_avg = plasma_avg
                zero = torch.zeros_like(T_avg)
                df_avg = evaluate_df_coefficients(
                    df_data, cfg.df_mode, bool(cfg.include_baryon),
                    T_avg, muB_avg, zero, zero, zero)
                dfb = dataclasses.replace(df_avg, **{
                    f.name: getattr(df_avg, f.name).expand(tau.shape)
                    for f in dataclasses.fields(df_avg)})
                cavg = dict(T=T_avg.expand(tau.shape), bulkPi=c["bulkPi"],
                            detA=detA, df=dfb)
                breakdown = mode3_breakdown(cavg, laguerre, cfg)
            else:
                breakdown = mode3_breakdown(c, laguerre, cfg)
        else:
            # Jonah's f_mod normally never falls back, except where A loses
            # positive definiteness (detA <= deta_min): as is3d_tpu does
            breakdown = detA <= cfg.deta_min
    else:
        breakdown = torch.zeros_like(tau, dtype=torch.bool)
    c["breakdown"] = breakdown

    if cfg.fast:
        dn_list = _drawable(_species_yields_fast(c, species, cfg), species)
        sums = dn_list.sum(dim=1)
    else:
        dn_list, sums = species_yields(
            dict(T=c["T"], alphaB=c["alphaB"], bulkPi=c["bulkPi"],
                 breakdown=breakdown, F=df.F, G=df.G, z=df.z,
                 betabulk=df.betabulk), species, laguerre, cfg,
            sums_only=scalars_only)

    y_max = cfg.y_cut if cfg.dimension == 2 else 0.5
    dn_tot = sums * (2.0 * y_max * ds_max)
    dn_tot = torch.where(c["valid"], dn_tot, torch.zeros_like(dn_tot))

    # mean yield for the oversampling estimate (reference
    # estimate_mean_particle_number, sampling_kernels.cpp:200-236)
    neq_s = species.equilibrium_density[None, :]
    if cfg.df_mode == 4:
        per_sp = torch.where(breakdown[:, None],
                             (1.0 + df.delta_z[:, None]) * neq_s,
                             df.z[:, None] * neq_s)
        mean_cell = c["udsigma"] * per_sp.sum(dim=1)
    else:
        mean_cell = (c["udsigma"] * (
            neq_s + c["bulkPi"][:, None] * species.bulk_density[None, :]
        ).sum(dim=1) - ds_space * Vdsigma * species.diff_density.sum())
    mean_cell = torch.where(c["valid"], mean_cell, torch.zeros_like(mean_cell))
    if scalars_only:
        return dict(lam=dn_tot.sum(), mean=mean_cell.sum())

    out = dict(
        tau=tau, x=c["x"], y=c["y"], eta=c["eta"],
        T=c["T"], alphaB=c["alphaB"], T_mod=T_mod, alphaB_mod=alphaB_mod,
        shear_mod=shear_mod, bulk_mod=bulk_mod, diff_mod=diff_mod,
        breakdown=breakdown, benth=c["baryon_enthalpy_ratio"],
        bulkPi=c["bulkPi"],
        dst=dst, dsx=dsx, dsy=dsy, dsz=dsz, ds_max=ds_max,
        ut=c["ut"], ux=c["ux"], uy=c["uy"], un=c["un"],
        Xt=basis.Xt, Xx=basis.Xx, Xy=basis.Xy, Xn=basis.Xn,
        Yx=basis.Yx, Yy=basis.Yy, Zt=basis.Zt, Zn=basis.Zn,
        pixx=piL[0], pixy=piL[1], pixz=piL[2], piyy=piL[3], piyz=piL[4],
        pizz=piL[5], Vx=VL[0], Vy=VL[1], Vz=VL[2],
        dn_list=dn_list, dn_tot=dn_tot, mean_cell=mean_cell)
    for name in DF_FIELDS:
        out["df_" + name] = getattr(df, name)
    return out


def vah_cell_data(cols: dict, species: SpeciesArrays, laguerre: dict,
                  cfg: Config, scalars_only: bool = False) -> dict:
    """Every per-cell sampler input of an anisotropic-hydro surface
    (is3d_tpu/kernels/sample.py:_vah_cell_data_impl, modes 2-3): the LRF
    tetrad, dsigma, pi and W in the LRF (W^mu completed as
    vah.complete_vah_cells does), Lambda, a_L and the residual-df
    coefficients, the densities 2 a_L neq(Lambda) (``dn_list``, K7b on the
    card), ``dn_tot`` and ``mean_cell`` (half the densities' sum times
    u.dsigma).  ``scalars_only``: {lam, mean} as ``cell_data``'s."""
    c = complete_vah_cells(cols)
    tau, ut = c["tau"], c["ut"]
    basis = lrf.milne_basis(ut, c["ux"], c["uy"], c["un"], tau)
    dst, dsx, dsy, dsz = lrf.boost_dsigma_to_lrf(
        basis, c["dat"], c["dax"], c["day"], c["dan"],
        ut, c["ux"], c["uy"], c["un"])
    ds_space, ds_max = lrf.dsigma_magnitude(dst, dsx, dsy, dsz)
    udsigma = (ut * c["dat"] + c["ux"] * c["dax"] + c["uy"] * c["day"]
               + c["un"] * c["dan"])
    valid = udsigma > 0.0
    piL = lrf.boost_pimunu_to_lrf(basis, c["pitt"], c["pitx"], c["pity"],
                                  c["pitn"], c["pixx"], c["pixy"], c["pixn"],
                                  c["piyy"], c["piyn"], c["pinn"], tau)
    WL = lrf.boost_Vmu_to_lrf(basis, c["Wt"], c["Wx"], c["Wy"], c["Wn"], tau)

    dn_list, sums = species_yields(dict(Lambda=c["Lambda"], aL=c["aL"]),
                                   species, laguerre, cfg,
                                   sums_only=scalars_only)
    y_max = cfg.y_cut if cfg.dimension == 2 else 0.5
    zero = torch.zeros_like(sums)
    dn_tot = torch.where(valid, sums * (2.0 * y_max * ds_max), zero)
    mean_cell = torch.where(valid, udsigma * sums * 0.5, zero)
    if scalars_only:
        return dict(lam=dn_tot.sum(), mean=mean_cell.sum())
    return dict(
        tau=tau, x=c["x"], y=c["y"], eta=c["eta"],
        Lambda=c["Lambda"], aL=c["aL"], bulkPi=c["bulkPi"],
        c0=c["c0"], c1=c["c1"], c2=c["c2"], c3=c["c3"], c4=c["c4"],
        pixx=piL[0], pixy=piL[1], pixz=piL[2], piyy=piL[3], piyz=piL[4],
        pizz=piL[5], Wlx=WL[0], Wly=WL[1], Wlz=WL[2],
        dst=dst, dsx=dsx, dsy=dsy, dsz=dsz, ds_max=ds_max,
        ut=ut, ux=c["ux"], uy=c["uy"], un=c["un"],
        Xt=basis.Xt, Xx=basis.Xx, Xy=basis.Xy, Xn=basis.Xn,
        Yx=basis.Yx, Yy=basis.Yy, Zt=basis.Zt, Zn=basis.Zn,
        dn_list=dn_list, dn_tot=dn_tot, mean_cell=mean_cell)


def vah_sampler_cols(surface, cfg: Config) -> dict:
    """The columns the VAH sampler reads, with the VAH smooth kernel's
    zero filling of switched-off viscous columns
    (is3d_tpu/kernels/sample.py:_vah_sampler_cols)."""
    if surface.Lambda is None or surface.aL is None:
        raise ValueError("VAH sampler needs Lambda and aL (mode 2/3 surface)")
    z = torch.zeros_like(surface.tau)
    get = lambda name: getattr(surface, name, None)
    cols = {k: get(k) for k in ("tau", "x", "y", "dat", "dax", "day", "dan",
                                "ux", "uy", "un", "Lambda", "aL")}
    cols["eta"] = surface.eta if surface.eta is not None else z
    shear_on = bool(cfg.include_shear_deltaf)
    bulk_on = bool(cfg.include_bulk_deltaf)
    for name in ("pitt", "pitx", "pity", "pitn", "pixx", "pixy", "pixn",
                 "piyy", "piyn", "pinn", "Wx", "Wy"):
        v = get(name)
        cols[name] = v if (shear_on and v is not None) else z
    v = get("bulkPi")
    cols["bulkPi"] = v if (bulk_on and v is not None) else z
    for name in ("c0", "c1", "c2", "c3", "c4"):
        v = get(name)
        on = shear_on if name in ("c3", "c4") else bulk_on
        cols[name] = v if (on and v is not None) else z
    return cols


def sampler_effective_cfg(surface, cfg: Config) -> Config:
    """The VAH residual-df gate for the sampler (modes 2-3,
    is3d_tpu/kernels/sample.py:_sampler_effective_cfg): chains whose
    coefficient columns are absent or exact zeros leave the event kernel
    and its row (vah.effective_vah_cfg; bit-identical events: with zero
    coefficients df = 0 exactly).  Warns when a chain stays on with
    regulate_deltaf = 0: the sampler still clips (1 + df)/2 to [0, 1]."""
    if cfg.vah_df_gate and cfg.mode in (2, 3):
        z = torch.zeros_like(surface.tau)
        probe = {k: (getattr(surface, k, None) if getattr(surface, k, None)
                     is not None else z)
                 for k in ("c0", "c1", "c2", "c3", "c4", "bulkPi")}
        cfg = effective_vah_cfg(probe, cfg)
    if (cfg.mode in (2, 3) and not cfg.regulate_deltaf
            and (cfg.include_shear_deltaf or cfg.include_bulk_deltaf)):
        warnings.warn(
            "VAH sampling with regulate_deltaf=0: the sampler's rejection "
            "scheme still clips the viscous weight (1+df)/2 to [0,1], so on "
            "cells where |f_abar df| > 1 sampled events diverge "
            "statistically from the unclipped smooth_spectra_vah.",
            stacklevel=3)
    return cfg


# ======================================================================
# Phase B: one batch of events, one thread (or lane) a hadron slot
# ======================================================================

# the per-cell fields of the slot's row gather (is3d_tpu/kernels/sample.py
# :734-784): those read before the keep decision, pruned per df_mode, then
# those of the lab boost
_PRE_COMMON = ("T", "alphaB", "benth", "bulkPi",
               "pixx", "pixy", "pixz", "piyy", "piyz", "pizz",
               "Vx", "Vy", "Vz", "dst", "dsx", "dsy", "dsz", "ds_max")
_PRE_DF = {
    1: ("df_c0", "df_c1", "df_c2", "df_c3", "df_c4", "df_shear14"),
    2: ("df_betapi", "df_F", "df_G", "df_betabulk", "df_betaV"),
    3: ("df_betapi", "df_F", "df_G", "df_betabulk", "df_betaV",
        "T_mod", "alphaB_mod", "breakdown", "shear_mod", "bulk_mod",
        "diff_mod"),
    4: ("df_betapi", "df_delta_lambda", "df_delta_z",
        "T_mod", "breakdown", "shear_mod", "bulk_mod", "diff_mod"),
}
_LAB_FIELDS = ("tau", "x", "y", "eta", "ut", "ux", "uy", "un",
               "Xt", "Xx", "Xy", "Xn", "Yx", "Yy", "Zt", "Zn")
# anisotropic hydro (is3d_tpu's _pre_fields): Lambda, a_L and dsigma, then
# the fields of each residual-df chain the gate keeps
_PRE_VAH_BASE = ("Lambda", "aL", "dst", "dsx", "dsy", "dsz", "ds_max")
_PRE_VAH_SHEAR = ("c3", "c4", "pixx", "pixy", "pixz", "piyy", "piyz",
                  "pizz", "Wlx", "Wly", "Wlz")
_PRE_VAH_BULK = ("bulkPi", "c0", "c1", "c2")

# every field the event kernel can read, in the order of csrc/sample.cuh's
# `Field` enum; the kernel finds each in a row through ``layout``
ROW_FIELDS = (_PRE_COMMON + ("df_c0", "df_c1", "df_c2", "df_c3", "df_c4",
                             "df_shear14", "df_betapi", "df_F", "df_G",
                             "df_betabulk", "df_betaV", "df_delta_lambda",
                             "df_delta_z", "T_mod", "alphaB_mod",
                             "breakdown", "shear_mod", "bulk_mod",
                             "diff_mod") + _LAB_FIELDS
              + ("Lambda", "aL", "c0", "c1", "c2", "c3", "c4", "Wlx", "Wly",
                 "Wlz"))


def _vah(cfg: Config) -> bool:
    return cfg.mode in (2, 3)


def gather_fields(cfg: Config) -> tuple:
    """The fields of one slot's row: the pre-keep fields of the df mode (VAH:
    of the chains ``cfg`` keeps), then the lab fields with the tetrad
    (sampler_gather_tetrad is inert: is3d_tpu's per-slot rebuild gives the
    same values)."""
    if _vah(cfg):
        return (_PRE_VAH_BASE
                + (_PRE_VAH_SHEAR if cfg.include_shear_deltaf else ())
                + (_PRE_VAH_BULK if cfg.include_bulk_deltaf else ())
                + _LAB_FIELDS)
    return _PRE_COMMON + _PRE_DF[cfg.df_mode] + _LAB_FIELDS


def _kernel_df(cfg: Config) -> int:
    """The event kernel's DF: the df mode, or on VAH surfaces 8 | shear |
    bulk << 1 (csrc/sample.cuh, kVah)."""
    if _vah(cfg):
        return (8 | int(bool(cfg.include_shear_deltaf))
                | int(bool(cfg.include_bulk_deltaf)) << 1)
    return cfg.df_mode


def pack_rows(cell: dict, cfg: Config) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, layout): the gathered fields of every cell row-major, (C, NF)
    in the cell data's float dtype with NF padded to 16 bytes (so a row
    starts 16-byte aligned), and the int32 column of each ROW_FIELDS
    entry in a row (-1 where the df mode has none), on the host."""
    fields = gather_fields(cfg)
    dtype = cell["tau"].dtype
    per = 128 // torch.finfo(dtype).bits
    nf = -(-len(fields) // per) * per
    C = cell["tau"].shape[0]
    rows = torch.zeros((C, nf), dtype=dtype, device=cell["tau"].device)
    for i, k in enumerate(fields):
        rows[:, i] = cell[k].to(dtype)
    layout = torch.tensor([fields.index(k) if k in fields else -1
                           for k in ROW_FIELDS], dtype=torch.int32)
    return rows, layout


def _df_weight(cfg, g, E, px, py, pz, mass2, sign, baryon):
    """Viscous weight (1 + df)/2 for the linear branch
    (reference compute_df_weight, sampling_kernels.cpp:361-453)."""
    pipp = (px * px * g["pixx"] + py * py * g["piyy"] + pz * pz * g["pizz"]
            + 2.0 * (px * py * g["pixy"] + px * pz * g["pixz"]
                     + py * pz * g["piyz"]))
    Vp = -(px * g["Vx"] + py * g["Vy"] + pz * g["Vz"])
    T = g["T"]
    bulkPi = g["bulkPi"]
    if cfg.df_mode == 1:
        chem = baryon * g["alphaB"]
        feqbar = 1.0 - sign / (torch.exp(E / T - chem) + sign)
        df_shear = pipp / g["df_shear14"]
        df_bulk = ((g["df_c0"] - g["df_c2"]) * mass2
                   + (baryon * g["df_c1"] + (4.0 * g["df_c2"] - g["df_c0"]) * E)
                   * E) * bulkPi
        df_diff = (baryon * g["df_c3"] + g["df_c4"] * E) * Vp
        df_tot = feqbar * (df_shear + df_bulk + df_diff)
    elif cfg.df_mode in (2, 3):
        chem = baryon * g["alphaB"]
        feqbar = 1.0 - sign / (torch.exp(E / T - chem) + sign)
        df_shear = pipp / (2.0 * E * g["df_betapi"] * T)
        df_bulk = (baryon * g["df_G"] + g["df_F"] * E / T**2
                   + (E - mass2 / E) / (3.0 * T)) * bulkPi / g["df_betabulk"]
        df_diff = (g["benth"] - baryon / E) * Vp / g["df_betaV"]
        df_tot = feqbar * (df_shear + df_bulk + df_diff)
    else:   # mode 4 linearized (Jonah)
        feqbar = 1.0 - sign / (torch.exp(E / T) + sign)
        df_shear = feqbar * pipp / (2.0 * E * g["df_betapi"] * T)
        df_bulk = (g["df_delta_z"] - 3.0 * g["df_delta_lambda"]
                   + feqbar * g["df_delta_lambda"] * (E - mass2 / E) / T)
        df_tot = df_shear + df_bulk
    df_tot = torch.clamp(df_tot, -1.0, 1.0)
    return 0.5 * (1.0 + df_tot)


def _propose(u, mbar, sign, chem):
    """One rejection round of the given slots from its five uniforms ``u``
    on [tiny, 1): the light (mbar < 1.008) p^2 e^-p proposal from three
    exponential deviates (reference :481-517) or the heavy 3-component
    k^j e^-k mixture (:520-599).  Returns (accept, pbar, Ebar, phi,
    costheta)."""
    l1, l2, l3 = torch.log(u[0]), torch.log(u[1]), torch.log(u[2])
    l12 = l1 + l2
    mbar2 = mbar * mbar
    # light branch
    pbar_l = -(l1 + l2 + l3)
    Ebar_l = torch.sqrt(pbar_l * pbar_l + mbar2)
    phi_l = l12 * l12 / (pbar_l * pbar_l)
    cos_l = (l1 - l2) / l12
    weq_max = torch.where((mbar < 0.8554) & (sign == -1.0),
                          pion_thermal_weight_max(mbar),
                          torch.ones_like(mbar))
    w_l = torch.exp(pbar_l - Ebar_l) / (1.0 + sign * torch.exp(-Ebar_l)) / weq_max
    # heavy branch: pick the k^j e^-k component
    w0 = mbar2
    w1 = 2.0 * mbar
    tot = w0 + w1 + 2.0
    r = u[3] * tot
    j1 = (r >= w0) & (r < w0 + w1)
    j2 = r >= (w0 + w1)
    kbar = torch.where(j2, -(l1 + l2 + l3), torch.where(j1, -l12, -l1))
    phi_h = torch.where(j2, l12 * l12 / (kbar * kbar),
                        torch.where(j1, -l1 / kbar, u[1]))
    cos_h = torch.where(j2, (l1 - l2) / l12, 2.0 * u[2] - 1.0)
    Ebar_h = kbar + mbar
    pbar_h = torch.sqrt(torch.clamp(Ebar_h * Ebar_h - mbar2, min=0.0))
    e = torch.exp(Ebar_h - chem)
    w_h = pbar_h / Ebar_h * e / (e + sign)

    light = mbar < MBAR_LIGHT
    pbar = torch.where(light, pbar_l, pbar_h)
    Ebar = torch.where(light, Ebar_l, Ebar_h)
    phi = TWO_PI * torch.where(light, phi_l, phi_h)
    cost = torch.where(light, cos_l, cos_h)
    w = torch.where(light, w_l, w_h)
    return u[4] < w, pbar, Ebar, phi, cost


def _lab_kinematics(g, mass, E, px, py, pz, u_y, cfg):
    """Boost LRF momenta to the lab frame with the row's tetrad and rebuild
    the rapidity and (2+1D) the space-time rapidity (reference
    :1144-1192)."""
    basis = lrf.MilneBasis(Xt=g["Xt"], Xx=g["Xx"], Xy=g["Xy"], Xn=g["Xn"],
                           Yx=g["Yx"], Yy=g["Yy"], Zt=g["Zt"], Zn=g["Zn"])
    ptau, px_lab, py_lab, pn = lrf.boost_pLRF_to_lab(
        basis, g["ut"], g["ux"], g["uy"], g["un"], E, px, py, pz)
    tau = g["tau"]
    mass2 = mass * mass
    mT = torch.sqrt(mass2 + px_lab**2 + py_lab**2)
    if cfg.dimension == 2:
        # boost-invariant: rapidity uniform on [-y_cut, y_cut], (pz, eta)
        # rebuilt (reference :1168-1192)
        yp = cfg.y_cut * (2.0 * u_y - 1.0)
        sinhy = torch.sinh(yp)
        coshy = torch.sqrt(1.0 + sinhy * sinhy)
        sinheta = (ptau * sinhy - tau * pn * coshy) / mT
        eta_out = torch.asinh(sinheta)
        pz_lab = mT * sinhy
    else:
        eta_out = g["eta"]
        pz_lab = tau * pn * torch.cosh(eta_out) + ptau * torch.sinh(eta_out)
    return px_lab, py_lab, pz_lab, eta_out


class PhiloxSource:
    """The uniforms of a batch of events from the port's Philox streams
    (kernels/rng.py), the same numbers K7 draws: each slot's five own
    draws and its five of each rejection round, keyed on (seed, global
    event, slot, round)."""

    def __init__(self, seed: int, ev0: int, dtype: torch.dtype):
        self.key = rng.seed_key(seed)
        self.ev0 = int(ev0)
        self.dtype = dtype

    def slot_draws(self, ev: torch.Tensor, slot: torch.Tensor):
        """(5, ...) uniforms on [0, 1): cell group, cell in block,
        species, keep, rapidity."""
        return rng.slot_uniforms(self.key, slot, ev + self.ev0, self.dtype)

    def round_draws(self, r: int, ev: torch.Tensor, slot: torch.Tensor):
        """(5, ...) uniforms on [tiny, 1) of rejection round r."""
        return rng.slot_uniforms(self.key, slot, ev + self.ev0, self.dtype,
                                 round_=r, open0=True)


def event_batch_plain(rows: torch.Tensor, tables: dict,
                      species: SpeciesArrays, counts: torch.Tensor, src,
                      n_cap: int, cfg: Config) -> dict:
    """The plain version of K7: every slot of B events x ``n_cap``
    (is3d_tpu/kernels/sample.py:_one_event_lrf and _lab_kinematics).
    ``rows`` is ``pack_rows``' (C, NF); ``tables`` the draw's
    (``build_draw_tables``: alias picks, or the binary searches of
    ``sampler_alias = 0``, reading u[0] for the cell and u[2] for the
    species); ``counts`` (B,) the events' hadron counts; ``src`` gives the
    uniforms (``PhiloxSource``, or a test's replay of is3d_tpu's).  On VAH
    surfaces (modes 2-3) q is drawn at T = Lambda with zero chemical
    potential, stretched to pz = a_L qz and kept with the residual-df
    weight.  Returns (B, n_cap) tensors: keep, ok (momentum accepted),
    rounds (proposals made), sidx, cidx, and the lab px, py, pz, eta
    (2+1D: sampled; 3+1D: the cell's).  Slots at or past an event's count
    have keep = ok = False and rounds = 0."""
    dev, dtype = rows.device, rows.dtype
    B = counts.shape[0]
    C = rows.shape[0]
    fields = gather_fields(cfg)
    ev = torch.arange(B, device=dev)[:, None].expand(B, n_cap)
    sl = torch.arange(n_cap, device=dev)[None, :].expand(B, n_cap)
    slot = sl < counts.to(dev)[:, None]
    u = src.slot_draws(ev, sl)

    if _search(tables):
        # cell ~ dn_tot / lam by inverse CDF, clipped: cum_dn[-1] may fall
        # below u lam; species by the halvings of the cell's rowcum row
        rowcum = tables["rowcum"]
        x = u[0] * torch.as_tensor(tables["lam"], dtype=dtype, device=dev)
        cidx = torch.clamp(torch.searchsorted(
            tables["cum_dn"], x.contiguous(), right=True), 0, C - 1)
        sidx = row_categorical(rowcum, cidx,
                               u[2] * rowcum[cidx, rowcum.shape[1] - 1])
        cidx, sidx = cidx.to(torch.int32), sidx.to(torch.int32)
    else:
        CB = tables["blk_prob"].shape[1]
        grp = alias_pick(tables["grp_prob"], tables["grp_alias"],
                         torch.zeros_like(sl), u[0])
        within = alias_pick(tables["blk_prob"], tables["blk_alias"], grp,
                            u[1])
        cidx = torch.clamp(grp * CB + within, max=C - 1)
        sidx = alias_pick(tables["sp_prob"], tables["sp_alias"], cidx, u[2])
    r = rows[cidx.long()]
    g = {k: r[..., i] for i, k in enumerate(fields)}
    s = sidx.long()
    mass = species.mass[s]
    mass2 = mass * mass
    sign = species.sign[s]
    baryon = species.baryon[s]

    if _vah(cfg):
        # f_a(p) = f_eq(q; Lambda), q = (px, py, pz / a_L): q isotropic at
        # T = Lambda, zero chemical potential
        use_mod = torch.zeros_like(slot)
        T_eff = g["Lambda"]
        chem_s = torch.zeros_like(T_eff)
    elif cfg.df_mode in (1, 2):
        use_mod = torch.zeros_like(slot)
        T_eff = g["T"]
        chem_s = baryon * g["alphaB"]
    else:
        use_mod = ~(g["breakdown"] > 0.5)
        T_eff = torch.where(use_mod, g["T_mod"], g["T"])
        if cfg.df_mode == 4:
            # Jonah's feqmod samples at zero chemical potential (:1111-1117)
            chem_s = torch.where(use_mod, torch.zeros_like(T_eff),
                                 baryon * g["alphaB"])
        else:
            chem_s = baryon * torch.where(use_mod, g["alphaB_mod"],
                                          g["alphaB"])
    mbar = mass / T_eff

    # rejection, every pending slot proposing each round; round r of a
    # slot has its own uniforms, so the pending slots are compacted
    done = ~slot
    pbar = torch.zeros_like(T_eff)
    Ebar = torch.ones_like(T_eff)
    phi = torch.zeros_like(T_eff)
    cost = torch.zeros_like(T_eff)
    rounds = torch.zeros((B, n_cap), dtype=torch.int32, device=dev)
    for rnd in range(MAX_REJECTION_ROUNDS):
        pend = (~done).nonzero(as_tuple=True)
        if pend[0].numel() == 0:
            break
        acc, pb, Eb, ph, ct = _propose(src.round_draws(rnd, *pend),
                                       mbar[pend], sign[pend], chem_s[pend])
        rounds[pend] += 1
        a = tuple(p[acc] for p in pend)
        pbar[a], Ebar[a], phi[a], cost[a] = pb[acc], Eb[acc], ph[acc], ct[acc]
        done[a] = True
    ok = done & slot

    sint = torch.sqrt(torch.clamp(1.0 - cost * cost, min=0.0))
    E = Ebar * T_eff
    p = pbar * T_eff
    px = p * sint * torch.cos(phi)
    py = p * sint * torch.sin(phi)
    pz = p * cost

    if _vah(cfg):
        # the stretch pz = a_L qz and the residual 14-moment df in the LRF:
        # (z.p) = -pz, (W.p) = -(W_L . p), pi_ij p_i p_j; f_abar at the
        # anisotropic energy is the proposal's 1 - sign/(e^Ebar + sign)
        # (is3d_tpu/kernels/sample.py:946-975)
        pz = g["aL"] * pz
        E = torch.sqrt(mass2 + px * px + py * py + pz * pz)
        fabar = 1.0 - sign / (torch.exp(Ebar) + sign)
        df_tot = torch.zeros_like(E)
        if cfg.include_shear_deltaf:
            Wp = g["Wlx"] * px + g["Wly"] * py + g["Wlz"] * pz
            pipp = (px * px * g["pixx"] + py * py * g["piyy"]
                    + pz * pz * g["pizz"]
                    + 2.0 * (px * py * g["pixy"] + px * pz * g["pixz"]
                             + py * pz * g["piyz"]))
            df_tot = df_tot + g["c3"] * pz * Wp + g["c4"] * pipp
        if cfg.include_bulk_deltaf:
            df_tot = df_tot + (g["c0"] * mass2 + g["c1"] * pz * pz
                               + g["c2"] * E * E) * g["bulkPi"]
        df_tot = fabar * df_tot
        if cfg.regulate_deltaf:
            df_tot = torch.clamp(df_tot, -1.0, 1.0)
        # the budget-2 rejection scheme clips (1 + df)/2 to [0, 1] whatever
        # regulate_deltaf says
        w_vah = torch.clamp(0.5 * (1.0 + df_tot), 0.0, 1.0)

    if cfg.df_mode in (3, 4) and not _vah(cfg):
        # feqmod momentum rescale p = A p_mod + shifts (reference :619-650)
        dm = g["diff_mod"] * (E * g["benth"] + baryon)
        bx = (1.0 + g["bulk_mod"]) * px + g["shear_mod"] * (
            g["pixx"] * px + g["pixy"] * py + g["pixz"] * pz) + dm * g["Vx"]
        by = (1.0 + g["bulk_mod"]) * py + g["shear_mod"] * (
            g["pixy"] * px + g["piyy"] * py + g["piyz"] * pz) + dm * g["Vy"]
        bz = (1.0 + g["bulk_mod"]) * pz + g["shear_mod"] * (
            g["pixz"] * px + g["piyz"] * py + g["pizz"] * pz) + dm * g["Vz"]
        px = torch.where(use_mod, bx, px)
        py = torch.where(use_mod, by, py)
        pz = torch.where(use_mod, bz, pz)
        E = torch.where(use_mod, torch.sqrt(mass2 + px**2 + py**2 + pz**2), E)

    if _vah(cfg):
        w_visc = w_vah
    else:
        w_visc = torch.where(use_mod, torch.ones_like(E),
                             _df_weight(cfg, g, E, px, py, pz, mass2, sign,
                                        baryon))
    w_flux = torch.clamp(E * g["dst"] - px * g["dsx"] - py * g["dsy"]
                         - pz * g["dsz"], min=0.0) / (E * g["ds_max"])
    keep = ok & (u[3] < w_flux * w_visc)
    pxl, pyl, pzl, eta = _lab_kinematics(g, mass, E, px, py, pz, u[4], cfg)
    return dict(keep=keep, ok=ok, rounds=rounds, sidx=sidx, cidx=cidx,
                px=pxl, py=pyl, pz=pzl, eta=eta)


SLOT_OUTPUTS = ("keep", "ok", "rounds", "sidx", "cidx", "px", "py", "pz",
                "eta")

# K7's yardstick, counted from the formula: a Philox-4x32-10 block is 20
# multiply-highs on the INT32 pipe; a slot's own draws and each rejection
# round take 2 blocks in float32 (5 uniforms, 4 a block) and 3 in float64;
# a rejection round takes 6 special functions (3 logs, a sqrt, 2 exps of
# the light proposal), a slot 8 more after it (sint, cos, sin, the df exp,
# the feqmod / lab mT sqrt, sinh, cosh's sqrt, asinh); a slot gathers its
# row and three (prob, alias) entries, one gather each (no layout reads an
# entry in fewer), each table's gathers counted by gather_bytes
PHILOX_MULHI = 20
PROPOSAL_SFU = 6
SLOT_SFU = 8
L2_BYTES = 50 * 2**20     # the H100's L2


def gather_bytes(table_bytes: int, n_gathers: int) -> int:
    """The least memory traffic of ``n_gathers`` random gathers from a
    table of ``table_bytes``: a table that fits in L2 is read at most once,
    a larger one a 32-byte sector a gather."""
    if table_bytes <= L2_BYTES:
        return min(table_bytes, 32 * n_gathers)
    return 32 * n_gathers


def sample_formula_ops(n_slots: int, n_valid: int, n_rounds: int,
                       rows: torch.Tensor, tables: dict,
                       out_bytes: Optional[int] = None) -> dict:
    """The work of one K7 launch as its inputs need it: ``n_slots`` slots
    of which ``n_valid`` below their event's count, ``n_rounds``
    proposals made (the sum of the slots' rounds: rounds per slot = 1 /
    efficiency), on ``rows`` and the draw ``tables`` it was given.  An
    alias pick gathers one (prob, alias) entry of its table; a search
    draw ceil(log2(C + 1)) entries of cum_dn and S.bit_length() + 1 of
    its cell's rowcum row.  Returns the bytes (each table's gathers by
    gather_bytes; the outputs written once: ``out_bytes``, default the
    per-slot mode's), the multiply-highs and the special functions."""
    itemsize = rows.element_size()
    blocks = 2 if itemsize == 4 else 3
    row_sectors = -(-rows.shape[1] * itemsize // 32)
    gathers = gather_bytes(rows.nbytes, n_valid * row_sectors)
    if _search(tables):
        C, S = tables["rowcum"].shape
        gathers += gather_bytes(tables["cum_dn"].nbytes,
                                n_valid * C.bit_length())
        gathers += gather_bytes(tables["rowcum"].nbytes,
                                n_valid * (S.bit_length() + 1))
    else:
        gathers += sum(gather_bytes(tables[f"{t}_prob"].nbytes
                                    + tables[f"{t}_alias"].nbytes, n_valid)
                       for t in ("grp", "blk", "sp"))
    if out_bytes is None:
        out_bytes = n_slots * (2 + 3 * 4 + 4 * itemsize)
    return dict(bytes=gathers + out_bytes,
                mulhi=PHILOX_MULHI * blocks * (n_valid + n_rounds),
                sfu=PROPOSAL_SFU * n_rounds + SLOT_SFU * n_valid)


def packed_bytes(packed: dict, n_kept: int, n_events: int) -> int:
    """The bytes packed mode writes: each packed field's entries of the
    hadrons kept (at most its capacity), the per-event counts and the
    three totals."""
    n = min(n_kept, min(v.shape[0] for v in packed.values()))
    return (n * sum(v.element_size() for v in packed.values())
            + 4 * n_events + 3 * 8)


def alias_formula_bytes(R: int, K: int, itemsize: int) -> int:
    """K7a reads each scaled weight once and writes each (prob, alias)
    entry once (a pass over rows sorted outside it would also read each
    sorted entry's index: R K (2 itemsize + 8))."""
    return R * K * (2 * itemsize + 4)


def _event_args(rows, layout, tables, species, counts, seed, ev0, n_cap,
                cfg, what):
    """Check K7's inputs and return the C entry's common arguments (and
    the tensors they point into, kept alive by the caller)."""
    check_float(what, rows)
    C, nf = rows.shape
    S = species.mass.shape[0]
    B = counts.shape[0]
    check_tensor("rows", rows, (C, nf), rows)
    # the C entry checks the layout against its df mode's columns
    lay = layout.to("cpu", torch.int32).contiguous()
    if tuple(lay.shape) != (len(ROW_FIELDS),) or int(lay.max()) >= nf:
        raise ValueError(f"layout: need {len(ROW_FIELDS)} columns below "
                         f"{nf}, got {tuple(lay.shape)}")
    if _search(tables):
        check_tensor("cum_dn", tables["cum_dn"], (C,), rows)
        check_tensor("rowcum", tables["rowcum"], (C, S), rows)
        t_args = (tables["cum_dn"].data_ptr(), C, None, 0,
                  tables["rowcum"].data_ptr(), S)
        alive = [tables["cum_dn"], tables["rowcum"]]
        lam = float(tables["lam"])
    else:
        G, CB = tables["blk_prob"].shape
        alive = []
        for t, shape in (("grp", (1, G)), ("blk", (G, CB)), ("sp", (C, S))):
            prob, alias = tables[f"{t}_prob"], tables[f"{t}_alias"]
            if (tuple(prob.shape) != shape or tuple(alias.shape) != shape
                    or prob.dtype != rows.dtype or alias.dtype != torch.int32
                    or prob.device != rows.device
                    or alias.device != rows.device):
                raise ValueError(f"{t} table: need {shape} {rows.dtype} prob "
                                 f"and int32 alias on {rows.device}, got "
                                 f"{tuple(prob.shape)} {prob.dtype}, "
                                 f"{tuple(alias.shape)} {alias.dtype}")
            alive.append(pair_table(prob, alias))
        t_args = (alive[0].data_ptr(), G, alive[1].data_ptr(), CB,
                  alive[2].data_ptr(), S)
        lam = 0.0
    mass, sign, baryon = (getattr(species, k).contiguous()
                          for k in ("mass", "sign", "baryon"))
    for name, t in (("mass", mass), ("sign", sign), ("baryon", baryon)):
        check_tensor(name, t, (S,), rows)
    check_tensor("counts", counts, (B,), rows, dtype=torch.int32)
    if nf * rows.element_size() % 16 or rows.data_ptr() % 16:
        raise ValueError(f"{what}: rows must be 16-byte aligned")
    if B * n_cap >= 1 << 31 or ev0 + B > 1 << 32:
        raise ValueError(f"{what}: more slots or events than the kernel's "
                         "32-bit counters take")
    require_cuda(what, rows)
    k0, k1 = rng.seed_key(seed)
    args = (rows.data_ptr(), C, nf, lay.data_ptr(), *t_args,
            mass.data_ptr(), sign.data_ptr(), baryon.data_ptr(),
            counts.data_ptr(), B, n_cap, ev0, k0, k1, cfg.dimension,
            _kernel_df(cfg), int(bool(cfg.regulate_deltaf)),
            float(cfg.y_cut), lam)
    return args, (lay, alive, mass, sign, baryon)


def _event_library(cfg: Config, tables: dict) -> str:
    """The library of K7's instantiations for the run's surface and draw
    (csrc/sample.cu, sample_vah.cu, sample_search.cu,
    sample_vah_search.cu)."""
    return ("sample" + ("_vah" if _vah(cfg) else "")
            + ("_search" if _search(tables) else ""))


def _event_counter(cfg: Config, tables: dict, packed: bool) -> str:
    kind = ("SEARCH_" if _search(tables) else "VAH_" if _vah(cfg) else "")
    return kind + ("PACKED_LAUNCHES" if packed else "LAUNCHES")


def event_batch_cuda(rows: torch.Tensor, layout: torch.Tensor, tables: dict,
                     species: SpeciesArrays, counts: torch.Tensor,
                     seed: int, ev0: int, n_cap: int, cfg: Config) -> dict:
    """K7's per-slot mode (csrc/sample.cuh, event_kernel): the outputs of
    ``event_batch_plain`` with the port's Philox streams (keep and ok as
    bool; slots at or past an event's count all zero)."""
    args, alive = _event_args(rows, layout, tables, species, counts, seed,
                              ev0, n_cap, cfg, "event_batch_cuda")
    lib = _library(_event_library(cfg, tables))
    B, dev = counts.shape[0], rows.device
    out = dict(keep=torch.empty((B, n_cap), dtype=torch.bool, device=dev),
               ok=torch.empty((B, n_cap), dtype=torch.bool, device=dev),
               rounds=torch.empty((B, n_cap), dtype=torch.int32, device=dev),
               sidx=torch.empty((B, n_cap), dtype=torch.int32, device=dev),
               cidx=torch.empty((B, n_cap), dtype=torch.int32, device=dev))
    for k in ("px", "py", "pz", "eta"):
        out[k] = torch.empty((B, n_cap), dtype=rows.dtype, device=dev)
    fn = (lib.is3d_sample_events_f64 if rows.dtype == torch.float64
          else lib.is3d_sample_events_f32)
    launch(lib, "sample events", fn, dev, *args,
           *(out[k].data_ptr() for k in SLOT_OUTPUTS))
    _count(_event_counter(cfg, tables, packed=False))
    return out


def event_batch_packed_cuda(rows: torch.Tensor, layout: torch.Tensor,
                            tables: dict, species: SpeciesArrays,
                            counts: torch.Tensor, seed: int, ev0: int,
                            n_cap: int, cfg: Config, cap: int
                            ) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """K7's packed mode: the kept hadrons of the batch compacted in the
    same launch.  Returns what ``event_batch_packed_plain`` returns, bit
    for bit over the first min(kept, cap) entries of each packed array
    (the rest is not written)."""
    args, alive = _event_args(rows, layout, tables, species, counts, seed,
                              ev0, n_cap, cfg, "event_batch_packed_cuda")
    lib = _library(_event_library(cfg, tables))
    B, dev = counts.shape[0], rows.device
    C, S = rows.shape[0], species.mass.shape[0]
    cbits = _index_pack_bits(S, C)
    fdt = torch.float16 if _pack_f16(cfg) else rows.dtype
    packed = {k: torch.empty(cap, dtype=torch.int32 if k in _PACK_INT
                             else fdt, device=dev)
              for k in _pack_fields(cfg, cbits is not None)}
    per_event = torch.zeros(B, dtype=torch.int32, device=dev)
    tiles = lib.is3d_sample_tiles(B * n_cap)
    scratch = torch.zeros(4 + tiles, dtype=torch.int64, device=dev)
    ptr = lambda k: packed[k].data_ptr() if k in packed else None
    fn = (lib.is3d_sample_packed_f64 if rows.dtype == torch.float64
          else lib.is3d_sample_packed_f32)
    launch(lib, "sample events (packed)", fn, dev, *args, cap,
           -1 if cbits is None else cbits, int(fdt == torch.float16),
           ptr("scidx") or ptr("sidx"), ptr("cidx"), ptr("px"), ptr("py"),
           ptr("pz"), ptr("eta"), per_event.data_ptr(), scratch.data_ptr())
    _count(_event_counter(cfg, tables, packed=True))
    return packed, per_event, scratch[1:4]


def _library(name: str = "sample"):
    """The ctypes library of csrc/<name>.cu (K7a in "sample", K7 in every
    "sample*" library, K7b in "yields"), its entries bound once."""
    from ..native.build import cuda_library
    lib = cuda_library(name)
    if getattr(lib, "_is3d_bound", False):
        return lib
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    if name == "yields":
        for fn in (lib.is3d_species_yields_f32, lib.is3d_species_yields_f64):
            fn.restype = ci
            fn.argtypes = [vp, ci, vp, ci, vp, ci,   # cells C species S lag Q
                           ci, ci, cd,               # mode baryon inv_norm
                           vp, vp, vp]               # out sums stream
    else:
        if name == "sample":
            for fn in (lib.is3d_alias_build_f32, lib.is3d_alias_build_f64):
                fn.restype = ci
                fn.argtypes = [vp, ci, ci, vp, vp]   # q0 R K pairs stream
            for fn in (lib.is3d_alias_build_sorted_f32,
                       lib.is3d_alias_build_sorted_f64):
                fn.restype = ci
                fn.argtypes = [vp, vp, ci, ci, vp, vp]  # qs order R K pairs
            lib.is3d_alias_rows_per_block.restype = ci
            lib.is3d_alias_rows_per_block.argtypes = [ci, ci]
        common = [vp, ci, ci, vp,                   # rows C nf layout
                  vp, ci, vp, ci, vp, ci,           # the draw's tables
                  vp, vp, vp,                       # mass sign baryon
                  vp, ci, ci, ctypes.c_longlong,    # counts B n_cap ev0
                  ctypes.c_uint, ctypes.c_uint,     # key
                  ci, ci, ci, cd, cd]               # dim df regulate y_cut lam
        for fn in (lib.is3d_sample_events_f32, lib.is3d_sample_events_f64):
            fn.restype = ci
            fn.argtypes = common + [vp] * 9 + [vp]  # the slot outputs, stream
        for fn in (lib.is3d_sample_packed_f32, lib.is3d_sample_packed_f64):
            fn.restype = ci
            fn.argtypes = common + [ci, ci, ci,     # cap cbits f16
                                    vp, vp, vp, vp, vp, vp,  # idx0 idx1 px py pz eta
                                    vp, vp, vp]     # per_event scratch stream
        lib.is3d_sample_tiles.restype = ci
        lib.is3d_sample_tiles.argtypes = [ctypes.c_longlong]
    lib.is3d_cuda_error_string.restype = ctypes.c_char_p
    lib.is3d_cuda_error_string.argtypes = [ci]
    lib._is3d_bound = True
    return lib


def event_batch_packed_plain(rows, tables, species, counts, src,
                             n_cap: int, cfg: Config, cap: int
                             ) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """The plain version of K7's packed mode: ``pack_batch`` of
    ``event_batch_plain``.  Returns (the packed (cap,) arrays, the
    per-event kept counts (B,) int32, (kept, accepted, proposed) int64)."""
    out = event_batch_plain(rows, tables, species, counts, src, n_cap, cfg)
    packed, per_event = pack_batch(out, cfg, species.mass.shape[0],
                                   rows.shape[0], cap)
    small = torch.stack([per_event.sum(dtype=torch.int64),
                         out["ok"].sum(dtype=torch.int64),
                         out["rounds"].sum(dtype=torch.int64)])
    return packed, per_event, small


def event_batch_packed(rows, layout, tables, species, counts, seed: int,
                       ev0: int, n_cap: int, cfg: Config, cap: int):
    """One batch's kept hadrons: K7's packed mode on CUDA tensors, the
    plain version on CPU ones."""
    if rows.device.type == "cpu":
        return event_batch_packed_plain(
            rows, tables, species, counts,
            PhiloxSource(seed, ev0, rows.dtype), n_cap, cfg, cap)
    return event_batch_packed_cuda(rows, layout, tables, species, counts,
                                   seed, ev0, n_cap, cfg, cap)


# ======================================================================
# Packing and the host side
# ======================================================================

EVENT_FIELDS = ("mcid", "mass", "tau", "x", "y", "eta", "t", "z",
                "E", "px", "py", "pz", "yp")
_PACK_INT = ("sidx", "cidx", "scidx")


def _index_pack_bits(n_species: int, n_cells: int):
    """Bit position fusing (species, cell) into one int32 word sidx <<
    cbits | cidx, or None where they do not fit in 31 bits."""
    cbits = max(1, (max(n_cells, 1) - 1).bit_length())
    sbits = max(1, (max(n_species, 1) - 1).bit_length())
    return cbits if (cbits + sbits) <= 31 else None


def _pack_fields(cfg: Config, fused_idx: bool) -> tuple:
    """Fields copied to the host; the rest are rebuilt there
    (is3d_tpu/kernels/sample.py:_pack_fields)."""
    idx = ("scidx",) if fused_idx else ("sidx", "cidx")
    if cfg.dimension == 2:
        return idx + ("eta", "px", "py", "pz")
    return idx + ("px", "py", "pz")


def _pack_f16(cfg: Config) -> bool:
    """sampler_pack: f16 momenta (and 2+1D eta) on the copy to the host,
    "auto" on float32 runs only."""
    mode = cfg.sampler_pack
    if mode == "auto":
        mode = "f16" if cfg.precision == "f32" else "f32"
    return mode == "f16"


def pack_batch(out: dict, cfg: Config, n_species: int, n_cells: int,
               cap: int) -> tuple[dict, torch.Tensor]:
    """The kept slots of a batch, event-major in (cap,) arrays: a cumsum
    over the keep flags and an index copy (kept slots past ``cap`` are
    dropped; the caller compares the count with ``cap``).  Returns
    (packed, per-event kept counts (B,) int32)."""
    keep = out["keep"].reshape(-1)
    pos = torch.cumsum(keep, 0, dtype=torch.int64) - 1
    idx = torch.where(keep & (pos < cap), pos, torch.full_like(pos, cap))
    cbits = _index_pack_bits(n_species, n_cells)
    vals = dict(out)
    if cbits is not None:
        vals["scidx"] = (out["sidx"] << cbits) | out["cidx"]
    f16 = _pack_f16(cfg)
    packed = {}
    for k in _pack_fields(cfg, cbits is not None):
        v = vals[k].reshape(-1)
        buf = v.new_zeros(cap + 1).scatter_(0, idx, v)[:cap]
        packed[k] = buf.to(torch.float16) if (f16 and k not in _PACK_INT) \
            else buf
    return packed, out["keep"].sum(dim=1, dtype=torch.int32)


def _empty_event() -> dict:
    """A zero-hadron event with the full EVENT_FIELDS schema."""
    return {k: (np.zeros(0, dtype=np.int64) if k == "mcid"
                else np.zeros(0)) for k in EVENT_FIELDS}


def _cell_positions(cell: dict, cfg: Config) -> dict:
    """Host copies of the per-cell positions the packed stream references
    by index."""
    names = ("tau", "x", "y") if cfg.dimension == 2 else ("tau", "x", "y",
                                                          "eta")
    return {k: cell[k].double().cpu().numpy() for k in names}


def _reconstruct_packed(packed: dict, mcids_np, mass_np, cellpos: dict,
                        cfg: Config) -> None:
    """Rebuild the derived per-hadron fields on the host, in place
    (is3d_tpu/kernels/sample.py:_reconstruct_packed): (mcid, mass) from
    the species index, positions from the cell index, on-shell E, (t, z)
    and yp; f16 fields are widened to f32 first.  Every field is copied
    out of ``packed``'s arrays, which may be reused staging buffers."""
    for k, v in packed.items():
        packed[k] = v.astype(np.float32 if v.dtype == np.float16
                             else v.dtype)
    n_cells = len(cellpos["tau"])
    if "scidx" in packed:
        cbits = _index_pack_bits(len(mcids_np), n_cells)
        sc = packed.pop("scidx").astype(np.int64)
        sidx = sc >> cbits
        cidx = sc & ((1 << cbits) - 1)
    else:
        sidx = packed.pop("sidx").astype(np.int64)
        cidx = packed.pop("cidx").astype(np.int64)
    sidx = np.clip(sidx, 0, len(mcids_np) - 1)
    packed["mcid"] = mcids_np[sidx]
    packed["mass"] = mass_np[sidx].astype(packed["px"].dtype)
    cidx = np.clip(cidx, 0, n_cells - 1)
    dtype = packed["px"].dtype
    for k in cellpos:
        if k == "eta" and "eta" in packed:
            continue            # 2+1D: eta is per hadron
        packed[k] = cellpos[k][cidx].astype(dtype)
    packed["E"] = np.sqrt(packed["mass"]**2 + packed["px"]**2
                          + packed["py"]**2 + packed["pz"]**2)
    packed["t"] = packed["tau"] * np.cosh(packed["eta"])
    packed["z"] = packed["tau"] * np.sinh(packed["eta"])
    with np.errstate(divide="ignore", invalid="ignore"):
        packed["yp"] = 0.5 * np.log(
            (packed["E"] + packed["pz"])
            / np.maximum(packed["E"] - packed["pz"], 1e-45))


def _sampler_dtype(dtype: torch.dtype) -> torch.dtype:
    """At least float32 (is3d_tpu/kernels/sample.py:_sampler_dtype)."""
    return torch.promote_types(dtype, torch.float32)


def _sampler_cols(surface, cfg) -> dict:
    cols = surface_columns(surface, cfg)
    cols["x"] = surface.x
    cols["y"] = surface.y
    return cols


def _cast_floats(obj, dtype):
    if isinstance(obj, dict):
        return {k: (v.to(dtype) if torch.is_floating_point(v) else v)
                for k, v in obj.items()}
    return obj.to(dtype=dtype)


def _plasma_avg(plasma, dtype, dev) -> tuple:
    return (torch.tensor(float(plasma.temperature), dtype=dtype, device=dev),
            torch.tensor(float(plasma.baryon_chemical_potential), dtype=dtype,
                         device=dev))


def _laguerre(laguerre, dtype, dev) -> dict:
    if laguerre is None:
        return laguerre_device(32, (1, 2), dtype=dtype, device=dev)
    return laguerre


def build_cell_data(surface, species, df_data, cfg, plasma, laguerre=None
                    ) -> dict:
    """Phase A of a surface (is3d_tpu/kernels/sample.py:_build_cell_data):
    VAH (modes 2-3, which read no VH df table) or viscous hydro, inputs
    upcast to at least float32."""
    dtype = _sampler_dtype(surface.tau.dtype)
    dev = surface.tau.device
    laguerre = _laguerre(laguerre, dtype, dev)
    species = _cast_floats(species, dtype)
    if _vah(cfg):
        return vah_cell_data(_cast_floats(vah_sampler_cols(surface, cfg),
                                          dtype), species, laguerre, cfg)
    return cell_data(_cast_floats(_sampler_cols(surface, cfg), dtype),
                     species, _cast_floats(df_data, dtype), laguerre,
                     _plasma_avg(plasma, dtype, dev), cfg)


def _total_yield(cell, cfg) -> float:
    """Physical mean hadrons per event (2+1D includes the 2 y_cut factor)."""
    ntot = float(cell["mean_cell"].sum())
    if cfg.dimension == 2:
        ntot *= 2.0 * cfg.y_cut
    return ntot


def _report_timings(label: str, timings: dict) -> None:
    """The opt-in breakdown of a sampler run (IS3D_SAMPLER_TIMINGS=1): one
    ``[label timings]`` line of its always-on ``timings`` (info["timings"]:
    phase A, dispatch, wait, copy, assembly, gather), through
    utils.EnvGatedAccumTimer; nothing when the variable is unset."""
    from ..utils import EnvGatedAccumTimer
    timer = EnvGatedAccumTimer("IS3D_SAMPLER_TIMINGS")
    for key, seconds in timings.items():
        timer.add(key, seconds)
    timer.report(label)


def _oversample_nevents(nevents, ntot: float, cfg) -> int:
    """Oversampling event count (reference: emissionfunction.cpp:1524-1532)."""
    if nevents is not None:
        return nevents
    if not cfg.oversample:
        return 1
    return max(1, min(int(math.ceil(cfg.min_num_hadrons / max(ntot, 1e-30))),
                      cfg.max_num_samples))


def _slot_capacity(lam: float) -> int:
    """Per-event hadron-slot capacity: mean + 10 sigma, padded to 128."""
    n_cap = int(lam + 10.0 * math.sqrt(lam) + 64.0)
    return -(-n_cap // 128) * 128


def _resolve_seed(seed, cfg) -> int:
    if seed is None:
        seed = cfg.sampler_seed
    if seed < 0:
        seed = int(np.random.SeedSequence().entropy % (2**31))
    return int(seed)


def _batch_width(nevents: int, n_cap: int) -> int:
    """Events per batch under the 4M-slot budget, batches of equal size."""
    b_max = max(1, min(nevents, (1 << 22) // n_cap))
    n_batches = -(-nevents // b_max)
    return -(-nevents // n_batches)


def _packed_capacity(B: int, ntot_est: float, n_cap: int) -> int:
    """Packed capacity for a B-event batch: mean yield + 10 sigma + 25 %
    headroom (a batch beyond it runs again at twice the capacity)."""
    cap = int(1.25 * B * ntot_est + 10.0 * math.sqrt(B * ntot_est) + 1024.0)
    return min(-(-cap // 128) * 128, B * n_cap)


def calculate_total_yield(surface, species, df_data, cfg, plasma,
                          laguerre=None) -> float:
    """Mean total hadron yield of the surface (reference:
    sampling_kernels.cpp:653-831); in 2+1D dN/dy x 2 y_cut.  Above the
    sampler_cell_chunk bound the mean adds up over the cell chunks' scalar
    pre-pass (no (C, S) table).  ``sample_particles`` returns the same
    number in ``info``."""
    chunk = resolve_cell_chunk(cfg, surface.tau.shape[0])
    if chunk is None:
        return _total_yield(build_cell_data(surface, species, df_data, cfg,
                                            plasma, laguerre), cfg)
    plan = _ChunkPlan(surface, species, df_data, sampler_effective_cfg(
        surface, cfg), plasma, laguerre, chunk)
    ntot = sum(float(plan.build(ci, scalars=True)["mean"])
               for ci in range(plan.n_chunks))
    if cfg.dimension == 2:
        ntot *= 2.0 * cfg.y_cut
    return ntot


def _event_slice(event_partition, n_global: int) -> tuple:
    """[lo, hi) of the global events of ``event_partition`` (k, n)."""
    if event_partition is None:
        return 0, n_global
    k, n = (int(v) for v in event_partition)
    return (k * n_global) // n, ((k + 1) * n_global) // n


def sample_particles(surface, species: SpeciesArrays, mcids,
                     df_data: Optional[DeltafData], cfg: Config, plasma,
                     nevents: Optional[int] = None,
                     seed: Optional[int] = None, laguerre=None,
                     events_per_batch: Optional[int] = None, mesh=None,
                     event_partition: Optional[tuple] = None,
                     info: Optional[dict] = None) -> list:
    """Sample particle event lists on the surface's device: a list of
    per-event dicts of numpy arrays (EVENT_FIELDS).  With oversampling,
    Nevents = min(ceil(min_num_hadrons / Ntot), max_num_samples)
    (emissionfunction.cpp:1504-1562).  VAH surfaces (modes 2-3) need no
    ``df_data``; their residual-df chains pass the gate first
    (``sampler_effective_cfg``).  Surfaces above the ``sampler_cell_chunk``
    bound run chunk by chunk (``_sample_cell_chunked``).

    ``event_partition=(k, n)`` samples the k-th of n contiguous slices of
    the global event range; event i depends only on (seed, i), so the
    slices concatenate to the unpartitioned run byte for byte.  ``info``
    gets ``event_lo``, ``nevents_global``, ``total_yield`` (the mean
    hadrons an event, ``calculate_total_yield``'s number), the batch plan
    (``batches``, ``n_cap``, ``capacity``, ``reruns``; chunked: ``chunks``),
    the momenta ``accepted`` and ``proposed``, and host-clock ``timings``
    (s): phase A, dispatch, wait, copy, assembly.

    With ``mesh`` (a parallel.mesh.CellMesh) the cell axis is sharded over
    its ranks (``sample_particles_sharded``); ``event_partition`` and
    ``events_per_batch`` are the one-device sampler's and raise
    ValueError there."""
    if event_partition is not None:
        k, n = event_partition
        if mesh is not None:
            raise ValueError("event_partition composes with the one-device "
                             "sampler; the cell-sharded mesh sampler has "
                             "its own per-rank streams")
        if not (0 <= int(k) < int(n)):
            raise ValueError(f"event_partition must be (k, n) with "
                             f"0 <= k < n, got {event_partition}")
    if mesh is not None:
        if events_per_batch is not None:
            raise ValueError("events_per_batch is a one-device batching "
                             "knob; the sharded sampler derives its batch "
                             "width from the slot budget")
        return sample_particles_sharded(
            surface, species, mcids, df_data, cfg, plasma, mesh,
            nevents=nevents, seed=seed, laguerre=laguerre, info=info)
    cfg = sampler_effective_cfg(surface, cfg)
    dtype = _sampler_dtype(surface.tau.dtype)
    laguerre = _laguerre(laguerre, dtype, surface.tau.device)
    chunk = resolve_cell_chunk(cfg, surface.tau.shape[0])
    if chunk is not None:
        return _sample_cell_chunked(
            _ChunkPlan(surface, species, df_data, cfg, plasma, laguerre,
                       chunk), mcids, nevents=nevents, seed=seed,
            events_per_batch=events_per_batch,
            event_partition=event_partition, info=info)
    t0 = time.perf_counter()
    cell = build_cell_data(surface, species, df_data, cfg, plasma, laguerre)
    species = _cast_floats(species, dtype)
    lam = float(cell["dn_tot"].sum())
    tables = build_draw_tables(cell.pop("dn_list"), cell["dn_tot"], cfg, lam)
    rows, layout = pack_rows(cell, cfg)

    timings = dict(phase_a=time.perf_counter() - t0)
    total = _total_yield(cell, cfg)
    if info is not None:
        info.update(timings=timings, total_yield=total)
    if lam <= 0.0:
        lo0, hi0 = _event_slice(event_partition, nevents or 1)
        if info is not None:
            info.update(event_lo=lo0, nevents_global=nevents or 1)
        return [_empty_event() for _ in range(hi0 - lo0)]

    ntot = abs(total)
    nevents = _oversample_nevents(nevents, ntot, cfg)
    ev_lo, ev_hi = _event_slice(event_partition, nevents)
    if info is not None:
        info.update(event_lo=ev_lo, nevents_global=nevents)
    if ev_hi == ev_lo:
        return []
    n_cap = _slot_capacity(lam)
    B = events_per_batch or _batch_width(ev_hi - ev_lo, n_cap)
    cap = _packed_capacity(B, min(ntot, lam) or lam, n_cap)
    events = []
    plan = dict(batches=0, n_cap=n_cap, events_per_batch=B, capacity=cap,
                reruns=0, lam=lam)
    acc, samp = _drain_event_range(
        rows, layout, tables, species, cell, cfg, _resolve_seed(seed, cfg),
        lam, ev_lo, ev_hi, B, n_cap, np.asarray(mcids, dtype=np.int64),
        timings, plan, events)
    plan.update(accepted=acc, proposed=samp)
    if info is not None:
        info.update(plan)
    if samp:
        print(f"Momentum sampling efficiency = {100.0 * acc / samp:.2f} %")
    _report_timings("sample_particles", timings)
    return events


def sample_particles_sharded(surface, species: SpeciesArrays, mcids,
                             df_data: Optional[DeltafData], cfg: Config,
                             plasma, mesh, nevents: Optional[int] = None,
                             seed: Optional[int] = None, laguerre=None,
                             info: Optional[dict] = None) -> list:
    """Cell-sharded sampling over the ranks of ``mesh`` (port of
    is3d_tpu/kernels/sample.py:1777-1961).  By Poisson superposition the
    hadrons of disjoint cell subsets are an exact sample of the whole
    surface, so each rank runs the two-phase sampler on its own cells:
    rank r takes the cells [r ceil(C / W), (r + 1) ceil(C / W)), padded
    inert, and runs phase A (K7b, then K7a or the searches' cumsums) and
    K7 on them under _chunk_seed(seed, r) -- the port's fold_in(key, dev).
    The batch shapes and the event count come from one all-gather of the
    ranks' (lam, mean), and each event's lists are gathered in rank order:
    every rank returns the same list, one process's _sample_cell_chunked
    with sampler_cell_chunk = ceil(C / W) byte for byte.  ``info`` as
    sample_particles' (event_lo 0, the whole event range)."""
    from ..parallel.mesh import check_mesh
    check_mesh(mesh)
    if surface.tau.device != mesh.device:
        raise ValueError(f"the surface is on {surface.tau.device}, the "
                         f"mesh's rank on {mesh.device}")
    cfg = sampler_effective_cfg(surface, cfg)
    dtype = _sampler_dtype(surface.tau.dtype)
    laguerre = _laguerre(laguerre, dtype, surface.tau.device)
    chunk = -(-surface.tau.shape[0] // mesh.size)
    plan = _ChunkPlan(surface, species, df_data, cfg, plasma, laguerre,
                      chunk)
    return _sample_cell_chunked(plan, mcids, nevents=nevents, seed=seed,
                                info=info, mesh=mesh)


# ======================================================================
# Cell-chunked sampling: bounded phase-A memory at any surface size
# ======================================================================
# Disjoint cell chunks are independent sub-surfaces by Poisson
# superposition (is3d_tpu/kernels/sample.py:1610-1633), so each chunk runs
# the whole two-phase sampler under its own seed and the per-event hadron
# lists concatenate over chunks: exact in distribution, the streams a
# function of (seed, sampler_cell_chunk, C).  One chunk's (chunk, S) tables
# live on the device at a time; the batch shapes (n_cap, the batch width,
# the packed capacity) are pinned to the worst chunk from a scalar
# pre-pass that keeps no (chunk, S) table (K7b's row sums alone).

def _chunk_seed(seed: int, chunk_idx: int) -> int:
    """Independent per-chunk sampler seed: a pure function of (seed,
    chunk index) through a SeedSequence branch distinct from both the
    event fold_in stream and the decay-seed branch (0x6D63)."""
    return int(np.random.SeedSequence(
        (int(seed), 0x63636B, int(chunk_idx))).generate_state(
            2, dtype=np.uint64)[0] % (2**63))


def _chunk_cols(cols: dict, lo: int, hi: int, target: int) -> dict:
    """Slice [lo, hi) of every cell column, padded to ``target`` cells
    with inert entries (dsigma = 0 => u.dsigma = 0 => invalid => zero
    yield, never drawn; the fields padded to 1 keep 1/T finite)."""
    out = {k: v[lo:hi] for k, v in cols.items()}
    return out if hi - lo == target else _pad_inert(out, target)


class _ChunkPlan:
    """A surface cut into cell chunks of ``chunk`` (the last padded
    inert), and the phase A of one chunk (``build``)."""

    def __init__(self, surface, species, df_data, cfg, plasma, laguerre,
                 chunk: int):
        self.cfg = cfg
        self.dtype = _sampler_dtype(surface.tau.dtype)
        dev = surface.tau.device
        self.laguerre = _laguerre(laguerre, self.dtype, dev)
        self.species = _cast_floats(species, self.dtype)
        if _vah(cfg):
            self.cols = _cast_floats(vah_sampler_cols(surface, cfg),
                                     self.dtype)
        else:
            self.cols = _cast_floats(_sampler_cols(surface, cfg), self.dtype)
            self.df = _cast_floats(df_data, self.dtype)
            self.plasma_avg = _plasma_avg(plasma, self.dtype, dev)
        C = self.cols["tau"].shape[0]
        self.chunk = chunk
        self.n_chunks = -(-C // chunk)
        self.bounds = [(ci * chunk, min((ci + 1) * chunk, C))
                       for ci in range(self.n_chunks)]

    def build(self, ci: int, scalars: bool) -> dict:
        """Phase A of chunk ``ci`` (``scalars``: {lam, mean} alone)."""
        cc = _chunk_cols(self.cols, *self.bounds[ci], self.chunk)
        if _vah(self.cfg):
            return vah_cell_data(cc, self.species, self.laguerre, self.cfg,
                                 scalars_only=scalars)
        return cell_data(cc, self.species, self.df, self.laguerre,
                         self.plasma_avg, self.cfg, scalars_only=scalars)


def _chunk_scalars(plan: _ChunkPlan, own, mesh) -> tuple[list, list]:
    """The scalar pre-pass: each chunk's (lam, mean), those of ``own``
    computed here; over a mesh (one chunk a rank) one all-gather of the
    ranks' pairs gives every chunk's on every rank."""
    pairs = [(float(s["lam"]), float(s["mean"]))
             for s in (plan.build(ci, scalars=True) for ci in own)]
    if mesh is not None and mesh.size > 1:
        from ..parallel.mesh import _all_gather_rows
        send = torch.tensor(pairs or [(0.0, 0.0)], dtype=torch.float64,
                            device=mesh.device)
        pairs = [tuple(p) for p in _all_gather_rows(send, mesh)
                 .cpu().tolist()[:plan.n_chunks]]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _sample_cell_chunked(plan: _ChunkPlan, mcids, nevents=None, seed=None,
                         events_per_batch=None, event_partition=None,
                         info=None, mesh=None) -> list:
    """The cell-chunked sampler (is3d_tpu/kernels/sample.py:
    _sample_cell_chunked): the scalar pre-pass, then each chunk's phase A,
    tables and batches under its own seed (_chunk_seed), the events merged
    chunk by chunk in chunk order.  Composes with event_partition: the
    streams key on (chunk seed, global event), so the union of event
    slices is byte-identical to the whole chunked run.  With ``mesh`` rank
    r runs chunk r alone (sample_particles_sharded) and the ranks gather
    their event lists in rank order: every rank returns this run's list
    one process gives byte for byte."""
    cfg, species = plan.cfg, plan.species
    t0 = time.perf_counter()
    own = (range(plan.n_chunks) if mesh is None
           else range(mesh.rank, min(mesh.rank + 1, plan.n_chunks)))
    lam_chunks, mean_chunks = _chunk_scalars(plan, own, mesh)
    timings = dict(phase_a=time.perf_counter() - t0)
    lam_max = max(lam_chunks)
    y_fact = 2.0 * cfg.y_cut if cfg.dimension == 2 else 1.0
    total = sum(mean_chunks) * y_fact
    if info is not None:
        info.update(timings=timings, total_yield=total,
                    chunks=plan.n_chunks, chunk=plan.chunk)
    if lam_max <= 0.0:
        lo0, hi0 = _event_slice(event_partition, nevents or 1)
        if info is not None:
            info.update(event_lo=lo0, nevents_global=nevents or 1)
        return [_empty_event() for _ in range(hi0 - lo0)]

    nevents = _oversample_nevents(nevents, abs(total), cfg)
    ev_lo, ev_hi = _event_slice(event_partition, nevents)
    if info is not None:
        info.update(event_lo=ev_lo, nevents_global=nevents)
    if ev_hi == ev_lo:
        return []
    # shapes pinned to the worst chunk
    seed = _resolve_seed(seed, cfg)
    n_cap = _slot_capacity(lam_max)
    B = events_per_batch or _batch_width(ev_hi - ev_lo, n_cap)
    ntot_est = max(min(abs(m) * y_fact, lm) or lm
                   for m, lm in zip(mean_chunks, lam_chunks))
    batches = dict(batches=0, n_cap=n_cap, events_per_batch=B,
                   capacity=_packed_capacity(B, ntot_est, n_cap), reruns=0,
                   lam=sum(lam_chunks), lam_max=lam_max)
    mcids_np = np.asarray(mcids, dtype=np.int64)
    merged = [{k: [] for k in EVENT_FIELDS} for _ in range(ev_hi - ev_lo)]
    acc = samp = 0
    for ci in own:
        if lam_chunks[ci] <= 0.0:
            continue                      # an inert chunk adds nothing
        t = time.perf_counter()
        cell = plan.build(ci, scalars=False)
        tables = build_draw_tables(cell.pop("dn_list"), cell["dn_tot"], cfg,
                                   lam_chunks[ci])
        rows, layout = pack_rows(cell, cfg)
        timings["phase_a"] += time.perf_counter() - t
        ev_chunk = []
        a, n = _drain_event_range(
            rows, layout, tables, species, cell, cfg,
            _chunk_seed(seed, ci), lam_chunks[ci], ev_lo, ev_hi, B, n_cap,
            mcids_np, timings, batches, ev_chunk)
        acc += a
        samp += n
        for m, ev in zip(merged, ev_chunk):
            for k in EVENT_FIELDS:
                m[k].append(ev[k])
        del cell, tables, rows
    if mesh is not None and mesh.size > 1:
        t = time.perf_counter()
        merged, acc, samp = _gather_chunk_events(merged, acc, samp, mesh)
        timings["gather"] = time.perf_counter() - t
    events = [{k: np.concatenate(v) for k, v in m.items()} if m["mcid"]
              else _empty_event() for m in merged]
    batches.update(accepted=acc, proposed=samp)
    if info is not None:
        info.update(batches)
    if samp:
        print(f"Momentum sampling efficiency = {100.0 * acc / samp:.2f} %")
    _report_timings("sample_particles (cell-chunked)" if mesh is None
                    else "sample_particles_sharded", timings)
    return events


def _gather_chunk_events(merged: list, acc0: int, samp0: int, mesh):
    """Every rank's per-event chunk lists, merged in rank order (= chunk
    order), and the momenta accepted and proposed over the ranks.  A rank
    sends each event's arrays as one concatenation (one array a field: a
    single chunk a rank, or none for an inert one)."""
    from ..parallel.mesh import gather_objects
    mine = [{k: np.concatenate(v) for k, v in m.items()} if m["mcid"]
            else None for m in merged]
    out = [{k: [] for k in EVENT_FIELDS} for _ in merged]
    acc = samp = 0
    for theirs, a, n in gather_objects((mine, acc0, samp0), mesh):
        acc += a
        samp += n
        for m, ev in zip(out, theirs):
            if ev is not None:
                for k in EVENT_FIELDS:
                    m[k].append(ev[k])
    return out, acc, samp


def _drain_event_range(rows, layout, tables, species, cell, cfg, seed: int,
                       lam: float, ev_lo: int, ev_hi: int, B: int,
                       n_cap: int, mcids_np, timings: dict, plan: dict,
                       events: list) -> tuple[int, int]:
    """Run and drain every batch of [ev_lo, ev_hi), appending per-event
    dicts to ``events``; returns the (accepted, proposed) momenta.

    On the card batch k+1 is queued before batch k is drained: batch k's
    kept hadrons, compacted by K7's packed mode, go to pinned host memory
    on a side stream while k+1's kernel runs.  A batch whose kept hadrons
    exceed the packed capacity runs again at twice the capacity
    (counter-keyed streams: the same hadrons), and the capacity stays
    doubled.  The nested functions form no reference cycle, so the
    tables they read are freed when this returns (the cell-chunked
    driver's next chunk needs the memory)."""
    dev = rows.device
    cuda = dev.type == "cuda"
    mass_np = species.mass.double().cpu().numpy()
    cellpos = _cell_positions(cell, cfg)
    copy_stream = torch.cuda.Stream(dev) if cuda else None
    stage = {}      # pinned host buffers the kept columns land in
    for k in ("dispatch", "wait", "copy", "assembly"):
        timings.setdefault(k, 0.0)
    totals = [0, 0]

    def dispatch(start: int, b: int, cap: int) -> dict:
        t = time.perf_counter()
        counts = torch.from_numpy(rng.poisson_counts(
            seed, range(start, start + b), lam).astype(np.int32))
        if int(counts.max()) > n_cap:
            raise RuntimeError(f"sampler: an event of {int(counts.max())} "
                               f"hadrons exceeds the slot capacity {n_cap}")
        if cuda:     # a blocking copy would wait for the queued batch
            counts = counts.pin_memory().to(dev, non_blocking=True)
        packed, per_event, small = event_batch_packed(
            rows, layout, tables, species, counts, seed, start, n_cap, cfg,
            cap)
        item = dict(start=start, b=b, cap=cap, packed=packed)
        if cuda:
            item["per_event"] = torch.empty(b, dtype=torch.int32,
                                            pin_memory=True)
            item["small"] = torch.empty(3, dtype=torch.int64,
                                        pin_memory=True)
            item["per_event"].copy_(per_event, non_blocking=True)
            item["small"].copy_(small, non_blocking=True)
            item["ready"] = torch.cuda.Event()
            item["ready"].record()
        else:
            item["per_event"], item["small"] = per_event, small
        timings["dispatch"] += time.perf_counter() - t
        return item

    def drain(item: dict):
        while True:
            t = time.perf_counter()
            if cuda:
                item["ready"].synchronize()
            n_kept, n_ok, n_rounds = (int(v) for v in item["small"])
            timings["wait"] += time.perf_counter() - t
            if n_kept <= item["cap"]:
                break
            cap = item["cap"]
            while cap < n_kept:
                cap *= 2
            plan["capacity"] = cap
            plan["reruns"] += 1
            item = dispatch(item["start"], item["b"], cap)
        t = time.perf_counter()
        if cuda:
            for k, v in item["packed"].items():
                if k not in stage or stage[k].shape[0] < n_kept:
                    stage[k] = torch.empty(v.shape[0], dtype=v.dtype,
                                           pin_memory=True)
            copy_stream.wait_event(item["ready"])
            with torch.cuda.stream(copy_stream):
                host = {k: stage[k][:n_kept].copy_(v[:n_kept],
                                                   non_blocking=True)
                        for k, v in item["packed"].items()}
            copy_stream.synchronize()
        else:
            host = {k: v[:n_kept] for k, v in item["packed"].items()}
        cut = {k: v.numpy() for k, v in host.items()}
        timings["copy"] += time.perf_counter() - t
        t = time.perf_counter()
        counts = item["per_event"].numpy().astype(np.int64)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        _reconstruct_packed(cut, mcids_np, mass_np, cellpos, cfg)
        for e in range(item["b"]):
            lo, hi = int(offsets[e]), int(offsets[e + 1])
            events.append({k: cut[k][lo:hi] for k in EVENT_FIELDS})
        totals[0] += n_ok
        totals[1] += n_rounds
        plan["batches"] += 1
        timings["assembly"] += time.perf_counter() - t

    pending = None
    for start in range(ev_lo, ev_hi, B):
        item = dispatch(start, min(B, ev_hi - start), plan["capacity"])
        if pending is not None:
            drain(pending)
        pending = item
    if pending is not None:
        drain(pending)
    return totals[0], totals[1]
