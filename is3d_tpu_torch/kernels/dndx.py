"""Smooth Cooper-Frye spacetime distributions (operation = 0):
dN/(tau dtau dy), dN/(2 pi r dr dy), dN/(2 pi tau r dtau dr dy), dN/dy/deta.

Port of ``is3d_tpu.kernels.dndx`` for viscous-hydro surfaces with linear
delta-f (df 1-2; reference: emissionfunction_smooth_kernels.cpp:1000-2135).
The pointwise emission function is the spectra kernels' (fixed rapidity
nodes); it is reduced over the momentum points per (cell, species) and per
(species, node), and the per-cell dN/dy is binned on the (tau, r) grid.
One group of cells goes through:

1. ``prepare_cells`` + ``smooth.pack_cells``: the spectra kernel's (Cp, NF)
   input;
2. ``dndx_cuda`` (the hand-written kernel csrc/dndx.cu) for CUDA tensors,
   ``dndx_plain`` for CPU tensors: per_cell (Cp, S) and dydeta (S, R), both
   x CF_PREFACTOR x degeneracy;
3. ``bin_plan`` (the group's bin of every cell, sorted once) and
   ``dndx_bin_cuda`` (csrc/dndx.cu's segment-sum kernel) or
   ``dndx_bin_plain``: the tau, r and (tau, r) histograms and dN/dy.

The group accumulators are folded in group order by
``parallel.mesh.grouped_cell_reduce``; ``dndx_finalize`` normalizes them on
the host.  Every reduction on the CUDA path runs in a fixed order without
float atomics, so a run is bit-identical to the next.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..units import CF_PREFACTOR
from ..config import Config
from ..data import SpeciesArrays
from ..io.tables import MomentumGrid
from ..io.deltaf import DeltafData
from .common import surface_columns, prepare_cells, effective_chunk
from .launch import check_float, check_tensor, require_cuda, launch
from .smooth import (MomentumConstants, SpectraFlags, NF, pack_cells,
                     plain_block, spectra_flags, momentum_constants)

# launches of the CUDA kernels in this process: the per-cell reduction
# (dndx_cuda) and the histogram segment sum (dndx_bin_cuda)
LAUNCHES = 0
BIN_LAUNCHES = 0

# csrc/dndx.cu: cells per shared-memory tile, and the blocks the cell
# split aims for (eight per SM of an H100)
_TILE = 16
_TARGET_BLOCKS = 8 * 132

# per (cell, node, species, point) evaluation of the 2+1D float32 kernel,
# by df mode, counted in its sm_90a SASS (the unrolled loop body holds 16
# evaluations: 601 (df 1) and 680 (df 2) FP32-pipe instructions, 16 ex2
# and 16 or 32 reciprocals; 1054 and 1325 instructions in all)
FP32_PER_EVAL = {1: 601 / 16, 2: 680 / 16}
SFU_PER_EVAL = {1: 2, 2: 3}


def dndx_cols(surface, cfg: Config) -> dict:
    """Cell columns the dN/dX kernel reduces over: the emission columns
    plus the (x, y) positions for the (tau, r) binning."""
    cols = surface_columns(surface, cfg)
    cols["x"] = surface.x
    cols["y"] = surface.y
    return cols


def momentum_weights(grid: MomentumGrid, cfg: Config) -> torch.Tensor:
    """wM (n_pT * n_phi,): the momentum integral's weight per point.  With
    the pT jacobian (reference_compat_dndy = 0) or without it, as the
    reference's dN_dX momentum integral does (:1372; observables.dN_dy)."""
    wp = (grid.pT_weight if cfg.reference_compat_dndy
          else grid.pT_weight * grid.pT)
    return (wp[:, None] * grid.phi_weight[None, :]).reshape(-1).contiguous()


def node_weights(grid: MomentumGrid, dimension: int) -> torch.Tensor:
    """wR (n_nodes,) of the per-cell sum over nodes: the eta weights in
    2+1D; ones in 3+1D, where the reference sums the y grid without weights
    (:1312-1374)."""
    if dimension == 2:
        return grid.eta_weight.contiguous()
    return torch.ones_like(grid.y)


# ------------------------------------------------------------ plain version

def dndx_plain(cells: torch.Tensor, mom: MomentumConstants,
               flags: SpectraFlags, wM: torch.Tensor, wR: torch.Tensor,
               cell_chunk: int = 65536) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the kernel on the same inputs: per_cell
    (Cp, S) = Σ_r wR Σ_m wM f and dydeta (S, R) = Σ_c Σ_m wM f, both x
    CF_PREFACTOR x degeneracy (the port of _cell_dNdy on the reduce=False
    block), cells in chunks within common.CHUNK_ELEMENT_BUDGET."""
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    R = mom.nodes.shape[0]
    C = cells.shape[0]
    chunk = effective_chunk(cell_chunk, C, R * S * P * F)
    per_cell, dydeta = [], None
    for c0 in range(0, C, chunk):
        block = plain_block(cells[c0:c0 + chunk], mom, flags)
        t = torch.einsum("crsm,m->crs", block.reshape(-1, R, S, P * F), wM)
        per_cell.append(torch.einsum("crs,r->cs", t, wR))
        part = t.sum(0).T
        dydeta = part if dydeta is None else dydeta.add_(part)
    scale = CF_PREFACTOR * mom.degeneracy
    return ((torch.cat(per_cell) * scale[None, :]).contiguous(),
            (dydeta * scale[:, None]).contiguous())


# ------------------------------------------------------------- CUDA kernel

def _library():
    from ..native.build import cuda_library
    lib = cuda_library("dndx")
    if not getattr(lib, "_is3d_bound", False):
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for fn in (lib.is3d_dndx_f32, lib.is3d_dndx_f64):
            fn.restype = ci
            fn.argtypes = [vp, ci, ci,                 # cells, n_cells, nf
                           vp, vp, vp, vp, ci,         # species, n_species
                           vp, vp, vp, ci, ci,         # pT, px, py, n_pT, n_phi
                           vp, vp, vp, ci,             # nodes, wR, wM, n_nodes
                           ci, ci, ci, ci,             # df, dim, reg, outflow
                           cd, ci,                     # prefactor, split
                           vp, vp, vp, vp]             # outputs, scratch, stream
        for fn in (lib.is3d_dndx_probe_f32, lib.is3d_dndx_probe_f64):
            fn.restype = ci
            fn.argtypes = [vp, ci, ci,                 # a, n_cells, n_nodes
                           vp, vp, ci, ci,             # b, w, n_species, M
                           vp, vp, ci,                 # wM, wR, split
                           vp, vp, vp, vp]             # outputs, scratch, stream
        for fn in (lib.is3d_dndx_bin_f32, lib.is3d_dndx_bin_f64):
            fn.restype = ci
            fn.argtypes = [vp, ci, vp, vp, ci, vp, vp]
        lib.is3d_cuda_error_string.restype = ctypes.c_char_p
        lib.is3d_cuda_error_string.argtypes = [ci]
        lib._is3d_bound = True
    return lib


def cell_split(n_cells: int, n_species: int) -> tuple[int, int]:
    """(cells per block, blocks per species) of the kernel's grid: whole
    tiles per block, enough blocks for about _TARGET_BLOCKS in all."""
    tiles = -(-max(n_cells, 1) // _TILE)
    n_split = min(tiles, max(1, -(-_TARGET_BLOCKS // max(n_species, 1))))
    per = -(-tiles // n_split) * _TILE
    return per, -(-max(n_cells, 1) // per)


def dndx_cuda(cells: torch.Tensor, mom: MomentumConstants,
              flags: SpectraFlags, wM: torch.Tensor,
              wR: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the hand-written kernel (csrc/dndx.cu) on the current
    stream: (per_cell (Cp, S), dydeta (S, R)) in the cells' dtype."""
    global LAUNCHES
    check_float("dndx_cuda", cells)
    check_tensor("cells", cells, (cells.shape[0], NF), cells)
    if flags.remap:
        raise ValueError("dndx_cuda evaluates at fixed rapidity nodes "
                         "(flags.remap must be False)")
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    R = mom.nodes.shape[0]
    for name, n in dict(mass=S, sign=S, baryon=S, degeneracy=S, pT=P,
                        px=P * F, py=P * F, nodes=R).items():
        check_tensor(f"momentum constant {name}", getattr(mom, name), (n,),
                     cells)
    check_tensor("wM", wM, (P * F,), cells)
    check_tensor("wR", wR, (R,), cells)
    require_cuda("dndx_cuda", cells)
    C = cells.shape[0]
    per, n_split = cell_split(C, S)
    per_cell = cells.new_empty((C, S))
    dydeta = cells.new_empty((S, R))
    partial = cells.new_empty((n_split, S, R))
    lib = _library()
    fn = (lib.is3d_dndx_f32 if cells.dtype == torch.float32
          else lib.is3d_dndx_f64)
    launch(lib, "dndx", fn, cells.device,
           cells.data_ptr(), C, NF,
           mom.mass.data_ptr(), mom.sign.data_ptr(),
           mom.baryon.data_ptr(), mom.degeneracy.data_ptr(), S,
           mom.pT.data_ptr(), mom.px.data_ptr(), mom.py.data_ptr(), P, F,
           mom.nodes.data_ptr(), wR.data_ptr(), wM.data_ptr(), R,
           flags.df_mode, flags.dimension, int(flags.regulate),
           int(flags.outflow), CF_PREFACTOR, per, per_cell.data_ptr(),
           dydeta.data_ptr(), partial.data_ptr())
    LAUNCHES += 1
    return per_cell, dydeta


# ------------------------------------------------------------------ binning

@dataclass(frozen=True)
class BinPlan:
    """The (tau, r) bins of a group's cells, as one list of (bin, cell)
    entries sorted stably by bin.  Bins are laid out as tau (n_tau) | r
    (n_r) | (tau, r) (n_tau * n_r, tau-major) | one bin holding every cell
    (the group's dN/dy); a cell outside the tau (r) range has no entry in
    the tau (r) and (tau, r) histograms."""

    n_tau: int
    n_r: int
    key: torch.Tensor     # (E,) int64 bin of each entry, ascending
    cell: torch.Tensor    # (E,) int32 cell of each entry; ascending per bin
    start: torch.Tensor   # (n_bins + 1,) int32 first entry of each bin

    @property
    def n_bins(self) -> int:
        return self.n_tau + self.n_r + self.n_tau * self.n_r + 1


def bin_plan(tau: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
             cfg: Config) -> BinPlan:
    """The JAX package's bin rules (_dndx_jit): itau = floor((tau -
    tau_min) / dtau), ir = floor((r - r_min) / dr), r = sqrt(x^2 + y^2),
    in the columns' dtype; out-of-range cells are masked out.  Integer
    ops only, on the columns' device."""
    n_tau, n_r = cfg.tau_bins, cfg.r_bins
    dtau = (cfg.tau_max - cfg.tau_min) / n_tau
    dr = (cfg.r_max - cfg.r_min) / n_r
    r = torch.sqrt(x ** 2 + y ** 2)
    itau = torch.floor((tau - cfg.tau_min) / dtau).to(torch.int64)
    ir = torch.floor((r - cfg.r_min) / dr).to(torch.int64)
    tau_ok = (itau >= 0) & (itau < n_tau)
    r_ok = (ir >= 0) & (ir < n_r)
    both = tau_ok & r_ok
    ids = torch.arange(tau.shape[0], device=tau.device)
    n_bins = n_tau + n_r + n_tau * n_r + 1
    key = torch.cat([itau[tau_ok], n_tau + ir[r_ok],
                     n_tau + n_r + (itau * n_r + ir)[both],
                     torch.full_like(ids, n_bins - 1)])
    cell = torch.cat([ids[tau_ok], ids[r_ok], ids[both], ids])
    key, order = torch.sort(key, stable=True)
    counts = torch.bincount(key, minlength=n_bins)
    start = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return BinPlan(n_tau=n_tau, n_r=n_r, key=key,
                   cell=cell[order].to(torch.int32).contiguous(),
                   start=start.to(torch.int32).contiguous())


def dndx_bin_plain(per_cell: torch.Tensor, plan: BinPlan) -> torch.Tensor:
    """Plain torch version of the binning kernel: hist (S, n_bins) with
    hist[s, b] = Σ over b's entries of per_cell[cell, s]."""
    S = per_cell.shape[1]
    hist = per_cell.new_zeros((S, plan.n_bins))
    return hist.index_add_(1, plan.key, per_cell[plan.cell.long()].T)


def dndx_bin_cuda(per_cell: torch.Tensor, plan: BinPlan) -> torch.Tensor:
    """Launch csrc/dndx.cu's segment-sum kernel: hist (S, n_bins), each
    bin summed over its cells in index order (no atomics)."""
    global BIN_LAUNCHES
    check_float("dndx_bin_cuda", per_cell)
    if per_cell.dim() != 2:
        raise ValueError(f"per_cell must be (C, S), got "
                         f"{tuple(per_cell.shape)}")
    check_tensor("per_cell", per_cell, tuple(per_cell.shape), per_cell)
    check_tensor("plan.start", plan.start, (plan.n_bins + 1,), per_cell,
                 torch.int32)
    check_tensor("plan.cell", plan.cell, (plan.key.shape[0],), per_cell,
                 torch.int32)
    require_cuda("dndx_bin_cuda", per_cell)
    S = per_cell.shape[1]
    hist = per_cell.new_empty((S, plan.n_bins))
    lib = _library()
    fn = (lib.is3d_dndx_bin_f32 if per_cell.dtype == torch.float32
          else lib.is3d_dndx_bin_f64)
    launch(lib, "dndx_bin", fn, per_cell.device, per_cell.data_ptr(), S,
           plan.cell.data_ptr(), plan.start.data_ptr(), plan.n_bins,
           hist.data_ptr())
    BIN_LAUNCHES += 1
    return hist


# ------------------------------------------------------------ entry point

def _group_dndx(cols: dict, mom: MomentumConstants, flags: SpectraFlags,
                wM: torch.Tensor, wR: torch.Tensor, df_data: DeltafData,
                cfg: Config) -> dict:
    """The accumulators of one group: the (tau, r) histograms, dN/dy and
    dN/dy/deta."""
    cells = pack_cells(prepare_cells(cols, cfg, df_data), cfg)
    plan = bin_plan(cols["tau"], cols["x"], cols["y"], cfg)
    if cells.device.type == "cuda":
        per_cell, dydeta = dndx_cuda(cells, mom, flags, wM, wR)
        hist = dndx_bin_cuda(per_cell, plan)
    elif cells.device.type == "cpu":
        per_cell, dydeta = dndx_plain(cells, mom, flags, wM, wR,
                                      cfg.cell_chunk)
        hist = dndx_bin_plain(per_cell, plan)
    else:
        raise ValueError(f"no dN/dX path for device {cells.device}")
    n_tau, n_r = plan.n_tau, plan.n_r
    S = hist.shape[0]
    return dict(
        tau_hist=hist[:, :n_tau].contiguous(),
        r_hist=hist[:, n_tau:n_tau + n_r].contiguous(),
        taur_hist=hist[:, n_tau + n_r:-1].reshape(S, n_tau, n_r).contiguous(),
        dydeta=dydeta,
        dNdy=hist[:, -1].contiguous())


def dndx_finalize(acc: dict, grid: MomentumGrid, cfg: Config) -> dict:
    """Histogram accumulators -> normalized distributions + bin midpoints
    (reference file values, emissionfunction_smooth_kernels.cpp:1404-1432),
    as host numpy arrays."""
    acc = {k: v.cpu().numpy() for k, v in acc.items()}

    dtau = (cfg.tau_max - cfg.tau_min) / cfg.tau_bins
    dr = (cfg.r_max - cfg.r_min) / cfg.r_bins
    tau_mid = cfg.tau_min + dtau * (np.arange(cfg.tau_bins) + 0.5)
    r_mid = cfg.r_min + dr * (np.arange(cfg.r_bins) + 0.5)

    eta = (grid.eta if cfg.dimension == 2 else grid.y).cpu().numpy()
    return dict(
        tau_mid=tau_mid, r_mid=r_mid, eta=eta,
        dN_dy=acc["dNdy"],
        dN_dydeta=acc["dydeta"],
        dN_taudtaudy=acc["tau_hist"] / (tau_mid * dtau)[None, :],
        dN_twopirdrdy=acc["r_hist"] / (2.0 * np.pi * r_mid * dr)[None, :],
        dN_twopitaurdtaudrdy=acc["taur_hist"]
        / (2.0 * np.pi * tau_mid[:, None] * r_mid[None, :] * dtau * dr)[None],
        raw_tau_hist=acc["tau_hist"], raw_r_hist=acc["r_hist"],
    )


def spacetime_distributions(surface, species: SpeciesArrays,
                            grid: MomentumGrid, df_data: DeltafData,
                            cfg: Config) -> dict:
    """All dN/dX distributions (linear df 1-2, viscous-hydro surfaces):
    a dict of host numpy arrays with bin midpoints and normalized
    distributions.  The cell reduction runs through the canonical group
    tree: one launch of each kernel per group, accumulators folded in group
    order."""
    from ..parallel.mesh import grouped_cell_reduce
    if cfg.df_mode not in (1, 2) or cfg.mode in (2, 3):
        raise ValueError("spacetime_distributions handles linear df 1-2 on "
                         "viscous-hydro surfaces")
    cols = dndx_cols(surface, cfg)
    # dN/dX keeps fixed eta nodes: dN/dy/deta is reported AT the common
    # node positions, which a per-species mT remap would scramble
    grid = dataclasses.replace(grid, eta_mT_rescale=False)
    flags = spectra_flags(cfg, grid)
    mom = momentum_constants(species, grid, cfg.dimension)
    wM = momentum_weights(grid, cfg)
    wR = node_weights(grid, cfg.dimension)
    acc = grouped_cell_reduce(
        lambda c, m, fl, wm, wr, d: _group_dndx(c, m, fl, wm, wr, d, cfg),
        cols, (mom, flags, wM, wR, df_data), cfg)
    return dndx_finalize(acc, grid, cfg)
