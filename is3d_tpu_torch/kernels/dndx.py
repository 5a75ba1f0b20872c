"""Smooth Cooper-Frye spacetime distributions (operation = 0):
dN/(tau dtau dy), dN/(2 pi r dr dy), dN/(2 pi tau r dtau dr dy), dN/dy/deta.

Port of ``is3d_tpu.kernels.dndx``: viscous-hydro surfaces with linear
delta-f (df 1-2) and modified equilibrium (df 3-4; reference:
emissionfunction_smooth_kernels.cpp:1000-2135), and anisotropic-hydro
surfaces (modes 2-3, the VAH emission of kernels/vah.py, which the
reference has no dN/dX path for).  The pointwise emission
function is the spectra kernels' (fixed rapidity nodes); it is reduced over
the momentum points per (cell, species) and per (species, node), and the
per-cell dN/dy is binned on the (tau, r) grid.  One group of cells goes
through:

1. ``prepare_cells`` + ``smooth.pack_cells``: the spectra kernel's (Cp, NF)
   input (df 3-4: ``feqmod.group_inputs``, the feqmod kernels' packed rows
   and (cell, species) tables; modes 2-3: ``vah.group_inputs``, the VAH
   kernels' packed rows);
2. ``dndx_cuda`` (the hand-written kernel csrc/dndx.cu, fed the species,
   mT and point tables of ``emission_tables`` and a cell split chosen by
   ``cell_split`` to fill the card; df 3-4: ``dndx_feqmod_cuda``, the same
   kernel with the feqmod producer; modes 2-3: ``dndx_vah_cuda``, with the
   VAH producer) for CUDA tensors, ``dndx_plain`` (``dndx_feqmod_plain``,
   ``dndx_vah_plain``) for CPU tensors: per_cell (Cp, S) and dydeta (S,
   R), both x CF_PREFACTOR x degeneracy;
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
from ..io.tables import MomentumGrid, laguerre_in_precision
from ..io.deltaf import DeltafData
from .common import surface_columns, prepare_cells, effective_chunk
from .launch import (check_float, check_tensor, require_cuda, launch,
                     resident_blocks, split_to_fill)
from .smooth import (MomentumConstants, SpectraFlags, NF,
                     FORMULA_OPS as SPECTRA_FORMULA_OPS,
                     pack_cells, plain_block, spectra_flags,
                     momentum_constants)
from . import feqmod, vah

# launches of the CUDA kernels in this process: the per-cell reduction
# (dndx_cuda; with the feqmod producer, dndx_feqmod_cuda; with the VAH
# producer, dndx_vah_cuda) and the histogram segment sum (dndx_bin_cuda)
LAUNCHES = 0
FEQMOD_LAUNCHES = 0
VAH_LAUNCHES = 0
BIN_LAUNCHES = 0

# csrc/dndx.cu: threads per block, species and nodes per thread of the
# per-cell kernel; binning entries per slice; the most cell splits
_BLOCK = 128
_J = 4
_YC = 3
_SLICE = 64
_MAX_SPLIT = 1024

# the bound's yardstick is the spectra kernel's (kernels/smooth.py): the
# emission value plus the sum over momentum points; the sums over nodes and
# over cells act once per (cell, node, species), not per evaluation (the
# VAH producer's is kernels/vah.py's vah_formula_ops at fixed nodes)
FORMULA_OPS = SPECTRA_FORMULA_OPS


def dndx_cols(surface, cfg: Config) -> dict:
    """Cell columns the dN/dX kernel reduces over: the emission columns of
    the surface mode plus the (x, y) positions for the (tau, r)
    binning."""
    if cfg.mode in (2, 3):
        cols = vah.vah_surface_cols(surface)
    else:
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
    n = mom.nodes.shape[0] * mom.mass.shape[0] * mom.px.shape[0]
    return _reduce_plain(
        lambda c0, k: plain_block(cells[c0:c0 + k], mom, flags),
        cells.shape[0], mom, wM, wR,
        effective_chunk(cell_chunk, cells.shape[0], n))


def dndx_feqmod_plain(x: torch.Tensor, rn: torch.Tensor, wcs: torch.Tensor,
                      mom: MomentumConstants, flags: feqmod.FeqmodFlags,
                      wM: torch.Tensor, wR: torch.Tensor,
                      cell_chunk: int = 65536
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the feqmod producer: ``dndx_plain``'s sums
    over ``feqmod.feqmod_block`` (the reduce=False block of
    _chunk_contribution_feqmod, is3d_tpu/kernels/dndx.py:110-124; its chunk
    holds 4 x the elements, the JAX package's factor for df 3-4)."""
    n = mom.nodes.shape[0] * mom.mass.shape[0] * mom.px.shape[0]
    return _reduce_plain(
        lambda c0, k: feqmod.feqmod_block(x[c0:c0 + k], rn[c0:c0 + k],
                                          wcs[c0:c0 + k], mom, flags),
        x.shape[0], mom, wM, wR, effective_chunk(cell_chunk, x.shape[0],
                                                 4 * n))


def dndx_vah_plain(x: torch.Tensor, mom: MomentumConstants,
                   flags: vah.VahFlags, wM: torch.Tensor, wR: torch.Tensor,
                   cell_chunk: int = 65536
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the VAH producer: ``dndx_plain``'s sums over
    ``vah.vah_block`` (the reduce=False block of _chunk_vah_spectra,
    is3d_tpu/kernels/dndx.py:102-109) at fixed nodes."""
    if flags.remap:
        raise ValueError("dndx_vah_plain evaluates at fixed rapidity nodes "
                         "(flags.remap must be False)")
    n = mom.nodes.shape[0] * mom.mass.shape[0] * mom.px.shape[0]
    return _reduce_plain(
        lambda c0, k: vah.vah_block(x[c0:c0 + k], mom, flags),
        x.shape[0], mom, wM, wR, effective_chunk(cell_chunk, x.shape[0], n))


def _reduce_plain(block_of, C: int, mom: MomentumConstants,
                  wM: torch.Tensor, wR: torch.Tensor, chunk: int):
    """per_cell and dydeta of the (c, R, S, P, F) blocks ``block_of(c0,
    chunk)`` of C cells, taken ``chunk`` cells at a time."""
    S, R = mom.mass.shape[0], mom.nodes.shape[0]
    per_cell, dydeta = [], None
    for c0 in range(0, C, chunk):
        block = block_of(c0, chunk)
        t = torch.einsum("crsm,m->crs", block.reshape(-1, R, S, wM.shape[0]),
                         wM)
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
                           vp, vp, ci,                 # species, deg, S
                           vp, vp, ci, ci,             # mt, points, n_pT, n_phi
                           vp, vp, ci,                 # nodes, wR, n_nodes
                           ci, ci, ci, ci,             # df, dim, reg, outflow
                           cd, ci,                     # prefactor, split
                           vp, vp, vp, vp]             # outputs, scratch, stream
        for fn in (lib.is3d_dndx_slots_f32, lib.is3d_dndx_slots_f64):
            fn.restype = ci
            fn.argtypes = [ci, ci, ci, ci]             # df, dim, n_pT, n_phi
        for fn in (lib.is3d_dndx_feqmod_f32, lib.is3d_dndx_feqmod_f64):
            fn.restype = ci
            fn.argtypes = [vp, ci, ci, vp, vp,         # cells, C, nq, rn, wcs
                           vp, vp, ci,                 # species, deg, S
                           vp, vp, ci, ci,             # mt, points, n_pT, n_phi
                           vp, vp, ci,                 # nodes, wR, n_nodes
                           ci, ci, ci, ci, ci,         # df, dim, sw, reg, out
                           cd, ci,                     # prefactor, split
                           vp, vp, vp, vp]             # outputs, scratch, stream
        for fn in (lib.is3d_dndx_feqmod_slots_f32,
                   lib.is3d_dndx_feqmod_slots_f64):
            fn.restype = ci
            fn.argtypes = [ci, ci, ci, ci]             # df, dim, n_pT, n_phi
        for fn in (lib.is3d_dndx_vah_f32, lib.is3d_dndx_vah_f64):
            fn.restype = ci
            fn.argtypes = [vp, ci, ci,                 # cells, C, nv
                           vp, vp, ci,                 # species, deg, S
                           vp, vp, ci, ci,             # mt, points, n_pT, n_phi
                           vp, vp, ci,                 # nodes, wR, n_nodes
                           ci, ci, ci, ci,             # dim, sw, reg, outflow
                           cd, ci,                     # prefactor, split
                           vp, vp, vp, vp]             # outputs, scratch, stream
        for fn in (lib.is3d_dndx_vah_slots_f32, lib.is3d_dndx_vah_slots_f64):
            fn.restype = ci
            fn.argtypes = [ci, ci, ci, ci]             # dim, sw, n_pT, n_phi
        for fn in (lib.is3d_dndx_probe_slots_f32,
                   lib.is3d_dndx_probe_slots_f64):
            fn.restype = ci
            fn.argtypes = []
        for fn in (lib.is3d_dndx_probe_f32, lib.is3d_dndx_probe_f64):
            fn.restype = ci
            fn.argtypes = [vp, ci, ci,                 # a, n_cells, n_nodes
                           vp, vp, ci, ci,             # b, w, n_species, M
                           vp, vp, ci,                 # wM, wR, split
                           vp, vp, vp, vp]             # outputs, scratch, stream
        for fn in (lib.is3d_dndx_bin_f32, lib.is3d_dndx_bin_f64):
            fn.restype = ci
            fn.argtypes = [vp, ci,                     # per_cell, S
                           vp, vp, ci,                 # cell, key, E
                           vp, ci,                     # start, n_bins
                           vp, ctypes.c_longlong,      # pieces, their rows
                           vp, vp]                     # hist, stream
        lib.is3d_cuda_error_string.restype = ctypes.c_char_p
        lib.is3d_cuda_error_string.argtypes = [ci]
        lib._is3d_bound = True
    return lib


def emission_tables(mom: MomentumConstants,
                    wM: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """The kernel's momentum-side inputs, each row one 16-byte-aligned
    load: species (S, 4) = m^2, sign, baryon, 0; mt (S, P, 2) = mT, mT^2
    with mT = sqrt(m^2 + pT^2); points (M, 8) = px, py, px^2, py^2, px py,
    wM, 0, 0 (M = P * n_phi, m = p * n_phi + f)."""
    m2 = mom.mass ** 2
    z = torch.zeros_like(m2)
    species = torch.stack([m2, mom.sign, mom.baryon, z], dim=1)
    mT2 = m2[:, None] + mom.pT[None, :] ** 2
    mt = torch.stack([torch.sqrt(mT2), mT2], dim=2)
    zp = torch.zeros_like(mom.px)
    points = torch.stack([mom.px, mom.py, mom.px ** 2, mom.py ** 2,
                          mom.px * mom.py, wM, zp, zp], dim=1)
    return species.contiguous(), mt.contiguous(), points.contiguous()


def cells_per_batch(n_nodes: int) -> int:
    """Cells a block of the per-cell kernel takes at once: its threads are
    (cell, group of _YC nodes) pairs."""
    groups = -(-n_nodes // _YC)
    if not 1 <= groups <= _BLOCK:
        raise ValueError(f"the dN/dX kernel takes 1 to {_BLOCK * _YC} "
                         f"rapidity nodes, got {n_nodes}")
    return _BLOCK // groups


def cell_split(n_cells: int, n_species: int, n_nodes: int,
               slots: int) -> tuple[int, int]:
    """(cells per split, splits) of the per-cell kernel's grid (species
    groups of _J, splits) on a card that holds ``slots`` of its blocks at
    once: whole batches per split, the fewest splits that fill the card's
    waves (launch.split_to_fill)."""
    batch = cells_per_batch(n_nodes)
    n_batches = -(-max(n_cells, 1) // batch)
    per, n_split = split_to_fill(n_batches, -(-max(n_species, 1) // _J),
                                 slots, _MAX_SPLIT)
    return per * batch, n_split


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
    cells_per_batch(R)
    require_cuda("dndx_cuda", cells)
    C = cells.shape[0]
    lib = _library()
    f64 = cells.dtype == torch.float64
    slots = resident_blocks(
        lib, "dndx",
        lib.is3d_dndx_slots_f64 if f64 else lib.is3d_dndx_slots_f32,
        cells.device, flags.df_mode, flags.dimension, P, F)
    per, n_split = cell_split(C, S, R, slots)
    species, mt, points = emission_tables(mom, wM)
    per_cell = cells.new_empty((C, S))
    dydeta = cells.new_empty((S, R))
    partial = cells.new_empty((n_split, S, R))
    launch(lib, "dndx", lib.is3d_dndx_f64 if f64 else lib.is3d_dndx_f32,
           cells.device, cells.data_ptr(), C, NF,
           species.data_ptr(), mom.degeneracy.data_ptr(), S,
           mt.data_ptr(), points.data_ptr(), P, F,
           mom.nodes.data_ptr(), wR.data_ptr(), R,
           flags.df_mode, flags.dimension, int(flags.regulate),
           int(flags.outflow), CF_PREFACTOR, per, per_cell.data_ptr(),
           dydeta.data_ptr(), partial.data_ptr())
    LAUNCHES += 1
    return per_cell, dydeta


def dndx_feqmod_cuda(x: torch.Tensor, rn: torch.Tensor, wcs: torch.Tensor,
                     mom: MomentumConstants, flags: feqmod.FeqmodFlags,
                     wM: torch.Tensor, wR: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/dndx.cu's per-cell kernel with the feqmod producer on
    the current stream: (per_cell (C, S), dydeta (S, R)) in the cells'
    dtype."""
    global FEQMOD_LAUNCHES
    check_float("dndx_feqmod_cuda", x)
    if flags.remap:
        raise ValueError("dndx_feqmod_cuda evaluates at fixed rapidity "
                         "nodes (flags.remap must be False)")
    C = x.shape[0]
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    R = mom.nodes.shape[0]
    check_tensor("cells", x, (C, feqmod.NQ), x)
    check_tensor("rn", rn, (C, S), x)
    check_tensor("wcs", wcs, (C, S), x)
    for name, n in dict(mass=S, sign=S, baryon=S, degeneracy=S, pT=P,
                        px=P * F, py=P * F, nodes=R).items():
        check_tensor(f"momentum constant {name}", getattr(mom, name), (n,),
                     x)
    check_tensor("wM", wM, (P * F,), x)
    check_tensor("wR", wR, (R,), x)
    cells_per_batch(R)
    require_cuda("dndx_feqmod_cuda", x)
    lib = _library()
    f64 = x.dtype == torch.float64
    slots = resident_blocks(
        lib, "dndx feqmod",
        lib.is3d_dndx_feqmod_slots_f64 if f64
        else lib.is3d_dndx_feqmod_slots_f32,
        x.device, flags.df_mode, flags.dimension, P, F)
    per, n_split = cell_split(C, S, R, slots)
    species, mt, points = emission_tables(mom, wM)
    per_cell = x.new_empty((C, S))
    dydeta = x.new_empty((S, R))
    partial = x.new_empty((n_split, S, R))
    launch(lib, "dndx feqmod",
           lib.is3d_dndx_feqmod_f64 if f64 else lib.is3d_dndx_feqmod_f32,
           x.device, x.data_ptr(), C, feqmod.NQ, rn.data_ptr(),
           wcs.data_ptr(), species.data_ptr(), mom.degeneracy.data_ptr(), S,
           mt.data_ptr(), points.data_ptr(), P, F, mom.nodes.data_ptr(),
           wR.data_ptr(), R, flags.df_mode, flags.dimension, flags.switches,
           int(flags.regulate), int(flags.outflow), CF_PREFACTOR, per,
           per_cell.data_ptr(), dydeta.data_ptr(), partial.data_ptr())
    FEQMOD_LAUNCHES += 1
    return per_cell, dydeta


def dndx_vah_cuda(x: torch.Tensor, mom: MomentumConstants,
                  flags: vah.VahFlags, wM: torch.Tensor, wR: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/dndx.cu's per-cell kernel with the VAH producer on the
    current stream: (per_cell (C, S), dydeta (S, R)) in the cells'
    dtype."""
    global VAH_LAUNCHES
    check_float("dndx_vah_cuda", x)
    if flags.remap:
        raise ValueError("dndx_vah_cuda evaluates at fixed rapidity nodes "
                         "(flags.remap must be False)")
    C = x.shape[0]
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    R = mom.nodes.shape[0]
    check_tensor("cells", x, (C, vah.NV), x)
    for name, n in dict(mass=S, sign=S, baryon=S, degeneracy=S, pT=P,
                        px=P * F, py=P * F, nodes=R).items():
        check_tensor(f"momentum constant {name}", getattr(mom, name), (n,),
                     x)
    check_tensor("wM", wM, (P * F,), x)
    check_tensor("wR", wR, (R,), x)
    cells_per_batch(R)
    require_cuda("dndx_vah_cuda", x)
    lib = _library()
    f64 = x.dtype == torch.float64
    slots = resident_blocks(
        lib, "dndx vah",
        lib.is3d_dndx_vah_slots_f64 if f64 else lib.is3d_dndx_vah_slots_f32,
        x.device, flags.dimension, flags.switches, P, F)
    per, n_split = cell_split(C, S, R, slots)
    species, mt, points = emission_tables(mom, wM)
    per_cell = x.new_empty((C, S))
    dydeta = x.new_empty((S, R))
    partial = x.new_empty((n_split, S, R))
    launch(lib, "dndx vah",
           lib.is3d_dndx_vah_f64 if f64 else lib.is3d_dndx_vah_f32,
           x.device, x.data_ptr(), C, vah.NV, species.data_ptr(),
           mom.degeneracy.data_ptr(), S, mt.data_ptr(), points.data_ptr(), P,
           F, mom.nodes.data_ptr(), wR.data_ptr(), R, flags.dimension,
           flags.switches, int(flags.regulate), int(flags.outflow),
           CF_PREFACTOR, per, per_cell.data_ptr(), dydeta.data_ptr(),
           partial.data_ptr())
    VAH_LAUNCHES += 1
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
    """Launch csrc/dndx.cu's segment sum (slice_kernel, then bin_kernel):
    hist (S, n_bins), each bin summed in a fixed order (no atomics)."""
    global BIN_LAUNCHES
    check_float("dndx_bin_cuda", per_cell)
    if per_cell.dim() != 2:
        raise ValueError(f"per_cell must be (C, S), got "
                         f"{tuple(per_cell.shape)}")
    check_tensor("per_cell", per_cell, tuple(per_cell.shape), per_cell)
    check_tensor("plan.start", plan.start, (plan.n_bins + 1,), per_cell,
                 torch.int32)
    E = plan.key.shape[0]
    check_tensor("plan.cell", plan.cell, (E,), per_cell, torch.int32)
    check_tensor("plan.key", plan.key, (E,), per_cell, torch.int64)
    require_cuda("dndx_bin_cuda", per_cell)
    S = per_cell.shape[1]
    hist = per_cell.new_empty((S, plan.n_bins))
    # per-run sums: each slice's first run, then each bin's (csrc/dndx.cu)
    n_rows = -(-E // _SLICE) + plan.n_bins
    pieces = per_cell.new_empty((n_rows, S))
    lib = _library()
    fn = (lib.is3d_dndx_bin_f32 if per_cell.dtype == torch.float32
          else lib.is3d_dndx_bin_f64)
    launch(lib, "dndx_bin", fn, per_cell.device, per_cell.data_ptr(), S,
           plan.cell.data_ptr(), plan.key.data_ptr(), E,
           plan.start.data_ptr(), plan.n_bins, pieces.data_ptr(), n_rows,
           hist.data_ptr())
    BIN_LAUNCHES += 1
    return hist


# ------------------------------------------------------------ entry point

def _group_per_cell(cols: dict, mom: MomentumConstants, flags, wM, wR,
                    df_data: DeltafData, species: SpeciesArrays | None,
                    laguerre: dict | None, cfg: Config):
    """(per_cell, dydeta) of one group: the linear df kernel, with
    ``laguerre`` (df 3-4) the feqmod producer, with VAH flags (modes 2-3)
    the VAH producer."""
    dev = cols["tau"].device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no dN/dX path for device {dev}")
    if isinstance(flags, vah.VahFlags):
        x = vah.group_inputs(cols, flags)
        if dev.type == "cuda":
            return dndx_vah_cuda(x, mom, flags, wM, wR)
        return dndx_vah_plain(x, mom, flags, wM, wR, cfg.cell_chunk)
    if laguerre is not None:
        x, rn, wcs = feqmod.group_inputs(cols, species, laguerre, df_data,
                                         cfg, flags)
        if dev.type == "cuda":
            return dndx_feqmod_cuda(x, rn, wcs, mom, flags, wM, wR)
        return dndx_feqmod_plain(x, rn, wcs, mom, flags, wM, wR,
                                 cfg.cell_chunk)
    cells = pack_cells(prepare_cells(cols, cfg, df_data), cfg)
    if dev.type == "cuda":
        return dndx_cuda(cells, mom, flags, wM, wR)
    return dndx_plain(cells, mom, flags, wM, wR, cfg.cell_chunk)


def _group_dndx(cols: dict, mom: MomentumConstants, flags, wM: torch.Tensor,
                wR: torch.Tensor, df_data: DeltafData,
                species: SpeciesArrays | None, laguerre: dict | None,
                cfg: Config) -> dict:
    """The accumulators of one group: the (tau, r) histograms, dN/dy and
    dN/dy/deta."""
    plan = bin_plan(cols["tau"], cols["x"], cols["y"], cfg)
    per_cell, dydeta = _group_per_cell(cols, mom, flags, wM, wR, df_data,
                                       species, laguerre, cfg)
    if per_cell.device.type == "cuda":
        hist = dndx_bin_cuda(per_cell, plan)
    else:
        hist = dndx_bin_plain(per_cell, plan)
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


def dndx_reduction(cols: dict, species: SpeciesArrays, grid: MomentumGrid,
                   df_data: DeltafData, cfg: Config,
                   laguerre: dict | None = None) -> tuple:
    """(kernel_fn, replicated, grid) of the dN/dX cell reduction over
    ``cols`` (the whole surface's or a rank's slice) under ``cfg``, VAH
    surfaces already gated (vah.effective_vah_cfg); ``grid`` with fixed
    eta nodes, as dndx_finalize takes it."""
    # dN/dX keeps fixed eta nodes: dN/dy/deta is reported AT the common
    # node positions, which a per-species mT remap would scramble
    grid = dataclasses.replace(grid, eta_mT_rescale=False)
    if cfg.mode in (2, 3):
        flags = vah.vah_flags(cfg, grid)
        laguerre = None
    elif cfg.df_mode in (3, 4):
        flags = feqmod.feqmod_flags(cfg, grid)
        laguerre = laguerre_in_precision(laguerre, cols["tau"].dtype,
                                         cols["tau"].device)
    else:
        flags = spectra_flags(cfg, grid)
        laguerre = None
    mom = momentum_constants(species, grid, cfg.dimension)
    wM = momentum_weights(grid, cfg)
    wR = node_weights(grid, cfg.dimension)
    return ((lambda c, m, fl, wm, wr, d, sp, lag: _group_dndx(
        c, m, fl, wm, wr, d, sp, lag, cfg)),
        (mom, flags, wM, wR, df_data, species, laguerre), grid)


def spacetime_distributions(surface, species: SpeciesArrays,
                            grid: MomentumGrid, df_data: DeltafData,
                            cfg: Config, laguerre: dict | None = None,
                            mesh=None) -> dict:
    """All dN/dX distributions: a dict of host numpy arrays with bin
    midpoints and normalized distributions.  The cell reduction runs
    through the canonical group tree: one launch of each kernel per group,
    accumulators folded in group order (with ``mesh``, each rank launches
    its own groups and every rank folds all of them).  Viscous hydro
    takes df 1-4; df 3-4 take the Gauss-Laguerre table (default:
    feqmod's) in the surface's precision, replicated to every group like
    df_data.  Anisotropic hydro (modes 2-3) takes the VAH emission,
    whatever df_mode, its residual chains gated as the spectra's
    (vah.effective_vah_cfg)."""
    from ..parallel.mesh import grouped_cell_reduce
    if cfg.df_mode not in (1, 2, 3, 4):
        raise ValueError("spacetime_distributions handles df 1-4")
    cols = dndx_cols(surface, cfg)
    if cfg.mode in (2, 3):
        cfg = vah.effective_vah_cfg(cols, cfg)
    fn, replicated, grid = dndx_reduction(cols, species, grid, df_data, cfg,
                                          laguerre)
    acc = grouped_cell_reduce(fn, cols, replicated, cfg, mesh=mesh)
    return dndx_finalize(acc, grid, cfg)
