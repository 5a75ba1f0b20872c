"""Time the hand-written kernels of two (or more) checkouts of this
repository in one process tree on one card, in the order A, B, B, A (A, B,
C, C, B, A).

    python -m is3d_tpu_torch.tools.ab_spectra ROOT_A ROOT_B [ROOT_C ...]
        [--cells N]
        [--cases 3d_df2,3d_df1,2d_fixed,2d_remap,bin,dndx,proto,decays,
                 yields,alias,sample,cascade,grad_feqmod_3d,
                 grad_feqmod_2d,grad_vah_3d,grad_vah_2d,grad_polzn_3d,
                 grad_polzn_2d,grad_polzn_2d_fixed,grad_main_3d,
                 grad_main_2d,grad_decays,polzn_3d,polzn_2d,feqmod_3d,
                 feqmod_3d_most,feqmod_2d,feqmod_2d_most,feqmod_dndx]

Each turn runs a fresh interpreter that imports ``is3d_tpu_torch`` from
that root (building its kernels into that root's _build/) and, per case:

* ``3d_df2`` (the operation-1 main path), ``3d_df1``, ``2d_fixed``,
  ``2d_remap``: ``smooth_spectra_cuda`` on one group of N synthetic cells
  (seed 0; 3+1D or 2+1D), 320 species, the native grid (32 x 24, 21 y or
  48 eta nodes, without or with the mT remap), df 2 (1 for ``3d_df1``)
  with shear + bulk, regulate, outflow, float32: one launch to warm up,
  then 5 launches timed with CUDA events;
* ``bin``: ``dndx_bin_cuda`` on one group of the operation-0 main path's
  shape -- the bin plan of 8192 synthetic 2+1D cells (seed 2) on the
  default 120 x 60 (tau, r) bins and a (8192, 320) per-cell table drawn
  with numpy (seed 5) -- one warm-up, then 5 runs of 20 calls queued
  behind a device-side sleep, so the events time the device and not the
  host's enqueue;
* ``dndx``: ``dndx_cuda`` on one group of the operation-0 main path's
  shape -- 8192 synthetic 2+1D cells (seed 2), 320 species, the native
  32 x 24 grid with 48 fixed eta nodes, df 1 with shear + bulk, regulate,
  outflow, float32 -- timed as the spectra cases; the sum and the
  float64 difference are those of the per-cell output;
* ``proto``: ``proto_spectra_cuda`` at the prototype's own shape (32768
  cells x 320 x 768 x 21, float32, ``proto_inputs`` seed 0), timed as the
  spectra cases; the float64 difference on its first 2048 cells;
* ``decays``: ``decay_wave_cuda`` on every launch of the feed-down
  cascade of the decaying synthetic list (320 species, seed 0) on thermal
  spectra (``testing.thermal_spectra``), the native 32 x 24 grid with 21
  y in 3+1D and in 2+1D, in float32 and float64, each launch added to the
  running spectra before the next wave; timed as the spectra cases, one
  entry a (dimension, dtype, wave, body) (``decays_w0_3body`` the 3+1D
  float32 ones, ``decays_2d_float64_w0_3body`` the others); the float32
  entries' difference from the float64 kernel on the same launch;
* ``yields``, phase A's (cell, species) densities on the surface of
  ``alias`` and ``sample`` below (131072 x 320 x 32 nodes, df 2,
  float32): that side's ``species_yields`` (K7b, csrc/yields.cu), or on a
  side before K7b its torch quadrature (``_species_yields_exact``), timed
  as ``alias``; its sum is that of the densities;
* ``alias`` and ``sample``, the sampler on the surface of chip_smoke.py's
  [sample main 2d] run (``testing.write_synthetic_run_dir``: 131072 2+1D
  cells, 320 species, seed 0; df 2 with shear + bulk, float32, oversampled
  to 1.5e6 hadrons, sampler_seed 17), written once into a temporary
  directory: ``alias`` times the species table's alias phase through that
  side's ``alias_build`` on its (131072, 320) weights (torch's scaling and
  stable sort and K7a before the sort moved into K7a; the scaling and K7a
  after); ``sample``
  times one batch of the main path's shape (its events per batch, slot
  and packed capacities, seed 17, events 0..B-1) through that side's
  dispatch path: K7's packed mode (``event_batch_packed``) where the side
  has it, else the per-slot kernel and ``pack_batch``; its sum is that of
  the kept hadrons' px.  Both time 5 calls queued behind a device-side
  sleep, as ``bin`` does: the device's time, not the host's enqueue;
* ``cascade``, K8 on chip_smoke.py's [cascade pair] shape: the unstable
  hadrons of the [sample decays] run's 2 events (the decaying list of
  that surface, sampler_seed 17, min_num_hadrons 6e5), float32, pass by
  pass on the state each pass starts from (advanced by that side's
  kernel): ``cascade_p<k>`` the pass's device time (5 calls queued behind
  a device-side sleep, each after a copy of the state's live slots back,
  less the copies alone; a side whose pass is a decide launch, a torch
  cumsum and a write launch around a host read has the three queued
  without the read), ``cascade_device`` every pass so, ``cascade_call``
  one ``run_cascade`` call under CUDA events (the host's enqueue and
  reads included, median of 5); the sums are those of the state's px
  after the pass;
* ``grad_feqmod_3d``, ``grad_feqmod_2d``, ``grad_vah_3d``, ``grad_vah_2d``:
  the backward kernels K10 (``feqmod_bwd_cuda``: 3+1D df 3, 2+1D df 4
  with the mT remap) and K11 (``vah_bwd_cuda``: 3+1D with the chains gated
  off, ``grad_vah_3d_chains`` with synthetic c0..c4 on every cell, and
  2+1D with the remap, gated) on one group of N synthetic cells
  (``synthetic_surface`` / ``synthetic_vah_cells``, seed 0), 320 species,
  the native grid, shear + bulk, regulate, outflow, float32 and the
  positive cotangent ``testing.grad_cotangent``: timed as the spectra
  cases; the float64 difference on its first 512 cells; beside it the
  share of breakdown cells and (a side with ``bwd_kernel_name``) the cells
  of each chain's instantiation, and for each instantiation its threads,
  shared memory, resident blocks and warps an SM, registers and local
  bytes (the side's ``bwd_props``, or ``tools/occupancy.py`` at the first
  version's launch shape) and SASS per evaluation; a side without the
  kernel reports the case ``"absent"``;
* ``polzn_3d``, ``polzn_2d``: the polarization kernel K6 (``polzn_cuda``:
  3+1D fixed nodes, 2+1D with the mT remap) on that synthetic mode-5
  group, its five sums stacked: timed as the spectra cases, the float64
  difference on its first 512 cells;
* ``grad_polzn_3d``, ``grad_polzn_2d``, ``grad_polzn_2d_fixed``: the
  polarization's backward kernels K12a (``polzn_bwd_cuda``, 3+1D fixed
  nodes; ``_fixed`` 2+1D fixed nodes) and K12b (2+1D with the mT remap,
  48 nodes) on one group of N synthetic mode-5 cells
  (``synthetic_surface_cells`` and ``synthetic_vorticity``, seed 0), 320
  species, the native grid, float32, T_avg ``testing.POLZN_T_AVG`` and a
  positive cotangent on the five sums: timed, the float64 difference and
  the resources as the grad cases (with the side's plan -- species and pT
  rows a stage, angles, stage row, waves -- where it has ``BWD_PLAN``);
* ``feqmod_3d``, ``feqmod_3d_most``, ``feqmod_2d``, ``feqmod_2d_most``:
  the df 3-4 forward kernel K3 (``feqmod_spectra_cuda``: 3+1D df 3 at
  fixed nodes; 2+1D df 4 with the mT remap, 48 nodes) on the first N
  cells of chip_smoke.py's [feqmod main] / [feqmod main 2d] surface
  (``testing.write_synthetic_run_dir``, 131072 cells x 320 species, seed
  0, read as the CLI reads it), df with shear + bulk, regulate, outflow,
  float32, as it is and (``_most``) with the shear stress x 30, as
  chip_smoke.py's [feqmod pair]: timed as the spectra cases; the float64
  difference on its first 512 cells; the share of cells that break down
  and of evaluations that take the fallback, and each instantiation's
  cells, threads, resident blocks and warps an SM, registers, local bytes
  and SASS per evaluation (a side with ``chain_kernel_name``: one a
  chain; else the first version's one body through
  ``tools/occupancy.py``);
* ``feqmod_dndx``: K3's dN/dX producer (``dndx_feqmod_cuda``, csrc/dndx.cu,
  which shares csrc/feqmod.cuh) on the first canonical group (2048 cells)
  of chip_smoke.py's [feqmod dndx] surface (16384 2+1D cells x 320
  species, operation 0, df 3, 48 fixed eta nodes, float32): timed as the
  spectra cases, the float64 difference on the whole group;
* ``grad_main_3d``, ``grad_main_2d``: the linear-df backward kernels
  (``spectra_bwd_cuda``) K9a (3+1D, fixed nodes) and K9b (2+1D with the mT
  remap, 48 nodes) on one group of N synthetic cells as the spectra cases
  (df 2 with shear + bulk, regulate, outflow, float32, 320 species, the
  positive cotangent): timed as the spectra cases; the float64
  difference on its first 512 cells; each instantiation's resources and
  SASS per evaluation as the grad cases (K9a's plan -- cells a block,
  species a stage, waves -- where the side has ``FIXED_BWD_PLAN``, else
  its first version's launch shape; K9b's first version at its launch
  shape where the side has no ``bwd_props``);
* ``grad_decays``: the backward wave kernel K9c (``wave_bwd_cuda``) on
  every launch of the ``decays`` case's cascade (3+1D, float32, the
  positive cotangent), each launch's feed-down added to the running
  spectra before the next wave: timed as the spectra cases, one entry a
  (wave, body) (``grad_decays_w0_3body``); the float64 difference of the
  launch's first task; the route and, where the side measures it
  (``wave_bwd_bits``), the bits the scale's bound gives up; the kernel's
  SASS per evaluation with its atomics.

The report is one JSON line per turn (median, runs, output sum and the
float32 output's largest difference from the same side's float64 kernel,
as a share of its largest value, per case) and, per case and for every
root after the first, the medians of A and of that root, their ratio B / A,
the relative difference of the output sums and both sides'
float32-vs-float64 differences.  Uses only functions both
sides have had since their kernels were first ported.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CASES = ("3d_df2", "3d_df1", "2d_fixed", "2d_remap", "bin", "dndx", "proto",
         "decays", "yields", "alias", "sample", "cascade", "grad_feqmod_3d",
         "grad_feqmod_2d", "grad_vah_3d", "grad_vah_2d", "grad_polzn_3d",
         "grad_polzn_2d", "grad_polzn_2d_fixed", "grad_main_3d",
         "grad_main_2d", "grad_decays",
         "polzn_3d", "polzn_2d", "feqmod_3d", "feqmod_3d_most",
         "feqmod_2d", "feqmod_2d_most", "feqmod_dndx")

_TURN = r"""
import json, statistics, sys
sys.path.insert(0, sys.argv[1])
OCCUPANCY_TOOL = sys.argv[4]
import numpy as np
import torch
from is3d_tpu_torch import testing
from is3d_tpu_torch.config import Config
from is3d_tpu_torch.io.tables import native_momentum_grid
from is3d_tpu_torch.kernels import smooth, dndx, decays
from is3d_tpu_torch.kernels.common import surface_columns, prepare_cells
from is3d_tpu_torch.experiments import smooth_proto
assert smooth.__file__.startswith(sys.argv[1]), smooth.__file__
dev, dt = torch.device("cuda"), torch.float32
n_cells, cases = int(sys.argv[2]), sys.argv[3].split(",")
SPECTRA = {"3d_df2": (3, 2, False), "3d_df1": (3, 1, False),
           "2d_fixed": (2, 2, False), "2d_remap": (2, 2, True)}


def timed(fn, inner=1):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if inner > 1:
            torch.cuda._sleep(20_000_000)
        a.record()
        for _ in range(inner):
            out = fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times), times, float(out.double().sum())


# the [sample main 2d] surface's config, species and cell data
def sampler_surface():
    import tempfile
    from is3d_tpu_torch.api import IS3D
    from is3d_tpu_torch.kernels import sample
    run_dir = tempfile.mkdtemp()
    testing.write_synthetic_run_dir(run_dir, 131072, 320, dimension=2,
                                    seed=0)
    cfg = Config(operation=2, mode=1, dimension=2, df_mode=2,
                 precision="f32", include_shear_deltaf=1,
                 include_bulk_deltaf=1, regulate_deltaf=1, outflow=1,
                 oversample=1, min_num_hadrons=1500000, sampler_seed=17)
    run = IS3D(cfg, data_dir=run_dir, device="cuda")
    _, df_data, species, _, _ = run._prepare()
    cell = sample.build_cell_data(run.surface, species, df_data, cfg,
                                  run.plasma())
    return cfg, sample._cast_floats(species, dt), cell, run, df_data


# K8 on the [cascade pair] shape: pass by pass and the whole cascade
def cascade_cases(report):
    import tempfile
    from is3d_tpu_torch.api import IS3D
    from is3d_tpu_torch.kernels import mc_decays, sample
    from is3d_tpu_torch.kernels.launch import launch
    run_dir = tempfile.mkdtemp()
    testing.write_synthetic_run_dir(run_dir, 131072, 320, dimension=2,
                                    seed=0, decays=True)
    cfg = Config(operation=2, mode=1, dimension=2, df_mode=2,
                 precision="f32", include_shear_deltaf=1,
                 include_bulk_deltaf=1, regulate_deltaf=1, outflow=1,
                 oversample=1, min_num_hadrons=600000, sampler_seed=17,
                 do_resonance_decays=1)
    run = IS3D(cfg, data_dir=run_dir, device="cuda")
    table, df_data, species, mcids, _ = run._prepare()
    events = sample.sample_particles(run.surface, species, mcids, df_data,
                                     cfg, run.plasma(), nevents=2, seed=17)
    inp = mc_decays.cascade_inputs(events, table, cfg.lightest_particle,
                                   mc_decays.derive_decay_seed(17),
                                   device="cuda")
    st, n0, tabs = inp["state"], inp["n0"], inp["dev_tabs"]
    key, n_passes = inp["key"], inp["tabs"].n_passes
    C = st["E"].shape[0]
    first = {k: v.clone() for k, v in st.items()}
    work = {k: v.clone() for k, v in st.items()}
    zero = torch.zeros(1, device=dev)
    lib = mc_decays._library()
    parent = hasattr(lib, "is3d_cascade_decide_f32")
    if parent:      # decide, cumsum, write around a host read
        extra, chan = (torch.empty(C, dtype=torch.int32, device=dev)
                       for _ in range(2))
        tab_ptrs = (*(tabs[k].data_ptr() for k in (
            "mass", "ctau", "stable", "cum", "nd", "d1", "d2", "d3",
            "quant")), *tabs["cum"].shape)

        def reset(n):
            pass

        def device_pass(n):
            launch(lib, "decide", lib.is3d_cascade_decide_f32, dev,
                   work["sidx"].data_ptr(), work["lin"].data_ptr(), n,
                   *tab_ptrs, *key, extra.data_ptr(), chan.data_ptr())
            offs = torch.cumsum(extra[:n], 0, dtype=torch.int32)
            launch(lib, "write", lib.is3d_cascade_write_f32, dev,
                   work["sidx"].data_ptr(), work["lin"].data_ptr(),
                   work["eid"].data_ptr(),
                   *(work[k].data_ptr() for k in mc_decays.STATE_FLOATS),
                   n, C, *tab_ptrs, *key, extra.data_ptr(), chan.data_ptr(),
                   offs.data_ptr())
        scratch = dict(extra=extra, ch=chan)
        advance = lambda s, n: mc_decays.cascade_pass_cuda(s, n, tabs, key,
                                                           scratch)
    else:           # one launch a pass, the count on the card
        counts, scratch = mc_decays.cascade_buffers(C, 1, n0, dev)
        go = mc_decays.pass_launcher(work, tabs, key, counts, scratch)

        def reset(n):
            counts.fill_(n)
            scratch.zero_()

        def device_pass(n):
            go(0, n)
        advance = lambda s, n: mc_decays.cascade_pass_cuda(s, n, tabs, key)

    def restored(snap, n):      # the state's live slots and the counts
        dst, src = [work[k][:n] for k in snap], [snap[k][:n] for k in snap]
        return lambda: (torch._foreach_copy_(dst, src), reset(n))

    def device_ms(fn, restore):
        both = timed(lambda: (restore(), fn(), zero)[2], inner=5)[1]
        alone = timed(lambda: (restore(), zero)[1], inner=5)[1]
        runs = [b - a for b, a in zip(both, alone)]
        return statistics.median(runs), runs

    n, sizes = n0, [n0]
    for p in range(n_passes):
        snap = {k: v.clone() for k, v in st.items()}
        ms, runs = device_ms(lambda: device_pass(n), restored(snap, n))
        n = advance(st, n)
        sizes.append(n)
        report[f"cascade_p{p}"] = {"ms": ms, "runs": runs, "err_f64": None,
                                   "sum": float(st["px"][:n].double().sum())}
    if parent:
        whole = lambda: [device_pass(m) for m in sizes[:-1]]
    else:
        whole = lambda: mc_decays.launch_cascade(work, n0, tabs, key,
                                                 n_passes)
    ms, runs = device_ms(whole, restored(first, n0))
    report["cascade_device"] = {"ms": ms, "runs": runs, "err_f64": None,
                                "sum": float(st["px"][:n].double().sum())}
    calls = []
    for _ in range(6):
        s = {k: v.clone() for k, v in first.items()}
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        nf = mc_decays.run_cascade(s, n0, tabs, key, n_passes)
        b.record()
        b.synchronize()
        calls.append(a.elapsed_time(b))
    assert nf == n, (nf, n)
    report["cascade_call"] = {"ms": statistics.median(calls[1:]),
                              "runs": calls[1:], "err_f64": None,
                              "sum": float(s["px"][:n].double().sum())}


# the backward kernels K10 (df 3-4), K11 (VAH) and K12 (polarization) on
# one synthetic group
GRAD = {"grad_feqmod_3d": ("feqmod", 3), "grad_feqmod_2d": ("feqmod", 2),
        "grad_vah_3d": ("vah", 3), "grad_vah_2d": ("vah", 2),
        "grad_polzn_3d": ("polzn", 3), "grad_polzn_2d": ("polzn", 2),
        "grad_polzn_2d_fixed": ("polzn", 2)}


# an instantiation's registers, local bytes, resident blocks an SM (the
# side's own query props(), or on a side without one tools/occupancy.py at
# the launch shape fallback() gives) and SASS per evaluation
# (tools/sass_count.py)
def bwd_resources(lib_name, kernel, props, fallback):
    import importlib.util
    from is3d_tpu_torch.native import build
    from is3d_tpu_torch.tools import sass_count
    lib = build._cuda_paths(lib_name)[1]
    if props is not None:
        res = dict(props())
    else:
        spec = importlib.util.spec_from_file_location("occupancy",
                                                      OCCUPANCY_TOOL)
        occ = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(occ)
        threads, smem = fallback()
        res = dict(threads=threads, smem_bytes=smem, **(occ.occupancy(
            lib, kernel, threads, smem) or {"blocks_per_sm": None}))
    res["warps_per_sm"] = (None if res.get("blocks_per_sm") is None else
                           res["blocks_per_sm"] * (res["threads"] // 32))
    res["sass"] = sass_count.per_eval(lib, kernel)
    return res


# the threads and shared memory of a backward kernel that stages G a row
# at a time (the kernels' first version): float64 accumulators, NQ or NV
# columns of the block's threads, the cells' rows, G's row and px, py
def first_version_shape(R, F, n_cols, fixed3):
    CT = 128 // R
    nt = (CT * R + 31) // 32 * 32
    extra = nt * 8 if n_cols == 54 else 0        # K10's grad_rn shares
    return nt, n_cols * nt * 8 + extra + (CT * n_cols + F * (
        R if fixed3 else 1) + 2 * F) * 4


def grad_case(case, report):
    from is3d_tpu_torch.io.surface import surface_from_arrays
    from is3d_tpu_torch.io.tables import laguerre_device
    from is3d_tpu_torch.kernels import feqmod, polzn, vah
    kind, dim = GRAD[case]
    mod = dict(feqmod=feqmod, vah=vah, polzn=polzn)[kind]
    if not hasattr(mod, f"{kind}_bwd_cuda"):
        report[case] = "absent"
        return
    f64 = torch.float64
    remap = dim == 2 and not case.endswith("_fixed")
    grid = native_momentum_grid(dim, eta_mT_rescale=remap, dtype=dt,
                                device=dev)
    species = testing.synthetic_species(320, dtype=dt, device=dev)
    mom = smooth.momentum_constants(species, grid, dim)
    mom64 = mom.to(dtype=f64)
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    R = mom.nodes.shape[0]
    G = testing.grad_cotangent((S, P, F, R if dim == 3 else 1), dtype=dt,
                               device=dev)
    cut = 512
    base = dict(operation=1, dimension=dim, precision="f32",
                include_shear_deltaf=1, include_bulk_deltaf=1,
                regulate_deltaf=1, outflow=1)
    if kind == "feqmod":
        df = 3 if dim == 3 else 4
        cfg = Config(mode=1, df_mode=df, **base)
        surf = testing.synthetic_surface(n_cells, dim, seed=0, dtype=dt,
                                         device=dev)
        flags = feqmod.feqmod_flags(cfg, grid)
        x, rn, wcs = feqmod.group_inputs(
            surface_columns(surf, cfg), species,
            laguerre_device(dtype=dt, device=dev),
            testing.synthetic_deltaf_data(dtype=dt, device=dev), cfg, flags)
        go = lambda: feqmod.feqmod_bwd_cuda(x, rn, wcs, G, mom, flags)[0]
        small = [t[:cut].contiguous() for t in (x, rn, wcs)]
        out = feqmod.feqmod_bwd_cuda(*small, G, mom, flags)[0].double()
        ref = feqmod.feqmod_bwd_cuda(*(t.double() for t in small),
                                     G.double(), mom64, flags)[0]
        ms, runs, total = timed(go)
        entry = {"ms": ms, "runs": runs, "sum": total, "err_f64": float(
            (out - ref).abs().max() / ref.abs().max()),
            "broken_down": float((x[:, feqmod.FQ["bd"]] != 0).double()
                                 .mean())}
        new = hasattr(feqmod, "bwd_kernel_name")
        if new:
            # (named bwd_chain_split and BWD_CHAINS before the forward
            # kernels split their cells by chain too)
            split = getattr(feqmod, "chain_split", None) or getattr(
                feqmod, "bwd_chain_split")
            order, offs = split(x, dim)
            offs = offs.tolist()
            names = getattr(feqmod, "CHAINS", None) or getattr(
                feqmod, "BWD_CHAINS")
            chains = [(i, n) for i, n in enumerate(names)
                      if i < (3 if dim == 3 else 2)]
            entry["cells_per_chain"] = {n: offs[i + 1] - offs[i]
                                        for i, n in chains}
        else:
            chains = [(None, "both")]
        for i, name in chains:
            kern = (feqmod.bwd_kernel_name(flags, i) if new
                    else f"feqmod_remap_bwd_kernelIfLi{df}EE" if dim == 2
                    else f"feqmod_bwd_kernelIfLi{dim}ELi{df}EE")
            entry[f"resources_{name}"] = bwd_resources(
                "feqmod_bwd", kern,
                (lambda i=i: feqmod.bwd_props(dev, False, mom, flags, i))
                if new else None,
                lambda: first_version_shape(R, F, 54, dim == 3))
        report[case] = entry
        return
    if kind == "polzn":
        cfg = Config(mode=5, **base)
        cols = polzn.polzn_cols(surface_from_arrays(
            dtype=dt, device=dev, **testing.synthetic_surface_cells(
                n_cells, dim, 0), **testing.synthetic_vorticity(n_cells, 0)))
        flags = polzn.polzn_flags(cfg, grid)
        x = polzn.pack_polzn_cells(cols, testing.POLZN_T_AVG, flags)
        pm, wR = polzn.species_pm(species), polzn.node_weights(grid, flags)
        G5 = testing.grad_cotangent((5,) + tuple(G.shape), dtype=dt,
                                    device=dev)
        table = smooth.remap_node_table(mom) if flags.remap else None
        go = lambda: polzn.polzn_bwd_cuda(x, G5, mom, pm, wR, flags, table)
        xs = x[:cut].contiguous()
        out = polzn.polzn_bwd_cuda(xs, G5, mom, pm, wR, flags,
                                   table).double()
        ref = polzn.polzn_bwd_cuda(
            xs.double(), G5.double(), mom64, pm.double(), wR.double(), flags,
            smooth.remap_node_table(mom64) if flags.remap else None)
        ms, runs, total = timed(go)
        report[case] = {
            "ms": ms, "runs": runs, "sum": total, "err_f64": float(
                (out - ref).abs().max() / ref.abs().max()),
            "resources": bwd_resources(
                "polzn_bwd", "polzn_remap_bwd_kernelIfEE" if flags.remap
                else f"polzn_bwd_kernelIfLi{dim}EE",
                (lambda: polzn.bwd_props(dev, False, mom, flags, n_cells))
                if hasattr(polzn, "BWD_PLAN")
                else (lambda: polzn.bwd_props(dev, False, mom, flags)),
                None)}
        return
    cfg = Config(mode=2, **base)
    cells = testing.synthetic_vah_cells(n_cells, dim, seed=0)
    kinds = [("", cells)]
    if dim == 3:
        kinds.append(("_chains", dict(cells, **testing.synthetic_vah_coefficients(
            cells, seed=0))))
    for suffix, c in kinds:
        cols = vah.vah_surface_cols(surface_from_arrays(dtype=dt, device=dev,
                                                        **c))
        flags = vah.vah_flags(vah.effective_vah_cfg(cols, cfg), grid)
        x = vah.group_inputs(cols, flags)
        go = lambda: vah.vah_bwd_cuda(x, G, mom, flags)
        xs = x[:cut].contiguous()
        out = vah.vah_bwd_cuda(xs, G, mom, flags).double()
        ref = vah.vah_bwd_cuda(xs.double(), G.double(), mom64, flags)
        ms, runs, total = timed(go)
        kern = (f"vah_remap_bwd_kernelIfLi{flags.switches}EE" if dim == 2
                else f"vah_bwd_kernelIfLi{dim}ELi{flags.switches}EE")
        report[case + suffix] = {
            "ms": ms, "runs": runs, "sum": total, "err_f64": float(
                (out - ref).abs().max() / ref.abs().max()),
            "chains": flags.switches, "resources": bwd_resources(
                "vah_bwd", kern,
                (lambda: vah.bwd_props(dev, False, mom, flags))
                if hasattr(vah, "bwd_props") else None,
                lambda: first_version_shape(R, F, 35, dim == 3))}


# K9a / K9b: the linear-df backward on one synthetic group
def grad_main_case(case, report):
    dim = 3 if case == "grad_main_3d" else 2
    f64 = torch.float64
    cfg = Config(operation=1, mode=1, dimension=dim, df_mode=2,
                 precision="f32", include_shear_deltaf=1,
                 include_bulk_deltaf=1, regulate_deltaf=1, outflow=1)
    surf = testing.synthetic_surface(n_cells, dim, seed=0, dtype=dt,
                                     device=dev)
    species = testing.synthetic_species(320, dtype=dt, device=dev)
    grid = native_momentum_grid(dim, eta_mT_rescale=dim == 2, dtype=dt,
                                device=dev)
    df_data = testing.synthetic_deltaf_data(dtype=dt, device=dev)
    cells = smooth.pack_cells(prepare_cells(surface_columns(surf, cfg), cfg,
                                            df_data), cfg)
    mom = smooth.momentum_constants(species, grid, dim)
    flags = smooth.spectra_flags(cfg, grid)
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    R = mom.nodes.shape[0]
    G = testing.grad_cotangent((S, P, F, R if dim == 3 else 1), dtype=dt,
                               device=dev)
    table = smooth.remap_node_table(mom) if flags.remap else None
    go = lambda: smooth.spectra_bwd_cuda(cells, G, mom, flags, table)
    cs = cells[:512].contiguous()
    out = smooth.spectra_bwd_cuda(cs, G, mom, flags, table).double()
    ref = smooth.spectra_bwd_cuda(cs.double(), G.double(), mom.to(dtype=f64),
                                  flags, None if table is None
                                  else table.double())
    ms, runs, total = timed(go)
    kern = ("remap_bwd_kernelIfLi2E" if flags.remap
            else "spectra_bwd_kernelIfLi3ELi2E")

    def first_version():           # 128 threads' worth of (cell, node)
        CT = 128 // R
        nt = (CT * R + 31) // 32 * 32
        gs, red = 16 * F * (R if dim == 3 else 1) * 4, CT * R * 36 * 8
        rest = CT * 36 + 4 * 16 + CT * F * 4 + 2 * F + (
            16 * R * 2 if flags.remap else 0)
        return nt, max(gs, red) + rest * 4
    props = None
    if flags.remap and hasattr(smooth, "bwd_props"):
        props = lambda: smooth.bwd_props(dev, False, mom, flags)
    elif hasattr(smooth, "FIXED_BWD_PLAN"):        # K9a's plan
        props = lambda: smooth.bwd_props(dev, False, mom, flags,
                                         cells.shape[0])
    report[case] = {"ms": ms, "runs": runs, "sum": total, "err_f64": float(
        (out - ref).abs().max() / ref.abs().max()), "resources":
        bwd_resources("smooth_spectra_bwd", kern, props, first_version)}


# K9c on every launch of the decays case's cascade, 3+1D float32
def grad_decays_case(report):
    from is3d_tpu_torch.native import build
    from is3d_tpu_torch.tools import sass_count
    f64 = torch.float64
    table, mcids = testing.synthetic_decaying_table(320)
    grid = native_momentum_grid(3)
    pT64 = grid.pT.numpy()
    waves = decays.plan_waves(decays._decay_schedule(
        table, mcids, pT64, Config().lightest_particle))
    acc = torch.as_tensor(testing.thermal_spectra(table, mcids, grid, 3),
                          device=dev)
    wg, wg64 = (decays.wave_grid(grid, 3, t, dev) for t in (dt, f64))
    G = testing.grad_cotangent(acc.shape, device=dev)
    lib = build._cuda_paths("decays_bwd")[1]
    sub = lambda t: decays.WaveTasks(
        nbody=t.nbody, slot=t.slot[:1], seg=t.seg[:1], par=t.par[:1],
        order=t.order, target=t.target, tstart=t.tstart)
    for i, st in enumerate(decays.stage_waves(waves, pT64, dt, dev)):
        tables = decays.parent_tables(acc, st.rows, st.masses, st.mtg, dt)
        tables64 = tables.to(None, f64)
        for tasks in st.launches:
            go = lambda: decays.wave_bwd_cuda(tables, tasks, wg, G)[0]
            ms, runs, total = timed(go)
            one = sub(tasks)
            out = decays.wave_bwd_cuda(tables, one, wg, G)
            ref = decays.wave_bwd_cuda(tables64, one.to(None, f64), wg64, G)
            err = max(float((a.double() - b).abs().max() / b.abs().max())
                      for a, b in zip(out, ref) if b.abs().max() > 0)
            entry = {"ms": ms, "runs": runs, "sum": total, "err_f64": err,
                     "tasks": tasks.slot.shape[0],
                     "evaluations": decays.wave_evaluations(tasks, wg)}
            if hasattr(decays, "wave_bwd_blocking"):
                entry["route"] = decays.wave_bwd_blocking(tables, tasks,
                                                          wg)["route"]
                kern = (f"wave_bwd_kernelIfLi3ELi{tasks.nbody}ELb"
                        f"{int(entry['route'] == 'shared')}E")
            else:
                entry["route"] = "two passes, device atomics"
                kern = f"wave_bwd_kernelIfLi3ELi{tasks.nbody}ELi1E"
            if hasattr(decays, "wave_bwd_bits"):
                b, e = decays.wave_bwd_bits(tables, tasks, wg, G)
                live = e > -2 ** 31
                entry["bits_given_up"] = [int((b - e)[live].min()),
                                          int((b - e)[live].max())]
            entry["sass"] = sass_count.per_eval(lib, kern)
            report[f"grad_decays_w{i}_{tasks.nbody}body"] = entry
            decays.decay_wave_cuda(tables, tasks, wg, acc)


# K3, the df 3-4 forward (feqmod_spectra_cuda), on the first group of the
# [feqmod main] (3+1D df 3) and [feqmod main 2d] (2+1D df 4, mT remap)
# surfaces: as they are, and with the shear stress x 30 (most cells break
# down), as chip_smoke.py's [feqmod pair] and [feqmod remap pair]
FEQMOD = {"feqmod_3d": (3, 1.0), "feqmod_3d_most": (3, 30.0),
          "feqmod_2d": (2, 1.0), "feqmod_2d_most": (2, 30.0)}
feqmod_runs = {}


def feqmod_run(dim):
    import tempfile
    from is3d_tpu_torch.api import IS3D
    if dim not in feqmod_runs:
        cfg = Config(operation=1, mode=1, dimension=dim,
                     df_mode=3 if dim == 3 else 4, precision="f32",
                     include_shear_deltaf=1, include_bulk_deltaf=1,
                     regulate_deltaf=1, outflow=1)
        with tempfile.TemporaryDirectory() as run_dir:
            testing.write_synthetic_run_dir(run_dir, 131072, 320,
                                            dimension=dim, seed=0)
            run = IS3D(cfg, data_dir=run_dir, device="cuda")
            _, df_data, species, _, grid = run._prepare()
        feqmod_runs[dim] = (cfg, surface_columns(run.surface, cfg), species,
                            grid, df_data)
    return feqmod_runs[dim]


def feqmod_case(case, report):
    from is3d_tpu_torch.io.tables import laguerre_device
    from is3d_tpu_torch.kernels import feqmod
    from is3d_tpu_torch.native import build
    from is3d_tpu_torch.tools import sass_count
    dim, shear = FEQMOD[case]
    cfg, cols, species, grid, df_data = feqmod_run(dim)
    group = {k: v[:n_cells] for k, v in cols.items()}
    for k in ("pixx", "pixy", "pixn", "piyy", "piyn"):
        group[k] = group[k] * shear
    flags = feqmod.feqmod_flags(cfg, grid)
    mom = smooth.momentum_constants(species, grid, dim)
    x, rn, wcs = feqmod.group_inputs(
        group, species, laguerre_device(dtype=dt, device=dev), df_data, cfg,
        flags)
    table = smooth.remap_node_table(mom) if flags.remap else None
    ms, runs, total = timed(
        lambda: feqmod.feqmod_spectra_cuda(x, rn, wcs, mom, flags, table))
    small = [t[:512].contiguous() for t in (x, rn, wcs)]
    mom64 = mom.to(dtype=torch.float64)
    out = feqmod.feqmod_spectra_cuda(*small, mom, flags, table).double()
    ref = feqmod.feqmod_spectra_cuda(
        *(t.double() for t in small), mom64, flags,
        smooth.remap_node_table(mom64) if flags.remap else None)
    bd = x[:, feqmod.FQ["bd"]] != 0
    # evaluations of each chain: a breakdown cell's all take the
    # fallback, in 3+1D also a clean cell's with detA < 0.01 at |y - eta|
    # < detA
    S, M, R = mom.mass.shape[0], mom.px.shape[0], mom.nodes.shape[0]
    fb_nodes = bd.double() * R
    if dim == 3:
        detA, eta = x[:, feqmod.FQ["detA"]], x[:, feqmod.FQ["eta"]]
        fb_nodes = fb_nodes + ((((~bd) & (detA < feqmod.NARROW_DETA))[:, None]
                                & ((mom.nodes[None, :] - eta[:, None]).abs()
                                   < detA[:, None])).sum(1))
    evals = x.shape[0] * R * S * M
    entry = {"ms": ms, "runs": runs, "sum": total,
             "err_f64": float((out - ref).abs().max() / ref.abs().max()),
             "breakdown_share": float(bd.double().mean()),
             "evaluations": evals,
             "fallback_share": float(fb_nodes.sum()) * S * M / evals}
    lib = build._cuda_paths("feqmod")[1]
    if hasattr(feqmod, "chain_kernel_name"):
        # one instantiation a chain (csrc/feqmod.cu since its redesign)
        order, offs = feqmod.chain_split(x, dim)
        offs = offs.tolist()
        for i in range(3 if dim == 3 else 2):
            kern = feqmod.chain_kernel_name(flags, i, mom.n_phi)
            res = dict(cells=offs[i + 1] - offs[i], kernel=kern,
                       **feqmod.chain_props(dev, False, flags, i, mom.n_phi))
            res["warps_per_sm"] = res["blocks_per_sm"] * res["threads"] // 32
            res["sass"] = sass_count.per_eval(lib, kern)
            entry[f"resources_{feqmod.CHAINS[i]}"] = res
    else:
        # the first version: one body for both chains, 128 threads a block
        width = (feqmod.feqmod_grid(
            feqmod._library(), dev, False, S, mom.pT.shape[0], mom.n_phi,
            R, 2, True).phi_width if flags.remap else 0)
        kern = (f"remap_kernelIfLi{width}EE" if flags.remap
                else f"fixed_kernelIfLi{dim}EE")
        entry["resources_both"] = bwd_resources(
            "feqmod", kern, None, lambda: (128, 0))
        entry["resources_both"]["kernel"] = kern
    report[case] = entry


# K3's dN/dX producer (dndx_feqmod_cuda, csrc/dndx.cu, which shares
# csrc/feqmod.cuh) on the first canonical group of chip_smoke.py's
# [feqmod dndx] surface (16384 2+1D cells x 320 species, operation 0, df
# 3, 48 fixed eta nodes)
def feqmod_dndx_case(report):
    import dataclasses
    import tempfile
    from is3d_tpu_torch.api import IS3D
    from is3d_tpu_torch.io.tables import laguerre_device
    from is3d_tpu_torch.kernels import feqmod
    from is3d_tpu_torch.parallel.mesh import canonical_groups
    cfg = Config(operation=0, mode=1, dimension=2, df_mode=3,
                 precision="f32", include_shear_deltaf=1,
                 include_bulk_deltaf=1, regulate_deltaf=1, outflow=1)
    with tempfile.TemporaryDirectory() as run_dir:
        testing.write_synthetic_run_dir(run_dir, 16384, 320, dimension=2,
                                        seed=0)
        run = IS3D(cfg, data_dir=run_dir, device="cuda")
        _, df_data, species, _, grid = run._prepare()
    grid = dataclasses.replace(grid, eta_mT_rescale=False)
    cols = surface_columns(run.surface, cfg)
    _, gs = canonical_groups(cfg, cols["tau"].shape[0])
    flags = feqmod.feqmod_flags(cfg, grid)
    mom = smooth.momentum_constants(species, grid, 2)
    wM, wR = dndx.momentum_weights(grid, cfg), dndx.node_weights(grid, 2)
    x, rn, wcs = feqmod.group_inputs(
        {k: v[:gs] for k, v in cols.items()}, species,
        laguerre_device(dtype=dt, device=dev), df_data, cfg, flags)
    ms, runs, total = timed(
        lambda: dndx.dndx_feqmod_cuda(x, rn, wcs, mom, flags, wM, wR)[0])
    out = dndx.dndx_feqmod_cuda(x, rn, wcs, mom, flags, wM, wR)[0].double()
    ref = dndx.dndx_feqmod_cuda(x.double(), rn.double(), wcs.double(),
                                mom.to(dtype=torch.float64), flags,
                                wM.double(), wR.double())[0]
    report["feqmod_dndx"] = {"ms": ms, "runs": runs, "sum": total,
                             "err_f64": float((out - ref).abs().max()
                                              / ref.abs().max())}


report = {"root": sys.argv[1]}
surface = None
for case in cases:
    if case in FEQMOD:
        feqmod_case(case, report)
        continue
    if case == "feqmod_dndx":
        feqmod_dndx_case(report)
        continue
    if case in GRAD:
        grad_case(case, report)
        continue
    if case in ("grad_main_3d", "grad_main_2d"):
        grad_main_case(case, report)
        continue
    if case == "grad_decays":
        grad_decays_case(report)
        continue
    if case in SPECTRA:
        dim, df, remap = SPECTRA[case]
        cfg = Config(operation=1, mode=1, dimension=dim, df_mode=df,
                     precision="f32", include_shear_deltaf=1,
                     include_bulk_deltaf=1, regulate_deltaf=1, outflow=1)
        surf = testing.synthetic_surface(n_cells, dim, seed=0, dtype=dt,
                                         device=dev)
        species = testing.synthetic_species(320, dtype=dt, device=dev)
        grid = native_momentum_grid(dim, eta_mT_rescale=remap, dtype=dt,
                                    device=dev)
        df_data = testing.synthetic_deltaf_data(dtype=dt, device=dev)
        cells = smooth.pack_cells(prepare_cells(surface_columns(surf, cfg),
                                                cfg, df_data), cfg)
        mom = smooth.momentum_constants(species, grid, dim)
        flags = smooth.spectra_flags(cfg, grid)
        ms, runs, total = timed(
            lambda: smooth.smooth_spectra_cuda(cells, mom, flags))
        out = smooth.smooth_spectra_cuda(cells, mom, flags).double()
        ref = smooth.smooth_spectra_cuda(cells.double(),
                                         mom.to(dtype=torch.float64), flags)
        err = float((out - ref).abs().max() / ref.abs().max())
    elif case == "dndx":
        cfg = Config(operation=0, mode=1, dimension=2, df_mode=1,
                     precision="f32", include_shear_deltaf=1,
                     include_bulk_deltaf=1, regulate_deltaf=1, outflow=1)
        surf = testing.synthetic_surface(8192, 2, seed=2, dtype=dt,
                                         device=dev)
        species = testing.synthetic_species(320, dtype=dt, device=dev)
        grid = native_momentum_grid(2, eta_mT_rescale=False, dtype=dt,
                                    device=dev)
        df_data = testing.synthetic_deltaf_data(dtype=dt, device=dev)
        cells = smooth.pack_cells(prepare_cells(surface_columns(surf, cfg),
                                                cfg, df_data), cfg)
        mom = smooth.momentum_constants(species, grid, 2)
        flags = smooth.spectra_flags(cfg, grid)
        wM = dndx.momentum_weights(grid, cfg)
        wR = dndx.node_weights(grid, 2)
        ms, runs, total = timed(
            lambda: dndx.dndx_cuda(cells, mom, flags, wM, wR)[0])
        out = dndx.dndx_cuda(cells, mom, flags, wM, wR)[0].double()
        ref = dndx.dndx_cuda(cells.double(), mom.to(dtype=torch.float64),
                             flags, wM.double(), wR.double())[0]
        err = float((out - ref).abs().max() / ref.abs().max())
    elif case in ("polzn_3d", "polzn_2d"):
        from is3d_tpu_torch.io.surface import surface_from_arrays
        from is3d_tpu_torch.kernels import polzn
        dim = 3 if case == "polzn_3d" else 2
        grid = native_momentum_grid(dim, eta_mT_rescale=dim == 2, dtype=dt,
                                    device=dev)
        species = testing.synthetic_species(320, dtype=dt, device=dev)
        mom = smooth.momentum_constants(species, grid, dim)
        mom64 = mom.to(dtype=torch.float64)
        flags = polzn.polzn_flags(Config(mode=5, dimension=dim), grid)
        x = polzn.pack_polzn_cells(polzn.polzn_cols(surface_from_arrays(
            dtype=dt, device=dev, **testing.synthetic_surface_cells(
                n_cells, dim, 0), **testing.synthetic_vorticity(n_cells, 0))),
            testing.POLZN_T_AVG, flags)
        pm, wR = polzn.species_pm(species), polzn.node_weights(grid, flags)
        sums = lambda x, m, pm, wR: torch.stack(polzn.polzn_cuda(
            x, m, pm, wR, flags,
            smooth.remap_node_table(m) if flags.remap else None))
        ms, runs, total = timed(lambda: sums(x, mom, pm, wR))
        xs = x[:512].contiguous()
        out = sums(xs, mom, pm, wR).double()
        ref = sums(xs.double(), mom64, pm.double(), wR.double())
        err = float((out - ref).abs().max() / ref.abs().max())
    elif case == "proto":
        x = smooth_proto.proto_inputs(device=dev)
        args = [x[n] for n in smooth_proto.ARGS]
        ms, runs, total = timed(
            lambda: smooth_proto.proto_spectra_cuda(*args))
        sub = [args[0][:2048].contiguous()] + args[1:]
        out = smooth_proto.proto_spectra_cuda(*sub).double()
        ref = smooth_proto.proto_spectra_cuda(*(a.double() for a in sub))
        err = float((out - ref).abs().max() / ref.abs().max())
    elif case == "decays":
        table, mcids = testing.synthetic_decaying_table(320)
        f64 = torch.float64
        for dim, wdt in ((3, dt), (3, f64), (2, dt), (2, f64)):
            grid = native_momentum_grid(dim)
            pT64 = grid.pT.numpy()
            waves = decays.plan_waves(decays._decay_schedule(
                table, mcids, pT64, Config().lightest_particle))
            acc = torch.as_tensor(testing.thermal_spectra(table, mcids, grid,
                                                          dim), device=dev)
            wg, wg64 = (decays.wave_grid(grid, dim, t, dev)
                        for t in (wdt, f64))
            name = "decays" + ("" if (dim, wdt) == (3, dt) else
                               f"_{dim}d_{str(wdt)[-7:]}")
            for i, (st, st64) in enumerate(zip(
                    decays.stage_waves(waves, pT64, wdt, dev),
                    decays.stage_waves(waves, pT64, f64, dev))):
                tables = decays.parent_tables(acc, st.rows, st.masses,
                                              st.mtg, wdt)
                tables64 = decays.parent_tables(acc, st64.rows, st64.masses,
                                                st64.mtg, f64)
                for tasks, tasks64 in zip(st.launches, st64.launches):
                    scratch = torch.zeros_like(acc)
                    ms, runs, total = timed(lambda: (decays.decay_wave_cuda(
                        tables, tasks, wg, scratch), scratch)[1])
                    err = None
                    if wdt != f64:
                        out, ref = torch.zeros_like(acc), torch.zeros_like(acc)
                        decays.decay_wave_cuda(tables, tasks, wg, out)
                        decays.decay_wave_cuda(tables64, tasks64, wg64, ref)
                        err = float((out - ref).abs().max() / ref.abs().max())
                    report[f"{name}_w{i}_{tasks.nbody}body"] = {
                        "ms": ms, "runs": runs, "sum": total, "err_f64": err}
                    decays.decay_wave_cuda(tables, tasks, wg, acc)
        continue
    elif case == "cascade":
        cascade_cases(report)
        continue
    elif case == "yields":
        from is3d_tpu_torch.io.tables import laguerre_device
        from is3d_tpu_torch.kernels import sample
        surface = surface or sampler_surface()
        cfg, species, _, run, df_data = surface
        c = prepare_cells(sample._cast_floats(sample._sampler_cols(
            run.surface, cfg), dt), cfg, sample._cast_floats(df_data, dt))
        c["breakdown"] = torch.zeros_like(c["T"], dtype=torch.bool)
        lag = laguerre_device(32, (1, 2), dtype=dt, device=dev)
        if hasattr(sample, "species_yields"):
            cols = dict(T=c["T"], alphaB=c["alphaB"], bulkPi=c["bulkPi"],
                        breakdown=c["breakdown"], F=c["df"].F, G=c["df"].G,
                        z=c["df"].z, betabulk=c["df"].betabulk)
            go = lambda: sample.species_yields(cols, species, lag, cfg)[0]
        else:       # before K7b: phase A's torch quadrature
            go = lambda: sample._species_yields_exact(c, species, lag, cfg)
        ms, runs, total = timed(go, inner=5)
        err = None
    elif case in ("alias", "sample"):
        from is3d_tpu_torch.kernels import rng, sample
        surface = surface or sampler_surface()
        cfg, species, cell = surface[:3]
        dn = cell["dn_list"]
        if case == "alias":
            ms, runs, total = timed(lambda: sample.alias_build(dn)[0],
                                    inner=5)
            err = None
        else:
            tables = sample.build_alias_tables(dn, cell["dn_tot"])
            rows, layout = sample.pack_rows(cell, cfg)
            lam = float(cell["dn_tot"].sum())
            ntot = abs(sample._total_yield(cell, cfg))
            n_cap = sample._slot_capacity(lam)
            B = sample._batch_width(sample._oversample_nevents(None, ntot,
                                                               cfg), n_cap)
            cap = sample._packed_capacity(B, min(ntot, lam) or lam, n_cap)
            counts = torch.as_tensor(rng.poisson_counts(17, range(B), lam),
                                     dtype=torch.int32, device=dev)
            S, C = species.mass.shape[0], rows.shape[0]
            if hasattr(sample, "event_batch_packed"):
                go = lambda: sample.event_batch_packed(
                    rows, layout, tables, species, counts, 17, 0, n_cap, cfg,
                    cap)
            else:
                go = lambda: (lambda p, e: (p, e, None))(*sample.pack_batch(
                    sample.event_batch_cuda(rows, layout, tables, species,
                                            counts, 17, 0, n_cap, cfg),
                    cfg, S, C, cap))
            ms, runs, _ = timed(lambda: go()[1], inner=5)
            packed, per_event, _ = go()
            kept = int(per_event.sum())
            total = float(packed["px"][:min(kept, cap)].double().sum())
            err = None
    else:
        cfg = Config(operation=0, mode=1, dimension=2)
        surf = testing.synthetic_surface(8192, 2, seed=2, dtype=dt,
                                         device=dev)
        plan = dndx.bin_plan(surf.tau, surf.x, surf.y, cfg)
        per_cell = torch.from_numpy(np.random.default_rng(5).random(
            (8192, 320), dtype=np.float32)).to(dev)
        ms, runs, total = timed(lambda: dndx.dndx_bin_cuda(per_cell, plan),
                                inner=20)
        ref = dndx.dndx_bin_cuda(per_cell.double(), plan)
        out = dndx.dndx_bin_cuda(per_cell, plan).double()
        err = float((out - ref).abs().max() / ref.abs().max())
    report[case] = {"ms": ms, "runs": runs, "sum": total, "err_f64": err}
print(json.dumps(report))
"""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root_a")
    ap.add_argument("root_b", nargs="+")
    ap.add_argument("--cells", type=int, default=16384)
    ap.add_argument("--cases", default=",".join(CASES))
    args = ap.parse_args(argv)
    cases = args.cases.split(",")
    unknown = set(cases) - set(CASES)
    if unknown:
        ap.error(f"unknown cases {sorted(unknown)}; known: {CASES}")
    roots = [os.path.abspath(r) for r in (args.root_a, *args.root_b)]
    results = {r: [] for r in roots}
    for root in roots + roots[::-1]:
        proc = subprocess.run([sys.executable, "-c", _TURN, root,
                               str(args.cells), ",".join(cases),
                               os.path.join(os.path.dirname(
                                   os.path.abspath(__file__)),
                                   "occupancy.py")],
                              capture_output=True, text=True, check=True,
                              timeout=1800)
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results[root].append(json.loads(line))
    # a case may report several entries (decays: one a launch); a side
    # without a case's kernel reports it "absent"
    entries = [k for k in results[roots[0]][0] if k != "root"]
    for case in entries:
        absent = [os.path.relpath(r) for r in roots
                  if not isinstance(results[r][0].get(case), dict)]
        if absent:
            print(json.dumps({"case": case, "absent": absent}))
            continue
        med = {r: sum(t[case]["ms"] for t in results[r]) / 2 for r in roots}
        sums = {r: results[r][0][case]["sum"] for r in roots}
        first = roots[0]
        for other in roots[1:]:
            print(json.dumps({
                "case": case, "b": os.path.relpath(other),
                "a_ms": med[first], "b_ms": med[other],
                "b_over_a": med[other] / med[first],
                "same_sum": len({t[case]["sum"] for r in (first, other)
                                 for t in results[r]}) == 1,
                "sum_rel_diff": abs(sums[other] - sums[first])
                / abs(sums[first]),
                "a_err_f64": results[first][0][case]["err_f64"],
                "b_err_f64": results[other][0][case]["err_f64"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
