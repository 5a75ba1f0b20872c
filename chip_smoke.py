#!/usr/bin/env python3
"""Smoke run of is3d_tpu_torch on one CUDA card.

Usage (from the repository root; needs one GPU, nvcc and g++)::

    python3 chip_smoke.py

Phases, each printing its own line(s):

1. device: the card's name, power limit and maximum SM clock
   (nvidia-smi); fails without CUDA;
2. build: every kernel source (csrc/smooth_spectra.cu, csrc/dndx.cu,
   csrc/smooth_proto.cu, csrc/decays.cu, csrc/feqmod.cu, csrc/vah.cu,
   csrc/polzn.cu, csrc/sample.cu, csrc/mc_decays.cu, csrc/yields.cu,
   csrc/sample_vah.cu, csrc/sample_search.cu, csrc/sample_vah_search.cu,
   csrc/smooth_spectra_bwd.cu, csrc/decays_bwd.cu, csrc/feqmod_bwd.cu,
   csrc/vah_bwd.cu, csrc/polzn_bwd.cu; one nvcc each, all started
   together) and the fastio host library, from this checkout's
   sources, with ptxas's register and spill lines;
3. each kernel against its plain torch version at small shapes, in f32
   (atol 2e-5 * max, rtol 2e-4) and f64 (rtol 1e-10, atol 1e-13 * max):
   the spectra kernel on every path (3+1D df 1/2, 2+1D fixed nodes, 2+1D
   mT remap; regulate/outflow off and on; one baryon + diffusion case
   each); the spectra kernel's edges (species, momentum points and nodes
   that are not multiples of its blocking factors; 3+1D rapidities far
   enough from the cells that exp(u.p/T) overflows, where the output must
   be exactly 0; a boson at small mT; large shear with regulate on, where
   the clip must bite; with the 2+1D remap also flow rapidities up to 2,
   light bosons where s(mT) clamps to 1, eta nodes so far out that the
   lightest species' outputs are exactly 0, pad rows); the dN/dX kernel
   and its binning kernel (777
   cells, 40 species; 2+1D and 3+1D, df 1/2, regulate/outflow off and on,
   baryon + diffusion); the dN/dX kernel's edges (species, nodes and rows
   that are not multiples of its blocking, fewer rows than one batch, one
   row, exp overflow with exact zeros, light bosons, an active clip, pad
   rows; two launches bit-identical); the binning kernel's edges (empty
   bins, a bin of
   every cell, bins longer and shorter than one slice, two launches
   bit-identical); the spectra prototype (with masked cells, which must
   add exactly 0) and the reduction probe; the decay-wave kernel's edges
   (testing.DECAY_EDGES: 2- and 3-body, 2+1D and 3+1D; parent MT past
   the grid, Phi in the wrap cell, |Y| > y_max with exact zeros, massless
   daughters, adjusted masses, a row fed by many tasks, a parent at the
   -745 floor, a stretched y grid whose stencils are not consecutive; two
   launches bit-identical); [feqmod small]: the three entry points of the
   feqmod kernel K3 (fixed nodes, 2+1D remap, the dN/dX producer) on
   testing.FEQMOD_EDGES (df 3 and 4; clean, mixed and mostly broken-down
   cells; the 3+1D narrow mask; ragged species, points and nodes; exp
   overflow with exact zeros; the df 4 clamp; both
   reference_compat_feqmod_eta settings; a baryon case; betaV = 0 tables;
   pad rows; two launches bit-identical); [vah small]: the three entry
   points of the VAH kernel K4 (fixed nodes, 2+1D remap, the dN/dX
   producer) on testing.VAH_EDGES (every chain setting, regulate/outflow
   off and on, a_L on one side of 1, ragged shapes, strong flow, exact
   zeros, pad rows); [polzn small]: both polarization kernels K6 on
   testing.POLZN_EDGES, each of the five sums (a massless species' inf
   and NaN in the same places); f32 and f64, two launches bit-identical,
   exact zeros kept; [sample small]: the event kernel K7 against its
   plain version slot by slot on testing.SAMPLE_EDGES (df 1-4, 2+1D and
   3+1D, broken-down cells, baryon diffusion in 2+1D and 3+1D; a
   massless species and zero-yield cells no slot may draw), f32 and f64,
   the flipped decisions counted (none allowed in f64), two launches
   bit-identical, its packed mode bit for bit pack_batch of its per-slot
   output (at the run's capacity and past it), and a batch past its
   packed capacity run again, through the packed mode, to the same
   events; [alias small]: K7a on testing.alias_edge_weights (rows too long
   for its shared memory too), tables identical to the plain version's;
   [cascade small]: K8 on
   testing.cascade_edge_inputs (4 and testing.WIDE_CHANNELS channels a
   species), f32 and f64: the same daughters and lineage words,
   one launch a pass queued with no host sync (set_sync_debug_mode
   "error"), two runs bit-identical, and its two guards (capacity, a table
   short of a pass); [grad small]: the backward kernels K9a and K9b
   (csrc/smooth_spectra_bwd.cu) on every testing.SPECTRA_EDGES case and
   K9c (csrc/decays_bwd.cu) on every testing.DECAY_EDGES case and the
   finer-y 3-body wave of testing.DECAY_ROUTE_EDGES (whose float32 slot
   words do not fit in shared memory: the route by shape) against the
   plain versions' autograd in f64 from the same inputs (a positive
   cotangent, testing.grad_cotangent), f32 and f64, two launches
   bit-identical, each K9c launch on its route; [grad small feqmod] and [grad small vah]: K10a/K10b
   (csrc/feqmod_bwd.cu) on every testing.FEQMOD_EDGES case and K11a/K11b
   (csrc/vah_bwd.cu) on every testing.VAH_EDGES case the same way, each
   field to its own largest value (the f64 reference rounded to the
   kernel's precision);
4. operation 1 main path: a synthetic 131072-cell x 320-species 3+1D
   mode-1 run directory through ``is3d_tpu_torch.cli.main`` (df 2, shear +
   bulk, regulate, outflow, f32, native 32 x 24 x 21 grid), then the same
   CLI on a 256-cell run directory on cuda and on cpu (f64), whose spectra
   files must agree;
5. the spectra kernel on one canonical group of that surface (16384
   cells), f32: two launches bit-identical; on the group's first 2048
   cells agreement with the plain version and both f32 versions against
   the f64 kernel (the kernel's difference at most 3x the plain
   version's); times (CUDA events, one warm-up, median of 5; the plain
   version's one run), the bound and the kernel's instructions per
   evaluation (tools/sass_count.py, where cuobjdump reads the library);
   [grad pair] the backward kernel K9a on that group (median of 3, bound
   from kernels/smooth.py:BACKWARD_FORMULA_OPS, SASS, its plan: cells a
   block, species a stage, registers, resident blocks, waves and the last
   wave's blocks, SMs and fill; its first 32 cells against the plain
   version); [grad main] diff.surface_vjp of the
   production spectra of that surface and the pullback of sum dN/dy plus
   the pions' v2 and <pT>, with respect to T, u, bulkPi, pi, dsigma and
   eta: the forward bit-equal to smooth_spectra, K1 and K9a each launched
   once a group, forward and backward seconds; on its first 256 cells in
   f64 five entries against central differences (rtol 5e-5);
5a. the default 2+1D operation-1 main path: a synthetic 131072-cell x
   320-species 2+1D run directory through ``cli.main`` (df 2, shear + bulk,
   regulate, outflow, f32, native 32 x 24 x 48 grid with the mT remap):
   launches of the remap kernel = canonical groups, the results tree; then
   the same CLI on a 256-cell run directory on cuda and on cpu (f64); then
   the remap kernel on one canonical group of that surface as in 5 (the
   plain version on its first 1024 cells); [grad pair 2d] and [grad main
   2d] as in 5 with K9b (the remap's backward); [trace] the same CLI run
   again inside utils.device_trace (CUDA activity), the Chrome trace in
   chiprun_out/trace_main_2d/ read by tools/trace_summary.py: its
   remap_kernel launches equal to the run's counted launches (one a
   canonical group), the results tree byte-equal to the untraced run's;
   the traced window, the card's busy seconds (the union of its kernel,
   memcpy and memset intervals), the idle share, the five kernels with
   the most device time and the trace's size;
6. operation 0 main path: a synthetic 65536-cell x 320-species 2+1D run
   directory through ``cli.main`` (df 1, shear + bulk, regulate, outflow,
   f32, native 32 x 24 x 48 grid): launches = canonical groups, every
   spacetime_distribution file present and finite, pion dN/dy > 0; then
   the same CLI on a 256-cell run directory on cuda and on cpu (f64);
7. the dN/dX kernel and the binning kernel on one canonical group of that
   surface (8192 cells), f32: two launches bit-identical; on the group's
   first 1024 cells agreement with the plain version and the f32 kernel
   and the f32 plain version against the f64 kernel; times (one warm-up
   and the median of 5; the plain version's one run; the binning kernel,
   its plain version and its library yardstick on the whole group as 20
   calls queued behind a device-side sleep, per call);
7a. the operation-1 main path with decays: a synthetic 131072-cell x
   320-species 3+1D run directory on the decaying list through
   ``cli.main`` (as 4, do_resonance_decays = 1): its phases by name, the
   waves and channel contributions it prints and the wave kernel's
   launches, each equal to is3d_tpu's count of the list's schedule
   (testing.DECAYS_MAIN_SCHEDULE: waves, and the waves with 2- (3-) body
   tasks), the decay files; then the same CLI on
   256-cell run directories on cuda and on cpu (f64), 2+1D with 24 and
   3+1D with 16 species; then the cascade again on that run's smooth
   spectra, wave by wave: each launch timed (CUDA events, one warm-up,
   median of 3) beside its bound, the largest launch of each body held
   against its plain version on the same inputs (one timed run, all its
   buckets; the kernel record's ms, plain_ms and bound_ms are of that
   launch, path_ms the sum over the path's launches), the wave kernel's
   SASS per evaluation (f32 3+1D, each body), and the f32 cascade against
   the f64 one; then the 2+1D waves at full width (320 species of the
   decaying list, native 32 x 24 grid) on the smooth spectra of a 2+1D
   run cut to 16384 cells, timed the same way, the largest launch of each
   body against its plain version; [grad feqmod decays]
   decayed_spectra_fn with df 3 on that surface (K3 and K10a once a
   group, K2 and K9c once a wave of each body, the forward bit-equal);
   [grad decays] decayed_spectra_fn on
   the decays main path's surface: its forward bit-equal to
   do_resonance_decays of the production spectra, the pullback of a
   positive cotangent (K9a once a group, K9c once a wave of each body),
   then K9c launch by launch on the path's waves (timed beside
   kernels/decays.py:wave_backward_operations), each launch's first task
   against the plain version's autograd in f32 and f64, two launches
   bit-identical; [ensemble batch] IS3D.run_ensemble over 8 events of
   16384 cells x 320 species (2+1D df 2; one from its file, seven in
   memory), one results tree each, every row bit-equal to its single run,
   the wall time by phase;
8. the experiments at their own shapes, each through its ``measure()``:
   the spectra prototype (32768 cells x 320 x 768 x 21; its plain version
   on the first 1024 cells) and the reduction probe (176 x 48 x 320 x 768);
9. the feqmod paths: [feqmod main] a synthetic 131072-cell x 320-species
   3+1D run directory through ``cli.main`` with df 3 (shear + bulk,
   regulate, outflow, f32, native grid): launches = canonical groups, the
   results tree, the share of breakdown cells; the same CLI on a 256-cell
   run directory (bulk x 30) on cuda and on cpu (f64); [feqmod pair] one
   16384-cell group as it is and with the shear x 30 (most cells break
   down): f32 against the f64 kernel, paired times, its first 1024 cells
   against the plain version, the bound from the evaluations each chain
   makes, each chain instantiation's cells, resources and SASS per
   evaluation; [grad feqmod pair] K10a on that group as
   [grad pair] (GRAD_PAIR_PLAIN_CELLS cells, an equal share of each
   chain's part, against the plain version; the cells each chain's
   instantiation takes, and each instantiation's registers, spills,
   resident blocks an SM and SASS per evaluation), [grad feqmod main]
   diff.surface_vjp of the production df 3
   spectra (K3 and K10a once a group, the forward bit-equal, f64 central
   differences); [feqmod main 2d] the same with df 4 in 2+1D (the mT
   remap) and its pair (as it is and with the shear x 30, plain on 512
   cells), [grad feqmod pair 2d] and
   [grad feqmod main 2d] with K10b; [feqmod dndx]
   operation 0 with df 3 on 16384 cells x 320 species (2+1D) and one of
   its groups (plain on 512 cells);
10. the VAH paths: [vah main 2d] a synthetic 131072-cell x 320-species
   mode-2 (VAH) 2+1D run directory through ``cli.main`` (shear and bulk
   df on in the config, gated off: no c0..c4 columns; regulate, outflow,
   f32, the mT remap): launches of the remap kernel = groups, the results
   tree; [vah main 3d] the same in 3+1D (fixed nodes); their 256-cell
   cuda-against-cpu runs (2+1D mode 2, 3+1D mode 3); [vah pair] one group
   of each, and the 3+1D group with synthetic c0..c4 (every chain on): f32
   against the f64 kernel, paired times, plain on 512 / 1024 cells, bound
   (kernels/vah.py, vah_formula_ops), SASS; [grad vah pair] K11b and K11a
   on those three groups (with registers, spills, resident blocks an SM
   and SASS per evaluation); [grad vah main 2d] (mode 2, gated, by Lambda,
   a_L, u and dsigma) and [grad vah main 3d] (synthetic c0..c4 on every
   cell: every chain, by those and the shear, bulkPi, W, c0 and c3) as
   [grad main]; [vah dndx] operation 0 on a
   16384-cell mode-2 2+1D run, its small run and one group;
11. the polarization paths: [grad small polzn] K12a and K12b
   (csrc/polzn_bwd.cu) on every testing.POLZN_EDGES case as [grad small
   vah] (a massless species' NaN and inf where the plain version has them
   in the kernel's precision); [polzn main 2d] a synthetic 131072 x 320
   mode-5 2+1D run directory through ``cli.main`` (the remap kernel, then
   K1's remap spectra, df 2), the S*.dat files, its 256-cell
   cuda-against-cpu run; [polzn main 3d] the same in 3+1D (the fixed-node
   kernel, then K1); [polzn pair] one group of each as [vah pair]
   (kernels/polzn.py, polzn_formula_ops); [grad polzn pair] K12b and K12a
   on those groups as [grad vah pair] (five sums' positive cotangent);
   [grad polzn main 2d] and [grad polzn main 3d]: diff.surface_vjp of
   polarization_fn at full width by the vorticity, flow and dsigma (and
   eta), the observable sum of the Lambda row's Sy_over_Snorm: the
   forward bit-equal to spin_polarization, K6 and K12 once a group, f64
   central differences; [grad mode5] the spectra
   gradient of the 2+1D mode-5 surface (K1's remap and K9b once a group,
   no polarization kernel);
12. the sampler (operation 2): [sample main 2d] a synthetic 131072 x 320
   2+1D run directory through ``IS3D.from_run_dir(...)
   .run_particlization()`` (df 2, shear + bulk, f32, oversample to
   min_num_hadrons = 1.5e6): phases, the sampler's split (phase A,
   dispatch, wait, copy to the host, assembly), kept hadrons/s,
   efficiency, K7's packed mode launched once a batch, K7a three times,
   the OSCAR list; [analysis] analysis.compare_sampling_smooth of that
   run's lists (no new sampling) against [main 2d]'s spectra of the same
   surface for the pion, kaon and proton (the smooth dN/dy equal to
   [main 2d]'s dN_dy file, the sampled one within 5 sigma + 2 % of it),
   analysis.compute_observables with the run's particle table (the
   identified dN/dy within 5 sigma + 2 % of the smooth spectra's), and
   IS3D_SAMPLER_TIMINGS=1 on a 256-cell cuda run printing its one line;
   its 256-cell f64 cuda-against-cpu run (the same
   streams: the same lists; the cuda run through the packed mode);
   [sample pair] alias_scale and K7a on the species table (against its
   plain version, its byte bound and torch's stable sort of the rows),
   K7 on one batch of that shape in per-slot mode against its bound
   (kernels/sample.py, sample_formula_ops) with pack_batch's compaction
   of its output, and in packed mode against its own bound, bit for bit
   pack_batch's at the run's capacity and past it; the batch's last event
   at full width and a 16384-slot batch against its plain version;
   [sample decays]
   the same run on the decaying list with do_resonance_decays = 1 (K8
   once a pass, stable hadrons only; the MC-decay phase's split: upload,
   lookup, cascade, regroup, download) and its small runs; [cascade pair]
   K8 pass by pass on that run's events against its plain version and
   its bound (kernels/mc_decays.py, cascade_formula_ops), each pass's
   device time and the whole cascade as one call;
13. the sampler's second half: [yields small] K7b (csrc/yields.cu)
   against species_yields_plain on testing.YIELDS_EDGES (df 1-4 and VAH,
   f32 and f64, two launches and the row-sums mode bit-identical);
   [sample vah small] and [sample search small], K7's VAH and
   binary-search instantiations on testing.SAMPLE_EDGES as [sample
   small]; [yields pair] K7b on [sample main 2d]'s cells against its
   bound and the torch quadrature it replaced; [sample search 2d] that run
   with sampler_alias = 0 (K7-search only, each species' count within 5
   sigma of the alias run's), its 256-cell cuda-against-cpu run and
   [sample search pair]; [sample vah main 2d] operation 2 on [vah main
   2d]'s mode-2 surface (K7b's VAH mode, K7a, K7-VAH's packed mode; pion,
   kaon and proton dN/dy within 5 sigma + 2 % of that surface's
   operation-1 spectra), its 256-cell runs (mode 2 in 2+1D, mode 3 in
   3+1D), [yields pair vah] and [sample vah pair] (synthetic c0..c4, every
   chain on); [sample chunked] 1179648 in-memory cells (BASELINE.md's 1M
   scale) in 3 chunks and unchunked, one event each, the two counts
   within 5 sigma, their launches and peak memory, and a 256-cell run
   with sampler_cell_chunk = 64; [ensemble small] two worker processes of
   ensemble.multiprocess_oversample on this card, a removed batch rebuilt
   byte for byte by its worker resumed;
14. multi-GPU on the cell axis: [mesh] api.IS3D(mesh=) on the run
   directories of [main], [main 2d], [dndx main], [feqmod main], [vah main
   2d] and [polzn main 2d] (kept for it), and the slice-local
   smooth_spectra_multihost ([main]) and spacetime_distributions_multihost
   ([dndx main]) from process_cell_slice's columns, on W spawned ranks
   (file:// rendezvous): W = 2 and 3 with gloo, every rank on cuda:0, and W
   = 1 with NCCL.  The kernels are built by this process first, so no
   rank builds.  Every rank's spectra, distributions and polarization
   equal the one-process run's (the same API in this process) with
   torch.equal, in the W = 3 spawn rank 0's results tree is the CLI's
   one-process tree byte for byte and no other rank writes (the other
   spawns write nothing: the writers take most of a spawn's wall), and
   each rank launched exactly the
   kernels of its own canonical groups (3, 3, 2 of 8 for W = 3: the pad
   group is not launched); [mesh grad] in the W = 2 spawn
   diff.spectra_fn(mesh=) on [grad main]'s observable: every rank's
   gradient equals the one-process gradient bit for bit, from the same
   cotangent bits.  Each W prints every rank's compute seconds, the bytes
   it gathered and its gather-and-fold seconds beside the card's name and
   power limit: ranks sharing one card, so the walls prove the sharded
   path, not scaling.  A failed rank or a rank still running after
   MESH_TIMEOUT seconds fails the run.  In the W = 2 spawn also: [mesh
   events] batch.smooth_spectra_batched and batch.polarization_batched
   (mode 5) on [ensemble batch]'s 8 x 16384-cell x 320-species 2+1D
   ensemble over the event axis, every rank's rows bit-equal to one
   process and each rank launching half its kernels (4 events x the
   groups), and the gradient of the batched spectra
   (surface_value_and_grad) bit-equal, with its backward launches halved
   too;
   [mesh sample] kernels.sample.sample_particles(mesh=) on [sample main
   2d]'s surface (oversampled to MESH_SAMPLE_HADRONS), every rank's list
   byte-equal to one process's _sample_cell_chunked with 65536 cells a
   chunk, each rank launching K7b twice, K7a three times and K7's packed
   mode once a batch, the pion, kaon and proton dN/dy within 5 sigma + 2 %
   of [main 2d]'s operation-1 spectra of the same surface; [pod] two CLI
   processes with the pod keys (mesh_backend=gloo, both on this card):
   operation 1 on [main]'s run directory and operation 2 with the event
   decays on [sample decays]'s, rank 0's results tree byte-identical to
   the one-process run's.  The spawns run in MESH_STAGES: W = 2 beside
   this process's one-process references, then W = 3, W = 1 (NCCL) and
   both [pod] pairs at once, so their walls overlap.

The cpu halves of the 256-cell cuda-against-cpu runs run in the
background, one process at a time with CPU_THREADS threads, and are
compared at the end (phase_cpu_runs).  Depth cut to keep the run near
eight minutes: [pair], [remap pair] and
[dndx pair] hold the kernel to its plain version on the group's first
2048, 1024 and 1024 cells, one run each (five runs on the whole group
took 110 s and 70 s before, and one 31 s for the remap); [feqmod pair]
on 1024 cells and [vah pair] / [polzn pair] on 512 (2+1D) and 1024
(3+1D) cells (4096 for [pair], 2048 for the others until the sampler's
second half added its phases); the [grad ... pair] phases of K10 and K11
on GRAD_PAIR_PLAIN_CELLS = 128 cells (the plain autograd took 10 s on 512);
one warm run of each float64 kernel (three took ~19 s more).

Bounds: the larger of the bytes over the memory rate and the operations
over the card's FP32 and SFU rates, the spectra, dN/dX and prototype
kernels' operations from one yardstick counted in the formula
(kernels/smooth.py, FORMULA_OPS), the wave kernel's from its own
count of what its inputs need (kernels/decays.py, wave_operations), the
feqmod kernels' from theirs (kernels/feqmod.py, feqmod_formula_ops; f_mod
and the fallback counted apart, as the data has them), the VAH and
polarization kernels' from theirs (kernels/vah.py, vah_formula_ops;
kernels/polzn.py, polzn_formula_ops), the sampler's and the cascade's
from their multiply-highs on the INT32 pipe (64 lanes an SM), their
special functions and their gathers: a table that fits in the 50 MB L2
read once, a larger one a 32-byte sector a gather (kernels/sample.py,
gather_bytes, sample_formula_ops; kernels/mc_decays.py,
cascade_formula_ops), the backward kernels' from theirs
(kernels/smooth.py, backward_formula_ops; kernels/decays.py,
wave_backward_operations; kernels/feqmod.py,
feqmod_backward_formula_ops, each chain apart; kernels/vah.py,
vah_backward_formula_ops; kernels/polzn.py,
polzn_backward_formula_ops).  Before
every path (4, 5a, 6, 7a, 8, 9, 10, 11, 12, 13, and the gradients of
[grad main], [grad main 2d], [grad decays], [grad feqmod main], [grad
feqmod main 2d], [grad feqmod decays], [grad vah main 2d], [grad vah main
3d], [grad polzn main 2d], [grad polzn main 3d], [grad mode5], and on
every rank each run of [mesh] and [mesh grad]) all launch counts are set
to 0 and they are read right after it.  The line before
the last is the kernel record as JSON; the last line is ``{"ok": true,
"device": {...}}``.  Any failed phase exits nonzero before that line is
printed.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "_smoke")
MAIN_CELLS, MAIN_SPECIES = 131072, 320
MAIN_ARGS = ["device=cuda", "precision=f32", "operation=1", "dimension=3",
             "df_mode=2", "include_shear_deltaf=1", "include_bulk_deltaf=1",
             "regulate_deltaf=1", "outflow=1"]
MAIN2D_ARGS = ["device=cuda", "precision=f32", "operation=1", "dimension=2",
               "df_mode=2", "include_shear_deltaf=1", "include_bulk_deltaf=1",
               "regulate_deltaf=1", "outflow=1"]
DNDX_CELLS = 65536
DNDX_ARGS = ["device=cuda", "precision=f32", "operation=0", "dimension=2",
             "df_mode=1", "include_shear_deltaf=1", "include_bulk_deltaf=1",
             "regulate_deltaf=1", "outflow=1"]
DECAYS_ARGS = MAIN_ARGS + ["do_resonance_decays=1"]
FEQMOD_ARGS = ["device=cuda", "precision=f32", "operation=1", "dimension=3",
               "df_mode=3", "include_shear_deltaf=1", "include_bulk_deltaf=1",
               "regulate_deltaf=1", "outflow=1"]
FEQMOD2D_ARGS = ["device=cuda", "precision=f32", "operation=1",
                 "dimension=2", "df_mode=4", "include_shear_deltaf=1",
                 "include_bulk_deltaf=1", "regulate_deltaf=1", "outflow=1"]
FEQMOD_DNDX_CELLS = 16384
FEQMOD_DNDX_ARGS = ["device=cuda", "precision=f32", "operation=0",
                    "dimension=2", "df_mode=3", "include_shear_deltaf=1",
                    "include_bulk_deltaf=1", "regulate_deltaf=1", "outflow=1"]
# the cells of a group that the plain feqmod version is held to (and timed
# on) in the [feqmod pair] phase
FEQMOD_PLAIN_CELLS = 1024
DECAYS_2D_CELLS = 16384
# anisotropic hydro (modes 2-3) and spin polarization (mode 5): shear and
# bulk df on in the config, which the VAH gate drops (no c0..c4 columns,
# as on every real VAH surface)
VAH2D_ARGS = ["device=cuda", "precision=f32", "operation=1", "dimension=2",
              "include_shear_deltaf=1", "include_bulk_deltaf=1",
              "regulate_deltaf=1", "outflow=1"]
VAH3D_ARGS = ["device=cuda", "precision=f32", "operation=1", "dimension=3",
              "include_shear_deltaf=1", "include_bulk_deltaf=1",
              "regulate_deltaf=1", "outflow=1"]
VAH_DNDX_CELLS = 16384
VAH_DNDX_ARGS = ["device=cuda", "precision=f32", "operation=0",
                 "dimension=2", "include_shear_deltaf=1",
                 "include_bulk_deltaf=1", "regulate_deltaf=1", "outflow=1"]
POLZN2D_ARGS = MAIN2D_ARGS
POLZN3D_ARGS = MAIN_ARGS
# operation 2 (the sampler): the 2+1D main path at full width, oversampled
# to a few million hadrons (about 1.8e6, a 400 MB OSCAR list), and the same
# with the event-level decays on the decaying list
SAMPLE2D_ARGS = ["device=cuda", "precision=f32", "operation=2",
                 "dimension=2", "df_mode=2", "include_shear_deltaf=1",
                 "include_bulk_deltaf=1", "regulate_deltaf=1", "outflow=1",
                 "oversample=1", "min_num_hadrons=1500000",
                 "sampler_seed=17"]
SAMPLE_DECAYS_ARGS = [a for a in SAMPLE2D_ARGS
                      if not a.startswith("min_num_hadrons")] + [
                          "min_num_hadrons=600000", "do_resonance_decays=1"]
# the slots of the small batch K7 is held to its plain version on in
# [sample pair]
SAMPLE_PLAIN_SLOTS = 16384
# operation 2 on the [vah main 2d] surface (mode 2, the residual-df chains
# gated off as on every real VAH file), the same target as SAMPLE2D_ARGS
SAMPLE_VAH2D_ARGS = [a for a in VAH2D_ARGS if not a.startswith("operation")
                     ] + ["operation=2", "oversample=1",
                          "min_num_hadrons=1500000", "sampler_seed=17"]
# the cell-chunked sampler at BASELINE.md's 1M scale: 9 x 131072 cells,
# three chunks of at most 2^19 by default
CHUNKED_CELLS = 9 * MAIN_CELLS
KERNEL_SOURCES = ("smooth_spectra", "dndx", "smooth_proto", "decays",
                  "feqmod", "vah", "polzn", "sample", "mc_decays", "yields",
                  "sample_vah", "sample_search", "sample_vah_search",
                  "smooth_spectra_bwd", "decays_bwd", "feqmod_bwd",
                  "vah_bwd", "polzn_bwd")
# [mesh]: the ranks of each spawn (W, backend) and the join timeout (s);
# the main-path run directories it reuses, by phase tag: (run dir, CLI
# args, the kernels each group launches), kept by _keep until it ends
# the spawn whose rank 0 writes the results trees (held byte for byte to
# the CLI's one-process trees): the writers take most of a spawn's wall
MESH_WRITE_W = 3
# the spawns in stages: a stage's spawns run at once, the first stage's
# beside this process's one-process references, the last stage's beside
# [pod]'s CLI ranks (ranks share the card: the walls overlap, and measure
# correctness, not scaling)
MESH_STAGES = (((2, "gloo"),), ((3, "gloo"), (1, "nccl")))
MESH_TIMEOUT = 300.0
MESH_DIRS: dict = {}
# [mesh events]' inputs (kept by [ensemble batch]), [mesh sample]'s run
# directory (kept by [sample main 2d]) and its hadron target, and [pod]'s
# operation-2 run directory (kept by [sample decays])
MESH_EVENTS: dict = {}
MESH_SAMPLE: dict = {}
MESH_SAMPLE_HADRONS = 400000
POD_DIRS: dict = {}
POD_TIMEOUT = 300.0
# [trace]'s Chrome trace of [main 2d]'s CLI run (chiprun_out/ is
# gitignored), and the species [analysis] compares with the smooth spectra
TRACE_DIR = os.path.join(ROOT, "chiprun_out", "trace_main_2d")
ANALYSIS_SPECIES = (("pion", 211), ("kaon", 321), ("proton", 2212))
# H100 SXM: SMs, FP32, SFU and INT32-multiply lanes per SM, memory rate
# (bytes/s)
N_SM, FP32_LANES, SFU_LANES, HBM_RATE = 132, 128, 16, 3.35e12
INT32_LANES = 64


T_START = time.perf_counter()


def _clock(tag: str):
    """A [clock] line: the seconds since the script started, as ``tag``
    starts (the run's breakdown against its time limit)."""
    print(f"[clock] {tag} at {time.perf_counter() - T_START:.1f} s",
          flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def phase_device() -> tuple[str, float]:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0])
    print(f"[device] {smi} | max SM clock {clock:.0f} MHz | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)}")
    return smi, clock * 1e6


def phase_build():
    from is3d_tpu_torch.native import build
    t0 = time.perf_counter()
    build.build_cuda_libraries(KERNEL_SOURCES)
    for name in KERNEL_SOURCES:
        build.cuda_library(name)
    t_cuda = time.perf_counter() - t0
    t0 = time.perf_counter()
    if build.get_fastio() is None:
        fail("fastio did not build (g++ missing or failing)")
    t_fastio = time.perf_counter() - t0
    for name in KERNEL_SOURCES:
        for line in build.CUDA_BUILD_LOGS.get(name, "").splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry function" in line):
                print(f"[build] ptxas {name}: {line.strip()}")
    print(f"[build] {', '.join(f'{n}.cu' for n in KERNEL_SOURCES)} (nvcc, "
          f"in parallel) {t_cuda:.2f} s, fastio.cpp (g++) {t_fastio:.2f} s")


def _group_inputs(surface, species, grid, df_data, cfg):
    from is3d_tpu_torch.kernels.common import surface_columns, prepare_cells
    from is3d_tpu_torch.kernels.smooth import (pack_cells, spectra_flags,
                                               momentum_constants)
    cells = pack_cells(prepare_cells(surface_columns(surface, cfg), cfg,
                                     df_data), cfg)
    return (cells, momentum_constants(species, grid, cfg.dimension),
            spectra_flags(cfg, grid))


def _check(name, got, want, rtol, atol_rel):
    got, want = got.double().cpu(), want.double().cpu()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail(f"{name}: non-finite output")
    scale = want.abs().max().item()
    err = (got - want).abs()
    bad = err > rtol * want.abs() + atol_rel * scale
    max_err = err.max().item()
    rel = max_err / scale if scale else float("inf")
    print(f"[kernel vs plain] {name}: max|err| {max_err:.3e} "
          f"(max|ref| {scale:.3e}, {rel:.2e} of it) "
          f"{'ok' if not bad.any() else 'FAIL'}")
    if bad.any() or scale == 0.0:
        fail(f"{name}: kernel disagrees with the plain version "
             f"({int(bad.sum())} points outside rtol={rtol}, "
             f"atol={atol_rel}*max)")
    return max_err


def phase_small_cases():
    from is3d_tpu_torch.config import Config
    from is3d_tpu_torch.io.surface import surface_from_arrays
    from is3d_tpu_torch.io.tables import native_momentum_grid
    from is3d_tpu_torch.kernels.smooth import (smooth_spectra_cuda,
                                               smooth_spectra_plain)
    from is3d_tpu_torch import testing

    cases = []
    for dimension, remap in ((3, False), (2, False), (2, True)):
        for df_mode in (1, 2):
            for reg_out in (0, 1):
                cases.append((dimension, remap, df_mode, reg_out, False))
        cases.append((dimension, remap, 1 if remap else 2, 1, True))
    tol = {torch.float32: (2e-4, 2e-5), torch.float64: (1e-10, 1e-13)}
    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.float64):
        for i, (dimension, remap, df_mode, reg_out, baryon) in enumerate(cases):
            cfg = Config(operation=1, mode=1, dimension=dimension,
                         df_mode=df_mode, include_shear_deltaf=1,
                         include_bulk_deltaf=1, include_baryon=int(baryon),
                         include_baryondiff_deltaf=int(baryon),
                         regulate_deltaf=reg_out, outflow=reg_out)
            cells = testing.synthetic_surface_cells(777, dimension, seed=i)
            if baryon:
                rng = np.random.default_rng(i)
                cells.update(muB=rng.uniform(0.05, 0.3, 777),
                             nB=rng.uniform(0, 0.05, 777),
                             Vx=rng.normal(0, 0.02, 777),
                             Vy=rng.normal(0, 0.02, 777),
                             Vn=rng.normal(0, 0.005, 777))
            surface = surface_from_arrays(dtype=dtype, device=dev, **cells)
            grid = native_momentum_grid(dimension, n_pT=8, n_phi=6, n_y=5,
                                        n_eta=12, dtype=dtype, device=dev,
                                        eta_mT_rescale=remap)
            species = testing.synthetic_species(40, dtype=dtype, device=dev)
            df_data = testing.synthetic_deltaf_data(dtype=dtype, device=dev)
            cells_t, mom, flags = _group_inputs(surface, species, grid,
                                                df_data, cfg)
            got = smooth_spectra_cuda(cells_t, mom, flags)
            want = smooth_spectra_plain(cells_t, mom, flags)
            torch.cuda.synchronize()
            name = (f"{str(dtype)[6:]} {dimension}+1D "
                    f"{'remap' if remap else 'fixed'} df{df_mode} "
                    f"reg/out={reg_out}{' baryon+diff' if baryon else ''}")
            _check(name, got, want, *tol[dtype])


def phase_small_edges():
    """The spectra kernel's edges (testing.SPECTRA_EDGES: ragged blocking,
    exp overflow with exact zeros, light bosons, an active clip) against
    the plain version, f32 and f64, 777 cells and 40 species."""
    from is3d_tpu_torch import testing
    from is3d_tpu_torch.kernels.smooth import (smooth_spectra_cuda,
                                               smooth_spectra_plain)
    for dtype in (torch.float32, torch.float64):
        for case in testing.SPECTRA_EDGES:
            cells, mom, flags = testing.spectra_edge_inputs(
                case, n_cells=777, n_species=40, dtype=dtype, device="cuda")
            got = smooth_spectra_cuda(cells, mom, flags)
            want = smooth_spectra_plain(cells, mom, flags)
            torch.cuda.synchronize()
            seen = testing.spectra_edge_seen(case, cells, mom, flags, want)
            _check(f"{str(dtype)[6:]} edge {case} ({seen})", got, want,
                   *TOL[dtype])
            zero = want == 0
            if (got[zero] != 0).any():
                fail(f"{dtype} {case}: {int((got[zero] != 0).sum())} of the "
                     f"plain version's {int(zero.sum())} exact zeros are "
                     "nonzero in the kernel")


def phase_small_dndx_edges():
    """The dN/dX kernel's edges (testing.DNDX_EDGES) against the plain
    version, f32 and f64, 777 cells and 40 species unless the case says
    otherwise; two launches bit-identical, exact zeros kept."""
    from is3d_tpu_torch import testing
    from is3d_tpu_torch.kernels import dndx
    for dtype in (torch.float32, torch.float64):
        for case in testing.DNDX_EDGES:
            x = testing.dndx_edge_inputs(case, n_cells=777, n_species=40,
                                         dtype=dtype, device="cuda")
            got, again = dndx.dndx_cuda(*x), dndx.dndx_cuda(*x)
            want = dndx.dndx_plain(*x)
            torch.cuda.synchronize()
            seen = testing.dndx_edge_seen(case, *x, *want)
            for part, g, a, w in zip(("per cell", "dN/dy/deta"), got, again,
                                     want):
                _check(f"dndx {str(dtype)[6:]} edge {case} ({seen}) {part}",
                       g, w, *TOL[dtype])
                if not torch.equal(g, a):
                    fail(f"dndx {dtype} {case} {part}: two launches differ")
                zero = w == 0
                if (g[zero] != 0).any():
                    fail(f"dndx {dtype} {case} {part}: "
                         f"{int((g[zero] != 0).sum())} of the plain "
                         f"version's {int(zero.sum())} exact zeros are "
                         "nonzero in the kernel")


def phase_small_feqmod():
    """[feqmod small]: each feqmod entry point against its plain version on
    testing.FEQMOD_EDGES (the fixed-node kernel and the dN/dX producer on
    3+1D and 2+1D fixed nodes, the remap kernel on the 2+1D remap), f32
    and f64, 777 cells and 40 species unless the case says otherwise; two
    launches bit-identical, exact zeros kept."""
    from is3d_tpu_torch import testing
    from is3d_tpu_torch.kernels import feqmod, dndx
    n = 0
    for dtype in (torch.float32, torch.float64):
        for case in testing.FEQMOD_EDGES:
            x, rn, wcs, mom, flags, wM, wR = testing.feqmod_edge_inputs(
                case, n_cells=777, n_species=40, dtype=dtype, device="cuda")
            runs = [("spectra", ("",), lambda: (feqmod.feqmod_spectra_cuda(
                x, rn, wcs, mom, flags),), lambda: (
                feqmod.feqmod_spectra_plain(x, rn, wcs, mom, flags),))]
            if not flags.remap:
                runs.append(("dndx", (" per cell", " dN/dy/deta"),
                             lambda: dndx.dndx_feqmod_cuda(
                                 x, rn, wcs, mom, flags, wM, wR),
                             lambda: dndx.dndx_feqmod_plain(
                                 x, rn, wcs, mom, flags, wM, wR)))
            for entry, parts, kern, plain in runs:
                got, again, want = kern(), kern(), plain()
                torch.cuda.synchronize()
                seen = testing.feqmod_edge_seen(case, x, rn, wcs, mom, flags,
                                                feqmod.feqmod_spectra_plain(
                                                    x, rn, wcs, mom, flags))
                for part, g, a, w in zip(parts, got, again, want):
                    name = f"feqmod {entry}{part} {str(dtype)[6:]} {case}"
                    _check(f"{name} ({seen})", g, w, *TOL[dtype])
                    if not torch.equal(g, a):
                        fail(f"{name}: two launches differ")
                    zero = w == 0
                    if (g[zero] != 0).any():
                        fail(f"{name}: {int((g[zero] != 0).sum())} of the "
                             f"plain version's {int(zero.sum())} exact zeros "
                             "are nonzero in the kernel")
                    n += 1
    print(f"[feqmod small] {n} comparisons of the three entry points with "
          "their plain versions agree; two launches bit-identical")


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The bit pattern of a float tensor (NaN equals NaN of the same
    bits)."""
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def _check_pattern(name, got, want, rtol, atol_rel):
    """_check for outputs that hold inf or NaN by design (a massless
    species' polarization): the same NaN, +inf and -inf positions, the
    finite values within the tolerance."""
    for what, f in (("NaN", torch.isnan), ("+inf", torch.isposinf),
                    ("-inf", torch.isneginf)):
        if not torch.equal(f(got), f(want)):
            fail(f"{name}: the kernel's {what} positions differ from the "
                 "plain version's")
    fin = torch.isfinite(want)
    return _check(f"{name} [{int((~fin).sum())} non-finite values in the "
                  "same places]", got[fin], want[fin], rtol, atol_rel)


def _edge_check(name, got, again, want, tol) -> float:
    """A kernel's output on an edge case against its plain version, two
    launches bit-identical, the plain version's exact zeros kept."""
    check = _check if torch.isfinite(want).all() else _check_pattern
    err = check(name, got, want, *tol)
    if not torch.equal(_bits(got), _bits(again)):
        fail(f"{name}: two launches differ")
    zero = want == 0
    if (got[zero] != 0).any():
        fail(f"{name}: {int((got[zero] != 0).sum())} of the plain version's "
             f"{int(zero.sum())} exact zeros are nonzero in the kernel")
    return err


def phase_small_vah():
    """[vah small]: each VAH entry point (fixed_kernel, remap_kernel, and
    the dN/dX producer on the fixed-node cases) against its plain version
    on testing.VAH_EDGES, f32 and f64, 777 cells and 40 species unless the
    case says otherwise; two launches bit-identical, exact zeros kept."""
    from is3d_tpu_torch import testing
    from is3d_tpu_torch.kernels import vah, dndx
    n = 0
    for dtype in (torch.float32, torch.float64):
        for case in testing.VAH_EDGES:
            x, mom, flags, wM, wR = testing.vah_edge_inputs(
                case, n_cells=777, n_species=40, dtype=dtype, device="cuda")
            want = vah.vah_spectra_plain(x, mom, flags)
            seen = testing.vah_edge_seen(case, x, mom, flags, want)
            runs = [("spectra", ("",), lambda: (vah.vah_spectra_cuda(
                x, mom, flags),), (want,))]
            if not flags.remap:
                runs.append(("dndx", (" per cell", " dN/dy/deta"),
                             lambda: dndx.dndx_vah_cuda(x, mom, flags, wM,
                                                        wR),
                             dndx.dndx_vah_plain(x, mom, flags, wM, wR)))
            for entry, parts, kern, plain in runs:
                got, again = kern(), kern()
                torch.cuda.synchronize()
                for part, g, a, w in zip(parts, got, again, plain):
                    _edge_check(f"vah {entry}{part} {str(dtype)[6:]} {case} "
                                f"({seen})", g, a, w, TOL[dtype])
                    n += 1
    print(f"[vah small] {n} comparisons of the three entry points with "
          "their plain versions agree; two launches bit-identical; exact "
          "zeros kept")


def phase_small_polzn():
    """[polzn small]: both polarization kernels against their plain
    version on testing.POLZN_EDGES (the massless cases held to the same
    inf/NaN positions), f32 and f64, 777 cells and 40 species unless the
    case says otherwise, each of the five sums; two launches bit-identical,
    exact zeros kept."""
    from is3d_tpu_torch import testing
    from is3d_tpu_torch.kernels import polzn
    n = 0
    for dtype in (torch.float32, torch.float64):
        for case in testing.POLZN_EDGES:
            x, mom, pm, wR, flags, table = testing.polzn_edge_inputs(
                case, n_cells=777, n_species=40, dtype=dtype, device="cuda")
            want = polzn.polzn_plain(x, mom, pm, wR, flags)
            seen = testing.polzn_edge_seen(case, x, mom, pm, wR, flags, want)
            got = polzn.polzn_cuda(x, mom, pm, wR, flags, table)
            again = polzn.polzn_cuda(x, mom, pm, wR, flags, table)
            torch.cuda.synchronize()
            for part, g, a, w in zip(polzn.SUMS, got, again, want):
                _edge_check(f"polzn {part} {str(dtype)[6:]} {case} ({seen})",
                            g, a, w, TOL[dtype])
                n += 1
    print(f"[polzn small] {n} comparisons of the two kernels' five sums "
          "with their plain version agree; two launches bit-identical; "
          "exact zeros kept; the massless species' inf/NaN in place")


def phase_small_bins():
    """The binning kernel's edges (testing.BIN_EDGES: empty bins, a bin of
    every cell, bins longer and shorter than one slice) against its plain
    version, f32 and f64; two launches bit-identical."""
    from is3d_tpu_torch.kernels import dndx
    from is3d_tpu_torch import testing
    for dtype in (torch.float32, torch.float64):
        for case in testing.BIN_EDGES:
            per_cell, plan = testing.bin_edge_inputs(case, dtype=dtype,
                                                     device="cuda")
            got = dndx.dndx_bin_cuda(per_cell, plan)
            again = dndx.dndx_bin_cuda(per_cell, plan)
            want = dndx.dndx_bin_plain(per_cell, plan)
            torch.cuda.synchronize()
            counts = torch.diff(plan.start).cpu()
            _check(f"dndx_bin {str(dtype)[6:]} {case}: "
                   f"{per_cell.shape[0]} cells, {int((counts == 0).sum())} "
                   f"empty of {plan.n_bins} bins, longest "
                   f"{int(counts.max())} entries", got, want, *TOL[dtype])
            if not torch.equal(got, again):
                fail(f"dndx_bin {case}: two launches differ")


def phase_small_decay_edges():
    """The wave kernel's edges (testing.DECAY_EDGES: 2- and 3-body, 2+1D and
    3+1D; MT past the grid, Phi wrap, |Y| > y_max with exact zeros,
    massless daughters, adjusted masses, a row fed by many tasks, a parent
    at the floor, stencils that are not consecutive on a stretched y grid)
    against the plain version, f32 and f64; two launches bit-identical,
    exact zeros kept."""
    from is3d_tpu_torch import testing
    from is3d_tpu_torch.kernels import decays
    for dtype in (torch.float32, torch.float64):
        for case in testing.DECAY_EDGES:
            tables, tasks, wg, n_seg = testing.decay_edge_inputs(
                case, dtype=dtype, device="cuda")
            shape = (n_seg,) + tables.logdN.shape[1:]
            got = torch.zeros(shape, dtype=torch.float64, device="cuda")
            again = torch.zeros_like(got)
            decays.decay_wave_cuda(tables, tasks, wg, got)
            decays.decay_wave_cuda(tables, tasks, wg, again)
            want = decays.wave_plain(tables, tasks, wg, n_seg).double()
            torch.cuda.synchronize()
            seen = testing.decay_edge_seen(case, tables, tasks, wg, n_seg,
                                           want)
            _check(f"decay_wave {str(dtype)[6:]} edge {case} ({seen})", got,
                   want, *TOL[dtype])
            if not torch.equal(got, again):
                fail(f"decay_wave {dtype} {case}: two launches differ")
            zero = want == 0
            if (got[zero] != 0).any():
                fail(f"decay_wave {dtype} {case}: "
                     f"{int((got[zero] != 0).sum())} of the plain version's "
                     f"{int(zero.sum())} exact zeros are nonzero")


def _run_cli(argv):
    from is3d_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    phases = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^\[is3d_tpu_torch\] (.+?): ([0-9.]+) s$", out, re.M)}
    return rc, phases, out


def _results_ok(results, mcids, n_y):
    for rel in (["dN_pTdpTdphidy.dat"]
                + [f"{p}_{m}.dat" for m in mcids
                   for p in ("dN_pTdpTdphidy", "dN_dy", "dN_dphidy",
                             "dN_twopipTdpTdy", "vn_continuous/vn")]):
        if not os.path.isfile(os.path.join(results, rel)):
            fail(f"missing writer output {rel}")
    pion = np.loadtxt(os.path.join(results, "dN_pTdpTdphidy_211.dat"),
                      skiprows=1)
    if pion.shape != (n_y * 24 * 32, 4):
        fail(f"pion spectra file has shape {pion.shape}")
    # every contribution is >= 0 with outflow and regulated df; at y = 0
    # every (pT, phi) bin has cells close enough in rapidity to be > 0
    mid = pion[pion[:, 0] == 0.0, 3]
    if not (np.isfinite(pion).all() and (pion[:, 3] >= 0).all()
            and mid.size == 24 * 32 and (mid > 0).all()):
        fail("pion spectra are not finite, non-negative and positive at y=0")


def phase_main_path(smi: str, name="main", dimension=3, args=MAIN_ARGS,
                    n_nodes=21, want=None, decays=False, mode=1):
    """One operation-1 CLI run at full size: 3+1D (21 rapidities) or 2+1D
    (48 eta nodes, mT remap), with ``decays`` on the decaying synthetic
    list and do_resonance_decays = 1, on a surface of ``mode`` (1, 2, 3 or
    5: testing.write_synthetic_run_dir).  ``want``: the kernels the run
    must launch once per canonical group (default: the spectra kernel);
    with ``decays`` also the wave kernel once per wave that has tasks of
    its body; mode 5 also writes the polarization files."""
    from is3d_tpu_torch.config import load_config
    from is3d_tpu_torch.parallel.mesh import canonical_groups
    from is3d_tpu_torch.io.pdg import load_chosen_mcids
    from is3d_tpu_torch.testing import write_synthetic_run_dir

    run_dir = os.path.join(WORK, name.replace(" ", "_"))
    t0 = time.perf_counter()
    write_synthetic_run_dir(run_dir, MAIN_CELLS, MAIN_SPECIES,
                            dimension=dimension, seed=0, decays=decays,
                            mode=mode)
    print(f"[{name}] synthetic run dir {MAIN_CELLS} cells x {MAIN_SPECIES} "
          f"species written in {time.perf_counter() - t0:.2f} s")

    _reset_counts()
    t0 = time.perf_counter()
    rc, phases, out = _run_cli([run_dir] + args)
    wall = time.perf_counter() - t0
    counts = _counts()
    # the CLI's output without its config echo ("  key = value")
    print("\n".join(f"[{name}] cli: " + l for l in out.splitlines()
                    if " = " not in l))
    if rc != 0:
        fail(f"cli exited {rc}")
    cfg = load_config(os.path.join(run_dir, "iS3D_parameters.dat"),
                      overrides=dict(a.split("=", 1) for a in args[1:]))
    groups, _ = canonical_groups(cfg, MAIN_CELLS)
    mcids = load_chosen_mcids(os.path.join(
        run_dir, "PDG", "chosen_particles_urqmd_v3.3+.dat"))
    expect = {k: groups for k in want or ("smooth_spectra",)}
    if decays:
        # one launch per wave that has tasks of each body
        sched = _main_decays_schedule()
        expect.update(decay_wave_2body=sched["waves_2body"],
                      decay_wave_3body=sched["waves_3body"])
    _expect_counts(f"{name} path", counts, expect)
    if len(mcids) != MAIN_SPECIES:
        fail(f"{len(mcids)} chosen species")
    _results_ok(os.path.join(run_dir, "results"), mcids,
                n_y=n_nodes if dimension == 3 else 1)
    if mode == 5:
        _polzn_results_ok(os.path.join(run_dir, "results"), mcids,
                          n_y=n_nodes if dimension == 3 else 1, tag=name)
    if decays:
        _decay_results_ok(os.path.join(run_dir, "results"), mcids, n_nodes,
                          out)
    evals = MAIN_CELLS * MAIN_SPECIES * 32 * 24 * n_nodes
    t_spec = phases["smooth spectra"]
    pol = (f", polarization {phases['spin polarization']:.3f} s (writers "
           f"{phases['polarization writers']:.3f} s)" if mode == 5 else "")
    print(f"[{name}] {smi} | prepare "
          f"{phases['prepare (io, pdg, deltaf)']:.3f} s{pol}"
          f", spectra {t_spec:.3f} s, writers {phases['writers']:.3f} s, "
          f"cli wall {wall:.3f} s | {evals:.3e} evaluations, "
          f"{evals / t_spec:.3e} evaluations/s | launches "
          + ", ".join(f"{k} {counts[k]}" for k in want or ("smooth_spectra",))
          + f" = groups {groups}")
    if decays:
        print(f"[{name}] {smi} | phases: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in phases.items()) + " | launches "
            + ", ".join(f"{k} {counts[k]}" for k in
                        ("decay_wave_2body", "decay_wave_3body")))
    return counts, run_dir, cfg, phases


def phase_trace(smi: str, run_dir: str, args, launches: int):
    """[trace]: [main 2d]'s CLI run again inside utils.device_trace (CUDA
    activity), its Chrome trace written into TRACE_DIR and read by
    tools/trace_summary.py.  Fails unless the trace holds device events,
    its remap-kernel launches equal the run's counted launches and those
    ``launches`` (one a canonical group), and the run's results tree is
    [main 2d]'s byte for byte (then removed: no later phase reads it).
    Prints the traced window, the card's busy seconds (the union of its
    kernel, memcpy and memset intervals), the idle share, the five kernels
    with the most device time and the trace's size, beside the card's name
    and power limit."""
    from is3d_tpu_torch.tools import trace_summary
    from is3d_tpu_torch.utils import device_trace
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    results = os.path.join(run_dir, "results")
    _reset_counts()
    t0 = time.perf_counter()
    with device_trace(TRACE_DIR):
        rc, phases, _ = _run_cli([run_dir] + args)
    wall = time.perf_counter() - t0
    counts = _counts()
    if rc != 0:
        fail(f"[trace] cli exited {rc}")
    _expect_counts("[trace] path", counts, dict(
        smooth_spectra=launches, smooth_spectra_remap=launches))
    files = [f for f in os.listdir(TRACE_DIR) if f.endswith(".pt.trace.json")]
    if len(files) != 1:
        fail(f"[trace] {len(files)} trace files in {TRACE_DIR}")
    path = os.path.join(TRACE_DIR, files[0])
    s = trace_summary.summarize(path)
    if not s["device_events"]:
        fail("[trace] the trace holds no kernel, memcpy or memset: the "
             "profiler recorded no CUDA activity")
    remap = sum(k["count"] for name, k in s["kernels"].items()
                if re.search(r"(?<!\w)remap_kernel<", name))
    if remap != launches:
        fail(f"[trace] {remap} remap_kernel launches in the trace, the run "
             f"counted {launches}")
    if _tree_bytes(results) != _tree_bytes(os.path.join(
            run_dir, "results_mesh_one")):
        fail("[trace] the traced run's results tree differs from "
             "[main 2d]'s")
    shutil.rmtree(results)
    print(f"[trace] {smi} | traced window {s['window_s']:.3f} s (the "
          f"traced call's host wall {wall:.3f} s; cli phases: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())
          + f") | card busy {s['busy_s']:.4f} s ({s['device_events']} "
          f"kernel, memcpy and memset intervals, their union), idle share "
          f"{100.0 * s['idle_share']:.2f} % | remap_kernel {remap} "
          f"launches = counted {launches} | trace {s['bytes']} B, "
          f"{os.path.relpath(path, ROOT)}; results tree byte-equal to "
          "[main 2d]'s")
    for name, sec, n in trace_summary.top_kernels(s, 5):
        print(f"[trace] {smi} | top kernel {1e3 * sec:.3f} ms in {n} "
              f"launches: {name[:120]}")


def _main_decays_schedule() -> dict:
    """The schedule of the [decays main] list as is3d_tpu counts it
    (testing.DECAYS_MAIN_SCHEDULE, held to is3d_tpu's own schedule by the
    CPU tests), not as the port's schedule, which drives the launches."""
    from is3d_tpu_torch.testing import DECAYS_MAIN_SCHEDULE as want
    if (want["n_species"], want["seed"]) != (MAIN_SPECIES, 0):
        fail(f"testing.DECAYS_MAIN_SCHEDULE is for {want['n_species']} "
             f"species, seed {want['seed']}")
    return want


def _decay_results_ok(results, mcids, n_y, out):
    """The decay files exist, are finite and non-negative, every species
    gains or keeps (feed-down only adds) and the pions gain; the CLI
    printed the channel contributions and waves of the list's schedule."""
    m = re.search(r"Resonance decays: (\d+) channel-contributions added in "
                  r"(\d+) waves", out)
    want = _main_decays_schedule()
    if not m or (int(m.group(1)), int(m.group(2))) != (
            want["channel_contributions"], want["waves"]):
        fail(f"the decays run printed {m and m.group(0)!r}, not "
             f"{want['channel_contributions']} channel contributions in "
             f"{want['waves']} waves")
    for mcid in mcids:
        if not os.path.isfile(os.path.join(
                results, f"dN_pTdpTdphidy_{mcid}_resonance_decays.dat")):
            fail(f"missing dN_pTdpTdphidy_{mcid}_resonance_decays.dat")
    table = np.loadtxt(os.path.join(results,
                                    "dN_dpTdphidy_resonance_decays.dat"),
                       skiprows=1)
    if (table.shape != (len(mcids) * n_y * 24 * 32, 4)
            or not np.isfinite(table).all() or (table[:, 3] < 0).any()):
        fail(f"dN_dpTdphidy_resonance_decays.dat: shape {table.shape}, "
             "or values not finite and non-negative")
    gain = {}
    for mcid in (211, 22):
        a, b = (np.loadtxt(os.path.join(results, f"dN_pTdpTdphidy_{mcid}"
                                        f"{sfx}.dat"), skiprows=1)[:, 3]
                for sfx in ("", "_resonance_decays"))
        if not (np.isfinite(b).all() and (b >= a).all() and (b > a).any()):
            fail(f"{mcid}: the decayed spectrum is not finite and above the "
                 "smooth one")
        gain[mcid] = b.sum() / max(a.sum(), 1e-300)
    print(f"[decays main] {m.group(1)} channel contributions in "
          f"{m.group(2)} waves; decayed/smooth yield on the grid: pi+ "
          f"{gain[211]:.4f}, photon {gain[22]:.3e}")


# the cpu halves of the small cuda-against-cpu runs: a background thread
# runs them one at a time, each in a process of its own with CPU_THREADS
# threads, beside the rest of the script; phase_cpu_runs waits for them
# and compares, _stop_cpu_runs ends whatever is left
CPU_THREADS = 3
_cpu_jobs: list = []
_cpu_procs: list = []
_cpu_pool = None


def _cpu_run(argv) -> tuple:
    """(exit code, stderr's end) of the CLI on the cpu in a process of its
    own, this checkout's package first on its path."""
    env = dict(os.environ, OMP_NUM_THREADS=str(CPU_THREADS),
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.Popen([sys.executable, "-m", "is3d_tpu_torch", *argv],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)
    _cpu_procs.append(proc)
    _, err = proc.communicate(timeout=900)
    return proc.returncode, err[-3000:]


def phase_small_path_cpu_vs_cuda(name="small", dimension=3, params=None,
                                 args=("df_mode=2", "regulate_deltaf=1"),
                                 label="3+1D df2", n_species=11,
                                 decays=False, scale_bulk=1.0, mode=1):
    """The whole CLI path on cuda and on cpu, f64, on a small run dir
    written twice (the same seed): the cuda run here, the cpu run queued
    to the background (phase_cpu_runs compares the two trees)."""
    global _cpu_pool
    from concurrent.futures import ThreadPoolExecutor
    from is3d_tpu_torch.testing import write_synthetic_run_dir
    run_dir = os.path.join(WORK, name)
    for d in (run_dir, run_dir + "_cpu"):
        write_synthetic_run_dir(d, 256, n_species, dimension=dimension,
                                seed=1, params=params, decays=decays,
                                scale_bulk=scale_bulk, mode=mode)
    argv = lambda d, device: [d, f"device={device}", "precision=f64", *args]
    if _cpu_pool is None:
        _cpu_pool = ThreadPoolExecutor(max_workers=1)
    future = _cpu_pool.submit(_cpu_run, argv(run_dir + "_cpu", "cpu"))
    rc, _, _ = _run_cli(argv(run_dir, "cuda"))
    if rc != 0:
        fail(f"{name} run on cuda exited {rc}")
    _cpu_jobs.append((name, label, n_species, future,
                      os.path.join(run_dir, "results"),
                      os.path.join(run_dir + "_cpu", "results")))


def phase_cpu_runs():
    """Wait for the cpu halves of the small runs and hold each cuda tree to
    its cpu tree: every file, every number within 1e-6 relative (and
    1e-6 of the file's largest value)."""
    for name, label, n_species, future, cuda_tree, cpu_tree in _cpu_jobs:
        rc, err = future.result()
        if rc != 0:
            fail(f"{name} run on cpu exited {rc}:\n{err}")
        n_files = worst = 0
        for d, _, files in os.walk(cpu_tree):
            for f in files:
                a = os.path.join(d, f)
                va, vb = _values(a), _values(a.replace(cpu_tree, cuda_tree))
                err = np.abs(va - vb)
                if va.shape != vb.shape or (
                        err > 1e-6 * np.abs(va)
                        + 1e-6 * np.abs(va).max()).any():
                    fail(f"{name} run: {os.path.relpath(a, cpu_tree)} "
                         "differs between cuda and cpu beyond 1e-6")
                worst = max(worst, float(err.max() / np.abs(va).max()))
                n_files += 1
        print(f"[{name} path] 256 cells x {n_species} species {label} f64: "
              f"{n_files} result files agree between cuda and cpu (max "
              f"difference {worst:.2e} of each file's largest value)")
        if n_files == 0:
            fail(f"{name} run wrote no result files")
    _cpu_jobs.clear()


def _stop_cpu_runs():
    """End the background cpu runs: the queued ones cancelled, a running
    one killed and waited for."""
    global _cpu_pool
    for job in _cpu_jobs:
        job[3].cancel()
    for proc in _cpu_procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if _cpu_pool is not None:
        _cpu_pool.shutdown(wait=True, cancel_futures=True)
        _cpu_pool = None


def _values(path):
    """The numbers of a results file (header words skipped)."""
    vals = []
    for tok in open(path).read().split():
        try:
            vals.append(float(tok))
        except ValueError:
            pass
    return np.asarray(vals)


def phase_pair(smi: str, clock: float, run_dir: str, cfg, tag="pair",
               plain_cells=2048):
    """The spectra kernel on one canonical group (16384 cells) of a
    main-path surface, f32, at the grid and the split the main path
    launches: two launches bit-identical; on the group's first
    ``plain_cells`` cells agreement with the plain version and both f32
    versions against the f64 kernel (the kernel's difference at most 3x
    the plain version's); times (the kernel one warm-up, median of 5; the
    plain version's one run, tens of seconds a whole group), bound,
    instructions per evaluation."""
    from is3d_tpu_torch.api import IS3D
    from is3d_tpu_torch.utils import cuda_median_ms
    from is3d_tpu_torch.kernels import smooth
    from is3d_tpu_torch.kernels.common import surface_columns, prepare_cells
    from is3d_tpu_torch.parallel.mesh import canonical_groups

    run = IS3D(cfg, data_dir=run_dir, device="cuda")
    _, df_data, species, _, grid = run._prepare()
    cols = surface_columns(run.surface, cfg)
    _, gs = canonical_groups(cfg, run.surface.n_cells)
    group = {k: v[:gs] for k, v in cols.items()}
    cells = smooth.pack_cells(prepare_cells(group, cfg, df_data), cfg)
    mom = smooth.momentum_constants(species, grid, cfg.dimension)
    mom64 = mom.to(dtype=torch.float64)
    flags = smooth.spectra_flags(cfg, grid)
    # as smooth_spectra gives it: the node table built once for all groups
    table = smooth.remap_node_table(mom) if flags.remap else None
    kern = lambda: smooth.smooth_spectra_cuda(cells, mom, flags, table)
    got, again = kern(), kern()
    if not torch.equal(got, again):
        fail(f"smooth_spectra ({tag}): two launches on the same group differ")
    n = plain_cells
    cs = cells[:n].contiguous()
    want, p_ms = _timed_once(lambda: smooth.smooth_spectra_plain(
        cs, mom, flags, cfg.cell_chunk))
    got_n = smooth.smooth_spectra_cuda(cs, mom, flags, table)
    nodes = grid.n_eta if cfg.dimension == 2 else 1
    path = "2+1D mT remap" if flags.remap else f"{cfg.dimension}+1D"
    max_err = _check(f"float32 {path} main-path group, its first {n} cells "
                     f"({tuple(got.shape)} out)", got_n, want, 2e-4, 2e-5)
    # both float32 versions against the float64 kernel on the same inputs
    ref = smooth.smooth_spectra_cuda(cs.double(), mom64, flags)
    share = lambda a: ((a.double() - ref).abs().max() / ref.abs().max()).item()
    k_share, p_share = share(got_n), share(want)
    print(f"[{tag}] float32 against the float64 kernel on the group's first "
          f"{n} cells, largest difference as a share of the largest value: "
          f"kernel {k_share:.2e}, plain {p_share:.2e}")
    if k_share > 3.0 * p_share:
        fail(f"smooth_spectra ({tag}): float32 differs from the float64 "
             "kernel by more than 3x the float32 plain version's difference")
    del ref, want
    k_ms, k_all = cuda_median_ms(kern)
    evals = cells.shape[0] * got.numel() * nodes
    ops = (smooth.remap_formula_ops(cfg.df_mode, grid.n_phi) if flags.remap
           else smooth.FORMULA_OPS[cfg.df_mode])
    bound = _bound(evals, *ops, _nbytes(cells, got, *mom_tensors(mom)), clock)
    kernel = f"spectra_kernelIfLi{cfg.dimension}ELi{cfg.df_mode}E"
    if flags.remap:
        width = smooth.remap_grid(
            smooth._spectra_library(), cells.device, False, *got.shape[:3],
            nodes, cfg.df_mode).phi_width
        kernel = f"remap_kernelIfLi{cfg.df_mode}ELi{width}E"
    print(f"[{tag}] {smi} | one group {cells.shape[0]} cells x "
          f"{tuple(got.shape)} x {nodes} nodes ({path}, df {cfg.df_mode}): "
          f"kernel {k_ms:.3f} ms (runs "
          f"{', '.join(f'{t:.2f}' for t in k_all)}), plain {p_ms:.3f} ms on "
          f"the group's first {n} cells (one run), "
          f"kernel {evals / k_ms * 1e3:.3e} evaluations/s; bound "
          f"{bound[0]:.3f} ms ({bound[1]}), kernel at "
          f"{bound[0] / k_ms:.1%} of it; two launches bit-identical; "
          "issued per evaluation: " + _issued("smooth_spectra", kernel))
    return dict(launches=None, max_abs_err=max_err, ms=k_ms, plain_ms=p_ms,
                bound_ms=bound[0], bound_by=bound[1], library_ms=None,
                cells=cells.shape[0], plain_cells=n)


def _feqmod_run(run_dir: str, cfg):
    """(surface columns, species, grid, df_data) of a run directory on the
    card, as the CLI prepares them."""
    from is3d_tpu_torch.api import IS3D
    from is3d_tpu_torch.kernels.common import surface_columns
    run = IS3D(cfg, data_dir=run_dir, device="cuda")
    _, df_data, species, _, grid = run._prepare()
    return surface_columns(run.surface, cfg), species, grid, df_data


def _feqmod_share(tag: str, run_dir: str, cfg):
    """Print the share of a run's cells that break down (and, in 3+1D, that
    may take the narrow mask: detA < 0.01)."""
    from is3d_tpu_torch.io.tables import laguerre_device
    from is3d_tpu_torch.kernels import feqmod
    from is3d_tpu_torch.kernels.common import prepare_cells
    cols, _, _, df_data = _feqmod_run(run_dir, cfg)
    c = feqmod.feqmod_transform(prepare_cells(cols, cfg, df_data),
                                laguerre_device(dtype=cols["tau"].dtype,
                                                device="cuda"), cfg)
    bd = c["breakdown"]
    narrow = (~bd) & (c["detA"] < feqmod.NARROW_DETA)
    print(f"[{tag}] {int(bd.sum())} of {bd.numel()} cells break down "
          f"({bd.double().mean().item():.2%}), {int(narrow.sum())} have "
          f"detA < 0.01 without breaking down; detA in "
          f"[{c['detA'].min().item():.4f}, {c['detA'].max().item():.4f}]")


def _feqmod_evals(x, mom, flags) -> tuple[float, float]:
    """(f_mod, fallback) evaluations of a launch on the packed cells x: a
    breakdown cell evaluates only the fallback, and a 3+1D cell with detA
    < 0.01 also at the nodes where |y - eta| < detA."""
    from is3d_tpu_torch.kernels.feqmod import FQ, NARROW_DETA
    S, M, R = mom.mass.shape[0], mom.px.shape[0], mom.nodes.shape[0]
    bd = x[:, FQ["bd"]] > 0
    fb_nodes = bd.double() * R
    if flags.dimension == 3:
        detA, eta = x[:, FQ["detA"]], x[:, FQ["eta"]]
        narrow = (((~bd) & (detA < NARROW_DETA))[:, None]
                  & ((mom.nodes[None, :] - eta[:, None]).abs()
                     < detA[:, None]))
        fb_nodes = fb_nodes + narrow.sum(1)
    fb = fb_nodes.sum().item() * S * M
    return x.shape[0] * R * S * M - fb, fb


def _feqmod_bound(x, mom, flags, nbytes: int, clock: float):
    """The bound of a feqmod launch from the evaluations this input makes
    of each chain (kernels/feqmod.py: feqmod_formula_ops)."""
    from is3d_tpu_torch.kernels import feqmod
    mod, fb = _feqmod_evals(x, mom, flags)
    ops = [feqmod.feqmod_formula_ops(flags.df_mode, flags.remap, mom.n_phi,
                                     fallback) for fallback in (False, True)]
    evals = mod + fb
    fp32 = (mod * ops[0][0] + fb * ops[1][0]) / evals
    sfu = (mod * ops[0][1] + fb * ops[1][1]) / evals
    return _bound(evals, fp32, sfu, nbytes, clock), evals, fb / evals


def _scaled_group(cols: dict, n: int, shear: float) -> dict:
    """The first n cells of a run's columns with the shear stress x
    ``shear`` (a strong shear breaks the momentum transform down through
    detA and keeps T_mod, a function of the bulk pressure, as it was)."""
    g = {k: v[:n] for k, v in cols.items()}
    for k in ("pixx", "pixy", "pixn", "piyy", "piyn"):
        g[k] = g[k] * shear
    return g


def phase_feqmod_pair(smi: str, clock: float, run_dir: str, cfg, tag: str,
                      plain_cells=FEQMOD_PLAIN_CELLS):
    """[feqmod pair]: a feqmod spectra kernel on one canonical group (16384
    cells) of a main-path surface as it is, and with the shear stress x 30
    (most cells break down), f32: the float64 kernel on the same cells,
    two launches bit-identical, the group's first ``plain_cells`` cells
    held against the plain version; paired CUDA-event times (f32, f64; one
    warm-up, median of 5, and one warm run), the plain version's one run on those
    cells, the bound from the evaluations of each chain, the kernel's
    instructions per evaluation.  Returns the record of each kind."""
    from is3d_tpu_torch.io.tables import laguerre_device
    from is3d_tpu_torch.kernels import feqmod
    from is3d_tpu_torch.kernels.smooth import (momentum_constants,
                                               remap_node_table)
    from is3d_tpu_torch.parallel.mesh import canonical_groups
    from is3d_tpu_torch.utils import cuda_median_ms

    cols, species, grid, df_data = _feqmod_run(run_dir, cfg)
    _, gs = canonical_groups(cfg, cols["tau"].shape[0])
    flags = feqmod.feqmod_flags(cfg, grid)
    mom = momentum_constants(species, grid, cfg.dimension)
    f64 = dict(species=species.to(dtype=torch.float64),
               df_data=df_data.to(dtype=torch.float64),
               mom=mom.to(dtype=torch.float64),
               lag=laguerre_device(dtype=torch.float64, device="cuda"))
    lag = laguerre_device(dtype=torch.float32, device="cuda")
    table = remap_node_table(mom) if flags.remap else None
    table64 = remap_node_table(f64["mom"]) if flags.remap else None
    # one instantiation a chain (csrc/feqmod.cu), the narrow cells' only at
    # 3+1D fixed nodes
    chains = range(3 if cfg.dimension == 3 and not flags.remap else 2)
    records = {}
    for kind, shear in (("clean", 1.0), ("most", 30.0)):
        group = _scaled_group(cols, gs, shear)
        x, rn, wcs = feqmod.group_inputs(group, species, lag, df_data, cfg,
                                         flags)
        x64, rn64, wcs64 = feqmod.group_inputs(
            {k: v.double() for k, v in group.items()}, f64["species"],
            f64["lag"], f64["df_data"], cfg, flags)
        kern = lambda: feqmod.feqmod_spectra_cuda(x, rn, wcs, mom, flags,
                                                  table)
        kern64 = lambda: feqmod.feqmod_spectra_cuda(x64, rn64, wcs64,
                                                    f64["mom"], flags,
                                                    table64)
        got, again, ref = kern(), kern(), kern64()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"{tag} {kind}: two launches on the same group differ")
        f32_share = ((got.double() - ref).abs().max()
                     / ref.abs().max()).item()
        n = plain_cells
        xs, rns, wcss = (t[:n].contiguous() for t in (x, rn, wcs))
        kslice = lambda: feqmod.feqmod_spectra_cuda(xs, rns, wcss, mom, flags,
                                                    table)
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        want = feqmod.feqmod_spectra_plain(xs, rns, wcss, mom, flags,
                                           cfg.cell_chunk)
        t1.record()
        t1.synchronize()
        p_ms = t0.elapsed_time(t1)
        err = _check(f"{tag} {kind} float32, the group's first {n} cells",
                     kslice(), want, 2e-4, 2e-5)
        del want, ref
        k_ms, k_all = cuda_median_ms(kern)
        # one run: it is warm, and its runs spread under 1 %
        k64_ms, k64_all = cuda_median_ms(kern64, 1)
        ks_ms, _ = cuda_median_ms(kslice, 3)
        bound, evals, fb_share = _feqmod_bound(
            x, mom, flags, _nbytes(x, rn, wcs, got, *mom_tensors(mom)), clock)
        bd = (x[:, feqmod.FQ["bd"]] > 0).double().mean().item()
        print(f"[{tag}] {smi} | {kind}: one group {x.shape[0]} cells x "
              f"{tuple(got.shape)} ({bd:.1%} of cells break down, "
              f"{fb_share:.1%} of {evals:.3e} evaluations take the "
              f"fallback): kernel {k_ms:.3f} ms (runs "
              f"{', '.join(f'{t:.2f}' for t in k_all)}), float64 kernel "
              f"{k64_ms:.3f} ms (runs "
              f"{', '.join(f'{t:.1f}' for t in k64_all)}); float32 against float64 {f32_share:.2e} of the largest "
              f"value; on the first {n} cells kernel {ks_ms:.3f} ms, plain "
              f"{p_ms:.1f} ms (one run); bound {bound[0]:.3f} ms "
              f"({bound[1]}), kernel at {bound[0] / k_ms:.1%} of it; two "
              "launches bit-identical")
        _, offs = feqmod.chain_split(x, cfg.dimension)
        offs = offs.tolist()
        for i in chains:
            kern = feqmod.chain_kernel_name(flags, i, mom.n_phi)
            print(f"[{tag}] {kind}: {feqmod.CHAINS[i]} "
                  f"({offs[i + 1] - offs[i]} cells), {kern}: "
                  f"{feqmod.chain_props(x.device, False, flags, i, mom.n_phi)}"
                  "; issued per evaluation: " + _issued("feqmod", kern))
        records[kind] = dict(launches=None, max_abs_err=err, ms=k_ms,
                             plain_ms=p_ms, bound_ms=bound[0],
                             bound_by=bound[1], library_ms=None, cells=gs,
                             plain_cells=n, kernel_ms_on_plain_cells=ks_ms,
                             f64_ms=k64_ms, breakdown_share=bd,
                             fallback_share=fb_share)
    return records


def phase_feqmod_dndx_pair(smi: str, clock: float, run_dir: str, cfg,
                           plain_cells=512):
    """[feqmod dndx]: the dN/dX kernel's feqmod producer on one canonical
    group of that run, f32: two launches bit-identical, its first
    ``plain_cells`` cells held against the plain version, times, bound."""
    import dataclasses
    from is3d_tpu_torch.io.tables import laguerre_device
    from is3d_tpu_torch.kernels import dndx, feqmod
    from is3d_tpu_torch.kernels.smooth import momentum_constants
    from is3d_tpu_torch.parallel.mesh import canonical_groups
    from is3d_tpu_torch.utils import cuda_median_ms

    cols, species, grid, df_data = _feqmod_run(run_dir, cfg)
    grid = dataclasses.replace(grid, eta_mT_rescale=False)
    _, gs = canonical_groups(cfg, cols["tau"].shape[0])
    flags = feqmod.feqmod_flags(cfg, grid)
    mom = momentum_constants(species, grid, cfg.dimension)
    wM = dndx.momentum_weights(grid, cfg)
    wR = dndx.node_weights(grid, cfg.dimension)
    x, rn, wcs = feqmod.group_inputs(
        {k: v[:gs] for k, v in cols.items()}, species,
        laguerre_device(dtype=torch.float32, device="cuda"), df_data, cfg,
        flags)
    kern = lambda: dndx.dndx_feqmod_cuda(x, rn, wcs, mom, flags, wM, wR)
    got, again = kern(), kern()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail("dndx feqmod: two launches on the same group differ")
    n = plain_cells
    xs, rns, wcss = (t[:n].contiguous() for t in (x, rn, wcs))
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    want = dndx.dndx_feqmod_plain(xs, rns, wcss, mom, flags, wM, wR,
                                  cfg.cell_chunk)
    t1.record()
    t1.synchronize()
    p_ms = t0.elapsed_time(t1)
    part = dndx.dndx_feqmod_cuda(xs, rns, wcss, mom, flags, wM, wR)
    err = max(_check(f"dndx feqmod float32, the group's first {n} cells, "
                     "per cell", part[0], want[0], 2e-4, 2e-5),
              _check(f"dndx feqmod float32, the group's first {n} cells, "
                     "dN/dy/deta", part[1], want[1], 2e-4, 2e-5))
    k_ms, k_all = cuda_median_ms(kern)
    bound, evals, fb_share = _feqmod_bound(
        x, mom, flags, _nbytes(x, rn, wcs, wM, wR, *got, *mom_tensors(mom)),
        clock)
    print(f"[feqmod dndx] {smi} | one group {x.shape[0]} cells x "
          f"{mom.mass.shape[0]} x {wM.shape[0]} x {wR.shape[0]} "
          f"({fb_share:.1%} of {evals:.3e} evaluations take the fallback): "
          f"kernel {k_ms:.3f} ms (runs {', '.join(f'{t:.2f}' for t in k_all)}"
          f"), plain {p_ms:.1f} ms on its first {n} cells (one run); bound "
          f"{bound[0]:.3f} ms ({bound[1]}), kernel at "
          f"{bound[0] / k_ms:.1%} of it; two launches bit-identical; issued "
          "per evaluation: " + _issued(
              "dndx", "percell_kernelIfNS_14FeqmodProducerIf"
              f"Li{cfg.dimension}E"))
    return dict(launches=None, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                bound_ms=bound[0], bound_by=bound[1], library_ms=None,
                cells=gs, plain_cells=n)


def _issued(library: str, kernel: str) -> str:
    """Instructions per evaluation in the SASS of the first kernel of
    ``library`` whose mangled name matches ``kernel`` (tools/sass_count.py),
    or "not measured" where cuobjdump is missing or finds no loop."""
    from is3d_tpu_torch.native import build
    from is3d_tpu_torch.tools import sass_count
    r = sass_count.per_eval(build._cuda_paths(library)[1], kernel)
    if r is None:
        return "not measured"
    atomics = (f", {r['atom']:.2f} device and {r['atoms']:.2f} shared "
               f"atomics ({r['cas']:.2f} CAS)"
               if r.get("atom", 0) or r.get("atoms", 0) else "")
    return (f"{r['instructions']:.2f} instructions, {r['fp32']:.2f} FP32, "
            f"{r['sfu']:.2f} SFU, {r['lds']:.2f} shared loads{atomics} "
            f"(loop of {r['evaluations']:.0f} evaluations)")


def _modules():
    from is3d_tpu_torch.kernels import (smooth, dndx, decays, feqmod, vah,
                                        polzn, sample, mc_decays)
    from is3d_tpu_torch.experiments import smooth_proto, dndx_reduce_probe
    return (smooth, dndx, smooth_proto, dndx_reduce_probe, decays, feqmod,
            vah, polzn, sample, mc_decays)


def _reset_counts():
    (smooth, dndx, proto, probe, decays, feqmod, vah, polzn, sample,
     mc_decays) = _modules()
    smooth.LAUNCHES = smooth.REMAP_LAUNCHES = 0
    smooth.BWD_LAUNCHES = smooth.BWD_REMAP_LAUNCHES = 0
    decays.TWO_BODY_BWD_LAUNCHES = decays.THREE_BODY_BWD_LAUNCHES = 0
    dndx.LAUNCHES = dndx.BIN_LAUNCHES = dndx.FEQMOD_LAUNCHES = 0
    dndx.VAH_LAUNCHES = 0
    proto.LAUNCHES = probe.LAUNCHES = 0
    decays.TWO_BODY_LAUNCHES = decays.THREE_BODY_LAUNCHES = 0
    feqmod.LAUNCHES = feqmod.REMAP_LAUNCHES = 0
    feqmod.BWD_LAUNCHES = feqmod.BWD_REMAP_LAUNCHES = 0
    vah.LAUNCHES = vah.REMAP_LAUNCHES = 0
    vah.BWD_LAUNCHES = vah.BWD_REMAP_LAUNCHES = 0
    polzn.LAUNCHES = polzn.REMAP_LAUNCHES = 0
    polzn.BWD_LAUNCHES = polzn.BWD_REMAP_LAUNCHES = 0
    sample.LAUNCHES = sample.PACKED_LAUNCHES = sample.ALIAS_LAUNCHES = 0
    sample.VAH_LAUNCHES = sample.VAH_PACKED_LAUNCHES = 0
    sample.SEARCH_LAUNCHES = sample.SEARCH_PACKED_LAUNCHES = 0
    sample.YIELDS_LAUNCHES = sample.YIELDS_VAH_LAUNCHES = 0
    mc_decays.LAUNCHES = 0


def _counts() -> dict:
    (smooth, dndx, proto, probe, decays, feqmod, vah, polzn, sample,
     mc_decays) = _modules()
    return dict(smooth_spectra=smooth.LAUNCHES,
                smooth_spectra_remap=smooth.REMAP_LAUNCHES,
                dndx=dndx.LAUNCHES,
                dndx_bin=dndx.BIN_LAUNCHES, smooth_proto=proto.LAUNCHES,
                dndx_probe=probe.LAUNCHES,
                decay_wave_2body=decays.TWO_BODY_LAUNCHES,
                decay_wave_3body=decays.THREE_BODY_LAUNCHES,
                spectra_bwd=smooth.BWD_LAUNCHES,
                spectra_bwd_remap=smooth.BWD_REMAP_LAUNCHES,
                decay_wave_bwd_2body=decays.TWO_BODY_BWD_LAUNCHES,
                decay_wave_bwd_3body=decays.THREE_BODY_BWD_LAUNCHES,
                feqmod_spectra=feqmod.LAUNCHES,
                feqmod_spectra_remap=feqmod.REMAP_LAUNCHES,
                feqmod_bwd=feqmod.BWD_LAUNCHES,
                feqmod_bwd_remap=feqmod.BWD_REMAP_LAUNCHES,
                vah_bwd=vah.BWD_LAUNCHES,
                vah_bwd_remap=vah.BWD_REMAP_LAUNCHES,
                dndx_feqmod=dndx.FEQMOD_LAUNCHES,
                vah_spectra=vah.LAUNCHES,
                vah_spectra_remap=vah.REMAP_LAUNCHES,
                dndx_vah=dndx.VAH_LAUNCHES,
                polzn=polzn.LAUNCHES, polzn_remap=polzn.REMAP_LAUNCHES,
                polzn_bwd=polzn.BWD_LAUNCHES,
                polzn_bwd_remap=polzn.BWD_REMAP_LAUNCHES,
                sample_events=sample.LAUNCHES,
                sample_packed=sample.PACKED_LAUNCHES,
                sample_events_vah=sample.VAH_LAUNCHES,
                sample_packed_vah=sample.VAH_PACKED_LAUNCHES,
                sample_events_search=sample.SEARCH_LAUNCHES,
                sample_packed_search=sample.SEARCH_PACKED_LAUNCHES,
                alias_tables=sample.ALIAS_LAUNCHES,
                species_yields=sample.YIELDS_LAUNCHES,
                species_yields_vah=sample.YIELDS_VAH_LAUNCHES,
                mc_cascade=mc_decays.LAUNCHES)


def _expect_counts(path: str, counts: dict, want: dict):
    """Fail unless the path launched exactly the kernels in ``want`` (the
    given number of times each) and no other."""
    for name, n in counts.items():
        if n != want.get(name, 0):
            fail(f"{path}: {name} launched {n} times, expected "
                 f"{want.get(name, 0)}")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def mom_tensors(mom):
    return (mom.mass, mom.sign, mom.baryon, mom.degeneracy, mom.pT, mom.px,
            mom.py, mom.nodes, mom.weights, mom.cos_phi, mom.sin_phi)


def _bound(evals: float, fp32: float, sfu: float, nbytes: float,
           clock: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the FP32 and SFU instructions (``evals`` x
    ``fp32`` and x ``sfu``) over their issue rates at the maximum SM
    clock."""
    t_ops = max(evals * fp32 / (N_SM * FP32_LANES * clock),
                evals * sfu / (N_SM * SFU_LANES * clock))
    t_bytes = nbytes / HBM_RATE
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _dndx_group_inputs(surface, species, grid, df_data, cfg, n=None):
    """The dN/dX kernels' inputs for the first ``n`` cells (all if None)."""
    import dataclasses
    from is3d_tpu_torch.kernels import dndx
    from is3d_tpu_torch.kernels.common import prepare_cells
    from is3d_tpu_torch.kernels.smooth import (pack_cells, spectra_flags,
                                               momentum_constants)
    cols = dndx.dndx_cols(surface, cfg)
    if n is not None:
        cols = {k: v[:n] for k, v in cols.items()}
    grid = dataclasses.replace(grid, eta_mT_rescale=False)
    cells = pack_cells(prepare_cells(cols, cfg, df_data), cfg)
    return (cells, momentum_constants(species, grid, cfg.dimension),
            spectra_flags(cfg, grid), dndx.momentum_weights(grid, cfg),
            dndx.node_weights(grid, cfg.dimension),
            dndx.bin_plan(cols["tau"], cols["x"], cols["y"], cfg))


TOL = {torch.float32: (2e-4, 2e-5), torch.float64: (1e-10, 1e-13)}


def phase_small_dndx():
    from is3d_tpu_torch.config import Config
    from is3d_tpu_torch.io.surface import surface_from_arrays
    from is3d_tpu_torch.io.tables import native_momentum_grid
    from is3d_tpu_torch.kernels import dndx
    from is3d_tpu_torch import testing

    cases = [(dimension, df_mode, reg_out, False) for dimension in (2, 3)
             for df_mode in (1, 2) for reg_out in (0, 1)]
    cases += [(2, 1, 1, True), (3, 2, 1, True)]
    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.float64):
        for i, (dimension, df_mode, reg_out, baryon) in enumerate(cases):
            cfg = Config(operation=0, mode=1, dimension=dimension,
                         df_mode=df_mode, include_shear_deltaf=1,
                         include_bulk_deltaf=1, include_baryon=int(baryon),
                         include_baryondiff_deltaf=int(baryon),
                         regulate_deltaf=reg_out, outflow=reg_out,
                         tau_bins=30, r_bins=20)
            cells = testing.synthetic_surface_cells(777, dimension,
                                                    seed=100 + i)
            if baryon:
                rng = np.random.default_rng(i)
                cells.update(muB=rng.uniform(0.05, 0.3, 777),
                             nB=rng.uniform(0, 0.05, 777),
                             Vx=rng.normal(0, 0.02, 777),
                             Vy=rng.normal(0, 0.02, 777),
                             Vn=rng.normal(0, 0.005, 777))
            surface = surface_from_arrays(dtype=dtype, device=dev, **cells)
            grid = native_momentum_grid(dimension, n_pT=8, n_phi=6, n_y=5,
                                        n_eta=12, dtype=dtype, device=dev)
            species = testing.synthetic_species(40, dtype=dtype, device=dev)
            df_data = testing.synthetic_deltaf_data(dtype=dtype, device=dev)
            packed, mom, flags, wM, wR, plan = _dndx_group_inputs(
                surface, species, grid, df_data, cfg)
            got = dndx.dndx_cuda(packed, mom, flags, wM, wR)
            want = dndx.dndx_plain(packed, mom, flags, wM, wR)
            hist = dndx.dndx_bin_cuda(want[0], plan)
            hist_want = dndx.dndx_bin_plain(want[0], plan)
            torch.cuda.synchronize()
            name = (f"dndx {str(dtype)[6:]} {dimension}+1D df{df_mode} "
                    f"reg/out={reg_out}{' baryon+diff' if baryon else ''}")
            _check(f"{name} per cell", got[0], want[0], *TOL[dtype])
            _check(f"{name} dN/dy/deta", got[1], want[1], *TOL[dtype])
            _check(f"{name} bins", hist, hist_want, *TOL[dtype])


def phase_small_experiments():
    from is3d_tpu_torch.experiments import smooth_proto as proto
    from is3d_tpu_torch.experiments import dndx_reduce_probe as probe
    for dtype in (torch.float32, torch.float64):
        x = proto.proto_inputs(50, S=64, P=4, F=6, Y=5, seed=3, dtype=dtype,
                               device="cuda")
        x["cells"][::3, proto.IDX["mask"]] = 0.0
        got = proto.proto_spectra_cuda(*(x[n] for n in proto.ARGS))
        want = proto.proto_spectra_plain(*(x[n] for n in proto.ARGS))
        torch.cuda.synchronize()
        _check(f"smooth_proto {str(dtype)[6:]} 50 cells (17 masked) x 64 x "
               "24 x 5", got, want, *TOL[dtype])
        x["cells"][:, proto.IDX["mask"]] = 0.0
        none = proto.proto_spectra_cuda(*(x[n] for n in proto.ARGS))
        if (none != 0).any():
            fail(f"smooth_proto {dtype}: masked cells add "
                 f"{none.abs().max().item():.3e}, not exactly 0")
        x = probe.probe_inputs(37, 7, 20, 50, seed=4, dtype=dtype,
                               device="cuda")
        args = (x["a"], x["b"], x["w"], x["wM"], x["wR"])
        got = probe.percell_probe_cuda(*args)
        want = probe.percell_probe_plain(*args)
        torch.cuda.synchronize()
        for part, g, w in zip(("per cell", "per node"), got, want):
            _check(f"dndx_probe {str(dtype)[6:]} 37 x 7 x 20 x 50 {part}", g,
                   w, *TOL[dtype])


def phase_dndx_main(smi: str, tag="dndx main", n_cells=DNDX_CELLS,
                    args=DNDX_ARGS, want=("dndx", "dndx_bin"), mode=1):
    """One operation-0 CLI run on a synthetic 2+1D run directory of
    ``n_cells`` cells x 320 species on a surface of ``mode``: launches of
    ``want`` = canonical groups, every spacetime_distribution file present
    and finite, pion dN/dy > 0."""
    from is3d_tpu_torch.config import load_config
    from is3d_tpu_torch.io.pdg import load_chosen_mcids
    from is3d_tpu_torch.io.tables import native_momentum_grid
    from is3d_tpu_torch.parallel.mesh import canonical_groups
    from is3d_tpu_torch.testing import write_synthetic_run_dir

    run_dir = os.path.join(WORK, tag.replace(" ", "_"))
    t0 = time.perf_counter()
    write_synthetic_run_dir(run_dir, n_cells, MAIN_SPECIES, dimension=2,
                            seed=2, params=dict(operation=0), mode=mode)
    print(f"[{tag}] synthetic run dir {n_cells} cells x "
          f"{MAIN_SPECIES} species written in "
          f"{time.perf_counter() - t0:.2f} s")
    _reset_counts()
    t0 = time.perf_counter()
    rc, phases, out = _run_cli([run_dir] + list(args))
    wall = time.perf_counter() - t0
    counts = _counts()
    print("\n".join(f"[{tag}] cli: " + l for l in out.splitlines()
                    if " = " not in l))
    if rc != 0:
        fail(f"dN/dX cli exited {rc}")
    cfg = load_config(os.path.join(run_dir, "iS3D_parameters.dat"),
                      overrides=dict(a.split("=", 1) for a in args[1:]))
    groups, _ = canonical_groups(cfg, n_cells)
    _expect_counts(f"{tag} path", counts, {k: groups for k in want})
    mcids = load_chosen_mcids(os.path.join(
        run_dir, "PDG", "chosen_particles_urqmd_v3.3+.dat"))
    if len(mcids) != MAIN_SPECIES:
        fail(f"{len(mcids)} chosen species")
    d = os.path.join(run_dir, "results", "spacetime_distribution")
    grid = native_momentum_grid(2)
    shapes = {"dN_taudtaudy": (cfg.tau_bins, 2),
              "dN_twopirdrdy": (cfg.r_bins, 2),
              "dN_twopitaurdtaudrdy": (cfg.tau_bins * cfg.r_bins, 3),
              "dN_dydeta": (grid.n_eta, 2)}
    for m in mcids:
        for stem, shape in shapes.items():
            tail = f"_{grid.n_eta}pt" if stem == "dN_dydeta" else ""
            path = os.path.join(d, f"{stem}_{m}{tail}.dat")
            if not os.path.isfile(path):
                fail(f"missing writer output {os.path.relpath(path, d)}")
            v = np.loadtxt(path)
            if v.shape != shape or not np.isfinite(v).all():
                fail(f"{os.path.relpath(path, d)}: shape {v.shape} or "
                     "non-finite values")
    n_files = len(os.listdir(d))
    if n_files != 4 * MAIN_SPECIES:
        fail(f"{n_files} spacetime_distribution files, expected "
             f"{4 * MAIN_SPECIES}")
    dydeta = np.loadtxt(os.path.join(d, f"dN_dydeta_211_{grid.n_eta}pt.dat"))
    dndy = float(dydeta[:, 1] @ grid.eta_weight.numpy())
    if not dndy > 0:
        fail(f"pion dN/dy = {dndy} is not positive")
    evals = n_cells * MAIN_SPECIES * 32 * 24 * grid.n_eta
    t_dx = phases["dN/dX spacetime"]
    print(f"[{tag}] {smi} | prepare "
          f"{phases['prepare (io, pdg, deltaf)']:.3f} s, dN/dX {t_dx:.3f} s, "
          f"writers {phases['writers']:.3f} s, cli wall {wall:.3f} s | "
          f"{evals:.3e} evaluations, {evals / t_dx:.3e} evaluations/s | "
          "launches " + ", ".join(f"{k} {counts[k]}" for k in want)
          + f" = groups {groups} | {n_files} files, pion dN/dy {dndy:.6e}")
    return counts, run_dir, cfg


def phase_dndx_pair(smi: str, clock: float, run_dir: str, cfg,
                    plain_cells=1024):
    """The dN/dX kernel on one canonical group (8192 cells) of the
    operation-0 path, f32: two launches bit-identical; on the group's first
    ``plain_cells`` cells agreement with the plain version and both f32
    versions against the f64 kernel; times, bound, SASS; then the binning
    kernel on the group's per-cell dN/dy against its plain version and its
    library yardstick."""
    from is3d_tpu_torch.api import IS3D
    from is3d_tpu_torch.utils import cuda_median_ms, cuda_queued_ms
    from is3d_tpu_torch.kernels import dndx
    from is3d_tpu_torch.parallel.mesh import canonical_groups

    run = IS3D(cfg, data_dir=run_dir, device="cuda")
    _, df_data, species, _, grid = run._prepare()
    _, gs = canonical_groups(cfg, run.surface.n_cells)
    cells, mom, flags, wM, wR, plan = _dndx_group_inputs(
        run.surface, species, grid, df_data, cfg, gs)
    kern = lambda: dndx.dndx_cuda(cells, mom, flags, wM, wR)
    got, again = kern(), kern()
    torch.cuda.synchronize()
    if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
        fail("dndx: two launches on the same group differ")
    n = plain_cells
    cs = cells[:n].contiguous()
    want, p_ms = _timed_once(lambda: dndx.dndx_plain(cs, mom, flags, wM, wR,
                                                     cfg.cell_chunk))
    got_n = dndx.dndx_cuda(cs, mom, flags, wM, wR)
    S, R = got[1].shape
    shape = f"{cells.shape[0]} cells x {S} x {wM.shape[0]} x {R}"
    err = max(_check(f"dndx float32 main-path group ({shape}), its first {n} "
                     "cells, per cell", got_n[0], want[0], 2e-4, 2e-5),
              _check(f"dndx float32 main-path group, its first {n} cells, "
                     "dN/dy/deta", got_n[1], want[1], 2e-4, 2e-5))
    # both float32 versions against the float64 kernel on the same inputs
    ref = dndx.dndx_cuda(cs.double(), mom.to(dtype=torch.float64), flags,
                         wM.double(), wR.double())
    share = lambda a, r: ((a.double() - r).abs().max() / r.abs().max()).item()
    print(f"[dndx pair] float32 against the float64 kernel on the group's "
          f"first {n} cells, largest difference as a share of the largest "
          "value (per cell, dN/dy/deta): kernel "
          f"{share(got_n[0], ref[0]):.2e}, {share(got_n[1], ref[1]):.2e}"
          f"; plain {share(want[0], ref[0]):.2e}, "
          f"{share(want[1], ref[1]):.2e}")
    del ref
    k_ms, k_all = cuda_median_ms(kern)
    evals = cells.shape[0] * S * wM.shape[0] * R
    bound = _bound(evals, *dndx.FORMULA_OPS[cfg.df_mode],
                   _nbytes(cells, wM, wR, *got, *mom_tensors(mom)), clock)
    print(f"[dndx pair] {smi} | one group {shape}: kernel {k_ms:.3f} ms "
          f"(runs {', '.join(f'{t:.2f}' for t in k_all)}), plain "
          f"{p_ms:.3f} ms on its first {n} cells (one run), "
          f"kernel {evals / k_ms * 1e3:.3e} evaluations/s, bound "
          f"{bound[0]:.3f} ms ({bound[1]}); two "
          "launches bit-identical; issued per evaluation: "
          + _issued("dndx", "percell_kernelIfNS_16EmissionProducerIf"
                    f"Li{cfg.df_mode}ELi{cfg.dimension}ELb1E"))
    rec_dndx = dict(launches=None, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                    bound_ms=bound[0], bound_by=bound[1], library_ms=None,
                    cells=cells.shape[0], plain_cells=n)

    # the binning kernel on this group's per-cell dN/dy
    per_cell = got[0]
    bkern = lambda: dndx.dndx_bin_cuda(per_cell, plan)
    bplain = lambda: dndx.dndx_bin_plain(per_cell, plan)
    hist, hist2, hist_want = bkern(), bkern(), bplain()
    # the library yardstick: one sparse product (bins x cells) @ per_cell
    ones = torch.ones(plan.key.shape[0], dtype=per_cell.dtype,
                      device=per_cell.device)
    assign = torch.sparse_coo_tensor(
        torch.stack([plan.key, plan.cell.long()]), ones,
        (plan.n_bins, per_cell.shape[0])).coalesce().to_sparse_csr()
    blib = lambda: torch.sparse.mm(assign, per_cell)
    lib_out = blib()
    torch.cuda.synchronize()
    if not torch.equal(hist, hist2):
        fail("dndx_bin: two launches on the same group differ")
    berr = _check(f"dndx_bin float32 main-path group ({plan.n_bins} bins, "
                  f"{plan.key.shape[0]} entries)", hist, hist_want, 2e-4,
                  2e-5)
    _check("dndx_bin's library yardstick (torch.sparse.mm)", lib_out.T,
           hist_want, 2e-4, 2e-5)
    b_ms, b_all = cuda_queued_ms(bkern)
    bp_ms, _ = cuda_queued_ms(bplain)
    bl_ms, _ = cuda_queued_ms(blib)
    bbound = _bound(plan.key.shape[0] * S, 1, 0,
                    _nbytes(per_cell, plan.cell, plan.start, hist), clock)
    print(f"[bin pair] {smi} | one group: kernel {b_ms:.4f} ms (runs "
          f"{', '.join(f'{t:.4f}' for t in b_all)}), plain {bp_ms:.4f} ms, "
          f"torch.sparse.mm {bl_ms:.4f} ms, bound {bbound[0]:.4f} ms "
          f"({bbound[1]}); two launches bit-identical; device time per "
          f"call by kernel: {_kernel_split(bkern)}")
    rec_bin = dict(launches=None, max_abs_err=berr, ms=b_ms, plain_ms=bp_ms,
                   bound_ms=bbound[0], bound_by=bbound[1], library_ms=bl_ms)
    return rec_dndx, rec_bin


def _decay_waves(smi: str, clock: float, tag: str, spectra, table, mcids,
                 grid, cfg):
    """The cascade on ``spectra`` wave by wave, f32: each launch timed (CUDA
    events into a scratch accumulator, one warm-up, median of 3) beside its
    bound, then added to the running spectra.  Returns the largest launch
    of each body (evaluations, wave, tables, tasks, ms, bound), the kernel
    time over the launches of each body, and the wave grid."""
    from is3d_tpu_torch.utils import cuda_median_ms
    from is3d_tpu_torch.kernels import decays
    pT64 = grid.pT.to("cpu", torch.float64).numpy()
    waves = decays.plan_waves(decays._decay_schedule(
        table, mcids, pT64, cfg.lightest_particle))
    wg = decays.wave_grid(grid, cfg.dimension, torch.float32, "cuda")
    staged = decays.stage_waves(waves, pT64, torch.float32, "cuda")
    lib = decays._library()
    acc = spectra.double()
    scratch = torch.zeros_like(acc)
    largest = {}
    total = {2: 0.0, 3: 0.0}
    for i, st in enumerate(staged):
        tables = decays.parent_tables(acc, st.rows, st.masses, st.mtg,
                                      torch.float32)
        for tasks in st.launches:
            kern = lambda: decays.decay_wave_cuda(tables, tasks, wg, scratch)
            kern()
            ms, runs = cuda_median_ms(kern, 3)
            evals = decays.wave_evaluations(tasks, wg)
            fed = tasks.target.shape[0] * acc[0].numel() * 8
            nbytes = (_nbytes(tables.logdN, tables.tc, tables.ts, tables.mtg,
                              tasks.slot, tasks.par) + 2 * fed)
            fp32, sfu = decays.wave_operations(tasks, wg)
            bound = _bound(1.0, fp32, sfu, nbytes, clock)
            t_fp32, t_sfu = (_bound(1.0, fp32, 0, 0, clock)[0],
                             _bound(1.0, 0, sfu, 0, clock)[0])
            bl = decays.wave_blocking(lib, acc.device, torch.float32,
                                      tasks.nbody, cfg.dimension,
                                      tasks.slot.shape[0],
                                      *tables.logdN.shape[1:],
                                      wg.phi_bucket.shape[0])
            total[tasks.nbody] += ms
            print(f"[{tag}] {smi} | wave {i} {tasks.nbody}-body: "
                  f"{tasks.slot.shape[0]} tasks on {st.rows.shape[0]} slots, "
                  f"{bl.pt_block} pT a block, {bl.chunks} (s, v) chunks a "
                  f"task, {bl.smem} B of shared memory a block, "
                  f"{evals:.3e} evaluations, {fp32 / evals:.3f} FP32 and "
                  f"{sfu / evals:.0f} SFU an evaluation at least: kernel "
                  f"{ms:.3f} ms (runs "
                  f"{', '.join(f'{t:.3f}' for t in runs)}), bound "
                  f"{bound[0]:.3f} ms ({bound[1]}: FP32 {t_fp32:.3f}, SFU "
                  f"{t_sfu:.3f}), {bound[0] / ms:.1%} of it, "
                  f"{evals / ms * 1e3:.3e} evaluations/s")
            if evals > largest.get(tasks.nbody, (0,))[0]:
                largest[tasks.nbody] = (evals, i, tables, tasks, ms, bound)
            decays.decay_wave_cuda(tables, tasks, wg, acc)
    torch.cuda.synchronize()
    print(f"[{tag}] {smi} | kernel time over the path's launches: "
          f"2-body {total[2]:.3f} ms, 3-body {total[3]:.3f} ms")
    return largest, total, wg


def _decay_largest_vs_plain(smi: str, tag: str, largest: dict, wg,
                            n_seg: int) -> dict:
    """The largest launch of each body against its plain version on the
    same inputs (all its buckets, one timed run); two launches
    bit-identical.  Returns the kernel records by body."""
    from is3d_tpu_torch.kernels import decays
    records = {}
    for nbody, (evals, i, tables, tasks, ms, bound) in sorted(
            largest.items()):
        shape = (n_seg,) + tables.logdN.shape[1:]
        got = torch.zeros(shape, dtype=torch.float64, device="cuda")
        again = torch.zeros_like(got)
        decays.decay_wave_cuda(tables, tasks, wg, got)
        decays.decay_wave_cuda(tables, tasks, wg, again)
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        want = decays.wave_plain(tables, tasks, wg, n_seg)
        t1.record()
        t1.synchronize()
        p_ms = t0.elapsed_time(t1)
        if not torch.equal(got, again):
            fail(f"decay_wave {nbody}-body ({tag}): two launches differ")
        err = _check(f"decay_wave float32 {wg.dimension}+1D {nbody}-body "
                     f"wave {i} ({tasks.slot.shape[0]} tasks)", got,
                     want.double(), *TOL[torch.float32])
        bucket = decays.WAVE_BUCKET[wg.dimension]
        n_buckets = -(-tasks.slot.shape[0] // bucket)
        print(f"[{tag}] {smi} | {nbody}-body wave {i}: kernel "
              f"{ms:.3f} ms, plain {p_ms:.1f} ms on the same launch "
              f"({n_buckets} buckets of {bucket} tasks, "
              f"{p_ms / n_buckets:.1f} ms a bucket), plain/kernel "
              f"{p_ms / ms:.1f}; bound {bound[0]:.3f} ms ({bound[1]}); two "
              "launches bit-identical")
        records[nbody] = dict(launches=None, max_abs_err=err, ms=ms,
                              plain_ms=p_ms, bound_ms=bound[0],
                              bound_by=bound[1], library_ms=None,
                              launch=f"wave {i}, the largest")
        del want, got, again
    return records


def phase_decays_pair(smi: str, clock: float, run_dir: str, cfg):
    """The wave kernel on the main decays path's own waves: the smooth
    spectra of the run directory (f32, recomputed), every launch timed
    beside its bound, the largest launch of each body against its plain
    version, the kernel's SASS per evaluation, the f32 cascade against the
    f64 one on the same spectra; then the 2+1D waves at full width on
    their own spectra (phase_decays_2d)."""
    from is3d_tpu_torch.api import IS3D
    from is3d_tpu_torch.kernels import decays

    run = IS3D(cfg.replace(do_resonance_decays=0), data_dir=run_dir,
               device="cuda")
    spectra = torch.as_tensor(run.run_particlization(
        write_files=False).spectra, device="cuda")
    table, _, _, mcids, grid = run._prepare()
    largest, total, wg = _decay_waves(smi, clock, "decays pair", spectra,
                                      table, mcids, grid, cfg)
    # ms, plain_ms and bound_ms are of the largest launch ("launch"); the
    # path's launches differ in size by two orders of magnitude, path_ms
    # sums them
    records = _decay_largest_vs_plain(smi, "decays pair", largest, wg,
                                      spectra.shape[0])
    for nbody in records:
        records[nbody]["path_ms"] = total[nbody]
        print(f"[decays pair] {smi} | wave_kernel f32 3+1D {nbody}-body, "
              "issued per evaluation: " + _issued(
                  "decays", f"wave_kernelIfLi3ELi{nbody}E"))

    # the f32 cascade (the main path's) against f64 on the same spectra
    grid64 = grid.to(dtype=torch.float64)
    with contextlib.redirect_stdout(io.StringIO()):
        f32 = decays.do_resonance_decays(spectra, table, mcids, grid, cfg)
        f64 = decays.do_resonance_decays(spectra.double(), table, mcids,
                                         grid64, cfg)
    torch.cuda.synchronize()
    if not torch.isfinite(f32).all():
        fail("the f32 cascade has non-finite values")
    gain = (f64 - spectra.double()).abs().amax(dim=(1, 2, 3))
    diff = (f32 - f64).abs().amax(dim=(1, 2, 3))
    scale = f64.abs().amax(dim=(1, 2, 3))
    fed = gain > 0
    print(f"[decays pair] {smi} | f32 cascade against f64 on the same "
          f"spectra: largest difference {(diff / scale).max().item():.2e} "
          f"of a species' largest value, "
          f"{(diff[fed] / gain[fed]).max().item():.2e} of its largest "
          f"feed-down ({int(fed.sum())} species fed)")
    return records


def phase_decays_2d(smi: str, clock: float):
    """The 2+1D waves at full width: the decaying synthetic list (320
    species), the native 32 x 24 grid, on the smooth spectra of a 2+1D
    run directory cut to DECAYS_2D_CELLS cells (the waves' work does not
    depend on the cell count): every launch timed beside its bound, the
    largest of each body against its plain version."""
    from is3d_tpu_torch.api import IS3D
    from is3d_tpu_torch.config import load_config
    from is3d_tpu_torch.testing import write_synthetic_run_dir

    run_dir = os.path.join(WORK, "decays_2d")
    write_synthetic_run_dir(run_dir, DECAYS_2D_CELLS, MAIN_SPECIES,
                            dimension=2, seed=0, decays=True)
    cfg = load_config(os.path.join(run_dir, "iS3D_parameters.dat"),
                      overrides=dict(a.split("=", 1)
                                     for a in MAIN2D_ARGS[1:]))
    run = IS3D(cfg.replace(do_resonance_decays=0), data_dir=run_dir,
               device="cuda")
    spectra = torch.as_tensor(run.run_particlization(
        write_files=False).spectra, device="cuda")
    table, _, _, mcids, grid = run._prepare()
    print(f"[decays 2d] smooth spectra of {DECAYS_2D_CELLS} cells x "
          f"{len(mcids)} species, 2+1D, native {tuple(spectra.shape[1:3])} "
          "grid (cells cut from the main path's 131072: the waves' work "
          "does not depend on them)")
    largest, _, wg = _decay_waves(smi, clock, "decays 2d", spectra, table,
                                  mcids, grid, cfg)
    _decay_largest_vs_plain(smi, "decays 2d", largest, wg, spectra.shape[0])
    shutil.rmtree(run_dir, ignore_errors=True)


def _kernel_split(fn, calls: int = 20, tries: int = 3) -> str:
    """Device time per call of ``fn`` by CUDA kernel name, from
    torch.profiler over ``calls`` calls, or "not measured" where the
    profiler records no device time in ``tries`` tries (a trace on the
    card has come back without device events now and then)."""
    from torch.profiler import profile, ProfilerActivity
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        parts = []
        for e in prof.key_averages():
            us = (getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0))
            if us and "kernel" in e.key:
                m = re.search(r"(\w+)<", e.key)
                parts.append(f"{m.group(1) if m else e.key[:40]} "
                             f"{us / calls:.2f} us")
        if parts:
            return ", ".join(parts)
    return "not measured"


def phase_experiments(smi: str, clock: float):
    """Each experiment at its own shape through its measure(): the counts
    are set to 0 before it and read after it."""
    _, _, proto, probe, *_ = _modules()
    records = {}
    for name, mod in (("smooth_proto", proto), ("dndx_probe", probe)):
        _reset_counts()
        r = mod.measure()
        counts = _counts()
        # the experiment's own run, plus its one comparison launch
        _expect_counts(f"{name} experiment", counts,
                       {name: r["launches"] + 1})
        if r["launches"] < 1:
            fail(f"{name}: no launch in its experiment run")
        outs = r["got"] if isinstance(r["got"], tuple) else (r["got"],)
        wants = r["want"] if isinstance(r["want"], tuple) else (r["want"],)
        err = max(_check(f"{name} float32 own shape ({r['label']})", g, w,
                         2e-4, 2e-5) for g, w in zip(outs, wants))
        bound = _bound(r["evaluations"], *mod.BOUND_OPS, r["bytes"], clock)
        issued = (_issued("smooth_proto", "proto_kernelIf")
                  if name == "smooth_proto" else
                  _issued("dndx", "percell_kernelIfNS_13ProbeProducer"))
        print(f"[{name}] {smi} | {r['label']}: kernel {r['ms']:.3f} ms "
              f"(runs {', '.join(f'{t:.3f}' for t in r['runs'])}), "
              f"{r['evaluations'] / r['ms'] * 1e3:.3e} evaluations/s; plain "
              f"{r['plain_ms']:.3f} ms ({r['plain_label']}); bound "
              f"{bound[0]:.3f} ms ({bound[1]}); launches {r['launches']}; "
              f"issued per evaluation: {issued}")
        records[name] = dict(launches=r["launches"], max_abs_err=err,
                             ms=r["ms"], plain_ms=r["plain_ms"],
                             bound_ms=bound[0], bound_by=bound[1],
                             library_ms=None)
    return records


def phase_feqmod(smi: str, clock: float):
    """The feqmod (df 3-4) paths at full width: [feqmod main] (3+1D df 3)
    and its 256-cell cuda-against-cpu run, [feqmod pair] on a clean and a
    mostly broken-down group; [feqmod main 2d] (2+1D df 4, mT remap), its
    small run and pair; [feqmod dndx] (operation 0, df 3) and its group;
    the backward kernels' [grad feqmod pair] and [grad feqmod main] (3+1D
    df 3) and [grad feqmod pair 2d] and [grad feqmod main 2d] (2+1D df 4,
    remap) on those surfaces.  Returns the kernel records of the three
    entry points and of the two backward kernels."""
    counts, run_dir, cfg, _ = phase_main_path(
        smi, "feqmod main", args=FEQMOD_ARGS, want=("feqmod_spectra",))
    _feqmod_share("feqmod main", run_dir, cfg)
    phase_small_path_cpu_vs_cuda(
        "small_feqmod", dimension=3, args=("df_mode=3", "regulate_deltaf=1"),
        label="3+1D df3 (bulk x 30)", scale_bulk=30.0)
    pair = phase_feqmod_pair(smi, clock, run_dir, cfg, "feqmod pair")
    rec_bwd = phase_grad_feqmod_pair(smi, clock, run_dir, cfg,
                                     "grad feqmod pair")
    rec_bwd["launches"] = phase_grad_feqmod_main(
        smi, run_dir, cfg, "grad feqmod main")["counts"]["feqmod_bwd"]
    _keep("feqmod main", run_dir, FEQMOD_ARGS, ("feqmod_spectra",))
    rec = dict(pair["clean"], launches=counts["feqmod_spectra"],
               most_breakdown=pair["most"])

    counts, run_dir, cfg, _ = phase_main_path(
        smi, "feqmod main 2d", dimension=2, args=FEQMOD2D_ARGS, n_nodes=48,
        want=("feqmod_spectra_remap",))
    _feqmod_share("feqmod main 2d", run_dir, cfg)
    phase_small_path_cpu_vs_cuda(
        "small_feqmod_2d", dimension=2,
        args=("df_mode=4", "regulate_deltaf=1"),
        label="2+1D mT remap df4 (bulk x 30)", scale_bulk=30.0)
    pair = phase_feqmod_pair(smi, clock, run_dir, cfg, "feqmod remap pair",
                             plain_cells=512)
    rec_bwd_remap = phase_grad_feqmod_pair(smi, clock, run_dir, cfg,
                                           "grad feqmod pair 2d")
    rec_bwd_remap["launches"] = phase_grad_feqmod_main(
        smi, run_dir, cfg, "grad feqmod main 2d")["counts"][
            "feqmod_bwd_remap"]
    shutil.rmtree(run_dir, ignore_errors=True)
    rec_remap = dict(pair["clean"], launches=counts["feqmod_spectra_remap"],
                     most_breakdown=pair["most"])

    counts, run_dir, cfg = phase_dndx_main(
        smi, "feqmod dndx", FEQMOD_DNDX_CELLS, FEQMOD_DNDX_ARGS,
        want=("dndx_feqmod", "dndx_bin"))
    rec_dndx = phase_feqmod_dndx_pair(smi, clock, run_dir, cfg)
    rec_dndx["launches"] = counts["dndx_feqmod"]
    shutil.rmtree(run_dir, ignore_errors=True)
    return rec, rec_remap, rec_dndx, rec_bwd, rec_bwd_remap


def _polzn_results_ok(results, mcids, n_y, tag):
    """The polarization files exist, are finite, of the spectra's layout,
    and not all zero."""
    for name in ("St", "Sx", "Sy", "Sn"):
        v = np.loadtxt(os.path.join(results, f"{name}.dat"))
        if v.shape != (len(mcids) * n_y * 24 * 32, 4) or not (
                np.isfinite(v).all() and (v[:, 3] != 0).any()):
            fail(f"{tag}: {name}.dat has shape {v.shape}, or values not "
                 "finite, or all zero")
    print(f"[{tag}] St.dat, Sx.dat, Sy.dat, Sn.dat: {len(mcids)} species x "
          f"{n_y * 24 * 32} points each, finite")


def _prepared(run_dir: str, cfg):
    """(run, particle table, df_data, species, mcids, grid) of a run
    directory on the card, as the CLI prepares them."""
    from is3d_tpu_torch.api import IS3D
    run = IS3D(cfg, data_dir=run_dir, device="cuda")
    table, df_data, species, mcids, grid = run._prepare()
    return run, table, df_data, species, mcids, grid


def _run_state(run_dir: str, cfg):
    """(run, species, grid) of a run directory on the card."""
    run, _, _, species, _, grid = _prepared(run_dir, cfg)
    return run, species, grid


def _timed_once(fn):
    """(fn(), its CUDA-event ms) for one run that takes seconds."""
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    out = fn()
    t1.record()
    t1.synchronize()
    return out, t0.elapsed_time(t1)


def _group_pair(name: str, parts, kern, kern64, kslice, plain, n: int):
    """One group's float32 kernel as [vah pair] and [polzn pair] take it:
    two launches bit-identical, the float64 kernel on the same cells
    (the largest difference as a share of each output's largest value,
    the worst of ``parts``), the group's first ``n`` cells (``kslice``)
    held against the plain version (``plain``, one timed run);
    CUDA-event medians of the kernel (5) and the slice (3), and one run
    of the float64 kernel (warm; its runs spread under 1 %).  Returns (the group's outputs, the measurements)."""
    from is3d_tpu_torch.utils import cuda_median_ms
    tup = lambda t: t if isinstance(t, tuple) else (t,)
    got, again, ref = tup(kern()), tup(kern()), tup(kern64())
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"{name}: two launches on the same group differ")
    f32_share = max(((g.double() - r).abs().max() / r.abs().max()).item()
                    for g, r in zip(got, ref))
    want, p_ms = _timed_once(plain)
    err = max(_check(f"{name} float32{part}, the group's first {n} cells",
                     g, w, 2e-4, 2e-5)
              for part, g, w in zip(parts, tup(kslice()), tup(want)))
    del want, ref
    k_ms, k_all = cuda_median_ms(kern)
    k64_ms, k64_all = cuda_median_ms(kern64, 1)
    ks_ms, _ = cuda_median_ms(kslice, 3)
    return got, dict(err=err, f32_share=f32_share, p_ms=p_ms, k_ms=k_ms,
                     k_all=k_all, k64_ms=k64_ms, k64_all=k64_all, ks_ms=ks_ms)


def _pair_line(m: dict, evals: float, n: int, bound) -> str:
    """The measurements of _group_pair as the pair phases print them."""
    return (f"kernel {m['k_ms']:.3f} ms (runs "
            f"{', '.join(f'{t:.2f}' for t in m['k_all'])}), "
            f"{evals / m['k_ms'] * 1e3:.3e} evaluations/s; float64 kernel "
            f"{m['k64_ms']:.3f} ms (runs "
            f"{', '.join(f'{t:.1f}' for t in m['k64_all'])}); float32 "
            f"against float64 {m['f32_share']:.2e} of the largest value (the "
            f"worst output); on the first {n} cells kernel {m['ks_ms']:.3f} "
            f"ms, plain {m['p_ms']:.1f} ms (one run); bound {bound[0]:.3f} ms "
            f"({bound[1]}), kernel at {bound[0] / m['k_ms']:.1%} of it; two "
            "launches bit-identical; issued per evaluation: ")


def _pair_record(m: dict, bound, cells: int, n: int) -> dict:
    return dict(launches=None, max_abs_err=m["err"], ms=m["k_ms"],
                plain_ms=m["p_ms"], bound_ms=bound[0], bound_by=bound[1],
                library_ms=None, cells=cells, plain_cells=n,
                kernel_ms_on_plain_cells=m["ks_ms"], f64_ms=m["k64_ms"],
                f32_vs_f64=m["f32_share"])


def phase_vah_pair(smi: str, clock: float, groups: list) -> list:
    """[vah pair]: a VAH spectra kernel on one canonical group (16384
    cells) of a main-path surface, f32, for each (kind, columns, species,
    grid, cfg, plain_cells) of ``groups``: two launches bit-identical, the
    float64 kernel on the same cells, the group's first ``plain_cells``
    cells held against the plain version; CUDA-event times (f32 one
    warm-up and the median of 5, f64 of 3), the plain version's one run,
    evaluations/s, the bound (kernels/vah.py:vah_formula_ops), SASS per
    evaluation.  Returns the record of each kind."""
    from is3d_tpu_torch.kernels import vah
    from is3d_tpu_torch.kernels.smooth import momentum_constants
    records = []
    for kind, cols, species, grid, cfg, n in groups:
        flags = vah.vah_flags(vah.effective_vah_cfg(cols, cfg), grid)
        x = vah.group_inputs(cols, flags)
        x64 = vah.group_inputs({k: v.double() for k, v in cols.items()},
                               flags)
        xs = x[:n].contiguous()
        mom = momentum_constants(species, grid, cfg.dimension)
        mom64 = mom.to(dtype=torch.float64)
        (got,), m = _group_pair(
            f"vah pair {kind}", ("",),
            lambda: vah.vah_spectra_cuda(x, mom, flags),
            lambda: vah.vah_spectra_cuda(x64, mom64, flags),
            lambda: vah.vah_spectra_cuda(xs, mom, flags),
            lambda: vah.vah_spectra_plain(xs, mom, flags, cfg.cell_chunk), n)
        R = mom.nodes.shape[0]
        evals = x.shape[0] * mom.mass.shape[0] * mom.px.shape[0] * R
        bound = _bound(evals, *vah.vah_formula_ops(flags, mom.n_phi),
                       _nbytes(x, got, *mom_tensors(mom)), clock)
        if flags.remap:
            width = vah.vah_grid(vah._library(), x.device, False,
                                 mom.mass.shape[0], mom.pT.shape[0],
                                 mom.n_phi, R, flags).phi_width
            kernel = f"remap_kernelIfLi{width}ELi{flags.switches}EE"
        else:
            kernel = (f"fixed_kernelIfLi{flags.dimension}ELi"
                      f"{flags.switches}EE")
        aL = cols["aL"]
        print(f"[vah pair] {smi} | {kind}: one group {x.shape[0]} cells x "
              f"{tuple(got.shape)} x {R} nodes (chains {flags.switches}, "
              f"a_L in [{aL.min().item():.2f}, {aL.max().item():.2f}]): "
              + _pair_line(m, evals, n, bound) + _issued("vah", kernel))
        records.append(_pair_record(m, bound, x.shape[0], n))
    return records


def phase_vah_dndx_pair(smi: str, clock: float, run_dir: str, cfg,
                        plain_cells=512) -> dict:
    """[vah dndx]: the dN/dX kernel's VAH producer on one canonical group
    of that run, f32: two launches bit-identical, its first
    ``plain_cells`` cells held against the plain version, times, bound."""
    import dataclasses
    from is3d_tpu_torch.kernels import dndx, vah
    from is3d_tpu_torch.kernels.smooth import momentum_constants
    from is3d_tpu_torch.parallel.mesh import canonical_groups
    from is3d_tpu_torch.utils import cuda_median_ms
    run, species, grid = _run_state(run_dir, cfg)
    grid = dataclasses.replace(grid, eta_mT_rescale=False)
    cols = vah.vah_surface_cols(run.surface)
    _, gs = canonical_groups(cfg, cols["tau"].shape[0])
    cols = {k: v[:gs] for k, v in cols.items()}
    flags = vah.vah_flags(vah.effective_vah_cfg(cols, cfg), grid)
    x = vah.group_inputs(cols, flags)
    mom = momentum_constants(species, grid, cfg.dimension)
    wM = dndx.momentum_weights(grid, cfg)
    wR = dndx.node_weights(grid, cfg.dimension)
    kern = lambda: dndx.dndx_vah_cuda(x, mom, flags, wM, wR)
    got, again = kern(), kern()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail("dndx vah: two launches on the same group differ")
    n = plain_cells
    xs = x[:n].contiguous()
    want, p_ms = _timed_once(lambda: dndx.dndx_vah_plain(
        xs, mom, flags, wM, wR, cfg.cell_chunk))
    part = dndx.dndx_vah_cuda(xs, mom, flags, wM, wR)
    err = max(_check(f"dndx vah float32, the group's first {n} cells, per "
                     "cell", part[0], want[0], 2e-4, 2e-5),
              _check(f"dndx vah float32, the group's first {n} cells, "
                     "dN/dy/deta", part[1], want[1], 2e-4, 2e-5))
    k_ms, k_all = cuda_median_ms(kern)
    R = wR.shape[0]
    evals = x.shape[0] * mom.mass.shape[0] * wM.shape[0] * R
    bound = _bound(evals, *vah.vah_formula_ops(flags, mom.n_phi),
                   _nbytes(x, wM, wR, *got, *mom_tensors(mom)), clock)
    print(f"[vah dndx] {smi} | one group {x.shape[0]} cells x "
          f"{mom.mass.shape[0]} x {wM.shape[0]} x {R} (chains "
          f"{flags.switches}): kernel {k_ms:.3f} ms (runs "
          f"{', '.join(f'{t:.2f}' for t in k_all)}), plain {p_ms:.1f} ms on "
          f"its first {n} cells (one run); bound {bound[0]:.3f} ms "
          f"({bound[1]}), kernel at {bound[0] / k_ms:.1%} of it; two "
          "launches bit-identical; issued per evaluation: " + _issued(
              "dndx", f"percell_kernelIfNS_11VahProducerIfLi{cfg.dimension}E"))
    return dict(launches=None, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                bound_ms=bound[0], bound_by=bound[1], library_ms=None,
                cells=gs, plain_cells=n)


def phase_polzn_pair(smi: str, clock: float, groups: list) -> list:
    """[polzn pair]: a polarization kernel on one canonical group (16384
    cells) of a main-path surface, f32, for each (kind, columns, species,
    grid, cfg, T_avg, plain_cells) of ``groups``: as [vah pair], the five
    sums each held to its plain version, the bound from
    kernels/polzn.py:polzn_formula_ops."""
    from is3d_tpu_torch.kernels import polzn
    from is3d_tpu_torch.kernels.smooth import (momentum_constants,
                                               remap_node_table)
    records = []
    for kind, cols, species, grid, cfg, T_avg, n in groups:
        flags = polzn.polzn_flags(cfg, grid)
        x = polzn.pack_polzn_cells(cols, T_avg, flags)
        x64 = polzn.pack_polzn_cells({k: v.double() for k, v in cols.items()},
                                     T_avg, flags)
        xs = x[:n].contiguous()
        mom = momentum_constants(species, grid, cfg.dimension)
        mom64 = mom.to(dtype=torch.float64)
        pm = polzn.species_pm(species)
        pm64 = polzn.species_pm(species.to(dtype=torch.float64))
        wR = polzn.node_weights(grid, flags)
        table = remap_node_table(mom) if flags.remap else None
        table64 = remap_node_table(mom64) if flags.remap else None
        got, m = _group_pair(
            f"polzn pair {kind}", [f" {s}" for s in polzn.SUMS],
            lambda: polzn.polzn_cuda(x, mom, pm, wR, flags, table),
            lambda: polzn.polzn_cuda(x64, mom64, pm64, wR.double(), flags,
                                     table64),
            lambda: polzn.polzn_cuda(xs, mom, pm, wR, flags, table),
            lambda: polzn.polzn_plain(xs, mom, pm, wR, flags,
                                      cfg.cell_chunk), n)
        R = mom.nodes.shape[0]
        evals = x.shape[0] * mom.mass.shape[0] * mom.px.shape[0] * R
        nb = _nbytes(x, pm, wR, *got, *mom_tensors(mom)) + (
            _nbytes(table) if flags.remap else 0)
        bound = _bound(evals, *polzn.polzn_formula_ops(flags.remap,
                                                      mom.n_phi), nb, clock)
        kernel = ("remap_kernelIfEEv" if flags.remap
                  else f"fixed_kernelIfLi{flags.dimension}EE")
        print(f"[polzn pair] {smi} | {kind}: one group {x.shape[0]} cells x "
              f"{tuple(got[0].shape)} x {R} nodes, five sums: "
              + _pair_line(m, evals, n, bound) + _issued("polzn", kernel))
        records.append(_pair_record(m, bound, x.shape[0], n))
    return records


def _first_group(cols: dict, cfg) -> dict:
    """The first canonical group of a run's cell columns."""
    from is3d_tpu_torch.parallel.mesh import canonical_groups
    _, gs = canonical_groups(cfg, cols["tau"].shape[0])
    return {k: v[:gs] for k, v in cols.items()}


def phase_vah(smi: str, clock: float):
    """The VAH paths: [vah main 2d] (mode 2, 2+1D, the mT remap) and [vah
    main 3d] (mode 2, 3+1D fixed nodes) through the CLI at 131072 x 320,
    each with a 256-cell cuda-against-cpu run (the 3+1D one on a mode-3
    surface); [vah pair] on one group of each (and of the 3+1D one with
    synthetic c0..c4: every chain on); [vah dndx] (operation 0, mode 2,
    16384 cells) and its group; the backward kernels' [grad vah pair] (the
    three groups) and [grad vah main 2d] (gated) and [grad vah main 3d]
    (every chain, synthetic c0..c4 on every cell).  Returns the kernel
    records of the three entry points, [vah main 2d]'s run directory (kept
    for [sample vah main 2d]) with its pion, kaon and proton dN/dy, and
    the records of the two backward kernels."""
    from is3d_tpu_torch import testing
    from is3d_tpu_torch.kernels import vah
    counts2, run_dir2, cfg2, _ = phase_main_path(
        smi, "vah main 2d", dimension=2, args=VAH2D_ARGS, n_nodes=48,
        want=("vah_spectra_remap",), mode=2)
    phase_small_path_cpu_vs_cuda("small_vah_2d", dimension=2,
                                 label="2+1D mode 2 mT remap", mode=2)
    counts3, run_dir3, cfg3, _ = phase_main_path(
        smi, "vah main 3d", args=VAH3D_ARGS, want=("vah_spectra",), mode=2)
    phase_small_path_cpu_vs_cuda("small_vah_3d", dimension=3,
                                 label="3+1D mode 3", mode=3)
    run2, species2, grid2 = _run_state(run_dir2, cfg2)
    run3, species3, grid3 = _run_state(run_dir3, cfg3)
    g2 = _first_group(vah.vah_surface_cols(run2.surface), cfg2)
    g3 = _first_group(vah.vah_surface_cols(run3.surface), cfg3)
    coeffs = testing.synthetic_vah_coefficients(
        {"tau": np.zeros(g3["tau"].shape[0])}, seed=0)
    g3c = dict(g3, **{k: torch.tensor(v, dtype=torch.float32, device="cuda")
                      for k, v in coeffs.items()})
    rec_remap, rec_fixed, rec_chains = phase_vah_pair(smi, clock, [
        ("2+1D remap", g2, species2, grid2, cfg2, 512),
        ("3+1D fixed", g3, species3, grid3, cfg3, 1024),
        ("3+1D fixed, every chain", g3c, species3, grid3, cfg3, 1024)])
    rec_bwd_remap, rec_bwd_off, rec_bwd = phase_grad_vah_pair(smi, clock, [
        ("2+1D remap", g2, species2, grid2, cfg2),
        ("3+1D fixed", g3, species3, grid3, cfg3),
        ("3+1D fixed, every chain", g3c, species3, grid3, cfg3)])
    rec_bwd_remap["launches"] = phase_grad_vah_main(
        smi, run2.surface, species2, grid2, cfg2, run2._prepare()[3],
        "grad vah main 2d", GRAD_VAH_WRT)["counts"]["vah_bwd_remap"]
    # every chain on: synthetic c0..c4 on every cell of the 3+1D surface
    coeffs = testing.synthetic_vah_coefficients(
        {"tau": np.zeros(run3.surface.n_cells)}, seed=0)
    surface3c = run3.surface.replace(**{
        k: torch.tensor(v, dtype=torch.float32, device="cuda")
        for k, v in coeffs.items()})
    rec_bwd.update(chains_off=rec_bwd_off, launches=phase_grad_vah_main(
        smi, surface3c, species3, grid3, cfg3, run3._prepare()[3],
        "grad vah main 3d", GRAD_VAH_CHAIN_WRT)["counts"]["vah_bwd"])
    shutil.rmtree(run_dir3, ignore_errors=True)
    # the operation-1 dN/dy [sample vah main 2d] holds its hadrons to
    dndy = _dndy_files(os.path.join(run_dir2, "results"), (211, 321, 2212))
    _keep("vah main 2d", run_dir2, VAH2D_ARGS, ("vah_spectra_remap",))
    rec_remap["launches"] = counts2["vah_spectra_remap"]
    rec_fixed.update(launches=counts3["vah_spectra"], every_chain=rec_chains)

    counts, run_dir, cfg = phase_dndx_main(
        smi, "vah dndx", VAH_DNDX_CELLS, VAH_DNDX_ARGS,
        want=("dndx_vah", "dndx_bin"), mode=2)
    phase_small_path_cpu_vs_cuda("small_vah_dndx", dimension=2,
                                 params=dict(operation=0),
                                 label="2+1D operation 0 mode 2", mode=2)
    rec_dndx = phase_vah_dndx_pair(smi, clock, run_dir, cfg)
    rec_dndx["launches"] = counts["dndx_vah"]
    shutil.rmtree(run_dir, ignore_errors=True)
    return (rec_fixed, rec_remap, rec_dndx, run_dir2, dndy, rec_bwd,
            rec_bwd_remap)


def phase_polzn(smi: str, clock: float):
    """The polarization paths: [grad small polzn] (K12a and K12b on
    testing.POLZN_EDGES); [polzn main 2d] (mode 5, 2+1D: the remap
    kernel, then K1's remap spectra) and [polzn main 3d] (3+1D: the
    fixed-node kernel, then K1) through the CLI at 131072 x 320, the
    first with its 256-cell cuda-against-cpu run; [polzn pair] and [grad
    polzn pair] on one group of each; [grad polzn main 2d] and [grad polzn
    main 3d] (the polarization's gradient at full width); [grad mode5] on
    the 2+1D surface.  Returns the kernel records of K6's two kernels and
    of K12a and K12b."""
    from is3d_tpu_torch.kernels import polzn
    phase_small_grad_polzn()
    counts2, run_dir2, cfg2, _ = phase_main_path(
        smi, "polzn main 2d", dimension=2, args=POLZN2D_ARGS, n_nodes=48,
        want=("polzn_remap", "smooth_spectra", "smooth_spectra_remap"),
        mode=5)
    phase_small_path_cpu_vs_cuda("small_polzn_2d", dimension=2,
                                 label="2+1D mode 5 (polarization, spectra)",
                                 mode=5)
    counts3, run_dir3, cfg3, _ = phase_main_path(
        smi, "polzn main 3d", args=POLZN3D_ARGS,
        want=("polzn", "smooth_spectra"), mode=5)
    run2, species2, grid2 = _run_state(run_dir2, cfg2)
    run3, species3, grid3 = _run_state(run_dir3, cfg3)
    g2 = (_first_group(polzn.polzn_cols(run2.surface), cfg2), species2,
          grid2, cfg2, run2.plasma().temperature)
    g3 = (_first_group(polzn.polzn_cols(run3.surface), cfg3), species3,
          grid3, cfg3, run3.plasma().temperature)
    rec_remap, rec_fixed = phase_polzn_pair(smi, clock, [
        ("2+1D remap",) + g2 + (512,), ("3+1D fixed",) + g3 + (1024,)])
    rec_bwd_remap, rec_bwd = phase_grad_polzn_pair(smi, clock, [
        ("2+1D remap",) + g2, ("3+1D fixed",) + g3])
    rec_bwd_remap["launches"] = phase_grad_polzn_main(
        smi, run_dir2, cfg2, "grad polzn main 2d")["counts"][
            "polzn_bwd_remap"]
    rec_bwd["launches"] = phase_grad_polzn_main(
        smi, run_dir3, cfg3, "grad polzn main 3d")["counts"]["polzn_bwd"]
    phase_grad_mode5(smi, run_dir2, cfg2)
    _keep("polzn main 2d", run_dir2, POLZN2D_ARGS,
          ("polzn_remap", "smooth_spectra", "smooth_spectra_remap"))
    shutil.rmtree(run_dir3, ignore_errors=True)
    rec_remap["launches"] = counts2["polzn_remap"]
    rec_fixed["launches"] = counts3["polzn"]
    return rec_fixed, rec_remap, rec_bwd, rec_bwd_remap


# ------------------------------------------------------------- operation 2

def _slot_err(name, want, got, counts, n_cap, dtype) -> tuple[int, int,
                                                              float]:
    """K7's slots (``got``) against its plain version's (``want``) on one
    batch: (flipped slots, valid slots, the largest difference of the lab
    momenta and eta on the slots decided alike, as a share of each field's
    largest value).  A slot is flipped where its acceptance, rounds or
    keep differ (a uniform within rounding of its weight); float64 allows
    none, float32 1e-4 of the slots.  The cell and species of every slot
    agree."""
    valid = (torch.arange(n_cap, device=counts.device)[None, :]
             < counts[:, None])
    flips = valid & ((want["ok"] != got["ok"])
                     | (want["rounds"] != got["rounds"])
                     | (want["keep"] != got["keep"]))
    nf, nv = int(flips.sum()), int(valid.sum())
    if nf > (0 if dtype == torch.float64 else 1e-4 * nv):
        fail(f"{name}: {nf} of {nv} slots decided otherwise than the plain "
             "version")
    for k in ("sidx", "cidx"):
        if not torch.equal(want[k][valid], got[k][valid]):
            fail(f"{name}: the kernel's {k} differ from the plain version's")
    both = valid & ~flips & want["ok"]
    rtol, atol = TOL[dtype]
    worst = 0.0
    for k in ("px", "py", "pz", "eta"):
        a, b = want[k][both].double(), got[k][both].double()
        scale = float(a.abs().max())
        err = (a - b).abs()
        if not torch.isfinite(b).all() or (
                err > rtol * a.abs() + atol * scale).any():
            fail(f"{name}: {k} outside rtol={rtol}, atol={atol}*max")
        worst = max(worst, float(err.max()) / scale)
    return nf, nv, worst


def _packed_same(name, got, ref, per_slot, cfg, n_species, n_cells,
                 cap) -> int:
    """K7's packed output ``got`` (packed arrays, per-event counts,
    totals) against pack_batch of its per-slot output: the same counts and
    totals, and the first min(kept, cap) entries of every packed field bit
    for bit.  Returns the kept count."""
    from is3d_tpu_torch.kernels import sample
    packed, per_event, small = got
    want, want_events = sample.pack_batch(per_slot, cfg, n_species, n_cells,
                                          cap)
    kept = int(want_events.sum())
    totals = [kept, int(per_slot["ok"].sum()), int(per_slot["rounds"].sum())]
    if not torch.equal(per_event, want_events) or small.tolist() != totals:
        fail(f"{name}: packed counts {per_event.tolist()}, "
             f"{small.tolist()}; pack_batch {want_events.tolist()}, {totals}")
    n = min(kept, cap)
    bits = lambda t: t.view(torch.int16) if t.dtype == torch.float16 else t
    if sorted(packed) != sorted(want) or not all(
            packed[k].dtype == want[k].dtype
            and torch.equal(bits(packed[k][:n]), bits(want[k][:n]))
            for k in want):
        fail(f"{name}: the packed arrays differ from pack_batch's")
    if ref is not None and not all(
            torch.equal(bits(packed[k][:n]), bits(ref[0][k][:n]))
            for k in packed):
        fail(f"{name}: two packed launches differ")
    return kept


def phase_small_yields():
    """[yields small]: K7b against species_yields_plain on
    testing.YIELDS_EDGES (df 1-4 and VAH, broken-down cells, a massless
    species, clamped densities, baryon chemistry, cold cells whose e^pbar
    would overflow), f32 and f64: the densities and row sums within TOL,
    two launches and the row-sums mode bit-identical."""
    from is3d_tpu_torch import testing
    from is3d_tpu_torch.kernels import sample
    for dtype in (torch.float32, torch.float64):
        for case in sorted(testing.YIELDS_EDGES):
            inp = testing.yields_edge_inputs(case, dtype, "cuda")
            args = (inp["cols"], inp["species"], inp["laguerre"], inp["cfg"])
            got, sums = sample.species_yields_cuda(*args)
            again, sums2 = sample.species_yields_cuda(*args)
            none, sums3 = sample.species_yields_cuda(*args, sums_only=True)
            want, wsums = sample.species_yields_plain(*args)
            torch.cuda.synchronize()
            name = f"[yields small] {case} {str(dtype)[6:]}"
            if not (none is None and torch.equal(got, again)
                    and torch.equal(sums, sums2)
                    and torch.equal(sums, sums3)):
                fail(f"{name}: two launches (or the row-sums mode) differ")
            _check(f"{name} densities", got, want, *TOL[dtype])
            _check(f"{name} row sums", sums, wsums, *TOL[dtype])
            try:
                seen = testing.yields_edge_seen(case, inp, got)
            except AssertionError as e:
                fail(f"{name}: the case did not exercise its edge: {e}")
            print(f"{name}: {seen}; two launches and the row-sums mode "
                  "bit-identical")


def phase_small_sample():
    """[sample small]: K7 against its plain version on testing.SAMPLE_EDGES
    (every df mode, 2+1D and 3+1D, broken-down cells, baryon diffusion;
    a massless species and zero-yield cells no slot may draw), f32 and
    f64, slot by slot, two launches bit-identical; its packed mode bit for
    bit against pack_batch of the per-slot output, at the run's packed
    capacity and at half the kept hadrons (past it), two launches
    bit-identical; then a batch forced past its packed capacity runs
    again, through the packed mode, to the same events."""
    from is3d_tpu_torch import testing
    from is3d_tpu_torch.config import Config
    from is3d_tpu_torch.io.surface import ThermoAverages
    from is3d_tpu_torch.kernels import sample
    flips = {}
    for case in sorted(testing.SAMPLE_EDGES):
        tag = ("[sample search small]" if "search" in case else
               "[sample vah small]" if "vah" in case else "[sample small]")
        for dtype in (torch.float32, torch.float64):
            inp = testing.sample_edge_inputs(case, dtype, "cuda")
            args = (inp["rows"], inp["layout"], inp["tables"],
                    inp["species"], inp["counts"], inp["seed"], inp["ev0"],
                    inp["n_cap"], inp["cfg"])
            got, again = (sample.event_batch_cuda(*args) for _ in range(2))
            want = sample.event_batch_plain(
                inp["rows"], inp["tables"], inp["species"], inp["counts"],
                sample.PhiloxSource(inp["seed"], inp["ev0"], dtype),
                inp["n_cap"], inp["cfg"])
            torch.cuda.synchronize()
            if not all(torch.equal(got[k], again[k]) for k in got):
                fail(f"[sample small] {case}: two launches differ")
            name = f"{tag} {case} {str(dtype)[6:]}"
            nf, nv, err = _slot_err(name, want, got, inp["counts"],
                                    inp["n_cap"], dtype)
            try:
                seen = testing.sample_edge_seen(case, inp, got)
            except AssertionError as e:
                fail(f"{name}: the case did not exercise its edge: {e}")
            f = flips.setdefault((tag, dtype), [0, 0])
            f[0] += nf
            f[1] += nv
            C, S = inp["rows"].shape[0], inp["species"].mass.shape[0]
            kept = int(got["keep"].sum())
            caps = (sample._packed_capacity(
                4, float(inp["cell"]["dn_tot"].sum()), inp["n_cap"]),
                max(kept // 2, 1))
            for cap in caps:
                runs = [sample.event_batch_packed_cuda(*args, cap)
                        for _ in range(2)]
                torch.cuda.synchronize()
                _packed_same(f"{name} packed cap {cap}", runs[1], runs[0],
                             got, inp["cfg"], S, C, cap)
            print(f"{name}: {seen}; {nf} flipped, max err {err:.2e} of max; "
                  "two launches bit-identical; packed mode identical to "
                  f"pack_batch at capacities {caps[0]} and {caps[1]} "
                  f"({kept} kept)")
    for (tag, dtype), (nf, nv) in flips.items():
        print(f"{tag} {str(dtype)[6:]}: {nf} of {nv} slots flipped "
              f"({nf / nv:.2e})")

    # a batch past its packed capacity runs again at twice it: same events
    f32 = torch.float32
    cfg = Config(operation=2, precision="f32", include_shear_deltaf=1,
                 include_bulk_deltaf=1, y_cut=3.0)
    kw = dict(nevents=6, events_per_batch=3, seed=5)
    args = (testing.synthetic_surface(512, 2, seed=3, dtype=f32,
                                      device="cuda"),
            testing.synthetic_species(13, f32, "cuda"), np.arange(13),
            testing.synthetic_deltaf_data(f32, "cuda"), cfg,
            ThermoAverages(0.152, 0.33, 0.057, 0.0, 0.0))
    info_ref, info = {}, {}
    ref = sample.sample_particles(*args, info=info_ref, **kw)
    packed_capacity = sample._packed_capacity
    sample._packed_capacity = lambda *a: 256
    _reset_counts()
    try:
        got = sample.sample_particles(*args, info=info, **kw)
    finally:
        sample._packed_capacity = packed_capacity
    if info["reruns"] < 1 or info_ref["reruns"]:
        fail(f"[sample small] forced rerun: {info['reruns']} reruns")
    _expect_counts("[sample small] forced rerun", _counts(), dict(
        sample_packed=info["batches"] + info["reruns"], alias_tables=3,
        species_yields=1))
    same = len(ref) == len(got) and all(
        a[k].tobytes() == b[k].tobytes() for a, b in zip(ref, got) for k in a)
    if not same:
        fail("[sample small] a rerun at twice the capacity changed events")
    print(f"[sample small] capacity 256 for batches of "
          f"{sum(len(e['mcid']) for e in ref[:3])} kept hadrons: "
          f"{info['reruns']} reruns, capacity {info['capacity']}, the same "
          "events byte for byte (packed mode, "
          f"{info['batches'] + info['reruns']} launches)")


def phase_small_alias():
    """[alias small]: K7a against its plain version on
    testing.alias_edge_weights (zero rows, one entry, flat rows, a 1e12
    range with 60 % zeros, the main path's row shapes, rows too long for
    shared memory), f32 and f64: the same tables bit for bit, two launches
    bit-identical; the rows a block of each shape."""
    from is3d_tpu_torch import testing
    from is3d_tpu_torch.kernels import sample
    for dtype in (torch.float32, torch.float64):
        names = []
        for name, w in testing.alias_edge_weights(dtype, "cuda").items():
            q0 = sample.alias_scale(w)
            got = sample.alias_tables_cuda(q0)
            again = sample.alias_tables_cuda(q0)
            want = sample.alias_tables_plain(*sample.alias_sort(w))
            torch.cuda.synchronize()
            for g, a, p in zip(got, again, want):
                if not (torch.equal(g, a) and torch.equal(g, p)):
                    fail(f"[alias small] {name} {dtype}: the kernel's "
                         "tables differ from the plain version's")
            per_block = sample._library().is3d_alias_rows_per_block(
                w.shape[1], int(dtype == torch.float64))
            names.append(f"{name} {tuple(w.shape)} ({per_block} rows a "
                         "block)")
        print(f"[alias small] {str(dtype)[6:]}: {', '.join(names)}: tables "
              "identical to the plain version's, two launches bit-identical")


@contextlib.contextmanager
def _no_host_sync():
    """Any operation that makes the host wait on the card raises inside."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def phase_small_cascade():
    """[cascade small]: K8 against cascade_plain on
    testing.cascade_edge_inputs (3000 hadrons of the 60-species decaying
    list, every pass), f32 and f64, on its tables (4 channels a species)
    and on them widened to testing.WIDE_CHANNELS, as real PDG lists are:
    the same daughters and lineage words, momenta and
    vertices within the tolerance, two runs bit-identical, one launch a
    pass queued with no host sync (set_sync_debug_mode("error")) and one
    read at the end; then the guards: a capacity too small raises, and a
    table short of a pass leaves unstable hadrons, which decay_events
    refuses."""
    from is3d_tpu_torch import testing
    from is3d_tpu_torch.kernels import mc_decays
    for dtype in (torch.float32, torch.float64):
        for channels in (None, testing.WIDE_CHANNELS):
            runs = [testing.cascade_edge_inputs(dtype, "cuda",
                                                channels=channels)
                    for _ in range(3)]
            a = runs[0]
            n_passes = a["tabs"].n_passes
            na = mc_decays.cascade_plain(a["state"], a["n0"], a["dev_tabs"],
                                         a["key"], n_passes)
            ns = []
            for r in runs[1:]:
                mc_decays.LAUNCHES = 0
                with _no_host_sync():
                    counts = mc_decays.launch_cascade(
                        r["state"], r["n0"], r["dev_tabs"], r["key"],
                        n_passes)
                if mc_decays.LAUNCHES != n_passes:
                    fail(f"[cascade small] {mc_decays.LAUNCHES} launches for "
                         f"{n_passes} passes")
                ns.append(mc_decays.final_count(counts,
                                                r["state"]["E"].shape[0]))
            nb, nc = ns
            torch.cuda.synchronize()
            b, c = runs[1]["state"], runs[2]["state"]
            tag = (f"[cascade small] {str(dtype)[6:]} "
                   f"{a['tabs'].cum.shape[1]} channels")
            if not na == nb == nc:
                fail(f"{tag}: {na}, {nb}, {nc} hadrons")
            for k in ("sidx", "eid", "lin") + mc_decays.STATE_FLOATS:
                if not torch.equal(b[k][:nb], c[k][:nb]):
                    fail(f"{tag}: two runs differ in {k}")
            for k in ("sidx", "eid", "lin"):
                if not torch.equal(a["state"][k][:na], b[k][:na]):
                    fail(f"{tag}: {k} differ from the plain version's")
            err = max(_check(f"{tag} {k}", b[k][:na], a["state"][k][:na],
                             *TOL[dtype])
                      for k in mc_decays.STATE_FLOATS)
            stable = a["tabs"].stable[b["sidx"][:nb].cpu().numpy()].all()
            print(f"{tag} {tuple(a['tabs'].cum.shape)}: {a['n0']} hadrons -> "
                  f"{nb} in {n_passes} passes ({n_passes} launches, no host "
                  f"sync between them), all stable {stable}, max err "
                  f"{err:.2e}; two runs bit-identical")
            if not stable:
                fail("[cascade small] unstable hadrons left")

    small = testing.cascade_edge_inputs(torch.float32, "cuda", n=64)
    st = {k: v[:small["n0"]].clone() for k, v in small["state"].items()}
    try:
        mc_decays.run_cascade(st, small["n0"], small["dev_tabs"],
                              small["key"], small["tabs"].n_passes)
        fail("[cascade small] a capacity of the input count did not raise")
    except RuntimeError as e:
        print(f"[cascade small] capacity {small['n0']}: raised ({e})")
    table, tabs = small["table"], mc_decays.cached_tables(small["table"], 111)
    r = np.random.default_rng(0)
    s = r.integers(0, len(tabs.mc_id), 3000)
    p = r.normal(0, 0.5, (3000, 3))
    z = np.zeros(3000)
    events = [dict(mcid=tabs.mc_id[s], mass=tabs.mass[s],
                   E=np.sqrt(tabs.mass[s]**2 + (p**2).sum(1)), px=p[:, 0],
                   py=p[:, 1], pz=p[:, 2], t=z + 6, x=z, y=z, z=z,
                   tau=z + 6, eta=z, yp=z)]
    tabs.n_passes -= 1
    try:
        mc_decays.decay_events(events, table, seed=1, device="cuda")
        fail("[cascade small] a table short of a pass did not raise")
    except RuntimeError as e:
        print(f"[cascade small] {tabs.n_passes} of {tabs.n_passes + 1} "
              f"passes: raised ({e})")
    finally:
        tabs.n_passes += 1


def _oscar_ok(path: str, n_events: int, n_hadrons: int, allowed=None):
    """The OSCAR list: one '# n' header an event with hadrons, n rows of 9
    numbers each, the header counts summing to ``n_hadrons``; the first
    100000 rows finite, their mc ids in ``allowed``."""
    headers, rows = [], 0
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"#"):
                headers.append(int(line.split()[1]))
            else:
                rows += 1
    if len(headers) > n_events or sum(headers) != n_hadrons or rows != sum(
            headers):
        fail(f"{path}: {len(headers)} events, {sum(headers)} hadrons in "
             f"the headers, {rows} rows; expected {n_hadrons} hadrons in at "
             f"most {n_events} events")
    head = np.loadtxt(path, comments="#", max_rows=100000)
    if head.shape[1] != 9 or not np.isfinite(head).all():
        fail(f"{path}: rows are not 9 finite numbers")
    if allowed is not None and not np.isin(head[:, 0].astype(np.int64),
                                           allowed).all():
        fail(f"{path}: mc ids outside the allowed set")
    return os.path.getsize(path)


def _sample_counts(cfg, info, decays=False) -> dict:
    """The launches of one operation-2 run: K7b once (a chunked run: twice a
    chunk, the pre-pass and the chunk's phase A), K7a three times a table
    build with alias draws, K7's packed mode (its surface's and draw's
    instantiation) once a batch and once a rerun, K8 once a pass."""
    vah, search = cfg.mode in (2, 3), not cfg.sampler_alias
    tables = info.get("chunks", 1)
    want = {("species_yields_vah" if vah else "species_yields"):
            2 * tables if "chunks" in info else 1,
            ("sample_packed_search" if search else "sample_packed_vah" if vah
             else "sample_packed"): info["batches"] + info["reruns"]}
    if not search:
        want["alias_tables"] = 3 * tables
    if decays:
        want["mc_cascade"] = info["decays"]["passes"]
    return want


def phase_sample_main(smi: str, name: str, args, decays=False, run_dir=None,
                      mode=1):
    """One operation-2 run at full width through the API a user calls
    (``IS3D.from_run_dir(...).run_particlization()``; the CLI's path) on a
    synthetic 131072-cell x 320-species 2+1D run directory (``decays``: the
    decaying list; ``run_dir``: an existing one of surface ``mode``):
    phases, the sampler's split (phase A, dispatch, wait for the card, the
    copy to the host, event assembly), kept hadrons/s, efficiency; K7b
    once, K7 launched once a batch (and once a rerun), K7a three times (the
    2-level cell table and the species table) with alias draws, K8 once a
    pass with decays; the OSCAR list (with decays: stable hadrons only).
    Returns (counts, run_dir, cfg, info, result)."""
    from is3d_tpu_torch.api import IS3D
    from is3d_tpu_torch.config import load_config
    from is3d_tpu_torch.testing import write_synthetic_run_dir
    from is3d_tpu_torch.utils import PhaseTimer

    if run_dir is None:
        run_dir = os.path.join(WORK, name.replace(" ", "_"))
        t0 = time.perf_counter()
        write_synthetic_run_dir(run_dir, MAIN_CELLS, MAIN_SPECIES,
                                dimension=2, seed=0, decays=decays, mode=mode)
        print(f"[{name}] synthetic run dir {MAIN_CELLS} cells x "
              f"{MAIN_SPECIES} species written in "
              f"{time.perf_counter() - t0:.2f} s")
    overrides = dict(a.split("=", 1) for a in args[1:])
    _reset_counts()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = IS3D.from_run_dir(run_dir, overrides=overrides, device="cuda")
        timer = PhaseTimer(verbose=False)
        result = run.run_particlization(timer=timer)
    wall = time.perf_counter() - t0
    counts = _counts()
    for line in buf.getvalue().splitlines():
        print(f"[{name}] run: {line}")
    phases = dict(timer.phases)
    info = result.sample_info
    cfg = load_config(os.path.join(run_dir, "iS3D_parameters.dat"),
                      overrides=overrides)
    want = _sample_counts(cfg, info, decays)
    _expect_counts(f"{name} path", counts, want)
    n_ev = len(result.events)
    n_had = sum(len(e["mcid"]) for e in result.events)
    allowed = None
    if decays:
        table = run._prepare()[0]
        allowed = np.asarray(table.mc_id)[np.asarray(table.stable, bool)]
        allowed = np.concatenate([allowed, [run.cfg.lightest_particle]])
    size = _oscar_ok(os.path.join(run_dir, "results", "particle_list_osc.dat"),
                     n_ev, n_had, allowed)
    t = info["timings"]
    t_s = phases["sampler"]
    eff = 100.0 * info["accepted"] / info["proposed"]
    print(f"[{name}] {smi} | prepare "
          f"{phases['prepare (io, pdg, deltaf)']:.3f} s, sampler {t_s:.3f} s "
          f"(phase A {t['phase_a']:.3f}, dispatch {t['dispatch']:.3f}, wait "
          f"{t['wait']:.3f}, copy {t['copy']:.3f}, assembly "
          f"{t['assembly']:.3f}), "
          + (f"MC decays {phases['MC resonance decays']:.3f} s "
             f"({info['decays']['hadrons_in']} unstable -> "
             f"{info['decays']['hadrons_out']} in {info['decays']['passes']} "
             f"passes, capacity {info['decays']['capacity']}; "
             + ", ".join(f"{k} {v:.4f}" for k, v in
                         info["decays"]["timings"].items())
             + "), " if decays else "")
          + f"writers {phases['writers']:.3f} s, wall {wall:.3f} s | "
          f"{n_ev} events ({info['batches']} batches of "
          f"{info['events_per_batch']}, {info['reruns']} reruns, n_cap "
          f"{info['n_cap']}, lam {info['lam']:.1f}), {n_had} hadrons "
          f"(total yield {n_ev * info['total_yield']:.1f}), "
          f"{n_had / t_s:.4e} hadrons/s in the sampler phase, efficiency "
          f"{eff:.2f} %, OSCAR {size / 1e6:.1f} MB | launches "
          + ", ".join(f"{k} {counts[k]}" for k in want))
    return counts, run_dir, cfg, info, result


def _species_counts(events, mcids) -> np.ndarray:
    """Hadrons of each species in ``events``."""
    ids = np.concatenate([e["mcid"] for e in events])
    order = np.argsort(mcids)
    pos = np.searchsorted(mcids[order], ids)
    return np.bincount(order[pos], minlength=len(mcids))


def _sample_bound(ops: dict, clock: float) -> tuple[float, str]:
    """The least time (ms) of a sampler or cascade launch: the larger of
    its bytes over the memory rate and its multiply-highs and special
    functions over their lanes' rates at the maximum SM clock."""
    t = dict(bytes=ops["bytes"] / HBM_RATE,
             operations=max(ops["mulhi"] / (N_SM * INT32_LANES * clock),
                            ops["sfu"] / (N_SM * SFU_LANES * clock)))
    by = max(t, key=t.get)
    return t[by] * 1e3, by


def phase_sample_pair(smi: str, clock: float, run_dir: str, cfg,
                      info: dict):
    """[sample pair]: on the [sample main 2d] surface, f32 (device times:
    5 calls queued behind a device-side sleep, median of 3): alias_scale
    and K7a (its stable sort and pass) on the (131072, 320) species table,
    beside torch's stable sort of the same rows (K7a against its plain
    version, identical, one timed run) with its byte bound; K7 on one batch of the main path's shape in per-slot mode
    (median of 3; two launches bit-identical) beside its bound
    (kernels/sample.py: sample_formula_ops, from this batch's slots and
    rounds) and pack_batch's compaction of its output (the path before
    K7's packed mode), and in packed mode beside its own bound (the same
    gathers, the packed bytes as output): bit-identical to pack_batch of
    the per-slot output at the run's capacity and at half the kept
    hadrons; the batch's last event at full width and a small batch of
    SAMPLE_PLAIN_SLOTS slots against the plain version, slot by slot.
    Returns the kernel records of K7 and K7a."""
    from is3d_tpu_torch.kernels import rng, sample
    from is3d_tpu_torch.utils import cuda_queued_ms
    # device time: 5 calls queued behind a device-side sleep, median of 3
    timed = lambda fn: cuda_queued_ms(fn, inner=5, n=3)
    from is3d_tpu_torch.api import IS3D
    run = IS3D(cfg, data_dir=run_dir, device="cuda")
    _, df_data, species, _, _ = run._prepare()
    cell = sample.build_cell_data(run.surface, species, df_data, cfg,
                                  run.plasma())
    species = sample._cast_floats(species, torch.float32)
    dn = cell.pop("dn_list")
    C, S = dn.shape

    q0 = sample.alias_scale(dn)
    scale_ms, _ = timed(lambda: sample.alias_scale(dn))
    sort_ms, _ = timed(lambda: sample._sort_rows(q0))
    got = sample.alias_tables_cuda(q0)
    a_ms, a_runs = timed(lambda: sample.alias_tables_cuda(q0))
    want, a_plain_ms = _timed_once(lambda: sample.alias_tables_plain(
        *sample._sort_rows(q0)))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        fail("[sample pair] K7a's species table differs from the plain "
             "version's")
    del want, got, q0
    a_bound = sample.alias_formula_bytes(C, S, 4) / HBM_RATE * 1e3
    per_block = sample._library().is3d_alias_rows_per_block(S, 0)
    print(f"[sample pair] {smi} | species table {C} x {S}: alias_scale "
          f"(torch) {scale_ms:.3f} ms; K7a (the stable sort and the pass) "
          f"{a_ms:.3f} ms (runs {', '.join(f'{x:.3f}' for x in a_runs)}; "
          f"{per_block} rows a block), against torch's stable sort alone "
          f"{sort_ms:.3f} ms; plain {a_plain_ms:.1f} ms (one run), tables "
          f"identical; bound {a_bound:.4f} ms (bytes), kernel at "
          f"{a_bound / a_ms:.2%} of it")

    tables = sample.build_alias_tables(dn, cell["dn_tot"])
    del dn
    rows, layout = sample.pack_rows(cell, cfg)
    lam, n_cap, B = info["lam"], info["n_cap"], info["events_per_batch"]
    seed = 17
    counts = torch.as_tensor(rng.poisson_counts(seed, range(B), lam),
                             dtype=torch.int32, device="cuda")
    kern = lambda: sample.event_batch_cuda(rows, layout, tables, species,
                                           counts, seed, 0, n_cap, cfg)
    out, again = kern(), kern()
    torch.cuda.synchronize()
    if not all(torch.equal(out[k], again[k]) for k in out):
        fail("[sample pair] two launches of K7 differ")
    del again
    k_ms, k_runs = timed(kern)
    n_valid, n_rounds = int(counts.sum()), int(out["rounds"].sum())
    ops = sample.sample_formula_ops(B * n_cap, n_valid, n_rounds, rows,
                                    tables)
    bound = _sample_bound(ops, clock)
    cap = info["capacity"]
    p_ms, _ = timed(lambda: sample.pack_batch(out, cfg, S, C, cap))
    kept = int(out["keep"].sum())

    # packed mode: bit for bit pack_batch's, at the run's capacity and
    # past half the kept hadrons
    pk = lambda c: sample.event_batch_packed_cuda(
        rows, layout, tables, species, counts, seed, 0, n_cap, cfg, c)
    for c in (cap, kept // 2):
        first = pk(c)
        _packed_same(f"[sample pair] packed, capacity {c}", pk(c), first,
                     out, cfg, S, C, c)
        del first
    pk_ms, pk_runs = timed(lambda: pk(cap))
    packed = pk(cap)[0]
    pk_ops = sample.sample_formula_ops(
        B * n_cap, n_valid, n_rounds, rows, tables,
        out_bytes=sample.packed_bytes(packed, kept, B))
    pk_bound = _sample_bound(pk_ops, clock)
    del packed

    # the batch's last event at full width against the plain version:
    # every slot counter to n_cap, a global event past the first
    last = B - 1
    want, last_ms = _timed_once(lambda: sample.event_batch_plain(
        rows, tables, species, counts[last:],
        sample.PhiloxSource(seed, last, torch.float32), n_cap, cfg))
    nf_last, nv_last, err_last = _slot_err(
        f"[sample pair] event {last} at full width", want,
        {k: v[last:] for k, v in out.items()}, counts[last:], n_cap,
        torch.float32)
    del want

    small = torch.tensor([SAMPLE_PLAIN_SLOTS], dtype=torch.int32,
                         device="cuda")
    ks = lambda: sample.event_batch_cuda(rows, layout, tables, species, small,
                                         seed, 0, SAMPLE_PLAIN_SLOTS, cfg)
    got = ks()
    want, plain_ms = _timed_once(lambda: sample.event_batch_plain(
        rows, tables, species, small,
        sample.PhiloxSource(seed, 0, torch.float32), SAMPLE_PLAIN_SLOTS,
        cfg))
    nf, nv, err = _slot_err("[sample pair] small batch", want, got, small,
                            SAMPLE_PLAIN_SLOTS, torch.float32)
    ks_ms, _ = timed(ks)
    print(f"[sample pair] event {last} of the batch, {nv_last} slots: "
          f"plain {last_ms:.1f} ms (one run), {nf_last} flipped, max err "
          f"{err_last:.2e} of max")
    print(f"[sample pair] {smi} | K7 one batch {B} events x {n_cap} slots "
          f"({n_valid} hadrons to sample, {n_rounds} proposals = "
          f"{n_rounds / n_valid:.3f} a slot, {kept} kept): per-slot mode "
          f"{k_ms:.3f} ms (runs {', '.join(f'{x:.3f}' for x in k_runs)}), "
          f"bound {bound[0]:.4f} ms ({bound[1]}: {ops['bytes'] / 1e6:.1f} "
          f"MB, {ops['mulhi']:.4e} multiply-highs, {ops['sfu']:.4e} special "
          f"functions), kernel at {bound[0] / k_ms:.1%} of it; pack_batch "
          f"of its output (cumsum and index copy) {p_ms:.3f} ms; packed "
          f"mode {pk_ms:.3f} ms (runs "
          f"{', '.join(f'{x:.3f}' for x in pk_runs)}), "
          f"{kept / pk_ms * 1e3:.4e} kept hadrons/s, bound "
          f"{pk_bound[0]:.4f} ms ({pk_bound[1]}: "
          f"{pk_ops['bytes'] / 1e6:.1f} MB), at {pk_bound[0] / pk_ms:.1%} "
          f"of it, bit-identical to pack_batch at capacities {cap} and "
          f"{kept // 2}; two launches bit-identical; small batch of "
          f"{SAMPLE_PLAIN_SLOTS} slots: kernel {ks_ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms (one run), {nf} of {nv} slots flipped, max err "
          f"{err:.2e} of max")
    rec_k7 = dict(launches=None, max_abs_err=max(err, err_last), ms=k_ms,
                  plain_ms=plain_ms,
                  bound_ms=bound[0], bound_by=bound[1], library_ms=None,
                  slots=B * n_cap, plain_slots=SAMPLE_PLAIN_SLOTS,
                  kernel_ms_on_plain_slots=ks_ms, flipped=nf + nf_last,
                  full_event_slots=nv_last, full_event_plain_ms=last_ms,
                  packed_ms=pk_ms, packed_bound_ms=pk_bound[0],
                  packed_bound_by=pk_bound[1], compaction_ms_before=p_ms)
    rec_k7a = dict(launches=None, max_abs_err=0.0, ms=a_ms,
                   plain_ms=a_plain_ms, bound_ms=a_bound, bound_by="bytes",
                   library_ms=None, rows=C, width=S, rows_per_block=per_block,
                   alias_scale_ms=scale_ms, torch_sort_ms=sort_ms)
    return rec_k7, rec_k7a


def _restored(work: dict, snap: dict, n: int):
    """``fn`` that copies the first ``n`` slots of ``snap`` over ``work``
    (all a K8 pass reads; it writes only those and slots past n)."""
    dst = [work[k][:n] for k in snap]
    src = [snap[k][:n] for k in snap]
    return lambda: torch._foreach_copy_(dst, src)


def _queued_less(fn, restore) -> float:
    """Device ms of ``fn`` run after ``restore``: both queued (5 calls
    behind a device-side sleep, median of 5), less ``restore`` alone."""
    from is3d_tpu_torch.utils import cuda_queued_ms
    both, _ = cuda_queued_ms(lambda: (restore(), fn()), inner=5, n=5)
    alone, _ = cuda_queued_ms(restore, inner=5, n=5)
    return both - alone


def phase_cascade_pair(smi: str, clock: float, run_dir: str, cfg):
    """[cascade pair]: K8 pass by pass on the unstable hadrons of the
    [sample decays] run's events (the same 2 events, seed 17; f32), each
    pass on a copy of the state it starts from: its device time (the
    launch queued behind a restore of the state, less the restore alone;
    utils.cuda_queued_ms) beside its bound
    (kernels/mc_decays.py:cascade_formula_ops), CUDA events around one
    call of the one-pass entry (the earlier method, the host's enqueue and
    the count's read included), and the plain version on the same state
    (one timed run; the same daughters and lineage words, floats within
    TOL).  Then the whole cascade: one run_cascade call (every pass
    queued, one read) under CUDA events, its passes' device time, one
    launch a pass.  Returns K8's kernel record (the pass with the most
    decays)."""
    from is3d_tpu_torch.api import IS3D
    from is3d_tpu_torch.kernels import mc_decays, rng, sample
    run = IS3D(cfg, data_dir=run_dir, device="cuda")
    table, df_data, species, mcids, _ = run._prepare()
    events = sample.sample_particles(run.surface, species, mcids, df_data,
                                     cfg, run.plasma(), nevents=2, seed=17)
    inp = mc_decays.cascade_inputs(events, table, cfg.lightest_particle,
                                   mc_decays.derive_decay_seed(17),
                                   device="cuda")
    st, n0, tabs = inp["state"], inp["n0"], inp["tabs"]
    dev_tabs, key = inp["dev_tabs"], inp["key"]
    C = st["E"].shape[0]
    first = {k: v.clone() for k, v in st.items()}
    table_bytes = sum(t.nbytes for t in dev_tabs.values())
    work = {k: v.clone() for k, v in st.items()}
    counts, scratch = mc_decays.cascade_buffers(C, 1, n0, "cuda")
    go = mc_decays.pass_launcher(work, dev_tabs, key, counts, scratch)
    best, n, bound_all = None, n0, 0.0
    for p in range(tabs.n_passes):
        snap = {k: v.clone() for k, v in st.items()}

        restore = _restored(work, snap, n)
        ms = _queued_less(lambda: go(0, n), lambda: (
            restore(), counts.fill_(n), scratch.zero_()))
        times = []
        for _ in range(3):
            s = {k: v.clone() for k, v in snap.items()}
            n_new, t = _timed_once(lambda: mc_decays.cascade_pass_cuda(
                s, n, dev_tabs, key))
            times.append(t)
        plain = {k: v.clone() for k, v in snap.items()}
        lin = plain["lin"][:n]
        n_plain, plain_ms = _timed_once(lambda: mc_decays.cascade_pass_plain(
            plain, n, dev_tabs, rng.decay_uniforms(key, lin, torch.float32),
            tuple(rng.child_lineage(key, lin, j) for j in (1, 2, 3))))
        if n_plain != n_new:
            fail(f"[cascade pair] pass {p}: {n_new} hadrons, plain {n_plain}")
        for k in ("sidx", "eid", "lin"):
            if not torch.equal(s[k][:n_new], plain[k][:n_new]):
                fail(f"[cascade pair] pass {p}: {k} differ")
        err = max(_check(f"[cascade pair] pass {p} {k}", s[k][:n_new],
                         plain[k][:n_new], *TOL[torch.float32])
                  for k in mc_decays.STATE_FLOATS)
        n_dec = int((dev_tabs["stable"][st["sidx"][:n].long()] == 0).sum())
        ops = mc_decays.cascade_formula_ops(n, n_dec, n_new - n, 4,
                                            table_bytes)
        bound = _sample_bound(ops, clock)
        bound_all += bound[0]
        events_ms = float(np.median(times))
        print(f"[cascade pair] {smi} | pass {p}: {n} live, {n_dec} decay, "
              f"-> {n_new}: {ms:.4f} ms on the device (events around one "
              f"call {events_ms:.3f} ms, runs "
              f"{', '.join(f'{x:.3f}' for x in times)}), plain "
              f"{plain_ms:.3f} ms; bound {bound[0]:.4f} ms ({bound[1]}), "
              f"kernel at {bound[0] / ms:.1%} of it")
        if best is None or n_dec > best["decaying"]:
            best = dict(launches=None, max_abs_err=err, ms=ms,
                        plain_ms=plain_ms, bound_ms=bound[0],
                        bound_by=bound[1], library_ms=None,
                        ms_events_one_call=events_ms, pass_index=p,
                        live=n, decaying=n_dec)
        st = s
        n = n_new

    # the whole cascade from the first state: one call, and on the device
    def cascade():
        s = {k: v.clone() for k, v in first.items()}
        torch.cuda.synchronize()
        mc_decays.LAUNCHES = 0
        return _timed_once(lambda: mc_decays.run_cascade(
            s, n0, dev_tabs, key, tabs.n_passes))
    calls = [cascade() for _ in range(5)]
    if mc_decays.LAUNCHES != tabs.n_passes or {c[0] for c in calls} != {n}:
        fail(f"[cascade pair] the cascade: {mc_decays.LAUNCHES} launches, "
             f"{sorted({c[0] for c in calls})} hadrons; expected "
             f"{tabs.n_passes} and {n}")
    cascade_ms = float(np.median([c[1] for c in calls]))
    device_ms = _queued_less(
        lambda: mc_decays.launch_cascade(work, n0, dev_tabs, key,
                                         tabs.n_passes),
        _restored(work, first, n0))
    print(f"[cascade pair] {smi} | the cascade, {n0} -> {n} hadrons in "
          f"{tabs.n_passes} passes ({tabs.n_passes} launches, one read): "
          f"{cascade_ms:.4f} ms as one call (runs "
          f"{', '.join(f'{c[1]:.3f}' for c in calls)}), {device_ms:.4f} ms "
          f"on the device; bound {bound_all:.4f} ms, at "
          f"{bound_all / device_ms:.1%} of the device time")
    best.update(cascade_ms=cascade_ms, cascade_device_ms=device_ms,
                cascade_bound_ms=bound_all)
    return best


def _yields_inputs(run, cfg) -> tuple:
    """K7b's float32 inputs on a run's surface as phase A builds them (VH:
    the cells' T, alpha_B, bulkPi, breakdown and df coefficients; VAH:
    Lambda and a_L), with the species and the Gauss-Laguerre rules."""
    from is3d_tpu_torch.io.tables import laguerre_device
    from is3d_tpu_torch.kernels import sample
    from is3d_tpu_torch.kernels.common import prepare_cells
    f32 = torch.float32
    _, df_data, species, _, _ = run._prepare()
    species = sample._cast_floats(species, f32)
    lag = laguerre_device(32, (1, 2), dtype=f32, device="cuda")
    if cfg.mode in (2, 3):
        return dict(Lambda=run.surface.Lambda.to(f32),
                    aL=run.surface.aL.to(f32)), species, lag
    c = prepare_cells(sample._cast_floats(sample._sampler_cols(
        run.surface, cfg), f32), cfg, sample._cast_floats(df_data, f32))
    df = c["df"]
    return dict(T=c["T"], alphaB=c["alphaB"], bulkPi=c["bulkPi"],
                breakdown=torch.zeros_like(c["T"], dtype=torch.bool),
                F=df.F, G=df.G, z=df.z, betabulk=df.betabulk), species, lag


def phase_yields_pair(smi: str, clock: float, tag: str, run, cfg) -> dict:
    """[yields pair] on a main path's surface (131072 cells x 320 species,
    f32): K7b's device time (5 calls queued behind a device-side sleep,
    median of 3; utils.cuda_queued_ms), its row-sums mode's, two launches
    bit-identical, against its plain version (the torch quadrature phase A
    ran before K7b, one timed run on the card) within TOL, and its bound
    (kernels/sample.py:yields_formula_ops).  Returns K7b's record."""
    from is3d_tpu_torch.kernels import sample
    from is3d_tpu_torch.utils import cuda_queued_ms
    cols, species, lag = _yields_inputs(run, cfg)
    kern = lambda sums_only=False: sample.species_yields_cuda(
        cols, species, lag, cfg, sums_only)
    got, sums = kern()
    again, sums2 = kern()
    torch.cuda.synchronize()
    if not (torch.equal(got, again) and torch.equal(sums, sums2)):
        fail(f"[{tag}] two launches of K7b differ")
    del again, sums2
    k_ms, k_runs = cuda_queued_ms(kern, inner=5, n=3)
    s_ms, _ = cuda_queued_ms(lambda: kern(True), inner=5, n=3)
    (want, wsums), plain_ms = _timed_once(lambda: sample.species_yields_plain(
        cols, species, lag, cfg))
    err = _check(f"[{tag}] densities", got, want, *TOL[torch.float32])
    _check(f"[{tag}] row sums", sums, wsums, *TOL[torch.float32])
    C, S = got.shape
    Q = lag[1][0].shape[0]
    del want, wsums, got
    ops = sample.yields_formula_ops(C, S, Q, cfg, 4)
    t = dict(bytes=ops["bytes"] / HBM_RATE,
             operations=ops["sfu"] / (N_SM * SFU_LANES * clock))
    by = max(t, key=t.get)
    bound = t[by] * 1e3
    print(f"[{tag}] {smi} | K7b on {C} cells x {S} species x {Q} nodes: "
          f"{k_ms:.4f} ms (runs {', '.join(f'{x:.4f}' for x in k_runs)}), "
          f"row sums alone {s_ms:.4f} ms; bound {bound:.4f} ms ({by}: "
          f"{ops['sfu']:.4e} special functions, {ops['bytes'] / 1e6:.1f} "
          f"MB), kernel at {bound / k_ms:.1%} of it; the plain torch "
          f"quadrature (phase A's before K7b) {plain_ms:.1f} ms (one run); "
          "two launches bit-identical")
    return dict(launches=None, max_abs_err=err, ms=k_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None, cells=C,
                species=S, nodes=Q, sums_only_ms=s_ms)


def phase_sample_kernel_pair(smi: str, clock: float, tag: str, run, cfg,
                             df_data, seed: int = 17) -> dict:
    """[tag]: one batch of a main path's shape (the run's events per batch
    x n_cap, f32) through ``cfg``'s K7 instantiation: per-slot mode (two
    launches bit-identical) and packed mode (bit for bit pack_batch of the
    per-slot output at the run's capacity and at half the kept hadrons),
    device times (5 calls queued, median of 3) beside their bounds
    (kernels/sample.py:sample_formula_ops); SAMPLE_PLAIN_SLOTS slots
    against the plain version, slot by slot.  Returns K7's record."""
    from is3d_tpu_torch.kernels import rng, sample
    from is3d_tpu_torch.utils import cuda_queued_ms
    timed = lambda fn: cuda_queued_ms(fn, inner=5, n=3)
    _, _, species, _, _ = run._prepare()
    species = sample._cast_floats(species, torch.float32)
    cell = sample.build_cell_data(run.surface, species, df_data, cfg,
                                  run.plasma())
    lam = float(cell["dn_tot"].sum())
    tables = sample.build_draw_tables(cell.pop("dn_list"), cell["dn_tot"],
                                      cfg, lam)
    rows, layout = sample.pack_rows(cell, cfg)
    C, S = rows.shape[0], species.mass.shape[0]
    n_cap = sample._slot_capacity(lam)
    total = abs(sample._total_yield(cell, cfg))
    n_ev = sample._oversample_nevents(None, total, cfg)
    B = sample._batch_width(n_ev, n_cap)
    cap = sample._packed_capacity(B, min(total, lam) or lam, n_cap)
    counts = torch.as_tensor(rng.poisson_counts(seed, range(B), lam),
                             dtype=torch.int32, device="cuda")
    kern = lambda: sample.event_batch_cuda(rows, layout, tables, species,
                                           counts, seed, 0, n_cap, cfg)
    out, again = kern(), kern()
    torch.cuda.synchronize()
    if not all(torch.equal(out[k], again[k]) for k in out):
        fail(f"[{tag}] two launches of K7 differ")
    del again
    k_ms, k_runs = timed(kern)
    n_valid, n_rounds = int(counts.sum()), int(out["rounds"].sum())
    ops = sample.sample_formula_ops(B * n_cap, n_valid, n_rounds, rows,
                                    tables)
    bound = _sample_bound(ops, clock)
    kept = int(out["keep"].sum())
    pk = lambda c: sample.event_batch_packed_cuda(
        rows, layout, tables, species, counts, seed, 0, n_cap, cfg, c)
    for c in (cap, kept // 2):
        first = pk(c)
        _packed_same(f"[{tag}] packed, capacity {c}", pk(c), first, out,
                     cfg, S, C, c)
        del first
    pk_ms, pk_runs = timed(lambda: pk(cap))
    packed = pk(cap)[0]
    pk_ops = sample.sample_formula_ops(
        B * n_cap, n_valid, n_rounds, rows, tables,
        out_bytes=sample.packed_bytes(packed, kept, B))
    pk_bound = _sample_bound(pk_ops, clock)
    del packed, out
    small = torch.tensor([SAMPLE_PLAIN_SLOTS], dtype=torch.int32,
                         device="cuda")
    ks = lambda: sample.event_batch_cuda(rows, layout, tables, species, small,
                                         seed, 0, SAMPLE_PLAIN_SLOTS, cfg)
    got = ks()
    want, plain_ms = _timed_once(lambda: sample.event_batch_plain(
        rows, tables, species, small,
        sample.PhiloxSource(seed, 0, torch.float32), SAMPLE_PLAIN_SLOTS,
        cfg))
    nf, nv, err = _slot_err(f"[{tag}] small batch", want, got, small,
                            SAMPLE_PLAIN_SLOTS, torch.float32)
    ks_ms, _ = timed(ks)
    print(f"[{tag}] {smi} | K7 ({sample._event_library(cfg, tables)}, df "
          f"code {sample._kernel_df(cfg)}) one batch {B} events x {n_cap} "
          f"slots ({n_valid} hadrons to sample, {n_rounds} proposals, "
          f"{kept} kept): per-slot mode {k_ms:.3f} ms (runs "
          f"{', '.join(f'{x:.3f}' for x in k_runs)}), bound {bound[0]:.4f} "
          f"ms ({bound[1]}: {ops['bytes'] / 1e6:.1f} MB), kernel at "
          f"{bound[0] / k_ms:.1%} of it; packed mode {pk_ms:.3f} ms (runs "
          f"{', '.join(f'{x:.3f}' for x in pk_runs)}), bound "
          f"{pk_bound[0]:.4f} ms ({pk_bound[1]}), at "
          f"{pk_bound[0] / pk_ms:.1%} of it, bit-identical to pack_batch at "
          f"capacities {cap} and {kept // 2}; two launches bit-identical; "
          f"small batch of {SAMPLE_PLAIN_SLOTS} slots: kernel {ks_ms:.3f} "
          f"ms, plain {plain_ms:.1f} ms (one run), {nf} of {nv} slots "
          f"flipped, max err {err:.2e} of max")
    return dict(launches=None, max_abs_err=err, ms=k_ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1], library_ms=None,
                slots=B * n_cap, plain_slots=SAMPLE_PLAIN_SLOTS,
                kernel_ms_on_plain_slots=ks_ms, flipped=nf, packed_ms=pk_ms,
                packed_bound_ms=pk_bound[0], packed_bound_by=pk_bound[1])


def _dndy_files(results: str, mcids) -> dict:
    """dN/dy at y = 0 of each of ``mcids`` from an operation-1 results
    tree (dN_dy_MCID.dat)."""
    out = {}
    for m in mcids:
        rows = np.atleast_2d(np.loadtxt(os.path.join(results,
                                                     f"dN_dy_{m}.dat")))
        out[m] = float(rows[np.argmin(np.abs(rows[:, 0])), 1])
    return out


def phase_sample_vah(smi: str, clock: float, run_dir: str, dndy: dict):
    """[sample vah main 2d]: operation 2 on the [vah main 2d] surface (mode
    2, 131072 x 320, 2+1D, f32, the chains gated off) through the API (the
    CLI's path), oversampled to 1.5e6 hadrons, the OSCAR list: K7b (VAH)
    once, K7a three times, K7-VAH's packed mode once a batch; pion, kaon
    and proton dN/dy within 5 sigma + 2 % of that surface's operation-1
    spectra (``dndy``).  Its 256-cell cuda-against-cpu runs (mode 2 in
    2+1D, mode 3 in 3+1D, f64).  [sample vah pair]: one batch of that shape
    with synthetic c0..c4 (every chain on); [yields pair] for VAH.
    Returns the records of K7-VAH and K7b (VAH)."""
    import dataclasses
    from is3d_tpu_torch import testing
    from is3d_tpu_torch.api import IS3D
    from is3d_tpu_torch.kernels import sample
    counts, run_dir, cfg, info, result = phase_sample_main(
        smi, "sample vah main 2d", SAMPLE_VAH2D_ARGS, run_dir=run_dir,
        mode=2)
    n_ev = len(result.events)
    n_sp = _species_counts(result.events, np.asarray(result.mcids))
    lines = []
    for m, want in dndy.items():
        n = int(n_sp[list(result.mcids).index(m)])
        got = n / (2.0 * cfg.y_cut * n_ev)
        sig = math.sqrt(max(n, 1)) / (2.0 * cfg.y_cut * n_ev)
        lines.append(f"{m} {got:.4f} against {want:.4f}")
        if abs(got - want) > 5.0 * sig + 0.02 * want:
            fail(f"[sample vah main 2d] dN/dy of {m}: sampled {got:.5f}, "
                 f"operation 1 {want:.5f} (sigma {sig:.5f})")
    print(f"[sample vah main 2d] dN/dy at y = 0, sampled against the "
          f"[vah main 2d] spectra: {'; '.join(lines)} (within 5 sigma + 2 %)")
    small = dict(operation=2, sampler_seed=3, oversample=1,
                 min_num_hadrons=3000)
    for dim, mode in ((2, 2), (3, 3)):
        phase_small_path_cpu_vs_cuda(
            f"small_sample_vah_{dim}d", dimension=dim, params=small,
            mode=mode, label=f"operation 2 mode {mode} {dim}+1D")
    run = IS3D(cfg, data_dir=run_dir, device="cuda")
    run.read_fo_surf_from_file(write_averages=False)
    rec_y = phase_yields_pair(smi, clock, "yields pair vah", run, cfg)
    rec_y["launches"] = counts["species_yields_vah"]
    surf = run.surface
    coef = testing.synthetic_vah_coefficients(
        {"tau": np.zeros(surf.tau.shape[0])}, seed=0)
    run.surface = dataclasses.replace(surf, **{
        k: torch.tensor(v, dtype=surf.tau.dtype, device="cuda")
        for k, v in coef.items()})
    chains = sample.sampler_effective_cfg(run.surface, cfg)
    if sample._kernel_df(chains) != 11:
        fail(f"[sample vah pair] the gate kept {sample._kernel_df(chains)}")
    rec = phase_sample_kernel_pair(smi, clock, "sample vah pair", run, chains,
                                   None)
    rec["launches"] = counts["sample_packed_vah"]
    return rec, rec_y


def phase_sample_search(smi: str, clock: float, run_dir: str, alias_result):
    """[sample search 2d]: the [sample main 2d] run again with
    sampler_alias = 0: K7-search's packed mode once a batch and K7b once,
    no K7a; each species' count within 5 sigma of the alias run's.  Its
    256-cell cuda-against-cpu run (f64); [sample search pair] on one batch
    of that shape.  Returns K7-search's record."""
    from is3d_tpu_torch.api import IS3D
    counts, _, cfg, info, result = phase_sample_main(
        smi, "sample search 2d", SAMPLE2D_ARGS + ["sampler_alias=0"],
        run_dir=run_dir)
    mcids = np.asarray(result.mcids)
    a = _species_counts(result.events, mcids)
    b = _species_counts(alias_result.events, mcids)
    if len(result.events) != len(alias_result.events):
        fail(f"[sample search 2d] {len(result.events)} events, the alias "
             f"run {len(alias_result.events)}")
    bad = np.abs(a - b) > 5.0 * np.sqrt(a + b + 1.0)
    if bad.any():
        fail(f"[sample search 2d] species {mcids[bad].tolist()}: counts "
             f"{a[bad].tolist()} against the alias run's {b[bad].tolist()}")
    print(f"[sample search 2d] {len(mcids)} species' counts ({int(a.sum())} "
          f"against {int(b.sum())} hadrons) within 5 sigma of the alias "
          "run's")
    phase_small_path_cpu_vs_cuda(
        "small_sample_search", dimension=2, params=dict(
            operation=2, sampler_seed=3, oversample=1, min_num_hadrons=3000),
        args=("df_mode=2", "regulate_deltaf=1", "sampler_alias=0"),
        label="operation 2 df2 sampler_alias=0")
    run = IS3D(cfg, data_dir=run_dir, device="cuda")
    run.read_fo_surf_from_file(write_averages=False)
    _, df_data, _, _, _ = run._prepare()
    rec = phase_sample_kernel_pair(smi, clock, "sample search pair", run, cfg,
                                   df_data)
    rec["launches"] = counts["sample_packed_search"]
    return rec


def phase_sample_chunked(smi: str):
    """[sample chunked]: the API (IS3D.read_fo_surf_from_memory, then
    run_particlization without writers) on an in-memory viscous-hydro
    surface of CHUNKED_CELLS cells x 320 species (2+1D, df 2, f32), one
    event, the default sampler_cell_chunk: 3 chunks of at most 2^19 cells,
    K7b twice a chunk (the pre-pass, the chunk's phase A), K7a three times
    a chunk, K7's packed mode once a batch; the same surface unchunked
    (sampler_cell_chunk = -1); the two hadron counts within 5 sigma of
    each other; peak device memory of each.  Then the 256-cell
    cuda-against-cpu run with sampler_cell_chunk = 64 (f64)."""
    from is3d_tpu_torch import testing
    from is3d_tpu_torch.api import IS3D
    from is3d_tpu_torch.config import load_config
    from is3d_tpu_torch.utils import PhaseTimer
    rd = os.path.join(WORK, "chunked_tables")
    testing.write_synthetic_run_dir(rd, 16, MAIN_SPECIES, dimension=2, seed=0)
    t0 = time.perf_counter()
    cells = testing.synthetic_surface_cells(CHUNKED_CELLS, 2, seed=0)
    t_gen = time.perf_counter() - t0
    over = dict(a.split("=", 1) for a in SAMPLE2D_ARGS[1:])
    over.update(oversample=0)
    runs = {}
    for name, chunk in (("chunked", 0), ("unchunked", -1)):
        cfg = load_config(os.path.join(rd, "iS3D_parameters.dat"),
                          overrides=dict(over, sampler_cell_chunk=chunk))
        run = IS3D(cfg, data_dir=rd, device="cuda")
        run.read_fo_surf_from_memory(**cells)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _reset_counts()
        timer = PhaseTimer(verbose=False)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            result = run.run_particlization(write_files=False, timer=timer)
        wall = time.perf_counter() - t0
        counts = _counts()
        info = result.sample_info
        _expect_counts(f"[sample chunked] {name}", counts,
                       _sample_counts(cfg, info))
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        n = sum(len(e["mcid"]) for e in result.events)
        runs[name] = n
        t = info["timings"]
        print(f"[sample chunked] {smi} | {name}: {CHUNKED_CELLS} cells x "
              f"{MAIN_SPECIES} species, {info.get('chunks', 1)} chunks, "
              f"{len(result.events)} event, {n} hadrons (total yield "
              f"{info['total_yield']:.1f}), sampler "
              f"{dict(timer.phases)['sampler']:.3f} s (phase A "
              f"{t['phase_a']:.3f}, "
              f"dispatch {t['dispatch']:.3f}, wait {t['wait']:.3f}, copy "
              f"{t['copy']:.3f}, assembly {t['assembly']:.3f}), wall "
              f"{wall:.3f} s, peak device memory {peak:.2f} GiB above the "
              "surface | launches " + ", ".join(
                  f"{k} {v}" for k, v in counts.items() if v))
        if name == "chunked" and info["chunks"] != 3:
            fail(f"[sample chunked] {info['chunks']} chunks, expected 3")
        del run, result
    a, b = runs["chunked"], runs["unchunked"]
    if abs(a - b) > 5.0 * math.sqrt(a + b):
        fail(f"[sample chunked] {a} hadrons chunked, {b} unchunked")
    print(f"[sample chunked] {a} hadrons chunked against {b} unchunked, "
          f"within 5 sigma (surface generated in {t_gen:.1f} s)")
    shutil.rmtree(rd, ignore_errors=True)
    phase_small_path_cpu_vs_cuda(
        "small_sample_chunked", dimension=2, params=dict(
            operation=2, sampler_seed=3, oversample=1, min_num_hadrons=3000),
        args=("df_mode=2", "regulate_deltaf=1", "sampler_cell_chunk=64"),
        label="operation 2 df2 sampler_cell_chunk=64")


def phase_ensemble_small():
    """[ensemble small]: ensemble.multiprocess_oversample with 2 worker
    processes (python -m is3d_tpu_torch.ensemble_worker) on this card, on
    a 256-cell run directory: the merged manifest complete, every batch's
    file, each worker's batches its own; a batch file removed, its worker
    resumed (oversample_run in this process) runs that batch alone and
    rebuilds it byte for byte."""
    from is3d_tpu_torch import ensemble, testing
    rd = os.path.join(WORK, "ensemble")
    testing.write_synthetic_run_dir(rd, 256, 11, 2, seed=1)
    out = os.path.join(rd, "oversampling")
    kw = dict(n_workers=2, events_per_batch=2, base_seed=7, device="cuda",
              timeout=600, overrides=dict(operation=2, oversample=1,
                                          min_num_hadrons=3000,
                                          precision="f32"))
    t0 = time.perf_counter()
    merged = ensemble.multiprocess_oversample(rd, out, **kw)
    wall = time.perf_counter() - t0
    nb = len(merged["batches"])
    if not merged["complete"] or nb < 2:
        fail(f"[ensemble small] {nb} batches, missing "
             f"{merged['missing_batches']}")
    files = {b: open(v["file"], "rb").read()
             for b, v in merged["batches"].items()}
    for w in range(2):
        with open(os.path.join(out, f"manifest_worker{w}.json")) as f:
            own = set(json.load(f)["batches"])
        if own != {str(b) for b in range(w, nb, 2)}:
            fail(f"[ensemble small] worker {w} batches {sorted(own)}")
    # worker 1 resumed in this process: only the removed batch runs again
    os.remove(merged["batches"]["1"]["file"])
    from is3d_tpu_torch.api import IS3D
    run = IS3D.from_run_dir(rd, overrides=kw["overrides"], device="cuda")
    table, df_data, species, mcids, _ = run._prepare()
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        ensemble.oversample_run(
            run.surface, species, np.asarray(mcids), df_data, run.cfg,
            run.plasma(), out_dir=out, events_per_batch=2, base_seed=7,
            worker_id=1, n_workers=2, particle_table=table)
    wall2 = time.perf_counter() - t0
    again = ensemble.merge_manifests(out, 2)
    counts = _counts()
    if (not again["complete"] or counts["sample_packed"] != 1
            or open(again["batches"]["1"]["file"], "rb").read()
            != files["1"]):
        fail("[ensemble small] the resumed worker did not rebuild batch 1 "
             f"alone byte for byte ({counts['sample_packed']} batches run)")
    print(f"[ensemble small] 2 workers, {nb} batches, "
          f"{merged['total_hadrons']} hadrons, {wall:.1f} s; batch 1 "
          f"removed and rebuilt byte for byte by worker 1 resumed, alone, "
          f"{wall2:.1f} s")
    shutil.rmtree(rd, ignore_errors=True)


def _spectra_file(results: str, mcid: int, n_pT: int, n_phi: int):
    """(n_pT, n_phi, 1) spectra of one species from a 2+1D results tree's
    dN_pTdpTdphidy_MCID.dat (rows y, phip, pT, value: phi-major) and its
    pT column."""
    rows = np.loadtxt(os.path.join(results, f"dN_pTdpTdphidy_{mcid}.dat"),
                      skiprows=1)
    if rows.shape != (n_pT * n_phi, 4):
        fail(f"[analysis] dN_pTdpTdphidy_{mcid}.dat has shape {rows.shape}")
    vals = rows[:, 3].reshape(n_phi, n_pT).T[:, :, None]
    return vals, rows[:n_pT, 2]


def _within(got: float, want: float, n: float, per: float, tag: str):
    """Fail unless a sampled yield ``got`` (``n`` hadrons, ``per`` hadrons
    a unit of it) lies within 5 sigma + 2 % of ``want``."""
    sig = math.sqrt(max(n, 1.0)) / per
    if not (math.isfinite(got) and abs(got - want) <= 5.0 * sig
            + 0.02 * want):
        fail(f"[analysis] {tag}: sampled {got:.5f}, smooth {want:.5f} "
             f"(sigma {sig:.5f})")


def phase_analysis(smi: str, result, cfg):
    """[analysis]: the port's analysis module on [sample main 2d]'s events
    (held in memory: no new sampling) and [main 2d]'s spectra of the same
    surface (its results tree, kept for [mesh]).
    compare_sampling_smooth for the pion, kaon and proton (the spectra as
    a cuda tensor): the smooth dN/dy equal to [main 2d]'s dN_dy file
    (rtol 1e-6), the sampled one within 5 sigma + 2 % of it;
    compute_observables with the run's particle table: the identified
    dN/dy (|y| < 0.5, both charges) within 5 sigma + 2 % of the smooth
    sum, every number finite.  Then IS3D_SAMPLER_TIMINGS=1 on a 256-cell
    cuda run: one [sample_particles timings] line, info["timings"]'s."""
    from is3d_tpu_torch import analysis
    from is3d_tpu_torch.api import IS3D
    from is3d_tpu_torch.histograms import sampler_test_histograms
    from is3d_tpu_torch.io.pdg import read_resonances
    from is3d_tpu_torch.io.tables import native_momentum_grid
    from is3d_tpu_torch.testing import write_synthetic_run_dir
    t0 = time.perf_counter()
    events, mcids = result.events, np.asarray(result.mcids)
    n_ev = len(events)
    main2d = MESH_DIRS["main 2d"][0]
    results = os.path.join(main2d, "results_mesh_one")
    grid = native_momentum_grid(2)
    n_pT, n_phi = grid.pT.shape[0], grid.phi.shape[0]
    ids = [int(m) for m in mcids
           if abs(int(m)) in dict(ANALYSIS_SPECIES).values()]
    spectra = []
    for m in ids:
        vals, pT = _spectra_file(results, m, n_pT, n_phi)
        if not np.allclose(pT, grid.pT.numpy(), rtol=1e-7, atol=0):
            fail(f"[analysis] the pT column of {m}'s file is not the grid's")
        spectra.append(vals)
    spectra = torch.tensor(np.stack(spectra), device="cuda")
    hist = sampler_test_histograms(events, ids, cfg)
    dndy_file = _dndy_files(results, ids)
    per = 2.0 * cfg.y_cut * n_ev
    lines = []
    for _, m in ANALYSIS_SPECIES:
        c = analysis.compare_sampling_smooth(hist, spectra, grid, ids, m, cfg)
        if not all(np.isfinite(np.asarray(v, float)).all()
                   for v in c.values()) or not (
                       c["dN_2pipTdpTdy_smooth"] > 0).all():
            fail(f"[analysis] compare_sampling_smooth of {m}: not finite "
                 "and positive")
        if not math.isclose(c["dN_dy_smooth"], dndy_file[m], rel_tol=1e-6):
            fail(f"[analysis] smooth dN/dy of {m} {c['dN_dy_smooth']} "
                 f"against [main 2d]'s file {dndy_file[m]}")
        _within(c["dN_dy_sampled"], c["dN_dy_smooth"],
                c["dN_dy_sampled"] * per, per, f"dN/dy of {m}")
        lines.append(f"{m} {c['dN_dy_sampled']:.4f} against "
                     f"{c['dN_dy_smooth']:.4f}")
    table = read_resonances(os.path.join(main2d, "PDG"), cfg.hrg_eos)
    obs = analysis.compute_observables(events, particle_table=table)
    if obs["nsamples"] != n_ev or not all(math.isfinite(v) for v in (
            obs["dNch_deta"], obs["dET_deta"], obs["pT_fluct"]["sum_pT"],
            *obs["mean_pT"].values())) or not np.isfinite(
                obs["flow"]["Qn"]).all() or obs["dNch_deta"] <= 0:
        fail(f"[analysis] compute_observables: {obs}")
    ident = []
    for name, pid in ANALYSIS_SPECIES:
        want = sum(v for m, v in dndy_file.items() if abs(m) == pid)
        got = obs["dN_dy"][name]
        _within(got, want, got * n_ev, n_ev, f"compute_observables {name}")
        ident.append(f"{name} {got:.3f} against {want:.3f}")
    took = time.perf_counter() - t0
    v2 = abs(obs["flow"]["Qn"][1]) / max(obs["flow"]["N"], 1)
    print(f"[analysis] {smi} | {n_ev} events, "
          f"{sum(len(e['mcid']) for e in events)} hadrons of [sample main "
          f"2d] against [main 2d]'s spectra | compare_sampling_smooth dN/dy "
          f"at y = 0: {'; '.join(lines)} | compute_observables dN/dy (|y| < "
          f"0.5, both charges): {'; '.join(ident)} (within 5 sigma + 2 %); "
          f"dNch/deta {obs['dNch_deta']:.2f}, dET/deta "
          f"{obs['dET_deta']:.2f} GeV, mean pT pion "
          f"{obs['mean_pT']['pion']:.4f} GeV, |Q2|/N {v2:.5f} | {took:.2f} s")
    small = os.path.join(WORK, "analysis_timings")
    write_synthetic_run_dir(small, 256, 24, dimension=2, seed=3, params=dict(
        operation=2, oversample=1, min_num_hadrons=3000, sampler_seed=3))
    buf = io.StringIO()
    os.environ["IS3D_SAMPLER_TIMINGS"] = "1"
    try:
        with contextlib.redirect_stdout(buf):
            res = IS3D.from_run_dir(small, device="cuda").run_particlization()
    finally:
        del os.environ["IS3D_SAMPLER_TIMINGS"]
    shutil.rmtree(small, ignore_errors=True)
    t = res.sample_info["timings"]
    want = "[sample_particles timings] " + "  ".join(
        f"{k}={v:.3f}s" for k, v in t.items())
    got = [l for l in buf.getvalue().splitlines()
           if l.startswith("[sample_particles")]
    if got != [want]:
        fail(f"[analysis] IS3D_SAMPLER_TIMINGS=1 printed {got}, expected "
             f"[{want!r}]")
    print(f"[analysis] IS3D_SAMPLER_TIMINGS=1 on a 256-cell cuda run: "
          f"{got[0]}")


def phase_sample(smi: str, clock: float, vah_dir: str, vah_dndy: dict):
    """The operation-2 paths: [sample main 2d] and its 256-cell
    cuda-against-cpu runs (f64; the same Philox streams, so the same
    lists), [yields pair] (K7b on its surface), [sample pair], [sample
    search 2d] and [sample search pair] on the same run directory;
    [sample vah main 2d] on [vah main 2d]'s (``vah_dir``), [sample vah
    pair] and K7b's VAH pair; [sample chunked]; [ensemble small]; [sample
    decays] (the decaying list, do_resonance_decays = 1) with its small runs
    and [cascade pair].  Returns the kernel records of K7, K7a, K8, K7b
    (VH, VAH), K7-VAH and K7-search."""
    from is3d_tpu_torch.api import IS3D
    counts, run_dir, cfg, info, result = phase_sample_main(
        smi, "sample main 2d", SAMPLE2D_ARGS)
    _clock("analysis")
    phase_analysis(smi, result, cfg)
    _clock("sample pairs")
    small = dict(operation=2, sampler_seed=3, oversample=1,
                 min_num_hadrons=3000)
    _reset_counts()
    phase_small_path_cpu_vs_cuda("small_sample", dimension=2, params=small,
                                 label="operation 2 df2")
    small_counts = _counts()
    if small_counts["sample_packed"] < 1 or small_counts["sample_events"]:
        fail(f"[small_sample path] K7 launches {small_counts}: expected the "
             "packed mode only")
    print(f"[small_sample path] the cuda run went through K7's packed mode "
          f"({small_counts['sample_packed']} launches)")
    run = IS3D(cfg, data_dir=run_dir, device="cuda")
    run.read_fo_surf_from_file(write_averages=False)
    rec_y = phase_yields_pair(smi, clock, "yields pair", run, cfg)
    rec_y["launches"] = counts["species_yields"]
    del run
    rec_k7, rec_k7a = phase_sample_pair(smi, clock, run_dir, cfg, info)
    rec_k7["launches"] = counts["sample_packed"]
    rec_k7a["launches"] = counts["alias_tables"]
    rec_search = phase_sample_search(smi, clock, run_dir, result)
    del result
    # [mesh sample] samples this surface again
    shutil.rmtree(os.path.join(run_dir, "results"), ignore_errors=True)
    MESH_SAMPLE.update(run_dir=run_dir, overrides=dict(
        _overrides(SAMPLE2D_ARGS),
        min_num_hadrons=str(MESH_SAMPLE_HADRONS)))
    rec_vah, rec_y_vah = phase_sample_vah(smi, clock, vah_dir, vah_dndy)
    _release(vah_dir)
    phase_sample_chunked(smi)
    phase_ensemble_small()
    counts, run_dir, cfg, _, _ = phase_sample_main(
        smi, "sample decays", SAMPLE_DECAYS_ARGS, decays=True)
    phase_small_path_cpu_vs_cuda("small_sample_decays", dimension=2,
                                 params=small, n_species=24, decays=True,
                                 label="operation 2 df2 with decays")
    rec_k8 = phase_cascade_pair(smi, clock, run_dir, cfg)
    rec_k8["launches"] = counts["mc_cascade"]
    # [pod] runs it again over two CLI ranks
    os.rename(os.path.join(run_dir, "results"),
              os.path.join(run_dir, "results_pod_one"))
    POD_DIRS["sample decays"] = (run_dir, SAMPLE_DECAYS_ARGS,
                                 "results_pod_one")
    return rec_k7, rec_k7a, rec_k8, rec_y, rec_y_vah, rec_vah, rec_search


# ---------------------------------------------------- gradients (K9)

# the spectra the observable of [grad main] reads: the pions' v2 and <pT>
# besides every species' dN/dy (a calibration observable)
GRAD_WRT = ("T", "ux", "uy", "un", "bulkPi", "pixx", "pixy", "pixn", "piyy",
            "piyn", "dat", "dax", "day", "dan")
# the cells of a main-path group the backward kernels are held to their
# plain versions on in [grad pair], and of the f64 slice of [grad main]'s
# central differences
GRAD_PLAIN_CELLS = 32
GRAD_FD_CELLS = 256
ENSEMBLE_EVENTS, ENSEMBLE_CELLS = 8, 16384
# the fields [grad polzn main 2d] / [grad polzn main 3d] differentiate by
# (and eta in 3+1D)
GRAD_POLZN_WRT = ("wtx", "wty", "wtn", "wxy", "wxn", "wyn", "ux", "uy", "un",
                  "dat", "dax", "day", "dan")


def _grad_check(name, got, want, dtype, plain=None, loose=()) -> float:
    """Fail unless a gradient agrees with its plain version, each field
    (testing.grad_field_errors) to TOL[dtype] of the field's largest value,
    the fields in ``loose`` to the float32 bar.  Given the plain version's
    own gradient in ``dtype`` (``plain``; the main-shape pairs, as [pair]
    holds the forward kernels), a field outside the bar passes if its
    error is at most 3x the plain gradient's in that same field.  Returns
    the largest error."""
    from is3d_tpu_torch import testing
    bad, worst = testing.grad_field_errors(got, want, *TOL[dtype])
    if loose:
        idx = torch.tensor(sorted(loose))
        bad[idx] = testing.grad_field_errors(got, want,
                                             *TOL[torch.float32])[0][idx]
    gl = got if isinstance(got, tuple) else (got,)
    wl = want if isinstance(want, tuple) else (want,)
    err = max((g.double().cpu() - w.double().cpu()).abs().max().item()
              for g, w in zip(gl, wl))
    line = (f"largest error {float(worst.max()):.2e} of its field's largest "
            "value")
    if loose:
        line += f" (fields {sorted(loose)} at the float32 bar)"
    if plain is not None:
        worst_p = testing.grad_field_errors(plain, want, *TOL[dtype])[1]
        line += f" (the plain version in {dtype}: {float(worst_p.max()):.2e})"
        waive = (bad > 0) & (worst <= 3.0 * worst_p)
        if waive.any():
            js = waive.nonzero().flatten().tolist()
            line += (f"; {len(js)} field(s) outside the bar within 3x the "
                     "plain version's own error there: " + ", ".join(
                         f"{j} ({worst[j]:.2e} against {worst_p[j]:.2e})"
                         for j in js[:4]) + (", ..." if len(js) > 4 else ""))
        bad = bad.masked_fill(waive, 0)
    js = bad.nonzero().flatten().tolist()
    bad = int(bad.sum())
    print(f"[kernel vs plain] {name}: {line} {'ok' if not bad else 'FAIL'}")
    if bad:
        fail(f"{name}: {bad} gradient entries outside rtol={TOL[dtype][0]}, "
             f"atol={TOL[dtype][1]}*max of their field (fields " + ", ".join(
                 f"{j}: {worst[j]:.2e}" for j in js[:6]) + ")")
    return err


def phase_small_grad():
    """[grad small]: K9a and K9b (csrc/smooth_spectra_bwd.cu) on every
    testing.SPECTRA_EDGES case (3+1D, 2+1D fixed and remap, df 1 and 2,
    regulate and outflow on and off, an overflowed exponential, a saturated
    regulator, pad rows, one species) and K9c (csrc/decays_bwd.cu) on
    every testing.DECAY_EDGES and DECAY_ROUTE_EDGES case, against their
    plain versions' autograd in f64 from the same inputs, f32 and f64; two
    launches bit-identical; K9c's route (float32 slot words in shared
    memory where they fit, else the device's) as its shape gives it."""
    from is3d_tpu_torch import testing
    from is3d_tpu_torch.kernels import decays, smooth
    for case in sorted(testing.SPECTRA_EDGES):
        for dtype in (torch.float32, torch.float64):
            cells, mom, flags, G = testing.spectra_grad_inputs(
                case, dtype=dtype, device="cuda")
            want = smooth.spectra_bwd_plain(cells.double(), G.double(),
                                            mom.to(None, torch.float64),
                                            flags)
            got = smooth.spectra_bwd_cuda(cells, G, mom, flags)
            again = smooth.spectra_bwd_cuda(cells, G, mom, flags)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"spectra_bwd {case}: two launches differ")
            _grad_check(f"[grad small] spectra_bwd {case} {dtype}", got,
                        want, dtype)
    # the finer-y route case in float32 alone: the forward stages no
    # float64 table of its grid
    for case, dtype in [(c, d) for c in sorted(testing.DECAY_EDGES)
                        for d in (torch.float32, torch.float64)] + [
            (c, torch.float32) for c in sorted(testing.DECAY_ROUTE_EDGES)]:
        tables, tasks, wg, G = testing.decay_grad_inputs(
            case, dtype=dtype, device="cuda")
        route = decays.wave_bwd_blocking(tables, tasks, wg)["route"]
        if route != ("shared" if dtype == torch.float32
                     and case in testing.DECAY_EDGES else "device"):
            fail(f"decay_wave_bwd {case} {dtype}: route {route}")
        want = decays.wave_bwd_plain(tables.to(None, torch.float64),
                                     tasks.to(None, torch.float64),
                                     wg.to(None, torch.float64), G)
        got = decays.wave_bwd_cuda(tables, tasks, wg, G)
        again = decays.wave_bwd_cuda(tables, tasks, wg, G)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"decay_wave_bwd {case}: two launches differ")
        _grad_check(f"[grad small] decay_wave_bwd {case} {dtype}", got,
                    want, dtype)


def _grad_group(run_dir: str, cfg):
    """(run, species, grid, df_data, packed cells of the first canonical
    group, mom, flags, node table) of a main-path run directory."""
    from is3d_tpu_torch.api import IS3D
    from is3d_tpu_torch.kernels import smooth
    from is3d_tpu_torch.kernels.common import surface_columns, prepare_cells
    from is3d_tpu_torch.parallel.mesh import canonical_groups
    run = IS3D(cfg, data_dir=run_dir, device="cuda")
    particle_table, df_data, species, mcids, grid = run._prepare()
    cols = surface_columns(run.surface, cfg)
    _, gs = canonical_groups(cfg, run.surface.n_cells)
    cells = smooth.pack_cells(prepare_cells({k: v[:gs] for k, v in
                                             cols.items()}, cfg, df_data),
                              cfg)
    mom = smooth.momentum_constants(species, grid, cfg.dimension)
    flags = smooth.spectra_flags(cfg, grid)
    table = smooth.remap_node_table(mom) if flags.remap else None
    return (run, particle_table, species, mcids, grid, df_data, cells, mom,
            flags, table)


def phase_grad_pair(smi: str, clock: float, run_dir: str, cfg,
                    tag: str) -> dict:
    """[grad pair]: the backward kernel on one canonical group of a main
    path (full species and grid, f32, a positive cotangent): two launches
    bit-identical, the time (one warm-up, median of 3), bound, share,
    issued per evaluation, the kernel's plan and resources (bwd_props); on
    the group's first GRAD_PLAIN_CELLS cells
    against the plain version's autograd in f64 (and the plain version's
    time in f32 there)."""
    from is3d_tpu_torch import testing
    from is3d_tpu_torch.kernels import smooth
    from is3d_tpu_torch.utils import cuda_median_ms
    (_, _, _, _, grid, _, cells, mom, flags, table) = _grad_group(run_dir,
                                                                  cfg)
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    R = mom.nodes.shape[0]
    G = testing.grad_cotangent((S, P, F, R if cfg.dimension == 3 else 1),
                               dtype=torch.float32, device="cuda")
    kern = lambda: smooth.spectra_bwd_cuda(cells, G, mom, flags, table)
    got, again = kern(), kern()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail(f"spectra_bwd ({tag}): two launches on the same group differ")
    k_ms, k_all = cuda_median_ms(kern, 3)
    n = GRAD_PLAIN_CELLS
    cs = cells[:n].contiguous()
    want = smooth.spectra_bwd_plain(cs.double(), G.double(),
                                    mom.to(None, torch.float64), flags)
    plain, p_ms = _timed_once(lambda: smooth.spectra_bwd_plain(cs, G, mom,
                                                               flags))
    err = _grad_check(f"[{tag}] float32 group's first {n} cells",
                      smooth.spectra_bwd_cuda(cs, G, mom, flags, table),
                      want, torch.float32, plain)
    evals = cells.shape[0] * S * P * F * R
    fp32, sfu = smooth.backward_formula_ops(cfg.df_mode, flags.remap, F)
    bound = _bound(evals, fp32, sfu, _nbytes(cells, G, got,
                                             *mom_tensors(mom)), clock)
    kernel = (f"remap_bwd_kernelIfLi{cfg.df_mode}E" if flags.remap else
              f"spectra_bwd_kernelIfLi{cfg.dimension}ELi{cfg.df_mode}E")
    plan = _bwd_plan(smooth.bwd_props("cuda", False, mom, flags,
                                      cells.shape[0]), cells.shape[0])
    print(f"[{tag}] {smi} | one group {cells.shape[0]} cells x {S} x "
          f"{P * F} x {R} nodes: backward kernel {k_ms:.3f} ms (runs "
          f"{', '.join(f'{t:.2f}' for t in k_all)}), "
          f"{evals / k_ms * 1e3:.3e} evaluations/s; plain (autograd, f32) "
          f"{p_ms:.3f} ms on {n} cells; bound {bound[0]:.3f} ms "
          f"({bound[1]}: {fp32:.4g} FP32 + {sfu} SFU an evaluation), kernel "
          f"at {bound[0] / k_ms:.1%} of it; two launches bit-identical; "
          "issued per evaluation: " + _issued("smooth_spectra_bwd", kernel)
          + f"; {plan}")
    return dict(launches=None, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                bound_ms=bound[0], bound_by=bound[1], library_ms=None,
                cells=cells.shape[0], plain_cells=n)


def _bwd_plan(props: dict, n_cells: int) -> dict:
    """A backward kernel's launch shape and resources (its bwd_props),
    with its last wave where the plan reports its waves (K9a's): the
    blocks in it, the SMs they occupy and the share of the
    card's resident blocks they fill."""
    if "waves" in props:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        slots = props["blocks_per_sm"] * sms
        last = -(-n_cells // props["cells_per_block"]) - (
            props["waves"] - 1) * slots
        props = dict(props, last_wave_blocks=last,
                     last_wave_sms=min(last, sms),
                     last_wave_fill=round(last / slots, 4))
    return props


def _grad_observable(grid, mcids):
    """sum dN/dy plus the pions' v2 and <pT> (diff's torch observables)."""
    from is3d_tpu_torch import diff
    pi = int(np.nonzero(np.asarray(mcids) == 211)[0][0])

    def obs(spectra):
        return (diff.dN_dy_j(spectra, grid).sum()
                + diff.vn_j(spectra[pi:pi + 1], grid, 2).sum()
                + diff.mean_pT_j(spectra[pi:pi + 1], grid).sum())
    return obs


def _surface_slice(surface, n: int, dtype):
    """The first n cells of a surface, every carried column in dtype."""
    import dataclasses
    return surface.replace(**{
        f.name: getattr(surface, f.name)[:n].to(dtype)
        for f in dataclasses.fields(surface)
        if isinstance(getattr(surface, f.name), torch.Tensor)})


def _grad_path(smi: str, tag: str, surface, make_fn, prod, mcids, grid,
               cfg, wrt, want: dict, picks, observable=None) -> dict:
    """diff.surface_vjp of a differentiable map at full width (the main
    path's surface, f32) with respect to ``wrt``, then the pullback of the
    observable's cotangent: ``make_fn(dtype)`` the map on that precision's
    species, grid and tables, ``prod()`` the production result (a tensor,
    or a dict of tensors as polarization_fn's), ``observable(grid)`` the
    scalar of it (default _grad_observable's spectra observable), ``want``
    the kernels and their launches (every count set to 0 before the run);
    the forward equals the production result bit for bit, every gradient
    is finite and nonzero; forward and backward seconds; on the first
    GRAD_FD_CELLS cells in f64 the entries ``picks`` against central
    differences (rtol 5e-5)."""
    from is3d_tpu_torch import diff
    if observable is None:
        observable = lambda g: _grad_observable(g, mcids)
    fn = make_fn(torch.float32)
    obs = observable(grid)
    _reset_counts()
    t0 = time.perf_counter()
    value, pull = diff.surface_vjp(fn, surface, wrt)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    # the observable's cotangent on each leaf of the value (0 where unused)
    leaves = value if isinstance(value, dict) else {None: value}
    xs = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
    with torch.enable_grad():
        y = obs(xs if isinstance(value, dict) else xs[None])
        cts = torch.autograd.grad(y, list(xs.values()), allow_unused=True)
    ct = {k: torch.zeros_like(v) if c is None else c
          for (k, v), c in zip(xs.items(), cts)}
    t0 = time.perf_counter()
    grads = pull(ct if isinstance(value, dict) else ct[None])
    torch.cuda.synchronize()
    t_bwd = time.perf_counter() - t0
    counts = _counts()
    _expect_counts(f"{tag} path", counts, want)
    ref = prod()
    refs = ref if isinstance(ref, dict) else {None: ref}
    if sorted(refs, key=str) != sorted(leaves, key=str) or not all(
            torch.equal(leaves[k], refs[k]) for k in refs):
        fail(f"{tag}: the differentiable forward differs from the "
             "production result")
    for k, g in grads.items():
        if not (torch.isfinite(g).all() and g.abs().max() > 0):
            fail(f"{tag}: the gradient by {k} is not finite and nonzero "
                 f"({int((~torch.isfinite(g)).sum())} entries not finite, "
                 "first cells "
                 f"{torch.nonzero(~torch.isfinite(g))[:4, 0].tolist()}; "
                 f"{int((g == 0).sum())} zero)")
    nodes = grid.n_eta if cfg.dimension == 2 else grid.n_y
    n_species = next(iter(leaves.values())).shape[0]
    evals = surface.n_cells * n_species * grid.n_pT * grid.n_phi * nodes
    groups = max(want.values())
    print(f"[{tag}] {smi} | {surface.n_cells} cells x {n_species} "
          f"species, {len(wrt)} fields: forward {t_fwd:.3f} s (bit-equal "
          f"to the production result), backward {t_bwd:.3f} s, "
          f"{evals / t_bwd:.3e} backward evaluations/s, "
          f"{t_bwd / groups * 1e3:.1f} ms a group over {groups} groups | "
          "launches " + ", ".join(f"{k} {v}" for k, v in want.items()))

    # central differences in f64 on a slice
    n = GRAD_FD_CELLS
    s64 = _surface_slice(surface, n, torch.float64)
    fn64 = make_fn(torch.float64)
    obs64 = observable(grid.to(None, torch.float64))
    _, g64 = diff.surface_value_and_grad(lambda s: obs64(fn64(s)), s64,
                                         [k for k, _ in picks])
    worst = 0.0
    for k, i in picks:
        x = getattr(s64, k)
        eps = 1e-6 * max(1.0, abs(float(x[i])))
        hot = torch.zeros_like(x)
        hot[i] = eps
        with torch.no_grad():
            fd = (float(obs64(fn64(s64.replace(**{k: x + hot}))))
                  - float(obs64(fn64(s64.replace(**{k: x - hot}))))) / (
                      2 * eps)
        got = float(g64[k][i])
        rel = abs(got - fd) / max(abs(fd), 1e-300)
        worst = max(worst, rel)
        if abs(got - fd) > 5e-5 * abs(fd) + 1e-9 * float(g64[k].abs().max()):
            fail(f"{tag}: d/d{k}[{i}] {got:.9e} against central "
                 f"differences {fd:.9e}")
    print(f"[{tag}] f64 on the first {n} cells: {len(picks)} gradient "
          f"entries against central differences, largest relative "
          f"difference {worst:.2e} (rtol 5e-5)")
    return dict(counts=counts, forward_s=t_fwd, backward_s=t_bwd)


def phase_grad_main(smi: str, run_dir: str, cfg, tag: str) -> dict:
    """[grad main] / [grad main 2d]: _grad_path of the production linear-df
    spectra (smooth_spectra) with respect to T, u, bulkPi, the five pi
    components, dsigma (and eta in 3+1D): K1 and K9a (K9b with the remap)
    each launched once a group."""
    from is3d_tpu_torch import diff
    from is3d_tpu_torch.kernels.smooth import smooth_spectra
    from is3d_tpu_torch.parallel.mesh import canonical_groups
    (run, _, species, mcids, grid, df_data, _, _, flags, _) = _grad_group(
        run_dir, cfg)
    surface = run.surface
    groups, _ = canonical_groups(cfg, surface.n_cells)
    want = dict(smooth_spectra=groups, spectra_bwd=groups)
    if flags.remap:
        want.update(smooth_spectra_remap=groups, spectra_bwd_remap=groups)
    return _grad_path(
        smi, tag, surface,
        lambda dt: diff.spectra_fn(species.to(None, dt), grid.to(None, dt),
                                   df_data.to(None, dt), cfg),
        lambda: smooth_spectra(surface, species, grid, df_data, cfg),
        mcids, grid, cfg, GRAD_WRT + (("eta",) if cfg.dimension == 3 else ()),
        want, [("T", 5), ("ux", 17), ("pixy", 33), ("bulkPi", 41)] + (
            [("eta", 9)] if cfg.dimension == 3 else [("dat", 9)]))


def phase_grad_decays(smi: str, clock: float, run_dir: str, cfg) -> dict:
    """[grad decays]: decayed_spectra_fn on the [decays main] surface
    (the decaying list, 3+1D, f32): its forward equals do_resonance_decays
    of smooth_spectra bit for bit; the pullback of a positive cotangent
    (forward and backward seconds, launches); then K9c launch by launch on
    the path's own waves (each timed beside its bound), and on each launch's
    first tasks against the plain version's autograd in f32 and f64, two
    launches bit-identical.  Returns the kernel records by body."""
    from is3d_tpu_torch import diff, testing
    from is3d_tpu_torch.kernels import decays
    from is3d_tpu_torch.kernels.smooth import smooth_spectra
    from is3d_tpu_torch.parallel.mesh import canonical_groups
    (run, table, species, mcids, grid, df_data, _, _, _, _) = _grad_group(
        run_dir, cfg)
    surface = run.surface
    groups, _ = canonical_groups(cfg, surface.n_cells)
    fn = diff.decayed_spectra_fn(species, grid, df_data, cfg, table, mcids)
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out, pull = diff.surface_vjp(fn, surface, ("T", "ux", "bulkPi"))
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    ct = testing.grad_cotangent(out.shape, device="cuda")
    t0 = time.perf_counter()
    grads = pull(ct)
    torch.cuda.synchronize()
    t_bwd = time.perf_counter() - t0
    counts = _counts()
    sched = _main_decays_schedule()
    _expect_counts("grad decays path", counts, dict(
        smooth_spectra=groups, spectra_bwd=groups,
        decay_wave_2body=sched["waves_2body"],
        decay_wave_3body=sched["waves_3body"],
        decay_wave_bwd_2body=sched["waves_2body"],
        decay_wave_bwd_3body=sched["waves_3body"]))
    with contextlib.redirect_stdout(io.StringIO()):
        prod = decays.do_resonance_decays(smooth_spectra(
            surface, species, grid, df_data, cfg), table, mcids, grid, cfg)
    if not torch.equal(out, prod):
        fail("grad decays: the traced forward differs from "
             "do_resonance_decays")
    for k, g in grads.items():
        if not (torch.isfinite(g).all() and g.abs().max() > 0):
            fail(f"grad decays: the gradient by {k} is not finite and "
                 "nonzero")
    print(f"[grad decays] {smi} | {surface.n_cells} cells x {out.shape[0]} "
          f"species, {cfg.dimension}+1D: forward {t_fwd:.3f} s (bit-equal "
          f"to do_resonance_decays), backward {t_bwd:.3f} s | launches "
          + ", ".join(f"{k} {counts[k]}" for k in (
              "decay_wave_2body", "decay_wave_3body", "decay_wave_bwd_2body",
              "decay_wave_bwd_3body", "spectra_bwd")))

    # K9c on the path's waves: each launch timed, then held to the plain
    # version on its first task
    spectra = smooth_spectra(surface, species, grid, df_data, cfg)
    pT64 = grid.pT.to("cpu", torch.float64).numpy()
    waves = decays.plan_waves(decays._decay_schedule(
        table, mcids, pT64, cfg.lightest_particle))
    staged = decays.stage_waves(waves, pT64, torch.float32, "cuda")
    wg = decays.wave_grid(grid, cfg.dimension, torch.float32, "cuda")
    wg64 = decays.wave_grid(grid.to(None, torch.float64), cfg.dimension,
                            torch.float64, "cuda")
    acc = spectra.double()
    rec = {2: dict(ms=0.0, path_ms=0.0, err=0.0), 3: dict(ms=0.0,
                                                          path_ms=0.0,
                                                          err=0.0)}
    G = testing.grad_cotangent(acc.shape, device="cuda")
    # the launch's first task against the plain version (its autograd
    # keeps every s node's block: one 3-body task is ~7 GB in f64 on the
    # main grid); the f64 kernel on the same (upcast) inputs
    sub = lambda t: decays.WaveTasks(
        nbody=t.nbody, slot=t.slot[:1], seg=t.seg[:1], par=t.par[:1],
        order=t.order, target=t.target, tstart=t.tstart)
    for i, st in enumerate(staged):
        tables = decays.parent_tables(acc, st.rows, st.masses, st.mtg,
                                      torch.float32)
        tables64 = tables.to(None, torch.float64)
        for tasks in st.launches:
            kern = lambda: decays.wave_bwd_cuda(tables, tasks, wg, G)
            got = kern()
            again, ms = _timed_once(kern)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"decay_wave_bwd wave {i} {tasks.nbody}-body: two "
                     "launches differ")
            blk = decays.wave_bwd_blocking(tables, tasks, wg)
            route = blk["route"]
            _, P_, F_, Y_ = tables.logdN.shape
            blocks = (tasks.slot.shape[0] * -(-P_ // blk["pt_block"])
                      * blk["chunks"])
            words = (P_ + 2) * (F_ + 2) * Y_           # a slot's entries
            b_bits, e_bits = decays.wave_bwd_bits(tables, tasks, wg, G)
            live = e_bits > -2 ** 31
            lost = (b_bits - e_bits)[live]
            if (lost < 0).any():
                fail(f"decay_wave_bwd wave {i} {tasks.nbody}-body: a term "
                     "lies above its slot's scale bound")
            fp32, sfu = decays.wave_backward_operations(tasks, wg)
            fed = tasks.target.shape[0] * acc[0].numel() * 8
            nbytes = 2 * _nbytes(tables.logdN, tables.tc, tables.ts) + \
                _nbytes(tables.mtg, tasks.slot, tasks.par) + fed
            bound = _bound(1.0, fp32, sfu, nbytes, clock)
            r = rec[tasks.nbody]
            r["path_ms"] += ms
            if ms > r["ms"]:
                r.update(ms=ms, bound=bound, launch=f"wave {i}")
            tasks64 = sub(tasks.to(None, torch.float64))
            want, p_ms = _timed_once(lambda: decays.wave_bwd_plain(
                tables64, tasks64, wg64, G))
            err = _grad_check(
                f"[grad decays] wave {i} {tasks.nbody}-body, its first task, "
                "float32", decays.wave_bwd_cuda(tables, sub(tasks), wg, G),
                want, torch.float32,
                decays.wave_bwd_plain(tables, sub(tasks), wg, G))
            _grad_check(f"[grad decays] wave {i} {tasks.nbody}-body, its "
                        "first task, float64",
                        decays.wave_bwd_cuda(tables64, tasks64, wg64, G),
                        want, torch.float64)
            r["err"] = max(r["err"], err)
            r["plain_ms"] = p_ms
            del want
            print(f"[grad decays] {smi} | wave {i} {tasks.nbody}-body "
                  f"backward: {tasks.slot.shape[0]} tasks, kernel "
                  f"{ms:.3f} ms, bound {bound[0]:.3f} ms ({bound[1]}), "
                  f"{bound[0] / ms:.1%} of it; plain (f64 autograd) "
                  f"{p_ms:.1f} ms on its first task; two launches "
                  f"bit-identical; route {route} ({blocks} blocks; "
                  + (f"at most {blocks * words} device atomics to flush "
                     "them, plus the carries" if route == "shared"
                     else "device atomics a term")
                  + f"), the scale's bound gives up {int(lost.min())}-"
                  f"{int(lost.max())} bits (log and tail rows of each "
                  "slot); issued per evaluation: "
                  + _issued("decays_bwd", f"wave_bwd_kernelIfLi"
                            f"{cfg.dimension}ELi{tasks.nbody}ELb"
                            f"{int(route == 'shared')}E"))
        for tasks in st.launches:
            decays.decay_wave_cuda(tables, tasks, wg, acc)
    records = {}
    for nbody, r in rec.items():
        records[nbody] = dict(
            launches=counts[f"decay_wave_bwd_{nbody}body"],
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound"][0], bound_by=r["bound"][1], library_ms=None,
            launch=f"{r['launch']}, the longest", path_ms=r["path_ms"],
            plain_tasks=1)
        print(f"[grad decays] {smi} | decay_wave_bwd {nbody}-body over the "
              f"path's launches {r['path_ms']:.3f} ms")
    return records


# ------------------------------------------- gradients of df 3-4 and VAH

# the fields the VAH runs differentiate: the anisotropic variables, flow
# and dsigma; with every chain on also the shear, bulk, W and two
# coefficient columns (the gate keeps a chain whose column wants a
# gradient)
GRAD_VAH_WRT = ("Lambda", "aL", "ux", "uy", "un", "dat", "dax", "day", "dan")
GRAD_VAH_CHAIN_WRT = GRAD_VAH_WRT + ("pixx", "pixy", "bulkPi", "Wx", "c0",
                                     "c3")
# the cells of a main-path group the backward kernels K10 and K11 are held
# to their plain versions on in the [grad ... pair] phases (the plain
# version's autograd in f32 took 10.1 s on 512 cells of a 3+1D df 3 group)
GRAD_PAIR_PLAIN_CELLS = 128


def _grad_check_fields(name, got, want, dtype, plain=None) -> float:
    """_grad_check of each gradient of a kernel (the packed cells' and, for
    K10, rn's), each field (column) to its own largest value, the f64
    reference rounded to the kernel's precision first (a field of float32
    gradients whose largest value lies below float32's range, 8e-57 on
    testing.FEQMOD_EDGES["3d_df4_narrow"], is 0 there)."""
    tup = lambda t: t if isinstance(t, tuple) else (t,)
    want = tuple(w.to(dtype) for w in tup(want))
    plains = tup(plain) if plain is not None else (None,) * len(tup(got))
    return max(_grad_check(f"{name}{part}", g, w, dtype, p)
               for part, g, w, p in zip(("", " (rn)"), tup(got), tup(want),
                                        plains))


def phase_small_grad_feqmod():
    """[grad small feqmod]: K10a and K10b (csrc/feqmod_bwd.cu) on every
    testing.FEQMOD_EDGES case (df 3 and 4; 3+1D, 2+1D fixed and remap;
    clean, mixed and mostly broken-down cells; the 3+1D narrow mask; exp
    overflow; the df 4 clamp and a saturated regulator; betaV = 0 tables;
    pad rows) against the plain version's autograd in f64 from the same
    inputs (a positive cotangent), f32 and f64; two launches
    bit-identical."""
    from is3d_tpu_torch import testing
    from is3d_tpu_torch.kernels import feqmod
    for case in sorted(testing.FEQMOD_EDGES):
        for dtype in (torch.float32, torch.float64):
            x, rn, wcs, mom, flags, G = testing.feqmod_grad_inputs(
                case, dtype=dtype, device="cuda")
            want = feqmod.feqmod_bwd_plain(
                x.double(), rn.double(), wcs.double(), G.double(),
                mom.to(None, torch.float64), flags)
            got = feqmod.feqmod_bwd_cuda(x, rn, wcs, G, mom, flags)
            again = feqmod.feqmod_bwd_cuda(x, rn, wcs, G, mom, flags)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"feqmod_bwd {case}: two launches differ")
            _grad_check_fields(f"[grad small feqmod] feqmod_bwd {case} "
                               f"{dtype}", got, want, dtype)


def phase_small_grad_vah():
    """[grad small vah]: K11a and K11b (csrc/vah_bwd.cu) on every
    testing.VAH_EDGES case (every chain setting on each path, regulate and
    outflow off and on, a_L on either side of 1, ragged shapes, strong
    flow, exp overflow, pad rows) against the plain version's autograd in
    f64 from the same inputs, f32 and f64; two launches bit-identical."""
    from is3d_tpu_torch import testing
    from is3d_tpu_torch.kernels import vah
    for case in sorted(testing.VAH_EDGES):
        for dtype in (torch.float32, torch.float64):
            x, mom, flags, G = testing.vah_grad_inputs(case, dtype=dtype,
                                                       device="cuda")
            want = vah.vah_bwd_plain(x.double(), G.double(),
                                     mom.to(None, torch.float64), flags)
            got = vah.vah_bwd_cuda(x, G, mom, flags)
            again = vah.vah_bwd_cuda(x, G, mom, flags)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"vah_bwd {case}: two launches differ")
            _grad_check_fields(f"[grad small vah] vah_bwd {case} {dtype}",
                               got, want, dtype)


def _ptxas(library: str, kernel: str) -> str:
    """The registers and spill bytes ptxas reported, in this run's build,
    for the first kernel of ``library`` whose mangled name matches
    ``kernel``."""
    from is3d_tpu_torch.native import build
    seen, name = {}, None
    for line in build.CUDA_BUILD_LOGS.get(library, "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            seen[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            seen[name]["spill"] = f"{m.group(1)}/{m.group(2)} B spilled"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            seen[name]["regs"] = f"{m.group(1)} registers"
    for k, v in seen.items():
        if re.search(kernel, k) and "regs" in v:
            return f"ptxas {v['regs']}, {v.get('spill', 'spills not shown')}"
    return "ptxas: not in this run's build log"


def _resources(label: str, props: dict, library: str, kernel: str) -> str:
    """One instantiation's launch shape, registers, spills and resident
    blocks an SM (launch.kernel_props and this run's ptxas lines)."""
    warps = props["blocks_per_sm"] * props["threads"] // 32
    return (f"{label}: {props['threads']} threads a block of "
            f"{props['cells_per_block']} cells, {props['smem_bytes']} B shared,"
            f" {props['blocks_per_sm']} blocks an SM ({warps} warps), "
            f"{props['registers']} registers, {props['local_bytes']} B local "
            f"({_ptxas(library, kernel)})")


def _grad_kernel_pair(smi: str, clock: float, tag: str, kern, kslice,
                      plain, plain64, n: int, bound, evals: float,
                      bodies: list, note: str, checked: str,
                      kslice64=None) -> dict:
    """A backward kernel on one canonical group as [grad pair] takes it:
    two launches bit-identical, the CUDA-event median of 3 (one warm-up),
    n of the group's cells (``kslice``; ``checked`` says which) against the
    plain version's autograd in f64 (``plain64``) and the plain version's
    own error in f32 (``plain``, one timed run), the bound and its share;
    for each instantiation of ``bodies`` (label, library, mangled name,
    kernel_props) its registers, spills and resident blocks, and its SASS
    per evaluation.  Given ``kslice64`` (the float64 kernel on the same
    cells), every field is also held in f64: at the f64 bar, or at the f32
    bar where the plain version in f32 misses that bar (a field that
    cancels, whose f32 hold the plain version's own error waives).
    Returns the kernel record."""
    from is3d_tpu_torch import testing
    from is3d_tpu_torch.utils import cuda_median_ms
    tup = lambda t: t if isinstance(t, tuple) else (t,)
    got, again = tup(kern()), tup(kern())
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"{tag}: two launches on the same group differ")
    k_ms, k_all = cuda_median_ms(kern, 3)
    want = plain64()
    p32, p_ms = _timed_once(plain)
    err = _grad_check_fields(f"[{tag}] float32, {n} of the group's cells "
                             f"({checked})", kslice(), want, torch.float32,
                             p32)
    if kslice64 is not None:
        loose = testing.grad_field_errors(p32, want, *TOL[torch.float32])[0]
        _grad_check(f"[{tag}] float64, {n} of the group's cells ({checked})",
                    kslice64(), want, torch.float64,
                    loose=loose.nonzero().flatten().tolist())
    del want, p32
    print(f"[{tag}] {smi} | {note}: backward kernel {k_ms:.3f} ms (runs "
          f"{', '.join(f'{t:.2f}' for t in k_all)}), "
          f"{evals / k_ms * 1e3:.3e} evaluations/s; plain (autograd, f32) "
          f"{p_ms:.3f} ms on {n} cells; bound {bound[0]:.3f} ms "
          f"({bound[1]}), kernel at {bound[0] / k_ms:.1%} of it; two "
          "launches bit-identical")
    for label, library, kernel, props in bodies:
        print(f"[{tag}] {_resources(label, props, library, kernel)}; issued "
              f"per evaluation: {_issued(library, kernel)}")
    return dict(launches=None, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                bound_ms=bound[0], bound_by=bound[1], library_ms=None,
                plain_cells=n, bodies={b[0]: b[3] for b in bodies})


def phase_grad_feqmod_pair(smi: str, clock: float, run_dir: str, cfg,
                           tag: str) -> dict:
    """[grad feqmod pair] / [grad feqmod pair 2d]: K10a (K10b with the
    remap) on the first canonical group of a feqmod main path (f32, a
    positive cotangent), as _grad_kernel_pair, the checked cells an equal
    share of each chain's part (kernels/feqmod.py:chain_split; cells
    per instantiation printed); the bound from the evaluations of each
    chain this group makes (kernels/feqmod.py:feqmod_backward_formula_ops)."""
    from is3d_tpu_torch import testing
    from is3d_tpu_torch.io.tables import laguerre_device
    from is3d_tpu_torch.kernels import feqmod
    from is3d_tpu_torch.kernels.smooth import momentum_constants
    cols, species, grid, df_data = _feqmod_run(run_dir, cfg)
    group = _first_group(cols, cfg)
    flags = feqmod.feqmod_flags(cfg, grid)
    mom = momentum_constants(species, grid, cfg.dimension)
    mom64 = mom.to(None, torch.float64)
    x, rn, wcs = feqmod.group_inputs(
        group, species, laguerre_device(dtype=torch.float32, device="cuda"),
        df_data, cfg, flags)
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    R = mom.nodes.shape[0]
    G = testing.grad_cotangent((S, P, F, R if cfg.dimension == 3 else 1),
                               dtype=torch.float32, device="cuda")
    order, offs = feqmod.chain_split(x, cfg.dimension)
    offs = offs.tolist()
    chains = range(3 if cfg.dimension == 3 else 2)
    split = {feqmod.CHAINS[i]: offs[i + 1] - offs[i] for i in chains}
    present = [i for i in chains if offs[i + 1] > offs[i]]
    share = GRAD_PAIR_PLAIN_CELLS // len(present)
    idx = torch.cat([order[offs[i]:offs[i] + share] for i in present]
                    ).long().sort().values
    n = idx.numel()
    xs, rns, wcss = (t[idx].contiguous() for t in (x, rn, wcs))
    mod, fb = _feqmod_evals(x, mom, flags)
    ops = [feqmod.feqmod_backward_formula_ops(flags.df_mode, flags.remap,
                                              F, chain)
           for chain in (False, True)]
    evals = mod + fb
    bound = _bound(evals, (mod * ops[0][0] + fb * ops[1][0]) / evals,
                   (mod * ops[0][1] + fb * ops[1][1]) / evals,
                   _nbytes(x, rn, wcs, G, x, rn, *mom_tensors(mom)), clock)
    bodies = []
    for i in chains:
        bodies.append((f"{feqmod.CHAINS[i]} ({split[feqmod.CHAINS[i]]}"
                       " cells)", "feqmod_bwd", feqmod.bwd_kernel_name(flags, i),
                       feqmod.bwd_props(x.device, False, mom, flags, i)))
    bd = (x[:, feqmod.FQ["bd"]] > 0).double().mean().item()
    rec = _grad_kernel_pair(
        smi, clock, tag, lambda: feqmod.feqmod_bwd_cuda(x, rn, wcs, G, mom,
                                                        flags),
        lambda: feqmod.feqmod_bwd_cuda(xs, rns, wcss, G, mom, flags),
        lambda: feqmod.feqmod_bwd_plain(xs, rns, wcss, G, mom, flags),
        lambda: feqmod.feqmod_bwd_plain(xs.double(), rns.double(),
                                        wcss.double(), G.double(), mom64,
                                        flags),
        n, bound, evals, bodies,
        f"df {flags.df_mode}, one group {x.shape[0]} cells x {S} x {P * F} "
        f"x {R} nodes ({bd:.1%} of cells break down, {fb / evals:.1%} of "
        "the evaluations take the fallback); cells per instantiation "
        + ", ".join(f"{k} {v}" for k, v in split.items()),
        f"the first {share} of each chain's part")
    rec["cells_per_chain"] = split
    return rec


def phase_grad_feqmod_main(smi: str, run_dir: str, cfg, tag: str) -> dict:
    """[grad feqmod main] / [grad feqmod main 2d]: _grad_path of the
    production feqmod spectra (smooth_spectra_feqmod) with respect to
    GRAD_WRT (and eta in 3+1D): K3 and K10a (K10b with the remap) each
    launched once a group."""
    from is3d_tpu_torch import diff
    from is3d_tpu_torch.kernels.feqmod import smooth_spectra_feqmod
    from is3d_tpu_torch.parallel.mesh import canonical_groups
    run, _, df_data, species, mcids, grid = _prepared(run_dir, cfg)
    surface = run.surface
    groups, _ = canonical_groups(cfg, surface.n_cells)
    remap = cfg.dimension == 2 and grid.eta_mT_rescale
    want = (dict(feqmod_spectra_remap=groups, feqmod_bwd_remap=groups)
            if remap else dict(feqmod_spectra=groups, feqmod_bwd=groups))
    return _grad_path(
        smi, tag, surface,
        lambda dt: diff.spectra_fn(species.to(None, dt), grid.to(None, dt),
                                   df_data.to(None, dt), cfg),
        lambda: smooth_spectra_feqmod(surface, species, grid, df_data, cfg),
        mcids, grid, cfg, GRAD_WRT + (("eta",) if cfg.dimension == 3 else ()),
        want, [("T", 5), ("ux", 17), ("pixy", 33), ("bulkPi", 41)] + (
            [("eta", 9)] if cfg.dimension == 3 else [("dat", 9)]))


def phase_grad_feqmod_decays(smi: str, run_dir: str, cfg):
    """[grad feqmod decays]: decayed_spectra_fn with df 3 on the [decays
    main] surface (the decaying list, 3+1D, f32): its forward equals
    do_resonance_decays of smooth_spectra_feqmod bit for bit; the pullback
    of a positive cotangent launches K3 and K10a once a group and K2 and
    K9c once a wave of each body (counted from 0 around the run); every
    gradient finite and nonzero; forward and backward seconds."""
    from is3d_tpu_torch import diff, testing
    from is3d_tpu_torch.kernels import decays
    from is3d_tpu_torch.kernels.feqmod import smooth_spectra_feqmod
    from is3d_tpu_torch.parallel.mesh import canonical_groups
    cfg = cfg.replace(df_mode=3)
    run, table, df_data, species, mcids, grid = _prepared(run_dir, cfg)
    surface = run.surface
    groups, _ = canonical_groups(cfg, surface.n_cells)
    fn = diff.decayed_spectra_fn(species, grid, df_data, cfg, table, mcids)
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out, pull = diff.surface_vjp(fn, surface, ("T", "ux", "bulkPi",
                                                   "pixy"))
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    t0 = time.perf_counter()
    grads = pull(testing.grad_cotangent(out.shape, device="cuda"))
    torch.cuda.synchronize()
    t_bwd = time.perf_counter() - t0
    counts = _counts()
    sched = _main_decays_schedule()
    _expect_counts("grad feqmod decays path", counts, dict(
        feqmod_spectra=groups, feqmod_bwd=groups,
        decay_wave_2body=sched["waves_2body"],
        decay_wave_3body=sched["waves_3body"],
        decay_wave_bwd_2body=sched["waves_2body"],
        decay_wave_bwd_3body=sched["waves_3body"]))
    with contextlib.redirect_stdout(io.StringIO()):
        prod = decays.do_resonance_decays(smooth_spectra_feqmod(
            surface, species, grid, df_data, cfg), table, mcids, grid, cfg)
    if not torch.equal(out, prod):
        fail("grad feqmod decays: the traced forward differs from "
             "do_resonance_decays")
    for k, g in grads.items():
        if not (torch.isfinite(g).all() and g.abs().max() > 0):
            fail(f"grad feqmod decays: the gradient by {k} is not finite "
                 "and nonzero")
    print(f"[grad feqmod decays] {smi} | {surface.n_cells} cells x "
          f"{out.shape[0]} species, 3+1D df 3: forward {t_fwd:.3f} s "
          f"(bit-equal to do_resonance_decays), backward {t_bwd:.3f} s | "
          "launches " + ", ".join(f"{k} {counts[k]}" for k in (
              "feqmod_spectra", "feqmod_bwd", "decay_wave_bwd_2body",
              "decay_wave_bwd_3body")))


def phase_grad_vah_pair(smi: str, clock: float, groups: list) -> list:
    """[grad vah pair]: K11a / K11b on one canonical group of a VAH main
    path (f32, a positive cotangent) for each (kind, columns, species,
    grid, cfg) of ``groups``, as _grad_kernel_pair; the bound from
    kernels/vah.py:vah_backward_formula_ops."""
    from is3d_tpu_torch import testing
    from is3d_tpu_torch.kernels import vah
    from is3d_tpu_torch.kernels.smooth import momentum_constants
    records = []
    for kind, cols, species, grid, cfg in groups:
        flags = vah.vah_flags(vah.effective_vah_cfg(cols, cfg), grid)
        x = vah.group_inputs(cols, flags)
        mom = momentum_constants(species, grid, cfg.dimension)
        mom64 = mom.to(None, torch.float64)
        S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
        R = mom.nodes.shape[0]
        G = testing.grad_cotangent((S, P, F, R if cfg.dimension == 3 else 1),
                                   dtype=torch.float32, device="cuda")
        n = GRAD_PAIR_PLAIN_CELLS
        xs = x[:n].contiguous()
        evals = x.shape[0] * S * P * F * R
        bound = _bound(evals, *vah.vah_backward_formula_ops(flags, F),
                       _nbytes(x, G, x, *mom_tensors(mom)), clock)
        kernel = (f"vah_remap_bwd_kernelIfLi{flags.switches}EE" if flags.remap
                  else f"vah_bwd_kernelIfLi{flags.dimension}ELi"
                  f"{flags.switches}EE")
        records.append(_grad_kernel_pair(
            smi, clock, "grad vah pair",
            lambda: vah.vah_bwd_cuda(x, G, mom, flags),
            lambda: vah.vah_bwd_cuda(xs, G, mom, flags),
            lambda: vah.vah_bwd_plain(xs, G, mom, flags),
            lambda: vah.vah_bwd_plain(xs.double(), G.double(), mom64, flags),
            n, bound, evals, [(f"chains {flags.switches}", "vah_bwd", kernel,
                               vah.bwd_props(x.device, False, mom, flags))],
            f"{kind}: one group {x.shape[0]} cells x {S} x {P * F} x {R} "
            f"nodes (chains {flags.switches})", "the first ones"))
    return records


def phase_grad_vah_main(smi: str, surface, species, grid, cfg, mcids,
                        tag: str, wrt) -> dict:
    """[grad vah main 2d] / [grad vah main 3d]: _grad_path of the
    production VAH spectra (smooth_spectra_vah) of a VAH main path's
    surface with respect to ``wrt``: K4 and K11a (K11b with the remap)
    each launched once a group."""
    from is3d_tpu_torch import diff
    from is3d_tpu_torch.kernels.vah import smooth_spectra_vah
    from is3d_tpu_torch.parallel.mesh import canonical_groups
    groups, _ = canonical_groups(cfg, surface.n_cells)
    remap = cfg.dimension == 2 and grid.eta_mT_rescale
    want = (dict(vah_spectra_remap=groups, vah_bwd_remap=groups) if remap
            else dict(vah_spectra=groups, vah_bwd=groups))
    picks = [("Lambda", 5), ("aL", 17), ("ux", 33)] + (
        [("eta", 9)] if cfg.dimension == 3 else [("dat", 9)])
    if "c3" in wrt:
        picks += [("c3", 41), ("bulkPi", 12)]
    return _grad_path(
        smi, tag, surface,
        lambda dt: diff.spectra_fn(species.to(None, dt), grid.to(None, dt),
                                   None, cfg),
        lambda: smooth_spectra_vah(surface, species, grid, cfg),
        mcids, grid, cfg, wrt + (("eta",) if cfg.dimension == 3 else ()),
        want, picks)


def _polzn_bwd_check(name, got, want, plain, dtype, plain32=None) -> float:
    """A K12 gradient (C, NW) against the f64 plain one (``want``) per
    field as _grad_check_fields takes it, with a massless species' NaN and
    inf where the plain version in the kernel's precision (``plain``) has
    them; ``plain32`` the plain version's own float32 gradient at the main
    shapes (3x its error allowed)."""
    for what, f in (("NaN", torch.isnan), ("+inf", torch.isposinf),
                    ("-inf", torch.isneginf)):
        if not torch.equal(f(got), f(plain)):
            fail(f"{name}: the kernel's {what} positions differ from the "
                 "plain version's")
    fin = torch.isfinite(plain) & torch.isfinite(want)
    n_bad = int((~fin).sum())
    if n_bad:
        name += f" [{n_bad} non-finite entries in the same places]"
    keep = lambda t: torch.where(fin, t, torch.zeros_like(t))
    return _grad_check_fields(name, keep(got), keep(want), dtype,
                              None if plain32 is None else keep(plain32))


def phase_small_grad_polzn():
    """[grad small polzn]: K12a and K12b (csrc/polzn_bwd.cu) on every
    testing.POLZN_EDGES case (3+1D, 2+1D fixed nodes and the remap; ragged
    species, points and nodes; exp overflow; strong flow; a massless
    species; pad rows) against the plain version's autograd in f64 from
    the same inputs (a positive cotangent on the five sums), f32 and f64,
    the massless cases' NaN and inf where the plain version has them in
    the kernel's precision; two launches bit-identical."""
    from is3d_tpu_torch import testing
    from is3d_tpu_torch.kernels import polzn
    n = 0
    for case in sorted(testing.POLZN_EDGES):
        for dtype in (torch.float32, torch.float64):
            x, mom, pm, wR, flags, table, G = testing.polzn_grad_inputs(
                case, dtype=dtype, device="cuda")
            want = polzn.polzn_bwd_plain(
                x.double(), G.double(), mom.to(None, torch.float64),
                pm.double(), wR.double(), flags)
            plain = polzn.polzn_bwd_plain(x, G, mom, pm, wR, flags)
            got = polzn.polzn_bwd_cuda(x, G, mom, pm, wR, flags, table)
            again = polzn.polzn_bwd_cuda(x, G, mom, pm, wR, flags, table)
            torch.cuda.synchronize()
            if not torch.equal(_bits(got), _bits(again)):
                fail(f"polzn_bwd {case}: two launches differ")
            _polzn_bwd_check(f"[grad small polzn] polzn_bwd {case} {dtype}",
                             got, want, plain, dtype)
            n += 1
    print(f"[grad small polzn] {n} gradients of K12a/K12b agree with the "
          "plain version's autograd; two launches bit-identical; the "
          "massless species' NaN/inf in place")


def phase_grad_polzn_pair(smi: str, clock: float, groups: list) -> list:
    """[grad polzn pair]: K12a / K12b on one canonical group of a
    polarization main path (f32, a positive cotangent on the five sums)
    for each (kind, columns, species, grid, cfg, T_avg) of ``groups``, as
    _grad_kernel_pair, the float64 kernel on the same cells too (the
    remap's y_flow column cancels: its gradient is a boundary term of an
    integral over eta that does not depend on y_flow, and float32 holds
    little of it); the bound from
    kernels/polzn.py:polzn_backward_formula_ops."""
    from is3d_tpu_torch import testing
    from is3d_tpu_torch.kernels import polzn
    from is3d_tpu_torch.kernels.smooth import (momentum_constants,
                                               remap_node_table)
    records = []
    for kind, cols, species, grid, cfg, T_avg in groups:
        flags = polzn.polzn_flags(cfg, grid)
        x = polzn.pack_polzn_cells(cols, T_avg, flags)
        mom = momentum_constants(species, grid, cfg.dimension)
        # the float64 constants from the float64 grid: the remap kernel
        # forms pT cos phi, pT sin phi itself, which float32 px, py carried
        # to float64 would miss by their float32 rounding
        mom64 = momentum_constants(species.to(None, torch.float64),
                                   grid.to(None, torch.float64),
                                   cfg.dimension)
        pm, wR = polzn.species_pm(species), polzn.node_weights(grid, flags)
        table = remap_node_table(mom) if flags.remap else None
        S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
        R = mom.nodes.shape[0]
        G = testing.grad_cotangent((5, S, P, F, R if cfg.dimension == 3
                                    else 1), dtype=torch.float32,
                                   device="cuda")
        n = GRAD_PAIR_PLAIN_CELLS
        xs = x[:n].contiguous()
        evals = x.shape[0] * S * P * F * R
        nb = _nbytes(x, G, x, pm, wR, *mom_tensors(mom)) + (
            _nbytes(table) if flags.remap else 0)
        bound = _bound(evals, *polzn.polzn_backward_formula_ops(
            flags.remap, F), nb, clock)
        kernel = ("polzn_remap_bwd_kernelIfEE" if flags.remap
                  else f"polzn_bwd_kernelIfLi{flags.dimension}EE")
        plain64 = lambda: polzn.polzn_bwd_plain(
            xs.double(), G.double(), mom64, pm.double(), wR.double(), flags)
        plan = _bwd_plan(polzn.bwd_props(x.device, False, mom, flags,
                                         x.shape[0]), x.shape[0])
        rec = _grad_kernel_pair(
            smi, clock, "grad polzn pair",
            lambda: polzn.polzn_bwd_cuda(x, G, mom, pm, wR, flags, table),
            lambda: polzn.polzn_bwd_cuda(xs, G, mom, pm, wR, flags, table),
            lambda: polzn.polzn_bwd_plain(xs, G, mom, pm, wR, flags),
            plain64, n, bound, evals,
            [("five sums", "polzn_bwd", kernel, plan)],
            f"{kind}: one group {x.shape[0]} cells x {S} x {P * F} x {R} "
            f"nodes, five sums", "the first ones",
            kslice64=lambda: polzn.polzn_bwd_cuda(
                xs.double(), G.double(), mom64, pm.double(), wR.double(),
                flags))
        print(f"[grad polzn pair] {kind}: stages of "
              f"{plan['species_per_stage']} species x "
              f"{plan['pT_rows_per_stage']} pT rows ("
              f"{-(-S // plan['species_per_stage'])} species chunks), "
              f"{plan['angles']} angles at once, {plan['stage_row']} values "
              f"a {'point' if flags.remap else 'species stage row'}, "
              f"{plan['waves']} waves, the last {plan['last_wave_blocks']} "
              f"blocks ({plan['last_wave_fill']:.1%} of the resident)")
        records.append(rec)
    return records


def phase_grad_polzn_main(smi: str, run_dir: str, cfg, tag: str) -> dict:
    """[grad polzn main 2d] / [grad polzn main 3d]: _grad_path of the
    production polarization (spin_polarization's dict) of a polarization
    main path's surface with respect to the vorticity wtx..wyn, the flow,
    dsigma (and eta in 3+1D), the observable the sum over pT and phi of
    the Lambda row's St, Sx, Sy and Sn over Snorm (tests/test_grad.py's
    Sy_over_Snorm alone does not depend on wty, wxy or wyn, whose
    gradients would be exactly 0): K6 and K12a (K12b with the remap) each
    launched once a group."""
    from is3d_tpu_torch import diff
    from is3d_tpu_torch.kernels.polzn import spin_polarization
    from is3d_tpu_torch.parallel.mesh import canonical_groups
    run, _, _, species, mcids, grid = _prepared(run_dir, cfg)
    lam = int(np.nonzero(np.asarray(mcids) == 3122)[0][0])
    surface, plasma = run.surface, run.plasma()
    groups, _ = canonical_groups(cfg, surface.n_cells)
    remap = cfg.dimension == 2 and grid.eta_mT_rescale
    want = (dict(polzn_remap=groups, polzn_bwd_remap=groups) if remap
            else dict(polzn=groups, polzn_bwd=groups))
    wrt = GRAD_POLZN_WRT + (("eta",) if cfg.dimension == 3 else ())
    picks = [("wtx", 5), ("wxn", 17), ("wty", 25), ("ux", 33),
             ("dat", 41)] + ([("eta", 9)] if cfg.dimension == 3
                             else [("un", 9)])
    return _grad_path(
        smi, tag, surface,
        lambda dt: diff.polarization_fn(species.to(None, dt),
                                        grid.to(None, dt), cfg, plasma),
        lambda: spin_polarization(surface, species, grid, cfg, plasma),
        mcids, grid, cfg, wrt, want, picks,
        observable=lambda g: lambda out: sum(
            out[f"S{c}_over_Snorm"][lam].sum() for c in "txyn"))


def phase_grad_mode5(smi: str, run_dir: str, cfg) -> dict:
    """[grad mode5]: the spectra of a mode-5 (vorticity) surface are K1's
    (api.py): _grad_path of smooth_spectra on [polzn main 2d]'s surface,
    K1's remap and K9b each launched once a group, no polarization
    kernel."""
    from is3d_tpu_torch import diff
    from is3d_tpu_torch.kernels.smooth import smooth_spectra
    from is3d_tpu_torch.parallel.mesh import canonical_groups
    run, _, df_data, species, mcids, grid = _prepared(run_dir, cfg)
    surface = run.surface
    groups, _ = canonical_groups(cfg, surface.n_cells)
    return _grad_path(
        smi, "grad mode5", surface,
        lambda dt: diff.spectra_fn(species.to(None, dt), grid.to(None, dt),
                                   df_data.to(None, dt), cfg),
        lambda: smooth_spectra(surface, species, grid, df_data, cfg),
        mcids, grid, cfg, GRAD_WRT,
        dict(smooth_spectra=groups, smooth_spectra_remap=groups,
             spectra_bwd=groups, spectra_bwd_remap=groups),
        [("T", 5), ("ux", 17), ("bulkPi", 41)])


def phase_ensemble_batch(smi: str):
    """[ensemble batch]: IS3D.run_ensemble over ENSEMBLE_EVENTS events of
    ENSEMBLE_CELLS cells x 320 species, 2+1D df 2 (the first event read
    from its file, the rest in memory), writing one results tree per event;
    each event's spectra equal its single run bit for bit; the wall time
    by phase."""
    import dataclasses
    from is3d_tpu_torch.api import IS3D
    from is3d_tpu_torch.kernels.smooth import smooth_spectra
    from is3d_tpu_torch.testing import (synthetic_surface,
                                        write_synthetic_run_dir)
    run_dir = os.path.join(WORK, "ensemble_batch")
    write_synthetic_run_dir(run_dir, ENSEMBLE_CELLS, MAIN_SPECIES,
                            dimension=2, seed=0)
    overrides = dict(a.split("=", 1) for a in MAIN2D_ARGS[1:])
    run = IS3D.from_run_dir(run_dir, device="cuda", overrides=overrides)
    path = os.path.join(run_dir, "input", "surface.dat")
    # the in-memory events carry the blocks the file's reader gives
    first = IS3D.from_run_dir(run_dir, device="cuda", overrides=overrides
                              ).read_fo_surf_from_file(
                                  path, write_averages=False).surface
    absent = {f.name: None for f in dataclasses.fields(first)
              if getattr(first, f.name) is None}
    events = [path] + [
        synthetic_surface(ENSEMBLE_CELLS, 2, seed=e, dtype=torch.float32,
                          device="cuda").replace(**absent)
        for e in range(1, ENSEMBLE_EVENTS)]
    t0 = time.perf_counter()
    results = run.run_ensemble(events)
    wall = time.perf_counter() - t0
    _, df_data, species, _, grid = run._prepare()
    for e, res in enumerate(results):
        # run_ensemble leaves the first event (read from its file) as the
        # run's surface
        surf = run.surface if e == 0 else events[e]
        single = smooth_spectra(surf, species, grid, df_data, run.cfg)
        if not np.array_equal(res.spectra, single.cpu().numpy()):
            fail(f"ensemble batch: event {e}'s row differs from its single "
                 "run")
        if not os.path.isfile(os.path.join(run.results_dir, f"event_{e}",
                                           "dN_pTdpTdphidy.dat")):
            fail(f"ensemble batch: event {e} wrote no spectra file")
    phases = {}
    for k, v in run.timer.phases:
        phases[k] = phases.get(k, 0.0) + v
    print(f"[ensemble batch] {smi} | {ENSEMBLE_EVENTS} events x "
          f"{ENSEMBLE_CELLS} cells x {MAIN_SPECIES} species, 2+1D df 2: "
          f"wall {wall:.3f} s; by phase: " + ", ".join(
              f"{k} {v:.3f} s" for k, v in phases.items())
          + "; every row bit-equal to its single run")
    _keep_events([run.surface] + events[1:], species, grid, df_data,
                 run.cfg)
    shutil.rmtree(run_dir, ignore_errors=True)


def _keep_events(surfaces, species, grid, df_data, cfg):
    """[mesh events]' inputs on the host: the ensemble stacked, the same
    with each event's thermal vorticity (mode 5) and its T_avg."""
    from is3d_tpu_torch import batch
    from is3d_tpu_torch.io.surface import surface_averages
    from is3d_tpu_torch.testing import synthetic_vorticity
    stacked = batch.stack_surfaces(surfaces)
    vort = [synthetic_vorticity(ENSEMBLE_CELLS, seed=e)
            for e in range(ENSEMBLE_EVENTS)]
    polzn = stacked.replace(**{k: torch.tensor(np.stack([v[k] for v in vort]),
                                               dtype=stacked.tau.dtype,
                                               device=stacked.tau.device)
                               for k in vort[0]})
    T_avg = [surface_averages(s).temperature for s in surfaces]
    path = os.path.join(WORK, "mesh_events.pt")
    torch.save(dict(stacked=stacked.to("cpu"), polzn=polzn.to("cpu"),
                    species=species.to("cpu"), grid=grid.to("cpu"),
                    df_data=df_data.to("cpu"), cfg=cfg,
                    T_avg=torch.tensor(T_avg, dtype=torch.float64)), path)
    MESH_EVENTS["path"] = path


# ------------------------------------------------------------ multi-GPU

def _keep(tag: str, run_dir: str, args, want):
    """Keep a main-path run directory for [mesh]: its CLI args, the
    kernels each canonical group launches there, and the CLI's results
    tree (the one-process tree) as ``results_mesh_one``."""
    os.rename(os.path.join(run_dir, "results"),
              os.path.join(run_dir, "results_mesh_one"))
    MESH_DIRS[tag] = (run_dir, list(args), tuple(want))


def _release(run_dir: str):
    """Remove a run directory unless [mesh] keeps it."""
    if not any(run_dir == d for d, _, _ in MESH_DIRS.values()):
        shutil.rmtree(run_dir, ignore_errors=True)


def _overrides(args) -> dict:
    return dict(a.split("=", 1) for a in args if not a.startswith("device="))


def _mesh_runs(results: str) -> list:
    return [dict(name=tag, run_dir=d, overrides=_overrides(args),
                 results_dir=os.path.join(d, results))
            for tag, (d, args, _) in MESH_DIRS.items()]


def _slice_local(run, mesh):
    """The slice-local path of a run (operation 1: smooth_spectra_multihost,
    0: spacetime_distributions_multihost) from the columns of this rank's
    process_cell_slice alone."""
    from is3d_tpu_torch.kernels.common import surface_columns
    from is3d_tpu_torch.kernels.dndx import dndx_cols
    from is3d_tpu_torch.parallel import multihost
    _, df_data, species, _, grid = run._prepare()
    cfg, n = run.cfg, run.surface.n_cells
    a, b = multihost.process_cell_slice(cfg, n, mesh)
    if cfg.operation == 1:
        cols = surface_columns(run.surface, cfg)
        local = {k: v[a:b] for k, v in cols.items()}
        _reset_counts()
        return multihost.smooth_spectra_multihost(
            local, n, species, grid, df_data, cfg, mesh).cpu().numpy()
    cols = dndx_cols(run.surface, cfg)
    local = {k: v[a:b] for k, v in cols.items()}
    _reset_counts()
    return multihost.spacetime_distributions_multihost(
        local, n, species, grid, df_data, cfg, mesh)


def _mesh_grad(run, mesh=None) -> dict:
    """[grad main]'s observable through diff.spectra_fn (with ``mesh``):
    its gradient by GRAD_WRT and eta (surface_value_and_grad) and the
    observable's cotangent on the spectra."""
    from is3d_tpu_torch import diff
    _, df_data, species, mcids, grid = run._prepare()
    fn = diff.spectra_fn(species, grid, df_data, run.cfg, mesh=mesh)
    obs = _grad_observable(grid, mcids)
    wrt = GRAD_WRT + ("eta",)
    _reset_counts()
    t0 = time.perf_counter()
    value, grads = diff.surface_value_and_grad(lambda s: obs(fn(s)),
                                               run.surface, wrt)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    wall = time.perf_counter() - t0
    counts = _counts()
    y = fn(run.surface).requires_grad_(True)
    with torch.enable_grad():
        ct = torch.autograd.grad(obs(y), y)[0]
    return dict(value=value.cpu(), grads={k: v.cpu() for k, v in
                                          grads.items()},
                cotangent=ct.cpu(), counts=counts, wall=wall)


# [mesh events]' gradient fields of the stacked 2+1D ensemble
EVENTS_GRAD_WRT = ("T", "ux", "uy", "bulkPi", "pixy", "dat")


def _events_cases(path: str, device) -> dict:
    """[mesh events]' batched cases (testing.batched_case) on ``device``:
    the spectra of the stacked ensemble, and its mode-5 polarization."""
    inp = torch.load(path, weights_only=False)
    common = dict(species=inp["species"].to(device),
                  grid=inp["grid"].to(device),
                  df_data=inp["df_data"].to(device))
    return dict(spectra=dict(common, kind="spectra", cfg=inp["cfg"],
                             stacked=inp["stacked"].to(device)),
                polzn=dict(common, kind="polzn",
                           cfg=inp["cfg"].replace(mode=5),
                           stacked=inp["polzn"].to(device),
                           T_avg=inp["T_avg"]))


def _timed(fn):
    """fn()'s result on the host, its launch counts and its wall seconds
    (to a device sync)."""
    _reset_counts()
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(result=_host(out), counts=_counts(), wall=wall)


def _host(x):
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_host(v) for v in x)
    return x.cpu() if isinstance(x, torch.Tensor) else x


def _mesh_events(path: str, mesh=None, device="cuda") -> dict:
    """[mesh events]: the batched spectra, polarization and spectra
    gradient of the kept ensemble, over the event axis of ``mesh`` (or in
    one process)."""
    from is3d_tpu_torch import testing
    cases = _events_cases(path, device if mesh is None else mesh.device)
    out = {name: _timed(lambda c=c: testing.batched_case(c, mesh))
           for name, c in cases.items()}
    out["grad"] = _timed(lambda: _events_grad(cases["spectra"], mesh))
    return out


def _events_grad(case: dict, mesh):
    """The value and gradient of sum dN/dy + sum <pT> over the batched
    spectra's events by EVENTS_GRAD_WRT (one forward and one backward
    pass; testing.batched_grad adds surface_vjp's on the CPU)."""
    from is3d_tpu_torch import diff, testing

    def loss(stacked):
        out = testing.batched_case(dict(case, stacked=stacked), mesh)
        return sum(diff.dN_dy_j(row, case["grid"]).sum()
                   + diff.mean_pT_j(row, case["grid"]).sum() for row in out)
    return diff.surface_value_and_grad(loss, case["stacked"],
                                       EVENTS_GRAD_WRT)


def _mesh_sample(spec: dict, mesh) -> dict:
    """[mesh sample] on a rank: sample_particles(mesh=) of the kept run
    directory's surface."""
    from is3d_tpu_torch.api import IS3D
    from is3d_tpu_torch.kernels import sample
    run = IS3D.from_run_dir(spec["run_dir"], overrides=spec["overrides"],
                            mesh=mesh)
    run.read_fo_surf_from_file(write_averages=False)
    _, df_data, species, mcids, _ = run._prepare()
    info = {}
    out = _timed(lambda: sample.sample_particles(
        run.surface, species, mcids, df_data, run.cfg, run.plasma(),
        mesh=mesh, info=info))
    return dict(out, info=info)


def mesh_rank(mesh, runs, slices, grad, write, events=None,
              sampled=None) -> dict:
    """One rank of [mesh]: api.IS3D(mesh=) on each of ``runs`` (with
    ``write`` rank 0 writes ``results_dir``; another rank is given
    ``<results_dir>_rank<r>``, where it must write nothing), the
    slice-local path on each of ``slices``, and with ``grad`` [mesh grad]
    on that run; each with its launch counts, parallel.mesh.MESH_STATS and
    wall seconds; with ``events`` (the inputs' path) [mesh events] and
    with ``sampled`` (a run directory and overrides) [mesh sample]."""
    from is3d_tpu_torch import testing
    from is3d_tpu_torch.api import IS3D
    from is3d_tpu_torch.parallel import mesh as pmesh
    out = dict(runs={}, slices={}, grad=None)
    for run in runs:
        _reset_counts()
        res = testing.mesh_api_rank(mesh, [run], write)[run["name"]]
        out["runs"][run["name"]] = dict(res, counts=_counts())
    for run in slices:
        r = IS3D.from_run_dir(run["run_dir"], overrides=run["overrides"],
                              mesh=mesh)
        pmesh.reset_mesh_stats()
        t0 = time.perf_counter()
        res = _slice_local(r, mesh)
        out["slices"][run["name"]] = dict(
            result=res, counts=_counts(), stats=dict(pmesh.MESH_STATS),
            wall=time.perf_counter() - t0)
    if grad is not None:
        pmesh.reset_mesh_stats()
        out["grad"] = _mesh_grad(IS3D.from_run_dir(
            grad["run_dir"], overrides=grad["overrides"], mesh=mesh), mesh)
        out["grad"]["stats"] = dict(pmesh.MESH_STATS)
    if events is not None:
        out["events"] = _mesh_events(events, mesh)
    if sampled is not None:
        out["sample"] = _mesh_sample(sampled, mesh)
    return out


def _same(a, b) -> bool:
    """torch.equal of two results: arrays, tensors, dicts or tuples of
    them, None."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(b, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in b)
    if isinstance(b, tuple):
        return len(a) == len(b) and all(map(_same, a, b))
    return torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def _tree_bytes(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _rank_line(tag: str, smi: str, W: int, backend: str, r: int,
               stats: dict, wall: float) -> str:
    return (f"[{tag}] {smi} | W = {W} ({backend}, every rank on one card) "
            f"rank {r}: wall {wall:.3f} s, compute {stats['compute_s']:.3f}"
            f" s over {stats['groups']} groups, gathered "
            f"{stats['gathered_bytes']} B, gather + fold "
            f"{stats['gather_fold_s']:.3f} s")


def phase_mesh(smi: str, device: str = "cuda"):
    """[mesh] and [mesh grad] (docstring, 14): the spawns of MESH_STAGES'
    first stage start, this process computes the one-process results
    meanwhile, and each spawn is held to them; then each later stage's
    spawns at once, the last beside [pod]; every rank on ``device`` (index
    0)."""
    runs = _mesh_runs("results_mesh_one")
    grad_run = next(r for r in runs if r["name"] == "main")
    ref = dict(runs=runs, grad_run=grad_run, slice_runs=[
        r for r in runs if r["name"] in ("main", "dndx main")])
    started = [_spawn_start(device, W, backend, ref)
               for W, backend in MESH_STAGES[0]]
    try:
        _mesh_references(smi, device, ref)
    finally:
        for spawn in started:
            spawn["thread"].join()
    for spawn in started:
        _spawn_check(smi, spawn, ref)
    for k, stage in enumerate(MESH_STAGES[1:], 1):
        started, pods = [], []
        try:
            started = [_spawn_start(device, W, backend, ref)
                       for W, backend in stage]
            if k == len(MESH_STAGES) - 1:
                pods = _pod_start()
            for spawn in started:
                spawn["thread"].join()
            _pod_finish(smi, pods)
        finally:
            for spawn in started:
                spawn["thread"].join()
            _pod_stop(pods)
        for spawn in started:
            _spawn_check(smi, spawn, ref,
                         beside=len(stage) > 1 or bool(pods))
    for d, _, _ in MESH_DIRS.values():
        shutil.rmtree(d, ignore_errors=True)
    MESH_DIRS.clear()
    for d in [MESH_SAMPLE.get("run_dir")] + [v[0]
                                              for v in POD_DIRS.values()]:
        if d:
            shutil.rmtree(d, ignore_errors=True)
    MESH_SAMPLE.clear()
    POD_DIRS.clear()


def _mesh_references(smi: str, device: str, ref: dict):
    """The one-process results the spawns are held to, into ``ref``: the
    API run of each kept run directory, [grad main]'s gradient, [mesh
    events]' and [mesh sample]'s."""
    from is3d_tpu_torch.api import IS3D
    one, n_cells = {}, {}
    t0 = time.perf_counter()
    for run in ref["runs"]:
        r = IS3D.from_run_dir(run["run_dir"], overrides=run["overrides"],
                              device=device)
        res = r.run_particlization(write_files=False)
        one[run["name"]] = dict(spectra=res.spectra, dN_dX=res.dN_dX,
                                polarization=res.polarization)
        n_cells[run["name"]] = (r.cfg, r.surface.n_cells)
    grad_run = ref["grad_run"]
    grad_one = _mesh_grad(IS3D.from_run_dir(
        grad_run["run_dir"], overrides=grad_run["overrides"], device=device))
    print(f"[mesh] {smi} | one process: {len(one)} api.IS3D runs (their "
          f"trees the CLI's) and [grad main]'s gradient in "
          f"{time.perf_counter() - t0:.3f} s (beside the first spawns)")
    ref.update(one=one, n_cells=n_cells, grad_one=grad_one, slice_want={
        "main": one["main"]["spectra"],
        "dndx main": one["dndx main"]["dN_dX"]},
        events=(_mesh_events(MESH_EVENTS["path"], device=device)
                if MESH_EVENTS else None),
        sample=_sample_one(MESH_SAMPLE, device) if MESH_SAMPLE else None)
    if device == "cuda":
        torch.cuda.empty_cache()


def _spawn_start(device: str, W: int, backend: str, ref: dict) -> dict:
    """Start one spawn of MESH_STAGES, W ranks on ``device`` (index 0), in
    a thread of this process; its ranks' results (or the error) and its
    spawn-to-join wall land in the returned dict."""
    import threading
    from is3d_tpu_torch import testing
    spawn = dict(W=W, backend=backend)

    def run():
        t0 = time.perf_counter()
        try:
            spawn["ranks"] = testing.run_ranks(
                mesh_rank, W, os.path.join(WORK, f"mesh_w{W}"),
                args=(_mesh_runs(f"results_mesh_w{W}"), ref["slice_runs"],
                      ref["grad_run"] if W == 2 else None,
                      W == MESH_WRITE_W,
                      MESH_EVENTS.get("path") if W == 2 else None,
                      (MESH_SAMPLE or None) if W == 2 else None),
                backend=backend, device=f"{device}:0" if device == "cuda"
                else device, timeout=MESH_TIMEOUT,
                # torch's default threads, as this process: the host's
                # share of the prepare then has this process's bits
                threads=None)
        except Exception as err:
            spawn["error"] = err
        spawn["wall"] = time.perf_counter() - t0
    spawn["thread"] = threading.Thread(target=run, daemon=True)
    spawn["thread"].start()
    return spawn


def _spawn_check(smi: str, spawn: dict, ref: dict, beside=False):
    """Hold a joined spawn's ranks to ``ref``, phase_mesh's one-process
    results (``beside``: other spawns or [pod]'s CLI ranks shared the card
    and the host meanwhile)."""
    from is3d_tpu_torch.parallel.mesh import canonical_groups
    W, backend = spawn["W"], spawn["backend"]
    if "error" in spawn:
        fail(f"[mesh] W = {W} ({backend}): {spawn['error']}")
    runs, one, n_cells = ref["runs"], ref["one"], ref["n_cells"]
    grad_one, ranks, wall = ref["grad_one"], spawn["ranks"], spawn["wall"]
    write = W == MESH_WRITE_W
    for run in runs:
        name = run["name"]
        cfg, n = n_cells[name]
        G, _ = canonical_groups(cfg, n)
        per = -(-G // W)
        want = MESH_DIRS[name][2]
        for r, res in enumerate(ranks):
            got = res["runs"][name]
            own = min(G, (r + 1) * per) - min(G, r * per)
            for key in ("spectra", "dN_dX", "polarization"):
                if not _same(got[key], one[name][key]):
                    fail(f"[mesh] W = {W} rank {r} {name}: {key} "
                         "differs from the one-process run")
            _expect_counts(f"[mesh] W = {W} rank {r} {name}",
                           got["counts"], {k: own for k in want})
            if got["wrote"] != (r == 0 and write) or \
                    os.path.exists(f"{run['run_dir']}/results_mesh_w{W}"
                                   f"_rank{r}"):
                fail(f"[mesh] W = {W} rank {r} {name}: only rank 0 "
                     "writes the results tree")
        files = ""
        if write:
            a = _tree_bytes(os.path.join(run["run_dir"],
                                         "results_mesh_one"))
            b = _tree_bytes(os.path.join(run["run_dir"],
                                         f"results_mesh_w{W}"))
            if not a or a != b:
                fail(f"[mesh] W = {W} {name}: rank 0's results tree is "
                     f"not the one-process tree byte for byte ({len(a)} "
                     f"and {len(b)} files)")
            files = f", {len(a)} files byte-equal"
            shutil.rmtree(os.path.join(run["run_dir"],
                                       f"results_mesh_w{W}"))
        print(f"[mesh] {smi} | W = {W} {name}: every rank bit-equal"
              f"{files}, launches "
              + " / ".join(str(res["runs"][name]["counts"][want[0]])
                           for res in ranks) + f" of {G} groups")
    for name, want in ref["slice_want"].items():
        cfg, n = n_cells[name]
        G, _ = canonical_groups(cfg, n)
        per = -(-G // W)
        for r, res in enumerate(ranks):
            got = res["slices"][name]
            if not _same(got["result"], want):
                fail(f"[mesh] W = {W} rank {r} slice-local {name} "
                     "differs from the one-process run")
            own = min(G, (r + 1) * per) - min(G, r * per)
            _expect_counts(f"[mesh] W = {W} rank {r} slice-local {name}",
                           got["counts"],
                           {k: own for k in MESH_DIRS[name][2]})
    for r, res in enumerate(ranks):
        stats = {k: sum(x["stats"][k] for x in res["runs"].values())
                 for k in ("compute_s", "groups", "gathered_bytes",
                           "gather_fold_s")}
        print(_rank_line("mesh", smi, W, backend, r, stats,
                         sum(x["wall"] for x in res["runs"].values())))
        for name, got in res["slices"].items():
            print(_rank_line(f"mesh slice-local {name}", smi, W,
                             backend, r, got["stats"], got["wall"]))
    print(f"[mesh] {smi} | W = {W} ({backend}): spawn to join "
          f"{wall:.3f} s" + (" (beside other spawns or [pod]'s CLI ranks)"
                             if beside else "")
          + ", every rank bit-equal to one process")
    if W == 2:
        G, _ = canonical_groups(*n_cells["main"])
        per = -(-G // W)
        cts = [res["grad"]["cotangent"] for res in ranks]
        if not all(torch.equal(c, cts[0]) for c in cts):
            fail("[mesh grad] the ranks' cotangents differ")
        for r, res in enumerate(ranks):
            got = res["grad"]
            own = min(G, (r + 1) * per) - min(G, r * per)
            if not (torch.equal(got["value"], grad_one["value"])
                    and _same(got["grads"], grad_one["grads"])):
                fail(f"[mesh grad] rank {r}: the gradient differs from "
                     "the one-process gradient")
            _expect_counts(f"[mesh grad] rank {r}", got["counts"],
                           dict(smooth_spectra=own, spectra_bwd=own))
            print(_rank_line("mesh grad", smi, W, backend, r,
                             got["stats"], got["wall"])
                  + f" (one process {grad_one['wall']:.3f} s): gradient"
                  f" by {len(got['grads'])} fields bit-equal")
        if ref["events"] is not None:
            _check_mesh_events(smi, W, ranks, ref["events"])
        if ref["sample"] is not None:
            _check_mesh_sample(smi, W, ranks, ref["sample"])


def _check_mesh_events(smi: str, W: int, ranks: list, one: dict):
    """[mesh events]: every rank's rows and gradient bit-equal to one
    process's, and each rank's launches the one-process launches over
    W."""
    for name in ("spectra", "polzn", "grad"):
        want = one[name]
        launches = {k: v for k, v in want["counts"].items() if v}
        if not launches or any(v % W for v in launches.values()):
            fail(f"[mesh events] {name}: the one-process launches "
                 f"{launches} do not split into {W} equal shares")
        for r, res in enumerate(ranks):
            got = res["events"][name]
            if not _same(got["result"], want["result"]):
                fail(f"[mesh events] W = {W} rank {r} {name}: differs from "
                     "the one-process run")
            _expect_counts(f"[mesh events] W = {W} rank {r} {name}",
                           got["counts"],
                           {k: v // W for k, v in launches.items()})
            print(f"[mesh events] {smi} | W = {W} (gloo, every rank on one "
                  f"card) rank {r} {name}: wall {got['wall']:.3f} s (one "
                  f"process {want['wall']:.3f} s), launches "
                  + ", ".join(f"{k} {got['counts'][k]}" for k in launches)
                  + " (one process " + ", ".join(
                      f"{k} {v}" for k, v in launches.items())
                  + "), bit-equal")


def _sample_one(spec: dict, device) -> dict:
    """[mesh sample]'s one-process reference: _sample_cell_chunked of the
    kept surface with 65536 cells a chunk, and [main 2d]'s dN/dy."""
    from is3d_tpu_torch.api import IS3D
    from is3d_tpu_torch.kernels import sample
    run = IS3D.from_run_dir(spec["run_dir"], overrides=spec["overrides"],
                            device=device)
    run.read_fo_surf_from_file(write_averages=False)
    _, df_data, species, mcids, _ = run._prepare()
    cfg = sample.sampler_effective_cfg(run.surface, run.cfg)
    plan = sample._ChunkPlan(run.surface, species, df_data, cfg,
                             run.plasma(), None, -(-MAIN_CELLS // 2))
    info = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = _timed(lambda: sample._sample_cell_chunked(
            plan, mcids, info=info))
    dndy = _dndy_files(os.path.join(MESH_DIRS["main 2d"][0],
                                    "results_mesh_one"), (211, 321, 2212))
    return dict(out, info=info, mcids=np.asarray(mcids), y_cut=cfg.y_cut,
                dndy=dndy)


def _check_mesh_sample(smi: str, W: int, ranks: list, one: dict):
    """[mesh sample]: every rank's list byte-equal to the one-process
    chunked run, each rank's launches (K7b for its pre-pass and phase A,
    K7a three times, K7's packed mode once a batch and a rerun), and the
    pion, kaon and proton dN/dy within 5 sigma + 2 % of [main 2d]'s."""
    from is3d_tpu_torch import testing
    want = one["result"]
    for r, res in enumerate(ranks):
        got = res["sample"]
        if not testing.same_events(got["result"], want):
            fail(f"[mesh sample] W = {W} rank {r}: the events differ from "
                 "the one-process chunked run")
        info = got["info"]
        _expect_counts(f"[mesh sample] W = {W} rank {r}", got["counts"],
                       dict(species_yields=2, alias_tables=3,
                            sample_packed=info["batches"] + info["reruns"]))
        print(f"[mesh sample] {smi} | W = {W} (gloo, every rank on one "
              f"card) rank {r}: wall {got['wall']:.3f} s (one process "
              f"{one['wall']:.3f} s; phase A {info['timings']['phase_a']:.3f}"
              f", gather {info['timings']['gather']:.3f} s), launches "
              + ", ".join(f"{k} {v}" for k, v in got["counts"].items() if v)
              + f"; {len(got['result'])} events byte-equal")
    n_ev = len(want)
    n_sp = _species_counts(want, one["mcids"])
    lines = []
    for m, dndy in one["dndy"].items():
        n = int(n_sp[list(one["mcids"]).index(m)])
        got = n / (2.0 * one["y_cut"] * n_ev)
        sig = math.sqrt(max(n, 1)) / (2.0 * one["y_cut"] * n_ev)
        lines.append(f"{m} {got:.4f} against {dndy:.4f}")
        if abs(got - dndy) > 5.0 * sig + 0.02 * dndy:
            fail(f"[mesh sample] dN/dy of {m}: sampled {got:.5f}, "
                 f"operation 1 {dndy:.5f} (sigma {sig:.5f})")
    print(f"[mesh sample] {smi} | {n_ev} events, "
          f"{sum(len(e['mcid']) for e in want)} hadrons; dN/dy at y = 0 "
          f"against [main 2d]'s spectra: {'; '.join(lines)} (within 5 "
          "sigma + 2 %)")


def _pod_start() -> list:
    """Start [pod]: two CLI processes with the pod keys on 127.0.0.1
    (mesh_backend=gloo, both on this card) on [main]'s run directory
    (operation 1) and two on [sample decays]' (operation 2 with the event
    decays), the four at once, each logging to a file under WORK."""
    import socket
    import threading
    pods = dict(POD_DIRS)
    if "main" in MESH_DIRS:
        d, args, _ = MESH_DIRS["main"]
        pods["main"] = (d, args, "results_mesh_one")
    socks = [socket.socket() for _ in pods]
    for sock in socks:
        sock.bind(("127.0.0.1", 0))
    ports = [sock.getsockname()[1] for sock in socks]
    for sock in socks:
        sock.close()
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    started = []
    for (tag, (run_dir, args, one)), port in zip(pods.items(), ports):
        logs = [os.path.join(WORK, f"pod_{tag.replace(' ', '_')}_{i}.log")
                for i in range(2)]
        pod = dict(tag=tag, run_dir=run_dir, one=one, logs=logs,
                   t0=time.perf_counter(), procs=[], wall=None)
        started.append(pod)
        for i, log in enumerate(logs):
            with open(log, "w") as f:
                pod["procs"].append(subprocess.Popen(
                    [sys.executable, "-m", "is3d_tpu_torch", run_dir, *args,
                     "mesh_backend=gloo",
                     f"multihost_coordinator=127.0.0.1:{port}",
                     "multihost_nproc=2", f"multihost_pid={i}"], cwd=ROOT,
                    env=env, stdout=f, stderr=subprocess.STDOUT))

        def watch(pod=pod):
            for p in pod["procs"]:
                p.wait()
            pod["wall"] = time.perf_counter() - pod["t0"]
        pod["watch"] = threading.Thread(target=watch, daemon=True)
        pod["watch"].start()
    return started


def _pod_finish(smi: str, started: list):
    """Wait for [pod]'s CLI ranks (POD_TIMEOUT from their start): rank 0's
    results tree must be the one-process run's byte for byte."""
    for pod in started:
        pod["watch"].join(max(0.0, POD_TIMEOUT
                              - (time.perf_counter() - pod["t0"])))
        tag, run_dir, procs = pod["tag"], pod["run_dir"], pod["procs"]
        logs = [open(log).read() for log in pod["logs"]]
        if pod["wall"] is None or any(p.returncode for p in procs):
            fail(f"[pod] {tag}: the CLI ranks exited "
                 f"{[p.poll() for p in procs]} (None: still running after "
                 f"{POD_TIMEOUT} s):\n" + "\n".join(logs))
        a = _tree_bytes(os.path.join(run_dir, pod["one"]))
        b = _tree_bytes(os.path.join(run_dir, "results"))
        if not a or a != b:
            fail(f"[pod] {tag}: rank 0's results tree is not the "
                 f"one-process tree byte for byte ({len(a)} and {len(b)} "
                 "files)")
        done = [line for line in logs[0].splitlines()
                if line.startswith("done in")]
        print(f"[pod] {smi} | {tag}: 2 CLI ranks (gloo, both on one card, "
              "beside the other pair and [mesh]'s last stage): "
              f"spawn to exit {pod['wall']:.3f} s, rank 0 {done}; {len(a)} "
              f"files ({sum(map(len, a.values()))} B) byte-equal to one "
              "process")
        shutil.rmtree(os.path.join(run_dir, "results"), ignore_errors=True)


def _pod_stop(started: list):
    """Kill and reap any [pod] CLI rank still running."""
    for pod in started:
        for p in pod["procs"]:
            if p.poll() is None:
                p.kill()
            p.wait()


def main():
    smi, clock = phase_device()
    _clock("build")
    phase_build()
    _clock("small phases")
    phase_small_cases()
    phase_small_edges()
    phase_small_dndx()
    phase_small_dndx_edges()
    phase_small_bins()
    phase_small_experiments()
    phase_small_decay_edges()
    phase_small_grad()
    phase_small_grad_feqmod()
    phase_small_grad_vah()
    phase_small_feqmod()
    phase_small_vah()
    phase_small_polzn()
    phase_small_yields()
    phase_small_sample()
    phase_small_alias()
    phase_small_cascade()
    shutil.rmtree(WORK, ignore_errors=True)
    try:
        _clock("main")
        counts, run_dir, cfg, _ = phase_main_path(smi)
        phase_small_path_cpu_vs_cuda()
        rec_spectra = phase_pair(smi, clock, run_dir, cfg)
        rec_spectra["launches"] = counts["smooth_spectra"]
        rec_sbwd = phase_grad_pair(smi, clock, run_dir, cfg, "grad pair")
        rec_sbwd["launches"] = phase_grad_main(
            smi, run_dir, cfg, "grad main")["counts"]["spectra_bwd"]
        _keep("main", run_dir, MAIN_ARGS, ("smooth_spectra",))
        _clock("main 2d")
        counts, run_dir, cfg2d, _ = phase_main_path(
            smi, "main 2d", dimension=2, args=MAIN2D_ARGS, n_nodes=48,
            want=("smooth_spectra", "smooth_spectra_remap"))
        phase_small_path_cpu_vs_cuda(
            "small_2d", dimension=2, label="2+1D mT remap df2")
        rec_remap = phase_pair(smi, clock, run_dir, cfg2d, "remap pair",
                               plain_cells=1024)
        rec_remap["launches"] = counts["smooth_spectra_remap"]
        rec_rbwd = phase_grad_pair(smi, clock, run_dir, cfg2d,
                                   "grad pair 2d")
        rec_rbwd["launches"] = phase_grad_main(
            smi, run_dir, cfg2d, "grad main 2d")["counts"][
                "spectra_bwd_remap"]
        _keep("main 2d", run_dir, MAIN2D_ARGS,
              ("smooth_spectra", "smooth_spectra_remap"))
        _clock("trace")
        phase_trace(smi, run_dir, MAIN2D_ARGS, rec_remap["launches"])
        _clock("dndx main")
        counts, dndx_dir, dndx_cfg = phase_dndx_main(smi)
        phase_small_path_cpu_vs_cuda(
            "small_dndx", dimension=2, params=dict(operation=0),
            args=("df_mode=2", "regulate_deltaf=1"),
            label="2+1D operation 0 df2")
        rec_dndx, rec_bin = phase_dndx_pair(smi, clock, dndx_dir, dndx_cfg)
        rec_dndx["launches"] = counts["dndx"]
        rec_bin["launches"] = counts["dndx_bin"]
        _keep("dndx main", dndx_dir, DNDX_ARGS, ("dndx", "dndx_bin"))
        _clock("decays main")
        counts, run_dir, cfg, _ = phase_main_path(
            smi, "decays main", args=DECAYS_ARGS, decays=True)
        # 3+1D with 16 species (through the photon and omega, so 2- and
        # 3-body and a massless daughter): the CPU's plain 3-body waves on
        # the native 21-rapidity grid take 1.5 min at 17 species
        for dimension, n_species in ((2, 24), (3, 16)):
            phase_small_path_cpu_vs_cuda(
                f"small_decays_{dimension}d", dimension=dimension,
                label=f"{dimension}+1D df2 with decays",
                n_species=n_species, decays=True)
        rec_decays = phase_decays_pair(smi, clock, run_dir, cfg)
        for nbody in (2, 3):
            rec_decays[nbody]["launches"] = counts[f"decay_wave_{nbody}body"]
        rec_dbwd = phase_grad_decays(smi, clock, run_dir, cfg)
        phase_grad_feqmod_decays(smi, run_dir, cfg)
        shutil.rmtree(run_dir, ignore_errors=True)
        _clock("decays 2d")
        phase_decays_2d(smi, clock)
        _clock("ensemble batch")
        phase_ensemble_batch(smi)
        _clock("experiments")
        experiments = phase_experiments(smi, clock)
        _clock("feqmod")
        (rec_feqmod, rec_feqmod_remap, rec_feqmod_dndx, rec_qbwd,
         rec_qbwd_remap) = phase_feqmod(smi, clock)
        _clock("vah")
        (rec_vah, rec_vah_remap, rec_vah_dndx, vah_dir, vah_dndy, rec_vbwd,
         rec_vbwd_remap) = phase_vah(smi, clock)
        _clock("polzn")
        rec_polzn, rec_polzn_remap, rec_pbwd, rec_pbwd_remap = phase_polzn(
            smi, clock)
        _clock("sample")
        (rec_k7, rec_k7a, rec_k8, rec_yields, rec_yields_vah, rec_k7_vah,
         rec_k7_search) = phase_sample(smi, clock, vah_dir, vah_dndy)
        _clock("mesh")
        phase_mesh(smi)
        # the cpu halves of the small runs finish behind [mesh]
        _clock("cpu runs")
        phase_cpu_runs()
        _clock("done")
    finally:
        _stop_cpu_runs()
        shutil.rmtree(WORK, ignore_errors=True)
    src = "is3d_tpu_torch/csrc/"
    kernels = [
        dict(name="smooth_spectra", route="cuda",
             source=src + "smooth_spectra.cu",
             replaces="is3d_tpu/kernels/pallas_smooth.py:61", **rec_spectra),
        dict(name="smooth_spectra_remap", route="cuda",
             source=src + "smooth_spectra.cu",
             replaces="is3d_tpu/kernels/smooth.py:161", **rec_remap),
        dict(name="dndx", route="cuda", source=src + "dndx.cu",
             replaces="is3d_tpu/kernels/dndx.py:66", **rec_dndx),
        dict(name="dndx_bin", route="cuda", source=src + "dndx.cu",
             replaces="is3d_tpu/kernels/dndx.py:141", **rec_bin),
        dict(name="dndx_probe", route="cuda", source=src + "dndx.cu",
             replaces="experiments/probe_dndx_reduce.py:137",
             **experiments["dndx_probe"]),
        dict(name="smooth_proto", route="cuda", source=src + "smooth_proto.cu",
             replaces="experiments/pallas_smooth_proto.py:36",
             **experiments["smooth_proto"]),
        dict(name="decay_wave_2body", route="cuda", source=src + "decays.cu",
             replaces="is3d_tpu/kernels/decays.py:583", **rec_decays[2]),
        dict(name="decay_wave_3body", route="cuda", source=src + "decays.cu",
             replaces="is3d_tpu/kernels/decays.py:600", **rec_decays[3]),
        dict(name="feqmod_spectra", route="cuda", source=src + "feqmod.cu",
             replaces="is3d_tpu/kernels/feqmod.py:276", **rec_feqmod),
        dict(name="feqmod_spectra_remap", route="cuda",
             source=src + "feqmod.cu",
             replaces="is3d_tpu/kernels/feqmod.py:276", **rec_feqmod_remap),
        dict(name="dndx_feqmod", route="cuda", source=src + "dndx.cu",
             replaces="is3d_tpu/kernels/dndx.py:110", **rec_feqmod_dndx),
        dict(name="vah_spectra", route="cuda", source=src + "vah.cu",
             replaces="is3d_tpu/kernels/vah.py:51", **rec_vah),
        dict(name="vah_spectra_remap", route="cuda", source=src + "vah.cu",
             replaces="is3d_tpu/kernels/vah.py:51", **rec_vah_remap),
        dict(name="dndx_vah", route="cuda", source=src + "dndx.cu",
             replaces="is3d_tpu/kernels/dndx.py:102", **rec_vah_dndx),
        dict(name="polzn", route="cuda", source=src + "polzn.cu",
             replaces="is3d_tpu/kernels/polzn.py:42", **rec_polzn),
        dict(name="polzn_remap", route="cuda", source=src + "polzn.cu",
             replaces="is3d_tpu/kernels/polzn.py:42", **rec_polzn_remap),
        dict(name="sample_events", route="cuda", source=src + "sample.cu",
             replaces="is3d_tpu/kernels/sample.py:1099", **rec_k7),
        dict(name="alias_tables", route="cuda", source=src + "sample.cu",
             replaces="is3d_tpu/kernels/sample.py:92", **rec_k7a),
        dict(name="mc_cascade", route="cuda", source=src + "mc_decays.cu",
             replaces="is3d_tpu/kernels/mc_decays.py:242", **rec_k8),
        dict(name="species_yields", route="cuda", source=src + "yields.cu",
             replaces="is3d_tpu/kernels/sample.py:278", **rec_yields),
        dict(name="species_yields_vah", route="cuda",
             source=src + "yields.cu",
             replaces="is3d_tpu/kernels/sample.py:484", **rec_yields_vah),
        dict(name="sample_events_vah", route="cuda",
             source=src + "sample_vah.cu",
             replaces="is3d_tpu/kernels/sample.py:889", **rec_k7_vah),
        dict(name="sample_events_search", route="cuda",
             source=src + "sample_search.cu",
             replaces="is3d_tpu/kernels/sample.py:712", **rec_k7_search),
        dict(name="spectra_bwd", route="cuda",
             source=src + "smooth_spectra_bwd.cu",
             replaces="is3d_tpu/kernels/smooth.py:426", **rec_sbwd),
        dict(name="spectra_bwd_remap", route="cuda",
             source=src + "smooth_spectra_bwd.cu",
             replaces="is3d_tpu/kernels/smooth.py:161", **rec_rbwd),
        dict(name="decay_wave_bwd_2body", route="cuda",
             source=src + "decays_bwd.cu",
             replaces="is3d_tpu/kernels/decays.py:281", **rec_dbwd[2]),
        dict(name="decay_wave_bwd_3body", route="cuda",
             source=src + "decays_bwd.cu",
             replaces="is3d_tpu/kernels/decays.py:350", **rec_dbwd[3]),
        dict(name="feqmod_bwd", route="cuda", source=src + "feqmod_bwd.cu",
             replaces="is3d_tpu/kernels/feqmod.py:276", **rec_qbwd),
        dict(name="feqmod_bwd_remap", route="cuda",
             source=src + "feqmod_bwd.cu",
             replaces="is3d_tpu/kernels/feqmod.py:464", **rec_qbwd_remap),
        dict(name="vah_bwd", route="cuda", source=src + "vah_bwd.cu",
             replaces="is3d_tpu/kernels/vah.py:51", **rec_vbwd),
        dict(name="vah_bwd_remap", route="cuda", source=src + "vah_bwd.cu",
             replaces="is3d_tpu/kernels/vah.py:199", **rec_vbwd_remap),
        dict(name="polzn_bwd", route="cuda", source=src + "polzn_bwd.cu",
             replaces="is3d_tpu/kernels/polzn.py:42", **rec_pbwd),
        dict(name="polzn_bwd_remap", route="cuda",
             source=src + "polzn_bwd.cu",
             replaces="is3d_tpu/kernels/polzn.py:73", **rec_pbwd_remap),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
