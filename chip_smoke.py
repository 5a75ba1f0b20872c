#!/usr/bin/env python3
"""Smoke run of is3d_tpu_torch on one CUDA card.

Usage (from the repository root; needs one GPU, nvcc and g++)::

    python3 chip_smoke.py

Phases, each printing its own line(s):

1. device: the card's name, power limit and maximum SM clock
   (nvidia-smi); fails without CUDA;
2. build: every kernel source (csrc/smooth_spectra.cu, csrc/dndx.cu,
   csrc/smooth_proto.cu; one nvcc each, all started together) and the
   fastio host library, from this checkout's sources, with ptxas's
   register and spill lines;
3. each kernel against its plain torch version at small shapes, in f32
   (atol 2e-5 * max, rtol 2e-4) and f64 (rtol 1e-10, atol 1e-13 * max):
   the spectra kernel on every path (3+1D df 1/2, 2+1D fixed nodes, 2+1D
   mT remap; regulate/outflow off and on; one baryon + diffusion case
   each); the dN/dX kernel and its binning kernel (777 cells, 40 species;
   2+1D and 3+1D, df 1/2, regulate/outflow off and on, baryon + diffusion);
   the spectra prototype and the reduction probe;
4. operation 1 main path: a synthetic 131072-cell x 320-species 3+1D
   mode-1 run directory through ``is3d_tpu_torch.cli.main`` (df 2, shear +
   bulk, regulate, outflow, f32, native 32 x 24 x 21 grid), then the same
   CLI on a 256-cell run directory on cuda and on cpu (f64), whose spectra
   files must agree;
5. the spectra kernel against the plain version on one canonical group of
   that surface (16384 cells), f32: agreement, then paired times (CUDA
   events, one warm-up, median of 5);
6. operation 0 main path: a synthetic 65536-cell x 320-species 2+1D run
   directory through ``cli.main`` (df 1, shear + bulk, regulate, outflow,
   f32, native 32 x 24 x 48 grid): launches = canonical groups, every
   spacetime_distribution file present and finite, pion dN/dy > 0; then
   the same CLI on a 256-cell run directory on cuda and on cpu (f64);
7. the dN/dX kernel and the binning kernel on one canonical group of that
   surface (8192 cells), f32: agreement with the plain versions, two
   launches bit-identical, paired times (one warm-up -- for the plain
   version its agreement call -- and the median of 5);
8. the experiments at their own shapes, each through its ``measure()``:
   the spectra prototype (32768 cells x 320 x 768 x 21; its plain version
   on the first 1024 cells) and the reduction probe (176 x 48 x 320 x 768).

Before every path (4, 6, 8) all launch counts are set to 0 and they are
read right after it.  The line before the last is the kernel record as
JSON; the last line is ``{"ok": true, "device": {...}}``.  Any failed phase
exits nonzero before that line is printed.
"""

from __future__ import annotations

import contextlib
import io
import json
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
DNDX_CELLS = 65536
DNDX_ARGS = ["device=cuda", "precision=f32", "operation=0", "dimension=2",
             "df_mode=1", "include_shear_deltaf=1", "include_bulk_deltaf=1",
             "regulate_deltaf=1", "outflow=1"]
KERNEL_SOURCES = ("smooth_spectra", "dndx", "smooth_proto")
# H100 SXM: SMs, FP32 and SFU lanes per SM, memory rate (bytes/s)
N_SM, FP32_LANES, SFU_LANES, HBM_RATE = 132, 128, 16, 3.35e12


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


def phase_main_path(smi: str):
    from is3d_tpu_torch.config import load_config
    from is3d_tpu_torch.kernels import smooth
    from is3d_tpu_torch.parallel.mesh import canonical_groups
    from is3d_tpu_torch.io.pdg import load_chosen_mcids
    from is3d_tpu_torch.testing import write_synthetic_run_dir

    run_dir = os.path.join(WORK, "main")
    t0 = time.perf_counter()
    write_synthetic_run_dir(run_dir, MAIN_CELLS, MAIN_SPECIES, dimension=3,
                            seed=0)
    print(f"[main] synthetic run dir {MAIN_CELLS} cells x {MAIN_SPECIES} "
          f"species written in {time.perf_counter() - t0:.2f} s")

    smooth.LAUNCHES = 0
    t0 = time.perf_counter()
    rc, phases, out = _run_cli([run_dir] + MAIN_ARGS)
    wall = time.perf_counter() - t0
    launches = smooth.LAUNCHES
    # the CLI's output without its config echo ("  key = value")
    print("\n".join("[main] cli: " + l for l in out.splitlines()
                    if " = " not in l))
    if rc != 0:
        fail(f"cli exited {rc}")
    cfg = load_config(os.path.join(run_dir, "iS3D_parameters.dat"),
                      overrides=dict(a.split("=", 1) for a in MAIN_ARGS[1:]))
    groups, _ = canonical_groups(cfg, MAIN_CELLS)
    if launches != groups:
        fail(f"{launches} kernel launches on the main path, expected one per "
             f"canonical group ({groups})")
    mcids = load_chosen_mcids(os.path.join(
        run_dir, "PDG", "chosen_particles_urqmd_v3.3+.dat"))
    if len(mcids) != MAIN_SPECIES:
        fail(f"{len(mcids)} chosen species")
    _results_ok(os.path.join(run_dir, "results"), mcids, n_y=21)
    evals = MAIN_CELLS * MAIN_SPECIES * 32 * 24 * 21
    t_spec = phases["smooth spectra"]
    print(f"[main] {smi} | prepare {phases['prepare (io, pdg, deltaf)']:.3f} s"
          f", spectra {t_spec:.3f} s, writers {phases['writers']:.3f} s, "
          f"cli wall {wall:.3f} s | {evals:.3e} evaluations, "
          f"{evals / t_spec:.3e} evaluations/s | launches {launches} = "
          f"groups {groups}")
    return launches, run_dir, cfg, phases


def phase_small_path_cpu_vs_cuda(name="small", dimension=3, params=None,
                                 args=("df_mode=2", "regulate_deltaf=1"),
                                 label="3+1D df2"):
    """The whole CLI path on cuda and on cpu, f64, on a small run dir."""
    from is3d_tpu_torch.testing import write_synthetic_run_dir
    run_dir = os.path.join(WORK, name)
    write_synthetic_run_dir(run_dir, 256, 11, dimension=dimension, seed=1,
                            params=params)
    trees = {}
    for device in ("cuda", "cpu"):
        results = os.path.join(run_dir, f"results_{device}")
        rc, _, _ = _run_cli([run_dir, f"device={device}", "precision=f64",
                             *args])
        if rc != 0:
            fail(f"{name} run on {device} exited {rc}")
        shutil.move(os.path.join(run_dir, "results"), results)
        trees[device] = results
    n_files = worst = 0
    for d, _, files in os.walk(trees["cpu"]):
        for f in files:
            a = os.path.join(d, f)
            va, vb = _values(a), _values(a.replace(trees["cpu"],
                                                   trees["cuda"]))
            err = np.abs(va - vb)
            if va.shape != vb.shape or (
                    err > 1e-6 * np.abs(va) + 1e-6 * np.abs(va).max()).any():
                fail(f"{name} run: {os.path.relpath(a, trees['cpu'])} "
                     "differs between cuda and cpu beyond 1e-6")
            worst = max(worst, float(err.max() / np.abs(va).max()))
            n_files += 1
    print(f"[{name} path] 256 cells x 11 species {label} f64: {n_files} "
          f"result files agree between cuda and cpu (max difference "
          f"{worst:.2e} of each file's largest value)")
    if n_files == 0:
        fail(f"{name} run wrote no result files")


def _values(path):
    """The numbers of a results file (header words skipped)."""
    vals = []
    for tok in open(path).read().split():
        try:
            vals.append(float(tok))
        except ValueError:
            pass
    return np.asarray(vals)


def phase_pair(smi: str, run_dir: str, cfg):
    from is3d_tpu_torch.api import IS3D
    from is3d_tpu_torch.utils import cuda_median_ms
    from is3d_tpu_torch.kernels.common import surface_columns, prepare_cells
    from is3d_tpu_torch.kernels.smooth import (
        pack_cells, momentum_constants, spectra_flags, smooth_spectra_cuda,
        smooth_spectra_plain)
    from is3d_tpu_torch.parallel.mesh import canonical_groups

    run = IS3D(cfg, data_dir=run_dir, device="cuda")
    df_data, species, _, grid = run._prepare()
    cols = surface_columns(run.surface, cfg)
    _, gs = canonical_groups(cfg, run.surface.n_cells)
    group = {k: v[:gs] for k, v in cols.items()}
    cells = pack_cells(prepare_cells(group, cfg, df_data), cfg)
    mom = momentum_constants(species, grid, cfg.dimension)
    flags = spectra_flags(cfg, grid)
    kern = lambda: smooth_spectra_cuda(cells, mom, flags)
    plain = lambda: smooth_spectra_plain(cells, mom, flags, cfg.cell_chunk)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    max_err = _check(f"float32 main-path group ({tuple(cells.shape)} cells, "
                     f"{tuple(got.shape)} out)", got, want, 2e-4, 2e-5)
    kern()
    plain()
    torch.cuda.synchronize()
    k_ms, k_all = cuda_median_ms(kern)
    p_ms, p_all = cuda_median_ms(plain)
    evals = cells.shape[0] * got.numel()
    print(f"[pair] {smi} | one group {cells.shape[0]} cells x "
          f"{tuple(got.shape)}: kernel {k_ms:.3f} ms (runs "
          f"{', '.join(f'{t:.2f}' for t in k_all)}), plain {p_ms:.3f} ms "
          f"(runs {', '.join(f'{t:.1f}' for t in p_all)}), "
          f"kernel {evals / k_ms * 1e3:.3e} evaluations/s, "
          f"plain/kernel {p_ms / k_ms:.2f}")
    return max_err, k_ms, p_ms, evals, _nbytes(cells, got, *mom_tensors(mom))


def _modules():
    from is3d_tpu_torch.kernels import smooth, dndx
    from is3d_tpu_torch.experiments import smooth_proto, dndx_reduce_probe
    return smooth, dndx, smooth_proto, dndx_reduce_probe


def _reset_counts():
    smooth, dndx, proto, probe = _modules()
    smooth.LAUNCHES = dndx.LAUNCHES = dndx.BIN_LAUNCHES = 0
    proto.LAUNCHES = probe.LAUNCHES = 0


def _counts() -> dict:
    smooth, dndx, proto, probe = _modules()
    return dict(smooth_spectra=smooth.LAUNCHES, dndx=dndx.LAUNCHES,
                dndx_bin=dndx.BIN_LAUNCHES, smooth_proto=proto.LAUNCHES,
                dndx_probe=probe.LAUNCHES)


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
            mom.py, mom.nodes, mom.weights)


def _bound(evals: float, fp32: float, sfu: float, nbytes: float,
           clock: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the FP32 and SFU instructions over their
    issue rates at the maximum SM clock."""
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
        got = proto.proto_spectra_cuda(*(x[n] for n in proto.ARGS))
        want = proto.proto_spectra_plain(*(x[n] for n in proto.ARGS))
        torch.cuda.synchronize()
        _check(f"smooth_proto {str(dtype)[6:]} 50 cells x 64 x 24 x 5", got,
               want, *TOL[dtype])
        x = probe.probe_inputs(37, 7, 20, 50, seed=4, dtype=dtype,
                               device="cuda")
        args = (x["a"], x["b"], x["w"], x["wM"], x["wR"])
        got = probe.percell_probe_cuda(*args)
        want = probe.percell_probe_plain(*args)
        torch.cuda.synchronize()
        for part, g, w in zip(("per cell", "per node"), got, want):
            _check(f"dndx_probe {str(dtype)[6:]} 37 x 7 x 20 x 50 {part}", g,
                   w, *TOL[dtype])


def phase_dndx_main(smi: str):
    from is3d_tpu_torch.config import load_config
    from is3d_tpu_torch.io.pdg import load_chosen_mcids
    from is3d_tpu_torch.io.tables import native_momentum_grid
    from is3d_tpu_torch.parallel.mesh import canonical_groups
    from is3d_tpu_torch.testing import write_synthetic_run_dir

    run_dir = os.path.join(WORK, "dndx")
    t0 = time.perf_counter()
    write_synthetic_run_dir(run_dir, DNDX_CELLS, MAIN_SPECIES, dimension=2,
                            seed=2, params=dict(operation=0))
    print(f"[dndx main] synthetic run dir {DNDX_CELLS} cells x "
          f"{MAIN_SPECIES} species written in "
          f"{time.perf_counter() - t0:.2f} s")
    _reset_counts()
    t0 = time.perf_counter()
    rc, phases, out = _run_cli([run_dir] + DNDX_ARGS)
    wall = time.perf_counter() - t0
    counts = _counts()
    print("\n".join("[dndx main] cli: " + l for l in out.splitlines()
                    if " = " not in l))
    if rc != 0:
        fail(f"dN/dX cli exited {rc}")
    cfg = load_config(os.path.join(run_dir, "iS3D_parameters.dat"),
                      overrides=dict(a.split("=", 1) for a in DNDX_ARGS[1:]))
    groups, _ = canonical_groups(cfg, DNDX_CELLS)
    _expect_counts("dN/dX main path", counts,
                   dict(dndx=groups, dndx_bin=groups))
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
    evals = DNDX_CELLS * MAIN_SPECIES * 32 * 24 * grid.n_eta
    t_dx = phases["dN/dX spacetime"]
    print(f"[dndx main] {smi} | prepare "
          f"{phases['prepare (io, pdg, deltaf)']:.3f} s, dN/dX {t_dx:.3f} s, "
          f"writers {phases['writers']:.3f} s, cli wall {wall:.3f} s | "
          f"{evals:.3e} evaluations, {evals / t_dx:.3e} evaluations/s | "
          f"launches dndx {counts['dndx']}, dndx_bin {counts['dndx_bin']} "
          f"= groups {groups} | {n_files} files, pion dN/dy {dndy:.6e}")
    return counts, run_dir, cfg


def phase_dndx_pair(smi: str, clock: float, run_dir: str, cfg):
    from is3d_tpu_torch.api import IS3D
    from is3d_tpu_torch.utils import cuda_median_ms
    from is3d_tpu_torch.kernels import dndx
    from is3d_tpu_torch.parallel.mesh import canonical_groups

    run = IS3D(cfg, data_dir=run_dir, device="cuda")
    df_data, species, _, grid = run._prepare()
    _, gs = canonical_groups(cfg, run.surface.n_cells)
    cells, mom, flags, wM, wR, plan = _dndx_group_inputs(
        run.surface, species, grid, df_data, cfg, gs)
    kern = lambda: dndx.dndx_cuda(cells, mom, flags, wM, wR)
    plain = lambda: dndx.dndx_plain(cells, mom, flags, wM, wR,
                                    cfg.cell_chunk)
    got, again, want = kern(), kern(), plain()
    torch.cuda.synchronize()
    if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
        fail("dndx: two launches on the same group differ")
    S, R = got[1].shape
    shape = f"{cells.shape[0]} cells x {S} x {wM.shape[0]} x {R}"
    err = max(_check(f"dndx float32 main-path group ({shape}) per cell",
                     got[0], want[0], 2e-4, 2e-5),
              _check(f"dndx float32 main-path group dN/dy/deta", got[1],
                     want[1], 2e-4, 2e-5))
    k_ms, k_all = cuda_median_ms(kern)
    p_ms, p_all = cuda_median_ms(plain)
    evals = cells.shape[0] * S * wM.shape[0] * R
    bound = _bound(evals, dndx.FP32_PER_EVAL[cfg.df_mode],
                   dndx.SFU_PER_EVAL[cfg.df_mode],
                   _nbytes(cells, wM, wR, *got, *mom_tensors(mom)), clock)
    print(f"[dndx pair] {smi} | one group {shape}: kernel {k_ms:.3f} ms "
          f"(runs {', '.join(f'{t:.2f}' for t in k_all)}), plain "
          f"{p_ms:.3f} ms (runs {', '.join(f'{t:.1f}' for t in p_all)}), "
          f"kernel {evals / k_ms * 1e3:.3e} evaluations/s, plain/kernel "
          f"{p_ms / k_ms:.2f}, bound {bound[0]:.3f} ms ({bound[1]}); two "
          "launches bit-identical")
    rec_dndx = dict(launches=None, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                    bound_ms=bound[0], bound_by=bound[1], library_ms=None)

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
    b_ms, b_all = cuda_median_ms(bkern)
    bp_ms, _ = cuda_median_ms(bplain)
    bl_ms, _ = cuda_median_ms(blib)
    bbound = _bound(plan.key.shape[0] * S, 1, 0,
                    _nbytes(per_cell, plan.cell, plan.start, hist), clock)
    print(f"[bin pair] {smi} | one group: kernel {b_ms:.4f} ms (runs "
          f"{', '.join(f'{t:.4f}' for t in b_all)}), plain {bp_ms:.4f} ms, "
          f"torch.sparse.mm {bl_ms:.4f} ms, bound {bbound[0]:.4f} ms "
          f"({bbound[1]}); two launches bit-identical")
    rec_bin = dict(launches=None, max_abs_err=berr, ms=b_ms, plain_ms=bp_ms,
                   bound_ms=bbound[0], bound_by=bbound[1], library_ms=bl_ms)
    return rec_dndx, rec_bin


def phase_experiments(smi: str, clock: float):
    """Each experiment at its own shape through its measure(): the counts
    are set to 0 before it and read after it."""
    _, _, proto, probe = _modules()
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
        bound = _bound(r["evaluations"], mod.FP32_PER_EVAL, mod.SFU_PER_EVAL,
                       r["bytes"], clock)
        print(f"[{name}] {smi} | {r['label']}: kernel {r['ms']:.3f} ms "
              f"(runs {', '.join(f'{t:.3f}' for t in r['runs'])}), "
              f"{r['evaluations'] / r['ms'] * 1e3:.3e} evaluations/s; plain "
              f"{r['plain_ms']:.3f} ms ({r['plain_label']}); bound "
              f"{bound[0]:.3f} ms ({bound[1]}); launches {r['launches']}")
        records[name] = dict(launches=r["launches"], max_abs_err=err,
                             ms=r["ms"], plain_ms=r["plain_ms"],
                             bound_ms=bound[0], bound_by=bound[1],
                             library_ms=None)
    return records


def main():
    smi, clock = phase_device()
    phase_build()
    phase_small_cases()
    phase_small_dndx()
    phase_small_experiments()
    shutil.rmtree(WORK, ignore_errors=True)
    try:
        _reset_counts()
        launches, run_dir, cfg, _ = phase_main_path(smi)
        _expect_counts("spectra main path", _counts(),
                       dict(smooth_spectra=launches))
        phase_small_path_cpu_vs_cuda()
        max_err, k_ms, p_ms, evals, moved = phase_pair(smi, run_dir, cfg)
        smooth, dndx, _, _ = _modules()
        bound = _bound(evals, smooth.FP32_PER_EVAL[cfg.df_mode],
                       smooth.SFU_PER_EVAL[cfg.df_mode], moved, clock)
        print(f"[pair] bound of one group {bound[0]:.3f} ms ({bound[1]}): "
              f"kernel at {bound[0] / k_ms:.1%} of it")
        shutil.rmtree(run_dir, ignore_errors=True)
        counts, dndx_dir, dndx_cfg = phase_dndx_main(smi)
        phase_small_path_cpu_vs_cuda(
            "small_dndx", dimension=2, params=dict(operation=0),
            args=("df_mode=2", "regulate_deltaf=1"),
            label="2+1D operation 0 df2")
        rec_dndx, rec_bin = phase_dndx_pair(smi, clock, dndx_dir, dndx_cfg)
        rec_dndx["launches"] = counts["dndx"]
        rec_bin["launches"] = counts["dndx_bin"]
        experiments = phase_experiments(smi, clock)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    src = "is3d_tpu_torch/csrc/"
    kernels = [
        dict(name="smooth_spectra", route="cuda",
             source=src + "smooth_spectra.cu",
             replaces="is3d_tpu/kernels/pallas_smooth.py:61",
             launches=launches, max_abs_err=max_err, ms=k_ms, plain_ms=p_ms,
             bound_ms=bound[0], bound_by=bound[1], library_ms=None),
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
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
