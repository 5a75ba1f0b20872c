#!/usr/bin/env python3
"""Smoke run of is3d_tpu_torch on one CUDA card.

Usage (from the repository root; needs one GPU, nvcc and g++)::

    python3 chip_smoke.py

Phases, each printing its own line(s):

1. device: the card's name and power limit (nvidia-smi); fails without CUDA;
2. build: the spectra kernel (csrc/smooth_spectra.cu, nvcc) and the fastio
   host library, from this checkout's sources;
3. kernel against its plain torch version at small shapes, every kernel
   path (3+1D df 1/2, 2+1D fixed nodes, 2+1D mT remap; regulate/outflow
   off and on; one baryon + diffusion case each), in f32 (atol 2e-5 * max,
   rtol 2e-4) and f64 (rtol 1e-10, atol 1e-13 * max);
4. main path: a synthetic 131072-cell x 320-species 3+1D mode-1 run
   directory through ``is3d_tpu_torch.cli.main`` (df 2, shear + bulk,
   regulate, outflow, f32, native 32 x 24 x 21 grid), then the same CLI
   on a 256-cell run directory on cuda and on cpu (f64), whose spectra
   files must agree;
5. the kernel against the plain version on one canonical group of the
   main path's surface (16384 cells), f32: agreement, then paired times
   (CUDA events, one warm-up, median of 5).

The line before the last is the kernel record as JSON; the last line is
``{"ok": true, "device": {...}}``.  Any failed phase exits nonzero before
that line is printed.
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


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def phase_device() -> str:
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
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    return smi


def phase_build():
    from is3d_tpu_torch.native import build
    t0 = time.perf_counter()
    build.cuda_library("smooth_spectra")
    t_cuda = time.perf_counter() - t0
    t0 = time.perf_counter()
    if build.get_fastio() is None:
        fail("fastio did not build (g++ missing or failing)")
    t_fastio = time.perf_counter() - t0
    for line in build.CUDA_BUILD_LOGS.get("smooth_spectra", "").splitlines():
        if ("registers" in line or "spill" in line
                or "Compiling entry function" in line):
            print(f"[build] ptxas: {line.strip()}")
    print(f"[build] smooth_spectra.cu (nvcc) {t_cuda:.2f} s, fastio.cpp "
          f"(g++) {t_fastio:.2f} s")


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


def phase_small_path_cpu_vs_cuda():
    """The whole CLI path on cuda and on cpu, f64, on a small run dir."""
    from is3d_tpu_torch.testing import write_synthetic_run_dir
    run_dir = os.path.join(WORK, "small")
    write_synthetic_run_dir(run_dir, 256, 11, dimension=3, seed=1)
    trees = {}
    for device in ("cuda", "cpu"):
        results = os.path.join(run_dir, f"results_{device}")
        rc, _, _ = _run_cli([run_dir, f"device={device}", "precision=f64",
                             "df_mode=2", "regulate_deltaf=1"])
        if rc != 0:
            fail(f"small run on {device} exited {rc}")
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
                fail(f"small run: {os.path.relpath(a, trees['cpu'])} differs "
                     "between cuda and cpu beyond 1e-6")
            worst = max(worst, float(err.max() / np.abs(va).max()))
            n_files += 1
    print(f"[small path] 256 cells x 11 species 3+1D df2 f64: {n_files} "
          f"result files agree between cuda and cpu (max difference "
          f"{worst:.2e} of each file's largest value)")


def _values(path):
    """The numbers of a results file (header words skipped)."""
    vals = []
    for tok in open(path).read().split():
        try:
            vals.append(float(tok))
        except ValueError:
            pass
    return np.asarray(vals)


def _median_ms(fn, n=5):
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times)), times


def phase_pair(smi: str, run_dir: str, cfg):
    from is3d_tpu_torch.api import IS3D
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
    k_ms, k_all = _median_ms(kern)
    p_ms, p_all = _median_ms(plain)
    evals = cells.shape[0] * got.numel()
    print(f"[pair] {smi} | one group {cells.shape[0]} cells x "
          f"{tuple(got.shape)}: kernel {k_ms:.3f} ms (runs "
          f"{', '.join(f'{t:.2f}' for t in k_all)}), plain {p_ms:.3f} ms "
          f"(runs {', '.join(f'{t:.1f}' for t in p_all)}), "
          f"kernel {evals / k_ms * 1e3:.3e} evaluations/s, "
          f"plain/kernel {p_ms / k_ms:.2f}")
    return max_err, k_ms, p_ms


def main():
    smi = phase_device()
    phase_build()
    phase_small_cases()
    shutil.rmtree(WORK, ignore_errors=True)
    try:
        launches, run_dir, cfg, _ = phase_main_path(smi)
        phase_small_path_cpu_vs_cuda()
        max_err, k_ms, p_ms = phase_pair(smi, run_dir, cfg)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"kernels": [{
        "name": "smooth_spectra",
        "route": "cuda",
        "source": "is3d_tpu_torch/csrc/smooth_spectra.cu",
        "replaces": "is3d_tpu/kernels/pallas_smooth.py:61",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
