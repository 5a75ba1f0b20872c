"""Ensemble / oversampling drivers (port of is3d_tpu/ensemble.py).

The reference scales out by processes: oversample.sh reruns the binary N
times into oversampling/results_i, and run_multithread_sampling_iS3D.py
spawns sandboxed worker processes.  One process of the port's sampler
fills a card (its events are batched on the device), so these drivers
reproduce the reference's output layouts and add deterministic seeds:

* ``oversample_run``: sample a target hadron count in event batches and
  write each batch to results_<i>/ (oversample.sh layout), checkpointed
  through a manifest (same keys and layout as is3d_tpu's) so that an
  interrupted run resumes from the next incomplete batch;
* ``ensemble_seeds``: independent, collision-free seeds, one a batch;
* ``multiprocess_oversample``: worker processes (``python -m
  is3d_tpu_torch.ensemble_worker``) over disjoint batches of one plan,
  their manifests merged by ``merge_manifests``.  The CUDA libraries are
  built once in the parent before any worker starts (is3d_tpu staggers
  its workers' cold start for its compile cache instead).

A worker of several devices (``mesh_devices=N``: N ranks, one card each,
NCCL; ``host_devices=N``: N CPU ranks over gloo) is a group of N
processes with its own rendezvous under out_dir, whose CellMesh
``oversample_run(mesh=)`` samples each batch over (the cell-sharded
sampler, kernels.sample.sample_particles_sharded); rank 0 writes.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

from . import writers
from .kernels.sample import calculate_total_yield, sample_particles

# the CUDA sources a worker's sampler can launch (built once by the parent)
CUDA_SOURCES = ("sample", "sample_vah", "sample_search", "sample_vah_search",
                "yields", "mc_decays")


def ensemble_seeds(base_seed: int, n_workers: int) -> list:
    """Independent per-batch seeds by numpy's SeedSequence spawning, 63
    bits each: a 31-bit reduction would give a ~2e-4 chance of a colliding
    pair over a 1000-batch plan, and a colliding pair of batches would be
    byte-identical, double-counted streams."""
    ss = np.random.SeedSequence(base_seed)
    return [int(child.generate_state(2, dtype=np.uint64)[0] % (2**63))
            for child in ss.spawn(n_workers)]


def _write_manifest(path: str, manifest: dict):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, path)          # atomic on POSIX


def _batch_plan(n_events_needed: int, events_per_batch: int,
                max_batches: int) -> list:
    """The events of each batch: a function of the three numbers alone, so
    a resumed run, and every worker, derive the same plan."""
    plan, left = [], n_events_needed
    while left > 0 and len(plan) < max_batches:
        plan.append(min(events_per_batch, left))
        left -= plan[-1]
    return plan


def oversample_run(surface, species, mcids, df_data, cfg, plasma,
                   out_dir: str = "oversampling", events_per_batch: int = 100,
                   base_seed: int = 0, max_batches: int = 1000,
                   resume: bool = True, worker_id: int = 0,
                   n_workers: int = 1, mesh=None, particle_table=None):
    """Sample until cfg.min_num_hadrons hadrons (or the limits), one OSCAR
    file a batch in <out_dir>/results_<i>/ (oversample.sh layout).

    <out_dir>/manifest.json records the run's parameters and every
    completed batch (events, hadrons, file, seed).  A rerun with
    ``resume=True`` skips the batches whose entry and file both exist and
    samples the rest with their own deterministic seeds, so its output
    equals an uninterrupted run's; a manifest of other stream parameters
    (base_seed, events_per_batch, the event target, the worker split, the
    decays, the draw, the decay streams) refuses to resume.  With
    ``n_workers > 1`` this process takes the batches with ``batch %
    n_workers == worker_id`` and records them in manifest_worker<k>.json;
    the batch seeds are a single worker's, so the workers' union is the
    single-process run file for file.  With ``cfg.do_resonance_decays``
    and a ``particle_table`` every batch is decayed before it is written,
    under a seed derived from its own.  With ``mesh`` (a CellMesh) every
    batch is sampled over its ranks (the cell-sharded sampler, whose
    streams depend on the rank count: ``mesh_shards`` in the manifest, and
    a resume at another count refuses); every rank returns the same
    totals, and rank 0 alone writes the batch files and the manifest,
    after its own view of the checkpoints decided which batches to run.

    Returns (n_batches, total_hadrons, mean_yield); with n_workers > 1 the
    total covers this worker's batches."""
    from .kernels.mc_decays import (DECAY_STREAM_VERSION, decay_events,
                                    derive_decay_seed)
    from .parallel.mesh import check_mesh, gather_objects
    check_mesh(mesh)
    do_decays = bool(getattr(cfg, "do_resonance_decays", 0))
    if do_decays and particle_table is None:
        raise ValueError("cfg.do_resonance_decays=1 needs particle_table= "
                         "(the full ParticleTable the decay channels come "
                         "from)")
    ntot = abs(calculate_total_yield(surface, species, df_data, cfg, plasma))
    n_events_needed = int(np.ceil(cfg.min_num_hadrons / max(ntot, 1e-30)))
    n_events_needed = min(n_events_needed, cfg.max_num_samples)

    os.makedirs(out_dir, exist_ok=True)
    manifest_name = ("manifest.json" if n_workers == 1
                     else f"manifest_worker{worker_id}.json")
    manifest_path = os.path.join(out_dir, manifest_name)
    sampler_alias = int(getattr(cfg, "sampler_alias", 0))
    decay_stream = DECAY_STREAM_VERSION if do_decays else 0
    mesh_shards = 0 if mesh is None else mesh.size
    writes = mesh is None or mesh.rank == 0
    manifest = {"base_seed": base_seed, "events_per_batch": events_per_batch,
                "n_events_needed": n_events_needed, "batches": {},
                "worker_id": worker_id, "n_workers": n_workers,
                "mesh_shards": mesh_shards, "max_batches": max_batches,
                "decays": int(do_decays), "sampler_alias": sampler_alias,
                "decay_stream": decay_stream}
    if os.path.exists(manifest_path):
        if not resume:
            raise ValueError(
                f"{manifest_path} exists; pass resume=True to continue the "
                "run or choose a fresh out_dir")
        with open(manifest_path) as f:
            prev = json.load(f)
        if (prev.get("base_seed") != base_seed
                or prev.get("events_per_batch") != events_per_batch
                or prev.get("n_events_needed") != n_events_needed
                or prev.get("worker_id", 0) != worker_id
                or prev.get("n_workers", 1) != n_workers
                or prev.get("mesh_shards", 0) != mesh_shards
                or prev.get("decays", 0) != int(do_decays)
                or prev.get("sampler_alias") != sampler_alias
                or prev.get("decay_stream", 0) != decay_stream):
            raise ValueError(
                f"{manifest_path} was written with base_seed="
                f"{prev.get('base_seed')}, events_per_batch="
                f"{prev.get('events_per_batch')}, n_events_needed="
                f"{prev.get('n_events_needed')} (now {n_events_needed}), "
                f"worker {prev.get('worker_id', 0)}/"
                f"{prev.get('n_workers', 1)}, mesh_shards="
                f"{prev.get('mesh_shards', 0)} (now {mesh_shards}), decays="
                f"{prev.get('decays', 0)} (now {int(do_decays)}), "
                f"sampler_alias={prev.get('sampler_alias')} "
                f"(now {sampler_alias}), decay_stream="
                f"{prev.get('decay_stream', 0)} (now {decay_stream}); "
                "refusing to resume with different parameters (would "
                "silently mix sample streams)")
        manifest = prev
        # a run-length cap, not a stream parameter: kept current for
        # merge_manifests
        manifest["max_batches"] = max_batches

    plan = _batch_plan(n_events_needed, events_per_batch, max_batches)
    seeds = ensemble_seeds(base_seed, max_batches)
    device = surface.tau.device
    mine = [(b, nev) for b, nev in enumerate(plan)
            if b % n_workers == worker_id]
    # the checkpointed batches (entry and file), by their hadrons: rank
    # 0's view on every rank, so that the ranks sample the same batches
    done = {}
    for b, nev in mine:
        entry = manifest["batches"].get(str(b))
        if (entry is not None and entry["events"] == nev
                and os.path.exists(entry["file"])):
            done[b] = entry["hadrons"]
    if mesh is not None and mesh.size > 1:
        done = gather_objects(done, mesh)[0]
    total = 0
    for batch, nev in mine:
        if batch in done:
            total += done[batch]
            continue
        events = sample_particles(surface, species, mcids, df_data, cfg,
                                  plasma, nevents=nev, seed=seeds[batch],
                                  mesh=mesh)
        if do_decays:
            events = decay_events(events, particle_table, cfg,
                                  seed=derive_decay_seed(seeds[batch]),
                                  device=device)
        n_had = sum(len(e["mcid"]) for e in events)
        total += n_had
        if not writes:
            continue
        d = os.path.join(out_dir, f"results_{batch}")
        os.makedirs(d, exist_ok=True)
        out_file = os.path.join(d, "particle_list_osc.dat")
        writers.write_particle_list_oscar(events, out_file)
        manifest["batches"][str(batch)] = {
            "events": nev, "hadrons": n_had, "file": out_file,
            "seed": seeds[batch]}
        _write_manifest(manifest_path, manifest)
    return len(plan), total, ntot


def merge_manifests(out_dir: str, n_workers: int) -> dict:
    """Merge the workers' manifests into <out_dir>/manifest.json: the
    workers must agree on every stream parameter, and the union of their
    batches is checked against the plan.  Returns the merged manifest
    (base_seed, events_per_batch, n_events_needed, n_workers, batches,
    total_hadrons, complete, missing_batches, and the stream tags)."""
    merged = None
    for k in range(n_workers):
        name = ("manifest.json" if n_workers == 1
                else f"manifest_worker{k}.json")
        path = os.path.join(out_dir, name)
        if not os.path.exists(path):
            raise FileNotFoundError(f"missing worker manifest: {path}")
        with open(path) as f:
            m = json.load(f)
        if merged is None:
            merged = {key: m[key] for key in
                      ("base_seed", "events_per_batch", "n_events_needed")}
            merged.update(n_workers=n_workers, batches={},
                          max_batches=m.get("max_batches", 1000),
                          mesh_shards=m.get("mesh_shards", 0),
                          decays=m.get("decays", 0),
                          sampler_alias=m.get("sampler_alias"),
                          decay_stream=m.get("decay_stream", 0))
        else:
            for key in ("base_seed", "events_per_batch", "n_events_needed",
                        "max_batches", "mesh_shards", "decays",
                        "sampler_alias", "decay_stream"):
                have = (m.get(key, 0)
                        if key in ("mesh_shards", "decays", "decay_stream")
                        else m.get(key, merged.get(key)))
                if have != merged.get(key):
                    raise ValueError(
                        f"worker {k} manifest disagrees on {key}: "
                        f"{have} != {merged.get(key)}")
        if m.get("n_workers", 1) != n_workers:
            raise ValueError(
                f"worker {k} ran with n_workers={m.get('n_workers', 1)}, "
                f"expected {n_workers}")
        merged["batches"].update(m["batches"])

    plan = _batch_plan(merged["n_events_needed"], merged["events_per_batch"],
                       merged["max_batches"])
    missing = [b for b in range(len(plan))
               if str(b) not in merged["batches"]
               or not os.path.exists(merged["batches"][str(b)]["file"])]
    # only batches of the plan whose file exists count: stale entries of an
    # earlier, longer plan, and lost files (missing, to be rerun), do not
    missing_set = set(missing)
    merged["total_hadrons"] = sum(v["hadrons"]
                                  for b, v in merged["batches"].items()
                                  if int(b) < len(plan)
                                  and int(b) not in missing_set)
    merged["complete"] = not missing
    merged["missing_batches"] = missing
    _write_manifest(os.path.join(out_dir, "manifest.json"), merged)
    return merged


def multiprocess_oversample(run_dir: str, out_dir: str, n_workers: int = 2,
                            events_per_batch: int = 100, base_seed: int = 0,
                            overrides: dict | None = None,
                            platform: str | None = None,
                            mesh_devices: int | None = None,
                            host_devices: int | None = None,
                            timeout: float = 3600.0,
                            device: str | None = None) -> dict:
    """Run ``n_workers`` worker processes over disjoint batches of one
    oversampling plan (``python -m is3d_tpu_torch.ensemble_worker``, each
    loading the reference-layout ``run_dir``) and merge their manifests.
    A crashed or killed pool can be launched again: the per-batch
    checkpoints make it resume.  ``platform`` names the device as the CLI
    reads it (cpu, gpu or cuda); ``device`` (default cuda) says the same.
    The CUDA libraries are built here first, once, so that the workers do
    not each run nvcc.

    ``mesh_devices=N`` makes each worker a group of N ranks, one card each
    (worker w's rank r on card (w N + r) mod the card count), over NCCL;
    ``host_devices=N`` the same on the CPU over gloo (is3d_tpu's virtual
    CPU devices).  Each group joins through a rendezvous file of its own
    under out_dir and samples its batches with the cell-sharded sampler
    (oversample_run(mesh=)).

    Returns the merged manifest (see merge_manifests)."""
    if mesh_devices and host_devices:
        raise ValueError("mesh_devices (cards) and host_devices (CPU ranks) "
                         "are two spellings of a worker's ranks: give one")
    if platform is not None:
        mapped = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}.get(platform)
        if mapped is None or (device is not None
                              and device.split(":")[0] != mapped):
            raise ValueError(f"platform={platform!r} is not one of cpu, gpu, "
                             f"cuda, or contradicts device={device!r}")
        device = mapped
    if host_devices:
        if device is not None and device.split(":")[0] != "cpu":
            raise ValueError(f"host_devices runs CPU ranks; device={device!r}"
                             " contradicts it")
        device = "cpu"
    device = device or "cuda"
    if mesh_devices and device.split(":")[0] != "cuda":
        raise ValueError(f"mesh_devices puts each rank on a card; "
                         f"device={device!r} contradicts it (host_devices "
                         "runs CPU ranks)")
    if device.split(":")[0] == "cuda":
        from .native.build import build_cuda_libraries
        build_cuda_libraries(CUDA_SOURCES)
    args_common = [f"run_dir={run_dir}", f"out_dir={out_dir}",
                   f"n_workers={n_workers}",
                   f"events_per_batch={events_per_batch}",
                   f"base_seed={base_seed}", f"device={device}"]
    for k, v in (overrides or {}).items():
        args_common.append(f"{k}={v}")
    # the workers import this package from where the parent found it
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    n_ranks = int(mesh_devices or host_devices or 1)
    rdzv = os.path.join(os.path.abspath(out_dir), ".rendezvous")
    tag = f"{os.getpid()}_{time.monotonic_ns()}"
    if mesh_devices or host_devices:
        os.makedirs(rdzv, exist_ok=True)
        if host_devices:
            # a CPU worker's ranks are on this host: gloo over loopback
            env.setdefault("GLOO_SOCKET_IFNAME", "lo")

    def rank_args(w: int, r: int) -> list:
        if not (mesh_devices or host_devices):
            return []
        key = "mesh_devices" if mesh_devices else "host_devices"
        return [f"{key}={n_ranks}", f"mesh_rank={r}",
                f"mesh_init=file://{rdzv}/worker{w}_{tag}"]

    deadline = time.monotonic() + timeout
    procs = [subprocess.Popen(
        [sys.executable, "-m", "is3d_tpu_torch.ensemble_worker",
         f"worker_id={w}", *args_common, *rank_args(w, r)], env=env)
        for w in range(n_workers) for r in range(n_ranks)]
    try:
        rcs = [p.wait(timeout=max(1.0, deadline - time.monotonic()))
               for p in procs]
    except subprocess.TimeoutExpired:
        rcs = None
    finally:
        # one deadline for the pool: no worker outlives this call
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    if rcs is None:
        raise RuntimeError(
            f"oversample worker pool exceeded {timeout:.0f} s; all workers "
            "killed -- launch multiprocess_oversample again to resume from "
            "the per-batch checkpoints")
    bad = [(i // n_ranks, rc) for i, rc in enumerate(rcs) if rc != 0]
    if bad:
        raise RuntimeError(
            f"oversample worker(s) failed (worker, rc): {bad}; launch "
            "multiprocess_oversample again to resume from the per-batch "
            "checkpoints")
    return merge_manifests(out_dir, n_workers)
