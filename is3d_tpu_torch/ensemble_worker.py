"""Worker process of ensemble.multiprocess_oversample (port of
is3d_tpu/ensemble_worker.py).

Usage (spawned by multiprocess_oversample, or by hand or a scheduler
against a shared filesystem)::

    python -m is3d_tpu_torch.ensemble_worker worker_id=0 n_workers=4 \\
        run_dir=. out_dir=oversampling events_per_batch=100 base_seed=0 \\
        [device=cuda|cpu] [platform=cpu|gpu|cuda] [any iS3D parameter] \\
        [mesh_devices=N | host_devices=N  mesh_rank=r  mesh_init=URL]

The worker loads the surface from the reference-layout run_dir, derives
the same deterministic batch plan as every other worker, and samples the
batches with batch % n_workers == worker_id, checkpointing each into its
own manifest.  ``platform`` maps to ``device`` as the CLI maps it.

A worker of N ranks is N such processes, one a rank (``mesh_rank``), that
join the group at ``mesh_init`` (file://path or tcp://host:port, one per
worker): ``mesh_devices=N`` puts rank r of worker w on card (w N + r) mod
the card count, over NCCL; ``host_devices=N`` on the CPU, over gloo.  The
group's CellMesh goes to ensemble.oversample_run(mesh=).
"""

from __future__ import annotations

import sys

_OWN_KEYS = ("worker_id", "n_workers", "run_dir", "out_dir",
             "events_per_batch", "base_seed", "platform", "max_batches",
             "mesh_devices", "host_devices", "mesh_rank", "mesh_init",
             "device")
_PLATFORM_DEVICE = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def main(argv: list[str]) -> int:
    kv = {}
    for a in argv:
        if "=" not in a:
            raise SystemExit(f"arguments must be key=value, got {a!r}")
        k, v = a.split("=", 1)
        kv[k] = v
    device = kv.get("device")
    if kv.get("platform"):
        mapped = _PLATFORM_DEVICE.get(kv["platform"])
        if mapped is None or (device is not None
                              and device.split(":")[0] != mapped):
            raise SystemExit(f"platform={kv['platform']} is not one of cpu, "
                             f"gpu, cuda, or contradicts device={device}")
        device = mapped
    device = device or ("cpu" if kv.get("host_devices") else "cuda")

    from . import config as _config

    overrides = {k: v for k, v in kv.items() if k not in _OWN_KEYS}
    # a mistyped worker key (n_worker=4) would reach the config, be
    # dropped there, and leave this worker sampling every batch of the plan
    unknown = sorted(k for k in overrides if k not in _config._FIELD_TYPES)
    if unknown:
        raise SystemExit(
            f"unknown argument(s) {unknown}: not a worker key "
            f"({', '.join(_OWN_KEYS)}) and not an iS3D config parameter")
    mesh = _join_mesh(kv, device)
    try:
        return _sample(kv, overrides, device if mesh is None
                       else mesh.device, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def _join_mesh(kv: dict, device: str):
    """The worker's CellMesh from mesh_devices / host_devices, mesh_rank
    and mesh_init (None for a one-device worker)."""
    if kv.get("mesh_devices") and kv.get("host_devices"):
        raise SystemExit("give one of mesh_devices (cards) and host_devices "
                         "(CPU ranks)")
    n = int(kv.get("mesh_devices") or kv.get("host_devices") or 0)
    if not n:
        return None
    if "mesh_rank" not in kv or "mesh_init" not in kv:
        raise SystemExit("a worker of several ranks needs mesh_rank= and "
                         "mesh_init= (its group's rendezvous)")
    rank = int(kv["mesh_rank"])
    import torch
    from .parallel import multihost
    if kv.get("host_devices"):
        if device.split(":")[0] != "cpu":
            raise SystemExit(f"host_devices runs CPU ranks; device={device} "
                             "contradicts it")
        dev, backend = torch.device("cpu"), "gloo"
    else:
        from .api import resolve_device
        resolve_device(device)
        index = (int(kv.get("worker_id", 0)) * n + rank
                 ) % torch.cuda.device_count()
        dev, backend = torch.device("cuda", index), "nccl"
        torch.cuda.set_device(dev)
    multihost.initialize(kv["mesh_init"], n, rank, backend)
    return multihost.global_mesh(dev)


def _sample(kv: dict, overrides: dict, device, mesh) -> int:
    import numpy as np
    from .api import IS3D
    from .ensemble import oversample_run
    run = IS3D.from_run_dir(kv.get("run_dir", "."), overrides=overrides,
                            device=device)
    run.read_fo_surf_from_file(write_averages=False)
    table, df_data, species, mcids, _grid = run._prepare()
    n_batches, total, ntot = oversample_run(
        run.surface, species, np.asarray(mcids),
        None if run.cfg.mode in (2, 3) else df_data, run.cfg, run.plasma(),
        out_dir=kv.get("out_dir", "oversampling"),
        events_per_batch=int(kv.get("events_per_batch", 100)),
        base_seed=int(kv.get("base_seed", 0)),
        max_batches=int(kv.get("max_batches", 1000)),
        worker_id=int(kv.get("worker_id", 0)),
        n_workers=int(kv.get("n_workers", 1)), mesh=mesh,
        particle_table=table)
    ranks = "" if mesh is None else f" rank {mesh.rank}/{mesh.size}"
    print(f"worker {kv.get('worker_id', 0)}/{kv.get('n_workers', 1)}"
          f"{ranks}: {total} hadrons over its share of {n_batches} batches "
          f"(mean yield {ntot:.3f}/event)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
