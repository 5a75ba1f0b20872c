"""Command-line entry point (RuniS3D equivalent, reference: RuniS3D.cpp).

Usage::

    python -m is3d_tpu_torch [run_dir] [device=cuda|cpu] [key=value ...]

Reads ``<run_dir>/iS3D_parameters.dat``, the surface from
``<run_dir>/input/surface.dat``, PDG / tables / deltaf_coefficients from the
run directory, writes outputs to ``<run_dir>/results/``.  ``key=value``
arguments override parameters (reference: ParameterReader::readFromArguments).
``device`` (default cuda) is consumed by the CLI: cuda must be available
when asked for; the run never moves to the CPU on its own.  is3d_tpu's
harness key ``platform`` names the device too (cpu -> device=cpu, gpu or
cuda -> device=cuda).

Pod mode (is3d_tpu's three keys): run the same command on every rank with
``multihost_coordinator=host:port multihost_nproc=N multihost_pid=i``; the
CLI joins the process group (parallel.multihost.initialize over
tcp://host:port) and runs on parallel.multihost.global_mesh(device), so
every rank computes the one-process result and rank 0 writes results/ (a
directory every rank sees).  ``mesh_backend`` (nccl or gloo; default nccl
for a cuda device, gloo for cpu) is the CLI's own key: gloo lets ranks
share one card, while under nccl each rank of a host needs its own card
(``device=cuda:i``; a bare ``cuda`` is the current card on every rank,
and NCCL refuses two ranks on one).  ``host_devices`` (is3d_tpu's count of virtual CPU
devices in one process) has no meaning for a one-device process and
raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import sys
import time

_USAGE = (
    "usage: python -m is3d_tpu_torch [run_dir] [device=cuda|cpu] "
    "[key=value ...]\n"
    "  run_dir    directory with iS3D_parameters.dat, input/surface.dat,\n"
    "             PDG/, tables/, deltaf_coefficients/ (default: .)\n"
    "  device     cuda (default) or cpu; platform=cpu|gpu|cuda says the\n"
    "             same (is3d_tpu's key)\n"
    "  key=value  parameter overrides, e.g. df_mode=2 precision=f32\n"
    "             (reference: ParameterReader::readFromArguments)\n"
    "  operation  0 (dN/dX), 1 (spectra) or 2 (sampled particle lists);\n"
    "             mode 0-7: 1 viscous hydro,\n"
    "             2 / 3 anisotropic hydro (VAH, PL / PL,PT matched),\n"
    "             5 viscous hydro + thermal vorticity (the spin\n"
    "             polarization, then the operation)\n"
    "pod mode (one rank a device, results bit-identical to one process):\n"
    "  run the SAME command on every rank, adding\n"
    "  multihost_coordinator=host:port multihost_nproc=N multihost_pid=i\n"
    "  [mesh_backend=nccl|gloo] (default nccl on cuda, gloo on cpu; gloo\n"
    "  lets ranks share a card); under nccl give each rank of a host its\n"
    "  own card, device=cuda:i (a bare cuda is cuda:0 on every rank);\n"
    "  rank 0 writes results/, which every rank must see")


# is3d_tpu's pod keys, and the CLI's own key for the group's backend
_POD_KEYS = ("multihost_coordinator", "multihost_nproc", "multihost_pid")
_PLATFORM_DEVICE = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("-h", "--help"):
        print(_USAGE)
        return 0
    run_dir = "."
    if argv and "=" not in argv[0]:
        run_dir = argv.pop(0)
    bad = [a for a in argv if "=" not in a]
    if bad:
        print(f"unrecognized argument(s): {' '.join(bad)}\n{_USAGE}",
              file=sys.stderr)
        return 2
    overrides = dict(a.split("=", 1) for a in argv)
    if "host_devices" in overrides:
        raise NotImplementedError(
            "host_devices (is3d_tpu's virtual CPU devices of one process) "
            "has no meaning for the port, whose processes hold one device "
            "each: run ranks with the pod keys instead (README, decided "
            "differences)")
    device = overrides.pop("device", None)
    if "platform" in overrides:
        platform = overrides.pop("platform")
        mapped = _PLATFORM_DEVICE.get(platform)
        if mapped is None or (device is not None
                              and device.split(":")[0] != mapped):
            print(f"platform={platform} "
                  + (f"contradicts device={device}" if mapped else
                     "is not one of cpu, gpu, cuda") + f"\n{_USAGE}",
                  file=sys.stderr)
            return 2
        device = device or mapped
    device = device or "cuda"
    backend = overrides.pop("mesh_backend", None)
    pod = {k: overrides.pop(k) for k in _POD_KEYS if k in overrides}
    if pod and len(pod) < len(_POD_KEYS):
        missing = [k for k in _POD_KEYS if k not in pod]
        print(f"pod mode needs all of {', '.join(_POD_KEYS)}; missing "
              f"{', '.join(missing)}\n{_USAGE}", file=sys.stderr)
        return 2
    if backend not in (None, "nccl", "gloo") or (backend and not pod):
        print(f"mesh_backend={backend} takes nccl or gloo, with the pod "
              f"keys\n{_USAGE}", file=sys.stderr)
        return 2

    t0 = time.time()
    mesh = None
    if pod:
        mesh = _join_pod(pod, device, backend)
    try:
        return _run(run_dir, overrides, device, mesh, t0)
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def _join_pod(pod: dict, device: str, backend):
    """Join the ranks' process group over tcp://multihost_coordinator and
    return the mesh of every rank on ``device``."""
    import torch
    from .parallel import multihost
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        from .api import resolve_device
        resolve_device(dev)
        if dev.index is not None:
            torch.cuda.set_device(dev)
    multihost.initialize(f"tcp://{pod['multihost_coordinator']}",
                         int(pod["multihost_nproc"]),
                         int(pod["multihost_pid"]), backend)
    return multihost.global_mesh(dev)


def _run(run_dir: str, overrides: dict, device: str, mesh, t0: float) -> int:
    from .api import IS3D
    from .utils import PhaseTimer
    run = IS3D.from_run_dir(run_dir, overrides=overrides,
                            device=None if mesh is not None else device,
                            mesh=mesh)
    # full config echo (reference: paraRdr->echo() at iS3D.cpp:84)
    for f in dataclasses.fields(run.cfg):
        print(f"  {f.name} = {getattr(run.cfg, f.name)}")
    print(f"  device = {run.device}")
    if mesh is not None:
        print(f"  mesh = rank {mesh.rank} of {mesh.size} ({mesh.backend})")
    result = run.run_particlization(timer=PhaseTimer(verbose=True))
    dt = time.time() - t0
    if result.spectra is not None:
        print(f"spectra shape {result.spectra.shape}")
    elif result.events is not None:
        n = sum(len(e["mcid"]) for e in result.events)
        print(f"sampled {len(result.events)} events, {n} hadrons")
    else:
        print(f"dN/dX: {len(result.mcids)} species, dN_dy shape "
              f"{result.dN_dX['dN_dy'].shape}")
    print(run.timer.summary())
    print(f"done in {dt:.2f} s; output in {run.results_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
