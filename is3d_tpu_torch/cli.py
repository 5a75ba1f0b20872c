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
cuda -> device=cuda); its pod keys and ``host_devices`` are multi-device
keys and raise NotImplementedError until multi-GPU (ROADMAP slice 11) is
ported.
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
    "             polarization, then the operation)")


# is3d_tpu's multi-device CLI keys: its pod mode and its virtual CPU
# device count
_MULTI_DEVICE_KEYS = ("multihost_coordinator", "multihost_nproc",
                      "multihost_pid", "host_devices")
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
    multi = [k for k in _MULTI_DEVICE_KEYS if k in overrides]
    if multi:
        raise NotImplementedError(
            f"{', '.join(multi)} (multi-device runs) is not ported yet: "
            "ROADMAP section 1, slice 11")
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

    from .api import IS3D
    from .utils import PhaseTimer

    t0 = time.time()
    run = IS3D.from_run_dir(run_dir, overrides=overrides, device=device)
    # full config echo (reference: paraRdr->echo() at iS3D.cpp:84)
    for f in dataclasses.fields(run.cfg):
        print(f"  {f.name} = {getattr(run.cfg, f.name)}")
    print(f"  device = {run.device}")
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
