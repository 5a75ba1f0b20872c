"""Run-time utilities: phase timing and CUDA-event kernel timing.

The reference's only instrumentation is a wall-clock Stopwatch around
calculate_spectra (src/cpp/Stopwatch.h) plus progress printfs.  Here every
pipeline phase is timed on the host clock; a phase that ends by reading a
device result back to the host (as the spectra phase does) includes the
device time.
"""

from __future__ import annotations

import contextlib
import time


class PhaseTimer:
    """Accumulates named phase durations; prints a summary."""

    def __init__(self, verbose: bool = True):
        self.verbose = verbose
        self.phases: list = []

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.phases.append((name, dt))
            if self.verbose:
                print(f"[is3d_tpu_torch] {name}: {dt:.3f} s")

    def total(self) -> float:
        return sum(dt for _, dt in self.phases)

    def summary(self) -> str:
        lines = [f"  {name:<28s} {dt:8.3f} s" for name, dt in self.phases]
        lines.append(f"  {'total':<28s} {self.total():8.3f} s")
        return "\n".join(lines)


def cuda_median_ms(fn, n: int = 5):
    """Median and all of ``n`` CUDA-event times (ms) of ``fn()`` on the
    current stream, each run synchronized; the caller warms up first."""
    import statistics
    import torch
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(statistics.median(times)), times
