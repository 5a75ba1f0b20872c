"""Run-time utilities: phase timing, CUDA-event kernel timing and an
optional device trace.

The reference's only instrumentation is a wall-clock Stopwatch around
calculate_spectra (src/cpp/Stopwatch.h) plus progress printfs.  Here every
pipeline phase is timed on the host clock; a phase that ends by reading a
device result back to the host (as the spectra phase does) includes the
device time.  A torch.profiler trace can be captured around any phase
(``device_trace``) and summarized by tools/trace_summary.py.
"""

from __future__ import annotations

import contextlib
import os
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


class EnvGatedAccumTimer:
    """Keyed wall-clock accumulation across loop iterations, enabled by an
    environment variable; a no-op otherwise.  Complements PhaseTimer (one
    entry per phase, always on): this one folds repeated enter/exit of the
    same key into a single total, for opt-in breakdowns of hot host loops
    (e.g. IS3D_SAMPLER_TIMINGS=1 for the sampler drain loop)."""

    def __init__(self, env_var: str):
        self.enabled = os.environ.get(env_var, "") == "1"
        self.acc: dict = {}
        # (key, t0) stack so nested/interleaved `with timer(k):` blocks
        # attribute time to the right key instead of silently mixing them
        self._stack: list = []
        self._next_key = None

    def __call__(self, key: str):
        self._next_key = key
        return self

    def __enter__(self):
        if self.enabled:
            self._stack.append((self._next_key, time.perf_counter()))

    def __exit__(self, *exc):
        if self.enabled:
            key, t0 = self._stack.pop()
            self.acc[key] = (self.acc.get(key, 0.0)
                             + time.perf_counter() - t0)
        return False

    def add(self, key: str, seconds: float):
        """Fold ``seconds`` measured elsewhere into ``key`` (a loop that
        keeps its own always-on totals reports them here instead of timing
        each section twice)."""
        if self.enabled:
            self.acc[key] = self.acc.get(key, 0.0) + seconds

    def report(self, label: str):
        if self.enabled and self.acc:
            parts = "  ".join(f"{k}={v:.3f}s" for k, v in self.acc.items())
            print(f"[{label} timings] {parts}")


@contextlib.contextmanager
def device_trace(log_dir: str | None, device=None):
    """torch.profiler trace of the block, written into ``log_dir`` as one
    Chrome-trace JSON (``*.pt.trace.json``, torch.profiler's
    tensorboard_trace_handler); a no-op when ``log_dir`` is None.

    ``device`` resolves as a run's does (default cuda, which raises without
    CUDA): on cuda the trace records the card's activity (kernels, copies,
    sets; CUPTI), and the card is synchronized before the trace ends so no
    queued kernel is left out; on cpu the host's operators.  A trace asked
    for on cuda never falls back to the host's: a card whose profiler
    records nothing gives a trace without device events (the caller checks,
    tools/trace_summary.py)."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    from .api import resolve_device
    dev = resolve_device("cuda" if device is None else device)
    cuda = dev.type == "cuda"
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CUDA if cuda
                             else ProfilerActivity.CPU],
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize(dev)


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


def cuda_queued_ms(fn, inner: int = 20, n: int = 5):
    """Median and all of ``n`` device times (ms) per call of ``fn()`` for a
    call much shorter than its host overhead: each run queues ``inner``
    calls behind a device-side sleep, so the events time the calls back to
    back on the device and not the host's enqueue.  The caller warms up
    first."""
    import statistics
    import torch
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)          # ~10 ms at 2 GHz
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(statistics.median(times)), times
