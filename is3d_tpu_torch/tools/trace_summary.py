"""Summarize a torch.profiler Chrome trace (utils.device_trace's
``*.pt.trace.json``): the traced window, the card's busy seconds, its idle
share and the device time of each kernel.

    python -m is3d_tpu_torch.tools.trace_summary TRACE.json [--top 5]

prints one JSON object.  The window runs from the first event of the trace
to the end of its last (every timed event: host operators, runtime calls,
device work and the profiler's own start and end marks).  The busy seconds
are the union of the device intervals -- kernels, memory copies and memory
sets (DEVICE_CATEGORIES) -- so work that overlaps on several streams counts
once; the idle share is 1 - busy / window.  A trace without device events
(a host-only trace, or a card whose profiler recorded nothing) is busy 0.
"""

from __future__ import annotations

import argparse
import json
import os

# the Chrome-trace categories of device work, as Kineto names them
DEVICE_CATEGORIES = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})


def load_trace(path: str) -> dict:
    """The trace's JSON object."""
    with open(path) as f:
        return json.load(f)


def _timed(events):
    """(start, end, event) of every event with a time stamp, in
    microseconds; metadata events ("ph": "M") carry none that counts."""
    for e in events:
        if e.get("ph") == "M" or "ts" not in e:
            continue
        t0 = float(e["ts"])
        yield t0, t0 + float(e.get("dur", 0.0) or 0.0), e


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals given in
    microseconds, in seconds."""
    total, lo, hi = 0.0, None, None
    for a, b in sorted(intervals):
        if hi is None or a > hi:
            if hi is not None:
                total += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    if hi is not None:
        total += hi - lo
    return total * 1e-6


def summarize(trace) -> dict:
    """Summary of a trace (a path, or load_trace's object): ``window_s``,
    ``busy_s`` (the union of the device intervals), ``idle_share``,
    ``device_events`` (their count), ``kernels`` {name: {"seconds",
    "count"}} in order of device time (the largest first), and ``bytes``
    (the file's size, given a path)."""
    nbytes = None
    if isinstance(trace, (str, os.PathLike)):
        nbytes = os.path.getsize(trace)
        trace = load_trace(trace)
    timed = list(_timed(trace.get("traceEvents", [])))
    window = ((max(b for _, b, _ in timed) - min(a for a, _, _ in timed))
              * 1e-6 if timed else 0.0)
    device, kernels = [], {}
    for a, b, e in timed:
        cat = e.get("cat")
        if e.get("ph") != "X" or cat not in DEVICE_CATEGORIES:
            continue
        device.append((a, b))
        if cat == "kernel":
            k = kernels.setdefault(e.get("name", "?"),
                                   {"seconds": 0.0, "count": 0})
            k["seconds"] += (b - a) * 1e-6
            k["count"] += 1
    busy = union_seconds(device)
    return dict(window_s=window, busy_s=busy,
                idle_share=1.0 - busy / window if window > 0 else 1.0,
                device_events=len(device),
                kernels=dict(sorted(kernels.items(),
                                    key=lambda kv: -kv[1]["seconds"])),
                bytes=nbytes)


def top_kernels(summary: dict, n: int = 5) -> list:
    """The ``n`` kernels with the most device time: (name, seconds,
    count)."""
    return [(name, k["seconds"], k["count"])
            for name, k in list(summary["kernels"].items())[:n]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace", help="a *.pt.trace.json file")
    ap.add_argument("--top", type=int, default=5,
                    help="kernels listed, by device time (default 5)")
    args = ap.parse_args(argv)
    s = summarize(args.trace)
    s["kernels"] = dict(list(s["kernels"].items())[:args.top])
    print(json.dumps(s))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
