"""Time the spectra kernel of two checkouts of this repository in one
process tree on one card, in the order A, B, B, A.

    python -m is3d_tpu_torch.tools.ab_spectra ROOT_A ROOT_B [--cells N]

Each turn runs a fresh interpreter that imports ``is3d_tpu_torch`` from
that root (building its csrc/smooth_spectra.cu into that root's _build/),
launches ``smooth_spectra_cuda`` on one group of the main path's shape --
N synthetic 3+1D cells (seed 0), 320 species, the native 32 x 24 x 21
grid, df 2 with shear + bulk, regulate, outflow, float32 -- once to warm
up, then times 5 launches (CUDA events) and prints their median and the
sum of the output.  The report is one JSON line per turn and the ratio of
the medians.  Uses only functions both sides have had since the kernel was
first ported.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_TURN = r"""
import json, statistics, sys
sys.path.insert(0, sys.argv[1])
import torch
from is3d_tpu_torch import testing
from is3d_tpu_torch.config import Config
from is3d_tpu_torch.io.tables import native_momentum_grid
from is3d_tpu_torch.kernels import smooth
from is3d_tpu_torch.kernels.common import surface_columns, prepare_cells
assert smooth.__file__.startswith(sys.argv[1]), smooth.__file__
dev, dt = torch.device("cuda"), torch.float32
cfg = Config(operation=1, mode=1, dimension=3, df_mode=2, precision="f32",
             include_shear_deltaf=1, include_bulk_deltaf=1,
             regulate_deltaf=1, outflow=1)
surf = testing.synthetic_surface(int(sys.argv[2]), 3, seed=0, dtype=dt,
                                 device=dev)
species = testing.synthetic_species(320, dtype=dt, device=dev)
grid = native_momentum_grid(3, dtype=dt, device=dev)
df_data = testing.synthetic_deltaf_data(dtype=dt, device=dev)
cells = smooth.pack_cells(prepare_cells(surface_columns(surf, cfg), cfg,
                                        df_data), cfg)
mom = smooth.momentum_constants(species, grid, 3)
flags = smooth.spectra_flags(cfg, grid)
out = smooth.smooth_spectra_cuda(cells, mom, flags)
torch.cuda.synchronize()
times = []
for _ in range(5):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = smooth.smooth_spectra_cuda(cells, mom, flags)
    b.record()
    b.synchronize()
    times.append(a.elapsed_time(b))
print(json.dumps({"root": sys.argv[1], "ms": statistics.median(times),
                  "runs": times, "sum": float(out.double().sum())}))
"""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root_a")
    ap.add_argument("root_b")
    ap.add_argument("--cells", type=int, default=16384)
    args = ap.parse_args(argv)
    roots = [os.path.abspath(r) for r in (args.root_a, args.root_b)]
    results = {r: [] for r in roots}
    for root in (roots[0], roots[1], roots[1], roots[0]):
        proc = subprocess.run([sys.executable, "-c", _TURN, root,
                               str(args.cells)], capture_output=True,
                              text=True, check=True, timeout=900)
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results[root].append(json.loads(line))
    med = {r: sorted(t["ms"] for t in results[r]) for r in roots}
    a, b = (sum(med[r]) / 2 for r in roots)
    print(json.dumps({"a_ms": a, "b_ms": b, "b_over_a": b / a,
                      "same_sum": len({t["sum"] for r in roots
                                       for t in results[r]}) == 1}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
