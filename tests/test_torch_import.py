"""is3d_tpu_torch imports neither jax, flax nor is3d_tpu: a fresh
interpreter imports the package, the dN/dX kernels and the experiments,
runs a CPU spectra call and a CPU spacetime_distributions call, then
checks sys.modules."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import json, sys
import torch
torch.set_num_threads(1)
import is3d_tpu_torch
from is3d_tpu_torch import testing
from is3d_tpu_torch.config import Config
from is3d_tpu_torch.io.tables import native_momentum_grid
from is3d_tpu_torch.kernels.smooth import smooth_spectra
from is3d_tpu_torch.kernels.dndx import spacetime_distributions
from is3d_tpu_torch.experiments import smooth_proto, dndx_reduce_probe
cfg = Config(dimension=3, df_mode=2, include_shear_deltaf=1)
out = smooth_spectra(testing.synthetic_surface(20, 3),
                     testing.synthetic_species(4),
                     native_momentum_grid(3, n_pT=3, n_phi=4, n_y=3),
                     testing.synthetic_deltaf_data(), cfg)
dX = spacetime_distributions(testing.synthetic_surface(20, 2),
                             testing.synthetic_species(4),
                             native_momentum_grid(2, n_pT=3, n_phi=4, n_eta=5),
                             testing.synthetic_deltaf_data(),
                             Config(operation=0, dimension=2, df_mode=1))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "is3d_tpu"))
print(json.dumps({"shape": list(out.shape),
                  "finite": bool(torch.isfinite(out).all()),
                  "dN_dy": list(dX["dN_dy"].shape),
                  "dN_dy_positive": bool((dX["dN_dy"] > 0).all()),
                  "bad": bad}))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res == {"shape": [4, 3, 4, 3], "finite": True, "dN_dy": [4],
                   "dN_dy_positive": True, "bad": []}
