"""is3d_tpu_torch: Cooper-Frye particlization on PyTorch and CUDA.

The port of ``is3d_tpu`` (JAX on a TPU) to PyTorch with hand-written Hopper
kernels.  It runs operation 0 (dN/dX spacetime distributions) and operation
1 (smooth spectra) with linear delta-f (df 1-2) on viscous-hydro surfaces
end to end: the reference's run directory in, its results tree out.
Imports torch and numpy, never jax.
"""

__version__ = "0.1.0"

from .config import Config, load_config  # noqa: F401
from .units import HBARC  # noqa: F401
from .api import IS3D, RunResult  # noqa: F401
