"""Native runtime components, built on demand and ctypes-wrapped.

The host IO library (fastio.cpp, the same source as is3d_tpu's) is compiled
with the system toolchain and degrades to the pure-numpy path without one;
the CUDA kernels under csrc/ are built by the same module (native/build.py).
"""

from .build import get_fastio, fast_parse_doubles  # noqa: F401
