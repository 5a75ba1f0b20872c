"""Resident blocks an SM, registers and local memory of a built CUDA kernel,
read through the CUDA driver from the library's SASS image, for a kernel
whose library exports no query of its own (a checkout from before its
wrapper had one; the backward kernels' ``bwd_props`` do this in-process).

    python -m is3d_tpu_torch.tools.occupancy LIB PATTERN THREADS SMEM

``cuobjdump -xelf`` extracts the library's cubin, ``cuModuleLoad`` loads it
into the current context and, for the first kernel whose mangled name
matches the regular expression PATTERN, ``cuOccupancyMaxActiveBlocksPerMultiprocessor``
gives the blocks an SM holds at THREADS threads and SMEM bytes of dynamic
shared memory (the driver's form of
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), and
``cuFuncGetAttribute`` the registers and local memory bytes a thread.
Runs on the machine with the card; self-contained, so another checkout's
tool can load it by path.
"""

from __future__ import annotations

import ctypes
import glob
import os
import re
import shutil
import subprocess
import sys
import tempfile

_ATTR_LOCAL_BYTES = 3        # CU_FUNC_ATTRIBUTE_LOCAL_SIZE_BYTES
_ATTR_NUM_REGS = 4           # CU_FUNC_ATTRIBUTE_NUM_REGS
_ATTR_MAX_DYN_SMEM = 8       # CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES


def _tool() -> str | None:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return tool if os.path.exists(tool) else None


def kernel_names(lib: str) -> list[str]:
    """The mangled names of the kernels in a library's SASS."""
    tool = _tool()
    if tool is None:
        return []
    proc = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True)
    return re.findall(r"Function : (\S+)", proc.stdout)


def occupancy(lib: str, pattern: str, threads: int, smem: int
              ) -> dict | None:
    """dict(kernel, blocks_per_sm, registers, local_bytes) of the first
    kernel of ``lib`` matching ``pattern``, or None where cuobjdump, the
    driver or the kernel is missing.  Needs a current CUDA context (touch
    the card with torch first)."""
    tool = _tool()
    names = [n for n in kernel_names(lib) if re.search(pattern, n)]
    if tool is None or not names:
        return None
    cuda = ctypes.CDLL("libcuda.so.1")
    with tempfile.TemporaryDirectory() as d:
        subprocess.run([tool, "-xelf", "all", os.path.abspath(lib)], cwd=d,
                       capture_output=True)
        for cubin in sorted(glob.glob(os.path.join(d, "*.cubin"))):
            mod = ctypes.c_void_p()
            if cuda.cuModuleLoad(ctypes.byref(mod), cubin.encode()) != 0:
                continue
            try:
                fn = ctypes.c_void_p()
                if cuda.cuModuleGetFunction(ctypes.byref(fn), mod,
                                            names[0].encode()) != 0:
                    continue
                cuda.cuFuncSetAttribute(fn, _ATTR_MAX_DYN_SMEM, int(smem))
                n, regs, local = (ctypes.c_int() for _ in range(3))
                if cuda.cuOccupancyMaxActiveBlocksPerMultiprocessor(
                        ctypes.byref(n), fn, int(threads),
                        ctypes.c_size_t(int(smem))) != 0:
                    return None
                cuda.cuFuncGetAttribute(ctypes.byref(regs), _ATTR_NUM_REGS,
                                        fn)
                cuda.cuFuncGetAttribute(ctypes.byref(local),
                                        _ATTR_LOCAL_BYTES, fn)
                return dict(kernel=names[0], blocks_per_sm=n.value,
                            registers=regs.value, local_bytes=local.value)
            finally:
                cuda.cuModuleUnload(mod)
    return None


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 4:
        print(__doc__)
        return 2
    import torch
    torch.zeros(1, device="cuda")
    print(occupancy(argv[0], argv[1], int(argv[2]), int(argv[3])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
