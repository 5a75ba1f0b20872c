"""Build and ctypes bindings for the port's native libraries.

Two libraries are compiled at first use from the sources in this package
into ``is3d_tpu_torch/_build/``, each cached under a hash of its source and
flags:

* ``fastio`` (native/fastio.cpp, g++): the surface tokenizer and the
  writers' ``%.8e`` formatter.  Without a host compiler the callers fall
  back to byte-identical Python loops.
* the CUDA kernels (csrc/*.cu, nvcc for sm_90a, plain C interface; the
  hash also covers every csrc/*.cuh header, so a header edit rebuilds):
  no fallback -- a failed build raises with the compiler's output.
  ``build_cuda_libraries`` compiles several sources at once, one nvcc
  process each.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
_FASTIO_SRC = os.path.join(_PKG, "native", "fastio.cpp")
_CSRC = os.path.join(_PKG, "csrc")

_lock = threading.Lock()
_fastio = None
_fastio_tried = False
_cuda_libs: dict = {}
# the compiler output of each CUDA build of this process (ptxas register
# and spill report), by library name
CUDA_BUILD_LOGS: dict = {}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _cached_path(name: str, sources, flags) -> str:
    """The library's path under BUILD_DIR, keyed by the bytes of every file
    in ``sources`` (in order) and the flags."""
    h = hashlib.sha256()
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    os.makedirs(BUILD_DIR, exist_ok=True)
    return os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")


def _try_load(path: str):
    try:
        return ctypes.CDLL(path)
    except OSError:
        return None


def _build_fastio():
    """Compile fastio.cpp into a cached .so and LOAD it; returns the loaded
    CDLL or None.  A .so that compiles but cannot be dlopen'ed is not
    cached, or every later process would silently lose the native path."""
    so_path = _cached_path("fastio", [_FASTIO_SRC], ())
    if os.path.exists(so_path):
        lib = _try_load(so_path)
        if lib is not None:
            return lib
        try:                       # stale unloadable artifact: rebuild
            os.remove(so_path)
        except OSError:
            pass
    tmp = so_path + f".tmp{os.getpid()}"
    # -fopenmp parallelizes the OSCAR formatter; on toolchains without
    # OpenMP support retry without it (the pragmas are no-ops then)
    for extra in (["-fopenmp"], []):
        cmd = ["g++", "-O3", *extra, "-shared", "-fPIC", "-o", tmp,
               _FASTIO_SRC]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (subprocess.SubprocessError, OSError):
            continue
        lib = _try_load(tmp)       # verify BEFORE caching
        if lib is None:
            try:
                os.remove(tmp)
            except OSError:
                pass
            continue
        os.replace(tmp, so_path)   # dlopen holds the inode; rename is safe
        return lib
    return None


def get_fastio():
    """The loaded fastio library, or None if no host compiler could build
    it.  Thread-safe: concurrent first callers wait on the build lock."""
    global _fastio, _fastio_tried
    if _fastio is not None:
        return _fastio
    with _lock:
        if _fastio is None and not _fastio_tried:
            _fastio_tried = True
            lib = _build_fastio()
            if lib is not None:
                lib.parse_doubles.restype = ctypes.c_longlong
                lib.parse_doubles.argtypes = [
                    ctypes.c_char_p, ctypes.c_longlong,
                    ctypes.POINTER(ctypes.c_double), ctypes.c_longlong]
                lib.count_doubles.restype = ctypes.c_longlong
                lib.count_doubles.argtypes = [ctypes.c_char_p,
                                              ctypes.c_longlong]
                dp = ctypes.POINTER(ctypes.c_double)
                lib.write_sci_table.restype = ctypes.c_longlong
                lib.write_sci_table.argtypes = [
                    ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, dp,
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
                _fastio = lib
    return _fastio


def fast_parse_doubles(data: bytes) -> np.ndarray | None:
    """Parse all numeric tokens in ``data``; None if the native lib is
    unavailable or a token is not numeric (caller falls back).  ``data``
    must be a bytes object (CPython NUL-terminates it, which the C side
    requires)."""
    lib = get_fastio()
    if lib is None:
        return None
    n = lib.count_doubles(data, len(data))
    if n < 0:
        return None
    out = np.empty(int(n), dtype=np.float64)
    got = lib.parse_doubles(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n)
    if got != n:
        return None
    return out


def fast_write_sci_table(path: str, append: bool, header: str | None,
                         rows: np.ndarray, blank_every: int) -> bool:
    """Append ``rows`` (2-D float64, C-contiguous) as tab-separated %.8e
    lines with a blank line after every ``blank_every`` rows; False if the
    native lib is unavailable or the write failed (caller falls back to
    the byte-identical Python loop)."""
    lib = get_fastio()
    if lib is None:
        return False
    rows = np.ascontiguousarray(rows, dtype=np.float64)
    if rows.ndim != 2:
        return False
    got = lib.write_sci_table(
        path.encode(), 1 if append else 0,
        header.encode() if header else None,
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rows.shape[0], rows.shape[1], int(blank_every))
    return got == rows.shape[0]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (neither on PATH nor under "
                       f"{home}/bin): cannot build the CUDA kernels")


def _cuda_paths(name: str) -> tuple[str, str]:
    """(source, cached library path) of ``csrc/<name>.cu``; the key covers
    every csrc/*.cuh header, whichever the source includes."""
    src = os.path.join(_CSRC, f"{name}.cu")
    headers = sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))
    return src, _cached_path(name, [src, *headers], NVCC_FLAGS)


def build_cuda_libraries(names) -> None:
    """Compile each ``csrc/<name>.cu`` that has no cached library yet, one
    nvcc process per source, all started together.  Raises with the
    compiler's output if nvcc is missing or any build fails; every process
    started here has ended when this returns or raises."""
    with _lock:
        todo = []
        for name in names:
            src, so_path = _cuda_paths(name)
            if name not in _cuda_libs and not os.path.exists(so_path):
                todo.append((name, src, so_path))
        if not todo:
            return
        nvcc = _nvcc()
        procs = []
        try:
            for name, src, so_path in todo:
                tmp = so_path + f".tmp{os.getpid()}"
                proc = subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", tmp, src],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                procs.append((name, src, so_path, tmp, proc))
            failed = []
            for name, src, so_path, tmp, proc in procs:
                out, err = proc.communicate(timeout=600)
                CUDA_BUILD_LOGS[name] = out + err
                if proc.returncode != 0:
                    failed.append(f"nvcc failed to build {src} (exit "
                                  f"{proc.returncode}):\n{out}{err}")
                else:
                    os.replace(tmp, so_path)
        finally:
            for *_, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if failed:
            raise RuntimeError("\n".join(failed))


def cuda_library(name: str) -> ctypes.CDLL:
    """Build (once per source hash) and load ``csrc/<name>.cu``.  Raises
    with the compiler's output if nvcc is missing or the build fails."""
    lib = _cuda_libs.get(name)
    if lib is not None:
        return lib
    build_cuda_libraries([name])
    with _lock:
        if name not in _cuda_libs:
            _cuda_libs[name] = ctypes.CDLL(_cuda_paths(name)[1])
        return _cuda_libs[name]
