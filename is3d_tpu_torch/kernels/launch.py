"""What every CUDA kernel wrapper does around its launch: check its
arguments (dtype, shape and contiguity first, the device last, so a CPU
call reaches every check) and launch on the device's current stream,
raising on the error code the C entry point returns."""

from __future__ import annotations

import torch


def check_float(name: str, t: torch.Tensor):
    if not isinstance(t, torch.Tensor) or t.dtype not in (torch.float32,
                                                          torch.float64):
        raise ValueError(f"{name} takes float32 or float64 tensors, got "
                         f"{getattr(t, 'dtype', type(t).__name__)}")


def check_tensor(name: str, t: torch.Tensor, shape: tuple, like: torch.Tensor,
                 dtype=None):
    """Raise unless ``t`` is a contiguous tensor of ``shape`` on ``like``'s
    device with ``dtype`` (default: ``like``'s)."""
    dtype = like.dtype if dtype is None else dtype
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name}: need a tensor, got {type(t).__name__}")
    if (t.device != like.device or t.dtype != dtype
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
        layout = "" if t.is_contiguous() else ", not contiguous"
        raise ValueError(f"{name}: need a contiguous {tuple(shape)} {dtype} "
                         f"tensor on {like.device}, got {tuple(t.shape)} "
                         f"{t.dtype} on {t.device}{layout}")


def require_cuda(name: str, t: torch.Tensor):
    """The last check of a wrapper, after dtypes, shapes and contiguity."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {t.device}")


def launch(lib, what: str, fn, device: torch.device, *args):
    """Call the C entry point ``fn(*args, stream)`` on ``device``'s current
    stream; raise with the CUDA error string if it returns nonzero."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.is3d_cuda_error_string(rc).decode()} "
                           f"(error {rc})")
