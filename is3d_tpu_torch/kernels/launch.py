"""What every CUDA kernel wrapper does around its launch: check its
arguments (dtype, shape and contiguity first, the device last, so a CPU
call reaches every check), split the cells so the card's waves fill, and
launch on the device's current stream, raising on the error code the C
entry point returns."""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

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


# what kernel_props reports, in the C entries' order
PROPS = ("cells_per_block", "threads", "smem_bytes", "blocks_per_sm",
         "registers", "local_bytes")


def kernel_props(lib, what: str, fn, device: torch.device, *args) -> dict:
    """One kernel instantiation's launch shape and resources on ``device``
    from the C entry ``fn(*args, out)``: cells a block, threads, dynamic
    shared memory, resident blocks an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers and local
    memory (spill) bytes a thread."""
    out = (ctypes.c_int * len(PROPS))()
    with torch.cuda.device(device):
        rc = fn(*args, out)
    if rc != 0:
        raise RuntimeError(f"{what}: no launch configuration: "
                           f"{lib.is3d_cuda_error_string(rc).decode()}")
    return dict(zip(PROPS, out))


def resident_blocks(lib, what: str, fn, device: torch.device, *args) -> int:
    """The blocks of a kernel that ``device`` holds at once, from the C
    entry ``fn(*args)`` (SMs x blocks per SM, or minus a CUDA error
    code)."""
    with torch.cuda.device(device):
        slots = fn(*args)
    if slots < 1:
        raise RuntimeError(f"{what}: no launch configuration: "
                           f"{lib.is3d_cuda_error_string(-slots).decode()}")
    return slots


def split_to_fill(n_units: int, blocks_per_split: int, slots: int,
                  max_split: int) -> tuple[int, int]:
    """(units per split, splits) for a kernel whose grid is
    ``blocks_per_split`` blocks of equal work for each contiguous range of
    its ``n_units`` sequential units (cell tiles or batches), on a card
    that holds ``slots`` blocks at once.  A launch of k splits runs in
    ceil(blocks / slots) waves, each as long as one split's units; the
    result is the fewest splits whose waves x units come within 2 % of the
    best of 1..max_split.  Every unit belongs to exactly one split, and
    only the last split may be short."""
    n_units = max(int(n_units), 1)
    if blocks_per_split < 1 or slots < 1 or max_split < 1:
        raise ValueError("split_to_fill needs positive blocks_per_split, "
                         f"slots and max_split, got {blocks_per_split}, "
                         f"{slots}, {max_split}")
    costs = {}
    for k in range(1, min(max_split, n_units) + 1):
        per = -(-n_units // k)
        n_split = -(-n_units // per)
        if n_split not in costs:
            waves = -(-blocks_per_split * n_split // slots)
            costs[n_split] = (waves * per, per)
    best = min(c for c, _ in costs.values())
    n_split = min(k for k, (c, _) in costs.items() if c <= 1.02 * best)
    return costs[n_split][1], n_split


@dataclass(frozen=True)
class KernelGrid:
    """A tiled kernel's grid for one shape on one card, as its C side (the
    owner of the blocking: csrc/feqmod.cu, vah.cu, polzn.cu) reports it."""

    blocks: int        # blocks for each range of cells
    slots: int         # blocks the card holds at once
    parts: int         # partial sums for each range of cells
    tile: int          # cells per shared-memory tile
    max_split: int     # most ranges of cells
    phi_width: int     # remap: angles per thread (its instantiation)


def kernel_grid(lib, what: str, fn, device: torch.device,
                *args) -> KernelGrid:
    """The grid the C entry point ``fn(*args, out)`` reports on
    ``device``; raise with the CUDA error string if it returns nonzero."""
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        rc = fn(*args, out)
    if rc != 0:
        raise RuntimeError(f"{what}: no launch configuration: "
                           f"{lib.is3d_cuda_error_string(rc).decode()}")
    return KernelGrid(*out)


def tile_split(n_cells: int, grid: KernelGrid) -> tuple[int, int]:
    """(cells per split, splits) of a tiled kernel: whole tiles per split,
    the fewest splits that fill the card's waves (split_to_fill)."""
    n_tiles = -(-max(n_cells, 1) // grid.tile)
    per, n_split = split_to_fill(n_tiles, max(grid.blocks, 1), grid.slots,
                                 grid.max_split)
    return per * grid.tile, n_split
