"""The canonical cell-reduction tree, on one device or over ranks.

Bit-stability contract (BASELINE.md): the cell reduction runs over a
CANONICAL GROUP TREE that is a function of the global surface size and
config only.  The padded cell axis is cut into G groups at global
boundaries; each group is reduced by one kernel call, and the G group
partials are combined by a SEQUENTIAL left fold in group order
(elementwise adds -- value-deterministic).  Multi-GPU runs change only
where the group partials are computed, not the fold.

Multi-GPU (``mesh=``, port of is3d_tpu/parallel/mesh.py:129-232): a
``CellMesh`` is a torch.distributed process group, one process a GPU (not
is3d_tpu's single-controller device mesh).  With W ranks the groups stay
those of the global cell count; G_pad = ceil(G / W) W, and rank r owns the
contiguous groups [r G_pad / W, (r + 1) G_pad / W).  It launches one kernel
call per REAL group it owns -- pad groups are neither launched nor folded
(JAX appends them only for shard_map's equal shapes) -- the ranks exchange
their partials (NCCL: all_gather on the device; gloo: through pinned host
copies), and every rank folds all G partials in global group order with
``_fold``, so each returns the one-process result bit for bit.  That holds
for the same card model on every rank: the CUDA wrappers size a group's
launch from the card's occupancy (remap_cell_split, launch.tile_split),
so ``default_mesh`` checks the card names.  W == 1 takes the one-process
loop.

Under autograd the gather-and-fold is ``_GatherFold``: its backward hands
each of the rank's own partials the output's cotangent (the fold's reverse
is the identity on each term), so the rank's backward kernels produce the
gradient rows of its own cells; ``diff.surface_value_and_grad`` and
``diff.surface_vjp`` assemble the global gradient from every rank's rows
(``recording_layouts``, ``ShardLayout.assemble``).  The event axis of
batch.py records an ``EventLayout`` the same way, and the sampler and pod
mode meet through ``gather_objects`` and ``barrier``.
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass

import torch

from ..config import Config
from ..kernels.common import pad_and_chunk

# the rank's work in sharded reductions since the last reset_mesh_stats():
# real groups launched, seconds of its own launches (to a device sync),
# bytes gathered (all ranks' rows, pad rows included) and seconds of the
# gather and the fold (to a device sync)
MESH_STATS = dict(reductions=0, groups=0, compute_s=0.0, gathered_bytes=0,
                  gather_fold_s=0.0)


def reset_mesh_stats():
    MESH_STATS.update(reductions=0, groups=0, compute_s=0.0,
                      gathered_bytes=0, gather_fold_s=0.0)


@dataclass(frozen=True)
class CellMesh:
    """The ranks a cell reduction runs over: a torch.distributed process
    group (one GPU a rank), this rank's device, its rank and the group's
    size, and the group's backend."""

    group: object
    device: torch.device
    rank: int
    size: int
    backend: str = "gloo"

    @property
    def device_collectives(self) -> bool:
        """NCCL exchanges device tensors; gloo goes through the host."""
        return "nccl" in str(self.backend) and self.device.type == "cuda"


def _mesh_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("default_mesh: no device given and CUDA is "
                               "not available; pass device='cpu' for a "
                               "CPU rank")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def default_mesh(device=None, group=None) -> CellMesh:
    """The CellMesh of ``group`` (default: WORLD) on ``device`` (default:
    the current CUDA device), after torch.distributed.init_process_group
    (or parallel.multihost.initialize).  Raises without an initialised
    group -- it never builds a world of one -- and when the ranks' devices
    are not all the same model (a group's partial bits depend on it)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("default_mesh needs an initialised "
                           "torch.distributed process group "
                           "(parallel.multihost.initialize)")
    group = dist.group.WORLD if group is None else group
    dev = _mesh_device(device)
    size = dist.get_world_size(group)
    names = [None] * size
    with (torch.cuda.device(dev) if dev.type == "cuda"
          else contextlib.nullcontext()):
        dist.all_gather_object(names, _device_name(dev), group=group)
    if len(set(names)) != 1:
        raise RuntimeError("every rank of a CellMesh must run on the same "
                           f"device model, got {names}")
    return CellMesh(group=group, device=dev, rank=dist.get_rank(group),
                    size=size, backend=str(dist.get_backend(group)))


def check_mesh(mesh):
    """Raise TypeError unless ``mesh`` is None or a CellMesh."""
    if mesh is not None and not isinstance(mesh, CellMesh):
        raise TypeError("mesh= takes a parallel.mesh.CellMesh (a "
                        "torch.distributed process group, default_mesh()),"
                        f" got {type(mesh).__name__}")


def canonical_groups(cfg: Config, n_cells: int) -> tuple[int, int]:
    """(G, group_size) of the canonical reduction tree -- a function of the
    GLOBAL cell count and config only, never of the device count.  G is
    raised in multiples of reduce_groups so a group never exceeds
    cell_slab cells."""
    # cap G at the cell count: tiny surfaces must not pay G x the work in
    # padded groups
    G = max(1, min(cfg.reduce_groups, n_cells))
    G *= max(1, -(-n_cells // (G * cfg.cell_slab)))
    return G, -(-max(n_cells, 1) // G)


@dataclass(frozen=True)
class ShardLayout:
    """Where the groups of one sharded reduction ran: G groups of gs cells
    of an n-cell surface, ``per`` groups a rank (G_pad / W)."""

    mesh: CellMesh
    n_cells: int
    G: int
    gs: int

    @property
    def per(self) -> int:
        return -(-self.G // self.mesh.size)

    def owned(self, rank: int | None = None) -> tuple[int, int]:
        """[g0, g1): the real groups of ``rank`` (default: this rank)."""
        r = self.mesh.rank if rank is None else rank
        return min(self.G, r * self.per), min(self.G, (r + 1) * self.per)

    def assemble(self, rows: dict) -> dict:
        """Every rank's own cell rows of each (n_cells, ...) tensor in
        ``rows`` (a dict), gathered by the canonical cell ranges: rank r's
        rows [r per gs, (r + 1) per gs) come from rank r, so each rank
        returns the tensors a one-process run gives."""
        return _gather_own_rows(rows, self.n_cells, self.per * self.gs,
                                self.mesh)


@dataclass(frozen=True)
class EventLayout:
    """Where the events of one event-sharded ensemble map ran: E whole
    events, E / W a rank in order (batch.py)."""

    mesh: CellMesh
    n_events: int

    @property
    def per(self) -> int:
        return self.n_events // self.mesh.size

    def owned(self, rank: int | None = None) -> tuple[int, int]:
        """[e0, e1): the events of ``rank`` (default: this rank)."""
        r = self.mesh.rank if rank is None else rank
        return r * self.per, (r + 1) * self.per

    def assemble(self, rows: dict) -> dict:
        """Every rank's own event rows of each (E, ...) tensor in ``rows``
        gathered in event order (ShardLayout.assemble on the event
        axis)."""
        return _gather_own_rows(rows, self.n_events, self.per, self.mesh)


def _gather_own_rows(rows: dict, n: int, block: int,
                     mesh: CellMesh) -> dict:
    """Each (n, ...) tensor of ``rows`` with rank r's rows [r block, (r +
    1) block) (clipped to n) taken from rank r: one all-gather of every
    tensor's own rows side by side."""
    if not rows:
        return rows
    names = list(rows)
    flat = [rows[k].reshape(n, -1) for k in names]
    widths = [f.shape[1] for f in flat]
    lo = min(n, mesh.rank * block)
    hi = min(n, lo + block)
    own = torch.cat(flat, dim=1)[lo:hi]
    send = own.new_zeros((block, own.shape[1]))
    send[:hi - lo] = own
    full = _all_gather_rows(send, mesh)[:n]
    out, at = {}, 0
    for k, w in zip(names, widths):
        out[k] = full[:, at:at + w].reshape(rows[k].shape).contiguous()
        at += w
    return out


_RECORDERS: list = []


@contextlib.contextmanager
def recording_layouts():
    """Collect the ShardLayout of every sharded reduction run inside the
    block (diff.py assembles gradients by them)."""
    rec: list = []
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS.remove(rec)


def _pad_inert(cols: dict, n_target: int) -> dict:
    """Pad cell columns to n_target with inert cells: dsigma = 0 so
    u.dsigma = 0 and every kernel's contribution vanishes identically."""
    padded, mask, _ = pad_and_chunk(cols, n_target)
    cols = {k: v.reshape(-1) for k, v in padded.items()}
    m = mask.reshape(-1).to(cols["tau"].dtype)
    for k in ("dat", "dax", "day", "dan"):
        cols[k] = cols[k] * m
    return cols


def _fold(acc, part):
    """acc + part leaf by leaf (a tensor or a dict of tensors), in place
    into acc; the first partial is copied."""
    if isinstance(part, dict):
        return {k: _fold(None if acc is None else acc[k], v)
                for k, v in part.items()}
    return part.clone() if acc is None else acc.add_(part)


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _all_gather_rows(send: torch.Tensor, mesh: CellMesh) -> torch.Tensor:
    """(W * rows, ...) on the mesh's device: every rank's ``send`` (rows,
    ...) in rank order.  NCCL gathers on the device; gloo through host
    copies (pinned for a CUDA device)."""
    import torch.distributed as dist
    shape = (mesh.size * send.shape[0],) + tuple(send.shape[1:])
    if mesh.device_collectives:
        out = send.new_empty(shape)
        dist.all_gather_into_tensor(out, send.contiguous(), group=mesh.group)
        return out
    pin = send.device.type == "cuda"
    host = torch.empty(send.shape, dtype=send.dtype, pin_memory=pin)
    host.copy_(send)
    out = torch.empty(shape, dtype=send.dtype, pin_memory=pin)
    dist.all_gather(list(out.chunk(mesh.size)), host, group=mesh.group)
    return out.to(mesh.device, non_blocking=pin)


def _collective_device(mesh: CellMesh):
    """The CUDA device context an object collective needs under NCCL."""
    return (torch.cuda.device(mesh.device) if mesh.device.type == "cuda"
            else contextlib.nullcontext())


def gather_objects(obj, mesh: CellMesh) -> list:
    """Every rank's picklable ``obj``, in rank order, on every rank."""
    import torch.distributed as dist
    out = [None] * mesh.size
    with _collective_device(mesh):
        dist.all_gather_object(out, obj, group=mesh.group)
    return out


def barrier(mesh: CellMesh):
    """Wait until every rank of the mesh has reached this call."""
    import torch.distributed as dist
    if mesh.device_collectives:
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)


def all_reduce_max(flags: list, mesh: CellMesh) -> list:
    """The ranks' largest value of each flag (bools), one all_reduce."""
    import torch.distributed as dist
    dev = mesh.device if mesh.device_collectives else torch.device("cpu")
    t = torch.tensor([int(f) for f in flags], dtype=torch.int32, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return [bool(v) for v in t.tolist()]


@dataclass(frozen=True)
class _PartSpec:
    """The leaves of a group partial: dict keys (None for a tensor),
    shapes and dtype."""

    keys: tuple | None
    shapes: tuple
    dtype: torch.dtype

    @staticmethod
    def of(part) -> "_PartSpec":
        keys = tuple(part) if isinstance(part, dict) else None
        leaves = [part[k] for k in keys] if keys else [part]
        dtypes = {t.dtype for t in leaves}
        if len(dtypes) != 1:
            raise ValueError(f"a group partial's leaves must share a dtype, "
                             f"got {sorted(map(str, dtypes))}")
        return _PartSpec(keys, tuple(tuple(t.shape) for t in leaves),
                         dtypes.pop())

    def leaves(self, part) -> list:
        return [part[k] for k in self.keys] if self.keys else [part]

    def build(self, leaves):
        return dict(zip(self.keys, leaves)) if self.keys else leaves[0]

    def unflatten(self, row: torch.Tensor):
        out, at = [], 0
        for s in self.shapes:
            out.append(row[at:at + math.prod(s)].view(s))
            at += math.prod(s)
        return self.build(out)


class _GatherFold(torch.autograd.Function):
    """All-gather the ranks' group partials and fold the G real ones in
    global group order.  Inputs: the layout and spec, an anchor (an empty
    slice of a column under grad, so a rank without groups is in the graph
    too) and the rank's partials' leaves, group by group; outputs: the
    folded leaves.  The backward gives each own partial leaf the cotangent
    of its output leaf."""

    @staticmethod
    def forward(ctx, layout, spec, anchor, *own):
        mesh = layout.mesh
        n_leaf = len(spec.shapes)
        width = sum(math.prod(s) for s in spec.shapes)
        send = torch.zeros((layout.per, width), dtype=spec.dtype,
                           device=mesh.device)
        for i in range(len(own) // n_leaf):
            send[i] = torch.cat([t.reshape(-1)
                                 for t in own[i * n_leaf:(i + 1) * n_leaf]])
        t0 = time.perf_counter()
        rows = _all_gather_rows(send, mesh)
        acc = None
        for g in range(layout.G):
            acc = _fold(acc, spec.unflatten(rows[g]))
        _sync(mesh.device)
        MESH_STATS["gathered_bytes"] += rows.numel() * rows.element_size()
        MESH_STATS["gather_fold_s"] += time.perf_counter() - t0
        ctx.n_leaf, ctx.n_own = n_leaf, len(own)
        return tuple(spec.leaves(acc))

    @staticmethod
    def backward(ctx, *cts):
        return (None, None, None) + tuple(
            cts[j % ctx.n_leaf] for j in range(ctx.n_own))


def _shard_spec(parts: list, layout: ShardLayout) -> _PartSpec:
    """The partial's spec, on a rank without groups rank 0's (broadcast
    only when some rank owns no real group: every rank knows that from
    the layout)."""
    spec = _PartSpec.of(parts[0]) if parts else None
    if layout.owned(layout.mesh.size - 1)[0] < layout.G:
        return spec
    import torch.distributed as dist
    box = [spec]
    src = dist.get_global_rank(layout.mesh.group, 0)
    with _collective_device(layout.mesh):
        dist.broadcast_object_list(box, src=src, group=layout.mesh.group)
    return box[0]


def _grouped_shard_run(kernel_fn, own_cols: dict, replicated: tuple,
                       layout: ShardLayout):
    """One kernel call per real group this rank owns (``own_cols`` holds
    exactly those groups' cells, padded), then the gather and the fold:
    the reduction of every group, on every rank."""
    mesh = layout.mesh
    g0, g1 = layout.owned()
    gs = layout.gs
    t0 = time.perf_counter()
    parts = [kernel_fn({k: v[i * gs:(i + 1) * gs]
                        for k, v in own_cols.items()}, *replicated)
             for i in range(g1 - g0)]
    _sync(mesh.device)
    MESH_STATS["reductions"] += 1
    MESH_STATS["groups"] += g1 - g0
    MESH_STATS["compute_s"] += time.perf_counter() - t0
    if _RECORDERS:
        _RECORDERS[-1].append(layout)
    spec = _shard_spec(parts, layout)
    anchor = next((v[:0] for v in own_cols.values() if v.requires_grad),
                  None)
    own = [t for p in parts for t in spec.leaves(p)]
    return spec.build(list(_GatherFold.apply(layout, spec, anchor, *own)))


def _one_process_reduce(kernel_fn, cols: dict, replicated: tuple,
                        G: int, gs: int):
    cols = _pad_inert(cols, G * gs)
    acc = None
    for g in range(G):
        sub = {k: v[g * gs:(g + 1) * gs] for k, v in cols.items()}
        acc = _fold(acc, kernel_fn(sub, *replicated))
    return acc


def grouped_cell_reduce(kernel_fn, cols: dict, replicated: tuple,
                        cfg: Config, mesh: CellMesh | None = None):
    """Reduce ``kernel_fn(cols_group, *replicated)`` -- a tensor, or a dict
    of accumulator tensors -- over the cell axis through the canonical group
    tree: one call per group, every leaf folded in group order.  With a
    ``mesh`` every rank holds the full columns, launches its own groups
    and returns the full reduction (module docstring)."""
    check_mesh(mesh)
    n = cols["tau"].shape[0]
    G, gs = canonical_groups(cfg, n)
    if mesh is None:
        return _one_process_reduce(kernel_fn, cols, replicated, G, gs)
    if cols["tau"].device != mesh.device:
        raise ValueError(f"the columns are on {cols['tau'].device}, the "
                         f"mesh's rank on {mesh.device}")
    if mesh.size == 1:
        t0 = time.perf_counter()
        acc = _one_process_reduce(kernel_fn, cols, replicated, G, gs)
        _sync(mesh.device)
        MESH_STATS["reductions"] += 1
        MESH_STATS["groups"] += G
        MESH_STATS["compute_s"] += time.perf_counter() - t0
        return acc
    layout = ShardLayout(mesh, n, G, gs)
    g0, g1 = layout.owned()
    cols = _pad_inert(cols, G * gs)
    own = {k: v[g0 * gs:g1 * gs] for k, v in cols.items()}
    return _grouped_shard_run(kernel_fn, own, replicated, layout)


def sharded_cell_reduce(kernel_fn, cols: dict, replicated: tuple,
                        cfg: Config, mesh: CellMesh):
    """Mesh-sharded canonical cell reduction (see grouped_cell_reduce)."""
    return grouped_cell_reduce(kernel_fn, cols, replicated, cfg, mesh)


def smooth_spectra_sharded(surface, species, grid, df_data, cfg: Config,
                           mesh: CellMesh | None = None, laguerre=None):
    """Smooth spectra over the ranks of ``mesh`` (default: default_mesh()
    on the surface's device): the linear-df kernel (df 1-2) or the feqmod
    kernel (df 3-4), every rank returning the full spectra."""
    from ..kernels import smooth, feqmod
    if mesh is None:
        mesh = default_mesh(surface.tau.device)
    if cfg.df_mode in (1, 2):
        return smooth.smooth_spectra(surface, species, grid, df_data, cfg,
                                     mesh=mesh)
    if cfg.df_mode not in (3, 4):
        # the same check as the one-process dispatch: an out-of-range
        # df_mode must not reach the feqmod kernel
        raise ValueError(f"df_mode must be 1-4, got {cfg.df_mode}")
    return feqmod.smooth_spectra_feqmod(surface, species, grid, df_data,
                                        cfg, laguerre=laguerre, mesh=mesh)
