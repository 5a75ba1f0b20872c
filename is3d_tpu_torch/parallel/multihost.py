"""Slice-local multi-GPU runs: each rank holds only its cells.

Port of is3d_tpu/parallel/multihost.py:54-309 onto torch.distributed, one
process a GPU.  ``parallel/mesh.grouped_cell_reduce(..., mesh=)`` takes the
full columns on every rank; here each rank loads only
``process_cell_slice(cfg, n_global, mesh)`` -- its [start, stop) of the
real cells, the cells of the canonical groups it owns -- and passes their
columns (``surface_columns``, ``vah_surface_cols``, ``polzn_cols`` or
``dndx_cols`` of that slice) with the global cell count.  The reduction is
the same ``_grouped_shard_run``: one launch per real group the rank owns,
the partials all-gathered and folded in global group order, so every rank
returns the one-process result bit for bit.

What the port decides from the columns is decided once for all ranks: the
VAH gate (kernels/vah.agreed_vah_cfg) by one all_reduce of the ranks'
flags, where is3d_tpu leaves the gate off on this path; everything else is
decided per group (feqmod.chain_split, dndx.bin_plan) or from cfg.
is3d_tpu's feqmod_kernel_mode, routed_switch, unroll_groups and
optimization_barrier are XLA code-generation matters: the port's groups
are separate launches already.

Pod mode (``*_pod``, is3d_tpu/parallel/multihost.py:318-387): where every
rank holds the whole surface anyway (file mode reads the whole file), each
of these cuts the rank's process_cell_slice from the full columns and runs
the slice-local entry, so the same call on every rank gives IS3D(mesh=)'s
result bit for bit.
"""

from __future__ import annotations

from ..config import Config
from .mesh import (CellMesh, ShardLayout, canonical_groups, check_mesh,
                   default_mesh, grouped_cell_reduce, _grouped_shard_run,
                   _pad_inert)


def initialize(init_method: str, world_size: int, rank: int,
               backend: str) -> None:
    """Join the process group: torch.distributed.init_process_group with
    the caller's rendezvous (``tcp://host:port`` or ``file://path``), world
    size, rank and backend -- "nccl" for one card a rank, "gloo" for CPU
    ranks or ranks that share a card.  Nothing picks or switches the
    backend."""
    import torch.distributed as dist
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def pod_active() -> bool:
    """True when this process is one of several ranks of an initialized
    torch.distributed process group (is3d_tpu's jax.process_count() > 1,
    the test of pod mode)."""
    import torch.distributed as dist
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def global_mesh(device=None) -> CellMesh:
    """The CellMesh of every rank of the process group (default_mesh)."""
    return default_mesh(device)


def _padded_layout(cfg: Config, n_global: int,
                   mesh: CellMesh) -> tuple[int, int]:
    """(padded global cell count, group size) of the canonical tree for
    this global surface on this mesh: G_pad = ceil(G / W) W groups."""
    G, gs = canonical_groups(cfg, n_global)
    W = mesh.size
    return -(-G // W) * W * gs, gs


def process_cell_slice(cfg: Config, n_global: int,
                       mesh: CellMesh | None = None) -> tuple[int, int]:
    """The [start, stop) range of GLOBAL surface cells this rank must
    load, clipped to n_global on both ends (a rank whose whole extent is
    canonical-tree padding loads nothing: start == stop == n_global)."""
    if mesh is None:
        mesh = global_mesh()
    n_padded, _ = _padded_layout(cfg, n_global, mesh)
    per = n_padded // mesh.size
    a = mesh.rank * per
    return min(a, n_global), min(a + per, n_global)


def multihost_cell_reduce(kernel_fn, cols_local: dict, n_global: int,
                          replicated: tuple, cfg: Config,
                          mesh: CellMesh | None = None):
    """Slice-local counterpart of grouped_cell_reduce: every rank passes
    the columns of its process_cell_slice and receives the full
    accumulator (a tensor or a dict of tensors)."""
    check_mesh(mesh)
    if mesh is None:
        mesh = global_mesh()
    start, stop = process_cell_slice(cfg, n_global, mesh)
    n_real = stop - start
    if any(v.shape[0] != n_real for v in cols_local.values()):
        raise ValueError(f"local columns must hold exactly cells [{start}, "
                         f"{stop}) ({n_real} rows)")
    if cols_local["tau"].device != mesh.device:
        raise ValueError(f"the columns are on {cols_local['tau'].device}, "
                         f"the mesh's rank on {mesh.device}")
    if mesh.size == 1:
        return grouped_cell_reduce(kernel_fn, cols_local, replicated, cfg,
                                   mesh)
    G, gs = canonical_groups(cfg, n_global)
    layout = ShardLayout(mesh, n_global, G, gs)
    g0, g1 = layout.owned()
    # the real cells of the rank's groups, padded inert to whole groups
    # exactly as the one-process run pads the surface's last group
    cols = (_pad_inert(cols_local, (g1 - g0) * gs) if g1 > g0
            else cols_local)
    return _grouped_shard_run(kernel_fn, cols, replicated, layout)


def _reject_feqmod(cfg: Config, what: str, alternative: str) -> None:
    if cfg.df_mode in (3, 4) and cfg.mode not in (2, 3):
        raise ValueError(
            f"multi-host {what} handles df_mode 1/2 (and VAH modes 2/3); "
            f"feqmod (df_mode {cfg.df_mode}) runs through {alternative} "
            "(same slice-local contract, plus the Gauss-Laguerre table for "
            "the in-kernel breakdown routing).")


def smooth_spectra_multihost(cols_local: dict, n_global: int, species, grid,
                             df_data, cfg: Config,
                             mesh: CellMesh | None = None):
    """Slice-local linear-df smooth spectra (df_mode 1/2): each rank
    supplies surface_columns() of its process_cell_slice; returns the full
    (S, PT, PHI, Y) spectra on every rank."""
    if cfg.mode in (2, 3):
        raise ValueError(
            f"smooth_spectra_multihost handles VH surfaces only; VAH "
            f"(mode={cfg.mode}) runs through smooth_spectra_vah_multihost")
    if cfg.df_mode not in (1, 2):
        _reject_feqmod(cfg, "smooth spectra", "feqmod_spectra_multihost")
        raise ValueError(f"df_mode must be 1 or 2, got {cfg.df_mode}")
    from ..kernels.smooth import spectra_reduction
    fn, rep = spectra_reduction(cols_local, species, grid, df_data, cfg)
    return multihost_cell_reduce(fn, cols_local, n_global, rep, cfg, mesh)


def _agreed(cols_local: dict, cfg: Config, mesh):
    from ..kernels.vah import agreed_vah_cfg
    check_mesh(mesh)
    mesh = global_mesh() if mesh is None else mesh
    return agreed_vah_cfg(cols_local, cfg, mesh), mesh


def smooth_spectra_vah_multihost(cols_local: dict, n_global: int, species,
                                 grid, cfg: Config,
                                 mesh: CellMesh | None = None):
    """Slice-local VAH smooth spectra (mode 2/3 surfaces): each rank
    supplies vah_surface_cols() of its process_cell_slice.  The residual
    chains are gated as the one-process run gates them, agreed over the
    ranks (kernels/vah.agreed_vah_cfg)."""
    from ..kernels.vah import vah_reduction
    gated, mesh = _agreed(cols_local, cfg, mesh)
    fn, rep = vah_reduction(species, grid, gated)
    return multihost_cell_reduce(fn, cols_local, n_global, rep, gated, mesh)


def spin_polarization_multihost(cols_local: dict, n_global: int, species,
                                grid, cfg: Config, plasma,
                                mesh: CellMesh | None = None) -> dict:
    """Slice-local spin polarization (mode-5 surfaces): each rank supplies
    polzn_cols() of its process_cell_slice; returns the full result dict
    (kernels/polzn.spin_polarization) on every rank."""
    from ..kernels.polzn import polzn_reduction, polzn_normalize, SUMS
    fn, rep = polzn_reduction(cols_local, species, grid, cfg, plasma)
    acc = multihost_cell_reduce(fn, cols_local, n_global, rep, cfg, mesh)
    return polzn_normalize(tuple(acc[k] for k in SUMS))


def spacetime_distributions_multihost(cols_local: dict, n_global: int,
                                      species, grid, df_data, cfg: Config,
                                      mesh: CellMesh | None = None) -> dict:
    """Slice-local dN/dX spacetime distributions (df_mode 1/2 or VAH mode
    2/3): each rank supplies dndx_cols() of its process_cell_slice;
    returns the normalized distribution dict on every rank."""
    _reject_feqmod(cfg, "dN/dX", "feqmod_spacetime_distributions_multihost")
    if cfg.df_mode not in (1, 2, 3, 4):
        raise ValueError("spacetime_distributions handles df 1-4")
    from ..kernels.dndx import dndx_reduction, dndx_finalize
    if cfg.mode in (2, 3):
        cfg, mesh = _agreed(cols_local, cfg, mesh)
    fn, rep, grid = dndx_reduction(cols_local, species, grid, df_data, cfg)
    acc = multihost_cell_reduce(fn, cols_local, n_global, rep, cfg, mesh)
    return dndx_finalize(acc, grid, cfg)


def feqmod_spectra_multihost(cols_local: dict, n_global: int, species, grid,
                             df_data, cfg: Config, laguerre=None,
                             mesh: CellMesh | None = None):
    """Slice-local feqmod smooth spectra (df_mode 3/4): each rank supplies
    surface_columns() of its process_cell_slice (the breakdown chains are
    chosen per group, feqmod.chain_split); returns the full (S, PT, PHI,
    Y) spectra on every rank."""
    if cfg.df_mode not in (3, 4):
        raise ValueError("feqmod multi-host handles df modes 3-4, got "
                         f"{cfg.df_mode}")
    from ..kernels.feqmod import feqmod_reduction
    fn, rep = feqmod_reduction(cols_local, species, grid, df_data, cfg,
                               laguerre)
    return multihost_cell_reduce(fn, cols_local, n_global, rep, cfg, mesh)


def feqmod_spacetime_distributions_multihost(cols_local: dict, n_global: int,
                                             species, grid, df_data,
                                             cfg: Config, laguerre=None,
                                             mesh: CellMesh | None = None
                                             ) -> dict:
    """Slice-local feqmod dN/dX (df_mode 3/4 on VH surfaces): each rank
    supplies dndx_cols() of its process_cell_slice; returns the normalized
    distribution dict on every rank."""
    if cfg.df_mode not in (3, 4) or cfg.mode in (2, 3):
        raise ValueError("feqmod dN/dX multi-host handles df modes 3-4 on "
                         f"VH surfaces, got df_mode={cfg.df_mode} "
                         f"mode={cfg.mode}")
    from ..kernels.dndx import dndx_reduction, dndx_finalize
    fn, rep, grid = dndx_reduction(cols_local, species, grid, df_data, cfg,
                                   laguerre)
    acc = multihost_cell_reduce(fn, cols_local, n_global, rep, cfg, mesh)
    return dndx_finalize(acc, grid, cfg)


# --------------------------------------------------------------- pod mode

def _slice_for(cols: dict, n_global: int, cfg: Config,
               mesh: CellMesh) -> dict:
    """The columns of this rank's process_cell_slice."""
    start, stop = process_cell_slice(cfg, n_global, mesh)
    return {k: v[start:stop] for k, v in cols.items()}


def smooth_spectra_pod(surface, species, grid, df_data, cfg: Config,
                       mesh: CellMesh | None = None):
    """Pod-mode smooth spectra from the full surface (VH df 1-4)."""
    from ..kernels.common import surface_columns
    mesh = global_mesh() if mesh is None else mesh
    cols = surface_columns(surface, cfg)
    n = cols["tau"].shape[0]
    local = _slice_for(cols, n, cfg, mesh)
    if cfg.df_mode in (3, 4):
        return feqmod_spectra_multihost(local, n, species, grid, df_data,
                                        cfg, mesh=mesh)
    return smooth_spectra_multihost(local, n, species, grid, df_data, cfg,
                                    mesh)


def smooth_spectra_vah_pod(surface, species, grid, cfg: Config,
                           mesh: CellMesh | None = None):
    """Pod-mode VAH smooth spectra from the full mode-2/3 surface; the
    gate is decided from the full columns, the same on every rank."""
    from ..kernels.vah import vah_surface_cols, effective_vah_cfg
    mesh = global_mesh() if mesh is None else mesh
    cols = vah_surface_cols(surface)
    cfg = effective_vah_cfg(cols, cfg)
    n = cols["tau"].shape[0]
    return smooth_spectra_vah_multihost(_slice_for(cols, n, cfg, mesh), n,
                                        species, grid, cfg, mesh)


def spin_polarization_pod(surface, species, grid, cfg: Config, plasma,
                          mesh: CellMesh | None = None) -> dict:
    """Pod-mode spin polarization from the full mode-5 surface."""
    from ..kernels.polzn import polzn_cols
    mesh = global_mesh() if mesh is None else mesh
    cols = polzn_cols(surface)
    n = cols["tau"].shape[0]
    return spin_polarization_multihost(_slice_for(cols, n, cfg, mesh), n,
                                       species, grid, cfg, plasma, mesh)


def spacetime_distributions_pod(surface, species, grid, df_data,
                                cfg: Config,
                                mesh: CellMesh | None = None) -> dict:
    """Pod-mode dN/dX from the full surface (VH df 1-4 or VAH mode 2/3;
    the VAH gate from the full columns)."""
    from ..kernels.dndx import dndx_cols
    mesh = global_mesh() if mesh is None else mesh
    cols = dndx_cols(surface, cfg)
    if cfg.mode in (2, 3):
        from ..kernels.vah import effective_vah_cfg
        cfg = effective_vah_cfg(cols, cfg)
    n = cols["tau"].shape[0]
    local = _slice_for(cols, n, cfg, mesh)
    if cfg.df_mode in (3, 4) and cfg.mode not in (2, 3):
        return feqmod_spacetime_distributions_multihost(
            local, n, species, grid, df_data, cfg, mesh=mesh)
    return spacetime_distributions_multihost(local, n, species, grid,
                                             df_data, cfg, mesh)
