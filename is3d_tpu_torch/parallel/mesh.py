"""The canonical cell-reduction tree, single device.

Bit-stability contract (BASELINE.md): the cell reduction runs over a
CANONICAL GROUP TREE that is a function of the global surface size and
config only.  The padded cell axis is cut into G groups at global
boundaries; each group is reduced by one kernel call, and the G group
partials are combined by a SEQUENTIAL left fold in group order
(elementwise adds -- value-deterministic).  Multi-GPU runs (a later slice)
change only where the group partials are computed, not the fold.
"""

from __future__ import annotations

import torch

from ..config import Config
from ..kernels.common import pad_and_chunk


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


def grouped_cell_reduce(kernel_fn, cols: dict, replicated: tuple,
                        cfg: Config):
    """Reduce ``kernel_fn(cols_group, *replicated)`` -- a tensor, or a dict
    of accumulator tensors -- over the cell axis through the canonical group
    tree: one call per group, every leaf folded in group order."""
    n = cols["tau"].shape[0]
    G, gs = canonical_groups(cfg, n)
    cols = _pad_inert(cols, G * gs)
    acc = None
    for g in range(G):
        sub = {k: v[g * gs:(g + 1) * gs] for k, v in cols.items()}
        acc = _fold(acc, kernel_fn(sub, *replicated))
    return acc
