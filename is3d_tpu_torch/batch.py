"""Ensembles of freeze-out surfaces: one call for many events.

Port of ``is3d_tpu.batch`` (its docstring gives the use: event-by-event
hydro, thousands of surfaces per centrality bin).  JAX stacks the ensemble
on an event axis and vmaps the kernels into one program; here each event
runs the single-surface path (the same kernels, one launch per canonical
group), so a batched row is the single run of its surface bit for bit
(is3d_tpu only reaches <= 1e-12 there, its vmapped program being another
compilation).

Padding contract: ``stack_surfaces`` pads every event to a common cell
count with the inert fills of kernels/common.PAD_ONE_COLUMNS (tau, T, E,
P, Lambda, aL = 1, everything else 0) and records each event's own count;
the batched maps run each event on its own cells, so the padding never
enters a sum and its gradient is exactly 0.  A stacked surface built
without counts (any (E, C) Surface) runs every row whole.

Gradients flow through the batched spectra of every surface and df mode
(diff.spectra_fn's maps) and through the batched polarization
(diff.polarization_fn's map): a loss summed over the ensemble
differentiates in one reverse pass.

Event axis over ranks (``mesh=``, a parallel.mesh.CellMesh; port of
is3d_tpu/batch.py:176-249): rank r runs the events [r E / W, (r + 1) E /
W), each through the single-surface path with no cell collective, and the
ranks all-gather their rows in event order, so every rank returns the
one-process (E, ...) result bit for bit.  E must divide by W (pad with
``empty_like_surface``).  Under autograd the gather's backward hands each
rank its own events' cotangent rows (``_GatherEvents``), and
diff.surface_value_and_grad / surface_vjp assemble each rank's gradient
rows of the stacked columns by event (parallel.mesh.EventLayout): every
rank holds the one-process gradient bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
import types
from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from .config import Config
from .data import SpeciesArrays
from .io.surface import Surface
from .io.tables import MomentumGrid
from .io.deltaf import DeltafData
from .kernels.common import PAD_ONE_COLUMNS
from .parallel import mesh as pmesh


@dataclass(frozen=True)
class StackedSurface(Surface):
    """A Surface with (E, C) leaves and each event's own cell count."""

    counts: tuple = ()


def _fields():
    return [f.name for f in dataclasses.fields(Surface)]


def stack_surfaces(surfaces: Sequence[Surface], pad_to: int | None = None,
                   dtype=None) -> StackedSurface:
    """Stack an ensemble into one StackedSurface with (E, C) leaves.

    Surfaces may have different cell counts; each is padded to ``pad_to``
    (default: the largest count) with the inert fills (module docstring).
    Every surface must carry the same optional blocks (a field present on
    some events and absent on others raises ValueError), and every column
    is cast to ``dtype`` (default: the first surface's)."""
    if not surfaces:
        raise ValueError("stack_surfaces needs at least one surface")
    n_max = max(s.n_cells for s in surfaces)
    if pad_to is None:
        pad_to = n_max
    if pad_to < n_max:
        raise ValueError(f"pad_to={pad_to} < largest surface ({n_max} cells)")
    if dtype is None:
        dtype = surfaces[0].tau.dtype
    device = surfaces[0].tau.device
    out = {}
    for name in _fields():
        vals = [getattr(s, name) for s in surfaces]
        have = [v is not None for v in vals]
        if not any(have):
            out[name] = None
            continue
        if not all(have):
            raise ValueError(
                f"cannot stack: field '{name}' is present on some surfaces "
                f"and None on others")
        fill = 1.0 if name in PAD_ONE_COLUMNS else 0.0
        cols = []
        for v in vals:
            v = torch.as_tensor(v).to(device=device, dtype=dtype)
            pad = pad_to - v.shape[0]
            if pad:
                v = torch.cat([v, v.new_full((pad,), fill)])
            cols.append(v)
        out[name] = torch.stack(cols)
    return StackedSurface(**out, counts=tuple(s.n_cells for s in surfaces))


def event(stacked: Surface, e: int) -> Surface:
    """Event ``e`` of a stacked surface as a Surface of its own cells."""
    counts = getattr(stacked, "counts", ())
    n = counts[e] if counts else stacked.tau.shape[1]
    return Surface(**{name: None if getattr(stacked, name) is None
                      else getattr(stacked, name)[e, :n]
                      for name in _fields()})


def _single_fn(species: SpeciesArrays, grid: MomentumGrid,
               df_data: DeltafData | None, cfg: Config) -> Callable:
    """The single-surface spectra map of the API's dispatch (api.py,
    _smooth_spectra): VAH surfaces (modes 2-3), else by df mode."""
    if cfg.mode in (2, 3):
        from .kernels.vah import smooth_spectra_vah
        return lambda s: smooth_spectra_vah(s, species, grid, cfg)
    if cfg.df_mode in (1, 2):
        from .kernels.smooth import smooth_spectra
        return lambda s: smooth_spectra(s, species, grid, df_data, cfg)
    from .kernels.feqmod import smooth_spectra_feqmod
    return lambda s: smooth_spectra_feqmod(s, species, grid, df_data, cfg)


def batched_spectra_fn(species: SpeciesArrays, grid: MomentumGrid,
                       df_data: DeltafData | None, cfg: Config,
                       mesh=None) -> Callable:
    """The stacked-surface -> (E, S, PT, PHI, Y) spectra map.  Every surface
    mode and df mode runs forward, and gradients flow through each (the
    maps of diff.spectra_fn).  Each event runs alone, so no memory budget
    depends on the event count (is3d_tpu's n_events); with ``mesh`` whole
    events a rank (module docstring)."""
    pmesh.check_mesh(mesh)
    one = _single_fn(species, grid, df_data, cfg)

    def fn(stacked):
        return _event_sharded(lambda e: one(event(stacked, e)), stacked,
                              mesh)
    return fn


def event_layout(n_events: int, mesh) -> pmesh.EventLayout:
    """The event layout of an E-event ensemble on ``mesh``: whole events,
    E / W a rank; an E that W does not divide raises ValueError."""
    if n_events % mesh.size:
        raise ValueError(
            f"event count {n_events} does not divide the {mesh.size}-rank "
            f"mesh; pad the ensemble (stack_surfaces with empty_like_surface "
            f"throwaway events) to a multiple of {mesh.size}")
    return pmesh.EventLayout(mesh, n_events)


class _GatherEvents(torch.autograd.Function):
    """All-gather the ranks' event rows in event order: inputs the layout,
    the rows' spec (parallel.mesh._PartSpec of one event) and this rank's
    leaves, each (E / W, ...); outputs the (E, ...) leaves.  The backward
    hands each own leaf its events' rows of the output's cotangent."""

    @staticmethod
    def forward(ctx, layout, spec, *own):
        per = layout.per
        send = torch.cat([t.reshape(per, -1) for t in own], dim=1)
        rows = pmesh._all_gather_rows(send, layout.mesh)
        out, at = [], 0
        for shape in spec.shapes:
            w = math.prod(shape)
            out.append(rows[:, at:at + w].reshape((-1,) + shape)
                       .contiguous())
            at += w
        ctx.lo, ctx.hi = layout.owned()
        return tuple(out)

    @staticmethod
    def backward(ctx, *cts):
        return (None, None) + tuple(c[ctx.lo:ctx.hi] for c in cts)


def gather_events(own, layout: pmesh.EventLayout):
    """This rank's event rows (a tensor or a dict of tensors, each (E / W,
    ...)) gathered over the ranks into the (E, ...) result, in event
    order, on every rank; differentiable."""
    spec = pmesh._PartSpec.of({k: v[0] for k, v in own.items()}
                              if isinstance(own, dict) else own[0])
    return spec.build(list(_GatherEvents.apply(layout, spec,
                                               *spec.leaves(own))))


def _event_sharded(one: Callable, stacked: Surface, mesh):
    """``one(e)`` of every event of the ensemble, stacked on the event
    axis: all E in one process, or over the mesh's ranks (module
    docstring); ``one`` returns a tensor or a dict of tensors."""
    E = stacked.tau.shape[0]
    if mesh is None or mesh.size == 1:
        rows = [one(e) for e in range(E)]
    else:
        if stacked.tau.device != mesh.device:
            raise ValueError(f"the ensemble is on {stacked.tau.device}, "
                             f"the mesh's rank on {mesh.device}")
        layout = event_layout(E, mesh)
        if pmesh._RECORDERS:
            pmesh._RECORDERS[-1].append(layout)
        rows = [one(e) for e in range(*layout.owned())]
    if isinstance(rows[0], dict):
        own = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    else:
        own = torch.stack(rows)
    if mesh is None or mesh.size == 1:
        return own
    return gather_events(own, layout)


def smooth_spectra_batched(stacked: Surface, species: SpeciesArrays,
                           grid: MomentumGrid, df_data: DeltafData | None,
                           cfg: Config, mesh=None) -> torch.Tensor:
    """Spectra of a stacked ensemble, (E, S, n_pT, n_phi, n_y_out), each
    row the single run of its event; with ``mesh`` whole events a rank
    (module docstring)."""
    return batched_spectra_fn(species, grid, df_data, cfg, mesh)(stacked)


def polarization_batched(stacked: Surface, species: SpeciesArrays,
                         grid: MomentumGrid, cfg: Config, T_avg,
                         mesh=None) -> dict:
    """Spin polarization (mode-5 surfaces) of a stacked ensemble: the dict
    of spin_polarization's outputs with a leading event axis, each event at
    its own T_avg ((E,) or one value for all, constants).  Gradients flow
    to the stacked surface's columns, each event's those of its single
    run."""
    from .kernels.polzn import spin_polarization
    pmesh.check_mesh(mesh)
    E = stacked.tau.shape[0]
    T = torch.as_tensor(T_avg, dtype=torch.float64).reshape(-1)
    T = T.expand(E) if T.numel() == 1 else T
    return _event_sharded(
        lambda e: spin_polarization(
            event(stacked, e), species, grid, cfg,
            types.SimpleNamespace(temperature=float(T[e]))), stacked, mesh)


def empty_like_surface(surface: Surface) -> Surface:
    """A throwaway event: the same blocks and cell count as ``surface``,
    every dsigma component zero (so every cell fails the u.dsigma > 0 mask
    and its spectra are exact zeros), the inert fills elsewhere."""
    def fill(name, v):
        if v is None:
            return None
        return (torch.ones_like(v) if name in PAD_ONE_COLUMNS
                else torch.zeros_like(v))
    return Surface(**{name: fill(name, getattr(surface, name))
                      for name in _fields()})
