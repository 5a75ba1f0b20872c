"""Differentiable Cooper-Frye: gradients of smooth observables with respect
to the freeze-out surface.

Port of ``is3d_tpu.diff`` (its module docstring gives the motivation: one
reverse pass instead of finite differences over full re-runs).  The
forward of every map here is the production path itself, bit for bit; the
reverse pass runs

* on CUDA tensors, the backward kernels: smooth.spectra_bwd_cuda (K1's
  fixed nodes and 2+1D remap, csrc/smooth_spectra_bwd.cu) for the linear-df
  spectra, feqmod.feqmod_bwd_cuda (csrc/feqmod_bwd.cu) for df 3-4,
  vah.vah_bwd_cuda (csrc/vah_bwd.cu) for VAH, polzn.polzn_bwd_cuda
  (csrc/polzn_bwd.cu) for the spin polarization, decays.wave_bwd_cuda
  (csrc/decays_bwd.cu) for the feed-down waves, torch autograd for the
  per-cell and per-slot tensor algebra around them (prepare_cells, the df
  coefficients, the feqmod transform and renormalization, pack_cells,
  pack_polzn_cells, prepare_parents);
* on CPU tensors, torch autograd of the plain versions, each cell chunk
  recomputed in the backward (torch.utils.checkpoint, JAX's remat_scan).

Supported surface maps: spectra_fn on viscous-hydro surfaces (modes 1 and
5) with linear df (df_mode 1-2, K1's backward K9a/K9b) and modified
equilibrium df (df_mode 3-4, K3's backward K10a/K10b,
csrc/feqmod_bwd.cu), and on anisotropic surfaces (modes 2-3, K4's backward
K11a/K11b, csrc/vah_bwd.cu); decayed_spectra_fn, the same through the 2-
and 3-body feed-down; polarization_fn, the spin polarization's dict of
mode-5 surfaces (K6's backward K12a/K12b, csrc/polzn_bwd.cu; T_avg the
plasma's, a constant).  As in is3d_tpu.diff, the df 3-4 forward is the
production smooth_spectra_feqmod (the JAX package disables its breakdown
partition for AD; the port's kernels branch per cell and have none), so a
cell crossing the breakdown threshold switches chains discontinuously and
its gradient is the one-sided derivative of the chain it took.

Non-smooth points inherited from the physics (one-sided derivatives, never
NaN): the |df| <= 1 regulator, the outflow Theta(p.dsigma) cut, the
u.dsigma > 0 cell mask; at a tie the plain version's torch convention
(d max(x, 0)/dx = 1 at x = 0, d clamp(x, -1, 1)/dx = 1 at |x| = 1), where
JAX takes 1/2.

Under ``mesh=`` (a parallel.mesh.CellMesh, is3d_tpu/diff.py:108-207)
the forward runs sharded: each rank launches its own canonical groups and
folds every group's partial (parallel/mesh._GatherFold, whose backward
hands each own partial the output's cotangent).  The cotangent is the same
on every rank (a replicated output, the same loss), so each rank's backward
kernels give the gradient rows of its own cells, and
surface_value_and_grad / surface_vjp all-gather every rank's rows by the
canonical cell ranges (on batch.py's event axis, by event:
parallel.mesh.EventLayout): every rank returns the global gradient, the
one-process one bit for bit.  A bare torch.autograd.grad under a mesh
gives only the rank's own rows.

The observable helpers at the end are torch twins of is3d_tpu.diff's jnp
ones (observables.py is numpy for the writers).
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

from .config import Config
from .data import SpeciesArrays
from .io.tables import MomentumGrid
from .io.deltaf import DeltafData


def _theta(surface, wrt: Iterable[str]) -> dict:
    """The named fields as fresh leaves that require grad; raises on an
    absent (None) field."""
    theta = {}
    for k in wrt:
        v = getattr(surface, k, None)
        if v is None:
            raise ValueError(
                f"cannot differentiate with respect to '{k}': the surface "
                f"does not carry that field (None)")
        theta[k] = v.detach().clone().requires_grad_(True)
    return theta


def _layout(rec: list):
    """The one ShardLayout the forward's sharded reductions ran on (None
    for a one-process forward); raises when they differ."""
    if not rec:
        return None
    if any(r != rec[0] for r in rec[1:]):
        raise ValueError("the sharded reductions of one map must share one "
                         "layout (cell count, groups and mesh)")
    return rec[0]


def _assemble(layout, grads: dict) -> dict:
    return grads if layout is None else layout.assemble(grads)


def surface_value_and_grad(fn: Callable, surface, wrt: Iterable[str]):
    """Value and gradient of ``fn(surface)`` (a scalar tensor) with respect
    to the named ``Surface`` fields.

    Returns ``(value, grads)`` with ``grads`` a dict mapping each name in
    ``wrt`` to a tensor of that field's shape.  Fields not in ``wrt`` are
    constants.  Raises ValueError on fields the surface does not carry
    (None): a gradient with respect to an absent block is a config error,
    not a zero."""
    from .parallel.mesh import recording_layouts
    theta = _theta(surface, tuple(wrt))
    with recording_layouts() as rec, torch.enable_grad():
        value = fn(surface.replace(**theta))
        grads = torch.autograd.grad(value, list(theta.values()),
                                    allow_unused=True)
    return value.detach(), _assemble(_layout(rec), {
        k: torch.zeros_like(v) if g is None else g
        for (k, v), g in zip(theta.items(), grads)})


def surface_vjp(fn: Callable, surface, wrt: Iterable[str]):
    """Forward value plus a pullback on the named surface fields.

    ``fn(surface)`` may return a tensor (e.g. the full (S, PT, PHI, Y)
    spectra) or a dict of tensors (e.g. polarization_fn's).  Returns
    ``(value, pullback)`` where ``pullback(cotangent)`` (shaped like
    ``value``: a tensor, or a dict with a cotangent for each key) gives the
    ``wrt``-keyed gradient dict; it may be called more than once (under a
    mesh on every rank alike: it gathers the ranks' rows)."""
    from .parallel.mesh import recording_layouts
    theta = _theta(surface, tuple(wrt))
    with recording_layouts() as rec, torch.enable_grad():
        value = fn(surface.replace(**theta))
    layout = _layout(rec)
    keys = list(value) if isinstance(value, dict) else None
    outs = [value[k] for k in keys] if keys is not None else [value]

    def pullback(cotangent):
        cts = [cotangent[k] for k in keys] if keys is not None else [
            cotangent]
        pairs = [(o, torch.as_tensor(c, dtype=o.dtype, device=o.device))
                 for o, c in zip(outs, cts) if o.requires_grad]
        if not pairs:
            return _assemble(layout, {k: torch.zeros_like(v)
                                      for k, v in theta.items()})
        grads = torch.autograd.grad([o for o, _ in pairs],
                                    list(theta.values()),
                                    [c for _, c in pairs],
                                    retain_graph=True, allow_unused=True)
        return _assemble(layout, {
            k: torch.zeros_like(v) if g is None else g
            for (k, v), g in zip(theta.items(), grads)})

    if keys is not None:
        return {k: v.detach() for k, v in value.items()}, pullback
    return value.detach(), pullback


def spectra_fn(species: SpeciesArrays, grid: MomentumGrid,
               df_data: DeltafData | None, cfg: Config,
               mesh=None) -> Callable:
    """The differentiable surface -> spectra map for ``cfg``, dispatched as
    the production API (api.py, _smooth_spectra): VAH surfaces (modes 2-3)
    to smooth_spectra_vah, else by df mode to smooth_spectra (1-2) or
    smooth_spectra_feqmod (3-4), so its forward is the production result
    bit for bit.  With ``mesh`` the forward runs sharded over its ranks
    (module docstring)."""
    from .parallel.mesh import check_mesh
    check_mesh(mesh)
    if cfg.mode in (2, 3):
        def fn(surface):
            from .kernels.vah import smooth_spectra_vah
            return smooth_spectra_vah(surface, species, grid, cfg, mesh=mesh)
        return fn
    if cfg.df_mode in (3, 4):
        def fn(surface):
            from .kernels.feqmod import smooth_spectra_feqmod
            return smooth_spectra_feqmod(surface, species, grid, df_data,
                                         cfg, mesh=mesh)
        return fn
    if cfg.df_mode not in (1, 2):
        raise ValueError(f"df_mode must be 1-4, got {cfg.df_mode}")

    def fn(surface):
        from .kernels.smooth import smooth_spectra
        return smooth_spectra(surface, species, grid, df_data, cfg,
                              mesh=mesh)
    return fn


def decayed_spectra_fn(species: SpeciesArrays, grid: MomentumGrid,
                       df_data: DeltafData | None, cfg: Config,
                       table, mcids, mesh=None) -> Callable:
    """The differentiable surface -> post-feed-down spectra map: spectra_fn
    composed with the 2- and 3-body cascade
    (kernels.decays.resonance_feed_down_traced), whose forward is
    do_resonance_decays' bit for bit.  ``species`` rows, ``mcids`` and the
    spectra's rows are in chosen-particle order (as the API makes them);
    ``table`` is the full particle table (the decay channels)."""
    base = spectra_fn(species, grid, df_data, cfg, mesh=mesh)

    def fn(surface):
        from .kernels.decays import resonance_feed_down_traced
        return resonance_feed_down_traced(base(surface), table, mcids, grid,
                                          cfg)
    return fn


def polarization_fn(species: SpeciesArrays, grid: MomentumGrid,
                    cfg: Config, plasma, mesh=None) -> Callable:
    """The differentiable surface -> polarization-dict map (mode 5):
    spin_polarization's St, Sx, Sy, Sn, Snorm and S*_over_Snorm, whose
    forward is the production result bit for bit, with gradients with
    respect to the thermal vorticity (wtx..wyn), the flow, dsigma, tau (and
    eta in 3+1D).  ``plasma.temperature`` is T_avg, a constant, as in
    is3d_tpu.diff.  With ``mesh`` the forward runs sharded over its ranks
    (module docstring)."""
    from .parallel.mesh import check_mesh
    check_mesh(mesh)

    def fn(surface):
        from .kernels.polzn import spin_polarization
        return spin_polarization(surface, species, grid, cfg, plasma,
                                 mesh=mesh)
    return fn


# ------------------------------------------------- differentiable observables
# torch twins of is3d_tpu.diff's dN_dy_j, mean_pT_j, vn_j (same contractions,
# same reference citations)

def dN_dy_j(spectra, grid: MomentumGrid,
            include_pT_jacobian: bool = True) -> torch.Tensor:
    """(S, PT, PHI, Y) -> (S, Y) transverse-momentum integral
    (observables.dN_dy, reference emissionfunction.cpp:745-768)."""
    pw = grid.pT_weight
    w = pw * grid.pT if include_pT_jacobian else pw
    return torch.einsum("spfy,p,f->sy", spectra, w, grid.phi_weight)


def mean_pT_j(spectra, grid: MomentumGrid) -> torch.Tensor:
    """(S, Y) mean transverse momentum (observables.mean_pT)."""
    num = torch.einsum("spfy,p,f->sy", spectra,
                       grid.pT_weight * grid.pT ** 2, grid.phi_weight)
    den = dN_dy_j(spectra, grid)
    return num / torch.where(den == 0.0, torch.ones_like(den), den)


def vn_j(spectra, grid: MomentumGrid, n: int) -> torch.Tensor:
    """pT-integrated |v_n|(y), shape (S, Y) (observables.continuous_vn
    integrated over pT; reference emissionfunction.cpp:1053-1136).  The
    magnitude sqrt(re^2 + im^2) takes the double-where guard, so a bin
    where the harmonic vanishes identically has gradient 0, not NaN."""
    w = grid.pT_weight * grid.pT
    wc = torch.cos(n * grid.phi) * grid.phi_weight
    ws = torch.sin(n * grid.phi) * grid.phi_weight
    re = torch.einsum("spfy,p,f->sy", spectra, w, wc)
    im = torch.einsum("spfy,p,f->sy", spectra, w, ws)
    den = dN_dy_j(spectra, grid)
    r2 = re * re + im * im
    pos = r2 > 0.0
    mag = torch.where(pos, torch.sqrt(torch.where(pos, r2,
                                                  torch.ones_like(r2))),
                      torch.zeros_like(r2))
    return mag / torch.where(den == 0.0, torch.ones_like(den), den)
