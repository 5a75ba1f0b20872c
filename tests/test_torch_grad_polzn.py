"""is3d_tpu_torch.diff.polarization_fn against is3d_tpu.diff.polarization_fn
on the CPU in float64: the gradient of the spin polarization's nine
outputs (St, Sx, Sy, Sn, Snorm and the four S*_over_Snorm) with respect to
the surface, through the plain torch version's autograd (each cell chunk
checkpointed) on one side and jax.vjp on the other.

Inputs are made with numpy from a seed (testing.synthetic_surface_cells,
testing.synthetic_vorticity) and carried to the port through
is3d_tpu_torch.convert.  Cases: 3+1D, 2+1D fixed nodes and the 2+1D mT
remap, each with respect to the vorticity wtx..wyn, the flow ux, uy, un,
dsigma dat..dan and tau (and eta in 3+1D), with a cotangent on all nine
outputs; a 3+1D grid whose outer rapidities give Snorm == 0 exactly (the
S/Snorm guard), and one whose Snorm^2 also underflows in some bins (JAX's
NaN where README's decided difference says, the port's finite gradient
against JAX's reverse of the five sums and central differences); a
massless species, whose NaN and inf must sit where JAX's do; central differences of sum Sy_over_Snorm; the batched
polarization under grad against each event's own gradient; mesh= refused.

Tolerance: both sides in f64 take the same derivatives through the same
algebra in another order, so they agree to ~1e-14; rtol 1e-8 / atol 1e-10
x max|grad| of each field (tests/test_torch_grad.py's bar).  Central
differences as tests/test_grad.py: rtol 5e-5.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from is3d_tpu import diff as jdiff
from is3d_tpu import testing as jtesting
from is3d_tpu.config import Config as JConfig
from is3d_tpu.io.surface import Surface as JSurface, ThermoAverages as JAvg
from is3d_tpu.io.tables import native_momentum_grid as j_native_grid

from is3d_tpu_torch import batch, convert, diff, testing
from is3d_tpu_torch.config import Config
from is3d_tpu_torch.kernels.polzn import spin_polarization

from test_torch_polzn import assert_same
from test_torch_smooth import jax_state

torch.set_num_threads(1)

RTOL = 1e-8
ATOL_REL = 1e-10
N_CELLS = 24
WRT = ("wtx", "wty", "wtn", "wxy", "wxn", "wyn", "ux", "uy", "un", "dat",
       "dax", "day", "dan", "tau")
# path: (dimension, remap, grid overrides).  "3d_snorm_zero": its outer
# rapidities (+-12) overflow every exponential, so Snorm there is exactly
# 0 and no bin holds a Snorm so small that its square underflows.
# "3d_snorm_underflow" adds y = +-6, where some bins' Snorm^2 lies below
# float64's smallest normal: XLA flushes it to 0, so JAX's reverse of
# S / Snorm forms S / Snorm^2 = S / 0, while torch's (S / Snorm) / Snorm
# stays finite (test_snorm_underflow_against_jax_and_central_differences)
PATHS = {"3d": (3, False, {}), "2d_fixed": (2, False, {}),
         "2d_remap": (2, True, {}),
         "3d_snorm_zero": (3, False, dict(n_y=3, y_max=12.0)),
         "3d_snorm_underflow": (3, False, dict(n_y=5, y_max=12.0))}
# the fields Snorm depends on (the vorticity enters only St..Sn)
SNORM_FIELDS = ("tau", "eta", "ux", "uy", "un", "dat", "dax", "day", "dan")
SUMS = ("St", "Sx", "Sy", "Sn", "Snorm")
PLASMA = JAvg(0.152, 0.3, 0.05, 0.0, 0.0)


def _inputs(path, massless=False):
    """(cells, cfg kwargs, JAX grid, JAX species, wrt) of a case."""
    dimension, remap, grid_kw = PATHS[path]
    cells = jtesting.synthetic_surface_cells(N_CELLS, dimension, 3)
    cells.update(testing.synthetic_vorticity(N_CELLS, 3))
    jgrid = j_native_grid(dimension=dimension, **dict(
        dict(n_pT=4, n_phi=4, n_y=3, n_eta=6), **grid_kw),
        eta_mT_rescale=remap)
    jsp = jtesting.synthetic_species(n_species=4)
    if massless:
        jsp = jsp.replace(mass=jsp.mass.at[2].set(0.0))
    wrt = WRT + (("eta",) if dimension == 3 else ())
    return cells, dict(mode=5, dimension=dimension, cell_chunk=8), jgrid, \
        jsp, wrt


def _port(cells, cfg_kw, jgrid, jsp):
    """The port's (surface, species, grid, cfg, plasma) of a case."""
    return (convert.surface_from_state(cells),
            convert.species_from_state(jax_state(jsp)),
            convert.grid_from_state(jax_state(jgrid)), Config(**cfg_kw),
            convert.averages_from_state(dataclasses.asdict(PLASMA)))


def _cotangents(value: dict) -> dict:
    """A numpy-seeded cotangent on every output (positive weights)."""
    rng = np.random.default_rng(41)
    return {k: rng.uniform(0.5, 1.5, np.shape(value[k]))
            for k in sorted(value)}


def _jax_pullback(path, massless=False, outputs=None):
    """(value, pullback) of jax.vjp of is3d_tpu's polarization_fn (its
    ``outputs`` alone if given), numpy in and out."""
    cells, cfg_kw, jgrid, jsp, wrt = _inputs(path, massless)
    fn = jdiff.polarization_fn(jsp, jgrid, JConfig(**cfg_kw), PLASMA)
    if outputs is not None:
        full = fn
        fn = lambda s: {k: full(s)[k] for k in outputs}
    jsurf = JSurface(**{k: jnp.asarray(v) for k, v in cells.items()})
    value, pull = jdiff.surface_vjp(fn, jsurf, wrt)
    return ({k: np.asarray(v) for k, v in value.items()},
            lambda cts: {k: np.asarray(v) for k, v in pull(
                {k: jnp.asarray(c) for k, c in cts.items()}).items()})


@functools.lru_cache(maxsize=None)
def _jax_vjp(path, massless=False):
    """(value, cotangents, gradients) of jax.vjp of is3d_tpu's
    polarization_fn, as numpy."""
    value, pull = _jax_pullback(path, massless)
    cts = _cotangents(value)
    return value, cts, pull(cts)


def _port_vjp(path, massless=False):
    cells, cfg_kw, jgrid, jsp, wrt = _inputs(path, massless)
    surf, sp, grid, cfg, plasma = _port(cells, cfg_kw, jgrid, jsp)
    fn = diff.polarization_fn(sp, grid, cfg, plasma)
    value, pull = diff.surface_vjp(fn, surf, wrt)
    cts = _jax_vjp(path, massless)[1]
    grads = pull({k: torch.as_tensor(v) for k, v in cts.items()})
    prod = spin_polarization(surf, sp, grid, cfg, plasma)
    return value, grads, prod


@pytest.mark.parametrize("path", ["2d_fixed", "2d_remap", "3d",
                                  "3d_snorm_zero"])
def test_polarization_vjp_matches_jax(path):
    """surface_vjp of the port's polarization_fn against jax.vjp of
    is3d_tpu's, a cotangent on all nine outputs; the forward is
    spin_polarization's bit for bit and JAX's at the forward's bar."""
    want_value, _, want = _jax_vjp(path)
    value, grads, prod = _port_vjp(path)
    assert sorted(value) == sorted(want_value) == sorted(prod)
    for k in value:
        assert torch.equal(value[k], prod[k]), k
        assert_same(value[k].numpy(), want_value[k])
    zero = int((value["Snorm"] == 0).sum())
    assert (zero > 0) == (path == "3d_snorm_zero"), zero
    assert sorted(grads) == sorted(want)
    for k, w in want.items():
        g = grads[k].numpy()
        assert np.isfinite(g).all() and np.abs(w).max() > 0, k
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=ATOL_REL * np.abs(w).max(),
                                   err_msg=k)


def test_snorm_underflow_against_jax_and_central_differences():
    """Where Snorm != 0 but Snorm^2 lies below float64's smallest normal,
    JAX's gradient is NaN in every entry of every field Snorm depends on
    (SNORM_FIELDS), even with a zero cotangent on those bins, and finite
    and the port's at the bar in the vorticity's.  The port's is finite
    everywhere: it equals JAX's reverse of the five sums alone with the
    division's reverse, (S / Snorm) / Snorm, chained in numpy, at the bar,
    and central differences of the underflowing bins' S*_over_Snorm."""
    path = "3d_snorm_underflow"
    _, cts, want = _jax_vjp(path)
    value, grads, _ = _port_vjp(path)
    snorm = value["Snorm"].numpy()
    under = (snorm != 0) & (snorm ** 2 < np.finfo(np.float64).tiny)
    assert under.any() and (snorm == 0).any()
    masked = {k: np.where(under, 0.0, c) if k.endswith("_over_Snorm")
              else c for k, c in cts.items()}
    want_masked = _jax_pullback(path)[1](masked)
    for k, w in want.items():
        assert np.isfinite(grads[k].numpy()).all(), k
        if k in SNORM_FIELDS:
            assert np.isnan(w).all() and np.isnan(want_masked[k]).all(), k
        else:
            assert np.isfinite(w).all(), k
            np.testing.assert_allclose(grads[k].numpy(), w, rtol=RTOL,
                                       atol=ATOL_REL * np.abs(w).max(),
                                       err_msg=k)
    # JAX's reverse of the five sums, the division's reverse in numpy
    sums, pull = _jax_pullback(path, outputs=SUMS)
    zero = snorm == 0
    safe = np.where(zero, 1.0, snorm)
    ct = {k: cts[k].copy() for k in SUMS}
    for c in "txyn":
        r = cts[f"S{c}_over_Snorm"]
        ct[f"S{c}"] += r / safe
        ct["Snorm"] -= np.where(zero, 0.0, r * (sums[f"S{c}"] / safe) / safe)
    ref = pull(ct)
    for k, w in ref.items():
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=RTOL,
                                   atol=ATOL_REL * np.abs(w).max(),
                                   err_msg=k)
    # central differences: the underflowing bins' ratios, by the fields of
    # the cell whose terms dominate them (the others' gradients there lie
    # below the differences' resolution)
    cells, cfg_kw, jgrid, jsp, wrt = _inputs(path)
    surf, sp, grid, cfg, plasma = _port(cells, cfg_kw, jgrid, jsp)
    fn = diff.polarization_fn(sp, grid, cfg, plasma)
    mask = torch.as_tensor(under)
    scalar = lambda s: sum((fn(s)[f"S{c}_over_Snorm"] * mask).sum()
                           for c in "txyn")
    _, g = diff.surface_value_and_grad(scalar, surf, wrt)
    cell = int(g["eta"].abs().argmax())
    for k in ("eta", "tau", "wxy", "wtx"):
        x = getattr(surf, k)
        eps = 1e-6 * max(1.0, abs(float(x[cell])))
        hot = torch.zeros_like(x)
        hot[cell] = eps
        with torch.no_grad():
            fd = (float(scalar(surf.replace(**{k: x + hot})))
                  - float(scalar(surf.replace(**{k: x - hot})))) / (2 * eps)
        assert fd != 0.0, k
        np.testing.assert_allclose(float(g[k][cell]), fd, rtol=5e-5,
                                   err_msg=k)


@pytest.mark.parametrize("path", ["3d", "2d_fixed", "2d_remap"])
def test_massless_nonfinite_positions_match_jax(path):
    """A massless species (pm = -0.25/m = -inf) puts NaN or inf into the
    gradient where JAX's reverse does (0 x -inf = NaN in g_meas = g_mp
    pref); the finite entries agree at the bar."""
    want_value, _, want = _jax_vjp(path, True)
    value, grads, _ = _port_vjp(path, True)
    assert not np.isfinite(want_value["St"]).all()
    bad = 0
    for k, w in want.items():
        g = grads[k].numpy()
        for f in (np.isnan, np.isposinf, np.isneginf):
            np.testing.assert_array_equal(f(g), f(w), err_msg=k)
        fin = np.isfinite(w)
        bad += int((~fin).sum())
        if fin.any():
            np.testing.assert_allclose(
                g[fin], w[fin], rtol=RTOL,
                atol=ATOL_REL * max(np.abs(w[fin]).max(), 1e-300),
                err_msg=k)
    assert bad > 0


@pytest.mark.parametrize("path", ["3d", "2d_fixed", "2d_remap"])
def test_value_and_grad_matches_central_differences(path):
    """surface_value_and_grad of sum Sy_over_Snorm (the first species'
    row, tests/test_grad.py's observable) against central differences."""
    cells, cfg_kw, jgrid, jsp, _ = _inputs(path)
    surf, sp, grid, cfg, plasma = _port(cells, cfg_kw, jgrid, jsp)
    fn = diff.polarization_fn(sp, grid, cfg, plasma)
    scalar = lambda s: fn(s)["Sy_over_Snorm"][0].sum()
    picks = [("wtx", 3), ("wxn", 5), ("ux", 7), ("dat", 2), ("tau", 11)] + (
        [("eta", 4)] if cfg.dimension == 3 else [])
    _, grads = diff.surface_value_and_grad(scalar, surf,
                                           [k for k, _ in picks])
    for k, i in picks:
        x = getattr(surf, k)
        eps = 1e-6 * max(1.0, abs(float(x[i])))
        hot = torch.zeros_like(x)
        hot[i] = eps
        with torch.no_grad():
            fd = (float(scalar(surf.replace(**{k: x + hot})))
                  - float(scalar(surf.replace(**{k: x - hot})))) / (2 * eps)
        np.testing.assert_allclose(float(grads[k][i]), fd, rtol=5e-5,
                                   err_msg=k)


def test_batched_polarization_gradients_are_single_runs():
    """polarization_batched under grad: each event's gradient is its own
    polarization_fn's bit for bit, and the pad cells' is exactly 0."""
    cells, cfg_kw, jgrid, jsp, _ = _inputs("2d_remap")
    _, sp, grid, cfg, _ = _port(cells, cfg_kw, jgrid, jsp)
    surfaces = []
    for seed, n in ((1, 9), (2, 14)):
        c = dict(testing.synthetic_surface_cells(n, 2, seed),
                 **testing.synthetic_vorticity(n, seed))
        surfaces.append(convert.surface_from_state(c))
    T_avg = [0.151, 0.158]
    wrt = ("wtx", "wxn", "ux", "dat")
    stacked = batch.stack_surfaces(surfaces)
    theta = {k: getattr(stacked, k).clone().requires_grad_(True)
             for k in wrt}
    loss = lambda out: out["Sy_over_Snorm"].sum() + out["Snorm"].sum()
    with torch.enable_grad():
        out = batch.polarization_batched(stacked.replace(**theta), sp, grid,
                                         cfg, T_avg)
        grads = torch.autograd.grad(loss(out), list(theta.values()))
    for e, s in enumerate(surfaces):
        plasma = dataclasses.make_dataclass(
            "P", [("temperature", float)])(T_avg[e])
        _, want = diff.surface_value_and_grad(
            lambda x: loss(diff.polarization_fn(sp, grid, cfg, plasma)(x)),
            s, wrt)
        n = s.n_cells
        for k, g in zip(wrt, grads):
            assert want[k].abs().max() > 0, k
            assert torch.equal(g[e, :n], want[k]), k
            assert (g[e, n:] == 0).all(), k


def test_polarization_fn_refuses_mesh(tmp_path):
    """polarization_fn(mesh=) raised until slice 11a ported it: on 2 gloo
    ranks every rank's value, gradient (surface_value_and_grad) and
    surface_vjp pullback equal the one-process ones bit for bit, from the
    same cotangent bits on both ranks (the one-process gradient is held to
    jax.vjp above); a mesh that is not a CellMesh raises TypeError."""
    cells, cfg_kw, jgrid, jsp, wrt = _inputs("3d")
    surf, sp, grid, cfg, plasma = _port(cells, cfg_kw, jgrid, jsp)
    case = dict(kind="polzn", surface=surf, species=sp, grid=grid, cfg=cfg,
                plasma=plasma)
    path = str(tmp_path / "case.pt")
    torch.save({"polzn": case}, path)
    want = testing.mesh_grad(case, wrt)
    ranks = testing.run_ranks(testing.mesh_grad_rank, 2, str(tmp_path),
                              args=(path, "polzn", wrt), timeout=240.0)
    for r, got in enumerate(ranks):
        for k in got["cotangent"]:
            assert torch.equal(got["cotangent"][k],
                               ranks[0]["cotangent"][k]), k
        assert torch.equal(got["value"], want["value"])
        assert sum(bool(g.abs().max() > 0)
                   for g in want["grads"].values()) >= len(wrt) // 2
        for k in wrt:
            assert torch.equal(got["grads"][k], want["grads"][k]), (r, k)
            assert torch.equal(got["vjp"][k], want["vjp"][k]), (r, k)
    with pytest.raises(TypeError, match="CellMesh"):
        diff.polarization_fn(sp, grid, cfg, plasma, mesh=object())
