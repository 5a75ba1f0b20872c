"""is3d_tpu_torch.diff against is3d_tpu.diff on the CPU in float64: the
gradients of the modified-equilibrium spectra (df 3 "Mike", df 4 "Jonah")
with respect to the freeze-out surface, and of the same through the
resonance feed-down.

Inputs are made with numpy from a seed (is3d_tpu_torch.testing's cells,
the shear x 0.3 and the bulk x 0.01, so that some cells break down and
most do not) and carried to both packages; the JAX gradients are computed
once, in one module-scoped fixture.  Tolerance: rtol 1e-8 / atol 1e-10 x
max|grad| of each field, as tests/test_torch_grad.py (both sides in f64
take the same derivatives; the port sums |x|^2 as squares where JAX
expands the quadratic form, ~1e-12 apart here).  The finite-difference
checks take central differences at rtol 5e-5.

* spectra_fn for df 3 and df 4 in 3+1D and 2+1D (fixed nodes and the mT
  remap), clean and broken-down cells in one surface; the forward is
  smooth_spectra_feqmod's bit for bit;
* decayed_spectra_fn with df 3 on the decaying list (2+1D).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from is3d_tpu import diff as jdiff
from is3d_tpu import testing as jtesting
from is3d_tpu.config import Config as JConfig
from is3d_tpu.data import species_from_table as j_species_from_table
from is3d_tpu.io.surface import Surface as JSurface
from is3d_tpu.io.tables import native_momentum_grid as j_native_grid

from is3d_tpu_torch import convert, diff, testing
from is3d_tpu_torch.config import Config
from is3d_tpu_torch.data import species_from_table
from is3d_tpu_torch.io.tables import laguerre_device
from is3d_tpu_torch.kernels import feqmod
from is3d_tpu_torch.kernels.common import surface_columns

from test_torch_grad import (DECAY_GRID, VISC, _close, _decaying, _scalar,
                             _scalar_jax)
from test_torch_smooth import jax_state

torch.set_num_threads(1)

GRID = dict(n_pT=5, n_phi=4, n_y=3, n_eta=6)
N_CELLS, N_SPECIES = 24, 3
CASES = {
    "df3_3d": (dict(dimension=3, df_mode=3), {}),
    "df3_2d_fixed": (dict(dimension=2, df_mode=3),
                     dict(eta_mT_rescale=False)),
    "df4_3d": (dict(dimension=3, df_mode=4), {}),
    "df4_2d_remap": (dict(dimension=2, df_mode=4), {}),
}
# the cases held to JAX (one compilation each, the most of this file's
# time): df 3 in 3+1D and 2+1D fixed nodes, df 4 with the mT remap
JAX_CASES = ("df3_3d", "df3_2d_fixed", "df4_2d_remap")
WRT = ("T", "ux", "uy", "un", "bulkPi", "pixx", "pixy", "pixn", "piyy",
       "piyn", "dat", "dax", "day", "dan", "tau", "E", "P")


def _cells(dimension: int, seed: int = 3, n: int = N_CELLS,
           shear: float = 0.3) -> dict:
    cells = testing.synthetic_surface_cells(n, dimension, seed)
    for k in ("pixx", "pixy", "pixn", "piyy", "piyn"):
        cells[k] = cells[k] * shear
    cells["bulkPi"] = cells["bulkPi"] * 0.01
    return cells


def _wrt(dimension: int) -> tuple:
    return WRT + (("eta",) if dimension == 3 else ())


def _inputs(name):
    """(JAX inputs, port inputs) of a case."""
    cfg_kw, grid_kw = CASES[name]
    cfg_kw = dict(cfg_kw, operation=1, mode=1, **VISC)
    jgrid = j_native_grid(dimension=cfg_kw["dimension"],
                          **dict(GRID, **grid_kw))
    jsp = jtesting.synthetic_species(n_species=N_SPECIES)
    jdf = jtesting.synthetic_deltaf_data()
    port = (convert.species_from_state(jax_state(jsp)),
            convert.grid_from_state(jax_state(jgrid)),
            convert.deltaf_from_state(jax_state(jdf)), Config(**cfg_kw))
    return (jsp, jgrid, jdf, JConfig(**cfg_kw)), port


@pytest.fixture(scope="module")
def jax_grads():
    """is3d_tpu's value and gradients of the observable for every case."""
    out = {}
    for name in JAX_CASES:
        cfg_kw = CASES[name][0]
        cells = _cells(cfg_kw["dimension"])
        (jsp, jgrid, jdf, jcfg), _ = _inputs(name)
        smap = jdiff.spectra_fn(jsp, jgrid, jdf, jcfg)
        obs = _scalar_jax(jgrid)
        value, grads = jdiff.surface_value_and_grad(
            lambda s: obs(smap(s)),
            JSurface(**{k: jnp.asarray(v) for k, v in cells.items()}),
            _wrt(cfg_kw["dimension"]))
        out[name] = (cells, float(value),
                     {k: np.asarray(v) for k, v in grads.items()})
    return out


@pytest.mark.parametrize("name", JAX_CASES)
def test_feqmod_grad_matches_jax(jax_grads, name):
    cells, jvalue, jg = jax_grads[name]
    _, (sp, grid, df, cfg) = _inputs(name)
    fn, obs = diff.spectra_fn(sp, grid, df, cfg), _scalar(grid)
    value, g = diff.surface_value_and_grad(
        lambda s: obs(fn(s)), convert.surface_from_state(cells), tuple(jg))
    np.testing.assert_allclose(float(value), jvalue, rtol=1e-12)
    assert set(g) == set(jg)
    _close(g, jg)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cells_mix_clean_and_broken_down(name):
    """Every case holds cells on both chains (the gradients take the
    derivative of the chain each cell took)."""
    _, (sp, grid, df, cfg) = _inputs(name)
    cells = _cells(cfg.dimension)
    flags = feqmod.feqmod_flags(cfg, grid)
    x, _, _ = feqmod.group_inputs(
        surface_columns(convert.surface_from_state(cells), cfg), sp,
        laguerre_device(dtype=torch.float64), df, cfg, flags)
    bd = x[:, feqmod.FQ["bd"]] > 0
    assert bd.any() and not bd.all(), int(bd.sum())


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_is_smooth_spectra_feqmod_bit_for_bit(name):
    _, (sp, grid, df, cfg) = _inputs(name)
    cells = _cells(cfg.dimension)
    surf = convert.surface_from_state(cells)
    want = feqmod.smooth_spectra_feqmod(surf, sp, grid, df, cfg)
    value, _ = diff.surface_vjp(diff.spectra_fn(sp, grid, df, cfg), surf,
                                ("T", "bulkPi"))
    assert torch.equal(value, want)


# entries of cells away from the breakdown step (a cell on it switches
# chains under the difference)
@pytest.mark.parametrize("name,field,i", [("df3_3d", "T", 3),
                                          ("df3_2d_fixed", "pixy", 1),
                                          ("df4_3d", "eta", 3),
                                          ("df4_2d_remap", "bulkPi", 5)])
def test_feqmod_grad_matches_central_differences(name, field, i):
    _, (sp, grid, df, cfg) = _inputs(name)
    cells = _cells(cfg.dimension)
    fn, obs = diff.spectra_fn(sp, grid, df, cfg), _scalar(grid)
    surf = convert.surface_from_state(cells)
    _, g = diff.surface_value_and_grad(lambda s: obs(fn(s)), surf, (field,))
    x = getattr(surf, field)
    eps = 3.0e-6 * max(1.0, abs(float(x[i])))
    shift = lambda d: surf.replace(**{field: x + d * eps * (
        torch.arange(x.shape[0]) == i)})
    with torch.no_grad():
        fd = (float(obs(fn(shift(1.0)))) - float(obs(fn(shift(-1.0))))) / (
            2.0 * eps)
    assert abs(float(g[field][i])) > 0
    np.testing.assert_allclose(float(g[field][i]), fd, rtol=5e-5,
                               atol=1e-12)


def test_decayed_feqmod_spectra_fn_matches_jax():
    """Surface -> df 3 spectra -> feed-down, one reverse pass, against
    is3d_tpu.diff.decayed_spectra_fn (2+1D, the decaying list)."""
    table, mcids, jtable = _decaying()
    cfg_kw = dict(dimension=2, df_mode=3, **VISC)
    jsp = j_species_from_table(
        jtable, [jtable.index_of_mcid(int(m)) for m in mcids])
    jgrid = j_native_grid(2, **DECAY_GRID[2])
    jdf = jtesting.synthetic_deltaf_data()
    jcfg = JConfig(operation=1, mode=1, do_resonance_decays=1, **cfg_kw)
    # the shear x 0.1: at x 0.3 one of these cells' spectra rise with pT
    # and the feed-down's tail fit blows them up to 1e29
    cells = _cells(2, seed=11, n=12, shear=0.1)
    wrt = ("T", "ux", "bulkPi", "pixy")
    jfn = jdiff.decayed_spectra_fn(jsp, jgrid, jdf, jcfg, jtable, mcids)
    jv, jg = jdiff.surface_value_and_grad(
        lambda s: jnp.sum(jdiff.dN_dy_j(jfn(s), jgrid)),
        JSurface(**{k: jnp.asarray(v) for k, v in cells.items()}), wrt)

    sp = species_from_table(table, [table.index_of_mcid(int(m))
                                    for m in mcids])
    grid = convert.grid_from_state(jax_state(jgrid))
    df = convert.deltaf_from_state(jax_state(jdf))
    cfg = Config(operation=1, mode=1, do_resonance_decays=1, **cfg_kw)
    fn = diff.decayed_spectra_fn(sp, grid, df, cfg, table, mcids)
    v, g = diff.surface_value_and_grad(
        lambda s: diff.dN_dy_j(fn(s), grid).sum(),
        convert.surface_from_state(cells), wrt)
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-12)
    _close(g, {k: np.asarray(w) for k, w in jg.items()})
