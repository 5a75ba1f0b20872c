"""is3d_tpu_torch.diff against is3d_tpu.diff on the CPU in float64: the
gradients of the anisotropic-hydro (VAH, surface modes 2-3) spectra with
respect to the freeze-out surface, and the residual-df gate under
autograd.

Inputs are made with numpy from a seed (is3d_tpu_torch.testing's VAH
cells, their synthetic c0..c4 where a case has them) and carried to both
packages; the JAX gradients are computed once, in one module-scoped
fixture.  Tolerance: rtol 1e-8 / atol 1e-10 x max|grad| of each field, as
tests/test_torch_grad.py; central differences at rtol 5e-5.

* spectra_fn for mode 2 in 2+1D with the mT remap, gated (no c0..c4: f_a
  alone, every real VAH file) and ungated (vah_df_gate = 0, every chain,
  the coefficient columns differentiated), and for mode 3 in 3+1D with
  every chain; the forward is smooth_spectra_vah's bit for bit;
* the gate under grad: with c0..c4 zero a chain whose column wants a
  gradient is kept, and its gradient equals JAX's (not 0); with nothing
  under grad the gate drops it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from is3d_tpu import diff as jdiff
from is3d_tpu import testing as jtesting
from is3d_tpu.config import Config as JConfig
from is3d_tpu.io.surface import Surface as JSurface
from is3d_tpu.io.tables import native_momentum_grid as j_native_grid

from is3d_tpu_torch import convert, diff, testing
from is3d_tpu_torch.config import Config
from is3d_tpu_torch.kernels import vah

from test_torch_grad import VISC, _close, _scalar, _scalar_jax
from test_torch_smooth import jax_state

torch.set_num_threads(1)

GRID = dict(n_pT=5, n_phi=4, n_y=3, n_eta=6)
N_CELLS, N_SPECIES = 20, 3
WRT = ("Lambda", "aL", "ux", "uy", "un", "dat", "dax", "day", "dan", "tau")
CHAIN_WRT = ("c0", "c1", "c2", "c3", "c4", "pixx", "pixy", "bulkPi", "Wx")
# name: (config, chains (synthetic c0..c4), fields)
CASES = {
    "mode2_2d_remap_gated": (dict(mode=2, dimension=2), False, WRT),
    "mode2_2d_remap_ungated": (dict(mode=2, dimension=2, vah_df_gate=0),
                               True, WRT + CHAIN_WRT),
    "mode3_3d_chains": (dict(mode=3, dimension=3), True,
                        WRT + ("eta", "c3", "c0", "pixy", "Wy")),
}


def _cells(name: str) -> dict:
    cfg_kw, chains, _ = CASES[name]
    cells = testing.synthetic_vah_cells(N_CELLS, cfg_kw["dimension"], seed=5)
    if chains:
        cells.update(testing.synthetic_vah_coefficients(cells, seed=5))
    return cells


def _inputs(cfg_kw: dict):
    """(JAX inputs, port inputs) of a configuration."""
    cfg_kw = dict(cfg_kw, operation=1, **VISC)
    jgrid = j_native_grid(dimension=cfg_kw["dimension"], **GRID)
    jsp = jtesting.synthetic_species(n_species=N_SPECIES)
    port = (convert.species_from_state(jax_state(jsp)),
            convert.grid_from_state(jax_state(jgrid)), Config(**cfg_kw))
    return (jsp, jgrid, JConfig(**cfg_kw)), port


def _jax_grads(cells: dict, cfg_kw: dict, wrt) -> tuple:
    (jsp, jgrid, jcfg), _ = _inputs(cfg_kw)
    smap = jdiff.spectra_fn(jsp, jgrid, None, jcfg)
    obs = _scalar_jax(jgrid)
    value, grads = jdiff.surface_value_and_grad(
        lambda s: obs(smap(s)),
        JSurface(**{k: jnp.asarray(v) for k, v in cells.items()}), wrt)
    return float(value), {k: np.asarray(v) for k, v in grads.items()}


def _gate_cells() -> dict:
    """Cells whose c0..c4 columns are present and all zero."""
    cells = testing.synthetic_vah_cells(N_CELLS, 3, seed=6)
    cells.update({f"c{i}": np.zeros(N_CELLS) for i in range(5)})
    return cells


GATE_CFG = dict(mode=3, dimension=3)
GATE_WRT = ("c3", "Lambda")


@pytest.fixture(scope="module")
def jax_grads():
    """is3d_tpu's value and gradients of the observable for every case,
    and for the gate's case (c3 under grad on zero columns)."""
    out = {name: _jax_grads(_cells(name), CASES[name][0], CASES[name][2])
           for name in CASES}
    out["gate"] = _jax_grads(_gate_cells(), GATE_CFG, GATE_WRT)
    return out


def _port_grads(cells: dict, cfg_kw: dict, wrt):
    _, (sp, grid, cfg) = _inputs(cfg_kw)
    fn, obs = diff.spectra_fn(sp, grid, None, cfg), _scalar(grid)
    return diff.surface_value_and_grad(
        lambda s: obs(fn(s)), convert.surface_from_state(cells), wrt)


@pytest.mark.parametrize("name", sorted(CASES))
def test_vah_grad_matches_jax(jax_grads, name):
    jvalue, jg = jax_grads[name]
    value, g = _port_grads(_cells(name), CASES[name][0], tuple(jg))
    np.testing.assert_allclose(float(value), jvalue, rtol=1e-12)
    assert set(g) == set(jg)
    _close(g, jg)


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_is_smooth_spectra_vah_bit_for_bit(name):
    _, (sp, grid, cfg) = _inputs(CASES[name][0])
    surf = convert.surface_from_state(_cells(name))
    want = vah.smooth_spectra_vah(surf, sp, grid, cfg)
    value, _ = diff.surface_vjp(diff.spectra_fn(sp, grid, None, cfg), surf,
                                ("Lambda", "ux"))
    assert torch.equal(value, want)


@pytest.mark.parametrize("name,field,i", [
    ("mode2_2d_remap_gated", "Lambda", 4),
    ("mode2_2d_remap_ungated", "c3", 6),
    ("mode3_3d_chains", "aL", 2)])
def test_vah_grad_matches_central_differences(name, field, i):
    cells = _cells(name)
    _, (sp, grid, cfg) = _inputs(CASES[name][0])
    fn, obs = diff.spectra_fn(sp, grid, None, cfg), _scalar(grid)
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


def test_gate_keeps_a_chain_under_grad(jax_grads):
    """c0..c4 all zero: with c3 under grad the shear chain is kept (as a JAX
    tracer keeps it) and d/dc3 equals JAX's, nonzero; with nothing under
    grad the gate drops both chains, and the spectra are the same."""
    jvalue, jg = jax_grads["gate"]
    cells = _gate_cells()
    value, g = _port_grads(cells, GATE_CFG, GATE_WRT)
    np.testing.assert_allclose(float(value), jvalue, rtol=1e-12)
    assert np.abs(jg["c3"]).max() > 0
    _close(g, jg)
    _, (sp, grid, cfg) = _inputs(GATE_CFG)
    surf = convert.surface_from_state(cells)
    cols = vah.vah_surface_cols(surf)
    assert vah.vah_flags(vah.effective_vah_cfg(cols, cfg), grid).switches == 0
    tracked = dict(cols, c3=cols["c3"].clone().requires_grad_(True))
    with torch.enable_grad():
        flags = vah.vah_flags(vah.effective_vah_cfg(tracked, cfg), grid)
    assert flags.switches == 1
    with torch.no_grad():
        flags = vah.vah_flags(vah.effective_vah_cfg(tracked, cfg), grid)
    assert flags.switches == 0
    assert torch.equal(diff.spectra_fn(sp, grid, None, cfg)(surf),
                       vah.smooth_spectra_vah(surf, sp, grid, cfg))
