"""is3d_tpu_torch.diff against is3d_tpu.diff on the CPU in float64: the
gradients of the linear-df spectra and of the resonance-decay feed-down
with respect to the freeze-out surface.

Inputs are made with numpy from a seed on the JAX side and carried to the
port through is3d_tpu_torch.convert; the JAX gradients are computed once,
in one module-scoped fixture.  Tolerance: both sides in f64 take the same
derivatives through the same algebra in another order, so they agree to
~1e-14; rtol 1e-8 / atol 1e-10 x max|grad| of each field leaves six
orders of margin.  The finite-difference checks follow tests/test_grad.py
(central differences, rtol 5e-5).

* spectra_fn: 3+1D and 2+1D (fixed nodes and the mT remap), df 1 and 2,
  regulate and outflow on, a baryon case with diffusion; the forward is
  smooth_spectra's bit for bit; vn_j and mean_pT_j; a saturated regulator,
  a masked cell and an overflowed exponential (finite and equal to JAX's);
  surface_vjp; mode-5 surfaces' spectra (K1's path).  The polarization's
  gradient is tests/test_torch_grad_polzn.py's.
* The feed-down: resonance_feed_down_traced's gradient with respect to the
  spectra (the decaying list, one parent all zero and one tail-patched, as
  tests/test_torch_decays.py), 2+1D and 3+1D, and its forward equal to
  do_resonance_decays; decayed_spectra_fn from a surface in 2+1D.
* The custom derivatives of fermi_bose, scaled_fermi_bose and the clipped
  arccos at their edges against JAX's custom_jvp.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from is3d_tpu import diff as jdiff
from is3d_tpu import testing as jtesting
from is3d_tpu.config import Config as JConfig
from is3d_tpu.data import species_from_table as j_species_from_table
from is3d_tpu.io import pdg as jpdg
from is3d_tpu.io.surface import Surface as JSurface
from is3d_tpu.io.tables import native_momentum_grid as j_native_grid
from is3d_tpu.kernels import common as jcommon
from is3d_tpu.kernels import decays as jdecays

from is3d_tpu_torch import convert, diff, testing
from is3d_tpu_torch.config import Config
from is3d_tpu_torch.data import species_from_table
from is3d_tpu_torch.io import pdg
from is3d_tpu_torch.io.tables import native_momentum_grid
from is3d_tpu_torch.kernels import common, decays
from is3d_tpu_torch.kernels.smooth import smooth_spectra

from test_torch_smooth import jax_state, random_cells

torch.set_num_threads(1)

RTOL = 1e-8
ATOL_REL = 1e-10

GRID = dict(n_pT=5, n_phi=4, n_y=3, n_eta=6)
VISC = dict(include_shear_deltaf=1, include_bulk_deltaf=1,
            regulate_deltaf=1, outflow=1, cell_chunk=16)
WRT2 = ("T", "ux", "uy", "un", "bulkPi", "pixx", "pixy", "pixn", "piyy",
        "piyn", "dat", "dax", "day", "dan", "tau", "E", "P")
CASES = {
    "2d_df2_remap": (dict(dimension=2, df_mode=2, **VISC), {}),
    "2d_df1_fixed": (dict(dimension=2, df_mode=1, **VISC),
                     dict(eta_mT_rescale=False)),
    "3d_df2": (dict(dimension=3, df_mode=2, **VISC), {}),
    "3d_df1": (dict(dimension=3, df_mode=1, **VISC), {}),
    "3d_df2_baryon": (dict(dimension=3, df_mode=2, include_baryon=1,
                           include_baryondiff_deltaf=1, **VISC), {}),
}
N_SPECIES = 6

# the feed-down's grids (small: the JAX 3+1D feed-down gradient is the
# slowest part of the file)
DECAY_GRID = {2: dict(n_pT=8, pT_max=3.0, n_phi=8, n_y=5, n_eta=4),
              3: dict(n_pT=6, pT_max=3.0, n_phi=6, n_y=3, n_eta=4)}


def _wrt(cfg_kw):
    wrt = WRT2 + (("eta",) if cfg_kw["dimension"] == 3 else ())
    if cfg_kw.get("include_baryon"):
        wrt += ("muB", "nB", "Vx", "Vy", "Vn")
    return wrt


def _cells(name, cfg_kw):
    cells = random_cells(24, cfg_kw["dimension"], seed=len(name),
                         baryon=bool(cfg_kw.get("include_baryon")))
    if name == "edges":
        cells["bulkPi"] = np.full(24, 0.2)        # deep regulation
        cells["dat"][0] = -2.0                    # a masked cell
    return cells


def _inputs(cfg_kw, grid_kw):
    """(JAX inputs, port inputs) of one configuration."""
    dimension = cfg_kw["dimension"]
    jcfg = JConfig(operation=1, mode=1, **cfg_kw)
    jgrid = j_native_grid(dimension=dimension, **dict(GRID, **grid_kw))
    jsp = jtesting.synthetic_species(n_species=N_SPECIES)
    jdf = jtesting.synthetic_deltaf_data()
    port = (convert.species_from_state(jax_state(jsp)),
            convert.grid_from_state(jax_state(jgrid)),
            convert.deltaf_from_state(jax_state(jdf)),
            Config(operation=1, mode=1, **cfg_kw))
    return (jsp, jgrid, jdf, jcfg), port


def _scalar_jax(jgrid):
    """Sum dN/dy plus the v2 and <pT> of every species (a calibration
    observable), on the JAX side."""
    def obs(spectra):
        return (jnp.sum(jdiff.dN_dy_j(spectra, jgrid))
                + jnp.sum(jdiff.vn_j(spectra, jgrid, 2))
                + 0.1 * jnp.sum(jdiff.mean_pT_j(spectra, jgrid)))
    return obs


def _scalar(grid):
    def obs(spectra):
        return (diff.dN_dy_j(spectra, grid).sum()
                + diff.vn_j(spectra, grid, 2).sum()
                + 0.1 * diff.mean_pT_j(spectra, grid).sum())
    return obs


def _edge_grid_kw():
    # exp(u.p / T) overflows where the rapidity grid reaches far from the
    # cells (tests: testing.SPECTRA_EDGES["3d_overflow"])
    return dict(n_y=5, y_max=12.0)


SPECTRA_CASES = dict(CASES, edges=(dict(dimension=3, df_mode=2, **VISC),
                                   _edge_grid_kw()))


@pytest.fixture(scope="module")
def jax_grads():
    """is3d_tpu's value and gradients for every case of this file."""
    out = {}
    for name, (cfg_kw, grid_kw) in SPECTRA_CASES.items():
        cells = _cells(name, cfg_kw)
        (jsp, jgrid, jdf, jcfg), _ = _inputs(cfg_kw, grid_kw)
        smap = jdiff.spectra_fn(jsp, jgrid, jdf, jcfg)
        surf = JSurface(**{k: jnp.asarray(v) for k, v in cells.items()})
        obs = _scalar_jax(jgrid)
        value, grads = jdiff.surface_value_and_grad(
            lambda s: obs(smap(s)), surf, _wrt(cfg_kw))
        out[name] = (cells, float(value),
                     {k: np.asarray(v) for k, v in grads.items()})
    out["decays"] = {}
    table, mcids, jtable = _decaying()
    for dimension in (2, 3):
        spectra, W = _decay_inputs(table, mcids, dimension)
        jgrid = j_native_grid(dimension, **DECAY_GRID[dimension])
        jcfg = JConfig(dimension=dimension, do_resonance_decays=1)
        g = jax.grad(lambda sp: jnp.sum(jdecays.resonance_feed_down_traced(
            sp, jtable, mcids, jgrid, jcfg, use_hat=False) * W))(
                jnp.asarray(spectra))
        out["decays"][dimension] = np.asarray(g)
    return out


def _port_grads(name):
    cfg_kw, grid_kw = SPECTRA_CASES[name]
    _, (sp, grid, df, cfg) = _inputs(cfg_kw, grid_kw)
    fn = diff.spectra_fn(sp, grid, df, cfg)
    obs = _scalar(grid)
    return fn, obs, grid, cfg


def _close(got: dict, want: dict):
    for k, w in convert.grads_from_state(want).items():
        g, w = got[k].numpy(), w.numpy()
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=ATOL_REL * np.abs(w).max(),
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(SPECTRA_CASES))
def test_spectra_grad_matches_jax(jax_grads, name):
    cells, jvalue, jg = jax_grads[name]
    fn, obs, _, _ = _port_grads(name)
    value, g = diff.surface_value_and_grad(
        lambda s: obs(fn(s)), convert.surface_from_state(cells),
        tuple(jg))
    np.testing.assert_allclose(float(value), jvalue, rtol=1e-12)
    assert set(g) == set(jg)
    _close(g, jg)


def test_edges_show_saturation_mask_and_overflow(jax_grads):
    """The edge case drives cells into |df| > 1 regulation, masks one cell
    (u.dsigma < 0) and overflows exp(u.p/T) at the outer rapidities; its
    gradients are finite (test_spectra_grad_matches_jax[edges] holds them
    to JAX's)."""
    cells, _, jg = jax_grads["edges"]
    fn, _, _, _ = _port_grads("edges")
    surf = convert.surface_from_state(cells, requires_grad=("T",))
    assert surf.T.requires_grad and not surf.ux.requires_grad
    out = fn(surf)
    assert (out[..., 0] == 0).any() and (out[..., 2] > 0).all()
    (gT,) = torch.autograd.grad(out.sum(), surf.T)
    assert torch.isfinite(gT).all()
    assert np.isfinite(jg["bulkPi"]).all() and jg["dat"][0] == 0.0


@pytest.mark.parametrize("name,field,i", [("2d_df2_remap", "T", 3),
                                          ("2d_df2_remap", "pixy", 5),
                                          ("3d_df1", "ux", 2),
                                          ("3d_df2", "eta", 7)])
def test_spectra_grad_matches_central_differences(jax_grads, name, field,
                                                   i):
    cells, _, _ = jax_grads[name]
    fn, obs, _, _ = _port_grads(name)
    surf = convert.surface_from_state(cells)
    _, g = diff.surface_value_and_grad(lambda s: obs(fn(s)), surf, (field,))
    x = getattr(surf, field)
    eps = 3.0e-6 * max(1.0, abs(float(x[i])))
    shift = lambda d: surf.replace(**{field: x + d * eps * (
        torch.arange(x.shape[0]) == i)})
    with torch.no_grad():
        fd = (float(obs(fn(shift(1.0)))) - float(obs(fn(shift(-1.0))))) / (
            2.0 * eps)
    np.testing.assert_allclose(float(g[field][i]), fd, rtol=5e-5,
                               atol=1e-12)


def test_observables_match_jax():
    rng = np.random.default_rng(4)
    spectra = rng.uniform(0.1, 1.0, (3, 5, 4, 2))
    spectra[1] = 0.0                                  # a vanishing harmonic
    jgrid = j_native_grid(dimension=3, n_pT=5, n_phi=4, n_y=2)
    grid = convert.grid_from_state(jax_state(jgrid))
    sp = torch.tensor(spectra)
    for jf, f in ((lambda s: jdiff.vn_j(s, jgrid, 2),
                   lambda s: diff.vn_j(s, grid, 2)),
                  (lambda s: jdiff.mean_pT_j(s, jgrid),
                   lambda s: diff.mean_pT_j(s, grid)),
                  (lambda s: jdiff.dN_dy_j(s, jgrid),
                   lambda s: diff.dN_dy_j(s, grid))):
        np.testing.assert_allclose(f(sp).numpy(), jf(jnp.asarray(spectra)),
                                   rtol=1e-12, atol=1e-300)
        jg = jax.grad(lambda s: jnp.sum(jf(s)))(jnp.asarray(spectra))
        x = sp.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(f(x).sum(), x)
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-12, atol=1e-300)


def test_forward_is_smooth_spectra_bit_for_bit(jax_grads):
    cells, _, _ = jax_grads["3d_df2"]
    fn, _, grid, cfg = _port_grads("3d_df2")
    _, (sp, _, df, _) = _inputs(*SPECTRA_CASES["3d_df2"])
    surf = convert.surface_from_state(cells)
    want = smooth_spectra(surf, sp, grid, df, cfg)
    value, pull = diff.surface_vjp(fn, surf, ("T",))
    assert torch.equal(value, want)
    with torch.enable_grad():
        t = surf.T.clone().requires_grad_(True)
        assert torch.equal(fn(surf.replace(T=t)).detach(), want)


def test_one_hot_vjp_is_the_grad_of_the_bin(jax_grads):
    cells, _, _ = jax_grads["2d_df2_remap"]
    fn, _, _, _ = _port_grads("2d_df2_remap")
    surf = convert.surface_from_state(cells)
    value, pull = diff.surface_vjp(fn, surf, ("T", "ux"))
    ct = torch.zeros_like(value)
    ct[2, 3, 1, 0] = 1.0
    g = pull(ct)
    _, want = diff.surface_value_and_grad(lambda s: fn(s)[2, 3, 1, 0], surf,
                                          ("T", "ux"))
    for k in ("T", "ux"):
        np.testing.assert_allclose(g[k].numpy(), want[k].numpy(),
                                   rtol=1e-13, atol=1e-300)
    g2 = pull(2.0 * ct)                               # a pullback reused
    np.testing.assert_allclose(g2["T"].numpy(), 2.0 * want["T"].numpy(),
                               rtol=1e-13)


def test_absent_field_raises(jax_grads):
    cells, _, _ = jax_grads["3d_df2"]
    fn, obs, _, _ = _port_grads("3d_df2")
    surf = convert.surface_from_state(cells)
    assert surf.wtx is None and surf.Lambda is None
    with pytest.raises(ValueError, match="wtx"):
        diff.surface_value_and_grad(lambda s: obs(fn(s)), surf, ("T", "wtx"))
    with pytest.raises(ValueError, match="Lambda"):
        diff.surface_vjp(fn, surf, ("Lambda",))


@pytest.mark.parametrize("dimension", [2, 3])
def test_mode5_spectra_grad_matches_jax(dimension):
    """The spectra of a mode-5 (vorticity) surface are the linear-df
    spectra (api.py), so their gradient runs through K1's backward: against
    jax.vjp of is3d_tpu.diff.spectra_fn on the same surface, the vorticity
    columns carried and not differentiated (2+1D the mT remap)."""
    cfg_kw = dict(CASES["3d_df2" if dimension == 3 else "2d_df2_remap"][0])
    (jsp, jgrid, jdf, jcfg), (sp, grid, df, cfg) = _inputs(cfg_kw, {})
    jcfg, cfg = (dataclasses.replace(c, mode=5) for c in (jcfg, cfg))
    cells = dict(testing.synthetic_surface_cells(16, dimension, seed=9),
                 **testing.synthetic_vorticity(16, seed=9))
    wrt = ("T", "ux", "bulkPi", "pixy", "dat") + (
        ("eta",) if dimension == 3 else ())
    jfn = jdiff.spectra_fn(jsp, jgrid, jdf, jcfg)
    jsurf = JSurface(**{k: jnp.asarray(v) for k, v in cells.items()})
    ct = testing.grad_cotangent(np.asarray(jfn(jsurf)).shape).numpy()
    jv, jpull = jdiff.surface_vjp(jfn, jsurf, wrt)
    jg = {k: np.asarray(v) for k, v in jpull(jnp.asarray(ct)).items()}
    fn = diff.spectra_fn(sp, grid, df, cfg)
    surf = convert.surface_from_state(cells)
    v, pull = diff.surface_vjp(fn, surf, wrt)
    assert torch.equal(v, smooth_spectra(surf, sp, grid, df, cfg))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-9,
                               atol=1e-12 * np.abs(np.asarray(jv)).max())
    _close(pull(torch.tensor(ct)), jg)


# ------------------------------------------------------------ the feed-down

def _decaying():
    table, mcids = testing.synthetic_decaying_table(24, seed=3)
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "pdg.dat")
        testing.write_decaying_pdg(path, 24, seed=3)
        jtable = jpdg.read_resonances_conventional(path)
    return table, mcids, jtable


def _decay_inputs(table, mcids, dimension):
    """The decaying list's thermal spectra with one parent all zero (its
    log table the -745 floor) and one zero from the middle of its pT range
    up (patched by the tail fit), and the positive weights of the
    observable."""
    grid = native_momentum_grid(dimension, **DECAY_GRID[dimension])
    spectra = testing.thermal_spectra(table, mcids, grid, dimension)
    rows = decays._decay_schedule(table, mcids, np.zeros(1), 111)[0]
    spectra[rows[1]] = 0.0
    spectra[rows[2], DECAY_GRID[dimension]["n_pT"] // 2:] = 0.0
    W = np.random.default_rng(dimension).uniform(0.5, 1.5, spectra.shape)
    return spectra, W


@pytest.fixture(scope="module")
def decaying():
    return _decaying()


@pytest.mark.parametrize("dimension", [2, 3])
def test_feed_down_grad_matches_jax(jax_grads, decaying, dimension):
    table, mcids, _ = decaying
    spectra, W = _decay_inputs(table, mcids, dimension)
    grid = native_momentum_grid(dimension, **DECAY_GRID[dimension])
    cfg = Config(dimension=dimension, do_resonance_decays=1)
    x = torch.tensor(spectra, requires_grad=True)
    out = decays.resonance_feed_down_traced(x, table, mcids, grid, cfg)
    (g,) = torch.autograd.grad((out * torch.tensor(W)).sum(), x)
    want = jax_grads["decays"][dimension]
    assert np.isfinite(g.numpy()).all()
    np.testing.assert_allclose(g.numpy(), want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max())
    # the forward is the production cascade's, bit for bit
    ref = decays.do_resonance_decays(torch.tensor(spectra), table, mcids,
                                     grid, cfg)
    assert torch.equal(out.detach(), ref)


def test_decayed_spectra_fn_matches_jax(decaying):
    """Surface -> smooth spectra -> feed-down, one reverse pass, against
    is3d_tpu.diff.decayed_spectra_fn (2+1D, the decaying list's species)."""
    table, mcids, jtable = decaying
    cfg_kw = dict(dimension=2, df_mode=2, **VISC)
    idx = [table.index_of_mcid(int(m)) for m in mcids]
    jidx = [jtable.index_of_mcid(int(m)) for m in mcids]
    jsp = j_species_from_table(jtable, jidx)
    jgrid = j_native_grid(2, **DECAY_GRID[2])
    jdf = jtesting.synthetic_deltaf_data()
    jcfg = JConfig(operation=1, mode=1, do_resonance_decays=1, **cfg_kw)
    cells = random_cells(12, 2, seed=11)
    jfn = jdiff.decayed_spectra_fn(jsp, jgrid, jdf, jcfg, jtable, mcids)
    jv, jg = jdiff.surface_value_and_grad(
        lambda s: jnp.sum(jdiff.dN_dy_j(jfn(s), jgrid)),
        JSurface(**{k: jnp.asarray(v) for k, v in cells.items()}),
        ("T", "ux", "bulkPi"))

    sp = species_from_table(table, idx)
    grid = convert.grid_from_state(jax_state(jgrid))
    df = convert.deltaf_from_state(jax_state(jdf))
    cfg = Config(operation=1, mode=1, do_resonance_decays=1, **cfg_kw)
    fn = diff.decayed_spectra_fn(sp, grid, df, cfg, table, mcids)
    v, g = diff.surface_value_and_grad(
        lambda s: diff.dN_dy_j(fn(s), grid).sum(),
        convert.surface_from_state(cells), ("T", "ux", "bulkPi"))
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-12)
    _close(g, {k: np.asarray(w) for k, w in jg.items()})


# ------------------------------------------------------ custom derivatives

def test_fermi_bose_derivatives_match_custom_jvp():
    """d/dx and d/ds of 1/(e^x + s) and of a/(e^x + s), and d/dx of the
    clipped arccos, at their edges: e^x overflowing (exact zeros), s = 0
    and +-1, |x| >= 1 for the arccos (zero), against JAX's custom_jvp."""
    x = np.array([-3.0, 0.0, 0.7, 40.0, 800.0, 1.0e4])
    for s in (-1.0, 0.0, 1.0):
        sv = np.full_like(x, s)
        sv[0] = 1.0 if s == -1.0 else s           # keep e^x + s > 0
        jx, js = jax.grad(lambda a, b: jnp.sum(jcommon.fermi_bose(a, b)),
                          argnums=(0, 1))(jnp.asarray(x), jnp.asarray(sv))
        tx = torch.tensor(x, requires_grad=True)
        ts = torch.tensor(sv, requires_grad=True)
        gx, gs = torch.autograd.grad(common.fermi_bose(tx, ts).sum(),
                                     (tx, ts))
        np.testing.assert_allclose(gx.numpy(), jx, rtol=1e-14, atol=0)
        np.testing.assert_allclose(gs.numpy(), js, rtol=1e-14, atol=0)
        assert gx[-1] == 0.0 and gs[-1] == 0.0
        a = np.linspace(0.5, 2.0, x.shape[0])
        ja, jx2, js2 = jax.grad(
            lambda p, q, r: jnp.sum(jcommon.scaled_fermi_bose(p, q, r)),
            argnums=(0, 1, 2))(jnp.asarray(a), jnp.asarray(x),
                               jnp.asarray(sv))
        ta = torch.tensor(a, requires_grad=True)
        tx = torch.tensor(x, requires_grad=True)
        ts = torch.tensor(sv, requires_grad=True)
        got = torch.autograd.grad(
            common.scaled_fermi_bose(ta, tx, ts).sum(), (ta, tx, ts))
        for g, w in zip(got, (ja, jx2, js2)):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-14, atol=0)
    c = np.array([-1.5, -1.0, -0.3, 0.0, 0.9, 1.0, 1.0 + 1e-12])
    jc = jax.grad(lambda v: jnp.sum(jdecays._arccos_clipped(v)))(
        jnp.asarray(c))
    tc = torch.tensor(c, requires_grad=True)
    (gc,) = torch.autograd.grad(decays.arccos_clipped(tc).sum(), tc)
    np.testing.assert_allclose(gc.numpy(), jc, rtol=1e-14, atol=0)
    assert (gc[[0, 1, 5, 6]] == 0).all() and torch.isfinite(gc).all()
