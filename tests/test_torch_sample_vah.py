"""The sampler's second half in is3d_tpu_torch against is3d_tpu on the same
inputs (the plain torch versions, CPU, f64):

* phase A's densities (``species_yields_plain``, K7b's plain version)
  against is3d_tpu's _species_yields_exact_block (df 1-4) and
  _species_yields_vah on every testing.YIELDS_EDGES case, clamped as
  phase A clamps them, at rtol 1e-9;
* VAH phase A (``vah_cell_data``) against is3d_tpu's _vah_cell_data_jit
  (gated, every chain, 3+1D mode 3): the LRF fields, dn_tot, mean_cell,
  the search tables (rowcum, cum_dn) at rtol 1e-9 and the alias tables'
  pmf at 1e-12;
* replayed events: is3d_tpu's own uniforms for one event fed through the
  port's event_batch_plain on is3d_tpu's cell data, slot by slot, with no
  flipped decision: the VAH branch (every chain setting, regulate on and
  off, 2+1D and 3+1D) and the binary-search draws (df 1-4 and VAH);
* the VAH sampler in distribution against the port's smooth_spectra_vah
  (per-species dN/dy and mean pT at 5 sigma, as tests/test_sampler_vah.py
  holds is3d_tpu's), and the df gate bit-identical;
* the search draws against the alias draws in distribution.

Inputs are made with numpy from a seed (is3d_tpu_torch.testing's VAH
cells, is3d_tpu.testing's species) and carried to the port with
is3d_tpu_torch.convert.
"""

import math
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from is3d_tpu import testing as jtesting
from is3d_tpu.config import Config as JConfig
from is3d_tpu.io.surface import Surface as JSurface, ThermoAverages as JAvg
from is3d_tpu.kernels import sample as jsample

from is3d_tpu_torch import convert, observables, testing
from is3d_tpu_torch.config import Config
from is3d_tpu_torch.io.surface import ThermoAverages
from is3d_tpu_torch.io.tables import native_momentum_grid
from is3d_tpu_torch.kernels import sample
from is3d_tpu_torch.kernels.vah import smooth_spectra_vah

from test_torch_sample import (JaxReplaySource, PLASMA, VISC, assert_close,
                               realized_pmf, species_pair)
from test_torch_feqmod import feqmod_cells, MIXED
from test_torch_smooth import jax_state

torch.set_num_threads(1)


# --------------------------------------------------------------- K7b plain

def _jax_block(inp):
    """is3d_tpu's densities for a YIELDS_EDGES case, clamped and the
    massless species zeroed as its phase A does."""
    sp = inp["species"]
    jsp = types.SimpleNamespace(
        **{k: jnp.asarray(getattr(sp, k).numpy()) for k in
           ("mass", "sign", "degeneracy", "baryon")},
        n_species=sp.mass.shape[0])
    lag = {a: tuple(jnp.asarray(t.numpy()) for t in rw)
           for a, rw in inp["laguerre"].items()}
    cols = {k: jnp.asarray(v.numpy()) for k, v in inp["cols"].items()}
    cfg = inp["cfg"]
    if cfg.mode in (2, 3):
        dn = jsample._species_yields_vah(cols, jsp, lag)
    else:
        c = dict(T=cols["T"], alphaB=cols["alphaB"], bulkPi=cols["bulkPi"],
                 breakdown=cols["breakdown"],
                 df=types.SimpleNamespace(**{k: cols[k] for k in
                                             ("F", "G", "z", "betabulk")}))
        dn = jsample._species_yields_exact_block(
            c, jsp, lag, JConfig(df_mode=cfg.df_mode,
                                 include_baryon=cfg.include_baryon))
    dn = jnp.where(jsp.mass[None, :] > 0.0, jnp.maximum(dn, 0.0), 0.0)
    return np.asarray(dn)


@pytest.mark.parametrize("case", sorted(testing.YIELDS_EDGES))
def test_species_yields_plain_matches_jax(case):
    inp = testing.yields_edge_inputs(case, n_cells=97, n_species=23)
    want = _jax_block(inp)
    got, sums = sample.species_yields_plain(inp["cols"], inp["species"],
                                            inp["laguerre"], inp["cfg"])
    assert_close(got.numpy(), want)
    assert_close(sums.numpy(), want.sum(axis=1))
    assert want.max() > 0


# --------------------------------------------------------- VAH phase A

VAH_CASES = {
    # (dimension, mode, chains, regulate)
    "2d_gated": (2, 2, 0, 1),
    "2d_chains": (2, 2, 3, 1),
    "3d_mode3_chains_noreg": (3, 3, 3, 0),
    "3d_shear": (3, 2, 1, 1),
}


def vah_pair(case, n=57, seed=3, alias=1):
    """(port surface, JAX surface, port cfg, JAX cfg), both gated."""
    dim, mode, chains, reg = VAH_CASES[case]
    cells = testing.synthetic_vah_cells(n, dim, seed=seed)
    coef = testing.synthetic_vah_coefficients(cells, seed=seed)
    for i in range(5):
        if (chains & 1 and i >= 3) or (chains & 2 and i < 3):
            cells[f"c{i}"] = coef[f"c{i}"]
    for k in ("dat", "dax", "day", "dan"):
        cells[k][::5] = 0.0                    # zero-yield cells
    kw = dict(operation=2, mode=mode, dimension=dim, y_cut=3.0,
              regulate_deltaf=reg, sampler_alias=alias, **VISC)
    jsurf = JSurface(**{k: jnp.asarray(v) for k, v in cells.items()})
    surf = convert.surface_from_state(cells)
    with pytest.warns(UserWarning) if (chains and not reg) else _nowarn():
        cfg = sample.sampler_effective_cfg(surf, Config(**kw))
    jcfg = jsample._sampler_effective_cfg(jsurf, JConfig(**kw))
    assert (cfg.include_shear_deltaf, cfg.include_bulk_deltaf) == (
        jcfg.include_shear_deltaf, jcfg.include_bulk_deltaf) == (
            chains & 1, chains >> 1)
    return surf, jsurf, cfg, jcfg


class _nowarn:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


VAH_FIELDS = ("dn_tot", "mean_cell", "Lambda", "aL", "bulkPi", "c0", "c3",
              "pixx", "pixy", "pixz", "piyy", "piyz", "pizz", "dst", "dsx",
              "dsy", "dsz", "ds_max", "ut", "Xt", "Xx", "Xy", "Xn", "Yx",
              "Yy", "Zt", "Zn")


@pytest.mark.parametrize("case", sorted(VAH_CASES))
def test_vah_cell_data_matches_jax(case):
    surf, jsurf, cfg, jcfg = vah_pair(case)
    jsp, sp = species_pair()
    want = jsample._build_cell_data(jsurf, jsp, None, jcfg, JAvg(**PLASMA),
                                    jsample._laguerre_device(jnp.float64))
    got = sample.build_cell_data(surf, sp, None, cfg,
                                 ThermoAverages(**PLASMA))
    for k in VAH_FIELDS:
        assert_close(got[k].numpy(), want[k])
    # W in the LRF is transverse to z: Wlz is rounding, held to W's scale
    W = ("Wlx", "Wly", "Wlz")
    assert_close(np.stack([got[k].numpy() for k in W]),
                 np.stack([np.asarray(want[k]) for k in W]))
    lam = float(got["dn_tot"].sum())
    search = sample.build_search_tables(got["dn_list"], got["dn_tot"], lam)
    assert_close(search["rowcum"].numpy(), want["rowcum"])
    assert_close(search["cum_dn"].numpy(), want["cum_dn"])
    assert lam == pytest.approx(float(jnp.sum(want["dn_tot"])), rel=1e-12)
    alias = sample.build_alias_tables(got["dn_list"], got["dn_tot"])
    for t in ("grp", "blk", "sp"):
        pmf = realized_pmf(alias[t + "_prob"].numpy(),
                           alias[t + "_alias"].numpy())
        jpmf = realized_pmf(want[t + "_prob"], want[t + "_alias"])
        assert np.abs(pmf - jpmf).sum(1).max() < 1e-12
    # zero-yield cells and a mean yield from half the densities
    assert (np.asarray(want["dn_tot"])[::5] == 0).all()
    assert float(got["mean_cell"].sum()) > 0


def test_vah_sampler_cols_zero_fill_matches_jax():
    surf, jsurf, cfg, jcfg = vah_pair("2d_chains")
    for shear, bulk in ((0, 1), (1, 0), (0, 0)):
        c = sample.vah_sampler_cols(surf, cfg.replace(
            include_shear_deltaf=shear, include_bulk_deltaf=bulk))
        j = jsample._vah_sampler_cols(jsurf, jcfg.replace(
            include_shear_deltaf=shear, include_bulk_deltaf=bulk))
        assert sorted(c) == sorted(j)
        for k in j:
            np.testing.assert_array_equal(c[k].numpy(), np.asarray(j[k]),
                                          err_msg=k)


# ------------------------------------------------------- replayed events

def _replay(cell, jsp, sp, jcfg, cfg, search, seed_key=11):
    """One event of is3d_tpu's _one_event and the port's plain version on
    is3d_tpu's cell data and uniforms."""
    lam = float(jnp.sum(cell["dn_tot"]))
    n_cap = jsample._slot_capacity(lam)
    key = jax.random.fold_in(jax.random.key(seed_key), 4)
    want = jax.jit(jsample._one_event, static_argnames=("n_cap", "cfg"))(
        cell, jsp, key, jnp.asarray(lam), n_cap=n_cap, cfg=jcfg)
    src = JaxReplaySource(key, n_cap, jnp.asarray(lam))
    port_cell = {k: torch.from_numpy(np.array(v)) for k, v in cell.items()}
    if search:
        tables = dict(rowcum=port_cell["rowcum"], cum_dn=port_cell["cum_dn"],
                      lam=lam)
    else:
        tables = {k: port_cell[k] for k in ("grp_prob", "grp_alias",
                                            "blk_prob", "blk_alias",
                                            "sp_prob", "sp_alias")}
    rows, _ = sample.pack_rows(port_cell, cfg)
    got = sample.event_batch_plain(rows, tables, sp,
                                   torch.tensor([src.n], dtype=torch.int32),
                                   src, n_cap, cfg)
    return got, want, src.n, n_cap


def _assert_same_event(got, want, n, n_cap):
    keep = np.asarray(want["keep"])
    assert 20 < keep.sum() < n
    np.testing.assert_array_equal(got["keep"][0].numpy(), keep)
    valid = np.arange(n_cap) < n
    for k in ("sidx", "cidx"):
        np.testing.assert_array_equal(got[k][0].numpy()[valid],
                                      np.asarray(want[k])[valid])
    for k in ("px", "py", "pz", "eta"):
        assert_close(got[k][0].numpy()[keep], np.asarray(want[k])[keep])
    assert int(got["ok"].sum()) == int(want["acceptances"])
    assert int(got["rounds"].sum()) == int(want["samples"])


@pytest.mark.parametrize("case,search", [
    ("2d_gated", False), ("2d_chains", False),
    ("3d_mode3_chains_noreg", False), ("3d_shear", False),
    ("2d_chains", True), ("3d_mode3_chains_noreg", True)])
def test_replayed_vah_event_matches_jax(case, search):
    dim = VAH_CASES[case][0]
    surf, jsurf, cfg, jcfg = vah_pair(case, n=80 if dim == 2 else 400,
                                      seed=7, alias=0 if search else 1)
    jsp, sp = species_pair()
    cell = jsample._build_cell_data(jsurf, jsp, None, jcfg, JAvg(**PLASMA),
                                    jsample._laguerre_device(jnp.float64))
    _assert_same_event(*_replay(cell, jsp, sp, jcfg, cfg, search))


@pytest.mark.parametrize("dimension,df_mode", [(2, 1), (3, 2), (2, 3),
                                               (3, 4)])
def test_replayed_search_event_matches_jax(dimension, df_mode):
    cells = feqmod_cells(80 if dimension == 2 else 400, dimension, 7,
                         scales=MIXED)
    kw = dict(operation=2, mode=1, dimension=dimension, df_mode=df_mode,
              y_cut=3.0, sampler_alias=0, **VISC)
    jsp, sp = species_pair()
    jcfg = JConfig(**kw)
    cell = jsample._build_cell_data(
        JSurface(**{k: jnp.asarray(v) for k, v in cells.items()}), jsp,
        jtesting.synthetic_deltaf_data(), jcfg, JAvg(**PLASMA),
        jsample._laguerre_device(jnp.float64))
    assert "grp_prob" not in cell
    _assert_same_event(*_replay(cell, jsp, sp, jcfg, Config(**kw), True))


def test_row_categorical_matches_jax_at_the_edges():
    """The halvings on rows with ties, zeros and v at the row's ends, S a
    power of two and not."""
    r = np.random.default_rng(2)
    for S in (1, 7, 8, 64, 65):
        w = r.random((5, S)) * (r.random((5, S)) > 0.3)
        w[0] = 0.0
        rc = np.cumsum(w, axis=1)
        c = np.repeat(np.arange(5), 9)
        v = rc[c, -1] * np.tile(np.r_[0.0, r.random(7), 1.0], 5)
        want = np.asarray(jsample._row_categorical(jnp.asarray(rc),
                                                   jnp.asarray(c),
                                                   jnp.asarray(v)))
        got = sample.row_categorical(torch.from_numpy(rc),
                                     torch.from_numpy(c), torch.from_numpy(v))
        np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------ in distribution

def species6():
    jsp = jtesting.synthetic_species(6)
    return convert.species_from_state(jax_state(jsp))


def vah_flow_cells(n=36, seed=3):
    """A flowing 2+1D VAH surface with every residual-df chain on (the
    columns of tests/test_sampler_vah.py:vah_flow_surface)."""
    from test_sampler_vah import vah_flow_surface
    return jax_state(vah_flow_surface(n=n, seed=seed))


def test_vah_sampler_matches_smooth_vah():
    """Per-species dN/dy and mean pT of the port's VAH sampler against the
    port's smooth VAH spectra of the same surface (5 sigma + 2 % / 1 %, as
    tests/test_sampler_vah.py holds is3d_tpu's)."""
    sp = species6()
    surf = convert.surface_from_state(vah_flow_cells())
    y_cut = 3.0
    cfg = Config(operation=2, mode=2, dimension=2, df_mode=2,
                 include_shear_deltaf=1, include_bulk_deltaf=1,
                 regulate_deltaf=1, outflow=1, y_cut=y_cut, sampler_seed=23)
    grid = native_momentum_grid(dimension=2, n_pT=48, pT_max=5.0, n_phi=24,
                                n_eta=48)
    spectra = smooth_spectra_vah(surf, sp, grid, cfg.replace(operation=1))
    dNdy = observables.dN_dy(spectra, grid)[:, 0]
    meanpT = observables.mean_pT(spectra, grid)[:, 0]
    nev = 400
    events = sample.sample_particles(surf, sp, np.arange(1, 7), None, cfg,
                                     ThermoAverages(**PLASMA), nevents=nev)
    mc = np.concatenate([e["mcid"] for e in events])
    pT = np.concatenate([np.hypot(e["px"], e["py"]) for e in events])
    assert mc.size > 5000
    for i in range(6):
        sel = mc == i + 1
        n_s = int(sel.sum())
        got = n_s / (2 * y_cut * nev)
        sig = math.sqrt(max(n_s, 1)) / (2 * y_cut * nev)
        assert abs(got - dNdy[i]) < 5 * sig + 0.02 * dNdy[i], (i, got,
                                                               dNdy[i])
        tol = 5 * pT[sel].std() / math.sqrt(n_s) + 0.01 * meanpT[i]
        assert abs(pT[sel].mean() - meanpT[i]) < tol, (i, pT[sel].mean(),
                                                       meanpT[i])


def test_vah_sampler_df_gate_bit_identical():
    """Without c0..c4 (every real VAH file) the gated sampler's events equal
    the ungated one's byte for byte (w_visc = 1/2 either way); with them
    the gate drops nothing and the chains move the events."""
    sp = species6()
    cells = vah_flow_cells(n=24, seed=11)
    bare = {k: v for k, v in cells.items() if k[0] != "c" or len(k) != 2}
    cfg = Config(operation=2, mode=2, dimension=2, df_mode=2,
                 include_shear_deltaf=1, include_bulk_deltaf=1,
                 regulate_deltaf=1, outflow=1, y_cut=3.0)
    plasma = ThermoAverages(**PLASMA)
    run = lambda c, **kw: sample.sample_particles(
        convert.surface_from_state(c), sp, np.arange(1, 7), None,
        cfg.replace(**kw), plasma, nevents=40, seed=21)
    gated, ungated = run(bare), run(bare, vah_df_gate=0)
    assert sum(len(e["mcid"]) for e in gated) > 100
    assert len(gated) == len(ungated)
    for a, b in zip(gated, ungated):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), k
    chains = run(cells)
    assert any(a["px"].tobytes() != b["px"].tobytes()
               for a, b in zip(gated, chains))


@pytest.mark.parametrize("mode", [1, 2])
def test_search_draws_match_alias_draws_in_distribution(mode):
    """sampler_alias = 0 against the alias draws on the same surface:
    per-species counts within 5 sigma of each other, over many hadrons."""
    if mode == 1:
        cells = feqmod_cells(64, 2, 5, scales=MIXED)
        df_data = convert.deltaf_from_state(jax_state(
            jtesting.synthetic_deltaf_data()))
    else:
        cells = vah_flow_cells(n=30, seed=4)
        df_data = None
    sp = species6()
    cfg = Config(operation=2, mode=mode, dimension=2, df_mode=2, y_cut=3.0,
                 regulate_deltaf=1, **VISC)
    surf = convert.surface_from_state(cells)
    plasma = ThermoAverages(**PLASMA)
    ids = {}
    for alias in (0, 1):
        ev = sample.sample_particles(surf, sp, np.arange(1, 7), df_data,
                                     cfg.replace(sampler_alias=alias),
                                     plasma, nevents=200, seed=8)
        ids[alias] = np.concatenate([e["mcid"] for e in ev])
    assert ids[0].size > 4000
    for m in range(1, 7):
        a, b = int((ids[0] == m).sum()), int((ids[1] == m).sum())
        assert abs(a - b) < 5 * math.sqrt(a + b + 1), (m, a, b)
