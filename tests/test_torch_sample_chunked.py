"""The cell-chunked sampler of is3d_tpu_torch against is3d_tpu's
(_sample_cell_chunked; the plain torch path, CPU, f64):

* ``_chunk_seed`` equal to is3d_tpu's, and the inert padding of the last
  chunk equal to its _chunk_cols;
* the scalar pre-pass: every chunk's (lam, mean) equal to is3d_tpu's
  _cell_scalars_jit / _vah_cell_scalars_jit at rtol 1e-9, on viscous
  (df 2 and df 3) and anisotropic surfaces, and equal to the full phase
  A's sums;
* ``calculate_total_yield`` above the chunk bound equal to is3d_tpu's;
* chunked runs: the plan (chunks, batches), event_partition slices that
  concatenate to the whole chunked run byte for byte, a run that
  reproduces itself, per-species yields within 5 sigma of the unchunked
  run's and of is3d_tpu's chunked run, with the alias and the search
  draws.
"""

import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from is3d_tpu import testing as jtesting
from is3d_tpu.config import Config as JConfig
from is3d_tpu.io.surface import Surface as JSurface, ThermoAverages as JAvg
from is3d_tpu.kernels import sample as jsample

from is3d_tpu_torch import convert, testing
from is3d_tpu_torch.config import Config
from is3d_tpu_torch.io.surface import ThermoAverages
from is3d_tpu_torch.kernels import sample

from test_torch_sample import PLASMA, VISC, species_pair
from test_torch_feqmod import feqmod_cells, MIXED
from test_torch_smooth import jax_state

torch.set_num_threads(1)


def test_chunk_seed_matches_jax():
    for seed in (0, 17, 2**31 - 1, 2**62 + 5):
        for ci in (0, 1, 2, 11):
            assert sample._chunk_seed(seed, ci) == jsample._chunk_seed(seed,
                                                                       ci)
    assert len({sample._chunk_seed(3, ci) for ci in range(64)}) == 64


def test_chunk_padding_matches_jax():
    cells = testing.synthetic_vah_cells(37, 2, seed=1)
    cols = {k: torch.from_numpy(v) for k, v in cells.items()}
    jcols = {k: jnp.asarray(v) for k, v in cells.items()}
    got = sample._chunk_cols(cols, 32, 37, 16)
    want = jsample._chunk_cols(jcols, 32, 37, 16)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert (got["dat"][5:] == 0).all() and (got["Lambda"][5:] == 1).all()
    full = sample._chunk_cols(cols, 0, 16, 16)
    assert all(full[k] is not cols[k] and torch.equal(full[k], cols[k][:16])
               for k in cols)


SURFACES = {
    # (mode, df_mode, cells, chunk)
    "vh_df2": (1, 2, 83, 32),
    "vh_df3": (1, 3, 83, 32),
    "vah_chains": (2, 2, 70, 24),
}


def surface_pair(name, dimension=2, seed=5):
    mode, df_mode, n, chunk = SURFACES[name]
    if mode == 1:
        cells = feqmod_cells(n, dimension, seed, scales=MIXED)
    else:
        cells = testing.synthetic_vah_cells(n, dimension, seed=seed)
        cells.update(testing.synthetic_vah_coefficients(cells, seed=seed))
    kw = dict(operation=2, mode=mode, dimension=dimension, df_mode=df_mode,
              y_cut=3.0, regulate_deltaf=1, sampler_cell_chunk=chunk, **VISC)
    return (convert.surface_from_state(cells),
            JSurface(**{k: jnp.asarray(v) for k, v in cells.items()}),
            Config(**kw), JConfig(**kw), chunk)


@pytest.mark.parametrize("name", sorted(SURFACES))
def test_chunk_prepass_matches_jax(name):
    surf, jsurf, cfg, jcfg, chunk = surface_pair(name)
    jsp, sp = species_pair()
    jdf = jtesting.synthetic_deltaf_data()
    df = convert.deltaf_from_state(jax_state(jdf))
    lag = jsample._laguerre_device(jnp.float64)
    plan = sample._ChunkPlan(surf, sp, df, sample.sampler_effective_cfg(
        surf, cfg), ThermoAverages(**PLASMA), None, chunk)
    vah = cfg.mode in (2, 3)
    jcfg = jsample._sampler_effective_cfg(jsurf, jcfg)
    jcols = (jsample._vah_sampler_cols(jsurf, jcfg) if vah
             else jsample._sampler_cols(jsurf, jcfg))
    avg = (jnp.asarray(PLASMA["temperature"]),
           jnp.asarray(PLASMA["baryon_chemical_potential"]))
    C = surf.tau.shape[0]
    assert plan.n_chunks == -(-C // chunk) >= 3
    for ci, (lo, hi) in enumerate(plan.bounds):
        cc = jsample._chunk_cols(jcols, lo, hi, chunk)
        want = (jsample._vah_cell_scalars_jit(cc, jsp, lag, jcfg) if vah
                else jsample._cell_scalars_jit(cc, jsp, jdf, lag, avg, jcfg))
        got = plan.build(ci, scalars=True)
        for k in ("lam", "mean"):
            assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-9)
        full = plan.build(ci, scalars=False)
        assert float(got["lam"]) == float(full["dn_tot"].sum())
        assert float(got["lam"]) > 0


@pytest.mark.parametrize("name", ["vh_df3", "vah_chains"])
def test_calculate_total_yield_chunked_matches_jax(name):
    surf, jsurf, cfg, jcfg, _ = surface_pair(name)
    jsp, sp = species_pair()
    jdf = jtesting.synthetic_deltaf_data()
    want = jsample.calculate_total_yield(jsurf, jsp, jdf, jcfg, JAvg(**PLASMA))
    got = sample.calculate_total_yield(
        surf, sp, convert.deltaf_from_state(jax_state(jdf)), cfg,
        ThermoAverages(**PLASMA))
    assert got == pytest.approx(want, rel=1e-9)
    # the chunks' means add up to the unchunked surface's
    whole = sample.calculate_total_yield(
        surf, sp, convert.deltaf_from_state(jax_state(jdf)),
        cfg.replace(sampler_cell_chunk=-1), ThermoAverages(**PLASMA))
    assert got == pytest.approx(whole, rel=1e-12)


def _events(name, alias=1, **kw):
    surf, _, cfg, _, _ = surface_pair(name)
    _, sp = species_pair()
    df = convert.deltaf_from_state(jax_state(jtesting.synthetic_deltaf_data()))
    info = {}
    ev = sample.sample_particles(
        surf, sp, np.arange(101, 110), None if cfg.mode in (2, 3) else df,
        cfg.replace(sampler_alias=alias), ThermoAverages(**PLASMA),
        info=info, **kw)
    return ev, info


def _same_events(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].tobytes() == \
                y[k].tobytes(), k


@pytest.mark.parametrize("name,alias", [("vh_df2", 1), ("vah_chains", 0)])
def test_chunked_partitions_concatenate_byte_identical(name, alias):
    full, info = _events(name, alias, nevents=7, seed=9, events_per_batch=2)
    assert info["chunks"] == 3 and info["event_lo"] == 0
    assert info["batches"] == 3 * 4     # four batches a chunk
    parts = []
    for k in range(3):
        ev, part = _events(name, alias, nevents=7, seed=9,
                           event_partition=(k, 3))
        assert part["event_lo"] == (k * 7) // 3
        parts.extend(ev)
    _same_events(full, parts)
    again, _ = _events(name, alias, nevents=7, seed=9)
    _same_events(full, again)
    assert sum(len(e["mcid"]) for e in full) > 100


@pytest.mark.parametrize("name,alias", [("vh_df3", 1), ("vah_chains", 1),
                                        ("vh_df2", 0)])
def test_chunked_matches_unchunked_and_jax_in_distribution(name, alias):
    """Per-species yields of the chunked run within 5 sigma of the
    unchunked run's and of is3d_tpu's chunked run's."""
    nev = 150
    chunked, info = _events(name, alias, nevents=nev, seed=4)
    surf, jsurf, cfg, jcfg, _ = surface_pair(name)
    jsp, sp = species_pair()
    jdf = jtesting.synthetic_deltaf_data()
    df = convert.deltaf_from_state(jax_state(jdf))
    whole = sample.sample_particles(
        surf, sp, np.arange(101, 110), None if cfg.mode in (2, 3) else df,
        cfg.replace(sampler_cell_chunk=-1, sampler_alias=alias),
        ThermoAverages(**PLASMA), nevents=nev, seed=4)
    ref = jsample.sample_particles(
        jsurf, jsp, np.arange(101, 110), None, jdf,
        jcfg.replace(sampler_alias=alias), JAvg(**PLASMA), nevents=nev,
        seed=4)
    ids = [np.concatenate([e["mcid"] for e in ev])
           for ev in (chunked, whole, ref)]
    assert info["chunks"] == 3 and ids[0].size > 3000
    for m in range(101, 110):
        a = int((ids[0] == m).sum())
        for other in ids[1:]:
            b = int((other == m).sum())
            assert abs(a - b) < 5 * math.sqrt(a + b + 1), (m, a, b)


def test_default_chunk_bound_matches_jax():
    for v, C in ((0, 1 << 20), (0, (1 << 20) + 1), (-1, 1 << 22), (64, 64),
                 (64, 65), (0, 1179648)):
        cfg = Config(sampler_cell_chunk=v)
        assert sample.resolve_cell_chunk(cfg, C) == \
            jsample._resolve_cell_chunk(JConfig(sampler_cell_chunk=v), C)
    assert sample.resolve_cell_chunk(Config(), 1179648) == 1 << 19
