"""is3d_tpu_torch's sampler, module by module, against is3d_tpu on the same
inputs (the plain torch versions, CPU, f64):

* the port's Philox-4x32-10 (kernels/rng.py, 16-bit limbs) against a
  pure-Python big-int Philox and Random123's known answers;
* phase A (``cell_data``) against is3d_tpu's _cell_data_jit for df 1-4 and
  fast 0 and 1: dn_tot, mean_cell, the species CDF, the LRF fields, the
  feqmod fields and the breakdown, at rtol 1e-9 (atol 1e-12 x max);
* the Walker-alias tables (the plain Vose pass) against is3d_tpu's
  _alias_build, and the pmf they realize against the weights at 1e-12;
* a replayed event: the uniforms is3d_tpu's _one_event draws for one event
  (split(key, 8), the rejection split chain, fold_in(key, 987654321)),
  with its count n, fed through the port's event_batch_plain on is3d_tpu's
  own cell data: the kept hadrons equal, momenta at rtol 1e-9, in 2+1D and
  3+1D and every df mode (and with is3d_tpu rebuilding the tetrad per
  slot, which the port's inert sampler_gather_tetrad = 0 gathers).

Inputs are made with numpy from a seed (is3d_tpu.testing's synthetic
surface) and carried to the port with is3d_tpu_torch.convert.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from is3d_tpu import testing as jtesting
from is3d_tpu.config import Config as JConfig
from is3d_tpu.io.surface import Surface as JSurface, ThermoAverages as JAvg
from is3d_tpu.kernels import sample as jsample

from is3d_tpu_torch import convert
from is3d_tpu_torch.config import Config
from is3d_tpu_torch.io.surface import ThermoAverages
from is3d_tpu_torch.kernels import rng, sample

from test_torch_smooth import jax_state
from test_torch_feqmod import feqmod_cells, MIXED

torch.set_num_threads(1)

RTOL = 1e-9
ATOL_REL = 1e-12
VISC = dict(include_shear_deltaf=1, include_bulk_deltaf=1)
PLASMA = dict(temperature=0.152, energy_density=0.33, pressure=0.057,
              baryon_chemical_potential=0.0, net_baryon_density=0.0)


# ------------------------------------------------------------------ Philox

def philox_bigint(ctr, key):
    """Philox-4x32-10 in Python integers (Salmon et al., SC11)."""
    M = (0xD2511F53, 0xCD9E8D57)
    W = (0x9E3779B9, 0xBB67AE85)
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + W[0]) % 2**32, (k1 + W[1]) % 2**32
        p0, p1 = M[0] * c0, M[1] * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 % 2**32,
                          (p0 >> 32) ^ c3 ^ k1, p0 % 2**32)
    return c0, c1, c2, c3


def test_philox_matches_bigint_and_known_answers():
    m = 0xFFFFFFFF
    known = {((0, 0, 0, 0), (0, 0)):
             (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8),
             ((m, m, m, m), (m, m)):
             (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
              (0xA4093822, 0x299F31D0)):
             (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)}
    for (ctr, key), want in known.items():
        assert philox_bigint(ctr, key) == want
        got = rng.philox4x32(*ctr, key)
        assert tuple(int(w) for w in got) == want
    r = np.random.default_rng(0)
    ctr = r.integers(0, 2**32, (4, 257), dtype=np.uint64).astype(np.int64)
    key = tuple(int(k) for k in r.integers(0, 2**32, 2, dtype=np.uint64))
    got = rng.philox4x32(*(torch.from_numpy(c) for c in ctr), key)
    for i in range(ctr.shape[1]):
        want = philox_bigint(tuple(int(c) for c in ctr[:, i]), key)
        assert tuple(int(g[i]) for g in got) == want


def test_uniform_conversions_and_stream_keys():
    """24 bits a float32 uniform, 53 bits (two words) a float64 one, [tiny,
    1) with open0; a slot's draws depend on (seed, event, slot, round)
    only."""
    key = rng.seed_key(2**40 + 17)
    assert key == (17, 256)
    slots, events = torch.arange(6), torch.tensor(3)
    for dtype in (torch.float32, torch.float64):
        u = rng.slot_uniforms(key, slots, events, dtype)
        assert u.shape == (rng.N_DRAWS, 6) and u.dtype == dtype
        assert ((u >= 0) & (u < 1)).all()
        w = rng.philox4x32(slots, events, rng.SLOT_ROUND * 16, rng.SAMPLE_TAG,
                           key)
        if dtype == torch.float32:
            want = [(int(w[0][i]) >> 8) * 2.0**-24 for i in range(6)]
        else:
            want = [((int(w[0][i]) >> 5) * 2**26 + (int(w[1][i]) >> 6))
                    * 2.0**-53 for i in range(6)]
        np.testing.assert_array_equal(u[0].double().numpy(), want)
        # the same slot of another batch layout draws the same numbers
        again = rng.slot_uniforms(key, torch.tensor([4]), events, dtype)
        assert torch.equal(again[:, 0], u[:, 4])
        r0 = rng.slot_uniforms(key, slots, events, dtype, round_=0,
                               open0=True)
        assert (r0 >= torch.finfo(dtype).tiny).all()
        assert not torch.equal(r0, u)
    assert rng.poisson_counts(5, [0, 1, 7], 1e6)[2] == \
        rng.poisson_counts(5, [7], 1e6)[0]


# ----------------------------------------------------------------- phase A

def species_pair(n_species=9, seed=0):
    """(JAX species, port species) with nonzero surface-averaged
    densities (the mean yield and fast mode read them)."""
    jsp = jtesting.synthetic_species(n_species=n_species)
    r = np.random.default_rng(seed)
    jsp = jsp.replace(
        equilibrium_density=jnp.asarray(r.uniform(0.01, 0.3, n_species)),
        bulk_density=jnp.asarray(r.uniform(-0.2, 0.2, n_species)),
        diff_density=jnp.asarray(r.uniform(-0.01, 0.01, n_species)))
    return jsp, convert.species_from_state(jax_state(jsp))


def cell_pair(df_mode, fast, dimension=2, n=57, seed=3, baryon=False):
    cells = feqmod_cells(n, dimension, seed, scales=MIXED, baryon=baryon)
    if baryon:      # a baryon diffusion current
        r = np.random.default_rng(seed + 2000)
        cells.update(Vx=r.normal(0, 0.01, n), Vy=r.normal(0, 0.01, n),
                     Vn=r.normal(0, 0.002, n))
    kw = dict(operation=2, mode=1, dimension=dimension, df_mode=df_mode,
              fast=fast, y_cut=3.0, **VISC)
    if baryon:
        kw.update(include_baryon=1, include_baryondiff_deltaf=1)
    jsp, sp = species_pair()
    jdf = jtesting.synthetic_deltaf_data()
    jcfg = JConfig(**kw)
    want = jsample._build_cell_data(
        JSurface(**{k: jnp.asarray(v) for k, v in cells.items()}), jsp, jdf,
        jcfg, JAvg(**PLASMA), jsample._laguerre_device(jnp.float64))
    cfg = Config(**kw)
    got = sample.build_cell_data(
        convert.surface_from_state(cells), sp,
        convert.deltaf_from_state(jax_state(jdf)), cfg,
        ThermoAverages(**PLASMA))
    return got, want, cfg


CELL_FIELDS = ("dn_tot", "mean_cell", "dst", "dsx", "dsy", "dsz", "ds_max",
               "pixx", "pixy", "pixz", "piyy", "piyz", "pizz", "Vx", "Vy",
               "Vz", "Xt", "Xx", "Xy", "Xn", "Yx", "Yy", "Zt", "Zn", "T_mod",
               "alphaB_mod", "shear_mod", "bulk_mod", "diff_mod", "benth",
               "df_betapi", "df_F", "df_c0", "df_delta_z")


def assert_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_REL * scale)


@pytest.mark.parametrize("fast", [0, 1])
@pytest.mark.parametrize("df_mode", [1, 2, 3, 4])
def test_cell_data_matches_jax(df_mode, fast):
    got, want, _ = cell_pair(df_mode, fast)
    for k in CELL_FIELDS:
        assert_close(got[k].numpy(), want[k])
    assert_close(torch.cumsum(got["dn_list"], 1).numpy(), want["rowcum"])
    np.testing.assert_array_equal(got["breakdown"].numpy(),
                                  np.asarray(want["breakdown"]))
    assert np.asarray(want["dn_tot"]).sum() > 0
    if df_mode == 3 and not fast:
        # the surface mixes clean and broken-down cells
        assert 0 < np.asarray(want["breakdown"]).sum() < len(want["tau"])


def test_cell_data_3d_baryon_matches_jax():
    got, want, _ = cell_pair(2, 0, dimension=3, baryon=True)
    for k in CELL_FIELDS + ("alphaB",):
        assert_close(got[k].numpy(), want[k])
    assert np.abs(np.asarray(want["Vx"])).max() > 0


# ------------------------------------------------------------ alias tables

def realized_pmf(prob, alias):
    """The categorical each alias row realizes: (prob[k] + sum over b with
    alias[b] = k of (1 - prob[b])) / K."""
    prob, alias = np.asarray(prob, np.float64), np.asarray(alias)
    R, K = prob.shape
    pmf = prob.copy()
    for r in range(R):
        np.add.at(pmf[r], alias[r], 1.0 - prob[r])
    return pmf / K


def test_alias_tables_match_jax_and_weights():
    r = np.random.default_rng(5)
    w = r.lognormal(0.0, 3.0, (6, 37)) * (r.random((6, 37)) > 0.4)
    w[2] = 0.0                                   # a zero row: uniform
    w[3, :] = 0.0
    w[3, 11] = 2.5                               # one entry takes it all
    w[4] = 1.0                                   # a flat row
    got_p, got_a = sample.alias_build(torch.from_numpy(w))
    want_p, want_a = jsample._alias_build(jnp.asarray(w))
    # XLA rounds the row scaling its own way (1 ulp): the tables may differ
    # in the last bit, the pmf they realize not beyond 1e-12
    pmf = realized_pmf(got_p.numpy(), got_a.numpy())
    assert np.abs(pmf - realized_pmf(want_p, want_a)).sum(1).max() < 1e-12
    tot = w.sum(1, keepdims=True)
    target = np.where(tot > 0, w / np.where(tot > 0, tot, 1), 1.0 / 37)
    assert np.abs(pmf - target).sum(1).max() < 1e-12
    assert (pmf[w == 0][tot.repeat(37, 1)[w == 0] > 0] == 0).all()


def test_alias_tables_of_cell_data_match_jax():
    got, want, _ = cell_pair(2, 0)
    tables = sample.build_alias_tables(got["dn_list"], got["dn_tot"])
    for k in ("grp", "blk", "sp"):
        pmf_got = realized_pmf(tables[k + "_prob"].numpy(),
                               tables[k + "_alias"].numpy())
        pmf_want = realized_pmf(want[k + "_prob"], want[k + "_alias"])
        assert np.abs(pmf_got - pmf_want).sum(1).max() < 1e-12


# ---------------------------------------------------------- replayed event

class JaxReplaySource:
    """The uniforms is3d_tpu's _one_event draws for one event from ``key``
    (is3d_tpu/kernels/sample.py:850-1023), in the port's source interface:
    the slot draws ks[1], ks[5], ks[2], ks[4] and fold_in(key, 987654321),
    and the rejection chain from ks[3], one split a round."""

    def __init__(self, key, n_cap, lam):
        ks = jax.random.split(key, 8)
        u = lambda k: np.asarray(jax.random.uniform(k, (n_cap,),
                                                    dtype=jnp.float64))
        self.slot = torch.from_numpy(np.stack(
            [u(ks[1]), u(ks[5]), u(ks[2]), u(ks[4]),
             u(jax.random.fold_in(key, 987654321))])[:, None, :])
        self.n = int(jax.random.poisson(ks[0], lam))
        self.chain, self.rounds, self.n_cap = ks[3], [], n_cap

    def slot_draws(self, ev, slot):
        return self.slot[:, ev, slot]

    def round_draws(self, r, ev, slot):
        while len(self.rounds) <= r:
            self.chain, sub = jax.random.split(self.chain)
            self.rounds.append(torch.from_numpy(np.array(
                jax.random.uniform(sub, (5, self.n_cap), dtype=jnp.float64,
                                   minval=jnp.finfo(jnp.float64).tiny,
                                   maxval=1.0)))[:, None, :])
        return self.rounds[r][:, ev, slot]


@pytest.mark.parametrize("dimension,df_mode,tetrad", [
    (2, 1, 1), (2, 2, 0), (3, 2, 1), (2, 3, 1), (3, 4, 1)])
def test_replayed_event_matches_jax(dimension, df_mode, tetrad):
    # 3+1D samples one unit of rapidity, 2+1D six: as many hadrons
    cells = feqmod_cells(40 if dimension == 2 else 240, dimension, 7,
                         scales=MIXED)
    kw = dict(operation=2, mode=1, dimension=dimension, df_mode=df_mode,
              y_cut=3.0, sampler_gather_tetrad=tetrad, **VISC)
    jsp, sp = species_pair()
    jcfg = JConfig(**kw)
    cell = jsample._build_cell_data(
        JSurface(**{k: jnp.asarray(v) for k, v in cells.items()}), jsp,
        jtesting.synthetic_deltaf_data(), jcfg, JAvg(**PLASMA),
        jsample._laguerre_device(jnp.float64))
    lam = float(jnp.sum(cell["dn_tot"]))
    n_cap = jsample._slot_capacity(lam)
    key = jax.random.fold_in(jax.random.key(11), 4)
    want = jax.jit(jsample._one_event, static_argnames=("n_cap", "cfg"))(
        cell, jsp, key, jnp.asarray(lam), n_cap=n_cap, cfg=jcfg)

    src = JaxReplaySource(key, n_cap, jnp.asarray(lam))
    port_cell = {k: torch.from_numpy(np.array(v)) for k, v in cell.items()}
    tables = {k: port_cell[k] for k in ("grp_prob", "grp_alias", "blk_prob",
                                        "blk_alias", "sp_prob", "sp_alias")}
    cfg = Config(**kw)
    rows, _ = sample.pack_rows(port_cell, cfg)
    got = sample.event_batch_plain(rows, tables, sp,
                                   torch.tensor([src.n], dtype=torch.int32),
                                   src, n_cap, cfg)
    keep = np.asarray(want["keep"])
    assert 20 < keep.sum() < src.n
    np.testing.assert_array_equal(got["keep"][0].numpy(), keep)
    valid = np.arange(n_cap) < src.n
    for k in ("sidx", "cidx"):
        np.testing.assert_array_equal(got[k][0].numpy()[valid],
                                      np.asarray(want[k])[valid])
    for k in ("px", "py", "pz", "eta"):
        assert_close(got[k][0].numpy()[keep], np.asarray(want[k])[keep])
    # every valid slot proposed at least once; JAX's acceptance count
    assert int(got["ok"].sum()) == int(want["acceptances"])
    assert int(got["rounds"].sum()) == int(want["samples"])
