"""is3d_tpu_torch's Monte-Carlo decay cascade (kernels/mc_decays.py, the
plain torch version, CPU) against is3d_tpu.kernels.mc_decays:

* build_decay_tables equal to is3d_tpu's, array for array, on the
  decaying synthetic list;
* one cascade pass fed is3d_tpu's own uniforms (the Threefry lineage
  draws of _cascade_jit): the same daughters, momenta and vertices at
  rtol 1e-12;
* the physics with the port's own lineage streams, after
  tests/test_mc_decays.py: four-momentum conservation and on-shell
  daughters, the 2-body line energy, the m23 phase-space shape, vertex
  lifetimes, branching ratios, chain termination, closed channels and the
  lightest particle; final yields against is3d_tpu's cascade on the
  decaying list (5 sigma);
* partition invariance: a slice of events decayed with its global offset
  equals the same events decayed in one call, byte for byte.
"""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from is3d_tpu.kernels import mc_decays as jmcd

from is3d_tpu_torch import testing
from is3d_tpu_torch.kernels import mc_decays as mcd, rng

from test_mc_decays import (_mk_table, _events_of, _p4sum, RHO_TABLE,
                            OMEGA_TABLE, CHAIN_TABLE)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def decaying_table():
    table, _ = testing.synthetic_decaying_table(60, seed=0)
    return table


def test_build_decay_tables_match_jax(decaying_table):
    got = mcd.build_decay_tables(decaying_table)
    want = jmcd.build_decay_tables(decaying_table)
    assert got.n_passes == want.n_passes >= 2
    for k in ("mc_id", "mass", "ctau", "stable", "cum", "nd", "d1", "d2",
              "d3", "quant", "maxmult"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    assert (got.nd == 3).any() and (~got.stable).sum() > 10


def random_hadrons(tabs, n, seed):
    r = np.random.default_rng(seed)
    sidx = r.choice(np.flatnonzero(~tabs.stable), n).astype(np.int32)
    m = tabs.mass[sidx]
    p = r.normal(0.0, 0.6, (n, 3))
    cols = dict(px=p[:, 0], py=p[:, 1], pz=p[:, 2],
                E=np.sqrt(m**2 + (p**2).sum(1)), t=r.uniform(4, 9, n),
                x=r.normal(0, 3, n), y=r.normal(0, 3, n), z=r.normal(0, 1, n))
    return sidx, cols


def test_cascade_pass_fed_jax_uniforms_matches_jax(decaying_table):
    tabs = mcd.build_decay_tables(decaying_table)
    n0 = 400
    sidx, cols = random_hadrons(tabs, n0, 1)
    C = 1 << int(int(tabs.maxmult[sidx].sum()) - 1).bit_length()
    eid = np.repeat(np.arange(40), 10).astype(np.int32)
    eg = eid + 7
    ordv = np.tile(np.arange(10), 40).astype(np.int32)
    key = jax.random.key(99)

    def pad(v, dt):
        out = np.zeros(C, dt)
        out[:n0] = v
        return jnp.asarray(out)

    st = jmcd._cascade_jit(
        pad(sidx, np.int32),
        *(pad(cols[k], np.float64) for k in mcd.STATE_FLOATS),
        pad(eid, np.int32), pad(eg, np.int32), pad(ordv, np.int32), n0, key,
        jmcd.build_decay_tables(decaying_table).device(jnp.float64),
        n_passes=1)
    nf = int(st[-1])
    # the uniforms _cascade_jit's first pass draws: fold_in(lineage, 0)
    u = jax.vmap(lambda e, o: jax.random.uniform(jax.random.fold_in(
        jax.random.fold_in(jax.random.fold_in(key, e), o), 0), (7,),
        dtype=jnp.float64))(jnp.asarray(eg), jnp.asarray(ordv))

    port = mcd.initial_state(sidx, cols, eid, eg.astype(np.int64), ordv, C,
                             rng.seed_key(5), torch.float64, "cpu")
    kids = tuple(torch.zeros((n0, 2), dtype=torch.int64) for _ in range(3))
    n = mcd.cascade_pass_plain(port, n0, tabs.device(torch.float64, "cpu"),
                               torch.from_numpy(np.array(u).T.copy()), kids)
    assert n == nf > n0
    np.testing.assert_array_equal(port["sidx"][:n].numpy(),
                                  np.asarray(st[0])[:n])
    np.testing.assert_array_equal(port["eid"][:n].numpy(),
                                  np.asarray(st[9])[:n])
    for i, k in enumerate(mcd.STATE_FLOATS):
        want = np.asarray(st[1 + i])[:n]
        np.testing.assert_allclose(port[k][:n].numpy(), want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max(),
                                   err_msg=k)


def test_lineage_streams():
    """Root words hash (event, ordinal); children hash (parent, j); the
    draws of a hadron depend on its word only."""
    key = rng.seed_key(3)
    lin = rng.root_lineage(key, torch.tensor([5, 5, 6]), torch.tensor([0, 1,
                                                                       0]))
    assert len({tuple(r) for r in lin.tolist()}) == 3
    kids = [rng.child_lineage(key, lin, j) for j in (1, 2, 3)]
    assert len({tuple(k[0].tolist()) for k in kids}) == 3
    u = rng.decay_uniforms(key, lin, torch.float64)
    assert u.shape == (rng.N_DECAY_DRAWS, 3)
    np.testing.assert_array_equal(
        rng.decay_uniforms(key, lin[1:2], torch.float64)[:, 0], u[:, 1])


# --------------------------------------------- physics on the port's streams

def test_two_body_conservation_onshell_and_line_energy():
    r = np.random.default_rng(1)
    ev = _events_of(113, 0.7752, r.normal(0.0, 1.2, size=(4000, 3)))
    o = mcd.decay_events(ev, RHO_TABLE, seed=3, device="cpu")[0]
    assert len(o["E"]) == 8000
    assert set(np.unique(o["mcid"])) == {-211, 211}
    np.testing.assert_allclose(_p4sum(o), _p4sum(ev[0]), rtol=1e-9)
    m2 = o["E"]**2 - o["px"]**2 - o["py"]**2 - o["pz"]**2
    np.testing.assert_allclose(m2, 0.1396**2, rtol=1e-6)
    rest = mcd.decay_events(_events_of(113, 0.7752, np.zeros((500, 3))),
                            RHO_TABLE, seed=5, device="cpu")[0]
    np.testing.assert_allclose(rest["E"], 0.7752 / 2.0, rtol=1e-9)
    sel = rest["mcid"] == 211
    cth = rest["pz"][sel] / np.sqrt(rest["px"][sel]**2 + rest["py"][sel]**2
                                    + rest["pz"][sel]**2)
    assert abs(cth.mean()) < 4.0 / math.sqrt(3 * sel.sum())


def test_three_body_conservation_and_m23_shape():
    M, mpi, mpi0 = 0.7827, 0.1396, 0.1350
    ev = _events_of(223, M, np.zeros((20000, 3)))
    o = mcd.decay_events(ev, OMEGA_TABLE, seed=11, device="cpu")[0]
    assert len(o["E"]) == 60000
    np.testing.assert_allclose(_p4sum(o), _p4sum(ev[0]), rtol=1e-9,
                               atol=1e-7)
    sel = o["mcid"] == 211
    E23 = M - o["E"][sel]
    p23 = np.stack([-o["px"][sel], -o["py"][sel], -o["pz"][sel]], axis=1)
    m23 = np.sqrt(np.maximum(E23**2 - (p23**2).sum(axis=1), 0.0))
    lo, hi = mpi + mpi0, M - mpi
    assert m23.min() > lo - 1e-6 and m23.max() < hi + 1e-6
    g = np.linspace(lo, hi, 41)
    centers = 0.5 * (g[1:] + g[:-1])
    w = mcd._pstar(M, mpi, centers) * mcd._pstar(centers, mpi, mpi0)
    w /= w.sum()
    hist, _ = np.histogram(m23, bins=g)
    frac = hist / hist.sum()
    err = np.sqrt(np.maximum(w * (1 - w) / hist.sum(), 1e-12))
    assert np.all(np.abs(frac - w) < 6 * err + 0.1 * w)


def test_decay_vertex_timelike_and_lifetime():
    from is3d_tpu_torch.units import HBARC
    r = np.random.default_rng(2)
    p4s = r.normal(0.0, 0.8, size=(20000, 3))
    o = mcd.decay_events(_events_of(113, 0.7752, p4s, t0=5.0), RHO_TABLE,
                         seed=13, device="cpu")[0]
    dt = o["t"] - 5.0
    dr = np.sqrt(o["x"]**2 + o["y"]**2 + o["z"]**2)
    assert np.all(dt >= 0.0) and np.all(dr <= dt + 1e-9)
    M = 0.7752
    Ep = np.sqrt(M**2 + (p4s**2).sum(axis=1))
    np.testing.assert_allclose(np.mean(dt), (HBARC / 0.1491) * np.mean(Ep) / M,
                               rtol=0.1)


def test_branching_ratios_chain_closed_and_lightest():
    tab = _mk_table(
        [(800, 1.5, 0.2, False), (801, 0.2, 0.0, True), (802, 0.3, 0.0, True),
         (803, 0.4, 0.0, True)],
        {800: [(0.6, [801, 801]), (0.3, [802, 802]), (0.1, [801, 802, 803])]})
    o = mcd.decay_events(_events_of(800, 1.5, np.zeros((30000, 3))), tab,
                         seed=17, device="cpu")[0]
    n3 = (o["mcid"] == 803).sum()
    n_ch2 = ((o["mcid"] == 802).sum() - n3) // 2
    n_ch1 = ((o["mcid"] == 801).sum() - n3) // 2
    tot = n3 + n_ch1 + n_ch2
    assert tot == 30000
    for frac, want in ((n_ch1 / tot, 0.6), (n_ch2 / tot, 0.3),
                       (n3 / tot, 0.1)):
        assert abs(frac - want) < 5 * math.sqrt(want * (1 - want) / tot)
    # a two-generation chain runs to the stable leaves in one call
    r = np.random.default_rng(3)
    ev = _events_of(900, 2.0, r.normal(0, 1, (3000, 3)))
    o = mcd.decay_events(ev, CHAIN_TABLE, seed=19, device="cpu")[0]
    assert sorted(np.unique(o["mcid"])) == [902, 903, 904]
    assert len(o["E"]) == 9000
    np.testing.assert_allclose(_p4sum(o), _p4sum(ev[0]), rtol=1e-9)
    # closed channels: stable, or renormalized over the open ones
    closed = _mk_table(
        [(810, 0.5, 0.1, False), (811, 0.4, 0.0, True), (812, 0.3, 0.0, True)],
        {810: [(1.0, [811, 812])]})
    assert mcd.build_decay_tables(closed).stable.all()
    part = _mk_table(
        [(820, 1.0, 0.1, False), (821, 0.4, 0.0, True), (822, 0.3, 0.0, True)],
        {820: [(0.5, [821, 821, 821]), (0.5, [821, 822])]})
    o2 = mcd.decay_events(_events_of(820, 1.0, np.zeros((50, 3))), part,
                          seed=23, device="cpu")[0]
    assert sorted(np.unique(o2["mcid"])) == [821, 822]
    assert len(o2["E"]) == 100
    pi0 = _mk_table([(111, 0.1350, 7.8e-9, False), (22, 0.0, 0.0, True)],
                    {111: [(1.0, [22, 22])]})
    ev = _events_of(111, 0.1350, np.zeros((10, 3)))
    assert np.all(mcd.decay_events(ev, pi0, seed=29,
                                   lightest_particle=111,
                                   device="cpu")[0]["mcid"] == 111)
    assert np.all(mcd.decay_events(ev, pi0, seed=29,
                                   lightest_particle=22,
                                   device="cpu")[0]["mcid"] == 22)


def _mixed_events(tabs, n_events, per_event, seed):
    """Events of random species of the table (stable and not)."""
    r = np.random.default_rng(seed)
    events = []
    for _ in range(n_events):
        s = r.integers(0, len(tabs.mc_id), per_event)
        m = tabs.mass[s]
        p = r.normal(0, 0.5, (per_event, 3))
        E = np.sqrt(m**2 + (p**2).sum(1))
        z = np.zeros(per_event)
        events.append(dict(mcid=tabs.mc_id[s], mass=m, E=E, px=p[:, 0],
                           py=p[:, 1], pz=p[:, 2], t=z + 6.0, x=z, y=z, z=z,
                           tau=z + 6.0, eta=z, yp=z))
    return events


def test_final_yields_match_jax_cascade(decaying_table):
    tabs = mcd.build_decay_tables(decaying_table)
    events = _mixed_events(tabs, 20, 400, 4)
    got = mcd.decay_events(events, decaying_table, seed=31, device="cpu")
    want = jmcd.decay_events(events, decaying_table, seed=31)
    a = np.concatenate([e["mcid"] for e in got])
    b = np.concatenate([e["mcid"] for e in want])
    index = {int(m): i for i, m in enumerate(tabs.mc_id)}
    assert all(tabs.stable[index[int(m)]] for m in np.unique(a))
    for m in np.unique(np.concatenate([a, b])):
        na, nb = (a == m).sum(), (b == m).sum()
        assert abs(na - nb) < 5 * math.sqrt(na + nb + 1), (m, na, nb)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_p4sum(g), _p4sum(w), rtol=1e-9)


def test_partition_invariant_lineage_streams(decaying_table):
    tabs = mcd.build_decay_tables(decaying_table)
    events = _mixed_events(tabs, 7, 30, 6)
    full = mcd.decay_events(events, decaying_table, seed=41, device="cpu")
    parts = (mcd.decay_events(events[:3], decaying_table, seed=41,
                              device="cpu")
             + mcd.decay_events(events[3:], decaying_table, seed=41,
                                event_offset=3, device="cpu"))
    assert len(parts) == len(full) == 7
    for a, b in zip(full, parts):
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), k
    shifted = mcd.decay_events(events[3:], decaying_table, seed=41,
                               device="cpu")
    assert any(a["px"].tobytes() != b["px"].tobytes()
               for a, b in zip(full[3:], shifted))


def test_unknown_mcid_raises():
    ev = _events_of(999, 1.0, np.zeros((3, 3)))
    with pytest.raises(KeyError):
        mcd.decay_events(ev, RHO_TABLE, seed=1, device="cpu")


@pytest.mark.parametrize("entry", ["decay_events", "cascade_inputs"])
def test_decay_entry_points_default_to_the_card(monkeypatch, entry):
    """decay_events and cascade_inputs run on cuda unless the caller names
    the CPU: without CUDA, a call that names no device raises naming CUDA
    (api.resolve_device), never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ev = _events_of(113, 0.7752, np.zeros((10, 3)))
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "decay_events":
            mcd.decay_events(ev, RHO_TABLE, seed=3)
        else:
            mcd.cascade_inputs(ev, RHO_TABLE, 111, 3)
    assert len(mcd.decay_events(ev, RHO_TABLE, seed=3,
                                device="cpu")[0]["E"]) == 20
