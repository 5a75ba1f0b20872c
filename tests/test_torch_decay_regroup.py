"""The MC-decay phase's own input and output handling
(kernels/mc_decays.py: decay_events, cascade_inputs), torch on the events'
device, here on CPU tensors, against the numpy host code it replaced
(copied below as the reference): the same per-event lists in the same
order, mcid and the cascade's state columns bit for bit, tau / eta / yp
within 1e-6 relative in float32 and 1e-12 in float64 (torch's and numpy's
log may differ by an ulp); an unknown mc id raises KeyError; the partition
invariance holds byte for byte; the phase's timings are reported.
"""

import numpy as np
import pytest
import torch

from is3d_tpu_torch import testing
from is3d_tpu_torch.kernels import mc_decays as mcd

torch.set_num_threads(1)

RTOL = {np.float32: 1e-6, np.float64: 1e-12}
STATE_COLUMNS = ("mass", "E", "px", "py", "pz", "t", "x", "y", "z")


# ---------------------------------------------------- the numpy reference

def _concat_events(events, tabs):
    counts = [len(e["E"]) for e in events]
    N = int(sum(counts))
    cols = {k: np.concatenate([np.asarray(e[k]) for e in events])
            for k in mcd.EVENT_FIELDS}
    mcid_in = cols["mcid"].astype(np.int64)
    eid = np.repeat(np.arange(len(events), dtype=np.int32), counts)
    ordv = (np.arange(N, dtype=np.int64)
            - np.repeat(np.cumsum([0] + counts[:-1]).astype(np.int64),
                        counts))
    order = np.argsort(tabs.mc_id, kind="stable")
    pos = np.clip(np.searchsorted(tabs.mc_id[order], mcid_in), 0,
                  len(order) - 1)
    sidx = order[pos].astype(np.int32)
    bad = tabs.mc_id[sidx] != mcid_in
    if bad.any():
        raise KeyError(f"sampled mc id(s) not in the particle table: "
                       f"{np.unique(mcid_in[bad])[:5]}")
    return cols, sidx, eid, ordv


def numpy_decay_events(events, table, seed, event_offset=0):
    """decay_events as it was: the numpy concatenation and split, the
    cascade (the plain passes), the numpy tail and regrouping."""
    tabs = mcd.cached_tables(table, 111)
    cols, sidx, eid, ordv = _concat_events(events, tabs)
    unst = ~tabs.stable[sidx]
    dtype_np = np.asarray(events[0]["E"]).dtype
    dtype = torch.float32 if dtype_np == np.float32 else torch.float64
    key = mcd.rng.seed_key(seed)
    n0 = int(unst.sum())
    passed = {k: v[~unst] for k, v in cols.items()}
    eid_passed = eid[~unst]
    C = 1 << max(0, int(int(tabs.maxmult[sidx[unst]].sum()) - 1)
                 .bit_length())
    st = mcd.initial_state(
        sidx[unst], {k: cols[k][unst] for k in mcd.STATE_FLOATS}, eid[unst],
        eid[unst].astype(np.int64) + int(event_offset), ordv[unst], C, key,
        dtype, "cpu")
    nf = mcd.run_cascade(st, n0, tabs.device(dtype, "cpu"), key,
                         tabs.n_passes)
    host = {k: st[k][:nf].cpu().numpy() for k in
            ("sidx",) + mcd.STATE_FLOATS + ("eid",)}
    sidx_o = host["sidx"]
    assert tabs.stable[sidx_o].all()
    E, pz, t, z = host["E"], host["pz"], host["t"], host["z"]
    casc = dict(mcid=tabs.mc_id[sidx_o],
                mass=tabs.mass[sidx_o].astype(dtype_np), E=E,
                px=host["px"], py=host["py"], pz=pz, t=t, x=host["x"],
                y=host["y"], z=z)
    casc["tau"] = np.sqrt(np.maximum(t * t - z * z, 0.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        casc["eta"] = 0.5 * np.log(
            np.maximum(t + z, 1e-45) / np.maximum(t - z, 1e-45))
        casc["yp"] = 0.5 * np.log((E + pz) / np.maximum(E - pz, 1e-45))
    out_cols = {k: np.concatenate([np.asarray(passed[k], dtype=v.dtype), v])
                for k, v in casc.items()}
    eid_o = np.concatenate([eid_passed, host["eid"]])
    order = np.argsort(eid_o, kind="stable")
    bounds = np.searchsorted(eid_o[order], np.arange(len(events) + 1))
    return [{k: v[order[bounds[e]:bounds[e + 1]]] for k, v in out_cols.items()}
            for e in range(len(events))]


# ------------------------------------------------------------------ inputs

@pytest.fixture(scope="module")
def decaying_table():
    table, _ = testing.synthetic_decaying_table(60, seed=0)
    return table


def mixed_events(table, dtype, seed, sizes=(40, 0, 25, 60, 7)):
    """Events of random species of the table (stable and not), vertices
    off the light cone, an empty event, one of stable hadrons only."""
    tabs = mcd.cached_tables(table, 111)
    r = np.random.default_rng(seed)
    stable = np.flatnonzero(tabs.stable)
    events = []
    for i, n in enumerate(sizes):
        s = (r.choice(stable, n) if i == len(sizes) - 1
             else r.integers(0, len(tabs.mc_id), n))
        m = tabs.mass[s]
        p = r.normal(0, 0.6, (n, 3))
        t = r.uniform(4, 9, n)
        eta = r.normal(0, 1.5, n)
        cols = dict(mcid=tabs.mc_id[s], mass=m,
                    E=np.sqrt(m**2 + (p**2).sum(1)), px=p[:, 0], py=p[:, 1],
                    pz=p[:, 2], t=t * np.cosh(eta), x=r.normal(0, 3, n),
                    y=r.normal(0, 3, n), z=t * np.sinh(eta), tau=t, eta=eta,
                    yp=r.normal(0, 1, n))
        events.append({k: (v if k == "mcid" else v.astype(dtype))
                       for k, v in cols.items()})
    return events


# ------------------------------------------------------------------- tests

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_decay_events_matches_the_numpy_tail(decaying_table, dtype):
    events = mixed_events(decaying_table, dtype, 1)
    info = {}
    got = mcd.decay_events(events, decaying_table, seed=5, event_offset=2,
                           info=info, device="cpu")
    want = numpy_decay_events(events, decaying_table, 5, event_offset=2)
    assert info["hadrons_out"] > info["hadrons_in"] > 0
    assert len(got) == len(want) == len(events)
    assert [len(e["E"]) for e in got] == [len(e["E"]) for e in want]
    assert len(got[1]["E"]) == 0
    for g, w in zip(got, want):
        assert tuple(g) == tuple(w) == mcd.EVENT_FIELDS
        assert g["mcid"].dtype == np.int64
        np.testing.assert_array_equal(g["mcid"], w["mcid"])
        for k in STATE_COLUMNS:
            assert g[k].dtype == w[k].dtype == dtype, k
            assert g[k].tobytes() == w[k].tobytes(), k
        for k in ("tau", "eta", "yp"):
            assert g[k].dtype == w[k].dtype == dtype, k
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL[dtype], atol=0,
                                       equal_nan=True, err_msg=k)
    # the stable-only event passes through untouched
    for k in mcd.EVENT_FIELDS:
        assert got[-1][k].tobytes() == np.asarray(events[-1][k]).tobytes()


def test_cascade_inputs_state_matches_the_numpy_split(decaying_table):
    """The device split's cascade state equals the numpy split's."""
    events = mixed_events(decaying_table, np.float64, 2)
    tabs = mcd.cached_tables(decaying_table, 111)
    inp = mcd.cascade_inputs(events, decaying_table, 111, 9,
                             event_offset=4, device="cpu")
    cols, sidx, eid, ordv = _concat_events(events, tabs)
    unst = ~tabs.stable[sidx]
    assert inp["n0"] == int(unst.sum())
    want = mcd.initial_state(
        sidx[unst], {k: cols[k][unst] for k in mcd.STATE_FLOATS}, eid[unst],
        eid[unst].astype(np.int64) + 4, ordv[unst],
        inp["state"]["E"].shape[0], mcd.rng.seed_key(9), torch.float64,
        "cpu")
    for k, v in want.items():
        assert torch.equal(inp["state"][k], v), k
    np.testing.assert_array_equal(inp["passed"].numpy(),
                                  np.flatnonzero(~unst))


def test_decay_events_without_unstable_hadrons(decaying_table):
    events = mixed_events(decaying_table, np.float32, 3, sizes=(5, 9))
    tabs = mcd.cached_tables(decaying_table, 111)
    stable = np.flatnonzero(tabs.stable)
    for e in events:
        e["mcid"] = tabs.mc_id[stable[:len(e["E"])]]
    info = {}
    got = mcd.decay_events(events, decaying_table, seed=1, info=info,
                           device="cpu")
    assert set(info["timings"]) == {"upload", "lookup"}
    for g, e in zip(got, events):
        for k in mcd.EVENT_FIELDS:
            assert g[k].tobytes() == np.asarray(e[k]).tobytes(), k


def test_decay_events_reports_its_timings(decaying_table):
    info = {}
    mcd.decay_events(mixed_events(decaying_table, np.float32, 4),
                     decaying_table, seed=2, info=info, device="cpu")
    assert tuple(info["timings"]) == mcd.DECAY_TIMINGS
    assert all(v >= 0.0 for v in info["timings"].values())
    assert info["passes"] == mcd.cached_tables(decaying_table,
                                               111).n_passes


def test_decay_events_unknown_mcid_raises(decaying_table):
    events = mixed_events(decaying_table, np.float64, 5)
    events[2]["mcid"] = events[2]["mcid"].copy()
    events[2]["mcid"][3] = 987654321
    with pytest.raises(KeyError, match="987654321"):
        mcd.decay_events(events, decaying_table, seed=1, device="cpu")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_decay_events_partition_invariant(decaying_table, dtype):
    events = mixed_events(decaying_table, dtype, 6, sizes=(30, 12, 0, 41, 8,
                                                           19, 25))
    full = mcd.decay_events(events, decaying_table, seed=41, device="cpu")
    parts = (mcd.decay_events(events[:3], decaying_table, seed=41,
                              device="cpu")
             + mcd.decay_events(events[3:], decaying_table, seed=41,
                                event_offset=3, device="cpu"))
    assert len(parts) == len(full) == 7
    for a, b in zip(full, parts):
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), k
