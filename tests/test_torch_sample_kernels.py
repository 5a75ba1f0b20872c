"""The sampler's and the cascade's kernel wrappers without JAX: the CPU
dispatch takes the plain versions and never loads a kernel; the wrappers
refuse CPU tensors; the edge inputs (is3d_tpu_torch.testing's
SAMPLE_EDGES, YIELDS_EDGES, alias_edge_weights, cascade_edge_inputs) are
what they claim; the packed plain version is pack_batch of the per-slot one; the
interleaved (prob, alias) tables' views; the wide decay tables give the
same cascade; and, on a CUDA card (gpu-marked), K7 (per-slot and packed;
viscous and anisotropic hydro, alias and search draws), K7a, K7b and K8
against their plain versions on those inputs (K8 pass by pass
and whole, on 4 and 64 channels a species, queued with no host sync, two
runs bit-identical, its overflow guard; decay_events on the card against
the CPU run).

On the GPU: python -m pytest tests/test_torch_sample_kernels.py -m gpu
--noconftest (the conftest imports jax).  Tolerances: K7a identical
tables; K7 slot by slot, f64 with no flipped decision (acceptance,
rounds, keep) and rtol 1e-10 / atol 1e-13 x max, f32 with at most 1e-4
of the slots flipped and rtol 2e-4 / atol 2e-5 x max on the rest; K7's
packed mode bit for bit pack_batch of its per-slot output; K7b rtol 2e-4
/ atol 2e-5 x max in f32 and 1e-10 / 1e-13 x max in f64, its row sums
alike, two launches bit-identical; K8 the same daughters, f64 rtol 1e-10,
f32 rtol 2e-4.
"""

import numpy as np
import pytest
import torch

from is3d_tpu_torch import testing
from is3d_tpu_torch.kernels import mc_decays, sample
from is3d_tpu_torch.native import build

torch.set_num_threads(1)

TOL = {torch.float32: (2e-4, 2e-5), torch.float64: (1e-10, 1e-13)}
FLIPS = {torch.float32: 1e-4, torch.float64: 0.0}


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the GPU: python -m pytest "
                    "tests/test_torch_sample_kernels.py -m gpu --noconftest)")


def test_cpu_dispatch_never_loads_a_kernel(monkeypatch):
    def refuse(name):
        raise AssertionError(f"loaded {name} on the CPU path")
    monkeypatch.setattr(build, "cuda_library", refuse)
    inp = testing.sample_edge_inputs("2d_df2", n_cells=128)
    packed, per_event, small = sample.event_batch_packed(
        inp["rows"], inp["layout"], inp["tables"], inp["species"],
        inp["counts"], 5, 0, inp["n_cap"], inp["cfg"], 4 * inp["n_cap"])
    assert per_event.shape == (4,) and int(small[0]) == int(per_event.sum())
    assert packed["px"].shape == (4 * inp["n_cap"],)
    c = testing.cascade_edge_inputs(n=50)
    n = mc_decays.run_cascade(c["state"], c["n0"], c["dev_tabs"], c["key"],
                              c["tabs"].n_passes)
    assert n > c["n0"]


def test_wrappers_refuse_cpu_tensors():
    inp = testing.sample_edge_inputs("2d_df1", n_cells=64)
    with pytest.raises(ValueError, match="needs CUDA"):
        sample.event_batch_cuda(inp["rows"], inp["layout"], inp["tables"],
                                inp["species"], inp["counts"], 5, 0,
                                inp["n_cap"], inp["cfg"])
    with pytest.raises(ValueError, match="needs CUDA"):
        sample.event_batch_packed_cuda(
            inp["rows"], inp["layout"], inp["tables"], inp["species"],
            inp["counts"], 5, 0, inp["n_cap"], inp["cfg"], 100)
    bad = dict(inp["tables"], sp_alias=inp["tables"]["sp_alias"].long())
    with pytest.raises(ValueError, match="sp table"):
        sample.event_batch_cuda(inp["rows"], inp["layout"], bad,
                                inp["species"], inp["counts"], 5, 0,
                                inp["n_cap"], inp["cfg"])
    q0 = sample.alias_scale(torch.rand(3, 5, dtype=torch.float64))
    with pytest.raises(ValueError, match="needs CUDA"):
        sample.alias_tables_cuda(q0)
    with pytest.raises(ValueError, match="float32 or float64"):
        sample.alias_tables_cuda(q0.to(torch.float16))
    c = testing.cascade_edge_inputs(n=20)
    with pytest.raises(ValueError, match="needs CUDA"):
        mc_decays.cascade_pass_cuda(c["state"], c["n0"], c["dev_tabs"],
                                    c["key"])


@pytest.mark.parametrize("case", sorted(testing.SAMPLE_EDGES))
def test_sample_edge_inputs_are_what_they_claim(case):
    inp = testing.sample_edge_inputs(case, n_cells=512)
    out = sample.event_batch_plain(
        inp["rows"], inp["tables"], inp["species"], inp["counts"],
        sample.PhiloxSource(inp["seed"], inp["ev0"], torch.float64),
        inp["n_cap"], inp["cfg"])
    testing.sample_edge_seen(case, inp, out)
    assert not out["keep"][2].any() and int(out["ok"][3].sum()) <= 1


def packed_equal(got, want, n: int):
    """The first n entries of two packed dicts, bit for bit."""
    bits = lambda t: t.view(torch.int16) if t.dtype == torch.float16 else t
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(bits(got[k][:n]), bits(want[k][:n])), k


@pytest.mark.parametrize("case", sorted(testing.SAMPLE_EDGES))
def test_packed_plain_is_pack_batch_of_the_slots(case):
    """event_batch_packed_plain: pack_batch of event_batch_plain field for
    field, its per-event counts and (kept, accepted, proposed) totals;
    and past its capacity the first cap hadrons with the counts exact."""
    inp = testing.sample_edge_inputs(case, torch.float32, n_cells=256)
    cfg = inp["cfg"].replace(precision="f32")       # f16 momenta
    src = lambda: sample.PhiloxSource(inp["seed"], inp["ev0"], torch.float32)
    out = sample.event_batch_plain(inp["rows"], inp["tables"], inp["species"],
                                   inp["counts"], src(), inp["n_cap"], cfg)
    kept = int(out["keep"].sum())
    C, S = inp["rows"].shape[0], inp["species"].mass.shape[0]
    for cap in (4 * inp["n_cap"], kept // 2):
        want, want_events = sample.pack_batch(out, cfg, S, C, cap)
        packed, per_event, small = sample.event_batch_packed_plain(
            inp["rows"], inp["tables"], inp["species"], inp["counts"], src(),
            inp["n_cap"], cfg, cap)
        packed_equal(packed, want, min(kept, cap))
        assert torch.equal(per_event, want_events)
        assert small.tolist() == [kept, int(out["ok"].sum()),
                                  int(out["rounds"].sum())]
        assert packed["px"].dtype == torch.float16
    assert 0 < kept // 2 < kept


@pytest.mark.parametrize("case", sorted(testing.YIELDS_EDGES))
def test_yields_edge_inputs_are_what_they_claim(case):
    """The plain K7b on each edge: what the case claims, the row sums the
    rows' sums, and the sums-only mode the same sums with no table."""
    inp = testing.yields_edge_inputs(case)
    args = (inp["cols"], inp["species"], inp["laguerre"], inp["cfg"])
    dn, sums = sample.species_yields(*args)
    testing.yields_edge_seen(case, inp, dn)
    assert torch.equal(sums, dn.sum(dim=1))
    none, again = sample.species_yields(*args, sums_only=True)
    assert none is None and torch.equal(again, sums)


def test_yields_cpu_dispatch_and_cuda_refusal(monkeypatch):
    def refuse(name):
        raise AssertionError(f"loaded {name} on the CPU path")
    monkeypatch.setattr(build, "cuda_library", refuse)
    inp = testing.yields_edge_inputs("df2_baryon", n_cells=16)
    args = (inp["cols"], inp["species"], inp["laguerre"], inp["cfg"])
    assert sample.species_yields(*args)[0].shape == (16, 41)
    with pytest.raises(ValueError, match="needs CUDA"):
        sample.species_yields_cuda(*args)
    bad = dict(inp["cols"], T=inp["cols"]["T"].to(torch.float16))
    with pytest.raises(ValueError, match="float32 or float64"):
        sample.species_yields_cuda(bad, *args[1:])


def test_formula_counts_the_search_and_the_yields():
    """sample_formula_ops with search tables: ceil(log2(C + 1)) gathers of
    cum_dn (in L2: read once) and S.bit_length() + 1 of rowcum (a sector
    each past L2); yields_formula_ops: 4 special functions a node of each
    quadrature, df 3's clean cells two."""
    rows = torch.zeros((1 << 20, 40), dtype=torch.float32)
    rowcum = torch.empty((1 << 20, 320))        # 1.34 GB
    tables = dict(cum_dn=torch.zeros(1 << 20), rowcum=rowcum, lam=1.0)
    ops = sample.sample_formula_ops(1000, 900, 1500, rows, tables,
                                    out_bytes=0)
    assert ops["bytes"] == (32 * 900 * 5 + min(4 << 20, 32 * 900 * 21)
                            + 32 * 900 * 10)
    from is3d_tpu_torch.config import Config
    y = sample.yields_formula_ops(100, 7, 32, Config(df_mode=3), 4,
                                  n_broken=30)
    assert y["sfu"] == 4 * (2 * 70 + 30) * 7 * 32
    assert y["bytes"] == (8 * 100 + 28 + 128 + 100) * 4 + 100 * 7 * 4
    v = sample.yields_formula_ops(100, 7, 32, Config(mode=2), 8,
                                  sums_only=True)
    assert v == dict(bytes=(2 * 100 + 28 + 128 + 100) * 8,
                     sfu=4 * 100 * 7 * 32)


def test_drain_frees_its_tables_on_return():
    """_drain_event_range (a batch rerun included) keeps no reference to
    the rows and tables it read once it returns, with the cyclic garbage
    collector off: the cell-chunked sampler frees a chunk's tables before
    the next chunk's."""
    import gc
    import weakref
    inp = testing.sample_edge_inputs("2d_df2", n_cells=128)
    rows, tables = inp["rows"].clone(), dict(inp["tables"])
    tables["sp_prob"] = tables["sp_prob"].clone()
    refs = [weakref.ref(rows), weakref.ref(tables["sp_prob"])]
    plan = dict(batches=0, capacity=16, reruns=0)
    events = []
    gc.disable()
    try:
        sample._drain_event_range(
            rows, inp["layout"], tables, inp["species"], inp["cell"],
            inp["cfg"], 5, float(inp["cell"]["dn_tot"].sum()), 0, 3, 2,
            inp["n_cap"], np.arange(13), {}, plan, events)
        del rows, tables
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()
    assert plan["reruns"] >= 1 and len(events) == 3


def test_pair_table_views_equal_the_plain_tables():
    """The interleaved (prob, alias) table: its views read back the plain
    pass's tables; built from such views it is their storage, no copy;
    from separate tables a copy."""
    for dtype in (torch.float32, torch.float64):
        w = testing.alias_edge_weights(dtype)["mixed"]
        prob, alias = sample.alias_tables_plain(*sample.alias_sort(w))
        pairs = sample.pair_table(prob, alias)
        assert pairs.shape == prob.shape + (2,) and pairs.dtype == dtype
        p, a = sample._pair_views(pairs)
        assert torch.equal(p, prob) and torch.equal(a, alias)
        again = sample.pair_table(p, a)
        assert again.data_ptr() == pairs.data_ptr()
        assert torch.equal(again, pairs)
        words = pairs.view(torch.int32).reshape(-1, 2 * dtype.itemsize // 4)
        assert torch.equal(words[:, dtype.itemsize // 4], alias.reshape(-1))


def test_formula_counts_one_gather_a_pick():
    """sample_formula_ops: a pick gathers one (prob, alias) entry, so a
    table larger than L2 costs one 32-byte sector a valid slot; packed
    mode's output is its packed bytes."""
    rows = torch.zeros((4096, 40), dtype=torch.float32)
    big = (6_600_000, 2)        # 52.8 MB of (prob, alias) entries
    tables = dict(grp_prob=torch.zeros(1, 8), grp_alias=torch.zeros(
        (1, 8), dtype=torch.int32), blk_prob=torch.zeros(8, 512),
        blk_alias=torch.zeros((8, 512), dtype=torch.int32),
        sp_prob=torch.empty(big), sp_alias=torch.empty(big,
                                                       dtype=torch.int32))
    ops = sample.sample_formula_ops(1000, 900, 1500, rows, tables,
                                    out_bytes=0)
    assert ops["bytes"] == (min(rows.nbytes, 32 * 900 * 5) + 64
                            + min(8 * 4096, 32 * 900) + 32 * 900)
    assert ops["mulhi"] == 20 * 2 * (900 + 1500)
    per_slot = sample.sample_formula_ops(1000, 900, 1500, rows, tables)
    assert per_slot["bytes"] - ops["bytes"] == 1000 * (2 + 12 + 16)
    packed = dict(scidx=torch.zeros(50, dtype=torch.int32),
                  px=torch.zeros(50, dtype=torch.float16))
    assert sample.packed_bytes(packed, 40, 3) == 40 * 6 + 12 + 24
    assert sample.packed_bytes(packed, 80, 3) == 50 * 6 + 12 + 24


def realized_pmf(prob, alias):
    prob, alias = prob.double().cpu().numpy(), alias.cpu().numpy()
    pmf = prob.copy()
    for r in range(prob.shape[0]):
        np.add.at(pmf[r], alias[r], 1.0 - prob[r])
    return pmf / prob.shape[1]


def test_alias_edge_tables_realize_their_weights():
    for name, w in testing.alias_edge_weights().items():
        if w.shape[0] > 512:
            w = w[:512]
        prob, alias = sample.alias_build(w)
        tot = w.sum(1, keepdim=True)
        target = torch.where(tot > 0, w / torch.where(tot > 0, tot, 1.0),
                             1.0 / w.shape[1]).numpy()
        err = np.abs(realized_pmf(prob, alias) - target).sum(1).max()
        assert err < 1e-12, (name, err)


def test_cascade_plain_ends_stable_and_conserves_momentum():
    c = testing.cascade_edge_inputs(n=400)
    st = c["state"]
    p0 = [float(st[k][:c["n0"]].sum()) for k in ("E", "px", "py", "pz")]
    n = mc_decays.run_cascade(st, c["n0"], c["dev_tabs"], c["key"],
                              c["tabs"].n_passes)
    assert c["tabs"].stable[st["sidx"][:n].numpy()].all()
    p1 = [float(st[k][:n].sum()) for k in ("E", "px", "py", "pz")]
    np.testing.assert_allclose(p1, p0, rtol=1e-9, atol=1e-9)


def compare_slots(a: dict, b: dict, counts, n_cap: int, dtype) -> int:
    """Slot-by-slot agreement of K7 (b) with its plain version (a); the
    flipped slots' count."""
    valid = (torch.arange(n_cap, device=counts.device)[None, :]
             < counts[:, None])
    flips = valid & ((a["ok"] != b["ok"]) | (a["rounds"] != b["rounds"])
                     | (a["keep"] != b["keep"]))
    assert int(flips.sum()) <= FLIPS[dtype] * int(valid.sum())
    for k in ("sidx", "cidx"):
        assert torch.equal(a[k][valid], b[k][valid]), k
    both = valid & ~flips & a["ok"]
    rtol, atol = TOL[dtype]
    for k in ("px", "py", "pz", "eta"):
        x, y = b[k][both].double(), a[k][both].double()
        assert torch.isfinite(x).all()
        torch.testing.assert_close(x, y, rtol=rtol,
                                   atol=atol * float(y.abs().max()))
    return int(flips.sum())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(testing.SAMPLE_EDGES))
def test_event_kernel_matches_plain_on_gpu(cuda_card, case, dtype):
    inp = testing.sample_edge_inputs(case, dtype, "cuda")
    args = (inp["rows"], inp["layout"], inp["tables"], inp["species"],
            inp["counts"], inp["seed"], inp["ev0"], inp["n_cap"], inp["cfg"])
    got = sample.event_batch_cuda(*args)
    again = sample.event_batch_cuda(*args)
    want = sample.event_batch_plain(
        inp["rows"], inp["tables"], inp["species"], inp["counts"],
        sample.PhiloxSource(inp["seed"], inp["ev0"], dtype), inp["n_cap"],
        inp["cfg"])
    torch.cuda.synchronize()
    for k in got:
        assert torch.equal(got[k], again[k]), k
    compare_slots(want, got, inp["counts"], inp["n_cap"], dtype)
    testing.sample_edge_seen(case, inp, got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(testing.SAMPLE_EDGES))
def test_packed_kernel_matches_pack_batch_on_gpu(cuda_card, case, dtype):
    """K7's packed mode bit for bit pack_batch of its per-slot output, at a
    capacity above the kept hadrons and at half of them; two launches
    identical."""
    inp = testing.sample_edge_inputs(case, dtype, "cuda")
    cfg = inp["cfg"].replace(precision="f32" if dtype == torch.float32
                             else "f64")
    args = (inp["rows"], inp["layout"], inp["tables"], inp["species"],
            inp["counts"], inp["seed"], inp["ev0"], inp["n_cap"], cfg)
    out = sample.event_batch_cuda(*args)
    kept = int(out["keep"].sum())
    C, S = inp["rows"].shape[0], inp["species"].mass.shape[0]
    for cap in (4 * inp["n_cap"], kept // 2):
        want, want_events = sample.pack_batch(out, cfg, S, C, cap)
        got = sample.event_batch_packed_cuda(*args, cap)
        again = sample.event_batch_packed_cuda(*args, cap)
        torch.cuda.synchronize()
        packed_equal(got[0], want, min(kept, cap))
        packed_equal(again[0], got[0], min(kept, cap))
        assert torch.equal(got[1], want_events)
        assert got[2].tolist() == [kept, int(out["ok"].sum()),
                                   int(out["rounds"].sum())]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(testing.YIELDS_EDGES))
def test_yields_kernel_matches_plain_on_gpu(cuda_card, case, dtype):
    """K7b against its plain version on each edge: the densities and the
    row sums within the tolerance, two launches and the sums-only mode
    bit-identical."""
    inp = testing.yields_edge_inputs(case, dtype, "cuda")
    args = (inp["cols"], inp["species"], inp["laguerre"], inp["cfg"])
    launches = sample.YIELDS_LAUNCHES + sample.YIELDS_VAH_LAUNCHES
    got, sums = sample.species_yields_cuda(*args)
    again, sums2 = sample.species_yields_cuda(*args)
    none, sums3 = sample.species_yields_cuda(*args, sums_only=True)
    want, wsums = sample.species_yields_plain(*args)
    torch.cuda.synchronize()
    assert sample.YIELDS_LAUNCHES + sample.YIELDS_VAH_LAUNCHES == launches + 3
    assert none is None
    assert torch.equal(got, again) and torch.equal(sums, sums2)
    assert torch.equal(sums, sums3)
    rtol, atol = TOL[dtype]
    for g, w in ((got, want), (sums, wsums)):
        torch.testing.assert_close(g, w, rtol=rtol,
                                   atol=atol * float(w.abs().max()))
    testing.yields_edge_seen(case, inp, got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_alias_kernel_matches_plain_on_gpu(cuda_card, dtype):
    for name, w in testing.alias_edge_weights(dtype, "cuda").items():
        got = sample.alias_tables_cuda(sample.alias_scale(w))
        want = sample.alias_tables_plain(*sample.alias_sort(w))
        for g, x in zip(got, want):
            assert torch.equal(g, x), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cascade_kernel_matches_plain_on_gpu(cuda_card, dtype):
    a = testing.cascade_edge_inputs(dtype, "cuda")
    b = testing.cascade_edge_inputs(dtype, "cuda")
    na = mc_decays.cascade_plain(a["state"], a["n0"], a["dev_tabs"],
                                 a["key"], a["tabs"].n_passes)
    nb = mc_decays.run_cascade(b["state"], b["n0"], b["dev_tabs"], b["key"],
                               b["tabs"].n_passes)
    assert na == nb > a["n0"]
    for k in ("sidx", "eid", "lin"):
        assert torch.equal(a["state"][k][:na], b["state"][k][:na]), k
    rtol, atol = TOL[dtype]
    for k in mc_decays.STATE_FLOATS:
        y = a["state"][k][:na].double()
        torch.testing.assert_close(b["state"][k][:na].double(), y, rtol=rtol,
                                   atol=atol * float(y.abs().max()))


def test_wide_tables_give_the_same_cascade():
    """testing.widen_decay_tables pads no-op channels: the plain cascade on
    the wide tables equals the one on the narrow tables, bit for bit."""
    a = testing.cascade_edge_inputs(n=400)
    b = testing.cascade_edge_inputs(n=400, channels=testing.WIDE_CHANNELS)
    assert b["dev_tabs"]["cum"].shape[1] == testing.WIDE_CHANNELS
    na = mc_decays.run_cascade(a["state"], a["n0"], a["dev_tabs"], a["key"],
                               a["tabs"].n_passes)
    nb = mc_decays.run_cascade(b["state"], b["n0"], b["dev_tabs"], b["key"],
                               b["tabs"].n_passes)
    assert na == nb > a["n0"]
    for k in a["state"]:
        assert torch.equal(a["state"][k][:na], b["state"][k][:na]), k


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("channels", [None, testing.WIDE_CHANNELS])
def test_cascade_pass_kernel_matches_plain_pass_on_gpu(cuda_card, channels,
                                                       dtype):
    """K8 pass by pass (the one-pass entry) against the plain pass on the
    same state, on 4 and 64 channels a species."""
    a = testing.cascade_edge_inputs(dtype, "cuda", channels=channels)
    b = testing.cascade_edge_inputs(dtype, "cuda", channels=channels)
    n, key = a["n0"], a["key"]
    rtol, atol = TOL[dtype]
    for _ in range(a["tabs"].n_passes):
        lin = a["state"]["lin"][:n]
        na = mc_decays.cascade_pass_plain(
            a["state"], n, a["dev_tabs"],
            mc_decays.rng.decay_uniforms(key, lin, dtype),
            tuple(mc_decays.rng.child_lineage(key, lin, j) for j in (1, 2, 3)))
        nb = mc_decays.cascade_pass_cuda(b["state"], n, b["dev_tabs"], key)
        assert na == nb > 0
        for k in ("sidx", "eid", "lin"):
            assert torch.equal(a["state"][k][:na], b["state"][k][:na]), k
        for k in mc_decays.STATE_FLOATS:
            y = a["state"][k][:na].double()
            torch.testing.assert_close(b["state"][k][:na].double(), y,
                                       rtol=rtol,
                                       atol=atol * float(y.abs().max()))
        n = na


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("channels", [None, testing.WIDE_CHANNELS])
def test_cascade_kernel_bit_identical_without_host_sync_on_gpu(
        cuda_card, channels, dtype):
    """The whole cascade twice: one launch a pass, queued with no host
    sync (set_sync_debug_mode "error"), one read; bit-identical runs."""
    runs = [testing.cascade_edge_inputs(dtype, "cuda", channels=channels)
            for _ in range(2)]
    ns = []
    for r in runs:
        mc_decays.LAUNCHES = 0
        torch.cuda.set_sync_debug_mode("error")
        try:
            counts = mc_decays.launch_cascade(r["state"], r["n0"],
                                              r["dev_tabs"], r["key"],
                                              r["tabs"].n_passes)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert mc_decays.LAUNCHES == r["tabs"].n_passes
        ns.append(mc_decays.final_count(counts, r["state"]["E"].shape[0]))
    assert ns[0] == ns[1] > runs[0]["n0"]
    for k in runs[0]["state"]:
        assert torch.equal(runs[0]["state"][k], runs[1]["state"][k]), k


@pytest.mark.gpu
def test_cascade_overflow_raises_on_gpu(cuda_card):
    small = testing.cascade_edge_inputs(torch.float32, "cuda", n=64)
    st = {k: v[:small["n0"]].clone() for k, v in small["state"].items()}
    with pytest.raises(RuntimeError, match="decay cascade overflow"):
        mc_decays.run_cascade(st, small["n0"], small["dev_tabs"],
                              small["key"], small["tabs"].n_passes)
    with pytest.raises(RuntimeError, match="decay cascade overflow"):
        mc_decays.cascade_pass_cuda(st, small["n0"], small["dev_tabs"],
                                    small["key"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_decay_events_cuda_matches_cpu_on_gpu(cuda_card, dtype):
    """decay_events on the card against the CPU run: the same lists, mcid
    bit for bit, floats within the kernel's tolerance."""
    table, _ = testing.synthetic_decaying_table(60, seed=0)
    tabs = mc_decays.cached_tables(table, 111)
    r = np.random.default_rng(3)
    events = []
    for n in (300, 0, 120, 250):
        s = r.integers(0, len(tabs.mc_id), n)
        p = r.normal(0, 0.5, (n, 3))
        z = np.zeros(n, dtype)
        events.append(dict(
            mcid=tabs.mc_id[s], mass=tabs.mass[s].astype(dtype),
            E=np.sqrt(tabs.mass[s]**2 + (p**2).sum(1)).astype(dtype),
            px=p[:, 0].astype(dtype), py=p[:, 1].astype(dtype),
            pz=p[:, 2].astype(dtype), t=z + 6, x=z, y=z, z=z, tau=z + 6,
            eta=z, yp=z))
    info = {}
    got = mc_decays.decay_events(events, table, seed=7, device="cuda",
                                 info=info)
    want = mc_decays.decay_events(events, table, seed=7, device="cpu")
    assert tuple(info["timings"]) == mc_decays.DECAY_TIMINGS
    rtol, atol = TOL[torch.float32 if dtype == np.float32 else torch.float64]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["mcid"], w["mcid"])
        for k in mc_decays.FLOAT_FIELDS:
            scale = float(np.abs(w[k]).max()) if len(w[k]) else 0.0
            np.testing.assert_allclose(g[k], w[k], rtol=rtol,
                                       atol=atol * scale, err_msg=k)
