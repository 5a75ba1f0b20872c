"""The port's tail against is3d_tpu on the CPU, on seeded numpy inputs:
analysis (compute_observables, is_charged, pseudorapidity,
compare_sampling_smooth), plotting, utils.EnvGatedAccumTimer and the
sampler's gated breakdown, utils.device_trace and tools/trace_summary.py,
physics/lrf.basis_orthonormality_residual, physics/thermal's modified-EoS
integrands, kernels/common.required_fields and
parallel/multihost.pod_active (its true case runs in test_torch_pod.py's
spawns).  About 15 s on one worker.
"""

import glob
import itertools
import json
import os
import time

import numpy as np
import pytest
import torch

import is3d_tpu.analysis as jax_analysis
import is3d_tpu.utils as jax_utils
from is3d_tpu.config import Config as JaxConfig
from is3d_tpu.histograms import sampler_test_histograms as jax_histograms
from is3d_tpu.io import pdg as jax_pdg
from is3d_tpu.io.tables import native_momentum_grid as jax_grid

from is3d_tpu_torch import analysis, cli, testing, utils
from is3d_tpu_torch.config import Config
from is3d_tpu_torch.histograms import sampler_test_histograms
from is3d_tpu_torch.io import pdg
from is3d_tpu_torch.io.tables import gauss_laguerre, native_momentum_grid
from is3d_tpu_torch.tools import trace_summary

MCIDS = np.array([211, -211, 111, 321, -321, 2212, -2212, 3122, 12212,
                  20213])
MASS = {211: 0.13957, 111: 0.13498, 321: 0.49368, 2212: 0.93827,
        3122: 1.11568, 12212: 1.44, 20213: 1.23}


def _events(seed=0, nev=4, n=400):
    """Per-event dicts of numpy arrays (the sampler's EVENT_FIELDS), the
    species drawn from MCIDS; the last event carries a hadron at rest
    (px = py = pz = 0) and one with pT = 0 and pz != 0."""
    rng = np.random.default_rng(seed)
    events = []
    for e in range(nev):
        mcid = rng.choice(MCIDS, n)
        m = np.array([MASS[abs(int(i))] for i in mcid])
        pT = rng.exponential(0.5, n) + 0.01
        phi = rng.uniform(0, 2 * np.pi, n)
        yp = rng.uniform(-3, 3, n)
        px, py = pT * np.cos(phi), pT * np.sin(phi)
        if e == nev - 1:
            px[:2] = py[:2] = 0.0
            yp[0] = 0.0
            yp[1] = 0.7
        mT = np.sqrt(m ** 2 + px ** 2 + py ** 2)
        events.append(dict(
            mcid=mcid, px=px, py=py, pz=mT * np.sinh(yp),
            E=mT * np.cosh(yp), yp=yp, eta=yp + rng.normal(0, 0.2, n),
            tau=rng.uniform(1, 10, n), x=rng.uniform(-8, 8, n),
            y=rng.uniform(-8, 8, n), z=np.zeros(n), t=np.zeros(n), mass=m))
    return events


def _same(a, b, path="out"):
    """a == b exactly, through dicts, lists and arrays (complex too)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (
            path, a, b)


def _pdg_file(tmp_path):
    """A conventional PDG file both readers read: hadrons of the fallback
    charged set, neutral ones, and charged resonances outside it (N(1440)+,
    a1(1260)+ and the mirrored anti-N(1440)-)."""
    rows = [(211, "pi+", 0.13957, 0.0, 1, 0, 0, 1, []),
            (111, "pi0", 0.13498, 0.0, 1, 0, 0, 0, []),
            (321, "K+", 0.49368, 0.0, 1, 0, 1, 1, []),
            (2212, "p", 0.93827, 0.0, 2, 1, 0, 1, []),
            (3122, "Lambda", 1.11568, 0.0, 2, 1, -1, 0, []),
            (12212, "N(1440)+", 1.44, 0.35, 2, 1, 0, 1, []),
            (20213, "a1(1260)+", 1.23, 0.42, 3, 0, 0, 1, [])]
    path = str(tmp_path / "pdg.dat")
    testing._write_pdg(path, rows)
    return path


@pytest.mark.parametrize("nev", [4, 0])
def test_compute_observables_matches_jax(nev):
    events = _events(nev=nev) if nev else []
    got = analysis.compute_observables(events)
    want = jax_analysis.compute_observables(events)
    _same(got, want)
    assert got["flow"]["Qn"].dtype == np.complex128
    if nev:
        assert got["dN_dy"]["pion"] > 0 and got["dNch_deta"] > 0


def test_pseudorapidity_at_rest_and_along_the_beam():
    px = np.array([0.0, 0.0, 0.0, 0.3])
    py = np.array([0.0, 0.0, 0.0, 0.4])
    pz = np.array([0.0, 1.0, -1.0, 0.5])
    got = analysis.pseudorapidity(px, py, pz)
    _same(got, jax_analysis.pseudorapidity(px, py, pz))
    assert got[0] == 0.0 and got[1] == np.inf and got[2] == -np.inf
    assert got[3] == np.arcsinh(0.5 / 0.5)


def test_is_charged_matches_jax_with_and_without_a_table(tmp_path):
    path = _pdg_file(tmp_path)
    table = pdg.read_resonances_conventional(path)
    jax_table = jax_pdg.read_resonances_conventional(path)
    ids = np.concatenate([MCIDS, [-12212, 999]]).reshape(3, 4)
    got = analysis.is_charged(ids, table)
    _same(got, jax_analysis.is_charged(ids, jax_table))
    _same(analysis.is_charged(ids), jax_analysis.is_charged(ids))
    # N(1440)+ and a1(1260)+: charged by the table, not by the fallback set
    res = np.isin(ids, [12212, -12212, 20213])
    assert got[res].all() and not analysis.is_charged(ids)[res].any()
    events = _events()
    _same(analysis.compute_observables(events, particle_table=table),
          jax_analysis.compute_observables(events,
                                           particle_table=jax_table))


@pytest.mark.parametrize("dimension", [2, 3])
def test_compare_sampling_smooth_matches_jax(dimension):
    rng = np.random.default_rng(dimension)
    kw = dict(dimension=dimension, y_cut=1.0, pT_bins=20)
    cfg, jcfg = Config(**kw), JaxConfig(**kw)
    events = _events(seed=dimension)
    grid, jgrid = native_momentum_grid(dimension), jax_grid(dimension)
    n_y = grid.y.shape[0]
    assert n_y == (1 if dimension == 2 else 21)
    spectra = rng.uniform(0.5, 2.0, (len(MCIDS), 32, 24, n_y))
    hist = sampler_test_histograms(events, MCIDS, cfg)
    jhist = jax_histograms(events, MCIDS, jcfg)
    _same(hist, jhist)
    for mcid in (211, 321, 2212):
        got = analysis.compare_sampling_smooth(
            hist, torch.tensor(spectra), grid, MCIDS, mcid, cfg)
        want = jax_analysis.compare_sampling_smooth(
            jhist, spectra, jgrid, MCIDS, mcid, jcfg)
        assert sorted(got) == sorted(want)
        for k in got:
            if k.endswith("_smooth") and k != "pT_smooth":
                # the grids' weights reach numpy by two routes: the last bit
                np.testing.assert_allclose(got[k], want[k], rtol=1e-14,
                                           atol=0, err_msg=k)
            else:
                _same(got[k], want[k], k)
        # 3+1D: the smooth side at the midrapidity node, not the edge
        i = list(MCIDS).index(mcid)
        iy = 0 if dimension == 2 else 10
        pT, w = grid.pT.numpy(), grid.pT_weight.numpy()
        phiw = grid.phi_weight.numpy()
        assert got["dN_dy_smooth"] == pytest.approx(
            np.einsum("pf,p,f->", spectra[i, :, :, iy], w * pT, phiw),
            rel=1e-13)


def test_plots_draw_what_jax_draws(tmp_path):
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt
    import is3d_tpu.plotting as jax_plotting
    from is3d_tpu_torch import plotting

    rng = np.random.default_rng(7)
    cfg = Config(dimension=2, y_cut=1.0, pT_bins=20)
    events = _events(seed=7)
    spectra = rng.uniform(0.5, 2.0, (len(MCIDS), 32, 24, 1))
    grid = native_momentum_grid(2)
    cmp = analysis.compare_sampling_smooth(
        sampler_test_histograms(events, MCIDS, cfg), spectra, grid, MCIDS,
        211, cfg)
    pairs = [
        (plotting.plot_spectra(torch.tensor(spectra), grid, MCIDS, 321,
                               out=str(tmp_path / "s.png")),
         jax_plotting.plot_spectra(spectra, jax_grid(2), MCIDS, 321)),
        (plotting.plot_sampling_vs_smooth(cmp, 211),
         jax_plotting.plot_sampling_vs_smooth(cmp, 211)),
        (plotting.plot_event_histogram(events, key="pz", bins=30),
         jax_plotting.plot_event_histogram(events, key="pz", bins=30)),
    ]
    assert os.path.getsize(tmp_path / "s.png") > 0
    for fig, jfig in pairs:
        ax, jax_ax = fig.axes[0], jfig.axes[0]
        assert len(ax.lines) == len(jax_ax.lines)
        for a, b in zip(ax.lines, jax_ax.lines):
            # the smooth curves' last bit, as in compare_sampling_smooth
            np.testing.assert_allclose(a.get_xydata(), b.get_xydata(),
                                       rtol=1e-14, atol=0)
        assert len(ax.patches) == len(jax_ax.patches)
        for a, b in zip(ax.patches, jax_ax.patches):
            _same(np.asarray(a.get_xy()), np.asarray(b.get_xy()))
        assert (ax.get_title(), ax.get_xlabel(), ax.get_ylabel()) == (
            jax_ax.get_title(), jax_ax.get_xlabel(), jax_ax.get_ylabel())
        plt.close(fig)
        plt.close(jfig)


def test_basis_orthonormality_residual_matches_jax():
    import jax.numpy as jnp
    from is3d_tpu.physics import lrf as jax_lrf
    from is3d_tpu_torch.physics import lrf

    rng = np.random.default_rng(3)
    n = 2000
    tau = rng.uniform(0.3, 12.0, n)
    ux, uy = rng.normal(0, 1.5, n), rng.normal(0, 1.5, n)
    ux[:40] = uy[:40] = 0.0              # no transverse flow: the guard
    ux[40:80] *= 1e-6
    un = rng.normal(0, 0.4, n) / tau
    ut = np.sqrt(1.0 + ux ** 2 + uy ** 2 + (tau * un) ** 2)
    cols = (ut, ux, uy, un, tau)
    t = [torch.tensor(c) for c in cols]
    j = [jnp.asarray(c) for c in cols]
    basis = lrf.milne_basis(*t)
    jbasis = jax_lrf.milne_basis(*j)
    got = lrf.basis_orthonormality_residual(basis, *t)
    want = np.asarray(jax_lrf.basis_orthonormality_residual(jbasis, *j))
    assert got.dtype == torch.float64 and got.shape == (n,)
    assert float(got.max()) <= 1e-12
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    # the same basis through both residuals
    same = type(basis)(**{k: torch.tensor(np.asarray(getattr(jbasis, k)))
                          for k in ("Xt", "Xx", "Xy", "Xn", "Yx", "Yy", "Zt",
                                    "Zn")})
    np.testing.assert_allclose(
        lrf.basis_orthonormality_residual(same, *t).numpy(), want, rtol=0,
        atol=1e-12)
    # a broken tetrad shows
    bad = type(basis)(**{**{k: getattr(basis, k) for k in (
        "Xt", "Xx", "Xy", "Xn", "Yx", "Yy", "Zt")}, "Zn": basis.Zn * 1.01})
    assert float(lrf.basis_orthonormality_residual(bad, *t).min()) > 1e-4


@pytest.mark.parametrize("name", ["E_mod_int", "P_mod_int"])
def test_modified_eos_integrands_match_jax(name):
    import jax.numpy as jnp
    from is3d_tpu.physics import thermal as jax_thermal
    from is3d_tpu_torch.physics import thermal

    roots, weights = gauss_laguerre(32, alphas=(2,))[2]
    mbar, lam, sign = (np.array(v, dtype=np.float64).ravel() for v in
                       np.meshgrid([0.05, 0.7, 3.0, 9.0, 25.0],
                                   [-0.4, -0.1, 0.0, 0.3, 1.5],
                                   [-1.0, 1.0], indexing="ij"))
    fn, jfn = getattr(thermal, name), getattr(jax_thermal, name)
    want = np.asarray(jax_thermal.gauss_mod(
        jfn, jnp.asarray(roots), jnp.asarray(weights), jnp.asarray(mbar),
        jnp.asarray(lam), jnp.asarray(sign)))
    got_np = thermal.gauss_mod(fn, roots, weights, mbar, lam, sign)
    assert isinstance(got_np, np.ndarray)
    np.testing.assert_allclose(got_np, jax_thermal.gauss_mod(
        jfn, roots, weights, mbar, lam, sign), rtol=1e-12)
    got_t = thermal.gauss_mod(fn, torch.tensor(roots), weights,
                              torch.tensor(mbar), lam, torch.tensor(sign))
    assert got_t.dtype == torch.float64
    for got in (got_np, got_t.numpy()):
        np.testing.assert_allclose(got, want, rtol=1e-12)
    assert np.all(want > 0)
    # the pointwise integrand, torch against numpy
    p = torch.tensor(roots)[:, None]
    np.testing.assert_allclose(
        fn(p, torch.tensor(mbar), torch.tensor(lam), torch.tensor(sign)
           ).numpy(), jfn(roots[:, None], mbar, lam, sign), rtol=1e-12)


def test_required_fields_matches_jax():
    from is3d_tpu.kernels.common import required_fields as jax_required
    from is3d_tpu_torch.kernels.common import required_fields

    seen = set()
    for dim, shear, bulk, baryon, bdiff, df, mode in itertools.product(
            (2, 3), (0, 1), (0, 1), (0, 1), (0, 1), (1, 2, 3, 4),
            range(1, 8)):
        kw = dict(dimension=dim, include_shear_deltaf=shear,
                  include_bulk_deltaf=bulk, include_baryon=baryon,
                  include_baryondiff_deltaf=bdiff, df_mode=df, mode=mode)
        got = required_fields(Config(**kw))
        assert got == jax_required(JaxConfig(**kw)), kw
        seen.add(tuple(got))
    assert len(seen) > 20


def _fake_clock(monkeypatch):
    """time.perf_counter stepping 0.25, 0.5, 0.75, ... s a call."""
    ticks = itertools.count(1)
    monkeypatch.setattr(time, "perf_counter", lambda: 0.25 * next(ticks))


@pytest.mark.parametrize("value", ["1", "", "0"])
def test_env_gated_timer_matches_jax(value, monkeypatch, capsys):
    monkeypatch.setenv("IS3D_TEST_TIMINGS", value)
    out = []
    for mod in (utils, jax_utils):
        _fake_clock(monkeypatch)
        t = mod.EnvGatedAccumTimer("IS3D_TEST_TIMINGS")
        with t("outer"):
            with t("inner"):
                time.perf_counter()
            with t("inner"):
                pass
        with t("other"):
            with t("outer"):
                pass
        t.report("label")
        out.append((t.enabled, dict(t.acc), capsys.readouterr().out))
    assert out[0] == out[1]
    enabled, acc, printed = out[0]
    assert enabled == (value == "1")
    if enabled:
        assert list(acc) == ["inner", "outer", "other"]
        assert acc == dict(inner=0.75, outer=1.75, other=0.75)
        assert printed == (
            "[label timings] inner=0.750s  outer=1.750s  other=0.750s\n")
    else:
        assert acc == {} and printed == ""


def test_env_gated_timer_add_folds_outside_totals(monkeypatch, capsys):
    monkeypatch.setenv("IS3D_TEST_TIMINGS", "1")
    t = utils.EnvGatedAccumTimer("IS3D_TEST_TIMINGS")
    t.add("a", 0.5)
    t.add("a", 0.25)
    t.add("b", 1.0)
    t.report("x")
    assert capsys.readouterr().out == "[x timings] a=0.750s  b=1.000s\n"
    monkeypatch.delenv("IS3D_TEST_TIMINGS")
    t = utils.EnvGatedAccumTimer("IS3D_TEST_TIMINGS")
    t.add("a", 0.5)
    t.report("x")
    assert t.acc == {} and capsys.readouterr().out == ""


@pytest.fixture(scope="module")
def sample_dir(tmp_path_factory):
    return testing.write_synthetic_run_dir(
        str(tmp_path_factory.mktemp("tail") / "op2"), 48, 7, dimension=2,
        seed=5, params=dict(operation=2, oversample=1, min_num_hadrons=500,
                            sampler_seed=17))


@pytest.mark.parametrize("chunk,label", [
    (0, "sample_particles"), (16, "sample_particles (cell-chunked)")])
@pytest.mark.parametrize("value", ["1", None])
def test_sampler_timings_line(sample_dir, tmp_path, monkeypatch, capsys,
                              chunk, label, value):
    from is3d_tpu_torch.api import IS3D
    if value is None:
        monkeypatch.delenv("IS3D_SAMPLER_TIMINGS", raising=False)
    else:
        monkeypatch.setenv("IS3D_SAMPLER_TIMINGS", value)
    res = IS3D.from_run_dir(sample_dir, device="cpu",
                            overrides=dict(sampler_cell_chunk=chunk),
                            results_dir=str(tmp_path)).run_particlization()
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("[sample_particles")]
    timings = res.sample_info["timings"]
    assert set(timings) == {"phase_a", "dispatch", "wait", "copy",
                            "assembly"}
    if value is None:
        assert lines == []
        return
    assert len(lines) == 1 and lines[0].startswith(f"[{label} timings] ")
    keys = [p.split("=")[0] for p in lines[0].split("] ", 1)[1].split()]
    assert keys == list(timings)
    # info["timings"] is what the line prints: nothing timed twice
    assert lines[0].endswith("  ".join(f"{k}={v:.3f}s"
                                       for k, v in timings.items()))


def test_device_trace_none_is_a_no_op(tmp_path):
    before = os.listdir(tmp_path)
    with utils.device_trace(None):
        x = torch.ones(3).sum()
    assert float(x) == 3.0 and os.listdir(tmp_path) == before
    with utils.device_trace(None, device="cpu"):
        pass


@pytest.mark.skipif(torch.cuda.is_available(), reason="raises without CUDA")
def test_device_trace_defaults_to_cuda_and_raises_here(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with utils.device_trace(str(tmp_path / "t")):
            pass
    assert not os.path.exists(tmp_path / "t")


def test_device_trace_on_cpu_writes_one_trace_of_a_cli_run(tmp_path, capsys):
    run_dir = testing.write_synthetic_run_dir(str(tmp_path / "rd"), 64, 11,
                                              dimension=2, seed=11)
    log = str(tmp_path / "trace")
    t0 = time.perf_counter()
    with utils.device_trace(log, device="cpu"):
        assert cli.main([run_dir, "device=cpu"]) == 0
    wall = time.perf_counter() - t0
    capsys.readouterr()
    files = glob.glob(os.path.join(log, "*"))
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(files[0]) as f:
        trace = json.load(f)
    assert any(e.get("cat") == "cpu_op" for e in trace["traceEvents"])
    s = trace_summary.summarize(files[0])
    assert s["busy_s"] == 0.0 and s["device_events"] == 0
    assert s["kernels"] == {} and s["idle_share"] == 1.0
    assert 0.0 < s["window_s"] <= wall
    assert s["bytes"] == os.path.getsize(files[0])
    assert os.path.isfile(os.path.join(run_dir, "results",
                                       "dN_pTdpTdphidy.dat"))


def _hand_trace():
    """Device intervals (us): kernels A [0, 10), B [5, 15) and A [40, 42);
    a memcpy [20, 25) and a memset [24, 28) -- the union 15 + 8 + 2 = 25
    us; a host op [-10, 90) and the profiler's end mark at 95: the window
    105 us."""
    k = lambda name, ts, dur, cat="kernel": dict(
        ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=0, tid=7)
    return {"traceEvents": [
        dict(ph="M", name="process_name", pid=0, args={"name": "gpu"}),
        k("void A<float>(float*)", 0.0, 10.0),
        k("B", 5.0, 10.0),
        k("Memcpy DtoH", 20.0, 5.0, "gpu_memcpy"),
        k("Memset", 24.0, 4.0, "gpu_memset"),
        k("void A<float>(float*)", 40.0, 2.0),
        k("aten::add", -10.0, 100.0, "cpu_op"),
        dict(ph="i", s="g", name="Record Window End", ts=95.0),
    ]}


def test_trace_summary_of_overlapping_device_intervals(tmp_path, capsys):
    s = trace_summary.summarize(_hand_trace())
    assert s["window_s"] == pytest.approx(105e-6, rel=1e-12)
    assert s["busy_s"] == pytest.approx(25e-6, rel=1e-12)
    assert s["idle_share"] == pytest.approx(1.0 - 25.0 / 105.0, rel=1e-12)
    assert s["device_events"] == 5 and s["bytes"] is None
    assert list(s["kernels"]) == ["void A<float>(float*)", "B"]
    assert s["kernels"]["void A<float>(float*)"]["count"] == 2
    assert s["kernels"]["void A<float>(float*)"]["seconds"] == (
        pytest.approx(12e-6, rel=1e-12))
    assert trace_summary.top_kernels(s, 1) == [
        ("void A<float>(float*)", s["kernels"]["void A<float>(float*)"][
            "seconds"], 2)]
    assert trace_summary.union_seconds([]) == 0.0
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps(_hand_trace()))
    assert trace_summary.main([str(path), "--top", "1"]) == 0
    printed = json.loads(capsys.readouterr().out)
    assert printed["busy_s"] == pytest.approx(25e-6, rel=1e-12)
    assert list(printed["kernels"]) == ["void A<float>(float*)"]
    assert printed["bytes"] == path.stat().st_size


def test_pod_active_is_false_without_a_process_group():
    from is3d_tpu_torch.parallel.multihost import pod_active
    assert not torch.distributed.is_initialized()
    assert pod_active() is False
