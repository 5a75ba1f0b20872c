"""Operation 2 of is3d_tpu_torch end to end (the plain torch path, CPU)
against is3d_tpu on the same synthetic run directories.

The port draws from its own Philox streams, so its events equal
is3d_tpu's in distribution only; held here:

* per-species yields against is3d_tpu's sampler and against the smooth
  spectra of the same surface (5 sigma), and the pion pT marginal against
  the smooth spectrum (chi^2 over coarse bins);
* the events themselves: on shell, on the tau hypersurface, from cells
  and species of the run; f16 momenta on float32 runs;
* event_partition slices concatenate to the whole run byte for byte, and a
  batch that overflows its packed capacity runs again to the same events;
* the CLI: the OSCAR list's structure as is3d_tpu's run writes it, the
  test_sampler = 1 tree with is3d_tpu's file names and mean yield, the
  decayed list on the decaying synthetic PDG list, mode 5; a rerun leaves
  no stale list; the writer is byte-identical with is3d_tpu's;
* the configurations the first half refused running (VAH surfaces, the
  binary-search draws, an active cell chunk), and mesh= (the sharded
  sampler, and IS3D's event slices over ranks) on 2 gloo ranks.
"""

import math
import os

import numpy as np
import pytest
import torch

from is3d_tpu import writers as j_writers
from is3d_tpu.api import IS3D as JIS3D
from is3d_tpu.kernels import sample as jsample

from is3d_tpu_torch import cli, observables, writers
from is3d_tpu_torch.api import IS3D
from is3d_tpu_torch.config import Config
from is3d_tpu_torch.io.tables import native_momentum_grid
from is3d_tpu_torch.kernels import sample
from is3d_tpu_torch.native import build
from is3d_tpu_torch.testing import write_synthetic_run_dir

from oracle import bin_fractions_from_grid

torch.set_num_threads(1)

SAMPLE = dict(operation=2, df_mode=2, regulate_deltaf=1, sampler_seed=42)
N_EVENTS = 300
STATS = dict(SAMPLE, oversample=1, min_num_hadrons=1e9,
             max_num_samples=N_EVENTS)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    return write_synthetic_run_dir(str(tmp_path_factory.mktemp("rd")), 64, 11,
                                   2, seed=3, params=SAMPLE)


@pytest.fixture(scope="module")
def stats(run_dir):
    """The port's and is3d_tpu's events of one run (N_EVENTS events,
    oversampled), and the port's smooth spectra of the same surface."""
    port = IS3D.from_run_dir(run_dir, overrides=STATS, device="cpu")
    got = port.run_particlization(write_files=False)
    ref = JIS3D.from_run_dir(run_dir, overrides=STATS)
    want = ref.run_particlization(write_files=False)
    smooth = IS3D.from_run_dir(run_dir, overrides=dict(operation=1),
                               device="cpu").run_particlization(
                                   write_files=False)
    return got, want, smooth


def _cat(events, k):
    return np.concatenate([np.asarray(e[k]) for e in events])


def test_yields_match_jax_sampler_and_smooth(stats):
    got, want, smooth = stats
    assert len(got.events) == len(want.events) == N_EVENTS
    np.testing.assert_array_equal(got.mcids, want.mcids)
    grid = native_momentum_grid(2)
    dNdy = observables.dN_dy(smooth.spectra, grid)[:, 0]
    y_cut = 5.0
    a, b = _cat(got.events, "mcid"), _cat(want.events, "mcid")
    for i, m in enumerate(got.mcids):
        na, nb = int((a == m).sum()), int((b == m).sum())
        # against is3d_tpu's sampler: two Poisson counts
        assert abs(na - nb) < 5 * math.sqrt(na + nb + 1), (m, na, nb)
        # against the smooth dN/dy
        sampled = na / (2 * y_cut) / N_EVENTS
        sigma = math.sqrt(max(na, 1)) / (2 * y_cut) / N_EVENTS
        assert abs(sampled - dNdy[i]) < 5 * sigma + 0.02 * dNdy[i], \
            (m, sampled, dNdy[i])
    assert a.size > 10000


def test_pion_pT_marginal_matches_smooth(stats):
    got, _, smooth = stats
    grid = native_momentum_grid(2)
    i = list(got.mcids).index(211)
    dNpT = observables.dN_twopipTdpTdy(smooth.spectra, grid)[i, :, 0]
    edges = np.array([0.0, 0.2, 0.4, 0.6, 0.9, 1.3, 4.0])
    pred = bin_fractions_from_grid(grid.pT.numpy(), dNpT, edges)
    mcid = _cat(got.events, "mcid")
    pT = np.hypot(_cat(got.events, "px"), _cat(got.events, "py"))[mcid == 211]
    counts, _ = np.histogram(pT, bins=edges)
    expect = pred * counts.sum()
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    # 5 degrees of freedom: P(chi^2 > 25) ~ 1e-4
    assert chi2 < 25.0, (counts, expect)


def test_events_are_on_shell_and_on_the_surface(stats):
    got, _, _ = stats
    for e in got.events[:20]:
        E2 = e["mass"]**2 + e["px"]**2 + e["py"]**2 + e["pz"]**2
        np.testing.assert_allclose(e["E"]**2, E2, rtol=1e-10)
        np.testing.assert_allclose(e["t"]**2 - e["z"]**2, e["tau"]**2,
                                   rtol=1e-10)
        np.testing.assert_allclose(
            e["yp"], 0.5 * np.log((e["E"] + e["pz"]) / (e["E"] - e["pz"])),
            rtol=1e-8, atol=1e-10)
        assert np.isin(e["mcid"], got.mcids).all()
        assert (np.abs(e["yp"]) <= 5.0 + 1e-9).all()


def test_sampler_shapes_match_jax():
    for lam in (3.7, 400.0, 3.5e5):
        n_cap = sample._slot_capacity(lam)
        assert n_cap == jsample._slot_capacity(lam)
        for nev in (1, 7, 300):
            B = sample._batch_width(nev, n_cap)
            assert B == jsample._batch_width(nev, n_cap)
            assert (sample._packed_capacity(B, 0.4 * lam, n_cap)
                    == jsample._packed_capacity(B, 0.4 * lam, n_cap))
    for S, C in ((320, 131072), (40000, 1 << 20), (7, 1)):
        assert sample._index_pack_bits(S, C) == jsample._index_pack_bits(S, C)
    cfg = Config(dimension=3)
    assert sample._pack_fields(cfg, True) == jsample._pack_fields(cfg, True)


def test_total_yield_in_info_matches_jax(stats, run_dir):
    got, _, _ = stats
    ref = JIS3D.from_run_dir(run_dir, overrides=STATS)
    _, df_data, species, _, _, plasma = ref._prepare()
    want = jsample.calculate_total_yield(ref.surface, species, df_data,
                                         ref.cfg, plasma)
    assert got.sample_info["total_yield"] == pytest.approx(want, rel=1e-9)
    run = IS3D.from_run_dir(run_dir, overrides=STATS, device="cpu")
    _, df_data, species, _, _ = run._prepare()
    assert sample.calculate_total_yield(
        run.surface, species, df_data, run.cfg, run.plasma()) == \
        got.sample_info["total_yield"]


def _port_events(run_dir, **kw):
    run = IS3D.from_run_dir(run_dir, overrides=SAMPLE, device="cpu")
    particle_table, df_data, species, mcids, grid = run._prepare()
    info = {}
    ev = sample.sample_particles(run.surface, species, mcids, df_data,
                                 run.cfg, run.plasma(), info=info, **kw)
    return ev, info


def _same_events(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].tobytes() == \
                y[k].tobytes(), k


def test_event_partitions_concatenate_byte_identical(run_dir):
    full, info = _port_events(run_dir, nevents=7, events_per_batch=2)
    assert info["event_lo"] == 0 and info["batches"] == 4
    parts = []
    for k in range(3):
        ev, part_info = _port_events(run_dir, nevents=7,
                                     event_partition=(k, 3))
        assert part_info["event_lo"] == (k * 7) // 3
        parts.extend(ev)
    _same_events(full, parts)
    assert sum(len(e["mcid"]) for e in full) > 100


def test_capacity_overflow_reruns_the_batch(run_dir, monkeypatch):
    ref, _ = _port_events(run_dir, nevents=6, events_per_batch=3)
    monkeypatch.setattr(sample, "_packed_capacity", lambda *a: 16)
    got, info = _port_events(run_dir, nevents=6, events_per_batch=3)
    assert info["reruns"] >= 1 and info["capacity"] > 16
    _same_events(ref, got)


def test_float32_run_ships_f16_momenta(run_dir):
    run = IS3D.from_run_dir(run_dir, overrides=dict(SAMPLE, precision="f32"),
                            device="cpu")
    ev = run.run_particlization(write_files=False).events
    e = ev[0]
    assert e["px"].dtype == np.float32 and len(e["px"]) > 10
    # f16 momenta: 11 significant bits, E rebuilt on shell from them
    np.testing.assert_array_equal(e["px"], e["px"].astype(np.float16))
    E2 = e["mass"]**2 + e["px"]**2 + e["py"]**2 + e["pz"]**2
    np.testing.assert_allclose(e["E"]**2, E2, rtol=1e-5)


# ------------------------------------------------------------ CLI, writers

def _oscar(path):
    """[(n, rows)] of an OSCAR list: each event's header count and rows."""
    events, rows = [], None
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                rows = []
                events.append((int(line.split()[1]), rows))
            else:
                rows.append(line.split())
    return events


def _cli(run_dir, tmp_path, over: dict) -> str:
    """The port's CLI run of ``run_dir`` with ``over``, its results tree
    moved to tmp_path / "torch"."""
    assert cli.main([run_dir, "device=cpu"]
                    + [f"{k}={v}" for k, v in over.items()]) == 0
    os.rename(os.path.join(run_dir, "results"), tmp_path / "torch")
    return str(tmp_path / "torch")


def test_cli_oscar_list_matches_jax_structure(run_dir, tmp_path):
    over = dict(oversample=1, min_num_hadrons=2000)
    _cli(run_dir, tmp_path, over)
    JIS3D.from_run_dir(run_dir, overrides=dict(SAMPLE, **over),
                       results_dir=str(tmp_path / "jax")).run_particlization()
    got = _oscar(tmp_path / "torch" / "particle_list_osc.dat")
    want = _oscar(tmp_path / "jax" / "particle_list_osc.dat")
    assert abs(len(got) - len(want)) <= 1 and len(got) > 10
    for n, rows in got:
        assert n == len(rows) > 0
        assert all(len(r) == 9 for r in rows)
        for r in rows[:3]:
            assert r[1].count("e") == 1 and len(r[1].split("e")[0]) == (
                19 if r[1].startswith("-") else 18)
    na, nb = sum(n for n, _ in got), sum(n for n, _ in want)
    assert abs(na - nb) < 5 * math.sqrt(na + nb)
    chosen = set(open(os.path.join(
        run_dir, "PDG", "chosen_particles_urqmd_v3.3+.dat")).read().split())
    ma = {r[0] for _, rows in got for r in rows}
    mb = {r[0] for _, rows in want for r in rows}
    assert ma <= chosen and mb <= chosen and len(ma & mb) >= 5


def test_cli_test_sampler_tree_matches_jax(run_dir, tmp_path):
    _cli(run_dir, tmp_path, dict(test_sampler=1))
    JIS3D.from_run_dir(run_dir, overrides=dict(SAMPLE, test_sampler=1),
                       results_dir=str(tmp_path / "jax")).run_particlization()

    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert tree(tmp_path / "torch") == tree(tmp_path / "jax")
    assert len(tree(tmp_path / "jax")) > 40
    a = float(open(tmp_path / "torch" / "mean_yield.dat").read())
    b = float(open(tmp_path / "jax" / "mean_yield.dat").read())
    assert a == pytest.approx(b, rel=1e-9)


def test_cli_decays_the_events(tmp_path):
    rd = write_synthetic_run_dir(str(tmp_path / "rd"), 64, 24, 2, seed=1,
                                 decays=True, params=SAMPLE)
    assert cli.main([rd, "device=cpu", "oversample=1",
                     "min_num_hadrons=500"]) == 0
    got = _oscar(os.path.join(rd, "results", "particle_list_osc.dat"))
    run = IS3D.from_run_dir(rd, device="cpu")
    table = run._prepare()[0]
    stable = {int(m) for m, s in zip(table.mc_id, table.stable) if s}
    ids = {int(r[0]) for _, rows in got for r in rows}
    assert ids and ids <= stable | {111}


def test_mode5_runs_polarization_then_sampler(tmp_path):
    rd = write_synthetic_run_dir(str(tmp_path / "rd"), 40, 7, 2, seed=4,
                                 mode=5, params=SAMPLE)
    got = IS3D.from_run_dir(rd, device="cpu").run_particlization()
    assert got.polarization is not None and len(got.events) == 1
    assert os.path.isfile(os.path.join(rd, "results", "St.dat"))
    assert os.path.isfile(os.path.join(rd, "results",
                                       "particle_list_osc.dat"))


def test_rerun_leaves_no_stale_list(run_dir, tmp_path):
    res = str(tmp_path / "res")
    IS3D.from_run_dir(run_dir, device="cpu",
                      results_dir=res).run_particlization()
    assert os.path.isfile(os.path.join(res, "particle_list_osc.dat"))
    IS3D.from_run_dir(run_dir, overrides=dict(test_sampler=1), device="cpu",
                      results_dir=res).run_particlization()
    assert not os.path.exists(os.path.join(res, "particle_list_osc.dat"))
    assert os.path.isfile(os.path.join(res, "yield_list.dat"))
    IS3D.from_run_dir(run_dir, overrides=dict(operation=1), device="cpu",
                      results_dir=res).run_particlization()
    left = {os.path.relpath(os.path.join(d, f), res)
            for d, _, fs in os.walk(res) for f in fs}
    assert not any(p.startswith(("dN_deta", "vn/", "momentum_distribution",
                                 "yield_list", "mean_yield"))
                   for p in left)


@pytest.mark.parametrize("native", [True, False])
def test_oscar_writer_byte_identical_with_jax(stats, tmp_path, monkeypatch,
                                              native):
    events = stats[0].events[:5] + [sample._empty_event()]
    j_writers.write_particle_list_oscar(events, str(tmp_path / "jax.dat"))
    if native:
        assert build.get_fastio() is not None
    else:
        monkeypatch.setattr(build, "fast_write_oscar_event",
                            lambda *a, **k: False)
    writers.write_particle_list_oscar(events, str(tmp_path / "torch.dat"))
    assert (open(tmp_path / "torch.dat", "rb").read()
            == open(tmp_path / "jax.dat", "rb").read())


@pytest.mark.parametrize("override", [
    dict(mode=2), dict(mode=3), dict(sampler_alias=0)])
def test_sampler_refusals(override, tmp_path):
    """The configurations slice 9's first half refused (VAH surfaces, the
    binary-search draws) run through the CLI now: the OSCAR list of a
    small run directory, its structure as is3d_tpu's run writes it."""
    mode = override.get("mode", 1)
    rd = write_synthetic_run_dir(str(tmp_path / "rd"), 40, 9,
                                 3 if mode == 3 else 2, seed=2, mode=mode,
                                 params=dict(SAMPLE, **override))
    assert cli.main([rd, "device=cpu", "oversample=1",
                     "min_num_hadrons=300"]) == 0
    got = _oscar(os.path.join(rd, "results", "particle_list_osc.dat"))
    assert got and all(n == len(rows) > 0 for n, rows in got)
    assert sum(n for n, _ in got) >= 100


def test_sampler_refuses_active_cell_chunk_and_mesh(run_dir, tmp_path):
    """An active cell chunk runs (the chunked sampler, its 4 chunks of 16
    cells).  mesh= raised NotImplementedError until the sharded sampler
    and pod mode were ported: on 2 gloo ranks sample_particles(mesh=)
    gives every rank the chunked run of 2 chunks of 32 cells byte for
    byte, and IS3D(mesh=)'s slices of the events concatenate to the
    one-process list."""
    from is3d_tpu_torch import testing
    run = IS3D.from_run_dir(run_dir, overrides=dict(sampler_cell_chunk=16),
                            device="cpu")
    result = run.run_particlization(write_files=False)
    assert result.sample_info["chunks"] == 4 and result.events
    run = IS3D.from_run_dir(run_dir, overrides=dict(sampler_seed=8),
                            device="cpu")
    _, df_data, species, mcids, grid = run._prepare()
    case = dict(surface=run.surface, species=species, mcids=mcids,
                df_data=df_data, cfg=run.cfg, plasma=run.plasma(),
                nevents=5, seed=8)
    path = str(tmp_path / "case.pt")
    torch.save(dict(batched={}, samples=dict(c=case)), path)
    ranks = testing.run_ranks(
        testing.event_suite_rank, 2, str(tmp_path / "w"),
        args=(path, [], None, ()), timeout=240.0)
    want, _ = testing.sample_case(case, chunk=32)
    assert sum(len(e["mcid"]) for e in want) > 100
    for res in ranks:
        assert testing.same_events(res["samples"]["c"][0], want)
    one = run.run_particlization(write_files=False).events
    ranks = testing.run_ranks(
        testing.mesh_api_rank, 2, str(tmp_path / "w2"),
        args=([dict(name="op2", run_dir=run_dir,
                    overrides=dict(sampler_seed=8),
                    results_dir=str(tmp_path / "mesh"))], False),
        timeout=240.0)
    assert testing.same_events(
        [e for res in ranks for e in res["op2"]["events"]], one)
