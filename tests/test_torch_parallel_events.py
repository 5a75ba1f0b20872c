"""is3d_tpu_torch over ranks on the event axis and the cell-sharded
sampler, on the CPU: ``mesh=`` (a CellMesh) over W = 2 and 3 gloo ranks.

One spawn of W ranks per W (testing.event_suite_rank) runs every case:

* batch.smooth_spectra_batched (2+1D df 2 with the mT remap, 3+1D df 3
  whose cells break down) and batch.polarization_batched (mode 5) of a
  6-event ensemble of unequal cell counts, and the gradient of the
  batched spectra by three stacked fields (surface_value_and_grad and
  surface_vjp): every rank's rows and gradients equal one process's BIT
  FOR BIT; an event count W does not divide raises ValueError;
* IS3D.run_ensemble(mesh=) on 6 events (2+1D df 2 with the feed-down,
  each event's on the rank that owns it; mode 5 with the polarization):
  rank 0's event_<i> trees are the one-process trees byte for byte and no
  other rank writes;
* kernels.sample.sample_particles(mesh=) (viscous df 2 with alias draws,
  VAH with the binary searches): every rank's list equals one process's
  _sample_cell_chunked with ceil(C / W) cells a chunk byte for byte, and
  event_partition or events_per_batch with mesh= raise ValueError;
* ensemble.oversample_run(mesh=): its batch files are the one-process
  chunked runs' byte for byte, its manifest records mesh_shards = W, and a
  resume at another rank count refuses; two multiprocess_oversample
  workers of host_devices = 2 ranks each, against the same.

Against is3d_tpu: the one-process batched rows against is3d_tpu.batch at
rtol 1e-9, and the sharded sampler's per-species yields against is3d_tpu's
sample_particles_sharded on a one-device jax mesh within 5 sigma.  f64,
tens of cells; one worker, about a minute.
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from is3d_tpu import batch as jbatch
from is3d_tpu import testing as jtesting
from is3d_tpu.config import Config as JConfig
from is3d_tpu.io.surface import Surface as JSurface, ThermoAverages as JAvg
from is3d_tpu.io.tables import native_momentum_grid as j_native_grid
from is3d_tpu.kernels import sample as jsample
from is3d_tpu.parallel import mesh as jmesh

from is3d_tpu_torch import batch, convert, ensemble, testing, writers
from is3d_tpu_torch.api import IS3D
from is3d_tpu_torch.config import Config
from is3d_tpu_torch.io.surface import ThermoAverages
from is3d_tpu_torch.kernels import sample
from is3d_tpu_torch.parallel import mesh as pmesh

from test_torch_sample import PLASMA, species_pair
from test_torch_sample_chunked import surface_pair
from test_torch_slice import _tree
from test_torch_smooth import jax_state

torch.set_num_threads(1)

W_ALL = (2, 3)
E = 6
SIZES = (31, 17, 40, 23, 36, 12)
VISC = dict(include_shear_deltaf=1, include_bulk_deltaf=1)
GRID = dict(n_pT=5, n_phi=4, n_y=5, n_eta=10)
T_AVG = (0.150, 0.152, 0.154, 0.151, 0.153, 0.155)
GRAD_WRT = ("T", "ux", "dat")
JOIN_TIMEOUT = 240.0
# name: (kind, dimension, remap, cfg, cell scales (shear, bulk))
BATCHED = {
    "smooth_2d_df2_remap": ("spectra", 2, True,
                            dict(df_mode=2, regulate_deltaf=1, **VISC),
                            (1.0, 1.0)),
    "feqmod_3d_df3": ("spectra", 3, False, dict(df_mode=3, **VISC),
                      (0.1, 0.01)),
    "polzn_2d": ("polzn", 2, True, dict(mode=5), (1.0, 1.0)),
}
GRADS = (("smooth_2d_df2_remap", GRAD_WRT),)
SAMPLES = {"vh_df2": 1, "vah_chains": 0}    # name: sampler_alias
OVERSAMPLE = dict(oversample=1, min_num_hadrons=1500)


def _cells(kind, dimension, scales, seed, n):
    cells = jtesting.synthetic_surface_cells(n, dimension, seed)
    for k in ("pixx", "pixy", "pixn", "piyy", "piyn"):
        cells[k] = cells[k] * scales[0]
    cells["bulkPi"] = cells["bulkPi"] * scales[1]
    if kind == "polzn":
        cells.update(testing.synthetic_vorticity(n, seed))
    return cells


def _batched(name):
    """The port's batched case and is3d_tpu's stacked inputs."""
    kind, dimension, remap, cfg_kw, scales = BATCHED[name]
    jsp = jtesting.synthetic_species(n_species=7)
    jgrid = j_native_grid(dimension=dimension, eta_mT_rescale=remap, **GRID)
    jdf = jtesting.synthetic_deltaf_data()
    cells = [_cells(kind, dimension, scales, 20 + e, n)
             for e, n in enumerate(SIZES)]
    stacked = batch.stack_surfaces([convert.surface_from_state(c)
                                    for c in cells])
    cfg = Config(operation=1, dimension=dimension, **cfg_kw)
    case = dict(kind=kind, stacked=stacked, cfg=cfg,
                species=convert.species_from_state(jax_state(jsp)),
                grid=convert.grid_from_state(jax_state(jgrid)),
                df_data=convert.deltaf_from_state(jax_state(jdf)),
                T_avg=torch.tensor(T_AVG, dtype=torch.float64))
    jst = jbatch.stack_surfaces([JSurface(**{k: jnp.asarray(v)
                                             for k, v in c.items()})
                                 for c in cells])
    jcfg = JConfig(operation=1, mode=cfg.mode, dimension=dimension,
                   **{k: v for k, v in cfg_kw.items() if k != "mode"})
    return case, (jst, jsp, jgrid, jdf, jcfg)


def _sample_case(name, nevents=7):
    surf, _, cfg, _, _ = surface_pair(name)
    _, sp = species_pair()
    df = convert.deltaf_from_state(jax_state(
        jtesting.synthetic_deltaf_data()))
    return dict(surface=surf, species=sp, mcids=np.arange(101, 110),
                df_data=None if cfg.mode in (2, 3) else df,
                cfg=cfg.replace(sampler_alias=SAMPLES[name],
                                sampler_cell_chunk=-1),
                plasma=ThermoAverages(**PLASMA), nevents=nevents, seed=9)


def _ensemble_runs(root):
    """Two run directories of 6 events each: 2+1D df 2 with the feed-down
    (the decaying list), and mode 5."""
    runs = []
    for name, mode, n_species, decays in (("ens_decays", 1, 24, True),
                                          ("ens_mode5", 5, 7, False)):
        run_dir = testing.write_momentum_tables(
            testing.write_synthetic_run_dir(
                str(root / name), SIZES[0], n_species, 2, seed=3, mode=mode,
                decays=decays))
        paths = [os.path.join(run_dir, "input", "surface.dat")] + [
            testing.write_surface_file(str(root / name / f"ev{e}.dat"), n,
                                       2, seed=30 + e, mode=mode)
            for e, n in enumerate(SIZES[1:], start=1)]
        runs.append(dict(name=name, run_dir=run_dir, surfaces=paths,
                         overrides=dict(df_mode=2),
                         results_dir=os.path.join(run_dir, "one")))
    return runs


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("events")
    cases = {name: _batched(name)[0] for name in BATCHED}
    samples = {name: _sample_case(name) for name in SAMPLES}
    path = str(root / "inputs.pt")
    torch.save(dict(batched=cases, samples=samples), path)
    runs = _ensemble_runs(root)
    return dict(
        root=root, path=path, cases=cases, samples=samples, runs=runs,
        one={name: testing.batched_case(c) for name, c in cases.items()},
        grads={name: testing.batched_grad(cases[name], wrt)
               for name, wrt in GRADS},
        ensembles={r["name"]: testing.ensemble_run(r) for r in runs})


@pytest.fixture(scope="module")
def spawned(inputs):
    done = {}

    def spawn(W):
        if W not in done:
            runs = [dict(r, results_dir=os.path.join(r["run_dir"],
                                                     f"mesh{W}"))
                    for r in inputs["runs"]]
            over = dict(case="vh_df2", overrides=OVERSAMPLE, base_seed=5,
                        events_per_batch=3,
                        out_dir=str(inputs["root"] / f"over{W}"))
            done[W] = testing.run_ranks(
                testing.event_suite_rank, W, str(inputs["root"] / f"w{W}"),
                args=(inputs["path"], runs, over, GRADS),
                timeout=JOIN_TIMEOUT)
        return done[W]
    return spawn


@pytest.fixture(scope="module", params=W_ALL)
def ranks(request, spawned):
    return request.param, spawned(request.param)


def _equal(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(b, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in b)
    if isinstance(b, np.ndarray):
        return np.array_equal(a, b, equal_nan=True)
    return torch.equal(a, b)


def _mesh(W, r=0):
    return pmesh.CellMesh(group=None, device=torch.device("cpu"), rank=r,
                          size=W)


@pytest.mark.parametrize("name", sorted(BATCHED))
def test_batched_rows_match_one_process_bits(ranks, inputs, name):
    W, out = ranks
    want = inputs["one"][name]
    for r, res in enumerate(out):
        assert _equal(res["batched"][name], want), (W, r)


def test_batched_grad_matches_one_process_bits(ranks, inputs):
    W, out = ranks
    for name, wrt in GRADS:
        want = inputs["grads"][name]
        assert all(want["grads"][k].abs().max() > 0 for k in wrt)
        for r, res in enumerate(out):
            got = res["grads"][name]
            assert torch.equal(got["value"], want["value"]), (W, r)
            assert _equal(got["grads"], want["grads"]), (W, r, "grad")
            assert _equal(got["vjp"], want["vjp"]), (W, r, "vjp")
    # pad cells (event 5 has 12 of 40) get exactly 0
    assert (inputs["grads"][GRADS[0][0]]["grads"]["T"][5, 12:] == 0).all()


def test_event_count_must_divide_the_ranks(inputs, tmp_path):
    case = inputs["cases"]["smooth_2d_df2_remap"]
    with pytest.raises(ValueError, match="does not divide the 4-rank"):
        testing.batched_case(case, _mesh(4))
    with pytest.raises(ValueError, match="empty_like_surface"):
        testing.batched_case(inputs["cases"]["polzn_2d"], _mesh(5))
    with pytest.raises(TypeError, match="CellMesh"):
        testing.batched_case(case, object())
    run = inputs["runs"][1]
    with pytest.raises(ValueError, match="does not divide the 4-rank"):
        IS3D.from_run_dir(run["run_dir"], overrides=run["overrides"],
                          results_dir=str(tmp_path), mesh=_mesh(4)
                          ).run_ensemble(run["surfaces"])
    assert not os.listdir(tmp_path)
    # the throwaway padding events round the ensemble up: zero rows
    empty = batch.empty_like_surface(batch.event(case["stacked"], 0))
    padded = batch.stack_surfaces(
        [batch.event(case["stacked"], e) for e in range(E)] + [empty] * 2)
    rows = testing.batched_case(dict(case, stacked=padded))
    assert torch.equal(rows[:E], inputs["one"]["smooth_2d_df2_remap"])
    assert (rows[E:] == 0).all()


@pytest.mark.parametrize("name", ["ens_decays", "ens_mode5"])
def test_run_ensemble_mesh_trees_match_one_process(ranks, inputs, name):
    W, out = ranks
    run = next(r for r in inputs["runs"] if r["name"] == name)
    want = inputs["ensembles"][name]
    for r, res in enumerate(out):
        got = res["ensembles"][name]
        assert _equal(got["spectra"], want["spectra"]), (W, r)
        assert _equal(got["polarization"], want["polarization"]), (W, r)
        assert got["wrote"] == (r == 0)
        assert not os.path.exists(os.path.join(run["run_dir"],
                                               f"mesh{W}_rank{r}"))
    one, mesh = (_tree(os.path.join(run["run_dir"], d))
                 for d in ("one", f"mesh{W}"))
    assert sorted(one) == sorted(mesh)
    assert {p.split(os.sep)[0] for p in one} == {f"event_{e}"
                                                 for e in range(E)}
    assert any("resonance_decays" in p for p in one) == (
        name == "ens_decays")
    for rel in one:
        with open(one[rel], "rb") as a, open(mesh[rel], "rb") as b:
            assert a.read() == b.read(), rel


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_sharded_sampler_matches_chunked_bytes(ranks, inputs, name):
    W, out = ranks
    case = inputs["samples"][name]
    C = case["surface"].tau.shape[0]
    want, info = testing.sample_case(case, chunk=-(-C // W))
    assert info["chunks"] == W and sum(len(e["mcid"]) for e in want) > 100
    for r, res in enumerate(out):
        got, ginfo = res["samples"][name]
        assert testing.same_events(got, want), (W, r)
        assert ginfo["event_lo"] == 0 and ginfo["nevents_global"] == 7
        assert ginfo["total_yield"] == info["total_yield"]
        assert (ginfo["accepted"], ginfo["proposed"]) == (
            info["accepted"], info["proposed"])


def test_sharded_sampler_refusals(inputs):
    case = inputs["samples"]["vh_df2"]
    args = (case["surface"], case["species"], case["mcids"],
            case["df_data"], case["cfg"], case["plasma"])
    with pytest.raises(ValueError, match="event_partition composes"):
        sample.sample_particles(*args, mesh=_mesh(2), event_partition=(0, 2))
    with pytest.raises(ValueError, match="events_per_batch"):
        sample.sample_particles(*args, mesh=_mesh(2), events_per_batch=4)
    with pytest.raises(TypeError, match="CellMesh"):
        sample.sample_particles(*args, mesh="2 cards")


def _batch_files(case, W, out_dir, n_batches, events_per_batch, n_events,
                 base_seed):
    """The one-process chunked run of every oversampling batch, written
    as its OSCAR file; returns {batch: bytes}."""
    seeds = ensemble.ensemble_seeds(base_seed, 1000)
    C = case["surface"].tau.shape[0]
    out = {}
    for b in range(n_batches):
        nev = min(events_per_batch, n_events - b * events_per_batch)
        ev, _ = testing.sample_case(dict(case, nevents=nev, seed=seeds[b]),
                                    chunk=-(-C // W))
        path = os.path.join(out_dir, f"one_{b}.dat")
        writers.write_particle_list_oscar(ev, path)
        with open(path, "rb") as f:
            out[b] = f.read()
    return out


def test_oversample_run_mesh_manifest_and_files(ranks, inputs, tmp_path):
    W, out = ranks
    case = dict(inputs["samples"]["vh_df2"])
    case["cfg"] = case["cfg"].replace(**OVERSAMPLE)
    over = inputs["root"] / f"over{W}"
    manifest = json.load(open(over / "manifest.json"))
    assert manifest["mesh_shards"] == W
    nb, total, _ = out[0]["oversample"]
    assert all(res["oversample"] == out[0]["oversample"] for res in out)
    assert nb == len(manifest["batches"]) >= 2
    assert total == sum(v["hadrons"] for v in manifest["batches"].values())
    want = _batch_files(case, W, str(tmp_path), nb, 3,
                        manifest["n_events_needed"], 5)
    for b in range(nb):
        with open(over / f"results_{b}" / "particle_list_osc.dat",
                  "rb") as f:
            assert f.read() == want[b], b
    args = (case["surface"], case["species"], case["mcids"],
            case["df_data"], case["cfg"], case["plasma"])
    for mesh in (None, _mesh(W + 1)):
        with pytest.raises(ValueError, match=f"mesh_shards={W}"):
            ensemble.oversample_run(*args, out_dir=str(over), base_seed=5,
                                    events_per_batch=3, mesh=mesh)


def test_multiprocess_oversample_host_devices(tmp_path):
    """Two workers of two gloo CPU ranks each: the batches of the plan are
    the one-process chunked runs (two chunks) byte for byte."""
    run_dir = testing.write_synthetic_run_dir(
        str(tmp_path / "run"), 45, 7, 2, seed=4, params=dict(operation=2))
    overrides = dict(oversample=1, min_num_hadrons=600)
    merged = ensemble.multiprocess_oversample(
        run_dir, str(tmp_path / "mp"), n_workers=2, events_per_batch=3,
        base_seed=5, overrides=overrides, host_devices=2, timeout=240.0)
    assert merged["complete"] and merged["mesh_shards"] == 2
    nb = len(merged["batches"])
    assert nb >= 3
    run = IS3D.from_run_dir(run_dir, overrides=overrides, device="cpu")
    _, df, sp, mcids, _ = run._prepare()
    case = dict(surface=run.surface, species=sp, mcids=mcids, df_data=df,
                cfg=run.cfg, plasma=run.plasma())
    want = _batch_files(case, 2, str(tmp_path), nb, 3,
                        merged["n_events_needed"], 5)
    for b in range(nb):
        with open(tmp_path / "mp" / f"results_{b}" /
                  "particle_list_osc.dat", "rb") as f:
            assert f.read() == want[b], b
    with pytest.raises(ValueError, match="give one"):
        ensemble.multiprocess_oversample(run_dir, str(tmp_path / "x"),
                                         mesh_devices=2, host_devices=2)
    with pytest.raises(ValueError, match="contradicts"):
        ensemble.multiprocess_oversample(run_dir, str(tmp_path / "x"),
                                         host_devices=2, device="cuda")


@pytest.mark.parametrize("name", ["smooth_2d_df2_remap", "polzn_2d"])
def test_one_process_batched_matches_jax(inputs, name):
    """The one-process batched rows (every rank's bits, above) against
    is3d_tpu.batch's vmapped rows at rtol 1e-9."""
    case, (jst, jsp, jgrid, jdf, jcfg) = _batched(name)
    got = inputs["one"][name]
    if case["kind"] == "polzn":
        want = jbatch.polarization_batched(jst, jsp, jgrid, jcfg,
                                           np.asarray(T_AVG))
        for k in want:
            w = np.asarray(want[k])
            np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-9,
                                       atol=1e-12 * np.nanmax(np.abs(w)),
                                       err_msg=k)
        return
    want = np.asarray(jbatch.smooth_spectra_batched(jst, jsp, jgrid, jdf,
                                                    jcfg))
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                               atol=1e-12 * np.abs(want).max())


def test_sharded_sampler_matches_jax_sharded_in_distribution():
    """Per-species yields of the sharded sampler (W = 2: the chunked run of
    two chunks, every rank's list above) within 5 sigma of is3d_tpu's
    sample_particles_sharded on a one-device jax mesh."""
    nev = 60
    case = _sample_case("vh_df2", nevents=nev)
    _, jsurf, _, jcfg, _ = surface_pair("vh_df2")
    jsp, _ = species_pair()
    C = case["surface"].tau.shape[0]
    got, _ = testing.sample_case(case, chunk=-(-C // 2))
    ref = jsample.sample_particles(
        jsurf, jsp, np.arange(101, 110), None,
        jtesting.synthetic_deltaf_data(),
        jcfg.replace(sampler_alias=1, sampler_cell_chunk=-1),
        JAvg(**PLASMA), nevents=nev, seed=9, mesh=jmesh.default_mesh(1))
    ids = [np.concatenate([e["mcid"] for e in ev]) for ev in (got, ref)]
    assert len(ref) == nev and ids[0].size > 1500
    for m in range(101, 110):
        a, b = (int((i == m).sum()) for i in ids)
        assert abs(a - b) < 5 * math.sqrt(a + b + 1), (m, a, b)
