"""is3d_tpu_torch's ensemble drivers and its last three writers against
is3d_tpu's (the plain torch path, CPU):

* write_particle_list_csv, write_sampled_pT_pdf and write_dN_twopidpTdy
  byte for byte against is3d_tpu/writers.py on the same events or
  spectra, and the dN_twopidpTdy pattern in the files a run cleans;
* oversample_run: its manifest's keys and parameters equal is3d_tpu's on
  the same run, a run cut short and resumed equal to an uninterrupted one
  file for file (a lost batch rebuilt), the refusals;
* oversample_run(mesh=) on a one-rank mesh: the one-chunk sharded
  sampler's files, mesh_shards in the manifest, a resume without the mesh
  refused (several ranks: tests/test_torch_parallel_events.py);
* merge_manifests over workers, and multiprocess_oversample with two
  worker processes (python -m is3d_tpu_torch.ensemble_worker) on the CPU:
  their union the single-process run's files; the multi-device keys
  checked (mesh_devices takes cards, a worker of ranks needs its rank and
  rendezvous).
"""

import json
import os

import numpy as np
import pytest
import torch

from is3d_tpu import ensemble as j_ensemble
from is3d_tpu import writers as j_writers
from is3d_tpu.api import IS3D as JIS3D

from is3d_tpu_torch import ensemble, ensemble_worker, writers
from is3d_tpu_torch.api import IS3D
from is3d_tpu_torch.io.tables import native_momentum_grid
from is3d_tpu_torch.testing import write_synthetic_run_dir

torch.set_num_threads(1)

SAMPLE = dict(operation=2, df_mode=2, regulate_deltaf=1, oversample=1,
              min_num_hadrons=300, max_num_samples=40)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    return write_synthetic_run_dir(str(tmp_path_factory.mktemp("rd")), 48, 9,
                                   2, seed=2, params=SAMPLE)


@pytest.fixture(scope="module")
def prepared(run_dir):
    run = IS3D.from_run_dir(run_dir, device="cpu")
    table, df_data, species, mcids, grid = run._prepare()
    return run, table, df_data, species, np.asarray(mcids), grid


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# ------------------------------------------------------------- writers

def test_csv_and_pT_pdf_writers_byte_identical_with_jax(prepared, tmp_path):
    run, _, df_data, species, mcids, _ = prepared
    events = IS3D.from_run_dir(
        run.data_dir, device="cpu").run_particlization(
            write_files=False).events[:6]
    events.insert(2, {k: v[:0] for k, v in events[0].items()})
    assert sum(len(e["mcid"]) for e in events) > 50
    for name, fn, jfn, args in (
            ("csv", writers.write_particle_list_csv,
             j_writers.write_particle_list_csv, (events,)),
            ("pdf", writers.write_sampled_pT_pdf,
             j_writers.write_sampled_pT_pdf, (events, mcids, run.cfg))):
        fn(*args, results_dir=str(tmp_path / "torch" / name))
        jfn(*args, results_dir=str(tmp_path / "jax" / name))
        files = sorted(os.path.relpath(os.path.join(d, f),
                                       tmp_path / "jax" / name)
                       for d, _, fs in os.walk(tmp_path / "jax" / name)
                       for f in fs)
        assert len(files) >= len(mcids) if name == "pdf" else len(events)
        for f in files:
            assert _read(tmp_path / "torch" / name / f) == \
                _read(tmp_path / "jax" / name / f), f


@pytest.mark.parametrize("dimension", [2, 3])
def test_dN_twopidpTdy_writer_byte_identical_with_jax(tmp_path, dimension):
    grid = native_momentum_grid(dimension, n_pT=7, n_phi=5, n_y=5)
    r = np.random.default_rng(dimension)
    n_y = 1 if dimension == 2 else 5
    spectra = r.lognormal(0.0, 2.0, (4, 7, 5, n_y))
    mcids = [211, -211, 321, 2212]
    writers.write_dN_twopidpTdy(spectra, grid, mcids, dimension,
                                str(tmp_path / "torch"))
    from is3d_tpu.io.tables import native_momentum_grid as jgrid
    j_writers.write_dN_twopidpTdy(spectra, jgrid(dimension, n_pT=7, n_phi=5,
                                                 n_y=5), mcids, dimension,
                                  str(tmp_path / "jax"))
    for m in mcids:
        f = f"dN_twopidpTdy_{m}.dat"
        assert _read(tmp_path / "torch" / f) == _read(tmp_path / "jax" / f)
    writers.clean_results_dir(str(tmp_path / "torch"))
    assert not os.listdir(tmp_path / "torch")


# --------------------------------------------------------- oversampling

def _oversample(prepared, out, **kw):
    run, table, df_data, species, mcids, _ = prepared
    return ensemble.oversample_run(run.surface, species, mcids, df_data,
                                   run.cfg, run.plasma(), out_dir=str(out),
                                   events_per_batch=3, base_seed=5, **kw)


def test_oversample_manifest_matches_jax(prepared, run_dir, tmp_path):
    nb, total, ntot = _oversample(prepared, tmp_path / "torch")
    ref = JIS3D.from_run_dir(run_dir)
    table, df_data, species, mcids, _grid, plasma = ref._prepare()
    jnb, jtotal, jntot = j_ensemble.oversample_run(
        ref.surface, species, np.asarray(mcids), df_data, ref.cfg, plasma,
        out_dir=str(tmp_path / "jax"), events_per_batch=3, base_seed=5)
    got = json.load(open(tmp_path / "torch" / "manifest.json"))
    want = json.load(open(tmp_path / "jax" / "manifest.json"))
    assert sorted(got) == sorted(want)
    assert {k: v for k, v in got.items() if k != "batches"} == \
        {k: v for k, v in want.items() if k != "batches"}
    assert sorted(got["batches"]) == sorted(want["batches"])
    for b, entry in got["batches"].items():
        assert sorted(entry) == sorted(want["batches"][b])
        assert entry["seed"] == want["batches"][b]["seed"]
        assert entry["events"] == want["batches"][b]["events"]
        assert os.path.isfile(entry["file"])
    assert nb == jnb >= 2 and ntot == pytest.approx(jntot, rel=1e-9)
    assert abs(total - jtotal) < 5 * np.sqrt(total + jtotal)


def test_oversample_resume_equals_uninterrupted(prepared, tmp_path):
    full = tmp_path / "full"
    nb, total, _ = _oversample(prepared, full)
    part = tmp_path / "part"
    _oversample(prepared, part, max_batches=1)
    assert len(json.load(open(part / "manifest.json"))["batches"]) == 1
    first = part / "results_0" / "particle_list_osc.dat"
    mtime = os.path.getmtime(first)
    assert _oversample(prepared, part)[:2] == (nb, total)
    assert os.path.getmtime(first) == mtime
    for i in range(nb):
        f = f"results_{i}/particle_list_osc.dat"
        assert _read(full / f) == _read(part / f), f
    lost = part / "results_1" / "particle_list_osc.dat"
    os.remove(lost)
    assert _oversample(prepared, part)[:2] == (nb, total)
    assert _read(lost) == _read(full / "results_1" / "particle_list_osc.dat")
    run, _, df_data, species, mcids, _ = prepared
    with pytest.raises(ValueError, match="refusing to resume"):
        ensemble.oversample_run(run.surface, species, mcids, df_data,
                                run.cfg, run.plasma(), out_dir=str(part),
                                events_per_batch=4, base_seed=5)
    with pytest.raises(ValueError, match="resume=True"):
        _oversample(prepared, part, resume=False)
    # mesh= raised NotImplementedError until the sharded sampler was
    # ported: a one-rank mesh samples each batch as one chunk (its seed
    # _chunk_seed(seed, 0)), records mesh_shards and refuses a resume
    # without the mesh
    from is3d_tpu_torch.kernels import sample
    from is3d_tpu_torch.parallel.mesh import CellMesh
    one_rank = CellMesh(group=None, device=torch.device("cpu"), rank=0,
                        size=1)
    mesh_dir = tmp_path / "mesh"
    assert _oversample(prepared, mesh_dir, mesh=one_rank)[0] == nb
    assert json.load(open(mesh_dir / "manifest.json"))["mesh_shards"] == 1
    run, _, df_data, species, mcids, _ = prepared
    plan = sample._ChunkPlan(run.surface, species, df_data, run.cfg,
                             run.plasma(), None, run.surface.n_cells)
    events = sample._sample_cell_chunked(
        plan, mcids, nevents=3, seed=ensemble.ensemble_seeds(5, 1000)[0])
    writers.write_particle_list_oscar(events, str(tmp_path / "b0.dat"))
    assert _read(tmp_path / "b0.dat") == _read(
        mesh_dir / "results_0" / "particle_list_osc.dat")
    with pytest.raises(ValueError, match="mesh_shards=1"):
        _oversample(prepared, mesh_dir)
    with pytest.raises(TypeError, match="CellMesh"):
        _oversample(prepared, tmp_path / "bad", mesh=object())


def test_merge_manifests_of_workers(prepared, tmp_path):
    out = tmp_path / "ov"
    whole = tmp_path / "whole"
    nb, total, _ = _oversample(prepared, whole)
    for w in range(2):
        _oversample(prepared, out, worker_id=w, n_workers=2)
    merged = ensemble.merge_manifests(str(out), 2)
    assert merged["complete"] and merged["missing_batches"] == []
    assert merged["total_hadrons"] == total
    assert sorted(merged["batches"]) == [str(b) for b in range(nb)]
    for b in range(nb):
        f = f"results_{b}/particle_list_osc.dat"
        assert _read(out / f) == _read(whole / f)
    os.remove(out / "results_0" / "particle_list_osc.dat")
    again = ensemble.merge_manifests(str(out), 2)
    assert again["missing_batches"] == [0] and not again["complete"]
    with pytest.raises(ValueError, match="ran with n_workers=2"):
        ensemble.merge_manifests(str(out), 3)
    with pytest.raises(FileNotFoundError):
        ensemble.merge_manifests(str(tmp_path / "whole2"), 1)


def test_multiprocess_oversample_two_workers(prepared, run_dir, tmp_path):
    whole = tmp_path / "whole"
    nb, total, _ = _oversample(prepared, whole)
    out = tmp_path / "mp"
    merged = ensemble.multiprocess_oversample(
        run_dir, str(out), n_workers=2, events_per_batch=3, base_seed=5,
        platform="cpu")
    assert merged["complete"] and merged["total_hadrons"] == total
    for b in range(nb):
        f = f"results_{b}/particle_list_osc.dat"
        assert _read(out / f) == _read(whole / f)
    for w in range(2):
        batches = json.load(open(out / f"manifest_worker{w}.json"))["batches"]
        assert set(batches) == {str(b) for b in range(w, nb, 2)}
    # mesh_devices raised NotImplementedError until multi-device workers
    # were ported: it takes cards (host_devices is the CPU's spelling;
    # two host_devices workers: tests/test_torch_parallel_events.py)
    with pytest.raises(ValueError, match="host_devices runs CPU ranks"):
        ensemble.multiprocess_oversample(run_dir, str(out), mesh_devices=2,
                                         device="cpu")
    with pytest.raises(ValueError, match="platform"):
        ensemble.multiprocess_oversample(run_dir, str(out), platform="tpu")


def test_worker_refuses_unknown_and_multi_device_keys(run_dir):
    with pytest.raises(SystemExit, match="unknown argument"):
        ensemble_worker.main([f"run_dir={run_dir}", "n_worker=2",
                              "device=cpu"])
    # host_devices raised NotImplementedError until multi-device workers
    # were ported: a worker of ranks needs its rank and its rendezvous
    with pytest.raises(SystemExit, match="mesh_rank= and mesh_init="):
        ensemble_worker.main([f"run_dir={run_dir}", "host_devices=4"])
    with pytest.raises(SystemExit, match="platform"):
        ensemble_worker.main([f"run_dir={run_dir}", "platform=cpu",
                              "device=cuda"])
