"""is3d_tpu_torch.batch and IS3D.run_ensemble on the CPU in float64.

* Each batched row is its surface's single run bit for bit (df 1-4 and
  VAH; the spin polarization of mode-5 surfaces too), and agrees with
  is3d_tpu.batch at the f64 bar (rtol 1e-9 / atol 1e-12 x max: JAX's
  vmapped rows are another compilation of the same sums).
* Gradients through the batch equal is3d_tpu's (rtol 1e-8 / atol 1e-10 x
  max, as tests/test_torch_grad.py); a VAH ensemble's equal each event's
  single run's (rtol 1e-12); pad cells get exactly 0.
* stack_surfaces' padding and refusals; mesh= of one rank runs the
  one-process path, and an event count the ranks do not divide or a
  mesh that is not a CellMesh is refused (the event axis over several
  ranks: tests/test_torch_parallel_events.py).
* run_ensemble's per-event trees against is3d_tpu's on synthetic run
  directories (mode 1 with the feed-down off, mode 5 with the
  polarization), file by file as tests/test_torch_slice.py compares them,
  and the stale event_<i> trees of a larger earlier ensemble cleaned.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from is3d_tpu import batch as jbatch
from is3d_tpu import testing as jtesting
from is3d_tpu.api import IS3D as JIS3D
from is3d_tpu.config import Config as JConfig
from is3d_tpu.io.surface import Surface as JSurface
from is3d_tpu.io.tables import native_momentum_grid as j_native_grid

from is3d_tpu_torch import batch, convert, testing
from is3d_tpu_torch.api import IS3D
from is3d_tpu_torch.config import Config
from is3d_tpu_torch.io.surface import surface_from_arrays
from is3d_tpu_torch.kernels.polzn import spin_polarization

from test_torch_slice import _tree, _numbers
from test_torch_smooth import jax_state

torch.set_num_threads(1)

GRID = dict(n_pT=6, n_phi=5, n_eta=10)
SIZES = (17, 9, 23)
BASE = dict(operation=1, mode=1, dimension=2, df_mode=2,
            include_shear_deltaf=1, include_bulk_deltaf=1,
            regulate_deltaf=1, outflow=1, cell_chunk=8)


def _cells(seeds=(3, 4, 5), sizes=SIZES, vah=False):
    make = testing.synthetic_vah_cells if vah else \
        testing.synthetic_surface_cells
    return [make(n, 2, seed=s) for n, s in zip(sizes, seeds)]


def _port(cfg_kw):
    jsp = jtesting.synthetic_species(5)
    jgrid = j_native_grid(dimension=2, **GRID)
    jdf = jtesting.synthetic_deltaf_data()
    return ((jsp, jgrid, jdf, JConfig(**cfg_kw)),
            (convert.species_from_state(jax_state(jsp)),
             convert.grid_from_state(jax_state(jgrid)),
             convert.deltaf_from_state(jax_state(jdf)), Config(**cfg_kw)))


@pytest.mark.parametrize("df_mode", [1, 2, 3, 4])
def test_batched_rows_are_single_runs(df_mode):
    cfg_kw = dict(BASE, df_mode=df_mode)
    (jsp, jgrid, jdf, jcfg), (sp, grid, df, cfg) = _port(cfg_kw)
    cells = _cells()
    surfaces = [convert.surface_from_state(c) for c in cells]
    stacked = batch.stack_surfaces(surfaces)
    assert stacked.tau.shape == (3, max(SIZES)) and stacked.counts == SIZES
    out = batch.smooth_spectra_batched(stacked, sp, grid, df, cfg)
    single = batch._single_fn(sp, grid, df, cfg)
    for e, s in enumerate(surfaces):
        assert torch.equal(out[e], single(s)), e
    want = np.asarray(jbatch.smooth_spectra_batched(
        jbatch.stack_surfaces([JSurface(**{k: jnp.asarray(v)
                                           for k, v in c.items()})
                               for c in cells]), jsp, jgrid, jdf, jcfg))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-9,
                               atol=1e-12 * np.abs(want).max())


def test_batched_vah_rows_are_single_runs():
    cfg_kw = dict(BASE, mode=2)
    _, (sp, grid, _, cfg) = _port(cfg_kw)
    surfaces = [surface_from_arrays(**c) for c in _cells(vah=True)]
    stacked = batch.stack_surfaces(surfaces)
    out = batch.smooth_spectra_batched(stacked, sp, grid, None, cfg)
    single = batch._single_fn(sp, grid, None, cfg)
    for e, s in enumerate(surfaces):
        assert torch.equal(out[e], single(s)), e
    # a loss summed over the ensemble: each event's gradient is its single
    # run's (K4's backward on the card), the pad cells' exactly 0
    wrt = ("Lambda", "aL", "ux")
    theta = {k: getattr(stacked, k).clone().requires_grad_(True)
             for k in wrt}
    with torch.enable_grad():
        out = batch.batched_spectra_fn(sp, grid, None, cfg)(
            stacked.replace(**theta))
        grads = torch.autograd.grad(out.sum(), list(theta.values()))
    for e, s in enumerate(surfaces):
        one = {k: getattr(s, k).clone().requires_grad_(True) for k in wrt}
        with torch.enable_grad():
            want = torch.autograd.grad(single(s.replace(**one)).sum(),
                                       list(one.values()))
        n = s.n_cells
        for k, g, w in zip(wrt, grads, want):
            assert w.abs().max() > 0, k
            np.testing.assert_allclose(g[e, :n].numpy(), w.numpy(),
                                       rtol=1e-12, atol=0, err_msg=k)
            assert (g[e, n:] == 0).all(), k


def test_batched_polarization_rows_are_single_runs():
    cfg_kw = dict(BASE, mode=5, df_mode=1, include_shear_deltaf=0,
                  include_bulk_deltaf=0, regulate_deltaf=0)
    _, (sp, grid, _, cfg) = _port(cfg_kw)
    surfaces = [surface_from_arrays(**c, **testing.synthetic_vorticity(
        c["tau"].shape[0], seed=i)) for i, c in enumerate(_cells(
            sizes=(6, 11), seeds=(1, 2)))]
    T_avg = [0.151, 0.158]
    out = batch.polarization_batched(batch.stack_surfaces(surfaces), sp,
                                     grid, cfg, T_avg)
    for e, s in enumerate(surfaces):
        ref = spin_polarization(s, sp, grid, cfg, dataclasses.make_dataclass(
            "P", [("temperature", float)])(T_avg[e]))
        for k in ref:
            assert torch.equal(out[k][e].nan_to_num(7.0),
                               ref[k].nan_to_num(7.0)), k


def test_stack_pads_inert_and_refuses_mixed_blocks():
    a, b = (convert.surface_from_state(c) for c in _cells()[:2])
    stacked = batch.stack_surfaces([a, b], pad_to=30)
    assert stacked.tau.shape == (2, 30)
    assert (stacked.tau[1, 9:] == 1).all() and (stacked.dat[1, 9:] == 0).all()
    assert torch.equal(batch.event(stacked, 1).T, b.T)
    with pytest.raises(ValueError, match="pad_to"):
        batch.stack_surfaces([a], pad_to=3)
    with pytest.raises(ValueError, match="bulkPi"):
        batch.stack_surfaces([a, b.replace(bulkPi=None)])
    with pytest.raises(ValueError, match="at least one"):
        batch.stack_surfaces([])
    empty = batch.empty_like_surface(a)
    assert (empty.dat == 0).all() and (empty.T == 1).all()


def test_mesh_is_refused():
    """mesh= raised NotImplementedError until the event axis was ported:
    a one-rank mesh now gives the one-process rows bit for bit (its own
    events are all of them, no collective), and what is refused is a
    mesh that is not a CellMesh and an event count the ranks do not
    divide."""
    from is3d_tpu_torch.parallel.mesh import CellMesh
    _, (sp, grid, df, cfg) = _port(BASE)
    stacked = batch.stack_surfaces([convert.surface_from_state(c)
                                    for c in _cells()])
    one_rank = CellMesh(group=None, device=torch.device("cpu"), rank=0,
                        size=1)
    assert torch.equal(
        batch.smooth_spectra_batched(stacked, sp, grid, df, cfg,
                                     mesh=one_rank),
        batch.smooth_spectra_batched(stacked, sp, grid, df, cfg))
    with pytest.raises(TypeError, match="CellMesh"):
        batch.smooth_spectra_batched(stacked, sp, grid, df, cfg,
                                     mesh=object())
    two = CellMesh(group=None, device=torch.device("cpu"), rank=0, size=2)
    with pytest.raises(ValueError, match="event count 3 does not divide"):
        batch.polarization_batched(stacked, sp, grid, cfg, 0.15, mesh=two)


def test_gradients_flow_through_batch():
    """d(sum over the ensemble)/dT on a stacked batch against is3d_tpu's;
    pad cells' gradients are exactly 0."""
    (jsp, jgrid, jdf, jcfg), (sp, grid, df, cfg) = _port(BASE)
    cells = _cells((7, 8), (6, 11))
    jst = jbatch.stack_surfaces([JSurface(**{k: jnp.asarray(v)
                                             for k, v in c.items()})
                                 for c in cells])
    jfn = jbatch.batched_spectra_fn(jsp, jgrid, jdf, jcfg)
    want = np.asarray(jax.grad(lambda T: jnp.sum(jfn(jst.replace(T=T))))(
        jst.T))
    stacked = batch.stack_surfaces([convert.surface_from_state(c)
                                    for c in cells])
    fn = batch.batched_spectra_fn(sp, grid, df, cfg)
    T = stacked.T.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(fn(stacked.replace(T=T)).sum(), T)
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-8,
                               atol=1e-10 * np.abs(want).max())
    assert (g[0, 6:] == 0).all()


# ------------------------------------------------------------ run_ensemble

def _ensemble_dirs(tmp_path, mode, sizes=(40, 24, 32)):
    """A run directory and the surface files of three events (each event's
    file from a run directory of its own seed)."""
    run = testing.write_synthetic_run_dir(str(tmp_path / "run"), sizes[0],
                                          7, 2, seed=3, mode=mode)
    paths = [os.path.join(run, "input", "surface.dat")]
    for i, n in enumerate(sizes[1:]):
        d = testing.write_synthetic_run_dir(str(tmp_path / f"ev{i}"), n, 7,
                                            2, seed=10 + i, mode=mode)
        paths.append(os.path.join(d, "input", "surface.dat"))
    return run, paths


def _same_trees(a, b):
    jt, tt = _tree(a), _tree(b)
    assert sorted(jt) == sorted(tt) and jt
    for rel in jt:
        va, wa = _numbers(jt[rel])
        vb, wb = _numbers(tt[rel])
        assert wa == wb and va.shape == vb.shape, rel
        np.testing.assert_allclose(vb, va, rtol=1e-6,
                                   atol=1e-6 * np.abs(va).max(), err_msg=rel)
    return jt


@pytest.mark.parametrize("mode", [1, 5])
def test_run_ensemble_trees_match_jax(tmp_path, mode):
    run, paths = _ensemble_dirs(tmp_path, mode)
    jres = JIS3D.from_run_dir(run, results_dir=str(tmp_path / "jax")
                              ).run_ensemble(paths)
    port = IS3D.from_run_dir(run, device="cpu",
                             results_dir=str(tmp_path / "torch"))
    res = port.run_ensemble(paths)
    assert len(res) == len(jres) == 3
    jt = _same_trees(tmp_path / "jax", tmp_path / "torch")
    assert {r.split(os.sep)[0] for r in jt} == {"event_0", "event_1",
                                                "event_2"}
    if mode == 5:
        assert "event_2/St.dat" in jt
        for k in res[1].polarization:
            np.testing.assert_allclose(res[1].polarization[k],
                                       jres[1].polarization[k], rtol=1e-9,
                                       atol=1e-12 * np.nanmax(np.abs(
                                           jres[1].polarization[k])))
    # each event's spectra are its single run's, bit for bit
    single = IS3D.from_run_dir(run, device="cpu").read_fo_surf_from_file(
        paths[1], write_averages=False).run_particlization(write_files=False)
    np.testing.assert_array_equal(res[1].spectra, single.spectra)
    names = [n for n, _ in port.timer.phases]
    assert names[:3] == ["load surfaces", "prepare (io, pdg, deltaf)",
                         "stack + batched spectra"]


def test_run_ensemble_cleans_stale_event_trees(tmp_path):
    run, paths = _ensemble_dirs(tmp_path, 1)
    out = str(tmp_path / "out")
    port = IS3D.from_run_dir(run, device="cpu", results_dir=out)
    port.run_ensemble(paths)
    os.makedirs(os.path.join(out, "event_2", "mine"))
    IS3D.from_run_dir(run, device="cpu", results_dir=out).run_ensemble(
        paths[:1])
    assert os.path.isdir(os.path.join(out, "event_0"))
    # the stale trees hold no file of the writers any more (is3d_tpu's
    # cleaning: their own files, then the directory if nothing is left)
    assert _tree(os.path.join(out, "event_1")) == {}
    assert _tree(os.path.join(out, "event_2")) == {}
    assert os.path.isdir(os.path.join(out, "event_2", "mine"))
    with pytest.raises(ValueError, match="operation 1"):
        IS3D.from_run_dir(run, device="cpu", overrides=dict(operation=0)
                          ).run_ensemble(paths)
