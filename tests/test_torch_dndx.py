"""is3d_tpu_torch's dN/dX path (operation 0, the plain torch version on the
CPU) against is3d_tpu.kernels.dndx on identical inputs.

Inputs are made with numpy from a seed, built on the JAX side and carried
to the port through is3d_tpu_torch.convert (test_torch_smooth.jax_state).
Tolerance: f64 on both sides, so the two differ only by summation order
and the regrouping of the same terms: rtol=1e-9 with atol=1e-12 * max|ref|
for near-zero bins, as test_torch_smooth.py.  The results trees are held to
the BASELINE.md bar of 1e-6 relative, since their %.6e values may flip a
last digit.
"""

import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from is3d_tpu import testing as jtesting
from is3d_tpu.api import IS3D as JIS3D
from is3d_tpu.config import Config as JConfig
from is3d_tpu.io.surface import Surface as JSurface
from is3d_tpu.io.tables import native_momentum_grid as j_native_grid
from is3d_tpu.kernels import dndx as jdndx
from is3d_tpu.kernels.common import (surface_columns as j_surface_columns,
                                     prepare_cells as j_prepare_cells)
from is3d_tpu.kernels.smooth import _chunk_contribution

from is3d_tpu_torch import cli, convert
from is3d_tpu_torch.api import IS3D
from is3d_tpu_torch.config import Config
from is3d_tpu_torch.kernels import dndx
from is3d_tpu_torch.kernels.common import surface_columns, prepare_cells
from is3d_tpu_torch.kernels.smooth import (pack_cells, spectra_flags,
                                           momentum_constants)
from is3d_tpu_torch import testing as ptesting
from is3d_tpu_torch.testing import write_synthetic_run_dir

from test_torch_smooth import jax_state, random_cells
from test_torch_slice import _tree, _numbers

torch.set_num_threads(1)

RTOL = 1e-9
ATOL_REL = 1e-12
VISC = dict(include_shear_deltaf=1, include_bulk_deltaf=1)
BINS = dict(tau_min=0.0, tau_max=12.0, tau_bins=30, r_min=0.0, r_max=12.0,
            r_bins=20)
SMALL_GRID = dict(n_pT=5, n_phi=4, n_y=5, n_eta=8)


def _port_state(jsp, jgrid, jdf, dtype=torch.float64):
    return (convert.species_from_state(jax_state(jsp), dtype=dtype),
            convert.grid_from_state(jax_state(jgrid), dtype=dtype),
            convert.deltaf_from_state(jax_state(jdf), dtype=dtype))


def run_both(cells, cfg_kw, n_species=6):
    """(port, reference) spacetime_distributions for one configuration."""
    dimension = cfg_kw["dimension"]
    jcfg = JConfig(operation=0, mode=1, **BINS, **cfg_kw)
    jgrid = j_native_grid(dimension=dimension, **SMALL_GRID)
    jsp = jtesting.synthetic_species(n_species=n_species)
    jdf = jtesting.synthetic_deltaf_data()
    jsurf = JSurface(**{k: jnp.asarray(v) for k, v in cells.items()})
    want = jdndx.spacetime_distributions(jsurf, jsp, jgrid, jdf, jcfg)

    species, grid, df_data = _port_state(jsp, jgrid, jdf)
    got = dndx.spacetime_distributions(
        convert.surface_from_state(cells), species, grid, df_data,
        Config(operation=0, mode=1, **BINS, **cfg_kw))
    return got, want


KEYS = ("dN_dy", "dN_dydeta", "dN_taudtaudy", "dN_twopirdrdy",
        "dN_twopitaurdtaudrdy", "raw_tau_hist", "raw_r_hist", "tau_mid",
        "r_mid", "eta")

CASES = {
    "2d_df1": dict(dimension=2, df_mode=1, **VISC),
    "2d_df2_regulate_outflow": dict(dimension=2, df_mode=2, regulate_deltaf=1,
                                    outflow=1, **VISC),
    "3d_df2": dict(dimension=3, df_mode=2, **VISC),
    "3d_df1_regulate_outflow_compat": dict(dimension=3, df_mode=1,
                                           regulate_deltaf=1, outflow=1,
                                           reference_compat_dndy=1, **VISC),
    "2d_df2_compat": dict(dimension=2, df_mode=2, reference_compat_dndy=1,
                          **VISC),
    # 70 cells: not a multiple of the 3 groups or of the 16-row cell block
    "2d_df1_ragged_groups": dict(dimension=2, df_mode=1, reduce_groups=3,
                                 outflow=1, **VISC),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_spacetime_distributions_match_jax(name):
    cfg_kw = CASES[name]
    n = 70 if "ragged" in name else 48
    got, want = run_both(random_cells(n, cfg_kw["dimension"], seed=len(name)),
                         dict(cfg_kw, cell_chunk=16))
    assert np.abs(want["dN_dy"]).min() > 0
    for k in KEYS:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k], w, rtol=RTOL,
                                   atol=ATOL_REL * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("dimension,df_mode", [(2, 1), (3, 2)])
def test_spacetime_distributions_baryon_diffusion_match_jax(dimension,
                                                            df_mode):
    cells = random_cells(40, dimension, seed=9, baryon=True)
    cfg_kw = dict(dimension=dimension, df_mode=df_mode, include_baryon=1,
                  include_baryondiff_deltaf=1, **VISC)
    got, want = run_both(cells, cfg_kw)
    for k in KEYS:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k], w, rtol=RTOL,
                                   atol=ATOL_REL * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("dimension,df_mode,compat", [(2, 2, 0), (3, 1, 1)])
def test_dndx_plain_matches_jax_cell_reduction(dimension, df_mode, compat):
    """dndx_plain against _cell_dNdy(_chunk_contribution(reduce=False)) on
    the same prepared cells (one chunk, no groups, no binning)."""
    n = 23
    cells = random_cells(n, dimension, seed=5)
    cfg_kw = dict(dimension=dimension, df_mode=df_mode, regulate_deltaf=1,
                  outflow=1, reference_compat_dndy=compat, **VISC)
    jcfg = JConfig(operation=0, mode=1, **cfg_kw)
    jgrid = j_native_grid(dimension=dimension, eta_mT_rescale=False,
                          **SMALL_GRID)
    jsp = jtesting.synthetic_species(n_species=5)
    jdf = jtesting.synthetic_deltaf_data()
    jsurf = JSurface(**{k: jnp.asarray(v) for k, v in cells.items()})
    c = j_prepare_cells(j_surface_columns(jsurf, jcfg), jcfg, jdf)
    block = _chunk_contribution(c, jnp.ones(n, bool), jsp, jgrid, jcfg,
                                reduce=False)
    want_pc, want_dy = (np.asarray(a) for a in
                        jdndx._cell_dNdy(block, jsp, jgrid, jcfg))

    cfg = Config(operation=0, mode=1, **cfg_kw)
    species, grid, df_data = _port_state(jsp, jgrid, jdf)
    packed = pack_cells(prepare_cells(
        surface_columns(convert.surface_from_state(cells), cfg), cfg,
        df_data), cfg)
    per_cell, dydeta = dndx.dndx_plain(
        packed, momentum_constants(species, grid, dimension),
        spectra_flags(cfg, grid), dndx.momentum_weights(grid, cfg),
        dndx.node_weights(grid, dimension), cell_chunk=7)
    assert per_cell.shape == (packed.shape[0], 5)
    assert torch.equal(per_cell[n:], torch.zeros_like(per_cell[n:]))
    np.testing.assert_allclose(per_cell[:n].numpy(), want_pc, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want_pc).max())
    np.testing.assert_allclose(dydeta.numpy(), want_dy, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want_dy).max())


@pytest.mark.parametrize("case", sorted(ptesting.DNDX_EDGES))
def test_dndx_plain_matches_jax_cell_reduction_on_edges(case):
    """dndx_plain on the dN/dX kernel's edge cases (testing.DNDX_EDGES, 75
    cells) against _cell_dNdy(_chunk_contribution(reduce=False)) on the
    same cells, grid and species built on the JAX side (f64, rtol 1e-9);
    pad rows are exactly 0."""
    import dataclasses
    spec = ptesting.edge_spec(ptesting.DNDX_EDGES, case, n_cells=75)
    cells, mom, flags, wM, wR = ptesting.dndx_edge_inputs(case, n_cells=75)
    per_cell, dydeta = dndx.dndx_plain(cells, mom, flags, wM, wR,
                                       cell_chunk=32)

    n = spec["rows"] or spec["n_cells"]
    raw = {k: v[:n] for k, v in ptesting.edge_surface_cells(spec).items()}
    jcfg = JConfig(operation=0, **ptesting.edge_config_kw(spec))
    jgrid = j_native_grid(dimension=spec["dimension"],
                          **ptesting.edge_grid_kw(spec))
    jsp = jtesting.synthetic_species(n_species=spec["n_species"])
    if spec["light_bosons"]:
        jsp = dataclasses.replace(jsp, mass=jnp.where(jsp.sign < 0, 0.02,
                                                      jsp.mass))
    np.testing.assert_array_equal(np.asarray(jsp.mass), mom.mass.numpy())
    jsurf = JSurface(**{k: jnp.asarray(v) for k, v in raw.items()})
    c = j_prepare_cells(j_surface_columns(jsurf, jcfg), jcfg,
                        jtesting.synthetic_deltaf_data())
    block = _chunk_contribution(c, jnp.ones(n, bool), jsp, jgrid, jcfg,
                                reduce=False)
    want_pc, want_dy = (np.asarray(a) for a in
                        jdndx._cell_dNdy(block, jsp, jgrid, jcfg))
    assert np.abs(want_pc).max() > 0
    assert torch.equal(per_cell[n:], torch.zeros_like(per_cell[n:]))
    np.testing.assert_allclose(per_cell[:n].numpy(), want_pc, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want_pc).max())
    np.testing.assert_allclose(dydeta.numpy(), want_dy, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want_dy).max())


@pytest.mark.parametrize("layout", ["one_bin", "one_bin_and_out_of_range"])
def test_histograms_with_empty_and_dominant_bins_match_jax(layout):
    """bin_plan + dndx_bin_plain against the JAX package's scatter-add on
    a surface whose cells crowd one tau bin and one r bin, so nearly every
    bin is empty and one (tau, r) bin holds every in-range cell; with
    cells outside the tau and r ranges in the second layout.  Compared
    through spacetime_distributions on both sides (f64)."""
    n = 40
    cells = random_cells(n, 2, seed=11)
    rng = np.random.default_rng(12)
    cells["tau"] = rng.uniform(5.25, 5.55, n)      # tau bin 13 (width 0.4)
    r, phi = rng.uniform(3.05, 3.5, n), rng.uniform(0, 2 * np.pi, n)
    cells["x"], cells["y"] = r * np.cos(phi), r * np.sin(phi)  # r bin 5
    if layout == "one_bin_and_out_of_range":
        cells["tau"][::3] = 15.0
        cells["x"][1::4], cells["y"][1::4] = 20.0, 0.0
    got, want = run_both(cells, dict(dimension=2, df_mode=1, **VISC))
    taur = np.asarray(want["dN_twopitaurdtaudrdy"])
    assert (np.count_nonzero(np.asarray(want["raw_tau_hist"]), axis=1)
            == 1).all()
    assert (np.count_nonzero(taur.reshape(taur.shape[0], -1), axis=1)
            == 1).all()
    for k in KEYS:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k], w, rtol=RTOL,
                                   atol=ATOL_REL * np.abs(w).max(), err_msg=k)


def test_bin_plan_entries_follow_the_jax_bin_rules():
    """Every cell lands in its floor bin, cells outside a range have no
    entry there, bins list their cells in index order, and the last bin
    holds every cell."""
    tau = torch.tensor([0.5, 11.9, 12.0, 3.3, -0.1, 3.3], dtype=torch.float64)
    x = torch.tensor([0.0, 5.0, 1.0, 13.0, 2.0, 0.1], dtype=torch.float64)
    y = torch.zeros(6, dtype=torch.float64)
    cfg = Config(tau_min=0.0, tau_max=12.0, tau_bins=4, r_min=0.0,
                 r_max=12.0, r_bins=3)
    plan = dndx.bin_plan(tau, x, y, cfg)
    assert plan.n_bins == 4 + 3 + 12 + 1
    entries = {}
    for k, cell in zip(plan.key.tolist(), plan.cell.tolist()):
        entries.setdefault(k, []).append(cell)
    # tau bins (width 3): 0.5 -> 0, 11.9 -> 3, 3.3 -> 1 twice
    assert entries[0] == [0] and entries[1] == [3, 5] and entries[3] == [1]
    # r bins (width 4): 0 -> 0, 5 -> 1, 1 -> 0, 2 -> 0, 0.1 -> 0; 13 out
    assert entries[4] == [0, 2, 4, 5] and entries[5] == [1]
    # (tau, r) needs both in range: cells 0, 1, 5
    assert entries[7 + 0 * 3 + 0] == [0] and entries[7 + 3 * 3 + 1] == [1]
    assert entries[7 + 1 * 3 + 0] == [5]
    assert entries[19] == list(range(6))
    counts = np.diff(plan.start.numpy())
    assert counts.sum() == plan.key.shape[0] == 4 + 5 + 3 + 6


@pytest.fixture(scope="module")
def op0_run_dirs(tmp_path_factory):
    return {dim: write_synthetic_run_dir(
        str(tmp_path_factory.mktemp(f"op0_{dim}d")), n_cells=40, n_species=11,
        dimension=dim, seed=4, params=dict(operation=0))
        for dim in (2, 3)}


@pytest.mark.parametrize("dimension,overrides", [
    (2, dict(df_mode=1)), (3, dict(df_mode=2, regulate_deltaf=1))])
def test_operation0_run_dir_matches_jax(op0_run_dirs, tmp_path, dimension,
                                        overrides):
    run_dir = op0_run_dirs[dimension]
    ref = JIS3D.from_run_dir(run_dir, overrides=overrides,
                             results_dir=str(tmp_path / "jax"))
    want = ref.run_particlization(write_files=True)
    port = IS3D.from_run_dir(run_dir, overrides=overrides, device="cpu",
                             results_dir=str(tmp_path / "torch"))
    got = port.run_particlization(write_files=True)
    assert got.spectra is None
    np.testing.assert_array_equal(got.mcids, want.mcids)
    np.testing.assert_allclose(got.dN_dX["dN_dy"], want.dN_dX["dN_dy"],
                               rtol=RTOL)

    jt, tt = _tree(tmp_path / "jax"), _tree(tmp_path / "torch")
    assert sorted(jt) == sorted(tt)
    assert len(jt) == 4 * len(want.mcids)
    assert all(rel.startswith("spacetime_distribution" + os.sep) for rel in jt)
    for rel in jt:
        va, wa = _numbers(jt[rel])
        vb, wb = _numbers(tt[rel])
        assert wa == wb == [] and va.shape == vb.shape, rel
        np.testing.assert_allclose(vb, va, rtol=1e-6,
                                   atol=1e-6 * np.abs(va).max(), err_msg=rel)


def test_cli_runs_operation0(op0_run_dirs):
    rc = cli.main([op0_run_dirs[2], "device=cpu", "operation=0",
                   "precision=f32", "df_mode=2"])
    assert rc == 0
    d = os.path.join(op0_run_dirs[2], "results", "spacetime_distribution")
    assert os.path.getsize(os.path.join(d, "dN_taudtaudy_211.dat")) > 0
    assert os.path.isfile(os.path.join(d, "dN_dydeta_211_48pt.dat"))


MESH_OP0 = [
    (dict(mode=2, df_mode=3), "slice 11"),
    (dict(mode=5, df_mode=4), "slice 11"),
    (dict(mode=2), "slice 11"), (dict(mode=3), "slice 11"),
    (dict(mode=5), "slice 11"),
]


@pytest.fixture(scope="module")
def op0_mesh_runs(tmp_path_factory):
    """Operation 0 on VAH and vorticity surfaces (48 cells, 2+1D) in one
    process and under IS3D(mesh=) on 2 gloo ranks (one spawn for every
    case; rank 0 writes the results tree)."""
    root = tmp_path_factory.mktemp("op0_mesh")
    dirs = {mode: write_synthetic_run_dir(str(root / f"mode{mode}"), 48, 7, 2,
                                          seed=mode, mode=mode,
                                          params=dict(operation=0))
            for mode in (2, 3, 5)}
    runs, one = [], []
    for i, (override, _) in enumerate(MESH_OP0):
        run_dir = dirs[override["mode"]]
        overrides = dict(override, operation=0)
        res = IS3D.from_run_dir(run_dir, overrides=overrides, device="cpu",
                                results_dir=os.path.join(run_dir, f"one{i}")
                                ).run_particlization()
        one.append(res)
        runs.append(dict(name=i, run_dir=run_dir, overrides=overrides,
                         results_dir=os.path.join(run_dir, f"mesh{i}")))
    ranks = ptesting.run_ranks(ptesting.mesh_api_rank, 2, str(root / "w"),
                               args=(runs,), timeout=240.0)
    return runs, one, ranks


@pytest.mark.parametrize("override,slice_name", MESH_OP0)
def test_operation0_unported_configurations_raise(op0_mesh_runs, override,
                                                  slice_name):
    """Operation 0 under a device mesh on these surfaces raised
    NotImplementedError naming ``slice_name`` until that slice (11a)
    ported mesh=: now every rank's distributions equal the one-process
    run's bit for bit and rank 0's results tree is the one-process tree
    byte for byte."""
    from test_torch_slice import _tree
    runs, one, ranks = op0_mesh_runs
    i = MESH_OP0.index((override, slice_name))
    want = one[i].dN_dX
    for r, res in enumerate(ranks):
        got = res[i]["dN_dX"]
        assert set(got) == set(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), (slice_name, r, k)
        assert res[i]["wrote"] == (r == 0)
    a = _tree(os.path.join(runs[i]["run_dir"], f"one{i}"))
    b = _tree(runs[i]["results_dir"])
    assert sorted(a) == sorted(b) and a
    for rel in a:
        with open(a[rel], "rb") as fa, open(b[rel], "rb") as fb:
            assert fa.read() == fb.read(), rel
