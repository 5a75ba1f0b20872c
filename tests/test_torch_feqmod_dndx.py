"""is3d_tpu_torch's dN/dX with modified equilibrium df (df 3-4, operation 0;
the plain torch version, CPU) against is3d_tpu.kernels.dndx on identical
inputs, and the whole df 3-4 slice end to end: operation 1 (with and
without the feed-down) and operation 0 through the CLI / IS3D on synthetic
run directories, whose results trees must match is3d_tpu's.

Inputs and tolerances as test_torch_feqmod.py (rtol=1e-9 with atol=1e-12 *
max in f64) and, for the results trees, test_torch_slice.py /
test_torch_dndx.py (the integrated spectra files byte-equal, the others
value for value at the BASELINE.md bar of 1e-6 relative).  The run
directories' bulk pressure is x 30, so a third of their cells break down
under the delta-f generator's tables.
"""

import os
import shutil

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from is3d_tpu import cli as jcli
from is3d_tpu import testing as jtesting
from is3d_tpu.api import IS3D as JIS3D
from is3d_tpu.config import Config as JConfig
from is3d_tpu.io.surface import Surface as JSurface
from is3d_tpu.io.tables import native_momentum_grid as j_native_grid
from is3d_tpu.kernels import dndx as jdndx

from is3d_tpu_torch import cli, convert
from is3d_tpu_torch.api import IS3D
from is3d_tpu_torch.config import Config
from is3d_tpu_torch.kernels import dndx
from is3d_tpu_torch.testing import write_synthetic_run_dir

from test_torch_smooth import jax_state
from test_torch_slice import _tree, _numbers, BYTE_EQUAL
from test_torch_feqmod import feqmod_cells, MIXED, MOST

torch.set_num_threads(1)

RTOL = 1e-9
ATOL_REL = 1e-12
VISC = dict(include_shear_deltaf=1, include_bulk_deltaf=1)
BINS = dict(tau_min=0.0, tau_max=12.0, tau_bins=30, r_min=0.0, r_max=12.0,
            r_bins=20)
SMALL_GRID = dict(n_pT=5, n_phi=4, n_y=5, n_eta=8)


def run_both(cells, cfg_kw, n_species=7, jcfg_kw=None):
    """(port, reference) spacetime_distributions for one configuration."""
    dimension = cfg_kw["dimension"]
    jcfg = JConfig(operation=0, mode=1, **BINS, **cfg_kw, **(jcfg_kw or {}))
    jgrid = j_native_grid(dimension=dimension, **SMALL_GRID)
    jsp = jtesting.synthetic_species(n_species=n_species)
    jdf = jtesting.synthetic_deltaf_data()
    jsurf = JSurface(**{k: jnp.asarray(v) for k, v in cells.items()})
    want = jdndx.spacetime_distributions(jsurf, jsp, jgrid, jdf, jcfg)
    got = dndx.spacetime_distributions(
        convert.surface_from_state(cells),
        convert.species_from_state(jax_state(jsp)),
        convert.grid_from_state(jax_state(jgrid)),
        convert.deltaf_from_state(jax_state(jdf)),
        Config(operation=0, mode=1, **BINS, **cfg_kw))
    return got, want


def assert_dndx_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert np.isfinite(w).all(), k
        np.testing.assert_allclose(got[k], w, rtol=RTOL,
                                   atol=ATOL_REL * np.abs(w).max(),
                                   err_msg=k)
    assert np.abs(np.asarray(want["dN_dy"])).max() > 0


CASES = {
    "3d_df3_mixed": (3, 3, MIXED, {}), "3d_df4_mixed": (3, 4, MIXED, {}),
    "2d_df3_mixed": (2, 3, MIXED, {}), "2d_df4_mixed": (2, 4, MIXED, {}),
    "2d_df3_most": (2, 3, MOST, {}),
    "2d_df4_compat": (2, 4, (0.01, 3.0),
                      dict(reference_compat_feqmod_eta=1)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_feqmod_spacetime_distributions_match_jax(name):
    dimension, df_mode, scales, kw = CASES[name]
    cells = feqmod_cells(80, dimension, seed=len(name), scales=scales)
    got, want = run_both(cells, dict(dimension=dimension, df_mode=df_mode,
                                     regulate_deltaf=1, outflow=1,
                                     cell_chunk=32, **VISC, **kw))
    assert_dndx_close(got, want)


def test_feqmod_dndx_routed_jax_matches_port():
    """JAX's routed dN/dX (per-chunk branches on sorted cells) gives the
    answer the port is held to."""
    cells = feqmod_cells(96, 2, seed=43, scales=MIXED)
    got, want = run_both(cells, dict(dimension=2, df_mode=3, outflow=1,
                                     cell_chunk=8, **VISC),
                         jcfg_kw=dict(feqmod_partition_min_cells=1))
    assert_dndx_close(got, want)


# ------------------------------------------------------- the whole slice

@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    return {dim: write_synthetic_run_dir(
        str(tmp_path_factory.mktemp(f"feqmod_{dim}d")), n_cells=48,
        n_species=11, dimension=dim, seed=6, scale_bulk=30.0)
        for dim in (2, 3)}


def _compare_trees(jt, tt, byte_equal=()):
    assert sorted(jt) == sorted(tt)
    for rel in jt:
        with open(jt[rel], "rb") as a, open(tt[rel], "rb") as b:
            same = a.read() == b.read()
        if os.path.basename(rel).startswith(byte_equal):
            assert same, f"{rel} is not byte-equal"
            continue
        va, wa = _numbers(jt[rel])
        vb, wb = _numbers(tt[rel])
        assert wa == wb and va.shape == vb.shape, rel
        np.testing.assert_allclose(vb, va, rtol=1e-6,
                                   atol=1e-6 * np.abs(va).max(), err_msg=rel)


RUNS = {
    "op1_3d_df3": (3, dict(operation=1, df_mode=3, regulate_deltaf=1)),
    "op1_2d_df4": (2, dict(operation=1, df_mode=4)),
    "op0_2d_df3": (2, dict(operation=0, df_mode=3, regulate_deltaf=1)),
    "op0_3d_df4": (3, dict(operation=0, df_mode=4)),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_feqmod_run_dir_matches_jax(run_dirs, tmp_path, name):
    dimension, overrides = RUNS[name]
    ref = JIS3D.from_run_dir(run_dirs[dimension], overrides=overrides,
                             results_dir=str(tmp_path / "jax"))
    want = ref.run_particlization(write_files=True)
    port = IS3D.from_run_dir(run_dirs[dimension], overrides=overrides,
                             device="cpu", results_dir=str(tmp_path / "torch"))
    got = port.run_particlization(write_files=True)
    np.testing.assert_array_equal(got.mcids, want.mcids)
    if overrides["operation"] == 1:
        np.testing.assert_allclose(got.spectra, want.spectra, rtol=RTOL,
                                   atol=ATOL_REL * np.abs(want.spectra).max())
        byte_equal = BYTE_EQUAL
    else:
        assert got.spectra is None
        np.testing.assert_allclose(got.dN_dX["dN_dy"], want.dN_dX["dN_dy"],
                                   rtol=RTOL)
        byte_equal = ()
    _compare_trees(_tree(tmp_path / "jax"), _tree(tmp_path / "torch"),
                   byte_equal)


def test_feqmod_cli_with_decays_matches_jax_cli(tmp_path):
    """df 3 with do_resonance_decays = 1: the CLI on a decaying run
    directory (2+1D, native grid) against the JAX package's CLI, the decay
    files at rtol 1e-9 plus one unit in the last printed digit (as
    test_torch_decays.py)."""
    rd = write_synthetic_run_dir(str(tmp_path / "rd"), 48, 24, 2, seed=3,
                                 decays=True, scale_bulk=30.0,
                                 params=dict(df_mode=3, regulate_deltaf=1))
    assert jcli.main([rd]) == 0
    os.rename(os.path.join(rd, "results"), os.path.join(rd, "results_jax"))
    assert cli.main([rd, "device=cpu"]) == 0
    files = sorted(os.listdir(os.path.join(rd, "results_jax")))
    assert files == sorted(os.listdir(os.path.join(rd, "results")))
    decay_files = [f for f in files if f.endswith("_resonance_decays.dat")]
    assert len(decay_files) == 2 + 24
    for f in decay_files:
        a, b = (open(os.path.join(rd, d, f)).read().split()
                for d in ("results_jax", "results"))
        words = lambda toks: [t for t in toks if not t[-1].isdigit()]
        assert words(a) == words(b), f
        va = np.asarray([float(t) for t in a if t[-1].isdigit()])
        vb = np.asarray([float(t) for t in b if t[-1].isdigit()])
        assert va.shape == vb.shape and (va > 0).any(), f
        digit = 1e-8 * 10.0 ** np.floor(np.log10(np.abs(va) + 1e-300))
        assert (np.abs(vb - va) <= 1e-9 * np.abs(va) + digit).all(), f


@pytest.mark.parametrize("operation", [0, 1])
def test_cli_runs_feqmod_in_float32(run_dirs, tmp_path, operation):
    rd = str(tmp_path / "rd")
    shutil.copytree(run_dirs[2], rd)
    rc = cli.main([rd, "device=cpu", "precision=f32", "df_mode=4",
                   f"operation={operation}"])
    assert rc == 0
    name = (os.path.join("spacetime_distribution", "dN_taudtaudy_211.dat")
            if operation == 0 else "dN_pTdpTdphidy_211.dat")
    v = np.loadtxt(os.path.join(rd, "results", name), skiprows=operation)
    assert np.isfinite(v).all() and (v[:, -1] > 0).any()
