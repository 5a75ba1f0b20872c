"""is3d_tpu_torch's thermal-vorticity spin polarization (surface mode 5,
the plain torch version, CPU) against is3d_tpu.kernels.polzn on
identical inputs: every returned array on each path, set_FO_temperature
on and off, a massless species (whose sums are inf or NaN in the same
places), the writer byte for byte, and whole mode-5 CLI runs.

Inputs are made with numpy from a seed and carried to the port through
is3d_tpu_torch.convert.  Tolerance: f64 on both sides, rtol=1e-9 with
atol=1e-12 * max|ref| per array over its finite values; the written
spectra files at 1e-6 relative (%.8e rounding).
"""

import dataclasses
import filecmp
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from is3d_tpu import testing as jtesting
from is3d_tpu import writers as j_writers
from is3d_tpu.api import IS3D as JIS3D
from is3d_tpu.config import Config as JConfig
from is3d_tpu.io.surface import Surface as JSurface, ThermoAverages as JAvg
from is3d_tpu.io.tables import native_momentum_grid as j_native_grid
from is3d_tpu.kernels import polzn as jpolzn

from is3d_tpu_torch import cli, convert, testing, writers
from is3d_tpu_torch.api import IS3D
from is3d_tpu_torch.config import Config
from is3d_tpu_torch.kernels import polzn
from is3d_tpu_torch.native import build

from test_torch_smooth import jax_state
from test_torch_slice import _tree, _numbers

torch.set_num_threads(1)

RTOL = 1e-9
ATOL_REL = 1e-12
PATHS = {"3d": (3, False), "2d_fixed": (2, False), "2d_remap": (2, True)}


def assert_same(got, want):
    """Equal non-finite positions (NaN, +inf, -inf); the finite values at
    the f64 bar."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    for f in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(f(got), f(want))
    fin = np.isfinite(want)
    assert fin.any() and np.abs(want[fin]).max() > 0
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL,
                               atol=ATOL_REL * np.abs(want[fin]).max())


def run_both(path, seed=1, n=43, massless=False, plasma_T=0.152):
    dimension, remap = PATHS[path]
    cells = jtesting.synthetic_surface_cells(n, dimension, seed)
    cells.update(testing.synthetic_vorticity(n, seed))
    cfg_kw = dict(mode=5, dimension=dimension, cell_chunk=16)
    jgrid = j_native_grid(dimension=dimension, n_pT=5, n_phi=4, n_y=5,
                          n_eta=10, eta_mT_rescale=remap)
    jsp = jtesting.synthetic_species(n_species=9)
    if massless:
        jsp = jsp.replace(mass=jsp.mass.at[2].set(0.0))
    plasma = JAvg(plasma_T, 0.3, 0.05, 0.0, 0.0)
    want = jpolzn.spin_polarization(
        JSurface(**{k: jnp.asarray(v) for k, v in cells.items()}), jsp,
        jgrid, JConfig(**cfg_kw), plasma)
    got = polzn.spin_polarization(
        convert.surface_from_state(cells),
        convert.species_from_state(jax_state(jsp)),
        convert.grid_from_state(jax_state(jgrid)), Config(**cfg_kw),
        convert.averages_from_state(dataclasses.asdict(plasma)))
    return got, want


@pytest.mark.parametrize("massless", [False, True])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_spin_polarization_matches_jax(path, massless):
    got, want = run_both(path, massless=massless)
    assert sorted(got) == sorted(want)
    for k in want:
        assert_same(got[k].numpy(), want[k])
    bad = ~np.isfinite(np.asarray(want["St"]))
    assert bad.any() == massless
    if massless:
        # only the massless species; its Snorm stays finite
        assert bad[2].all() and not bad[[0, 1, 3]].any()
        assert np.isfinite(np.asarray(want["Snorm"])).all()


@pytest.mark.parametrize("set_T", [0, 1])
def test_polarization_honours_set_fo_temperature(tmp_path, set_T):
    """Through the run: the plasma's temperature is T_switch with
    set_FO_temperature = 1, the surface average without; both packages
    give the same sums."""
    run_dir = testing.write_synthetic_run_dir(str(tmp_path / "run"), 40, 7,
                                              2, seed=4, mode=5)
    overrides = dict(set_FO_temperature=set_T, T_switch=0.140)
    ref = JIS3D.from_run_dir(run_dir, overrides=overrides,
                             results_dir=str(tmp_path / "jax"))
    want = ref.run_particlization(write_files=False).polarization
    port = IS3D.from_run_dir(run_dir, overrides=overrides, device="cpu")
    got = port.run_particlization(write_files=False).polarization
    assert port.plasma().temperature == (
        0.140 if set_T else port.averages.temperature)
    for k in want:
        assert_same(got[k], want[k])


def test_polarization_writer_is_byte_identical(tmp_path):
    """write_polarization writes the same bytes as is3d_tpu's on the same
    f64 sums (a zero Snorm point included)."""
    got, want = run_both("2d_remap")
    sums = {k: want[k] for k in ("St", "Sx", "Sy", "Sn", "Snorm")}
    sums["Snorm"] = np.asarray(sums["Snorm"]).copy()
    sums["Snorm"][0, 0, 0, 0] = 0.0
    grid = j_native_grid(dimension=2, n_pT=5, n_phi=4, n_eta=10)
    os.makedirs(tmp_path / "jax")
    os.makedirs(tmp_path / "torch")
    j_writers.write_polarization(*sums.values(), grid, 2,
                                 str(tmp_path / "jax"))
    writers.write_polarization(
        *(np.asarray(v) for v in sums.values()),
        convert.grid_from_state(jax_state(grid)), 2, str(tmp_path / "torch"))
    for name in ("St", "Sx", "Sy", "Sn"):
        assert filecmp.cmp(tmp_path / "jax" / f"{name}.dat",
                           tmp_path / "torch" / f"{name}.dat", shallow=False)


def test_polzn_cpu_tensors_take_plain_path_and_never_load_kernel():
    counts = (polzn.LAUNCHES, polzn.REMAP_LAUNCHES)
    for path in PATHS:
        got, _ = run_both(path, n=20)
        assert all(torch.isfinite(v).all() for v in got.values())
    assert counts == (polzn.LAUNCHES, polzn.REMAP_LAUNCHES)
    assert "polzn" not in build._cuda_libs


# ------------------------------------------------------ end to end

def test_mode5_cli_results_match_jax(tmp_path):
    """A mode-5 2+1D run directory through the port's CLI (device=cpu) and
    through is3d_tpu: S*.dat and every spectra file, file by file; the
    polarization in memory at the f64 bar."""
    run_dir = testing.write_synthetic_run_dir(str(tmp_path / "run"), 48, 11,
                                              2, seed=7, mode=5)
    ref = JIS3D.from_run_dir(run_dir, results_dir=str(tmp_path / "jax"))
    want = ref.run_particlization(write_files=True)
    port = IS3D.from_run_dir(run_dir, device="cpu")
    got = port.run_particlization(write_files=False)
    for k in want.polarization:
        assert_same(got.polarization[k], want.polarization[k])
    assert cli.main([run_dir, "device=cpu"]) == 0
    jt, tt = _tree(tmp_path / "jax"), _tree(os.path.join(run_dir, "results"))
    assert sorted(jt) == sorted(tt)
    assert {"St.dat", "Sx.dat", "Sy.dat", "Sn.dat"} <= set(jt)
    assert len(jt) == 4 + 1 + 5 * 11
    for rel in jt:
        va, wa = _numbers(jt[rel])
        vb, wb = _numbers(tt[rel])
        assert wa == wb and va.shape == vb.shape, rel
        np.testing.assert_allclose(vb, va, rtol=1e-6,
                                   atol=1e-6 * np.abs(va).max(), err_msg=rel)
    assert not os.path.exists(os.path.join(
        run_dir, "average_thermodynamic_quantities.dat"))


def test_mode5_rerun_with_fewer_species_leaves_no_stale_files(tmp_path):
    """A second mode-5 run into the same results directory with fewer
    chosen species: its S*.dat hold only its own species (the writers
    append, so a stale block would double them) and equal a fresh
    directory's files."""
    run_dir = testing.write_synthetic_run_dir(str(tmp_path / "run"), 24, 11,
                                              2, seed=8, mode=5)
    assert cli.main([run_dir, "device=cpu"]) == 0
    chosen = os.path.join(run_dir, "PDG", "chosen_particles_urqmd_v3.3+.dat")
    with open(chosen) as f:
        mcids = f.read().split()
    with open(chosen, "w") as f:
        f.write("".join(f"{m}\n" for m in mcids[:4]))
    assert cli.main([run_dir, "device=cpu"]) == 0
    fresh = str(tmp_path / "fresh")
    port = IS3D.from_run_dir(run_dir, device="cpu", results_dir=fresh)
    n_species = len(port.run_particlization(write_files=True).mcids)
    assert n_species < 11
    for name in ("St", "Sx", "Sy", "Sn"):
        a = os.path.join(run_dir, "results", f"{name}.dat")
        assert np.loadtxt(a).shape[0] == n_species * 32 * 24
        assert filecmp.cmp(a, os.path.join(fresh, f"{name}.dat"),
                           shallow=False)
