"""is3d_tpu_torch's host layer against is3d_tpu on identical inputs:
config parsing, PDG tables, surface readers and thermo averages, df
coefficients, momentum grids, the df table generator, particle densities,
splines and the LRF closures.

Host-side numpy code carried over from is3d_tpu must give equal arrays;
physics evaluated in torch (f64) must agree to 1e-12 relative (roundoff
of a different evaluation order, far inside the 1e-6 BASELINE.md bar).
"""

import dataclasses
import filecmp
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from is3d_tpu import testing as jtesting
from is3d_tpu.config import load_config as j_load_config
from is3d_tpu.io import pdg as j_pdg
from is3d_tpu.io import deltaf as j_deltaf
from is3d_tpu.io import surface as j_surface
from is3d_tpu.io.tables import native_momentum_grid as j_native_grid
from is3d_tpu.physics import lrf as j_lrf
from is3d_tpu.physics.splines import build_natural_cubic as j_spline
from is3d_tpu.tools import deltaf_generator as j_gen
from is3d_tpu.data import species_from_table as j_species_from_table

from is3d_tpu_torch import convert
from is3d_tpu_torch.api import IS3D
from is3d_tpu_torch.config import Config, load_config
from is3d_tpu_torch.io import pdg, deltaf, surface
from is3d_tpu_torch.io.tables import native_momentum_grid
from is3d_tpu_torch.physics import lrf
from is3d_tpu_torch.physics.splines import build_natural_cubic
from is3d_tpu_torch.tools import deltaf_generator
from is3d_tpu_torch.data import species_from_table
from is3d_tpu_torch.testing import write_synthetic_run_dir

from test_torch_smooth import jax_state

torch.set_num_threads(1)

T64 = torch.float64


def close(got, want, rtol=1e-12):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    return {d: write_synthetic_run_dir(str(tmp_path_factory.mktemp(f"rd{d}")),
                                       n_cells=40, n_species=24, dimension=d,
                                       seed=d)
            for d in (2, 3)}


CONFIG_TEXTS = {
    "empty": "",
    "reference_file": """
        operation = 1          # smooth spectra
        mode = 1
        hrg_eos = 2
        set_FO_temperature = 1
        T_switch = 0.155
        dimension = 3
        df_mode = 2
        include_baryon = 1
        include_bulk_deltaf = 1
        include_shear_deltaf = 1
        include_baryondiff_deltaf = 1
        regulate_deltaf = 1
        outflow = 1
        deta_min = 1.e-4
        group_particles = 1
        particle_diff_tolerance = 0.00
        do_resonance_decays = 1
        lightest_particle = 111
        oversample = 1
        min_num_hadrons = 1.0e+8
        sampler_seed = 7
        y_cut = 3.0
        pT_bins = 50
        reference_compat_dndy = 1
        reference_compat_feqmod_eta = 1
        unknown_key = 5
    """,
    "port_knobs": "precision = f32\ncell_chunk = 4096\ncell_slab = 1000\n"
                  "reduce_groups = 4\ndf_mode = 1.0e+0\n"
                  "sampler_pack = f16\nsampler_cell_chunk = -1\n"
                  "sampler_gather_tetrad = 0\nsampler_alias = 1\n",
}


@pytest.mark.parametrize("name", sorted(CONFIG_TEXTS))
def test_config_parsing_matches_jax(name):
    text = CONFIG_TEXTS[name]
    overrides = {"dimension": "2"} if name == "port_knobs" else None
    got = load_config(text=text, overrides=overrides)
    want = j_load_config(text=text, overrides=overrides)
    names = [f.name for f in dataclasses.fields(Config)]
    for n in names:
        assert getattr(got, n) == getattr(want, n), n
    # every reference key of is3d_tpu's Config is kept, and the VAH and
    # sampler keys; only TPU knobs go (the feqmod partition keys and
    # mesh_axis stay, accepted and inert)
    dropped = {f.name for f in dataclasses.fields(want)} - set(names)
    assert dropped == {"remat_scan"}


def test_pdg_tables_and_species_match_jax(run_dirs):
    pdg_dir = os.path.join(run_dirs[3], "PDG")
    got = pdg.read_resonances(pdg_dir, 1)
    want = j_pdg.read_resonances(pdg_dir, 1)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name.startswith("decays_"):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        elif b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    chosen = os.path.join(pdg_dir, "chosen_particles_urqmd_v3.3+.dat")
    mcids = pdg.load_chosen_mcids(chosen)
    assert len(mcids) == 24
    idx = pdg.chosen_indices(got, mcids)
    np.testing.assert_array_equal(idx, j_pdg.chosen_indices(want, mcids))
    sp = species_from_table(got, idx)
    jsp = j_species_from_table(want, idx)
    for f in dataclasses.fields(jsp):
        np.testing.assert_array_equal(getattr(sp, f.name).numpy(),
                                      np.asarray(getattr(jsp, f.name)))


@pytest.mark.parametrize("dimension", [2, 3])
def test_mode1_surface_and_averages_match_jax(run_dirs, dimension):
    path = os.path.join(run_dirs[dimension], "input", "surface.dat")
    got, avg = surface.read_surface(path, mode=1, dimension=dimension)
    want, javg = j_surface.read_surface(path, mode=1, dimension=dimension)
    assert dataclasses.astuple(avg) == dataclasses.astuple(javg)
    for f in dataclasses.fields(want):
        b = getattr(want, f.name)
        a = getattr(got, f.name, None)
        if b is None:
            assert a is None, f.name
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f.name)


# (mode, include_baryon, include_baryondiff) -> column count, exercising
# every ported VH reader with its optional baryon blocks
READERS = [(0, 1, 1), (1, 1, 1), (4, 0, 0), (6, 0, 0), (7, 0, 0)]


@pytest.mark.parametrize("mode,baryon,diff", READERS)
def test_vh_surface_readers_match_jax(tmp_path, mode, baryon, diff):
    ncols = j_surface.expected_columns(mode, baryon, diff)
    rng = np.random.default_rng(mode)
    m = rng.uniform(0.1, 0.4, (17, ncols))      # |v| < 1 for mode 7
    path = str(tmp_path / "surface.dat")
    np.savetxt(path, m, fmt="%.17e")
    got, avg = surface.read_surface(path, mode=mode, dimension=3,
                                    include_baryon=bool(baryon),
                                    include_baryondiff=bool(diff))
    want, javg = j_surface.read_surface(path, mode=mode, dimension=3,
                                        include_baryon=bool(baryon),
                                        include_baryondiff=bool(diff))
    assert dataclasses.astuple(avg) == dataclasses.astuple(javg)
    for f in dataclasses.fields(want):
        b = getattr(want, f.name)
        a = getattr(got, f.name, None)
        if b is None:
            assert a is None, f.name
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f.name)


def test_vah_modes_raise_not_implemented(tmp_path):
    """The VAH readers and every operation on VAH surfaces are ported, the
    sampler (operation 2) last, and operation 2 under mesh= (which raised
    NotImplementedError until pod mode was ported): on 2 gloo ranks each
    samples its slice of the events, and the slices concatenate to the
    one-process list byte for byte."""
    from is3d_tpu_torch import testing
    for mode in (2, 3):
        for op in (0, 1, 2):
            IS3D(Config(operation=op, mode=mode), data_dir=str(tmp_path),
                 device="cpu")
    runs, one = [], {}
    for mode in (2, 3):
        d = write_synthetic_run_dir(
            str(tmp_path / f"mode{mode}"), 40, 7, 2, seed=mode, mode=mode,
            params=dict(operation=2, oversample=1, min_num_hadrons=400,
                        sampler_seed=3))
        runs.append(dict(name=mode, run_dir=d, overrides={},
                         results_dir=str(tmp_path / f"mesh{mode}")))
        one[mode] = IS3D.from_run_dir(d, device="cpu").run_particlization(
            write_files=False).events
    ranks = testing.run_ranks(testing.mesh_api_rank, 2,
                              str(tmp_path / "w"), args=(runs, False),
                              timeout=240.0)
    for mode in (2, 3):
        got = [e for res in ranks for e in res[mode]["events"]]
        assert len(one[mode]) >= 2
        assert testing.same_events(got, one[mode]), mode
    with pytest.raises(TypeError, match="CellMesh"):
        IS3D(Config(operation=2, mode=2), device="cpu", mesh=object())


@pytest.mark.parametrize("df_mode,include_baryon",
                         [(1, 0), (2, 0), (3, 0), (4, 0), (1, 1), (2, 1)])
def test_df_coefficients_match_jax(df_mode, include_baryon):
    rng = np.random.default_rng(df_mode + 10 * include_baryon)
    n = 64
    q = dict(T=rng.uniform(0.13, 0.17, n), muB=rng.uniform(0.0, 0.5, n),
             E=rng.uniform(0.25, 0.4, n), P=rng.uniform(0.04, 0.08, n),
             bulkPi=rng.normal(0, 0.003, n))
    jdf = jtesting.synthetic_deltaf_data()
    want = j_deltaf.evaluate_df_coefficients(
        jdf, df_mode, bool(include_baryon),
        *(jnp.asarray(q[k]) for k in ("T", "muB", "E", "P", "bulkPi")))
    got = deltaf.evaluate_df_coefficients(
        convert.deltaf_from_state(jax_state(jdf)), df_mode,
        bool(include_baryon),
        *(torch.tensor(q[k]) for k in ("T", "muB", "E", "P", "bulkPi")))
    for f in dataclasses.fields(want):
        close(getattr(got, f.name), getattr(want, f.name))


@pytest.mark.parametrize("df_mode", [1, 2])
def test_particle_densities_match_jax(run_dirs, df_mode):
    rd = run_dirs[2]
    _, avg = surface.read_surface(os.path.join(rd, "input", "surface.dat"),
                                  mode=1, dimension=2)
    coeff = os.path.join(rd, "deltaf_coefficients")
    table = pdg.read_resonances(os.path.join(rd, "PDG"), 1)
    jtable = j_pdg.read_resonances(os.path.join(rd, "PDG"), 1)
    data = deltaf.build_deltaf_data(coeff, 1, table, avg.temperature)
    jdata = j_deltaf.build_deltaf_data(coeff, 1, jtable, avg.temperature)
    # the Jonah splines are built on the host from the same quadrature
    for name in ("lambda2_spline", "z_spline"):
        for k in "xybcd":
            close(getattr(getattr(data, name), k),
                  getattr(getattr(jdata, name), k))
    deltaf.compute_particle_densities(table, df_mode, avg, data, False)
    j_deltaf.compute_particle_densities(jtable, df_mode, avg, jdata, False)
    for k in ("equilibrium_density", "bulk_density", "diff_density"):
        close(getattr(table, k), getattr(jtable, k))


@pytest.mark.parametrize("dimension", [2, 3])
def test_native_momentum_grid_matches_jax(dimension):
    got = native_momentum_grid(dimension)
    want = j_native_grid(dimension)
    assert got.eta_mT_rescale == want.eta_mT_rescale == (dimension == 2)
    for f in dataclasses.fields(want):
        if f.name != "eta_mT_rescale":
            np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                          np.asarray(getattr(want, f.name)))


def test_deltaf_generator_matches_jax(run_dirs, tmp_path):
    table = pdg.read_resonances(os.path.join(run_dirs[3], "PDG"), 1)
    kw = dict(nT=11, nmuB=3, n_laguerre=32)
    T, muB, got = deltaf_generator.compute_coefficient_tables(table, **kw)
    jT, jmuB, want = j_gen.compute_coefficient_tables(table, **kw)
    np.testing.assert_array_equal(T, jT)
    np.testing.assert_array_equal(muB, jmuB)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    deltaf_generator.write_tables(T, muB, got, str(tmp_path / "a"))
    j_gen.write_tables(jT, jmuB, want, str(tmp_path / "b"))
    names = sorted(os.listdir(tmp_path / "b"))
    assert sorted(os.listdir(tmp_path / "a")) == names
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "a", tmp_path / "b",
                                           names, shallow=False)
    assert not mismatch and not errors


def test_splines_and_lrf_match_jax():
    rng = np.random.default_rng(5)
    x = np.sort(rng.uniform(0.05, 0.3, 40))
    y = np.sin(30 * x) + x ** 3
    xq = rng.uniform(0.0, 0.35, 200)             # includes extrapolation
    want = j_spline(x, y)(jnp.asarray(xq))
    got = build_natural_cubic(x, y)(torch.tensor(xq))
    close(got, want)

    n = 50
    u = {k: rng.uniform(-0.6, 0.6, n) for k in ("ux", "uy", "un")}
    tau = rng.uniform(1, 9, n)
    pi = {k: rng.normal(0, 0.01, n)
          for k in ("pixx", "pixy", "pixn", "piyy", "piyn")}
    V = {k: rng.normal(0, 0.01, n) for k in ("Vx", "Vy", "Vn")}
    t = lambda a: torch.tensor(a)
    ut = lrf.u_tau(t(u["ux"]), t(u["uy"]), t(u["un"]), t(tau))
    jut = j_lrf.u_tau(u["ux"], u["uy"], u["un"], tau)
    close(ut, jut)
    args = [pi[k] for k in ("pixx", "pixy", "pixn", "piyy", "piyn")]
    got = lrf.reconstruct_pimunu(*map(t, args), ut, t(u["ux"]), t(u["uy"]),
                                 t(u["un"]), t(tau))
    want = j_lrf.reconstruct_pimunu(*args, jut, u["ux"], u["uy"], u["un"],
                                    tau)
    for a, b in zip(got, want):
        close(a, b)
    close(lrf.complete_Vmu(t(V["Vx"]), t(V["Vy"]), t(V["Vn"]), ut,
                           t(u["ux"]), t(u["uy"]), t(u["un"]), t(tau)),
          j_lrf.complete_Vmu(V["Vx"], V["Vy"], V["Vn"], jut, u["ux"],
                             u["uy"], u["un"], tau))


@pytest.mark.parametrize("dimension", [2, 3])
def test_mean_pT_matches_jax(dimension):
    """observables.mean_pT (S, Y) on the same numpy spectra, with one
    species all zero (a zero dN/dy, mapped to a mean of 0), at rtol 1e-12
    in f64."""
    from is3d_tpu import observables as j_obs
    from is3d_tpu_torch import observables
    kw = dict(n_pT=8, n_phi=6, n_y=5, n_eta=4)
    grid = native_momentum_grid(dimension, **kw)
    jgrid = j_native_grid(dimension, **kw)
    n_y = 5 if dimension == 3 else 1
    spectra = np.random.default_rng(7).random((4, 8, 6, n_y))
    spectra[2] = 0.0
    got = observables.mean_pT(torch.as_tensor(spectra), grid)
    want = np.asarray(j_obs.mean_pT(spectra, jgrid))
    assert got.shape == (4, n_y) and (got[2] == 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
