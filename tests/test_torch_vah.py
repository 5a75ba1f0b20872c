"""is3d_tpu_torch's anisotropic-hydro (VAH, surface modes 2-3) half against
is3d_tpu's on identical inputs: the conformal fit, the mode-2 and mode-3
readers, the vah coefficient tables, the residual-df gate, the spectra
(the plain torch version, CPU) on every path, and whole CLI runs.  The
averages-file rule (written for modes 0, 1, 4, 6, 7 only) is held here
too.

Inputs are made with numpy from a seed (is3d_tpu_torch.testing's VAH
cells and run directories) and carried to the port through
is3d_tpu_torch.convert.  Tolerance: f64 on both sides, rtol=1e-9 with
atol=1e-12 * max|ref| (test_torch_smooth.py's bar); the written files
at 1e-6 relative, as test_torch_slice.py explains (%.8e rounding).
"""

import dataclasses
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from is3d_tpu import testing as jtesting
from is3d_tpu.api import IS3D as JIS3D
from is3d_tpu.config import Config as JConfig
from is3d_tpu.io import deltaf as j_deltaf
from is3d_tpu.io import surface as j_surface
from is3d_tpu.io.surface import Surface as JSurface
from is3d_tpu.io.tables import native_momentum_grid as j_native_grid
from is3d_tpu.kernels import vah as jvah
from is3d_tpu.physics import anisotropic as j_aniso

from is3d_tpu_torch import cli, convert, testing
from is3d_tpu_torch.api import IS3D, check_supported
from is3d_tpu_torch.config import Config
from is3d_tpu_torch.io import deltaf, surface
from is3d_tpu_torch.kernels import vah
from is3d_tpu_torch.physics import anisotropic

from test_torch_smooth import jax_state
from test_torch_slice import _tree, _numbers

torch.set_num_threads(1)

RTOL = 1e-9
ATOL_REL = 1e-12
SMALL_GRID = dict(n_pT=5, n_phi=4, n_y=5, n_eta=10)


def assert_close(got, want, rtol=RTOL, atol_rel=ATOL_REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max())


# ----------------------------------------------------------- the fit

def test_aL_fit_and_R200_match_jax():
    ratio = np.linspace(0.02, 2.95, 401)
    aL = anisotropic.aL_fit(ratio)
    np.testing.assert_allclose(aL, j_aniso.aL_fit(ratio), rtol=RTOL)
    # R200 around and across its Taylor window |x| < 0.01
    grid = np.concatenate([aL, np.linspace(0.99, 1.01, 41)])
    np.testing.assert_allclose(anisotropic.R200(grid), j_aniso.R200(grid),
                               rtol=RTOL)
    for f in (anisotropic.R200, j_aniso.R200):
        with pytest.raises(ValueError, match="out of bounds"):
            f(np.array([1.0, np.inf]))


# ----------------------------------------------------------- readers

def _vah_matrix(mode, baryon, diff, seed=5, n=41):
    """A mode-2/3 surface file's matrix (testing's VAH cells, 3+1D), with
    mode 3's optional baryon blocks appended as random columns."""
    cells = testing.synthetic_vah_cells(n, 3, seed)
    m = testing._surface_rows(cells, mode)
    rng = np.random.default_rng(seed)
    extra = (2 if baryon else 0) + (5 if diff else 0)
    return np.concatenate([m, rng.uniform(0.01, 0.1, (n, extra))], axis=1)


VAH_READERS = [(2, 0, 0), (3, 0, 0), (3, 1, 0), (3, 0, 1), (3, 1, 1)]


@pytest.mark.parametrize("mode,baryon,diff", VAH_READERS)
def test_vah_surface_readers_match_jax(tmp_path, mode, baryon, diff):
    """Every Surface column (a_L and Lambda from the conformal fit in mode
    2, the baryon blocks of mode 3) and the averages."""
    m = _vah_matrix(mode, baryon, diff)
    assert m.shape[1] == surface.expected_columns(mode, baryon, diff) \
        == j_surface.expected_columns(mode, baryon, diff)
    path = str(tmp_path / "surface.dat")
    np.savetxt(path, m, fmt="%.17e")
    kw = dict(mode=mode, dimension=3, include_baryon=bool(baryon),
              include_baryondiff=bool(diff))
    got, avg = surface.read_surface(path, **kw)
    want, javg = j_surface.read_surface(path, **kw)
    np.testing.assert_allclose(dataclasses.astuple(avg),
                               dataclasses.astuple(javg), rtol=RTOL)
    for f in dataclasses.fields(want):
        b = getattr(want, f.name)
        a = getattr(got, f.name, None)
        if b is None:
            assert a is None, f.name
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=0.0, err_msg=f.name)
    assert (got.aL < 1).any() and (got.aL > 1).any()


def test_vah_reader_rejects_pl_over_p_at_3(tmp_path):
    cells = testing.synthetic_vah_cells(9, 2, seed=1)
    cells["PL"][4] = 3.0 * cells["P"][4]
    path = str(tmp_path / "surface.dat")
    np.savetxt(path, testing._surface_rows(cells, 2), fmt="%.17e")
    for read in (surface.read_surface, j_surface.read_surface):
        with pytest.raises(ValueError, match="PL/Peq >= 3"):
            read(path, mode=2, dimension=2)


def _mode_matrix(mode):
    """A surface file's matrix for any mode: testing's cells for 1, 2, 3
    and 5; uniform random columns for the others (|v| < 1 for mode 7)."""
    if mode in (1, 2, 3, 5):
        cells = (testing.synthetic_vah_cells(17, 3, seed=mode)
                 if mode in (2, 3) else
                 testing.synthetic_surface_cells(17, 3, seed=mode))
        cells.update(testing.synthetic_vorticity(17, seed=mode))
        return testing._surface_rows(cells, mode)
    ncols = surface.expected_columns(mode, False, False)
    return np.random.default_rng(mode).uniform(0.1, 0.4, (17, ncols))


@pytest.mark.parametrize("mode", range(8))
def test_averages_file_written_for_modes_0_1_4_6_7(tmp_path, mode):
    """read_fo_surf_from_file writes average_thermodynamic_quantities.dat
    where is3d_tpu does (the reference's readers for modes 0, 1, 4, 6
    and 7), never for modes 2, 3 and 5."""
    written = {}
    for name, runner in (("jax", lambda d: JIS3D(JConfig(mode=mode,
                                                         dimension=3),
                                                 data_dir=d)),
                         ("torch", lambda d: IS3D(Config(mode=mode,
                                                         dimension=3),
                                                  data_dir=d,
                                                  device="cpu"))):
        d = tmp_path / name
        (d / "input").mkdir(parents=True)
        np.savetxt(d / "input" / "surface.dat", _mode_matrix(mode),
                   fmt="%.17e")
        runner(str(d)).read_fo_surf_from_file()
        written[name] = os.path.exists(
            d / "average_thermodynamic_quantities.dat")
    assert written["torch"] == written["jax"] == (mode in (0, 1, 4, 6, 7))


def test_vah_modes_raise_not_implemented_for_the_sampler():
    """Modes 2, 3 and 5 run operations 0, 1 and 2 (the sampler's VAH
    branch, slice 9's second half); the sharded sampler (mesh=), which
    raised NotImplementedError until it was ported, samples a VAH surface
    on a one-rank mesh as the chunked driver's one chunk, byte for byte
    (several ranks: tests/test_torch_parallel_events.py)."""
    from is3d_tpu_torch.parallel.mesh import CellMesh
    for mode in (2, 3, 5):
        for op in (0, 1, 2):
            check_supported(Config(operation=op, mode=mode))
    cells = testing.synthetic_vah_cells(50, 2, seed=4)
    cells.update(testing.synthetic_vah_coefficients(cells, seed=4))
    case = dict(surface=convert.surface_from_state(cells),
                species=testing.synthetic_species(7), mcids=np.arange(7),
                cfg=Config(operation=2, mode=2, dimension=2, y_cut=3.0,
                           include_shear_deltaf=1, include_bulk_deltaf=1),
                plasma=None, nevents=4, seed=6)
    one_rank = CellMesh(group=None, device=torch.device("cpu"), rank=0,
                        size=1)
    got, info = testing.sample_case(case, one_rank)
    want, _ = testing.sample_case(case, chunk=50)
    assert info["chunks"] == 1 and sum(len(e["mcid"]) for e in got) > 0
    assert testing.same_events(got, want)


# ------------------------------------------------ coefficient tables

def test_vah_coefficient_tables_match_jax(tmp_path):
    """The synthetic vah tables load alike, and the bilinear
    interpolation agrees inside the table and where it clamps at every
    edge (Lambda below 0.6 and above 1.25 fm^-1, a_L below 0.2 and above
    2)."""
    testing.write_vah_coefficient_tables(str(tmp_path), seed=3)
    coeff_dir = str(tmp_path / "deltaf_coefficients")
    got = deltaf.load_vah_coefficient_tables(coeff_dir)
    want = j_deltaf.load_vah_coefficient_tables(coeff_dir)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    rng = np.random.default_rng(4)
    hbarc = 0.197327053
    Lam = np.concatenate([rng.uniform(0.5, 1.4, 60) * hbarc,
                          [0.1 * hbarc, 2.0 * hbarc, 0.6 * hbarc]])
    aL = np.concatenate([rng.uniform(0.1, 2.5, 60), [0.05, 3.0, 2.0]])
    a = deltaf.interpolate_vah_coefficients(got, Lam, aL)
    b = j_deltaf.interpolate_vah_coefficients(want, Lam, aL)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=0.0)


# ------------------------------------------------------------ the gate

def _gate_cells(n=32, with_c=False, zero_bulk=False):
    cells = testing.synthetic_vah_cells(n, 2, seed=77)
    if with_c:
        cells.update(testing.synthetic_vah_coefficients(cells, seed=77))
    if zero_bulk:
        cells["bulkPi"] = np.zeros(n)
    return cells


GATE_CASES = {
    "none": (dict(), (0, 0)),
    "c4_only": (dict(c4=1.0), (1, 0)),
    "c1_only": (dict(c1=1.0), (0, 1)),
    "c1_zero_bulk": (dict(c1=1.0, zero_bulk=True), (0, 0)),
    "all": (dict(with_c=True), (1, 1)),
    "switches_off": (dict(with_c=True, off=True), (0, 0)),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_effective_vah_cfg_matches_jax(case):
    """The gate keeps the chains is3d_tpu keeps: shear needs a nonzero c3
    or c4, bulk a nonzero bulkPi and a nonzero c0..c2, and a switch that
    is off stays off."""
    spec, want = GATE_CASES[case]
    cells = _gate_cells(with_c=spec.get("with_c", False),
                        zero_bulk=spec.get("zero_bulk", False))
    for k in ("c1", "c4"):
        if k in spec:
            cells[k] = np.full(32, spec[k])
    on = 0 if spec.get("off") else 1
    kw = dict(mode=2, dimension=2, include_shear_deltaf=on,
              include_bulk_deltaf=on)
    jcols = jvah.vah_surface_cols(JSurface(**{k: jnp.asarray(v)
                                              for k, v in cells.items()}))
    jeff = jvah.effective_vah_cfg(jcols, JConfig(**kw))
    eff = vah.effective_vah_cfg(vah.vah_surface_cols(
        convert.surface_from_state(cells)), Config(**kw))
    assert (eff.include_shear_deltaf, eff.include_bulk_deltaf) == want \
        == (jeff.include_shear_deltaf, jeff.include_bulk_deltaf)


@pytest.mark.parametrize("with_c", [False, True])
def test_vah_gate_is_bit_identical(with_c):
    """Gated and ungated (vah_df_gate = 0) plain spectra are bitwise equal:
    without c columns the dropped chains are exact zeros; with them the
    gate drops nothing.  And the chains do move the result."""
    cells = _gate_cells(with_c=with_c)
    surf = convert.surface_from_state(cells)
    grid = momentum_grid(2, True)
    species = testing.synthetic_species(5)
    cfg = Config(mode=2, dimension=2, include_shear_deltaf=1,
                 include_bulk_deltaf=1, regulate_deltaf=1, outflow=1)
    gated = vah.smooth_spectra_vah(surf, species, grid, cfg)
    ungated = vah.smooth_spectra_vah(surf, species, grid,
                                     cfg.replace(vah_df_gate=0))
    assert torch.equal(gated, ungated)
    assert torch.isfinite(gated).all() and (gated > 0).any()
    bare = vah.smooth_spectra_vah(surf, species, grid, cfg.replace(
        include_shear_deltaf=0, include_bulk_deltaf=0))
    assert torch.equal(bare, gated) != with_c


def momentum_grid(dimension, remap, **kw):
    from is3d_tpu_torch.io.tables import native_momentum_grid
    return native_momentum_grid(dimension, eta_mT_rescale=remap,
                                **dict(SMALL_GRID, **kw))


# ----------------------------------------------------------- spectra

PATHS = {"3d": (3, False), "2d_fixed": (2, False), "2d_remap": (2, True)}
CHAINS = {"none": (0, 0), "shear": (1, 0), "bulk": (0, 1), "both": (1, 1)}
EXTRA = {
    # regulate and outflow apart, on every path's chains
    "3d_regulate_only": dict(path="3d", reg=1, out=0),
    "3d_outflow_only": dict(path="3d", reg=0, out=1),
    "2d_remap_neither": dict(path="2d_remap", reg=0, out=0),
    # a_L on one side of 1 only
    "2d_remap_aL_below_1": dict(path="2d_remap", pl=(0.3, 0.9)),
    "3d_aL_above_1": dict(path="3d", pl=(1.2, 2.5)),
    # strong longitudinal flow (|y_flow| up to ~1.7)
    "2d_remap_strong_flow": dict(path="2d_remap", scale_un=7.0),
    "3d_strong_flow": dict(path="3d", scale_un=7.0),
    # 37 cells over 8 groups: the last group is mostly pad cells
    "2d_remap_group_remainder": dict(path="2d_remap", n=37),
}


def run_both(cells, cfg_kw, grid_kw, n_species=7):
    """(port, reference) VAH spectra for one configuration."""
    dimension = cfg_kw["dimension"]
    jgrid = j_native_grid(dimension=dimension, **grid_kw)
    jsp = jtesting.synthetic_species(n_species=n_species)
    jsurf = JSurface(**{k: jnp.asarray(v) for k, v in cells.items()})
    want = np.asarray(jvah.smooth_spectra_vah(jsurf, jsp, jgrid,
                                              JConfig(**cfg_kw)))
    got = vah.smooth_spectra_vah(
        convert.surface_from_state(cells),
        convert.species_from_state(jax_state(jsp)),
        convert.grid_from_state(jax_state(jgrid)), Config(**cfg_kw))
    return got.numpy(), want


def _spectra_case(path, chains=(1, 1), reg=1, out=1, pl=(0.3, 2.5),
                  scale_un=1.0, n=40):
    dimension, remap = PATHS[path]
    cells = testing.synthetic_vah_cells(n, dimension, seed=n + dimension,
                                        pl_over_p=pl)
    cells["un"] = cells["un"] * scale_un
    if any(chains):
        cells.update(testing.synthetic_vah_coefficients(cells, seed=n))
    cfg_kw = dict(mode=2, dimension=dimension, include_shear_deltaf=chains[0],
                  include_bulk_deltaf=chains[1], regulate_deltaf=reg,
                  outflow=out, cell_chunk=16)
    return cells, cfg_kw, dict(SMALL_GRID, eta_mT_rescale=remap)


@pytest.mark.parametrize("chains", sorted(CHAINS))
@pytest.mark.parametrize("path", sorted(PATHS))
def test_vah_spectra_match_jax(path, chains):
    cells, cfg_kw, grid_kw = _spectra_case(path, CHAINS[chains])
    got, want = run_both(cells, cfg_kw, grid_kw)
    assert_close(got, want)


@pytest.mark.parametrize("case", sorted(EXTRA))
def test_vah_spectra_edges_match_jax(case):
    spec = dict(EXTRA[case])
    cells, cfg_kw, grid_kw = _spectra_case(spec.pop("path"), **spec)
    if case.endswith("group_remainder"):
        cfg_kw["reduce_groups"] = 8
    got, want = run_both(cells, cfg_kw, grid_kw)
    assert_close(got, want)


# ------------------------------------------------------ end to end

E2E = {
    "mode2_2d": dict(mode=2, dimension=2, n_species=11, overrides={}),
    "mode2_2d_decays": dict(mode=2, dimension=2, n_species=24, decays=True,
                            overrides={}),
    "mode3_3d": dict(mode=3, dimension=3, n_species=11, overrides={}),
    "mode2_2d_tables": dict(mode=2, dimension=2, n_species=11, tables=True,
                            overrides=dict(vah_coefficient_tables=1,
                                           regulate_deltaf=1)),
}


@pytest.mark.parametrize("name", sorted(E2E))
def test_vah_cli_results_match_jax(tmp_path, name):
    """A synthetic VAH run directory through the port's CLI (device=cpu)
    and through is3d_tpu: the same results tree, file by file (decays:
    the *_resonance_decays files too; tables: c0..c4 interpolated from the
    vah tables, so every chain runs), and the port's in-memory spectra at
    the f64 bar."""
    case = E2E[name]
    run_dir = testing.write_synthetic_run_dir(
        str(tmp_path / "run"), 48, case["n_species"], case["dimension"],
        seed=5, decays=case.get("decays", False), mode=case["mode"])
    if case.get("tables"):
        testing.write_vah_coefficient_tables(run_dir, seed=5)
    overrides = case["overrides"]
    ref = JIS3D.from_run_dir(run_dir, overrides=overrides,
                             results_dir=str(tmp_path / "jax"))
    want = ref.run_particlization(write_files=True)
    port = IS3D.from_run_dir(run_dir, overrides=overrides, device="cpu")
    got = port.run_particlization(write_files=False)
    assert_close(got.spectra, want.spectra)
    if case.get("tables"):
        assert port.surface.c3 is not None and ref.surface.c3 is not None
        assert_close(port.surface.c3.numpy(), np.asarray(ref.surface.c3))
    assert cli.main([run_dir, "device=cpu"]
                    + [f"{k}={v}" for k, v in overrides.items()]) == 0
    jt, tt = _tree(tmp_path / "jax"), _tree(os.path.join(run_dir, "results"))
    assert sorted(jt) == sorted(tt)
    assert len(jt) >= 1 + 5 * case["n_species"]
    assert any("_resonance_decays" in rel for rel in jt) == bool(
        case.get("decays"))
    for rel in jt:
        va, wa = _numbers(jt[rel])
        vb, wb = _numbers(tt[rel])
        assert wa == wb and va.shape == vb.shape, rel
        np.testing.assert_allclose(vb, va, rtol=1e-6,
                                   atol=1e-6 * np.abs(va).max(), err_msg=rel)
    assert not os.path.exists(os.path.join(
        run_dir, "average_thermodynamic_quantities.dat"))


def test_mode3_baryon_outside_the_vh_table_matches_jax(tmp_path):
    """A mode-3 surface with include_baryon = 1 whose muB lies outside the
    VH δf table's grid: both packages run it (VAH never reads that table,
    so neither checks the range there) and agree at the f64 bar."""
    run_dir = testing.write_synthetic_run_dir(
        str(tmp_path / "run"), 24, 7, 3, seed=9, mode=3,
        params=dict(include_baryon=1))
    path = os.path.join(run_dir, "input", "surface.dat")
    m = np.loadtxt(path)
    hbarc = 0.197327053
    muB = np.linspace(0.9, 1.2, m.shape[0]) / hbarc      # table: [0, 0.8]
    np.savetxt(path, np.concatenate(
        [m, muB[:, None], np.full((m.shape[0], 1), 0.05)], axis=1),
        fmt="%.10e")
    ref = JIS3D.from_run_dir(run_dir, results_dir=str(tmp_path / "jax"))
    want = ref.run_particlization(write_files=False)
    port = IS3D.from_run_dir(run_dir, device="cpu")
    got = port.run_particlization(write_files=False)
    assert port.cfg.include_baryon and port.cfg.mode == 3
    assert float(port.surface.muB.min()) > 0.8
    assert_close(got.spectra, want.spectra)
