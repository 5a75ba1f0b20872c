"""is3d_tpu_torch's modified-equilibrium spectra (df 3-4; the plain torch
version, CPU) against is3d_tpu.kernels.feqmod.smooth_spectra_feqmod on
identical inputs, and the per-cell algebra it is built on against the JAX
functions.

Inputs are made with numpy from a seed (is3d_tpu.testing's synthetic
cells, shear and bulk scaled as in is3d_tpu_torch.testing.FEQMOD_EDGES:
the synthetic delta-f tables are far from a real gas's, so unscaled cells
mostly break down) and carried to the port through is3d_tpu_torch.convert.
Tolerance: f64 on both sides, rtol=1e-9 with atol=1e-12 * max|ref|, as
test_torch_smooth.py.  The port evaluates |Minv p|^2 as a sum of squares
where JAX expands the quadratic form; in f64 the two differ far below the
tolerance on these inputs.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from is3d_tpu import testing as jtesting
from is3d_tpu.config import Config as JConfig
from is3d_tpu.io.surface import Surface as JSurface
from is3d_tpu.io.tables import (native_momentum_grid as j_native_grid,
                                laguerre_device as j_laguerre_device,
                                laguerre_in_precision as j_laguerre_in_prec)
from is3d_tpu.kernels import feqmod as jfeqmod
from is3d_tpu.physics import lrf as jlrf

from is3d_tpu_torch import convert
from is3d_tpu_torch.config import Config, load_config
from is3d_tpu_torch.io.tables import (laguerre_device, laguerre_in_precision,
                                      load_gauss_laguerre_file,
                                      gauss_laguerre)
from is3d_tpu_torch.kernels import feqmod
from is3d_tpu_torch.physics import lrf

from test_torch_smooth import jax_state

torch.set_num_threads(1)

RTOL = 1e-9
ATOL_REL = 1e-12
VISC = dict(include_shear_deltaf=1, include_bulk_deltaf=1)
SMALL_GRID = dict(n_pT=5, n_phi=4, n_y=5, n_eta=10)
# (scale_pi, scale_bulk) of testing.FEQMOD_EDGES' surfaces
CLEAN, MIXED, MOST = (0.01, 0.001), (0.1, 0.01), (0.3, 0.01)


def feqmod_cells(n, dimension, seed, scales=MIXED, bulk_P=None,
                 eta_on=None, baryon=False):
    """numpy cells of is3d_tpu.testing, shear x scales[0] and bulkPi x
    scales[1] (or bulkPi = bulk_P x P, cycled); with ``eta_on`` the cells'
    eta moved onto the nearest of those rapidities."""
    cells = jtesting.synthetic_surface_cells(n, dimension, seed)
    for k in ("pixx", "pixy", "pixn", "piyy", "piyn"):
        cells[k] = cells[k] * scales[0]
    cells["bulkPi"] = cells["bulkPi"] * scales[1]
    if bulk_P is not None:
        cells["bulkPi"] = np.resize(np.asarray(bulk_P, float), n) * cells["P"]
    if eta_on is not None:
        cells["eta"] = eta_on[np.abs(cells["eta"][:, None]
                                     - eta_on[None, :]).argmin(1)]
    if baryon:
        rng = np.random.default_rng(seed + 1000)
        cells.update(muB=rng.uniform(0.05, 0.3, n),
                     nB=rng.uniform(0.01, 0.05, n))
    return cells


def run_both(cells, cfg_kw, grid_kw, n_species=9, jcfg_kw=None,
             jdf_edit=None):
    """(port, reference, port cfg) spectra for one configuration; jcfg_kw
    sets keys of the JAX Config only."""
    dimension = cfg_kw["dimension"]
    jcfg = JConfig(operation=1, mode=1, **cfg_kw, **(jcfg_kw or {}))
    jgrid = j_native_grid(dimension=dimension, **grid_kw)
    jsp = jtesting.synthetic_species(n_species=n_species)
    jdf = jtesting.synthetic_deltaf_data()
    if jdf_edit is not None:
        jdf = jdf_edit(jdf)
    jsurf = JSurface(**{k: jnp.asarray(v) for k, v in cells.items()})
    want = np.asarray(jfeqmod.smooth_spectra_feqmod(jsurf, jsp, jgrid, jdf,
                                                    jcfg))
    cfg = Config(operation=1, mode=1, **cfg_kw)
    got = feqmod.smooth_spectra_feqmod(
        convert.surface_from_state(cells),
        convert.species_from_state(jax_state(jsp)),
        convert.grid_from_state(jax_state(jgrid)),
        convert.deltaf_from_state(jax_state(jdf)), cfg)
    return got.numpy(), want


def assert_close(got, want):
    assert got.shape == want.shape
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max())


PATHS = {"3d": (3, {}), "2d_fixed": (2, dict(eta_mT_rescale=False)),
         "2d_remap": (2, dict(eta_mT_rescale=True))}
SURFACES = {"mixed": MIXED, "most": MOST}


@pytest.mark.parametrize("df_mode", [3, 4])
@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("surface", sorted(SURFACES))
def test_feqmod_spectra_match_jax(df_mode, path, surface):
    dimension, grid_kw = PATHS[path]
    cells = feqmod_cells(72, dimension, seed=df_mode + 7 * len(path),
                         scales=SURFACES[surface])
    got, want = run_both(
        cells, dict(dimension=dimension, df_mode=df_mode, regulate_deltaf=1,
                    outflow=1, cell_chunk=32, **VISC),
        dict(SMALL_GRID, **grid_kw))
    assert_close(got, want)


@pytest.mark.parametrize("df_mode,path", [(3, "3d"), (4, "2d_remap")])
def test_feqmod_clean_surface_no_regulation_matches_jax(df_mode, path):
    dimension, grid_kw = PATHS[path]
    cells = feqmod_cells(64, dimension, seed=11, scales=CLEAN)
    got, want = run_both(cells, dict(dimension=dimension, df_mode=df_mode,
                                      **VISC), dict(SMALL_GRID, **grid_kw))
    assert_close(got, want)


def test_feqmod_narrow_mask_matches_jax():
    """3+1D df 4 with bulkPi = -0.9 P: detA in (0, 0.01) on most cells,
    eta on the output rapidities, so the narrow mask takes the fallback."""
    grid = dict(SMALL_GRID)
    y = np.linspace(-5.0, 5.0, grid["n_y"])
    cells = feqmod_cells(64, 3, seed=5, scales=(0.01, 1.0), bulk_P=(-0.9,),
                         eta_on=y)
    got, want = run_both(cells, dict(dimension=3, df_mode=4, outflow=1,
                                      **VISC), grid)
    assert_close(got, want)
    # the mask fired: without it the spectra differ
    c = _port_cells(cells, dict(dimension=3, df_mode=4, **VISC))
    narrow = (~c["breakdown"]) & (c["detA"] > 0) & (c["detA"] < 0.01)
    assert narrow.sum() > 10


@pytest.mark.parametrize("compat", [0, 1])
def test_feqmod_reference_compat_eta_matches_jax(compat):
    """Both settings of reference_compat_feqmod_eta on 2+1D fixed nodes,
    with cells on both sides of detA = 1 (df 4, bulk x 3)."""
    cells = feqmod_cells(64, 2, seed=13, scales=(0.01, 3.0))
    kw = dict(dimension=2, df_mode=4, reference_compat_feqmod_eta=compat,
              **VISC)
    got, want = run_both(cells, kw, dict(SMALL_GRID, eta_mT_rescale=False))
    assert_close(got, want)
    c = _port_cells(cells, kw)
    assert (c["detA"] >= 1).any() and (c["detA"] < 1).any()
    assert ((c["eta_scale"] == 1) == (c["detA"] >= 1)).all() == bool(compat)


def test_feqmod_baryon_alphaB_mod_matches_jax():
    cells = feqmod_cells(64, 3, seed=17, scales=MIXED, baryon=True)
    kw = dict(dimension=3, df_mode=3, include_baryon=1, regulate_deltaf=1,
              **VISC)
    got, want = run_both(cells, kw, SMALL_GRID)
    assert_close(got, want)
    assert np.abs(_port_cells(cells, kw)["alphaB_mod"].numpy()).max() > 0.1


def test_feqmod_degenerate_tables_match_jax():
    """betaV = 0 with baryon diffusion and regulation on mostly broken-down
    cells: the unregrouped fallback keeps the clipped +-inf finite."""
    cells = feqmod_cells(48, 3, seed=19, scales=MOST, baryon=True)
    rng = np.random.default_rng(3)
    cells.update(Vx=rng.normal(0, 0.02, 48), Vy=rng.normal(0, 0.02, 48),
                 Vn=rng.normal(0, 0.005, 48))

    def zero_betaV(jdf):
        tables = dict(jdf.tables)
        tables["betaV"] = jnp.zeros_like(tables["betaV"])
        return jdf.replace(tables=tables)

    got, want = run_both(cells, dict(dimension=3, df_mode=3, include_baryon=1,
                                      include_baryondiff_deltaf=1,
                                      regulate_deltaf=1, **VISC),
                         SMALL_GRID, jdf_edit=zero_betaV)
    assert_close(got, want)


def test_feqmod_df4_clamp_matches_jax():
    """bulkPi below -P and above the Jonah table's bulkPi/P: the clamp of
    prepare_cells, both packages."""
    cells = feqmod_cells(48, 3, seed=23, scales=(0.01, 1.0),
                         bulk_P=(-1.5, 0.2, 40.0))
    kw = dict(dimension=3, df_mode=4, **VISC)
    got, want = run_both(cells, kw, SMALL_GRID)
    assert_close(got, want)
    c = _port_cells(cells, kw)
    P = c["P"]
    assert (c["bulkPi"] > -P).all() and (c["bulkPi"] < 40.0 * P).all()


@pytest.mark.parametrize("path", ["3d", "2d_remap"])
def test_feqmod_routed_jax_matches_port(path):
    """JAX's routed mode (per-chunk branches, cells sorted by their
    routing flag) gives the answer the port is held to."""
    dimension, grid_kw = PATHS[path]
    cells = feqmod_cells(96, dimension, seed=29, scales=MIXED)
    kw = dict(dimension=dimension, df_mode=3, regulate_deltaf=1, outflow=1,
              cell_chunk=8, **VISC)
    got, want = run_both(cells, kw, dict(SMALL_GRID, **grid_kw),
                         jcfg_kw=dict(feqmod_partition_min_cells=1))
    assert_close(got, want)
    assert jfeqmod.feqmod_kernel_mode(
        JConfig(feqmod_partition_min_cells=1), 96) == "routed"


def _port_cells(cells, kw):
    """The port's prepared feqmod cell bundle of numpy cells."""
    from is3d_tpu_torch.kernels.common import surface_columns, prepare_cells
    cfg = Config(operation=1, mode=1, **kw)
    df = convert.deltaf_from_state(jax_state(jtesting.synthetic_deltaf_data()))
    sp = convert.species_from_state(jax_state(jtesting.synthetic_species(9)))
    c = prepare_cells(surface_columns(convert.surface_from_state(cells), cfg),
                      cfg, df)
    return feqmod.prepare_feqmod_cells(c, sp, laguerre_device(), cfg)


@pytest.mark.parametrize("df_mode", [3, 4])
def test_feqmod_partition_keys_are_inert(df_mode):
    """feqmod_partition and feqmod_partition_min_cells load from a
    parameter file and change no bit of the result."""
    cfg = load_config(text="feqmod_partition = 0\n"
                      "feqmod_partition_min_cells = 1\n",
                      overrides=dict(dimension=3, df_mode=df_mode,
                                     include_bulk_deltaf=1,
                                     include_shear_deltaf=1))
    assert cfg.feqmod_partition == 0 and cfg.feqmod_partition_min_cells == 1
    cells = feqmod_cells(40, 3, seed=31, scales=MIXED)
    jsp, jgrid = jtesting.synthetic_species(7), j_native_grid(3, **SMALL_GRID)
    args = (convert.surface_from_state(cells),
            convert.species_from_state(jax_state(jsp)),
            convert.grid_from_state(jax_state(jgrid)),
            convert.deltaf_from_state(jax_state(
                jtesting.synthetic_deltaf_data())))
    a = feqmod.smooth_spectra_feqmod(*args, cfg)
    b = feqmod.smooth_spectra_feqmod(*args, dataclasses.replace(
        cfg, feqmod_partition=1, feqmod_partition_min_cells=16384))
    assert torch.equal(a, b)


# ------------------------------------------------------ per-cell algebra

def _random_sym(rng, n, scale):
    """Symmetric 3x3 transforms near the identity (the 6-tuple layout)."""
    off = rng.normal(0, scale, (6, n))
    off[[0, 3, 5]] += 1.0
    return [off[i] for i in range(6)]


def test_refined_inverse_matches_jax():
    rng = np.random.default_rng(37)
    for scale in (0.05, 0.6, 3.0):       # the last mostly keeps adjugates
        A = _random_sym(rng, 200, scale)
        jadj, jdet = jfeqmod._adjugate_sym(tuple(jnp.asarray(a) for a in A))
        jinv = tuple(a / jdet for a in jadj)
        want = jfeqmod._refined_inverse(tuple(jnp.asarray(a) for a in A),
                                        jinv)
        tA = tuple(torch.as_tensor(a) for a in A)
        adj, det = feqmod.adjugate_sym(tA)
        got = feqmod.refined_inverse(tA, tuple(a / det for a in adj))
        np.testing.assert_allclose(det.numpy(), np.asarray(jdet), rtol=1e-13)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                       atol=1e-12)


def test_milne_basis_boost_and_flow_rapidity_match_jax():
    rng = np.random.default_rng(41)
    n = 300
    ux, uy, un = (rng.normal(0, s, n) for s in (0.6, 0.6, 0.05))
    ux[:20] = uy[:20] = 0.0                 # the no-transverse-flow guard
    tau = rng.uniform(0.5, 10.0, n)
    pis = [rng.normal(0, 0.01, n) for _ in range(10)]
    ut = np.sqrt(1.0 + ux * ux + uy * uy + (tau * un) ** 2)
    jb = jlrf.milne_basis(*(jnp.asarray(a) for a in (ut, ux, uy, un, tau)))
    tb = lrf.milne_basis(*(torch.as_tensor(a) for a in (ut, ux, uy, un, tau)))
    for f in ("Xt", "Xx", "Xy", "Xn", "Yx", "Yy", "Zt", "Zn"):
        np.testing.assert_allclose(getattr(tb, f).numpy(),
                                   np.asarray(getattr(jb, f)), rtol=1e-14,
                                   atol=1e-15)
    want = jlrf.boost_pimunu_to_lrf(jb, *(jnp.asarray(p) for p in pis),
                                    jnp.asarray(tau))
    got = lrf.boost_pimunu_to_lrf(tb, *(torch.as_tensor(p) for p in pis),
                                  torch.as_tensor(tau))
    # pi_LRF's components are differences of terms of ~|pi| (0.01-1):
    # the f64 cancellation leaves ~1e-15 absolute
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-13)
    un_extreme = np.concatenate([un, [1e3, -1e3, np.nan]])
    ut_e = np.concatenate([ut, [1.0, 1.0, 1.0]])
    tau_e = np.concatenate([tau, [1.0, 1.0, 1.0]])
    np.testing.assert_allclose(
        lrf.flow_rapidity(*(torch.as_tensor(a) for a in (tau_e, ut_e,
                                                         un_extreme))).numpy(),
        np.asarray(jlrf.flow_rapidity(*(jnp.asarray(a) for a in (
            tau_e, ut_e, un_extreme)))), rtol=1e-13)


def test_laguerre_helpers_match_jax(tmp_path):
    want = j_laguerre_device()
    got = laguerre_device()
    assert sorted(got) == sorted(want) == [1, 2]
    for a in want:
        for g, w in zip(got[a], want[a]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    cast = laguerre_in_precision(None, torch.float32)
    jcast = j_laguerre_in_prec(None, jnp.float32)
    for a in jcast:
        for g, w in zip(cast[a], jcast[a]):
            # XLA flushes the smallest weights' float32 denormals to 0
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-37)
    # the reference's multi-alpha file format, written from the computed
    # nodes (the repo ships no tables/)
    raw = gauss_laguerre(8, alphas=(0, 1, 2))
    path = tmp_path / "gla.dat"
    with open(path, "w") as f:
        f.write("3 8\n")
        for a in range(3):
            for r, w in zip(*raw[a]):
                f.write(f"{a} {float(r)!r} {float(w)!r}\n")
    from is3d_tpu.io.tables import load_gauss_laguerre_file as j_load
    got, want = load_gauss_laguerre_file(str(path)), j_load(str(path))
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for a in want:
        np.testing.assert_array_equal(got[a][0], want[a][0])
        np.testing.assert_array_equal(got[a][1], raw[a][1])
