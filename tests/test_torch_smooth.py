"""is3d_tpu_torch's smooth spectra (the plain torch version, CPU) against
is3d_tpu.kernels.smooth.smooth_spectra on identical inputs.

Inputs are made with numpy from a seed, built once on the JAX side and
carried to the port through is3d_tpu_torch.convert.  Tolerance: f64 on
both sides, so the two differ only by summation order and the algebraic
regrouping of the same terms (~1e-15 relative per term): rtol=1e-9 with
atol=1e-12 * max|ref| for the near-zero bins leaves five orders of margin
and is far inside the 1e-6 relative bar of BASELINE.md.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from is3d_tpu import testing as jtesting
from is3d_tpu.config import Config as JConfig
from is3d_tpu.io.surface import Surface as JSurface
from is3d_tpu.io.tables import native_momentum_grid as j_native_grid
from is3d_tpu.kernels.smooth import smooth_spectra as j_smooth_spectra

from is3d_tpu_torch import convert
from is3d_tpu_torch.config import Config
from is3d_tpu_torch.kernels.smooth import smooth_spectra

torch.set_num_threads(1)

RTOL = 1e-9
ATOL_REL = 1e-12


def jax_state(obj):
    """A JAX-side state container as nested dicts of numpy arrays."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if dataclasses.is_dataclass(obj):
        return {f.name: jax_state(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: jax_state(v) for k, v in obj.items()}
    return np.asarray(obj)


def random_cells(n, dimension, seed, baryon=False):
    cells = jtesting.synthetic_surface_cells(n, dimension, seed)
    if baryon:
        rng = np.random.default_rng(seed + 1000)
        cells.update(muB=rng.uniform(0.05, 0.3, n), nB=rng.uniform(0, 0.05, n),
                     Vx=rng.normal(0, 0.02, n), Vy=rng.normal(0, 0.02, n),
                     Vn=rng.normal(0, 0.005, n))
    return cells


def run_both(cells, cfg_kw, grid_kw, n_species=14, dtype=torch.float64):
    """(port, reference) spectra for one configuration."""
    dimension = cfg_kw["dimension"]
    jcfg = JConfig(operation=1, mode=1, **cfg_kw)
    jgrid = j_native_grid(dimension=dimension, **grid_kw)
    jsp = jtesting.synthetic_species(n_species=n_species)
    jdf = jtesting.synthetic_deltaf_data()
    jsurf = JSurface(**{k: jnp.asarray(v) for k, v in cells.items()})
    want = np.asarray(j_smooth_spectra(jsurf, jsp, jgrid, jdf, jcfg))

    cfg = Config(operation=1, mode=1, **cfg_kw)
    got = smooth_spectra(
        convert.surface_from_state(cells, dtype=dtype),
        convert.species_from_state(jax_state(jsp), dtype=dtype),
        convert.grid_from_state(jax_state(jgrid), dtype=dtype),
        convert.deltaf_from_state(jax_state(jdf), dtype=dtype), cfg)
    return got.numpy(), want


SMALL_GRID = dict(n_pT=6, n_phi=6, n_y=5, n_eta=12)
VISC = dict(include_shear_deltaf=1, include_bulk_deltaf=1)

CASES = {
    # dimension x df, default switches (shear + bulk), 2+1D remapped nodes
    "2d_df1": (dict(dimension=2, df_mode=1, **VISC), {}),
    "2d_df2": (dict(dimension=2, df_mode=2, **VISC), {}),
    "3d_df1": (dict(dimension=3, df_mode=1, **VISC), {}),
    "3d_df2": (dict(dimension=3, df_mode=2, **VISC), {}),
    # 2+1D fixed eta nodes
    "2d_df1_fixed": (dict(dimension=2, df_mode=1, **VISC),
                     dict(eta_mT_rescale=False)),
    "2d_df2_fixed": (dict(dimension=2, df_mode=2, **VISC),
                     dict(eta_mT_rescale=False)),
    # regulate_deltaf / outflow on
    "3d_df2_regulate_outflow": (dict(dimension=3, df_mode=2, regulate_deltaf=1,
                                     outflow=1, **VISC), {}),
    "2d_df1_regulate_outflow": (dict(dimension=2, df_mode=1, regulate_deltaf=1,
                                     outflow=1, **VISC), {}),
    "2d_df2_fixed_regulate_outflow": (dict(dimension=2, df_mode=2,
                                           regulate_deltaf=1, outflow=1,
                                           **VISC),
                                      dict(eta_mT_rescale=False)),
    # switch sets
    "3d_df2_shear_only": (dict(dimension=3, df_mode=2,
                               include_shear_deltaf=1), {}),
    "2d_df1_bulk_only": (dict(dimension=2, df_mode=1,
                              include_bulk_deltaf=1), {}),
    "3d_df2_no_df": (dict(dimension=3, df_mode=2, regulate_deltaf=1), {}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_smooth_spectra_matches_jax(name):
    cfg_kw, grid_kw = CASES[name]
    cells = random_cells(120, cfg_kw["dimension"], seed=len(name))
    got, want = run_both(cells, dict(cfg_kw, cell_chunk=32),
                         dict(SMALL_GRID, **grid_kw))
    assert got.shape == want.shape
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max())


@pytest.mark.parametrize("dimension,df_mode", [(3, 1), (2, 2)])
def test_smooth_spectra_baryon_diffusion_matches_jax(dimension, df_mode):
    """include_baryon (alphaB, bilinear (T, muB) coefficients) with the
    baryon-diffusion df term on nonzero V^mu."""
    cells = random_cells(96, dimension, seed=7, baryon=True)
    cfg_kw = dict(dimension=dimension, df_mode=df_mode, include_baryon=1,
                  include_baryondiff_deltaf=1, **VISC)
    got, want = run_both(cells, cfg_kw, SMALL_GRID)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max())


@pytest.mark.parametrize("dimension", [2, 3])
def test_smooth_spectra_ragged_cell_count(dimension):
    """203 cells: not a multiple of the 8 canonical groups, the 16-row
    cell block, or the 7-cell chunk."""
    cells = random_cells(203, dimension, seed=11)
    cfg_kw = dict(dimension=dimension, df_mode=2, outflow=1, cell_chunk=7,
                  **VISC)
    got, want = run_both(cells, cfg_kw, SMALL_GRID)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max())


@pytest.mark.parametrize("df_mode,dimension", [(1, 2), (2, 2), (2, 3)])
def test_smooth_spectra_f32_matches_pallas_interpret(monkeypatch, df_mode,
                                                     dimension):
    """f32 against the TPU kernel itself (Pallas, interpret mode), fixed
    eta nodes (it has no remap), at tests/test_pallas.py's tolerance."""
    monkeypatch.setenv("IS3D_PALLAS_INTERPRET", "1")
    from is3d_tpu.kernels.common import surface_columns
    from is3d_tpu.kernels.pallas_smooth import smooth_spectra_pallas

    cells = random_cells(21, dimension, seed=61)
    grid_kw = dict(n_pT=5, n_phi=6, n_y=5, n_eta=8, eta_mT_rescale=False)
    cfg_kw = dict(dimension=dimension, df_mode=df_mode, regulate_deltaf=1,
                  outflow=1, cell_chunk=8, **VISC)
    jcfg = JConfig(operation=1, mode=1, **cfg_kw)
    f32 = lambda tree: {k: (v.astype(jnp.float32) if v is not None else v)
                        for k, v in tree.items()}
    jgrid = j_native_grid(dimension=dimension, **grid_kw)
    jsp = jtesting.synthetic_species(n_species=6)
    jdf = jtesting.synthetic_deltaf_data()
    jsurf = JSurface(**{k: jnp.asarray(v) for k, v in cells.items()})
    cols = f32(surface_columns(jsurf, jcfg))
    import jax
    cast = lambda t: jax.tree.map(
        lambda a: a.astype(jnp.float32) if hasattr(a, "astype")
        and a.dtype == jnp.float64 else a, t)
    want = np.asarray(smooth_spectra_pallas(cols, cast(jsp), cast(jgrid),
                                            cast(jdf), jcfg))

    dt = torch.float32
    got = smooth_spectra(
        convert.surface_from_state(cells, dtype=dt),
        convert.species_from_state(jax_state(jsp), dtype=dt),
        convert.grid_from_state(jax_state(jgrid), dtype=dt),
        convert.deltaf_from_state(jax_state(jdf), dtype=dt),
        Config(operation=1, mode=1, **cfg_kw)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=2e-5 * scale, rtol=2e-4)


def test_remap_node_table_reproduces_jax_operands():
    """The remap kernel's prepacked node factors exp(-+s eta_r) and its
    per-cell exp(+-y_flow) against the operands of the JAX body's addition
    theorem (_rescaled_eta_operands): mT cosh(s eta_r), mT sinh(s eta_r),
    their products, (cosh, sinh)(-y_flow) and the jacobian s(mT).  Both
    sides f64 and the same elementary functions of the same arguments:
    rtol 1e-12."""
    from is3d_tpu.kernels.smooth import _rescaled_eta_operands
    from is3d_tpu_torch.kernels import smooth as tsmooth
    from is3d_tpu_torch.kernels.common import surface_columns, prepare_cells

    cells = random_cells(40, 2, seed=3)
    cells["un"] = cells["un"] * 7.0               # |y_flow| up to ~2
    jgrid = j_native_grid(dimension=2, **SMALL_GRID)
    jsp = jtesting.synthetic_species(n_species=14)
    S, P, F, R = 14, jgrid.n_pT, jgrid.n_phi, jgrid.n_eta
    cfg = Config(operation=1, mode=1, dimension=2, df_mode=2, **VISC)
    c = prepare_cells(surface_columns(convert.surface_from_state(cells), cfg),
                      cfg, convert.deltaf_from_state(
                          jax_state(jtesting.synthetic_deltaf_data())))
    jc = {k: jnp.asarray(c[k].numpy()) for k in ("ux", "uy", "ut", "tau",
                                                 "un")}
    CHR, SHR, CHR2, SHR2, CHRSHR, chs, shs, s_flat = (
        np.asarray(x) for x in _rescaled_eta_operands(jc, jsp, jgrid, S, P,
                                                      F, P * F))

    grid = convert.grid_from_state(jax_state(jgrid))
    assert grid.eta_mT_rescale
    mom = tsmooth.momentum_constants(
        convert.species_from_state(jax_state(jsp)), grid, 2)
    table = tsmooth.remap_node_table(mom).numpy()          # (S, P, R, 2)
    s = tsmooth.remap_scale(mom).numpy()
    mT = np.sqrt(mom.mass.numpy()[:, None] ** 2 + mom.pT.numpy()[None] ** 2)
    ch = 0.5 * (table[..., 1] + table[..., 0])
    sh = 0.5 * (table[..., 1] - table[..., 0])

    def block(x):                  # (S, P, R) -> the operands' (1, R, S, M)
        return np.broadcast_to(x[:, :, None, :], (S, P, F, R)).reshape(
            S, P * F, R).transpose(2, 0, 1)[None]

    tol = dict(rtol=1e-12, atol=0)
    np.testing.assert_allclose(block(mT[..., None] * ch), CHR, **tol)
    np.testing.assert_allclose(block(mT[..., None] * sh), SHR, rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(block((mT ** 2)[..., None] * ch * ch), CHR2,
                               **tol)
    np.testing.assert_allclose(block((mT ** 2)[..., None] * sh * sh), SHR2,
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(block((mT ** 2)[..., None] * ch * sh), CHRSHR,
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(
        np.broadcast_to(s[:, :, None], (S, P, F)).reshape(S, P * F), s_flat,
        **tol)
    packed = tsmooth.pack_cells(c, cfg)[:40]
    yflow = packed[:, tsmooth.IDX["yflow"]].numpy()
    assert 1.5 < np.abs(yflow).max() < 2.5
    ey, eym = np.exp(yflow), np.exp(-yflow)
    np.testing.assert_allclose(0.5 * (ey + eym), chs, **tol)
    np.testing.assert_allclose(-0.5 * (ey - eym), shs, rtol=1e-12,
                               atol=1e-15)
