"""is3d_tpu_torch's dN/dX spacetime distributions on anisotropic-hydro
surfaces (modes 2-3, the VAH producer's plain version, CPU) against
is3d_tpu.kernels.dndx.spacetime_distributions on identical inputs: every
returned array, with the residual chains gated and not, and a whole
operation-0 CLI run on a mode-2 run directory.

Inputs are made with numpy from a seed and carried to the port through
is3d_tpu_torch.convert.  Tolerance: f64 on both sides, rtol=1e-9 with
atol=1e-12 * max|ref| per array (test_torch_dndx.py's bar); the written
files at 1e-6 relative (%.6e printing).
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
from is3d_tpu.kernels.dndx import spacetime_distributions as j_dndx

from is3d_tpu_torch import cli, convert, testing
from is3d_tpu_torch.config import Config
from is3d_tpu_torch.kernels import dndx

from test_torch_smooth import jax_state
from test_torch_slice import _tree, _numbers

torch.set_num_threads(1)

RTOL = 1e-9
ATOL_REL = 1e-12
BINS = dict(tau_bins=12, r_bins=8, tau_max=10.0, r_max=8.0)
CASES = {
    "2d_gated": dict(dimension=2, chains=False),
    "2d_chains": dict(dimension=2, chains=True),
    "2d_chains_ungated": dict(dimension=2, chains=True, gate=0),
    "3d_gated": dict(dimension=3, chains=False),
    "3d_chains_plain": dict(dimension=3, chains=True, reg_out=0),
}


def _cells(n, dimension, chains, seed):
    cells = testing.synthetic_vah_cells(n, dimension, seed)
    if chains:
        cells.update(testing.synthetic_vah_coefficients(cells, seed))
    return cells


@pytest.mark.parametrize("case", sorted(CASES))
def test_vah_dndx_matches_jax(case):
    spec = CASES[case]
    dimension = spec["dimension"]
    cells = _cells(45, dimension, spec["chains"], seed=len(case))
    reg_out = spec.get("reg_out", 1)
    cfg_kw = dict(mode=2, operation=0, dimension=dimension,
                  include_shear_deltaf=1, include_bulk_deltaf=1,
                  regulate_deltaf=reg_out, outflow=reg_out, cell_chunk=16,
                  vah_df_gate=spec.get("gate", 1), **BINS)
    jgrid = j_native_grid(dimension=dimension, n_pT=5, n_phi=4, n_y=5,
                          n_eta=10)
    jsp = jtesting.synthetic_species(n_species=7)
    want = j_dndx(JSurface(**{k: jnp.asarray(v) for k, v in cells.items()}),
                  jsp, jgrid, None, JConfig(**cfg_kw))
    got = dndx.spacetime_distributions(
        convert.surface_from_state(cells),
        convert.species_from_state(jax_state(jsp)),
        convert.grid_from_state(jax_state(jgrid)), None, Config(**cfg_kw))
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape, k
        assert np.isfinite(b).all(), k
        np.testing.assert_allclose(a, b, rtol=RTOL,
                                   atol=ATOL_REL * np.abs(b).max(),
                                   err_msg=k)
    assert (want["dN_dy"] > 0).all()


def test_vah_operation0_cli_matches_jax(tmp_path):
    """A mode-2 2+1D run directory through the port's CLI (device=cpu,
    operation 0) and through is3d_tpu: the same spacetime_distribution
    tree, file by file."""
    run_dir = testing.write_synthetic_run_dir(
        str(tmp_path / "run"), 48, 11, 2, seed=6, mode=2,
        params=dict(operation=0))
    ref = JIS3D.from_run_dir(run_dir, results_dir=str(tmp_path / "jax"))
    want = ref.run_particlization(write_files=True)
    assert cli.main([run_dir, "device=cpu"]) == 0
    jt, tt = _tree(tmp_path / "jax"), _tree(os.path.join(run_dir, "results"))
    assert sorted(jt) == sorted(tt) and len(jt) == 4 * 11
    for rel in jt:
        va, wa = _numbers(jt[rel])
        vb, wb = _numbers(tt[rel])
        assert wa == wb and va.shape == vb.shape, rel
        np.testing.assert_allclose(vb, va, rtol=1e-6,
                                   atol=1e-6 * np.abs(va).max(), err_msg=rel)
    assert (want.dN_dX["dN_dy"] > 0).all()
