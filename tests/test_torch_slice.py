"""The whole operation-1 slice: one synthetic run directory through
is3d_tpu.api.IS3D and is3d_tpu_torch.api.IS3D (device="cpu"), both writing
their results trees.

The run-dir path takes the native default grid (32 pT x 24 phi x 21 y, or
48 eta in 2+1D), so the run is kept to 64 cells x 11 species.

Tolerances: the spectra are held to test_torch_smooth.py's f64 bar
(rtol=1e-9, atol=1e-12 * max).  The integrated observables (dN_dy,
dN_dphidy, dN_twopipTdpTdy) are byte-identical.  The other two writers are
compared value for value at 1e-6 relative (the BASELINE.md bar), because
they are not byte-equal: the point spectra (dN_pTdpTdphidy) print every
value with %.8e, and a value whose two f64 results differ in the 15th
digit now and then rounds to a different 9th digit; the continuous v_n
are ratios of near-cancelling Fourier sums, so the small high harmonics
carry that 1e-15 difference up into the printed digits.
"""

import os

import numpy as np
import pytest
import torch

from is3d_tpu.api import IS3D as JIS3D

from is3d_tpu_torch import cli
from is3d_tpu_torch.api import IS3D
from is3d_tpu_torch.testing import write_synthetic_run_dir

torch.set_num_threads(1)

BYTE_EQUAL = ("dN_dy_", "dN_dphidy_", "dN_twopipTdpTdy_")
CASES = {
    "2d_df1": dict(dimension=2, overrides=dict(df_mode=1)),
    "3d_df2": dict(dimension=3, overrides=dict(df_mode=2, regulate_deltaf=1)),
}


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            out[os.path.relpath(os.path.join(d, f), root)] = os.path.join(d, f)
    return out


def _numbers(path):
    with open(path) as f:
        toks = f.read().split()
    vals, words = [], []
    for t in toks:
        try:
            vals.append(float(t))
        except ValueError:
            words.append(t)
    return np.asarray(vals), words


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    return {name: write_synthetic_run_dir(
        str(tmp_path_factory.mktemp(name)), n_cells=64, n_species=11,
        dimension=case["dimension"], seed=3)
        for name, case in CASES.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_slice_matches_jax(run_dirs, tmp_path, name):
    run_dir = run_dirs[name]
    overrides = CASES[name]["overrides"]
    ref = JIS3D.from_run_dir(run_dir, overrides=overrides,
                             results_dir=str(tmp_path / "jax"))
    want = ref.run_particlization(write_files=True)
    port = IS3D.from_run_dir(run_dir, overrides=overrides, device="cpu",
                             results_dir=str(tmp_path / "torch"))
    got = port.run_particlization(write_files=True)

    assert got.spectra.shape == want.spectra.shape
    np.testing.assert_array_equal(got.mcids, want.mcids)
    np.testing.assert_allclose(got.spectra, want.spectra, rtol=1e-9,
                               atol=1e-12 * np.abs(want.spectra).max())

    jt, tt = _tree(tmp_path / "jax"), _tree(tmp_path / "torch")
    assert sorted(jt) == sorted(tt)
    assert len(jt) == 1 + 5 * len(want.mcids)
    for rel in jt:
        with open(jt[rel], "rb") as a, open(tt[rel], "rb") as b:
            same = a.read() == b.read()
        if os.path.basename(rel).startswith(BYTE_EQUAL):
            assert same, f"{rel} is not byte-equal"
            continue
        va, wa = _numbers(jt[rel])
        vb, wb = _numbers(tt[rel])
        assert wa == wb and va.shape == vb.shape, rel
        np.testing.assert_allclose(vb, va, rtol=1e-6,
                                   atol=1e-6 * np.abs(va).max(), err_msg=rel)


def test_cli_runs_the_slice(run_dirs, tmp_path):
    rc = cli.main([run_dirs["2d_df1"], "device=cpu", "precision=f32",
                   "include_shear_deltaf=1", "include_bulk_deltaf=1"])
    assert rc == 0
    results = os.path.join(run_dirs["2d_df1"], "results")
    assert os.path.getsize(os.path.join(results, "dN_pTdpTdphidy.dat")) > 0
