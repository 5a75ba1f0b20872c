"""The VAH (K4: csrc/vah.cu and dndx.cu's VAH producer) and polarization
(K6: csrc/polzn.cu) kernels' wrappers and edges, jax-free so that they run
on the card too: CPU tensors take the plain versions and never load a
CUDA library; every wrapper checks dtype, shape, contiguity and device
before a launch; the edge cases of testing.VAH_EDGES and POLZN_EDGES show
the edge they are named for; the bounds' yardsticks.  The gpu-marked
tests hold each kernel to its plain version on every edge case (on the
card: python -m pytest tests/test_torch_vah_polzn_kernels.py -m gpu
--noconftest).  tests/test_torch_vah.py, test_torch_vah_dndx.py and
test_torch_polzn.py hold the plain versions to is3d_tpu."""

import numpy as np
import pytest
import torch

from is3d_tpu_torch import convert, testing
from is3d_tpu_torch.config import Config
from is3d_tpu_torch.io.tables import native_momentum_grid
from is3d_tpu_torch.kernels import dndx, polzn, vah
from is3d_tpu_torch.native import build

torch.set_num_threads(1)


def _grid(dimension, remap):
    return native_momentum_grid(dimension, n_pT=5, n_phi=4, n_y=5, n_eta=10,
                                eta_mT_rescale=remap)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the GPU: python -m pytest "
                    "tests/test_torch_vah_polzn_kernels.py -m gpu "
                    "--noconftest)")


# --------------------------------------------------------------- K4

def test_vah_cpu_tensors_take_plain_path_and_never_load_kernel():
    counts = (vah.LAUNCHES, vah.REMAP_LAUNCHES)
    for dimension, remap in ((3, False), (2, True)):
        surf = convert.surface_from_state(
            testing.synthetic_vah_cells(30, dimension, seed=8))
        out = vah.smooth_spectra_vah(surf, testing.synthetic_species(5),
                                     _grid(dimension, remap),
                                     Config(mode=2, dimension=dimension,
                                            outflow=1))
        assert out.device.type == "cpu" and torch.isfinite(out).all()
    assert counts == (vah.LAUNCHES, vah.REMAP_LAUNCHES)
    assert "vah" not in build._cuda_libs


def test_vah_surface_cols_needs_lambda_and_aL():
    cells = testing.synthetic_surface_cells(5, 2, seed=1)
    with pytest.raises(ValueError, match="Lambda and aL"):
        vah.vah_surface_cols(convert.surface_from_state(cells))


def _wrapper_inputs(remap):
    x, mom, flags, _, _ = testing.vah_edge_inputs(
        "2d_remap_sw3" if remap else "3d_sw3", n_cells=9)
    return x, mom, flags


VAH_FAULTS = {None: "needs CUDA tensors", "dtype": "float32 or float64",
          "shape": "need a contiguous", "contiguity": "not contiguous"}


@pytest.mark.parametrize("fault", list(VAH_FAULTS), ids=str)
@pytest.mark.parametrize("remap", [False, True])
def test_vah_wrapper_checks_its_arguments(remap, fault):
    """CPU tensors, a wrong dtype, a wrong shape and a non-contiguous
    tensor each raise before any launch (the device is checked last, so a
    CPU call reaches every other check)."""
    x, mom, flags = _wrapper_inputs(remap)
    if fault == "dtype":
        x = x.to(torch.int32)
    elif fault == "shape":
        x = x[:, :-1].contiguous()
    elif fault == "contiguity":
        x = x.t().contiguous().t()
    counts = (vah.LAUNCHES, vah.REMAP_LAUNCHES)
    with pytest.raises(ValueError, match=VAH_FAULTS[fault]):
        vah.vah_spectra_cuda(x, mom, flags)
    assert counts == (vah.LAUNCHES, vah.REMAP_LAUNCHES)
    assert "vah" not in build._cuda_libs


@pytest.mark.parametrize("case", sorted(testing.VAH_EDGES))
def test_vah_edge_inputs_are_what_they_claim(case):
    """On the CPU: the VAH edge cases' plain spectra are finite and show
    the edge they are named for (a_L on both sides of 1 or one side
    only, shapes off the kernels' blocking, exact zeros where exp
    overflows, inert pad rows, |y_flow| > 1)."""
    x, mom, flags, _, _ = testing.vah_edge_inputs(case)
    out = vah.vah_spectra_plain(x, mom, flags)
    assert testing.vah_edge_seen(case, x, mom, flags, out)


def test_vah_yardstick():
    """The VAH bound's count: f_a 9 FP32 + 3 SFU (SFU-bound); the chains
    +13 FP32 stay SFU-bound at 22; the remap adds its node kinematics per
    (cell, node, species, pT), a 24th of them per evaluation on the
    native grid."""
    flags = lambda sw, remap: vah.VahFlags(2 if remap else 3, remap,
                                           bool(sw & 1), bool(sw & 2), True,
                                           True)
    rate = lambda ops: max(ops[0] / 128, ops[1] / 16)
    assert vah.vah_formula_ops(flags(0, False), 24) == (9.0, 3.0)
    assert vah.vah_formula_ops(flags(3, False), 24) == (22.0, 3.0)
    assert rate(vah.vah_formula_ops(flags(3, False), 24)) == 3 / 16
    assert vah.vah_formula_ops(flags(0, True), 24) == (8 + 12 / 24,
                                                       3 + 2 / 24)
    assert vah.vah_formula_ops(flags(3, True), 24) == (21 + 23 / 24,
                                                       3 + 2 / 24)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("case", sorted(testing.VAH_EDGES))
def test_vah_kernel_edges_match_plain_on_gpu(cuda_card, case, dtype):
    """The VAH spectra kernels' edges against the plain version: f32 at
    rtol 2e-4 / atol 2e-5 x max, f64 at 1e-10 / 1e-13 x max; two
    launches bit-identical, exact zeros kept."""
    rtol, atol = ((2e-4, 2e-5) if dtype == torch.float32
                  else (1e-10, 1e-13))
    x, mom, flags, _, _ = testing.vah_edge_inputs(case, dtype=dtype,
                                                  device="cuda")
    got, again = (vah.vah_spectra_cuda(x, mom, flags) for _ in range(2))
    want = vah.vah_spectra_plain(x, mom, flags)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=rtol, atol=atol * want.abs().max().item())
    zero = want == 0
    assert torch.equal(got[zero], want[zero])


# ------------------------------------------- K4's dN/dX producer

def test_vah_dndx_cpu_tensors_take_plain_path_and_never_load_kernel():
    launches = (dndx.VAH_LAUNCHES, dndx.BIN_LAUNCHES)
    cells = testing.synthetic_vah_cells(30, 2, seed=3)
    cells.update(testing.synthetic_vah_coefficients(cells, seed=3))
    dX = dndx.spacetime_distributions(
        convert.surface_from_state(cells), testing.synthetic_species(5),
        native_momentum_grid(2, n_pT=4, n_phi=4, n_eta=6), None,
        Config(mode=2, operation=0, dimension=2, include_shear_deltaf=1,
               outflow=1, tau_bins=12, r_bins=8, tau_max=10.0, r_max=8.0))
    assert np.isfinite(dX["dN_dy"]).all() and (dX["dN_dy"] > 0).all()
    assert launches == (dndx.VAH_LAUNCHES, dndx.BIN_LAUNCHES)
    assert "dndx" not in build._cuda_libs


DNDX_FAULTS = {None: "needs CUDA tensors", "dtype": "float32 or float64",
          "shape": "need a contiguous", "contiguity": "not contiguous",
          "remap": "fixed rapidity nodes"}


@pytest.mark.parametrize("fault", list(DNDX_FAULTS), ids=str)
def test_dndx_vah_wrapper_checks_its_arguments(fault):
    """CPU tensors, a wrong dtype, a wrong shape, a non-contiguous tensor
    and the remap's flags each raise before any launch."""
    x, mom, flags, wM, wR = testing.vah_edge_inputs("2d_fixed_sw3",
                                                    n_cells=9)
    if fault == "dtype":
        x = x.to(torch.int32)
    elif fault == "shape":
        wR = wR[:-1].contiguous()
    elif fault == "contiguity":
        x = x.t().contiguous().t()
    elif fault == "remap":
        flags = vah.VahFlags(2, True, True, True, True, True)
    launches = dndx.VAH_LAUNCHES
    with pytest.raises(ValueError, match=DNDX_FAULTS[fault]):
        dndx.dndx_vah_cuda(x, mom, flags, wM, wR)
    assert launches == dndx.VAH_LAUNCHES
    assert "dndx" not in build._cuda_libs


def test_dndx_vah_plain_refuses_the_remap():
    x, mom, flags, wM, wR = testing.vah_edge_inputs("2d_remap_sw0",
                                                    n_cells=9)
    with pytest.raises(ValueError, match="fixed rapidity nodes"):
        dndx.dndx_vah_plain(x, mom, flags, wM, wR)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("case", sorted(c for c in testing.VAH_EDGES
                                        if "remap" not in c))
def test_dndx_vah_edges_match_plain_on_gpu(cuda_card, case, dtype):
    """The VAH producer on the fixed-node VAH edges against its plain
    version: f32 at rtol 2e-4 / atol 2e-5 x max, f64 at 1e-10 / 1e-13 x
    max; two launches bit-identical, exact zeros kept."""
    rtol, atol = ((2e-4, 2e-5) if dtype == torch.float32
                  else (1e-10, 1e-13))
    x, mom, flags, wM, wR = testing.vah_edge_inputs(case, dtype=dtype,
                                                    device="cuda")
    got, again = (dndx.dndx_vah_cuda(x, mom, flags, wM, wR)
                  for _ in range(2))
    want = dndx.dndx_vah_plain(x, mom, flags, wM, wR)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=rtol,
                                   atol=atol * w.abs().max().item())
        zero = w == 0
        assert torch.equal(g[zero], w[zero])


# --------------------------------------------------------------- K6

def test_polzn_cols_needs_the_vorticity():
    cells = testing.synthetic_surface_cells(5, 2, seed=1)
    with pytest.raises(ValueError, match="thermal vorticity"):
        polzn.polzn_cols(convert.surface_from_state(cells))


POLZN_FAULTS = {None: "needs CUDA tensors", "dtype": "float32 or float64",
          "shape": "need a contiguous", "contiguity": "not contiguous",
          "table": "need a contiguous"}


@pytest.mark.parametrize("fault", list(POLZN_FAULTS), ids=str)
def test_polzn_wrapper_checks_its_arguments(fault):
    """CPU tensors, a wrong dtype, a wrong shape, a non-contiguous tensor
    and a wrong node table each raise before any launch."""
    x, mom, pm, wR, flags, table = testing.polzn_edge_inputs("2d_remap",
                                                             n_cells=9)
    if fault == "dtype":
        x = x.to(torch.int32)
    elif fault == "shape":
        pm = pm[:-1].contiguous()
    elif fault == "contiguity":
        x = x.t().contiguous().t()
    elif fault == "table":
        table = table[:, :, :-1].contiguous()
    counts = (polzn.LAUNCHES, polzn.REMAP_LAUNCHES)
    with pytest.raises(ValueError, match=POLZN_FAULTS[fault]):
        polzn.polzn_cuda(x, mom, pm, wR, flags, table)
    assert counts == (polzn.LAUNCHES, polzn.REMAP_LAUNCHES)
    assert "polzn" not in build._cuda_libs


@pytest.mark.parametrize("case", sorted(testing.POLZN_EDGES))
def test_polzn_edge_inputs_are_what_they_claim(case):
    """On the CPU: the polarization edge cases' plain sums show the edge
    they are named for (shapes off the kernels' blocking, exact zeros
    where exp overflows, the massless species' inf/NaN, inert pad rows,
    |y_flow| > 1)."""
    x, mom, pm, wR, flags, _ = testing.polzn_edge_inputs(case)
    sums = polzn.polzn_plain(x, mom, pm, wR, flags)
    assert testing.polzn_edge_seen(case, x, mom, pm, wR, flags, sums)


def test_polzn_yardstick():
    """The polarization bound's count: 16 FP32 + 2 SFU an evaluation (FP32
    and SFU at the same rate); the remap adds 14 FP32 a (cell, node,
    species, pT), a 24th of them per evaluation on the native grid."""
    assert polzn.polzn_formula_ops(False, 24) == (16.0, 2.0)
    assert 16 / 128 == 2 / 16
    assert polzn.polzn_formula_ops(True, 24) == (16 + 14 / 24, 2.0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("case", sorted(testing.POLZN_EDGES))
def test_polzn_kernel_edges_match_plain_on_gpu(cuda_card, case, dtype):
    """Both polarization kernels' edges against the plain version, each
    of the five sums: f32 at rtol 2e-4 / atol 2e-5 x max, f64 at 1e-10 /
    1e-13 x max over the finite values, the same inf/NaN positions; two
    launches bit-identical, exact zeros kept."""
    rtol, atol = ((2e-4, 2e-5) if dtype == torch.float32
                  else (1e-10, 1e-13))
    x, mom, pm, wR, flags, table = testing.polzn_edge_inputs(
        case, dtype=dtype, device="cuda")
    got, again = (polzn.polzn_cuda(x, mom, pm, wR, flags, table)
                  for _ in range(2))
    want = polzn.polzn_plain(x, mom, pm, wR, flags)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        g, a, w = g.cpu().numpy(), a.cpu().numpy(), w.cpu().numpy()
        np.testing.assert_array_equal(g.view(np.int64 if g.itemsize == 8
                                             else np.int32),
                                      a.view(np.int64 if a.itemsize == 8
                                             else np.int32))
        for f in (np.isnan, np.isposinf, np.isneginf):
            np.testing.assert_array_equal(f(g), f(w))
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=rtol,
                                   atol=atol * np.abs(w[fin]).max())
        zero = w == 0
        np.testing.assert_array_equal(g[zero], w[zero])
