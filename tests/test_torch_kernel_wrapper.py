"""The spectra kernel's wrapper and dispatch, on the CPU: CPU tensors take
the plain version and never load the CUDA library; pack_cells' pad rows are
inert; asking for CUDA without it raises instead of running on the CPU;
unported configurations raise NotImplementedError.  The kernel itself is
checked against the plain version by the gpu-marked tests below and by
chip_smoke.py."""

import numpy as np
import pytest
import torch

from is3d_tpu_torch import cli, testing
from is3d_tpu_torch.api import IS3D
from is3d_tpu_torch.config import Config
from is3d_tpu_torch.io.tables import native_momentum_grid
from is3d_tpu_torch.kernels import smooth
from is3d_tpu_torch.kernels.common import surface_columns, prepare_cells
from is3d_tpu_torch.native import build

torch.set_num_threads(1)


def _inputs(n_cells, dimension, remap, device="cpu", dtype=torch.float64):
    cfg = Config(operation=1, mode=1, dimension=dimension, df_mode=2,
                 include_shear_deltaf=1, include_bulk_deltaf=1, outflow=1)
    surf = testing.synthetic_surface(n_cells, dimension, seed=4, dtype=dtype,
                                     device=device)
    grid = native_momentum_grid(dimension, n_pT=4, n_phi=4, n_y=3, n_eta=6,
                                eta_mT_rescale=remap, dtype=dtype,
                                device=device)
    species = testing.synthetic_species(5, dtype=dtype, device=device)
    df_data = testing.synthetic_deltaf_data(dtype=dtype, device=device)
    return cfg, surf, grid, species, df_data


def _packed(cfg, surf, grid, species, df_data):
    cells = smooth.pack_cells(
        prepare_cells(surface_columns(surf, cfg), cfg, df_data), cfg)
    return (cells, smooth.momentum_constants(species, grid, cfg.dimension),
            smooth.spectra_flags(cfg, grid))


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the GPU: python -m pytest "
                    "tests/test_torch_kernel_wrapper.py -m gpu --noconftest)")


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")


def test_cpu_tensors_take_plain_path_and_never_load_kernel():
    launches = smooth.LAUNCHES
    cfg, surf, grid, species, df_data = _inputs(37, 3, False)
    out = smooth.smooth_spectra(surf, species, grid, df_data, cfg)
    assert out.device.type == "cpu" and torch.isfinite(out).all()
    assert smooth.LAUNCHES == launches
    assert "smooth_spectra" not in build._cuda_libs


@pytest.mark.parametrize("dimension,remap", [(3, False), (2, False),
                                             (2, True)])
def test_pack_cells_pad_rows_are_inert(dimension, remap):
    cells, mom, flags = _packed(*_inputs(5, dimension, remap))
    assert cells.shape == (smooth.CELL_BLOCK, smooth.NF)
    pad = cells[5:]
    assert torch.equal(smooth.smooth_spectra_plain(pad, mom, flags),
                       torch.zeros_like(smooth.smooth_spectra_plain(
                           cells, mom, flags)))
    # the 11 pad rows add zeros to the 5 real cells' sum (the reduction
    # tree over 16 rows rounds differently from the one over 5)
    full = smooth.smooth_spectra_plain(cells, mom, flags)
    torch.testing.assert_close(
        full, smooth.smooth_spectra_plain(cells[:5], mom, flags),
        rtol=1e-14, atol=1e-14 * full.abs().max().item())


def test_kernel_wrapper_rejects_cpu_tensors():
    cells, mom, flags = _packed(*_inputs(5, 3, False))
    launches = smooth.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        smooth.smooth_spectra_cuda(cells, mom, flags)
    assert smooth.LAUNCHES == launches


def test_cuda_device_without_cuda_raises(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        IS3D(Config(), data_dir=str(tmp_path), device="cuda")


def test_cli_defaults_to_cuda_and_raises_without_it(no_cuda, tmp_path):
    run_dir = testing.write_synthetic_run_dir(str(tmp_path), 8, 11, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([run_dir])


@pytest.mark.parametrize("override,slice_name", [
    (dict(operation=0), "slice 7"), (dict(operation=2), "slice 9"),
    (dict(mode=2), "slice 8"), (dict(mode=5), "slice 8"),
    (dict(df_mode=3), "slice 6"), (dict(do_resonance_decays=1), "slice 4"),
])
def test_unported_configurations_raise(override, slice_name):
    with pytest.raises(NotImplementedError, match=slice_name):
        IS3D(Config(**override), device="cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("dimension,remap", [(3, False), (2, False),
                                             (2, True)])
def test_kernel_matches_plain_on_gpu(cuda_card, dimension, remap):
    cells, mom, flags = _packed(*_inputs(203, dimension, remap,
                                         device="cuda"))
    launches = smooth.LAUNCHES
    got = smooth.smooth_spectra_cuda(cells, mom, flags)
    want = smooth.smooth_spectra_plain(cells, mom, flags)
    torch.cuda.synchronize()
    assert smooth.LAUNCHES == launches + 1
    scale = want.abs().max().item()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-10, atol=1e-13 * scale)
