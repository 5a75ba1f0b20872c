"""The kernels' wrappers and dispatch, on the CPU: CPU tensors take the
plain versions and never load the CUDA libraries; pack_cells' pad rows are
inert; every wrapper checks dtype, shape, contiguity and device before a
launch; asking for CUDA without it raises instead of running on the CPU;
unported configurations raise NotImplementedError.  The kernels
themselves are checked against their plain versions by the gpu-marked
tests below and by chip_smoke.py."""

import numpy as np
import pytest
import torch

from is3d_tpu_torch import cli, testing
from is3d_tpu_torch.api import IS3D
from is3d_tpu_torch.config import Config
from is3d_tpu_torch.io.tables import native_momentum_grid
from is3d_tpu_torch.experiments import smooth_proto, dndx_reduce_probe
from is3d_tpu_torch.kernels import smooth, dndx
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
    (dict(operation=0, df_mode=3), "slice 7"), (dict(operation=2), "slice 9"),
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


# ------------------------------------------------- the dN/dX and experiments

def _dndx_inputs(n_cells, dimension, device="cpu", dtype=torch.float64):
    cfg = Config(operation=0, mode=1, dimension=dimension, df_mode=1,
                 include_shear_deltaf=1, include_bulk_deltaf=1, outflow=1,
                 regulate_deltaf=1, tau_bins=12, r_bins=8)
    surf = testing.synthetic_surface(n_cells, dimension, seed=6, dtype=dtype,
                                     device=device)
    grid = native_momentum_grid(dimension, n_pT=4, n_phi=4, n_y=3, n_eta=6,
                                eta_mT_rescale=False, dtype=dtype,
                                device=device)
    species = testing.synthetic_species(5, dtype=dtype, device=device)
    df_data = testing.synthetic_deltaf_data(dtype=dtype, device=device)
    cols = dndx.dndx_cols(surf, cfg)
    cells = smooth.pack_cells(prepare_cells(cols, cfg, df_data), cfg)
    return (cells, smooth.momentum_constants(species, grid, dimension),
            smooth.spectra_flags(cfg, grid), dndx.momentum_weights(grid, cfg),
            dndx.node_weights(grid, dimension),
            dndx.bin_plan(cols["tau"], cols["x"], cols["y"], cfg))


def test_dndx_cpu_tensors_take_plain_path_and_never_load_kernel():
    launches = (dndx.LAUNCHES, dndx.BIN_LAUNCHES)
    cfg = Config(operation=0, mode=1, dimension=2, df_mode=2,
                 include_shear_deltaf=1)
    dX = dndx.spacetime_distributions(
        testing.synthetic_surface(21, 2, seed=2),
        testing.synthetic_species(4),
        native_momentum_grid(2, n_pT=3, n_phi=4, n_eta=5),
        testing.synthetic_deltaf_data(), cfg)
    assert np.isfinite(dX["dN_dy"]).all() and (dX["dN_dy"] > 0).all()
    assert (dndx.LAUNCHES, dndx.BIN_LAUNCHES) == launches
    assert "dndx" not in build._cuda_libs


def _wrapper_calls(dtype=torch.float64, fault=None):
    """(name, thunk) for every new wrapper on CPU inputs, with ``fault``
    applied to the first tensor argument: None, "dtype", "shape" or
    "contiguity"."""
    def spoil(t):
        if fault == "dtype":
            return t.to(torch.int32) if t.dtype.is_floating_point else t
        if fault == "shape":
            return t[:-1] if t.dim() == 1 else t[:, :-1]
        if fault == "contiguity":
            return (torch.stack([t, t], -1)[..., 0] if t.dim() > 1
                    else torch.stack([t, t], -1)[:, 0])
        return t

    cells, mom, flags, wM, wR, plan = _dndx_inputs(20, 2, dtype=dtype)
    per_cell = torch.rand(cells.shape[0], 5, dtype=dtype)
    proto = smooth_proto.proto_inputs(8, S=32, P=2, F=3, Y=2, dtype=dtype)
    probe = dndx_reduce_probe.probe_inputs(6, 3, 4, 5, dtype=dtype)
    return {
        "dndx": lambda: dndx.dndx_cuda(spoil(cells), mom, flags, wM, wR),
        "dndx_wM": lambda: dndx.dndx_cuda(cells, mom, flags, spoil(wM), wR),
        "dndx_bin": lambda: dndx.dndx_bin_cuda(spoil(per_cell), plan),
        "smooth_proto": lambda: smooth_proto.proto_spectra_cuda(
            spoil(proto["cells"]), *(proto[n] for n in smooth_proto.ARGS[1:])),
        "smooth_proto_mTf": lambda: smooth_proto.proto_spectra_cuda(
            proto["cells"], spoil(proto["mTf"]),
            *(proto[n] for n in smooth_proto.ARGS[2:])),
        "dndx_probe": lambda: dndx_reduce_probe.percell_probe_cuda(
            spoil(probe["a"]), probe["b"], probe["w"], probe["wM"],
            probe["wR"]),
        "dndx_probe_w": lambda: dndx_reduce_probe.percell_probe_cuda(
            probe["a"], probe["b"], spoil(probe["w"]), probe["wM"],
            probe["wR"]),
    }


WRAPPERS = sorted(_wrapper_calls())
FAULTS = {None: "needs CUDA tensors", "dtype": "float32 or float64|int32",
          "shape": "need a contiguous|must be", "contiguity": "not contiguous"}


@pytest.mark.parametrize("fault", list(FAULTS), ids=str)
@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_new_wrappers_check_their_arguments(wrapper, fault):
    """CPU tensors, a wrong dtype, a wrong shape and a non-contiguous
    tensor each raise before any launch (the device is checked last, so a
    CPU call reaches every other check)."""
    counts = (dndx.LAUNCHES, dndx.BIN_LAUNCHES, smooth_proto.LAUNCHES,
              dndx_reduce_probe.LAUNCHES)
    with pytest.raises(ValueError, match=FAULTS[fault]):
        _wrapper_calls(fault=fault)[wrapper]()
    assert counts == (dndx.LAUNCHES, dndx.BIN_LAUNCHES, smooth_proto.LAUNCHES,
                      dndx_reduce_probe.LAUNCHES)
    assert not {"dndx", "smooth_proto"} & set(build._cuda_libs)


def test_cell_split_covers_every_cell_in_whole_tiles():
    for n_cells, n_species in ((1, 1), (15, 320), (777, 40), (8192, 320),
                               (176, 320), (100000, 3)):
        per, n_split = dndx.cell_split(n_cells, n_species)
        assert per % 16 == 0 and per * n_split >= n_cells
        assert per * (n_split - 1) < n_cells


@pytest.mark.gpu
@pytest.mark.parametrize("dimension", [2, 3])
def test_dndx_kernels_match_plain_on_gpu(cuda_card, dimension):
    cells, mom, flags, wM, wR, plan = _dndx_inputs(203, dimension,
                                                   device="cuda")
    launches = (dndx.LAUNCHES, dndx.BIN_LAUNCHES)
    got = dndx.dndx_cuda(cells, mom, flags, wM, wR)
    want = dndx.dndx_plain(cells, mom, flags, wM, wR)
    hist = dndx.dndx_bin_cuda(want[0], plan)
    hist_want = dndx.dndx_bin_plain(want[0], plan)
    again = dndx.dndx_cuda(cells, mom, flags, wM, wR)
    torch.cuda.synchronize()
    assert (dndx.LAUNCHES, dndx.BIN_LAUNCHES) == (launches[0] + 2,
                                                  launches[1] + 1)
    for g, w in ((got[0], want[0]), (got[1], want[1]), (hist, hist_want)):
        scale = w.abs().max().item()
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=1e-10, atol=1e-13 * scale)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.gpu
def test_experiment_kernels_match_plain_on_gpu(cuda_card):
    x = smooth_proto.proto_inputs(40, S=64, P=3, F=4, Y=3,
                                  dtype=torch.float64, device="cuda")
    args = [x[n] for n in smooth_proto.ARGS]
    got = smooth_proto.proto_spectra_cuda(*args)
    want = smooth_proto.proto_spectra_plain(*args)
    y = dndx_reduce_probe.probe_inputs(30, 6, 9, 40, dtype=torch.float64,
                                       device="cuda")
    yargs = [y[k] for k in ("a", "b", "w", "wM", "wR")]
    pgot = dndx_reduce_probe.percell_probe_cuda(*yargs)
    pwant = dndx_reduce_probe.percell_probe_plain(*yargs)
    torch.cuda.synchronize()
    for g, w in ((got, want), *zip(pgot, pwant)):
        scale = w.abs().max().item()
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=1e-10, atol=1e-13 * scale)


def test_cuda_cache_key_covers_every_header(tmp_path, monkeypatch):
    """A kernel's cached library path changes when its source or any
    csrc/*.cuh header changes, so a header edit cannot load a stale
    library."""
    monkeypatch.setattr(build, "_CSRC", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    first = build._cuda_paths("k")[1]
    assert build._cuda_paths("k")[1] == first
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = build._cuda_paths("k")[1]
    (tmp_path / "other.cuh").write_text("// new header\n")
    third = build._cuda_paths("k")[1]
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edit\n')
    assert len({first, second, third, build._cuda_paths("k")[1]}) == 4
