"""The kernels' wrappers and dispatch, on the CPU: CPU tensors take the
plain versions and never load the CUDA libraries; pack_cells' pad rows are
inert; every wrapper checks dtype, shape, contiguity and device before a
launch; asking for CUDA without it raises instead of running on the CPU;
configurations that once raised NotImplementedError now run.  The kernels
themselves are checked against their plain versions by the gpu-marked
tests below and by chip_smoke.py."""

import dataclasses

import numpy as np
import pytest
import torch

from is3d_tpu_torch import cli, testing
from is3d_tpu_torch.api import IS3D
from is3d_tpu_torch.config import Config
from is3d_tpu_torch.io.surface import surface_from_arrays
from is3d_tpu_torch.io.tables import native_momentum_grid
from is3d_tpu_torch.experiments import smooth_proto, dndx_reduce_probe
from is3d_tpu_torch.kernels import smooth, dndx, decays, feqmod
from is3d_tpu_torch.kernels.common import surface_columns, prepare_cells
from is3d_tpu_torch.kernels.launch import (launch, split_to_fill,
                                           KernelGrid, tile_split)
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


OP2_CASES = [
    (dict(operation=2, mode=2, df_mode=3), "slice 9"),
    (dict(operation=2, sampler_alias=0), "slice 9"),
    (dict(operation=2, mode=2), "slice 9"),
    (dict(operation=2, mode=3), "slice 9"),
    (dict(operation=2, df_mode=3, sampler_alias=0), "slice 9"),
    (dict(operation=2, do_resonance_decays=1, df_mode=4, mode=3), "slice 9"),
]


def _op2_run_dir(path, override, seed=None):
    params = dict(override, oversample=1, min_num_hadrons=200)
    if seed is not None:
        params["sampler_seed"] = seed
    return testing.write_synthetic_run_dir(
        path, 24, 24 if override.get("do_resonance_decays") else 7, 2,
        seed=1, mode=override.get("mode", 1),
        decays=bool(override.get("do_resonance_decays")), params=params)


@pytest.fixture(scope="module")
def op2_mesh(tmp_path_factory):
    """Each OP2_CASES configuration in one process and over 2 gloo ranks
    (one spawn), seeded: the events of each."""
    root = tmp_path_factory.mktemp("op2_mesh")
    runs, one = [], []
    for i, (override, _) in enumerate(OP2_CASES):
        d = _op2_run_dir(str(root / f"c{i}"), override, seed=11)
        runs.append(dict(name=i, run_dir=d, overrides={},
                         results_dir=str(root / f"mesh{i}")))
        one.append(IS3D.from_run_dir(d, device="cpu").run_particlization(
            write_files=False).events)
    ranks = testing.run_ranks(testing.mesh_api_rank, 2, str(root / "w"),
                              args=(runs, False), timeout=240.0)
    return one, [[e for res in ranks for e in res[i]["events"]]
                 for i in range(len(OP2_CASES))]


@pytest.mark.parametrize("override,slice_name", OP2_CASES)
def test_unported_configurations_raise(override, slice_name, tmp_path,
                                       op2_mesh):
    """Operation 2 on VAH surfaces and with the binary-search draws, which
    raised NotImplementedError naming ``slice_name`` until that slice
    (9, second half) ported them: each configuration now builds and runs
    on a small run directory; under mesh= (NotImplementedError until pod
    mode was ported) the ranks' slices concatenate to the one-process
    events byte for byte."""
    run_dir = _op2_run_dir(str(tmp_path), override)
    result = IS3D(Config(**override), data_dir=run_dir,
                  device="cpu").run_particlization(write_files=False)
    assert sum(len(e["mcid"]) for e in result.events) > 0
    assert result.sample_info["total_yield"] > 0
    one, mesh = (x[OP2_CASES.index((override, slice_name))]
                 for x in op2_mesh)
    assert len(one) >= 2 and testing.same_events(mesh, one)


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


@pytest.mark.gpu
@pytest.mark.parametrize("f64", [False, True])
def test_remap_grid_on_gpu(cuda_card, f64):
    """The grids the CPU test of the cell split assumes are those the C
    side reports, a given node table gives the same bits as the one the
    wrapper builds, and a part count that is not the grid's is refused
    before anything is written."""
    lib = smooth._spectra_library()
    dev = torch.device("cuda")
    for (S, P, F, R), (blocks, chunks, width) in REMAP_GRIDS.items():
        for df_mode in (1, 2):
            grid = smooth.remap_grid(lib, dev, f64, S, P, F, R, df_mode)
            assert (grid.blocks, grid.node_chunks, grid.tile, grid.max_split,
                    grid.phi_width) == (blocks, chunks, 8, 64, width)
            assert grid.slots >= torch.cuda.get_device_properties(
                dev).multi_processor_count
    dtype = torch.float64 if f64 else torch.float32
    cells, mom, flags = _packed(*_inputs(203, 2, True, dtype=dtype,
                                         device="cuda"))
    table = smooth.remap_node_table(mom)
    assert torch.equal(smooth.smooth_spectra_cuda(cells, mom, flags, table),
                       smooth.smooth_spectra_cuda(cells, mom, flags))
    S, P, Fn, R = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi, \
        mom.nodes.shape[0]
    grid = smooth.remap_grid(lib, dev, f64, S, P, Fn, R, flags.df_mode)
    per, n_split = smooth.remap_cell_split(cells.shape[0], grid)
    out = torch.zeros((S, P, Fn, 1), dtype=dtype, device=dev)
    partial = torch.zeros((n_split * grid.node_chunks + 1, S, P, Fn),
                          dtype=dtype, device=dev)
    fn = (lib.is3d_smooth_spectra_remap_f64 if f64
          else lib.is3d_smooth_spectra_remap_f32)
    with pytest.raises(RuntimeError, match="invalid argument"):
        launch(lib, "smooth_spectra remap", fn, dev, cells.data_ptr(),
               cells.shape[0], smooth.NF, mom.mass.data_ptr(),
               mom.sign.data_ptr(), mom.baryon.data_ptr(),
               mom.degeneracy.data_ptr(), S, mom.pT.data_ptr(), P,
               mom.cos_phi.data_ptr(), mom.sin_phi.data_ptr(), Fn,
               table.data_ptr(), mom.weights.data_ptr(), R, flags.df_mode,
               int(flags.regulate), int(flags.outflow), 1.0,
               smooth.ETA_REMAP_T_REF, per, partial.shape[0],
               partial.data_ptr(), out.data_ptr())
    torch.cuda.synchronize()
    assert not partial.any() and not out.any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("case", sorted(testing.SPECTRA_EDGES))
def test_kernel_edges_match_plain_on_gpu(cuda_card, case, dtype):
    """The spectra kernels' edges (testing.SPECTRA_EDGES, fixed nodes and
    the 2+1D remap) against the plain version: f32 at rtol 2e-4 / atol 2e-5
    x max (approximate exp and reciprocal, another summation order), f64 at
    rtol 1e-10 / atol 1e-13 x max; two launches bit-identical, exact zeros
    kept."""
    rtol, atol = ((2e-4, 2e-5) if dtype == torch.float32
                  else (1e-10, 1e-13))
    cells, mom, flags = testing.spectra_edge_inputs(case, dtype=dtype,
                                                    device="cuda")
    got = smooth.smooth_spectra_cuda(cells, mom, flags)
    again = smooth.smooth_spectra_cuda(cells, mom, flags)
    want = smooth.smooth_spectra_plain(cells, mom, flags)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    scale = want.abs().max().item()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=rtol, atol=atol * scale)
    zero = want == 0
    assert torch.equal(got[zero], want[zero])
    if case.endswith("overflow"):
        assert zero.any()


@pytest.mark.parametrize("case", sorted(testing.SPECTRA_EDGES))
def test_kernel_edge_inputs_are_what_they_claim(case):
    """On the CPU: the edge cases' plain spectra are finite and show the
    edge they are named for (exact zeros where exp overflows, an active
    clip, light bosons, shapes off the kernels' blocking; with the 2+1D
    remap also flow rapidities up to 2, s(mT) clamped to 1 and inert pad
    rows)."""
    cells, mom, flags = testing.spectra_edge_inputs(case)
    out = smooth.smooth_spectra_plain(cells, mom, flags)
    assert testing.spectra_edge_seen(case, cells, mom, flags, out)


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
    remap = dataclasses.replace(flags, remap=True)
    per_cell = torch.rand(cells.shape[0], 5, dtype=dtype)
    proto = smooth_proto.proto_inputs(8, S=32, P=2, F=3, Y=2, dtype=dtype)
    probe = dndx_reduce_probe.probe_inputs(6, 3, 4, 5, dtype=dtype)
    tables, tasks, wg, n_seg = testing.decay_edge_inputs("2body_2d",
                                                         dtype=dtype)
    acc = torch.zeros((n_seg,) + tables.logdN.shape[1:], dtype=torch.float64)
    fx, frn, fwcs, fmom, fflags, fwM, fwR = testing.feqmod_edge_inputs(
        "3d_df4_mixed", n_cells=9, n_species=5, dtype=dtype)
    rx, rrn, rwcs, rmom, rflags, _, _ = testing.feqmod_edge_inputs(
        "2d_remap_df3_mixed", n_cells=9, n_species=5, dtype=dtype)
    return {
        "feqmod": lambda: feqmod.feqmod_spectra_cuda(spoil(fx), frn, fwcs,
                                                     fmom, fflags),
        "feqmod_rn": lambda: feqmod.feqmod_spectra_cuda(fx, spoil(frn), fwcs,
                                                        fmom, fflags),
        "feqmod_remap_wcs": lambda: feqmod.feqmod_spectra_cuda(
            rx, rrn, spoil(rwcs), rmom, rflags),
        "feqmod_remap_table": lambda: feqmod.feqmod_spectra_cuda(
            rx, rrn, rwcs, rmom, rflags,
            spoil(smooth.remap_node_table(rmom))),
        "dndx_feqmod": lambda: dndx.dndx_feqmod_cuda(
            spoil(fx), frn, fwcs, fmom, fflags, fwM, fwR),
        "dndx_feqmod_wR": lambda: dndx.dndx_feqmod_cuda(
            fx, frn, fwcs, fmom, fflags, fwM, spoil(fwR)),
        "decay_wave": lambda: decays.decay_wave_cuda(
            dataclasses.replace(tables, logdN=spoil(tables.logdN)), tasks,
            wg, acc),
        "decay_wave_par": lambda: decays.decay_wave_cuda(
            tables, dataclasses.replace(tasks, par=spoil(tasks.par)), wg,
            acc),
        "decay_wave_acc": lambda: decays.decay_wave_cuda(
            tables, tasks, wg, spoil(acc)),
        "smooth_spectra_remap": lambda: smooth.smooth_spectra_cuda(
            spoil(cells), mom, remap),
        "smooth_spectra_remap_cos": lambda: smooth.smooth_spectra_cuda(
            cells, dataclasses.replace(mom, cos_phi=spoil(mom.cos_phi)),
            remap),
        "smooth_spectra_remap_table": lambda: smooth.smooth_spectra_cuda(
            cells, mom, remap, spoil(smooth.remap_node_table(mom))),
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
    current = lambda: (smooth.LAUNCHES, smooth.REMAP_LAUNCHES, dndx.LAUNCHES,
                       dndx.BIN_LAUNCHES, smooth_proto.LAUNCHES,
                       dndx_reduce_probe.LAUNCHES, decays.TWO_BODY_LAUNCHES,
                       decays.THREE_BODY_LAUNCHES, feqmod.LAUNCHES,
                       feqmod.REMAP_LAUNCHES, dndx.FEQMOD_LAUNCHES)
    counts = current()
    with pytest.raises(ValueError, match=FAULTS[fault]):
        _wrapper_calls(fault=fault)[wrapper]()
    assert counts == current()
    assert not {"smooth_spectra", "dndx", "smooth_proto", "decays",
                "feqmod"} & set(build._cuda_libs)


SLOTS = (1, 7, 264, 528, 1056, 10 ** 6)


def test_cell_split_covers_every_cell_in_whole_tiles():
    """Whatever the card's resident-block count, the dN/dX kernel's split
    is whole batches of cells, covers every cell once, and only its last
    range is short."""
    for n_cells in (1, 15, 16, 176, 777, 8192, 65536):
        for n_species, n_nodes in ((1, 1), (320, 48), (41, 13), (7, 5),
                                   (3, 384)):
            batch = dndx.cells_per_batch(n_nodes)
            assert batch == 128 // -(-n_nodes // 3)
            for slots in SLOTS:
                per, n_split = dndx.cell_split(n_cells, n_species, n_nodes,
                                               slots)
                assert per % batch == 0 and 1 <= n_split <= 1024
                assert per * (n_split - 1) < n_cells <= per * n_split
    # the operation-0 main-path group on an H100 at 4 blocks per SM: 13
    # ranges of 79 batches, 1040 blocks in two waves of 528
    assert dndx.cell_split(8192, 320, 48, 528) == (632, 13)
    with pytest.raises(ValueError, match="rapidity nodes"):
        dndx.cells_per_batch(385)


# (S, P, F, R): (blocks for each range of cells, chunks of nodes, angles per
# thread) of the remap kernel's grid
REMAP_GRIDS = {(320, 32, 24, 48): (80 * 1 * 4, 4, 24),
               (41, 11, 13, 13): (8, 2, 16), (5, 4, 4, 6): (1, 1, 8),
               (7, 8, 6, 12): (1, 1, 8), (40, 8, 32, 25): (3 * 2 * 3, 3, 16),
               (1, 1, 48, 241): (2 * 21, 21, 24)}


@pytest.mark.parametrize("n_cells", [0, 1, 7, 8, 16, 777, 16384, 131072])
def test_remap_cell_split_covers_every_cell_in_whole_tiles(n_cells):
    """Whatever the card's resident-block count, the remap kernel's split
    is whole tiles, covers every cell once, and only its last range is
    short.  The grids are those the C side reports for these shapes (blocks
    of 128 (species, pT) pairs x chunks of angles x chunks of 12 nodes,
    tiles of 8 cells, at most 64 ranges; test_remap_grid_on_gpu holds them
    against it)."""
    for blocks, chunks, width in REMAP_GRIDS.values():
        for slots in SLOTS:
            grid = smooth.RemapGrid(blocks, slots, chunks, 8, 64, width)
            per, n_split = smooth.remap_cell_split(n_cells, grid)
            assert per % 8 == 0 and 1 <= n_split <= 64
            assert per * (n_split - 1) < max(n_cells, 1) <= per * n_split
    # a main-path group on an H100 at 5 blocks per SM: 33 ranges of 63
    # tiles x 4 node chunks x 80 blocks = 10560 blocks in 16 waves of 660
    # (2 ranges, 640 blocks in one wave, measured 6.9 % slower)
    main = smooth.RemapGrid(320, 660, 4, 8, 64, 24)
    assert smooth.remap_cell_split(16384, main) == (504, 33)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_remap_node_table_equals_its_definition(dtype):
    """The table smooth_spectra_cuda prepacks for the remap kernel: exp(-s
    eta_r) and exp(+s eta_r) per (species, pT, node) with s = sqrt(T_ref /
    max(mT, T_ref)), so that cosh and sinh of Delta = y_flow - s eta_r are
    sums of products with exp(+-y_flow)."""
    cells, mom, flags = _packed(*_inputs(5, 2, True, dtype=dtype))
    table = smooth.remap_node_table(mom)
    S, P, R = 5, 4, 6
    assert table.shape == (S, P, R, 2) and table.dtype == dtype
    assert table.is_contiguous()
    s = smooth.remap_scale(mom)
    for i in range(S):
        for p in range(P):
            mT = torch.sqrt(mom.mass[i] ** 2 + mom.pT[p] ** 2)
            assert s[i, p] == torch.sqrt(smooth.ETA_REMAP_T_REF / torch.clamp(
                mT, min=smooth.ETA_REMAP_T_REF))
            assert torch.equal(table[i, p, :, 0],
                               torch.exp(-(s[i, p] * mom.nodes)))
            assert torch.equal(table[i, p, :, 1],
                               torch.exp(s[i, p] * mom.nodes))
    assert (s <= 1).all() and (s[mom.mass < 0.14] < 1).any()
    # cosh and sinh of Delta from the table and exp(+-y_flow)
    yflow = cells[:, smooth.IDX["yflow"]].view(-1, 1, 1, 1)
    delta = yflow - s[None, :, :, None] * mom.nodes
    ep = torch.exp(yflow) * table[None, ..., 0]
    em = torch.exp(-yflow) * table[None, ..., 1]
    tol = 1e-5 if dtype == torch.float32 else 1e-13
    torch.testing.assert_close(0.5 * (ep + em), torch.cosh(delta), rtol=tol,
                               atol=0)
    torch.testing.assert_close(0.5 * (ep - em), torch.sinh(delta), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("n_cells", [0, 1, 15, 16, 1024, 32768])
def test_proto_cell_split_covers_every_cell_in_whole_tiles(n_cells):
    for blocks in (1, 80, 3360):
        for slots in SLOTS:
            per, n_split = smooth_proto.cell_split(n_cells, blocks, slots)
            assert per % 32 == 0 and 1 <= n_split <= 8
            assert per * (n_split - 1) < max(n_cells, 1) <= per * n_split
    # the prototype's own shape on an H100 at 4 blocks per SM
    assert smooth_proto.cell_split(32768, 3360, 528) == (16384, 2)


@pytest.mark.parametrize("n_units,blocks,slots,max_split", [
    (1, 80, 528, 1024), (22, 80, 528, 1024), (1024, 80, 528, 1024),
    (1024, 3360, 528, 8), (8192, 80, 528, 1024), (100, 1, 528, 64),
    (77, 13, 5, 16), (1000, 600, 528, 4)])
def test_split_to_fill_is_the_fewest_splits_near_the_best(n_units, blocks,
                                                          slots, max_split):
    per, n_split = split_to_fill(n_units, blocks, slots, max_split)
    assert 1 <= n_split <= max_split
    assert per * (n_split - 1) < n_units <= per * n_split

    def cost(k):
        p = -(-n_units // k)
        return -(-blocks * -(-n_units // p) // slots) * p
    best = min(cost(k) for k in range(1, min(max_split, n_units) + 1))
    assert cost(n_split) <= 1.02 * best
    assert all(cost(k) > 1.02 * best for k in range(1, n_split)
               if -(-n_units // -(-n_units // k)) == k)
    with pytest.raises(ValueError, match="positive"):
        split_to_fill(n_units, blocks, 0, max_split)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_emission_tables_equal_their_definition(dtype):
    """The tables dndx_cuda prepacks for its kernel: one row per species,
    (species, pT) and momentum point, padded to 16-byte loads."""
    cells, mom, flags, wM, wR, _ = _dndx_inputs(20, 2, dtype=dtype)
    species, mt, points = dndx.emission_tables(mom, wM)
    S, P, M = 5, 4, 16
    assert species.shape == (S, 4) and mt.shape == (S, P, 2)
    assert points.shape == (M, 8)
    assert all(t.dtype == dtype and t.is_contiguous()
               for t in (species, mt, points))
    for s in range(S):
        assert species[s].tolist() == [(mom.mass[s] ** 2).item(),
                                       mom.sign[s].item(),
                                       mom.baryon[s].item(), 0.0]
        for p in range(P):
            mT2 = mom.mass[s] ** 2 + mom.pT[p] ** 2
            assert mt[s, p, 1] == mT2 and mt[s, p, 0] == torch.sqrt(mT2)
    for m in range(M):
        px, py = mom.px[m], mom.py[m]
        assert points[m].tolist() == [px.item(), py.item(), (px * px).item(),
                                      (py * py).item(), (px * py).item(),
                                      wM[m].item(), 0.0, 0.0]


@pytest.mark.parametrize("case", sorted(testing.DNDX_EDGES))
def test_dndx_edge_inputs_are_what_they_claim(case):
    """On the CPU: the dN/dX edge cases' plain outputs are finite and show
    the edge they are named for (shapes off the kernel's blocking, fewer
    rows than a batch, exact zeros where exp overflows, an active clip,
    light bosons, inert pad rows)."""
    x = testing.dndx_edge_inputs(case)
    out = dndx.dndx_plain(*x)
    assert testing.dndx_edge_seen(case, *x, *out)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("case", sorted(testing.DNDX_EDGES))
def test_dndx_kernel_edges_match_plain_on_gpu(cuda_card, case, dtype):
    """The dN/dX kernel's edges (testing.DNDX_EDGES) against the plain
    version: f32 at rtol 2e-4 / atol 2e-5 x max (approximate exp and
    reciprocal, another summation order), f64 at rtol 1e-10 / atol 1e-13 x
    max; two launches bit-identical, exact zeros kept."""
    rtol, atol = ((2e-4, 2e-5) if dtype == torch.float32
                  else (1e-10, 1e-13))
    x = testing.dndx_edge_inputs(case, dtype=dtype, device="cuda")
    got, again, want = dndx.dndx_cuda(*x), dndx.dndx_cuda(*x), \
        dndx.dndx_plain(*x)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=rtol,
                                   atol=atol * w.abs().max().item())
        zero = w == 0
        assert torch.equal(g[zero], w[zero])
    if case == "3d_overflow":
        assert (want[1] == 0).any()


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
@pytest.mark.parametrize("case", sorted(testing.BIN_EDGES))
def test_bin_kernel_edges_match_plain_on_gpu(cuda_card, case):
    per_cell, plan = testing.bin_edge_inputs(case, device="cuda")
    got = dndx.dndx_bin_cuda(per_cell, plan)
    again = dndx.dndx_bin_cuda(per_cell, plan)
    want = dndx.dndx_bin_plain(per_cell, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-12, atol=1e-13)


def test_bin_edge_plans_have_their_edges():
    """On the CPU: the binning edge cases hold empty bins, bins longer than
    a slice, a (tau) bin of every cell, and a group shorter than a slice,
    and the plain version sums every bin."""
    seen = set()
    for case in testing.BIN_EDGES:
        per_cell, plan = testing.bin_edge_inputs(case)
        counts = torch.diff(plan.start)
        n = per_cell.shape[0]
        seen |= {"empty"} if (counts == 0).any() else set()
        seen |= {"long"} if (counts[:-1] > 64).any() else set()
        seen |= {"every"} if (counts[:-1] == n).any() else set()
        seen |= {"short"} if n < 64 else set()
        hist = dndx.dndx_bin_plain(per_cell, plan)
        torch.testing.assert_close(hist[:, -1], per_cell.sum(0))
    assert seen == {"empty", "long", "every", "short"}


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


def test_bound_yardstick_is_shared():
    """K1, the dN/dX kernel and P1 take their bounds from one count of the
    emission formula, with its per-cell factors hoisted: each kernel adds
    one sum over cells or points, P1 is K1's at df 2.  df 1 is FP32-bound,
    df 2 and the probe SFU-bound (SFU has 16 lanes to FP32's 128)."""
    assert smooth.EMISSION_OPS == {1: (18, 2), 2: (18, 3)}
    for df, (fp32, sfu) in smooth.EMISSION_OPS.items():
        assert smooth.FORMULA_OPS[df] == (fp32 + 1, sfu)
    assert dndx.FORMULA_OPS == smooth.FORMULA_OPS
    assert smooth_proto.BOUND_OPS == smooth.FORMULA_OPS[2]
    rate = lambda ops: max(ops[0] / 128, ops[1] / 16)
    assert rate(smooth.FORMULA_OPS[1]) == 19 / 128
    assert rate(smooth.FORMULA_OPS[2]) == 3 / 16
    assert rate(dndx_reduce_probe.BOUND_OPS) == 2 / 16
    # the 2+1D remap adds its node kinematics once per (cell, node, species,
    # pT): a 24th of 18 FP32 per evaluation on the native grid, and no SFU
    # operation (its two exponentials have fewer indices and are hoisted)
    assert smooth.REMAP_NODE_OPS == (18, 0)
    assert smooth.remap_formula_ops(2, 24) == (19 + 18 / 24, 3)
    assert smooth.remap_formula_ops(1, 1) == (19 + 18, 2)
    assert rate(smooth.remap_formula_ops(2, 24)) == 3 / 16


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


def test_decays_cpu_tensors_take_plain_path_and_never_load_kernel():
    counts = (decays.TWO_BODY_LAUNCHES, decays.THREE_BODY_LAUNCHES)
    table, mcids = testing.synthetic_decaying_table(24)
    grid = native_momentum_grid(2, n_pT=4, n_phi=4, n_eta=4)
    spectra = torch.as_tensor(testing.thermal_spectra(table, mcids, grid, 2))
    out = decays.do_resonance_decays(spectra, table, mcids, grid,
                                     Config(dimension=2))
    assert out.device.type == "cpu" and (out >= spectra).all()
    assert (out > spectra).any()
    assert (decays.TWO_BODY_LAUNCHES, decays.THREE_BODY_LAUNCHES) == counts
    assert "decays" not in build._cuda_libs


@pytest.mark.parametrize("case", sorted(testing.DECAY_EDGES))
def test_decay_edge_inputs_are_what_they_claim(case):
    """The wave kernel's edge cases show their edges in the plain output
    (tail nodes, wrapped Phi, massless daughters, rows fed by many tasks,
    a parent at the floor, exact zeros beyond |y_max|)."""
    x = testing.decay_edge_inputs(case)
    testing.decay_edge_seen(case, *x, decays.wave_plain(*x))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("case", sorted(testing.DECAY_EDGES))
def test_decay_wave_edges_match_plain_on_gpu(cuda_card, case, dtype):
    """The wave kernel against its plain version on every edge case, f32 at
    rtol 2e-4 / atol 2e-5 x max, f64 at rtol 1e-10 / atol 1e-13 x max;
    exact zeros kept; two launches bit-identical."""
    tables, tasks, wg, n_seg = testing.decay_edge_inputs(case, dtype=dtype,
                                                         device="cuda")
    acc = torch.zeros((n_seg,) + tables.logdN.shape[1:], dtype=torch.float64,
                      device="cuda")
    again = torch.zeros_like(acc)
    launches = decays.TWO_BODY_LAUNCHES + decays.THREE_BODY_LAUNCHES
    decays.decay_wave_cuda(tables, tasks, wg, acc)
    decays.decay_wave_cuda(tables, tasks, wg, again)
    want = decays.wave_plain(tables, tasks, wg, n_seg).double()
    torch.cuda.synchronize()
    assert (decays.TWO_BODY_LAUNCHES + decays.THREE_BODY_LAUNCHES
            == launches + 2)
    testing.decay_edge_seen(case, tables, tasks, wg, n_seg, want)
    rtol, atol = (2e-4, 2e-5) if dtype == torch.float32 else (1e-10, 1e-13)
    np.testing.assert_allclose(acc.cpu().numpy(), want.cpu().numpy(),
                               rtol=rtol,
                               atol=atol * want.abs().max().item())
    assert torch.equal(acc, again)
    assert (acc[want == 0] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dimension", [2, 3])
def test_decay_cascade_cuda_matches_cpu_on_gpu(cuda_card, dimension):
    """The whole cascade on the card (f64 kernel) against the CPU's plain
    waves, and in f32 against f64 to the waves' float32 accuracy."""
    table, mcids = testing.synthetic_decaying_table(40)
    grid = native_momentum_grid(dimension, n_pT=8, pT_max=3.0, n_phi=8,
                                n_y=5, n_eta=4)
    spectra = torch.as_tensor(testing.thermal_spectra(table, mcids, grid,
                                                      dimension))
    cfg = Config(dimension=dimension)
    cpu = decays.do_resonance_decays(spectra, table, mcids, grid, cfg)
    gpu = decays.do_resonance_decays(spectra.cuda(), table, mcids,
                                     grid.to("cuda"), cfg)
    f32 = decays.do_resonance_decays(spectra.float().cuda(), table, mcids,
                                     grid.to("cuda", torch.float32), cfg)
    scale = cpu.abs().amax(dim=(1, 2, 3), keepdim=True)
    assert ((gpu.cpu() - cpu).abs() <= 1e-10 * cpu.abs() + 1e-13 * scale).all()
    assert ((f32.cpu() - cpu).abs() <= 1e-4 * scale).all()


PHI_GRIDS = [("gauss_legendre", n) for n in (6, 7, 12, 24, 31, 48)] + [
    ("ragged", testing._RAGGED["n_phi"]), ("decay_edges", 9)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("kind,n_phi", PHI_GRIDS)
def test_phi_bucket_lookup_matches_searchsorted(kind, n_phi, dtype):
    """The wave kernel's phi lookup (padded grid, uniform buckets, one
    compare; decays.phi_cell_lookup mirrors it) finds the interval that
    torch.searchsorted and the wrap-cell rule of _interp_phi_indices find,
    on random angles, angles exactly on the nodes and angles in the wrap
    cell on both sides; on a node the two may take the neighbouring
    intervals, and the interpolated value agrees (f32 to 1e-4 of a unit
    table: the wrap cell's shift by 2 pi rounds at 4.8e-7 rad)."""
    grid = native_momentum_grid(2, n_pT=4, n_phi=n_phi, n_eta=4)
    phi = grid.phi.to(dtype).contiguous()
    cells = [torch.as_tensor(a) for a in decays.phi_cells(grid.phi.numpy(),
                                                          512)]
    assert cells[2].shape[0] <= 512
    pad, invd = (a.to(dtype) for a in cells[:2])
    rng = np.random.default_rng(n_phi)
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    Pw = torch.cat([t(rng.uniform(0, 2 * np.pi, 5000)), phi,
                    t(rng.uniform(0, float(phi[0]), 200)),
                    t(rng.uniform(float(phi[-1]), 2 * np.pi, 200))])
    Pw = Pw[Pw < decays.TWO_PI]
    iL, iR, _, w = decays._interp_phi_indices(phi, Pw)
    jL, jR, u = decays.phi_cell_lookup(Pw, pad, invd, cells[2])
    same = (iL == jL) & (iR == jR)
    on_node = (Pw[:, None] == phi).any(1)
    assert bool((same | on_node).all())
    assert int(same.sum()) > Pw.shape[0] - phi.shape[0] - 1
    # the weight lies in [0, 1] up to the rounding of (Pw - left) / width
    eps = 1e-5 if dtype == torch.float32 else 1e-12
    assert bool(((u >= -eps) & (u <= 1 + eps)).all())
    v = t(rng.normal(size=phi.shape[0]))
    err = (v[iL] * (1 - w) + v[iR] * w - v[jL] * (1 - u) - v[jR] * u).abs()
    assert err.max().item() < (1e-4 if dtype == torch.float32 else 1e-12)


def test_phi_bucket_table_raises_where_it_cannot_bucket():
    """Two grid points closer than 2 pi / max_buckets leave no bucket
    table with one point a bucket: the host raises."""
    phi = np.linspace(0.1, 6.0, 10)
    decays.phi_cells(phi, 512)
    phi[4] = phi[3] + 1e-4
    with pytest.raises(ValueError, match="no table of at most 512"):
        decays.phi_cells(phi, 512)
    # buckets narrower than the least spacing always do
    assert decays.phi_cells(phi, 10 ** 5)[2].shape[0] <= int(
        1.002 * 2 * np.pi / 1e-4) + 1


def test_decays_cpu_take_a_phi_grid_the_kernel_would_need_many_buckets_for():
    """The CPU's plain path builds no bucket table, so a 64-point
    Gauss-Legendre phi grid (end spacing 0.0093 rad, 700 and more buckets)
    decays on the CPU as any other; the wave grid it builds has no phi
    cells."""
    table, mcids = testing.synthetic_decaying_table(24)
    grid = native_momentum_grid(2, n_pT=4, n_phi=64, n_eta=4)
    assert decays.phi_cells(grid.phi.numpy(), 10 ** 4)[2].shape[0] > 512
    assert decays.wave_grid(grid, 2, torch.float64, "cpu").phi_bucket is None
    spectra = torch.as_tensor(testing.thermal_spectra(table, mcids, grid, 2))
    out = decays.do_resonance_decays(spectra, table, mcids, grid,
                                     Config(dimension=2))
    assert (out >= spectra).all() and (out > spectra).any()
    assert "decays" not in build._cuda_libs


@pytest.mark.parametrize("nbody", [2, 3])
def test_wave_split_folds_every_row_once_in_order(nbody):
    """For waves of 1-300 tasks and every chunk count the card's blocking
    can give (1 to the task's (s, v) node pairs; test_wave_blocking_on_gpu
    holds the C side's choice), fold_rows adds each (task, chunk) scratch
    row exactly once -- a target row's tasks in schedule order, each task's
    chunks in ascending order."""
    rng = np.random.default_rng(nbody)
    pairs = 12 if nbody == 2 else 144
    for n_tasks in list(range(1, 13)) + [20, 65, 173, 277, 300]:
        seg = rng.integers(0, 7, n_tasks)
        tasks = decays.wave_tasks(
            nbody, [(int(s), 1.0, 0) + (0.0,) * (4 if nbody == 2 else 5)
                    for s in seg], torch.float64, "cpu")
        for n_chunks in sorted({1, 2, 5, 11, pairs, int(rng.integers(
                1, pairs + 1))}):
            rows = decays.fold_rows(tasks, n_chunks)
            flat = [r for t in rows for r in t]
            assert sorted(flat) == list(range(n_tasks * n_chunks))
            for t, target in enumerate(tasks.target.tolist()):
                want = [k * n_chunks + c
                        for k in np.nonzero(seg == target)[0]
                        for c in range(n_chunks)]
                assert rows[t] == want


@pytest.mark.gpu
@pytest.mark.parametrize("nbody", [2, 3])
def test_wave_blocking_on_gpu(cuda_card, nbody):
    """The C side's blocking for waves of 1-300 tasks on the native 32 x 24
    grid: balanced pT chunks, at least 4 blocks an SM unless every chunk
    is one (s, v) pair, no more chunks than that needs, the shared memory
    of the phi table counted; a launch with another chunk count than the
    blocking's is refused."""
    lib = decays._library()
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    pairs = 12 if nbody == 2 else 144
    for n_tasks in list(range(1, 13)) + [20, 65, 173, 277, 300]:
        for dtype, dim, NY in ((torch.float32, 3, 21), (torch.float64, 3, 21),
                               (torch.float32, 2, 1), (torch.float64, 2, 1)):
            bl = decays.wave_blocking(lib, dev, dtype, nbody, dim, n_tasks,
                                      32, 24, NY, 40)
            assert 1 <= bl.pt_block <= 32 and 1 <= bl.chunks <= pairs
            n_pt = -(-32 // bl.pt_block)
            assert bl.pt_block * n_pt - 32 < n_pt
            blocks = n_tasks * n_pt * bl.chunks
            assert blocks >= 4 * n_sm or bl.chunks == pairs
            assert bl.chunks == 1 or blocks < 4 * n_sm + n_tasks * 32
            bare = decays.wave_blocking(lib, dev, dtype, nbody, dim,
                                        n_tasks, 32, 24, NY, 0)
            assert bl.smem == bare.smem + 40 * 4
            assert bare.smem + 4 * bare.max_buckets <= 232448
    tables, tasks, wg, n_seg = testing.decay_edge_inputs(
        f"{nbody}body_3d", dtype=torch.float32, device="cuda")
    U, P, F, NY = tables.logdN.shape
    K, NB = tasks.slot.shape[0], wg.phi_bucket.shape[0]
    n_chunks = decays.wave_blocking(lib, dev, torch.float32, nbody, 3, K, P,
                                    F, NY, NB).chunks
    scratch = torch.zeros((K * (n_chunks + 1), P, F, NY), device=dev)
    acc = torch.zeros((n_seg, P, F, NY), dtype=torch.float64, device=dev)
    with pytest.raises(RuntimeError, match="invalid argument"):
        launch(lib, "decay_wave", lib.is3d_decay_wave_f32, dev, nbody, 3,
               tables.logdN.data_ptr(), tables.tc.data_ptr(),
               tables.ts.data_ptr(), tables.mtg.data_ptr(),
               wg.pT.data_ptr(), wg.phi_pad.data_ptr(),
               wg.phi_invd.data_ptr(), wg.phi_bucket.data_ptr(), NB,
               wg.y.data_ptr(), wg.quad.data_ptr(), U, P, F, NY,
               tasks.slot.data_ptr(), tasks.par.data_ptr(), K, n_chunks + 1,
               tasks.order.data_ptr(), tasks.target.data_ptr(),
               tasks.tstart.data_ptr(), tasks.target.shape[0],
               scratch.data_ptr(), acc.data_ptr())
    torch.cuda.synchronize()
    assert (acc == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_decay_wave_s_split_matches_plain_on_gpu(cuda_card, dtype):
    """A 3-task 3-body wave (3+1D), which the card takes in several chunks
    of its (s, v) node pairs, against its plain version; two launches
    bit-identical."""
    tables, tasks, wg, n_seg = testing.decay_edge_inputs(
        "3body_3d", dtype=dtype, device="cuda")
    # three tasks of parents off the -745 floor (slot 0 is all zero)
    pick = torch.nonzero(tasks.slot.cpu() > 0)[:3, 0].tolist()
    host = [(int(tasks.seg[i]), float(tasks.par[i, 0]), int(tasks.slot[i]))
            + tuple(tasks.par[i, 1:].tolist()) for i in pick]
    tasks = decays.wave_tasks(3, host, dtype, "cuda")
    U, P, F, NY = tables.logdN.shape
    assert decays.wave_blocking(decays._library(), torch.device("cuda"),
                                dtype, 3, 3, 3, P, F, NY,
                                wg.phi_bucket.shape[0]).chunks > 1
    acc = torch.zeros((n_seg, P, F, NY), dtype=torch.float64, device="cuda")
    again = torch.zeros_like(acc)
    decays.decay_wave_cuda(tables, tasks, wg, acc)
    decays.decay_wave_cuda(tables, tasks, wg, again)
    want = decays.wave_plain(tables, tasks, wg, n_seg).double()
    torch.cuda.synchronize()
    rtol, atol = (2e-4, 2e-5) if dtype == torch.float32 else (1e-10, 1e-13)
    np.testing.assert_allclose(acc.cpu().numpy(), want.cpu().numpy(),
                               rtol=rtol,
                               atol=atol * want.abs().max().item())
    assert torch.equal(acc, again)


# ------------------------------------------------------- feqmod (df 3-4)

def test_feqmod_cpu_tensors_take_plain_path_and_never_load_kernel():
    """df 3-4 on CPU tensors: the plain versions of the spectra (fixed
    nodes and remap) and of the dN/dX producer; no launch, no library."""
    counts = (feqmod.LAUNCHES, feqmod.REMAP_LAUNCHES, dndx.FEQMOD_LAUNCHES)
    for dimension, remap, df_mode in ((3, False, 3), (2, True, 4)):
        cfg = Config(operation=1, mode=1, dimension=dimension,
                     df_mode=df_mode, include_shear_deltaf=1,
                     include_bulk_deltaf=1, outflow=1)
        cells = testing.synthetic_surface_cells(30, dimension, seed=8,
                                                scale_bulk=0.01)
        for k in ("pixx", "pixy", "pixn", "piyy", "piyn"):
            cells[k] = cells[k] * 0.1
        surf = surface_from_arrays(**cells)
        grid = native_momentum_grid(dimension, n_pT=4, n_phi=4, n_y=3,
                                    n_eta=6, eta_mT_rescale=remap)
        species = testing.synthetic_species(5)
        df_data = testing.synthetic_deltaf_data()
        out = feqmod.smooth_spectra_feqmod(surf, species, grid, df_data, cfg)
        assert out.device.type == "cpu" and torch.isfinite(out).all()
        dX = dndx.spacetime_distributions(
            surf, species, grid, df_data,
            dataclasses.replace(cfg, operation=0, tau_bins=12, r_bins=8))
        assert np.isfinite(dX["dN_dy"]).all() and (dX["dN_dy"] > 0).all()
    assert counts == (feqmod.LAUNCHES, feqmod.REMAP_LAUNCHES,
                      dndx.FEQMOD_LAUNCHES)
    assert not {"feqmod", "dndx"} & set(build._cuda_libs)


@pytest.mark.parametrize("case", sorted(testing.FEQMOD_EDGES))
def test_feqmod_edge_inputs_are_what_they_claim(case):
    """On the CPU: the feqmod edge cases' plain spectra are finite and
    show the edge they are named for (their share of broken-down cells,
    the narrow mask's cells, shapes off the kernels' blocking, exact zeros
    where exp overflows, inert pad rows, the compat flag's unscaled cells,
    alphaB_mod, 1/betaV = inf)."""
    x, rn, wcs, mom, flags, wM, wR = testing.feqmod_edge_inputs(case)
    out = feqmod.feqmod_spectra_plain(x, rn, wcs, mom, flags)
    assert testing.feqmod_edge_seen(case, x, rn, wcs, mom, flags, out)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("case", sorted(testing.FEQMOD_EDGES))
def test_feqmod_kernel_edges_match_plain_on_gpu(cuda_card, case, dtype):
    """The feqmod kernels' edges (testing.FEQMOD_EDGES) against the plain
    versions: the spectra kernel of the case's path and, at fixed nodes,
    the dN/dX producer; f32 at rtol 2e-4 / atol 2e-5 x max, f64 at rtol
    1e-10 / atol 1e-13 x max; two launches bit-identical, exact zeros
    kept."""
    rtol, atol = ((2e-4, 2e-5) if dtype == torch.float32
                  else (1e-10, 1e-13))
    x, rn, wcs, mom, flags, wM, wR = testing.feqmod_edge_inputs(
        case, dtype=dtype, device="cuda")
    runs = [(lambda: (feqmod.feqmod_spectra_cuda(x, rn, wcs, mom, flags),),
             (feqmod.feqmod_spectra_plain(x, rn, wcs, mom, flags),))]
    if not flags.remap:
        runs.append((lambda: dndx.dndx_feqmod_cuda(x, rn, wcs, mom, flags,
                                                   wM, wR),
                     dndx.dndx_feqmod_plain(x, rn, wcs, mom, flags, wM, wR)))
    for kern, want in runs:
        got, again = kern(), kern()
        torch.cuda.synchronize()
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, a)
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                       rtol=rtol,
                                       atol=atol * w.abs().max().item())
            zero = w == 0
            assert torch.equal(g[zero], w[zero])


def test_feqmod_cell_split_covers_every_cell_in_whole_tiles():
    """The feqmod kernels' cell ranges: whole tiles, every cell once."""
    for tile, max_split in ((16, 8), (8, 64)):
        for n_cells in (1, 15, 16, 17, 777, 16384):
            for slots in SLOTS:
                grid = KernelGrid(blocks=96, slots=slots, parts=1,
                                  tile=tile, max_split=max_split,
                                  phi_width=0)
                per, n_split = tile_split(n_cells, grid)
                assert per % tile == 0 and 1 <= n_split <= max_split
                assert (n_split - 1) * per < n_cells <= n_split * per


def test_feqmod_yardstick():
    """The feqmod bound's count: f_mod 16 FP32 + 3 SFU (sqrt, exp, rcp;
    SFU-bound, as K1's df 2); the fallback at the main paths' flags
    (shear + bulk, no diffusion term, the exponent's b alphaB hoisted per
    (cell, species)) 23 FP32 + 3 SFU for df 3 and df 4, SFU-bound (an
    earlier count, 29 and 24, took the diffusion term, V.p and b alphaB
    in); the remap adds its node kinematics per (cell, node,
    species, pT), a 24th of them per evaluation on the native grid."""
    rate = lambda ops: max(ops[0] / 128, ops[1] / 16)
    assert feqmod.feqmod_formula_ops(3, False, 24, False) == (16.0, 3.0)
    assert rate(feqmod.MOD_OPS) == 3 / 16
    assert feqmod.FALLBACK_OPS == {3: (23, 3), 4: (23, 3)}
    assert rate(feqmod.FALLBACK_OPS[3]) == 3 / 16
    assert feqmod.feqmod_formula_ops(4, False, 24, True) == (23.0, 3.0)
    assert feqmod.feqmod_formula_ops(3, True, 24, False) == (
        16 + 9 / 24, 3 + 2 / 24)
    assert feqmod.feqmod_formula_ops(4, True, 24, True) == (
        23 + 18 / 24, 3.0)
