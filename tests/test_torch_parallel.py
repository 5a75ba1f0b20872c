"""is3d_tpu_torch's multi-GPU path on the CPU: ``mesh=`` (a CellMesh, a
torch.distributed process group of one rank a device) over gloo ranks.

One spawn of W ranks per W in {2, 3, 8} (file:// rendezvous, a join
timeout that kills the ranks and fails) runs every case of this file:
every cell-reduced path of operations 0 and 1 (linear df 3+1D and the 2+1D
remap, feqmod df 3-4 with cells that break down, VAH modes 2-3 with the
residual-df gate agreed over the ranks, the mode-5 polarization, dN/dX for
VH df 2, feqmod df 3 and VAH), each with the full columns and slice-local
(parallel/multihost.py), and api.IS3D(mesh=) runs of operations 0 and 1.
Each rank's result must equal the one-process port run BIT FOR BIT, and
each rank must have launched exactly its own groups (G = 8 groups of 38
cells: 4 + 4, 3 + 3 + 2 with a pad group not launched, 1 each; the 5-cell
case leaves ranks 5-7 of W = 8 without a group).  The one-process port is
held to is3d_tpu's smooth_spectra_sharded on a JAX mesh of W of the 8
virtual CPU devices at rtol 1e-9 in f64 (test_torch_smooth.py's bar), and
the W = 2 gradient of spectra_fn(mesh=) to jax.grad within 1e-8.

f64 inputs of a few hundred cells and narrow grids (run dirs: 48 cells on
the native grid) keep the file near a minute on one worker.
"""

import dataclasses
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from is3d_tpu import diff as jdiff
from is3d_tpu import testing as jtesting
from is3d_tpu.config import Config as JConfig
from is3d_tpu.io.surface import Surface as JSurface
from is3d_tpu.io.tables import native_momentum_grid as j_native_grid
from is3d_tpu.parallel import mesh as jmesh

from is3d_tpu_torch import convert, testing
from is3d_tpu_torch.api import IS3D
from is3d_tpu_torch.config import Config
from is3d_tpu_torch.io.surface import ThermoAverages
from is3d_tpu_torch.parallel import mesh as pmesh, multihost

from test_torch_smooth import jax_state
from test_torch_slice import _tree

torch.set_num_threads(1)

W_ALL = (2, 3, 8)
N_CELLS = 301
VISC = dict(include_shear_deltaf=1, include_bulk_deltaf=1)
GRID = dict(n_pT=5, n_phi=4, n_y=5, n_eta=10)
GRAD_WRT = ("T", "ux", "pixy", "dat")
JOIN_TIMEOUT = 240.0


def _jax_inputs(dimension, remap=False):
    jsp = jtesting.synthetic_species(n_species=7)
    jgrid = j_native_grid(dimension=dimension, eta_mT_rescale=remap, **GRID)
    jdf = jtesting.synthetic_deltaf_data()
    return jsp, jgrid, jdf


def _port(jsp, jgrid, jdf):
    return dict(species=convert.species_from_state(jax_state(jsp)),
                grid=convert.grid_from_state(jax_state(jgrid)),
                df_data=convert.deltaf_from_state(jax_state(jdf)))


def _vh_cells(dimension, seed, scales=(1.0, 1.0), n=N_CELLS):
    cells = jtesting.synthetic_surface_cells(n, dimension, seed)
    for k in ("pixx", "pixy", "pixn", "piyy", "piyn"):
        cells[k] = cells[k] * scales[0]
    cells["bulkPi"] = cells["bulkPi"] * scales[1]
    return cells


def _vah_cells(dimension, seed, partial):
    cells = testing.synthetic_vah_cells(N_CELLS, dimension, seed)
    coeffs = testing.synthetic_vah_coefficients(cells, seed)
    if partial:
        # shear coefficients only in the first cells (rank 0's), bulk ones
        # only in the last (the last rank's): no rank's slice alone gates
        # as the whole surface does
        for k in ("c3", "c4"):
            coeffs[k][40:] = 0.0
        for k in ("c0", "c1", "c2"):
            coeffs[k][:260] = 0.0
    cells.update(coeffs)
    return cells


# name: (kind, cfg, cells, dimension, remap, JAX parity W or None);
# df 3-4 cells take testing.FEQMOD_EDGES' mixed scales, where part of the
# cells break down
CASES = {
    "smooth_3d_df2": ("smooth", dict(dimension=3, df_mode=2,
                                     regulate_deltaf=1, outflow=1, **VISC),
                      lambda: _vh_cells(3, 1), 3, False, 2),
    "smooth_2d_df1_remap": ("smooth", dict(dimension=2, df_mode=1, **VISC),
                            lambda: _vh_cells(2, 2), 2, True, 3),
    "feqmod_3d_df3": ("smooth", dict(dimension=3, df_mode=3, **VISC),
                      lambda: _vh_cells(3, 3, (0.1, 0.01)), 3, False, 8),
    "feqmod_2d_df4_remap": ("smooth", dict(dimension=2, df_mode=4, **VISC),
                            lambda: _vh_cells(2, 4, (0.1, 0.01)), 2, True,
                            None),
    "tiny_3d_df2": ("smooth", dict(dimension=3, df_mode=2, **VISC),
                    lambda: _vh_cells(3, 5, n=5), 3, False, None),
    "vah_2d_mode2_gated": ("vah", dict(mode=2, dimension=2, **VISC),
                           lambda: _vah_cells(2, 6, True), 2, True, None),
    "vah_3d_mode3": ("vah", dict(mode=3, dimension=3, regulate_deltaf=1,
                                 **VISC),
                     lambda: _vah_cells(3, 7, False), 3, False, None),
    "polzn_2d_remap": ("polzn", dict(mode=5, dimension=2),
                       lambda: dict(_vh_cells(2, 8),
                                    **testing.synthetic_vorticity(N_CELLS,
                                                                  8)),
                       2, True, None),
    "dndx_2d_df2": ("dndx", dict(operation=0, dimension=2, df_mode=2,
                                 **VISC),
                    lambda: _vh_cells(2, 9), 2, False, None),
    "dndx_2d_df3": ("dndx", dict(operation=0, dimension=2, df_mode=3,
                                 **VISC),
                    lambda: _vh_cells(2, 10, (0.1, 0.01)), 2, False, None),
    "dndx_2d_vah": ("dndx", dict(operation=0, mode=2, dimension=2, **VISC),
                    lambda: _vah_cells(2, 11, True), 2, False, None),
}
GRADS = (("smooth_3d_df2", GRAD_WRT),)
# api.IS3D runs: (write_synthetic_run_dir arguments, overrides)
RUNS = {
    "op1_3d_df2": (dict(n_species=7, dimension=3), dict(df_mode=2)),
    "op1_2d_mode5": (dict(n_species=7, dimension=2, mode=5),
                     dict(df_mode=2)),
    "op0_2d_df1": (dict(n_species=7, dimension=2), dict(operation=0)),
}


def _case(name):
    kind, cfg_kw, cells_fn, dimension, remap, _ = CASES[name]
    cells = cells_fn()
    jsp, jgrid, jdf = _jax_inputs(dimension, remap)
    case = dict(_port(jsp, jgrid, jdf), kind=kind,
                surface=convert.surface_from_state(cells),
                cfg=Config(**cfg_kw))
    if kind == "polzn":
        case["plasma"] = ThermoAverages(0.152, 0.3, 0.05, 0.0, 0.0)
    return case, cells, (jsp, jgrid, jdf)


def _equal(a, b) -> bool:
    if isinstance(b, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in b)
    if isinstance(b, np.ndarray):
        return np.array_equal(a, b, equal_nan=True)
    return torch.equal(a, b)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The cases (torch.save'd for the ranks), their one-process results,
    the run dirs and their one-process IS3D runs."""
    root = tmp_path_factory.mktemp("mesh")
    cases = {name: _case(name)[0] for name in CASES}
    path = str(root / "cases.pt")
    torch.save(cases, path)
    one = {name: testing.mesh_case(case) for name, case in cases.items()}
    grads = {name: testing.mesh_grad(cases[name], wrt)
             for name, wrt in GRADS}
    runs, api_one = {}, {}
    for name, (kw, overrides) in RUNS.items():
        run_dir = testing.write_synthetic_run_dir(
            str(root / name), n_cells=48, seed=4, **kw)
        runs[name] = dict(run_dir=run_dir, overrides=overrides)
        res = IS3D.from_run_dir(run_dir, overrides=overrides, device="cpu",
                                results_dir=os.path.join(run_dir, "one")
                                ).run_particlization()
        api_one[name] = dict(spectra=res.spectra, dN_dX=res.dN_dX,
                             polarization=res.polarization)
    return dict(root=root, path=path, cases=cases, one=one, grads=grads,
                runs=runs, api_one=api_one)


@pytest.fixture(scope="module")
def spawned(inputs):
    """Every rank's results at W, one spawn of W ranks for each W."""
    done = {}

    def spawn(W):
        if W not in done:
            runs = [dict(name=name, results_dir=os.path.join(
                r["run_dir"], f"mesh{W}"), **r)
                for name, r in inputs["runs"].items()]
            done[W] = testing.run_ranks(
                testing.mesh_suite_rank, W, str(inputs["root"] / f"w{W}"),
                args=(inputs["path"], list(CASES), runs,
                      GRADS if W == 2 else ()),
                timeout=JOIN_TIMEOUT)
        return done[W]
    return spawn


@pytest.fixture(scope="module", params=W_ALL)
def ranks(request, spawned):
    return request.param, spawned(request.param)


def _owned(W, n):
    G, _ = pmesh.canonical_groups(Config(), n)
    per = -(-G // W)
    return [max(0, min(G, (r + 1) * per) - min(G, r * per))
            for r in range(W)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_paths_match_one_process_bits(ranks, inputs, name):
    W, out = ranks
    want = inputs["one"][name]
    n = inputs["cases"][name]["surface"].tau.shape[0]
    for r, res in enumerate(out):
        got = res["cases"][name]
        assert _equal(got["mesh"], want), (W, r, "full columns")
        assert _equal(got["slice"], want), (W, r, "slice-local")
        assert got["groups"] == got["slice_groups"] == _owned(W, n)[r]


def test_vah_gate_agreed_over_ranks(ranks):
    """The slice-local VAH path launches the chains the full surface
    gates (neither slice alone would); the result bits are held above."""
    W, out = ranks
    for name in ("vah_2d_mode2_gated", "dndx_2d_vah"):
        gates = [res["cases"][name]["gates"] for res in out]
        assert all(g["agreed"] == g["full"] == (1, 1) for g in gates)
        assert {g["local"] for g in gates} != {(1, 1)}, name


@pytest.mark.parametrize("name", sorted(RUNS))
def test_api_mesh_runs_match_one_process(ranks, inputs, name):
    W, out = ranks
    run_dir = inputs["runs"][name]["run_dir"]
    want = inputs["api_one"][name]
    n_groups = _owned(W, 48)
    for r, res in enumerate(out):
        got = res["api"][name]
        for key in ("spectra", "dN_dX", "polarization"):
            if want[key] is None:
                assert got[key] is None
            else:
                assert _equal(got[key], want[key]), (W, r, key)
        # mode 5 reduces twice: the polarization, then the spectra
        assert got["groups"] == n_groups[r] * (2 if "mode5" in name else 1)
        assert got["wrote"] == (r == 0)
        assert not os.path.exists(os.path.join(run_dir, f"mesh{W}_rank{r}"))
    one, mesh = (_tree(os.path.join(run_dir, d)) for d in ("one", f"mesh{W}"))
    assert sorted(one) == sorted(mesh) and one
    for rel in one:
        with open(one[rel], "rb") as a, open(mesh[rel], "rb") as b:
            assert a.read() == b.read(), rel


def test_spectra_grad_mesh_matches_one_process_bits(spawned, inputs):
    out = spawned(2)
    for name, _ in GRADS:
        want = inputs["grads"][name]
        cts = [res["grads"][name]["cotangent"] for res in out]
        # the same cotangent bits on every rank: each backward is the
        # one-process backward of its own groups
        assert all(torch.equal(c, cts[0]) for c in cts)
        for r, res in enumerate(out):
            got = res["grads"][name]
            assert torch.equal(got["value"], want["value"])
            assert _equal(got["grads"], want["grads"]), (r, "grad")
            assert _equal(got["vjp"], want["vjp"]), (r, "vjp")
            assert all(g.abs().max() > 0 for g in got["grads"].values())


def test_spectra_grad_matches_jax():
    """The one-process port gradient (what every rank assembles, above)
    against jax.grad of the same observable, within 1e-8."""
    case, cells, (jsp, jgrid, jdf) = _case("smooth_3d_df2")
    jcfg = JConfig(operation=1, mode=1, **CASES["smooth_3d_df2"][1])
    smap = jdiff.spectra_fn(jsp, jgrid, jdf, jcfg)
    jsurf = JSurface(**{k: jnp.asarray(v) for k, v in cells.items()})
    _, jgrads = jdiff.surface_value_and_grad(
        lambda s: (jnp.sum(jdiff.dN_dy_j(smap(s), jgrid))
                   + jnp.sum(jdiff.mean_pT_j(smap(s), jgrid))),
        jsurf, GRAD_WRT)
    got = testing.mesh_grad(case, GRAD_WRT)["grads"]
    for k in GRAD_WRT:
        want = np.asarray(jgrads[k])
        np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-8,
                                   atol=1e-8 * np.abs(want).max(), err_msg=k)


@pytest.mark.parametrize("name", sorted(n for n, c in CASES.items()
                                        if c[5] is not None))
def test_one_process_matches_jax_sharded(inputs, name):
    """The one-process port (every rank's bits, above) against is3d_tpu's
    smooth_spectra_sharded on a mesh of W of the 8 virtual CPU devices."""
    _, cfg_kw, _, _, _, W = CASES[name]
    _, cells, (jsp, jgrid, jdf) = _case(name)
    jsurf = JSurface(**{k: jnp.asarray(v) for k, v in cells.items()})
    want = np.asarray(jmesh.smooth_spectra_sharded(
        jsurf, jsp, jgrid, jdf, JConfig(operation=1, mode=1, **cfg_kw),
        mesh=jmesh.default_mesh(W)))
    got = inputs["one"][name].numpy()
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-9,
                               atol=1e-12 * np.abs(want).max())


def test_feqmod_cases_break_down():
    """The df 3-4 cases hold cells on both chains."""
    from is3d_tpu_torch.io.tables import laguerre_in_precision
    from is3d_tpu_torch.kernels import feqmod
    from is3d_tpu_torch.kernels.common import surface_columns, prepare_cells
    for name in ("feqmod_3d_df3", "feqmod_2d_df4_remap", "dndx_2d_df3"):
        case, _, _ = _case(name)
        cfg = case["cfg"]
        c = feqmod.prepare_feqmod_cells(
            prepare_cells(surface_columns(case["surface"], cfg), cfg,
                          case["df_data"]),
            case["species"], laguerre_in_precision(
                None, torch.float64, torch.device("cpu")), cfg)
        broke = c["breakdown"]
        assert broke.any() and not broke.all(), name


@pytest.mark.parametrize("W", range(1, 9))
def test_process_cell_slice_layout(W):
    """process_cell_slice against _padded_layout worked by hand: G_pad =
    ceil(G / W) W groups of gs cells, rank r's extent [r G_pad gs / W,
    (r + 1) G_pad gs / W) clipped to the real cells; ranks past them get
    start == stop == n."""
    for n in (3, 5, 7, 301):
        cfg = Config()
        G = min(8, n)
        gs = -(-n // G)
        per = -(-G // W) * gs
        assert multihost._padded_layout(cfg, n, _mesh(W, 0)) == (
            -(-G // W) * W * gs, gs)
        slices = [multihost.process_cell_slice(cfg, n, _mesh(W, r))
                  for r in range(W)]
        assert slices == [(min(r * per, n), min((r + 1) * per, n))
                          for r in range(W)]
        # contiguous, covering every cell once
        assert slices[0][0] == 0 and slices[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    # n = 3 below G = reduce_groups: W = 8 leaves ranks 3-7 only padding
    if W == 8:
        assert [multihost.process_cell_slice(Config(), 3, _mesh(8, r))
                for r in range(8)] == [(0, 1), (1, 2), (2, 3)] + [(3, 3)] * 5


def _mesh(W, r):
    return pmesh.CellMesh(group=None, device=torch.device("cpu"), rank=r,
                          size=W)


def test_mesh_refusals(tmp_path):
    """No fallback: no group, a mesh that is not a CellMesh, a device that
    is not the mesh's.  Operation 2 under a mesh (refused until pod mode
    was ported) builds, and takes the pod rule with several ranks
    (tests/test_torch_pod.py)."""
    with pytest.raises(RuntimeError, match="initialised"):
        pmesh.default_mesh("cpu")
    with pytest.raises(RuntimeError, match="initialised"):
        multihost.process_cell_slice(Config(), 100)
    with pytest.raises(TypeError, match="CellMesh"):
        IS3D(Config(operation=1), device="cpu", mesh="2 cards")
    with pytest.raises(TypeError, match="CellMesh"):
        pmesh.grouped_cell_reduce(None, {"tau": torch.zeros(3)}, (),
                                  Config(), mesh=object())
    assert IS3D(Config(operation=2), device="cpu", mesh=_mesh(2, 0))._pod()
    assert not IS3D(Config(operation=2), device="cpu",
                    mesh=_mesh(1, 0))._pod()
    with pytest.raises(ValueError, match="rank device"):
        IS3D(Config(operation=1), device="cpu",
             mesh=dataclasses.replace(_mesh(2, 0),
                                      device=torch.device("meta")))
