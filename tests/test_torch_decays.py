"""The resonance-decay feed-down of is3d_tpu_torch against is3d_tpu, on
the CPU in float64, on the decaying synthetic list
(testing.write_synthetic_run_dir(..., decays=True)) that both packages read.

* The schedule (parent rows, waves, every task tuple) equals the JAX one.
* The cascade (do_resonance_decays) matches is3d_tpu.kernels.decays.
  do_resonance_decays, which on the CPU under x64 is its float64 host
  loop, at rtol 1e-9 / atol 1e-12 x each species' largest value (the two
  sum the same terms in another order), 2+1D and 3+1D.
* Reference-free checks carried from tests/test_decays.py: 2- and 3-body
  yield conservation and the pT shape against a Monte-Carlo decay.
* The CLI with do_resonance_decays = 1 against the JAX CLI.
Grids are small (pT <= 8, phi <= 8, y <= 5) except where a check needs
the native grid (the CLI) or a fine one (conservation, Monte-Carlo); the
JAX cascades are built once per module.
"""

import dataclasses
import math
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from is3d_tpu import cli as jcli
from is3d_tpu.config import Config as JConfig
from is3d_tpu.io import pdg as jpdg
from is3d_tpu.io.tables import native_momentum_grid as jax_grid
from is3d_tpu.kernels import decays as jdk

from is3d_tpu_torch import cli, testing, writers
from is3d_tpu_torch.config import Config
from is3d_tpu_torch.io import pdg
from is3d_tpu_torch.io.tables import native_momentum_grid
from is3d_tpu_torch.kernels import decays

torch.set_num_threads(1)

N_SPECIES = 24
GRID = dict(n_pT=8, pT_max=3.0, n_phi=8, n_y=5, n_eta=4)


@pytest.fixture(scope="module")
def decaying(tmp_path_factory):
    """The decaying run directory, its tables in both packages, its
    chosen list."""
    rd = testing.write_synthetic_run_dir(
        str(tmp_path_factory.mktemp("decaying")), 64, N_SPECIES, 2, seed=3,
        decays=True)
    mcids = pdg.load_chosen_mcids(
        os.path.join(rd, "PDG", "chosen_particles_urqmd_v3.3+.dat"))
    return dict(run_dir=rd, mcids=mcids,
                table=pdg.read_resonances(os.path.join(rd, "PDG"), 1),
                jtable=jpdg.read_resonances(os.path.join(rd, "PDG"), 1))


def _spectra(decaying, dimension):
    spectra = testing.thermal_spectra(decaying["table"], decaying["mcids"],
                                      native_momentum_grid(dimension, **GRID),
                                      dimension)
    # a decaying parent all zero (the -745 floor), another zero from the
    # middle of its pT range up (patched by the tail fit)
    rows = decays._decay_schedule(decaying["table"], decaying["mcids"],
                                  np.zeros(1), 111)[0]
    spectra[rows[1]] = 0.0
    spectra[rows[2], GRID["n_pT"] // 2:] = 0.0
    return spectra


@pytest.fixture(scope="module")
def jax_cascades(decaying):
    """is3d_tpu's float64 cascade on the same spectra, 2+1D and 3+1D."""
    out = {}
    for dimension in (2, 3):
        spectra = _spectra(decaying, dimension)
        out[dimension] = (spectra, jdk.do_resonance_decays(
            spectra, decaying["jtable"], decaying["mcids"],
            jax_grid(dimension, **GRID),
            JConfig(dimension=dimension, do_resonance_decays=1)))
    return out


def test_schedule_equals_jax(decaying):
    pT = native_momentum_grid(3, **GRID).pT.numpy()
    got = decays._decay_schedule(decaying["table"], decaying["mcids"], pT,
                                 111)
    want = jdk._decay_schedule(decaying["jtable"], decaying["mcids"], pT,
                               111)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[3], want[3])
    for g_tasks, w_tasks in ((got[1], want[1]), (got[2], want[2])):
        assert [len(t) for t in g_tasks] == [len(t) for t in w_tasks]
        for g_parent, w_parent in zip(g_tasks, w_tasks):
            for g, w in zip(g_parent, w_parent):
                assert g[0] == w[0] and len(g) == len(w)
                np.testing.assert_allclose(
                    np.hstack([np.atleast_1d(v) for v in g[1:]]),
                    np.hstack([np.atleast_1d(v) for v in w[1:]]),
                    rtol=1e-15, atol=0)


def test_synthetic_list_has_its_edges(decaying):
    """The decaying list drives every part of the schedule: three waves, a
    parent fed by a heavier parent and by a lighter one (the width shift
    opens h1 -> f2 pi0), two identical daughters (multiplicity 2), adjusted
    masses, massless daughters, an unchosen daughter, 3-body channels, a
    closed 3-body channel; and one slot per (parent, adjusted mass)."""
    table, mcids = decaying["table"], decaying["mcids"]
    rows, tasks2, tasks3, level = decays._decay_schedule(table, mcids,
                                                         np.ones(1), 111)
    row = {int(m): i for i, m in enumerate(mcids)}
    assert 221 not in row and 22 in row
    assert level.max() >= 2
    by = {mcids[r]: (t2, t3, lv)
          for r, t2, t3, lv in zip(rows, tasks2, tasks3, level)}
    nominal = lambda m: table.mass[table.index_of_mcid(m)]
    # rho3 -> f2 -> rho0 -> pi pi
    assert by[117][2] < by[225][2] < by[113][2]
    # f2 -> rho0 rho0 below threshold: multiplicity 2 at an adjusted mass
    rho_from_f2 = [t for t in by[225][0] if t[0] == row[113]]
    assert rho_from_f2 and rho_from_f2[0][6] > nominal(225)
    assert rho_from_f2[0][3] < nominal(113) ** 2
    # h1 (lighter) -> f2 (heavier): same wave as f2 or later
    up = [t for t in by[10223][0] if t[0] == row[225]]
    assert up and nominal(10223) < nominal(225) and by[10223][2] >= by[225][2]
    # massless daughters: omega -> pi0 gamma, eta' -> rho0 gamma
    assert any(t[0] == row[22] and t[3] == 0.0 for t in by[223][0])
    # eta' -> eta pi+ pi-: 3-body with the unchosen eta; eta pi0 pi0: mult 2
    assert {t[0] for t in by[331][1]} >= {row[211], row[-211], row[111]}
    # omega -> K+ K- pi0 is closed: its 3-body tasks feed pions only
    assert {t[0] for t in by[223][1]} == {row[211], row[-211], row[111]}
    # one slot per (parent, adjusted mass): h1 has two
    waves = decays.plan_waves((rows, tasks2, tasks3, level))
    h1 = [(r, m) for w in waves for r, m in zip(w.rows, w.masses)
          if r == row[10223]]
    assert len(h1) == 2 and h1[0][1] != h1[1][1]


def test_main_decays_schedule_is_jax_count(tmp_path):
    """testing.DECAYS_MAIN_SCHEDULE, which chip_smoke.py's [decays main]
    path holds its launches and printed line to, is is3d_tpu's schedule of
    that list: channel contributions, waves, and the waves with 2-body and
    with 3-body tasks."""
    want = testing.DECAYS_MAIN_SCHEDULE
    path = str(tmp_path / "pdg.dat")
    mcids = testing.write_decaying_pdg(path, want["n_species"], want["seed"])
    assert len(mcids) == want["n_species"]
    rows, tasks2, tasks3, level = jdk._decay_schedule(
        jpdg.read_resonances_conventional(path), mcids,
        native_momentum_grid(3).pT.numpy(), 111)
    waves = [np.nonzero(level == w)[0] for w in range(int(level.max()) + 1)]
    got = dict(n_species=len(mcids), seed=want["seed"],
               channel_contributions=sum(map(len, tasks2 + tasks3)),
               waves=len(waves),
               waves_2body=sum(any(tasks2[i] for i in w) for w in waves),
               waves_3body=sum(any(tasks3[i] for i in w) for w in waves))
    assert got == want


def test_phi_grid_outside_0_2pi_is_refused(decaying):
    """The wave kernel wraps Phi with one add or subtract of 2 pi: a phi
    grid outside [0, 2 pi) is refused on every device."""
    grid = native_momentum_grid(2, **GRID)
    spectra = torch.as_tensor(_spectra(decaying, 2))
    cfg = Config(dimension=2, do_resonance_decays=1)
    for shift in (-0.5, 2.0):
        shifted = dataclasses.replace(grid, phi=grid.phi + shift)
        with pytest.raises(ValueError, match=r"phi grid in \[0, 2 pi\)"):
            decays.do_resonance_decays(spectra, decaying["table"],
                                       decaying["mcids"], shifted, cfg)


@pytest.mark.parametrize("dimension", [2, 3])
def test_cascade_matches_jax(decaying, jax_cascades, dimension):
    spectra, want = jax_cascades[dimension]
    cfg = Config(dimension=dimension, do_resonance_decays=1)
    got = decays.do_resonance_decays(
        torch.as_tensor(spectra), decaying["table"], decaying["mcids"],
        native_momentum_grid(dimension, **GRID), cfg)
    assert got.dtype == torch.float64 and got.shape == spectra.shape
    got = got.numpy()
    scale = np.abs(want).max(axis=(1, 2, 3), keepdims=True)
    assert (np.abs(want - spectra).max(axis=(1, 2, 3)) > 0).sum() >= 10
    assert (np.abs(got - want) <= 1e-9 * np.abs(want) + 1e-12 * scale).all()


def test_prepare_parents_matches_jax():
    """The batched tail fit against _prepare_parent, column by column:
    zero entries patched, the last-two-points fallback, and columns
    without a fit (const -745, slope 0)."""
    rng = np.random.default_rng(4)
    pT = np.linspace(0.1, 3.0, 8)
    parents, masses = [], [0.775, 1.2755, 0.5]
    for M in masses:
        p = np.exp(-np.sqrt(pT ** 2 + M ** 2)[:, None, None] / 0.15
                   + rng.normal(0, 0.05, (8, 5, 3)))
        parents.append(p)
    parents[0][3:] = 0.0                # fallback: few relativistic points
    parents[1][:, 0] = 0.0              # no fit in one phi column
    parents[1][:, 1, 0] = 0.0
    parents[1][-1, 1, 0] = 1.0          # one finite point: no fit either
    parents[2][1::2] = 0.0              # patched holes
    M = np.asarray(masses)
    mtg = np.sqrt(pT[None] ** 2 + M[:, None] ** 2)
    got = decays.prepare_parents(torch.as_tensor(np.stack(parents)),
                                 torch.as_tensor(mtg), torch.as_tensor(M))
    for u, (p, mass) in enumerate(zip(parents, masses)):
        want = jdk._prepare_parent(p, pT, mass)
        for g, w in zip(got, want[:3]):
            np.testing.assert_allclose(g[u].numpy(), w, rtol=1e-13,
                                       atol=1e-13)
    assert (got[1][1, 0] == -745.0).all() and (got[2][1, 0] == 0.0).all()


# ------------------------------------------------ reference-free checks

def _one_task(M, m1, m2, branch=1.0, dimension=2):
    """A 2-body task of a parent of mass M with the analytic spectrum of
    tests/test_decays.py, and its feed-down from two_body_wave_plain."""
    grid = native_momentum_grid(2, n_pT=48, pT_max=6.0, n_phi=24, n_eta=8)
    pT, phi = grid.pT.numpy(), grid.phi.numpy()
    MT = np.sqrt(M * M + pT * pT)
    spec = (np.exp(3.0 - 3.2 * MT)[:, None]
            * (1.0 + 0.4 * np.cos(2 * phi))[None, :])[None, :, :, None]
    Estar = (M * M + m1 * m1 - m2 * m2) / (2 * M)
    pstar = math.sqrt(Estar ** 2 - m1 * m1)
    return grid, spec, [(0, M * branch / (8.0 * pstar), 0, m1 * m1, Estar,
                         pstar, M)]


def _feed(grid, spec, M, nbody, tasks):
    wg = decays.wave_grid(grid, 2, torch.float64, "cpu")
    mtg = torch.sqrt(grid.pT ** 2 + M ** 2)[None]
    tables = decays.parent_tables(torch.as_tensor(spec), torch.tensor([0]),
                                  torch.tensor([M], dtype=torch.float64),
                                  mtg, torch.float64)
    return decays.wave_plain(tables, decays.wave_tasks(
        nbody, tasks, torch.float64, "cpu"), wg, 1)[0].numpy()


def _dNdy(spec, grid):
    w = grid.pT_weight.numpy() * grid.pT.numpy()
    return float(np.einsum("pf,p,f->", spec[:, :, 0], w,
                           grid.phi_weight.numpy()))


@pytest.mark.parametrize("masses", [(0.775, 0.138, 0.138),
                                    (0.892, 0.494, 0.138),
                                    (0.892, 0.138, 0.494)],
                         ids=["rho_pipi", "Kstar_K", "Kstar_pi"])
def test_two_body_yield_conservation(masses):
    """Each daughter species gains BR x the parent's dN/dY."""
    M, m1, m2 = masses
    grid, spec, tasks = _one_task(M, m1, m2)
    got = _dNdy(_feed(grid, spec, M, 2, tasks), grid)
    want = _dNdy(spec[0], grid)
    assert abs(got - want) < 0.02 * want, (got, want)


def _three_body_task(M, m1, m2, m3):
    s_plus, s_minus, d = (M - m1) ** 2, (m2 + m3) ** 2, (m2 - m3) ** 2
    Q = decays._q_factor(M, m1, m2, m3)
    return [(0, M * M * (s_plus - s_minus) / (8.0 * Q), 0, m1 * m1, M,
             s_minus, s_plus, d)]


def test_three_body_yield_conservation():
    """omega -> 3 pi (one pi+ group): dN/dy = BR x the parent's dN/dY."""
    M, m = 0.783, 0.138
    grid, spec, _ = _one_task(M, m, m)
    got = _dNdy(_feed(grid, spec, M, 3, _three_body_task(M, m, m, m)), grid)
    want = _dNdy(spec[0], grid)
    assert abs(got - want) < 0.03 * want, (got, want)


def _mc_daughters(rng, M, m1, N, pstar_of):
    """pT and y of daughter 1 of N parents drawn from MT exp(-3.2 MT)
    (1 + 0.4 cos 2 Phi), |Y| < 8, decaying isotropically with momentum
    pstar_of(n) in the rest frame."""
    b, Yr = 3.2, 8.0
    Y = rng.uniform(-Yr, Yr, N)
    MT = np.empty(N)
    got = 0
    while got < N:
        cand = M + rng.exponential(1.0 / b, 2 * (N - got))
        sel = cand[rng.uniform(0, 1, cand.size) < cand / (M + 40.0 / b)]
        sel = sel[:N - got]
        MT[got:got + sel.size] = sel
        got += sel.size
    Phi = np.empty(N)
    got = 0
    while got < N:
        cand = rng.uniform(0, 2 * np.pi, 2 * (N - got))
        sel = cand[rng.uniform(0, 1, cand.size)
                   < (1 + 0.4 * np.cos(2 * cand)) / 1.4][:N - got]
        Phi[got:got + sel.size] = sel
        got += sel.size
    pstar, Estar = pstar_of(N)
    cth, ph = rng.uniform(-1, 1, N), rng.uniform(0, 2 * np.pi, N)
    sth = np.sqrt(1 - cth ** 2)
    ps = pstar[:, None] * np.stack([sth * np.cos(ph), sth * np.sin(ph), cth], 1)
    PT = np.sqrt(MT ** 2 - M ** 2)
    P0 = MT * np.cosh(Y)
    Pvec = np.stack([PT * np.cos(Phi), PT * np.sin(Phi), MT * np.sinh(Y)], 1)
    coef = np.einsum("ni,ni->n", ps, Pvec) / (M * (P0 + M)) + Estar / M
    plab = ps + coef[:, None] * Pvec
    E = np.sqrt(m1 * m1 + np.einsum("ni,ni->n", plab, plab))
    yd = 0.5 * np.log((E + plab[:, 2]) / (E - plab[:, 2]))
    from scipy.integrate import quad
    nY = 2 * np.pi * np.exp(3.0) * quad(lambda x: x * np.exp(-b * x), M,
                                        np.inf)[0]
    return np.hypot(plab[:, 0], plab[:, 1]), yd, nY * 2 * Yr / N


def _shape_against_mc(grid, feed, pTd, yd, w, edges, rel):
    sel = np.abs(yd) < 0.5
    counts, _ = np.histogram(pTd[sel], bins=edges)
    mc = counts * w / np.diff(edges)
    pT = grid.pT.numpy()
    dphi = np.einsum("pf,f->p", feed[:, :, 0], grid.phi_weight.numpy()) * pT
    centers = 0.5 * (edges[1:] + edges[:-1])
    integ = np.interp(centers, pT, dphi)
    stat = np.sqrt(np.maximum(counts, 1)) * w / np.diff(edges)
    for i in range(len(centers)):
        assert abs(mc[i] - integ[i]) < 5 * stat[i] + rel * integ[i], \
            (i, centers[i], mc[i], integ[i])


def test_two_body_shape_against_monte_carlo():
    """rho0 -> pi+ pi-: the feed-down's pT shape against a Monte-Carlo
    decay of parents drawn from the same spectrum."""
    M, m = 0.775, 0.138
    grid, spec, tasks = _one_task(M, m, m)
    feed = _feed(grid, spec, M, 2, tasks)
    Estar = M / 2.0
    pstar = math.sqrt(Estar ** 2 - m * m)
    pTd, yd, w = _mc_daughters(np.random.default_rng(8), M, m, 1_000_000,
                               lambda n: (np.full(n, pstar),
                                          np.full(n, Estar)))
    _shape_against_mc(grid, feed, pTd, yd, w,
                      np.array([0.05, 0.15, 0.25, 0.35, 0.5, 0.7, 1.0, 1.4]),
                      0.04)


def test_three_body_shape_against_monte_carlo():
    """omega -> pi+ pi- pi0: the pT shape against a phase-space
    Monte-Carlo decay (invariant mass of the (2, 3) pair drawn from the Q
    factor's integrand)."""
    M, m1, m2, m3 = 0.783, 0.138, 0.138, 0.135
    grid, spec, _ = _one_task(M, m1, m2)
    feed = _feed(grid, spec, M, 3, _three_body_task(M, m1, m2, m3))
    s_plus, s_minus, d = (M - m1) ** 2, (m2 + m3) ** 2, (m2 - m3) ** 2
    a = (M + m1) ** 2
    rho = lambda s: np.sqrt(np.maximum(
        (a - s) * (s_plus - s) * (s - s_minus) * (s - d), 0.0)) / s
    rng = np.random.default_rng(12)
    rho_max = rho(np.linspace(s_minus, s_plus, 2000)[1:-1]).max()

    def pstar_of(n):
        s = np.empty(n)
        got = 0
        while got < n:
            cand = rng.uniform(s_minus, s_plus, 3 * (n - got))
            sel = cand[rng.uniform(0, rho_max, cand.size) < rho(cand)]
            sel = sel[:n - got]
            s[got:got + sel.size] = sel
            got += sel.size
        Estar = (M * M + m1 * m1 - s) / (2 * M)
        return np.sqrt(np.maximum(Estar ** 2 - m1 * m1, 0)), Estar

    pTd, yd, w = _mc_daughters(rng, M, m1, 1_000_000, pstar_of)
    _shape_against_mc(grid, feed, pTd, yd, w,
                      np.array([0.05, 0.15, 0.25, 0.35, 0.5, 0.7, 1.0]),
                      0.05)


def test_massless_daughter_f32_finite(decaying):
    """A float32 cascade keeps the photon rows finite (the cancellation-free
    kinematics) and agrees with float64 to the wave's float32 accuracy."""
    table, mcids = decaying["table"], decaying["mcids"]
    grid = native_momentum_grid(3, **GRID)
    spectra = torch.as_tensor(_spectra(decaying, 3))
    cfg = Config(dimension=3, do_resonance_decays=1)
    f64 = decays.do_resonance_decays(spectra, table, mcids, grid, cfg)
    f32 = decays.do_resonance_decays(spectra.float(), table, mcids,
                                     grid.to(dtype=torch.float32), cfg)
    photon = int(np.nonzero(mcids == 22)[0][0])
    assert (f64[photon] > spectra[photon]).any()
    assert torch.isfinite(f32).all()
    scale = f64.abs().amax(dim=(1, 2, 3), keepdim=True)
    assert ((f32 - f64).abs() <= 1e-4 * scale).all()


# ------------------------------------------------------- output layer

def test_cli_decay_files_match_jax_cli(decaying, tmp_path):
    """The CLI on the decaying run directory (2+1D, native grid) on the CPU
    against the JAX package's CLI: the same files, and the values of the
    decay files at rtol 1e-9 plus one unit in the last printed digit
    (%.8e rounds float64 results that differ in the 15th digit to
    different 9th digits now and then)."""
    rd = str(tmp_path / "rd")
    shutil.copytree(decaying["run_dir"], rd)
    assert jcli.main([rd]) == 0
    os.rename(os.path.join(rd, "results"), os.path.join(rd, "results_jax"))
    assert cli.main([rd, "device=cpu"]) == 0
    jax_files = sorted(os.listdir(os.path.join(rd, "results_jax")))
    assert jax_files == sorted(os.listdir(os.path.join(rd, "results")))
    decay_files = [f for f in jax_files if f.endswith("_resonance_decays.dat")]
    assert "dN_dpTdphidy_resonance_decays.dat" in decay_files
    assert len(decay_files) == 2 + N_SPECIES
    for f in decay_files:
        a, b = (open(os.path.join(rd, d, f)).read().split()
                for d in ("results_jax", "results"))
        words = lambda toks: [t for t in toks if not t[-1].isdigit()]
        assert words(a) == words(b), f
        va = np.asarray([float(t) for t in a if t[-1].isdigit()])
        vb = np.asarray([float(t) for t in b if t[-1].isdigit()])
        assert va.shape == vb.shape and (va > 0).any(), f
        digit = 1e-8 * 10.0 ** np.floor(np.log10(np.abs(va) + 1e-300))
        assert (np.abs(vb - va) <= 1e-9 * np.abs(va) + digit).all(), f


def test_api_result_is_the_decayed_spectra(decaying, tmp_path):
    """IS3D's operation-1 run with decays returns the cascade of its own
    smooth spectra, and writes the smooth files and the decay files."""
    from is3d_tpu_torch.api import IS3D
    smooth = IS3D.from_run_dir(decaying["run_dir"], device="cpu",
                               overrides=dict(do_resonance_decays=0),
                               results_dir=str(tmp_path / "smooth"))
    spectra = smooth.run_particlization(write_files=False).spectra
    run = IS3D.from_run_dir(decaying["run_dir"], device="cpu",
                            results_dir=str(tmp_path / "decayed"))
    result = run.run_particlization()
    names = [n for n, _ in run.timer.phases]
    assert names == ["prepare (io, pdg, deltaf)", "smooth spectra",
                     "resonance decays dispatch", "writers",
                     "resonance decays", "decay writers"]
    particle_table, _, _, mcids, grid = run._prepare()
    want = decays.do_resonance_decays(torch.as_tensor(spectra),
                                      particle_table, mcids, grid, run.cfg)
    np.testing.assert_array_equal(result.spectra, want.numpy())
    files = os.listdir(tmp_path / "decayed")
    assert "dN_pTdpTdphidy.dat" in files
    assert "dN_pTdpTdphidy_resonance_decays.dat" in files


def test_write_dN_dpTdphidy_matches_jax(tmp_path):
    from is3d_tpu import writers as jwriters
    grid = native_momentum_grid(3, **GRID)
    spectra = np.random.default_rng(2).random((3, 8, 8, 5))
    writers.write_dN_dpTdphidy(spectra, grid, [211, 111, 22], 3,
                               str(tmp_path), suffix="_resonance_decays")
    jwriters.write_dN_dpTdphidy(jnp.asarray(spectra), jax_grid(3, **GRID),
                                [211, 111, 22], 3, str(tmp_path / "jax"),
                                suffix="_resonance_decays")
    name = "dN_dpTdphidy_resonance_decays.dat"
    assert (open(tmp_path / name).read()
            == open(tmp_path / "jax" / name).read())


def test_operation0_rerun_with_fewer_species_leaves_no_stale_files(tmp_path):
    """clean_results_dir owns the spacetime files: a rerun of operation 0
    into the same directory with a shorter chosen list removes the first
    run's files of the species it dropped."""
    rd = testing.write_synthetic_run_dir(str(tmp_path), 16, 14, 2, seed=4,
                                         params=dict(operation=0))
    args = [rd, "device=cpu", "precision=f32"]
    assert cli.main(args) == 0
    st = os.path.join(rd, "results", "spacetime_distribution")
    assert len(os.listdir(st)) == 4 * 14
    chosen = os.path.join(rd, "PDG", "chosen_particles_urqmd_v3.3+.dat")
    kept = open(chosen).read().split()[:11]
    with open(chosen, "w") as f:
        f.write("".join(f"{m}\n" for m in kept))
    assert cli.main(args) == 0
    assert sorted({int(f.split("_")[2].split(".")[0]) for f in os.listdir(st)}
                  ) == sorted(int(m) for m in kept)
    assert len(os.listdir(st)) == 4 * 11


def test_config_replace_matches_jax():
    cfg = Config(dimension=3).replace(do_resonance_decays=1, df_mode=2)
    want = JConfig(dimension=3).replace(do_resonance_decays=1, df_mode=2)
    assert (cfg.dimension, cfg.do_resonance_decays, cfg.df_mode) == (
        want.dimension, want.do_resonance_decays, want.df_mode) == (3, 1, 2)
    assert Config().do_resonance_decays == 0


def test_negative_nan_prints_as_native_fastio_does(tmp_path, monkeypatch):
    """The Python fallback of _write_sci_table prints a NaN with its sign
    bit as -nan, as C's printf in native/fastio.cpp does."""
    from is3d_tpu_torch.native import build
    rows = np.array([[math.copysign(math.nan, -1.0), math.nan, -math.inf,
                      1.5]])
    native = tmp_path / "native.dat"
    writers._write_sci_table(str(native), "h\n", rows, 1)
    monkeypatch.setattr(build, "fast_write_sci_table", lambda *a: False)
    plain = tmp_path / "plain.dat"
    writers._write_sci_table(str(plain), "h\n", rows, 1)
    assert open(plain).read() == "h\n-nan\tnan\t-inf\t1.50000000e+00\n\n"
    if build.get_fastio() is not None:
        assert open(native).read() == open(plain).read()
