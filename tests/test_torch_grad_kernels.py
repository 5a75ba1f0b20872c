"""The backward kernels' wrappers without JAX: the CPU path takes the plain
versions' autograd and never loads a kernel; the wrappers refuse CPU
tensors; the backward fold's plan and the padded tables are what the
kernel reads; the yardsticks count what the kernels do; and, on a CUDA card
(gpu-marked), K9a and K9b (csrc/smooth_spectra_bwd.cu: fixed nodes and the
2+1D mT remap) on testing.SPECTRA_EDGES, K9c (csrc/decays_bwd.cu) on
testing.DECAY_EDGES, K10a/K10b (csrc/feqmod_bwd.cu) on
testing.FEQMOD_EDGES, K11a/K11b (csrc/vah_bwd.cu) on testing.VAH_EDGES
and K12a/K12b (csrc/polzn_bwd.cu: the polarization's fixed nodes and 2+1D
mT remap) on testing.POLZN_EDGES against their plain versions, two
launches bit-identical, and the autograd Functions that carry them.  The
plain df 3 gradient stays finite on the edges where f_mod saturates or
1/betaV = inf.

On the GPU: python -m pytest tests/test_torch_grad_kernels.py -m gpu
--noconftest (the conftest imports jax).  Tolerances: against the plain
gradient in float64 from the same inputs, float32 rtol 2e-4 / atol 2e-5 x
max|grad| of each field, float64 1e-10 / 1e-13 x max; the cotangents are
testing.grad_cotangent's positive weights (its comment says why).  A
massless species' NaN and inf (the polarization's pm = -inf) are held to
the plain version's positions in the kernel's own precision.
"""

import dataclasses

import numpy as np
import pytest
import torch

from is3d_tpu_torch import testing
from is3d_tpu_torch.io.tables import native_momentum_grid
from is3d_tpu_torch.kernels import decays, feqmod, polzn, smooth, vah
from is3d_tpu_torch.native import build

torch.set_num_threads(1)

TOL = {torch.float32: (2e-4, 2e-5), torch.float64: (1e-10, 1e-13)}
SPECTRA = sorted(testing.SPECTRA_EDGES)
DECAYS = sorted(testing.DECAY_EDGES)
FEQMOD = sorted(testing.FEQMOD_EDGES)
VAH = sorted(testing.VAH_EDGES)
POLZN = sorted(testing.POLZN_EDGES)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the GPU: python -m pytest "
                    "tests/test_torch_grad_kernels.py -m gpu --noconftest)")


def test_cpu_gradient_never_loads_a_kernel(monkeypatch):
    def refuse(name):
        raise AssertionError(f"loaded {name} on the CPU path")
    monkeypatch.setattr(build, "cuda_library", refuse)
    cells, mom, flags, G = testing.spectra_grad_inputs("3d_df2_ragged",
                                                       n_cells=20)
    x = cells.clone().requires_grad_(True)
    out = smooth.group_spectra(x, mom, flags)
    (g,) = torch.autograd.grad(out, x, G)
    assert torch.equal(g, smooth.spectra_bwd_plain(cells, G, mom, flags))
    assert torch.isfinite(g).all() and g.abs().max() > 0


@pytest.mark.parametrize("which", ["feqmod", "vah"])
def test_feqmod_vah_cpu_gradients_never_load_a_kernel(monkeypatch, which):
    """On the CPU the df 3-4 and VAH spectra differentiate through their
    plain versions (each chunk under torch.utils.checkpoint): no kernel
    library is loaded, and the gradient is the plain backward's."""
    def refuse(name):
        raise AssertionError(f"loaded {name} on the CPU path")
    monkeypatch.setattr(build, "cuda_library", refuse)
    if which == "feqmod":
        x, rn, wcs, mom, flags, G = testing.feqmod_grad_inputs("2d_remap_df3_mixed",
                                                        n_cells=20)
        xg = x.clone().requires_grad_(True)
        rg = rn.clone().requires_grad_(True)
        got = torch.autograd.grad(
            feqmod.group_spectra(xg, rg, wcs, mom, flags, cell_chunk=8),
            (xg, rg), G)
        want = feqmod.feqmod_bwd_plain(x, rn, wcs, G, mom, flags)
    else:
        x, mom, flags, G = testing.vah_grad_inputs("3d_sw3", n_cells=20)
        xg = x.clone().requires_grad_(True)
        got = torch.autograd.grad(
            vah.group_spectra(xg, mom, flags, cell_chunk=8), (xg,), G)
        want = (vah.vah_bwd_plain(x, G, mom, flags),)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and g.abs().max() > 0
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("case", ["3d_ragged", "2d_remap_yflow"])
def test_polzn_cpu_gradient_never_loads_a_kernel(monkeypatch, case):
    """On the CPU the polarization differentiates through its plain version
    (each chunk under torch.utils.checkpoint): no kernel library is loaded,
    and the gradient of the packed cells is polzn_bwd_plain's."""
    def refuse(name):
        raise AssertionError(f"loaded {name} on the CPU path")
    monkeypatch.setattr(build, "cuda_library", refuse)
    x, mom, pm, wR, flags, _, G = testing.polzn_grad_inputs(case,
                                                            n_cells=20)
    xg = x.clone().requires_grad_(True)
    sums = polzn.polzn_plain(xg, mom, pm, wR, flags, cell_chunk=8)
    (g,) = torch.autograd.grad(sums, xg, tuple(G.unbind(0)))
    want = polzn.polzn_bwd_plain(x, G, mom, pm, wR, flags)
    assert torch.isfinite(g).all() and g.abs().max() > 0
    torch.testing.assert_close(g, want, rtol=1e-12, atol=1e-14)
    assert (g[:, polzn.PW["tau"]] == 0).all()


def test_polzn_fields_match_the_cuda_header():
    """PW_FIELDS is csrc/polzn.cuh's `enum PwField` (both polarization
    kernels and their backward read it), name for name."""
    import os
    import re
    path = os.path.join(os.path.dirname(polzn.__file__), "..", "csrc",
                        "polzn.cuh")
    body = re.search(r"enum PwField \{(.*?)\};", open(path).read(),
                     re.S).group(1)
    names = [n.strip() for n in body.split(",")]
    assert names == ["W_" + n.upper() for n in polzn.PW_FIELDS] + ["NW"]


@pytest.mark.parametrize("case", ["2d_df4_most", "3d_degenerate"])
def test_plain_feqmod_gradient_is_nan_free(case):
    """The plain version's autograd stays finite where f_mod's |x|^2
    saturates (a 2+1D node scaled by detA = 62) and where 1/betaV = inf
    clips the df 3 bracket (the double where and the zero-safe products of
    kernels/feqmod.py), as K10 does."""
    x, rn, wcs, mom, flags, G = testing.feqmod_grad_inputs(case)
    for g in feqmod.feqmod_bwd_plain(x, rn, wcs, G, mom, flags):
        assert torch.isfinite(g).all() and g.abs().max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_df4_lambda_gradient_is_nan_free_near_zero_bulk(dtype):
    """df 4's lambda = sign(bulkPi) sqrt(lambda2(bulkPi / P)): near bulkPi =
    0 the float32 spline gives lambda2 <= 0, where sqrt's derivative met a
    zero cotangent (a masked cell) as 0 / 0 = NaN; the double where gives
    0 there and leaves the values and the other derivatives as they were
    (a smoke-2d-df4-feqmod cell, bulkPi = -1.8e-8)."""
    from is3d_tpu_torch.io.deltaf import evaluate_df_coefficients
    df = testing.synthetic_deltaf_data(dtype=dtype)
    T, E, P = (torch.full((4,), v, dtype=dtype) for v in (0.157, 0.39,
                                                           0.0647))
    bulk = torch.tensor([-1.8e-8, 0.0, 1e-12, 0.003], dtype=dtype,
                        requires_grad=True)
    c = evaluate_df_coefficients(df, 4, False, T, torch.zeros_like(T), E, P,
                                 bulk)
    (g,) = torch.autograd.grad(c.lam, bulk, torch.tensor(
        [0.0, 0.0, 1.0, 1.0], dtype=dtype))
    assert torch.isfinite(g).all() and g[3] > 0
    assert c.lam[3] > 0 and (c.lam[1:3] == 0).all()


@pytest.mark.parametrize("which", ["spectra", "decays", "feqmod", "vah",
                                   "polzn"])
def test_wrappers_refuse_cpu_tensors(which):
    if which == "polzn":
        for case in ("3d", "2d_remap"):
            x, mom, pm, wR, flags, table, G = testing.polzn_grad_inputs(
                case, n_cells=20)
            with pytest.raises(ValueError, match="needs CUDA"):
                polzn.polzn_bwd_cuda(x, G, mom, pm, wR, flags, table)
            with pytest.raises(ValueError, match="G"):
                polzn.polzn_bwd_cuda(x, G[:4], mom, pm, wR, flags, table)
        assert "polzn_bwd" not in build._cuda_libs
        return
    if which == "feqmod":
        x, rn, wcs, mom, flags, G = testing.feqmod_grad_inputs("3d_df3_clean",
                                                        n_cells=20)
        with pytest.raises(ValueError, match="needs CUDA"):
            feqmod.feqmod_bwd_cuda(x, rn, wcs, G, mom, flags)
        with pytest.raises(ValueError, match="G"):
            feqmod.feqmod_bwd_cuda(x, rn, wcs, G[:1], mom, flags)
        return
    if which == "vah":
        x, mom, flags, G = testing.vah_grad_inputs("2d_remap_sw3", n_cells=20)
        with pytest.raises(ValueError, match="needs CUDA"):
            vah.vah_bwd_cuda(x, G, mom, flags)
        with pytest.raises(ValueError, match="G"):
            vah.vah_bwd_cuda(x, G.float(), mom, flags)
        return
    if which == "spectra":
        cells, mom, flags, G = testing.spectra_grad_inputs("2d_remap_yflow",
                                                           n_cells=20)
        with pytest.raises(ValueError, match="needs CUDA"):
            smooth.spectra_bwd_cuda(cells, G, mom, flags)
        with pytest.raises(ValueError, match="G"):
            smooth.spectra_bwd_cuda(cells, G[:1], mom, flags)
    else:
        tables, tasks, wg, G = testing.decay_grad_inputs("2body_2d")
        with pytest.raises(ValueError, match="needs CUDA"):
            decays.wave_bwd_cuda(tables, tasks, wg, G)
        with pytest.raises(ValueError, match="G"):
            decays.wave_bwd_cuda(tables, tasks, wg, G.float())


@pytest.mark.parametrize("case", ["2body_3d", "3body_2d"])
def test_padded_tables(case):
    """padded_tables lays each slot out as the forward kernel stages it
    (phi column c holds column (c - 1) mod F; tc and ts after the log
    table), float32 scaled by log2(e)."""
    tables, _, _, _ = testing.decay_grad_inputs(case)
    U, P, F, NY = tables.logdN.shape
    pt = decays.padded_tables(tables)
    assert pt.shape == (U, (P + 2) * (F + 2) * NY)
    log = pt[:, :P * (F + 2) * NY].reshape(U, P, F + 2, NY)
    assert torch.equal(log[:, :, 1:F + 1], tables.logdN)
    assert torch.equal(log[:, :, 0], tables.logdN[:, :, F - 1])
    assert torch.equal(log[:, :, F + 1], tables.logdN[:, :, 0])
    tail = pt[:, P * (F + 2) * NY:].reshape(U, 2, F + 2, NY)
    assert torch.equal(tail[:, 0, 1:F + 1], tables.tc)
    assert torch.equal(tail[:, 1, 1:F + 1], tables.ts)
    assert torch.equal(decays.padded_tables(tables.to(None, torch.float32))[
        :, :P * (F + 2) * NY].reshape(U, P, F + 2, NY)[:, :, 1:F + 1],
        tables.logdN.float() * torch.tensor(1.4426950408889634,
                                            dtype=torch.float32))


@pytest.mark.parametrize("angles", [1, 2, 4])
@pytest.mark.parametrize("case", ["3d_df2_ragged", "2d_df1_ragged"])
def test_fixed_bwd_stage_is_what_the_kernel_reads(case, angles):
    """fixed_bwd_stage lays the cotangent out as K9a stages it: entry
    (pT p, angle group f // angles, species s, node r x angles + f %
    angles) holds prefactor x degeneracy x G[s, p, f, r], the padded
    angles and the padding of each species' row are 0; rows hold mT, m^2,
    sign and baryon number of each (pT, species)."""
    cells, mom, flags, G = testing.spectra_grad_inputs(case, n_cells=20)
    S, P, F, R = G.shape
    ru = -(-R * angles // 2) * 2 + 2
    rows, Gw = smooth.fixed_bwd_stage(G, mom, angles, ru)
    nfg = -(-F // angles)
    assert Gw.shape == (P, nfg, S, ru) and Gw.is_contiguous()
    w = smooth.CF_PREFACTOR * mom.degeneracy
    f = torch.arange(F)
    for r in range(R):
        got = Gw[:, f // angles, :, r * angles + f % angles]   # (F, P, S)
        want = (G[:, :, :, r] * w[:, None, None]).permute(2, 1, 0)
        assert torch.equal(got, want)
    pad = torch.ones(nfg, angles, dtype=torch.bool)
    pad.view(-1)[:F] = False
    for u in range(angles):
        assert not Gw[:, pad[:, u], :, u:R * angles:angles].any()
    assert not Gw[..., R * angles:].any()
    m2 = mom.mass ** 2
    assert torch.equal(rows[..., 0], torch.sqrt(m2 + mom.pT[:, None] ** 2))
    assert torch.equal(rows[..., 1], m2.expand(P, S))
    assert torch.equal(rows[..., 2], mom.sign.expand(P, S))
    assert torch.equal(rows[..., 3], mom.baryon.expand(P, S))


@pytest.mark.parametrize("angles", [1, 2, 4])
@pytest.mark.parametrize("case", ["3d_ragged", "2d_fixed_ragged"])
def test_polzn_fixed_bwd_stage_is_what_the_kernel_reads(case, angles):
    """polzn.fixed_bwd_stage lays the five sums' cotangents out as K12a
    stages them: entry (pT p, angle group f // angles, species s) holds
    G[k, s, p, f, r] (k < 4) at ((f % angles) n_out + r) 4 + k, one
    16-byte vector a (species, angle, node), and G[4, s, p, f, r] at 4
    angles n_out + r angles + f % angles; the padded angles and each
    species' padding are 0; rows hold mT, sign, pm and pm sign of each
    (pT, species)."""
    x, mom, pm, wR, flags, table, G = testing.polzn_grad_inputs(case,
                                                                n_cells=20)
    _, S, P, F, R = G.shape
    assert R == (mom.nodes.shape[0] if flags.dimension == 3 else 1)
    ru = -(-5 * angles * R // 4) * 4 + 4
    rows, Gst = polzn.fixed_bwd_stage(G, mom, pm, angles, ru)
    nfg = -(-F // angles)
    assert Gst.shape == (P, nfg, S, ru) and Gst.is_contiguous()
    assert rows.shape == (P, S, 4) and rows.is_contiguous()
    want = torch.zeros_like(Gst)
    for f in range(F):
        fg, u = divmod(f, angles)
        for r in range(R):
            for k in range(4):
                want[:, fg, :, (u * R + r) * 4 + k] = G[k, :, :, f, r].T
            want[:, fg, :, 4 * angles * R + r * angles + u] = G[4, :, :, f,
                                                                r].T
    assert torch.equal(Gst, want)
    assert not Gst[..., 5 * angles * R:].any()
    for u in range(F % angles or angles, angles):     # the padded angles
        last = Gst[:, -1]
        assert not last[..., u * R * 4:(u + 1) * R * 4].any()
        assert not last[..., 4 * angles * R + u:5 * angles * R:angles].any()
    m2 = mom.mass ** 2
    assert torch.equal(rows[..., 0], torch.sqrt(m2 + mom.pT[:, None] ** 2))
    assert torch.equal(rows[..., 1], mom.sign.expand(P, S))
    assert torch.equal(rows[..., 2], pm.expand(P, S))
    assert torch.equal(rows[..., 3], (pm * mom.sign).expand(P, S))


@pytest.mark.parametrize("case", ["2d_remap", "2d_remap_ragged"])
def test_polzn_remap_bwd_stage_is_what_the_kernel_reads(case):
    """polzn.remap_bwd_stage lays the cotangents out as K12b reads a point:
    (species, pT, phi) holds the five G's times the remap's jacobian s(mT)
    of the (species, pT) row, then cos phi, sin phi and 0."""
    x, mom, pm, wR, flags, table, G = testing.polzn_grad_inputs(case,
                                                                n_cells=20)
    assert flags.remap
    _, S, P, F, _ = G.shape
    Gs = polzn.remap_bwd_stage(G, mom)
    assert Gs.shape == (S, P, F, 8) and Gs.is_contiguous()
    s = smooth.remap_scale(mom)
    for k in range(5):
        assert torch.equal(Gs[..., k], G[k, ..., 0] * s[:, :, None])
    assert torch.equal(Gs[..., 5], mom.cos_phi.expand(S, P, F))
    assert torch.equal(Gs[..., 6], mom.sin_phi.expand(S, P, F))
    assert not Gs[..., 7].any()


def test_backward_yardsticks():
    """The backward's operations per evaluation exceed the forward's, and
    the wave backward counts the forward's evaluations."""
    for df in (1, 2):
        fwd = smooth.FORMULA_OPS[df]
        bwd = smooth.backward_formula_ops(df, remap=False, n_phi=24)
        assert bwd[0] > 2 * fwd[0] and bwd[1] <= fwd[1]
        assert smooth.backward_formula_ops(df, remap=True,
                                           n_phi=24)[0] > bwd[0]
    tables, tasks, wg, _ = testing.decay_grad_inputs("2body_3d_narrow_y")
    f_fwd, s_fwd = decays.wave_operations(tasks, wg)
    f_bwd, s_bwd = decays.wave_backward_operations(tasks, wg)
    assert s_bwd == s_fwd == decays.wave_evaluations(tasks, wg)
    assert f_bwd > f_fwd > 0


@pytest.mark.parametrize("df", [1, 2])
def test_remap_backward_yardstick_row_share(df):
    """With the remap the backward's count is the fixed node's plus the
    per-evaluation extra and the row's share 1 / n_phi (the node
    kinematics, composites and node sums of a (cell, node, species, pT)
    row), as remap_formula_ops shares the forward's node kinematics: it
    falls as n_phi grows, by the row's operations times the change of
    1 / n_phi; the fixed node's does not depend on n_phi."""
    fixed = smooth.backward_formula_ops(df, False, 24)
    assert fixed == smooth.backward_formula_ops(df, False, 8)
    assert fixed == smooth.BACKWARD_FORMULA_OPS[df]
    for n_phi in (8, 24, 48):
        assert smooth.backward_formula_ops(df, True, n_phi) == (
            fixed[0] + smooth.REMAP_BACKWARD_EXTRA
            + smooth.REMAP_BACKWARD_ROW_OPS / n_phi, fixed[1])
    b = {n: smooth.backward_formula_ops(df, True, n)[0] for n in (8, 24, 48)}
    assert b[8] > b[24] > b[48] > fixed[0]
    f = {n: smooth.remap_formula_ops(df, n)[0] for n in (8, 48)}
    row = lambda ops: ops * (1 / 8 - 1 / 48)
    assert f[8] - f[48] == pytest.approx(row(smooth.REMAP_NODE_OPS[0]))
    assert b[8] - b[48] == pytest.approx(row(smooth.REMAP_BACKWARD_ROW_OPS))


@pytest.mark.parametrize("case", sorted(testing.DECAY_EDGES))
def test_wave_bwd_scale_bounds_every_term(case):
    """K9c's slot scales (decays.wave_bwd_scale, no evaluation; one for a
    slot's log rows, one for its tail rows) lie above every term the
    backward kernel adds there (testing.wave_term_max, the plain version's
    gather form term by term in float64; terms that are float64 normal
    numbers), and give up at most 12 bits against the largest; HI_u = 61 -
    ceil(log2 E_u) from the slot's evaluations."""
    tables, tasks, wg, G = testing.decay_grad_inputs(case)
    lb = decays.wave_term_bound_log2(tables, tasks, wg, G)
    most = testing.wave_term_max(tables, tasks, wg, G)
    live = most > 2.0 ** -1000
    assert live[:, 0].any() and live[:, 1].any()
    gap = lb[live] - torch.log2(most[live])
    assert (gap >= 0).all(), gap
    assert gap.max() <= 12.0, gap
    sc = decays.wave_bwd_scale(tables, tasks, wg, G).long()
    e = sc[:, 2:] - sc[:, :2]                   # 2^e above the bounds
    assert (e.double()[live] > lb[live]).all()
    U, P, F, NY = tables.logdN.shape
    n = torch.bincount(tasks.slot.long(), minlength=U).double()
    evals = n * (12 if tasks.nbody == 3 else 1) * P * F * NY * 144 * 2
    hi = 61 - torch.ceil(torch.log2(evals.clamp_min(1.0)))
    assert torch.equal(sc[:, 2].double(), hi)


def test_feqmod_vah_backward_yardsticks():
    """K10's and K11's operations per evaluation exceed their forwards',
    the fallback's f_mod's, every chain's the gated f_a's, and the remap
    adds its node kinematics."""
    for df in (3, 4):
        for fallback in (False, True):
            fwd = feqmod.feqmod_formula_ops(df, False, 24, fallback)
            bwd = feqmod.feqmod_backward_formula_ops(df, False, 24, fallback)
            assert bwd[0] > 2 * fwd[0] and bwd[1] >= fwd[1]
            assert feqmod.feqmod_backward_formula_ops(
                df, True, 24, fallback)[0] > bwd[0]
        assert (feqmod.feqmod_backward_formula_ops(df, False, 24, True)[0]
                > feqmod.feqmod_backward_formula_ops(df, False, 24, False)[0])
    flags = lambda sw, remap: vah.VahFlags(
        dimension=2 if remap else 3, remap=remap, shear=bool(sw & 1),
        bulk=bool(sw & 2), regulate=True, outflow=True)
    for remap in (False, True):
        ops = [vah.vah_backward_formula_ops(flags(sw, remap), 24)
               for sw in range(4)]
        for sw in range(4):
            fwd = vah.vah_formula_ops(flags(sw, remap), 24)
            assert ops[sw][0] > 2 * fwd[0] and ops[sw][1] >= fwd[1]
        assert ops[0][0] < ops[2][0] < ops[1][0] < ops[3][0]
    assert (vah.vah_backward_formula_ops(flags(3, True), 24)[0]
            > vah.vah_backward_formula_ops(flags(3, False), 24)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", FEQMOD)
def test_feqmod_bwd_kernel_matches_plain(cuda_card, case, dtype):
    """K10a/K10b against the plain version's autograd in f64 from the same
    inputs, the reference rounded to the kernel's precision (a field whose
    largest f64 value lies below float32's range is 0 there)."""
    x, rn, wcs, mom, flags, G = testing.feqmod_grad_inputs(case, dtype=dtype,
                                                    device="cuda")
    want = feqmod.feqmod_bwd_plain(x.double(), rn.double(), wcs.double(),
                                   G.double(), mom.to(None, torch.float64),
                                   flags)
    got = feqmod.feqmod_bwd_cuda(x, rn, wcs, G, mom, flags)
    again = feqmod.feqmod_bwd_cuda(x, rn, wcs, G, mom, flags)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g, w in zip(got, want):
        bad, worst = testing.grad_errors(g, w.to(dtype), *TOL[dtype])
        assert bad == 0, (case, worst)


def _chain_keys(x, dimension):
    """The chain of each packed cell by csrc/feqmod_bwd.cu's rule, cell by
    cell: 1 (the fallback) where it breaks down, in 3+1D 2 (both chains)
    where detA < 0.01 (its nodes with |y - eta| < detA take the fallback),
    else 0 (f_mod)."""
    keys = []
    for row in x.tolist():
        bd, detA = row[feqmod.FQ["bd"]], row[feqmod.FQ["detA"]]
        narrow = dimension == 3 and float(
            torch.tensor(detA, dtype=x.dtype)) < float(
                torch.tensor(feqmod.NARROW_DETA, dtype=x.dtype))
        keys.append(1 if bd != 0 else 2 if narrow else 0)
    return keys


@pytest.mark.parametrize("case", ["3d_df4_narrow", "3d_df4_clamp",
                                  "3d_df4_mixed", "2d_remap_df4_most",
                                  "2d_df3_ragged"])
def test_feqmod_bwd_chain_split(case):
    """chain_split on the CPU: the index lists form a permutation of
    the group, each cell lands in its chain's list (the breakdown flag, and
    in 3+1D the narrow rule) and each list keeps the cells' order; on
    shuffled cells too."""
    x, _, _, _, flags, _ = testing.feqmod_grad_inputs(case)
    perm = torch.randperm(x.shape[0], generator=torch.Generator().manual_seed(3))
    for cells in (x, x[perm]):
        order, offs = feqmod.chain_split(cells, flags.dimension)
        assert order.dtype == offs.dtype == torch.int32
        assert offs.tolist()[0] == 0 and offs.tolist()[-1] == cells.shape[0]
        assert sorted(order.tolist()) == list(range(cells.shape[0]))
        keys = _chain_keys(cells, flags.dimension)
        for j in range(len(feqmod.CHAINS)):
            part = order[offs[j]:offs[j + 1]].tolist()
            assert part == [i for i, k in enumerate(keys) if k == j]
        if flags.dimension == 2:
            assert offs[2] == offs[3]
    if case == "3d_df4_narrow":
        assert offs[3] - offs[2] > 0 and offs[1] == 0


# groups of one chain, of the other, of both, and of 3+1D narrow cells
CHAIN_GROUPS = [("3d_df4_mixed", (0,)), ("3d_df4_mixed", (1,)),
                ("3d_df4_mixed", (0, 1)), ("3d_df4_narrow", (2,)),
                ("3d_df4_clamp", (0, 1, 2)), ("2d_remap_df4_most", (0,)),
                ("2d_remap_df4_most", (1,)), ("2d_remap_df3_mixed", (0, 1))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case,chains", CHAIN_GROUPS,
                         ids=[f"{c}-{''.join(map(str, k))}"
                              for c, k in CHAIN_GROUPS])
def test_feqmod_bwd_chain_groups(cuda_card, case, chains, dtype):
    """K10 on groups whose cells all take one chain's instantiation, the
    other's, both, and the 3+1D narrow cells' two-chain body, against the
    plain version as test_feqmod_bwd_kernel_matches_plain holds it; two
    launches bit-identical."""
    x, rn, wcs, mom, flags, G = testing.feqmod_grad_inputs(case, dtype=dtype,
                                                           device="cuda")
    keys = torch.tensor(_chain_keys(x, flags.dimension), device="cuda")
    pick = torch.isin(keys, torch.tensor(chains, device="cuda"))
    x, rn, wcs = (t[pick].contiguous() for t in (x, rn, wcs))
    assert sorted(set(keys[pick].tolist())) == list(chains)
    want = feqmod.feqmod_bwd_plain(x.double(), rn.double(), wcs.double(),
                                   G.double(), mom.to(None, torch.float64),
                                   flags)
    got = feqmod.feqmod_bwd_cuda(x, rn, wcs, G, mom, flags)
    again = feqmod.feqmod_bwd_cuda(x, rn, wcs, G, mom, flags)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g, w in zip(got, want):
        bad, worst = testing.grad_errors(g, w.to(dtype), *TOL[dtype])
        assert bad == 0, (case, chains, worst)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["3d_df4_clamp", "3d_df3_ragged",
                                  "2d_remap_df3_mixed", "2d_df4_most"])
def test_feqmod_bwd_permutation_invariance(cuda_card, case, dtype):
    """A permutation of a group's cells permutes K10's grad and grad_rn bit
    for bit: a cell's sums run over its own nodes in node order, whatever
    cells share its group or block and wherever its chain's part puts it."""
    x, rn, wcs, mom, flags, G = testing.feqmod_grad_inputs(case, dtype=dtype,
                                                           device="cuda")
    perm = torch.randperm(x.shape[0], generator=torch.Generator().manual_seed(
        11)).to("cuda")
    got = feqmod.feqmod_bwd_cuda(x, rn, wcs, G, mom, flags)
    moved = feqmod.feqmod_bwd_cuda(x[perm].contiguous(), rn[perm].contiguous(),
                                   wcs[perm].contiguous(), G, mom, flags)
    torch.cuda.synchronize()
    for a, b in zip(got, moved):
        assert torch.equal(a[perm], b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", VAH)
def test_vah_bwd_kernel_matches_plain(cuda_card, case, dtype):
    x, mom, flags, G = testing.vah_grad_inputs(case, dtype=dtype, device="cuda")
    want = vah.vah_bwd_plain(x.double(), G.double(),
                             mom.to(None, torch.float64), flags)
    got = vah.vah_bwd_cuda(x, G, mom, flags)
    again = vah.vah_bwd_cuda(x, G, mom, flags)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    bad, worst = testing.grad_errors(got, want.to(dtype), *TOL[dtype])
    assert bad == 0, (case, worst)


@pytest.mark.gpu
def test_feqmod_vah_autograd_functions_launch_the_backward_kernels(
        cuda_card):
    """Under autograd on the card the df 3-4 and VAH spectra run their
    backward kernels once a group (the launch counts move), and their
    forwards are the production kernels' bit for bit."""
    x, rn, wcs, mom, flags, G = testing.feqmod_grad_inputs("2d_remap_df3_mixed",
                                                    device="cuda")
    n0 = feqmod.BWD_REMAP_LAUNCHES
    xg, rg = x.clone().requires_grad_(True), rn.clone().requires_grad_(True)
    out = feqmod.group_spectra(xg, rg, wcs, mom, flags)
    assert torch.equal(out.detach(), feqmod.feqmod_spectra_cuda(x, rn, wcs,
                                                                mom, flags))
    got = torch.autograd.grad(out, (xg, rg), G)
    assert feqmod.BWD_REMAP_LAUNCHES == n0 + 1
    assert all(torch.equal(a, b) for a, b in zip(
        got, feqmod.feqmod_bwd_cuda(x, rn, wcs, G, mom, flags)))
    x, mom, flags, G = testing.vah_grad_inputs("3d_sw3", device="cuda")
    n0 = vah.BWD_LAUNCHES
    xg = x.clone().requires_grad_(True)
    out = vah.group_spectra(xg, mom, flags)
    assert torch.equal(out.detach(), vah.vah_spectra_cuda(x, mom, flags))
    (g,) = torch.autograd.grad(out, xg, G)
    assert vah.BWD_LAUNCHES == n0 + 1
    assert torch.equal(g, vah.vah_bwd_cuda(x, G, mom, flags))


def test_polzn_backward_yardstick():
    """K12's operations per evaluation exceed twice the forward's (K6's),
    its SFU count is the forward's, and the remap adds its row's node
    kinematics and d/dDelta, a share that falls as n_phi grows."""
    for remap in (False, True):
        fwd = polzn.polzn_formula_ops(remap, 24)
        bwd = polzn.polzn_backward_formula_ops(remap, 24)
        assert bwd[0] > 2 * fwd[0] and bwd[1] == fwd[1]
    fixed = polzn.polzn_backward_formula_ops(False, 24)
    assert fixed == (polzn.POLZN_BWD_OPS[0] + polzn.POLZN_BWD_ROW_OPS / 24,
                     polzn.POLZN_BWD_OPS[1])
    b = {n: polzn.polzn_backward_formula_ops(True, n)[0] for n in (8, 24)}
    assert b[8] > b[24] > fixed[0]
    assert b[8] - b[24] == pytest.approx(polzn.POLZN_BWD_REMAP_ROW_OPS
                                         * (1 / 8 - 1 / 24))


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The bit pattern of a float tensor (NaN equals NaN of the same
    bits)."""
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def _polzn_bwd_check(got, want, plain, dtype):
    """A K12 gradient against the f64 plain one at TOL[dtype] per field,
    its NaN and inf where the plain version in ``dtype`` (``plain``) has
    them (a massless species)."""
    for f in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(f(got), f(plain)), f.__name__
    fin = torch.isfinite(plain) & torch.isfinite(want)
    bad, worst = testing.grad_errors(torch.where(fin, got.double(), 0.0),
                                     torch.where(fin, want, 0.0).to(dtype),
                                     *TOL[dtype])
    assert bad == 0, worst


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", POLZN)
def test_polzn_bwd_kernel_matches_plain(cuda_card, case, dtype):
    x, mom, pm, wR, flags, table, G = testing.polzn_grad_inputs(
        case, dtype=dtype, device="cuda")
    want = polzn.polzn_bwd_plain(x.double(), G.double(),
                                 mom.to(None, torch.float64), pm.double(),
                                 wR.double(), flags)
    plain = polzn.polzn_bwd_plain(x, G, mom, pm, wR, flags)
    n0 = polzn.BWD_REMAP_LAUNCHES if flags.remap else polzn.BWD_LAUNCHES
    got = polzn.polzn_bwd_cuda(x, G, mom, pm, wR, flags, table)
    again = polzn.polzn_bwd_cuda(x, G, mom, pm, wR, flags, table)
    torch.cuda.synchronize()
    assert (polzn.BWD_REMAP_LAUNCHES if flags.remap
            else polzn.BWD_LAUNCHES) == n0 + 2
    assert torch.equal(_bits(got), _bits(again))
    _polzn_bwd_check(got, want, plain, dtype)


# the plan test's shapes: 3+1D with 21 nodes and 302 species (a ragged last
# species chunk in float32 and float64), 2+1D fixed nodes, the remap with
# 19 pT rows (a partial last tile); an odd n_phi everywhere
POLZN_PLAN = {
    "3d": dict(n_species=302, grid=dict(n_pT=3, n_phi=7, n_y=21)),
    "2d_fixed": dict(n_species=301, grid=dict(n_pT=3, n_phi=7, n_eta=13)),
    "2d_remap": dict(n_species=23, grid=dict(n_pT=19, n_phi=7, n_eta=12,
                                             eta_mT_rescale=True)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", sorted(POLZN_PLAN))
def test_polzn_bwd_plan_stages_and_tail(cuda_card, case, dtype):
    """K12a's and K12b's plans (polzn.bwd_props) on shapes that leave
    their tails: the 3+1D species' last chunk is ragged, n_phi is not a
    multiple of K12a's angles a stage, the remap's last tile of pT rows is
    partial, and the cell counts 1, CT - 1 and CT + 1 (CT the cells a
    block) leave the last block partly empty; each against the plain
    version in float64, two launches bit-identical.  No float32 plan
    spills."""
    spec = POLZN_PLAN[case]
    x, mom, pm, wR, flags, table, G = testing.polzn_grad_inputs(
        case, n_cells=8, dtype=dtype, device="cuda", **spec)
    f64 = dtype == torch.float64
    plan = polzn.bwd_props("cuda", f64, mom, flags, 8)
    S, F = mom.mass.shape[0], mom.n_phi
    if case == "3d":
        sc = plan["species_per_stage"]
        assert sc < S and S % sc, plan
    if flags.remap:
        assert mom.pT.shape[0] % plan["pT_rows_per_stage"], plan
    else:
        assert F % plan["angles"], plan
    if not f64:
        assert plan["local_bytes"] == 0, plan
    ct = plan["cells_per_block"]
    for n in sorted({1, max(ct - 1, 1), ct + 1}):
        x, mom, pm, wR, flags, table, G = testing.polzn_grad_inputs(
            case, n_cells=n, dtype=dtype, device="cuda", **spec)
        want = polzn.polzn_bwd_plain(
            x.double(), G.double(), mom.to(None, torch.float64), pm.double(),
            wR.double(), flags)
        plain = polzn.polzn_bwd_plain(x, G, mom, pm, wR, flags)
        got = polzn.polzn_bwd_cuda(x, G, mom, pm, wR, flags, table)
        again = polzn.polzn_bwd_cuda(x, G, mom, pm, wR, flags, table)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(again)), n
        _polzn_bwd_check(got, want, plain, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["3d_ragged", "2d_remap"])
def test_polzn_autograd_function_launches_the_backward_kernel(cuda_card,
                                                               case):
    """Under autograd on the card the polarization runs its backward kernel
    once a group (the launch count moves), and its forward is the
    production kernel's bit for bit."""
    x, mom, pm, wR, flags, table, G = testing.polzn_grad_inputs(
        case, device="cuda")
    n0 = polzn.BWD_REMAP_LAUNCHES if flags.remap else polzn.BWD_LAUNCHES
    xg = x.clone().requires_grad_(True)
    out = polzn._PolznKernel.apply(xg, mom, pm, wR, flags, table)
    assert all(torch.equal(a, b) for a, b in zip(
        out.detach().unbind(0), polzn.polzn_cuda(x, mom, pm, wR, flags,
                                                 table)))
    (g,) = torch.autograd.grad(out, xg, G)
    assert (polzn.BWD_REMAP_LAUNCHES if flags.remap
            else polzn.BWD_LAUNCHES) == n0 + 1
    assert torch.equal(g, polzn.polzn_bwd_cuda(x, G, mom, pm, wR, flags,
                                               table))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", SPECTRA)
def test_spectra_bwd_kernel_matches_plain(cuda_card, case, dtype):
    cells, mom, flags, G = testing.spectra_grad_inputs(case, dtype=dtype,
                                                       device="cuda")
    want = smooth.spectra_bwd_plain(cells.double(), G.double(),
                                    mom.to(None, torch.float64), flags)
    got = smooth.spectra_bwd_cuda(cells, G, mom, flags)
    again = smooth.spectra_bwd_cuda(cells, G, mom, flags)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    bad, worst = testing.grad_errors(got, want, *TOL[dtype])
    assert bad == 0, (case, worst)


@pytest.mark.gpu
@pytest.mark.parametrize("outflow", [False, True], ids=["clip_off",
                                                        "clip_on"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["3d_df2_ragged", "2d_df1_ragged"])
def test_spectra_bwd_kernel_does_not_hide_nan(cuda_card, case, dtype,
                                              outflow):
    """A NaN d sigma_x in one cell: the fixed-node kernel's gradient is NaN
    wherever the plain version's is (the outflow mask lets a NaN p.dsigma
    through), and every other cell's row holds the plain version's."""
    cells, mom, flags, G = testing.spectra_grad_inputs(case, n_cells=24,
                                                       dtype=dtype,
                                                       device="cuda")
    flags = dataclasses.replace(flags, outflow=outflow)
    assert not flags.remap
    cells[5, 2] = float("nan")                        # the column dax
    want = smooth.spectra_bwd_plain(cells.double(), G.double(),
                                    mom.to(None, torch.float64), flags)
    got = smooth.spectra_bwd_cuda(cells, G, mom, flags)
    torch.cuda.synchronize()
    nan = torch.isnan(want)
    assert nan[5].any() and not nan[torch.arange(len(want)) != 5].any()
    assert torch.isnan(got)[nan].all(), (got[5], want[5])
    rest = torch.arange(len(want)) != 5
    bad, worst = testing.grad_errors(got[rest], want[rest], *TOL[dtype])
    assert bad == 0, (case, worst)


@pytest.mark.gpu
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_spectra_bwd_plan_stages_and_tail(cuda_card, f64):
    """K9a's plan (smooth.bwd_props): 3d_species_chunks takes two species
    chunks a stage; 3d_partial_block's last block is partly empty; at the
    3+1D main shape (a 16384-cell group, 320 species, 32 x 24 x 21) a block
    holds 128 // 21 = 6 cells, the float32 kernel holds 16 warps an SM,
    its waves are its blocks over the card's resident blocks, and no plan
    spills."""
    dt = torch.float64 if f64 else torch.float32
    cells, mom, flags = testing.spectra_edge_inputs(
        "3d_species_chunks", dtype=dt, device="cuda")
    plan = smooth.bwd_props("cuda", f64, mom, flags, cells.shape[0])
    assert plan["species_per_stage"] < mom.mass.shape[0], plan
    cells, mom, flags = testing.spectra_edge_inputs(
        "3d_partial_block", dtype=dt, device="cuda")
    plan = smooth.bwd_props("cuda", f64, mom, flags, cells.shape[0])
    assert cells.shape[0] % plan["cells_per_block"], plan
    grid = native_momentum_grid(3, dtype=dt, device="cuda")
    mom = smooth.momentum_constants(
        testing.synthetic_species(320, dtype=dt, device="cuda"), grid, 3)
    plan = smooth.bwd_props("cuda", f64, mom, flags, 16384)
    assert plan["local_bytes"] == 0 and plan["cells_per_block"] == 6, plan
    slots = plan["blocks_per_sm"] * torch.cuda.get_device_properties(
        0).multi_processor_count
    assert plan["waves"] == -(-(-(-16384 // plan["cells_per_block"]))
                              // slots), plan
    if not f64:
        assert plan["blocks_per_sm"] * plan["threads"] == 16 * 32, plan


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", DECAYS)
def test_wave_bwd_kernel_matches_plain(cuda_card, case, dtype):
    tables, tasks, wg, G = testing.decay_grad_inputs(case, dtype=dtype,
                                                     device="cuda")
    want = decays.wave_bwd_plain(tables.to(None, torch.float64),
                                 tasks.to(None, torch.float64),
                                 wg.to(None, torch.float64), G)
    got = decays.wave_bwd_cuda(tables, tasks, wg, G)
    again = decays.wave_bwd_cuda(tables, tasks, wg, G)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    bad, worst = testing.grad_errors(got, want, *TOL[dtype])
    assert bad == 0, (case, worst)
    # the route by dtype: float32 slot words in shared memory (they fit),
    # float64 the device's words
    route = decays.wave_bwd_blocking(tables, tasks, wg)["route"]
    assert route == ("shared" if dtype == torch.float32 else "device")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(testing.DECAY_ROUTE_EDGES))
def test_wave_bwd_kernel_device_route_matches_plain(cuda_card, case):
    """The 3-body 3+1D wave on a grid whose float32 slot words do not fit
    in shared memory (testing.DECAY_ROUTE_EDGES) takes K9c's device route
    by shape, and agrees with the plain version as the shared route does
    (float32 only: the forward kernel stages a float64 table of this grid
    nowhere)."""
    tables, tasks, wg, G = testing.decay_grad_inputs(
        case, dtype=torch.float32, device="cuda")
    assert decays.wave_bwd_blocking(tables, tasks, wg)["route"] == "device"
    want = decays.wave_bwd_plain(tables.to(None, torch.float64),
                                 tasks.to(None, torch.float64),
                                 wg.to(None, torch.float64), G)
    got = decays.wave_bwd_cuda(tables, tasks, wg, G)
    again = decays.wave_bwd_cuda(tables, tasks, wg, G)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    bad, worst = testing.grad_errors(got, want, *TOL[torch.float32])
    assert bad == 0, (case, worst)


@pytest.mark.gpu
def test_autograd_functions_launch_the_backward_kernels(cuda_card):
    """Under autograd on the card the spectra and the feed-down run their
    backward kernels (the launch counts move), and their forwards are the
    production kernels' bit for bit."""
    cells, mom, flags, G = testing.spectra_grad_inputs(
        "2d_remap_df2_ragged", device="cuda")
    n0 = smooth.BWD_REMAP_LAUNCHES
    x = cells.clone().requires_grad_(True)
    out = smooth.group_spectra(x, mom, flags)
    assert torch.equal(out.detach(), smooth.smooth_spectra_cuda(cells, mom,
                                                                flags))
    (g,) = torch.autograd.grad(out, x, G)
    assert smooth.BWD_REMAP_LAUNCHES == n0 + 1
    assert torch.equal(g, smooth.spectra_bwd_cuda(cells, G, mom, flags))
    table, mcids = testing.synthetic_decaying_table(24)
    from is3d_tpu_torch.config import Config
    from is3d_tpu_torch.io.tables import native_momentum_grid
    grid = native_momentum_grid(2, n_pT=7, pT_max=3.0, n_phi=9, n_eta=4,
                                device="cuda")
    cfg = Config(dimension=2, do_resonance_decays=1)
    spectra = torch.as_tensor(testing.thermal_spectra(
        table, mcids, grid.to("cpu"), 2), device="cuda")
    n2 = decays.TWO_BODY_BWD_LAUNCHES + decays.THREE_BODY_BWD_LAUNCHES
    s = spectra.clone().requires_grad_(True)
    dec = decays.resonance_feed_down_traced(s, table, mcids, grid, cfg)
    assert torch.equal(dec.detach(), decays.do_resonance_decays(
        spectra, table, mcids, grid, cfg))
    (gs,) = torch.autograd.grad(dec.sum(), s)
    assert torch.isfinite(gs).all()
    assert decays.TWO_BODY_BWD_LAUNCHES + decays.THREE_BODY_BWD_LAUNCHES > n2


def test_diff_and_batch_import_no_jax():
    """A fresh interpreter takes a gradient through diff and a batched run
    through batch without importing jax, flax or is3d_tpu."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = r"""
import json, sys
import torch
from is3d_tpu_torch import batch, diff, testing
from is3d_tpu_torch.config import Config
from is3d_tpu_torch.io.tables import native_momentum_grid
g = native_momentum_grid(2, n_pT=3, n_phi=4, n_eta=5)
sp, df = testing.synthetic_species(4), testing.synthetic_deltaf_data()
cfg = Config(dimension=2, df_mode=2, include_shear_deltaf=1)
s = testing.synthetic_surface(20, 2)
fn = diff.spectra_fn(sp, g, df, cfg)
_, gr = diff.surface_value_and_grad(lambda x: diff.dN_dy_j(fn(x), g).sum(),
                                    s, ("T",))
out = batch.smooth_spectra_batched(batch.stack_surfaces([s, s]), sp, g, df,
                                   cfg)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "is3d_tpu"))
print(json.dumps({"grad": bool(torch.isfinite(gr["T"]).all()),
                  "rows": bool(torch.equal(out[0], out[1])), "bad": bad}))
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-c", script], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res == {"grad": True, "rows": True, "bad": []}
