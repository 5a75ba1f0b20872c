"""The df 3-4 forward kernels' inputs and chains without JAX (csrc/feqmod.cu
fixed_kernel and remap_kernel): on the CPU, feqmod.chain_split,
feqmod.fixed_stage and feqmod.remap_stage lay a group out as the kernels
read it, and the emission evaluated from the staged rows, one chain a cell
as the kernels branch, equals the plain version's feqmod_block in
float64; on a CUDA card (gpu-marked), each chain's instantiation against
the plain version on every testing.FEQMOD_EDGES case, a shuffled group
within tolerance of the group, and two launches bit-identical.

On the GPU: python -m pytest tests/test_torch_feqmod_kernels.py -m gpu
--noconftest (the conftest imports jax).  Tolerances: float32 rtol 2e-4 /
atol 2e-5 x max, float64 1e-10 / 1e-13 x max (the kernel's sums run in
another order than the plain version's); the staged evaluation in float64
at 1e-12 x max (the same formulas, grouped as the kernel groups them).
"""

import math

import numpy as np
import pytest
import torch

from is3d_tpu_torch import testing
from is3d_tpu_torch.kernels import feqmod, smooth

torch.set_num_threads(1)

TOL = {torch.float32: (2e-4, 2e-5), torch.float64: (1e-10, 1e-13)}
# the FEQMOD_EDGES cases at fixed nodes and with the remap
FIXED = sorted(c for c in testing.FEQMOD_EDGES if "remap" not in c)
REMAP = sorted(c for c in testing.FEQMOD_EDGES if "remap" in c)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the GPU: python -m pytest "
                    "tests/test_torch_feqmod_kernels.py -m gpu --noconftest)")


def _fallback(b, pdu, pipp, Vp, m2, sgn, bar, flags):
    """The linearized fallback f_eq (1 + df) from u.p, pi:pp and V.p with
    the staged coefficients b(name) (FB_ROW's and REMAP_FB_ROW's names),
    as feqmod.cuh's fallback_fixed groups it."""
    arg = pdu * b("L/T")
    if flags.df_mode == 3:
        arg = arg + bar * b("-L alphaB")
    feq = 1.0 / (torch.exp(arg) + sgn)
    feqbar = 1.0 - sgn * feq
    r = 1.0 / pdu
    d = torch.zeros_like(feq)
    if flags.df_mode == 3:
        if flags.shear:
            d = (b("ksh") * pipp) * r
        if flags.bulk:
            d = d + (b("k3 bulkPi") * (pdu - m2 * r)
                     + (b("kF bulkPi") * pdu + b("kG bulkPi") * bar))
        if flags.diff:
            d = d + feqmod._zero_safe_mul((b("benth") - bar * r) * Vp,
                                          b("kV"))
        d = feqbar * d
    else:
        if flags.shear:
            d = ((feqbar * b("ksh")) * pipp) * r
        if flags.bulk:
            d = d + ((feqbar * b("dl/T")) * (pdu - m2 * r) + b("dz - 3 dl"))
    if flags.regulate:
        d = torch.clamp(d, -1.0, 1.0)
    return feq * d + feq if (flags.shear or flags.bulk or flags.diff) else feq


def _staged_block(st: feqmod.FixedStage, mom, flags) -> torch.Tensor:
    """The (C, R, S, P, F) emission of fixed_stage's rows in their chain
    order, evaluated as csrc/feqmod.cu evaluates it (float64: L = 1): a
    row of the f_mod part takes f_mod, of the fallback part the fallback,
    of the narrow part f_mod but the fallback where its composites' narrow
    flag is set; without node weights, prefactor or degeneracy."""
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    R = mom.nodes.shape[0]
    C = st.mrow.shape[0]
    offs = st.offs.tolist()
    key = torch.zeros(C, dtype=torch.long)
    for j in range(3):
        key[offs[j]:offs[j + 1]] = j
    row = lambda t, names, n: t[:, names.index(n)].view(C, 1, 1, 1, 1)
    m = lambda n: row(st.mrow, feqmod.MOD_ROW, n)
    b = lambda n: row(st.frow, feqmod.FB_ROW, n)
    comp = lambda t, names, n: t[:, :R, names.index(n)].view(C, R, 1, 1, 1)
    mc = lambda n: comp(st.mcomp, feqmod.MOD_COMP, n)
    fc = lambda n: comp(st.fcomp, feqmod.FB_COMP, n)
    sp = lambda t: t.view(1, 1, S, 1, 1)
    m2 = sp(mom.mass ** 2)
    sgn, bar = sp(mom.sign), sp(mom.baryon)
    mT = torch.sqrt(mom.mass[:, None] ** 2 + mom.pT[None, :] ** 2).view(
        1, 1, S, P, 1)
    px = mom.px.view(1, 1, 1, P, F)
    py = mom.py.view(1, 1, 1, P, F)
    cs = lambda t: t[:, :S].reshape(C, 1, S, 1, 1)
    # f_mod
    x = [mT * mc(f"a{i}") + (m(f"gx{i}") * px + m(f"gy{i}") * py)
         for i in range(3)]
    e2 = x[0] * x[0] + x[1] * x[1] + x[2] * x[2] + m2
    e2 = torch.where(torch.isnan(e2), torch.full_like(e2, math.inf), e2)
    f_mod = cs(st.rnw) / (torch.exp(torch.sqrt(e2) * m("L/T_mod")
                                    + m("-L alphaB_mod") * bar) + sgn)
    pds_m = mT * mc("A1") + (m("dax") * px + m("day") * py)
    keep = f_mod != 0
    if flags.outflow:
        keep = keep & (pds_m > 0)
    v_mod = torch.where(keep, pds_m * f_mod, torch.zeros_like(f_mod))
    # the fallback
    pdu = mT * fc("B1") + (b("-ux") * px + b("-uy") * py)
    pipp = (mT * mT * fc("C1") + mT * (px * fc("C2") + py * fc("C3"))
            + (b("pixx") * px * px + b("piyy") * py * py
               + b("2 pixy") * (px * py)))
    Vp = mT * fc("D1") + (b("-Vx") * px + b("-Vy") * py)
    f_fb = _fallback(b, pdu, pipp, Vp, m2, sgn, bar, flags)
    pds_f = mT * fc("A1") + (b("dax") * px + b("day") * py)
    v_fb = pds_f * f_fb
    if flags.outflow:
        v_fb = torch.where(pds_f > 0, v_fb, torch.zeros_like(v_fb))
    v_fb = v_fb * cs(st.wj)
    fb = ((key == 1).view(C, 1, 1, 1, 1)
          | ((key == 2).view(C, 1, 1, 1, 1) & (fc("narrow") != 0)))
    return torch.where(fb, v_fb, v_mod)


def _fb_coefficients(g) -> dict:
    """The fallback's coefficients the rows name, from the packed fields:
    df 3's bulk coefficients times bulkPi, df 4's dl over T."""
    return {"ksh": g("ksh"), "kF bulkPi": g("kF") * g("bulkPi"),
            "kG bulkPi": g("kG") * g("bulkPi"),
            "k3 bulkPi": g("k3") * g("bulkPi"), "benth": g("benth"),
            "kV": g("kV"), "dz - 3 dl": g("dz") - 3 * g("dl"),
            "dl/T": g("dl") * g("invT")}


@pytest.mark.parametrize("case", FIXED)
def test_fixed_stage_is_what_the_kernel_reads(case):
    """fixed_stage lays a group out as csrc/feqmod.cu's fixed_kernel reads
    it: the cells in chain_split's order; each per-cell row and per-(cell,
    node) composite what MOD_ROW, FB_ROW, MOD_COMP and FB_COMP name (L = 1
    in float64); the nodes padded to whole register blocks by repeating
    the last, whose weight is 0; the species padded to a multiple of J
    with zeros; every row a whole number of 16-byte vectors."""
    x, rn, wcs, mom, flags, _, _ = testing.feqmod_edge_inputs(case)
    st = feqmod.fixed_stage(x, rn, wcs, mom, flags)
    order, offs = feqmod.chain_split(x, flags.dimension)
    assert torch.equal(st.offs, offs)
    C, R, S = x.shape[0], mom.nodes.shape[0], mom.mass.shape[0]
    rp = -(-R // feqmod.FIXED_YC) * feqmod.FIXED_YC
    s4 = -(-S // feqmod.FIXED_J) * feqmod.FIXED_J
    shapes = dict(mrow=(C, len(feqmod.MOD_ROW)), frow=(C, len(feqmod.FB_ROW)),
                  mcomp=(C, rp, len(feqmod.MOD_COMP)),
                  fcomp=(C, rp, len(feqmod.FB_COMP)), rnw=(C, s4),
                  wj=(C, s4), weights=(rp,))
    for name, shape in shapes.items():
        t = getattr(st, name)
        assert tuple(t.shape) == shape and t.is_contiguous(), name
        assert t.shape[-1] * t.element_size() % 16 == 0 or name == "weights"
    xo = x[order.long()]
    g = lambda n: xo[:, feqmod.FQ[n]]
    want_m = dict(dax=g("dax"), day=g("day"), **{
        f"g{a}{i}": g(f"g{a}{i}") for a in "xy" for i in range(3)},
        **{"L/T_mod": g("invTm"), "-L alphaB_mod": -g("abm")})
    want_b = {"dax": g("dax"), "day": g("day"), "-ux": -g("ux"),
              "-uy": -g("uy"), "pixx": g("pixx"), "piyy": g("piyy"),
              "2 pixy": 2 * g("pixy"), "L/T": g("invT"),
              "-L alphaB": -g("alphaB"), "-Vx": -g("Vx"), "-Vy": -g("Vy"),
              **_fb_coefficients(g)}
    for t, names, want in ((st.mrow, feqmod.MOD_ROW, want_m),
                           (st.frow, feqmod.FB_ROW, want_b)):
        for i, n in enumerate(names):
            if n:
                assert torch.equal(t[:, i], want[n]), n
            else:
                assert not t[:, i].any()
    # the composites at node r: feqmod_node's, the last node repeated
    node = mom.nodes[torch.clamp(torch.arange(rp), max=R - 1)][None, :]
    c = lambda n: g(n)[:, None]
    du = node - c("eta") if flags.dimension == 3 else -node.expand(C, rp)
    ds = du if flags.dimension == 3 else -(c("scale") * node)
    cs, ss, ch, sh = torch.cosh(ds), torch.sinh(ds), torch.cosh(du), \
        torch.sinh(du)
    tsh = sh * c("tau")
    want_mc = [cs * c("dat") + ss * c("dant")] + [
        cs * c(f"a{i}") + ss * c(f"b{i}") for i in range(3)]
    want_fc = [ch * c("dat") + sh * c("dant"), ch * c("ut") - sh * c("tun"),
               ch * ch * c("pitt") + tsh * tsh * c("pinn")
               - 2 * ch * tsh * c("pitn"),
               -2 * (ch * c("pitx") - tsh * c("pixn")),
               -2 * (ch * c("pity") - tsh * c("piyn")),
               ch * c("Vt") - tsh * c("Vn")]
    # (torch's vectorized cosh and sinh may round a strided tensor apart
    # from a contiguous one by an ulp: C1 cancels)
    for t, want in ((st.mcomp, want_mc), (st.fcomp, want_fc)):
        for i, w in enumerate(want):
            torch.testing.assert_close(t[..., i], w, rtol=1e-13,
                                       atol=1e-13 * w.abs().max().item())
    narrow = st.fcomp[..., feqmod.FB_COMP.index("narrow")]
    if flags.dimension == 3:
        assert torch.equal(narrow != 0, du.abs() < c("detA"))
    else:
        assert not narrow.any()
    assert not st.fcomp[..., -1].any()
    assert torch.equal(st.weights[:R], mom.weights)
    assert not st.weights[R:].any()
    assert torch.equal(st.rnw[:, :S], (rn * wcs)[order.long()])
    assert torch.equal(st.wj[:, :S], wcs[order.long()])
    assert not st.rnw[:, S:].any() and not st.wj[:, S:].any()


@pytest.mark.parametrize("case", FIXED)
def test_fixed_stage_evaluates_to_feqmod_block(case):
    """The emission evaluated from fixed_stage's rows (each cell on its
    chain, the kernel's grouping of the formulas) equals the plain
    version's feqmod_block at every (cell, node, species, point) in
    float64, NaN where it is NaN."""
    x, rn, wcs, mom, flags, _, _ = testing.feqmod_edge_inputs(case)
    st = feqmod.fixed_stage(x, rn, wcs, mom, flags)
    order, _ = feqmod.chain_split(x, flags.dimension)
    got = _staged_block(st, mom, flags)
    want = feqmod.feqmod_block(x, rn, wcs, mom, flags)[order.long()]
    scale = want.nan_to_num(0.0, 0.0, 0.0).abs().max().item()
    assert scale > 0
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12 * scale,
                               equal_nan=True)
    assert torch.equal(got[want == 0], want[want == 0])


def _remap_staged_block(st: feqmod.RemapStage, mom, flags) -> torch.Tensor:
    """The (C, R, S, P, F) emission of remap_stage's rows in their chain
    order, evaluated as csrc/feqmod.cu's remap_kernel evaluates it
    (float64): f_mod at the nodes y_flow + zscale s(mT) eta_r through
    exp(+-delta), the fallback at the shared nodes y_flow - s eta_r
    through the node table; (cell, phi) terms at unit pT."""
    S, P, F = mom.mass.shape[0], mom.pT.shape[0], mom.n_phi
    R = mom.nodes.shape[0]
    C = st.mrow.shape[0]
    offs = st.offs.tolist()
    fb = torch.zeros(C, dtype=torch.bool)
    fb[offs[1]:offs[2]] = True
    fb = fb.view(C, 1, 1, 1, 1)
    row = lambda t, names, n: t[:, names.index(n)].view(C, 1, 1, 1, 1)
    m = lambda n: row(st.mrow, feqmod.REMAP_MOD_ROW, n)
    b = lambda n: row(st.frow, feqmod.REMAP_FB_ROW, n)
    sp = lambda t: t.view(1, 1, S, 1, 1)
    m2 = sp(mom.mass ** 2)
    sgn, bar = sp(mom.sign), sp(mom.baryon)
    mT = torch.sqrt(mom.mass[:, None] ** 2 + mom.pT[None, :] ** 2).view(
        1, 1, S, P, 1)
    pt = mom.pT.view(1, 1, 1, P, 1)
    sv = smooth.remap_scale(mom).view(1, 1, S, P, 1)
    eta = mom.nodes.view(1, R, 1, 1, 1)
    cf = mom.cos_phi.view(1, 1, 1, 1, F)
    sf = mom.sin_phi.view(1, 1, 1, 1, F)
    cs = lambda t: t.reshape(C, 1, S, 1, 1)
    # f_mod
    eq = m("exp(yfm)") * torch.exp(m("zscale") * sv * eta)
    rq = 1.0 / eq
    node = lambda p, q: (mT * m(p)) * eq + (mT * m(q)) * rq
    A = node("(dat+dant)/2", "(dat-dant)/2")
    x = [pt * (m(f"gx{i}") * cf + m(f"gy{i}") * sf)
         + node(f"(a{i}+b{i})/2", f"(a{i}-b{i})/2") for i in range(3)]
    e2 = x[0] * x[0] + x[1] * x[1] + x[2] * x[2] + m2
    e2 = torch.where(torch.isnan(e2), torch.full_like(e2, math.inf), e2)
    f_mod = cs(st.rnzw) / (torch.exp(torch.sqrt(e2) * m("L/T_mod")
                                     + m("-L alphaB_mod") * bar) + sgn)
    pds_m = pt * (m("dax") * cf + m("day") * sf) + A
    keep = f_mod != 0
    if flags.outflow:
        keep = keep & (pds_m > 0)
    v_mod = torch.where(keep, pds_m * f_mod, torch.zeros_like(f_mod))
    # the fallback
    table = smooth.remap_node_table(mom).permute(2, 0, 1, 3)[None]
    ep = b("exp(yflow)") * (0.5 * mT) * table[..., 0, None]
    em = b("exp(-yflow)") * (0.5 * mT) * table[..., 1, None]
    ch, sh = ep + em, ep - em
    pdu = pt * -(b("ux") * cf + b("uy") * sf) + (ch * b("ut")
                                                  + sh * b("-tun"))
    Vp = pt * -(b("Vx") * cf + b("Vy") * sf) + (ch * b("Vt")
                                                 + sh * b("-tau Vn"))
    pipp = ((ch * pt) * (-2.0 * (b("pitx") * cf + b("pity") * sf))
            + (sh * pt) * (2.0 * b("tau") * (b("pixn") * cf
                                             + b("piyn") * sf))
            + pt * pt * (b("pixx") * cf * cf + b("piyy") * sf * sf
                         + 2.0 * b("pixy") * cf * sf)
            + (ch * ch * b("pitt") + sh * sh * b("tau^2 pinn")
               + ch * sh * b("-2 tau pitn")))
    f_fb = _fallback(b, pdu, pipp, Vp, m2, sgn, bar, flags)
    pds_f = pt * (b("dax") * cf + b("day") * sf) + (ch * b("dat")
                                                     + sh * b("dant"))
    v_fb = pds_f * f_fb
    if flags.outflow:
        v_fb = torch.where(pds_f > 0, v_fb, torch.zeros_like(v_fb))
    return torch.where(fb, v_fb * cs(st.wj), v_mod)


@pytest.mark.parametrize("case", REMAP)
def test_remap_stage_is_what_the_kernel_reads(case):
    """remap_stage lays a group out as csrc/feqmod.cu's remap_kernel reads
    it: the cells in chain_split's order (no narrow part in 2+1D); each
    row what REMAP_MOD_ROW and REMAP_FB_ROW name (L = 1 in float64); the
    (cell, species) tables |renorm| x zscale x validity and validity;
    every row a whole number of 16-byte vectors."""
    x, rn, wcs, mom, flags, _, _ = testing.feqmod_edge_inputs(case)
    st = feqmod.remap_stage(x, rn, wcs)
    order, offs = feqmod.chain_split(x, 2)
    assert torch.equal(st.offs, offs) and offs[2] == offs[3]
    C, S = x.shape[0], mom.mass.shape[0]
    for t, shape in ((st.mrow, (C, len(feqmod.REMAP_MOD_ROW))),
                     (st.frow, (C, len(feqmod.REMAP_FB_ROW))),
                     (st.rnzw, (C, S)), (st.wj, (C, S))):
        assert tuple(t.shape) == shape and t.is_contiguous()
    assert st.mrow.shape[1] % 2 == 0 and st.frow.shape[1] % 2 == 0
    o = order.long()
    xo = x[o]
    g = lambda n: xo[:, feqmod.FQ[n]]
    tau = g("tau")
    want = {"exp(yfm)": torch.exp(g("yfm")), "zscale": g("scale"),
            "L/T_mod": g("invTm"), "-L alphaB_mod": -g("abm"),
            "(dat+dant)/2": (g("dat") + g("dant")) / 2,
            "(dat-dant)/2": (g("dat") - g("dant")) / 2,
            "exp(yflow)": torch.exp(g("yflow")),
            "exp(-yflow)": torch.exp(-g("yflow")), "-tun": -g("tun"),
            "-tau Vn": -tau * g("Vn"), "tau^2 pinn": tau * tau * g("pinn"),
            "-2 tau pitn": -2 * tau * g("pitn"), "L/T": g("invT"),
            "-L alphaB": -g("alphaB"), **_fb_coefficients(g)}
    for i in range(3):
        want[f"(a{i}+b{i})/2"] = (g(f"a{i}") + g(f"b{i}")) / 2
        want[f"(a{i}-b{i})/2"] = (g(f"a{i}") - g(f"b{i}")) / 2
    for t, names in ((st.mrow, feqmod.REMAP_MOD_ROW),
                     (st.frow, feqmod.REMAP_FB_ROW)):
        for i, n in enumerate(names):
            if n:
                assert torch.equal(t[:, i], want[n] if n in want else g(n)), n
            else:
                assert not t[:, i].any()
    assert torch.equal(st.rnzw, (rn * x[:, feqmod.FQ["scale"], None]
                                 * wcs)[o])
    assert torch.equal(st.wj, wcs[o])


@pytest.mark.parametrize("case", REMAP)
def test_remap_stage_evaluates_to_feqmod_block(case):
    """The emission evaluated from remap_stage's rows as the remap kernel
    groups it equals the plain version's feqmod_block at every (cell,
    node, species, point) in float64."""
    x, rn, wcs, mom, flags, _, _ = testing.feqmod_edge_inputs(case)
    st = feqmod.remap_stage(x, rn, wcs)
    order, _ = feqmod.chain_split(x, 2)
    got = _remap_staged_block(st, mom, flags)
    want = feqmod.feqmod_block(x, rn, wcs, mom, flags)[order.long()]
    scale = want.nan_to_num(0.0, 0.0, 0.0).abs().max().item()
    assert scale > 0
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12 * scale,
                               equal_nan=True)
    assert torch.equal(got[want == 0], want[want == 0])


def _chain_groups(x, flags):
    """The chains present in a group: (chain index, its cells' indices)."""
    order, offs = feqmod.chain_split(x, flags.dimension)
    offs = offs.tolist()
    return [(j, order[offs[j]:offs[j + 1]].long().sort().values)
            for j in range(3) if offs[j + 1] > offs[j]]


def test_chain_groups_cover_the_edges():
    """Every chain's instantiation has cells on some edge case: f_mod, the
    fallback, and the 3+1D narrow cells' two-chain body at fixed nodes;
    f_mod and the fallback with the remap; each in float32 and float64 by
    the gpu test below."""
    seen = set()
    for case in FIXED + REMAP:
        x, _, _, _, flags, _, _ = testing.feqmod_edge_inputs(case)
        seen |= {(flags.dimension, flags.remap, j)
                 for j, _ in _chain_groups(x, flags)}
    assert seen == {(3, False, 0), (3, False, 1), (3, False, 2),
                    (2, False, 0), (2, False, 1), (2, True, 0), (2, True, 1)}


def _check(got, want, dtype):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=rtol,
                               atol=atol * want.abs().max().item())
    zero = want == 0
    assert torch.equal(got[zero], want[zero])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("case", FIXED + REMAP)
def test_chain_instantiations_match_plain_on_gpu(cuda_card, case, dtype):
    """Each chain's instantiation alone (the group cut to that chain's
    cells, so the other chains' launches have no cells) against the plain
    version, two launches bit-identical; the whole group shuffled against
    the group within tolerance (another chain order of the same cells)."""
    x, rn, wcs, mom, flags, _, _ = testing.feqmod_edge_inputs(
        case, dtype=dtype, device="cuda")
    for _, idx in _chain_groups(x, flags):
        xs, rns, wcss = (t[idx].contiguous() for t in (x, rn, wcs))
        got = feqmod.feqmod_spectra_cuda(xs, rns, wcss, mom, flags)
        again = feqmod.feqmod_spectra_cuda(xs, rns, wcss, mom, flags)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _check(got, feqmod.feqmod_spectra_plain(xs, rns, wcss, mom, flags),
               dtype)
    perm = torch.randperm(x.shape[0], generator=torch.Generator().manual_seed(
        7)).to(x.device)
    whole = feqmod.feqmod_spectra_cuda(x, rn, wcs, mom, flags)
    shuffled = feqmod.feqmod_spectra_cuda(x[perm].contiguous(),
                                          rn[perm].contiguous(),
                                          wcs[perm].contiguous(), mom, flags)
    torch.cuda.synchronize()
    _check(shuffled, whole, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("f64", [False, True])
def test_chain_props_on_gpu(cuda_card, f64):
    """Every chain's instantiation builds and fits the blocks an SM its
    launch bounds ask for (float32 4, the narrow cells' two-chain body 3;
    float64 2), at fixed nodes and with the remap at each width of angles,
    the main paths' switches and others."""
    for dim, remap, chains in ((3, False, (0, 1, 2)), (2, False, (0, 1)),
                               (2, True, (0, 1))):
        for df in (3, 4):
            for main in (True, False):
                flags = feqmod.FeqmodFlags(
                    df_mode=df, dimension=dim, remap=remap, regulate=main,
                    outflow=True, shear=True, bulk=True, diff=False)
                for chain in chains:
                    for n_phi in ((8, 16, 24) if remap else (24,)):
                        p = feqmod.chain_props(torch.device("cuda"), f64,
                                               flags, chain, n_phi)
                        assert p["threads"] == 128
                        want = 2 if f64 else 3 if chain == 2 else 4
                        assert p["blocks_per_sm"] >= want, (
                            dim, remap, df, main, chain, n_phi, p)
