"""Monte-Carlo resonance decays of sampled events (operation 2 with
do_resonance_decays = 1).

Port of is3d_tpu/kernels/mc_decays.py: every unstable hadron of a sampled
event decays through the PDG table's open 2- and 3-body channels down to
stable hadrons, with exponential decay vertices along p^mu / m.  The events
are concatenated into one batch of capacity C (the sum over the input
hadrons of their worst-case final multiplicity, a power of two); each pass
decays one generation (``n_passes`` = the table's longest chain):

* the channel from one uniform against the species' cumulative row,
* 3-body: m23 from the channel's quantile table (2-node interpolation),
* two-stage isotropic decays with the boosts, the exponential vertex,
* daughter 1 in the parent's slot, daughters 2-3 at n + exclusive-cumsum
  offsets in slot order, so the layout does not depend on thread timing.

On the card a pass is kernel K8 (csrc/mc_decays.cu: a decide launch, the
cumsum, a write launch), one thread a live hadron; ``cascade_pass_plain``
is its plain version.

Random numbers: the port's Philox lineage streams (kernels/rng.py).  Each
hadron carries a 64-bit lineage word: a sampled hadron's is a hash of
(global event, in-event ordinal), daughter j's a hash of (parent, j), and
a decay draws its seven uniforms from its own word.  So decay draws depend
only on (seed, global event, ordinal, decay path), never on a hadron's
position in the batch: a slice of events decayed with its global offset
equals the same events decayed in one call, byte for byte (is3d_tpu's
DECAY_STREAM_VERSION 2 contract, with the port's streams).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..units import HBARC
from . import rng
from .launch import check_float, check_tensor, launch, require_cuda
from .sample import gather_bytes

KQ = 257          # inverse-CDF quantile nodes per 3-body channel
_M23_GRID = 2048  # host-side CDF resolution
DECAY_SEED_TAG = 0x6D63

# kernel launches of K8: one per pass (a decide and a write launch)
LAUNCHES = 0


# ======================================================================
# host-side tables (numpy, copied from is3d_tpu/kernels/mc_decays.py)
# ======================================================================

@dataclass
class DecayTables:
    """Decay tables of a ParticleTable, (S, CH) arrays padded with no-op
    channels (cum = 1, nd = 2, daughters 0); ``quant`` rows of 2-body
    channels hold the constant m2."""
    mc_id: np.ndarray        # (S,) int64
    mass: np.ndarray         # (S,)
    ctau: np.ndarray         # (S,) hbar c / Gamma [fm], 0 where stable
    stable: np.ndarray       # (S,) bool, effective stability
    cum: np.ndarray          # (S, CH) cumulative renormalized branch ratios
    nd: np.ndarray           # (S, CH) int32, 2 or 3
    d1: np.ndarray           # (S, CH) int32 daughter species indices
    d2: np.ndarray
    d3: np.ndarray
    quant: np.ndarray        # (S, CH, KQ) m23 inverse-CDF quantiles
    maxmult: np.ndarray      # (S,) int64 worst-case final multiplicity
    n_passes: int            # longest decay-chain depth

    def device(self, dtype, device) -> dict:
        f = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                      device=device)
        i = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                      dtype=torch.int32, device=device)
        return dict(mass=f(self.mass), ctau=f(self.ctau),
                    stable=i(self.stable), cum=f(self.cum), nd=i(self.nd),
                    d1=i(self.d1), d2=i(self.d2), d3=i(self.d3),
                    quant=f(self.quant))


def _pstar(M, m1, m2):
    lam = (M * M - (m1 + m2) ** 2) * (M * M - (m1 - m2) ** 2)
    return np.sqrt(np.maximum(lam, 0.0)) / (2.0 * np.maximum(M, 1e-30))


def _m23_quantiles(M, m1, m2, m3):
    """Inverse CDF of g(m23) ~ p*(M,m1,m23) p*(m23,m2,m3) at KQ nodes."""
    lo, hi = m2 + m3, M - m1
    g = np.linspace(lo, hi, _M23_GRID)
    w = _pstar(M, m1, g) * _pstar(g, m2, m3)
    cdf = np.concatenate([[0.0], np.cumsum(0.5 * (w[1:] + w[:-1]))])
    if cdf[-1] <= 0.0:            # degenerate channel right at threshold
        return np.full(KQ, 0.5 * (lo + hi))
    cdf /= cdf[-1]
    q = np.linspace(0.0, 1.0, KQ)
    return np.interp(q, cdf, g)


def build_decay_tables(table, lightest_particle: int = 111) -> DecayTables:
    """Compile a ParticleTable's decay channels into fixed-shape arrays:
    closed channels (at nominal masses), channels of 4+ daughters or of
    daughters missing from the table are dropped and the rest
    renormalized; a species left without channels is stable, as is
    ``lightest_particle``."""
    S = len(table)
    mass = np.asarray(table.mass, dtype=np.float64)
    width = np.asarray(table.width, dtype=np.float64)
    stable = np.asarray(table.stable, dtype=bool).copy()
    stable |= np.asarray(table.mc_id) == int(lightest_particle)

    mcid_to_idx = {int(m): i for i, m in enumerate(table.mc_id)}
    channels = [[] for _ in range(S)]   # (prob, nd, i1, i2, i3, quant)
    for s in range(S):
        if stable[s]:
            continue
        M = mass[s]
        for ch in range(len(table.decays_branch[s])):
            b = float(table.decays_branch[s][ch])
            nd = abs(int(table.decays_n[s][ch]))
            if b <= 0.0 or nd < 2 or nd > 3:
                continue
            d_mcids = [int(m) for m in table.decays_part[s][ch][:nd]]
            try:
                didx = [mcid_to_idx[m] for m in d_mcids]
            except KeyError:
                continue
            dm = mass[didx]
            if dm.sum() >= M:               # closed at nominal masses
                continue
            if nd == 2:
                channels[s].append((b, 2, didx[0], didx[1], 0, None))
            else:
                quant = _m23_quantiles(M, dm[0], dm[1], dm[2])
                channels[s].append((b, 3, didx[0], didx[1], didx[2], quant))
        if not channels[s]:
            stable[s] = True

    CH = max(1, max(len(c) for c in channels))
    cum = np.ones((S, CH), dtype=np.float64)
    nd = np.full((S, CH), 2, dtype=np.int32)
    d1 = np.zeros((S, CH), dtype=np.int32)
    d2 = np.zeros((S, CH), dtype=np.int32)
    d3 = np.zeros((S, CH), dtype=np.int32)
    quant = np.zeros((S, CH, KQ), dtype=np.float64)
    for s, chs in enumerate(channels):
        if not chs:
            continue
        probs = np.array([c[0] for c in chs])
        cum[s, :len(chs)] = np.cumsum(probs / probs.sum())
        # the last real channel closes the unit interval exactly, so no
        # uniform selects a padding channel
        cum[s, len(chs) - 1:] = 1.0
        for j, (_, n, i1, i2, i3, q) in enumerate(chs):
            nd[s, j] = n
            d1[s, j], d2[s, j], d3[s, j] = i1, i2, i3
            quant[s, j] = mass[i2] if q is None else q

    # worst-case final multiplicity and chain depth, ascending mass
    maxmult = np.ones(S, dtype=np.int64)
    depth = np.zeros(S, dtype=np.int64)
    for s in np.argsort(mass, kind="stable"):
        if stable[s] or not channels[s]:
            continue
        best_m, best_d = 1, 0
        for (_, n, i1, i2, i3, _) in channels[s]:
            ds = (i1, i2, i3)[:n]
            best_m = max(best_m, sum(int(maxmult[d]) for d in ds))
            best_d = max(best_d, 1 + max(int(depth[d]) for d in ds))
        maxmult[s] = best_m
        depth[s] = best_d

    ctau = np.where(~stable & (width > 0.0), HBARC / np.maximum(width, 1e-30),
                    0.0)
    return DecayTables(mc_id=np.asarray(table.mc_id, dtype=np.int64),
                       mass=mass, ctau=ctau, stable=stable, cum=cum, nd=nd,
                       d1=d1, d2=d2, d3=d3, quant=quant, maxmult=maxmult,
                       n_passes=int(depth.max()) if S else 0)


# id(table)-keyed; each entry keeps the table alive, so a recycled address
# never aliases a stale entry
_TABLE_CACHE = {}


def cached_tables(table, lightest: int) -> DecayTables:
    k = (id(table), int(lightest))
    if k not in _TABLE_CACHE:
        _TABLE_CACHE[k] = (table, build_decay_tables(table, lightest), {})
    return _TABLE_CACHE[k][1]


def _cached_device_tables(table, lightest: int, dtype, device) -> dict:
    dev = _TABLE_CACHE[(id(table), int(lightest))][2]
    key = (str(dtype), str(device))
    if key not in dev:
        dev[key] = _TABLE_CACHE[(id(table), int(lightest))][1].device(
            dtype, device)
    return dev[key]


def derive_decay_seed(seed: int) -> int:
    """The decay streams' seed from the sampler's, through a SeedSequence
    branch of its own (is3d_tpu/kernels/mc_decays.py:derive_decay_seed)."""
    return int(np.random.SeedSequence(
        (int(seed), DECAY_SEED_TAG)).generate_state(2, dtype=np.uint64)[0]
        % (2**63))


# ======================================================================
# one pass of the cascade
# ======================================================================

STATE_FLOATS = ("E", "px", "py", "pz", "t", "x", "y", "z")


def _boost(Ep, Px, Py, Pz, invM, Er, qx, qy, qz):
    """Boost (Er, q) from the rest frame of a particle of lab four-momentum
    (Ep, P) and inverse mass invM to the lab."""
    dot = Px * qx + Py * qy + Pz * qz
    Eout = (Ep * Er + dot) * invM
    coef = (dot / (Ep + 1.0 / invM) + Er) * invM
    return Eout, qx + Px * coef, qy + Py * coef, qz + Pz * coef


def _iso_dir(u_cos, u_phi, pmag):
    cth = 2.0 * u_cos - 1.0
    sth = torch.sqrt(torch.clamp(1.0 - cth * cth, min=0.0))
    ph = (2.0 * math.pi) * u_phi
    return pmag * sth * torch.cos(ph), pmag * sth * torch.sin(ph), pmag * cth


def decay_kinematics(tabs: dict, sidx, f: dict, u) -> dict:
    """The decay of hadrons (species ``sidx``, state floats ``f``) from
    their seven uniforms ``u`` (7, n) (is3d_tpu/kernels/mc_decays.py
    :_cascade_jit's body): dec (unstable), nd, the three daughters'
    species, their momenta and the decay vertex."""
    dtype = f["E"].dtype
    s = sidx.long()
    dec = tabs["stable"][s] == 0
    M = tabs["mass"][s]
    invM = 1.0 / torch.clamp(M, min=1e-8)
    cumrow = tabs["cum"][s]
    CH = cumrow.shape[1]
    ch = torch.clamp((u[0][:, None] >= cumrow).sum(dim=1), max=CH - 1)
    nd = tabs["nd"][s, ch]
    D1, D2, D3 = (tabs[k][s, ch].long() for k in ("d1", "d2", "d3"))
    m1, m2, m3 = tabs["mass"][D1], tabs["mass"][D2], tabs["mass"][D3]
    is3 = nd == 3

    posq = u[1] * (KQ - 1)
    i0 = torch.clamp(posq.to(torch.int32), 0, KQ - 2).long()
    fr = posq - i0.to(dtype)
    qa = tabs["quant"][s, ch, i0]
    qb = tabs["quant"][s, ch, i0 + 1]
    mc = torch.where(is3, qa * (1.0 - fr) + qb * fr, m2)

    E, px, py, pz = f["E"], f["px"], f["py"], f["pz"]
    lamA = (M * M - (m1 + mc) ** 2) * (M * M - (m1 - mc) ** 2)
    pA = torch.sqrt(torch.clamp(lamA, min=0.0)) * (0.5 * invM)
    q1x, q1y, q1z = _iso_dir(u[2], u[3], pA)
    E1r = torch.sqrt(m1 * m1 + pA * pA)
    Ecr = torch.sqrt(mc * mc + pA * pA)
    E1, p1x, p1y, p1z = _boost(E, px, py, pz, invM, E1r, q1x, q1y, q1z)
    Ec, pcx, pcy, pcz = _boost(E, px, py, pz, invM, Ecr, -q1x, -q1y, -q1z)

    invmc = 1.0 / torch.clamp(mc, min=1e-8)
    lamB = (mc * mc - (m2 + m3) ** 2) * (mc * mc - (m2 - m3) ** 2)
    pB = torch.sqrt(torch.clamp(lamB, min=0.0)) * (0.5 * invmc)
    q2x, q2y, q2z = _iso_dir(u[4], u[5], pB)
    E2r = torch.sqrt(m2 * m2 + pB * pB)
    E3r = torch.sqrt(m3 * m3 + pB * pB)
    E2b, p2bx, p2by, p2bz = _boost(Ec, pcx, pcy, pcz, invmc, E2r, q2x, q2y,
                                   q2z)
    E3, p3x, p3y, p3z = _boost(Ec, pcx, pcy, pcz, invmc, E3r, -q2x, -q2y,
                               -q2z)
    E2 = torch.where(is3, E2b, Ec)
    p2x = torch.where(is3, p2bx, pcx)
    p2y = torch.where(is3, p2by, pcy)
    p2z = torch.where(is3, p2bz, pcz)

    taup = -tabs["ctau"][s] * torch.log1p(-u[6])
    vtx = dict(t=f["t"] + taup * E * invM, x=f["x"] + taup * px * invM,
               y=f["y"] + taup * py * invM, z=f["z"] + taup * pz * invM)
    return dict(dec=dec, nd=nd, D=(D1, D2, D3), vtx=vtx,
                p1=(E1, p1x, p1y, p1z), p2=(E2, p2x, p2y, p2z),
                p3=(E3, p3x, p3y, p3z))


def cascade_pass_plain(st: dict, n: int, tabs: dict, u, kids) -> int:
    """One generation over the first ``n`` hadrons of the state ``st``
    (sidx int32, the STATE_FLOATS, eid int32, lin (C, 2) int64), in
    place: ``u`` (7, n) their uniforms, ``kids`` their daughters' lineage
    words ((n, 2) each, j = 1, 2, 3).  Returns the new live count."""
    C = st["sidx"].shape[0]
    f = {k: st[k][:n] for k in STATE_FLOATS}
    d = decay_kinematics(tabs, st["sidx"][:n], f, u)
    dec, is3 = d["dec"], d["nd"] == 3
    extra = torch.where(dec, d["nd"] - 1, torch.zeros_like(d["nd"])).long()
    offs = n + torch.cumsum(extra, 0) - extra
    n_new = n + int(extra.sum())
    if n_new > C:
        raise RuntimeError(f"decay cascade overflow: {n_new} hadrons > "
                           f"capacity {C} (worst-case bound violated)")
    new = dict(sidx=(d["D"][0], d["D"][1], d["D"][2]),
               E=(d["p1"][0], d["p2"][0], d["p3"][0]),
               px=(d["p1"][1], d["p2"][1], d["p3"][1]),
               py=(d["p1"][2], d["p2"][2], d["p3"][2]),
               pz=(d["p1"][3], d["p2"][3], d["p3"][3]))
    for k in ("t", "x", "y", "z"):
        new[k] = (d["vtx"][k],) * 3
    new["eid"] = (st["eid"][:n],) * 3
    new["lin"] = kids
    i2 = offs[dec]
    i3 = (offs + 1)[dec & is3]
    for k, (v1, v2, v3) in new.items():
        col = st[k]
        mask = dec if v1.dim() == 1 else dec[:, None]
        col[:n] = torch.where(mask, v1.to(col.dtype), col[:n])
        col[i2] = v2[dec].to(col.dtype)
        col[i3] = v3[dec & is3].to(col.dtype)
    return n_new


def cascade_plain(st: dict, n0: int, tabs: dict, key, n_passes: int) -> int:
    """The whole cascade in plain torch: each pass draws the live hadrons'
    uniforms and daughters' lineages from their lineage words.  Returns
    the final live count."""
    n = n0
    dtype = st["E"].dtype
    for _ in range(n_passes):
        lin = st["lin"][:n]
        u = rng.decay_uniforms(key, lin, dtype)
        kids = tuple(rng.child_lineage(key, lin, j) for j in (1, 2, 3))
        n = cascade_pass_plain(st, n, tabs, u, kids)
    return n


def cascade_pass_cuda(st: dict, n: int, tabs: dict, key, scratch: dict
                      ) -> int:
    """K8 (csrc/mc_decays.cu): one generation of the first ``n`` hadrons,
    a decide launch (channel, daughters-to-add), the exclusive cumsum of
    the daughter counts, and a write launch (draws, kinematics, daughter 1
    in place, daughters 2-3 at n + offset).  Returns the new live count."""
    global LAUNCHES
    E = st["E"]
    check_float("cascade_pass_cuda", E)
    C = E.shape[0]
    S, CH = tabs["cum"].shape
    for k in STATE_FLOATS:
        check_tensor(k, st[k], (C,), E)
    check_tensor("sidx", st["sidx"], (C,), E, dtype=torch.int32)
    check_tensor("eid", st["eid"], (C,), E, dtype=torch.int32)
    check_tensor("lin", st["lin"], (C, 2), E, dtype=torch.int64)
    for k in ("mass", "ctau"):
        check_tensor(k, tabs[k], (S,), E)
    check_tensor("stable", tabs["stable"], (S,), E, dtype=torch.int32)
    check_tensor("cum", tabs["cum"], (S, CH), E)
    for k in ("nd", "d1", "d2", "d3"):
        check_tensor(k, tabs[k], (S, CH), E, dtype=torch.int32)
    check_tensor("quant", tabs["quant"], (S, CH, KQ), E)
    require_cuda("cascade_pass_cuda", E)
    if n == 0:
        return 0
    lib = _library()
    f64 = E.dtype == torch.float64
    extra, ch = scratch["extra"][:n], scratch["ch"][:n]
    k0, k1 = key
    tab_ptrs = (tabs["mass"].data_ptr(), tabs["ctau"].data_ptr(),
                tabs["stable"].data_ptr(), tabs["cum"].data_ptr(),
                tabs["nd"].data_ptr(), tabs["d1"].data_ptr(),
                tabs["d2"].data_ptr(), tabs["d3"].data_ptr(),
                tabs["quant"].data_ptr(), S, CH)
    launch(lib, "cascade decide",
           lib.is3d_cascade_decide_f64 if f64 else lib.is3d_cascade_decide_f32,
           E.device, st["sidx"].data_ptr(), st["lin"].data_ptr(), n,
           *tab_ptrs, k0, k1, extra.data_ptr(), ch.data_ptr())
    offs = torch.cumsum(extra, 0, dtype=torch.int32)
    n_new = n + int(offs[-1])
    if n_new > C:
        raise RuntimeError(f"decay cascade overflow: {n_new} hadrons > "
                           f"capacity {C} (worst-case bound violated)")
    launch(lib, "cascade write",
           lib.is3d_cascade_write_f64 if f64 else lib.is3d_cascade_write_f32,
           E.device, st["sidx"].data_ptr(), st["lin"].data_ptr(),
           st["eid"].data_ptr(), *(st[k].data_ptr() for k in STATE_FLOATS),
           n, C, *tab_ptrs, k0, k1, extra.data_ptr(), ch.data_ptr(),
           offs.data_ptr())
    LAUNCHES += 1
    return n_new


# K8's yardstick, counted from the formula: a decay draws 2 Philox blocks
# in float32 (7 uniforms) and 4 in float64, plus 1 in the decide launch and
# 3 for its daughters' lineage words, 20 multiply-highs a block; 13 special
# functions (8 sqrts, 2 cos, 2 sin, a log1p); per live hadron the decide
# launch reads its species and lineage (20 bytes) and writes two ints, a
# decaying one gathers 8 sectors of tables (sample.gather_bytes: tables
# that fit in L2 are read once) and reads its state, and every daughter's
# state is written once
CASCADE_SFU = 13


def cascade_formula_ops(n_live: int, n_dec: int, n_new: int,
                        itemsize: int, table_bytes: int) -> dict:
    """The work of one K8 pass: ``n_live`` hadrons, ``n_dec`` of them
    decaying into ``n_dec + n_new`` daughters, on decay tables of
    ``table_bytes`` in all."""
    state = 4 + 16 + 4 + 8 * itemsize
    draws = 2 if itemsize == 4 else 4
    return dict(bytes=n_live * 28 + n_dec * state
                + gather_bytes(table_bytes, 8 * n_dec)
                + (n_dec + n_new) * state,
                mulhi=20 * (n_live + n_dec * (draws + 3)),
                sfu=CASCADE_SFU * n_dec)


def _library():
    from ..native.build import cuda_library
    lib = cuda_library("mc_decays")
    if not getattr(lib, "_is3d_bound", False):
        vp, ci, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        tabs = [vp] * 9 + [ci, ci]      # mass ctau stable cum nd d1 d2 d3 quant S CH
        for fn in (lib.is3d_cascade_decide_f32, lib.is3d_cascade_decide_f64):
            fn.restype = ci
            fn.argtypes = [vp, vp, ci] + tabs + [cu, cu, vp, vp, vp]
        for fn in (lib.is3d_cascade_write_f32, lib.is3d_cascade_write_f64):
            fn.restype = ci
            fn.argtypes = ([vp, vp, vp] + [vp] * 8 + [ci, ci] + tabs
                           + [cu, cu, vp, vp, vp, vp])
        lib.is3d_cuda_error_string.restype = ctypes.c_char_p
        lib.is3d_cuda_error_string.argtypes = [ci]
        lib._is3d_bound = True
    return lib


def run_cascade(st: dict, n0: int, tabs: dict, key, n_passes: int) -> int:
    """The cascade on the state's device: K8 a pass on CUDA tensors, the
    plain passes on CPU ones.  Returns the final live count."""
    if st["E"].device.type == "cpu":
        return cascade_plain(st, n0, tabs, key, n_passes)
    C = st["E"].shape[0]
    scratch = dict(extra=torch.empty(C, dtype=torch.int32,
                                     device=st["E"].device),
                   ch=torch.empty(C, dtype=torch.int32,
                                  device=st["E"].device))
    n = n0
    for _ in range(n_passes):
        n = cascade_pass_cuda(st, n, tabs, key, scratch)
    return n


# ======================================================================
# host orchestration
# ======================================================================

EVENT_FIELDS = ("mcid", "mass", "E", "px", "py", "pz", "t", "x", "y", "z",
                "tau", "eta", "yp")


def initial_state(sidx: np.ndarray, cols: dict, eid: np.ndarray,
                  eg: np.ndarray, ordv: np.ndarray, C: int, key, dtype,
                  device) -> dict:
    """The cascade's state of capacity C from n0 unstable hadrons: species
    indices, STATE_FLOATS columns, batch-local event ids and root lineage
    words from (global event, in-event ordinal)."""
    n0 = len(sidx)

    def pad(v, dt, fill=0):
        out = torch.full((C,), fill, dtype=dt, device=device)
        out[:n0] = torch.as_tensor(np.asarray(v), dtype=dt, device=device)
        return out

    st = {k: pad(cols[k], dtype) for k in STATE_FLOATS}
    st["sidx"] = pad(sidx, torch.int32)
    st["eid"] = pad(eid, torch.int32, -1)
    lin = torch.zeros((C, 2), dtype=torch.int64, device=device)
    lin[:n0] = rng.root_lineage(
        key, torch.as_tensor(eg, dtype=torch.int64, device=device),
        torch.as_tensor(ordv, dtype=torch.int64, device=device))
    st["lin"] = lin
    return st


def _concat_events(events: list, tabs: DecayTables) -> tuple:
    """The events' columns concatenated, each hadron's species index, its
    batch-local event id and its in-event ordinal."""
    counts = [len(e["E"]) for e in events]
    N = int(sum(counts))
    cols = {k: np.concatenate([np.asarray(e[k]) for e in events])
            for k in EVENT_FIELDS}
    mcid_in = cols["mcid"].astype(np.int64)
    eid = np.repeat(np.arange(len(events), dtype=np.int32), counts)
    ordv = (np.arange(N, dtype=np.int64)
            - np.repeat(np.cumsum([0] + counts[:-1]).astype(np.int64),
                        counts))
    order = np.argsort(tabs.mc_id, kind="stable")
    pos = np.clip(np.searchsorted(tabs.mc_id[order], mcid_in), 0,
                  len(order) - 1)
    sidx = order[pos].astype(np.int32)
    bad = tabs.mc_id[sidx] != mcid_in
    if bad.any():
        raise KeyError(f"sampled mc id(s) not in the particle table: "
                       f"{np.unique(mcid_in[bad])[:5]}")
    return cols, sidx, eid, ordv


def cascade_inputs(events: list, table, lightest_particle: int, seed: int,
                   event_offset: int = 0, device="cpu") -> dict:
    """What the cascade of ``events``' unstable hadrons starts from: the
    state at its worst-case capacity (``initial_state``), n0, the host and
    device tables and the key; the stable hadrons' columns and event ids
    (``passed``, ``eid_passed``), which pass through untouched."""
    tabs = cached_tables(table, lightest_particle)
    cols, sidx, eid, ordv = _concat_events(events, tabs)
    unst = ~tabs.stable[sidx]
    dtype_np = np.asarray(events[0]["E"]).dtype
    if dtype_np not in (np.float32, np.float64):
        dtype_np = np.dtype(np.float64)
    dtype = torch.float32 if dtype_np == np.float32 else torch.float64
    key = rng.seed_key(seed)
    n0 = int(unst.sum())
    out = dict(n0=n0, tabs=tabs, key=key, dtype_np=dtype_np,
               passed={k: v[~unst] for k, v in cols.items()},
               eid_passed=eid[~unst])
    if n0:
        C = 1 << max(0, int(int(tabs.maxmult[sidx[unst]].sum()) - 1)
                     .bit_length())
        out["state"] = initial_state(
            sidx[unst], {k: cols[k][unst] for k in STATE_FLOATS}, eid[unst],
            eid[unst].astype(np.int64) + int(event_offset), ordv[unst], C,
            key, dtype, device)
        out["dev_tabs"] = _cached_device_tables(table, lightest_particle,
                                                dtype, device)
    return out


def decay_events(events: list, table, cfg=None, seed: int = 0,
                 lightest_particle: int | None = None,
                 event_offset: int = 0, device="cpu", info=None) -> list:
    """Decay every unstable resonance of sampled events to stable hadrons
    on ``device``: a new list in the same schema holding the final-state
    hadrons, decay products with their decay vertices.  ``event_offset``
    is the global index of events[0]: a slice of events decayed with its
    offset equals the same events decayed in one call.  Deterministic in
    (events, seed, event_offset).  ``info`` gets the cascade's capacity,
    hadrons in and out and passes."""
    if lightest_particle is None:
        lightest_particle = int(getattr(cfg, "lightest_particle", 111))
    if not events:
        return []
    if sum(len(e["E"]) for e in events) == 0:
        return [dict(e) for e in events]
    inp = cascade_inputs(events, table, lightest_particle, seed,
                         event_offset, device)
    tabs, dtype_np = inp["tabs"], inp["dtype_np"]
    if inp["n0"] == 0:
        out_cols, eid_o = inp["passed"], inp["eid_passed"]
    else:
        st = inp["state"]
        nf = run_cascade(st, inp["n0"], inp["dev_tabs"], inp["key"],
                         tabs.n_passes)
        if info is not None:
            info.update(capacity=st["E"].shape[0], hadrons_in=inp["n0"],
                        hadrons_out=nf, passes=tabs.n_passes)
        host = {k: st[k][:nf].cpu().numpy() for k in
                ("sidx",) + STATE_FLOATS + ("eid",)}
        sidx_o = host["sidx"]
        if np.any(~tabs.stable[sidx_o]):
            raise RuntimeError("unstable hadrons survived the cascade; the "
                               "table's chain depth exceeded n_passes")
        E, pz, t, z = host["E"], host["pz"], host["t"], host["z"]
        casc = dict(mcid=tabs.mc_id[sidx_o],
                    mass=tabs.mass[sidx_o].astype(dtype_np), E=E,
                    px=host["px"], py=host["py"], pz=pz, t=t, x=host["x"],
                    y=host["y"], z=z)
        casc["tau"] = np.sqrt(np.maximum(t * t - z * z, 0.0))
        with np.errstate(divide="ignore", invalid="ignore"):
            casc["eta"] = 0.5 * np.log(
                np.maximum(t + z, 1e-45) / np.maximum(t - z, 1e-45))
            casc["yp"] = 0.5 * np.log((E + pz) / np.maximum(E - pz, 1e-45))
        out_cols = {k: np.concatenate([np.asarray(inp["passed"][k],
                                                  dtype=v.dtype), v])
                    for k, v in casc.items()}
        eid_o = np.concatenate([inp["eid_passed"], host["eid"]])

    order = np.argsort(eid_o, kind="stable")
    bounds = np.searchsorted(eid_o[order], np.arange(len(events) + 1))
    return [{k: v[order[bounds[e]:bounds[e + 1]]] for k, v in out_cols.items()}
            for e in range(len(events))]
