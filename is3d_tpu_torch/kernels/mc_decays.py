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

On the card a pass is one launch of kernel K8 (csrc/mc_decays.cu, a
thread a live hadron, the daughters' slots by an in-kernel prefix sum) and
the live count stays on the card: ``launch_cascade`` queues every pass,
``run_cascade`` reads the counts once; ``cascade_pass_plain`` is its plain
version.  ``decay_events`` keeps the events on the device between the host
lists (upload, species lookup, cascade, regrouping by event, one copy
back), as torch on the CPU too.

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
import time
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

# kernel launches of K8: one a pass
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


# the lineage keying scheme above: part of which bytes a decayed batch is,
# so a resumed ensemble run refuses a manifest of another version
# (ensemble.oversample_run)
DECAY_STREAM_VERSION = 2


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


def _checked(st: dict, tabs: dict) -> int:
    """K8's argument checks (dtypes, shapes, contiguity, then the device);
    returns the state's capacity."""
    E = st["E"]
    check_float("K8", E)
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
    require_cuda("K8", E)
    return C


def cascade_buffers(C: int, n_passes: int, n0: int, device) -> tuple:
    """The live counts (n_passes + 1,), each n0 (pass p writes counts[p +
    1] before pass p + 1 reads it; a fill, no copy from the host), and, a
    row a pass, the tile counter and the look-back state words of every
    tile of C slots, zeroed."""
    tile = _library().is3d_cascade_tile()
    counts = torch.full((n_passes + 1,), n0, dtype=torch.int32,
                        device=device)
    scratch = torch.zeros((n_passes, 1 + -(-C // tile)), dtype=torch.int64,
                          device=device)
    return counts, scratch


def pass_launcher(st: dict, tabs: dict, key, counts, scratch):
    """K8's arguments checked once for a cascade on ``st``: returns
    ``go(p, n_upper)``, which queues pass p (csrc/mc_decays.cu,
    pass_kernel: reads its live count from counts[p] on the card and
    writes counts[p + 1]; its grid from ``n_upper``, a bound of that
    count).  ``counts`` and ``scratch`` as ``cascade_buffers`` makes
    them."""
    C = _checked(st, tabs)
    E = st["E"]
    lib = _library()
    n_passes = counts.shape[0] - 1
    check_tensor("counts", counts, (n_passes + 1,), E, dtype=torch.int32)
    check_tensor("scratch", scratch,
                 (n_passes, 1 + -(-C // lib.is3d_cascade_tile())), E,
                 dtype=torch.int64)
    fn = (lib.is3d_cascade_pass_f64 if E.dtype == torch.float64
          else lib.is3d_cascade_pass_f32)
    head = (st["sidx"].data_ptr(), st["lin"].data_ptr(), st["eid"].data_ptr(),
            *(st[k].data_ptr() for k in STATE_FLOATS), C)
    tail = (*(tabs[k].data_ptr() for k in ("mass", "ctau", "stable", "cum",
                                           "nd", "d1", "d2", "d3", "quant")),
            *tabs["cum"].shape, *key)
    row = scratch.stride(0) * 8

    def go(p: int, n_upper: int):
        global LAUNCHES
        word = scratch.data_ptr() + p * row
        launch(lib, "cascade pass", fn, E.device, *head, p,
               counts.data_ptr(), word, word + 8, n_upper, *tail)
        LAUNCHES += 1
    return go


def final_count(counts, C: int) -> int:
    """The final live count from the passes' counts (one read from the
    card); raises if a pass outgrew the capacity."""
    host = counts.cpu().tolist()
    over = [n for n in host if n > C]
    if over:
        raise RuntimeError(f"decay cascade overflow: {over[0]} hadrons > "
                           f"capacity {C} (worst-case bound violated)")
    return host[-1]


def launch_cascade(st: dict, n0: int, tabs: dict, key, n_passes: int):
    """Queue the whole cascade on the card, one K8 launch a pass, with no
    read from the card: pass p's grid is sized for min(C, 3^p n0) hadrons
    and its live count is read on the card.  Returns the (n_passes + 1,)
    int32 live counts, counts[0] = n0, still on the card."""
    C = _checked(st, tabs)
    counts, scratch = cascade_buffers(C, n_passes, n0, st["E"].device)
    go = pass_launcher(st, tabs, key, counts, scratch)
    for p in range(n_passes):
        go(p, min(C, n0 * 3**p))
    return counts


def cascade_pass_cuda(st: dict, n: int, tabs: dict, key) -> int:
    """K8 (csrc/mc_decays.cu) on one generation of the first ``n`` hadrons,
    in place: one launch of pass_kernel, then a read of the new live
    count.  The cascade's own path is ``launch_cascade``, which reads
    nothing between passes.  Returns the new live count."""
    C = _checked(st, tabs)
    return final_count(launch_cascade(st, n, tabs, key, 1), C) if n else 0


# K8's yardstick, counted from the formula: a decay draws 2 Philox blocks
# in float32 (7 uniforms) and 4 in float64, and 3 for its daughters'
# lineage words, 20 multiply-highs a block; 13 special functions (8 sqrts,
# 2 cos, 2 sin, a log1p); every live hadron's species is read (4 bytes), a
# decaying one's lineage, event and floats, and it gathers 8 sectors of
# tables (sample.gather_bytes: tables that fit in L2 are read once); every
# daughter's state is written once
CASCADE_SFU = 13


def cascade_formula_ops(n_live: int, n_dec: int, n_new: int,
                        itemsize: int, table_bytes: int) -> dict:
    """The work of one K8 pass: ``n_live`` hadrons, ``n_dec`` of them
    decaying into ``n_dec + n_new`` daughters, on decay tables of
    ``table_bytes`` in all."""
    state = 4 + 16 + 4 + 8 * itemsize
    draws = 2 if itemsize == 4 else 4
    return dict(bytes=n_live * 4 + n_dec * (state - 4)
                + gather_bytes(table_bytes, 8 * n_dec)
                + (n_dec + n_new) * state,
                mulhi=20 * n_dec * (draws + 3),
                sfu=CASCADE_SFU * n_dec)


def _library():
    from ..native.build import cuda_library
    lib = cuda_library("mc_decays")
    if not getattr(lib, "_is3d_bound", False):
        vp, ci, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        for fn in (lib.is3d_cascade_pass_f32, lib.is3d_cascade_pass_f64):
            fn.restype = ci
            # state (sidx lin eid, 8 floats), cap, pass, counts, tile
            # counter, states, n_upper, tables (mass ctau stable cum nd d1
            # d2 d3 quant, S, CH), key, stream
            fn.argtypes = ([vp] * 11 + [ci, ci, vp, vp, vp, ci] + [vp] * 9
                           + [ci, ci, cu, cu, vp])
        lib.is3d_cascade_tile.restype = ci
        lib.is3d_cascade_tile.argtypes = []
        lib.is3d_cuda_error_string.restype = ctypes.c_char_p
        lib.is3d_cuda_error_string.argtypes = [ci]
        lib._is3d_bound = True
    return lib


def run_cascade(st: dict, n0: int, tabs: dict, key, n_passes: int) -> int:
    """The cascade on the state's device: on CUDA every pass queued
    (``launch_cascade``) and the live counts read once at the end; on the
    CPU the plain passes.  Returns the final live count."""
    if st["E"].device.type == "cpu":
        return cascade_plain(st, n0, tabs, key, n_passes)
    return final_count(launch_cascade(st, n0, tabs, key, n_passes),
                        st["E"].shape[0])


# ======================================================================
# host orchestration: torch on the events' device
# ======================================================================

EVENT_FIELDS = ("mcid", "mass", "E", "px", "py", "pz", "t", "x", "y", "z",
                "tau", "eta", "yp")
FLOAT_FIELDS = EVENT_FIELDS[1:]
DECAY_TIMINGS = ("upload", "lookup", "cascade", "regroup", "download")


def initial_state(sidx, cols: dict, eid, eg, ordv, C: int, key, dtype,
                  device) -> dict:
    """The cascade's state of capacity C from n0 unstable hadrons (arrays
    or tensors): species indices, STATE_FLOATS columns, batch-local event
    ids and root lineage words from (global event, in-event ordinal)."""
    n0 = len(sidx)

    def pad(v, dt, fill=0):
        out = torch.full((C,), fill, dtype=dt, device=device)
        out[:n0] = torch.as_tensor(v, dtype=dt, device=device)
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


def _lookup_tables(table, lightest: int, device) -> dict:
    """The species lookup's tensors on ``device`` (cached with the decay
    tables): the sorted mc ids and their species, each species' mc id,
    mass, stability and worst-case multiplicity."""
    tabs, dev = _TABLE_CACHE[(id(table), int(lightest))][1:]
    key = ("lookup", str(device))
    if key not in dev:
        order = np.argsort(tabs.mc_id, kind="stable")
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
        dev[key] = dict(ids_sorted=t(tabs.mc_id[order]), order=t(order),
                        mc_id=t(tabs.mc_id), mass=t(tabs.mass),
                        stable=t(tabs.stable), maxmult=t(tabs.maxmult))
    return dev[key]


def _upload(events: list, dtype, device) -> tuple:
    """Every event's columns copied straight into one buffer on ``device``
    at its offset: mcid (N,) int64 and the FLOAT_FIELDS (12, N)."""
    counts = [len(e["E"]) for e in events]
    N = sum(counts)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    mcid = torch.empty(N, dtype=torch.int64, device=device)
    cols = torch.empty((len(FLOAT_FIELDS), N), dtype=dtype, device=device)
    lo = 0
    for e, n in zip(events, counts):
        # a copy from pageable memory returns once its source is staged
        mcid[lo:lo + n].copy_(torch.from_numpy(np.ascontiguousarray(
            e["mcid"], dtype=np.int64)), non_blocking=True)
        for j, k in enumerate(FLOAT_FIELDS):
            cols[j, lo:lo + n].copy_(torch.from_numpy(np.ascontiguousarray(
                e[k], dtype=np_dtype)), non_blocking=True)
        lo += n
    return mcid, cols, counts


def cascade_inputs(events: list, table, lightest_particle: int, seed: int,
                   event_offset: int = 0, device="cuda", mark=None) -> dict:
    """The events on ``device`` (the card unless the caller names the CPU;
    no fallback: without CUDA it raises as IS3D(device="cuda") does) and
    what their unstable hadrons' cascade starts from: ``mcid`` and
    ``cols`` (FLOAT_FIELDS) of every hadron, its batch-local ``eid``, the
    stable ones' indices (``passed``, in order), n0, the state at its
    worst-case capacity (``initial_state``), the host and device tables
    and the key.  One read from the device (an
    unknown mc id's count, n0 and the capacity).  ``mark(name)`` is called
    after the upload and after the lookup."""
    from ..api import resolve_device
    mark = mark or (lambda name: None)
    device = resolve_device(device)
    tabs = cached_tables(table, lightest_particle)
    dtype_np = np.asarray(events[0]["E"]).dtype
    dtype = torch.float32 if dtype_np == np.float32 else torch.float64
    mcid, cols, counts = _upload(events, dtype, device)
    mark("upload")

    lk = _lookup_tables(table, lightest_particle, device)
    N, S = mcid.shape[0], len(tabs.mc_id)
    pos = torch.clamp(torch.searchsorted(lk["ids_sorted"], mcid), max=S - 1)
    sidx = lk["order"][pos]
    bad = lk["mc_id"][sidx] != mcid
    unst = ~lk["stable"][sidx]
    n_bad, n0, mult = torch.stack([
        bad.sum(), unst.sum(),
        torch.where(unst, lk["maxmult"][sidx], 0).sum()]).cpu().tolist()
    if n_bad:
        raise KeyError(f"sampled mc id(s) not in the particle table: "
                       f"{torch.unique(mcid[bad]).cpu().numpy()[:5]}")
    n_ev = len(events)
    per_event = torch.as_tensor(counts, dtype=torch.int64).to(device)
    eid = torch.repeat_interleave(
        torch.arange(n_ev, dtype=torch.int64, device=device), per_event,
        output_size=N)
    ordv = (torch.arange(N, dtype=torch.int64, device=device)
            - (torch.cumsum(per_event, 0) - per_event)[eid])
    # the unstable hadrons first, then the stable ones, each in order
    split = torch.argsort((~unst).to(torch.uint8), stable=True)
    key = rng.seed_key(seed)
    out = dict(n0=n0, tabs=tabs, key=key, dtype=dtype, n_events=n_ev,
               mcid=mcid, cols=cols, eid=eid, passed=split[n0:], lookup=lk)
    if n0:
        u = split[:n0]
        C = 1 << max(0, int(mult - 1).bit_length())
        out["state"] = initial_state(
            sidx[u], {k: cols[FLOAT_FIELDS.index(k)][u]
                      for k in STATE_FLOATS},
            eid[u], eid[u] + int(event_offset), ordv[u], C, key, dtype,
            device)
        out["dev_tabs"] = _cached_device_tables(table, lightest_particle,
                                                dtype, device)
    mark("lookup")
    return out


def _final_columns(inp: dict, nf: int) -> tuple:
    """The cascade's nf hadrons as output columns: mcid, FLOAT_FIELDS
    (mass from the species; tau, eta, yp from the vertex and momentum, in
    the column's dtype), their event ids and the count of unstable ones."""
    st, lk = inp["state"], inp["lookup"]
    s = st["sidx"][:nf].long()
    E, pz, t, z = (st[k][:nf] for k in ("E", "pz", "t", "z"))
    c = dict(mass=lk["mass"][s].to(inp["dtype"]),
             **{k: st[k][:nf] for k in STATE_FLOATS})
    c["tau"] = torch.sqrt(torch.clamp(t * t - z * z, min=0.0))
    c["eta"] = 0.5 * torch.log(torch.clamp(t + z, min=1e-45)
                               / torch.clamp(t - z, min=1e-45))
    c["yp"] = 0.5 * torch.log((E + pz) / torch.clamp(E - pz, min=1e-45))
    left = (~lk["stable"][s]).sum()
    return (lk["mc_id"][s], torch.stack([c[k] for k in FLOAT_FIELDS]),
            st["eid"][:nf].long(), left)


def decay_events(events: list, table, cfg=None, seed: int = 0,
                 lightest_particle: int | None = None,
                 event_offset: int = 0, device="cuda", info=None) -> list:
    """Decay every unstable resonance of sampled events to stable hadrons
    on ``device`` (the card unless the caller names the CPU; without CUDA
    it raises, as IS3D(device="cuda") does): a new list in the same schema holding the final-state
    hadrons, each event's stable input hadrons in their order, then its
    decay products (with their decay vertices) in cascade-slot order.
    ``event_offset`` is the global index of events[0]: a slice of events
    decayed with its offset equals the same events decayed in one call.
    Deterministic in (events, seed, event_offset).

    Between the host lists everything is torch on ``device`` (the CPU too):
    the events uploaded at their offsets, the species lookup and the
    stable/unstable split, the cascade, the output columns and their
    regrouping by event (a stable sort of the event ids), then one copy
    into (pinned) host memory; each event's arrays are slices of it.
    ``info`` gets the cascade's capacity, hadrons in and out, passes and
    host-clock ``timings`` (s, DECAY_TIMINGS; on CUDA each split ends with
    a device synchronize, so it holds its own device work)."""
    from ..api import resolve_device
    device = resolve_device(device)
    if lightest_particle is None:
        lightest_particle = int(getattr(cfg, "lightest_particle", 111))
    if not events:
        return []
    if sum(len(e["E"]) for e in events) == 0:
        return [dict(e) for e in events]
    timings = {}
    clock = [time.perf_counter()]

    def mark(name):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        timings[name] = now - clock[0]
        clock[0] = now

    inp = cascade_inputs(events, table, lightest_particle, seed,
                         event_offset, device, mark)
    if info is not None:
        info["timings"] = timings
    if inp["n0"] == 0:
        return [{k: np.array(e[k]) for k in EVENT_FIELDS} for e in events]
    tabs, st = inp["tabs"], inp["state"]
    nf = run_cascade(st, inp["n0"], inp["dev_tabs"], inp["key"],
                     tabs.n_passes)
    mark("cascade")
    if info is not None:
        info.update(capacity=st["E"].shape[0], hadrons_in=inp["n0"],
                    hadrons_out=nf, passes=tabs.n_passes)

    # [passed; cascaded], ordered by event (stable), into one buffer
    mcid_c, cols_c, eid_c, left = _final_columns(inp, nf)
    passed = inp["passed"]
    eid_o = torch.cat([inp["eid"][passed], eid_c])
    order = torch.argsort(eid_o, stable=True)
    n_ev, M = inp["n_events"], eid_o.shape[0]
    isz = cols_c.element_size()
    F = len(FLOAT_FIELDS)
    buf = torch.empty(8 * M + F * M * isz + 8 * (n_ev + 2),
                      dtype=torch.uint8, device=device)
    mcid_o = buf[:8 * M].view(torch.int64)
    cols_o = buf[8 * M:8 * M + F * M * isz].view(inp["dtype"]).view(F, M)
    meta = buf[8 * M + F * M * isz:].view(torch.int64)
    torch.index_select(torch.cat([inp["mcid"][passed], mcid_c]), 0, order,
                       out=mcid_o)
    torch.index_select(torch.cat([inp["cols"][:, passed], cols_c], dim=1), 1,
                       order, out=cols_o)
    meta[:n_ev + 1] = torch.searchsorted(
        eid_o[order], torch.arange(n_ev + 1, device=device))
    meta[n_ev + 1] = left
    mark("regroup")

    if device.type == "cuda":
        host = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(buf)
    else:
        host = buf
    h = host.numpy()
    np_dtype = np.float32 if inp["dtype"] == torch.float32 else np.float64
    mcid_h = h[:8 * M].view(np.int64)
    cols_h = h[8 * M:8 * M + F * M * isz].view(np_dtype).reshape(F, M)
    meta_h = h[8 * M + F * M * isz:].view(np.int64)
    if meta_h[n_ev + 1]:
        raise RuntimeError("unstable hadrons survived the cascade; the "
                           "table's chain depth exceeded n_passes")
    out = []
    for e in range(n_ev):
        lo, hi = int(meta_h[e]), int(meta_h[e + 1])
        ev = {"mcid": mcid_h[lo:hi]}
        ev.update((k, cols_h[j, lo:hi]) for j, k in enumerate(FLOAT_FIELDS))
        out.append(ev)
    mark("download")
    return out
