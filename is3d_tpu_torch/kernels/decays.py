"""Resonance-decay feed-down on smooth spectra (2- and 3-body).

Port of ``is3d_tpu.kernels.decays`` (its module docstring gives the
physics, the reference's layout and the deliberate fixes of its defects).
For each unstable parent R and each channel R -> 1 + 2 (+ 3), the daughter
spectrum gains

    dN_1/(pT dpT dphi dy) += pref * int dv dzeta MT dN_R(Y, MT, Phi)

with 12-point Gauss-Legendre rules in v (Y = y + v DeltaY) and zeta (MT =
MTbar + DeltaMT cos zeta), the parent's log spectrum interpolated
bilinearly in (MT, Phi) (trilinearly with Y in 3+1D) and continued as
exp(c + s MT) past its MT grid; 3-body channels add an outer 12-point
integral over the invariant mass s of the (2, 3) pair.

The cascade runs in three layers:

1. ``_decay_schedule`` (host, numpy): a static function of the particle
   table and the chosen list.  Per parent its channel-group tasks
   (kinematics and prefactors) and its wave: a parent decays after every
   heavier parent that feeds it, and the parents of one wave decay
   together.  ``plan_waves`` gives each wave its parent slots, one per
   (parent, adjusted mass), since the MT tail fit takes the adjusted
   mass's MT grid.
2. ``prepare_parents`` (torch on the spectra's device): the patched log
   tables and the MT tail fit of a wave's slots, read from the running
   spectra.
3. The wave integrals: ``decay_wave_cuda`` (the hand-written kernel
   csrc/decays.cu) for CUDA tensors, ``two_body_wave_plain`` and
   ``three_body_wave_plain`` (the gather form of the reference's
   evaluators, in buckets of tasks) for CPU tensors.

``do_resonance_decays`` keeps the spectra on their device from the first
wave to the last: every host-to-device copy is made before the first
launch, all-zero parents are evaluated (their log table is the -745 floor,
so they add exp(-745) ~ 0) instead of skipped after a read-back, and the
waves accumulate into a float64 copy of the spectra whatever the wave's
dtype.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..tensors import TensorContainer
from .launch import check_float, check_tensor, require_cuda, launch

TWO_PI = 2.0 * math.pi
GAUSS_PTS = 12
_GL_X, _GL_W = np.polynomial.legendre.leggauss(GAUSS_PTS)
_Q_X, _Q_W = np.polynomial.legendre.leggauss(24)

MT_FIT_THRESHOLD2 = 2.73   # mT^2 > 2.73 M^2 for tail-fit points (ref :2063)

# tasks per call of the plain integrals: bounds their (tasks, pT, phi, y,
# v, zeta) temporaries
WAVE_BUCKET = {2: 256, 3: 32}

# launches of csrc/decays.cu in this process (decay_wave_cuda), by body,
# and of its backward csrc/decays_bwd.cu (wave_bwd_cuda)
TWO_BODY_LAUNCHES = 0
THREE_BODY_LAUNCHES = 0
TWO_BODY_BWD_LAUNCHES = 0
THREE_BODY_BWD_LAUNCHES = 0

# The yardstick of the wave kernel's bound (wave_operations): the least
# FP32 and SFU operations of one Phi solution at one (task, pT, phi, y, v,
# zeta[, s]) inside the MT grid, an FMA as one operation, everything of
# fewer indices hoisted (the log2(e) scale of exp into the table).  2+1D,
# per evaluation: Phi = Phi~ +- phi (1), the wrap to [0, 2 pi) (2), the phi
# weight (2), the bilinear (MT, phi) lerp (3 lerps of 2), the weighted sum
# (1), exp (1 SFU).  3+1D, rapidity planes shared by neighbouring outputs:
# per evaluation one plane from four corner weights (4), the Y lerp (2),
# the weighted sum (1), exp (1 SFU); per (node, phi, +-) with an
# evaluation, Phi, the wrap and the phi weight (5), the four corner weights
# (5) and the first plane of its run of rapidities (4).
WAVE_EVAL_OPS = {2: (12, 1), 3: (7, 1)}
WAVE_RUN_OPS = 14
# The backward's (wave_backward_operations): per evaluation the forward
# value, formed as the backward kernel forms it (the bilinear (MT, phi)
# planes of its Y stencil with no plane shared between outputs: 2+1D 12 as
# the forward, 3+1D two planes 8, the Y lerp 2, the weight 1), exp (1 SFU),
# the cotangent times W exp 2, and the hat weights' share of it spread onto
# the corners: 4 FMAs in 2+1D, 8 (two planes) in 3+1D; per (node, phi, +-)
# in 3+1D the wrap, the phi weight and the four corner weights (10).
WAVE_BWD_EVAL_OPS = {2: (18, 1), 3: (21, 1)}
WAVE_BWD_RUN_OPS = 10

# ======================================================================
# schedule (host, numpy)
# ======================================================================

def _q_factor(M, m1, m2, m3):
    """Normalization Q = int_{s-}^{s+} ds g(s) (reference :99-121)."""
    a = (M + m1) ** 2
    b = (M - m1) ** 2
    c = (m2 + m3) ** 2
    d = (m2 - m3) ** 2
    s = c + (b - c) * (1.0 + _Q_X) / 2.0
    return float(np.sum(_Q_W * (b - c)
                        * np.sqrt(np.abs((a - s) * (b - s) * (s - c) * (s - d)))
                        / (2.0 * s)))


def _group_daughters(daughter_idx, chosen_pos):
    """Group chosen daughters by species -> list of (table_idx, multiplicity,
    other_daughter_table_indices)."""
    groups = {}
    for di in daughter_idx:
        if di in chosen_pos:
            if di not in groups:
                others = list(daughter_idx)
                others.remove(di)
                groups[di] = [0, others]
            groups[di][0] += 1
    return [(di, mult, others) for di, (mult, others) in groups.items()]


def _decay_schedule(table, mcids, pT, lightest):
    """Per-parent channel-group tasks and the wave level of every parent,
    a static function of the particle table and the chosen list (never of
    the spectra).  Returns (parent_rows, tasks2, tasks3, level): the chosen
    row of each decaying parent, heaviest first; per parent its 2-body
    tasks (seg, pref, MT_grid, m2, Estar, pstar, M) and 3-body tasks (seg,
    pref, MT_grid, m2, M, s_minus, s_plus, d), seg the daughter's chosen
    row; the wave of each parent."""
    mcids = np.asarray(mcids)
    chosen_table_idx = np.array([table.index_of_mcid(int(m)) for m in mcids])
    chosen_pos = {int(ti): i for i, ti in enumerate(chosen_table_idx)}

    # heaviest -> lightest among chosen, skip the lightest particle
    order = np.argsort(-table.mass[chosen_table_idx], kind="stable")

    parent_rows = []
    parent_tasks2 = []
    parent_tasks3 = []
    for ichosen in order:
        ti = int(chosen_table_idx[ichosen])
        if table.stable[ti]:
            continue
        if int(mcids[ichosen]) == int(lightest):
            continue
        mass_parent0 = float(table.mass[ti])
        width_parent = float(table.width[ti])
        tasks2 = []
        tasks3 = []

        for ch in range(len(table.decays_branch[ti])):
            branch = float(table.decays_branch[ti][ch])
            nd = abs(int(table.decays_n[ti][ch]))
            if branch <= 0.0 or nd in (0, 1) or nd > 3:
                continue
            d_mcids = [int(m) for m in table.decays_part[ti][ch][:nd]]
            try:
                d_idx = [table.index_of_mcid(m) for m in d_mcids]
            except KeyError:
                continue

            if nd == 2:
                i1, i2 = d_idx
                m1 = float(table.mass[i1])
                m2 = float(table.mass[i2])
                M = mass_parent0
                # width shift to open sub-threshold channels (ref
                # :242-258); with all three widths zero the channel is
                # closed outright (the loop could not make progress)
                closed = False
                w_par = 0.25 * width_parent
                w1 = 0.5 * float(table.width[i1])
                w2 = 0.5 * float(table.width[i2])
                if m1 + m2 > M and w_par == 0.0 and w1 == 0.0 and w2 == 0.0:
                    closed = True
                while not closed and m1 + m2 > M:
                    M += w_par
                    m1 -= w1
                    m2 -= w2
                    if m1 < 0.0 or m2 < 0.0:
                        closed = True
                if closed:
                    continue
                adj_mass = {i1: m1, i2: m2}
                MT_grid = np.sqrt(pT ** 2 + M ** 2)
                for di, mult, others in _group_daughters(d_idx, chosen_pos):
                    ma = adj_mass[di]
                    # Estar takes the *other* daughter's adjusted mass
                    mb = adj_mass[others[0]]
                    Estar = (M * M + ma * ma - mb * mb) / (2.0 * M)
                    pstar2 = Estar * Estar - ma * ma
                    if pstar2 <= 0.0:
                        continue
                    pstar = math.sqrt(pstar2)
                    pref = mult * M * branch / (8.0 * pstar)
                    tasks2.append((chosen_pos[di], pref, MT_grid, ma * ma,
                                   Estar, pstar, M))
            else:
                M = mass_parent0
                for di, mult, others in _group_daughters(d_idx, chosen_pos):
                    ma = float(table.mass[di])
                    mb = float(table.mass[others[0]])
                    mc_ = float(table.mass[others[1]])
                    s_plus = (M - ma) ** 2
                    s_minus = (mb + mc_) ** 2
                    d_ = (mb - mc_) ** 2
                    if s_plus <= s_minus:
                        continue  # kinematically closed at the table masses
                    Q = _q_factor(M, ma, mb, mc_)
                    if Q <= 0.0:
                        continue
                    MT_grid = np.sqrt(pT ** 2 + M ** 2)
                    pref = mult * M * M * (s_plus - s_minus) * branch / (8.0 * Q)
                    tasks3.append((chosen_pos[di], pref, MT_grid, ma * ma,
                                   M, s_minus, s_plus, d_))

        if tasks2 or tasks3:
            parent_rows.append(int(ichosen))
            parent_tasks2.append(tasks2)
            parent_tasks3.append(tasks3)

    # levelize: a parent waits for the heavier parents that feed it.  Feed
    # from a lighter parent into a heavier one (width-shifted channels)
    # still lands in the heavier spectrum but after its decay, as in the
    # reference's mass-ordered sequential cascade.
    row_to_slot = {r: i for i, r in enumerate(parent_rows)}
    level = np.zeros(len(parent_rows), dtype=np.int64)
    for i in range(len(parent_rows)):      # mass-descending order
        targets = [row_to_slot.get(t[0])
                   for t in parent_tasks2[i] + parent_tasks3[i]]
        # i feeds an already-processed heavier parent j: run i no earlier
        # than j (the same wave reads j's spectrum before any add lands)
        for j in targets:
            if j is not None and j < i:
                level[i] = max(level[i], level[j])
        # lighter parents fed by i decay strictly after i
        for j in targets:
            if j is not None and j > i:
                level[j] = max(level[j], level[i] + 1)
    return parent_rows, parent_tasks2, parent_tasks3, level


@dataclass(frozen=True)
class WavePlan:
    """One wave on the host: the chosen row and the (adjusted) mass of each
    parent slot, and the tasks with their slot, in schedule order:
    2-body (seg, pref, slot, m2, Estar, pstar, M), 3-body (seg, pref,
    slot, m2, M, s_minus, s_plus, d)."""
    rows: list
    masses: list
    tasks2: list
    tasks3: list


def plan_waves(schedule) -> list:
    """The schedule's waves, each parent with one slot per distinct
    (adjusted) mass among its tasks."""
    parent_rows, tasks2, tasks3, level = schedule
    n_waves = int(level.max()) + 1 if len(parent_rows) else 0
    waves = []
    for w in range(n_waves):
        rows, masses, t2, t3 = [], [], [], []
        for i in np.nonzero(level == w)[0]:
            slot_by_M = {}

            def slot_for(M, _row=parent_rows[i], _s=slot_by_M):
                if M not in _s:
                    _s[M] = len(rows)
                    rows.append(_row)
                    masses.append(M)
                return _s[M]

            t2 += [(t[0], t[1], slot_for(t[6])) + t[3:] for t in tasks2[i]]
            t3 += [(t[0], t[1], slot_for(t[4])) + t[3:] for t in tasks3[i]]
        waves.append(WavePlan(rows, masses, t2, t3))
    return waves


# ======================================================================
# device-side inputs of the wave integrals
# ======================================================================

@dataclass(frozen=True)
class WaveGrid(TensorContainer):
    """The momentum grid and the quadrature rules of the wave integrals:
    quad (3, 12) = Gauss-Legendre nodes x, weights w, cos(pi (1 + x) / 2)
    (the zeta nodes); y is (1,) in 2+1D; phi_pad, phi_invd, phi_bucket the
    wave kernel's phi intervals (phi_cells), built for CUDA tensors only
    (None on the CPU, whose plain version searches the grid)."""
    pT: torch.Tensor
    phi: torch.Tensor
    y: torch.Tensor
    quad: torch.Tensor
    dimension: int
    phi_pad: torch.Tensor | None = None      # (F + 2,)
    phi_invd: torch.Tensor | None = None     # (F + 1,)
    phi_bucket: torch.Tensor | None = None   # (NB,) int32


def phi_cells(phi, max_buckets: int) -> tuple[np.ndarray, np.ndarray,
                                              np.ndarray]:
    """The wave kernel's phi intervals of a sorted phi grid in [0, 2 pi):
    the padded grid phi[F-1] - 2 pi, phi[0..F-1], phi[0] + 2 pi (F + 2
    points, F + 1 intervals; interval i takes table columns (i - 1) mod F
    and i mod F, so the wrap cell is an ordinary interval), the inverse
    widths of its intervals, and a table of NB uniform buckets over [0, 2
    pi): bucket b holds the interval of the angle b h - h / 1000 (h = 2 pi
    / NB).  NB is the least for which every bucket, widened by h / 1000 on
    each side against the rounding of the kernel's b = int(Pw NB / 2 pi),
    holds at most one grid point, so one compare with the interval's right
    end finds the interval of any angle of the bucket
    (phi_cell_lookup).  Buckets narrower than the grid's least spacing /
    1.002 always do; raises if no NB <= max_buckets (what the kernel's
    shared memory holds, wave_blocking) does."""
    phi = np.asarray(phi, np.float64)
    pad = np.concatenate([[phi[-1] - TWO_PI], phi, [phi[0] + TWO_PI]])
    enough = int(1.002 * TWO_PI / np.diff(pad).min()) + 1
    for nb in range(1, min(max_buckets, enough) + 1):
        h = TWO_PI / nb
        lo = np.arange(nb) * h - 1e-3 * h
        hi = lo + 1.002 * h
        n_in = (np.searchsorted(pad[1:], hi) - np.searchsorted(pad[1:], lo))
        if n_in.max() <= 1:
            bucket = np.maximum(np.searchsorted(pad, lo) - 1, 0)
            return pad, 1.0 / np.diff(pad), bucket.astype(np.int32)
    raise ValueError(f"the phi grid of {phi.shape[0]} points has spacings "
                     f"down to {np.diff(pad).min():.3e}: no table of at most "
                     f"{max_buckets} uniform buckets holds one point each")


def phi_cell_lookup(Pw, pad, invd, bucket):
    """(iL, iR, t) of wrapped angles Pw in [0, 2 pi) as the wave kernel
    finds them in the tensors of phi_cells: the bucket's interval i, i + 1
    where Pw lies past its right end; the table columns (i - 1) mod F and
    i mod F and the weight of the right one."""
    nb = bucket.shape[0]
    F = pad.shape[0] - 2
    binv = (torch.tensor(float(nb), dtype=Pw.dtype)
            / torch.tensor(TWO_PI, dtype=Pw.dtype))
    b = (Pw * binv).long().clamp(max=nb - 1)
    i = bucket.long()[b]
    i = i + (Pw > pad[i + 1]).long()
    t = (Pw - pad[i]) * invd[i]
    return (i + F - 1) % F, i % F, t


def wave_grid(grid, dimension: int, dtype, device) -> WaveGrid:
    x = torch.as_tensor(_GL_X, dtype=dtype)
    quad = torch.stack([x, torch.as_tensor(_GL_W, dtype=dtype),
                        torch.cos(0.5 * math.pi * (1.0 + x))])
    t = lambda a: torch.as_tensor(a).to(device=device,
                                        dtype=dtype).contiguous()
    y = t(grid.y[:1] if dimension == 2 else grid.y)
    cells = {}
    if torch.device(device).type == "cuda":
        most = wave_blocking(_library(), torch.device(device), dtype, 2,
                             dimension, 1, grid.pT.shape[0],
                             grid.phi.shape[0], y.shape[0], 0).max_buckets
        pad, invd, bucket = phi_cells(
            grid.phi.to("cpu", torch.float64).numpy(), most)
        cells = dict(phi_pad=t(pad), phi_invd=t(invd),
                     phi_bucket=torch.as_tensor(bucket, device=device))
    return WaveGrid(pT=t(grid.pT), phi=t(grid.phi), y=y,
                    quad=quad.to(device).contiguous(), dimension=dimension,
                    **cells)


@dataclass(frozen=True)
class ParentTables(TensorContainer):
    """A wave's parent slots: logdN (U, P, F, Y) patched log spectra; tc, ts
    (U, F, Y) the MT tail's const and slope; mtg (U, P) the MT grid
    sqrt(pT^2 + M^2) of the slot's mass."""
    logdN: torch.Tensor
    tc: torch.Tensor
    ts: torch.Tensor
    mtg: torch.Tensor


@dataclass(frozen=True)
class WaveTasks(TensorContainer):
    """One launch: the 2- or 3-body tasks of a wave.  par (K, 6) = pref,
    m2, Estar, pstar, M, 0 (2-body) or pref, m2, M, s_minus, s_plus, d
    (3-body); seg (K,) the target row of each task; the fold's plan: the
    rows fed (target), and for each the tasks feeding it in schedule order
    (order[tstart[t]:tstart[t + 1]])."""
    nbody: int
    slot: torch.Tensor     # (K,) int32
    seg: torch.Tensor      # (K,) int64
    par: torch.Tensor      # (K, 6)
    order: torch.Tensor    # (K,) int32
    target: torch.Tensor   # (n_target,) int32
    tstart: torch.Tensor   # (n_target + 1,) int32


def wave_tasks(nbody: int, tasks: list, dtype, device) -> WaveTasks:
    """WaveTasks of the host task tuples of WavePlan."""
    seg = np.array([t[0] for t in tasks], dtype=np.int64)
    par = np.zeros((len(tasks), 6))
    par[:, 0] = [t[1] for t in tasks]
    par[:, 1:len(tasks[0]) - 2] = [t[3:] for t in tasks]
    order = np.argsort(seg, kind="stable")
    target, counts = np.unique(seg, return_counts=True)
    tstart = np.concatenate([[0], np.cumsum(counts)])
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    return WaveTasks(
        nbody=nbody, slot=i32([t[2] for t in tasks]),
        seg=torch.as_tensor(seg, device=device),
        par=torch.as_tensor(par, dtype=dtype, device=device),
        order=i32(order), target=i32(target), tstart=i32(tstart))


def prepare_parents(parents: torch.Tensor, mtg: torch.Tensor,
                    masses: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(U, P, F, Y) parent spectra -> (patched log (U, P, F, Y), tail const
    and slope (U, F, Y)): per (slot, phi, y) column, the least-squares line
    log dN = c + s MT through the relativistic finite points (MT >
    sqrt(2.73) M; the last two finite points where fewer than two are),
    and every non-finite log replaced by the line; const -745 and slope 0
    where no line fits.  mtg (U, P) the slots' MT grids, masses (U,)
    float64."""
    dtype = parents.dtype
    pos = parents > 0.0
    logdN = torch.where(pos, torch.log(torch.where(pos, parents, 1.0)),
                        -math.inf)
    mt = mtg[:, :, None, None]
    mT_min = (MT_FIT_THRESHOLD2 ** 0.5 * masses).to(dtype)[:, None, None,
                                                             None]
    finite = torch.isfinite(logdN)
    primary = finite & (mt > mT_min)
    # 1 at the last finite point of a column, 2 at the one before, ...
    rank_from_end = torch.flip(torch.cumsum(
        torch.flip(finite.to(torch.int32), [1]), 1), [1])
    fallback = finite & (rank_from_end <= 2)
    sel = torch.where(primary.sum(1, keepdim=True) >= 2, primary, fallback)
    self_f = sel.to(dtype)
    ylog = torch.where(sel, logdN, 0.0)
    S0 = self_f.sum(1)
    S1 = (self_f * mt).sum(1)
    S2 = (self_f * mt * mt).sum(1)
    T0 = ylog.sum(1)
    T1 = (ylog * mt).sum(1)
    det = S0 * S2 - S1 * S1
    ok = (S0 >= 2) & (det.abs() > 0.0)
    safe_det = torch.where(ok, det, 1.0)
    slope = torch.where(ok, (S0 * T1 - S1 * T0) / safe_det, 0.0)
    const = torch.where(ok, (T0 * S2 - T1 * S1) / safe_det, -745.0)
    patched = torch.where(finite, logdN, const[:, None] + slope[:, None] * mt)
    return patched.contiguous(), const.contiguous(), slope.contiguous()


def parent_tables(acc: torch.Tensor, rows: torch.Tensor,
                  masses: torch.Tensor, mtg: torch.Tensor,
                  dtype) -> ParentTables:
    """A wave's ParentTables from the running float64 spectra ``acc`` (S,
    P, F, Y): slot u reads row rows[u] with mass masses[u] (float64) and
    MT grid mtg[u], in the wave's ``dtype``."""
    parents = acc.index_select(0, rows).to(dtype)
    logdN, tc, ts = prepare_parents(parents, mtg, masses)
    return ParentTables(logdN=logdN, tc=tc, ts=ts, mtg=mtg)


# ======================================================================
# plain versions of the wave integrals (torch, gather form)
# ======================================================================

def _interp_phi_indices(phi, Phip):
    """Wrap-around linear interpolation stencil in Phip.
    Returns (iL, iR, wL, wR)."""
    F = phi.shape[0]
    inside = (Phip >= phi[0]) & (Phip <= phi[-1])
    iR_in = torch.searchsorted(phi, Phip).clamp(1, F - 1)
    iL_in = iR_in - 1
    # outside: between (phi[-1] - 2 pi) and phi[0]; the angle is mapped
    # near 0 (the reference's expression, kept as it is)
    Phip_out = Phip - torch.floor(Phip / math.pi) * TWO_PI
    phiL = torch.where(inside, phi[iL_in], phi[-1] - TWO_PI)
    phiR = torch.where(inside, phi[iR_in], phi[0])
    x = torch.where(inside, Phip, Phip_out)
    iL = torch.where(inside, iL_in, F - 1)
    iR = torch.where(inside, iR_in, 0)
    t = (x - phiL) / (phiR - phiL)
    return iL, iR, 1.0 - t, t


def _eval_parent_pair(tables: ParentTables, slot, wg: WaveGrid, MT, Phip1,
                      Phip2, Y):
    """Sum of exp(log dN) at (MT, Phip1[, Y]) and (MT, Phip2[, Y]): the
    gather form of the reference's evaluators (_eval_parent_2d_pair_gather,
    _eval_parent_3d_pair_gather), batched over tasks with slot (B,).
    Shapes broadcast to (B, P, F, Y, V, Z): MT (B, P, 1, 1, V, Z), Phip
    (B, P, F, 1, V, Z), Y (B, P, 1, Y, V, 1) or None in 2+1D."""
    U, Pg, F, NY = tables.logdN.shape
    B = slot.shape[0]
    g = tables.mtg[slot]                                   # (B, Pg)
    q = MT.reshape(B, -1).contiguous()
    iMR = torch.searchsorted(g, q).clamp(1, Pg - 1)
    iML = iMR - 1
    gL, gR = g.gather(1, iML), g.gather(1, iMR)
    tM = ((q - gL) / (gR - gL)).reshape(MT.shape)
    inside = (q <= g[:, -1:]).reshape(MT.shape)
    iML = iML.reshape(MT.shape)
    iMR = iMR.reshape(MT.shape)
    s = slot.reshape((B,) + (1,) * (MT.dim() - 1))
    flat = tables.logdN.reshape(-1)
    tc, ts = tables.tc.reshape(-1), tables.ts.reshape(-1)
    if Y is None:
        planes = [(torch.zeros_like(s), None)]
    else:
        iYR = torch.searchsorted(wg.y, Y.contiguous()).clamp(1, NY - 1)
        iYL = iYR - 1
        tY = (Y - wg.y[iYL]) / (wg.y[iYR] - wg.y[iYL])
        planes = [(iYL, 1.0 - tY), (iYR, tY)]

    def one(Phip):
        iL, iR, wL, wR = _interp_phi_indices(wg.phi, Phip)
        # flat offsets of the (MT row, phi) and (phi) stencils at the size
        # of Phip; the y plane is added last, at the full size
        row = {(m, f): ((s * Pg + iM) * F + iF) * NY
               for m, iM in (("L", iML), ("R", iMR))
               for f, iF in (("L", iL), ("R", iR))}
        col = {f: (s * F + iF) * NY for f, iF in (("L", iL), ("R", iR))}
        val = 0.0
        for iY, wY in planes:
            L = lambda m, f: flat[row[m, f] + iY]
            C = lambda v, f: v[col[f] + iY]
            bi = ((L("L", "L") * wL + L("L", "R") * wR) * (1.0 - tM)
                  + (L("R", "L") * wL + L("R", "R") * wR) * tM)
            tail = ((C(tc, "L") + C(ts, "L") * MT) * wL
                    + (C(tc, "R") + C(ts, "R") * MT) * wR)
            plane = torch.where(inside, bi, tail)
            val = plane if wY is None else val + plane * wY
        return torch.exp(val)

    out = one(Phip1) + one(Phip2)
    if Y is None:
        return out
    return torch.where(Y.abs() <= wg.y[-1].abs(), out, 0.0)


class _ArccosClipped(torch.autograd.Function):
    """acos(clamp(x, -1, 1)) with the JAX package's derivative
    (_arccos_clipped, is3d_tpu/kernels/decays.py:448-470): -1 / sqrt(1 -
    x^2) inside (-1, 1), 0 where |x| >= 1 (autograd of the clamp then acos
    is inf x 0 = NaN there)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.acos(torch.clamp(x, -1.0, 1.0))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        xc = torch.clamp(x, -1.0, 1.0)
        inside = x.abs() < 1.0
        d = -1.0 / torch.sqrt(torch.clamp_min(1.0 - xc * xc, 1e-30))
        return g * torch.where(inside, d, torch.zeros_like(d))


def arccos_clipped(x):
    """acos(clamp(x, -1, 1)); under autograd with _ArccosClipped's
    derivative, the same forward either way."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _ArccosClipped.apply(x)
    return torch.acos(torch.clamp(x, -1.0, 1.0))


def _kinematics(m2, Estar, pstar, M, wg: WaveGrid):
    """The (v, zeta) nodes of B tasks with m2, Estar, pstar, M (B,) (the
    reference's _decay_kinematics and _parent_MT_Phip, batched): DeltaY
    (B, P), the parent's MT and Phi~ (B, P, V, Z), the v weights (B, P,
    V)."""
    x, wv, coszeta = wg.quad
    pT = wg.pT
    c = lambda t: t[:, None, None]                         # (B, 1, 1)
    pT2 = pT ** 2
    mT2 = pT2 + m2[:, None]                                # (B, P)
    mT = torch.sqrt(mT2)
    DeltaY = torch.log((pstar[:, None] + torch.sqrt(Estar[:, None] ** 2
                                                    + pT2)) / mT)
    a = x * DeltaY[..., None]                              # (B, P, V)
    coshv, sinhv = torch.cosh(a), torch.sinh(a)
    # cancellation-free forms (reference :484-498): mT^2 cosh^2 - pT^2 =
    # m1^2 + mT^2 sinh^2 and Estar^2 + pT^2 - mT^2 cosh^2 = pstar^2 -
    # mT^2 sinh^2; the left-hand forms are NaN for massless daughters in
    # float32
    mT2s2 = mT2[..., None] * sinhv ** 2
    denom = c(m2) + mT2s2
    MTbar = c(Estar * M) * mT[..., None] * coshv / denom
    DeltaMT = (c(M) * pT[:, None] * torch.sqrt((c(pstar) ** 2 - mT2s2).abs())
               / denom)
    mTc = mT[..., None] * coshv / pT[:, None]
    vw = DeltaY[..., None] * wv / torch.sqrt(denom.abs())  # (B, P, V)
    MT = MTbar[..., None] + DeltaMT[..., None] * coszeta   # (B, P, V, Z)
    # 1e-30 (not 1e-300): a normal number in float32 too
    PT = torch.sqrt(torch.clamp_min(MT ** 2 - c(M)[..., None] ** 2, 1e-30))
    Phip_t = arccos_clipped(
        (MT * mTc[..., None] - (Estar[:, None] * M[:, None] / pT)[..., None,
                                                                  None])
        / PT)
    return DeltaY, MT, Phip_t, vw


def _two_body_integral(tables: ParentTables, slot, m2, Estar, pstar, M,
                       wg: WaveGrid):
    """(B, P, F, Y) feed-down integrals, without prefactor, of B tasks
    with slot, m2, Estar, pstar, M (B,) (the reference's
    _two_body_integral, batched)."""
    DeltaY, MT, Phip_t, vw = _kinematics(m2, Estar, pstar, M, wg)
    x, wv, _ = wg.quad
    # (B, P, F, V, Z) -> with a y axis (B, P, F, 1, V, Z)
    ph = wg.phi[None, None, :, None, None]
    Phip1 = torch.remainder(Phip_t[:, :, None] + ph, TWO_PI)[:, :, :, None]
    Phip2 = torch.remainder(-Phip_t[:, :, None] + ph, TWO_PI)[:, :, :, None]
    MTb = MT[:, :, None, None]                             # (B, P, 1, 1, V, Z)
    Y = None
    if wg.dimension == 3:
        Y = wg.y[:, None] + x[None, :] * DeltaY[..., None, None]   # (B, P, Y, V)
        Y = Y[:, :, None, :, :, None]                      # (B, P, 1, Y, V, 1)
    dN = _eval_parent_pair(tables, slot, wg, MTb, Phip1, Phip2, Y)
    zsum = torch.einsum("bpfyvz,z->bpfyv", MTb * dN, wv)
    return torch.einsum("bpfyv,bpv->bpfy", zsum, vw)


def _three_body_s(m2, M, s_minus, s_plus, d, wg: WaveGrid):
    """Estar, pstar and the weight (B, 12) at the 12 s nodes of B 3-body
    tasks (the reference's _three_body_integral)."""
    x, w, _ = wg.quad
    s = s_minus[:, None] + (s_plus - s_minus)[:, None] * (1.0 + x) / 2.0
    Estar = (M[:, None] ** 2 + m2[:, None] - s) / (2.0 * M[:, None])
    pstar = torch.sqrt(torch.clamp_min(Estar ** 2 - m2[:, None], 1e-30))
    sw = w * torch.sqrt(((s - s_minus[:, None]) * (s - d[:, None])).abs()) / s
    return Estar, pstar, sw


def _three_body_integral(tables: ParentTables, slot, m2, M, s_minus, s_plus,
                         d, wg: WaveGrid):
    """The outer 12-point s integral of _two_body_integral: Estar, pstar
    and the weight depend on the invariant mass s of the (2, 3) pair."""
    Estar, pstar, sw = _three_body_s(m2, M, s_minus, s_plus, d, wg)
    out = 0.0
    for k in range(GAUSS_PTS):
        out = out + sw[:, k, None, None, None] * _two_body_integral(
            tables, slot, m2, Estar[:, k], pstar[:, k], M, wg)
    return out


def task_nodes(tasks: WaveTasks, wg: WaveGrid):
    """DeltaY (K, S, P) and the parent's MT and Phi~ (K, S, P, V, Z) of
    every task, S = 1 (2-body) or the 12 s nodes (3-body)."""
    p = tasks.par[:, 1:]
    if tasks.nbody == 2:
        DY, MT, Ph, _ = _kinematics(p[:, 0], p[:, 1], p[:, 2], p[:, 3], wg)
        return DY[:, None], MT[:, None], Ph[:, None]
    Estar, pstar, _ = _three_body_s(*p.unbind(1), wg)
    nodes = [_kinematics(p[:, 0], Estar[:, k], pstar[:, k], p[:, 1], wg)
             for k in range(GAUSS_PTS)]
    return tuple(torch.stack([n[i] for n in nodes], 1) for i in range(3))


def _wave_vy(tasks: WaveTasks, wg: WaveGrid):
    """(K, S, P, V) counts of the outputs y of each (task, s, pT, v) that
    are evaluated: all (1) in 2+1D, in 3+1D those with |Y| <= |y_max| (the
    rest is exactly 0 and never evaluated)."""
    DY = task_nodes(tasks, wg)[0]                          # (K, S, P)
    if wg.dimension == 2:
        return DY.new_ones(DY.shape + (GAUSS_PTS,), dtype=torch.int64)
    Y = wg.y[:, None] + wg.quad[0][None, :] * DY[..., None, None]
    return (Y.abs() <= wg.y[-1].abs()).sum(-2)             # (K, S, P, V)


def wave_evaluations(tasks: WaveTasks, wg: WaveGrid) -> int:
    """The evaluations one launch does on these inputs: per (task, s, pT,
    phi, y, v, zeta) two Phi solutions, in 3+1D only where |Y| <= |y_max|
    (the rest is exactly 0 and never evaluated)."""
    return int(_wave_vy(tasks, wg).sum()) * GAUSS_PTS * wg.phi.shape[0] * 2


def wave_operations(tasks: WaveTasks, wg: WaveGrid) -> tuple[int, int]:
    """The least (FP32, SFU) operations of one launch on these inputs
    (WAVE_EVAL_OPS a evaluation, in 3+1D WAVE_RUN_OPS a (node, phi, +-)
    with an evaluation)."""
    n_vy = _wave_vy(tasks, wg)
    per = GAUSS_PTS * wg.phi.shape[0] * 2
    evals = int(n_vy.sum()) * per
    fp32, sfu = WAVE_EVAL_OPS[wg.dimension]
    fp32 *= evals
    if wg.dimension == 3:
        fp32 += WAVE_RUN_OPS * int((n_vy > 0).sum()) * per
    return fp32, sfu * evals


def wave_backward_operations(tasks: WaveTasks, wg: WaveGrid) -> tuple[int,
                                                                      int]:
    """The least (FP32, SFU) operations of one backward launch on these
    inputs (WAVE_BWD_EVAL_OPS an evaluation, in 3+1D WAVE_BWD_RUN_OPS a
    (node, phi, +-) with an evaluation)."""
    n_vy = _wave_vy(tasks, wg)
    per = GAUSS_PTS * wg.phi.shape[0] * 2
    evals = int(n_vy.sum()) * per
    fp32, sfu = WAVE_BWD_EVAL_OPS[wg.dimension]
    fp32 *= evals
    if wg.dimension == 3:
        fp32 += WAVE_BWD_RUN_OPS * int((n_vy > 0).sum()) * per
    return fp32, sfu * evals


def _wave_plain(integral, tables: ParentTables, tasks: WaveTasks,
                wg: WaveGrid, n_seg: int):
    P, F, NY = tables.logdN.shape[1:]
    out = tables.logdN.new_zeros((n_seg, P, F, NY))
    B = WAVE_BUCKET[wg.dimension]
    for lo in range(0, tasks.slot.shape[0], B):
        par = tasks.par[lo:lo + B]
        part = integral(tables, tasks.slot[lo:lo + B].long(), wg, par[:, 1:])
        out.index_add_(0, tasks.seg[lo:lo + B],
                       part * par[:, 0, None, None, None])
    return out


def two_body_wave_plain(tables: ParentTables, tasks: WaveTasks,
                        wg: WaveGrid, n_seg: int):
    """Plain version of the wave kernel's 2-body launch: the (n_seg, P, F,
    Y) feed-down of the tasks, each x its prefactor, summed over tasks in
    schedule order (index_add_), in buckets of WAVE_BUCKET tasks."""
    return _wave_plain(
        lambda t, sl, g, p: _two_body_integral(t, sl, p[:, 0], p[:, 1],
                                               p[:, 2], p[:, 3], g),
        tables, tasks, wg, n_seg)


def three_body_wave_plain(tables: ParentTables, tasks: WaveTasks,
                          wg: WaveGrid, n_seg: int):
    """Plain version of the wave kernel's 3-body launch (as
    two_body_wave_plain)."""
    return _wave_plain(
        lambda t, sl, g, p: _three_body_integral(t, sl, p[:, 0], p[:, 1],
                                                 p[:, 2], p[:, 3], p[:, 4],
                                                 g),
        tables, tasks, wg, n_seg)


def wave_plain(tables: ParentTables, tasks: WaveTasks, wg: WaveGrid,
               n_seg: int):
    fn = two_body_wave_plain if tasks.nbody == 2 else three_body_wave_plain
    return fn(tables, tasks, wg, n_seg)


# ======================================================================
# the hand-written kernel (csrc/decays.cu)
# ======================================================================

@dataclass(frozen=True)
class WaveBlocking:
    """The wave kernel's blocking for one launch on one card, as the C side
    (csrc/decays.cu:wave_blocking, the owner of the blocking) reports
    it."""
    pt_block: int      # pT values a block
    chunks: int        # chunks of each task's (s, v) node pairs
    smem: int          # shared memory a block (bytes)
    max_buckets: int   # most phi buckets the shared memory holds


def wave_blocking(lib, device: torch.device, dtype, nbody: int,
                  dimension: int, n_tasks: int, P: int, F: int, NY: int,
                  n_buckets: int) -> WaveBlocking:
    out = (ctypes.c_int * 4)()
    fn = (lib.is3d_decay_wave_blocking_f64 if dtype == torch.float64
          else lib.is3d_decay_wave_blocking_f32)
    with torch.cuda.device(device):
        rc = fn(nbody, dimension, n_tasks, P, F, NY, n_buckets, out)
    if rc != 0:
        raise RuntimeError("decay_wave: no launch configuration: "
                           f"{lib.is3d_cuda_error_string(rc).decode()}")
    return WaveBlocking(*out)


def fold_rows(tasks: WaveTasks, n_chunks: int) -> list:
    """The scratch rows that fold_kernel adds into each target row, in its
    order: the row's tasks in schedule order, each task's chunks 0 ..
    n_chunks - 1 (row task * n_chunks + chunk)."""
    order = tasks.order.tolist()
    tstart = tasks.tstart.tolist()
    return [[order[j] * n_chunks + c for j in range(tstart[t], tstart[t + 1])
             for c in range(n_chunks)] for t in range(len(tstart) - 1)]


def _library():
    from ..native.build import cuda_library
    lib = cuda_library("decays")
    if not getattr(lib, "_is3d_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.is3d_decay_wave_f32, lib.is3d_decay_wave_f64):
            fn.restype = ci
            fn.argtypes = [ci, ci,                     # nbody, dimension
                           vp, vp, vp, vp,             # logdN, tc, ts, mtg
                           vp, vp, vp, vp, ci,         # pT, phi cells, NB
                           vp, vp,                     # y, quad
                           ci, ci, ci, ci,             # U, P, F, Y
                           vp, vp, ci, ci,             # slot, par, K, NC
                           vp, vp, vp, ci,             # order, target, tstart, n
                           vp, vp, vp]                 # scratch, acc, stream
        for fn in (lib.is3d_decay_wave_blocking_f32,
                   lib.is3d_decay_wave_blocking_f64):
            fn.restype = ci
            fn.argtypes = [ci] * 7 + [ctypes.POINTER(ci)]
        lib.is3d_cuda_error_string.restype = ctypes.c_char_p
        lib.is3d_cuda_error_string.argtypes = [ci]
        lib._is3d_bound = True
    return lib


def decay_wave_cuda(tables: ParentTables, tasks: WaveTasks, wg: WaveGrid,
                    acc: torch.Tensor):
    """Launch csrc/decays.cu on the current stream: the wave kernel writes
    each (task, chunk)'s feed-down x its prefactor to scratch, the fold
    kernel adds each target row's rows (fold_rows) into ``acc`` (S, P, F,
    Y), float64, in place."""
    global TWO_BODY_LAUNCHES, THREE_BODY_LAUNCHES
    check_float("decay_wave_cuda", tables.logdN)
    if tables.logdN.dim() != 4:
        raise ValueError("logdN must be (U, P, F, Y), got "
                         f"{tuple(tables.logdN.shape)}")
    U, P, F, NY = tables.logdN.shape
    like = tables.logdN
    check_tensor("logdN", like, (U, P, F, NY), like)
    check_tensor("tc", tables.tc, (U, F, NY), like)
    check_tensor("ts", tables.ts, (U, F, NY), like)
    check_tensor("mtg", tables.mtg, (U, P), like)
    check_tensor("pT", wg.pT, (P,), like)
    check_tensor("phi", wg.phi, (F,), like)
    if wg.phi_bucket is not None:
        check_tensor("phi_pad", wg.phi_pad, (F + 2,), like)
        check_tensor("phi_invd", wg.phi_invd, (F + 1,), like)
        check_tensor("phi_bucket", wg.phi_bucket, (wg.phi_bucket.shape[0],),
                     like, torch.int32)
    check_tensor("y", wg.y, (NY,), like)
    check_tensor("quad", wg.quad, (3, GAUSS_PTS), like)
    K = tasks.slot.shape[0]
    n_t = tasks.target.shape[0]
    check_tensor("slot", tasks.slot, (K,), like, torch.int32)
    check_tensor("par", tasks.par, (K, 6), like)
    check_tensor("order", tasks.order, (K,), like, torch.int32)
    check_tensor("target", tasks.target, (n_t,), like, torch.int32)
    check_tensor("tstart", tasks.tstart, (n_t + 1,), like, torch.int32)
    check_tensor("acc", acc, (acc.shape[0], P, F, NY), like, torch.float64)
    if tasks.nbody not in (2, 3) or (wg.dimension, NY > 1) not in (
            (2, False), (3, True)):
        raise ValueError(f"decay_wave_cuda takes 2- or 3-body tasks and a "
                         f"2+1D (Y = 1) or 3+1D (Y > 1) grid, got "
                         f"{tasks.nbody}-body, dimension {wg.dimension}, "
                         f"Y = {NY}")
    require_cuda("decay_wave_cuda", like)
    if wg.phi_bucket is None:
        raise ValueError("decay_wave_cuda needs the phi cells of a wave grid "
                         "built on the card (wave_grid on a CUDA device)")
    NB = wg.phi_bucket.shape[0]
    lib = _library()
    n_chunks = wave_blocking(lib, like.device, like.dtype, tasks.nbody,
                             wg.dimension, K, P, F, NY, NB).chunks
    scratch = like.new_empty((K * n_chunks, P, F, NY))
    fn = (lib.is3d_decay_wave_f64 if like.dtype == torch.float64
          else lib.is3d_decay_wave_f32)
    launch(lib, "decay_wave", fn, like.device, tasks.nbody, wg.dimension,
           like.data_ptr(), tables.tc.data_ptr(), tables.ts.data_ptr(),
           tables.mtg.data_ptr(), wg.pT.data_ptr(), wg.phi_pad.data_ptr(),
           wg.phi_invd.data_ptr(), wg.phi_bucket.data_ptr(), NB,
           wg.y.data_ptr(), wg.quad.data_ptr(), U, P, F, NY,
           tasks.slot.data_ptr(), tasks.par.data_ptr(), K, n_chunks,
           tasks.order.data_ptr(), tasks.target.data_ptr(),
           tasks.tstart.data_ptr(), n_t, scratch.data_ptr(), acc.data_ptr())
    if tasks.nbody == 2:
        TWO_BODY_LAUNCHES += 1
    else:
        THREE_BODY_LAUNCHES += 1


# ======================================================================
# the backward of the wave kernel (csrc/decays_bwd.cu)
# ======================================================================

def wave_bwd_plain(tables: ParentTables, tasks: WaveTasks, wg: WaveGrid,
                   G: torch.Tensor):
    """Plain version of the backward kernel: the gradients (d_logdN, d_tc,
    d_ts) of <G, wave_plain(tables, tasks)> (G (n_seg, P, F, Y), the
    cotangent of the spectra the wave feeds, any float dtype), by torch
    autograd of the gather-form plain version."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (tables.logdN, tables.tc, tables.ts)]
        t = ParentTables(logdN=leaves[0], tc=leaves[1], ts=leaves[2],
                         mtg=tables.mtg)
        out = wave_plain(t, tasks, wg, G.shape[0])
        return torch.autograd.grad(out, leaves, G.to(out.dtype))


def padded_tables(tables: ParentTables) -> torch.Tensor:
    """(U, LEN) the backward kernel's copy of the slots' tables: per slot
    the log table (P, F + 2, Y), then tc and ts (F + 2, Y) each, their phi
    columns padded as the forward stages them (column c holds the slot's
    column (c - 1) mod F), float32 scaled by log2(e)."""
    pad = lambda x: torch.cat([x[..., -1:, :], x, x[..., :1, :]], dim=-2)
    U = tables.logdN.shape[0]
    flat = torch.cat([pad(tables.logdN).reshape(U, -1),
                      pad(tables.tc).reshape(U, -1),
                      pad(tables.ts).reshape(U, -1)], dim=1)
    if flat.dtype == torch.float32:
        flat = flat * torch.tensor(1.4426950408889634, dtype=torch.float32)
    return flat.contiguous()


# the tail's breakpoints a slot (wave_term_bound_log2): MT from the grid's
# end up by 2^(1/TAIL_STEPS) a step
TAIL_BREAKS = 256
TAIL_STEPS = 32


def wave_term_bound_log2(tables: ParentTables, tasks: WaveTasks,
                         wg: WaveGrid, G: torch.Tensor) -> torch.Tensor:
    """(U, 2) float64: log2 of a bound above |g W exp(L) w_c| of every term
    the backward kernel adds to each slot's log rows (nodes inside the MT
    grid) and to its tail rows tc, ts (nodes past it), -inf where none,
    without evaluating one: per task |pref| max |G| of its row; per node
    (s, pT, v, zeta) its W and MT (the forward's kinematics) and a bound
    on L and on the corner weight.  Inside the MT grid L interpolates two
    rows (at most the larger row maximum, weight at most 1); below it
    (0 <= MT < the grid's first) the interpolation extrapolates: its
    largest value over (phi, y) is convex in MT, so below the chord from
    MT = 0 to the first row, weight 1 - tM; past the grid L <= the upper
    envelope of the lines tc + ts MT over (phi, y), convex in MT, so at
    most its larger value at the ends of the TAIL_BREAKS interval MT falls
    in (past the last, that plus max ts times the rest), weight max(1,
    MT).  The intervals next to the one
    MT falls in, and both sides of the grid's end, are taken too, so the
    kernel's own rounding of MT cannot leave the bound; one bit more covers
    its rounding of the term.  Assumes a y grid symmetric about 0 (|Y| <=
    |y_max| inside it), as every grid is."""
    f64 = torch.float64
    U, P = tables.mtg.shape
    K = tasks.slot.shape[0]
    dev = tables.logdN.device
    ln2 = math.log(2.0)
    log = tables.logdN.to(f64)
    m = tables.mtg.to(f64)
    rmax = log.amax((2, 3))                                 # (U, P)
    t_lo = -m[:, 0] / (m[:, 1] - m[:, 0])                   # MT = 0
    below = ((1.0 - t_lo[:, None, None]) * log[:, 0]
             + t_lo[:, None, None] * log[:, 1]).amax((1, 2))  # at MT = 0
    tc, ts = tables.tc.to(f64), tables.ts.to(f64)
    brk = (m[:, -1:] * (1.0 - 1e-4) * torch.exp2(torch.arange(
        TAIL_BREAKS, dtype=f64, device=dev) / TAIL_STEPS))  # (U, NB)
    env = (tc.reshape(U, -1, 1) + ts.reshape(U, -1, 1) * brk[:, None]
           ).amax(1)                                        # (U, NB)
    tsmax = ts.amax((1, 2)).clamp_min(0.0)
    slot = tasks.slot.long()
    mtg = m[slot].contiguous()                              # (K, P)
    rmax_k, below_k, t_lo_k = rmax[slot], below[slot], t_lo[slot]
    brk_k, env_k, tsmax_k = brk[slot], env[slot], tsmax[slot]
    par = tasks.par.to(f64)
    wg64 = wg.to(None, f64)
    gmax = (G.abs().amax((1, 2, 3)).to(f64)[tasks.seg.long()]
            * par[:, 0].abs())
    wv = wg64.quad[1]
    p = par[:, 1:]
    if tasks.nbody == 2:
        sets = [(p[:, 0], p[:, 1], p[:, 2], p[:, 3], torch.ones_like(p[:, 0]))]
    else:
        Es, ps, sw = _three_body_s(*p.unbind(1), wg64)
        sets = [(p[:, 0], Es[:, i], ps[:, i], p[:, 1], sw[:, i])
                for i in range(GAUSS_PTS)]
    best = torch.full((K, 2), -math.inf, dtype=f64, device=dev)
    for m2, Estar, pstar, M, sw in sets:
        _, MT, _, vw = _kinematics(m2, Estar, pstar, M, wg64)
        W = sw[:, None, None, None] * vw[..., None] * wv * MT
        q = MT.reshape(K, -1).contiguous()
        iR = torch.searchsorted(mtg, q)
        inside = torch.full_like(q, -math.inf)
        for d in (-1, 0, 1):
            j = (iR + d).clamp(1, P - 1)
            gL, gR = mtg.gather(1, j - 1), mtg.gather(1, j)
            t = (q - gL) / (gR - gL)
            rows = torch.maximum(rmax_k.gather(1, j - 1), rmax_k.gather(1, j))
            lam = (t / t_lo_k[:, None]).clamp(0.0, 1.0)
            chord = (1.0 - lam) * rmax_k[:, :1] + lam * below_k[:, None]
            lb = torch.where((t < 0.0) & (j == 1),
                             chord / ln2 + torch.log2(1.0 - t),
                             rows / ln2 + torch.log2(torch.maximum(
                                 (1.0 - t).abs(), t.abs())))
            ok = (t <= 1.0 + 1e-4) & ((t >= -1e-4) | (j == 1))
            inside = torch.maximum(inside, torch.where(ok, lb, -math.inf))
        i = torch.floor(TAIL_STEPS * torch.log2(q / brk_k[:, :1])).long()
        lo = i.clamp(0, TAIL_BREAKS - 2)
        env_q = torch.maximum(env_k.gather(1, lo), env_k.gather(1, lo + 1))
        past = (q - brk_k[:, -1:]).clamp_min(0.0) * tsmax_k[:, None]
        env_q = torch.where(i >= TAIL_BREAKS - 1, env_k[:, -1:] + past, env_q)
        tail = env_q / ln2 + torch.log2(q.clamp_min(1.0))
        edge = mtg[:, -1:]
        lw = torch.log2(W.reshape(K, -1).abs())
        node_in = torch.where(q <= edge * (1.0 + 1e-5), lw + inside,
                              -math.inf)
        node_tail = torch.where(q > edge * (1.0 - 1e-5), lw + tail,
                                -math.inf)
        best = torch.maximum(best, torch.stack([node_in.amax(1),
                                                node_tail.amax(1)], 1))
    task = torch.log2(gmax)[:, None] + best + 1.0
    return torch.full((U, 2), -math.inf, dtype=f64, device=dev).scatter_reduce(
        0, slot[:, None].expand(K, 2), task, "amax")


def wave_bwd_scale(tables: ParentTables, tasks: WaveTasks, wg: WaveGrid,
                   G: torch.Tensor) -> torch.Tensor:
    """(U, 3) int32 on the tables' device, no host read: per slot the
    backward kernel's fixed-point scales S = HI_u - e of its log rows and
    of its tail rows, and HI_u (csrc/decays_bwd.cu, Scale): 2^e above
    wave_term_bound_log2's bound of the rows' terms, HI_u = 61 -
    ceil(log2 E_u), E_u the slot's evaluations (its tasks x s nodes x P x
    F x Y x 144 nodes x 2 solutions)."""
    U, P, F, NY = tables.logdN.shape
    dev = tables.logdN.device
    lb = wave_term_bound_log2(tables, tasks, wg, G)
    # no nonzero term lies below the dtype's least subnormal, which a term
    # of smaller true value may round up to: the bound stays 4x above it
    tiny = -1072.0 if tables.logdN.dtype == torch.float64 else -147.0
    e = torch.nan_to_num(torch.floor(lb) + 1.0, nan=1100.0, posinf=1100.0,
                         neginf=tiny).clamp(tiny, 1100.0)
    per_task = ((GAUSS_PTS if tasks.nbody == 3 else 1) * P * F * NY
                * GAUSS_PTS * GAUSS_PTS * 2)
    n = torch.zeros(U, dtype=torch.float64, device=dev).index_add_(
        0, tasks.slot.long(), torch.full(tasks.slot.shape, float(per_task),
                                         dtype=torch.float64, device=dev))
    hi = 61.0 - torch.ceil(torch.log2(n.clamp_min(1.0)))
    return torch.cat([hi[:, None] - e, hi[:, None]], 1).to(
        torch.int32).contiguous()


def _bwd_library():
    from ..native.build import cuda_library
    lib = cuda_library("decays_bwd")
    if not getattr(lib, "_is3d_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.is3d_decay_wave_bwd_f32, lib.is3d_decay_wave_bwd_f64):
            fn.restype = ci
            fn.argtypes = [ci, ci,                     # nbody, dimension
                           vp, vp,                     # padded tables, mtg
                           vp, vp, vp, vp, ci,         # pT, phi cells, NB
                           vp, vp,                     # y, quad
                           ci, ci, ci, ci,             # U, P, F, Y
                           vp, vp, vp, ci, ci,         # slot, par, seg, K, NC
                           vp, vp, vp, vp,             # G (float64), scale, acc, emax
                           vp, vp, vp, vp]             # dlog, dtc, dts, stream
        for fn in (lib.is3d_decay_wave_bwd_blocking_f32,
                   lib.is3d_decay_wave_bwd_blocking_f64):
            fn.restype = ci
            fn.argtypes = [ci] * 7 + [ctypes.POINTER(ci)]
        lib.is3d_cuda_error_string.restype = ctypes.c_char_p
        lib.is3d_cuda_error_string.argtypes = [ci]
        lib._is3d_bound = True
    return lib


def wave_bwd_blocking(tables: ParentTables, tasks: WaveTasks,
                      wg: WaveGrid) -> dict:
    """The backward kernel's blocking for one launch on the tables' card,
    as csrc/decays_bwd.cu (blocking, its owner) reports it: pT values a
    block, node-pair chunks, shared memory, most phi buckets and the route
    ("shared": a block's private copy of the slot's words in shared
    memory; "device": every term to the device's words)."""
    U, P, F, NY = tables.logdN.shape
    lib = _bwd_library()
    out = (ctypes.c_int * 5)()
    fn = (lib.is3d_decay_wave_bwd_blocking_f64
          if tables.logdN.dtype == torch.float64
          else lib.is3d_decay_wave_bwd_blocking_f32)
    with torch.cuda.device(tables.logdN.device):
        rc = fn(tasks.nbody, wg.dimension, tasks.slot.shape[0], P, F, NY,
                wg.phi_bucket.shape[0], out)
    if rc != 0:
        raise RuntimeError("decay_wave_bwd: no launch configuration: "
                           f"{lib.is3d_cuda_error_string(rc).decode()}")
    return dict(pt_block=out[0], chunks=out[1], smem=out[2],
                max_buckets=out[3], route="shared" if out[4] else "device")


def _wave_bwd_launch(tables: ParentTables, tasks: WaveTasks, wg: WaveGrid,
                     G: torch.Tensor, emax: torch.Tensor | None = None):
    global TWO_BODY_BWD_LAUNCHES, THREE_BODY_BWD_LAUNCHES
    check_float("wave_bwd_cuda", tables.logdN)
    if tables.logdN.dim() != 4:
        raise ValueError("logdN must be (U, P, F, Y), got "
                         f"{tuple(tables.logdN.shape)}")
    U, P, F, NY = tables.logdN.shape
    like = tables.logdN
    check_tensor("tc", tables.tc, (U, F, NY), like)
    check_tensor("ts", tables.ts, (U, F, NY), like)
    check_tensor("mtg", tables.mtg, (U, P), like)
    check_tensor("pT", wg.pT, (P,), like)
    check_tensor("y", wg.y, (NY,), like)
    check_tensor("quad", wg.quad, (3, GAUSS_PTS), like)
    K = tasks.slot.shape[0]
    check_tensor("slot", tasks.slot, (K,), like, torch.int32)
    check_tensor("par", tasks.par, (K, 6), like)
    check_tensor("G", G, (G.shape[0], P, F, NY), like, torch.float64)
    if tasks.nbody not in (2, 3) or (wg.dimension, NY > 1) not in (
            (2, False), (3, True)):
        raise ValueError(f"wave_bwd_cuda takes 2- or 3-body tasks and a "
                         f"2+1D (Y = 1) or 3+1D (Y > 1) grid, got "
                         f"{tasks.nbody}-body, dimension {wg.dimension}, "
                         f"Y = {NY}")
    require_cuda("wave_bwd_cuda", like)
    if wg.phi_bucket is None:
        raise ValueError("wave_bwd_cuda needs the phi cells of a wave grid "
                         "built on the card (wave_grid on a CUDA device)")
    NB = wg.phi_bucket.shape[0]
    lib = _bwd_library()
    f64 = like.dtype == torch.float64
    n_chunks = wave_bwd_blocking(tables, tasks, wg)["chunks"]
    ptab = padded_tables(tables)
    seg = tasks.seg.to(torch.int32)
    scale = wave_bwd_scale(tables, tasks, wg, G)
    # the slots' fixed-point words: one an entry in float32, two in float64
    acc = torch.zeros((U, 2 if f64 else 1, ptab.shape[1]), dtype=torch.int64,
                      device=like.device)
    d_logdN = torch.empty_like(tables.logdN)
    d_tc = torch.empty_like(tables.tc)
    d_ts = torch.empty_like(tables.ts)
    launch(lib, "decay_wave_bwd",
           lib.is3d_decay_wave_bwd_f64 if f64 else lib.is3d_decay_wave_bwd_f32,
           like.device, tasks.nbody, wg.dimension, ptab.data_ptr(),
           tables.mtg.data_ptr(), wg.pT.data_ptr(), wg.phi_pad.data_ptr(),
           wg.phi_invd.data_ptr(), wg.phi_bucket.data_ptr(), NB,
           wg.y.data_ptr(), wg.quad.data_ptr(), U, P, F, NY,
           tasks.slot.data_ptr(), tasks.par.data_ptr(), seg.data_ptr(), K,
           n_chunks, G.data_ptr(), scale.data_ptr(), acc.data_ptr(),
           None if emax is None else emax.data_ptr(),
           d_logdN.data_ptr(), d_tc.data_ptr(), d_ts.data_ptr())
    if tasks.nbody == 2:
        TWO_BODY_BWD_LAUNCHES += 1
    else:
        THREE_BODY_BWD_LAUNCHES += 1
    return d_logdN, d_tc, d_ts


def wave_bwd_cuda(tables: ParentTables, tasks: WaveTasks, wg: WaveGrid,
                  G: torch.Tensor):
    """Launch csrc/decays_bwd.cu on the current stream: the gradients
    (d_logdN (U, P, F, Y), d_tc, d_ts (U, F, Y)) of <G, the feed-down of
    decay_wave_cuda(tables, tasks, wg)>, G (S, P, F, Y) float64 (the
    cotangent of the spectra accumulator).  One pass: each slot's scale
    from wave_bwd_scale (torch on the card, no host read), every term
    added in fixed point (order-free, so deterministic), in float32 to a
    block's copy of the slot's words in shared memory where it fits
    (wave_bwd_blocking); finish_kernel converts and folds the padded phi
    columns."""
    return _wave_bwd_launch(tables, tasks, wg, G)


def wave_bwd_bits(tables: ParentTables, tasks: WaveTasks, wg: WaveGrid,
                  G: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(bound, exact) (U, 2) int32: per slot and rows (log, tail) the
    binary exponent of the scale's bound wave_bwd_scale takes (2^e above
    every term) and of the largest term the kernel adds (frexp; INT_MIN
    where it adds none), measured in one launch of the kernel: what the
    bound gives up, in bits."""
    emax = torch.full((tables.logdN.shape[0], 2), -2 ** 31,
                      dtype=torch.int32, device=tables.logdN.device)
    _wave_bwd_launch(tables, tasks, wg, G, emax)
    sc = wave_bwd_scale(tables, tasks, wg, G)
    return sc[:, 2:] - sc[:, :2], emax


class _WaveLaunch(torch.autograd.Function):
    """One launch of the wave kernel under autograd: the forward clones the
    float64 accumulator and folds the launch into the clone exactly as
    do_resonance_decays folds it into the accumulator (the same bits); the
    backward passes the accumulator's cotangent through and adds the slots'
    gradients from wave_bwd_cuda."""

    @staticmethod
    def forward(ctx, acc, logdN, tc, ts, mtg, tasks, wg):
        out = acc.clone()
        tables = ParentTables(logdN=logdN, tc=tc, ts=ts, mtg=mtg)
        decay_wave_cuda(tables, tasks, wg, out)
        ctx.save_for_backward(logdN, tc, ts, mtg)
        ctx.tasks, ctx.wg = tasks, wg
        return out

    @staticmethod
    def backward(ctx, G):
        logdN, tc, ts, mtg = ctx.saved_tensors
        tables = ParentTables(logdN=logdN, tc=tc, ts=ts, mtg=mtg)
        d = wave_bwd_cuda(tables, ctx.tasks, ctx.wg, G.contiguous())
        return (G, *d, None, None, None)


class _GatherRows(torch.autograd.Function):
    """acc.index_select(0, rows) whose backward adds the gradients of the
    slots that read one row (one slot per adjusted mass) in slot order and
    writes each row once (index_copy_ of distinct rows), where a CUDA
    index_add_ with repeated rows would add them in the order of its
    atomics."""

    @staticmethod
    def forward(ctx, acc, rows, groups):
        ctx.shape, ctx.groups = acc.shape, groups
        ctx.save_for_backward(rows)
        return acc.index_select(0, rows)

    @staticmethod
    def backward(ctx, g):
        unique, slots = ctx.groups
        rows_g = torch.stack([_ordered_sum(g, s) for s in slots])
        out = g.new_zeros(ctx.shape)
        out.index_copy_(0, unique, rows_g)
        return out, None, None


def _ordered_sum(g, slots):
    acc = g[slots[0]]
    for u in slots[1:]:
        acc = acc + g[u]
    return acc


def _row_groups(rows: list, device) -> tuple:
    """(distinct rows, the slots of each in slot order) of a wave."""
    seen = {}
    for u, r in enumerate(rows):
        seen.setdefault(int(r), []).append(u)
    return (torch.as_tensor(list(seen), dtype=torch.int64, device=device),
            list(seen.values()))


def resonance_feed_down_traced(spectra: torch.Tensor, table, mcids, grid,
                               cfg) -> torch.Tensor:
    """The 2- and 3-body feed-down as a differentiable map: spectra (S, P,
    F, Y) -> decayed spectra (float64), do_resonance_decays' computation
    (its result bit for bit).  Under autograd the cotangent reaches the
    spectra through every wave: on CUDA each launch is a _WaveLaunch (its
    backward the kernel of csrc/decays_bwd.cu), on the CPU torch autograd
    of the plain waves; the slots' tables (prepare_parents) and the rows
    they read (_GatherRows) differentiate in torch."""
    return _feed_down(spectra, table, mcids, grid, cfg)[0]


def _feed_down(spectra: torch.Tensor, table, mcids, grid, cfg):
    """(decayed spectra, the waves) of the cascade: the parents of a wave
    read the spectra as they were before it, every launch folds into a
    float64 accumulator."""
    dev, dtype = spectra.device, spectra.dtype
    dimension = int(cfg.dimension)
    pT64 = grid.pT.to("cpu", torch.float64).numpy()
    phi = grid.phi.to("cpu", dtype)
    if not bool(((phi >= 0.0) & (phi < TWO_PI)).all()):
        raise ValueError("the feed-down takes a phi grid in [0, 2 pi), got "
                         f"[{phi.min().item()}, {phi.max().item()}]")
    waves = plan_waves(_decay_schedule(table, np.asarray(mcids), pT64,
                                       cfg.lightest_particle))
    wg = wave_grid(grid, dimension, dtype, dev)
    staged = stage_waves(waves, pT64, dtype, dev)
    n_y = 1 if dimension == 2 else wg.y.shape[0]
    want = (len(mcids), wg.pT.shape[0], wg.phi.shape[0], n_y)
    if tuple(spectra.shape) != want:
        raise ValueError(f"spectra must be {want}, got {tuple(spectra.shape)}")

    acc = spectra.to(torch.float64).clone()
    for w, st in zip(waves, staged):
        parents = _GatherRows.apply(acc, st.rows,
                                    _row_groups(w.rows, dev)).to(dtype)
        logdN, tc, ts = prepare_parents(parents, st.mtg, st.masses)
        for tasks in st.launches:
            if dev.type == "cuda":
                acc = _WaveLaunch.apply(acc, logdN, tc, ts, st.mtg, tasks,
                                        wg)
            elif dev.type == "cpu":
                tables = ParentTables(logdN=logdN, tc=tc, ts=ts, mtg=st.mtg)
                acc = acc + wave_plain(tables, tasks, wg,
                                       acc.shape[0]).double()
            else:
                raise ValueError(f"no decay path for device {dev}")
    return acc, waves


# ======================================================================
# the cascade
# ======================================================================

@dataclass(frozen=True)
class StagedWave:
    """A wave's device inputs, made before the cascade's first launch."""
    rows: torch.Tensor      # (U,) int64
    masses: torch.Tensor    # (U,) float64
    mtg: torch.Tensor       # (U, P) the wave's dtype
    launches: tuple         # WaveTasks of its 2-body, then 3-body tasks


def stage_waves(waves: list, pT64: np.ndarray, dtype, device) -> list:
    """Every wave's device inputs (all host-to-device copies of the
    cascade)."""
    staged = []
    for w in waves:
        M = np.asarray(w.masses, np.float64)
        mtg = np.sqrt(pT64[None, :] ** 2 + M[:, None] ** 2)
        staged.append(StagedWave(
            rows=torch.as_tensor(np.asarray(w.rows, np.int64), device=device),
            masses=torch.as_tensor(M, device=device),
            mtg=torch.as_tensor(mtg, dtype=dtype, device=device),
            launches=tuple(wave_tasks(nb, t, dtype, device)
                           for nb, t in ((2, w.tasks2), (3, w.tasks3)) if t)))
    return staged


def do_resonance_decays(spectra: torch.Tensor, table, mcids, grid,
                        cfg) -> torch.Tensor:
    """Apply the 2- and 3-body feed-down cascade to smooth spectra.

    spectra: (S, P, F, Y) on the run's device, in chosen-particle (mcids)
    order; the waves run in its dtype.  Returns the decayed spectra,
    float64, on the same device: dispatched and not waited for on CUDA
    (reading the result back waits).  The result is the reference's
    heaviest -> lightest cascade (do_resonance_decays, :143-203), its
    parents grouped into waves: resonance_feed_down_traced without
    autograd."""
    with torch.no_grad():
        acc, waves = _feed_down(spectra, table, mcids, grid, cfg)
    n_channels = sum(len(w.tasks2) + len(w.tasks3) for w in waves)
    print(f"Resonance decays: {n_channels} channel-contributions added"
          f" in {len(waves)} waves")
    return acc
