"""The port's counter-based random numbers: Philox-4x32-10 in plain torch.

The sampler and the decay cascade draw every uniform from Philox keyed on
explicit counters, never from a generator with state: the seed is a
parameter, and a draw is a pure function of (key, counter).  The same
function is written twice, here over int64 tensors holding 32-bit words and
in ``csrc/philox.cuh`` for the kernels, so that a kernel and its plain
version draw the same numbers and can be compared slot by slot.

Torch has no unsigned 32-bit multiply-high, and a product of two 32-bit
values overflows a signed int64, so ``_mulhilo`` splits the round
constant into 16-bit limbs: each partial product stays below 2^48.

Counters (c0, c1, c2, c3), 32-bit words each:

* sampler, one event slot: (slot, global event, round * 16 + block,
  SAMPLE_TAG); rounds 0..255 are the rejection rounds, round 256
  (SLOT_ROUND) the slot's own draws (cell group, cell in block, species,
  keep, rapidity); ``block`` counts the Philox blocks of one draw;
* cascade, one hadron of lineage (L0, L1): draws (L0, L1, block,
  DRAW_TAG); child j's lineage = the first two words of (L0, L1, j,
  CHILD_TAG); a root hadron's lineage = those of (global event, in-event
  ordinal, 0, ROOT_TAG).

The key is the seed's two 32-bit halves.  The JAX package draws from
Threefry keys instead, so the port's event lists equal JAX's in
distribution only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
PHILOX_ROUNDS = 10

SAMPLE_TAG = 0x53414D50   # "SAMP"
DRAW_TAG = 0x44524157     # "DRAW"
CHILD_TAG = 0x4348494C    # "CHIL"
ROOT_TAG = 0x524F4F54     # "ROOT"
SLOT_ROUND = 256          # the round index of a slot's own draws
N_DRAWS = 5               # uniforms of one slot draw and of one round
N_DECAY_DRAWS = 7         # uniforms of one decay


def seed_key(seed: int) -> tuple[int, int]:
    """The Philox key of a seed: its low and high 32-bit halves."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed must be in [0, 2^64), got {seed}")
    return seed & MASK32, (seed >> 32) & MASK32


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of a * m for int64 ``a`` in [0, 2^32) and a
    32-bit constant ``m``, in 16-bit limbs of m."""
    p_lo = a * (m & 0xFFFF)                  # < 2^48
    p_hi = a * (m >> 16)                     # < 2^48
    s = ((p_hi & 0xFFFF) << 16) + p_lo       # < 2^49
    return (p_hi >> 16) + (s >> 32), s & MASK32


def philox4x32(c0, c1, c2, c3, key: tuple[int, int]):
    """Philox-4x32-10 of the counters (int64 tensors or ints, broadcast,
    each in [0, 2^32)) under ``key``; four int64 tensors of 32-bit
    words."""
    like = next((c for c in (c0, c1, c2, c3) if isinstance(c, torch.Tensor)),
                None)
    cast = (lambda c: torch.as_tensor(c, dtype=torch.int64,
                                      device=like.device)
            if like is not None else torch.tensor(c, dtype=torch.int64))
    c0, c1, c2, c3 = (cast(c) for c in (c0, c1, c2, c3))
    k0, k1 = key
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W[0]) & MASK32
            k1 = (k1 + PHILOX_W[1]) & MASK32
        hi0, lo0 = _mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _unit(words: list, dtype: torch.dtype, open0: bool) -> list:
    """Uniforms on [0, 1) from 32-bit words: 24 bits a float32 (one word),
    53 bits a float64 (two words); with ``open0`` on [tiny, 1), for a
    log."""
    if dtype == torch.float32:
        out = [(w >> 8).to(torch.float32) * 2.0 ** -24 for w in words]
    else:
        out = [((a >> 5) * 67108864 + (b >> 6)).to(torch.float64)
               * 2.0 ** -53 for a, b in zip(words[0::2], words[1::2])]
    if open0:
        tiny = torch.finfo(dtype).tiny
        out = [torch.clamp(u, min=tiny) for u in out]
    return out


def uniforms(key, c0, c1, c2_base: int, c3: int, n: int,
             dtype: torch.dtype, open0: bool = False) -> list:
    """``n`` uniforms of one draw: Philox blocks (c0, c1, c2_base + b, c3)
    for b = 0, 1, ..., four uniforms a block in float32, two in float64,
    in order."""
    per = 4 if dtype == torch.float32 else 2
    words = []
    for b in range(math.ceil(n / per)):
        words.extend(philox4x32(c0, c1, c2_base + b, c3, key))
    return _unit(words, dtype, open0)[:n]


def slot_uniforms(key, slots, events, dtype, round_: int = SLOT_ROUND,
                  open0: bool = False) -> torch.Tensor:
    """(N_DRAWS, ...) uniforms of event slots (``slots`` and ``events``
    broadcast): their own draws, or those of rejection round ``round_``
    (on [tiny, 1) with ``open0``)."""
    return torch.stack(uniforms(key, slots, events, round_ * 16, SAMPLE_TAG,
                                N_DRAWS, dtype, open0))


def decay_uniforms(key, lineage: torch.Tensor, dtype) -> torch.Tensor:
    """(N_DECAY_DRAWS, n) uniforms of the decays of hadrons of ``lineage``
    (n, 2) int64 words."""
    return torch.stack(uniforms(key, lineage[:, 0], lineage[:, 1], 0,
                                DRAW_TAG, N_DECAY_DRAWS, dtype))


def child_lineage(key, lineage: torch.Tensor, j: int) -> torch.Tensor:
    """(n, 2) lineage words of the j-th daughter (j = 1, 2, 3)."""
    w = philox4x32(lineage[:, 0], lineage[:, 1], j, CHILD_TAG, key)
    return torch.stack(w[:2], dim=1)


def root_lineage(key, events: torch.Tensor, ordinals: torch.Tensor
                 ) -> torch.Tensor:
    """(n, 2) lineage words of sampled hadrons: (global event, in-event
    ordinal) hashed, so that a hadron's stream does not depend on its
    position in a batch."""
    w = philox4x32(events, ordinals, 0, ROOT_TAG, key)
    return torch.stack(w[:2], dim=1)


def poisson_counts(seed: int, events, lam: float) -> np.ndarray:
    """The hadron count of each event, Poisson(lam), drawn exactly on the
    host from numpy's Philox keyed on (seed, global event): one scalar an
    event, shared by the kernel and the plain version."""
    out = np.empty(len(events), dtype=np.int64)
    for i, e in enumerate(events):
        g = np.random.Generator(np.random.Philox(
            key=int(seed) | (int(e) << 64)))
        out[i] = g.poisson(lam)
    return out
