// Integer prefix sums across a kernel's tiles, for the sampler's packed
// mode (sample.cu, K7) and the decay cascade (mc_decays.cu, K8).
//
// A tile's offset is the sum of the counts of the tiles before it, taken
// by a single-pass decoupled look-back: each tile publishes its own count
// as soon as it has it, and its inclusive prefix once it knows it, in one
// 64-bit state word a tile (zeroed before the launch).  A tile waits only
// on tiles with smaller numbers, so the tiles must be numbered in the
// order blocks start (an atomic counter): every earlier tile is then
// running or done.  Integer-only, so the offsets do not depend on the
// blocks' timing.
#pragma once

#include <cstdint>

namespace is3d_scan {

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// inclusive sum over the warp
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int o = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

// the counts of the tiles before ``tile``: single-pass decoupled look-back
// over the state words (bits 62-63: 1 = the tile's own count is published,
// 2 = its inclusive prefix; bits 0-31 the count), run by one thread
__device__ unsigned long long look_back(unsigned long long* states, int tile,
                                        unsigned long long agg) {
  constexpr unsigned long long kAgg = 1ull << 62, kPre = 2ull << 62;
  if (tile == 0) {
    atomicExch(&states[0], kPre | agg);
    return 0;
  }
  atomicExch(&states[tile], kAgg | agg);
  unsigned long long excl = 0;
  for (int j = tile - 1; j >= 0;) {
    const unsigned long long v =
        *reinterpret_cast<volatile unsigned long long*>(&states[j]);
    const unsigned long long flag = v >> 62;
    if (flag == 0) continue;             // tile j still running
    excl += v & 0xffffffffull;
    if (flag == 2) break;
    --j;
  }
  atomicExch(&states[tile], kPre | (excl + agg));
  return excl;
}

// the same prefix, looked back by a whole warp: lane l reads the word of
// tile j - l, so a window of 32 earlier tiles costs one round trip (the
// words before tile 0 read as a prefix of 0); every lane returns the count
// before ``tile``
__device__ unsigned long long look_back_warp(unsigned long long* states,
                                             int tile, unsigned long long agg,
                                             int lane) {
  constexpr unsigned long long kAgg = 1ull << 62, kPre = 2ull << 62;
  if (lane == 0) atomicExch(&states[tile], (tile ? kAgg : kPre) | agg);
  unsigned long long excl = 0;
  for (int j = tile - 1; j >= 0; j -= 32) {
    const int k = j - lane;
    unsigned long long v = kPre;
    unsigned flag;
    do {                                  // until no tile of the window runs
      if (k >= 0)
        v = *reinterpret_cast<volatile unsigned long long*>(&states[k]);
      flag = static_cast<unsigned>(v >> 62);
    } while (__any_sync(0xffffffffu, flag == 0));
    const unsigned pre = __ballot_sync(0xffffffffu, flag == 2);
    const int last = pre ? __ffs(pre) - 1 : 31;    // the nearest prefix
    unsigned long long c = lane <= last ? (v & 0xffffffffull) : 0;
#pragma unroll
    for (int d = 16; d; d >>= 1) c += __shfl_xor_sync(0xffffffffu, c, d);
    excl += c;
    if (pre) break;
  }
  if (lane == 0 && tile) atomicExch(&states[tile], kPre | (excl + agg));
  return excl;
}

}  // namespace is3d_scan
