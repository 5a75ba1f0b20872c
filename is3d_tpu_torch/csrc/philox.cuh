// Philox-4x32-10, the port's counter-based generator, for the sampler
// (sample.cu) and the decay cascade (mc_decays.cu).
//
// The same function as is3d_tpu_torch/kernels/rng.py (plain torch, in
// 16-bit limbs): a kernel and its plain version draw the same numbers,
// so they can be compared slot by slot.  The counters, tags and uniform
// conversions here must stay those of rng.py:
//   * a draw of N uniforms takes Philox blocks (c0, c1, c2_base + b, c3),
//     b = 0, 1, ...: four uniforms a block in float (24 bits a word), two
//     in double (53 bits from two words);
//   * ``open0`` moves 0 to the type's smallest normal (the draws of a
//     rejection round take a log).
#pragma once

#include <cfloat>
#include <cstdint>

namespace is3d_rng {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
constexpr uint32_t kSampleTag = 0x53414D50u;  // "SAMP"
constexpr uint32_t kDrawTag = 0x44524157u;    // "DRAW"
constexpr uint32_t kChildTag = 0x4348494Cu;   // "CHIL"
constexpr int kSlotRound = 256;               // a slot's own draws

struct Words {
  uint32_t w[4];
};

__device__ __forceinline__ Words philox(uint32_t c0, uint32_t c1, uint32_t c2,
                                        uint32_t c3, uint32_t k0,
                                        uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return Words{{c0, c1, c2, c3}};
}

template <typename T>
struct Unit;

template <>
struct Unit<float> {
  static constexpr int kPerBlock = 4;
  __device__ static float at(const Words& b, int k, bool open0) {
    const float u = static_cast<float>(b.w[k] >> 8) * 0x1p-24f;
    return open0 ? fmaxf(u, FLT_MIN) : u;
  }
};

template <>
struct Unit<double> {
  static constexpr int kPerBlock = 2;
  __device__ static double at(const Words& b, int k, bool open0) {
    const uint64_t a = b.w[2 * k] >> 5, c = b.w[2 * k + 1] >> 6;
    const double u = static_cast<double>(a * 67108864ull + c) * 0x1p-53;
    return open0 ? fmax(u, DBL_MIN) : u;
  }
};

// N uniforms of one draw, in order
template <typename T, int N>
__device__ __forceinline__ void uniforms(T (&u)[N], uint32_t c0, uint32_t c1,
                                         uint32_t c2_base, uint32_t c3,
                                         uint32_t k0, uint32_t k1,
                                         bool open0) {
  constexpr int P = Unit<T>::kPerBlock;
#pragma unroll
  for (int b = 0; b < (N + P - 1) / P; ++b) {
    const Words w = philox(c0, c1, c2_base + b, c3, k0, k1);
#pragma unroll
    for (int k = 0; k < P; ++k)
      if (b * P + k < N) u[b * P + k] = Unit<T>::at(w, k, open0);
  }
}

}  // namespace is3d_rng
