// What the backward kernels (feqmod_bwd.cu, vah_bwd.cu,
// smooth_spectra_bwd.cu, polzn_bwd.cu) share: the asynchronous copy of the
// cotangent's tiles into shared memory, the stages' alignment and vector
// loads, and the map from the cell columns a body touches to its
// accumulator slots.
//
//   * cp.async (sm_80 and later) copies one element (or 16 bytes) of
//     global memory into shared memory without passing through registers; a thread commits
//     its copies as a group and waits for them before the block's barrier,
//     so the next tile is in flight while the current one is consumed.
//   * Cols<A0, A1, B0, B1>: a body touches the columns [A0, A1) and [B0,
//     B1) of a cell row; slot(k) numbers them 0.. N-1 (-1 for a column it
//     never touches, whose gradient is exactly 0).  slot() is constexpr,
//     so an accumulator array indexed by slot(K) of a literal K stays in
//     registers.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace is3d {

// one element (4 or 8 bytes) of global memory into shared memory
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(s), "l"(src) : "memory");
}

// 16 bytes of global memory into shared memory, both 16-byte aligned,
// cached in L2 only
template <typename T>
__device__ __forceinline__ void cp_async16(T* dst, const T* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every copy this thread committed has landed (visible to the block after
// the next barrier)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the bytes b rounded up to a whole number of 16-byte vectors
__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) / 16 * 16;
}

// U values of T from shared memory, a pair a vector load where U is even
template <typename T, int U>
__device__ __forceinline__ void ld_u(const T* p, T* v) {
  using T2 = typename std::conditional<sizeof(T) == 4, float2, double2>::type;
#pragma unroll
  for (int u = 0; u < U; u += 1 + (U % 2 == 0)) {
    if constexpr (U % 2 == 0) {
      const T2 a = *reinterpret_cast<const T2*>(p + u);
      v[u] = a.x;
      v[u + 1] = a.y;
    } else {
      v[u] = p[u];
    }
  }
}

// a momentum point: px, py (one 8-byte load in float32), and with their
// squares (16 bytes; px py in a table beside it)
template <typename T>
struct alignas(2 * sizeof(T)) Pt2 {
  T x, y;
};
template <typename T>
struct alignas(16) Pt4 {
  T x, y, xx, yy;
};

// the (n_pT, n_phi) points of a block, staged once: px, py from their
// tables (xt, yt), or with the remap pT cos phi and pT sin phi from the
// angles' (xt, yt = cos, sin phi); the squares and px py where the table
// holds Pt4 (txy then not null)
template <typename T, class PT>
__device__ __forceinline__ void stage_points(PT* tab, T* txy, const T* xt,
                                             const T* yt, const T* pT, int P,
                                             int F, bool remap, int tid,
                                             int nt) {
  for (int i = tid; i < P * F; i += nt) {
    const int p = i / F, f = i - p * F;
    const T x = remap ? pT[p] * xt[f] : xt[i];
    const T y = remap ? pT[p] * yt[f] : yt[i];
    if constexpr (sizeof(PT) == 4 * sizeof(T)) {
      tab[i] = PT{x, y, x * x, y * y};
      txy[i] = x * y;
    } else {
      tab[i] = PT{x, y};
    }
  }
}

template <int A0, int A1, int B0 = 0, int B1 = 0>
struct Cols {
  static constexpr int N = (A1 - A0) + (B1 - B0);
  static constexpr __host__ __device__ int slot(int k) {
    return (k >= A0 && k < A1) ? k - A0
           : (k >= B0 && k < B1) ? (A1 - A0) + k - B0 : -1;
  }
};

// r[slot(K)] += v for a column K the body touches
template <class C, int K, typename T>
__device__ __forceinline__ void radd(T* r, T v) {
  static_assert(C::slot(K) >= 0, "a column outside the body's slots");
  r[C::slot(K)] += v;
}

}  // namespace is3d
