// The folded form of the emission function, shared by the register-blocked
// kernels (smooth_spectra.cu, dndx.cu, smooth_proto.cu): per-cell constants
// are multiplied into the staged values once per cell, so the evaluation
// at one (cell, node, species, point) is a short fma chain around one exp
// and one (df 1) or two (df 2) reciprocals.
//
//   * Fn<T>: the type-dependent parts.  float32 takes ex2.approx on an
//     argument pre-scaled by log2(e) and rcp.approx (no IEEE division
//     sequence, no blanket fast math); both give +inf -> 0, so exp(u.p/T)
//     may overflow to +inf and 1/(inf + s) is exactly 0.  float64 keeps the
//     IEEE exp and division.
//   * stage_scalars / stage_composites: the NS folded scalars of a cell
//     and the NK composites of a (cell, node) from a packed row in the
//     order of emission.cuh's `Field`.
//   * folded_f: f_eq (1 + clip(feqbar df)) from the four per-point chains.

#pragma once

#include <cuda_runtime.h>

#include "emission.cuh"

namespace is3d {

constexpr int NS = 16;             // staged scalars per cell
constexpr int NK = 8;              // staged composites per (cell, node)

// staged per-cell scalars (slot meaning by df mode where they differ)
enum Scalar {
  S_DAX, S_DAY, S_NUX, S_NUY,      // dsigma_x, dsigma_y, -u^x, -u^y
  S_PXX, S_PYY, S_PXY, S_INVT,     // ksc pi^xx, ksc pi^yy, 2 ksc pi^xy, L/T
  S_NVX, S_NVY, S_ALPHA, S_KP,     // -kv V^x, -kv V^y, L alphaB, see below
  S_KB1, S_KM2, S_KV, S_KC3
};
// df 2: KP = (kb0 + kb2) Pi, KB1 = kb1 Pi, KM2 = -kb2 Pi, KV = benth,
//       kv = kdv, so df = r (pi:pp' + KM2 m2 - b V.p') + KP u.p + KB1 b
//       + KV V.p' with r = 1/u.p and the primes marking folded factors
// df 1: KP = kb2 Pi, KB1 = kb1 Pi, KM2 = kb0 Pi, KV = kc4, KC3 = kc3,
//       kv = 1, so df = pi:pp' + KM2 m2 + (KB1 b + KP u.p) u.p
//       + (KC3 b + KV u.p) V.p
// (L = log2 e in float32, 1 in float64; b the species' baryon number)

// --------------------------------------------------- type-dependent parts

template <typename T>
struct Fn;

template <>
struct Fn<float> {
  static constexpr float SCALE = 1.4426950408889634f;   // exp(x) = 2^(x L)
  static __device__ __forceinline__ float exp_scaled(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
  }
  static __device__ __forceinline__ float rcp(float x) {
    float y;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
  }
  static __device__ __forceinline__ float inf() {
    return __int_as_float(0x7f800000);
  }
  static __device__ __forceinline__ void ld4(const float* p, float& a,
                                             float& b, float& c, float& d) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    a = v.x; b = v.y; c = v.z; d = v.w;
  }
};

template <>
struct Fn<double> {
  static constexpr double SCALE = 1.0;                  // IEEE exp
  static __device__ __forceinline__ double exp_scaled(double x) {
    return exp(x);
  }
  static __device__ __forceinline__ double rcp(double x) { return 1.0 / x; }
  static __device__ __forceinline__ double inf() {
    return __longlong_as_double(0x7ff0000000000000LL);
  }
  static __device__ __forceinline__ void ld4(const double* p, double& a,
                                             double& b, double& c,
                                             double& d) {
    const double2 u = *reinterpret_cast<const double2*>(p);
    const double2 v = *reinterpret_cast<const double2*>(p + 2);
    a = u.x; b = u.y; c = v.x; d = v.y;
  }
};

// ------------------------------------------------------------- staging

// the NS scalars of one cell from its packed row g (NF fields)
template <typename T, int DF>
__device__ __forceinline__ void stage_scalars(const T* g, T* o) {
  const T L = Fn<T>::SCALE;
  const T ksc = g[F_KSC];
  const T bp = g[F_BULKPI];
  const T kv = DF == 2 ? g[F_KDV] : T(1);
  o[S_DAX] = g[F_DAX];
  o[S_DAY] = g[F_DAY];
  o[S_NUX] = -g[F_UX];
  o[S_NUY] = -g[F_UY];
  o[S_PXX] = ksc * g[F_PIXX];
  o[S_PYY] = ksc * g[F_PIYY];
  o[S_PXY] = T(2) * ksc * g[F_PIXY];
  o[S_INVT] = L * g[F_INVT];
  o[S_NVX] = -kv * g[F_VX];
  o[S_NVY] = -kv * g[F_VY];
  o[S_ALPHA] = L * g[F_ALPHAB];
  o[S_KB1] = g[F_KB1] * bp;
  if (DF == 2) {
    o[S_KP] = (g[F_KB0] + g[F_KB2]) * bp;
    o[S_KM2] = -g[F_KB2] * bp;
    o[S_KV] = g[F_BENTH];
    o[S_KC3] = T(0);
  } else {
    o[S_KP] = g[F_KB2] * bp;
    o[S_KM2] = g[F_KB0] * bp;
    o[S_KV] = g[F_KC4];
    o[S_KC3] = g[F_KC3];
  }
}

// the NK composites of one (cell, node): A1, B1, ksc C1-C3, kv D1, the
// node weight w, 0
template <typename T, int DF>
__device__ __forceinline__ void stage_composites(const T* g, T delta, T w,
                                                 T* o) {
  const Comp<T> k = composites(g, 1, 0, d_cosh(delta), d_sinh(delta));
  const T ksc = g[F_KSC];
  o[0] = k.A1;
  o[1] = k.B1;
  o[2] = ksc * k.C1;
  o[3] = ksc * k.C2;
  o[4] = ksc * k.C3;
  o[5] = (DF == 2 ? g[F_KDV] : T(1)) * k.D1;
  o[6] = w;
  o[7] = T(0);
}

// ----------------------------------------------------------- evaluation

// f_eq (1 + clip(feqbar df, dlo, dhi)) at one (cell, node, species, point)
// from u.p (pdu), the folded pi:pp' (with KM2 m2 added) and V.p' chains.
// invT and nbal = -L alphaB b carry the exp's scale; b1 = KB1 b, c3b =
// KC3 b (df 1 only); kp, kv the staged S_KP, S_KV.
template <typename T, int DF>
__device__ __forceinline__ T folded_f(T pdu, T pipp, T Vp, T invT, T nbal,
                                      T sgn, T bar, T kp, T b1, T kv, T c3b,
                                      T dlo, T dhi) {
  using F = Fn<T>;
  const T feq = F::rcp(F::exp_scaled(fma(pdu, invT, nbal)) + sgn);
  T df;
  if (DF == 1) {
    df = fma(fma(kp, pdu, b1), pdu, pipp);
    df = fma(fma(kv, pdu, c3b), Vp, df);
  } else {
    const T r = F::rcp(pdu);
    df = fma(r, fma(-bar, Vp, pipp), fma(kv, Vp, fma(kp, pdu, b1)));
  }
  df = fma(-sgn, feq, T(1)) * df;
  df = fmin(fmax(df, dlo), dhi);
  return fma(feq, df, feq);
}

}  // namespace is3d
