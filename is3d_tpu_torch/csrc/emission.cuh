// Per-point Cooper-Frye emission with linear delta-f, shared by the
// spectra kernel (smooth_spectra.cu) and the dN/dX kernel (dndx.cu), so
// both evaluate p.dsigma * f_eq * (1 + df) from one source.
//
// Per (cell, rapidity node) the kinematics enter through cosh/sinh of
// Delta = y - eta, so every per-point quantity is a short fma chain:
//
//     p.dsigma   = mT A1(c,r) + W1(c,m)
//     u.p        = mT B1(c,r) - W2(c,m)
//     pi:pp      = mT^2 C1 + mT px C2 + mT py C3 + C4(c,m)
//     V.p        = mT D1(c,r) - D2(c,m)
//
// Cell fields come from a shared-memory tile of packed rows (field f of
// tile cell c at raw[f * ld + c]), in the order of `Field`, which must
// match FIELDS in is3d_tpu_torch/kernels/smooth.py.  No fast math:
// exp(u.p/T) overflows at large mT cosh(Delta), and 1/(inf + s) must stay
// exactly 0.

#pragma once

#include <cuda_runtime.h>

namespace is3d {

// must match FIELDS in is3d_tpu_torch/kernels/smooth.py
enum Field {
  F_TAU, F_DAT, F_DAX, F_DAY, F_DANT, F_UT, F_UX, F_UY, F_TUN,
  F_INVT, F_ALPHAB, F_PITT, F_PITX, F_PITY, F_PITN, F_PIXX, F_PIXY,
  F_PIXN, F_PIYY, F_PIYN, F_PINN, F_VT, F_VX, F_VY, F_VN, F_BENTH,
  F_BULKPI, F_ETA, F_YFLOW, F_KSC, F_KB0, F_KB1, F_KB2, F_KDV,
  F_KC3, F_KC4, NF
};

constexpr int NCOMP = 6;           // A1, B1, C1, C2, C3, D1

__device__ __forceinline__ float d_exp(float x) { return expf(x); }
__device__ __forceinline__ double d_exp(double x) { return exp(x); }
__device__ __forceinline__ float d_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double d_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float d_cosh(float x) { return coshf(x); }
__device__ __forceinline__ double d_cosh(double x) { return cosh(x); }
__device__ __forceinline__ float d_sinh(float x) { return sinhf(x); }
__device__ __forceinline__ double d_sinh(double x) { return sinh(x); }

template <typename T>
struct Point {            // per-thread momentum point
  T mT, mT2, mTpx, mTpy, px, py, px2, py2, pxpy, m2, sgn, bar, srem;
};

template <typename T>
struct Comp {             // per (cell, node)
  T A1, B1, C1, C2, C3, D1;
};

template <typename T>
struct CellPoint {        // per (cell, point), node-independent
  T W1, W2, C4, D2, invT, alphaB, bulkPi, benth;
  T ksc, kb0, kb1, kb2, kdv, kc3, kc4;
};

// the monomials of one momentum point at fixed rapidity nodes (species
// mass ms, pT pt, pT cos phi px, pT sin phi py): no remap, srem = 1
template <typename T>
__device__ __forceinline__ Point<T> make_point(T ms, T pt, T px, T py, T sgn,
                                               T bar) {
  Point<T> p;
  p.m2 = ms * ms;
  p.mT = d_sqrt(p.m2 + pt * pt);
  p.px = px;
  p.py = py;
  p.mT2 = p.mT * p.mT;
  p.mTpx = p.mT * p.px;
  p.mTpy = p.mT * p.py;
  p.px2 = p.px * p.px;
  p.py2 = p.py * p.py;
  p.pxpy = p.px * p.py;
  p.sgn = sgn;
  p.bar = bar;
  p.srem = T(1);
  return p;
}

// field f of tile cell c lives at raw[f * ld + c]
template <typename T>
__device__ __forceinline__ Comp<T> composites(const T* raw, int ld, int c,
                                              T ch, T sh) {
  const T t_sh = sh * raw[F_TAU * ld + c];
  Comp<T> k;
  k.A1 = ch * raw[F_DAT * ld + c] + sh * raw[F_DANT * ld + c];
  k.B1 = ch * raw[F_UT * ld + c] - sh * raw[F_TUN * ld + c];
  k.C1 = ch * ch * raw[F_PITT * ld + c] + t_sh * t_sh * raw[F_PINN * ld + c]
         - T(2) * ch * t_sh * raw[F_PITN * ld + c];
  k.C2 = T(-2) * (ch * raw[F_PITX * ld + c] - t_sh * raw[F_PIXN * ld + c]);
  k.C3 = T(-2) * (ch * raw[F_PITY * ld + c] - t_sh * raw[F_PIYN * ld + c]);
  k.D1 = ch * raw[F_VT * ld + c] - t_sh * raw[F_VN * ld + c];
  return k;
}

template <typename T>
__device__ __forceinline__ CellPoint<T> cell_point(const T* raw, int ld,
                                                   int c, const Point<T>& p) {
  CellPoint<T> q;
  q.W1 = raw[F_DAX * ld + c] * p.px + raw[F_DAY * ld + c] * p.py;
  q.W2 = raw[F_UX * ld + c] * p.px + raw[F_UY * ld + c] * p.py;
  q.C4 = raw[F_PIXX * ld + c] * p.px2 + raw[F_PIYY * ld + c] * p.py2
         + T(2) * raw[F_PIXY * ld + c] * p.pxpy;
  q.D2 = raw[F_VX * ld + c] * p.px + raw[F_VY * ld + c] * p.py;
  q.invT = raw[F_INVT * ld + c];
  q.alphaB = raw[F_ALPHAB * ld + c];
  q.bulkPi = raw[F_BULKPI * ld + c];
  q.benth = raw[F_BENTH * ld + c];
  q.ksc = raw[F_KSC * ld + c];
  q.kb0 = raw[F_KB0 * ld + c];
  q.kb1 = raw[F_KB1 * ld + c];
  q.kb2 = raw[F_KB2 * ld + c];
  q.kdv = raw[F_KDV * ld + c];
  q.kc3 = raw[F_KC3 * ld + c];
  q.kc4 = raw[F_KC4 * ld + c];
  return q;
}

// p.dsigma * f_eq * (1 + df) at one (cell, node, point)
template <typename T, int DF>
__device__ __forceinline__ T emission(const Point<T>& p, const CellPoint<T>& q,
                                      const Comp<T>& k, int regulate,
                                      int outflow) {
  const T pds = p.mT * k.A1 + q.W1;
  const T pdotu = p.mT * k.B1 - q.W2;
  const T pipp = p.mT2 * k.C1 + p.mTpx * k.C2 + p.mTpy * k.C3 + q.C4;
  const T Vp = p.mT * k.D1 - q.D2;
  const T feq = T(1) / (d_exp(pdotu * q.invT - p.bar * q.alphaB) + p.sgn);
  const T feqbar = T(1) - p.sgn * feq;
  T df;
  if (DF == 1) {
    df = q.ksc * pipp
         + (q.kb0 * p.m2 + (q.kb1 * p.bar + q.kb2 * pdotu) * pdotu) * q.bulkPi
         + (q.kc3 * p.bar + q.kc4 * pdotu) * Vp;
  } else {
    const T r = T(1) / pdotu;
    df = q.ksc * pipp * r
         + (q.kb0 * pdotu + q.kb1 * p.bar + q.kb2 * (pdotu - p.m2 * r))
           * q.bulkPi
         + (q.benth - p.bar * r) * Vp * q.kdv;
  }
  df = feqbar * df;
  if (regulate) df = df < T(-1) ? T(-1) : (df > T(1) ? T(1) : df);
  const T f = feq * df + feq;
  return (outflow ? (pds > T(0) ? pds : T(0)) : pds) * f;
}

}  // namespace is3d
