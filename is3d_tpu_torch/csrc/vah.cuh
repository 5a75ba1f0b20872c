// The anisotropic-hydro (VAH) emission value, shared by the VAH spectra
// kernels (vah.cu) and the dN/dX kernel's VAH producer (dndx.cu): the
// packed per-cell fields, the per-(cell, node) composites at fixed nodes
// and the value f at one evaluation.
//
// Per (cell, node, species, point):
//
//     p.dsigma = mT A1(c,r) + W1(c,m)
//     u.p      = mT B1(c,r) - W2(c,m)
//     z.p      = mT Z1(c,r)              (z has no transverse components)
//     E_a      = sqrt((u.p)^2 + xi_L (z.p)^2)
//     f_a      = 1 / (exp(E_a / Lambda) + sign)
//
// and, with the residual chains (compile-time switches of the kernels),
//
//     df = c3 (z.p)(W.p) + c4 pi_perp:pp                      (shear)
//        + Pi c0 m^2 + Pi c1 (z.p)^2 + Pi c2 (u.p)^2           (bulk)
//     f  = f_a (1 + clip(fabar df, -1, 1))  (unclipped without regulate)
//
// c4 is folded into pi_perp (the k* fields) and Pi into c0..c2 (bc*) by
// is3d_tpu_torch/kernels/vah.py:pack_vah_cells.  E_a^2 is JAX's form: for
// a_L > 1 (xi_L < 0) its two terms cancel partly, but only where z.p is
// large and f_a exponentially small, so float32 keeps the outputs within
// 1e-6 of the largest for a_L up to 4.4 (PL/P = 2.5; PERF.md).
// Exact zeros stay exact: exp overflow gives f_a = 1 / (inf + sign) = 0,
// and an outflow point with p.dsigma <= 0 or a pad cell (dsigma = 0)
// gives 0 x f = 0.

#pragma once

#include <cuda_runtime.h>

#include "feqmod.cuh"   // fq_sqrt; folded.cuh's Fn<T>, emission.cuh's d_*

namespace is3d {

// must match VF_FIELDS in is3d_tpu_torch/kernels/vah.py
enum VahField {
  V_TAU, V_ETA, V_DAT, V_DANT, V_DAX, V_DAY, V_UT, V_TUN, V_ZT, V_TZN,
  V_UX, V_UY, V_XIL, V_INVLAM, V_AL, V_LAM, V_YFLOW,
  V_C3, V_WT, V_TWN, V_WX, V_WY, V_KPITT, V_KPINN, V_KPITN, V_KPITX,
  V_KPIXN, V_KPITY, V_KPIYN, V_KPIXX, V_KPIYY, V_KPIXY,
  V_BC0, V_BC1, V_BC2, NV
};

// the residual chains (kernels/vah.py VahFlags.switches)
constexpr int VSW_SHEAR = 1, VSW_BULK = 2;
// values staged per (cell, fixed node): A1, B1, Z1, xi_L Z1^2, then the
// shear's C1, C2, C3 (pi:pp = mT^2 C1 + mT (px C2 + py C3) + C4) and E1
// (W.p = mT E1 - WW), and the node weight
constexpr int NKV = 9;

// per-cell coefficients of f; invLamL = L / Lambda (L = log2 e in
// float32, folded into the exponent)
template <typename T>
struct VahCoef {
  T invLamL, c3, bc0, bc1, bc2;
};

template <typename T>
__device__ __forceinline__ VahCoef<T> vah_coef(const T* g) {
  return VahCoef<T>{Fn<T>::SCALE * g[V_INVLAM], g[V_C3], g[V_BC0],
                    g[V_BC1], g[V_BC2]};
}

// f at one evaluation from u.p, xi_L (z.p)^2 and, with the chains, z.p,
// pi:pp (c4 folded) and W.p
template <typename T, int SW>
__device__ __forceinline__ T vah_f(T pdu, T xz, T zp, T pipp, T Wp, T m2,
                                   T sgn, const VahCoef<T>& k,
                                   int regulate) {
  using F = Fn<T>;
  const T E = fq_sqrt(fma(pdu, pdu, xz));
  const T fa = F::rcp(F::exp_scaled(E * k.invLamL) + sgn);
  if (SW == 0) return fa;
  T d = T(0);
  if (SW & VSW_SHEAR) d = fma(k.c3 * zp, Wp, pipp);
  if (SW & VSW_BULK)
    d = d + fma(k.bc2 * pdu, pdu, fma(k.bc1 * zp, zp, k.bc0 * m2));
  d = fma(-sgn, fa, T(1)) * d;
  if (regulate) d = d < T(-1) ? T(-1) : (d > T(1) ? T(1) : d);
  return fma(fa, d, fa);
}

// p.dsigma f, with the outflow filter max(p.dsigma, 0) as the JAX package
template <typename T>
__device__ __forceinline__ T vah_emit(T pds, T f, int outflow) {
  return (outflow ? fmax(pds, T(0)) : pds) * f;
}

// the NKV values of (cell g, rapidity difference delta); w the node weight
template <typename T>
__device__ __forceinline__ void vah_node(const T* g, T delta, T w, T* o) {
  const T ch = d_cosh(delta), sh = d_sinh(delta);
  const T tsh = sh * g[V_TAU];
  o[0] = ch * g[V_DAT] + sh * g[V_DANT];
  o[1] = ch * g[V_UT] - sh * g[V_TUN];
  o[2] = ch * g[V_ZT] - sh * g[V_TZN];
  o[3] = g[V_XIL] * o[2] * o[2];
  o[4] = ch * ch * g[V_KPITT] + tsh * tsh * g[V_KPINN]
         - T(2) * ch * tsh * g[V_KPITN];
  o[5] = T(-2) * (ch * g[V_KPITX] - tsh * g[V_KPIXN]);
  o[6] = T(-2) * (ch * g[V_KPITY] - tsh * g[V_KPIYN]);
  o[7] = ch * g[V_WT] - sh * g[V_TWN];
  o[8] = w;
}

// the value at one (cell, fixed node, species, point) from the node's
// composites q (vah_node) and the (cell, point) terms W1, -W2, C4 (c4
// folded) and -WW; c23 = px C2 + py C3 of the node at this point
template <typename T, int SW>
__device__ __forceinline__ T vah_point(const T* q, T mT, T mT2, T m2, T sgn,
                                       T W1, T nW2, T C4, T nWW, T c23,
                                       const VahCoef<T>& k, int regulate,
                                       int outflow) {
  const T pdu = fma(mT, q[1], nW2);
  const T zp = mT * q[2];
  T pipp = T(0), Wp = T(0);
  if (SW & VSW_SHEAR) {
    pipp = fma(mT2, q[4], fma(mT, c23, C4));
    Wp = fma(mT, q[7], nWW);
  }
  const T f = vah_f<T, SW>(pdu, mT2 * q[3], zp, pipp, Wp, m2, sgn, k,
                           regulate);
  return vah_emit(fma(mT, q[0], W1), f, outflow);
}

}  // namespace is3d
