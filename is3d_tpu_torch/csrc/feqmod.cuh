// The modified-equilibrium (df 3-4) emission value, shared by the feqmod
// spectra kernels (feqmod.cu) and the dN/dX kernel's feqmod producer
// (dndx.cu): the packed per-cell fields, the per-(cell, node) composites
// at fixed nodes, f_mod and the linearized fallback (fallback_value on the
// packed fields for dndx.cu; fallback_fixed on feqmod.cu's staged, folded
// coefficients).
//
// Per (cell, node, species, point) a clean cell evaluates only
//
//     x          = Minv p = mT alpha(c,r) + gamma(c,m)   (3 components)
//     E_mod      = sqrt(m^2 + max(|x|^2, 0))
//     f_mod      = |renorm|(c,s) / (exp(E_mod / T_mod - b alphaB_mod) + sign)
//
// at the scaled node, and a breakdown cell (and, in 3+1D, a cell with detA
// < 0.01 at the nodes where |y - eta| < detA) only the linearized fallback
// at the unscaled node, whose kinematics are the linear kernels' (u.p,
// pi:pp, V.p).  |x|^2 is the sum of squares, not the JAX package's
// expanded quadratic form, which cancels in float32 on cells near
// breakdown (kernels/feqmod.py).  Guards kept from
// is3d_tpu/kernels/feqmod.py:
//   * |x|^2 saturates: NaN and -inf go to +inf (E_mod = inf, f_mod
//     exactly 0);
//   * the outflow filter is a select, not max(p.dsigma, 0) f: the
//     fallback can be NaN at points that emit nothing;
//   * an f_mod of exactly 0 emits nothing, also where p.dsigma overflowed
//     (2+1D fixed nodes scaled by a large detA: cosh(detA eta) is inf in
//     float32), where the JAX package's 0 inf is NaN;
//   * the df 3 fallback is not regrouped (a clip-regulated +-inf must not
//     become 0 inf = NaN when betaV = 0), and its clip keeps NaN as NaN;
//   * df 4's fallback has no chemical potential.

#pragma once

#include <cuda_runtime.h>

#include "folded.cuh"

namespace is3d {

// must match FQ_FIELDS in is3d_tpu_torch/kernels/feqmod.py
enum FqField {
  Q_TAU, Q_ETA, Q_DAT, Q_DANT, Q_DAX, Q_DAY,
  Q_BD, Q_DETA, Q_SCALE, Q_YFM, Q_A0, Q_A1, Q_A2, Q_B0, Q_B1, Q_B2, Q_GX0,
  Q_GX1, Q_GX2, Q_GY0, Q_GY1, Q_GY2, Q_INVTM, Q_ABM,
  Q_UT, Q_TUN, Q_UX, Q_UY, Q_PITT, Q_PITX, Q_PITY, Q_PITN, Q_PINN, Q_PIXX,
  Q_PIXY, Q_PIXN, Q_PIYY, Q_PIYN, Q_VT, Q_VX, Q_VY, Q_VN, Q_INVT, Q_ALPHAB,
  Q_KSH, Q_KF, Q_KG, Q_K3, Q_BULKPI, Q_BENTH, Q_KV, Q_DZ, Q_DL, Q_YFLOW,
  NQ
};

// the fallback's terms (kernels/feqmod.py FeqmodFlags.switches)
constexpr int SW_SHEAR = 1, SW_BULK = 2, SW_DIFF = 4;
// values staged per (cell, fixed node): f_mod's A1 and alpha (3); the
// fallback's A1, B1, C1, C2, C3, D1; the node weight; the narrow flag
constexpr int NKQ = 12;

__device__ __forceinline__ float fq_sqrt(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ double fq_sqrt(double x) { return sqrt(x); }

// the fallback's per-cell coefficients; L = log2 e (float32) folded into
// the exponent's two
template <typename T>
struct FbCoef {
  T invTL, nab, ksh, kF, kG, k3, bulkPi, benth, kV, dzl, dl, invT;
};

template <typename T>
__device__ __forceinline__ FbCoef<T> fb_coef(const T* g) {
  const T L = Fn<T>::SCALE;
  FbCoef<T> k;
  k.invTL = L * g[Q_INVT];
  k.nab = -L * g[Q_ALPHAB];
  k.ksh = g[Q_KSH];
  k.kF = g[Q_KF];
  k.kG = g[Q_KG];
  k.k3 = g[Q_K3];
  k.bulkPi = g[Q_BULKPI];
  k.benth = g[Q_BENTH];
  k.kV = g[Q_KV];
  k.dzl = g[Q_DZ] - T(3) * g[Q_DL];
  k.dl = g[Q_DL];
  k.invT = g[Q_INVT];
  return k;
}

// the fallback f_eq (1 + df) from u.p, pi:pp and V.p (unscaled: the
// coefficients multiply in the JAX package's order)
template <typename T>
__device__ __forceinline__ T fallback_value(int df_mode, int sw, T pdu,
                                            T pipp, T Vp, T m2, T sgn, T bar,
                                            const FbCoef<T>& k,
                                            int regulate) {
  using F = Fn<T>;
  T arg = pdu * k.invTL;
  if (df_mode == 3) arg = fma(bar, k.nab, arg);
  const T feq = F::rcp(F::exp_scaled(arg) + sgn);
  if (sw == 0) return feq;
  const T feqbar = fma(-sgn, feq, T(1));
  const T r = F::rcp(pdu);
  T d = T(0);
  if (df_mode == 3) {
    if (sw & SW_SHEAR) d = (k.ksh * pipp) * r;
    if (sw & SW_BULK)
      d = d + (fma(k.kF, pdu, k.kG * bar) + k.k3 * fma(-m2, r, pdu))
                  * k.bulkPi;
    if (sw & SW_DIFF) d = d + (fma(-bar, r, k.benth) * Vp) * k.kV;
    d = feqbar * d;
  } else {
    if (sw & SW_SHEAR) d = ((feqbar * k.ksh) * pipp) * r;
    if (sw & SW_BULK)
      d = d + (k.dzl + ((feqbar * k.dl) * fma(-m2, r, pdu)) * k.invT);
  }
  if (regulate) d = d < T(-1) ? T(-1) : (d > T(1) ? T(1) : d);
  return fma(feq, d, feq);
}

// min(x, +inf): NaN -> +inf, every other value kept (PTX min returns the
// operand that is not NaN); one instruction for the |x|^2 saturation of a
// sum of squares, which is never -inf
__device__ __forceinline__ float fq_sat(float x) {
  float y;
  asm("min.f32 %0, %1, %2;"
      : "=f"(y)
      : "f"(x), "f"(__int_as_float(0x7f800000)));
  return y;
}
__device__ __forceinline__ double fq_sat(double x) {
  double y;
  asm("min.f64 %0, %1, %2;"
      : "=d"(y)
      : "d"(x), "d"(__longlong_as_double(0x7ff0000000000000LL)));
  return y;
}

// the regulation's clip to [-1, 1], NaN kept as NaN (float32: the .NaN
// forms of max and min, one instruction each)
__device__ __forceinline__ float fq_clip(float d) {
  float y;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(d), "f"(-1.0f));
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(y), "f"(1.0f));
  return y;
}
__device__ __forceinline__ double fq_clip(double d) {
  return d < -1.0 ? -1.0 : (d > 1.0 ? 1.0 : d);
}

// the fallback's per-cell coefficients as feqmod.cu's kernels stage them
// (kernels/feqmod.py fixed_stage, remap_stage): fb_coef's with bulkPi
// folded into kF, kG and k3 (df 3) and 1/T into dl (df 4)
template <typename T>
struct FbFold {
  T invTL, nab, ksh, kFb, kGb, k3b, benth, kV, dzl, dlT;
};

// fallback_value for feqmod.cu's chains: the same terms in the same order,
// with bulkPi and 1/T folded into the bulk terms' coefficients (FbFold), the
// (cell, species) factors nbal = b (-L alphaB) and kGbb = kG bulkPi b
// hoisted out of the loop, and the df mode (DF) and, where MAIN, the main
// paths' switches (shear + bulk, regulation) at compile time; the df 3
// bracket stays unregrouped
template <typename T, int DF, bool MAIN>
__device__ __forceinline__ T fallback_fixed(T pdu, T pipp, T Vp, T m2, T sgn,
                                            T bar, T nbal, T kGbb,
                                            const FbFold<T>& k, int sw_,
                                            int regulate) {
  using F = Fn<T>;
  const int sw = MAIN ? (SW_SHEAR | SW_BULK) : sw_;
  const T arg = DF == 3 ? fma(pdu, k.invTL, nbal) : pdu * k.invTL;
  const T feq = F::rcp(F::exp_scaled(arg) + sgn);
  if (sw == 0) return feq;
  const T feqbar = fma(-sgn, feq, T(1));
  const T r = F::rcp(pdu);
  T d = T(0);
  if (DF == 3) {
    if (sw & SW_SHEAR) d = (k.ksh * pipp) * r;
    if (sw & SW_BULK)
      d = d + fma(k.k3b, fma(-m2, r, pdu), fma(k.kFb, pdu, kGbb));
    if (sw & SW_DIFF) d = d + (fma(-bar, r, k.benth) * Vp) * k.kV;
    d = feqbar * d;
  } else {
    if (sw & SW_SHEAR) d = ((feqbar * k.ksh) * pipp) * r;
    if (sw & SW_BULK) d = d + fma(feqbar * k.dlT, fma(-m2, r, pdu), k.dzl);
  }
  if (MAIN || regulate) d = fq_clip(d);
  return fma(feq, d, feq);
}

// f_mod from |x|^2 (saturated here); invTmL = L / T_mod, nbm = -L b
// alphaB_mod, rn the (cell, species) |renorm| (x zscale with the remap)
template <typename T>
__device__ __forceinline__ T mod_value(T x2, T m2, T invTmL, T nbm, T sgn,
                                       T rn) {
  using F = Fn<T>;
  x2 = x2 > -F::inf() ? x2 : F::inf();
  const T E = fq_sqrt(m2 + fmax(x2, T(0)));
  return rn * F::rcp(F::exp_scaled(fma(E, invTmL, nbm)) + sgn);
}

// |x|^2 of x = mT alpha + gamma
template <typename T>
__device__ __forceinline__ T x_squared(T mT, const T* alpha, const T* gam) {
  const T x0 = fma(mT, alpha[0], gam[0]);
  const T x1 = fma(mT, alpha[1], gam[1]);
  const T x2 = fma(mT, alpha[2], gam[2]);
  return fma(x0, x0, fma(x1, x1, x2 * x2));
}

// p.dsigma f with the outflow filter as a select
template <typename T>
__device__ __forceinline__ T emit(T pds, T f, int outflow) {
  const T v = pds * f;
  return outflow ? (pds > T(0) ? v : T(0)) : v;
}

// emit for f_mod: exactly 0 where f_mod is
template <typename T>
__device__ __forceinline__ T emit_mod(T pds, T f, int outflow) {
  return f == T(0) ? T(0) : emit(pds, f, outflow);
}

// the NKQ values of (cell g, fixed node): 3+1D the output rapidity y
// (Delta = y - eta for both chains), 2+1D the eta node (f_mod at -scale
// eta, the fallback at -eta); w the node weight
template <typename T, int DIM>
__device__ __forceinline__ void feqmod_node(const T* g, T node, T w, T* o) {
  const T du = DIM == 3 ? node - g[Q_ETA] : -node;
  const T ds = DIM == 3 ? du : -(g[Q_SCALE] * node);
  const T cs = d_cosh(ds), ss = d_sinh(ds);
  o[0] = cs * g[Q_DAT] + ss * g[Q_DANT];
  o[1] = cs * g[Q_A0] + ss * g[Q_B0];
  o[2] = cs * g[Q_A1] + ss * g[Q_B1];
  o[3] = cs * g[Q_A2] + ss * g[Q_B2];
  const T ch = d_cosh(du), sh = d_sinh(du);
  const T tsh = sh * g[Q_TAU];
  o[4] = ch * g[Q_DAT] + sh * g[Q_DANT];
  o[5] = ch * g[Q_UT] - sh * g[Q_TUN];
  o[6] = ch * ch * g[Q_PITT] + tsh * tsh * g[Q_PINN]
         - T(2) * ch * tsh * g[Q_PITN];
  o[7] = T(-2) * (ch * g[Q_PITX] - tsh * g[Q_PIXN]);
  o[8] = T(-2) * (ch * g[Q_PITY] - tsh * g[Q_PIYN]);
  o[9] = ch * g[Q_VT] - tsh * g[Q_VN];
  o[10] = w;
  o[11] = (DIM == 3 && fabs(du) < g[Q_DETA]) ? T(1) : T(0);
}

// a 3+1D cell whose narrow mask can fire (JAX: detA < 0.01)
template <typename T, int DIM>
__device__ __forceinline__ bool feqmod_narrow(const T* g) {
  return DIM == 3 && g[Q_DETA] < T(0.01);
}

}  // namespace is3d
