// Per-point Cooper-Frye emission with linear delta-f: the packed cell
// fields and the per-(cell, node) composites every kernel shares.  The
// kernels evaluate the folded form of folded.cuh.
//
// Per (cell, rapidity node) the kinematics enter through cosh/sinh of
// Delta = y - eta, so every per-point quantity is a short fma chain:
//
//     p.dsigma   = mT A1(c,r) + W1(c,m)
//     u.p        = mT B1(c,r) - W2(c,m)
//     pi:pp      = mT^2 C1 + mT px C2 + mT py C3 + C4(c,m)
//     V.p        = mT D1(c,r) - D2(c,m)
//
// Cell fields come from packed rows (field f of cell c at raw[f * ld + c];
// ld = 1, c = 0 for one row), in the order of `Field`, which must match
// FIELDS in is3d_tpu_torch/kernels/smooth.py.  No fast math: exp(u.p/T)
// overflows at large mT cosh(Delta), and 1/(inf + s) must stay exactly 0.

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

__device__ __forceinline__ float d_exp(float x) { return expf(x); }
__device__ __forceinline__ double d_exp(double x) { return exp(x); }
__device__ __forceinline__ float d_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double d_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float d_cosh(float x) { return coshf(x); }
__device__ __forceinline__ double d_cosh(double x) { return cosh(x); }
__device__ __forceinline__ float d_sinh(float x) { return sinhf(x); }
__device__ __forceinline__ double d_sinh(double x) { return sinh(x); }

template <typename T>
struct Comp {             // per (cell, node)
  T A1, B1, C1, C2, C3, D1;
};

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

}  // namespace is3d
