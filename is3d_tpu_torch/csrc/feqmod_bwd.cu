// The backward pass of the modified-equilibrium (df 3 "Mike", df 4 "Jonah")
// smooth spectra for Hopper (sm_90a), float32 and float64: the gradient of
// <G, spectra> with respect to the packed cells and the (cell, species)
// renormalization.
//
// Replaces what JAX runs for the reverse pass of the feqmod spectra: XLA's
// reverse of the chunk body _chunk_contribution_feqmod
// (is3d_tpu/kernels/feqmod.py:276) under jax.checkpoint (:697-698), driven
// by is3d_tpu/diff.py:132-155, for the fixed-node kernel
// (feqmod_bwd_kernel: 3+1D and 2+1D fixed nodes) and the 2+1D mT remap
// (feqmod_remap_bwd_kernel, the reverse of feqmod.py:464-526).  Like JAX's
// remat it keeps no forward intermediates: it recomputes the emission value
// at every (cell, node, species, point) and chains through it.
//
// Inputs (built by is3d_tpu_torch/kernels/feqmod.py:pack_feqmod_cells):
// cells (n_cells, NQ) in the order of feqmod.cuh's `FqField`; rn, wcs
// (n_cells, n_species); the species and momentum constants of the forward;
// G (n_species, n_pT, n_phi, n_out), the output's cotangent (n_out =
// n_nodes in 3+1D, 1 in 2+1D).  Outputs: grad (n_cells, NQ) and grad_rn
// (n_cells, n_species), every entry written once.
//
// The formula (the plain version's, kernels/feqmod.py:feqmod_block, under
// torch autograd).  A (cell, node) takes one chain, as the forward kernel
// branches (per cell on the breakdown flag bd; in 3+1D a cell with detA <
// 0.01 takes the fallback at the nodes where |y - eta| < detA), and the
// derivative is that chain's (JAX's jnp.where derivative; bd and the
// narrow mask are steps and carry none):
//   * f_mod: x = Minv p = mT (a cosh + b sinh) + px gx + py gy at the scaled
//     node, E = sqrt(m^2 + |x|^2), f_mod = rn (zscale) / (exp(E / T_mod -
//     b alphaB_mod) + sign); the value p.dsigma f_mod.  Its cell fields are
//     dsigma, a, b, gx, gy, 1/T_mod, alphaB_mod and the node's (eta in
//     3+1D, the 2+1D node scale, with the remap y_flow and zscale, which
//     also multiplies f_mod), and rn;
//   * the linearized fallback f_eq (1 + df) at the unscaled node
//     (kernels/feqmod.py:fallback_f), through u.p, pi:pp and V.p as the
//     linear kernels' (smooth_spectra_bwd.cu) and the per-cell coefficients
//     (1/T, alphaB, ksh, kF, kG, k3, bulkPi, nB/(E+P), kV; df 4 dz, dl).
// Hazards, each an exact 0 in both directions as in the forward: an
// overflowed exponential (f = 0); |x|^2 not finite (a non-finite Minv, or
// overflow: saturated, E = inf, so f_mod = 0, or rn / sign where 1/T_mod
// < 0, whose derivative by the exponent is 0); f_mod = 0 emits nothing and
// has no derivative (the plain version's select); the outflow select (pds
// <= 0); the df 3 fallback's clip-regulated +-inf (the clip carries 0, and
// the bracket's own chain is skipped where its cotangent is 0, so no 0 x
// inf reaches a sum).
//
// What bounds it on this card: FP32 issue.  Each evaluation recomputes the
// forward (a sqrt, an exp and a reciprocal beside ~16 FP32 operations for
// f_mod; an exp and two reciprocals beside ~25 for the fallback) and adds
// the chain rule and the point sums (kernels/feqmod.py,
// feqmod_backward_formula_ops); the cells and (cell, species) tables of a
// group are 24 MB and G, read once a block, stays in L2.
//
// Design: K9a's (smooth_spectra_bwd.cu) per-cell reduction.
//   * A thread owns one (cell, node) pair and walks every (species, pT,
//     phi); a block holds CT cells x all nodes, so nothing of a cell's sum
//     leaves the block.  The chain is the thread's for the whole walk.
//   * The species loop is outermost, so a thread's share of grad_rn[c, s]
//     is one float64 register; after each species the block adds the
//     nodes of each cell in node order through shared memory and writes
//     the entry.
//   * Per (species, pT) the block stages G's row (all phi, and in 3+1D all
//     nodes) weighted by prefactor x degeneracy (x the remap's s(mT)), and
//     the row's px, py.  The thread forms its node kinematics mT cosh, mT
//     sinh once per (species, pT) (with the remap from one exp), and the
//     chain's composites, then runs the n_phi points.
//   * The accumulator.  One cell's gradient sums S x P x F x nodes terms
//     (5.2e6 in 3+1D at 320 x 32 x 24 x 21, 1.2e7 with the 48-node remap).
//     The sums over the n_phi points of a row run in T (24 terms); each
//     row's sums are multiplied by its node kinematics and added in float64
//     to the thread's NQ accumulators, which live in shared memory (one
//     column a thread).
//   * No atomics.  At the end the block adds each cell's nodes in node
//     order in float64 and one thread writes each entry: two launches give
//     identical bits.
//   * float32 takes ex2.approx and rcp.approx as the forward kernel does
//     (folded.cuh, Fn<float>): +inf -> 0.
// A first version: simple and right; its time against its bound is in
// PERF.md.

#include <cuda_runtime.h>

#include "feqmod.cuh"

namespace {

using namespace is3d;

constexpr int BLOCK = 128;       // most threads a block: CT cells x nodes
constexpr size_t MAX_SMEM = 232448;

enum Mode { FIXED3 = 0, FIXED2 = 1, REMAP = 2 };

// shared memory: the float64 accumulators (NQ columns of nt), the per-node
// grad_rn shares (nt), the block's cell rows, the staged cotangent row and
// the row's px, py
template <typename T>
struct Smem {
  double *acc, *red;
  T *raw, *gs, *pxs, *pys, *end_;
  __host__ __device__ Smem(unsigned char* p, int nt, int CT, int F, int RG) {
    acc = reinterpret_cast<double*>(p);
    red = acc + (size_t)NQ * nt;
    raw = reinterpret_cast<T*>(red + nt);
    gs = raw + CT * NQ;
    pxs = gs + F * RG;
    pys = pxs + F;
    end_ = pys + F;
  }
  __host__ __device__ size_t bytes(const unsigned char* p) const {
    return reinterpret_cast<const unsigned char*>(end_) - p;
  }
};

// the f_mod chain over one row (species, pT) of a thread's (cell, node):
// cp, sn the node kinematics, zs the remap's zscale (1 at fixed nodes);
// returns the row's share of grad_rn; sm the remap's s(mT) (d Delta /
// d zscale = s(mT) eta_r there)
template <typename T, int MODE>
__device__ __forceinline__ double mod_row(
    const T* g, double* a, int nt, const T* gs, int gstride, const T* pxs,
    const T* pys, int F, T w, T cp, T sn, T m2, T sgn, T bar, T rnv, T zs,
    T eta_r, T sm, int outflow) {
  using Fx = Fn<T>;
  const T L = Fx::SCALE;
  const T dat = g[Q_DAT], dant = g[Q_DANT], dax = g[Q_DAX], day = g[Q_DAY];
  const T invTm = g[Q_INVTM];
  const T nbm = -L * bar * g[Q_ABM];
  const T invTmL = L * invTm;
  const T A = cp * dat + sn * dant;
  T al[3], gxk[3], gyk[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    al[k] = cp * g[Q_A0 + k] + sn * g[Q_B0 + k];
    gxk[k] = g[Q_GX0 + k];
    gyk[k] = g[Q_GY0 + k];
  }
  const T rz = rnv * zs;
  T tP = 0, tPx = 0, tPy = 0, tIT = 0, tG = 0, tRn = 0, tS = 0;
  T tX[3] = {0, 0, 0}, tXx[3] = {0, 0, 0}, tXy[3] = {0, 0, 0};
  bool hit = false;
  for (int f = 0; f < F; ++f) {
    const T x = pxs[f], y = pys[f];
    const T pds = A + dax * x + day * y;
    T X[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) X[k] = al[k] + gxk[k] * x + gyk[k] * y;
    const T x2 = X[0] * X[0] + X[1] * X[1] + X[2] * X[2];
    // saturated |x|^2 (NaN, inf): E = inf as in the forward, so f_mod is
    // rn / (e^(+-inf) + sign) (0, or rn / sign where 1/T_mod < 0)
    const bool sat = !(x2 < Fx::inf());
    const T E = sat ? Fx::inf() : d_sqrt(m2 + x2);
    const T fb = Fx::rcp(Fx::exp_scaled(fma(E, invTmL, nbm)) + sgn);
    const T fm = rz * fb;
    if (fm == T(0) || (outflow && !(pds > T(0)))) continue;
    const T gv = gs[f * gstride] * w;
    const T gp = gv * fm, gf = gv * pds;
    hit = true;
    tP += gp;
    tPx += gp * x;
    tPy += gp * y;
    tRn += gf * fb * zs;
    if (MODE == REMAP) tS += gf * rnv * fb;
    if (sat) continue;          // the occupation's derivative is exactly 0
    const T garg = -gf * rz * fb * (T(1) - sgn * fb);
    tIT += garg * E;
    tG += garg;
    const T h = E > T(0) ? garg * invTm / E : T(0);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const T gx = h * X[k];
      tX[k] += gx;
      tXx[k] += gx * x;
      tXy[k] += gx * y;
    }
  }
  // a row that emits nothing adds nothing (its node kinematics may be inf:
  // f_mod's node scaled by a large detA)
  if (!hit) return 0.0;
  const double C = cp, Sn = sn;
  a[Q_DAT * nt] += C * tP;
  a[Q_DANT * nt] += Sn * tP;
  a[Q_DAX * nt] += tPx;
  a[Q_DAY * nt] += tPy;
  double gdel = (Sn * dat + C * dant) * tP;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a[(Q_A0 + k) * nt] += C * tX[k];
    a[(Q_B0 + k) * nt] += Sn * tX[k];
    a[(Q_GX0 + k) * nt] += tXx[k];
    a[(Q_GY0 + k) * nt] += tXy[k];
    gdel += (Sn * g[Q_A0 + k] + C * g[Q_B0 + k]) * tX[k];
  }
  a[Q_INVTM * nt] += tIT;
  a[Q_ABM * nt] -= (double)bar * tG;
  if (MODE == FIXED3) a[Q_ETA * nt] -= gdel;           // Delta = y - eta
  if (MODE == FIXED2) a[Q_SCALE * nt] -= (double)eta_r * gdel;  // -scale eta
  if (MODE == REMAP) {
    // Delta = y_flow + zscale s(mT) eta_r, and zscale multiplies f_mod
    a[Q_YFM * nt] += gdel;
    a[Q_SCALE * nt] += (double)sm * eta_r * gdel + tS;
  }
  return tRn;
}

// the linearized fallback over one row (species, pT) of a thread's (cell,
// node) at the unscaled node (cp, sn)
template <typename T, int MODE, int DF>
__device__ __forceinline__ void fallback_row(
    const T* g, double* a, int nt, const T* gs, int gstride, const T* pxs,
    const T* pys, int F, T w, T cp, T sn, T m2, T sgn, T bar, int sw,
    int regulate, int outflow) {
  using Fx = Fn<T>;
  const T L = Fx::SCALE;
  const bool shear = sw & SW_SHEAR, bulk = sw & SW_BULK;
  const bool diff = DF == 3 && (sw & SW_DIFF);
  const T tau = g[Q_TAU], dat = g[Q_DAT], dant = g[Q_DANT], dax = g[Q_DAX];
  const T day = g[Q_DAY], ut = g[Q_UT], tun = g[Q_TUN], ux = g[Q_UX];
  const T uy = g[Q_UY], pitt = g[Q_PITT], pitx = g[Q_PITX];
  const T pity = g[Q_PITY], pitn = g[Q_PITN], pinn = g[Q_PINN];
  const T pixx = g[Q_PIXX], pixy = g[Q_PIXY], pixn = g[Q_PIXN];
  const T piyy = g[Q_PIYY], piyn = g[Q_PIYN], Vt = g[Q_VT], Vx = g[Q_VX];
  const T Vy = g[Q_VY], Vn = g[Q_VN], invT = g[Q_INVT];
  const T alpha = g[Q_ALPHAB], ksh = g[Q_KSH], kF = g[Q_KF], kG = g[Q_KG];
  const T k3 = g[Q_K3], Pi = g[Q_BULKPI], benth = g[Q_BENTH], kV = g[Q_KV];
  const T dz = g[Q_DZ], dl = g[Q_DL];
  const T A = cp * dat + sn * dant;
  const T B = cp * ut - sn * tun;
  const T C1 = cp * cp * pitt + tau * tau * sn * sn * pinn
               - T(2) * tau * cp * sn * pitn;
  const T CX = T(-2) * (cp * pitx - tau * sn * pixn);
  const T CY = T(-2) * (cp * pity - tau * sn * piyn);
  const T D1 = cp * Vt - tau * sn * Vn;
  const T lo = regulate ? T(-1) : -Fx::inf();
  const T hi = regulate ? T(1) : Fx::inf();
  const T nab = DF == 3 ? -L * bar * alpha : T(0);
  // the row's sums over phi, in T
  T tP = 0, tPx = 0, tPy = 0, tU = 0, tUx = 0, tUy = 0;
  T tQ = 0, tQx = 0, tQy = 0, tQxx = 0, tQyy = 0, tQxy = 0;
  T tV = 0, tVx = 0, tVy = 0;
  T tIT = 0, tA = 0, tKsh = 0, tKF = 0, tKG = 0, tK3 = 0, tPi = 0;
  T tBe = 0, tKV = 0, tDz = 0, tDl = 0;
  bool hit = false;
  for (int f = 0; f < F; ++f) {
    const T x = pxs[f], y = pys[f];
    const T pds = A + dax * x + day * y;
    if (outflow && !(pds > T(0))) continue;
    hit = true;
    const T pdu = B - (ux * x + uy * y);
    T pipp = T(0), Vp = T(0);
    if (shear)
      pipp = C1 + x * CX + y * CY + pixx * x * x + piyy * y * y
             + T(2) * pixy * x * y;
    if (diff) Vp = D1 - (Vx * x + Vy * y);
    // the forward value (kernels/feqmod.py:fallback_f)
    const T feq = Fx::rcp(Fx::exp_scaled(fma(pdu, L * invT, nab)) + sgn);
    const T feqbar = T(1) - sgn * feq;
    T fv = feq, d = T(0), dc = T(0), sum = T(0), r = T(0), mr = T(0);
    if (sw) {
      r = Fx::rcp(pdu);
      mr = pdu - m2 * r;
      if (DF == 3) {
        if (shear) sum = ksh * pipp * r;
        if (bulk) sum = sum + (kF * pdu + kG * bar + k3 * mr) * Pi;
        if (diff) sum = sum + (benth - bar * r) * Vp * kV;
        d = feqbar * sum;
      } else {
        if (shear) d = feqbar * ksh * pipp * r;
        if (bulk) d = d + (dz - T(3) * dl + feqbar * dl * mr * invT);
      }
      dc = d < lo ? lo : (d > hi ? hi : d);    // NaN stays NaN
      fv = feq * dc + feq;
    }
    const T gv = gs[f * gstride] * w;
    const T gp = gv * fv, gf = gv * pds;
    // the chain rule, as torch autograd takes it through fallback_f
    T gfeq = gf, gu = T(0), gq = T(0), gV = T(0);
    if (sw) {
      gfeq = gf * (dc + T(1));
      const T gd = (d >= lo && d <= hi) ? gf * feq : T(0);
      if (gd != T(0)) {
        T gbar = T(0), gr = T(0);
        if (DF == 3) {
          const T gs_ = gd * feqbar;
          gbar = gd * sum;
          if (shear) {
            tKsh += gs_ * pipp * r;
            gq = gs_ * ksh * r;
            gr += gs_ * ksh * pipp;
          }
          if (bulk) {
            tKF += gs_ * Pi * pdu;
            tKG += gs_ * Pi * bar;
            tK3 += gs_ * Pi * mr;
            tPi += gs_ * (kF * pdu + kG * bar + k3 * mr);
            gu += gs_ * Pi * (kF + k3);
            gr -= gs_ * Pi * k3 * m2;
          }
          if (diff) {
            const T br = benth - bar * r;
            tBe += gs_ * Vp * kV;
            gr -= gs_ * bar * Vp * kV;
            gV = gs_ * br * kV;
            tKV += gs_ * br * Vp;
          }
        } else {
          if (shear) {
            gbar += gd * ksh * pipp * r;
            tKsh += gd * feqbar * pipp * r;
            gq = gd * feqbar * ksh * r;
            gr += gd * feqbar * ksh * pipp;
          }
          if (bulk) {
            tDz += gd;
            tDl += gd * (feqbar * mr * invT - T(3));
            gbar += gd * dl * mr * invT;
            gu += gd * feqbar * dl * invT;
            gr -= gd * feqbar * dl * m2 * invT;
            tIT += gd * feqbar * dl * mr;
          }
        }
        gfeq -= sgn * gbar;
        gu -= gr * r * r;
      }
    }
    const T garg = -gfeq * feq * feqbar;
    tIT += garg * pdu;
    tA += garg * bar;
    gu += garg * invT;
    tP += gp;
    tPx += gp * x;
    tPy += gp * y;
    tU += gu;
    tUx += gu * x;
    tUy += gu * y;
    if (shear) {
      tQ += gq;
      tQx += gq * x;
      tQy += gq * y;
      tQxx += gq * x * x;
      tQyy += gq * y * y;
      tQxy += gq * x * y;
    }
    if (diff) {
      tV += gV;
      tVx += gV * x;
      tVy += gV * y;
    }
  }
  if (!hit) return;
  const double C = cp, Sn = sn, td = tau;
  a[Q_DAT * nt] += C * tP;
  a[Q_DANT * nt] += Sn * tP;
  a[Q_DAX * nt] += tPx;
  a[Q_DAY * nt] += tPy;
  a[Q_UT * nt] += C * tU;
  a[Q_TUN * nt] -= Sn * tU;
  a[Q_UX * nt] -= tUx;
  a[Q_UY * nt] -= tUy;
  a[Q_INVT * nt] += tIT;
  if (DF == 3) a[Q_ALPHAB * nt] -= tA;
  a[Q_KSH * nt] += tKsh;
  a[Q_KF * nt] += tKF;
  a[Q_KG * nt] += tKG;
  a[Q_K3 * nt] += tK3;
  a[Q_BULKPI * nt] += tPi;
  a[Q_BENTH * nt] += tBe;
  a[Q_KV * nt] += tKV;
  a[Q_DZ * nt] += tDz;
  a[Q_DL * nt] += tDl;
  double gdel = (Sn * dat + C * dant) * tP + (Sn * ut - C * tun) * tU;
  if (shear) {
    a[Q_PITT * nt] += C * C * tQ;
    a[Q_PINN * nt] += td * td * Sn * Sn * tQ;
    a[Q_PITN * nt] -= 2.0 * td * C * Sn * tQ;
    a[Q_PITX * nt] -= 2.0 * C * tQx;
    a[Q_PIXN * nt] += 2.0 * td * Sn * tQx;
    a[Q_PITY * nt] -= 2.0 * C * tQy;
    a[Q_PIYN * nt] += 2.0 * td * Sn * tQy;
    a[Q_PIXX * nt] += tQxx;
    a[Q_PIYY * nt] += tQyy;
    a[Q_PIXY * nt] += 2.0 * tQxy;
    a[Q_TAU * nt] += 2.0 * td * pinn * Sn * Sn * tQ
                     - 2.0 * pitn * C * Sn * tQ + 2.0 * pixn * Sn * tQx
                     + 2.0 * piyn * Sn * tQy;
    gdel += (2.0 * C * Sn * pitt + 2.0 * td * td * Sn * C * pinn
             - 2.0 * td * (Sn * Sn + C * C) * pitn) * tQ
            - 2.0 * (Sn * pitx - td * C * pixn) * tQx
            - 2.0 * (Sn * pity - td * C * piyn) * tQy;
  }
  if (diff) {
    a[Q_VT * nt] += C * tV;
    a[Q_VN * nt] -= td * Sn * tV;
    a[Q_VX * nt] -= tVx;
    a[Q_VY * nt] -= tVy;
    a[Q_TAU * nt] -= (double)Vn * Sn * tV;
    gdel += (Sn * Vt - td * C * Vn) * tV;
  }
  if (MODE == FIXED3) a[Q_ETA * nt] -= gdel;           // Delta = y - eta
  if (MODE == REMAP) a[Q_YFLOW * nt] += gdel;         // y_flow - s eta_r
}

// grid (blocks of CT cells); thread t owns cell t / R of the block at node
// t % R
template <typename T, int MODE, int DF>
__device__ __forceinline__ void feqmod_bwd_body(
    const T* __restrict__ cells, int n_cells, int CT,
    const T* __restrict__ rn, const T* __restrict__ wcs,
    const T* __restrict__ mass, const T* __restrict__ sign,
    const T* __restrict__ baryon, const T* __restrict__ deg, int S,
    const T* __restrict__ pT, int P, const T* __restrict__ px,
    const T* __restrict__ py, const T* __restrict__ cos_phi,
    const T* __restrict__ sin_phi, int F, const T* __restrict__ nodes,
    const T* __restrict__ weights, int R, int sw, int regulate, int outflow,
    T prefactor, T t_ref, const T* __restrict__ G, T* __restrict__ grad,
    T* __restrict__ grad_rn) {
  constexpr bool RG1 = MODE != FIXED3;           // G has no node axis
  const int RG = RG1 ? 1 : R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const Smem<T> s(smem_raw, nt, CT, F, RG);
  const int c0 = blockIdx.x * CT;
  const int nc = min(CT, n_cells - c0);
  const bool active = tid < nc * R;
  const int ci = active ? tid / R : 0, r = active ? tid - ci * R : 0;

  for (int i = tid; i < CT * NQ; i += nt) {
    const int c = min(i / NQ, nc - 1);
    s.raw[i] = cells[(size_t)(c0 + c) * NQ + (i - (i / NQ) * NQ)];
  }
  double* a = s.acc + tid;
  for (int k = 0; k < NQ; ++k) a[k * nt] = 0.0;
  __syncthreads();
  const T* g = s.raw + ci * NQ;
  const int cell = c0 + ci;
  const T eta_r = nodes[r];
  const T w = MODE == FIXED3 ? T(1) : weights[r];
  // the thread's chain: the fallback on a breakdown cell and, in 3+1D, at
  // the narrow nodes of a cell with detA < 0.01; f_mod elsewhere
  bool fb = g[Q_BD] != T(0);
  T ch = T(1), sh = T(0);
  if (MODE != REMAP) {
    const T du = MODE == FIXED3 ? eta_r - g[Q_ETA] : -eta_r;
    if (MODE == FIXED3 && g[Q_DETA] < T(0.01) &&
        fabs(du) < g[Q_DETA])
      fb = true;
    const T delta = (fb || MODE == FIXED3) ? du : -(g[Q_SCALE] * eta_r);
    ch = d_cosh(delta);
    sh = d_sinh(delta);
  }
  const T zs = MODE == REMAP ? g[Q_SCALE] : T(1);

  for (int sp = 0; sp < S; ++sp) {
    const T m2 = mass[sp] * mass[sp], sgn = sign[sp], bar = baryon[sp];
    const T dg = prefactor * deg[sp];
    const size_t cs = (size_t)cell * S + sp;
    const T rnv = active ? rn[cs] : T(0);
    const T wcv = active ? wcs[cs] : T(0);
    double rn_acc = 0.0;
    for (int p = 0; p < P; ++p) {
      const T pt = pT[p];
      const T mT = d_sqrt(m2 + pt * pt);
      // s(mT) of the remap's node map (kernels/smooth.py:remap_scale):
      // the nodes' scale and, on the reduced output, the jacobian
      const T sm = MODE == REMAP
                       ? d_sqrt(t_ref / (mT > t_ref ? mT : t_ref)) : T(1);
      __syncthreads();                   // the previous row is consumed
      for (int i = tid; i < F * RG; i += nt)
        s.gs[i] = dg * sm * G[((size_t)sp * P + p) * F * RG + i];
      for (int i = tid; i < F; i += nt) {
        s.pxs[i] = MODE == REMAP ? pt * cos_phi[i] : px[p * F + i];
        s.pys[i] = MODE == REMAP ? pt * sin_phi[i] : py[p * F + i];
      }
      __syncthreads();
      if (!active || wcv == T(0)) continue;
      // the node kinematics of this (species, pT): cp = mT cosh(Delta),
      // sn = mT sinh(Delta); with the remap Delta = y_flow - s(mT) eta_r
      // (fallback) or y_flow + zscale s(mT) eta_r (f_mod)
      T cp, sn;
      if (MODE != REMAP) {
        cp = mT * ch;
        sn = mT * sh;
      } else {
        const T e = fb ? d_exp(g[Q_YFLOW] - sm * eta_r)
                       : d_exp(g[Q_YFM] + zs * sm * eta_r);
        const T em = T(1) / e;
        cp = T(0.5) * mT * (e + em);
        sn = T(0.5) * mT * (e - em);
      }
      const T* gr = s.gs + (RG1 ? 0 : r);
      const T wv = w * wcv;
      if (fb)
        fallback_row<T, MODE, DF>(g, a, nt, gr, RG, s.pxs, s.pys, F, wv, cp,
                                  sn, m2, sgn, bar, sw, regulate, outflow);
      else
        rn_acc += mod_row<T, MODE>(g, a, nt, gr, RG, s.pxs, s.pys, F, wv, cp,
                                   sn, m2, sgn, bar, rnv, zs, eta_r, sm,
                                   outflow);
    }
    // grad_rn[c, s]: the nodes of each cell added in node order
    __syncthreads();
    s.red[tid] = rn_acc;
    __syncthreads();
    for (int c = tid; c < nc; c += nt) {
      double v = 0.0;
      for (int rr = 0; rr < R; ++rr) v += s.red[c * R + rr];
      grad_rn[(size_t)(c0 + c) * S + sp] = (T)v;
    }
  }
  __syncthreads();
  // each cell's gradient: its nodes added in node order
  for (int i = tid; i < nc * NQ; i += nt) {
    const int c = i / NQ, k = i - c * NQ;
    double v = 0.0;
    for (int rr = 0; rr < R; ++rr) v += s.acc[(size_t)k * nt + c * R + rr];
    grad[(size_t)(c0 + c) * NQ + k] = (T)v;
  }
}

template <typename T, int DIM, int DF>
__global__ void __launch_bounds__(BLOCK)
feqmod_bwd_kernel(const T* __restrict__ cells, int n_cells, int CT,
                  const T* __restrict__ rn, const T* __restrict__ wcs,
                  const T* __restrict__ mass, const T* __restrict__ sign,
                  const T* __restrict__ baryon, const T* __restrict__ deg,
                  int S, const T* __restrict__ pT, int P,
                  const T* __restrict__ px, const T* __restrict__ py, int F,
                  const T* __restrict__ nodes,
                  const T* __restrict__ weights, int R, int sw, int regulate,
                  int outflow, T prefactor, const T* __restrict__ G,
                  T* __restrict__ grad, T* __restrict__ grad_rn) {
  feqmod_bwd_body<T, DIM == 3 ? FIXED3 : FIXED2, DF>(
      cells, n_cells, CT, rn, wcs, mass, sign, baryon, deg, S, pT, P, px, py,
      nullptr, nullptr, F, nodes, weights, R, sw, regulate, outflow,
      prefactor, T(1), G, grad, grad_rn);
}

template <typename T, int DF>
__global__ void __launch_bounds__(BLOCK)
feqmod_remap_bwd_kernel(const T* __restrict__ cells, int n_cells, int CT,
                        const T* __restrict__ rn, const T* __restrict__ wcs,
                        const T* __restrict__ mass,
                        const T* __restrict__ sign,
                        const T* __restrict__ baryon,
                        const T* __restrict__ deg, int S,
                        const T* __restrict__ pT, int P,
                        const T* __restrict__ cos_phi,
                        const T* __restrict__ sin_phi, int F,
                        const T* __restrict__ nodes,
                        const T* __restrict__ weights, int R, int sw,
                        int regulate, int outflow, T prefactor, T t_ref,
                        const T* __restrict__ G, T* __restrict__ grad,
                        T* __restrict__ grad_rn) {
  feqmod_bwd_body<T, REMAP, DF>(cells, n_cells, CT, rn, wcs, mass, sign,
                                baryon, deg, S, pT, P, nullptr, nullptr,
                                cos_phi, sin_phi, F, nodes, weights, R, sw,
                                regulate, outflow, prefactor, t_ref, G, grad,
                                grad_rn);
}

// cells a block, its threads and its shared memory for a shape, or an
// error code
template <typename T>
int blocking(int mode, int F, int R, int* CT, int* threads, size_t* smem) {
  if (R < 1 || R > BLOCK || F < 1) return cudaErrorInvalidValue;
  *CT = BLOCK / R;
  *threads = (*CT * R + 31) / 32 * 32;
  const Smem<T> s(nullptr, *threads, *CT, F, mode == FIXED3 ? R : 1);
  *smem = s.bytes(nullptr);
  return *smem > MAX_SMEM ? (int)cudaErrorInvalidValue : 0;
}

template <typename K, typename... Args>
int launch_(K kern, int n_cells, int CT, int threads, size_t smem,
            cudaStream_t stream, Args... args) {
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  const unsigned blocks = (unsigned)((n_cells + CT - 1) / CT);
  kern<<<blocks, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fixed(const void* cells, int n_cells, int nq, const void* rn,
                 const void* wcs, const void* mass, const void* sign,
                 const void* baryon, const void* deg, int S, const void* pT,
                 const void* px, const void* py, int P, int F,
                 const void* nodes, const void* weights, int R, int df,
                 int dim, int sw, int regulate, int outflow,
                 double prefactor, const void* G, void* grad, void* grad_rn,
                 void* stream_v) {
  if (nq != NQ || (df != 3 && df != 4) || (dim != 2 && dim != 3) ||
      sw < 0 || sw > 7 || n_cells < 0 || S < 1 || P < 1)
    return cudaErrorInvalidValue;
  if (n_cells == 0) return cudaSuccess;
  int CT, threads;
  size_t smem;
  const int rc = blocking<T>(dim == 3 ? FIXED3 : FIXED2, F, R, &CT, &threads,
                             &smem);
  if (rc != 0) return rc;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
#define IS3D_QBWD(DIM_, DF_)                                                  \
  launch_(feqmod_bwd_kernel<T, DIM_, DF_>, n_cells, CT, threads, smem,       \
          stream, (const T*)cells, n_cells, CT, (const T*)rn,                \
          (const T*)wcs, (const T*)mass, (const T*)sign, (const T*)baryon,   \
          (const T*)deg, S, (const T*)pT, P, (const T*)px, (const T*)py, F,  \
          (const T*)nodes, (const T*)weights, R, sw, regulate, outflow,      \
          (T)prefactor, (const T*)G, (T*)grad, (T*)grad_rn)
  if (dim == 3) return df == 3 ? IS3D_QBWD(3, 3) : IS3D_QBWD(3, 4);
  return df == 3 ? IS3D_QBWD(2, 3) : IS3D_QBWD(2, 4);
#undef IS3D_QBWD
}

template <typename T>
int launch_remap(const void* cells, int n_cells, int nq, const void* rn,
                 const void* wcs, const void* mass, const void* sign,
                 const void* baryon, const void* deg, int S, const void* pT,
                 int P, const void* cos_phi, const void* sin_phi, int F,
                 const void* nodes, const void* weights, int R, int df,
                 int sw, int regulate, int outflow, double prefactor,
                 double t_ref, const void* G, void* grad, void* grad_rn,
                 void* stream_v) {
  if (nq != NQ || (df != 3 && df != 4) || sw < 0 || sw > 7 || n_cells < 0 ||
      S < 1 || P < 1 || !(t_ref > 0.0))
    return cudaErrorInvalidValue;
  if (n_cells == 0) return cudaSuccess;
  int CT, threads;
  size_t smem;
  const int rc = blocking<T>(REMAP, F, R, &CT, &threads, &smem);
  if (rc != 0) return rc;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
#define IS3D_QBWD(DF_)                                                        \
  launch_(feqmod_remap_bwd_kernel<T, DF_>, n_cells, CT, threads, smem,       \
          stream, (const T*)cells, n_cells, CT, (const T*)rn,                \
          (const T*)wcs, (const T*)mass, (const T*)sign, (const T*)baryon,   \
          (const T*)deg, S, (const T*)pT, P, (const T*)cos_phi,              \
          (const T*)sin_phi, F, (const T*)nodes, (const T*)weights, R, sw,   \
          regulate, outflow, (T)prefactor, (T)t_ref, (const T*)G, (T*)grad,  \
          (T*)grad_rn)
  return df == 3 ? IS3D_QBWD(3) : IS3D_QBWD(4);
#undef IS3D_QBWD
}

}  // namespace

extern "C" {

// fixed nodes (3+1D, 2+1D): grad (n_cells, NQ) and grad_rn (n_cells,
// n_species) of <G, spectra>
#define IS3D_QBWD_ENTRY(NAME, T)                                              \
  int NAME(const void* cells, int n_cells, int nq, const void* rn,           \
           const void* wcs, const void* mass, const void* sign,              \
           const void* baryon, const void* deg, int S, const void* pT,       \
           const void* px, const void* py, int P, int F, const void* nodes,  \
           const void* weights, int R, int df, int dim, int sw,              \
           int regulate, int outflow, double prefactor, const void* G,       \
           void* grad, void* grad_rn, void* stream) {                        \
    return launch_fixed<T>(cells, n_cells, nq, rn, wcs, mass, sign, baryon,  \
                           deg, S, pT, px, py, P, F, nodes, weights, R, df,  \
                           dim, sw, regulate, outflow, prefactor, G, grad,   \
                           grad_rn, stream);                                 \
  }
IS3D_QBWD_ENTRY(is3d_feqmod_bwd_f32, float)
IS3D_QBWD_ENTRY(is3d_feqmod_bwd_f64, double)
#undef IS3D_QBWD_ENTRY

// the 2+1D mT remap: the nodes eta_r move per (cell, species, pT)
#define IS3D_QBWD_REMAP_ENTRY(NAME, T)                                        \
  int NAME(const void* cells, int n_cells, int nq, const void* rn,           \
           const void* wcs, const void* mass, const void* sign,              \
           const void* baryon, const void* deg, int S, const void* pT,       \
           int P, const void* cos_phi, const void* sin_phi, int F,           \
           const void* nodes, const void* weights, int R, int df, int sw,    \
           int regulate, int outflow, double prefactor, double t_ref,        \
           const void* G, void* grad, void* grad_rn, void* stream) {         \
    return launch_remap<T>(cells, n_cells, nq, rn, wcs, mass, sign, baryon,  \
                           deg, S, pT, P, cos_phi, sin_phi, F, nodes,        \
                           weights, R, df, sw, regulate, outflow, prefactor, \
                           t_ref, G, grad, grad_rn, stream);                 \
  }
IS3D_QBWD_REMAP_ENTRY(is3d_feqmod_bwd_remap_f32, float)
IS3D_QBWD_REMAP_ENTRY(is3d_feqmod_bwd_remap_f64, double)
#undef IS3D_QBWD_REMAP_ENTRY

const char* is3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
