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
// Design: a per-cell reduction (K9a's, smooth_spectra_bwd.cu) with the
// cotangent staged a tile at a time.
//   * A thread owns one (cell, node) pair and walks every (species, pT,
//     phi); a block holds CT cells x all nodes, so nothing of a cell's sum
//     leaves the block.
//   * One chain a launch.  The wrapper splits a group's cells by chain on
//     the card (kernels/feqmod.py:bwd_chain_split: a stable sort of the
//     cells by chain and the parts' offsets, which the kernel reads, so
//     the host never waits): breakdown cells take the fallback (CHAIN =
//     FB), clean cells f_mod (MOD) and, in 3+1D, clean cells with detA <
//     0.01, whose narrow nodes take the fallback, the two-chain body
//     (MIX).  An instantiation holds only its chain's registers and no warp
//     diverges on the chain outside MIX.  Each launch's grid covers the
//     group; the blocks past its part return at once.
//   * The species loop is outermost, so a thread's share of grad_rn[c, s]
//     is one float64 register; after each species the block adds the
//     nodes of each cell in node order through shared memory and writes
//     the entry.
//   * G is staged a tile at a time: a species' P rows (2+1D: P x F values)
//     or, in 3+1D where G has the node axis, PT3 = 4 of its rows (4 beat 8
//     by A/B: smaller buffers, one more block an SM), copied with cp.async
//     into one of two buffers while the other is consumed, beside the
//     tile's mT and the remap's s(mT): one barrier a tile, not two a row.
//     The momentum points (px, py; the remap's pT cos phi, pT sin phi) are
//     staged once a block.
//   * The fallback's terms are compile-time where they are the main
//     paths' shear + bulk (FSW), so its instantiation holds no branch or
//     register for the others; other switch sets read them at run time.
//   * The accumulator.  One cell's gradient sums S x P x F x nodes terms
//     (5.2e6 in 3+1D at 320 x 32 x 24 x 21, 1.2e7 with the 48-node remap).
//     The sums over the n_phi points of a row run in T (24 terms); each
//     row's sums times its node kinematics are added in T to registers,
//     one a column the chain touches (f_mod 23, the fallback 36: QCols).
//     Once a species the threads put them in shared memory and the block
//     adds each cell's nodes in node order, in float64, to the cell's
//     float64 accumulators (NC x CT, not NC x threads: shared memory stays
//     small enough for more blocks an SM).  In float32 a register so holds
//     a species' P x F = 768 terms (32 row products of 24-term sums)
//     before float64 takes over: its rounding error is at most ~768 x
//     2^-24 = 5e-5 of the species' sum of magnitudes and typically
//     ~sqrt(768) x 2^-24 = 2e-6, inside the 2e-4 the checks allow; the
//     float64 sums over the nodes and species add nothing to it.
//   * No atomics.  One thread owns each (cell, slot) accumulator and adds
//     the species in order, and one thread writes each entry: two launches
//     give identical bits, and a cell's gradient depends on its own row
//     alone, not on its place in the group or on the cells beside it.
//   * float32 takes the forward kernel's instructions (folded.cuh's
//     Fn<float>, feqmod.cuh's fq_sqrt): ex2.approx, rcp.approx (1 / E too)
//     and sqrt.approx for E, +inf -> 0; float64 keeps IEEE arithmetic.

#include <cuda_runtime.h>

#include "bwd_stage.cuh"
#include "feqmod.cuh"

namespace {

using namespace is3d;

constexpr int BLOCK = 128;       // most threads a block: CT cells x nodes
constexpr int PT3 = 4;           // pT rows a tile in 3+1D
constexpr size_t MAX_SMEM = 232448;

enum Mode { FIXED3 = 0, FIXED2 = 1, REMAP = 2 };
// the chain of a launch's cells: f_mod, the fallback, both (3+1D narrow)
enum Chain { MOD = 0, FB = 1, MIX = 2 };

// the columns a chain touches (FqField order): f_mod eta .. alphaB_mod;
// the fallback tau .. dsigma_y and u^t .. y_flow
template <int CHAIN> struct QCols;
template <> struct QCols<MOD> : Cols<Q_ETA, Q_UT> {};
template <> struct QCols<FB> : Cols<Q_TAU, Q_BD, Q_UT, NQ> {};
template <> struct QCols<MIX> : Cols<0, NQ> {};

__host__ __device__ constexpr int n_slots(int chain) {
  return chain == MOD ? QCols<MOD>::N : chain == FB ? QCols<FB>::N
                                                    : QCols<MIX>::N;
}

// shared memory: the per-node grad_rn shares of a species, the momentum
// points (stage_points), the float64 accumulators (NC slots of the block's
// CT cells), a species' per-node sums (NC slots of nt), the block's cell
// rows, two stage buffers (a tile of G, its rows' mT, s(mT)) and the
// block's cell indices
template <typename T>
struct Smem {
  double *red, *acc;
  Pt2<T>* tab;
  T *sums, *raw, *stage;
  int* cid;
  int SB;
  __host__ __device__ Smem(unsigned char* p, int nt, int NC, int CT, int P,
                           int F, int PT, int RG) {
    red = reinterpret_cast<double*>(p);
    tab = reinterpret_cast<Pt2<T>*>(red + nt);
    acc = reinterpret_cast<double*>(tab + P * F);
    sums = reinterpret_cast<T*>(acc + NC * CT);
    raw = sums + (size_t)NC * nt;
    stage = raw + CT * NQ;
    SB = PT * F * RG + 2 * PT;
    cid = reinterpret_cast<int*>(stage + 2 * SB);
  }
  __host__ __device__ size_t bytes(const unsigned char* p, int CT) const {
    return reinterpret_cast<const unsigned char*>(cid + CT) - p;
  }
};

// the f_mod chain over one row (species, pT) of a thread's (cell, node):
// cp, sn the node kinematics, zs the remap's zscale (1 at fixed nodes), tb
// the row's momentum points; adds the row's products to the slots
// ra and returns its share of grad_rn; sm the remap's s(mT) (d Delta / d
// zscale = s(mT) eta_r there)
template <typename T, int MODE, class C>
__device__ __forceinline__ T mod_row(
    const T* g, T* ra, const T* gs, int gstride, const Pt2<T>* tb, int F,
    T w, T cp, T sn, T m2, T sgn, T bar, T rnv, T zs, T eta_r, T sm,
    int outflow) {
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
    const T x = tb[f].x, y = tb[f].y;
    const T pds = A + dax * x + day * y;
    T X[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) X[k] = al[k] + gxk[k] * x + gyk[k] * y;
    const T x2 = X[0] * X[0] + X[1] * X[1] + X[2] * X[2];
    // saturated |x|^2 (NaN, inf): E = inf as in the forward, so f_mod is
    // rn / (e^(+-inf) + sign) (0, or rn / sign where 1/T_mod < 0)
    const bool sat = !(x2 < Fx::inf());
    const T E = sat ? Fx::inf() : fq_sqrt(m2 + x2);
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
    const T h = E > T(0) ? garg * invTm * Fx::rcp(E) : T(0);
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
  if (!hit) return T(0);
  radd<C, Q_DAT>(ra, cp * tP);
  radd<C, Q_DANT>(ra, sn * tP);
  radd<C, Q_DAX>(ra, tPx);
  radd<C, Q_DAY>(ra, tPy);
  T gdel = (sn * dat + cp * dant) * tP;
  static_assert(C::slot(Q_A2) == C::slot(Q_A0) + 2 &&
                C::slot(Q_B2) == C::slot(Q_B0) + 2 &&
                C::slot(Q_GX2) == C::slot(Q_GX0) + 2 &&
                C::slot(Q_GY2) == C::slot(Q_GY0) + 2, "x's columns");
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ra[C::slot(Q_A0) + k] += cp * tX[k];
    ra[C::slot(Q_B0) + k] += sn * tX[k];
    ra[C::slot(Q_GX0) + k] += tXx[k];
    ra[C::slot(Q_GY0) + k] += tXy[k];
    gdel += (sn * g[Q_A0 + k] + cp * g[Q_B0 + k]) * tX[k];
  }
  radd<C, Q_INVTM>(ra, tIT);
  radd<C, Q_ABM>(ra, -(bar * tG));
  if (MODE == FIXED3) radd<C, Q_ETA>(ra, -gdel);         // Delta = y - eta
  if (MODE == FIXED2) radd<C, Q_SCALE>(ra, -(eta_r * gdel));  // -scale eta
  if (MODE == REMAP) {
    // Delta = y_flow + zscale s(mT) eta_r, and zscale multiplies f_mod
    radd<C, Q_YFM>(ra, gdel);
    radd<C, Q_SCALE>(ra, sm * eta_r * gdel + tS);
  }
  return tRn;
}

// the linearized fallback over one row (species, pT) of a thread's (cell,
// node) at the unscaled node (cp, sn); adds the row's products to the
// slots ra.  FSW: the terms sw as a compile-time constant, or -1 (sw read
// at run time)
template <typename T, int MODE, int DF, int FSW, class C>
__device__ __forceinline__ void fallback_row(
    const T* g, T* ra, const T* gs, int gstride, const Pt2<T>* tb, int F,
    T w, T cp, T sn, T m2, T sgn, T bar, int sw_, int regulate,
    int outflow) {
  using Fx = Fn<T>;
  const T L = Fx::SCALE;
  const int sw = FSW >= 0 ? FSW : sw_;
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
    const T x = tb[f].x, y = tb[f].y;
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
  const T Cp = cp, Sn = sn, td = tau, two = T(2);
  radd<C, Q_DAT>(ra, Cp * tP);
  radd<C, Q_DANT>(ra, Sn * tP);
  radd<C, Q_DAX>(ra, tPx);
  radd<C, Q_DAY>(ra, tPy);
  radd<C, Q_UT>(ra, Cp * tU);
  radd<C, Q_TUN>(ra, -(Sn * tU));
  radd<C, Q_UX>(ra, -tUx);
  radd<C, Q_UY>(ra, -tUy);
  radd<C, Q_INVT>(ra, tIT);
  if (DF == 3) radd<C, Q_ALPHAB>(ra, -tA);
  radd<C, Q_KSH>(ra, tKsh);
  radd<C, Q_KF>(ra, tKF);
  radd<C, Q_KG>(ra, tKG);
  radd<C, Q_K3>(ra, tK3);
  radd<C, Q_BULKPI>(ra, tPi);
  radd<C, Q_BENTH>(ra, tBe);
  radd<C, Q_KV>(ra, tKV);
  radd<C, Q_DZ>(ra, tDz);
  radd<C, Q_DL>(ra, tDl);
  T gdel = (Sn * dat + Cp * dant) * tP + (Sn * ut - Cp * tun) * tU;
  if (shear) {
    radd<C, Q_PITT>(ra, Cp * Cp * tQ);
    radd<C, Q_PINN>(ra, td * td * Sn * Sn * tQ);
    radd<C, Q_PITN>(ra, -(two * td * Cp * Sn * tQ));
    radd<C, Q_PITX>(ra, -(two * Cp * tQx));
    radd<C, Q_PIXN>(ra, two * td * Sn * tQx);
    radd<C, Q_PITY>(ra, -(two * Cp * tQy));
    radd<C, Q_PIYN>(ra, two * td * Sn * tQy);
    radd<C, Q_PIXX>(ra, tQxx);
    radd<C, Q_PIYY>(ra, tQyy);
    radd<C, Q_PIXY>(ra, two * tQxy);
    radd<C, Q_TAU>(ra, two * td * pinn * Sn * Sn * tQ
                       - two * pitn * Cp * Sn * tQ + two * pixn * Sn * tQx
                       + two * piyn * Sn * tQy);
    gdel += (two * Cp * Sn * pitt + two * td * td * Sn * Cp * pinn
             - two * td * (Sn * Sn + Cp * Cp) * pitn) * tQ
            - two * (Sn * pitx - td * Cp * pixn) * tQx
            - two * (Sn * pity - td * Cp * piyn) * tQy;
  }
  if (diff) {
    radd<C, Q_VT>(ra, Cp * tV);
    radd<C, Q_VN>(ra, -(td * Sn * tV));
    radd<C, Q_VX>(ra, -tVx);
    radd<C, Q_VY>(ra, -tVy);
    radd<C, Q_TAU>(ra, -(Vn * Sn * tV));
    gdel += (Sn * Vt - td * Cp * Vn) * tV;
  }
  if (MODE == FIXED3) radd<C, Q_ETA>(ra, -gdel);         // Delta = y - eta
  if (MODE == REMAP) radd<C, Q_YFLOW>(ra, gdel);        // y_flow - s eta_r
}

// grid (blocks of CT cells of the launch's part: the cells order[offs[part]
// ..offs[part + 1]) ); thread t owns cell t / R of the block at node t % R.
// xt, yt: px, py (n_pT, n_phi) at fixed nodes, cos, sin phi (n_phi) with
// the remap
template <typename T, int MODE, int DF, int CHAIN, int FSW>
__device__ __forceinline__ void feqmod_bwd_body(
    const T* __restrict__ cells, int CT, const int* __restrict__ order,
    const int* __restrict__ offs, const T* __restrict__ rn,
    const T* __restrict__ wcs, const T* __restrict__ mass,
    const T* __restrict__ sign, const T* __restrict__ baryon,
    const T* __restrict__ deg, int S, const T* __restrict__ pT, int P,
    const T* __restrict__ xt, const T* __restrict__ yt, int F,
    const T* __restrict__ nodes, const T* __restrict__ weights, int R,
    int sw, int regulate, int outflow, T prefactor, T t_ref,
    const T* __restrict__ G, T* __restrict__ grad,
    T* __restrict__ grad_rn) {
  using C = QCols<CHAIN>;
  constexpr int NC = C::N;
  constexpr bool RG1 = MODE != FIXED3;           // G has no node axis
  const int RG = RG1 ? 1 : R;
  const int PT = MODE == FIXED3 ? min(PT3, P) : P;
  const int TP = (P + PT - 1) / PT;              // tiles a species
  const int base = offs[CHAIN];
  const int n_part = offs[CHAIN + 1] - base;
  const int c0 = blockIdx.x * CT;
  if (c0 >= n_part) return;                      // past the chain's cells
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const Smem<T> s(smem_raw, nt, NC, CT, P, F, PT, RG);
  const int nc = min(CT, n_part - c0);
  const bool active = tid < nc * R;
  const int ci = active ? tid / R : 0, r = active ? tid - ci * R : 0;

  // tile k: G's rows (cp.async into buffer k & 1) and their mT, s(mT)
  auto issue = [&](int k) {
    const int sp = k / TP, p0 = (k - sp * TP) * PT;
    const int rows = min(PT, P - p0);
    T* dst = s.stage + (k & 1) * s.SB;
    const T* src = G + ((size_t)sp * P + p0) * F * RG;
    const int n = rows * F * RG;
    for (int i = tid; i < n; i += nt) cp_async_elem(dst + i, src + i);
    cp_async_commit();
    T* mts = dst + PT * F * RG;
    const T m2 = mass[sp] * mass[sp];
    for (int i = tid; i < rows; i += nt) {
      const T pt = pT[p0 + i];
      const T mT = d_sqrt(m2 + pt * pt);
      mts[i] = mT;
      // s(mT) of the remap's node map (kernels/smooth.py:remap_scale): the
      // nodes' scale and, on the reduced output, the jacobian
      mts[PT + i] = MODE == REMAP
                        ? d_sqrt(t_ref / (mT > t_ref ? mT : t_ref)) : T(1);
    }
  };

  for (int i = tid; i < CT; i += nt) s.cid[i] = order[base + c0 + min(i, nc - 1)];
  for (int i = tid; i < CT * NQ; i += nt) {
    const int c = min(i / NQ, nc - 1);
    s.raw[i] = cells[(size_t)order[base + c0 + c] * NQ + (i - (i / NQ) * NQ)];
  }
  stage_points(s.tab, static_cast<T*>(nullptr), xt, yt, pT, P, F,
               MODE == REMAP, tid, nt);
  for (int i = tid; i < NC * CT; i += nt) s.acc[i] = 0.0;
  issue(0);
  __syncthreads();
  const T* g = s.raw + ci * NQ;
  const int cell = s.cid[ci];
  const T eta_r = nodes[r];
  const T w = MODE == FIXED3 ? T(1) : weights[r];
  // the thread's chain: the launch's, but in MIX the fallback on a
  // breakdown cell and at the narrow nodes (|y - eta| < detA < 0.01) of a
  // 3+1D cell; f_mod elsewhere
  bool fb = CHAIN == FB;
  T ch = T(1), sh = T(0);
  if (MODE != REMAP) {
    const T du = MODE == FIXED3 ? eta_r - g[Q_ETA] : -eta_r;
    if (CHAIN == MIX)
      fb = g[Q_BD] != T(0) ||
           (MODE == FIXED3 && g[Q_DETA] < T(0.01) && fabs(du) < g[Q_DETA]);
    const T delta = (fb || MODE == FIXED3) ? du : -(g[Q_SCALE] * eta_r);
    ch = d_cosh(delta);
    sh = d_sinh(delta);
  }
  const T zs = MODE == REMAP ? g[Q_SCALE] : T(1);

  T ra[NC];
  double rn_acc = 0.0;
  T m2 = T(0), sgn = T(0), bar = T(0), dg = T(0), rnv = T(0), wcv = T(0);
  const int n_tiles = S * TP;
  for (int k = 0; k < n_tiles; ++k) {
    const int sp = k / TP, p0 = (k - sp * TP) * PT;
    const int rows = min(PT, P - p0);
    cp_async_wait_all();
    __syncthreads();              // tile k has landed, tile k - 1 is consumed
    if (k + 1 < n_tiles) issue(k + 1);
    if (p0 == 0) {
#pragma unroll
      for (int j = 0; j < NC; ++j) ra[j] = T(0);
      rn_acc = 0.0;
      m2 = mass[sp] * mass[sp];
      sgn = sign[sp];
      bar = baryon[sp];
      dg = prefactor * deg[sp];
      const size_t cs = (size_t)cell * S + sp;
      rnv = active ? rn[cs] : T(0);
      wcv = active ? wcs[cs] : T(0);
    }
    if (active && wcv != T(0)) {
      const T* st = s.stage + (k & 1) * s.SB;
      const T* mts = st + PT * F * RG;
      for (int q = 0; q < rows; ++q) {
        const T mT = mts[q], sm = mts[PT + q];
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
          const T em = Fn<T>::rcp(e);
          cp = T(0.5) * mT * (e + em);
          sn = T(0.5) * mT * (e - em);
        }
        const T* gr = st + q * F * RG + (RG1 ? 0 : r);
        const Pt2<T>* tb = s.tab + (p0 + q) * F;
        const T wv = (dg * sm) * (w * wcv);
        if constexpr (CHAIN == FB) {
          fallback_row<T, MODE, DF, FSW, C>(g, ra, gr, RG, tb, F, wv, cp, sn,
                                            m2, sgn, bar, sw, regulate,
                                            outflow);
        } else if constexpr (CHAIN == MOD) {
          rn_acc += mod_row<T, MODE, C>(g, ra, gr, RG, tb, F, wv, cp, sn, m2,
                                        sgn, bar, rnv, zs, eta_r, sm,
                                        outflow);
        } else {
          if (fb)
            fallback_row<T, MODE, DF, FSW, C>(g, ra, gr, RG, tb, F, wv, cp,
                                              sn, m2, sgn, bar, sw, regulate,
                                              outflow);
          else
            rn_acc += mod_row<T, MODE, C>(g, ra, gr, RG, tb, F, wv, cp, sn,
                                          m2, sgn, bar, rnv, zs, eta_r, sm,
                                          outflow);
        }
      }
    }
    if (p0 + rows == P) {         // the species' last tile: into float64
#pragma unroll
      for (int j = 0; j < NC; ++j) s.sums[(size_t)j * nt + tid] = ra[j];
      s.red[tid] = rn_acc;
      __syncthreads();
      // each cell's nodes in node order: a thread owns (cell, slot) pairs
      for (int i = tid; i < nc * NC; i += nt) {
        const int c = i / NC, j = i - c * NC;
        const T* v = s.sums + (size_t)j * nt + c * R;
        double sum = 0.0;
        for (int rr = 0; rr < R; ++rr) sum += (double)v[rr];
        s.acc[j * CT + c] += sum;
      }
      // grad_rn[c, sp]
      for (int c = tid; c < nc; c += nt) {
        double v = 0.0;
        for (int rr = 0; rr < R; ++rr) v += s.red[c * R + rr];
        grad_rn[(size_t)s.cid[c] * S + sp] = (T)v;
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
  // each cell's gradient (0 in the columns the chain never touches)
  for (int i = tid; i < nc * NQ; i += nt) {
    const int c = i / NQ, k = i - c * NQ;
    const int j = C::slot(k);
    grad[(size_t)s.cid[c] * NQ + k] = (T)(j >= 0 ? s.acc[j * CT + c] : 0.0);
  }
}

#define IS3D_QBWD_PARAMS                                                      \
  const T *__restrict__ cells, int CT, const int *__restrict__ order,        \
      const int *__restrict__ offs, const T *__restrict__ rn,                \
      const T *__restrict__ wcs, const T *__restrict__ mass,                 \
      const T *__restrict__ sign, const T *__restrict__ baryon,              \
      const T *__restrict__ deg, int S, const T *__restrict__ pT, int P,     \
      const T *__restrict__ xt, const T *__restrict__ yt, int F,             \
      const T *__restrict__ nodes, const T *__restrict__ weights, int R,     \
      int sw, int regulate, int outflow, T prefactor, T t_ref,               \
      const T *__restrict__ G, T *__restrict__ grad, T *__restrict__ grad_rn
#define IS3D_QBWD_ARGS                                                        \
  cells, CT, order, offs, rn, wcs, mass, sign, baryon, deg, S, pT, P, xt,    \
      yt, F, nodes, weights, R, sw, regulate, outflow, prefactor, t_ref, G,  \
      grad, grad_rn

// FSW: the fallback's terms at compile time (SW_SHEAR | SW_BULK, the main
// paths'), or -1 (read at run time); f_mod ignores it
template <typename T, int DIM, int DF, int CHAIN, int FSW>
__global__ void __launch_bounds__(BLOCK)
feqmod_bwd_kernel(IS3D_QBWD_PARAMS) {
  feqmod_bwd_body<T, DIM == 3 ? FIXED3 : FIXED2, DF, CHAIN, FSW>(
      IS3D_QBWD_ARGS);
}

template <typename T, int DF, int CHAIN, int FSW>
__global__ void __launch_bounds__(BLOCK)
feqmod_remap_bwd_kernel(IS3D_QBWD_PARAMS) {
  feqmod_bwd_body<T, REMAP, DF, CHAIN, FSW>(IS3D_QBWD_ARGS);
}

// cells a block, its threads and its shared memory for a shape, or an
// error code
template <typename T>
int blocking(int mode, int chain, int P, int F, int R, int* CT, int* threads,
             size_t* smem) {
  if (R < 1 || R > BLOCK || F < 1 || P < 1) return cudaErrorInvalidValue;
  *CT = BLOCK / R;
  *threads = (*CT * R + 31) / 32 * 32;
  const int PT = mode == FIXED3 ? (P < PT3 ? P : PT3) : P;
  const Smem<T> s(nullptr, *threads, n_slots(chain), *CT, P, F, PT,
                  mode == FIXED3 ? R : 1);
  *smem = s.bytes(nullptr, *CT);
  return *smem > MAX_SMEM ? (int)cudaErrorInvalidValue : 0;
}

// the fallback's compile-time terms of a launch (FSW)
constexpr int FAST_SW = SW_SHEAR | SW_BULK;

// the kernel of (T, mode, df, chain, the fallback's terms sw), or nullptr
template <typename T, int DF, int CH, int FSW>
const void* kernel_in(int mode) {
  return mode == FIXED3 ? (const void*)feqmod_bwd_kernel<T, 3, DF, CH, FSW>
         : mode == FIXED2 ? (const void*)feqmod_bwd_kernel<T, 2, DF, CH, FSW>
                          : (const void*)feqmod_remap_bwd_kernel<T, DF, CH,
                                                                 FSW>;
}

template <typename T>
const void* kernel_of(int mode, int df, int chain, int sw) {
  if (df != 3 && df != 4) return nullptr;
  const bool fast = sw == FAST_SW;
  if (chain == MIX) {
    if (mode != FIXED3) return nullptr;
    if (df == 3)
      return fast ? (const void*)feqmod_bwd_kernel<T, 3, 3, MIX, FAST_SW>
                  : (const void*)feqmod_bwd_kernel<T, 3, 3, MIX, -1>;
    return fast ? (const void*)feqmod_bwd_kernel<T, 3, 4, MIX, FAST_SW>
                : (const void*)feqmod_bwd_kernel<T, 3, 4, MIX, -1>;
  }
  if (chain == MOD)
    return df == 3 ? kernel_in<T, 3, MOD, -1>(mode)
                   : kernel_in<T, 4, MOD, -1>(mode);
  if (chain == FB) {
    if (df == 3)
      return fast ? kernel_in<T, 3, FB, FAST_SW>(mode)
                  : kernel_in<T, 3, FB, -1>(mode);
    return fast ? kernel_in<T, 4, FB, FAST_SW>(mode)
                : kernel_in<T, 4, FB, -1>(mode);
  }
  return nullptr;
}

// one chain's launch over the group: a block for every CT cells of the
// group (the blocks past the part's count return at once)
template <typename T>
int launch_chain(int mode, int df, int chain, int sw, int n_cells, int P,
                 int F, int R, cudaStream_t stream, void** args) {
  const void* kern = kernel_of<T>(mode, df, chain, sw);
  if (kern == nullptr) return cudaErrorInvalidValue;
  int CT, threads;
  size_t smem;
  const int rc = blocking<T>(mode, chain, P, F, R, &CT, &threads, &smem);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  *static_cast<int*>(args[1]) = CT;
  const unsigned blocks = (unsigned)((n_cells + CT - 1) / CT);
  e = cudaLaunchKernel(kern, dim3(blocks), dim3(threads), args, smem,
                       stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int mode, const void* cells, int n_cells, int nq,
           const void* order, const void* offs, int chain, const void* rn,
           const void* wcs, const void* mass, const void* sign,
           const void* baryon, const void* deg, int S, const void* pT, int P,
           const void* xt, const void* yt, int F, const void* nodes,
           const void* weights, int R, int df, int sw, int regulate,
           int outflow, double prefactor, double t_ref, const void* G,
           void* grad, void* grad_rn, void* stream_v) {
  if (nq != NQ || (df != 3 && df != 4) || sw < 0 || sw > 7 || n_cells < 0 ||
      S < 1 || P < 1 || chain < MOD || chain > MIX ||
      (mode == REMAP && !(t_ref > 0.0)))
    return cudaErrorInvalidValue;
  if (n_cells == 0) return cudaSuccess;
  const T* cells_ = static_cast<const T*>(cells);
  int CT = 0;
  const int* order_ = static_cast<const int*>(order);
  const int* offs_ = static_cast<const int*>(offs);
  const T* rn_ = static_cast<const T*>(rn);
  const T* wcs_ = static_cast<const T*>(wcs);
  const T* mass_ = static_cast<const T*>(mass);
  const T* sign_ = static_cast<const T*>(sign);
  const T* baryon_ = static_cast<const T*>(baryon);
  const T* deg_ = static_cast<const T*>(deg);
  const T* pT_ = static_cast<const T*>(pT);
  const T* xt_ = static_cast<const T*>(xt);
  const T* yt_ = static_cast<const T*>(yt);
  const T* nodes_ = static_cast<const T*>(nodes);
  const T* weights_ = static_cast<const T*>(weights);
  T prefactor_ = (T)prefactor, t_ref_ = (T)t_ref;
  const T* G_ = static_cast<const T*>(G);
  T* grad_ = static_cast<T*>(grad);
  T* grad_rn_ = static_cast<T*>(grad_rn);
  void* args[] = {&cells_, &CT, &order_, &offs_, &rn_, &wcs_, &mass_,
                  &sign_, &baryon_, &deg_, &S, &pT_, &P, &xt_, &yt_, &F,
                  &nodes_, &weights_, &R, &sw, &regulate, &outflow,
                  &prefactor_, &t_ref_, &G_, &grad_, &grad_rn_};
  return launch_chain<T>(mode, df, chain, sw, n_cells, P, F, R,
                         static_cast<cudaStream_t>(stream_v), args);
}

// out: cells a block, threads, shared memory bytes, resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers a thread and
// local memory bytes a thread (spills) of one instantiation at one shape
template <typename T>
int props(int mode, int df, int chain, int sw, int P, int F, int R,
          int* out) {
  const void* kern = kernel_of<T>(mode, df, chain, sw);
  if (kern == nullptr) return cudaErrorInvalidValue;
  int CT, threads;
  size_t smem;
  const int rc = blocking<T>(mode, chain, P, F, R, &CT, &threads, &smem);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return (int)e;
  out[0] = CT;
  out[1] = threads;
  out[2] = (int)smem;
  out[3] = blocks;
  out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;
  return 0;
}

}  // namespace

extern "C" {

// one chain's part of a group: grad (n_cells, NQ) and grad_rn (n_cells,
// n_species) of <G, spectra> at the cells order[offs[chain] ..
// offs[chain + 1]) (kernels/feqmod.py:bwd_chain_split); dim 3 or 2 fixed
// nodes (xt, yt = px, py), or the 2+1D mT remap with dim = 0 (xt, yt =
// cos, sin phi; the nodes eta_r move per (cell, species, pT))
#define IS3D_QBWD_ENTRY(NAME, T)                                              \
  int NAME(const void* cells, int n_cells, int nq, const void* order,        \
           const void* offs, int chain, const void* rn, const void* wcs,     \
           const void* mass, const void* sign, const void* baryon,           \
           const void* deg, int S, const void* pT, int P, const void* xt,    \
           const void* yt, int F, const void* nodes, const void* weights,    \
           int R, int df, int dim, int sw, int regulate, int outflow,        \
           double prefactor, double t_ref, const void* G, void* grad,        \
           void* grad_rn, void* stream) {                                    \
    const int mode = dim == 3 ? FIXED3 : dim == 2 ? FIXED2 : REMAP;          \
    if (dim != 0 && dim != 2 && dim != 3) return cudaErrorInvalidValue;     \
    return launch<T>(mode, cells, n_cells, nq, order, offs, chain, rn, wcs,  \
                     mass, sign, baryon, deg, S, pT, P, xt, yt, F, nodes,    \
                     weights, R, df, sw, regulate, outflow, prefactor,       \
                     t_ref, G, grad, grad_rn, stream);                       \
  }
IS3D_QBWD_ENTRY(is3d_feqmod_bwd_f32, float)
IS3D_QBWD_ENTRY(is3d_feqmod_bwd_f64, double)
#undef IS3D_QBWD_ENTRY

// props<T> of (f64, dim as in the launch entry, df, chain, the fallback's
// terms sw) at (P, F, R)
int is3d_feqmod_bwd_props(int f64, int dim, int df, int chain, int sw,
                          int P, int F, int R, int* out) {
  if (dim != 0 && dim != 2 && dim != 3) return cudaErrorInvalidValue;
  const int mode = dim == 3 ? FIXED3 : dim == 2 ? FIXED2 : REMAP;
  return f64 ? props<double>(mode, df, chain, sw, P, F, R, out)
             : props<float>(mode, df, chain, sw, P, F, R, out);
}

const char* is3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
