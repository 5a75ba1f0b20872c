// The backward pass of the smooth Cooper-Frye spectra (linear delta-f, df 1
// and 2) for Hopper (sm_90a), float32 and float64: the gradient of <G,
// spectra> with respect to the packed cells.
//
// Replaces what JAX runs for the reverse pass of the spectra: XLA's reverse
// of the chunk body under jax.checkpoint (is3d_tpu/kernels/smooth.py:426-451,
// driven by is3d_tpu/diff.py:108-169), for the fixed-node kernel
// (spectra_bwd_kernel: 3+1D and 2+1D fixed nodes) and the 2+1D mT remap
// (remap_bwd_kernel, the reverse of smooth.py:161).  Like JAX's remat it
// keeps no forward intermediates: it recomputes the emission value at every
// (cell, node, species, point) from the packed cells and chains through it.
//
// Inputs (built by is3d_tpu_torch/kernels/smooth.py): cells (n_cells, NF)
// in the order of emission.cuh's `Field`; the species and momentum
// constants of the forward; G (n_species, n_pT, n_phi, n_out), the output's
// cotangent (n_out = n_nodes in 3+1D, 1 in 2+1D); the remap's node table
// (n_species, n_pT, n_nodes, 2) = exp(-s eta_r), exp(+s eta_r).
// Output: grad (n_cells, NF), every row written once.
//
// The formula.  With g = prefactor deg_s w_node [s(mT)] G the weighted
// cotangent of one evaluation, contrib = max(p.dsigma, 0) f the emission
// value, f = feq (1 + clamp(feqbar df, -1, 1)), feq = 1 / (e^arg + sign),
// arg = u.p / T - b alphaB, every cell field x_k gets
//     grad[c, k] = sum over (node, species, pT, phi) of g d contrib / d x_k,
// by the chain rule through the four point terms p.dsigma, u.p, pi:pp and
// V.p (smooth.py:emission_terms) and the per-cell scalars (1/T, alphaB, the
// df coefficients, bulkPi, nB/(E+P)).  Every convention is the plain
// version's under torch autograd (smooth.py:plain_block): d max(x, 0)/dx =
// 1 at x >= 0, d clamp(x, -1, 1)/dx = 1 on [-1, 1], and the occupation's
// derivative is the JAX package's (common.fermi_bose: -feq feqbar, exactly
// 0 where e^arg overflows).
//
// What bounds it on this card: FP32 issue.  Each evaluation recomputes the
// forward (~20 FP32, an exp and one or two reciprocals) and adds ~35 FP32
// operations of chain rule and sums (kernels/smooth.py,
// BACKWARD_FORMULA_OPS; with the remap REMAP_BACKWARD_EXTRA more an
// evaluation and REMAP_BACKWARD_ROW_OPS a (species, pT) row); no bytes to
// speak of: a group's cells are 2.4 MB and G, read once per block of
// cells, stays in L2.
//
// Design of the fixed-node kernel (K9a, spectra_bwd_kernel).
//   * A per-cell reduction over momentum points, the shape of dndx.cu's
//     percell_kernel: a thread owns one (cell, node) pair and walks every
//     (pT, phi, species); a block holds CT cells x all nodes, so nothing
//     of a cell's sum leaves the block.  The node kinematics (cosh, sinh
//     of Delta) are the thread's constants and the sums that need them are
//     formed per node (SP .. SV below), then multiplied by cosh and sinh
//     once at the end.
//   * Staging.  Per pT row the block stages the weighted cotangent of a
//     chunk of SB species (all phi, all nodes in 3+1D), the species' mT,
//     and per (cell, phi) the terms W1, -W2, C4, -D2 that do not depend on
//     the node or the species: they are the same for every thread of a
//     cell, so each is formed once per block.
//   * The accumulator.  One cell's gradient sums S x P x F x nodes terms
//     (5.2e6 in 3+1D at 320 x 32 x 24 x 21).  The sums run in T over the
//     SB species of one (pT, phi) point and are carried in float64 across
//     points, so a float32 sum is never longer than SB terms.
//
// Design of the 2+1D mT remap (K9b, remap_bwd_kernel), where the nodes
// move with (cell, species, pT): Delta = y_flow - s(mT) eta_r.
//   * A thread owns one (cell, node) pair as above (REMAP_BLOCK threads a
//     block, CT = REMAP_BLOCK / R cells) and walks species, then pT rows,
//     then phi, as K11b (vah_bwd.cu).  Per (species, pT) row it forms the
//     node kinematics mT cosh Delta, mT sinh Delta from the node table
//     (two products) and the composites of the four point terms once;
//     its n_phi points then run the fixed-node body, each point term one
//     FMA from the row's composite and a (cell, phi) term at unit pT
//     staged once a block (pi:pp's px part as pT mT cosh g + pT mT sinh h).
//   * Staging: a species' G (P x F), its node table (P x R x 2) by
//     cp.async into one of two buffers while the other is consumed
//     (bwd_stage.cuh), beside each row's weight prefactor deg s(mT) and mT:
//     one barrier a species.  The momentum points (pT cos, pT sin, their
//     squares and product) are staged once a block.
//   * The accumulator.  A row's sums over phi of the six point-term
//     cotangents run in T (n_phi terms); the row multiplies them by mT
//     cosh and mT sinh once, into the 13 node sums; the 9 sums with px,
//     py and the 8 of the scalars run per point.  All 30 sums (Sums) are
//     T registers over a species (P x F = 768 terms: at most ~768 x 2^-24
//     = 5e-5 of the species' sum of magnitudes in float32, typically
//     2e-6, inside the 2e-4 the checks allow), flushed to the thread's
//     float64 accumulators in shared memory once a species.
//
// Both:
//   * No atomics.  At the end each thread turns its float64 sums into the
//     NF gradients of its (cell, node) pair (finalize), the block adds the
//     nodes of a cell in node order in float64, and one thread writes each
//     entry: two launches give identical bits.
//   * float32 takes ex2.approx and rcp.approx as the forward kernel does
//     (folded.cuh, Fn<float>): +inf -> 0, so an overflowed exponential
//     gives feq = 0 and every term of the evaluation exactly 0; float64
//     keeps IEEE arithmetic.

#include <cuda_runtime.h>

#include "bwd_stage.cuh"
#include "folded.cuh"

namespace {

using namespace is3d;

constexpr int BLOCK = 128;       // most threads a block: CT cells x nodes
// the remap's: most threads a block, and the blocks an SM its registers
// are budgeted for
constexpr int REMAP_BLOCK = 192;
constexpr int REMAP_MIN_BLOCKS = 2;
constexpr int SB = 16;           // species a staged chunk
constexpr int NV = 4;            // staged values per (cell, phi)
constexpr size_t MAX_SMEM = 232448;

enum Mode { FIXED3 = 0, FIXED2 = 1, REMAP = 2 };

// the gradient of one (cell, node) from its sums, in float64
struct Sums {
  // node sums in the generic form: P = sum gp mT cosh, Ps = sum gp mT sinh,
  // U, Us of u.p, Q.. of pi:pp's mT^2 terms, X, Y of its mT px and mT py
  // terms, V, Vs of V.p
  double Pc, Ps, Uc, Us, Qcc, Qss, Qcs, Xc, Xs, Yc, Ys, Vc, Vs;
  // per-point sums: gp px, gp py, gu px, gu py, gq px^2, gq py^2,
  // gq px py, gv px, gv py
  double Gpx, Gpy, Gux, Guy, Gqxx, Gqyy, Gqxy, Gvx, Gvy;
  // the scalars: g_arg u.p, g_arg b, and s0 .. s5 of the df chain
  double sInvT, sAlpha, s0, s1, s2, s3, s4, s5;
};

template <typename T, int DF>
__device__ __forceinline__ void finalize(const T* g, const Sums& a,
                                         double w, int mode, double* o) {
  const double tau = g[F_TAU], dat = g[F_DAT], dant = g[F_DANT];
  const double ut = g[F_UT], tun = g[F_TUN];
  const double pitt = g[F_PITT], pitx = g[F_PITX], pity = g[F_PITY];
  const double pitn = g[F_PITN], pinn = g[F_PINN], pixn = g[F_PIXN];
  const double piyn = g[F_PIYN], Vt = g[F_VT], Vn = g[F_VN];
  const double Pi = g[F_BULKPI], kb0 = g[F_KB0], kb1 = g[F_KB1];
  const double kb2 = g[F_KB2], benth = g[F_BENTH], kdv = g[F_KDV];
  for (int k = 0; k < NF; ++k) o[k] = 0.0;
  o[F_DAT] = a.Pc;
  o[F_DANT] = a.Ps;
  o[F_DAX] = a.Gpx;
  o[F_DAY] = a.Gpy;
  o[F_UT] = a.Uc;
  o[F_TUN] = -a.Us;
  o[F_UX] = -a.Gux;
  o[F_UY] = -a.Guy;
  o[F_PITT] = a.Qcc;
  o[F_PINN] = tau * tau * a.Qss;
  o[F_PITN] = -2.0 * tau * a.Qcs;
  o[F_PITX] = -2.0 * a.Xc;
  o[F_PIXN] = 2.0 * tau * a.Xs;
  o[F_PITY] = -2.0 * a.Yc;
  o[F_PIYN] = 2.0 * tau * a.Ys;
  o[F_PIXX] = a.Gqxx;
  o[F_PIYY] = a.Gqyy;
  o[F_PIXY] = 2.0 * a.Gqxy;
  o[F_VT] = a.Vc;
  o[F_VN] = -tau * a.Vs;
  o[F_VX] = -a.Gvx;
  o[F_VY] = -a.Gvy;
  o[F_TAU] = 2.0 * tau * pinn * a.Qss - 2.0 * pitn * a.Qcs
             + 2.0 * pixn * a.Xs + 2.0 * piyn * a.Ys - Vn * a.Vs;
  // d/dDelta: d(mT cosh)/dDelta = mT sinh, d(mT sinh)/dDelta = mT cosh
  const double gdelta =
      dat * a.Ps + dant * a.Pc + ut * a.Us - tun * a.Uc
      + 2.0 * pitt * a.Qcs + 2.0 * tau * tau * pinn * a.Qcs
      - 2.0 * tau * pitn * (a.Qss + a.Qcc) - 2.0 * pitx * a.Xs
      + 2.0 * tau * pixn * a.Xc - 2.0 * pity * a.Ys + 2.0 * tau * piyn * a.Yc
      + Vt * a.Vs - tau * Vn * a.Vc;
  if (mode == FIXED3) o[F_ETA] = -gdelta;        // Delta = y - eta
  if (mode == REMAP) o[F_YFLOW] = gdelta;        // Delta = y_flow - s eta_r
  o[F_INVT] = a.sInvT;
  o[F_ALPHAB] = -a.sAlpha;
  o[F_KSC] = a.s0;
  o[F_KB0] = Pi * a.s1;
  o[F_KB1] = Pi * a.s2;
  o[F_KB2] = Pi * a.s3;
  o[F_BULKPI] = kb0 * a.s1 + kb1 * a.s2 + kb2 * a.s3;
  if (DF == 2) {
    o[F_BENTH] = kdv * a.s4;
    o[F_KDV] = benth * a.s4 - a.s5;
  } else {
    o[F_KC3] = a.s4;
    o[F_KC4] = a.s5;
  }
  for (int k = 0; k < NF; ++k) o[k] *= w;
}

// The fixed-node body's shared-memory layout: the block's cell rows, the
// staged cotangent (SB species x F phi x RG nodes; reused at the end for
// the per-(cell, node) gradients), the species chunk, the (cell, phi) row
// terms.
template <typename T>
struct Smem {
  T *raw, *gs, *mT, *m2, *sgn, *bar, *rowt, *pxs, *pys;
  double* red;
  __host__ __device__ Smem(unsigned char* p, int CT, int F, int RG, int R) {
    red = reinterpret_cast<double*>(p);
    const size_t gsz = (size_t)SB * F * RG * sizeof(T);
    const size_t rsz = (size_t)CT * R * NF * sizeof(double);
    T* t = reinterpret_cast<T*>(p + (gsz > rsz ? gsz : rsz));
    gs = reinterpret_cast<T*>(p);
    raw = t;
    mT = raw + CT * NF;
    m2 = mT + SB;
    sgn = m2 + SB;
    bar = sgn + SB;
    rowt = bar + SB;
    pxs = rowt + CT * F * NV;
    pys = pxs + F;
    end_ = pys + F;
  }
  T* end_;
  __host__ __device__ size_t bytes(const unsigned char* p) const {
    return reinterpret_cast<const unsigned char*>(end_) - p;
  }
};

// fixed nodes (K9a): grid (blocks of CT cells); thread t owns cell t / R
// of the block at node t % R
template <typename T, int MODE, int DF>
__device__ __forceinline__ void bwd_body(
    const T* __restrict__ cells, int n_cells, int CT,
    const T* __restrict__ mass, const T* __restrict__ sign,
    const T* __restrict__ baryon, const T* __restrict__ deg, int S,
    const T* __restrict__ pT, int P, const T* __restrict__ px,
    const T* __restrict__ py, int F, const T* __restrict__ nodes,
    const T* __restrict__ weights, int R, int regulate, int outflow,
    T prefactor, const T* __restrict__ G, T* __restrict__ grad) {
  using Fx = Fn<T>;
  constexpr int RG1 = MODE == FIXED3 ? 0 : 1;   // 1: G has no node axis
  const int RG = RG1 ? 1 : R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> s(smem_raw, CT, F, RG, R);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int c0 = blockIdx.x * CT;
  const int nc = min(CT, n_cells - c0);
  const bool active = tid < nc * R;
  const int ci = active ? tid / R : 0, r = active ? tid - ci * R : 0;

  for (int i = tid; i < CT * NF; i += nt) {
    const int c = min(i / NF, nc - 1);
    s.raw[i] = cells[(size_t)(c0 + c) * NF + (i - (i / NF) * NF)];
  }
  __syncthreads();
  const T* g = s.raw + ci * NF;
  const T tau = g[F_TAU], dat = g[F_DAT], dant = g[F_DANT], ut = g[F_UT];
  const T tun = g[F_TUN], pitt = g[F_PITT], pitx = g[F_PITX];
  const T pity = g[F_PITY], pitn = g[F_PITN], pinn = g[F_PINN];
  const T pixn = g[F_PIXN], piyn = g[F_PIYN], Vt = g[F_VT], Vn = g[F_VN];
  const T invT = g[F_INVT], alpha = g[F_ALPHAB], ksc = g[F_KSC];
  const T kb0 = g[F_KB0], kb1 = g[F_KB1], kb2 = g[F_KB2], Pi = g[F_BULKPI];
  const T kdv = g[F_KDV], benth = g[F_BENTH], kc3 = g[F_KC3];
  const T kc4 = g[F_KC4];
  const T L = Fx::SCALE;
  const T invTL = L * invT;
  const T dlo = regulate ? T(-1) : -Fx::inf();
  const T dhi = regulate ? T(1) : Fx::inf();
  // the thread's node kinematics and composites
  T ch = T(1), sh = T(0), A1 = T(0), B1 = T(0), C1 = T(0), C2 = T(0);
  T C3 = T(0), D1 = T(0);
  {
    const T delta = MODE == FIXED3 ? nodes[r] - g[F_ETA] : -nodes[r];
    ch = d_cosh(delta);
    sh = d_sinh(delta);
    const T t_sh = sh * tau;
    A1 = ch * dat + sh * dant;
    B1 = ch * ut - sh * tun;
    C1 = ch * ch * pitt + t_sh * t_sh * pinn - T(2) * ch * t_sh * pitn;
    C2 = T(-2) * (ch * pitx - t_sh * pixn);
    C3 = T(-2) * (ch * pity - t_sh * piyn);
    D1 = ch * Vt - t_sh * Vn;
  }
  const double w = MODE == FIXED3 ? 1.0 : (double)weights[r];

  Sums a = {};
  // the node sums before the node's cosh and sinh
  double SP = 0, SU = 0, S2 = 0, SX = 0, SY = 0, SV = 0;

  for (int p = 0; p < P; ++p) {
    const T pt = pT[p];
    for (int sb = 0; sb < S; sb += SB) {
      const int ns = min(SB, S - sb);
      __syncthreads();                   // the previous chunk is consumed
      for (int i = tid; i < SB * F * RG; i += nt) {
        const int sl = i / (F * RG), rest = i - sl * F * RG;
        T v = T(0);
        if (sl < ns) {
          const int sp = sb + sl;
          v = prefactor * deg[sp] * G[((size_t)sp * P + p) * F * RG + rest];
        }
        s.gs[i] = v;
      }
      for (int i = tid; i < SB; i += nt) {
        const int sp = min(sb + i, S - 1);
        s.m2[i] = mass[sp] * mass[sp];
        s.mT[i] = d_sqrt(s.m2[i] + pt * pt);
        s.sgn[i] = sign[sp];
        s.bar[i] = baryon[sp];
      }
      if (sb == 0) {
        for (int i = tid; i < F; i += nt) {
          s.pxs[i] = px[p * F + i];
          s.pys[i] = py[p * F + i];
        }
        __syncthreads();
        for (int i = tid; i < CT * F; i += nt) {
          const int c = i / F, f = i - c * F;
          const T* q = s.raw + c * NF;
          const T x = s.pxs[f], y = s.pys[f];
          T* o = s.rowt + i * NV;
          o[0] = q[F_DAX] * x + q[F_DAY] * y;
          o[1] = -(q[F_UX] * x + q[F_UY] * y);
          o[2] = q[F_PIXX] * x * x + q[F_PIYY] * y * y
                 + T(2) * q[F_PIXY] * x * y;
          o[3] = -(q[F_VX] * x + q[F_VY] * y);
        }
      }
      __syncthreads();
      if (!active) continue;
      for (int f = 0; f < F; ++f) {
        const T* rt = s.rowt + (ci * F + f) * NV;
        const T W1 = rt[0], nW2 = rt[1], C4 = rt[2], nD2 = rt[3];
        const T x = s.pxs[f], y = s.pys[f];
        const T PC = x * C2 + y * C3;
        // the point's partial sums over the chunk's species, in T
        T qgp = 0, qgu = 0, qgq = 0, qgv = 0;
        T qP = 0, qU = 0, q2 = 0, qX = 0, qV = 0;
        T qi = 0, qa = 0, q0 = 0, q1 = 0, q2d = 0, q3 = 0, q4 = 0, q5 = 0;
        const T* gr = s.gs + f * RG + (RG1 ? 0 : r);
        for (int sl = 0; sl < ns; ++sl) {
          const T gv = gr[sl * F * RG];
          const T mT = s.mT[sl], m2 = s.m2[sl];
          const T sgn = s.sgn[sl], b = s.bar[sl];
          const T pds = fma(mT, A1, W1);
          const T pdu = fma(mT, B1, nW2);
          const T pipp = fma(mT * mT, C1, fma(mT, PC, C4));
          const T Vp = fma(mT, D1, nD2);
          // the forward value
          const T feq = Fx::rcp(Fx::exp_scaled(fma(pdu, invTL, -L * alpha * b))
                                + sgn);
          const T feqbar = fma(-sgn, feq, T(1));
          T df, r_ = T(0);
          if (DF == 1) {
            df = ksc * pipp + (kb0 * m2 + (kb1 * b + kb2 * pdu) * pdu) * Pi
                 + (kc3 * b + kc4 * pdu) * Vp;
          } else {
            r_ = Fx::rcp(pdu);
            df = ksc * pipp * r_ + (kb0 * pdu + kb1 * b + kb2 * (pdu - m2 * r_))
                 * Pi + (benth - b * r_) * Vp * kdv;
          }
          const T prod = feqbar * df;
          const T dfc = fmin(fmax(prod, dlo), dhi);
          const T fv = fma(feq, dfc, feq);
          const T pp = outflow ? fmax(pds, T(0)) : pds;
          // the chain rule, as torch autograd takes it through plain_block
          const T gp = (!outflow || pds >= T(0)) ? gv * fv : T(0);
          const T gfv = gv * pp;
          const T gprod = (prod >= dlo && prod <= dhi) ? gfv * feq : T(0);
          const T gfeq = fma(gfv, dfc, gfv) - sgn * gprod * df;
          const T gdf = gprod * feqbar;
          const T garg = -gfeq * feq * feqbar;
          T gq, gVp, gu;
          if (DF == 1) {
            gq = gdf * ksc;
            gVp = gdf * (kc3 * b + kc4 * pdu);
            gu = garg * invT
                 + gdf * ((kb1 * b + T(2) * kb2 * pdu) * Pi + kc4 * Vp);
            q0 = fma(gdf, pipp, q0);
            q1 = fma(gdf, m2, q1);
            q2d = fma(gdf * b, pdu, q2d);
            q3 = fma(gdf * pdu, pdu, q3);
            q4 = fma(gdf * b, Vp, q4);
            q5 = fma(gdf * pdu, Vp, q5);
          } else {
            gq = gdf * ksc * r_;
            gVp = gdf * (benth - b * r_) * kdv;
            gu = garg * invT
                 + gdf * (-r_ * r_ * (ksc * pipp - kb2 * Pi * m2 - b * Vp * kdv)
                          + (kb0 + kb2) * Pi);
            q0 = fma(gdf * pipp, r_, q0);
            q1 = fma(gdf, pdu, q1);
            q2d = fma(gdf, b, q2d);
            q3 = fma(gdf, pdu - m2 * r_, q3);
            q4 = fma(gdf, Vp, q4);
            q5 = fma(gdf * b * r_, Vp, q5);
          }
          qi = fma(garg, pdu, qi);
          qa = fma(garg, b, qa);
          qgp += gp;
          qgu += gu;
          qgq += gq;
          qgv += gVp;
          qP = fma(gp, mT, qP);
          qU = fma(gu, mT, qU);
          q2 = fma(gq * mT, mT, q2);
          qX = fma(gq, mT, qX);
          qV = fma(gVp, mT, qV);
        }
        // carry the point's sums in float64
        const double X = x, Y = y;
        a.Gpx += X * qgp;
        a.Gpy += Y * qgp;
        a.Gux += X * qgu;
        a.Guy += Y * qgu;
        a.Gqxx += X * X * qgq;
        a.Gqyy += Y * Y * qgq;
        a.Gqxy += X * Y * qgq;
        a.Gvx += X * qgv;
        a.Gvy += Y * qgv;
        a.sInvT += qi;
        a.sAlpha += qa;
        a.s0 += q0;
        a.s1 += q1;
        a.s2 += q2d;
        a.s3 += q3;
        a.s4 += q4;
        a.s5 += q5;
        SP += qP;
        SU += qU;
        S2 += q2;
        SX += X * qX;
        SY += Y * qX;
        SV += qV;
      }
    }
  }
  {
    // the generic node sums of a fixed node: mT cosh = cosh x mT
    const double C = ch, Sh = sh;
    a.Pc = C * SP;
    a.Ps = Sh * SP;
    a.Uc = C * SU;
    a.Us = Sh * SU;
    a.Qcc = C * C * S2;
    a.Qss = Sh * Sh * S2;
    a.Qcs = C * Sh * S2;
    a.Xc = C * SX;
    a.Xs = Sh * SX;
    a.Yc = C * SY;
    a.Ys = Sh * SY;
    a.Vc = C * SV;
    a.Vs = Sh * SV;
  }
  __syncthreads();                       // the last chunk is consumed
  if (active) finalize<T, DF>(g, a, w, MODE, s.red + (size_t)tid * NF);
  __syncthreads();
  // each cell's gradient: its nodes added in node order
  for (int i = tid; i < nc * NF; i += nt) {
    const int c = i / NF, k = i - c * NF;
    double v = 0.0;
    for (int rr = 0; rr < R; ++rr) v += s.red[(size_t)(c * R + rr) * NF + k];
    grad[(size_t)(c0 + c) * NF + k] = (T)v;
  }
}

template <typename T, int DIM, int DF>
__global__ void __launch_bounds__(BLOCK)
spectra_bwd_kernel(const T* __restrict__ cells, int n_cells, int CT,
                   const T* __restrict__ mass, const T* __restrict__ sign,
                   const T* __restrict__ baryon, const T* __restrict__ deg,
                   int S, const T* __restrict__ pT, int P,
                   const T* __restrict__ px, const T* __restrict__ py, int F,
                   const T* __restrict__ nodes,
                   const T* __restrict__ weights, int R, int regulate,
                   int outflow, T prefactor, const T* __restrict__ G,
                   T* __restrict__ grad) {
  bwd_body<T, DIM == 3 ? FIXED3 : FIXED2, DF>(
      cells, n_cells, CT, mass, sign, baryon, deg, S, pT, P, px, py, F,
      nodes, weights, R, regulate, outflow, prefactor, G, grad);
}

// The remap body's shared-memory layout: the float64 accumulators (NS
// slots of nt), the momentum points (pT cos phi, pT sin phi, their squares
// and products), pT, the per-(cell, phi) point terms at unit pT (RowU), two
// stage buffers (a species' G (P x F), its node table (P x R x 2), each
// row's weight and mT) and the block's cell rows, placed past the per-
// (cell, node) gradients (nt x NF float64 from 0) that the end writes over
// the accumulators.
template <typename T>
struct alignas(16) RowU {
  T w1, nw2, g, h, c4, nd2, pad0, pad1;
};

constexpr int NS = sizeof(Sums) / sizeof(double);
static_assert(NS == 30, "Sums holds 30 float64 sums");

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) / 16 * 16;
}

template <typename T>
struct RSmem {
  double* acc;
  Pt4<T>* pts;
  T *txy, *pTs, *stage, *raw;
  RowU<T>* unit;
  int SB;
  size_t end_;
  __host__ __device__ RSmem(unsigned char* p, int nt, int CT, int P, int F,
                            int R) {
    size_t o = (size_t)NS * nt * sizeof(double);
    acc = reinterpret_cast<double*>(p);
    pts = reinterpret_cast<Pt4<T>*>(p + o);
    o = align16(o + (size_t)P * F * sizeof(Pt4<T>));
    txy = reinterpret_cast<T*>(p + o);
    o = align16(o + (size_t)P * F * sizeof(T));
    pTs = reinterpret_cast<T*>(p + o);
    o = align16(o + (size_t)P * sizeof(T));
    unit = reinterpret_cast<RowU<T>*>(p + o);
    o = align16(o + (size_t)CT * F * sizeof(RowU<T>));
    stage = reinterpret_cast<T*>(p + o);
    SB = P * F + P * R * 2 + 2 * P;
    o = align16(o + 2 * (size_t)SB * sizeof(T));
    const size_t red = (size_t)nt * NF * sizeof(double);
    o = o > red ? o : red;
    raw = reinterpret_cast<T*>(p + o);
    end_ = o + (size_t)CT * NF * sizeof(T);
  }
};

// K9b, the 2+1D mT remap: grid (blocks of CT cells); thread t owns cell
// t / R of the block at node t % R and walks species, then pT rows, then
// phi.  Per (species, pT) row it forms the node kinematics mT cosh Delta,
// mT sinh Delta (Delta = y_flow - s eta_r, from the node table) and the
// composites of the four point terms once, runs the n_phi points with the
// fixed-node body's chain rule, and multiplies the row's sums by the
// kinematics once; per species its sums are flushed to float64.
template <typename T, int DF>
__device__ __forceinline__ void remap_bwd_body(
    const T* __restrict__ cells, int n_cells, int CT,
    const T* __restrict__ mass, const T* __restrict__ sign,
    const T* __restrict__ baryon, const T* __restrict__ deg, int S,
    const T* __restrict__ pT, int P, const T* __restrict__ cos_phi,
    const T* __restrict__ sin_phi, int F, const T* __restrict__ table,
    const T* __restrict__ weights, int R, int regulate, int outflow,
    T prefactor, T t_ref, const T* __restrict__ G, T* __restrict__ grad) {
  using Fx = Fn<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const RSmem<T> s(smem_raw, nt, CT, P, F, R);
  const int c0 = blockIdx.x * CT;
  const int nc = min(CT, n_cells - c0);
  const bool active = tid < nc * R;
  const int ci = active ? tid / R : 0, r = active ? tid - ci * R : 0;

  // tile k: species k's G (P x F) and node table (P x R x 2) by cp.async
  // into buffer k & 1, beside each row's weight prefactor deg s and mT
  auto issue = [&](int k) {
    T* dst = s.stage + (k & 1) * s.SB;
    const T* g0 = G + (size_t)k * P * F;
    for (int i = tid; i < P * F; i += nt) cp_async_elem(dst + i, g0 + i);
    const T* t0 = table + (size_t)k * P * R * 2;
    T* tt = dst + P * F;
    for (int i = tid; i < P * R * 2; i += nt) cp_async_elem(tt + i, t0 + i);
    cp_async_commit();
    T* wr = tt + P * R * 2;
    const T m2 = mass[k] * mass[k], dg = prefactor * deg[k];
    for (int i = tid; i < P; i += nt) {
      const T pt = pT[i];
      const T mT = d_sqrt(m2 + pt * pt);
      wr[i] = dg * d_sqrt(t_ref / (mT > t_ref ? mT : t_ref));
      wr[P + i] = mT;
    }
  };

  for (int i = tid; i < CT * NF; i += nt) {
    const int c = min(i / NF, nc - 1);
    s.raw[i] = cells[(size_t)(c0 + c) * NF + (i - (i / NF) * NF)];
  }
  stage_points(s.pts, s.txy, cos_phi, sin_phi, pT, P, F, true, tid, nt);
  for (int i = tid; i < P; i += nt) s.pTs[i] = pT[i];
  for (int j = 0; j < NS; ++j) s.acc[(size_t)j * nt + tid] = 0.0;
  issue(0);
  __syncthreads();
  // the (cell, phi) point terms at unit pT: p.dsigma's px, py part, u.p's,
  // pi:pp's pT mT cosh and pT mT sinh coefficients and its px^2 .. part,
  // V.p's
  for (int i = tid; i < CT * F; i += nt) {
    const int c = i / F, f = i - c * F;
    const T* q = s.raw + c * NF;
    const T x = cos_phi[f], y = sin_phi[f];
    RowU<T> u;
    u.w1 = q[F_DAX] * x + q[F_DAY] * y;
    u.nw2 = -(q[F_UX] * x + q[F_UY] * y);
    u.g = T(-2) * (q[F_PITX] * x + q[F_PITY] * y);
    u.h = T(2) * q[F_TAU] * (q[F_PIXN] * x + q[F_PIYN] * y);
    u.c4 = q[F_PIXX] * x * x + q[F_PIYY] * y * y + T(2) * q[F_PIXY] * x * y;
    u.nd2 = -(q[F_VX] * x + q[F_VY] * y);
    u.pad0 = u.pad1 = T(0);
    s.unit[i] = u;
  }
  const T* g = s.raw + ci * NF;
  const T tau = g[F_TAU], dat = g[F_DAT], dant = g[F_DANT], ut = g[F_UT];
  const T tun = g[F_TUN], pitt = g[F_PITT], pitn = g[F_PITN];
  const T pinn = g[F_PINN], Vt = g[F_VT], Vn = g[F_VN];
  const T invT = g[F_INVT], alpha = g[F_ALPHAB], ksc = g[F_KSC];
  const T kb0 = g[F_KB0], kb1 = g[F_KB1], kb2 = g[F_KB2], Pi = g[F_BULKPI];
  const T kdv = g[F_KDV], benth = g[F_BENTH], kc3 = g[F_KC3];
  const T kc4 = g[F_KC4];
  const T L = Fx::SCALE;
  const T invTL = L * invT;
  const T dlo = regulate ? T(-1) : -Fx::inf();
  const T dhi = regulate ? T(1) : Fx::inf();
  const T ey = d_exp(g[F_YFLOW]), eym = d_exp(-g[F_YFLOW]);
  const double w = (double)weights[r];
  const RowU<T>* un = s.unit + ci * F;

  // the species' sums in T, in Sums' order
  T q[NS];
  for (int sp = 0; sp < S; ++sp) {
    cp_async_wait_all();
    __syncthreads();              // tile sp has landed, tile sp - 1 is consumed
    if (sp + 1 < S) issue(sp + 1);
    const T* st = s.stage + (sp & 1) * s.SB;
    const T* tb = st + P * F;
    const T* wr = tb + P * R * 2;
    const T m2 = mass[sp] * mass[sp], sgn = sign[sp], b = baryon[sp];
    const T nab = -L * alpha * b;
#pragma unroll
    for (int j = 0; j < NS; ++j) q[j] = T(0);
    for (int p = 0; p < P && active; ++p) {
      const T pt = s.pTs[p], mT = wr[P + p], wrow = wr[p];
      // the row's node kinematics and composites
      const T hm = T(0.5) * mT;
      const T ep = ey * hm * tb[(p * R + r) * 2];
      const T em = eym * hm * tb[(p * R + r) * 2 + 1];
      const T cp = ep + em;                     // mT cosh(Delta)
      const T sn = ep - em;                     // mT sinh(Delta)
      const T tsp = tau * sn;
      const T A = fma(cp, dat, sn * dant);
      const T B = fma(cp, ut, -(sn * tun));
      const T D = fma(cp, Vt, -(tsp * Vn));
      const T C1 = cp * cp * pitt + tsp * tsp * pinn - T(2) * cp * tsp * pitn;
      const T cpt = cp * pt, spt = sn * pt, pt2 = pt * pt;
      const T* gr = st + p * F;
      const Pt4<T>* pp4 = s.pts + p * F;
      const T* pxy = s.txy + p * F;
      // the row's sums over phi of the four terms' cotangents (and pi:pp's
      // x px, x py)
      T tP = 0, tU = 0, tQ = 0, tQx = 0, tQy = 0, tV = 0;
      // eight points an iteration: independent chains at the same 12
      // warps an SM (by A/B, two against one 0.95, four against two 0.96,
      // eight against four 0.95)
#pragma unroll 8
      for (int f = 0; f < F; ++f) {
        const RowU<T> u = un[f];
        const Pt4<T> v = pp4[f];
        const T gv = wrow * gr[f];
        const T pds = fma(pt, u.w1, A);
        const T pdu = fma(pt, u.nw2, B);
        const T pipp = fma(cpt, u.g, fma(spt, u.h, fma(pt2, u.c4, C1)));
        const T Vp = fma(pt, u.nd2, D);
        // the forward value
        const T feq = Fx::rcp(Fx::exp_scaled(fma(pdu, invTL, nab)) + sgn);
        const T feqbar = fma(-sgn, feq, T(1));
        T df, r_ = T(0);
        if (DF == 1) {
          df = ksc * pipp + (kb0 * m2 + (kb1 * b + kb2 * pdu) * pdu) * Pi
               + (kc3 * b + kc4 * pdu) * Vp;
        } else {
          r_ = Fx::rcp(pdu);
          df = ksc * pipp * r_ + (kb0 * pdu + kb1 * b + kb2 * (pdu - m2 * r_))
               * Pi + (benth - b * r_) * Vp * kdv;
        }
        const T prod = feqbar * df;
        const T dfc = fmin(fmax(prod, dlo), dhi);
        const T fv = fma(feq, dfc, feq);
        const T pp = outflow ? fmax(pds, T(0)) : pds;
        // the chain rule, as torch autograd takes it through plain_block
        const T gp = (!outflow || pds >= T(0)) ? gv * fv : T(0);
        const T gfv = gv * pp;
        const T gprod = (prod >= dlo && prod <= dhi) ? gfv * feq : T(0);
        const T gfeq = fma(gfv, dfc, gfv) - sgn * gprod * df;
        const T gdf = gprod * feqbar;
        const T garg = -gfeq * feq * feqbar;
        T gq, gVp, gu;
        if (DF == 1) {
          gq = gdf * ksc;
          gVp = gdf * (kc3 * b + kc4 * pdu);
          gu = garg * invT
               + gdf * ((kb1 * b + T(2) * kb2 * pdu) * Pi + kc4 * Vp);
          // s1, s2, s4 without their species factor m2, b, b
          const T gu_ = gdf * pdu;
          q[24] = fma(gdf, pipp, q[24]);
          q[25] += gdf;
          q[26] += gu_;
          q[27] = fma(gu_, pdu, q[27]);
          q[28] = fma(gdf, Vp, q[28]);
          q[29] = fma(gu_, Vp, q[29]);
        } else {
          gq = gdf * ksc * r_;
          gVp = gdf * (benth - b * r_) * kdv;
          gu = garg * invT
               + gdf * (-r_ * r_ * (ksc * pipp - kb2 * Pi * m2 - b * Vp * kdv)
                        + (kb0 + kb2) * Pi);
          // s2, s5 without their species factor b; s3 as the sum of
          // gdf r, whose s1 - m2 (.) the species takes
          const T gr = gdf * r_;
          q[24] = fma(gr, pipp, q[24]);
          q[25] = fma(gdf, pdu, q[25]);
          q[26] += gdf;
          q[27] += gr;
          q[28] = fma(gdf, Vp, q[28]);
          q[29] = fma(gr, Vp, q[29]);
        }
        q[22] = fma(garg, pdu, q[22]);          // sInvT
        q[23] += garg;                          // sAlpha / b
        const T x = v.x, y = v.y;
        tP += gp;
        tU += gu;
        tQ += gq;
        tQx = fma(gq, x, tQx);
        tQy = fma(gq, y, tQy);
        tV += gVp;
        q[13] = fma(gp, x, q[13]);              // Gpx
        q[14] = fma(gp, y, q[14]);              // Gpy
        q[15] = fma(gu, x, q[15]);              // Gux
        q[16] = fma(gu, y, q[16]);              // Guy
        q[17] = fma(gq, v.xx, q[17]);           // Gqxx
        q[18] = fma(gq, v.yy, q[18]);           // Gqyy
        q[19] = fma(gq, pxy[f], q[19]);         // Gqxy
        q[20] = fma(gVp, x, q[20]);             // Gvx
        q[21] = fma(gVp, y, q[21]);             // Gvy
      }
      // the row's node sums: mT cosh and mT sinh applied once
      const T cq = cp * tQ, sq = sn * tQ;
      q[0] = fma(cp, tP, q[0]);                 // Pc
      q[1] = fma(sn, tP, q[1]);                 // Ps
      q[2] = fma(cp, tU, q[2]);                 // Uc
      q[3] = fma(sn, tU, q[3]);                 // Us
      q[4] = fma(cp, cq, q[4]);                 // Qcc
      q[5] = fma(sn, sq, q[5]);                 // Qss
      q[6] = fma(cp, sq, q[6]);                 // Qcs
      q[7] = fma(cp, tQx, q[7]);                // Xc
      q[8] = fma(sn, tQx, q[8]);                // Xs
      q[9] = fma(cp, tQy, q[9]);                // Yc
      q[10] = fma(sn, tQy, q[10]);              // Ys
      q[11] = fma(cp, tV, q[11]);               // Vc
      q[12] = fma(sn, tV, q[12]);               // Vs
    }
    // the species' factors of the scalar sums, then into float64
    q[23] *= b;
    if (DF == 1) {
      q[25] *= m2;
      q[26] *= b;
      q[28] *= b;
    } else {
      q[26] *= b;
      q[27] = q[25] - m2 * q[27];
      q[29] *= b;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) s.acc[(size_t)j * nt + tid] += (double)q[j];
  }
  cp_async_wait_all();
  __syncthreads();
  Sums a;
  double* ad = reinterpret_cast<double*>(&a);
  for (int j = 0; j < NS; ++j) ad[j] = s.acc[(size_t)j * nt + tid];
  __syncthreads();                       // every accumulator is read
  if (active) finalize<T, DF>(g, a, w, REMAP, s.acc + (size_t)tid * NF);
  __syncthreads();
  // each cell's gradient: its nodes added in node order
  for (int i = tid; i < nc * NF; i += nt) {
    const int c = i / NF, k = i - c * NF;
    double v = 0.0;
    for (int rr = 0; rr < R; ++rr) v += s.acc[(size_t)(c * R + rr) * NF + k];
    grad[(size_t)(c0 + c) * NF + k] = (T)v;
  }
}

#define IS3D_RBWD_PARAMS                                                      \
  const T *__restrict__ cells, int n_cells, int CT,                          \
      const T *__restrict__ mass, const T *__restrict__ sign,                \
      const T *__restrict__ baryon, const T *__restrict__ deg, int S,        \
      const T *__restrict__ pT, int P, const T *__restrict__ cos_phi,        \
      const T *__restrict__ sin_phi, int F, const T *__restrict__ table,     \
      const T *__restrict__ weights, int R, int regulate, int outflow,       \
      T prefactor, T t_ref, const T *__restrict__ G, T *__restrict__ grad

// float32 is compiled for REMAP_MIN_BLOCKS blocks an SM; float64 (its
// registers spill at that budget) for one
template <typename T, int DF>
__global__ void __launch_bounds__(REMAP_BLOCK,
                                  sizeof(T) == 4 ? REMAP_MIN_BLOCKS : 1)
remap_bwd_kernel(IS3D_RBWD_PARAMS) {
  remap_bwd_body<T, DF>(cells, n_cells, CT, mass, sign, baryon, deg, S, pT,
                        P, cos_phi, sin_phi, F, table, weights, R, regulate,
                        outflow, prefactor, t_ref, G, grad);
}

// cells a block and its shared memory for a fixed-node shape, or an error
// code
template <typename T>
int blocking(int mode, int F, int R, int* CT, size_t* smem) {
  if (R < 1 || R > BLOCK || F < 1) return cudaErrorInvalidValue;
  *CT = BLOCK / R;
  const Smem<T> s(nullptr, *CT, F, mode == FIXED3 ? R : 1, R);
  *smem = s.bytes(nullptr);
  return *smem > MAX_SMEM ? (int)cudaErrorInvalidValue : 0;
}

// the remap's: cells a block, threads and shared memory, or an error code
template <typename T>
int remap_blocking(int P, int F, int R, int* CT, int* threads,
                   size_t* smem) {
  if (R < 1 || R > REMAP_BLOCK || F < 1 || P < 1)
    return cudaErrorInvalidValue;
  *CT = REMAP_BLOCK / R;
  *threads = (*CT * R + 31) / 32 * 32;
  *smem = RSmem<T>(nullptr, *threads, *CT, P, F, R).end_;
  return *smem > MAX_SMEM ? (int)cudaErrorInvalidValue : 0;
}

template <typename T, typename K, typename... Args>
int launch_(K kern, int n_cells, int CT, int R, size_t smem,
            cudaStream_t stream, Args... args) {
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  const int threads = (CT * R + 31) / 32 * 32;
  const unsigned blocks = (unsigned)((n_cells + CT - 1) / CT);
  kern<<<blocks, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fixed(const void* cells, int n_cells, int nf, const void* mass,
                 const void* sign, const void* baryon, const void* deg,
                 int S, const void* pT, const void* px, const void* py,
                 int P, int F, const void* nodes, const void* weights, int R,
                 int df, int dim, int regulate, int outflow,
                 double prefactor, const void* G, void* grad,
                 void* stream_v) {
  if (nf != NF || (df != 1 && df != 2) || (dim != 2 && dim != 3) ||
      n_cells < 0 || S < 0 || P < 0)
    return cudaErrorInvalidValue;
  if (n_cells == 0) return cudaSuccess;
  int CT;
  size_t smem;
  const int rc = blocking<T>(dim == 3 ? FIXED3 : FIXED2, F, R, &CT, &smem);
  if (rc != 0) return rc;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
#define IS3D_BWD(DIM_, DF_)                                                   \
  launch_<T>(spectra_bwd_kernel<T, DIM_, DF_>, n_cells, CT, R, smem, stream, \
             (const T*)cells, n_cells, CT, (const T*)mass, (const T*)sign,   \
             (const T*)baryon, (const T*)deg, S, (const T*)pT, P,            \
             (const T*)px, (const T*)py, F, (const T*)nodes,                 \
             (const T*)weights, R, regulate, outflow, (T)prefactor,          \
             (const T*)G, (T*)grad)
  if (dim == 3) return df == 1 ? IS3D_BWD(3, 1) : IS3D_BWD(3, 2);
  return df == 1 ? IS3D_BWD(2, 1) : IS3D_BWD(2, 2);
#undef IS3D_BWD
}

template <typename T>
int launch_remap(const void* cells, int n_cells, int nf, const void* mass,
                 const void* sign, const void* baryon, const void* deg,
                 int S, const void* pT, int P, const void* cos_phi,
                 const void* sin_phi, int F, const void* table,
                 const void* weights, int R, int df, int regulate,
                 int outflow, double prefactor, double t_ref, const void* G,
                 void* grad, void* stream_v) {
  if (nf != NF || (df != 1 && df != 2) || n_cells < 0 || S < 0 || P < 0)
    return cudaErrorInvalidValue;
  if (n_cells == 0) return cudaSuccess;
  if (S == 0 || P == 0) return (int)cudaMemsetAsync(
      grad, 0, (size_t)n_cells * NF * sizeof(T),
      static_cast<cudaStream_t>(stream_v));
  int CT, threads;
  size_t smem;
  const int rc = remap_blocking<T>(P, F, R, &CT, &threads, &smem);
  if (rc != 0) return rc;
  const void* kern = df == 1 ? (const void*)remap_bwd_kernel<T, 1>
                             : (const void*)remap_bwd_kernel<T, 2>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const T* cells_ = static_cast<const T*>(cells);
  const T* mass_ = static_cast<const T*>(mass);
  const T* sign_ = static_cast<const T*>(sign);
  const T* baryon_ = static_cast<const T*>(baryon);
  const T* deg_ = static_cast<const T*>(deg);
  const T* pT_ = static_cast<const T*>(pT);
  const T* cos_ = static_cast<const T*>(cos_phi);
  const T* sin_ = static_cast<const T*>(sin_phi);
  const T* table_ = static_cast<const T*>(table);
  const T* weights_ = static_cast<const T*>(weights);
  T prefactor_ = (T)prefactor, t_ref_ = (T)t_ref;
  const T* G_ = static_cast<const T*>(G);
  T* grad_ = static_cast<T*>(grad);
  void* args[] = {&cells_, &n_cells, &CT, &mass_, &sign_, &baryon_, &deg_,
                  &S, &pT_, &P, &cos_, &sin_, &F, &table_, &weights_, &R,
                  &regulate, &outflow, &prefactor_, &t_ref_, &G_, &grad_};
  const unsigned blocks = (unsigned)((n_cells + CT - 1) / CT);
  e = cudaLaunchKernel(kern, dim3(blocks), dim3(threads), args, smem,
                       static_cast<cudaStream_t>(stream_v));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// out: cells a block, threads, shared memory bytes, resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers a thread and
// local memory bytes a thread (spills) of the remap kernel at one shape
template <typename T>
int remap_props(int df, int P, int F, int R, int* out) {
  if (df != 1 && df != 2) return cudaErrorInvalidValue;
  const void* kern = df == 1 ? (const void*)remap_bwd_kernel<T, 1>
                             : (const void*)remap_bwd_kernel<T, 2>;
  int CT, threads;
  size_t smem;
  const int rc = remap_blocking<T>(P, F, R, &CT, &threads, &smem);
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

// fixed nodes (3+1D, 2+1D): grad (n_cells, NF) of <G, spectra>
#define IS3D_BWD_ENTRY(NAME, T)                                               \
  int NAME(const void* cells, int n_cells, int nf, const void* mass,         \
           const void* sign, const void* baryon, const void* deg, int S,     \
           const void* pT, const void* px, const void* py, int P, int F,     \
           const void* nodes, const void* weights, int R, int df, int dim,   \
           int regulate, int outflow, double prefactor, const void* G,       \
           void* grad, void* stream) {                                       \
    return launch_fixed<T>(cells, n_cells, nf, mass, sign, baryon, deg, S,   \
                           pT, px, py, P, F, nodes, weights, R, df, dim,     \
                           regulate, outflow, prefactor, G, grad, stream);   \
  }
IS3D_BWD_ENTRY(is3d_spectra_bwd_f32, float)
IS3D_BWD_ENTRY(is3d_spectra_bwd_f64, double)
#undef IS3D_BWD_ENTRY

// the 2+1D mT remap: table (S, P, R, 2) as the forward's
#define IS3D_BWD_REMAP_ENTRY(NAME, T)                                         \
  int NAME(const void* cells, int n_cells, int nf, const void* mass,         \
           const void* sign, const void* baryon, const void* deg, int S,     \
           const void* pT, int P, const void* cos_phi, const void* sin_phi,  \
           int F, const void* table, const void* weights, int R, int df,     \
           int regulate, int outflow, double prefactor, double t_ref,        \
           const void* G, void* grad, void* stream) {                        \
    return launch_remap<T>(cells, n_cells, nf, mass, sign, baryon, deg, S,   \
                           pT, P, cos_phi, sin_phi, F, table, weights, R,    \
                           df, regulate, outflow, prefactor, t_ref, G, grad, \
                           stream);                                          \
  }
IS3D_BWD_REMAP_ENTRY(is3d_spectra_bwd_remap_f32, float)
IS3D_BWD_REMAP_ENTRY(is3d_spectra_bwd_remap_f64, double)
#undef IS3D_BWD_REMAP_ENTRY

// remap_props<T> of (f64, df) at (P, F, R)
int is3d_spectra_bwd_remap_props(int f64, int df, int P, int F, int R,
                                 int* out) {
  return f64 ? remap_props<double>(df, P, F, R, out)
             : remap_props<float>(df, P, F, R, out);
}

const char* is3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
