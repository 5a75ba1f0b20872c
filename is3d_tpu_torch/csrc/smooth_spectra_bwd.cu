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
// BACKWARD_FORMULA_OPS); no bytes to speak of: a group's cells are 2.4 MB
// and G, read once per block of cells, stays in L2.
//
// Design.
//   * A per-cell reduction over momentum points, the shape of dndx.cu's
//     percell_kernel: a thread owns one (cell, node) pair and walks every
//     (pT, phi, species); a block holds CT cells x all nodes, so nothing
//     of a cell's sum leaves the block.  In 3+1D and 2+1D fixed nodes the
//     node kinematics (cosh, sinh of Delta) are the thread's constants and
//     the sums that need them are formed per node (SP .. SV below), then
//     multiplied by cosh and sinh once at the end; with the remap the
//     nodes move with (species, pT), so cosh and sinh enter every sum
//     (the node table gives mT cosh, mT sinh from two products).
//   * Staging.  Per pT row the block stages the weighted cotangent of a
//     chunk of SB species (all phi, all nodes in 3+1D), the species' mT,
//     and per (cell, phi) the terms W1, -W2, C4, -D2 that do not depend on
//     the node or the species: they are the same for every thread of a
//     cell, so each is formed once per block.
//   * The accumulator.  One cell's gradient sums S x P x F x nodes terms
//     (5.2e6 in 3+1D, 1.2e7 with the 48-node remap at 320 x 32 x 24).  The
//     sums run in T over the SB species of one (pT, phi) point and are
//     carried in float64 across points, so a float32 sum is never longer
//     than SB terms.
//   * No atomics.  At the end each thread turns its sums into the NF
//     gradients of its (cell, node) pair, the block adds the nodes of a
//     cell in node order in float64, and one thread writes each entry:
//     two launches give identical bits.
//   * float32 takes ex2.approx and rcp.approx as the forward kernel does
//     (folded.cuh, Fn<float>): +inf -> 0, so an overflowed exponential
//     gives feq = 0 and every term of the evaluation exactly 0.

#include <cuda_runtime.h>

#include "folded.cuh"

namespace {

using namespace is3d;

constexpr int BLOCK = 128;       // most threads a block: CT cells x nodes
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

// The shared-memory layout: the block's cell rows, the staged cotangent
// (SB species x F phi x RG nodes; reused at the end for the per-(cell,
// node) gradients), the species chunk, the (cell, phi) row terms, the
// remap's node table chunk.
template <typename T>
struct Smem {
  T *raw, *gs, *mT, *m2, *sgn, *bar, *rowt, *pxs, *pys, *tab;
  double* red;
  __host__ __device__ Smem(unsigned char* p, int CT, int F, int RG, int R,
                           int mode) {
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
    tab = pys + F;
    end_ = tab + (mode == REMAP ? SB * R * 2 : 0);
  }
  T* end_;
  __host__ __device__ size_t bytes(const unsigned char* p) const {
    return reinterpret_cast<const unsigned char*>(end_) - p;
  }
};

// grid (blocks of CT cells); thread t owns cell t / R of the block at node
// t % R
template <typename T, int MODE, int DF>
__device__ __forceinline__ void bwd_body(
    const T* __restrict__ cells, int n_cells, int CT,
    const T* __restrict__ mass, const T* __restrict__ sign,
    const T* __restrict__ baryon, const T* __restrict__ deg, int S,
    const T* __restrict__ pT, int P, const T* __restrict__ px,
    const T* __restrict__ py, const T* __restrict__ cos_phi,
    const T* __restrict__ sin_phi, int F, const T* __restrict__ nodes,
    const T* __restrict__ weights, const T* __restrict__ table, int R,
    int regulate, int outflow, T prefactor, T t_ref,
    const T* __restrict__ G, T* __restrict__ grad) {
  using Fx = Fn<T>;
  constexpr int RG1 = MODE == FIXED3 ? 0 : 1;   // 1: G has no node axis
  const int RG = RG1 ? 1 : R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> s(smem_raw, CT, F, RG, R, MODE);
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
  // fixed nodes: the thread's node kinematics and composites
  T ch = T(1), sh = T(0), A1 = T(0), B1 = T(0), C1 = T(0), C2 = T(0);
  T C3 = T(0), D1 = T(0), ey = T(1), eym = T(1);
  if (MODE != REMAP) {
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
  } else {
    ey = d_exp(g[F_YFLOW]);
    eym = d_exp(-g[F_YFLOW]);
  }
  const double w = MODE == FIXED3 ? 1.0 : (double)weights[r];

  Sums a = {};
  // fixed nodes: the node sums before the node's cosh and sinh
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
          if (MODE == REMAP) {
            const T mT = d_sqrt(mass[sp] * mass[sp] + pt * pt);
            v *= d_sqrt(t_ref / (mT > t_ref ? mT : t_ref));
          }
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
      if (MODE == REMAP)
        for (int i = tid; i < SB * R * 2; i += nt) {
          const int sl = i / (R * 2), rest = i - sl * R * 2;
          const int sp = min(sb + sl, S - 1);
          s.tab[i] = table[((size_t)sp * P + p) * R * 2 + rest];
        }
      if (sb == 0) {
        for (int i = tid; i < F; i += nt) {
          s.pxs[i] = MODE == REMAP ? pt * cos_phi[i] : px[p * F + i];
          s.pys[i] = MODE == REMAP ? pt * sin_phi[i] : py[p * F + i];
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
        T qP = 0, qU = 0, q2 = 0, qX = 0, qV = 0;               // fixed
        T qPs = 0, qUs = 0, qss = 0, qcs = 0, qXs = 0, qVs = 0; // remap
        T qi = 0, qa = 0, q0 = 0, q1 = 0, q2d = 0, q3 = 0, q4 = 0, q5 = 0;
        const T* gr = s.gs + f * RG + (RG1 ? 0 : r);
        for (int sl = 0; sl < ns; ++sl) {
          const T gv = gr[sl * F * RG];
          const T mT = s.mT[sl], m2 = s.m2[sl];
          const T sgn = s.sgn[sl], b = s.bar[sl];
          T pds, pdu, pipp, Vp, cp = T(0), sp_ = T(0);
          if (MODE != REMAP) {
            pds = fma(mT, A1, W1);
            pdu = fma(mT, B1, nW2);
            pipp = fma(mT * mT, C1, fma(mT, PC, C4));
            Vp = fma(mT, D1, nD2);
          } else {
            const T hm = T(0.5) * mT;
            const T ep = ey * hm * s.tab[(sl * R + r) * 2];
            const T em = eym * hm * s.tab[(sl * R + r) * 2 + 1];
            cp = ep + em;                     // mT cosh(Delta)
            sp_ = ep - em;                    // mT sinh(Delta)
            const T tsp = tau * sp_;
            pds = fma(cp, dat, fma(sp_, dant, W1));
            pdu = fma(cp, ut, fma(-sp_, tun, nW2));
            pipp = cp * cp * pitt + tsp * tsp * pinn
                   - T(2) * cp * tsp * pitn
                   - T(2) * (x * (cp * pitx - tsp * pixn)
                             + y * (cp * pity - tsp * piyn)) + C4;
            Vp = fma(cp, Vt, fma(-tsp, Vn, nD2));
          }
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
          if (MODE != REMAP) {
            qP = fma(gp, mT, qP);
            qU = fma(gu, mT, qU);
            q2 = fma(gq * mT, mT, q2);
            qX = fma(gq, mT, qX);
            qV = fma(gVp, mT, qV);
          } else {
            qP = fma(gp, cp, qP);
            qPs = fma(gp, sp_, qPs);
            qU = fma(gu, cp, qU);
            qUs = fma(gu, sp_, qUs);
            q2 = fma(gq * cp, cp, q2);
            qss = fma(gq * sp_, sp_, qss);
            qcs = fma(gq * cp, sp_, qcs);
            qX = fma(gq, cp, qX);
            qXs = fma(gq, sp_, qXs);
            qV = fma(gVp, cp, qV);
            qVs = fma(gVp, sp_, qVs);
          }
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
        if (MODE != REMAP) {
          SP += qP;
          SU += qU;
          S2 += q2;
          SX += X * qX;
          SY += Y * qX;
          SV += qV;
        } else {
          a.Pc += qP;
          a.Ps += qPs;
          a.Uc += qU;
          a.Us += qUs;
          a.Qcc += q2;
          a.Qss += qss;
          a.Qcs += qcs;
          a.Xc += X * qX;
          a.Xs += X * qXs;
          a.Yc += Y * qX;
          a.Ys += Y * qXs;
          a.Vc += qV;
          a.Vs += qVs;
        }
      }
    }
  }
  if (MODE != REMAP) {
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
      cells, n_cells, CT, mass, sign, baryon, deg, S, pT, P, px, py, nullptr,
      nullptr, F, nodes, weights, nullptr, R, regulate, outflow, prefactor,
      T(1), G, grad);
}

template <typename T, int DF>
__global__ void __launch_bounds__(BLOCK)
remap_bwd_kernel(const T* __restrict__ cells, int n_cells, int CT,
                 const T* __restrict__ mass, const T* __restrict__ sign,
                 const T* __restrict__ baryon, const T* __restrict__ deg,
                 int S, const T* __restrict__ pT, int P,
                 const T* __restrict__ cos_phi,
                 const T* __restrict__ sin_phi, int F,
                 const T* __restrict__ table,
                 const T* __restrict__ weights, int R, int regulate,
                 int outflow, T prefactor, T t_ref, const T* __restrict__ G,
                 T* __restrict__ grad) {
  bwd_body<T, REMAP, DF>(cells, n_cells, CT, mass, sign, baryon, deg, S, pT,
                         P, nullptr, nullptr, cos_phi, sin_phi, F, nullptr,
                         weights, table, R, regulate, outflow, prefactor,
                         t_ref, G, grad);
}

// cells a block and its shared memory for a shape, or an error code
template <typename T>
int blocking(int mode, int F, int R, int* CT, size_t* smem) {
  if (R < 1 || R > BLOCK || F < 1) return cudaErrorInvalidValue;
  *CT = BLOCK / R;
  const Smem<T> s(nullptr, *CT, F, mode == FIXED3 ? R : 1, R, mode);
  *smem = s.bytes(nullptr);
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
  int CT;
  size_t smem;
  const int rc = blocking<T>(REMAP, F, R, &CT, &smem);
  if (rc != 0) return rc;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
#define IS3D_BWD(DF_)                                                         \
  launch_<T>(remap_bwd_kernel<T, DF_>, n_cells, CT, R, smem, stream,          \
             (const T*)cells, n_cells, CT, (const T*)mass, (const T*)sign,   \
             (const T*)baryon, (const T*)deg, S, (const T*)pT, P,            \
             (const T*)cos_phi, (const T*)sin_phi, F, (const T*)table,       \
             (const T*)weights, R, regulate, outflow, (T)prefactor,          \
             (T)t_ref, (const T*)G, (T*)grad)
  return df == 1 ? IS3D_BWD(1) : IS3D_BWD(2);
#undef IS3D_BWD
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

const char* is3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
