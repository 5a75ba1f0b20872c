// Smooth Cooper-Frye spectra with modified equilibrium distributions (df 3
// "Mike", df 4 "Jonah") for Hopper (sm_90a), float32 and float64.
//
// Replaces the XLA hot loop of is3d_tpu/kernels/feqmod.py:
// _chunk_contribution_feqmod (:276), routed per chunk by routed_switch
// (:606) and driven by _feqmod_spectra_jit (:665).  Two kernels:
//   * fixed_kernel: fixed nodes, 3+1D (the output rapidities) and 2+1D
//     (eta nodes, f_mod's scaled per cell by eta_scale);
//   * remap_kernel: the 2+1D mT remap, the default grid of every 2+1D run.
// The dN/dX kernel's feqmod producer (csrc/dndx.cu) is the third entry
// point; the emission value is csrc/feqmod.cuh's, shared by all three.
//
// Inputs (built by is3d_tpu_torch/kernels/feqmod.py:pack_feqmod_cells):
//   cells (n_cells, NQ) per-cell scalars, field order `FqField`
//         (== FQ_FIELDS): the momentum transform's coefficients, the
//         breakdown flag, detA, the node scale, and the linearized
//         fallback's fields and coefficients;
//   rn, wcs (n_cells, n_species): |renorm| and validity x finite renorm;
//   mass, sign, baryon, deg (n_species); pT (n_pT); px, py (n_pT n_phi) or
//   cos_phi, sin_phi (n_phi); nodes, weights (n_nodes); with the remap the
//   fallback's node table (S, P, R, 2) = exp(-+s eta_r)
//   (kernels/smooth.py:remap_node_table).
// Output: (n_species, n_pT, n_phi, n_out) x prefactor x degeneracy (x the
// remap's jacobian s(mT)), n_out = n_nodes in 3+1D, 1 in 2+1D.
//
// What bounds it on this card: SFU and FP32 issue, not bytes.  A 16384-cell
// group is 3.4 MB of cells and 21 MB of (cell, species) tables against
// 8.5e10 evaluations (3+1D, 320 species, 32 x 24 x 21), each a sqrt, an
// exp and a reciprocal (f_mod) or an exp and two reciprocals (the
// fallback) besides 16 (f_mod) or 24-29 (fallback) FP32 operations
// (kernels/feqmod.py, MOD_OPS and FALLBACK_OPS).
//
// Design.  The blocking of smooth_spectra.cu, which the linear kernels
// were redesigned around, with the emission value of feqmod.cuh:
//   * Per-cell branch.  Every thread of a block walks the same cells and
//     nodes, so the choice between f_mod and the fallback is uniform in
//     the block: a breakdown cell evaluates only the fallback, a clean
//     cell only f_mod, and a 3+1D cell with detA < 0.01 takes the fallback
//     at the nodes where |y - eta| < detA (the reference's own scalar
//     semantics, emissionfunction_smooth_kernels.cpp:811-877; JAX selects
//     per point between two chains it always evaluates).
//   * The momentum transform.  x = Minv p_LRF with p_LRF = mT (alpha ch +
//     beta sh) + gamma(px, py) comes in as coefficients
//     (kernels/feqmod.py): Minv (alpha ch + beta sh) per (cell, node),
//     staged once per tile, and Minv gamma per (cell, point), shared by
//     every node and species.  The evaluation is then 3 FMA for x, 3 for
//     |x|^2 (a sum of squares: the JAX package's expanded quadratic form
//     cancels in float32 near breakdown), the saturation, a sqrt, an exp
//     and a reciprocal.
//   * fixed_kernel: a thread owns one momentum point for J species and
//     YC nodes (3+1D the block's YC rapidities, 2+1D the eta nodes in
//     steps of YC); tiles of TILE cells and their node composites are
//     staged in shared memory; the (cell, species) renorm and validity of
//     the block's J species too.
//   * remap_kernel: f_mod's node moves with (cell, species, pT): delta =
//     y_flow + zscale s(mT) eta_r, so exp(delta) = exp(y_flow) exp(zscale
//     s eta_r) is one exp per (cell, species, pT, node), and e^-delta one
//     reciprocal; a thread owns one (species, pT) for NPHI angles and
//     RNODES nodes (remap_kernel's transposed loop in smooth_spectra.cu),
//     so both are shared by the NPHI angles, whose per-(cell, angle) terms
//     (at unit pT) are staged once per tile.  The fallback's shared nodes
//     read the node table as smooth_spectra.cu's remap kernel does.
//   * float32 takes ex2.approx on a pre-scaled argument, rcp.approx and
//     sqrt.approx, which keep +inf -> 0; float64 keeps IEEE exp, division
//     and sqrt.
//   * The cells are split into ranges (the wrapper picks the count from
//     the card's resident-block count, kernels/launch.py:split_to_fill);
//     each range writes its own partial, and fold_kernel adds them in
//     order.  No atomics: two launches give identical bits.
// A first version: simple and right; its time against its bound is in
// PERF.md.

#include <cuda_runtime.h>

#include <algorithm>

#include "feqmod.cuh"

namespace {

using namespace is3d;

constexpr int BLOCK = 128;         // momentum points per block
constexpr int J = 4;               // species per thread
constexpr int YC = 3;              // nodes per register block
constexpr int TILE = 16;           // cells per shared-memory tile
constexpr int RS2 = 12;            // 2+1D nodes per staged chunk (x YC)
constexpr int MAX_SPLIT = 8;

// ------------------------------------------------ fixed rapidity nodes

// grid (point blocks, species groups of J, n_split x node groups of YC
// (3+1D) or n_split (2+1D)); partial (n_split, S, M, n_out), unscaled
template <typename T, int DIM>
__global__ void __launch_bounds__(BLOCK, sizeof(T) == 4 ? 3 : 2)
fixed_kernel(const T* __restrict__ cells, int n_cells, int cells_per_split,
             const T* __restrict__ rn, const T* __restrict__ wcs,
             const T* __restrict__ mass, const T* __restrict__ sign,
             const T* __restrict__ baryon, int n_species,
             const T* __restrict__ pT, const T* __restrict__ px,
             const T* __restrict__ py, int M, int n_phi,
             const T* __restrict__ nodes, const T* __restrict__ weights,
             int n_nodes, int df_mode, int sw, int regulate, int outflow,
             T* __restrict__ partial) {
  using F = Fn<T>;
  constexpr int RSC = DIM == 3 ? YC : RS2;
  __shared__ __align__(16) T raw[TILE * NQ];
  __shared__ __align__(16) T comp[TILE * RSC * NKQ];
  __shared__ T srn[TILE * J];
  __shared__ T swc[TILE * J];

  const int tid = threadIdx.x;
  const int nz = DIM == 3 ? (n_nodes + YC - 1) / YC : 1;
  const int split = blockIdx.z / nz;
  const int rbeg = DIM == 3 ? (blockIdx.z - split * nz) * YC : 0;
  const int rend = DIM == 3 ? min(rbeg + YC, n_nodes) : n_nodes;
  const int cbeg = split * cells_per_split;
  const int cend = min(n_cells, cbeg + cells_per_split);
  const int m = blockIdx.x * BLOCK + tid;
  const int s0 = blockIdx.y * J;
  const int n_out = DIM == 3 ? n_nodes : 1;
  const T L = F::SCALE;

  // the thread's momentum point for its J species (ragged edges clamped
  // to a real point and species, never stored)
  const int mc = min(m, M - 1);
  const T pxv = px[mc], pyv = py[mc];
  const T pt = pT[mc / n_phi];
  const T px2 = pxv * pxv, py2 = pyv * pyv, pxpy = pxv * pyv;
  T mT[J], mT2[J], m2[J], sgn[J], bar[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int s = min(s0 + j, n_species - 1);
    m2[j] = mass[s] * mass[s];
    mT[j] = d_sqrt(m2[j] + pt * pt);
    mT2[j] = mT[j] * mT[j];
    sgn[j] = sign[s];
    bar[j] = baryon[s];
  }

  T acc[J][YC];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int y = 0; y < YC; ++y) acc[j][y] = T(0);

  for (int c0 = cbeg; c0 < cend; c0 += TILE) {
    const int nc = min(TILE, cend - c0);
    __syncthreads();                                 // previous tile consumed
    for (int i = tid; i < nc * NQ; i += BLOCK)
      raw[i] = cells[(size_t)c0 * NQ + i];
    for (int i = tid; i < nc * J; i += BLOCK) {
      const int c = i / J;
      const size_t at = (size_t)(c0 + c) * n_species
                        + min(s0 + i - c * J, n_species - 1);
      srn[i] = rn[at];
      swc[i] = wcs[at];
    }
    __syncthreads();
    for (int r0 = rbeg; r0 < rend; r0 += RSC) {
      // nodes of this chunk, rounded up to whole register blocks; the
      // padding repeats the last node with weight 0 (2+1D) or is not
      // stored (3+1D)
      const int nr = min(RSC, rend - r0);
      const int nrp = DIM == 3 ? YC : (nr + YC - 1) / YC * YC;
      if (r0 != rbeg) __syncthreads();               // previous chunk consumed
      for (int i = tid; i < nc * nrp; i += BLOCK) {
        const int c = i / nrp;
        const int rr = i - c * nrp;
        const int r = min(r0 + rr, n_nodes - 1);
        const T w = DIM == 3 ? T(1) : (r0 + rr < rend ? weights[r] : T(0));
        feqmod_node<T, DIM>(raw + c * NQ, nodes[r], w,
                            comp + (c * RSC + rr) * NKQ);
      }
      __syncthreads();
      for (int c = 0; c < nc; ++c) {
        const T* g = raw + c * NQ;
        const bool bd = g[Q_BD] != T(0);
        const bool narrow = feqmod_narrow<T, DIM>(g);
        // per (cell, point)
        const T W1 = fma(g[Q_DAX], pxv, g[Q_DAY] * pyv);
        T gam[3];
#pragma unroll
        for (int k3 = 0; k3 < 3; ++k3)
          gam[k3] = fma(g[Q_GX0 + k3], pxv, g[Q_GY0 + k3] * pyv);
        const T invTmL = L * g[Q_INVTM];
        T nW2 = T(0), C4 = T(0), nD2 = T(0);
        FbCoef<T> k{};
        if (bd || narrow) {
          nW2 = -fma(g[Q_UX], pxv, g[Q_UY] * pyv);
          C4 = fma(g[Q_PIXX], px2,
                   fma(g[Q_PIYY], py2, T(2) * g[Q_PIXY] * pxpy));
          nD2 = -fma(g[Q_VX], pxv, g[Q_VY] * pyv);
          k = fb_coef(g);
        }
        // per (cell, species)
        T nbm[J], rnj[J], wj[J];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          nbm[j] = -L * g[Q_ABM] * bar[j];
          rnj[j] = srn[c * J + j];
          wj[j] = swc[c * J + j];
        }
        const T* kc = comp + c * RSC * NKQ;
        for (int rr = 0; rr < nrp; rr += YC) {
#pragma unroll
          for (int y = 0; y < YC; ++y) {
            const T* q = kc + (rr + y) * NKQ;
            const T w = q[10];
            if (!(bd || (narrow && q[11] != T(0)))) {
              const T A1 = q[0];
#pragma unroll
              for (int j = 0; j < J; ++j) {
                const T x2 = x_squared(mT[j], q + 1, gam);
                const T f = mod_value(x2, m2[j], invTmL, nbm[j], sgn[j],
                                      rnj[j]);
                const T v = emit_mod(fma(mT[j], A1, W1), f, outflow) * wj[j];
                acc[j][y] = fma(w, v, acc[j][y]);
              }
            } else {
              const T A1 = q[4], B1 = q[5], C1 = q[6], D1 = q[9];
              const T c23 = fma(pxv, q[7], pyv * q[8]);
#pragma unroll
              for (int j = 0; j < J; ++j) {
                const T pdu = fma(mT[j], B1, nW2);
                const T pipp = fma(mT2[j], C1, fma(mT[j], c23, C4));
                const T Vp = fma(mT[j], D1, nD2);
                const T f = fallback_value(df_mode, sw, pdu, pipp, Vp, m2[j],
                                           sgn[j], bar[j], k, regulate);
                const T v = emit(fma(mT[j], A1, W1), f, outflow) * wj[j];
                acc[j][y] = fma(w, v, acc[j][y]);
              }
            }
          }
        }
      }
    }
  }
  if (m >= M) return;
  T* o = partial + (size_t)split * n_species * M * (size_t)n_out;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int s = s0 + j;
    if (s >= n_species) continue;
    if (DIM == 3) {
#pragma unroll
      for (int y = 0; y < YC; ++y)
        if (rbeg + y < rend)
          o[((size_t)s * M + m) * n_nodes + rbeg + y] = acc[j][y];
    } else {
      T v = T(0);
#pragma unroll
      for (int y = 0; y < YC; ++y) v += acc[j][y];
      o[(size_t)s * M + m] = v;
    }
  }
}

// ------------------------------------------------------- 2+1D mT remap

constexpr int RBLOCK = 128;        // (species, pT) threads per block
constexpr int RYC = 3;             // nodes per register block
constexpr int RNODES = 12;         // nodes per block (a multiple of RYC)
constexpr int RTILE = 8;           // cells per shared-memory tile
constexpr int NPR = 12;            // staged values per (cell, phi)
constexpr int MAX_RSPLIT = 64;

// the NPR values of one (cell, phi) at unit pT (cf, sf = cos, sin phi):
// f_mod's w1 (p.dsigma) and gamma1 (x's point term, 3); the fallback's
// -w2, -d2, c4, and g, h with px C2 + py C3 = ch g + sh h
template <typename T>
__device__ __forceinline__ void stage_row(const T* g, T cf, T sf, T* o) {
  o[0] = g[Q_DAX] * cf + g[Q_DAY] * sf;
  o[1] = g[Q_GX0] * cf + g[Q_GY0] * sf;
  o[2] = g[Q_GX1] * cf + g[Q_GY1] * sf;
  o[3] = g[Q_GX2] * cf + g[Q_GY2] * sf;
  o[4] = -(g[Q_UX] * cf + g[Q_UY] * sf);
  o[5] = -(g[Q_VX] * cf + g[Q_VY] * sf);
  o[6] = g[Q_PIXX] * cf * cf + g[Q_PIYY] * sf * sf
         + T(2) * g[Q_PIXY] * cf * sf;
  o[7] = T(-2) * (g[Q_PITX] * cf + g[Q_PITY] * sf);
  o[8] = T(2) * g[Q_TAU] * (g[Q_PIXN] * cf + g[Q_PIYN] * sf);
  o[9] = T(0);
  o[10] = T(0);
  o[11] = T(0);
}

// grid (blocks of RBLOCK (species, pT) pairs, phi chunks of NPHI, n_split x
// node chunks of RNODES); thread i owns species i / n_pT at pT i % n_pT
// for the block's NPHI angles and RNODES nodes.  partial (n_split x node
// chunks, S, P, F), unscaled.
template <typename T, int NPHI>
__global__ void __launch_bounds__(RBLOCK, sizeof(T) == 4 ? 3 : 2)
remap_kernel(const T* __restrict__ cells, int n_cells, int cells_per_split,
             const T* __restrict__ rn, const T* __restrict__ wcs,
             const T* __restrict__ mass, const T* __restrict__ sign,
             const T* __restrict__ baryon, int n_species,
             const T* __restrict__ pT, int n_pT,
             const T* __restrict__ cos_phi, const T* __restrict__ sin_phi,
             int n_phi, const T* __restrict__ table,
             const T* __restrict__ nodes, const T* __restrict__ weights,
             int n_nodes, int df_mode, int sw, int regulate, int outflow,
             T t_ref, T* __restrict__ partial) {
  using F = Fn<T>;
  __shared__ __align__(16) T tab[RNODES * RBLOCK * 2];  // [node][thread][-,+]
  __shared__ __align__(16) T rows[RTILE * NPHI * NPR];  // [cell][phi][NPR]
  __shared__ T raw[RTILE * NQ];
  __shared__ T wts[RNODES];
  __shared__ T eta[RNODES];

  const int tid = threadIdx.x;
  const int n_sp = n_species * n_pT;
  const int i = blockIdx.x * RBLOCK + tid;
  const int ic = min(i, n_sp - 1);         // ragged edge: clamped, not stored
  const int s = ic / n_pT;
  const int n_chunks = (n_nodes + RNODES - 1) / RNODES;
  const int split = blockIdx.z / n_chunks;
  const int r0 = (blockIdx.z - split * n_chunks) * RNODES;
  const int nr = min(RNODES, n_nodes - r0);
  const int nrp = (nr + RYC - 1) / RYC * RYC;
  const int f0 = blockIdx.y * NPHI;
  const int cbeg = split * cells_per_split;
  const int cend = min(n_cells, cbeg + cells_per_split);
  const T L = F::SCALE;

  const T pt = pT[ic - s * n_pT];
  const T pt2 = pt * pt;
  const T m2 = mass[s] * mass[s];
  const T mTv = d_sqrt(m2 + pt2);
  const T hmT = T(0.5) * mTv;
  const T sgn = sign[s];
  const T bar = baryon[s];
  // s(mT) of the node map (kernels/smooth.py:remap_scale), x L for the exp
  const T sv = d_sqrt(t_ref / (mTv > t_ref ? mTv : t_ref));

  // the thread's fallback node factors; the padding up to whole register
  // blocks repeats the last node with weight 0
  for (int rr = 0; rr < nrp; ++rr) {
    const size_t at = ((size_t)ic * n_nodes + min(r0 + rr, n_nodes - 1)) * 2;
    tab[(rr * RBLOCK + tid) * 2] = table[at];
    tab[(rr * RBLOCK + tid) * 2 + 1] = table[at + 1];
  }
  if (tid < RNODES) {
    wts[tid] = tid < nr ? weights[r0 + tid] : T(0);
    eta[tid] = nodes[min(r0 + tid, n_nodes - 1)];
  }

  T acc[NPHI];
#pragma unroll
  for (int f = 0; f < NPHI; ++f) acc[f] = T(0);

  for (int c0 = cbeg; c0 < cend; c0 += RTILE) {
    const int nc = min(RTILE, cend - c0);
    __syncthreads();                                 // previous tile consumed
    for (int k = tid; k < nc * NQ; k += RBLOCK)
      raw[k] = cells[(size_t)c0 * NQ + k];
    __syncthreads();
    for (int k = tid; k < nc * NPHI; k += RBLOCK) {
      const int c = k / NPHI;
      const int fc = min(f0 + k - c * NPHI, n_phi - 1);
      stage_row<T>(raw + c * NQ, cos_phi[fc], sin_phi[fc], rows + k * NPR);
    }
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
      const T* g = raw + c * NQ;
      const T* rw = rows + c * NPHI * NPR;
      const size_t cs = (size_t)(c0 + c) * n_species + s;
      const T wc = wcs[cs];
      if (g[Q_BD] == T(0)) {
        // f_mod: per (cell, species, pT)
        const T zs = g[Q_SCALE];
        const T eyf = d_exp(g[Q_YFM]);
        const T zsv = L * (zs * sv);
        const T rnz = rn[cs] * zs;
        const T invTmL = L * g[Q_INVTM];
        const T nbm = -L * g[Q_ABM] * bar;
        // (mT / 2)(dat +- dant) and (mT / 2)(a_k +- b_k): ch and sh of the
        // node as (e^delta +- e^-delta) / 2
        const T hA = hmT * (g[Q_DAT] + g[Q_DANT]);
        const T hB = hmT * (g[Q_DAT] - g[Q_DANT]);
        T hp[3], hm[3];
#pragma unroll
        for (int k3 = 0; k3 < 3; ++k3) {
          hp[k3] = hmT * (g[Q_A0 + k3] + g[Q_B0 + k3]);
          hm[k3] = hmT * (g[Q_A0 + k3] - g[Q_B0 + k3]);
        }
        for (int rr = 0; rr < nrp; rr += RYC) {
          // per (cell, species, pT, node): e^delta from one exp, e^-delta
          // from one reciprocal, then p.dsigma's and x's node terms
          T A[RYC], X[RYC][3], w[RYC];
#pragma unroll
          for (int y = 0; y < RYC; ++y) {
            const T eq = eyf * F::exp_scaled(zsv * eta[rr + y]);
            const T rq = F::rcp(eq);
            A[y] = fma(hA, eq, hB * rq);
#pragma unroll
            for (int k3 = 0; k3 < 3; ++k3)
              X[y][k3] = fma(hp[k3], eq, hm[k3] * rq);
            w[y] = wts[rr + y];
          }
#pragma unroll
          for (int f = 0; f < NPHI; ++f) {
            const T* q = rw + f * NPR;
            const T w1 = q[0];
            const T gam[3] = {pt * q[1], pt * q[2], pt * q[3]};
#pragma unroll
            for (int y = 0; y < RYC; ++y) {
              const T x2 = x_squared(T(1), X[y], gam);
              const T fm = mod_value(x2, m2, invTmL, nbm, sgn, rnz);
              const T v = emit_mod(fma(pt, w1, A[y]), fm, outflow) * wc;
              acc[f] = fma(w[y], v, acc[f]);
            }
          }
        }
      } else {
        // the fallback at the shared nodes Delta = y_flow - s eta_r
        const FbCoef<T> k = fb_coef(g);
        const T eyh = d_exp(g[Q_YFLOW]) * hmT;
        const T eymh = d_exp(-g[Q_YFLOW]) * hmT;
        const T dat = g[Q_DAT], dant = g[Q_DANT];
        const T ut = g[Q_UT], ntun = -g[Q_TUN];
        const T vt = g[Q_VT], nvn = -g[Q_TAU] * g[Q_VN];
        const T c1a = g[Q_PITT];
        const T c1b = g[Q_TAU] * g[Q_TAU] * g[Q_PINN];
        const T c1c = T(-2) * g[Q_TAU] * g[Q_PITN];
        for (int rr = 0; rr < nrp; rr += RYC) {
          T A[RYC], B[RYC], D[RYC], C1[RYC], cg[RYC], sg[RYC], w[RYC];
#pragma unroll
          for (int y = 0; y < RYC; ++y) {
            const T tm = tab[((rr + y) * RBLOCK + tid) * 2];
            const T tp = tab[((rr + y) * RBLOCK + tid) * 2 + 1];
            const T ep = eyh * tm;
            const T em = eymh * tp;
            const T ch = ep + em;
            const T sh = ep - em;
            A[y] = fma(ch, dat, sh * dant);
            B[y] = fma(ch, ut, sh * ntun);
            D[y] = fma(ch, vt, sh * nvn);
            C1[y] = fma(ch * ch, c1a, fma(sh * sh, c1b, ch * sh * c1c));
            cg[y] = ch * pt;
            sg[y] = sh * pt;
            w[y] = wts[rr + y];
          }
#pragma unroll
          for (int f = 0; f < NPHI; ++f) {
            const T* q = rw + f * NPR;
            const T w1 = q[0], nw2 = q[4], nd2 = q[5], c4 = q[6];
            const T gg = q[7], hh = q[8];
#pragma unroll
            for (int y = 0; y < RYC; ++y) {
              const T pdu = fma(pt, nw2, B[y]);
              const T Vp = fma(pt, nd2, D[y]);
              const T pipp =
                  fma(cg[y], gg, fma(sg[y], hh, fma(pt2, c4, C1[y])));
              const T fv = fallback_value(df_mode, sw, pdu, pipp, Vp, m2, sgn,
                                          bar, k, regulate);
              const T v = emit(fma(pt, w1, A[y]), fv, outflow) * wc;
              acc[f] = fma(w[y], v, acc[f]);
            }
          }
        }
      }
    }
  }
  if (i >= n_sp) return;
  T* o = partial + ((size_t)blockIdx.z * n_sp + i) * n_phi + f0;
#pragma unroll
  for (int f = 0; f < NPHI; ++f)
    if (f0 + f < n_phi) o[f] = acc[f];
}

// out[i] = prefactor deg[s] (s(mT)) sum over the parts (in order) of
// partial; i runs over (S, n_pT, n_phi, n_out), s(mT) = sqrt(T_ref /
// max(mT, T_ref)) the jacobian of the remap (t_ref > 0 only)
template <typename T>
__global__ void __launch_bounds__(256)
fold_kernel(const T* __restrict__ partial, int n_parts, long long n,
            int n_pT, int n_phi, int n_out, const T* __restrict__ mass,
            const T* __restrict__ pT, const T* __restrict__ deg, T prefactor,
            T t_ref, T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  T v = T(0);
  for (int k = 0; k < n_parts; ++k) v += partial[k * n + i];
  const long long sp = i / ((long long)n_phi * n_out);
  const int s = (int)(sp / n_pT);
  if (t_ref > T(0)) {
    const T pt = pT[sp - (long long)s * n_pT];
    const T mT = d_sqrt(mass[s] * mass[s] + pt * pt);
    v = v * d_sqrt(t_ref / (mT > t_ref ? mT : t_ref));
  }
  out[i] = prefactor * deg[s] * v;
}

// ------------------------------------------------------------ launchers

// angles per thread of the remap kernel: of 8, 16 and 24 the width that
// pads n_phi the least, the largest of equals
int remap_phi_width(int n_phi) {
  int best = 8;
  for (int w = 16; w <= 24; w += 8)
    if ((n_phi + w - 1) / w * w <= (n_phi + best - 1) / best * best) best = w;
  return best;
}

bool shape_ok(int n_species, int n_pT, int n_phi, int n_nodes,
              int dimension) {
  return n_species >= 1 && n_pT >= 1 && n_phi >= 1 && n_nodes >= 1 &&
         (dimension == 2 || dimension == 3) &&
         (long long)n_species * n_pT * n_phi * n_nodes < 0x7fffffffLL &&
         (n_species + J - 1) / J <= 65535;
}

template <typename K>
int resident(K kernel, int threads, int* slots) {
  int dev = 0, n_sm = 0, per_sm = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc == 0)
    rc = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                     dev);
  if (rc == 0)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                            threads, 0);
  if (rc != 0) return rc;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *slots = n_sm * per_sm;
  return cudaSuccess;
}

// a kernel's grid for a shape on the current card, the one owner of the
// blocking: out = {blocks for each range of cells, resident blocks (SMs x
// blocks per SM), partial sums for each range of cells, cells per tile,
// most ranges of cells, angles per thread (remap; 0 at fixed nodes)}
template <typename T>
int feqmod_grid(int n_species, int n_pT, int n_phi, int n_nodes,
                int dimension, int remap, int* out) {
  if (!shape_ok(n_species, n_pT, n_phi, n_nodes, dimension) ||
      (remap && dimension != 2) || out == nullptr)
    return cudaErrorInvalidValue;
  int slots = 0, rc;
  if (remap) {
    const int width = remap_phi_width(n_phi);
    if (width == 8) rc = resident(remap_kernel<T, 8>, RBLOCK, &slots);
    else if (width == 16) rc = resident(remap_kernel<T, 16>, RBLOCK, &slots);
    else rc = resident(remap_kernel<T, 24>, RBLOCK, &slots);
    if (rc != 0) return rc;
    const long long n_sp = (long long)n_species * n_pT;
    const long long chunks = (n_nodes + RNODES - 1) / RNODES;
    const long long blocks = (n_sp + RBLOCK - 1) / RBLOCK
                             * ((n_phi + width - 1) / width) * chunks;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    out[0] = (int)blocks;
    out[1] = slots;
    out[2] = (int)chunks;
    out[3] = RTILE;
    out[4] = MAX_RSPLIT;
    out[5] = width;
    return cudaSuccess;
  }
  rc = dimension == 3 ? resident(fixed_kernel<T, 3>, BLOCK, &slots)
                      : resident(fixed_kernel<T, 2>, BLOCK, &slots);
  if (rc != 0) return rc;
  const long long M = (long long)n_pT * n_phi;
  const long long nz = dimension == 3 ? (n_nodes + YC - 1) / YC : 1;
  const long long blocks = (M + BLOCK - 1) / BLOCK
                           * ((n_species + J - 1) / J) * nz;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  out[0] = (int)blocks;
  out[1] = slots;
  out[2] = 1;
  out[3] = TILE;
  out[4] = MAX_SPLIT;
  out[5] = 0;
  return cudaSuccess;
}

template <typename T>
int fold(const void* partial, int n_parts, int n_species, int n_pT,
         int n_phi, int n_out, const void* mass, const void* pT,
         const void* deg, double prefactor, double t_ref, void* out,
         cudaStream_t stream) {
  const long long n = (long long)n_species * n_pT * n_phi * n_out;
  fold_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(partial), n_parts, n, n_pT, n_phi, n_out,
      static_cast<const T*>(mass), static_cast<const T*>(pT),
      static_cast<const T*>(deg), (T)prefactor, (T)t_ref,
      static_cast<T*>(out));
  return (int)cudaGetLastError();
}

// the ranges of cells of a launch, or 0 where the split does not fit
long long n_ranges(int n_cells, int cells_per_split, int tile) {
  if (n_cells < 1 || cells_per_split < 1) return 0;
  const long long n = ((long long)n_cells + cells_per_split - 1)
                      / cells_per_split;
  // a split of whole tiles, so no tile straddles two blocks
  if (n > 1 && cells_per_split % tile != 0) return 0;
  return n;
}

template <typename T>
int launch_fixed(const void* cells, int n_cells, int nq, const void* rn,
                 const void* wcs, const void* mass, const void* sign,
                 const void* baryon, const void* deg, int n_species,
                 const void* pT, const void* px, const void* py, int n_pT,
                 int n_phi, const void* nodes, const void* weights,
                 int n_nodes, int df_mode, int dimension, int sw,
                 int regulate, int outflow, double prefactor,
                 int cells_per_split, int n_partial, void* partial,
                 void* out, void* stream_v) {
  const long long n_split = n_ranges(n_cells, cells_per_split, TILE);
  if (nq != NQ || (df_mode != 3 && df_mode != 4) ||
      !shape_ok(n_species, n_pT, n_phi, n_nodes, dimension) ||
      n_split < 1 || n_split > MAX_SPLIT || n_split != n_partial ||
      partial == nullptr)
    return cudaErrorInvalidValue;
  const long long M = (long long)n_pT * n_phi;
  const unsigned nz =
      dimension == 3 ? (unsigned)((n_nodes + YC - 1) / YC) : 1u;
  if ((long long)nz * n_split > 65535) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  const dim3 grid((unsigned)((M + BLOCK - 1) / BLOCK),
                  (unsigned)((n_species + J - 1) / J),
                  nz * (unsigned)n_split);
#define IS3D_FIXED(DIM_)                                                      \
  fixed_kernel<T, DIM_><<<grid, BLOCK, 0, stream>>>(                          \
      static_cast<const T*>(cells), n_cells, cells_per_split,                \
      static_cast<const T*>(rn), static_cast<const T*>(wcs),                 \
      static_cast<const T*>(mass), static_cast<const T*>(sign),              \
      static_cast<const T*>(baryon), n_species, static_cast<const T*>(pT),   \
      static_cast<const T*>(px), static_cast<const T*>(py), (int)M, n_phi,   \
      static_cast<const T*>(nodes), static_cast<const T*>(weights), n_nodes, \
      df_mode, sw, regulate, outflow, static_cast<T*>(partial))
  if (dimension == 3) IS3D_FIXED(3); else IS3D_FIXED(2);
#undef IS3D_FIXED
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return fold<T>(partial, (int)n_split, n_species, n_pT, n_phi,
                 dimension == 3 ? n_nodes : 1, mass, pT, deg, prefactor, 0.0,
                 out, stream);
}

template <typename T>
int launch_remap(const void* cells, int n_cells, int nq, const void* rn,
                 const void* wcs, const void* mass, const void* sign,
                 const void* baryon, const void* deg, int n_species,
                 const void* pT, int n_pT, const void* cos_phi,
                 const void* sin_phi, int n_phi, const void* table,
                 const void* nodes, const void* weights, int n_nodes,
                 int df_mode, int sw, int regulate, int outflow,
                 double prefactor, double t_ref, int cells_per_split,
                 int n_partial, void* partial, void* out, void* stream_v) {
  const long long n_split = n_ranges(n_cells, cells_per_split, RTILE);
  const int width = remap_phi_width(n_phi);
  const long long n_parts = n_split * ((n_nodes + RNODES - 1) / RNODES);
  const long long n_sp = (long long)n_species * n_pT;
  if (nq != NQ || (df_mode != 3 && df_mode != 4) ||
      !shape_ok(n_species, n_pT, n_phi, n_nodes, 2) || n_split < 1 ||
      n_split > MAX_RSPLIT || n_parts != n_partial || n_parts > 65535 ||
      (n_phi + width - 1) / width > 65535 || !(t_ref > 0.0) ||
      partial == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  const dim3 grid((unsigned)((n_sp + RBLOCK - 1) / RBLOCK),
                  (unsigned)((n_phi + width - 1) / width),
                  (unsigned)n_parts);
#define IS3D_REMAP(NPHI_)                                                     \
  remap_kernel<T, NPHI_><<<grid, RBLOCK, 0, stream>>>(                        \
      static_cast<const T*>(cells), n_cells, cells_per_split,                \
      static_cast<const T*>(rn), static_cast<const T*>(wcs),                 \
      static_cast<const T*>(mass), static_cast<const T*>(sign),              \
      static_cast<const T*>(baryon), n_species, static_cast<const T*>(pT),   \
      n_pT, static_cast<const T*>(cos_phi), static_cast<const T*>(sin_phi),  \
      n_phi, static_cast<const T*>(table), static_cast<const T*>(nodes),     \
      static_cast<const T*>(weights), n_nodes, df_mode, sw, regulate,        \
      outflow, (T)t_ref, static_cast<T*>(partial))
  if (width == 8) IS3D_REMAP(8);
  else if (width == 16) IS3D_REMAP(16);
  else IS3D_REMAP(24);
#undef IS3D_REMAP
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return fold<T>(partial, (int)n_parts, n_species, n_pT, n_phi, 1, mass, pT,
                 deg, prefactor, t_ref, out, stream);
}

}  // namespace

extern "C" {

// a feqmod kernel's grid on the current card (see feqmod_grid); returns a
// CUDA error code
int is3d_feqmod_grid_f32(int n_species, int n_pT, int n_phi, int n_nodes,
                         int dimension, int remap, int* out) {
  return feqmod_grid<float>(n_species, n_pT, n_phi, n_nodes, dimension,
                            remap, out);
}
int is3d_feqmod_grid_f64(int n_species, int n_pT, int n_phi, int n_nodes,
                         int dimension, int remap, int* out) {
  return feqmod_grid<double>(n_species, n_pT, n_phi, n_nodes, dimension,
                             remap, out);
}

// fixed nodes: partial (n_partial = ranges of cells, S, P, F, n_out)
#define IS3D_FEQMOD_ENTRY(NAME, T)                                            \
  int NAME(const void* cells, int n_cells, int nq, const void* rn,           \
           const void* wcs, const void* mass, const void* sign,              \
           const void* baryon, const void* deg, int n_species,               \
           const void* pT, const void* px, const void* py, int n_pT,         \
           int n_phi, const void* nodes, const void* weights, int n_nodes,   \
           int df_mode, int dimension, int sw, int regulate, int outflow,    \
           double prefactor, int cells_per_split, int n_partial,             \
           void* partial, void* out, void* stream) {                         \
    return launch_fixed<T>(cells, n_cells, nq, rn, wcs, mass, sign, baryon,  \
                           deg, n_species, pT, px, py, n_pT, n_phi, nodes,   \
                           weights, n_nodes, df_mode, dimension, sw,         \
                           regulate, outflow, prefactor, cells_per_split,    \
                           n_partial, partial, out, stream);                 \
  }
IS3D_FEQMOD_ENTRY(is3d_feqmod_f32, float)
IS3D_FEQMOD_ENTRY(is3d_feqmod_f64, double)
#undef IS3D_FEQMOD_ENTRY

// the 2+1D mT remap: table (S, P, R, 2) = exp(-s eta_r), exp(+s eta_r),
// partial (n_partial = ranges of cells x chunks of nodes, S, P, F)
#define IS3D_FEQMOD_REMAP_ENTRY(NAME, T)                                      \
  int NAME(const void* cells, int n_cells, int nq, const void* rn,           \
           const void* wcs, const void* mass, const void* sign,              \
           const void* baryon, const void* deg, int n_species,               \
           const void* pT, int n_pT, const void* cos_phi,                    \
           const void* sin_phi, int n_phi, const void* table,                \
           const void* nodes, const void* weights, int n_nodes, int df_mode, \
           int sw, int regulate, int outflow, double prefactor,              \
           double t_ref, int cells_per_split, int n_partial, void* partial,  \
           void* out, void* stream) {                                        \
    return launch_remap<T>(cells, n_cells, nq, rn, wcs, mass, sign, baryon,  \
                           deg, n_species, pT, n_pT, cos_phi, sin_phi,       \
                           n_phi, table, nodes, weights, n_nodes, df_mode,   \
                           sw, regulate, outflow, prefactor, t_ref,          \
                           cells_per_split, n_partial, partial, out,         \
                           stream);                                          \
  }
IS3D_FEQMOD_REMAP_ENTRY(is3d_feqmod_remap_f32, float)
IS3D_FEQMOD_REMAP_ENTRY(is3d_feqmod_remap_f64, double)
#undef IS3D_FEQMOD_REMAP_ENTRY

const char* is3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
