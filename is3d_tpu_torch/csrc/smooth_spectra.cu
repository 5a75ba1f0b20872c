// Smooth Cooper-Frye spectra with linear delta-f (df 1: 14-moment, df 2:
// Chapman-Enskog) for Hopper (sm_90a), float32 and float64.
//
// Replaces is3d_tpu/kernels/pallas_smooth.py::_kernel (launched by
// _pallas_spectra_jit).  Held to the production JAX body
// is3d_tpu/kernels/smooth.py::_chunk_contribution, so beyond the TPU kernel
// it also covers the 2+1D mT-adaptive eta-node remap, float64, and a
// fixed-order cell reduction.
//
// Inputs (built by is3d_tpu_torch/kernels/smooth.py):
//   cells   (n_cells, NF) row-major per-cell scalars, field order `Field`
//           in emission.cuh (== FIELDS in smooth.py); pad rows are inert
//   mass, sign, baryon, deg (n_species); pT (n_pT); px, py (n_pT*n_phi);
//   nodes, weights (n_nodes): 3+1D the output rapidities, 2+1D the eta
//           quadrature.
// Output: out (n_species, n_pT, n_phi, n_out), n_out = n_nodes in 3+1D,
// 1 in 2+1D, already x prefactor x degeneracy.
//
// What bounds it on this card: FP32 and SFU issue, not bytes.  A group of
// 16384 cells is 2.4 MB and stays in L2, and every evaluation (cell, node,
// species, momentum point) needs an exp and one (df 1) or two (df 2)
// reciprocals besides its fma chain.  The formula itself needs 19 FP32
// operations and 3 SFU operations per df-2 evaluation (kernels/smooth.py,
// FORMULA_OPS), and the SFU pipe has an eighth of the FP32 lanes, so SFU
// issue sets the bound for df 2 (FP32 for df 1).  The parent issued 159
// instructions per df-2 evaluation (56 FP32, 24 shared loads, ~40 integer,
// an IEEE division sequence for each reciprocal); tools/sass_count.py
// counts the loop of this one (PERF.md, section 6).
//
// Design (fixed rapidity nodes: 3+1D, and 2+1D without the remap).
//   * Register blocking.  A thread owns one momentum point (pT, phi) for
//     J species and YC nodes: 3+1D the block's YC output rapidities, 2+1D
//     the eta nodes in steps of YC.  Per cell it forms the per-(cell,
//     point) terms W1, W2, C4, D2 once for J x YC evaluations, the
//     per-(cell, species) terms once for YC, and loads the per-(cell, node)
//     composites once for J.
//   * Staging.  A tile of TILE cells is copied to shared memory, then
//     re-laid as cell-major rows with compile-time strides: NS = 16 cell
//     scalars (four 16-byte loads) and 8 composites per (cell, node) (two
//     loads; stage_scalars and stage_composites in folded.cuh, shared
//     with dndx.cu).  Constants of the cell are folded in at staging:
//     log2(e)/T for an exp2, the shear coefficient into pi, the
//     diffusion coefficient into V, the bulk coefficients into three
//     products.
//   * Special functions.  float32 uses ex2.approx on the pre-scaled
//     argument and rcp.approx (no IEEE division sequence, no blanket fast
//     math); both give +inf -> 0, so exp(u.p/T) may overflow to +inf and
//     1/(inf + s) is exactly 0, as the reference's semantics ask.  float64
//     keeps the IEEE exp and division.
//   * Occupancy.  Blocks are uniform in work, so a grid of a few waves
//     loses its last, partial wave.  The launcher splits the cells into
//     n_split contiguous ranges, chosen from the card's resident-block
//     count to fill the waves; the per-split partials go to a second,
//     fixed-order pass (fold_kernel).  Every sum runs in a fixed order and
//     nothing uses atomics, so two launches give identical bits.
//
// Design (2+1D mT remap, remap_kernel).  The nodes move with (cell,
// species, pT): Delta = y_flow(cell) - s(mT) eta_r.  The first version (a
// thread per (species, pT, phi) point calling exp and an IEEE division per
// (cell, node) and the unfolded emission function) took 930 ms per group of
// 16384 cells x 320 x 768 x 48 where the fixed-node kernel takes 209 ms.
//   * No special function in the loop.  exp(Delta) = exp(y_flow) exp(-s
//     eta_r): the wrapper prepacks exp(-+s eta_r) per (species, pT, node)
//     (kernels/smooth.py:remap_node_table), exp(+-y_flow) is staged per
//     cell, and mT cosh(Delta), mT sinh(Delta) are two products, a sum and
//     a difference.
//   * The transposed loop of dndx.cu.  Nothing of the node kinematics
//     depends on phi, so a thread owns one (species, pT) for NPHI angles and
//     RNODES nodes: it forms the composites of RYC nodes once (18 FP32 per
//     node) and walks the angles, whose per-(cell, phi) terms are the same
//     for every thread of the block and come as two broadcast loads of a
//     row staged at unit pT (px = pT cos phi: the thread multiplies by its
//     own pT inside the fma it needs anyway, so a block mixes any species
//     and pT).  px C2 + py C3 regroups as mT cosh g(cell, phi) + mT sinh
//     h(cell, phi), so C2 and C3 are never formed.  The NPHI sums stay in
//     registers (the angle loop is unrolled; NPHI is 8, 16 or 24).  Three
//     nodes a register block and five blocks per SM (at most 102
//     registers; float32 takes 95, no spills) were the fastest of the
//     blockings timed (PERF.md, section 6).
//   * The evaluation is folded_f of folded.cuh, as in the other kernels.
//   * Occupancy.  (species, pT) pairs give few threads (10240 at 320 x 32),
//     so the grid also spans chunks of RNODES nodes and n_split ranges of
//     cells (the wrapper picks n_split from remap_grid's block counts,
//     kernels/launch.py:split_to_fill); remap_fold_kernel adds the parts in
//     order and applies the jacobian s(mT), the prefactor and the
//     degeneracy.  No atomics: two launches give identical bits.

#include <cuda_runtime.h>

#include <algorithm>

#include "folded.cuh"

namespace {

using namespace is3d;

constexpr int BLOCK = 128;         // momentum points per block
constexpr int J = 4;               // species per thread
constexpr int YC = 3;              // nodes per register block
constexpr int TILE = 32;           // cells per shared-memory tile
constexpr int MAX_SPLIT = 8;
// resident blocks per SM the register budget is cut for: 4 in float32
// (at most 128 registers a thread), 2 in float64, where the blocking
// takes twice the registers
constexpr size_t SMEM_BUDGET = 48 * 1024;

// ------------------------------------------------ fixed rapidity nodes

// grid (point blocks, species groups of J, n_split x node groups of YC
// (3+1D) or n_split (2+1D)).  dst: out (n_split == 1, scaled) or the
// split's slice of the (n_split, S, M, n_out) partials (unscaled).
template <typename T, int DIM, int DF>
__global__ void __launch_bounds__(BLOCK, 16 / sizeof(T))
spectra_kernel(const T* __restrict__ cells, int n_cells, int cells_per_split,
               const T* __restrict__ mass, const T* __restrict__ sign,
               const T* __restrict__ baryon, const T* __restrict__ deg,
               int n_species, const T* __restrict__ pT,
               const T* __restrict__ px, const T* __restrict__ py, int M,
               int n_phi, const T* __restrict__ nodes,
               const T* __restrict__ weights, int n_nodes, int rs,
               int n_split, int regulate, int outflow, T prefactor,
               T* __restrict__ dst) {
  using F = Fn<T>;
  // one extern declaration (as double4: aligned for the 16-byte loads)
  // for every instantiation; carved as scalars | composites | raw rows
  extern __shared__ double4 smem_d4[];
  T* scal = reinterpret_cast<T*>(smem_d4);          // [TILE][NS]
  T* comp = scal + TILE * NS;                        // [TILE][rs][NK]
  T* raw = comp + TILE * rs * NK;                    // [TILE][NF]

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

  // the thread's momentum point for its J species (ragged edges clamped
  // to a real point and species, never stored)
  const int mc = min(m, M - 1);
  const T pxv = px[mc], pyv = py[mc];
  const T pt = pT[mc / n_phi];
  const T px2 = pxv * pxv, py2 = pyv * pyv, pxpy = pxv * pyv;
  T mT[J], mT2[J], mTpx[J], mTpy[J], m2[J], sgn[J], bar[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int s = min(s0 + j, n_species - 1);
    m2[j] = mass[s] * mass[s];
    mT[j] = d_sqrt(m2[j] + pt * pt);
    mT2[j] = mT[j] * mT[j];
    mTpx[j] = mT[j] * pxv;
    mTpy[j] = mT[j] * pyv;
    sgn[j] = sign[s];
    bar[j] = baryon[s];
  }
  const T dlo = regulate ? T(-1) : -F::inf();
  const T dhi = regulate ? T(1) : F::inf();
  const T plo = outflow ? T(0) : -F::inf();

  T acc[J][YC];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int y = 0; y < YC; ++y) acc[j][y] = T(0);

  const int rstep = DIM == 3 ? YC : rs;
  for (int c0 = cbeg; c0 < cend; c0 += TILE) {
    const int nc = min(TILE, cend - c0);
    __syncthreads();                                 // previous tile consumed
    for (int i = tid; i < nc * NF; i += BLOCK)
      raw[i] = cells[(size_t)c0 * NF + i];
    __syncthreads();
    for (int c = tid; c < nc; c += BLOCK)
      stage_scalars<T, DF>(raw + c * NF, scal + c * NS);
    for (int r0 = rbeg; r0 < rend; r0 += rstep) {
      // nodes of this chunk, rounded up to whole register blocks; the
      // padding repeats the last node with weight 0 (2+1D) or is not
      // stored (3+1D)
      const int nr = min(rstep, rend - r0);
      const int nrp = DIM == 3 ? YC : (nr + YC - 1) / YC * YC;
      if (r0 != rbeg) __syncthreads();               // previous chunk consumed
      for (int i = tid; i < nc * nrp; i += BLOCK) {
        const int c = i / nrp;
        const int rr = i - c * nrp;
        const int r = min(r0 + rr, n_nodes - 1);
        const T* g = raw + c * NF;
        const T delta = DIM == 3 ? nodes[r] - g[F_ETA] : -nodes[r];
        const T w = DIM == 3 ? T(1) : (r0 + rr < rend ? weights[r] : T(0));
        stage_composites<T, DF>(g, delta, w, comp + (c * rs + rr) * NK);
      }
      __syncthreads();
      for (int c = 0; c < nc; ++c) {
        const T* q = scal + c * NS;
        T dax, day, nux, nuy, pxx, pyy, pxy, invT, nvx, nvy, alpha, kp, kb1,
            km2, kv, kc3;
        F::ld4(q, dax, day, nux, nuy);
        F::ld4(q + 4, pxx, pyy, pxy, invT);
        F::ld4(q + 8, nvx, nvy, alpha, kp);
        F::ld4(q + 12, kb1, km2, kv, kc3);
        // per (cell, point)
        const T W1 = fma(dax, pxv, day * pyv);
        const T nW2 = fma(nux, pxv, nuy * pyv);
        const T nD2 = fma(nvx, pxv, nvy * pyv);
        const T C4 = fma(pxx, px2, fma(pyy, py2, pxy * pxpy));
        // per (cell, species)
        T c4s[J], b1[J], c3b[J], nbal[J];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          c4s[j] = fma(km2, m2[j], C4);
          b1[j] = kb1 * bar[j];
          c3b[j] = kc3 * bar[j];
          nbal[j] = -alpha * bar[j];
        }
        const T* kc = comp + c * rs * NK;
        for (int rr = 0; rr < nrp; rr += YC) {
#pragma unroll
          for (int y = 0; y < YC; ++y) {
            T A1, B1, C1, C2, C3, D1, w, unused;
            F::ld4(kc + (rr + y) * NK, A1, B1, C1, C2);
            F::ld4(kc + (rr + y) * NK + 4, C3, D1, w, unused);
#pragma unroll
            for (int j = 0; j < J; ++j) {
              const T pds = fma(mT[j], A1, W1);
              const T pdu = fma(mT[j], B1, nW2);
              const T pipp =
                  fma(mT2[j], C1, fma(mTpx[j], C2, fma(mTpy[j], C3, c4s[j])));
              const T Vp = fma(mT[j], D1, nD2);
              const T feq = F::rcp(
                  F::exp_scaled(fma(pdu, invT, nbal[j])) + sgn[j]);
              T df;
              if (DF == 1) {
                df = fma(fma(kp, pdu, b1[j]), pdu, pipp);
                df = fma(fma(kv, pdu, c3b[j]), Vp, df);
              } else {
                const T r = F::rcp(pdu);
                df = fma(r, fma(-bar[j], Vp, pipp),
                         fma(kv, Vp, fma(kp, pdu, b1[j])));
              }
              df = fma(-sgn[j], feq, T(1)) * df;
              df = fmin(fmax(df, dlo), dhi);
              const T f = fma(feq, df, feq);
              const T pp = fmax(pds, plo);
              acc[j][y] = fma(DIM == 3 ? pp : pp * w, f, acc[j][y]);
            }
          }
        }
      }
    }
  }
  if (m >= M) return;
  T* o = dst + (size_t)split * n_species * M * (size_t)n_out;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int s = s0 + j;
    if (s >= n_species) continue;
    const T scale = n_split == 1 ? prefactor * deg[s] : T(1);
    if (DIM == 3) {
#pragma unroll
      for (int y = 0; y < YC; ++y)
        if (rbeg + y < rend)
          o[((size_t)s * M + m) * n_nodes + rbeg + y] = scale * acc[j][y];
    } else {
      T v = T(0);
#pragma unroll
      for (int y = 0; y < YC; ++y) v += acc[j][y];
      o[(size_t)s * M + m] = scale * v;
    }
  }
}

// out[i] = prefactor deg[s] sum over splits (in order) of partial
template <typename T>
__global__ void __launch_bounds__(256)
fold_kernel(const T* __restrict__ partial, int n_split, long long n,
            long long per_species, const T* __restrict__ deg, T prefactor,
            T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  T v = T(0);
  for (int k = 0; k < n_split; ++k) v += partial[k * n + i];
  out[i] = prefactor * deg[i / per_species] * v;
}

// ------------------------------------------------------- 2+1D mT remap

constexpr int RBLOCK = 128;        // (species, pT) threads per block
constexpr int RYC = 3;             // nodes per register block
constexpr int RNODES = 12;         // nodes per block (a multiple of RYC)
constexpr int RTILE = 8;           // cells per shared-memory tile
constexpr int NR = 20;             // staged scalars per cell
constexpr int NP = 8;              // staged values per (cell, phi)
// most ranges of cells.  Many short blocks beat few long ones: on an H100 a
// 16384-cell group at 320 x 32 x 24 x 48 takes 33 ranges (132 partial sums,
// 130 MB of scratch) and 184.7 ms; capped at 2 ranges it took 197.4 ms and
// its float32 sums of 8192 cells x 12 nodes were off by 1.3e-5 of the
// largest value for 1.0e-6 (PERF.md, section 6).
constexpr int MAX_RSPLIT = 64;

// staged per-cell scalars of the remap kernel; the last seven are those of
// folded.cuh's `Scalar`
enum RemapScalar {
  R_EY, R_EYM, R_DAT, R_DANT,      // exp(y_flow), exp(-y_flow), dsigma_t, _n/tau
  R_UT, R_NTUN, R_DVT, R_DVN,      // u^t, -tau u^n, kv V^t, -kv tau V^n
  R_C1A, R_C1B, R_C1C, R_INVT,     // ksc (pi^tt, tau^2 pi^nn, -2 tau pi^tn)
  R_ALPHA, R_KP, R_KB1, R_KM2,
  R_KV, R_KC3
};

__device__ __forceinline__ void ld2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x; b = v.y;
}
__device__ __forceinline__ void ld2(const double* p, double& a, double& b) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  a = v.x; b = v.y;
}

// the NR scalars of one cell from its packed row g
template <typename T, int DF>
__device__ __forceinline__ void stage_remap_scalars(const T* g, T* o) {
  T sc[NS];
  stage_scalars<T, DF>(g, sc);
  const T ksc = g[F_KSC];
  const T tau = g[F_TAU];
  const T kv = DF == 2 ? g[F_KDV] : T(1);
  o[R_EY] = d_exp(g[F_YFLOW]);
  o[R_EYM] = d_exp(-g[F_YFLOW]);
  o[R_DAT] = g[F_DAT];
  o[R_DANT] = g[F_DANT];
  o[R_UT] = g[F_UT];
  o[R_NTUN] = -g[F_TUN];
  o[R_DVT] = kv * g[F_VT];
  o[R_DVN] = -kv * tau * g[F_VN];
  o[R_C1A] = ksc * g[F_PITT];
  o[R_C1B] = ksc * tau * tau * g[F_PINN];
  o[R_C1C] = T(-2) * ksc * tau * g[F_PITN];
  o[R_INVT] = sc[S_INVT];
  o[R_ALPHA] = sc[S_ALPHA];
  o[R_KP] = sc[S_KP];
  o[R_KB1] = sc[S_KB1];
  o[R_KM2] = sc[S_KM2];
  o[R_KV] = sc[S_KV];
  o[R_KC3] = sc[S_KC3];
  o[R_KC3 + 1] = T(0);
  o[R_KC3 + 2] = T(0);
}

// the NP values of one (cell, phi) at unit pT (cf, sf = cos, sin phi): the
// kernel's threads scale them by their pT.  w1, -w2, -kv d2, c4' as the
// fixed-node kernel's per-(cell, point) terms; g and h collect px C2 + py C3
// = ch g + sh h, so C2 and C3 are never formed per node.
template <typename T, int DF>
__device__ __forceinline__ void stage_remap_row(const T* g, T cf, T sf,
                                                T* o) {
  const T ksc = g[F_KSC];
  const T tau = g[F_TAU];
  const T kv = DF == 2 ? g[F_KDV] : T(1);
  o[0] = g[F_DAX] * cf + g[F_DAY] * sf;
  o[1] = -(g[F_UX] * cf + g[F_UY] * sf);
  o[2] = -kv * (g[F_VX] * cf + g[F_VY] * sf);
  o[3] = ksc * (g[F_PIXX] * cf * cf + g[F_PIYY] * sf * sf
                + T(2) * g[F_PIXY] * cf * sf);
  o[4] = T(-2) * ksc * (g[F_PITX] * cf + g[F_PITY] * sf);
  o[5] = T(2) * ksc * tau * (g[F_PIXN] * cf + g[F_PIYN] * sf);
  o[6] = T(0);
  o[7] = T(0);
}

// grid (blocks of RBLOCK (species, pT) pairs, phi chunks of NPHI, n_split x
// node chunks of RNODES); thread i owns species i / n_pT at pT i % n_pT for
// the block's NPHI angles and RNODES nodes.  partial (n_split x node
// chunks, S, P, F), unscaled.
template <typename T, int DF, int NPHI>
__global__ void __launch_bounds__(RBLOCK, 20 / sizeof(T))
remap_kernel(const T* __restrict__ cells, int n_cells, int cells_per_split,
             const T* __restrict__ mass, const T* __restrict__ sign,
             const T* __restrict__ baryon, int n_species,
             const T* __restrict__ pT, int n_pT,
             const T* __restrict__ cos_phi, const T* __restrict__ sin_phi,
             int n_phi, const T* __restrict__ table,
             const T* __restrict__ weights, int n_nodes, int regulate,
             int outflow, T* __restrict__ partial) {
  using F = Fn<T>;
  __shared__ __align__(16) T tab[RNODES * RBLOCK * 2];  // [node][thread][-,+]
  __shared__ __align__(16) T rows[RTILE * NPHI * NP];   // [cell][phi][NP]
  __shared__ __align__(16) T scal[RTILE * NR];          // [cell][NR]
  __shared__ T raw[RTILE * NF];
  __shared__ T wts[RNODES];

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

  const T pt = pT[ic - s * n_pT];
  const T pt2 = pt * pt;
  const T m2 = mass[s] * mass[s];
  const T hmT = T(0.5) * d_sqrt(m2 + pt2);
  const T sgn = sign[s];
  const T bar = baryon[s];
  const T dlo = regulate ? T(-1) : -F::inf();
  const T dhi = regulate ? T(1) : F::inf();
  const T plo = outflow ? T(0) : -F::inf();

  // the thread's node factors; the padding up to whole register blocks
  // repeats the last node with weight 0
  for (int rr = 0; rr < nrp; ++rr) {
    const size_t at = ((size_t)ic * n_nodes + min(r0 + rr, n_nodes - 1)) * 2;
    tab[(rr * RBLOCK + tid) * 2] = table[at];
    tab[(rr * RBLOCK + tid) * 2 + 1] = table[at + 1];
  }
  if (tid < RNODES) wts[tid] = tid < nr ? weights[r0 + tid] : T(0);

  T acc[NPHI];
#pragma unroll
  for (int f = 0; f < NPHI; ++f) acc[f] = T(0);

  for (int c0 = cbeg; c0 < cend; c0 += RTILE) {
    const int nc = min(RTILE, cend - c0);
    __syncthreads();                                 // previous tile consumed
    for (int k = tid; k < nc * NF; k += RBLOCK)
      raw[k] = cells[(size_t)c0 * NF + k];
    __syncthreads();
    for (int c = tid; c < nc; c += RBLOCK)
      stage_remap_scalars<T, DF>(raw + c * NF, scal + c * NR);
    for (int k = tid; k < nc * NPHI; k += RBLOCK) {
      const int c = k / NPHI;
      const int f = k - c * NPHI;
      const int fc = min(f0 + f, n_phi - 1);
      stage_remap_row<T, DF>(raw + c * NF, cos_phi[fc], sin_phi[fc],
                             rows + k * NP);
    }
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
      const T* q = scal + c * NR;
      T ey, eym, dat, dant, ut, ntun, dvt, dvn, c1a, c1b, c1c, invT, alpha,
          kp, kb1, km2, kv, kc3, unused0, unused1;
      F::ld4(q, ey, eym, dat, dant);
      F::ld4(q + 4, ut, ntun, dvt, dvn);
      F::ld4(q + 8, c1a, c1b, c1c, invT);
      F::ld4(q + 12, alpha, kp, kb1, km2);
      F::ld4(q + 16, kv, kc3, unused0, unused1);
      // per (cell, species, pT): mT/2 exp(+-y_flow) and the species terms
      const T eyh = ey * hmT;
      const T eymh = eym * hmT;
      const T km2m2 = km2 * m2;
      const T b1 = kb1 * bar;
      const T c3b = kc3 * bar;
      const T nbal = -alpha * bar;
      const T* rw = rows + c * NPHI * NP;
      for (int rr = 0; rr < nrp; rr += RYC) {
        // per (cell, species, pT, node): mT cosh and mT sinh of Delta =
        // y_flow - s eta_r from two products, then the composites
        T A[RYC], B[RYC], D[RYC], C1[RYC], cg[RYC], sg[RYC], w[RYC];
#pragma unroll
        for (int y = 0; y < RYC; ++y) {
          T tm, tp;
          ld2(tab + ((rr + y) * RBLOCK + tid) * 2, tm, tp);
          const T ep = eyh * tm;
          const T em = eymh * tp;
          const T ch = ep + em;
          const T sh = ep - em;
          A[y] = fma(ch, dat, sh * dant);
          B[y] = fma(ch, ut, sh * ntun);
          D[y] = fma(ch, dvt, sh * dvn);
          C1[y] = fma(ch * ch, c1a,
                      fma(sh * sh, c1b, fma(ch * sh, c1c, km2m2)));
          cg[y] = ch * pt;
          sg[y] = sh * pt;
          w[y] = wts[rr + y];
        }
#pragma unroll
        for (int f = 0; f < NPHI; ++f) {
          T w1, nw2, nd2, c4, g, h;
          F::ld4(rw + f * NP, w1, nw2, nd2, c4);
          ld2(rw + f * NP + 4, g, h);
#pragma unroll
          for (int y = 0; y < RYC; ++y) {
            const T pds = fma(pt, w1, A[y]);
            const T pdu = fma(pt, nw2, B[y]);
            const T Vp = fma(pt, nd2, D[y]);
            const T pipp = fma(cg[y], g, fma(sg[y], h, fma(pt2, c4, C1[y])));
            const T fv = folded_f<T, DF>(pdu, pipp, Vp, invT, nbal, sgn, bar,
                                         kp, b1, kv, c3b, dlo, dhi);
            acc[f] = fma(fmax(pds, plo) * w[y], fv, acc[f]);
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

// out[i] = prefactor deg[s] s(mT) sum over the parts (in order) of partial,
// s(mT) = sqrt(T_ref / max(mT, T_ref)) the jacobian of the node map
template <typename T>
__global__ void __launch_bounds__(256)
remap_fold_kernel(const T* __restrict__ partial, int n_parts, long long n,
                  int n_pT, int n_phi, const T* __restrict__ mass,
                  const T* __restrict__ pT, const T* __restrict__ deg,
                  T prefactor, T t_ref, T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  T v = T(0);
  for (int k = 0; k < n_parts; ++k) v += partial[k * n + i];
  const int sp = (int)(i / n_phi);
  const int s = sp / n_pT;
  const T pt = pT[sp - s * n_pT];
  const T mT = d_sqrt(mass[s] * mass[s] + pt * pt);
  const T srem = d_sqrt(t_ref / (mT > t_ref ? mT : t_ref));
  out[i] = prefactor * deg[s] * (v * srem);
}

// ------------------------------------------------------------ launchers

struct Shape {
  int n_cells, n_species, n_pT, n_phi, n_nodes, df_mode, dimension;
};

int check_shape(const Shape& a) {
  if ((a.df_mode != 1 && a.df_mode != 2) ||
      (a.dimension != 2 && a.dimension != 3) || a.n_cells < 0 ||
      a.n_species < 0 || a.n_pT < 0 || a.n_phi < 0 || a.n_nodes < 1)
    return cudaErrorInvalidValue;
  const long long M = (long long)a.n_pT * a.n_phi;
  if ((long long)a.n_species * M > 0x7fffffffLL - BLOCK ||
      a.n_species / J + 1 > 65535)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// nodes per staged chunk of the fixed-node kernel: 3+1D YC; 2+1D every
// node (rounded up to whole register blocks) or as many as fit
template <typename T>
int chunk_nodes(const Shape& a) {
  if (a.dimension == 3) return YC;
  const size_t fixed = (size_t)TILE * (NS + NF) * sizeof(T);
  const int fit = (int)((SMEM_BUDGET - fixed) / (TILE * NK * sizeof(T)))
                  / YC * YC;
  const int all = (a.n_nodes + YC - 1) / YC * YC;
  return all < fit ? all : fit;
}

template <typename T>
size_t fixed_smem(int rs) {
  return (size_t)TILE * (NS + (size_t)rs * NK + NF) * sizeof(T);
}

template <typename T, int DIM, int DF>
int splits_for(const Shape& a, long long blocks) {
  int dev = 0, n_sm = 0, per_sm = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc == 0)
    rc = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                     dev);
  if (rc == 0)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, spectra_kernel<T, DIM, DF>, BLOCK,
        fixed_smem<T>(chunk_nodes<T>(a)));
  if (rc != 0) return -rc;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  // the fewest splits whose waves come within 2 % of the best of 1..MAX
  const long long slots = (long long)n_sm * per_sm;
  const int max_split = (int)std::min<long long>(
      MAX_SPLIT, std::max<long long>(1, (a.n_cells + TILE - 1) / TILE));
  double cost[MAX_SPLIT + 1], best = 1e300;
  for (int k = 1; k <= max_split; ++k) {
    cost[k] = (double)((blocks * k + slots - 1) / slots) / k;
    best = cost[k] < best ? cost[k] : best;
  }
  for (int k = 1; k <= max_split; ++k)
    if (cost[k] <= 1.02 * best) return k;
  return 1;
}

long long fixed_blocks(const Shape& a) {
  const long long M = (long long)a.n_pT * a.n_phi;
  const long long nz = a.dimension == 3 ? (a.n_nodes + YC - 1) / YC : 1;
  return (M + BLOCK - 1) / BLOCK * ((a.n_species + J - 1) / J) * nz;
}

// splits of the cell axis for a fixed-node launch of this shape, or minus
// a CUDA error code
template <typename T>
int splits(const Shape& a) {
  const int rc = check_shape(a);
  if (rc != 0) return -rc;
  const long long blocks = fixed_blocks(a);
  if (blocks == 0) return 1;
  if (a.dimension == 3)
    return a.df_mode == 1 ? splits_for<T, 3, 1>(a, blocks)
                          : splits_for<T, 3, 2>(a, blocks);
  return a.df_mode == 1 ? splits_for<T, 2, 1>(a, blocks)
                        : splits_for<T, 2, 2>(a, blocks);
}

template <typename T>
int launch(const void* cells_v, int nf, const Shape& a, const void* mass_v,
           const void* sign_v, const void* baryon_v, const void* deg_v,
           const void* pT_v, const void* px_v, const void* py_v,
           const void* nodes_v, const void* weights_v, int regulate,
           int outflow, double prefactor, int n_split, void* partial_v,
           void* out_v, void* stream_v) {
  int rc = check_shape(a);
  if (rc != 0 || nf != NF || n_split < 1 || n_split > MAX_SPLIT ||
      (n_split > 1 && partial_v == nullptr))
    return rc != 0 ? rc : cudaErrorInvalidValue;
  const long long M = (long long)a.n_pT * a.n_phi;
  if (M * a.n_species == 0) return cudaSuccess;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  const T* cells = static_cast<const T*>(cells_v);
  const T* mass = static_cast<const T*>(mass_v);
  const T* sign = static_cast<const T*>(sign_v);
  const T* baryon = static_cast<const T*>(baryon_v);
  const T* deg = static_cast<const T*>(deg_v);
  const T* pT = static_cast<const T*>(pT_v);
  const T* px = static_cast<const T*>(px_v);
  const T* py = static_cast<const T*>(py_v);
  const T* nodes = static_cast<const T*>(nodes_v);
  const T* weights = static_cast<const T*>(weights_v);
  T* out = static_cast<T*>(out_v);

  const int rs = chunk_nodes<T>(a);
  if (rs < YC) return cudaErrorInvalidValue;
  const size_t smem = fixed_smem<T>(rs);
  const int per = (int)(((long long)a.n_cells + n_split - 1) / n_split);
  const int cells_per_split = per < 1 ? 1 : per;
  const unsigned nz =
      a.dimension == 3 ? (unsigned)((a.n_nodes + YC - 1) / YC) : 1u;
  if ((long long)nz * n_split > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((M + BLOCK - 1) / BLOCK),
                  (unsigned)((a.n_species + J - 1) / J), nz * n_split);
  T* dst = n_split == 1 ? out : static_cast<T*>(partial_v);
#define IS3D_FIXED(DIM_, DF_)                                                 \
  spectra_kernel<T, DIM_, DF_><<<grid, BLOCK, smem, stream>>>(                \
      cells, a.n_cells, cells_per_split, mass, sign, baryon, deg,             \
      a.n_species, pT, px, py, (int)M, a.n_phi, nodes, weights, a.n_nodes,    \
      rs, n_split, regulate, outflow, (T)prefactor, dst)
  if (a.dimension == 3) {
    if (a.df_mode == 1) IS3D_FIXED(3, 1); else IS3D_FIXED(3, 2);
  } else {
    if (a.df_mode == 1) IS3D_FIXED(2, 1); else IS3D_FIXED(2, 2);
  }
#undef IS3D_FIXED
  rc = (int)cudaGetLastError();
  if (rc != 0 || n_split == 1) return rc;
  const long long n_out = a.dimension == 3 ? a.n_nodes : 1;
  const long long n = a.n_species * M * n_out;
  fold_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(partial_v), n_split, n, M * n_out, deg,
      (T)prefactor, out);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- launchers, mT remap

// angles per thread: of 8, 16 and 24 the width that pads n_phi the least,
// the largest of equals
int remap_phi_width(int n_phi) {
  int best = 8;
  for (int w = 16; w <= 24; w += 8)
    if ((n_phi + w - 1) / w * w <= (n_phi + best - 1) / best * best) best = w;
  return best;
}

// IS3D_REMAP(DF, NPHI) runs once with the instantiation of the flags
#define IS3D_REMAP_WIDTH(DF_, width)                                          \
  {                                                                          \
    if (width == 8) { IS3D_REMAP(DF_, 8) }                                   \
    else if (width == 16) { IS3D_REMAP(DF_, 16) }                            \
    else { IS3D_REMAP(DF_, 24) }                                             \
  }
#define IS3D_REMAP_DISPATCH(df_mode, width)                                   \
  if (df_mode == 1) IS3D_REMAP_WIDTH(1, width) else IS3D_REMAP_WIDTH(2, width)

// the remap kernel's grid for a shape on the current card, the one owner of
// its blocking: out = {blocks for each range of cells, resident blocks (SMs
// x blocks per SM), chunks of nodes, cells per tile, most ranges of cells,
// angles per thread}.
// The wrapper splits the cells with these (kernels/launch.py:split_to_fill)
// and sizes the partial sums as ranges x chunks of nodes.
template <typename T>
int remap_grid(int n_species, int n_pT, int n_phi, int n_nodes, int df_mode,
               int* out) {
  if ((df_mode != 1 && df_mode != 2) || n_species < 0 || n_pT < 0 ||
      n_phi < 0 || n_nodes < 1 || out == nullptr)
    return cudaErrorInvalidValue;
  int dev = 0, n_sm = 0, per_sm = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc == 0)
    rc = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                     dev);
  const int width = remap_phi_width(n_phi);
#define IS3D_REMAP(DF_, NPHI_)                                                \
  if (rc == 0)                                                               \
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(                 \
        &per_sm, remap_kernel<T, DF_, NPHI_>, RBLOCK, 0);
  IS3D_REMAP_DISPATCH(df_mode, width)
#undef IS3D_REMAP
  if (rc != 0) return rc;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long n_sp = (long long)n_species * n_pT;
  const long long chunks = (n_nodes + RNODES - 1) / RNODES;
  const long long blocks = (n_sp + RBLOCK - 1) / RBLOCK
                           * ((n_phi + width - 1) / width) * chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  out[0] = (int)blocks;
  out[1] = n_sm * per_sm;
  out[2] = (int)chunks;
  out[3] = RTILE;
  out[4] = MAX_RSPLIT;
  out[5] = width;
  return cudaSuccess;
}

template <typename T>
int launch_remap(const void* cells_v, int n_cells, int nf, const void* mass_v,
                 const void* sign_v, const void* baryon_v, const void* deg_v,
                 int n_species, const void* pT_v, int n_pT,
                 const void* cos_phi_v, const void* sin_phi_v, int n_phi,
                 const void* table_v, const void* weights_v, int n_nodes,
                 int df_mode, int regulate, int outflow, double prefactor,
                 double t_ref, int cells_per_split, int n_partial,
                 void* partial_v, void* out_v, void* stream_v) {
  if (nf != NF || (df_mode != 1 && df_mode != 2) || n_cells < 0 ||
      n_species < 0 || n_pT < 0 || n_phi < 0 || n_nodes < 1 ||
      cells_per_split < 1 || partial_v == nullptr)
    return cudaErrorInvalidValue;
  const long long n_sp = (long long)n_species * n_pT;
  const long long n = n_sp * n_phi;
  if (n == 0) return cudaSuccess;
  const long long n_split =
      std::max<long long>(1, ((long long)n_cells + cells_per_split - 1)
                                 / cells_per_split);
  const int width = remap_phi_width(n_phi);
  const long long n_parts = n_split * ((n_nodes + RNODES - 1) / RNODES);
  // a split of whole tiles, so no tile straddles two blocks, and a
  // partial buffer (n_partial parts) of just the parts this grid writes
  if ((n_split > 1 && cells_per_split % RTILE != 0) ||
      n_parts != n_partial || n_split > MAX_RSPLIT || n_parts > 65535 ||
      (n_phi + width - 1) / width > 65535 || n > 0x7fffffffLL ||
      (long long)n_sp * n_nodes > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  const T* mass = static_cast<const T*>(mass_v);
  const T* pT = static_cast<const T*>(pT_v);
  T* partial = static_cast<T*>(partial_v);
  const dim3 grid((unsigned)((n_sp + RBLOCK - 1) / RBLOCK),
                  (unsigned)((n_phi + width - 1) / width),
                  (unsigned)n_parts);
#define IS3D_REMAP(DF_, NPHI_)                                                \
  remap_kernel<T, DF_, NPHI_><<<grid, RBLOCK, 0, stream>>>(                   \
      static_cast<const T*>(cells_v), n_cells, cells_per_split, mass,        \
      static_cast<const T*>(sign_v), static_cast<const T*>(baryon_v),        \
      n_species, pT, n_pT, static_cast<const T*>(cos_phi_v),                 \
      static_cast<const T*>(sin_phi_v), n_phi,                               \
      static_cast<const T*>(table_v), static_cast<const T*>(weights_v),      \
      n_nodes, regulate, outflow, partial);
  IS3D_REMAP_DISPATCH(df_mode, width)
#undef IS3D_REMAP
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  remap_fold_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      partial, (int)n_parts, n, n_pT, n_phi, mass, pT,
      static_cast<const T*>(deg_v), (T)prefactor, (T)t_ref,
      static_cast<T*>(out_v));
  return (int)cudaGetLastError();
}
#undef IS3D_REMAP_DISPATCH
#undef IS3D_REMAP_WIDTH

}  // namespace

extern "C" {

#define IS3D_SPLITS_ENTRY(NAME, T)                                            \
  int NAME(int n_cells, int n_species, int n_pT, int n_phi, int n_nodes,     \
           int df_mode, int dimension) {                                     \
    return splits<T>(Shape{n_cells, n_species, n_pT, n_phi, n_nodes,         \
                           df_mode, dimension});                             \
  }
IS3D_SPLITS_ENTRY(is3d_smooth_spectra_splits_f32, float)
IS3D_SPLITS_ENTRY(is3d_smooth_spectra_splits_f64, double)
#undef IS3D_SPLITS_ENTRY

#define IS3D_SPECTRA_ENTRY(NAME, T)                                           \
  int NAME(const void* cells, int n_cells, int nf, const void* mass,         \
           const void* sign, const void* baryon, const void* deg,            \
           int n_species, const void* pT, const void* px, const void* py,    \
           int n_pT, int n_phi, const void* nodes, const void* weights,      \
           int n_nodes, int df_mode, int dimension, int regulate,            \
           int outflow, double prefactor, int n_split, void* partial,        \
           void* out, void* stream) {                                        \
    return launch<T>(cells, nf,                                              \
                     Shape{n_cells, n_species, n_pT, n_phi, n_nodes,         \
                           df_mode, dimension},                              \
                     mass, sign, baryon, deg, pT, px, py, nodes, weights,    \
                     regulate, outflow, prefactor, n_split, partial, out,    \
                     stream);                                                \
  }
IS3D_SPECTRA_ENTRY(is3d_smooth_spectra_f32, float)
IS3D_SPECTRA_ENTRY(is3d_smooth_spectra_f64, double)
#undef IS3D_SPECTRA_ENTRY

// the 2+1D mT remap: table (S, P, R, 2) = exp(-s eta_r), exp(+s eta_r)
// (kernels/smooth.py:remap_node_table), partial (n_partial = ranges of
// cells x chunks of nodes, S, P, F) scratch
#define IS3D_REMAP_ENTRY(NAME, T)                                             \
  int NAME(const void* cells, int n_cells, int nf, const void* mass,         \
           const void* sign, const void* baryon, const void* deg,            \
           int n_species, const void* pT, int n_pT, const void* cos_phi,     \
           const void* sin_phi, int n_phi, const void* table,                \
           const void* weights, int n_nodes, int df_mode, int regulate,      \
           int outflow, double prefactor, double t_ref, int cells_per_split, \
           int n_partial, void* partial, void* out, void* stream) {          \
    return launch_remap<T>(cells, n_cells, nf, mass, sign, baryon, deg,      \
                           n_species, pT, n_pT, cos_phi, sin_phi, n_phi,     \
                           table, weights, n_nodes, df_mode, regulate,       \
                           outflow, prefactor, t_ref, cells_per_split,       \
                           n_partial, partial, out, stream);                 \
  }
IS3D_REMAP_ENTRY(is3d_smooth_spectra_remap_f32, float)
IS3D_REMAP_ENTRY(is3d_smooth_spectra_remap_f64, double)
#undef IS3D_REMAP_ENTRY

// the remap kernel's grid for a shape on the current card: out[6] = blocks
// for each range of cells, resident blocks, chunks of nodes, cells per
// tile, most ranges of cells, angles per thread; returns a CUDA error code
int is3d_smooth_spectra_remap_grid_f32(int n_species, int n_pT, int n_phi,
                                       int n_nodes, int df_mode, int* out) {
  return remap_grid<float>(n_species, n_pT, n_phi, n_nodes, df_mode, out);
}
int is3d_smooth_spectra_remap_grid_f64(int n_species, int n_pT, int n_phi,
                                       int n_nodes, int df_mode, int* out) {
  return remap_grid<double>(n_species, n_pT, n_phi, n_nodes, df_mode, out);
}

const char* is3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
