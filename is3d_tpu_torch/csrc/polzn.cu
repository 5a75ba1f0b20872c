// Thermal-vorticity spin polarization (mode 5) for Hopper (sm_90a),
// float32 and float64.
//
// Replaces the XLA hot loop of is3d_tpu/kernels/polzn.py:_chunk_polzn
// (:42), driven by _polzn_jit (:165).  One pass over the points computes
// the five sums over cells and nodes of
//
//     meas  = p.dsigma f0 w,   f0 = 1 / (exp(u.p / T_avg) + sign)
//     pref  = pm (1 - sign f0),   pm = -0.25 / m
//     S_mu += meas pref (mT s1_mu(c,r) + s2_mu(c,m)),   Snorm += meas
//
// where s1 and s2 are the eps-contractions of p with the thermal
// vorticity (p^eta, not tau p^eta, contracts it).  Two kernels:
//   * fixed_kernel: fixed nodes, 3+1D (the output rapidities, w = 1) and
//     2+1D (the eta nodes, w = eta_weight x (eta[1] - eta[0]), the
//     reference's quirk, from the wrapper);
//   * remap_kernel: the 2+1D mT remap; its nodes Delta = y_flow - s eta_r
//     with s = sqrt(T_ref / max(mT, T_ref)) depend on (species, pT) and the
//     cell's y_flow only, so e^+-Delta = e^+-y_flow x the node table
//     exp(-+s eta_r) (kernels/smooth.py:remap_node_table, K1's remap
//     design): no special function per node.  The jacobian s multiplies
//     the reduced sums (fold_kernel).
//
// Inputs (built by is3d_tpu_torch/kernels/polzn.py:pack_polzn_cells):
//   cells (n_cells, NW) per-cell scalars, field order `PwField` (==
//   PW_FIELDS); mass, sign, pm (n_species); pT (n_pT); px, py (n_pT n_phi)
//   or cos_phi, sin_phi (n_phi); nodes (3+1D, 2+1D fixed) or the node
//   table (remap); wR (n_nodes) the node weights.
// Output: (5, n_species, n_pT, n_phi, n_out) = St, Sx, Sy, Sn, Snorm, n_out
// = n_nodes in 3+1D, 1 in 2+1D.
//
// What bounds it on this card: FP32 and SFU issue about equally, 16 FP32
// operations and an exp and a reciprocal per evaluation
// (kernels/polzn.py, polzn_formula_ops), against a few MB of cells.
//
// Design: the blocking of feqmod.cu, five accumulators per output.
//   * fixed_kernel: a thread owns one momentum point for JP species and YC
//     nodes (5 JP YC accumulators); tiles of TILE cells and their node
//     composites are staged in shared memory.
//   * remap_kernel: a thread owns one (species, pT) for NPHI angles (5 NPHI
//     accumulators) and RNODES nodes, whose node factors it keeps in
//     shared memory; per (cell, node) it forms p.dsigma's, u.p's and the
//     four s1 node terms once for its NPHI angles, RYC nodes at a time so
//     each angle's staged terms are read once for RYC evaluations.
//   * A massless species has pm = -inf, so its S sums are inf or NaN as
//     the JAX package's are (pm (1 - sign f0) is formed as the plain
//     version forms it).
//   * float32 takes ex2.approx on a pre-scaled argument and rcp.approx;
//     float64 keeps IEEE exp and division.
//   * The cells are split into ranges (kernels/launch.py:split_to_fill);
//     each range writes its own partial, and fold_kernel adds them in
//     order.  No atomics: two launches give identical bits.
// A first version: simple and right; its time against its bound is in
// PERF.md.

#include <cuda_runtime.h>

#include "folded.cuh"
#include "polzn.cuh"

namespace {

using namespace is3d;

constexpr int BLOCK = 128;         // momentum points per block
constexpr int JP = 4;              // species per thread
constexpr int YC = 3;              // nodes per register block
constexpr int TILE = 16;           // cells per shared-memory tile
constexpr int RS2 = 12;            // 2+1D nodes per staged chunk (x YC)
constexpr int NKP = 7;             // staged values per (cell, node)
constexpr int MAX_SPLIT = 8;

// the NKP values of (cell g, rapidity difference delta): p.dsigma's A1,
// L u.p / T's B1, the four s1 and the node weight w
template <typename T>
__device__ __forceinline__ void polzn_node(const T* g, T delta, T w, T* o) {
  const T ch = d_cosh(delta), sh = d_sinh(delta);
  const T sht = sh * g[W_ITAU];
  o[0] = ch * g[W_DAT] + sh * g[W_DANT];
  o[1] = Fn<T>::SCALE * (ch * g[W_UT_T] - sh * g[W_TUN_T]);
  o[2] = g[W_WXY] * sht;
  o[3] = g[W_WYN] * ch + g[W_WTY] * sht;
  o[4] = -(g[W_WXN] * ch + g[W_WTX] * sht);
  o[5] = g[W_WXY] * ch;
  o[6] = w;
}

// the five sums' terms at one evaluation, added to acc: p.dsigma = pds,
// L u.p / T = arg, the four eps-contractions s[4], the node weight w
template <typename T>
__device__ __forceinline__ void polzn_add(T pds, T arg, const T (&s)[4], T w,
                                          T sgn, T pm, T* acc) {
  using F = Fn<T>;
  const T f0 = F::rcp(F::exp_scaled(arg) + sgn);
  const T pref = pm * fma(-sgn, f0, T(1));
  const T meas = pds * f0 * w;
  const T mp = meas * pref;
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] = fma(mp, s[q], acc[q]);
  acc[4] += meas;
}

// ------------------------------------------------ fixed rapidity nodes

// grid (point blocks, species groups of JP, n_split x node groups of YC
// (3+1D) or n_split (2+1D)); partial (n_split, 5, S, M, n_out)
template <typename T, int DIM>
__global__ void __launch_bounds__(BLOCK, sizeof(T) == 4 ? 3 : 2)
fixed_kernel(const T* __restrict__ cells, int n_cells, int cells_per_split,
             const T* __restrict__ mass, const T* __restrict__ sign,
             const T* __restrict__ pmv, int n_species,
             const T* __restrict__ pT, const T* __restrict__ px,
             const T* __restrict__ py, int M, int n_phi,
             const T* __restrict__ nodes, const T* __restrict__ wR,
             int n_nodes, T* __restrict__ partial) {
  using F = Fn<T>;
  constexpr int RSC = DIM == 3 ? YC : RS2;
  __shared__ __align__(16) T raw[TILE * NW];
  __shared__ __align__(16) T comp[TILE * RSC * NKP];

  const int tid = threadIdx.x;
  const int nz = DIM == 3 ? (n_nodes + YC - 1) / YC : 1;
  const int split = blockIdx.z / nz;
  const int rbeg = DIM == 3 ? (blockIdx.z - split * nz) * YC : 0;
  const int rend = DIM == 3 ? min(rbeg + YC, n_nodes) : n_nodes;
  const int cbeg = split * cells_per_split;
  const int cend = min(n_cells, cbeg + cells_per_split);
  const int m = blockIdx.x * BLOCK + tid;
  const int s0 = blockIdx.y * JP;
  const int n_out = DIM == 3 ? n_nodes : 1;
  const T L = F::SCALE;

  const int mc = min(m, M - 1);
  const T pxv = px[mc], pyv = py[mc];
  const T pt = pT[mc / n_phi];
  T mT[JP], sgn[JP], pm[JP];
#pragma unroll
  for (int j = 0; j < JP; ++j) {
    const int s = min(s0 + j, n_species - 1);
    mT[j] = d_sqrt(mass[s] * mass[s] + pt * pt);
    sgn[j] = sign[s];
    pm[j] = pmv[s];
  }

  T acc[JP][YC][NSUM];
#pragma unroll
  for (int j = 0; j < JP; ++j)
#pragma unroll
    for (int y = 0; y < YC; ++y)
#pragma unroll
      for (int q = 0; q < NSUM; ++q) acc[j][y][q] = T(0);

  for (int c0 = cbeg; c0 < cend; c0 += TILE) {
    const int nc = min(TILE, cend - c0);
    __syncthreads();                                 // previous tile consumed
    for (int i = tid; i < nc * NW; i += BLOCK)
      raw[i] = cells[(size_t)c0 * NW + i];
    __syncthreads();
    for (int r0 = rbeg; r0 < rend; r0 += RSC) {
      // 2+1D: the padding up to whole register blocks repeats the last
      // node (skipped below)
      const int nr = min(RSC, rend - r0);
      const int nrp = DIM == 3 ? YC : (nr + YC - 1) / YC * YC;
      if (r0 != rbeg) __syncthreads();               // previous chunk consumed
      for (int i = tid; i < nc * nrp; i += BLOCK) {
        const int c = i / nrp;
        const int rr = i - c * nrp;
        const int r = min(r0 + rr, n_nodes - 1);
        const T* g = raw + c * NW;
        const T w = r0 + rr < rend ? wR[r] : T(0);
        polzn_node<T>(g, DIM == 3 ? nodes[r] - g[W_ETA] : -nodes[r], w,
                      comp + (c * RSC + rr) * NKP);
      }
      __syncthreads();
      for (int c = 0; c < nc; ++c) {
        const T* g = raw + c * NW;
        // per (cell, point)
        const T W1 = fma(g[W_DAX], pxv, g[W_DAY] * pyv);
        const T nW2 = -L * fma(g[W_UX_T], pxv, g[W_UY_T] * pyv);
        const T s2[4] = {fma(g[W_WYN], pxv, -g[W_WXN] * pyv),
                         -g[W_WTN] * pyv, g[W_WTN] * pxv,
                         fma(g[W_WTX], pyv, -g[W_WTY] * pxv)};
        const T* kc = comp + c * RSC * NKP;
        for (int rr = 0; rr < nrp; rr += YC) {
#pragma unroll
          for (int y = 0; y < YC; ++y) {
            // 2+1D: the padding past the last node is skipped, not weighted
            // 0: 0 x pm is NaN for a massless species
            if (DIM == 2 && rr + y >= nr) continue;
            const T* q = kc + (rr + y) * NKP;
#pragma unroll
            for (int j = 0; j < JP; ++j) {
              const T s[4] = {fma(mT[j], q[2], s2[0]), fma(mT[j], q[3], s2[1]),
                              fma(mT[j], q[4], s2[2]), fma(mT[j], q[5], s2[3])};
              polzn_add(fma(mT[j], q[0], W1), fma(mT[j], q[1], nW2), s, q[6],
                        sgn[j], pm[j], acc[j][y]);
            }
          }
        }
      }
    }
  }
  if (m >= M) return;
  const size_t plane = (size_t)n_species * M * n_out;
  T* o = partial + (size_t)split * NSUM * plane;
#pragma unroll
  for (int j = 0; j < JP; ++j) {
    const int s = s0 + j;
    if (s >= n_species) continue;
#pragma unroll
    for (int q = 0; q < NSUM; ++q) {
      if (DIM == 3) {
#pragma unroll
        for (int y = 0; y < YC; ++y)
          if (rbeg + y < rend)
            o[q * plane + ((size_t)s * M + m) * n_nodes + rbeg + y] =
                acc[j][y][q];
      } else {
        T v = T(0);
#pragma unroll
        for (int y = 0; y < YC; ++y) v += acc[j][y][q];
        o[q * plane + (size_t)s * M + m] = v;
      }
    }
  }
}

// ------------------------------------------------------- 2+1D mT remap

constexpr int RBLOCK = 128;        // (species, pT) threads per block
constexpr int RYC = 3;             // nodes per register block
constexpr int RNODES = 12;         // nodes per block (a multiple of RYC)
constexpr int RTILE = 8;           // cells per shared-memory tile
constexpr int NPHI = 8;            // angles per thread
constexpr int NPR = 6;             // staged values per (cell, phi)
constexpr int MAX_RSPLIT = 64;

// the NPR values of one (cell, phi) at unit pT (cf, sf = cos, sin phi):
// w1 (p.dsigma), -L w2 / T (u.p), the four s2
template <typename T>
__device__ __forceinline__ void stage_row(const T* g, T cf, T sf, T* o) {
  o[0] = g[W_DAX] * cf + g[W_DAY] * sf;
  o[1] = -Fn<T>::SCALE * (g[W_UX_T] * cf + g[W_UY_T] * sf);
  o[2] = g[W_WYN] * cf - g[W_WXN] * sf;
  o[3] = -g[W_WTN] * sf;
  o[4] = g[W_WTN] * cf;
  o[5] = g[W_WTX] * sf - g[W_WTY] * cf;
}

// grid (blocks of RBLOCK (species, pT) pairs, phi chunks of NPHI, n_split x
// node chunks of RNODES); partial (n_split x node chunks, 5, S, P, F),
// without the jacobian
template <typename T>
__global__ void __launch_bounds__(RBLOCK, sizeof(T) == 4 ? 3 : 2)
remap_kernel(const T* __restrict__ cells, int n_cells, int cells_per_split,
             const T* __restrict__ mass, const T* __restrict__ sign,
             const T* __restrict__ pmv, int n_species,
             const T* __restrict__ pT, int n_pT,
             const T* __restrict__ cos_phi, const T* __restrict__ sin_phi,
             int n_phi, const T* __restrict__ table,
             const T* __restrict__ wR, int n_nodes,
             T* __restrict__ partial) {
  __shared__ __align__(16) T tab[RNODES * RBLOCK * 2];  // [node][thread][-,+]
  __shared__ __align__(16) T rows[RTILE * NPHI * NPR];  // [cell][phi][NPR]
  __shared__ T raw[RTILE * NW];
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
  const int f0 = blockIdx.y * NPHI;
  const int cbeg = split * cells_per_split;
  const int cend = min(n_cells, cbeg + cells_per_split);

  const T pt = pT[ic - s * n_pT];
  const T hmT = T(0.5) * d_sqrt(mass[s] * mass[s] + pt * pt);
  const T sgn = sign[s];
  const T pm = pmv[s];

  for (int rr = 0; rr < RNODES; ++rr) {
    const size_t at = ((size_t)ic * n_nodes + min(r0 + rr, n_nodes - 1)) * 2;
    tab[(rr * RBLOCK + tid) * 2] = table[at];
    tab[(rr * RBLOCK + tid) * 2 + 1] = table[at + 1];
  }
  if (tid < RNODES) wts[tid] = tid < nr ? wR[r0 + tid] : T(0);

  T acc[NPHI][NSUM];
#pragma unroll
  for (int f = 0; f < NPHI; ++f)
#pragma unroll
    for (int q = 0; q < NSUM; ++q) acc[f][q] = T(0);

  for (int c0 = cbeg; c0 < cend; c0 += RTILE) {
    const int nc = min(RTILE, cend - c0);
    __syncthreads();                                 // previous tile consumed
    for (int k = tid; k < nc * NW; k += RBLOCK)
      raw[k] = cells[(size_t)c0 * NW + k];
    __syncthreads();
    for (int k = tid; k < nc * NPHI; k += RBLOCK) {
      const int c = k / NPHI;
      const int fc = min(f0 + k - c * NPHI, n_phi - 1);
      stage_row<T>(raw + c * NW, cos_phi[fc], sin_phi[fc], rows + k * NPR);
    }
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
      const T* g = raw + c * NW;
      const T* rw = rows + c * NPHI * NPR;
      const T eyh = d_exp(g[W_YFLOW]) * hmT;
      const T eymh = d_exp(-g[W_YFLOW]) * hmT;
      const T LutT = Fn<T>::SCALE * g[W_UT_T];
      const T LtunT = Fn<T>::SCALE * g[W_TUN_T];
      for (int rr = 0; rr < nr; rr += RYC) {
        // per (cell, species, pT, node): mT ch and mT sh of Delta from the
        // node table, then the node terms, for a register block of nodes
        T A[RYC], B[RYC], s1[RYC][4], w[RYC];
#pragma unroll
        for (int y = 0; y < RYC; ++y) {
          w[y] = wts[rr + y];
          const T ep = eyh * tab[((rr + y) * RBLOCK + tid) * 2];
          const T em = eymh * tab[((rr + y) * RBLOCK + tid) * 2 + 1];
          const T mch = ep + em;
          const T msh = ep - em;
          const T msht = msh * g[W_ITAU];
          A[y] = fma(mch, g[W_DAT], msh * g[W_DANT]);
          B[y] = fma(mch, LutT, -msh * LtunT);
          s1[y][0] = g[W_WXY] * msht;
          s1[y][1] = fma(g[W_WYN], mch, g[W_WTY] * msht);
          s1[y][2] = -fma(g[W_WXN], mch, g[W_WTX] * msht);
          s1[y][3] = g[W_WXY] * mch;
        }
#pragma unroll
        for (int f = 0; f < NPHI; ++f) {
          const T* q = rw + f * NPR;
          const T w1 = q[0], nw2 = q[1];
          const T s2[4] = {q[2], q[3], q[4], q[5]};
#pragma unroll
          for (int y = 0; y < RYC; ++y) {
            // the padding past the last node is skipped, not weighted 0:
            // 0 x pm is NaN for a massless species
            if (rr + y >= nr) continue;
            const T sv[4] = {fma(pt, s2[0], s1[y][0]), fma(pt, s2[1], s1[y][1]),
                             fma(pt, s2[2], s1[y][2]), fma(pt, s2[3], s1[y][3])};
            polzn_add(fma(pt, w1, A[y]), fma(pt, nw2, B[y]), sv, w[y], sgn,
                      pm, acc[f]);
          }
        }
      }
    }
  }
  if (i >= n_sp) return;
  const size_t plane = (size_t)n_sp * n_phi;
  T* o = partial + (size_t)blockIdx.z * NSUM * plane + (size_t)i * n_phi
         + f0;
#pragma unroll
  for (int q = 0; q < NSUM; ++q)
#pragma unroll
    for (int f = 0; f < NPHI; ++f)
      if (f0 + f < n_phi) o[q * plane + f] = acc[f][q];
}

// out[i] = (s(mT)) sum over the parts (in order) of partial; i runs over
// (5, S, n_pT, n_phi, n_out), s(mT) = sqrt(T_ref / max(mT, T_ref)) the
// jacobian of the remap (t_ref > 0 only)
template <typename T>
__global__ void __launch_bounds__(256)
fold_kernel(const T* __restrict__ partial, int n_parts, long long n,
            long long plane, int n_pT, int n_phi, int n_out,
            const T* __restrict__ mass, const T* __restrict__ pT, T t_ref,
            T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  T v = T(0);
  for (int k = 0; k < n_parts; ++k) v += partial[k * n + i];
  if (t_ref > T(0)) {
    const long long sp = (i % plane) / ((long long)n_phi * n_out);
    const int s = (int)(sp / n_pT);
    const T pt = pT[sp - (long long)s * n_pT];
    const T mT = d_sqrt(mass[s] * mass[s] + pt * pt);
    v = v * d_sqrt(t_ref / (mT > t_ref ? mT : t_ref));
  }
  out[i] = v;
}

// ------------------------------------------------------------ launchers

bool shape_ok(int n_species, int n_pT, int n_phi, int n_nodes,
              int dimension) {
  return n_species >= 1 && n_pT >= 1 && n_phi >= 1 && n_nodes >= 1 &&
         (dimension == 2 || dimension == 3) &&
         (long long)NSUM * n_species * n_pT * n_phi * n_nodes < 0x7fffffffLL &&
         (n_species + JP - 1) / JP <= 65535;
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
int polzn_grid(int n_species, int n_pT, int n_phi, int n_nodes,
               int dimension, int remap, int* out) {
  if (!shape_ok(n_species, n_pT, n_phi, n_nodes, dimension) ||
      (remap && dimension != 2) || out == nullptr)
    return cudaErrorInvalidValue;
  int slots = 0, rc;
  if (remap) {
    rc = resident(remap_kernel<T>, RBLOCK, &slots);
    if (rc != 0) return rc;
    const long long n_sp = (long long)n_species * n_pT;
    const long long chunks = (n_nodes + RNODES - 1) / RNODES;
    const long long blocks = (n_sp + RBLOCK - 1) / RBLOCK
                             * ((n_phi + NPHI - 1) / NPHI) * chunks;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    out[0] = (int)blocks;
    out[1] = slots;
    out[2] = (int)chunks;
    out[3] = RTILE;
    out[4] = MAX_RSPLIT;
    out[5] = NPHI;
    return cudaSuccess;
  }
  rc = dimension == 3 ? resident(fixed_kernel<T, 3>, BLOCK, &slots)
                      : resident(fixed_kernel<T, 2>, BLOCK, &slots);
  if (rc != 0) return rc;
  const long long M = (long long)n_pT * n_phi;
  const long long nz = dimension == 3 ? (n_nodes + YC - 1) / YC : 1;
  const long long blocks = (M + BLOCK - 1) / BLOCK
                           * ((n_species + JP - 1) / JP) * nz;
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
         double t_ref, void* out, cudaStream_t stream) {
  const long long plane = (long long)n_species * n_pT * n_phi * n_out;
  const long long n = NSUM * plane;
  fold_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(partial), n_parts, n, plane, n_pT, n_phi, n_out,
      static_cast<const T*>(mass), static_cast<const T*>(pT), (T)t_ref,
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
int launch_fixed(const void* cells, int n_cells, int nw, const void* mass,
                 const void* sign, const void* pm, int n_species,
                 const void* pT, const void* px, const void* py, int n_pT,
                 int n_phi, const void* nodes, const void* wR, int n_nodes,
                 int dimension, int cells_per_split, int n_partial,
                 void* partial, void* out, void* stream_v) {
  const long long n_split = n_ranges(n_cells, cells_per_split, TILE);
  if (nw != NW || !shape_ok(n_species, n_pT, n_phi, n_nodes, dimension) ||
      n_split < 1 || n_split > MAX_SPLIT || n_split != n_partial ||
      partial == nullptr)
    return cudaErrorInvalidValue;
  const long long M = (long long)n_pT * n_phi;
  const unsigned nz =
      dimension == 3 ? (unsigned)((n_nodes + YC - 1) / YC) : 1u;
  if ((long long)nz * n_split > 65535) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  const dim3 grid((unsigned)((M + BLOCK - 1) / BLOCK),
                  (unsigned)((n_species + JP - 1) / JP),
                  nz * (unsigned)n_split);
#define IS3D_FIXED(DIM_)                                                      \
  fixed_kernel<T, DIM_><<<grid, BLOCK, 0, stream>>>(                          \
      static_cast<const T*>(cells), n_cells, cells_per_split,                \
      static_cast<const T*>(mass), static_cast<const T*>(sign),              \
      static_cast<const T*>(pm), n_species, static_cast<const T*>(pT),       \
      static_cast<const T*>(px), static_cast<const T*>(py), (int)M, n_phi,   \
      static_cast<const T*>(nodes), static_cast<const T*>(wR), n_nodes,      \
      static_cast<T*>(partial))
  if (dimension == 3) IS3D_FIXED(3); else IS3D_FIXED(2);
#undef IS3D_FIXED
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return fold<T>(partial, (int)n_split, n_species, n_pT, n_phi,
                 dimension == 3 ? n_nodes : 1, mass, pT, 0.0, out, stream);
}

template <typename T>
int launch_remap(const void* cells, int n_cells, int nw, const void* mass,
                 const void* sign, const void* pm, int n_species,
                 const void* pT, int n_pT, const void* cos_phi,
                 const void* sin_phi, int n_phi, const void* table,
                 const void* wR, int n_nodes, double t_ref,
                 int cells_per_split, int n_partial, void* partial, void* out,
                 void* stream_v) {
  const long long n_split = n_ranges(n_cells, cells_per_split, RTILE);
  const long long n_parts = n_split * ((n_nodes + RNODES - 1) / RNODES);
  const long long n_sp = (long long)n_species * n_pT;
  if (nw != NW || !shape_ok(n_species, n_pT, n_phi, n_nodes, 2) ||
      n_split < 1 || n_split > MAX_RSPLIT || n_parts != n_partial ||
      n_parts > 65535 || (n_phi + NPHI - 1) / NPHI > 65535 ||
      !(t_ref > 0.0) || partial == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  const dim3 grid((unsigned)((n_sp + RBLOCK - 1) / RBLOCK),
                  (unsigned)((n_phi + NPHI - 1) / NPHI), (unsigned)n_parts);
  remap_kernel<T><<<grid, RBLOCK, 0, stream>>>(
      static_cast<const T*>(cells), n_cells, cells_per_split,
      static_cast<const T*>(mass), static_cast<const T*>(sign),
      static_cast<const T*>(pm), n_species, static_cast<const T*>(pT), n_pT,
      static_cast<const T*>(cos_phi), static_cast<const T*>(sin_phi), n_phi,
      static_cast<const T*>(table), static_cast<const T*>(wR), n_nodes,
      static_cast<T*>(partial));
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return fold<T>(partial, (int)n_parts, n_species, n_pT, n_phi, 1, mass, pT,
                 t_ref, out, stream);
}

}  // namespace

extern "C" {

// a polarization kernel's grid on the current card (see polzn_grid);
// returns a CUDA error code
int is3d_polzn_grid_f32(int n_species, int n_pT, int n_phi, int n_nodes,
                        int dimension, int remap, int* out) {
  return polzn_grid<float>(n_species, n_pT, n_phi, n_nodes, dimension, remap,
                           out);
}
int is3d_polzn_grid_f64(int n_species, int n_pT, int n_phi, int n_nodes,
                        int dimension, int remap, int* out) {
  return polzn_grid<double>(n_species, n_pT, n_phi, n_nodes, dimension,
                            remap, out);
}

// fixed nodes: partial (n_partial = ranges of cells, 5, S, P, F, n_out)
#define IS3D_POLZN_ENTRY(NAME, T)                                             \
  int NAME(const void* cells, int n_cells, int nw, const void* mass,         \
           const void* sign, const void* pm, int n_species, const void* pT,  \
           const void* px, const void* py, int n_pT, int n_phi,              \
           const void* nodes, const void* wR, int n_nodes, int dimension,    \
           int cells_per_split, int n_partial, void* partial, void* out,     \
           void* stream) {                                                   \
    return launch_fixed<T>(cells, n_cells, nw, mass, sign, pm, n_species,    \
                           pT, px, py, n_pT, n_phi, nodes, wR, n_nodes,      \
                           dimension, cells_per_split, n_partial, partial,   \
                           out, stream);                                     \
  }
IS3D_POLZN_ENTRY(is3d_polzn_f32, float)
IS3D_POLZN_ENTRY(is3d_polzn_f64, double)
#undef IS3D_POLZN_ENTRY

// the 2+1D mT remap: table (S, P, R, 2) = exp(-s eta_r), exp(+s eta_r),
// partial (n_partial = ranges of cells x chunks of nodes, 5, S, P, F)
#define IS3D_POLZN_REMAP_ENTRY(NAME, T)                                       \
  int NAME(const void* cells, int n_cells, int nw, const void* mass,         \
           const void* sign, const void* pm, int n_species, const void* pT,  \
           int n_pT, const void* cos_phi, const void* sin_phi, int n_phi,    \
           const void* table, const void* wR, int n_nodes, double t_ref,     \
           int cells_per_split, int n_partial, void* partial, void* out,     \
           void* stream) {                                                   \
    return launch_remap<T>(cells, n_cells, nw, mass, sign, pm, n_species,    \
                           pT, n_pT, cos_phi, sin_phi, n_phi, table, wR,     \
                           n_nodes, t_ref, cells_per_split, n_partial,       \
                           partial, out, stream);                            \
  }
IS3D_POLZN_REMAP_ENTRY(is3d_polzn_remap_f32, float)
IS3D_POLZN_REMAP_ENTRY(is3d_polzn_remap_f64, double)
#undef IS3D_POLZN_REMAP_ENTRY

const char* is3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
