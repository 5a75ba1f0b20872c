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
// The 2+1D mT remap forms its composites per (cell, point, node), which
// species blocking cannot share; it keeps the one-point-per-thread loop
// of emission.cuh (remap_kernel).

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

constexpr int RBLOCK = 256;        // points per block of the remap kernel
constexpr int MAX_RTILE = 64;      // cells per shared-memory tile

// one thread per (species, pT, phi) point, all eta nodes, cells in index
// order; nodes at Delta = y_flow(cell) - s(mT) eta_r
template <typename T, int DF>
__global__ void __launch_bounds__(RBLOCK)
remap_kernel(const T* __restrict__ cells, int n_cells,
             const T* __restrict__ mass, const T* __restrict__ sign,
             const T* __restrict__ baryon, const T* __restrict__ deg,
             int n_species, const T* __restrict__ pT,
             const T* __restrict__ px, const T* __restrict__ py, int n_pT,
             int n_phi, const T* __restrict__ nodes,
             const T* __restrict__ weights, int n_nodes, int tile_c,
             int regulate, int outflow, T prefactor, T t_ref,
             T* __restrict__ out) {
  // carved as nodes | weights | raw cell tile [NF][tile_c]
  extern __shared__ double smem_d[];
  T* node_s = reinterpret_cast<T*>(smem_d);
  T* weight_s = node_s + n_nodes;
  T* raw = weight_s + n_nodes;

  const int M = n_pT * n_phi;
  const int idx = blockIdx.x * RBLOCK + threadIdx.x;
  const bool active = idx < n_species * M;

  for (int i = threadIdx.x; i < n_nodes; i += RBLOCK) {
    node_s[i] = nodes[i];
    weight_s[i] = weights[i];
  }

  Point<T> p;
  int s = 0;
  {
    int m = 0, ip = 0;
    if (active) {
      s = idx / M;
      m = idx - s * M;
      ip = m / n_phi;
    }
    const T ms = active ? mass[s] : T(0);
    const T pt = active ? pT[ip] : T(0);
    p.m2 = ms * ms;
    p.mT = d_sqrt(p.m2 + pt * pt);
    p.px = active ? px[m] : T(0);
    p.py = active ? py[m] : T(0);
    p.mT2 = p.mT * p.mT;
    p.mTpx = p.mT * p.px;
    p.mTpy = p.mT * p.py;
    p.px2 = p.px * p.px;
    p.py2 = p.py * p.py;
    p.pxpy = p.px * p.py;
    p.sgn = active ? sign[s] : T(1);
    p.bar = active ? baryon[s] : T(0);
    p.srem = d_sqrt(t_ref / (p.mT > t_ref ? p.mT : t_ref));
  }

  T acc = T(0);
  for (int c0 = 0; c0 < n_cells; c0 += tile_c) {
    const int nc = min(tile_c, n_cells - c0);
    __syncthreads();                                // previous tile consumed
    for (int i = threadIdx.x; i < nc * NF; i += RBLOCK) {
      const int c = i / NF;
      raw[(i - c * NF) * tile_c + c] = cells[(size_t)c0 * NF + i];
    }
    __syncthreads();
    if (!active) continue;
    for (int c = 0; c < nc; ++c) {
      const CellPoint<T> q = cell_point(raw, tile_c, c, p);
      const T yflow = raw[F_YFLOW * tile_c + c];
      for (int r = 0; r < n_nodes; ++r) {
        const T ep = d_exp(yflow - p.srem * node_s[r]);
        const T em = T(1) / ep;
        const Comp<T> k = composites(raw, tile_c, c, T(0.5) * (ep + em),
                                     T(0.5) * (ep - em));
        acc += weight_s[r] * emission<T, DF>(p, q, k, regulate, outflow);
      }
    }
  }
  if (active) out[idx] = prefactor * deg[s] * (acc * p.srem);
}

// ------------------------------------------------------------ launchers

struct Shape {
  int n_cells, n_species, n_pT, n_phi, n_nodes, df_mode, dimension, remap;
};

int check_shape(const Shape& a) {
  if ((a.df_mode != 1 && a.df_mode != 2) ||
      (a.dimension != 2 && a.dimension != 3) || a.n_cells < 0 ||
      a.n_species < 0 || a.n_pT < 0 || a.n_phi < 0 || a.n_nodes < 1)
    return cudaErrorInvalidValue;
  const long long M = (long long)a.n_pT * a.n_phi;
  if ((long long)a.n_species * M > 0x7fffffffLL - RBLOCK ||
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

// splits of the cell axis for a launch of this shape (1 for the remap),
// or minus a CUDA error code
template <typename T>
int splits(const Shape& a) {
  const int rc = check_shape(a);
  if (rc != 0) return -rc;
  if (a.dimension == 2 && a.remap) return 1;
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
           int outflow, double prefactor, double t_ref, int n_split,
           void* partial_v, void* out_v, void* stream_v) {
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

  if (a.dimension == 2 && a.remap) {
    const size_t fixed = 2 * (size_t)a.n_nodes * sizeof(T);
    if (fixed + NF * sizeof(T) > SMEM_BUDGET || n_split != 1)
      return cudaErrorInvalidValue;
    int tile_c = (int)((SMEM_BUDGET - fixed) / (NF * sizeof(T)));
    if (tile_c > MAX_RTILE) tile_c = MAX_RTILE;
    const size_t smem = fixed + (size_t)tile_c * NF * sizeof(T);
    const unsigned grid =
        (unsigned)((M * a.n_species + RBLOCK - 1) / RBLOCK);
#define IS3D_REMAP(DF_)                                                       \
  remap_kernel<T, DF_><<<grid, RBLOCK, smem, stream>>>(                       \
      cells, a.n_cells, mass, sign, baryon, deg, a.n_species, pT, px, py,     \
      a.n_pT, a.n_phi, nodes, weights, a.n_nodes, tile_c, regulate, outflow, \
      (T)prefactor, (T)t_ref, out)
    if (a.df_mode == 1) IS3D_REMAP(1); else IS3D_REMAP(2);
#undef IS3D_REMAP
    return (int)cudaGetLastError();
  }

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

}  // namespace

extern "C" {

#define IS3D_SPLITS_ENTRY(NAME, T)                                            \
  int NAME(int n_cells, int n_species, int n_pT, int n_phi, int n_nodes,     \
           int df_mode, int dimension, int remap) {                          \
    return splits<T>(Shape{n_cells, n_species, n_pT, n_phi, n_nodes,         \
                           df_mode, dimension, remap});                      \
  }
IS3D_SPLITS_ENTRY(is3d_smooth_spectra_splits_f32, float)
IS3D_SPLITS_ENTRY(is3d_smooth_spectra_splits_f64, double)
#undef IS3D_SPLITS_ENTRY

#define IS3D_SPECTRA_ENTRY(NAME, T)                                           \
  int NAME(const void* cells, int n_cells, int nf, const void* mass,         \
           const void* sign, const void* baryon, const void* deg,            \
           int n_species, const void* pT, const void* px, const void* py,    \
           int n_pT, int n_phi, const void* nodes, const void* weights,      \
           int n_nodes, int df_mode, int dimension, int remap, int regulate, \
           int outflow, double prefactor, double t_ref, int n_split,         \
           void* partial, void* out, void* stream) {                         \
    return launch<T>(cells, nf,                                              \
                     Shape{n_cells, n_species, n_pT, n_phi, n_nodes,         \
                           df_mode, dimension, remap},                       \
                     mass, sign, baryon, deg, pT, px, py, nodes, weights,    \
                     regulate, outflow, prefactor, t_ref, n_split, partial,  \
                     out, stream);                                           \
  }
IS3D_SPECTRA_ENTRY(is3d_smooth_spectra_f32, float)
IS3D_SPECTRA_ENTRY(is3d_smooth_spectra_f64, double)
#undef IS3D_SPECTRA_ENTRY

const char* is3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
