// Per-cell dN/dX reduction for Hopper (sm_90a), float32 and float64.
//
// Replaces the XLA body of is3d_tpu/kernels/dndx.py::_dndx_jit
// (_chunk_contribution(reduce=False) followed by _cell_dNdy), and realises
// the design of the Pallas probe experiments/probe_dndx_reduce.py::
// make_pallas_percell (P2): the per-cell (C, S) and per-node (S, R)
// accumulators stay on chip, and the reduction over momentum points is
// fused into the pass that produces the points.  One launch per canonical
// group computes, for a producer f(c, r, s, m),
//
//     per_cell[c, s] = scale_s * sum_r wR_r sum_m wM_m f(c, r, s, m)
//     dydeta[s, r]   = scale_s * sum_c sum_m wM_m f(c, r, s, m)
//
// Two producers instantiate the same reduction:
//   * EmissionProducer: p.dsigma f_eq (1 + df) of emission.cuh (linear df
//     1-2) at fixed rapidity nodes, 2+1D (Delta = -eta_r, wR = eta weights)
//     or 3+1D (Delta = y_r - eta_c, wR = 1); scale_s = CF * degeneracy.
//     Inputs as smooth_spectra.cu (packed cells, species and momentum
//     constants) plus wM (n_pT*n_phi) and wR (n_nodes).
//   * ProbeProducer: P2's synthetic f = 1/(e^x + 1) (1 + 0.1 x) w(s, m),
//     x = a(c, r) b(s, m) + 0.3 a(c, r); scale_s = 1.
// Two more kernels turn per_cell into the (tau, r) histograms: the
// scatter-add of _dndx_jit (.at[].add) as a fixed-order segment sum over
// the (bin, cell) entries pre-sorted by bin (kernels/dndx.py:bin_plan).
// The segments are very uneven -- one bin (dN/dy) holds every cell, the
// tau and r bins hundreds, many (tau, r) bins none -- so the sum runs in
// two passes over fixed slices of SLICE entries: slice_kernel sums each
// slice's runs of one bin (a thread per (slice, species), species
// fastest, so a warp reads 128 contiguous bytes per entry, and a long bin
// spreads over the card), and bin_kernel adds, per (bin, species), the
// pieces of the bin's slices in order.  Bound by latency: the bytes (one
// read of per_cell) take a few microseconds; nothing uses atomics.

#include <cuda_runtime.h>

#include "emission.cuh"

namespace {

using namespace is3d;

constexpr int BLOCK = 256;           // threads (momentum points) per block
constexpr int WARPS = BLOCK / 32;
constexpr int TILE = 16;             // cells per shared-memory tile
constexpr int RC = 8;                // rapidity nodes per staged chunk
constexpr size_t SMEM_BUDGET = 48 * 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SLICE = 64;            // binning entries per slice
constexpr int BIN_TILE = 32;         // bins and species per bin_kernel block

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  return v;                                        // valid in lane 0
}

// ------------------------------------------------------------- producers

template <typename T, int DF, int DIM>
struct EmissionProducer {
  const T* cells;                    // (n_cells, NF) packed rows
  const T* mass;
  const T* sign;
  const T* baryon;
  const T* pT;
  const T* px;
  const T* py;
  int n_phi;
  int regulate;
  int outflow;

  using PointState = Point<T>;
  using CellState = CellPoint<T>;

  // tile layout: raw [NF][TILE] | composites [NCOMP][TILE * RC]
  static size_t tile_elems() { return (size_t)NF * TILE + NCOMP * TILE * RC; }

  __device__ void stage_cells(T* tile, int c0, int nc) const {
    for (int i = threadIdx.x; i < nc * NF; i += BLOCK) {
      const int c = i / NF;
      tile[(i - c * NF) * TILE + c] = cells[(size_t)c0 * NF + i];
    }
  }

  __device__ void stage_nodes(T* tile, int c0, int nc, const T* node_s,
                              int r0, int nr) const {
    const T* raw = tile;
    T* comp = tile + NF * TILE;
    constexpr int ldc = TILE * RC;
    for (int i = threadIdx.x; i < nc * nr; i += BLOCK) {
      const int c = i / nr;
      const int rr = i - c * nr;
      const T delta = DIM == 3 ? node_s[r0 + rr] - raw[F_ETA * TILE + c]
                               : -node_s[r0 + rr];
      const Comp<T> k =
          composites(raw, TILE, c, d_cosh(delta), d_sinh(delta));
      const int j = c * RC + rr;
      comp[0 * ldc + j] = k.A1;
      comp[1 * ldc + j] = k.B1;
      comp[2 * ldc + j] = k.C1;
      comp[3 * ldc + j] = k.C2;
      comp[4 * ldc + j] = k.C3;
      comp[5 * ldc + j] = k.D1;
    }
  }

  __device__ PointState point(int s, int m) const {
    return make_point<T>(mass[s], pT[m / n_phi], px[m], py[m], sign[s],
                         baryon[s]);
  }

  __device__ CellState cell(const T* tile, int c, const PointState& p) const {
    return cell_point(tile, TILE, c, p);
  }

  __device__ T eval(const T* tile, int c, int rr, const PointState& p,
                    const CellState& q) const {
    const T* comp = tile + NF * TILE;
    constexpr int ldc = TILE * RC;
    const int j = c * RC + rr;
    Comp<T> k;
    k.A1 = comp[0 * ldc + j];
    k.B1 = comp[1 * ldc + j];
    k.C1 = comp[2 * ldc + j];
    k.C2 = comp[3 * ldc + j];
    k.C3 = comp[4 * ldc + j];
    k.D1 = comp[5 * ldc + j];
    return emission<T, DF>(p, q, k, regulate, outflow);
  }
};

template <typename T>
struct ProbeProducer {
  const T* a;                        // (n_cells, n_nodes)
  const T* b;                        // (n_species, M)
  const T* w;                        // (n_species, M)
  int n_nodes;
  int M;

  struct PointState { T b, w; };
  struct CellState {};

  // tile layout: a [TILE][RC]
  static size_t tile_elems() { return (size_t)TILE * RC; }

  __device__ void stage_cells(T*, int, int) const {}

  __device__ void stage_nodes(T* tile, int c0, int nc, const T*, int r0,
                              int nr) const {
    for (int i = threadIdx.x; i < nc * nr; i += BLOCK) {
      const int c = i / nr;
      const int rr = i - c * nr;
      tile[c * RC + rr] = a[(size_t)(c0 + c) * n_nodes + r0 + rr];
    }
  }

  __device__ PointState point(int s, int m) const {
    const size_t i = (size_t)s * M + m;
    return PointState{b[i], w[i]};
  }

  __device__ CellState cell(const T*, int, const PointState&) const {
    return CellState{};
  }

  __device__ T eval(const T* tile, int c, int rr, const PointState& p,
                    const CellState&) const {
    const T av = tile[c * RC + rr];
    const T x = av * p.b + T(0.3) * av;
    const T f = T(1) / (d_exp(x) + T(1));
    return f * (T(1) + T(0.1) * x) * p.w;
  }
};

// ------------------------------------------------------------- kernels

// grid (n_species, n_split); partial (n_split, n_species, n_nodes)
template <typename T, typename Prod>
__global__ void __launch_bounds__(BLOCK)
percell_kernel(Prod prod, int n_cells, int cells_per_split, int n_species,
               int M, const T* __restrict__ nodes, const T* __restrict__ wR,
               const T* __restrict__ wM, int n_nodes,
               const T* __restrict__ deg, T prefactor,
               T* __restrict__ per_cell, T* __restrict__ partial) {
  // one extern declaration (as double: 8-byte aligned) for every
  // instantiation; carved as nodes | wR | per-(warp, node) | per-(warp,
  // cell) | producer tile
  extern __shared__ double smem_d[];
  const int R = n_nodes;
  T* node_s = reinterpret_cast<T*>(smem_d);
  T* wR_s = node_s + R;
  T* dydw = wR_s + R;                               // [WARPS][R]
  T* pcw = dydw + WARPS * R;                        // [WARPS][TILE]
  T* tile = pcw + WARPS * TILE;

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cbeg = blockIdx.y * cells_per_split;
  const int cend = min(n_cells, cbeg + cells_per_split);
  const int ppt = (M + BLOCK - 1) / BLOCK;          // points per thread

  for (int i = tid; i < R; i += BLOCK) {
    node_s[i] = nodes[i];
    wR_s[i] = wR[i];
  }
  for (int i = tid; i < WARPS * R; i += BLOCK) dydw[i] = T(0);
  for (int i = tid; i < WARPS * TILE; i += BLOCK) pcw[i] = T(0);
  const T scale = deg != nullptr ? prefactor * deg[s] : prefactor;

  for (int c0 = cbeg; c0 < cend; c0 += TILE) {
    const int nc = min(TILE, cend - c0);
    __syncthreads();                                // previous tile consumed
    prod.stage_cells(tile, c0, nc);
    for (int r0 = 0; r0 < R; r0 += RC) {
      const int nr = min(RC, R - r0);
      __syncthreads();                              // raw staged, chunk free
      prod.stage_nodes(tile, c0, nc, node_s, r0, nr);
      __syncthreads();
      T acc[RC];
#pragma unroll
      for (int rr = 0; rr < RC; ++rr) acc[rr] = T(0);
      for (int j = 0; j < ppt; ++j) {
        const int m = tid + j * BLOCK;
        const bool active = m < M;
        typename Prod::PointState p{};
        T wm = T(0);
        if (active) {
          p = prod.point(s, m);
          wm = wM[m];
        }
        for (int c = 0; c < nc; ++c) {
          T pc = T(0);
          if (active) {
            const typename Prod::CellState q = prod.cell(tile, c, p);
#pragma unroll
            for (int rr = 0; rr < RC; ++rr) {
              if (rr < nr) {
                const T e = wm * prod.eval(tile, c, rr, p, q);
                pc += wR_s[r0 + rr] * e;
                acc[rr] += e;
              }
            }
          }
          pc = warp_sum(pc);
          if (lane == 0) pcw[warp * TILE + c] += pc;
        }
      }
#pragma unroll
      for (int rr = 0; rr < RC; ++rr) {
        const T v = warp_sum(acc[rr]);
        if (lane == 0 && rr < nr) dydw[warp * R + r0 + rr] += v;
      }
    }
    __syncthreads();                                // pcw complete
    for (int c = tid; c < nc; c += BLOCK) {
      T v = T(0);
      for (int w = 0; w < WARPS; ++w) {
        v += pcw[w * TILE + c];
        pcw[w * TILE + c] = T(0);
      }
      per_cell[(size_t)(c0 + c) * n_species + s] = scale * v;
    }
  }
  __syncthreads();                                  // dydw complete
  for (int r = tid; r < R; r += BLOCK) {
    T v = T(0);
    for (int w = 0; w < WARPS; ++w) v += dydw[w * R + r];
    partial[((size_t)blockIdx.y * n_species + s) * R + r] = v;
  }
}

// dydeta[s, r] = scale_s * sum over splits (in order) of partial
template <typename T>
__global__ void __launch_bounds__(BLOCK)
fold_kernel(const T* __restrict__ partial, int n_split, int n_species,
            int n_nodes, const T* __restrict__ deg, T prefactor,
            T* __restrict__ dydeta) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const int n = n_species * n_nodes;
  if (i >= n) return;
  T v = T(0);
  for (int k = 0; k < n_split; ++k) v += partial[(size_t)k * n + i];
  const int s = i / n_nodes;
  dydeta[i] = (deg != nullptr ? prefactor * deg[s] : prefactor) * v;
}

// The entries [j SLICE, (j + 1) SLICE) of slice j fall into runs of one
// bin each, summed over their entries in ascending order: the first run's
// sum goes to piece row j, every later run's (it starts its bin b) to row
// n_slices + b, so bin_kernel reads a bin's slices as consecutive rows.
// Loads come in batches to keep them in flight.
template <typename T>
__global__ void __launch_bounds__(BLOCK)
slice_kernel(const T* __restrict__ per_cell, int n_species,
             const int* __restrict__ cell, const long long* __restrict__ key,
             int n_entries, int n_slices, T* __restrict__ piece) {
  constexpr int BATCH = 16;
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= (long long)n_slices * n_species) return;
  const int j = (int)(i / n_species);
  const int s = (int)(i - (long long)j * n_species);
  const int k0 = j * SLICE;
  const int k1 = min(k0 + SLICE, n_entries);
  T v = T(0);
  long long row = j;
  long long prev = key[k0];
  for (int b = k0; b < k1; b += BATCH) {
    T val[BATCH];
    long long kb[BATCH];
#pragma unroll
    for (int t = 0; t < BATCH; ++t) {
      const int k = min(b + t, k1 - 1);
      val[t] = per_cell[(size_t)cell[k] * n_species + s];
      kb[t] = key[k];
    }
#pragma unroll
    for (int t = 0; t < BATCH; ++t) {
      if (b + t < k1) {
        if (kb[t] != prev) {                        // a new run starts here
          piece[(size_t)row * n_species + s] = v;
          v = T(0);
          row = n_slices + kb[t];
          prev = kb[t];
        }
        v += val[t];
      }
    }
  }
  piece[(size_t)row * n_species + s] = v;
}

// hist[s, b] = sum over k in [start[b], start[b+1]) of per_cell[cell[k], s]:
// the piece of b's first run, then the first-run pieces of the slices that
// start inside b, in order.  A block owns BIN_TILE bins x BIN_TILE
// species: lanes run over species to read, the tile is transposed in
// shared memory, and lanes run over bins to write.
template <typename T>
__global__ void __launch_bounds__(BLOCK)
bin_kernel(int n_species, const int* __restrict__ start, int n_bins,
           int n_slices, const T* __restrict__ piece, T* __restrict__ hist) {
  __shared__ T tile[BIN_TILE][BIN_TILE + 1];        // [species][bin]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = blockIdx.x * BIN_TILE;
  const int s0 = blockIdx.y * BIN_TILE;
  const int s = s0 + lane;
  // unrolled over the warp's bins, so their loads overlap
#pragma unroll
  for (int q = 0; q < BIN_TILE / WARPS; ++q) {
    const int bb = warp + q * WARPS;
    const int b = b0 + bb;
    T v = T(0);
    if (b < n_bins && s < n_species) {
      const int k0 = start[b];
      const int k1 = start[b + 1];
      if (k0 < k1) {
        const int j0 = k0 / SLICE;
        const size_t head = k0 == j0 * SLICE ? (size_t)j0
                                             : (size_t)n_slices + b;
        v = piece[head * n_species + s];
        // the slices that start inside b, BATCH loads in flight at a time
        // (a plain loop issues each load after the previous add)
        constexpr int BATCH = 16;
        const int j1 = (k1 + SLICE - 1) / SLICE;    // slices j < j1 start in b
        int j = j0 + 1;
        for (; j + BATCH <= j1; j += BATCH) {
          T x[BATCH];
#pragma unroll
          for (int t = 0; t < BATCH; ++t)
            x[t] = piece[(size_t)(j + t) * n_species + s];
#pragma unroll
          for (int t = 0; t < BATCH; ++t) v += x[t];
        }
        for (; j < j1; ++j) v += piece[(size_t)j * n_species + s];
      }
    }
    tile[lane][bb] = v;
  }
  __syncthreads();
  for (int ss = warp; ss < BIN_TILE; ss += WARPS) {
    const int b = b0 + lane;
    if (b < n_bins && s0 + ss < n_species)
      hist[(size_t)(s0 + ss) * n_bins + b] = tile[ss][lane];
  }
}

// ------------------------------------------------------------- launchers

template <typename T, typename Prod>
int launch_percell(const Prod& prod, int n_cells, int cells_per_split,
                   int n_species, int M, const void* nodes_v,
                   const void* wR_v, const void* wM_v, int n_nodes,
                   const void* deg_v, double prefactor, void* per_cell_v,
                   void* dydeta_v, void* partial_v, void* stream_v) {
  if (n_cells < 1 || n_species < 1 || M < 1 || n_nodes < 1 ||
      cells_per_split < TILE || cells_per_split % TILE != 0)
    return cudaErrorInvalidValue;
  const long long n_split =
      ((long long)n_cells + cells_per_split - 1) / cells_per_split;
  if (n_split > 65535 || n_species > 0x7fffffff / n_nodes)
    return cudaErrorInvalidValue;
  const size_t smem = (2 * (size_t)n_nodes + WARPS * (size_t)n_nodes +
                       WARPS * TILE + Prod::tile_elems()) * sizeof(T);
  if (smem > SMEM_BUDGET) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  const T* nodes = static_cast<const T*>(nodes_v);
  const T* wR = static_cast<const T*>(wR_v);
  const T* wM = static_cast<const T*>(wM_v);
  const T* deg = static_cast<const T*>(deg_v);
  T* partial = static_cast<T*>(partial_v);
  percell_kernel<T, Prod>
      <<<dim3((unsigned)n_species, (unsigned)n_split), BLOCK, smem, stream>>>(
          prod, n_cells, cells_per_split, n_species, M, nodes, wR, wM,
          n_nodes, deg, (T)prefactor, static_cast<T*>(per_cell_v), partial);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int n = n_species * n_nodes;
  fold_kernel<T><<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(
      partial, (int)n_split, n_species, n_nodes, deg, (T)prefactor,
      static_cast<T*>(dydeta_v));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dndx(const void* cells, int n_cells, int nf, const void* mass,
                const void* sign, const void* baryon, const void* deg,
                int n_species, const void* pT, const void* px,
                const void* py, int n_pT, int n_phi, const void* nodes,
                const void* wR, const void* wM, int n_nodes, int df_mode,
                int dimension, int regulate, int outflow, double prefactor,
                int cells_per_split, void* per_cell, void* dydeta,
                void* partial, void* stream) {
  if (nf != NF || (df_mode != 1 && df_mode != 2) ||
      (dimension != 2 && dimension != 3) || n_pT < 1 || n_phi < 1)
    return cudaErrorInvalidValue;
#define IS3D_DNDX(DF_, DIM_)                                                  \
  {                                                                          \
    EmissionProducer<T, DF_, DIM_> prod{                                     \
        static_cast<const T*>(cells), static_cast<const T*>(mass),           \
        static_cast<const T*>(sign), static_cast<const T*>(baryon),          \
        static_cast<const T*>(pT), static_cast<const T*>(px),                \
        static_cast<const T*>(py), n_phi, regulate, outflow};                \
    return launch_percell<T>(prod, n_cells, cells_per_split, n_species,      \
                             n_pT * n_phi, nodes, wR, wM, n_nodes, deg,      \
                             prefactor, per_cell, dydeta, partial, stream);  \
  }
  if (dimension == 3) {
    if (df_mode == 1) IS3D_DNDX(1, 3) else IS3D_DNDX(2, 3)
  } else {
    if (df_mode == 1) IS3D_DNDX(1, 2) else IS3D_DNDX(2, 2)
  }
#undef IS3D_DNDX
  return cudaErrorInvalidValue;                     // not reached
}

template <typename T>
int launch_probe(const void* a, int n_cells, int n_nodes, const void* b,
                 const void* w, int n_species, int M, const void* wM,
                 const void* wR, int cells_per_split, void* per_cell,
                 void* sr, void* partial, void* stream) {
  ProbeProducer<T> prod{static_cast<const T*>(a), static_cast<const T*>(b),
                        static_cast<const T*>(w), n_nodes, M};
  // the probe has no rapidity nodes: wR fills the unused node table
  return launch_percell<T>(prod, n_cells, cells_per_split, n_species, M, wR,
                           wR, wM, n_nodes, nullptr, 1.0, per_cell, sr,
                           partial, stream);
}

template <typename T>
int launch_bin(const void* per_cell_v, int n_species, const void* cell_v,
               const void* key_v, int n_entries, const void* start_v,
               int n_bins, void* piece_v, long long n_piece_rows,
               void* hist_v, void* stream_v) {
  if (n_species < 1 || n_bins < 1 || n_entries < 0)
    return cudaErrorInvalidValue;
  const long long n_slices = ((long long)n_entries + SLICE - 1) / SLICE;
  const long long n_part = n_slices * n_species;
  if (n_piece_rows < n_slices + n_bins ||
      (n_part + BLOCK - 1) / BLOCK > 0x7fffffffLL ||
      (n_species + BIN_TILE - 1) / BIN_TILE > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  T* piece = static_cast<T*>(piece_v);
  if (n_part > 0) {
    slice_kernel<T><<<(unsigned)((n_part + BLOCK - 1) / BLOCK), BLOCK, 0,
                      stream>>>(
        static_cast<const T*>(per_cell_v), n_species,
        static_cast<const int*>(cell_v), static_cast<const long long*>(key_v),
        n_entries, (int)n_slices, piece);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  const dim3 grid((unsigned)((n_bins + BIN_TILE - 1) / BIN_TILE),
                  (unsigned)((n_species + BIN_TILE - 1) / BIN_TILE));
  bin_kernel<T><<<grid, BLOCK, 0, stream>>>(
      n_species, static_cast<const int*>(start_v), n_bins, (int)n_slices,
      piece, static_cast<T*>(hist_v));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define IS3D_DNDX_ENTRY(NAME, T)                                              \
  int NAME(const void* cells, int n_cells, int nf, const void* mass,         \
           const void* sign, const void* baryon, const void* deg,            \
           int n_species, const void* pT, const void* px, const void* py,    \
           int n_pT, int n_phi, const void* nodes, const void* wR,           \
           const void* wM, int n_nodes, int df_mode, int dimension,          \
           int regulate, int outflow, double prefactor, int cells_per_split, \
           void* per_cell, void* dydeta, void* partial, void* stream) {      \
    return launch_dndx<T>(cells, n_cells, nf, mass, sign, baryon, deg,       \
                          n_species, pT, px, py, n_pT, n_phi, nodes, wR, wM, \
                          n_nodes, df_mode, dimension, regulate, outflow,    \
                          prefactor, cells_per_split, per_cell, dydeta,      \
                          partial, stream);                                  \
  }
IS3D_DNDX_ENTRY(is3d_dndx_f32, float)
IS3D_DNDX_ENTRY(is3d_dndx_f64, double)
#undef IS3D_DNDX_ENTRY

#define IS3D_PROBE_ENTRY(NAME, T)                                             \
  int NAME(const void* a, int n_cells, int n_nodes, const void* b,           \
           const void* w, int n_species, int M, const void* wM,              \
           const void* wR, int cells_per_split, void* per_cell, void* sr,    \
           void* partial, void* stream) {                                    \
    return launch_probe<T>(a, n_cells, n_nodes, b, w, n_species, M, wM, wR,  \
                           cells_per_split, per_cell, sr, partial, stream);  \
  }
IS3D_PROBE_ENTRY(is3d_dndx_probe_f32, float)
IS3D_PROBE_ENTRY(is3d_dndx_probe_f64, double)
#undef IS3D_PROBE_ENTRY

#define IS3D_BIN_ENTRY(NAME, T)                                               \
  int NAME(const void* per_cell, int n_species, const void* cell,            \
           const void* key, int n_entries, const void* start, int n_bins,    \
           void* piece, long long n_piece_rows, void* hist, void* stream) {  \
    return launch_bin<T>(per_cell, n_species, cell, key, n_entries, start,   \
                         n_bins, piece, n_piece_rows, hist, stream);         \
  }
IS3D_BIN_ENTRY(is3d_dndx_bin_f32, float)
IS3D_BIN_ENTRY(is3d_dndx_bin_f64, double)
#undef IS3D_BIN_ENTRY

const char* is3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
