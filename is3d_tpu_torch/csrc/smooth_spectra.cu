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
// Design.  Output-stationary: one thread owns one (species, pT, phi) point,
// a block owns 256 points and one output rapidity (3+1D) or all eta nodes
// (2+1D).  Each thread keeps its own accumulator and walks the cells in
// index order, so the sum is deterministic run to run and needs no atomics
// (the Pallas grid carried its sum across a sequential cell-block axis,
// which Hopper's unordered blocks do not have).  Cells come in tiles
// staged in shared memory; for fixed nodes the block also computes each
// cell's per-(cell, node) composites A1, B1, C1-C3, D1 once into shared
// memory, so the per-point work is the fma chain of emission.cuh.
//
// What bounds it: not bytes.  A group of 16384 cells is 2.4 MB and stays
// in L2; per point the kernel does ~40 fma and the special functions: one
// exp and one reciprocal for the occupation 1/(e^x + s), one more
// reciprocal 1/(u.p) for df 2, and with the remap one more exp (and its
// reciprocal) for cosh/sinh of Delta.  So it is bound by the SFU and the
// IEEE division sequences.  The design keeps the special functions to that
// minimum per point: the node-dependent cosh/sinh of fixed nodes are
// hoisted to the per-(cell, node) composites, the per-cell 1/T and the df
// coefficients are folded into the packed rows on the host side, and every
// cell-side quantity is read from shared memory as a broadcast.  No fast
// math: exp(u.p/T) overflows at large mT cosh(Delta), and 1/(inf + s) must
// stay exactly 0.

#include <cuda_runtime.h>

#include "emission.cuh"

namespace {

using namespace is3d;

constexpr int BLOCK = 256;         // points per block
constexpr int MAX_TILE = 64;       // cells per shared-memory tile
constexpr size_t SMEM_BUDGET = 48 * 1024;

enum Mode { MODE_3D = 0, MODE_2D_FIXED = 1, MODE_2D_REMAP = 2 };

template <typename T, int MODE, int DF>
__global__ void __launch_bounds__(BLOCK)
spectra_kernel(const T* __restrict__ cells, int n_cells,
               const T* __restrict__ mass, const T* __restrict__ sign,
               const T* __restrict__ baryon, const T* __restrict__ deg,
               int n_species, const T* __restrict__ pT,
               const T* __restrict__ px, const T* __restrict__ py,
               int n_pT, int n_phi, const T* __restrict__ nodes,
               const T* __restrict__ weights, int n_nodes, int tile_c,
               int regulate, int outflow, T prefactor, T t_ref,
               T* __restrict__ out) {
  // one extern declaration (as double: 8-byte aligned) for every
  // instantiation; carved as nodes | weights | raw cell tile | composites
  extern __shared__ double smem_d[];
  T* node_s = reinterpret_cast<T*>(smem_d);
  T* weight_s = node_s + n_nodes;
  T* raw = weight_s + n_nodes;                      // [NF][tile_c]
  const int nr = MODE == MODE_3D ? 1 : (MODE == MODE_2D_FIXED ? n_nodes : 0);
  T* comp = raw + NF * tile_c;                      // [NCOMP][tile_c * nr]
  const int ldc = tile_c * nr;

  const int M = n_pT * n_phi;
  const int idx = blockIdx.x * BLOCK + threadIdx.x;
  const bool active = idx < n_species * M;
  const int iy = blockIdx.y;                        // 3+1D output rapidity

  for (int i = threadIdx.x; i < n_nodes; i += BLOCK) {
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
    for (int i = threadIdx.x; i < nc * NF; i += BLOCK) {
      const int c = i / NF;
      raw[(i - c * NF) * tile_c + c] = cells[(size_t)c0 * NF + i];
    }
    __syncthreads();
    if (MODE != MODE_2D_REMAP) {
      for (int i = threadIdx.x; i < nc * nr; i += BLOCK) {
        const int c = i / nr;
        const int r = i - c * nr;
        const T delta = MODE == MODE_3D
                            ? node_s[iy] - raw[F_ETA * tile_c + c]
                            : -node_s[r];
        const Comp<T> k =
            composites(raw, tile_c, c, d_cosh(delta), d_sinh(delta));
        comp[0 * ldc + i] = k.A1;
        comp[1 * ldc + i] = k.B1;
        comp[2 * ldc + i] = k.C1;
        comp[3 * ldc + i] = k.C2;
        comp[4 * ldc + i] = k.C3;
        comp[5 * ldc + i] = k.D1;
      }
      __syncthreads();
    }
    if (!active) continue;
    for (int c = 0; c < nc; ++c) {
      const CellPoint<T> q = cell_point(raw, tile_c, c, p);
      if (MODE == MODE_2D_REMAP) {
        // nodes at Delta = y_flow(cell) - s(mT) eta_r, per point
        const T yflow = raw[F_YFLOW * tile_c + c];
        for (int r = 0; r < n_nodes; ++r) {
          const T ep = d_exp(yflow - p.srem * node_s[r]);
          const T em = T(1) / ep;
          const Comp<T> k = composites(raw, tile_c, c, T(0.5) * (ep + em),
                                       T(0.5) * (ep - em));
          acc += weight_s[r] * emission<T, DF>(p, q, k, regulate, outflow);
        }
      } else {
        for (int r = 0; r < nr; ++r) {
          const int j = c * nr + r;
          Comp<T> k;
          k.A1 = comp[0 * ldc + j];
          k.B1 = comp[1 * ldc + j];
          k.C1 = comp[2 * ldc + j];
          k.C2 = comp[3 * ldc + j];
          k.C3 = comp[4 * ldc + j];
          k.D1 = comp[5 * ldc + j];
          const T e = emission<T, DF>(p, q, k, regulate, outflow);
          acc += MODE == MODE_3D ? e : weight_s[r] * e;
        }
      }
    }
  }
  if (active) {
    const T val = MODE == MODE_2D_REMAP ? acc * p.srem : acc;
    out[(size_t)idx * gridDim.y + iy] = prefactor * deg[s] * val;
  }
}

template <typename T, int MODE, int DF>
void launch_one(dim3 grid, size_t smem, cudaStream_t stream, const T* cells,
                int n_cells, const T* mass, const T* sign, const T* baryon,
                const T* deg, int n_species, const T* pT, const T* px,
                const T* py, int n_pT, int n_phi, const T* nodes,
                const T* weights, int n_nodes, int tile_c, int regulate,
                int outflow, T prefactor, T t_ref, T* out) {
  spectra_kernel<T, MODE, DF><<<grid, BLOCK, smem, stream>>>(
      cells, n_cells, mass, sign, baryon, deg, n_species, pT, px, py, n_pT,
      n_phi, nodes, weights, n_nodes, tile_c, regulate, outflow, prefactor,
      t_ref, out);
}

template <typename T>
int launch(const void* cells_v, int n_cells, int nf, const void* mass_v,
           const void* sign_v, const void* baryon_v, const void* deg_v,
           int n_species, const void* pT_v, const void* px_v,
           const void* py_v, int n_pT, int n_phi, const void* nodes_v,
           const void* weights_v, int n_nodes, int df_mode, int dimension,
           int remap, int regulate, int outflow, double prefactor,
           double t_ref, void* out_v, void* stream_v) {
  if (nf != NF || (df_mode != 1 && df_mode != 2) ||
      (dimension != 2 && dimension != 3) || n_cells < 0 || n_species < 0 ||
      n_pT < 0 || n_phi < 0 || n_nodes < 1)
    return cudaErrorInvalidValue;
  const int mode =
      dimension == 3 ? MODE_3D : (remap ? MODE_2D_REMAP : MODE_2D_FIXED);
  const int nr = mode == MODE_3D ? 1 : (mode == MODE_2D_FIXED ? n_nodes : 0);
  const size_t fixed = 2 * (size_t)n_nodes * sizeof(T);
  const size_t per_cell = (NF + NCOMP * (size_t)nr) * sizeof(T);
  if (fixed + per_cell > SMEM_BUDGET) return cudaErrorInvalidValue;
  int tile_c = (int)((SMEM_BUDGET - fixed) / per_cell);
  if (tile_c > MAX_TILE) tile_c = MAX_TILE;
  const size_t smem = fixed + (size_t)tile_c * per_cell;
  const long long n_points = (long long)n_species * n_pT * n_phi;
  if (n_points == 0) return cudaSuccess;
  if (n_points > 0x7fffffffLL - BLOCK) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n_points + BLOCK - 1) / BLOCK),
                  mode == MODE_3D ? n_nodes : 1);
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
#define IS3D_LAUNCH(MODE_, DF_)                                              \
  launch_one<T, MODE_, DF_>(grid, smem, stream, cells, n_cells, mass, sign,  \
                            baryon, deg, n_species, pT, px, py, n_pT, n_phi, \
                            nodes, weights, n_nodes, tile_c, regulate,       \
                            outflow, (T)prefactor, (T)t_ref, out)
  if (mode == MODE_3D) {
    if (df_mode == 1) IS3D_LAUNCH(MODE_3D, 1); else IS3D_LAUNCH(MODE_3D, 2);
  } else if (mode == MODE_2D_FIXED) {
    if (df_mode == 1) IS3D_LAUNCH(MODE_2D_FIXED, 1);
    else IS3D_LAUNCH(MODE_2D_FIXED, 2);
  } else {
    if (df_mode == 1) IS3D_LAUNCH(MODE_2D_REMAP, 1);
    else IS3D_LAUNCH(MODE_2D_REMAP, 2);
  }
#undef IS3D_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int is3d_smooth_spectra_f32(const void* cells, int n_cells, int nf,
                            const void* mass, const void* sign,
                            const void* baryon, const void* deg,
                            int n_species, const void* pT, const void* px,
                            const void* py, int n_pT, int n_phi,
                            const void* nodes, const void* weights,
                            int n_nodes, int df_mode, int dimension,
                            int remap, int regulate, int outflow,
                            double prefactor, double t_ref, void* out,
                            void* stream) {
  return launch<float>(cells, n_cells, nf, mass, sign, baryon, deg, n_species,
                       pT, px, py, n_pT, n_phi, nodes, weights, n_nodes,
                       df_mode, dimension, remap, regulate, outflow,
                       prefactor, t_ref, out, stream);
}

int is3d_smooth_spectra_f64(const void* cells, int n_cells, int nf,
                            const void* mass, const void* sign,
                            const void* baryon, const void* deg,
                            int n_species, const void* pT, const void* px,
                            const void* py, int n_pT, int n_phi,
                            const void* nodes, const void* weights,
                            int n_nodes, int df_mode, int dimension,
                            int remap, int regulate, int outflow,
                            double prefactor, double t_ref, void* out,
                            void* stream) {
  return launch<double>(cells, n_cells, nf, mass, sign, baryon, deg,
                        n_species, pT, px, py, n_pT, n_phi, nodes, weights,
                        n_nodes, df_mode, dimension, remap, regulate, outflow,
                        prefactor, t_ref, out, stream);
}

const char* is3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
