// The sampler's phase-A densities (K7b) for Hopper (sm_90a), float32 and
// float64: dn[c, s], the per-(cell, species) mean densities the cell and
// species draws come from, by 32-point Gauss-Laguerre quadrature.
//
// yields_kernel<T, MODE> replaces is3d_tpu/kernels/sample.py:
// _species_yields_exact_block (:278, run in cell chunks by
// _species_yields_exact :222) and _species_yields_vah (:484), which XLA
// runs as a (cells x species x nodes) elementwise block and a sum:
//   MODE kDf12: 2 neq(T, alpha_B)                           (df 1-2)
//   MODE kDf3:  neq + bulkPi (neq + b J10 G + J20 F / T^2) / betabulk,
//               or 2 neq on a broken-down cell               (df 3)
//   MODE kDf4:  z neq(T, 0), or 2 neq on a broken-down cell  (df 4)
//   MODE kVah:  2 a_L neq(Lambda, 0)                         (modes 2-3)
// with neq = T^3 / (2 pi^2 hbarc^3) g sum_k w_k p_k f(p_k) over the
// alpha = 1 nodes (J20 over the alpha = 2 nodes), in the overflow-safe
// forms of physics/thermal.py (every exp of a non-positive argument:
// e^p f = e^{p - x} / (1 + sign e^{-x}), x = Ebar - chem; a naive e^p is
// inf in float32 at the largest roots, ~114).  In the same launch it
// clamps each density at 0, zeroes the massless species (neither can be
// drawn) and writes each cell's row sum, the cell draw's weight before its
// dsigma factor (kernels/sample.py:cell_data).  With out = null it writes
// the row sums alone: the cell-chunked sampler's scalar pre-pass.
//
// A warp takes a cell (its scalars broadcast, its branch warp-uniform), a
// lane the species lane, lane + 32, ...: the row's stores coalesce, and
// the row sum is each lane's sum in species order folded by a fixed
// shuffle tree, so two launches give identical bits.  The nodes, weights
// and species columns sit in shared memory, read by the whole warp at
// once.  What bounds it on this card: ~4 special functions an evaluation
// (two exps, a square root, a division) over the SFU lanes
// (kernels/sample.py:yields_formula_ops); its output, one (C, S) table,
// is ~20x below that in bytes.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;

enum Mode { kDf12 = 0, kDf3 = 1, kDf4 = 2, kVah = 3 };

// the per-cell columns of each mode, rows of the (ncol, C) input
enum VhCol { cT, cAlphaB, cBulkPi, cBreakdown, cF, cG, cZ, cBetabulk,
             kVhCols };
enum VahCol { cLambda, cAL, kVahCols };

// e^p f_eq and e^p f_eq f_eqbar at Ebar = sqrt(p^2 + mbar^2), overflow-safe
// (physics/thermal.py: _feq_w, _ff_w)
template <typename T>
__device__ __forceinline__ T feq_w(T p, T mbar2, T chem, T sign) {
  const T x = sqrt(p * p + mbar2) - chem;
  return exp(p - x) / (T(1) + sign * exp(-x));
}
template <typename T>
__device__ __forceinline__ T ff_w(T p, T Ebar, T chem, T sign) {
  const T x = Ebar - chem;
  const T d = T(1) + sign * exp(-x);
  return exp(p - x) / (d * d);
}

// sum_k w_k p_k e^p f_eq over the alpha = 1 nodes: neq's quadrature
template <typename T>
__device__ __forceinline__ T neq_sum(const T* r, const T* w, int Q, T mbar2,
                                     T chem, T sign) {
  T acc = T(0);
  for (int k = 0; k < Q; ++k)
    acc += w[k] * (r[k] * feq_w(r[k], mbar2, chem, sign));
  return acc;
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    yields_kernel(const T* cells, int C, const T* species, int S,
                  const T* lag, int Q, int include_baryon, T inv_norm,
                  T* out, T* sums) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  // species columns mass, sign, degeneracy, baryon; nodes r1, w1, r2, w2
  T* s_mass = sm;
  T* s_sign = sm + S;
  T* s_deg = sm + 2 * S;
  T* s_bar = sm + 3 * S;
  T* r1 = sm + 4 * S;
  T* w1 = r1 + Q;
  T* r2 = r1 + 2 * Q;
  T* w2 = r1 + 3 * Q;
  for (int i = threadIdx.x; i < 4 * S; i += kThreads) sm[i] = species[i];
  for (int i = threadIdx.x; i < 4 * Q; i += kThreads) r1[i] = lag[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int c = blockIdx.x * kWarps + (threadIdx.x >> 5); c < C;
       c += gridDim.x * kWarps) {
    T Tc, alphaB = T(0), bulkPi = T(0), F = T(0), G = T(0), z = T(0);
    T betabulk = T(1), aL = T(1);
    bool broken = false;
    if constexpr (MODE == kVah) {
      Tc = __ldg(cells + static_cast<size_t>(cLambda) * C + c);
      aL = __ldg(cells + static_cast<size_t>(cAL) * C + c);
    } else {
      Tc = __ldg(cells + static_cast<size_t>(cT) * C + c);
      alphaB = __ldg(cells + static_cast<size_t>(cAlphaB) * C + c);
      if constexpr (MODE == kDf3 || MODE == kDf4)
        broken = __ldg(cells + static_cast<size_t>(cBreakdown) * C + c)
            > T(0.5);
      if constexpr (MODE == kDf3) {
        bulkPi = __ldg(cells + static_cast<size_t>(cBulkPi) * C + c);
        F = __ldg(cells + static_cast<size_t>(cF) * C + c);
        G = __ldg(cells + static_cast<size_t>(cG) * C + c);
        betabulk = __ldg(cells + static_cast<size_t>(cBetabulk) * C + c);
      }
      if constexpr (MODE == kDf4)
        z = __ldg(cells + static_cast<size_t>(cZ) * C + c);
    }
    const T neq_fact = Tc * Tc * Tc * inv_norm;
    T row = T(0);
    for (int s = lane; s < S; s += 32) {
      const T mass = s_mass[s], sign = s_sign[s], deg = s_deg[s];
      const T mbar = mass / Tc, mbar2 = mbar * mbar;
      T v;
      if constexpr (MODE == kVah) {
        v = T(2) * aL * (neq_fact * deg * neq_sum(r1, w1, Q, mbar2, T(0),
                                                  sign));
      } else {
        const T baryon = s_bar[s];
        const T chem = baryon * alphaB;
        if (MODE == kDf12 || broken) {
          v = T(2) * (neq_fact * deg * neq_sum(r1, w1, Q, mbar2, chem, sign));
        } else if constexpr (MODE == kDf4) {
          v = z * (neq_fact * deg * neq_sum(r1, w1, Q, mbar2, T(0), sign));
        } else {
          // df 3: neq, J10 (alpha = 1) and J20 (alpha = 2) at (T, chem)
          T a_neq = T(0), a_j10 = T(0), a_j20 = T(0);
          for (int k = 0; k < Q; ++k) {
            const T p = r1[k];
            const T Eb = sqrt(p * p + mbar2);
            const T x = Eb - chem;
            const T e = exp(-x);
            const T num = exp(p - x);
            const T d = T(1) + sign * e;
            a_neq += w1[k] * (p * (num / d));
            if (include_baryon) a_j10 += w1[k] * (p * (num / (d * d)));
            const T p2 = r2[k];
            const T E2 = sqrt(p2 * p2 + mbar2);
            a_j20 += w2[k] * (E2 * ff_w(p2, E2, chem, sign));
          }
          const T neq = neq_fact * deg * a_neq;
          const T J10 = include_baryon ? neq_fact * deg * a_j10 : T(0);
          const T J20 = Tc * neq_fact * deg * a_j20;
          const T bulk_density =
              (neq + baryon * J10 * G + J20 * (F / (Tc * Tc))) / betabulk;
          v = neq + bulkPi * bulk_density;
        }
      }
      v = v < T(0) ? T(0) : v;          // a NaN stays NaN, as torch.clamp
      if (!(mass > T(0))) v = T(0);
      if (out) out[static_cast<size_t>(c) * S + s] = v;
      row += v;
    }
#pragma unroll
    for (int d = 16; d > 0; d /= 2) row += __shfl_xor_sync(kFull, row, d);
    if (lane == 0) sums[c] = row;
  }
}

template <typename T, int MODE>
int launch_yields(const void* cells, int C, const void* species, int S,
                  const void* lag, int Q, int include_baryon,
                  double inv_norm, void* out, void* sums,
                  cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(4 * S + 4 * Q) * sizeof(T);
  if (bytes > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        yields_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, yields_kernel<T, MODE>, kThreads, bytes);
  if (err != cudaSuccess) return err;
  const long long need = (static_cast<long long>(C) + kWarps - 1) / kWarps;
  const long long have = static_cast<long long>(n_sm) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(need < have ? need : have);
  if (blocks > 0)
    yields_kernel<T, MODE><<<blocks, kThreads, bytes, stream>>>(
        static_cast<const T*>(cells), C, static_cast<const T*>(species), S,
        static_cast<const T*>(lag), Q, include_baryon,
        static_cast<T>(inv_norm), static_cast<T*>(out),
        static_cast<T*>(sums));
  return cudaGetLastError();
}

template <typename T>
int yields(const void* cells, int C, const void* species, int S,
           const void* lag, int Q, int mode, int include_baryon,
           double inv_norm, void* out, void* sums, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kDf12:
      return launch_yields<T, kDf12>(cells, C, species, S, lag, Q,
                                     include_baryon, inv_norm, out, sums, s);
    case kDf3:
      return launch_yields<T, kDf3>(cells, C, species, S, lag, Q,
                                    include_baryon, inv_norm, out, sums, s);
    case kDf4:
      return launch_yields<T, kDf4>(cells, C, species, S, lag, Q,
                                    include_baryon, inv_norm, out, sums, s);
    case kVah:
      return launch_yields<T, kVah>(cells, C, species, S, lag, Q,
                                    include_baryon, inv_norm, out, sums, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K7b: the densities (C, S) into out (null: the row sums alone) and their
// row sums (C,) into sums.  cells: (ncol, C) per-cell columns, the mode's
// (VhCol or VahCol); species: (4, S) mass, sign, degeneracy, baryon; lag:
// (4, Q) the alpha = 1 and alpha = 2 nodes and weights; mode 0-3 (Mode);
// inv_norm = 1 / (2 pi^2 hbarc^3)
int is3d_species_yields_f32(const void* cells, int C, const void* species,
                            int S, const void* lag, int Q, int mode,
                            int include_baryon, double inv_norm, void* out,
                            void* sums, void* stream) {
  return yields<float>(cells, C, species, S, lag, Q, mode, include_baryon,
                       inv_norm, out, sums, stream);
}
int is3d_species_yields_f64(const void* cells, int C, const void* species,
                            int S, const void* lag, int Q, int mode,
                            int include_baryon, double inv_norm, void* out,
                            void* sums, void* stream) {
  return yields<double>(cells, C, species, S, lag, Q, mode, include_baryon,
                        inv_norm, out, sums, stream);
}

const char* is3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
