// The Monte-Carlo sampler's Walker-alias tables (K7a) and the event batch
// (K7, csrc/sample.cuh) on viscous-hydro surfaces with alias draws, for
// Hopper (sm_90a), float32 and float64.
//
// K7a, alias_kernel, replaces is3d_tpu/kernels/sample.py:_alias_build
// (:92), a K-step fori_loop of scatters over all rows, with its argsort.
// A block stages P rows of scaled weights (kernels/sample.py:alias_scale)
// in shared memory with cp.async, transposed so that lane l's element k
// sits at k (P + 1) + l; its warps sort the rows descending, ties by
// original index (`warp_sort`, a bitonic network: what torch's stable sort
// gives); lane l of the first warp runs the two-pointer Vose pass over row
// l (`vose_pass`: the running donor in a register, the other entries read
// once each from the two ends) and writes prob / alias at the original
// slots in shared memory, and the block stores the interleaved (prob,
// alias) pairs coalesced.  The same operations in the same order as the
// plain version (kernels/sample.py:alias_tables_plain after alias_sort):
// identical tables.  P is chosen for the most rows in flight an SM; rows
// too long for shared memory (a cell-group row of more than ~7000 blocks)
// are sorted by torch and take alias_global_kernel, a thread a row in
// device memory.  What bounds it on this card: the bytes it moves
// (kernels/sample.py:alias_formula_bytes) and the K-step dependent chain
// of each row, which the rows in flight hide.
//
// K7 (event_kernel, its design in csrc/sample.cuh) is instantiated here
// for df 1-4 with alias draws; sample_vah.cu, sample_search.cu and
// sample_vah_search.cu instantiate the rest, one library each.

#include <cuda_pipeline.h>

#include "sample.cuh"

namespace {

constexpr int kMaxSmem = 232448;              // a block's shared memory

__device__ __forceinline__ void store_pair(void* t, size_t o, float p,
                                           int a) {
  static_cast<int2*>(t)[o] = make_int2(__float_as_int(p), a);
}
__device__ __forceinline__ void store_pair(void* t, size_t o, double p,
                                           int a) {
  static_cast<int4*>(t)[o] = make_int4(__double2loint(p), __double2hiint(p),
                                       a, 0);
}

// the two-pointer Vose pass of one row sorted descending: q and o its
// weights and original indices at stride st; store(m, prob, alias) puts
// the finalized slot m.  Step by step the operations of
// kernels/sample.py:alias_tables_plain: the donor i when it has dropped
// below 1, else the smallest untouched entry j against it; the donor's
// running weight stays in a register, and every other entry is read once,
// from the front or the back
template <typename T, typename Store>
__device__ __forceinline__ void vose_pass(const T* q, const int* o, int st,
                                          int K, Store store) {
  T qi = q[0];
  int oi = o[0];
  if (K > 1) {
    int i = 0, j = K - 1;
    T qj = q[j * st], qn = q[st];
    int oj = o[j * st], on = o[st];
    for (int step = 1; step < K; ++step) {
      if (qi < T(1)) {
        store(oi, clampT(qi, T(0), T(1)), on);
        qi = qn - (T(1) - qi);
        oi = on;
        ++i;
        const int nx = min(i + 1, K - 1) * st;
        qn = q[nx];
        on = o[nx];
      } else {
        store(oj, clampT(qj, T(0), T(1)), oi);
        qi = qi - (T(1) - qj);
        --j;
        qj = q[j * st];
        oj = o[j * st];
      }
    }
  }
  store(oi, T(1), oi);
}

// the order of the Vose pass's input (kernels/sample.py:alias_sort,
// torch.sort(-q, stable=True)): the larger weight first, ties by original
// index
template <typename T>
__device__ __forceinline__ bool before(T qa, int ia, T qb, int ib) {
  return qa > qb || (qa == qb && ia < ib);
}

// sort a row's n (weight, original index) entries at stride st in place
// by `before`, one warp: the bitonic network in its all-ascending form (a
// merge's first comparators mirror the two halves), so a comparator whose
// partner lies past n never swaps, as if the missing entries sorted last,
// and n need not be a power of 2.  `before` is a strict total order, so
// the result is the one stable sort gives
template <typename T>
__device__ void warp_sort(T* q, int* o, int st, int n, int lane) {
  int N = 1;
  while (N < n) N <<= 1;
  for (int k = 2; k <= N; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = lane; t < N / 2; t += 32) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int l = j == k >> 1 ? i ^ (k - 1) : i + j;
        if (l < n) {
          const T qi = q[i * st], ql = q[l * st];
          const int oi = o[i * st], ol = o[l * st];
          if (before(ql, ol, qi, oi)) {
            q[i * st] = ql;
            q[l * st] = qi;
            o[i * st] = ol;
            o[l * st] = oi;
          }
        }
      }
      __syncwarp();
    }
  }
}

// K7a's block: sixteen warps (a row's sort a warp; 4 and 8 were slower
// on the card), P rows; element k of the block's row r at k (P + 1) + r
// in each of q, o, prob and alias
constexpr int kAliasThreads = 512;

template <typename T>
size_t alias_smem(int K, int P) {
  return static_cast<size_t>(K) * (P + 1) * 2 * (sizeof(T) + 4);
}

template <typename T>
__global__ void __launch_bounds__(kAliasThreads)
    alias_kernel(const T* q0, int R, int K, int P, void* pairs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = P + 1;
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sp = sq + static_cast<size_t>(K) * S;
  int* so = reinterpret_cast<int*>(sp + static_cast<size_t>(K) * S);
  int* sa = so + static_cast<size_t>(K) * S;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * P;
  const int rows = min(P, R - r0);
  const int n = rows * K;
  const size_t base = static_cast<size_t>(r0) * K;
  // every copy in flight at once (cp.async), each to its transposed place
  for (int x = tid; x < n; x += kAliasThreads) {
    const int r = x / K, k = x - r * K;
    __pipeline_memcpy_async(sq + k * S + r, q0 + base + x, sizeof(T));
    so[k * S + r] = k;
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int r = tid / 32; r < rows; r += kAliasThreads / 32)
    warp_sort(sq + r, so + r, S, K, tid & 31);
  __syncthreads();
  if (tid < rows)
    vose_pass(sq + tid, so + tid, S, K, [&](int m, T p, int al) {
      sp[m * S + tid] = p;
      sa[m * S + tid] = al;
    });
  __syncthreads();
  for (int x = tid; x < n; x += kAliasThreads) {
    const int r = x / K, k = x - r * K;
    store_pair(pairs, base + x, sp[k * S + r], sa[k * S + r]);
  }
}

// rows too long for shared memory, sorted by torch (kernels/sample.py:
// alias_sort): a thread a row in device memory
template <typename T>
__global__ void __launch_bounds__(128)
    alias_global_kernel(const T* qs, const int* order, int R, int K,
                        void* pairs) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const size_t base = static_cast<size_t>(r) * K;
  vose_pass(qs + base, order + base, 1, K, [&](int m, T p, int al) {
    store_pair(pairs, base + m, p, al);
  });
}

// rows a block of alias_kernel: the most rows in flight an SM, the larger
// block on a tie; 0 where a row does not fit in shared memory
template <typename T>
int alias_rows_per_block(int K, cudaError_t* err) {
  static bool ready = false;
  *err = cudaSuccess;
  if (!ready) {
    *err = cudaFuncSetAttribute(alias_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kMaxSmem);
    if (*err != cudaSuccess) return 0;
    ready = true;
  }
  int best = 0, best_rows = 0;
  for (int P = 32; P >= 1; P -= (P > 2 ? 2 : 1)) {
    const size_t bytes = alias_smem<T>(K, P);
    if (bytes > static_cast<size_t>(kMaxSmem)) continue;
    int per_sm = 0;
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, alias_kernel<T>, kAliasThreads, bytes);
    if (*err != cudaSuccess) return 0;
    if (per_sm * P > best_rows) {
      best_rows = per_sm * P;
      best = P;
    }
  }
  return best;
}

template <typename T>
int alias_build(const void* q0, int R, int K, void* pairs, void* stream) {
  if (R < 1 || K < 1) return cudaSuccess;
  cudaError_t err;
  const int P = alias_rows_per_block<T>(K, &err);
  if (err != cudaSuccess) return err;
  if (P < 1) return cudaErrorInvalidValue;   // alias_build_sorted's rows
  alias_kernel<T><<<(R + P - 1) / P, kAliasThreads, alias_smem<T>(K, P),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q0), R, K, P, pairs);
  return cudaGetLastError();
}

template <typename T>
int alias_build_sorted(const void* qs, const void* order, int R, int K,
                       void* pairs, void* stream) {
  if (R < 1 || K < 1) return cudaSuccess;
  alias_global_kernel<T><<<(R + 127) / 128, 128, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qs), static_cast<const int*>(order), R, K, pairs);
  return cudaGetLastError();
}

}  // namespace

IS3D_SAMPLE_EVENT_ENTRIES(false, false)

extern "C" {

// K7a: the interleaved (prob, alias) pairs of R rows of K weights q0,
// each row scaled to mean 1 (kernels/sample.py:alias_scale), sorted in the
// kernel; rows too long for its shared memory are refused
int is3d_alias_build_f32(const void* q0, int R, int K, void* pairs,
                         void* stream) {
  return alias_build<float>(q0, R, K, pairs, stream);
}
int is3d_alias_build_f64(const void* q0, int R, int K, void* pairs,
                         void* stream) {
  return alias_build<double>(q0, R, K, pairs, stream);
}

// K7a on such rows, sorted descending (qs) with their original indices
int is3d_alias_build_sorted_f32(const void* qs, const void* order, int R,
                                int K, void* pairs, void* stream) {
  return alias_build_sorted<float>(qs, order, R, K, pairs, stream);
}
int is3d_alias_build_sorted_f64(const void* qs, const void* order, int R,
                                int K, void* pairs, void* stream) {
  return alias_build_sorted<double>(qs, order, R, K, pairs, stream);
}

// rows a block of K7a for rows of K entries (0: too long, the sorted
// entry's device-memory kernel), or minus a CUDA error code
int is3d_alias_rows_per_block(int K, int f64) {
  cudaError_t err;
  const int P = f64 ? alias_rows_per_block<double>(K, &err)
                    : alias_rows_per_block<float>(K, &err);
  return err == cudaSuccess ? P : -static_cast<int>(err);
}

}  // extern "C"
