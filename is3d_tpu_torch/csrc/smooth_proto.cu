// The spectra prototype (df 2, 3+1D, regulate and outflow fixed on) for
// Hopper (sm_90a), float32 and float64.
//
// Replaces the Pallas kernel experiments/pallas_smooth_proto.py::kernel
// (launched by pallas_spectra, P1), the earlier prototype of the spectra
// kernel, with the prototype's own inputs and output: 34 packed fields in
// the prototype's order (`PField`), the temperature T itself (not 1/T),
// dan/tau formed in the kernel, a mask column (a validity weight >= 0),
// the momentum composites read from the caller's (S, M) tables, and the
// output laid out as the Pallas grid wrote it, (S / s_tile, Y, s_tile, M).
// Driven by is3d_tpu_torch/experiments/smooth_proto.py.
//
// Inputs: cells (n_cells, 34); mTf, mT2, mTpx, mTpy (S, M) momentum
// composites; pxf, pyf (M); m2, sign, bary (S); yg (Y).
//
// What bounds it on this card: SFU issue.  Every evaluation (cell,
// rapidity, species, point) needs an exp and two reciprocals besides 19
// FP32 operations (kernels/smooth.py, FORMULA_OPS), and the SFU pipe has
// an eighth of the FP32 lanes; the 4.5 MB of cells stay in L2.  The first
// version of this kernel (a thread per (species, point), blockIdx.y the
// rapidity, three IEEE divisions and an expf per evaluation, the per-
// (cell, point) terms redone for each rapidity and species) took 6.4x the
// bound.
//
// Design: that of smooth_spectra.cu's 3+1D path, on the prototype's
// inputs.
//   * Register blocking: a thread owns one momentum point for J species
//     and YC rapidities, so the per-(cell, point) terms W1, W2, C4, D2 are
//     formed once for J x YC evaluations and the composites of a (cell,
//     rapidity) loaded once for J.
//   * Staging: a tile of TILE cells is copied to shared memory and re-laid
//     cell-major with compile-time strides, NS folded scalars and NK
//     composites per (cell, rapidity), read as 16-byte loads.  Folded in
//     once per cell: log2(e)/T (one IEEE division at staging), sc into pi,
//     ibV into V, bulkPi into the b coefficients, the mask into the
//     surface-normal terms (a masked cell has p.dsigma = 0 and adds
//     exactly 0).
//   * float32 takes ex2.approx on the pre-scaled argument and rcp.approx
//     (folded.cuh); float64 keeps IEEE exp and division.
//   * The blocks are uniform in work: the wrapper splits the cells so the
//     card's waves fill (experiments/smooth_proto.py), and fold_kernel
//     adds the splits' partials in order.  No atomics: two launches give
//     identical bits.

#include <cuda_runtime.h>

#include "folded.cuh"

namespace {

using namespace is3d;

// must match FIELDS in is3d_tpu_torch/experiments/smooth_proto.py
enum PField {
  P_TAU, P_DAT, P_DAX, P_DAY, P_DAN, P_UT, P_UX, P_UY, P_UN, P_T, P_ALPHAB,
  P_PITT, P_PITX, P_PITY, P_PITN, P_PIXX, P_PIXY, P_PIXN, P_PIYY, P_PIYN,
  P_PINN, P_VT, P_VX, P_VY, P_VN, P_BENTH, P_BULKPI, P_ETA, P_SC, P_B0,
  P_B1, P_B2, P_IBV, P_MASK, PNF
};

constexpr int BLOCK = 128;         // momentum points per block
constexpr int J = 4;               // species per thread
constexpr int YC = 3;              // rapidities per thread
constexpr int TILE = 32;           // cells per shared-memory tile

// the NS folded scalars (folded.cuh, df 2) of one cell from its row g
template <typename T>
__device__ __forceinline__ void stage_proto_scalars(const T* g, T* o) {
  const T L = Fn<T>::SCALE;
  const T sc = g[P_SC], bp = g[P_BULKPI], ibv = g[P_IBV], mask = g[P_MASK];
  o[S_DAX] = g[P_DAX] * mask;
  o[S_DAY] = g[P_DAY] * mask;
  o[S_NUX] = -g[P_UX];
  o[S_NUY] = -g[P_UY];
  o[S_PXX] = sc * g[P_PIXX];
  o[S_PYY] = sc * g[P_PIYY];
  o[S_PXY] = T(2) * sc * g[P_PIXY];
  o[S_INVT] = L / g[P_T];
  o[S_NVX] = -ibv * g[P_VX];
  o[S_NVY] = -ibv * g[P_VY];
  o[S_ALPHA] = L * g[P_ALPHAB];
  o[S_KP] = (g[P_B0] + g[P_B2]) * bp;
  o[S_KB1] = g[P_B1] * bp;
  o[S_KM2] = -g[P_B2] * bp;
  o[S_KV] = g[P_BENTH];
  o[S_KC3] = T(0);
}

// the NK composites of one (cell, rapidity yv): A1 mask, B1, sc C1-C3,
// ibV D1, 0, 0
template <typename T>
__device__ __forceinline__ void stage_proto_composites(const T* g, T yv,
                                                       T* o) {
  const T ep = d_exp(yv - g[P_ETA]);
  const T em = T(1) / ep;
  const T ch = T(0.5) * (ep + em);
  const T sh = T(0.5) * (ep - em);
  const T tau = g[P_TAU];
  const T t_sh = sh * tau;
  const T sc = g[P_SC];
  o[0] = (ch * g[P_DAT] + sh * (g[P_DAN] / tau)) * g[P_MASK];
  o[1] = ch * g[P_UT] - sh * (tau * g[P_UN]);
  o[2] = sc * (ch * ch * g[P_PITT] + t_sh * t_sh * g[P_PINN]
               - T(2) * ch * t_sh * g[P_PITN]);
  o[3] = sc * (T(-2) * (ch * g[P_PITX] - t_sh * g[P_PIXN]));
  o[4] = sc * (T(-2) * (ch * g[P_PITY] - t_sh * g[P_PIYN]));
  o[5] = g[P_IBV] * (ch * g[P_VT] - t_sh * g[P_VN]);
  o[6] = T(0);
  o[7] = T(0);
}

// grid (point blocks, species groups of J, n_split x rapidity groups of
// YC); dst: out, or the (n_split, |out|) partials
template <typename T>
__global__ void __launch_bounds__(BLOCK, 16 / sizeof(T))
proto_kernel(const T* __restrict__ cells, int n_cells, int cells_per_split,
             const T* __restrict__ mTf, const T* __restrict__ mT2f,
             const T* __restrict__ mTpxf, const T* __restrict__ mTpyf,
             const T* __restrict__ pxf, const T* __restrict__ pyf,
             const T* __restrict__ m2f, const T* __restrict__ sign,
             const T* __restrict__ bary, const T* __restrict__ yg,
             int n_species, int M, int n_y, int s_tile, T* __restrict__ dst) {
  using F = Fn<T>;
  __shared__ __align__(16) T scal[TILE * NS];
  __shared__ __align__(16) T comp[TILE * YC * NK];
  __shared__ T raw[TILE * PNF];

  const int tid = threadIdx.x;
  const int nz = (n_y + YC - 1) / YC;
  const int split = blockIdx.z / nz;
  const int rbeg = (blockIdx.z - split * nz) * YC;
  const int cbeg = split * cells_per_split;
  const int cend = min(n_cells, cbeg + cells_per_split);
  const int m = blockIdx.x * BLOCK + tid;
  const int s0 = blockIdx.y * J;

  // the thread's point for its J species (ragged edges clamped to a real
  // point and species, never stored)
  const int mc = min(m, M - 1);
  const T pxv = pxf[mc], pyv = pyf[mc];
  const T px2 = pxv * pxv, py2 = pyv * pyv, pxpy = pxv * pyv;
  T mT[J], mT2[J], mTpx[J], mTpy[J], m2[J], sgn[J], bar[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int s = min(s0 + j, n_species - 1);
    const size_t i = (size_t)s * M + mc;
    mT[j] = mTf[i];
    mT2[j] = mT2f[i];
    mTpx[j] = mTpxf[i];
    mTpy[j] = mTpyf[i];
    m2[j] = m2f[s];
    sgn[j] = sign[s];
    bar[j] = bary[s];
  }

  T acc[J][YC];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int y = 0; y < YC; ++y) acc[j][y] = T(0);

  for (int c0 = cbeg; c0 < cend; c0 += TILE) {
    const int nc = min(TILE, cend - c0);
    __syncthreads();                                 // previous tile consumed
    for (int i = tid; i < nc * PNF; i += BLOCK)
      raw[i] = cells[(size_t)c0 * PNF + i];
    __syncthreads();
    for (int c = tid; c < nc; c += BLOCK)
      stage_proto_scalars<T>(raw + c * PNF, scal + c * NS);
    for (int i = tid; i < nc * YC; i += BLOCK) {
      const int c = i / YC;
      const int y = i - c * YC;
      stage_proto_composites<T>(raw + c * PNF, yg[min(rbeg + y, n_y - 1)],
                                comp + i * NK);
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
      T c4s[J], b1[J], nbal[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        c4s[j] = fma(km2, m2[j], C4);
        b1[j] = kb1 * bar[j];
        nbal[j] = -alpha * bar[j];
      }
      const T* kc = comp + c * YC * NK;
#pragma unroll
      for (int y = 0; y < YC; ++y) {
        T A1, B1, C1, C2, C3, D1, u0, u1;
        F::ld4(kc + y * NK, A1, B1, C1, C2);
        F::ld4(kc + y * NK + 4, C3, D1, u0, u1);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const T pds = fma(mT[j], A1, W1);
          const T pdu = fma(mT[j], B1, nW2);
          const T pipp =
              fma(mT2[j], C1, fma(mTpx[j], C2, fma(mTpy[j], C3, c4s[j])));
          const T Vp = fma(mT[j], D1, nD2);
          const T f = folded_f<T, 2>(pdu, pipp, Vp, invT, nbal[j], sgn[j],
                                     bar[j], kp, b1[j], kv, kc3, T(-1), T(1));
          acc[j][y] = fma(fmax(pds, T(0)), f, acc[j][y]);
        }
      }
    }
  }
  if (m >= M) return;
  T* o = dst + (size_t)split * n_species * M * (size_t)n_y;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int s = s0 + j;
    if (s >= n_species) continue;
    const int st = s / s_tile;
    const int si = s - st * s_tile;
#pragma unroll
    for (int y = 0; y < YC; ++y)
      if (rbeg + y < n_y)
        o[(((size_t)st * n_y + rbeg + y) * s_tile + si) * M + m] = acc[j][y];
  }
}

// out[i] = sum over splits (in order) of partial
template <typename T>
__global__ void __launch_bounds__(256)
fold_kernel(const T* __restrict__ partial, int n_split, long long n,
            T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  T v = T(0);
  for (int k = 0; k < n_split; ++k) v += partial[k * n + i];
  out[i] = v;
}

long long blocks_per_split(int n_species, int M, int n_y) {
  return (long long)((M + BLOCK - 1) / BLOCK) * ((n_species + J - 1) / J) *
         ((n_y + YC - 1) / YC);
}

// resident blocks of proto_kernel<T> on the current card, or minus a CUDA
// error code
template <typename T>
int slots() {
  int dev = 0, n_sm = 0, per_sm = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc == 0)
    rc = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                     dev);
  if (rc == 0)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, proto_kernel<T>, BLOCK, 0);
  if (rc != 0) return -rc;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  return n_sm * per_sm;
}

template <typename T>
int launch(const void* cells, int n_cells, int nf, const void* mTf,
           const void* mT2, const void* mTpx, const void* mTpy,
           const void* pxf, const void* pyf, const void* m2, const void* sign,
           const void* bary, const void* yg, int n_species, int M, int n_y,
           int s_tile, int cells_per_split, void* partial_v, void* out_v,
           void* stream_v) {
  if (nf != PNF || n_cells < 0 || n_species < 1 || M < 1 || n_y < 1 ||
      s_tile < 1 || n_species % s_tile != 0 || cells_per_split < 1)
    return cudaErrorInvalidValue;
  const long long n_split =
      n_cells == 0 ? 1
                   : ((long long)n_cells + cells_per_split - 1) /
                         cells_per_split;
  const long long nz = (n_y + YC - 1) / YC;
  if (nz * n_split > 65535 || (n_species + J - 1) / J > 65535 ||
      (n_split > 1 && partial_v == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  T* out = static_cast<T*>(out_v);
  const dim3 grid((unsigned)((M + BLOCK - 1) / BLOCK),
                  (unsigned)((n_species + J - 1) / J),
                  (unsigned)(nz * n_split));
  proto_kernel<T><<<grid, BLOCK, 0, stream>>>(
      static_cast<const T*>(cells), n_cells, cells_per_split,
      static_cast<const T*>(mTf), static_cast<const T*>(mT2),
      static_cast<const T*>(mTpx), static_cast<const T*>(mTpy),
      static_cast<const T*>(pxf), static_cast<const T*>(pyf),
      static_cast<const T*>(m2), static_cast<const T*>(sign),
      static_cast<const T*>(bary), static_cast<const T*>(yg), n_species, M,
      n_y, s_tile, n_split == 1 ? out : static_cast<T*>(partial_v));
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || n_split == 1) return rc;
  const long long n = (long long)n_species * M * n_y;
  fold_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(partial_v), (int)n_split, n, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define IS3D_PROTO_ENTRY(NAME, T)                                             \
  int NAME(const void* cells, int n_cells, int nf, const void* mTf,          \
           const void* mT2, const void* mTpx, const void* mTpy,              \
           const void* pxf, const void* pyf, const void* m2,                 \
           const void* sign, const void* bary, const void* yg,               \
           int n_species, int M, int n_y, int s_tile, int cells_per_split,   \
           void* partial, void* out, void* stream) {                         \
    return launch<T>(cells, n_cells, nf, mTf, mT2, mTpx, mTpy, pxf, pyf, m2, \
                     sign, bary, yg, n_species, M, n_y, s_tile,              \
                     cells_per_split, partial, out, stream);                 \
  }
IS3D_PROTO_ENTRY(is3d_smooth_proto_f32, float)
IS3D_PROTO_ENTRY(is3d_smooth_proto_f64, double)
#undef IS3D_PROTO_ENTRY

// resident blocks of the kernel on the current card, or minus a CUDA
// error code; and the blocks of one split of a launch of this shape
int is3d_smooth_proto_slots_f32() { return slots<float>(); }
int is3d_smooth_proto_slots_f64() { return slots<double>(); }
long long is3d_smooth_proto_blocks(int n_species, int M, int n_y) {
  return blocks_per_split(n_species, M, n_y);
}

const char* is3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
