// The spectra prototype (df 2, 3+1D, regulate and outflow fixed on) for
// Hopper (sm_90a), float32 and float64.
//
// Replaces the Pallas kernel experiments/pallas_smooth_proto.py::kernel
// (launched by pallas_spectra, P1), the earlier prototype of the spectra
// kernel, with the prototype's own inputs and math: 34 packed fields in
// the prototype's order (`PField`), the temperature T itself (not 1/T),
// dan/tau formed in the kernel, f = feq (1 + df), a mask column, and the
// output laid out as the Pallas grid wrote it, (S / s_tile, Y, s_tile, M).
// Driven by is3d_tpu_torch/experiments/smooth_proto.py.
//
// Inputs: cells (n_cells, 34); mTf, mT2, mTpx, mTpy (S, M) momentum
// composites; pxf, pyf (M); m2, sign, bary (S); yg (Y).
//
// Design.  As smooth_spectra.cu's 3+1D path: one thread per (species,
// momentum point), blockIdx.y the output rapidity, cells staged in
// shared-memory tiles with each cell's cosh/sinh composites computed once
// per block (one exp and one reciprocal per cell), and a per-thread
// accumulator over the cells in index order (no atomics, deterministic).
// What bounds it: operations -- per point ~40 fma, one exp and three IEEE
// divisions (1/(e^x + s), 1/(u.p) and u.p / T); the 4.5 MB of cells stay
// in L2.  The composites (emission.cuh's Comp) keep the node-dependent
// special functions out of the per-point chain.

#include <cuda_runtime.h>

#include "emission.cuh"

namespace {

using namespace is3d;

// must match FIELDS in is3d_tpu_torch/experiments/smooth_proto.py
enum PField {
  P_TAU, P_DAT, P_DAX, P_DAY, P_DAN, P_UT, P_UX, P_UY, P_UN, P_T, P_ALPHAB,
  P_PITT, P_PITX, P_PITY, P_PITN, P_PIXX, P_PIXY, P_PIXN, P_PIYY, P_PIYN,
  P_PINN, P_VT, P_VX, P_VY, P_VN, P_BENTH, P_BULKPI, P_ETA, P_SC, P_B0,
  P_B1, P_B2, P_IBV, P_MASK, PNF
};

constexpr int BLOCK = 256;         // points per block
constexpr int TILE = 64;           // cells per shared-memory tile

template <typename T>
__global__ void __launch_bounds__(BLOCK)
proto_kernel(const T* __restrict__ cells, int n_cells,
             const T* __restrict__ mTf, const T* __restrict__ mT2,
             const T* __restrict__ mTpx, const T* __restrict__ mTpy,
             const T* __restrict__ pxf, const T* __restrict__ pyf,
             const T* __restrict__ m2, const T* __restrict__ sign,
             const T* __restrict__ bary, const T* __restrict__ yg,
             int n_species, int M, int n_y, int s_tile, T* __restrict__ out) {
  __shared__ T raw[PNF * TILE];                     // [PNF][TILE]
  __shared__ Comp<T> comp[TILE];
  const int idx = blockIdx.x * BLOCK + threadIdx.x;
  const bool active = idx < n_species * M;
  const int iy = blockIdx.y;
  const T yv = yg[iy];

  const int s = active ? idx / M : 0;
  const int m = active ? idx - s * M : 0;
  const T mT = active ? mTf[idx] : T(0);
  const T mTT = active ? mT2[idx] : T(0);
  const T mTx = active ? mTpx[idx] : T(0);
  const T mTy = active ? mTpy[idx] : T(0);
  const T px = active ? pxf[m] : T(0);
  const T py = active ? pyf[m] : T(0);
  const T ms2 = active ? m2[s] : T(0);
  const T sg = active ? sign[s] : T(1);
  const T bs = active ? bary[s] : T(0);

  T acc = T(0);
  for (int c0 = 0; c0 < n_cells; c0 += TILE) {
    const int nc = min(TILE, n_cells - c0);
    __syncthreads();                                // previous tile consumed
    for (int i = threadIdx.x; i < nc * PNF; i += BLOCK) {
      const int c = i / PNF;
      raw[(i - c * PNF) * TILE + c] = cells[(size_t)c0 * PNF + i];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < nc; c += BLOCK) {
      const T* g = raw + c;                         // field f at g[f * TILE]
      const T ep = d_exp(yv - g[P_ETA * TILE]);
      const T em = T(1) / ep;
      const T ch = T(0.5) * (ep + em);
      const T sh = T(0.5) * (ep - em);
      const T tau = g[P_TAU * TILE];
      const T t_sh = sh * tau;
      Comp<T> k;
      k.A1 = ch * g[P_DAT * TILE] + sh * (g[P_DAN * TILE] / tau);
      k.B1 = ch * g[P_UT * TILE] - sh * (tau * g[P_UN * TILE]);
      k.C1 = ch * ch * g[P_PITT * TILE] + t_sh * t_sh * g[P_PINN * TILE]
             - T(2) * ch * t_sh * g[P_PITN * TILE];
      k.C2 = T(-2) * (ch * g[P_PITX * TILE] - t_sh * g[P_PIXN * TILE]);
      k.C3 = T(-2) * (ch * g[P_PITY * TILE] - t_sh * g[P_PIYN * TILE]);
      k.D1 = ch * g[P_VT * TILE] - t_sh * g[P_VN * TILE];
      comp[c] = k;
    }
    __syncthreads();
    if (!active) continue;
    for (int c = 0; c < nc; ++c) {
      const T* g = raw + c;
      const Comp<T> k = comp[c];
      const T W1 = g[P_DAX * TILE] * px + g[P_DAY * TILE] * py;
      const T W2 = g[P_UX * TILE] * px + g[P_UY * TILE] * py;
      const T C4 = g[P_PIXX * TILE] * px * px + g[P_PIYY * TILE] * py * py
                   + T(2) * g[P_PIXY * TILE] * px * py;
      const T D2 = g[P_VX * TILE] * px + g[P_VY * TILE] * py;
      const T pds = mT * k.A1 + W1;
      const T pdotu = mT * k.B1 - W2;
      const T pipp = mTT * k.C1 + mTx * k.C2 + mTy * k.C3 + C4;
      const T Vp = mT * k.D1 - D2;
      const T chem = bs * g[P_ALPHAB * TILE];
      const T feq = T(1) / (d_exp(pdotu / g[P_T * TILE] - chem) + sg);
      const T feqbar = T(1) - sg * feq;
      const T r = T(1) / pdotu;
      T df = feqbar * (g[P_SC * TILE] * pipp * r
                       + (g[P_B0 * TILE] * pdotu + g[P_B1 * TILE] * bs
                          + g[P_B2 * TILE] * (pdotu - ms2 * r))
                         * g[P_BULKPI * TILE]
                       + (g[P_BENTH * TILE] - bs * r) * Vp * g[P_IBV * TILE]);
      df = df < T(-1) ? T(-1) : (df > T(1) ? T(1) : df);
      const T f = feq * (T(1) + df);
      acc += (pds > T(0) ? pds * f : T(0)) * g[P_MASK * TILE];
    }
  }
  if (active) {
    const int st = s / s_tile;
    const int si = s - st * s_tile;
    out[(((size_t)st * n_y + iy) * s_tile + si) * M + m] = acc;
  }
}

template <typename T>
int launch(const void* cells, int n_cells, int nf, const void* mTf,
           const void* mT2, const void* mTpx, const void* mTpy,
           const void* pxf, const void* pyf, const void* m2, const void* sign,
           const void* bary, const void* yg, int n_species, int M, int n_y,
           int s_tile, void* out, void* stream) {
  if (nf != PNF || n_cells < 0 || n_species < 1 || M < 1 || n_y < 1 ||
      s_tile < 1 || n_species % s_tile != 0 || n_y > 65535)
    return cudaErrorInvalidValue;
  const long long n_points = (long long)n_species * M;
  if (n_points > 0x7fffffffLL - BLOCK) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n_points + BLOCK - 1) / BLOCK), n_y);
  proto_kernel<T><<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(cells), n_cells, static_cast<const T*>(mTf),
      static_cast<const T*>(mT2), static_cast<const T*>(mTpx),
      static_cast<const T*>(mTpy), static_cast<const T*>(pxf),
      static_cast<const T*>(pyf), static_cast<const T*>(m2),
      static_cast<const T*>(sign), static_cast<const T*>(bary),
      static_cast<const T*>(yg), n_species, M, n_y, s_tile,
      static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define IS3D_PROTO_ENTRY(NAME, T)                                             \
  int NAME(const void* cells, int n_cells, int nf, const void* mTf,          \
           const void* mT2, const void* mTpx, const void* mTpy,              \
           const void* pxf, const void* pyf, const void* m2,                 \
           const void* sign, const void* bary, const void* yg,               \
           int n_species, int M, int n_y, int s_tile, void* out,             \
           void* stream) {                                                   \
    return launch<T>(cells, n_cells, nf, mTf, mT2, mTpx, mTpy, pxf, pyf, m2, \
                     sign, bary, yg, n_species, M, n_y, s_tile, out, stream);\
  }
IS3D_PROTO_ENTRY(is3d_smooth_proto_f32, float)
IS3D_PROTO_ENTRY(is3d_smooth_proto_f64, double)
#undef IS3D_PROTO_ENTRY

const char* is3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
