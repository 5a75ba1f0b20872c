// Resonance-decay feed-down waves for Hopper (sm_90a), float32 and float64.
//
// Replaces the XLA bodies of is3d_tpu/kernels/decays.py::_two_body_wave
// (:583) and ::_three_body_wave (:600): for every task of a wave (one
// channel, one chosen daughter species, one parent slot) the feed-down
//
//     out[task, p, f, y] = pref * [sum_s ws] sum_v sum_zeta w(v, zeta)
//                          MT (dN(MT, Phi+, Y) + dN(MT, Phi-, Y))
//
// with 12-point Gauss-Legendre rules in v (Y = y + v DeltaY), zeta (MT =
// MTbar + DeltaMT cos zeta) and, for 3-body tasks, the invariant mass s of
// the (2, 3) pair (Estar, pstar and the weight ws depend on s).  dN is the
// parent slot's patched log table, interpolated bilinearly in (MT, Phi)
// (and linearly in Y in 3+1D, exactly 0 beyond |y_max|) and exponentiated,
// or the exp(tc + ts MT) tail past the slot's MT grid.  The math is the
// gather form of the plain versions (kernels/decays.py:
// two_body_wave_plain, three_body_wave_plain), node for node.
//
// What bounds it on this card: FP32 and SFU issue, not bytes.  A wave's
// inputs are the slots' tables (a 3+1D slot of 32 x 24 x 21 is 64.5 KB in
// float32) and the output is one (P, F, Y) block per task, against 288
// evaluations per output value (3456 for 3-body); the yardstick counts 13
// (2+1D) or 21 (3+1D) FP32 operations and one SFU operation per
// evaluation (kernels/decays.py: WAVE_FORMULA_OPS).
//
// Design (a first, simple version; its time and bound are recorded, not
// tuned):
//   * A block per (task, chunk of PB pT values).  It stages the task's
//     parent slot -- the whole log table (P x F x Y), the tail tc/ts
//     (F x Y), the MT grid -- and the phi and y grids in shared memory, so
//     every gather of the interpolation is a shared load.  At the native
//     3+1D grid that is 70 KB in float32 and 140 KB in float64, above the
//     48 KB default, so the launch sets the dynamic shared-memory limit.
//   * The (v, zeta) nodes depend on (task, pT[, s]) only: the block builds
//     them once into a shared table (MT, Phi~ = arccos(...), the weight
//     wz vw MT, the MT stencil's left index and weight, -1 for the tail),
//     each thread one node.  3-body tasks rebuild it for each s.
//   * A thread owns one output (pT, phi, y) and walks the 144 nodes; per v
//     it forms the Y stencil once (3+1D), per node it forms both Phi
//     solutions, wraps each to [0, 2 pi) (one add or subtract, as exact as
//     fmod on a phi grid in [0, 2 pi); the wrap cell between phi[F-1] -
//     2 pi and phi[0] as the plain version), finds the phi interval by a
//     binary search in shared memory and gathers 4 (2+1D) or 8 (3+1D)
//     table values.  3+1D takes PB = 1 (F x Y outputs, in passes of 256);
//     2+1D, which has only F outputs per pT, takes 256 / F pT a block.
//   * float32 takes ex2.approx on x log2(e) for exp (+inf -> inf, -inf ->
//     0), the accurate acosf, logf, coshf, sinhf for the nodes; float64
//     keeps IEEE exp.  The 1e-30 floor of PT^2 is normal in float32.
//   * fold_kernel adds each target row's tasks, in schedule order, into the
//     float64 accumulator of the spectra (a thread per target value); no
//     atomics, so two launches give identical bits.

#include <cuda_runtime.h>

namespace {

constexpr int NG = 12;             // Gauss-Legendre points in v, zeta, s
constexpr int NODES = NG * NG;     // (v, zeta) nodes per (task, pT[, s])
constexpr int THREADS = 256;
constexpr int MAX_PB = 16;         // pT values a block
constexpr int NPAR = 6;            // parameters per task
constexpr int FOLD_THREADS = 256;
constexpr size_t MAX_SMEM = 232448;

template <typename T>
struct Fn;

template <>
struct Fn<float> {
  static constexpr float TWO_PI = 6.283185307179586f;
  static constexpr float PI = 3.141592653589793f;
  static __device__ __forceinline__ float exp(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
    return y;
  }
  static __device__ __forceinline__ float sqrt(float x) { return sqrtf(x); }
  static __device__ __forceinline__ float log(float x) { return logf(x); }
  static __device__ __forceinline__ float cosh(float x) { return coshf(x); }
  static __device__ __forceinline__ float sinh(float x) { return sinhf(x); }
  static __device__ __forceinline__ float acos(float x) { return acosf(x); }
  static __device__ __forceinline__ float floor(float x) { return floorf(x); }
  static __device__ __forceinline__ float abs(float x) { return fabsf(x); }
};

template <>
struct Fn<double> {
  static constexpr double TWO_PI = 6.283185307179586;
  static constexpr double PI = 3.141592653589793;
  static __device__ __forceinline__ double exp(double x) { return ::exp(x); }
  static __device__ __forceinline__ double sqrt(double x) { return ::sqrt(x); }
  static __device__ __forceinline__ double log(double x) { return ::log(x); }
  static __device__ __forceinline__ double cosh(double x) { return ::cosh(x); }
  static __device__ __forceinline__ double sinh(double x) { return ::sinh(x); }
  static __device__ __forceinline__ double acos(double x) { return ::acos(x); }
  static __device__ __forceinline__ double floor(double x) {
    return ::floor(x);
  }
  static __device__ __forceinline__ double abs(double x) { return fabs(x); }
};

template <typename T>
__device__ __forceinline__ T max_(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T min_(T a, T b) { return a < b ? a : b; }

// first index i of the sorted a[0..n) with a[i] >= x (torch.searchsorted,
// right=False), n if none
template <typename T>
__device__ __forceinline__ int lower_bound(const T* a, int n, T x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// the shared-memory layout of a block (T arrays first, then ints)
template <typename T>
struct Smem {
  T *tab, *tc, *ts, *mtg, *phi, *invd, *y, *qx, *qw, *qz;
  T *nMT, *nPh, *nW, *nTM, *ysh;
  int* nIM;

  static __host__ __device__ size_t bytes(int P, int F, int NY, int PB) {
    const size_t FY = (size_t)F * NY;
    return sizeof(T) * ((size_t)P * FY + 2 * FY + P + 2 * F + NY + 3 * NG
                        + 4 * (size_t)PB * NODES + (size_t)PB * NG)
           + sizeof(int) * (size_t)PB * NODES;
  }

  __device__ Smem(unsigned char* raw, int P, int F, int NY, int PB) {
    const int FY = F * NY;
    tab = reinterpret_cast<T*>(raw);
    tc = tab + (size_t)P * FY;
    ts = tc + FY;
    mtg = ts + FY;
    phi = mtg + P;
    invd = phi + F;
    y = invd + F;
    qx = y + NY;
    qw = qx + NG;
    qz = qw + NG;
    nMT = qz + NG;
    nPh = nMT + PB * NODES;
    nW = nPh + PB * NODES;
    nTM = nW + PB * NODES;
    ysh = nTM + PB * NODES;
    nIM = reinterpret_cast<int*>(ysh + PB * NG);
  }
};

// the (v, zeta) node n of pT value pb of the block: MT, Phi~, the weight
// wz vw MT, the MT stencil (left index, -1 past the grid; weight); node
// zeta = 0 also keeps v DeltaY
template <typename T>
__device__ __forceinline__ void build_node(const Smem<T>& s, int n, T pt,
                                           int P, T m2, T Es, T ps, T M) {
  using F_ = Fn<T>;
  const int pb = n / NODES, v = (n / NG) % NG, z = n % NG;
  const T pT2 = pt * pt;
  const T mT2 = pT2 + m2;
  const T mT = F_::sqrt(mT2);
  const T DY = F_::log((ps + F_::sqrt(Es * Es + pT2)) / mT);
  const T a = s.qx[v] * DY;
  const T ch = F_::cosh(a), sh = F_::sinh(a);
  // cancellation-free forms (kernels/decays.py, _two_body_integral)
  const T mT2s2 = mT2 * (sh * sh);
  const T den = m2 + mT2s2;
  const T MTbar = Es * M * mT * ch / den;
  const T DMT = M * pt * F_::sqrt(F_::abs(ps * ps - mT2s2)) / den;
  const T mTc = mT * ch / pt;
  const T vw = DY * s.qw[v] / F_::sqrt(F_::abs(den));
  const T MT = MTbar + DMT * s.qz[z];
  const T PT = F_::sqrt(max_(MT * MT - M * M, T(1e-30)));
  const T arg = (MT * mTc - Es * M / pt) / PT;
  s.nMT[n] = MT;
  s.nPh[n] = F_::acos(min_(max_(arg, T(-1)), T(1)));
  s.nW[n] = s.qw[z] * vw * MT;
  const int iR = min(max(lower_bound(s.mtg, P, MT), 1), P - 1);
  s.nTM[n] = (MT - s.mtg[iR - 1]) / (s.mtg[iR] - s.mtg[iR - 1]);
  s.nIM[n] = MT <= s.mtg[P - 1] ? iR - 1 : -1;
  if (z == 0) s.ysh[pb * NG + v] = a;
}

// log dN at (MT, Phi[, plane iy]) of the stencil (iM, tM) (iM < 0: the
// tail), phi cell (iL, iR, t)
template <typename T>
__device__ __forceinline__ T plane(const Smem<T>& s, int F, int NY, int iM,
                                   T tM, T MT, int iL, int iR, T t, int iy) {
  const T wL = T(1) - t;
  if (iM >= 0) {
    const T* r0 = s.tab + (size_t)iM * F * NY + iy;
    const T* r1 = r0 + F * NY;
    return (r0[iL * NY] * wL + r0[iR * NY] * t) * (T(1) - tM)
           + (r1[iL * NY] * wL + r1[iR * NY] * t) * tM;
  }
  return (s.tc[iL * NY + iy] + s.ts[iL * NY + iy] * MT) * wL
         + (s.tc[iR * NY + iy] + s.ts[iR * NY + iy] * MT) * t;
}

// dN at one Phi solution (before the wrap to [0, 2 pi))
template <typename T, int DIM>
__device__ __forceinline__ T eval(const Smem<T>& s, int F, int NY, int iM,
                                  T tM, T MT, T Phi, int iYL, T tY) {
  using F_ = Fn<T>;
  // jnp.mod / torch.remainder (fmod, then + 2 pi where negative).  Phi =
  // +-Phi~ + phi lies in [-pi, 3 pi] on a grid in [0, 2 pi), which the
  // host checks (do_resonance_decays): there one add or subtract of 2 pi
  // gives the same bits (fmod is exact, and so is Phi - 2 pi for Phi in
  // [2 pi, 4 pi))
  T Pw = Phi;
  if (Pw < T(0)) Pw += F_::TWO_PI;
  else if (Pw >= F_::TWO_PI) Pw -= F_::TWO_PI;
  int iL, iR;
  T t;
  if (Pw >= s.phi[0] && Pw <= s.phi[F - 1]) {
    iR = min(max(lower_bound(s.phi, F, Pw), 1), F - 1);
    iL = iR - 1;
    t = (Pw - s.phi[iL]) * s.invd[iL];
  } else {
    // the wrap cell (phi[F-1] - 2 pi, phi[0]), the angle mapped near 0
    const T x = Pw - F_::floor(Pw / F_::PI) * F_::TWO_PI;
    iL = F - 1;
    iR = 0;
    t = (x - (s.phi[F - 1] - F_::TWO_PI)) * s.invd[F - 1];
  }
  T val;
  if (DIM == 3)
    val = plane(s, F, NY, iM, tM, MT, iL, iR, t, iYL) * (T(1) - tY)
          + plane(s, F, NY, iM, tM, MT, iL, iR, t, iYL + 1) * tY;
  else
    val = plane(s, F, NY, iM, tM, MT, iL, iR, t, 0);
  return F_::exp(val);
}

template <typename T, int DIM, int NBODY>
__global__ void __launch_bounds__(THREADS)
    wave_kernel(const T* __restrict__ logdN, const T* __restrict__ tc,
                const T* __restrict__ ts, const T* __restrict__ mtg,
                const T* __restrict__ pT, const T* __restrict__ phi,
                const T* __restrict__ y, const T* __restrict__ quad,
                const int* __restrict__ slot, const T* __restrict__ par,
                int P, int F, int NY, int PB, T* __restrict__ out) {
  using F_ = Fn<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> s(smem_raw, P, F, NY, PB);
  const int k = blockIdx.x;
  const int p0 = blockIdx.y * PB;
  const int np = min(PB, P - p0);
  const int FY = F * NY;
  const int PFY = P * FY;
  const size_t u = slot[k];

  for (int i = threadIdx.x; i < PFY; i += THREADS)
    s.tab[i] = logdN[u * PFY + i];
  for (int i = threadIdx.x; i < FY; i += THREADS) {
    s.tc[i] = tc[u * FY + i];
    s.ts[i] = ts[u * FY + i];
  }
  for (int i = threadIdx.x; i < P; i += THREADS) s.mtg[i] = mtg[u * P + i];
  for (int i = threadIdx.x; i < F; i += THREADS) s.phi[i] = phi[i];
  for (int i = threadIdx.x; i < NY; i += THREADS) s.y[i] = y[i];
  for (int i = threadIdx.x; i < NG; i += THREADS) {
    s.qx[i] = quad[i];
    s.qw[i] = quad[NG + i];
    s.qz[i] = quad[2 * NG + i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < F; i += THREADS)
    s.invd[i] = T(1) / (i + 1 < F ? s.phi[i + 1] - s.phi[i]
                                  : s.phi[0] - (s.phi[F - 1] - F_::TWO_PI));

  const T* pk = par + (size_t)k * NPAR;
  const T pref = pk[0], m2 = pk[1];
  const T M = NBODY == 2 ? pk[4] : pk[2];
  const T yedge = F_::abs(s.y[NY - 1]);
  const int n_out = np * FY;
  const int n_nodes = np * NODES;

  for (int base = 0; base < n_out; base += THREADS) {
    const int o = base + threadIdx.x;
    const bool active = o < n_out;
    const int pb = active ? o / FY : 0;
    const int f = active ? (o / NY) % F : 0;
    const int yj = active ? o % NY : 0;
    T acc = T(0);
    for (int is = 0; is < (NBODY == 3 ? NG : 1); ++is) {
      T Es, ps, sw;
      if (NBODY == 2) {
        Es = pk[2];
        ps = pk[3];
        sw = T(1);
      } else {
        const T sm = pk[3], sp = pk[4], d = pk[5];
        const T sv = sm + (sp - sm) * (T(1) + s.qx[is]) / T(2);
        Es = (M * M + m2 - sv) / (T(2) * M);
        ps = F_::sqrt(max_(Es * Es - m2, T(1e-30)));
        sw = s.qw[is] * F_::sqrt(F_::abs((sv - sm) * (sv - d))) / sv;
      }
      __syncthreads();            // the last node table is no longer read
      for (int n = threadIdx.x; n < n_nodes; n += THREADS)
        build_node(s, n, pT[p0 + n / NODES], P, m2, Es, ps, M);
      __syncthreads();
      if (!active) continue;
      const T phif = s.phi[f];
      T part = T(0);
      for (int v = 0; v < NG; ++v) {
        int iYL = 0;
        T tY = T(0);
        if (DIM == 3) {
          const T Y = s.y[yj] + s.ysh[pb * NG + v];
          if (!(F_::abs(Y) <= yedge)) continue;     // exactly 0 there
          iYL = min(max(lower_bound(s.y, NY, Y), 1), NY - 1) - 1;
          tY = (Y - s.y[iYL]) / (s.y[iYL + 1] - s.y[iYL]);
        }
        T zs = T(0);
        const int n0 = (pb * NG + v) * NG;
        for (int z = 0; z < NG; ++z) {
          const int n = n0 + z;
          const T MT = s.nMT[n], Ph = s.nPh[n], tM = s.nTM[n];
          const int iM = s.nIM[n];
          zs += s.nW[n] * (eval<T, DIM>(s, F, NY, iM, tM, MT, Ph + phif, iYL,
                                        tY)
                           + eval<T, DIM>(s, F, NY, iM, tM, MT, phif - Ph,
                                          iYL, tY));
        }
        part += zs;
      }
      acc += sw * part;
    }
    if (active)
      out[(size_t)k * PFY + (size_t)(p0 + pb) * FY + f * NY + yj] =
          pref * acc;
  }
}

// acc[target[t], e] += sum over j in [tstart[t], tstart[t+1]) of
// scratch[order[j], e], in that order, in float64
template <typename T>
__global__ void __launch_bounds__(FOLD_THREADS)
    fold_kernel(const T* __restrict__ scratch, const int* __restrict__ order,
                const int* __restrict__ target,
                const int* __restrict__ tstart, long long PFY,
                double* __restrict__ acc) {
  const long long e = (long long)blockIdx.x * FOLD_THREADS + threadIdx.x;
  const int t = blockIdx.y;
  if (e >= PFY) return;
  double sum = 0.0;
  for (int j = tstart[t]; j < tstart[t + 1]; ++j)
    sum += (double)scratch[(size_t)order[j] * PFY + e];
  acc[(size_t)target[t] * PFY + e] += sum;
}

template <typename T, int DIM, int NBODY>
cudaError_t launch_kernel(dim3 grid, size_t smem, cudaStream_t stream,
                          const T* logdN, const T* tc, const T* ts,
                          const T* mtg, const T* pT, const T* phi, const T* y,
                          const T* quad, const int* slot, const T* par, int P,
                          int F, int NY, int PB, T* out) {
  auto kern = wave_kernel<T, DIM, NBODY>;
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return rc;
  kern<<<grid, THREADS, smem, stream>>>(logdN, tc, ts, mtg, pT, phi, y, quad,
                                        slot, par, P, F, NY, PB, out);
  return cudaGetLastError();
}

template <typename T>
int launch_wave(int nbody, int dim, const void* logdN_v, const void* tc_v,
                const void* ts_v, const void* mtg_v, const void* pT_v,
                const void* phi_v, const void* y_v, const void* quad_v, int U,
                int P, int F, int NY, const void* slot_v, const void* par_v,
                int K, const void* order_v, const void* target_v,
                const void* tstart_v, int n_target, void* scratch_v,
                void* acc_v, void* stream_v) {
  if (K < 1 || U < 1 || P < 2 || F < 2 || n_target < 1 || n_target > 65535 ||
      (nbody != 2 && nbody != 3) || !((dim == 2 && NY == 1) ||
                                      (dim == 3 && NY >= 2)))
    return cudaErrorInvalidValue;
  const int FY = F * NY;
  const int PB = max(1, min(min(P, MAX_PB), THREADS / FY));
  const size_t smem = Smem<T>::bytes(P, F, NY, PB);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  const dim3 grid((unsigned)K, (unsigned)((P + PB - 1) / PB));
  const T* logdN = static_cast<const T*>(logdN_v);
  const T* tc = static_cast<const T*>(tc_v);
  const T* ts = static_cast<const T*>(ts_v);
  const T* mtg = static_cast<const T*>(mtg_v);
  const T* pT = static_cast<const T*>(pT_v);
  const T* phi = static_cast<const T*>(phi_v);
  const T* y = static_cast<const T*>(y_v);
  const T* quad = static_cast<const T*>(quad_v);
  const int* slot = static_cast<const int*>(slot_v);
  const T* par = static_cast<const T*>(par_v);
  T* scratch = static_cast<T*>(scratch_v);
  cudaError_t rc;
#define IS3D_WAVE(D, N)                                                      \
  launch_kernel<T, D, N>(grid, smem, stream, logdN, tc, ts, mtg, pT, phi, y, \
                         quad, slot, par, P, F, NY, PB, scratch)
  if (dim == 2)
    rc = nbody == 2 ? IS3D_WAVE(2, 2) : IS3D_WAVE(2, 3);
  else
    rc = nbody == 2 ? IS3D_WAVE(3, 2) : IS3D_WAVE(3, 3);
#undef IS3D_WAVE
  if (rc != cudaSuccess) return (int)rc;
  const long long PFY = (long long)P * FY;
  const dim3 fgrid((unsigned)((PFY + FOLD_THREADS - 1) / FOLD_THREADS),
                   (unsigned)n_target);
  fold_kernel<T><<<fgrid, FOLD_THREADS, 0, stream>>>(
      scratch, static_cast<const int*>(order_v),
      static_cast<const int*>(target_v), static_cast<const int*>(tstart_v),
      PFY, static_cast<double*>(acc_v));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define IS3D_DECAY_ENTRY(NAME, T)                                            \
  int NAME(int nbody, int dim, const void* logdN, const void* tc,           \
           const void* ts, const void* mtg, const void* pT, const void* phi, \
           const void* y, const void* quad, int U, int P, int F, int NY,    \
           const void* slot, const void* par, int K, const void* order,     \
           const void* target, const void* tstart, int n_target,            \
           void* scratch, void* acc, void* stream) {                        \
    return launch_wave<T>(nbody, dim, logdN, tc, ts, mtg, pT, phi, y, quad, \
                          U, P, F, NY, slot, par, K, order, target, tstart, \
                          n_target, scratch, acc, stream);                  \
  }
IS3D_DECAY_ENTRY(is3d_decay_wave_f32, float)
IS3D_DECAY_ENTRY(is3d_decay_wave_f64, double)
#undef IS3D_DECAY_ENTRY

const char* is3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
