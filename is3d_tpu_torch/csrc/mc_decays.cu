// The event-level Monte-Carlo decay cascade (K8) for Hopper (sm_90a),
// float32 and float64.
//
// Replaces the XLA hot loop of is3d_tpu/kernels/mc_decays.py:_cascade_jit
// (:242): one generation of 2- and 3-body decays of every live hadron a
// pass.  A pass is two launches around a torch cumsum
// (kernels/mc_decays.py:cascade_pass_cuda):
//   * decide_kernel, one thread a live hadron: the channel from the first
//     uniform of its lineage stream against its species' cumulative row,
//     and the daughters it adds (nd - 1, 0 if stable);
//   * the inclusive cumsum of those counts (torch), so daughters 2-3 land
//     at n + exclusive offset in slot order, the layout of the plain
//     version whatever the threads' timing;
//   * write_kernel, one thread a live decaying hadron: its seven uniforms,
//     m23 by 2-node interpolation of the channel's quantile table,
//     isotropic two-stage decays with the boosts, the exponential vertex
//     along p^mu / M, daughter 1 in the parent's slot, daughters 2-3 at
//     their offsets, each with its lineage word hash(parent, j).
// A thread reads only its own slot below n and writes its slot and slots
// at or above n: no race, no atomics; two launches give identical bits.
//
// Random numbers: philox.cuh with the counters of kernels/rng.py: a
// hadron of lineage (L0, L1) draws from (L0, L1, block, DRAW_TAG);
// daughter j's lineage is the first two words of (L0, L1, j, CHILD_TAG).
// The plain version (kernels/mc_decays.py:cascade_plain) draws the same.
//
// What bounds it on this card: per hadron a handful of table gathers and
// ~70 bytes of state read and written, against 2-6 Philox blocks and ~12
// special functions (kernels/mc_decays.py:cascade_formula_ops).  A first
// version: simple and right; its time against its bound is in PERF.md.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kQ = 257;   // quantile nodes a 3-body channel (kernels KQ)

template <typename T>
struct Tabs {
  const T* mass;
  const T* ctau;
  const int* stable;
  const T* cum;
  const int* nd;
  const int* d1;
  const int* d2;
  const int* d3;
  const T* quant;
  int S, CH;
};

template <typename T>
struct Four {
  T E, x, y, z;
};

template <typename T>
__device__ __forceinline__ Four<T> boost(T Ep, T Px, T Py, T Pz, T invM, T Er,
                                         T qx, T qy, T qz) {
  const T dot = Px * qx + Py * qy + Pz * qz;
  const T Eout = (Ep * Er + dot) * invM;
  const T coef = (dot / (Ep + T(1) / invM) + Er) * invM;
  return Four<T>{Eout, qx + Px * coef, qy + Py * coef, qz + Pz * coef};
}

template <typename T>
__device__ __forceinline__ void iso_dir(T u_cos, T u_phi, T pmag, T& qx, T& qy,
                                        T& qz) {
  const T cth = T(2) * u_cos - T(1);
  const T s2 = T(1) - cth * cth;
  const T sth = sqrt(s2 > T(0) ? s2 : T(0));
  const T ph = T(6.283185307179586) * u_phi;
  qx = pmag * sth * cos(ph);
  qy = pmag * sth * sin(ph);
  qz = pmag * cth;
}

template <typename T>
__device__ __forceinline__ T sq(T v) {
  return v * v;
}

template <typename T>
__device__ __forceinline__ T posT(T v) {
  return v > T(0) ? v : T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decide_kernel(const int* sidx, const long long* lin, int n,
                  const Tabs<T> t, uint32_t k0, uint32_t k1, int* extra,
                  int* chan) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = sidx[i];
  if (t.stable[s]) {
    extra[i] = 0;
    chan[i] = 0;
    return;
  }
  T u[1];
  is3d_rng::uniforms<T, 1>(u, static_cast<uint32_t>(lin[2 * i]),
                           static_cast<uint32_t>(lin[2 * i + 1]), 0,
                           is3d_rng::kDrawTag, k0, k1, false);
  const T* cum = t.cum + static_cast<size_t>(s) * t.CH;
  int c = 0;
  for (int k = 0; k < t.CH; ++k) c += (u[0] >= cum[k]);
  c = min(c, t.CH - 1);
  chan[i] = c;
  extra[i] = t.nd[static_cast<size_t>(s) * t.CH + c] - 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    write_kernel(int* sidx, long long* lin, int* eid, T* E_, T* px_, T* py_,
                 T* pz_, T* t_, T* x_, T* y_, T* z_, int n, int cap,
                 const Tabs<T> t, uint32_t k0, uint32_t k1, const int* extra,
                 const int* chan, const int* incl) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = sidx[i];
  if (t.stable[s]) return;
  const uint32_t L0 = static_cast<uint32_t>(lin[2 * i]);
  const uint32_t L1 = static_cast<uint32_t>(lin[2 * i + 1]);
  T u[7];
  is3d_rng::uniforms<T, 7>(u, L0, L1, 0, is3d_rng::kDrawTag, k0, k1, false);

  const T M = t.mass[s];
  const T invM = T(1) / (M > T(1e-8) ? M : T(1e-8));
  const int ch = chan[i];
  const size_t sc = static_cast<size_t>(s) * t.CH + ch;
  const int nd = t.nd[sc];
  const int D1 = t.d1[sc], D2 = t.d2[sc], D3 = t.d3[sc];
  const T m1 = t.mass[D1], m2 = t.mass[D2], m3 = t.mass[D3];
  const bool is3 = nd == 3;

  const T posq = u[1] * T(kQ - 1);
  const int i0 = min(max(static_cast<int>(posq), 0), kQ - 2);
  const T fr = posq - static_cast<T>(i0);
  const T* q = t.quant + sc * kQ;
  const T mc = is3 ? q[i0] * (T(1) - fr) + q[i0 + 1] * fr : m2;

  const T E = E_[i], px = px_[i], py = py_[i], pz = pz_[i];
  const T lamA = (M * M - sq(m1 + mc)) * (M * M - sq(m1 - mc));
  const T pA = sqrt(posT(lamA)) * (T(0.5) * invM);
  T q1x, q1y, q1z;
  iso_dir(u[2], u[3], pA, q1x, q1y, q1z);
  const T E1r = sqrt(m1 * m1 + pA * pA);
  const T Ecr = sqrt(mc * mc + pA * pA);
  const Four<T> p1 = boost(E, px, py, pz, invM, E1r, q1x, q1y, q1z);
  const Four<T> pc = boost(E, px, py, pz, invM, Ecr, -q1x, -q1y, -q1z);

  const T invmc = T(1) / (mc > T(1e-8) ? mc : T(1e-8));
  const T lamB = (mc * mc - sq(m2 + m3)) * (mc * mc - sq(m2 - m3));
  const T pB = sqrt(posT(lamB)) * (T(0.5) * invmc);
  T q2x, q2y, q2z;
  iso_dir(u[4], u[5], pB, q2x, q2y, q2z);
  const T E2r = sqrt(m2 * m2 + pB * pB);
  const T E3r = sqrt(m3 * m3 + pB * pB);
  const Four<T> p2b = boost(pc.E, pc.x, pc.y, pc.z, invmc, E2r, q2x, q2y,
                            q2z);
  const Four<T> p3 = boost(pc.E, pc.x, pc.y, pc.z, invmc, E3r, -q2x, -q2y,
                           -q2z);
  const Four<T> p2 = is3 ? p2b : pc;

  const T taup = -t.ctau[s] * log1p(-u[6]);
  const T tD = t_[i] + taup * E * invM;
  const T xD = x_[i] + taup * px * invM;
  const T yD = y_[i] + taup * py * invM;
  const T zD = z_[i] + taup * pz * invM;
  const int ev = eid[i];

  auto put = [&](int j, int sp, const Four<T>& p, int child) {
    sidx[j] = sp;
    E_[j] = p.E;
    px_[j] = p.x;
    py_[j] = p.y;
    pz_[j] = p.z;
    t_[j] = tD;
    x_[j] = xD;
    y_[j] = yD;
    z_[j] = zD;
    eid[j] = ev;
    const is3d_rng::Words w =
        is3d_rng::philox(L0, L1, static_cast<uint32_t>(child),
                         is3d_rng::kChildTag, k0, k1);
    lin[2 * j] = w.w[0];
    lin[2 * j + 1] = w.w[1];
  };
  const int off = n + incl[i] - extra[i];
  put(i, D1, p1, 1);
  if (off < cap) put(off, D2, p2, 2);
  if (is3 && off + 1 < cap) put(off + 1, D3, p3, 3);
}

template <typename T>
Tabs<T> make_tabs(const void* mass, const void* ctau, const void* stable,
                  const void* cum, const void* nd, const void* d1,
                  const void* d2, const void* d3, const void* quant, int S,
                  int CH) {
  return Tabs<T>{static_cast<const T*>(mass), static_cast<const T*>(ctau),
                 static_cast<const int*>(stable), static_cast<const T*>(cum),
                 static_cast<const int*>(nd), static_cast<const int*>(d1),
                 static_cast<const int*>(d2), static_cast<const int*>(d3),
                 static_cast<const T*>(quant), S, CH};
}

unsigned blocks_for(int n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

#define IS3D_TABS_ARGS                                                        \
  const void *mass, const void *ctau, const void *stable, const void *cum,   \
      const void *nd, const void *d1, const void *d2, const void *d3,        \
      const void *quant, int S, int CH
#define IS3D_TABS(T) \
  make_tabs<T>(mass, ctau, stable, cum, nd, d1, d2, d3, quant, S, CH)

// extra (n,): daughters each live hadron adds; chan (n,): its channel
#define IS3D_DECIDE_ENTRY(NAME, T)                                            \
  int NAME(const void* sidx, const void* lin, int n, IS3D_TABS_ARGS,         \
           unsigned k0, unsigned k1, void* extra, void* chan,                \
           void* stream) {                                                   \
    if (n > 0)                                                               \
      decide_kernel<T><<<blocks_for(n), kThreads, 0,                         \
                         static_cast<cudaStream_t>(stream)>>>(               \
          static_cast<const int*>(sidx),                                     \
          static_cast<const long long*>(lin), n, IS3D_TABS(T), k0, k1,       \
          static_cast<int*>(extra), static_cast<int*>(chan));                \
    return cudaGetLastError();                                               \
  }
IS3D_DECIDE_ENTRY(is3d_cascade_decide_f32, float)
IS3D_DECIDE_ENTRY(is3d_cascade_decide_f64, double)
#undef IS3D_DECIDE_ENTRY

// incl (n,): the inclusive cumsum of extra; the state arrays have
// capacity cap
#define IS3D_WRITE_ENTRY(NAME, T)                                             \
  int NAME(void* sidx, void* lin, void* eid, void* E, void* px, void* py,    \
           void* pz, void* t, void* x, void* y, void* z, int n, int cap,     \
           IS3D_TABS_ARGS, unsigned k0, unsigned k1, const void* extra,      \
           const void* chan, const void* incl, void* stream) {               \
    if (n > 0)                                                               \
      write_kernel<T><<<blocks_for(n), kThreads, 0,                          \
                        static_cast<cudaStream_t>(stream)>>>(                \
          static_cast<int*>(sidx), static_cast<long long*>(lin),             \
          static_cast<int*>(eid), static_cast<T*>(E), static_cast<T*>(px),   \
          static_cast<T*>(py), static_cast<T*>(pz), static_cast<T*>(t),      \
          static_cast<T*>(x), static_cast<T*>(y), static_cast<T*>(z), n,     \
          cap, IS3D_TABS(T), k0, k1, static_cast<const int*>(extra),         \
          static_cast<const int*>(chan), static_cast<const int*>(incl));     \
    return cudaGetLastError();                                               \
  }
IS3D_WRITE_ENTRY(is3d_cascade_write_f32, float)
IS3D_WRITE_ENTRY(is3d_cascade_write_f64, double)
#undef IS3D_WRITE_ENTRY
#undef IS3D_TABS
#undef IS3D_TABS_ARGS

const char* is3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
