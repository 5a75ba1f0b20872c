// The event-level Monte-Carlo decay cascade (K8) for Hopper (sm_90a),
// float32 and float64.
//
// Replaces the XLA hot loop of is3d_tpu/kernels/mc_decays.py:_cascade_jit
// (:242): one generation of 2- and 3-body decays of every live hadron a
// pass.  A pass is one launch of pass_kernel, and the live count stays on
// the card (kernels/mc_decays.py:launch_cascade queues every pass and the
// host reads the counts once, after the last):
//   * pass p reads its live count n from counts[p]; at most the card's
//     resident blocks are launched, and a tile is 1 to kMaxItems slots a
//     thread, as few as let each block take the pass in one tile (a
//     tile's fixed cost, a ticket, five barriers and a look-back, is most
//     of a pass in which few hadrons decay); a block takes tiles from an
//     atomic counter, in the order blocks start;
//   * a thread a slot (coalesced): a decaying hadron draws its first
//     Philox block (from its lineage words), picks its channel from u[0]
//     against its species' cumulative row and adds nd - 1 daughters; the
//     decision and the block's other uniforms wait in shared memory;
//   * a thread a run of slots: a warp scan, a block scan and a single-pass
//     decoupled look-back over the earlier tiles (scan.cuh, a warp reading
//     32 tiles' words at once) give the tile's daughters 2-3 the slots n
//     + the exclusive prefix in slot order: integer-only, so they land in
//     the slots the plain version's cumsum gives them whatever the
//     blocks' timing; the pass's last tile publishes counts[p + 1] (also
//     past the capacity: writes past it are skipped, and the host raises
//     on the count);
//   * the tile's decays, listed in slot order and spread over the block:
//     the rest of each one's seven uniforms (every Philox block drawn
//     once), m23 by 2-node interpolation of the channel's quantile table,
//     isotropic two-stage decays with the boosts, the exponential vertex
//     along p^mu / M, daughter 1 in the parent's slot, daughters 2-3 at
//     their slots, each with its lineage word hash(parent, j).
// A thread reads only its own slots below n and writes them and slots at
// or above n: no race, no float atomics; two launches give identical
// bits.
//
// The species tables (mass, ctau, stable, the cumulative rows, nd and the
// daughters) are read through the read-only cache, the m23 quantile tables
// from L2.  Staging the tables in shared memory once a block lost its A/B
// on every pass (PERF.md): a block reads few of their entries, and the
// staging sat on each block's critical path.
//
// Random numbers: philox.cuh with the counters of kernels/rng.py: a
// hadron of lineage (L0, L1) draws from (L0, L1, block, DRAW_TAG);
// daughter j's lineage is the first two words of (L0, L1, j, CHILD_TAG).
// The plain version (kernels/mc_decays.py:cascade_plain) draws the same.
//
// What bounds it on this card: the bytes of the live hadrons' species,
// the decaying ones' state and the daughters' state written (~70 bytes a
// decay in float32), against 5 (float32) or 7 Philox blocks and 13
// special functions a decay (kernels/mc_decays.py:cascade_formula_ops);
// at the main path's ~2e5 decays a pass that is ~11 us, so a pass is
// short against the launch and a tile's ticket, barriers and look-back.
// Its times against its bound, and each element's A/B, are in PERF.md.

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

#include "philox.cuh"
#include "scan.cuh"

namespace {

using namespace is3d_scan;

constexpr int kThreads = 512;              // a block; a tile of slots
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocksF32 = 2;           // float32: 64 registers a thread
constexpr int kMaxItems = 4;               // slots a thread at most
constexpr int kQ = 257;                    // quantile nodes (kernels KQ)

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
struct State {
  int* sidx;
  long long* lin;   // (cap, 2)
  int* eid;
  T *E, *px, *py, *pz, *t, *x, *y, *z;
};

struct Pass {
  int* counts;                        // (n_passes + 1,) live counts
  unsigned long long* tile_counter;   // this pass's, zeroed
  unsigned long long* states;         // this pass's look-back, zeroed
  int pass, cap;
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

// the decay of slot i (species sp, channel c, uniforms u[1..6]): daughter
// 1 in place, daughters 2-3 at off, off + 1 where below the capacity
template <typename T>
__device__ __forceinline__ void decay(const State<T>& s, const Tabs<T>& t,
                                     int i, int sp, int c, const T (&u)[7],
                                     uint32_t L0, uint32_t L1, int off,
                                     int cap, uint32_t k0, uint32_t k1) {
  const T M = __ldg(t.mass + sp);
  const T invM = T(1) / (M > T(1e-8) ? M : T(1e-8));
  const size_t sc = static_cast<size_t>(sp) * t.CH + c;
  const int nd = __ldg(t.nd + sc);
  const int D1 = __ldg(t.d1 + sc), D2 = __ldg(t.d2 + sc),
            D3 = __ldg(t.d3 + sc);
  const T m1 = __ldg(t.mass + D1), m2 = __ldg(t.mass + D2),
          m3 = __ldg(t.mass + D3);
  const bool is3 = nd == 3;

  const T posq = u[1] * T(kQ - 1);
  const int i0 = min(max(static_cast<int>(posq), 0), kQ - 2);
  const T fr = posq - static_cast<T>(i0);
  const T* q = t.quant + sc * kQ;
  const T mc = is3 ? __ldg(q + i0) * (T(1) - fr) + __ldg(q + i0 + 1) * fr
                   : m2;

  const T E = s.E[i], px = s.px[i], py = s.py[i], pz = s.pz[i];
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

  const T taup = -__ldg(t.ctau + sp) * log1p(-u[6]);
  const T tD = s.t[i] + taup * E * invM;
  const T xD = s.x[i] + taup * px * invM;
  const T yD = s.y[i] + taup * py * invM;
  const T zD = s.z[i] + taup * pz * invM;
  const int ev = s.eid[i];

  auto put = [&](int j, int sp_j, const Four<T>& p, int child) {
    s.sidx[j] = sp_j;
    s.E[j] = p.E;
    s.px[j] = p.x;
    s.py[j] = p.y;
    s.pz[j] = p.z;
    s.t[j] = tD;
    s.x[j] = xD;
    s.y[j] = yD;
    s.z[j] = zD;
    s.eid[j] = ev;
    const is3d_rng::Words w =
        is3d_rng::philox(L0, L1, static_cast<uint32_t>(child),
                         is3d_rng::kChildTag, k0, k1);
    s.lin[2 * j] = w.w[0];
    s.lin[2 * j + 1] = w.w[1];
  };
  put(i, D1, p1, 1);
  if (off < cap) put(off, D2, p2, 2);
  if (is3 && off + 1 < cap) put(off + 1, D3, p3, 3);
}

constexpr int kSlots = kMaxItems * kThreads;   // a tile's slots at most

// shared memory a block keeps for a tile's slots: the first Philox
// block's uniforms past u[0] and the decision (channel | added daughters
// << 16, -1: no decay) of each slot, and the list of its decays (slot,
// daughters' offset in the tile)
template <typename T>
__host__ __device__ constexpr size_t slot_bytes() {
  return static_cast<size_t>(kSlots)
      * ((is3d_rng::Unit<T>::kPerBlock - 1) * sizeof(T) + 3 * sizeof(int));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? kMinBlocksF32 : 1)
    pass_kernel(const State<T> s, const Tabs<T> t, const Pass p, uint32_t k0,
                uint32_t k1) {
  constexpr int P = is3d_rng::Unit<T>::kPerBlock;   // uniforms a block
  extern __shared__ __align__(16) unsigned char smem[];
  T* kept = reinterpret_cast<T*>(smem);        // (P - 1) x kSlots
  int* code = reinterpret_cast<int*>(kept + (P - 1) * kSlots);
  int* list_slot = code + kSlots;
  int* list_off = list_slot + kSlots;
  __shared__ int warp_incl[kWarps];
  __shared__ int s_tile, s_excl;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = p.counts[p.pass];
  if (n <= 0 || n > p.cap) {        // nothing live, or an earlier overflow
    if (blockIdx.x == 0 && tid == 0) p.counts[p.pass + 1] = n;
    return;
  }
  // slots a thread: as few as let the launched blocks take the pass in
  // one tile each, up to kMaxItems
  const long long span = static_cast<long long>(gridDim.x) * kThreads;
  const long long want = (n + span - 1) / span;
  const int items = static_cast<int>(want < kMaxItems ? want : kMaxItems);
  const int n_tiles = (n + items * kThreads - 1) / (items * kThreads);
  for (;;) {
    if (tid == 0) s_tile = static_cast<int>(atomicAdd(p.tile_counter, 1ull));
    __syncthreads();
    const int tile = s_tile;
    if (tile >= n_tiles) return;
    const int base = tile * items * kThreads;

    // 1. a thread a slot, coalesced: a decaying hadron's first Philox
    // block, its channel and the daughters it adds
    for (int j = 0; j < items; ++j) {
      const int k = j * kThreads + tid, i = base + k;
      int dc = -1;
      if (i < n) {
        const int sp = s.sidx[i];
        if (!__ldg(t.stable + sp)) {
          const is3d_rng::Words w = is3d_rng::philox(
              static_cast<uint32_t>(s.lin[2 * i]),
              static_cast<uint32_t>(s.lin[2 * i + 1]), 0, is3d_rng::kDrawTag,
              k0, k1);
          const T u0 = is3d_rng::Unit<T>::at(w, 0, false);
#pragma unroll
          for (int b = 1; b < P; ++b)
            kept[(b - 1) * kSlots + k] = is3d_rng::Unit<T>::at(w, b, false);
          const T* cum = t.cum + static_cast<size_t>(sp) * t.CH;
          int c = 0;
          for (int q = 0; q < t.CH; ++q) c += (u0 >= __ldg(cum + q));
          c = min(c, t.CH - 1);
          dc = c | ((__ldg(t.nd + static_cast<size_t>(sp) * t.CH + c) - 1)
                    << 16);
        }
      }
      code[k] = dc;
    }
    __syncthreads();

    // 2. a thread a run of items slots, in slot order: its decays and
    // daughters (decays << 16 | daughters: a tile's totals stay below
    // 2^16), summed by a warp scan, a block scan and the look-back over
    // the earlier tiles' daughters
    int mine = 0;
    for (int j = 0; j < items; ++j) {
      const int dc = code[tid * items + j];
      if (dc >= 0) mine += (1 << 16) + (dc >> 16);
    }
    const int incl = warp_scan(mine, lane);
    if (lane == 31) warp_incl[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int v = lane < kWarps ? warp_incl[lane] : 0;
      v = warp_scan(v, lane);
      if (lane < kWarps) warp_incl[lane] = v;
    }
    __syncthreads();
    const int total = warp_incl[kWarps - 1];
    if (warp == 0) {
      const int excl = static_cast<int>(look_back_warp(
          p.states, tile, static_cast<unsigned long long>(total & 0xffff),
          lane));
      if (lane == 0) s_excl = excl;
    }

    // 3. the tile's decays listed in slot order with their daughters'
    // offsets in the tile
    int before = (warp ? warp_incl[warp - 1] : 0) + incl - mine;
    int q = before >> 16, add = before & 0xffff;
    for (int j = 0; j < items; ++j) {
      const int k = tid * items + j, dc = code[k];
      if (dc < 0) continue;
      list_slot[q] = k;
      list_off[q++] = add;
      add += dc >> 16;
    }
    __syncthreads();

    // 4. the decays, spread over the block: the rest of each one's
    // uniforms (every Philox block once), the kinematics, the daughters;
    // the pass's last tile publishes the next live count
    const int n_dec = total >> 16, off0 = n + s_excl;
    if (tid == 0 && tile == n_tiles - 1)
      p.counts[p.pass + 1] = off0 + (total & 0xffff);
    for (int r = tid; r < n_dec; r += kThreads) {
      const int k = list_slot[r], i = base + k;
      const uint32_t L0 = static_cast<uint32_t>(s.lin[2 * i]);
      const uint32_t L1 = static_cast<uint32_t>(s.lin[2 * i + 1]);
      T u[7];
      u[0] = T(0);
#pragma unroll
      for (int b = 1; b < P; ++b) u[b] = kept[(b - 1) * kSlots + k];
#pragma unroll
      for (int blk = 1; blk * P < 7; ++blk) {
        const is3d_rng::Words w = is3d_rng::philox(
            L0, L1, static_cast<uint32_t>(blk), is3d_rng::kDrawTag, k0, k1);
#pragma unroll
        for (int b = 0; b < P; ++b)
          if (blk * P + b < 7)
            u[blk * P + b] = is3d_rng::Unit<T>::at(w, b, false);
      }
      decay<T>(s, t, i, s.sidx[i], code[k] & 0xffff, u, L0, L1,
                     off0 + list_off[r], p.cap, k0, k1);
    }
  }
}

// blocks of pass_kernel<T> that fit on the card at once, or minus a CUDA
// error code; kept for the device last asked
template <typename T>
int resident() {
  static int last_dev = -1, last_slots = 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (dev == last_dev) return last_slots;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pass_kernel<T>, kThreads, slot_bytes<T>());
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  last_dev = dev;
  last_slots = sms * per_sm;
  return last_slots;
}

// one pass: a block per tile of at most n_upper slots, no more blocks than
// fit on the card at once
template <typename T>
int launch_pass(const State<T>& s, const Tabs<T>& t, const Pass& p,
                int n_upper, uint32_t k0, uint32_t k1, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        pass_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(slot_bytes<T>()));
    if (e != cudaSuccess) return e;
    ready = true;
  }
  const int slots = resident<T>();
  if (slots < 0) return -slots;
  const int tiles = (std::max(n_upper, 1) + kThreads - 1) / kThreads;
  pass_kernel<T><<<std::min(tiles, slots), kThreads, slot_bytes<T>(),
                   stream>>>(s, t, p, k0, k1);
  return cudaGetLastError();
}

template <typename T>
int pass_entry(void* sidx, void* lin, void* eid, void* E, void* px, void* py,
               void* pz, void* tt, void* x, void* y, void* z, int cap,
               int pass, void* counts, void* tile_counter, void* states,
               int n_upper, const void* mass, const void* ctau,
               const void* stable, const void* cum, const void* nd,
               const void* d1, const void* d2, const void* d3,
               const void* quant, int S, int CH, unsigned k0, unsigned k1,
               void* stream) {
  const State<T> s{static_cast<int*>(sidx), static_cast<long long*>(lin),
                   static_cast<int*>(eid), static_cast<T*>(E),
                   static_cast<T*>(px), static_cast<T*>(py),
                   static_cast<T*>(pz), static_cast<T*>(tt),
                   static_cast<T*>(x), static_cast<T*>(y),
                   static_cast<T*>(z)};
  const Tabs<T> t{static_cast<const T*>(mass), static_cast<const T*>(ctau),
                  static_cast<const int*>(stable), static_cast<const T*>(cum),
                  static_cast<const int*>(nd), static_cast<const int*>(d1),
                  static_cast<const int*>(d2), static_cast<const int*>(d3),
                  static_cast<const T*>(quant), S, CH};
  const Pass p{static_cast<int*>(counts),
               static_cast<unsigned long long*>(tile_counter),
               static_cast<unsigned long long*>(states), pass, cap};
  return launch_pass<T>(s, t, p, n_upper, k0, k1,
                        static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// slots a tile: the wrapper sizes the look-back state words from it
int is3d_cascade_tile() { return kThreads; }

// pass ``pass`` of the cascade on the state arrays of capacity cap: reads
// counts[pass], writes counts[pass + 1]; tile_counter (one word) and
// states (a word a tile of cap) zeroed by the caller; n_upper bounds the
// pass's live count (the grid)
#define IS3D_PASS_ENTRY(NAME, T)                                             \
  int NAME(void* sidx, void* lin, void* eid, void* E, void* px, void* py,   \
           void* pz, void* t, void* x, void* y, void* z, int cap, int pass, \
           void* counts, void* tile_counter, void* states, int n_upper,     \
           const void* mass, const void* ctau, const void* stable,          \
           const void* cum, const void* nd, const void* d1, const void* d2, \
           const void* d3, const void* quant, int S, int CH, unsigned k0,   \
           unsigned k1, void* stream) {                                     \
    return pass_entry<T>(sidx, lin, eid, E, px, py, pz, t, x, y, z, cap,    \
                         pass, counts, tile_counter, states, n_upper, mass, \
                         ctau, stable, cum, nd, d1, d2, d3, quant, S, CH,   \
                         k0, k1, stream);                                   \
  }
IS3D_PASS_ENTRY(is3d_cascade_pass_f32, float)
IS3D_PASS_ENTRY(is3d_cascade_pass_f64, double)
#undef IS3D_PASS_ENTRY

const char* is3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
