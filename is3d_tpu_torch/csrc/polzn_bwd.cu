// The backward pass of the thermal-vorticity spin polarization (mode 5)
// for Hopper (sm_90a), float32 and float64: the gradient of <G, (St, Sx,
// Sy, Sn, Snorm)> with respect to the packed cells.
//
// Replaces what JAX runs for the reverse pass of the polarization: XLA's
// reverse of the chunk body _chunk_polzn (is3d_tpu/kernels/polzn.py:42)
// under jax.checkpoint (:189-190), driven by is3d_tpu/diff.py:197-207, for
// the fixed-node kernel (polzn_bwd_kernel, K12a: 3+1D and 2+1D fixed
// nodes) and the 2+1D mT remap (polzn_remap_bwd_kernel, K12b: the reverse
// of polzn.py:73-94 and :145-149).  Like JAX's remat it keeps no forward
// intermediates: it recomputes every evaluation from the packed cells and
// chains through it.
//
// Inputs (built by is3d_tpu_torch/kernels/polzn.py): cells (n_cells, NW) in
// the order of polzn.cuh's `PwField`; the species and momentum constants
// of the forward (pm = -0.25 / m); the node weights wR; with the remap the
// node table exp(-+s eta_r) of kernels/smooth.py:remap_node_table (K1's
// and K6's); G (5, n_species, n_pT, n_phi, n_out), the five sums'
// cotangents (n_out = n_nodes in 3+1D, 1 in 2+1D).
// Output: grad (n_cells, NW), every row written once.
//
// The formula (the plain version's, kernels/polzn.py:polzn_block, under
// torch autograd).  At one evaluation (cell, node, species, pT, phi), with
// cp = mT cosh(Delta), sn = mT sinh(Delta), Delta = y - eta (3+1D), -eta_r
// (2+1D fixed) or y_flow - s eta_r (the remap):
//     p.dsigma = cp dat + sn dant + dax px + day py,
//     u.p / T  = cp ut_T - sn tun_T - ux_T px - uy_T py,
//     f0 = 1 / (exp(u.p / T) + sign),  q = 1 - sign f0,  pref = pm q,
//     meas = p.dsigma f0,  mp = meas pref,  S_k = mp T_k,  Snorm = meas,
//     T_k = mT s1_k(cp, sn itau, w) + s2_k(px, py, w)  (the eps-contractions),
// and with g_k = w_node [s] G_k the weighted cotangents (s the remap's
// jacobian, on the reduced sums in the forward):
//     g_mp = sum_k g_k T_k,  g_meas = g_mp pref + g_4,  g_pref = g_mp meas,
//     g_f0 = g_meas p.dsigma - g_pref pm sign,  g_pds = g_meas f0,
//     g_arg = -g_f0 f0 q (common.fermi_bose's derivative: exactly 0 where
//     exp overflows),  g_T_k = g_k mp.
// The cell fields are linear in those terms with coefficients cp, sn, px,
// py (and itau, the vorticity), and Delta moves cp and sn: d cp / d Delta
// = sn and back, so eta (3+1D, -) and y_flow (the remap, +) get
// sn d/dcp + cp d/dsn.  A massless species has pm = -inf: the chain is
// formed as the plain version forms it, so its NaN and inf reach the same
// columns (JAX's reverse does the same).
//
// What bounds it on this card: FP32 issue.  Each evaluation recomputes the
// forward (an exp and a reciprocal beside ~10 FP32 operations) and adds
// the chain rule and the sums, ~38 FP32 operations with the factors of
// fewer indices hoisted (kernels/polzn.py, polzn_backward_formula_ops);
// the cells of a group are 1.2 MB and G, read once a block, stays in L2.
//
// Design: the backward family of csrc/vah_bwd.cu and feqmod_bwd.cu.
//   * A thread owns one (cell, node) pair and walks every (species, pT,
//     phi); a block holds CT = 128 / R cells x all nodes, so nothing of a
//     cell's sum leaves the block.
//   * G is staged a tile at a time: PT rows (pT) of one species, of each
//     of the five sums (3+1D: one row of F x R values; 2+1D: up to 8 rows
//     of F values), copied with cp.async (16 bytes a copy where the slab
//     is whole 16-byte vectors on both sides, else an element) into one of
//     two buffers while the other is consumed, beside the rows' mT and the
//     remap's jacobian: one barrier a tile.  In 3+1D a block copies 5 / CT
//     of a G value an evaluation: the 16-byte copies took K12a from 279 to
//     241 ms a main-shape group (their loop held 30 registers fewer: 20
//     warps an SM, not 16; PERF.md).  The momentum points (px, py; the
//     remap's pT cos phi, pT sin phi) are staged once a block.
//   * The thread forms its node kinematics cp, sn once per (species, pT)
//     (at fixed nodes from its cosh and sinh, with the remap from e^+-y_flow
//     and the node table, as the forward kernel), the row's composites, then
//     runs the n_phi points, whose sixteen sums (the p.dsigma and u.p
//     cotangents and x px, py; the four g_T_k and six of their px, py
//     products) run in T.  Each row's sums times the row's factors (and the
//     weight) are added in T to registers, one a column the mode touches,
//     which are added in float64 to the thread's accumulators in shared
//     memory once a species: a float32 register holds a species' P x F =
//     768 terms before float64 takes over, as in vah_bwd.cu.
//   * No atomics.  At the end the block adds each cell's nodes in node
//     order in float64 and one thread writes each entry: two launches give
//     identical bits.
//   * float32 takes the forward kernel's instructions (folded.cuh's
//     Fn<float>): ex2.approx on the argument pre-scaled by log2(e) and
//     rcp.approx, +inf -> 0, so an overflowed exponential gives f0 = 0 and
//     every term of the evaluation exactly 0; float64 keeps IEEE arithmetic.
// A first version: simple and right, with one A/B'd step (the 16-byte
// copies); its time against its bound is in PERF.md.

#include <cuda_runtime.h>

#include "bwd_stage.cuh"
#include "folded.cuh"
#include "polzn.cuh"

namespace {

using namespace is3d;

constexpr int BLOCK = 128;       // most threads a block: CT cells x nodes
constexpr int PT2 = 8;           // pT rows a tile without the node axis
constexpr size_t MAX_SMEM = 232448;

enum Mode { FIXED3 = 0, FIXED2 = 1, REMAP = 2 };

// the columns a mode touches (PwField order): 3+1D eta .. wyn, 2+1D fixed
// dat .. wyn (its Delta does not move with the cell), the remap dat ..
// y_flow; tau enters through dant, itau, tun_T and y_flow only
template <int MODE> struct PCols;
template <> struct PCols<FIXED3> : Cols<W_ETA, W_YFLOW> {};
template <> struct PCols<FIXED2> : Cols<W_DAT, W_YFLOW> {};
template <> struct PCols<REMAP> : Cols<W_DAT, NW> {};

__host__ __device__ constexpr int n_slots(int mode) {
  return mode == FIXED3 ? PCols<FIXED3>::N
         : mode == FIXED2 ? PCols<FIXED2>::N : PCols<REMAP>::N;
}

// pT rows a tile: one in 3+1D (G has the node axis), else up to PT2
__host__ __device__ inline int tile_rows(int mode, int P) {
  return mode == FIXED3 ? 1 : (P < PT2 ? P : PT2);
}

// shared memory: the float64 accumulators (NC slots of nt), the momentum
// points, the block's cell rows and two stage buffers (a tile of each of
// the five G's, then its rows' mT and jacobian)
template <typename T>
struct Smem {
  double* acc;
  Pt2<T>* tab;
  T *raw, *stage;
  int GS, SB;
  __host__ __device__ Smem(unsigned char* p, int nt, int NC, int CT, int P,
                           int F, int PT, int RG) {
    acc = reinterpret_cast<double*>(p);
    tab = reinterpret_cast<Pt2<T>*>(acc + (size_t)NC * nt);
    raw = reinterpret_cast<T*>(tab + P * F);
    // the stages 16-byte aligned, so a slab of whole 16-byte vectors copies
    // by cp_async16
    constexpr int V = 16 / sizeof(T);
    const size_t off = reinterpret_cast<size_t>(raw + CT * NW) -
                       reinterpret_cast<size_t>(p);
    stage = reinterpret_cast<T*>(p + (off + 15) / 16 * 16);
    GS = PT * F * RG;
    SB = (NSUM * GS + 2 * PT + V - 1) / V * V;
  }
  __host__ __device__ size_t bytes(const unsigned char* p) const {
    return reinterpret_cast<const unsigned char*>(stage + 2 * SB) - p;
  }
};

// grid (blocks of CT cells); thread t owns cell t / R of the block at node
// t % R.  xt, yt: px, py (n_pT, n_phi) at fixed nodes, cos, sin phi
// (n_phi) with the remap; nodes (fixed nodes) or table (the remap)
template <typename T, int MODE>
__device__ __forceinline__ void polzn_bwd_body(
    const T* __restrict__ cells, int n_cells, int CT,
    const T* __restrict__ mass, const T* __restrict__ sign,
    const T* __restrict__ pmv, int S, const T* __restrict__ pT, int P,
    const T* __restrict__ xt, const T* __restrict__ yt, int F,
    const T* __restrict__ nodes, const T* __restrict__ wR, int R,
    const T* __restrict__ table, T t_ref, const T* __restrict__ G,
    T* __restrict__ grad) {
  using Fx = Fn<T>;
  using C = PCols<MODE>;
  constexpr int NC = C::N;
  constexpr bool RG1 = MODE != FIXED3;           // G has no node axis
  const int RG = RG1 ? 1 : R;
  const int PT = tile_rows(MODE, P);
  const int TP = (P + PT - 1) / PT;              // tiles a species
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const Smem<T> s(smem_raw, nt, NC, CT, P, F, PT, RG);
  const int c0 = blockIdx.x * CT;
  const int nc = min(CT, n_cells - c0);
  const bool active = tid < nc * R;
  const int ci = active ? tid / R : 0, r = active ? tid - ci * R : 0;
  const size_t plane = (size_t)S * P * F * RG;   // one sum's cotangent

  // tile k: each sum's rows of G (cp.async into buffer k & 1), the rows'
  // mT and the remap's jacobian s(mT)
  auto issue = [&](int k) {
    const int sp = k / TP, p0 = (k - sp * TP) * PT;
    const int rows = min(PT, P - p0);
    T* dst = s.stage + (k & 1) * s.SB;
    const T* src = G + ((size_t)sp * P + p0) * F * RG;
    const int n = rows * F * RG;
    constexpr int V = 16 / sizeof(T);
    for (int q = 0; q < NSUM; ++q) {
      T* d = dst + q * s.GS;
      const T* gq = src + q * plane;
      if (n % V == 0 && ((reinterpret_cast<size_t>(d) |
                          reinterpret_cast<size_t>(gq)) & 15) == 0) {
        for (int i = tid * V; i < n; i += nt * V) cp_async16(d + i, gq + i);
      } else {
        for (int i = tid; i < n; i += nt) cp_async_elem(d + i, gq + i);
      }
    }
    cp_async_commit();
    T* mts = dst + NSUM * s.GS;
    const T m2 = mass[sp] * mass[sp];
    for (int i = tid; i < rows; i += nt) {
      const T pt = pT[p0 + i];
      const T mT = d_sqrt(m2 + pt * pt);
      mts[i] = mT;
      mts[PT + i] = MODE == REMAP ? d_sqrt(t_ref / (mT > t_ref ? mT : t_ref))
                                  : T(1);
    }
  };

  for (int i = tid; i < CT * NW; i += nt) {
    const int c = min(i / NW, nc - 1);
    s.raw[i] = cells[(size_t)(c0 + c) * NW + (i - (i / NW) * NW)];
  }
  stage_points(s.tab, static_cast<T*>(nullptr), xt, yt, pT, P, F,
               MODE == REMAP, tid, nt);
  for (int j = 0; j < NC; ++j) s.acc[(size_t)j * nt + tid] = 0.0;
  issue(0);
  __syncthreads();
  const T* g = s.raw + ci * NW;
  const T dat = g[W_DAT], dant = g[W_DANT], dax = g[W_DAX], day = g[W_DAY];
  const T utT = g[W_UT_T], tunT = g[W_TUN_T], itau = g[W_ITAU];
  const T wtx = g[W_WTX], wty = g[W_WTY], wtn = g[W_WTN];
  const T wxy = g[W_WXY], wxn = g[W_WXN], wyn = g[W_WYN];
  const T L = Fx::SCALE;
  const T nLux = -L * g[W_UX_T], nLuy = -L * g[W_UY_T];
  const T w = MODE == FIXED3 ? T(1) : wR[r];
  // fixed nodes: the thread's cosh and sinh; the remap: e^+-y_flow / 2
  T ch = T(1), sh = T(0), ey = T(0), eym = T(0);
  if (MODE != REMAP) {
    const T delta = MODE == FIXED3 ? nodes[r] - g[W_ETA] : -nodes[r];
    ch = d_cosh(delta);
    sh = d_sinh(delta);
  } else {
    ey = d_exp(g[W_YFLOW]);
    eym = d_exp(-g[W_YFLOW]);
  }

  T ra[NC];
  T sgn = T(0), pm = T(0), pms = T(0);
  const int n_tiles = S * TP;
  for (int k = 0; k < n_tiles; ++k) {
    const int sp = k / TP, p0 = (k - sp * TP) * PT;
    const int rows = min(PT, P - p0);
    cp_async_wait_all();
    __syncthreads();              // tile k has landed, tile k - 1 is consumed
    if (k + 1 < n_tiles) issue(k + 1);
    if (p0 == 0) {
#pragma unroll
      for (int j = 0; j < NC; ++j) ra[j] = T(0);
      sgn = sign[sp];
      pm = pmv[sp];
      pms = pm * sgn;
    }
    const T* st = s.stage + (k & 1) * s.SB;
    const T* mts = st + NSUM * s.GS;
    for (int q = 0; q < rows && active; ++q) {
      const T mT = mts[q];
      // the node kinematics of this (species, pT): cp = mT cosh(Delta), sn
      // = mT sinh(Delta); with the remap e^+-Delta = e^+-y_flow x the node
      // table's exp(-+s eta_r)
      T cp, sn;
      if (MODE != REMAP) {
        cp = mT * ch;
        sn = mT * sh;
      } else {
        const T hm = T(0.5) * mT;
        const T* tb = table + (((size_t)sp * P + p0 + q) * R + r) * 2;
        const T ep = ey * hm * tb[0];
        const T em = eym * hm * tb[1];
        cp = ep + em;
        sn = ep - em;
      }
      const T snt = sn * itau;
      const T A = fma(cp, dat, sn * dant);
      const T B = L * fma(cp, utT, -(sn * tunT));
      const T m0 = wxy * snt, m1 = fma(wyn, cp, wty * snt);
      const T m2 = -fma(wxn, cp, wtx * snt), m3 = wxy * cp;
      const T* gr = st + q * F * RG + (RG1 ? 0 : r);
      const Pt2<T>* tb = s.tab + (p0 + q) * F;
      // the row's sums over phi, in T
      T tP = 0, tPx = 0, tPy = 0, tA = 0, tAx = 0, tAy = 0;
      T h0 = 0, h1 = 0, h2 = 0, h3 = 0;
      T h0x = 0, h0y = 0, h1y = 0, h2x = 0, h3x = 0, h3y = 0;
      for (int f = 0; f < F; ++f) {
        const Pt2<T> v = tb[f];
        const T x = v.x, y = v.y;
        const T* gf = gr + f * RG;
        const T g0 = gf[0], g1 = gf[s.GS], g2 = gf[2 * s.GS];
        const T g3 = gf[3 * s.GS], g4 = gf[4 * s.GS];
        const T pds = fma(dax, x, fma(day, y, A));
        const T arg = fma(nLux, x, fma(nLuy, y, B));
        const T f0 = Fx::rcp(Fx::exp_scaled(arg) + sgn);
        const T qf = fma(-sgn, f0, T(1));
        const T pref = pm * qf;
        const T meas = pds * f0;
        const T mp = meas * pref;
        const T T0 = fma(wyn, x, fma(-wxn, y, m0));
        const T T1 = fma(-wtn, y, m1);
        const T T2 = fma(wtn, x, m2);
        const T T3 = fma(wtx, y, fma(-wty, x, m3));
        const T gmp = fma(g0, T0, fma(g1, T1, fma(g2, T2, g3 * T3)));
        const T gme = fma(gmp, pref, g4);
        const T gpr = gmp * meas;
        const T gf0 = fma(gme, pds, -(gpr * pms));
        const T ga = -(gf0 * f0) * qf;
        const T gp = gme * f0;
        tP += gp;
        tPx = fma(gp, x, tPx);
        tPy = fma(gp, y, tPy);
        tA += ga;
        tAx = fma(ga, x, tAx);
        tAy = fma(ga, y, tAy);
        const T k0 = g0 * mp, k1 = g1 * mp, k2 = g2 * mp, k3 = g3 * mp;
        h0 += k0;
        h1 += k1;
        h2 += k2;
        h3 += k3;
        h0x = fma(k0, x, h0x);
        h0y = fma(k0, y, h0y);
        h1y = fma(k1, y, h1y);
        h2x = fma(k2, x, h2x);
        h3x = fma(k3, x, h3x);
        h3y = fma(k3, y, h3y);
      }
      // the weight (with the remap times the jacobian s(mT)) on the sums
      const T wj = MODE == REMAP ? w * mts[PT + q] : w;
      tP *= wj; tPx *= wj; tPy *= wj; tA *= wj; tAx *= wj; tAy *= wj;
      h0 *= wj; h1 *= wj; h2 *= wj; h3 *= wj;
      h0x *= wj; h0y *= wj; h1y *= wj; h2x *= wj; h3x *= wj; h3y *= wj;
      // the row into the species' registers
      radd<C, W_DAT>(ra, cp * tP);
      radd<C, W_DANT>(ra, sn * tP);
      radd<C, W_DAX>(ra, tPx);
      radd<C, W_DAY>(ra, tPy);
      radd<C, W_UT_T>(ra, cp * tA);
      radd<C, W_TUN_T>(ra, -(sn * tA));
      radd<C, W_UX_T>(ra, -tAx);
      radd<C, W_UY_T>(ra, -tAy);
      radd<C, W_WXY>(ra, fma(snt, h0, cp * h3));
      radd<C, W_WYN>(ra, fma(cp, h1, h0x));
      radd<C, W_WXN>(ra, -fma(cp, h2, h0y));
      radd<C, W_WTY>(ra, fma(snt, h1, -h3x));
      radd<C, W_WTN>(ra, h2x - h1y);
      radd<C, W_WTX>(ra, fma(-snt, h2, h3y));
      // sn itau enters the four s1: itau gets sn x its cotangent
      const T gst = fma(wxy, h0, fma(wty, h1, -(wtx * h2)));
      radd<C, W_ITAU>(ra, sn * gst);
      if constexpr (MODE != FIXED2) {
        // d/dDelta: d cp / dDelta = sn and back
        const T gcp = fma(dat, tP, fma(utT, tA, fma(wyn, h1,
                          fma(-wxn, h2, wxy * h3))));
        const T gsn = fma(dant, tP, fma(-tunT, tA, itau * gst));
        const T gdel = fma(sn, gcp, cp * gsn);
        if constexpr (MODE == FIXED3)
          radd<C, W_ETA>(ra, -gdel);                    // Delta = y - eta
        else
          radd<C, W_YFLOW>(ra, gdel);                   // y_flow - s eta_r
      }
    }
    if (p0 + rows == P) {         // the species' last tile: into float64
#pragma unroll
      for (int j = 0; j < NC; ++j)
        s.acc[(size_t)j * nt + tid] += (double)ra[j];
    }
  }
  cp_async_wait_all();
  __syncthreads();
  // each cell's gradient: its nodes added in node order (0 in the columns
  // the mode leaves untouched)
  for (int i = tid; i < nc * NW; i += nt) {
    const int c = i / NW, k = i - c * NW;
    const int j = C::slot(k);
    double v = 0.0;
    if (j >= 0)
      for (int rr = 0; rr < R; ++rr) v += s.acc[(size_t)j * nt + c * R + rr];
    grad[(size_t)(c0 + c) * NW + k] = (T)v;
  }
}

#define IS3D_PBWD_PARAMS                                                      \
  const T *__restrict__ cells, int n_cells, int CT,                          \
      const T *__restrict__ mass, const T *__restrict__ sign,                \
      const T *__restrict__ pmv, int S, const T *__restrict__ pT, int P,     \
      const T *__restrict__ xt, const T *__restrict__ yt, int F,             \
      const T *__restrict__ nodes, const T *__restrict__ wR, int R,          \
      const T *__restrict__ table, T t_ref, const T *__restrict__ G,         \
      T *__restrict__ grad
#define IS3D_PBWD_ARGS                                                        \
  cells, n_cells, CT, mass, sign, pmv, S, pT, P, xt, yt, F, nodes, wR, R,    \
      table, t_ref, G, grad

// K12a: fixed nodes (3+1D, 2+1D)
template <typename T, int DIM>
__global__ void __launch_bounds__(BLOCK)
polzn_bwd_kernel(IS3D_PBWD_PARAMS) {
  polzn_bwd_body<T, DIM == 3 ? FIXED3 : FIXED2>(IS3D_PBWD_ARGS);
}

// K12b: the 2+1D mT remap
template <typename T>
__global__ void __launch_bounds__(BLOCK)
polzn_remap_bwd_kernel(IS3D_PBWD_PARAMS) {
  polzn_bwd_body<T, REMAP>(IS3D_PBWD_ARGS);
}

// cells a block, its threads and its shared memory for a shape, or an
// error code
template <typename T>
int blocking(int mode, int P, int F, int R, int* CT, int* threads,
             size_t* smem) {
  if (R < 1 || R > BLOCK || F < 1 || P < 1) return cudaErrorInvalidValue;
  *CT = BLOCK / R;
  *threads = (*CT * R + 31) / 32 * 32;
  const Smem<T> s(nullptr, *threads, n_slots(mode), *CT, P, F,
                  tile_rows(mode, P), mode == FIXED3 ? R : 1);
  *smem = s.bytes(nullptr);
  return *smem > MAX_SMEM ? (int)cudaErrorInvalidValue : 0;
}

// the kernel of (T, mode), or nullptr
template <typename T>
const void* kernel_of(int mode) {
  return mode == FIXED3 ? (const void*)polzn_bwd_kernel<T, 3>
         : mode == FIXED2 ? (const void*)polzn_bwd_kernel<T, 2>
         : mode == REMAP ? (const void*)polzn_remap_bwd_kernel<T> : nullptr;
}

template <typename T>
int launch(int mode, const void* cells, int n_cells, int nw,
           const void* mass, const void* sign, const void* pm, int S,
           const void* pT, int P, const void* xt, const void* yt, int F,
           const void* nodes, const void* wR, int R, const void* table,
           double t_ref, const void* G, void* grad, void* stream_v) {
  if (nw != NW || n_cells < 0 || S < 1 || P < 1 ||
      (mode == REMAP && (table == nullptr || !(t_ref > 0.0))) ||
      (mode != REMAP && nodes == nullptr))
    return cudaErrorInvalidValue;
  if (n_cells == 0) return cudaSuccess;
  const void* kern = kernel_of<T>(mode);
  if (kern == nullptr) return cudaErrorInvalidValue;
  int CT, threads;
  size_t smem;
  const int rc = blocking<T>(mode, P, F, R, &CT, &threads, &smem);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const T* cells_ = static_cast<const T*>(cells);
  const T* mass_ = static_cast<const T*>(mass);
  const T* sign_ = static_cast<const T*>(sign);
  const T* pm_ = static_cast<const T*>(pm);
  const T* pT_ = static_cast<const T*>(pT);
  const T* xt_ = static_cast<const T*>(xt);
  const T* yt_ = static_cast<const T*>(yt);
  const T* nodes_ = static_cast<const T*>(nodes);
  const T* wR_ = static_cast<const T*>(wR);
  const T* table_ = static_cast<const T*>(table);
  T t_ref_ = (T)t_ref;
  const T* G_ = static_cast<const T*>(G);
  T* grad_ = static_cast<T*>(grad);
  void* args[] = {&cells_, &n_cells, &CT, &mass_, &sign_, &pm_, &S, &pT_,
                  &P, &xt_, &yt_, &F, &nodes_, &wR_, &R, &table_, &t_ref_,
                  &G_, &grad_};
  const unsigned blocks = (unsigned)((n_cells + CT - 1) / CT);
  e = cudaLaunchKernel(kern, dim3(blocks), dim3(threads), args, smem,
                       static_cast<cudaStream_t>(stream_v));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// out: cells a block, threads, shared memory bytes, resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers a thread and
// local memory bytes a thread (spills) of one instantiation at one shape
template <typename T>
int props(int mode, int P, int F, int R, int* out) {
  const void* kern = kernel_of<T>(mode);
  if (kern == nullptr) return cudaErrorInvalidValue;
  int CT, threads;
  size_t smem;
  const int rc = blocking<T>(mode, P, F, R, &CT, &threads, &smem);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return (int)e;
  out[0] = CT;
  out[1] = threads;
  out[2] = (int)smem;
  out[3] = blocks;
  out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;
  return 0;
}

}  // namespace

extern "C" {

// K12a, fixed nodes (3+1D, 2+1D): grad (n_cells, NW) of <G, the five sums>
#define IS3D_PBWD_ENTRY(NAME, T)                                              \
  int NAME(const void* cells, int n_cells, int nw, const void* mass,         \
           const void* sign, const void* pm, int S, const void* pT,          \
           const void* px, const void* py, int P, int F, const void* nodes,  \
           const void* wR, int R, int dim, const void* G, void* grad,        \
           void* stream) {                                                   \
    if (dim != 2 && dim != 3) return cudaErrorInvalidValue;                 \
    return launch<T>(dim == 3 ? FIXED3 : FIXED2, cells, n_cells, nw, mass,   \
                     sign, pm, S, pT, P, px, py, F, nodes, wR, R, nullptr,   \
                     0.0, G, grad, stream);                                  \
  }
IS3D_PBWD_ENTRY(is3d_polzn_bwd_f32, float)
IS3D_PBWD_ENTRY(is3d_polzn_bwd_f64, double)
#undef IS3D_PBWD_ENTRY

// K12b, the 2+1D mT remap: table (S, P, R, 2) = exp(-s eta_r), exp(+s
// eta_r), t_ref the remap's T_ref (its jacobian s(mT))
#define IS3D_PBWD_REMAP_ENTRY(NAME, T)                                        \
  int NAME(const void* cells, int n_cells, int nw, const void* mass,         \
           const void* sign, const void* pm, int S, const void* pT, int P,   \
           const void* cos_phi, const void* sin_phi, int F,                  \
           const void* table, const void* wR, int R, double t_ref,           \
           const void* G, void* grad, void* stream) {                        \
    return launch<T>(REMAP, cells, n_cells, nw, mass, sign, pm, S, pT, P,    \
                     cos_phi, sin_phi, F, nullptr, wR, R, table, t_ref, G,   \
                     grad, stream);                                          \
  }
IS3D_PBWD_REMAP_ENTRY(is3d_polzn_bwd_remap_f32, float)
IS3D_PBWD_REMAP_ENTRY(is3d_polzn_bwd_remap_f64, double)
#undef IS3D_PBWD_REMAP_ENTRY

// props<T> of (f64, dim: 3, 2 fixed nodes or 0 the remap) at (P, F, R)
int is3d_polzn_bwd_props(int f64, int dim, int P, int F, int R, int* out) {
  if (dim != 0 && dim != 2 && dim != 3) return cudaErrorInvalidValue;
  const int mode = dim == 3 ? FIXED3 : dim == 2 ? FIXED2 : REMAP;
  return f64 ? props<double>(mode, P, F, R, out)
             : props<float>(mode, P, F, R, out);
}

const char* is3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
