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
// the order of polzn.cuh's `PwField`; the node weights wR; the five sums'
// cotangents G (5, n_species, n_pT, n_phi, n_out) (n_out = n_nodes in 3+1D,
// 1 in 2+1D), laid out by the wrapper for each kernel's stages
// (fixed_bwd_stage, remap_bwd_stage); with the remap the node table
// exp(-+s eta_r) of kernels/smooth.py:remap_node_table (K1's and K6's).
// Output: grad (n_cells, NW), every row written once.
//
// The formula (the plain version's, kernels/polzn.py:polzn_block, under
// torch autograd).  At one evaluation (cell, node, species, pT, phi), with
// cp = mT cosh(Delta), sn = mT sinh(Delta), Delta = y - eta (3+1D), -eta_r
// (2+1D fixed) or y_flow - s eta_r (the remap), pm = -0.25 / m:
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
// the chain rule and the sums, 35 FP32 operations with the factors of
// fewer indices hoisted (kernels/polzn.py, polzn_backward_formula_ops);
// the cells of a group are 1.2 MB and G, read once a block, stays in L2.
//
// Design of the fixed-node kernel (K12a), after K9a
// (smooth_spectra_bwd.cu): the node kinematics are the thread's constants,
// so the species go innermost and everything of fewer indices is hoisted.
//   * A thread owns one (cell, node) pair, thread t node t / CT of cell
//     t % CT (a warp's threads read a few nodes' cotangents: one shared
//     wavefront a load); a block holds CT = FIX_BLOCK / R cells x all
//     nodes, so nothing of a cell's sum leaves the block.  It walks pT
//     rows, then groups of fix_u angles, then chunks of SC species, the
//     species' row (one 16-byte load) shared by the group's fix_u
//     independent chains.
//   * Hoisted: once a thread mT's coefficients of p.dsigma (Ar), of
//     L u.p / T (Br) and of the four T_k (ck); once a point the px, py
//     parts of the same six terms.  An evaluation is then one FMA each,
//     35 FP32 with its twelve sums (g_T_k = g_k mp fused into theirs) and
//     two MUFU.
//   * Staging: one stage a (pT row, angle group, species chunk), by
//     cp.async 16 bytes a copy into one of two buffers while the other is
//     consumed (bwd_stage.cuh), one barrier a stage.  The wrapper lays G
//     out once a launch (kernels/polzn.py:fixed_bwd_stage) so a stage is
//     one contiguous run: a species' values at the group's angles, per
//     angle and node g0..g3 as one 16-byte vector, then g4 at the angles
//     (one 8-byte load), RU values padded to 16 bytes; beside them each
//     (pT, species) row's mT, sign, pm, pm sign as 16 bytes.  SC: the
//     fewest chunks whose two stages fit the shared memory of
//     FIX_MIN_BLOCKS blocks an SM (fixed_plan).
//   * The accumulator.  A point's twelve sums over the species (g_pds,
//     g_arg and the four g_T_k, each plain and times mT) run in T over S
//     terms and go to the thread's float64 sums in shared memory once a
//     point, the px, py products then (NA = 16 sums: ten of px, py, six
//     of mT).  At the end each thread turns them into its NC gradients
//     with the node's cosh, sinh, itau and weight (finalize).
//
// Design of the 2+1D mT remap (K12b), where the node moves with (species,
// pT): Delta = y_flow - s(mT) eta_r, so the species stay outermost.
//   * A thread owns one (cell, node) pair, t / R and t % R; a block holds
//     CT = REMAP_BLOCK / R cells.  It walks species, then pT rows, then
//     phi (unrolled REMAP_UNROLL: independent chains); per row it forms
//     cp, sn from the node table and the row's composites once.
//   * The (cell, phi) terms at unit pT, staged once a block (a 16-byte
//     vector, the cell's row padded by one so a warp's two cells take
//     different banks): p.dsigma's and L u.p / T's px, py parts and T0's
//     and T3's.  p.dsigma, u.p and the four T_k are then one FMA each
//     with the row's pT.  The px, py sums run on cos phi, sin phi and are
//     multiplied by pT once a row; g_T_k folds into them (mp cos, mp sin
//     formed once a point).
//   * Staging: tiles of REMAP_PT pT rows of one species by cp.async 16
//     bytes a copy, double-buffered, one barrier a tile.  The wrapper
//     lays G out once a launch (kernels/polzn.py:remap_bwd_stage): per
//     (species, pT, phi) g0..g3 | g4, cos phi, sin phi, 0, two 16-byte
//     broadcast loads, the jacobian s(mT) folded in; the node weight
//     multiplies each node's float64 sums at the end.
//   * The accumulator: a row's sixteen sums run in T over n_phi; the row
//     adds them times its factors to one register a column, added in
//     float64 to the thread's sums in shared memory once a species (P x F
//     terms in T).
//
// Both:
//   * No atomics.  At the end the block adds each cell's nodes in node
//     order in float64 and one thread writes each entry: two launches give
//     identical bits.
//   * float32 takes the forward kernel's instructions (folded.cuh's
//     Fn<float>): ex2.approx on the argument pre-scaled by log2(e) and
//     rcp.approx, +inf -> 0, so an overflowed exponential gives f0 = 0 and
//     every term of the evaluation exactly 0; float64 keeps IEEE arithmetic.
// Its time against its bound is in PERF.md.

#include <cuda_runtime.h>

#include "bwd_stage.cuh"
#include "folded.cuh"
#include "polzn.cuh"

namespace {

using namespace is3d;

// K12a's: most threads a block (CT cells x nodes), the blocks of that size
// an SM float32 registers and the stages' shared memory are budgeted for
// (16 warps), the angles a thread evaluates at once (independent chains).
// By A/B on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): 128-thread
// blocks 4 an SM against 5 0.938 (3 lost); 2 blocks of 256 against 4 of
// 128 0.972 (one of 384 or 512 lost); in 3+1D 4 angles against 2 0.972
// (3 tie, 1 lost at every block shape), in 2+1D 2 against 4 0.942 (4
// spill 16 bytes at the 128 registers, 1 lost); the species loop
// unrolled 2 spills
constexpr int FIX_BLOCK = 256;
constexpr int FIX_MIN_BLOCKS = 2;
constexpr int FIX_U3 = 4;        // 3+1D
constexpr int FIX_U2 = 2;        // 2+1D fixed nodes
// K12b's: most threads a block, pT rows a stage, and the phi loop's
// unroll.  By A/B: unrolled 8 against 4 0.968, 4 against 2 0.965, 2
// against 1 0.972, 12 lost; 16 rows a stage against 8 0.988-0.993, 4
// lost; 192-thread blocks lost
constexpr int REMAP_BLOCK = 128;
constexpr int REMAP_PT = 16;
constexpr int REMAP_UNROLL = 8;
constexpr int GV = 8;            // K12b's values a (species, pT, phi) point
constexpr size_t MAX_SMEM = 232448;

enum Mode { FIXED3 = 0, FIXED2 = 1, REMAP = 2 };

// K12a's angles a stage in a mode, and the most of the two
__host__ __device__ constexpr int fix_u(int mode) {
  return mode == FIXED3 ? FIX_U3 : FIX_U2;
}
constexpr int FIX_U_MAX = FIX_U3 > FIX_U2 ? FIX_U3 : FIX_U2;

// the columns a mode touches (PwField order): 3+1D eta .. wyn, 2+1D fixed
// dat .. wyn (its Delta does not move with the cell), the remap dat ..
// y_flow; tau enters through dant, itau, tun_T and y_flow only
template <int MODE> struct PCols;
template <> struct PCols<FIXED3> : Cols<W_ETA, W_YFLOW> {};
template <> struct PCols<FIXED2> : Cols<W_DAT, W_YFLOW> {};
template <> struct PCols<REMAP> : Cols<W_DAT, NW> {};

// K12a's float64 sums a thread carries: ten px, py products (Gpx, Gpy,
// Gax, Gay, K0x, K0y, K1y, K2x, K3x, K3y), then six mT sums (MP, MA, MK0 ..
// MK3); a point's twelve sums in T (NQ: gp, gp mT, ga, ga mT, k0 .. k3,
// k0 mT .. k3 mT)
constexpr int NA = 16;
constexpr int NQ = 12;
static_assert(NA >= PCols<FIXED3>::N && NA >= PCols<FIXED2>::N,
              "the end's gradients reuse the sums' shared memory");

// r[slot(K)] = v for a column K the body touches
template <class C, int K>
__device__ __forceinline__ void put(double* o, double v) {
  static_assert(C::slot(K) >= 0, "a column outside the body's slots");
  o[C::slot(K)] = v;
}

// K12a's stage row: the values a species of one stage holds (per angle
// and node g0..g3, then g4 per node and angle), padded to whole 16-byte
// copies
template <typename T>
__host__ __device__ constexpr int fixed_stage_row(int mode, int R) {
  constexpr int V = 16 / (int)sizeof(T);
  return ((mode == FIXED3 ? R : 1) * fix_u(mode) * NSUM + V - 1) / V * V;
}

// K12a's shared memory: the float64 sums (NA slots of nt; the end's
// per-(cell, node) gradients, nt x NC, over them), two stage buffers and
// the block's cell rows.  A buffer holds one stage: SC species' stage rows
// (RU values each; fixed_bwd_stage in kernels/polzn.py lays G out so),
// their rows (mT, sign, pm, pm sign) at the stage's pT, and the angles'
// px, py.
template <typename T>
struct FSmem {
  size_t stage_, rows_, xy_, sz_, raw_, end_;
  __host__ __device__ FSmem(int nt, int CT, int RU, int SC) {
    stage_ = align16((size_t)NA * nt * sizeof(double));
    rows_ = align16((size_t)SC * RU * sizeof(T));
    xy_ = rows_ + (size_t)SC * 4 * sizeof(T);
    sz_ = align16(xy_ + (size_t)FIX_U_MAX * 2 * sizeof(T));
    raw_ = stage_ + 2 * sz_;
    end_ = raw_ + (size_t)CT * NW * sizeof(T);
  }
  __device__ T* buf(unsigned char* p, int b, size_t part = 0) const {
    return reinterpret_cast<T*>(p + stage_ + b * sz_ + part);
  }
};

// K12a's gradient of one (cell, node) from its float64 sums a (NA, in the
// order above), into o (NC slots), times the node weight w
template <typename T, int MODE>
__device__ __forceinline__ void finalize(const T* g, const double* a,
                                         double ch, double sh, double w,
                                         double* o) {
  using C = PCols<MODE>;
  const double itau = g[W_ITAU], dat = g[W_DAT], dant = g[W_DANT];
  const double utT = g[W_UT_T], tunT = g[W_TUN_T];
  const double wtx = g[W_WTX], wty = g[W_WTY], wxy = g[W_WXY];
  const double wxn = g[W_WXN], wyn = g[W_WYN];
  const double Gpx = a[0], Gpy = a[1], Gax = a[2], Gay = a[3];
  const double K0x = a[4], K0y = a[5], K1y = a[6], K2x = a[7];
  const double K3x = a[8], K3y = a[9];
  const double MP = a[10], MA = a[11];
  const double MK0 = a[12], MK1 = a[13], MK2 = a[14], MK3 = a[15];
  const double shi = sh * itau;
  put<C, W_DAT>(o, ch * MP);
  put<C, W_DANT>(o, sh * MP);
  put<C, W_DAX>(o, Gpx);
  put<C, W_DAY>(o, Gpy);
  put<C, W_UT_T>(o, ch * MA);
  put<C, W_TUN_T>(o, -(sh * MA));
  put<C, W_UX_T>(o, -Gax);
  put<C, W_UY_T>(o, -Gay);
  put<C, W_WXY>(o, shi * MK0 + ch * MK3);
  put<C, W_WYN>(o, ch * MK1 + K0x);
  put<C, W_WXN>(o, -(ch * MK2 + K0y));
  put<C, W_WTY>(o, shi * MK1 - K3x);
  put<C, W_WTN>(o, K2x - K1y);
  put<C, W_WTX>(o, -(shi * MK2) + K3y);
  // sn itau enters the four s1: itau gets sn x its cotangent
  const double gst = wxy * MK0 + wty * MK1 - wtx * MK2;
  put<C, W_ITAU>(o, sh * gst);
  if constexpr (MODE == FIXED3) {
    // d/dDelta: d cp / dDelta = sn and back; Delta = y - eta
    const double gcp = dat * MP + utT * MA + wyn * MK1 - wxn * MK2 +
                       wxy * MK3;
    const double gsn = dant * MP - tunT * MA + itau * gst;
    put<C, W_ETA>(o, -(sh * gcp + ch * gsn));
  }
  for (int j = 0; j < C::N; ++j) o[j] *= w;
}

// K12a, fixed nodes: grid (blocks of CT cells); thread t owns node t / CT
// of cell t % CT and walks pT rows, then groups of U = fix_u angles, then
// chunks of SC species (one stage each), the species inside a stage
// evaluated at the group's U angles at once.  A point's NQ sums run in
// T over every species and go to the thread's float64 sums once a point.
// rows (P, S, 4) and Gst (P, ceil(F / U), S, RU): fixed_bwd_stage's.
template <typename T, int MODE>
__device__ __forceinline__ void fixed_bwd_body(
    const T* __restrict__ cells, int n_cells, int CT, int S, int SC, int P,
    const T* __restrict__ px, const T* __restrict__ py, int F,
    const T* __restrict__ nodes, const T* __restrict__ wR, int R, int RU,
    const T* __restrict__ rows, const T* __restrict__ Gst,
    T* __restrict__ grad) {
  using Fx = Fn<T>;
  using C = PCols<MODE>;
  constexpr int NC = C::N;
  constexpr int U = fix_u(MODE);
  constexpr int V = 16 / sizeof(T);            // values a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const FSmem<T> s(nt, CT, RU, SC);
  double* acc = reinterpret_cast<double*>(smem_raw);
  T* raw = reinterpret_cast<T*>(smem_raw + s.raw_);
  const int c0 = blockIdx.x * CT;
  const int nc = min(CT, n_cells - c0);
  const bool active = tid < CT * R && tid % CT < nc;
  const int r = active ? tid / CT : 0, ci = active ? tid % CT : 0;
  // the node's place in a species' stage row (G has no node axis in 2+1D)
  const int RG = MODE == FIXED3 ? R : 1, rg = MODE == FIXED3 ? r : 0;
  const int NFG = (F + U - 1) / U, NSC = (S + SC - 1) / SC;
  const int K = P * NFG * NSC;

  for (int i = tid; i < CT * NW; i += nt) {
    const int c = min(i / NW, nc - 1);
    raw[i] = cells[(size_t)(c0 + c) * NW + (i - (i / NW) * NW)];
  }
  for (int j = 0; j < NA; ++j) acc[(size_t)j * nt + tid] = 0.0;

  // stage k = (pT row p, angle group fg, species chunk sc) into buffer
  // k & 1: the stage rows and the rows by cp.async, 16 bytes a copy; the
  // angles' px, py by the threads
  auto issue = [&](int k) {
    const int sc = k % NSC, pf = k / NSC;
    const int fg = pf % NFG, p = pf / NFG;
    const int s0 = sc * SC, ns = min(SC, S - s0);
    T* gs = s.buf(smem_raw, k & 1);
    const T* g0 = Gst + (((size_t)p * NFG + fg) * S + s0) * RU;
    for (int i = tid * V; i < ns * RU; i += nt * V) cp_async16(gs + i, g0 + i);
    T* rs = s.buf(smem_raw, k & 1, s.rows_);
    const T* r0 = rows + ((size_t)p * S + s0) * 4;
    for (int i = tid * V; i < ns * 4; i += nt * V) cp_async16(rs + i, r0 + i);
    cp_async_commit();
    const int f0 = fg * U, nu = min(U, F - f0);
    T* xy = s.buf(smem_raw, k & 1, s.xy_);
    for (int u = tid; u < U; u += nt) {
      xy[2 * u] = u < nu ? px[p * F + f0 + u] : T(0);
      xy[2 * u + 1] = u < nu ? py[p * F + f0 + u] : T(0);
    }
  };
  issue(0);
  __syncthreads();                // the cell rows are in

  const T* g = raw + ci * NW;
  const T dax = g[W_DAX], day = g[W_DAY];
  const T wtx = g[W_WTX], wty = g[W_WTY], wtn = g[W_WTN];
  const T wxy = g[W_WXY], wxn = g[W_WXN], wyn = g[W_WYN];
  const T L = Fx::SCALE;
  const T nLux = -L * g[W_UX_T], nLuy = -L * g[W_UY_T];
  // the thread's node kinematics and mT's coefficients: p.dsigma = mT Ar +
  // (dax px + day py), L u.p / T = mT Br + .., T_k = mT ck + s2_k
  const T delta = MODE == FIXED3 ? nodes[r] - g[W_ETA] : -nodes[r];
  const T ch = d_cosh(delta), sh = d_sinh(delta);
  const T shi = sh * g[W_ITAU];
  const T Ar = fma(ch, g[W_DAT], sh * g[W_DANT]);
  const T Br = L * fma(ch, g[W_UT_T], -(sh * g[W_TUN_T]));
  const T k0 = wxy * shi, k1 = fma(wyn, ch, wty * shi);
  const T k2 = -fma(wxn, ch, wtx * shi), k3 = wxy * ch;

  T q[U][NQ];
  T W[U][6];                      // a point's px, py parts of the six terms
  for (int k = 0; k < K; ++k) {
    cp_async_wait_all();
    __syncthreads();              // stage k has landed, stage k - 1 is consumed
    if (k + 1 < K) issue(k + 1);
    if (!active) continue;
    const int sc = k % NSC;
    const int ns = min(SC, S - sc * SC);
    const int b = k & 1;
    const T* xy = s.buf(smem_raw, b, s.xy_);
    if (sc == 0) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const T x = xy[2 * u], y = xy[2 * u + 1];
        W[u][0] = fma(dax, x, day * y);
        W[u][1] = fma(nLux, x, nLuy * y);
        W[u][2] = fma(wyn, x, -(wxn * y));
        W[u][3] = -(wtn * y);
        W[u][4] = wtn * x;
        W[u][5] = fma(wtx, y, -(wty * x));
#pragma unroll
        for (int j = 0; j < NQ; ++j) q[u][j] = T(0);
      }
    }
    const T* gs = s.buf(smem_raw, b);
    const T* rs = s.buf(smem_raw, b, s.rows_);
    for (int sl = 0; sl < ns; ++sl) {
      T mT, sgn, pm, pms;
      Fx::ld4(rs + 4 * sl, mT, sgn, pm, pms);
      const T* gr = gs + sl * RU;
      T g4[U];
      ld_u<T, U>(gr + RG * U * 4 + rg * U, g4);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        T g0, g1, g2, g3;
        Fx::ld4(gr + (u * RG + rg) * 4, g0, g1, g2, g3);
        T* a = q[u];
        const T pds = fma(mT, Ar, W[u][0]);
        const T arg = fma(mT, Br, W[u][1]);
        const T f0 = Fx::rcp(Fx::exp_scaled(arg) + sgn);
        const T qf = fma(-sgn, f0, T(1));
        const T pref = pm * qf;
        const T meas = pds * f0;
        const T mp = meas * pref;
        const T T0 = fma(mT, k0, W[u][2]);
        const T T1 = fma(mT, k1, W[u][3]);
        const T T2 = fma(mT, k2, W[u][4]);
        const T T3 = fma(mT, k3, W[u][5]);
        const T gmp = fma(g0, T0, fma(g1, T1, fma(g2, T2, g3 * T3)));
        const T gme = fma(gmp, pref, g4[u]);
        const T gpr = gmp * meas;
        const T gf0 = fma(gme, pds, -(gpr * pms));
        const T ga = -(gf0 * f0) * qf;
        const T gp = gme * f0;
        const T mpm = mp * mT;
        a[0] += gp;
        a[1] = fma(gp, mT, a[1]);
        a[2] += ga;
        a[3] = fma(ga, mT, a[3]);
        a[4] = fma(g0, mp, a[4]);
        a[5] = fma(g1, mp, a[5]);
        a[6] = fma(g2, mp, a[6]);
        a[7] = fma(g3, mp, a[7]);
        a[8] = fma(g0, mpm, a[8]);
        a[9] = fma(g1, mpm, a[9]);
        a[10] = fma(g2, mpm, a[10]);
        a[11] = fma(g3, mpm, a[11]);
      }
    }
    if (sc == NSC - 1) {
      // the points' sums into float64, once a point
      const int f0 = ((k / NSC) % NFG) * U, nu = min(U, F - f0);
      double* ac = acc + tid;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u >= nu) break;
        const T* a = q[u];
        const double X = xy[2 * u], Y = xy[2 * u + 1];
        const double gp = a[0], ga = a[2];
        const double h0 = a[4], h1 = a[5], h2 = a[6], h3 = a[7];
        ac[0 * nt] += X * gp;
        ac[1 * nt] += Y * gp;
        ac[2 * nt] += X * ga;
        ac[3 * nt] += Y * ga;
        ac[4 * nt] += X * h0;
        ac[5 * nt] += Y * h0;
        ac[6 * nt] += Y * h1;
        ac[7 * nt] += X * h2;
        ac[8 * nt] += X * h3;
        ac[9 * nt] += Y * h3;
        ac[10 * nt] += (double)a[1];
        ac[11 * nt] += (double)a[3];
        ac[12 * nt] += (double)a[8];
        ac[13 * nt] += (double)a[9];
        ac[14 * nt] += (double)a[10];
        ac[15 * nt] += (double)a[11];
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
  double a[NA];
#pragma unroll
  for (int j = 0; j < NA; ++j) a[j] = acc[(size_t)j * nt + tid];
  __syncthreads();                // every sum is read
  if (active)
    finalize<T, MODE>(g, a, ch, sh, MODE == FIXED3 ? 1.0 : (double)wR[r],
                      acc + (size_t)tid * NC);
  __syncthreads();
  // each cell's gradient: its nodes added in node order (0 in the columns
  // the mode leaves untouched)
  for (int i = tid; i < nc * NW; i += nt) {
    const int c = i / NW, k = i - c * NW;
    const int j = C::slot(k);
    double v = 0.0;
    if (j >= 0)
      for (int rr = 0; rr < R; ++rr) v += acc[(size_t)(rr * CT + c) * NC + j];
    grad[(size_t)(c0 + c) * NW + k] = (T)v;
  }
}

#define IS3D_PFBWD_PARAMS                                                     \
  const T *__restrict__ cells, int n_cells, int CT, int S, int SC, int P,    \
      const T *__restrict__ px, const T *__restrict__ py, int F,             \
      const T *__restrict__ nodes, const T *__restrict__ wR, int R, int RU,  \
      const T *__restrict__ rows, const T *__restrict__ Gst,                 \
      T *__restrict__ grad

// K12a: fixed nodes (3+1D, 2+1D).  float32 is compiled for FIX_MIN_BLOCKS
// blocks an SM; float64 (its registers spill at that budget) for one
template <typename T, int DIM>
__global__ void __launch_bounds__(FIX_BLOCK,
                                  sizeof(T) == 4 ? FIX_MIN_BLOCKS : 1)
polzn_bwd_kernel(IS3D_PFBWD_PARAMS) {
  fixed_bwd_body<T, DIM == 3 ? FIXED3 : FIXED2>(
      cells, n_cells, CT, S, SC, P, px, py, F, nodes, wR, R, RU, rows, Gst,
      grad);
}

// K12b's shared memory: the float64 sums (NC slots of nt), the (cell,
// phi) terms at unit pT (CT rows of F + 1 vectors), two stage buffers (a
// tile of REMAP_PT pT rows of one species' G, GV values a point, then the
// rows' mT and pT) and the block's cell rows
template <typename T>
struct RSmem {
  size_t unit_, stage_, sz_, raw_, end_;
  __host__ __device__ RSmem(int nt, int CT, int F, int PT) {
    unit_ = align16((size_t)PCols<REMAP>::N * nt * sizeof(double));
    stage_ = align16(unit_ + (size_t)CT * (F + 1) * 4 * sizeof(T));
    sz_ = align16((size_t)PT * F * GV * sizeof(T) + 2 * PT * sizeof(T));
    raw_ = stage_ + 2 * sz_;
    end_ = raw_ + (size_t)CT * NW * sizeof(T);
  }
};

// K12b, the 2+1D mT remap: grid (blocks of CT cells); thread t owns cell
// t / R of the block at node t % R and walks species, then tiles of pT
// rows, then phi.  Gs (S, P, F, GV): remap_bwd_stage's; table (S, P, R, 2)
// the node table; cos_phi, sin_phi (F).
template <typename T>
__device__ __forceinline__ void remap_bwd_body(
    const T* __restrict__ cells, int n_cells, int CT,
    const T* __restrict__ mass, const T* __restrict__ sign,
    const T* __restrict__ pmv, int S, const T* __restrict__ pT, int P,
    const T* __restrict__ cos_phi, const T* __restrict__ sin_phi, int F,
    const T* __restrict__ table, const T* __restrict__ wR, int R,
    const T* __restrict__ Gs, T* __restrict__ grad) {
  using Fx = Fn<T>;
  using C = PCols<REMAP>;
  constexpr int NC = C::N;
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int PT = min(P, REMAP_PT);
  const int TP = (P + PT - 1) / PT;              // tiles a species
  const RSmem<T> s(nt, CT, F, PT);
  double* acc = reinterpret_cast<double*>(smem_raw);
  T* unit = reinterpret_cast<T*>(smem_raw + s.unit_);
  T* raw = reinterpret_cast<T*>(smem_raw + s.raw_);
  const int c0 = blockIdx.x * CT;
  const int nc = min(CT, n_cells - c0);
  const bool active = tid < nc * R;
  const int ci = active ? tid / R : 0, r = active ? tid - ci * R : 0;

  // tile k: rows p0 .. of species k / TP (cp.async into buffer k & 1),
  // beside the rows' mT and pT
  auto issue = [&](int k) {
    const int sp = k / TP, p0 = (k - sp * TP) * PT;
    const int rows = min(PT, P - p0);
    T* dst = reinterpret_cast<T*>(smem_raw + s.stage_ + (k & 1) * s.sz_);
    const T* src = Gs + ((size_t)sp * P + p0) * F * GV;
    for (int i = tid * V; i < rows * F * GV; i += nt * V)
      cp_async16(dst + i, src + i);
    cp_async_commit();
    T* mts = dst + PT * F * GV;
    const T m2 = mass[sp] * mass[sp];
    for (int i = tid; i < rows; i += nt) {
      const T pt = pT[p0 + i];
      mts[i] = d_sqrt(m2 + pt * pt);
      mts[PT + i] = pt;
    }
  };

  for (int i = tid; i < CT * NW; i += nt) {
    const int c = min(i / NW, nc - 1);
    raw[i] = cells[(size_t)(c0 + c) * NW + (i - (i / NW) * NW)];
  }
  for (int j = 0; j < NC; ++j) acc[(size_t)j * nt + tid] = 0.0;
  issue(0);
  __syncthreads();                // the cell rows are in
  const T L = Fx::SCALE;
  // the (cell, phi) terms at unit pT: p.dsigma's px, py part, L u.p / T's,
  // T0's and T3's
  for (int i = tid; i < CT * F; i += nt) {
    const int c = i / F, f = i - c * F;
    const T* q = raw + c * NW;
    const T x = cos_phi[f], y = sin_phi[f];
    T* o = unit + (c * (F + 1) + f) * 4;
    o[0] = fma(q[W_DAX], x, q[W_DAY] * y);
    o[1] = -L * fma(q[W_UX_T], x, q[W_UY_T] * y);
    o[2] = fma(q[W_WYN], x, -(q[W_WXN] * y));
    o[3] = fma(q[W_WTX], y, -(q[W_WTY] * x));
  }
  const T* g = raw + ci * NW;
  const T dat = g[W_DAT], dant = g[W_DANT];
  const T utT = g[W_UT_T], tunT = g[W_TUN_T], itau = g[W_ITAU];
  const T wtx = g[W_WTX], wty = g[W_WTY], wtn = g[W_WTN];
  const T wxy = g[W_WXY], wxn = g[W_WXN], wyn = g[W_WYN];
  // e^+-y_flow / 2: e^+-Delta = e^+-y_flow x the node table's exp(-+s eta_r)
  const T ey = d_exp(g[W_YFLOW]), eym = d_exp(-g[W_YFLOW]);
  const T* un = unit + ci * (F + 1) * 4;

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
    const T* st =
        reinterpret_cast<const T*>(smem_raw + s.stage_ + (k & 1) * s.sz_);
    const T* mts = st + PT * F * GV;
    for (int q = 0; q < rows && active; ++q) {
      const T mT = mts[q], pt = mts[PT + q];
      // the node kinematics of this (species, pT): cp = mT cosh(Delta), sn
      // = mT sinh(Delta)
      const T hm = T(0.5) * mT;
      const T* tb = table + (((size_t)sp * P + p0 + q) * R + r) * 2;
      const T ep = ey * hm * tb[0];
      const T em = eym * hm * tb[1];
      const T cp = ep + em, sn = ep - em;
      const T snt = sn * itau;
      const T A = fma(cp, dat, sn * dant);
      const T B = L * fma(cp, utT, -(sn * tunT));
      const T m0 = wxy * snt, m1 = fma(wyn, cp, wty * snt);
      const T m2 = -fma(wxn, cp, wtx * snt), m3 = wxy * cp;
      const T nwt = -(wtn * pt), pwt = wtn * pt;
      const T* gr = st + q * F * GV;
      // the row's sums over phi, in T (the px, py ones over cos, sin phi)
      T tP = 0, tPx = 0, tPy = 0, tA = 0, tAx = 0, tAy = 0;
      T h0 = 0, h1 = 0, h2 = 0, h3 = 0;
      T h0x = 0, h0y = 0, h1y = 0, h2x = 0, h3x = 0, h3y = 0;
#pragma unroll REMAP_UNROLL
      for (int f = 0; f < F; ++f) {
        T g0, g1, g2, g3, g4, x, y, z;
        Fx::ld4(gr + f * GV, g0, g1, g2, g3);
        Fx::ld4(gr + f * GV + 4, g4, x, y, z);
        T wp, wa, u0, u3;
        Fx::ld4(un + f * 4, wp, wa, u0, u3);
        const T pds = fma(pt, wp, A);
        const T arg = fma(pt, wa, B);
        const T f0 = Fx::rcp(Fx::exp_scaled(arg) + sgn);
        const T qf = fma(-sgn, f0, T(1));
        const T pref = pm * qf;
        const T meas = pds * f0;
        const T mp = meas * pref;
        const T T0 = fma(pt, u0, m0);
        const T T1 = fma(nwt, y, m1);
        const T T2 = fma(pwt, x, m2);
        const T T3 = fma(pt, u3, m3);
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
        const T mpx = mp * x, mpy = mp * y;
        h0 = fma(g0, mp, h0);
        h1 = fma(g1, mp, h1);
        h2 = fma(g2, mp, h2);
        h3 = fma(g3, mp, h3);
        h0x = fma(g0, mpx, h0x);
        h0y = fma(g0, mpy, h0y);
        h1y = fma(g1, mpy, h1y);
        h2x = fma(g2, mpx, h2x);
        h3x = fma(g3, mpx, h3x);
        h3y = fma(g3, mpy, h3y);
      }
      // the row into the species' registers (px = pT cos phi: the cos, sin
      // sums times pT)
      radd<C, W_DAT>(ra, cp * tP);
      radd<C, W_DANT>(ra, sn * tP);
      radd<C, W_DAX>(ra, pt * tPx);
      radd<C, W_DAY>(ra, pt * tPy);
      radd<C, W_UT_T>(ra, cp * tA);
      radd<C, W_TUN_T>(ra, -(sn * tA));
      radd<C, W_UX_T>(ra, -(pt * tAx));
      radd<C, W_UY_T>(ra, -(pt * tAy));
      radd<C, W_WXY>(ra, fma(snt, h0, cp * h3));
      radd<C, W_WYN>(ra, fma(cp, h1, pt * h0x));
      radd<C, W_WXN>(ra, -fma(cp, h2, pt * h0y));
      radd<C, W_WTY>(ra, fma(snt, h1, -(pt * h3x)));
      radd<C, W_WTN>(ra, pt * (h2x - h1y));
      radd<C, W_WTX>(ra, fma(-snt, h2, pt * h3y));
      // sn itau enters the four s1: itau gets sn x its cotangent
      const T gst = fma(wxy, h0, fma(wty, h1, -(wtx * h2)));
      radd<C, W_ITAU>(ra, sn * gst);
      // d/dDelta: d cp / dDelta = sn and back; Delta = y_flow - s eta_r
      const T gcp = fma(dat, tP, fma(utT, tA, fma(wyn, h1,
                        fma(-wxn, h2, wxy * h3))));
      const T gsn = fma(dant, tP, fma(-tunT, tA, itau * gst));
      radd<C, W_YFLOW>(ra, fma(sn, gcp, cp * gsn));
    }
    if (p0 + rows == P) {         // the species' last tile: into float64
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[(size_t)j * nt + tid] += (double)ra[j];
    }
  }
  cp_async_wait_all();
  __syncthreads();
  // each cell's gradient: its nodes times their weights, added in node
  // order (0 in tau, eta)
  for (int i = tid; i < nc * NW; i += nt) {
    const int c = i / NW, k = i - c * NW;
    const int j = C::slot(k);
    double v = 0.0;
    if (j >= 0)
      for (int rr = 0; rr < R; ++rr)
        v += (double)wR[rr] * acc[(size_t)j * nt + c * R + rr];
    grad[(size_t)(c0 + c) * NW + k] = (T)v;
  }
}

#define IS3D_PRBWD_PARAMS                                                     \
  const T *__restrict__ cells, int n_cells, int CT,                          \
      const T *__restrict__ mass, const T *__restrict__ sign,                \
      const T *__restrict__ pmv, int S, const T *__restrict__ pT, int P,     \
      const T *__restrict__ cos_phi, const T *__restrict__ sin_phi, int F,   \
      const T *__restrict__ table, const T *__restrict__ wR, int R,          \
      const T *__restrict__ Gs, T *__restrict__ grad

// K12b: the 2+1D mT remap
template <typename T>
__global__ void __launch_bounds__(REMAP_BLOCK)
polzn_remap_bwd_kernel(IS3D_PRBWD_PARAMS) {
  remap_bwd_body<T>(cells, n_cells, CT, mass, sign, pmv, S, pT, P, cos_phi,
                    sin_phi, F, table, wR, R, Gs, grad);
}

template <typename X>
struct Id {
  using type = X;
};

// A kernel of ours on the stream: its arguments converted to the kernel's
// own parameter types
template <typename... A>
cudaError_t launch_kernel(void (*kern)(A...), unsigned blocks, int threads,
                          size_t smem, void* stream,
                          typename Id<A>::type... a) {
  void* args[] = {&a...};
  return cudaLaunchKernel((const void*)kern, dim3(blocks), dim3(threads),
                          args, smem, static_cast<cudaStream_t>(stream));
}

// the launch plan of one shape on the current card: cells a block (CT),
// threads, shared memory, resident blocks an SM, species a stage (SC), pT
// rows a stage, angles a thread evaluates at once, values a species' stage
// row (K12a) or a point (K12b) holds, and the waves of resident blocks
struct Plan {
  int CT, threads, smem, blocks_per_sm, SC, PT, U, RU, waves;
};

// K12a's: SC the fewest species chunks whose two stages fit the shared
// memory of the blocks an SM the registers are budgeted for; the last
// wave is left as it falls
template <typename T>
int fixed_plan(int mode, int S, int P, int F, int R, int n_cells,
               Plan* pl) {
  if (R < 1 || R > FIX_BLOCK || F < 1 || S < 1 || P < 1 || n_cells < 1)
    return cudaErrorInvalidValue;
  const void* kern = mode == FIXED3 ? (const void*)polzn_bwd_kernel<T, 3>
                                    : (const void*)polzn_bwd_kernel<T, 2>;
  int dev = 0, n_sm = 0, per_sm = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (e != cudaSuccess) return (int)e;
  const int CT = FIX_BLOCK / R;
  const int nt = (CT * R + 31) / 32 * 32;
  const int RU = fixed_stage_row<T>(mode, R);
  // the runtime reserves 1 KB of each block's shared memory
  const int sm_threads = FIX_BLOCK * (sizeof(T) == 4 ? FIX_MIN_BLOCKS : 1);
  size_t budget = (size_t)per_sm / (sm_threads / nt) - 1024;
  if (budget > (size_t)optin) budget = optin;
  int SC = 0;
  size_t smem = 0;
  for (int nsc = 1; nsc <= S && SC == 0; ++nsc) {
    const int sc = (S + nsc - 1) / nsc;
    const size_t b = FSmem<T>(nt, CT, RU, sc).end_;
    if (b <= budget) {
      SC = sc;
      smem = b;
    }
  }
  if (SC == 0) return cudaErrorInvalidValue;
  int bps = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, kern, nt, smem);
  if (e != cudaSuccess) return (int)e;
  if (bps < 1) return cudaErrorInvalidValue;
  const long blocks = (n_cells + CT - 1) / CT;
  const long slots = (long)bps * n_sm;
  *pl = Plan{CT, nt, (int)smem, bps, SC, 1, fix_u(mode), RU,
             (int)((blocks + slots - 1) / slots)};
  return 0;
}

template <typename T>
int remap_plan(int S, int P, int F, int R, int n_cells, Plan* pl) {
  if (R < 1 || R > REMAP_BLOCK || F < 1 || S < 1 || P < 1 || n_cells < 1)
    return cudaErrorInvalidValue;
  const void* kern = (const void*)polzn_remap_bwd_kernel<T>;
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int CT = REMAP_BLOCK / R;
  const int nt = (CT * R + 31) / 32 * 32;
  const int PT = P < REMAP_PT ? P : REMAP_PT;
  const size_t smem = RSmem<T>(nt, CT, F, PT).end_;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  int bps = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, kern, nt, smem);
  if (e != cudaSuccess) return (int)e;
  if (bps < 1) return cudaErrorInvalidValue;
  const long blocks = (n_cells + CT - 1) / CT;
  const long slots = (long)bps * n_sm;
  *pl = Plan{CT, nt, (int)smem, bps, 1, PT, REMAP_UNROLL, GV,
             (int)((blocks + slots - 1) / slots)};
  return 0;
}

template <typename T>
int launch_fixed(const void* cells, int n_cells, int nw, int S, int P,
                 int F, const void* px, const void* py, const void* nodes,
                 const void* wR, int R, int dim, int RU, const void* rows,
                 const void* Gst, void* grad, void* stream) {
  if (nw != NW || (dim != 2 && dim != 3) || n_cells < 0 || S < 1 || P < 1)
    return cudaErrorInvalidValue;
  if (n_cells == 0) return cudaSuccess;
  const int mode = dim == 3 ? FIXED3 : FIXED2;
  Plan pl;
  const int rc = fixed_plan<T>(mode, S, P, F, R, n_cells, &pl);
  if (rc != 0) return rc;
  if (RU != pl.RU) return cudaErrorInvalidValue;    // Gst's stage rows
  const cudaError_t e = launch_kernel(
      dim == 3 ? polzn_bwd_kernel<T, 3> : polzn_bwd_kernel<T, 2>,
      (unsigned)((n_cells + pl.CT - 1) / pl.CT), pl.threads, pl.smem, stream,
      static_cast<const T*>(cells), n_cells, pl.CT, S, pl.SC, P,
      static_cast<const T*>(px), static_cast<const T*>(py), F,
      static_cast<const T*>(nodes), static_cast<const T*>(wR), R, RU,
      static_cast<const T*>(rows), static_cast<const T*>(Gst),
      static_cast<T*>(grad));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_remap(const void* cells, int n_cells, int nw, const void* mass,
                 const void* sign, const void* pm, int S, const void* pT,
                 int P, const void* cos_phi, const void* sin_phi, int F,
                 const void* table, const void* wR, int R, const void* Gs,
                 void* grad, void* stream) {
  if (nw != NW || n_cells < 0 || S < 1 || P < 1 || table == nullptr)
    return cudaErrorInvalidValue;
  if (n_cells == 0) return cudaSuccess;
  Plan pl;
  const int rc = remap_plan<T>(S, P, F, R, n_cells, &pl);
  if (rc != 0) return rc;
  const cudaError_t e = launch_kernel(
      polzn_remap_bwd_kernel<T>, (unsigned)((n_cells + pl.CT - 1) / pl.CT),
      pl.threads, pl.smem, stream, static_cast<const T*>(cells), n_cells,
      pl.CT, static_cast<const T*>(mass), static_cast<const T*>(sign),
      static_cast<const T*>(pm), S, static_cast<const T*>(pT), P,
      static_cast<const T*>(cos_phi), static_cast<const T*>(sin_phi), F,
      static_cast<const T*>(table), static_cast<const T*>(wR), R,
      static_cast<const T*>(Gs), static_cast<T*>(grad));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// out: the plan (CT, threads, shared memory, resident blocks an SM), then
// registers and local memory bytes a thread (spills), SC, pT rows a stage,
// angles, the stage row and the waves, of one kernel at one shape
template <typename T>
int props(int mode, int S, int P, int F, int R, int n_cells, int* out) {
  Plan pl;
  const int rc = mode == REMAP ? remap_plan<T>(S, P, F, R, n_cells, &pl)
                               : fixed_plan<T>(mode, S, P, F, R, n_cells, &pl);
  if (rc != 0) return rc;
  const void* kern = mode == FIXED3   ? (const void*)polzn_bwd_kernel<T, 3>
                     : mode == FIXED2 ? (const void*)polzn_bwd_kernel<T, 2>
                                      : (const void*)polzn_remap_bwd_kernel<T>;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return (int)e;
  const int vals[] = {pl.CT,  pl.threads, pl.smem, pl.blocks_per_sm,
                      attr.numRegs, (int)attr.localSizeBytes, pl.SC, pl.PT,
                      pl.U, pl.RU, pl.waves};
  for (int i = 0; i < 11; ++i) out[i] = vals[i];
  return 0;
}

}  // namespace

extern "C" {

// K12a, fixed nodes (3+1D, 2+1D): grad (n_cells, NW) of <G, the five
// sums>, from kernels/polzn.py:fixed_bwd_stage's rows (P, S, 4) and stage
// rows Gst (P, ceil(F / fix_u), S, RU)
#define IS3D_PBWD_ENTRY(NAME, T)                                              \
  int NAME(const void* cells, int n_cells, int nw, int S, int P, int F,      \
           const void* px, const void* py, const void* nodes,                \
           const void* wR, int R, int dim, int RU, const void* rows,         \
           const void* Gst, void* grad, void* stream) {                      \
    return launch_fixed<T>(cells, n_cells, nw, S, P, F, px, py, nodes, wR,   \
                           R, dim, RU, rows, Gst, grad, stream);             \
  }
IS3D_PBWD_ENTRY(is3d_polzn_bwd_f32, float)
IS3D_PBWD_ENTRY(is3d_polzn_bwd_f64, double)
#undef IS3D_PBWD_ENTRY

// the layout kernels/polzn.py:fixed_bwd_stage gives K12a's cotangent at
// (f64, dim, R), with no call to the card: out = the angles a stage
// (fix_u), the values a species' stage row holds (RU)
int is3d_polzn_bwd_layout(int f64, int dim, int R, int* out) {
  if (dim != 2 && dim != 3) return cudaErrorInvalidValue;
  const int mode = dim == 3 ? FIXED3 : FIXED2;
  out[0] = fix_u(mode);
  out[1] = f64 ? fixed_stage_row<double>(mode, R)
               : fixed_stage_row<float>(mode, R);
  return 0;
}

// K12b, the 2+1D mT remap: table (S, P, R, 2) = exp(-s eta_r), exp(+s
// eta_r); Gs (S, P, F, 8) kernels/polzn.py:remap_bwd_stage's
#define IS3D_PBWD_REMAP_ENTRY(NAME, T)                                        \
  int NAME(const void* cells, int n_cells, int nw, const void* mass,         \
           const void* sign, const void* pm, int S, const void* pT, int P,   \
           const void* cos_phi, const void* sin_phi, int F,                  \
           const void* table, const void* wR, int R, const void* Gs,         \
           void* grad, void* stream) {                                       \
    return launch_remap<T>(cells, n_cells, nw, mass, sign, pm, S, pT, P,     \
                           cos_phi, sin_phi, F, table, wR, R, Gs, grad,      \
                           stream);                                          \
  }
IS3D_PBWD_REMAP_ENTRY(is3d_polzn_bwd_remap_f32, float)
IS3D_PBWD_REMAP_ENTRY(is3d_polzn_bwd_remap_f64, double)
#undef IS3D_PBWD_REMAP_ENTRY

// props<T> of (f64, dim: 3, 2 fixed nodes or 0 the remap) at (S, P, F, R,
// n_cells): out[11]
int is3d_polzn_bwd_props(int f64, int dim, int S, int P, int F, int R,
                         int n_cells, int* out) {
  if (dim != 0 && dim != 2 && dim != 3) return cudaErrorInvalidValue;
  const int mode = dim == 3 ? FIXED3 : dim == 2 ? FIXED2 : REMAP;
  return f64 ? props<double>(mode, S, P, F, R, n_cells, out)
             : props<float>(mode, S, P, F, R, n_cells, out);
}

const char* is3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
