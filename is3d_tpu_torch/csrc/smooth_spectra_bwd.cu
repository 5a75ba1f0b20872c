// The backward pass of the smooth Cooper-Frye spectra (linear delta-f, df 1
// and 2) for Hopper (sm_90a), float32 and float64: the gradient of <G,
// spectra> with respect to the packed cells.
//
// Replaces what JAX runs for the reverse pass of the spectra: XLA's reverse
// of the chunk body under jax.checkpoint (is3d_tpu/kernels/smooth.py:426-451,
// driven by is3d_tpu/diff.py:108-169), for the fixed-node kernel
// (spectra_bwd_kernel: 3+1D and 2+1D fixed nodes) and the 2+1D mT remap
// (remap_bwd_kernel, the reverse of smooth.py:161).  Like JAX's remat it
// keeps no forward intermediates: it recomputes the emission value at every
// (cell, node, species, point) from the packed cells and chains through it.
//
// Inputs (built by is3d_tpu_torch/kernels/smooth.py): cells (n_cells, NF)
// in the order of emission.cuh's `Field`; the species and momentum
// constants of the forward; G (n_species, n_pT, n_phi, n_out), the output's
// cotangent (n_out = n_nodes in 3+1D, 1 in 2+1D); the remap's node table
// (n_species, n_pT, n_nodes, 2) = exp(-s eta_r), exp(+s eta_r).
// Output: grad (n_cells, NF), every row written once.
//
// The formula.  With g = prefactor deg_s w_node [s(mT)] G the weighted
// cotangent of one evaluation, contrib = max(p.dsigma, 0) f the emission
// value, f = feq (1 + clamp(feqbar df, -1, 1)), feq = 1 / (e^arg + sign),
// arg = u.p / T - b alphaB, every cell field x_k gets
//     grad[c, k] = sum over (node, species, pT, phi) of g d contrib / d x_k,
// by the chain rule through the four point terms p.dsigma, u.p, pi:pp and
// V.p (smooth.py:emission_terms) and the per-cell scalars (1/T, alphaB, the
// df coefficients, bulkPi, nB/(E+P)).  Every convention is the plain
// version's under torch autograd (smooth.py:plain_block): d max(x, 0)/dx =
// 1 at x >= 0, d clamp(x, -1, 1)/dx = 1 on [-1, 1], and the occupation's
// derivative is the JAX package's (common.fermi_bose: -feq feqbar, exactly
// 0 where e^arg overflows).
//
// What bounds it on this card: FP32 issue.  Each evaluation recomputes the
// forward (~20 FP32, an exp and one or two reciprocals) and adds ~35 FP32
// operations of chain rule and sums (kernels/smooth.py,
// BACKWARD_FORMULA_OPS; with the remap REMAP_BACKWARD_EXTRA more an
// evaluation and REMAP_BACKWARD_ROW_OPS a (species, pT) row); no bytes to
// speak of: a group's cells are 2.4 MB and G, read once per block of
// cells, stays in L2.
//
// Design of the fixed-node kernel (K9a, spectra_bwd_kernel).
//   * A per-cell reduction over momentum points: a thread owns one (cell,
//     node) pair and walks pT rows, then groups of FIX_U angles, then the
//     species; a block holds CT cells x all nodes, so nothing of a cell's
//     sum leaves the block.  The node kinematics (cosh, sinh of Delta) are
//     the thread's constants and the sums that need them are formed per
//     node (SP .. SV below), then multiplied by cosh and sinh once at the
//     end.
//   * Staging: one stage a (pT row, angle group, chunk of SC species), by
//     cp.async 16 bytes a copy into one of two buffers while the other is
//     consumed (bwd_stage.cuh), one barrier a stage.  The wrapper lays the
//     cotangent out for it once a launch (kernels/smooth.py:
//     fixed_bwd_stage): weighted by prefactor x degeneracy, (pT, angle
//     group, species, node, angle), so a stage is one contiguous run, and
//     each (pT, species) row's mT, m^2, sign, b as 16 bytes.  The (cell,
//     angle) terms W1, -W2, C4, -D2 go into the stage of an angle group's
//     first chunk.  SC is all the species where two stages fit, two chunks
//     at 3+1D's main shape.
//   * Independent chains: a species' row and the cotangent at the FIX_U
//     angles (one vector load) feed FIX_U evaluations at once, each with
//     its own sums.
//   * The accumulator.  One cell's gradient sums S x P x F x nodes terms
//     (5.2e6 in 3+1D at 320 x 32 x 24 x 21).  A point's 17 sums run in T
//     over every species (S terms: at most ~320 x 2^-24 = 2e-5 of the
//     point's sum of magnitudes in float32) and go to the thread's float64
//     sums in shared memory once a point.
//   * The block: CT = FIX_BLOCK / R cells (6 x 21 nodes), FIX_MIN_BLOCKS
//     of them an SM (16 warps); the last wave is left as it falls
//     (fixed_plan).

// Design of the 2+1D mT remap (K9b, remap_bwd_kernel), where the nodes
// move with (cell, species, pT): Delta = y_flow - s(mT) eta_r.
//   * A thread owns one (cell, node) pair as above (REMAP_BLOCK threads a
//     block, CT = REMAP_BLOCK / R cells) and walks species, then pT rows,
//     then phi, as K11b (vah_bwd.cu).  Per (species, pT) row it forms the
//     node kinematics mT cosh Delta, mT sinh Delta from the node table
//     (two products) and the composites of the four point terms once;
//     its n_phi points then run the fixed-node body, each point term one
//     FMA from the row's composite and a (cell, phi) term at unit pT
//     staged once a block (pi:pp's px part as pT mT cosh g + pT mT sinh h).
//   * Staging: a species' G (P x F), its node table (P x R x 2) by
//     cp.async into one of two buffers while the other is consumed
//     (bwd_stage.cuh), beside each row's weight prefactor deg s(mT) and mT:
//     one barrier a species.  The momentum points (pT cos, pT sin, their
//     squares and product) are staged once a block.
//   * The accumulator.  A row's sums over phi of the six point-term
//     cotangents run in T (n_phi terms); the row multiplies them by mT
//     cosh and mT sinh once, into the 13 node sums; the 9 sums with px,
//     py and the 8 of the scalars run per point.  All 30 sums (Sums) are
//     T registers over a species (P x F = 768 terms: at most ~768 x 2^-24
//     = 5e-5 of the species' sum of magnitudes in float32, typically
//     2e-6, inside the 2e-4 the checks allow), flushed to the thread's
//     float64 accumulators in shared memory once a species.
//
// Both:
//   * No atomics.  At the end each thread turns its float64 sums into the
//     NF gradients of its (cell, node) pair (finalize), the block adds the
//     nodes of a cell in node order in float64, and one thread writes each
//     entry: two launches give identical bits.
//   * float32 takes ex2.approx and rcp.approx as the forward kernel does
//     (folded.cuh, Fn<float>): +inf -> 0, so an overflowed exponential
//     gives feq = 0 and every term of the evaluation exactly 0; float64
//     keeps IEEE arithmetic.

#include <cuda_runtime.h>

#include "bwd_stage.cuh"
#include "folded.cuh"

namespace {

using namespace is3d;

// K9a's: most threads a block (CT cells x nodes), the blocks of that size
// an SM float32 registers are budgeted for (16 warps), and the angles a
// thread evaluates at once (its independent chains)
constexpr int FIX_BLOCK = 128;
constexpr int FIX_MIN_BLOCKS = 4;
constexpr int FIX_U = 2;
// the remap's: most threads a block, and the blocks an SM its registers
// are budgeted for
constexpr int REMAP_BLOCK = 192;
constexpr int REMAP_MIN_BLOCKS = 2;
constexpr size_t MAX_SMEM = 232448;

enum Mode { FIXED3 = 0, FIXED2 = 1, REMAP = 2 };

// the gradient of one (cell, node) from its sums, in float64
struct Sums {
  // node sums in the generic form: P = sum gp mT cosh, Ps = sum gp mT sinh,
  // U, Us of u.p, Q.. of pi:pp's mT^2 terms, X, Y of its mT px and mT py
  // terms, V, Vs of V.p
  double Pc, Ps, Uc, Us, Qcc, Qss, Qcs, Xc, Xs, Yc, Ys, Vc, Vs;
  // per-point sums: gp px, gp py, gu px, gu py, gq px^2, gq py^2,
  // gq px py, gv px, gv py
  double Gpx, Gpy, Gux, Guy, Gqxx, Gqyy, Gqxy, Gvx, Gvy;
  // the scalars: g_arg u.p, g_arg b, and s0 .. s5 of the df chain
  double sInvT, sAlpha, s0, s1, s2, s3, s4, s5;
};

template <typename T, int DF>
__device__ __forceinline__ void finalize(const T* g, const Sums& a,
                                         double w, int mode, double* o) {
  const double tau = g[F_TAU], dat = g[F_DAT], dant = g[F_DANT];
  const double ut = g[F_UT], tun = g[F_TUN];
  const double pitt = g[F_PITT], pitx = g[F_PITX], pity = g[F_PITY];
  const double pitn = g[F_PITN], pinn = g[F_PINN], pixn = g[F_PIXN];
  const double piyn = g[F_PIYN], Vt = g[F_VT], Vn = g[F_VN];
  const double Pi = g[F_BULKPI], kb0 = g[F_KB0], kb1 = g[F_KB1];
  const double kb2 = g[F_KB2], benth = g[F_BENTH], kdv = g[F_KDV];
  for (int k = 0; k < NF; ++k) o[k] = 0.0;
  o[F_DAT] = a.Pc;
  o[F_DANT] = a.Ps;
  o[F_DAX] = a.Gpx;
  o[F_DAY] = a.Gpy;
  o[F_UT] = a.Uc;
  o[F_TUN] = -a.Us;
  o[F_UX] = -a.Gux;
  o[F_UY] = -a.Guy;
  o[F_PITT] = a.Qcc;
  o[F_PINN] = tau * tau * a.Qss;
  o[F_PITN] = -2.0 * tau * a.Qcs;
  o[F_PITX] = -2.0 * a.Xc;
  o[F_PIXN] = 2.0 * tau * a.Xs;
  o[F_PITY] = -2.0 * a.Yc;
  o[F_PIYN] = 2.0 * tau * a.Ys;
  o[F_PIXX] = a.Gqxx;
  o[F_PIYY] = a.Gqyy;
  o[F_PIXY] = 2.0 * a.Gqxy;
  o[F_VT] = a.Vc;
  o[F_VN] = -tau * a.Vs;
  o[F_VX] = -a.Gvx;
  o[F_VY] = -a.Gvy;
  o[F_TAU] = 2.0 * tau * pinn * a.Qss - 2.0 * pitn * a.Qcs
             + 2.0 * pixn * a.Xs + 2.0 * piyn * a.Ys - Vn * a.Vs;
  // d/dDelta: d(mT cosh)/dDelta = mT sinh, d(mT sinh)/dDelta = mT cosh
  const double gdelta =
      dat * a.Ps + dant * a.Pc + ut * a.Us - tun * a.Uc
      + 2.0 * pitt * a.Qcs + 2.0 * tau * tau * pinn * a.Qcs
      - 2.0 * tau * pitn * (a.Qss + a.Qcc) - 2.0 * pitx * a.Xs
      + 2.0 * tau * pixn * a.Xc - 2.0 * pity * a.Ys + 2.0 * tau * piyn * a.Yc
      + Vt * a.Vs - tau * Vn * a.Vc;
  if (mode == FIXED3) o[F_ETA] = -gdelta;        // Delta = y - eta
  if (mode == REMAP) o[F_YFLOW] = gdelta;        // Delta = y_flow - s eta_r
  o[F_INVT] = a.sInvT;
  o[F_ALPHAB] = -a.sAlpha;
  o[F_KSC] = a.s0;
  o[F_KB0] = Pi * a.s1;
  o[F_KB1] = Pi * a.s2;
  o[F_KB2] = Pi * a.s3;
  o[F_BULKPI] = kb0 * a.s1 + kb1 * a.s2 + kb2 * a.s3;
  if (DF == 2) {
    o[F_BENTH] = kdv * a.s4;
    o[F_KDV] = benth * a.s4 - a.s5;
  } else {
    o[F_KC3] = a.s4;
    o[F_KC4] = a.s5;
  }
  for (int k = 0; k < NF; ++k) o[k] *= w;
}

// K9a's float64 sums a thread carries (NA: Gpx, Gpy, Gux, Guy, Gqxx, Gqyy,
// Gqxy, Gvx, Gvy, sInvT, sAlpha, s0 .. s5, then the node sums before the
// node's cosh and sinh, SP, SU, S2, SX, SY, SV) and a point's sums in T
// (NQ), which the flush multiplies by px, py and adds into them
constexpr int NA = 23;
constexpr int NQ = 17;

// K9a's shared memory: the float64 sums (NA slots of nt), two stage
// buffers, and the block's cell rows, placed past the per-(cell, node)
// gradients (nt x NF float64 from 0) that the end writes over the sums and
// the stages.  A buffer holds one stage: SC species' weighted cotangent at
// the stage's FIX_U angles (RU values a species: node-major, angle-minor,
// padded to 16 bytes; fixed_bwd_stage in kernels/smooth.py lays G out so),
// their rows (mT, m^2, sign, b) at the stage's pT, the angles' px, py and,
// filled for the first species chunk of an angle group only, the (cell,
// angle) terms W1, -W2, C4, -D2.
template <typename T>
struct FSmem {
  size_t stage_, sz_, rows_, pts_, xy_, raw_, end_;
  __host__ __device__ FSmem(int nt, int CT, int RU, int SC) {
    stage_ = align16((size_t)NA * nt * sizeof(double));
    rows_ = align16((size_t)SC * RU * sizeof(T));
    pts_ = rows_ + (size_t)SC * 4 * sizeof(T);
    xy_ = pts_ + (size_t)CT * FIX_U * 4 * sizeof(T);
    sz_ = align16(xy_ + (size_t)FIX_U * 2 * sizeof(T));
    const size_t o = stage_ + 2 * sz_;
    const size_t red = (size_t)nt * NF * sizeof(double);
    raw_ = o > red ? o : red;
    end_ = raw_ + (size_t)CT * NF * sizeof(T);
  }
  __device__ T* buf(unsigned char* p, int b, size_t part = 0) const {
    return reinterpret_cast<T*>(p + stage_ + b * sz_ + part);
  }
};

// K9a, fixed nodes: grid (blocks of CT cells); thread t owns cell t / R of
// the block at node t % R and walks pT rows, then groups of FIX_U angles,
// then chunks of SC species (one stage each), the species inside a stage
// evaluated at the group's FIX_U angles at once.  A point's NQ sums run in
// T over every species and go to the thread's float64 sums once a point.
// rows (P, S, 4) and Gw (P, ceil(F / FIX_U), S, RU): fixed_bwd_stage's.
template <typename T, int MODE, int DF>
__device__ __forceinline__ void fixed_bwd_body(
    const T* __restrict__ cells, int n_cells, int CT, int S, int SC, int P,
    const T* __restrict__ px, const T* __restrict__ py, int F,
    const T* __restrict__ nodes, const T* __restrict__ weights, int R,
    int RU, int regulate, int outflow, const T* __restrict__ rows,
    const T* __restrict__ Gw, T* __restrict__ grad) {
  using Fx = Fn<T>;
  constexpr int U = FIX_U;
  constexpr int V = 16 / sizeof(T);            // values a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const FSmem<T> s(nt, CT, RU, SC);
  double* acc = reinterpret_cast<double*>(smem_raw);
  T* raw = reinterpret_cast<T*>(smem_raw + s.raw_);
  const int c0 = blockIdx.x * CT;
  const int nc = min(CT, n_cells - c0);
  const bool active = tid < nc * R;
  const int ci = active ? tid / R : 0, r = active ? tid - ci * R : 0;
  const int NFG = (F + U - 1) / U, NSC = (S + SC - 1) / SC;
  const int K = P * NFG * NSC;

  for (int i = tid; i < CT * NF; i += nt) {
    const int c = min(i / NF, nc - 1);
    raw[i] = cells[(size_t)(c0 + c) * NF + (i - (i / NF) * NF)];
  }
  for (int j = 0; j < NA; ++j) acc[(size_t)j * nt + tid] = 0.0;
  __syncthreads();

  // stage k = (pT row p, angle group fg, species chunk sc) into buffer
  // k & 1: the cotangent and the rows by cp.async, 16 bytes a copy; the
  // angles' px, py and, for the first chunk, the point terms by the
  // threads
  auto issue = [&](int k) {
    const int sc = k % NSC, pf = k / NSC;
    const int fg = pf % NFG, p = pf / NFG;
    const int s0 = sc * SC, ns = min(SC, S - s0);
    T* gs = s.buf(smem_raw, k & 1);
    const T* g0 = Gw + (((size_t)p * NFG + fg) * S + s0) * RU;
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
    if (sc == 0) {
      T* pts = s.buf(smem_raw, k & 1, s.pts_);
      for (int i = tid; i < CT * U; i += nt) {
        const int c = i / U, u = i - c * U;
        const T x = u < nu ? px[p * F + f0 + u] : T(0);
        const T y = u < nu ? py[p * F + f0 + u] : T(0);
        const T* q = raw + c * NF;
        T* o = pts + 4 * i;
        o[0] = q[F_DAX] * x + q[F_DAY] * y;
        o[1] = -(q[F_UX] * x + q[F_UY] * y);
        o[2] = q[F_PIXX] * x * x + q[F_PIYY] * y * y
               + T(2) * q[F_PIXY] * x * y;
        o[3] = -(q[F_VX] * x + q[F_VY] * y);
      }
    }
  };

  const T* g = raw + ci * NF;
  const T tau = g[F_TAU], dat = g[F_DAT], dant = g[F_DANT], ut = g[F_UT];
  const T tun = g[F_TUN], pitt = g[F_PITT], pitx = g[F_PITX];
  const T pity = g[F_PITY], pitn = g[F_PITN], pinn = g[F_PINN];
  const T pixn = g[F_PIXN], piyn = g[F_PIYN], Vt = g[F_VT], Vn = g[F_VN];
  const T invT = g[F_INVT], ksc = g[F_KSC], Pi = g[F_BULKPI];
  const T L = Fx::SCALE;
  const T invTL = L * invT, nAL = -L * g[F_ALPHAB];
  // the df coefficients folded with bulkPi and k_dv: df 2 as r (ksc pi:pp
  // + KM m^2 - kdv b V.p) + KP u.p + KB b + KV V.p; df 1 as ksc pi:pp +
  // KM m^2 + (KB b + KP u.p) u.p + (KC b + KV u.p) V.p
  const T KB = g[F_KB1] * Pi;
  const T KP = DF == 2 ? (g[F_KB0] + g[F_KB2]) * Pi : g[F_KB2] * Pi;
  const T KM = DF == 2 ? -g[F_KB2] * Pi : g[F_KB0] * Pi;
  const T kdv = g[F_KDV];
  const T KV = DF == 2 ? kdv * g[F_BENTH] : g[F_KC4];
  const T KC = g[F_KC3];
  const T dlo = regulate ? T(-1) : -Fx::inf();
  const T dhi = regulate ? T(1) : Fx::inf();
  const T olo = outflow ? T(0) : -Fx::inf();
  // the thread's node kinematics and composites
  const T delta = MODE == FIXED3 ? nodes[r] - g[F_ETA] : -nodes[r];
  const T ch = d_cosh(delta), sh = d_sinh(delta);
  const T t_sh = sh * tau;
  const T A1 = ch * dat + sh * dant;
  const T B1 = ch * ut - sh * tun;
  const T C1 = ch * ch * pitt + t_sh * t_sh * pinn - T(2) * ch * t_sh * pitn;
  const T C2 = T(-2) * (ch * pitx - t_sh * pixn);
  const T C3 = T(-2) * (ch * pity - t_sh * piyn);
  const T D1 = ch * Vt - t_sh * Vn;
  const int goff = (MODE == FIXED3 ? r : 0) * U;

  T q[U][NQ];
  T W1[U], nW2[U], C4[U], nD2[U], PC[U];
  issue(0);
  for (int k = 0; k < K; ++k) {
    cp_async_wait_all();
    __syncthreads();              // stage k has landed, stage k - 1 is consumed
    if (k + 1 < K) issue(k + 1);
    if (!active) continue;
    const int sc = k % NSC;
    const int ns = min(SC, S - sc * SC);
    const int b = k & 1;
    if (sc == 0) {
      const T* pts = s.buf(smem_raw, b, s.pts_) + ci * U * 4;
      const T* xy = s.buf(smem_raw, b, s.xy_);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        Fx::ld4(pts + 4 * u, W1[u], nW2[u], C4[u], nD2[u]);
        PC[u] = xy[2 * u] * C2 + xy[2 * u + 1] * C3;
#pragma unroll
        for (int j = 0; j < NQ; ++j) q[u][j] = T(0);
      }
    }
    const T* gs = s.buf(smem_raw, b) + goff;
    const T* rs = s.buf(smem_raw, b, s.rows_);
    for (int sl = 0; sl < ns; ++sl) {
      T gv[U];
      ld_u<T, U>(gs + sl * RU, gv);
      T mT, m2, sgn, bar;
      Fx::ld4(rs + 4 * sl, mT, m2, sgn, bar);
      // the species' factors, shared by the U angles
      const T nab = nAL * bar;
      const T km = KM * m2;
      const T kb = KB * bar;
      const T kvb = DF == 2 ? kdv * bar : KC * bar;   // df 1: KC b
#pragma unroll
      for (int u = 0; u < U; ++u) {
        T* a = q[u];
        const T pds = fma(mT, A1, W1[u]);
        const T pdu = fma(mT, B1, nW2[u]);
        const T pipp = fma(fma(mT, C1, PC[u]), mT, C4[u]);
        const T Vp = fma(mT, D1, nD2[u]);
        // the forward value
        const T feq = Fx::rcp(Fx::exp_scaled(fma(pdu, invTL, nab)) + sgn);
        const T feqbar = fma(-sgn, feq, T(1));
        T df, X = T(0), r_ = T(0), vb = T(0);
        if (DF == 1) {
          vb = fma(KV, pdu, kvb);
          df = fma(vb, Vp, fma(ksc, pipp, fma(fma(KP, pdu, kb), pdu, km)));
        } else {
          r_ = Fx::rcp(pdu);
          X = fma(ksc, pipp, fma(-kvb, Vp, km));
          df = fma(r_, X, fma(KP, pdu, fma(KV, Vp, kb)));
        }
        const T prod = feqbar * df;
        const T dfc = fmin(fmax(prod, dlo), dhi);
        const T fv = fma(feq, dfc, feq);
        // the chain rule, as torch autograd takes it through plain_block;
        // the outflow clip max(p.dsigma, 0) as a mask on the cotangent,
        // which a NaN p.dsigma passes (as it passes the plain version's
        // clamp)
        const T gs = pds < olo ? T(0) : gv[u];
        const T gp = gs * fv;
        const T gfv = gs * pds;
        const T gprod = dfc == prod ? gfv * feq : T(0);
        const T gfeq = fma(-sgn * gprod, df, fma(gfv, dfc, gfv));
        const T gdf = gprod * feqbar;
        const T garg = -(gfeq * feq) * feqbar;
        T gq, gVp, gu;
        if (DF == 1) {
          gq = gdf * ksc;
          gVp = gdf * vb;
          gu = fma(gdf, fma(KV, Vp, fma(T(2) * KP, pdu, kb)), garg * invT);
          const T gb = gdf * bar, gpu = gdf * pdu;
          a[11] = fma(gdf, pipp, a[11]);
          a[12] = fma(gdf, m2, a[12]);
          a[13] = fma(gb, pdu, a[13]);
          a[14] = fma(gpu, pdu, a[14]);
          a[15] = fma(gb, Vp, a[15]);
          a[16] = fma(gpu, Vp, a[16]);
        } else {
          const T gr = gdf * r_;
          gq = gr * ksc;
          gVp = fma(gdf, KV, -(gr * kvb));
          gu = fma(-(gr * r_), X, fma(gdf, KP, garg * invT));
          a[11] = fma(gr, pipp, a[11]);
          a[12] = fma(gdf, pdu, a[12]);
          a[13] = fma(gdf, bar, a[13]);
          a[14] = fma(gr, m2, a[14]);       // s3 = s1 - this
          a[15] = fma(gdf, Vp, a[15]);
          a[16] = fma(gr * bar, Vp, a[16]);
        }
        const T tq = gq * mT;
        a[0] += gp;
        a[1] = fma(gp, mT, a[1]);
        a[2] += gu;
        a[3] = fma(gu, mT, a[3]);
        a[4] += gq;
        a[5] += tq;
        a[6] = fma(tq, mT, a[6]);
        a[7] += gVp;
        a[8] = fma(gVp, mT, a[8]);
        a[9] = fma(garg, pdu, a[9]);
        a[10] = fma(garg, bar, a[10]);
      }
    }
    if (sc == NSC - 1) {
      // the points' sums into float64, once a point
      const int f0 = ((k / NSC) % NFG) * U, nu = min(U, F - f0);
      const T* xy = s.buf(smem_raw, b, s.xy_);
      double* ac = acc + tid;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u >= nu) break;
        const T* a = q[u];
        const double X = xy[2 * u], Y = xy[2 * u + 1];
        const double gp = a[0], gu = a[2], gq = a[4], gv = a[7], tq = a[5];
        ac[0 * nt] += X * gp;
        ac[1 * nt] += Y * gp;
        ac[2 * nt] += X * gu;
        ac[3 * nt] += Y * gu;
        ac[4 * nt] += X * X * gq;
        ac[5 * nt] += Y * Y * gq;
        ac[6 * nt] += X * Y * gq;
        ac[7 * nt] += X * gv;
        ac[8 * nt] += Y * gv;
        ac[9 * nt] += (double)a[9];
        ac[10 * nt] += (double)a[10];
        ac[11 * nt] += (double)a[11];
        ac[12 * nt] += (double)a[12];
        ac[13 * nt] += (double)a[13];
        ac[14 * nt] += DF == 2 ? (double)a[12] - (double)a[14]
                               : (double)a[14];
        ac[15 * nt] += (double)a[15];
        ac[16 * nt] += (double)a[16];
        ac[17 * nt] += (double)a[1];
        ac[18 * nt] += (double)a[3];
        ac[19 * nt] += (double)a[6];
        ac[20 * nt] += X * tq;
        ac[21 * nt] += Y * tq;
        ac[22 * nt] += (double)a[8];
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
  Sums a;
  {
    const double* ac = acc + tid;
    a.Gpx = ac[0]; a.Gpy = ac[nt]; a.Gux = ac[2 * nt]; a.Guy = ac[3 * nt];
    a.Gqxx = ac[4 * nt]; a.Gqyy = ac[5 * nt]; a.Gqxy = ac[6 * nt];
    a.Gvx = ac[7 * nt]; a.Gvy = ac[8 * nt];
    a.sInvT = ac[9 * nt]; a.sAlpha = ac[10 * nt];
    a.s0 = ac[11 * nt]; a.s1 = ac[12 * nt]; a.s2 = ac[13 * nt];
    a.s3 = ac[14 * nt]; a.s4 = ac[15 * nt]; a.s5 = ac[16 * nt];
    // the generic node sums of a fixed node: mT cosh = cosh x mT
    const double C = ch, Sh = sh;
    const double SP = ac[17 * nt], SU = ac[18 * nt], S2 = ac[19 * nt];
    const double SX = ac[20 * nt], SY = ac[21 * nt], SV = ac[22 * nt];
    a.Pc = C * SP;
    a.Ps = Sh * SP;
    a.Uc = C * SU;
    a.Us = Sh * SU;
    a.Qcc = C * C * S2;
    a.Qss = Sh * Sh * S2;
    a.Qcs = C * Sh * S2;
    a.Xc = C * SX;
    a.Xs = Sh * SX;
    a.Yc = C * SY;
    a.Ys = Sh * SY;
    a.Vc = C * SV;
    a.Vs = Sh * SV;
  }
  __syncthreads();                       // every sum is read
  const double w = MODE == FIXED3 ? 1.0 : (double)weights[r];
  if (active) finalize<T, DF>(g, a, w, MODE, acc + (size_t)tid * NF);
  __syncthreads();
  // each cell's gradient: its nodes added in node order
  for (int i = tid; i < nc * NF; i += nt) {
    const int c = i / NF, k = i - c * NF;
    double v = 0.0;
    for (int rr = 0; rr < R; ++rr) v += acc[(size_t)(c * R + rr) * NF + k];
    grad[(size_t)(c0 + c) * NF + k] = (T)v;
  }
}

#define IS3D_FBWD_PARAMS                                                      \
  const T *__restrict__ cells, int n_cells, int CT, int S, int SC, int P,    \
      const T *__restrict__ px, const T *__restrict__ py, int F,             \
      const T *__restrict__ nodes, const T *__restrict__ weights, int R,     \
      int RU, int regulate, int outflow, const T *__restrict__ rows,         \
      const T *__restrict__ Gw, T *__restrict__ grad

// float32 is compiled for FIX_MIN_BLOCKS blocks an SM; float64 (its
// registers spill at that budget) for one
template <typename T, int DIM, int DF>
__global__ void __launch_bounds__(FIX_BLOCK,
                                  sizeof(T) == 4 ? FIX_MIN_BLOCKS : 1)
spectra_bwd_kernel(IS3D_FBWD_PARAMS) {
  fixed_bwd_body<T, DIM == 3 ? FIXED3 : FIXED2, DF>(
      cells, n_cells, CT, S, SC, P, px, py, F, nodes, weights, R, RU,
      regulate, outflow, rows, Gw, grad);
}

// The remap body's shared-memory layout: the float64 accumulators (NS
// slots of nt), the momentum points (pT cos phi, pT sin phi, their squares
// and products), pT, the per-(cell, phi) point terms at unit pT (RowU), two
// stage buffers (a species' G (P x F), its node table (P x R x 2), each
// row's weight and mT) and the block's cell rows, placed past the per-
// (cell, node) gradients (nt x NF float64 from 0) that the end writes over
// the accumulators.
template <typename T>
struct alignas(16) RowU {
  T w1, nw2, g, h, c4, nd2, pad0, pad1;
};

constexpr int NS = sizeof(Sums) / sizeof(double);
static_assert(NS == 30, "Sums holds 30 float64 sums");

template <typename T>
struct RSmem {
  double* acc;
  Pt4<T>* pts;
  T *txy, *pTs, *stage, *raw;
  RowU<T>* unit;
  int SB;
  size_t end_;
  __host__ __device__ RSmem(unsigned char* p, int nt, int CT, int P, int F,
                            int R) {
    size_t o = (size_t)NS * nt * sizeof(double);
    acc = reinterpret_cast<double*>(p);
    pts = reinterpret_cast<Pt4<T>*>(p + o);
    o = align16(o + (size_t)P * F * sizeof(Pt4<T>));
    txy = reinterpret_cast<T*>(p + o);
    o = align16(o + (size_t)P * F * sizeof(T));
    pTs = reinterpret_cast<T*>(p + o);
    o = align16(o + (size_t)P * sizeof(T));
    unit = reinterpret_cast<RowU<T>*>(p + o);
    o = align16(o + (size_t)CT * F * sizeof(RowU<T>));
    stage = reinterpret_cast<T*>(p + o);
    SB = P * F + P * R * 2 + 2 * P;
    o = align16(o + 2 * (size_t)SB * sizeof(T));
    const size_t red = (size_t)nt * NF * sizeof(double);
    o = o > red ? o : red;
    raw = reinterpret_cast<T*>(p + o);
    end_ = o + (size_t)CT * NF * sizeof(T);
  }
};

// K9b, the 2+1D mT remap: grid (blocks of CT cells); thread t owns cell
// t / R of the block at node t % R and walks species, then pT rows, then
// phi.  Per (species, pT) row it forms the node kinematics mT cosh Delta,
// mT sinh Delta (Delta = y_flow - s eta_r, from the node table) and the
// composites of the four point terms once, runs the n_phi points with the
// fixed-node body's chain rule, and multiplies the row's sums by the
// kinematics once; per species its sums are flushed to float64.
template <typename T, int DF>
__device__ __forceinline__ void remap_bwd_body(
    const T* __restrict__ cells, int n_cells, int CT,
    const T* __restrict__ mass, const T* __restrict__ sign,
    const T* __restrict__ baryon, const T* __restrict__ deg, int S,
    const T* __restrict__ pT, int P, const T* __restrict__ cos_phi,
    const T* __restrict__ sin_phi, int F, const T* __restrict__ table,
    const T* __restrict__ weights, int R, int regulate, int outflow,
    T prefactor, T t_ref, const T* __restrict__ G, T* __restrict__ grad) {
  using Fx = Fn<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const RSmem<T> s(smem_raw, nt, CT, P, F, R);
  const int c0 = blockIdx.x * CT;
  const int nc = min(CT, n_cells - c0);
  const bool active = tid < nc * R;
  const int ci = active ? tid / R : 0, r = active ? tid - ci * R : 0;

  // tile k: species k's G (P x F) and node table (P x R x 2) by cp.async
  // into buffer k & 1, beside each row's weight prefactor deg s and mT
  auto issue = [&](int k) {
    T* dst = s.stage + (k & 1) * s.SB;
    const T* g0 = G + (size_t)k * P * F;
    for (int i = tid; i < P * F; i += nt) cp_async_elem(dst + i, g0 + i);
    const T* t0 = table + (size_t)k * P * R * 2;
    T* tt = dst + P * F;
    for (int i = tid; i < P * R * 2; i += nt) cp_async_elem(tt + i, t0 + i);
    cp_async_commit();
    T* wr = tt + P * R * 2;
    const T m2 = mass[k] * mass[k], dg = prefactor * deg[k];
    for (int i = tid; i < P; i += nt) {
      const T pt = pT[i];
      const T mT = d_sqrt(m2 + pt * pt);
      wr[i] = dg * d_sqrt(t_ref / (mT > t_ref ? mT : t_ref));
      wr[P + i] = mT;
    }
  };

  for (int i = tid; i < CT * NF; i += nt) {
    const int c = min(i / NF, nc - 1);
    s.raw[i] = cells[(size_t)(c0 + c) * NF + (i - (i / NF) * NF)];
  }
  stage_points(s.pts, s.txy, cos_phi, sin_phi, pT, P, F, true, tid, nt);
  for (int i = tid; i < P; i += nt) s.pTs[i] = pT[i];
  for (int j = 0; j < NS; ++j) s.acc[(size_t)j * nt + tid] = 0.0;
  issue(0);
  __syncthreads();
  // the (cell, phi) point terms at unit pT: p.dsigma's px, py part, u.p's,
  // pi:pp's pT mT cosh and pT mT sinh coefficients and its px^2 .. part,
  // V.p's
  for (int i = tid; i < CT * F; i += nt) {
    const int c = i / F, f = i - c * F;
    const T* q = s.raw + c * NF;
    const T x = cos_phi[f], y = sin_phi[f];
    RowU<T> u;
    u.w1 = q[F_DAX] * x + q[F_DAY] * y;
    u.nw2 = -(q[F_UX] * x + q[F_UY] * y);
    u.g = T(-2) * (q[F_PITX] * x + q[F_PITY] * y);
    u.h = T(2) * q[F_TAU] * (q[F_PIXN] * x + q[F_PIYN] * y);
    u.c4 = q[F_PIXX] * x * x + q[F_PIYY] * y * y + T(2) * q[F_PIXY] * x * y;
    u.nd2 = -(q[F_VX] * x + q[F_VY] * y);
    u.pad0 = u.pad1 = T(0);
    s.unit[i] = u;
  }
  const T* g = s.raw + ci * NF;
  const T tau = g[F_TAU], dat = g[F_DAT], dant = g[F_DANT], ut = g[F_UT];
  const T tun = g[F_TUN], pitt = g[F_PITT], pitn = g[F_PITN];
  const T pinn = g[F_PINN], Vt = g[F_VT], Vn = g[F_VN];
  const T invT = g[F_INVT], alpha = g[F_ALPHAB], ksc = g[F_KSC];
  const T kb0 = g[F_KB0], kb1 = g[F_KB1], kb2 = g[F_KB2], Pi = g[F_BULKPI];
  const T kdv = g[F_KDV], benth = g[F_BENTH], kc3 = g[F_KC3];
  const T kc4 = g[F_KC4];
  const T L = Fx::SCALE;
  const T invTL = L * invT;
  const T dlo = regulate ? T(-1) : -Fx::inf();
  const T dhi = regulate ? T(1) : Fx::inf();
  const T olo = outflow ? T(0) : -Fx::inf();
  const T ey = d_exp(g[F_YFLOW]), eym = d_exp(-g[F_YFLOW]);
  const double w = (double)weights[r];
  const RowU<T>* un = s.unit + ci * F;

  // the species' sums in T, in Sums' order
  T q[NS];
  for (int sp = 0; sp < S; ++sp) {
    cp_async_wait_all();
    __syncthreads();              // tile sp has landed, tile sp - 1 is consumed
    if (sp + 1 < S) issue(sp + 1);
    const T* st = s.stage + (sp & 1) * s.SB;
    const T* tb = st + P * F;
    const T* wr = tb + P * R * 2;
    const T m2 = mass[sp] * mass[sp], sgn = sign[sp], b = baryon[sp];
    const T nab = -L * alpha * b;
#pragma unroll
    for (int j = 0; j < NS; ++j) q[j] = T(0);
    for (int p = 0; p < P && active; ++p) {
      const T pt = s.pTs[p], mT = wr[P + p], wrow = wr[p];
      // the row's node kinematics and composites
      const T hm = T(0.5) * mT;
      const T ep = ey * hm * tb[(p * R + r) * 2];
      const T em = eym * hm * tb[(p * R + r) * 2 + 1];
      const T cp = ep + em;                     // mT cosh(Delta)
      const T sn = ep - em;                     // mT sinh(Delta)
      const T tsp = tau * sn;
      const T A = fma(cp, dat, sn * dant);
      const T B = fma(cp, ut, -(sn * tun));
      const T D = fma(cp, Vt, -(tsp * Vn));
      const T C1 = cp * cp * pitt + tsp * tsp * pinn - T(2) * cp * tsp * pitn;
      const T cpt = cp * pt, spt = sn * pt, pt2 = pt * pt;
      const T* gr = st + p * F;
      const Pt4<T>* pp4 = s.pts + p * F;
      const T* pxy = s.txy + p * F;
      // the row's sums over phi of the four terms' cotangents (and pi:pp's
      // x px, x py)
      T tP = 0, tU = 0, tQ = 0, tQx = 0, tQy = 0, tV = 0;
      // eight points an iteration: independent chains at the same 12
      // warps an SM (by A/B, two against one 0.95, four against two 0.96,
      // eight against four 0.95)
#pragma unroll 8
      for (int f = 0; f < F; ++f) {
        const RowU<T> u = un[f];
        const Pt4<T> v = pp4[f];
        const T gv = wrow * gr[f];
        const T pds = fma(pt, u.w1, A);
        const T pdu = fma(pt, u.nw2, B);
        const T pipp = fma(cpt, u.g, fma(spt, u.h, fma(pt2, u.c4, C1)));
        const T Vp = fma(pt, u.nd2, D);
        // the forward value
        const T feq = Fx::rcp(Fx::exp_scaled(fma(pdu, invTL, nab)) + sgn);
        const T feqbar = fma(-sgn, feq, T(1));
        T df, r_ = T(0);
        if (DF == 1) {
          df = ksc * pipp + (kb0 * m2 + (kb1 * b + kb2 * pdu) * pdu) * Pi
               + (kc3 * b + kc4 * pdu) * Vp;
        } else {
          r_ = Fx::rcp(pdu);
          df = ksc * pipp * r_ + (kb0 * pdu + kb1 * b + kb2 * (pdu - m2 * r_))
               * Pi + (benth - b * r_) * Vp * kdv;
        }
        const T prod = feqbar * df;
        const T dfc = fmin(fmax(prod, dlo), dhi);
        const T fv = fma(feq, dfc, feq);
        const T pp = outflow ? fmax(pds, T(0)) : pds;
        // the chain rule, as torch autograd takes it through plain_block
        const T gp = (!outflow || pds >= T(0)) ? gv * fv : T(0);
        const T gfv = gv * pp;
        const T gprod = (prod >= dlo && prod <= dhi) ? gfv * feq : T(0);
        const T gfeq = fma(gfv, dfc, gfv) - sgn * gprod * df;
        const T gdf = gprod * feqbar;
        const T garg = -gfeq * feq * feqbar;
        T gq, gVp, gu;
        if (DF == 1) {
          gq = gdf * ksc;
          gVp = gdf * (kc3 * b + kc4 * pdu);
          gu = garg * invT
               + gdf * ((kb1 * b + T(2) * kb2 * pdu) * Pi + kc4 * Vp);
          // s1, s2, s4 without their species factor m2, b, b
          const T gu_ = gdf * pdu;
          q[24] = fma(gdf, pipp, q[24]);
          q[25] += gdf;
          q[26] += gu_;
          q[27] = fma(gu_, pdu, q[27]);
          q[28] = fma(gdf, Vp, q[28]);
          q[29] = fma(gu_, Vp, q[29]);
        } else {
          gq = gdf * ksc * r_;
          gVp = gdf * (benth - b * r_) * kdv;
          gu = garg * invT
               + gdf * (-r_ * r_ * (ksc * pipp - kb2 * Pi * m2 - b * Vp * kdv)
                        + (kb0 + kb2) * Pi);
          // s2, s5 without their species factor b; s3 as the sum of
          // gdf r, whose s1 - m2 (.) the species takes
          const T gr = gdf * r_;
          q[24] = fma(gr, pipp, q[24]);
          q[25] = fma(gdf, pdu, q[25]);
          q[26] += gdf;
          q[27] += gr;
          q[28] = fma(gdf, Vp, q[28]);
          q[29] = fma(gr, Vp, q[29]);
        }
        q[22] = fma(garg, pdu, q[22]);          // sInvT
        q[23] += garg;                          // sAlpha / b
        const T x = v.x, y = v.y;
        tP += gp;
        tU += gu;
        tQ += gq;
        tQx = fma(gq, x, tQx);
        tQy = fma(gq, y, tQy);
        tV += gVp;
        q[13] = fma(gp, x, q[13]);              // Gpx
        q[14] = fma(gp, y, q[14]);              // Gpy
        q[15] = fma(gu, x, q[15]);              // Gux
        q[16] = fma(gu, y, q[16]);              // Guy
        q[17] = fma(gq, v.xx, q[17]);           // Gqxx
        q[18] = fma(gq, v.yy, q[18]);           // Gqyy
        q[19] = fma(gq, pxy[f], q[19]);         // Gqxy
        q[20] = fma(gVp, x, q[20]);             // Gvx
        q[21] = fma(gVp, y, q[21]);             // Gvy
      }
      // the row's node sums: mT cosh and mT sinh applied once
      const T cq = cp * tQ, sq = sn * tQ;
      q[0] = fma(cp, tP, q[0]);                 // Pc
      q[1] = fma(sn, tP, q[1]);                 // Ps
      q[2] = fma(cp, tU, q[2]);                 // Uc
      q[3] = fma(sn, tU, q[3]);                 // Us
      q[4] = fma(cp, cq, q[4]);                 // Qcc
      q[5] = fma(sn, sq, q[5]);                 // Qss
      q[6] = fma(cp, sq, q[6]);                 // Qcs
      q[7] = fma(cp, tQx, q[7]);                // Xc
      q[8] = fma(sn, tQx, q[8]);                // Xs
      q[9] = fma(cp, tQy, q[9]);                // Yc
      q[10] = fma(sn, tQy, q[10]);              // Ys
      q[11] = fma(cp, tV, q[11]);               // Vc
      q[12] = fma(sn, tV, q[12]);               // Vs
    }
    // the species' factors of the scalar sums, then into float64
    q[23] *= b;
    if (DF == 1) {
      q[25] *= m2;
      q[26] *= b;
      q[28] *= b;
    } else {
      q[26] *= b;
      q[27] = q[25] - m2 * q[27];
      q[29] *= b;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) s.acc[(size_t)j * nt + tid] += (double)q[j];
  }
  cp_async_wait_all();
  __syncthreads();
  Sums a;
  double* ad = reinterpret_cast<double*>(&a);
  for (int j = 0; j < NS; ++j) ad[j] = s.acc[(size_t)j * nt + tid];
  __syncthreads();                       // every accumulator is read
  if (active) finalize<T, DF>(g, a, w, REMAP, s.acc + (size_t)tid * NF);
  __syncthreads();
  // each cell's gradient: its nodes added in node order
  for (int i = tid; i < nc * NF; i += nt) {
    const int c = i / NF, k = i - c * NF;
    double v = 0.0;
    for (int rr = 0; rr < R; ++rr) v += s.acc[(size_t)(c * R + rr) * NF + k];
    grad[(size_t)(c0 + c) * NF + k] = (T)v;
  }
}

#define IS3D_RBWD_PARAMS                                                      \
  const T *__restrict__ cells, int n_cells, int CT,                          \
      const T *__restrict__ mass, const T *__restrict__ sign,                \
      const T *__restrict__ baryon, const T *__restrict__ deg, int S,        \
      const T *__restrict__ pT, int P, const T *__restrict__ cos_phi,        \
      const T *__restrict__ sin_phi, int F, const T *__restrict__ table,     \
      const T *__restrict__ weights, int R, int regulate, int outflow,       \
      T prefactor, T t_ref, const T *__restrict__ G, T *__restrict__ grad

// float32 is compiled for REMAP_MIN_BLOCKS blocks an SM; float64 (its
// registers spill at that budget) for one
template <typename T, int DF>
__global__ void __launch_bounds__(REMAP_BLOCK,
                                  sizeof(T) == 4 ? REMAP_MIN_BLOCKS : 1)
remap_bwd_kernel(IS3D_RBWD_PARAMS) {
  remap_bwd_body<T, DF>(cells, n_cells, CT, mass, sign, baryon, deg, S, pT,
                        P, cos_phi, sin_phi, F, table, weights, R, regulate,
                        outflow, prefactor, t_ref, G, grad);
}

// the remap's: cells a block, threads and shared memory, or an error code
template <typename T>
int remap_blocking(int P, int F, int R, int* CT, int* threads,
                   size_t* smem) {
  if (R < 1 || R > REMAP_BLOCK || F < 1 || P < 1)
    return cudaErrorInvalidValue;
  *CT = REMAP_BLOCK / R;
  *threads = (*CT * R + 31) / 32 * 32;
  *smem = RSmem<T>(nullptr, *threads, *CT, P, F, R).end_;
  return *smem > MAX_SMEM ? (int)cudaErrorInvalidValue : 0;
}

// K9a's stage row: the values a species' row of one stage holds (its
// nodes' cotangent at the FIX_U angles, 3+1D; FIX_U values, 2+1D), padded
// to whole 16-byte copies
template <typename T>
constexpr int fixed_stage_row(int mode, int R) {
  return ((mode == FIXED3 ? R : 1) * FIX_U + 16 / (int)sizeof(T) - 1) /
         (16 / (int)sizeof(T)) * (16 / (int)sizeof(T));
}

// K9a's launch plan for one shape on the current card: cells a block (CT
// = FIX_BLOCK / R), threads, shared memory, resident blocks an SM, species
// a stage (SC), the values a species' stage row holds (RU) and the waves.
// SC: the fewest species chunks whose two stages fit the shared memory of
// the blocks an SM the registers allow.  The last wave is left as it
// falls: a block size that filled it (12 warps an SM) lost 4.4 % and one
// of 64 threads 3.7 %, by A/B on an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md).
struct FixedPlan {
  int CT, threads, smem, blocks_per_sm, SC, RU, waves;
};

template <typename T>
int fixed_plan(const void* kern, int mode, int S, int F, int R, int n_cells,
               FixedPlan* pl) {
  if (R < 1 || R > FIX_BLOCK || F < 1 || S < 1 || n_cells < 1)
    return cudaErrorInvalidValue;       // also S = 0: no stage to plan
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
  // the blocks an SM the compiled registers hold; the runtime reserves 1 KB
  // of each block's shared memory
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
  *pl = FixedPlan{CT, nt, (int)smem, bps, SC, RU,
                  (int)((blocks + slots - 1) / slots)};
  return 0;
}

template <typename T>
const void* fixed_kernel(int dim, int df) {
  if (dim == 3)
    return df == 1 ? (const void*)spectra_bwd_kernel<T, 3, 1>
                   : (const void*)spectra_bwd_kernel<T, 3, 2>;
  return df == 1 ? (const void*)spectra_bwd_kernel<T, 2, 1>
                 : (const void*)spectra_bwd_kernel<T, 2, 2>;
}

template <typename T>
int launch_fixed(const void* cells, int n_cells, int nf, int S, int P,
                 int F, const void* px, const void* py, const void* nodes,
                 const void* weights, int R, int df, int dim, int regulate,
                 int outflow, int RU, const void* rows, const void* Gw,
                 void* grad, void* stream_v) {
  if (nf != NF || (df != 1 && df != 2) || (dim != 2 && dim != 3) ||
      n_cells < 0 || S < 0 || P < 0)
    return cudaErrorInvalidValue;
  if (n_cells == 0) return cudaSuccess;
  const void* kern = fixed_kernel<T>(dim, df);
  FixedPlan pl;
  const int rc = fixed_plan<T>(kern, dim == 3 ? FIXED3 : FIXED2, S, F, R,
                               n_cells, &pl);
  if (rc != 0) return rc;
  if (RU != pl.RU) return cudaErrorInvalidValue;    // Gw's stage rows
  const T* cells_ = static_cast<const T*>(cells);
  const T* px_ = static_cast<const T*>(px);
  const T* py_ = static_cast<const T*>(py);
  const T* nodes_ = static_cast<const T*>(nodes);
  const T* weights_ = static_cast<const T*>(weights);
  const T* rows_ = static_cast<const T*>(rows);
  const T* Gw_ = static_cast<const T*>(Gw);
  T* grad_ = static_cast<T*>(grad);
  void* args[] = {&cells_, &n_cells, &pl.CT, &S, &pl.SC, &P, &px_, &py_,
                  &F, &nodes_, &weights_, &R, &RU, &regulate, &outflow,
                  &rows_, &Gw_, &grad_};
  const unsigned blocks = (unsigned)((n_cells + pl.CT - 1) / pl.CT);
  cudaError_t e = cudaLaunchKernel(kern, dim3(blocks), dim3(pl.threads),
                                   args, pl.smem,
                                   static_cast<cudaStream_t>(stream_v));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// out: fixed_plan's CT, threads, shared memory bytes, resident blocks an
// SM, then registers and local memory bytes a thread (spills), SC, the
// angles a stage (FIX_U), RU and the waves, of K9a at one shape
template <typename T>
int fixed_props(int dim, int df, int S, int P, int F, int R, int n_cells,
                int* out) {
  if ((df != 1 && df != 2) || (dim != 2 && dim != 3) || P < 1)
    return cudaErrorInvalidValue;
  const void* kern = fixed_kernel<T>(dim, df);
  FixedPlan pl;
  const int rc = fixed_plan<T>(kern, dim == 3 ? FIXED3 : FIXED2, S, F, R,
                               n_cells, &pl);
  if (rc != 0) return rc;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return (int)e;
  const int vals[] = {pl.CT, pl.threads, pl.smem, pl.blocks_per_sm,
                      attr.numRegs, (int)attr.localSizeBytes, pl.SC, FIX_U,
                      pl.RU, pl.waves};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
  return 0;
}

template <typename T>
int launch_remap(const void* cells, int n_cells, int nf, const void* mass,
                 const void* sign, const void* baryon, const void* deg,
                 int S, const void* pT, int P, const void* cos_phi,
                 const void* sin_phi, int F, const void* table,
                 const void* weights, int R, int df, int regulate,
                 int outflow, double prefactor, double t_ref, const void* G,
                 void* grad, void* stream_v) {
  if (nf != NF || (df != 1 && df != 2) || n_cells < 0 || S < 0 || P < 0)
    return cudaErrorInvalidValue;
  if (n_cells == 0) return cudaSuccess;
  if (S == 0 || P == 0) return (int)cudaMemsetAsync(
      grad, 0, (size_t)n_cells * NF * sizeof(T),
      static_cast<cudaStream_t>(stream_v));
  int CT, threads;
  size_t smem;
  const int rc = remap_blocking<T>(P, F, R, &CT, &threads, &smem);
  if (rc != 0) return rc;
  const void* kern = df == 1 ? (const void*)remap_bwd_kernel<T, 1>
                             : (const void*)remap_bwd_kernel<T, 2>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const T* cells_ = static_cast<const T*>(cells);
  const T* mass_ = static_cast<const T*>(mass);
  const T* sign_ = static_cast<const T*>(sign);
  const T* baryon_ = static_cast<const T*>(baryon);
  const T* deg_ = static_cast<const T*>(deg);
  const T* pT_ = static_cast<const T*>(pT);
  const T* cos_ = static_cast<const T*>(cos_phi);
  const T* sin_ = static_cast<const T*>(sin_phi);
  const T* table_ = static_cast<const T*>(table);
  const T* weights_ = static_cast<const T*>(weights);
  T prefactor_ = (T)prefactor, t_ref_ = (T)t_ref;
  const T* G_ = static_cast<const T*>(G);
  T* grad_ = static_cast<T*>(grad);
  void* args[] = {&cells_, &n_cells, &CT, &mass_, &sign_, &baryon_, &deg_,
                  &S, &pT_, &P, &cos_, &sin_, &F, &table_, &weights_, &R,
                  &regulate, &outflow, &prefactor_, &t_ref_, &G_, &grad_};
  const unsigned blocks = (unsigned)((n_cells + CT - 1) / CT);
  e = cudaLaunchKernel(kern, dim3(blocks), dim3(threads), args, smem,
                       static_cast<cudaStream_t>(stream_v));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// out: cells a block, threads, shared memory bytes, resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers a thread and
// local memory bytes a thread (spills) of the remap kernel at one shape
template <typename T>
int remap_props(int df, int P, int F, int R, int* out) {
  if (df != 1 && df != 2) return cudaErrorInvalidValue;
  const void* kern = df == 1 ? (const void*)remap_bwd_kernel<T, 1>
                             : (const void*)remap_bwd_kernel<T, 2>;
  int CT, threads;
  size_t smem;
  const int rc = remap_blocking<T>(P, F, R, &CT, &threads, &smem);
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

// fixed nodes (3+1D, 2+1D): grad (n_cells, NF) of <G, spectra>, from
// kernels/smooth.py:fixed_bwd_stage's rows (P, S, 4) and weighted
// cotangent Gw (P, ceil(F / FIX_U), S, RU)
#define IS3D_BWD_ENTRY(NAME, T)                                               \
  int NAME(const void* cells, int n_cells, int nf, int S, int P, int F,      \
           const void* px, const void* py, const void* nodes,                \
           const void* weights, int R, int df, int dim, int regulate,        \
           int outflow, int RU, const void* rows, const void* Gw,            \
           void* grad, void* stream) {                                       \
    return launch_fixed<T>(cells, n_cells, nf, S, P, F, px, py, nodes,       \
                           weights, R, df, dim, regulate, outflow, RU, rows, \
                           Gw, grad, stream);                                \
  }
IS3D_BWD_ENTRY(is3d_spectra_bwd_f32, float)
IS3D_BWD_ENTRY(is3d_spectra_bwd_f64, double)
#undef IS3D_BWD_ENTRY

// the layout kernels/smooth.py:fixed_bwd_stage gives K9a's cotangent at
// (f64, dim, R), with no call to the card: out = the angles a stage
// (FIX_U), the values a species' stage row holds (RU)
int is3d_spectra_bwd_layout(int f64, int dim, int R, int* out) {
  const int mode = dim == 3 ? FIXED3 : FIXED2;
  out[0] = FIX_U;
  out[1] = f64 ? fixed_stage_row<double>(mode, R)
               : fixed_stage_row<float>(mode, R);
  return 0;
}

// fixed_props<T> of (f64, dim, df) at (S, P, F, R, n_cells): out[10]
int is3d_spectra_bwd_props(int f64, int dim, int df, int S, int P, int F,
                           int R, int n_cells, int* out) {
  return f64 ? fixed_props<double>(dim, df, S, P, F, R, n_cells, out)
             : fixed_props<float>(dim, df, S, P, F, R, n_cells, out);
}

// the 2+1D mT remap: table (S, P, R, 2) as the forward's
#define IS3D_BWD_REMAP_ENTRY(NAME, T)                                         \
  int NAME(const void* cells, int n_cells, int nf, const void* mass,         \
           const void* sign, const void* baryon, const void* deg, int S,     \
           const void* pT, int P, const void* cos_phi, const void* sin_phi,  \
           int F, const void* table, const void* weights, int R, int df,     \
           int regulate, int outflow, double prefactor, double t_ref,        \
           const void* G, void* grad, void* stream) {                        \
    return launch_remap<T>(cells, n_cells, nf, mass, sign, baryon, deg, S,   \
                           pT, P, cos_phi, sin_phi, F, table, weights, R,    \
                           df, regulate, outflow, prefactor, t_ref, G, grad, \
                           stream);                                          \
  }
IS3D_BWD_REMAP_ENTRY(is3d_spectra_bwd_remap_f32, float)
IS3D_BWD_REMAP_ENTRY(is3d_spectra_bwd_remap_f64, double)
#undef IS3D_BWD_REMAP_ENTRY

// remap_props<T> of (f64, df) at (P, F, R)
int is3d_spectra_bwd_remap_props(int f64, int df, int P, int F, int R,
                                 int* out) {
  return f64 ? remap_props<double>(df, P, F, R, out)
             : remap_props<float>(df, P, F, R, out);
}

const char* is3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
