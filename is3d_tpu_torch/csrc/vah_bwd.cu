// The backward pass of the anisotropic-hydro (VAH) smooth spectra for Hopper
// (sm_90a), float32 and float64: the gradient of <G, spectra> with respect
// to the packed cells.
//
// Replaces what JAX runs for the reverse pass of the VAH spectra: XLA's
// reverse of the chunk body _chunk_vah_spectra (is3d_tpu/kernels/vah.py:51)
// under jax.checkpoint (:233-234), driven by is3d_tpu/diff.py:123-130, for
// the fixed-node kernel (vah_bwd_kernel: 3+1D and 2+1D fixed nodes) and the
// 2+1D mT remap (vah_remap_bwd_kernel, the reverse of vah.py:104-110 and
// :199-201).  Like JAX's remat it keeps no forward intermediates: it
// recomputes the emission value at every (cell, node, species, point) from
// the packed cells and chains through it.
//
// Inputs (built by is3d_tpu_torch/kernels/vah.py): cells (n_cells, NV) in
// the order of vah.cuh's `VahField`; the chains SW the forward launched
// (shear 1, bulk 2; a template switch, as in vah.cu); the species and
// momentum constants of the forward; G (n_species, n_pT, n_phi, n_out),
// the output's cotangent (n_out = n_nodes in 3+1D, 1 in 2+1D).
// Output: grad (n_cells, NV), every row written once.
//
// The formula (the plain version's, kernels/vah.py:vah_block, under torch
// autograd).  With g = prefactor deg_s w_node [s] G the weighted cotangent
// of one evaluation, the value p.dsigma f with f = f_a (1 + clip(fabar
// df)), f_a = 1 / (exp(E_a / Lambda) + sign), E_a = sqrt((u.p)^2 + xi_L
// (z.p)^2), every cell field x_k gets
//     grad[c, k] = sum over (node, species, pT, phi) of g d value / d x_k
// by the chain rule through the five point terms p.dsigma, u.p, z.p, pi:pp
// (c4 folded) and W.p, each linear in the cell fields with coefficients
// mT cosh(Delta), mT sinh(Delta), px and py, and through the per-cell
// scalars 1/Lambda, xi_L, c3 and Pi c0..c2.  With the remap the node moves
// with the cell's scale s = a_L sqrt(Lambda / max(mT, Lambda)) (Delta =
// y_flow - s eta_r), which also weights the sum, so y_flow, a_L and Lambda
// get their gradients through Delta and through the weight.  Conventions:
// d max(x, 0)/dx = 1 at x >= 0, d clamp(x, -1, 1)/dx = 1 on [-1, 1], the
// occupation's derivative -f_a (1 - sign f_a), exactly 0 where e^x
// overflows (common.fermi_bose).  A chain off in SW contributes nothing:
// the wrapper refuses a launch whose switched-off columns want a gradient.
//
// What bounds it on this card: FP32 issue.  Each evaluation recomputes the
// forward (a sqrt, an exp and a reciprocal beside ~15 FP32 operations) and
// adds the chain rule and the point sums (kernels/vah.py,
// vah_backward_formula_ops); the cells of a group are 2.3 MB and G, read
// once a block, stays in L2.
//
// Design: a per-cell reduction (K9a's, smooth_spectra_bwd.cu) with the
// cotangent staged a tile at a time, as csrc/feqmod_bwd.cu.
//   * A thread owns one (cell, node) pair and walks every (species, pT,
//     phi); a block holds CT cells x all nodes, so nothing of a cell's sum
//     leaves the block.
//   * G is staged a tile at a time: a species' P rows (2+1D: P x F values)
//     or, in 3+1D where G has the node axis, PT3 = 4 of its rows, copied
//     with cp.async into one of two buffers while the other is consumed,
//     beside the tile's mT: one barrier a tile, not two a row.  The
//     momentum points (px, py; the remap's pT cos phi, pT sin phi, and with
//     the shear chain px^2, py^2, px py for pi:pp) are staged once a
//     block.  The thread forms the node kinematics mT cosh,
//     mT sinh of its node once per (species, pT) (with the remap from one
//     exp) and the composites of the five point terms, then runs the n_phi
//     points.
//   * The accumulator.  One cell's gradient sums S x P x F x nodes terms
//     (5.2e6 in 3+1D at 320 x 32 x 24 x 21, 1.2e7 with the 48-node remap).
//     The sums over the n_phi points of a row run in T (24 terms); each
//     row's sums times its node kinematics are added in T to registers,
//     one a column the chains SW touch (16 with every chain off, 35 with
//     both: VCols), which are added in float64 to the thread's accumulators
//     in shared memory once a species.  In float32 a register so holds a
//     species' P x F = 768 terms before float64 takes over: at most ~768 x
//     2^-24 = 5e-5 of the species' sum of magnitudes, typically 2e-6,
//     inside the 2e-4 the checks allow.
//   * No atomics.  At the end the block adds each cell's nodes in node
//     order in float64 and one thread writes each entry: two launches give
//     identical bits.
//   * float32 takes the forward kernel's instructions (folded.cuh's
//     Fn<float>, vah.cuh's vah_f): ex2.approx, rcp.approx (1 / E too) and
//     sqrt.approx for E, +inf -> 0, so an overflowed exponential gives f_a
//     = 0 and every term of the evaluation exactly 0; float64 keeps IEEE
//     arithmetic.

#include <cuda_runtime.h>

#include <type_traits>

#include "bwd_stage.cuh"
#include "vah.cuh"

namespace {

using namespace is3d;

constexpr int BLOCK = 128;       // most threads a block: CT cells x nodes
constexpr int PT3 = 4;           // pT rows a tile in 3+1D
constexpr size_t MAX_SMEM = 232448;

enum Mode { FIXED3 = 0, FIXED2 = 1, REMAP = 2 };

// the columns the chains SW touch (VahField order): f_a eta .. y_flow;
// the shear chain tau and c3 .. pi_perp^xy, the bulk chain Pi c0 .. c2
template <int SW> struct VCols;
template <> struct VCols<0> : Cols<V_ETA, V_C3> {};
template <> struct VCols<VSW_SHEAR> : Cols<V_TAU, V_BC0> {};
template <> struct VCols<VSW_BULK> : Cols<V_ETA, V_C3, V_BC0, NV> {};
template <> struct VCols<VSW_SHEAR | VSW_BULK> : Cols<0, NV> {};

__host__ __device__ constexpr int n_slots(int sw) {
  return sw == 0 ? VCols<0>::N : sw == 1 ? VCols<1>::N
         : sw == 2 ? VCols<2>::N : VCols<3>::N;
}

// shared memory: the float64 accumulators (NC slots of nt), the momentum
// points (stage_points: with the shear chain's squares, Pt4, and px py,
// txy; Pt2 without), the block's cell rows and two stage buffers (a tile
// of G and its rows' mT)
template <typename T>
struct Smem {
  double* acc;
  void* tab;
  T *txy, *raw, *stage;
  int SB;
  __host__ __device__ Smem(unsigned char* p, int nt, int NC, int CT, int P,
                           int F, int PT, int RG, bool sq) {
    acc = reinterpret_cast<double*>(p);
    tab = acc + (size_t)NC * nt;
    unsigned char* t = static_cast<unsigned char*>(tab);
    txy = reinterpret_cast<T*>(t + (size_t)P * F * (sq ? sizeof(Pt4<T>)
                                                       : sizeof(Pt2<T>)));
    raw = txy + (sq ? P * F : 0);
    stage = raw + CT * NV;
    SB = PT * F * RG + PT;
  }
  __host__ __device__ size_t bytes(const unsigned char* p) const {
    return reinterpret_cast<const unsigned char*>(stage + 2 * SB) - p;
  }
};

// pi:pp's and its sums' terms in px^2, py^2 and px py from the staged
// squares (the shear chain's Pt4; Pt2 bodies have no shear chain)
template <typename T>
__device__ __forceinline__ T sq_terms(const Pt4<T>& v, T xy, T lin, T kxx,
                                      T kyy, T kxy2) {
  return lin + kxx * v.xx + kyy * v.yy + kxy2 * xy;
}
template <typename T>
__device__ __forceinline__ T sq_terms(const Pt2<T>&, T, T lin, T, T, T) {
  return lin;
}
template <typename T>
__device__ __forceinline__ void sq_sums(const Pt4<T>& v, T xy, T g, T& sxx,
                                        T& syy, T& sxy) {
  sxx += g * v.xx;
  syy += g * v.yy;
  sxy += g * xy;
}
template <typename T>
__device__ __forceinline__ void sq_sums(const Pt2<T>&, T, T, T&, T&, T&) {}

// grid (blocks of CT cells); thread t owns cell t / R of the block at node
// t % R.  xt, yt: px, py (n_pT, n_phi) at fixed nodes, cos, sin phi
// (n_phi) with the remap
template <typename T, int MODE, int SW>
__device__ __forceinline__ void vah_bwd_body(
    const T* __restrict__ cells, int n_cells, int CT,
    const T* __restrict__ mass, const T* __restrict__ sign,
    const T* __restrict__ deg, int S, const T* __restrict__ pT, int P,
    const T* __restrict__ xt, const T* __restrict__ yt, int F,
    const T* __restrict__ nodes, const T* __restrict__ weights, int R,
    int regulate, int outflow, T prefactor, const T* __restrict__ G,
    T* __restrict__ grad) {
  using Fx = Fn<T>;
  using C = VCols<SW>;
  constexpr int NC = C::N;
  constexpr bool SH = (SW & VSW_SHEAR) != 0;
  constexpr bool BU = (SW & VSW_BULK) != 0;
  constexpr bool RG1 = MODE != FIXED3;           // G has no node axis
  const int RG = RG1 ? 1 : R;
  const int PT = MODE == FIXED3 ? min(PT3, P) : P;
  const int TP = (P + PT - 1) / PT;              // tiles a species
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nt = blockDim.x;
  using PtT = std::conditional_t<SH, Pt4<T>, Pt2<T>>;
  const Smem<T> s(smem_raw, nt, NC, CT, P, F, PT, RG, SH);
  PtT* const tab = static_cast<PtT*>(s.tab);
  const int c0 = blockIdx.x * CT;
  const int nc = min(CT, n_cells - c0);
  const bool active = tid < nc * R;
  const int ci = active ? tid / R : 0, r = active ? tid - ci * R : 0;

  // tile k: G's rows (cp.async into buffer k & 1) and their mT
  auto issue = [&](int k) {
    const int sp = k / TP, p0 = (k - sp * TP) * PT;
    const int rows = min(PT, P - p0);
    T* dst = s.stage + (k & 1) * s.SB;
    const T* src = G + ((size_t)sp * P + p0) * F * RG;
    const int n = rows * F * RG;
    for (int i = tid; i < n; i += nt) cp_async_elem(dst + i, src + i);
    cp_async_commit();
    T* mts = dst + PT * F * RG;
    const T m2 = mass[sp] * mass[sp];
    for (int i = tid; i < rows; i += nt) {
      const T pt = pT[p0 + i];
      mts[i] = d_sqrt(m2 + pt * pt);
    }
  };

  for (int i = tid; i < CT * NV; i += nt) {
    const int c = min(i / NV, nc - 1);
    s.raw[i] = cells[(size_t)(c0 + c) * NV + (i - (i / NV) * NV)];
  }
  stage_points(tab, s.txy, xt, yt, pT, P, F, MODE == REMAP, tid, nt);
  for (int j = 0; j < NC; ++j) s.acc[(size_t)j * nt + tid] = 0.0;
  issue(0);
  __syncthreads();
  const T* g = s.raw + ci * NV;
  const T tau = g[V_TAU], dat = g[V_DAT], dant = g[V_DANT], dax = g[V_DAX];
  const T day = g[V_DAY], ut = g[V_UT], tun = g[V_TUN], zt = g[V_ZT];
  const T tzn = g[V_TZN], ux = g[V_UX], uy = g[V_UY], xiL = g[V_XIL];
  const T invLam = g[V_INVLAM], aL = g[V_AL], lam = g[V_LAM];
  const T invLamL = Fx::SCALE * invLam;
  const T lo = regulate ? T(-1) : -Fx::inf();
  const T hi = regulate ? T(1) : Fx::inf();
  const T eta_r = nodes[r];
  const T w = MODE == FIXED3 ? T(1) : weights[r];
  // fixed nodes: the thread's node kinematics
  T ch = T(1), sh = T(0);
  if (MODE != REMAP) {
    const T delta = MODE == FIXED3 ? eta_r - g[V_ETA] : -eta_r;
    ch = d_cosh(delta);
    sh = d_sinh(delta);
  }

  T ra[NC];
  T m2 = T(0), sgn = T(0), dg = T(0);
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
      m2 = mass[sp] * mass[sp];
      sgn = sign[sp];
      dg = prefactor * deg[sp];
    }
    const T* st = s.stage + (k & 1) * s.SB;
    const T* mts = st + PT * F * RG;
    for (int q = 0; q < rows && active; ++q) {
      const T mT = mts[q];
      // the node kinematics of this (species, pT): cp = mT cosh(Delta),
      // sn = mT sinh(Delta); with the remap Delta = y_flow - s eta_r, s =
      // a_L q, q = sqrt(Lambda / max(mT, Lambda)), and the weight x s
      T cp, sn, qs = T(0), dq = T(0), sc = T(1);
      if (MODE != REMAP) {
        cp = mT * ch;
        sn = mT * sh;
      } else {
        qs = d_sqrt(lam / (mT > lam ? mT : lam));
        dq = mT > lam ? qs / (T(2) * lam) : T(0);
        sc = aL * qs;
        const T e = d_exp(g[V_YFLOW] - sc * eta_r);
        const T em = Fx::rcp(e);
        cp = T(0.5) * mT * (e + em);
        sn = T(0.5) * mT * (e - em);
      }
      const T* gr = st + q * F * RG + (RG1 ? 0 : r);
      const PtT* tb = tab + (p0 + q) * F;
      const T* txy = s.txy + (p0 + q) * F;
      const T wg = dg * w;
      const T A = cp * dat + sn * dant;
      const T B = cp * ut - sn * tun;
      const T Z = cp * zt - sn * tzn;
      const T XZ = xiL * Z * Z;
      T C1 = T(0), CX = T(0), CY = T(0), E1 = T(0);
      if (SH) {
        C1 = cp * cp * g[V_KPITT] + tau * tau * sn * sn * g[V_KPINN]
             - T(2) * tau * cp * sn * g[V_KPITN];
        CX = T(-2) * (cp * g[V_KPITX] - tau * sn * g[V_KPIXN]);
        CY = T(-2) * (cp * g[V_KPITY] - tau * sn * g[V_KPIYN]);
        E1 = cp * g[V_WT] - sn * g[V_TWN];
      }
      const T c3 = SH ? g[V_C3] : T(0), Wx = SH ? g[V_WX] : T(0);
      const T Wy = SH ? g[V_WY] : T(0), kpixx = SH ? g[V_KPIXX] : T(0);
      const T kpiyy = SH ? g[V_KPIYY] : T(0);
      const T kpixy2 = SH ? T(2) * g[V_KPIXY] : T(0);
      const T bc0 = BU ? g[V_BC0] : T(0), bc1 = BU ? g[V_BC1] : T(0);
      const T bc2 = BU ? g[V_BC2] : T(0);
      // the row's sums over phi, in T: the point terms' cotangents (and x
      // px, py where the term has them) and the scalars' sums
      T tP = 0, tPx = 0, tPy = 0, tU = 0, tUx = 0, tUy = 0, tZ = 0;
      T tQ = 0, tQx = 0, tQy = 0, tQxx = 0, tQyy = 0, tQxy = 0;
      T tW = 0, tWx = 0, tWy = 0;
      T tIL = 0, tXi = 0, tC3 = 0, tB0 = 0, tB1 = 0, tB2 = 0, tS = 0;
      for (int f = 0; f < F; ++f) {
        const PtT v = tb[f];
        const T x = v.x, y = v.y;
        const T g0 = gr[f * RG] * wg;
        const T gv = MODE == REMAP ? g0 * sc : g0;
        const T pds = A + dax * x + day * y;
        const T pdu = B - (ux * x + uy * y);
        const T E = fq_sqrt(fma(pdu, pdu, XZ));
        const T fa = Fx::rcp(Fx::exp_scaled(E * invLamL) + sgn);
        const T fabar = T(1) - sgn * fa;
        T fv = fa, df = T(0), prod = T(0), dc = T(0), pipp = T(0);
        T Wp = T(0);
        if (SH) {
          pipp = sq_terms(v, txy[f], C1 + x * CX + y * CY, kpixx, kpiyy,
                          kpixy2);
          Wp = E1 - (Wx * x + Wy * y);
          df = pipp + c3 * Z * Wp;
        }
        if (BU) df = df + bc0 * m2 + bc1 * Z * Z + bc2 * pdu * pdu;
        if (SH || BU) {
          prod = fabar * df;
          dc = prod < lo ? lo : (prod > hi ? hi : prod);
          fv = fa * dc + fa;
        }
        const T pp = outflow ? fmax(pds, T(0)) : pds;
        const T gp = (!outflow || pds >= T(0)) ? gv * fv : T(0);
        const T gf = gv * pp;
        if (MODE == REMAP) tS += g0 * pp * fv;
        T gfa = gf, gdf = T(0);
        if (SH || BU) {
          const T gd = (prod >= lo && prod <= hi) ? gf * fa : T(0);
          gfa = gf * (dc + T(1)) - sgn * gd * df;
          gdf = gd * fabar;
        }
        const T garg = -gfa * fa * fabar;
        tIL += garg * E;
        const T hE = E > T(0) ? garg * invLam * Fx::rcp(E) : T(0);
        T gu = hE * pdu, gz = hE * xiL * Z;
        tXi += T(0.5) * hE * Z * Z;
        if (SH) {
          const T gw = gdf * c3 * Z;
          gz += gdf * c3 * Wp;
          tC3 += gdf * Z * Wp;
          tQ += gdf;
          tQx += gdf * x;
          tQy += gdf * y;
          sq_sums(v, txy[f], gdf, tQxx, tQyy, tQxy);
          tW += gw;
          tWx += gw * x;
          tWy += gw * y;
        }
        if (BU) {
          tB0 += gdf * m2;
          tB1 += gdf * Z * Z;
          tB2 += gdf * pdu * pdu;
          gz += T(2) * gdf * bc1 * Z;
          gu += T(2) * gdf * bc2 * pdu;
        }
        tP += gp;
        tPx += gp * x;
        tPy += gp * y;
        tU += gu;
        tUx += gu * x;
        tUy += gu * y;
        tZ += gz;
      }
      // the row into the species' registers: the node kinematics applied
      const T two = T(2);
      radd<C, V_DAT>(ra, cp * tP);
      radd<C, V_DANT>(ra, sn * tP);
      radd<C, V_DAX>(ra, tPx);
      radd<C, V_DAY>(ra, tPy);
      radd<C, V_UT>(ra, cp * tU);
      radd<C, V_TUN>(ra, -(sn * tU));
      radd<C, V_UX>(ra, -tUx);
      radd<C, V_UY>(ra, -tUy);
      radd<C, V_ZT>(ra, cp * tZ);
      radd<C, V_TZN>(ra, -(sn * tZ));
      radd<C, V_XIL>(ra, tXi);
      radd<C, V_INVLAM>(ra, tIL);
      // d/dDelta: d(mT cosh)/dDelta = mT sinh and back
      T gdel = (sn * dat + cp * dant) * tP + (sn * ut - cp * tun) * tU
               + (sn * zt - cp * tzn) * tZ;
      if constexpr (SH) {
        const T kpitt = g[V_KPITT], kpinn = g[V_KPINN], kpitn = g[V_KPITN];
        const T kpitx = g[V_KPITX], kpixn = g[V_KPIXN], kpity = g[V_KPITY];
        const T kpiyn = g[V_KPIYN];
        radd<C, V_KPITT>(ra, cp * cp * tQ);
        radd<C, V_KPINN>(ra, tau * tau * sn * sn * tQ);
        radd<C, V_KPITN>(ra, -(two * tau * cp * sn * tQ));
        radd<C, V_KPITX>(ra, -(two * cp * tQx));
        radd<C, V_KPIXN>(ra, two * tau * sn * tQx);
        radd<C, V_KPITY>(ra, -(two * cp * tQy));
        radd<C, V_KPIYN>(ra, two * tau * sn * tQy);
        radd<C, V_KPIXX>(ra, tQxx);
        radd<C, V_KPIYY>(ra, tQyy);
        radd<C, V_KPIXY>(ra, two * tQxy);
        radd<C, V_TAU>(ra, two * tau * kpinn * sn * sn * tQ
                               - two * kpitn * cp * sn * tQ
                               + two * kpixn * sn * tQx
                               + two * kpiyn * sn * tQy);
        radd<C, V_C3>(ra, tC3);
        radd<C, V_WT>(ra, cp * tW);
        radd<C, V_TWN>(ra, -(sn * tW));
        radd<C, V_WX>(ra, -tWx);
        radd<C, V_WY>(ra, -tWy);
        gdel += (two * cp * sn * kpitt + two * tau * tau * sn * cp * kpinn
                 - two * tau * (sn * sn + cp * cp) * kpitn) * tQ
                - two * (sn * kpitx - tau * cp * kpixn) * tQx
                - two * (sn * kpity - tau * cp * kpiyn) * tQy
                + (sn * g[V_WT] - cp * g[V_TWN]) * tW;
      }
      if constexpr (BU) {
        radd<C, V_BC0>(ra, tB0);
        radd<C, V_BC1>(ra, tB1);
        radd<C, V_BC2>(ra, tB2);
      }
      if (MODE == FIXED3) radd<C, V_ETA>(ra, -gdel);     // Delta = y - eta
      if (MODE == REMAP) {
        // Delta = y_flow - s eta_r, and s weights the value
        radd<C, V_YFLOW>(ra, gdel);
        const T gs_ = -(eta_r * gdel) + tS;
        radd<C, V_AL>(ra, qs * gs_);
        radd<C, V_LAM>(ra, aL * dq * gs_);
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
  // of the chains SW leaves off)
  for (int i = tid; i < nc * NV; i += nt) {
    const int c = i / NV, k = i - c * NV;
    const int j = C::slot(k);
    double v = 0.0;
    if (j >= 0)
      for (int rr = 0; rr < R; ++rr) v += s.acc[(size_t)j * nt + c * R + rr];
    grad[(size_t)(c0 + c) * NV + k] = (T)v;
  }
}

#define IS3D_VBWD_PARAMS                                                      \
  const T *__restrict__ cells, int n_cells, int CT,                          \
      const T *__restrict__ mass, const T *__restrict__ sign,                \
      const T *__restrict__ deg, int S, const T *__restrict__ pT, int P,     \
      const T *__restrict__ xt, const T *__restrict__ yt, int F,             \
      const T *__restrict__ nodes, const T *__restrict__ weights, int R,     \
      int regulate, int outflow, T prefactor, const T *__restrict__ G,       \
      T *__restrict__ grad
#define IS3D_VBWD_ARGS                                                        \
  cells, n_cells, CT, mass, sign, deg, S, pT, P, xt, yt, F, nodes, weights,  \
      R, regulate, outflow, prefactor, G, grad

template <typename T, int DIM, int SW>
__global__ void __launch_bounds__(BLOCK)
vah_bwd_kernel(IS3D_VBWD_PARAMS) {
  vah_bwd_body<T, DIM == 3 ? FIXED3 : FIXED2, SW>(IS3D_VBWD_ARGS);
}

// the gated float32 remap (the main path's) is compiled for 6 blocks an
// SM: 79 registers, no spills, 8 blocks resident against 6 at 90, 0.95 of
// the time by A/B; the shear bodies and float64 keep the default
template <typename T, int SW>
__global__ void __launch_bounds__(
    BLOCK, (sizeof(T) == 4 && (SW & VSW_SHEAR) == 0) ? 6 : 1)
vah_remap_bwd_kernel(IS3D_VBWD_PARAMS) {
  vah_bwd_body<T, REMAP, SW>(IS3D_VBWD_ARGS);
}

// cells a block, its threads and its shared memory for a shape, or an
// error code
template <typename T>
int blocking(int mode, int sw, int P, int F, int R, int* CT, int* threads,
             size_t* smem) {
  if (R < 1 || R > BLOCK || F < 1 || P < 1) return cudaErrorInvalidValue;
  *CT = BLOCK / R;
  *threads = (*CT * R + 31) / 32 * 32;
  const int PT = mode == FIXED3 ? (P < PT3 ? P : PT3) : P;
  const Smem<T> s(nullptr, *threads, n_slots(sw), *CT, P, F, PT,
                  mode == FIXED3 ? R : 1, (sw & VSW_SHEAR) != 0);
  *smem = s.bytes(nullptr);
  return *smem > MAX_SMEM ? (int)cudaErrorInvalidValue : 0;
}

// the kernel of (T, mode, chains sw), or nullptr
template <typename T>
const void* kernel_of(int mode, int sw) {
#define IS3D_VK(SW_)                                                          \
  (mode == FIXED3 ? (const void*)vah_bwd_kernel<T, 3, SW_>                   \
   : mode == FIXED2 ? (const void*)vah_bwd_kernel<T, 2, SW_>                 \
                    : (const void*)vah_remap_bwd_kernel<T, SW_>)
  switch (sw) {
    case 0: return IS3D_VK(0);
    case 1: return IS3D_VK(1);
    case 2: return IS3D_VK(2);
    case 3: return IS3D_VK(3);
    default: return nullptr;
  }
#undef IS3D_VK
}

template <typename T>
int launch(int mode, const void* cells, int n_cells, int nv,
           const void* mass, const void* sign, const void* deg, int S,
           const void* pT, int P, const void* xt, const void* yt, int F,
           const void* nodes, const void* weights, int R, int sw,
           int regulate, int outflow, double prefactor, const void* G,
           void* grad, void* stream_v) {
  if (nv != NV || sw < 0 || sw > 3 || n_cells < 0 || S < 1 || P < 1)
    return cudaErrorInvalidValue;
  if (n_cells == 0) return cudaSuccess;
  const void* kern = kernel_of<T>(mode, sw);
  int CT, threads;
  size_t smem;
  const int rc = blocking<T>(mode, sw, P, F, R, &CT, &threads, &smem);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const T* cells_ = static_cast<const T*>(cells);
  const T* mass_ = static_cast<const T*>(mass);
  const T* sign_ = static_cast<const T*>(sign);
  const T* deg_ = static_cast<const T*>(deg);
  const T* pT_ = static_cast<const T*>(pT);
  const T* xt_ = static_cast<const T*>(xt);
  const T* yt_ = static_cast<const T*>(yt);
  const T* nodes_ = static_cast<const T*>(nodes);
  const T* weights_ = static_cast<const T*>(weights);
  T prefactor_ = (T)prefactor;
  const T* G_ = static_cast<const T*>(G);
  T* grad_ = static_cast<T*>(grad);
  void* args[] = {&cells_, &n_cells, &CT, &mass_, &sign_, &deg_, &S, &pT_,
                  &P, &xt_, &yt_, &F, &nodes_, &weights_, &R, &regulate,
                  &outflow, &prefactor_, &G_, &grad_};
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
int props(int mode, int sw, int P, int F, int R, int* out) {
  const void* kern = kernel_of<T>(mode, sw);
  if (kern == nullptr) return cudaErrorInvalidValue;
  int CT, threads;
  size_t smem;
  const int rc = blocking<T>(mode, sw, P, F, R, &CT, &threads, &smem);
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

// fixed nodes (3+1D, 2+1D): grad (n_cells, NV) of <G, spectra> for the
// chains sw
#define IS3D_VBWD_ENTRY(NAME, T)                                              \
  int NAME(const void* cells, int n_cells, int nv, const void* mass,         \
           const void* sign, const void* deg, int S, const void* pT,         \
           const void* px, const void* py, int P, int F, const void* nodes,  \
           const void* weights, int R, int dim, int sw, int regulate,        \
           int outflow, double prefactor, const void* G, void* grad,         \
           void* stream) {                                                   \
    if (dim != 2 && dim != 3) return cudaErrorInvalidValue;                 \
    return launch<T>(dim == 3 ? FIXED3 : FIXED2, cells, n_cells, nv, mass,   \
                     sign, deg, S, pT, P, px, py, F, nodes, weights, R, sw,  \
                     regulate, outflow, prefactor, G, grad, stream);         \
  }
IS3D_VBWD_ENTRY(is3d_vah_bwd_f32, float)
IS3D_VBWD_ENTRY(is3d_vah_bwd_f64, double)
#undef IS3D_VBWD_ENTRY

// the 2+1D mT remap: the nodes eta_r move per (cell, species, pT)
#define IS3D_VBWD_REMAP_ENTRY(NAME, T)                                        \
  int NAME(const void* cells, int n_cells, int nv, const void* mass,         \
           const void* sign, const void* deg, int S, const void* pT, int P,  \
           const void* cos_phi, const void* sin_phi, int F,                  \
           const void* nodes, const void* weights, int R, int sw,            \
           int regulate, int outflow, double prefactor, const void* G,       \
           void* grad, void* stream) {                                       \
    return launch<T>(REMAP, cells, n_cells, nv, mass, sign, deg, S, pT, P,   \
                     cos_phi, sin_phi, F, nodes, weights, R, sw, regulate,   \
                     outflow, prefactor, G, grad, stream);                   \
  }
IS3D_VBWD_REMAP_ENTRY(is3d_vah_bwd_remap_f32, float)
IS3D_VBWD_REMAP_ENTRY(is3d_vah_bwd_remap_f64, double)
#undef IS3D_VBWD_REMAP_ENTRY

// props<T> of (f64, dim: 3, 2 fixed nodes or 0 the remap, chains sw) at
// (P, F, R)
int is3d_vah_bwd_props(int f64, int dim, int sw, int P, int F, int R,
                       int* out) {
  if (dim != 0 && dim != 2 && dim != 3) return cudaErrorInvalidValue;
  const int mode = dim == 3 ? FIXED3 : dim == 2 ? FIXED2 : REMAP;
  return f64 ? props<double>(mode, sw, P, F, R, out)
             : props<float>(mode, sw, P, F, R, out);
}

const char* is3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
