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
// Design: K9a's (smooth_spectra_bwd.cu) per-cell reduction.
//   * A thread owns one (cell, node) pair and walks every (species, pT,
//     phi); a block holds CT cells x all nodes, so nothing of a cell's sum
//     leaves the block.
//   * Per (species, pT) the block stages G's row (all phi, and in 3+1D all
//     nodes) in shared memory, weighted by prefactor x degeneracy, and the
//     row's px, py.  The thread forms the node kinematics mT cosh, mT sinh
//     of its node once per (species, pT) (with the remap from one exp) and
//     the composites of the five point terms, then runs the n_phi points.
//   * The accumulator.  One cell's gradient sums S x P x F x nodes terms
//     (5.2e6 in 3+1D at 320 x 32 x 24 x 21, 1.2e7 with the 48-node remap).
//     The sums over the n_phi points of a row run in T (24 terms); each
//     row's sums are multiplied by its node kinematics and added in float64
//     to the thread's NV accumulators, which live in shared memory (one
//     column a thread: no bank conflicts, no registers held across rows).
//   * No atomics.  At the end the block adds each cell's nodes in node
//     order in float64 and one thread writes each entry: two launches give
//     identical bits.
//   * float32 takes ex2.approx and rcp.approx as the forward kernel does
//     (folded.cuh, Fn<float>): +inf -> 0, so an overflowed exponential
//     gives f_a = 0 and every term of the evaluation exactly 0.
// A first version: simple and right; its time against its bound is in
// PERF.md.

#include <cuda_runtime.h>

#include "vah.cuh"

namespace {

using namespace is3d;

constexpr int BLOCK = 128;       // most threads a block: CT cells x nodes
constexpr size_t MAX_SMEM = 232448;

enum Mode { FIXED3 = 0, FIXED2 = 1, REMAP = 2 };

// shared memory: the float64 accumulators (NV columns of nt), the block's
// cell rows, the staged cotangent row and the row's px, py
template <typename T>
struct Smem {
  double* acc;
  T *raw, *gs, *pxs, *pys, *end_;
  __host__ __device__ Smem(unsigned char* p, int nt, int CT, int F, int RG) {
    acc = reinterpret_cast<double*>(p);
    raw = reinterpret_cast<T*>(acc + (size_t)NV * nt);
    gs = raw + CT * NV;
    pxs = gs + F * RG;
    pys = pxs + F;
    end_ = pys + F;
  }
  __host__ __device__ size_t bytes(const unsigned char* p) const {
    return reinterpret_cast<const unsigned char*>(end_) - p;
  }
};

// grid (blocks of CT cells); thread t owns cell t / R of the block at node
// t % R
template <typename T, int MODE, int SW>
__device__ __forceinline__ void vah_bwd_body(
    const T* __restrict__ cells, int n_cells, int CT,
    const T* __restrict__ mass, const T* __restrict__ sign,
    const T* __restrict__ deg, int S, const T* __restrict__ pT, int P,
    const T* __restrict__ px, const T* __restrict__ py,
    const T* __restrict__ cos_phi, const T* __restrict__ sin_phi, int F,
    const T* __restrict__ nodes, const T* __restrict__ weights, int R,
    int regulate, int outflow, T prefactor, const T* __restrict__ G,
    T* __restrict__ grad) {
  using Fx = Fn<T>;
  constexpr bool SH = (SW & VSW_SHEAR) != 0;
  constexpr bool BU = (SW & VSW_BULK) != 0;
  constexpr bool RG1 = MODE != FIXED3;           // G has no node axis
  const int RG = RG1 ? 1 : R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const Smem<T> s(smem_raw, nt, CT, F, RG);
  const int c0 = blockIdx.x * CT;
  const int nc = min(CT, n_cells - c0);
  const bool active = tid < nc * R;
  const int ci = active ? tid / R : 0, r = active ? tid - ci * R : 0;

  for (int i = tid; i < CT * NV; i += nt) {
    const int c = min(i / NV, nc - 1);
    s.raw[i] = cells[(size_t)(c0 + c) * NV + (i - (i / NV) * NV)];
  }
  double* a = s.acc + tid;
  for (int k = 0; k < NV; ++k) a[k * nt] = 0.0;
  __syncthreads();
  const T* g = s.raw + ci * NV;
  const T tau = g[V_TAU], dat = g[V_DAT], dant = g[V_DANT], dax = g[V_DAX];
  const T day = g[V_DAY], ut = g[V_UT], tun = g[V_TUN], zt = g[V_ZT];
  const T tzn = g[V_TZN], ux = g[V_UX], uy = g[V_UY], xiL = g[V_XIL];
  const T invLam = g[V_INVLAM], aL = g[V_AL], lam = g[V_LAM];
  const T c3 = g[V_C3], Wt = g[V_WT], tWn = g[V_TWN], Wx = g[V_WX];
  const T Wy = g[V_WY], kpitt = g[V_KPITT], kpinn = g[V_KPINN];
  const T kpitn = g[V_KPITN], kpitx = g[V_KPITX], kpixn = g[V_KPIXN];
  const T kpity = g[V_KPITY], kpiyn = g[V_KPIYN], kpixx = g[V_KPIXX];
  const T kpiyy = g[V_KPIYY], kpixy = g[V_KPIXY], bc0 = g[V_BC0];
  const T bc1 = g[V_BC1], bc2 = g[V_BC2];
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
  const double taud = tau;

  for (int sp = 0; sp < S; ++sp) {
    const T m2 = mass[sp] * mass[sp], sgn = sign[sp];
    const T dg = prefactor * deg[sp];
    for (int p = 0; p < P; ++p) {
      const T pt = pT[p];
      __syncthreads();                   // the previous row is consumed
      for (int i = tid; i < F * RG; i += nt)
        s.gs[i] = dg * G[((size_t)sp * P + p) * F * RG + i];
      for (int i = tid; i < F; i += nt) {
        s.pxs[i] = MODE == REMAP ? pt * cos_phi[i] : px[p * F + i];
        s.pys[i] = MODE == REMAP ? pt * sin_phi[i] : py[p * F + i];
      }
      __syncthreads();
      if (!active) continue;
      const T mT = d_sqrt(m2 + pt * pt);
      // the node kinematics of this (species, pT): cp = mT cosh(Delta),
      // sn = mT sinh(Delta); with the remap Delta = y_flow - s eta_r, s =
      // a_L q, q = sqrt(Lambda / max(mT, Lambda)), and the weight x s
      T cp, sn, q = T(0), dq = T(0), sc = T(1);
      if (MODE != REMAP) {
        cp = mT * ch;
        sn = mT * sh;
      } else {
        q = d_sqrt(lam / (mT > lam ? mT : lam));
        dq = mT > lam ? q / (T(2) * lam) : T(0);
        sc = aL * q;
        const T e = d_exp(g[V_YFLOW] - sc * eta_r);
        const T em = T(1) / e;
        cp = T(0.5) * mT * (e + em);
        sn = T(0.5) * mT * (e - em);
      }
      const T A = cp * dat + sn * dant;
      const T B = cp * ut - sn * tun;
      const T Z = cp * zt - sn * tzn;
      const T XZ = xiL * Z * Z;
      T C1 = T(0), CX = T(0), CY = T(0), E1 = T(0);
      if (SH) {
        C1 = cp * cp * kpitt + tau * tau * sn * sn * kpinn
             - T(2) * tau * cp * sn * kpitn;
        CX = T(-2) * (cp * kpitx - tau * sn * kpixn);
        CY = T(-2) * (cp * kpity - tau * sn * kpiyn);
        E1 = cp * Wt - sn * tWn;
      }
      // the row's sums over phi, in T: the point terms' cotangents (and x
      // px, py where the term has them) and the scalars' sums
      T tP = 0, tPx = 0, tPy = 0, tU = 0, tUx = 0, tUy = 0, tZ = 0;
      T tQ = 0, tQx = 0, tQy = 0, tQxx = 0, tQyy = 0, tQxy = 0;
      T tW = 0, tWx = 0, tWy = 0;
      T tIL = 0, tXi = 0, tC3 = 0, tB0 = 0, tB1 = 0, tB2 = 0, tS = 0;
      for (int f = 0; f < F; ++f) {
        const T x = s.pxs[f], y = s.pys[f];
        const T g0 = s.gs[f * RG + (RG1 ? 0 : r)] * w;
        const T gv = MODE == REMAP ? g0 * sc : g0;
        const T pds = A + dax * x + day * y;
        const T pdu = B - (ux * x + uy * y);
        const T E = d_sqrt(pdu * pdu + XZ);
        const T fa = Fx::rcp(Fx::exp_scaled(E * invLamL) + sgn);
        const T fabar = T(1) - sgn * fa;
        T fv = fa, df = T(0), prod = T(0), dc = T(0), pipp = T(0);
        T Wp = T(0);
        if (SH) {
          pipp = C1 + x * CX + y * CY + kpixx * x * x + kpiyy * y * y
                 + T(2) * kpixy * x * y;
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
        const T hE = E > T(0) ? garg * invLam / E : T(0);
        T gu = hE * pdu, gz = hE * xiL * Z;
        tXi += T(0.5) * hE * Z * Z;
        if (SH) {
          const T gw = gdf * c3 * Z;
          gz += gdf * c3 * Wp;
          tC3 += gdf * Z * Wp;
          tQ += gdf;
          tQx += gdf * x;
          tQy += gdf * y;
          tQxx += gdf * x * x;
          tQyy += gdf * y * y;
          tQxy += gdf * x * y;
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
      // the row into the float64 accumulators: the node kinematics applied
      const double C = cp, Sn = sn;
      a[V_DAT * nt] += C * tP;
      a[V_DANT * nt] += Sn * tP;
      a[V_DAX * nt] += tPx;
      a[V_DAY * nt] += tPy;
      a[V_UT * nt] += C * tU;
      a[V_TUN * nt] -= Sn * tU;
      a[V_UX * nt] -= tUx;
      a[V_UY * nt] -= tUy;
      a[V_ZT * nt] += C * tZ;
      a[V_TZN * nt] -= Sn * tZ;
      a[V_XIL * nt] += tXi;
      a[V_INVLAM * nt] += tIL;
      // d/dDelta: d(mT cosh)/dDelta = mT sinh and back
      double gdel = (Sn * dat + C * dant) * tP + (Sn * ut - C * tun) * tU
                    + (Sn * zt - C * tzn) * tZ;
      if (SH) {
        a[V_KPITT * nt] += C * C * tQ;
        a[V_KPINN * nt] += taud * taud * Sn * Sn * tQ;
        a[V_KPITN * nt] -= 2.0 * taud * C * Sn * tQ;
        a[V_KPITX * nt] -= 2.0 * C * tQx;
        a[V_KPIXN * nt] += 2.0 * taud * Sn * tQx;
        a[V_KPITY * nt] -= 2.0 * C * tQy;
        a[V_KPIYN * nt] += 2.0 * taud * Sn * tQy;
        a[V_KPIXX * nt] += tQxx;
        a[V_KPIYY * nt] += tQyy;
        a[V_KPIXY * nt] += 2.0 * tQxy;
        a[V_TAU * nt] += 2.0 * taud * kpinn * Sn * Sn * tQ
                         - 2.0 * kpitn * C * Sn * tQ
                         + 2.0 * kpixn * Sn * tQx + 2.0 * kpiyn * Sn * tQy;
        a[V_C3 * nt] += tC3;
        a[V_WT * nt] += C * tW;
        a[V_TWN * nt] -= Sn * tW;
        a[V_WX * nt] -= tWx;
        a[V_WY * nt] -= tWy;
        gdel += (2.0 * C * Sn * kpitt + 2.0 * taud * taud * Sn * C * kpinn
                 - 2.0 * taud * (Sn * Sn + C * C) * kpitn) * tQ
                - 2.0 * (Sn * kpitx - taud * C * kpixn) * tQx
                - 2.0 * (Sn * kpity - taud * C * kpiyn) * tQy
                + (Sn * Wt - C * tWn) * tW;
      }
      if (BU) {
        a[V_BC0 * nt] += tB0;
        a[V_BC1 * nt] += tB1;
        a[V_BC2 * nt] += tB2;
      }
      if (MODE == FIXED3) a[V_ETA * nt] -= gdel;       // Delta = y - eta
      if (MODE == REMAP) {
        // Delta = y_flow - s eta_r, and s weights the value
        a[V_YFLOW * nt] += gdel;
        const double gs_ = -(double)eta_r * gdel + (double)tS;
        a[V_AL * nt] += (double)q * gs_;
        a[V_LAM * nt] += (double)aL * (double)dq * gs_;
      }
    }
  }
  __syncthreads();
  // each cell's gradient: its nodes added in node order
  for (int i = tid; i < nc * NV; i += nt) {
    const int c = i / NV, k = i - c * NV;
    double v = 0.0;
    for (int rr = 0; rr < R; ++rr) v += s.acc[(size_t)k * nt + c * R + rr];
    grad[(size_t)(c0 + c) * NV + k] = (T)v;
  }
}

template <typename T, int DIM, int SW>
__global__ void __launch_bounds__(BLOCK)
vah_bwd_kernel(const T* __restrict__ cells, int n_cells, int CT,
               const T* __restrict__ mass, const T* __restrict__ sign,
               const T* __restrict__ deg, int S, const T* __restrict__ pT,
               int P, const T* __restrict__ px, const T* __restrict__ py,
               int F, const T* __restrict__ nodes,
               const T* __restrict__ weights, int R, int regulate,
               int outflow, T prefactor, const T* __restrict__ G,
               T* __restrict__ grad) {
  vah_bwd_body<T, DIM == 3 ? FIXED3 : FIXED2, SW>(
      cells, n_cells, CT, mass, sign, deg, S, pT, P, px, py, nullptr,
      nullptr, F, nodes, weights, R, regulate, outflow, prefactor, G, grad);
}

template <typename T, int SW>
__global__ void __launch_bounds__(BLOCK)
vah_remap_bwd_kernel(const T* __restrict__ cells, int n_cells, int CT,
                     const T* __restrict__ mass, const T* __restrict__ sign,
                     const T* __restrict__ deg, int S,
                     const T* __restrict__ pT, int P,
                     const T* __restrict__ cos_phi,
                     const T* __restrict__ sin_phi, int F,
                     const T* __restrict__ nodes,
                     const T* __restrict__ weights, int R, int regulate,
                     int outflow, T prefactor, const T* __restrict__ G,
                     T* __restrict__ grad) {
  vah_bwd_body<T, REMAP, SW>(cells, n_cells, CT, mass, sign, deg, S, pT, P,
                             nullptr, nullptr, cos_phi, sin_phi, F, nodes,
                             weights, R, regulate, outflow, prefactor, G,
                             grad);
}

// cells a block, its threads and its shared memory for a shape, or an
// error code
template <typename T>
int blocking(int mode, int F, int R, int* CT, int* threads, size_t* smem) {
  if (R < 1 || R > BLOCK || F < 1) return cudaErrorInvalidValue;
  *CT = BLOCK / R;
  *threads = (*CT * R + 31) / 32 * 32;
  const Smem<T> s(nullptr, *threads, *CT, F, mode == FIXED3 ? R : 1);
  *smem = s.bytes(nullptr);
  return *smem > MAX_SMEM ? (int)cudaErrorInvalidValue : 0;
}

template <typename K, typename... Args>
int launch_(K kern, int n_cells, int CT, int threads, size_t smem,
            cudaStream_t stream, Args... args) {
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  const unsigned blocks = (unsigned)((n_cells + CT - 1) / CT);
  kern<<<blocks, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// IS3D_SW(MACRO, args) expands MACRO(args, SW) with the instantiation of
// the chains `sw`
#define IS3D_SW(MACRO, ...)                                                   \
  switch (sw) {                                                              \
    case 0: return MACRO(__VA_ARGS__, 0);                                    \
    case 1: return MACRO(__VA_ARGS__, 1);                                    \
    case 2: return MACRO(__VA_ARGS__, 2);                                    \
    default: return MACRO(__VA_ARGS__, 3);                                   \
  }

template <typename T>
int launch_fixed(const void* cells, int n_cells, int nv, const void* mass,
                 const void* sign, const void* deg, int S, const void* pT,
                 const void* px, const void* py, int P, int F,
                 const void* nodes, const void* weights, int R, int dim,
                 int sw, int regulate, int outflow, double prefactor,
                 const void* G, void* grad, void* stream_v) {
  if (nv != NV || (dim != 2 && dim != 3) || sw < 0 || sw > 3 ||
      n_cells < 0 || S < 1 || P < 1)
    return cudaErrorInvalidValue;
  if (n_cells == 0) return cudaSuccess;
  int CT, threads;
  size_t smem;
  const int rc = blocking<T>(dim == 3 ? FIXED3 : FIXED2, F, R, &CT, &threads,
                             &smem);
  if (rc != 0) return rc;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
#define IS3D_VBWD(DIM_, SW_)                                                  \
  launch_(vah_bwd_kernel<T, DIM_, SW_>, n_cells, CT, threads, smem, stream,  \
          (const T*)cells, n_cells, CT, (const T*)mass, (const T*)sign,      \
          (const T*)deg, S, (const T*)pT, P, (const T*)px, (const T*)py, F,  \
          (const T*)nodes, (const T*)weights, R, regulate, outflow,          \
          (T)prefactor, (const T*)G, (T*)grad)
  if (dim == 3) { IS3D_SW(IS3D_VBWD, 3) }
  IS3D_SW(IS3D_VBWD, 2)
#undef IS3D_VBWD
}

template <typename T>
int launch_remap(const void* cells, int n_cells, int nv, const void* mass,
                 const void* sign, const void* deg, int S, const void* pT,
                 int P, const void* cos_phi, const void* sin_phi, int F,
                 const void* nodes, const void* weights, int R, int sw,
                 int regulate, int outflow, double prefactor, const void* G,
                 void* grad, void* stream_v) {
  if (nv != NV || sw < 0 || sw > 3 || n_cells < 0 || S < 1 || P < 1)
    return cudaErrorInvalidValue;
  if (n_cells == 0) return cudaSuccess;
  int CT, threads;
  size_t smem;
  const int rc = blocking<T>(REMAP, F, R, &CT, &threads, &smem);
  if (rc != 0) return rc;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
#define IS3D_VBWD(X_, SW_)                                                    \
  launch_(vah_remap_bwd_kernel<T, SW_>, n_cells, CT, threads, smem, stream,  \
          (const T*)cells, n_cells, CT, (const T*)mass, (const T*)sign,      \
          (const T*)deg, S, (const T*)pT, P, (const T*)cos_phi,              \
          (const T*)sin_phi, F, (const T*)nodes, (const T*)weights, R,       \
          regulate, outflow, (T)prefactor, (const T*)G, (T*)grad)
  IS3D_SW(IS3D_VBWD, 0)
#undef IS3D_VBWD
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
    return launch_fixed<T>(cells, n_cells, nv, mass, sign, deg, S, pT, px,   \
                           py, P, F, nodes, weights, R, dim, sw, regulate,   \
                           outflow, prefactor, G, grad, stream);             \
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
    return launch_remap<T>(cells, n_cells, nv, mass, sign, deg, S, pT, P,    \
                           cos_phi, sin_phi, F, nodes, weights, R, sw,       \
                           regulate, outflow, prefactor, G, grad, stream);   \
  }
IS3D_VBWD_REMAP_ENTRY(is3d_vah_bwd_remap_f32, float)
IS3D_VBWD_REMAP_ENTRY(is3d_vah_bwd_remap_f64, double)
#undef IS3D_VBWD_REMAP_ENTRY

const char* is3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
