// Anisotropic-hydro (VAH) smooth Cooper-Frye spectra for Hopper (sm_90a),
// float32 and float64.
//
// Replaces the XLA hot loop of is3d_tpu/kernels/vah.py:_chunk_vah_spectra
// (:51), driven by _vah_jit (:213).  Two kernels:
//   * fixed_kernel: fixed nodes, 3+1D (the output rapidities) and 2+1D
//     (the eta nodes);
//   * remap_kernel: the 2+1D mT remap, the default grid of every 2+1D VAH
//     run (is3d_tpu forces it on table grids too).
// The dN/dX kernel's VAH producer (csrc/dndx.cu) is the third entry point;
// the emission value is csrc/vah.cuh's, shared by all three.
//
// Inputs (built by is3d_tpu_torch/kernels/vah.py:pack_vah_cells):
//   cells (n_cells, NV) per-cell scalars, field order `VahField`
//         (== VF_FIELDS);
//   mass, sign, deg (n_species); pT (n_pT); px, py (n_pT n_phi) or
//   cos_phi, sin_phi (n_phi); nodes, weights (n_nodes).
// Output: (n_species, n_pT, n_phi, n_out) x prefactor x degeneracy, n_out
// = n_nodes in 3+1D, 1 in 2+1D.
//
// What bounds it on this card: SFU issue.  Each evaluation takes a sqrt,
// an exp and a reciprocal beside 9 FP32 operations (kernels/vah.py,
// vah_formula_ops), and the remap adds an exp and a reciprocal per (cell,
// node, species, pT), shared by the angles.  A 16384-cell group is 2.3 MB
// of cells against 8.5e10 (3+1D) or 1.9e11 (2+1D) evaluations.
//
// Design: K3's first version (feqmod.cu) with the emission value of
// vah.cuh.
//   * The residual chains are template switches (SW: shear 1, bulk 2): a
//     launch with every chain gated off (the production case, no c0..c4
//     columns) evaluates f_a alone.
//   * fixed_kernel: a thread owns one momentum point for J species and YC
//     nodes (3+1D the block's YC rapidities, 2+1D the eta nodes in steps of
//     YC); tiles of TILE cells and their node composites (vah_node) are
//     staged in shared memory.
//   * remap_kernel: the nodes move with (cell, species, pT): Delta =
//     y_flow - s eta_r, s = a_L sqrt(Lambda / max(mT, Lambda)), so e^Delta
//     = e^y_flow 2^(-L s eta_r) is one exp per (cell, species, pT, node),
//     and e^-Delta one reciprocal; a thread owns one (species, pT) for
//     NPHI angles and RNODES nodes, so both are shared by the NPHI angles,
//     whose per-(cell, angle) terms (at unit pT) are staged once per tile.
//     The jacobian s multiplies the node weight, inside the cell sum.
//   * float32 takes ex2.approx on a pre-scaled argument, rcp.approx and
//     sqrt.approx, which keep +inf -> 0; float64 keeps IEEE exp, division
//     and sqrt.
//   * The cells are split into ranges (the wrapper picks the count from
//     the card's resident-block count, kernels/launch.py:split_to_fill);
//     each range writes its own partial, and fold_kernel adds them in
//     order.  No atomics: two launches give identical bits.
// A first version: simple and right; its time against its bound is in
// PERF.md.

#include <cuda_runtime.h>

#include "vah.cuh"

namespace {

using namespace is3d;

constexpr int BLOCK = 128;         // momentum points per block
constexpr int J = 4;               // species per thread
constexpr int YC = 3;              // nodes per register block
constexpr int TILE = 16;           // cells per shared-memory tile
constexpr int RS2 = 12;            // 2+1D nodes per staged chunk (x YC)
constexpr int MAX_SPLIT = 8;

// ------------------------------------------------ fixed rapidity nodes

// grid (point blocks, species groups of J, n_split x node groups of YC
// (3+1D) or n_split (2+1D)); partial (n_split, S, M, n_out), unscaled
template <typename T, int DIM, int SW>
__global__ void __launch_bounds__(BLOCK, sizeof(T) == 4 ? 3 : 2)
fixed_kernel(const T* __restrict__ cells, int n_cells, int cells_per_split,
             const T* __restrict__ mass, const T* __restrict__ sign,
             int n_species, const T* __restrict__ pT,
             const T* __restrict__ px, const T* __restrict__ py, int M,
             int n_phi, const T* __restrict__ nodes,
             const T* __restrict__ weights, int n_nodes, int regulate,
             int outflow, T* __restrict__ partial) {
  constexpr int RSC = DIM == 3 ? YC : RS2;
  __shared__ __align__(16) T raw[TILE * NV];
  __shared__ __align__(16) T comp[TILE * RSC * NKV];

  const int tid = threadIdx.x;
  const int nz = DIM == 3 ? (n_nodes + YC - 1) / YC : 1;
  const int split = blockIdx.z / nz;
  const int rbeg = DIM == 3 ? (blockIdx.z - split * nz) * YC : 0;
  const int rend = DIM == 3 ? min(rbeg + YC, n_nodes) : n_nodes;
  const int cbeg = split * cells_per_split;
  const int cend = min(n_cells, cbeg + cells_per_split);
  const int m = blockIdx.x * BLOCK + tid;
  const int s0 = blockIdx.y * J;
  const int n_out = DIM == 3 ? n_nodes : 1;

  // the thread's momentum point for its J species (ragged edges clamped
  // to a real point and species, never stored)
  const int mc = min(m, M - 1);
  const T pxv = px[mc], pyv = py[mc];
  const T pt = pT[mc / n_phi];
  const T px2 = pxv * pxv, py2 = pyv * pyv, pxpy = pxv * pyv;
  T mT[J], mT2[J], m2[J], sgn[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int s = min(s0 + j, n_species - 1);
    m2[j] = mass[s] * mass[s];
    mT[j] = d_sqrt(m2[j] + pt * pt);
    mT2[j] = mT[j] * mT[j];
    sgn[j] = sign[s];
  }

  T acc[J][YC];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int y = 0; y < YC; ++y) acc[j][y] = T(0);

  for (int c0 = cbeg; c0 < cend; c0 += TILE) {
    const int nc = min(TILE, cend - c0);
    __syncthreads();                                 // previous tile consumed
    for (int i = tid; i < nc * NV; i += BLOCK)
      raw[i] = cells[(size_t)c0 * NV + i];
    __syncthreads();
    for (int r0 = rbeg; r0 < rend; r0 += RSC) {
      // nodes of this chunk, rounded up to whole register blocks; the
      // padding repeats the last node with weight 0 (2+1D) or is not
      // stored (3+1D)
      const int nr = min(RSC, rend - r0);
      const int nrp = DIM == 3 ? YC : (nr + YC - 1) / YC * YC;
      if (r0 != rbeg) __syncthreads();               // previous chunk consumed
      for (int i = tid; i < nc * nrp; i += BLOCK) {
        const int c = i / nrp;
        const int rr = i - c * nrp;
        const int r = min(r0 + rr, n_nodes - 1);
        const T* g = raw + c * NV;
        const T w = DIM == 3 ? T(1) : (r0 + rr < rend ? weights[r] : T(0));
        vah_node<T>(g, DIM == 3 ? nodes[r] - g[V_ETA] : -nodes[r], w,
                    comp + (c * RSC + rr) * NKV);
      }
      __syncthreads();
      for (int c = 0; c < nc; ++c) {
        const T* g = raw + c * NV;
        const VahCoef<T> k = vah_coef<T>(g);
        // per (cell, point)
        const T W1 = fma(g[V_DAX], pxv, g[V_DAY] * pyv);
        const T nW2 = -fma(g[V_UX], pxv, g[V_UY] * pyv);
        T C4 = T(0), nWW = T(0);
        if (SW & VSW_SHEAR) {
          C4 = fma(g[V_KPIXX], px2,
                   fma(g[V_KPIYY], py2, T(2) * g[V_KPIXY] * pxpy));
          nWW = -fma(g[V_WX], pxv, g[V_WY] * pyv);
        }
        const T* kc = comp + c * RSC * NKV;
        for (int rr = 0; rr < nrp; rr += YC) {
#pragma unroll
          for (int y = 0; y < YC; ++y) {
            const T* q = kc + (rr + y) * NKV;
            const T c23 = (SW & VSW_SHEAR) ? fma(pxv, q[5], pyv * q[6])
                                           : T(0);
#pragma unroll
            for (int j = 0; j < J; ++j) {
              const T v = vah_point<T, SW>(q, mT[j], mT2[j], m2[j], sgn[j],
                                           W1, nW2, C4, nWW, c23, k,
                                           regulate, outflow);
              acc[j][y] = fma(q[8], v, acc[j][y]);
            }
          }
        }
      }
    }
  }
  if (m >= M) return;
  T* o = partial + (size_t)split * n_species * M * (size_t)n_out;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int s = s0 + j;
    if (s >= n_species) continue;
    if (DIM == 3) {
#pragma unroll
      for (int y = 0; y < YC; ++y)
        if (rbeg + y < rend)
          o[((size_t)s * M + m) * n_nodes + rbeg + y] = acc[j][y];
    } else {
      T v = T(0);
#pragma unroll
      for (int y = 0; y < YC; ++y) v += acc[j][y];
      o[(size_t)s * M + m] = v;
    }
  }
}

// ------------------------------------------------------- 2+1D mT remap

constexpr int RBLOCK = 128;        // (species, pT) threads per block
constexpr int RYC = 3;             // nodes per register block
constexpr int RNODES = 12;         // nodes per block (a multiple of RYC)
constexpr int RTILE = 8;           // cells per shared-memory tile
constexpr int NPR = 6;             // staged values per (cell, phi)
constexpr int MAX_RSPLIT = 64;

// the NPR values of one (cell, phi) at unit pT (cf, sf = cos, sin phi):
// w1 (p.dsigma), -w2 (u.p); with shear c4 (pi:pp's C4), g and h with
// px C2 + py C3 = ch g + sh h (pT and mT factored out), and -ww (W.p)
template <typename T, int SW>
__device__ __forceinline__ void stage_row(const T* g, T cf, T sf, T* o) {
  o[0] = g[V_DAX] * cf + g[V_DAY] * sf;
  o[1] = -(g[V_UX] * cf + g[V_UY] * sf);
  if (SW & VSW_SHEAR) {
    o[2] = g[V_KPIXX] * cf * cf + g[V_KPIYY] * sf * sf
           + T(2) * g[V_KPIXY] * cf * sf;
    o[3] = T(-2) * (g[V_KPITX] * cf + g[V_KPITY] * sf);
    o[4] = T(2) * g[V_TAU] * (g[V_KPIXN] * cf + g[V_KPIYN] * sf);
    o[5] = -(g[V_WX] * cf + g[V_WY] * sf);
  }
}

// grid (blocks of RBLOCK (species, pT) pairs, phi chunks of NPHI, n_split x
// node chunks of RNODES); thread i owns species i / n_pT at pT i % n_pT
// for the block's NPHI angles and RNODES nodes.  partial (n_split x node
// chunks, S, P, F), unscaled.
template <typename T, int NPHI, int SW>
__global__ void __launch_bounds__(RBLOCK, sizeof(T) == 4 ? 3 : 2)
remap_kernel(const T* __restrict__ cells, int n_cells, int cells_per_split,
             const T* __restrict__ mass, const T* __restrict__ sign,
             int n_species, const T* __restrict__ pT, int n_pT,
             const T* __restrict__ cos_phi, const T* __restrict__ sin_phi,
             int n_phi, const T* __restrict__ nodes,
             const T* __restrict__ weights, int n_nodes, int regulate,
             int outflow, T* __restrict__ partial) {
  using F = Fn<T>;
  __shared__ __align__(16) T rows[RTILE * NPHI * NPR];  // [cell][phi][NPR]
  __shared__ T raw[RTILE * NV];
  __shared__ T wts[RNODES];
  __shared__ T eta[RNODES];

  const int tid = threadIdx.x;
  const int n_sp = n_species * n_pT;
  const int i = blockIdx.x * RBLOCK + tid;
  const int ic = min(i, n_sp - 1);         // ragged edge: clamped, not stored
  const int s = ic / n_pT;
  const int n_chunks = (n_nodes + RNODES - 1) / RNODES;
  const int split = blockIdx.z / n_chunks;
  const int r0 = (blockIdx.z - split * n_chunks) * RNODES;
  const int nr = min(RNODES, n_nodes - r0);
  const int nrp = (nr + RYC - 1) / RYC * RYC;
  const int f0 = blockIdx.y * NPHI;
  const int cbeg = split * cells_per_split;
  const int cend = min(n_cells, cbeg + cells_per_split);
  const T L = F::SCALE;

  const T pt = pT[ic - s * n_pT];
  const T pt2 = pt * pt;
  const T m2 = mass[s] * mass[s];
  const T mTv = d_sqrt(m2 + pt2);
  const T hmT = T(0.5) * mTv;
  const T sgn = sign[s];

  // the padding up to whole register blocks repeats the last node with
  // weight 0
  if (tid < RNODES) {
    wts[tid] = tid < nr ? weights[r0 + tid] : T(0);
    eta[tid] = nodes[min(r0 + tid, n_nodes - 1)];
  }

  T acc[NPHI];
#pragma unroll
  for (int f = 0; f < NPHI; ++f) acc[f] = T(0);

  for (int c0 = cbeg; c0 < cend; c0 += RTILE) {
    const int nc = min(RTILE, cend - c0);
    __syncthreads();                                 // previous tile consumed
    for (int k = tid; k < nc * NV; k += RBLOCK)
      raw[k] = cells[(size_t)c0 * NV + k];
    __syncthreads();
    for (int k = tid; k < nc * NPHI; k += RBLOCK) {
      const int c = k / NPHI;
      const int fc = min(f0 + k - c * NPHI, n_phi - 1);
      stage_row<T, SW>(raw + c * NV, cos_phi[fc], sin_phi[fc], rows + k * NPR);
    }
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
      const T* g = raw + c * NV;
      const T* rw = rows + c * NPHI * NPR;
      const VahCoef<T> k = vah_coef<T>(g);
      // per (cell, species, pT): the node scale s and its jacobian
      const T lam = g[V_LAM];
      const T sc = g[V_AL] * d_sqrt(lam / (mTv > lam ? mTv : lam));
      const T nsL = -L * sc;
      const T eyf = d_exp(g[V_YFLOW]);
      const T xiL = g[V_XIL];
      // (mT / 2)(a +- b) of each composite a ch + b sh, ch and sh of the
      // node as (e^Delta +- e^-Delta) / 2
      const T hAp = hmT * (g[V_DAT] + g[V_DANT]);
      const T hAm = hmT * (g[V_DAT] - g[V_DANT]);
      const T hBp = hmT * (g[V_UT] - g[V_TUN]);
      const T hBm = hmT * (g[V_UT] + g[V_TUN]);
      const T hZp = hmT * (g[V_ZT] - g[V_TZN]);
      const T hZm = hmT * (g[V_ZT] + g[V_TZN]);
      const T hEp = hmT * (g[V_WT] - g[V_TWN]);
      const T hEm = hmT * (g[V_WT] + g[V_TWN]);
      const T tau = g[V_TAU];
      for (int rr = 0; rr < nrp; rr += RYC) {
        // per (cell, species, pT, node): e^Delta from one exp, e^-Delta
        // from one reciprocal, then the node terms
        T A[RYC], B[RYC], Z[RYC], XZ[RYC], ws[RYC];
        T C1[RYC], E1[RYC], cg[RYC], sg[RYC];
#pragma unroll
        for (int y = 0; y < RYC; ++y) {
          const T eq = eyf * F::exp_scaled(nsL * eta[rr + y]);
          const T rq = F::rcp(eq);
          A[y] = fma(hAp, eq, hAm * rq);
          B[y] = fma(hBp, eq, hBm * rq);
          Z[y] = fma(hZp, eq, hZm * rq);
          XZ[y] = xiL * Z[y] * Z[y];
          ws[y] = wts[rr + y] * sc;
          if (SW & VSW_SHEAR) {
            const T mch = hmT * (eq + rq);          // mT ch
            const T mtsh = tau * (hmT * (eq - rq));  // mT tau sh
            C1[y] = fma(mch * mch, g[V_KPITT],
                        fma(mtsh * mtsh, g[V_KPINN],
                            T(-2) * mch * mtsh * g[V_KPITN]));
            E1[y] = fma(hEp, eq, hEm * rq);
            cg[y] = mch * pt;
            sg[y] = hmT * (eq - rq) * pt;
          }
        }
#pragma unroll
        for (int f = 0; f < NPHI; ++f) {
          const T* q = rw + f * NPR;
#pragma unroll
          for (int y = 0; y < RYC; ++y) {
            const T pdu = fma(pt, q[1], B[y]);
            T pipp = T(0), Wp = T(0);
            if (SW & VSW_SHEAR) {
              pipp = fma(cg[y], q[3], fma(sg[y], q[4], fma(pt2, q[2], C1[y])));
              Wp = fma(pt, q[5], E1[y]);
            }
            const T fv = vah_f<T, SW>(pdu, XZ[y], Z[y], pipp, Wp, m2, sgn, k,
                                      regulate);
            const T v = vah_emit(fma(pt, q[0], A[y]), fv, outflow);
            acc[f] = fma(ws[y], v, acc[f]);
          }
        }
      }
    }
  }
  if (i >= n_sp) return;
  T* o = partial + ((size_t)blockIdx.z * n_sp + i) * n_phi + f0;
#pragma unroll
  for (int f = 0; f < NPHI; ++f)
    if (f0 + f < n_phi) o[f] = acc[f];
}

// out[i] = prefactor deg[s] sum over the parts (in order) of partial; i runs
// over (S, n_pT, n_phi, n_out)
template <typename T>
__global__ void __launch_bounds__(256)
fold_kernel(const T* __restrict__ partial, int n_parts, long long n,
            int n_pT, int n_phi, int n_out, const T* __restrict__ deg,
            T prefactor, T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  T v = T(0);
  for (int k = 0; k < n_parts; ++k) v += partial[k * n + i];
  const int s = (int)(i / ((long long)n_pT * n_phi * n_out));
  out[i] = prefactor * deg[s] * v;
}

// ------------------------------------------------------------ launchers

// angles per thread of the remap kernel: of 8 and 24 the width that pads
// n_phi the least, the larger of equals
int remap_phi_width(int n_phi) {
  return (n_phi + 23) / 24 * 24 <= (n_phi + 7) / 8 * 8 ? 24 : 8;
}

bool shape_ok(int n_species, int n_pT, int n_phi, int n_nodes,
              int dimension, int sw) {
  return n_species >= 1 && n_pT >= 1 && n_phi >= 1 && n_nodes >= 1 &&
         (dimension == 2 || dimension == 3) && sw >= 0 && sw <= 3 &&
         (long long)n_species * n_pT * n_phi * n_nodes < 0x7fffffffLL &&
         (n_species + J - 1) / J <= 65535;
}

template <typename K>
int resident(K kernel, int threads, int* slots) {
  int dev = 0, n_sm = 0, per_sm = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc == 0)
    rc = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                     dev);
  if (rc == 0)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                            threads, 0);
  if (rc != 0) return rc;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *slots = n_sm * per_sm;
  return cudaSuccess;
}

// IS3D_SW(MACRO, args) expands MACRO(args, SW) with the instantiation of
// the switches `sw`
#define IS3D_SW(MACRO, ...)                                                   \
  switch (sw) {                                                              \
    case 0: MACRO(__VA_ARGS__, 0); break;                                    \
    case 1: MACRO(__VA_ARGS__, 1); break;                                    \
    case 2: MACRO(__VA_ARGS__, 2); break;                                    \
    default: MACRO(__VA_ARGS__, 3); break;                                   \
  }

// a kernel's grid for a shape on the current card, the one owner of the
// blocking: out = {blocks for each range of cells, resident blocks (SMs x
// blocks per SM), partial sums for each range of cells, cells per tile,
// most ranges of cells, angles per thread (remap; 0 at fixed nodes)}
template <typename T>
int vah_grid(int n_species, int n_pT, int n_phi, int n_nodes, int dimension,
             int remap, int sw, int* out) {
  if (!shape_ok(n_species, n_pT, n_phi, n_nodes, dimension, sw) ||
      (remap && dimension != 2) || out == nullptr)
    return cudaErrorInvalidValue;
  int slots = 0, rc = 0;
  if (remap) {
    const int width = remap_phi_width(n_phi);
#define IS3D_RES_REMAP(W_, SW_) \
  rc = resident(remap_kernel<T, W_, SW_>, RBLOCK, &slots)
    if (width == 8) { IS3D_SW(IS3D_RES_REMAP, 8) }
    else { IS3D_SW(IS3D_RES_REMAP, 24) }
#undef IS3D_RES_REMAP
    if (rc != 0) return rc;
    const long long n_sp = (long long)n_species * n_pT;
    const long long chunks = (n_nodes + RNODES - 1) / RNODES;
    const long long blocks = (n_sp + RBLOCK - 1) / RBLOCK
                             * ((n_phi + width - 1) / width) * chunks;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    out[0] = (int)blocks;
    out[1] = slots;
    out[2] = (int)chunks;
    out[3] = RTILE;
    out[4] = MAX_RSPLIT;
    out[5] = width;
    return cudaSuccess;
  }
#define IS3D_RES_FIXED(DIM_, SW_) \
  rc = resident(fixed_kernel<T, DIM_, SW_>, BLOCK, &slots)
  if (dimension == 3) { IS3D_SW(IS3D_RES_FIXED, 3) }
  else { IS3D_SW(IS3D_RES_FIXED, 2) }
#undef IS3D_RES_FIXED
  if (rc != 0) return rc;
  const long long M = (long long)n_pT * n_phi;
  const long long nz = dimension == 3 ? (n_nodes + YC - 1) / YC : 1;
  const long long blocks = (M + BLOCK - 1) / BLOCK
                           * ((n_species + J - 1) / J) * nz;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  out[0] = (int)blocks;
  out[1] = slots;
  out[2] = 1;
  out[3] = TILE;
  out[4] = MAX_SPLIT;
  out[5] = 0;
  return cudaSuccess;
}

template <typename T>
int fold(const void* partial, int n_parts, int n_species, int n_pT,
         int n_phi, int n_out, const void* deg, double prefactor, void* out,
         cudaStream_t stream) {
  const long long n = (long long)n_species * n_pT * n_phi * n_out;
  fold_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(partial), n_parts, n, n_pT, n_phi, n_out,
      static_cast<const T*>(deg), (T)prefactor, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

// the ranges of cells of a launch, or 0 where the split does not fit
long long n_ranges(int n_cells, int cells_per_split, int tile) {
  if (n_cells < 1 || cells_per_split < 1) return 0;
  const long long n = ((long long)n_cells + cells_per_split - 1)
                      / cells_per_split;
  // a split of whole tiles, so no tile straddles two blocks
  if (n > 1 && cells_per_split % tile != 0) return 0;
  return n;
}

template <typename T>
int launch_fixed(const void* cells, int n_cells, int nv, const void* mass,
                 const void* sign, const void* deg, int n_species,
                 const void* pT, const void* px, const void* py, int n_pT,
                 int n_phi, const void* nodes, const void* weights,
                 int n_nodes, int dimension, int sw, int regulate,
                 int outflow, double prefactor, int cells_per_split,
                 int n_partial, void* partial, void* out, void* stream_v) {
  const long long n_split = n_ranges(n_cells, cells_per_split, TILE);
  if (nv != NV || !shape_ok(n_species, n_pT, n_phi, n_nodes, dimension, sw) ||
      n_split < 1 || n_split > MAX_SPLIT || n_split != n_partial ||
      partial == nullptr)
    return cudaErrorInvalidValue;
  const long long M = (long long)n_pT * n_phi;
  const unsigned nz =
      dimension == 3 ? (unsigned)((n_nodes + YC - 1) / YC) : 1u;
  if ((long long)nz * n_split > 65535) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  const dim3 grid((unsigned)((M + BLOCK - 1) / BLOCK),
                  (unsigned)((n_species + J - 1) / J),
                  nz * (unsigned)n_split);
#define IS3D_FIXED(DIM_, SW_)                                                 \
  fixed_kernel<T, DIM_, SW_><<<grid, BLOCK, 0, stream>>>(                     \
      static_cast<const T*>(cells), n_cells, cells_per_split,                \
      static_cast<const T*>(mass), static_cast<const T*>(sign), n_species,   \
      static_cast<const T*>(pT), static_cast<const T*>(px),                  \
      static_cast<const T*>(py), (int)M, n_phi,                              \
      static_cast<const T*>(nodes), static_cast<const T*>(weights), n_nodes, \
      regulate, outflow, static_cast<T*>(partial))
  if (dimension == 3) { IS3D_SW(IS3D_FIXED, 3) }
  else { IS3D_SW(IS3D_FIXED, 2) }
#undef IS3D_FIXED
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return fold<T>(partial, (int)n_split, n_species, n_pT, n_phi,
                 dimension == 3 ? n_nodes : 1, deg, prefactor, out, stream);
}

template <typename T>
int launch_remap(const void* cells, int n_cells, int nv, const void* mass,
                 const void* sign, const void* deg, int n_species,
                 const void* pT, int n_pT, const void* cos_phi,
                 const void* sin_phi, int n_phi, const void* nodes,
                 const void* weights, int n_nodes, int sw, int regulate,
                 int outflow, double prefactor, int cells_per_split,
                 int n_partial, void* partial, void* out, void* stream_v) {
  const long long n_split = n_ranges(n_cells, cells_per_split, RTILE);
  const int width = remap_phi_width(n_phi);
  const long long n_parts = n_split * ((n_nodes + RNODES - 1) / RNODES);
  const long long n_sp = (long long)n_species * n_pT;
  if (nv != NV || !shape_ok(n_species, n_pT, n_phi, n_nodes, 2, sw) ||
      n_split < 1 || n_split > MAX_RSPLIT || n_parts != n_partial ||
      n_parts > 65535 || (n_phi + width - 1) / width > 65535 ||
      partial == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  const dim3 grid((unsigned)((n_sp + RBLOCK - 1) / RBLOCK),
                  (unsigned)((n_phi + width - 1) / width),
                  (unsigned)n_parts);
#define IS3D_REMAP(NPHI_, SW_)                                                \
  remap_kernel<T, NPHI_, SW_><<<grid, RBLOCK, 0, stream>>>(                   \
      static_cast<const T*>(cells), n_cells, cells_per_split,                \
      static_cast<const T*>(mass), static_cast<const T*>(sign), n_species,   \
      static_cast<const T*>(pT), n_pT, static_cast<const T*>(cos_phi),       \
      static_cast<const T*>(sin_phi), n_phi, static_cast<const T*>(nodes),   \
      static_cast<const T*>(weights), n_nodes, regulate, outflow,            \
      static_cast<T*>(partial))
  if (width == 8) { IS3D_SW(IS3D_REMAP, 8) }
  else { IS3D_SW(IS3D_REMAP, 24) }
#undef IS3D_REMAP
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return fold<T>(partial, (int)n_parts, n_species, n_pT, n_phi, 1, deg,
                 prefactor, out, stream);
}

}  // namespace

extern "C" {

// a VAH kernel's grid on the current card (see vah_grid); returns a CUDA
// error code
int is3d_vah_grid_f32(int n_species, int n_pT, int n_phi, int n_nodes,
                      int dimension, int remap, int sw, int* out) {
  return vah_grid<float>(n_species, n_pT, n_phi, n_nodes, dimension, remap,
                         sw, out);
}
int is3d_vah_grid_f64(int n_species, int n_pT, int n_phi, int n_nodes,
                      int dimension, int remap, int sw, int* out) {
  return vah_grid<double>(n_species, n_pT, n_phi, n_nodes, dimension, remap,
                          sw, out);
}

// fixed nodes: partial (n_partial = ranges of cells, S, P, F, n_out)
#define IS3D_VAH_ENTRY(NAME, T)                                               \
  int NAME(const void* cells, int n_cells, int nv, const void* mass,         \
           const void* sign, const void* deg, int n_species, const void* pT, \
           const void* px, const void* py, int n_pT, int n_phi,              \
           const void* nodes, const void* weights, int n_nodes,              \
           int dimension, int sw, int regulate, int outflow,                 \
           double prefactor, int cells_per_split, int n_partial,             \
           void* partial, void* out, void* stream) {                         \
    return launch_fixed<T>(cells, n_cells, nv, mass, sign, deg, n_species,   \
                           pT, px, py, n_pT, n_phi, nodes, weights, n_nodes, \
                           dimension, sw, regulate, outflow, prefactor,      \
                           cells_per_split, n_partial, partial, out,         \
                           stream);                                          \
  }
IS3D_VAH_ENTRY(is3d_vah_f32, float)
IS3D_VAH_ENTRY(is3d_vah_f64, double)
#undef IS3D_VAH_ENTRY

// the 2+1D mT remap: partial (n_partial = ranges of cells x chunks of
// nodes, S, P, F)
#define IS3D_VAH_REMAP_ENTRY(NAME, T)                                         \
  int NAME(const void* cells, int n_cells, int nv, const void* mass,         \
           const void* sign, const void* deg, int n_species, const void* pT, \
           int n_pT, const void* cos_phi, const void* sin_phi, int n_phi,    \
           const void* nodes, const void* weights, int n_nodes, int sw,      \
           int regulate, int outflow, double prefactor,                      \
           int cells_per_split, int n_partial, void* partial, void* out,     \
           void* stream) {                                                   \
    return launch_remap<T>(cells, n_cells, nv, mass, sign, deg, n_species,   \
                           pT, n_pT, cos_phi, sin_phi, n_phi, nodes,         \
                           weights, n_nodes, sw, regulate, outflow,          \
                           prefactor, cells_per_split, n_partial, partial,   \
                           out, stream);                                     \
  }
IS3D_VAH_REMAP_ENTRY(is3d_vah_remap_f32, float)
IS3D_VAH_REMAP_ENTRY(is3d_vah_remap_f64, double)
#undef IS3D_VAH_REMAP_ENTRY

const char* is3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
