// Smooth Cooper-Frye spectra with modified equilibrium distributions (df 3
// "Mike", df 4 "Jonah") for Hopper (sm_90a), float32 and float64.
//
// Replaces the XLA hot loop of is3d_tpu/kernels/feqmod.py:
// _chunk_contribution_feqmod (:276), routed per chunk by routed_switch
// (:606) and driven by _feqmod_spectra_jit (:665).  Two kernels:
//   * fixed_kernel: fixed nodes, 3+1D (the output rapidities) and 2+1D
//     (eta nodes, f_mod's scaled per cell by eta_scale);
//   * remap_kernel: the 2+1D mT remap, the default grid of every 2+1D run.
// The dN/dX kernel's feqmod producer (csrc/dndx.cu) is the third entry
// point; the emission value is csrc/feqmod.cuh's, shared by all three.
//
// Inputs (built by is3d_tpu_torch/kernels/feqmod.py from a group's packed
// cells, pack_feqmod_cells): fixed_stage's tables (fixed nodes) or
// remap_stage's and the fallback's node table (S, P, R, 2) =
// exp(-+s eta_r) (kernels/smooth.py:remap_node_table) (the remap), the
// cells sorted by chain; mass, sign, baryon, deg (n_species); pT (n_pT);
// px, py (n_pT n_phi) or cos_phi, sin_phi (n_phi); nodes, weights
// (n_nodes).
// Output: (n_species, n_pT, n_phi, n_out) x prefactor x degeneracy (x the
// remap's jacobian s(mT)), n_out = n_nodes in 3+1D, 1 in 2+1D.
//
// What bounds it on this card: SFU and FP32 issue, not bytes.  A 16384-cell
// group is 3.4 MB of cells and 21 MB of (cell, species) tables against
// 8.5e10 evaluations (3+1D, 320 species, 32 x 24 x 21), each a sqrt, an
// exp and a reciprocal (f_mod) or an exp and two reciprocals (the
// fallback) besides 16 (f_mod) or 23 (the fallback at the main paths'
// flags) FP32 operations (kernels/feqmod.py, MOD_OPS and FALLBACK_OPS).
//
// Design of fixed_kernel (3+1D and 2+1D fixed nodes).  K1's blocking
// (smooth_spectra.cu) with the emission value of feqmod.cuh:
//   * One instantiation a chain.  A cell takes one chain (the reference's
//     own scalar semantics, emissionfunction_smooth_kernels.cpp:811-877;
//     JAX selects per point between two chains it always evaluates): a
//     breakdown cell the fallback (FB), a clean cell f_mod (MOD) and, in
//     3+1D, a clean cell with detA < 0.01 f_mod but the fallback at the
//     nodes where |y - eta| < detA (MIX, the two-chain body).  The wrapper
//     sorts the group's cells by chain on the card
//     (kernels/feqmod.py:chain_split, a stable sort and the parts'
//     offsets, which the kernel reads, so the host never waits) and
//     launches each chain's instantiation over its part, in the order MOD,
//     FB, MIX on one stream.  An instantiation holds only its chain's
//     registers and loads, and no warp diverges on the chain outside MIX.
//     The df mode is a template parameter and, where they are the main
//     paths' (shear + bulk, regulate, outflow: MAIN), so are the switches;
//     other switch sets read them at run time.
//   * Staging.  kernels/feqmod.py:fixed_stage lays out each chain's
//     inputs in the chain order, once a group, in torch: a per-cell row
//     (ModRow, FbRow) with the cell's constants folded in (log2 e / T_mod,
//     -log2 e alphaB_mod, log2 e / T, 2 pi^xy, the fallback's
//     coefficients with bulkPi and 1/T folded into the bulk terms',
//     feqmod.cuh FbFold), the per-(cell, node) composites (NMC, NFC
//     values, the nodes padded to whole register blocks) and the (cell,
//     species) |renorm| x validity (f_mod) and validity (the fallback),
//     the species padded to a multiple of J.  A tile of TILE cells and its
//     node composites are copied into shared memory 16 bytes a thread and
//     read back as 16-byte vectors.
//   * Register blocking.  A thread owns one momentum point for J species
//     and YC nodes (3+1D the block's YC rapidities, 2+1D the eta nodes in
//     steps of YC).  The momentum transform x = Minv p_LRF with p_LRF = mT
//     (alpha ch + beta sh) + gamma(px, py) comes in as coefficients: Minv
//     (alpha ch + beta sh) per (cell, node) and Minv gamma per (cell,
//     point), shared by every node and species.  An f_mod evaluation is
//     then 3 FMA for x, 3 for m^2 + |x|^2 (a sum of squares: the JAX
//     package's expanded quadratic form cancels in float32 near
//     breakdown), the saturation (one min), a sqrt, an exp and a
//     reciprocal.  32-cell tiles and 4 blocks an SM (at most 128
//     registers; the narrow cells' body 3, which spilled at 4) beat 16-cell
//     tiles and 3 blocks on an H100 (PERF.md, section 6).
//   * float32 takes ex2.approx on a pre-scaled argument, rcp.approx and
//     sqrt.approx, which keep +inf -> 0; float64 keeps IEEE exp, division
//     and sqrt.
//   * The cells are split into ranges (the wrapper picks the count from
//     the card's resident-block count, kernels/launch.py:split_to_fill):
//     each chain's launch cuts its own part into that many ranges, and
//     range k of every chain adds into partial k (the first launch
//     writes, the later ones add), so the partial buffer keeps the size of
//     one launch's.  fold_kernel adds the ranges in order.  The sum over a
//     group's cells so runs range by range: within range k, the f_mod
//     cells' sum, then the fallback's, then the narrow cells', each in the
//     group's order.  No atomics: two launches give identical bits.
//
// Design of remap_kernel (the 2+1D mT remap): the chains, the order of
// their launches, the compiled-in switches, the partial sums and the
// staging of fixed_kernel (remap_stage lays out the rows: f_mod's
// exp(y_flow) and half sums of its node terms, the fallback's exp(+-y_flow)
// and coefficients), with smooth_spectra.cu's transposed loop.
//   * f_mod's node moves with (cell, species, pT): delta = y_flow + zscale
//     s(mT) eta_r, so exp(delta) = exp(y_flow) exp(zscale s eta_r) is one
//     exp per (cell, species, pT, node), and e^-delta one reciprocal; a
//     thread owns one (species, pT) for NPHI angles and RNODES nodes, so
//     both are shared by the NPHI angles, whose per-(cell, angle) terms
//     (at unit pT: x's point term enters as one FMA by pT) are formed
//     once per tile and read as 16-byte vectors.  The fallback's shared
//     nodes read the node table.
//   * The grid also spans chunks of RNODES nodes: partial k x chunks +
//     chunk holds range k of every chain at the chunk's nodes.

#include <cuda_runtime.h>

#include <algorithm>

#include "feqmod.cuh"

namespace {

using namespace is3d;

constexpr int BLOCK = 128;         // momentum points per block
constexpr int J = 4;               // species per thread
constexpr int YC = 3;              // nodes per register block
constexpr int TILE = 32;           // cells per shared-memory tile
constexpr int RS2 = 12;            // 2+1D nodes per staged chunk (x YC)
constexpr int MAX_SPLIT = 8;

// ------------------------------------------------ fixed rapidity nodes

// the chain of a launch's cells (kernels/feqmod.py CHAINS)
enum Chain { MOD = 0, FB = 1, MIX = 2 };

// the staged per-cell rows (kernels/feqmod.py MOD_ROW, FB_ROW): f_mod's
// dsigma_x, dsigma_y, x's point coefficients gx, gy, L / T_mod, -L
// alphaB_mod; the fallback's dsigma_x, dsigma_y, -u^x, -u^y, pi^xx, pi^yy,
// 2 pi^xy, L / T, -L alphaB, its coefficients (FbFold), -V^x, -V^y
enum ModRow {
  M_DAX, M_DAY, M_GX0, M_GX1, M_GX2, M_GY0, M_GY1, M_GY2, M_INVTM, M_NABM,
  NMR = 12
};
enum FbRow {
  B_DAX, B_DAY, B_NUX, B_NUY, B_PXX, B_PYY, B_PXY2, B_INVTL, B_NAB, B_KSH,
  B_KFB, B_KGB, B_K3B, B_BENTH, B_KV, B_DZL, B_DLT, B_NVX, B_NVY, NFR = 20
};
// the staged per-(cell, node) composites (MOD_COMP, FB_COMP): f_mod's A1
// and Minv (alpha ch + beta sh) at the scaled node; the fallback's A1, B1,
// C1, C2, C3, D1 at the unscaled node and the narrow flag
constexpr int NMC = 4, NFC = 8;

// what every instantiation reads: fixed_stage's tables, every table in
// the group's chain order (row k is the k-th cell of the sorted group)
template <typename T>
struct FixedIn {
  const T* mrow;       // (C, NMR)
  const T* frow;       // (C, NFR)
  const T* mcomp;      // (C, rp, NMC)
  const T* fcomp;      // (C, rp, NFC)
  const T* rnw;        // (C, s4) |renorm| x validity
  const T* wj;         // (C, s4) validity
  const int* offs;     // chain k's rows: offs[k] .. offs[k + 1]
  const T* mass;
  const T* sign;
  const T* baryon;
  const T* pT;
  const T* px;
  const T* py;
  const T* weights;    // (rp), 0 past the last node
  int n_species, s4, M, n_phi, n_nodes, rp, n_split;
  int sw, regulate, outflow, add;
  T* partial;          // (n_split, S, M, n_out), unscaled
};

// copy n rows of W values (W values a multiple of 16 bytes) from src rows
// r0 .. r0 + n into shared rows of stride D at offset o, 16 bytes a thread
template <typename T, int W>
__device__ __forceinline__ void copy_rows(const T* __restrict__ src,
                                          size_t r0, int n, T* dst, int D,
                                          int o) {
  constexpr int U = 16 / sizeof(T);
  constexpr int UR = W / U;
  for (int i = threadIdx.x; i < n * UR; i += BLOCK) {
    const int r = i / UR;
    const int k = i - r * UR;
    *reinterpret_cast<uint4*>(dst + r * D + o + k * U) =
        *reinterpret_cast<const uint4*>(src + (r0 + r) * W + k * U);
  }
}

// copy the W composites of nodes r0 .. r0 + nr of cells c0 .. c0 + nc
// (src (C, rp, W)) into shared (cell, node) rows of stride D at offset o,
// RSC nodes a cell
template <typename T, int W, int RSC>
__device__ __forceinline__ void copy_comp(const T* __restrict__ src,
                                          size_t c0, int nc, int rp, int r0,
                                          int nr, T* dst, int D, int o) {
  constexpr int U = 16 / sizeof(T);
  constexpr int UR = W / U;
  const int per = nr * UR;
  for (int i = threadIdx.x; i < nc * per; i += BLOCK) {
    const int c = i / per;
    const int k = i - c * per;
    const int rr = k / UR;
    *reinterpret_cast<uint4*>(dst + (c * RSC + rr) * D + o +
                              (k - rr * UR) * U) =
        *reinterpret_cast<const uint4*>(src + ((c0 + c) * rp + r0) * W +
                                        k * U);
  }
}

// copy the J values of species s0 .. s0 + J of cells c0 .. c0 + nc (src
// (C, s4)) into shared rows of stride D at offset o
template <typename T>
__device__ __forceinline__ void copy_species(const T* __restrict__ src,
                                             size_t c0, int nc, int s4,
                                             int s0, T* dst, int D, int o) {
  constexpr int U = 16 / sizeof(T);
  constexpr int UJ = J / U;
  for (int i = threadIdx.x; i < nc * UJ; i += BLOCK) {
    const int c = i / UJ;
    const int k = i - c * UJ;
    *reinterpret_cast<uint4*>(dst + c * D + o + k * U) =
        *reinterpret_cast<const uint4*>(src + (c0 + c) * s4 + s0 + k * U);
  }
}

// resident blocks an SM the registers are cut for: float32 4 (at most 128
// registers a thread), 3 for the two-chain body (4 spilled), float64 2
constexpr int fixed_min_blocks(size_t size, int chain) {
  return size == 4 ? (chain == MIX ? 3 : 4) : 2;
}

// grid (point blocks, species groups of J, n_split x node groups of YC
// (3+1D) or n_split (2+1D)): block (x, y, z) sums the cells of range
// z / node groups of its chain's part at its points, species and nodes
template <typename T, int DIM, int CHAIN, int DF, bool MAIN>
__global__ void __launch_bounds__(BLOCK, fixed_min_blocks(sizeof(T), CHAIN))
fixed_kernel(const FixedIn<T> a) {
  using F = Fn<T>;
  constexpr bool HM = CHAIN != FB;           // f_mod evaluated
  constexpr bool HF = CHAIN != MOD;          // the fallback evaluated
  constexpr int RSC = DIM == 3 ? YC : RS2;   // nodes staged a chunk
  constexpr int NR = (HM ? NMR : 0) + (HF ? NFR : 0);
  constexpr int NC = (HM ? NMC : 0) + (HF ? NFC : 0);
  constexpr int NJ = (HM ? J : 0) + (HF ? J : 0);
  constexpr int FO = HM ? NMR : 0;           // the fallback's row offset
  constexpr int FC = HM ? NMC : 0;           // ... composites' offset
  constexpr int FJ = HM ? J : 0;             // ... validity's offset
  __shared__ __align__(16) T srow[TILE * NR];
  __shared__ __align__(16) T scomp[TILE * RSC * NC];
  __shared__ __align__(16) T ssp[TILE * NJ];
  __shared__ T swt[RSC];

  const int tid = threadIdx.x;
  const int nz = DIM == 3 ? (a.n_nodes + YC - 1) / YC : 1;
  const int split = blockIdx.z / nz;
  const int rbeg = DIM == 3 ? (blockIdx.z - split * nz) * YC : 0;
  const int rend = DIM == 3 ? rbeg + YC : a.rp;     // staged, padded
  const int m = blockIdx.x * BLOCK + tid;
  const int s0 = blockIdx.y * J;
  const int n_out = DIM == 3 ? a.n_nodes : 1;
  const int sw = MAIN ? (SW_SHEAR | SW_BULK) : a.sw;
  const bool outflow = MAIN || a.outflow;
  // this block's range of its chain's part
  const int base = a.offs[CHAIN];
  const int n_part = a.offs[CHAIN + 1] - base;
  const int per = (n_part + a.n_split - 1) / a.n_split;
  const int cbeg = base + min(n_part, split * per);
  const int cend = base + min(n_part, (split + 1) * per);
  if (a.add && cbeg >= cend) return;               // nothing to add

  // the thread's momentum point for its J species (ragged edges clamped
  // to a real point and species, never stored)
  const int mc = min(m, a.M - 1);
  const T pxv = a.px[mc], pyv = a.py[mc];
  const T pt = a.pT[mc / a.n_phi];
  const T px2 = pxv * pxv, py2 = pyv * pyv, pxpy = pxv * pyv;
  T mT[J], mT2[J], m2[J], sgn[J], bar[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int s = min(s0 + j, a.n_species - 1);
    m2[j] = a.mass[s] * a.mass[s];
    mT[j] = d_sqrt(m2[j] + pt * pt);
    mT2[j] = mT[j] * mT[j];
    sgn[j] = a.sign[s];
    bar[j] = a.baryon[s];
  }

  T acc[J][YC];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int y = 0; y < YC; ++y) acc[j][y] = T(0);

  for (int c0 = cbeg; c0 < cend; c0 += TILE) {
    const int nc = min(TILE, cend - c0);
    __syncthreads();                                 // previous tile consumed
    if (HM) {
      copy_rows<T, NMR>(a.mrow, c0, nc, srow, NR, 0);
      copy_species<T>(a.rnw, c0, nc, a.s4, s0, ssp, NJ, 0);
    }
    if (HF) {
      copy_rows<T, NFR>(a.frow, c0, nc, srow, NR, FO);
      copy_species<T>(a.wj, c0, nc, a.s4, s0, ssp, NJ, FJ);
    }
    for (int r0 = rbeg; r0 < rend; r0 += RSC) {
      // nodes of this chunk, whole register blocks (the staged tables
      // repeat the last node, with weight 0 in 2+1D; not stored in 3+1D)
      const int nrp = min(RSC, rend - r0);
      if (r0 != rbeg) __syncthreads();               // previous chunk consumed
      if (HM)
        copy_comp<T, NMC, RSC>(a.mcomp, c0, nc, a.rp, r0, nrp, scomp, NC, 0);
      if (HF)
        copy_comp<T, NFC, RSC>(a.fcomp, c0, nc, a.rp, r0, nrp, scomp, NC,
                               FC);
      if (DIM == 2 && tid < nrp) swt[tid] = a.weights[r0 + tid];
      __syncthreads();
      for (int c = 0; c < nc; ++c) {
        // per (cell, point) and (cell, species): f_mod's
        T W1 = T(0), gam[3] = {T(0), T(0), T(0)}, invTmL = T(0);
        T nbm[J], rnj[J];
        if (HM) {
          const T* q = srow + c * NR;
          T dax, day, gx0, gx1, gx2, gy0, gy1, gy2, nabm, u0, u1;
          F::ld4(q, dax, day, gx0, gx1);
          F::ld4(q + 4, gx2, gy0, gy1, gy2);
          F::ld4(q + 8, invTmL, nabm, u0, u1);
          W1 = fma(dax, pxv, day * pyv);
          gam[0] = fma(gx0, pxv, gy0 * pyv);
          gam[1] = fma(gx1, pxv, gy1 * pyv);
          gam[2] = fma(gx2, pxv, gy2 * pyv);
          F::ld4(ssp + c * NJ, rnj[0], rnj[1], rnj[2], rnj[3]);
#pragma unroll
          for (int j = 0; j < J; ++j) nbm[j] = nabm * bar[j];
        }
        // ... and the fallback's
        T nW2 = T(0), C4 = T(0), nD2 = T(0);
        T nbal[J], kGb[J], wj[J];
        FbFold<T> k{};
        if (HF) {
          const T* q = srow + c * NR + FO;
          T dax, day, nux, nuy, pxx, pyy, pxy2, nvx, nvy, u0;
          F::ld4(q, dax, day, nux, nuy);
          F::ld4(q + 4, pxx, pyy, pxy2, k.invTL);
          F::ld4(q + 8, k.nab, k.ksh, k.kFb, k.kGb);
          F::ld4(q + 12, k.k3b, k.benth, k.kV, k.dzl);
          F::ld4(q + 16, k.dlT, nvx, nvy, u0);
          W1 = fma(dax, pxv, day * pyv);
          nW2 = fma(nux, pxv, nuy * pyv);
          C4 = fma(pxx, px2, fma(pyy, py2, pxy2 * pxpy));
          if (!MAIN) nD2 = fma(nvx, pxv, nvy * pyv);
          F::ld4(ssp + c * NJ + FJ, wj[0], wj[1], wj[2], wj[3]);
#pragma unroll
          for (int j = 0; j < J; ++j) {
            nbal[j] = bar[j] * k.nab;
            kGb[j] = k.kGb * bar[j];
          }
        }
        const T* kc = scomp + c * RSC * NC;
        for (int rr = 0; rr < nrp; rr += YC) {
#pragma unroll
          for (int y = 0; y < YC; ++y) {
            const T* q = kc + (rr + y) * NC;
            const T w = DIM == 3 ? T(1) : swt[rr + y];
            T fA1 = T(0), B1 = T(0), C1 = T(0), C2 = T(0), C3 = T(0),
              D1 = T(0), narrow = T(0), u0;
            if (HF) {
              F::ld4(q + FC, fA1, B1, C1, C2);
              F::ld4(q + FC + 4, C3, D1, narrow, u0);
            }
            if (CHAIN == MOD || (CHAIN == MIX && narrow == T(0))) {
              T A1, al0, al1, al2;
              F::ld4(q, A1, al0, al1, al2);
#pragma unroll
              for (int j = 0; j < J; ++j) {
                const T x0 = fma(mT[j], al0, gam[0]);
                const T x1 = fma(mT[j], al1, gam[1]);
                const T x2 = fma(mT[j], al2, gam[2]);
                const T e2 = fq_sat(fma(x0, x0, fma(x1, x1,
                                                    fma(x2, x2, m2[j]))));
                const T f = rnj[j] * F::rcp(F::exp_scaled(fma(
                                fq_sqrt(e2), invTmL, nbm[j])) + sgn[j]);
                const T pds = fma(mT[j], A1, W1);
                // exactly 0 where f_mod is, and the outflow select
                const T v = (f != T(0) && (!outflow || pds > T(0)))
                                ? pds * f : T(0);
                acc[j][y] = DIM == 3 ? acc[j][y] + v
                                     : fma(w, v, acc[j][y]);
              }
            } else {
              const T c23 = fma(pxv, C2, pyv * C3);
#pragma unroll
              for (int j = 0; j < J; ++j) {
                const T pdu = fma(mT[j], B1, nW2);
                const T pipp = fma(mT2[j], C1, fma(mT[j], c23, C4));
                const T Vp = MAIN ? T(0) : fma(mT[j], D1, nD2);
                const T f = fallback_fixed<T, DF, MAIN>(
                    pdu, pipp, Vp, m2[j], sgn[j], bar[j], nbal[j], kGb[j], k,
                    sw, a.regulate);
                const T pds = fma(mT[j], fA1, W1);
                T v = pds * f;
                if (outflow) v = pds > T(0) ? v : T(0);
                v = v * wj[j];
                acc[j][y] = DIM == 3 ? acc[j][y] + v
                                     : fma(w, v, acc[j][y]);
              }
            }
          }
        }
      }
    }
  }
  if (m >= a.M) return;
  T* o = a.partial + (size_t)split * a.n_species * a.M * (size_t)n_out;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int s = s0 + j;
    if (s >= a.n_species) continue;
    if (DIM == 3) {
#pragma unroll
      for (int y = 0; y < YC; ++y)
        if (rbeg + y < a.n_nodes) {
          T* p = o + ((size_t)s * a.M + m) * a.n_nodes + rbeg + y;
          *p = a.add ? *p + acc[j][y] : acc[j][y];
        }
    } else {
      T v = T(0);
#pragma unroll
      for (int y = 0; y < YC; ++y) v += acc[j][y];
      T* p = o + (size_t)s * a.M + m;
      *p = a.add ? *p + v : v;
    }
  }
}

// ------------------------------------------------------- 2+1D mT remap

constexpr int RBLOCK = 128;        // (species, pT) threads per block
static_assert(RBLOCK == BLOCK, "copy_rows strides by BLOCK threads");
constexpr int RYC = 3;             // nodes per register block
constexpr int RNODES = 12;         // nodes per block (a multiple of RYC)
constexpr int RTILE = 8;           // cells per shared-memory tile
constexpr int MAX_RSPLIT = 64;

// the remap kernel's staged per-cell rows (kernels/feqmod.py REMAP_MOD_ROW,
// REMAP_FB_ROW): f_mod's exp(y_flow of the mod nodes), zscale, L / T_mod,
// -L alphaB_mod, (dat +- dant) / 2, (a_k +- b_k) / 2 and the (cell, phi)
// terms' dsigma_x, dsigma_y, gx, gy; the fallback's exp(+-y_flow), dat,
// dant, u^t, -tau u^n, V^t, -tau V^n, pi^tt, tau^2 pi^nn, -2 tau pi^tn,
// its coefficients (FbFold) and the (cell, phi) terms' fields
enum RemapModRow {
  RM_EY, RM_ZS, RM_INVTM, RM_NABM, RM_HAP, RM_HAM, RM_HP0, RM_HM0, RM_HP1,
  RM_HM1, RM_HP2, RM_HM2, RM_DAX, RM_DAY, RM_GX0, RM_GX1, RM_GX2, RM_GY0,
  RM_GY1, RM_GY2, NRM = 20
};
enum RemapFbRow {
  RF_EY, RF_EYM, RF_DAT, RF_DANT, RF_UT, RF_NTUN, RF_VT, RF_NVN, RF_C1A,
  RF_C1B, RF_C1C, RF_PAD0, RF_INVTL, RF_NAB, RF_KSH, RF_KFB, RF_KGB, RF_K3B,
  RF_BENTH, RF_KV, RF_DZL, RF_DLT, RF_DAX, RF_DAY, RF_UX, RF_UY, RF_VX,
  RF_VY, RF_PIXX, RF_PIYY, RF_PIXY, RF_PITX, RF_PITY, RF_TAU, RF_PIXN,
  RF_PIYN, NRF = 36
};

// what every remap instantiation reads: remap_stage's tables in the
// group's chain order
template <typename T>
struct RemapIn {
  const T* mrow;       // (C, NRM)
  const T* frow;       // (C, NRF)
  const T* rnzw;       // (C, S) |renorm| x zscale x validity
  const T* wj;         // (C, S) validity
  const int* offs;     // chain k's rows: offs[k] .. offs[k + 1]
  const T* mass;
  const T* sign;
  const T* baryon;
  const T* pT;
  const T* cos_phi;
  const T* sin_phi;
  const T* table;      // (S, P, R, 2) exp(-s eta_r), exp(+s eta_r)
  const T* nodes;
  const T* weights;
  int n_species, n_pT, n_phi, n_nodes, n_split;
  int sw, regulate, outflow, add;
  T t_ref;
  T* partial;          // (n_split x node chunks, S, P, F), unscaled
};

// the (cell, phi) terms at unit pT of a staged row (cf, sf = cos, sin phi):
// f_mod's w1 (p.dsigma) and gamma1 (x's point term, 3); the fallback's w1,
// -w2, c4, g, h with px C2 + py C3 = ch g + sh h, and -d2
template <typename T, int CHAIN>
__device__ __forceinline__ void remap_terms(const T* g, T cf, T sf, T* o) {
  if (CHAIN == MOD) {
    o[0] = g[RM_DAX] * cf + g[RM_DAY] * sf;
    o[1] = g[RM_GX0] * cf + g[RM_GY0] * sf;
    o[2] = g[RM_GX1] * cf + g[RM_GY1] * sf;
    o[3] = g[RM_GX2] * cf + g[RM_GY2] * sf;
  } else {
    o[0] = g[RF_DAX] * cf + g[RF_DAY] * sf;
    o[1] = -(g[RF_UX] * cf + g[RF_UY] * sf);
    o[2] = g[RF_PIXX] * cf * cf + g[RF_PIYY] * sf * sf
           + T(2) * g[RF_PIXY] * cf * sf;
    o[3] = T(-2) * (g[RF_PITX] * cf + g[RF_PITY] * sf);
    o[4] = T(2) * g[RF_TAU] * (g[RF_PIXN] * cf + g[RF_PIYN] * sf);
    o[5] = -(g[RF_VX] * cf + g[RF_VY] * sf);
    o[6] = T(0);
    o[7] = T(0);
  }
}

// grid (blocks of RBLOCK (species, pT) pairs, phi chunks of NPHI, n_split x
// node chunks of RNODES); thread i owns species i / n_pT at pT i % n_pT
// for the block's NPHI angles and RNODES nodes over range z / node chunks
// of its chain's part.  partial (n_split x node chunks, S, P, F).
template <typename T, int NPHI, int CHAIN, int DF, bool MAIN>
__global__ void __launch_bounds__(RBLOCK, sizeof(T) == 4 ? 4 : 2)
remap_kernel(const RemapIn<T> a) {
  using F = Fn<T>;
  constexpr bool HM = CHAIN == MOD;
  constexpr int NRW = HM ? NRM : NRF;        // staged row
  constexpr int NPR = HM ? 4 : 8;            // (cell, phi) terms
  __shared__ __align__(16) T tab[HM ? 2 : RNODES * RBLOCK * 2];
  __shared__ __align__(16) T rows[RTILE * NPHI * NPR];
  __shared__ __align__(16) T srow[RTILE * NRW];
  __shared__ T wts[RNODES];
  __shared__ T eta[RNODES];

  const int tid = threadIdx.x;
  const int n_sp = a.n_species * a.n_pT;
  const int i = blockIdx.x * RBLOCK + tid;
  const int ic = min(i, n_sp - 1);         // ragged edge: clamped, not stored
  const int s = ic / a.n_pT;
  const int n_chunks = (a.n_nodes + RNODES - 1) / RNODES;
  const int split = blockIdx.z / n_chunks;
  const int r0 = (blockIdx.z - split * n_chunks) * RNODES;
  const int nr = min(RNODES, a.n_nodes - r0);
  const int nrp = (nr + RYC - 1) / RYC * RYC;
  const int f0 = blockIdx.y * NPHI;
  const int sw = MAIN ? (SW_SHEAR | SW_BULK) : a.sw;
  const bool outflow = MAIN || a.outflow;
  const int base = a.offs[CHAIN];
  const int n_part = a.offs[CHAIN + 1] - base;
  const int per = (n_part + a.n_split - 1) / a.n_split;
  const int cbeg = base + min(n_part, split * per);
  const int cend = base + min(n_part, (split + 1) * per);
  if (a.add && cbeg >= cend) return;               // nothing to add
  const T L = F::SCALE;

  const T pt = a.pT[ic - s * a.n_pT];
  const T pt2 = pt * pt;
  const T m2 = a.mass[s] * a.mass[s];
  const T mTv = d_sqrt(m2 + pt2);
  const T hmT = T(0.5) * mTv;
  const T sgn = a.sign[s];
  const T bar = a.baryon[s];
  // s(mT) of the node map (kernels/smooth.py:remap_scale)
  const T sv = d_sqrt(a.t_ref / (mTv > a.t_ref ? mTv : a.t_ref));

  // the thread's fallback node factors; the padding up to whole register
  // blocks repeats the last node with weight 0
  if (!HM)
    for (int rr = 0; rr < nrp; ++rr) {
      const size_t at =
          ((size_t)ic * a.n_nodes + min(r0 + rr, a.n_nodes - 1)) * 2;
      tab[(rr * RBLOCK + tid) * 2] = a.table[at];
      tab[(rr * RBLOCK + tid) * 2 + 1] = a.table[at + 1];
    }
  if (tid < RNODES) {
    wts[tid] = tid < nr ? a.weights[r0 + tid] : T(0);
    eta[tid] = a.nodes[min(r0 + tid, a.n_nodes - 1)];
  }

  T acc[NPHI];
#pragma unroll
  for (int f = 0; f < NPHI; ++f) acc[f] = T(0);

  for (int c0 = cbeg; c0 < cend; c0 += RTILE) {
    const int nc = min(RTILE, cend - c0);
    __syncthreads();                                 // previous tile consumed
    copy_rows<T, NRW>(HM ? a.mrow : a.frow, c0, nc, srow, NRW, 0);
    __syncthreads();
    for (int k = tid; k < nc * NPHI; k += RBLOCK) {
      const int c = k / NPHI;
      const int fc = min(f0 + k - c * NPHI, a.n_phi - 1);
      remap_terms<T, CHAIN>(srow + c * NRW, a.cos_phi[fc], a.sin_phi[fc],
                            rows + k * NPR);
    }
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
      const T* g = srow + c * NRW;
      const T* rw = rows + c * NPHI * NPR;
      const size_t cs = (size_t)(c0 + c) * a.n_species + s;
      if (HM) {
        // f_mod: per (cell, species, pT)
        T ey, zs, invTmL, nabm;
        F::ld4(g, ey, zs, invTmL, nabm);
        const T zsv = L * (zs * sv);
        const T rnz = a.rnzw[cs];
        const T nbm = nabm * bar;
        T hAp, hAm, hp0, hm0, hp1, hm1, hp2, hm2;
        F::ld4(g + RM_HAP, hAp, hAm, hp0, hm0);
        F::ld4(g + RM_HP1, hp1, hm1, hp2, hm2);
        // (mT / 2)(dat +- dant) and (mT / 2)(a_k +- b_k): ch and sh of the
        // node as (e^delta +- e^-delta) / 2
        const T hA = mTv * hAp, hB = mTv * hAm;
        const T hp[3] = {mTv * hp0, mTv * hp1, mTv * hp2};
        const T hm[3] = {mTv * hm0, mTv * hm1, mTv * hm2};
        for (int rr = 0; rr < nrp; rr += RYC) {
          // per (cell, species, pT, node): e^delta from one exp, e^-delta
          // from one reciprocal, then p.dsigma's and x's node terms
          T A[RYC], X[RYC][3], w[RYC];
#pragma unroll
          for (int y = 0; y < RYC; ++y) {
            const T eq = ey * F::exp_scaled(zsv * eta[rr + y]);
            const T rq = F::rcp(eq);
            A[y] = fma(hA, eq, hB * rq);
#pragma unroll
            for (int k3 = 0; k3 < 3; ++k3)
              X[y][k3] = fma(hp[k3], eq, hm[k3] * rq);
            w[y] = wts[rr + y];
          }
#pragma unroll
          for (int f = 0; f < NPHI; ++f) {
            T w1, g0, g1, g2;
            F::ld4(rw + f * NPR, w1, g0, g1, g2);
#pragma unroll
            for (int y = 0; y < RYC; ++y) {
              const T x0 = fma(pt, g0, X[y][0]);
              const T x1 = fma(pt, g1, X[y][1]);
              const T x2 = fma(pt, g2, X[y][2]);
              const T e2 = fq_sat(fma(x0, x0, fma(x1, x1, fma(x2, x2, m2))));
              const T fm = rnz * F::rcp(F::exp_scaled(fma(
                               fq_sqrt(e2), invTmL, nbm)) + sgn);
              const T pds = fma(pt, w1, A[y]);
              // exactly 0 where f_mod is, and the outflow select
              const T v = (fm != T(0) && (!outflow || pds > T(0)))
                              ? pds * fm : T(0);
              acc[f] = fma(w[y], v, acc[f]);
            }
          }
        }
      } else {
        // the fallback at the shared nodes Delta = y_flow - s eta_r
        T ey, eym, dat, dant, ut, ntun, vt, nvn, c1a, c1b, c1c, u0;
        F::ld4(g, ey, eym, dat, dant);
        F::ld4(g + RF_UT, ut, ntun, vt, nvn);
        F::ld4(g + RF_C1A, c1a, c1b, c1c, u0);
        FbFold<T> k;
        F::ld4(g + RF_INVTL, k.invTL, k.nab, k.ksh, k.kFb);
        F::ld4(g + RF_KGB, k.kGb, k.k3b, k.benth, k.kV);
        k.dzl = g[RF_DZL];
        k.dlT = g[RF_DLT];
        const T wc = a.wj[cs];
        const T nbal = bar * k.nab, kGb = k.kGb * bar;
        const T eyh = ey * hmT;
        const T eymh = eym * hmT;
        for (int rr = 0; rr < nrp; rr += RYC) {
          T A[RYC], B[RYC], D[RYC], C1[RYC], cg[RYC], sg[RYC], w[RYC];
#pragma unroll
          for (int y = 0; y < RYC; ++y) {
            const T tm = tab[((rr + y) * RBLOCK + tid) * 2];
            const T tp = tab[((rr + y) * RBLOCK + tid) * 2 + 1];
            const T ep = eyh * tm;
            const T em = eymh * tp;
            const T ch = ep + em;
            const T sh = ep - em;
            A[y] = fma(ch, dat, sh * dant);
            B[y] = fma(ch, ut, sh * ntun);
            D[y] = MAIN ? T(0) : fma(ch, vt, sh * nvn);
            C1[y] = fma(ch * ch, c1a, fma(sh * sh, c1b, ch * sh * c1c));
            cg[y] = ch * pt;
            sg[y] = sh * pt;
            w[y] = wts[rr + y];
          }
#pragma unroll
          for (int f = 0; f < NPHI; ++f) {
            T w1, nw2, c4, gg, hh, nd2, u1, u2;
            F::ld4(rw + f * NPR, w1, nw2, c4, gg);
            F::ld4(rw + f * NPR + 4, hh, nd2, u1, u2);
#pragma unroll
            for (int y = 0; y < RYC; ++y) {
              const T pdu = fma(pt, nw2, B[y]);
              const T Vp = MAIN ? T(0) : fma(pt, nd2, D[y]);
              const T pipp =
                  fma(cg[y], gg, fma(sg[y], hh, fma(pt2, c4, C1[y])));
              const T fv = fallback_fixed<T, DF, MAIN>(
                  pdu, pipp, Vp, m2, sgn, bar, nbal, kGb, k, sw, a.regulate);
              const T pds = fma(pt, w1, A[y]);
              T v = pds * fv;
              if (outflow) v = pds > T(0) ? v : T(0);
              acc[f] = fma(w[y], v * wc, acc[f]);
            }
          }
        }
      }
    }
  }
  if (i >= n_sp) return;
  T* o = a.partial + ((size_t)blockIdx.z * n_sp + i) * a.n_phi + f0;
#pragma unroll
  for (int f = 0; f < NPHI; ++f)
    if (f0 + f < a.n_phi) o[f] = a.add ? o[f] + acc[f] : acc[f];
}

// out[i] = prefactor deg[s] (s(mT)) sum over the parts (in order) of
// partial; i runs over (S, n_pT, n_phi, n_out), s(mT) = sqrt(T_ref /
// max(mT, T_ref)) the jacobian of the remap (t_ref > 0 only)
template <typename T>
__global__ void __launch_bounds__(256)
fold_kernel(const T* __restrict__ partial, int n_parts, long long n,
            int n_pT, int n_phi, int n_out, const T* __restrict__ mass,
            const T* __restrict__ pT, const T* __restrict__ deg, T prefactor,
            T t_ref, T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  T v = T(0);
  for (int k = 0; k < n_parts; ++k) v += partial[k * n + i];
  const long long sp = i / ((long long)n_phi * n_out);
  const int s = (int)(sp / n_pT);
  if (t_ref > T(0)) {
    const T pt = pT[sp - (long long)s * n_pT];
    const T mT = d_sqrt(mass[s] * mass[s] + pt * pt);
    v = v * d_sqrt(t_ref / (mT > t_ref ? mT : t_ref));
  }
  out[i] = prefactor * deg[s] * v;
}

// ------------------------------------------------------------ launchers

// angles per thread of the remap kernel: of 8, 16 and 24 the width that
// pads n_phi the least, the largest of equals
int remap_phi_width(int n_phi) {
  int best = 8;
  for (int w = 16; w <= 24; w += 8)
    if ((n_phi + w - 1) / w * w <= (n_phi + best - 1) / best * best) best = w;
  return best;
}

bool shape_ok(int n_species, int n_pT, int n_phi, int n_nodes,
              int dimension) {
  return n_species >= 1 && n_pT >= 1 && n_phi >= 1 && n_nodes >= 1 &&
         (dimension == 2 || dimension == 3) &&
         (long long)n_species * n_pT * n_phi * n_nodes < 0x7fffffffLL &&
         (n_species + J - 1) / J <= 65535;
}

int resident(const void* kernel, int threads, int* slots) {
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

// the fixed-node kernel of (dimension, chain, df, main switches), or
// nullptr (f_mod does not depend on the df mode: DF = 0)
template <typename T, int DIM, int CHAIN>
const void* fixed_of(int df, bool main) {
  if (CHAIN == MOD)
    return main ? (const void*)fixed_kernel<T, DIM, MOD, 0, true>
                : (const void*)fixed_kernel<T, DIM, MOD, 0, false>;
  if (df == 3)
    return main ? (const void*)fixed_kernel<T, DIM, CHAIN, 3, true>
                : (const void*)fixed_kernel<T, DIM, CHAIN, 3, false>;
  return main ? (const void*)fixed_kernel<T, DIM, CHAIN, 4, true>
              : (const void*)fixed_kernel<T, DIM, CHAIN, 4, false>;
}

template <typename T>
const void* fixed_kernel_of(int dimension, int chain, int df, bool main) {
  if (df != 3 && df != 4) return nullptr;
  if (dimension == 3)
    return chain == MOD ? fixed_of<T, 3, MOD>(df, main)
           : chain == FB ? fixed_of<T, 3, FB>(df, main)
           : chain == MIX ? fixed_of<T, 3, MIX>(df, main)
                          : nullptr;
  if (dimension == 2)
    return chain == MOD ? fixed_of<T, 2, MOD>(df, main)
           : chain == FB ? fixed_of<T, 2, FB>(df, main)
                         : nullptr;
  return nullptr;
}

// the main paths' switches, which the kernels compile in
bool main_switches(int sw, int regulate, int outflow) {
  return sw == (SW_SHEAR | SW_BULK) && regulate && outflow;
}

// the remap kernel of (angles a thread, chain, df, main switches), or
// nullptr
template <typename T, int NPHI>
const void* remap_of(int chain, int df, bool main) {
  if (chain == MOD)
    return main ? (const void*)remap_kernel<T, NPHI, MOD, 0, true>
                : (const void*)remap_kernel<T, NPHI, MOD, 0, false>;
  if (chain != FB) return nullptr;
  if (df == 3)
    return main ? (const void*)remap_kernel<T, NPHI, FB, 3, true>
                : (const void*)remap_kernel<T, NPHI, FB, 3, false>;
  return main ? (const void*)remap_kernel<T, NPHI, FB, 4, true>
              : (const void*)remap_kernel<T, NPHI, FB, 4, false>;
}

template <typename T>
const void* remap_kernel_of(int width, int chain, int df, bool main) {
  if (df != 3 && df != 4) return nullptr;
  return width == 8 ? remap_of<T, 8>(chain, df, main)
         : width == 16 ? remap_of<T, 16>(chain, df, main)
         : width == 24 ? remap_of<T, 24>(chain, df, main)
                       : nullptr;
}

// a kernel's grid for a shape on the current card, the one owner of the
// blocking: out = {blocks for each range of cells, resident blocks (SMs x
// blocks per SM), partial sums for each range of cells, cells per tile,
// most ranges of cells, angles per thread (remap; 0 at fixed nodes)}
template <typename T>
int feqmod_grid(int n_species, int n_pT, int n_phi, int n_nodes,
                int dimension, int remap, int* out) {
  if (!shape_ok(n_species, n_pT, n_phi, n_nodes, dimension) ||
      (remap && dimension != 2) || out == nullptr)
    return cudaErrorInvalidValue;
  int slots = 0, rc;
  if (remap) {
    const int width = remap_phi_width(n_phi);
    rc = resident(remap_kernel_of<T>(width, FB, 3, true), RBLOCK, &slots);
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
  // every chain's instantiation is built for the same blocks an SM; the
  // fallback's main one stands for them
  rc = resident(fixed_kernel_of<T>(dimension, FB, 3, true), BLOCK, &slots);
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

// out: cells a tile, threads, static shared memory bytes, resident blocks
// an SM, registers and local memory bytes a thread of one chain's
// instantiation (launch.PROPS): dimension 3 or 2 at fixed nodes, 0 the
// 2+1D remap at n_phi angles
template <typename T>
int chain_props(int dimension, int chain, int df, int main, int n_phi,
                int* out) {
  const bool remap = dimension == 0;
  const void* kern =
      remap ? remap_kernel_of<T>(remap_phi_width(n_phi), chain, df, main != 0)
            : fixed_kernel_of<T>(dimension, chain, df, main != 0);
  if (kern == nullptr || out == nullptr) return cudaErrorInvalidValue;
  const int threads = remap ? RBLOCK : BLOCK;
  int blocks = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kern, threads, 0);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return (int)e;
  out[0] = remap ? RTILE : TILE;
  out[1] = threads;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = blocks;
  out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;
  return cudaSuccess;
}

template <typename T>
int fold(const void* partial, int n_parts, int n_species, int n_pT,
         int n_phi, int n_out, const void* mass, const void* pT,
         const void* deg, double prefactor, double t_ref, void* out,
         cudaStream_t stream) {
  const long long n = (long long)n_species * n_pT * n_phi * n_out;
  fold_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(partial), n_parts, n, n_pT, n_phi, n_out,
      static_cast<const T*>(mass), static_cast<const T*>(pT),
      static_cast<const T*>(deg), (T)prefactor, (T)t_ref,
      static_cast<T*>(out));
  return (int)cudaGetLastError();
}

// every chain's launch over its part of the group (MOD, FB, then in 3+1D
// MIX; the first writes the partials, the later add), then the fold
template <typename T>
int launch_fixed(FixedIn<T> a, int n_cells, const void* deg, int n_pT,
                 int df_mode, int dimension, double prefactor, void* out,
                 cudaStream_t stream) {
  if ((df_mode != 3 && df_mode != 4) ||
      !shape_ok(a.n_species, n_pT, a.n_phi, a.n_nodes, dimension) ||
      n_cells < 1 || a.n_split < 1 || a.n_split > MAX_SPLIT ||
      a.partial == nullptr || a.s4 < a.n_species || a.s4 % J != 0 ||
      a.rp != (a.n_nodes + YC - 1) / YC * YC ||
      a.sw < 0 || a.sw > (SW_SHEAR | SW_BULK | SW_DIFF))
    return cudaErrorInvalidValue;
  const unsigned nz =
      dimension == 3 ? (unsigned)((a.n_nodes + YC - 1) / YC) : 1u;
  if ((long long)nz * a.n_split > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((a.M + BLOCK - 1) / BLOCK),
                  (unsigned)((a.n_species + J - 1) / J),
                  nz * (unsigned)a.n_split);
  const bool main = main_switches(a.sw, a.regulate, a.outflow);
  void* args[] = {&a};
  for (int chain = MOD; chain <= (dimension == 3 ? MIX : FB); ++chain) {
    a.add = chain != MOD;
    const void* kern = fixed_kernel_of<T>(dimension, chain, df_mode, main);
    cudaError_t e = cudaLaunchKernel(kern, grid, dim3(BLOCK), args, 0,
                                     stream);
    if (e != cudaSuccess) return (int)e;
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  return fold<T>(a.partial, a.n_split, a.n_species, n_pT, a.n_phi,
                 dimension == 3 ? a.n_nodes : 1, a.mass, a.pT, deg,
                 prefactor, 0.0, out, stream);
}

// every chain's launch over its part of the group (MOD, then FB; the
// first writes the partials, the second adds), then the fold with the
// remap's jacobian
template <typename T>
int launch_remap(RemapIn<T> a, int n_cells, const void* deg, int df_mode,
                 double prefactor, int n_partial, void* out,
                 cudaStream_t stream) {
  const int width = remap_phi_width(a.n_phi);
  const long long n_chunks = (a.n_nodes + RNODES - 1) / RNODES;
  const long long n_parts = a.n_split * n_chunks;
  const long long n_sp = (long long)a.n_species * a.n_pT;
  if ((df_mode != 3 && df_mode != 4) ||
      !shape_ok(a.n_species, a.n_pT, a.n_phi, a.n_nodes, 2) || n_cells < 1 ||
      a.n_split < 1 || a.n_split > MAX_RSPLIT || n_parts != n_partial ||
      n_parts > 65535 || (a.n_phi + width - 1) / width > 65535 ||
      !(a.t_ref > T(0)) || a.partial == nullptr || a.sw < 0 ||
      a.sw > (SW_SHEAR | SW_BULK | SW_DIFF))
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n_sp + RBLOCK - 1) / RBLOCK),
                  (unsigned)((a.n_phi + width - 1) / width),
                  (unsigned)n_parts);
  const bool main = main_switches(a.sw, a.regulate, a.outflow);
  void* args[] = {&a};
  for (int chain = MOD; chain <= FB; ++chain) {
    a.add = chain != MOD;
    const void* kern = remap_kernel_of<T>(width, chain, df_mode, main);
    cudaError_t e = cudaLaunchKernel(kern, grid, dim3(RBLOCK), args, 0,
                                     stream);
    if (e != cudaSuccess) return (int)e;
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  return fold<T>(a.partial, (int)n_parts, a.n_species, a.n_pT, a.n_phi, 1,
                 a.mass, a.pT, deg, prefactor, (double)a.t_ref, out, stream);
}

}  // namespace

extern "C" {

// a feqmod kernel's grid on the current card (see feqmod_grid); returns a
// CUDA error code
int is3d_feqmod_grid_f32(int n_species, int n_pT, int n_phi, int n_nodes,
                         int dimension, int remap, int* out) {
  return feqmod_grid<float>(n_species, n_pT, n_phi, n_nodes, dimension,
                            remap, out);
}
int is3d_feqmod_grid_f64(int n_species, int n_pT, int n_phi, int n_nodes,
                         int dimension, int remap, int* out) {
  return feqmod_grid<double>(n_species, n_pT, n_phi, n_nodes, dimension,
                             remap, out);
}

// fixed nodes: fixed_stage's tables (kernels/feqmod.py) of a group
// sorted by chain, offs the chains' parts; partial (n_split, S, P, F,
// n_out)
#define IS3D_FEQMOD_ENTRY(NAME, T)                                            \
  int NAME(const void* mrow, const void* frow, const void* mcomp,            \
           const void* fcomp, const void* rnw, const void* wj,               \
           const void* offs, int n_cells, int s4, int rp, const void* mass,  \
           const void* sign, const void* baryon, const void* deg,            \
           int n_species, const void* pT, const void* px, const void* py,    \
           int n_pT, int n_phi, const void* weights, int n_nodes,            \
           int df_mode, int dimension, int sw, int regulate, int outflow,    \
           double prefactor, int n_split, void* partial, void* out,          \
           void* stream) {                                                   \
    FixedIn<T> a{static_cast<const T*>(mrow), static_cast<const T*>(frow),   \
                 static_cast<const T*>(mcomp), static_cast<const T*>(fcomp), \
                 static_cast<const T*>(rnw), static_cast<const T*>(wj),      \
                 static_cast<const int*>(offs), static_cast<const T*>(mass), \
                 static_cast<const T*>(sign), static_cast<const T*>(baryon), \
                 static_cast<const T*>(pT), static_cast<const T*>(px),       \
                 static_cast<const T*>(py), static_cast<const T*>(weights),  \
                 n_species, s4, n_pT * n_phi, n_phi, n_nodes, rp, n_split,   \
                 sw, regulate, outflow, 0, static_cast<T*>(partial)};        \
    return launch_fixed<T>(a, n_cells, deg, n_pT, df_mode, dimension,        \
                           prefactor, out,                                   \
                           static_cast<cudaStream_t>(stream));               \
  }
IS3D_FEQMOD_ENTRY(is3d_feqmod_f32, float)
IS3D_FEQMOD_ENTRY(is3d_feqmod_f64, double)
#undef IS3D_FEQMOD_ENTRY

// chain_props<T> of (f64, dimension (0: the remap), chain, df, main
// switches, n_phi)
int is3d_feqmod_props(int f64, int dimension, int chain, int df, int main,
                      int n_phi, int* out) {
  return f64 ? chain_props<double>(dimension, chain, df, main, n_phi, out)
             : chain_props<float>(dimension, chain, df, main, n_phi, out);
}

// the 2+1D mT remap: remap_stage's tables (kernels/feqmod.py) of a group
// sorted by chain, offs the chains' parts; table (S, P, R, 2) =
// exp(-s eta_r), exp(+s eta_r); partial (n_partial = ranges of cells x
// chunks of nodes, S, P, F)
#define IS3D_FEQMOD_REMAP_ENTRY(NAME, T)                                      \
  int NAME(const void* mrow, const void* frow, const void* rnzw,             \
           const void* wj, const void* offs, int n_cells, const void* mass,  \
           const void* sign, const void* baryon, const void* deg,            \
           int n_species, const void* pT, int n_pT, const void* cos_phi,     \
           const void* sin_phi, int n_phi, const void* table,                \
           const void* nodes, const void* weights, int n_nodes, int df_mode, \
           int sw, int regulate, int outflow, double prefactor,              \
           double t_ref, int n_split, int n_partial, void* partial,          \
           void* out, void* stream) {                                        \
    RemapIn<T> a{static_cast<const T*>(mrow), static_cast<const T*>(frow),   \
                 static_cast<const T*>(rnzw), static_cast<const T*>(wj),     \
                 static_cast<const int*>(offs), static_cast<const T*>(mass), \
                 static_cast<const T*>(sign), static_cast<const T*>(baryon), \
                 static_cast<const T*>(pT), static_cast<const T*>(cos_phi),  \
                 static_cast<const T*>(sin_phi), static_cast<const T*>(table),\
                 static_cast<const T*>(nodes),                               \
                 static_cast<const T*>(weights), n_species, n_pT, n_phi,     \
                 n_nodes, n_split, sw, regulate, outflow, 0, (T)t_ref,       \
                 static_cast<T*>(partial)};                                  \
    return launch_remap<T>(a, n_cells, deg, df_mode, prefactor, n_partial,   \
                           out, static_cast<cudaStream_t>(stream));          \
  }
IS3D_FEQMOD_REMAP_ENTRY(is3d_feqmod_remap_f32, float)
IS3D_FEQMOD_REMAP_ENTRY(is3d_feqmod_remap_f64, double)
#undef IS3D_FEQMOD_REMAP_ENTRY

const char* is3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
