// Per-cell dN/dX reduction for Hopper (sm_90a), float32 and float64.
//
// Replaces the XLA body of is3d_tpu/kernels/dndx.py::_dndx_jit
// (_chunk_contribution(reduce=False) followed by _cell_dNdy), and realises
// the design of the Pallas probe experiments/probe_dndx_reduce.py::
// make_pallas_percell (P2): the per-cell (C, S) and per-node (S, R)
// accumulators stay on chip, and the reduction over momentum points is
// fused into the pass that produces the points.  One launch per canonical
// group computes, for a producer f(c, r, s, m),
//
//     per_cell[c, s] = scale_s * sum_r wR_r sum_m wM_m f(c, r, s, m)
//     dydeta[s, r]   = scale_s * sum_c sum_m wM_m f(c, r, s, m)
//
// Four producers instantiate the same reduction:
//   * EmissionProducer: p.dsigma f_eq (1 + df) (linear df 1-2) in the
//     folded form of folded.cuh at fixed rapidity nodes, 2+1D (Delta =
//     -eta_r, wR = eta weights) or 3+1D (Delta = y_r - eta_c, wR = 1);
//     scale_s = CF * degeneracy.  Inputs: the packed cells of
//     smooth_spectra.cu and three tables the wrapper prepacks
//     (kernels/dndx.py:emission_tables): species (S, 4) = m^2, sign,
//     baryon, 0; mT (S, n_pT, 2) = mT, mT^2; points (M, 8) = px, py, px^2,
//     py^2, px py, wM, 0, 0.
//   * FeqmodProducer: p.dsigma f of the modified-equilibrium df (df 3-4,
//     the third entry point of is3d_tpu/kernels/feqmod.py's
//     _chunk_contribution_feqmod, with reduce=False under
//     is3d_tpu/kernels/dndx.py:110-124) at fixed rapidity nodes: the
//     emission value of feqmod.cuh on the packed rows of feqmod.cu
//     (kernels/feqmod.py:pack_feqmod_cells) and its (cell, species) renorm
//     and validity tables; the tables of EmissionProducer.  Each thread
//     branches per (cell, node) between f_mod and the fallback, so a warp
//     whose cells differ runs both; the dN/dX kernel is a first version
//     here, its time against its bound in PERF.md.
//   * VahProducer: p.dsigma f of the anisotropic-hydro emission (modes
//     2-3, is3d_tpu/kernels/vah.py's _chunk_vah_spectra with reduce=False
//     under is3d_tpu/kernels/dndx.py:102-109) at fixed rapidity nodes: the
//     emission value of vah.cuh on the packed rows of vah.cu
//     (kernels/vah.py:pack_vah_cells); the residual chains a runtime
//     switch of the producer (one instantiation per dimension, each chain
//     set its own code path); the tables of EmissionProducer.
//   * ProbeProducer: P2's synthetic f = 1/(e^x + 1) (1 + 0.1 x) w(s, m),
//     x = a(c, r) b(s, m) + 0.3 a(c, r); scale_s = 1.
//
// What bounds it on this card: FP32 and SFU issue, not bytes (a group of
// 8192 cells is 1.2 MB of input and 10 MB of output against 1e11
// evaluations).  The formula needs 19 FP32 and 2 (df 1) or 3 (df 2) SFU
// operations per evaluation (kernels/smooth.py, FORMULA_OPS).  The first
// version of this kernel (a block per species, a thread per momentum
// point, nodes staged 8 at a time, a warp reduction per (cell, point slot,
// chunk)) issued 66 instructions per evaluation.
//
// Design: the transposed loop of P2, with the register blocking of
// smooth_spectra.cu.
//   * A thread owns one cell and YC rapidity nodes, for J species: the
//     cell's NS folded scalars and the 6 composites of each of its nodes
//     live in registers, formed once per (cell, node group, species group)
//     straight from the packed row (no shared-memory staging; the 16
//     threads of a cell read the same row).  It then walks the momentum
//     points, pT outer and phi inner (unrolled by two), whose constants
//     are the same for the whole block and come as broadcast 16-byte loads
//     from the point table, staged in shared memory where it fits (read
//     through L1 where not).  Per point it forms the per-(cell, point)
//     terms once for J x YC evaluations and px C2 + py C3 once per node
//     for J.
//   * t[j][y] = sum_m wM f is a register sum.  Both outputs derive from
//     it once per (cell, species group), so nothing but the evaluation is
//     in the point loop: per_cell adds sum_y wR_y t[j][y] over the threads
//     of the cell through shared memory in node order; dydeta adds t over
//     the block's cells in a thread-private shared-memory slot and, at the
//     end, over the block's threads of one node group in cell order.
//   * The cells are split over blockIdx.y; the wrapper picks the split
//     from the card's resident-block count so the waves fill
//     (kernels/dndx.py:cell_split), and fold_kernel adds the splits'
//     partials in order.  Every sum runs in a fixed order and nothing uses
//     atomics: two launches give identical bits.
//   * float32 takes ex2.approx on a pre-scaled argument and rcp.approx
//     (folded.cuh), which keep +inf -> 0; float64 keeps IEEE exp and
//     division and runs two blocks per SM.
// Dropped: the same blocking with a thread per momentum point (as in
// smooth_spectra.cu).  There t[j][y] is spread over the block's threads,
// so per_cell needs a block reduction per cell and dydeta either J x R
// register accumulators (192 for 48 nodes) or a reduction per (cell, node
// group); here both sums cost a few instructions per 9216 evaluations.
//
// Two more kernels turn per_cell into the (tau, r) histograms: the
// scatter-add of _dndx_jit (.at[].add) as a fixed-order segment sum over
// the (bin, cell) entries pre-sorted by bin (kernels/dndx.py:bin_plan).
// The segments are very uneven -- one bin (dN/dy) holds every cell, the
// tau and r bins hundreds, many (tau, r) bins none -- so the sum runs in
// two passes over fixed slices of SLICE entries: slice_kernel sums each
// slice's runs of one bin (a thread per (slice, species), species
// fastest, so a warp reads 128 contiguous bytes per entry, and a long bin
// spreads over the card), and bin_kernel adds, per (bin, species), the
// pieces of the bin's slices in order.  Bound by latency: the bytes (one
// read of per_cell) take a few microseconds; nothing uses atomics.

#include <cuda_runtime.h>

#include "feqmod.cuh"
#include "folded.cuh"
#include "vah.cuh"

namespace {

using namespace is3d;

constexpr int PBLOCK = 128;          // (cell, node group) threads per block
constexpr int J = 4;                 // species per thread
constexpr int YC = 3;                // nodes per thread
constexpr int PW = 8;                // values per row of the point table
constexpr int PHI_UNROLL = 2;        // phi steps per trip of the point loop
// the point table is staged in shared memory up to this size (4 resident
// blocks of it fit an SM); a larger one is read from global memory (L1)
constexpr size_t POINTS_SMEM_MAX = 32 * 1024;
constexpr int BLOCK = 256;           // threads of the fold and bin kernels
constexpr int WARPS = BLOCK / 32;
constexpr int SLICE = 64;            // binning entries per slice
constexpr int BIN_TILE = 32;         // bins and species per bin_kernel block

// ------------------------------------------------------------- producers

// A producer stages what its block shares into dynamic shared memory,
// gives the per-thread state of one (cell, node group) and adds, for the
// J species from s0 on, t[j][y] += sum_m wM_m f(c, r0 + y, s0 + j, m).
// Species and nodes past the end are clamped to the last real one; the
// kernel never stores them.

// PS: the point table is staged in shared memory
template <typename T, int DF, int DIM, bool PS>
struct EmissionProducer {
  const T* cells;                    // (n_cells, NF) packed rows
  const T* nodes;                    // (n_nodes)
  const T* species;                  // (n_species, 4) m^2, sign, baryon, 0
  const T* mt;                       // (n_species, n_pT, 2) mT, mT^2
  const T* points;                   // (M, 8) px, py, px^2, py^2, px py, wM
  int n_species, n_nodes, n_pT, n_phi;
  int regulate, outflow;

  size_t shared_bytes() const {
    return PS ? (size_t)n_pT * n_phi * PW * sizeof(T) : 0;
  }

  __device__ __forceinline__ void stage(T* sm) const {
    if (PS)
      for (int i = threadIdx.x; i < n_pT * n_phi * PW; i += PBLOCK)
        sm[i] = points[i];
  }

  struct CellState {
    T sc[NS];                        // folded scalars (folded.cuh)
    T k[YC][6];                      // A1, B1, C1', C2', C3', D1' per node
  };

  __device__ __forceinline__ void load(CellState& cs, int cell, int r0) const {
    const T* g = cells + (size_t)cell * NF;
    stage_scalars<T, DF>(g, cs.sc);
#pragma unroll
    for (int y = 0; y < YC; ++y) {
      const T node = nodes[min(r0 + y, n_nodes - 1)];
      T o[NK];
      stage_composites<T, DF>(g, DIM == 3 ? node - g[F_ETA] : -node, T(0), o);
#pragma unroll
      for (int i = 0; i < 6; ++i) cs.k[y][i] = o[i];
    }
  }

  __device__ __forceinline__ void sum_points(const CellState& cs, int s0,
                                             T (&t)[J][YC],
                                             const T* sm) const {
    using F = Fn<T>;
    const T dlo = regulate ? T(-1) : -F::inf();
    const T dhi = regulate ? T(1) : F::inf();
    const T plo = outflow ? T(0) : -F::inf();
    const T dax = cs.sc[S_DAX], day = cs.sc[S_DAY];
    const T nux = cs.sc[S_NUX], nuy = cs.sc[S_NUY];
    const T nvx = cs.sc[S_NVX], nvy = cs.sc[S_NVY];
    const T pxx = cs.sc[S_PXX], pyy = cs.sc[S_PYY], pxy = cs.sc[S_PXY];
    const T invT = cs.sc[S_INVT], kp = cs.sc[S_KP], kv = cs.sc[S_KV];
    // per (cell, species)
    T km2[J], b1[J], c3b[J], nbal[J], sgn[J], bar[J];
    const T* mts[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int s = min(s0 + j, n_species - 1);
      T m2, unused;
      F::ld4(species + (size_t)s * 4, m2, sgn[j], bar[j], unused);
      km2[j] = cs.sc[S_KM2] * m2;
      b1[j] = cs.sc[S_KB1] * bar[j];
      c3b[j] = cs.sc[S_KC3] * bar[j];
      nbal[j] = -cs.sc[S_ALPHA] * bar[j];
      mts[j] = mt + (size_t)s * n_pT * 2;
    }
    const T* q = PS ? sm : points;
    for (int ip = 0; ip < n_pT; ++ip) {
      T mT[J], mT2[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        mT[j] = mts[j][2 * ip];
        mT2[j] = mts[j][2 * ip + 1];
      }
#pragma unroll PHI_UNROLL
      for (int iphi = 0; iphi < n_phi; ++iphi, q += PW) {
        T px, py, px2, py2, pxpy, wm, u0, u1;
        F::ld4(q, px, py, px2, py2);
        F::ld4(q + 4, pxpy, wm, u0, u1);
        // per (cell, point)
        const T W1 = fma(dax, px, day * py);
        const T nW2 = fma(nux, px, nuy * py);
        const T nD2 = fma(nvx, px, nvy * py);
        const T C4 = fma(pxx, px2, fma(pyy, py2, pxy * pxpy));
        T c4s[J];
#pragma unroll
        for (int j = 0; j < J; ++j) c4s[j] = km2[j] + C4;
#pragma unroll
        for (int y = 0; y < YC; ++y) {
          const T A1 = cs.k[y][0], B1 = cs.k[y][1], C1 = cs.k[y][2];
          const T D1 = cs.k[y][5];
          const T c23 = fma(px, cs.k[y][3], py * cs.k[y][4]);
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const T pds = fma(mT[j], A1, W1);
            const T pdu = fma(mT[j], B1, nW2);
            const T pipp = fma(mT2[j], C1, fma(mT[j], c23, c4s[j]));
            const T Vp = fma(mT[j], D1, nD2);
            const T f = folded_f<T, DF>(pdu, pipp, Vp, invT, nbal[j], sgn[j],
                                        bar[j], kp, b1[j], kv, c3b[j], dlo,
                                        dhi);
            t[j][y] = fma(fmax(pds, plo) * wm, f, t[j][y]);
          }
        }
      }
    }
  }
};

// the modified-equilibrium df (feqmod.cuh); staged: the point table is in
// shared memory
template <typename T, int DIM>
struct FeqmodProducer {
  const T* cells;                    // (n_cells, NQ) packed rows
  const T* rn;                       // (n_cells, n_species) |renorm|
  const T* wcs;                      // (n_cells, n_species) validity
  const T* nodes;                    // (n_nodes)
  const T* species;                  // (n_species, 4) m^2, sign, baryon, 0
  const T* mt;                       // (n_species, n_pT, 2) mT, mT^2
  const T* points;                   // (M, 8) px, py, px^2, py^2, px py, wM
  int n_species, n_nodes, n_pT, n_phi;
  int df_mode, sw, regulate, outflow, staged;

  size_t shared_bytes() const {
    return staged ? (size_t)n_pT * n_phi * PW * sizeof(T) : 0;
  }

  __device__ __forceinline__ void stage(T* sm) const {
    if (staged)
      for (int i = threadIdx.x; i < n_pT * n_phi * PW; i += PBLOCK)
        sm[i] = points[i];
  }

  struct CellState {
    int cell;
    T k[YC][NKQ];                    // feqmod_node's values per node
  };

  __device__ __forceinline__ void load(CellState& cs, int cell, int r0) const {
    cs.cell = cell;
    const T* g = cells + (size_t)cell * NQ;
#pragma unroll
    for (int y = 0; y < YC; ++y)
      feqmod_node<T, DIM>(g, nodes[min(r0 + y, n_nodes - 1)], T(1), cs.k[y]);
  }

  __device__ __forceinline__ void sum_points(const CellState& cs, int s0,
                                             T (&t)[J][YC],
                                             const T* sm) const {
    using F = Fn<T>;
    const T L = F::SCALE;
    const T* g = cells + (size_t)cs.cell * NQ;
    const bool bd = g[Q_BD] != T(0);
    const bool narrow = feqmod_narrow<T, DIM>(g);
    const T dax = g[Q_DAX], day = g[Q_DAY];
    const T ux = g[Q_UX], uy = g[Q_UY], vx = g[Q_VX], vy = g[Q_VY];
    const T pxx = g[Q_PIXX], pyy = g[Q_PIYY], pxy2 = T(2) * g[Q_PIXY];
    const T invTmL = L * g[Q_INVTM];
    const FbCoef<T> k = fb_coef(g);
    // per (cell, species)
    T m2[J], sgn[J], bar[J], nbm[J], rnj[J], wj[J];
    const T* mts[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int s = min(s0 + j, n_species - 1);
      T unused;
      F::ld4(species + (size_t)s * 4, m2[j], sgn[j], bar[j], unused);
      nbm[j] = -L * g[Q_ABM] * bar[j];
      rnj[j] = rn[(size_t)cs.cell * n_species + s];
      wj[j] = wcs[(size_t)cs.cell * n_species + s];
      mts[j] = mt + (size_t)s * n_pT * 2;
    }
    bool fb[YC];
#pragma unroll
    for (int y = 0; y < YC; ++y) fb[y] = bd || (narrow && cs.k[y][11] != T(0));
    const T* q = staged ? sm : points;
    for (int ip = 0; ip < n_pT; ++ip) {
      T mT[J], mT2[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        mT[j] = mts[j][2 * ip];
        mT2[j] = mts[j][2 * ip + 1];
      }
      for (int iphi = 0; iphi < n_phi; ++iphi, q += PW) {
        T px, py, px2, py2, pxpy, wm, u0, u1;
        F::ld4(q, px, py, px2, py2);
        F::ld4(q + 4, pxpy, wm, u0, u1);
        // per (cell, point)
        const T W1 = fma(dax, px, day * py);
        T gam[3];
#pragma unroll
        for (int k3 = 0; k3 < 3; ++k3)
          gam[k3] = fma(g[Q_GX0 + k3], px, g[Q_GY0 + k3] * py);
#pragma unroll
        for (int y = 0; y < YC; ++y) {
          const T* kk = cs.k[y];
          if (!fb[y]) {
#pragma unroll
            for (int j = 0; j < J; ++j) {
              const T x2 = x_squared(mT[j], kk + 1, gam);
              const T f = mod_value(x2, m2[j], invTmL, nbm[j], sgn[j],
                                    rnj[j]);
              const T v = emit_mod(fma(mT[j], kk[0], W1), f, outflow)
                          * wj[j];
              t[j][y] = fma(v, wm, t[j][y]);
            }
          } else {
            const T nW2 = -fma(ux, px, uy * py);
            const T nD2 = -fma(vx, px, vy * py);
            const T C4 = fma(pxx, px2, fma(pyy, py2, pxy2 * pxpy));
            const T c23 = fma(px, kk[7], py * kk[8]);
#pragma unroll
            for (int j = 0; j < J; ++j) {
              const T pdu = fma(mT[j], kk[5], nW2);
              const T pipp = fma(mT2[j], kk[6], fma(mT[j], c23, C4));
              const T Vp = fma(mT[j], kk[9], nD2);
              const T f = fallback_value(df_mode, sw, pdu, pipp, Vp, m2[j],
                                         sgn[j], bar[j], k, regulate);
              const T v = emit(fma(mT[j], kk[4], W1), f, outflow) * wj[j];
              t[j][y] = fma(v, wm, t[j][y]);
            }
          }
        }
      }
    }
  }
};

// the anisotropic-hydro emission (vah.cuh); staged: the point table is in
// shared memory
template <typename T, int DIM>
struct VahProducer {
  const T* cells;                    // (n_cells, NV) packed rows
  const T* nodes;                    // (n_nodes)
  const T* species;                  // (n_species, 4) m^2, sign, baryon, 0
  const T* mt;                       // (n_species, n_pT, 2) mT, mT^2
  const T* points;                   // (M, 8) px, py, px^2, py^2, px py, wM
  int n_species, n_nodes, n_pT, n_phi;
  int sw, regulate, outflow, staged;

  size_t shared_bytes() const {
    return staged ? (size_t)n_pT * n_phi * PW * sizeof(T) : 0;
  }

  __device__ __forceinline__ void stage(T* sm) const {
    if (staged)
      for (int i = threadIdx.x; i < n_pT * n_phi * PW; i += PBLOCK)
        sm[i] = points[i];
  }

  struct CellState {
    int cell;
    T k[YC][NKV];                    // vah_node's values per node
  };

  __device__ __forceinline__ void load(CellState& cs, int cell, int r0) const {
    cs.cell = cell;
    const T* g = cells + (size_t)cell * NV;
#pragma unroll
    for (int y = 0; y < YC; ++y) {
      const T node = nodes[min(r0 + y, n_nodes - 1)];
      vah_node<T>(g, DIM == 3 ? node - g[V_ETA] : -node, T(1), cs.k[y]);
    }
  }

  template <int SW>
  __device__ __forceinline__ void sum_sw(const CellState& cs, int s0,
                                         T (&t)[J][YC], const T* sm) const {
    using F = Fn<T>;
    const T* g = cells + (size_t)cs.cell * NV;
    const VahCoef<T> k = vah_coef<T>(g);
    const T dax = g[V_DAX], day = g[V_DAY], ux = g[V_UX], uy = g[V_UY];
    // per (cell, species)
    T m2[J], sgn[J];
    const T* mts[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int s = min(s0 + j, n_species - 1);
      T bar, unused;
      F::ld4(species + (size_t)s * 4, m2[j], sgn[j], bar, unused);
      mts[j] = mt + (size_t)s * n_pT * 2;
    }
    const T* q = staged ? sm : points;
    for (int ip = 0; ip < n_pT; ++ip) {
      T mT[J], mT2[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        mT[j] = mts[j][2 * ip];
        mT2[j] = mts[j][2 * ip + 1];
      }
      for (int iphi = 0; iphi < n_phi; ++iphi, q += PW) {
        T px, py, px2, py2, pxpy, wm, u0, u1;
        F::ld4(q, px, py, px2, py2);
        F::ld4(q + 4, pxpy, wm, u0, u1);
        // per (cell, point)
        const T W1 = fma(dax, px, day * py);
        const T nW2 = -fma(ux, px, uy * py);
        T C4 = T(0), nWW = T(0);
        if (SW & VSW_SHEAR) {
          C4 = fma(g[V_KPIXX], px2,
                   fma(g[V_KPIYY], py2, T(2) * g[V_KPIXY] * pxpy));
          nWW = -fma(g[V_WX], px, g[V_WY] * py);
        }
#pragma unroll
        for (int y = 0; y < YC; ++y) {
          const T* kk = cs.k[y];
          const T c23 = (SW & VSW_SHEAR) ? fma(px, kk[5], py * kk[6]) : T(0);
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const T v = vah_point<T, SW>(kk, mT[j], mT2[j], m2[j], sgn[j], W1,
                                         nW2, C4, nWW, c23, k, regulate,
                                         outflow);
            t[j][y] = fma(v, wm, t[j][y]);
          }
        }
      }
    }
  }

  __device__ __forceinline__ void sum_points(const CellState& cs, int s0,
                                             T (&t)[J][YC],
                                             const T* sm) const {
    switch (sw) {
      case 0: sum_sw<0>(cs, s0, t, sm); break;
      case 1: sum_sw<1>(cs, s0, t, sm); break;
      case 2: sum_sw<2>(cs, s0, t, sm); break;
      default: sum_sw<3>(cs, s0, t, sm); break;
    }
  }
};

template <typename T>
struct ProbeProducer {
  const T* a;                        // (n_cells, n_nodes)
  const T* b;                        // (n_species, M)
  const T* w;                        // (n_species, M)
  const T* wM;                       // (M)
  int n_species, n_nodes, M;

  size_t shared_bytes() const { return 0; }

  __device__ __forceinline__ void stage(T*) const {}

  struct CellState {
    T xa[YC], x0[YC];                // x = xa b + x0, scaled for the exp
    T ha[YC], h0[YC];                // 1 + 0.1 x = ha b + h0
  };

  __device__ __forceinline__ void load(CellState& cs, int cell, int r0) const {
#pragma unroll
    for (int y = 0; y < YC; ++y) {
      const T av = a[(size_t)cell * n_nodes + min(r0 + y, n_nodes - 1)];
      cs.xa[y] = Fn<T>::SCALE * av;
      cs.x0[y] = Fn<T>::SCALE * (T(0.3) * av);
      cs.ha[y] = T(0.1) * av;
      cs.h0[y] = T(1) + T(0.1) * (T(0.3) * av);
    }
  }

  __device__ __forceinline__ void sum_points(const CellState& cs, int s0,
                                             T (&t)[J][YC],
                                             const T*) const {
    using F = Fn<T>;
    const T* bs[J];
    const T* ws[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const size_t row = (size_t)min(s0 + j, n_species - 1) * M;
      bs[j] = b + row;
      ws[j] = w + row;
    }
#pragma unroll 4
    for (int m = 0; m < M; ++m) {
      const T wm = wM[m];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const T bv = bs[j][m];
        const T ww = ws[j][m] * wm;
#pragma unroll
        for (int y = 0; y < YC; ++y) {
          const T f = F::rcp(F::exp_scaled(fma(cs.xa[y], bv, cs.x0[y])) + T(1));
          t[j][y] = fma(f * fma(cs.ha[y], bv, cs.h0[y]), ww, t[j][y]);
        }
      }
    }
  }
};

// ------------------------------------------------------------- kernels

// grid (species groups of J, n_split); thread tid owns node group tid % NG
// (NG = ceil(n_nodes / YC)) of cell tid / NG of each batch of CB = PBLOCK /
// NG cells; partial (n_split, n_species, n_nodes), unscaled
template <typename T, typename Prod>
__global__ void __launch_bounds__(PBLOCK, 16 / sizeof(T))
percell_kernel(Prod prod, int n_cells, int cells_per_split, int n_species,
               int n_nodes, const T* __restrict__ wR,
               const T* __restrict__ deg, T prefactor,
               T* __restrict__ per_cell, T* __restrict__ partial) {
  // pcs: each thread's per-cell sums; dys: each thread's running sums
  // over its cells, slot (j, y) of thread tid at dys[(j YC + y) PBLOCK +
  // tid], re-read at the end as the block's (cell slot, node group) table
  __shared__ T pcs[PBLOCK * J];
  __shared__ T dys[J * YC * PBLOCK];
  extern __shared__ double4 dyn_d4[];
  T* sm = reinterpret_cast<T*>(dyn_d4);
  prod.stage(sm);
  __syncthreads();

  const int tid = threadIdx.x;
  const int NG = (n_nodes + YC - 1) / YC;
  const int CB = PBLOCK / NG;
  const int g = tid % NG;
  const int cb = tid / NG;
  const int r0 = g * YC;
  const int s0 = blockIdx.x * J;
  const int cbeg = blockIdx.y * cells_per_split;
  const int cend = min(n_cells, cbeg + cells_per_split);

  T wr[YC];
#pragma unroll
  for (int y = 0; y < YC; ++y) wr[y] = r0 + y < n_nodes ? wR[r0 + y] : T(0);
#pragma unroll
  for (int i = 0; i < J * YC; ++i) dys[i * PBLOCK + tid] = T(0);

  for (int c0 = cbeg; c0 < cend; c0 += CB) {
    const int c = c0 + cb;
    const bool live = cb < CB && c < cend;
    typename Prod::CellState cs;
    prod.load(cs, live ? c : cbeg, r0);
    T t[J][YC];
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int y = 0; y < YC; ++y) t[j][y] = T(0);
    prod.sum_points(cs, s0, t, sm);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      T pc = T(0);
#pragma unroll
      for (int y = 0; y < YC; ++y) {
        const T v = live ? t[j][y] : T(0);
        pc = fma(wr[y], v, pc);
        dys[(j * YC + y) * PBLOCK + tid] += v;
      }
      pcs[tid * J + j] = pc;
    }
    __syncthreads();
    for (int i = tid; i < CB * J; i += PBLOCK) {
      const int b = i / J;                          // cell slot of the batch
      const int j = i - b * J;
      if (c0 + b < cend && s0 + j < n_species) {
        T v = T(0);
        for (int k = 0; k < NG; ++k) v += pcs[(b * NG + k) * J + j];
        const T scale = deg != nullptr ? prefactor * deg[s0 + j] : prefactor;
        per_cell[(size_t)(c0 + b) * n_species + s0 + j] = scale * v;
      }
    }
    __syncthreads();                                // pcs free again
  }
  __syncthreads();
  for (int i = tid; i < NG * J * YC; i += PBLOCK) {
    const int k = i / (J * YC);                     // node group
    const int jy = i - k * (J * YC);
    const int j = jy / YC;
    const int r = k * YC + jy - j * YC;
    if (r >= n_nodes || s0 + j >= n_species) continue;
    T v = T(0);
    for (int b = 0; b < CB; ++b) v += dys[jy * PBLOCK + b * NG + k];
    partial[((size_t)blockIdx.y * n_species + s0 + j) * n_nodes + r] = v;
  }
}

// dydeta[s, r] = scale_s * sum over splits (in order) of partial
template <typename T>
__global__ void __launch_bounds__(BLOCK)
fold_kernel(const T* __restrict__ partial, int n_split, int n_species,
            int n_nodes, const T* __restrict__ deg, T prefactor,
            T* __restrict__ dydeta) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const int n = n_species * n_nodes;
  if (i >= n) return;
  T v = T(0);
  for (int k = 0; k < n_split; ++k) v += partial[(size_t)k * n + i];
  const int s = i / n_nodes;
  dydeta[i] = (deg != nullptr ? prefactor * deg[s] : prefactor) * v;
}

// The entries [j SLICE, (j + 1) SLICE) of slice j fall into runs of one
// bin each, summed over their entries in ascending order: the first run's
// sum goes to piece row j, every later run's (it starts its bin b) to row
// n_slices + b, so bin_kernel reads a bin's slices as consecutive rows.
// Loads come in batches to keep them in flight.
template <typename T>
__global__ void __launch_bounds__(BLOCK)
slice_kernel(const T* __restrict__ per_cell, int n_species,
             const int* __restrict__ cell, const long long* __restrict__ key,
             int n_entries, int n_slices, T* __restrict__ piece) {
  constexpr int BATCH = 16;
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= (long long)n_slices * n_species) return;
  const int j = (int)(i / n_species);
  const int s = (int)(i - (long long)j * n_species);
  const int k0 = j * SLICE;
  const int k1 = min(k0 + SLICE, n_entries);
  T v = T(0);
  long long row = j;
  long long prev = key[k0];
  for (int b = k0; b < k1; b += BATCH) {
    T val[BATCH];
    long long kb[BATCH];
#pragma unroll
    for (int t = 0; t < BATCH; ++t) {
      const int k = min(b + t, k1 - 1);
      val[t] = per_cell[(size_t)cell[k] * n_species + s];
      kb[t] = key[k];
    }
#pragma unroll
    for (int t = 0; t < BATCH; ++t) {
      if (b + t < k1) {
        if (kb[t] != prev) {                        // a new run starts here
          piece[(size_t)row * n_species + s] = v;
          v = T(0);
          row = n_slices + kb[t];
          prev = kb[t];
        }
        v += val[t];
      }
    }
  }
  piece[(size_t)row * n_species + s] = v;
}

// hist[s, b] = sum over k in [start[b], start[b+1]) of per_cell[cell[k], s]:
// the piece of b's first run, then the first-run pieces of the slices that
// start inside b, in order.  A block owns BIN_TILE bins x BIN_TILE
// species: lanes run over species to read, the tile is transposed in
// shared memory, and lanes run over bins to write.
template <typename T>
__global__ void __launch_bounds__(BLOCK)
bin_kernel(int n_species, const int* __restrict__ start, int n_bins,
           int n_slices, const T* __restrict__ piece, T* __restrict__ hist) {
  __shared__ T tile[BIN_TILE][BIN_TILE + 1];        // [species][bin]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = blockIdx.x * BIN_TILE;
  const int s0 = blockIdx.y * BIN_TILE;
  const int s = s0 + lane;
  // unrolled over the warp's bins, so their loads overlap
#pragma unroll
  for (int q = 0; q < BIN_TILE / WARPS; ++q) {
    const int bb = warp + q * WARPS;
    const int b = b0 + bb;
    T v = T(0);
    if (b < n_bins && s < n_species) {
      const int k0 = start[b];
      const int k1 = start[b + 1];
      if (k0 < k1) {
        const int j0 = k0 / SLICE;
        const size_t head = k0 == j0 * SLICE ? (size_t)j0
                                             : (size_t)n_slices + b;
        v = piece[head * n_species + s];
        // the slices that start inside b, BATCH loads in flight at a time
        // (a plain loop issues each load after the previous add)
        constexpr int BATCH = 16;
        const int j1 = (k1 + SLICE - 1) / SLICE;    // slices j < j1 start in b
        int j = j0 + 1;
        for (; j + BATCH <= j1; j += BATCH) {
          T x[BATCH];
#pragma unroll
          for (int t = 0; t < BATCH; ++t)
            x[t] = piece[(size_t)(j + t) * n_species + s];
#pragma unroll
          for (int t = 0; t < BATCH; ++t) v += x[t];
        }
        for (; j < j1; ++j) v += piece[(size_t)j * n_species + s];
      }
    }
    tile[lane][bb] = v;
  }
  __syncthreads();
  for (int ss = warp; ss < BIN_TILE; ss += WARPS) {
    const int b = b0 + lane;
    if (b < n_bins && s0 + ss < n_species)
      hist[(size_t)(s0 + ss) * n_bins + b] = tile[ss][lane];
  }
}

// ------------------------------------------------------------- launchers

// resident blocks of percell_kernel<T, Prod> on the current card (SMs x
// blocks per SM), or minus a CUDA error code
template <typename T, typename Prod>
int percell_slots(size_t shared_bytes) {
  int dev = 0, n_sm = 0, per_sm = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc == 0)
    rc = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                     dev);
  if (rc == 0)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, percell_kernel<T, Prod>, PBLOCK, shared_bytes);
  if (rc != 0) return -rc;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  return n_sm * per_sm;
}

template <typename T, typename Prod>
int launch_percell(const Prod& prod, int n_cells, int cells_per_split,
                   int n_species, int n_nodes, const void* wR_v,
                   const void* deg_v, double prefactor, void* per_cell_v,
                   void* dydeta_v, void* partial_v, void* stream_v) {
  if (n_cells < 1 || n_species < 1 || n_nodes < 1 ||
      n_nodes > PBLOCK * YC || cells_per_split < 1)
    return cudaErrorInvalidValue;
  const int cb = PBLOCK / ((n_nodes + YC - 1) / YC);
  const long long n_split =
      ((long long)n_cells + cells_per_split - 1) / cells_per_split;
  // a split of whole batches, so no batch straddles two blocks
  if ((n_split > 1 && cells_per_split % cb != 0) || n_split > 65535 ||
      n_species > 0x7fffffff / n_nodes)
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  const T* deg = static_cast<const T*>(deg_v);
  T* partial = static_cast<T*>(partial_v);
  percell_kernel<T, Prod>
      <<<dim3((unsigned)((n_species + J - 1) / J), (unsigned)n_split), PBLOCK,
         prod.shared_bytes(), stream>>>(prod, n_cells, cells_per_split,
                                        n_species, n_nodes,
                      static_cast<const T*>(wR_v), deg, (T)prefactor,
                      static_cast<T*>(per_cell_v), partial);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int n = n_species * n_nodes;
  fold_kernel<T><<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(
      partial, (int)n_split, n_species, n_nodes, deg, (T)prefactor,
      static_cast<T*>(dydeta_v));
  return (int)cudaGetLastError();
}

template <typename T>
size_t point_table_bytes(int n_pT, int n_phi) {
  return (size_t)n_pT * n_phi * PW * sizeof(T);
}

// IS3D_EMISSION(DF, DIM, PS) runs once with the instantiation of the
// flags; the point table goes to shared memory where it fits
#define IS3D_DISPATCH_PS(DF_, DIM_)                                           \
  {                                                                          \
    if (staged) IS3D_EMISSION(DF_, DIM_, true)                               \
    else IS3D_EMISSION(DF_, DIM_, false)                                     \
  }
#define IS3D_DISPATCH(df_mode, dimension, n_pT, n_phi)                        \
  const bool staged = point_table_bytes<T>(n_pT, n_phi) <= POINTS_SMEM_MAX;  \
  if (dimension == 3) {                                                      \
    if (df_mode == 1) IS3D_DISPATCH_PS(1, 3) else IS3D_DISPATCH_PS(2, 3)     \
  } else {                                                                   \
    if (df_mode == 1) IS3D_DISPATCH_PS(1, 2) else IS3D_DISPATCH_PS(2, 2)     \
  }

bool emission_shape_ok(int df_mode, int dimension, int n_pT, int n_phi) {
  return (df_mode == 1 || df_mode == 2) &&
         (dimension == 2 || dimension == 3) && n_pT >= 1 && n_phi >= 1 &&
         n_pT <= 0x7fffffff / PW / n_phi;
}

template <typename T>
int dndx_slots(int df_mode, int dimension, int n_pT, int n_phi) {
  if (!emission_shape_ok(df_mode, dimension, n_pT, n_phi))
    return -(int)cudaErrorInvalidValue;
#define IS3D_EMISSION(DF_, DIM_, PS_)                                         \
  return percell_slots<T, EmissionProducer<T, DF_, DIM_, PS_>>(              \
      PS_ ? point_table_bytes<T>(n_pT, n_phi) : 0);
  IS3D_DISPATCH(df_mode, dimension, n_pT, n_phi)
#undef IS3D_EMISSION
}

template <typename T>
int launch_dndx(const void* cells, int n_cells, int nf, const void* species,
                const void* deg, int n_species, const void* mt,
                const void* points, int n_pT, int n_phi, const void* nodes,
                const void* wR, int n_nodes, int df_mode, int dimension,
                int regulate, int outflow, double prefactor,
                int cells_per_split, void* per_cell, void* dydeta,
                void* partial, void* stream) {
  if (nf != NF || !emission_shape_ok(df_mode, dimension, n_pT, n_phi))
    return cudaErrorInvalidValue;
#define IS3D_EMISSION(DF_, DIM_, PS_)                                         \
  {                                                                          \
    EmissionProducer<T, DF_, DIM_, PS_> prod{                                \
        static_cast<const T*>(cells), static_cast<const T*>(nodes),          \
        static_cast<const T*>(species), static_cast<const T*>(mt),           \
        static_cast<const T*>(points), n_species, n_nodes, n_pT, n_phi,      \
        regulate, outflow};                                                  \
    return launch_percell<T>(prod, n_cells, cells_per_split, n_species,      \
                             n_nodes, wR, deg, prefactor, per_cell, dydeta,  \
                             partial, stream);                               \
  }
  IS3D_DISPATCH(df_mode, dimension, n_pT, n_phi)
#undef IS3D_EMISSION
}
#undef IS3D_DISPATCH
#undef IS3D_DISPATCH_PS

bool feqmod_shape_ok(int df_mode, int dimension, int n_pT, int n_phi) {
  return (df_mode == 3 || df_mode == 4) &&
         (dimension == 2 || dimension == 3) && n_pT >= 1 && n_phi >= 1 &&
         n_pT <= 0x7fffffff / PW / n_phi;
}

template <typename T>
int dndx_feqmod_slots(int df_mode, int dimension, int n_pT, int n_phi) {
  if (!feqmod_shape_ok(df_mode, dimension, n_pT, n_phi))
    return -(int)cudaErrorInvalidValue;
  const size_t bytes = point_table_bytes<T>(n_pT, n_phi);
  const size_t staged = bytes <= POINTS_SMEM_MAX ? bytes : 0;
  return dimension == 3
             ? percell_slots<T, FeqmodProducer<T, 3>>(staged)
             : percell_slots<T, FeqmodProducer<T, 2>>(staged);
}

template <typename T>
int launch_dndx_feqmod(const void* cells, int n_cells, int nq,
                       const void* rn, const void* wcs, const void* species,
                       const void* deg, int n_species, const void* mt,
                       const void* points, int n_pT, int n_phi,
                       const void* nodes, const void* wR, int n_nodes,
                       int df_mode, int dimension, int sw, int regulate,
                       int outflow, double prefactor, int cells_per_split,
                       void* per_cell, void* dydeta, void* partial,
                       void* stream) {
  if (nq != NQ || !feqmod_shape_ok(df_mode, dimension, n_pT, n_phi))
    return cudaErrorInvalidValue;
  const int staged = point_table_bytes<T>(n_pT, n_phi) <= POINTS_SMEM_MAX;
#define IS3D_FEQMOD(DIM_)                                                     \
  {                                                                          \
    FeqmodProducer<T, DIM_> prod{                                            \
        static_cast<const T*>(cells), static_cast<const T*>(rn),             \
        static_cast<const T*>(wcs), static_cast<const T*>(nodes),            \
        static_cast<const T*>(species), static_cast<const T*>(mt),           \
        static_cast<const T*>(points), n_species, n_nodes, n_pT, n_phi,      \
        df_mode, sw, regulate, outflow, staged};                             \
    return launch_percell<T>(prod, n_cells, cells_per_split, n_species,      \
                             n_nodes, wR, deg, prefactor, per_cell, dydeta,  \
                             partial, stream);                               \
  }
  if (dimension == 3) IS3D_FEQMOD(3) else IS3D_FEQMOD(2)
#undef IS3D_FEQMOD
}

bool vah_shape_ok(int dimension, int sw, int n_pT, int n_phi) {
  return (dimension == 2 || dimension == 3) && sw >= 0 && sw <= 3 &&
         n_pT >= 1 && n_phi >= 1 && n_pT <= 0x7fffffff / PW / n_phi;
}

template <typename T>
int dndx_vah_slots(int dimension, int sw, int n_pT, int n_phi) {
  if (!vah_shape_ok(dimension, sw, n_pT, n_phi))
    return -(int)cudaErrorInvalidValue;
  const size_t bytes = point_table_bytes<T>(n_pT, n_phi);
  const size_t staged = bytes <= POINTS_SMEM_MAX ? bytes : 0;
  return dimension == 3 ? percell_slots<T, VahProducer<T, 3>>(staged)
                        : percell_slots<T, VahProducer<T, 2>>(staged);
}

template <typename T>
int launch_dndx_vah(const void* cells, int n_cells, int nv,
                    const void* species, const void* deg, int n_species,
                    const void* mt, const void* points, int n_pT, int n_phi,
                    const void* nodes, const void* wR, int n_nodes,
                    int dimension, int sw, int regulate, int outflow,
                    double prefactor, int cells_per_split, void* per_cell,
                    void* dydeta, void* partial, void* stream) {
  if (nv != NV || !vah_shape_ok(dimension, sw, n_pT, n_phi))
    return cudaErrorInvalidValue;
  const int staged = point_table_bytes<T>(n_pT, n_phi) <= POINTS_SMEM_MAX;
#define IS3D_VAH(DIM_)                                                        \
  {                                                                          \
    VahProducer<T, DIM_> prod{                                               \
        static_cast<const T*>(cells), static_cast<const T*>(nodes),          \
        static_cast<const T*>(species), static_cast<const T*>(mt),           \
        static_cast<const T*>(points), n_species, n_nodes, n_pT, n_phi, sw,  \
        regulate, outflow, staged};                                          \
    return launch_percell<T>(prod, n_cells, cells_per_split, n_species,      \
                             n_nodes, wR, deg, prefactor, per_cell, dydeta,  \
                             partial, stream);                               \
  }
  if (dimension == 3) IS3D_VAH(3) else IS3D_VAH(2)
#undef IS3D_VAH
}

template <typename T>
int launch_probe(const void* a, int n_cells, int n_nodes, const void* b,
                 const void* w, int n_species, int M, const void* wM,
                 const void* wR, int cells_per_split, void* per_cell,
                 void* sr, void* partial, void* stream) {
  if (M < 1) return cudaErrorInvalidValue;
  ProbeProducer<T> prod{static_cast<const T*>(a), static_cast<const T*>(b),
                        static_cast<const T*>(w), static_cast<const T*>(wM),
                        n_species, n_nodes, M};
  return launch_percell<T>(prod, n_cells, cells_per_split, n_species,
                           n_nodes, wR, nullptr, 1.0, per_cell, sr, partial,
                           stream);
}

template <typename T>
int launch_bin(const void* per_cell_v, int n_species, const void* cell_v,
               const void* key_v, int n_entries, const void* start_v,
               int n_bins, void* piece_v, long long n_piece_rows,
               void* hist_v, void* stream_v) {
  if (n_species < 1 || n_bins < 1 || n_entries < 0)
    return cudaErrorInvalidValue;
  const long long n_slices = ((long long)n_entries + SLICE - 1) / SLICE;
  const long long n_part = n_slices * n_species;
  if (n_piece_rows < n_slices + n_bins ||
      (n_part + BLOCK - 1) / BLOCK > 0x7fffffffLL ||
      (n_species + BIN_TILE - 1) / BIN_TILE > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  T* piece = static_cast<T*>(piece_v);
  if (n_part > 0) {
    slice_kernel<T><<<(unsigned)((n_part + BLOCK - 1) / BLOCK), BLOCK, 0,
                      stream>>>(
        static_cast<const T*>(per_cell_v), n_species,
        static_cast<const int*>(cell_v), static_cast<const long long*>(key_v),
        n_entries, (int)n_slices, piece);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  const dim3 grid((unsigned)((n_bins + BIN_TILE - 1) / BIN_TILE),
                  (unsigned)((n_species + BIN_TILE - 1) / BIN_TILE));
  bin_kernel<T><<<grid, BLOCK, 0, stream>>>(
      n_species, static_cast<const int*>(start_v), n_bins, (int)n_slices,
      piece, static_cast<T*>(hist_v));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define IS3D_DNDX_ENTRY(NAME, T)                                              \
  int NAME(const void* cells, int n_cells, int nf, const void* species,      \
           const void* deg, int n_species, const void* mt,                   \
           const void* points, int n_pT, int n_phi, const void* nodes,       \
           const void* wR, int n_nodes, int df_mode, int dimension,          \
           int regulate, int outflow, double prefactor, int cells_per_split, \
           void* per_cell, void* dydeta, void* partial, void* stream) {      \
    return launch_dndx<T>(cells, n_cells, nf, species, deg, n_species, mt,   \
                          points, n_pT, n_phi, nodes, wR, n_nodes, df_mode,  \
                          dimension, regulate, outflow, prefactor,           \
                          cells_per_split, per_cell, dydeta, partial,        \
                          stream);                                           \
  }
IS3D_DNDX_ENTRY(is3d_dndx_f32, float)
IS3D_DNDX_ENTRY(is3d_dndx_f64, double)
#undef IS3D_DNDX_ENTRY

// the feqmod producer (df 3-4): rn, wcs (n_cells, n_species) beside the
// packed rows (n_cells, NQ) of kernels/feqmod.py:pack_feqmod_cells
#define IS3D_DNDX_FEQMOD_ENTRY(NAME, T)                                       \
  int NAME(const void* cells, int n_cells, int nq, const void* rn,           \
           const void* wcs, const void* species, const void* deg,            \
           int n_species, const void* mt, const void* points, int n_pT,      \
           int n_phi, const void* nodes, const void* wR, int n_nodes,        \
           int df_mode, int dimension, int sw, int regulate, int outflow,    \
           double prefactor, int cells_per_split, void* per_cell,            \
           void* dydeta, void* partial, void* stream) {                      \
    return launch_dndx_feqmod<T>(cells, n_cells, nq, rn, wcs, species, deg,  \
                                 n_species, mt, points, n_pT, n_phi, nodes,  \
                                 wR, n_nodes, df_mode, dimension, sw,        \
                                 regulate, outflow, prefactor,               \
                                 cells_per_split, per_cell, dydeta, partial, \
                                 stream);                                    \
  }
IS3D_DNDX_FEQMOD_ENTRY(is3d_dndx_feqmod_f32, float)
IS3D_DNDX_FEQMOD_ENTRY(is3d_dndx_feqmod_f64, double)
#undef IS3D_DNDX_FEQMOD_ENTRY

int is3d_dndx_feqmod_slots_f32(int df_mode, int dimension, int n_pT,
                               int n_phi) {
  return dndx_feqmod_slots<float>(df_mode, dimension, n_pT, n_phi);
}
int is3d_dndx_feqmod_slots_f64(int df_mode, int dimension, int n_pT,
                               int n_phi) {
  return dndx_feqmod_slots<double>(df_mode, dimension, n_pT, n_phi);
}

// the VAH producer (modes 2-3): the packed rows (n_cells, NV) of
// kernels/vah.py:pack_vah_cells; sw the residual chains (shear 1, bulk 2)
#define IS3D_DNDX_VAH_ENTRY(NAME, T)                                          \
  int NAME(const void* cells, int n_cells, int nv, const void* species,      \
           const void* deg, int n_species, const void* mt,                   \
           const void* points, int n_pT, int n_phi, const void* nodes,       \
           const void* wR, int n_nodes, int dimension, int sw, int regulate, \
           int outflow, double prefactor, int cells_per_split,               \
           void* per_cell, void* dydeta, void* partial, void* stream) {      \
    return launch_dndx_vah<T>(cells, n_cells, nv, species, deg, n_species,   \
                              mt, points, n_pT, n_phi, nodes, wR, n_nodes,   \
                              dimension, sw, regulate, outflow, prefactor,   \
                              cells_per_split, per_cell, dydeta, partial,    \
                              stream);                                       \
  }
IS3D_DNDX_VAH_ENTRY(is3d_dndx_vah_f32, float)
IS3D_DNDX_VAH_ENTRY(is3d_dndx_vah_f64, double)
#undef IS3D_DNDX_VAH_ENTRY

int is3d_dndx_vah_slots_f32(int dimension, int sw, int n_pT, int n_phi) {
  return dndx_vah_slots<float>(dimension, sw, n_pT, n_phi);
}
int is3d_dndx_vah_slots_f64(int dimension, int sw, int n_pT, int n_phi) {
  return dndx_vah_slots<double>(dimension, sw, n_pT, n_phi);
}

// resident blocks of the dN/dX kernel (probe: of its probe instantiation)
// on the current card, or minus a CUDA error code
int is3d_dndx_slots_f32(int df_mode, int dimension, int n_pT, int n_phi) {
  return dndx_slots<float>(df_mode, dimension, n_pT, n_phi);
}
int is3d_dndx_slots_f64(int df_mode, int dimension, int n_pT, int n_phi) {
  return dndx_slots<double>(df_mode, dimension, n_pT, n_phi);
}
int is3d_dndx_probe_slots_f32() {
  return percell_slots<float, ProbeProducer<float>>(0);
}
int is3d_dndx_probe_slots_f64() {
  return percell_slots<double, ProbeProducer<double>>(0);
}

#define IS3D_PROBE_ENTRY(NAME, T)                                             \
  int NAME(const void* a, int n_cells, int n_nodes, const void* b,           \
           const void* w, int n_species, int M, const void* wM,              \
           const void* wR, int cells_per_split, void* per_cell, void* sr,    \
           void* partial, void* stream) {                                    \
    return launch_probe<T>(a, n_cells, n_nodes, b, w, n_species, M, wM, wR,  \
                           cells_per_split, per_cell, sr, partial, stream);  \
  }
IS3D_PROBE_ENTRY(is3d_dndx_probe_f32, float)
IS3D_PROBE_ENTRY(is3d_dndx_probe_f64, double)
#undef IS3D_PROBE_ENTRY

#define IS3D_BIN_ENTRY(NAME, T)                                               \
  int NAME(const void* per_cell, int n_species, const void* cell,            \
           const void* key, int n_entries, const void* start, int n_bins,    \
           void* piece, long long n_piece_rows, void* hist, void* stream) {  \
    return launch_bin<T>(per_cell, n_species, cell, key, n_entries, start,   \
                         n_bins, piece, n_piece_rows, hist, stream);         \
  }
IS3D_BIN_ENTRY(is3d_dndx_bin_f32, float)
IS3D_BIN_ENTRY(is3d_dndx_bin_f64, double)
#undef IS3D_BIN_ENTRY

const char* is3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
