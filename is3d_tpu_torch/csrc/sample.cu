// The Monte-Carlo sampler's event batch (K7) and its Walker-alias tables
// (K7a) for Hopper (sm_90a), float32 and float64.
//
// K7, event_kernel, replaces the XLA hot loop of
// is3d_tpu/kernels/sample.py:_event_batch_packed_jit (:1099) with
// _one_event_lrf (:837) and _lab_kinematics (:787), viscous-hydro
// branches, df 1-4.  One thread a hadron slot of B events x n_cap slots:
// the slot < n test, three alias picks (cell group, cell in block,
// species), one gather of the cell's row (kernels/sample.py:pack_rows:
// the pre-keep fields of the df mode and the lab fields, row-major, each
// row 16-byte aligned; the thread finds a field through `Layout`), its own
// rejection loop of up to 256 rounds (round r of slot s has its own
// Philox counter, so no synchronisation), the feqmod rescale, the viscous
// and flux weights, the keep draw and the lab boost.  It writes per-slot
// keep / ok / rounds / sidx / cidx / lab px, py, pz, eta; the compaction to
// event-major packed arrays is a cumsum and an index copy in torch
// (kernels/sample.py:pack_batch).
//
// K7a, alias_kernel, replaces is3d_tpu/kernels/sample.py:_alias_build
// (:92), a K-step fori_loop of scatters over all rows: one thread a row
// runs the same two-pointer Vose pass over its row sorted descending
// (the sort is torch's), writing prob / alias straight at the original
// slots.  The same operations in the same order as the plain version
// (kernels/sample.py:alias_tables_plain): identical tables.
//
// Random numbers: philox.cuh, the counters of kernels/rng.py: a slot's own
// draws (SLOT_ROUND) and each rejection round's, keyed on (seed, global
// event, slot, round).  The plain version (kernels/sample.py:
// event_batch_plain) draws the same numbers.
//
// What bounds K7 on this card: per slot one random row of ~40 fields
// (5-6 32-byte sectors in float32) and three alias entries, against
// Philox's 20 multiply-highs a block on the integer pipe and ~6 special
// functions a rejection round; kernels/sample.py:sample_formula_ops counts
// both.  Design: no shared memory, no atomics, a uniform branch per df
// mode (template).  A
// slot's decisions depend on its own numbers only, so two launches give
// identical bits.  A first version: simple and right; its time against
// its bound is in PERF.md.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kMaxRounds = 256;
constexpr int kThreads = 128;

// the fields of a row, in the order of kernels/sample.py:ROW_FIELDS
enum Field {
  fT, fAlphaB, fBenth, fBulkPi, fPixx, fPixy, fPixz, fPiyy, fPiyz, fPizz,
  fVx, fVy, fVz, fDst, fDsx, fDsy, fDsz, fDsMax,
  fC0, fC1, fC2, fC3, fC4, fShear14, fBetapi, fF, fG, fBetabulk, fBetaV,
  fDeltaLambda, fDeltaZ, fTmod, fAlphaBmod, fBreakdown, fShearMod, fBulkMod,
  fDiffMod,
  fTau, fX, fY, fEta, fUt, fUx, fUy, fUn, fXt, fXx, fXy, fXn, fYx, fYy, fZt,
  fZn,
  kNumFields
};

struct Layout {
  int col[kNumFields];   // column of each field in a row, -1 if absent
};

template <typename T>
struct Args {
  const T* rows;
  int n_cells, nf;
  const T* grp_prob;
  const int* grp_alias;
  int n_groups;
  const T* blk_prob;
  const int* blk_alias;
  int cell_block;
  const T* sp_prob;
  const int* sp_alias;
  int n_species;
  const T* mass;
  const T* sign;
  const T* baryon;
  const int* counts;
  int n_events, n_cap;
  uint32_t ev0, k0, k1;
  T y_cut;
  bool* keep;
  bool* ok;
  int* rounds;
  int* sidx;
  int* cidx;
  T* px;
  T* py;
  T* pz;
  T* eta;
};

// a product never contracted into an FMA with a later add: the alias
// pick's frac(u K) must round as the plain version's u * K does
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

template <typename T>
__device__ __forceinline__ int alias_pick(const T* prob, const int* alias,
                                          int row, int K, T u) {
  const T x = mul_rn(u, static_cast<T>(K));
  const int b = min(static_cast<int>(x), K - 1);
  const T f = x - static_cast<T>(b);
  const size_t o = static_cast<size_t>(row) * K + b;
  return f < prob[o] ? b : alias[o];
}

template <typename T>
__device__ __forceinline__ T clampT(T v, T lo, T hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <typename T>
__device__ __forceinline__ T pion_weight_max(T x) {
  const T x2 = x * x, x3 = x2 * x, x4 = x3 * x;
  const T num = T(143206.88623164667) - T(95956.76008684626) * x
      - T(21341.937407169076) * x2 + T(14388.446116867359) * x3
      - T(6083.775788504437) * x4;
  const T den = T(-0.3541350577684533) + T(143218.69233952634) * x
      - T(24516.803600065778) * x2 - T(115811.59391199696) * x3
      + T(35814.36403387459) * x4;
  return T(1.00001) * num / den;
}

// the viscous weight (1 + df)/2 of the linear branch
// (kernels/sample.py:_df_weight)
template <typename T, int DF>
__device__ __forceinline__ T df_weight(const T* row, const Layout& L, T E, T px, T py, T pz,
                       T mass2, T sign, T baryon) {
  auto g = [&](int f) { return row[L.col[f]]; };
  const T pipp = px * px * g(fPixx) + py * py * g(fPiyy)
      + pz * pz * g(fPizz)
      + T(2) * (px * py * g(fPixy) + px * pz * g(fPixz)
                + py * pz * g(fPiyz));
  const T Vp = -(px * g(fVx) + py * g(fVy) + pz * g(fVz));
  const T Tc = g(fT), bulkPi = g(fBulkPi);
  T df_tot;
  if (DF == 1) {
    const T chem = baryon * g(fAlphaB);
    const T feqbar = T(1) - sign / (exp(E / Tc - chem) + sign);
    const T c0 = g(fC0), c2 = g(fC2);
    const T df_shear = pipp / g(fShear14);
    const T df_bulk = ((c0 - c2) * mass2
                       + (baryon * g(fC1) + (T(4) * c2 - c0) * E) * E)
        * bulkPi;
    const T df_diff = (baryon * g(fC3) + g(fC4) * E) * Vp;
    df_tot = feqbar * (df_shear + df_bulk + df_diff);
  } else if (DF == 2 || DF == 3) {
    const T chem = baryon * g(fAlphaB);
    const T feqbar = T(1) - sign / (exp(E / Tc - chem) + sign);
    const T df_shear = pipp / (T(2) * E * g(fBetapi) * Tc);
    const T df_bulk = (baryon * g(fG) + g(fF) * E / (Tc * Tc)
                       + (E - mass2 / E) / (T(3) * Tc))
        * bulkPi / g(fBetabulk);
    const T df_diff = (g(fBenth) - baryon / E) * Vp / g(fBetaV);
    df_tot = feqbar * (df_shear + df_bulk + df_diff);
  } else {
    const T feqbar = T(1) - sign / (exp(E / Tc) + sign);
    const T dl = g(fDeltaLambda);
    const T df_shear = feqbar * pipp / (T(2) * E * g(fBetapi) * Tc);
    const T df_bulk = g(fDeltaZ) - T(3) * dl
        + feqbar * dl * (E - mass2 / E) / Tc;
    df_tot = df_shear + df_bulk;
  }
  df_tot = clampT(df_tot, T(-1), T(1));
  return T(0.5) * (T(1) + df_tot);
}

template <typename T, int DIM, int DF>
__global__ void __launch_bounds__(kThreads)
    event_kernel(const Args<T> a, const Layout L) {
  const long long gid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (gid >= static_cast<long long>(a.n_events) * a.n_cap) return;
  const int e = static_cast<int>(gid / a.n_cap);
  const int slot = static_cast<int>(gid - static_cast<long long>(e) * a.n_cap);
  if (slot >= a.counts[e]) {
    a.keep[gid] = false;
    a.ok[gid] = false;
    a.rounds[gid] = 0;
    a.sidx[gid] = 0;
    a.cidx[gid] = 0;
    a.px[gid] = a.py[gid] = a.pz[gid] = a.eta[gid] = T(0);
    return;
  }
  const uint32_t ev = a.ev0 + static_cast<uint32_t>(e);
  const uint32_t s32 = static_cast<uint32_t>(slot);
  T u[5];
  is3d_rng::uniforms<T, 5>(u, s32, ev, is3d_rng::kSlotRound * 16,
                           is3d_rng::kSampleTag, a.k0, a.k1, false);

  const int grp = alias_pick(a.grp_prob, a.grp_alias, 0, a.n_groups, u[0]);
  const int within = alias_pick(a.blk_prob, a.blk_alias, grp, a.cell_block,
                                u[1]);
  const int cidx = min(grp * a.cell_block + within, a.n_cells - 1);
  const int sidx = alias_pick(a.sp_prob, a.sp_alias, cidx, a.n_species, u[2]);
  const T* row = a.rows + static_cast<size_t>(cidx) * a.nf;
  auto g = [&](int f) { return row[L.col[f]]; };
  const T mass = a.mass[sidx], sign = a.sign[sidx], baryon = a.baryon[sidx];
  const T mass2 = mass * mass;

  bool use_mod = false;
  T T_eff, chem;
  if (DF == 1 || DF == 2) {
    T_eff = g(fT);
    chem = baryon * g(fAlphaB);
  } else {
    use_mod = !(g(fBreakdown) > T(0.5));
    T_eff = use_mod ? g(fTmod) : g(fT);
    if (DF == 4)
      chem = use_mod ? T(0) : baryon * g(fAlphaB);
    else
      chem = baryon * (use_mod ? g(fAlphaBmod) : g(fAlphaB));
  }
  const T mbar = mass / T_eff;
  const T mbar2 = mbar * mbar;
  const bool light = mbar < T(1.008);
  const T weq_max = (mbar < T(0.8554) && sign == T(-1))
      ? pion_weight_max(mbar) : T(1);

  // rejection: the proposals of the reference's light (p^2 e^-p) and heavy
  // (k^j e^-k mixture) samplers (kernels/sample.py:_propose)
  T pbar = T(0), Ebar = T(1), phi = T(0), cost = T(0);
  bool accepted = false;
  int n_rounds = 0;
  for (int r = 0; r < kMaxRounds; ++r) {
    n_rounds = r + 1;
    T v[5];
    is3d_rng::uniforms<T, 5>(v, s32, ev, static_cast<uint32_t>(r) * 16,
                             is3d_rng::kSampleTag, a.k0, a.k1, true);
    const T l1 = log(v[0]), l2 = log(v[1]), l3 = log(v[2]);
    const T l12 = l1 + l2;
    T pb, Eb, ph, ct, w;
    if (light) {
      pb = -(l1 + l2 + l3);
      Eb = sqrt(pb * pb + mbar2);
      ph = l12 * l12 / (pb * pb);
      ct = (l1 - l2) / l12;
      w = exp(pb - Eb) / (T(1) + sign * exp(-Eb)) / weq_max;
    } else {
      const T w0 = mbar2, w1 = T(2) * mbar;
      const T tot = w0 + w1 + T(2);
      const T rr = v[3] * tot;
      const bool j1 = (rr >= w0) && (rr < w0 + w1);
      const bool j2 = rr >= (w0 + w1);
      const T kbar = j2 ? -(l1 + l2 + l3) : (j1 ? -l12 : -l1);
      ph = j2 ? l12 * l12 / (kbar * kbar) : (j1 ? -l1 / kbar : v[1]);
      ct = j2 ? (l1 - l2) / l12 : T(2) * v[2] - T(1);
      Eb = kbar + mbar;
      const T d = Eb * Eb - mbar2;
      pb = sqrt(d > T(0) ? d : T(0));
      const T ex = exp(Eb - chem);
      w = pb / Eb * ex / (ex + sign);
    }
    if (v[4] < w) {
      pbar = pb;
      Ebar = Eb;
      phi = T(6.283185307179586) * ph;
      cost = ct;
      accepted = true;
      break;
    }
  }

  const T s2 = T(1) - cost * cost;
  const T sint = sqrt(s2 > T(0) ? s2 : T(0));
  T E = Ebar * T_eff;
  const T p = pbar * T_eff;
  T px = p * sint * cos(phi);
  T py = p * sint * sin(phi);
  T pz = p * cost;

  if ((DF == 3 || DF == 4) && use_mod) {
    // feqmod momentum rescale p = A p_mod + shifts (reference :619-650)
    const T dm = g(fDiffMod) * (E * g(fBenth) + baryon);
    const T bm = T(1) + g(fBulkMod), sm = g(fShearMod);
    const T bx = bm * px + sm * (g(fPixx) * px + g(fPixy) * py
                                 + g(fPixz) * pz) + dm * g(fVx);
    const T by = bm * py + sm * (g(fPixy) * px + g(fPiyy) * py
                                 + g(fPiyz) * pz) + dm * g(fVy);
    const T bz = bm * pz + sm * (g(fPixz) * px + g(fPiyz) * py
                                 + g(fPizz) * pz) + dm * g(fVz);
    px = bx;
    py = by;
    pz = bz;
    E = sqrt(mass2 + px * px + py * py + pz * pz);
  }
  const T w_visc = use_mod ? T(1)
      : df_weight<T, DF>(row, L, E, px, py, pz, mass2, sign, baryon);
  const T flux = E * g(fDst) - px * g(fDsx) - py * g(fDsy) - pz * g(fDsz);
  const T w_flux = (flux > T(0) ? flux : T(0)) / (E * g(fDsMax));
  const bool keep = accepted && (u[3] < w_flux * w_visc);

  // lab boost (kernels/sample.py:_lab_kinematics)
  const T tau = g(fTau), ut = g(fUt), ux = g(fUx), uy = g(fUy), un = g(fUn);
  const T Xt = g(fXt), Xx = g(fXx), Xy = g(fXy), Xn = g(fXn);
  const T Yx = g(fYx), Yy = g(fYy), Zt = g(fZt), Zn = g(fZn);
  const T ptau = E * ut + px * Xt + pz * Zt;
  const T pxl = E * ux + px * Xx + py * Yx;
  const T pyl = E * uy + px * Xy + py * Yy;
  const T pn = E * un + px * Xn + pz * Zn;
  T pzl, eta;
  if (DIM == 2) {
    const T mT = sqrt(mass2 + pxl * pxl + pyl * pyl);
    const T yp = a.y_cut * (T(2) * u[4] - T(1));
    const T sinhy = sinh(yp);
    const T coshy = sqrt(T(1) + sinhy * sinhy);
    const T sinheta = (ptau * sinhy - tau * pn * coshy) / mT;
    eta = asinh(sinheta);
    pzl = mT * sinhy;
  } else {
    eta = g(fEta);
    pzl = tau * pn * cosh(eta) + ptau * sinh(eta);
  }
  a.keep[gid] = keep;
  a.ok[gid] = accepted;
  a.rounds[gid] = n_rounds;
  a.sidx[gid] = sidx;
  a.cidx[gid] = cidx;
  a.px[gid] = pxl;
  a.py[gid] = pyl;
  a.pz[gid] = pzl;
  a.eta[gid] = eta;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    alias_kernel(T* qs, const int* order, int R, int K, T* prob, int* alias) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  T* q = qs + static_cast<size_t>(r) * K;
  const int* o = order + static_cast<size_t>(r) * K;
  T* pr = prob + static_cast<size_t>(r) * K;
  int* al = alias + static_cast<size_t>(r) * K;
  int i = 0, j = K - 1;
  for (int step = 0; step < K; ++step) {
    const T qi = q[i];
    const bool last = i == j;
    const bool small = (qi < T(1)) && !last;
    const int ip1 = min(i + 1, K - 1);
    const T qj = q[j];
    const int pos = (last || small) ? i : j;
    const T pv = last ? T(1) : clampT(small ? qi : qj, T(0), T(1));
    const int aval = o[last ? i : (small ? ip1 : i)];
    const T uval = small ? q[ip1] - (T(1) - qi)
                         : (last ? qi : qi - (T(1) - qj));
    q[small ? ip1 : i] = uval;
    const int out = o[pos];
    pr[out] = pv;
    al[out] = aval;
    if (small || last)
      ++i;
    else
      --j;
  }
}

template <typename T, int DIM, int DF>
cudaError_t launch_events(const Args<T>& a, const Layout& L,
                          cudaStream_t stream) {
  const long long n = static_cast<long long>(a.n_events) * a.n_cap;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  if (blocks) event_kernel<T, DIM, DF><<<blocks, kThreads, 0, stream>>>(a, L);
  return cudaGetLastError();
}

template <typename T, int DIM>
cudaError_t dispatch_df(int df_mode, const Args<T>& a, const Layout& L,
                        cudaStream_t stream) {
  switch (df_mode) {
    case 1: return launch_events<T, DIM, 1>(a, L, stream);
    case 2: return launch_events<T, DIM, 2>(a, L, stream);
    case 3: return launch_events<T, DIM, 3>(a, L, stream);
    case 4: return launch_events<T, DIM, 4>(a, L, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int sample_events(const void* rows, int n_cells, int nf, const int* layout,
                  const void* grp_prob, const void* grp_alias, int n_groups,
                  const void* blk_prob, const void* blk_alias, int cell_block,
                  const void* sp_prob, const void* sp_alias, int n_species,
                  const void* mass, const void* sign, const void* baryon,
                  const void* counts, int n_events, int n_cap, long long ev0,
                  unsigned k0, unsigned k1, int dimension, int df_mode,
                  double y_cut, void* keep, void* ok,
                  void* rounds, void* sidx, void* cidx, void* px, void* py,
                  void* pz, void* eta, void* stream) {
  Layout L;
  for (int f = 0; f < kNumFields; ++f) L.col[f] = layout[f];
  Args<T> a{static_cast<const T*>(rows), n_cells, nf,
            static_cast<const T*>(grp_prob),
            static_cast<const int*>(grp_alias), n_groups,
            static_cast<const T*>(blk_prob),
            static_cast<const int*>(blk_alias), cell_block,
            static_cast<const T*>(sp_prob),
            static_cast<const int*>(sp_alias), n_species,
            static_cast<const T*>(mass), static_cast<const T*>(sign),
            static_cast<const T*>(baryon), static_cast<const int*>(counts),
            n_events, n_cap, static_cast<uint32_t>(ev0), k0, k1,
            static_cast<T>(y_cut), static_cast<bool*>(keep),
            static_cast<bool*>(ok), static_cast<int*>(rounds),
            static_cast<int*>(sidx), static_cast<int*>(cidx),
            static_cast<T*>(px), static_cast<T*>(py), static_cast<T*>(pz),
            static_cast<T*>(eta)};
  auto s = static_cast<cudaStream_t>(stream);
  if (dimension == 2) return dispatch_df<T, 2>(df_mode, a, L, s);
  if (dimension == 3) return dispatch_df<T, 3>(df_mode, a, L, s);
  return cudaErrorInvalidValue;
}

template <typename T>
int alias_build(void* qs, const void* order, int R, int K, void* prob,
                void* alias, void* stream) {
  const unsigned blocks = static_cast<unsigned>((R + kThreads - 1) / kThreads);
  if (blocks)
    alias_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<T*>(qs), static_cast<const int*>(order), R, K,
        static_cast<T*>(prob), static_cast<int*>(alias));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K7a: (prob, alias) of R rows of K sorted descending weights qs (scratch,
// overwritten) with their original indices; prob and alias come in as 1
// and 0
int is3d_alias_build_f32(void* qs, const void* order, int R, int K,
                         void* prob, void* alias, void* stream) {
  return alias_build<float>(qs, order, R, K, prob, alias, stream);
}
int is3d_alias_build_f64(void* qs, const void* order, int R, int K,
                         void* prob, void* alias, void* stream) {
  return alias_build<double>(qs, order, R, K, prob, alias, stream);
}

// K7: the slots of n_events x n_cap; `layout` is a host array of
// kNumFields columns (kernels/sample.py:pack_rows)
#define IS3D_SAMPLE_ENTRY(NAME, T)                                            \
  int NAME(const void* rows, int n_cells, int nf, const int* layout,         \
           const void* grp_prob, const void* grp_alias, int n_groups,        \
           const void* blk_prob, const void* blk_alias, int cell_block,      \
           const void* sp_prob, const void* sp_alias, int n_species,         \
           const void* mass, const void* sign, const void* baryon,           \
           const void* counts, int n_events, int n_cap, long long ev0,       \
           unsigned k0, unsigned k1, int dimension, int df_mode,             \
           double y_cut, void* keep, void* ok, void* rounds, void* sidx,     \
           void* cidx, void* px, void* py, void* pz, void* eta,              \
           void* stream) {                                                   \
    return sample_events<T>(rows, n_cells, nf, layout, grp_prob, grp_alias,  \
                            n_groups, blk_prob, blk_alias, cell_block,       \
                            sp_prob, sp_alias, n_species, mass, sign,        \
                            baryon, counts, n_events, n_cap, ev0, k0, k1,    \
                            dimension, df_mode, y_cut, keep, ok,             \
                            rounds, sidx, cidx, px, py, pz, eta, stream);    \
  }
IS3D_SAMPLE_ENTRY(is3d_sample_events_f32, float)
IS3D_SAMPLE_ENTRY(is3d_sample_events_f64, double)
#undef IS3D_SAMPLE_ENTRY

const char* is3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
