// The Monte-Carlo sampler's event batch (K7) for Hopper (sm_90a), float32
// and float64: the kernel template and its C entries, instantiated by
// four sources, one library each (one nvcc each, built in parallel):
//   sample.cu             viscous hydro (df 1-4), alias draws (and K7a)
//   sample_vah.cu         anisotropic hydro (modes 2-3), alias draws
//   sample_search.cu      viscous hydro, binary-search draws
//   sample_vah_search.cu  anisotropic hydro, binary-search draws
// Each includes this header and expands IS3D_SAMPLE_EVENT_ENTRIES(VAH,
// SEARCH): the same C entries in every library, over its instantiations
// (kernels/sample.py:_event_library picks the library by the run's
// surface and draws).
//
// event_kernel<T, DIM, DF, PACKED, SEARCH> replaces the XLA hot loop of
// is3d_tpu/kernels/sample.py:_event_batch_packed_jit (:1099) with
// _one_event_lrf (:837) and _lab_kinematics (:787).  DF is the df mode
// 1-4 on viscous-hydro surfaces, or kVah | shear | bulk << 1 on VAH
// surfaces (the residual-df chains as compile-time switches, as in
// vah.cu).  A block takes a tile of kTile (512) consecutive hadron slots
// of B events x n_cap in three phases:
//   1. setup, a thread a slot: the slot < n test; the cell and species
//      draws: alias picks (cell group, cell in block, species; each (prob,
//      alias) pair one 8-byte load, 16 in float64; the species table's
//      read streaming, evict first, so the rows stay in L2) or, with
//      SEARCH, is3d_tpu's binary searches (_one_event_lrf :862-876: the
//      cell by searchsorted(cum_dn, u lam, right) clipped to C - 1, the
//      species by S.bit_length() halvings of the cell's rowcum row,
//      _row_categorical :712); the proposal's inputs from the cell's row
//      (mbar, chem, sign, the pion weight bound) into shared memory, and
//      the list of the tile's valid slots;
//   2. rejection with lane refill: a lane proposes for its slot round by
//      round (up to 256; round r of slot s has its own Philox counter) and,
//      once the slot accepts or runs out of rounds, takes the next pending
//      slot of the tile (a warp-aggregated counter in shared memory), so a
//      warp no longer waits for its slowest lane slot by slot;
//   3. finalize, a thread a slot: the cell's row in 16-byte vector loads
//      (kernels/sample.py:pack_rows: a row starts 16-byte aligned and the
//      column of each field is fixed by the df mode, `col`), the feqmod
//      rescale (df 3-4) or the VAH stretch pz = a_L qz with its residual
//      14-moment weight (is3d_tpu/kernels/sample.py:946-975), the viscous
//      and flux weights, the keep draw and the lab boost.
// VAH samples q isotropically at T = Lambda with zero chemical potential:
// the same proposals, then f_abar = 1 - sign / (e^Ebar + sign) from the
// proposal's Ebar, the residual df (regulate_deltaf's clip, a runtime
// flag) and w_visc = clip((1 + df) / 2, 0, 1).
// Per-slot mode (PACKED = false) writes keep / ok / rounds / sidx / cidx /
// lab px, py, pz, eta for every slot: what the plain version
// (kernels/sample.py:event_batch_plain) is held to slot by slot.  Packed
// mode compacts the kept hadrons in the same launch, as JAX's function
// does: each tile counts its kept slots (ballots), takes its global offset
// by a single-pass decoupled look-back over the tiles before it
// (scan.cuh; integer and exact; tiles are numbered in the order blocks
// start, so every earlier tile is running or done), and writes the fields of
// kernels/sample.py:_pack_fields (f16 where _pack_f16 says) straight into
// the (cap,) arrays, event-major; hadrons past cap are dropped while the
// counts stay exact.  It adds the per-event kept counts and the ok and
// rounds totals with integer atomics: pack_batch's output, bit for bit.
//
// Random numbers: philox.cuh, the counters of kernels/rng.py: a slot's own
// draws (SLOT_ROUND) and each rejection round's, keyed on (seed, global
// event, slot, round).  The plain version draws the same numbers; the
// search draws read them as the alias draws do (u[0] the cell, u[2] the
// species).
//
// What bounds it on this card: the per-slot gathers (its row, in L2; the
// species table's (prob, alias) pair or the halvings of its rowcum row,
// 168 MB at the main shape, a 32-byte sector each) against Philox's
// multiply-highs and ~6 special functions a rejection round
// (kernels/sample.py:sample_formula_ops).  A slot's decisions depend on
// its own numbers only, so two launches give identical bits.  Each
// element of the design was kept on an A/B on the card
// (tools/ab_spectra.py --cases sample, PERF.md): lane refill, the 16-byte
// row loads, the pair in one load, the streaming species reads, tiles of
// 512 slots and the float32 register cap each won.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "philox.cuh"
#include "scan.cuh"

namespace {

using namespace is3d_scan;

constexpr int kMaxRounds = 256;
constexpr int kThreads = 128;                 // K7: threads a block
constexpr int kSlotsPerThread = 4;
constexpr int kTile = kThreads * kSlotsPerThread;  // slots a tile
constexpr int kWarps = kThreads / 32;
constexpr int kChunks = kTile / 32;           // 32-slot words of a tile
constexpr unsigned kFull = 0xffffffffu;
static_assert(kChunks <= 32, "one warp scans a tile's 32-slot words");

// DF of the VAH instantiations: kVah | shear | bulk << 1
constexpr int kVah = 8;

// the fields of a row, in the order of kernels/sample.py:ROW_FIELDS
enum Field {
  fT, fAlphaB, fBenth, fBulkPi, fPixx, fPixy, fPixz, fPiyy, fPiyz, fPizz,
  fVx, fVy, fVz, fDst, fDsx, fDsy, fDsz, fDsMax,
  fC0, fC1, fC2, fC3, fC4, fShear14, fBetapi, fF, fG, fBetabulk, fBetaV,
  fDeltaLambda, fDeltaZ, fTmod, fAlphaBmod, fBreakdown, fShearMod, fBulkMod,
  fDiffMod,
  fTau, fX, fY, fEta, fUt, fUx, fUy, fUn, fXt, fXx, fXy, fXn, fYx, fYy, fZt,
  fZn,
  // anisotropic hydro: Lambda, a_L, the residual-df coefficients c0..c4
  // and W in the LRF
  fLambda, fAL, fVc0, fVc1, fVc2, fVc3, fVc4, fWlx, fWly, fWlz,
  kNumFields
};

// a row's fields by df mode (kernels/sample.py:gather_fields): the common
// pre-keep fields fT..fDsMax, the df mode's, then the lab fields
// fTau..fZn, each group in enum order but df 3-4's (the df_index switch);
// VAH rows (vah_col): Lambda, a_L and dsigma, the shear chain's fields,
// the bulk chain's, then the lab fields (is3d_tpu's _pre_fields)
constexpr int kNCommon = fDsMax + 1;
constexpr int kNLab = fZn - fTau + 1;

__host__ __device__ constexpr bool is_vah(int DF) { return DF >= kVah; }

template <int DF>
__host__ __device__ constexpr int n_df_fields() {
  return DF == 1 ? 6 : DF == 2 ? 5 : DF == 3 ? 11 : 8;
}

// the position of f among the df mode's own fields, -1 if absent
template <int DF>
__host__ __device__ constexpr int df_index(Field f) {
  if (DF == 1) return (f >= fC0 && f <= fShear14) ? f - fC0 : -1;
  if (f >= fBetapi && f <= fBetaV && DF != 4) return f - fBetapi;
  if (DF == 3) return (f >= fTmod && f <= fDiffMod) ? 5 + (f - fTmod) : -1;
  if (DF == 4) {
    switch (f) {
      case fBetapi: return 0;
      case fDeltaLambda: return 1;
      case fDeltaZ: return 2;
      case fTmod: return 3;
      case fBreakdown: return 4;
      case fShearMod: return 5;
      case fBulkMod: return 6;
      case fDiffMod: return 7;
      default: return -1;
    }
  }
  return -1;
}

// the column of field f in a VAH row, -1 if absent
template <int DF>
__host__ __device__ constexpr int vah_col(Field f) {
  switch (f) {
    case fLambda: return 0;
    case fAL: return 1;
    case fDst: return 2;
    case fDsx: return 3;
    case fDsy: return 4;
    case fDsz: return 5;
    case fDsMax: return 6;
    default: break;
  }
  int n = 7;
  if (DF & 1) {
    switch (f) {
      case fVc3: return n;
      case fVc4: return n + 1;
      case fPixx: return n + 2;
      case fPixy: return n + 3;
      case fPixz: return n + 4;
      case fPiyy: return n + 5;
      case fPiyz: return n + 6;
      case fPizz: return n + 7;
      case fWlx: return n + 8;
      case fWly: return n + 9;
      case fWlz: return n + 10;
      default: break;
    }
    n += 11;
  }
  if (DF & 2) {
    switch (f) {
      case fBulkPi: return n;
      case fVc0: return n + 1;
      case fVc1: return n + 2;
      case fVc2: return n + 3;
      default: break;
    }
    n += 4;
  }
  return (f >= fTau && f <= fZn) ? n + (f - fTau) : -1;
}

// the column of field f in a row of df mode DF, -1 if absent
template <int DF>
__host__ __device__ constexpr int col(Field f) {
  if (is_vah(DF)) return vah_col<DF>(f);
  return f < kNCommon ? static_cast<int>(f)
       : df_index<DF>(f) >= 0 ? kNCommon + df_index<DF>(f)
       : (f >= fTau && f <= fZn) ? kNCommon + n_df_fields<DF>() + (f - fTau)
       : -1;
}
template <int DF>
__host__ __device__ constexpr int n_fields() {
  if (is_vah(DF))
    return 7 + ((DF & 1) ? 11 : 0) + ((DF & 2) ? 4 : 0) + kNLab;
  return kNCommon + n_df_fields<DF>() + kNLab;
}

// 16-byte vectors of a row
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
};

template <int K>
__device__ __forceinline__ float lane_of(const float4& v) {
  if constexpr (K == 0) return v.x;
  else if constexpr (K == 1) return v.y;
  else if constexpr (K == 2) return v.z;
  else return v.w;
}
template <int K>
__device__ __forceinline__ double lane_of(const double2& v) {
  if constexpr (K == 0) return v.x;
  else return v.y;
}

template <typename T>
__device__ __forceinline__ typename Vec<T>::type load_vec(const T* p, int v) {
  return __ldg(reinterpret_cast<const typename Vec<T>::type*>(p) + v);
}

// a whole row of df mode DF in registers, its fields by compile-time index
template <typename T, int DF>
struct Row {
  static constexpr int kN = Vec<T>::n;
  static constexpr int kV = (n_fields<DF>() + kN - 1) / kN;
  typename Vec<T>::type v[kV];
  __device__ __forceinline__ explicit Row(const T* row) {
#pragma unroll
    for (int i = 0; i < kV; ++i) v[i] = load_vec(row, i);
  }
  template <Field F>
  __device__ __forceinline__ T get() const {
    constexpr int c = col<DF>(F);
    static_assert(c >= 0, "field absent in this df mode");
    return lane_of<c % kN>(v[c / kN]);
  }
};

// one field of a row in device memory (its 16-byte vector)
template <typename T, int DF, Field F>
__device__ __forceinline__ T load_field(const T* row) {
  constexpr int c = col<DF>(F);
  static_assert(c >= 0, "field absent in this df mode");
  return lane_of<c % Vec<T>::n>(load_vec(row, c / Vec<T>::n));
}

// a (prob, alias) pair of an interleaved table (kernels/sample.py:
// alias_tables_cuda): prob, then alias in the next 32-bit word, an entry
// 2 x sizeof(T) bytes.  STREAM: an entry read once (the species table,
// far larger than L2), its line the first L2 evicts (ld.global.cs), so
// the rows stay there
template <bool STREAM>
__device__ __forceinline__ void load_pair(const void* t, size_t o, float& p,
                                          int& a) {
  const int2* q = static_cast<const int2*>(t) + o;
  const int2 v = STREAM ? __ldcs(q) : __ldg(q);
  p = __int_as_float(v.x);
  a = v.y;
}
template <bool STREAM>
__device__ __forceinline__ void load_pair(const void* t, size_t o, double& p,
                                          int& a) {
  const int4* q = static_cast<const int4*>(t) + o;
  const int4 v = STREAM ? __ldcs(q) : __ldg(q);
  p = __hiloint2double(v.y, v.x);
  a = v.z;
}

template <typename T>
struct Args {
  const T* rows;
  int n_cells, nf;
  // the draw's tables: alias pairs grp (1, G), blk (G, CB) and sp (C, S);
  // SEARCH: grp is cum_dn (C,) and sp rowcum (C, S), blk unused
  const void* grp;
  int n_groups;
  const void* blk;
  int cell_block;
  const void* sp;
  int n_species;
  const T* mass;
  const T* sign;
  const T* baryon;
  const int* counts;
  int n_events, n_cap;
  uint32_t ev0, k0, k1;
  T y_cut;
  T lam;                // SEARCH: the cell draw's sum of dn_tot
  int regulate;         // VAH: regulate_deltaf's clip of the residual df
  // per-slot mode: (B, n_cap) outputs
  bool* keep;
  bool* ok;
  int* rounds;
  int* sidx;
  int* cidx;
  T* px;
  T* py;
  T* pz;
  T* eta;
  // packed mode: (cap,) outputs, (B,) kept counts, and scratch: the tile
  // counter, the kept / ok / rounds totals, then one state word a tile
  int cap, cbits, f16;
  int* p_idx0;          // scidx, or sidx
  int* p_idx1;          // cidx where cbits < 0
  void* p_px;
  void* p_py;
  void* p_pz;
  void* p_eta;          // 2+1D
  int* per_event;
  unsigned long long* scratch;
};

// a product never contracted into an FMA with a later add: the alias
// pick's frac(u K) and the search draws' u lam and u rowcum[S - 1] must
// round as the plain version's products do
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

template <bool STREAM = false, typename T>
__device__ __forceinline__ int alias_pick(const void* pairs, int row, int K,
                                          T u) {
  const T x = mul_rn(u, static_cast<T>(K));
  const int b = min(static_cast<int>(x), K - 1);
  const T f = x - static_cast<T>(b);
  const size_t o = static_cast<size_t>(row) * K + b;
  T p;
  int a;
  load_pair<STREAM>(pairs, o, p, a);
  return f < p ? b : a;
}

// the cell of a search draw: searchsorted(cum, x, right) clipped to C - 1
// (is3d_tpu/kernels/sample.py:863-866)
template <typename T>
__device__ __forceinline__ int search_cell(const T* cum, int C, T x) {
  int lo = 0, hi = C;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(cum + mid) <= x) lo = mid + 1;
    else hi = mid;
  }
  return min(lo, C - 1);
}

// the species of a search draw: the first s with rc[s] >= v in
// S.bit_length() halvings (is3d_tpu/kernels/sample.py:_row_categorical;
// v <= rc[S - 1], so no halving reads past the row)
template <typename T>
__device__ __forceinline__ int search_species(const T* rc, int S, T v) {
  const int halvings = 32 - __clz(S);
  int lo = 0, hi = S;
  for (int it = 0; it < halvings; ++it) {
    const int mid = (lo + hi) >> 1;
    const bool right = __ldg(rc + min(mid, S - 1)) < v;
    lo = right ? mid + 1 : lo;
    hi = right ? hi : mid;
  }
  return min(lo, S - 1);
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

// the feqmod switch and the sampling temperature and chemistry of a
// slot's cell (kernels/sample.py:event_batch_plain)
template <typename T, int DF>
__device__ __forceinline__ void sampling_state(T Tc, T alphaB, T breakdown,
                                               T Tmod, T alphaBmod, T baryon,
                                               bool& use_mod, T& T_eff,
                                               T& chem) {
  if (DF == 1 || DF == 2) {
    use_mod = false;
    T_eff = Tc;
    chem = baryon * alphaB;
  } else {
    use_mod = !(breakdown > T(0.5));
    T_eff = use_mod ? Tmod : Tc;
    if (DF == 4)
      chem = use_mod ? T(0) : baryon * alphaB;
    else
      chem = baryon * (use_mod ? alphaBmod : alphaB);
  }
}

// the sampling state from a row in device memory (setup) or registers
// (finalize): VAH samples at T = Lambda with zero chemical potential
template <typename T, int DF, typename Get>
__device__ __forceinline__ void row_state(Get get, T baryon, bool& use_mod,
                                          T& T_eff, T& chem) {
  if constexpr (is_vah(DF)) {
    use_mod = false;
    T_eff = get.template operator()<fLambda>();
    chem = T(0);
  } else if constexpr (DF == 1 || DF == 2) {
    sampling_state<T, DF>(get.template operator()<fT>(),
                          get.template operator()<fAlphaB>(), T(0), T(0),
                          T(0), baryon, use_mod, T_eff, chem);
  } else if constexpr (DF == 3) {
    sampling_state<T, DF>(get.template operator()<fT>(),
                          get.template operator()<fAlphaB>(),
                          get.template operator()<fBreakdown>(),
                          get.template operator()<fTmod>(),
                          get.template operator()<fAlphaBmod>(), baryon,
                          use_mod, T_eff, chem);
  } else {
    sampling_state<T, DF>(get.template operator()<fT>(),
                          get.template operator()<fAlphaB>(),
                          get.template operator()<fBreakdown>(),
                          get.template operator()<fTmod>(), T(0), baryon,
                          use_mod, T_eff, chem);
  }
}

// a field getter over a row in device memory, and over one in registers
template <typename T, int DF>
struct MemGet {
  const T* row;
  template <Field F>
  __device__ __forceinline__ T operator()() const {
    return load_field<T, DF, F>(row);
  }
};
template <typename T, int DF>
struct RegGet {
  const Row<T, DF>& g;
  template <Field F>
  __device__ __forceinline__ T operator()() const {
    return g.template get<F>();
  }
};

// the viscous weight (1 + df)/2 of the linear branch
// (kernels/sample.py:_df_weight)
template <typename T, int DF>
__device__ __forceinline__ T df_weight(const Row<T, DF>& g, T E, T px, T py,
                                       T pz, T mass2, T sign, T baryon) {
  const T pipp = px * px * g.template get<fPixx>()
      + py * py * g.template get<fPiyy>() + pz * pz * g.template get<fPizz>()
      + T(2) * (px * py * g.template get<fPixy>()
                + px * pz * g.template get<fPixz>()
                + py * pz * g.template get<fPiyz>());
  const T Vp = -(px * g.template get<fVx>() + py * g.template get<fVy>()
                 + pz * g.template get<fVz>());
  const T Tc = g.template get<fT>(), bulkPi = g.template get<fBulkPi>();
  T df_tot;
  if constexpr (DF == 1) {
    const T chem = baryon * g.template get<fAlphaB>();
    const T feqbar = T(1) - sign / (exp(E / Tc - chem) + sign);
    const T c0 = g.template get<fC0>(), c2 = g.template get<fC2>();
    const T df_shear = pipp / g.template get<fShear14>();
    const T df_bulk = ((c0 - c2) * mass2
                       + (baryon * g.template get<fC1>()
                          + (T(4) * c2 - c0) * E) * E) * bulkPi;
    const T df_diff = (baryon * g.template get<fC3>()
                       + g.template get<fC4>() * E) * Vp;
    df_tot = feqbar * (df_shear + df_bulk + df_diff);
  } else if constexpr (DF == 2 || DF == 3) {
    const T chem = baryon * g.template get<fAlphaB>();
    const T feqbar = T(1) - sign / (exp(E / Tc - chem) + sign);
    const T df_shear = pipp / (T(2) * E * g.template get<fBetapi>() * Tc);
    const T df_bulk = (baryon * g.template get<fG>()
                       + g.template get<fF>() * E / (Tc * Tc)
                       + (E - mass2 / E) / (T(3) * Tc))
        * bulkPi / g.template get<fBetabulk>();
    const T df_diff = (g.template get<fBenth>() - baryon / E) * Vp
        / g.template get<fBetaV>();
    df_tot = feqbar * (df_shear + df_bulk + df_diff);
  } else {
    const T feqbar = T(1) - sign / (exp(E / Tc) + sign);
    const T dl = g.template get<fDeltaLambda>();
    const T df_shear = feqbar * pipp
        / (T(2) * E * g.template get<fBetapi>() * Tc);
    const T df_bulk = g.template get<fDeltaZ>() - T(3) * dl
        + feqbar * dl * (E - mass2 / E) / Tc;
    df_tot = df_shear + df_bulk;
  }
  df_tot = clampT(df_tot, T(-1), T(1));
  return T(0.5) * (T(1) + df_tot);
}

// the VAH weight clip((1 + f_abar df) / 2, 0, 1) with the residual
// 14-moment df of the chains DF carries (is3d_tpu/kernels/sample.py:
// 946-975), f_abar from the proposal's Ebar = E_a / Lambda
template <typename T, int DF>
__device__ __forceinline__ T vah_weight(const Row<T, DF>& g, T Ebar, T E,
                                        T px, T py, T pz, T mass2, T sign,
                                        int regulate) {
  T df_tot = T(0);
  if constexpr ((DF & 1) != 0) {
    const T Wp = g.template get<fWlx>() * px + g.template get<fWly>() * py
        + g.template get<fWlz>() * pz;
    const T pipp = px * px * g.template get<fPixx>()
        + py * py * g.template get<fPiyy>()
        + pz * pz * g.template get<fPizz>()
        + T(2) * (px * py * g.template get<fPixy>()
                  + px * pz * g.template get<fPixz>()
                  + py * pz * g.template get<fPiyz>());
    df_tot = df_tot + g.template get<fVc3>() * pz * Wp
        + g.template get<fVc4>() * pipp;
  }
  if constexpr ((DF & 2) != 0) {
    df_tot = df_tot + (g.template get<fVc0>() * mass2
                       + g.template get<fVc1>() * pz * pz
                       + g.template get<fVc2>() * E * E)
        * g.template get<fBulkPi>();
  }
  const T fabar = T(1) - sign / (exp(Ebar) + sign);
  df_tot = fabar * df_tot;
  if (regulate) df_tot = clampT(df_tot, T(-1), T(1));
  return clampT(T(0.5) * (T(1) + df_tot), T(0), T(1));
}

// a tile's shared memory: per slot the proposal's inputs (mbar, chem,
// sign, weq_max in A-D; the rejection's results pbar, Ebar, phi, cost
// replace them; packed mode's lab px, py, pz, eta replace those), the
// keep and rapidity draws, sidx, cidx, rounds | ok << 16; the list of
// valid slots; the valid and keep words and their offsets
template <typename T>
struct TileSmem {
  T *A, *B, *C, *D, *U3, *U4;
  unsigned long long* red;   // 2 x kWarps partial totals
  int *sidx, *cidx, *rnd, *voff, *koff, *misc;
  unsigned *vmask, *kmask;
  unsigned short* list;
  static constexpr size_t bytes() {
    return 6 * kTile * sizeof(T) + 2 * kWarps * 8 + 3 * kTile * 4
        + 4 * kChunks * 4 + 4 * 4 + kTile * 2;
  }
  __device__ explicit TileSmem(unsigned char* p) {
    T* t = reinterpret_cast<T*>(p);
    A = t; B = t + kTile; C = t + 2 * kTile; D = t + 3 * kTile;
    U3 = t + 4 * kTile; U4 = t + 5 * kTile;
    red = reinterpret_cast<unsigned long long*>(t + 6 * kTile);
    int* i = reinterpret_cast<int*>(red + 2 * kWarps);
    sidx = i; cidx = i + kTile; rnd = i + 2 * kTile;
    voff = i + 3 * kTile; koff = voff + kChunks;
    vmask = reinterpret_cast<unsigned*>(koff + kChunks);
    kmask = vmask + kChunks;
    misc = reinterpret_cast<int*>(kmask + kChunks);  // next, n_valid, tile, base
    list = reinterpret_cast<unsigned short*>(misc + 4);
  }
};

template <typename T>
__device__ __forceinline__ void store_packed(void* p, int pos, T v, bool f16) {
  if (f16)   // via float32, as torch's .to(float16) rounds a float64
    static_cast<__half*>(p)[pos] = __float2half_rn(static_cast<float>(v));
  else
    static_cast<T*>(p)[pos] = v;
}

// float32: registers for 8 blocks an SM (64 a thread; 32 warps to hide
// the gathers' latency)
template <typename T, int DIM, int DF, bool PACKED, bool SEARCH>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 8 : 1)
    event_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileSmem<T> s(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long total = static_cast<long long>(a.n_events) * a.n_cap;
  int tile = blockIdx.x;
  if (PACKED) {
    if (tid == 0) s.misc[2] = static_cast<int>(atomicAdd(&a.scratch[0], 1ull));
    __syncthreads();
    tile = s.misc[2];
  }
  const long long g0 = static_cast<long long>(tile) * kTile;

  // ---- 1. setup: the draws and the proposal's inputs, a thread a slot
#pragma unroll 4
  for (int it = 0; it < kSlotsPerThread; ++it) {
    const int k = it * kThreads + tid;
    const long long g = g0 + k;
    int e = 0, slot = 0;
    bool valid = false;
    if (g < total) {
      e = static_cast<int>(g / a.n_cap);
      slot = static_cast<int>(g - static_cast<long long>(e) * a.n_cap);
      valid = slot < __ldg(a.counts + e);
    }
    s.rnd[k] = 0;
    if (valid) {
      const uint32_t ev = a.ev0 + static_cast<uint32_t>(e);
      T u[5];
      is3d_rng::uniforms<T, 5>(u, static_cast<uint32_t>(slot), ev,
                               is3d_rng::kSlotRound * 16,
                               is3d_rng::kSampleTag, a.k0, a.k1, false);
      int cidx, sidx;
      if constexpr (SEARCH) {
        cidx = search_cell(static_cast<const T*>(a.grp), a.n_cells,
                           mul_rn(u[0], a.lam));
        const T* rc = static_cast<const T*>(a.sp)
            + static_cast<size_t>(cidx) * a.n_species;
        sidx = search_species(rc, a.n_species,
                              mul_rn(u[2], __ldg(rc + a.n_species - 1)));
      } else {
        const int grp = alias_pick(a.grp, 0, a.n_groups, u[0]);
        const int within = alias_pick(a.blk, grp, a.cell_block, u[1]);
        cidx = min(grp * a.cell_block + within, a.n_cells - 1);
        sidx = alias_pick<true>(a.sp, cidx, a.n_species, u[2]);
      }
      const T* row = a.rows + static_cast<size_t>(cidx) * a.nf;
      const T mass = __ldg(a.mass + sidx), sign = __ldg(a.sign + sidx);
      const T baryon = __ldg(a.baryon + sidx);
      bool use_mod;
      T T_eff, chem;
      row_state<T, DF>(MemGet<T, DF>{row}, baryon, use_mod, T_eff, chem);
      const T mbar = mass / T_eff;
      s.A[k] = mbar;
      s.B[k] = chem;
      s.C[k] = sign;
      s.D[k] = (mbar < T(0.8554) && sign == T(-1)) ? pion_weight_max(mbar)
                                                   : T(1);
      s.U3[k] = u[3];
      s.U4[k] = u[4];
      s.sidx[k] = sidx;
      s.cidx[k] = cidx;
    }
    const unsigned m = __ballot_sync(kFull, valid);
    if (lane == 0) s.vmask[k >> 5] = m;
  }
  __syncthreads();
  if (warp == 0) {
    const int c = lane < kChunks ? __popc(s.vmask[lane]) : 0;
    const int incl = warp_scan(c, lane);
    if (lane < kChunks) s.voff[lane] = incl - c;
    if (lane == 31) s.misc[1] = incl;
    if (lane == 0) s.misc[0] = 0;
  }
  __syncthreads();
  for (int it = 0; it < kSlotsPerThread; ++it) {
    const int k = it * kThreads + tid;
    const unsigned m = s.vmask[k >> 5];
    if ((m >> lane) & 1u)
      s.list[s.voff[k >> 5] + __popc(m & lanemask_lt())] =
          static_cast<unsigned short>(k);
  }
  __syncthreads();

  // ---- 2. rejection, a lane taking the tile's next pending slot as soon
  // as its slot is done (the proposals of the reference's light p^2 e^-p
  // and heavy k^j e^-k mixture samplers, kernels/sample.py:_propose)
  {
    const int n_valid = s.misc[1];
    int cur = -1, r = 0;
    bool need = true;
    uint32_t ev = 0, s32 = 0;
    T mbar = 0, mbar2 = 0, sign = 0, chem = 0, wmax = 1;
    bool light = false;
    while (true) {
      const unsigned want = __ballot_sync(kFull, need);
      if (want) {
        const int leader = __ffs(want) - 1;
        int base = 0;
        if (lane == leader) base = atomicAdd(&s.misc[0], __popc(want));
        base = __shfl_sync(kFull, base, leader);
        if (need) {
          const int q = base + __popc(want & lanemask_lt());
          need = false;
          cur = q < n_valid ? s.list[q] : -1;
          if (cur >= 0) {
            const long long g = g0 + cur;
            const int e = static_cast<int>(g / a.n_cap);
            ev = a.ev0 + static_cast<uint32_t>(e);
            s32 = static_cast<uint32_t>(g - static_cast<long long>(e) * a.n_cap);
            mbar = s.A[cur];
            chem = s.B[cur];
            sign = s.C[cur];
            wmax = s.D[cur];
            mbar2 = mbar * mbar;
            light = mbar < T(1.008);
            r = 0;
          }
        }
      }
      if (!__any_sync(kFull, cur >= 0)) break;
      if (cur >= 0) {
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
          w = exp(pb - Eb) / (T(1) + sign * exp(-Eb)) / wmax;
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
        ++r;
        const bool acc = v[4] < w;
        if (acc || r == kMaxRounds) {
          s.A[cur] = acc ? pb : T(0);
          s.B[cur] = acc ? Eb : T(1);
          s.C[cur] = acc ? T(6.283185307179586) * ph : T(0);
          s.D[cur] = acc ? ct : T(0);
          s.rnd[cur] = r | (acc ? 1 << 16 : 0);
          cur = -1;
          need = true;
        }
      }
    }
  }
  __syncthreads();

  // ---- 3. finalize, a thread a slot
  unsigned long long n_ok = 0, n_rounds = 0;
  for (int it = 0; it < kSlotsPerThread; ++it) {
    const int k = it * kThreads + tid;
    const long long g = g0 + k;
    const bool valid = (s.vmask[k >> 5] >> lane) & 1u;
    bool keep = false, accepted = false;
    int rounds = 0, sidx = 0, cidx = 0;
    T pxl = T(0), pyl = T(0), pzl = T(0), eta = T(0);
    if (valid) {
      const int ro = s.rnd[k];
      rounds = ro & 0xffff;
      accepted = ro >> 16;
      const T pbar = s.A[k], Ebar = s.B[k], phi = s.C[k], cost = s.D[k];
      sidx = s.sidx[k];
      cidx = s.cidx[k];
      const Row<T, DF> g(a.rows + static_cast<size_t>(cidx) * a.nf);
      const T mass = __ldg(a.mass + sidx), sign = __ldg(a.sign + sidx);
      const T baryon = __ldg(a.baryon + sidx);
      const T mass2 = mass * mass;
      bool use_mod;
      T T_eff, chem;
      row_state<T, DF>(RegGet<T, DF>{g}, baryon, use_mod, T_eff, chem);

      const T s2 = T(1) - cost * cost;
      const T sint = sqrt(s2 > T(0) ? s2 : T(0));
      T E = Ebar * T_eff;
      const T p = pbar * T_eff;
      T px = p * sint * cos(phi);
      T py = p * sint * sin(phi);
      T pz = p * cost;
      T w_visc = T(1);
      if constexpr (is_vah(DF)) {
        // the Romatschke-Strickland stretch pz = a_L qz
        pz = g.template get<fAL>() * pz;
        E = sqrt(mass2 + px * px + py * py + pz * pz);
        w_visc = vah_weight<T, DF>(g, Ebar, E, px, py, pz, mass2, sign,
                                   a.regulate);
      } else {
        if constexpr (DF == 3 || DF == 4) {
          if (use_mod) {
            // feqmod momentum rescale p = A p_mod + shifts (reference
            // :619-650)
            const T dm = g.template get<fDiffMod>()
                * (E * g.template get<fBenth>() + baryon);
            const T bm = T(1) + g.template get<fBulkMod>();
            const T sm = g.template get<fShearMod>();
            const T pixx = g.template get<fPixx>(), pixy = g.template get<fPixy>();
            const T pixz = g.template get<fPixz>(), piyy = g.template get<fPiyy>();
            const T piyz = g.template get<fPiyz>(), pizz = g.template get<fPizz>();
            const T bx = bm * px + sm * (pixx * px + pixy * py + pixz * pz)
                + dm * g.template get<fVx>();
            const T by = bm * py + sm * (pixy * px + piyy * py + piyz * pz)
                + dm * g.template get<fVy>();
            const T bz = bm * pz + sm * (pixz * px + piyz * py + pizz * pz)
                + dm * g.template get<fVz>();
            px = bx;
            py = by;
            pz = bz;
            E = sqrt(mass2 + px * px + py * py + pz * pz);
          }
        }
        if (!use_mod)
          w_visc = df_weight<T, DF>(g, E, px, py, pz, mass2, sign, baryon);
      }
      const T flux = E * g.template get<fDst>() - px * g.template get<fDsx>()
          - py * g.template get<fDsy>() - pz * g.template get<fDsz>();
      const T w_flux = (flux > T(0) ? flux : T(0))
          / (E * g.template get<fDsMax>());
      keep = accepted && (s.U3[k] < w_flux * w_visc);

      // lab boost (kernels/sample.py:_lab_kinematics)
      const T tau = g.template get<fTau>(), ut = g.template get<fUt>();
      const T ux = g.template get<fUx>(), uy = g.template get<fUy>();
      const T un = g.template get<fUn>();
      const T Xt = g.template get<fXt>(), Xx = g.template get<fXx>();
      const T Xy = g.template get<fXy>(), Xn = g.template get<fXn>();
      const T Yx = g.template get<fYx>(), Yy = g.template get<fYy>();
      const T Zt = g.template get<fZt>(), Zn = g.template get<fZn>();
      const T ptau = E * ut + px * Xt + pz * Zt;
      pxl = E * ux + px * Xx + py * Yx;
      pyl = E * uy + px * Xy + py * Yy;
      const T pn = E * un + px * Xn + pz * Zn;
      if (DIM == 2) {
        const T mT = sqrt(mass2 + pxl * pxl + pyl * pyl);
        const T yp = a.y_cut * (T(2) * s.U4[k] - T(1));
        const T sinhy = sinh(yp);
        const T coshy = sqrt(T(1) + sinhy * sinhy);
        const T sinheta = (ptau * sinhy - tau * pn * coshy) / mT;
        eta = asinh(sinheta);
        pzl = mT * sinhy;
      } else {
        eta = g.template get<fEta>();
        pzl = tau * pn * cosh(eta) + ptau * sinh(eta);
      }
    }
    if constexpr (!PACKED) {
      if (g < total) {
        a.keep[g] = keep;
        a.ok[g] = accepted;
        a.rounds[g] = rounds;
        a.sidx[g] = sidx;
        a.cidx[g] = cidx;
        a.px[g] = pxl;
        a.py[g] = pyl;
        a.pz[g] = pzl;
        a.eta[g] = eta;
      }
    } else {
      s.A[k] = pxl;
      s.B[k] = pyl;
      s.C[k] = pzl;
      s.D[k] = eta;
      const unsigned m = __ballot_sync(kFull, keep);
      if (lane == 0) s.kmask[k >> 5] = m;
      n_ok += accepted;
      n_rounds += static_cast<unsigned>(rounds);
    }
  }
  if constexpr (PACKED) {
  // ---- 4. packed mode: the tile's offset, then its kept hadrons
#pragma unroll
  for (int d = 16; d > 0; d /= 2) {
    n_ok += __shfl_down_sync(kFull, n_ok, d);
    n_rounds += __shfl_down_sync(kFull, n_rounds, d);
  }
  if (lane == 0) {
    s.red[warp] = n_ok;
    s.red[kWarps + warp] = n_rounds;
  }
  __syncthreads();
  if (warp == 0) {
    const int c = lane < kChunks ? __popc(s.kmask[lane]) : 0;
    const int incl = warp_scan(c, lane);
    if (lane < kChunks) s.koff[lane] = incl - c;
    if (lane == 31) {
      const unsigned long long agg = static_cast<unsigned long long>(incl);
      s.misc[3] = static_cast<int>(look_back(a.scratch + 4, tile, agg));
      unsigned long long t_ok = 0, t_rounds = 0;
      for (int w = 0; w < kWarps; ++w) {
        t_ok += s.red[w];
        t_rounds += s.red[kWarps + w];
      }
      if (agg) atomicAdd(&a.scratch[1], agg);
      if (t_ok) atomicAdd(&a.scratch[2], t_ok);
      if (t_rounds) atomicAdd(&a.scratch[3], t_rounds);
    }
  }
  __syncthreads();
  const int base = s.misc[3];
  for (int it = 0; it < kSlotsPerThread; ++it) {
    const int k = it * kThreads + tid;
    const long long g = g0 + k;
    const unsigned m = s.kmask[k >> 5];
    const int below = __popc(m & lanemask_lt());
    if ((m >> lane) & 1u) {
      const int pos = base + s.koff[k >> 5] + below;
      if (pos < a.cap) {
        const int sidx = s.sidx[k], cidx = s.cidx[k];
        if (a.cbits >= 0) {
          a.p_idx0[pos] = (sidx << a.cbits) | cidx;
        } else {
          a.p_idx0[pos] = sidx;
          a.p_idx1[pos] = cidx;
        }
        store_packed(a.p_px, pos, s.A[k], a.f16);
        store_packed(a.p_py, pos, s.B[k], a.f16);
        store_packed(a.p_pz, pos, s.C[k], a.f16);
        if (DIM == 2) store_packed(a.p_eta, pos, s.D[k], a.f16);
      }
    }
    // the last slot of an event within the tile adds the event's kept
    // hadrons of this tile to its count
    if (g < total && (k == kTile - 1 || g + 1 == total
                      || (g + 1) % a.n_cap == 0)) {
      const int e = static_cast<int>(g / a.n_cap);
      const long long first = static_cast<long long>(e) * a.n_cap - g0;
      const int st = first > 0 ? static_cast<int>(first) : 0;
      const int incl = s.koff[k >> 5] + below + static_cast<int>((m >> lane) & 1u);
      const unsigned ms = s.kmask[st >> 5];
      const int excl = s.koff[st >> 5]
          + __popc(ms & ((1u << (st & 31)) - 1u));
      if (incl > excl) atomicAdd(a.per_event + e, incl - excl);
    }
  }
  }
}

template <typename T, int DIM, int DF, bool PACKED, bool SEARCH>
cudaError_t launch_events(const Args<T>& a, cudaStream_t stream) {
  static bool ready = false;
  constexpr size_t bytes = TileSmem<T>::bytes();
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        event_kernel<T, DIM, DF, PACKED, SEARCH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const long long n = static_cast<long long>(a.n_events) * a.n_cap;
  const unsigned tiles = static_cast<unsigned>((n + kTile - 1) / kTile);
  if (tiles)
    event_kernel<T, DIM, DF, PACKED, SEARCH>
        <<<tiles, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// the caller's layout (kernels/sample.py:pack_rows) must be the df mode's
// compile-time one
template <int DF>
bool same_layout(const int* layout) {
  for (int f = 0; f < kNumFields; ++f)
    if (layout[f] != col<DF>(static_cast<Field>(f))) return false;
  return true;
}

// the instantiations of this library: VAH selects the VAH row (df_mode
// kVah | shear | bulk << 1) over df 1-4
template <typename T, bool PACKED, bool VAH, bool SEARCH>
int dispatch(int dimension, int df_mode, const Args<T>& a,
             const int* layout, void* stream) {
  if (dimension != 2 && dimension != 3) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
#define IS3D_CASE(DF)                                                       \
  case DF:                                                                  \
    if (!same_layout<DF>(layout)) return cudaErrorInvalidValue;             \
    return dimension == 2 ? launch_events<T, 2, DF, PACKED, SEARCH>(a, s)   \
                          : launch_events<T, 3, DF, PACKED, SEARCH>(a, s);
  if constexpr (VAH) {
    switch (df_mode) {
      IS3D_CASE(kVah) IS3D_CASE(kVah | 1) IS3D_CASE(kVah | 2)
      IS3D_CASE(kVah | 3)
      default: break;
    }
  } else {
    switch (df_mode) {
      IS3D_CASE(1) IS3D_CASE(2) IS3D_CASE(3) IS3D_CASE(4)
      default: break;
    }
  }
#undef IS3D_CASE
  return cudaErrorInvalidValue;
}

template <typename T>
Args<T> common_args(const void* rows, int n_cells, int nf,
                    const void* grp, int n_groups, const void* blk,
                    int cell_block, const void* sp, int n_species,
                    const void* mass, const void* sign, const void* baryon,
                    const void* counts, int n_events, int n_cap,
                    long long ev0, unsigned k0, unsigned k1, int regulate,
                    double y_cut, double lam) {
  Args<T> a{};
  a.rows = static_cast<const T*>(rows);
  a.n_cells = n_cells;
  a.nf = nf;
  a.grp = grp;
  a.n_groups = n_groups;
  a.blk = blk;
  a.cell_block = cell_block;
  a.sp = sp;
  a.n_species = n_species;
  a.mass = static_cast<const T*>(mass);
  a.sign = static_cast<const T*>(sign);
  a.baryon = static_cast<const T*>(baryon);
  a.counts = static_cast<const int*>(counts);
  a.n_events = n_events;
  a.n_cap = n_cap;
  a.ev0 = static_cast<uint32_t>(ev0);
  a.k0 = k0;
  a.k1 = k1;
  a.regulate = regulate;
  a.y_cut = static_cast<T>(y_cut);
  a.lam = static_cast<T>(lam);
  return a;
}

}  // namespace

#define IS3D_COMMON_PARAMS                                                  \
  const void *rows, int n_cells, int nf, const int *layout,                \
      const void *grp, int n_groups, const void *blk, int cell_block,      \
      const void *sp, int n_species, const void *mass, const void *sign,   \
      const void *baryon, const void *counts, int n_events, int n_cap,     \
      long long ev0, unsigned k0, unsigned k1, int dimension, int df_mode, \
      int regulate, double y_cut, double lam
#define IS3D_COMMON_ARGS                                                    \
  rows, n_cells, nf, grp, n_groups, blk, cell_block, sp, n_species, mass,  \
      sign, baryon, counts, n_events, n_cap, ev0, k0, k1, regulate, y_cut, \
      lam

// K7's C entries of one library; VAH and SEARCH pick its instantiations.
// Per-slot mode: the slots of n_events x n_cap; `layout` is a host array
// of kNumFields columns (kernels/sample.py:pack_rows); grp, blk and sp the
// interleaved (prob, alias) tables, or (SEARCH) cum_dn, unused and rowcum,
// with lam the sum of dn_tot.  Packed mode: the kept hadrons in
// event-major (cap,) arrays (idx1 and eta may be null where unused; f16:
// the momenta and eta as __half), the (B,) kept counts (zeroed by the
// caller) and scratch, zeroed by the caller: 4 + tiles 64-bit words (the
// tile counter, the kept, ok and rounds totals, the tiles' states)
#define IS3D_SAMPLE_EVENT_ENTRIES(VAH, SEARCH)                              \
  extern "C" {                                                              \
  int is3d_sample_events_f32(IS3D_COMMON_PARAMS, void* keep, void* ok,     \
                             void* rounds, void* sidx, void* cidx,         \
                             void* px, void* py, void* pz, void* eta,      \
                             void* stream) {                               \
    return is3d_slots<float, VAH, SEARCH>(IS3D_COMMON_ARGS, dimension,     \
                                          df_mode, layout, keep, ok,       \
                                          rounds, sidx, cidx, px, py, pz,  \
                                          eta, stream);                    \
  }                                                                         \
  int is3d_sample_events_f64(IS3D_COMMON_PARAMS, void* keep, void* ok,     \
                             void* rounds, void* sidx, void* cidx,         \
                             void* px, void* py, void* pz, void* eta,      \
                             void* stream) {                               \
    return is3d_slots<double, VAH, SEARCH>(IS3D_COMMON_ARGS, dimension,    \
                                           df_mode, layout, keep, ok,      \
                                           rounds, sidx, cidx, px, py, pz, \
                                           eta, stream);                   \
  }                                                                         \
  int is3d_sample_packed_f32(IS3D_COMMON_PARAMS, int cap, int cbits,       \
                             int f16, void* idx0, void* idx1, void* px,    \
                             void* py, void* pz, void* eta,                \
                             void* per_event, void* scratch,               \
                             void* stream) {                               \
    return is3d_packed<float, VAH, SEARCH>(                                \
        IS3D_COMMON_ARGS, dimension, df_mode, layout, cap, cbits, f16,     \
        idx0, idx1, px, py, pz, eta, per_event, scratch, stream);          \
  }                                                                         \
  int is3d_sample_packed_f64(IS3D_COMMON_PARAMS, int cap, int cbits,       \
                             int f16, void* idx0, void* idx1, void* px,    \
                             void* py, void* pz, void* eta,                \
                             void* per_event, void* scratch,               \
                             void* stream) {                               \
    return is3d_packed<double, VAH, SEARCH>(                               \
        IS3D_COMMON_ARGS, dimension, df_mode, layout, cap, cbits, f16,     \
        idx0, idx1, px, py, pz, eta, per_event, scratch, stream);          \
  }                                                                         \
  int is3d_sample_tiles(long long n_slots) {                               \
    return static_cast<int>((n_slots + kTile - 1) / kTile);                \
  }                                                                         \
  const char* is3d_cuda_error_string(int code) {                           \
    return cudaGetErrorString(static_cast<cudaError_t>(code));             \
  }                                                                         \
  }

namespace {

template <typename T, bool VAH, bool SEARCH>
int is3d_slots(const void* rows, int n_cells, int nf, const void* grp,
               int n_groups, const void* blk, int cell_block, const void* sp,
               int n_species, const void* mass, const void* sign,
               const void* baryon, const void* counts, int n_events,
               int n_cap, long long ev0, unsigned k0, unsigned k1,
               int regulate, double y_cut, double lam, int dimension,
               int df_mode, const int* layout, void* keep, void* ok,
               void* rounds, void* sidx, void* cidx, void* px, void* py,
               void* pz, void* eta, void* stream) {
  Args<T> a = common_args<T>(rows, n_cells, nf, grp, n_groups, blk,
                             cell_block, sp, n_species, mass, sign, baryon,
                             counts, n_events, n_cap, ev0, k0, k1, regulate,
                             y_cut, lam);
  a.keep = static_cast<bool*>(keep);
  a.ok = static_cast<bool*>(ok);
  a.rounds = static_cast<int*>(rounds);
  a.sidx = static_cast<int*>(sidx);
  a.cidx = static_cast<int*>(cidx);
  a.px = static_cast<T*>(px);
  a.py = static_cast<T*>(py);
  a.pz = static_cast<T*>(pz);
  a.eta = static_cast<T*>(eta);
  return dispatch<T, false, VAH, SEARCH>(dimension, df_mode, a, layout,
                                         stream);
}

template <typename T, bool VAH, bool SEARCH>
int is3d_packed(const void* rows, int n_cells, int nf, const void* grp,
                int n_groups, const void* blk, int cell_block,
                const void* sp, int n_species, const void* mass,
                const void* sign, const void* baryon, const void* counts,
                int n_events, int n_cap, long long ev0, unsigned k0,
                unsigned k1, int regulate, double y_cut, double lam,
                int dimension, int df_mode, const int* layout, int cap,
                int cbits, int f16, void* idx0, void* idx1, void* px,
                void* py, void* pz, void* eta, void* per_event,
                void* scratch, void* stream) {
  Args<T> a = common_args<T>(rows, n_cells, nf, grp, n_groups, blk,
                             cell_block, sp, n_species, mass, sign, baryon,
                             counts, n_events, n_cap, ev0, k0, k1, regulate,
                             y_cut, lam);
  a.cap = cap;
  a.cbits = cbits;
  a.f16 = f16;
  a.p_idx0 = static_cast<int*>(idx0);
  a.p_idx1 = static_cast<int*>(idx1);
  a.p_px = px;
  a.p_py = py;
  a.p_pz = pz;
  a.p_eta = eta;
  a.per_event = static_cast<int*>(per_event);
  a.scratch = static_cast<unsigned long long*>(scratch);
  return dispatch<T, true, VAH, SEARCH>(dimension, df_mode, a, layout,
                                        stream);
}

}  // namespace
