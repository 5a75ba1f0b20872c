// The backward pass of the resonance-decay feed-down waves for Hopper
// (sm_90a), float32 and float64: the gradient of <G, wave output> with
// respect to each parent slot's table (log dN (P, F, Y), tc, ts (F, Y)).
//
// Replaces the hand-written VJPs of JAX's hat-weight evaluators,
// is3d_tpu/kernels/decays.py:281-298 (_eval_parent_2d_pair_bwd) and
// :350-370 (_eval_parent_3d_pair_bwd), as the wave kernels reach them
// (_two_body_wave :583, _three_body_wave :600).  As JAX's custom_vjp it
// keeps no forward intermediates: it recomputes every evaluation.  The
// kinematic queries (MT, Phi, Y) are functions of masses and grids, so
// only the tables get gradients.
//
// The formula.  One evaluation of task k at output (p, f, y), node (s, v,
// zeta) and Phi solution +- adds W exp(L) to out[k, p, f, y], W = ws wz vw
// MT and L the bilinear (MT, Phi) interpolation of the slot's table (and
// linear in Y in 3+1D; past the MT grid tc + ts MT, interpolated in Phi):
// L = sum over corners of w_c tab[c].  With g = pref_k G[seg_k, p, f, y],
//     d tab[c] += g W exp(L) w_c
// for every corner c of every evaluation (outputs with |Y| > |y_max| add
// nothing, as in the forward).
//
// What bounds it on this card: each evaluation recomputes the forward's
// (exp and ~20 FP32, kernels/decays.py: wave_backward_operations) and adds
// to 4 (2+1D) or 8 (3+1D) entries of the slot's table that other threads
// and blocks add to as well.  The first version (two passes, two device-
// memory atomics a term: ~8 an evaluation in 3+1D, ~1e11 for the main
// path's 3-body wave 0) ran at 0.5 % of the FP32 bound, on the L2's
// atomics.
//
// Design.
//   * The forward's blocking (decays.cu, wave_kernel): a block per (task,
//     chunk of PB pT values, chunk of the task's (s, v) node pairs), a
//     thread per output (pT, phi, run of YRun rapidities), the (v, zeta)
//     node table built per s in shared memory (build_node, as the
//     forward's).  The table it reads (log2(e)-scaled in float32, phi
//     columns padded, kernels/decays.py: padded_tables) is copied into
//     shared memory on the shared route, and read from device memory
//     (L1, L2) on the device route.
//   * No float atomic: the adds are integer, in fixed point, so their
//     order cannot change the sum (two launches give identical bits).  A
//     term x = g W exp(L) w_c is scaled by 2^S_u (Scale below); in 3+1D a
//     thread's neighbouring outputs share a rapidity plane, summed in the
//     thread before it is added.
//   * One pass.  The slot's scale comes from a bound that needs no
//     evaluation (kernels/decays.py: wave_bwd_scale, torch on the card:
//     |pref| max|G| of the task, each node's W and MT, the slot's row
//     extremes), not from the exact largest term, which the first version
//     found by running every evaluation twice.  The bound gives up B_u bits
//     against the exact largest term (measured on the main path's waves:
//     PERF.md; decays.wave_bwd_bits reads the exact exponent through
//     emax); the words keep HI_u bits below the bound, so a float32 term
//     keeps its 24 bits while HI_u - B_u >= 24 (main path: HI_u 32-38,
//     B_u 1-7), and float64's two words 2 HI_u - B_u bits.
//   * Routes, chosen by dtype and shape (blocking), never after a failure:
//     - SHM, float32 where the slot's table and a 32-bit low word an
//       entry (148.5 KB at 32 x 24 x 21, 7 KB in 2+1D) fit beside the
//       node tables: the block reads the table from shared memory and
//       adds each term's low 32 bits to its low word there (a native
//       shared atomic; a 64-bit atomicAdd on shared memory is a compare-
//       and-swap loop on sm_90, 2x slower on the 3-body wave 0 by A/B),
//       the high bits and the carry out of the low word (rare: once the
//       word passes 2^32) to the slot's int64 word in device memory, and
//       at its end each nonzero low word to the same int64 word: a term's
//       bits reach that word exactly once, in any order.  One block an SM
//       holds a 3+1D copy, so the route's blocks take THREADS_SHM threads
//       (runs of 7 rapidities) for 18 warps an SM.
//     - DEVICE, float64 (two words an entry do not fit in 3+1D, and one
//       word's resolution would miss float64's checks) and float32 grids
//       whose words do not fit: each term adds to the device's words, as
//       the first version did, in one pass.
//   * Precision.  An entry's int64 word sums at most E_u terms of
//     |.| < 2^HI_u, so it stays below 2^61 (Scale), whatever part of the
//     sum a block's low word holds.  A float32 term rounds to the word at
//     2^-HI_u of the bound (HI_u = 61 - ceil(log2 E_u)), below its own
//     float32 rounding; the absolute error of an entry is at most its
//     terms' count x 2^-(HI_u + 1) of the bound: 1.2e-5 of the bound for
//     1e5 terms at HI_u = 32 (~1e-8 as the roundings' signs fall), inside
//     the checks' 2e-5 x max (float32) of a gradient whose largest entry
//     sums many terms; float64's two words keep 2^-2HI_u.
//     finish_kernel turns each entry's words into the float gradient and
//     folds the padded phi columns onto the slot's columns.

#include <cuda_runtime.h>


namespace {

constexpr int NG = 12;             // Gauss-Legendre points in v, zeta, s
constexpr int NODES = NG * NG;     // (v, zeta) nodes per (task, pT[, s])
constexpr int THREADS = 256;       // most threads a block
constexpr int THREADS_SHM = 576;   // the shared route's (8 pT values of
                                   // 24 phi x 3 runs in 3+1D: 18 warps)
constexpr int NPAR = 6;            // parameters per task
constexpr int FOLD_THREADS = 256;
constexpr size_t MAX_SMEM = 232448;

// the forward's type-dependent parts (decays.cu, Fn)
template <typename T>
struct Fn;

template <>
struct Fn<float> {
  static constexpr float TWO_PI = 6.283185307179586f;
  static __device__ __forceinline__ float exps(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
  }
  static __device__ __forceinline__ float sqrt(float x) { return sqrtf(x); }
  static __device__ __forceinline__ float log(float x) { return logf(x); }
  static __device__ __forceinline__ float cosh(float x) { return coshf(x); }
  static __device__ __forceinline__ float sinh(float x) { return sinhf(x); }
  static __device__ __forceinline__ float acos(float x) { return acosf(x); }
  static __device__ __forceinline__ float abs(float x) { return fabsf(x); }
};

template <>
struct Fn<double> {
  static constexpr double TWO_PI = 6.283185307179586;
  static __device__ __forceinline__ double exps(double x) { return ::exp(x); }
  static __device__ __forceinline__ double sqrt(double x) { return ::sqrt(x); }
  static __device__ __forceinline__ double log(double x) { return ::log(x); }
  static __device__ __forceinline__ double cosh(double x) { return ::cosh(x); }
  static __device__ __forceinline__ double sinh(double x) { return ::sinh(x); }
  static __device__ __forceinline__ double acos(double x) { return ::acos(x); }
  static __device__ __forceinline__ double abs(double x) { return fabs(x); }
};

// rapidities a thread owns in 3+1D: 7, where the forward's float32 owns
// 21 (its planes in shared memory; here a float32 run of 7 left the
// 3-body wave 0 at 0.56 of its time by A/B, more threads for the one
// resident block of the shared route against ~9 % more plane adds)
template <typename T, int DIM>
struct YRun {
  static constexpr int R = DIM == 2 ? 1 : 7;
};

template <typename T>
__device__ __forceinline__ T max_(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T min_(T a, T b) { return a < b ? a : b; }

template <typename T>
__device__ __forceinline__ int lower_bound(const T* a, int n, T x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The shared-memory layout of a block: the grids and the node table of
// decays.cu's Smem; LEN = P (F + 2) Y + 2 (F + 2) Y is a slot's length in
// the padded layout of padded_tables, TAIL the offset of its tc.
template <typename T>
struct Smem {
  int FP, NY, NB, LEN, TAIL;
  T *mtg, *phl, *invd, *y, *qx, *qw, *qz, *nDY, *nPh, *nW, *nW0, *nW1;
  int *nRow, *bucket;

  __host__ __device__ Smem(unsigned char* raw, int P, int F, int NY_, int PB,
                           int NB_)
      : FP(F + 2), NY(NY_), NB(NB_) {
    TAIL = P * FP * NY;
    LEN = TAIL + 2 * FP * NY;
    mtg = reinterpret_cast<T*>(raw);
    phl = mtg + P;
    invd = phl + F + 2;
    y = invd + F + 1;
    qx = y + NY;
    qw = qx + NG;
    qz = qw + NG;
    nDY = qz + NG;
    nPh = nDY + PB;
    nW = nPh + PB * NODES;
    nW0 = nW + PB * NODES;
    nW1 = nW0 + PB * NODES;
    nRow = reinterpret_cast<int*>(nW1 + PB * NODES);
    bucket = nRow + PB * NODES;
  }

  __host__ __device__ size_t bytes(const unsigned char* raw) const {
    return reinterpret_cast<const unsigned char*>(bucket + NB) - raw;
  }

  // the shared route's copy of the slot's table and its 32-bit low
  // words, past the tables (16-byte aligned)
  __host__ __device__ static size_t words_at(size_t b) {
    return (b + 15) / 16 * 16;
  }
  __host__ __device__ static size_t shm_bytes(int len) {
    return (size_t)len * (sizeof(T) + sizeof(unsigned));
  }
  __device__ T* table() const {
    const unsigned char* raw = reinterpret_cast<const unsigned char*>(mtg);
    return reinterpret_cast<T*>(const_cast<unsigned char*>(raw)
                                + words_at(bytes(raw)));
  }
  __device__ unsigned* low() const {
    return reinterpret_cast<unsigned*>(table() + LEN);
  }
};

// the (v, zeta) node n of pT value pb at one s: decays.cu's build_node,
// the tail's row the offset TAIL of tc in the padded table
template <typename T>
__device__ __forceinline__ void build_node(const Smem<T>& s, int n, T pt,
                                           int P, T m2, T Es, T ps, T M,
                                           T sw, int v_dy) {
  using F_ = Fn<T>;
  const int pb = n / NODES, v = (n / NG) % NG, z = n % NG;
  const T pT2 = pt * pt;
  const T mT2 = pT2 + m2;
  const T mT = F_::sqrt(mT2);
  const T DY = F_::log((ps + F_::sqrt(Es * Es + pT2)) / mT);
  const T a = s.qx[v] * DY;
  const T ch = F_::cosh(a), sh = F_::sinh(a);
  const T mT2s2 = mT2 * (sh * sh);
  const T den = m2 + mT2s2;
  const T MTbar = Es * M * mT * ch / den;
  const T DMT = M * pt * F_::sqrt(F_::abs(ps * ps - mT2s2)) / den;
  const T mTc = mT * ch / pt;
  const T vw = DY * s.qw[v] / F_::sqrt(F_::abs(den));
  const T MT = MTbar + DMT * s.qz[z];
  const T PT = F_::sqrt(max_(MT * MT - M * M, T(1e-30)));
  const T arg = (MT * mTc - Es * M / pt) / PT;
  s.nPh[n] = F_::acos(min_(max_(arg, T(-1)), T(1)));
  s.nW[n] = sw * (s.qw[z] * vw * MT);
  const int iR = min(max(lower_bound(s.mtg, P, MT), 1), P - 1);
  const bool inside = MT <= s.mtg[P - 1];
  const T tM = (MT - s.mtg[iR - 1]) / (s.mtg[iR] - s.mtg[iR - 1]);
  s.nW0[n] = inside ? T(1) - tM : T(1);
  s.nW1[n] = inside ? tM : MT;
  s.nRow[n] = inside ? (iR - 1) * s.FP * s.NY : s.TAIL;
  if (v == v_dy && z == 0) s.nDY[pb] = DY;
}

// one Phi solution's corner: the offset of its (row, left column) and the
// four bilinear weights of q, q + NY, q + FP NY, q + FP NY + NY
template <typename T>
struct Corner {
  int q;
  T w00, w01, w10, w11;
};

template <typename T>
__device__ __forceinline__ Corner<T> corner(const Smem<T>& s, T Phi, int row,
                                            T W0, T W1, T binv) {
  using F_ = Fn<T>;
  T Pw = Phi;
  if (Pw < T(0)) Pw += F_::TWO_PI;
  else if (Pw >= F_::TWO_PI) Pw -= F_::TWO_PI;
  int i = s.bucket[min((int)(Pw * binv), s.NB - 1)];
  if (Pw > s.phl[i + 1]) ++i;
  const T t = (Pw - s.phl[i]) * s.invd[i];
  Corner<T> c;
  c.q = row + i * s.NY;
  c.w00 = W0 * (T(1) - t);
  c.w01 = W0 * t;
  c.w10 = W1 * (T(1) - t);
  c.w11 = W1 * t;
  return c;
}

template <typename T>
__device__ __forceinline__ T plane(const T* tab, int q, int NY, int FPNY,
                                   const Corner<T>& c) {
  return tab[q] * c.w00 + tab[q + NY] * c.w01 + tab[q + FPNY] * c.w10
         + tab[q + FPNY + NY] * c.w11;
}

// the left plane of Y's stencil (the forward's y_stencil)
template <typename T>
__device__ __forceinline__ int y_stencil(const Smem<T>& s, int Ls, T Y) {
  if (Ls < 0) return min(max(lower_bound(s.y, s.NY, Y), 1), s.NY - 1) - 1;
  while (Ls < s.NY - 2 && s.y[Ls + 1] < Y) ++Ls;
  return Ls;
}

// The fixed point of a slot u.  The wrapper (kernels/decays.py:
// wave_bwd_scale) bounds every term a w_c of the slot without evaluating
// one (from the slot's row extremes, the task's largest |pref G| and each
// node's W and MT), apart for its log rows (nodes inside the MT grid) and
// its tail rows tc, ts (nodes past it, whose gradients are ~1e-6 of the
// log rows' and are checked on their own): |a w_c| < 2^e.  With E_u the slot's evaluations (its
// tasks x nodes x outputs x 2), the sum of any entry's |terms| is below
// E_u 2^e, so a term scaled by 2^S, S = HI_u - e, HI_u = 61 -
// ceil(log2 E_u), leaves every entry's sum below 2^61 in magnitude, and a
// fold of two entries below 2^62: no integer word can overflow, in any
// order of the adds.
//   * float32: one 64-bit word an entry, the term rounded to an integer at
//     that scale (a float32 term carries 24 bits; the word's resolution
//     is 2^-HI_u of the bound).
//   * float64: two words, the term's integer part (high) and the rest x
//     2^HI_u rounded (low): resolution 2^-2HI_u of the bound.
template <typename T>
struct Scale;

template <>
struct Scale<float> {
  float a, b;                  // 2^S = a b (each factor within float32)
  __device__ Scale(int S, int) {
    S = S > 250 ? 250 : (S < -250 ? -250 : S);
    a = exp2f((float)(S / 2));
    b = exp2f((float)(S - S / 2));
  }
  // the term's word at the slot's scale
  __device__ __forceinline__ long long word(float x) const {
    return __float2ll_rn((x * a) * b);
  }
};

template <>
struct Scale<double> {
  int S, HI;
  __device__ Scale(int S_, int HI_) : S(S_), HI(HI_) {}
};

// one term x of table entry `at`: in float32 its word into the device's
// acc[at], or on the shared route its low 32 bits into the block's
// low[at] and the rest with the carry out of that add into acc[at] (the
// sum stays exact modulo 2^64, in any order); in float64 its two words
// into acc[at] and acc[LEN + at]
template <bool SHM>
__device__ __forceinline__ void add_term(unsigned long long* acc,
                                         unsigned* low, int, int at,
                                         float x, const Scale<float>& sc) {
  const long long w = sc.word(x);
  if (SHM) {
    const unsigned lo = (unsigned)w;
    const unsigned old = atomicAdd(low + at, lo);
    const long long hi = (w >> 32) + (old + lo < old ? 1 : 0);
    if (hi != 0)
      atomicAdd(acc + at, (unsigned long long)hi << 32);
  } else {
    atomicAdd(acc + at, (unsigned long long)w);
  }
}
template <bool SHM>
__device__ __forceinline__ void add_term(unsigned long long* acc, unsigned*,
                                         int LEN, int at, double x,
                                         const Scale<double>& sc) {
  const double X = ldexp(x, sc.S);
  const double h = floor(X);
  atomicAdd(acc + at, (unsigned long long)(long long)h);
  atomicAdd(acc + LEN + at,
            (unsigned long long)(long long)rint(ldexp(X - h, sc.HI)));
}

// the four corner terms a w_c of one (plane of a) Phi solution; `big`
// keeps the largest |a w_c| where the caller measures it
template <bool SHM, typename T>
__device__ __forceinline__ void corner_terms(unsigned long long* acc,
                                             unsigned* low,
                                             int LEN, int q, int NY,
                                             int FPNY, T w00, T w01, T w10,
                                             T w11, T a, const Scale<T>& sc,
                                             bool measure, T& big) {
  const T x[4] = {a * w00, a * w01, a * w10, a * w11};
  const int at[4] = {q, q + NY, q + FPNY, q + FPNY + NY};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (measure) big = max_(big, Fn<T>::abs(x[i]));
    add_term<SHM>(acc, low, LEN, at[i], x[i], sc);
  }
}

// float32 tables whose copy and low words fit in shared memory beside the
// node tables (SHM): each block reads its slot's table there and adds its
// terms' low 32 bits to its own low words, the rest to the device's word,
// and each low word to the device's word once, at its end (integer adds,
// so in any order); otherwise every term goes to the device's words.
// scale (U, 3): S of the log rows, S of the tail rows, HI_u; acc: (U, LEN)
// words in float32, (U, 2, LEN) in float64; emax (U, 2) or null: the
// largest binary exponent of the terms added to the log and the tail rows
// (frexp), measured where asked for
template <typename T, int DIM, int NBODY, bool SHM>
__global__ void __launch_bounds__(SHM ? THREADS_SHM : THREADS)
    wave_bwd_kernel(const T* __restrict__ ptab, const T* __restrict__ mtg,
                    const T* __restrict__ pT, const T* __restrict__ phl,
                    const T* __restrict__ invd,
                    const int* __restrict__ bucket, const T* __restrict__ y,
                    const T* __restrict__ quad, const int* __restrict__ slot,
                    const T* __restrict__ par, const int* __restrict__ seg,
                    const double* __restrict__ G, int P, int F, int NY,
                    int PB, int NC, int NB, const int* __restrict__ scale,
                    unsigned long long* __restrict__ acc,
                    int* __restrict__ emax) {
  using F_ = Fn<T>;
  constexpr int R = YRun<T, DIM>::R;
  constexpr int WORDS = sizeof(T) == 4 ? 1 : 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> s(smem_raw, P, F, NY, PB, NB);
  const int k = blockIdx.x, p0 = blockIdx.y * PB, ck = blockIdx.z;
  const int np = min(PB, P - p0);
  const int nt = blockDim.x, tid = threadIdx.x;
  const int FY = F * NY, FPNY = s.FP * NY;
  const size_t u = slot[k];
  unsigned long long* acc_u = acc + u * WORDS * (size_t)s.LEN;
  const T* tab = SHM ? s.table() : ptab + u * (size_t)s.LEN;
  unsigned* low = SHM ? s.low() : nullptr;
  const Scale<T> sc_in(scale[3 * u], scale[3 * u + 2]);
  const Scale<T> sc_tail(scale[3 * u + 1], scale[3 * u + 2]);
  const bool measure = emax != nullptr;
  T big_in = T(0), big_tail = T(0);

  for (int i = tid; i < P; i += nt) s.mtg[i] = mtg[u * P + i];
  for (int i = tid; i < F + 2; i += nt) s.phl[i] = phl[i];
  for (int i = tid; i < F + 1; i += nt) s.invd[i] = invd[i];
  for (int i = tid; i < NB; i += nt) s.bucket[i] = bucket[i];
  for (int i = tid; i < NY; i += nt) s.y[i] = y[i];
  for (int i = tid; i < NG; i += nt) {
    s.qx[i] = quad[i];
    s.qw[i] = quad[NG + i];
    s.qz[i] = quad[2 * NG + i];
  }
  if (SHM)
    for (int i = tid; i < s.LEN; i += nt) {
      s.table()[i] = ptab[u * (size_t)s.LEN + i];
      low[i] = 0u;
    }

  const T* pk = par + (size_t)k * NPAR;
  const T pref = pk[0], m2 = pk[1];
  const T M = NBODY == 2 ? pk[4] : pk[2];
  const T yedge = F_::abs(y[NY - 1]);
  const T binv = T(NB) / F_::TWO_PI;
  const int NCH = (NY + R - 1) / R;
  const int n_out = np * F * NCH;
  const int Q = (NBODY == 2 ? 1 : NG) * NG;
  const int q0 = ck * Q / NC, q1 = (ck + 1) * Q / NC;
  const double* Gk = G + (size_t)seg[k] * P * FY;

  for (int base = 0; base < n_out; base += nt) {
    const int o = base + tid;
    const bool active = o < n_out;
    const int f = o % F, ch = (o / F) % NCH, pb = o / (F * NCH);
    const int j0 = ch * R;
    // the cotangent of the thread's outputs, x the task's prefactor
    T g[R];
#pragma unroll
    for (int j = 0; j < R; ++j)
      g[j] = active && j0 + j < NY
                 ? pref * (T)Gk[(size_t)(p0 + pb) * FY + f * NY + j0 + j]
                 : T(0);
    for (int is = q0 / NG; is * NG < q1; ++is) {
      const int v0 = max(q0 - is * NG, 0), v1 = min(q1 - is * NG, NG);
      const int nv = v1 - v0;
      T Es, ps, sw;
      if (NBODY == 2) {
        Es = pk[2];
        ps = pk[3];
        sw = T(1);
      } else {
        const T sm = pk[3], sp = pk[4], d = pk[5];
        const T sv = sm + (sp - sm) * (T(1) + quad[is]) / T(2);
        Es = (M * M + m2 - sv) / (T(2) * M);
        ps = F_::sqrt(max_(Es * Es - m2, T(1e-30)));
        sw = quad[NG + is] * F_::sqrt(F_::abs((sv - sm) * (sv - d))) / sv;
      }
      __syncthreads();      // staged, or the last node table is read
      for (int i = tid; i < np * nv * NG; i += nt) {
        const int b = i / (nv * NG), v = v0 + (i / NG) % nv;
        build_node(s, (b * NG + v) * NG + i % NG, pT[p0 + b], P, m2, Es, ps,
                   M, sw, v0);
      }
      __syncthreads();
      const T phif = s.phl[f + 1];
      for (int v = v0; v < v1; ++v) {
        // the run's Y stencils: left plane Ls[j], weight tY[j] of the
        // right one; bit j of mask where |Y| <= |y_max|
        int Ls[R];
        T tY[R];
        unsigned mask = 0;
        if (active) {
          const T a = s.qx[v] * s.nDY[pb];
          int L = -1;
#pragma unroll
          for (int j = 0; j < R; ++j) {
            Ls[j] = 0;
            tY[j] = T(0);
            if (DIM == 3 && j0 + j < NY) {
              const T Y = s.y[j0 + j] + a;
              if (F_::abs(Y) <= yedge) {
                L = y_stencil(s, L, Y);
                Ls[j] = L;
                tY[j] = (Y - s.y[L]) / (s.y[L + 1] - s.y[L]);
                mask |= 1u << j;
              }
            }
          }
          if (DIM == 2) mask = 1u;
        }
        for (int z = 0; z < NG; ++z) {
          const int n = (pb * NG + v) * NG + z;
          // the weights of both Phi solutions' evaluations: om[sg][j] =
          // g W exp(L)
          Corner<T> cc[2];
          T om[2][R];
          if (active && mask) {
            const T Ph = s.nPh[n], W = s.nW[n], W0 = s.nW0[n];
            const T W1 = s.nW1[n];
            const int row = s.nRow[n];
#pragma unroll
            for (int sg = 0; sg < 2; ++sg) {
              cc[sg] = corner(s, sg ? phif - Ph : phif + Ph, row, W0, W1,
                              binv);
#pragma unroll
              for (int j = 0; j < R; ++j) {
                om[sg][j] = T(0);
                if ((mask >> j) & 1u) {
                  T L;
                  if (DIM == 3) {
                    const T lo = plane(tab, cc[sg].q + Ls[j], NY, FPNY,
                                       cc[sg]);
                    const T hi = plane(tab, cc[sg].q + Ls[j] + 1, NY, FPNY,
                                       cc[sg]);
                    L = lo + tY[j] * (hi - lo);
                  } else {
                    L = plane(tab, cc[sg].q, 1, s.FP, cc[sg]);
                  }
                  om[sg][j] = g[j] * W * F_::exps(L);
                }
              }
            }
          }
          if (!(active && mask)) continue;
          const bool tl = s.nRow[n] == s.TAIL;      // past the MT grid
          const Scale<T>& sc = tl ? sc_tail : sc_in;
          T bg = T(0);
#pragma unroll
          for (int sg = 0; sg < 2; ++sg) {
            const Corner<T>& c = cc[sg];
            if (DIM == 2) {
              corner_terms<SHM>(acc_u, low, s.LEN, c.q, 1, s.FP, c.w00, c.w01,
                              c.w10, c.w11, om[sg][0], sc, measure, bg);
              continue;
            }
            // output j adds om (1 - tY) to plane Ls and om tY to plane
            // Ls + 1; where the next output's left plane is this one's
            // right plane (a run of consecutive stencils) the two are
            // summed before they are added
            int cp = -1;                 // the plane carried, its value
            T cv = T(0);
#pragma unroll
            for (int j = 0; j < R; ++j) {
              if (!((mask >> j) & 1u)) continue;
              const T a = om[sg][j];
              const T t = tY[j];
              T lo = a * (T(1) - t);
              if (cp == Ls[j]) {
                lo += cv;
              } else if (cp >= 0) {
                corner_terms<SHM>(acc_u, low, s.LEN, c.q + cp, NY, FPNY, c.w00,
                                c.w01, c.w10, c.w11, cv, sc, measure, bg);
              }
              corner_terms<SHM>(acc_u, low, s.LEN, c.q + Ls[j], NY, FPNY, c.w00,
                              c.w01, c.w10, c.w11, lo, sc, measure, bg);
              cp = Ls[j] + 1;
              cv = a * t;
            }
            if (cp >= 0)
              corner_terms<SHM>(acc_u, low, s.LEN, c.q + cp, NY, FPNY, c.w00,
                              c.w01, c.w10, c.w11, cv, sc, measure, bg);
          }
          if (measure) {
            if (tl) big_tail = max_(big_tail, bg);
            else big_in = max_(big_in, bg);
          }
        }
      }
    }
  }
  if (SHM) {
    __syncthreads();                // every term of the block is added
    for (int i = tid; i < s.LEN; i += nt) {
      const unsigned w = low[i];
      if (w != 0u) atomicAdd(acc_u + i, (unsigned long long)w);
    }
  }
  if (measure)
    for (int i = 0; i < 2; ++i) {
      const T b = i ? big_tail : big_in;
      if (b > T(0)) {
        int e;
        frexp((double)b, &e);       // b < 2^e
        atomicMax(emax + 2 * u + i, e);
      }
    }
}

// d_logdN[u, m, c, y] (and d_tc, d_ts): the fixed-point sums of slot u's
// padded column c + 1 and, for c = F - 1, column 0, for c = 0, column
// F + 1, back to floating point at the slot's scale
template <typename T>
__global__ void __launch_bounds__(FOLD_THREADS)
    finish_kernel(const unsigned long long* __restrict__ acc,
                  const int* __restrict__ scale, int P, int F, int NY,
                  T* __restrict__ dlog, T* __restrict__ dtc,
                  T* __restrict__ dts) {
  constexpr int WORDS = sizeof(T) == 4 ? 1 : 2;
  const int FP = F + 2;
  const long long per = (long long)(P + 2) * F * NY;
  const long long e = (long long)blockIdx.x * FOLD_THREADS + threadIdx.x;
  const int u = blockIdx.y;
  if (e >= per) return;
  const int row = (int)(e / ((long long)F * NY));     // P rows, tc, ts
  const int rest = (int)(e - (long long)row * F * NY);
  const int c = rest / NY, iy = rest - c * NY;
  const long long LEN = (long long)(P + 2) * FP * NY;
  const long long at = (long long)row * FP * NY;
  const long long a1 = at + (long long)(c + 1) * NY + iy;
  const long long a2 = c == F - 1 ? at + iy
                       : (c == 0 ? at + (long long)(F + 1) * NY + iy : -1);
  const unsigned long long* hi = acc + (size_t)u * WORDS * LEN;
  long long h = (long long)hi[a1];
  if (a2 >= 0) h += (long long)hi[a2];
  double v = (double)h;
  if (WORDS == 2) {
    const unsigned long long* lo = hi + LEN;
    long long l = (long long)lo[a1];
    if (a2 >= 0) l += (long long)lo[a2];
    v += ldexp((double)l, -scale[3 * u + 2]);
  }
  v = ldexp(v, -scale[3 * u + (row < P ? 0 : 1)]);
  if (row < P)
    dlog[((size_t)u * P + row) * F * NY + rest] = (T)v;
  else if (row == P)
    dtc[(size_t)u * F * NY + rest] = (T)v;
  else
    dts[(size_t)u * F * NY + rest] = (T)v;
}

template <typename T, int DIM>
size_t smem_bytes(int P, int F, int NY, int PB, int NB) {
  return Smem<T>(nullptr, P, F, NY, PB, NB).bytes(nullptr);
}

// the backward's blocking for a launch of K tasks: out = {PB, NC, shared
// memory a block, most phi buckets, route (1: the slot's table and low
// words in shared memory)}.  float32 takes the shared route where they,
// the node tables of a pT block and the buckets fit (PB from THREADS_SHM,
// lowered until they do); float64, and float32 where no PB fits, add to
// the device's words (PB from THREADS, as the forward's wave_blocking).
template <typename T>
int blocking(int nbody, int dim, int K, int P, int F, int NY, int NB,
             int* out) {
  if (K < 1 || P < 2 || F < 2 || NB < 0 || out == nullptr ||
      (nbody != 2 && nbody != 3) ||
      !((dim == 2 && NY == 1) || (dim == 3 && NY >= 2)))
    return cudaErrorInvalidValue;
  int dev = 0, n_sm = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc == 0)
    rc = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                     dev);
  if (rc != 0) return rc;
  const int R = dim == 2 ? YRun<T, 2>::R : YRun<T, 3>::R;
  const int runs = F * ((NY + R - 1) / R);
  auto balance = [&](int pb) {
    pb = max(1, min(P, pb));
    return (P + (P + pb - 1) / pb - 1) / ((P + pb - 1) / pb);
  };
  auto base = [&](int pb) {
    return dim == 2 ? smem_bytes<T, 2>(P, F, NY, pb, 0)
                    : smem_bytes<T, 3>(P, F, NY, pb, 0);
  };
  int PB = balance(THREADS / runs);
  int shm = 0;
  if (sizeof(T) == 4) {
    const size_t words = Smem<T>::shm_bytes((P + 2) * (F + 2) * NY);
    for (int pb = balance(THREADS_SHM / runs); pb >= 1;
         pb = pb > 1 ? balance(pb - 1) : 0) {
      if (Smem<T>::words_at(base(pb) + (size_t)NB * sizeof(int)) + words
          <= MAX_SMEM) {
        PB = pb;
        shm = 1;
        break;
      }
      if (pb == 1) break;
    }
  }
  const long long blocks = (long long)K * ((P + PB - 1) / PB);
  const long long pairs = (nbody == 2 ? 1 : NG) * NG;
  // four waves of blocks on the device route; one on the shared route,
  // whose blocks each copy the slot's table and zero and flush low words
  // (0.93 of its time against four waves over the main path's launches)
  const long long want = ((shm ? 1LL : 4LL) * n_sm + blocks - 1) / blocks;
  const size_t b0 = base(PB);
  const size_t with_nb = shm ? Smem<T>::words_at(b0 + (size_t)NB * sizeof(int))
                                   + Smem<T>::shm_bytes((P + 2) * (F + 2) * NY)
                             : b0 + (size_t)NB * sizeof(int);
  out[0] = PB;
  out[1] = (int)(want < pairs ? want : pairs);
  out[2] = with_nb > (size_t)0x7fffffff ? 0x7fffffff : (int)with_nb;
  out[3] = b0 > MAX_SMEM ? 0 : (int)((MAX_SMEM - b0) / sizeof(int));
  out[4] = shm;
  return cudaSuccess;
}

template <typename T, int DIM, int NBODY, bool SHM>
cudaError_t launch_kernel(dim3 grid, int threads, size_t smem,
                          cudaStream_t stream, const T* ptab, const T* mtg,
                          const T* pT, const T* phl, const T* invd,
                          const int* bucket, const T* y, const T* quad,
                          const int* slot, const T* par, const int* seg,
                          const double* G, int P, int F, int NY, int PB,
                          int NC, int NB, const int* scale,
                          unsigned long long* acc, int* emax) {
  auto kern = wave_bwd_kernel<T, DIM, NBODY, SHM>;
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return rc;
  kern<<<grid, threads, smem, stream>>>(ptab, mtg, pT, phl, invd, bucket, y,
                                        quad, slot, par, seg, G, P, F, NY,
                                        PB, NC, NB, scale, acc, emax);
  return cudaGetLastError();
}

// acc must hold zeros on entry: (U, LEN) words in float32, (U, 2, LEN) in
// float64; scale (U, 3) int32; emax (U, 2) int32 = INT_MIN, or null
template <typename T>
int launch_bwd(int nbody, int dim, const void* ptab_v, const void* mtg_v,
               const void* pT_v, const void* phl_v, const void* invd_v,
               const void* bucket_v, int NB, const void* y_v,
               const void* quad_v, int U, int P, int F, int NY,
               const void* slot_v, const void* par_v, const void* seg_v,
               int K, int NC, const void* G_v, const void* scale_v,
               void* acc_v, void* emax_v, void* dlog_v, void* dtc_v,
               void* dts_v, void* stream_v) {
  int bl[5];
  const int rc0 = blocking<T>(nbody, dim, K, P, F, NY, NB, bl);
  if (rc0 != cudaSuccess) return rc0;
  const int PB = bl[0];
  const size_t smem = (size_t)bl[2];
  const bool shm = bl[4] != 0;
  if (U < 1 || U > 65535 || NB < 1 || NC != bl[1] || smem > MAX_SMEM)
    return cudaErrorInvalidValue;
  const int R = dim == 2 ? YRun<T, 2>::R : YRun<T, 3>::R;
  const int outputs = PB * F * ((NY + R - 1) / R);
  const int threads = min(shm ? THREADS_SHM : THREADS,
                          (outputs + 31) / 32 * 32);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  const dim3 grid((unsigned)K, (unsigned)((P + PB - 1) / PB), (unsigned)NC);
  const T* ptab = static_cast<const T*>(ptab_v);
  const T* mtg = static_cast<const T*>(mtg_v);
  const T* pT = static_cast<const T*>(pT_v);
  const T* phl = static_cast<const T*>(phl_v);
  const T* invd = static_cast<const T*>(invd_v);
  const int* bucket = static_cast<const int*>(bucket_v);
  const T* y = static_cast<const T*>(y_v);
  const T* quad = static_cast<const T*>(quad_v);
  const int* slot = static_cast<const int*>(slot_v);
  const T* par = static_cast<const T*>(par_v);
  const int* seg = static_cast<const int*>(seg_v);
  const double* G = static_cast<const double*>(G_v);
  const int* scale = static_cast<const int*>(scale_v);
  unsigned long long* acc = static_cast<unsigned long long*>(acc_v);
  int* emax = static_cast<int*>(emax_v);
  cudaError_t rc = cudaSuccess;
#define IS3D_WAVE_BWD(D, N, SH)                                            \
  launch_kernel<T, D, N, SH>(grid, threads, smem, stream, ptab, mtg, pT,   \
                             phl, invd, bucket, y, quad, slot, par, seg, G, \
                             P, F, NY, PB, NC, NB, scale, acc, emax)
  if constexpr (sizeof(T) == 4) {
    if (shm) {
      if (dim == 2)
        rc = nbody == 2 ? IS3D_WAVE_BWD(2, 2, true)
                        : IS3D_WAVE_BWD(2, 3, true);
      else
        rc = nbody == 2 ? IS3D_WAVE_BWD(3, 2, true)
                        : IS3D_WAVE_BWD(3, 3, true);
    }
  }
  if (!shm) {
    if (dim == 2)
      rc = nbody == 2 ? IS3D_WAVE_BWD(2, 2, false)
                      : IS3D_WAVE_BWD(2, 3, false);
    else
      rc = nbody == 2 ? IS3D_WAVE_BWD(3, 2, false)
                      : IS3D_WAVE_BWD(3, 3, false);
  }
#undef IS3D_WAVE_BWD
  if (rc != cudaSuccess) return (int)rc;
  const long long per = (long long)(P + 2) * F * NY;
  const dim3 fgrid((unsigned)((per + FOLD_THREADS - 1) / FOLD_THREADS),
                   (unsigned)U);
  finish_kernel<T><<<fgrid, FOLD_THREADS, 0, stream>>>(
      acc, scale, P, F, NY, static_cast<T*>(dlog_v), static_cast<T*>(dtc_v),
      static_cast<T*>(dts_v));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// acc zeros on entry ((U, LEN) uint64 in float32, (U, 2, LEN) in float64),
// scale (U, 3) int32 (kernels/decays.py: wave_bwd_scale), emax (U, 2)
// int32 = INT_MIN or null
#define IS3D_DECAY_BWD_ENTRY(NAME, T)                                         \
  int NAME(int nbody, int dim, const void* ptab, const void* mtg,            \
           const void* pT, const void* phl, const void* invd,                \
           const void* bucket, int NB, const void* y, const void* quad,      \
           int U, int P, int F, int NY, const void* slot, const void* par,   \
           const void* seg, int K, int NC, const void* G, const void* scale, \
           void* acc, void* emax, void* dlog, void* dtc, void* dts,          \
           void* stream) {                                                   \
    return launch_bwd<T>(nbody, dim, ptab, mtg, pT, phl, invd, bucket, NB,   \
                         y, quad, U, P, F, NY, slot, par, seg, K, NC, G,     \
                         scale, acc, emax, dlog, dtc, dts, stream);          \
  }
IS3D_DECAY_BWD_ENTRY(is3d_decay_wave_bwd_f32, float)
IS3D_DECAY_BWD_ENTRY(is3d_decay_wave_bwd_f64, double)
#undef IS3D_DECAY_BWD_ENTRY

// the backward's blocking for a launch on the current card: out[5] = pT
// values a block, chunks of each task's (s, v) node pairs, shared memory a
// block, most phi buckets, route (1: the slot's words in shared memory);
// returns a CUDA error code
int is3d_decay_wave_bwd_blocking_f32(int nbody, int dim, int K, int P, int F,
                                     int NY, int NB, int* out) {
  return blocking<float>(nbody, dim, K, P, F, NY, NB, out);
}
int is3d_decay_wave_bwd_blocking_f64(int nbody, int dim, int K, int P, int F,
                                     int NY, int NB, int* out) {
  return blocking<double>(nbody, dim, K, P, F, NY, NB, out);
}

const char* is3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
