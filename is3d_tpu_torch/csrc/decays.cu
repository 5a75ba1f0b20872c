// Resonance-decay feed-down waves for Hopper (sm_90a), float32 and float64.
//
// Replaces the XLA bodies of is3d_tpu/kernels/decays.py::_two_body_wave
// (:583) and ::_three_body_wave (:600): for every task of a wave (one
// channel, one chosen daughter species, one parent slot) the feed-down
//
//     out[task, p, f, y] = pref * [sum_s ws] sum_v sum_zeta w(v, zeta)
//                          MT (dN(MT, Phi~ + phi_f, Y) + dN(MT, phi_f - Phi~, Y))
//
// with 12-point Gauss-Legendre rules in v (Y = y + v DeltaY), zeta (MT =
// MTbar + DeltaMT cos zeta) and, for 3-body tasks, the invariant mass s of
// the (2, 3) pair (Estar, pstar and the weight ws depend on s).  dN is the
// parent slot's patched log table, interpolated bilinearly in (MT, Phi)
// (and linearly in Y in 3+1D, exactly 0 beyond |y_max|) and exponentiated,
// or the exp(tc + ts MT) tail past the slot's MT grid.  The math is the
// gather form of the plain versions (kernels/decays.py:
// two_body_wave_plain, three_body_wave_plain), node for node.
//
// What bounds it on this card: SFU issue, not bytes.  A wave's inputs are
// the slots' tables (a 3+1D slot of 32 x 24 x 21 is 64.5 KB in float32)
// and the output is one (P, F, Y) block per task, against 288 evaluations
// per output value (3456 for 3-body); each evaluation takes one ex2 and,
// with planes shared between neighbouring rapidities, about 7 FP32
// operations in 3+1D (12 in 2+1D) (kernels/decays.py: wave_operations).
//
// Design:
//   * A block per (task, chunk of PB pT values, chunk of the task's (s, v)
//     node pairs: 12 for a 2-body task, 144 for a 3-body one).  It
//     stages the task's parent slot in shared memory -- the log table and
//     the tail tc/ts with their phi columns padded to F + 2 (column c holds
//     the slot's column (c - 1) mod F), float32 scaled by log2(e) so exp is
//     one ex2 -- and the grids.  wave_blocking, the one owner of the
//     blocking, picks PB and the (s, v) chunks from the wave's size and the
//     SM count, so the few tasks of the last waves still fill the card, and
//     reports them to the wrapper (kernels/decays.py: wave_blocking); each
//     (task, chunk) writes its own scratch row.
//   * The (v, zeta) nodes depend on (task, pT, s) only: every thread of the
//     block builds those of its chunk once per s into a shared table: Phi~, the weight ws
//     wz vw MT, and the (MT) stencil as one row offset and two weights --
//     inside the MT grid (1 - tM, tM) on rows iM and iM + 1, in the tail
//     (1, MT) on tc and ts -- so both are the same four-load bilinear form.
//   * Phi without a search or a branch on the wrap: the padded phi grid
//     phi[F-1] - 2 pi, phi[0..F-1], phi[0] + 2 pi has F + 1 ordinary
//     intervals; a uniform bucket table over [0, 2 pi) (at most one grid
//     point per bucket, kernels/decays.py: phi_cells; as many buckets as
//     the grid needs, up to what shared memory holds) gives the interval of
//     a wrapped angle with one load and one compare.  Interval, phi weight
//     and the four bilinear weights are formed once per (node, phi_f, +-).
//   * A thread owns (pT, phi_f) and a run of YR consecutive rapidities
//     (3+1D; all 21 in float32).  Per v it forms each output's Y stencil
//     (Y = y_j + v DeltaY, a sorted walk over the y grid); per (node, +-)
//     it walks its run keeping the last interpolated rapidity plane in a
//     register, so neighbouring outputs share it: a plane is 4 shared loads
//     at immediate offsets and 4 FMAs.  Where the run's stencils are not
//     consecutive (a y grid that is not uniform) a second loop forms each
//     stencil's planes and still reuses the plane where they overlap.
//     Outputs with |Y| > |y_max| are summed apart per v and dropped, so
//     they add exactly 0.
//   * float32 takes ex2.approx on the log2(e)-scaled table (+inf -> inf,
//     -inf -> 0), the accurate acosf, logf, coshf, sinhf for the nodes;
//     float64 keeps IEEE exp on the unscaled table.
//   * fold_kernel adds each target row's (task, chunk) rows -- its tasks
//     in schedule order, each task's chunks in ascending order -- into
//     the float64 accumulator of the spectra (a thread per target value);
//     no atomics, so two launches give identical bits.

#include <cuda_runtime.h>

namespace {

constexpr int NG = 12;             // Gauss-Legendre points in v, zeta, s
constexpr int NODES = NG * NG;     // (v, zeta) nodes per (task, pT[, s])
constexpr int THREADS = 256;       // most threads a block
constexpr int NPAR = 6;            // parameters per task
constexpr int FOLD_THREADS = 256;
constexpr size_t MAX_SMEM = 232448;

template <typename T>
struct Fn;

template <>
struct Fn<float> {
  static constexpr float TWO_PI = 6.283185307179586f;
  static constexpr float SCALE = 1.4426950408889634f;   // log2(e)
  // exp of a table value scaled by SCALE
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
  static constexpr double SCALE = 1.0;
  static __device__ __forceinline__ double exps(double x) { return ::exp(x); }
  static __device__ __forceinline__ double sqrt(double x) { return ::sqrt(x); }
  static __device__ __forceinline__ double log(double x) { return ::log(x); }
  static __device__ __forceinline__ double cosh(double x) { return ::cosh(x); }
  static __device__ __forceinline__ double sinh(double x) { return ::sinh(x); }
  static __device__ __forceinline__ double acos(double x) { return ::acos(x); }
  static __device__ __forceinline__ double abs(double x) { return fabs(x); }
};

// rapidities a thread owns in 3+1D
template <typename T, int DIM>
struct YRun {
  static constexpr int R = DIM == 2 ? 1 : (sizeof(T) == 4 ? 21 : 7);
};

template <typename T>
__device__ __forceinline__ T max_(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T min_(T a, T b) { return a < b ? a : b; }

// first index i of the sorted a[0..n) with a[i] >= x (torch.searchsorted,
// right=False), n if none
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

// The shared-memory layout of a block (T arrays first, then ints).  The
// padded table, tc and ts are contiguous, rows FP * NY apart, with G
// elements before and after: a run's planes past the y grid (outputs that
// are dropped) read there.
template <typename T>
struct Smem {
  int FP, NY, G, NB;
  T *tab, *tc, *mtg, *phl, *invd, *y, *qx, *qw, *qz, *nDY;
  T *nPh, *nW, *nW0, *nW1;
  int *nRow, *bucket;

  __host__ __device__ Smem(unsigned char* raw, int P, int F, int NY_, int R,
                           int PB, int NB_)
      : FP(F + 2), NY(NY_), G(R + 2), NB(NB_) {
    T* p = reinterpret_cast<T*>(raw);
    tab = p + G;
    tc = tab + (size_t)P * FP * NY;
    mtg = tc + 2 * FP * NY + G;
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

  __host__ __device__ size_t bytes() const {
    return reinterpret_cast<const unsigned char*>(bucket + NB)
           - reinterpret_cast<const unsigned char*>(tab - G);
  }
};

// the (v, zeta) node n of pT value pb of the block at one s (Es, ps, its
// weight sw): Phi~, the weight sw wz vw MT, the MT stencil as a row offset
// into the padded table (iM's row; tc's inside the tail) and its two
// weights (1 - tM, tM; in the tail 1 and MT on tc and ts); node (v_dy, 0)
// also keeps DeltaY
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
  // cancellation-free forms (kernels/decays.py, _kinematics)
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
  s.nRow[n] = inside ? (iR - 1) * s.FP * s.NY : (int)(s.tc - s.tab);
  if (v == v_dy && z == 0) s.nDY[pb] = DY;
}

// One Phi solution of a node: the table offset of its (row, left column)
// corner and the four bilinear weights of the corners q, q + NY (right
// column), q + FP NY (next row, or ts), q + FP NY + NY
template <typename T>
struct Corner {
  int q;
  T w00, w01, w10, w11;
};

template <typename T>
__device__ __forceinline__ Corner<T> corner(const Smem<T>& s, T Phi, int row,
                                            T W0, T W1, T binv) {
  using F_ = Fn<T>;
  // jnp.mod / torch.remainder: Phi = phi_f +- Phi~ lies in [-pi, 3 pi] on
  // a phi grid in [0, 2 pi), which the host checks; there one add or
  // subtract of 2 pi gives the same bits
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

// the interpolated log dN of one rapidity plane at corner offset q
template <typename T>
__device__ __forceinline__ T plane(const T* tab, int q, int NY, int FPNY,
                                   const Corner<T>& c) {
  return tab[q] * c.w00 + tab[q + NY] * c.w01 + tab[q + FPNY] * c.w10
         + tab[q + FPNY + NY] * c.w11;
}

// the left plane of Y's stencil on the y grid (the plain version's
// clamped torch.searchsorted): a search for the first Y of a run (Ls < 0),
// then a walk up from the last one (the run's Y increase)
template <typename T>
__device__ __forceinline__ int y_stencil(const Smem<T>& s, int Ls, T Y) {
  if (Ls < 0) return min(max(lower_bound(s.y, s.NY, Y), 1), s.NY - 1) - 1;
  while (Ls < s.NY - 2 && s.y[Ls + 1] < Y) ++Ls;
  return Ls;
}

// One s node of the block: add the 3+1D feed-down of output (pb, f, run
// j0 .. j0 + R) over v in [v0, v1) to acc[0..R) from the node table built
// for that s
template <typename T, int R>
__device__ __forceinline__ void eval_3d(const Smem<T>& s, int pb, int f,
                                        int j0, int v0, int v1, T yedge,
                                        T binv, T* acc) {
  using F_ = Fn<T>;
  const int NY = s.NY, FPNY = s.FP * NY;
  const T phif = s.phl[f + 1];
  for (int v = v0; v < v1; ++v) {
    // the run's Y stencils: left plane L_j and the weight tY[j] of plane
    // L_j + 1; bit j of mask where |Y| <= |y_max|; regular where L_j = c +
    // j for every such j
    const T a = s.qx[v] * s.nDY[pb];
    T tY[R];
    unsigned mask = 0;
    bool regular = true;
    int c = 0, Ls = -1;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      tY[j] = T(0);
      if (j0 + j < NY) {
        const T Y = s.y[j0 + j] + a;
        if (F_::abs(Y) <= yedge) {
          Ls = y_stencil(s, Ls, Y);
          tY[j] = (Y - s.y[Ls]) / (s.y[Ls + 1] - s.y[Ls]);
          if (mask == 0) c = Ls - j;
          else if (Ls != c + j) regular = false;
          mask |= 1u << j;
        }
      }
    }
    if (mask == 0) continue;
    T part[R];
#pragma unroll
    for (int j = 0; j < R; ++j) part[j] = T(0);
    const int n0 = (pb * NG + v) * NG;
    if (regular) {
      for (int z = 0; z < NG; ++z) {
        const int n = n0 + z;
        const T Ph = s.nPh[n], W = s.nW[n], W0 = s.nW0[n], W1 = s.nW1[n];
        const int row = s.nRow[n];
#pragma unroll
        for (int sg = 0; sg < 2; ++sg) {
          const Corner<T> cc =
              corner(s, sg ? phif - Ph : phif + Ph, row, W0, W1, binv);
          const T* t0 = s.tab + cc.q + c;
          T lo = plane(t0, 0, NY, FPNY, cc);
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const T hi = plane(t0, j + 1, NY, FPNY, cc);
            part[j] += W * F_::exps(lo + tY[j] * (hi - lo));
            lo = hi;
          }
        }
      }
    } else {
      for (int z = 0; z < NG; ++z) {
        const int n = n0 + z;
        const T Ph = s.nPh[n], W = s.nW[n], W0 = s.nW0[n], W1 = s.nW1[n];
        const int row = s.nRow[n];
#pragma unroll
        for (int sg = 0; sg < 2; ++sg) {
          const Corner<T> cc =
              corner(s, sg ? phif - Ph : phif + Ph, row, W0, W1, binv);
          // the stencils again (this path is rare): a plane is formed once
          // where one output's right plane is the next one's left
          int Ls = -1, Lp = -1;
          T hi = T(0);
#pragma unroll
          for (int j = 0; j < R; ++j) {
            if (!((mask >> j) & 1u)) continue;
            Ls = y_stencil(s, Ls, s.y[j0 + j] + a);
            T lo = hi;
            if (Ls != Lp) lo = plane(s.tab, cc.q + Ls, NY, FPNY, cc);
            hi = plane(s.tab, cc.q + Ls + 1, NY, FPNY, cc);
            Lp = Ls + 1;
            part[j] += W * F_::exps(lo + tY[j] * (hi - lo));
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j)
      if ((mask >> j) & 1u) acc[j] += part[j];
  }
}

// One s node of the block in 2+1D: add the feed-down of output (pb, f)
// over v in [v0, v1)
template <typename T>
__device__ __forceinline__ void eval_2d(const Smem<T>& s, int pb, int f,
                                        int v0, int v1, T binv, T* acc) {
  using F_ = Fn<T>;
  const int FP = s.FP;
  const T phif = s.phl[f + 1];
  T sum = T(0);
  for (int n = (pb * NG + v0) * NG; n < (pb * NG + v1) * NG; ++n) {
    const T Ph = s.nPh[n], W = s.nW[n], W0 = s.nW0[n], W1 = s.nW1[n];
    const int row = s.nRow[n];
#pragma unroll
    for (int sg = 0; sg < 2; ++sg) {
      const Corner<T> cc =
          corner(s, sg ? phif - Ph : phif + Ph, row, W0, W1, binv);
      sum += W * F_::exps(plane(s.tab, cc.q, 1, FP, cc));
    }
  }
  acc[0] += sum;
}

template <typename T, int DIM, int NBODY>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 4 ? 2 : 1)
    wave_kernel(const T* __restrict__ logdN, const T* __restrict__ tc,
                const T* __restrict__ ts, const T* __restrict__ mtg,
                const T* __restrict__ pT, const T* __restrict__ phl,
                const T* __restrict__ invd, const int* __restrict__ bucket,
                const T* __restrict__ y, const T* __restrict__ quad,
                const int* __restrict__ slot, const T* __restrict__ par,
                int P, int F, int NY, int PB, int NC, int NB,
                T* __restrict__ out) {
  using F_ = Fn<T>;
  constexpr int R = YRun<T, DIM>::R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> s(smem_raw, P, F, NY, R, PB, NB);
  const int k = blockIdx.x, p0 = blockIdx.y * PB, ck = blockIdx.z;
  const int np = min(PB, P - p0);
  const int nt = blockDim.x, tid = threadIdx.x;
  const int FY = F * NY, FPNY = s.FP * NY, PFY = P * FY;
  const size_t u = slot[k];

  // the slot, scaled and with its phi columns padded: column c of the
  // staged table holds column (c - 1) mod F
  for (int i = tid; i < P * FPNY; i += nt) {
    const int m = i / FPNY, r = i - m * FPNY, c = r / NY, iy = r - c * NY;
    const int oc = c == 0 ? F - 1 : (c == F + 1 ? 0 : c - 1);
    s.tab[i] = F_::SCALE * logdN[u * PFY + (size_t)(m * F + oc) * NY + iy];
  }
  for (int i = tid; i < FPNY; i += nt) {
    const int c = i / NY, iy = i - c * NY;
    const int oc = c == 0 ? F - 1 : (c == F + 1 ? 0 : c - 1);
    s.tc[i] = F_::SCALE * tc[u * FY + oc * NY + iy];
    s.tc[FPNY + i] = F_::SCALE * ts[u * FY + oc * NY + iy];
  }
  for (int i = tid; i < s.G; i += nt) {
    s.tab[i - s.G] = T(0);
    s.tc[2 * FPNY + i] = T(0);
  }
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

  const T* pk = par + (size_t)k * NPAR;
  const T pref = pk[0], m2 = pk[1];
  const T M = NBODY == 2 ? pk[4] : pk[2];
  const T yedge = F_::abs(y[NY - 1]);
  const T binv = T(NB) / F_::TWO_PI;
  const int NCH = (NY + R - 1) / R;
  const int n_out = np * F * NCH;
  // this block's chunk [q0, q1) of the task's (s, v) pairs, q = s NG + v
  const int Q = (NBODY == 2 ? 1 : NG) * NG;
  const int q0 = ck * Q / NC, q1 = (ck + 1) * Q / NC;

  // one pass unless F * (runs per pT) is above the block's threads
  for (int base = 0; base < n_out; base += nt) {
    const int o = base + tid;
    const bool active = o < n_out;
    const int f = o % F, ch = (o / F) % NCH, pb = o / (F * NCH);
    T acc[R];
#pragma unroll
    for (int j = 0; j < R; ++j) acc[j] = T(0);
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
      if (!active) continue;
      if constexpr (DIM == 3)
        eval_3d<T, R>(s, pb, f, ch * R, v0, v1, yedge, binv, acc);
      else
        eval_2d(s, pb, f, v0, v1, binv, acc);
    }
    if (!active) continue;
    T* o_ = out + ((size_t)k * NC + ck) * PFY + (size_t)(p0 + pb) * FY
            + f * NY + ch * R;
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (ch * R + j < NY) o_[j] = pref * acc[j];
  }
}

// acc[target[t], e] += the scratch rows of target t at e, in float64: for
// j in [tstart[t], tstart[t+1]) the rows order[j] NC + 0 .. NC - 1, in
// that order
template <typename T>
__global__ void __launch_bounds__(FOLD_THREADS)
    fold_kernel(const T* __restrict__ scratch, const int* __restrict__ order,
                const int* __restrict__ target,
                const int* __restrict__ tstart, int NC, long long PFY,
                double* __restrict__ acc) {
  const long long e = (long long)blockIdx.x * FOLD_THREADS + threadIdx.x;
  const int t = blockIdx.y;
  if (e >= PFY) return;
  double sum = 0.0;
  for (int j = tstart[t]; j < tstart[t + 1]; ++j)
    for (int c = 0; c < NC; ++c)
      sum += (double)scratch[((size_t)order[j] * NC + c) * PFY + e];
  acc[(size_t)target[t] * PFY + e] += sum;
}

template <typename T, int DIM, int NBODY>
cudaError_t launch_kernel(dim3 grid, int threads, size_t smem,
                          cudaStream_t stream, const T* logdN, const T* tc,
                          const T* ts, const T* mtg, const T* pT,
                          const T* phl, const T* invd, const int* bucket,
                          const T* y, const T* quad, const int* slot,
                          const T* par, int P, int F, int NY, int PB,
                          int NC, int NB, T* out) {
  auto kern = wave_kernel<T, DIM, NBODY>;
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return rc;
  kern<<<grid, threads, smem, stream>>>(logdN, tc, ts, mtg, pT, phl, invd,
                                        bucket, y, quad, slot, par, P, F, NY,
                                        PB, NC, NB, out);
  return cudaGetLastError();
}

template <typename T, int DIM>
size_t smem_bytes(int P, int F, int NY, int PB, int NB) {
  return Smem<T>(nullptr, P, F, NY, YRun<T, DIM>::R, PB, NB).bytes();
}

// The wave kernel's blocking for a launch of K tasks on the current card,
// the one owner of it: out = {PB pT values a block, NC chunks of each
// task's (s, v) node pairs, dynamic shared memory a block with an NB-bucket
// phi table, most buckets the shared memory takes}.  A block takes as many
// pT values as its threads hold runs of (phi, y) outputs, in balanced
// chunks; the node pairs (12 for a 2-body task, 144 for a 3-body one) go
// in as many chunks as the wave needs for 4 blocks an SM.
template <typename T>
int wave_blocking(int nbody, int dim, int K, int P, int F, int NY, int NB,
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
  int PB = max(1, min(P, THREADS / runs));
  PB = (P + (P + PB - 1) / PB - 1) / ((P + PB - 1) / PB);
  const long long blocks = (long long)K * ((P + PB - 1) / PB);
  const long long pairs = (nbody == 2 ? 1 : NG) * NG;
  const long long want = (4LL * n_sm + blocks - 1) / blocks;
  const size_t base = dim == 2 ? smem_bytes<T, 2>(P, F, NY, PB, 0)
                               : smem_bytes<T, 3>(P, F, NY, PB, 0);
  const size_t with_nb = base + (size_t)NB * sizeof(int);
  out[0] = PB;
  out[1] = (int)(want < pairs ? want : pairs);
  out[2] = with_nb > (size_t)0x7fffffff ? 0x7fffffff : (int)with_nb;
  out[3] = base > MAX_SMEM ? 0 : (int)((MAX_SMEM - base) / sizeof(int));
  return cudaSuccess;
}

template <typename T>
int launch_wave(int nbody, int dim, const void* logdN_v, const void* tc_v,
                const void* ts_v, const void* mtg_v, const void* pT_v,
                const void* phl_v, const void* invd_v, const void* bucket_v,
                int NB, const void* y_v, const void* quad_v, int U, int P,
                int F, int NY, const void* slot_v, const void* par_v, int K,
                int NC, const void* order_v, const void* target_v,
                const void* tstart_v, int n_target, void* scratch_v,
                void* acc_v, void* stream_v) {
  // the scratch rows (K x NC) must be those of the blocking
  int bl[4];
  int rc0 = wave_blocking<T>(nbody, dim, K, P, F, NY, NB, bl);
  if (rc0 != cudaSuccess) return rc0;
  const int PB = bl[0];
  const size_t smem = (size_t)bl[2];
  if (U < 1 || n_target < 1 || n_target > 65535 || NB < 1 || NC != bl[1] ||
      smem > MAX_SMEM)
    return cudaErrorInvalidValue;
  const int R = dim == 2 ? YRun<T, 2>::R : YRun<T, 3>::R;
  const int outputs = PB * F * ((NY + R - 1) / R);
  const int threads = min(THREADS, (outputs + 31) / 32 * 32);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  const dim3 grid((unsigned)K, (unsigned)((P + PB - 1) / PB), (unsigned)NC);
  const T* logdN = static_cast<const T*>(logdN_v);
  const T* tc = static_cast<const T*>(tc_v);
  const T* ts = static_cast<const T*>(ts_v);
  const T* mtg = static_cast<const T*>(mtg_v);
  const T* pT = static_cast<const T*>(pT_v);
  const T* phl = static_cast<const T*>(phl_v);
  const T* invd = static_cast<const T*>(invd_v);
  const int* bucket = static_cast<const int*>(bucket_v);
  const T* y = static_cast<const T*>(y_v);
  const T* quad = static_cast<const T*>(quad_v);
  const int* slot = static_cast<const int*>(slot_v);
  const T* par = static_cast<const T*>(par_v);
  T* scratch = static_cast<T*>(scratch_v);
  cudaError_t rc;
#define IS3D_WAVE(D, N)                                                     \
  launch_kernel<T, D, N>(grid, threads, smem, stream, logdN, tc, ts, mtg,  \
                         pT, phl, invd, bucket, y, quad, slot, par, P, F,  \
                         NY, PB, NC, NB, scratch)
  if (dim == 2)
    rc = nbody == 2 ? IS3D_WAVE(2, 2) : IS3D_WAVE(2, 3);
  else
    rc = nbody == 2 ? IS3D_WAVE(3, 2) : IS3D_WAVE(3, 3);
#undef IS3D_WAVE
  if (rc != cudaSuccess) return (int)rc;
  const long long PFY = (long long)P * F * NY;
  const dim3 fgrid((unsigned)((PFY + FOLD_THREADS - 1) / FOLD_THREADS),
                   (unsigned)n_target);
  fold_kernel<T><<<fgrid, FOLD_THREADS, 0, stream>>>(
      scratch, static_cast<const int*>(order_v),
      static_cast<const int*>(target_v), static_cast<const int*>(tstart_v),
      NC, PFY, static_cast<double*>(acc_v));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define IS3D_DECAY_ENTRY(NAME, T)                                             \
  int NAME(int nbody, int dim, const void* logdN, const void* tc,            \
           const void* ts, const void* mtg, const void* pT, const void* phl, \
           const void* invd, const void* bucket, int NB, const void* y,      \
           const void* quad, int U, int P, int F, int NY, const void* slot,  \
           const void* par, int K, int NC, const void* order,               \
           const void* target, const void* tstart, int n_target,             \
           void* scratch, void* acc, void* stream) {                         \
    return launch_wave<T>(nbody, dim, logdN, tc, ts, mtg, pT, phl, invd,     \
                          bucket, NB, y, quad, U, P, F, NY, slot, par, K,    \
                          NC, order, target, tstart, n_target, scratch, acc, \
                          stream);                                           \
  }
IS3D_DECAY_ENTRY(is3d_decay_wave_f32, float)
IS3D_DECAY_ENTRY(is3d_decay_wave_f64, double)
#undef IS3D_DECAY_ENTRY

// the wave kernel's blocking for a launch on the current card: out[4] = pT
// values a block, chunks of each task's (s, v) node pairs, shared memory a
// block, most phi buckets; returns a CUDA error code
int is3d_decay_wave_blocking_f32(int nbody, int dim, int K, int P, int F,
                                 int NY, int NB, int* out) {
  return wave_blocking<float>(nbody, dim, K, P, F, NY, NB, out);
}
int is3d_decay_wave_blocking_f64(int nbody, int dim, int K, int P, int F,
                                 int NY, int NB, int* out) {
  return wave_blocking<double>(nbody, dim, K, P, F, NY, NB, out);
}

const char* is3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
