// Fast ASCII numeric table parser for freeze-out surface files.
//
// Native-runtime counterpart of the reference's C++ readers
// (src/cpp/readindata.cpp, src/cpp/Table.cpp): the reference streams
// whitespace-separated doubles through ifstream>>; this parser tokenizes a
// whole memory buffer with strtod, which is ~an order of magnitude faster
// for the multi-GB surfaces of production (3+1)D hydro runs.
//
// Contract: buf must be NUL-terminated at buf[len] (CPython bytes always
// are) -- strtod may read past `len` otherwise.  Every numeric token must
// end at whitespace, '#', or the buffer end; parse_doubles enforces this
// so a token like "2abc" is rejected (-1) instead of silently splitting.
//
// Exposed via ctypes (no pybind11 in this environment); see build.py.

#include <cstdlib>
#include <cstring>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <locale.h>

// strtod and snprintf %e are LC_NUMERIC-sensitive: an embedding process
// with e.g. a de_DE numeric locale would stop parsing at '.' (silently
// disabling the fast path) or emit comma decimal separators in the writer.
// Both halves run under a forced per-thread C locale (uselocale is
// thread-local).
static locale_t c_numeric_locale()
{
    static locale_t loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
    return loc;
}

// Skip whitespace and '#'-to-end-of-line comments (matches the tolerant
// Python loader).
static inline const char* skip_sep(const char* p, const char* end)
{
    while (p < end) {
        if (*p == '#') {
            while (p < end && *p != '\n') ++p;
        } else if (isspace((unsigned char)*p)) {
            ++p;
        } else {
            break;
        }
    }
    return p;
}

extern "C" {

// Parse up to max_out doubles from buf[0..len); returns the number parsed,
// or -1 if a token failed to parse or tokens remain beyond max_out.
long long parse_doubles(const char* buf, long long len, double* out,
                        long long max_out)
{
    const char* p = buf;
    const char* end = buf + len;
    long long n = 0;
    locale_t prev = uselocale(c_numeric_locale());
    while ((p = skip_sep(p, end)) < end) {
        if (n >= max_out) { n = -1; break; }  // more tokens than promised
        char* next = nullptr;
        double v = strtod(p, &next);
        if (next == p ||                      // not a number
            (next < end && !isspace((unsigned char)*next) &&
             *next != '#')) {                 // token has trailing garbage
            n = -1;
            break;
        }
        out[n++] = v;
        p = next;
    }
    uselocale(prev);
    return n;
}

// Count whitespace/comment-separated tokens WITHOUT parsing them (a pure
// scan, ~2x cheaper than a strtod pass over multi-GB buffers); numeric
// validation is parse_doubles' job -- on any non-numeric token the counts
// disagree or parse returns -1, and the caller falls back.
long long count_doubles(const char* buf, long long len)
{
    const char* p = buf;
    const char* end = buf + len;
    long long n = 0;
    while ((p = skip_sep(p, end)) < end) {
        ++n;
        while (p < end && !isspace((unsigned char)*p) && *p != '#') ++p;
    }
    return n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fast "%.8e" formatter.
//
// glibc snprintf("%.8e") measures ~850 ns/value on this host -- at a
// full-SMASH 444-species 3+1D results tree (~43M formatted values) that is
// pure formatting cost on the pipeline's critical path.  This formatter
// produces byte-identical output ~10x faster by scaling the value into
// [1e8, 1e9) in 80-bit long double (64-bit mantissa: absolute scaling
// error <= ~1e9 * 2^-62 ~ 2.4e-10) and emitting the 9 correctly-rounded
// significant digits directly.  Whenever the scaled value sits within
// 1e-6 of a rounding tie or cannot be trusted (inf/nan, range-correction
// runaway), it returns -1 and the caller falls back to snprintf -- so the
// output is bit-for-bit what glibc (and CPython, which agrees with glibc
// on every finite double incl. round-half-even exact ties) would print.
// ---------------------------------------------------------------------------

#include <cmath>
#include <cstdint>

static const int P10_LO = -350, P10_HI = 350;

// Split power-of-ten table: 10^k = hi + lo with hi the correctly-rounded
// double and lo the (exact) residual of the long-double value, giving an
// effectively ~85-bit product below via a two-term expansion -- SSE double
// arithmetic throughout (the pure x87 long-double pipeline measured ~2x
// slower per value on this host).
struct P10Split {
    double hi[P10_HI - P10_LO + 1];
    double lo[P10_HI - P10_LO + 1];
};

static P10Split p10_build()
{
    P10Split t;
    for (int k = P10_LO; k <= P10_HI; ++k) {
        long double v = powl(10.0L, (long double)k);
        t.hi[k - P10_LO] = (double)v;
        t.lo[k - P10_LO] = (double)(v - (long double)(double)v);
    }
    return t;
}

static const P10Split* p10_table()
{
    // C++11 magic static: thread-safe one-time init (ctypes drops the
    // GIL, so concurrent writer threads DO reach this together; a
    // hand-rolled bool guard would race on a half-filled table)
    static const P10Split tab = p10_build();
    return &tab;
}

static const char DIG2[201] =
    "00010203040506070809101112131415161718192021222324"
    "25262728293031323334353637383940414243444546474849"
    "50515253545556575859606162636465666768697071727374"
    "75767778798081828384858687888990919293949596979899";

// Format v as "%.8e" into out (no terminator); returns the length, or -1
// to request the snprintf fallback.
static inline int fmt_e8_fast(double v, char* out)
{
    uint64_t bits;
    memcpy(&bits, &v, 8);
    int neg = (int)(bits >> 63);
    uint64_t ab = bits & 0x7fffffffffffffffULL;
    char* p = out;
    if (neg) *p++ = '-';
    if (ab == 0) {                                // +-0.0
        memcpy(p, "0.00000000e+00", 14);
        return (int)(p - out) + 14;
    }
    if (ab >= 0x7ff0000000000000ULL) return -1;   // inf / nan
    double av = fabs(v);
    int E = (int)floor(ilogb(av) * 0.301029995663981195);
    // |E| > 290 (incl. all subnormals): the split-table product would
    // need out-of-double-range powers; snprintf handles these rare values
    if (E < -290 || E > 290) return -1;
    const P10Split* tab = p10_table();
    int idx = (8 - E) - P10_LO;
    // two-term product: av*hi rounds at ~1.1e-16 rel, av*lo restores the
    // table residual -> |X - exact| <= ~2e-7 absolute at the 1e9 scale,
    // far inside the 2e-4 tie window below
    double X = av * tab->hi[idx] + av * tab->lo[idx];
    for (int guard = 0; X < 1e8 || X >= 1e9; ++guard) {
        E += (X >= 1e9) ? 1 : -1;
        if (guard >= 3 || E < -292 || E > 292) return -1;
        idx = (8 - E) - P10_LO;
        X = av * tab->hi[idx] + av * tab->lo[idx];
    }
    double fl = floor(X);
    double frac = X - fl;
    if (fabs(frac - 0.5) < 2e-4) return -1;       // near a rounding tie
    uint64_t N = (uint64_t)fl + (frac > 0.5);
    if (N >= 1000000000ULL) { N = 100000000ULL; ++E; }  // 9.99..9 carry
    uint32_t r = (uint32_t)(N % 100000000ULL);
    *p++ = (char)('0' + (unsigned)(N / 100000000ULL));
    *p++ = '.';
    uint32_t hi = r / 10000, lo = r % 10000;
    memcpy(p + 0, DIG2 + (hi / 100) * 2, 2);
    memcpy(p + 2, DIG2 + (hi % 100) * 2, 2);
    memcpy(p + 4, DIG2 + (lo / 100) * 2, 2);
    memcpy(p + 6, DIG2 + (lo % 100) * 2, 2);
    p += 8;
    *p++ = 'e';
    *p++ = E < 0 ? '-' : '+';
    unsigned aE = (unsigned)(E < 0 ? -E : E);
    if (aE >= 100) { *p++ = (char)('0' + aE / 100); aE %= 100; }
    memcpy(p, DIG2 + aE * 2, 2);
    p += 2;
    return (int)(p - out);
}

// Append an (nrows x ncols) table of doubles to `path` as tab-separated
// "%.8e" rows, with one extra blank line after every `blank_every` rows
// (0 = never) and an optional header string written verbatim first.
// Byte-identical to the Python fallback in writers._write_sci_table (both
// produce correctly-rounded shortest-%.8e decimals; glibc printf and
// CPython float formatting agree on every finite double).  This is the
// native-runtime counterpart of the reference's spectra writers
// (emissionfunction.cpp:381-827, `scientific << setprecision(8)`): the
// per-value Python f-string loop measured ~240 s for a full-SMASH
// (444-species) 3+1D results tree -- pure host formatting cost, which
// this parallel formatter removes from the pipeline's critical path.
// Returns nrows on success, -1 on I/O error.
extern "C"
long long write_sci_table(const char* path, int append, const char* header,
                          const double* data, long long nrows, int ncols,
                          long long blank_every)
{
    FILE* f = fopen(path, append ? "ab" : "wb");
    if (!f) return -1;
    setvbuf(f, nullptr, _IOFBF, 1 << 20);
    if (header && header[0] &&
        fputs(header, f) == EOF) { fclose(f); return -1; }

    const long long CH = 1 << 16;
    const int W = 20 * (ncols > 0 ? ncols : 1) + 8;  // %.8e is <= 16 chars
    char* buf = (char*)malloc((size_t)CH * W);
    // per-column direct-mapped memo of formatted values: the coordinate
    // columns of grid-shaped tables either repeat in long runs (y, phip)
    // or cycle through a small set (pT), so almost every non-value column
    // is a hash + memcpy instead of a format.  The last column (the data)
    // is never memoized.
    struct FmtMemo { uint64_t bits; int len; char s[24]; };
    const int MB = 64;
    FmtMemo* memo = ncols > 1
        ? (FmtMemo*)malloc((size_t)(ncols - 1) * MB * sizeof(FmtMemo))
        : nullptr;
    if (!buf || (ncols > 1 && !memo)) {
        free(buf); free(memo); fclose(f); return -1;
    }
    for (long long i = 0; i < (long long)(ncols - 1) * MB; ++i)
        memo[i].len = -1;
    long long written = 0;
    for (long long s0 = 0; s0 < nrows; s0 += CH) {
        long long m = nrows - s0 < CH ? nrows - s0 : CH;
        // contiguous fill + ONE fwrite per chunk (a per-row fwrite
        // measured ~50 ns/row of pure call overhead); each row uses at
        // most W bytes, so m rows cannot overflow the CH*W buffer
        char* p = buf;
        bool bad = false;
        locale_t prev = uselocale(c_numeric_locale());
        for (long long i = 0; i < m && !bad; ++i) {
            const double* row = data + (size_t)(s0 + i) * ncols;
            for (int c = 0; c < ncols; ++c) {
                int k;
                if (c < ncols - 1) {
                    uint64_t b;
                    memcpy(&b, &row[c], 8);
                    FmtMemo* e = memo + (size_t)c * MB
                                 + ((b * 2654435761ULL) >> 58);
                    if (e->len > 0 && e->bits == b) {
                        memcpy(p, e->s, e->len);
                        k = e->len;
                    } else {
                        k = fmt_e8_fast(row[c], p);
                        if (k < 0)
                            k = snprintf(p, 20, "%.8e", row[c]);
                        if (k > 0 && k <= 20) {
                            e->bits = b;
                            e->len = k;
                            memcpy(e->s, p, k);
                        }
                    }
                } else {
                    k = fmt_e8_fast(row[c], p);
                    if (k < 0)
                        k = snprintf(p, 20, "%.8e", row[c]);
                }
                if (k <= 0 || k >= 20) { bad = true; break; }
                p += k;
                *p++ = c + 1 < ncols ? '\t' : '\n';
            }
            if (blank_every > 0 && (s0 + i + 1) % blank_every == 0)
                *p++ = '\n';
        }
        uselocale(prev);
        if (bad || fwrite(buf, 1, p - buf, f) != (size_t)(p - buf)) {
            free(buf); free(memo); fclose(f); return -1;
        }
        written += m;
    }
    free(buf); free(memo);
    if (fclose(f) != 0) return -1;
    return written;
}

// Append one event to an OSCAR particle-list file: "# n" header then rows
// "mcid t x y z E px py pz" at 16-digit scientific precision (matches the
// reference's write_particle_list_OSC, emissionfunction.cpp:863-901, and
// the Python fallback writer byte for byte).  Returns n, or -1 on I/O
// error.  Native-runtime counterpart of the reference's C++ writer: the
// per-hadron Python formatting loop measured 78 k hadrons/s, an order of
// magnitude slower than the sampler it drains.
extern "C"
long long write_oscar_event(const char* path, int append, long long n,
                            const long long* mcid, const double* t,
                            const double* x, const double* y,
                            const double* z, const double* E,
                            const double* px, const double* py,
                            const double* pz)
{
    FILE* f = fopen(path, append ? "ab" : "wb");
    if (!f) return -1;
    setvbuf(f, nullptr, _IOFBF, 1 << 20);
    if (fprintf(f, "# %lld\n", n) < 0) { fclose(f); return -1; }

    // the cost is the double formatting, not the I/O: format rows in
    // parallel (OpenMP; the pragma is a no-op without -fopenmp) into a
    // fixed-stride chunk buffer, then stream the rows out sequentially
    const long long CH = 1 << 16;
    const int W = 240;            // max row width incl. NUL (9 fields)
    char* buf = (char*)malloc((size_t)CH * W);
    int* lens = (int*)malloc(CH * sizeof(int));
    if (!buf || !lens) { free(buf); free(lens); fclose(f); return -1; }
    long long written = 0;
    for (long long s0 = 0; s0 < n; s0 += CH) {
        long long m = n - s0 < CH ? n - s0 : CH;
        #pragma omp parallel
        {
            locale_t prev = uselocale(c_numeric_locale());
            #pragma omp for schedule(static)
            for (long long i = 0; i < m; ++i) {
                long long j = s0 + i;
                lens[i] = snprintf(buf + (size_t)i * W, W,
                    "%lld %.16e %.16e %.16e %.16e %.16e %.16e %.16e %.16e\n",
                    mcid[j], t[j], x[j], y[j], z[j], E[j], px[j], py[j], pz[j]);
            }
            uselocale(prev);
        }
        for (long long i = 0; i < m; ++i) {
            if (lens[i] <= 0 || lens[i] >= W ||
                fwrite(buf + (size_t)i * W, 1, lens[i], f) != (size_t)lens[i]) {
                free(buf); free(lens); fclose(f); return -1;
            }
        }
        written += m;
    }
    free(buf); free(lens);
    if (fclose(f) != 0) return -1;
    return written;
}
