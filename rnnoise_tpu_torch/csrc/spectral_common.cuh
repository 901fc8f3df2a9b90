// Device code of the 960-point real spectra, shared by the kernels of
// spectral.cu (forward and inverse spectra, post-filter and synthesis),
// analysis.cu (pitch analysis and both forward spectra) and frame.cu.
//
// Forward: each of a stream's two windowed real inputs is transformed as
// one complex 480-point sequence (its even samples real, its odd
// imaginary) by an f64 FFT in shared memory: Stockham stages of radix 2,
// 16 and 15 with twiddles and roots from an exact f64 table
// (dsp/fft_plan.py), then a last pass that forms the 481 bins of the real
// spectrum (see FH and fwd_spectra below); each bin is rounded once to
// f32.  The spectra feed knife-edge decisions, so these sums must round as
// the f64 DFT matmul of the plain versions does: an f64 FFT's error
// (~1e-16 of the row) moves the f32 result by an ulp at most, and rarely.
//
// Inverse: the unscaled inverse DFT x of a conjugate-symmetric spectrum X
// (bins k <= 480) is taken as one complex 480-point sequence,
// z[m] = x[2m] + i x[2m+1], the inverse FFT of
// Z[k] = (X[k] + conj X[480-k]) + i w960^k (X[k] - conj X[480-k]), k < 480
// (bins 0 and 480 taken real).  A first pass forms conj Z, the mirror of
// the forward's last pass, and runs the radix-2 stage on it; the forward's
// own radix-16 and radix-15 stages and table then give FFT(conj Z) =
// conj z, and a last pass applies the synthesis window and rounds each
// sample once to f32 (see inv_spectra below).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rnnt {

constexpr int FS = 480;            // frame
constexpr int WS = 960;            // window / DFT length
constexpr int NBIN = 481;          // bins kept
constexpr int PBUF = 1728;         // pitch buffer
constexpr int MAX_START = PBUF - WS;   // largest pitch-window start

// The forward FFT (dsp/fft_plan.py holds the same plan).  Each real input
// v of 960 samples is transformed as one complex sequence of FH = 480
// points, c[m] = w[2m] v[2m] + i w[2m+1] v[2m+1], and its spectrum taken
// from C = FFT(c) in a last pass (fwd_spectra), so each spectrum's error
// is relative to its own input: a stream's two inputs are never mixed.
// The stages' radices (fft_plan.FFT_RADICES), the product of the radices
// before each stage, and each stage's offset in the FFT table
// (fft_plan.fft_table): its (R - 1) x Ns twiddles, then its R roots.
constexpr int FH = WS / 2;         // points of a sequence
constexpr int FFT_R0 = 2, FFT_R1 = 16, FFT_R2 = 15;
constexpr int FFT_NS1 = FFT_R0, FFT_NS2 = FFT_NS1 * FFT_R1;
__host__ __device__ constexpr int fft_stage_size(int r, int ns) { return (r - 1) * ns + r; }
constexpr int FFT_OFF1 = 0, FFT_OFF2 = FFT_OFF1 + fft_stage_size(FFT_R1, FFT_NS1),
              FFT_TABLE = FFT_OFF2 + fft_stage_size(FFT_R2, FFT_NS2);   // 509
// butterflies of the in-place stages per stream, two sequences (60 and
// 64): a block runs one per thread, so it needs this many threads a stream
constexpr int FFT_LANES = 2 * FH / FFT_R2;
static_assert(FFT_R0 == 2 && FFT_R1 == 16 && FFT_R2 == 15 && FFT_NS2 * FFT_R2 == FH &&
              2 * FH / FFT_R1 <= FFT_LANES, "the butterflies below are these radices'");

__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 csub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}
// a b, with the products rounded as written (nothing for nvcc to contract)
__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(fma(a.x, b.x, -__dmul_rn(a.y, b.y)),
                      fma(a.x, b.y, __dmul_rn(a.y, b.x)));
}
// i a
__device__ __forceinline__ double2 times_i(double2 a) { return make_double2(-a.y, a.x); }

// The storage slot of point n of a sequence's buffer: n's low 3 bits
// XOR-swizzled with bits 3-6 (a permutation inside each aligned 8), so the
// strided stores of the stages spread over the shared-memory banks.
__device__ __forceinline__ int swz(int n) {
  return (n & ~7) | ((n ^ (n >> 3) ^ (n >> 4)) & 7);
}

// Forward DFT-4 in place, the factors +-i as swaps.
__device__ __forceinline__ void dft4(double2& v0, double2& v1, double2& v2, double2& v3) {
  const double2 a0 = cadd(v0, v2), a1 = csub(v0, v2);
  const double2 b0 = cadd(v1, v3), d = csub(v1, v3);
  const double2 b1 = make_double2(d.y, -d.x);            // -i (v1 - v3)
  v0 = cadd(a0, b0);
  v1 = cadd(a1, b1);
  v2 = csub(a0, b0);
  v3 = csub(a1, b1);
}

// Forward DFT-16 in place as 4 x 4: X[k1 + 4 k2] = sum_n2 w16^(n2 k1)
// w4^(n2 k2) sum_n1 v[4 n1 + n2] w4^(n1 k1); W[q] = w16^q.
__device__ __forceinline__ void dft16(double2 (&v)[16], const double2* __restrict__ W) {
#pragma unroll
  for (int n2 = 0; n2 < 4; ++n2) dft4(v[n2], v[n2 + 4], v[n2 + 8], v[n2 + 12]);
  // v[n2 + 4 k1] now holds the inner DFT of column n2 at k1
#pragma unroll
  for (int n2 = 1; n2 < 4; ++n2)
#pragma unroll
    for (int k1 = 1; k1 < 4; ++k1)
      v[n2 + 4 * k1] = cmul(v[n2 + 4 * k1], W[n2 * k1]);
  double2 o[16];
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) {
    double2 b0 = v[4 * k1], b1 = v[4 * k1 + 1], b2 = v[4 * k1 + 2], b3 = v[4 * k1 + 3];
    dft4(b0, b1, b2, b3);
    o[k1] = b0;
    o[k1 + 4] = b1;
    o[k1 + 8] = b2;
    o[k1 + 12] = b3;
  }
#pragma unroll
  for (int q = 0; q < 16; ++q) v[q] = o[q];
}

// Forward DFT-3 of (a0, a1, a2) with w = w3: a0 + t, a0 + c t +- i s' d,
// where t = a1 + a2, d = a1 - a2, c = w.x and s' = w.y.
__device__ __forceinline__ void dft3(double2& a0, double2& a1, double2& a2, double2 w) {
  const double2 t = cadd(a1, a2), d = csub(a1, a2);
  const double2 m = make_double2(fma(w.x, t.x, a0.x), fma(w.x, t.y, a0.y));
  const double2 u = times_i(make_double2(__dmul_rn(w.y, d.x), __dmul_rn(w.y, d.y)));
  a0 = cadd(a0, t);
  a1 = cadd(m, u);
  a2 = csub(m, u);
}

// Forward DFT-5 of a[0..4] with w1 = w5, w2 = w5^2 (Rader-free symmetric
// form: sums and differences of the pairs (1, 4) and (2, 3)).
__device__ __forceinline__ void dft5(double2 (&a)[5], double2 w1, double2 w2) {
  const double2 t1 = cadd(a[1], a[4]), d1 = csub(a[1], a[4]);
  const double2 t2 = cadd(a[2], a[3]), d2 = csub(a[2], a[3]);
  const double2 m1 = make_double2(fma(w2.x, t2.x, fma(w1.x, t1.x, a[0].x)),
                                  fma(w2.x, t2.y, fma(w1.x, t1.y, a[0].y)));
  const double2 m2 = make_double2(fma(w1.x, t2.x, fma(w2.x, t1.x, a[0].x)),
                                  fma(w1.x, t2.y, fma(w2.x, t1.y, a[0].y)));
  const double2 u1 = times_i(make_double2(fma(w1.y, d1.x, __dmul_rn(w2.y, d2.x)),
                                          fma(w1.y, d1.y, __dmul_rn(w2.y, d2.y))));
  const double2 u2 = times_i(make_double2(fma(w2.y, d1.x, -__dmul_rn(w1.y, d2.x)),
                                          fma(w2.y, d1.y, -__dmul_rn(w1.y, d2.y))));
  a[0] = cadd(cadd(a[0], t1), t2);
  a[1] = cadd(m1, u1);
  a[4] = csub(m1, u1);
  a[2] = cadd(m2, u2);
  a[3] = csub(m2, u2);
}

// Forward DFT-15 in place by the prime-factor map (3 x 5, no twiddles):
// point n = (5 n1 + 3 n2) mod 15, bin k = (10 k1 + 6 k2) mod 15; W[q] = w15^q,
// so w3 = W[5], w5 = W[3], w5^2 = W[6].
__device__ __forceinline__ void dft15(double2 (&v)[15], const double2* __restrict__ W) {
  const double2 w3 = W[5], w5 = W[3], w25 = W[6];
  double2 A[3][5];                       // A[k1][n2]
#pragma unroll
  for (int n2 = 0; n2 < 5; ++n2) {
    double2 a0 = v[(3 * n2) % 15], a1 = v[(5 + 3 * n2) % 15], a2 = v[(10 + 3 * n2) % 15];
    dft3(a0, a1, a2, w3);
    A[0][n2] = a0;
    A[1][n2] = a1;
    A[2][n2] = a2;
  }
#pragma unroll
  for (int k1 = 0; k1 < 3; ++k1) {
    dft5(A[k1], w5, w25);
#pragma unroll
    for (int k2 = 0; k2 < 5; ++k2) v[(10 * k1 + 6 * k2) % 15] = A[k1][k2];
  }
}

// One in-place Stockham stage (radix R after NSPAN points' worth of
// stages) of nseq sequences of FH points at buf + q * FH, by all threads of
// the block, one butterfly per thread (nseq * FH / R <= blockDim.x): each
// thread reads its R points and applies the twiddles from the FFT table ft,
// all threads meet, then each writes its R outputs.  Ends with a barrier.
template <int R, int NSPAN, int OFF>
__device__ __forceinline__ void fft_stage(int nseq, double2* buf,
                                          const double2* __restrict__ ft) {
  constexpr int M = FH / R;
  const int i = threadIdx.x;
  const bool on = i < nseq * M;
  const int q = on ? i / M : 0, j = i - q * M, jm = j % NSPAN;
  double2* z = buf + q * FH;
  double2 v[R];
  if (on) {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = z[swz(j + r * M)];
#pragma unroll
    for (int r = 1; r < R; ++r) v[r] = cmul(v[r], ft[OFF + (r - 1) * NSPAN + jm]);
    if constexpr (R == 16) dft16(v, ft + OFF + (R - 1) * NSPAN);
    else dft15(v, ft + OFF + (R - 1) * NSPAN);
  }
  __syncthreads();
  if (on) {
    const int base = (j - jm) * R + jm;
#pragma unroll
    for (int r = 0; r < R; ++r) z[swz(base + r * NSPAN)] = v[r];
  }
  __syncthreads();
}

// Samples n and n + 1 (n even) of an input row: one 8-byte load where the
// pair is aligned.
__device__ __forceinline__ float2 load_pair(const float* v) {
  if ((reinterpret_cast<uintptr_t>(v) & 7) == 0) return *reinterpret_cast<const float2*>(v);
  return make_float2(v[0], v[1]);
}

// Both forward spectra of nstr streams by all threads of the block, a
// butterfly a thread (nstr * FFT_LANES <= blockDim.x; K >= the radix-2
// butterflies per thread, nstr * 240 / blockDim.x).  Stream g's
// X input is [mem | x], whose samples n, n + 1 (n even) lie at xin(g, n),
// and its P input the pitch window at pin(g).  Each input is windowed in
// f64 (exact: products of two floats) as complex samples
// c[m] = w[2m] v[2m] + i w[2m+1] v[2m+1], m < 480, whose 480-point FFT C
// runs in buf [2 nstr][480] (X's then P's sequence per stream, swizzled,
// swz).  A last pass makes each bin k <= 480 of the spectrum,
// V[k] = (C[k] + conj C[-k]) / 2 - i w960^k (C[k] - conj C[-k]) / 2, scales
// it by 1/960 and rounds it once to f32: store(g, seq, k, re, im) with seq
// 0 for X and 1 for P.  tw holds the base twiddles (cos, sin)(2 pi m / 960)
// for m <= 480, ft the FFT table (either in device or shared memory).  Starts after the caller's last barrier on buf; has
// none after the stores.
template <int K, class XIn, class PIn, class Store>
__device__ __forceinline__ void fwd_spectra(int nstr, double2* buf,
                                            const double2* __restrict__ tw,
                                            const double2* __restrict__ ft,
                                            const float* __restrict__ window,
                                            XIn xin, PIn pin, Store store) {
  constexpr int M0 = FH / FFT_R0;
  const int nseq = 2 * nstr;
  // the radix-2 stage: butterfly j of both sequences of a stream per item,
  // every load of the thread issued before any of its stores
  const float2* w2 = reinterpret_cast<const float2*>(window);
  float2 wv[K][2], xv[K][2], pv[K][2];
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const int i = threadIdx.x + u * blockDim.x;
    if (i < nstr * M0) {
      const int g = i / M0, j = i - g * M0;
      const float* p = pin(g);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = j + h * M0;
        wv[u][h] = w2[m];
        xv[u][h] = load_pair(xin(g, 2 * m));
        pv[u][h] = load_pair(p + 2 * m);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const int i = threadIdx.x + u * blockDim.x;
    if (i < nstr * M0) {
      const int g = i / M0, j = i - g * M0;
#pragma unroll
      for (int seq = 0; seq < 2; ++seq) {
        const float2* v = seq ? pv[u] : xv[u];
        const double2 a = make_double2((double)wv[u][0].x * v[0].x, (double)wv[u][0].y * v[0].y);
        const double2 b = make_double2((double)wv[u][1].x * v[1].x, (double)wv[u][1].y * v[1].y);
        double2* z = buf + (2 * g + seq) * FH;
        z[swz(2 * j)] = cadd(a, b);
        z[swz(2 * j + 1)] = csub(a, b);
      }
    }
  }
  __syncthreads();
  fft_stage<FFT_R1, FFT_NS1, FFT_OFF1>(nseq, buf, ft);
  fft_stage<FFT_R2, FFT_NS2, FFT_OFF2>(nseq, buf, ft);
  // bin k from a = C[k mod 480] and b = C[-k mod 480]; a thread makes
  // bins k and 480 - k, which read the same two points
  const auto bin = [&](int q, int k, double2 a, double2 b) {
    const double c = 1.0 / (2 * WS);
    const double2 s = make_double2(a.x + b.x, a.y - b.y);     // C[k] + conj C[-k]
    const double2 d = make_double2(a.x - b.x, a.y + b.y);     // C[k] - conj C[-k]
    const double2 t = tw[k];                                   // w960^-k
    const double2 u = cmul(make_double2(d.y, -d.x), make_double2(t.x, -t.y));
    store(q >> 1, q & 1, k, (float)((s.x + u.x) * c), (float)((s.y + u.y) * c));
  };
  constexpr int NPAIR = FH / 2 + 1;
  for (int i = threadIdx.x; i < nseq * NPAIR; i += blockDim.x) {
    const int q = i / NPAIR, k = i - q * NPAIR;
    const double2* z = buf + q * FH;
    const double2 a = z[swz(k)], b = z[swz(k == 0 ? 0 : FH - k)];
    bin(q, k, a, b);
    if (k != FH / 2) bin(q, FH - k, b, a);
  }
}

// The inverse spectra of nstr streams by all threads of the block
// (nstr * FH / FFT_R2 <= blockDim.x, a butterfly a thread): for each
// stream g, x[n] = sum_k c_k (re_k cos(2 pi k n / 960) - im_k sin(2 pi k n /
// 960)), c_k = 1 at k = 0 and 480 and 2 elsewhere, times the window, each
// sample rounded once to f32.  load(g, k) gives bin k <= 480 of stream g as
// (re, im) (the imaginary parts of bins 0 and 480 are not read); the
// 480-point FFT runs in buf [nstr][480] (swizzled, swz); store(g, n, lo, hi)
// takes samples n, n + 1 (lo) and n + 480, n + 481 (hi) for even n < 480, so
// one call may read what it then overwrites.  tw holds the base twiddles
// (cos, sin)(2 pi m / 960) for m < 480, ft the FFT table (either in device or
// shared memory).  Starts after the caller's last barrier on buf and on
// what load reads; has none after the stores.
template <class Load, class Store>
__device__ __forceinline__ void inv_spectra(int nstr, double2* buf,
                                            const double2* __restrict__ tw,
                                            const double2* __restrict__ ft,
                                            const float* __restrict__ window,
                                            Load load, Store store) {
  constexpr int M0 = FH / FFT_R0;
  // conj Z[k] = (conj A + B) - i w960^-k (conj A - B) for A = X[k] and
  // B = X[480 - k], in f64 (the sums of two floats, then the twiddle)
  const auto conj_z = [&](int g, int k) {
    float2 a = load(g, k), b = load(g, FH - k);
    if (k == 0) a.y = b.y = 0.0f;                  // bins 0 and 480 are real
    const double2 s = make_double2((double)a.x + b.x, (double)b.y - a.y);
    const double2 d = make_double2((double)a.x - b.x, -((double)a.y + b.y));
    const double2 t = tw[k];
    return cadd(s, cmul(make_double2(d.y, -d.x), make_double2(t.x, -t.y)));
  };
  // the radix-2 stage on conj Z: butterfly j of stream g reads points j and
  // j + 240
  for (int i = threadIdx.x; i < nstr * M0; i += blockDim.x) {
    const int g = i / M0, j = i - g * M0;
    const double2 a = conj_z(g, j), b = conj_z(g, j + M0);
    double2* z = buf + g * FH;
    z[swz(2 * j)] = cadd(a, b);
    z[swz(2 * j + 1)] = csub(a, b);
  }
  __syncthreads();
  fft_stage<FFT_R1, FFT_NS1, FFT_OFF1>(nstr, buf, ft);
  fft_stage<FFT_R2, FFT_NS2, FFT_OFF2>(nstr, buf, ft);
  // x[2m] = Re F[m], x[2m+1] = -Im F[m] for F = FFT(conj Z); a thread
  // makes samples 2m, 2m + 1 and their partners 480 later
  const float2* w2 = reinterpret_cast<const float2*>(window);
  const auto pair = [&](double2 f, float2 w) {
    return make_float2((float)((double)w.x * f.x), (float)((double)w.y * -f.y));
  };
  for (int i = threadIdx.x; i < nstr * M0; i += blockDim.x) {
    const int g = i / M0, m = i - g * M0;
    const double2* z = buf + g * FH;
    store(g, 2 * m, pair(z[swz(m)], w2[m]), pair(z[swz(m + M0)], w2[m + M0]));
  }
}

}  // namespace rnnt
