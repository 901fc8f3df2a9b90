// The pitch analysis' device code, shared by analysis.cu (the lag table and
// the analysis kernels) and frame.cu (the whole-chunk kernel): the lag table
// alone as register tiles (lag_partials), the lag table and its energies as
// f64 tensor-core products (lag_energy_mma), the fine search's ratio and
// argmax (fine_ratio, warp_argmax) and the doubling ladder (resolve_period).
// See analysis.cu for what it computes and how its numerics match the plain
// versions.

#pragma once

#include <math_constants.h>
#include <stdint.h>

#include "spectral_common.cuh"

namespace rnnt {

constexpr int DS = 864;            // decimated pitch buffer
constexpr int XOFF = 384;          // x = ds[384 : 864]
constexpr int N2 = 480;            // correlation length
constexpr int NLAGS = 385;         // table entries, lags 0..384
constexpr int MAXP2 = 384;         // max period, 24 kHz units
constexpr int MINP2 = 30;          // min period, 24 kHz units
constexpr int NL2 = 294;           // fine-search lags
constexpr int MIN_PERIOD = 60;
constexpr int MAX_PERIOD = 768;

__constant__ int SECOND_CHECK[16] = {0, 0, 3, 2, 3, 2, 5, 2, 3, 2, 3, 2, 5, 2, 3, 2};

// The lag table's tiles (dsp/cuda_xcorr.py holds the same shape): a thread
// owns LAG_TILE consecutive lags and one slice of TAP_SLICE consecutive
// taps.  The threads of a slice are SLICE_LANES consecutive ones (two whole
// warps, the first LAG_TILES of them busy), so a warp's loads of x[j] are one
// broadcast and its loads of ds[i+j] stride LAG_TILE (odd) doubles, free of
// bank conflicts; the slices' partial sums meet through shared memory in one
// fixed order, ((s0 + s1) + (s2 + s3)).
constexpr int LAG_TILE = 7;                        // lags per thread
constexpr int TAP_SLICE = 120;                     // taps per slice
constexpr int TAP_SLICES = N2 / TAP_SLICE;         // 4
constexpr int LAG_TILES = NLAGS / LAG_TILE;        // 55
constexpr int SLICE_LANES = 64;
constexpr int LAG_THREADS = TAP_SLICES * SLICE_LANES;        // 256
constexpr int DS_PAD = DS + 8;     // a zero tail that the last window reads
static_assert(NLAGS % LAG_TILE == 0 && N2 % TAP_SLICE == 0 && TAP_SLICES == 4 &&
              LAG_TILES <= SLICE_LANES && SLICE_LANES % 32 == 0 && LAG_TILE % 2 == 1,
              "the lag tiles must cover the table, a slice whole warps");
static_assert(NLAGS + N2 <= DS_PAD, "the last window must stay inside the buffer");

// ds [864] (f32, device or shared memory) into d [DS_PAD] f64, zero-padded,
// by threads t < nt.
__device__ __forceinline__ void load_ds64(double* d, const float* ds, int t, int nt) {
  for (int i = t; i < DS_PAD; i += nt) d[i] = i < DS ? (double)ds[i] : 0.0;
}

// The partial sums of thread t < LAG_THREADS over its slice, from d = ds in
// f64 (load_ds64), into part [TAP_SLICES][NLAGS]: acc[i] = sum_j ds[384+j]
// ds[i+j] over the slice's taps in ascending order.  Per tap, one shared
// load of ds[i+j] (a window of LAG_TILE values slides through registers) and
// one broadcast of x[j] feed LAG_TILE multiply-adds, with no conversion.
__device__ __forceinline__ void lag_partials(const double* d, int t, double* part) {
  const int slice = t / SLICE_LANES, tile = t - slice * SLICE_LANES;
  if (tile >= LAG_TILES) return;
  const int i0 = tile * LAG_TILE, j0 = slice * TAP_SLICE;
  const double* x = d + XOFF + j0;
  const double* y = d + i0 + j0;
  double acc[LAG_TILE], w[LAG_TILE];
#pragma unroll
  for (int r = 0; r < LAG_TILE; ++r) {
    acc[r] = 0.0;
    w[r] = y[r];
  }
#pragma unroll
  for (int j = 0; j < TAP_SLICE; ++j) {
    const double xj = x[j];
#pragma unroll
    for (int r = 0; r < LAG_TILE; ++r) acc[r] = fma(xj, w[r], acc[r]);
#pragma unroll
    for (int r = 0; r + 1 < LAG_TILE; ++r) w[r] = w[r + 1];
    w[LAG_TILE - 1] = y[j + LAG_TILE];
  }
  double* p = part + slice * NLAGS + i0;
#pragma unroll
  for (int r = 0; r < LAG_TILE; ++r) p[r] = acc[r];
}

// bx[i] from the slices' partial sums, added in one fixed order and rounded
// once.
__device__ __forceinline__ void lag_finish(const double* part, int i, float* bx) {
  const double* p = part + i;
  bx[i] = (float)((p[0] + p[NLAGS]) + (p[2 * NLAGS] + p[3 * NLAGS]));
}

// The lag table and its energies as f64 tensor-core products
// (dsp/cuda_xcorr.py holds the same plan).  A tile is MMA_TILE_LAGS = 128
// consecutive lags L0 + row + 16n (row < 16, n < 8), the 16 x 8 output of
// one chain of mma.sync m16n8k8 f64 products over k < MMA_K_LEN = 480 + 112,
// MMA_KSTEPS = 74 steps of 8:
//   bx[L0 + row + 16n] = sum_k A[row][k] B[k][n],   A[row][k] = ds[L0 + row + k],
//                        B[k][n] = x[k - 16n] if 0 <= k - 16n < 480, else 0;
//   yy[L0 + row + 16n] = sum_k A[row][k]^2 E[k][n], E[k][n] = 1 if 0 <= k - 16n < 480.
// A is a Hankel matrix of ds, B a Toeplitz band of x and E its 0/1 band.  A
// lane 4g + t holds A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4] of
// step m, ds[L0 + g + t + 8m + (0, 8, 4, 12)]: rows g + 8 of step m are rows
// g of step m + 1, so two new values a tile and step (u and v below) slide
// through a window of registers, and a warp's 32 loads touch 11 consecutive
// doubles.  B and E do not depend on the tile: two values a step serve all
// tiles.  MMA_TILES = 3 tiles hold lags 0..383 and read ds[0..862] at most:
// no zero tail is needed, and a stream never reads the next one's ds.  Lag
// 384, bx[384] = yy[384] = sum_j x[j]^2, is one warp's sum.  Each product is
// one of two floats, exact in f64; each table entry is an f64 sum rounded
// once.  (The m8n8k4 f64 shape runs at half the m16n8kN shapes' rate on the
// H100: scripts/torch_f64_mma_rate.py.)
constexpr int MMA_M = 16, MMA_N = 8, MMA_K = 8;    // the mma's shape
constexpr int MMA_TILE_LAGS = MMA_M * MMA_N;       // 128
constexpr int MMA_TILES = (NLAGS - 1) / MMA_TILE_LAGS;   // 3
constexpr int MMA_K_LEN = N2 + (MMA_N - 1) * MMA_M;      // 592
constexpr int MMA_KSTEPS = MMA_K_LEN / MMA_K;            // 74
constexpr int MMA_DS_EXTENT = (MMA_TILES - 1) * MMA_TILE_LAGS + MMA_M - 1 + MMA_K_LEN;  // 863
constexpr int LAG_WARPS = 2;                             // warps a stream: a table each
static_assert(MMA_TILES * MMA_TILE_LAGS == NLAGS - 1 && MMA_K_LEN % MMA_K == 0 &&
              MMA_M == 16 && MMA_K == 8 && MMA_DS_EXTENT <= DS,
              "the tiles cover lags 0..383 and read inside the stream's ds");

// c += a b for one m16n8k8 f64 product: lane 4g + t holds A[g][t],
// A[g + 8][t], A[g][t + 4], A[g + 8][t + 4] (a0..a3), B[t][g], B[t + 4][g]
// (b0, b1) and C[g][2t], C[g][2t + 1], C[g + 8][2t], C[g + 8][2t + 1].
__device__ __forceinline__ void dmma_m16n8k8(double (&c)[4], double a0, double a1,
                                             double a2, double a3, double b0, double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

// One warp's chains over the MMA_TILES tiles of one stream, d its ds (f64,
// shared memory): the lag table into bx with BX, the energies into yy with
// YY.  A warp with the energies alone keeps A squared in its window.
template <bool BX, bool YY>
__device__ __forceinline__ void lag_chains(const double* d, float* bx, float* yy) {
  constexpr bool SQ = YY && !BX;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const double* a = d + g + t;
  const auto load = [&](int i) {
    const double v = a[i];
    return SQ ? __dmul_rn(v, v) : v;
  };
  const auto sq = [](double v) { return SQ ? v : __dmul_rn(v, v); };
  double cb[MMA_TILES][4], ce[MMA_TILES][4];
  double u[MMA_TILES][2], v[MMA_TILES][2];         // u(m), u(m + 1); v(m), v(m + 1)
#pragma unroll
  for (int q = 0; q < MMA_TILES; ++q) {
#pragma unroll
    for (int i = 0; i < 4; ++i) cb[q][i] = ce[q][i] = 0.0;
    const int l0 = q * MMA_TILE_LAGS;
    u[q][0] = load(l0);
    u[q][1] = load(l0 + MMA_K);
    v[q][0] = load(l0 + 4);
    v[q][1] = load(l0 + MMA_K + 4);
  }
  const int j0 = t - MMA_M * g;                    // B's tap at step 0
#pragma unroll 4
  for (int m = 0; m < MMA_KSTEPS; ++m) {
    const int j = j0 + MMA_K * m;
    const bool in0 = (unsigned)j < (unsigned)N2, in1 = (unsigned)(j + 4) < (unsigned)N2;
    double b0 = 0.0, b1 = 0.0;
    if (BX && in0) b0 = d[XOFF + j];
    if (BX && in1) b1 = d[XOFF + j + 4];
    const double e0 = in0 ? 1.0 : 0.0, e1 = in1 ? 1.0 : 0.0;
    const bool more = m + 1 < MMA_KSTEPS;
#pragma unroll
    for (int q = 0; q < MMA_TILES; ++q) {
      double nu = 0.0, nv = 0.0;
      if (more) {
        const int i = q * MMA_TILE_LAGS + MMA_K * (m + 2);
        nu = load(i);
        nv = load(i + 4);
      }
      if (BX) dmma_m16n8k8(cb[q], u[q][0], u[q][1], v[q][0], v[q][1], b0, b1);
      if (YY)
        dmma_m16n8k8(ce[q], sq(u[q][0]), sq(u[q][1]), sq(v[q][0]), sq(v[q][1]), e0, e1);
      u[q][0] = u[q][1];
      u[q][1] = nu;
      v[q][0] = v[q][1];
      v[q][1] = nv;
    }
  }
  // C[row][n] is lag L0 + row + 16n: C[g][2t] lag L0 + g + 32t, C[g][2t + 1]
  // 16 more, C[g + 8][.] 8 more
#pragma unroll
  for (int q = 0; q < MMA_TILES; ++q) {
    const int i = q * MMA_TILE_LAGS + g + 2 * MMA_M * t;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int at = i + MMA_M * (c & 1) + 8 * (c >> 1);
      if (BX) bx[at] = (float)cb[q][c];
      if (YY) yy[at] = (float)ce[q][c];
    }
  }
}

// bx and yy (lags 0..384, each rounded once to f32) of the block's streams
// g < ns by WPS warps a stream: warp w takes stream w / WPS and, with WPS =
// 2, the lag table (w even) or the energies (w odd), with WPS = 1 both;
// warps w >= ns * WPS return at once.  Stream g's ds [864] (f64, shared
// memory) is at ds + g * ds_stride, its tables at bx + g * out_stride and
// yy + g * out_stride.  Ends without a barrier.
template <int WPS>
__device__ __forceinline__ void lag_energy_mma(int ns, const double* ds, int ds_stride,
                                               float* bx, float* yy, int out_stride) {
  static_assert(WPS == 1 || WPS == 2, "a warp runs both tables, or one each");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = warp / WPS, part = warp - g * WPS;
  if (g >= ns) return;
  const double* d = ds + g * ds_stride;
  bx += g * out_stride;
  yy += g * out_stride;
  if constexpr (WPS == 1) lag_chains<true, true>(d, bx, yy);
  else if (part == 0) lag_chains<true, false>(d, bx, yy);
  else lag_chains<false, true>(d, bx, yy);
  if (part == WPS - 1) {
    double s = 0.0;
    for (int j = lane; j < N2; j += 32) s = fma(d[XOFF + j], d[XOFF + j], s);
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) bx[MAXP2] = yy[MAXP2] = (float)s;
  }
}

// The fine search's inputs at lag l < NL2, within 2 lags of twice the
// coarse candidates bp0, bp1 (12 kHz lags): the candidate correlation
// xc2[l] and the ratio q[l] = (xc 1e-12)^2 / max(1 + yy, 1) over lags with
// xc > 0 (-inf elsewhere).
__device__ __forceinline__ void fine_ratio(const float* bx, const float* yy, int l,
                                           int bp0, int bp1, float* xc2, float* q) {
  const bool cand = abs(l - 2 * bp0) <= 2 || abs(l - 2 * bp1) <= 2;
  const float xc = cand ? fmaxf(bx[l], -1.0f) : 0.0f;
  xc2[l] = xc;
  const float num = __fmul_rn((float)1e-12, xc);
  q[l] = xc > 0.0f ? __fdiv_rn(__fmul_rn(num, num), fmaxf(__fadd_rn(1.0f, yy[l]), 1.0f))
                   : -CUDART_INF_F;
}

// The first index of the largest q[i], i < n, with q[skip] taken as -inf
// (torch.argmax; all -inf gives 0), by one warp.
__device__ __forceinline__ int warp_argmax(const float* q, int n, int skip) {
  const int lane = threadIdx.x & 31;
  float best = -CUDART_INF_F;
  int at = n;
  for (int i = lane; i < n; i += 32) {
    const float v = i == skip ? -CUDART_INF_F : q[i];
    if (v > best || (at == n && v == best)) { best = v; at = i; }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oa = __shfl_xor_sync(0xffffffffu, at, off);
    if (ob > best || (ob == best && oa < at)) { best = ob; at = oa; }
  }
  return at;
}

// xy / sqrt(1 + xx yy)
__device__ __forceinline__ float pitch_gain(float xy, float xx, float yy) {
  return __fdiv_rn(xy, __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(xx, yy))));
}

// +1, -1 or 0 from the three correlations around a peak (pitch.c:368-384)
__device__ __forceinline__ int peak_offset(float a, float b, float c) {
  const float k = (float)0.7;
  if (__fsub_rn(c, a) > __fmul_rn(k, __fsub_rn(b, a))) return 1;
  if (__fsub_rn(a, c) > __fmul_rn(k, __fsub_rn(b, c))) return -1;
  return 0;
}

// The fine search, the doubling ladder and the final offset for one stream
// (rnnoise_tpu_torch/dsp/pitch.py: fine_search, remove_doubling), from the
// lag table bx, the energies yy and the candidate correlations xc2.
// Returns T0 in 48 kHz units; writes the pitch gain to *gain.  UNROLL
// unrolls the ladder's 14 steps by that much: unrolled, each step's
// divisions are by constants and its table reads and gain do not wait on
// the step before (only the choice does), which the analysis kernel gains
// by; the whole-chunk kernel, whose code is ~30 k instructions, keeps it
// rolled (unrolled, its fine-search span took longer, PERF.md §6).
template <int UNROLL>
__device__ int resolve_period(const float* bx, const float* yy, const float* xc2,
                              int fb0, int prev_period48, float prev_gain,
                              float* gain) {
  const int a_i = max(fb0 - 1, 0), c_i = min(fb0 + 1, NL2 - 1);
  int off = peak_offset(xc2[a_i], xc2[fb0], xc2[c_i]);
  if (!(fb0 > 0 && fb0 < NL2 - 1)) off = 0;
  const int pitch_index = MAX_PERIOD - (2 * fb0 - off);

  const int T0 = min(pitch_index / 2, MAXP2 - 1);
  const int prev_period = prev_period48 / 2;
  const float xx = bx[MAXP2];
  const float xy = bx[MAXP2 - T0], yy0 = yy[MAXP2 - T0];
  float best_xy = xy, best_yy = yy0;
  const float g0 = pitch_gain(xy, xx, yy0);
  float g = g0;
  int T = T0;
  bool active = true;
#pragma unroll UNROLL
  for (int k = 2; k < 16; ++k) {
    const int T1 = (2 * T0 + k) / (2 * k);
    int T1b = (2 * SECOND_CHECK[k] * T0 + k) / (2 * k);
    if (k == 2) T1b = T1 + T0 > MAXP2 ? T0 : T0 + T1;
    active = active && T1 >= MINP2;               // `break` (pitch.c:469-470)
    const float xy_k = __fmul_rn(0.5f, __fadd_rn(bx[MAXP2 - T1], bx[MAXP2 - T1b]));
    const float yy_k = __fmul_rn(0.5f, __fadd_rn(yy[MAXP2 - T1], yy[MAXP2 - T1b]));
    const float g1 = pitch_gain(xy_k, xx, yy_k);
    const int d = abs(T1 - prev_period);
    const float cont = d <= 1 ? prev_gain
        : (d <= 2 && 5 * k * k < T0) ? __fmul_rn(0.5f, prev_gain) : 0.0f;
    float thresh = fmaxf(__fsub_rn(__fmul_rn((float)0.7, g0), cont), (float)0.3);
    if (T1 < 3 * MINP2)
      thresh = fmaxf(__fsub_rn(__fmul_rn((float)0.85, g0), cont), (float)0.4);
    if (active && g1 > thresh) {
      best_xy = xy_k;
      best_yy = yy_k;
      T = T1;
      g = g1;
    }
  }
  best_xy = fmaxf(best_xy, 0.0f);
  float pg = best_yy <= best_xy ? 1.0f : __fdiv_rn(best_xy, __fadd_rn(best_yy, 1.0f));
  const float xm = bx[MAXP2 - min(max(T - 1, 0), MAXP2)];
  const float x0 = bx[MAXP2 - min(max(T, 0), MAXP2)];
  const float xp = bx[MAXP2 - min(max(T + 1, 0), MAXP2)];
  *gain = fminf(pg, g);
  return max(2 * T + peak_offset(xm, x0, xp), MIN_PERIOD);
}

}  // namespace rnnt
