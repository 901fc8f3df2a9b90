// The pitch analysis of one stream, from its decimated pitch buffer to the
// period and both forward spectra, as device code shared by analysis.cu (the
// lag table and the analysis kernels) and frame.cu (the whole-chunk kernel).
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
constexpr int ANALYSIS_THREADS = 512;  // >= a stage's butterflies and the fine lags

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
// f64 (load_ds64), into part [TAP_SLICES][E][NLAGS] (E = 2 with ENERGY, else
// 1): acc[i] = sum_j ds[384+j] ds[i+j] and, with ENERGY, the lag-window
// energy e[i] = sum_j ds[i+j]^2, over the slice's taps in ascending order.
// Per tap, one shared load of ds[i+j] (a window of LAG_TILE values slides
// through registers) and one broadcast of x[j] feed LAG_TILE multiply-adds
// (twice that with ENERGY), with no conversion.
template <bool ENERGY>
__device__ __forceinline__ void lag_partials(const double* d, int t, double* part) {
  const int slice = t / SLICE_LANES, tile = t - slice * SLICE_LANES;
  if (tile >= LAG_TILES) return;
  const int i0 = tile * LAG_TILE, j0 = slice * TAP_SLICE;
  const double* x = d + XOFF + j0;
  const double* y = d + i0 + j0;
  double acc[LAG_TILE], e[LAG_TILE], w[LAG_TILE];
#pragma unroll
  for (int r = 0; r < LAG_TILE; ++r) {
    acc[r] = 0.0;
    e[r] = 0.0;
    w[r] = y[r];
  }
#pragma unroll
  for (int j = 0; j < TAP_SLICE; ++j) {
    const double xj = x[j];
#pragma unroll
    for (int r = 0; r < LAG_TILE; ++r) {
      acc[r] = fma(xj, w[r], acc[r]);
      if (ENERGY) e[r] = fma(w[r], w[r], e[r]);
    }
#pragma unroll
    for (int r = 0; r + 1 < LAG_TILE; ++r) w[r] = w[r + 1];
    w[LAG_TILE - 1] = y[j + LAG_TILE];
  }
  double* p = part + slice * (ENERGY ? 2 : 1) * NLAGS + i0;
#pragma unroll
  for (int r = 0; r < LAG_TILE; ++r) {
    p[r] = acc[r];
    if (ENERGY) p[NLAGS + r] = e[r];
  }
}

// bx[i] (and, with ENERGY, yy[i]) from the slices' partial sums, added in
// one fixed order and rounded once.
template <bool ENERGY>
__device__ __forceinline__ void lag_finish(const double* part, int i, float* bx,
                                           float* yy) {
  constexpr int W = (ENERGY ? 2 : 1) * NLAGS;
  const double* p = part + i;
  bx[i] = (float)((p[0] + p[W]) + (p[2 * W] + p[3 * W]));
  if (ENERGY)
    yy[i] = (float)((p[NLAGS] + p[W + NLAGS]) + (p[2 * W + NLAGS] + p[3 * W + NLAGS]));
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
// Returns T0 in 48 kHz units; writes the pitch gain to *gain.
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

// Shared memory of analysis_body: ds in f64 and the lag table's partial
// sums, then the FFT's buffer.
struct __align__(16) AnalysisSmem {
  struct Lag {
    double ds64[DS_PAD];
    double part[TAP_SLICES * 2 * NLAGS];
  };
  union {
    Lag lag;
    double2 fft[WS];
  };
  float bx[NLAGS], yy[NLAGS], xc2[NL2], q[NL2];
  int start;
};

// The analysis of one stream by a block of ANALYSIS_THREADS threads, from
// its decimated pitch buffer ds [864] (device or shared memory), the frame
// x and the analysis memory mem [480], the pitch buffer pbuf [1728], the
// coarse candidates bp0, bp1 and the previous period and gain; tw holds
// the 960 base twiddles and then the FFT table.  Writes X and P [962]
// re|im, and from thread 0 *T0_out and *gain_out (visible to the block
// after the next barrier).
__device__ __forceinline__ void analysis_body(
    AnalysisSmem& sm, const float* ds, const float* mem, const float* x,
    const float* pbuf, int bp0, int bp1, int prev_period, float prev_gain,
    const float* __restrict__ window, const double2* __restrict__ tw,
    float* X, float* P, int* T0_out, float* gain_out) {
  const int tid = threadIdx.x;
  load_ds64(sm.lag.ds64, ds, tid, blockDim.x);
  __syncthreads();
  if (tid < LAG_THREADS) lag_partials<true>(sm.lag.ds64, tid, sm.lag.part);
  __syncthreads();
  for (int i = tid; i < NLAGS; i += blockDim.x) lag_finish<true>(sm.lag.part, i, sm.bx, sm.yy);
  __syncthreads();
  // fine search within 2 lags of twice the coarse candidates: ratio
  // (xc 1e-12)^2 / max(1 + yy, 1) over lags with xc > 0
  if (tid < NL2) {
    const int b0 = 2 * bp0, b1 = 2 * bp1;
    const bool cand = abs(tid - b0) <= 2 || abs(tid - b1) <= 2;
    const float xc = cand ? fmaxf(sm.bx[tid], -1.0f) : 0.0f;
    sm.xc2[tid] = xc;
    const float num = __fmul_rn((float)1e-12, xc);
    sm.q[tid] = xc > 0.0f
        ? __fdiv_rn(__fmul_rn(num, num), fmaxf(__fadd_rn(1.0f, sm.yy[tid]), 1.0f))
        : -CUDART_INF_F;
  }
  __syncthreads();
  if (tid < 32) {
    // the first lag of the largest ratio (torch.argmax); all -inf gives 0
    float best = -CUDART_INF_F;
    int at = NL2;
    for (int i = tid; i < NL2; i += 32)
      if (sm.q[i] > best || (at == NL2 && sm.q[i] == best)) { best = sm.q[i]; at = i; }
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oa = __shfl_xor_sync(0xffffffffu, at, off);
      if (ob > best || (ob == best && oa < at)) { best = ob; at = oa; }
    }
    if (tid == 0) {
      float gain;
      const int T0 = resolve_period(sm.bx, sm.yy, sm.xc2, at, prev_period,
                                    prev_gain, &gain);
      *T0_out = T0;
      *gain_out = gain;
      sm.start = min(max(PBUF - WS - T0, 0), MAX_START);
    }
  }
  __syncthreads();
  const float* p = pbuf + sm.start;
  static_assert(ANALYSIS_THREADS >= 512, "the split butterflies of one stream");
  fwd_spectra<true, 1>(
      1, sm.fft, tw, tw + WS, window,
      [&](int, int n) { return n < FS ? mem + n : x + (n - FS); },
      [&](int) { return p; },
      [&](int, int seq, int k, float re, float im) {
        float* o = seq ? P : X;
        o[k] = re;
        o[NBIN + k] = im;
      });
}

}  // namespace rnnt
