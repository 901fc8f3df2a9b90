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
constexpr int ANALYSIS_THREADS = 512;  // 256 even bins | 256 odd bins

__constant__ int SECOND_CHECK[16] = {0, 0, 3, 2, 3, 2, 5, 2, 3, 2, 3, 2, 5, 2, 3, 2};

__device__ __forceinline__ void load_ds(float* s_ds, const float* ds) {
  for (int i = threadIdx.x; i < DS; i += blockDim.x) s_ds[i] = ds[i];
}

// bx[i] and, with ENERGY, the lag-window energy sum_{j<480} ds[i+j]^2, each
// summed in f64 and rounded once
template <bool ENERGY>
__device__ __forceinline__ void lag_row(const float* s_ds, int i, float* bx,
                                        float* yy) {
  const float* x = s_ds + XOFF;
  const float* y = s_ds + i;
  double acc = 0.0, e = 0.0;
#pragma unroll 8
  for (int j = 0; j < N2; ++j) {
    const double v = y[j];
    acc = fma((double)x[j], v, acc);
    if (ENERGY) e = fma(v, v, e);
  }
  bx[i] = (float)acc;
  if (ENERGY) yy[i] = (float)e;
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

// Shared memory of analysis_body.
struct __align__(16) AnalysisSmem {
  double u[2 * 2 * FS];            // X, P folded halves
  float ds[DS];
  float bx[NLAGS], yy[NLAGS], xc2[NL2], q[NL2];
  int start;
};

// The analysis of one stream by a block of ANALYSIS_THREADS threads, from
// its decimated pitch buffer ds (copied into sm.ds unless it is sm.ds), the
// frame x and the analysis memory mem [480], the pitch buffer pbuf [1728],
// the coarse candidates bp0, bp1 and the previous period and gain.  Writes
// X and P [962] re|im, and from thread 0 *T0_out and *gain_out (visible to
// the block after the next barrier).
__device__ __forceinline__ void analysis_body(
    AnalysisSmem& sm, const float* ds, const float* mem, const float* x,
    const float* pbuf, int bp0, int bp1, int prev_period, float prev_gain,
    const float* __restrict__ window, const double2* __restrict__ tw,
    float* X, float* P, int* T0_out, float* gain_out) {
  const int tid = threadIdx.x;
  if (ds != sm.ds) load_ds(sm.ds, ds);
  for (int n = tid; n < FS; n += blockDim.x) {
    const double w0 = window[n], w1 = window[n + FS];
    fwd_fold(sm.u, n, w0 * mem[n], w1 * x[n]);
  }
  __syncthreads();
  if (tid < NLAGS) lag_row<true>(sm.ds, tid, sm.bx, sm.yy);
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
  for (int n = tid; n < FS; n += blockDim.x) {
    const double w0 = window[n], w1 = window[n + FS];
    fwd_fold(sm.u + 2 * FS, n, w0 * p[n], w1 * p[n + FS]);
  }
  __syncthreads();

  const int par = tid >= ANALYSIS_THREADS / 2;
  const int k = 2 * (tid & (ANALYSIS_THREADS / 2 - 1)) + par;
  if (k < NBIN) {
    double re[2], im[2];
    fwd_bin_sums<2>(sm.u, k, tw, re, im);
    fwd_store(X, k, re[0], im[0]);
    fwd_store(P, k, re[1], im[1]);
  }
}

}  // namespace rnnt
