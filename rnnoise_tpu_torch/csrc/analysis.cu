// Pitch analysis for a batch of streams, on Hopper (sm_90a): the lag-
// correlation table alone, and the fused analysis from the coarse pitch
// candidates to both forward spectra.
//
// rnnt_lag_corr_table replaces the TPU kernel
// rnnoise_tpu/dsp/pallas_xcorr.py:lag_corr_table_pallas (_xcorr_kernel):
// bx[i] = sum_{j<480} ds[384+j] ds[i+j] for i <= 384, from the whitened,
// decimated pitch buffer ds [S, 864].
//
// rnnt_analysis_spectral replaces pallas_analysis.py:analysis_spectral
// (_analysis_kernel -> _pitch_body, then the window and _dif_forward): the
// lag table and the 385 sliding 480-tap energies of ds; the fine search with
// its pseudo-interpolation (pitch.c:281-385); the remove_doubling ladder for
// k = 2..15 (pitch.c:422-528); the final +-1 offset; then, with the period
// T0 resolved, the windows [mem | x] and pitch_buf[768 - T0 : 1728 - T0] and
// both forward DFTs, as rnnt_forward_spectral computes them.
//
// What bounds them: a direct correlation is 385 x 480 f64 multiply-adds per
// stream, and the two DFTs 2 x 481 x 480, against 5-19 KB of input and
// output per stream, so the f64 issue rate bounds them, not device memory.
// The design is one block per stream with ds in shared memory, one thread
// per lag; the ranking and the ladder are serial per stream (one thread:
// 14 candidate steps of a few operations each), and the DFTs share
// spectral_common.cuh with the forward-spectrum kernel, so X and P equal its
// output bit for bit.  The TPU's DFT-1024 correlation, one-hot lookups and
// grouped ladder windows work around a matrix unit and are not carried over.
//
// Numerics: pitch ranking sits on ~1e-4 knife edges.  The lag table and the
// energies sum products of two floats, which are exact in f64, in f64 and
// round once to f32, as the plain versions (f64 convolutions) do; every f32
// step of the ranking and the ladder uses the _rn intrinsics, so nvcc
// contracts nothing into an FMA that PyTorch does not, and constants are
// rounded from double as PyTorch rounds a Python scalar.

#include <math_constants.h>
#include <stdint.h>

#include "spectral_common.cuh"

namespace {

using namespace rnnt;

constexpr int DS = 864;            // decimated pitch buffer
constexpr int XOFF = 384;          // x = ds[384 : 864]
constexpr int N2 = 480;            // correlation length
constexpr int NLAGS = 385;         // table entries, lags 0..384
constexpr int MAXP2 = 384;         // max period, 24 kHz units
constexpr int MINP2 = 30;          // min period, 24 kHz units
constexpr int NL2 = 294;           // fine-search lags
constexpr int MIN_PERIOD = 60;
constexpr int MAX_PERIOD = 768;
constexpr int XCORR_THREADS = 416;     // 13 warps: one lag each
constexpr int ANALYSIS_THREADS = 512;  // 256 even bins | 256 odd bins

__constant__ int SECOND_CHECK[16] = {0, 0, 3, 2, 3, 2, 5, 2, 3, 2, 3, 2, 5, 2, 3, 2};

__device__ __forceinline__ void load_ds(float* s_ds, const float* __restrict__ ds) {
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

__global__ void __launch_bounds__(XCORR_THREADS)
xcorr_kernel(const float* __restrict__ ds, float* __restrict__ bx) {
  __shared__ float s_ds[DS];
  const int s = blockIdx.x;
  load_ds(s_ds, ds + (size_t)s * DS);
  __syncthreads();
  const int i = threadIdx.x;
  if (i < NLAGS) lag_row<false>(s_ds, i, bx + (size_t)s * NLAGS, nullptr);
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

__global__ void __launch_bounds__(ANALYSIS_THREADS)
analysis_kernel(const float* __restrict__ mem, const float* __restrict__ x,
                const float* __restrict__ pbuf, const float* __restrict__ ds,
                const int* __restrict__ bp0, const int* __restrict__ bp1,
                const int* __restrict__ prev_period,
                const float* __restrict__ prev_gain,
                const float* __restrict__ window, const double2* __restrict__ tw,
                float* __restrict__ X, float* __restrict__ P,
                int* __restrict__ T0_out, float* __restrict__ gain_out) {
  __shared__ float s_ds[DS];
  __shared__ float s_bx[NLAGS], s_yy[NLAGS], s_xc2[NL2], s_q[NL2];
  __shared__ __align__(16) double s_u[2 * 2 * FS];   // X, P folded halves
  __shared__ int s_start;
  const int s = blockIdx.x, tid = threadIdx.x;
  load_ds(s_ds, ds + (size_t)s * DS);
  for (int n = tid; n < FS; n += blockDim.x) {
    const double w0 = window[n], w1 = window[n + FS];
    fwd_fold(s_u, n, w0 * mem[(size_t)s * FS + n], w1 * x[(size_t)s * FS + n]);
  }
  __syncthreads();
  if (tid < NLAGS) lag_row<true>(s_ds, tid, s_bx, s_yy);
  __syncthreads();

  // fine search within 2 lags of twice the coarse candidates: ratio
  // (xc 1e-12)^2 / max(1 + yy, 1) over lags with xc > 0
  if (tid < NL2) {
    const int b0 = 2 * bp0[s], b1 = 2 * bp1[s];
    const bool cand = abs(tid - b0) <= 2 || abs(tid - b1) <= 2;
    const float xc = cand ? fmaxf(s_bx[tid], -1.0f) : 0.0f;
    s_xc2[tid] = xc;
    const float num = __fmul_rn((float)1e-12, xc);
    s_q[tid] = xc > 0.0f
        ? __fdiv_rn(__fmul_rn(num, num), fmaxf(__fadd_rn(1.0f, s_yy[tid]), 1.0f))
        : -CUDART_INF_F;
  }
  __syncthreads();
  if (tid < 32) {
    // the first lag of the largest ratio (torch.argmax); all -inf gives 0
    float best = -CUDART_INF_F;
    int at = NL2;
    for (int i = tid; i < NL2; i += 32)
      if (s_q[i] > best || (at == NL2 && s_q[i] == best)) { best = s_q[i]; at = i; }
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oa = __shfl_xor_sync(0xffffffffu, at, off);
      if (ob > best || (ob == best && oa < at)) { best = ob; at = oa; }
    }
    if (tid == 0) {
      float gain;
      const int T0 = resolve_period(s_bx, s_yy, s_xc2, at, prev_period[s],
                                    prev_gain[s], &gain);
      T0_out[s] = T0;
      gain_out[s] = gain;
      s_start = min(max(PBUF - WS - T0, 0), MAX_START);
    }
  }
  __syncthreads();
  const float* p = pbuf + (size_t)s * PBUF + s_start;
  for (int n = tid; n < FS; n += blockDim.x) {
    const double w0 = window[n], w1 = window[n + FS];
    fwd_fold(s_u + 2 * FS, n, w0 * p[n], w1 * p[n + FS]);
  }
  __syncthreads();

  const int par = tid >= ANALYSIS_THREADS / 2;
  const int k = 2 * (tid & (ANALYSIS_THREADS / 2 - 1)) + par;
  if (k >= NBIN) return;
  double re[2], im[2];
  fwd_bin_sums<2>(s_u, k, tw, re, im);
  fwd_store(X + (size_t)s * 2 * NBIN, k, re[0], im[0]);
  fwd_store(P + (size_t)s * 2 * NBIN, k, re[1], im[1]);
}

}  // namespace

extern "C" {

// ds [S, 864] -> bx [S, 385].  Returns the CUDA error code of the launch.
int rnnt_lag_corr_table(const float* ds, float* bx, int S, void* stream) {
  if (S <= 0) return 0;
  xcorr_kernel<<<S, XCORR_THREADS, 0, (cudaStream_t)stream>>>(ds, bx);
  return (int)cudaGetLastError();
}

// mem, x [S, 480]; pitch_buf [S, 1728]; ds [S, 864]; bp0, bp1 [S] int32
// (coarse candidates, 12 kHz lags); prev_period [S] int32 (48 kHz units);
// prev_gain [S]; window [960]; twiddles [960] f64.  Writes X, P [S, 962]
// re|im, T0 [S] int32 (48 kHz units), gain [S].
int rnnt_analysis_spectral(const float* mem, const float* x,
                           const float* pitch_buf, const float* ds,
                           const int* bp0, const int* bp1,
                           const int* prev_period, const float* prev_gain,
                           const float* window, const double* twiddles,
                           float* X, float* P, int* T0, float* gain, int S,
                           void* stream) {
  if (S <= 0) return 0;
  analysis_kernel<<<S, ANALYSIS_THREADS, 0, (cudaStream_t)stream>>>(
      mem, x, pitch_buf, ds, bp0, bp1, prev_period, prev_gain, window,
      reinterpret_cast<const double2*>(twiddles), X, P, T0, gain);
  return (int)cudaGetLastError();
}

}  // extern "C"
