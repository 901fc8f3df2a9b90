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
// stream (twice that with the energies) against 5 KB of input and output,
// and the two spectra two 480-point complex f64 FFTs (~44 k f64 operations), so
// the f64 issue rate bounds the lag table and the analysis.  The lag table
// converts ds to f64 once, as it enters shared memory, and gives each
// thread 7 consecutive lags and a slice of 120 taps, with a window of ds
// sliding through its registers (analysis_body.cuh: lag_partials): per tap
// one conflict-free shared load and one broadcast feed 7 multiply-adds, and
// the 4 slices of a lag meet in one fixed order through shared memory.  The analysis is one block
// per stream; the ranking and the ladder are serial per stream (one thread:
// 14 candidate steps of a few operations each), and the spectra share
// spectral_common.cuh's FFT with the forward-spectrum kernel: with one
// stream a block, its radix-16 and radix-15 butterflies are split over 4
// and 8 lanes (the same operations in the same order), and X and P equal
// the forward kernel's bit for bit.  The TPU's DFT-1024 correlation, one-hot
// lookups and grouped ladder windows work around a matrix unit and are not
// carried over.
//
// Numerics: pitch ranking sits on ~1e-4 knife edges.  The lag table and the
// energies sum products of two floats, which are exact in f64, in f64 and
// round once to f32, as the plain versions (f64 convolutions) do; every f32
// step of the ranking and the ladder uses the _rn intrinsics, so nvcc
// contracts nothing into an FMA that PyTorch does not, and constants are
// rounded from double as PyTorch rounds a Python scalar.
//
// The analysis itself is analysis_body.cuh, which frame.cu shares.

#include "analysis_body.cuh"

namespace {

using namespace rnnt;

constexpr int XG = 2;                              // streams per block
constexpr int XCORR_THREADS = XG * LAG_THREADS;    // 512

__global__ void __launch_bounds__(XCORR_THREADS)
xcorr_kernel(const float* __restrict__ ds, float* __restrict__ bx, int S) {
  __shared__ double s_ds[XG][DS_PAD];
  __shared__ double s_part[XG][TAP_SLICES * NLAGS];
  const int g = threadIdx.x / LAG_THREADS, t = threadIdx.x - g * LAG_THREADS;
  const int s = blockIdx.x * XG + g;
  if (s < S) load_ds64(s_ds[g], ds + (size_t)s * DS, t, LAG_THREADS);
  __syncthreads();
  if (s < S) lag_partials<false>(s_ds[g], t, s_part[g]);
  __syncthreads();
  if (s < S)
    for (int i = t; i < NLAGS; i += LAG_THREADS)
      lag_finish<false>(s_part[g], i, bx + (size_t)s * NLAGS, nullptr);
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
  __shared__ AnalysisSmem sm;
  const int s = blockIdx.x;
  analysis_body(sm, ds + (size_t)s * DS, mem + (size_t)s * FS, x + (size_t)s * FS,
                pbuf + (size_t)s * PBUF, bp0[s], bp1[s], prev_period[s],
                prev_gain[s], window, tw, X + (size_t)s * 2 * NBIN,
                P + (size_t)s * 2 * NBIN, T0_out + s, gain_out + s);
}

}  // namespace

extern "C" {

// ds [S, 864] -> bx [S, 385].  Returns the CUDA error code of the launch.
int rnnt_lag_corr_table(const float* ds, float* bx, int S, void* stream) {
  if (S <= 0) return 0;
  xcorr_kernel<<<(S + XG - 1) / XG, XCORR_THREADS, 0, (cudaStream_t)stream>>>(
      ds, bx, S);
  return (int)cudaGetLastError();
}

// mem, x [S, 480]; pitch_buf [S, 1728]; ds [S, 864]; bp0, bp1 [S] int32
// (coarse candidates, 12 kHz lags); prev_period [S] int32 (48 kHz units);
// prev_gain [S]; window [960]; twiddles [960 + 509] f64 pairs (as
// rnnt_forward_spectral's).  Writes X, P [S, 962]
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
