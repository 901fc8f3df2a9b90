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
// rnnt_lag_energy_table runs the analysis' lag table and energies alone, so
// that they can be held against their plain versions.
//
// What bounds them: a direct correlation is 385 x 480 f64 multiply-adds per
// stream (twice that with the energies) against 5 KB of input and output,
// and the two spectra two 480-point complex f64 FFTs (~44 k f64 operations),
// so f64 arithmetic bounds both kernels.  The lag table alone converts ds to
// f64 once, as it enters shared memory, and gives each thread 7 consecutive
// lags and a slice of 120 taps, with a window of ds sliding through its
// registers (analysis_body.cuh: lag_partials): per tap one conflict-free
// shared load and one broadcast feed 7 multiply-adds on the f64 pipe, and
// the 4 slices of a lag meet in one fixed order through shared memory.
//
// The analysis puts the lag table and its energies on the f64 tensor cores,
// at twice the f64 pipe's rate (analysis_body.cuh: lag_energy_mma): per
// stream 3 tiles of 128 lags, each the 16 x 8 output of a chain of mma.sync
// m16n8k8 f64 products over 74 k-steps of 8 taps for each table (A a Hankel
// matrix of ds, squared for the energies, B a Toeplitz band of x or its 0/1
// band), 444 products and 455 k multiply-adds a stream, so the tensor-core
// rate bounds the products (m8n8k4, the other f64 shape, runs at half the
// rate: scripts/torch_f64_mma_rate.py).  A block takes AG streams,
// LAG_WARPS = 2 warps each: one runs a stream's lag table, the other its
// energies; one warp a stream then runs the fine search's ratio, its argmax
// and the ladder (unrolled) on its lane 0, and every thread runs a
// butterfly of the block's forward FFTs (spectral_common.cuh:fwd_spectra,
// the forward-spectrum kernel's shape: 64 threads a stream, the twiddles
// staged in shared memory), so X and P equal the forward kernel's bit for
// bit.  4 blocks (16 warps, ~47 KB of shared memory and 122 registers a
// thread each) stay resident on an SM, enough warps for the tensor cores.
// The earlier shape, one stream to a 512-thread block, ran the lag table on
// the f64 pipe in 4 tap slices, its FFT butterflies split over 4 and 8
// lanes to keep 512 threads busy on one stream, and its ladder on one
// thread while 511 waited at the barrier; with the streams of a block
// taken together, neither the split FFT nor the idle block is needed.  The
// TPU's DFT-1024 correlation, one-hot lookups and grouped ladder windows
// work around a matrix unit and are not carried over.
//
// Numerics: pitch ranking sits on ~1e-4 knife edges.  The lag table and the
// energies sum products of two floats, which are exact in f64, in f64 and
// round once to f32, as the plain versions (f64 convolutions) do; only the
// order of the f64 additions differs between the kernels and the plain
// versions.  Every f32 step of the ranking and the ladder uses the _rn
// intrinsics, so nvcc contracts nothing into an FMA that PyTorch does not,
// and constants are rounded from double as PyTorch rounds a Python scalar.

#include "analysis_body.cuh"

namespace {

using namespace rnnt;

constexpr int XG = 2;                              // streams per block, lag table
constexpr int XCORR_THREADS = XG * LAG_THREADS;    // 512

__global__ void __launch_bounds__(XCORR_THREADS)
xcorr_kernel(const float* __restrict__ ds, float* __restrict__ bx, int S) {
  __shared__ double s_ds[XG][DS_PAD];
  __shared__ double s_part[XG][TAP_SLICES * NLAGS];
  const int g = threadIdx.x / LAG_THREADS, t = threadIdx.x - g * LAG_THREADS;
  const int s = blockIdx.x * XG + g;
  if (s < S) load_ds64(s_ds[g], ds + (size_t)s * DS, t, LAG_THREADS);
  __syncthreads();
  if (s < S) lag_partials(s_ds[g], t, s_part[g]);
  __syncthreads();
  if (s < S)
    for (int i = t; i < NLAGS; i += LAG_THREADS)
      lag_finish(s_part[g], i, bx + (size_t)s * NLAGS);
}

constexpr int AG = 2;                              // streams per block, analysis
constexpr int AN_THREADS = AG * LAG_WARPS * 32;    // 128
// the radix-2 butterflies of the block's FFTs a thread
constexpr int AN_K = (AG * FH / FFT_R0 + AN_THREADS - 1) / AN_THREADS;
static_assert(LAG_WARPS * 32 >= FFT_LANES, "a butterfly of each stream a thread");

// The analysis' shared memory: ds in f64 and the tables of the fine search,
// then the FFT's buffer in their place; the twiddles and the windows' starts.
struct __align__(16) AnalysisSmem {
  struct Lag {
    double ds[AG][DS];
    float bx[AG][NLAGS], yy[AG][NLAGS], xc2[AG][NL2], q[AG][NL2];
  };
  union {
    Lag lag;
    double2 fft[AG * 2 * FH];
  };
  double2 tw[NBIN + FFT_TABLE];    // the base twiddles k <= 480, the FFT table
  int start[AG];
};

// ds rows s0 .. s0 + ns - 1 into d [AG][DS] f64 by the block's AN_THREADS
// threads, 4 values a load where ds is 16-byte aligned, every load of a
// thread issued before its stores.
__device__ __forceinline__ void stage_ds(double* d, const float* ds, int s0, int ns) {
  static_assert(DS % 4 == 0, "rows of whole float4s");
  constexpr int N4 = AG * DS / 4, PER = (N4 + AN_THREADS - 1) / AN_THREADS;
  if (reinterpret_cast<uintptr_t>(ds) & 15) {
    for (int i = threadIdx.x; i < ns * DS; i += AN_THREADS) d[i] = (double)ds[(size_t)s0 * DS + i];
    return;
  }
  const float4* src = reinterpret_cast<const float4*>(ds + (size_t)s0 * DS);
  float4 v[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = threadIdx.x + u * AN_THREADS;
    if (i < ns * (DS / 4)) v[u] = src[i];
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = threadIdx.x + u * AN_THREADS;
    if (i < ns * (DS / 4)) {
      double2* o = reinterpret_cast<double2*>(d + 4 * i);
      o[0] = make_double2(v[u].x, v[u].y);
      o[1] = make_double2(v[u].z, v[u].w);
    }
  }
}

__global__ void __launch_bounds__(AN_THREADS, 4)
analysis_kernel(const float* __restrict__ mem, const float* __restrict__ x,
                const float* __restrict__ pbuf, const float* __restrict__ ds,
                const int* __restrict__ bp0, const int* __restrict__ bp1,
                const int* __restrict__ prev_period,
                const float* __restrict__ prev_gain,
                const float* __restrict__ window, const double2* __restrict__ tw,
                float* __restrict__ X, float* __restrict__ P,
                int* __restrict__ T0_out, float* __restrict__ gain_out, int S) {
  __shared__ AnalysisSmem sm;
  const int s0 = blockIdx.x * AG, ns = min(AG, S - s0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  stage_ds(sm.lag.ds[0], ds, s0, ns);
#pragma unroll
  for (int i = threadIdx.x; i < NBIN + FFT_TABLE; i += AN_THREADS)
    sm.tw[i] = i < NBIN ? tw[i] : tw[WS + i - NBIN];
  __syncthreads();
  lag_energy_mma<LAG_WARPS>(ns, sm.lag.ds[0], DS, sm.lag.bx[0], sm.lag.yy[0], NLAGS);
  __syncthreads();
  if (warp < ns) {                                   // a warp a stream
    const int s = s0 + warp;
    const float* bx = sm.lag.bx[warp];
    const float* yy = sm.lag.yy[warp];
    const int b0 = bp0[s], b1 = bp1[s];
    for (int l = lane; l < NL2; l += 32)
      fine_ratio(bx, yy, l, b0, b1, sm.lag.xc2[warp], sm.lag.q[warp]);
    __syncwarp();
    const int at = warp_argmax(sm.lag.q[warp], NL2, -1);
    if (lane == 0) {
      float gain;
      const int T0 = resolve_period<14>(bx, yy, sm.lag.xc2[warp], at, prev_period[s],
                                    prev_gain[s], &gain);
      T0_out[s] = T0;
      gain_out[s] = gain;
      sm.start[warp] = min(max(PBUF - WS - T0, 0), MAX_START);
    }
  }
  __syncthreads();
  fwd_spectra<AN_K>(
      ns, sm.fft, sm.tw, sm.tw + NBIN, window,
      [&](int g, int n) {
        const size_t s = s0 + g;
        return n < FS ? mem + s * FS + n : x + s * FS + (n - FS);
      },
      [&](int g) { return pbuf + (size_t)(s0 + g) * PBUF + sm.start[g]; },
      [&](int g, int seq, int k, float re, float im) {
        float* o = (seq ? P : X) + (size_t)(s0 + g) * 2 * NBIN;
        o[k] = re;
        o[NBIN + k] = im;
      });
}

__global__ void __launch_bounds__(AN_THREADS)
lag_energy_kernel(const float* __restrict__ ds, float* __restrict__ bx,
                  float* __restrict__ yy, int S) {
  __shared__ double s_ds[AG][DS];
  const int s0 = blockIdx.x * AG, ns = min(AG, S - s0);
  stage_ds(s_ds[0], ds, s0, ns);
  __syncthreads();
  lag_energy_mma<LAG_WARPS>(ns, s_ds[0], DS, bx + (size_t)s0 * NLAGS,
                            yy + (size_t)s0 * NLAGS, NLAGS);
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
  analysis_kernel<<<(S + AG - 1) / AG, AN_THREADS, 0, (cudaStream_t)stream>>>(
      mem, x, pitch_buf, ds, bp0, bp1, prev_period, prev_gain, window,
      reinterpret_cast<const double2*>(twiddles), X, P, T0, gain, S);
  return (int)cudaGetLastError();
}

// ds [S, 864] -> the analysis' lag table bx and energies yy [S, 385].
int rnnt_lag_energy_table(const float* ds, float* bx, float* yy, int S, void* stream) {
  if (S <= 0) return 0;
  lag_energy_kernel<<<(S + AG - 1) / AG, AN_THREADS, 0, (cudaStream_t)stream>>>(
      ds, bx, yy, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
