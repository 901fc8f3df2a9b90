// Forward and inverse 960-point real spectra, and the post-filter with
// synthesis, for a batch of streams, on Hopper (sm_90a).
//
// rnnt_forward_spectral replaces the TPU kernel
// rnnoise_tpu/dsp/pallas_spectral.py:forward_spectral (_fwd_kernel with
// _take_window_vmem and _dif_forward): X is the DFT of the Vorbis-windowed
// [analysis_mem | x], P the DFT of the windowed pitch_buf[start : start+960]
// (the window is gathered here, per stream), both scaled by 1/960 and stored
// as [S, 962] re|im in natural bin order.
//
// rnnt_inverse_spectral replaces pallas_spectral.py:inverse_spectral
// (_inv_kernel -> _dif_inverse): the unscaled inverse DFT of a conjugate-
// symmetric [S, 962] re|im spectrum (bin weights 1 at k = 0 and 480, 2
// elsewhere), times the synthesis window -> [S, 960].
//
// rnnt_postfilter_synthesis replaces pallas_spectral.py:postfilter_synthesis
// (_post_kernel -> _post_body): the delayed frame's comb filter (the band
// strength r interpolated to bins, X += r P, renormalised to the band
// energies), the gain cap max(g, .6 lastg) interpolated and applied, the
// silence blend and the lastg update, then the inverse DFT, the synthesis
// window and the overlap-add with synthesis_mem.
//
// What bounds them: the forward spectra move ~15 KB of input and output
// per stream and, as two 480-point complex f64 FFTs (spectral_common.cuh),
// do ~44 k f64 operations per stream, so device memory bounds them: a
// block of 128 threads takes 2 streams (46 KB of shared memory with the
// twiddles it reads, 4 blocks an SM, so that all streams of S = 1024 are in
// flight at once), loads each input pair of samples once, all of a thread's
// loads before its first store, runs the radix-2 stage into shared memory
// and the radix-16 and radix-15 stages in place there, a whole butterfly a
// thread, and writes X and P row by row.  Of the shapes tried on the H100
// (1 to 3 streams a block, 64 to 256 threads a stream, more blocks an SM at
// the price of spills, inputs double-buffered by cp.async), this was the
// fastest at S = 1024; butterflies split over 4 and 8 lanes (one stream a
// block) took 3x as long.  The twiddles come from an f64 table built in Python
// (dsp/fft_plan.py) and appended to the 960 base twiddles; every kernel here
// takes that extended table.
// The inverse moves ~7.7 KB a stream and, as one 480-point complex f64 FFT
// of the forward's stages (spectral_common.cuh:inv_spectra), does ~22 k f64
// operations, so it is shaped as the forward kernel: a block of 128 threads
// takes 4 streams (one sequence each, the same 46 KB of shared memory), a
// whole butterfly a thread.  The post-filter moves ~13 KB a stream and adds
// to the inverse's arithmetic ~3 k band operations a stream: with the band
// tables in their compact form (each bin touches two bands), an
// interpolation is 2 FMAs a bin and a band energy a sum over the band's own
// bins.  So it takes the inverse's shape: a block of 128 threads takes 4
// streams (47 KB of shared memory, 4 blocks an SM), each band-level step a
// (stream, band) a thread, each bin-level step the block's bins in turn, and
// the inverse a butterfly a thread.
//
// The forward spectra feed the pitch, band-energy and silence decisions,
// which sit on knife edges: a 2e-6 difference in X flips an int8 activation
// now and then, and the flip shows as a transient of a few LSB two frames
// long.  So the forward kernel windows and transforms in f64 and rounds each
// bin once to f32, as its plain version (an f64 DFT matmul) does; the two
// then agree to an ulp.  The inverse and the post-filter only shape the
// output (nothing after them decides on a threshold but the int16 rounding);
// their FFT runs in f64 all the same, so that it shares the forward's device
// code and exact twiddles, and rounds each sample once, after the window.
// Their plain versions sum in f32 (an f32 matmul); chip_smoke.py holds the
// two within 1e-4 of each row's largest magnitude.
//
// The post-filter itself is postfilter_body.cuh, which frame.cu shares.

#include <stdint.h>

#include "postfilter_body.cuh"

namespace {

using namespace rnnt;

constexpr int GF = 2;              // streams per block, forward
constexpr int GI = 4;              // streams per block, inverse
constexpr int FWD_THREADS = GF * FFT_LANES;   // 128: a butterfly of each stream
constexpr int INV_THREADS = GI * FH / FFT_R2;  // 128: a butterfly of each stream
constexpr int GP = 4;              // streams per block, post-filter
constexpr int POST_THREADS = GP * FH / FFT_R2;  // 128: a butterfly of each stream
static_assert(GI * FH / FFT_R1 <= INV_THREADS && GP * FH / FFT_R1 <= POST_THREADS &&
              GP * NB <= POST_THREADS, "the inverse's stages need these threads (inv_spectra)");

__global__ void __launch_bounds__(FWD_THREADS, 4)
forward_kernel(const float* __restrict__ mem, const float* __restrict__ x,
               const float* __restrict__ pbuf, const int* __restrict__ start,
               const float* __restrict__ window,
               const double2* __restrict__ tw, float* __restrict__ X,
               float* __restrict__ P, int S) {
  __shared__ double2 s_z[GF * WS];                // 30 KB: 2 sequences a stream
  const int s0 = blockIdx.x * GF, ns = min(GF, S - s0);
  // the twiddles the FFT reads (the base table's first 481, then the FFT
  // table) staged in shared memory; the first stage's barrier orders them
  __shared__ double2 s_tw[NBIN + FFT_TABLE];
  for (int i = threadIdx.x; i < NBIN + FFT_TABLE; i += blockDim.x)
    s_tw[i] = i < NBIN ? tw[i] : tw[WS + i - NBIN];
  fwd_spectra<(GF * FH / FFT_R0 + FWD_THREADS - 1) / FWD_THREADS>(
      ns, s_z, s_tw, s_tw + NBIN, window,
      [&](int g, int n) {
        const size_t s = s0 + g;
        return n < FS ? mem + s * FS + n : x + s * FS + (n - FS);
      },
      [&](int g) {
        const size_t s = s0 + g;
        return pbuf + s * PBUF + min(max(start[s], 0), MAX_START);
      },
      [&](int g, int seq, int k, float re, float im) {
        float* o = (seq ? P : X) + (size_t)(s0 + g) * 2 * NBIN;
        o[k] = re;
        o[NBIN + k] = im;
      });
}

__global__ void __launch_bounds__(INV_THREADS, 4)
inverse_kernel(const float* __restrict__ Y, const float* __restrict__ window,
               const double2* __restrict__ tw, float* __restrict__ out, int S) {
  __shared__ double2 s_z[GI * FH];                // 30 KB: one sequence a stream
  // the twiddles the inverse reads: the base table's first 480, then the
  // FFT table
  __shared__ double2 s_tw[FH + FFT_TABLE];
  const int s0 = blockIdx.x * GI, ns = min(GI, S - s0);
  for (int i = threadIdx.x; i < FH + FFT_TABLE; i += blockDim.x)
    s_tw[i] = i < FH ? tw[i] : tw[WS + i - FH];
  __syncthreads();
  inv_spectra(
      ns, s_z, s_tw, s_tw + FH, window,
      [&](int g, int k) {
        const float* y = Y + (size_t)(s0 + g) * 2 * NBIN;
        return make_float2(y[k], y[NBIN + k]);
      },
      [&](int g, int n, float2 lo, float2 hi) {
        float* o = out + (size_t)(s0 + g) * WS + n;
        *reinterpret_cast<float2*>(o) = lo;
        *reinterpret_cast<float2*>(o + FS) = hi;
      });
}

__global__ void __launch_bounds__(POST_THREADS, 4)
postfilter_kernel(const float* __restrict__ dX, const float* __restrict__ dP,
                  const float* __restrict__ dEx, const float* __restrict__ dEp,
                  const float* __restrict__ dExp, const float* __restrict__ g,
                  const float* __restrict__ lastg, const float* __restrict__ Ex,
                  const uint8_t* __restrict__ silence,
                  const float* __restrict__ smem,
                  const float4* __restrict__ pairs, const int2* __restrict__ ranges,
                  const float* __restrict__ window, const double2* __restrict__ tw,
                  float* __restrict__ out, float* __restrict__ smem_out,
                  float* __restrict__ lastg_out, int S) {
  extern __shared__ __align__(16) unsigned char post_smem[];
  PostSmem<GP>& sm = *reinterpret_cast<PostSmem<GP>*>(post_smem);
  __shared__ PostIO io[GP];
  const int s0 = blockIdx.x * GP, ns = min(GP, S - s0);
  if (threadIdx.x < ns) {
    const size_t s = s0 + threadIdx.x, b = s * NB, row = s * FS;
    io[threadIdx.x] = PostIO{dX + s * 2 * NBIN, dP + s * 2 * NBIN, dEx + b, dEp + b,
                             dExp + b, g + b, lastg + b, Ex + b, smem + row,
                             smem_out + row, lastg_out + b, silence[s] != 0};
  }
  __syncthreads();
  postfilter_streams(
      ns, sm, io, pairs, ranges, window, tw, tw + WS,
      [&](int gg, int n, float v) { out[(size_t)(s0 + gg) * FS + n] = v; });
}

}  // namespace

extern "C" {

// mem, x [S, 480]; pitch_buf [S, 1728]; start [S] int32 (clamped to
// [0, 768]); window [960]; twiddles [960 + 509] f64 pairs: (cos, sin) of
// 2 pi m / 960, then the FFT table (dsp/fft_plan.py:fft_table, 509); X, P
// [S, 962].  Returns the CUDA error code of the launch.
int rnnt_forward_spectral(const float* mem, const float* x,
                          const float* pitch_buf, const int* start,
                          const float* window, const double* twiddles,
                          float* X, float* P, int S, void* stream) {
  if (S <= 0) return 0;
  forward_kernel<<<(S + GF - 1) / GF, FWD_THREADS, 0, (cudaStream_t)stream>>>(
      mem, x, pitch_buf, start, window,
      reinterpret_cast<const double2*>(twiddles), X, P, S);
  return (int)cudaGetLastError();
}

// Y [S, 962] re|im; window [960]; twiddles [960 + 509] f64 pairs, as for
// rnnt_forward_spectral; out [S, 960].
int rnnt_inverse_spectral(const float* Y, const float* window,
                          const double* twiddles, float* out, int S,
                          void* stream) {
  if (S <= 0) return 0;
  inverse_kernel<<<(S + GI - 1) / GI, INV_THREADS, 0, (cudaStream_t)stream>>>(
      Y, window, reinterpret_cast<const double2*>(twiddles), out, S);
  return (int)cudaGetLastError();
}

// dX, dP [S, 962] re|im (the delayed frame); dEx, dEp, dExp, g, lastg, Ex
// [S, 32]; silence [S] bytes (0 or 1); synthesis_mem [S, 480]; pairs
// [2, 481, 4] f32 and ranges [32, 2] int32, the compact band tables
// (postfilter_body.cuh); window [960]; twiddles [960 + 509] f64 pairs, as
// for rnnt_forward_spectral.  Writes out [S, 480], synthesis_mem_out
// [S, 480], lastg_out [S, 32].
int rnnt_postfilter_synthesis(const float* dX, const float* dP, const float* dEx,
                              const float* dEp, const float* dExp, const float* g,
                              const float* lastg, const float* Ex,
                              const uint8_t* silence, const float* synthesis_mem,
                              const float* pairs, const int* ranges,
                              const float* window, const double* twiddles,
                              float* out, float* synthesis_mem_out,
                              float* lastg_out, int S, void* stream) {
  if (S <= 0) return 0;
  const int smem = (int)sizeof(PostSmem<GP>);
  cudaError_t e = cudaFuncSetAttribute(
      postfilter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  postfilter_kernel<<<(S + GP - 1) / GP, POST_THREADS, smem, (cudaStream_t)stream>>>(
      dX, dP, dEx, dEp, dExp, g, lastg, Ex, silence, synthesis_mem,
      reinterpret_cast<const float4*>(pairs), reinterpret_cast<const int2*>(ranges),
      window, reinterpret_cast<const double2*>(twiddles), out, synthesis_mem_out,
      lastg_out, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
