// The main path's whole chunk for a batch of streams, on Hopper (sm_90a):
// T frames of rnnoise_process_frame (denoise.c:457-504) in one launch, int16
// in and out, the state carried across the frames inside the launch.
//
// rnnt_process_chunk replaces the TPU kernel
// rnnoise_tpu/dsp/pallas_frame.py:process_chunk_monokernel (_frame_kernel ->
// frame_body).  Per frame and stream, in the order of
// rnnoise_tpu_torch/denoise.py:
//   1. the HP biquad in closed form (dsp/biquad.py, "f64" rounding): the
//      479-tap Toeplitz input term and the state terms summed in f64 from
//      the exact f64 A-powers, each rounded once;
//   2. the pitch-buffer shift, staged through shared memory;
//   3. the 2x decimation, the 5 autocorrelations (f64, rounded once), the
//      order-4 Levinson with its early-out, the .9^i damping and the FIR5
//      (dsp/pitch.py:pitch_downsample);
//   4. the coarse search: 147 lags x 240 taps and their window energies
//      (f64, rounded once), find_best_pitch's top-2 by ratio with the first
//      of equal maxima;
//   5. the fine search, the doubling ladder, the window and both forward
//      spectra (analysis_body.cuh, as analysis.cu);
//   6. the band energies and correlations (f64, rounded once), the
//      log-energy follower (one thread, 32 steps), the E sum and both DCTs
//      (f64, rounded once) and the silence gate (compute_frame_features);
//   7. the network's step for the block's streams (rnn_body.cuh, as
//      rnn_step.cu);
//   8. the previous frame's post-filter and synthesis (postfilter_body.cuh,
//      as spectral.cu), the output rounded half away from zero and clipped
//      to int16.
// The TPU formulation stays behind: its permuted 488-wide layout, one-hot
// selections, bf16-X3 dots, the aliased coarse table, the incremental
// decimation carry, the closed form of the log-energy follower and its
// frames-per-step and VMEM limits.
//
// What bounds it: operations.  Per stream and frame it does ~0.5M f64
// operations (the lag table and energies 2 x 385 x 480 multiply-adds, the
// two forward spectra's FFTs ~44 k and the inverse's ~21 k, the biquad's
// Toeplitz term 480 x 479 / 2 multiply-adds) and reads the network's
// ~1.4 MB of weights (the int8 matrices' nonzero blocks and the f32
// weights, rnn_step.cu) once per block, against ~25 KB of state per
// stream, read and written once a chunk, and 2 KB of PCM per stream and
// frame in device memory.  The design: a block owns G = 8 streams for all
// T frames, so streams never synchronise across blocks and there is one
// launch per chunk (the fused configuration makes ~480 per frame,
// PERF.md).  G = 8 is the RNN step's own stream block: its products read
// each weight once for 8 streams, and at S = 1024 it gives 128 blocks for
// the H100's 132 SMs.  Within a block the per-stream spans (1-6, 8) take
// the 8 streams one after another on all 512 threads (the analysis's
// block), and the network takes the 8 together.  That keeps one block per
// SM with 16 warps, so the f64 issue rate is far from full: this is the
// simple design, and the one to make fast later.
//
// State: the block copies its streams' input state into the output state at
// t = 0 and then updates it there; the caller's state is only read.  The
// network's state alternates between the output state and a scratch copy
// (frame t reads what frame t-1 wrote, frame 0 the input), because its
// body reads and writes different tensors.  The new spectra wait in scratch
// until the post-filter has read the previous frame's, and the new band
// energies in shared memory.
//
// Numerics: every sum that feeds a decision (a period, the silence gate,
// an int8 activation) adds products of two floats, exact in f64, in f64 and
// rounds once, as the plain versions do (dsp/pitch.py, dsp/transform.py,
// dsp/biquad.py); every f32 step uses the _rn intrinsics, so nvcc contracts
// nothing into an FMA that PyTorch does not, and constants are rounded from
// double as PyTorch rounds a Python scalar.

#include <math_constants.h>
#include <stdint.h>

#include "analysis_body.cuh"
#include "postfilter_body.cuh"
#include "rnn_body.cuh"

namespace rnnt {

// The 17 tensors of a DenoiseState, in its field order (the same order as
// _STATE in dsp/cuda_frame.py).
struct State {
  float* analysis_mem; float* synthesis_mem; float* pitch_buf;
  float* last_gain; int* last_period; float* mem_hp; float* lastg;
  float* conv1_mem; float* conv2_mem; float* gru[3];
  float* dX; float* dP; float* dEx; float* dEp; float* dExp;
};

// The launch's arguments, in the order of _ChunkArgs in dsp/cuda_frame.py.
struct ChunkArgs {
  State src, dst, tmp;             // input, output, network scratch
  const int16_t* pcm; int16_t* out; float* vad;
  float* xp; float* feats; uint8_t* silence; float* gains;   // scratch
  const float* conv1_w; const float* conv1_b;
  const int* q_w; const int* q_k; const int* q_sched;
  const float* conv2_scale; const float* conv2_b;
  const float* gru_in_scale; const float* gru_in_b;
  const float* gru_rec_scale; const float* gru_rec_b; const float* gru_diag;
  const float* heads_w; const float* heads_b;
  const double* hp_k; const double* hp_rowA; const double* hp_SA;
  const double* hp_SB;
  const float* window; const double* tw; const float* band;
  const float* interp; const float* dct;
  int S, T, F, C, N, NB;
};

}  // namespace rnnt

namespace {

using namespace rnnt;

constexpr int G = RNN_G;                  // streams per block
constexpr int THREADS = ANALYSIS_THREADS;  // 512
constexpr int NWARPS = THREADS / 32;
static_assert(NWARPS == RNN_WARPS, "the network's step is split over the block's warps");
constexpr int NC = 147;                   // coarse lags
constexpr int LEN4 = 240;                 // coarse correlation length
constexpr int NFEAT = 2 * NB + 1;         // 65 features

// Shared memory kept across the phases of a frame.
struct Persist {
  double hp_k[FS];                 // the biquad's taps k_0 .. k_478
  float newE[G][3][NB];            // this frame's Ex, Ep, Exp per stream
};

// Shared memory of the per-stream analysis (steps 1-6).
struct __align__(16) FrameSmem {
  AnalysisSmem an;
  float ds[DS];                    // the whitened, decimated buffer
  float pbuf[PBUF];                // the new pitch buffer
  float xin[FS];                   // the frame's input samples
  float xlp[DS];                   // decimated, before whitening
  float xc4[NC], q4[NC];
  float e2x[NBIN], e2p[NBIN], cxp[NBIN];
  float Ly[NB], feat[NFEAT];
  double red[NWARPS][5];           // block sums
  float lpc[5];                    // the FIR's taps
  int bp[2];
  float E;
};

// Sums of K f64 values over the block, valid in thread 0.
template <int K>
__device__ __forceinline__ void block_sum(double (&v)[K], double (*red)[5]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp][k] = v[k];
  __syncthreads();
  if (threadIdx.x == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      double s = 0.0;
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w][k];
      v[k] = s;
    }
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

__device__ __forceinline__ void copy_rows(float* dst, const float* src, int s,
                                          int width) {
  for (int i = threadIdx.x; i < width; i += blockDim.x)
    dst[(size_t)s * width + i] = src[(size_t)s * width + i];
}

// Output sample n of one stream, rounded half away from zero and clipped to
// int16 (denoise.process_frames_tm_i16).
struct StoreI16 {
  int16_t* o;
  __device__ __forceinline__ void operator()(int n, float v) const {
    const float r = truncf(v > 0.0f ? __fadd_rn(v, 0.5f) : __fsub_rn(v, 0.5f));
    o[n] = (int16_t)(int)fminf(fmaxf(r, -32768.0f), 32767.0f);
  }
};

// Steps 1-6 for stream s (slot g of the block) at frame t: updates the
// stream's mem_hp, pitch_buf, analysis_mem, last_period and last_gain in
// a.dst, writes X, P to a.xp, the features and silence flag to a.feats and
// a.silence, and Ex, Ep, Exp to ps.newE[g].
__device__ void analyse_stream(const ChunkArgs& a, Persist& ps, FrameSmem& fs,
                               int t, int s, int g) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const State& d = a.dst;

  // 1-2. the HP biquad into the tail of the shifted pitch buffer
  const int16_t* in = a.pcm + ((size_t)t * a.S + s) * FS;
  for (int i = tid; i < FS; i += nt) fs.xin[i] = (float)in[i];
  for (int i = tid; i < PBUF - FS; i += nt)
    fs.pbuf[i] = d.pitch_buf[(size_t)s * PBUF + FS + i];
  const double m0 = d.mem_hp[2 * s], m1 = d.mem_hp[2 * s + 1];
  __syncthreads();
  double v[2] = {0.0, 0.0};
  for (int i = tid; i < FS; i += nt) {
    double acc = 0.0;                    // sum_{j<i} k_{i-1-j} x_j
    for (int j = 0; j < i; ++j) acc = fma(ps.hp_k[i - 1 - j], (double)fs.xin[j], acc);
    const double st = fma(m1, a.hp_rowA[2 * i + 1], m0 * a.hp_rowA[2 * i]);
    fs.pbuf[PBUF - FS + i] =
        __fadd_rn(__fadd_rn(fs.xin[i], (float)acc), (float)st);
    v[0] = fma((double)fs.xin[i], a.hp_SB[2 * i], v[0]);
    v[1] = fma((double)fs.xin[i], a.hp_SB[2 * i + 1], v[1]);
  }
  block_sum<2>(v, fs.red);
  if (tid == 0)
    for (int j = 0; j < 2; ++j)
      d.mem_hp[2 * s + j] =
          (float)(fma(m1, a.hp_SA[2 * j + 1], m0 * a.hp_SA[2 * j]) + v[j]);
  __syncthreads();
  for (int i = tid; i < PBUF; i += nt) d.pitch_buf[(size_t)s * PBUF + i] = fs.pbuf[i];

  // 3. decimation, LPC fit and whitening
  for (int i = tid; i < DS; i += nt) {
    const float xl = i > 0 ? fs.pbuf[2 * i - 1] : 0.0f;
    fs.xlp[i] = __fadd_rn(__fmul_rn(0.25f, __fadd_rn(xl, fs.pbuf[2 * i + 1])),
                          __fmul_rn(0.5f, fs.pbuf[2 * i]));
  }
  __syncthreads();
  double ac[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
  for (int i = tid; i < DS; i += nt) {
    const double xi = fs.xlp[i];
#pragma unroll
    for (int k = 0; k < 5; ++k)
      if (i + k < DS) ac[k] = fma(xi, (double)fs.xlp[i + k], ac[k]);
  }
  block_sum<5>(ac, fs.red);
  if (tid == 0) {
    float r[5];
    for (int k = 0; k < 5; ++k) r[k] = (float)ac[k];
    r[0] = __fmul_rn(r[0], (float)1.0001);
    for (int i = 1; i < 5; ++i)                      // lag windowing
      r[i] = __fsub_rn(r[i], __fmul_rn(r[i], (float)((0.008 * i) * (0.008 * i))));
    // order-4 Levinson-Durbin with the 30 dB early-out (pitch._levinson4)
    float lpc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float err = r[0];
    bool done = r[0] == 0.0f;
    for (int i = 0; i < 4; ++i) {
      float rr = r[i + 1];
      for (int j = 0; j < i; ++j) rr = __fadd_rn(rr, __fmul_rn(lpc[j], r[i - j]));
      const float k = __fdiv_rn(-rr, done ? 1.0f : err);
      float nw[4] = {lpc[0], lpc[1], lpc[2], lpc[3]};
      nw[i] = k;
      for (int j = 0; j < (i + 1) / 2; ++j) {
        const float t1 = lpc[j], t2 = lpc[i - 1 - j];
        nw[j] = __fadd_rn(t1, __fmul_rn(k, t2));
        nw[i - 1 - j] = __fadd_rn(t2, __fmul_rn(k, t1));
      }
      if (!done) {
        for (int j = 0; j < 4; ++j) lpc[j] = nw[j];
        err = __fsub_rn(err, __fmul_rn(__fmul_rn(k, k), err));
      }
      done = done || err < __fmul_rn((float)0.001, r[0]);
    }
    double tmp = 1.0;
    for (int i = 0; i < 4; ++i) {                    // .9^i damping
      tmp *= 0.9;
      lpc[i] = __fmul_rn(lpc[i], (float)tmp);
    }
    const float c1 = (float)0.8;
    fs.lpc[0] = __fadd_rn(lpc[0], c1);
    fs.lpc[1] = __fadd_rn(lpc[1], __fmul_rn(c1, lpc[0]));
    fs.lpc[2] = __fadd_rn(lpc[2], __fmul_rn(c1, lpc[1]));
    fs.lpc[3] = __fadd_rn(lpc[3], __fmul_rn(c1, lpc[2]));
    fs.lpc[4] = __fmul_rn(c1, lpc[3]);
  }
  __syncthreads();
  for (int i = tid; i < DS; i += nt) {               // celt_fir5
    float y = fs.xlp[i];
#pragma unroll
    for (int k = 0; k < 5; ++k)
      y = __fadd_rn(y, __fmul_rn(fs.lpc[k], i - 1 - k >= 0 ? fs.xlp[i - 1 - k] : 0.0f));
    fs.ds[i] = y;
  }
  __syncthreads();

  // 4. coarse search on the 4x-decimated buffers x4[j] = ds[384 + 2j],
  // y4[i] = ds[2i]
  if (tid < NC) {
    double xc = 0.0, e = 0.0;
    for (int j = 0; j < LEN4; ++j) {
      const double y = fs.ds[2 * (tid + j)];
      xc = fma((double)fs.ds[XOFF + 2 * j], y, xc);
      e = fma(y, y, e);
    }
    const float xcf = (float)xc;
    const float syy = fmaxf(__fadd_rn(1.0f, (float)e), 1.0f);
    const float num = __fmul_rn(xcf, (float)1e-12);
    fs.xc4[tid] = xcf;
    fs.q4[tid] = xcf > 0.0f ? __fdiv_rn(__fmul_rn(num, num), syy) : -CUDART_INF_F;
  }
  __syncthreads();
  if (tid < 32) {
    int count = 0;
    for (int i = tid; i < NC; i += 32) count += fs.xc4[i] > 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      count += __shfl_xor_sync(0xffffffffu, count, off);
    const int i0 = warp_argmax(fs.q4, NC, -1);
    const int i1 = warp_argmax(fs.q4, NC, i0);
    if (tid == 0) {
      fs.bp[0] = count >= 1 ? i0 : 0;
      fs.bp[1] = count >= 2 ? i1 : (count == 1 ? 0 : 1);
    }
  }
  __syncthreads();

  // 5. fine search, doubling ladder, window and both spectra
  float* X = a.xp + (size_t)s * 4 * NBIN;
  float* P = X + 2 * NBIN;
  analysis_body(fs.an, fs.ds, d.analysis_mem + (size_t)s * FS,
                fs.pbuf + PBUF - FS, fs.pbuf, fs.bp[0], fs.bp[1],
                d.last_period[s], d.last_gain[s], a.window,
                reinterpret_cast<const double2*>(a.tw), X, P,
                d.last_period + s, d.last_gain + s);
  __syncthreads();
  for (int i = tid; i < FS; i += nt)
    d.analysis_mem[(size_t)s * FS + i] = fs.pbuf[PBUF - FS + i];

  // 6. band features and the silence gate
  for (int k = tid; k < NBIN; k += nt) {
    const float xr = X[k], xi = X[NBIN + k], pr = P[k], pi = P[NBIN + k];
    fs.e2x[k] = __fadd_rn(__fmul_rn(xr, xr), __fmul_rn(xi, xi));
    fs.e2p[k] = __fadd_rn(__fmul_rn(pr, pr), __fmul_rn(pi, pi));
    fs.cxp[k] = __fadd_rn(__fmul_rn(xr, pr), __fmul_rn(xi, pi));
  }
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5;
  for (int b = warp; b < NB; b += nt >> 5) {
    double ex = 0.0, ep = 0.0, c = 0.0;
    for (int k = lane; k < NBIN; k += 32) {
      const double w = a.band[k * NB + b];
      ex = fma(w, (double)fs.e2x[k], ex);
      ep = fma(w, (double)fs.e2p[k], ep);
      c = fma(w, (double)fs.cxp[k], c);
    }
    for (int off = 16; off > 0; off >>= 1) {
      ex += __shfl_down_sync(0xffffffffu, ex, off);
      ep += __shfl_down_sync(0xffffffffu, ep, off);
      c += __shfl_down_sync(0xffffffffu, c, off);
    }
    if (lane == 0) {
      const float exf = (float)ex, epf = (float)ep;
      ps.newE[g][0][b] = exf;
      ps.newE[g][1][b] = epf;
      ps.newE[g][2][b] = __fdiv_rn(
          (float)c, __fsqrt_rn(__fadd_rn(__fmul_rn(exf, epf), (float)0.001)));
    }
  }
  __syncthreads();
  if (tid == 0) {
    // the spectral-floor follower (denoise.c:381-388) and E in f64
    float log_max = -2.0f, follow = -2.0f;
    double E = 0.0;
    for (int i = 0; i < NB; ++i) {
      const float ex = ps.newE[g][0][i];
      E += ex;
      const float L = log10f(__fadd_rn((float)1e-2, ex));
      const float ly = fmaxf(__fsub_rn(log_max, 7.0f),
                             fmaxf(__fsub_rn(follow, 1.5f), L));
      log_max = fmaxf(log_max, ly);
      follow = fmaxf(__fsub_rn(follow, 1.5f), ly);
      fs.Ly[i] = ly;
    }
    fs.E = (float)E;
  }
  __syncthreads();
  if (tid < 2 * NB) {
    const int i = tid & (NB - 1);
    const float* src = tid < NB ? fs.Ly : ps.newE[g][2];
    double acc = 0.0;
    for (int j = 0; j < NB; ++j)
      acc = fma((double)src[j], (double)a.dct[j * NB + i], acc);
    float f = (float)acc;
    if (tid == 0) f = __fadd_rn(f, -12.0f);
    if (tid == 1) f = __fadd_rn(f, -4.0f);
    fs.feat[tid] = f;
  } else if (tid == 2 * NB) {
    fs.feat[tid] = __fmul_rn((float)0.01, __fsub_rn((float)d.last_period[s], 300.0f));
  }
  __syncthreads();
  const bool silent = fs.E < (float)0.04;
  for (int i = tid; i < NFEAT; i += nt)
    a.feats[(size_t)s * NFEAT + i] = silent ? 0.0f : fs.feat[i];
  if (tid == 0) a.silence[s] = silent;
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1) chunk_kernel(const ChunkArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Persist& ps = *reinterpret_cast<Persist*>(smem);
  unsigned char* work = smem + sizeof(Persist);   // one phase at a time
  FrameSmem& fs = *reinterpret_cast<FrameSmem*>(work);
  PostSmem& post = *reinterpret_cast<PostSmem*>(work);
  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * G, ns = min(G, a.S - s0);
  const double2* tw = reinterpret_cast<const double2*>(a.tw);

  // the input state in (the network's is read from a.src at frame 0)
  for (int g = 0; g < ns; ++g) {
    const int s = s0 + g;
    copy_rows(a.dst.analysis_mem, a.src.analysis_mem, s, FS);
    copy_rows(a.dst.synthesis_mem, a.src.synthesis_mem, s, FS);
    copy_rows(a.dst.pitch_buf, a.src.pitch_buf, s, PBUF);
    copy_rows(a.dst.last_gain, a.src.last_gain, s, 1);
    copy_rows(reinterpret_cast<float*>(a.dst.last_period),
              reinterpret_cast<const float*>(a.src.last_period), s, 1);
    copy_rows(a.dst.mem_hp, a.src.mem_hp, s, 2);
    copy_rows(a.dst.lastg, a.src.lastg, s, NB);
    copy_rows(a.dst.dX, a.src.dX, s, 2 * NBIN);
    copy_rows(a.dst.dP, a.src.dP, s, 2 * NBIN);
    copy_rows(a.dst.dEx, a.src.dEx, s, NB);
    copy_rows(a.dst.dEp, a.src.dEp, s, NB);
    copy_rows(a.dst.dExp, a.src.dExp, s, NB);
  }
  for (int i = tid; i < FS - 1; i += blockDim.x) ps.hp_k[i] = a.hp_k[i];
  __syncthreads();

  for (int t = 0; t < a.T; ++t) {
    // the network's state: written to dst on the last frame, so to tmp
    // and dst alternately before it
    const State& wr = ((a.T - 1 - t) & 1) ? a.tmp : a.dst;
    const State& rd = t == 0 ? a.src : (((a.T - t) & 1) ? a.tmp : a.dst);
    for (int g = 0; g < ns; ++g) analyse_stream(a, ps, fs, t, s0 + g, g);

    const RnnArgs ra{a.feats, a.silence, rd.conv1_mem, rd.conv2_mem,
                     {rd.gru[0], rd.gru[1], rd.gru[2]},
                     a.conv1_w, a.conv1_b, a.q_w, a.q_k, a.q_sched,
                     a.conv2_scale, a.conv2_b,
                     a.gru_in_scale, a.gru_in_b, a.gru_rec_scale, a.gru_rec_b,
                     a.gru_diag,
                     a.heads_w, a.heads_b,
                     wr.conv1_mem, wr.conv2_mem, {wr.gru[0], wr.gru[1], wr.gru[2]},
                     a.gains, a.vad + (size_t)t * a.S,
                     a.S, a.F, a.C, a.N, a.NB};
    rnn_body(ra, work, s0);
    __syncthreads();

    for (int g = 0; g < ns; ++g) {
      const int s = s0 + g;
      const State& d = a.dst;
      const size_t b = (size_t)s * NB, row = (size_t)s * FS;
      postfilter_body(post, d.dX + (size_t)s * 2 * NBIN, d.dP + (size_t)s * 2 * NBIN,
                      d.dEx + b, d.dEp + b, d.dExp + b, a.gains + b, d.lastg + b,
                      ps.newE[g][0], a.silence[s] != 0, d.synthesis_mem + row,
                      a.band, a.interp, a.window, tw,
                      StoreI16{a.out + ((size_t)t * a.S + s) * FS},
                      d.synthesis_mem + row, d.lastg + b);
      __syncthreads();
      // this frame's spectra and band energies become the delayed ones
      const float* xp = a.xp + (size_t)s * 4 * NBIN;
      for (int i = tid; i < 2 * NBIN; i += blockDim.x) {
        d.dX[(size_t)s * 2 * NBIN + i] = xp[i];
        d.dP[(size_t)s * 2 * NBIN + i] = xp[2 * NBIN + i];
      }
      if (tid < NB) {
        d.dEx[b + tid] = ps.newE[g][0][tid];
        d.dEp[b + tid] = ps.newE[g][1][tid];
        d.dExp[b + tid] = ps.newE[g][2][tid];
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block for a network of F features, C conv
// and N GRU units.
size_t rnnt_chunk_smem_bytes(int F, int C, int N) {
  size_t work = rnn_smem_bytes(F, C, N);
  if (sizeof(FrameSmem) > work) work = sizeof(FrameSmem);
  if (sizeof(PostSmem) > work) work = sizeof(PostSmem);
  return sizeof(Persist) + work;
}

// One chunk: see ChunkArgs and dsp/cuda_frame.py for the tensors.  Returns
// the CUDA error code of the launch (0 on success).
int rnnt_process_chunk(const ChunkArgs* args, void* stream) {
  const ChunkArgs a = *args;
  if (a.S <= 0 || a.T <= 0) return 0;
  if (a.F != NFEAT || a.NB != NB) return (int)cudaErrorInvalidValue;
  const size_t smem = rnnt_chunk_smem_bytes(a.F, a.C, a.N);
  cudaError_t e = cudaFuncSetAttribute(
      chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  chunk_kernel<<<(a.S + G - 1) / G, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
