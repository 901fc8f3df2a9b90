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
//   5. the lag table and energies (385 lags x 480 taps, f64, rounded once)
//      as f64 tensor-core products (analysis_body.cuh: lag_energy_mma), the
//      fine search and the doubling ladder (analysis_body.cuh:
//      resolve_period), the window and both forward spectra
//      (spectral_common.cuh:fwd_spectra);
//   6. the band energies and correlations (f64, rounded once), the
//      log-energy follower, the E sum and both DCTs (f64, rounded once) and
//      the silence gate (compute_frame_features);
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
// frame in device memory.  A block owns G = 8 streams for all T frames, so
// streams never synchronise across blocks and there is one launch per chunk
// (the fused configuration makes ~480 per frame, PERF.md).  G = 8 is the RNN
// step's own stream block: its products read each weight once for 8
// streams, and at S = 1024 it gives 128 blocks for the H100's 132 SMs, one
// block of 16 warps an SM.
//
// The design: every span takes the block's streams together, so each
// barrier closes 8 streams' work and each serial section (the Levinson
// recursion, the period's ladder, the log-energy follower) runs the 8
// streams on 8 threads at once.  Taken a stream at a time on the whole
// block, the spans were chains of latencies behind their own barriers, and
// the f64 pipes sat idle (PERF.md §5).  Shared memory holds all 8 streams'
// working set of one span at a time (the analysis' 140 KB, the network's
// 158 KB) beside 43 KB kept across the spans; the forward FFTs read their
// inputs from device memory.  The Toeplitz term and the coarse search are
// register-tiled: a thread owns HP_TILE consecutive outputs (the biquad:
// the tiles of a stream paired, short with long, so every thread does as
// many multiply-adds) or 7 consecutive lags, and a window of inputs slides
// through its registers, one shared load feeding several multiply-adds.
// The lag table and its energies run on the f64 tensor cores, as in the
// analysis kernel, 2 warps a stream.  The band tables are read in their
// compact form (postfilter_body.cuh), staged in shared memory: a band sum
// runs over the band's own bins.  Each span is a function of its own (its own register
// allocation under the 128 registers a thread that 16 warps allow: inlined,
// the spans spilled twice as much) reaching the arguments and shared memory
// through file-scope symbols; the network's arguments for both directions
// of its state are kernel parameters, so rnn_body reads them as in
// rnn_step.cu.  Loops that move device memory keep COPY_BATCH loads in
// flight before their stores.
//
// State: the block copies its streams' input state into the output state at
// t = 0 and then updates it there; the caller's state is only read.  The
// network's state alternates between the output state and a scratch copy
// (frame t reads what frame t-1 wrote; the input state is copied into the
// one frame 0 reads), because its body reads and writes different tensors;
// its VAD waits in scratch until the post-filter's span stores it.  The
// spectra alternate the same way (spec_buf), since frame t's are made
// before frame t-1's post-filter reads those; the new band energies wait in
// shared memory.
//
// Numerics: every sum that feeds a decision (a period, the silence gate,
// an int8 activation) adds products of two floats, exact in f64, in f64 and
// rounds once, as the plain versions do (dsp/pitch.py, dsp/transform.py,
// dsp/biquad.py); every f32 step uses the _rn intrinsics, so nvcc contracts
// nothing into an FMA that PyTorch does not, and constants are rounded from
// double as PyTorch rounds a Python scalar.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

// Phase marks for scripts/torch_frame_phases.py.  Built with
// -DRNNT_FRAME_PHASES, lane 0 of each warp of the first FRAME_PHASE_BLOCKS
// blocks records clock64() and the span's kind at the end of each span of a
// frame, in order (each frame overwrites the frame before, so the last
// frame's marks remain), and the block's clock at its start, after the state
// copy-in and at its end; otherwise the marks are empty.
enum FramePhase {
  PH_FRAME, PH_BIQUAD, PH_LPC, PH_COARSE, PH_LAG, PH_FINE, PH_SPECTRA,
  PH_FEATURES, PH_NETWORK, PH_POST, PH_HANDOVER, PH_BIQUAD_IN, PH_FEAT_BINS,
  PH_FEAT_BANDS, PH_POST_BINS, PH_POST_BANDS, PH_COARSE_PICK
};
#define FRAME_PHASE_NAMES                                                    \
  "frame start;biquad;decimation and LPC;coarse search;lag table;"         \
  "fine search and ladder;forward spectra;band features and gate;"         \
  "network step;post-filter;state handover;biquad: the input;"             \
  "band features: per bin;band features: band sums;"                      \
  "post-filter: bands and comb;post-filter: band energies;"               \
  "coarse search: the candidates"
#ifdef RNNT_FRAME_PHASES
constexpr int FRAME_PHASE_BLOCKS = 132, FRAME_PHASE_WARPS = 16, FRAME_MARKS = 128;
__device__ long long frame_phase_clock[FRAME_PHASE_BLOCKS][FRAME_PHASE_WARPS][FRAME_MARKS];
__device__ int frame_phase_kind[FRAME_PHASE_BLOCKS][FRAME_PHASE_WARPS][FRAME_MARKS];
__device__ int frame_phase_count[FRAME_PHASE_BLOCKS][FRAME_PHASE_WARPS];
__device__ long long frame_phase_span[FRAME_PHASE_BLOCKS][3];
__shared__ int frame_mark_n[FRAME_PHASE_WARPS];
#define FRAME_MARK(k)                                                        \
  do {                                                                     \
    if ((threadIdx.x & 31) == 0 && blockIdx.x < FRAME_PHASE_BLOCKS) {      \
      const int w_ = threadIdx.x >> 5, i_ = frame_mark_n[w_]++;            \
      if (i_ < FRAME_MARKS) {                                              \
        frame_phase_clock[blockIdx.x][w_][i_] = clock64();                 \
        frame_phase_kind[blockIdx.x][w_][i_] = (k);                        \
      }                                                                    \
      frame_phase_count[blockIdx.x][w_] = i_ + 1;                          \
    }                                                                      \
  } while (0)
#define FRAME_MARK_RESET()                                                   \
  if ((threadIdx.x & 31) == 0) frame_mark_n[threadIdx.x >> 5] = 0
#define FRAME_SPAN(i)                                                        \
  if (threadIdx.x == 0 && blockIdx.x < FRAME_PHASE_BLOCKS)                 \
  frame_phase_span[blockIdx.x][i] = clock64()
#define POST_MARK(k) FRAME_MARK(PH_POST_BINS + (k))
#else
#define FRAME_MARK(k)
#define FRAME_MARK_RESET()
#define FRAME_SPAN(i)
#endif

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
  float* xp; float* feats; uint8_t* silence; float* gains; float* vad1;  // scratch
  // (xp: [2, S, 962], spectra X then P, the other half of spec_buf's pairs)
  const float* conv1_w; const float* conv1_b;
  const int* q_w; const int* q_k; const int* q_sched;
  const float* conv2_scale; const float* conv2_b;
  const float* gru_in_scale; const float* gru_in_b;
  const float* gru_rec_scale; const float* gru_rec_b; const float* gru_diag;
  const float* heads_w; const float* heads_b;
  const double* hp_k; const double* hp_rowA; const double* hp_SA;
  const double* hp_SB;
  const float* window; const double* tw; const float* pairs;
  const int* ranges; const float* dct;
  int S, T, F, C, N, NB;
};

// The kernel's parameter: the arguments and the network step's arguments
// for both directions of its state (rnn[0] reads tmp and writes dst, rnn[1]
// the other way), built on the host, so that rnn_body reads its pointers
// from the parameter space as rnn_step.cu's kernel does, not from registers.
struct ChunkLaunch {
  ChunkArgs a;
  RnnArgs rnn[2];
};

}  // namespace rnnt

namespace {

using namespace rnnt;

constexpr int G = RNN_G;                  // streams per block
constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
static_assert(NWARPS == RNN_WARPS, "the network's step is split over the block's warps");
static_assert(G * LAG_WARPS <= NWARPS, "a warp (or LAG_WARPS) a stream");
constexpr int NC = 147;                   // coarse lags
constexpr int LEN4 = 240;                 // coarse correlation length
constexpr int NFEAT = 2 * NB + 1;         // 65 features

// The biquad's Toeplitz term (dsp/cuda_frame.py holds the same tiling): a
// thread owns HP_TILE consecutive outputs of one stream and then the
// stream's mirror tile (tiles p and HP_TILES - 1 - p, so every thread runs
// ~480 steps); the 8 streams of a tile pair are 8 consecutive threads.  A
// stream's samples are an f64 row of XPAD zeros and its 480 samples, rows
// XSTR apart (XSTR = 1 mod 16: the 16 lanes of a half warp, 8 streams x 2
// tiles, load from 16 distinct banks).
constexpr int HP_TILE = 8;
constexpr int HP_TILES = FS / HP_TILE;              // 60
constexpr int HP_THREADS = G * HP_TILES / 2;        // 240
constexpr int XPAD = HP_TILE, XSTR = 497;
static_assert(FS % (2 * HP_TILE) == 0 && XSTR >= XPAD + FS && XSTR % 16 == 1 &&
              HP_THREADS <= THREADS / 2, "the biquad's tiles");
// Lags per thread of the coarse search; ds rows in f64 with an odd stride
// (the coarse search's two streams in a warp on other banks).
constexpr int CT = 7, CTILES = NC / CT;             // 21 tiles a stream
constexpr int DSTR = 873;
static_assert(NC % CT == 0 && G * CTILES <= THREADS && DSTR >= DS && DSTR % 2 == 1,
              "the coarse tiles and the ds rows");

// Shared memory kept across the spans of a frame, and the chunk's constants.
struct __align__(16) Persist {
  double2 tw[NBIN + FFT_TABLE];    // the base twiddles k <= 480, the FFT table
  float4 pairs[2 * NBIN];          // the compact band tables
  double hp_k[FS];                 // the biquad's taps k_0 .. k_478 (and a 0)
  float dct[NB * NB];              // the DCT table
  int2 ranges[NB];                 // the energy table's bin ranges
  double ac[G][2][5];              // the autocorrelations' two halves
  float newE[G][3][NB];            // this frame's Ex, Ep, Exp per stream
  float hp_m[G][2];                // mem_hp at the frame's start
  float lpc[G][5];                 // the FIR's taps
  float E[G];                      // the silence gate's energy
  int bp[G][2];                    // the coarse candidates
  int start[G];                    // the pitch window's start
  bool silent[G];                  // the silence flags
};

// Each span's working set for the block's streams, one span's at a time.
struct __align__(16) AnalysisWork {
  union {                          // the biquad's input, then xlp, then the coarse table
    double xs[G * XSTR];
    float xlp[G][DS];
    struct { float xc4[G][NC], q4[G][NC]; } coarse;
  } r1;
  union {                          // the new pitch buffer, then the lag table
    float pbuf[G][PBUF];
    struct { float bx[G][NLAGS], yy[G][NLAGS], xc2[G][NL2], q[G][NL2]; } lag;
  } r2;
  double ds64[G * DSTR];           // the whitened, decimated buffer in f64
};
struct __align__(16) FeatureWork {
  float e2x[G][NBIN], e2p[G][NBIN], cxp[G][NBIN];
  float L[G][NB], Ly[G][NB];
};
// The forward FFTs take FFT_G streams at a time (span_spectra).
constexpr int FFT_G = G / 2;
constexpr size_t FFT_BYTES = sizeof(double2) * FFT_G * 2 * FH;

// The block's shared memory: the arguments (the spans take them by
// reference, which a kernel parameter would turn into a copy on every
// thread's stack), then Persist and one span's working set at a time.  The
// spans reach both through these symbols, so the compiler knows them for
// shared memory: they do not alias device memory.
extern __shared__ __align__(16) unsigned char chunk_smem[];
__shared__ ChunkArgs chunk_args;
__device__ __forceinline__ Persist& persist() { return *reinterpret_cast<Persist*>(chunk_smem); }
__device__ __forceinline__ unsigned char* span_work() { return chunk_smem + sizeof(Persist); }

// Frame t's spectra X (which = 0) or P (1), [S, 962]: written by frame t,
// read by frame t's band features and frame t + 1's post-filter.  They
// alternate between the state's delayed spectra (T - 1 - t even) and the
// scratch pair, so the last frame's land in the state without a copy; frame
// -1's are the input state's, copied in.
__device__ __forceinline__ float* spec_buf(const ChunkArgs& a, int t, int which) {
  if ((a.T - 1 - t) & 1) return a.xp + (size_t)which * a.S * 2 * NBIN;
  return which ? a.dst.dP : a.dst.dX;
}

// dst(i) = src(i) for i < n by the block, each thread's COPY_BATCH loads in
// flight before its stores (one after another, a load's latency each time).
constexpr int COPY_BATCH = 8;
template <class Src, class Dst>
__device__ __forceinline__ void copy_mapped(int n, Src src, Dst dst) {
  for (int i0 = threadIdx.x; i0 < n; i0 += COPY_BATCH * blockDim.x) {
    float v[COPY_BATCH];
#pragma unroll
    for (int u = 0; u < COPY_BATCH; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) v[u] = *src(i);
    }
#pragma unroll
    for (int u = 0; u < COPY_BATCH; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) *dst(i) = v[u];
    }
  }
}

// The block's rows s0 .. s0+ns-1 of a [S, width] tensor, copied.
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int s0,
                                          int ns, int width) {
  const size_t o = (size_t)s0 * width;
  copy_mapped(ns * width, [&](int i) { return src + o + i; },
              [&](int i) { return dst + o + i; });
}

// Output sample n of one stream, rounded half away from zero and clipped to
// int16 (denoise.process_frames_tm_i16).
__device__ __forceinline__ int16_t to_i16(float v) {
  const float r = truncf(v > 0.0f ? __fadd_rn(v, 0.5f) : __fsub_rn(v, 0.5f));
  return (int16_t)(int)fminf(fmaxf(r, -32768.0f), 32767.0f);
}

// The order-4 Levinson-Durbin recursion with the 30 dB early-out
// (pitch._levinson4), the .9^i damping and the FIR5's taps, from the
// autocorrelations ac [5] (f64 sums).
__device__ __forceinline__ void lpc_taps(const double* ac0, const double* ac1, float* taps) {
  float r[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) r[k] = (float)(ac0[k] + ac1[k]);
  r[0] = __fmul_rn(r[0], (float)1.0001);
#pragma unroll
  for (int i = 1; i < 5; ++i)                      // lag windowing
    r[i] = __fsub_rn(r[i], __fmul_rn(r[i], (float)((0.008 * i) * (0.008 * i))));
  float lpc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float err = r[0];
  bool done = r[0] == 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float rr = r[i + 1];
#pragma unroll
    for (int j = 0; j < i; ++j) rr = __fadd_rn(rr, __fmul_rn(lpc[j], r[i - j]));
    const float k = __fdiv_rn(-rr, done ? 1.0f : err);
    float nw[4] = {lpc[0], lpc[1], lpc[2], lpc[3]};
    nw[i] = k;
#pragma unroll
    for (int j = 0; j < (i + 1) / 2; ++j) {
      const float t1 = lpc[j], t2 = lpc[i - 1 - j];
      nw[j] = __fadd_rn(t1, __fmul_rn(k, t2));
      nw[i - 1 - j] = __fadd_rn(t2, __fmul_rn(k, t1));
    }
    if (!done) {
#pragma unroll
      for (int j = 0; j < 4; ++j) lpc[j] = nw[j];
      err = __fsub_rn(err, __fmul_rn(__fmul_rn(k, k), err));
    }
    done = done || err < __fmul_rn((float)0.001, r[0]);
  }
  double tmp = 1.0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {                    // .9^i damping
    tmp *= 0.9;
    lpc[i] = __fmul_rn(lpc[i], (float)tmp);
  }
  const float c1 = (float)0.8;
  taps[0] = __fadd_rn(lpc[0], c1);
  taps[1] = __fadd_rn(lpc[1], __fmul_rn(c1, lpc[0]));
  taps[2] = __fadd_rn(lpc[2], __fmul_rn(c1, lpc[1]));
  taps[3] = __fadd_rn(lpc[3], __fmul_rn(c1, lpc[2]));
  taps[4] = __fmul_rn(c1, lpc[3]);
}

// Steps 1-6 for the block's ns streams s0 + g at frame t, a function a span
// (each its own register allocation, under the block's 128 registers a
// thread): update their mem_hp, pitch_buf, analysis_mem, last_period and
// last_gain in a.dst, write X, P to spec_buf, the features and silence flags to
// a.feats and a.silence (and ps.silent), and Ex, Ep, Exp to ps.newE.

// 1-2. the HP biquad into the tail of the shifted pitch buffer, and the new
// mem_hp
__device__ __noinline__ void span_biquad(int t, int s0, int ns) {
  const ChunkArgs& a = chunk_args;
  Persist& ps = persist();
  unsigned char* work = span_work();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const State& d = a.dst;
  AnalysisWork& aw = *reinterpret_cast<AnalysisWork*>(work);
  double* xs = aw.r1.xs;

  // 1-2. the frame's samples in f64 after XPAD zeros, the shifted pitch buffer
  const int16_t* const pcm = a.pcm + ((size_t)t * a.S + s0) * FS;
#pragma unroll 4
  for (int i = tid; i < G * XSTR; i += nt) {
    const int g = i / XSTR, n = i - g * XSTR - XPAD;
    xs[i] = g < ns && n >= 0 && n < FS ? (double)pcm[g * FS + n] : 0.0;
  }
  const float* const pbuf = d.pitch_buf + (size_t)s0 * PBUF;
  copy_mapped(ns * (PBUF - FS),
              [&](int i) {
                const int g = i / (PBUF - FS);
                return pbuf + g * PBUF + FS + (i - g * (PBUF - FS));
              },
              [&](int i) {
                const int g = i / (PBUF - FS);
                return &aw.r2.pbuf[g][i - g * (PBUF - FS)];
              });
  if (tid < 2 * ns) ps.hp_m[tid >> 1][tid & 1] = d.mem_hp[2 * s0 + tid];
  __syncthreads();
  FRAME_MARK(PH_BIQUAD_IN);
  if (tid < HP_THREADS) {
    // the Toeplitz term sum_{d<i} k_d x_{i-1-d} of tiles p and HP_TILES-1-p
    const int g = tid % G, p = tid / G;
    if (g < ns) {
      const double* x = xs + g * XSTR + XPAD;      // x[-XPAD .. -1] = 0
      const float m0 = ps.hp_m[g][0], m1 = ps.hp_m[g][1];
#pragma unroll 1
      for (int h = 0; h < 2; ++h) {
        const int i0 = (h ? HP_TILES - 1 - p : p) * HP_TILE;
        double w[HP_TILE], acc[HP_TILE];
#pragma unroll
        for (int r = 0; r < HP_TILE; ++r) {
          w[r] = x[i0 + r - 1];
          acc[r] = 0.0;
        }
        for (int k = 0; k < i0 + HP_TILE - 1; ++k) {
          const double kk = ps.hp_k[k];
#pragma unroll
          for (int r = 0; r < HP_TILE; ++r) acc[r] = fma(kk, w[r], acc[r]);
#pragma unroll
          for (int r = HP_TILE - 1; r > 0; --r) w[r] = w[r - 1];
          w[0] = x[i0 - 2 - k];
        }
#pragma unroll
        for (int r = 0; r < HP_TILE; ++r) {
          const int i = i0 + r;
          const double st = fma((double)m1, a.hp_rowA[2 * i + 1], (double)m0 * a.hp_rowA[2 * i]);
          aw.r2.pbuf[g][PBUF - FS + i] =
              __fadd_rn(__fadd_rn((float)x[i], (float)acc[r]), (float)st);
        }
      }
    }
  } else if (warp >= NWARPS / 2 && warp - NWARPS / 2 < ns) {
    // the frame's new state A^480 s + sum_j A^(479-j) B x_j, a warp a stream
    const int g = warp - NWARPS / 2;
    const double* x = xs + g * XSTR + XPAD;
    double v0 = 0.0, v1 = 0.0;
    for (int i = lane; i < FS; i += 32) {
      v0 = fma(x[i], a.hp_SB[2 * i], v0);
      v1 = fma(x[i], a.hp_SB[2 * i + 1], v1);
    }
    for (int off = 16; off > 0; off >>= 1) {
      v0 += __shfl_down_sync(0xffffffffu, v0, off);
      v1 += __shfl_down_sync(0xffffffffu, v1, off);
    }
    if (lane == 0) {
      const double m0 = ps.hp_m[g][0], m1 = ps.hp_m[g][1];
      d.mem_hp[2 * (s0 + g)] = (float)(fma(m1, a.hp_SA[1], m0 * a.hp_SA[0]) + v0);
      d.mem_hp[2 * (s0 + g) + 1] = (float)(fma(m1, a.hp_SA[3], m0 * a.hp_SA[2]) + v1);
    }
  }
  __syncthreads();
  FRAME_MARK(PH_BIQUAD);
}

// 3. the pitch buffer back, decimation, LPC fit and whitening
__device__ __noinline__ void span_lpc(int t, int s0, int ns) {
  const ChunkArgs& a = chunk_args;
  Persist& ps = persist();
  AnalysisWork& aw = *reinterpret_cast<AnalysisWork*>(span_work());
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  copy_mapped(ns * PBUF, [&](int i) { return &aw.r2.pbuf[0][0] + i; },
              [&](int i) { return a.dst.pitch_buf + (size_t)s0 * PBUF + i; });
  for (int i = tid; i < ns * DS; i += nt) {
    const int g = i / DS, n = i - g * DS;
    const float* pb = aw.r2.pbuf[g];
    const float xl = n > 0 ? pb[2 * n - 1] : 0.0f;
    aw.r1.xlp[g][n] = __fadd_rn(__fmul_rn(0.25f, __fadd_rn(xl, pb[2 * n + 1])),
                                __fmul_rn(0.5f, pb[2 * n]));
  }
  __syncthreads();
  if (warp < 2 * ns) {
    // the 5 autocorrelations of stream warp / 2, half warp % 2 of the lags'
    // first factor by this warp
    const int g = warp >> 1, h = warp & 1;
    const float* xl = aw.r1.xlp[g];
    double ac[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
    for (int i = h * (DS / 2) + lane; i < (h + 1) * (DS / 2); i += 32) {
      const double xi = xl[i];
#pragma unroll
      for (int k = 0; k < 5; ++k)
        if (i + k < DS) ac[k] = fma(xi, (double)xl[i + k], ac[k]);
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      for (int off = 16; off > 0; off >>= 1) ac[k] += __shfl_down_sync(0xffffffffu, ac[k], off);
      if (lane == 0) ps.ac[g][h][k] = ac[k];
    }
  }
  __syncthreads();
  if (tid < ns) lpc_taps(ps.ac[tid][0], ps.ac[tid][1], ps.lpc[tid]);
  __syncthreads();
  for (int i = tid; i < G * DSTR; i += nt) {         // celt_fir5
    const int g = i / DSTR, n = i - g * DSTR;
    double y = 0.0;
    if (g < ns && n < DS) {
      const float* xl = aw.r1.xlp[g];
      float v = xl[n];
#pragma unroll
      for (int k = 0; k < 5; ++k)
        v = __fadd_rn(v, __fmul_rn(ps.lpc[g][k], n - 1 - k >= 0 ? xl[n - 1 - k] : 0.0f));
      y = v;
    }
    aw.ds64[i] = y;
  }
  __syncthreads();
  FRAME_MARK(PH_LPC);
}

// 4-5. the coarse search, the lag table, the fine search and the ladder
__device__ __noinline__ void span_search(int t, int s0, int ns) {
  const ChunkArgs& a = chunk_args;
  Persist& ps = persist();
  unsigned char* work = span_work();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const State& d = a.dst;
  AnalysisWork& aw = *reinterpret_cast<AnalysisWork*>(work);
  // 4. coarse search on the 4x-decimated buffers x4[j] = ds[384 + 2j],
  // y4[i] = ds[2i]: CT lags a thread, the window of y4 in registers
  if (tid < ns * CTILES) {
    const int g = tid / CTILES, i0 = (tid - g * CTILES) * CT;
    const double* ds = aw.ds64 + g * DSTR;
    double xc[CT], e[CT], w[CT];
#pragma unroll
    for (int r = 0; r < CT; ++r) {
      xc[r] = e[r] = 0.0;
      w[r] = ds[2 * (i0 + r)];
    }
    for (int j = 0; j < LEN4; ++j) {
      const double xj = ds[XOFF + 2 * j];
#pragma unroll
      for (int r = 0; r < CT; ++r) {
        xc[r] = fma(xj, w[r], xc[r]);
        e[r] = fma(w[r], w[r], e[r]);
      }
#pragma unroll
      for (int r = 0; r + 1 < CT; ++r) w[r] = w[r + 1];
      w[CT - 1] = ds[2 * (i0 + CT + j)];
    }
#pragma unroll
    for (int r = 0; r < CT; ++r) {
      const float xcf = (float)xc[r];
      const float syy = fmaxf(__fadd_rn(1.0f, (float)e[r]), 1.0f);
      const float num = __fmul_rn(xcf, (float)1e-12);
      aw.r1.coarse.xc4[g][i0 + r] = xcf;
      aw.r1.coarse.q4[g][i0 + r] =
          xcf > 0.0f ? __fdiv_rn(__fmul_rn(num, num), syy) : -CUDART_INF_F;
    }
  }
  __syncthreads();
  FRAME_MARK(PH_COARSE);
  if (warp < ns) {                                   // a warp a stream
    const float* xc4 = aw.r1.coarse.xc4[warp];
    const float* q4 = aw.r1.coarse.q4[warp];
    int count = 0;
    for (int i = lane; i < NC; i += 32) count += xc4[i] > 0.0f;
    for (int off = 16; off > 0; off >>= 1) count += __shfl_xor_sync(0xffffffffu, count, off);
    const int i0 = warp_argmax(q4, NC, -1);
    const int i1 = warp_argmax(q4, NC, i0);
    if (lane == 0) {
      ps.bp[warp][0] = count >= 1 ? i0 : 0;
      ps.bp[warp][1] = count >= 2 ? i1 : (count == 1 ? 0 : 1);
    }
  }
  FRAME_MARK(PH_COARSE_PICK);
  // 5. the lag table bx[i] = sum_j ds[384+j] ds[i+j] and the energies
  // yy[i] = sum_j ds[i+j]^2 over all 480 taps, LAG_WARPS warps a stream
  lag_energy_mma<LAG_WARPS>(ns, aw.ds64, DSTR, aw.r2.lag.bx[0], aw.r2.lag.yy[0], NLAGS);
  __syncthreads();
  FRAME_MARK(PH_LAG);

  // the fine search within 2 lags of twice the coarse candidates
  for (int i = tid; i < ns * NL2; i += nt) {
    const int g = i / NL2, l = i - g * NL2;
    fine_ratio(aw.r2.lag.bx[g], aw.r2.lag.yy[g], l, ps.bp[g][0], ps.bp[g][1],
               aw.r2.lag.xc2[g], aw.r2.lag.q[g]);
  }
  __syncthreads();
  if (warp < ns) {                                   // a warp a stream
    const int at = warp_argmax(aw.r2.lag.q[warp], NL2, -1);
    if (lane == 0) {
      const int s = s0 + warp;
      float gain;
      const int T0 = resolve_period<1>(aw.r2.lag.bx[warp], aw.r2.lag.yy[warp],
                                    aw.r2.lag.xc2[warp], at, d.last_period[s],
                                    d.last_gain[s], &gain);
      d.last_period[s] = T0;
      d.last_gain[s] = gain;
      ps.start[warp] = min(max(PBUF - WS - T0, 0), MAX_START);
    }
  }
  __syncthreads();
  FRAME_MARK(PH_FINE);
}

__device__ __noinline__ void span_spectra(int t, int s0, int ns) {
  const ChunkArgs& a = chunk_args;
  Persist& ps = persist();
  unsigned char* work = span_work();
  // both forward spectra of the block's streams, their inputs from device
  // memory: X of [analysis_mem | x], P of the pitch window (the pointers
  // read once, not from the arguments in each call).  Half the streams at a
  // time: all 8 at once hold twice the loads in each thread's registers and
  // spilled more (PERF.md §6).
#pragma unroll 1
  for (int h = 0; h < ns; h += FFT_G) {
    const int g0 = h;
    const float* const mem = a.dst.analysis_mem + (size_t)(s0 + g0) * FS;
    const float* const pb = a.dst.pitch_buf + (size_t)(s0 + g0) * PBUF;
    float* const Xo = spec_buf(a, t, 0) + (size_t)(s0 + g0) * 2 * NBIN;
    float* const Po = spec_buf(a, t, 1) + (size_t)(s0 + g0) * 2 * NBIN;
    fwd_spectra<(FFT_G * FH / FFT_R0 + THREADS - 1) / THREADS>(
        min(FFT_G, ns - g0), reinterpret_cast<double2*>(work), ps.tw, ps.tw + NBIN, a.window,
        [&](int g, int n) {
          return n < FS ? mem + g * FS + n : pb + g * PBUF + (PBUF - FS) + (n - FS);
        },
        [&](int g) { return pb + g * PBUF + ps.start[g0 + g]; },
        [&](int g, int seq, int k, float re, float im) {
          float* o = (seq ? Po : Xo) + g * 2 * NBIN;
          o[k] = re;
          o[NBIN + k] = im;
        });
    __syncthreads();
  }
  FRAME_MARK(PH_SPECTRA);
}

// 6. band features and the silence gate
__device__ __noinline__ void span_features(int t, int s0, int ns) {
  const ChunkArgs& a = chunk_args;
  Persist& ps = persist();
  unsigned char* work = span_work();
  const int tid = threadIdx.x, nt = blockDim.x;
  const State& d = a.dst;
  FeatureWork& fw = *reinterpret_cast<FeatureWork*>(work);
  copy_mapped(ns * FS,
              [&](int i) {
                return d.pitch_buf + (size_t)(s0 + i / FS) * PBUF + (PBUF - FS) + i % FS;
              },
              [&](int i) { return d.analysis_mem + (size_t)s0 * FS + i; });
  const float* const Xs = spec_buf(a, t, 0) + (size_t)s0 * 2 * NBIN;
  const float* const Ps = spec_buf(a, t, 1) + (size_t)s0 * 2 * NBIN;
#pragma unroll 4
  for (int i = tid; i < ns * NBIN; i += nt) {
    const int g = i / NBIN, k = i - g * NBIN;
    const float* X = Xs + g * 2 * NBIN;
    const float* P = Ps + g * 2 * NBIN;
    const float xr = X[k], xi = X[NBIN + k], pr = P[k], pi = P[NBIN + k];
    fw.e2x[g][k] = __fadd_rn(__fmul_rn(xr, xr), __fmul_rn(xi, xi));
    fw.e2p[g][k] = __fadd_rn(__fmul_rn(pr, pr), __fmul_rn(pi, pi));
    fw.cxp[g][k] = __fadd_rn(__fmul_rn(xr, pr), __fmul_rn(xi, pi));
  }
  __syncthreads();
  FRAME_MARK(PH_FEAT_BINS);
  if (tid < ns * NB) {                               // a (stream, band) a thread
    const int g = tid / NB, b = tid - g * NB;
    const float4* bpair = ps.pairs + PAIR_BAND * NBIN;
    const int2 rg = ps.ranges[b];
    double ex = 0.0, ep = 0.0, c = 0.0;
    for (int k = rg.x; k < rg.y; ++k) {
      const double w = pair_weight(bpair[k], b);
      ex = fma(w, (double)fw.e2x[g][k], ex);
      ep = fma(w, (double)fw.e2p[g][k], ep);
      c = fma(w, (double)fw.cxp[g][k], c);
    }
    const float exf = (float)ex, epf = (float)ep;
    ps.newE[g][0][b] = exf;
    ps.newE[g][1][b] = epf;
    ps.newE[g][2][b] = __fdiv_rn(
        (float)c, __fsqrt_rn(__fadd_rn(__fmul_rn(exf, epf), (float)0.001)));
    fw.L[g][b] = log10f(__fadd_rn((float)1e-2, exf));
  }
  __syncthreads();
  FRAME_MARK(PH_FEAT_BANDS);
  if (tid < ns) {
    // the spectral-floor follower (denoise.c:381-388) and E in f64, a
    // thread a stream
    const int g = tid;
    float log_max = -2.0f, follow = -2.0f;
    double E = 0.0;
    for (int i = 0; i < NB; ++i) {
      E += ps.newE[g][0][i];
      const float ly = fmaxf(__fsub_rn(log_max, 7.0f),
                             fmaxf(__fsub_rn(follow, 1.5f), fw.L[g][i]));
      log_max = fmaxf(log_max, ly);
      follow = fmaxf(__fsub_rn(follow, 1.5f), ly);
      fw.Ly[g][i] = ly;
    }
    ps.E[g] = (float)E;
  }
  __syncthreads();
  if (tid < ns * 2 * NB) {                           // both DCTs, the gate
    const int g = tid / (2 * NB), f = tid - g * 2 * NB, i = f & (NB - 1);
    const int s = s0 + g;
    const float* src = f < NB ? fw.Ly[g] : ps.newE[g][2];
    double acc = 0.0;
    for (int j = 0; j < NB; ++j)
      acc = fma((double)src[j], (double)ps.dct[j * NB + i], acc);
    float v = (float)acc;
    if (f == 0) v = __fadd_rn(v, -12.0f);
    if (f == 1) v = __fadd_rn(v, -4.0f);
    const bool silent = ps.E[g] < (float)0.04;
    a.feats[(size_t)s * NFEAT + f] = silent ? 0.0f : v;
    if (f == 0) {
      a.feats[(size_t)s * NFEAT + 2 * NB] =
          silent ? 0.0f : __fmul_rn((float)0.01, __fsub_rn((float)d.last_period[s], 300.0f));
      a.silence[s] = silent;
      ps.silent[g] = silent;
    }
  }
  __syncthreads();
  FRAME_MARK(PH_FEATURES);
}

// 8. the previous frame's post-filter and synthesis, the block's streams
// together; then this frame's band energies become the delayed ones (its
// spectra already are, spec_buf) and its VAD is stored
__device__ __noinline__ void span_post(int t, int s0, int ns) {
  const ChunkArgs& a = chunk_args;
  Persist& ps = persist();
  unsigned char* work = span_work();
  const int tid = threadIdx.x, nt = blockDim.x;
  const State& d = a.dst;
  __shared__ PostIO io[G];
  if (tid < ns) {
    const size_t s = s0 + tid, b = s * NB, row = s * FS;
    io[tid] = PostIO{spec_buf(a, t - 1, 0) + s * 2 * NBIN,
                     spec_buf(a, t - 1, 1) + s * 2 * NBIN, d.dEx + b, d.dEp + b,
                     d.dExp + b, a.gains + b, d.lastg + b, ps.newE[tid][0],
                     d.synthesis_mem + row, d.synthesis_mem + row, d.lastg + b,
                     ps.silent[tid]};
  }
  __syncthreads();
  postfilter_streams(
      ns, *reinterpret_cast<PostSmem<G>*>(work), io,
      ps.pairs, ps.ranges, a.window, ps.tw, ps.tw + NBIN,
      [&](int g, int n, float v) {
        a.out[((size_t)t * a.S + s0 + g) * FS + n] = to_i16(v);
      });
  __syncthreads();
  FRAME_MARK(PH_POST);
  if (tid < ns) a.vad[(size_t)t * a.S + s0 + tid] = a.vad1[s0 + tid];
  for (int i = tid; i < ns * 3 * NB; i += nt) {
    const int q = i / (ns * NB), j = i - q * ns * NB;
    float* const dE = q == 0 ? d.dEx : q == 1 ? d.dEp : d.dExp;
    dE[(size_t)s0 * NB + j] = ps.newE[j / NB][q][j % NB];
  }
  FRAME_MARK(PH_HANDOVER);
}

__global__ void __launch_bounds__(THREADS, 1) chunk_kernel(const ChunkLaunch L) {
  const ChunkArgs& a = chunk_args;
  Persist& ps = persist();
  unsigned char* work = span_work();
  const int tid = threadIdx.x;
  FRAME_SPAN(0);
  if (tid == 0) chunk_args = L.a;
  __syncthreads();
  const int s0 = blockIdx.x * G, ns = min(G, a.S - s0);

  // the input state in, the network's into the copy that frame 0 reads
  // (frame t writes dst when T - 1 - t is even, else tmp, and reads the
  // other), the biquad's taps and the twiddles
  const State& rd0 = ((a.T - 1) & 1) ? a.dst : a.tmp;
  copy_rows(rd0.conv1_mem, a.src.conv1_mem, s0, ns, 2 * a.F);
  copy_rows(rd0.conv2_mem, a.src.conv2_mem, s0, ns, 2 * a.C);
  for (int l = 0; l < 3; ++l) copy_rows(rd0.gru[l], a.src.gru[l], s0, ns, a.N);
  copy_rows(a.dst.analysis_mem, a.src.analysis_mem, s0, ns, FS);
  copy_rows(a.dst.synthesis_mem, a.src.synthesis_mem, s0, ns, FS);
  copy_rows(a.dst.pitch_buf, a.src.pitch_buf, s0, ns, PBUF);
  copy_rows(a.dst.last_gain, a.src.last_gain, s0, ns, 1);
  copy_rows(reinterpret_cast<float*>(a.dst.last_period),
            reinterpret_cast<const float*>(a.src.last_period), s0, ns, 1);
  copy_rows(a.dst.mem_hp, a.src.mem_hp, s0, ns, 2);
  copy_rows(a.dst.lastg, a.src.lastg, s0, ns, NB);
  copy_rows(spec_buf(a, -1, 0), a.src.dX, s0, ns, 2 * NBIN);
  copy_rows(spec_buf(a, -1, 1), a.src.dP, s0, ns, 2 * NBIN);
  copy_rows(a.dst.dEx, a.src.dEx, s0, ns, NB);
  copy_rows(a.dst.dEp, a.src.dEp, s0, ns, NB);
  copy_rows(a.dst.dExp, a.src.dExp, s0, ns, NB);
  for (int i = tid; i < FS; i += blockDim.x) ps.hp_k[i] = i < FS - 1 ? a.hp_k[i] : 0.0;
  const double2* tw = reinterpret_cast<const double2*>(a.tw);
  for (int i = tid; i < NBIN + FFT_TABLE; i += blockDim.x)
    ps.tw[i] = i < NBIN ? tw[i] : tw[WS + i - NBIN];
  for (int i = tid; i < 2 * NBIN; i += blockDim.x)
    ps.pairs[i] = reinterpret_cast<const float4*>(a.pairs)[i];
  for (int i = tid; i < NB * NB; i += blockDim.x) ps.dct[i] = a.dct[i];
  if (tid < NB) ps.ranges[tid] = reinterpret_cast<const int2*>(a.ranges)[tid];
  __syncthreads();
  FRAME_SPAN(1);

  for (int t = 0; t < a.T; ++t) {
    FRAME_MARK_RESET();
    FRAME_MARK(PH_FRAME);
    span_biquad(t, s0, ns);
    span_lpc(t, s0, ns);
    span_search(t, s0, ns);
    span_spectra(t, s0, ns);
    span_features(t, s0, ns);
    // 7. the network's step: its state written to dst on the last frame,
    // so to tmp and dst alternately before it; its VAD to a.vad1
    if ((a.T - 1 - t) & 1) rnn_body(L.rnn[1], work, s0);
    else rnn_body(L.rnn[0], work, s0);
    __syncthreads();
    FRAME_MARK(PH_NETWORK);
    span_post(t, s0, ns);
  }
  FRAME_SPAN(2);
}

}  // namespace

extern "C" {

#ifdef RNNT_FRAME_PHASES
// The phase marks' dimensions (blocks, warps, marks) and span names, in
// FramePhase order, separated by ';'.
void rnnt_frame_phase_layout(int* dims, const char** names) {
  dims[0] = FRAME_PHASE_BLOCKS;
  dims[1] = FRAME_PHASE_WARPS;
  dims[2] = FRAME_MARKS;
  *names = FRAME_PHASE_NAMES;
}

#ifdef RNNT_PHASES
// The network step's phase marks of the last launch (rnn_body.cuh: the last
// frame's), as rnn_step.cu's rnnt_rnn_phases.
int rnnt_rnn_phases(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, rnn_phase_clock, sizeof(rnn_phase_clock));
}
#endif

// Copies the last launch's marks to the host.  Returns a CUDA error code.
int rnnt_frame_phases(long long* clk, int* kind, int* count, long long* span) {
  cudaError_t e = cudaMemcpyFromSymbol(clk, frame_phase_clock, sizeof(frame_phase_clock));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(kind, frame_phase_kind, sizeof(frame_phase_kind));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(count, frame_phase_count, sizeof(frame_phase_count));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(span, frame_phase_span, sizeof(frame_phase_span));
  return (int)e;
}
#endif

// Dynamic shared memory of one block for a network of F features, C conv
// and N GRU units.
size_t rnnt_chunk_smem_bytes(int F, int C, int N) {
  size_t work = rnn_smem_bytes(F, C, N);
  if (sizeof(AnalysisWork) > work) work = sizeof(AnalysisWork);
  if (FFT_BYTES > work) work = FFT_BYTES;
  if (sizeof(FeatureWork) > work) work = sizeof(FeatureWork);
  if (sizeof(PostSmem<G>) > work) work = sizeof(PostSmem<G>);
  return sizeof(Persist) + work;
}

// One chunk: see ChunkArgs and dsp/cuda_frame.py for the tensors.  Returns
// the CUDA error code of the launch (0 on success).
int rnnt_process_chunk(const ChunkArgs* args, void* stream) {
  ChunkLaunch L;
  L.a = *args;
  const ChunkArgs& a = L.a;
  if (a.S <= 0 || a.T <= 0) return 0;
  if (a.F != NFEAT || a.NB != NB) return (int)cudaErrorInvalidValue;
  for (int v = 0; v < 2; ++v) {
    const State& rd = v ? a.dst : a.tmp;
    const State& wr = v ? a.tmp : a.dst;
    L.rnn[v] = RnnArgs{a.feats, a.silence, rd.conv1_mem, rd.conv2_mem,
                       {rd.gru[0], rd.gru[1], rd.gru[2]},
                       a.conv1_w, a.conv1_b, a.q_w, a.q_k, a.q_sched,
                       a.conv2_scale, a.conv2_b,
                       a.gru_in_scale, a.gru_in_b, a.gru_rec_scale, a.gru_rec_b,
                       a.gru_diag,
                       a.heads_w, a.heads_b,
                       wr.conv1_mem, wr.conv2_mem, {wr.gru[0], wr.gru[1], wr.gru[2]},
                       a.gains, a.vad1,
                       a.S, a.F, a.C, a.N, a.NB};
  }
  const size_t smem = rnnt_chunk_smem_bytes(a.F, a.C, a.N);
  cudaError_t e = cudaFuncSetAttribute(
      chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  chunk_kernel<<<(a.S + G - 1) / G, THREADS, smem, (cudaStream_t)stream>>>(L);
  return (int)cudaGetLastError();
}

}  // extern "C"
