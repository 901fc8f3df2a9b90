// One step of the RNNoise network for a batch of streams, on Hopper (sm_90a).
//
// Replaces the TPU kernel rnnoise_tpu/nn/pallas_rnn.py:compute_rnn_pallas
// (_kernel -> _rnn_body): conv1 (f32) + tanh_approx, conv2 (int8 weights,
// quantised activations, s32 accumulation, per-column scale), three int8
// GRU layers with the recurrent diagonal term, and the f32 gain/VAD heads
// with sigmoid_approx.  Silent rows keep their old state and get VAD 0
// (the reference skips compute_rnn on silent frames, denoise.c:474-480);
// their gains are still written.
//
// What bounds it: the ~3 MB of weights.  Each block reads all of them (from
// L2 after the first block), so L2 bandwidth over S/G blocks and the dp4a
// issue rate bound the kernel; the device-memory bound (weights once, state
// in and out) is far lower.  The design amortises every weight load over G
// streams held in one block: int8 weights are packed four input rows to a
// 32-bit word ([in/4, out]) so a warp's weight loads are coalesced and one
// __dp4a consumes four products; activations are quantised once per layer
// into shared memory and read as broadcasts.  One thread owns one GRU unit
// for all three gates, so the gate math needs no exchange between threads.
//
// Numerics match the plain version (nn/layers.py) bit for bit: int8 dots are
// exact in s32, f32 dots accumulate in f64 (products of two floats are exact
// there) and round once, and every elementwise step uses the _rn intrinsics
// so that nvcc contracts nothing into an FMA that PyTorch does not.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int G = 8;           // streams per block
constexpr int THREADS = 384;   // one GRU unit per thread at gru_size 384

__device__ __forceinline__ float tanh_approx(float x) {
  const float N0 = 952.52801514f, N1 = 96.39235687f, N2 = 0.60863042f;
  const float D0 = 952.72399902f, D1 = 413.36801147f, D2 = 11.88600922f;
  float x2 = __fmul_rn(x, x);
  float num = __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(N2, x2), N1), x2), N0);
  float den = __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(D2, x2), D1), x2), D0);
  float y = __fdiv_rn(__fmul_rn(num, x), den);
  return fminf(fmaxf(y, -1.0f), 1.0f);
}

__device__ __forceinline__ float sigmoid_approx(float x) {
  return __fadd_rn(0.5f, __fmul_rn(0.5f, tanh_approx(__fmul_rn(0.5f, x))));
}

// floor(.5 + 127 x) clipped to +-127, as one byte
__device__ __forceinline__ uint32_t quant(float x) {
  float q = floorf(__fadd_rn(0.5f, __fmul_rn(127.0f, x)));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
}

__device__ __forceinline__ int pack4(float a, float b, float c, float d) {
  return static_cast<int>(quant(a) | (quant(b) << 8) | (quant(c) << 16) |
                          (quant(d) << 24));
}

// int32 accumulator -> f32 (round to nearest) * scale + bias
__device__ __forceinline__ float dequant(int acc, float scale, float bias) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
}

struct Args {
  const float* feats; const uint8_t* silence;
  const float* c1m; const float* c2m;
  const float* h[3];
  const float* conv1_w; const float* conv1_b;
  const int* conv2_w; const float* conv2_scale; const float* conv2_b;
  const int* gru_in_w; const float* gru_in_scale; const float* gru_in_b;
  const int* gru_rec_w; const float* gru_rec_scale; const float* gru_rec_b;
  const float* gru_diag;
  const float* heads_w; const float* heads_b;
  float* c1m_out; float* c2m_out; float* h_out[3];
  float* gains; float* vad;
  int S, F, C, N, NB;
};

__global__ void __launch_bounds__(THREADS) rnn_step_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int F = a.F, C = a.C, N = a.N, NB = a.NB;
  const int F3 = 3 * F, C3 = 3 * C, N4 = 4 * N;
  const int QW = (C3 > N ? C3 : N) / 4;     // packed words of a layer input
  const int HW = N / 4;
  float* s_tmp1 = reinterpret_cast<float*>(smem);       // [G][3F]
  float* s_c1 = s_tmp1 + G * F3;                        // [G][C]
  float* s_cat = s_c1 + G * C;                          // [G][4N]
  int* s_q = reinterpret_cast<int*>(s_cat + G * N4);    // [G][QW]
  int* s_qh = s_q + G * QW;                             // [G][HW]
  __shared__ bool s_keep[G];

  const int tid = threadIdx.x, nt = blockDim.x;
  const int s0 = blockIdx.x * G;
  const int ns = min(G, a.S - s0);
  if (tid < G) s_keep[tid] = tid < ns && a.silence[s0 + tid] != 0;

  // conv1 input [c1m | feats]
  for (int i = tid; i < G * F3; i += nt) {
    int g = i / F3, k = i - g * F3;
    float v = 0.0f;
    if (g < ns) {
      v = k < 2 * F ? a.c1m[(size_t)(s0 + g) * 2 * F + k]
                    : a.feats[(size_t)(s0 + g) * F + k - 2 * F];
    }
    s_tmp1[i] = v;
  }
  __syncthreads();

  // conv1: f32 weights [3F, C], accumulated in f64
  for (int j = tid; j < C; j += nt) {
    double acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.0;
    for (int k = 0; k < F3; ++k) {
      double w = a.conv1_w[(size_t)k * C + j];
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] += (double)s_tmp1[g * F3 + k] * w;
    }
    float b = a.conv1_b[j];
#pragma unroll
    for (int g = 0; g < G; ++g)
      s_c1[g * C + j] = tanh_approx(__fadd_rn(__double2float_rn(acc[g]), b));
  }
  for (int i = tid; i < G * 2 * F; i += nt) {
    int g = i / (2 * F), k = i - g * 2 * F;
    if (g < ns) {
      size_t o = (size_t)(s0 + g) * 2 * F + k;
      a.c1m_out[o] = s_keep[g] ? a.c1m[o] : s_tmp1[g * F3 + F + k];
    }
  }
  __syncthreads();

  // conv2 input [c2m | c1], quantised and packed
  const int W2 = C3 / 4;
  for (int i = tid; i < G * W2; i += nt) {
    int g = i / W2, w = i - g * W2;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (g < ns) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        int k = 4 * w + t;
        v[t] = k < 2 * C ? a.c2m[(size_t)(s0 + g) * 2 * C + k]
                         : s_c1[g * C + k - 2 * C];
      }
    }
    s_q[g * QW + w] = pack4(v[0], v[1], v[2], v[3]);
  }
  for (int i = tid; i < G * 2 * C; i += nt) {
    int g = i / (2 * C), k = i - g * 2 * C;
    if (g < ns) {
      size_t o = (size_t)(s0 + g) * 2 * C + k;
      a.c2m_out[o] = s_keep[g] ? a.c2m[o]
                   : (k < C ? a.c2m[o + C] : s_c1[g * C + k - C]);
    }
  }
  __syncthreads();

  // conv2: int8 weights packed [3C/4, N]
  for (int j = tid; j < N; j += nt) {
    int acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0;
    for (int w = 0; w < W2; ++w) {
      int wt = a.conv2_w[(size_t)w * N + j];
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = __dp4a(s_q[g * QW + w], wt, acc[g]);
    }
    float sc = a.conv2_scale[j], b = a.conv2_b[j];
#pragma unroll
    for (int g = 0; g < G; ++g)
      s_cat[g * N4 + j] = tanh_approx(dequant(acc[g], sc, b));
  }
  __syncthreads();

  // three GRU layers, z/r/n gate order, input = previous block of s_cat
  for (int l = 0; l < 3; ++l) {
    const float* h = a.h[l];
    for (int i = tid; i < G * HW; i += nt) {
      int g = i / HW, w = i - g * HW;
      const float* x = s_cat + g * N4 + l * N + 4 * w;
      s_q[g * QW + w] = pack4(x[0], x[1], x[2], x[3]);
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (g < ns) {
#pragma unroll
        for (int t = 0; t < 4; ++t) v[t] = h[(size_t)(s0 + g) * N + 4 * w + t];
      }
      s_qh[g * HW + w] = pack4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();

    const size_t wl = (size_t)l * HW * 3 * N;     // layer offset, packed
    const size_t vl = (size_t)l * 3 * N;          // layer offset, per column
    for (int j = tid; j < N; j += nt) {
      int ai[3][G], ar[3][G];
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int g = 0; g < G; ++g) { ai[k][g] = 0; ar[k][g] = 0; }
      for (int w = 0; w < HW; ++w) {
        const size_t row = wl + (size_t)w * 3 * N + j;
        int wi[3], wr[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          wi[k] = a.gru_in_w[row + k * N];
          wr[k] = a.gru_rec_w[row + k * N];
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          int xq = s_q[g * QW + w], hq = s_qh[g * HW + w];
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            ai[k][g] = __dp4a(xq, wi[k], ai[k][g]);
            ar[k][g] = __dp4a(hq, wr[k], ar[k][g]);
          }
        }
      }
      float si[3], bi[3], sr[3], br[3], d[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        size_t c = vl + k * N + j;
        si[k] = a.gru_in_scale[c]; bi[k] = a.gru_in_b[c];
        sr[k] = a.gru_rec_scale[c]; br[k] = a.gru_rec_b[c];
        d[k] = a.gru_diag[c];
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g >= ns) continue;
        const size_t o = (size_t)(s0 + g) * N + j;
        float hv = h[o];
        float zin[3], rec[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          zin[k] = dequant(ai[k][g], si[k], bi[k]);
          rec[k] = __fadd_rn(dequant(ar[k][g], sr[k], br[k]), __fmul_rn(hv, d[k]));
        }
        float z = sigmoid_approx(__fadd_rn(zin[0], rec[0]));
        float r = sigmoid_approx(__fadd_rn(zin[1], rec[1]));
        float n = tanh_approx(__fadd_rn(zin[2], __fmul_rn(rec[2], r)));
        float hn = __fadd_rn(__fmul_rn(z, hv), __fmul_rn(__fsub_rn(1.0f, z), n));
        s_cat[g * N4 + (l + 1) * N + j] = hn;
        a.h_out[l][o] = s_keep[g] ? hv : hn;
      }
    }
    __syncthreads();
  }

  // heads: [4N] -> NB gains + 1 VAD, f32 weights stored transposed
  // [NB+1, 4N]; one warp per output column, lanes split the sum (f64)
  const int warp = tid / 32, lane = tid % 32, nwarps = nt / 32;
  for (int c = warp; c < NB + 1; c += nwarps) {
    double acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.0;
    const float* wc = a.heads_w + (size_t)c * N4;
    for (int k = lane; k < N4; k += 32) {
      double w = wc[k];
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] += (double)s_cat[g * N4 + k] * w;
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
      for (int off = 16; off > 0; off >>= 1)
        acc[g] += __shfl_down_sync(0xffffffffu, acc[g], off);
    if (lane == 0) {
      float b = a.heads_b[c];
      for (int g = 0; g < ns; ++g) {
        float v = sigmoid_approx(__fadd_rn(__double2float_rn(acc[g]), b));
        if (c < NB) a.gains[(size_t)(s0 + g) * NB + c] = v;
        else a.vad[s0 + g] = s_keep[g] ? 0.0f : v;
      }
    }
  }
}

size_t smem_bytes(int F, int C, int N) {
  int QW = (3 * C > N ? 3 * C : N) / 4;
  return sizeof(float) * (size_t)G * (3 * F + C + 4 * N) +
         sizeof(int) * (size_t)G * (QW + N / 4);
}

}  // namespace

extern "C" {

// Pointers are device pointers to contiguous tensors; see nn/cuda_rnn.py for
// shapes.  Returns the CUDA error code of the launch (0 on success).
int rnnt_rnn_step(const float* feats, const uint8_t* silence,
                  const float* c1m, const float* c2m, const float* h1,
                  const float* h2, const float* h3,
                  const float* conv1_w, const float* conv1_b,
                  const int* conv2_w, const float* conv2_scale,
                  const float* conv2_b,
                  const int* gru_in_w, const float* gru_in_scale,
                  const float* gru_in_b,
                  const int* gru_rec_w, const float* gru_rec_scale,
                  const float* gru_rec_b, const float* gru_diag,
                  const float* heads_w, const float* heads_b,
                  float* c1m_out, float* c2m_out, float* h1_out,
                  float* h2_out, float* h3_out, float* gains, float* vad,
                  int S, int F, int C, int N, int NB, void* stream) {
  if (S <= 0) return 0;
  Args a{feats, silence, c1m, c2m, {h1, h2, h3},
         conv1_w, conv1_b, conv2_w, conv2_scale, conv2_b,
         gru_in_w, gru_in_scale, gru_in_b,
         gru_rec_w, gru_rec_scale, gru_rec_b, gru_diag,
         heads_w, heads_b,
         c1m_out, c2m_out, {h1_out, h2_out, h3_out}, gains, vad,
         S, F, C, N, NB};
  size_t smem = smem_bytes(F, C, N);
  cudaError_t err = cudaFuncSetAttribute(
      rnn_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (S + G - 1) / G;
  rnn_step_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
