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
// The step itself is rnn_body.cuh, which frame.cu shares.
//
// Numerics match the plain version (nn/layers.py) bit for bit: int8 dots are
// exact in s32, f32 dots accumulate in f64 (products of two floats are exact
// there) and round once, and every elementwise step uses the _rn intrinsics
// so that nvcc contracts nothing into an FMA that PyTorch does not.

#include "rnn_body.cuh"

namespace {

using namespace rnnt;

constexpr int THREADS = 384;   // one GRU unit per thread at gru_size 384

__global__ void __launch_bounds__(THREADS) rnn_step_kernel(RnnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  rnn_body(a, smem, blockIdx.x * RNN_G);
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
  RnnArgs a{feats, silence, c1m, c2m, {h1, h2, h3},
            conv1_w, conv1_b, conv2_w, conv2_scale, conv2_b,
            gru_in_w, gru_in_scale, gru_in_b,
            gru_rec_w, gru_rec_scale, gru_rec_b, gru_diag,
            heads_w, heads_b,
            c1m_out, c2m_out, {h1_out, h2_out, h3_out}, gains, vad,
            S, F, C, N, NB};
  size_t smem = rnn_smem_bytes(F, C, N);
  cudaError_t err = cudaFuncSetAttribute(
      rnn_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (S + RNN_G - 1) / RNN_G;
  rnn_step_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
