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
// What bounds it: the weights each block reads from L2 (the device-memory
// bound, weights once and the state in and out, is far lower).  The int8
// matrices are stored 8-output x 4-input block-sparse in the reference's
// format (weights/blob.py densifies it); only a third of the GRU matrices'
// blocks is nonzero, so the kernel keeps only the nonzero blocks, as lists
// built once per model (nn/cuda_rnn.py block_lists): a block's 8 column
// words of 4 int8 weights, and the word of the layer input it multiplies.
// That is ~1.1 MB of int8 weights and indices a block in place of the
// dense 2.8 MB, plus conv1's and the heads' 0.3 MB of f32 weights.
// A unit group's lists (8 units; conv2: one list, a GRU layer: per matrix
// and gate) are one warp's task, the groups split over the block's 16
// warps by their products, so the warps are balanced though a list of the
// reference model holds 0 to 75 of its 96 possible blocks.  Tensor-core tiles of the dense matrices
// would not skip the zeros (tiles of 32 x 8 or 16 x 16 are ~90 % nonzero);
// a list's blocks, 8 at a time, with their input words gathered into the
// A operand, make one dense m16n8k32 int8 product each (rows: the block's
// 8 streams; columns: the list's 8 outputs; s32 accumulation), so the
// tensor cores do only the nonzero blocks' work and no lane reduction is
// needed.  The warps' schedule (which groups, where their lists start),
// conv1's weights, a layer's per-column parameters and state are staged in
// shared memory; the activations are quantised once per layer into shared
// memory.  conv1 and the heads, f32 weights summed in f64, hold their
// inputs as f64 in shared memory so that only the weights are converted,
// and a warp takes 3 of the heads' columns at once so that each input it
// reads serves 3.  Measured on the H100 (PERF.md), what remains is the
// latency of each warp's chain of L2 loads, products and gates: 16 warps
// cannot keep enough loads in flight to reach L2's bandwidth.
//
// The step itself is rnn_body.cuh, which frame.cu shares.
//
// Numerics match the plain version (nn/layers.py) bit for bit: int8 dots are
// exact in s32 in any partition and order, f32 dots accumulate in f64
// (products of two floats are exact there) and round once, and every
// elementwise step uses the _rn intrinsics so that nvcc contracts nothing
// into an FMA that PyTorch does not.  conv1 and the heads add their
// products in a fixed order (a thread's k in order; the heads' lanes, then
// a shuffle tree), so no partition of the work changes a bit.

#include "rnn_body.cuh"

namespace {

using namespace rnnt;

constexpr int THREADS = 32 * RNN_WARPS;

__global__ void __launch_bounds__(THREADS) rnn_step_kernel(RnnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  rnn_body(a, smem, blockIdx.x * RNN_G);
}

}  // namespace

extern "C" {

#ifdef RNNT_PHASES
// The phase marks of the last launch (rnn_body.cuh), copied to host memory
// of PHASE_BLOCKS x RNN_WARPS x RNN_PHASES int64.
int rnnt_rnn_phases(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, rnn_phase_clock, sizeof(rnn_phase_clock));
}
#endif

// Pointers are device pointers to contiguous tensors; see nn/cuda_rnn.py for
// shapes.  Returns the CUDA error code of the launch (0 on success).
int rnnt_rnn_step(const float* feats, const uint8_t* silence,
                  const float* c1m, const float* c2m, const float* h1,
                  const float* h2, const float* h3,
                  const float* conv1_w, const float* conv1_b,
                  const int* q_w, const int* q_k, const int* q_sched,
                  const float* conv2_scale, const float* conv2_b,
                  const float* gru_in_scale, const float* gru_in_b,
                  const float* gru_rec_scale, const float* gru_rec_b,
                  const float* gru_diag,
                  const float* heads_w, const float* heads_b,
                  float* c1m_out, float* c2m_out, float* h1_out,
                  float* h2_out, float* h3_out, float* gains, float* vad,
                  int S, int F, int C, int N, int NB, void* stream) {
  if (S <= 0) return 0;
  RnnArgs a{feats, silence, c1m, c2m, {h1, h2, h3},
            conv1_w, conv1_b, q_w, q_k, q_sched,
            conv2_scale, conv2_b,
            gru_in_scale, gru_in_b, gru_rec_scale, gru_rec_b, gru_diag,
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
