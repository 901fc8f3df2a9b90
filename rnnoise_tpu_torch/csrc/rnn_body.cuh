// The RNNoise network's step for a block of streams, as device code shared by
// rnn_step.cu (the RNN step alone) and frame.cu (the whole-chunk kernel).
// See rnn_step.cu for what it computes and how its numerics match the plain
// version.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace rnnt {

constexpr int RNN_G = 8;       // streams per block
constexpr int RNN_WARPS = 16;  // warps per block (nn/cuda_rnn.py RNN_WARPS)
// The int8 matrices' nonzero blocks: 8 output columns (a unit group) x 4
// inputs (one packed word); one tensor-core product takes MMA_BLOCKS of
// them (32 inputs).
constexpr int BLOCK_OUT = 8, MMA_BLOCKS = 8;
// products of each list whose loads a warp issues before its first product:
// the first GRU_FIRST of each of a GRU task's 3 lists of one matrix (all
// but the longest lists), the first CONV2_FIRST of a conv2 task's list
constexpr int GRU_FIRST = 6, CONV2_FIRST = 12;
constexpr int MMA_BATCH = 4;   // then the rest of a list, this many at once
// the heads' output columns a warp takes at once, so that each activation
// it reads from shared memory serves that many columns
constexpr int HEAD_COLS = 3;
static_assert(RNN_G == 8, "a product's rows 0-7 are the block's streams");

// Phase marks for scripts/torch_rnn_phases.py: built with -DRNNT_PHASES,
// lane 0 of each warp of the first PHASE_BLOCKS blocks records clock64()
// at the end of each phase of rnn_body in rnn_phase_clock; otherwise the
// marks are empty.
constexpr int RNN_PHASES = 16, PHASE_BLOCKS = 256;
#ifdef RNNT_PHASES
__device__ long long rnn_phase_clock[PHASE_BLOCKS][RNN_WARPS][RNN_PHASES];
#define RNN_MARK(n)                                                       \
  if ((threadIdx.x & 31) == 0 && blockIdx.x < PHASE_BLOCKS)               \
    rnn_phase_clock[blockIdx.x][threadIdx.x >> 5][n] = clock64()
#else
#define RNN_MARK(n)
#endif

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

struct RnnArgs {
  const float* feats; const uint8_t* silence;
  const float* c1m; const float* c2m;
  const float* h[3];
  const float* conv1_w; const float* conv1_b;
  const int* q_w; const int* q_k; const int* q_sched;
  const float* conv2_scale; const float* conv2_b;
  const float* gru_in_scale; const float* gru_in_b;
  const float* gru_rec_scale; const float* gru_rec_b; const float* gru_diag;
  const float* heads_w; const float* heads_b;
  float* c1m_out; float* c2m_out; float* h_out[3];
  float* gains; float* vad;
  int S, F, C, N, NB;
};

// d += A B for one m16n8k32 int8 tensor-core product with s32 accumulation
// (exact): A's rows 0-7 are a0 (inputs 0-15) and a2 (16-31), rows 8-15
// zero; d0, d1 are row lane / 4, columns 2 (lane % 4) and 2 (lane % 4) + 1.
__device__ __forceinline__ void mma_s8(int& d0, int& d1, int a0, int a2, int b0,
                                       int b1) {
  int d2 = 0, d3 = 0;
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d0), "+r"(d1), "+r"(d2), "+r"(d3)
      : "r"(a0), "r"(0), "r"(a2), "r"(0), "r"(b0), "r"(b1));
}

// Loads of products of one block list (blocks begin .. end - 1 of q_w,
// q_k) from block i0 on: lane (g, t) = (lane / 4, lane % 4) loads blocks t
// and t + 4 of each 8, its word for column g (b0, b1) and the two blocks'
// input words (kk: q_k of block t holds block t + 4's in its high half);
// past the end, zero weights of word 0.
template <int K>
struct ListLoads {
  int b0[K], b1[K], kk[K];
  __device__ __forceinline__ void load(const RnnArgs& a, int i0, int end, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int v = 0; v < K; ++v) {
      const int i = i0 + v * MMA_BLOCKS + t, j = i + 4;
      b0[v] = i < end ? a.q_w[(size_t)i * BLOCK_OUT + g] : 0;
      kk[v] = i < end ? a.q_k[i] : 0;
      b1[v] = j < end ? a.q_w[(size_t)j * BLOCK_OUT + g] : 0;
    }
  }
  // the products of the loaded blocks, their input words gathered from
  // s_x [words][RNN_G] as A (row = stream), added to d: stream g's sums of
  // columns 2t and 2t + 1
  __device__ __forceinline__ void multiply(int i0, int end, const int* s_x, int lane,
                                           int2& d) const {
    const int g = lane >> 2;
#pragma unroll
    for (int v = 0; v < K; ++v)
      if (i0 + v * MMA_BLOCKS < end)                // the same in the warp
        mma_s8(d.x, d.y, s_x[(kk[v] & 0xffff) * RNN_G + g],
               s_x[((unsigned)kk[v] >> 16) * RNN_G + g], b0[v], b1[v]);
  }
};

// The warps' schedule of the int8 stages (conv2, then the GRU layers), as
// nn/cuda_rnn.py:schedule lays it out: sched_split(st)[w] .. [w + 1] are warp
// w's tasks in stage st, and task i of the stage is the record
// sched_task(st, i): its unit group, then the bounds of its lists.
constexpr int SCHED_REC0 = 3, SCHED_REC = 8;   // record sizes: conv2, GRU
__host__ __device__ inline int sched_size(int NG) {
  return 4 * (RNN_WARPS + 1) + NG * (SCHED_REC0 + 3 * SCHED_REC);
}
__device__ __forceinline__ const int* sched_split(const int* sc, int st) {
  return sc + st * (RNN_WARPS + 1);
}
__device__ __forceinline__ const int* sched_task(const int* sc, int st, int i,
                                                 int NG) {
  const int* r = sc + 4 * (RNN_WARPS + 1);
  return st == 0 ? r + i * SCHED_REC0
                 : r + NG * SCHED_REC0 + ((st - 1) * NG + i) * SCHED_REC;
}

// The s32 sums x W of a unit group's NL block lists, by a whole warp: each
// list's 8 blocks at a time are one product, the blocks' packed input words
// gathered as A and their weights as B.  The lists' bounds are
// bound[0 .. NL]; list L's inputs are s_x[L / 3] (the GRU's input, then
// its state).  The lists go in groups of up to 3 (one matrix): the loads of
// each list's first FIRST products in the group are issued before its first
// product, then each list's rest MMA_BATCH products at a time.  Leaves lane
// (g, t) with stream g's sums of the group's columns 2t and 2t + 1 in d[L].
template <int NL, int FIRST>
__device__ __forceinline__ void task_dots(const RnnArgs& a, const int* bound,
                                          const int* const (&s_x)[2], int lane,
                                          int2 (&d)[NL]) {
  constexpr int NG3 = NL < 3 ? NL : 3;
#pragma unroll
  for (int L0 = 0; L0 < NL; L0 += NG3) {
    const int* x = s_x[L0 / 3];
    int beg[NG3 + 1];
#pragma unroll
    for (int L = 0; L <= NG3; ++L) beg[L] = bound[L0 + L];
    ListLoads<FIRST> first[NG3];
#pragma unroll
    for (int L = 0; L < NG3; ++L) first[L].load(a, beg[L], beg[L + 1], lane);
#pragma unroll
    for (int L = 0; L < NG3; ++L) {
      int2& dl = d[L0 + L];
      dl = make_int2(0, 0);
      first[L].multiply(beg[L], beg[L + 1], x, lane, dl);
      for (int i0 = beg[L] + FIRST * MMA_BLOCKS; i0 < beg[L + 1];
           i0 += MMA_BATCH * MMA_BLOCKS) {
        ListLoads<MMA_BATCH> rest;
        rest.load(a, i0, beg[L + 1], lane);
        rest.multiply(i0, beg[L + 1], x, lane, dl);
      }
    }
  }
}

// Bytes of the shared memory that first holds conv1's weights [3F][C] f32,
// then s_cat [G][4N] f64, a layer's parameters [5][3N] and state [G][N]
// (f32), a multiple of 16.
__host__ __device__ inline size_t rnn_union_bytes(int F, int C, int N) {
  const size_t w1 = sizeof(float) * (size_t)3 * F * C;
  const size_t cat = sizeof(double) * (size_t)RNN_G * 4 * N +
                     sizeof(float) * ((size_t)15 * N + (size_t)RNN_G * N);
  return ((w1 > cat ? w1 : cat) + 15) / 16 * 16;
}

// The step for streams s0 .. s0+RNN_G-1 (those below a.S), by a block of
// RNN_WARPS warps, with smem holding rnn_smem_bytes(F, C, N) bytes.
__device__ __forceinline__ void rnn_body(const RnnArgs& a, unsigned char* smem,
                                         int s0) {
  const int F = a.F, C = a.C, N = a.N, NB = a.NB;
  const int F3 = 3 * F, C3 = 3 * C, N4 = 4 * N;
  const int QW = (C3 > N ? C3 : N) / 4;     // packed words of a layer input
  const int HW = N / 4;
  const int NG = N / BLOCK_OUT;             // unit groups
  // the f32 inputs of the f64 dots held as f64 (exact): conv1's input,
  // word-major ([3F][G]), and the heads' input s_cat ([G][4N]); conv1's
  // weights are staged where s_cat and the layer's parameters go later
  double* s_tmp1 = reinterpret_cast<double*>(smem);         // [3F][G]
  double* s_cat = s_tmp1 + RNN_G * F3;                      // [G][4N]
  float* s_w1 = reinterpret_cast<float*>(s_cat);            // [3F][C]
  // a layer's per-column parameters (conv2: scale, bias; a GRU layer: its
  // input scale and bias, recurrent scale and bias, diagonal) and the
  // layer's state, staged with its packed input
  float* s_par = reinterpret_cast<float*>(s_cat + RNN_G * N4);  // [5][3N]
  float* s_h = s_par + 15 * N;                              // [G][N]
  float* s_c1 = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(s_cat) + rnn_union_bytes(F, C, N));  // [G][C]
  // packed int8 activations word-major, [words][G]
  int* s_q = reinterpret_cast<int*>(s_c1 + RNN_G * C);      // [QW][G]
  int* s_qh = s_q + RNN_G * QW;                             // [HW][G]
  int* s_sched = s_qh + RNN_G * HW;                         // sched_size(NG)
  __shared__ bool s_keep[RNN_G];

  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ns = min(RNN_G, a.S - s0);
  RNN_MARK(0);
  if (tid < RNN_G) s_keep[tid] = tid < ns && a.silence[s0 + tid] != 0;

  // conv1 input [c1m | feats], conv1's weights and the schedule
  for (int i = tid; i < RNN_G * F3; i += nt) {
    int g = i / F3, k = i - g * F3;
    float v = 0.0f;
    if (g < ns) {
      v = k < 2 * F ? a.c1m[(size_t)(s0 + g) * 2 * F + k]
                    : a.feats[(size_t)(s0 + g) * F + k - 2 * F];
    }
    s_tmp1[k * RNN_G + g] = v;
  }
  for (int i = tid; i < F3 * C; i += nt) s_w1[i] = a.conv1_w[i];
  for (int i = tid; i < sched_size(NG); i += nt) s_sched[i] = a.q_sched[i];
  __syncthreads();
  RNN_MARK(1);

  // conv1: f32 weights [3F, C], accumulated in f64 over k in order; a
  // thread takes unit j for all streams, so each weight is converted once
  for (int j = tid; j < C; j += nt) {
    double acc[RNN_G];
#pragma unroll
    for (int g = 0; g < RNN_G; ++g) acc[g] = 0.0;
    for (int k = 0; k < F3; ++k) {
      const double wk = s_w1[k * C + j];
      const double2* x = reinterpret_cast<const double2*>(s_tmp1 + k * RNN_G);
#pragma unroll
      for (int g = 0; g < RNN_G / 2; ++g) {
        const double2 xg = x[g];
        acc[2 * g] = fma(xg.x, wk, acc[2 * g]);
        acc[2 * g + 1] = fma(xg.y, wk, acc[2 * g + 1]);
      }
    }
    const float b = a.conv1_b[j];
#pragma unroll
    for (int g = 0; g < RNN_G; ++g)
      s_c1[g * C + j] = tanh_approx(__fadd_rn(__double2float_rn(acc[g]), b));
  }
  for (int i = tid; i < RNN_G * 2 * F; i += nt) {
    int g = i / (2 * F), k = i - g * 2 * F;
    if (g < ns) {
      size_t o = (size_t)(s0 + g) * 2 * F + k;
      a.c1m_out[o] = s_keep[g] ? a.c1m[o] : (float)s_tmp1[(F + k) * RNN_G + g];
    }
  }
  __syncthreads();
  RNN_MARK(2);

  // conv2 input [c2m | c1], quantised and packed, and its parameters
  const int W2 = C3 / 4;
  for (int i = tid; i < RNN_G * W2; i += nt) {
    int w = i / RNN_G, g = i - w * RNN_G;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (g < ns) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        int k = 4 * w + t;
        v[t] = k < 2 * C ? a.c2m[(size_t)(s0 + g) * 2 * C + k]
                         : s_c1[g * C + k - 2 * C];
      }
    }
    s_q[i] = pack4(v[0], v[1], v[2], v[3]);
  }
  for (int i = tid; i < N; i += nt) {
    s_par[i] = a.conv2_scale[i];
    s_par[N + i] = a.conv2_b[i];
  }
  for (int i = tid; i < RNN_G * 2 * C; i += nt) {
    int g = i / (2 * C), k = i - g * 2 * C;
    if (g < ns) {
      size_t o = (size_t)(s0 + g) * 2 * C + k;
      a.c2m_out[o] = s_keep[g] ? a.c2m[o]
                   : (k < C ? a.c2m[o + C] : s_c1[g * C + k - C]);
    }
  }
  __syncthreads();
  RNN_MARK(3);

  // conv2 and the three GRU layers (z/r/n gate order, input = previous
  // block of s_cat): stage 0 is conv2, stage l + 1 GRU layer l.  In stage
  // st, warp w takes the tasks sched_split(st)[w] .. [w + 1] of the
  // schedule; a unit group's lists (task_dots) leave lane (g, t) with
  // stream g's sums of its units 8 u + 2 t and 8 u + 2 t + 1, whose outputs
  // the lane finishes itself.
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int* const xs[2] = {s_q, s_qh};
  for (int st = 0; st < 4; ++st) {
    const int* split = sched_split(s_sched, st);
    if (st == 0) {
      for (int ti = split[warp]; ti < split[warp + 1]; ++ti) {
        const int* rec = sched_task(s_sched, 0, ti, NG);
        const int u = rec[0];
        int2 acc[1];
        task_dots<1, CONV2_FIRST>(a, rec + 1, xs, lane, acc);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = BLOCK_OUT * u + t2 + e;
          s_cat[g * N4 + j] =
              tanh_approx(dequant(e ? acc[0].y : acc[0].x, s_par[j], s_par[N + j]));
        }
      }
      RNN_MARK(4);
      __syncthreads();
      RNN_MARK(5);
      continue;
    }
    const int l = st - 1;
    const float* h = a.h[l];
    for (int i = tid; i < RNN_G * HW; i += nt) {
      int w = i / RNN_G, gg = i - w * RNN_G;
      const double* x = s_cat + gg * N4 + l * N + 4 * w;
      s_q[i] = pack4((float)x[0], (float)x[1], (float)x[2], (float)x[3]);
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (gg < ns) {
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = h[(size_t)(s0 + gg) * N + 4 * w + k];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) s_h[gg * N + 4 * w + k] = v[k];
      s_qh[i] = pack4(v[0], v[1], v[2], v[3]);
    }
    const size_t vl = (size_t)l * 3 * N;          // layer offset, per column
    for (int i = tid; i < 3 * N; i += nt) {
      s_par[i] = a.gru_in_scale[vl + i];
      s_par[3 * N + i] = a.gru_in_b[vl + i];
      s_par[6 * N + i] = a.gru_rec_scale[vl + i];
      s_par[9 * N + i] = a.gru_rec_b[vl + i];
      s_par[12 * N + i] = a.gru_diag[vl + i];
    }
    __syncthreads();
    RNN_MARK(3 + 3 * st);

    for (int ti = split[warp]; ti < split[warp + 1]; ++ti) {
      const int* rec = sched_task(s_sched, st, ti, NG);
      const int u = rec[0];
      int2 acc[6];                                // [matrix * 3 + gate]
      task_dots<6, GRU_FIRST>(a, rec + 1, xs, lane, acc);
      if (g >= ns) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = BLOCK_OUT * u + t2 + e;
        const float hv = s_h[g * N + j];
        float zin[3], rec[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int c = k * N + j;
          zin[k] = dequant(e ? acc[k].y : acc[k].x, s_par[c], s_par[3 * N + c]);
          rec[k] = __fadd_rn(dequant(e ? acc[3 + k].y : acc[3 + k].x,
                                     s_par[6 * N + c], s_par[9 * N + c]),
                             __fmul_rn(hv, s_par[12 * N + c]));
        }
        float z = sigmoid_approx(__fadd_rn(zin[0], rec[0]));
        float r = sigmoid_approx(__fadd_rn(zin[1], rec[1]));
        float n = tanh_approx(__fadd_rn(zin[2], __fmul_rn(rec[2], r)));
        float hn = __fadd_rn(__fmul_rn(z, hv), __fmul_rn(__fsub_rn(1.0f, z), n));
        s_cat[g * N4 + (l + 1) * N + j] = hn;
        a.h_out[l][(size_t)(s0 + g) * N + j] = s_keep[g] ? hv : hn;
      }
    }
    RNN_MARK(4 + 3 * st);
    __syncthreads();
    RNN_MARK(5 + 3 * st);
  }

  // heads: [4N] -> NB gains + 1 VAD, f32 weights stored transposed
  // [NB+1, 4N].  Column c's sum is split over the lanes of one warp (lane L
  // adds k = L, L + 32, ... in order, in f64), then added up by shuffles; a
  // warp takes HEAD_COLS columns (w, w + nh, ...) at once.
  const int nh = (NB + HEAD_COLS) / HEAD_COLS;     // warps with columns
  for (int w = warp; w < nh; w += RNN_WARPS) {
    double acc[HEAD_COLS][RNN_G];
#pragma unroll
    for (int c = 0; c < HEAD_COLS; ++c)
#pragma unroll
      for (int gg = 0; gg < RNN_G; ++gg) acc[c][gg] = 0.0;
#pragma unroll 4
    for (int k = lane; k < N4; k += 32) {
      double wk[HEAD_COLS];
#pragma unroll
      for (int c = 0; c < HEAD_COLS; ++c) {
        const int col = w + c * nh;
        wk[c] = col <= NB ? a.heads_w[(size_t)col * N4 + k] : 0.0f;
      }
#pragma unroll
      for (int gg = 0; gg < RNN_G; ++gg) {
        const double x = s_cat[gg * N4 + k];
#pragma unroll
        for (int c = 0; c < HEAD_COLS; ++c) acc[c][gg] = fma(x, wk[c], acc[c][gg]);
      }
    }
#pragma unroll
    for (int c = 0; c < HEAD_COLS; ++c) {
      const int col = w + c * nh;
#pragma unroll
      for (int gg = 0; gg < RNN_G; ++gg)
        for (int off = 16; off > 0; off >>= 1)
          acc[c][gg] += __shfl_down_sync(0xffffffffu, acc[c][gg], off);
      if (lane == 0 && col <= NB) {
        const float b = a.heads_b[col];
        for (int gg = 0; gg < ns; ++gg) {
          const float v = sigmoid_approx(__fadd_rn(__double2float_rn(acc[c][gg]), b));
          if (col < NB) a.gains[(size_t)(s0 + gg) * NB + col] = v;
          else a.vad[s0 + gg] = s_keep[gg] ? 0.0f : v;
        }
      }
    }
  }
  RNN_MARK(15);
}

inline size_t rnn_smem_bytes(int F, int C, int N) {
  const int QW = (3 * C > N ? 3 * C : N) / 4;
  return sizeof(double) * (size_t)RNN_G * 3 * F + rnn_union_bytes(F, C, N) +
         sizeof(float) * (size_t)RNN_G * C +
         sizeof(int) * ((size_t)RNN_G * (QW + N / 4) + sched_size(N / BLOCK_OUT));
}

}  // namespace rnnt
