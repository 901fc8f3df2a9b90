#!/usr/bin/env python3
"""The f64 tensor cores' rate by mma.sync shape on one GPU, and a check of
the fragment layouts the port's kernels assume.

    python3 scripts/torch_f64_mma_rate.py

Run on a machine with the CUDA toolkit and a card.  Builds a small CUDA
program with nvcc for sm_90a (into a temporary directory) and runs it: for
each f64 shape (m8n8k4, m16n8k4, m16n8k8, m16n8k16) it first multiplies one
small integer A and B through the shape's fragments as laid out below (A
row g + 8 (i % 2), column t + 4 (i // 2); B row t + 4 i, column g; C row
g + 8 (i // 2), column 2t + i % 2, for lane 4g + t; m8n8k4: A (g, t), B
(t, g), C (g, 2t + i)) and counts the outputs that differ from the exact
product, then times 8 independent chains of 4096 products in each warp of
1056 blocks of 128 threads (CUDA events) and prints TFLOP/s and
multiply-adds a clock an SM at 1.98 GHz, and the clocks a product takes
in one dependent chain of one warp (clock64); then m16n8k8's rate with 1
to 8 independent chains a warp at 16 warps an SM.  csrc/analysis_body.cuh's
lag_energy_mma uses m16n8k8 with this layout.
"""

import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from rnnoise_tpu_torch import kernels  # noqa: E402

SOURCE = r"""#include <cstdio>
#include <cstdlib>
#include <cuda_runtime.h>

template <int S> struct Shape;
template <> struct Shape<0> { static constexpr int M = 8, K = 4, NA = 1, NB = 1, NC = 2; };
template <> struct Shape<1> { static constexpr int M = 16, K = 4, NA = 2, NB = 1, NC = 4; };
template <> struct Shape<2> { static constexpr int M = 16, K = 8, NA = 4, NB = 2, NC = 4; };
template <> struct Shape<3> { static constexpr int M = 16, K = 16, NA = 8, NB = 4, NC = 4; };

template <int S> __device__ __forceinline__ void mma(double* c, const double* a, const double* b);
template <> __device__ __forceinline__ void mma<0>(double* c, const double* a, const double* b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};"
      : "+d"(c[0]), "+d"(c[1]) : "d"(a[0]), "d"(b[0]));
}
template <> __device__ __forceinline__ void mma<1>(double* c, const double* a, const double* b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3]) : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}
template <> __device__ __forceinline__ void mma<2>(double* c, const double* a, const double* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
template <> __device__ __forceinline__ void mma<3>(double* c, const double* a, const double* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
        "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// assumed layouts: A row g + 8 (i % 2), col t + 4 (i / 2); B row t + 4 i, col g;
// C row g + 8 (i / 2), col 2t + i % 2 (m8n8k4: A (g, t), B (t, g), C (g, 2t + i)).
template <int S> __host__ __device__ void a_pos(int lane, int i, int& r, int& c) {
  const int g = lane >> 2, t = lane & 3;
  r = g + 8 * (i % 2); c = t + 4 * (i / 2);
}
template <int S> __host__ __device__ void b_pos(int lane, int i, int& r, int& c) {
  const int g = lane >> 2, t = lane & 3;
  r = t + 4 * i; c = g;
}
template <int S> __host__ __device__ void c_pos(int lane, int i, int& r, int& c) {
  const int g = lane >> 2, t = lane & 3;
  r = g + 8 * (i / 2); c = 2 * t + i % 2;
}

template <int S> __global__ void layout(const double* A, const double* B, double* C) {
  using Sh = Shape<S>;
  const int lane = threadIdx.x;
  double a[8], b[4], c[4] = {0, 0, 0, 0};
  for (int i = 0; i < Sh::NA; ++i) { int r, k; a_pos<S>(lane, i, r, k); a[i] = A[r * Sh::K + k]; }
  for (int i = 0; i < Sh::NB; ++i) { int k, n; b_pos<S>(lane, i, k, n); b[i] = B[k * 8 + n]; }
  mma<S>(c, a, b);
  for (int i = 0; i < Sh::NC; ++i) { int r, n; c_pos<S>(lane, i, r, n); C[r * 8 + n] = c[i]; }
}

template <int S, int CH> __global__ void __launch_bounds__(128) tput(double* out, int iters) {
  using Sh = Shape<S>;
  double a[8], b[4], c[CH][4];
  for (int i = 0; i < 8; ++i) a[i] = 1e-3 * (threadIdx.x + i);
  for (int i = 0; i < 4; ++i) b[i] = 1e-3 * (threadIdx.x - i);
  for (int k = 0; k < CH; ++k) for (int i = 0; i < 4; ++i) c[k][i] = 0.0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < CH; ++k) mma<S>(c[k], a, b);
  }
  double s = 0;
  for (int k = 0; k < CH; ++k) for (int i = 0; i < 4; ++i) s += c[k][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int S> __global__ void latency(double* out, long long* cyc, int iters) {
  double a[8], b[4], c[4] = {0, 0, 0, 0};
  for (int i = 0; i < 8; ++i) a[i] = 1e-3 * (threadIdx.x + i);
  for (int i = 0; i < 4; ++i) b[i] = 1e-3 * (threadIdx.x - i);
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) mma<S>(c, a, b);
  const long long t1 = clock64();
  out[threadIdx.x] = c[0] + c[1] + c[2] + c[3];
  if (threadIdx.x == 0) *cyc = t1 - t0;
}

template <int S> void run(const char* name) {
  using Sh = Shape<S>;
  double hA[256], hB[128], hC[128], ref[128];
  for (int i = 0; i < Sh::M * Sh::K; ++i) hA[i] = (rand() % 17) - 8;
  for (int i = 0; i < Sh::K * 8; ++i) hB[i] = (rand() % 13) - 6;
  for (int r = 0; r < Sh::M; ++r) for (int n = 0; n < 8; ++n) {
    double s = 0; for (int k = 0; k < Sh::K; ++k) s += hA[r * Sh::K + k] * hB[k * 8 + n];
    ref[r * 8 + n] = s;
  }
  double *dA, *dB, *dC, *out;
  cudaMalloc(&dA, sizeof hA); cudaMalloc(&dB, sizeof hB); cudaMalloc(&dC, sizeof hC);
  cudaMemcpy(dA, hA, sizeof hA, cudaMemcpyHostToDevice);
  cudaMemcpy(dB, hB, sizeof hB, cudaMemcpyHostToDevice);
  layout<S><<<1, 32>>>(dA, dB, dC);
  cudaMemcpy(hC, dC, sizeof hC, cudaMemcpyDeviceToHost);
  int bad = 0;
  for (int i = 0; i < Sh::M * 8; ++i) bad += hC[i] != ref[i];
  const int blocks = 132 * 8, threads = 128, iters = 4096;
  cudaMalloc(&out, sizeof(double) * blocks * threads);
  tput<S, 8><<<blocks, threads>>>(out, 16);
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  cudaEventRecord(e0);
  tput<S, 8><<<blocks, threads>>>(out, iters);
  cudaEventRecord(e1); cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  const double fma = (double)blocks * (threads / 32) * iters * 8 * Sh::M * 8 * Sh::K;
  long long* cyc;
  cudaMalloc(&cyc, sizeof(long long));
  latency<S><<<1, 32>>>(out, cyc, 16);
  latency<S><<<1, 32>>>(out, cyc, 1024);
  long long c = 0;
  cudaMemcpy(&c, cyc, sizeof c, cudaMemcpyDeviceToHost);
  printf("%-9s layout %s (%d of %d differ); %.2f TFLOP/s, %.1f fma/clk/SM at 1.98 GHz; "
         "one chain %.1f clocks a product (%s)\n",
         name, bad ? "WRONG" : "ok", bad, Sh::M * 8, 2 * fma / ms / 1e9,
         fma / (ms * 1e-3) / 132 / 1.98e9, c / 1024.0, cudaGetErrorString(cudaGetLastError()));
}

// m16n8k8 with CH chains a warp, 4 warps a block and 4 blocks an SM (16
// warps, as the analysis kernel runs its products)
template <int CH> void chains() {
  const int blocks = 132 * 4, threads = 128, iters = 4096;
  double* out;
  cudaMalloc(&out, sizeof(double) * blocks * threads);
  tput<2, CH><<<blocks, threads>>>(out, 16);
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  cudaEventRecord(e0);
  tput<2, CH><<<blocks, threads>>>(out, iters);
  cudaEventRecord(e1); cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  const double fma = (double)blocks * (threads / 32) * iters * CH * 16 * 8 * 8;
  printf("m16n8k8   %d chains a warp, 16 warps an SM: %.2f TFLOP/s, %.1f fma/clk/SM\n", CH,
         2 * fma / ms / 1e9, fma / (ms * 1e-3) / 132 / 1.98e9);
}

int main() {
  run<0>("m8n8k4"); run<1>("m16n8k4"); run<2>("m16n8k8"); run<3>("m16n8k16");
  chains<1>(); chains<2>(); chains<3>(); chains<4>(); chains<6>(); chains<8>();
  return 0;
}
"""


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as work:
        cu, exe = os.path.join(work, "f64_mma.cu"), os.path.join(work, "f64_mma")
        with open(cu, "w") as f:
            f.write(SOURCE)
        subprocess.run([kernels.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                        "-o", exe, cu], check=True)
        return subprocess.run([exe]).returncode


if __name__ == "__main__":
    sys.exit(main())
