// The delayed frame's post-filter and synthesis for one stream (the comb
// filter, the gains, the inverse spectrum and the overlap-add), as device
// code shared by spectral.cu (the post-filter kernel) and frame.cu (the
// whole-chunk kernel).  See spectral.cu for what it computes.

#pragma once

#include "spectral_common.cuh"

namespace rnnt {

constexpr int NB = 32;             // bands

// sum over bands b of m[b * NBIN] * v[b], in band order, f32 FMA: bin k of
// the interpolation of band values v, with m = interp + k (neighbouring
// threads read neighbouring bins)
__device__ __forceinline__ float band_dot(const float* __restrict__ m,
                                          const float* v) {
  float acc = 0.0f;
#pragma unroll
  for (int b = 0; b < NB; ++b) acc = fmaf(m[b * NBIN], v[b], acc);
  return acc;
}

// The delayed frame's post-filter and synthesis for one stream, by a block
// of at least 256 threads in whole warps (the inverse FFT's split stages).  The band arithmetic uses the _rn intrinsics, so it
// rounds as the plain version's elementwise operators do; the per-bin
// interpolations (interp [32, 481]) and the band energies (band [481, 32])
// are f32 dot products in their own order.  Per-stream pointers: X, P [962]
// the delayed spectra, dEx, dEp, dExp, g, lastg, Ex [32], smem [480] the
// synthesis memory; lastg_out and smem_out may be lastg and smem.  Output
// sample n < 480 goes to store(n, value).  The inverse spectrum is
// inv_spectra's f64 FFT with its butterflies split over lanes (a block of at
// least 256 threads, whole warps); tw is the base table extended by the FFT
// table (cuda_spectral.fft_tables), in device memory.
struct __align__(16) PostSmem {
  double2 fft[FH];
  float re[NBIN], im[NBIN], e2[NBIN];
  float r[NB], gc[NB], norm[NB];
};

template <class Store>
__device__ __forceinline__ void postfilter_body(
    PostSmem& sm, const float* X, const float* P, const float* dEx,
    const float* dEp, const float* dExp, const float* g, const float* lastg,
    const float* Ex, bool silent, const float* smem,
    const float* __restrict__ band, const float* __restrict__ interp,
    const float* __restrict__ window, const double2* __restrict__ tw,
    Store store, float* smem_out, float* lastg_out) {
  const int tid = threadIdx.x;
  if (tid < NB) {
    const int i = tid;
    const float ex = dEx[i], ep = dEp[i], exp_ = dExp[i], gb = g[i];
    // comb strength r (denoise.c:429-441)
    const float e2 = __fmul_rn(exp_, exp_), g2 = __fmul_rn(gb, gb);
    float r = exp_ > gb ? 1.0f
        : __fdiv_rn(__fmul_rn(e2, __fsub_rn(1.0f, g2)),
                    __fadd_rn((float)0.001, __fmul_rn(g2, __fsub_rn(1.0f, e2))));
    r = __fsqrt_rn(fminf(fmaxf(r, 0.0f), 1.0f));
    sm.r[tid] = __fmul_rn(r, __fsqrt_rn(__fdiv_rn(ex, __fadd_rn((float)1e-8, ep))));
    // gain cap and the energy-compensated lastg (denoise.c:479-489)
    const float lg0 = lastg[i];
    const float gc = fmaxf(gb, __fmul_rn((float)0.6, lg0));
    sm.gc[tid] = gc;
    const float lg = __fdiv_rn(__fmul_rn(gc, __fadd_rn(ex, (float)1e-3)),
                               __fadd_rn(Ex[i], (float)1e-3));
    lastg_out[i] = silent ? lg0 : fminf(lg, 1.0f);
  }
  __syncthreads();
  for (int k = tid; k < NBIN; k += blockDim.x) {
    const float rf = band_dot(interp + k, sm.r);
    const float yr = __fadd_rn(X[k], __fmul_rn(rf, P[k]));
    const float yi = __fadd_rn(X[NBIN + k], __fmul_rn(rf, P[NBIN + k]));
    sm.re[k] = yr;
    sm.im[k] = yi;
    sm.e2[k] = __fadd_rn(__fmul_rn(yr, yr), __fmul_rn(yi, yi));
  }
  __syncthreads();
  // band energies of the filtered spectrum: one warp per band
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  for (int b = warp; b < NB; b += nwarps) {
    float acc = 0.0f;
    for (int k = lane; k < NBIN; k += 32)
      acc = fmaf(band[k * NB + b], sm.e2[k], acc);
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0)
      sm.norm[b] = __fsqrt_rn(__fdiv_rn(dEx[b], __fadd_rn((float)1e-8, acc)));
  }
  __syncthreads();
  for (int k = tid; k < NBIN; k += blockDim.x) {
    if (silent) {
      sm.re[k] = X[k];
      sm.im[k] = X[NBIN + k];
    } else {
      const float nf = band_dot(interp + k, sm.norm);
      const float gf = band_dot(interp + k, sm.gc);
      sm.re[k] = __fmul_rn(__fmul_rn(sm.re[k], nf), gf);
      sm.im[k] = __fmul_rn(__fmul_rn(sm.im[k], nf), gf);
    }
  }
  __syncthreads();
  // the windowed inverse, then the overlap-add: a thread reads smem[n] before
  // it writes smem_out[n] (which may be the same memory)
  inv_spectra<true>(
      1, sm.fft, tw, tw + WS, window,
      [&](int, int k) { return make_float2(sm.re[k], sm.im[k]); },
      [&](int, int n, float2 lo, float2 hi) {
        store(n, __fadd_rn(lo.x, smem[n]));
        store(n + 1, __fadd_rn(lo.y, smem[n + 1]));
        smem_out[n] = hi.x;
        smem_out[n + 1] = hi.y;
      });
}

}  // namespace rnnt
