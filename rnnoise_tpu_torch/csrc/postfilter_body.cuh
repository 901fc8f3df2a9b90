// The delayed frame's post-filter and synthesis for a group of streams (the
// comb filter, the gains, the inverse spectrum and the overlap-add), as
// device code shared by spectral.cu (the post-filter kernel) and frame.cu
// (the whole-chunk kernel).  See spectral.cu for what it computes.

#pragma once

#include "spectral_common.cuh"

namespace rnnt {

constexpr int NB = 32;             // bands

// Phase marks of the whole-chunk kernel (frame.cu defines them under
// -DRNNT_FRAME_PHASES): the end of the comb filter and of the band energies.
#ifndef POST_MARK
#define POST_MARK(k)
#endif

// The compact band tables (dsp/cuda_spectral.py:band_tables): each bin
// touches at most two neighbouring bands, so bin k's row of a bin -> band
// table is one float4 (w0, w1, b, 0), its weights for bands b and b + 1;
// pairs[0] is the interpolation (band values -> bins), pairs[1] the energy
// table (bins -> bands), whose band b covers the bins ranges[b].x <= k <
// ranges[b].y.
constexpr int PAIR_INTERP = 0, PAIR_BAND = 1;

// Bin k's interpolation of band values v from its pair p: the two nonzero
// terms of the dense table's f32 dot product in band order, so the same
// float as the 32-term sum for finite v (its zero terms add exactly 0 to a
// sum that starts at +0).
__device__ __forceinline__ float pair_interp(float4 p, const float* v) {
  const int b = (int)p.z;
  return fmaf(p.y, v[b + 1], fmaf(p.x, v[b], 0.0f));
}

// Band b's weight of bin k, from the bin's pair p in the energy table (k in
// the band's range, so p.z is b or b - 1).
__device__ __forceinline__ float pair_weight(float4 p, int b) {
  return (int)p.z == b ? p.x : p.y;
}

// One stream's tensors: X, P [962] the delayed spectra, dEx, dEp, dExp, g,
// lastg, Ex [32], smem [480] the synthesis memory, silent the stream's
// silence flag; lastg_out and smem_out may be lastg and smem.
struct PostIO {
  const float* X; const float* P; const float* dEx; const float* dEp;
  const float* dExp; const float* g; const float* lastg; const float* Ex;
  const float* smem; float* smem_out; float* lastg_out; bool silent;
};

// Shared memory of postfilter_streams for up to G streams.
template <int G>
struct __align__(16) PostSmem {
  double2 fft[G * FH];
  float re[G][NBIN], im[G][NBIN];
  float r[G][NB], gc[G][NB], norm[G][NB];
};

// The delayed frame's post-filter and synthesis for nstr <= G streams, by
// all threads of the block (nstr * FH / FFT_R2 <= blockDim.x: the inverse's
// butterflies, one a thread).  io[g] is stream g's PostIO, in shared memory
// (a few loads where it is used, not ~20 pointers held in registers);
// output sample n < 480 of stream g goes to store(g, n, value).  The band
// arithmetic uses the _rn intrinsics, so it rounds as the plain version's
// elementwise operators do; the per-bin interpolations are two f32 FMAs in band order
// (pair_interp); each band energy of the filtered spectrum is summed in f64
// over the band's own bins in ascending order and rounded once, as the
// plain version's f64 table product (transform.compute_band_energy)
// rounds.  The inverse spectrum is inv_spectra's f64 FFT, its butterflies a
// thread each; tw holds the base twiddles, ft the FFT table.  Starts after
// the caller's last barrier on sm and on what io reads; ends with a barrier
// before the stores of the inverse's last pass and none after them.
template <int G, class Store>
__device__ __forceinline__ void postfilter_streams(
    int nstr, PostSmem<G>& sm, const PostIO* io, const float4* __restrict__ pairs,
    const int2* __restrict__ ranges, const float* __restrict__ window,
    const double2* __restrict__ tw, const double2* __restrict__ ft, Store store) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const float4* ipair = pairs + PAIR_INTERP * NBIN;
  const float4* bpair = pairs + PAIR_BAND * NBIN;
  // comb strength r (denoise.c:429-441), gain cap and the
  // energy-compensated lastg (denoise.c:479-489), per band
  for (int i = tid; i < nstr * NB; i += nt) {
    const int g = i / NB, b = i - g * NB;
    const PostIO& o = io[g];
    const float ex = o.dEx[b], ep = o.dEp[b], exp_ = o.dExp[b], gb = o.g[b];
    const float e2 = __fmul_rn(exp_, exp_), g2 = __fmul_rn(gb, gb);
    float r = exp_ > gb ? 1.0f
        : __fdiv_rn(__fmul_rn(e2, __fsub_rn(1.0f, g2)),
                    __fadd_rn((float)0.001, __fmul_rn(g2, __fsub_rn(1.0f, e2))));
    r = __fsqrt_rn(fminf(fmaxf(r, 0.0f), 1.0f));
    sm.r[g][b] = __fmul_rn(r, __fsqrt_rn(__fdiv_rn(ex, __fadd_rn((float)1e-8, ep))));
    const float lg0 = o.lastg[b];
    const float gc = fmaxf(gb, __fmul_rn((float)0.6, lg0));
    sm.gc[g][b] = gc;
    const float lg = __fdiv_rn(__fmul_rn(gc, __fadd_rn(ex, (float)1e-3)),
                               __fadd_rn(o.Ex[b], (float)1e-3));
    o.lastg_out[b] = o.silent ? lg0 : fminf(lg, 1.0f);
  }
  __syncthreads();
  // the comb filter X + r P, per bin
#pragma unroll 4
  for (int i = tid; i < nstr * NBIN; i += nt) {
    const int g = i / NBIN, k = i - g * NBIN;
    const PostIO& o = io[g];
    const float rf = pair_interp(ipair[k], sm.r[g]);
    sm.re[g][k] = __fadd_rn(o.X[k], __fmul_rn(rf, o.P[k]));
    sm.im[g][k] = __fadd_rn(o.X[NBIN + k], __fmul_rn(rf, o.P[NBIN + k]));
  }
  __syncthreads();
  POST_MARK(0);
  // the band energies of the filtered spectrum and the renormalisation
  for (int i = tid; i < nstr * NB; i += nt) {
    const int g = i / NB, b = i - g * NB;
    const int2 rg = ranges[b];
    double acc = 0.0;
    for (int k = rg.x; k < rg.y; ++k) {
      const float yr = sm.re[g][k], yi = sm.im[g][k];
      const float e2 = __fadd_rn(__fmul_rn(yr, yr), __fmul_rn(yi, yi));
      acc = fma((double)pair_weight(bpair[k], b), (double)e2, acc);
    }
    sm.norm[g][b] =
        __fsqrt_rn(__fdiv_rn(io[g].dEx[b], __fadd_rn((float)1e-8, (float)acc)));
  }
  __syncthreads();
  POST_MARK(1);
  // the gains applied as the inverse reads each bin (a silent stream's
  // spectrum unchanged), then the windowed inverse and the overlap-add: a
  // thread reads smem[n] before it writes smem_out[n] (which may be the same
  // memory)
  inv_spectra(
      nstr, sm.fft, tw, ft, window,
      [&](int g, int k) {
        const PostIO& o = io[g];
        if (o.silent) return make_float2(o.X[k], o.X[NBIN + k]);
        const float4 p = ipair[k];
        const float nf = pair_interp(p, sm.norm[g]), gf = pair_interp(p, sm.gc[g]);
        return make_float2(__fmul_rn(__fmul_rn(sm.re[g][k], nf), gf),
                           __fmul_rn(__fmul_rn(sm.im[g][k], nf), gf));
      },
      [&](int g, int n, float2 lo, float2 hi) {
        const PostIO& o = io[g];
        store(g, n, __fadd_rn(lo.x, o.smem[n]));
        store(g, n + 1, __fadd_rn(lo.y, o.smem[n + 1]));
        o.smem_out[n] = hi.x;
        o.smem_out[n + 1] = hi.y;
      });
}

}  // namespace rnnt
