// Device code of the 960-point real spectra, shared by the kernels of
// spectral.cu (forward and inverse spectra, post-filter and synthesis) and
// analysis.cu (pitch analysis and both forward spectra).
//
// Forward: a spectrum's windowed input v is folded once into f64 halves,
// u0[n] = v[n] + v[n+480] (even bins) and u1[n] = v[n] - v[n+480] (odd
// bins), and each bin is summed in f64 over its half with the twiddles made
// by f64 rotation (drift below 1e-13 over 480 steps), then rounded once to
// f32.  The spectra feed knife-edge decisions, so these sums must round as
// the f64 DFT matmul of the plain versions does.
//
// Inverse: outputs n and n+480 come from one pass over the bin pairs
// (2m, 2m+1) as E+O and E-O, in f32 with twiddles by f32 rotation, reloaded
// from the table every RESEED pairs (so bin 480 gets the table's exact
// sin 0).

#pragma once

#include <cuda_runtime.h>

namespace rnnt {

constexpr int FS = 480;            // frame
constexpr int WS = 960;            // window / DFT length
constexpr int NBIN = 481;          // bins kept
constexpr int PBUF = 1728;         // pitch buffer
constexpr int MAX_START = PBUF - WS;   // largest pitch-window start
constexpr int MI = 241;            // inverse: bin pairs (2m, 2m+1), m < 241
constexpr int RESEED = 16;         // inverse: table reload period, in pairs
static_assert(240 % RESEED == 0, "bin 480 must take its twiddle from the table");

// Store the folded halves of one windowed spectrum input at sample n < 480,
// with a = w[n] v[n] and b = w[n+480] v[n+480]: u[n] = a + b, u[FS+n] = a - b.
__device__ __forceinline__ void fwd_fold(double* u, int n, double a, double b) {
  u[n] = a + b;
  u[FS + n] = a - b;
}

// Unscaled sums of bin k for NS spectra whose folded halves lie at
// u + i * 2 * FS (i < NS): re += u[n] cos(2 pi n k / 960), im += u[n] sin(..).
// tw holds (cos, sin)(2 pi m / 960) in f64.
template <int NS>
__device__ __forceinline__ void fwd_bin_sums(const double* u, int k,
                                             const double2* __restrict__ tw,
                                             double (&re)[NS], double (&im)[NS]) {
  const int par = k & 1;
#pragma unroll
  for (int i = 0; i < NS; ++i) { re[i] = 0.0; im[i] = 0.0; }
  // the twiddle of sample n by rotation with w = twiddle of sample 1
  const double2 w = tw[k];
  double cr = 1.0, ci = 0.0;
  for (int n = 0; n < FS; n += 2) {
    const double dr = fma(cr, w.x, -ci * w.y), di = fma(cr, w.y, ci * w.x);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const double2 v =
          *reinterpret_cast<const double2*>(u + (2 * i + par) * FS + n);
      re[i] = fma(v.x, cr, re[i]);
      im[i] = fma(v.x, ci, im[i]);
      re[i] = fma(v.y, dr, re[i]);
      im[i] = fma(v.y, di, im[i]);
    }
    cr = fma(dr, w.x, -di * w.y);
    ci = fma(dr, w.y, di * w.x);
  }
}

// Store bin k of a forward spectrum, scaled 1/960, into [962] re|im.
__device__ __forceinline__ void fwd_store(float* out, int k, double re, double im) {
  const double scale = 1.0 / WS;
  out[k] = (float)(re * scale);
  out[NBIN + k] = (float)(-im * scale);
}

// The twiddle table (cos, sin)(2 pi m / 960) rounded to f32, into shared
// memory, by all threads of the block.
__device__ __forceinline__ void load_twiddles_f32(float2* s_tw,
                                                  const double2* __restrict__ tw) {
  for (int i = threadIdx.x; i < WS; i += blockDim.x)
    s_tw[i] = make_float2((float)tw[i].x, (float)tw[i].y);
}

// Bin pair m of a conjugate-symmetric spectrum (re[k], im[k], k < 481) with
// the inverse's bin weights (1 at k = 0 and 480, 2 elsewhere):
// {w re[2m], w im[2m], w re[2m+1], w im[2m+1]}.
__device__ __forceinline__ float4 inv_pair(const float* re, const float* im, int m) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int ke = 2 * m, ko = 2 * m + 1;
  const float we = (ke == 0 || ke == NBIN - 1) ? 1.0f : 2.0f;
  v.x = we * re[ke];
  v.y = we * im[ke];
  if (ko < NBIN - 1) {                       // odd bins stop at 479
    v.z = 2.0f * re[ko];
    v.w = 2.0f * im[ko];
  }
  return v;
}

// Even- and odd-bin sums of output n < 480 for G spectra held as bin pairs
// in s_y[g][m]: output n is E + O, output n + 480 is E - O.
template <int G>
__device__ __forceinline__ void inv_sums(const float4 (*s_y)[MI], const float2* s_tw,
                                         int n, float (&e)[G], float (&o)[G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) { e[g] = 0.0f; o[g] = 0.0f; }
  // twiddles (cos, sin)(2 pi k n / 960) of bins k = 2m (ce) and 2m+1 (co):
  // ce steps by rotation with the twiddle of bin 2, co = ce times that of
  // bin 1
  const int step = (2 * n) % WS;
  const float2 t1 = s_tw[n], t2 = s_tw[step];
  int idx = 0;                                   // (2m * n) mod 960
  float2 ce = make_float2(1.0f, 0.0f);
  for (int m = 0; m < MI; ++m) {
    if (m % RESEED == 0) ce = s_tw[idx];
    const float2 co = make_float2(fmaf(ce.x, t1.x, -ce.y * t1.y),
                                  fmaf(ce.x, t1.y, ce.y * t1.x));
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4 v = s_y[g][m];
      e[g] = fmaf(v.x, ce.x, e[g]);
      e[g] = fmaf(-v.y, ce.y, e[g]);
      o[g] = fmaf(v.z, co.x, o[g]);
      o[g] = fmaf(-v.w, co.y, o[g]);
    }
    ce = make_float2(fmaf(ce.x, t2.x, -ce.y * t2.y),
                     fmaf(ce.x, t2.y, ce.y * t2.x));
    idx += step;
    if (idx >= WS) idx -= WS;
  }
}

}  // namespace rnnt
