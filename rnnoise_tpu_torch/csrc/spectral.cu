// Forward and inverse 960-point real spectra for a batch of streams, on
// Hopper (sm_90a).
//
// rnnt_forward_spectral replaces the TPU kernel
// rnnoise_tpu/dsp/pallas_spectral.py:forward_spectral (_fwd_kernel with
// _take_window_vmem and _dif_forward): X is the DFT of the Vorbis-windowed
// [analysis_mem | x], P the DFT of the windowed pitch_buf[start : start+960]
// (the window is gathered here, per stream), both scaled by 1/960 and stored
// as [S, 962] re|im in natural bin order.
//
// rnnt_inverse_spectral replaces pallas_spectral.py:inverse_spectral
// (_inv_kernel -> _dif_inverse): the unscaled inverse DFT of a conjugate-
// symmetric [S, 962] re|im spectrum (bin weights 1 at k = 0 and 480, 2
// elsewhere), times the synthesis window -> [S, 960].
//
// What bounds them: a direct DFT is 481 x 960 multiply-adds per spectrum,
// against 15-19 KB of input and output per stream, so the issue rate bounds
// them, not device memory.  Twiddles indexed by (n*k) mod 960 would hit
// shared-memory banks unevenly, so both kernels make them by rotation in
// registers instead.  The design halves the work with the (-1)^k symmetry of
// samples n and n+480 (even bins see v[n]+v[n+480], odd bins v[n]-v[n+480];
// the inverse gets outputs n and n+480 from one pass as E+O and E-O), and
// lets one twiddle serve 4 streams (x 2 spectra forward).
//
// The forward spectra feed the pitch, band-energy and silence decisions,
// which sit on knife edges: a 2e-6 difference in X flips an int8 activation
// now and then, and the flip shows as a transient of a few LSB two frames
// long.  So the forward kernel windows, folds and sums in f64 and rounds each
// bin once to f32, as its plain version (an f64 DFT matmul) does; the two
// then agree to an ulp.  Its f64 rotation drifts less than 1e-13 over 480
// steps.  The inverse only shapes the output, so it rotates and sums in f32
// with FMA, reloading from the table every 16 steps, and agrees with its
// plain version (an f32 DFT matmul) to ~2e-6 of each row's largest magnitude.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FS = 480;            // frame
constexpr int WS = 960;            // window / DFT length
constexpr int NBIN = 481;          // bins kept
constexpr int PBUF = 1728;         // pitch buffer
constexpr int GF = 4;              // streams per block, forward
constexpr int GI = 4;              // streams per block, inverse
constexpr int FWD_THREADS = 512;   // 256 even bins | 256 odd bins
constexpr int INV_THREADS = FS;    // one pair of outputs (n, n+480) each
constexpr int MI = 241;            // bin pairs (2m, 2m+1), m < 241
constexpr int RESEED = 16;         // inverse: table reload period, in pairs
static_assert(240 % RESEED == 0, "bin 480 must take its twiddle from the table");

// dynamic shared memory of the forward kernel:
// [spectrum][stream][parity][n] with parity 0 = v[n]+v[n+480], 1 = v[n]-v[n+480]
constexpr size_t FWD_SMEM = sizeof(double) * 2 * GF * 2 * FS;

__global__ void __launch_bounds__(FWD_THREADS)
forward_kernel(const float* __restrict__ mem, const float* __restrict__ x,
               const float* __restrict__ pbuf, const int* __restrict__ start,
               const float* __restrict__ window,
               const double2* __restrict__ tw, float* __restrict__ X,
               float* __restrict__ P, int S) {
  extern __shared__ __align__(16) double s_u[];
  auto u_at = [&](int sp, int g, int par) {
    return s_u + ((sp * GF + g) * 2 + par) * FS;
  };
  const int tid = threadIdx.x, s0 = blockIdx.x * GF;
  for (int i = tid; i < GF * FS; i += blockDim.x) {
    int g = i / FS, n = i - g * FS, s = s0 + g;
    double a = 0.0, b = 0.0, pa = 0.0, pb = 0.0;
    if (s < S) {
      double w0 = window[n], w1 = window[n + FS];
      a = w0 * mem[(size_t)s * FS + n];
      b = w1 * x[(size_t)s * FS + n];
      int st = min(max(start[s], 0), PBUF - WS);
      const float* p = pbuf + (size_t)s * PBUF + st;
      pa = w0 * p[n];
      pb = w1 * p[n + FS];
    }
    u_at(0, g, 0)[n] = a + b;
    u_at(0, g, 1)[n] = a - b;
    u_at(1, g, 0)[n] = pa + pb;
    u_at(1, g, 1)[n] = pa - pb;
  }
  __syncthreads();

  const int par = tid >= FWD_THREADS / 2;
  const int k = 2 * (tid & (FWD_THREADS / 2 - 1)) + par;
  if (k >= NBIN) return;
  double re[2][GF], im[2][GF];
#pragma unroll
  for (int sp = 0; sp < 2; ++sp)
#pragma unroll
    for (int g = 0; g < GF; ++g) { re[sp][g] = 0.0; im[sp][g] = 0.0; }
  // the twiddle of sample n, (cos, sin)(2 pi n k / 960), by rotation with
  // w = twiddle of sample 1: f64 keeps its drift over 480 steps below 1e-13
  const double2 w = tw[k];
  double cr = 1.0, ci = 0.0;
  for (int n = 0; n < FS; n += 2) {
    const double dr = fma(cr, w.x, -ci * w.y), di = fma(cr, w.y, ci * w.x);
#pragma unroll
    for (int sp = 0; sp < 2; ++sp)
#pragma unroll
      for (int g = 0; g < GF; ++g) {
        double2 u = *reinterpret_cast<const double2*>(u_at(sp, g, par) + n);
        re[sp][g] = fma(u.x, cr, re[sp][g]);
        im[sp][g] = fma(u.x, ci, im[sp][g]);
        re[sp][g] = fma(u.y, dr, re[sp][g]);
        im[sp][g] = fma(u.y, di, im[sp][g]);
      }
    cr = fma(dr, w.x, -di * w.y);
    ci = fma(dr, w.y, di * w.x);
  }
  const double scale = 1.0 / WS;
#pragma unroll
  for (int g = 0; g < GF; ++g) {
    int s = s0 + g;
    if (s >= S) break;
    float* xo = X + (size_t)s * 2 * NBIN;
    float* po = P + (size_t)s * 2 * NBIN;
    xo[k] = (float)(re[0][g] * scale);
    xo[NBIN + k] = (float)(-im[0][g] * scale);
    po[k] = (float)(re[1][g] * scale);
    po[NBIN + k] = (float)(-im[1][g] * scale);
  }
}

__global__ void __launch_bounds__(INV_THREADS)
inverse_kernel(const float* __restrict__ Y, const float* __restrict__ window,
               const double2* __restrict__ tw, float* __restrict__ out, int S) {
  __shared__ float2 s_tw[WS];
  // per stream and bin pair m: {w*re[2m], w*im[2m], w*re[2m+1], w*im[2m+1]}
  __shared__ float4 s_y[GI][MI];
  const int tid = threadIdx.x, s0 = blockIdx.x * GI;
  for (int i = tid; i < WS; i += blockDim.x)
    s_tw[i] = make_float2((float)tw[i].x, (float)tw[i].y);
  for (int i = tid; i < GI * MI; i += blockDim.x) {
    int g = i / MI, m = i - g * MI, s = s0 + g;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (s < S) {
      const float* y = Y + (size_t)s * 2 * NBIN;
      int ke = 2 * m, ko = 2 * m + 1;
      float we = (ke == 0 || ke == NBIN - 1) ? 1.0f : 2.0f;
      v.x = we * y[ke];
      v.y = we * y[NBIN + ke];
      if (ko < NBIN - 1) {                       // odd bins stop at 479
        v.z = 2.0f * y[ko];
        v.w = 2.0f * y[NBIN + ko];
      }
    }
    s_y[g][m] = v;
  }
  __syncthreads();

  const int n = tid;
  if (n >= FS) return;
  float e[GI], o[GI];
#pragma unroll
  for (int g = 0; g < GI; ++g) { e[g] = 0.0f; o[g] = 0.0f; }
  // twiddles (cos, sin)(2 pi k n / 960) of bins k = 2m (ce) and 2m+1 (co):
  // ce steps by rotation with the twiddle of bin 2, co = ce times that of
  // bin 1; ce is reloaded from the table every RESEED bin pairs, which
  // bounds the f32 rotation's drift and gives bin 480 (m = 240) the table's
  // exact sin = 0
  const int step = (2 * n) % WS;
  const float2 t1 = s_tw[n], t2 = s_tw[step];
  int idx = 0;                                   // (2m * n) mod 960
  float2 ce = make_float2(1.0f, 0.0f);
  for (int m = 0; m < MI; ++m) {
    if (m % RESEED == 0) ce = s_tw[idx];
    const float2 co = make_float2(fmaf(ce.x, t1.x, -ce.y * t1.y),
                                  fmaf(ce.x, t1.y, ce.y * t1.x));
#pragma unroll
    for (int g = 0; g < GI; ++g) {
      float4 v = s_y[g][m];
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
  const float w0 = window[n], w1 = window[n + FS];
#pragma unroll
  for (int g = 0; g < GI; ++g) {
    int s = s0 + g;
    if (s >= S) break;
    out[(size_t)s * WS + n] = w0 * (e[g] + o[g]);
    out[(size_t)s * WS + n + FS] = w1 * (e[g] - o[g]);
  }
}

}  // namespace

extern "C" {

// mem, x [S, 480]; pitch_buf [S, 1728]; start [S] int32 (clamped to
// [0, 768]); window [960]; twiddles [960] f64 (cos, sin of 2 pi m / 960);
// X, P [S, 962].  Returns the CUDA error code of the launch.
int rnnt_forward_spectral(const float* mem, const float* x,
                          const float* pitch_buf, const int* start,
                          const float* window, const double* twiddles,
                          float* X, float* P, int S, void* stream) {
  if (S <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  forward_kernel<<<(S + GF - 1) / GF, FWD_THREADS, FWD_SMEM,
                   (cudaStream_t)stream>>>(
      mem, x, pitch_buf, start, window,
      reinterpret_cast<const double2*>(twiddles), X, P, S);
  return (int)cudaGetLastError();
}

// Y [S, 962] re|im; window [960]; twiddles [960] f64; out [S, 960].
int rnnt_inverse_spectral(const float* Y, const float* window,
                          const double* twiddles, float* out, int S,
                          void* stream) {
  if (S <= 0) return 0;
  inverse_kernel<<<(S + GI - 1) / GI, INV_THREADS, 0, (cudaStream_t)stream>>>(
      Y, window, reinterpret_cast<const double2*>(twiddles), out, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
