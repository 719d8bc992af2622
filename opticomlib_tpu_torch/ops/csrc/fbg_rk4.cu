// Coupled-mode RK4 of the fiber Bragg grating for Hopper (sm_90a): for every
// frequency bin, integrate
//
//   R' =  i (shat R + kk S),   S' = -i (shat S + kk R),
//   shat = delta + s p(z) - F z,   kk = k p(z),
//
// from z = +1/2 to z = -1/2 in n_steps fixed RK4 steps of dz = -1/n_steps,
// from R = 1, S = 0.  The reflection response of the grating is S/R.
//
// Replaces opticomlib_tpu/devices.py _fbg_rk4 (a jax.lax.scan over the steps,
// every bin advancing in lockstep), not a Pallas kernel.
//
// What bounds it on an H100: operations.  A bin reads three floats and
// writes two complex64 values (28 B) but does 108 float32 operations a step
// at the least (three detunings d + s p - Fz of 3 and couplings k p of 1,
// four derivatives of 12, three stage states of 8 and the update of 6 for
// each of the four floats of R and S), so at 512 steps a bin is 55,000
// operations against 28 B.
//
// Design:
// * One thread a bin; R and S (four floats) stay in registers for the whole
//   integration, so device memory is touched once per bin at either end.
//   delta, s and k are real (the JAX package casts real arrays to complex64
//   with zero imaginary parts), so shat and kk are real floats and each
//   complex product with them is two real products.
// * The step grid is the same for every bin: the apodization p at the three
//   RK4 stage positions (p0 at z, p1 at z + dz/2, p2 at z + dz) and the
//   chirp terms F z, F (z + dz/2), F (z + dz) (fa, fb, fc), made once by
//   the caller, so a bin spends no operation on them.  A CTA stages the six
//   arrays into shared memory kTile steps at a time (24 KB), since at the
//   200,000-step cap they do not fit whole; every warp then reads one
//   address at a time (a broadcast).
// * The constants are the JAX package's float32 values: dz, dz/2 and dz/6
//   computed in float64 and rounded once, the chirp terms rounded as the
//   JAX package rounds them, shat in the order delta + s p - F z.  The
//   compiler may contract a product and a sum into one fma, and the update
//   sums k1 + 2 (k2 + k3) + k4 where the JAX package sums k1 + 2 k2 + 2 k3
//   + k4, so the kernel agrees with the plain version to rounding, not bit
//   for bit.
//
// Plain C interface, loaded with ctypes: fbg_rk4_launch returns the CUDA
// error of the launch (0 when it was accepted).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // steps of the grid staged at a time

// (dR, dS) = (i a, -i b), a = shat R + kk S, b = shat S + kk R
__device__ __forceinline__ void deriv(float shat, float kk, float Rr,
                                      float Ri, float Sr, float Si,
                                      float& dRr, float& dRi, float& dSr,
                                      float& dSi) {
  const float ar = shat * Rr + kk * Sr;
  const float ai = shat * Ri + kk * Si;
  const float br = shat * Sr + kk * Rr;
  const float bi = shat * Si + kk * Ri;
  dRr = -ai;
  dRi = ar;
  dSr = bi;
  dSi = -br;
}

__global__ void __launch_bounds__(kThreads)
    fbg_rk4_kernel(const float* __restrict__ delta,
                   const float* __restrict__ s, const float* __restrict__ k,
                   const float* __restrict__ p0,
                   const float* __restrict__ p1,
                   const float* __restrict__ p2,
                   const float* __restrict__ fa,
                   const float* __restrict__ fb,
                   const float* __restrict__ fc, int n_steps, float dz,
                   float dz2, float dz6, float2* __restrict__ R,
                   float2* __restrict__ S, long long n) {
  __shared__ float sp0[kTile], sp1[kTile], sp2[kTile];
  __shared__ float sfa[kTile], sfb[kTile], sfc[kTile];
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  const float d = live ? delta[i] : 0.f;
  const float sv = live ? s[i] : 0.f;
  const float kv = live ? k[i] : 0.f;
  float Rr = 1.f, Ri = 0.f, Sr = 0.f, Si = 0.f;
  for (int base = 0; base < n_steps; base += kTile) {
    const int m = min(kTile, n_steps - base);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < m; j += kThreads) {
      sp0[j] = p0[base + j];
      sp1[j] = p1[base + j];
      sp2[j] = p2[base + j];
      sfa[j] = fa[base + j];
      sfb[j] = fb[base + j];
      sfc[j] = fc[base + j];
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll 2
    for (int j = 0; j < m; ++j) {
      const float pa = sp0[j], pb = sp1[j], pc = sp2[j];
      const float sh_a = d + sv * pa - sfa[j];
      const float sh_b = d + sv * pb - sfb[j];
      const float sh_c = d + sv * pc - sfc[j];
      const float kk_a = kv * pa, kk_b = kv * pb, kk_c = kv * pc;
      float k1Rr, k1Ri, k1Sr, k1Si;
      deriv(sh_a, kk_a, Rr, Ri, Sr, Si, k1Rr, k1Ri, k1Sr, k1Si);
      float k2Rr, k2Ri, k2Sr, k2Si;
      deriv(sh_b, kk_b, Rr + dz2 * k1Rr, Ri + dz2 * k1Ri, Sr + dz2 * k1Sr,
            Si + dz2 * k1Si, k2Rr, k2Ri, k2Sr, k2Si);
      float k3Rr, k3Ri, k3Sr, k3Si;
      deriv(sh_b, kk_b, Rr + dz2 * k2Rr, Ri + dz2 * k2Ri, Sr + dz2 * k2Sr,
            Si + dz2 * k2Si, k3Rr, k3Ri, k3Sr, k3Si);
      float k4Rr, k4Ri, k4Sr, k4Si;
      deriv(sh_c, kk_c, Rr + dz * k3Rr, Ri + dz * k3Ri, Sr + dz * k3Sr,
            Si + dz * k3Si, k4Rr, k4Ri, k4Sr, k4Si);
      Rr = Rr + dz6 * (k1Rr + 2.f * (k2Rr + k3Rr) + k4Rr);
      Ri = Ri + dz6 * (k1Ri + 2.f * (k2Ri + k3Ri) + k4Ri);
      Sr = Sr + dz6 * (k1Sr + 2.f * (k2Sr + k3Sr) + k4Sr);
      Si = Si + dz6 * (k1Si + 2.f * (k2Si + k3Si) + k4Si);
    }
  }
  if (live) {
    R[i] = make_float2(Rr, Ri);
    S[i] = make_float2(Sr, Si);
  }
}

}  // namespace

extern "C" {

// delta, s, k: n float32; p0, p1, p2, fa, fb, fc: n_steps float32; R, S: n
// complex64 (interleaved float32 re, im).  All contiguous, on the current
// device.
int fbg_rk4_launch(const void* delta, const void* s, const void* k,
                   const void* p0, const void* p1, const void* p2,
                   const void* fa, const void* fb, const void* fc,
                   int n_steps, float dz, float dz2,
                   float dz6, void* R, void* S, long long n,
                   void* stream_ptr) {
  if (n <= 0) return 0;
  if (n_steps < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fbg_rk4_kernel<<<(unsigned)blocks, kThreads, 0,
                   static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float*>(delta), static_cast<const float*>(s),
      static_cast<const float*>(k), static_cast<const float*>(p0),
      static_cast<const float*>(p1), static_cast<const float*>(p2),
      static_cast<const float*>(fa), static_cast<const float*>(fb),
      static_cast<const float*>(fc), n_steps, dz, dz2, dz6,
      static_cast<float2*>(R), static_cast<float2*>(S), n);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
