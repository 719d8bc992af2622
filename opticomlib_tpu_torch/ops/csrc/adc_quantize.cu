// Uniform ADC quantiser for Hopper (sm_90a), in two modes.
//
// Replaces opticomlib_tpu/ops/pallas_kernels.py _adc_kernel (a (512, 128)
// block pass with lo/step/seed in SMEM and the TPU's PRNG for dithering).
//
// * adc_kernel_launch: the Pallas kernel's function (pk.adc_quantize):
//   q = (x - lo) / step, then half-up floor(q + 0.5) or stochastic
//   floor(q + u) with u from the top 24 bits of a random word, clip to
//   [0, levels - 1], y = lo + q * step.
// * adc_link_launch: the fused link's in-graph ADC (link._adc_quantize):
//   code = rint((v - lo) / (hi - lo) * nq), rounding half to even, with no
//   clip (the samples outside the 99.99 % range extrapolate), and
//   y = code / nq * (hi - lo) + lo.  lo and hi are read from device memory,
//   so the range estimate never comes back to the host.
//
// The two do not agree (tie rule, clip), so neither is folded into the
// other.  Every operation is an explicit round-to-nearest intrinsic in the
// plain PyTorch version's order (__fsub_rn, __fdiv_rn, __fmul_rn,
// __fadd_rn): nvcc would otherwise contract a*b+c into an FMA, and the
// output would differ from the plain version's in the last bit.
//
// Random words: Philox4x32-10 keyed by the seed, with the index of each
// group of four samples as the counter, so every sample of the array gets
// its own dither.  (The TPU kernel reseeds every grid step with the same
// seed, so there each 65,536-sample block repeats one dither pattern; this
// kernel does not copy that.)
//
// What bounds it on an H100: HBM bandwidth, 8 B a sample (read x, write y)
// against a division and a few flops.  The design is one grid-stride pass
// with 16-byte float4 loads and stores (four samples a thread an
// iteration); a ragged tail, or a pointer that is not 16-byte aligned,
// takes the scalar loop.  No shared memory, no cross-block traffic.
//
// Plain C interface, loaded with ctypes: each launcher returns the CUDA
// error of the launch (0 when it was accepted).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, Key k) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.k0 += W0;
      k.k1 += W1;
    }
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.k0, lo1, hi0 ^ c.w ^ k.k1, lo0);
  }
  return c;
}

__device__ __forceinline__ uint4 random_words(long long group, Key k) {
  return philox4x32_10(
      make_uint4((uint32_t)group, (uint32_t)((unsigned long long)group >> 32),
                 0u, 0u),
      k);
}

// uniform [0, 1) from the top 24 bits, as the TPU kernel draws it
__device__ __forceinline__ float unit24(uint32_t w) {
  return __fmul_rn((float)(w >> 8), 5.9604644775390625e-08f);  // 2^-24
}

__device__ __forceinline__ float q_kernel(float x, float lo, float step,
                                          float top, float u) {
  const float q = __fdiv_rn(__fsub_rn(x, lo), step);
  const float c = fminf(fmaxf(floorf(__fadd_rn(q, u)), 0.0f), top);
  return __fadd_rn(lo, __fmul_rn(c, step));
}

template <bool kStochastic>
__global__ void adc_kernel(const float* __restrict__ x, float* __restrict__ y,
                           long long n, float lo, float step, float top,
                           Key key, bool vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = vec ? n / 4 : 0;
  for (long long g = first; g < n4; g += stride) {
    const float4 v = reinterpret_cast<const float4*>(x)[g];
    float4 u = make_float4(0.5f, 0.5f, 0.5f, 0.5f);
    if (kStochastic) {
      const uint4 w = random_words(g, key);
      u = make_float4(unit24(w.x), unit24(w.y), unit24(w.z), unit24(w.w));
    }
    reinterpret_cast<float4*>(y)[g] = make_float4(
        q_kernel(v.x, lo, step, top, u.x), q_kernel(v.y, lo, step, top, u.y),
        q_kernel(v.z, lo, step, top, u.z), q_kernel(v.w, lo, step, top, u.w));
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) {
    float u = 0.5f;
    if (kStochastic) {
      const uint4 w = random_words(i / 4, key);
      const uint32_t word[4] = {w.x, w.y, w.z, w.w};
      u = unit24(word[i % 4]);
    }
    y[i] = q_kernel(x[i], lo, step, top, u);
  }
}

__device__ __forceinline__ float q_link(float v, float lo, float d, float nq) {
  const float code = rintf(__fmul_rn(__fdiv_rn(__fsub_rn(v, lo), d), nq));
  return __fadd_rn(__fmul_rn(__fdiv_rn(code, nq), d), lo);
}

__global__ void adc_link_kernel(const float* __restrict__ v,
                                float* __restrict__ y, long long n,
                                const float* __restrict__ lo_ptr,
                                const float* __restrict__ hi_ptr, float nq,
                                bool vec) {
  const float lo = *lo_ptr;
  const float d = __fsub_rn(*hi_ptr, lo);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = vec ? n / 4 : 0;
  for (long long g = first; g < n4; g += stride) {
    const float4 a = reinterpret_cast<const float4*>(v)[g];
    reinterpret_cast<float4*>(y)[g] =
        make_float4(q_link(a.x, lo, d, nq), q_link(a.y, lo, d, nq),
                    q_link(a.z, lo, d, nq), q_link(a.w, lo, d, nq));
  }
  for (long long i = 4 * n4 + first; i < n; i += stride)
    y[i] = q_link(v[i], lo, d, nq);
}

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15u) == 0;
}

cudaError_t grid_for(long long n, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // enough blocks to fill every SM several times over; each thread then
  // loops over a few float4 groups
  const long long want = (n / 4 + kThreads) / kThreads;
  const long long cap = 16LL * sms;
  *blocks = (int)(want < cap ? (want > 0 ? want : 1) : cap);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Kernel mode.  levels = 2^nbits; step is (hi - lo) / (levels - 1) rounded
// to float32 by the caller; stochastic != 0 dithers with Philox(seed).
int adc_kernel_launch(const float* x, float* y, long long n, float lo,
                      float step, int levels, int stochastic,
                      unsigned long long seed, void* stream_ptr) {
  if (n <= 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int blocks = 0;
  cudaError_t err = grid_for(n, &blocks);
  if (err != cudaSuccess) return (int)err;
  const Key key = {(uint32_t)seed, (uint32_t)(seed >> 32)};
  const float top = (float)(levels - 1);
  const bool vec = aligned16(x, y);
  if (stochastic)
    adc_kernel<true><<<blocks, kThreads, 0, stream>>>(x, y, n, lo, step, top,
                                                      key, vec);
  else
    adc_kernel<false><<<blocks, kThreads, 0, stream>>>(x, y, n, lo, step, top,
                                                       key, vec);
  return (int)cudaGetLastError();
}

// Link mode.  lo and hi are float32 scalars in device memory; nq = 2^bits-1.
int adc_link_launch(const float* v, float* y, long long n, const float* lo,
                    const float* hi, float nq, void* stream_ptr) {
  if (n <= 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int blocks = 0;
  cudaError_t err = grid_for(n, &blocks);
  if (err != cudaSuccess) return (int)err;
  adc_link_kernel<<<blocks, kThreads, 0, stream>>>(v, y, n, lo, hi, nq,
                                                   aligned16(v, y));
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
