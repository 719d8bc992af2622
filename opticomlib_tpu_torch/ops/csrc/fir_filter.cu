// Causal FIR filter for Hopper (sm_90a): y[n] = sum_{j < taps} h[j] x[n-j],
// x[< 0] = 0, len(y) = len(x), float32 throughout.
//
// Replaces opticomlib_tpu/ops/pallas_kernels.py _fir_kernel (overlap-save
// blocks of 16,384 outputs whose windows x[i*B - (taps-1) : (i+1)*B] are
// double-buffered by DMA from HBM into VMEM, the taps in SMEM, the MAC loop
// unrolled over the taps).
//
// What bounds it on an H100: the multiply-adds, not HBM.  A block of B
// outputs reads B + taps - 1 samples once and does B * taps FMAs: at the
// DAC's 783 gaussian taps that is about 700 FMAs a byte of x, far above
// the card's balance point, so the inner loop is what counts.  Each FMA
// takes one operand from shared memory (the window sample) and one
// broadcast tap, so shared-memory bandwidth, not the FP32 pipes, is the
// ceiling of this design.
//
// Design (simple first): one CTA per block of kBlock outputs.  The CTA
// stages its window (zeros where it runs off either end of x) and all the
// taps in dynamic shared memory, then each of its kThreads threads
// accumulates kPerThread outputs strided by kThreads, so the 32 lanes of a
// warp read 32 consecutive window samples (no bank conflicts) and one
// broadcast tap per step.  Each output is a float32 fmaf chain in tap
// order j = 0, 1, ..., taps - 1.  cp.async/TMA double buffering (the TPU
// kernel's DMA pattern), register sliding windows and a polyphase form that
// skips the zero-stuffed samples of an upsampled input are later work.
//
// Shared memory: (kBlock + taps - 1 + taps) floats; at kMaxTaps = 8192 that
// is 73,724 bytes, above the 48 KB default, so the launcher raises the
// kernel's dynamic shared-memory limit once.
//
// Plain C interface, loaded with ctypes: fir_launch returns the CUDA error
// of the launch (0 when it was accepted).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kBlock = kThreads * kPerThread;  // outputs per CTA
constexpr int kMaxTaps = 8192;                 // FIR_MAX_TAPS in kernels.py

__global__ void __launch_bounds__(kThreads)
    fir_kernel(const float* __restrict__ x, const float* __restrict__ h,
               float* __restrict__ y, long long n, int taps) {
  extern __shared__ float smem[];
  float* hs = smem;           // taps
  float* win = smem + taps;   // kBlock + taps - 1 window samples
  const long long base = (long long)blockIdx.x * kBlock;
  const int halo = taps - 1;
  const int wlen = kBlock + halo;

  for (int j = threadIdx.x; j < taps; j += kThreads) hs[j] = h[j];
  // win[w] = x[base - halo + w], zero outside [0, n)
  for (int w = threadIdx.x; w < wlen; w += kThreads) {
    const long long g = base - halo + w;
    win[w] = (g >= 0 && g < n) ? x[g] : 0.0f;
  }
  __syncthreads();

  float acc[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) acc[r] = 0.0f;
  // output base + t + r*kThreads reads win[t + r*kThreads + halo - j]
  const float* xs = win + threadIdx.x + halo;
#pragma unroll 4
  for (int j = 0; j < taps; ++j) {
    const float hj = hs[j];
#pragma unroll
    for (int r = 0; r < kPerThread; ++r)
      acc[r] = fmaf(hj, xs[r * kThreads - j], acc[r]);
  }
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const long long i = base + threadIdx.x + r * kThreads;
    if (i < n) y[i] = acc[r];
  }
}

}  // namespace

extern "C" {

// x, y: n float32 samples; h: taps float32 taps, 1 <= taps <= kMaxTaps.
int fir_launch(const float* x, const float* h, float* y, long long n,
               int taps, void* stream_ptr) {
  if (n <= 0) return 0;
  if (taps < 1 || taps > kMaxTaps) return (int)cudaErrorInvalidValue;
  const int shmem = (int)sizeof(float) * (kBlock + 2 * taps - 1);
  if (shmem > 48 * 1024) {
    // per device, so set on every launch that needs it (a host call)
    const cudaError_t err = cudaFuncSetAttribute(
        fir_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shmem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (n + kBlock - 1) / kBlock;
  fir_kernel<<<(unsigned)blocks, kThreads, shmem,
               static_cast<cudaStream_t>(stream_ptr)>>>(x, h, y, n, taps);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
