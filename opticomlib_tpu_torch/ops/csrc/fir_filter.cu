// Causal FIR filter for Hopper (sm_90a): y[n] = sum_{j < taps} h[j] x[n-j],
// x[< 0] = 0, len(y) = len(x), float32 throughout.
//
// Replaces opticomlib_tpu/ops/pallas_kernels.py _fir_kernel (overlap-save
// blocks of 16,384 outputs whose windows x[i*B - (taps-1) : (i+1)*B] are
// double-buffered by DMA from HBM into VMEM, the taps in SMEM, the MAC loop
// unrolled over the taps).
//
// What bounds it on an H100: the multiply-adds, not HBM, once there are more
// than a few dozen taps.  A block of B outputs reads B + taps - 1 samples
// once and does B * taps FMAs: at the DAC's 783 gaussian taps that is about
// 200 FMAs a byte moved, far above the card's balance point (33.5 T FMA/s
// against 3.35 TB/s: 10 FMAs a byte).  So the inner loop has to take its
// operands from registers: an FMA whose window sample comes from shared
// memory runs at the shared-memory load rate, a quarter of the FP32 rate.
// At the DAC's 64 nrz taps the bound is HBM (8 B a sample), and what counts
// is that the copies of one block run under the multiply-adds of another.
//
// Design: register tiles, fed by double-buffered windows.
// * The outputs are cut into blocks of kBlock = kThreads * 8 = 1024.  A
//   block's window win[w] = x[base - tapsP + w] (tapsP = taps rounded up to
//   kT; zeros where it runs off either end of x) and the taps (zero-padded
//   to tapsP) sit in dynamic shared memory.
// * A thread computes kR = 8 consecutive outputs and walks the taps in
//   chunks of kT = 8.  For a chunk it holds the 16 window samples
//   win[p - 8 .. p + 7] (p = 8 * thread + tapsP - 8 * chunk) and the chunk's
//   8 taps in registers and does 64 FMAs; for the next chunk the lower 8
//   samples become the upper 8 and it loads 8 new samples and 8 taps: four
//   16-byte shared-memory loads for 64 FMAs.  The chunk loop is unrolled by
//   two with the two register halves swapping roles, so nothing is moved.
// * Each output is one float32 fmaf chain in tap order j = 0, 1, ...,
//   taps - 1 (chunks ascending, taps ascending inside a chunk; the last,
//   partial chunk stops at taps), so the result does not depend on kR, kT,
//   the block size or the grid.
// * Bank conflicts: the 8 threads of a quarter-warp load 16-byte groups 32
//   bytes apart, which would fall on 4 of the 8 bank groups, two ways each.
//   The window is stored with the two groups of every odd 128-byte line
//   pair-swapped (group g at g ^ ((g >> 3) & 1)), so those 8 loads cover
//   all 8 bank groups.  The taps are broadcast loads.
// * A thread's 8 outputs are 32 consecutive bytes and leave as two 16-byte
//   stores straight from its registers.
// * The grid is as many CTAs as the card holds at once (the occupancy
//   query times the SM count); a CTA stages the taps once and walks the
//   blocks blockIdx.x, + gridDim.x, ...  It keeps two windows: while it
//   multiplies block b it has the 16-byte cp.async copies of its next block
//   in flight into the other window (the TPU kernel's DMA double buffer; a
//   window that runs off x, or an x that is not 16-byte aligned, is filled
//   element by element instead).  On an H100 that took 64 taps from 0.082
//   to 0.076 ms and 783 taps from 0.62 to 0.59 ms; 128 threads a CTA ran as
//   fast as 256 or faster at every tap count from 16 to 8192.
// * A polyphase form that skips the zero-stuffed samples of an upsampled
//   input changes the caller's work, not this kernel.
//
// Shared memory: (2 * (kBlock + tapsP) + tapsP) floats; at kMaxTaps = 8192
// that is 106,496 bytes, above the 48 KB default, so the launcher raises the
// kernel's dynamic shared-memory limit when it must.
//
// Plain C interface, loaded with ctypes: fir_launch returns the CUDA error
// of the launch (0 when it was accepted).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMinCtas = 8;            // CTAs an SM, for the register budget
constexpr int kR = 8;                  // consecutive outputs per thread
constexpr int kT = 8;                  // taps per chunk
constexpr int kBlock = kThreads * kR;  // outputs per block
constexpr int kMaxTaps = 8192;         // FIR_MAX_TAPS in kernels.py
constexpr int kBuffers = 2;            // windows in shared memory
static_assert(kR == 8 && kT == 8, "the register tile is written for 8 x 8");

// where 16-byte group g of the window lives (see "Bank conflicts" above)
__device__ __forceinline__ int swz4(int g) { return g ^ ((g >> 3) & 1); }
// the same for a float index
__device__ __forceinline__ int swz1(int w) { return w ^ (((w >> 5) & 1) << 2); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage the window of the block at base: win[w] = x[base - tapsP + w], zero
// outside [0, n).  A window that lies inside an aligned x goes by 16-byte
// cp.async copies (complete after cp_async_wait_all and a barrier); a ragged
// one element by element.
__device__ __forceinline__ void stage_window(float* win,
                                             const float* __restrict__ x,
                                             long long n, long long base,
                                             int tapsP, bool x16) {
  const int wlen = kBlock + tapsP;
  const long long first = base - tapsP;  // x index of win[0]
  if (x16 && first >= 0 && base + kBlock <= n) {
    // first is a multiple of 8 (kBlock and tapsP are)
    const float4* src = reinterpret_cast<const float4*>(x + first);
    float4* win4 = reinterpret_cast<float4*>(win);
    for (int g = threadIdx.x; g < wlen / 4; g += kThreads)
      cp_async16(win4 + swz4(g), src + g);
  } else {
    for (int w = threadIdx.x; w < wlen; w += kThreads) {
      const long long i = first + w;
      win[swz1(w)] = (i >= 0 && i < n) ? x[i] : 0.0f;
    }
  }
}

// groups g and g + 1 (g even) of the window into v[0..7]
__device__ __forceinline__ void load8(const float4* win4, int g, float* v) {
  const float4 a = win4[swz4(g)], b = win4[swz4(g + 1)];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// One chunk: its taps hc4[0..1] (the first ntap of them when kPartial),
// window samples lo = win[p-8 .. p-1] and hi = win[p .. p+7]; output r and
// tap jj meet at win[p + r - jj].
template <bool kPartial>
__device__ __forceinline__ void mac_chunk(float* acc, const float* hi,
                                          const float* lo, const float4* hc4,
                                          int ntap) {
  const float4 h0 = hc4[0], h1 = hc4[1];  // broadcast loads
  const float hc[kT] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
  for (int jj = 0; jj < kT; ++jj) {
    if (kPartial && jj >= ntap) break;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float xs = (r - jj >= 0) ? hi[r - jj] : lo[kT + r - jj];
      acc[r] = fmaf(hc[jj], xs, acc[r]);
    }
  }
}

// The block at base from its staged window and the staged taps: this
// thread's 8 outputs y[base + 8 t .. + 7], each one fmaf chain in tap order,
// stored as two 16-byte vectors (element by element at the ragged end).
__device__ __forceinline__ void block_outputs(const float4* win4,
                                              const float4* hs4,
                                              float* __restrict__ y,
                                              long long n, long long base,
                                              int taps, int tapsP, bool y16) {
  float acc[kR], wa[kT], wb[kT];
#pragma unroll
  for (int r = 0; r < kR; ++r) acc[r] = 0.0f;
  // group of win[p] at chunk 0; it falls by 2 a chunk and stays even
  int g = 2 * threadIdx.x + tapsP / 4;
  load8(win4, g, wa);
  const int nfull = taps / kT, rem = taps % kT;  // hs4: 2 vectors a chunk
  int c = 0;
  for (; c + 2 <= nfull; c += 2) {
    g -= 2;
    load8(win4, g, wb);
    mac_chunk<false>(acc, wa, wb, hs4 + 2 * c, kT);
    g -= 2;
    load8(win4, g, wa);
    mac_chunk<false>(acc, wb, wa, hs4 + 2 * c + 2, kT);
  }
  if (c < nfull) {
    g -= 2;
    load8(win4, g, wb);
    mac_chunk<false>(acc, wa, wb, hs4 + 2 * c, kT);
#pragma unroll
    for (int k = 0; k < kT; ++k) wa[k] = wb[k];
    ++c;
  }
  if (rem) {
    g -= 2;
    load8(win4, g, wb);
    mac_chunk<true>(acc, wa, wb, hs4 + 2 * c, rem);
  }
  const long long o0 = base + kR * threadIdx.x;
  if (y16 && o0 + kR <= n) {
    float4* dst = reinterpret_cast<float4*>(y + o0);
    dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  } else {
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (o0 + r < n) y[o0 + r] = acc[r];
  }
}

// Shared memory: kBuffers windows of kBlock + tapsP floats, then tapsP taps.
// Each CTA walks the blocks blockIdx.x, blockIdx.x + gridDim.x, ...; the
// next block's copies are in flight while this block's multiply-adds run.
__global__ void __launch_bounds__(kThreads, kMinCtas)
    fir_kernel(const float* __restrict__ x, const float* __restrict__ h,
               float* __restrict__ y, long long n, int taps,
               long long blocks) {
  extern __shared__ float4 smem4[];
  const int tapsP = (taps + kT - 1) / kT * kT;
  const int wlen = kBlock + tapsP;  // a multiple of 8 floats
  float* win = reinterpret_cast<float*>(smem4);
  float* hs = win + kBuffers * wlen;  // tapsP taps, zero padded
  const float4* hs4 = reinterpret_cast<const float4*>(hs);
  const bool x16 = (reinterpret_cast<std::uintptr_t>(x) & 15u) == 0;
  const bool y16 = (reinterpret_cast<std::uintptr_t>(y) & 15u) == 0;

  for (int j = threadIdx.x; j < tapsP; j += kThreads)
    hs[j] = j < taps ? h[j] : 0.0f;
  long long b = blockIdx.x;
  stage_window(win, x, n, b * kBlock, tapsP, x16);
  cp_async_wait_all();
  __syncthreads();
  int cur = 0;
  for (; b < blocks; b += gridDim.x) {
    const long long next = b + gridDim.x;
    if (next < blocks)
      stage_window(win + (cur ^ 1) * wlen, x, n, next * kBlock, tapsP, x16);
    block_outputs(reinterpret_cast<const float4*>(win + cur * wlen), hs4, y,
                  n, b * kBlock, taps, tapsP, y16);
    if (next < blocks) {
      // the next window is whole, and everyone has read this one before
      // the block after next is staged into it
      cp_async_wait_all();
      __syncthreads();
      cur ^= 1;
    }
  }
}

}  // namespace

extern "C" {

// x, y: n float32 samples; h: taps float32 taps, 1 <= taps <= kMaxTaps.
int fir_launch(const float* x, const float* h, float* y, long long n,
               int taps, void* stream_ptr) {
  if (n <= 0) return 0;
  if (taps < 1 || taps > kMaxTaps) return (int)cudaErrorInvalidValue;
  const int tapsP = (taps + kT - 1) / kT * kT;
  const int shmem =
      (int)sizeof(float) * (kBuffers * (kBlock + tapsP) + tapsP);
  cudaError_t err;
  if (shmem > 48 * 1024) {
    // per device, so set on every launch that needs it (a host call)
    err = cudaFuncSetAttribute(
        fir_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shmem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (n + kBlock - 1) / kBlock;
  // as many CTAs as the card holds at once, each walking its share of blocks
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fir_kernel, kThreads, shmem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const long long resident = (long long)sms * per_sm;
  const unsigned grid = (unsigned)(blocks < resident ? blocks : resident);
  fir_kernel<<<grid, kThreads, shmem, static_cast<cudaStream_t>(stream_ptr)>>>(
      x, h, y, n, taps, blocks);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
