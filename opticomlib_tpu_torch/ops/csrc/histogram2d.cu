// 2-D histogram of integer bin-index pairs, for Hopper (sm_90a).
//
// Replaces opticomlib_tpu/ops/pallas_kernels.py _hist_kernel (a one-hot
// matrix product on the TPU's matrix unit).  On the link's main path it is
// the nt = 1 case: the receiver's KDE histogram of 2^20 eye samples into
// 4096 bins (ops/eyeana.py _kde_min_threshold).
//
// What bounds it on an H100: reading the indices (8 B a sample) and, where
// samples crowd into few bins, atomic contention.  The design keeps the
// contended updates on chip: each block holds a private u32 histogram in
// shared memory (16 KiB for 4096 bins), fills it with shared-memory
// atomicAdd over a grid-stride loop, and flushes it with one global
// atomicAdd per nonzero bin.  The grid is a few blocks per SM, so the
// flush traffic stays small against the sample stream.  A histogram too
// large for shared memory is counted with global atomics in the same
// launch sequence.  Counts are exact (u32), converted to float32 at the end.
//
// Plain C interface, loaded with ctypes: histogram2d_launch returns the
// first CUDA error (0 when every call was accepted).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void hist_shared(const int* __restrict__ t,
                            const int* __restrict__ y, long long n, int nt,
                            int ny, unsigned int* __restrict__ counts) {
  extern __shared__ unsigned int local[];
  const int nbins = nt * ny;
  for (int b = threadIdx.x; b < nbins; b += blockDim.x) local[b] = 0u;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += stride) {
    const int ti = t[k];
    const int yi = y[k];
    if ((unsigned)ti < (unsigned)nt && (unsigned)yi < (unsigned)ny)
      atomicAdd(&local[ti * ny + yi], 1u);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nbins; b += blockDim.x) {
    const unsigned int c = local[b];
    if (c) atomicAdd(&counts[b], c);
  }
}

__global__ void hist_global(const int* __restrict__ t,
                            const int* __restrict__ y, long long n, int nt,
                            int ny, unsigned int* __restrict__ counts) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += stride) {
    const int ti = t[k];
    const int yi = y[k];
    if ((unsigned)ti < (unsigned)nt && (unsigned)yi < (unsigned)ny)
      atomicAdd(&counts[(long long)ti * ny + yi], 1u);
  }
}

__global__ void u32_to_f32(const unsigned int* __restrict__ in,
                           float* __restrict__ out, long long m) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < m;
       k += stride)
    out[k] = (float)in[k];
}

long long min_ll(long long a, long long b) { return a < b ? a : b; }

}  // namespace

extern "C" {

// counts: nt*ny u32 scratch; out: nt*ny float32 result.  Both are written
// on `stream`; nothing is allocated and nothing synchronises.
int histogram2d_launch(const int* t, const int* y, long long n, int nt,
                       int ny, unsigned int* counts, float* out,
                       void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long nbins = (long long)nt * ny;
  cudaError_t err = cudaMemsetAsync(counts, 0, nbins * sizeof(unsigned int),
                                    stream);
  if (err != cudaSuccess) return (int)err;

  int dev = 0, sms = 0, smem_optin = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaDeviceGetAttribute(
           &smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return (int)err;

  if (n > 0) {
    const size_t smem = (size_t)nbins * sizeof(unsigned int);
    const long long want = (n + kThreads - 1) / kThreads;
    if (smem <= (size_t)smem_optin) {
      if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(hist_shared,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
      }
      // two blocks per SM: enough to stream the indices, few enough that
      // zeroing and flushing the private histograms stays cheap
      const int blocks = (int)min_ll(want, 2LL * sms);
      hist_shared<<<blocks, kThreads, smem, stream>>>(t, y, n, nt, ny,
                                                      counts);
    } else {
      const int blocks = (int)min_ll(want, 8LL * sms);
      hist_global<<<blocks, kThreads, 0, stream>>>(t, y, n, nt, ny, counts);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }

  const int cblocks = (int)min_ll((nbins + kThreads - 1) / kThreads, 8LL * sms);
  u32_to_f32<<<cblocks, kThreads, 0, stream>>>(counts, out, nbins);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
