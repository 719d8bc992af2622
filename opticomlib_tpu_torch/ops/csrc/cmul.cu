// Complex product for Hopper (sm_90a): C = A * B on complex64 (interleaved
// float32 re, im), B of A's shape or one row broadcast over A's rows.
//
// Replaces opticomlib_tpu/ops/pallas_kernels.py _cmul_kernel (the planar
// complex multiply of the split-step solver: the spectral factor after the
// FFT and the rotation after the IFFT).
//
// What bounds it on an H100: bytes.  A sample costs 16 B read and 8 B
// written against six flops, so the only thing to design is the memory
// traffic: how wide each access is, how many are in flight and how often a
// byte crosses HBM.
//
// Design:
// * A, B and C are read and written as 16-byte vectors (a float4 is two
//   samples), neighbouring threads on neighbouring vectors.  A CTA of
//   kThreads threads owns a tile of kTile = kThreads * kVec vectors of the
//   row; a thread starts its kVec loads of B and its kVec loads of A before
//   the first multiply, so a CTA keeps 2 * 16 KB of loads in flight and an
//   SM several CTAs of them.  On an H100 every tile from 512 x 1 to 256 x 8
//   ran within 1 % of the others; 256 x 4 stays.
// * Rows innermost: a thread holds its vectors of a broadcast B in
//   registers and uses them for every row of A before it moves on (the next
//   row's A is loaded before the current row is multiplied and stored), so
//   the broadcast factor crosses HBM once whatever the number of rows.  A
//   same-shape product is one long row and takes the same kernel without
//   the third buffer.
// * Plain loads and stores.  Every byte is touched once, so streaming
//   accesses (ld.global.cs / st.global.cs: evict first) would leave L2 to
//   the transforms around the call; but at the solver's sizes no operand
//   fits the 50 MB L2 anyway, and on an H100 the hinted kernel ran 2 to 3 %
//   slower alone at every tile shape, so they are not used.
// * The grid is one CTA per tile (8192 tiles at 2^24 samples, 62 per SM);
//   tile bases are 64-bit, offsets inside a tile 32-bit.
// * The launcher picks the path from the pointers and the shape: the vector
//   kernel needs A, B and C 16-byte aligned and every row to start on a
//   vector (one row, or an even row length); an odd last sample of a single
//   row is done by one thread.  Anything else (a view with an odd storage
//   offset, an odd row length under a broadcast) takes the scalar kernel:
//   8-byte accesses, one column per thread, rows innermost too.
// * Rounding is written down, not left to the compiler's contraction:
//   re = fma(ar, br, -(ai * bi)), im = fma(ar, bi, ai * br), each product
//   and each fma rounded to nearest.  That is how torch's own complex
//   product comes out on the card, so the kernel equals A * B bit for bit.
//
// Plain C interface, loaded with ctypes: cmul_launch returns the CUDA error
// of the launch (0 when it was accepted).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                     // 16-byte vectors per thread
constexpr int kTile = kThreads * kVec;      // vectors per CTA and row

__device__ __forceinline__ float2 cmul1(float2 a, float2 b) {
  return make_float2(__fmaf_rn(a.x, b.x, -__fmul_rn(a.y, b.y)),
                     __fmaf_rn(a.x, b.y, __fmul_rn(a.y, b.x)));
}

__device__ __forceinline__ float4 cmul2(float4 a, float4 b) {
  const float2 lo = cmul1(make_float2(a.x, a.y), make_float2(b.x, b.y));
  const float2 hi = cmul1(make_float2(a.z, a.w), make_float2(b.z, b.w));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// One tile of nrow rows: a, c point at its vectors in row 0, rows are
// row_stride vectors apart, b at its vectors of B.  kFull: all kTile vectors
// exist, so no predicates; else the first rem.  kRows: more than one row may
// follow (the next row's loads are started before the current row's
// multiplies); without it the tile is one row and holds no third buffer.
template <bool kFull, bool kRows>
__device__ __forceinline__ void tile_rows(const float4* __restrict__ a,
                                          const float4* __restrict__ b,
                                          float4* __restrict__ c,
                                          long long row_stride, int nrow,
                                          int rem) {
  float4 bv[kVec], av[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int off = threadIdx.x + k * kThreads;
    if (kFull || off < rem) {
      bv[k] = b[off];
      av[k] = a[off];
    }
  }
  if (!kRows) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int off = threadIdx.x + k * kThreads;
      if (kFull || off < rem) c[off] = cmul2(av[k], bv[k]);
    }
    return;
  }
  float4 nx[kVec];
  for (int r = 0; r < nrow; ++r) {
    const bool more = r + 1 < nrow;
    a += row_stride;
    if (more) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int off = threadIdx.x + k * kThreads;
        if (kFull || off < rem) nx[k] = a[off];
      }
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int off = threadIdx.x + k * kThreads;
      if (kFull || off < rem) c[off] = cmul2(av[k], bv[k]);
    }
    if (more) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) av[k] = nx[k];
    }
    c += row_stride;
  }
}

template <bool kRows>
__global__ void __launch_bounds__(kThreads)
    cmul_vec_kernel(const float4* __restrict__ A, const float4* __restrict__ B,
                    float4* __restrict__ C, long long nvec, int nrow,
                    int odd_tail) {
  const long long tile = (long long)blockIdx.x * kTile;
  const long long left = nvec - tile;
  if (left >= kTile)
    tile_rows<true, kRows>(A + tile, B + tile, C + tile, nvec, nrow, kTile);
  else
    tile_rows<false, kRows>(A + tile, B + tile, C + tile, nvec, nrow,
                            (int)left);
  // the odd last sample of a single row (the launcher allows an odd length
  // only with one row)
  if (odd_tail && blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    const float2* a2 = reinterpret_cast<const float2*>(A) + 2 * nvec;
    const float2* b2 = reinterpret_cast<const float2*>(B) + 2 * nvec;
    float2* c2 = reinterpret_cast<float2*>(C) + 2 * nvec;
    *c2 = cmul1(*a2, *b2);
  }
}

__global__ void __launch_bounds__(kThreads)
    cmul_scalar_kernel(const float2* __restrict__ A,
                       const float2* __restrict__ B, float2* __restrict__ C,
                       long long ncol, int nrow) {
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (col >= ncol) return;
  const float2 b = B[col];
  for (int r = 0; r < nrow; ++r)
    C[r * ncol + col] = cmul1(A[r * ncol + col], b);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// A, C: nrow x ncol complex64, contiguous; B: nrow x ncol (broadcast = 0) or
// ncol (broadcast = 1).  All pointers 8-byte aligned (complex64 elements).
int cmul_launch(const void* A, const void* B, void* C, long long nrow,
                long long ncol, int broadcast, void* stream_ptr) {
  if (nrow <= 0 || ncol <= 0) return 0;
  if (!broadcast) {  // the same offsets in all three: one long row
    ncol *= nrow;
    nrow = 1;
  }
  if (nrow > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool vec = aligned16(A) && aligned16(B) && aligned16(C) &&
                   (nrow == 1 || ncol % 2 == 0) && ncol >= 2;
  if (vec) {
    const long long nvec = ncol / 2;
    const long long blocks = (nvec + kTile - 1) / kTile;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const float4* a4 = static_cast<const float4*>(A);
    const float4* b4 = static_cast<const float4*>(B);
    float4* c4 = static_cast<float4*>(C);
    if (nrow == 1)
      cmul_vec_kernel<false><<<(unsigned)blocks, kThreads, 0, stream>>>(
          a4, b4, c4, nvec, 1, (int)(ncol % 2));
    else
      cmul_vec_kernel<true><<<(unsigned)blocks, kThreads, 0, stream>>>(
          a4, b4, c4, nvec, (int)nrow, 0);
  } else {
    const long long blocks = (ncol + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cmul_scalar_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const float2*>(A), static_cast<const float2*>(B),
        static_cast<float2*>(C), ncol, (int)nrow);
  }
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
