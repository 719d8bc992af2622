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
// The same file holds the two kernels of the phi_max-adaptive split step
// (ops/ssfm.py ssfm_while_inside), which replace no TPU kernel: on the TPU
// XLA fused the same pointwise work.  A step there is
//
//   B, H = nl_halfstep(A)  ->  X = fft(B)  ->  spectral_phase(X)  ->
//   Y = ifft(X) without its 1/n  ->  A, max|A|^2 = cmul_max(Y, H)
//
// * spectral_phase: X *= ls * (cos(phi * h), sin(phi * h)) in place, phi a
//   float32 row broadcast over X's rows.  The factor is built in registers
//   (once a column, used for every row), so the step neither writes nor
//   reads a complex factor.  ls is the step's loss exp(-alpha h / 2) times
//   the inverse transform's 1/n when n is a power of two (then exact: a
//   power of two commutes with every rounding of the transform), so the
//   inverse needs no scaling pass.  th = phi * h, then precise cosf / sinf,
//   then ls * each, each rounded to nearest: how torch.polar(loss, phi * h)
//   comes out on the card.  Bytes bound it: 12 B read and 8 B written a
//   sample of one row.
// * cmul_max: C = A * H with cmul's rounding and, in the same pass,
//   max(re * re + im * im) over the stored C (each product and the sum
//   rounded to nearest: view_as_real(C).square().sum(-1).max(), which is
//   order-free).  A NaN wins, as in torch.max.  Each CTA reduces in
//   registers and shuffles, then one thread folds the CTA's maximum into a
//   scratch word with atomicMax on its bits (the values are >= +0, so their
//   bits order as the floats do, and NaN is made 0x7fffffff, above +inf);
//   the last CTA to finish (a counter beside it) writes the result and
//   zeroes both words, so the scratch is zero between launches and no
//   launch needs a memset.  Bytes bound it, as cmul.  power_max is the same
//   reduction over A alone (one read; the loop's first step size).
//
// Plain C interface, loaded with ctypes: each *_launch returns the CUDA
// error of the launch (0 when it was accepted).

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

// ---------------------------------------------------------------------------
// spectral_phase
// ---------------------------------------------------------------------------
__device__ __forceinline__ float2 phase1(float phi, float h, float ls) {
  const float th = __fmul_rn(phi, h);
  return make_float2(__fmul_rn(ls, cosf(th)), __fmul_rn(ls, sinf(th)));
}

__device__ __forceinline__ float4 phase2(float2 phi, float h, float ls) {
  const float2 lo = phase1(phi.x, h, ls);
  const float2 hi = phase1(phi.y, h, ls);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// One tile of nrow rows of X, in place: x points at its vectors in row 0,
// rows are row_stride vectors apart, phi at its pairs of the row.  The
// first row's loads are started before the factor is computed; each next
// row's before the current row is multiplied.  kRows as in tile_rows: a
// single row holds no third buffer (fewer registers, more CTAs an SM).
template <bool kFull, bool kRows>
__device__ __forceinline__ void phase_tile(float4* x, const float2* phi,
                                           float h, float ls,
                                           long long row_stride, int nrow,
                                           int rem) {
  float4 xv[kVec], e[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int off = threadIdx.x + k * kThreads;
    if (kFull || off < rem) xv[k] = x[off];
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int off = threadIdx.x + k * kThreads;
    if (kFull || off < rem) e[k] = phase2(phi[off], h, ls);
  }
  if (!kRows) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int off = threadIdx.x + k * kThreads;
      if (kFull || off < rem) x[off] = cmul2(xv[k], e[k]);
    }
    return;
  }
  float4 nx[kVec];
  for (int r = 0; r < nrow; ++r) {
    const bool more = r + 1 < nrow;
    if (more) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int off = threadIdx.x + k * kThreads;
        if (kFull || off < rem) nx[k] = x[row_stride + off];
      }
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int off = threadIdx.x + k * kThreads;
      if (kFull || off < rem) x[off] = cmul2(xv[k], e[k]);
    }
    if (more) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) xv[k] = nx[k];
    }
    x += row_stride;
  }
}

template <bool kRows>
__global__ void __launch_bounds__(kThreads)
    phase_vec_kernel(float4* X, const float2* __restrict__ phi, float h,
                     float ls, long long nvec, int nrow, int odd_tail) {
  const long long tile = (long long)blockIdx.x * kTile;
  const long long left = nvec - tile;
  if (left >= kTile)
    phase_tile<true, kRows>(X + tile, phi + tile, h, ls, nvec, nrow, kTile);
  else
    phase_tile<false, kRows>(X + tile, phi + tile, h, ls, nvec, nrow,
                             (int)left);
  // the odd last sample of a single row
  if (odd_tail && blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    float2* x2 = reinterpret_cast<float2*>(X) + 2 * nvec;
    const float* p = reinterpret_cast<const float*>(phi) + 2 * nvec;
    *x2 = cmul1(*x2, phase1(*p, h, ls));
  }
}

__global__ void __launch_bounds__(kThreads)
    phase_scalar_kernel(float2* X, const float* __restrict__ phi, float h,
                        float ls, long long ncol, int nrow) {
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (col >= ncol) return;
  const float2 e = phase1(phi[col], h, ls);
  for (int r = 0; r < nrow; ++r)
    X[r * ncol + col] = cmul1(X[r * ncol + col], e);
}

// ---------------------------------------------------------------------------
// cmul_max and power_max
// ---------------------------------------------------------------------------
__device__ __forceinline__ float power1(float2 c) {
  return __fadd_rn(__fmul_rn(c.x, c.x), __fmul_rn(c.y, c.y));
}

// max that keeps a NaN from either side (the values are >= +0 or NaN)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ float max_power2(float m, float4 c) {
  m = max_nan(m, power1(make_float2(c.x, c.y)));
  return max_nan(m, power1(make_float2(c.z, c.w)));
}

// Fold each thread's maximum m into the launch's: the CTA's by shuffles and
// shared memory, then into scratch[0] by atomicMax on the bits; the last CTA
// (scratch[1] counts the CTAs done) writes the result to out and leaves
// both words zero.
__device__ __forceinline__ void commit_max(float m, unsigned* scratch,
                                           float* out) {
  __shared__ float warp_max[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) m = max_nan(m, warp_max[w]);
  atomicMax(&scratch[0], m != m ? 0x7fffffffu : __float_as_uint(m));
  __threadfence();
  if (atomicAdd(&scratch[1], 1u) == gridDim.x - 1) {
    __threadfence();
    *out = __uint_as_float(atomicExch(&scratch[0], 0u));
    atomicExch(&scratch[1], 0u);
  }
}

// One tile of a single row: kProduct, C = A * H stored and its powers taken;
// else the powers of A.  C may be A (each vector is loaded before it is
// stored), so neither is __restrict__.
template <bool kFull, bool kProduct>
__device__ __forceinline__ float max_tile(const float4* a,
                                          const float4* __restrict__ hh,
                                          float4* c, int rem) {
  float4 av[kVec], hv[kVec];
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int off = threadIdx.x + k * kThreads;
    if (kFull || off < rem) {
      av[k] = a[off];
      if (kProduct) hv[k] = hh[off];
    }
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int off = threadIdx.x + k * kThreads;
    if (kFull || off < rem) {
      const float4 v = kProduct ? cmul2(av[k], hv[k]) : av[k];
      if (kProduct) c[off] = v;
      m = max_power2(m, v);
    }
  }
  return m;
}

template <bool kProduct>
__global__ void __launch_bounds__(kThreads)
    max_vec_kernel(const float4* A, const float4* __restrict__ H, float4* C,
                   long long nvec, int odd_tail, unsigned* scratch,
                   float* out) {
  const long long tile = (long long)blockIdx.x * kTile;
  const long long left = nvec - tile;
  float m = left >= kTile
                ? max_tile<true, kProduct>(A + tile, H + tile, C + tile, kTile)
                : max_tile<false, kProduct>(A + tile, H + tile, C + tile,
                                            (int)left);
  if (odd_tail && blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    float2 v = reinterpret_cast<const float2*>(A)[2 * nvec];
    if (kProduct) {
      v = cmul1(v, reinterpret_cast<const float2*>(H)[2 * nvec]);
      reinterpret_cast<float2*>(C)[2 * nvec] = v;
    }
    m = max_nan(m, power1(v));
  }
  commit_max(m, scratch, out);
}

// Views 8 bytes off a 16-byte boundary: 8-byte accesses, 2 * kTile samples
// a CTA as in the vector kernel.
template <bool kProduct>
__global__ void __launch_bounds__(kThreads)
    max_scalar_kernel(const float2* A, const float2* __restrict__ H,
                      float2* C, long long n, unsigned* scratch, float* out) {
  const long long base = (long long)blockIdx.x * 2 * kTile;
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < 2 * kVec; ++k) {
    const long long i = base + threadIdx.x + k * kThreads;
    if (i < n) {
      float2 v = A[i];
      if (kProduct) {
        v = cmul1(v, H[i]);
        C[i] = v;
      }
      m = max_nan(m, power1(v));
    }
  }
  commit_max(m, scratch, out);
}

template <bool kProduct>
int max_launch(const void* A, const void* H, void* C, long long n,
               void* scratch, void* out, void* stream_ptr) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  unsigned* s = static_cast<unsigned*>(scratch);
  float* o = static_cast<float*>(out);
  const bool vec = aligned16(A) && (!kProduct || (aligned16(H) &&
                                                  aligned16(C))) && n >= 2;
  const long long blocks = vec ? (n / 2 + kTile - 1) / kTile
                               : (n + 2LL * kTile - 1) / (2LL * kTile);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (vec)
    max_vec_kernel<kProduct><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const float4*>(A), static_cast<const float4*>(H),
        static_cast<float4*>(C), n / 2, (int)(n % 2), s, o);
  else
    max_scalar_kernel<kProduct><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const float2*>(A), static_cast<const float2*>(H),
        static_cast<float2*>(C), n, s, o);
  return (int)cudaGetLastError();
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

// X: nrow x ncol complex64, contiguous, multiplied in place; phi: ncol
// float32.  h: the step, ls: loss times the folded 1/n (or 1).
int spectral_phase_launch(void* X, const void* phi, long long nrow,
                          long long ncol, float h, float ls,
                          void* stream_ptr) {
  if (nrow <= 0 || ncol <= 0) return 0;
  if (nrow > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool vec = aligned16(X) &&
                   (reinterpret_cast<std::uintptr_t>(phi) & 7u) == 0 &&
                   (nrow == 1 || ncol % 2 == 0) && ncol >= 2;
  if (vec) {
    const long long nvec = ncol / 2;
    const long long blocks = (nvec + kTile - 1) / kTile;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    float4* x4 = static_cast<float4*>(X);
    const float2* p2 = static_cast<const float2*>(phi);
    if (nrow == 1)
      phase_vec_kernel<false><<<(unsigned)blocks, kThreads, 0, stream>>>(
          x4, p2, h, ls, nvec, 1, (int)(ncol % 2));
    else
      phase_vec_kernel<true><<<(unsigned)blocks, kThreads, 0, stream>>>(
          x4, p2, h, ls, nvec, (int)nrow, 0);
  } else {
    const long long blocks = (ncol + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    phase_scalar_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<float2*>(X), static_cast<const float*>(phi), h, ls, ncol,
        (int)nrow);
  }
  return (int)cudaGetLastError();
}

// A, H, C: n complex64, contiguous (C may be A); scratch: two uint32, zero;
// out: one float32, max(re^2 + im^2) of C.
int cmul_max_launch(const void* A, const void* H, void* C, long long n,
                    void* scratch, void* out, void* stream_ptr) {
  return max_launch<true>(A, H, C, n, scratch, out, stream_ptr);
}

// max(re^2 + im^2) of A's n complex64 samples into out.
int power_max_launch(const void* A, long long n, void* scratch, void* out,
                     void* stream_ptr) {
  return max_launch<false>(A, nullptr, nullptr, n, scratch, out, stream_ptr);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
