// The pencil FFT's local passes for Hopper (sm_90a): the rank-axis DFT with
// its twiddle, and the inverse transform's twiddle with its pack, each one
// pass that reads the field once and writes it once, straight into the
// layout that the next all_to_all_single sends (parallel/dfft.py).
//
// Replaces no TPU kernel: the JAX package's parallel/dfft.py writes the
// P-point DFT as a jnp.einsum (a tiny matmul on the MXU) and the twiddle as a
// product that XLA fuses with it.  Composed on the card, the einsum was a
// cuBLAS complex GEMM with K = P (its 32 x 64 tiles spent their time on the
// tile, not the data: about a tenth of the byte bound at the four-card
// sweep's shape), followed by a permuting copy, a broadcast cmul and a
// packing copy; the inverse's twiddle was a broadcast cmul and a copy.
//
// Layouts (complex64 as interleaved float32 re, im; contiguous; R rows, the
// product of the field's leading axes; B = P * C samples a row):
// * pencil_dft: z (P, R, C) -> y (P, R, C),
//     y[k, r, c] = tw[k*C + c] * sum_n W[k, n] * z[n, r, c]  (tw optional).
//   Forward (W_f, tw_f): the first all-to-all's output in, the second's
//   input out.  Inverse (W_i, no twiddle): between its two all-to-alls.
// * pencil_twiddle_pack: u (R, B) -> out (P, R, C),
//     out[p, r, c] = u[r, p*C + c] * tw[p*C + c].
//   The inverse FFT's output in, the inverse's first all-to-all's input out.
//
// What bounds it on an H100: bytes.  At P = 2 a sample costs two complex
// multiply-adds and a complex product (14 flop) against 16 B moved (8 read,
// 8 written) and the twiddle's 8 B once a column.
//
// Design:
// * A thread owns one column of the (R, C) plane: a 16-byte vector (two
//   samples) where C is even and every pointer 16-byte aligned, else one
//   sample.  It loads its twiddle once (P values) and walks the rows of its
//   CTA, so the twiddle crosses HBM once a row chunk, not once a row; it
//   starts the next row's loads before it computes and stores the current
//   one.  Neighbouring threads take neighbouring columns, so every load and
//   store of a warp is one contiguous run.
// * W (P x P) sits in shared memory; every lane of a warp reads the same
//   entry (a broadcast, no bank conflict).  P = 1, 2 and 4 (one card, the
//   2 x 2 mesh's time axis, a line of four) are compiled with P known, a
//   column's P inputs and P twiddles in registers; any other P takes a
//   scalar kernel that reads W and the P inputs through L1 (each input is
//   read P times by the same thread).
// * The rows go to gridDim.y in chunks only where the columns alone give
//   fewer than kMinCtas CTAs (a field of few, short rows); else a CTA walks
//   every row.
// * Rounding is written down, not left to the compiler's contraction: the
//   DFT accumulates each component with fused multiply-adds in n order
//   (re = fma(wr, zr, re), re = fma(-wi, zi, re); im = fma(wr, zi, im),
//   im = fma(wi, zr, im)), then the twiddle product rounds as cmul.cu's:
//   re = fma(ar, br, -(ai * bi)), im = fma(ar, bi, ai * br).  So the
//   twiddle-and-pack is bit-equal to cmul and the copy, and the DFT differs
//   from the GEMM only in the order of its roundings (at P = 2, where W is
//   +-1 up to 1.2e-16, each output is z0 +- z1 rounded once).
//
// Plain C interface, loaded with ctypes: each *_launch returns the CUDA
// error of the launch (0 when it was accepted).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMinCtas = 1024;  // about 8 CTAs an SM on 132 SMs

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fmaf_rn(a.x, b.x, -__fmul_rn(a.y, b.y)),
                     __fmaf_rn(a.x, b.y, __fmul_rn(a.y, b.x)));
}

__device__ __forceinline__ float4 cmul(float4 a, float4 b) {
  const float2 lo = cmul(make_float2(a.x, a.y), make_float2(b.x, b.y));
  const float2 hi = cmul(make_float2(a.z, a.w), make_float2(b.z, b.w));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// acc + w * z, each component by two fused multiply-adds
__device__ __forceinline__ float2 cmac(float2 acc, float2 w, float2 z) {
  acc.x = __fmaf_rn(w.x, z.x, acc.x);
  acc.x = __fmaf_rn(-w.y, z.y, acc.x);
  acc.y = __fmaf_rn(w.x, z.y, acc.y);
  acc.y = __fmaf_rn(w.y, z.x, acc.y);
  return acc;
}

__device__ __forceinline__ float4 cmac(float4 acc, float2 w, float4 z) {
  const float2 lo =
      cmac(make_float2(acc.x, acc.y), w, make_float2(z.x, z.y));
  const float2 hi =
      cmac(make_float2(acc.z, acc.w), w, make_float2(z.z, z.w));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

// Rows a CTA walks: all of them, unless the columns give too few CTAs.
inline long long row_chunk(long long blocks_x, long long nrow) {
  long long chunk = nrow;
  while (chunk > 1 && blocks_x * ((nrow + chunk - 1) / chunk) < kMinCtas)
    chunk = (chunk + 1) / 2;
  return chunk;
}

// ---------------------------------------------------------------------------
// pencil_dft
// ---------------------------------------------------------------------------
// z, y: (kP, nrow, ncol) in units of T; tw: kP * ncol of T (kTw).
template <int kP, bool kTw, typename T>
__global__ void __launch_bounds__(kThreads)
    dft_kernel(const T* __restrict__ z, const float2* __restrict__ W,
               const T* __restrict__ tw, T* __restrict__ y, long long ncol,
               int nrow, int chunk) {
  __shared__ float2 w[kP * kP];
  if (threadIdx.x < kP * kP) w[threadIdx.x] = W[threadIdx.x];
  __syncthreads();
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (col >= ncol) return;
  const int r0 = blockIdx.y * chunk;
  const int r1 = min(nrow, r0 + chunk);
  const long long plane = (long long)nrow * ncol;
  T t[kP];
  if constexpr (kTw) {
#pragma unroll
    for (int k = 0; k < kP; ++k) t[k] = tw[k * ncol + col];
  }
  const T* zp = z + (long long)r0 * ncol + col;
  T* yp = y + (long long)r0 * ncol + col;
  T cur[kP], nxt[kP];
#pragma unroll
  for (int n = 0; n < kP; ++n) cur[n] = zp[n * plane];
  for (int r = r0; r < r1; ++r) {
    const bool more = r + 1 < r1;
    if (more) {
#pragma unroll
      for (int n = 0; n < kP; ++n) nxt[n] = zp[n * plane + ncol];
    }
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      T acc{};
#pragma unroll
      for (int n = 0; n < kP; ++n) acc = cmac(acc, w[k * kP + n], cur[n]);
      if constexpr (kTw) acc = cmul(acc, t[k]);
      yp[k * plane] = acc;
    }
    if (more) {
#pragma unroll
      for (int n = 0; n < kP; ++n) cur[n] = nxt[n];
    }
    zp += ncol;
    yp += ncol;
  }
}

// Any P: one sample a thread, W and the P inputs of a column through L1.
template <bool kTw>
__global__ void __launch_bounds__(kThreads)
    dft_any_kernel(const float2* __restrict__ z, const float2* __restrict__ W,
                   const float2* __restrict__ tw, float2* __restrict__ y,
                   long long ncol, int nrow, int chunk, int P) {
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (col >= ncol) return;
  const int r0 = blockIdx.y * chunk;
  const int r1 = min(nrow, r0 + chunk);
  const long long plane = (long long)nrow * ncol;
  for (int r = r0; r < r1; ++r) {
    const long long at = (long long)r * ncol + col;
    for (int k = 0; k < P; ++k) {
      float2 acc{};
      for (int n = 0; n < P; ++n)
        acc = cmac(acc, W[k * P + n], z[n * plane + at]);
      if constexpr (kTw) acc = cmul(acc, tw[k * ncol + col]);
      y[k * plane + at] = acc;
    }
  }
}

template <int kP, bool kTw>
void dft_fixed(bool vec, dim3 grid, cudaStream_t stream, const void* z,
               const void* W, const void* tw, void* y, long long ncol,
               int nrow, int chunk) {
  const float2* w = static_cast<const float2*>(W);
  if (vec)
    dft_kernel<kP, kTw, float4><<<grid, kThreads, 0, stream>>>(
        static_cast<const float4*>(z), w, static_cast<const float4*>(tw),
        static_cast<float4*>(y), ncol, nrow, chunk);
  else
    dft_kernel<kP, kTw, float2><<<grid, kThreads, 0, stream>>>(
        static_cast<const float2*>(z), w, static_cast<const float2*>(tw),
        static_cast<float2*>(y), ncol, nrow, chunk);
}

template <bool kTw>
int dft_launch(const void* z, const void* W, const void* tw, void* y, int P,
               long long nrow, long long ncol, cudaStream_t stream) {
  const bool fixed = P == 1 || P == 2 || P == 4;
  const bool vec = fixed && ncol % 2 == 0 && aligned16(z) && aligned16(y) &&
                   (!kTw || aligned16(tw));
  const long long units = vec ? ncol / 2 : ncol;
  const long long blocks = (units + kThreads - 1) / kThreads;
  const long long chunk = row_chunk(blocks, nrow);
  const long long chunks = (nrow + chunk - 1) / chunk;
  if (blocks > 0x7fffffffLL || chunks > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)chunks);
  switch (P) {
    case 1: dft_fixed<1, kTw>(vec, grid, stream, z, W, tw, y, units,
                              (int)nrow, (int)chunk); break;
    case 2: dft_fixed<2, kTw>(vec, grid, stream, z, W, tw, y, units,
                              (int)nrow, (int)chunk); break;
    case 4: dft_fixed<4, kTw>(vec, grid, stream, z, W, tw, y, units,
                              (int)nrow, (int)chunk); break;
    default:
      dft_any_kernel<kTw><<<grid, kThreads, 0, stream>>>(
          static_cast<const float2*>(z), static_cast<const float2*>(W),
          static_cast<const float2*>(tw), static_cast<float2*>(y), ncol,
          (int)nrow, (int)chunk, P);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// pencil_twiddle_pack
// ---------------------------------------------------------------------------
// u: (nrow, P * ncol), out: (P, nrow, ncol), tw: P * ncol, in units of T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    twiddle_pack_kernel(const T* __restrict__ u, const T* __restrict__ tw,
                        T* __restrict__ out, long long ncol, int P, int nrow,
                        int chunk) {
  const long long width = (long long)P * ncol;
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= width) return;
  const long long p = j / ncol;
  const int r0 = blockIdx.y * chunk;
  const int r1 = min(nrow, r0 + chunk);
  const T t = tw[j];
  const T* up = u + (long long)r0 * width + j;
  T* op = out + (p * nrow + r0) * ncol + (j - p * ncol);
  T cur = *up;
  for (int r = r0; r < r1; ++r) {
    const bool more = r + 1 < r1;
    T nxt;
    if (more) nxt = up[width];
    *op = cmul(cur, t);
    if (more) cur = nxt;
    up += width;
    op += ncol;
  }
}

}  // namespace

extern "C" {

// z, y: P x nrow x ncol complex64, contiguous, 8-byte aligned, y not
// overlapping z; W: P x P complex64; tw: P * ncol complex64, or null for no
// twiddle.
int pencil_dft_launch(const void* z, const void* W, const void* tw, void* y,
                      int P, long long nrow, long long ncol,
                      void* stream_ptr) {
  if (P <= 0 || nrow <= 0 || ncol <= 0) return 0;
  if (nrow > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return tw ? dft_launch<true>(z, W, tw, y, P, nrow, ncol, stream)
            : dft_launch<false>(z, W, tw, y, P, nrow, ncol, stream);
}

// u: nrow x (P * ncol) complex64, out: P x nrow x ncol, tw: P * ncol; all
// contiguous, 8-byte aligned, out not overlapping u.
int pencil_twiddle_pack_launch(const void* u, const void* tw, void* out,
                               int P, long long nrow, long long ncol,
                               void* stream_ptr) {
  if (P <= 0 || nrow <= 0 || ncol <= 0) return 0;
  if (nrow > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool vec = ncol % 2 == 0 && aligned16(u) && aligned16(tw) &&
                   aligned16(out);
  const long long units = vec ? ncol / 2 : ncol;
  const long long blocks = (P * units + kThreads - 1) / kThreads;
  const long long chunk = row_chunk(blocks, nrow);
  const long long chunks = (nrow + chunk - 1) / chunk;
  if (blocks > 0x7fffffffLL || chunks > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)chunks);
  if (vec)
    twiddle_pack_kernel<float4><<<grid, kThreads, 0, stream>>>(
        static_cast<const float4*>(u), static_cast<const float4*>(tw),
        static_cast<float4*>(out), units, P, (int)nrow, (int)chunk);
  else
    twiddle_pack_kernel<float2><<<grid, kThreads, 0, stream>>>(
        static_cast<const float2*>(u), static_cast<const float2*>(tw),
        static_cast<float2*>(out), units, P, (int)nrow, (int)chunk);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
