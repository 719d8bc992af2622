// Histograms of integer bin indices, for Hopper (sm_90a): the 2-D table of
// index pairs and its row-batched form.
//
// Replaces opticomlib_tpu/ops/pallas_kernels.py _hist_kernel (a one-hot
// matrix product on the TPU's matrix unit) and the vmap over a row scatter
// that the JAX package wraps around it (ops/eyeana.py).  Two entries of one
// kernel family:
//
//   histogram_rows_launch  y (C, n) -> counts (C, ny): row c counts its own n
//                          samples.  The receivers' KDE histograms: (1, 4096)
//                          for one link, (channels, 4096) for a WDM sweep,
//                          (channels, 8192) for the histogram range estimator.
//   histogram2d_launch     pairs (t[k], y[k]) -> counts (nt, ny): the general
//                          table, e.g. the (256, 256) eye-density render.
//
// What bounds it on an H100: the index stream (4 B a sample by rows, 8 B a
// pair) against 3.35 TB/s, which is a few microseconds at the receivers'
// sizes, so launch count and latency decide; and, where an eye puts most
// samples into a few dozen bins, atomic contention.  The design:
//
//   * One launch.  A block zeroes a private u32 table in shared memory, counts
//     into it with shared-memory atomics, and flushes it.  Where one block
//     owns a row or tile the flush is a plain float32 store.  Where several
//     share it they add their nonzero bins into a u32 scratch table in device
//     memory that is all zero between launches; the last block to finish
//     (a ticket counter behind a __threadfence) converts the sums to float32,
//     writes the result and zeroes the scratch again.  No memset and no
//     convert kernel around the count.
//   * The row comes from the block index (blockIdx.y), so the row-batched
//     entry reads no row-index array and a block needs only ny bins of
//     shared memory whatever the number of rows.
//   * A table larger than kTileBins is cut into tiles of flat bins; a block
//     counts only the samples that fall into its tile, and the index stream
//     is read once a tile (from L2 where it fits).  Only a table of more than
//     kMaxTiles tiles takes the global path: float32 atomicAdd (exact below
//     2^24) straight into the zeroed result, one a sample.
//   * 16-byte loads, kUnroll of them in flight a thread before the first
//     atomic.  The kernel peels the samples before the first 16-byte
//     boundary and after the last whole vector itself, so any int32 view
//     takes the vector path; only a pair stream whose two arrays sit at
//     different offsets from a boundary is read element by element.
//   * Contention: kSubTables private copies of the table a block (warp w
//     counts into copy w % kSubTables) and kAggregate (equal bins of a warp
//     merged with __match_any_sync before one atomicAdd by the leader) are
//     compile-time variants; scripts/sweep_torch_kernels.py times them on an
//     eye window and on uniform bins.
//   * Host side: the SM count and the shared-memory opt-in are read once a
//     device and kept; nothing else is queried on a launch.
//
// Counts are exact integers, returned as float32 (exact below 2^24 a bin).
// Indices out of range (e.g. -1 for a masked sample) are dropped.
//
// Plain C interface, loaded with ctypes: the launchers return the first CUDA
// error (0 when every call was accepted); nothing is allocated and nothing
// synchronises.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;       // threads a block
constexpr int kUnroll = 4;          // 16-byte loads in flight a thread
constexpr int kBlocksPerSm = 2;     // blocks an SM, summed over rows and tiles
constexpr int kTileBins = 16384;    // bins a block keeps in shared memory
constexpr int kMaxTiles = 16;       // tiles a table; beyond: the global path
constexpr int kSubTables = 1;       // private copies of a small table a block
constexpr bool kAggregate = false;  // merge a warp's equal bins first
constexpr int kMaxDevices = 64;

struct Job {
  const int* t;           // pairs: first index of each pair; rows: unused
  const int* y;           // pairs: second index; rows: (nt, n) samples
  long long n;            // pairs, or samples a row
  int nt, ny;             // table shape; rows: nt rows of ny bins
  int tiles;              // tiles of a row (rows) or of the flat table (pairs)
  int copies;             // private copies of the tile in shared memory
  unsigned int* scratch;  // nt*ny sums, then one ticket counter a group
  float* out;             // (nt, ny)
};

template <bool kRows, bool kVec>
__global__ void __launch_bounds__(kThreads) hist_tiles(Job j) {
  extern __shared__ unsigned int local[];
  __shared__ bool is_last;
  const int group = blockIdx.y;
  const int row = kRows ? group / j.tiles : 0;
  const int tile = kRows ? group % j.tiles : group;
  const int table = kRows ? j.ny : j.nt * j.ny;  // bins the tiles cut up
  const int lo = tile * kTileBins;
  const int bins = table - lo < kTileBins ? table - lo : kTileBins;

  for (int b = threadIdx.x; b < j.copies * bins; b += kThreads) local[b] = 0u;
  __syncthreads();
  unsigned int* mine = local + ((threadIdx.x >> 5) % j.copies) * bins;

  // every thread of a warp calls this together (kAggregate votes)
  auto count = [&](int ti, int yi) {
    bool ok = (unsigned)yi < (unsigned)j.ny &&
              (kRows || (unsigned)ti < (unsigned)j.nt);
    const int v = ok ? (kRows ? yi : ti * j.ny + yi) - lo : -1;
    ok = ok && (unsigned)v < (unsigned)bins;
    if (kAggregate) {
      const unsigned live = __ballot_sync(0xffffffffu, ok);
      if (ok) {
        const unsigned peers = __match_any_sync(live, v);
        if ((int)(threadIdx.x & 31) == __ffs(peers) - 1)
          atomicAdd(&mine[v], (unsigned)__popc(peers));
      }
    } else if (ok) {
      atomicAdd(&mine[v], 1u);
    }
  };

  const int* y = j.y + (kRows ? (long long)row * j.n : 0LL);
  const int* t = j.t;
  // scalar head up to the first 16-byte boundary, 16-byte vectors, scalar
  // tail; without kVec every element is a "vector" of one
  long long head = 0, nvec = j.n;
  if (kVec) {
    head = ((16 - (int)(reinterpret_cast<std::uintptr_t>(y) & 15)) & 15) / 4;
    if (head > j.n) head = j.n;
    nvec = (j.n - head) / 4;
  }
  const long long tail0 = head + nvec * (kVec ? 4 : 1);

  const long long per_iter = (long long)kThreads * kUnroll;
  for (long long base = blockIdx.x * per_iter; base < nvec;
       base += gridDim.x * per_iter) {
    int4 yv[kUnroll], tv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads + threadIdx.x;
      yv[u] = make_int4(-1, -1, -1, -1);
      tv[u] = make_int4(0, 0, 0, 0);
      if (i < nvec) {
        if (kVec) {
          yv[u] = *reinterpret_cast<const int4*>(y + head + 4 * i);
          if (!kRows) tv[u] = *reinterpret_cast<const int4*>(t + head + 4 * i);
        } else {
          yv[u].x = y[i];
          if (!kRows) tv[u].x = t[i];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      count(tv[u].x, yv[u].x);
      if (kVec) {
        count(tv[u].y, yv[u].y);
        count(tv[u].z, yv[u].z);
        count(tv[u].w, yv[u].w);
      }
    }
  }
  if (kVec && blockIdx.x == 0) {  // at most 3 + 3 elements around the vectors
    const long long extra = head + (j.n - tail0);
    const bool live = threadIdx.x < extra;
    const long long i =
        threadIdx.x < head ? threadIdx.x : tail0 + (threadIdx.x - head);
    count(live && !kRows ? t[i] : 0, live ? y[i] : -1);
  }
  __syncthreads();

  const long long out0 = (kRows ? (long long)row * j.ny : 0LL) + lo;
  if (gridDim.x == 1) {  // this block owns the tile: store
    for (int b = threadIdx.x; b < bins; b += kThreads) {
      unsigned int c = 0u;
      for (int s = 0; s < j.copies; ++s) c += local[s * bins + b];
      j.out[out0 + b] = (float)c;
    }
    return;
  }
  unsigned int* sums = j.scratch + out0;
  for (int b = threadIdx.x; b < bins; b += kThreads) {
    unsigned int c = 0u;
    for (int s = 0; s < j.copies; ++s) c += local[s * bins + b];
    if (c) atomicAdd(&sums[b], c);
  }
  __threadfence();
  __syncthreads();
  unsigned int* ticket = j.scratch + (long long)j.nt * j.ny + group;
  if (threadIdx.x == 0) is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int b = threadIdx.x; b < bins; b += kThreads) {
    j.out[out0 + b] = (float)__ldcg(&sums[b]);
    sums[b] = 0u;  // the scratch is all zero again for the next launch
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

// One global float32 atomicAdd a sample into the zeroed result: only for a
// table that kMaxTiles tiles of shared memory do not cover.
template <bool kRows>
__global__ void __launch_bounds__(kThreads) hist_global(Job j) {
  const int row = kRows ? blockIdx.y : 0;
  const int* y = j.y + (kRows ? (long long)row * j.n : 0LL);
  float* out = j.out + (kRows ? (long long)row * j.ny : 0LL);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long k = (long long)blockIdx.x * kThreads + threadIdx.x; k < j.n;
       k += stride) {
    const int yi = y[k];
    const int ti = kRows ? 0 : j.t[k];
    if ((unsigned)yi < (unsigned)j.ny &&
        (kRows || (unsigned)ti < (unsigned)j.nt))
      atomicAdd(&out[(long long)ti * j.ny + yi], 1.0f);
  }
}

struct Device {
  int sms;
  bool ready;
};
Device g_device[kMaxDevices];

// Makes `device` current for the launch and puts the caller's back after it.
struct DeviceGuard {
  int before = -1, wanted;
  cudaError_t err;
  explicit DeviceGuard(int device) : wanted(device) {
    err = cudaGetDevice(&before);
    if (err == cudaSuccess && before != wanted) err = cudaSetDevice(wanted);
  }
  ~DeviceGuard() {
    if (before >= 0 && before != wanted) cudaSetDevice(before);
  }
};

// Read once a device (it must be current): the SM count, and the opt-in to
// more than 48 KiB of dynamic shared memory for every tile kernel.
cudaError_t prepare(int device, const Device** out) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  Device& d = g_device[device];
  if (!d.ready) {
    int smem = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(
        &smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    // a tile is the most dynamic shared memory a block asks for; the
    // kernels' few static bytes come on top
    const int tile = kTileBins * (int)sizeof(unsigned int);
    if (smem < tile + 1024) return cudaErrorInvalidConfiguration;
    const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
    if ((err = cudaFuncSetAttribute(hist_tiles<true, true>, attr, tile)) !=
            cudaSuccess ||
        (err = cudaFuncSetAttribute(hist_tiles<false, true>, attr, tile)) !=
            cudaSuccess ||
        (err = cudaFuncSetAttribute(hist_tiles<false, false>, attr, tile)) !=
            cudaSuccess)
      return err;
    d.ready = true;
  }
  *out = &d;
  return cudaSuccess;
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

int tiles_of(long long table) { return (int)ceil_div(table, kTileBins); }

// rows: y is (nt, n) and the table (nt, ny), row r counting its own samples;
// else (t, y) are n pairs into the (nt, ny) table.
int launch(bool rows, const int* t, const int* y, long long n, int nt, int ny,
           unsigned int* scratch, long long scratch_len, float* out,
           int device, void* stream_ptr) {
  const long long total = (long long)nt * ny;
  if (nt < 1 || ny < 1 || n < 0 || total > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const Device* d = nullptr;
  cudaError_t err = prepare(device, &d);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Job j{t, y, n, nt, ny, 1, 1, scratch, out};
  const long long table = rows ? ny : total;
  const long long nrow = rows ? nt : 1;
  if (nrow > 65535) return (int)cudaErrorInvalidValue;

  if (table > (long long)kMaxTiles * kTileBins) {
    err = cudaMemsetAsync(out, 0, total * sizeof(float), stream);
    if (err != cudaSuccess || n == 0) return (int)err;
    const long long want = ceil_div(n, kThreads);
    const long long cap = ceil_div(8LL * d->sms, nrow);
    const dim3 grid((unsigned)(want < cap ? want : cap), (unsigned)nrow);
    if (rows)
      hist_global<true><<<grid, kThreads, 0, stream>>>(j);
    else
      hist_global<false><<<grid, kThreads, 0, stream>>>(j);
    return (int)cudaGetLastError();
  }

  j.tiles = tiles_of(table);
  const long long groups = nrow * j.tiles;
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  const int bins = (int)(table < kTileBins ? table : kTileBins);
  if (j.tiles == 1 && (long long)bins * kSubTables <= kTileBins)
    j.copies = kSubTables;
  // one block a group at least; more while each still has a full iteration
  const bool vec =
      rows || ((reinterpret_cast<std::uintptr_t>(t) ^
                reinterpret_cast<std::uintptr_t>(y)) & 15u) == 0;
  const long long iters =
      ceil_div(vec ? n / 4 : n, (long long)kThreads * kUnroll);
  long long per_group = ceil_div((long long)kBlocksPerSm * d->sms, groups);
  if (per_group > iters) per_group = iters;
  if (per_group < 1) per_group = 1;
  if (per_group > 1 && (scratch == nullptr || scratch_len < total + groups))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)per_group, (unsigned)groups);
  const size_t smem = (size_t)j.copies * bins * sizeof(unsigned int);
  if (rows)
    hist_tiles<true, true><<<grid, kThreads, smem, stream>>>(j);
  else if (vec)
    hist_tiles<false, true><<<grid, kThreads, smem, stream>>>(j);
  else
    hist_tiles<false, false><<<grid, kThreads, smem, stream>>>(j);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Length (u32 elements) of the scratch a launch at this table shape may use:
// the table's sums and one ticket counter a group; 0 for the global path.
// The caller keeps the scratch zeroed before its first launch; every launch
// leaves it zero.
long long histogram_scratch_len(int rows, int nt, int ny) {
  const long long total = (long long)nt * ny;
  const long long table = rows ? ny : total;
  if (table > (long long)kMaxTiles * kTileBins) return 0;
  return total + (rows ? nt : 1) * (long long)tiles_of(table);
}

// y: (nrow, n) int32 contiguous; out: (nrow, ny) float32, written in full on
// `stream` of `device`.
int histogram_rows_launch(const int* y, int nrow, long long n, int ny,
                          unsigned int* scratch, long long scratch_len,
                          float* out, int device, void* stream) {
  return launch(true, nullptr, y, n, nrow, ny, scratch, scratch_len, out,
                device, stream);
}

// t, y: n int32 each; out: (nt, ny) float32, written in full on `stream` of
// `device`.
int histogram2d_launch(const int* t, const int* y, long long n, int nt,
                       int ny, unsigned int* scratch, long long scratch_len,
                       float* out, int device, void* stream) {
  return launch(false, t, y, n, nt, ny, scratch, scratch_len, out, device,
                stream);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
