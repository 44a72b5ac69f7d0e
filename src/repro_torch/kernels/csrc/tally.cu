// Integer tally: a scatter-add of int64 values onto a small table, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's policy tick adds with XLA
// scatters (`.at[idx].add(v, mode="drop")`), and the port first called
// PyTorch's `scatter_add`. Contract (`kernels/ref.tally_ref`):
//   out[s] = sum of values[i] over the entries i whose slot is s, int64[size],
// an entry's slot being idx[i], plus `size` once when idx[i] < 0, and the
// entry dropped when that is still outside [0, size); values default to ones.
// Sums wrap modulo 2^64 as int64 addition does.
//
// Bound: bytes. Each entry's index (8 B) and value (8 B, none for ones) are
// read once and the table written once: about 0.08 ms for the MaxMem tick's
// three calls over 8,388,608 pages at 3.35 TB/s.
//
// What stands in the way is contention, not bytes: the tick's tables are
// small (16 and 32 slots) or their used slots few (a candidate histogram of
// 131,073 slots in which nearly every page has a count of 0 or 1), so
// millions of entries land on one to four slots. PyTorch's scatter_add
// issues one global atomic an entry, and same-address atomics serialise in
// L2: 16.6-17.1 ms an epoch for the three calls, about 0.5% of the bound.
//
// Design:
//  1. A persistent grid sized from the entries and the SM count, two blocks
//     an SM at most, one block below kPerBlock entries; a grid-stride loop
//     with kUnroll loads in flight a thread.
//  2. Each block keeps a private copy of the table's first `window` slots in
//     shared memory as 64-bit counters: the whole table when it fits
//     (kWindow slots, 47 KiB), else as much as fits. A table read as rows of
//     `width` slots (the tick's histogram: a row a (tenant, tier), a column a
//     count) is windowed down its columns, slot s at position
//     (s % width) * rows + s / width, so the low counts of every row, where
//     nearly every page lies, are private whatever the row.
//  3. Within a warp, equal slots are combined first (__match_any_sync); the
//     group's leader adds the group's sum (its lane count for ones; else the
//     values in three 22-bit pieces, each summed exactly in 32 bits by
//     __reduce_add_sync) with one shared atomic. A hot slot costs one shared
//     atomic a warp, not 32.
//  4. A value of 0 adds nothing and is skipped.
//  5. At the end each block adds each non-zero private counter to the output
//     with one global atomic. An entry whose position lies beyond the window
//     takes a warp-combined global atomic at once, and is counted.
// The output is zeroed by a memset on the same stream before the launch.
// Integer sums are exact whatever their order, so the result is bit-equal
// to the plain version's.
//
// Counters: `counts` (int64[2] on the card) gains, with one atomic a block,
// the entries read and the entries that went to global atomics.
//
// C interface (pointers and the stream as void*, loaded with ctypes);
// `tally` returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 512;
constexpr int kWarp = 32;
constexpr int kUnroll = 4;                         // loads in flight a thread
constexpr long long kWindow = 6000;  // private slots a block: 47 KiB, under the 48 KiB of
                                     // shared memory a launch gets without opting in
constexpr long long kPerBlock = 16LL * kThreads;   // entries a block takes at least
constexpr int kBlocksPerSm = 2;
constexpr int kMaxDevices = 64;
constexpr long long kDropped = -(1LL << 62);       // a slot every entry past the end gets

// The sum over the lanes of `group` of v, modulo 2^64.
__device__ __forceinline__ u64 group_sum(unsigned group, u64 v) {
  const unsigned lo = __reduce_add_sync(group, static_cast<unsigned>(v & 0x3FFFFFu));
  const unsigned mid = __reduce_add_sync(group, static_cast<unsigned>((v >> 22) & 0x3FFFFFu));
  const unsigned hi = __reduce_add_sync(group, static_cast<unsigned>(v >> 44));
  return static_cast<u64>(lo) + (static_cast<u64>(mid) << 22) + (static_cast<u64>(hi) << 44);
}

__global__ void __launch_bounds__(kThreads)
    tally_kernel(const long long* __restrict__ idx, const long long* __restrict__ vals,
                 long long n, long long size, long long width, long long rows, int window,
                 u64* __restrict__ out, u64* __restrict__ counts) {
  extern __shared__ u64 priv[];  // [window]
  __shared__ u64 block_counts[2];
  for (int p = threadIdx.x; p < window; p += blockDim.x) priv[p] = 0;
  if (threadIdx.x < 2) block_counts[threadIdx.x] = 0;
  __syncthreads();

  const int lane = threadIdx.x & (kWarp - 1);
  const unsigned cols = static_cast<unsigned>(width);
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  unsigned seen = 0, spilled = 0;
  // a warp goes on while its first entry is in range, so that all 32 lanes
  // reach the match and the reductions
  for (long long base = tid; base - lane < n; base += kUnroll * stride) {
    long long k[kUnroll];
    u64 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      const bool in = i < n;
      seen += in;
      k[u] = in ? idx[i] : kDropped;
      v[u] = in ? (vals ? static_cast<u64>(vals[i]) : 1ull) : 0ull;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long s = k[u] < 0 ? k[u] + size : k[u];
      const bool ok = v[u] != 0 && s >= 0 && s < size;
      // slots are below 2^31: matched, divided and indexed in 32 bits
      const unsigned slot = static_cast<unsigned>(s);
      const unsigned group = __match_any_sync(0xffffffffu, ok ? static_cast<int>(slot) : -1);
      if (!ok) continue;
      const u64 sum = vals ? group_sum(group, v[u]) : static_cast<u64>(__popc(group));
      if (lane != __ffs(group) - 1) continue;
      const long long p =
          rows == 1 ? slot : static_cast<long long>(slot % cols) * rows + slot / cols;
      if (p < window) {
        atomicAdd(priv + p, sum);
      } else {
        atomicAdd(out + slot, sum);
        spilled += __popc(group);
      }
    }
  }
  seen = __reduce_add_sync(0xffffffffu, seen);
  spilled = __reduce_add_sync(0xffffffffu, spilled);
  if (lane == 0) {
    atomicAdd(block_counts, static_cast<u64>(seen));
    atomicAdd(block_counts + 1, static_cast<u64>(spilled));
  }
  __syncthreads();

  for (int p = threadIdx.x; p < window; p += blockDim.x) {
    const u64 c = priv[p];
    if (c != 0) {
      const unsigned q = static_cast<unsigned>(p), r = static_cast<unsigned>(rows);
      atomicAdd(out + (rows == 1 ? q : static_cast<long long>(q % r) * cols + q / r), c);
    }
  }
  if (threadIdx.x == 0) {
    if (block_counts[0] != 0) atomicAdd(counts, block_counts[0]);
    if (block_counts[1] != 0) atomicAdd(counts + 1, block_counts[1]);
  }
}

int sm_count() {
  static int sms[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 132;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    sms[dev] = 0;
    return 132;
  }
  return sms[dev];
}

long long rows_of(long long size, long long width) { return (size + width - 1) / width; }

}  // namespace

// Private slots a block keeps for a table of `size` slots read as rows of
// `width` (width >= 1).
extern "C" long long tally_window(long long size, long long width) {
  const long long slots = rows_of(size, width) * width;
  return slots < kWindow ? slots : kWindow;
}

// out (int64[size]) = the tally of the n entries of idx (int64), with the
// int64 `values`, or ones when `values` is null; `counts` (int64[2]) gains
// the entries read and those that went to global atomics.
extern "C" int tally(const void* idx, const void* values, long long n, long long size,
                     long long width, void* out, void* counts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(size) * sizeof(u64), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = rows_of(size, width);
  const int window = static_cast<int>(tally_window(size, width));
  const long long want = (n + kPerBlock - 1) / kPerBlock;
  const long long most = static_cast<long long>(sm_count()) * kBlocksPerSm;
  const int grid = static_cast<int>(want < 1 ? 1 : (want < most ? want : most));
  tally_kernel<<<grid, kThreads, static_cast<size_t>(window) * sizeof(u64), st>>>(
      static_cast<const long long*>(idx), static_cast<const long long*>(values), n, size, width,
      rows, window, static_cast<u64*>(out), static_cast<u64*>(counts));
  return static_cast<int>(cudaGetLastError());
}
