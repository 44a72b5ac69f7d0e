// Hotness accumulate + bin (MaxMem §3.2), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `hot_bins` (src/repro/kernels/hot_bins.py:59):
//   counts_out[p] = counts_in[p] + #{i : ids[i] == p}      (ids < 0 or >= P ignored)
//   bins[p]       = clip(floor(log2 counts_out[p]) + 1, 0, num_bins - 1), 0 when <= 0
//
// Bound: bytes. Each id is read once (4 N bytes), each page's count read once
// and its count and bin written once (12 P bytes); the arithmetic is a few
// integer operations per element.
//
// Design: scatter is slow on a TPU, so the Pallas kernel compares every id
// against every page of its tile (dense compare-and-reduce, O(N * P) work).
// Hopper has fast atomics in L2, so the ids are added with atomics, straight
// into counts_out: no histogram, no memset and no read-back of one. One
// cooperative kernel, a persistent grid of one 1024-thread block per SM, runs
// three phases with a grid barrier between them:
//  1. each thread loads its first kIds ids into registers (their read then
//     overlaps this phase), and the grid copies counts_in into counts_out,
//     16-byte vectors, kDepth loads in flight per thread (a scalar tail when
//     P is not a multiple of 4 or a pointer is not 16-byte aligned);
//  2. add the ids into counts_out with atomics. A warp holds 32 consecutive
//     ids; each run of equal ids among them (the sampler's ids arrive sorted,
//     one run per page) is added by its first lane with one atomic of the
//     run's length (a shuffle finds the run heads, a ballot their ends). On
//     unsorted ids every lane whose neighbour differs adds its own run: still
//     exact. Ids past the registers' share are read in a grid-stride loop;
//  3. bin counts_out into bins, 16-byte vectors, kDepth deep. counts_out (4 MiB at
//     P = 2^20) was written and updated in phases 1 and 2 and still sits in
//     the 50 MB L2, so this pass reads it from there. Phases 1 and 3 go
//     through L2 only (__stcg / __ldcg), never a stale L1 line.
// The card chose this shape (H100, 531,470 ids over 2^20 pages): run heads
// beat __match_any_sync grouping (which cost more than it saved: the runs
// are short) and plain per-id atomics; one block per SM beat 4-8 smaller
// blocks per SM (a cheaper barrier); three plain launches cost more; so did
// splitting the pages in two halves to overlap one half's atomics with the
// other's copy and binning (a third barrier).
// Integer atomics are exact, so the result is bit-equal whatever their order;
// int32 addition wraps (the atomics and the copy are two's complement), as the
// reference's int32 arithmetic does.
//
// C interface (pointers and the stream as void*, loaded with ctypes); returns
// cudaGetLastError() after the launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarp = 32;
constexpr int kIds = 4;    // ids per thread read before the copy phase
constexpr int kDepth = 4;  // 16-byte loads in flight per thread in the page passes

__device__ __forceinline__ int bin_of(int count, int num_bins) {
  int b = count > 0 ? 32 - __clz(count) : 0;  // floor(log2 count) + 1
  return b < num_bins - 1 ? b : num_bins - 1;
}

__device__ __forceinline__ int4 bins_of(int4 c, int num_bins) {
  return make_int4(bin_of(c.x, num_bins), bin_of(c.y, num_bins), bin_of(c.z, num_bins),
                   bin_of(c.w, num_bins));
}

// Adds a warp's 32 ids (one per lane; `ok` false for ids outside [0, pages))
// into counts, one atomic per run of equal ids.
__device__ __forceinline__ void add_runs(int* __restrict__ counts, int id, bool ok, int lane) {
  const int prev = __shfl_up_sync(0xffffffffu, id, 1);
  const bool head = ok && (lane == 0 || prev != id);
  const unsigned heads = __ballot_sync(0xffffffffu, head);
  const unsigned oks = __ballot_sync(0xffffffffu, ok);
  if (!head) return;
  const unsigned later = heads & ~((2u << lane) - 1u);  // heads after this lane
  const unsigned upto = later ? (1u << (__ffs(later) - 1)) - 1u : 0xffffffffu;
  atomicAdd(counts + id, __popc(oks & upto & ~((1u << lane) - 1u)));
}

// Pages [0, 4 * nv) as int4: counts_out = counts_in, through L2 only.
__device__ __forceinline__ void copy_pages(const int4* __restrict__ in4, int4* __restrict__ out4,
                                           long long nv, long long tid, long long stride) {
  for (long long v = tid; v < nv; v += kDepth * stride) {
    int4 c[kDepth];
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      if (v + u * stride < nv) c[u] = in4[v + u * stride];
    }
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      if (v + u * stride < nv) __stcg(out4 + v + u * stride, c[u]);
    }
  }
}

// Pages [0, 4 * nv) as int4: bins of counts_out, read from L2.
__device__ __forceinline__ void bin_pages(const int4* __restrict__ out4, int4* __restrict__ bins4,
                                          long long nv, long long tid, long long stride,
                                          int num_bins) {
  for (long long v = tid; v < nv; v += kDepth * stride) {
    int4 c[kDepth];
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      if (v + u * stride < nv) c[u] = __ldcg(out4 + v + u * stride);
    }
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      if (v + u * stride < nv) bins4[v + u * stride] = bins_of(c[u], num_bins);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    hot_bins_kernel(const int* __restrict__ ids, long long n, const int* __restrict__ counts_in,
                    int* __restrict__ counts_out, int* __restrict__ bins, int pages,
                    int num_bins, int vec) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int lane = threadIdx.x & (kWarp - 1);
  // pages [0, 4 * nv) go as int4, the rest one by one
  const long long nv = vec ? pages / 4 : 0;
  const int4* in4 = reinterpret_cast<const int4*>(counts_in);
  int4* out4 = reinterpret_cast<int4*>(counts_out);
  int4* bins4 = reinterpret_cast<int4*>(bins);
  int held[kIds];
#pragma unroll
  for (int k = 0; k < kIds; ++k) held[k] = tid + k * stride < n ? ids[tid + k * stride] : -1;
  copy_pages(in4, out4, nv, tid, stride);
  for (long long p = 4 * nv + tid; p < pages; p += stride) __stcg(counts_out + p, counts_in[p]);
  cg::grid_group grid = cg::this_grid();
  grid.sync();

  // a warp goes on while its first id is in range, so that all 32 lanes
  // reach the shuffle and the ballots
#pragma unroll
  for (int k = 0; k < kIds; ++k) {
    if (tid - lane + k * stride < n) {
      add_runs(counts_out, held[k], held[k] >= 0 && held[k] < pages, lane);
    }
  }
  for (long long i = tid + kIds * stride; i - lane < n; i += stride) {
    const int id = i < n ? ids[i] : -1;
    add_runs(counts_out, id, id >= 0 && id < pages, lane);
  }
  grid.sync();

  bin_pages(out4, bins4, nv, tid, stride, num_bins);
  for (long long p = 4 * nv + tid; p < pages; p += stride) {
    bins[p] = bin_of(__ldcg(counts_out + p), num_bins);
  }
}

// Blocks of the persistent grid: one per SM, fewer when the work is small.
// A grid that cannot be resident at once fails to launch (an error, not a
// hang).
int grid_for(long long items) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long want = (items + kThreads - 1) / kThreads;
  return static_cast<int>(want < sms ? (want > 0 ? want : 1) : sms);
}

}  // namespace

extern "C" int hot_bins(const void* ids, long long n, const void* counts_in, void* counts_out,
                        void* bins, int pages, int num_bins, void* stream) {
  if (pages <= 0) return static_cast<int>(cudaGetLastError());
  const int* id_p = static_cast<const int*>(ids);
  const int* in_p = static_cast<const int*>(counts_in);
  int* out_p = static_cast<int*>(counts_out);
  int* bins_p = static_cast<int*>(bins);
  int vec = ((reinterpret_cast<uintptr_t>(in_p) | reinterpret_cast<uintptr_t>(out_p) |
              reinterpret_cast<uintptr_t>(bins_p)) & 15) == 0;
  const long long items = n > pages / 4 ? n : pages / 4 + 3;
  void* args[] = {&id_p, &n, &in_p, &out_p, &bins_p, &pages, &num_bins, &vec};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(hot_bins_kernel), dim3(grid_for(items)), dim3(kThreads),
      args, 0, static_cast<cudaStream_t>(stream)));
}
