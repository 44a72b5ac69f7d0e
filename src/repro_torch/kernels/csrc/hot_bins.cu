// Hotness accumulate + bin (MaxMem §3.2), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `hot_bins` (src/repro/kernels/hot_bins.py:59):
//   counts_out[p] = counts_in[p] + #{i : ids[i] == p}      (ids < 0 ignored)
//   bins[p]       = clip(floor(log2 counts_out[p]) + 1, 0, num_bins - 1), 0 when <= 0
//
// Bound: bytes. Each id is read once (4 N bytes), each page's count read once
// and its count and bin written once (12 P bytes); the arithmetic is a few
// integer operations per element.
//
// Design: scatter is slow on a TPU, so the Pallas kernel compares every id
// against every page of its tile (dense compare-and-reduce, O(N * P) work).
// Hopper has fast atomics in L2, so this is an atomic histogram instead:
//  1. `histogram`: one thread per id (grid-stride) adds 1 to hist[id] with a
//     global atomicAdd. The [P] int32 histogram (4 MiB at P = 2^20) stays in
//     the 50 MB L2, so the atomics resolve there and not in HBM. Integer
//     atomics are exact, so the result is bit-equal whatever their order.
//  2. `add_and_bin`: one fused elementwise pass reads counts_in and hist,
//     writes counts_out and the bin, with __clz for floor(log2). With no ids
//     the pass reads counts_in alone (hist is skipped).
// The histogram is scratch the caller allocates; it is zeroed here with
// cudaMemsetAsync on the same stream. int32 addition wraps (unsigned add),
// as the reference's int32 arithmetic does.
//
// C interface (pointers and the stream as void*, loaded with ctypes); returns
// cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void histogram(const int* __restrict__ ids, long long n, int* __restrict__ hist,
                          int pages) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int id = ids[i];
    if (id >= 0 && id < pages) atomicAdd(hist + id, 1);
  }
}

__global__ void add_and_bin(const int* __restrict__ counts_in, const int* __restrict__ hist,
                            int* __restrict__ counts_out, int* __restrict__ bins, int pages,
                            int num_bins) {
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < pages; p += gridDim.x * blockDim.x) {
    unsigned int c = static_cast<unsigned int>(counts_in[p]);
    if (hist != nullptr) c += static_cast<unsigned int>(hist[p]);
    const int count = static_cast<int>(c);
    counts_out[p] = count;
    int b = count > 0 ? 32 - __clz(count) : 0;  // floor(log2 count) + 1
    if (b > num_bins - 1) b = num_bins - 1;
    if (b < 0) b = 0;
    bins[p] = b;
  }
}

int blocks_for(long long n, int per_sm) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long want = (n + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * per_sm;
  return static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
}

}  // namespace

extern "C" int hot_bins(const void* ids, long long n, const void* counts_in, void* hist,
                        void* counts_out, void* bins, int pages, int num_bins, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pages <= 0) return static_cast<int>(cudaGetLastError());
  int* h = nullptr;
  if (n > 0) {
    h = static_cast<int*>(hist);
    cudaError_t err = cudaMemsetAsync(h, 0, sizeof(int) * static_cast<size_t>(pages), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    histogram<<<blocks_for(n, 16), kThreads, 0, st>>>(static_cast<const int*>(ids), n, h, pages);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  add_and_bin<<<blocks_for(pages, 16), kThreads, 0, st>>>(
      static_cast<const int*>(counts_in), h, static_cast<int*>(counts_out),
      static_cast<int*>(bins), pages, num_bins);
  return static_cast<int>(cudaGetLastError());
}
