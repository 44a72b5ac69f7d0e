// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_attention`
// (src/repro/kernels/paged_attention.py:87): one query token per sequence
// attends over a pool of KV pages through a block table,
//   out[b, h] = softmax_k(q[b, h] . K[k] / sqrt(dh)) V[k]
// over the keys k of the pages tables[b, 0..n_p), where entry p holds
// clip(seq_lens[b] - p * page, 0, page) valid tokens and -1 entries are
// skipped. Query head h reads KV head h / g (g = nh / nkv). A row with no
// valid key returns 0.
//
// Bound: bytes. Each valid K and V row of the lane's pages is read once
// (2 * valid_tokens * nkv * dh * itemsize per lane) and the work per byte is
// two multiply-adds per query head of the group (g = 8 for yi-6b): far below
// the card's ~295 operations per byte. The least time is those bytes over
// HBM bandwidth (3.35 TB/s on an H100 SXM).
//
// Design (a simple kernel that is right first):
//  * One block per (KV head, lane): the g query heads of that KV head are
//    processed together, so each K/V page row is read from device memory
//    once for the whole group (GQA without expanding KV).
//  * The TPU grid walked pages in order with accumulators in VMEM; here the
//    block walks its table in a loop. For each run page it stages the page's
//    K and V rows of its KV head (page x dh) in shared memory as float32,
//    computes the g x page scores, and updates a running max, sum and f32
//    accumulator with the online softmax of the Pallas kernel (masked
//    scores at -1e30, corr = exp(m_prev - m_new)). Entries with a negative
//    page id or no valid token cost only the table read.
//  * Probabilities are rounded to the input type before the product with V,
//    as the Pallas kernel and the plain version do; the running sum uses the
//    unrounded values.
//  * The layer's pool is passed as a pointer to its contiguous [P, page,
//    nkv, dh] view; nothing is copied.
//
// C interface (pointers and the stream as void*, loaded with ctypes).
// `paged_attention` returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarp = 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T and back: the probabilities' rounding before the V product
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = kWarp / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory, in floats: q [g, dh+1], acc [g*dh], k [page, dh+1], v
// [page*dh], s [g*page], m [g], l [g], corr [g]. The q and k rows are padded
// by one float so the threads of a warp, which read different rows at the
// same column, hit different banks.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages, const int* __restrict__ tables,
                       const int* __restrict__ seq_lens, T* __restrict__ out, int n_p,
                       int page, int nkv, int dh, int g, float sm_scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;  // KV head
  const int b = blockIdx.y;  // lane
  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp, n_warps = kThreads / kWarp;
  const int gd = g * dh, pd = page * dh, dhp = dh + 1;
  float* sq = smem;
  float* acc = sq + g * dhp;
  float* sk = acc + gd;
  float* sv = sk + page * dhp;
  float* s = sv + pd;
  float* m = s + g * page;
  float* l = m + g;
  float* corr = l + g;

  const int nh = nkv * g;
  const T* qb = q + (static_cast<long long>(b) * nh + static_cast<long long>(h) * g) * dh;
  for (int i = tid; i < gd; i += kThreads) {
    sq[(i / dh) * dhp + i % dh] = to_f32(qb[i]);
    acc[i] = 0.f;
  }
  for (int i = tid; i < g; i += kThreads) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  const int len = seq_lens[b];
  const int* tab = tables + static_cast<long long>(b) * n_p;
  const long long row_stride = static_cast<long long>(nkv) * dh;  // one token

  for (int p = 0; p < n_p; ++p) {
    const int pid = tab[p];
    int n_valid = len - p * page;
    n_valid = n_valid < 0 ? 0 : (n_valid > page ? page : n_valid);
    if (pid < 0 || n_valid <= 0) continue;  // uniform across the block
    __syncthreads();  // the previous page's readers are done
    const long long base = static_cast<long long>(pid) * page * row_stride +
                           static_cast<long long>(h) * dh;
    for (int i = tid; i < pd; i += kThreads) {
      const int t = i / dh, d = i - t * dh;
      sk[t * dhp + d] = to_f32(k_pages[base + t * row_stride + d]);
      sv[i] = to_f32(v_pages[base + t * row_stride + d]);
    }
    __syncthreads();
    // scores s[j, t] = q_j . k_t * scale, masked beyond n_valid
    for (int i = tid; i < g * page; i += kThreads) {
      const int j = i / page, t = i - j * page;
      float dot = 0.f;
      const float* qr = sq + j * dhp;
      const float* kr = sk + t * dhp;
      for (int d = 0; d < dh; ++d) dot = fmaf(qr[d], kr[d], dot);
      s[i] = t < n_valid ? dot * sm_scale : kNegInf;
    }
    __syncthreads();
    // online softmax statistics: one warp per query head row
    for (int j = warp; j < g; j += n_warps) {
      float* sr = s + j * page;
      float mx = kNegInf;
      for (int t = lane; t < page; t += kWarp) mx = fmaxf(mx, sr[t]);
      mx = warp_max(mx);
      const float m_prev = m[j];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += kWarp) {
        const float e = t < n_valid ? expf(sr[t] - m_new) : 0.f;
        sum += e;
        sr[t] = round_to<T>(e);
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        corr[j] = c;
        l[j] = l[j] * c + sum;
        m[j] = m_new;
      }
    }
    __syncthreads();
    // acc[j, d] = acc[j, d] * corr[j] + sum_t p[j, t] v[t, d]
    for (int i = tid; i < gd; i += kThreads) {
      const int j = i / dh, d = i - j * dh;
      const float* pr = s + j * page;
      float a = acc[i] * corr[j];
      for (int t = 0; t < n_valid; ++t) a = fmaf(pr[t], sv[t * dh + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();
  T* ob = out + (static_cast<long long>(b) * nh + static_cast<long long>(h) * g) * dh;
  for (int i = tid; i < gd; i += kThreads) {
    const float den = fmaxf(l[i / dh], 1e-30f);
    ob[i] = from_f32<T>(acc[i] / den);
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages, const void* tables,
           const void* seq_lens, void* out, int B, int n_p, int page, int nkv, int dh, int g,
           float sm_scale, cudaStream_t st) {
  const size_t ng = g, nt = page, nd = dh;
  const size_t smem = sizeof(float) * (ng * (2 * nd + 1) + nt * (2 * nd + 1) + ng * nt + 3 * ng);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(paged_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(nkv, B);
  paged_attention_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      static_cast<const int*>(tables), static_cast<const int*>(seq_lens), static_cast<T*>(out),
      n_p, page, nkv, dh, g, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q [B, nkv*g, dh]; pools [P, page, nkv,
// dh]; tables i32 [B, n_p]; seq_lens i32 [B]; out [B, nkv*g, dh].
int paged_attention(const void* q, const void* k_pages, const void* v_pages,
                    const void* tables, const void* seq_lens, void* out, int B, int n_p,
                    int page, int nkv, int dh, int g, float sm_scale, int dtype, void* stream) {
  if (B <= 0 || nkv <= 0 || g <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, tables, seq_lens, out, B, n_p, page, nkv, dh, g,
                         sm_scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, tables, seq_lens, out, B, n_p, page,
                                 nkv, dh, g, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
