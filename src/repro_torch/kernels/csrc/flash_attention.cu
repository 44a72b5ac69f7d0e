// Causal GQA flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py:103):
//   out[b, h, i] = softmax_j(q[b, h, i] . k[b, h / g, j] / sqrt(dh)) v[b, h / g, j]
// with q [B, nh, Sq, dh], k/v [B, nkv, Skv, dh], g = nh / nkv (no KV
// expansion in memory). Queries are the last Sq positions of the key stream
// (suffix alignment, q_pos = Skv - Sq + i); causal keeps j <= q_pos, a
// sliding window w > 0 keeps j > q_pos - w.
//
// Bound: operations at prefill lengths. A causal call does about
// 2 * 2 * B * nh * dh * (Sq * Skv - Sq^2 / 2) flops against ~B * (nh * Sq +
// 2 * nkv * Skv) * dh * itemsize * 2 bytes; at S = 1,024 that is hundreds of
// operations per byte, above the H100's ~295 for bf16. The least time is the
// flops over the bf16 tensor-core peak (989 TFLOP/s).
//
// Design (a simple kernel that is right first; it computes on the CUDA
// cores in float32, not on the tensor cores, so it runs far above the
// bound):
//  * One block of 256 threads per (64-row q tile, query head, batch row).
//    The TPU grid carried the accumulators across its kv dimension in VMEM;
//    here the block loops over 64-key tiles of K and V, staged in shared
//    memory as float32 (K transposed, so a thread's column reads are
//    consecutive), with the online softmax of the Pallas kernel (masked
//    scores at -1e30, corr = exp(m_prev - m_new), l floored at 1e-30).
//  * Tiles wholly in the future (causal) or wholly older than the window
//    are skipped, as the Pallas kernel's `run` predicate does.
//  * Thread (ty, tx) of a 16 x 16 grid owns rows ty*4 .. ty*4+3 of the q
//    tile: score columns tx + 16*c and output columns tx + 16*c. A row's
//    max and sum are reduced over the 16 lanes that share it with shuffles;
//    probabilities go through shared memory for the product with V, rounded
//    to the input type first, as in the Pallas kernel.
//  * Blocks are issued last q tile first: under the causal mask the late
//    tiles have the most keys, so the long blocks start first.
//  * Shared memory for dh = 128 is 112.75 KiB, so two blocks fit on an SM.
//
// C interface (pointers and the stream as void*, loaded with ctypes).
// `flash_attention` returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;  // q rows per block
constexpr int kBN = 64;  // keys per tile
constexpr int kThreads = 256;
constexpr int kRows = 4;  // q rows per thread
constexpr int kCols = kBN / 16;  // score columns per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// reduce over the 16 lanes of a half-warp (the lanes sharing a row group)
__device__ __forceinline__ float half_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DH>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kBM) * DH + static_cast<size_t>(DH) * (kBN + 1) +
         static_cast<size_t>(kBN) * DH + static_cast<size_t>(kBM) * (kBN + 1);
}

// Shared memory, in floats: q [kBM][DH], k transposed [DH][kBN + 1],
// v [kBN][DH], p [kBM][kBN + 1].
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int nh, int nkv, int Sq,
                       int Skv, int causal, int window, float sm_scale) {
  constexpr int kOut = DH / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;
  float* skt = sq + kBM * DH;
  float* sv = skt + DH * (kBN + 1);
  float* sp = sv + kBN * DH;

  const int i_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (nh / nkv);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q_start = i_tile * kBM;
  const int q_offset = Skv - Sq;

  const T* qb = q + (static_cast<long long>(b) * nh + h) * Sq * DH;
  const T* kb = k + (static_cast<long long>(b) * nkv + kvh) * Skv * DH;
  const T* vb = v + (static_cast<long long>(b) * nkv + kvh) * Skv * DH;

  for (int i = tid; i < kBM * DH; i += kThreads) {
    const int r = i / DH;
    sq[i] = q_start + r < Sq ? to_f32(qb[static_cast<long long>(q_start) * DH + i]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[r][c] = 0.f;
  }

  const int q_first = q_offset + q_start;  // position of the tile's first row
  const int q_last = q_first + kBM - 1;
  const int n_tiles = (Skv + kBN - 1) / kBN;
  int j_end = n_tiles;
  if (causal) {
    const int last = q_last / kBN + 1;  // tiles with j * kBN <= q_last
    j_end = last < j_end ? last : j_end;
  }
  for (int j = 0; j < j_end; ++j) {
    const int kv_start = j * kBN;
    if (window > 0 && kv_start + kBN - 1 < q_first - window + 1) continue;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBN * DH; i += kThreads) {
      const int n = i / DH, d = i - n * DH;
      const bool in = kv_start + n < Skv;
      const long long g = static_cast<long long>(kv_start) * DH + i;
      skt[d * (kBN + 1) + n] = in ? to_f32(kb[g]) : 0.f;
      sv[i] = in ? to_f32(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) qv[r] = sq[(ty * kRows + r) * DH + d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = skt[d * (kBN + 1) + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

    float corr[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = ty * kRows + r;
      const int q_pos = q_first + row;
      bool keep[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int k_pos = kv_start + tx + 16 * c;
        bool ok = k_pos < Skv;
        if (causal) ok = ok && k_pos <= q_pos;
        if (window > 0) ok = ok && k_pos > q_pos - window;
        keep[c] = ok;
        s[r][c] = ok ? s[r][c] * sm_scale : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      mx = half_max(mx);
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float e = keep[c] ? expf(s[r][c] - m_new) : 0.f;
        sum += e;
        sp[row * (kBN + 1) + tx + 16 * c] = round_to<T>(e);
      }
      sum = half_sum(sum);
      corr[r] = expf(m[r] - m_new);
      l[r] = l[r] * corr[r] + sum;
      m[r] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[r][c] *= corr[r];
#pragma unroll 4
    for (int n = 0; n < kBN; ++n) {
      float pv[kRows], vv[kOut];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pv[r] = sp[(ty * kRows + r) * (kBN + 1) + n];
#pragma unroll
      for (int c = 0; c < kOut; ++c) vv[c] = sv[n * DH + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kOut; ++c) acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
    }
  }

  T* ob = out + (static_cast<long long>(b) * nh + h) * Sq * DH;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q_start + ty * kRows + r;
    if (row >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < kOut; ++c)
      ob[static_cast<long long>(row) * DH + tx + 16 * c] = from_f32<T>(acc[r][c] / den);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int B, int nh, int nkv,
           int Sq, int Skv, int causal, int window, float sm_scale, cudaStream_t st) {
  const size_t smem = sizeof(float) * smem_floats<DH>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((Sq + kBM - 1) / kBM, nh, B);
  flash_attention_kernel<T, DH><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), nh, nkv, Sq, Skv, causal, window, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* out, int B, int nh, int nkv,
              int Sq, int Skv, int dh, int causal, int window, float sm_scale, cudaStream_t st) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, out, B, nh, nkv, Sq, Skv, causal, window, sm_scale, st);
    case 32: return launch<T, 32>(q, k, v, out, B, nh, nkv, Sq, Skv, causal, window, sm_scale, st);
    case 64: return launch<T, 64>(q, k, v, out, B, nh, nkv, Sq, Skv, causal, window, sm_scale, st);
    case 128:
      return launch<T, 128>(q, k, v, out, B, nh, nkv, Sq, Skv, causal, window, sm_scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q [B, nh, Sq, dh]; k, v [B, nkv, Skv,
// dh]; out [B, nh, Sq, dh]; all contiguous. dh in {16, 32, 64, 128}.
int flash_attention(const void* q, const void* k, const void* v, void* out, int B, int nh,
                    int nkv, int Sq, int Skv, int dh, int causal, int window, float sm_scale,
                    int dtype, void* stream) {
  if (B <= 0 || nh <= 0 || Sq <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dh<float>(q, k, v, out, B, nh, nkv, Sq, Skv, dh, causal, window, sm_scale, st);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(q, k, v, out, B, nh, nkv, Sq, Skv, dh, causal, window,
                                    sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
