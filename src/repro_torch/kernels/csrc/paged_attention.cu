// Paged decode attention for Hopper (sm_90a), as a split-K decode.
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
// Bound: bytes. Each valid K and V row of a lane's pages is read once
// (2 * valid_tokens * nkv * dh * itemsize per lane), and the group of g
// query heads does 2 * g multiply-adds per K/V element: about 4 operations
// per byte in bf16 at g = 8, against the ~295 per byte at which the H100's
// tensor cores, not its memory, would be the limit. So the tensor cores
// would sit idle here whatever the kernel did; the design is about keeping
// enough bytes in flight, and the arithmetic runs on the CUDA cores in f32.
//
// Design:
//  * Split K. A (lane, KV head) pair gets n_split CTAs, each over a
//    contiguous split of `per` table entries; the wrapper chooses the split
//    from the table width and the SM count (`paged_attention.split_plan`)
//    so that the yi-6b serving shape (32 lanes x 4 KV heads x 32 entries)
//    launches 4 splits of 8 entries: 512 CTAs, about 4 per SM.
//  * Inside a CTA, four warps take the split's work units in turn, each
//    unit a chunk of up to CH tokens of one page (half a 16-token page in
//    bf16 at dh 128, a quarter in f32: 2 KiB of K and 2 of V). There is no
//    block barrier per unit. A warp copies its unit's K and V rows into its own two-stage
//    ring in shared memory with 16-byte `cp.async` (a warp reads 512 B per
//    instruction), and issues the next unit's copies before it computes
//    the current one. Entries that are -1 or hold no valid token cost only
//    the table read.
//  * Lanes split dh: a team of LPR = dh / (16 B / itemsize) lanes covers a
//    row, and a warp's 32 / LPR teams share out the g query heads, each
//    lane holding its dh slice of q and of the f32 accumulator for its
//    team's heads. A team reduces its heads' dot products by halving (each
//    shuffle sends half of the partial sums to the partner lane), HPT - 1 +
//    log2(LPR / HPT) shuffles for HPT heads. Scores go through a small
//    per-warp buffer, where the whole warp takes the unit's softmax, a few
//    lanes per head: max, correction and sum once per unit and head, each
//    probability computed once and rounded to the input type for the V
//    product (the running sum uses the unrounded values). Each warp keeps a
//    running (m, l, acc) per head, with the Pallas kernel's masked value
//    (-1e30) and corr = exp(m_prev - m_new).
//  * The four warps merge in shared memory once, at the end, and the CTA
//    writes its split's f32 (m, l, acc) to the partials. A second, small
//    kernel merges the splits with the log-sum-exp rescale and writes the
//    output in q's dtype. A split (or a lane) with no valid key has
//    m = -1e30 and l = 0 and adds weight 0; a lane of length 0 gets
//    0 / max(l, 1e-30) = 0 exactly.
//  * One template serves float32 and bfloat16 (and dh 16, 32, 64, 128).
//
// Resources (nvcc -Xptxas -v, sm_90a, dh 128): paged_split_kernel in bf16
// with 4 heads per team (g = 8) 104 registers, in f32 with 8 heads per team
// 114, no spills; 33.4 KiB of dynamic shared memory at g = 8 (the four
// warps' rings of 2 x 2 KiB per K or V unit, then the p buffers and running
// (m, l)); paged_combine_kernel 32 registers.
//
// C interface (pointers and the stream as void*, loaded with ctypes).
// `paged_attention` launches both kernels and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnitBytes = 2048;  // K (or V) bytes of one work unit at most
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

// the VEC elements of one 16-byte vector as floats
__device__ __forceinline__ void unpack(const uint4& u, float* f, const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f, const __nv_bfloat16*) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <typename T, int DH>
struct Shape {
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // elements per 16 B
  static constexpr int LPR = DH / VEC;                         // lanes per row (a team)
  static constexpr int TPW = 32 / LPR;                         // teams per warp
  static constexpr int CH_MAX = kUnitBytes / (DH * static_cast<int>(sizeof(T)));
  static constexpr int CH = CH_MAX < 16 ? CH_MAX : 16;         // tokens per unit at most
  static constexpr int STAGE = 2 * CH * DH;                    // K and V elements of a stage
  static constexpr size_t RING = sizeof(T) * kWarps * 2 * STAGE;  // the warps' rings, bytes
};

// One CTA per (split, KV head, lane). Shared memory: the warps' two-stage
// rings of K/V units (reused for the merge at the end), then for each warp
// its p buffer [g][CH] (scores, then rounded probabilities), its running
// (m, l) [g][2] and its corrections [g].
//
// Team t of a warp owns query heads t * HPT .. t * HPT + HPT - 1 (HPT a
// power of two, at most LPR). A dot product's HPT partial sums are reduced
// over the team's LPR lanes by halving: each step sends half of the values
// to the partner lane and keeps the other half, so HPT - 1 + log2(LPR /
// HPT) shuffles give lane x the full dot of head x * HPT / LPR.
template <typename T, int DH, int HPT>
__global__ void __launch_bounds__(kThreads, 4)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                   const T* __restrict__ v_pages, const int* __restrict__ tables,
                   const int* __restrict__ seq_lens, float* __restrict__ part_acc,
                   float* __restrict__ part_ml, int n_p, int per, int n_split, int page,
                   int nkv, int g, float sm_scale) {
  using S = Shape<T, DH>;
  constexpr int VEC = S::VEC, LPR = S::LPR, CH = S::CH;
  static_assert(HPT <= LPR, "a team reduces at most LPR heads");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int team = lane / LPR, x = lane % LPR;

  // the per-warp buffers follow the rings or the merge's [warp][g][DH], the larger
  const size_t xoff = S::RING > sizeof(float) * kWarps * g * DH ? S::RING
                                                                : sizeof(float) * kWarps * g * DH;
  T* ring = reinterpret_cast<T*>(smem_raw) + warp * 2 * S::STAGE;
  float* pbuf = reinterpret_cast<float*>(smem_raw + xoff) + warp * g * (CH + 3);
  float* wml = pbuf + g * CH;  // (m, l) per head
  float* corr = wml + 2 * g;

  const int nh = nkv * g;
  const long long row_stride = static_cast<long long>(nkv) * DH;  // one token
  const int len = seq_lens[b];
  const int* tab = tables + static_cast<long long>(b) * n_p;
  const int p0 = split * per;
  const int p1 = min(p0 + per, n_p);
  const int cpp = (page + CH - 1) / CH;  // units per page
  const int n_units = (p1 > p0 ? p1 - p0 : 0) * cpp;

  // this lane's dh slice of q and of the accumulator for its team's heads
  const int h0 = team * HPT;
  float qv[HPT][VEC], acc[HPT][VEC];
  const T* qb = q + (static_cast<long long>(b) * nh + static_cast<long long>(kvh) * g) * DH;
#pragma unroll
  for (int i = 0; i < HPT; ++i) {
    if (h0 + i < g) {
      const uint4 u = *reinterpret_cast<const uint4*>(qb + (h0 + i) * DH + x * VEC);
      unpack(u, qv[i], static_cast<const T*>(nullptr));
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qv[i][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;
  }
  for (int h = lane; h < g; h += 32) {
    wml[2 * h] = kNegInf;
    wml[2 * h + 1] = 0.f;
  }
  // the softmax spreads a unit's g x n scores over the warp: sl lanes a head
  int g2 = 1;
  while (g2 < g && g2 < 32) g2 *= 2;
  const int sl = 32 / g2, heads_per_pass = 32 / sl;
  const int passes = (g + heads_per_pass - 1) / heads_per_pass;
  const int hsel = x * HPT / LPR;               // the head this lane's dot ends in
  const bool writer = x % (LPR / HPT) == 0;     // one lane of each head writes it

  // unit u: entry p0 + u / cpp, tokens [t0, t0 + n) of its page
  auto unit_of = [&](int u, long long& base, int& n) -> bool {
    const int p = p0 + u / cpp;
    const int pid = tab[p];
    const int t0 = (u % cpp) * CH;
    int valid = len - p * page;
    valid = valid < 0 ? 0 : (valid > page ? page : valid);
    n = valid - t0;
    n = n > CH ? CH : n;
    if (pid < 0 || n <= 0) return false;
    base = (static_cast<long long>(pid) * page + t0) * row_stride + static_cast<long long>(kvh) * DH;
    return true;
  };
  auto next_unit = [&](int u, long long& base, int& n) -> int {
    while (u < n_units && !unit_of(u, base, n)) u += kWarps;
    return u;
  };
  // copy n rows of K and V into a stage: lane -> (row lane / LPR, vector x)
  auto issue = [&](T* stage, long long base, int n) {
    for (int r = team; r < n; r += S::TPW) {
      const long long off = base + r * row_stride + x * VEC;
      cp_async16(stage + r * DH + x * VEC, k_pages + off);
      cp_async16(stage + CH * DH + r * DH + x * VEC, v_pages + off);
    }
  };

  long long base = 0, base_next = 0;
  int n = 0, n_next = 0;
  int u = next_unit(warp, base, n);
  if (u < n_units) issue(ring, base, n);
  cp_async_commit();
  __syncwarp();
  int st = 0;
  while (u < n_units) {
    const int un = next_unit(u + kWarps, base_next, n_next);
    if (un < n_units) issue(ring + (st ^ 1) * S::STAGE, base_next, n_next);
    cp_async_commit();
    cp_async_wait_1();  // this unit's copies have landed
    __syncwarp();
    const T* ks = ring + st * S::STAGE;
    const T* vs = ks + CH * DH;

    // scores of the unit's n tokens, scaled, into pbuf[h][t]
#pragma unroll
    for (int t = 0; t < CH; ++t) {
      if (t < n) {
        float kf[VEC], v[HPT];
        unpack(*reinterpret_cast<const uint4*>(ks + t * DH + x * VEC), kf,
               static_cast<const T*>(nullptr));
#pragma unroll
        for (int i = 0; i < HPT; ++i) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot = fmaf(qv[i][e], kf[e], dot);
          v[i] = dot;
        }
#pragma unroll
        for (int s = 0; (HPT >> s) > 1; ++s) {
          const int half = HPT >> (s + 1), o = LPR >> (s + 1);
          const bool upper = (x & o) != 0;
#pragma unroll
          for (int k = 0; k < half; ++k) {
            const float send = upper ? v[k] : v[k + half];
            const float keep = upper ? v[k + half] : v[k];
            v[k] = keep + __shfl_xor_sync(0xffffffffu, send, o);
          }
        }
#pragma unroll
        for (int o = LPR / HPT / 2; o > 0; o >>= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
        if (writer && h0 + hsel < g) pbuf[(h0 + hsel) * CH + t] = v[0] * sm_scale;
      }
    }
    __syncwarp();

    // online softmax of the unit: sl lanes per head, sl-lane reductions
    for (int pass = 0; pass < passes; ++pass) {
      const int h = pass * heads_per_pass + lane / sl;
      const bool ok = h < g;
      float mx = kNegInf;
      if (ok)
        for (int t = lane % sl; t < n; t += sl) mx = fmaxf(mx, pbuf[h * CH + t]);
      for (int o = sl / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = ok ? wml[2 * h] : kNegInf;
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      if (ok)
        for (int t = lane % sl; t < n; t += sl) {
          const float e = expf(pbuf[h * CH + t] - m_new);
          sum += e;
          pbuf[h * CH + t] = round_to<T>(e);
        }
      for (int o = sl / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (ok && lane % sl == 0) {
        const float c = expf(m_old - m_new);
        corr[h] = c;
        wml[2 * h] = m_new;
        wml[2 * h + 1] = wml[2 * h + 1] * c + sum;
      }
    }
    __syncwarp();

    // acc = acc * corr + sum_t p_t v_t
#pragma unroll
    for (int i = 0; i < HPT; ++i) {
      const float c = h0 + i < g ? corr[h0 + i] : 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[i][e] *= c;
    }
#pragma unroll
    for (int t = 0; t < CH; ++t) {
      if (t < n) {
        float vf[VEC];
        unpack(*reinterpret_cast<const uint4*>(vs + t * DH + x * VEC), vf,
               static_cast<const T*>(nullptr));
#pragma unroll
        for (int i = 0; i < HPT; ++i) {
          const float p = h0 + i < g ? pbuf[(h0 + i) * CH + t] : 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[i][e] = fmaf(p, vf[e], acc[i][e]);
        }
      }
    }
    __syncwarp();  // the stage and the p buffer are free again
    u = un;
    base = base_next;
    n = n_next;
    st ^= 1;
  }

  // merge the warps: their (m, l) stay in wml; acc goes to [warp][g][DH]
  // over the rings
  __syncthreads();
  float* wacc = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int i = 0; i < HPT; ++i) {
    if (h0 + i < g) {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        wacc[(warp * g + h0 + i) * DH + x * VEC + e] = acc[i][e];
    }
  }
  __syncthreads();
  const float* ml0 = reinterpret_cast<const float*>(smem_raw + xoff);
  const long long cta = (static_cast<long long>(b) * nkv + kvh) * n_split + split;
  for (int i = threadIdx.x; i < g * DH; i += kThreads) {
    const int h = i / DH, d = i % DH;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, ml0[w * g * (CH + 3) + g * CH + 2 * h]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* wm = ml0 + w * g * (CH + 3) + g * CH;
      const float c = expf(wm[2 * h] - M);
      L += wm[2 * h + 1] * c;
      A += wacc[(w * g + h) * DH + d] * c;
    }
    part_acc[cta * g * DH + i] = A;
    if (d == 0) {
      part_ml[(cta * g + h) * 2] = M;
      part_ml[(cta * g + h) * 2 + 1] = L;
    }
  }
}


// One CTA per (KV head, lane): merge the n_split partials of its g heads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                     T* __restrict__ out, int n_split, int nkv, int g, int dh) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  const long long first = (static_cast<long long>(b) * nkv + kvh) * n_split;
  T* ob = out + (static_cast<long long>(b) * nkv + kvh) * g * dh;
  for (int i = threadIdx.x; i < g * dh; i += kThreads) {
    const int h = i / dh;
    float M = kNegInf;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, part_ml[((first + s) * g + h) * 2]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float c = expf(part_ml[((first + s) * g + h) * 2] - M);
      L += part_ml[((first + s) * g + h) * 2 + 1] * c;
      A += part_acc[(first + s) * g * dh + i] * c;
    }
    ob[i] = from_f32<T>(A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int DH, int HPT>
int launch_split(const void* q, const void* k_pages, const void* v_pages, const void* tables,
                 const void* seq_lens, void* part_acc, void* part_ml, int B, int n_p, int per,
                 int n_split, int page, int nkv, int g, float sm_scale, cudaStream_t st) {
  using S = Shape<T, DH>;
  const size_t merge = sizeof(float) * kWarps * g * DH;
  const size_t smem = (S::RING > merge ? S::RING : merge) + sizeof(float) * kWarps * g * (S::CH + 3);
  auto kernel = paged_split_kernel<T, DH, HPT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(n_split, nkv, B);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      static_cast<const int*>(tables), static_cast<const int*>(seq_lens),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), n_p, per, n_split, page, nkv,
      g, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// heads per team: the smallest of 1, 2, 4, 8 that covers g and that a team of
// LPR lanes can reduce
template <typename T, int DH>
int launch_hpt(const void* q, const void* kp, const void* vp, const void* tables,
               const void* lens, void* pa, void* pml, int B, int n_p, int per, int n_split,
               int page, int nkv, int g, float sm_scale, cudaStream_t st) {
  const int hpt = (g + Shape<T, DH>::TPW - 1) / Shape<T, DH>::TPW;
#define PA_CASE(H)                                                                            \
  if constexpr (H <= Shape<T, DH>::LPR) {                                                     \
    if (hpt <= H)                                                                             \
      return launch_split<T, DH, H>(q, kp, vp, tables, lens, pa, pml, B, n_p, per, n_split, \
                                    page, nkv, g, sm_scale, st);                              \
  }
  PA_CASE(1)
  PA_CASE(2)
  PA_CASE(4)
  PA_CASE(8)
#undef PA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* tables, const void* lens,
           void* out, void* pa, void* pml, int B, int n_p, int per, int n_split, int page,
           int nkv, int dh, int g, float sm_scale, cudaStream_t st) {
  int err;
  switch (dh) {
    case 16:
      err = launch_hpt<T, 16>(q, kp, vp, tables, lens, pa, pml, B, n_p, per, n_split, page,
                              nkv, g, sm_scale, st);
      break;
    case 32:
      err = launch_hpt<T, 32>(q, kp, vp, tables, lens, pa, pml, B, n_p, per, n_split, page,
                              nkv, g, sm_scale, st);
      break;
    case 64:
      err = launch_hpt<T, 64>(q, kp, vp, tables, lens, pa, pml, B, n_p, per, n_split, page,
                              nkv, g, sm_scale, st);
      break;
    case 128:
      err = launch_hpt<T, 128>(q, kp, vp, tables, lens, pa, pml, B, n_p, per, n_split, page,
                               nkv, g, sm_scale, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  paged_combine_kernel<T><<<dim3(nkv, B), kThreads, 0, st>>>(
      static_cast<const float*>(pa), static_cast<const float*>(pml), static_cast<T*>(out),
      n_split, nkv, g, dh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q [B, nkv*g, dh]; pools [P, page, nkv,
// dh]; tables i32 [B, n_p]; seq_lens i32 [B]; out [B, nkv*g, dh]; the f32
// partials part_acc [B, nkv, n_split, g, dh] and part_ml [B, nkv, n_split,
// g, 2] (m, l). Split s covers entries [s * per, min((s + 1) * per, n_p)).
// dh in {16, 32, 64, 128}; g at most 8 heads per team (see launch_hpt).
int paged_attention(const void* q, const void* k_pages, const void* v_pages,
                    const void* tables, const void* seq_lens, void* out, void* part_acc,
                    void* part_ml, int B, int n_p, int per, int n_split, int page, int nkv,
                    int dh, int g, float sm_scale, int dtype, void* stream) {
  if (B <= 0 || nkv <= 0 || g <= 0) return static_cast<int>(cudaGetLastError());
  if (n_split <= 0 || per <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, tables, seq_lens, out, part_acc, part_ml, B, n_p,
                         per, n_split, page, nkv, dh, g, sm_scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, tables, seq_lens, out, part_acc, part_ml,
                                 B, n_p, per, n_split, page, nkv, dh, g, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
