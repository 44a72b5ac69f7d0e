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
// flops over the bf16 tensor-core peak (989 TFLOP/s), so the bf16 kernel
// computes both products on the tensor cores.
//
// bfloat16 (the serving path's type): `flash_attention_hopper`.
//  * A CTA per (64 query rows (wgmma's M), query head, batch row): one
//    consumer warpgroup owns the 64 rows, one producer warp issues the
//    loads, two CTAs share an SM (one's softmax runs under the other's
//    products). CTAs are numbered late q tiles first: under the causal
//    mask those have the most keys, so the long ones start first.
//  * Loads: TMA (`cp.async.bulk.tensor`), completing on mbarriers: Q once,
//    K and V tiles of 64 keys into a ring of 2 stages, K and V with
//    barriers of their own (full: the producer's expect_tx; empty: one
//    arrival per consumer warp), the phase bit tracked per round of the
//    ring. The tensor maps are 3-D (dh, position, batch x head), so rows
//    past Sq or Skv read as zeros and never reach another head, built on
//    the host with cuTensorMapEncodeTiled reached through
//    cudaGetDriverEntryPoint (no -lcuda) and passed as __grid_constant__
//    parameters. A box is 64 rows by one swizzle span (128 B = 64 values
//    at dh >= 64, 64 B at dh 32, 32 B at dh 16): dh 128 is two column
//    blocks.
//  * S = Q K^T: `wgmma.mma_async m64n64k16 .f32.bf16.bf16`, both operands
//    K-major in shared memory (descriptors in the TMA's swizzle mode), the
//    f32 accumulator in registers.
//  * Online softmax in registers, in log2 units on the special-function
//    unit: the masked value -1e30, corr = exp(m_prev - m_new), l floored at
//    1e-30 at the end. Masks are applied only on tiles that cross the
//    diagonal, the window's edge or Skv; tiles wholly in the future or
//    wholly older than the window are never loaded.
//  * O += P V: a second wgmma, m64n{dh}k16, with P converted to bf16 in
//    registers (the S accumulator's layout is the A fragment's, so P is fed
//    from registers with no trip through shared memory; the rounding of P
//    to the input type is the Pallas kernel's and the plain version's) and
//    V from shared memory MN-major, through the descriptor's transpose bit.
//    It runs on the tensor cores while the next tile's S is issued behind
//    it; one wait covers both.
//  * Store: the consumer normalises o, writes bf16 into the Q tile (read
//    for the last time) in the maps' swizzled layout and sends it out with
//    a TMA store; rows past Sq are clipped by the map.
//  * No wgmma sits in a branch and no register of a product in flight is
//    written: ptxas would serialise the products (its C7511-C7520 notes).
//
// float32: `flash_attention_kernel`, on the CUDA cores in f32. The f32
// tolerance of 2e-5 rules out TF32 on the tensor cores. One block of 256
// threads per (64-row q tile, query head, batch row) loops over 64-key tiles
// staged in shared memory as float32 (K transposed), with the same online
// softmax; thread (ty, tx) of a 16 x 16 grid owns 4 rows; probabilities go
// through shared memory for the product with V.
//
// Resources (nvcc -Xptxas -v, sm_90a, dh 128): flash_attention_hopper 168
// registers, no spills, 81.1 KiB of dynamic shared memory (Q 16 + 2 stages
// of K and V 64 + 1 of alignment); flash_attention_kernel<float> 122
// registers, no spills, 112.75 KiB.
//
// C interface (pointers and the stream as void*, loaded with ctypes).
// `flash_attention` returns cudaGetLastError() after its launch.

#include <cuda.h>  // CUtensorMap and its enums only: no -lcuda, the encoder is looked up
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

// ---------------------------------------------------------------------------
// bfloat16: the Hopper kernel (TMA loads, wgmma on the tensor cores)
// ---------------------------------------------------------------------------


// The shared-memory layout of a [64 x DH] bf16 tile as TMA writes it with
// a swizzle of RB bytes: DH / AC column blocks of [64 rows][AC columns],
// each row RB bytes, 8-row groups RB * 8 bytes apart.
template <int DH>
struct Tile {
  static constexpr int RB = DH * 2 < 128 ? DH * 2 : 128;  // swizzle span, bytes
  static constexpr int AC = RB / 2;                        // columns of a block
  static constexpr int NBLK = DH / AC;                     // blocks across dh
  static constexpr int BYTES = 64 * DH * 2;                // q, k or v tile
  static constexpr uint64_t LAYOUT = RB == 128 ? 1 : (RB == 64 ? 2 : 3);  // wgmma swizzle
  static constexpr int STAGES = 2;  // of the K/V ring
  // shared memory: the Q tile (then O), the stages of (K, V), the
  // barriers; 1 KiB aligned
  static constexpr size_t SMEM = 1024 + static_cast<size_t>(BYTES) * (1 + 2 * STAGES) + 128;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// the consumer warpgroup's own barrier (named barrier 1, 128 threads)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}
// one arrival per warp, once every lane of it is past this point (the
// consumer barriers count warps: 128 arrivals on one word would serialise)
__device__ __forceinline__ void warp_arrive(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}
// Wait for the phase of parity `parity` to complete. A wait that outlasts
// 2^26 polls (seconds) traps, so a fault in the pipeline surfaces as a
// launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
  }
}
// one [1 x 64 x AC] box at (column c0, row c1, head c2), completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// the same box from shared memory out to the tensor (a bulk group)
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode. K-major operands (Q, K) in
// a swizzled layout ignore the leading offset; their 8-row groups are
// RB * 8 bytes apart. For the MN-major V the leading offset is the stride
// between column blocks along dh, the stride offset the one between
// 8-key groups.
template <int DH>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(((8 * Tile<DH>::RB) >> 4) & 0x3FFF) << 32) |
         (Tile<DH>::LAYOUT << 62);
}
// K-major tile of 64 rows, k-step kk (16 columns): the column block and the
// 32-byte step inside its swizzled rows
template <int DH>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t base, int kk) {
  using L = Tile<DH>;
  const int col = kk * 16;
  return make_desc<DH>(base + (col / L::AC) * 64 * L::RB + (col % L::AC) * 2, 16);
}
// MN-major V tile, keys 16 kk .. 16 kk + 15
template <int DH>
__device__ __forceinline__ uint64_t vmajor_desc(uint32_t base, int kk) {
  using L = Tile<DH>;
  return make_desc<DH>(base + kk * 16 * L::RB, 64 * L::RB);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin registers that an asynchronous wgmma writes or reads: the compiler
// may not move their reads, or reuse them, across this point.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]));
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], both operands in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 16] += A[64 x 16] B[16 x 16]: A from registers, B in shared memory MN-major
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 32] += A[64 x 16] B[16 x 32]: A from registers, B in shared memory MN-major
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A from registers, B in shared memory MN-major
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]: A from registers, B in shared memory MN-major
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&o)[DH / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DH == 16) wgmma_rs_n16(o, a, db);
  if constexpr (DH == 32) wgmma_rs_n32(o, a, db);
  if constexpr (DH == 64) wgmma_rs_n64(o, a, db);
  if constexpr (DH == 128) wgmma_rs_n128(o, a, db);
}

// 2^x on the special-function unit (flushes denormal results to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A CTA's work is one (query head, batch row, 64-row q tile); CTAs are
// numbered late q tiles first, since under the causal mask those have the
// most keys. Warps 0-3 are the consumer warpgroup, warp 4 the producer.
// Keys run in tiles of kBN = 64.
//
// Fragments of the consumer warpgroup (wgmma's m64 layout): thread
// (warp w, lane = 4 g + t) holds rows r0 = 16 w + g and r1 = r0 + 8; in the
// n8 column chunk j it holds columns 8 j + 2 t and 8 j + 2 t + 1, registers
// 4 j + 0/1 for r0 and 4 j + 2/3 for r1. The chunks 2 kk and 2 kk + 1 of S
// are exactly the A fragment of keys 16 kk .. 16 kk + 15 for P.V.
struct Item {
  int h, b, q_start, j_begin, n_tiles;
};

__device__ __forceinline__ Item item_of(int t, int nh, int B, int Sq, int Skv, int causal,
                                        int window) {
  const int n_qt = (Sq + kBM - 1) / kBM;
  Item it;
  const int per_tile = nh * B;
  it.q_start = (n_qt - 1 - t / per_tile) * kBM;
  it.b = (t % per_tile) / nh;
  it.h = t % nh;
  const int q_first = Skv - Sq + it.q_start, q_last = q_first + kBM - 1;
  int j_end = (Skv + kBN - 1) / kBN;
  if (causal) j_end = min(j_end, q_last < 0 ? 0 : q_last / kBN + 1);
  it.j_begin = 0;
  if (window > 0) {
    const int lo = q_first - window + 1;  // tiles ending before it are skipped
    it.j_begin = lo > 0 ? lo / kBN : 0;
  }
  it.n_tiles = j_end > it.j_begin ? j_end - it.j_begin : 0;
  return it;
}

template <int DH>
__global__ void __launch_bounds__(160, 2)
flash_attention_hopper(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap omap, int B, int nh, int nkv, int Sq,
                       int Skv, int causal, int window, float sm_scale) {
  using L = Tile<DH>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* sq = smem;  // Q, then O
  unsigned char* skv = sq + L::BYTES;  // stage s: K, V at 2 s, 2 s + 1
  // K and V have barriers of their own, so that K of tile j + 1 can land
  // while V of tile j - 1 is still read by the P.V product
  uint64_t* kfull = reinterpret_cast<uint64_t*>(skv + 2 * STAGES * L::BYTES);
  uint64_t* vfull = kfull + STAGES;
  uint64_t* kempty = vfull + STAGES;
  uint64_t* vempty = kempty + STAGES;
  uint64_t* qfull = vempty + STAGES;

  const Item item = item_of(blockIdx.x, nh, B, Sq, Skv, causal, window);
  const int n_tiles = item.n_tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&kempty[s], 4);
      mbar_init(&vempty[s], 4);
    }
    mbar_init(qfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer: one thread issues every TMA load, Q first, then K of each
    // tile before its V. The maps are 3-D (dh, position, batch x head):
    // rows past Sq or Skv read as zeros and never reach another head.
    if (threadIdx.x == 128) {
      mbar_expect_tx(qfull, L::BYTES);
      for (int c = 0; c < L::NBLK; ++c)
        tma_load(sq + c * 64 * L::RB, &qmap, qfull, c * L::AC, item.q_start,
                 item.b * nh + item.h);
      const int kv_head = item.b * nkv + item.h / (nh / nkv);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const uint32_t parity = ((j / STAGES) & 1) ^ 1;
        const int row = (item.j_begin + j) * kBN;
        unsigned char* ks = skv + 2 * s * L::BYTES;
        unsigned char* vs = ks + L::BYTES;
        mbar_wait(&kempty[s], parity);
        mbar_expect_tx(&kfull[s], L::BYTES);
        for (int c = 0; c < L::NBLK; ++c)
          tma_load(ks + c * 64 * L::RB, &kmap, &kfull[s], c * L::AC, row, kv_head);
        mbar_wait(&vempty[s], parity);
        mbar_expect_tx(&vfull[s], L::BYTES);
        for (int c = 0; c < L::NBLK; ++c)
          tma_load(vs + c * 64 * L::RB, &vmap, &vfull[s], c * L::AC, row, kv_head);
      }
    }
    return;
  }

  // consumers. Tile j's S = Q K^T is issued behind P.V of tile j - 1 and
  // one wait covers both. Every async product's registers are pinned
  // (`pin`) after the wait that completes it, and P stays live until its
  // product is known complete.
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = lane / 4, tq = lane % 4;
  const int r0 = 16 * warp + rg;  // this thread's rows r0 and r0 + 8
  const float sl2 = sm_scale * 1.4426950408889634f;  // raw scores to log2 units
  const int q_first = Skv - Sq + item.q_start, q_last = q_first + kBM - 1;
  const uint32_t q_addr = smem_u32(sq);
  auto k_addr = [&](int j) { return smem_u32(skv + 2 * (j % STAGES) * L::BYTES); };

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // m raw; l this thread's partial sums
  uint32_t pa[kBN / 16][4];  // P of the tile whose P.V may be in flight
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = 0u;
  mbar_wait(qfull, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const uint32_t parity = (j / STAGES) & 1;
    // S = Q K^T of tile j; P.V of tile j - 1 runs ahead of it on the
    // tensor cores, and the wait covers both
    float sc[32];
    mbar_wait(&kfull[s], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)  // the first step overwrites the accumulator
      wgmma_ss_n64(sc, kmajor_desc<DH>(q_addr, kk), kmajor_desc<DH>(k_addr(j), kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    pin(sc);
    pin(o);
    pin(pa);
    warp_arrive(&kempty[s]);
    if (j > 0) warp_arrive(&vempty[(j - 1) % STAGES]);

    // softmax of tile j; masks only on tiles that cross the diagonal, the
    // window's edge or Skv
    const int k0 = (item.j_begin + j) * kBN;
    const bool full_tile = k0 + kBN <= Skv && (!causal || k0 + kBN - 1 <= q_first) &&
                           (window <= 0 || k0 >= q_last - window + 1);
    if (!full_tile) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int k_pos = k0 + 8 * (i / 4) + 2 * tq + (i & 1);
        const int q_pos = q_first + r0 + 8 * ((i / 2) & 1);
        bool ok = k_pos < Skv;
        if (causal) ok = ok && k_pos <= q_pos;
        if (window > 0) ok = ok && k_pos > q_pos - window;
        sc[i] = ok ? sc[i] : kNegInf;
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], sc[i]);
    float corr[2], msl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = ex2((m[r] - m_new) * sl2);
      m[r] = m_new;
      msl[r] = m_new * sl2;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i / 2) & 1;
      float e0 = ex2(fmaf(sc[i], sl2, -msl[r]));
      float e1 = ex2(fmaf(sc[i + 1], sl2, -msl[r]));
      if (!full_tile) {
        // a masked score is exactly kNegInf and weighs 0, also where the
        // row's running max is still kNegInf
        e0 = sc[i] == kNegInf ? 0.f : e0;
        e1 = sc[i + 1] == kNegInf ? 0.f : e1;
      }
      l[r] += e0 + e1;
      pa[i / 8][(i / 2) & 3] = pack_bf16(e0, e1);
    }
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] *= corr[(i / 2) & 1];

    // O += P V of tile j, left running into the next tile's S
    mbar_wait(&vfull[s], parity);
    const uint32_t v_addr = k_addr(j) + L::BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) wgmma_pv<DH>(o, pa[kk], vmajor_desc<DH>(v_addr, kk));
    wgmma_commit();
  }
  wgmma_wait<0>();
  pin(o);
  pin(pa);

  // store: normalise, write bf16 into the Q tile in the maps' swizzled
  // layout once every warp's products have read Q, and send it out with one
  // TMA store per column block; rows past Sq are clipped by the map
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  consumer_sync();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
#pragma unroll
    for (int jn = 0; jn < DH / 8; ++jn) {
      const int col = 8 * jn + 2 * tq;
      uint32_t off = (col / L::AC) * 64 * L::RB + row * L::RB + (col % L::AC) * 2;
      off ^= ((off >> 7) & (L::RB / 16 - 1)) << 4;
      *reinterpret_cast<__nv_bfloat162*>(sq + off) =
          __floats2bfloat162_rn(o[4 * jn + 2 * r] * l[r], o[4 * jn + 2 * r + 1] * l[r]);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumer_sync();
  if (tid == 0) {
    for (int c = 0; c < L::NBLK; ++c)
      tma_store(&omap, sq + c * 64 * L::RB, c * L::AC, item.q_start, item.b * nh + item.h);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a 3-D map over [heads, rows, DH] bf16 with [1 x 64 x AC] boxes in the
// tile's swizzle; rows past `rows` read as zeros and are not written
template <int DH>
bool make_map(CUtensorMap* map, const void* base, long long heads, int rows) {
  using L = Tile<DH>;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(DH), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(DH) * 2,
                                 static_cast<cuuint64_t>(DH) * 2 * rows};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(L::AC), 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz = L::RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : L::RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a CTA of 160 threads per (query head, batch row, 64-row q tile)
template <int DH>
int launch_hopper(const void* q, const void* k, const void* v, void* out, int B, int nh, int nkv,
                  int Sq, int Skv, int causal, int window, float sm_scale, cudaStream_t st) {
  CUtensorMap qmap, kmap, vmap, omap;
  if (!make_map<DH>(&qmap, q, static_cast<long long>(B) * nh, Sq) ||
      !make_map<DH>(&kmap, k, static_cast<long long>(B) * nkv, Skv) ||
      !make_map<DH>(&vmap, v, static_cast<long long>(B) * nkv, Skv) ||
      !make_map<DH>(&omap, out, static_cast<long long>(B) * nh, Sq))
    return static_cast<int>(cudaErrorInvalidValue);
  static int attr_device = -1;  // the shared-memory limit is raised once per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (attr_device != dev) {
    cudaError_t e = cudaFuncSetAttribute(flash_attention_hopper<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Tile<DH>::SMEM));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_device = dev;
  }
  const long long grid = static_cast<long long>(nh) * B * ((Sq + kBM - 1) / kBM);
  flash_attention_hopper<DH><<<static_cast<unsigned>(grid), 160, Tile<DH>::SMEM, st>>>(
      qmap, kmap, vmap, omap, B, nh, nkv, Sq, Skv, causal, window, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int nh, int nkv,
               int Sq, int Skv, int dh, int causal, int window, float sm_scale, cudaStream_t st) {
  switch (dh) {
    case 16: return launch<float, 16>(q, k, v, out, B, nh, nkv, Sq, Skv, causal, window, sm_scale, st);
    case 32: return launch<float, 32>(q, k, v, out, B, nh, nkv, Sq, Skv, causal, window, sm_scale, st);
    case 64: return launch<float, 64>(q, k, v, out, B, nh, nkv, Sq, Skv, causal, window, sm_scale, st);
    case 128:
      return launch<float, 128>(q, k, v, out, B, nh, nkv, Sq, Skv, causal, window, sm_scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int nh, int nkv,
                int Sq, int Skv, int dh, int causal, int window, float sm_scale, cudaStream_t st) {
  switch (dh) {
    case 16: return launch_hopper<16>(q, k, v, out, B, nh, nkv, Sq, Skv, causal, window, sm_scale, st);
    case 32: return launch_hopper<32>(q, k, v, out, B, nh, nkv, Sq, Skv, causal, window, sm_scale, st);
    case 64: return launch_hopper<64>(q, k, v, out, B, nh, nkv, Sq, Skv, causal, window, sm_scale, st);
    case 128:
      return launch_hopper<128>(q, k, v, out, B, nh, nkv, Sq, Skv, causal, window, sm_scale, st);
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
    return launch_f32(q, k, v, out, B, nh, nkv, Sq, Skv, dh, causal, window, sm_scale, st);
  if (dtype == 1)
    return launch_bf16(q, k, v, out, B, nh, nkv, Sq, Skv, dh, causal, window, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
