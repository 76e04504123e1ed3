// Building blocks shared by the bf16 attention kernels K1 (attention_fwd.cu)
// and K2 (attention_bwd.cu) on Hopper (sm_90a): swizzled shared-memory tiles
// of (rows, D) bf16 operands, their asynchronous loader (cp.async), the
// wgmma matrix descriptors over them and the wgmma instructions themselves.
//
// Tile layout. A tile holds `rows` rows of D bf16 (D = 64: 128-byte rows,
// D = 32: 64-byte rows), rows packed, base aligned to 1024 bytes. The eight
// (four) 16-byte chunks of a row are stored XOR-permuted by the row number,
// which is exactly the 128-byte (64-byte) swizzle mode of wgmma's matrix
// descriptor: address bits [4,7) ^= bits [7,10) (bits [4,6) ^= bits [7,9)).
// One tile then serves, without any transposing copy,
//   * as a K-major operand (the head dim is the product's inner dim:
//     Q K^T, dO V^T, K Q^T, V dO^T): 8-row groups SBO = 8 rows apart, one
//     k-step of 16 values is 32 bytes further along the row;
//   * as an MN-major B operand with the transpose bit set (the tile's rows
//     are the inner dim: P V, P^T dO, dS^T Q, dS K): 8-row groups SBO
//     apart, one k-step of 16 rows is 16 rows further down.
// and both loaders write it conflict-free (8 threads fill one 128-byte row).
//
// Loads. cp.async (16 bytes, .cg, L2 only) with the swizzle applied by the
// issuing thread; rows at or past S are zero-filled through the src-size
// operand, so no loader branches on the ragged tail and a tile that lies
// wholly past S is simply zeros. Completion is counted per thread in
// commit groups; a block barrier after cp.async.wait_group publishes the
// tile to both warpgroups, and fence.proxy.async orders the writes before
// the tensor cores' (async proxy) reads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int D>
struct Tile {
  static_assert(D == 64 || D == 32, "head dim 64 (128-byte swizzle) or 32 (64-byte swizzle)");
  static constexpr int ROW_BYTES = 2 * D;
  static constexpr int CHUNKS = D / 8;               // 16-byte chunks per row
  static constexpr int GROUP_BYTES = 8 * ROW_BYTES;  // 8 rows: the descriptor's SBO
  static constexpr int KSTEPS = D / 16;              // k-steps over the head dim
  static constexpr uint64_t LAYOUT = D == 64 ? 1 : 2;  // descriptor swizzle: 128 B / 64 B

  // byte offset of 16-byte chunk c of row r inside a tile
  __device__ __forceinline__ static uint32_t offset(int r, int c) {
    const int x = D == 64 ? (r & 7) : ((r >> 1) & 3);
    return static_cast<uint32_t>(r * ROW_BYTES + ((c ^ x) << 4));
  }

  // wgmma matrix descriptor of the tile (or of a row block of it) at shared
  // address `addr` (a multiple of GROUP_BYTES). The leading byte offset is
  // not used by either operand form here (one swizzle width along the
  // contiguous dim).
  __device__ __forceinline__ static uint64_t desc(uint32_t addr) {
    return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
           (static_cast<uint64_t>(GROUP_BYTES >> 4) << 32) | (LAYOUT << 62);
  }
  // descriptor increments (the address field counts 16 bytes)
  static constexpr uint64_t KMAJOR_STEP = 32 >> 4;               // 16 values along the row
  static constexpr uint64_t MNMAJOR_STEP = (16 * ROW_BYTES) >> 4;  // 16 rows down
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes (cp.async) before async-proxy reads (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [row0, row0 + ROWS) of a (S, D) operand with row stride `stride`
// (elements) into the swizzled tile at shared address `dst`, by all THREADS
// threads of the block; rows at or past S arrive as zeros. A thread copies
// the same chunk column of rows RSTEP apart (a multiple of 8, so one swizzle
// term serves them all): one pointer and one offset per call, and no bounds
// test for a tile that lies wholly below S.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const __nv_bfloat16* base,
                                                long long stride, int row0, int S) {
  constexpr int CH = Tile<D>::CHUNKS, RSTEP = THREADS / CH, N = ROWS / RSTEP;
  static_assert(THREADS % CH == 0 && RSTEP % 8 == 0 && ROWS % RSTEP == 0,
                "the tile's chunks divide among the threads");
  const int r = threadIdx.x / CH, c = threadIdx.x % CH;
  const uint32_t d0 = dst + Tile<D>::offset(r, c);
  const __nv_bfloat16* src = base + (long long)(row0 + r) * stride + c * 8;
  const long long step = RSTEP * stride;
  if (row0 + ROWS <= S) {  // block-uniform
#pragma unroll
    for (int it = 0; it < N; ++it)
      cp_async16(d0 + it * RSTEP * Tile<D>::ROW_BYTES, src + it * step, 16);
  } else {
#pragma unroll
    for (int it = 0; it < N; ++it) {
      const bool in = row0 + r + it * RSTEP < S;
      cp_async16(d0 + it * RSTEP * Tile<D>::ROW_BYTES, in ? src + it * step : base, in ? 16 : 0);
    }
  }
}

// ------------------------------------------------------------------ wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator accesses across the wgmma group
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define SM90_ACC16(d)                                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15])
#define SM90_ACC32(d)                                                                          \
  SM90_ACC16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),            \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define SM90_REGS16 "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}"
#define SM90_REGS32                                                                \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21," \
  "%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}"

// d (64 x 64, f32) = or += A (64 x 16, shared, K-major) * B^T (B: 64 x 16,
// shared, K-major). accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SM90_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16 bf16, registers) * B (16 x 64, shared,
// MN-major: the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64_t(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_REGS32
      ", {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : SM90_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 32, f32) += A (64 x 16 bf16, registers) * B (16 x 32, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n32_t(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " SM90_REGS16
      ", {%16,%17,%18,%19}, %20, p, 1, 1, 1;\n}\n"
      : SM90_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// acc (64 x 64) = A (64 rows of a tile at descriptor a) * B^T (64 rows of a
// tile at descriptor b) over the head dim: the S = Q K^T form.
template <int D>
__device__ __forceinline__ void product_kmajor(float (&acc)[32], uint64_t a, uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < Tile<D>::KSTEPS; ++kk)
    wgmma_ss_n64(acc, a + kk * Tile<D>::KMAJOR_STEP, b + kk * Tile<D>::KMAJOR_STEP, kk > 0);
}

// acc (64 x D) += A (64 x 64 bf16 in registers, four k-steps of A fragments)
// * B (the 64-row tile at descriptor b, rows as the inner dim): the O += P V form.
template <int D>
__device__ __forceinline__ void accumulate_mnmajor(float (&acc)[D / 2], const uint32_t (&a)[4][4],
                                                   uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (D == 64)
      wgmma_rs_n64_t(acc, a[kk], b + kk * Tile<D>::MNMAJOR_STEP);
    else
      wgmma_rs_n32_t(acc, a[kk], b + kk * Tile<D>::MNMAJOR_STEP);
  }
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, one MUFU; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The warpgroup's 64 x D accumulator (thread layout: rows g and g + 8 of the
// warp's 16 rows, columns 8 j + 2 t, + 1) to rows [row0, row0 + 64) of a
// (S, D) bf16 tensor, each value times its row's factor; rows at or past S
// are not written.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long stride,
                                           const float (&acc)[D / 2], int r_lo, int S, int t,
                                           float f_lo, float f_hi) {
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (r_lo < S)
      *reinterpret_cast<__nv_bfloat162*>(base + (long long)r_lo * stride + c) =
          __floats2bfloat162_rn(acc[4 * nt] * f_lo, acc[4 * nt + 1] * f_lo);
    if (r_lo + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(base + (long long)(r_lo + 8) * stride + c) =
          __floats2bfloat162_rn(acc[4 * nt + 2] * f_hi, acc[4 * nt + 3] * f_hi);
  }
}

}  // namespace sm90
