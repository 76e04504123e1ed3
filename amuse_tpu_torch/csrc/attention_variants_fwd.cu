// Forward of the attention kernel variants V1, V3 and V5, for Hopper (sm_90a).
//
// Replaces the TPU kernels of benchmarks/kernel_variants.py that run the
// forward bodies: V1 _call_fwd (line 120, bodies _fwd_kernel_v1, _v4, _v0),
// V3 _call_fwd_v3 (line 373, _fwd_kernel_v3) and V5 make_v5.call_fwd
// (line 441, _fwd_kernel_v4). The three differ only in the TPU grid (a
// q-block of 640 rows, two heads by 320, the whole S); the tiling is what
// this design replaces. Per (batch, head), with scale = 1/sqrt(64):
//   SOFTMAX (v1, v3, v4, v5): s = q k^T scale in float32, m = rowmax(s),
//     e = exp(s - m), r = rowsum(e), o = (e cast to v's type) v accumulated
//     in float32, out = o / r in q's type.
//   DOTS (v0): out = (s cast to v's type) v, no mask and no softmax.
// e is taken against the row's FINAL maximum and rounded to bf16 once, as
// the TPU bodies do: K1's online softmax (attention_fwd.cu) rounds against a
// running maximum and is not a port of these bodies. So the softmax takes
// two passes over the K tiles: the first finds m, the second forms e, sums
// r from the same e values and accumulates e v. Keys at or past S are
// never read (zero-filled in shared memory) and get e = 0 (the TPU masks
// them to float32's minimum, whose exp is 0).
//
// Bound on the H100: operations. 4 S^2 D per (batch, head) for the two
// products, which the dots executes as they are. The softmax executes
// three (its first pass recomputes q k^T: 6 S^2 D). At the harness shape
// (4, 12, 1214, 64) bf16: 18.1 GFLOP counted (27.2 executed by the
// softmax), 0.0183 ms at 989 TFLOP/s; the bytes (q, k, v read, out
// written: 29.8 MB) take 0.0089 ms at 3.35 TB/s.
//
// Design of the bf16 softmax (softmax_fwd_wgmma): K1's building blocks
// (attention_fwd.cu, sm90_tile.cuh). One block of two warpgroups (256
// threads) per (batch*head, 128-row q tile), 64 rows a warpgroup; the grid
// is one dimension with the q tile fastest, so the blocks of one head run
// together and share K and V in L2. Both passes stream through one 4-stage
// ring of 64-key tiles filled by cp.async (swizzled, zero-filled past S):
// the ring runs over 2n virtual tiles, the n K tiles of pass 1 (V's half
// of the stage is not loaded) and then the n (K, V) tiles of pass 2, so
// pass 2's first tiles load while pass 1 ends; two tiles load ahead of the
// one at work, one block barrier a tile. cp.async and not TMA for the
// reasons attention_fwd.cu gives (a copy costs a thread a few instructions
// a tile; its zero-fill serves the ragged S with no transaction count).
//   Pass 1: S = Q K^T as wgmma m64n64k16, both operands from shared memory
//   through matrix descriptors; the row maximum of the raw products over
//   the keys below S, reduced over the four threads of a row at the end.
//   Pass 2: S again; e = 2^(s' - m') with s' = (q k^T) scale log2(e) folded
//   into one FMA and m' = m log2(e); r summed from the float32 e;
//   P = bf16(e) in registers as the A operand of O += P V, V read MN-major
//   (transpose bit), no transposing copy; out = O / r, a division as the
//   plain version takes it.
//   As in K1, warpgroup 1 runs pass 2 half a tile behind warpgroup 0 (its
//   O += P V of tile j-1 is issued where warpgroup 0 issues S of tile j),
//   so one's exponentials meet the other's products; O += P V stays in
//   flight across the barrier and is waited for with the next S.
//   Registers and residency (ptxas): 120 a thread, bounded to 128, no
//   spill; two blocks (four warpgroups) share an SM at
//   82,944 bytes of shared memory each (Q 16 KB, the ring 64 KB, 1 KB of
//   alignment). A warpgroup whose 64 rows lie wholly past S (the second
//   half of the last q tile) joins the loads and barriers and skips the
//   arithmetic.
//   Tried and not kept: expf on s = (q k^T) scale, then s - m, the plain
//   version's own arithmetic; its bit-equal share came out no higher than
//   ex2's and its time a quarter longer at the harness shape (PERF.md).
//   The first design (four warps of mma.sync, 64 rows a block, synchronous
//   tile loads, one barrier pair a tile) took 2.6 times as long.
// Design of the bf16 dots (dots_fwd_wgmma): the same blocks, grid and ring
// (4 stages of 64 keys, two tiles loading ahead, one barrier a tile) with
// pass 1 gone: n tiles, V loaded with every K. S = Q K^T from shared
// memory; P = bf16(s) in registers as the A operand of O += P V, V MN-major;
// no mask (a zero-filled K row gives s = +0 and P = 0 against a zero-filled
// V row, the zero padding the JAX wrapper gives the TPU body). scale = 1/8
// is a power of two, so the scale is applied to the float32 O at the store
// and the C entry refuses any other scale. That is bit for bit the plain
// version's rounding (tests/test_torch_port_variants.py) wherever no value
// leaves float32's normal range: s scale and every product and partial sum
// of the plain O are zero or at least 2^-126 in magnitude; |s| stays below bf16's
// overflow edge, 2^128 (1 - 2^-9) ~ 3.39e38, past which bf16(s) is inf and
// bf16(s scale) is not; every partial sum of bf16(s) v stays below FLT_MAX.
// Each warpgroup waits for S of a tile, which also retires the previous
// tile's P V, forms P and leaves its P V in flight over the next barrier;
// the two blocks an SM (four warpgroups) fill each other's gaps. Registers
// (ptxas): 106, no spill.
//   Tried (PERF.md), each slower: S of tile j+1 committed before P V of
//   tile j, so that waiting for S leaves P V in flight while the next P is
//   formed into a second P buffer (122-126 registers, 13-21% slower);
//   128-key stages, one barrier for two tiles and every product retired
//   before it; three or five stages.
//   float32 (both bodies): 256 threads, each a 4 x 4 block of S and of O,
//   float32 FMAs on operands stored k-major in shared memory (no tensor
//   cores: TF32 would round the inputs); P goes through shared memory as
//   the A operand of O += P V.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_tile.cuh"

namespace {

constexpr int D = 64;      // head dim (the JAX file's D)
constexpr int TILE = 64;   // query rows per block, keys per shared-memory tile (float32)
constexpr int SOFTMAX = 0, DOTS = 1;  // C body codes

// ------------------------------------------------------- bf16 softmax, wgmma

constexpr int W_BM = 128;     // query rows per block: two warpgroups x 64
constexpr int W_BK = 64;      // keys per ring stage
constexpr int W_STAGES = 4;   // stages of the ring
constexpr int W_AHEAD = 2;    // tiles loading ahead of the one at work; two more are being read
constexpr int W_THREADS = 256;
using Tl = sm90::Tile<D>;
constexpr int W_SMEM = 1024 + (W_BM + 2 * W_STAGES * W_BK) * Tl::ROW_BYTES;  // 1024: alignment

__global__ void __launch_bounds__(W_THREADS, 2)
softmax_fwd_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S,
                  int q_tiles, float scale_log2) {
  using namespace sm90;
  constexpr int KV_BYTES = W_BK * Tl::ROW_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + W_BM * Tl::ROW_BYTES;  // stage i: K at + 2 i KV_BYTES, then V

  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * W_BM;
  const int r_lo = q0 + wg * 64 + warp * 16 + g;
  const bool active = q0 + wg * 64 < S;  // warpgroup-uniform
  const long long base = (long long)bh * S * D;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;
  const int n = (S + W_BK - 1) / W_BK;  // key tiles; the ring runs over 2n virtual tiles

  auto stage_of = [&](int i) { return kv_s + (i % W_STAGES) * 2 * KV_BYTES; };
  auto load = [&](int i) {  // one commit group per call, empty past the last tile
    if (i < 2 * n) {
      const int tile = i < n ? i : i - n;
      load_tile_async<D, W_BK, W_THREADS>(stage_of(i), kb, D, tile * W_BK, S);
      if (i >= n) load_tile_async<D, W_BK, W_THREADS>(stage_of(i) + KV_BYTES, vb, D, tile * W_BK, S);
    }
    cp_async_commit();
  };
  load_tile_async<D, W_BM, W_THREADS>(q_s, q + base, D, q0, S);
#pragma unroll
  for (int i = 0; i < W_AHEAD; ++i) load(i);  // Q rides in the first group

  const uint64_t q_desc = Tl::desc(q_s + wg * 64 * Tl::ROW_BYTES);
  float sacc[32];  // S of the tile at work (rows = queries, columns = keys)
  auto scores = [&](int i) {  // S = Q K^T of virtual tile i, keys at or past S at -inf
    fence_regs(sacc);
    wgmma_fence();
    product_kmajor<D>(sacc, q_desc, Tl::desc(stage_of(i)));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);
    const int key0 = (i < n ? i : i - n) * W_BK;
    if (key0 + W_BK > S) {  // the ragged tail
#pragma unroll
      for (int jb = 0; jb < 8; ++jb)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (key0 + jb * 8 + 2 * t + e >= S) sacc[4 * jb + e] = sacc[4 * jb + 2 + e] = -INFINITY;
    }
  };

  // pass 1: the row maxima of the raw products (scale > 0 keeps the order)
  float m_lo = -INFINITY, m_hi = -INFINITY;
  for (int i = 0; i < n; ++i) {
    cp_async_wait<W_AHEAD - 1>();  // this thread's part of tile i has landed
    fence_proxy_async();
    __syncthreads();  // tile i is whole; tile i-2 is no longer read
    load(i + W_AHEAD);  // into the stage tile i-2 held
    if (!active) continue;
    scores(i);
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      m_lo = fmaxf(m_lo, fmaxf(sacc[4 * jb], sacc[4 * jb + 1]));
      m_hi = fmaxf(m_hi, fmaxf(sacc[4 * jb + 2], sacc[4 * jb + 3]));
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {  // the four threads of a row
    m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, off));
    m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, off));
  }
  // finite for an active row: every tile has a key below S
  const float mx_lo = m_lo * scale_log2, mx_hi = m_hi * scale_log2;

  // pass 2, K1's two phases: A(j), S and e against the final maximum; B(j),
  // O += P V, issued and left in flight. Warpgroup 0 runs A(j) B(j) between
  // two block barriers, warpgroup 1 runs B(j-1) A(j).
  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float l_lo = 0.f, l_hi = 0.f;
  uint32_t pa[4][4];  // P in bf16, as A fragments of P V
  auto phase_a = [&](int j) {
    scores(n + j);
    fence_regs(oacc);
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // exactly 0 on masked keys
        const float mx = e < 2 ? mx_lo : mx_hi;
        p[e] = ex2(fmaf(sacc[4 * jb + e], scale_log2, -mx));
      }
      l_lo += p[0] + p[1];
      l_hi += p[2] + p[3];
      pa[jb / 2][(jb % 2) * 2] = pack_bf16(p[0], p[1]);
      pa[jb / 2][(jb % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
  };
  auto phase_b = [&](int j) {
    fence_regs(oacc);
    wgmma_fence();
    accumulate_mnmajor<D>(oacc, pa, Tl::desc(stage_of(n + j) + KV_BYTES));
    wgmma_commit();
  };
  for (int j = 0; j <= n; ++j) {  // the last round is warpgroup 1's B(n - 1)
    cp_async_wait<W_AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();
    load(n + j + W_AHEAD);
    if (!active) continue;
    if (wg == 0) {
      if (j < n) {
        phase_a(j);
        phase_b(j);
      }
    } else {
      if (j > 0) phase_b(j - 1);
      if (j < n) phase_a(j);
    }
  }
  wgmma_wait<0>();
  fence_regs(oacc);
  cp_async_wait<0>();
  if (!active) return;

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  __nv_bfloat16* ob = o + base;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (r_lo < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r_lo * D + c) =
          __floats2bfloat162_rn(oacc[4 * nt] / l_lo, oacc[4 * nt + 1] / l_lo);
    if (r_lo + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)(r_lo + 8) * D + c) =
          __floats2bfloat162_rn(oacc[4 * nt + 2] / l_hi, oacc[4 * nt + 3] / l_hi);
  }
}

// ---------------------------------------------------------- bf16 dots, wgmma

// out = bf16(bf16(s) v * scale), scale a power of two (the C entry checks),
// so equal to bf16(bf16(s scale) v) bit for bit on the conditions the
// header note gives
__global__ void __launch_bounds__(W_THREADS, 2)
dots_fwd_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S,
               int q_tiles, float scale) {
  using namespace sm90;
  constexpr int KV_BYTES = W_BK * Tl::ROW_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + W_BM * Tl::ROW_BYTES;  // stage i: K at + 2 i KV_BYTES, then V

  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * W_BM;
  const int r_lo = q0 + wg * 64 + warp * 16 + lane / 4;
  const bool active = q0 + wg * 64 < S;  // warpgroup-uniform
  const long long base = (long long)bh * S * D;
  const int n = (S + W_BK - 1) / W_BK;  // key tiles

  auto stage_of = [&](int j) { return kv_s + (j % W_STAGES) * 2 * KV_BYTES; };
  auto load = [&](int j) {  // one commit group per call, empty past the last tile
    if (j < n) {
      load_tile_async<D, W_BK, W_THREADS>(stage_of(j), k + base, D, j * W_BK, S);
      load_tile_async<D, W_BK, W_THREADS>(stage_of(j) + KV_BYTES, v + base, D, j * W_BK, S);
    }
    cp_async_commit();
  };
  load_tile_async<D, W_BM, W_THREADS>(q_s, q + base, D, q0, S);
#pragma unroll
  for (int i = 0; i < W_AHEAD; ++i) load(i);  // Q rides in the first group

  // Keys at or past S need no mask: a zero-filled K row gives s = +0, so
  // P = 0, against a zero-filled V row.
  const uint64_t q_desc = Tl::desc(q_s + wg * 64 * Tl::ROW_BYTES);
  float sacc[32], oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  uint32_t pa[4][4];  // P = bf16(s) as A fragments of P V
  for (int j = 0; j < n; ++j) {
    cp_async_wait<W_AHEAD - 1>();  // this thread's part of tile j has landed
    fence_proxy_async();
    __syncthreads();  // tile j is whole; P V of tile j-2 has retired
    load(j + W_AHEAD);  // into the stage tile j-2 held
    if (!active) continue;
    fence_regs(sacc);
    wgmma_fence();
    product_kmajor<D>(sacc, q_desc, Tl::desc(stage_of(j)));  // S = Q K^T
    wgmma_commit();
    wgmma_wait<0>();  // S(j), and P V(j - 1) before it
    fence_regs(sacc);
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {  // S of n-tile jb is half of P V's k-step jb / 2
      pa[jb / 2][(jb % 2) * 2] = pack_bf16(sacc[4 * jb], sacc[4 * jb + 1]);
      pa[jb / 2][(jb % 2) * 2 + 1] = pack_bf16(sacc[4 * jb + 2], sacc[4 * jb + 3]);
    }
    fence_regs(oacc);
    wgmma_fence();
    accumulate_mnmajor<D>(oacc, pa, Tl::desc(stage_of(j) + KV_BYTES));  // O += P V, in flight
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(oacc);
  cp_async_wait<0>();
  if (active) store_rows<D>(o + base, D, oacc, r_lo, S, t, scale, scale);
}

// ---------------------------------------------------------------- float32

constexpr int F_THREADS = 256;  // 16 x 16 threads, a 4 x 4 block each
constexpr int LDF = TILE + 4;   // float row stride of a shared tile (272 bytes)
constexpr int F_TILE_FLOATS = D * LDF;

// rows [row0, row0 + 64) of a (S, 64) float32 matrix, stored transposed
// (dst[c * LDF + r]); rows at or past S are zeros
__device__ __forceinline__ void load_t_f32(float* dst, const float* src, int row0, int S) {
  for (int c = threadIdx.x; c < TILE * D / 4; c += F_THREADS) {
    const int r = c / (D / 4), col = (c % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) x = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * D + col);
    dst[(col + 0) * LDF + r] = x.x;
    dst[(col + 1) * LDF + r] = x.y;
    dst[(col + 2) * LDF + r] = x.z;
    dst[(col + 3) * LDF + r] = x.w;
  }
}

// the same, stored as it is (dst[r * LDF + c])
__device__ __forceinline__ void load_n_f32(float* dst, const float* src, int row0, int S) {
  for (int c = threadIdx.x; c < TILE * D / 4; c += F_THREADS) {
    const int r = c / (D / 4), col = (c % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) x = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * D + col);
    *reinterpret_cast<float4*>(dst + r * LDF + col) = x;
  }
}

// acc[i][j] = sum_p A[p][i0 + i] B[p][j0 + j] over 64 p, both operands k-major
__device__ __forceinline__ void mm4x4(float (&acc)[4][4], const float* A, const float* B, int i0,
                                      int j0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll 8
  for (int p = 0; p < 64; ++p) {
    const float4 a = *reinterpret_cast<const float4*>(A + p * LDF + i0);
    const float4 b = *reinterpret_cast<const float4*>(B + p * LDF + j0);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ float reduce16_max(float x) {  // over the 16 threads of a row block
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float reduce16_sum(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int BODY>
__global__ void __launch_bounds__(F_THREADS)
fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
        float* __restrict__ o, int S, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                      // [d][query]
  float* Kt = Qt + F_TILE_FLOATS;        // [d][key]
  float* Vs = Kt + F_TILE_FLOATS;        // [key][d]
  float* Pt = Vs + F_TILE_FLOATS;        // [key][query]
  const long long base = (long long)blockIdx.y * S * D;
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;  // rows 4 ti.., keys or d 4 tj..
  const int q0 = blockIdx.x * TILE, n_tiles = (S + TILE - 1) / TILE;
  load_t_f32(Qt, q + base, q0, S);

  float s[4][4], m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  if constexpr (BODY == SOFTMAX) {  // pass 1: the row maxima
    for (int kt = 0; kt < n_tiles; ++kt) {
      __syncthreads();
      load_t_f32(Kt, k + base, kt * TILE, S);
      __syncthreads();
      mm4x4(s, Qt, Kt, 4 * ti, 4 * tj);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (kt * TILE + 4 * tj + j < S)
          for (int i = 0; i < 4; ++i) m[i] = fmaxf(m[i], s[i][j] * scale);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = reduce16_max(m[i]);
  }
  float acc[4][4] = {}, r[4] = {0.f, 0.f, 0.f, 0.f};
  for (int kt = 0; kt < n_tiles; ++kt) {  // pass 2: e, r and e v
    __syncthreads();
    load_t_f32(Kt, k + base, kt * TILE, S);
    load_n_f32(Vs, v + base, kt * TILE, S);
    __syncthreads();
    mm4x4(s, Qt, Kt, 4 * ti, 4 * tj);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = kt * TILE + 4 * tj + j < S;
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (BODY == SOFTMAX) {
          p[i] = in ? expf(s[i][j] * scale - m[i]) : 0.f;
          r[i] += p[i];
        } else {
          p[i] = in ? s[i][j] * scale : 0.f;
        }
      }
      *reinterpret_cast<float4*>(Pt + (4 * tj + j) * LDF + 4 * ti) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();
    float part[4][4];
    mm4x4(part, Pt, Vs, 4 * ti, 4 * tj);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ti + i;
    const float f = BODY == SOFTMAX ? reduce16_sum(r[i]) : 1.f;
    if (row < S)
      *reinterpret_cast<float4*>(o + base + (long long)row * D + 4 * tj) =
          make_float4(acc[i][0] / f, acc[i][1] / f, acc[i][2] / f, acc[i][3] / f);
  }
}

template <int BODY>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int BH, int S,
                       float scale, cudaStream_t st) {
  constexpr int SMEM = 4 * F_TILE_FLOATS * sizeof(float);
  static cudaError_t attr =
      cudaFuncSetAttribute(fwd_f32<BODY>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + TILE - 1) / TILE, BH);
  fwd_f32<BODY><<<grid, F_THREADS, SMEM, st>>>(static_cast<const float*>(q),
                                               static_cast<const float*>(k),
                                               static_cast<const float*>(v),
                                               static_cast<float*>(o), S, scale);
  return cudaGetLastError();
}

cudaError_t launch_softmax_bf16(const void* q, const void* k, const void* v, void* o, int BH,
                                int S, float scale, cudaStream_t st) {
  static cudaError_t attr = cudaFuncSetAttribute(
      softmax_fwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM);
  if (attr != cudaSuccess) return attr;
  const int q_tiles = (S + W_BM - 1) / W_BM;
  softmax_fwd_wgmma<<<(unsigned)q_tiles * BH, W_THREADS, W_SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, q_tiles,
      scale * sm90::LOG2E);
  return cudaGetLastError();
}

cudaError_t launch_dots_bf16(const void* q, const void* k, const void* v, void* o, int BH,
                             int S, float scale, cudaStream_t st) {
  int e;
  if (frexpf(scale, &e) != 0.5f) return cudaErrorInvalidValue;  // the fold needs a power of two
  static cudaError_t attr = cudaFuncSetAttribute(
      dots_fwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM);
  if (attr != cudaSuccess) return attr;
  const int q_tiles = (S + W_BM - 1) / W_BM;
  dots_fwd_wgmma<<<(unsigned)q_tiles * BH, W_THREADS, W_SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, q_tiles, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: contiguous (B, H, S, 64) tensors, 16-byte aligned; dtype 0 =
// float32, 1 = bfloat16; body 0 = SOFTMAX, 1 = DOTS (bf16: `scale` a power
// of two). Launches one kernel on `stream` and returns its launch error
// (cudaGetLastError()), or 0.
int variant_fwd(const void* q, const void* k, const void* v, void* o, int dtype, int body, int B,
                int H, int S, float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || (long long)B * H > 65535) return cudaErrorInvalidValue;
  if (!(dtype == 0 || dtype == 1) || !(body == SOFTMAX || body == DOTS)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  if (dtype == 0)
    return body == SOFTMAX ? launch_f32<SOFTMAX>(q, k, v, o, BH, S, scale, st)
                           : launch_f32<DOTS>(q, k, v, o, BH, S, scale, st);
  return body == SOFTMAX ? launch_softmax_bf16(q, k, v, o, BH, S, scale, st)
                         : launch_dots_bf16(q, k, v, o, BH, S, scale, st);
}

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
