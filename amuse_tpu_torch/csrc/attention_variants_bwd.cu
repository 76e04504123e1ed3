// Backward of the attention kernel variants, for Hopper (sm_90a).
//
// Replaces the TPU kernels of benchmarks/kernel_variants.py that run the
// backward bodies: V2 _call_bwd (line 143; bodies _bwd_kernel_v1, _v4, _v0;
// V5's backward is V2 with _bwd_kernel_v4) and V4 _call_bwd_v3 (line 393,
// _bwd_kernel_v3, v1's body over two heads a program). There is no saved
// output or log-sum-exp: the inputs are q, k, v and dO alone. Per (batch,
// head), scale = 1/sqrt(64), keys and queries at or past S contributing
// nothing, and m, e, r the forward's (attention_variants_fwd.cu):
//   V1 (v1, v3): every product float32 on float32 values:
//     don = dO / r, dp = don v^T, ds = e (dp - rowsum(dp e) / r) scale,
//     dq = ds k, dk = ds^T q, dv = e^T don.
//   V4 (v4, v5): dp = dO v^T, ds = e (dp - rowsum(dp e) / r) / r scale rounded
//     to bf16 (ds16), dq = ds16 k, dk = ds16^T q, dv = bf16(e / r)^T dO, each
//     accumulated in float32; ds and e / r are rounded to bf16 whatever the
//     input type.
//   V0 (v0): s = q k^T scale, ds = dO v^T scale, dq = ds k, dk = ds^T q,
//     dv = s^T dO, all float32.
// dq, dk and dv are written in the inputs' type (the TPU writes dk and dv in
// float32 and the custom VJP casts them: one rounding either way).
//
// Bound on the H100: operations. Five S x S x D products, 10 S^2 D per
// (batch, head): at the harness shape (4, 12, 1214, 64) bf16, 9.06 GFLOP a
// product. Each is charged at the peak for its operands: two bf16 tensors
// multiply exactly on the tensor cores (989 TFLOP/s), a float32 operand that
// is no bf16 value (don, e, ds, s) needs the float32 units (67 TFLOP/s).
// V1: q k^T in bf16, four products in float32, 0.550 ms. V0: q k^T and
// dO v^T in bf16, three in float32, 0.424 ms. V4: all five in bf16, 0.0458
// ms. The bytes (q, k, v, dO read, dq, dk, dv written: 52 MB in bf16) take
// 0.0156 ms at 3.35 TB/s.
//
// Design. The TPU grid runs in order and adds dK and dV across q-blocks in a
// resident output block (lines 101-111). Hopper blocks run in no order, so
// the work is split, as attention_bwd.cu splits K2, into passes that each
// own their outputs, with no atomics (two launches on the same inputs are
// bit-equal):
//   1. rows, q-tile-major, one block per (batch*head, 64 queries): the row
//      statistics from three sweeps over the K tiles (m; then r from
//      e = exp(s - m); then c = rowsum(dp e) / r, which needs r first for
//      V1's don), written to a float32 scratch (B*H, 3, SP), SP = S rounded
//      up to 64; then dQ from a fourth sweep. V0 needs no statistics.
//   2. columns, kv-tile-major, one block per (batch*head, 64 keys): dK and
//      dV accumulated over every q tile inside the block (the TPU's
//      sequential grid dimension becomes this loop), from q, dO and pass 1's
//      statistics.
//   float32 operations (V1, V0 at either input type; V4 on float32 inputs):
//   256 threads, each a 4 x 4 block of every 64 x 64 product, float32 FMAs
//   on operands stored k-major in shared memory (q and dO both ways), S^T
//   and dP^T recomputed per tile; the elementwise terms go through shared
//   memory as the A operands of dK += dS^T Q and dV += P^T X. No tensor
//   cores: bf16 or TF32 would round don and e, which the TPU keeps float32.
//   bf16 V4: four warps of mma.sync m16n8k16 (bf16 in, float32 accumulation),
//   16 rows (queries in pass 1, keys in pass 2) a warp, the block's own
//   operands as register fragments, the streamed tile in shared memory; ds16
//   and bf16(e / r) are formed in the accumulator layout, which is the A
//   fragment layout of the product that consumes them.
// A simple right kernel first; the float32 products are the slow part (a
// few ms at the harness shape; PERF.md has the times).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// mm4x4, the row reductions, mma16816, pack_bf16, pair and the fragment loads
// repeat those of attention_variants_fwd.cu on purpose: a shared csrc/*.cuh
// enters the build hash of every kernel (ops/_build.py::_target), so it would
// rebuild K1-K3.

constexpr int D = 64;
constexpr int TILE = 64;
constexpr int V1 = 0, V4 = 1, V0 = 2;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ------------------------------------------------------------ float32 units

constexpr int F_THREADS = 256;  // 16 x 16 threads, a 4 x 4 block each
constexpr int LDF = TILE + 4;   // float row stride of a shared tile (272 bytes)
constexpr int F_TILE_FLOATS = D * LDF;

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  x[0] = a.x, x[1] = a.y, x[2] = b.x, x[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&x)[4]) {
  uint2 v;
  *reinterpret_cast<__nv_bfloat162*>(&v.x) = __floats2bfloat162_rn(x[0], x[1]);
  *reinterpret_cast<__nv_bfloat162*>(&v.y) = __floats2bfloat162_rn(x[2], x[3]);
  *reinterpret_cast<uint2*>(p) = v;
}

// Rows [row0, row0 + 64) of a (S, 64) matrix into float32 shared tiles: as it
// is (nrm[r * LDF + c]) and/or transposed (trn[c * LDF + r]), each row
// divided by div[r] where div is given; rows at or past S are zeros.
template <typename T>
__device__ __forceinline__ void load_tile(float* nrm, float* trn, const T* src, int row0, int S,
                                          const float* div) {
  for (int c = threadIdx.x; c < TILE * D / 4; c += F_THREADS) {
    const int r = c / (D / 4), col = (c % (D / 4)) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < S) {
      load4(src + (long long)(row0 + r) * D + col, x);
      if (div != nullptr)
        for (int i = 0; i < 4; ++i) x[i] = x[i] / div[r];
    }
    if (nrm != nullptr) store4(nrm + r * LDF + col, x);
    if (trn != nullptr)
      for (int i = 0; i < 4; ++i) trn[(col + i) * LDF + r] = x[i];
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

// ds and the factor of dV's product (p) of one (query, key) pair from its
// scaled score x and dp, the query's m, r, c = rowsum(dp e) / r
template <int BODY>
__device__ __forceinline__ void pair_terms(float x, float dp, float m, float r, float c,
                                           float scale, float& ds, float& p) {
  if constexpr (BODY == V0) {
    ds = dp * scale;
    p = x;
  } else {
    const float e = expf(x - m);
    if constexpr (BODY == V1) {
      ds = e * (dp - c) * scale;
      p = e;
    } else {
      ds = round_bf16(e * (dp - c) / r * scale);
      p = round_bf16(e / r);
    }
  }
}

// Pass 1 on the float32 units: statistics (V1, V4) and dQ.
template <typename T, int BODY>
__global__ void __launch_bounds__(F_THREADS)
rows_f32(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const T* __restrict__ dout, float* __restrict__ stats, T* __restrict__ dq, int S,
         int SP, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                  // [d][query], the block's
  float* Xt = Qt + F_TILE_FLOATS;    // [d][query]: don (V1) or dO, the block's
  float* Kt = Xt + F_TILE_FLOATS;    // [d][key]
  float* Kn = Kt + F_TILE_FLOATS;    // [key][d]
  float* Vt = Kn + F_TILE_FLOATS;    // [d][key]
  float* dSt = Vt + F_TILE_FLOATS;   // [key][query]
  float* rs = dSt + F_TILE_FLOATS;   // r of the block's 64 queries
  const long long base = (long long)blockIdx.y * S * D;
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;  // queries 4 ti.., keys or d 4 tj..
  const int q0 = blockIdx.x * TILE, n_tiles = (S + TILE - 1) / TILE;
  load_tile<T>(nullptr, Qt, q + base, q0, S, nullptr);

  float s[4][4], dp[4][4];
  float m[4] = {0.f, 0.f, 0.f, 0.f}, r[4] = {1.f, 1.f, 1.f, 1.f}, c[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (BODY != V0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = -INFINITY, r[i] = 0.f;
    for (int kt = 0; kt < n_tiles; ++kt) {  // sweep 1: m
      __syncthreads();
      load_tile<T>(nullptr, Kt, k + base, kt * TILE, S, nullptr);
      __syncthreads();
      mm4x4(s, Qt, Kt, 4 * ti, 4 * tj);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (kt * TILE + 4 * tj + j < S)
          for (int i = 0; i < 4; ++i) m[i] = fmaxf(m[i], s[i][j] * scale);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = reduce16_max(m[i]);
    for (int kt = 0; kt < n_tiles; ++kt) {  // sweep 2: r
      __syncthreads();
      load_tile<T>(nullptr, Kt, k + base, kt * TILE, S, nullptr);
      __syncthreads();
      mm4x4(s, Qt, Kt, 4 * ti, 4 * tj);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (kt * TILE + 4 * tj + j < S)
          for (int i = 0; i < 4; ++i) r[i] += expf(s[i][j] * scale - m[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = reduce16_sum(r[i]);
    if (tj == 0)
      for (int i = 0; i < 4; ++i) rs[4 * ti + i] = r[i];
    __syncthreads();
  }
  load_tile<T>(nullptr, Xt, dout + base, q0, S, BODY == V1 ? rs : nullptr);
  if constexpr (BODY != V0) {
    for (int kt = 0; kt < n_tiles; ++kt) {  // sweep 3: c = rowsum(dp e) / r
      __syncthreads();
      load_tile<T>(nullptr, Kt, k + base, kt * TILE, S, nullptr);
      load_tile<T>(nullptr, Vt, v + base, kt * TILE, S, nullptr);
      __syncthreads();
      mm4x4(s, Qt, Kt, 4 * ti, 4 * tj);
      mm4x4(dp, Xt, Vt, 4 * ti, 4 * tj);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (kt * TILE + 4 * tj + j < S)
          for (int i = 0; i < 4; ++i) c[i] += dp[i][j] * expf(s[i][j] * scale - m[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = reduce16_sum(c[i]) / r[i];
    if (tj == 0)
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + 4 * ti + i;
        if (row < S) {
          float* st = stats + (long long)blockIdx.y * 3 * SP + row;
          st[0] = m[i];
          st[SP] = r[i];
          st[2 * SP] = c[i];
        }
      }
  }
  float acc[4][4] = {};
  for (int kt = 0; kt < n_tiles; ++kt) {  // sweep 4: dQ
    __syncthreads();
    load_tile<T>(Kn, Kt, k + base, kt * TILE, S, nullptr);
    load_tile<T>(nullptr, Vt, v + base, kt * TILE, S, nullptr);
    __syncthreads();
    mm4x4(s, Qt, Kt, 4 * ti, 4 * tj);
    mm4x4(dp, Xt, Vt, 4 * ti, 4 * tj);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = kt * TILE + 4 * tj + j < S;
      float ds[4], p;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pair_terms<BODY>(s[i][j] * scale, dp[i][j], m[i], r[i], c[i], scale, ds[i], p);
        ds[i] = in ? ds[i] : 0.f;
      }
      store4(dSt + (4 * tj + j) * LDF + 4 * ti, ds);
    }
    __syncthreads();
    float part[4][4];
    mm4x4(part, dSt, Kn, 4 * ti, 4 * tj);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ti + i;
    if (row < S) store4(dq + base + (long long)row * D + 4 * tj, acc[i]);
  }
}

// Pass 2 on the float32 units: dK and dV of 64 keys over every q tile.
template <typename T, int BODY>
__global__ void __launch_bounds__(F_THREADS)
cols_f32(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const T* __restrict__ dout, const float* __restrict__ stats, T* __restrict__ dk,
         T* __restrict__ dv, int S, int SP, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;                  // [d][key], the block's
  float* Vt = Kt + F_TILE_FLOATS;    // [d][key], the block's
  float* Qt = Vt + F_TILE_FLOATS;    // [d][query]
  float* Qn = Qt + F_TILE_FLOATS;    // [query][d]
  float* Xt = Qn + F_TILE_FLOATS;    // [d][query]: don (V1) or dO
  float* Xn = Xt + F_TILE_FLOATS;    // [query][d]
  float* Pq = Xn + F_TILE_FLOATS;    // [query][key]: e (V1), bf16(e / r) (V4), s (V0)
  float* dSq = Pq + F_TILE_FLOATS;   // [query][key]
  float* ms = dSq + F_TILE_FLOATS;   // the q tile's m, r, c
  float* rs = ms + TILE;
  float* cs = rs + TILE;
  const long long base = (long long)blockIdx.y * S * D;
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;  // keys 4 ti.., queries or d 4 tj..
  const int k0 = blockIdx.x * TILE, n_tiles = (S + TILE - 1) / TILE;
  const float* st = stats + (long long)blockIdx.y * 3 * SP;
  load_tile<T>(nullptr, Kt, k + base, k0, S, nullptr);
  load_tile<T>(nullptr, Vt, v + base, k0, S, nullptr);

  float dka[4][4] = {}, dva[4][4] = {}, s[4][4], dp[4][4], part[4][4];
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * TILE;
    __syncthreads();
    if (threadIdx.x < TILE) {
      const bool in = BODY != V0 && q0 + threadIdx.x < S;
      ms[threadIdx.x] = in ? st[q0 + threadIdx.x] : 0.f;
      rs[threadIdx.x] = in ? st[SP + q0 + threadIdx.x] : 1.f;
      cs[threadIdx.x] = in ? st[2 * SP + q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    load_tile<T>(Qn, Qt, q + base, q0, S, nullptr);
    load_tile<T>(Xn, Xt, dout + base, q0, S, BODY == V1 ? rs : nullptr);
    __syncthreads();
    mm4x4(s, Kt, Qt, 4 * ti, 4 * tj);   // S^T
    mm4x4(dp, Vt, Xt, 4 * ti, 4 * tj);  // dP^T
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qc = 4 * tj + j;
      const bool qin = q0 + qc < S;
      float ds[4], p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pair_terms<BODY>(s[i][j] * scale, dp[i][j], ms[qc], rs[qc], cs[qc], scale, ds[i], p[i]);
        const bool in = qin && k0 + 4 * ti + i < S;
        ds[i] = in ? ds[i] : 0.f;
        p[i] = in ? p[i] : 0.f;
      }
      store4(dSq + qc * LDF + 4 * ti, ds);
      store4(Pq + qc * LDF + 4 * ti, p);
    }
    __syncthreads();
    mm4x4(part, Pq, Xn, 4 * ti, 4 * tj);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dva[i][j] += part[i][j];
    mm4x4(part, dSq, Qn, 4 * ti, 4 * tj);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dka[i][j] += part[i][j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + 4 * ti + i;
    if (row < S) {
      store4(dk + base + (long long)row * D + 4 * tj, dka[i]);
      store4(dv + base + (long long)row * D + 4 * tj, dva[i]);
    }
  }
}

// ------------------------------------------------------------ bf16, V4 only

constexpr int M_THREADS = 128;  // four warps, 16 rows each
constexpr int LDH = D + 8;      // bf16 row stride of a shared tile (144 bytes)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* lo, const __nv_bfloat16* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               int row0, int S) {
  for (int c = threadIdx.x; c < TILE * D / 8; c += M_THREADS) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < S) v = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * D + col);
    *reinterpret_cast<uint4*>(dst + r * LDH + col) = v;
  }
}
// A fragments (16 rows x 64) of rows r_lo and r_lo + 8 of a (S, 64) matrix
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[4][4], const __nv_bfloat16* src,
                                             int r_lo, int S, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const __nv_bfloat16* lo = src + (long long)r_lo * D + 16 * kk + 2 * t;
    const __nv_bfloat16* hi = lo + 8 * D;
    a[kk][0] = r_lo < S ? *reinterpret_cast<const uint32_t*>(lo) : 0u;
    a[kk][1] = r_lo + 8 < S ? *reinterpret_cast<const uint32_t*>(hi) : 0u;
    a[kk][2] = r_lo < S ? *reinterpret_cast<const uint32_t*>(lo + 8) : 0u;
    a[kk][3] = r_lo + 8 < S ? *reinterpret_cast<const uint32_t*>(hi + 8) : 0u;
  }
}
// s (16 x 64) = A (fragments, 16 x 64) B^T, B the 64-row shared tile (head
// dim contiguous): Q K^T, dO V^T, K Q^T, V dO^T
__device__ __forceinline__ void product_rows(float (&s)[8][4], const uint32_t (&a)[4][4],
                                             const __nv_bfloat16* tile, int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const __nv_bfloat16* b = tile + (8 * j + g) * LDH + 16 * kk + 2 * t;
      mma16816(s[j], a[kk], *reinterpret_cast<const uint32_t*>(b),
               *reinterpret_cast<const uint32_t*>(b + 8));
    }
}
// o (16 x 64) += P (16 x 64, fragments; its columns are the tile's rows) T,
// T the 64-row shared tile: ds16 K, bf16(e/r)^T dO, ds16^T Q
__device__ __forceinline__ void accumulate(float (&o)[8][4], const uint32_t (&p)[4][4],
                                           const __nv_bfloat16* tile, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const __nv_bfloat16* b = tile + (16 * kk + 2 * t) * LDH + 8 * j + g;
      mma16816(o[j], p[kk], pair(b, b + LDH), pair(b + 8 * LDH, b + 9 * LDH));
    }
}
__device__ __forceinline__ void zero(float (&a)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) a[j][0] = a[j][1] = a[j][2] = a[j][3] = 0.f;
}
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, const float (&a)[8][4], int r_lo,
                                           int S, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (r_lo < S)
      *reinterpret_cast<__nv_bfloat162*>(base + (long long)r_lo * D + c) =
          __floats2bfloat162_rn(a[j][0], a[j][1]);
    if (r_lo + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(base + (long long)(r_lo + 8) * D + c) =
          __floats2bfloat162_rn(a[j][2], a[j][3]);
  }
}
__device__ __forceinline__ float quad_sum(float x) {  // the four threads of a row
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Pass 1 of V4 on the tensor cores: statistics and dQ.
__global__ void __launch_bounds__(M_THREADS)
rows_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
          float* __restrict__ stats, __nv_bfloat16* __restrict__ dq, int S, int SP,
          float scale) {
  __shared__ __align__(16) __nv_bfloat16 Ks[TILE * LDH];
  __shared__ __align__(16) __nv_bfloat16 Vs[TILE * LDH];
  const long long base = (long long)blockIdx.y * S * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r_lo = blockIdx.x * TILE + 16 * warp + g;  // and r_lo + 8
  const int n_tiles = (S + TILE - 1) / TILE;
  uint32_t qa[4][4], da[4][4];
  load_a_frags(qa, q + base, r_lo, S, t);
  load_a_frags(da, dout + base, r_lo, S, t);
  float s[8][4], dp[8][4];
  float m[2] = {-INFINITY, -INFINITY}, r[2] = {0.f, 0.f}, c[2] = {0.f, 0.f};  // rows lo, hi

  for (int kt = 0; kt < n_tiles; ++kt) {  // sweep 1: m
    __syncthreads();
    load_tile_bf16(Ks, k + base, kt * TILE, S);
    __syncthreads();
    product_rows(s, qa, Ks, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (kt * TILE + 8 * j + 2 * t + (e & 1) < S) m[e / 2] = fmaxf(m[e / 2], s[j][e] * scale);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
  }
  for (int kt = 0; kt < n_tiles; ++kt) {  // sweep 2: r
    __syncthreads();
    load_tile_bf16(Ks, k + base, kt * TILE, S);
    __syncthreads();
    product_rows(s, qa, Ks, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (kt * TILE + 8 * j + 2 * t + (e & 1) < S) r[e / 2] += expf(s[j][e] * scale - m[e / 2]);
  }
  r[0] = quad_sum(r[0]);
  r[1] = quad_sum(r[1]);
  for (int kt = 0; kt < n_tiles; ++kt) {  // sweep 3: c = rowsum(dp e) / r
    __syncthreads();
    load_tile_bf16(Ks, k + base, kt * TILE, S);
    load_tile_bf16(Vs, v + base, kt * TILE, S);
    __syncthreads();
    product_rows(s, qa, Ks, g, t);
    product_rows(dp, da, Vs, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (kt * TILE + 8 * j + 2 * t + (e & 1) < S)
          c[e / 2] += dp[j][e] * expf(s[j][e] * scale - m[e / 2]);
  }
  c[0] = quad_sum(c[0]) / r[0];
  c[1] = quad_sum(c[1]) / r[1];
  if (t == 0)
    for (int h = 0; h < 2; ++h)
      if (r_lo + 8 * h < S) {
        float* st = stats + (long long)blockIdx.y * 3 * SP + r_lo + 8 * h;
        st[0] = m[h];
        st[SP] = r[h];
        st[2 * SP] = c[h];
      }
  float dqa[8][4];
  zero(dqa);
  for (int kt = 0; kt < n_tiles; ++kt) {  // sweep 4: dQ += ds16 K
    __syncthreads();
    load_tile_bf16(Ks, k + base, kt * TILE, S);
    load_tile_bf16(Vs, v + base, kt * TILE, S);
    __syncthreads();
    product_rows(s, qa, Ks, g, t);
    product_rows(dp, da, Vs, g, t);
    uint32_t dsa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const float x = expf(s[j][e] * scale - m[h]);
        ds[e] = kt * TILE + 8 * j + 2 * t + (e & 1) < S ? x * (dp[j][e] - c[h]) / r[h] * scale
                                                        : 0.f;
      }
      dsa[j / 2][(j % 2) * 2] = pack_bf16(ds[0], ds[1]);
      dsa[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    accumulate(dqa, dsa, Ks, g, t);
  }
  store_rows(dq + base, dqa, r_lo, S, t);
}

// Pass 2 of V4 on the tensor cores: dK and dV of 64 keys over every q tile.
__global__ void __launch_bounds__(M_THREADS)
cols_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
          const float* __restrict__ stats, __nv_bfloat16* __restrict__ dk,
          __nv_bfloat16* __restrict__ dv, int S, int SP, float scale) {
  __shared__ __align__(16) __nv_bfloat16 Qs[TILE * LDH];
  __shared__ __align__(16) __nv_bfloat16 dOs[TILE * LDH];
  __shared__ float ms[TILE], rs[TILE], cs[TILE];
  const long long base = (long long)blockIdx.y * S * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int kr_lo = blockIdx.x * TILE + 16 * warp + g;  // keys kr_lo and kr_lo + 8
  const int n_tiles = (S + TILE - 1) / TILE;
  const float* st = stats + (long long)blockIdx.y * 3 * SP;
  uint32_t ka[4][4], va[4][4];
  load_a_frags(ka, k + base, kr_lo, S, t);
  load_a_frags(va, v + base, kr_lo, S, t);
  float dka[8][4], dva[8][4], s[8][4], dp[8][4];
  zero(dka);
  zero(dva);
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * TILE;
    __syncthreads();
    load_tile_bf16(Qs, q + base, q0, S);
    load_tile_bf16(dOs, dout + base, q0, S);
    if (threadIdx.x < TILE) {
      const bool in = q0 + threadIdx.x < S;
      ms[threadIdx.x] = in ? st[q0 + threadIdx.x] : 0.f;
      rs[threadIdx.x] = in ? st[SP + q0 + threadIdx.x] : 1.f;
      cs[threadIdx.x] = in ? st[2 * SP + q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    product_rows(s, ka, Qs, g, t);   // S^T: rows keys, columns queries
    product_rows(dp, va, dOs, g, t); // dP^T
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        const bool in = q0 + qc < S && kr_lo + 8 * (e / 2) < S;
        const float x = expf(s[j][e] * scale - ms[qc]);
        p[e] = in ? x / rs[qc] : 0.f;
        ds[e] = in ? x * (dp[j][e] - cs[qc]) / rs[qc] * scale : 0.f;
      }
      pa[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
      dsa[j / 2][(j % 2) * 2] = pack_bf16(ds[0], ds[1]);
      dsa[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    accumulate(dva, pa, dOs, g, t);
    accumulate(dka, dsa, Qs, g, t);
  }
  store_rows(dk + base, dka, kr_lo, S, t);
  store_rows(dv + base, dva, kr_lo, S, t);
}

// ----------------------------------------------------------------- launch

template <typename T, int BODY>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* dout,
                       float* stats, void* dq, void* dk, void* dv, int BH, int S, int SP,
                       float scale, cudaStream_t st) {
  constexpr int ROWS_SMEM = (6 * F_TILE_FLOATS + TILE) * sizeof(float);
  constexpr int COLS_SMEM = (8 * F_TILE_FLOATS + 3 * TILE) * sizeof(float);
  static cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        rows_f32<T, BODY>, cudaFuncAttributeMaxDynamicSharedMemorySize, ROWS_SMEM);
    return e != cudaSuccess ? e
                            : cudaFuncSetAttribute(cols_f32<T, BODY>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   COLS_SMEM);
  }();
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + TILE - 1) / TILE, BH);
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *dot = static_cast<const T*>(dout);
  rows_f32<T, BODY><<<grid, F_THREADS, ROWS_SMEM, st>>>(qt, kt, vt, dot, stats,
                                                        static_cast<T*>(dq), S, SP, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cols_f32<T, BODY><<<grid, F_THREADS, COLS_SMEM, st>>>(
      qt, kt, vt, dot, stats, static_cast<T*>(dk), static_cast<T*>(dv), S, SP, scale);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                        float* stats, void* dq, void* dk, void* dv, int BH, int S, int SP,
                        float scale, cudaStream_t st) {
  using bf = __nv_bfloat16;
  const dim3 grid((S + TILE - 1) / TILE, BH);
  const bf *qb = static_cast<const bf*>(q), *kb = static_cast<const bf*>(k),
           *vb = static_cast<const bf*>(v), *db = static_cast<const bf*>(dout);
  rows_bf16<<<grid, M_THREADS, 0, st>>>(qb, kb, vb, db, stats, static_cast<bf*>(dq), S, SP,
                                         scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cols_bf16<<<grid, M_THREADS, 0, st>>>(qb, kb, vb, db, stats, static_cast<bf*>(dk),
                                         static_cast<bf*>(dv), S, SP, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_body(int body, const void* q, const void* k, const void* v, const void* dout,
                        float* stats, void* dq, void* dk, void* dv, int BH, int S, int SP,
                        float scale, cudaStream_t st) {
  if (body == V1) return launch_f32<T, V1>(q, k, v, dout, stats, dq, dk, dv, BH, S, SP, scale, st);
  if (body == V4) return launch_f32<T, V4>(q, k, v, dout, stats, dq, dk, dv, BH, S, SP, scale, st);
  return launch_f32<T, V0>(q, k, v, dout, stats, dq, dk, dv, BH, S, SP, scale, st);
}

}  // namespace

extern "C" {

// q, k, v, dout, dq, dk, dv: contiguous (B, H, S, 64) tensors of one type,
// 16-byte aligned; dtype 0 = float32, 1 = bfloat16; body 0 = V1, 1 = V4,
// 2 = V0; stats: float32 scratch of B * H * 3 * SP values, SP = S rounded up
// to a multiple of 64. Launches the two passes on `stream` and returns the
// first launch error (cudaGetLastError()), or 0.
int variant_bwd(const void* q, const void* k, const void* v, const void* dout, void* stats,
                void* dq, void* dk, void* dv, int dtype, int body, int B, int H, int S,
                float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || (long long)B * H > 65535) return cudaErrorInvalidValue;
  if (!(dtype == 0 || dtype == 1) || !(body == V1 || body == V4 || body == V0))
    return cudaErrorInvalidValue;
  const int SP = (S + TILE - 1) / TILE * TILE;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(stats);
  if (dtype == 1 && body == V4)
    return launch_bf16(q, k, v, dout, w, dq, dk, dv, B * H, S, SP, scale, st);
  if (dtype == 1)
    return launch_body<__nv_bfloat16>(body, q, k, v, dout, w, dq, dk, dv, B * H, S, SP, scale,
                                      st);
  return launch_body<float>(body, q, k, v, dout, w, dq, dk, dv, B * H, S, SP, scale, st);
}

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
