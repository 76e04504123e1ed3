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
// product, each charged at the bf16 tensor-core peak (989 TFLOP/s). Two bf16
// operands multiply exactly once. A float32 operand (ds, e / r, s) against
// an exact bf16 one is three such products: x = hi + mid + lo exactly in
// three bf16 pieces (the TPU's multi-pass float32 mode is built of bf16
// passes too). In V1, dp = don v^T is (dO v^T) / r, one bf16 product, and
// dv = e^T don is (e / r)^T dO. So V1 and V0 each come to 1 + 1 + 3 x 3 =
// 11 products, 0.1007 ms; V4 five, 0.0458 ms. (Charged on the float32
// units, 67 TFLOP/s, as before the split: V1 0.550 ms, V0 0.424.) The bytes
// (q, k, v, dO read, dq, dk, dv written: 52 MB in bf16) take 0.0156 ms at
// 3.35 TB/s.
//
// Design. The TPU grid runs in order and adds dK and dV across q-blocks in a
// resident output block (lines 101-111). Hopper blocks run in no order, so
// the work is split, as attention_bwd.cu splits K2, into passes that each
// own their outputs, with no atomics (two launches on the same inputs are
// bit-equal). The row statistics m, r and c = rowsum(dp e) / r go to a
// float32 scratch (B*H, 3, SP), SP = S rounded up to 64, between them.
//   bf16 inputs (V1, V4, V0; rows_pass and cols_pass, one rows and one
//   columns kernel a body): K2's passes on wgmma, from q, k, v and dO alone
//   (K2 reads K1's log-sum-exp and rowsum(dO o); here the rows pass takes
//   the statistics itself).
//     rows, q-tile-major, one block of two warpgroups per (batch*head,
//     128 queries), Q and dO resident in shared memory, K and V streaming.
//     Sweep 1: S = Q K^T and dP = dO V^T; m, r and rowsum(dp e) taken
//     online (r and the sum rescaled by 2^(m_old - m_new) as the maximum
//     grows), written as m' = m scale log2(e), 1/r and c. Sweep 2: S and dP
//     again, ds = e (dp - c) / r scale with e = 2^(s' - m') against the
//     final maximum, then dQ += ds K (ds from registers, K read MN-major):
//     V4 rounds ds to bf16, V1 multiplies it in three pieces. The two
//     sweeps run in one launch over one ring of 2n tiles. V0 has one sweep
//     and no statistics: dP = dO V^T, then dQ += (dP scale) K in pieces.
//     columns, kv-tile-major, one block per (batch*head, 64 keys a
//     warpgroup), K and V resident, Q, dO and the tile's m', 1/r, c
//     streaming: S^T = K Q^T and dP^T = V dO^T, then p^T = (e / r)^T (V0:
//     s^T) and ds^T in registers as the A operands of dV += p^T dO and
//     dK += ds^T Q, whose B operands are the same Q and dO tiles read
//     MN-major (transpose bit); no transposing copy. V4 rounds p and ds to
//     bf16; V1 and V0 multiply their three pieces.
//   Products executed for the five counted: V4 nine (the rows pass four,
//   the columns pass four, with S recomputed in each sweep and pass); V1
//   fifteen (rows S, dP; S, dP, 3 dQ; columns S, dP, 3 dV, 3 dK); V0 twelve
//   (rows dP, 3 dQ; columns eight). The first V4 design executed eleven on
//   mma.sync. e in both passes is taken against the final maximum, as the
//   TPU does, because the statistics are whole before they start; only r
//   and c are summed in another order (1/r multiplied, where the plain
//   version divides: a float32 ulp).
//   The split (split3, accumulate_split): hi = bf16(x), mid = bf16(x - hi),
//   lo = bf16(x - hi - mid), each difference exact in float32, so the
//   pieces carry all 24 bits of x (for |x| above about 8e-34; e below
//   2^-126 is 0 here, as ex2.approx flushes it) and each piece's product
//   with the bf16 partner is exact; the three accumulate in float32,
//   smallest first. Two pieces would round x at 2^-17, which a gradient
//   that is a small difference of large products shows
//   (kernel_variants.CANCELLATION_CASES). A piece register is read by its
//   wgmma until the group retires, so the pieces go a k-step at a time, at
//   most two groups in flight.
//   Every product is wgmma m64n64k16 from swizzled shared-memory tiles
//   (sm90_tile.cuh) filled by a 3-stage cp.async ring, zero-filled past S,
//   one block barrier a tile; the columns pass's stages also carry the
//   tile's 64 m', 1/r and c (not V0). cp.async and not TMA for the reasons
//   attention_fwd.cu gives. Registers and residency (ptxas, no spill): the
//   rows kernels hold S, dP, dQ and ds (V4: ds16; V1: its pieces) in 128
//   registers a thread (V0 105), bounded to 128, so two blocks of two
//   warpgroups share an SM at 82,944 bytes of shared memory each (Q and dO
//   32 KB, the ring 48 KB); the V4 columns kernel holds S^T, dP^T, dK, dV,
//   p16 and ds16 in 164, one block of three warpgroups an SM at 101,632
//   bytes (K and V 48 KB, the ring 48 KB and 2.25 KB of statistics); the V1
//   and V0 columns kernels (p, ds and their pieces) take 239 and 172, one
//   block of two warpgroups an SM (85,248 bytes): with three, capped at
//   168, V1 spilled 20 bytes, and with one k-step group in flight as well
//   40.
//   Tried and not kept: the statistics as a launch of their own before the
//   columns pass and dQ after it (three launches, Q and dO loaded twice)
//   took longer than the fused rows launch at the harness shape. The first
//   design (four warps of mma.sync, 64 rows a block, synchronous tile
//   loads, four sweeps over K in the rows pass: eleven products executed)
//   took five times as long. The times are in PERF.md.
//   float32 inputs (V1, V4, V0; rows_f32 and cols_f32 on the FMA units):
//   1. rows, q-tile-major, one block per (batch*head, 64 queries): the row
//      statistics from three sweeps over the K tiles (m; then r from
//      e = exp(s - m); then c, which needs r first for V1's don); then dQ
//      from a fourth sweep. V0 needs no statistics.
//   2. columns, kv-tile-major, one block per (batch*head, 64 keys): dK and
//      dV accumulated over every q tile inside the block (the TPU's
//      sequential grid dimension becomes this loop), from q, dO and pass 1's
//      statistics.
//   256 threads, each a 4 x 4 block of every 64 x 64 product, float32 FMAs
//   on operands stored k-major in shared memory (q and dO both ways), S^T
//   and dP^T recomputed per tile; the elementwise terms go through shared
//   memory as the A operands of dK += dS^T Q and dV += P^T X. With float32
//   inputs no operand is a bf16 value, so an exact split would take six
//   bf16 products a float32 one; the JAX file runs bf16 only. These
//   products are the slow part (a few ms at the harness shape; PERF.md has
//   the times).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_tile.cuh"

namespace {

// mm4x4 and the row reductions repeat those of attention_variants_fwd.cu on
// purpose: a new or changed csrc/*.cuh enters the build hash of every kernel
// (ops/_build.py::_target) and would rebuild K1-K3.

constexpr int D = 64;
constexpr int TILE = 64;
constexpr int V1 = 0, V4 = 1, V0 = 2;  // C body codes

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
__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

// Rows [row0, row0 + 64) of a (S, 64) matrix into float32 shared tiles: as it
// is (nrm[r * LDF + c]) and/or transposed (trn[c * LDF + r]), each row
// divided by div[r] where div is given; rows at or past S are zeros.
__device__ __forceinline__ void load_tile(float* nrm, float* trn, const float* src, int row0, int S,
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
template <int BODY>
__global__ void __launch_bounds__(F_THREADS)
rows_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
         const float* __restrict__ dout, float* __restrict__ stats, float* __restrict__ dq, int S,
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
  load_tile(nullptr, Qt, q + base, q0, S, nullptr);

  float s[4][4], dp[4][4];
  float m[4] = {0.f, 0.f, 0.f, 0.f}, r[4] = {1.f, 1.f, 1.f, 1.f}, c[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (BODY != V0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = -INFINITY, r[i] = 0.f;
    for (int kt = 0; kt < n_tiles; ++kt) {  // sweep 1: m
      __syncthreads();
      load_tile(nullptr, Kt, k + base, kt * TILE, S, nullptr);
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
      load_tile(nullptr, Kt, k + base, kt * TILE, S, nullptr);
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
  load_tile(nullptr, Xt, dout + base, q0, S, BODY == V1 ? rs : nullptr);
  if constexpr (BODY != V0) {
    for (int kt = 0; kt < n_tiles; ++kt) {  // sweep 3: c = rowsum(dp e) / r
      __syncthreads();
      load_tile(nullptr, Kt, k + base, kt * TILE, S, nullptr);
      load_tile(nullptr, Vt, v + base, kt * TILE, S, nullptr);
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
    load_tile(Kn, Kt, k + base, kt * TILE, S, nullptr);
    load_tile(nullptr, Vt, v + base, kt * TILE, S, nullptr);
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
template <int BODY>
__global__ void __launch_bounds__(F_THREADS)
cols_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
         const float* __restrict__ dout, const float* __restrict__ stats, float* __restrict__ dk,
         float* __restrict__ dv, int S, int SP, float scale) {
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
  load_tile(nullptr, Kt, k + base, k0, S, nullptr);
  load_tile(nullptr, Vt, v + base, k0, S, nullptr);

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
    load_tile(Qn, Qt, q + base, q0, S, nullptr);
    load_tile(Xn, Xt, dout + base, q0, S, BODY == V1 ? rs : nullptr);
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

// ---------------------------------------------------------- bf16, wgmma

constexpr int W_TILE = 64;       // rows of a streamed tile
constexpr int W_STAGES = 3;      // stages of the ring: two tiles load while one is at work
constexpr int W_LOADERS = 256;   // threads that issue the copies (every block has at least these)
constexpr int ROWS_WGS = 2;      // warpgroups (64 queries each) of a rows block
constexpr int W_STAT_BYTES = 3 * W_TILE * 4;  // a stage's m', 1/r and c (columns pass)
using Tl = sm90::Tile<D>;
using bf16 = __nv_bfloat16;
constexpr int ROWS_SMEM = 1024 + (2 * 64 * ROWS_WGS + 2 * W_STAGES * W_TILE) * Tl::ROW_BYTES;
// warpgroups (64 keys each) of a columns block, one block an SM: V4 three;
// V1 and V0 two, whose split pieces take up to 239 registers a thread
// (three warpgroups cap it at 168, and V1 spilled there)
__host__ __device__ constexpr int cols_wgs(int body) { return body == V4 ? 3 : 2; }
__host__ __device__ constexpr int cols_smem(int body) {
  return 1024 + (2 * 64 * cols_wgs(body) + 2 * W_STAGES * W_TILE) * Tl::ROW_BYTES +
         W_STAGES * W_STAT_BYTES;
}

// Both passes' arguments: (B*H, S, 64) bf16 tensors, the float32 statistics
// (B*H, 3, SP), the passes' tile counts and the scales.
struct WArgs {
  const bf16 *q, *k, *v, *dout;
  float* stats;
  bf16 *dq, *dk, *dv;
  int S, SP, row_tiles, key_tiles;
  float scale, scale_log2;
};

// S (or S^T) and dP (or dP^T) of the warpgroup's 64 rows against a 64-row
// tile: acc = A B^T over the head dim, both pairs from shared memory.
__device__ __forceinline__ void two_products(float (&s)[32], float (&dp)[32], uint64_t a_s,
                                             uint64_t b_s, uint64_t a_dp, uint64_t b_dp) {
  using namespace sm90;
  fence_regs(s);
  fence_regs(dp);
  wgmma_fence();
  product_kmajor<D>(s, a_s, b_s);
  product_kmajor<D>(dp, a_dp, b_dp);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
}

__device__ __forceinline__ float quad_sum(float x) {  // the four threads of a row
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// x0 = hi + mid + lo exactly, and x1 likewise, in three bf16 pieces packed
// as A-fragment registers (x0 in the low half). Each difference is exact in
// float32 (x - bf16(x) keeps at most 16 of x's 24 significant bits, the next
// at most 8), so the three carry all of x for |x| above bf16's smallest
// normal times 2^16 (about 8e-34).
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  hi = sm90::pack_bf16(x0, x1);
  x0 -= __uint_as_float(hi << 16);
  x1 -= __uint_as_float(hi & 0xffff0000u);
  mid = sm90::pack_bf16(x0, x1);
  lo = sm90::pack_bf16(x0 - __uint_as_float(mid << 16), x1 - __uint_as_float(mid & 0xffff0000u));
}

// acc += x B: x the warpgroup's 64 x 64 float32 A operand (accumulator
// layout), split into three bf16 pieces (split3) multiplied exactly against
// the bf16 tile at descriptor b (rows as the inner dim), smallest piece
// first, into the float32 accumulator. One commit group a k-step of 16, at
// most two in flight (wgmma reads its register operands until the group
// retires), so 24 registers of pieces are live and not 48. Ends with up to
// one group in flight; wgmma_wait<0> retires it.
__device__ __forceinline__ void accumulate_split(float (&acc)[32], const float (&x)[32],
                                                 uint64_t b) {
  using namespace sm90;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t hi[4], mid[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split3(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1], hi[i], mid[i], lo[i]);
    wgmma_fence();
    const uint64_t bk = b + kk * Tl::MNMAJOR_STEP;
    wgmma_rs_n64_t(acc, lo, bk);
    wgmma_rs_n64_t(acc, mid, bk);
    wgmma_rs_n64_t(acc, hi, bk);
    wgmma_commit();
    wgmma_wait<1>();
  }
}

// The rows pass, q-tile-major: one block of ROWS_WGS warpgroups per
// (batch*head, 128-query tile), Q and dO resident, K and V streaming.
// V4 and V1, sweep 1: m' = rowmax(q k^T) scale log2(e), r and c, taken
// online and written to stats[(bh * 3 + {0, 1, 2}) * SP + row] as m', 1/r
// and c (rows S..SP: +inf, 0, 0, so the columns pass gives their queries
// e = 0); sweep 2: from those statistics ds = e (dp - c) / r scale, then
// V4: dQ += ds16 K, ds16 = bf16(ds); V1: dQ += ds K in three pieces
// (accumulate_split). V0, one sweep, no statistics and no Q: dQ += ds K in
// three pieces, ds = dO V^T scale.
template <int BODY>
__device__ __forceinline__ void rows_pass(const WArgs& a) {
  using namespace sm90;
  constexpr int ROWS = 64 * ROWS_WGS;
  constexpr int OWN_BYTES = ROWS * Tl::ROW_BYTES, TILE_BYTES = W_TILE * Tl::ROW_BYTES;
  constexpr bool STATS = BODY != V0;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t do_s = q_s + OWN_BYTES;
  const uint32_t ring_s = do_s + OWN_BYTES;  // stage i: K at + 2 i TILE_BYTES, then V

  const int S = a.S, SP = a.SP;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x / a.row_tiles;
  const int q0 = (blockIdx.x % a.row_tiles) * ROWS;
  const int r_lo = q0 + wg * 64 + warp * 16 + g, r_hi = r_lo + 8;
  const bool active = q0 + wg * 64 < S;  // warpgroup-uniform; its rows then lie below SP
  const bool loader = threadIdx.x < W_LOADERS;
  const long long base = (long long)bh * S * D;
  const bf16* kb = a.k + base;
  const bf16* vb = a.v + base;
  const int n = (S + W_TILE - 1) / W_TILE;  // key tiles
  const int tiles = STATS ? 2 * n : n;     // the ring runs over every sweep's tiles

  auto stage_of = [&](int i) { return ring_s + (i % W_STAGES) * 2 * TILE_BYTES; };
  auto load = [&](int i) {  // one commit group per call, empty past the last tile
    if (i < tiles && loader) {
      const int row0 = (i % n) * W_TILE;
      load_tile_async<D, W_TILE, W_LOADERS>(stage_of(i), kb, D, row0, S);
      load_tile_async<D, W_TILE, W_LOADERS>(stage_of(i) + TILE_BYTES, vb, D, row0, S);
    }
    cp_async_commit();
  };
  if (loader) {
    if (STATS) load_tile_async<D, ROWS, W_LOADERS>(q_s, a.q + base, D, q0, S);
    load_tile_async<D, ROWS, W_LOADERS>(do_s, a.dout + base, D, q0, S);
  }
#pragma unroll
  for (int i = 0; i < W_STAGES - 1; ++i) load(i);  // Q and dO ride in the first group

  float* st = a.stats + (long long)bh * 3 * SP;
  const float scale = a.scale, scale_log2 = a.scale_log2;
  // m', 1/r and c of rows lo and hi; r and rowsum(dp e) while sweep 1 runs
  float m_lo = -INFINITY, m_hi = -INFINITY, ri_lo = 0.f, ri_hi = 0.f, c_lo = 0.f, c_hi = 0.f;
  float r_lo_sum = 0.f, r_hi_sum = 0.f, u_lo = 0.f, u_hi = 0.f;
  const uint64_t q_desc = Tl::desc(q_s + wg * 64 * Tl::ROW_BYTES);
  const uint64_t do_desc = Tl::desc(do_s + wg * 64 * Tl::ROW_BYTES);
  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;

  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<W_STAGES - 2>();  // this thread's part of tile i has landed
    fence_proxy_async();
    __syncthreads();  // tile i is whole; tile i-1 is no longer read
    load(i + W_STAGES - 1);  // into the stage tile i-1 held
    if (!active) continue;

    const uint32_t k_t = stage_of(i), v_t = k_t + TILE_BYTES;
    if constexpr (BODY == V0) {  // keys and queries past S are zeros: ds = 0 there
      float dp[32];
      fence_regs(dp);
      wgmma_fence();
      product_kmajor<D>(dp, do_desc, Tl::desc(v_t));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 32; ++j) dp[j] *= scale;
      fence_regs(dqa);
      accumulate_split(dqa, dp, Tl::desc(k_t));  // K read MN-major
      wgmma_wait<0>();
      fence_regs(dqa);
      continue;
    }

    const int key0 = (i % n) * W_TILE;
    const bool tail = key0 + W_TILE > S;  // keys at or past S: e = 0
    float sc[32], dp[32];  // S and dP: rows = queries, columns = keys
    two_products(sc, dp, q_desc, Tl::desc(k_t), do_desc, Tl::desc(v_t));
    if (tail) {
#pragma unroll
      for (int jb = 0; jb < 8; ++jb)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (key0 + jb * 8 + 2 * t + e >= S) sc[4 * jb + e] = sc[4 * jb + 2 + e] = -INFINITY;
    }

    if (i < n) {  // sweep 1: m, r and rowsum(dp e), online
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * jb], sc[4 * jb + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * jb + 2], sc[4 * jb + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      // finite: every tile has a key below S
      const float mn_lo = fmaxf(m_lo, mx_lo * scale_log2), mn_hi = fmaxf(m_hi, mx_hi * scale_log2);
      const float a_lo = ex2(m_lo - mn_lo), a_hi = ex2(m_hi - mn_hi);  // 0 on the first tile
      m_lo = mn_lo;
      m_hi = mn_hi;
      r_lo_sum *= a_lo;
      u_lo *= a_lo;
      r_hi_sum *= a_hi;
      u_hi *= a_hi;
#pragma unroll
      for (int jb = 0; jb < 8; ++jb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float e_lo = ex2(fmaf(sc[4 * jb + e], scale_log2, -mn_lo));
          const float e_hi = ex2(fmaf(sc[4 * jb + 2 + e], scale_log2, -mn_hi));
          r_lo_sum += e_lo;
          u_lo = fmaf(dp[4 * jb + e], e_lo, u_lo);
          r_hi_sum += e_hi;
          u_hi = fmaf(dp[4 * jb + 2 + e], e_hi, u_hi);
        }
      if (i == n - 1) {  // the row's statistics are whole
        r_lo_sum = quad_sum(r_lo_sum);
        r_hi_sum = quad_sum(r_hi_sum);
        ri_lo = 1.f / r_lo_sum;
        ri_hi = 1.f / r_hi_sum;
        c_lo = quad_sum(u_lo) / r_lo_sum;
        c_hi = quad_sum(u_hi) / r_hi_sum;
        if (t == 0) {
          const bool in_lo = r_lo < S, in_hi = r_hi < S;
          st[r_lo] = in_lo ? m_lo : INFINITY;
          st[SP + r_lo] = in_lo ? ri_lo : 0.f;
          st[2 * SP + r_lo] = in_lo ? c_lo : 0.f;
          st[r_hi] = in_hi ? m_hi : INFINITY;
          st[SP + r_hi] = in_hi ? ri_hi : 0.f;
          st[2 * SP + r_hi] = in_hi ? c_hi : 0.f;
        }
      }
      continue;
    }

    // sweep 2: ds = e (dp - c) / r scale, e against the final m
    const float f_lo = ri_lo * scale, f_hi = ri_hi * scale;
    auto ds_of = [&](int j, float m, float c, float f) {
      return ex2(fmaf(sc[j], scale_log2, -m)) * (dp[j] - c) * f;
    };
    fence_regs(dqa);
    if constexpr (BODY == V1) {  // ds into sc, then dQ += ds K in three pieces
#pragma unroll
      for (int jb = 0; jb < 8; ++jb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[4 * jb + e] = ds_of(4 * jb + e, m_lo, c_lo, f_lo);
          sc[4 * jb + 2 + e] = ds_of(4 * jb + 2 + e, m_hi, c_hi, f_hi);
        }
      accumulate_split(dqa, sc, Tl::desc(k_t));  // K read MN-major
    } else {  // dQ += ds16 K
      uint32_t dsa[4][4];  // ds16, as A fragments
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        dsa[jb / 2][(jb % 2) * 2] =
            pack_bf16(ds_of(4 * jb, m_lo, c_lo, f_lo), ds_of(4 * jb + 1, m_lo, c_lo, f_lo));
        dsa[jb / 2][(jb % 2) * 2 + 1] =
            pack_bf16(ds_of(4 * jb + 2, m_hi, c_hi, f_hi), ds_of(4 * jb + 3, m_hi, c_hi, f_hi));
      }
      wgmma_fence();
      accumulate_mnmajor<D>(dqa, dsa, Tl::desc(k_t));
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(dqa);
  }
  cp_async_wait<0>();
  if (active) store_rows<D>(a.dq + base, D, dqa, r_lo, S, t, 1.f, 1.f);
}

// The columns pass, kv-tile-major: dK and dV of one block of cols_wgs x 64
// keys (K and V resident) over every 64-query tile (Q, dO and, but for V0,
// the tile's m', 1/r, c streaming): S^T = K Q^T, dP^T = V dO^T, then
// dV += p^T dO and dK += ds^T Q with p^T and ds^T in registers as the A
// operands and the same Q and dO tiles read MN-major. p = e / r (V0: s) and
// ds as in rows_pass; V4 rounds both to bf16, V1 and V0 multiply them in
// three pieces (accumulate_split). A query past S has m' = +inf (V0: zero
// q and dO rows), so it adds nothing; a key past S is computed and not
// written.
template <int BODY>
__device__ __forceinline__ void cols_pass(const WArgs& a) {
  using namespace sm90;
  constexpr int ROWS = 64 * cols_wgs(BODY);
  constexpr int OWN_BYTES = ROWS * Tl::ROW_BYTES, TILE_BYTES = W_TILE * Tl::ROW_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t k_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t v_s = k_s + OWN_BYTES;
  const uint32_t ring_s = v_s + OWN_BYTES;  // stage i: Q at + 2 i TILE_BYTES, then dO
  const uint32_t stat_s = ring_s + W_STAGES * 2 * TILE_BYTES;  // stage i: 64 m', 64 1/r, 64 c
  const uint8_t* stat_p = smem_raw + (stat_s - smem_u32(smem_raw));

  const int S = a.S, SP = a.SP;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x / a.key_tiles;
  const int key0 = (blockIdx.x % a.key_tiles) * ROWS;
  const int key_lo = key0 + wg * 64 + warp * 16 + g;
  const bool active = key0 + wg * 64 < S;  // warpgroup-uniform
  const bool loader = threadIdx.x < W_LOADERS;
  const long long base = (long long)bh * S * D;
  const bf16* qb = a.q + base;
  const bf16* db = a.dout + base;
  const float* sb = a.stats + (long long)bh * 3 * SP;
  const int n = SP / W_TILE;  // query tiles; the statistics are padded to SP

  auto load = [&](int tile) {  // one commit group per call, empty past the last tile
    if (tile < n && loader) {
      const int stage = tile % W_STAGES;
      const uint32_t dst = ring_s + stage * 2 * TILE_BYTES;
      load_tile_async<D, W_TILE, W_LOADERS>(dst, qb, D, tile * W_TILE, S);
      load_tile_async<D, W_TILE, W_LOADERS>(dst + TILE_BYTES, db, D, tile * W_TILE, S);
      if (BODY != V0 && threadIdx.x < 48) {  // 16 chunks each of m', 1/r and c
        const int which = threadIdx.x / 16, c = threadIdx.x % 16;
        cp_async16(stat_s + stage * W_STAT_BYTES + threadIdx.x * 16,
                   sb + (long long)which * SP + tile * W_TILE + c * 4, 16);
      }
    }
    cp_async_commit();
  };
  if (loader) {
    load_tile_async<D, ROWS, W_LOADERS>(k_s, a.k + base, D, key0, S);
    load_tile_async<D, ROWS, W_LOADERS>(v_s, a.v + base, D, key0, S);
  }
#pragma unroll
  for (int i = 0; i < W_STAGES - 1; ++i) load(i);  // K and V ride in the first group

  const float scale = a.scale, scale_log2 = a.scale_log2;
  const uint64_t k_desc = Tl::desc(k_s + wg * 64 * Tl::ROW_BYTES);
  const uint64_t v_desc = Tl::desc(v_s + wg * 64 * Tl::ROW_BYTES);
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  for (int j = 0; j < n; ++j) {
    cp_async_wait<W_STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    load(j + W_STAGES - 1);
    if (!active) continue;

    const int stage = j % W_STAGES;
    const uint32_t q_t = ring_s + stage * 2 * TILE_BYTES, do_t = q_t + TILE_BYTES;
    const float* Ms = reinterpret_cast<const float*>(stat_p + stage * W_STAT_BYTES);
    const float* Rs = Ms + W_TILE;
    const float* Cs = Rs + W_TILE;
    float st[32], dpt[32];  // S^T and dP^T: rows = keys, columns = queries
    two_products(st, dpt, k_desc, Tl::desc(q_t), v_desc, Tl::desc(do_t));

    // p^T into st and ds^T into dpt, in float32
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      if constexpr (BODY == V0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[4 * jb + e] *= scale;
          dpt[4 * jb + e] *= scale;
        }
      } else {
        const float2 M = *reinterpret_cast<const float2*>(Ms + jb * 8 + 2 * t);
        const float2 R = *reinterpret_cast<const float2*>(Rs + jb * 8 + 2 * t);
        const float2 C = *reinterpret_cast<const float2*>(Cs + jb * 8 + 2 * t);
        const float m[2] = {M.x, M.y}, r[2] = {R.x, R.y}, c[2] = {C.x, C.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = e % 2;  // e = 0, 2: query 2 t; e = 1, 3: query 2 t + 1
          const float ex = ex2(fmaf(st[4 * jb + e], scale_log2, -m[x]));
          st[4 * jb + e] = ex * r[x];
          dpt[4 * jb + e] = ex * (dpt[4 * jb + e] - c[x]) * (r[x] * scale);
        }
      }
    }

    fence_regs(dva);
    fence_regs(dka);
    if constexpr (BODY == V4) {
      uint32_t pa[4][4], dsa[4][4];  // bf16(e / r)^T and ds16^T, as A fragments
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[kk][i] = pack_bf16(st[8 * kk + 2 * i], st[8 * kk + 2 * i + 1]);
          dsa[kk][i] = pack_bf16(dpt[8 * kk + 2 * i], dpt[8 * kk + 2 * i + 1]);
        }
      wgmma_fence();
      accumulate_mnmajor<D>(dva, pa, Tl::desc(do_t));  // dV += p16^T dO
      accumulate_mnmajor<D>(dka, dsa, Tl::desc(q_t));  // dK += ds16^T Q
      wgmma_commit();
    } else {
      accumulate_split(dva, st, Tl::desc(do_t));   // dV += p^T dO
      accumulate_split(dka, dpt, Tl::desc(q_t));   // dK += ds^T Q
    }
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
  }
  cp_async_wait<0>();
  if (!active) return;
  store_rows<D>(a.dk + base, D, dka, key_lo, S, t, 1.f, 1.f);
  store_rows<D>(a.dv + base, D, dva, key_lo, S, t, 1.f, 1.f);
}

// One rows and one columns kernel per body, named for it; __grid_constant__
// lets the passes read the arguments in place through a reference, with no
// copy (tools/variant_bwd_options.py times the plain parameter as option
// plain_param).
__global__ void __launch_bounds__(128 * ROWS_WGS, 2)
    v4_rows_wgmma(const __grid_constant__ WArgs a) { rows_pass<V4>(a); }
__global__ void __launch_bounds__(128 * ROWS_WGS, 2)
    v1_rows_wgmma(const __grid_constant__ WArgs a) { rows_pass<V1>(a); }
__global__ void __launch_bounds__(128 * ROWS_WGS, 2)
    v0_rows_wgmma(const __grid_constant__ WArgs a) { rows_pass<V0>(a); }
__global__ void __launch_bounds__(128 * cols_wgs(V4), 1)
    v4_cols_wgmma(const __grid_constant__ WArgs a) { cols_pass<V4>(a); }
__global__ void __launch_bounds__(128 * cols_wgs(V1), 1)
    v1_cols_wgmma(const __grid_constant__ WArgs a) { cols_pass<V1>(a); }
__global__ void __launch_bounds__(128 * cols_wgs(V0), 1)
    v0_cols_wgmma(const __grid_constant__ WArgs a) { cols_pass<V0>(a); }

// ----------------------------------------------------------------- launch

template <int BODY>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* dout,
                       float* stats, void* dq, void* dk, void* dv, int BH, int S, int SP,
                       float scale, cudaStream_t st) {
  constexpr int ROWS_SMEM = (6 * F_TILE_FLOATS + TILE) * sizeof(float);
  constexpr int COLS_SMEM = (8 * F_TILE_FLOATS + 3 * TILE) * sizeof(float);
  static cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        rows_f32<BODY>, cudaFuncAttributeMaxDynamicSharedMemorySize, ROWS_SMEM);
    return e != cudaSuccess ? e
                            : cudaFuncSetAttribute(cols_f32<BODY>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   COLS_SMEM);
  }();
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + TILE - 1) / TILE, BH);
  const float *qt = static_cast<const float*>(q), *kt = static_cast<const float*>(k),
              *vt = static_cast<const float*>(v), *dot = static_cast<const float*>(dout);
  rows_f32<BODY><<<grid, F_THREADS, ROWS_SMEM, st>>>(qt, kt, vt, dot, stats,
                                                     static_cast<float*>(dq), S, SP, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cols_f32<BODY><<<grid, F_THREADS, COLS_SMEM, st>>>(
      qt, kt, vt, dot, stats, static_cast<float*>(dk), static_cast<float*>(dv), S, SP, scale);
  return cudaGetLastError();
}

// the rows pass (both sweeps; V0: one), then the columns pass
template <int BODY>
cudaError_t launch_wgmma(void (*rows)(WArgs), void (*cols)(WArgs), WArgs a, int BH,
                         cudaStream_t st) {
  constexpr int COLS_KEYS = 64 * cols_wgs(BODY), COLS_SMEM = cols_smem(BODY);
  static const cudaError_t attr = [&] {
    constexpr auto A = cudaFuncAttributeMaxDynamicSharedMemorySize;
    const cudaError_t e = cudaFuncSetAttribute(rows, A, ROWS_SMEM);
    return e == cudaSuccess ? cudaFuncSetAttribute(cols, A, COLS_SMEM) : e;
  }();
  if (attr != cudaSuccess) return attr;
  a.row_tiles = (a.S + 64 * ROWS_WGS - 1) / (64 * ROWS_WGS);
  a.key_tiles = (a.S + COLS_KEYS - 1) / COLS_KEYS;
  rows<<<(unsigned)a.row_tiles * BH, 128 * ROWS_WGS, ROWS_SMEM, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cols<<<(unsigned)a.key_tiles * BH, 128 * cols_wgs(BODY), COLS_SMEM, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, dout, dq, dk, dv: contiguous (B, H, S, 64) tensors of one type,
// 16-byte aligned; dtype 0 = float32, 1 = bfloat16; body 0 = V1, 1 = V4,
// 2 = V0; stats: float32 scratch of B * H * 3 * SP values, SP = S rounded up to a multiple of 64.
// Launches the passes on `stream`, sets *route to 1 where they are the bf16
// wgmma kernels and to 0 where they are the float32 FMA kernels, and returns
// the first launch error (cudaGetLastError()), or 0.
int variant_bwd(const void* q, const void* k, const void* v, const void* dout, void* stats,
                void* dq, void* dk, void* dv, int dtype, int body, int B, int H, int S,
                float scale, void* stream, int* route) {
  if (B <= 0 || H <= 0 || S <= 0 || (long long)B * H > 65535) return cudaErrorInvalidValue;
  if (!(dtype == 0 || dtype == 1) || !(body == V1 || body == V4 || body == V0))
    return cudaErrorInvalidValue;
  const int SP = (S + TILE - 1) / TILE * TILE, BH = B * H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(stats);
  *route = dtype;
  if (dtype == 0) {
    if (body == V1) return launch_f32<V1>(q, k, v, dout, w, dq, dk, dv, BH, S, SP, scale, st);
    if (body == V4) return launch_f32<V4>(q, k, v, dout, w, dq, dk, dv, BH, S, SP, scale, st);
    return launch_f32<V0>(q, k, v, dout, w, dq, dk, dv, BH, S, SP, scale, st);
  }
  const WArgs a = {static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), static_cast<const bf16*>(dout), w,
                   static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, SP,
                   0, 0, scale, scale * sm90::LOG2E};  // tile counts: launch_wgmma
  if (body == V1) return launch_wgmma<V1>(v1_rows_wgmma, v1_cols_wgmma, a, BH, st);
  if (body == V4) return launch_wgmma<V4>(v4_rows_wgmma, v4_cols_wgmma, a, BH, st);
  return launch_wgmma<V0>(v0_rows_wgmma, v0_cols_wgmma, a, BH, st);
}

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
