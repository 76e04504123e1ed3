// K2: backward of the AST ViT blocks' multi-head attention, for Hopper (sm_90a).
//
// Replaces the TPU kernel amuse_tpu/ops/attention.py::_attn_bwd_kernel
// (reached through _mha_bwd_padded_raw <- _mha_core's custom VJP <-
// mha_fused_train <- mha_train). Same function, per (batch, head):
//   P  = softmax(Q K^T * scale)           recomputed in float32, keys >= S masked
//   dP = dO V^T                           float32 accumulation
//   dS = P * (dP - rowsum(dP * P)) * scale
//   dQ = dS K,  dK = dS^T Q,  dV = P^T dO  dS and P rounded to the operand type
//                                           first, float32 accumulation, then
//                                           cast to the input type
// Two differences in how, not what:
//   * P is rebuilt from the row log-sum-exp that K1 writes (attention_fwd.cu,
//     lse != nullptr): P = exp(s * scale - lse), no second softmax pass.
//   * rowsum(dP * P) is computed as Delta = rowsum(dO * O), which equals it
//     exactly in real arithmetic (sum_j P_ij dO_i.V_j = dO_i.O_i); with bf16
//     O it differs by O's rounding (the tolerance chip_smoke states).
//
// Bound on the H100: compute. 10 S^2 D operations per (batch, head) (the
// recomputed Q K^T, dP, dQ, dK, dV: five S x S x D products of 2 S^2 D,
// the exp and the elementwise terms not counted): at the stage-1 shape
// (12 = 3 encoders x 4 fbanks, 12 heads, S 1214, D 64) 136 GFLOP, 0.137 ms at
// 989 TFLOP/s bf16; the bytes (q, k, v, o, dO read, dq, dk, dv written,
// 179 MB) take 0.053 ms at 3.35 TB/s. The two passes below recompute S and
// dP in each (seven products where five are counted), so 0.19 ms is this
// design's own floor.
//
// Design. The TPU kernel keeps dK and dV of a whole head in VMEM and adds to
// them across q-blocks, "correct only because TPU grid steps run in order".
// Hopper blocks run concurrently and in no order, so the work is split into
// passes that each own their outputs, with no atomics (deterministic, two
// launches on the same inputs are bit-equal):
//   1. row statistics, into a float32 scratch (B*H, 2, SP), SP = S rounded
//      up to 64: Delta_i = rowsum(dO_i * O_i), and K1's LSE times log2(e)
//      (the passes below work in base 2); rows S..SP get LSE = +inf and
//      Delta = 0, so a query past S gives P = 2^-inf = 0 with no branch.
//      D/8 (bf16) or 8 (float32) threads share a row, so a warp reads whole
//      128-byte lines, and a shuffle reduction finishes the sum.
//   2. dK/dV, kv-tile-major: one block per (batch*head, 192-key tile).
//   3. dQ, q-tile-major: one block per (batch*head, 128-query tile).
// The ragged tail of S is masked in the kernel, with no padding. All eight
// tensors are taken with their own (batch, head, seq) strides and a
// contiguous head dim, so q, k, v come in as strided views of the fused qkv
// projection and dq, dk, dv are written as views of one (B, S, 3, H, D)
// buffer: the qkv Linear's backward gets one contiguous gradient.
//   bf16 (the main path; D 64 and D 32 are one template): a block's
//   warpgroups own 64 of its rows each. The block's own operands (K and V
//   in pass 2, Q and dO in pass 3) sit in shared memory for its lifetime;
//   the other pair streams in 64-row tiles through a 3-stage ring filled by
//   cp.async (sm90_tile.cuh: swizzled, zero-filled past S; pass 2's ring
//   also carries the tile's 64 LSE and Delta values), one block barrier per
//   tile. Why cp.async and not TMA: see attention_fwd.cu. Every product is
//   a wgmma m64nNk16:
//     pass 2: S^T = K Q^T and dP^T = V dO^T, both operands from shared
//     memory; P^T and dS^T (rows = keys) stay in registers, rounded to
//     bf16, as the A operands of dV += P^T dO and dK += dS^T Q, whose B
//     operands are the same dO and Q tiles read MN-major (transpose bit);
//     pass 3: S = Q K^T, dP = dO V^T, then dQ += dS K with dS from
//     registers and the K tile MN-major.
//   P = ex2(s * scale*log2(e) - lse*log2(e)): one FMA and one ex2 a score.
//   Registers and residency (ptxas, D 64, no spill in either): pass 2 holds
//   S^T, dP^T, dK, dV (128 accumulator registers) plus P^T and dS^T: 168
//   registers, so one block of three warpgroups (384 threads) fills an SM's
//   register file; with them K2 timed faster than with two warpgroups of
//   128 keys (186 registers). Pass 3 holds S, dP, dQ and dS in 124
//   registers, bounded to 128: two blocks of two warpgroups per SM (three
//   warpgroups in one block timed slower at the train step's shape). Shared
//   memory: 100 KB (pass 2), 81 KB (pass 3). Both passes run near 40% of the tensor-core
//   peak on the seven products they execute; what holds them is the chain
//   barrier -> wgmma -> wait -> exponentials -> wgmma per tile, which the
//   three or four warpgroups an SM holds overlap only in part (running
//   warpgroup 1 half a tile behind, as K1 does, did not pay here and is not
//   kept).
//   float32: one thread per key (dK/dV) or per query (dQ), scalar FMAs
//   over shared-memory tiles (no tensor cores: TF32 would round the inputs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_tile.cuh"

namespace {

struct Strides {
  long long b, h, s;
};

// Pass 1: row statistics. stats[(bh * 2) * SP + i] = lse_i * log2(e) (bf16;
// float32: lse_i as it is; +inf for S <= i < SP), stats[(bh * 2 + 1) * SP + i]
// = sum_d dO[i, d] * O[i, d] (0 for S <= i < SP). TPR threads share a row.
constexpr int STATS_THREADS = 256;

template <typename T, int D>
__global__ void __launch_bounds__(STATS_THREADS)
attn_bwd_stats_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ stats, int H, int S,
                      int SP, Strides os, Strides dos) {
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int TPR = BF16 ? D / 8 : 8;
  constexpr int ROWS = STATS_THREADS / TPR;  // rows per block
  const int row_tiles = (SP + ROWS - 1) / ROWS;
  const int bh = blockIdx.x / row_tiles;
  const long long b = bh / H, h = bh % H;
  const int row = (blockIdx.x % row_tiles) * ROWS + threadIdx.x / TPR;
  const int sub = threadIdx.x % TPR;
  float acc = 0.f;
  if (row < S) {
    const T* op = o + b * os.b + h * os.h + (long long)row * os.s;
    const T* dp = dout + b * dos.b + h * dos.h + (long long)row * dos.s;
    if constexpr (BF16) {  // one 16-byte load of each
      const uint4 ov = *reinterpret_cast<const uint4*>(op + sub * 8);
      const uint4 dv = *reinterpret_cast<const uint4*>(dp + sub * 8);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = __bfloat1622float2(o2[i]), c = __bfloat1622float2(d2[i]);
        acc = fmaf(a.x, c.x, acc);
        acc = fmaf(a.y, c.y, acc);
      }
    } else {
#pragma unroll
      for (int c = sub; c < D; c += TPR) acc = fmaf(op[c], dp[c], acc);
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (sub == 0 && row < SP) {
    const bool in = row < S;
    // the bf16 passes work in base 2, the float32 passes keep the natural log
    stats[((long long)bh * 2) * SP + row] =
        in ? lse[(long long)bh * S + row] * (BF16 ? sm90::LOG2E : 1.f) : INFINITY;
    stats[((long long)bh * 2 + 1) * SP + row] = in ? acc : 0.f;
  }
}

// ---------------------------------------------------------------- float32

constexpr int F_THREADS = 64;  // rows (keys or queries) per block, one per thread
constexpr int F_TILE = 32;     // rows of the streamed operand per shared-memory tile

template <int D>
__global__ void __launch_bounds__(F_THREADS)
attn_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ stats, float* __restrict__ dk,
                  float* __restrict__ dv, int H, int S, int SP, Strides qs, Strides ks,
                  Strides vs, Strides dos, Strides dks, Strides dvs, float scale) {
  __shared__ float Qs[F_TILE][D];
  __shared__ float dOs[F_TILE][D];
  __shared__ float Ls[F_TILE], Ds[F_TILE];

  const int row_tiles = (S + F_THREADS - 1) / F_THREADS;
  const int bh = blockIdx.x / row_tiles;
  const long long b = bh / H, h = bh % H;
  const int key = (blockIdx.x % row_tiles) * F_THREADS + threadIdx.x;
  const bool valid = key < S;
  const float* kp = k + b * ks.b + h * ks.h + (long long)(valid ? key : 0) * ks.s;
  const float* vp = v + b * vs.b + h * vs.h + (long long)(valid ? key : 0) * vs.s;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* db = dout + b * dos.b + h * dos.h;
  const float* lse = stats + (long long)bh * 2 * SP;  // the row statistics of pass 1
  const float* delta = lse + SP;

  float kr[D], vr[D], dka[D], dva[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    kr[c] = kp[c];
    vr[c] = vp[c];
    dka[c] = 0.f;
    dva[c] = 0.f;
  }
  for (int q0 = 0; q0 < S; q0 += F_TILE) {
    const int nq = min(F_TILE, S - q0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < F_TILE * D; i += F_THREADS) {
      const int r = i / D, c = i % D;
      const bool in = r < nq;
      Qs[r][c] = in ? qb[(long long)(q0 + r) * qs.s + c] : 0.f;
      dOs[r][c] = in ? db[(long long)(q0 + r) * dos.s + c] : 0.f;
    }
    if (threadIdx.x < F_TILE) {
      const bool in = threadIdx.x < nq;
      Ls[threadIdx.x] = in ? lse[q0 + threadIdx.x] : 0.f;
      Ds[threadIdx.x] = in ? delta[q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < nq; ++i) {  // queries past S are not visited
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        s = fmaf(kr[c], Qs[i][c], s);
        dp = fmaf(vr[c], dOs[i][c], dp);
      }
      const float p = expf(s * scale - Ls[i]);
      const float ds = p * (dp - Ds[i]) * scale;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        dva[c] = fmaf(p, dOs[i][c], dva[c]);
        dka[c] = fmaf(ds, Qs[i][c], dka[c]);
      }
    }
  }
  if (valid) {
    float* dkp = dk + b * dks.b + h * dks.h + (long long)key * dks.s;
    float* dvp = dv + b * dvs.b + h * dvs.h + (long long)key * dvs.s;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      dkp[c] = dka[c];
      dvp[c] = dva[c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(F_THREADS)
attn_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ stats, float* __restrict__ dq, int H, int S, int SP,
                Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs, float scale) {
  __shared__ float Ks[F_TILE][D];
  __shared__ float Vs[F_TILE][D];

  const int row_tiles = (S + F_THREADS - 1) / F_THREADS;
  const int bh = blockIdx.x / row_tiles;
  const long long b = bh / H, h = bh % H;
  const int row = (blockIdx.x % row_tiles) * F_THREADS + threadIdx.x;
  const bool valid = row < S;
  const int r = valid ? row : 0;
  const float* qp = q + b * qs.b + h * qs.h + (long long)r * qs.s;
  const float* dop = dout + b * dos.b + h * dos.h + (long long)r * dos.s;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float L = stats[(long long)bh * 2 * SP + r];
  const float Dd = stats[((long long)bh * 2 + 1) * SP + r];

  float qr[D], dor[D], acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    qr[c] = qp[c];
    dor[c] = dop[c];
    acc[c] = 0.f;
  }
  for (int k0 = 0; k0 < S; k0 += F_TILE) {
    const int nk = min(F_TILE, S - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < F_TILE * D; i += F_THREADS) {
      const int rr = i / D, c = i % D;
      const bool in = rr < nk;
      Ks[rr][c] = in ? kb[(long long)(k0 + rr) * ks.s + c] : 0.f;
      Vs[rr][c] = in ? vb[(long long)(k0 + rr) * vs.s + c] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < nk; ++j) {  // keys past S are not visited
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        s = fmaf(qr[c], Ks[j][c], s);
        dp = fmaf(dor[c], Vs[j][c], dp);
      }
      const float ds = expf(s * scale - L) * (dp - Dd) * scale;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = fmaf(ds, Ks[j][c], acc[c]);
    }
  }
  if (valid) {
    float* out = dq + b * dqs.b + h * dqs.h + (long long)row * dqs.s;
#pragma unroll
    for (int c = 0; c < D; ++c) out[c] = acc[c];
  }
}

// ------------------------------------------------------------------ bf16

constexpr int W_TILE = 64;     // rows of the streamed operands per ring stage
constexpr int W_STAGES = 3;    // stages of the ring: two tiles load while one is at work
constexpr int W_LOADERS = 256; // threads that issue the copies (every block has at least these)
constexpr int W_STAT_BYTES = 2 * W_TILE * 4;  // a stage's LSE and Delta values (pass 2)
constexpr int DKDV_WGS = 3;    // warpgroups (64 keys each) per block of pass 2
constexpr int DQ_WGS = 2;      // warpgroups (64 queries each) per block of pass 3

template <int D, int WGS>
constexpr int bwd_smem_bytes(bool with_stats) {
  return 1024 + (2 * 64 * WGS + 2 * W_STAGES * W_TILE) * sm90::Tile<D>::ROW_BYTES +
         (with_stats ? W_STAGES * W_STAT_BYTES : 0);  // 1024: alignment
}

// Pass 2: dK and dV of one tile of 64 WGS keys; loops over every 64-query tile.
template <int D, int WGS>
__global__ void __launch_bounds__(128 * WGS, 1)
attn_bwd_dkdv_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ stats, __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int H, int S, int SP, int row_tiles,
                    Strides qs, Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
                    float scale, float scale_log2) {
  using namespace sm90;
  using T = Tile<D>;
  constexpr int ROWS = 64 * WGS;
  constexpr int OWN_BYTES = ROWS * T::ROW_BYTES, TILE_BYTES = W_TILE * T::ROW_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t k_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t v_s = k_s + OWN_BYTES;
  const uint32_t ring_s = v_s + OWN_BYTES;  // stage i: Q at + 2 i TILE_BYTES, then dO
  const uint32_t stat_s = ring_s + W_STAGES * 2 * TILE_BYTES;  // stage i: 64 LSE, 64 Delta
  const uint8_t* stat_p = smem_raw + (stat_s - smem_u32(smem_raw));

  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x / row_tiles;
  const long long b = bh / H, h = bh % H;
  const int key0 = (blockIdx.x % row_tiles) * ROWS;
  const int key_lo = key0 + wg * 64 + warp * 16 + g;
  const bool active = key0 + wg * 64 < S;  // warpgroup-uniform
  const bool loader = threadIdx.x < W_LOADERS;
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* db = dout + b * dos.b + h * dos.h;
  const float* sb = stats + (long long)bh * 2 * SP;
  const int n_tiles = SP / W_TILE;

  auto load_stage = [&](int tile) {  // one commit group per call, empty past the last tile
    if (tile < n_tiles && loader) {
      const int stage = tile % W_STAGES;
      const uint32_t dst = ring_s + stage * 2 * TILE_BYTES;
      load_tile_async<D, W_TILE, W_LOADERS>(dst, qb, qs.s, tile * W_TILE, S);
      load_tile_async<D, W_TILE, W_LOADERS>(dst + TILE_BYTES, db, dos.s, tile * W_TILE, S);
      if (threadIdx.x < 32) {  // 16 chunks of LSE, 16 of Delta; SP pads both past S
        const int which = threadIdx.x / 16, c = threadIdx.x % 16;
        cp_async16(stat_s + stage * W_STAT_BYTES + threadIdx.x * 16,
                   sb + (long long)which * SP + tile * W_TILE + c * 4, 16);
      }
    }
    cp_async_commit();
  };
  if (loader) {
    load_tile_async<D, ROWS, W_LOADERS>(k_s, k + b * ks.b + h * ks.h, ks.s, key0, S);
    load_tile_async<D, ROWS, W_LOADERS>(v_s, v + b * vs.b + h * vs.h, vs.s, key0, S);
  }
#pragma unroll
  for (int i = 0; i < W_STAGES - 1; ++i) load_stage(i);  // K and V ride in the first group

  const uint64_t k_desc = T::desc(k_s + wg * 64 * T::ROW_BYTES);
  const uint64_t v_desc = T::desc(v_s + wg * 64 * T::ROW_BYTES);
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<W_STAGES - 2>();  // this thread's part of tile j has landed
    fence_proxy_async();
    __syncthreads();  // tile j is whole; tile j-1 is no longer read
    load_stage(j + W_STAGES - 1);  // into the stage tile j-1 held
    if (!active) continue;

    const int stage = j % W_STAGES;
    const uint32_t q_t = ring_s + stage * 2 * TILE_BYTES, do_t = q_t + TILE_BYTES;
    const float* Ls = reinterpret_cast<const float*>(stat_p + stage * W_STAT_BYTES);
    const float* Ds = Ls + W_TILE;

    float st[32], dpt[32];  // S^T and dP^T: rows = keys, columns = queries
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
    product_kmajor<D>(st, k_desc, T::desc(q_t));
    product_kmajor<D>(dpt, v_desc, T::desc(do_t));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    uint32_t pa[4][4], dsa[4][4];  // P^T and dS^T in bf16, as A fragments
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      const float2 L = *reinterpret_cast<const float2*>(Ls + jb * 8 + 2 * t);
      const float2 Dq = *reinterpret_cast<const float2*>(Ds + jb * 8 + 2 * t);
      const float p0 = ex2(fmaf(st[4 * jb], scale_log2, -L.x));  // 0 for a query past S
      const float p1 = ex2(fmaf(st[4 * jb + 1], scale_log2, -L.y));
      const float p2 = ex2(fmaf(st[4 * jb + 2], scale_log2, -L.x));
      const float p3 = ex2(fmaf(st[4 * jb + 3], scale_log2, -L.y));
      pa[jb / 2][(jb % 2) * 2] = pack_bf16(p0, p1);
      pa[jb / 2][(jb % 2) * 2 + 1] = pack_bf16(p2, p3);
      dsa[jb / 2][(jb % 2) * 2] = pack_bf16(p0 * (dpt[4 * jb] - Dq.x) * scale,
                                            p1 * (dpt[4 * jb + 1] - Dq.y) * scale);
      dsa[jb / 2][(jb % 2) * 2 + 1] = pack_bf16(p2 * (dpt[4 * jb + 2] - Dq.x) * scale,
                                                p3 * (dpt[4 * jb + 3] - Dq.y) * scale);
    }

    fence_regs(dva);
    fence_regs(dka);
    wgmma_fence();
    accumulate_mnmajor<D>(dva, pa, T::desc(do_t));  // dV += P^T dO
    accumulate_mnmajor<D>(dka, dsa, T::desc(q_t));  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
  }
  cp_async_wait<0>();
  if (!active) return;
  store_rows<D>(dk + b * dks.b + h * dks.h, dks.s, dka, key_lo, S, t, 1.f, 1.f);
  store_rows<D>(dv + b * dvs.b + h * dvs.h, dvs.s, dva, key_lo, S, t, 1.f, 1.f);
}

// Pass 3: dQ of one tile of 64 WGS queries; loops over every 64-key tile.
template <int D, int WGS>
__global__ void __launch_bounds__(128 * WGS, WGS == 2 ? 2 : 1)
attn_bwd_dq_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ stats, __nv_bfloat16* __restrict__ dq, int H, int S,
                  int SP, int row_tiles, Strides qs, Strides ks, Strides vs, Strides dos,
                  Strides dqs, float scale, float scale_log2) {
  using namespace sm90;
  using T = Tile<D>;
  constexpr int ROWS = 64 * WGS;
  constexpr int OWN_BYTES = ROWS * T::ROW_BYTES, TILE_BYTES = W_TILE * T::ROW_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t do_s = q_s + OWN_BYTES;
  const uint32_t ring_s = do_s + OWN_BYTES;  // stage i: K at + 2 i TILE_BYTES, then V

  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x / row_tiles;
  const long long b = bh / H, h = bh % H;
  const int q0 = (blockIdx.x % row_tiles) * ROWS;
  const int r_lo = q0 + wg * 64 + warp * 16 + g, r_hi = r_lo + 8;
  const bool active = q0 + wg * 64 < S;  // warpgroup-uniform
  const bool loader = threadIdx.x < W_LOADERS;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  const int n_tiles = (S + W_TILE - 1) / W_TILE;

  auto load_stage = [&](int tile) {  // one commit group per call, empty past the last tile
    if (tile < n_tiles && loader) {
      const uint32_t dst = ring_s + (tile % W_STAGES) * 2 * TILE_BYTES;
      load_tile_async<D, W_TILE, W_LOADERS>(dst, kb, ks.s, tile * W_TILE, S);
      load_tile_async<D, W_TILE, W_LOADERS>(dst + TILE_BYTES, vb, vs.s, tile * W_TILE, S);
    }
    cp_async_commit();
  };
  if (loader) {
    load_tile_async<D, ROWS, W_LOADERS>(q_s, q + b * qs.b + h * qs.h, qs.s, q0, S);
    load_tile_async<D, ROWS, W_LOADERS>(do_s, dout + b * dos.b + h * dos.h, dos.s, q0, S);
  }
#pragma unroll
  for (int i = 0; i < W_STAGES - 1; ++i) load_stage(i);  // Q and dO ride in the first group

  // a row past S: P = 2^-inf = 0, so dS = 0; its dQ is not written
  const float* sb = stats + (long long)bh * 2 * SP;
  const float L_lo = r_lo < S ? sb[r_lo] : INFINITY, L_hi = r_hi < S ? sb[r_hi] : INFINITY;
  const float D_lo = r_lo < S ? sb[SP + r_lo] : 0.f, D_hi = r_hi < S ? sb[SP + r_hi] : 0.f;

  const uint64_t q_desc = T::desc(q_s + wg * 64 * T::ROW_BYTES);
  const uint64_t do_desc = T::desc(do_s + wg * 64 * T::ROW_BYTES);
  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<W_STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    load_stage(j + W_STAGES - 1);
    if (!active) continue;

    const uint32_t k_t = ring_s + (j % W_STAGES) * 2 * TILE_BYTES, v_t = k_t + TILE_BYTES;
    float sc[32], dp[32];  // S and dP: rows = queries, columns = keys
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    product_kmajor<D>(sc, q_desc, T::desc(k_t));
    product_kmajor<D>(dp, do_desc, T::desc(v_t));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    const bool tail = j * W_TILE + W_TILE > S;  // the ragged tail: keys at or past S, P = 0
    uint32_t dsa[4][4];  // dS in bf16, as A fragments
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p_lo = ex2(fmaf(sc[4 * jb + e], scale_log2, -L_lo));
        float p_hi = ex2(fmaf(sc[4 * jb + 2 + e], scale_log2, -L_hi));
        if (tail && j * W_TILE + jb * 8 + 2 * t + e >= S) p_lo = p_hi = 0.f;
        ds[e] = p_lo * (dp[4 * jb + e] - D_lo) * scale;
        ds[2 + e] = p_hi * (dp[4 * jb + 2 + e] - D_hi) * scale;
      }
      dsa[jb / 2][(jb % 2) * 2] = pack_bf16(ds[0], ds[1]);
      dsa[jb / 2][(jb % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    fence_regs(dqa);
    wgmma_fence();
    accumulate_mnmajor<D>(dqa, dsa, T::desc(k_t));  // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqa);
  }
  cp_async_wait<0>();
  if (!active) return;
  store_rows<D>(dq + b * dqs.b + h * dqs.h, dqs.s, dqa, r_lo, S, t, 1.f, 1.f);
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* dout,
                         const float* stats, void* dq, void* dk, void* dv, int B, int H, int S,
                         int SP, const Strides* st, float scale, cudaStream_t s) {
  using bf = __nv_bfloat16;
  constexpr int DKDV_SMEM = bwd_smem_bytes<D, DKDV_WGS>(true);
  constexpr int DQ_SMEM = bwd_smem_bytes<D, DQ_WGS>(false);
  static cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(attn_bwd_dkdv_wgmma<D, DKDV_WGS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, DKDV_SMEM);
    return e != cudaSuccess ? e
                            : cudaFuncSetAttribute(attn_bwd_dq_wgmma<D, DQ_WGS>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   DQ_SMEM);
  }();
  if (attr != cudaSuccess) return attr;
  const unsigned heads = (unsigned)B * H;
  const int key_tiles = (S + 64 * DKDV_WGS - 1) / (64 * DKDV_WGS);
  attn_bwd_dkdv_wgmma<D, DKDV_WGS><<<key_tiles * heads, 128 * DKDV_WGS, DKDV_SMEM, s>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), stats, static_cast<bf*>(dk), static_cast<bf*>(dv), H, S, SP,
      key_tiles, st[0], st[1], st[2], st[4], st[6], st[7], scale, scale * sm90::LOG2E);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int q_tiles = (S + 64 * DQ_WGS - 1) / (64 * DQ_WGS);
  attn_bwd_dq_wgmma<D, DQ_WGS><<<q_tiles * heads, 128 * DQ_WGS, DQ_SMEM, s>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), stats, static_cast<bf*>(dq), H, S, SP, q_tiles, st[0],
      st[1], st[2], st[4], st[5], scale, scale * sm90::LOG2E);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* dout,
                       const float* stats, void* dq, void* dk, void* dv, int B, int H, int S,
                       int SP, const Strides* st, float scale, cudaStream_t s) {
  const unsigned grid = (unsigned)((S + F_THREADS - 1) / F_THREADS) * B * H;
  attn_bwd_dkdv_f32<D><<<grid, F_THREADS, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), stats, static_cast<float*>(dk), static_cast<float*>(dv),
      H, S, SP, st[0], st[1], st[2], st[4], st[6], st[7], scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dq_f32<D><<<grid, F_THREADS, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), stats, static_cast<float*>(dq), H, S, SP, st[0], st[1],
      st[2], st[4], st[5], scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_stats(const void* o, const void* dout, const float* lse, float* stats, int B,
                         int H, int S, int SP, const Strides* st, cudaStream_t s) {
  constexpr int ROWS = STATS_THREADS / (sizeof(T) == 2 ? D / 8 : 8);  // rows per block
  const unsigned grid = (unsigned)((SP + ROWS - 1) / ROWS) * B * H;
  attn_bwd_stats_kernel<T, D><<<grid, STATS_THREADS, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, stats, H, S, SP, st[3], st[4]);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_all(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* stats, void* dq, void* dk,
                       void* dv, int B, int H, int S, const Strides* st, float scale,
                       cudaStream_t s) {
  const int SP = (S + 63) / 64 * 64;
  const cudaError_t err = launch_stats<T, D>(o, dout, lse, stats, B, H, S, SP, st, s);
  if (err != cudaSuccess) return err;
  if constexpr (sizeof(T) == 2)
    return launch_wgmma<D>(q, k, v, dout, stats, dq, dk, dv, B, H, S, SP, st, scale, s);
  else
    return launch_f32<D>(q, k, v, dout, stats, dq, dk, dv, B, H, S, SP, st, scale, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: 24 element strides, (batch,
// head, seq) of q, k, v, o, dout, dq, dk, dv in that order; the head dim of
// every tensor must be contiguous; for bfloat16 the pointers must be 16-byte
// aligned and the strides multiples of 8 (checked by the Python wrapper).
// lse: K1's float32 (B, H, S) row log-sum-exp; stats: float32 scratch of
// B * H * 2 * SP values, SP = S rounded up to a multiple of 64, written here
// (16-byte aligned). Launches the three passes on `stream` and returns the
// first launch error (cudaGetLastError()), or 0.
int attention_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const void* lse, void* stats, void* dq, void* dk, void* dv, int dtype, int B,
                  int H, int S, int D, const long long* strides, float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return cudaErrorInvalidValue;
  // every grid is one dimension of (batch*head, row tile) pairs, 32 rows at least
  if ((long long)B * H * ((S + 63) / 64 * 2) > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (!((dtype == 0 || dtype == 1) && (D == 32 || D == 64))) return cudaErrorInvalidValue;
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* w = static_cast<float*>(stats);
  using bf = __nv_bfloat16;
  if (dtype == 0 && D == 64)
    return launch_all<float, 64>(q, k, v, o, dout, l, w, dq, dk, dv, B, H, S, st, scale, s);
  if (dtype == 0)
    return launch_all<float, 32>(q, k, v, o, dout, l, w, dq, dk, dv, B, H, S, st, scale, s);
  if (D == 64) return launch_all<bf, 64>(q, k, v, o, dout, l, w, dq, dk, dv, B, H, S, st, scale, s);
  return launch_all<bf, 32>(q, k, v, o, dout, l, w, dq, dk, dv, B, H, S, st, scale, s);
}

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
