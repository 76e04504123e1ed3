// K1: forward multi-head attention of the AST ViT blocks, for Hopper (sm_90a).
//
// Replaces the TPU kernel amuse_tpu/ops/attention.py::_attn_kernel (reached
// through _mha_fwd_padded_raw -> mha_pallas -> mha). Same function:
//   O = softmax(Q K^T / sqrt(d)) V   per (batch, head)
// with the softmax in float32, dot inputs in the storage type (bf16 or f32)
// accumulated in float32, P cast to V's type before P V, and the row
// division applied to the output row instead of the (S, S) plane.
// Optionally (lse != nullptr) it also writes each row's float32 log-sum-exp
// of the scaled scores (natural log), (B, H, S) contiguous, which the
// backward kernel K2 (attention_bwd.cu) reads to rebuild P without a second
// softmax pass. The LSE store is a template switch (WITH_LSE), chosen at
// launch by whether lse is null: the inference path (nullptr) runs an
// instantiation with no LSE code in it.
//
// Bound on the H100: compute. 4 S^2 D operations per (batch, head): at the
// AST shape (S 1214, D 64, 12 heads x 3 encoders per window) that is about
// 13.6 GFLOP per ViT block call at N = 1, ~14 us at 989 TFLOP/s bf16. At
// D 64 the softmax costs the SM as much as the products do (one exp2 on the
// 16-per-clock special-function units per 256 tensor-core operations at
// 4096 per clock), so about twice the bound is the practical floor.
//
// Design. The TPU kernel holds one head's whole K and V in VMEM (1280 x 64
// bf16 = 160 KiB each), which does not fit a Hopper block's 227 KB of
// shared memory together. Here K/V stream through shared memory in tiles
// with an online softmax (running max and sum per row); the ragged tail of
// S is masked in the kernel, with no padding to a block multiple. Q, K, V
// and O are taken with their own (batch, head, seq) strides and a
// contiguous head dim, so strided views of the fused qkv projection feed it
// without copies.
//   bf16 (the main path; D 64 and D 32 are one template): one block of two
//   warpgroups (256 threads) per (batch*head, 128-row q tile), 64 rows per
//   warpgroup. K and V arrive in 64-key tiles through a 4-stage ring in
//   shared memory filled by cp.async (sm90_tile.cuh: swizzled tiles,
//   zero-filled past S), so the loads of tiles j+1 and j+2 are in flight
//   while the tensor cores work on tiles j and j-1; one block barrier per
//   tile. cp.async rather than TMA: the operands are strided views whose
//   pointers change with every call of a train step, so tensor maps would
//   be encoded (or looked up) on the host for every launch of a step that
//   is already paced by its host, while the copy costs a thread four
//   instructions per tile; its zero-fill also serves a ragged or sub-tile S
//   with no transaction count that could leave a barrier waiting. S = Q K^T runs as
//   wgmma m64n64k16 with both operands read from shared memory through
//   matrix descriptors; S, the running max/sum and P stay in registers (the
//   accumulator's thread layout is that of mma.sync: rows lane/4 and +8,
//   columns 8j + 2(lane%4)), P is rounded to bf16 as the register A operand
//   of O += P V, whose B operand is the V tile read MN-major (transpose
//   bit), no transposing copy. The softmax runs in base 2: scale * log2(e)
//   is folded into one FMA per score before a single ex2; the LSE is
//   converted back, (m + log2(l)) * ln(2).
//   Warpgroup 1 runs half a tile behind warpgroup 0 (its O += P V of tile
//   j-1 is issued where warpgroup 0 issues S of tile j), so that one's
//   softmax meets the other's products; O += P V is left in flight across
//   the barrier and waited for with the next S. Against the plain order
//   this gained a few percent at both shapes when it was introduced.
//   Registers (ptxas, D 64): 120-123 a thread, bounded to 128, so two
//   blocks (four warpgroups) share an SM (81 KB of shared memory each); no
//   spill. A warpgroup whose 64 rows lie wholly past S (the second half of
//   the last q tile) joins the loads and barriers and skips the arithmetic.
//   The grid is one dimension, (batch*head, q tile) with the tile fastest,
//   so the blocks of one head run together and share K and V in L2.
//   It runs at about a third of the tensor-core peak: per tile each
//   warpgroup walks the chain barrier -> wgmma -> wait -> softmax -> wgmma,
//   and the four warpgroups an SM holds overlap products and softmax only in
//   part. Three warpgroups of 128-key tiles (one block an SM) were faster at
//   (3, 12, 1214, 64), whose 360 blocks fill 1.4 waves here, and slower at
//   the train step's shape; one configuration is kept.
//   float32: one thread per query row, 32-key tiles, float32 FMAs with
//   broadcast shared-memory operands (no tensor cores: TF32 would round
//   the inputs the plain version keeps).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_tile.cuh"

namespace {

constexpr int BQ = 128;  // float32 path: query rows per block, one per thread
constexpr int BK = 32;   // float32 path: keys per shared-memory tile

struct Strides {
  long long b, h, s;
};

// float32 path: one query row per thread.
template <int D, bool WITH_LSE>
__global__ void __launch_bounds__(BQ)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                int H, int S, Strides qs, Strides ks, Strides vs, Strides os, float scale) {
  __shared__ float Ks[BK][D];
  __shared__ float Vs[BK][D];

  const int q_tiles = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x / q_tiles;
  const long long b = bh / H, h = bh % H;
  const int row = (blockIdx.x % q_tiles) * BQ + threadIdx.x;
  const bool valid = row < S;

  const float* qp = q + b * qs.b + h * qs.h + (long long)(valid ? row : 0) * qs.s;
  const float* kp = k + b * ks.b + h * ks.h;
  const float* vp = v + b * vs.b + h * vs.h;

  float qr[D], acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    qr[c] = qp[c];
    acc[c] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < S; k0 += BK) {
    const int nk = min(BK, S - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < BK * D; i += BQ) {
      const int r = i / D, c = i % D;
      const bool in = r < nk;
      Ks[r][c] = in ? kp[(long long)(k0 + r) * ks.s + c] : 0.f;
      Vs[r][c] = in ? vp[(long long)(k0 + r) * vs.s + c] : 0.f;
    }
    __syncthreads();

    float s[BK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) dot = fmaf(qr[c], Ks[j][c], dot);
      s[j] = j < nk ? dot * scale : -INFINITY;  // mask the ragged tail
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);  // finite: every tile has a real key
    const float alpha = expf(m - m_new);     // 0 on the first tile
    l *= alpha;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);  // exactly 0 on masked keys
      l += p;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = fmaf(p, Vs[j][c], acc[c]);
    }
    m = m_new;
  }

  if (valid) {
    float* op = o + b * os.b + h * os.h + (long long)row * os.s;
#pragma unroll
    for (int c = 0; c < D; ++c) op[c] = acc[c] / l;
    if constexpr (WITH_LSE) lse[(long long)bh * S + row] = m + logf(l);
  }
}

// ------------------------------------------------------------------ bf16

constexpr int W_BM = 128;      // query rows per block: two warpgroups x 64
constexpr int W_BK = 64;       // keys per shared-memory tile
constexpr int W_STAGES = 4;    // K/V tiles in the ring
constexpr int W_AHEAD = 2;     // tiles loading ahead of the one at work; two more are being read
constexpr int W_THREADS = 256;

template <int D>
constexpr int fwd_smem_bytes() {
  return 1024 + (W_BM + 2 * W_STAGES * W_BK) * sm90::Tile<D>::ROW_BYTES;  // 1024: alignment
}

template <int D, bool WITH_LSE>
__global__ void __launch_bounds__(W_THREADS, 2)
attn_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int H, int S, int q_tiles, Strides qs, Strides ks,
                      Strides vs, Strides os, float scale_log2) {
  using namespace sm90;
  using T = Tile<D>;
  constexpr int KV_BYTES = W_BK * T::ROW_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + W_BM * T::ROW_BYTES;  // stage i: K at + 2 i KV_BYTES, then V

  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x / q_tiles;
  const long long b = bh / H, h = bh % H;
  const int q0 = (blockIdx.x % q_tiles) * W_BM;
  const int r_lo = q0 + wg * 64 + warp * 16 + g;
  const bool active = q0 + wg * 64 < S;  // warpgroup-uniform
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  const int n_tiles = (S + W_BK - 1) / W_BK;

  auto load_kv = [&](int tile) {  // one commit group per call, empty past the last tile
    if (tile < n_tiles) {
      const uint32_t dst = kv_s + (tile % W_STAGES) * 2 * KV_BYTES;
      load_tile_async<D, W_BK, W_THREADS>(dst, kb, ks.s, tile * W_BK, S);
      load_tile_async<D, W_BK, W_THREADS>(dst + KV_BYTES, vb, vs.s, tile * W_BK, S);
    }
    cp_async_commit();
  };
  load_tile_async<D, W_BM, W_THREADS>(q_s, q + b * qs.b + h * qs.h, qs.s, q0, S);
#pragma unroll
  for (int i = 0; i < W_AHEAD; ++i) load_kv(i);  // Q rides in the first group

  const uint64_t q_desc = T::desc(q_s + wg * 64 * T::ROW_BYTES);
  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;  // m in base-2 units

  // The work on tile j has two phases: A, S = Q K^T and the softmax update
  // (which first waits for every wgmma in flight, so the O it rescales is
  // whole), and B, O += P V, issued and left in flight. Warpgroup 0 runs
  // A(j) B(j) between two block barriers, warpgroup 1 runs B(j-1) A(j): one
  // warpgroup's softmax overlaps the other's products.
  uint32_t pa[4][4];  // P in bf16, as A fragments of P V
  auto phase_a = [&](int j) {
    const uint32_t k_s = kv_s + (j % W_STAGES) * 2 * KV_BYTES;
    float sacc[32];
    fence_regs(sacc);
    wgmma_fence();
    product_kmajor<D>(sacc, q_desc, T::desc(k_s));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);
    fence_regs(oacc);

    if (j * W_BK + W_BK > S) {  // the ragged tail: keys at or past S
#pragma unroll
      for (int jb = 0; jb < 8; ++jb)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (j * W_BK + jb * 8 + 2 * t + e >= S)
            sacc[4 * jb + e] = sacc[4 * jb + 2 + e] = -INFINITY;
    }
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      mx_lo = fmaxf(mx_lo, fmaxf(sacc[4 * jb], sacc[4 * jb + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sacc[4 * jb + 2], sacc[4 * jb + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {  // the 4 threads of a row
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    // finite: every tile has a real key
    const float mn_lo = fmaxf(m_lo, mx_lo * scale_log2), mn_hi = fmaxf(m_hi, mx_hi * scale_log2);
    const float a_lo = ex2(m_lo - mn_lo), a_hi = ex2(m_hi - mn_hi);  // 0 on the first tile
    m_lo = mn_lo;
    m_hi = mn_hi;
    l_lo *= a_lo;
    l_hi *= a_hi;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      oacc[4 * nt] *= a_lo;
      oacc[4 * nt + 1] *= a_lo;
      oacc[4 * nt + 2] *= a_hi;
      oacc[4 * nt + 3] *= a_hi;
    }
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      const float p0 = ex2(fmaf(sacc[4 * jb], scale_log2, -mn_lo));  // exactly 0 on masked keys
      const float p1 = ex2(fmaf(sacc[4 * jb + 1], scale_log2, -mn_lo));
      const float p2 = ex2(fmaf(sacc[4 * jb + 2], scale_log2, -mn_hi));
      const float p3 = ex2(fmaf(sacc[4 * jb + 3], scale_log2, -mn_hi));
      l_lo += p0 + p1;
      l_hi += p2 + p3;
      pa[jb / 2][(jb % 2) * 2] = pack_bf16(p0, p1);
      pa[jb / 2][(jb % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
  };
  auto phase_b = [&](int j) {
    fence_regs(oacc);
    wgmma_fence();
    accumulate_mnmajor<D>(oacc, pa, T::desc(kv_s + (j % W_STAGES) * 2 * KV_BYTES + KV_BYTES));
    wgmma_commit();
  };

  for (int j = 0; j <= n_tiles; ++j) {  // the last round is warpgroup 1's B(n_tiles - 1)
    cp_async_wait<W_AHEAD - 1>();  // this thread's part of tile j has landed
    fence_proxy_async();
    __syncthreads();  // tile j is whole; tile j-2 is no longer read
    load_kv(j + W_AHEAD);  // into the stage tile j-2 held
    if (!active) continue;
    if (wg == 0) {
      if (j < n_tiles) {
        phase_a(j);
        phase_b(j);
      }
    } else {
      if (j > 0) phase_b(j - 1);
      if (j < n_tiles) phase_a(j);
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
  store_rows<D>(o + b * os.b + h * os.h, os.s, oacc, r_lo, S, t, 1.f / l_lo, 1.f / l_hi);
  if constexpr (WITH_LSE) {
    if (t == 0 && r_lo < S) lse[(long long)bh * S + r_lo] = (m_lo + log2f(l_lo)) * LN2;
    if (t == 0 && r_lo + 8 < S) lse[(long long)bh * S + r_lo + 8] = (m_hi + log2f(l_hi)) * LN2;
  }
}

template <int D, bool WITH_LSE>
cudaError_t launch_wgmma_as(const void* q, const void* k, const void* v, void* o, float* lse,
                            int B, int H, int S, Strides qs, Strides ks, Strides vs, Strides os,
                            float scale, cudaStream_t st) {
  const auto kernel = attn_fwd_wgmma_kernel<D, WITH_LSE>;
  static cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, fwd_smem_bytes<D>());
  if (attr != cudaSuccess) return attr;
  const int q_tiles = (S + W_BM - 1) / W_BM;
  kernel<<<(unsigned)q_tiles * B * H, W_THREADS, fwd_smem_bytes<D>(), st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, H, S, q_tiles,
      qs, ks, vs, os, scale * sm90::LOG2E);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                         int H, int S, Strides qs, Strides ks, Strides vs, Strides os,
                         float scale, cudaStream_t st) {
  return lse ? launch_wgmma_as<D, true>(q, k, v, o, lse, B, H, S, qs, ks, vs, os, scale, st)
             : launch_wgmma_as<D, false>(q, k, v, o, lse, B, H, S, qs, ks, vs, os, scale, st);
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int H, int S, Strides qs, Strides ks, Strides vs, Strides os, float scale,
                       cudaStream_t st) {
  const unsigned grid = (unsigned)((S + BQ - 1) / BQ) * B * H;
  const auto kernel = lse ? attn_fwd_kernel<D, true> : attn_fwd_kernel<D, false>;
  kernel<<<grid, BQ, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, H, S, qs, ks, vs, os, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head dim
// must be contiguous; for bfloat16 the pointers must be 16-byte aligned and
// the strides multiples of 8 (checked by the Python wrapper). lse is
// nullptr or a float32 (B, H, S) contiguous buffer for the row log-sum-exp.
// Returns the first CUDA error of the launch (cudaGetLastError()), or 0.
int attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int dtype,
                  int B, int H, int S, int D, long long q_sb, long long q_sh, long long q_ss,
                  long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                  long long v_sh, long long v_ss, long long o_sb, long long o_sh,
                  long long o_ss, float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return cudaErrorInvalidValue;
  // every grid is one dimension of (batch*head, row tile) pairs, 32 rows at least
  if ((long long)B * H * ((S + 31) / 32) > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (!((dtype == 0 || dtype == 1) && (D == 32 || D == 64))) return cudaErrorInvalidValue;
  const auto launch = dtype == 0 ? (D == 64 ? launch_f32<64> : launch_f32<32>)
                                 : (D == 64 ? launch_wgmma<64> : launch_wgmma<32>);
  return launch(q, k, v, o, l, B, H, S, qs, ks, vs, os, scale, st);
}

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
