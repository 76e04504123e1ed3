// K1: forward multi-head attention of the AST ViT blocks, for Hopper (sm_90a).
//
// Replaces the TPU kernel amuse_tpu/ops/attention.py::_attn_kernel (reached
// through _mha_fwd_padded_raw -> mha_pallas -> mha). Same function:
//   O = softmax(Q K^T / sqrt(d)) V   per (batch, head)
// with the softmax in float32, dot inputs in the storage type (bf16 or f32)
// accumulated in float32, P cast to V's type before P V, and the row
// division applied to the output row instead of the (S, S) plane.
// Optionally (lse != nullptr) it also writes each row's float32 log-sum-exp
// of the scaled scores, (B, H, S) contiguous, which the backward kernel K2
// (attention_bwd.cu) reads to rebuild P without a second softmax pass. The
// LSE store is a template switch (WITH_LSE), chosen at launch by whether lse
// is null: the inference path (nullptr) runs an instantiation with no LSE
// code in it, so its registers and occupancy are those of the kernel
// without the output.
//
// Bound on the H100: compute. 4 S^2 D operations per (batch, head): at the
// AST shape (S 1214, D 64, 12 heads x 3 encoders per window) that is about
// 13.6 GFLOP per ViT block call at N = 1, ~14 us at 989 TFLOP/s bf16.
//
// Design. The TPU kernel holds one head's whole K and V in VMEM (1280 x 64
// bf16 = 160 KiB each), which does not fit a Hopper block's 227 KB of
// shared memory together. Here K/V stream through shared memory in tiles
// with an online softmax (running max and sum per row); the ragged tail of
// S is masked in the kernel, with no padding to a block multiple. Q, K, V
// and O are taken with their own (batch, head, seq) strides and a
// contiguous head dim, so strided views of the fused qkv projection feed it
// without copies.
//   bf16 (the main path): one block of 4 warps per (batch*head, 64-row q
//   tile), 16 rows per warp; Q K^T and P V run on the tensor cores as
//   mma.sync m16n8k16 (bf16 in, f32 accumulate) over 64-key tiles held in
//   padded (bank-conflict-free) shared memory; S and P stay in registers,
//   P is rounded to bf16 as the A operand of P V. Loads are synchronous
//   16-byte copies (no cp.async/TMA pipelining, no wgmma): later work.
//   float32: one thread per query row, 32-key tiles, float32 FMAs with
//   broadcast shared-memory operands (no tensor cores: TF32 would round
//   the inputs the plain version keeps).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

  const int bh = blockIdx.y;
  const long long b = bh / H, h = bh % H;
  const int row = blockIdx.x * BQ + threadIdx.x;
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

constexpr int MMA_BQ = 64;  // query rows per block: 4 warps x 16
constexpr int MMA_BK = 64;  // keys per shared-memory tile
constexpr int MMA_THREADS = 128;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(unsigned short lo, unsigned short hi) {
  return (static_cast<uint32_t>(hi) << 16) | lo;
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4): A regs hold
// (row g | g+8, col 2t..2t+1 | 8+2t..), B regs (k 2t..2t+1 | 8+2t.., col g),
// C (row g | g+8, col 2t..2t+1). The S accumulators of two adjacent 8-key
// tiles are therefore exactly the A operand of P V.
template <int D, bool WITH_LSE>
__global__ void __launch_bounds__(MMA_THREADS)
attn_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                    float* __restrict__ lse, int H, int S, Strides qs, Strides ks, Strides vs,
                    Strides os, float scale) {
  constexpr int LD = D + 8;          // padded row: conflict-free fragment loads
  constexpr int KSTEPS = D / 16;     // k-steps of Q K^T
  constexpr int NT_S = MMA_BK / 8;   // 8-key tiles of S
  constexpr int NT_O = D / 8;        // 8-column tiles of O
  __shared__ __align__(16) __nv_bfloat16 Ks[MMA_BK * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[MMA_BK * LD];
  const unsigned short* Vraw = reinterpret_cast<const unsigned short*>(Vs);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const long long b = bh / H, h = bh % H;
  const int r_lo = blockIdx.x * MMA_BQ + warp * 16 + g, r_hi = r_lo + 8;
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;

  auto qword = [&](int r, int c) -> uint32_t {  // two adjacent bf16 of Q; 0 past S
    return r < S ? *reinterpret_cast<const uint32_t*>(qb + (long long)r * qs.s + c) : 0u;
  };
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    qa[kk][0] = qword(r_lo, kk * 16 + 2 * t);
    qa[kk][1] = qword(r_hi, kk * 16 + 2 * t);
    qa[kk][2] = qword(r_lo, kk * 16 + 8 + 2 * t);
    qa[kk][3] = qword(r_hi, kk * 16 + 8 + 2 * t);
  }

  float oacc[NT_O][4];
#pragma unroll
  for (int nt = 0; nt < NT_O; ++nt) oacc[nt][0] = oacc[nt][1] = oacc[nt][2] = oacc[nt][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  for (int k0 = 0; k0 < S; k0 += MMA_BK) {
    __syncthreads();  // the previous tile is no longer read
    constexpr int VECS = MMA_BK * D / 8;  // 16-byte vectors per tile
    for (int i = threadIdx.x; i < VECS; i += MMA_THREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const int key = k0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (key < S) {
        kv = *reinterpret_cast<const uint4*>(kb + (long long)key * ks.s + c);
        vv = *reinterpret_cast<const uint4*>(vb + (long long)key * vs.s + c);
      }
      *reinterpret_cast<uint4*>(&Ks[r * LD + c]) = kv;
      *reinterpret_cast<uint4*>(&Vs[r * LD + c]) = vv;
    }
    __syncthreads();

    float sacc[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
      const __nv_bfloat16* kr = &Ks[(j * 8 + g) * LD];
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 2 * t);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8 + 2 * t);
        mma_bf16(sacc[j], qa[kk], b0, b1);
      }
    }

    float tmax_lo = -INFINITY, tmax_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = k0 + j * 8 + 2 * t + e < S;  // mask the ragged tail
        sacc[j][e] = in ? sacc[j][e] * scale : -INFINITY;
        sacc[j][2 + e] = in ? sacc[j][2 + e] * scale : -INFINITY;
        tmax_lo = fmaxf(tmax_lo, sacc[j][e]);
        tmax_hi = fmaxf(tmax_hi, sacc[j][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {  // the 4 threads of a row
      tmax_lo = fmaxf(tmax_lo, __shfl_xor_sync(0xffffffffu, tmax_lo, off));
      tmax_hi = fmaxf(tmax_hi, __shfl_xor_sync(0xffffffffu, tmax_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, tmax_lo), mn_hi = fmaxf(m_hi, tmax_hi);
    const float a_lo = expf(m_lo - mn_lo), a_hi = expf(m_hi - mn_hi);  // 0 on the first tile
    l_lo *= a_lo;
    l_hi *= a_hi;
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      oacc[nt][0] *= a_lo;
      oacc[nt][1] *= a_lo;
      oacc[nt][2] *= a_hi;
      oacc[nt][3] *= a_hi;
    }

    uint32_t pa[MMA_BK / 16][4];  // P in bf16, as A fragments of P V
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      const float p0 = expf(sacc[j][0] - mn_lo), p1 = expf(sacc[j][1] - mn_lo);
      const float p2 = expf(sacc[j][2] - mn_hi), p3 = expf(sacc[j][3] - mn_hi);
      l_lo += p0 + p1;
      l_hi += p2 + p3;
      pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    m_lo = mn_lo;
    m_hi = mn_hi;

#pragma unroll
    for (int kk = 0; kk < MMA_BK / 16; ++kk) {
      const int key = kk * 16 + 2 * t;
#pragma unroll
      for (int nt = 0; nt < NT_O; ++nt) {
        const int col = nt * 8 + g;
        const uint32_t b0 = pack_raw(Vraw[key * LD + col], Vraw[(key + 1) * LD + col]);
        const uint32_t b1 = pack_raw(Vraw[(key + 8) * LD + col], Vraw[(key + 9) * LD + col]);
        mma_bf16(oacc[nt], pa[kk], b0, b1);
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int nt = 0; nt < NT_O; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (r_lo < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r_lo * os.s + c) =
          __floats2bfloat162_rn(oacc[nt][0] / l_lo, oacc[nt][1] / l_lo);
    if (r_hi < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r_hi * os.s + c) =
          __floats2bfloat162_rn(oacc[nt][2] / l_hi, oacc[nt][3] / l_hi);
  }
  if constexpr (WITH_LSE) {
    if (t == 0 && r_lo < S) lse[(long long)bh * S + r_lo] = m_lo + logf(l_lo);
    if (t == 0 && r_hi < S) lse[(long long)bh * S + r_hi] = m_hi + logf(l_hi);
  }
}

template <int D>
void launch_mma(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                int S, Strides qs, Strides ks, Strides vs, Strides os, float scale,
                cudaStream_t st) {
  const dim3 grid((S + MMA_BQ - 1) / MMA_BQ, B * H);
  const auto kernel = lse ? attn_fwd_mma_kernel<D, true> : attn_fwd_mma_kernel<D, false>;
  kernel<<<grid, MMA_THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, H, S, qs, ks,
      vs, os, scale);
}

template <int D>
void launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                int S, Strides qs, Strides ks, Strides vs, Strides os, float scale,
                cudaStream_t st) {
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  const auto kernel = lse ? attn_fwd_kernel<D, true> : attn_fwd_kernel<D, false>;
  kernel<<<grid, BQ, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, H, S, qs, ks, vs, os, scale);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head dim
// must be contiguous; for bfloat16 the pointers must be 16-byte aligned and
// the strides multiples of 8 (checked by the Python wrapper). lse is
// nullptr or a float32 (B, H, S) contiguous buffer for the row log-sum-exp.
// Returns cudaGetLastError() after the launch.
int attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int dtype,
                  int B, int H, int S, int D, long long q_sb, long long q_sh, long long q_ss,
                  long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                  long long v_sh, long long v_ss, long long o_sb, long long o_sh,
                  long long o_ss, float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B * H > 65535) return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0 && D == 64) {
    launch_f32<64>(q, k, v, o, l, B, H, S, qs, ks, vs, os, scale, st);
  } else if (dtype == 0 && D == 32) {
    launch_f32<32>(q, k, v, o, l, B, H, S, qs, ks, vs, os, scale, st);
  } else if (dtype == 1 && D == 64) {
    launch_mma<64>(q, k, v, o, l, B, H, S, qs, ks, vs, os, scale, st);
  } else if (dtype == 1 && D == 32) {
    launch_mma<32>(q, k, v, o, l, B, H, S, qs, ks, vs, os, scale, st);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
