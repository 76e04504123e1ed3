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
// 179 MB) take 0.053 ms at 3.35 TB/s.
//
// Design. The TPU kernel keeps dK and dV of a whole head in VMEM and adds to
// them across q-blocks, "correct only because TPU grid steps run in order".
// Hopper blocks run concurrently and in no order, so the work is split into
// passes that each own their outputs, with no atomics (deterministic):
//   1. delta: Delta_i = rowsum(dO_i * O_i) in float32, one thread per row.
//   2. dK/dV, kv-tile-major: one block of 4 warps per (batch*head, 64-key
//      tile), 16 keys per warp, K and V of the warp's keys held as mma A
//      fragments in registers; loops over 64-query tiles of Q and dO in
//      padded shared memory. S^T = K Q^T and dP^T = V dO^T run on the tensor
//      cores; P^T and dS^T stay in registers and are exactly the A operands
//      of dV += P^T dO and dK += dS^T Q (C layout of two 8-query tiles = A
//      layout of a 16-query k-step, as in K1).
//   3. dQ, q-tile-major: one block per (batch*head, 64-query tile), Q and dO
//      as A fragments, K and V tiles streamed through shared memory;
//      dQ += dS K.
// The ragged tail of S is masked in the kernel (P = 0 for keys >= S and for
// queries >= S), with no padding. All eight tensors are taken with their own
// (batch, head, seq) strides and a contiguous head dim, so q, k, v come in
// as strided views of the fused qkv projection and dq, dk, dv are written as
// views of one (B, S, 3, H, D) buffer: the qkv Linear's backward gets one
// contiguous gradient.
//   bf16 (the main path): mma.sync m16n8k16 (bf16 in, f32 accumulate),
//   synchronous 16-byte loads (no cp.async/TMA pipelining, no wgmma yet).
//   float32: one thread per key (dK/dV) or per query (dQ), scalar FMAs
//   over shared-memory tiles (no tensor cores: TF32 would round the inputs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// Pass 1: Delta_i = sum_d dO[i, d] * O[i, d], float32, (B*H, S) contiguous.
constexpr int DELTA_THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(DELTA_THREADS)
attn_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ delta, int H, int S, int D, Strides os,
                      Strides dos) {
  const int bh = blockIdx.y;
  const long long b = bh / H, h = bh % H;
  const int row = blockIdx.x * DELTA_THREADS + threadIdx.x;
  if (row >= S) return;
  const T* op = o + b * os.b + h * os.h + (long long)row * os.s;
  const T* dp = dout + b * dos.b + h * dos.h + (long long)row * dos.s;
  float acc = 0.f;
  for (int c = 0; c < D; ++c) acc = fmaf(to_f(op[c]), to_f(dp[c]), acc);
  delta[(long long)bh * S + row] = acc;
}

// ---------------------------------------------------------------- float32

constexpr int F_THREADS = 64;  // rows (keys or queries) per block, one per thread
constexpr int F_TILE = 32;     // rows of the streamed operand per shared-memory tile

template <int D>
__global__ void __launch_bounds__(F_THREADS)
attn_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int H, int S, Strides qs,
                  Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs, float scale) {
  __shared__ float Qs[F_TILE][D];
  __shared__ float dOs[F_TILE][D];
  __shared__ float Ls[F_TILE], Ds[F_TILE];

  const int bh = blockIdx.y;
  const long long b = bh / H, h = bh % H;
  const int key = blockIdx.x * F_THREADS + threadIdx.x;
  const bool valid = key < S;
  const float* kp = k + b * ks.b + h * ks.h + (long long)(valid ? key : 0) * ks.s;
  const float* vp = v + b * vs.b + h * vs.h + (long long)(valid ? key : 0) * vs.s;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* db = dout + b * dos.b + h * dos.h;

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
      Ls[threadIdx.x] = in ? lse[(long long)bh * S + q0 + threadIdx.x] : 0.f;
      Ds[threadIdx.x] = in ? delta[(long long)bh * S + q0 + threadIdx.x] : 0.f;
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
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int H, int S, Strides qs, Strides ks, Strides vs,
                Strides dos, Strides dqs, float scale) {
  __shared__ float Ks[F_TILE][D];
  __shared__ float Vs[F_TILE][D];

  const int bh = blockIdx.y;
  const long long b = bh / H, h = bh % H;
  const int row = blockIdx.x * F_THREADS + threadIdx.x;
  const bool valid = row < S;
  const int r = valid ? row : 0;
  const float* qp = q + b * qs.b + h * qs.h + (long long)r * qs.s;
  const float* dop = dout + b * dos.b + h * dos.h + (long long)r * dos.s;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float L = lse[(long long)bh * S + r], Dd = delta[(long long)bh * S + r];

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

constexpr int MMA_ROWS = 64;  // keys (dK/dV) or queries (dQ) per block: 4 warps x 16
constexpr int MMA_TILE = 64;  // rows of the streamed operand per shared-memory tile
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

// The warp's 16 rows (lo = g, hi = g + 8) of a (S, D) operand as A fragments
// of m16n8k16 (k = the head dim); rows at or past S are 0.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const __nv_bfloat16* base,
                                       long long stride, int r_lo, int S, int t) {
  const int r_hi = r_lo + 8;
  auto word = [&](int r, int c) -> uint32_t {
    return r < S ? *reinterpret_cast<const uint32_t*>(base + (long long)r * stride + c) : 0u;
  };
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    a[kk][0] = word(r_lo, kk * 16 + 2 * t);
    a[kk][1] = word(r_hi, kk * 16 + 2 * t);
    a[kk][2] = word(r_lo, kk * 16 + 8 + 2 * t);
    a[kk][3] = word(r_hi, kk * 16 + 8 + 2 * t);
  }
}

// Copy rows [r0, r0 + MMA_TILE) of two (S, D) operands into padded shared
// memory tiles (row length LD), 16 bytes per thread per step; rows at or
// past S are 0.
template <int D, int LD>
__device__ __forceinline__ void load_tiles(__nv_bfloat16* xs, __nv_bfloat16* ys,
                                           const __nv_bfloat16* xb, long long xstride,
                                           const __nv_bfloat16* yb, long long ystride, int r0,
                                           int S) {
  constexpr int VECS = MMA_TILE * D / 8;
  for (int i = threadIdx.x; i < VECS; i += MMA_THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int row = r0 + r;
    uint4 xv = make_uint4(0u, 0u, 0u, 0u), yv = xv;
    if (row < S) {
      xv = *reinterpret_cast<const uint4*>(xb + (long long)row * xstride + c);
      yv = *reinterpret_cast<const uint4*>(yb + (long long)row * ystride + c);
    }
    *reinterpret_cast<uint4*>(&xs[r * LD + c]) = xv;
    *reinterpret_cast<uint4*>(&ys[r * LD + c]) = yv;
  }
}

// acc[j] (16 x 8, j-th 8-row tile of the shared operand) = A * X^T over the
// head dim: the B fragment of tile j is row j*8+g of the shared tile.
template <int D, int LD>
__device__ __forceinline__ void products(float (&acc)[MMA_TILE / 8][4],
                                         const uint32_t (&a)[D / 16][4],
                                         const __nv_bfloat16* xs, int g, int t) {
#pragma unroll
  for (int j = 0; j < MMA_TILE / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const __nv_bfloat16* xr = &xs[(j * 8 + g) * LD];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr + kk * 16 + 2 * t);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + kk * 16 + 8 + 2 * t);
      mma_bf16(acc[j], a[kk], b0, b1);
    }
  }
}

// acc (16 x D) += A (16 x MMA_TILE, as 16-row A fragments over the tile's
// rows) * X (MMA_TILE x D) from the shared tile.
template <int D, int LD>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4],
                                           const uint32_t (&a)[MMA_TILE / 16][4],
                                           const __nv_bfloat16* xs, int g, int t) {
  const unsigned short* raw = reinterpret_cast<const unsigned short*>(xs);
#pragma unroll
  for (int kk = 0; kk < MMA_TILE / 16; ++kk) {
    const int r = kk * 16 + 2 * t;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const int col = nt * 8 + g;
      const uint32_t b0 = pack_raw(raw[r * LD + col], raw[(r + 1) * LD + col]);
      const uint32_t b1 = pack_raw(raw[(r + 8) * LD + col], raw[(r + 9) * LD + col]);
      mma_bf16(acc[nt], a[kk], b0, b1);
    }
  }
}

template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long stride,
                                           const float (&acc)[D / 8][4], int r_lo, int S,
                                           int t) {
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (r_lo < S)
      *reinterpret_cast<__nv_bfloat162*>(base + (long long)r_lo * stride + c) =
          __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
    if (r_lo + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(base + (long long)(r_lo + 8) * stride + c) =
          __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
  }
}

// Pass 2: dK and dV of one 64-key tile; loops over every query tile.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
attn_bwd_dkdv_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H, int S,
                  Strides qs, Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
                  float scale) {
  constexpr int LD = D + 8;  // padded row: conflict-free fragment loads
  constexpr int NT = MMA_TILE / 8;
  __shared__ __align__(16) __nv_bfloat16 Qs[MMA_TILE * LD];
  __shared__ __align__(16) __nv_bfloat16 dOs[MMA_TILE * LD];
  __shared__ float Ls[MMA_TILE], Ds[MMA_TILE];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const long long b = bh / H, h = bh % H;
  const int key_lo = blockIdx.x * MMA_ROWS + warp * 16 + g;
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* db = dout + b * dos.b + h * dos.h;

  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a<D>(ka, k + b * ks.b + h * ks.h, ks.s, key_lo, S, t);
  load_a<D>(va, v + b * vs.b + h * vs.h, vs.s, key_lo, S, t);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nt][e] = dva[nt][e] = 0.f;

  for (int q0 = 0; q0 < S; q0 += MMA_TILE) {
    __syncthreads();  // the previous tile is no longer read
    load_tiles<D, LD>(Qs, dOs, qb, qs.s, db, dos.s, q0, S);
    if (threadIdx.x < MMA_TILE) {
      const int qi = q0 + threadIdx.x;
      Ls[threadIdx.x] = qi < S ? lse[(long long)bh * S + qi] : 0.f;
      Ds[threadIdx.x] = qi < S ? delta[(long long)bh * S + qi] : 0.f;
    }
    __syncthreads();

    float st[NT][4], dpt[NT][4];  // S^T and dP^T: rows = keys, cols = queries
    products<D, LD>(st, ka, Qs, g, t);
    products<D, LD>(dpt, va, dOs, g, t);

    uint32_t pa[MMA_TILE / 16][4], dsa[MMA_TILE / 16][4];  // P^T, dS^T in bf16
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t + e;
        const bool in = q0 + col < S;  // queries past S: P = 0
        const float L = Ls[col], Dq = Ds[col];
        p[e] = in ? expf(st[j][e] * scale - L) : 0.f;
        p[2 + e] = in ? expf(st[j][2 + e] * scale - L) : 0.f;
        ds[e] = p[e] * (dpt[j][e] - Dq) * scale;
        ds[2 + e] = p[2 + e] * (dpt[j][2 + e] - Dq) * scale;
      }
      pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(p[0], p[1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
      dsa[j / 2][(j % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsa[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    accumulate<D, LD>(dva, pa, dOs, g, t);  // dV += P^T dO
    accumulate<D, LD>(dka, dsa, Qs, g, t);  // dK += dS^T Q
  }
  store_rows<D>(dk + b * dks.b + h * dks.h, dks.s, dka, key_lo, S, t);
  store_rows<D>(dv + b * dvs.b + h * dvs.h, dvs.s, dva, key_lo, S, t);
}

// Pass 3: dQ of one 64-query tile; loops over every key tile.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
attn_bwd_dq_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, int H, int S, Strides qs, Strides ks,
                Strides vs, Strides dos, Strides dqs, float scale) {
  constexpr int LD = D + 8;
  constexpr int NT = MMA_TILE / 8;
  __shared__ __align__(16) __nv_bfloat16 Ks[MMA_TILE * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[MMA_TILE * LD];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const long long b = bh / H, h = bh % H;
  const int r_lo = blockIdx.x * MMA_ROWS + warp * 16 + g, r_hi = r_lo + 8;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;

  uint32_t qa[D / 16][4], doa[D / 16][4];
  load_a<D>(qa, q + b * qs.b + h * qs.h, qs.s, r_lo, S, t);
  load_a<D>(doa, dout + b * dos.b + h * dos.h, dos.s, r_lo, S, t);
  // rows past S: Q and dO are 0, so dS = 0 there; their dQ is not written
  const float L_lo = r_lo < S ? lse[(long long)bh * S + r_lo] : 0.f;
  const float L_hi = r_hi < S ? lse[(long long)bh * S + r_hi] : 0.f;
  const float D_lo = r_lo < S ? delta[(long long)bh * S + r_lo] : 0.f;
  const float D_hi = r_hi < S ? delta[(long long)bh * S + r_hi] : 0.f;

  float dqa[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) dqa[nt][0] = dqa[nt][1] = dqa[nt][2] = dqa[nt][3] = 0.f;

  for (int k0 = 0; k0 < S; k0 += MMA_TILE) {
    __syncthreads();
    load_tiles<D, LD>(Ks, Vs, kb, ks.s, vb, vs.s, k0, S);
    __syncthreads();

    float sc[NT][4], dp[NT][4];  // S and dP: rows = queries, cols = keys
    products<D, LD>(sc, qa, Ks, g, t);
    products<D, LD>(dp, doa, Vs, g, t);

    uint32_t dsa[MMA_TILE / 16][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = k0 + j * 8 + 2 * t + e < S;  // keys past S: P = 0
        const float p_lo = in ? expf(sc[j][e] * scale - L_lo) : 0.f;
        const float p_hi = in ? expf(sc[j][2 + e] * scale - L_hi) : 0.f;
        ds[e] = p_lo * (dp[j][e] - D_lo) * scale;
        ds[2 + e] = p_hi * (dp[j][2 + e] - D_hi) * scale;
      }
      dsa[j / 2][(j % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsa[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    accumulate<D, LD>(dqa, dsa, Ks, g, t);  // dQ += dS K
  }
  store_rows<D>(dq + b * dqs.b + h * dqs.h, dqs.s, dqa, r_lo, S, t);
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dq, void* dk, void* dv,
                       int B, int H, int S, const Strides* st, float scale, cudaStream_t s) {
  using bf = __nv_bfloat16;
  const dim3 grid((S + MMA_ROWS - 1) / MMA_ROWS, B * H);
  attn_bwd_dkdv_mma<D><<<grid, MMA_THREADS, 0, s>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), lse, delta, static_cast<bf*>(dk), static_cast<bf*>(dv), H,
      S, st[0], st[1], st[2], st[4], st[6], st[7], scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dq_mma<D><<<grid, MMA_THREADS, 0, s>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), lse, delta, static_cast<bf*>(dq), H, S, st[0], st[1], st[2],
      st[4], st[5], scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dq, void* dk, void* dv,
                       int B, int H, int S, const Strides* st, float scale, cudaStream_t s) {
  const dim3 grid((S + F_THREADS - 1) / F_THREADS, B * H);
  attn_bwd_dkdv_f32<D><<<grid, F_THREADS, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), H, S, st[0], st[1], st[2], st[4], st[6], st[7], scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dq_f32<D><<<grid, F_THREADS, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), H, S, st[0], st[1],
      st[2], st[4], st[5], scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: 24 element strides, (batch,
// head, seq) of q, k, v, o, dout, dq, dk, dv in that order; the head dim of
// every tensor must be contiguous; for bfloat16 the pointers must be 16-byte
// aligned and the strides multiples of 8 (checked by the Python wrapper).
// lse: K1's float32 (B, H, S) row log-sum-exp; delta: float32 (B, H, S)
// scratch, written here. Launches the three passes on `stream` and returns
// the first launch error (cudaGetLastError()), or 0.
int attention_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const void* lse, void* delta, void* dq, void* dk, void* dv, int dtype, int B,
                  int H, int S, int D, const long long* strides, float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B * H > 65535) return cudaErrorInvalidValue;
  if (!((dtype == 0 || dtype == 1) && (D == 32 || D == 64))) return cudaErrorInvalidValue;
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);

  const dim3 dgrid((S + DELTA_THREADS - 1) / DELTA_THREADS, B * H);
  if (dtype == 0)
    attn_bwd_delta_kernel<float><<<dgrid, DELTA_THREADS, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), d, H, S, D, st[3], st[4]);
  else
    attn_bwd_delta_kernel<__nv_bfloat16><<<dgrid, DELTA_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), d, H, S,
        D, st[3], st[4]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (dtype == 0 && D == 64)
    return launch_f32<64>(q, k, v, dout, l, d, dq, dk, dv, B, H, S, st, scale, s);
  if (dtype == 0) return launch_f32<32>(q, k, v, dout, l, d, dq, dk, dv, B, H, S, st, scale, s);
  if (D == 64) return launch_mma<64>(q, k, v, dout, l, d, dq, dk, dv, B, H, S, st, scale, s);
  return launch_mma<32>(q, k, v, dout, l, d, dq, dk, dv, B, H, S, st, scale, s);
}

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
