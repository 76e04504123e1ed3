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
// products (the softmax's second pass recomputes q k^T: 6 S^2 D executed).
// At the harness shape (4, 12, 1214, 64) bf16: 18.1 GFLOP, 0.0183 ms at
// 989 TFLOP/s; the bytes (q, k, v read, out written: 29.8 MB) take 0.0089
// ms at 3.35 TB/s.
//
// Design. One block of four warps per (batch*head, 64-row q tile), 16 rows
// a warp; K (and V) stream through shared memory in 64-key tiles.
//   bf16: every product is mma.sync m16n8k16 (bf16 in, float32
//   accumulation). Q's fragments stay in registers for the block's life;
//   S = Q K^T reads K's fragments from shared memory (rows padded to 72
//   values, so the eight rows a fragment load touches fall in distinct
//   banks). The accumulator layout of S is that of the A fragment of the
//   next product, so P = bf16(e) goes to O += P V without leaving the
//   registers; V's B fragments are gathered two bf16 at a time.
//   float32: 256 threads, each a 4 x 4 block of S and of O, float32 FMAs on
//   operands stored k-major in shared memory (no tensor cores: TF32 would
//   round the inputs); P goes through shared memory as the A operand of
//   O += P V.
// A simple right kernel first: no cp.async ring, one block barrier pair per
// tile, its times in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;      // head dim (the JAX file's D)
constexpr int TILE = 64;   // query rows per block, keys per shared-memory tile
constexpr int SOFTMAX = 0, DOTS = 1;

// ------------------------------------------------------------------ bf16
// These helpers (and the float32 tile loads, products and row reductions
// below) repeat in attention_variants_bwd.cu on purpose: a shared
// csrc/*.cuh enters the build hash of every kernel (ops/_build.py::_target),
// so it would rebuild K1-K3.

constexpr int M_THREADS = 128;  // four warps, 16 query rows each
constexpr int LDH = D + 8;      // bf16 row stride of a shared tile (144 bytes)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* lo, const __nv_bfloat16* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

// d (16 x 8, f32) += a (16 x 16 bf16) b (16 x 8 bf16)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [row0, row0 + 64) of a (S, 64) bf16 matrix into a shared tile with row
// stride LDH; rows at or past S are zeros
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
    const int c = 16 * kk + 2 * t;
    const __nv_bfloat16* lo = src + (long long)r_lo * D + c;
    const __nv_bfloat16* hi = lo + 8 * D;
    a[kk][0] = r_lo < S ? *reinterpret_cast<const uint32_t*>(lo) : 0u;
    a[kk][1] = r_lo + 8 < S ? *reinterpret_cast<const uint32_t*>(hi) : 0u;
    a[kk][2] = r_lo < S ? *reinterpret_cast<const uint32_t*>(lo + 8) : 0u;
    a[kk][3] = r_lo + 8 < S ? *reinterpret_cast<const uint32_t*>(hi + 8) : 0u;
  }
}

// s (16 x 64: eight n-tiles of 8 keys) = A (16 x 64, fragments) B^T, B the
// 64-row shared tile with the head dim contiguous (the Q K^T form)
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

// o (16 x 64) += P (16 x 64 keys, A fragments) V (the 64-key shared tile)
__device__ __forceinline__ void accumulate_pv(float (&o)[8][4], const uint32_t (&p)[4][4],
                                              const __nv_bfloat16* tile, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const __nv_bfloat16* b = tile + (16 * kk + 2 * t) * LDH + 8 * j + g;
      mma16816(o[j], p[kk], pair(b, b + LDH), pair(b + 8 * LDH, b + 9 * LDH));
    }
}

template <int BODY>
__global__ void __launch_bounds__(M_THREADS)
fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S,
         float scale) {
  __shared__ __align__(16) __nv_bfloat16 Ks[TILE * LDH];
  __shared__ __align__(16) __nv_bfloat16 Vs[TILE * LDH];
  const long long base = (long long)blockIdx.y * S * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r_lo = blockIdx.x * TILE + 16 * warp + g;  // and r_lo + 8
  const int n_tiles = (S + TILE - 1) / TILE;

  uint32_t qa[4][4];
  load_a_frags(qa, q + base, r_lo, S, t);
  float s[8][4];
  float m_lo = -INFINITY, m_hi = -INFINITY;
  if constexpr (BODY == SOFTMAX) {  // pass 1: the row maxima
    for (int kt = 0; kt < n_tiles; ++kt) {
      __syncthreads();
      load_tile_bf16(Ks, k + base, kt * TILE, S);
      __syncthreads();
      product_rows(s, qa, Ks, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (kt * TILE + 8 * j + 2 * t + e < S) {
            m_lo = fmaxf(m_lo, s[j][e] * scale);
            m_hi = fmaxf(m_hi, s[j][2 + e] * scale);
          }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {  // the four threads of a row
      m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, off));
      m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, off));
    }
  }
  float oacc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
  float r_lo_sum = 0.f, r_hi_sum = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {  // pass 2: e, r and e v
    __syncthreads();
    load_tile_bf16(Ks, k + base, kt * TILE, S);
    load_tile_bf16(Vs, v + base, kt * TILE, S);
    __syncthreads();
    product_rows(s, qa, Ks, g, t);
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = kt * TILE + 8 * j + 2 * t + (e & 1) < S;
        const float x = s[j][e] * scale;
        if constexpr (BODY == SOFTMAX)
          p[e] = in ? expf(x - (e < 2 ? m_lo : m_hi)) : 0.f;
        else
          p[e] = in ? x : 0.f;
      }
      if constexpr (BODY == SOFTMAX) {
        r_lo_sum += p[0] + p[1];
        r_hi_sum += p[2] + p[3];
      }
      // the S accumulator of n-tile j is half of the A fragment of k-step j / 2
      pa[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
    accumulate_pv(oacc, pa, Vs, g, t);
  }
  float f_lo = 1.f, f_hi = 1.f;
  if constexpr (BODY == SOFTMAX) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      r_lo_sum += __shfl_xor_sync(0xffffffffu, r_lo_sum, off);
      r_hi_sum += __shfl_xor_sync(0xffffffffu, r_hi_sum, off);
    }
    f_lo = r_lo_sum;
    f_hi = r_hi_sum;
  }
  __nv_bfloat16* ob = o + base;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (r_lo < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r_lo * D + c) =
          __floats2bfloat162_rn(oacc[j][0] / f_lo, oacc[j][1] / f_lo);
    if (r_lo + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)(r_lo + 8) * D + c) =
          __floats2bfloat162_rn(oacc[j][2] / f_hi, oacc[j][3] / f_hi);
  }
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
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int dtype, int BH,
                   int S, float scale, cudaStream_t st) {
  const dim3 grid((S + TILE - 1) / TILE, BH);
  if (dtype == 1) {
    fwd_bf16<BODY><<<grid, M_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, scale);
  } else {
    constexpr int SMEM = 4 * F_TILE_FLOATS * sizeof(float);
    static cudaError_t attr = cudaFuncSetAttribute(
        fwd_f32<BODY>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (attr != cudaSuccess) return attr;
    fwd_f32<BODY><<<grid, F_THREADS, SMEM, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), S, scale);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: contiguous (B, H, S, 64) tensors, 16-byte aligned; dtype 0 =
// float32, 1 = bfloat16; body 0 = SOFTMAX, 1 = DOTS. Launches one kernel on
// `stream` and returns its launch error (cudaGetLastError()), or 0.
int variant_fwd(const void* q, const void* k, const void* v, void* o, int dtype, int body, int B,
                int H, int S, float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || (long long)B * H > 65535) return cudaErrorInvalidValue;
  if (!(dtype == 0 || dtype == 1) || !(body == SOFTMAX || body == DOTS))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return body == SOFTMAX ? launch<SOFTMAX>(q, k, v, o, dtype, B * H, S, scale, st)
                         : launch<DOTS>(q, k, v, o, dtype, B * H, S, scale, st);
}

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
