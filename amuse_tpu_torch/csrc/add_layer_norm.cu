// Residual add + LayerNorm of the AST's ViT blocks on the inference path,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves LayerNorm and the residual
// add to XLA, which fuses them. In the port the two were six PyTorch passes
// (a bf16 add, the cast to float32, F.layer_norm, the per-encoder scale and
// shift as two broadcasts, the cast back), ~42 bytes moved per element.
// Same function, per row of E values of x (and delta):
//   s = round_T(x + delta)                (the bf16 add, bit for bit)
//   h = round_T((s - mean) * rsqrt(var + eps) * w[g] + b[g])
// with the mean and the biased variance in float32, the affine in float32
// over the per-encoder (G, E) weight and bias widened from T (row r belongs
// to encoder g = r / (rows / G)), and one rounding to T. Without delta the
// kernel reads x and writes h alone (s is x).
//
// Bound on the H100: bytes. Reading x and delta and writing s and h is 8
// bytes an element in bf16; at the b32 shape (116,544 rows x 768) 716 MB,
// 0.214 ms at 3.35 TB/s. The weight and bias rows (G x E) stay in L1/L2.
//
// Design. One warp per row, the row in registers: lane l holds the 16-byte
// vectors l, l + 32, ... of the row (E = 768 bf16: three vectors, 24
// values), so each load and store is one coalesced 512-byte line a warp.
// s is stored as soon as it is formed, the statistics come from the
// registers by two warp reductions (the mean, then the centred squares),
// and h is stored with 16-byte stores. Eight rows (warps) a block, no shared
// memory, no allocation; the template takes the vectors a lane holds
// (E / (32 * 16 / sizeof(T)), rounded up) so that the row stays in
// registers at every width up to 1024.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows a block
constexpr int kMaxWidth = 1024;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // element 2k is the low half (little-endian)
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // round to nearest even, as PyTorch's casts
      __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
      w[k] = *reinterpret_cast<uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// most 16-byte vectors a lane holds: E <= 1024
template <typename T>
constexpr int kMaxVectors = kMaxWidth / (32 * Vec<T>::N);

template <typename T>
struct Params {
  const T* x;
  const T* delta;  // nullptr: no residual add
  const T* weight;
  const T* bias;
  T* sum;  // s, written only with delta
  T* out;  // h
  long long rows;
  long long rows_per_group;
  int width;
  float eps;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int NV, bool HAS_DELTA>
__global__ void __launch_bounds__(kWarps * 32) add_layer_norm_kernel(const Params<T> p) {
  constexpr int N = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= p.rows) return;  // whole warps leave: the reductions below see full warps
  const int vectors = p.width / N;
  const long long base = row * p.width;
  const uint4* x = reinterpret_cast<const uint4*>(p.x + base);

  float v[NV][N];
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < vectors) {
      Vec<T>::unpack(x[c], v[i]);
      if constexpr (HAS_DELTA) {
        float d[N];
        Vec<T>::unpack(reinterpret_cast<const uint4*>(p.delta + base)[c], d);
#pragma unroll
        for (int k = 0; k < N; ++k) v[i][k] = __fadd_rn(v[i][k], d[k]);
        const uint4 s = Vec<T>::pack(v[i]);
        reinterpret_cast<uint4*>(p.sum + base)[c] = s;
        Vec<T>::unpack(s, v[i]);  // the statistics see s as stored
      }
#pragma unroll
      for (int k = 0; k < N; ++k) total += v[i][k];
    }
  }
  const float mean = warp_sum(total) / p.width;
  float squares = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i < vectors) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float c = v[i][k] - mean;
        squares = fmaf(c, c, squares);
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(squares) / p.width + p.eps);

  const long long g = row / p.rows_per_group;
  const uint4* w = reinterpret_cast<const uint4*>(p.weight + g * p.width);
  const uint4* b = reinterpret_cast<const uint4*>(p.bias + g * p.width);
  uint4* out = reinterpret_cast<uint4*>(p.out + base);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < vectors) {
      float wf[N], bf[N], h[N];
      Vec<T>::unpack(w[c], wf);
      Vec<T>::unpack(b[c], bf);
#pragma unroll
      for (int k = 0; k < N; ++k)  // y * w, then + b: two roundings, as the plain path
        h[k] = __fadd_rn(__fmul_rn((v[i][k] - mean) * rstd, wf[k]), bf[k]);
      out[c] = Vec<T>::pack(h);
    }
  }
}

// the instantiation that holds ``vectors`` 16-byte vectors a lane (1..kMaxVectors)
template <typename T, bool HAS_DELTA, int NV = 1>
void launch(const Params<T>& p, int vectors, unsigned blocks, cudaStream_t st) {
  if constexpr (NV < kMaxVectors<T>) {
    if (vectors > NV) return launch<T, HAS_DELTA, NV + 1>(p, vectors, blocks, st);
  }
  add_layer_norm_kernel<T, NV, HAS_DELTA><<<blocks, kWarps * 32, 0, st>>>(p);
}

template <typename T>
int run(const void* x, const void* delta, const void* weight, const void* bias, void* sum,
        void* out, long long rows, long long groups, int width, float eps, cudaStream_t st) {
  const Params<T> p{static_cast<const T*>(x), static_cast<const T*>(delta),
                    static_cast<const T*>(weight), static_cast<const T*>(bias),
                    static_cast<T*>(sum), static_cast<T*>(out), rows, rows / groups, width, eps};
  const int vectors = (width / Vec<T>::N + 31) / 32;
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  if (delta)
    launch<T, true>(p, vectors, blocks, st);
  else
    launch<T, false>(p, vectors, blocks, st);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for x, delta, weight, bias, sum and out
// alike. x, delta, sum and out are (rows, width) contiguous; weight and bias
// (groups, width) contiguous, groups dividing rows; every pointer 16-byte
// aligned; width a multiple of 8 up to 1024 (checked by the Python wrapper).
// delta nullptr: sum is not written. Launches on ``stream`` and returns the
// first CUDA error of the launch (cudaGetLastError()), or 0.
int add_layer_norm(const void* x, const void* delta, const void* weight, const void* bias,
                   void* sum, void* out, int dtype, long long rows, long long groups, int width,
                   float eps, void* stream) {
  if (rows <= 0 || groups <= 0 || rows % groups != 0) return cudaErrorInvalidValue;
  if (width <= 0 || width % 8 != 0 || width > kMaxWidth) return cudaErrorInvalidValue;
  if ((rows + kWarps - 1) / kWarps > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (delta && !sum) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(x, delta, weight, bias, sum, out, rows, groups, width, eps, st);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, delta, weight, bias, sum, out, rows, groups, width, eps, st);
  return cudaErrorInvalidValue;
}

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
