// K3: the whole eta=0 DDIM sampling loop of the latent denoiser in one
// launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel amuse_tpu/ops/denoiser_kernel.py::_sampler_kernel
// (built by make_fused_sampler). Same function, per window:
//   for each of the num_steps timesteps:
//     tokens = [latent + pos0, time_token[step], cond tokens (positions folded in)]
//     L post-norm encoder layers (attention over the real tokens, exact-erf
//     GELU FFN, LayerNorm eps 1e-5) as a U-Net skip stack with (L-1)/2
//     Linear(cat(x, skip)) merges, then the final LayerNorm;
//     eps = token 0; pred_x0 = (x - c1 eps) * c0, clipped to +-clip;
//     x = c2 pred_x0 + c3 eps.
// The time tokens, condition tokens and per-step (c0..c3) are computed
// outside in torch (amuse_tpu_torch/ops/denoiser_kernel.py), as the JAX
// package does outside its pallas_call. GELU uses erff, not the
// Abramowitz-Stegun polynomial the TPU kernel needed for want of erf.
//
// Bound on the H100: the work is a serial chain of num_steps x L tiny
// layers (50 x 9 over 5 tokens x 128 at the flagship dims): about 1 GFLOP
// per window in float32 and 7.6 MB of weights read once, so by the card's
// rates a few microseconds; in practice the chain's latency and each
// block's share of L2 bandwidth bound it.
//
// Design. The TPU kernel keeps all weights resident in VMEM (~7.6 MB in
// float32), far beyond the 227 KB of shared memory a Hopper block may use.
// Here one thread block runs one window: activations, q/k/v, the FF hidden
// and the skip tensors of the real tokens live in shared memory (~47 KB at
// the flagship dims, plus 40 KB of split-K scratch); weights are read from
// global memory in (in, out) layout as float4s, coalesced across threads,
// with a whole matrix in flight per matmul, and stay L2-resident after the
// first step; all steps loop inside the launch. The real-token count (2..5), d,
// ff, heads and layers are arguments, so a missing emotion/style stream
// runs the same kernel.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 512;
constexpr int MAX_T = 5;  // latent, time, content, emotion, style
constexpr float LN_EPS = 1e-5f;

struct Weights {
  const float *wq, *wk, *wv, *wo;  // (L, D, D), (in, out)
  const float *bq, *bk, *bv, *bo;  // (L, D)
  const float *w1, *b1;            // (L, D, FF), (L, FF)
  const float *w2, *b2;            // (L, FF, D), (L, D)
  const float *ln_scale, *ln_bias; // (L, 2, D)
  const float *wskip, *bskip;      // (L/2, 2D, D), (L/2, D)
  const float *final_scale, *final_bias;  // (D,)
};

struct Dims {
  int T, D, FF, H, L, steps;
  float clip;
};

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

// y[t, n] = act(sum_k x[t, k] W[k, n] + bias[n]) for t < T, n < N.
// x (T x K) and y (T x N) in shared memory, W (K x N) row-major in global
// memory (L2-resident after the first step). Each thread owns 4 adjacent
// columns (one float4 of W per k) and one slice of K: the N/4 column groups
// times `splits` K-slices cover the block, so a whole matrix's loads are in
// flight at once (the loop is bound by L2 latency otherwise). The slices'
// partial sums meet in scratch (THREADS * 4 * MAX_T floats). N % 4 == 0 and
// N / 4 <= THREADS (checked on the host).
__device__ void linear(const float* x, int T, int K, const float* __restrict__ W,
                       const float* __restrict__ bias, int N, float* y, float* scratch,
                       bool gelu) {
  const int tid = threadIdx.x;
  const int groups = N / 4;
  const int splits = THREADS / groups;
  const int grp = tid % groups, part = tid / groups;
  if (part < splits) {
    const int k0 = part * K / splits, k1 = (part + 1) * K / splits;
    const float4* w4 = reinterpret_cast<const float4*>(W) + grp;
    float4 acc[MAX_T];
#pragma unroll
    for (int t = 0; t < MAX_T; ++t) acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int kk = k0; kk < k1; ++kk) {
      const float4 w = __ldg(w4 + (size_t)kk * groups);
#pragma unroll
      for (int t = 0; t < MAX_T; ++t) {
        if (t < T) {
          const float xv = x[t * K + kk];
          acc[t].x = fmaf(xv, w.x, acc[t].x);
          acc[t].y = fmaf(xv, w.y, acc[t].y);
          acc[t].z = fmaf(xv, w.z, acc[t].z);
          acc[t].w = fmaf(xv, w.w, acc[t].w);
        }
      }
    }
    float4* s4 = reinterpret_cast<float4*>(scratch);
#pragma unroll
    for (int t = 0; t < MAX_T; ++t)
      if (t < T) s4[(part * MAX_T + t) * groups + grp] = acc[t];
  }
  __syncthreads();
  for (int i = tid; i < T * N; i += THREADS) {
    const int t = i / N, col = i % N;
    float val = 0.f;
    for (int p = 0; p < splits; ++p) val += scratch[(p * MAX_T + t) * N + col];
    val += bias[col];
    y[i] = gelu ? gelu_exact(val) : val;
  }
  __syncthreads();
}

// Multi-head self-attention over the T real tokens, one thread per output
// element (token, column); q, k, v, out are (T x D) in shared memory.
__device__ void attention(const float* q, const float* k, const float* v, float* out, int T,
                          int D, int H) {
  const int hd = D / H;
  const float inv_sqrt = 1.f / sqrtf((float)hd);
  for (int i = threadIdx.x; i < T * D; i += THREADS) {
    const int t = i / D, col = i % D, h0 = (col / hd) * hd;
    const float* qt = q + t * D + h0;
    float sc[MAX_T];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < MAX_T; ++j) {
      if (j < T) {
        const float* kj = k + j * D + h0;
        float dot = 0.f;
        for (int c = 0; c < hd; ++c) dot = fmaf(qt[c], kj[c], dot);
        sc[j] = dot * inv_sqrt;
        mx = fmaxf(mx, sc[j]);
      }
    }
    float sum = 0.f, acc = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_T; ++j) {
      if (j < T) {
        const float p = expf(sc[j] - mx);
        sum += p;
        acc = fmaf(p, v[j * D + col], acc);
      }
    }
    out[i] = acc / sum;
  }
  __syncthreads();
}

// x[t] = LayerNorm(x[t] + r[t]) * scale + bias for t < T, one warp per row;
// r may be null.
__device__ void add_layernorm(float* x, const float* r, int T, int D,
                              const float* __restrict__ scale,
                              const float* __restrict__ bias) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp < T) {
    float* xr = x + warp * D;
    const float* rr = r ? r + warp * D : nullptr;
    float sum = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float y = rr ? xr[c] + rr[c] : xr[c];
      xr[c] = y;
      sum += y;
    }
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float mean = sum / D;
    float var = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float dlt = xr[c] - mean;
      var = fmaf(dlt, dlt, var);
    }
    for (int off = 16; off > 0; off >>= 1) var += __shfl_xor_sync(0xffffffffu, var, off);
    const float inv = rsqrtf(var / D + LN_EPS);
    for (int c = lane; c < D; c += 32) xr[c] = (xr[c] - mean) * inv * scale[c] + bias[c];
  }
  __syncthreads();
}

struct Smem {
  float *x, *q, *k, *v, *ao, *tmp, *hid, *skips, *scratch, *latent;
};

__device__ void encoder_layer(int l, const Smem& s, const Weights& w, const Dims& d) {
  const int T = d.T, D = d.D, FF = d.FF;
  const size_t dd = (size_t)D * D, df = (size_t)D * FF;
  linear(s.x, T, D, w.wq + l * dd, w.bq + l * D, D, s.q, s.scratch, false);
  linear(s.x, T, D, w.wk + l * dd, w.bk + l * D, D, s.k, s.scratch, false);
  linear(s.x, T, D, w.wv + l * dd, w.bv + l * D, D, s.v, s.scratch, false);
  attention(s.q, s.k, s.v, s.ao, T, D, d.H);
  linear(s.ao, T, D, w.wo + l * dd, w.bo + l * D, D, s.tmp, s.scratch, false);
  add_layernorm(s.x, s.tmp, T, D, w.ln_scale + (2 * l) * D, w.ln_bias + (2 * l) * D);
  linear(s.x, T, D, w.w1 + l * df, w.b1 + (size_t)l * FF, FF, s.hid, s.scratch, true);
  linear(s.hid, T, FF, w.w2 + l * df, w.b2 + l * D, D, s.tmp, s.scratch, false);
  add_layernorm(s.x, s.tmp, T, D, w.ln_scale + (2 * l + 1) * D, w.ln_bias + (2 * l + 1) * D);
}

__global__ void __launch_bounds__(THREADS)
ddim_sampler_kernel(const float* __restrict__ time_tokens,  // (steps, D), pos[1] folded in
                    const float* __restrict__ cond,         // (B, T - 2, D), positions folded in
                    const float* __restrict__ coeffs,       // (steps, 4)
                    const float* __restrict__ pos0,         // (D,)
                    const float* __restrict__ x0,           // (B, D) initial latents
                    Weights w, Dims d, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int T = d.T, D = d.D, n_skip = (d.L - 1) / 2;
  const int td = MAX_T * D;
  const int hid_cols = d.FF > 2 * D ? d.FF : 2 * D;
  Smem s;
  s.x = smem;
  s.q = s.x + td;
  s.k = s.q + td;
  s.v = s.k + td;
  s.ao = s.v + td;
  s.tmp = s.ao + td;
  s.hid = s.tmp + td;
  s.skips = s.hid + MAX_T * hid_cols;
  s.scratch = s.skips + n_skip * td;
  s.latent = s.scratch + THREADS * 4 * MAX_T;

  const int b = blockIdx.x, tid = threadIdx.x;
  const int n_cond = T - 2;
  for (int i = tid; i < D; i += THREADS) s.latent[i] = x0[(size_t)b * D + i];
  __syncthreads();

  for (int step = 0; step < d.steps; ++step) {
    for (int i = tid; i < T * D; i += THREADS) {
      const int t = i / D, c = i % D;
      float val;
      if (t == 0) val = s.latent[c] + pos0[c];
      else if (t == 1) val = time_tokens[(size_t)step * D + c];
      else val = cond[((size_t)b * n_cond + (t - 2)) * D + c];
      s.x[i] = val;
    }
    __syncthreads();

    for (int li = 0; li < n_skip; ++li) {
      encoder_layer(li, s, w, d);
      for (int i = tid; i < T * D; i += THREADS) s.skips[li * td + i] = s.x[i];
      __syncthreads();
    }
    encoder_layer(n_skip, s, w, d);
    for (int si = 0; si < n_skip; ++si) {
      const float* skip = s.skips + (n_skip - 1 - si) * td;
      for (int i = tid; i < T * 2 * D; i += THREADS) {
        const int t = i / (2 * D), c = i % (2 * D);
        s.hid[i] = c < D ? s.x[t * D + c] : skip[t * D + c - D];
      }
      __syncthreads();
      linear(s.hid, T, 2 * D, w.wskip + (size_t)si * 2 * D * D, w.bskip + si * D, D, s.x,
             s.scratch, false);
      encoder_layer(n_skip + 1 + si, s, w, d);
    }
    // final LayerNorm of token 0 (the epsilon prediction) only: rows are independent
    add_layernorm(s.x, nullptr, 1, D, w.final_scale, w.final_bias);

    const float c0 = coeffs[step * 4 + 0], c1 = coeffs[step * 4 + 1];
    const float c2 = coeffs[step * 4 + 2], c3 = coeffs[step * 4 + 3];
    for (int i = tid; i < D; i += THREADS) {
      const float eps = s.x[i];
      float px = (s.latent[i] - c1 * eps) * c0;
      if (d.clip > 0.f) px = fminf(fmaxf(px, -d.clip), d.clip);
      s.latent[i] = c2 * px + c3 * eps;
    }
    __syncthreads();
  }
  for (int i = tid; i < D; i += THREADS) out[(size_t)b * D + i] = s.latent[i];
}

size_t smem_bytes(int D, int FF, int L) {
  const size_t td = (size_t)MAX_T * D;
  const size_t hid_cols = FF > 2 * D ? FF : 2 * D;
  return sizeof(float) * (6 * td + MAX_T * hid_cols + ((L - 1) / 2) * td +
                          (size_t)THREADS * 4 * MAX_T + D);
}

}  // namespace

extern "C" {

// All pointers are device float32, contiguous, in the layouts noted on the
// kernel and Weights. clip <= 0 disables the pred-x0 clamp. Returns
// cudaErrorInvalidValue for shapes the kernel does not take, else
// cudaGetLastError() after the launch.
int ddim_sampler(const float* time_tokens, const float* cond, const float* coeffs,
                 const float* pos0, const float* x0, const float* wq, const float* wk,
                 const float* wv, const float* wo, const float* bq, const float* bk,
                 const float* bv, const float* bo, const float* w1, const float* b1,
                 const float* w2, const float* b2, const float* ln_scale,
                 const float* ln_bias, const float* wskip, const float* bskip,
                 const float* final_scale, const float* final_bias, float* out, int batch,
                 int real_tokens, int steps, int d, int ff, int heads, int layers, float clip,
                 void* stream) {
  if (batch <= 0 || batch > 65535 || real_tokens < 2 || real_tokens > MAX_T || steps <= 0 ||
      d <= 0 || ff <= 0 || heads <= 0 || d % heads != 0 || layers < 1 || layers % 2 == 0 ||
      d % 4 != 0 || ff % 4 != 0 || d > 4 * THREADS || ff > 4 * THREADS)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d, ff, layers);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ddim_sampler_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const Weights w{wq, wk, wv, wo, bq, bk, bv, bo, w1, b1, w2, b2,
                  ln_scale, ln_bias, wskip, bskip, final_scale, final_bias};
  const Dims dims{real_tokens, d, ff, heads, layers, steps, clip};
  ddim_sampler_kernel<<<batch, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      time_tokens, cond, coeffs, pos0, x0, w, dims, out);
  return cudaGetLastError();
}

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
