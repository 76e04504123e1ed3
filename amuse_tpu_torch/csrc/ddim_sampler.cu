// K3: the whole eta=0 DDIM sampling loop of the latent denoiser in one
// launch, for Hopper (sm_90a): one thread-block cluster per window.
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
// Shapes: 2..5 real tokens, any odd L, heads dividing d, d and ff multiples
// of 4 up to 2048 whose activations fit in shared memory: every shape the
// one-block kernel this one replaced took (at C = 1 where no larger cluster
// divides the widths).
//
// Bound on the H100: the work is a serial chain of num_steps x L tiny
// layers (50 x 9 over 5 tokens x 128 at the flagship dims): ~1 GFLOP per
// window in float32 and 7.6 MB of weights, so by the card's rates ~14 us.
// The chain is serial, so latency bounds it, in two parts:
//   * exchanges: each layer's Q|K|V, O and FF2 results, and each skip
//     merge's, must reach every CTA before the next part of the layer:
//     3 L + (L-1)/2 = 31 per step at the flagship dims; no cluster barrier
//     runs inside the step loop (one before it, one after);
//   * bytes per CTA: each CTA reads its 1/C of the weights every step,
//     0.98 MB at C = 8, from L2 (the 7.6 MB stay resident there).
//
// Design. The TPU kernel keeps all weights resident in VMEM (~7.6 MB of
// float32); one Hopper SM holds 227 KB. Here a cluster of C CTAs runs one
// window, 256 threads each. The wrapper picks C from the dims and the
// window count: 8 (the portable size) at the flagship dims while the card
// runs all windows' clusters at once (15 on an H100), else the largest C
// that fits them in one wave (a window's chain is latency-bound).
//   * Each CTA owns 1/C of every matrix's output columns (Q|K|V, O, FF1,
//     the skip merges) or, for FF2, 1/C of its K rows: the FF1 units it
//     computed itself, so FF1 -> FF2 needs no exchange. Its result goes to
//     every CTA's shared memory with st.async, each store completing its
//     bytes on that CTA's receive mbarrier; FF2's partial sums land in a
//     (C, T, D) buffer in every CTA and are added there in rank order, so
//     all CTAs hold bit-equal activations and two launches give bit-equal
//     results (no atomics).
//   * An exchange is a wait on the local receive mbarrier: no cluster
//     barrier runs inside the step loop. Reuse of a receive buffer is safe
//     without one, because a CTA sends into a buffer only after it has
//     received data that every other CTA sent after reading that buffer.
//   * Everything row-wise (attention over <= 5 tokens, the residual
//     LayerNorms, the token build, the final LayerNorm and the DDIM update)
//     runs redundantly in every CTA and needs no exchange.
//   * The weights stream. The host lays every CTA's weights for one step
//     out as one contiguous run in the order it reads them (segments:
//     [merge], Q|K|V, O, LN1, FF1, FF2, LN2 per layer, then the final
//     LayerNorm; each matrix slice is followed by its bias row), cut into
//     chunks of at most 48 KB and a third of the ring. The run is the same
//     in every step, so one thread keeps it flowing into a ring of the
//     shared memory the activations leave (~155 KB at the flagship dims)
//     with cp.async.bulk copies, each completing on its own mbarrier,
//     issued as soon as the ring has room: the next 1.5 layers' weights are
//     in flight while this layer computes. A segment of several chunks
//     frees each chunk once every thread is done with it, so a segment may
//     be larger than the ring. Nothing stays resident across steps: a
//     CTA's share (~1 MB at C = 8) is six times the ring, and the stream
//     runs ahead of the chain it feeds.
//   * Shared memory holds the activations once: attention writes its
//     output over q, its scores go to the FF2 partials (free while it
//     runs), and at C = 1 those partials are the O buffer. Where little
//     room is left, the split-K scratch shrinks and products split K less.
//   * Inside a CTA a product is split over (column group of 4, K part)
//     threads; the K parts meet in shared memory in a fixed order. A
//     segment wider than 4 columns per thread (only where d or ff exceed
//     1024 / C) gives each thread up to 4 column groups, in an instance of
//     the product of its own. The kernel is a template on the real-token
//     count, so the token loops unroll.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int PRODUCER = THREADS - 1;  // the thread that issues the weight stream
constexpr int MAX_T = 5;               // latent, time, content, emotion, style
constexpr int MAX_PARTS = 16;          // K parts of one product inside a CTA
constexpr int MAX_PASS = 4;            // column groups of 4 per thread, at most
constexpr int MAX_D = 2048;            // d and ff
constexpr int TT_REGS = MAX_D / 4 / THREADS;  // float4s of the time token per thread
constexpr int NBAR = 64;               // weight-chunk mbarriers: chunks in flight at most
constexpr int MAX_CLUSTER = 8;         // the portable cluster size
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr int CHUNK_CAP_BYTES = 48 * 1024;
constexpr float LN_EPS = 1e-5f;

// Segments of a CTA's weight run, in the order of one step.
enum : int { QKV = 0, OPROJ, LN1, FF1, FF2, LN2, MERGE, FINAL };
// Receive mbarriers, one per exchange (after the weight chunks' NBAR).
enum : int { RECV_QKV = 0, RECV_O, RECV_FF2, RECV_MERGE, N_RECV };
constexpr int N_KINDS = FINAL + 1;
// NBAR + N_RECV mbarriers, then each segment kind's rows, cols, chunk rows
// and K parts (ints), padded to 128 bytes
constexpr int SHAPE_INTS = 4;
constexpr int BAR_BYTES = 768;
static_assert(8 * (NBAR + N_RECV) + 4 * SHAPE_INTS * N_KINDS <= BAR_BYTES, "mbarriers, shapes");

struct Plan {
  int D, FF, H, L, steps, C;
  float clip;
  int n_skip;
  int td;            // floats of one (MAX_T, D) activation buffer, padded
  int heads_per_pass;  // attention heads whose scores fit in td floats
  int step_floats;   // one CTA's weight run for one step
  int chunks_per_step;
  int ring_floats, scr_floats, smem_bytes;
  // float offsets of the shared-memory buffers (after the mbarriers)
  int x, o, q, k, v, part, h, skip, lat, scr, ring;
  int shape[SHAPE_INTS * N_KINDS];  // per kind: rows, cols, rows per chunk, K parts
};

bool is_vectors(int kind) { return kind == LN1 || kind == LN2 || kind == FINAL; }

// Rows x cols of a segment (a matrix slice's last row is its bias) and the
// rows of its chunks: all of a vector segment, else a multiple of 4 rows of
// at most cap floats (4 rows at least), or the whole segment.
void seg_shape(int D, int FF, int C, int cap, int kind, int& rows, int& cols, int& per) {
  const int dc = D / C, fc = FF / C;
  switch (kind) {
    case QKV: rows = D + 1; cols = 3 * dc; break;
    case OPROJ: rows = D + 1; cols = dc; break;
    case LN1: rows = 2; cols = D; break;  // scale, bias
    case FF1: rows = D + 1; cols = fc; break;
    case FF2: rows = fc; cols = D; break;  // this CTA's K rows, all columns
    case LN2: rows = 3; cols = D; break;   // FF2 bias, scale, bias
    case MERGE: rows = 2 * D + 1; cols = dc; break;
    default: rows = 2; cols = D; break;    // FINAL: scale, bias
  }
  const int fit = cap / cols / 4 * 4;
  per = is_vectors(kind) ? rows : (fit >= rows ? rows : (fit > 4 ? fit : 4));
}

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of `bar` with this parity to complete. A wait that
// outlasts 2^26 polls (seconds) traps, so a fault ends the launch with an
// error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done, polls = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (++polls == (1u << 26)) __trap();
  } while (!done);
}

// One bulk copy of `bytes` (a multiple of 16) from global to this CTA's
// shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, int bytes,
                                          uint64_t* bar) {
  mbar_expect(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release;\n barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Store v at `local`'s offset in the shared memory of every CTA of the
// cluster (this one included) with st.async, each store completing 16
// bytes on that CTA's copy of `bar`. Starts with the next rank so that the
// CTAs spread their stores.
__device__ __forceinline__ void send_all(float* local, float4 v, uint64_t* bar, int rank,
                                         int C) {
  const uint32_t a = smem_addr(local), b = smem_addr(bar);
  for (int i = 0; i < C; ++i) {
    int r = rank + 1 + i;
    if (r >= C) r -= C;
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
        "[%5];" ::"r"(map_rank(a, r)),
        "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(map_rank(b, r))
        : "memory");
  }
}

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// A place in the weight stream: the segment's kind and layer, the chunk's
// first row in the segment, its rows, floats and offset in the run, chunk of
// the launch, its offset in the ring, and the linear position (ring offsets
// with the wraps counted) that tells the producer how much of the ring is in
// use.
struct Cursor {
  int kind, layer, row, nr, n, src, j, ring_off;
  long long lin;
};

// The weight stream of one CTA: the consumer cursor (every thread, in step)
// and the producer cursor (thread PRODUCER); and what the launch counts.
struct Stream {
  float* ring;
  uint64_t* bars;
  const int* shape;  // Plan::shape, in shared memory
  const float* src;  // this CTA's weight run for one step
  int L, n_skip, ring_floats, total;
  Cursor cons, prod;
  int n_block, n_exchange;  // block barriers and exchanges passed

  __device__ __forceinline__ int rows(int kind) const { return shape[SHAPE_INTS * kind]; }
  __device__ __forceinline__ int cols(int kind) const { return shape[SHAPE_INTS * kind + 1]; }
  __device__ __forceinline__ int per(int kind) const { return shape[SHAPE_INTS * kind + 2]; }
  __device__ __forceinline__ int parts(int kind) const { return shape[SHAPE_INTS * kind + 3]; }

  // The next chunk: segments run [merge], Q|K|V, O, LN1, FF1, FF2, LN2 per
  // layer, then the final LayerNorm, then the next step's.
  __device__ __forceinline__ void next(Cursor& c) const {
    c.lin += c.n;
    c.ring_off += c.n;
    c.src += c.n;
    c.j += 1;
    c.row += per(c.kind);
    if (c.row >= rows(c.kind)) {
      c.row = 0;
      if (c.kind == FINAL) {
        c.kind = QKV;
        c.layer = 0;
        c.src = 0;
      } else if (c.kind == LN2) {
        ++c.layer;
        c.kind = c.layer == L ? FINAL : (c.layer > n_skip ? MERGE : QKV);
      } else {
        c.kind = c.kind == MERGE ? QKV : c.kind + 1;
      }
    }
    c.nr = min(per(c.kind), rows(c.kind) - c.row);
    c.n = c.nr * cols(c.kind);
    if (c.ring_off + c.n > ring_floats) {  // the chunk starts the ring again
      c.lin += ring_floats - c.ring_off;
      c.ring_off = 0;
    }
  }

  // Thread PRODUCER: issue every chunk that fits in the ring behind the
  // oldest one still in use (cons). Called where every thread is known to be
  // done with all chunks before cons.
  __device__ void produce() {
    while (prod.j < total && prod.j - cons.j < NBAR &&
           prod.lin + prod.n <= cons.lin + ring_floats) {
      bulk_load(ring + prod.ring_off, src + prod.src, prod.n * 4, bars + prod.j % NBAR);
      next(prod);
    }
  }

  __device__ __forceinline__ const float* wait(const Cursor& c) const {
    mbar_wait(bars + c.j % NBAR, (uint32_t)((c.j / NBAR) & 1));
    return ring + c.ring_off;
  }

  __device__ __forceinline__ void sync() {
    __syncthreads();
    ++n_block;
  }
};

__device__ __forceinline__ void sync_produce(Stream& s) {
  s.sync();
  if (threadIdx.x == PRODUCER) s.produce();
}

// The exchange of one phase: wait until this CTA's copy of `bar` has
// received `bytes` from the cluster's st.async stores (thread 0 arms it),
// then let the producer run: every local thread stored its outputs, so it
// was done with the weights of the segment before.
__device__ __forceinline__ void receive(Stream& s, uint64_t* bar, uint32_t& parity, int bytes) {
  if (threadIdx.x == 0) mbar_expect(bar, bytes);
  mbar_wait(bar, parity);
  parity ^= 1u;
  ++s.n_exchange;
  if (threadIdx.x == PRODUCER) s.produce();
}

// y[t, n] = sum_{k < K} *in(t, k) W[k, n] + bias[n] over the segment at the
// stream's cursor, of kind KIND (K weight rows, then the bias row if it has
// K + 1); out(t, n, float4 of columns n..n+3) receives the result. in(t, k)
// points at input element (t, k); rows k..k+3 are read as one float4.
// Thread (g, part) owns columns 4g..4g+3 and the blocks of 4 rows k/4 =
// part (mod parts); the parts' sums meet in `scratch` and are added in part
// order. Where the segment is wider than 4 columns per thread (NP > 1),
// thread g owns columns 4(g + i THREADS).. for i < NP and all rows. Each
// chunk but the last is freed for the producer once all threads are done
// with it.
template <int T, int KIND, int NP, class In, class Out>
__device__ __forceinline__ void matmul_np(Stream& s, int K, float* scratch, In in, Out out) {
  const int rows = s.rows(KIND), cols = s.cols(KIND), parts = s.parts(KIND);
  const int G = cols / 4, tid = threadIdx.x;
  const int g = NP > 1 ? tid : tid % G, part = NP > 1 ? 0 : tid / G;
  const bool active = part < parts;
  float4 acc[NP][T];
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int t = 0; t < T; ++t) acc[i][t] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* bias = nullptr;
  Cursor c = s.cons;
  for (;;) {
    const int r0 = c.row, n = c.nr;
    const float* w = s.wait(c);
    if (r0 <= K && K < r0 + n) bias = w + (K - r0) * cols;
    if (active) {
      const int rend = min(r0 + n, K);
      // blocks of 4 rows (chunks start on one): block i to part i (mod parts)
      int r = r0 + 4 * ((part - (r0 / 4) % parts + parts) % parts);
      const float* wp = w + (r - r0) * cols + 4 * g;
      if (NP == 1) {
#pragma unroll 2
        for (; r < rend; r += 4 * parts, wp += 4 * parts * cols) {
          float4 wv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) wv[j] = *reinterpret_cast<const float4*>(wp + j * cols);
#pragma unroll
          for (int t = 0; t < T; ++t) {
            const float4 xv = *reinterpret_cast<const float4*>(in(t, r));
            const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[0][t].x = fmaf(xs[j], wv[j].x, acc[0][t].x);
              acc[0][t].y = fmaf(xs[j], wv[j].y, acc[0][t].y);
              acc[0][t].z = fmaf(xs[j], wv[j].z, acc[0][t].z);
              acc[0][t].w = fmaf(xs[j], wv[j].w, acc[0][t].w);
            }
          }
        }
      } else {
        for (; r < rend; r += 4, wp += 4 * cols) {
          float4 xv[T];
#pragma unroll
          for (int t = 0; t < T; ++t) xv[t] = *reinterpret_cast<const float4*>(in(t, r));
#pragma unroll
          for (int i = 0; i < NP; ++i) {
            if (g + i * THREADS < G) {
              float4 wv[4];
#pragma unroll
              for (int j = 0; j < 4; ++j)
                wv[j] = *reinterpret_cast<const float4*>(wp + j * cols + 4 * i * THREADS);
#pragma unroll
              for (int t = 0; t < T; ++t) {
                const float xs[4] = {xv[t].x, xv[t].y, xv[t].z, xv[t].w};
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  acc[i][t].x = fmaf(xs[j], wv[j].x, acc[i][t].x);
                  acc[i][t].y = fmaf(xs[j], wv[j].y, acc[i][t].y);
                  acc[i][t].z = fmaf(xs[j], wv[j].z, acc[i][t].z);
                  acc[i][t].w = fmaf(xs[j], wv[j].w, acc[i][t].w);
                }
              }
            }
          }
        }
      }
    }
    const bool last = r0 + n >= rows;
    s.next(c);
    if (last) break;
    s.sync();  // every thread is done with the chunk: the producer may refill its room
    s.cons = c;
    if (tid == PRODUCER) s.produce();
  }
  if (parts == 1) {
    if (active) {
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int gg = g + i * THREADS;
        if (gg < G) {
#pragma unroll
          for (int t = 0; t < T; ++t)
            out(t, 4 * gg,
                bias ? add4(acc[i][t], *reinterpret_cast<const float4*>(bias + 4 * gg))
                     : acc[i][t]);
        }
      }
    }
  } else {
    if (active) {
#pragma unroll
      for (int t = 0; t < T; ++t)
        *reinterpret_cast<float4*>(scratch + (part * T + t) * cols + 4 * g) = acc[0][t];
    }
    s.sync();
    for (int i = tid; i < T * G; i += THREADS) {
      const int t = i / G, gg = i % G;
      const float* sp = scratch + t * cols + 4 * gg;
      float4 sum = *reinterpret_cast<const float4*>(sp);
#pragma unroll 4
      for (int q = 1; q < parts; ++q)
        sum = add4(sum, *reinterpret_cast<const float4*>(sp + q * T * cols));
      if (bias) sum = add4(sum, *reinterpret_cast<const float4*>(bias + 4 * gg));
      out(t, 4 * gg, sum);
    }
  }
  s.cons = c;
}

// The product over the segment at the stream's cursor (of kind KIND), with
// one column group per thread or, for a segment wider than that, MAX_PASS.
template <int T, int KIND, class In, class Out>
__device__ __forceinline__ void matmul(Stream& s, int K, float* scratch, In in, Out out) {
  if (s.cols(KIND) <= 4 * THREADS)
    matmul_np<T, KIND, 1>(s, K, scratch, in, out);
  else
    matmul_np<T, KIND, MAX_PASS>(s, K, scratch, in, out);
}

// x[t] = LayerNorm(x[t] + r[t]) * scale + bias for the first `rows` rows,
// one warp per row, where r[t] = sum_{i < nres} res[i * T * D + t * D]
// + extra (the partials added in order, then extra); nres 0 normalises x.
template <int T>
__device__ __forceinline__ void add_layernorm(float* x, int rows, const float* res, int nres,
                                              const float* extra, const float* scale,
                                              const float* bias, int D) {
  const int lane = threadIdx.x % 32;
  for (int warp = threadIdx.x / 32; warp < rows; warp += THREADS / 32) {
    float* xr = x + warp * D;
    float sum = 0.f;
#pragma unroll 4
    for (int c = lane; c < D; c += 32) {
      float y = xr[c];
      if (nres > 0) {
        const float* rp = res + warp * D + c;
        float r = rp[0];
#pragma unroll
        for (int i = 1; i < MAX_CLUSTER; ++i)  // unrolled: the loads issue together
          if (i < nres) r += rp[i * T * D];
        if (extra) r += extra[c];
        y += r;
      }
      xr[c] = y;
      sum += y;
    }
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float mean = sum / D;
    float var = 0.f;
#pragma unroll 4
    for (int c = lane; c < D; c += 32) {
      const float dlt = xr[c] - mean;
      var = fmaf(dlt, dlt, var);
    }
    for (int off = 16; off > 0; off >>= 1) var += __shfl_xor_sync(0xffffffffu, var, off);
    const float inv = rsqrtf(var / D + LN_EPS);
#pragma unroll 4
    for (int c = lane; c < D; c += 32) xr[c] = (xr[c] - mean) * inv * scale[c] + bias[c];
  }
}

// Multi-head self-attention over the T real tokens, in every CTA: scores,
// then the softmax rows, then P V, for hc heads at a time (as many as `sc`
// holds scores of); q, k, v are (T x D), and the output is written over q
// (each head's columns once its scores are done).
template <int T>
__device__ __forceinline__ void attention(Stream& s, float* q, const float* k, const float* v,
                                          float* sc, int hc, int D, int H) {
  const int hd = D / H, tid = threadIdx.x;
  const float inv_sqrt = 1.f / sqrtf((float)hd);
  for (int h0 = 0; h0 < H; h0 += hc) {
    const int nh = min(hc, H - h0);
    for (int i = tid; i < nh * T * T; i += THREADS) {
      const int h = h0 + i / (T * T), tq = (i / T) % T, tk = i % T;
      const float* qr = q + tq * D + h * hd;
      const float* kr = k + tk * D + h * hd;
      float dot = 0.f;
      if ((hd & 3) == 0) {
#pragma unroll 4
        for (int c = 0; c < hd; c += 4) {
          const float4 a = *reinterpret_cast<const float4*>(qr + c);
          const float4 b = *reinterpret_cast<const float4*>(kr + c);
          dot = fmaf(a.x, b.x, dot);
          dot = fmaf(a.y, b.y, dot);
          dot = fmaf(a.z, b.z, dot);
          dot = fmaf(a.w, b.w, dot);
        }
      } else {
        for (int c = 0; c < hd; ++c) dot = fmaf(qr[c], kr[c], dot);
      }
      sc[i] = dot * inv_sqrt;
    }
    s.sync();
    for (int i = tid; i < nh * T; i += THREADS) {
      float* row = sc + i * T;
      float e[T], mx = -INFINITY, sum = 0.f;
#pragma unroll
      for (int j = 0; j < T; ++j) mx = fmaxf(mx, row[j]);
#pragma unroll
      for (int j = 0; j < T; ++j) {
        e[j] = expf(row[j] - mx);
        sum += e[j];
      }
      const float inv = 1.f / sum;
#pragma unroll
      for (int j = 0; j < T; ++j) row[j] = e[j] * inv;
    }
    s.sync();
    // one thread per column of these heads, all tokens
    for (int col = h0 * hd + tid; col < (h0 + nh) * hd; col += THREADS) {
      const int h = col / hd - h0;
      float vc[T];
#pragma unroll
      for (int j = 0; j < T; ++j) vc[j] = v[j * D + col];
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float* pr = sc + (h * T + t) * T;
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < T; ++j) acc = fmaf(pr[j], vc[j], acc);
        q[t * D + col] = acc;
      }
    }
    s.sync();
  }
}

template <int T>
__global__ void __launch_bounds__(THREADS, 1)
ddim_sampler_kernel(const float* __restrict__ time_tokens,  // (steps, D), pos[1] folded in
                    const float* __restrict__ cond,         // (B, T - 2, D), positions folded in
                    const float* __restrict__ coeffs,       // (steps, 4)
                    const float* __restrict__ pos0,         // (D,)
                    const float* __restrict__ x0,           // (B, D) initial latents
                    const float* __restrict__ weights,      // (C, step_floats)
                    const Plan p, float* __restrict__ out,
                    int* __restrict__ stats) {  // null, or (cluster barriers, exchanges, block barriers)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* recv = bars + NBAR;
  float* sm = reinterpret_cast<float*>(smem_raw + BAR_BYTES);
  float *x = sm + p.x, *o = sm + p.o;
  float *q = sm + p.q, *k = sm + p.k, *v = sm + p.v, *h = sm + p.h;
  float *part = sm + p.part, *skips = sm + p.skip, *lat = sm + p.lat, *scratch = sm + p.scr;
  const int D = p.D, C = p.C, TD = T * D, dc = D / C, fc = p.FF / C, D4 = D / 4;
  const int rank = (int)cluster_rank(), b = blockIdx.x / C, tid = threadIdx.x;
  const float* cnd = cond + (size_t)b * (T - 2) * D;

  int* shape = reinterpret_cast<int*>(recv + N_RECV);
  if (tid == 0) {
    for (int i = 0; i < NBAR + N_RECV; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (tid < SHAPE_INTS * N_KINDS) shape[tid] = p.shape[tid];
  for (int i = tid; i < D; i += THREADS) lat[i] = x0[(size_t)b * D + i];
  __syncthreads();
  // every CTA of the cluster runs, its mbarriers armed, before any st.async
  cluster_sync_all();
  int n_cluster = 1;
  const int nr0 = min(shape[SHAPE_INTS * QKV + 2], shape[SHAPE_INTS * QKV]);
  const Cursor first{QKV, 0, 0, nr0, nr0 * shape[SHAPE_INTS * QKV + 1], 0, 0, 0, 0};
  Stream s{sm + p.ring, bars, shape, weights + (size_t)rank * p.step_floats, p.L, p.n_skip,
           p.ring_floats, p.steps * p.chunks_per_step, first, first, 1, 0};
  if (tid == PRODUCER) s.produce();
  uint32_t par_qkv = 0, par_o = 0, par_ff2 = 0, par_merge = 0;

  auto x_in = [&](int t, int kk) { return x + t * D + kk; };
  auto to_all = [&](float* base, uint64_t* bar) {
    return [=](int t, int n, float4 val) {
      send_all(base + t * D + rank * dc + n, val, bar, rank, C);
    };
  };
  float4 tt[TT_REGS];  // this step's time token: float4 columns tid, tid + THREADS
#pragma unroll
  for (int u = 0; u < TT_REGS; ++u)
    if (tid + u * THREADS < D4) tt[u] = __ldg(reinterpret_cast<const float4*>(time_tokens) + tid + u * THREADS);

  for (int step = 0; step < p.steps; ++step) {
    const float4 cf = __ldg(reinterpret_cast<const float4*>(coeffs) + step);
    for (int i = tid; i < TD; i += THREADS) {
      const int t = i / D, c = i % D;
      if (t == 0) x[i] = lat[c] + __ldg(pos0 + c);
      else if (t >= 2) x[i] = __ldg(cnd + (t - 2) * D + c);
    }
#pragma unroll
    for (int u = 0; u < TT_REGS; ++u) {
      const int i4 = tid + u * THREADS;
      if (i4 < D4) {
        reinterpret_cast<float4*>(x + D)[i4] = tt[u];
        if (step + 1 < p.steps)  // the next step's, in flight while this one runs
          tt[u] = __ldg(reinterpret_cast<const float4*>(time_tokens + (size_t)(step + 1) * D) + i4);
      }
    }
    s.sync();

    for (int l = 0; l < p.L; ++l) {
      if (l > p.n_skip) {  // x = Linear(cat(x, skip)), the skips taken last-in first-out
        const float* skip = skips + (2 * p.n_skip - l) * p.td;
        matmul<T, MERGE>(s, 2 * D, scratch,
                  [&](int t, int kk) { return kk < D ? x + t * D + kk : skip + t * D + kk - D; },
                  to_all(o, recv + RECV_MERGE));
        receive(s, recv + RECV_MERGE, par_merge, TD * 4);
        float* tmp = x;
        x = o;
        o = tmp;
      }
      // FF2's partials: their own buffer, or O's in a cluster of one
      float* ff2 = C == 1 ? o : part;
      // q | k | v: this CTA's columns of each, to every CTA
      matmul<T, QKV>(s, D, scratch, x_in, [&](int t, int n, float4 val) {
        const int which = n / dc;
        float* dst = which == 0 ? q : (which == 1 ? k : v);
        send_all(dst + t * D + rank * dc + n - which * dc, val, recv + RECV_QKV, rank, C);
      });
      receive(s, recv + RECV_QKV, par_qkv, 3 * TD * 4);
      // the scores go to the partials' buffer: no CTA sends its FF2 partials
      // of this layer before it has this CTA's O columns
      attention<T>(s, q, k, v, ff2, p.heads_per_pass, D, p.H);
      matmul<T, OPROJ>(s, D, scratch, [&](int t, int kk) { return q + t * D + kk; },
                to_all(o, recv + RECV_O));
      receive(s, recv + RECV_O, par_o, TD * 4);
      {
        const float* w = s.wait(s.cons);  // LN1: scale, bias
        add_layernorm<T>(x, T, o, 1, nullptr, w, w + D, D);
        s.next(s.cons);
      }
      sync_produce(s);
      matmul<T, FF1>(s, D, scratch, x_in, [&](int t, int n, float4 val) {
        val.x = gelu_exact(val.x);
        val.y = gelu_exact(val.y);
        val.z = gelu_exact(val.z);
        val.w = gelu_exact(val.w);
        *reinterpret_cast<float4*>(h + t * fc + n) = val;
      });
      sync_produce(s);
      // FF2 over this CTA's fc hidden units: a partial sum of every column,
      // to row `rank` of every CTA's (C, T, D) partials
      matmul<T, FF2>(s, fc, scratch, [&](int t, int kk) { return h + t * fc + kk; },
                [&](int t, int n, float4 val) {
                  send_all(ff2 + rank * TD + t * D + n, val, recv + RECV_FF2, rank, C);
                });
      receive(s, recv + RECV_FF2, par_ff2, C * TD * 4);
      {
        const float* w = s.wait(s.cons);  // LN2: FF2 bias, scale, bias
        add_layernorm<T>(x, T, ff2, C, w, w + D, w + 2 * D, D);
        s.next(s.cons);
      }
      sync_produce(s);
      if (l < p.n_skip)
        for (int i = tid; i < TD; i += THREADS) skips[l * p.td + i] = x[i];
    }
    {
      const float* w = s.wait(s.cons);  // final LayerNorm of token 0 (the epsilon prediction)
      add_layernorm<T>(x, 1, nullptr, 0, nullptr, w, w + D, D);
      s.next(s.cons);
    }
    sync_produce(s);
    for (int i = tid; i < D; i += THREADS) {
      const float eps = x[i];
      float px = (lat[i] - cf.y * eps) * cf.x;
      if (p.clip > 0.f) px = fminf(fmaxf(px, -p.clip), p.clip);
      lat[i] = cf.z * px + cf.w * eps;
    }
    s.sync();
  }
  if (rank == 0)
    for (int i = tid; i < D; i += THREADS) out[(size_t)b * D + i] = lat[i];
  cluster_sync_all();  // no CTA leaves while stores of the cluster are in flight
  ++n_cluster;
  if (stats && blockIdx.x == 0 && tid == 0) {
    stats[0] = n_cluster;
    stats[1] = s.n_exchange;
    stats[2] = s.n_block;
  }
}

int round32(int n) { return (n + 31) / 32 * 32; }

// The launch plan of the given dims and cluster size: shared-memory layout,
// ring, chunks of one step. Returns nullptr, or why the kernel does not take
// the shape.
const char* make_plan(int d, int ff, int heads, int layers, int cluster, Plan& p) {
  p = Plan{};
  if (cluster < 1 || cluster > MAX_CLUSTER) return "cluster size must be 1..8";
  if (d <= 0 || ff <= 0 || heads <= 0 || d % heads != 0 || layers < 1 || layers % 2 == 0)
    return "needs d, ff, heads > 0, heads dividing d, odd layers";
  if (d % (4 * cluster) != 0 || ff % (4 * cluster) != 0)
    return "d and ff must be multiples of 4 x the cluster size";
  if (d > MAX_D || ff > MAX_D) return "d and ff must be at most 2048";
  p.D = d; p.FF = ff; p.H = heads; p.L = layers; p.C = cluster;
  p.n_skip = (layers - 1) / 2;
  p.td = round32(MAX_T * d);
  p.heads_per_pass = p.td / (MAX_T * MAX_T);  // the scores' buffer holds td floats
  int off = 0;
  auto take = [&](int floats) { const int at = off; off += round32(floats); return at; };
  p.x = take(p.td); p.o = take(p.td); p.q = take(p.td); p.k = take(p.td); p.v = take(p.td);
  p.part = cluster > 1 ? take(cluster * p.td) : p.o;
  p.h = take(MAX_T * (ff / cluster)); p.skip = take(p.n_skip * p.td); p.lat = take(d);
  // the ring must hold the first chunk of every segment; the scratch takes
  // what its K parts need of the rest, at most
  int min_ring = 0, scr_need = 0;
  for (int kind = QKV; kind <= FINAL; ++kind) {
    int rows, cols, per;
    seg_shape(d, ff, cluster, 0, kind, rows, cols, per);
    if (cols > 4 * THREADS * MAX_PASS) return "a segment is wider than 4096 columns";
    min_ring = std::max(min_ring, per * cols);
    const int G = cols / 4, parts = std::min(MAX_PARTS, THREADS / G);
    if (!is_vectors(kind) && parts > 1) scr_need = std::max(scr_need, parts * MAX_T * cols);
  }
  const int room = (SMEM_LIMIT - BAR_BYTES) / 4 - off;
  if (room < min_ring) return "the activations and one weight chunk do not fit in shared memory";
  p.scr_floats = std::min(scr_need, (room - min_ring) / 32 * 32);
  p.scr = take(p.scr_floats);
  p.ring = off;
  p.ring_floats = ((SMEM_LIMIT - BAR_BYTES) / 4 - off) / 4 * 4;
  p.smem_bytes = BAR_BYTES + (off + p.ring_floats) * 4;
  const int cap_floats = std::min(CHUNK_CAP_BYTES / 4, p.ring_floats / 3) / 4 * 4;
  long long step_floats = 0, chunks = 0;
  for (int kind = QKV; kind <= FINAL; ++kind) {
    int rows, cols, per;
    seg_shape(d, ff, cluster, cap_floats, kind, rows, cols, per);
    // K parts: as many as the threads and the scratch hold; one where a
    // thread owns several column groups
    const int G = cols / 4;
    p.shape[SHAPE_INTS * kind] = rows;
    p.shape[SHAPE_INTS * kind + 1] = cols;
    p.shape[SHAPE_INTS * kind + 2] = per;
    p.shape[SHAPE_INTS * kind + 3] = G > THREADS ? 1 : std::max(1, std::min(
        std::min(MAX_PARTS, THREADS / G), p.scr_floats / (MAX_T * cols)));
    // one of each per layer, a merge per output layer, one final LayerNorm
    const int count = kind == MERGE ? p.n_skip : (kind == FINAL ? 1 : layers);
    chunks += (long long)count * ((rows + per - 1) / per);
    step_floats += (long long)count * rows * cols;
  }
  if (step_floats > 0x7fffffffLL) return "a CTA's weights for one step exceed 2^31 floats";
  p.step_floats = (int)step_floats;
  p.chunks_per_step = (int)chunks;
  return nullptr;
}

template <int T>
cudaError_t launch(const Plan& p, int batch, cudaStream_t stream, const float* time_tokens,
                   const float* cond, const float* coeffs, const float* pos0, const float* x0,
                   const float* weights, float* out, int* stats, int* max_clusters) {
  auto kernel = ddim_sampler_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * p.C, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = p.smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters) return cudaOccupancyMaxActiveClusters(max_clusters, (void*)kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, time_tokens, cond, coeffs, pos0, x0, weights, p, out,
                           stats);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t dispatch(int real_tokens, const Plan& p, int batch, cudaStream_t stream,
                     const float* time_tokens, const float* cond, const float* coeffs,
                     const float* pos0, const float* x0, const float* weights, float* out,
                     int* stats, int* max_clusters) {
  switch (real_tokens) {
    case 2: return launch<2>(p, batch, stream, time_tokens, cond, coeffs, pos0, x0, weights, out, stats, max_clusters);
    case 3: return launch<3>(p, batch, stream, time_tokens, cond, coeffs, pos0, x0, weights, out, stats, max_clusters);
    case 4: return launch<4>(p, batch, stream, time_tokens, cond, coeffs, pos0, x0, weights, out, stats, max_clusters);
    case 5: return launch<5>(p, batch, stream, time_tokens, cond, coeffs, pos0, x0, weights, out, stats, max_clusters);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The plan of the dims at a cluster size: nullptr if the kernel takes them,
// else the reason. info = (shared-memory bytes, ring bytes, chunks per step,
// floats of one CTA's weight run per step, split-K scratch bytes).
const char* ddim_sampler_plan(int d, int ff, int heads, int layers, int cluster,
                              long long* info) {
  Plan p;
  const char* why = make_plan(d, ff, heads, layers, cluster, p);
  if (why) return why;
  info[0] = p.smem_bytes;
  info[1] = 4LL * p.ring_floats;
  info[2] = p.chunks_per_step;
  info[3] = p.step_floats;
  info[4] = 4LL * p.scr_floats;
  return nullptr;
}

// cudaOccupancyMaxActiveClusters of the kernel at these dims into *count.
int ddim_sampler_max_clusters(int d, int ff, int heads, int layers, int cluster, int* count) {
  Plan p;
  if (make_plan(d, ff, heads, layers, cluster, p)) return cudaErrorInvalidValue;
  return dispatch(MAX_T, p, 1, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, count);
}

// All pointers are device float32, contiguous: weights is the (cluster,
// step_floats) run laid out by amuse_tpu_torch.ops.denoiser_kernel.pack_for_cluster.
// clip <= 0 disables the pred-x0 clamp. stats, if not null, is 3 device
// ints that receive what the first CTA passed: cluster barriers, exchanges
// and block barriers. Returns cudaErrorInvalidValue for shapes the kernel
// does not take, else cudaGetLastError() after the launch.
int ddim_sampler(const float* time_tokens, const float* cond, const float* coeffs,
                 const float* pos0, const float* x0, const float* weights, float* out,
                 long long weight_floats, int batch, int real_tokens, int steps, int d, int ff,
                 int heads, int layers, int cluster, float clip, int* stats, void* stream) {
  Plan p;
  if (make_plan(d, ff, heads, layers, cluster, p) || batch <= 0 || batch > 65535 ||
      real_tokens < 2 || real_tokens > MAX_T || steps <= 0 ||
      (long long)steps * p.chunks_per_step > 0x7fffffffLL ||
      weight_floats != (long long)cluster * p.step_floats)
    return cudaErrorInvalidValue;
  p.steps = steps;
  p.clip = clip;
  return dispatch(real_tokens, p, batch, static_cast<cudaStream_t>(stream), time_tokens, cond,
                  coeffs, pos0, x0, weights, out, stats, nullptr);
}

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
