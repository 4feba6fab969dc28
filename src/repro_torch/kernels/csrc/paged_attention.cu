// Paged attention over a block-table-indexed KV page pool, for Hopper
// (sm_90a): the one-page-per-step kernel, the split-KV partition kernel
// and the log-sum-exp combine.
//
// Replaces:
//  * src/repro/kernels/flash_attention.py:217 _paged_attention_unsplit
//    (Pallas body _paged_kernel :154) -> paged_attention_unsplit_kernel;
//  * src/repro/kernels/flash_attention.py:514 paged_attention_pallas
//    (Pallas body _paged_split_kernel :274) -> paged_attention_split_kernel,
//    then combine_splits (:353) -> combine_splits_kernel.
// Contract (as the reference): q (B, Hq, S, D) folded group-major onto its
// KV head as (B, Hkv, rows = group*S, D), f32 or bf16; pages
// (P, Hkv, ps, D) f32; block table (B, NP) int32; qpos (B,) int32.  Row r
// is query position qpos[b] + r % S and sees kv positions <= that
// (write-before-attend).  Masked logits are -1e30 and weigh exactly 0;
// tiles wholly past the last visible position are skipped and leave the
// online-softmax state untouched; a row that sees nothing outputs 0 (the
// max(l, 1e-30) guard).  The output has q's dtype.
//
// What bounds it on the H100: bytes.  Decode reads every visible K and V
// row once (f32, 2 * D * 4 = 2 KB per token and KV head) for ~4 * rows * D
// flops per token -- 8 rows at gemma-2b's MQA decode, ~4 flops per byte,
// far below the f32 roofline's ~20 (67 TFLOP/s over 3.35 TB/s).  A
// chunked-prefill call (rows = 8 * 16) is denser but still moves more
// bytes than it can hide at these context lengths.
//
// What the design does about it:
//  * pages are fetched through the block table by the block itself
//    (float4 loads of one contiguous 16 x D page), each visible page read
//    once per (batch, KV head, row tile); pages past the last visible
//    position and split-padding entries are never read;
//  * the query tile, the running (m, l) and the f32 accumulator stay in
//    shared memory for the whole walk: 16 rows x 256 x 4 B = 16 KB each,
//    so rows beyond 16 (group 8 x S 16 = 128 at prefill) are spread over
//    row-tile blocks instead of one 128 KB accumulator;
//  * the split kernel cuts the table into kv_split partitions run by
//    separate blocks (flash decoding), so a long context is not one
//    serial page chain on one SM; its partials (acc, m, l) go to HBM and
//    a second tiny kernel applies the combine formula.  A multi-page tile
//    (pages_per_step) computes its logits page by page into shared memory
//    and updates the softmax state once per tile, as the reference does.
// Not yet done (a later change): tensor-core (mma) dot products, async
// (cp.async / TMA) double-buffered page fetches, a KV-head-shared tile
// for the MQA case.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr float NEG = -1e30f;

struct Geometry {
  const void* q;         // (B, Hkv, rows, D) f32 or bf16
  const float* k_pages;  // (P, Hkv, ps, D)
  const float* v_pages;
  const int* bt;         // (B, NP)
  const int* qpos;       // (B,)
  int B, Hkv, rows, D, S, ps, P, NP;
  int t;                 // pages per tile
  int nt;                // tiles per partition
  int rt;                // query rows per block
  float scale;
  int q_bf16;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float load_q(const void* q, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i])
              : static_cast<const float*>(q)[i];
}

// One (page, KV head) block of ps x D floats into shared memory with row
// stride D + 1 (conflict-free column walks in the dot products).
__device__ __forceinline__ void load_page(const float* pages, int pg, int h,
                                          const Geometry& g, float* dst) {
  const int D = g.D, ld = D + 1, n = g.ps * D;
  const float* src = pages + ((size_t)pg * g.Hkv + h) * n;
  if (D % 4 == 0) {
    for (int i = threadIdx.x; i < n / 4; i += THREADS) {
      const float4 v = reinterpret_cast<const float4*>(src)[i];
      const int c = (4 * i) / D, d = (4 * i) % D;
      float* o = dst + c * ld + d;
      o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
    }
  } else {
    for (int i = threadIdx.x; i < n; i += THREADS)
      dst[(i / D) * ld + i % D] = src[i];
  }
}

// Shared-memory floats the walk needs (page-id ints ride at the end).
__host__ __device__ inline size_t smem_floats(int rt, int D, int ps, int t) {
  return 3 * (size_t)rt * D + (size_t)ps * (D + 1) + (size_t)rt * t * ps
         + 3 * (size_t)rt + t;
}

// Online-softmax walk of partition `sp` for (b, h, rows r0 .. r0+rt).
// kFinal: write acc / max(l, 1e-30) in q's dtype (the unsplit kernel);
// otherwise write the raw partials (acc, m, l) of this partition.
template <bool kFinal>
__device__ void walk(const Geometry& g, int b, int h, int r0, int sp,
                     void* out, float* acc_o, float* m_o, float* l_o) {
  extern __shared__ float smem[];
  const int D = g.D, ps = g.ps, rt = g.rt, ld = D + 1;
  const int TC = g.t * ps;                 // columns of one tile
  float* q_s = smem;                       // rt x D, q * scale
  float* acc_s = q_s + rt * D;             // rt x D
  float* pv_s = acc_s + rt * D;            // rt x D, this tile's p @ V
  float* kv_s = pv_s + rt * D;             // ps x (D + 1), one K or V page
  float* p_s = kv_s + ps * ld;             // rt x TC, logits then p
  float* m_s = p_s + rt * TC;              // rt
  float* l_s = m_s + rt;                   // rt
  float* al_s = l_s + rt;                  // rt, this tile's alpha
  int* pg_s = reinterpret_cast<int*>(al_s + rt);   // t page ids (-1: none)

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nr = min(rt, g.rows - r0);
  const size_t qbase = ((size_t)(b * g.Hkv + h) * g.rows + r0) * D;
  for (int i = tid; i < rt * D; i += THREADS) {
    // q.astype(f32) * scale, as _paged_kernel:181
    q_s[i] = (i / D < nr) ? load_q(g.q, qbase + i, g.q_bf16) * g.scale : 0.f;
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < rt; r += THREADS) {
    m_s[r] = NEG;
    l_s[r] = 0.f;
  }
  const int qpos0 = g.qpos[b];
  const int last = qpos0 + g.S - 1;        // last position any row sees
  const int* btb = g.bt + (size_t)b * g.NP;
  __syncthreads();

  for (int it = 0; it < g.nt; ++it) {
    const int base = (sp * g.nt + it) * g.t;   // first table entry of the tile
    // tiles wholly past the last visible position are skipped (and so is
    // every later one): the state stays untouched, as in the reference
    if (base * ps > last) break;
    // the tile's page ids; split-padding entries (>= NP), pages wholly
    // past `last` and out-of-range ids are never dereferenced -- all their
    // columns are masked anyway
    for (int j = tid; j < g.t; j += THREADS) {
      const int e = base + j;
      int pg = -1;
      if (e < g.NP && e * ps <= last) {
        pg = btb[e];
        if (pg < 0 || pg >= g.P) pg = -1;
      }
      pg_s[j] = pg;
    }
    __syncthreads();

    // 1. logits of the tile, page by page
    for (int j = 0; j < g.t; ++j) {
      const int pg = pg_s[j];
      if (pg >= 0) {
        load_page(g.k_pages, pg, h, g, kv_s);
        __syncthreads();
      }
      for (int i = tid; i < rt * ps; i += THREADS) {
        const int r = i / ps, c = i % ps;
        const int kvpos = (base + j) * ps + c;
        float logit = NEG;
        if (pg >= 0 && kvpos <= qpos0 + (r0 + r) % g.S) {
          const float* qr = q_s + r * D;
          const float* kr = kv_s + c * ld;
          float s = 0.f;
          for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
          logit = s;
        }
        p_s[r * TC + j * ps + c] = logit;
      }
      __syncthreads();
    }

    // 2. online-softmax update, one warp per row
    for (int r = warp; r < rt; r += NWARPS) {
      const int qp = qpos0 + (r0 + r) % g.S;
      float* pr = p_s + r * TC;
      float mx = NEG;
      for (int c = lane; c < TC; c += 32) mx = fmaxf(mx, pr[c]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < TC; c += 32) {
        const bool vis = pg_s[c / ps] >= 0 && base * ps + c <= qp;
        const float p = vis ? expf(pr[c] - m_new) : 0.f;
        pr[c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        al_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    for (int i = tid; i < rt * D; i += THREADS) pv_s[i] = 0.f;
    __syncthreads();

    // 3. p @ V of the tile, page by page; masked columns (p == 0) are not
    //    multiplied, so garbage in unwritten or recycled rows cannot leak
    for (int j = 0; j < g.t; ++j) {
      const int pg = pg_s[j];
      if (pg < 0) continue;                 // uniform across the block
      load_page(g.v_pages, pg, h, g, kv_s);
      __syncthreads();
      for (int i = tid; i < rt * D; i += THREADS) {
        const int r = i / D, d = i % D;
        const float* pr = p_s + r * TC + j * ps;
        float s = pv_s[i];
        for (int c = 0; c < ps; ++c) {
          const float p = pr[c];
          if (p != 0.f) s = fmaf(p, kv_s[c * ld + d], s);
        }
        pv_s[i] = s;
      }
      __syncthreads();
    }
    for (int i = tid; i < rt * D; i += THREADS)
      acc_s[i] = al_s[i / D] * acc_s[i] + pv_s[i];
    __syncthreads();
  }

  if (kFinal) {
    for (int i = tid; i < nr * D; i += THREADS) {
      const float y = acc_s[i] / fmaxf(l_s[i / D], 1e-30f);
      if (g.q_bf16)
        static_cast<__nv_bfloat16*>(out)[qbase + i] = __float2bfloat16_rn(y);
      else
        static_cast<float*>(out)[qbase + i] = y;
    }
  } else {
    const size_t row0 = ((size_t)(sp * g.B + b) * g.Hkv + h) * g.rows + r0;
    for (int i = tid; i < nr * D; i += THREADS) acc_o[row0 * D + i] = acc_s[i];
    for (int r = tid; r < nr; r += THREADS) {
      m_o[row0 + r] = m_s[r];
      l_o[row0 + r] = l_s[r];
    }
  }
}

// grid (row tiles, 1, B * Hkv): one page per step over the whole table
__global__ void __launch_bounds__(THREADS)
paged_attention_unsplit_kernel(Geometry g, void* out) {
  const int bh = blockIdx.z;
  walk<true>(g, bh / g.Hkv, bh % g.Hkv, blockIdx.x * g.rt, 0, out, nullptr,
             nullptr, nullptr);
}

// grid (row tiles, kv_split, B * Hkv): one partition per block
__global__ void __launch_bounds__(THREADS)
paged_attention_split_kernel(Geometry g, float* acc_o, float* m_o,
                             float* l_o) {
  const int bh = blockIdx.z;
  walk<false>(g, bh / g.Hkv, bh % g.Hkv, blockIdx.x * g.rt, blockIdx.y,
              nullptr, acc_o, m_o, l_o);
}

// out = sum_s alpha_s acc_s / max(sum_s alpha_s l_s, 1e-30),
// alpha_s = exp(m_s - max_s m_s): the combine_splits formula
__global__ void combine_splits_kernel(const float* __restrict__ acc,
                                      const float* __restrict__ m,
                                      const float* __restrict__ l,
                                      void* __restrict__ out, int split,
                                      int nrows, int D, int out_bf16) {
  const size_t n = (size_t)nrows * D;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t row = i / D;
    float m_star = m[row];
    for (int s = 1; s < split; ++s) m_star = fmaxf(m_star, m[s * (size_t)nrows + row]);
    float l_star = 0.f, a_star = 0.f;
    for (int s = 0; s < split; ++s) {
      const float alpha = expf(m[s * (size_t)nrows + row] - m_star);
      l_star += alpha * l[s * (size_t)nrows + row];
      a_star += alpha * acc[s * n + i];
    }
    const float y = a_star / fmaxf(l_star, 1e-30f);
    if (out_bf16)
      static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(y);
    else
      static_cast<float*>(out)[i] = y;
  }
}

Geometry make_geometry(const void* q, const void* k, const void* v,
                       const void* bt, const void* qpos, int B, int Hkv,
                       int rows, int D, int S, int ps, int P, int NP, int t,
                       int split, float scale, int q_bf16) {
  Geometry g;
  g.q = q;
  g.k_pages = static_cast<const float*>(k);
  g.v_pages = static_cast<const float*>(v);
  g.bt = static_cast<const int*>(bt);
  g.qpos = static_cast<const int*>(qpos);
  g.B = B; g.Hkv = Hkv; g.rows = rows; g.D = D; g.S = S; g.ps = ps;
  g.P = P; g.NP = NP; g.t = t;
  const int tiles = (NP + t - 1) / t;
  g.nt = (tiles + split - 1) / split;
  g.rt = rows <= 8 ? 8 : 16;
  g.scale = scale;
  g.q_bf16 = q_bf16;
  return g;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int paged_attention_unsplit_launch(
    const void* q, const void* k_pages, const void* v_pages, const void* bt,
    const void* qpos, void* out, int B, int Hkv, int rows, int D, int S,
    int ps, int P, int NP, float scale, int q_bf16, void* stream) {
  const Geometry g = make_geometry(q, k_pages, v_pages, bt, qpos, B, Hkv,
                                   rows, D, S, ps, P, NP, 1, 1, scale, q_bf16);
  const size_t bytes = smem_floats(g.rt, D, ps, 1) * sizeof(float);
  cudaError_t err = prepare(paged_attention_unsplit_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((rows + g.rt - 1) / g.rt, 1, B * Hkv);
  paged_attention_unsplit_kernel<<<grid, THREADS, bytes,
                                   static_cast<cudaStream_t>(stream)>>>(g, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int paged_attention_split_launch(
    const void* q, const void* k_pages, const void* v_pages, const void* bt,
    const void* qpos, void* acc_o, void* m_o, void* l_o, int B, int Hkv,
    int rows, int D, int S, int ps, int P, int NP, int t, int split,
    float scale, int q_bf16, void* stream) {
  const Geometry g = make_geometry(q, k_pages, v_pages, bt, qpos, B, Hkv,
                                   rows, D, S, ps, P, NP, t, split, scale,
                                   q_bf16);
  const size_t bytes = smem_floats(g.rt, D, ps, t) * sizeof(float);
  cudaError_t err = prepare(paged_attention_split_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((rows + g.rt - 1) / g.rt, split, B * Hkv);
  paged_attention_split_kernel<<<grid, THREADS, bytes,
                                 static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<float*>(acc_o), static_cast<float*>(m_o),
      static_cast<float*>(l_o));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int combine_splits_launch(const void* acc, const void* m,
                                     const void* l, void* out, int split,
                                     int nrows, int D, int out_bf16,
                                     void* stream) {
  const size_t n = (size_t)nrows * D;
  const int blocks = (int)((n + THREADS - 1) / THREADS);
  combine_splits_kernel<<<blocks > 0 ? blocks : 1, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(acc), static_cast<const float*>(m),
      static_cast<const float*>(l), out, split, nrows, D, out_bf16);
  return static_cast<int>(cudaGetLastError());
}
