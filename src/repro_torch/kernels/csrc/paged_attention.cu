// Paged attention over a block-table-indexed KV page pool, for Hopper
// (sm_90a): the unsplit kernel, the split-KV partition kernel and the
// log-sum-exp combine.
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
// The unsplit kernel (kv_split = 1: one launch, no partials in device
// memory, no combine launch):
//  * one block of 8 warps per (batch, KV head, 8-row tile) -- the 8 rows
//    of gemma-2b's MQA decode in one block; the block reads its own block
//    table, and warp w walks entries w, w + 8, ... with its own online
//    softmax state (m, l and the 8 rows' f32 accumulator in registers,
//    64 a lane at D 256), so a block streams 8 pages at a time instead
//    of one; at the end the warps merge with the combine_splits formula
//    through shared memory, and a warp that saw no page weighs 0;
//  * K/V rows go straight to registers as 16-byte loads, each lane owning
//    4 columns per 128, four rows at a time with the next four in flight
//    (V's first rows load during the softmax); no __syncthreads in the
//    page loop;
//  * logits: per-lane partial dot products over the lane's columns, then
//    one reduce-scatter of the 32 (row, key) sums of four keys (31
//    shuffles), which leaves each lane one logit; the quad that holds a
//    row updates its softmax state and hands p to the warp through a
//    per-warp shared buffer;
//  * entries past the last visible position, and pages whose id is out
//    of range, are never dereferenced; a p of 0 multiplies nothing, so
//    NaN in unwritten page rows cannot leak.
// The split kernel (paged_attention_split_kernel, walk below):
//  * pages are fetched through the block table by the block itself
//    (float4 loads of one contiguous 16 x D page), each visible page read
//    once per (batch, KV head, row tile); pages past the last visible
//    position and split-padding entries are never read;
//  * the query tile, the running (m, l) and the f32 accumulator stay in
//    shared memory for the whole walk: 16 rows x 256 x 4 B = 16 KB each,
//    so rows beyond 16 (group 8 x S 16 = 128 at prefill) are spread over
//    row-tile blocks instead of one 128 KB accumulator;
//  * it cuts the table into kv_split partitions run by separate blocks
//    (flash decoding), so a long context is not one serial page chain on
//    one SM; its partials (acc, m, l) go to HBM and a second tiny kernel
//    applies the combine formula.  A multi-page tile (pages_per_step)
//    computes its logits page by page into shared memory and updates the
//    softmax state once per tile, as the reference does.
//    Not yet done (a later change): async double-buffered page fetches
//    and register-resident state, as in the unsplit kernel.

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

// Online-softmax walk of partition `sp` for (b, h, rows r0 .. r0+rt),
// writing the raw partials (acc, m, l) of this partition.
__device__ void walk(const Geometry& g, int b, int h, int r0, int sp,
                     float* acc_o, float* m_o, float* l_o) {
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

  const size_t row0 = ((size_t)(sp * g.B + b) * g.Hkv + h) * g.rows + r0;
  for (int i = tid; i < nr * D; i += THREADS) acc_o[row0 * D + i] = acc_s[i];
  for (int r = tid; r < nr; r += THREADS) {
    m_o[row0 + r] = m_s[r];
    l_o[row0 + r] = l_s[r];
  }
}

// ---- the unsplit kernel: one block per (batch, KV head, 8-row tile), the
// table's pages dealt round-robin to its warps ---------------------------

constexpr int URT = 8;   // query rows per unsplit block

// Shared-memory floats of the unsplit kernel: q (URT x D); per warp the
// page's logits (URT x ps), its p (ps x URT) and alpha (URT); the warps'
// states for the merge (NWARPS x URT x D acc, NWARPS x URT m and l), the
// merge weights (NWARPS x URT) and the merged l (URT)
__host__ __device__ inline size_t unsplit_smem_floats(int D, int ps) {
  return (size_t)URT * D + (size_t)NWARPS * (2 * URT * ps + URT) +
         (size_t)NWARPS * URT * D + 3 * (size_t)NWARPS * URT + URT;
}

// One step of a reduce-scatter over the warp: lanes that differ in bit N
// swap halves of v and each adds what it kept to what it received.
template <int N>
__device__ __forceinline__ void fold(float (&v)[32], int lane) {
  const bool up = lane & N;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = up ? v[i] : v[i + N];
    const float keep = up ? v[i + N] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, N);
  }
}

// The warp sum of v[lane]: 31 shuffles for 32 sums (not 5 per sum).
__device__ __forceinline__ float reduce_scatter(float (&v)[32], int lane) {
  fold<16>(v, lane);
  fold<8>(v, lane);
  fold<4>(v, lane);
  fold<2>(v, lane);
  fold<1>(v, lane);
  return v[0];
}

// Rows c0 .. c0 + 3 (those < nc) of one page's (ps, D) K or V block into
// registers: the lane's float4 columns 4 * (lane + 32 u), zero elsewhere.
template <int NV>
__device__ __forceinline__ void load_rows(float4 (&x)[4][NV],
                                          const float* src, int c0, int nc,
                                          int D, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int col = 4 * (lane + 32 * u);
      x[j][u] = (c0 + j < nc && col < D)
                    ? __ldg(reinterpret_cast<const float4*>(
                          src + (size_t)(c0 + j) * D + col))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, s))));
}

__device__ __forceinline__ void axpy4(float p, float4 v, float4& acc) {
  acc.x = fmaf(p, v.x, acc.x);
  acc.y = fmaf(p, v.y, acc.y);
  acc.z = fmaf(p, v.z, acc.z);
  acc.w = fmaf(p, v.w, acc.w);
}

// grid (row tiles, 1, B * Hkv), NWARPS warps: warp w walks table entries
// w, w + NWARPS, ... with its own online-softmax state, then the warps
// merge with the combine_splits formula.  NV: float4 columns per lane
// (D <= 128 * NV, D % 4 == 0).
template <int NV>
__global__ void __launch_bounds__(THREADS, 1)
paged_attention_unsplit_kernel(Geometry g, void* out) {
  extern __shared__ __align__(16) float us_smem[];
  const int D = g.D, ps = g.ps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.z / g.Hkv, h = blockIdx.z % g.Hkv;
  const int r0 = blockIdx.x * URT;
  float* q_s = us_smem;                                       // URT x D
  float* s_w = q_s + URT * D + warp * (2 * URT * ps + URT);   // URT x ps
  float* p_w = s_w + URT * ps;                                // ps x URT
  float* a_w = p_w + URT * ps;                                // URT
  float* acc_m = q_s + URT * D + NWARPS * (2 * URT * ps + URT);
  float* m_m = acc_m + NWARPS * URT * D;                      // NWARPS x URT
  float* l_m = m_m + NWARPS * URT;
  float* w_m = l_m + NWARPS * URT;
  float* l_star = w_m + NWARPS * URT;                         // URT

  const int nr = min(URT, g.rows - r0);
  const size_t qbase = ((size_t)(b * g.Hkv + h) * g.rows + r0) * D;
  for (int i = threadIdx.x; i < URT * D; i += THREADS)
    // q.astype(f32) * scale, as _paged_kernel:181
    q_s[i] = (i / D < nr) ? load_q(g.q, qbase + i, g.q_bf16) * g.scale : 0.f;
  __syncthreads();

  const int qpos0 = g.qpos[b];
  const int last = qpos0 + g.S - 1;        // last position any row sees
  const int* btb = g.bt + (size_t)b * g.NP;
  // entries past the last visible position are never read
  const int npages = min(g.NP, last / ps + 1);
  // after the reduce-scatter lane l holds row l / 4, key 4 i + l % 4 of
  // each group of four keys; a quad of lanes shares one row's state
  const int my_r = lane >> 2, my_c = lane & 3;
  const int my_qp = qpos0 + (r0 + my_r) % g.S;
  float m_r = NEG, l_r = 0.f;
  float4 acc[URT][NV];
#pragma unroll
  for (int r = 0; r < URT; ++r)
#pragma unroll
    for (int u = 0; u < NV; ++u) acc[r][u] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int e = warp; e < npages; e += NWARPS) {
    const int pg = btb[e];
    // an out-of-range id is never dereferenced: all its columns would be
    // masked, an exact no-op of the online update
    if (pg < 0 || pg >= g.P) continue;
    const size_t off = ((size_t)pg * g.Hkv + h) * ps * D;
    const float* kp = g.k_pages + off;
    const float* vp = g.v_pages + off;
    const int base = e * ps;
    const int nc = min(ps, last - base + 1);   // rows some query row sees
    const int nk = (nc + 3) >> 2;
    float4 buf[4][NV];
    load_rows<NV>(buf, kp, 0, nc, D, lane);

    // 1. logits, four keys at a time: per-lane partial dot products over
    //    the lane's columns, then one reduce-scatter for all 32 (row, key)
    for (int ci = 0; ci < nk; ++ci) {
      float4 cur[4][NV];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int u = 0; u < NV; ++u) cur[j][u] = buf[j][u];
      if (ci + 1 < nk)
        load_rows<NV>(buf, kp, 4 * (ci + 1), nc, D, lane);
      else    // V's first rows load during the softmax
        load_rows<NV>(buf, vp, 0, nc, D, lane);
      float part[32];
#pragma unroll
      for (int r = 0; r < URT; ++r) {
        float4 qv[NV];
#pragma unroll
        for (int u = 0; u < NV; ++u) {
          const int col = 4 * (lane + 32 * u);
          qv[u] = col < D ? *reinterpret_cast<const float4*>(q_s + r * D + col)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float sum = 0.f;
#pragma unroll
          for (int u = 0; u < NV; ++u) sum = dot4(qv[u], cur[j][u], sum);
          part[r * 4 + j] = sum;
        }
      }
      const float x = reduce_scatter(part, lane);
      const int c = 4 * ci + my_c;
      if (c < nc) s_w[my_r * ps + c] = x;
    }
    __syncwarp();

    // 2. online-softmax update of row my_r over the page's visible keys
    float mx = m_r;
    for (int c = my_c; c < nc; c += 4)
      if (base + c <= my_qp) mx = fmaxf(mx, s_w[my_r * ps + c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = 0.f;
    for (int c = my_c; c < nc; c += 4) {
      const float p = base + c <= my_qp ? expf(s_w[my_r * ps + c] - mx) : 0.f;
      p_w[c * URT + my_r] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float alpha = expf(m_r - mx);
    l_r = alpha * l_r + sum;
    m_r = mx;
    if (my_c == 0) a_w[my_r] = alpha;
    __syncwarp();

    // 3. acc = alpha * acc + p . V, four keys at a time; a zero p (masked
    //    or underflowed) multiplies nothing, so NaN in unwritten or
    //    recycled rows cannot leak
#pragma unroll
    for (int r = 0; r < URT; ++r) {
      const float a = a_w[r];
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        acc[r][u].x *= a;
        acc[r][u].y *= a;
        acc[r][u].z *= a;
        acc[r][u].w *= a;
      }
    }
    for (int ci = 0; ci < nk; ++ci) {
      float4 cur[4][NV];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int u = 0; u < NV; ++u) cur[j][u] = buf[j][u];
      if (ci + 1 < nk) load_rows<NV>(buf, vp, 4 * (ci + 1), nc, D, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * ci + j;
        if (c >= nc) continue;
        const float4 pa = *reinterpret_cast<const float4*>(p_w + c * URT);
        const float4 pb = *reinterpret_cast<const float4*>(p_w + c * URT + 4);
        const float pr[URT] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int r = 0; r < URT; ++r) {
          if (pr[r] == 0.f) continue;
#pragma unroll
          for (int u = 0; u < NV; ++u) axpy4(pr[r], cur[j][u], acc[r][u]);
        }
      }
    }
    __syncwarp();                // s_w, p_w and a_w are the next page's
  }

  // merge the warps' states: out = sum_w alpha_w acc_w / max(sum_w alpha_w
  // l_w, 1e-30), alpha_w = exp(m_w - max_w m_w); a warp that saw no page
  // (m = -1e30, l = 0) weighs exactly 0
#pragma unroll
  for (int r = 0; r < URT; ++r)
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int col = 4 * (lane + 32 * u);
      if (col < D)
        *reinterpret_cast<float4*>(acc_m + (warp * URT + r) * D + col) =
            acc[r][u];
    }
  if (my_c == 0) {
    m_m[warp * URT + my_r] = m_r;
    l_m[warp * URT + my_r] = l_r;
  }
  __syncthreads();
  if (threadIdx.x < URT) {
    const int r = threadIdx.x;
    float ms = NEG;
    for (int w = 0; w < NWARPS; ++w) ms = fmaxf(ms, m_m[w * URT + r]);
    float ls = 0.f;
    for (int w = 0; w < NWARPS; ++w) {
      const float wt = expf(m_m[w * URT + r] - ms);
      w_m[w * URT + r] = wt;
      ls += wt * l_m[w * URT + r];
    }
    l_star[r] = fmaxf(ls, 1e-30f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nr * D; i += THREADS) {
    const int r = i / D;
    float a = 0.f;
    for (int w = 0; w < NWARPS; ++w)
      a += w_m[w * URT + r] * acc_m[(size_t)w * URT * D + i];
    const float y = a / l_star[r];
    if (g.q_bf16)
      static_cast<__nv_bfloat16*>(out)[qbase + i] = __float2bfloat16_rn(y);
    else
      static_cast<float*>(out)[qbase + i] = y;
  }
}

// grid (row tiles, kv_split, B * Hkv): one partition per block
__global__ void __launch_bounds__(THREADS)
paged_attention_split_kernel(Geometry g, float* acc_o, float* m_o,
                             float* l_o) {
  const int bh = blockIdx.z;
  walk(g, bh / g.Hkv, bh % g.Hkv, blockIdx.x * g.rt, blockIdx.y, acc_o, m_o,
       l_o);
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

// The unsplit kernel takes D % 4 == 0 and D <= 256 (the wrapper checks).
extern "C" int paged_attention_unsplit_launch(
    const void* q, const void* k_pages, const void* v_pages, const void* bt,
    const void* qpos, void* out, int B, int Hkv, int rows, int D, int S,
    int ps, int P, int NP, float scale, int q_bf16, void* stream) {
  if (D % 4 != 0 || D < 4 || D > 256 || rows < 1 || ps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = make_geometry(q, k_pages, v_pages, bt, qpos, B, Hkv,
                                   rows, D, S, ps, P, NP, 1, 1, scale,
                                   q_bf16);
  const size_t bytes = unsplit_smem_floats(D, ps) * sizeof(float);
  const dim3 grid((rows + URT - 1) / URT, 1, B * Hkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D <= 128) {
    err = prepare(paged_attention_unsplit_kernel<1>, bytes);
    if (err == cudaSuccess)
      paged_attention_unsplit_kernel<1><<<grid, THREADS, bytes, s>>>(g, out);
  } else {
    err = prepare(paged_attention_unsplit_kernel<2>, bytes);
    if (err == cudaSuccess)
      paged_attention_unsplit_kernel<2><<<grid, THREADS, bytes, s>>>(g, out);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
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
