// Paged attention over a block-table-indexed KV page pool, for Hopper
// (sm_90a): one kernel serves the unsplit and the split-KV (flash
// decoding) routes.
//
// Replaces:
//  * src/repro/kernels/flash_attention.py:217 _paged_attention_unsplit
//    (Pallas body _paged_kernel :154): one partition, normalised in place;
//  * src/repro/kernels/flash_attention.py:514 paged_attention_pallas
//    (Pallas body _paged_split_kernel :274, then combine_splits :353):
//    kv_split partitions whose partials the last block of each (batch, KV
//    head, row tile) merges by the combine_splits formula.
// Contract (as the reference): q (B, Hq, S, D) folded group-major onto its
// KV head as (B, Hkv, rows = group*S, D), f32 or bf16; pages
// (P, Hkv, ps, D) f32; block table (B, NP) int32; qpos (B,) int32.  Row r
// is query position qpos[b] + r % S and sees kv positions <= that
// (write-before-attend).  Masked logits weigh exactly 0; pages wholly past
// the last visible position are skipped; a row that sees nothing outputs
// 0 (the max(l, 1e-30) guard).  The output has q's dtype.
//
// What bounds it on the H100: bytes.  Decode reads every visible K and V
// row once (f32, 2 * D * 4 = 2 KB per token and KV head) for ~4 * rows * D
// flops per token -- 8 rows at gemma-2b's MQA decode, ~4 flops per byte,
// far below the f32 roofline's ~20 (67 TFLOP/s over 3.35 TB/s).  A
// chunked-prefill call (rows = 8 * 16) is denser but still moves more
// bytes than it can hide at these context lengths.  So the design keeps
// many pages in flight and nothing but the output (and, split, the small
// partials) in device memory.
//
// The walk (one device function for both routes):
//  * grid (8-row tiles, partitions, B * Hkv), one block of 8 warps each:
//    the block reads its own block table, and warp w walks its
//    partition's entries e0 + w, e0 + w + 8, ... with its own online
//    softmax state (m, l and the 8 rows' f32 accumulator in registers, 64
//    a lane at D 256), so a block streams 8 pages at a time;
//  * K/V rows go straight to registers as 16-byte loads, each lane owning
//    4 columns per 128, four rows at a time with the next four in flight
//    (V's first rows load during the softmax); no __syncthreads in the
//    page loop;
//  * logits: per-lane partial dot products over the lane's columns, then
//    one reduce-scatter of the 32 (row, key) sums of four keys (31
//    shuffles), which leaves each lane one logit; the quad that holds a
//    row updates its softmax state and hands p to the warp through a
//    per-warp shared buffer;
//  * the warps merge with the combine_splits formula through shared
//    memory (a warp that saw no page weighs 0);
//  * entries past the last visible position, split padding (e >= NP) and
//    page ids out of range are never dereferenced; a p of 0 multiplies
//    nothing, so NaN in unwritten page rows cannot leak.
// Output modes: with one partition the block normalises in place (no
// partials, one launch).  With kv_split partitions, partition sp covers
// the reference's entries [sp * nt * t, (sp + 1) * nt * t); its block
// writes the raw partial (acc, m, l) -- a dead partition keeps m = -1e30,
// l = 0 and weighs exactly 0 -- then takes a ticket after a fence; the
// last block of the (batch, KV head, row tile) applies combine_splits and
// writes the output, and leaves its ticket zeroed for the next launch.
// So the split route is one launch too.  Inside a partition the state is
// updated per warp and page, not once per pages_per_step tile: the
// kernel rounds differently from paged_attention_split_ref, within the
// gates stated beside its checks.  The wrapper hands every stream its
// own ticket buffer (and every CUDA-graph capture a buffer of its own,
// kept for the life of the process), so launches on two streams, or a
// replay beside eager launches, never share tickets.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int RT = 8;    // query rows per block
constexpr float NEG = -1e30f;

struct Geometry {
  const void* q;         // (B, Hkv, rows, D) f32 or bf16
  const float* k_pages;  // (P, Hkv, ps, D)
  const float* v_pages;
  const int* bt;         // (B, NP)
  const int* qpos;       // (B,)
  int B, Hkv, rows, D, S, ps, P, NP;
  int span;              // table entries per partition (nt * t)
  float scale;
  int q_bf16;
};

// The split route's scratch: raw partials (split, B, Hkv, rows[, D]) and
// one ticket per (batch, KV head, row tile), zero on entry and on exit.
struct Partials {
  float* acc;
  float* m;
  float* l;
  unsigned* tickets;
};

__device__ __forceinline__ float load_q(const void* q, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i])
              : static_cast<const float*>(q)[i];
}

// Shared-memory floats: q (RT x D); per warp the page's logits (RT x ps),
// its p (ps x RT) and alpha (RT); the warps' states for the merge
// (NWARPS x RT x D acc, NWARPS x RT m and l), the merge weights
// (NWARPS x RT) and the merged l (RT)
__host__ __device__ inline size_t smem_floats(int D, int ps) {
  return (size_t)RT * D + (size_t)NWARPS * (2 * RT * ps + RT) +
         (size_t)NWARPS * RT * D + 3 * (size_t)NWARPS * RT + RT;
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


// Warp `warp` of the block walks table entries e0 + warp, e0 + warp +
// NWARPS, ... below e1 with its own online softmax: on return acc (the
// lane's columns of all RT rows), m_r and l_r (row lane / 4) hold its
// state.  NV: float4 columns per lane (D <= 128 * NV, D % 4 == 0).
template <int NV>
__device__ __forceinline__ void walk(const Geometry& g, int b, int h, int e0,
                                     int e1, const float* q_s, float* s_w,
                                     float* p_w, float* a_w,
                                     float4 (&acc)[RT][NV], float& m_r,
                                     float& l_r) {
  const int D = g.D, ps = g.ps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qpos0 = g.qpos[b];
  const int last = qpos0 + g.S - 1;        // last position any row sees
  const int* btb = g.bt + (size_t)b * g.NP;
  // after the reduce-scatter lane l holds row l / 4, key 4 i + l % 4 of
  // each group of four keys; a quad of lanes shares one row's state
  const int my_r = lane >> 2, my_c = lane & 3;
  const int my_qp = qpos0 + (blockIdx.x * RT + my_r) % g.S;
  m_r = NEG;
  l_r = 0.f;
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int u = 0; u < NV; ++u) acc[r][u] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int e = e0 + warp; e < e1; e += NWARPS) {
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
      for (int r = 0; r < RT; ++r) {
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
      p_w[c * RT + my_r] = p;
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
    for (int r = 0; r < RT; ++r) {
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
        const float4 pa = *reinterpret_cast<const float4*>(p_w + c * RT);
        const float4 pb = *reinterpret_cast<const float4*>(p_w + c * RT + 4);
        const float pr[RT] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if (pr[r] == 0.f) continue;
#pragma unroll
          for (int u = 0; u < NV; ++u) axpy4(pr[r], cur[j][u], acc[r][u]);
        }
      }
    }
    __syncwarp();                // s_w, p_w and a_w are the next page's
  }
}

__device__ __forceinline__ void store_out(void* out, size_t i, float y,
                                          int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(y);
  else
    static_cast<float*>(out)[i] = y;
}

// grid (row tiles, partitions, B * Hkv), NWARPS warps: the walk over this
// block's partition, the warps' merge, then the output mode (above).
template <int NV>
__global__ void __launch_bounds__(THREADS, 1)
paged_attention_kernel(Geometry g, void* out, Partials part) {
  extern __shared__ __align__(16) float smem[];
  const int D = g.D, ps = g.ps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.z / g.Hkv, h = blockIdx.z % g.Hkv;
  const int r0 = blockIdx.x * RT;
  const int sp = blockIdx.y, split = gridDim.y;
  float* q_s = smem;                                         // RT x D
  float* s_w = q_s + RT * D + warp * (2 * RT * ps + RT);    // RT x ps
  float* p_w = s_w + RT * ps;                                // ps x RT
  float* a_w = p_w + RT * ps;                                // RT
  float* acc_m = q_s + RT * D + NWARPS * (2 * RT * ps + RT);
  float* m_m = acc_m + NWARPS * RT * D;                      // NWARPS x RT
  float* l_m = m_m + NWARPS * RT;
  float* w_m = l_m + NWARPS * RT;
  float* l_star = w_m + NWARPS * RT;                         // RT

  const int nr = min(RT, g.rows - r0);
  const size_t qbase = ((size_t)(b * g.Hkv + h) * g.rows + r0) * D;
  for (int i = threadIdx.x; i < RT * D; i += THREADS)
    // q.astype(f32) * scale, as _paged_kernel:181
    q_s[i] = (i / D < nr) ? load_q(g.q, qbase + i, g.q_bf16) * g.scale : 0.f;
  __syncthreads();

  // this partition's entries, up to the last visible position
  const int last = g.qpos[b] + g.S - 1;
  const int e0 = sp * g.span;
  const int e1 = min(min(g.NP, last / g.ps + 1), e0 + g.span);
  float4 acc[RT][NV];
  float m_r, l_r;
  walk<NV>(g, b, h, e0, e1, q_s, s_w, p_w, a_w, acc, m_r, l_r);

  // merge the warps' states: acc_p = sum_w alpha_w acc_w, l_p = sum_w
  // alpha_w l_w, alpha_w = exp(m_w - m_p), m_p = max_w m_w; a warp that
  // saw no page (m = -1e30, l = 0) weighs exactly 0
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int col = 4 * (lane + 32 * u);
      if (col < D)
        *reinterpret_cast<float4*>(acc_m + (warp * RT + r) * D + col) =
            acc[r][u];
    }
  if ((lane & 3) == 0) {
    m_m[warp * RT + (lane >> 2)] = m_r;
    l_m[warp * RT + (lane >> 2)] = l_r;
  }
  __syncthreads();
  if (threadIdx.x < RT) {
    const int r = threadIdx.x;
    float ms = NEG;
    for (int w = 0; w < NWARPS; ++w) ms = fmaxf(ms, m_m[w * RT + r]);
    float ls = 0.f;
    for (int w = 0; w < NWARPS; ++w) {
      const float wt = expf(m_m[w * RT + r] - ms);
      w_m[w * RT + r] = wt;
      ls += wt * l_m[w * RT + r];
    }
    l_star[r] = ls;
    m_m[r] = ms;     // row r's m_p (warp 0's m is read above, by this thread)
  }
  __syncthreads();

  if (split == 1) {     // one partition: normalise in place
    for (int i = threadIdx.x; i < nr * D; i += THREADS) {
      const int r = i / D;
      float a = 0.f;
      for (int w = 0; w < NWARPS; ++w)
        a += w_m[w * RT + r] * acc_m[(size_t)w * RT * D + i];
      store_out(out, qbase + i, a / fmaxf(l_star[r], 1e-30f), g.q_bf16);
    }
    return;
  }

  // the partition's raw partial, then the ticket
  const size_t nrows = (size_t)g.B * g.Hkv * g.rows;
  const size_t prow = (size_t)(b * g.Hkv + h) * g.rows + r0;   // row index
  for (int i = threadIdx.x; i < nr * D; i += THREADS) {
    const int r = i / D;
    float a = 0.f;
    for (int w = 0; w < NWARPS; ++w)
      a += w_m[w * RT + r] * acc_m[(size_t)w * RT * D + i];
    part.acc[(sp * nrows + prow) * D + i] = a;
  }
  if (threadIdx.x < nr) {
    part.m[sp * nrows + prow + threadIdx.x] = m_m[threadIdx.x];
    part.l[sp * nrows + prow + threadIdx.x] = l_star[threadIdx.x];
  }
  __threadfence();
  __syncthreads();
  __shared__ bool last_block;
  const unsigned tile = blockIdx.z * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0)
    last_block = atomicAdd(part.tickets + tile, 1u) == (unsigned)(split - 1);
  __syncthreads();
  if (!last_block) return;
  __threadfence();

  // out = sum_s alpha_s acc_s / max(sum_s alpha_s l_s, 1e-30),
  // alpha_s = exp(m_s - max_s m_s): the combine_splits formula; the
  // partials of other blocks are read past L1 (__ldcg)
  float* m_star = w_m;          // RT
  float* ls_star = w_m + RT;    // RT
  if (threadIdx.x < nr) {
    const size_t row = prow + threadIdx.x;
    float ms = __ldcg(part.m + row);
    for (int s = 1; s < split; ++s)
      ms = fmaxf(ms, __ldcg(part.m + s * nrows + row));
    float ls = 0.f;
    for (int s = 0; s < split; ++s)
      ls += expf(__ldcg(part.m + s * nrows + row) - ms) *
            __ldcg(part.l + s * nrows + row);
    m_star[threadIdx.x] = ms;
    ls_star[threadIdx.x] = ls;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nr * D; i += THREADS) {
    const int r = i / D;
    float a = 0.f;
    for (int s = 0; s < split; ++s)
      a += expf(__ldcg(part.m + s * nrows + prow + r) - m_star[r]) *
           __ldcg(part.acc + (s * nrows + prow) * D + i);
    store_out(out, qbase + i, a / fmaxf(ls_star[r], 1e-30f), g.q_bf16);
  }
  if (threadIdx.x == 0) part.tickets[tile] = 0u;
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

// D % 4 == 0 and D <= 256 (the wrappers check).  split == 1 writes the
// output directly and takes no scratch (acc, m, l, tickets may be null);
// split > 1 needs acc (split, B, Hkv, rows, D), m and l (split, B, Hkv,
// rows) f32 and tickets (B * Hkv * row tiles, zero; left zero).  span:
// table entries per partition.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages, const void* bt,
    const void* qpos, void* out, void* acc, void* m, void* l, void* tickets,
    int B, int Hkv, int rows, int D, int S, int ps, int P, int NP, int span,
    int split, float scale, int q_bf16, void* stream) {
  if (D % 4 != 0 || D < 4 || D > 256 || rows < 1 || ps < 1 || split < 1 ||
      span < 1 || (split > 1 && (!acc || !m || !l || !tickets)))
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.q = q;
  g.k_pages = static_cast<const float*>(k_pages);
  g.v_pages = static_cast<const float*>(v_pages);
  g.bt = static_cast<const int*>(bt);
  g.qpos = static_cast<const int*>(qpos);
  g.B = B; g.Hkv = Hkv; g.rows = rows; g.D = D; g.S = S; g.ps = ps;
  g.P = P; g.NP = NP; g.span = span;
  g.scale = scale;
  g.q_bf16 = q_bf16;
  const Partials part = {static_cast<float*>(acc), static_cast<float*>(m),
                         static_cast<float*>(l),
                         static_cast<unsigned*>(tickets)};
  const size_t bytes = smem_floats(D, ps) * sizeof(float);
  const dim3 grid((rows + RT - 1) / RT, split, B * Hkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D <= 128) {
    err = prepare(paged_attention_kernel<1>, bytes);
    if (err == cudaSuccess)
      paged_attention_kernel<1><<<grid, THREADS, bytes, s>>>(g, out, part);
  } else {
    err = prepare(paged_attention_kernel<2>, bytes);
    if (err == cudaSuccess)
      paged_attention_kernel<2><<<grid, THREADS, bytes, s>>>(g, out, part);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
