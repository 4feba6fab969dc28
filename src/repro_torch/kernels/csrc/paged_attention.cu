// Paged attention over a block-table-indexed KV page pool, for Hopper
// (sm_90a): two kernels, each serving the unsplit and the split-KV (flash
// decoding) routes in one launch -- the Hopper kernel, which the wrappers
// run wherever its plan takes the shape, and the control (the first port's
// CUDA-core walk), kept beside it for the shapes the plan refuses and as
// the yardstick it is timed against.
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
// What bounds it on the H100: bytes at decode.  Decode reads every visible
// K and V row once (f32, 2 * D * 4 = 2 KB per token and KV head at D 256)
// for ~4 * rows * D flops per token -- 8 rows at gemma-2b's MQA decode, ~4
// flops per byte, far below the f32 roofline's ~20 (67 TFLOP/s over 3.35
// TB/s).  A chunked-prefill call (rows = group * 16, up to 256) does ~64
// flops per byte: there the f32 products bound it.
//
// The Hopper kernel (paged_hopper_kernel):
//  * the query rows of a (batch, KV head) in row tiles of up to 16 (2 *
//    rw: a warp owns two rows, a half warp one), so that a visible page is
//    read from device memory once per (batch, KV head, row tile, block of
//    pages) and shared by the tile's rows from shared memory;
//  * a producer warp stages pages by 1-D bulk async copies (cp.async.bulk,
//    the page's nc visible rows of K and of V, each contiguous) into a
//    ring of `stages` slots (a multiple of the groups), on full / empty
//    mbarriers;
//  * `groups` groups of rw warps walk the block's pages round-robin, each
//    with its own online softmax state, so that several pages are in the
//    products at once; the groups merge through shared memory with the
//    combine_splits formula, in group order;
//  * a planned grid (chunks, row tiles, B * Hkv): each of the reference's
//    partitions is cut into `cpp` blocks of `per` table entries, so that a
//    decode step's few (batch, KV head) units still fill the card;
//  * the products in f32 on the CUDA cores from shared memory: lane l of
//    a half warp owns the float4 columns l, l + 16, ... of its row; logits
//    are the lanes' partial dot products reduced over the half warp by a
//    reduce-scatter (15 shuffles, which leave lane l key l of a page of <=
//    16 rows), the row's online softmax is a half warp's shuffles, and
//    p . V broadcasts each key's p by a shuffle;
//  * one block of pages: normalised in place.  Several: each writes its
//    raw partial (acc, m, l), takes a ticket after a fence, and the last
//    block of the (batch, KV head, row tile) merges every block's partial
//    in block order with the combine_splits formula (a block that saw
//    nothing weighs exactly 0) and leaves its ticket zeroed.
// Inside a group the state is updated page by page, not once per
// pages_per_step tile, and the blocks' partials merge in one pass: the
// kernel rounds differently from paged_attention_split_ref, within the
// gates stated beside its checks.
//
// The control (paged_attention_kernel), the walk:
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
//    memory (a warp that saw no page weighs 0).
// Both kernels: entries past the last visible position, split padding
// (e >= NP) and page ids out of range are never dereferenced; a p of 0
// multiplies nothing, so NaN in unwritten page rows cannot leak.
// The control's output modes: with one partition the block normalises in
// place (no partials, one launch).  With kv_split partitions, partition sp
// covers the reference's entries [sp * nt * t, (sp + 1) * nt * t); its
// block writes the raw partial (acc, m, l) -- a dead partition keeps
// m = -1e30, l = 0 and weighs exactly 0 -- then takes a ticket after a
// fence; the last block of the (batch, KV head, row tile) applies
// combine_splits and writes the output, and leaves its ticket zeroed.  So
// the split route is one launch too.  The wrapper hands every stream its
// own ticket buffer (and every CUDA-graph capture a buffer of its own,
// kept for the life of the process), so launches on two streams, or a
// replay beside eager launches, never share tickets.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

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

// -- the Hopper kernel -------------------------------------------------------
constexpr int HOP_ROW_WARPS = 8;    // warps a group: 2 rows each, 16 rows
constexpr int HOP_MAX_WARPS = 17;   // the producer and up to 16 consumers
constexpr int HOP_MAX_STAGES = 8;
constexpr int HOP_KEYS = 16;        // page rows the kernel takes (ps <= 16)
constexpr int HOP_HEADER = 256;     // barriers, slot ids and the ticket flag

// The plan's cut: each of the reference's partitions (span entries) into
// cpp blocks of per entries; groups of warps (rw warps each, 2 rows a
// warp) walk a block's entries round-robin; stages pages in flight.
struct HopPlan {
  int per, cpp, stages, groups, rw;
};

// Dynamic shared memory: the header, q (rows of the block x D f32), then
// the ring (stages x K and V of one page).  The groups' merge reuses the
// ring for groups 1.. 's states, the last block's merge q's and the
// ring's bytes for its (blocks x rows) weights and row sums.
inline size_t hop_smem_bytes(int rows_per_block, int D, int ps, int stages) {
  return HOP_HEADER + (size_t)rows_per_block * D * 4 +
         (size_t)stages * 2 * ps * D * 4;
}

// One step of a reduce-scatter over the half warp (lanes that differ in
// bit N, N <= 8): after N = 8, 4, 2, 1 lane l holds the sum of v[l & 15].
template <int N>
__device__ __forceinline__ void fold16(float (&v)[HOP_KEYS], int lane) {
  const bool up = lane & N;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = up ? v[i] : v[i + N];
    const float keep = up ? v[i + N] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, N);
  }
}

__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// q's elements i .. i + 3 (i % 4 == 0) as f32: one 16-byte (f32) or
// 8-byte (bf16) load where q's base allows it
__device__ __forceinline__ float4 load_q4(const Geometry& g, size_t i) {
  const uintptr_t align = g.q_bf16 ? 7 : 15;
  if (reinterpret_cast<uintptr_t>(g.q) & align)
    return make_float4(load_q(g.q, i, g.q_bf16), load_q(g.q, i + 1, g.q_bf16),
                       load_q(g.q, i + 2, g.q_bf16),
                       load_q(g.q, i + 3, g.q_bf16));
  if (g.q_bf16) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(g.q) + i));
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  return __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(g.q)
                                               + i));
}

// four consecutive outputs from element i (i % 4 == 0)
__device__ __forceinline__ void store4(void* out, size_t i, float4 y,
                                       int bf16) {
  if (bf16) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(y.x, y.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(y.z, y.w);
    uint2 w;
    w.x = *reinterpret_cast<const uint32_t*>(&lo);
    w.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + i) = w;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + i) = y;
  }
}

// grid (split * cpp blocks of pages, row tiles, B * Hkv), 32 * (1 +
// groups * rw) threads: warp 0 the producer, then the groups' warps.  NV:
// float4 columns a lane owns per row (D <= 64 * NV).
template <int NV>
__global__ void __launch_bounds__(HOP_MAX_WARPS * 32, 1)
paged_hopper_kernel(Geometry g, HopPlan pl, void* out, Partials part) {
  extern __shared__ __align__(128) unsigned char hsm[];
  uint64_t* full = reinterpret_cast<uint64_t*>(hsm);
  uint64_t* empty = full + HOP_MAX_STAGES;
  int* slot_pg = reinterpret_cast<int*>(empty + HOP_MAX_STAGES);
  int* last_flag = slot_pg + HOP_MAX_STAGES;
  const int D = g.D, ps = g.ps;
  const int rtb = 2 * pl.rw;                          // rows of the block
  float* q_s = reinterpret_cast<float*>(hsm + HOP_HEADER);
  float* ring = q_s + (size_t)rtb * D;
  const size_t page = (size_t)ps * D;                 // floats of one page
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int l16 = lane & 15;
  const int cw = warp - 1;                            // consumer warp
  const int grp = cw / pl.rw;                         // its group
  const int r = 2 * (cw % pl.rw) + (lane >> 4);       // the half warp's row
  const int chunk = blockIdx.x, tile = blockIdx.y;
  const int b = blockIdx.z / g.Hkv, h = blockIdx.z % g.Hkv;
  const int r0 = tile * rtb;
  const int nr = min(rtb, g.rows - r0);
  const int qpos0 = g.qpos[b];
  const int last = qpos0 + g.S - 1;       // last position any row sees
  const int vis = min(g.NP, last / ps + 1);
  const int sp = chunk / pl.cpp;
  const int e0 = sp * g.span + (chunk % pl.cpp) * pl.per;
  const int e1 = min(min(e0 + pl.per, (sp + 1) * g.span), vis);
  const int n = max(0, e1 - e0);
  const int* btb = g.bt + (size_t)b * g.NP;
  const size_t orow = (size_t)(b * g.Hkv + h) * g.rows + r0;   // row index

  if (threadIdx.x == 0) {
    for (int s = 0; s < pl.stages; ++s) {
      hopper::mbar_init(hopper::smem_u32(full + s), 1);
      hopper::mbar_init(hopper::smem_u32(empty + s), pl.rw);
    }
    hopper::fence_barrier_init();
  }
  // q.astype(f32) * scale, as _paged_kernel:181 (rows past the call's
  // zero): four elements a load, eight loads of a thread in flight at once
  {
    const int valid = nr * D, total = rtb * D;     // multiples of 4
    const int step = 4 * blockDim.x;
    for (int i0 = 4 * threadIdx.x; i0 < total; i0 += 8 * step) {
      float4 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int i = i0 + k * step;
        v[k] = i < valid ? load_q4(g, orow * D + i)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int i = i0 + k * step;
        if (i < total)
          *reinterpret_cast<float4*>(q_s + i) =
              make_float4(v[k].x * g.scale, v[k].y * g.scale,
                          v[k].z * g.scale, v[k].w * g.scale);
      }
    }
  }
  __syncthreads();

  float m = NEG, l = 0.f;
  float4 acc[NV];
#pragma unroll
  for (int u = 0; u < NV; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);

  if (warp == 0) {
    // the producer (lane 0): page i of the walk into slot i % stages once
    // the group that read the slot's last page has released it -- the nc
    // rows that some query row sees of K and of V; an out-of-range id is
    // never dereferenced (its slot arrives empty).  Table entries are
    // read one page ahead.
    if (lane == 0 && n > 0) {
      int pg = btb[e0];
      for (int i = 0; i < n; ++i) {
        const int next = i + 1 < n ? btb[e0 + i + 1] : 0;
        const int s = i % pl.stages;
        if (i >= pl.stages)
          hopper::mbar_wait(hopper::smem_u32(empty + s),
                            (i / pl.stages - 1) & 1);
        const uint32_t bar = hopper::smem_u32(full + s);
        if (pg < 0 || pg >= g.P) {
          slot_pg[s] = -1;
          hopper::mbar_arrive(bar);
        } else {
          slot_pg[s] = pg;
          const int e = e0 + i;
          const uint32_t bytes = (uint32_t)min(ps, last - e * ps + 1) * D * 4;
          const size_t off = ((size_t)pg * g.Hkv + h) * page;
          float* dst = ring + (size_t)s * 2 * page;
          hopper::mbar_arrive_expect_tx(bar, 2 * bytes);
          hopper::bulk_load(hopper::smem_u32(dst), g.k_pages + off, bytes,
                            bar);
          hopper::bulk_load(hopper::smem_u32(dst + page), g.v_pages + off,
                            bytes, bar);
        }
        pg = next;
      }
    }
    __syncwarp();
  } else {
    // group grp walks the block's pages grp, grp + groups, ...: its half
    // warp owns row r, lane l the float4 columns l, l + 16, ... of it
    const int qp = qpos0 + (r0 + r) % g.S;
    for (int i = grp; i < n; i += pl.groups) {
      const int s = i % pl.stages;
      hopper::mbar_wait(hopper::smem_u32(full + s), (i / pl.stages) & 1);
#ifdef PAGED_LOADS_ONLY
      // chip_paged_variants.py's copy: every page staged and waited for,
      // no product run (a scale no call passes, so ptxas keeps the code)
      if (slot_pg[s] >= 0 && g.scale == -12345.f) {
#else
      if (slot_pg[s] >= 0) {
#endif
        const int base = (e0 + i) * ps;
        const int nc = min(ps, last - base + 1);  // rows some query row sees
        const float* ks = ring + (size_t)s * 2 * page;
        const float* vs = ks + page;
        // 1. logits: the lane's partial dot products of its row with the
        //    page's keys over its columns
        float sc[HOP_KEYS];
#pragma unroll
        for (int c = 0; c < HOP_KEYS; ++c) sc[c] = 0.f;
#pragma unroll
        for (int u = 0; u < NV; ++u) {
          const int col = 4 * (l16 + 16 * u);
          if (col < D) {
            const float4 qv =
                *reinterpret_cast<const float4*>(q_s + (size_t)r * D + col);
#pragma unroll
            for (int c = 0; c < HOP_KEYS; ++c)
              if (c < nc)
                sc[c] = dot4(qv, *reinterpret_cast<const float4*>(
                                     ks + (size_t)c * D + col), sc[c]);
          }
        }
        // 2. the reduce-scatter leaves lane l key l's logit; the row's
        //    online-softmax update over the page's visible keys
        fold16<8>(sc, lane);
        fold16<4>(sc, lane);
        fold16<2>(sc, lane);
        fold16<1>(sc, lane);
        const bool see = l16 < nc && base + l16 <= qp;
        const float x = see ? sc[0] : NEG;
        const float m_new = fmaxf(m, half_max(x));
        const float p = see ? expf(x - m_new) : 0.f;
        const float alpha = expf(m - m_new);
        l = alpha * l + half_sum(p);
        m = m_new;
#pragma unroll
        for (int u = 0; u < NV; ++u) {
          acc[u].x *= alpha;
          acc[u].y *= alpha;
          acc[u].z *= alpha;
          acc[u].w *= alpha;
        }
        // 3. acc += p . V, key by key, each key's p broadcast from its
        //    lane; a zero p (masked or underflowed) multiplies nothing, so
        //    NaN in unwritten rows cannot leak
#pragma unroll
        for (int c = 0; c < HOP_KEYS; ++c) {
          if (c < nc) {
            const float pc = __shfl_sync(0xffffffffu, p, (lane & 16) | c);
#pragma unroll
            for (int u = 0; u < NV; ++u) {
              const int col = 4 * (l16 + 16 * u);
              if (col < D && pc != 0.f)
                axpy4(pc, *reinterpret_cast<const float4*>(
                              vs + (size_t)c * D + col), acc[u]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(hopper::smem_u32(empty + s));
    }
  }

  // the groups' merge: groups 1.. leave (acc, m, l) in the ring, group 0
  // takes acc = sum_g w_g acc_g, l = sum_g w_g l_g, w_g = exp(m_g -
  // max_g m_g), in group order (the combine_splits formula)
  if (pl.groups > 1) {
    __syncthreads();                          // every page is read
    float* gacc = ring;                       // (groups - 1) x rtb x D
    float* gm = ring + (size_t)(pl.groups - 1) * rtb * D;   // x rtb
    float* gl = gm + (pl.groups - 1) * rtb;
    if (warp > 0 && grp > 0) {
      const size_t at = (size_t)(grp - 1) * rtb + r;
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        const int col = 4 * (l16 + 16 * u);
        if (col < D)
          *reinterpret_cast<float4*>(gacc + at * D + col) = acc[u];
      }
      if (l16 == 0) {
        gm[at] = m;
        gl[at] = l;
      }
    }
    __syncthreads();
    if (warp > 0 && grp == 0) {
      float ms = m;
      for (int k = 1; k < pl.groups; ++k)
        ms = fmaxf(ms, gm[(k - 1) * rtb + r]);
      const float w0 = expf(m - ms);
      l = w0 * l;
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        acc[u].x *= w0;
        acc[u].y *= w0;
        acc[u].z *= w0;
        acc[u].w *= w0;
      }
      for (int k = 1; k < pl.groups; ++k) {
        const size_t at = (size_t)(k - 1) * rtb + r;
        const float w = expf(gm[at] - ms);
        l += w * gl[at];
#pragma unroll
        for (int u = 0; u < NV; ++u) {
          const int col = 4 * (l16 + 16 * u);
          if (col < D) {
            const float4 a =
                *reinterpret_cast<const float4*>(gacc + at * D + col);
            acc[u].x += w * a.x;
            acc[u].y += w * a.y;
            acc[u].z += w * a.z;
            acc[u].w += w * a.w;
          }
        }
      }
      m = ms;
    }
  }
  const bool mine = warp > 0 && grp == 0 && r < nr;   // group 0 writes

  if (gridDim.x == 1) {              // one block of pages: normalise in place
    if (mine) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        const int col = 4 * (l16 + 16 * u);
        if (col < D)
          store4(out, (orow + r) * D + col,
                 make_float4(acc[u].x * inv, acc[u].y * inv, acc[u].z * inv,
                             acc[u].w * inv),
                 g.q_bf16);
      }
    }
    return;
  }

  // this block's raw partial (a row that saw nothing: acc 0, m -1e30,
  // l 0), then the ticket
  const int blocks = gridDim.x;
  const size_t nrows = (size_t)g.B * g.Hkv * g.rows;
  if (mine) {
    const size_t prow = (size_t)chunk * nrows + orow + r;
    if (l16 == 0) {
      part.m[prow] = m;
      part.l[prow] = l;
    }
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int col = 4 * (l16 + 16 * u);
      if (col < D)
        *reinterpret_cast<float4*>(part.acc + prow * D + col) = acc[u];
    }
  }
  __threadfence();
  __syncthreads();
  const unsigned ticket = blockIdx.z * gridDim.y + tile;
  if (threadIdx.x == 0)
    *last_flag = atomicAdd(part.tickets + ticket, 1u) == (unsigned)(blocks - 1);
  __syncthreads();
  if (!*last_flag) return;
  __threadfence();

  // out = sum_c w_c acc_c / max(sum_c w_c l_c, 1e-30), w_c = exp(m_c -
  // max_c m_c), summed in block order: the combine_splits formula (a block
  // that saw nothing has acc 0 and l 0); partials read past L1, four
  // blocks' loads in flight at once
  float* wts = q_s;                            // blocks x rtb
  float* lsum = q_s + (size_t)blocks * rtb;    // rtb
  if (threadIdx.x < nr) {
    const int row = threadIdx.x;
    const float* mr = part.m + orow + row;
    const float* lr = part.l + orow + row;
    float ms = NEG;
#pragma unroll 4
    for (int c = 0; c < blocks; ++c)
      ms = fmaxf(ms, __ldcg(mr + (size_t)c * nrows));
    float ls = 0.f;
#pragma unroll 4
    for (int c = 0; c < blocks; ++c) {
      const float w = expf(__ldcg(mr + (size_t)c * nrows) - ms);
      ls += w * __ldcg(lr + (size_t)c * nrows);
      wts[c * rtb + row] = w;
    }
    lsum[row] = ls;
  }
  __syncthreads();
  const int d4 = D / 4;
  for (int i = threadIdx.x; i < nr * d4; i += blockDim.x) {
    const int row = i / d4, col = 4 * (i % d4);
    const float* ar = part.acc + (orow + row) * D + col;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int c = 0; c < blocks; ++c) {
      const float w = wts[c * rtb + row];
      const float4 x =
          __ldcg(reinterpret_cast<const float4*>(ar + (size_t)c * nrows * D));
      a.x = fmaf(w, x.x, a.x);
      a.y = fmaf(w, x.y, a.y);
      a.z = fmaf(w, x.z, a.z);
      a.w = fmaf(w, x.w, a.w);
    }
    const float inv = 1.f / fmaxf(lsum[row], 1e-30f);
    store4(out, (orow + row) * D + col,
           make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv), g.q_bf16);
  }
  if (threadIdx.x == 0) part.tickets[ticket] = 0u;
}

template <int NV>
cudaError_t hop_launch(const dim3& grid, int threads, size_t bytes,
                       cudaStream_t s, const Geometry& g, const HopPlan& pl,
                       void* out, const Partials& part) {
  cudaError_t err = prepare(paged_hopper_kernel<NV>, bytes);
  if (err == cudaSuccess)
    paged_hopper_kernel<NV><<<grid, threads, bytes, s>>>(g, pl, out, part);
  return err;
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

// The Hopper kernel.  D % 4 == 0, 4 <= D <= 256, 1 <= ps <= 16, the pages
// 16-byte aligned; rw 1-8 warps a group (rows of a block: 2 * rw), groups
// of them walking a block's pages round-robin (1 + groups * rw <= 17
// warps), 1-8 stages, a multiple of groups: then a slot is only ever read
// by one group, which waits for its phases in order (a group waiting on a
// slot for a phase two ahead of the slot's would pass its parity wait at
// once).  span: table entries per reference partition (split
// of them); per: entries a block walks; cpp: blocks per partition.  One
// block of pages (split * cpp == 1) writes the output directly and takes
// no scratch; more need acc (split * cpp, B, Hkv, rows, D), m and l
// (split * cpp, B, Hkv, rows) f32 and tickets (B * Hkv * row tiles, zero;
// left zero).
extern "C" int paged_attention_hopper_launch(
    const void* q, const void* k_pages, const void* v_pages, const void* bt,
    const void* qpos, void* out, void* acc, void* m, void* l, void* tickets,
    int B, int Hkv, int rows, int D, int S, int ps, int P, int NP, int span,
    int split, int per, int cpp, int groups, int rw, int stages, float scale,
    int q_bf16, void* stream) {
  const int chunks = split * cpp;
  const int rtb = 2 * rw;
  if (D % 4 != 0 || D < 4 || D > 256 || rows < 1 || ps < 1 ||
      ps > HOP_KEYS || split < 1 || span < 1 || per < 1 || cpp < 1 ||
      rw < 1 || rw > HOP_ROW_WARPS || groups < 1 ||
      1 + groups * rw > HOP_MAX_WARPS || stages < 1 ||
      stages > HOP_MAX_STAGES || stages % groups != 0 ||
      (reinterpret_cast<uintptr_t>(k_pages) |
       reinterpret_cast<uintptr_t>(v_pages)) % 16 != 0 ||
      (chunks > 1 && (!acc || !m || !l || !tickets)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = hop_smem_bytes(rtb, D, ps, stages);
  // the groups' states fit the ring, the merge's weights and sums behind
  // the header
  if (bytes > 232448 ||
      (size_t)(groups - 1) * rtb * (D + 2) > (size_t)stages * 2 * ps * D ||
      (chunks > 1 && (size_t)(chunks + 1) * rtb * 4 > bytes - HOP_HEADER))
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
  const HopPlan pl = {per, cpp, stages, groups, rw};
  const dim3 grid(chunks, (rows + rtb - 1) / rtb, B * Hkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 32 * (1 + groups * rw);
  cudaError_t err;
  if (D <= 64)
    err = hop_launch<1>(grid, threads, bytes, s, g, pl, out, part);
  else if (D <= 128)
    err = hop_launch<2>(grid, threads, bytes, s, g, pl, out, part);
  else
    err = hop_launch<4>(grid, threads, bytes, s, g, pl, out, part);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
