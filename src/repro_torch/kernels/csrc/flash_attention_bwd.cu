// The backward of cache-free flash attention (FA2 shape), for Hopper
// (sm_90a): bf16 products on the tensor cores, f32 on the CUDA cores.
//
// Replaces: no Pallas kernel.  The reference trains through XLA's autodiff
// of its einsum / chunked attention (src/repro/nn/attention.py:441-449);
// the port's training forward runs the hand-written flash_attention kernel
// (flash_attention.cu), whose gradient this is.  Same contract as that
// forward: q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), Hq % Hkv == 0, query
// head h reads KV head h / (Hq / Hkv), the queries the last Sq positions of
// the context (q_off = Skv - Sq), causal or not, D <= 256, f32 or bf16 in
// and out (all alike), f32 softmax and accumulation.  From the forward's
// output o and its rows' natural log-sum-exp lse (B, Hq, Sq) f32 and the
// output gradient do:
//   delta_i = rowsum(do * o)                       (flash_bwd_delta_kernel)
//   s = (q * scale) . k,  p = exp(s - lse_i), 0 where masked (kpos >= Skv,
//   or causal and q_off + i < kpos)
//   dp = do . v,  ds = p * (dp - delta_i)
//   dv = sum_i p^T do,  dk = sum_i ds^T (q * scale),  dq = scale * ds . k
// A row that sees no key has lse = -inf and every p masked, so its
// gradient is 0, never NaN.  The plain version is
// repro_torch.kernels.ref.flash_attention_bwd_plain.
//
// What bounds it on the H100: operations.  Five products of pairs x D per
// query head (10 * pairs * D flops) against 4 * (Sq + Skv) * D elements
// moved: gemma-2b's training shape (S 256, D 256) does ~280 flops a byte,
// at the bf16 ridge (~295), the whisper encoder's (S 1500, D 64) ~800.
// So the products go to the tensor cores (989 TFLOP/s bf16, against 67
// TFLOP/s of f32 on the CUDA cores), and the grid has to fill 132 SMs.
//
// One launch, deterministic (every sum runs in a fixed order, no block
// adds into another's output, two launches give the same bits):
//  * flash_bwd_delta_kernel: a warp per query row, 16-byte loads, a fixed
//    shuffle tree;
//  * dk/dv blocks, one per (KV tile, block of the tile's work, column
//    chunk, KV head, batch).  A KV tile's work is its items, (query head
//    of the group, 32-row Q step that can see the tile: causal, from the
//    one holding the first row at or past the tile's first key),
//    head-major.  A block runs `per` consecutive items (struct Walk), so a
//    tile with more items (causal: the first) takes more blocks, and MQA
//    and GQA shapes with few KV tiles still fill the card; the wrapper's
//    plan (kernels/flash_attention.flash_bwd_plan) picks `per` from the
//    shape and the SM count: bf16 the most items that still give the SMs
//    1.2 dk/dv blocks each (gemma-2b at B 8: 21, tiles of 4, 3, 2 and 1
//    blocks), f32 the fewest that keep its grid within 2 blocks an SM.
//    With one block a tile the block writes dk and dv; else every block
//    writes its f32 partial sums into a workspace ws[2][ns][B][Hkv][Skv][D]
//    (ns the most blocks of a tile; the wrapper's torch.empty), and
//    flash_bwd_reduce_kernel sums a row's partials in block order and
//    casts them;
//  * dq blocks, one per (Q tile, query head, batch), walking the KV steps
//    that the tile can see and recomputing p and ds.
//
// bf16 (flash_bwd_bf16_kernel: the dq and dk/dv blocks in one grid,
// longest first, so that dk/dv blocks fill the SMs that dq leaves free;
// 4 warps a block, two blocks an SM):
//  * products on the tensor cores: mma.sync m16n8k16 (bf16 in, f32
//    accumulator) with ldmatrix operand loads from shared memory.  dk/dv:
//    a 64-row KV tile, each warp 16 of its rows as the products' M;
//    S^T = K . Q^T and dP^T = V . dO^T land in accumulator fragments, so
//    P^T and dS^T are A operands from registers for dv += P^T . dO and
//    dk += dS^T . Q.  dq: a 32-row Q tile, S = Q . K^T and dP = dO . V^T
//    with a warp's 16 query rows as M, then dq += dS . K; the two warp
//    pairs walk alternate 32-row KV steps and join at the end.  q, k, v
//    and do enter exactly (bf16); the scale multiplies S after Q . K^T, and
//    dk and dq after their sums.  (wgmma m64n32k16 for S and dP, issued
//    and waited each step, gave the same bits and was slower at every
//    case: PERF.md);
//  * p = 2^(s * scale * log2(e) - lse * log2(e)) on the MUFU (ex2.approx),
//    a few f32 ulps from the plain version's exp(s - lse);
//  * p and ds enter their products as three bf16 terms, hi = bf16(x),
//    mi = bf16(x - hi), lo = bf16(x - hi - mi): hi + mi + lo = x, all 24
//    bits, so the tensor cores multiply the plain version's f32 p and ds.
//    Rounding them to bf16 moves dq, dk, dv by ~2.6e-3 relative L2; two
//    terms (16 bits) read ~1e-4, at the bf16 gate (chip_bwd_variants.py);
//  * tensor-core f32 accumulation truncates, so no sum runs in one
//    accumulator across steps: each step's product sums in a fresh
//    accumulator (over its 32 rows and the three terms) and joins dk, dv
//    or dq with round-to-nearest (without: up to 1.64e-4, over the gate);
//  * registers: a warp's dk and dv are 16 rows x the chunk's columns, DC
//    floats a thread.  Above D 64 the columns are cut into two chunks (64,
//    96 or 128), two blocks that each recompute S^T and dP^T over the
//    whole D, so that no instance holds more than 128 accumulator floats a
//    thread; dq holds D / 2 (128 at D 256);
//  * Q / dO steps (dk/dv) and 64-row K / V steps (dq) go through a ring in
//    shared memory by 16-byte cp.async, 2 stages (1 at D 256 for dk/dv,
//    above D 128 for dq, so that two blocks share an SM), the next step
//    loading while this one computes; rows padded by 16 bytes so that
//    ldmatrix's 8 rows hit distinct banks; rows past Sq or Skv and columns
//    past D are zero-filled and never read from device memory.  A head dim
//    that is not a multiple of 8, or an unaligned operand, stages the same
//    tiles with plain loads.
//
// f32 (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel): exact f32 products on
// the CUDA cores (no TF32), so that the f32 lane keeps the plain version's
// numbers: 16 x 16 threads, 32-row tiles staged in shared memory as f32
// (Q times scale), each thread 2 x 2 pairs of a tile and 2 rows x DJ
// columns of the sums in registers.  The dk/dv kernel takes the same walk
// and workspace (32-row KV tiles, one column chunk).
//
// MLA's V, zero-padded by the caller to the q/k width, gets a dv whose
// padded columns are sums of do's padded columns, which the caller's slice
// leaves 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// The dk/dv walk of one shape (the wrapper's flash_bwd_plan): KV tile t
// (kv_rows keys) has items (query head of the group, 32-row Q step), the
// steps from the first that sees the tile (causal), head-major; a block
// runs `per` consecutive items, so tile t has splits(t) blocks
struct Walk {
  int group, sq, skv, causal, kv_rows, per;

  __host__ __device__ __forceinline__ int tiles() const {
    return (skv + kv_rows - 1) / kv_rows;
  }
  __host__ __device__ __forceinline__ int first(int t) const {
    const int r = causal ? t * kv_rows - (skv - sq) : 0;
    return (r > 0 ? r : 0) / 32;
  }
  __host__ __device__ __forceinline__ int per_head(int t) const {
    const int n = (sq + 31) / 32 - first(t);
    return n > 0 ? n : 0;
  }
  __host__ __device__ __forceinline__ int splits(int t) const {
    const int n = group * per_head(t);
    return n <= per ? 1 : (n + per - 1) / per;
  }
  // dk/dv block x of a (KV head, chunk, batch): its tile t and split s
  __host__ __device__ __forceinline__ void block(int x, int& t, int& s) const {
    t = 0;
    for (int n = splits(0); x >= n; n = splits(++t)) x -= n;
    s = x;
  }
};

// V: elements a lane loads at once// V: elements a lane loads at once (16 bytes, or 1 when a row is not
// 16-byte aligned)
template <typename T, int V>
__global__ void __launch_bounds__(256)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                           float* __restrict__ delta, long long rows, int d) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* orow = o + row * d;
  const T* drow = dout + row * d;
  float acc = 0.f;
  for (int c = lane * V; c < d; c += 32 * V) {
    alignas(16) T a[V], b[V];
    if constexpr (V > 1) {
      *reinterpret_cast<uint4*>(a) = *reinterpret_cast<const uint4*>(drow + c);
      *reinterpret_cast<uint4*>(b) = *reinterpret_cast<const uint4*>(orow + c);
    } else {
      a[0] = drow[c];
      b[0] = orow[c];
    }
#pragma unroll
    for (int e = 0; e < V; ++e) acc = fmaf(to_f(a[e]), to_f(b[e]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) delta[row] = acc;
}

// dk = mul_k * sum_s ws[0][s], dv = sum_s ws[1][s] over the row's tile's
// splits, in order; blockIdx.y picks dk (0) or dv (1).  ws holds ns
// partials of n = B * Hkv * Skv * D floats each
template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_reduce_kernel(const float* __restrict__ ws, T* __restrict__ dk,
                            T* __restrict__ dv, long long n, int ns, int d,
                            Walk w, float mul_k) {
  const float* src = ws + (size_t)blockIdx.y * ns * n;
  T* dst = blockIdx.y ? dv : dk;
  const float mul = blockIdx.y ? 1.f : mul_k;
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < n;
       i += (long long)gridDim.x * 256) {
    const int row = (int)((i / d) % w.skv);
    const int nt = w.splits(row / w.kv_rows);
    float acc = src[i];
    for (int s = 1; s < nt; ++s) acc = __fadd_rn(acc, src[s * n + i]);
    put(dst + i, __fmul_rn(acc, mul));
  }
}

// -- f32: CUDA cores --------------------------------------------------------
namespace cc {

constexpr int BQ = 32;        // query rows per tile
constexpr int BK = 32;        // key rows per tile
constexpr int TY = 16, TX = 16;
constexpr int THREADS = TY * TX;
constexpr int RI = BQ / TY;   // tile rows per thread (2)
constexpr int CJ = BK / TX;   // tile columns per thread (2)
constexpr int LDP = BK + 1;   // p / ds rows

// shared floats of one block: four tiles of 32 rows x (16 DJ + 1), p and
// ds tiles, lse and delta of the Q tile
__host__ __device__ inline size_t smem_floats(int dj) {
  return (size_t)4 * 32 * (16 * dj + 1) + 2 * (size_t)BQ * LDP + 2 * BQ;
}

// rows [row0, row0 + 32) of a (nrows, d) slab into a 32 x ld f32 tile,
// times mul; rows past nrows and columns past d are 0 (never read)
__device__ __forceinline__ void stage(float* dst, const float* src, int row0,
                                      int nrows, int d, int ld, float mul) {
  for (int i = threadIdx.x; i < 32 * (ld - 1); i += THREADS) {
    const int r = i / (ld - 1), c = i - r * (ld - 1);
    float x = 0.f;
    if (row0 + r < nrows && c < d)
      x = __fmul_rn(src[(size_t)(row0 + r) * d + c], mul);
    dst[r * ld + c] = x;
  }
}

// s = qs . ks^T and dp = dos . vs^T for the thread's 2 x 2 pairs, then
// p = exp(s - lse), ds = p * (dp - delta), masked pairs 0; rows i = ty +
// 16 ri of the Q tile (q0), columns j = tx + 16 cj of the KV tile (k0)
__device__ __forceinline__ void tile_p_ds(const float* qs, const float* dos,
                                          const float* ks, const float* vs,
                                          const float* lse_s,
                                          const float* del_s, int ld, int d,
                                          int q0, int k0, int sq, int skv,
                                          int q_off, int causal,
                                          float (&p)[RI][CJ],
                                          float (&ds)[RI][CJ]) {
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  float s[RI][CJ], dp[RI][CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int c = 0; c < d; ++c) {
    float a[RI], g[RI], b[CJ], w[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      a[i] = qs[(ty + TY * i) * ld + c];
      g[i] = dos[(ty + TY * i) * ld + c];
    }
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      b[j] = ks[(tx + TX * j) * ld + c];
      w[j] = vs[(tx + TX * j) * ld + c];
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + TY * i;
    const int qpos = q_off + q0 + r;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int kpos = k0 + tx + TX * j;
      const bool ok =
          q0 + r < sq && kpos < skv && (!causal || qpos >= kpos);
      const float pij = ok ? expf(__fsub_rn(s[i][j], lse_s[r])) : 0.f;
      p[i][j] = pij;
      ds[i][j] = __fmul_rn(pij, __fsub_rn(dp[i][j], del_s[r]));
    }
  }
}

// lse and delta of the Q tile at q0 into shared memory (0 past Sq)
__device__ __forceinline__ void stage_rows(float* lse_s, float* del_s,
                                           const float* lse,
                                           const float* delta, size_t base,
                                           int q0, int sq) {
  if (threadIdx.x < BQ) {
    const int r = q0 + threadIdx.x;
    lse_s[threadIdx.x] = r < sq ? lse[base + r] : 0.f;
    del_s[threadIdx.x] = r < sq ? delta[base + r] : 0.f;
  }
}

// grid (the walk's blocks, Hkv, B); ws null: write dk, dv; else the
// block's partials into ws (ns of them)
template <int DJ>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          float* __restrict__ ws, int ns, int nb, int hq,
                          int d, float scale, Walk w) {
  extern __shared__ float smem[];
  const int group = w.group, sq = w.sq, skv = w.skv, causal = w.causal;
  constexpr int LD = 16 * DJ + 1;
  float* ks = smem;
  float* vs = ks + 32 * LD;
  float* qs = vs + 32 * LD;
  float* dos = qs + 32 * LD;
  float* ps = dos + 32 * LD;
  float* dss = ps + BQ * LDP;
  float* lse_s = dss + BQ * LDP;
  float* del_s = lse_s + BQ;

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  int kvt, split;
  w.block(blockIdx.x, kvt, split);
  const int hk = blockIdx.y, bb = blockIdx.z;
  const int k0 = kvt * BK;
  const int hkv = hq / group;
  const int q_off = skv - sq;
  const size_t kbase = ((size_t)bb * hkv + hk) * skv * d;
  stage(ks, k + kbase, k0, skv, d, LD, 1.f);
  stage(vs, v + kbase, k0, skv, d, LD, 1.f);

  float acc_k[RI][DJ], acc_v[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // causal: Q rows before k0 - q_off see no key of this tile
  const int first = w.first(kvt), per_head = w.per_head(kvt);
  const int i0 = split * w.per;
  const int i1 = min(i0 + w.per, group * per_head);
  for (int it = i0; it < i1; ++it) {
    const int h = hk * group + it / per_head;
    const int q0 = (first + it % per_head) * BQ;
    const size_t rbase = ((size_t)bb * hq + h) * sq;
    __syncthreads();                 // previous Q tile fully consumed
    stage(qs, q + rbase * d, q0, sq, d, LD, scale);
    stage(dos, dout + rbase * d, q0, sq, d, LD, 1.f);
    stage_rows(lse_s, del_s, lse, delta, rbase, q0, sq);
    __syncthreads();
    float p[RI][CJ], ds[RI][CJ];
    tile_p_ds(qs, dos, ks, vs, lse_s, del_s, LD, d, q0, k0, sq, skv, q_off,
              causal, p, ds);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        ps[(ty + TY * i) * LDP + tx + TX * j] = p[i][j];
        dss[(ty + TY * i) * LDP + tx + TX * j] = ds[i][j];
      }
    __syncthreads();
    // dv[j, c] += p[i, j] do[i, c]; dk[j, c] += ds[i, j] qs[i, c] for the
    // thread's key rows j = ty + 16 jr and columns c = tx + 16 jj
    for (int i = 0; i < BQ; ++i) {
      float pj[RI], dj[RI], gv[DJ], qv[DJ];
#pragma unroll
      for (int jr = 0; jr < RI; ++jr) {
        pj[jr] = ps[i * LDP + ty + TY * jr];
        dj[jr] = dss[i * LDP + ty + TY * jr];
      }
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        gv[jj] = dos[i * LD + tx + TX * jj];
        qv[jj] = qs[i * LD + tx + TX * jj];
      }
#pragma unroll
      for (int jr = 0; jr < RI; ++jr)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          acc_v[jr][jj] = fmaf(pj[jr], gv[jj], acc_v[jr][jj]);
          acc_k[jr][jj] = fmaf(dj[jr], qv[jj], acc_k[jr][jj]);
        }
    }
  }

  float* out_k = dk + kbase;
  float* out_v = dv + kbase;
  if (ws != nullptr) {
    const size_t n = (size_t)nb * hkv * skv * d;
    out_k = ws + split * n + kbase;
    out_v = ws + (ns + split) * n + kbase;
  }
#pragma unroll
  for (int jr = 0; jr < RI; ++jr) {
    const int row = k0 + ty + TY * jr;
    if (row >= skv) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int c = tx + TX * jj;
      if (c >= d) continue;
      out_k[(size_t)row * d + c] = acc_k[jr][jj];
      out_v[(size_t)row * d + c] = acc_v[jr][jj];
    }
  }
}

template <int DJ>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int hq, int group, int sq,
                        int skv, int d, float scale, int causal) {
  extern __shared__ float smem[];
  constexpr int LD = 16 * DJ + 1;
  float* ks = smem;
  float* vs = ks + 32 * LD;
  float* qs = vs + 32 * LD;
  float* dos = qs + 32 * LD;
  float* dss = dos + 32 * LD + BQ * LDP;
  float* lse_s = dss + BQ * LDP;
  float* del_s = lse_s + BQ;

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, bb = blockIdx.z;
  const int hkv = hq / group;
  const int q_off = skv - sq;
  const size_t rbase = ((size_t)bb * hq + h) * sq;
  const size_t kbase = ((size_t)bb * hkv + h / group) * skv * d;
  stage(qs, q + rbase * d, q0, sq, d, LD, scale);
  stage(dos, dout + rbase * d, q0, sq, d, LD, 1.f);
  stage_rows(lse_s, del_s, lse, delta, rbase, q0, sq);

  float acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // causal: keys at or past kv_end are invisible to every row of the tile
  const int q_hi = min(q0 + BQ, sq);
  int kv_end = causal ? min(skv, q_off + q_hi) : skv;
  if (kv_end < 0) kv_end = 0;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();                   // previous KV tile fully consumed
    stage(ks, k + kbase, k0, skv, d, LD, 1.f);
    stage(vs, v + kbase, k0, skv, d, LD, 1.f);
    __syncthreads();
    float p[RI][CJ], ds[RI][CJ];
    tile_p_ds(qs, dos, ks, vs, lse_s, del_s, LD, d, q0, k0, sq, skv, q_off,
              causal, p, ds);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        dss[(ty + TY * i) * LDP + tx + TX * j] = ds[i][j];
    __syncthreads();
    // dq[i, c] += ds[i, j] k[j, c] for rows i = ty + 16 ri, c = tx + 16 jj
    for (int j = 0; j < BK; ++j) {
      float di[RI], kv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) di[i] = dss[(ty + TY * i) * LDP + j];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) kv[jj] = ks[j * LD + tx + TX * jj];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj)
          acc[i][jj] = fmaf(di[i], kv[jj], acc[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty + TY * i;
    if (r >= sq) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int c = tx + TX * jj;
      if (c >= d) continue;
      dq[(rbase + r) * d + c] = __fmul_rn(acc[i][jj], scale);
    }
  }
}

}  // namespace cc

// -- bf16: tensor cores -----------------------------------------------------
namespace tc {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BKV = 64;       // dk/dv: KV rows per block, 16 per warp
constexpr int BQS = 32;       // dk/dv: Q rows per step
constexpr int BQ = 32;        // dq: Q rows per block, 16 per warp pair
constexpr int BKS = 32;       // dq: KV rows per step
constexpr int TERMS = 3;      // bf16 terms of p and ds
constexpr bool FRESH_ACC = true;   // a step's products in fresh accumulators
constexpr float LOG2E = 1.4426950408889634f;

// ring stages: dk/dv one at D 256 (K, V and one Q / dO step), dq one
// above D 128 (Q, dO and one 64-row K / V step), so that two blocks share
// an SM; two below
template <int DP>
__host__ __device__ constexpr int stages_kv() {
  return DP > 192 ? 1 : 2;
}
template <int DP>
__host__ __device__ constexpr int stages_q() {
  return DP > 128 ? 1 : 2;
}

// shared bytes of the kernel, the larger of its block kinds' (rows of DP +
// 8 bf16): dk/dv 2 x 64 + 2 x stages x 32 rows and lse and delta of
// `stages` 32-row steps; dq 2 x 32 + 2 x stages x 64 rows
template <int DP>
constexpr size_t smem_bytes() {
  const size_t kv = (size_t)(2 * 64 + 2 * stages_kv<DP>() * 32) * (DP + 8) *
                        sizeof(bf16) +
                    stages_kv<DP>() * 64 * sizeof(float);
  const size_t dq = (size_t)(2 * 32 + 2 * stages_q<DP>() * 64) * (DP + 8) *
                    sizeof(bf16);
  return kv > dq ? kv : dq;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes < 16 zero-fills the rest (0: no read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

// 4 bytes global -> shared; bytes 0 writes 0 without reading
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a . b over one m16n8k16 tile: bf16 operands, f32 accumulator
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x (MUFU, ~2 ulp; flushes results below 2^-126 to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 values as TERMS bf16 pairs, t[0] = bf16(x), t[1] = bf16(x -
// t[0]), t[2] = bf16(x - t[0] - t[1]) (each difference exact): with three
// terms they sum to x, all 24 bits; the lower column in the low half, as
// the A fragment wants
__device__ __forceinline__ void split_terms(float x0, float x1,
                                            uint32_t (&t)[TERMS]) {
#pragma unroll
  for (int i = 0; i < TERMS; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    x0 = __fsub_rn(x0, hf.x);
    x1 = __fsub_rn(x1, hf.y);
    t[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
}

// the A operands of k16 steps kk (columns 16 kk .. 16 kk + 15) from a 16 x
// 32 accumulator tile x[4][4] (n8 tiles 2 kk and 2 kk + 1), as terms
__device__ __forceinline__ void a_terms(const float (&x)[4][4],
                                        uint32_t (&a)[2][TERMS][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    uint32_t t[4][TERMS];
    split_terms(x[2 * kk][0], x[2 * kk][1], t[0]);
    split_terms(x[2 * kk][2], x[2 * kk][3], t[1]);
    split_terms(x[2 * kk + 1][0], x[2 * kk + 1][1], t[2]);
    split_terms(x[2 * kk + 1][2], x[2 * kk + 1][3], t[3]);
#pragma unroll
    for (int i = 0; i < TERMS; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) a[kk][i][r] = t[r][i];
  }
}

// acc (NT n8 tiles: a chunk's columns) += a . B over a step's 32 rows, B
// from a row-major tile with its rows along K at b_addr (the chunk's
// first column, the lane's ldmatrix offset applied; rows of LD bf16).
// The step's sums run in fresh accumulators, G 16-column slices at a
// time (2 G independent mma chains), joined into acc with
// round-to-nearest: a tensor-core sum truncates toward zero, so no
// accumulator runs across steps
template <int LD, int GW, int NT>
__device__ __forceinline__ void step_product(float (&acc)[NT][4],
                                             const uint32_t (&a)[2][TERMS][4],
                                             uint32_t b_addr) {
  constexpr int NS = NT / 2;                      // 16-column slices
  constexpr int G = NS % GW == 0 ? GW : 2;
  static_assert(NS % G == 0, "slices per group");
#pragma unroll
  for (int g0 = 0; g0 < NS; g0 += G) {
    float c[G][2][4];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          c[g][u][e] = FRESH_ACC ? 0.f : acc[2 * (g0 + g) + u][e];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t b[G][4];
#pragma unroll
      for (int g = 0; g < G; ++g)
        ldsm_x4_trans(b[g], b_addr + ((g0 + g) * 16 + kk * 16 * LD) *
                                         (uint32_t)sizeof(bf16));
#pragma unroll
      for (int i = 0; i < TERMS; ++i)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          mma(c[g][0], a[kk][i], b[g][0], b[g][1]);
          mma(c[g][1], a[kk][i], b[g][2], b[g][3]);
        }
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[2 * (g0 + g) + u][e] =
              FRESH_ACC ? __fadd_rn(acc[2 * (g0 + g) + u][e], c[g][u][e])
                        : c[g][u][e];
  }
}

// p = exp(s * scale - lse), 0 where !ok, and ds = p * (dp - delta), in
// place of s and dp: the plain version's formulas (exact for a
// power-of-two scale, the logits' summation order aside)
__device__ __forceinline__ void p_ds(float& s, float& dp, float lse,
                                     float delta, float scale, bool ok) {
  const float p = ok ? ex2(fmaf(s, scale * LOG2E, -lse * LOG2E)) : 0.f;
  s = p;
  dp = __fmul_rn(p, __fsub_rn(dp, delta));
}

// rows [row0, row0 + ROWS) of a (nrows, d) slab into a ROWS x (DP + 8)
// shared tile; rows >= nrows and columns >= d are zero and never read.
// vec: 16-byte cp.async (d % 8 == 0, aligned slab); otherwise plain loads
template <int ROWS, int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int nrows, int d,
                                          bool vec) {
  constexpr int LD = DP + 8, CH = DP / 8;     // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const int row = row0 + r;
    bf16* o = dst + r * LD + c;
    if (vec) {
      const bool ok = row < nrows && c < d;
      cp_async16(smem_addr(o), ok ? src + (size_t)row * d + c : src,
                 ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o[e] = (row < nrows && c + e < d) ? src[(size_t)row * d + c + e]
                                          : __float2bfloat16_rn(0.f);
    }
  }
}

// one Q step of the dk/dv walk into a ring stage: 32 rows of q and do
// from row q0 of the head at rbase, and their lse and delta (0 past Sq,
// not read)
template <int DP>
__device__ __forceinline__ void load_q_step(bf16* qst, bf16* dost,
                                            float* rst, const bf16* q,
                                            const bf16* dout,
                                            const float* lse,
                                            const float* delta, size_t rbase,
                                            int q0, int sq, int d, bool vec) {
  load_tile<BQS, DP>(qst, q + rbase * d, q0, sq, d, vec);
  load_tile<BQS, DP>(dost, dout + rbase * d, q0, sq, d, vec);
  const int t = threadIdx.x;
  if (t < 64) {
    const int r = q0 + (t & 31);
    const bool ok = r < sq;
    const float* src = t < 32 ? lse : delta;
    cp_async4(smem_addr(rst + t), ok ? src + rbase + r : src, ok ? 4 : 0);
  }
}

// what a launch hands every block of the bf16 kernel
struct Args {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;
  bf16 *dq, *dk, *dv;
  float* ws;
  Walk w;
  int ns, nb, hq, d, vec;
  float scale;
  int nqt, nlong, wblocks, ychunks;
};

// dk/dv block (bx, by, bz) = (the walk's block, KV head * NC + chunk,
// batch).  Warp w owns KV rows k0 + 16 w .. + 15 and the chunk's columns
// [c0, c0 + DC) of dk, dv; ws null: write dk, dv; else the block's
// partials into ws (ns of them)
template <int DP, int DC>
__device__ __forceinline__ void dkdv_block(const Args a, int bx, int by,
                                           int bz) {
  const bf16 *q = a.q, *k = a.k, *v = a.v, *dout = a.dout;
  const float *lse = a.lse, *delta = a.delta;
  bf16 *dk = a.dk, *dv = a.dv;
  float* ws = a.ws;
  const Walk w = a.w;
  const int ns = a.ns, nb = a.nb, hq = a.hq, d = a.d;
  const float scale = a.scale;
  const bool vec = a.vec;
  const int group = w.group, sq = w.sq, skv = w.skv, causal = w.causal;
  constexpr int LD = DP + 8;
  constexpr int NC = DP / DC;
  constexpr int ST = stages_kv<DP>();
  constexpr int GK = DC > 64 ? 2 : 4;      // slices a group (registers)
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* ks = reinterpret_cast<bf16*>(tc_smem);      // BKV x LD
  bf16* vs = ks + BKV * LD;                           // BKV x LD
  bf16* qs = vs + BKV * LD;                           // ST x BQS x LD
  bf16* dos = qs + ST * BQS * LD;                     // ST x BQS x LD
  float* rs = reinterpret_cast<float*>(dos + ST * BQS * LD);  // ST x 64

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;   // fragment row, column pair
  int kvt, split;
  w.block(bx, kvt, split);
  const int chunk = by % NC, hk = by / NC, bb = bz;
  const int hkv = hq / group;
  const int k0 = kvt * BKV, c0 = chunk * DC;
  const int q_off = skv - sq;
  const size_t kbase = ((size_t)bb * hkv + hk) * skv * d;

  // the block's items: (query head of the group, Q step), head-major
  const int first = w.first(kvt), per_head = w.per_head(kvt);
  const int i0 = split * w.per;
  const int i1 = min(i0 + w.per, group * per_head);

  load_tile<BKV, DP>(ks, k + kbase, k0, skv, d, vec);
  load_tile<BKV, DP>(vs, v + kbase, k0, skv, d, vec);
  if (i0 < i1)
    load_q_step<DP>(qs, dos, rs, q, dout, lse, delta,
                    ((size_t)bb * hq + hk * group + i0 / per_head) * sq,
                    (first + i0 % per_head) * BQS, sq, d, vec);
  cp_async_commit();

  const int wrow = warp * 16;
  const int kr0 = k0 + wrow + g;            // KV row of fragment row g
  // ldmatrix lane offsets: A (16 rows x 16 columns of a row-major tile),
  // B with the tile's rows along N, B with the tile's rows along K
  const int a_off = (wrow + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                    8 * (lane >> 4);
  const int n_off = ((lane & 7) + 8 * (lane >> 4)) * LD +
                    8 * ((lane >> 3) & 1);
  const int k_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                    8 * (lane >> 4);

  float acc_k[DC / 8][4], acc_v[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int it = i0; it < i1; ++it) {
    const int st = ST == 1 ? 0 : (it - i0) & 1;
    const int nx = it + 1;
    if (ST == 2 && nx < i1) {           // the next step loads during this one
      load_q_step<DP>(qs + (st ^ 1) * BQS * LD, dos + (st ^ 1) * BQS * LD,
                      rs + (st ^ 1) * 64, q, dout, lse, delta,
                      ((size_t)bb * hq + hk * group + nx / per_head) * sq,
                      (first + nx % per_head) * BQS, sq, d, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      if (ST == 1 && it > i0) {
        load_q_step<DP>(qs, dos, rs, q, dout, lse, delta,
                        ((size_t)bb * hq + hk * group + it / per_head) * sq,
                        (first + it % per_head) * BQS, sq, d, vec);
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qt = qs + st * BQS * LD;
    const bf16* dot = dos + st * BQS * LD;
    const float* rt = rs + st * 64;
    const int q0 = (first + it % per_head) * BQS;

    // S^T = K . Q^T and dP^T = V . dO^T: 16 KV rows x 32 Q rows a warp
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t ak[4], av[4];
      ldsm_x4(ak, smem_addr(ks + a_off + kk * 16));
      ldsm_x4(av, smem_addr(vs + a_off + kk * 16));
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        uint32_t b[4];
        ldsm_x4(b, smem_addr(qt + n_off + nn * 16 * LD + kk * 16));
        mma(s[2 * nn], ak, b[0], b[1]);
        mma(s[2 * nn + 1], ak, b[2], b[3]);
        ldsm_x4(b, smem_addr(dot + n_off + nn * 16 * LD + kk * 16));
        mma(dp[2 * nn], av, b[0], b[1]);
        mma(dp[2 * nn + 1], av, b[2], b[3]);
      }
    }

    // P^T and dS^T: element (j, e) is KV row kr0 + 8 (e >> 1) and query
    // row q0 + c, c = 8 j + 2 t4 + (e & 1); masked only on a tile that
    // crosses Sq, Skv or the diagonal
    const bool edge = q0 + BQS > sq || k0 + wrow + 16 > skv ||
                      (causal && q_off + q0 < k0 + wrow + 15);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t4 + (e & 1);
        const int qr = q0 + c, kr = kr0 + 8 * (e >> 1);
        const bool ok = !edge || (qr < sq && kr < skv &&
                                  (!causal || q_off + qr >= kr));
        p_ds(s[j][e], dp[j][e], rt[c], rt[32 + c], scale, ok);
      }

    // dv += P^T . dO and dk += dS^T . Q over the chunk's columns: each
    // 16-column slice of the step sums in a fresh accumulator and joins
    // with round-to-nearest
    uint32_t pa[2][TERMS][4];
    a_terms(s, pa);
    step_product<LD, GK>(acc_v, pa, smem_addr(dot + k_off + c0));
    uint32_t da[2][TERMS][4];
    a_terms(dp, da);
    step_product<LD, GK>(acc_k, da, smem_addr(qt + k_off + c0));
    __syncthreads();                   // the stage is free for the next load
  }
  cp_async_wait<0>();                  // K / V alone, when no item is run

  // dk = scale * sum, dv = sum: cast into dk, dv, or f32 partials into ws
  const size_t n = (size_t)nb * hkv * skv * d;
  float* wk = ws == nullptr ? nullptr : ws + split * n + kbase;
  float* wv = ws == nullptr ? nullptr : ws + (ns + split) * n + kbase;
  const bool pairs = (d & 1) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = kr0 + 8 * i;
    if (row >= skv) continue;
#pragma unroll
    for (int nn = 0; nn < DC / 8; ++nn) {
      const int c = c0 + 8 * nn + 2 * t4;
      if (c >= d) continue;
      const size_t at = (size_t)row * d + c;
      const float xk0 = acc_k[nn][2 * i], xk1 = acc_k[nn][2 * i + 1];
      const float xv0 = acc_v[nn][2 * i], xv1 = acc_v[nn][2 * i + 1];
      if (ws != nullptr) {
        if (pairs) {
          *reinterpret_cast<float2*>(wk + at) = make_float2(xk0, xk1);
          *reinterpret_cast<float2*>(wv + at) = make_float2(xv0, xv1);
        } else {
          wk[at] = xk0;
          wv[at] = xv0;
          if (c + 1 < d) {
            wk[at + 1] = xk1;
            wv[at + 1] = xv1;
          }
        }
      } else {
        bf16* ok = dk + kbase + at;
        bf16* ov = dv + kbase + at;
        const bf16 yk0 = __float2bfloat16_rn(__fmul_rn(xk0, scale));
        const bf16 yk1 = __float2bfloat16_rn(__fmul_rn(xk1, scale));
        const bf16 yv0 = __float2bfloat16_rn(xv0);
        const bf16 yv1 = __float2bfloat16_rn(xv1);
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(ok) = __halves2bfloat162(yk0, yk1);
          *reinterpret_cast<__nv_bfloat162*>(ov) = __halves2bfloat162(yv0, yv1);
        } else {
          *ok = yk0;
          *ov = yv0;
          if (c + 1 < d) {
            ok[1] = yk1;
            ov[1] = yv1;
          }
        }
      }
    }
  }
}

// dq block (bx, by, bz) = (32-row Q tile from the last, query head,
// batch).  Warps 2 p + r own query rows q0 + 16 r .. + 15; the pairs walk
// alternate 32-row KV steps (pair p the steps 2 i + p), so a block's walk
// takes half as many iterations, and pair 1's sums join pair 0's in
// shared memory at the end (round-to-nearest, in that order)
template <int DP>
__device__ __forceinline__ void dq_block(const Args a, int bx, int by,
                                         int bz) {
  const bf16 *q = a.q, *k = a.k, *v = a.v, *dout = a.dout;
  const float *lse = a.lse, *delta = a.delta;
  const int hq = a.hq, d = a.d, group = a.w.group, sq = a.w.sq;
  const int skv = a.w.skv, causal = a.w.causal;
  const float scale = a.scale;
  const bool vec = a.vec;
  constexpr int LD = DP + 8;
  constexpr int ST = stages_q<DP>();
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);      // BQ x LD
  bf16* dos = qs + BQ * LD;                           // BQ x LD
  bf16* ks = dos + BQ * LD;                           // ST x 2 BKS x LD
  bf16* vs = ks + ST * 2 * BKS * LD;                  // ST x 2 BKS x LD

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int pair = warp >> 1, wrow = (warp & 1) * 16;
  // the last Q tiles (causal: the longest walks) first
  const int q0 = (a.nqt - 1 - bx) * BQ;
  const int h = by, bb = bz;
  const int hkv = hq / group;
  const int q_off = skv - sq;
  const size_t rbase = ((size_t)bb * hq + h) * sq;
  const size_t kbase = ((size_t)bb * hkv + h / group) * skv * d;
  // causal: K/V positions >= kv_end are invisible to every row of the tile
  const int q_hi = min(q0 + BQ, sq);
  int kv_end = causal ? min(skv, q_off + q_hi) : skv;
  if (kv_end < 0) kv_end = 0;
  const int nsteps = (kv_end + BKS - 1) / BKS;
  const int iters = (nsteps + 1) / 2;     // two KV steps an iteration

  load_tile<BQ, DP>(qs, q + rbase * d, q0, sq, d, vec);
  load_tile<BQ, DP>(dos, dout + rbase * d, q0, sq, d, vec);
  if (iters > 0) {
    load_tile<2 * BKS, DP>(ks, k + kbase, 0, kv_end, d, vec);
    load_tile<2 * BKS, DP>(vs, v + kbase, 0, kv_end, d, vec);
  }
  cp_async_commit();

  const int qr0 = q0 + wrow + g;            // query row of fragment row g
  float lse_r[2], del_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = qr0 + 8 * i;
    lse_r[i] = r < sq ? lse[rbase + r] : 0.f;
    del_r[i] = r < sq ? delta[rbase + r] : 0.f;
  }
  const int a_off = (wrow + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                    8 * (lane >> 4);
  const int n_off = ((lane & 7) + 8 * (lane >> 4)) * LD +
                    8 * ((lane >> 3) & 1);
  const int k_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                    8 * (lane >> 4);

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < iters; ++t) {
    const int st = ST == 1 ? 0 : t & 1;
    if (ST == 2 && t + 1 < iters) {
      load_tile<2 * BKS, DP>(ks + (st ^ 1) * 2 * BKS * LD, k + kbase,
                             (t + 1) * 2 * BKS, kv_end, d, vec);
      load_tile<2 * BKS, DP>(vs + (st ^ 1) * 2 * BKS * LD, v + kbase,
                             (t + 1) * 2 * BKS, kv_end, d, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      if (ST == 1 && t > 0) {
        load_tile<2 * BKS, DP>(ks, k + kbase, t * 2 * BKS, kv_end, d, vec);
        load_tile<2 * BKS, DP>(vs, v + kbase, t * 2 * BKS, kv_end, d, vec);
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k1 = (2 * t + pair) * BKS;      // the pair's KV step
    if (k1 < kv_end) {
      const bf16* kt = ks + (st * 2 + pair) * BKS * LD;
      const bf16* vt = vs + (st * 2 + pair) * BKS * LD;

      // S = Q . K^T and dP = dO . V^T: 16 query rows x 32 keys a warp
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t aq[4], ag[4];
        ldsm_x4(aq, smem_addr(qs + a_off + kk * 16));
        ldsm_x4(ag, smem_addr(dos + a_off + kk * 16));
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          uint32_t b[4];
          ldsm_x4(b, smem_addr(kt + n_off + nn * 16 * LD + kk * 16));
          mma(s[2 * nn], aq, b[0], b[1]);
          mma(s[2 * nn + 1], aq, b[2], b[3]);
          ldsm_x4(b, smem_addr(vt + n_off + nn * 16 * LD + kk * 16));
          mma(dp[2 * nn], ag, b[0], b[1]);
          mma(dp[2 * nn + 1], ag, b[2], b[3]);
        }
      }
      // P and dS: element (j, e) is query row qr0 + 8 (e >> 1) and key
      // k1 + 8 j + 2 t4 + (e & 1)
      const bool edge = q0 + wrow + 16 > sq || k1 + BKS > skv ||
                        (causal && q_off + q0 + wrow < k1 + BKS - 1);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qr = qr0 + 8 * (e >> 1);
          const int kr = k1 + 8 * j + 2 * t4 + (e & 1);
          const bool ok = !edge || (qr < sq && kr < skv &&
                                    (!causal || q_off + qr >= kr));
          p_ds(s[j][e], dp[j][e], lse_r[e >> 1], del_r[e >> 1], scale, ok);
        }

      // dq += dS . K
      uint32_t da[2][TERMS][4];
      a_terms(dp, da);
      step_product<LD, 4>(acc, da, smem_addr(kt + k_off));
    }
    __syncthreads();                   // the stage is free for the next load
  }
  cp_async_wait<0>();                  // Q, dO alone, when no key is seen

  // pair 1's sums into shared memory (the K / V ring, free now), lane-major
  // so that a warp's 32 floats of a register are 32 banks
  float* part = reinterpret_cast<float*>(ks);
  __syncthreads();
  if (pair == 1) {
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[((n * 4 + e) * 2 + (warp & 1)) * 32 + lane] = acc[n][e];
  }
  __syncthreads();
  if (pair == 1) return;

  const bool pairs = (d & 1) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = qr0 + 8 * i;
    if (r >= sq) continue;
    bf16* orow = a.dq + (rbase + r) * d;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = 8 * n + 2 * t4;
      if (c >= d) continue;
      float y[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = 2 * i + u;
        y[u] = __fmul_rn(
            __fadd_rn(acc[n][e],
                      part[((n * 4 + e) * 2 + (warp & 1)) * 32 + lane]),
            scale);
      }
      const bf16 y0 = __float2bfloat16_rn(y[0]);
      const bf16 y1 = __float2bfloat16_rn(y[1]);
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(orow + c) =
            __halves2bfloat162(y0, y1);
      } else {
        orow[c] = y0;
        if (c + 1 < d) orow[c + 1] = y1;
      }
    }
  }
}

// the bf16 backward's blocks, one grid, longest first (a block's work is
// its Q steps or KV steps, alike in cost): the dq blocks whose walk is at
// least a dk/dv block's items (causal: the last Q tiles), then the dk/dv
// blocks, then the other dq blocks
template <int DP, int DC>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_bf16_kernel(const Args a) {
  int x = blockIdx.x;
  const int longs = a.nlong * a.hq * a.nb;
  if (x < longs) {
    dq_block<DP>(a, x % a.nlong, (x / a.nlong) % a.hq, x / (a.nlong * a.hq));
    return;
  }
  x -= longs;
  const int kv = a.wblocks * a.ychunks * a.nb;
  if (x < kv) {
    dkdv_block<DP, DC>(a, x % a.wblocks, (x / a.wblocks) % a.ychunks,
                       x / (a.wblocks * a.ychunks));
    return;
  }
  x -= kv;
  const int rest = a.nqt - a.nlong;
  dq_block<DP>(a, a.nlong + x % rest, (x / rest) % a.hq, x / (rest * a.hq));
}

}  // namespace tc

// every kernel of the launch asks for the SM's largest shared-memory
// carveout, the one the dq / dk/dv kernels need, so that the SMs are not
// reconfigured (and drained) between the launch's kernels
template <typename K>
cudaError_t max_shared(K kern) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, float* delta,
                         long long rows, int d, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(o) | reinterpret_cast<uintptr_t>(dout);
  const unsigned blocks = (unsigned)((rows + 7) / 8);
  const bool vec = d % V == 0 && addr % 16 == 0;
  auto kern = vec ? flash_bwd_delta_kernel<T, V> : flash_bwd_delta_kernel<T, 1>;
  const cudaError_t err = max_shared(kern);
  if (err != cudaSuccess) return err;
  kern<<<blocks, 256, 0, s>>>(static_cast<const T*>(o),
                              static_cast<const T*>(dout), delta, rows, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_reduce(const float* ws, void* dk, void* dv, long long n,
                          int ns, int d, const Walk& w, float mul_k,
                          cudaStream_t s) {
  const long long want = (n + 255) / 256;
  const long long blocks = want < 4096 ? want : 4096;
  const cudaError_t err = max_shared(flash_bwd_reduce_kernel<T>);
  if (err != cudaSuccess) return err;
  flash_bwd_reduce_kernel<T><<<dim3((unsigned)blocks, 2), 256, 0, s>>>(
      ws, static_cast<T*>(dk), static_cast<T*>(dv), n, ns, d, w, mul_k);
  return cudaGetLastError();
}

// the walk's dk/dv blocks of a (KV head, chunk, batch) and the most splits
// of a tile
inline void walk_blocks(const Walk& w, int& blocks, int& ns) {
  blocks = ns = 0;
  for (int t = 0; t < w.tiles(); ++t) {
    const int n = w.splits(t);
    blocks += n;
    ns = n > ns ? n : ns;
  }
}

template <int DJ>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const float* lse, const void* dout, void* dq,
                       void* dk, void* dv, const float* delta, float* ws,
                       int b, int hq, int hkv, int sq, int skv, int d,
                       float scale, int causal, int per, cudaStream_t s) {
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  const size_t smem = cc::smem_floats(DJ) * sizeof(float);
  auto kv_kern = cc::flash_bwd_dkdv_kernel<DJ>;
  auto q_kern = cc::flash_bwd_dq_kernel<DJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = max_shared(kv_kern);
  if (err == cudaSuccess) err = max_shared(q_kern);
  if (err != cudaSuccess) return err;
  const int group = hq / hkv;
  const Walk w{group, sq, skv, causal, cc::BK, per};
  int blocks, ns;
  walk_blocks(w, blocks, ns);
  if ((ns > 1) != (ws != nullptr)) return cudaErrorInvalidValue;
  kv_kern<<<dim3(blocks, hkv, b), cc::THREADS, smem, s>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), ws, ns, b, hq, d, scale, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q_kern<<<dim3((sq + cc::BQ - 1) / cc::BQ, hq, b), cc::THREADS, smem, s>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<float*>(dq), hq, group, sq,
      skv, d, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess || ws == nullptr) return err;
  return launch_reduce<float>(ws, dk, dv, (long long)b * hkv * skv * d, ns,
                              d, w, 1.f, s);
}

template <int DP, int DC>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const float* lse, const void* dout, void* dq,
                        void* dk, void* dv, const float* delta, float* ws,
                        int b, int hq, int hkv, int sq, int skv, int d,
                        float scale, int causal, int per, cudaStream_t s) {
  const size_t smem = tc::smem_bytes<DP>();
  auto kern = tc::flash_bwd_bf16_kernel<DP, DC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = max_shared(kern);
  if (err != cudaSuccess) return err;
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout);
  tc::Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = lse;
  a.delta = delta;
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.ws = ws;
  a.w = Walk{hq / hkv, sq, skv, causal, tc::BKV, per};
  walk_blocks(a.w, a.wblocks, a.ns);
  if ((a.ns > 1) != (ws != nullptr)) return cudaErrorInvalidValue;
  a.nb = b;
  a.hq = hq;
  a.d = d;
  a.vec = d % 8 == 0 && addr % 16 == 0;
  a.scale = scale;
  a.nqt = (sq + tc::BQ - 1) / tc::BQ;
  a.nlong = 0;                      // dq tiles, from the last, of >= per steps
  while (a.nlong < a.nqt) {
    const int top = (a.nqt - a.nlong) * tc::BQ;   // the tile's end row
    const int hi = top < sq ? top : sq;
    const int end = causal ? skv - sq + hi : skv;
    const int keys = end < skv ? end : skv;
    const int steps = keys > 0 ? (keys + tc::BKS - 1) / tc::BKS : 0;
    if ((steps + 1) / 2 < per) break;     // two KV steps an iteration
    ++a.nlong;
  }
  a.ychunks = hkv * (DP / DC);
  const long long blocks = (long long)a.nqt * hq * b +
                           (long long)a.wblocks * a.ychunks * b;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, tc::THREADS, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || ws == nullptr) return err;
  return launch_reduce<bf16>(ws, dk, dv, (long long)b * hkv * skv * d, a.ns,
                             d, a.w, scale, s);
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, o, dout, dq (b, hq, sq, d); k, v, dk, dv (b, hkv, skv, d); lse and
// delta (b, hq, sq) f32 (delta is scratch the launch writes); all
// contiguous, all bf16 (is_bf16) or all f32.  per: the plan's (query head,
// Q step) items per dk/dv block; when a KV tile takes more than one block,
// ws is f32 scratch of 2 * ns * b * hkv * skv * d floats (ns the most
// blocks of a tile), else null.  Kernels on the stream: delta, dk/dv, dq,
// and with ws the reduction.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, void* ws, int b, int hq, int hkv, int sq, int skv, int d,
    float scale, int causal, int is_bf16, int per, void* stream) {
  if (d < 1 || d > 256 || hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1 ||
      b < 1 || hq > 65535 || b > 65535 || hkv * 2 > 65535 || per < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* w = static_cast<float*>(ws);
  const long long rows = (long long)b * hq * sq;
  cudaError_t err =
      is_bf16 ? launch_delta<bf16>(o, dout, dl, rows, d, s)
              : launch_delta<float>(o, dout, dl, rows, d, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!is_bf16)
    err = d <= 64 ? launch_f32<4>(q, k, v, l, dout, dq, dk, dv, dl, w, b, hq,
                                  hkv, sq, skv, d, scale, causal, per, s)
        : d <= 128
            ? launch_f32<8>(q, k, v, l, dout, dq, dk, dv, dl, w, b, hq, hkv,
                            sq, skv, d, scale, causal, per, s)
        : d <= 192
            ? launch_f32<12>(q, k, v, l, dout, dq, dk, dv, dl, w, b, hq, hkv,
                             sq, skv, d, scale, causal, per, s)
            : launch_f32<16>(q, k, v, l, dout, dq, dk, dv, dl, w, b, hq, hkv,
                             sq, skv, d, scale, causal, per, s);
  else if (d <= 64)
    err = launch_bf16<64, 64>(q, k, v, l, dout, dq, dk, dv, dl, w, b, hq, hkv,
                              sq, skv, d, scale, causal, per, s);
  else if (d <= 128)
    err = launch_bf16<128, 64>(q, k, v, l, dout, dq, dk, dv, dl, w, b, hq,
                                hkv, sq, skv, d, scale, causal, per, s);
  else if (d <= 192)
    err = launch_bf16<192, 96>(q, k, v, l, dout, dq, dk, dv, dl, w, b, hq,
                               hkv, sq, skv, d, scale, causal, per, s);
  else
    err = launch_bf16<256, 128>(q, k, v, l, dout, dq, dk, dv, dl, w, b, hq,
                                hkv, sq, skv, d, scale, causal, per, s);
  return static_cast<int>(err);
}
