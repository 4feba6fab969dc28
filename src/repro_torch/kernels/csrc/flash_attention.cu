// Cache-free blocked online-softmax (flash) attention with GQA, for Hopper
// (sm_90a): two tensor-core kernels for bf16 (TMA and wgmma where the
// operands allow it, mma.sync otherwise) and a CUDA-core kernel for f32.
//
// Replaces: src/repro/kernels/flash_attention.py:101 flash_attention_pallas
// (the Pallas body is _kernel at :44).  Same contract: q (B, Hq, Sq, D),
// k and v (B, Hkv, Skv, D), Hq % Hkv == 0, query head h reads KV head
// h / (Hq / Hkv); the queries are the last Sq positions of the Skv-long
// context (q_off = Skv - Sq), causal or not.  Per 64-row KV tile, in f32:
//   logits = q . k * scale                     masked to -1e30 where
//                                              kpos >= Skv or (causal and
//                                              q_off + i < kpos)
//   m' = max(m, rowmax(logits)); p = exp(logits - m'), 0 where masked
//   alpha = exp(m - m'); l = alpha * l + rowsum(p); acc = alpha * acc + p.v
// and out = acc / max(l, 1e-30) in q's dtype (bf16 or f32), so a query
// row that sees no key gives 0, as the TPU kernel does.  Training asks
// for the rows' log-sum-exp too, lse = m + log(l) in f32 with the natural
// log (-inf for a row that sees no key), which the backward kernels
// (flash_attention_bwd.cu) read; serving passes no lse pointer, and the
// output does not depend on whether lse is written.  The plain version
// is repro_torch.kernels.ref.flash_attention_plain for both kernels.
//
// What bounds it on the H100: operations at long rows, bytes at short
// ones.  4 * Sq * Skv * D flops per (batch, query head) against 2 * (Sq +
// Skv) * D input elements: at the whisper encoder's Sq = Skv = 1500, D =
// 64 that is ~750 flops per input element, above the bf16 ridge (~295
// flop/byte), so the tensor cores' 989 TFLOP/s set the bound; at the
// causal S 512 shapes of the families (glm4, deepseek's MLA, zamba2, the
// VLM) half the pairs are masked, and reading q, k, v and writing out at
// 3.35 TB/s sets it.  The three bf16 terms of p (below) triple P.V, so
// the tensor work is ~2x the nominal 4 * Sq * Skv * D.
//
// The arithmetic of both bf16 kernels, per 64-key tile:
//  * S = Q.K^T on the tensor cores (bf16 in, f32 accumulator, k16 steps
//    in order; q.k of bf16 inputs is exact per product).  The online
//    softmax runs on the accumulator fragments in base 2: logits times
//    scale * log2(e), p = 2^(x - m) on the MUFU (ex2.approx), a few f32
//    ulps from the plain version's exp(q.f32 * scale . k - m); row max
//    and row sum are reduced over the 4-lane quad; l sums the f32 p;
//  * p enters P.V from registers as three bf16 A operands, hi = bf16(p),
//    mi = bf16(p - hi), lo = bf16(p - hi - mi): hi + mi + lo = p, so P.V
//    on the tensor cores multiplies the plain version's f32 p; per k16
//    step the terms go in the order hi, lo, mi.  One bf16 rounding of p
//    lands on either side of a rounding boundary depending on the
//    logits' summation order and moves outputs by up to ~7e-5, beyond
//    one output ulp (tests/test_torch_flash_attention.py); two terms (16
//    bits) stay within the ulp, but their noise broke an exact bf16 tie
//    of whisper's int8 logits the other way from the plain version;
//  * tensor-core f32 accumulation truncates toward zero, so O is not one
//    accumulator over the whole walk: each tile's P.V sums in a fresh
//    one and joins O with round-to-nearest, o = alpha * o + p.v as the
//    plain version rounds it;
//  * rows past Skv and columns past D are zero-filled in shared memory
//    and never read from device memory, so NaN past Skv cannot leak;
//    causal tiles that no row sees are never loaded, and the per-element
//    mask runs only on tiles that cross Skv or the diagonal.  Output rows
//    past Sq are not written.
//
// The TMA kernel (fa3::flash_fwd_wgmma_kernel), the FA3 shape, for every
// contiguous bf16 call whose head dim is a multiple of 8 and whose
// operands are 16-byte aligned (every path's shape):
//  * warp specialisation: warpgroup 0 is the producer, one thread of it
//    issuing every load; warpgroups 1 to NWG (1, 2, or 3 at D <= 64) are
//    consumers, each owning 64 query rows of one query head.  setmaxnreg
//    moves the producer's registers to the consumers (24 / 240 a thread
//    with two, 24 / 160 with three), so that O, a fresh P.V accumulator,
//    S and the three terms of p stay in registers, without spill;
//  * loads by TMA (hopper.cuh): Q once per block, K and V through a ring
//    of 2-4 stages in shared memory with a full barrier for each of K and
//    V and an empty barrier per stage; 64 x 64 boxes with the 128-byte
//    swizzle that wgmma reads.  K and V are 3-D tensor maps (D, Skv, B *
//    Hkv), so TMA fills rows past Skv (and columns past D) with zero
//    instead of reading the next head's rows.  The maps are encoded on
//    the host per launch (cuTensorMapEncodeTiled through
//    cudaGetDriverEntryPoint, no -lcuda) and passed as __grid_constant__
//    parameters: nothing is allocated on the device, so CUDA-graph
//    capture stays valid;
//  * products by wgmma: S = Q.K^T m64n64k16 from shared memory; P.V
//    m64n64k16 with the terms of p as the A operand from registers and V
//    from shared memory, MN-major (the transpose bit), in 64-column
//    slices (O takes D / 2 registers a thread), each joined in turn;
//  * a block owns one KV head and its consumers' items, which share each
//    K/V tile: two query heads of a GQA group at the same rows, or
//    consecutive 64-row steps of one head; causal blocks run longest
//    first.  kernels/flash_attention.flash_fwd_plan picks the grid (two
//    consumers above D 128, three for long non-causal rows at D 64, else
//    one, two blocks an SM), from the times of every grid (PERF.md);
//  * the consumers take turns, in a ring of named barriers, to issue
//    their products, so that one's softmax runs while another's products
//    do.  At D 64 (one or two consumers) S of tile t goes in flight with
//    P.V of tile t - 1, and tile t's softmax runs while P.V does;
//  * on the card the consumers' softmax and split of p (about a dozen
//    instructions and one MUFU ex2 a logit), not the tensor cores, set
//    the pace; the third term doubles P.V's tensor work;
//  * instances for D <= 64, 128, 192 and 256 with one or two consumers,
//    and D <= 64 with three.
//
// The mma.sync kernel (tc::flash_attention_bf16_kernel), the FA2 shape,
// for what TMA cannot address: a head dim that is not a multiple of 8,
// or an operand that is not 16-byte aligned.  One block of 4 warps per
// (64-row query tile, query head, batch), each warp owning 16 query rows;
// mma.sync m16n8k16 with ldmatrix operand loads; K/V tiles through a
// 2-stage cp.async ring (plain loads when unaligned), Q loaded once; rows
// padded by 16 bytes so that ldmatrix's 8 rows hit distinct banks;
// instances for D <= 64, 128, 192 and 256.
//
// The f32 kernel (flash_attention_f32_kernel): products on the CUDA cores
// in f32 (exact f32 inputs to every product, no TF32), so that the f32
// lane keeps the plain version's numbers:
//  * one block per (64-row query tile, query head, batch); the block walks
//    64-row K/V tiles staged in shared memory, Q staged once with the
//    scale applied, the (m, l) state and the output accumulator in
//    registers: 16 x 16 threads, each owning 4 query rows (i * 16 + ty) x
//    4 key columns of a logits tile and the same 4 rows x DJ columns of
//    the output.  Row reductions are 16-lane shuffles.  Rows are padded
//    by one float so that the logits loop reads K and Q without bank
//    conflicts.  At D = 256 the four tiles need 209 KB, above the 48 KB
//    static limit, so the launch raises the block's dynamic shared-memory
//    limit;
//  * causal tiles past the last query row's visible position are never
//    loaded; Q rows past Sq and K/V rows past Skv are filled with 0 in
//    shared memory, never read from device memory, and the p.v loop stops
//    at the tile's last valid key.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key / value rows per tile
constexpr int TY = 16;        // thread rows: each owns BQ / TY query rows
constexpr int TX = 16;        // thread columns: BK / TX logits columns
constexpr int THREADS = TY * TX;
constexpr int RI = BQ / TY;   // query rows per thread (4)
constexpr int CJ = BK / TX;   // logits columns per thread (4)
constexpr float NEG = -1e30f;

// shared-memory floats of one block: Q and K with rows of D + 1, V with
// rows of 16 * DJ (columns past D zero), P with rows of BK + 1
__host__ __device__ inline size_t smem_floats(int d, int dj) {
  return (size_t)BQ * (d + 1) + (size_t)BK * (d + 1) + (size_t)BK * 16 * dj +
         (size_t)BQ * (BK + 1);
}

// DJ: output columns per thread; the kernel takes D <= 16 * DJ
template <int DJ>
__global__ void __launch_bounds__(THREADS)
    flash_attention_f32_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ out,
                               float* __restrict__ lse,
                               int hq, int group, int sq, int skv, int d,
                               float scale, int causal) {
  extern __shared__ float smem[];
  const int ldq = d + 1, ldv = 16 * DJ, ldp = BK + 1;
  float* qs = smem;                    // BQ x ldq
  float* ks = qs + BQ * ldq;           // BK x ldq
  float* vs = ks + BK * ldq;           // BK x ldv
  float* ps = vs + BK * ldv;           // BQ x ldp

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, bb = blockIdx.z;
  const int hk = h / group;
  const int hkv = hq / group;
  const int q_off = skv - sq;
  const size_t qbase = ((size_t)bb * hq + h) * sq * d;
  const size_t kbase = ((size_t)bb * hkv + hk) * skv * d;

  // Q tile, scaled: q.f32 * scale (one rounding), 0 past Sq
  for (int idx = tid; idx < BQ * d; idx += THREADS) {
    const int r = idx / d, c = idx - r * d;
    float x = 0.f;
    if (q0 + r < sq)
      x = __fmul_rn(q[qbase + (size_t)(q0 + r) * d + c], scale);
    qs[r * ldq + c] = x;
  }

  // causal: K/V positions >= kv_end are invisible to every row of the tile
  const int q_hi = min(q0 + BQ, sq);
  int kv_end = causal ? min(skv, q_off + q_hi) : skv;
  if (kv_end < 0) kv_end = 0;
  const int ntiles = (kv_end + BK - 1) / BK;

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    const int kn = min(BK, skv - k0);  // valid keys in this tile
    __syncthreads();                   // previous tile fully consumed
    for (int idx = tid; idx < BK * d; idx += THREADS) {
      const int r = idx / d, c = idx - r * d;
      float kx = 0.f, vx = 0.f;
      if (r < kn) {
        const size_t g = kbase + (size_t)(k0 + r) * d + c;
        kx = k[g];
        vx = v[g];
      }
      ks[r * ldq + c] = kx;
      vs[r * ldv + c] = vx;
    }
    if (ldv > d) {                     // zero V's columns past D
      const int extra = ldv - d;
      for (int idx = tid; idx < BK * extra; idx += THREADS) {
        const int r = idx / extra, c = d + idx - r * extra;
        vs[r * ldv + c] = 0.f;
      }
    }
    __syncthreads();

    // logits tile: rows ty + 16 i, columns tx + 16 j
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float a[RI], b[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = qs[(ty + TY * i) * ldq + c];
#pragma unroll
      for (int j = 0; j < CJ; ++j) b[j] = ks[(tx + TX * j) * ldq + c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

    // online softmax update, one query row per (thread row, i)
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = q_off + q0 + ty + TY * i;
      bool ok[CJ];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kpos = k0 + tx + TX * j;
        ok[j] = kpos < skv && (!causal || qpos >= kpos);
        if (!ok[j]) s[i][j] = NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = ok[j] ? expf(__fsub_rn(s[i][j], m_new)) : 0.f;
        ps[(ty + TY * i) * ldp + tx + TX * j] = p;
        rs = __fadd_rn(rs, p);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, off));
      const float alpha = expf(__fsub_rn(m[i], m_new));
      l[i] = __fadd_rn(__fmul_rn(alpha, l[i]), rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] = __fmul_rn(alpha, acc[i][j]);
    }
    __syncthreads();                   // P tile complete

    // acc += p . v over the tile's valid keys only
    for (int kk = 0; kk < kn; ++kk) {
      float pv[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = ps[(ty + TY * i) * ldp + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[kk * ldv + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty + TY * i;
    if (r >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + TX * j;
      if (c >= d) continue;
      const float y = __fdiv_rn(acc[i][j], den);
      out[qbase + (size_t)r * d + c] = y;
    }
    if (lse != nullptr && tx == 0)
      lse[((size_t)bb * hq + h) * sq + r] =
          l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
  }
}


namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;              // query rows per block, 16 per warp
constexpr int BK = 64;              // key / value rows per tile
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr float NEG = -1e30f;

// Q, then 2 stages of K, then 2 stages of V; rows of DP + 8 bf16
template <int DP>
constexpr size_t smem_bytes() {
  return (size_t)(BQ + 4 * BK) * (DP + 8) * sizeof(bf16);
}

// 2^x (MUFU, ~2 ulp; flushes results below 2^-126 to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// two f32 p as three bf16 pairs, hi = bf16(p), mi = bf16(p - hi),
// lo = bf16(p - hi - mi) (each difference exact): hi + mi + lo = p, all
// 24 bits of it; the lower column in the low half, as the A fragment wants
__device__ __forceinline__ void split_p(float p0, float p1, uint32_t& hi,
                                        uint32_t& mi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = __fsub_rn(p0, hf.x), r1 = __fsub_rn(p1, hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(r0, mf.x), __fsub_rn(r1, mf.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mi = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}


// rows [row0, row0 + 64) of a (nrows, d) slab into a 64 x DP shared tile;
// rows >= nrows and columns >= d are zero and never read.  vec: 16-byte
// cp.async (d % 8 == 0, aligned slab); otherwise plain loads
template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int nrows, int d,
                                          bool vec) {
  constexpr int LD = DP + 8, CH = DP / 8;     // 16-byte chunks per row
  for (int i = threadIdx.x; i < 64 * CH; i += THREADS) {
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

// DP: the instance's head width (a multiple of 64); the kernel takes
// D <= DP
template <int DP>
__global__ void __launch_bounds__(THREADS)
    flash_attention_bf16_kernel(const bf16* __restrict__ q,
                                const bf16* __restrict__ k,
                                const bf16* __restrict__ v,
                                bf16* __restrict__ out,
                                float* __restrict__ lse, int hq, int group,
                                int sq, int skv, int d, float scale,
                                int causal, int vec) {
  constexpr int LD = DP + 8;
  constexpr int KD = DP / 16;          // k16 steps of Q.K^T, n16 steps of P.V
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);    // BQ x LD
  bf16* ks = qs + BQ * LD;                          // 2 x BK x LD
  bf16* vs = ks + 2 * BK * LD;                      // 2 x BK x LD

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;   // fragment row, column pair
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, bb = blockIdx.z;
  const int hkv = hq / group;
  const int q_off = skv - sq;
  const bf16* qg = q + ((size_t)bb * hq + h) * sq * d;
  const bf16* kg = k + ((size_t)bb * hkv + h / group) * skv * d;
  const bf16* vg = v + ((size_t)bb * hkv + h / group) * skv * d;
  // the softmax runs in base 2: logits times scale * log2(e), p = 2^(x - m)
  const float scale2 = scale * 1.4426950408889634f;

  // causal: K/V positions >= kv_end are invisible to every row of the tile
  const int q_hi = min(q0 + BQ, sq);
  int kv_end = causal ? min(skv, q_off + q_hi) : skv;
  if (kv_end < 0) kv_end = 0;
  const int ntiles = (kv_end + BK - 1) / BK;

  load_tile<DP>(qs, qg, q0, sq, d, vec);
  if (ntiles > 0) {
    load_tile<DP>(ks, kg, 0, skv, d, vec);
    load_tile<DP>(vs, vg, 0, skv, d, vec);
  }
  cp_async_commit();

  const int wrow = warp * 16;               // the warp's first row
  const int qp0 = q_off + q0 + wrow + g;    // position of fragment row g
  // ldmatrix lane addresses: A (16 rows x 16 columns), B from K (two n8
  // tiles of keys x 16 columns), B from V transposed (16 keys x two n8
  // tiles of columns)
  const int a_off = (wrow + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                    8 * (lane >> 4);
  const int k_off = ((lane & 7) + 8 * (lane >> 4)) * LD +
                    8 * ((lane >> 3) & 1);
  const int v_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                    8 * (lane >> 4);

  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    if (t + 1 < ntiles) {                 // tile t + 1 loads during tile t
      load_tile<DP>(ks + (st ^ 1) * BK * LD, kg, (t + 1) * BK, skv, d, vec);
      load_tile<DP>(vs + (st ^ 1) * BK * LD, vg, (t + 1) * BK, skv, d, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + st * BK * LD;
    const bf16* vt = vs + st * BK * LD;

    // S = Q.K^T: 16 x 64 per warp, in the accumulator fragments
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, smem_addr(qs + a_off + kk * 16));
#pragma unroll
      for (int nn = 0; nn < BK / 16; ++nn) {
        uint32_t b[4];
        ldsm_x4(b, smem_addr(kt + k_off + nn * 16 * LD + kk * 16));
        mma(s[2 * nn], a, b[0], b[1]);
        mma(s[2 * nn + 1], a, b[2], b[3]);
      }
    }

    // online softmax on the fragments: lane holds rows g (e < 2) and
    // g + 8 (e >= 2), key columns 8 j + 2 t4 + (e & 1)
    const int k0 = t * BK;
    const bool edge = k0 + BK > skv ||
                      (causal && k0 + BK - 1 > q_off + q0 + wrow);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[j][e], scale2);
        if (edge) {
          const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
          if (kpos >= skv || (causal && qp0 + 8 * (e >> 1) < kpos)) x = NEG;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
      alpha[i] = ex2(__fsub_rn(m[i], mx[i]));
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool ok = true;
        if (edge) {
          const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
          ok = kpos < skv && (!causal || qp0 + 8 * (e >> 1) >= kpos);
        }
        const float p = ok ? ex2(__fsub_rn(s[j][e], mx[e >> 1])) : 0.f;
        s[j][e] = p;
        rs[e >> 1] = __fadd_rn(rs[e >> 1], p);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        rs[i] = __fadd_rn(rs[i], __shfl_xor_sync(0xffffffffu, rs[i], off));
      l[i] = __fadd_rn(__fmul_rn(alpha[i], l[i]), rs[i]);
      m[i] = mx[i];
    }
    // O = alpha * O + P.V: P from registers as hi, mi, lo bf16 A operands;
    // each 16-column slice of the tile's product sums in a fresh
    // accumulator (tensor-core adds truncate toward zero) and joins O
    // with round-to-nearest, as the plain version's acc = alpha * acc + p.v
    uint32_t hi[BK / 16][4], mi[BK / 16][4], lo[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      split_p(s[2 * kk][0], s[2 * kk][1], hi[kk][0], mi[kk][0], lo[kk][0]);
      split_p(s[2 * kk][2], s[2 * kk][3], hi[kk][1], mi[kk][1], lo[kk][1]);
      split_p(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[kk][2], mi[kk][2],
              lo[kk][2]);
      split_p(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[kk][3], mi[kk][3],
              lo[kk][3]);
    }
#pragma unroll
    for (int nn = 0; nn < KD; ++nn) {
      float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t b[4];
        ldsm_x4_trans(b, smem_addr(vt + v_off + kk * 16 * LD + nn * 16));
        mma(c[0], hi[kk], b[0], b[1]);
        mma(c[1], hi[kk], b[2], b[3]);
        mma(c[0], lo[kk], b[0], b[1]);
        mma(c[1], lo[kk], b[2], b[3]);
        mma(c[0], mi[kk], b[0], b[1]);
        mma(c[1], mi[kk], b[2], b[3]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[2 * nn + u][e] =
              __fadd_rn(__fmul_rn(alpha[e >> 1], o[2 * nn + u][e]), c[u][e]);
    }
    __syncthreads();                      // stage st free for tile t + 2
  }
  cp_async_wait<0>();                     // Q alone, when no tile is seen

  const bool pairs = (d & 1) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + wrow + g + 8 * i;
    if (r >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    // m is in base-2 units (logits times log2(e)): lse = (m + log2 l) ln 2
    if (lse != nullptr && t4 == 0)
      lse[((size_t)bb * hq + h) * sq + r] =
          l[i] > 0.f ? (m[i] + log2f(l[i])) * 0.6931471805599453f
                     : -INFINITY;
    bf16* orow = out + (((size_t)bb * hq + h) * sq + r) * d;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = 8 * n + 2 * t4;
      if (c >= d) continue;
      const bf16 y0 = __float2bfloat16_rn(__fdiv_rn(o[n][2 * i], den));
      if (c + 1 < d) {
        const bf16 y1 =
            __float2bfloat16_rn(__fdiv_rn(o[n][2 * i + 1], den));
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __halves2bfloat162(y0, y1);
        } else {
          orow[c] = y0;
          orow[c + 1] = y1;
        }
      } else {
        orow[c] = y0;
      }
    }
  }
}

}  // namespace tc

// The bf16 route for TMA-addressable operands (D % 8 == 0, 16-byte
// aligned): the FA3 shape (see the header).  Each consumer warpgroup owns
// one item, 64 query rows of one query head; a block owns NWG items that
// read the same KV head (flash_fwd_plan in kernels/flash_attention.py
// mirrors the decode below).
namespace fa3 {

using tc::bf16;
using namespace hopper;

constexpr int BK = 64;                  // key / value rows per tile
constexpr int TILE = 64 * 128;          // bytes of 64 rows x 64 bf16
constexpr float NEG = -1e30f;

// ring stages of K and V tiles: 4 at D 64, 3 at D 128 and 192, 2 at D 256
template <int DP>
__host__ __device__ constexpr int stages() {
  return DP == 64 ? 4 : DP == 256 ? 2 : 3;
}

// Q (one tile per consumer), the K and V rings, then the barriers
template <int DP, int NWG>
constexpr size_t smem_bytes() {
  return (size_t)(NWG + 2 * stages<DP>()) * (DP / 64) * TILE +
         8 * (1 + 3 * stages<DP>());
}

// registers per thread after setmaxnreg: the producer's warpgroup gives
// its registers to the consumers (three: 24 / 160; two: 24 / 240; one
// with two blocks an SM: 24 / 232; one alone: 56 / 256)
template <int DP, int NWG>
struct Regs {
  static constexpr int blocks = (NWG == 1 && DP <= 128) ? 2 : 1;
  static constexpr int producer = (NWG == 1 && blocks == 1) ? 56 : 24;
  static constexpr int consumer =
      NWG == 3 ? 160 : NWG == 2 ? 240 : (blocks == 2 ? 232 : 256);
};

// KV tiles that 64 query rows from row0 see (0 for rows past Sq)
__device__ __forceinline__ int item_tiles(int row0, int sq, int skv,
                                          int causal) {
  if (row0 >= sq) return 0;
  int kv_end = causal ? min(skv, skv - sq + min(row0 + 64, sq)) : skv;
  return kv_end <= 0 ? 0 : (kv_end + BK - 1) / BK;
}

// DP: the instance's head width (a multiple of 64), D <= DP.  NWG: the
// consumer warpgroups (1, 2, or 3 at D <= 64); warpgroup 0 is the
// producer.
template <int DP, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), (Regs<DP, NWG>::blocks))
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                           const __grid_constant__ CUtensorMap tmk,
                           const __grid_constant__ CUtensorMap tmv,
                           bf16* __restrict__ out, float* __restrict__ lse,
                           int hq, int group, int sq, int skv, int d,
                           float scale, int causal, int pack_heads,
                           int units) {
  constexpr int CH = DP / 64;           // 64-column chunks of a row
  constexpr int ST = stages<DP>();
  constexpr int TB = CH * TILE;         // bytes of a 64-row Q, K or V tile
  // S of tile t beside P.V of t - 1 at D 64 (not with three consumers,
  // whose 160 registers hold one of the two; at D 128 it spills)
  constexpr bool OVERLAP = DP == 64 && NWG < 3;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t qs = smem_u32(smem);
  const uint32_t ks = qs + NWG * TB, vs = ks + ST * TB;
  const uint32_t qfull = vs + ST * TB;
  auto kfull = [&](int s) { return qfull + 8 + 8 * s; };
  auto vfull = [&](int s) { return qfull + 8 + 8 * (ST + s); };
  auto empty = [&](int s) { return qfull + 8 + 8 * (2 * ST + s); };

  if (threadIdx.x == 0) {
    if (qs & 1023) __trap();            // the swizzle needs 1024-byte tiles
    mbar_init(qfull, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(kfull(s), 1);
      mbar_init(vfull(s), 1);
      mbar_init(empty(s), 4 * NWG);     // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  // block -> batch, KV head and the consumers' (query head, row0): row
  // tiles of 64 rows (two heads of a group a block) or 64 a consumer on
  // one head; causal blocks longest first
  const int hkv = hq / group;
  const int rows = pack_heads ? 64 : 64 * NWG;
  const int nrt = (sq + rows - 1) / rows;
  const int rt = blockIdx.x / units, u = blockIdx.x - rt * units;
  const int r = causal ? nrt - 1 - rt : rt;
  int bb, hk, h0;                       // consumer c takes head h0 + c
  if (pack_heads) {                     // (or h0 when rows are packed)
    const int pairs = group / 2;
    bb = u / (hkv * pairs);
    const int rem = u - bb * hkv * pairs;
    hk = rem / pairs;
    h0 = hk * group + 2 * (rem - hk * pairs);
  } else {
    bb = u / hq;
    h0 = u - bb * hq;
    hk = h0 / group;
  }
  auto row0_of = [&](int c) { return pack_heads ? r * 64 : r * rows + 64 * c; };
  int nblk = 0;                         // KV tiles the block loads
#pragma unroll
  for (int c = 0; c < NWG; ++c)
    nblk = max(nblk, item_tiles(row0_of(c), sq, skv, causal));

  // the warpgroup, broadcast so that the compiler sees it warp-uniform
  // (setmaxnreg and the wgmma pipeline need uniform control flow)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // producer: one thread issues every TMA load
    setmaxnreg_dec<Regs<DP, NWG>::producer>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(qfull, NWG * TB);
#pragma unroll
      for (int c = 0; c < NWG; ++c)
#pragma unroll
        for (int ch = 0; ch < CH; ++ch)
          tma_load_3d(qs + c * TB + ch * TILE, &tmq, qfull, ch * 64,
                      row0_of(c), bb * hq + h0 + (pack_heads ? c : 0));
      const int kvh = bb * hkv + hk;
      for (int t = 0; t < nblk; ++t) {
        const int s = t % ST;
        if (t >= ST) mbar_wait(empty(s), ((t / ST) - 1) & 1);
        mbar_arrive_expect_tx(kfull(s), TB);
#pragma unroll
        for (int ch = 0; ch < CH; ++ch)
          tma_load_3d(ks + s * TB + ch * TILE, &tmk, kfull(s), ch * 64,
                      t * BK, kvh);
        mbar_arrive_expect_tx(vfull(s), TB);
#pragma unroll
        for (int ch = 0; ch < CH; ++ch)
          tma_load_3d(vs + s * TB + ch * TILE, &tmv, vfull(s), ch * 64,
                      t * BK, kvh);
      }
    }
    return;
  }

  // consumers
  setmaxnreg_inc<Regs<DP, NWG>::consumer>();
  const int c = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;   // fragment row, column pair
  const int h = h0 + (pack_heads ? c : 0), row0 = row0_of(c);
  const int nmine = item_tiles(row0, sq, skv, causal);
  const int q_off = skv - sq;
  const int wrow = 16 * warp;               // the warp's first row
  const int qp0 = q_off + row0 + wrow + g;  // position of fragment row g
  const float scale2 = scale * 1.4426950408889634f;
  const uint32_t qa = qs + c * TB;

  // tensor-core turns: the consumers take turns, in a ring, to issue
  // their products (named barrier 1 + c is consumer c's), so that one's
  // softmax runs while another's products do; consumer 0 starts
  auto turn_begin = [&]() {
    if (NWG > 1) named_bar_sync(1 + c, 256);
  };
  auto turn_end = [&]() {
    if (NWG > 1) named_bar_arrive(1 + (c + 1) % NWG, 256);
  };
  if (NWG > 1 && c == NWG - 1) named_bar_arrive(1, 256);

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, alpha[2] = {1.f, 1.f};
  float s[32];
  uint32_t hi[BK / 16][4], mi[BK / 16][4], lo[BK / 16][4];

  // S = Q.K^T of the tile in stage st (64 x 64 per consumer), in flight
  auto issue_s = [&](int st) {
    fence_operands(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk / 4) * TILE + (kk % 4) * 32;
      wgmma_m64n64k16_ss(s, desc_b128(qa + off, 16, 1024),
                         desc_b128(ks + st * TB + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // acc = P.V for V's columns [64 cs, 64 cs + 64) of stage st, in
  // flight: per k16 step the terms hi, lo, mi, in the mma.sync kernel's
  // order
  auto issue_pv = [&](float (&acc)[32], int st, int cs) {
    fence_operands(hi);
    fence_operands(mi);
    fence_operands(lo);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t b =
          desc_b128(vs + st * TB + cs * TILE + kk * 16 * 128, TILE, 1024);
      wgmma_m64n64k16_rs_t(acc, hi[kk], b, kk > 0);
      wgmma_m64n64k16_rs_t(acc, lo[kk], b, 1);
      wgmma_m64n64k16_rs_t(acc, mi[kk], b, 1);
    }
    wgmma_commit();
  };
  // after the wait that retires it: the registers back to the compiler
  auto landed_pv = [&](float (&acc)[32]) {
    fence_operands(acc);
    fence_operands(hi);
    fence_operands(mi);
    fence_operands(lo);
  };
  // O = a * O + acc with round-to-nearest, columns [64 cs, 64 cs + 64)
  auto join = [&](const float (&acc)[32], int cs, const float (&a)[2]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float& x = o[cs * 32 + i];
      x = __fadd_rn(__fmul_rn(a[(i >> 1) & 1], x), acc[i]);
    }
  };
  // P.V of the tile in stage st joined into O with alpha, 64-column
  // slice by slice, each waited and joined
  auto pv_serial = [&](int st) {
#pragma unroll
    for (int cs = 0; cs < CH; ++cs) {
      float acc[32];
      issue_pv(acc, st, cs);
      wgmma_wait<0>();
      landed_pv(acc);
      join(acc, cs, alpha);
    }
  };
  // the online softmax of tile t on S (the mma.sync kernel's arithmetic):
  // s becomes p, m and l move, alpha = 2^(m_old - m_new)
  auto softmax = [&](int t) {
    const int k0 = t * BK;
    const bool edge =
        k0 + BK > skv || (causal && k0 + BK - 1 > q_off + row0 + wrow);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[4 * j + e], scale2);
        if (edge) {
          const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
          if (kpos >= skv || (causal && qp0 + 8 * (e >> 1) < kpos)) x = NEG;
        }
        s[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
      alpha[i] = tc::ex2(__fsub_rn(m[i], mx[i]));
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool ok = true;
        if (edge) {
          const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
          ok = kpos < skv && (!causal || qp0 + 8 * (e >> 1) >= kpos);
        }
        const float p = ok ? tc::ex2(__fsub_rn(s[4 * j + e], mx[e >> 1]))
                           : 0.f;
        s[4 * j + e] = p;
        rs[e >> 1] = __fadd_rn(rs[e >> 1], p);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        rs[i] = __fadd_rn(rs[i], __shfl_xor_sync(0xffffffffu, rs[i], off));
      l[i] = __fadd_rn(__fmul_rn(alpha[i], l[i]), rs[i]);
      m[i] = mx[i];
    }
  };
  // p as three bf16 A operands, hi + mi + lo = p
  auto split = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      tc::split_p(s[8 * kk], s[8 * kk + 1], hi[kk][0], mi[kk][0], lo[kk][0]);
      tc::split_p(s[8 * kk + 2], s[8 * kk + 3], hi[kk][1], mi[kk][1],
                  lo[kk][1]);
      tc::split_p(s[8 * kk + 4], s[8 * kk + 5], hi[kk][2], mi[kk][2],
                  lo[kk][2]);
      tc::split_p(s[8 * kk + 6], s[8 * kk + 7], hi[kk][3], mi[kk][3],
                  lo[kk][3]);
    }
  };
  auto wait_k = [&](int t) { mbar_wait(kfull(t % ST), (t / ST) & 1); };
  auto wait_v = [&](int t) { mbar_wait(vfull(t % ST), (t / ST) & 1); };
  auto release = [&](int t) {           // the block is done with tile t
    if (lane == 0) mbar_arrive(empty(t % ST));
  };

  // The walk, in turns: turn 0 issues S_0, turn t (1 <= t < nmine) S_t
  // and P.V_{t-1}, turn nmine P.V_{nmine - 1}.  OVERLAP: S_t and
  // P.V_{t-1} go in flight together and the softmax of tile t runs while
  // P.V does.  Otherwise P.V_{t-1} slice by slice, then S_t.  Both
  // consumers take nblk + 1 turns; one whose rows see fewer tiles than
  // the block's other consumer releases the rest, each after its load
  // landed.
  mbar_wait(qfull, 0);
  int turns = 0;
  if (nmine > 0) {
    wait_k(0);
    turn_begin();
    issue_s(0);
    turn_end();
    ++turns;
    wgmma_wait<0>();
    fence_operands(s);
    softmax(0);
    split();
    for (int t = 1; t < nmine; ++t) {
      wait_k(t);
      wait_v(t - 1);
      turn_begin();
      if constexpr (OVERLAP) {
        float acc[CH][32];
        issue_s(t % ST);
#pragma unroll
        for (int cs = 0; cs < CH; ++cs) issue_pv(acc[cs], (t - 1) % ST, cs);
        turn_end();
        wgmma_wait<CH>();                 // S_t landed, P.V in flight
        fence_operands(s);
        const float a_prev[2] = {alpha[0], alpha[1]};   // tile t - 1's
        softmax(t);
        wgmma_wait<0>();
#pragma unroll
        for (int cs = 0; cs < CH; ++cs) {
          landed_pv(acc[cs]);
          join(acc[cs], cs, a_prev);
        }
      } else {
        pv_serial((t - 1) % ST);
        issue_s(t % ST);
        turn_end();
        wgmma_wait<0>();
        fence_operands(s);
        softmax(t);
      }
      ++turns;
      release(t - 1);
      split();
    }
    wait_v(nmine - 1);
    turn_begin();
    pv_serial((nmine - 1) % ST);
    turn_end();
    ++turns;
    release(nmine - 1);
  }
  // tiles only the other consumer sees: a turn each (it may be waiting
  // for one to release a stage), then the turns that make nblk + 1
  for (int t = nmine; t < nblk; ++t, ++turns) {
    wait_k(t);
    turn_begin();
    turn_end();
    release(t);
  }
  for (const int all = nblk > 0 ? nblk + 1 : 0; turns < all; ++turns) {
    turn_begin();
    turn_end();
  }
  if (NWG > 1 && c == 0) named_bar_sync(1, 256);   // the last turn's

  const size_t hq_row = ((size_t)bb * hq + h) * sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = row0 + wrow + g + 8 * i;
    if (rr >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    // m is in base-2 units (logits times log2(e)): lse = (m + log2 l) ln 2
    if (lse != nullptr && t4 == 0)
      lse[hq_row + rr] =
          l[i] > 0.f ? (m[i] + log2f(l[i])) * 0.6931471805599453f
                     : -INFINITY;
    bf16* orow = out + (hq_row + rr) * d;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = 8 * n + 2 * t4;
      if (col >= d) continue;
      *reinterpret_cast<__nv_bfloat162*>(orow + col) = __halves2bfloat162(
          __float2bfloat16_rn(__fdiv_rn(o[4 * n + 2 * i], den)),
          __float2bfloat16_rn(__fdiv_rn(o[4 * n + 2 * i + 1], den)));
    }
  }
}

}  // namespace fa3

template <int DJ>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, float* lse, int b, int hq, int hkv, int sq,
                       int skv, int d, float scale, int causal,
                       cudaStream_t s) {
  auto kern = flash_attention_f32_kernel<DJ>;
  const size_t smem = smem_floats(d, DJ) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, hq, b);
  kern<<<grid, THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, hq,
      hq / hkv, sq, skv, d, scale, causal);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, float* lse, int b, int hq, int hkv,
                        int sq, int skv, int d, float scale, int causal,
                        cudaStream_t s) {
  auto kern = tc::flash_attention_bf16_kernel<DP>;
  const size_t smem = tc::smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  const int vec = d % 8 == 0 && addr % 16 == 0;
  const dim3 grid((sq + tc::BQ - 1) / tc::BQ, hq, b);
  kern<<<grid, tc::THREADS, smem, s>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<tc::bf16*>(out), lse, hq,
      hq / hkv, sq, skv, d, scale, causal, vec);
  return cudaGetLastError();
}

using hopper::EncodeTiled;
using hopper::encode_tiled;

// a contiguous (heads, rows, d) bf16 tensor as a 3-D map of 64 x 64 boxes,
// 128-byte swizzle; out-of-bounds elements read as zero
bool encode_3d(EncodeTiled fn, CUtensorMap* map, const void* ptr, int d,
               int rows, int heads) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, int NWG>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, float* lse, int b, int hq, int hkv,
                         int sq, int skv, int d, float scale, int causal,
                         int pack_heads, cudaStream_t s) {
  auto kern = fa3::flash_fwd_wgmma_kernel<DP, NWG>;
  const size_t smem = fa3::smem_bytes<DP, NWG>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!encode_3d(fn, &mq, q, d, sq, b * hq) ||
      !encode_3d(fn, &mk, k, d, skv, b * hkv) ||
      !encode_3d(fn, &mv, v, d, skv, b * hkv))
    return cudaErrorInvalidValue;
  const int group = hq / hkv;
  const int rows = pack_heads ? 64 : 64 * NWG;
  const long long units =
      pack_heads ? (long long)b * hkv * (group / 2) : (long long)b * hq;
  const long long blocks = (long long)((sq + rows - 1) / rows) * units;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, 128 * (NWG + 1), smem, s>>>(
      mq, mk, mv, static_cast<tc::bf16*>(out), lse, hq, group, sq, skv, d,
      scale, causal, pack_heads, (int)units);
  return cudaGetLastError();
}

template <int NWG>
cudaError_t launch_wgmma_d(const void* q, const void* k, const void* v,
                           void* out, float* lse, int b, int hq, int hkv,
                           int sq, int skv, int d, float scale, int causal,
                           int pack_heads, cudaStream_t s) {
  if (d <= 64)
    return launch_wgmma<64, NWG>(q, k, v, out, lse, b, hq, hkv, sq, skv, d,
                                 scale, causal, pack_heads, s);
  if (d <= 128)
    return launch_wgmma<128, NWG>(q, k, v, out, lse, b, hq, hkv, sq, skv, d,
                                  scale, causal, pack_heads, s);
  if (d <= 192)
    return launch_wgmma<192, NWG>(q, k, v, out, lse, b, hq, hkv, sq, skv, d,
                                  scale, causal, pack_heads, s);
  return launch_wgmma<256, NWG>(q, k, v, out, lse, b, hq, hkv, sq, skv, d,
                                scale, causal, pack_heads, s);
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (b, hq, sq, d), k and v (b, hkv, skv, d), out like q; all contiguous,
// all bf16 (is_bf16) or all f32.  lse: null, or (b, hq, sq) f32 for the
// rows' natural log-sum-exp (training).  The wrapper checks 1 <= d <= 256,
// hq % hkv == 0 and sq, skv >= 1; a shape outside that is refused here too.
// wgs 0: f32 runs the CUDA-core kernel, D <= 64 or <= 256 (a narrower head
// runs in the next wider instance, its columns past D zero); bf16 the
// mma.sync kernel, D <= 64, 128, 192 or 256.  wgs 1, 2 or 3 (D <= 64):
// the TMA kernel with that many consumer warpgroups (bf16, d % 8 == 0,
// 16-byte aligned q, k, v; pack_heads: two query heads of a group a
// block, which needs wgs 2 and an even group), the plan of
// flash_fwd_plan.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int b, int hq, int hkv, int sq, int skv,
                                      int d, float scale, int causal,
                                      int is_bf16, int wgs, int pack_heads,
                                      void* stream) {
  if (d < 1 || d > 256 || hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1 ||
      b < 1 || hq > 65535 || b > 65535 || wgs < 0 || wgs > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (wgs > 0) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(q) |
                           reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v);
    if (!is_bf16 || d % 8 != 0 || addr % 16 != 0 ||
        (pack_heads && (wgs != 2 || (hq / hkv) % 2 != 0)) ||
        (wgs == 3 && d > 64))
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err =
        wgs == 3   ? launch_wgmma<64, 3>(q, k, v, out, l, b, hq, hkv, sq, skv,
                                         d, scale, causal, 0, s)
        : wgs == 2 ? launch_wgmma_d<2>(q, k, v, out, l, b, hq, hkv, sq, skv,
                                       d, scale, causal, pack_heads, s)
                   : launch_wgmma_d<1>(q, k, v, out, l, b, hq, hkv, sq, skv,
                                       d, scale, causal, 0, s);
    return static_cast<int>(err);
  }
  cudaError_t err;
  if (!is_bf16)
    err = d <= 64 ? launch_f32<4>(q, k, v, out, l, b, hq, hkv, sq, skv, d,
                                  scale, causal, s)
                  : launch_f32<16>(q, k, v, out, l, b, hq, hkv, sq, skv, d,
                                   scale, causal, s);
  else if (d <= 64)
    err = launch_bf16<64>(q, k, v, out, l, b, hq, hkv, sq, skv, d, scale,
                          causal, s);
  else if (d <= 128)
    err = launch_bf16<128>(q, k, v, out, l, b, hq, hkv, sq, skv, d, scale,
                           causal, s);
  else if (d <= 192)
    err = launch_bf16<192>(q, k, v, out, l, b, hq, hkv, sq, skv, d, scale,
                           causal, s);
  else
    err = launch_bf16<256>(q, k, v, out, l, b, hq, hkv, sq, skv, d, scale,
                           causal, s);
  return static_cast<int>(err);
}
