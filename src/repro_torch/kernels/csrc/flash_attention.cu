// Cache-free blocked online-softmax (flash) attention with GQA, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py:101 flash_attention_pallas
// (the Pallas body is _kernel at :44).  Same contract: q (B, Hq, Sq, D),
// k and v (B, Hkv, Skv, D), Hq % Hkv == 0, query head h reads KV head
// h / (Hq / Hkv); the queries are the last Sq positions of the Skv-long
// context (q_off = Skv - Sq), causal or not.  Per KV tile, in f32:
//   logits = (q.f32 * scale) . k.f32          masked to -1e30 where
//                                              kpos >= Skv or (causal and
//                                              q_off + i < kpos)
//   m' = max(m, rowmax(logits)); p = exp(logits - m'), 0 where masked
//   alpha = exp(m - m'); l = alpha * l + rowsum(p); acc = alpha * acc + p.v
// and out = acc / max(l, 1e-30) in q's dtype (bf16 or f32), so a query
// row that sees no key gives 0, as the TPU kernel does.  The plain version
// is repro_torch.kernels.ref.flash_attention_plain.
//
// What bounds it on the H100: operations.  4 * Sq * Skv * D flops per
// (batch, query head) against 2 * (Sq + Skv) * D input elements: at the
// whisper encoder's Sq = Skv = 1500, D = 64 that is ~750 flops per input
// element, above the bf16 ridge (~295 flop/byte), so the tensor cores'
// 989 TFLOP/s set the bound.  This first kernel runs the products on the
// CUDA cores in f32 (exact f32 inputs to every product, no TF32), so it
// sits well above that bound; wgmma with a TMA pipeline (FA3-style) is the
// later, fast version.
//
// What the design does about it:
//  * one block per (64-row query tile, query head, batch); the KV head is
//    h / group, read in place -- grouped K/V is never copied per query
//    head;
//  * the block walks 64-row K/V tiles staged in shared memory (converted
//    to f32 once, so every product reads f32 from shared memory), Q
//    staged once with the scale applied, the (m, l) state and the output
//    accumulator in registers: 16 x 16 threads, each owning 4 query rows
//    (i * 16 + ty) x 4 key columns of a logits tile and the same 4 rows x
//    DJ columns of the output.  Row reductions are 16-lane shuffles.
//    Rows are padded by one float so that the logits loop reads K and Q
//    without bank conflicts.  At D = 256 the four tiles need 209 KB,
//    above the 48 KB static limit, so the launch raises the block's
//    dynamic shared-memory limit;
//  * causal: whole K/V tiles past the last query row's visible position
//    are never loaded or computed (they would be exact no-ops of the
//    online update); the diagonal tiles mask per element;
//  * the ragged Sq and Skv tails are handled in the kernel: Q rows past Sq
//    and K/V rows past Skv are filled with 0 in shared memory, never read
//    from device memory, and the p.v loop stops at the tile's last valid
//    key, so nothing past Skv is ever multiplied; output rows past Sq are
//    not written.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key / value rows per tile
constexpr int TY = 16;        // thread rows: each owns BQ / TY query rows
constexpr int TX = 16;        // thread columns: BK / TX logits columns
constexpr int THREADS = TY * TX;
constexpr int RI = BQ / TY;   // query rows per thread (4)
constexpr int CJ = BK / TX;   // logits columns per thread (4)
constexpr float NEG = -1e30f;

template <bool BF16>
__device__ __forceinline__ float load(const void* p, size_t i) {
  if (BF16)
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
  return reinterpret_cast<const float*>(p)[i];
}

// shared-memory floats of one block: Q and K with rows of D + 1, V with
// rows of 16 * DJ (columns past D zero), P with rows of BK + 1
__host__ __device__ inline size_t smem_floats(int d, int dj) {
  return (size_t)BQ * (d + 1) + (size_t)BK * (d + 1) + (size_t)BK * 16 * dj +
         (size_t)BQ * (BK + 1);
}

// DJ: output columns per thread; the kernel takes D <= 16 * DJ
template <int DJ, bool BF16>
__global__ void __launch_bounds__(THREADS)
    flash_attention_kernel(const void* __restrict__ q,
                           const void* __restrict__ k,
                           const void* __restrict__ v, void* __restrict__ out,
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
      x = __fmul_rn(load<BF16>(q, qbase + (size_t)(q0 + r) * d + c), scale);
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
        kx = load<BF16>(k, g);
        vx = load<BF16>(v, g);
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
      const size_t o = qbase + (size_t)r * d + c;
      if (BF16)
        reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
      else
        reinterpret_cast<float*>(out)[o] = y;
    }
  }
}

template <int DJ, bool BF16>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int hq, int hkv, int sq, int skv, int d, float scale,
                   int causal, cudaStream_t s) {
  auto kern = flash_attention_kernel<DJ, BF16>;
  const size_t smem = smem_floats(d, DJ) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, hq, b);
  kern<<<grid, THREADS, smem, s>>>(q, k, v, out, hq, hq / hkv, sq, skv, d,
                                    scale, causal);
  return cudaGetLastError();
}

// two instances, for the head widths the ported models use: whisper's
// 64 and gemma's 256; a narrower head runs in the next wider instance,
// its columns past D zero in shared memory and never written
template <bool BF16>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int b, int hq, int hkv, int sq, int skv, int d,
                     float scale, int causal, cudaStream_t s) {
  if (d <= 64)
    return launch<4, BF16>(q, k, v, out, b, hq, hkv, sq, skv, d, scale,
                           causal, s);
  return launch<16, BF16>(q, k, v, out, b, hq, hkv, sq, skv, d, scale, causal,
                          s);
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (b, hq, sq, d), k and v (b, hkv, skv, d), out like q; all contiguous,
// all bf16 (is_bf16) or all f32.  The wrapper checks 1 <= d <= 256,
// hq % hkv == 0 and sq, skv >= 1; a shape outside that is refused here too.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b, int hq,
                                      int hkv, int sq, int skv, int d,
                                      float scale, int causal, int is_bf16,
                                      void* stream) {
  if (d < 1 || d > 256 || hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1 ||
      b < 1 || hq > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<true>(q, k, v, out, b, hq, hkv, sq, skv, d, scale,
                               causal, s)
              : dispatch<false>(q, k, v, out, b, hq, hkv, sq, skv, d, scale,
                                causal, s);
  return static_cast<int>(err);
}
