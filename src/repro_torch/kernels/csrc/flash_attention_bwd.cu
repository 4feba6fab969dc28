// The backward of cache-free flash attention (FA2 shape), for Hopper
// (sm_90a), on the CUDA cores in f32.
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
// What bounds it on the H100: operations, 10 * pairs * D flops per query
// head (the five products) against 4 * (Sq + Skv) * D elements moved; this
// first version runs them on the CUDA cores (67 TFLOP/s f32), far from the
// tensor cores' bound.  Tensor cores (wgmma) are later work.
//
// Design, three kernels in one launch function, deterministic (no atomics:
// every sum runs in a fixed order, two launches give the same bits):
//  * delta: one warp per query row, lanes over D, a fixed shuffle tree;
//  * dk/dv: one block of 16 x 16 threads per (32-row KV tile, KV head,
//    batch).  The tile's K and V stay in shared memory; the block walks the
//    group's query heads and, for each, every 32-row Q tile that can see
//    the KV tile (causal: from the first row at or past the tile's first
//    key), staging Q (scaled) and do, computing p and ds for the 32 x 32
//    pairs (each thread 2 x 2) into shared memory, then adding p^T do and
//    ds^T q into its 2 rows x DJ columns of dk and dv, held in registers.
//    The accumulators of a 32-row tile at D 256 are 64 floats a thread,
//    so gemma's D 256 with one KV head (MQA) fits without spilling the
//    sums to shared memory; the shared tiles (K, V, Q, do, rows padded to
//    16 DJ + 1 floats, and p, ds) take 140 KB at D 256, above the 48 KB
//    static limit, so the launch raises the dynamic shared-memory limit;
//  * dq: one block per (32-row Q tile, query head, batch), Q, do, lse and
//    delta staged once, walking the visible KV tiles (causal: up to the
//    tile's last row), recomputing p and ds, dq in registers;
//  * rows past Sq or Skv and columns past D are 0 in shared memory and
//    never read from device memory; outputs past them are not written.
//    MLA's V, zero-padded by the caller to the q/k width, gets a dv whose
//    padded columns are sums of do's padded columns, which the caller's
//    slice leaves 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 32;        // query rows per tile
constexpr int BK = 32;        // key rows per tile
constexpr int TY = 16, TX = 16;
constexpr int THREADS = TY * TX;
constexpr int RI = BQ / TY;   // tile rows per thread (2)
constexpr int CJ = BK / TX;   // tile columns per thread (2)
constexpr int LDP = BK + 1;   // p / ds rows

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// shared floats of one block: four tiles of 32 rows x (16 DJ + 1), p and
// ds tiles, lse and delta of the Q tile
__host__ __device__ inline size_t smem_floats(int dj) {
  return (size_t)4 * 32 * (16 * dj + 1) + 2 * (size_t)BQ * LDP + 2 * BQ;
}

// rows [row0, row0 + 32) of a (nrows, d) slab into a 32 x ld f32 tile,
// times mul; rows past nrows and columns past d are 0 (never read)
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0,
                                      int nrows, int d, int ld, float mul) {
  for (int i = threadIdx.x; i < 32 * (ld - 1); i += THREADS) {
    const int r = i / (ld - 1), c = i - r * (ld - 1);
    float x = 0.f;
    if (row0 + r < nrows && c < d)
      x = __fmul_rn(to_f(src[(size_t)(row0 + r) * d + c]), mul);
    dst[r * ld + c] = x;
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                           float* __restrict__ delta, long long rows, int d) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* orow = o + row * d;
  const T* drow = dout + row * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32)
    acc = fmaf(to_f(drow[c]), to_f(orow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) delta[row] = acc;
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

template <typename T, int DJ>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int hq,
                          int group, int sq, int skv, int d, float scale,
                          int causal) {
  extern __shared__ float smem[];
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
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, bb = blockIdx.z;
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
  const int first = causal ? max(0, k0 - q_off) : 0;
  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const size_t rbase = ((size_t)bb * hq + h) * sq;
    for (int q0 = (first / BQ) * BQ; q0 < sq; q0 += BQ) {
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
  }

#pragma unroll
  for (int jr = 0; jr < RI; ++jr) {
    const int row = k0 + ty + TY * jr;
    if (row >= skv) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int c = tx + TX * jj;
      if (c >= d) continue;
      put(dk + kbase + (size_t)row * d + c, acc_k[jr][jj]);
      put(dv + kbase + (size_t)row * d + c, acc_v[jr][jj]);
    }
  }
}

template <typename T, int DJ>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int hq, int group, int sq, int skv, int d,
                        float scale, int causal) {
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
      put(dq + (rbase + r) * d + c, __fmul_rn(acc[i][jj], scale));
    }
  }
}

template <typename T, int DJ>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const float* lse, const void* dout,
                   void* dq, void* dk, void* dv, float* delta, int b, int hq,
                   int hkv, int sq, int skv, int d, float scale, int causal,
                   cudaStream_t s) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const long long rows = (long long)b * hq * sq;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const T*>(o), tdo, delta, rows, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = smem_floats(DJ) * sizeof(float);
  auto kv_kern = flash_bwd_dkdv_kernel<T, DJ>;
  auto q_kern = flash_bwd_dq_kernel<T, DJ>;
  err = cudaFuncSetAttribute(
      kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int group = hq / hkv;
  kv_kern<<<dim3((skv + BK - 1) / BK, hkv, b), THREADS, smem, s>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      hq, group, sq, skv, d, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q_kern<<<dim3((sq + BQ - 1) / BQ, hq, b), THREADS, smem, s>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), hq, group, sq, skv,
      d, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* o, const float* lse, const void* dout,
                     void* dq, void* dk, void* dv, float* delta, int b,
                     int hq, int hkv, int sq, int skv, int d, float scale,
                     int causal, cudaStream_t s) {
  if (d <= 64)
    return launch<T, 4>(q, k, v, o, lse, dout, dq, dk, dv, delta, b, hq, hkv,
                        sq, skv, d, scale, causal, s);
  if (d <= 128)
    return launch<T, 8>(q, k, v, o, lse, dout, dq, dk, dv, delta, b, hq, hkv,
                        sq, skv, d, scale, causal, s);
  if (d <= 192)
    return launch<T, 12>(q, k, v, o, lse, dout, dq, dk, dv, delta, b, hq,
                         hkv, sq, skv, d, scale, causal, s);
  return launch<T, 16>(q, k, v, o, lse, dout, dq, dk, dv, delta, b, hq, hkv,
                       sq, skv, d, scale, causal, s);
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, o, dout, dq (b, hq, sq, d); k, v, dk, dv (b, hkv, skv, d); lse and
// delta (b, hq, sq) f32 (delta is scratch the launch writes); all
// contiguous, all bf16 (is_bf16) or all f32.  Three kernels on the stream:
// delta, dk/dv, dq.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, int b, int hq, int hkv, int sq, int skv, int d, float scale,
    int causal, int is_bf16, void* stream) {
  if (d < 1 || d > 256 || hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1 ||
      b < 1 || hq > 65535 || b > 65535 || hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaError_t err =
      is_bf16 ? launch_d<bf16>(q, k, v, o, l, dout, dq, dk, dv, dl, b, hq,
                               hkv, sq, skv, d, scale, causal, s)
              : launch_d<float>(q, k, v, o, l, dout, dq, dk, dv, dl, b, hq,
                                hkv, sq, skv, d, scale, causal, s);
  return static_cast<int>(err);
}
