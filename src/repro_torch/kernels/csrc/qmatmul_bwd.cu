// The gradient of the int8 quantized matmul's scales and bias, for Hopper
// (sm_90a), on the int8 tensor cores.
//
// Replaces: no Pallas kernel.  The reference trains under --quant int8
// through XLA's autodiff of its qmatmul chain (src/repro/kernels/ref.py:32
// qmatmul_ref, the forward of src/repro/kernels/qmatmul.py:104
// qmatmul_pallas): the int8 payloads are constants, so the gradients are
// those of the scales and the bias.  With acc = sum_k A[m,k] B[k,n]
// (exact int32), y0 = acc * sa[m], pre = fma(y0, sb[n], bias[n]) (or
// y0 * sb[n]) as the forward (qmatmul.cu) computes it, and the optional
// table epilogue epi (apply_table.cuh):
//   dpre     = dout                                  (no table)
//            = table_bwd(pre, dout)                  (ungated table)
//            = fma(dout, z, table_bwd(pre, dout * pre))  (gated, z = T(pre))
//   dsa[m]   = sum_n (dpre * sb[n]) * acc
//   dsb[n]   = sum_m dpre * y0
//   dbias[n] = sum_m dpre
// each product as XLA's transposes form it; the plain version is
// repro_torch.kernels.ref.qmatmul_bwd_plain (the same products, summed in
// another order: the card's check holds the two within an f32 bound).
//
// What bounds it on the H100: operations.  It recomputes acc, 2 M N K int8
// operations, against M K + K N + 2-4 M N bytes; at gemma-2b's training
// shapes (M 2048 tokens, K 2048, N up to 16384) that is ~100-200
// operations a byte, near the int8 tensor cores' balance (~590).
//
// What the design does about it (a simple first kernel, right before
// fast):
//  * pass 1, a grid of 64 x 64 output tiles, 4 warps a tile, 16 rows each:
//    acc recomputed on mma.sync m16n8k32 s8 x s8 -> s32 over K in steps
//    of 32 bytes, A and B staged through shared memory with plain loads (B
//    transposed to k-contiguous columns by byte permutes as it is
//    staged), rows padded to 48 bytes so a warp's fragment reads hit 32
//    distinct banks;
//  * the epilogue forms pre and dpre bitwise the forward's and the plain
//    version's (explicit round-to-nearest intrinsics, nothing contracted),
//    then reduces in a fixed order: a row's 64 columns over the 4 lanes of
//    a quad (shuffles), a column's 64 rows over the warp's 8 row groups
//    (shuffles), then the 4 warps in order (shared memory);
//  * the tile sums go to f32 partial buffers, (N tiles, M) and (M tiles,
//    N); pass 2 sums each output's partials in tile order.  No atomics:
//    the result is the same bits on every launch, as the flash backward's
//    split sum (flash_attention_bwd.cu).
// Not yet done: a cp.async or TMA ring, wgmma, and the forward's saved
// accumulator (recomputing it costs what the forward's products cost).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "apply_table.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32;   // output tile; K bytes a step
constexpr int THREADS = 128;               // 4 warps of 16 rows
constexpr int LDS = 48;                    // padded row of a staged tile
constexpr int RED_THREADS = 256;

struct BwdArgs {
  const int8_t* A;
  const int8_t* B;
  const float* sa;
  const float* sb;
  const float* bias;
  const float* table;
  const void* dout;
  float* part_m;   // (n_tiles, M) row partials of dsa
  float* part_n;   // (m_tiles, N) column partials of dsb
  float* part_b;   // (m_tiles, N) column partials of dbias (with a bias)
  int M, N, K;
  int table_n;
  float lo, step_inv;
  int indexing, gated, dout_bf16;
};

__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 4 x 4 bytes: r[j] holds row j (4 columns); c[i] gets column i (4 rows),
// row j in byte j
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4],
                                           uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// the first `valid` (<= 4) bytes at p, the rest zero
__device__ __forceinline__ uint32_t load4(const int8_t* p, int valid,
                                          bool aligned) {
  if (valid >= 4 && aligned) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t w = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < valid) w |= (uint32_t)(uint8_t)p[j] << (8 * j);
  return w;
}

__device__ __forceinline__ float dout_at(const BwdArgs& p, size_t i) {
  return p.dout_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.dout)[i])
             : static_cast<const float*>(p.dout)[i];
}

// grid (N tiles, M tiles)
__global__ void __launch_bounds__(THREADS)
qmm_bwd_partials_kernel(BwdArgs p) {
  __shared__ __align__(16) int8_t sA[BM * LDS];
  __shared__ __align__(16) int8_t sB[BN * LDS];   // [n][k]: B^T's tile
  __shared__ float red_n[4][BN];
  __shared__ float red_b[4][BN];
  extern __shared__ float tab[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  for (int i = tid; i < p.table_n; i += THREADS) tab[i] = p.table[i];

  int acc[8][4];
#pragma unroll
  for (int f = 0; f < 8; ++f)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[f][c] = 0;

  const bool a_al = p.K % 16 == 0 && (uintptr_t)p.A % 16 == 0;
  const bool b_al = p.N % 4 == 0 && (uintptr_t)p.B % 4 == 0;
  const int ar = tid >> 1, ah = tid & 1;     // A: a row's 16-byte half
  const int kq = tid >> 4, nq = tid & 15;    // B: 4 k rows x 4 columns
  for (int k0 = 0; k0 < p.K; k0 += BK) {
    {
      const int m = m0 + ar, kk = k0 + 16 * ah;
      const int valid = m < p.M ? max(0, min(16, p.K - kk)) : 0;
      const int8_t* src = p.A + (size_t)m * p.K + kk;
      uint4 v;
      if (valid == 16 && a_al) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        v.x = load4(src, valid, false);
        v.y = load4(src + 4, valid - 4, false);
        v.z = load4(src + 8, valid - 8, false);
        v.w = load4(src + 12, valid - 12, false);
      }
      *reinterpret_cast<uint4*>(sA + ar * LDS + 16 * ah) = v;
    }
    {
      const int n = n0 + 4 * nq;
      const int vn = max(0, min(4, p.N - n));
      uint32_t r[4], c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + 4 * kq + j;
        r[j] = (k < p.K && vn > 0)
                   ? load4(p.B + (size_t)k * p.N + n, vn, b_al)
                   : 0u;
      }
      transpose4(r, c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<uint32_t*>(sB + (4 * nq + i) * LDS + 4 * kq) = c[i];
    }
    __syncthreads();
    const int8_t* ap = sA + (16 * warp + g) * LDS + 4 * t;
    const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ap);
    const uint32_t a1 = *reinterpret_cast<const uint32_t*>(ap + 8 * LDS);
    const uint32_t a2 = *reinterpret_cast<const uint32_t*>(ap + 16);
    const uint32_t a3 = *reinterpret_cast<const uint32_t*>(ap + 8 * LDS + 16);
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      const int8_t* bp = sB + (8 * f + g) * LDS + 4 * t;
      mma_s8(acc[f], a0, a1, a2, a3, *reinterpret_cast<const uint32_t*>(bp),
             *reinterpret_cast<const uint32_t*>(bp + 16));
    }
    __syncthreads();
  }

  // the epilogue: lane (g, t) holds rows g, g + 8 of the warp's 16 and
  // columns 8f + 2t + e of the tile
  float rows[2] = {0.f, 0.f};
  float col_n[8][2], col_b[8][2];
#pragma unroll
  for (int f = 0; f < 8; ++f)
    col_n[f][0] = col_n[f][1] = col_b[f][0] = col_b[f][1] = 0.f;
#pragma unroll
  for (int f = 0; f < 8; ++f) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int h = c >> 1, e = c & 1;
      const int m = m0 + 16 * warp + g + 8 * h, n = n0 + 8 * f + 2 * t + e;
      if (m >= p.M || n >= p.N) continue;
      const float accf = (float)acc[f][c];
      const float sbn = p.sb[n];
      const float y0 = __fmul_rn(accf, p.sa[m]);
      const float pre = p.bias != nullptr ? __fmaf_rn(y0, sbn, p.bias[n])
                                          : __fmul_rn(y0, sbn);
      const float d = dout_at(p, (size_t)m * p.N + n);
      float dpre = d;
      if (p.table_n > 0) {
        if (p.gated) {
          const float z = apply_table(pre, tab, p.table_n, p.lo, p.step_inv,
                                      p.indexing, 0);
          dpre = __fmaf_rn(d, z, table_bwd(pre, __fmul_rn(d, pre), tab,
                                           p.table_n, p.lo, p.step_inv,
                                           p.indexing));
        } else {
          dpre = table_bwd(pre, d, tab, p.table_n, p.lo, p.step_inv,
                           p.indexing);
        }
      }
      rows[h] = __fadd_rn(rows[h], __fmul_rn(__fmul_rn(dpre, sbn), accf));
      col_n[f][e] = __fadd_rn(col_n[f][e], __fmul_rn(dpre, y0));
      col_b[f][e] = __fadd_rn(col_b[f][e], dpre);
    }
  }
  // a row's sum over the quad's 4 lanes
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = rows[h];
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
    const int m = m0 + 16 * warp + g + 8 * h;
    if (t == 0 && m < p.M) p.part_m[(size_t)blockIdx.x * p.M + m] = v;
  }
  // a column's sum over the warp's 8 row groups, then over the 4 warps
#pragma unroll
  for (int f = 0; f < 8; ++f) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float vn = col_n[f][e], vb = col_b[f][e];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        vn = __fadd_rn(vn, __shfl_xor_sync(0xffffffffu, vn, off));
        vb = __fadd_rn(vb, __shfl_xor_sync(0xffffffffu, vb, off));
      }
      if (g == 0) {
        red_n[warp][8 * f + 2 * t + e] = vn;
        red_b[warp][8 * f + 2 * t + e] = vb;
      }
    }
  }
  __syncthreads();
  if (tid < BN && n0 + tid < p.N) {
    float vn = red_n[0][tid], vb = red_b[0][tid];
#pragma unroll
    for (int w = 1; w < 4; ++w) {
      vn = __fadd_rn(vn, red_n[w][tid]);
      vb = __fadd_rn(vb, red_b[w][tid]);
    }
    p.part_n[(size_t)blockIdx.y * p.N + n0 + tid] = vn;
    if (p.part_b != nullptr)
      p.part_b[(size_t)blockIdx.y * p.N + n0 + tid] = vb;
  }
}

// out[i] = sum over tiles j, in order, of part[j * len + i]; blockIdx.y
// picks dsa, dsb or dbias
struct Sum {
  const float* part;
  float* out;
  int tiles, len;
};

__global__ void __launch_bounds__(RED_THREADS)
qmm_bwd_reduce_kernel(Sum s0, Sum s1, Sum s2) {
  const Sum s = blockIdx.y == 0 ? s0 : (blockIdx.y == 1 ? s1 : s2);
  const int i = blockIdx.x * RED_THREADS + threadIdx.x;
  if (s.out == nullptr || i >= s.len) return;
  float v = 0.f;
  for (int j = 0; j < s.tiles; ++j)
    v = __fadd_rn(v, s.part[(size_t)j * s.len + i]);
  s.out[i] = v;
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// A (M, K) int8, B (K, N) int8, row-major; sa (M), sb (N), bias (N or
// null), table (table_n f32 or none) as the forward's; dout (M, N) f32 or
// bf16 (dout_bf16).  part_m holds ceil(N / 64) x M floats, part_n and
// part_b (null without a bias) ceil(M / 64) x N.  Writes dsa (M), dsb (N)
// and dbias (N, null without a bias).  Two launches: the partials, their
// sums.
extern "C" int qmatmul_bwd_launch(const void* A, const void* B,
                                  const void* sa, const void* sb,
                                  const void* bias, const void* table,
                                  const void* dout, void* part_m,
                                  void* part_n, void* part_b, void* dsa,
                                  void* dsb, void* dbias, int M, int N, int K,
                                  int table_n, float lo, float step_inv,
                                  int indexing, int gated, int dout_bf16,
                                  void* stream) {
  if (M < 1 || N < 1 || K < 1 || table_n < 0 || table_n > 8192)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BwdArgs p{static_cast<const int8_t*>(A), static_cast<const int8_t*>(B),
            static_cast<const float*>(sa), static_cast<const float*>(sb),
            static_cast<const float*>(bias), static_cast<const float*>(table),
            dout, static_cast<float*>(part_m), static_cast<float*>(part_n),
            static_cast<float*>(part_b), M, N, K, table_n, lo, step_inv,
            indexing, gated, dout_bf16};
  const int n_tiles = (N + BN - 1) / BN, m_tiles = (M + BM - 1) / BM;
  const size_t smem = (size_t)table_n * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmm_bwd_partials_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  qmm_bwd_partials_kernel<<<dim3(n_tiles, m_tiles), THREADS, smem, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const Sum s0{static_cast<const float*>(part_m), static_cast<float*>(dsa),
               n_tiles, M};
  const Sum s1{static_cast<const float*>(part_n), static_cast<float*>(dsb),
               m_tiles, N};
  const Sum s2{static_cast<const float*>(part_b), static_cast<float*>(dbias),
               m_tiles, bias != nullptr ? N : 0};
  const int len = M > N ? M : N;
  qmm_bwd_reduce_kernel<<<dim3((len + RED_THREADS - 1) / RED_THREADS, 3),
                          RED_THREADS, 0, st>>>(s0, s1, s2);
  return static_cast<int>(cudaGetLastError());
}
