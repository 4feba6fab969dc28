// int8 x int8 -> int32 quantized matmul with the fused dequantize / bias /
// LUT-activation epilogue, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/qmatmul.py:104 qmatmul_pallas (the Pallas
// body is _kernel at :60).  Same contract: A (M, K) int8 row-major,
// B (K, N) int8 row-major, exact int32 accumulation over K, then
//   y = acc.f32 * sa[m] * sb[n]   (in that order, as qmatmul.py:82;
//                                  with a bias, fma(acc.f32 * sa[m],
//                                  sb[n], bias[n]), as XLA compiles
//                                  qmatmul.py:82-84)
//   y = table(y) or y * table(y)  (optional, apply_table of
//                                  lut_activation.py:36, shared with the
//                                  lut_activation kernel through
//                                  apply_table.cuh; step_inv comes from
//                                  the host, as qmatmul.py:87)
// cast to f32 or bf16 (round to nearest even).
//
// What bounds it on the H100: bytes.  On the serving path M is the token
// count (8 at decode, 128 for a prefill chunk) while K x N is a whole
// weight matrix (4.2 MB to 33.5 MB of int8), so the kernel does ~2*M
// int8 operations per weight byte read -- far below the ~590 ops/byte
// at which the int8 tensor cores (1979 TOPS) would overtake HBM
// (3.35 TB/s).  Reading each weight byte once, at full width, is all
// that matters; the int8 payload is what halves the bytes against bf16.
//
// What the design does about it: each block owns a BN=64 column strip
// and walks K in 64-byte tiles, so every weight byte is read from HBM
// exactly once, with 4-byte vector loads (coalesced 64-byte segments per
// K row).  When the output has too few column strips to fill the card
// (decode: N = 2048 gives 32 blocks for 132 SMs), K is split over
// `splitk` blocks per tile: each adds its int32 partial sums into a
// workspace with atomicAdd -- integer addition, so the total is exact
// and independent of order -- and the last block of the tile (counted
// with a fence and an atomic ticket) applies the epilogue and zeroes the
// workspace and its ticket for the next launch.  A tile of B is
// transposed in registers (4x4 byte blocks) into shared memory so that
// __dp4a can multiply four K values at a time; A rows are K-contiguous
// already.  For decode (M <= 16) the block is
// 16 rows high so no thread computes rows that cannot exist.  The
// epilogue runs on the int32 accumulator in registers, with the table in
// shared memory: the (M, N) f32 intermediate never reaches HBM.  The
// epilogue uses __fmul_rn/__fmaf_rn so that nvcc contracts nothing on
// its own: the op order is the reference's, so the f32 output is bitwise
// the plain version's (repro_torch.kernels.ref.qmatmul_ref, whose table
// epilogue indexes with the same (y - lo) * step_inv).
// Ragged M, N and K are masked here (zero-filled loads, guarded stores);
// the wrapper pads nothing.  Not yet done (a later change): int8
// tensor-core MMA, TMA multi-stage pipelining.  The workspace is shared
// by all launches on one device, so launches must not run concurrently
// on two streams (the engine uses one).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "apply_table.cuh"

namespace {

constexpr int BN = 64;           // output columns per block
constexpr int BK = 64;           // K bytes per tile
constexpr int KW = BK / 4;       // int32 words of K per tile
constexpr int THREADS = 256;     // 16 x 16 thread grid

// Four consecutive int8 values of a row, zero past `limit`; one 4-byte
// load when the row is 4-aligned and wholly inside.
__device__ __forceinline__ uint32_t load4(const int8_t* p, int col, int limit,
                                          bool vec) {
  if (vec && col + 4 <= limit) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (col + j < limit) v |= (uint32_t)(uint8_t)p[j] << (8 * j);
  return v;
}

template <int BM>
__global__ void __launch_bounds__(THREADS)
qmatmul_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
               const float* __restrict__ sa, const float* __restrict__ sb,
               const float* __restrict__ bias,
               const float* __restrict__ table, void* __restrict__ out,
               int M, int N, int K, bool vecA, bool vecB, int table_n,
               float lo, float step_inv, int indexing, int gated,
               int out_bf16, int splitk, int* __restrict__ ws,
               unsigned* __restrict__ tickets) {
  constexpr int TM = BM / 16;   // rows per thread
  constexpr int TN = BN / 16;   // columns per thread
  __shared__ uint32_t As[BM][KW + 1];
  // B tile transposed: Bs[n][w] packs B[4w .. 4w+3][n] for __dp4a
  __shared__ uint32_t Bs[BN][KW + 1];
  extern __shared__ float tab[];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  for (int i = tid; i < table_n; i += THREADS) tab[i] = table[i];

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  // this block's share of K, in whole tiles
  const int ktiles = (K + BK - 1) / BK;
  const int per = (ktiles + splitk - 1) / splitk;
  const int k_begin = blockIdx.z * per * BK;
  const int k_end = min(K, k_begin + per * BK);

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // A tile: BM rows x KW words, K-contiguous as stored
    for (int idx = tid; idx < BM * KW; idx += THREADS) {
      const int r = idx / KW, w = idx % KW;
      const int gm = m0 + r, gk = k0 + 4 * w;
      uint32_t v = 0;
      if (gm < M && gk < K) v = load4(A + (size_t)gm * K + gk, gk, K, vecA);
      As[r][w] = v;
    }
    // B tile: each thread loads a 4 (k) x 4 (n) byte block and transposes
    // it so that each word holds four k values of one column
    {
      const int kq = tid / 16, nq = tid % 16;
      const int gk = k0 + 4 * kq, gn = n0 + 4 * nq;
      uint32_t row[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        row[j] = 0;
        if (gk + j < K && gn < N)
          row[j] = load4(B + (size_t)(gk + j) * N + gn, gn, N, vecB);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int sh = 8 * c;
        Bs[4 * nq + c][kq] = ((row[0] >> sh) & 0xffu)
                           | (((row[1] >> sh) & 0xffu) << 8)
                           | (((row[2] >> sh) & 0xffu) << 16)
                           | (((row[3] >> sh) & 0xffu) << 24);
      }
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      int a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = (int)As[ty + 16 * i][w];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = (int)Bs[tx + 16 * j][w];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (splitk > 1) {
    // exact int32 reduction over the K splits; the last block finishes
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tx + 16 * j;
        if (m < M && n < N) atomicAdd(ws + (size_t)m * N + n, acc[i][j]);
      }
    }
    __threadfence();
    __syncthreads();
    __shared__ bool last;
    const unsigned tile = blockIdx.y * gridDim.x + blockIdx.x;
    if (tid == 0) last = atomicAdd(tickets + tile, 1u) == (unsigned)(splitk - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tx + 16 * j;
        // read the total and leave the workspace zeroed for the next launch
        if (m < M && n < N) acc[i][j] = atomicExch(ws + (size_t)m * N + n, 0);
      }
    }
    if (tid == 0) tickets[tile] = 0u;
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const float sam = sa[m];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      // with a bias, one rounding for the last product and the sum:
      // XLA compiles the reference's acc * sa * sb + bias into this FMA
      const float y0 = __fmul_rn((float)acc[i][j], sam);
      float y = bias != nullptr ? __fmaf_rn(y0, sb[n], bias[n])
                                : __fmul_rn(y0, sb[n]);
      if (table_n > 0)
        y = apply_table(y, tab, table_n, lo, step_inv, indexing, gated);
      const size_t o = (size_t)m * N + n;
      if (out_bf16)
        reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
      else
        reinterpret_cast<float*>(out)[o] = y;
    }
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Pointers may be null for bias (no bias) and table (table_n == 0).
// splitk > 1 needs ws (M*N int32) and tickets (one per output tile), both
// zero on entry; the kernel leaves them zero.
extern "C" int qmatmul_launch(const void* a, const void* b, const void* sa,
                              const void* sb, const void* bias,
                              const void* table, void* out, int M, int N,
                              int K, int table_n, float lo, float step_inv,
                              int indexing, int gated, int out_bf16,
                              int splitk, void* ws, void* tickets,
                              void* stream) {
  const bool vecA = (K % 4 == 0) && ((uintptr_t)a % 4 == 0);
  const bool vecB = (N % 4 == 0) && ((uintptr_t)b % 4 == 0);
  const size_t smem = (size_t)table_n * sizeof(float);
  const dim3 block(THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const int8_t*>(a);
  const auto* Bp = static_cast<const int8_t*>(b);
  const auto* SA = static_cast<const float*>(sa);
  const auto* SB = static_cast<const float*>(sb);
  const auto* BI = static_cast<const float*>(bias);
  const auto* T = static_cast<const float*>(table);
  auto* WS = static_cast<int*>(ws);
  auto* TK = static_cast<unsigned*>(tickets);
  if (M <= 16) {
    const dim3 grid((N + BN - 1) / BN, (M + 15) / 16, splitk);
    qmatmul_kernel<16><<<grid, block, smem, s>>>(
        A, Bp, SA, SB, BI, T, out, M, N, K, vecA, vecB, table_n, lo,
        step_inv, indexing, gated, out_bf16, splitk, WS, TK);
  } else {
    const dim3 grid((N + BN - 1) / BN, (M + 63) / 64, splitk);
    qmatmul_kernel<64><<<grid, block, smem, s>>>(
        A, Bp, SA, SB, BI, T, out, M, N, K, vecA, vecB, table_n, lo,
        step_inv, indexing, gated, out_bf16, splitk, WS, TK);
  }
  return static_cast<int>(cudaGetLastError());
}
