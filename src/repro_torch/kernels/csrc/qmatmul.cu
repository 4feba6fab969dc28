// int8 x int8 -> int32 quantized matmul with the fused dequantize / bias /
// LUT-activation epilogue, for Hopper (sm_90a), on the int8 tensor cores.
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
// What bounds it on the H100: bytes on the serving path.  M is the token
// count (8 at decode, 40 a verify pass, 128 for a prefill chunk) while
// K x N is a whole weight matrix (0.5 MB to 33.5 MB of int8), so the
// kernel does ~2*M int8 operations per weight byte -- far below the ~590
// ops/byte at which the int8 tensor cores (1979 TOPS) would overtake HBM
// (3.35 TB/s).  Only whisper's encoder (M 12000) and the VLM's image (M
// 12808) come near the operations bound.
//
// Three instances, chosen by the wrapper's plan (kernels/qmatmul.py,
// qmatmul_plan: the tiles, the split and the ring, from the shape and the
// SM count):
//  * the weight stream (M <= 64) and wgmma (M > 64): the TMA instances
//    (tq::qmm_tma_kernel, below): a producer thread keeps a ring of W and
//    X tiles in flight on mbarriers; products on the int8 tensor cores,
//    out^T = W^T X^T with the weights as the rows, taken from the weight
//    tiles through a 4 x 4 byte transpose, so the (K, N) parameters need
//    no pre-packed copy;
//  * the control, the parent kernel (qmatmul_kernel) for what TMA cannot
//    address: K or N not a multiple of 16 (the jet's N 5), operands that
//    are not 16-byte aligned.  The card's checks run it beside the
//    others, bitwise.
// Common to all:
//  * exact int32 sums: |acc| <= 128^2 * 16384 < 2^31, so the order of the
//    K sum does not matter and no .satfinite is needed;
//  * split-K when the output tiles cannot fill the card: `splitk` blocks
//    share a tile's K range and add their int32 partial sums into a
//    workspace with atomicAdd -- integer addition, so the total is exact
//    and independent of order -- and the last block of the tile (counted
//    with a fence and an atomic ticket) applies the epilogue and zeroes
//    the workspace and its ticket for the next launch;
//  * the epilogue runs on the int32 accumulator in registers, the table in
//    shared memory: the (M, N) f32 intermediate never reaches HBM.  It uses
//    __fmul_rn/__fmaf_rn so that nvcc contracts nothing on its own: the op
//    order is the reference's, so the output is bitwise the plain
//    version's (repro_torch.kernels.ref.qmatmul_ref, whose table epilogue
//    indexes with the same (y - lo) * step_inv).
// The control kernel: mma.sync m16n8k32 s8 x s8 -> s32 on a ring of
// shared-memory stages (128 K bytes each at decode, 64 otherwise) filled
// by 16-byte cp.async, each thread copying fixed chunk slots of every
// stage; zero-filled cp.async (src-size 0) masks the ragged M, N and K
// edges, and a row that is not 16-byte aligned stages with plain byte
// loads.  A rows are K-contiguous, so ldmatrix (b16) yields mma's A
// fragment.  B is stored (K, N), N-contiguous, while mma wants four
// consecutive k of one column in a register: each lane reads four 32-bit
// words (4 k rows x 4 columns) and transposes the 4 x 4 bytes with eight
// byte permutes (prmt), which gives four columns' k quads; B rows are
// XOR-swizzled by 16-byte chunk so those reads are free of bank
// conflicts.  Two tilings, chosen on M: M <= 16 (decode) the weights take
// mma's 16-row side, tokens its 8 columns (one or two n8 tiles), 8 warps
// on 128 columns with 6 stages of 16 KB; M > 16 a 128 x 128 block tile,
// 8 warps of 64 x 32, 4 stages; M > 16 writes each lane's 8 consecutive
// outputs with 16-byte stores.
// The workspace is per stream (the wrapper's zeroed scratch), so launches
// on two streams never share it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "apply_table.cuh"
#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;     // 8 warps
constexpr int KW = THREADS / 128; // decode: k-warp groups (4 warps span BN)
constexpr int BN = 128;          // output columns per block (bytes of a B row)
constexpr int MAX_TABLE = 8192;  // the wrapper's limit (qmatmul.py)

struct Args {
  const int8_t* A;
  const int8_t* B;
  const float* sa;
  const float* sb;
  const float* bias;
  const float* table;
  void* out;
  int M, N, K;
  int vecA, vecB, vec_out;
  int table_n;
  float lo, step_inv;
  int indexing, gated, out_bf16, splitk;
  int* ws;
  unsigned* tickets;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16 bytes at `src` (the first `bytes` of them, the rest zero) into
// shared memory: one cp.async when the rows are 16-byte aligned (`vec`),
// else byte loads.
__device__ __forceinline__ void load_chunk(int8_t* dst, const int8_t* src,
                                           int bytes, bool vec) {
  if (vec) {
    cp_async16(dst, src, bytes);
    return;
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (j < bytes) w[j >> 2] |= (uint32_t)(uint8_t)src[j] << (8 * (j & 3));
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// B's 16-byte chunk c of stage row k sits at chunk c ^ swz(k): the four k
// quads a warp reads at once land in distinct banks
__device__ __forceinline__ int b_chunk(int k, int c) {
  return c ^ (2 * ((k >> 2) & 3));
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

// The warp's 32 columns x 32 k of a B stage, from k row kk: lane (g, tig)
// gets t[q][i] = B[kk + 16q + 4tig .. +3][32 wn + 4g + i], k in byte order
__device__ __forceinline__ void load_b_frag(const int8_t* Bs, int kk, int wn,
                                            int lane, uint32_t (&t)[2][4]) {
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    uint32_t r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = kk + 16 * q + 4 * tig + j;
      r[j] = *reinterpret_cast<const uint32_t*>(
          Bs + k * BN + b_chunk(k, 2 * wn + (g >> 2)) * 16 + (g & 3) * 4);
    }
    transpose4(r, t[q]);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The reference's epilogue on one int32 sum, op for op
__device__ __forceinline__ float epilogue(const Args& p, const float* tab,
                                          int acc, float sam, int n) {
  // with a bias, one rounding for the last product and the sum: XLA
  // compiles the reference's acc * sa * sb + bias into this FMA
  const float y0 = __fmul_rn((float)acc, sam);
  float y = p.bias != nullptr ? __fmaf_rn(y0, p.sb[n], p.bias[n])
                              : __fmul_rn(y0, p.sb[n]);
  if (p.table_n > 0)
    y = apply_table(y, tab, p.table_n, p.lo, p.step_inv, p.indexing,
                    p.gated);
  return y;
}

// The same operations with the column's scale and bias given (the TMA
// instances read them from shared memory)
__device__ __forceinline__ float epilogue_at(const Args& p, const float* tab,
                                             int acc, float sam, float sbn,
                                             float biasn) {
  const float y0 = __fmul_rn((float)acc, sam);
  float y = p.bias != nullptr ? __fmaf_rn(y0, sbn, biasn)
                              : __fmul_rn(y0, sbn);
  if (p.table_n > 0)
    y = apply_table(y, tab, p.table_n, p.lo, p.step_inv, p.indexing,
                    p.gated);
  return y;
}

// Accumulators per thread: decode 2 m16 tiles (of weight columns) x MB n8
// tiles (of tokens); otherwise 4 m16 tiles x 4 n8 tiles.  A stage holds kBK
// K bytes: the A rows (stride kALd, 16 bytes of padding against bank
// conflicts) and kBK rows of B.
template <int BM, int MB>
struct Tiling {
  static constexpr bool kDecode = BM == 16;
  static constexpr int kAcc = kDecode ? 2 * MB * 4 : 64;
  static constexpr int kBK = kDecode ? 128 : 64;
  static constexpr int kStages = kDecode ? 6 : 4;
  static constexpr int kALd = kBK + 16;
  static constexpr int kARows = kDecode ? 8 * MB : BM;   // rows multiplied
  static constexpr int kStage = BM * kALd + kBK * BN;
  static constexpr size_t kSmem = (size_t)kStages * kStage;

  // output (m, n) of accumulator idx of lane (g, tig) in warp (wm/wk, wn)
  __device__ static void coord(int idx, int lane, int warp, int m0, int n0,
                               int& m, int& n) {
    const int g = lane >> 2, tig = lane & 3, wn = warp & 3;
    const int c = idx & 3;
    if constexpr (kDecode) {     // idx = (R * MB + mb) * 4 + c
      const int R = idx / (MB * 4), mb = (idx >> 2) % MB;
      n = n0 + 32 * wn + 4 * g + 2 * R + (c >> 1);
      m = m0 + 8 * mb + 2 * tig + (c & 1);
    } else {           // idx = (i * 4 + j) * 4 + c
      const int i = idx >> 4, j = (idx >> 2) & 3;
      m = m0 + 64 * (warp >> 2) + 16 * i + g + 8 * (c >> 1);
      n = n0 + 32 * wn + 8 * tig + 4 * (c & 1) + j;
    }
  }
};

// grid (N tiles, M tiles, splitk); BM 16 (decode, MB n8 tiles of tokens)
// or 128
template <int BM, int MB>
__global__ void __launch_bounds__(THREADS)
qmatmul_kernel(Args p) {
  using T = Tiling<BM, MB>;
  extern __shared__ __align__(16) int8_t smem[];
  float* tab = reinterpret_cast<float*>(smem + T::kSmem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  for (int i = tid; i < p.table_n; i += THREADS) tab[i] = p.table[i];

  int acc[T::kAcc];
#pragma unroll
  for (int i = 0; i < T::kAcc; ++i) acc[i] = 0;

  // this block's share of K, in whole stages
  constexpr int BK = T::kBK, A_LD = T::kALd;
  const int ktiles = (p.K + BK - 1) / BK;
  const int per = (ktiles + p.splitk - 1) / p.splitk;
  const int kt0 = blockIdx.z * per;
  const int nk = max(0, min(ktiles, kt0 + per) - kt0);

  // Each thread copies fixed 16-byte chunks of every stage: B chunk column
  // bc of rows br + b_step j, A chunk column ac of rows ar + a_step j.  Past an
  // edge the copy reads nothing and zero-fills (src-size 0).
  constexpr int b_step = THREADS / 8;       // B rows per pass
  const int br = tid >> 3, bc = tid & 7;
  const int b_dst = br * BN + b_chunk(br, bc) * 16;
  const int b_bytes = max(0, min(16, p.N - (n0 + 16 * bc)));
  const int8_t* b_src = p.B + (size_t)br * p.N + n0 + 16 * bc;
  constexpr int a_cols = BK / 16, a_step = THREADS / a_cols;
  const int ar = tid / a_cols, ac = tid % a_cols;
  const int a_bytes_m = p.K - 16 * ac;      // bytes left in the row at k0 = 0
  const int8_t* a_src = p.A + (size_t)(m0 + ar) * p.K + 16 * ac;

  auto load_stage = [&](int stage, int kt) {
    int8_t* As = smem + stage * T::kStage;
    int8_t* Bs = As + BM * A_LD;
    const int k0 = kt * BK;
#pragma unroll
    for (int j = 0; j < BK / b_step; ++j) {
      const bool in = b_bytes > 0 && k0 + br + b_step * j < p.K;
      load_chunk(Bs + b_dst + b_step * j * BN,
                 in ? b_src + (size_t)(k0 + b_step * j) * p.N : p.B,
                 in ? b_bytes : 0, p.vecB);
    }
#pragma unroll
    for (int j = 0; j < (T::kARows + a_step - 1) / a_step; ++j) {
      const int r = ar + a_step * j;
      if (r < T::kARows) {
        const int bytes = m0 + r < p.M ? max(0, min(16, a_bytes_m - k0)) : 0;
        load_chunk(As + r * A_LD + 16 * ac,
                   bytes ? a_src + (size_t)a_step * j * p.K + k0 : p.A, bytes,
                   p.vecA);
      }
    }
  };

  // the ring: STAGES - 1 stages ahead of the one being multiplied
#pragma unroll
  for (int s = 0; s < T::kStages - 1; ++s) {
    if (s < nk) load_stage(s, kt0 + s);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<T::kStages - 2>();
    __syncthreads();     // stage `it` is in; stage it - 1 is free
    const int nx = it + T::kStages - 1;
    if (nx < nk) load_stage(nx % T::kStages, kt0 + nx);
    cp_async_commit();
    const int8_t* As = smem + (it % T::kStages) * T::kStage;
    const int8_t* Bs = As + BM * A_LD;
    if constexpr (T::kDecode) {
      // out^T = B^T A^T: 32 weight columns as two m16 tiles; k-warp group
      // warp / 4 takes every KW-th k32 step of the stage
#pragma unroll
      for (int kk = 32 * (warp >> 2); kk < BK; kk += 32 * KW) {
        uint32_t t[2][4];
        load_b_frag(Bs, kk, wn, lane, t);
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          const int8_t* arow = As + (8 * mb + g) * A_LD + kk + 4 * tig;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(arow);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(arow + 16);
          mma_s8(acc + mb * 4, t[0][0], t[0][1], t[1][0], t[1][1], b0, b1);
          mma_s8(acc + (MB + mb) * 4, t[0][2], t[0][3], t[1][2], t[1][3], b0,
                 b1);
        }
      }
    } else {
      const int wm = warp >> 2;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32) {
        uint32_t t[2][4];
        load_b_frag(Bs, kk, wn, lane, t);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t a[4];
          ldmatrix_x4(a, As + (64 * wm + 16 * i + (lane & 7) +
                               ((lane >> 3) & 1) * 8) * A_LD +
                              kk + (lane >> 4) * 16);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_s8(acc + (i * 4 + j) * 4, a[0], a[1], a[2], a[3], t[0][j],
                   t[1][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // decode: the k-warp groups' sums meet in shared memory
  bool active = true;
  if constexpr (T::kDecode) {
    int* red = reinterpret_cast<int*>(smem);
    if (warp >= 4) {
      const int slot = ((warp - 4) * 32 + lane) * T::kAcc;
#pragma unroll
      for (int i = 0; i < T::kAcc; ++i) red[slot + i] = acc[i];
    }
    __syncthreads();
    active = warp < 4;
    if (active) {
      for (int w = 1; w < KW; ++w) {
        const int slot = ((w * 4 + warp - 4) * 32 + lane) * T::kAcc;
#pragma unroll
        for (int i = 0; i < T::kAcc; ++i) acc[i] += red[slot + i];
      }
    }
  }

  if (p.splitk > 1) {
    // exact int32 reduction over the K splits; the last block finishes
    if (active) {
#pragma unroll
      for (int i = 0; i < T::kAcc; ++i) {
        int m, n;
        T::coord(i, lane, warp, m0, n0, m, n);
        if (m < p.M && n < p.N) atomicAdd(p.ws + (size_t)m * p.N + n, acc[i]);
      }
    }
    __threadfence();
    __syncthreads();
    __shared__ bool last;
    const unsigned tile = blockIdx.y * gridDim.x + blockIdx.x;
    if (tid == 0)
      last = atomicAdd(p.tickets + tile, 1u) == (unsigned)(p.splitk - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (active) {
#pragma unroll
      for (int i = 0; i < T::kAcc; ++i) {
        int m, n;
        T::coord(i, lane, warp, m0, n0, m, n);
        // read the total and leave the workspace zeroed for the next launch
        if (m < p.M && n < p.N)
          acc[i] = atomicExch(p.ws + (size_t)m * p.N + n, 0);
      }
    }
    if (tid == 0) p.tickets[tile] = 0u;
  }
  if (!active) return;

  if constexpr (!T::kDecode) {
    if (p.vec_out) {
      // each lane holds 8 consecutive columns of rows g and g + 8 of every
      // m16 tile: one 16-byte (bf16) or two (f32) stores per row
      const int nb = n0 + 32 * wn + 8 * tig;
      if (nb >= p.N) return;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + 64 * (warp >> 2) + 16 * i + g + 8 * h;
          if (m >= p.M) continue;
          const float sam = p.sa[m];
          float y[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            y[j] = epilogue(p, tab,
                            acc[(i * 4 + (j & 3)) * 4 + 2 * h + (j >> 2)],
                            sam, nb + j);
          const size_t o = (size_t)m * p.N + nb;
          if (p.out_bf16) {
            uint4 v;
            __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              h2[j] = __floats2bfloat162_rn(y[2 * j], y[2 * j + 1]);
            *reinterpret_cast<uint4*>(
                reinterpret_cast<__nv_bfloat16*>(p.out) + o) = v;
          } else {
            float4* dst = reinterpret_cast<float4*>(
                reinterpret_cast<float*>(p.out) + o);
            dst[0] = make_float4(y[0], y[1], y[2], y[3]);
            dst[1] = make_float4(y[4], y[5], y[6], y[7]);
          }
        }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < T::kAcc; ++i) {
    int m, n;
    T::coord(i, lane, warp, m0, n0, m, n);
    if (m >= p.M || n >= p.N) continue;
    const float y = epilogue(p, tab, acc[i], p.sa[m], n);
    const size_t o = (size_t)m * p.N + n;
    if (p.out_bf16)
      reinterpret_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(y);
    else
      reinterpret_cast<float*>(p.out)[o] = y;
  }
}

template <int BM, int MB>
cudaError_t launch(const Args& p, cudaStream_t s) {
  using T = Tiling<BM, MB>;
  static bool configured = false;     // the largest table's bytes, once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        qmatmul_kernel<BM, MB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(T::kSmem + MAX_TABLE * sizeof(float)));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, p.splitk);
  qmatmul_kernel<BM, MB><<<grid, THREADS,
                           T::kSmem + (size_t)p.table_n * sizeof(float), s>>>(
      p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The TMA instances.  A block owns NB boxes of weight columns (one
// consumer warpgroup each) by ROWS token rows, and a range of 128-byte K
// stages (its split).  Warpgroup 0's first thread is the producer: it
// keeps a ring of `stages` stages in flight, each NB W boxes (128 k rows,
// the narrow tile's 32 or 64, x 128 columns) and one X tile (ROWS rows x
// 128 k), written by TMA with
// the 128-byte swizzle on a full mbarrier, freed by the consumers' warps
// on an empty one.  Out of bounds (the M, N and K edges) TMA writes zeros.
//
// All compute out^T = W^T X^T, the weights on the products' row side, so
// that no product row is spent on absent tokens and the weights need no
// pre-packed copy: a warp's columns x 32 k of a W box become the A
// fragments of its m16 tiles through a byte transpose, read so that no two
// lanes of a load share a bank under TMA's swizzle (lanes of tig >= 2 read
// their four k rows in the order 2, 3, 0, 1 and undo it in the
// transpose's last byte permutes).
//  * KIND 0, the weight stream (M <= 64): one box of 128 columns a block,
//    mma.sync m16n8k32 with the tokens in ROWS / 8 n8 tiles read from the
//    X tile; every warp does every k32 step of its 32 columns.  Bound by
//    the weight bytes: the plan fills the card by splitting K (one box
//    measured faster than blocks of two or four: PERF.md section 6).
//  * KIND 1, wgmma (M > 64): 128 columns a box, per k32 step two wgmma
//    m64nROWSk32 (.s32.s8.s8), A the fragments above from registers, B the
//    X tile (K-major already) by descriptor.
//  * KIND 2, the narrow wgmma tile (N and K at most 64: the jet's layers):
//    64 columns a block (one m64 tile, a warp's 16 columns), the K in one
//    stage of KS k32 steps, ROWS 32 or 64 tokens, several blocks an SM, so
//    that a block's products and epilogue are not mostly padding.
// All stage their out^T sums through shared memory; rolled loops then
// add a split's partial sums with atomics on consecutive addresses (the
// tickets as in the 128-row kernel) and apply the epilogue to 8-column
// groups of a row with 16-byte stores, its scales and bias read from
// shared memory, where the consumers put them while the first stages
// load.
namespace tq {

using namespace hopper;

constexpr int BK = 128;                 // K bytes a stage
constexpr int BOX = 128;                // columns of a TMA weight box
constexpr int SMEM_MAX = 232448;        // dynamic shared memory of a block

// KS: the k32 steps a stage's products take (4; the narrow tile's one
// stage holds the whole K, zeros past it)
template <int KIND, int NB, int ROWS, int KS>
struct Geo {
  static_assert(KIND == 2 ? NB == 1 && KS <= 2 : KS == 4, "instance");
  // the weight columns a consumer owns, its m16 tiles a warp (m64 tiles
  // a warpgroup)
  static constexpr int kCols = KIND == 2 ? 64 : BOX;
  static constexpr int kT = kCols / 64;
  // a W box: 128 columns by the stage's k rows (the narrow tile's: only
  // its k32 steps, so that TMA fills no k rows past them)
  static constexpr int kWRows = 32 * KS;
  static constexpr int kWTile = kWRows * BOX;
  static constexpr int kXTile = ROWS * 128;
  static constexpr int kStage = NB * kWTile + kXTile;
  // a consumer's ROWS x kCols int32 sums staged for the epilogue, rows
  // padded by 16 bytes
  static constexpr int kLdo = kCols * 4 + 16;
  static constexpr int kStaging = NB * ROWS * kLdo;
  static constexpr int kThreads = 128 * (NB + 1);
  // the block's row scales, column scales and bias, in shared memory
  static constexpr int kVec = (ROWS + 2 * NB * kCols) * 4;
  // the producer gives registers to the consumers (setmaxnreg): wgmma
  // with two consumers, whose launch leaves them 168 a thread
  static constexpr bool kRealloc = KIND == 1 && NB == 2;
  // blocks an SM: two small weight-stream blocks; the narrow tile's
  // 128 / ROWS
  static constexpr int kMinBlocks =
      KIND == 2 ? 128 / ROWS : (KIND == 0 && ROWS <= 16 ? 2 : 1);
};

// bytes before the barriers: the ring, or the staging tiles if larger
template <class G>
__host__ __device__ __forceinline__ int ring_bytes(int stages) {
  return stages * G::kStage > G::kStaging ? stages * G::kStage : G::kStaging;
}

// the A fragments of the warp's 32 columns x 32 k of a W box from k row
// kb: f[T] for the m16 tile T, whose rows g and g + 8 are the columns
// 4g + 2T and 4g + 2T + 1 of the warp's 32
__device__ __forceinline__ void load_w_frag(const unsigned char* W, int kb,
                                            int chunk, int word, int tig,
                                            int sw, uint32_t sel_lo,
                                            uint32_t sel_hi,
                                            uint32_t (&f)[2][4]) {
  uint32_t t[2][4];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    uint32_t r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = kb + 16 * q + 4 * tig + (j ^ sw);
      r[j] = *reinterpret_cast<const uint32_t*>(
          W + k * 128 + ((chunk ^ (k & 7)) << 4) + word);
    }
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
    t[q][0] = __byte_perm(t0, t2, sel_lo);
    t[q][1] = __byte_perm(t0, t2, sel_hi);
    t[q][2] = __byte_perm(t1, t3, sel_lo);
    t[q][3] = __byte_perm(t1, t3, sel_hi);
  }
#pragma unroll
  for (int T = 0; T < 2; ++T) {
    f[T][0] = t[0][2 * T];
    f[T][1] = t[0][2 * T + 1];
    f[T][2] = t[1][2 * T];
    f[T][3] = t[1][2 * T + 1];
  }
}

// the A fragment of the narrow tile's m16 tile: the warp's 16 columns x 32
// k of a W box from k row kb (its first 64 columns), rows g and g + 8 the
// columns 2g and 2g + 1 of the warp's 16 (two bytes of each k row, the
// same row order and bank spread as load_w_frag)
__device__ __forceinline__ void load_w_frag1(const unsigned char* W, int kb,
                                             int warp, int g, int tig,
                                             int sw, uint32_t (&f)[4]) {
  const uint32_t sel_g = sw ? 0x2064u : 0x6420u;
  const uint32_t sel_g8 = sw ? 0x3175u : 0x7531u;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    uint32_t r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = kb + 16 * q + 4 * tig + (j ^ sw);
      r[j] = *reinterpret_cast<const unsigned short*>(
          W + k * 128 + ((warp ^ (k & 7)) << 4) + 2 * g);
    }
    const uint32_t p01 = __byte_perm(r[0], r[1], 0x5410);
    const uint32_t p23 = __byte_perm(r[2], r[3], 0x5410);
    f[2 * q] = __byte_perm(p01, p23, sel_g);
    f[2 * q + 1] = __byte_perm(p01, p23, sel_g8);
  }
}

// grid (N / (kCols NB), M / ROWS, splitk); acc[T][4 j + c] is the sum of
// token m0 + 8 j + 2 tig + (c & 1), column n0 + kCols box + 16 kT warp +
// 2 kT g + 2 T + (c >> 1)
template <int KIND, int NB, int ROWS, int KS>
__global__ void __launch_bounds__(128 * (NB + 1),
                                  (Geo<KIND, NB, ROWS, KS>::kMinBlocks))
    qmm_tma_kernel(const __grid_constant__ CUtensorMap tmw,
                   const __grid_constant__ CUtensorMap tmx, Args p,
                   int stages) {
  using G = Geo<KIND, NB, ROWS, KS>;
  constexpr int COLS = G::kCols;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t ring = smem_u32(smem);
  const int rb = ring_bytes<G>(stages);
  const uint32_t bars = ring + rb;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (stages + s); };
  int* last = reinterpret_cast<int*>(smem + rb + 16 * stages);
  float* sa_s = reinterpret_cast<float*>(smem + rb + 16 * stages + 16);
  float* sb_s = sa_s + ROWS;
  float* bias_s = sb_s + NB * COLS;
  float* tab = bias_s + NB * COLS;

  const int n0 = blockIdx.x * (NB * COLS), m0 = blockIdx.y * ROWS;
  const int nbox = min(NB, (p.N - n0 + COLS - 1) / COLS);
  const int kst = (p.K + BK - 1) / BK;
  const int ks0 = (int)((long long)blockIdx.z * kst / p.splitk);
  const int nk = (int)((long long)(blockIdx.z + 1) * kst / p.splitk) - ks0;

  for (int i = threadIdx.x; i < p.table_n; i += G::kThreads)
    tab[i] = p.table[i];
  if (threadIdx.x == 0) {
    if (ring & 1023) __trap();          // the swizzle needs 1024-byte tiles
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * nbox);    // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup, broadcast so that the compiler sees it warp-uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    if constexpr (G::kRealloc) setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      const uint32_t bytes = nbox * G::kWTile + G::kXTile;
      for (int t = 0; t < nk; ++t) {
        const int s = t % stages;
        if (t >= stages) mbar_wait(empty(s), ((t / stages) - 1) & 1);
        mbar_arrive_expect_tx(full(s), bytes);
        const uint32_t st = ring + s * G::kStage;
        const int k0 = (ks0 + t) * BK;
        for (int b = 0; b < nbox; ++b)
          tma_load_2d(st + b * G::kWTile, &tmw, full(s), n0 + b * COLS, k0);
        tma_load_2d(st + NB * G::kWTile, &tmx, full(s), k0, m0);
      }
    }
    return;
  }
  if constexpr (G::kRealloc) setmaxnreg_inc<232>();
  const int c = wg - 1;                 // the consumer's box
  if (c >= nbox) return;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int sw = 2 * (tig >> 1);
  const uint32_t sel_lo = sw ? 0x1054u : 0x5410u;
  const uint32_t sel_hi = sw ? 0x3276u : 0x7632u;
  const int chunk = 2 * warp + (g >> 2), word = 4 * (g & 3);
  const int consumers = 128 * nbox;

  // the epilogue's scales and bias into shared memory while the first
  // stages load (read from global memory in the epilogue, their latency
  // is paid once per output)
  if (tid < COLS) {
    const int n = n0 + c * COLS + tid;
    sb_s[c * COLS + tid] = n < p.N ? p.sb[n] : 0.f;
    if (p.bias != nullptr) bias_s[c * COLS + tid] = n < p.N ? p.bias[n] : 0.f;
  }
  {
    for (int r = c * 128 + tid; r < ROWS; r += consumers)
      sa_s[r] = m0 + r < p.M ? p.sa[m0 + r] : 0.f;
  }
  named_bar_sync(1, consumers);

  int acc[G::kT][ROWS / 2];
#pragma unroll
  for (int T = 0; T < G::kT; ++T)
#pragma unroll
    for (int i = 0; i < ROWS / 2; ++i) acc[T][i] = 0;

  for (int t = 0; t < nk; ++t) {
    const int s = t % stages;
    mbar_wait(full(s), (t / stages) & 1);
    const unsigned char* W = smem + s * G::kStage + c * G::kWTile;
    if constexpr (KIND == 0) {
      const unsigned char* X = smem + s * G::kStage + NB * G::kWTile;
#pragma unroll
      for (int kb = 0; kb < BK; kb += 32) {
        uint32_t f[2][4];
        load_w_frag(W, kb, chunk, word, tig, sw, sel_lo, sel_hi, f);
#pragma unroll
        for (int j = 0; j < ROWS / 8; ++j) {
          const unsigned char* xr = X + (8 * j + g) * 128 + 4 * tig;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(
              xr + ((((kb >> 4)) ^ g) << 4));
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
              xr + ((((kb >> 4) + 1) ^ g) << 4));
#pragma unroll
          for (int T = 0; T < 2; ++T)
            mma_s8(acc[T] + 4 * j, f[T][0], f[T][1], f[T][2], f[T][3], b0,
                   b1);
        }
      }
    } else {
      uint32_t f[KS][G::kT][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        if constexpr (G::kT == 2)
          load_w_frag(W, 32 * kk, chunk, word, tig, sw, sel_lo, sel_hi,
                      f[kk]);
        else
          load_w_frag1(W, 32 * kk, warp, g, tig, sw, f[kk][0]);
      }
      const uint32_t xs = ring + s * G::kStage + NB * G::kWTile;
#pragma unroll
      for (int T = 0; T < G::kT; ++T) fence_operands(acc[T]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint64_t b = desc_b128(xs + 32 * kk, 16, 1024);
#pragma unroll
        for (int T = 0; T < G::kT; ++T) {
          if constexpr (ROWS == 32)
            wgmma_m64n32k32_s8_rs(acc[T], f[kk][T], b, 1);
          else if constexpr (ROWS == 64)
            wgmma_m64n64k32_s8_rs(acc[T], f[kk][T], b, 1);
          else
            wgmma_m64n128k32_s8_rs(acc[T], f[kk][T], b, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int T = 0; T < G::kT; ++T) fence_operands(acc[T]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  // out^T -> out through shared memory (the ring is free once every
  // consumer is past its last stage): the consumer's ROWS x 128 int32
  // sums, then rolled loops over them -- the split's atomics on
  // consecutive addresses, and the epilogue on 8-column groups with
  // 16-byte row stores.  (Unrolled over the accumulator registers, the
  // epilogue's code cost more than the products: PERF.md section 6.)
  named_bar_sync(1, consumers);
  int* stg = reinterpret_cast<int*>(smem + c * ROWS * G::kLdo);
  constexpr int LD = G::kLdo / 4;       // ints a staging row
#pragma unroll
  for (int T = 0; T < G::kT; ++T)
#pragma unroll
    for (int i = 0; i < ROWS / 2; i += 4)
#pragma unroll
      for (int h = 0; h < 2; ++h)       // token 8 j + 2 tig + h, 8 j = 2 i
        *reinterpret_cast<int2*>(stg + (2 * tig + 2 * i + h) * LD +
                                 16 * G::kT * warp + 2 * G::kT * g + 2 * T) =
            make_int2(acc[T][i + h], acc[T][i + 2 + h]);
  named_bar_sync(2 + c, 128);
  const int rows_in = min(ROWS, p.M - m0);
  const int ncol0 = n0 + c * COLS;
  if (p.splitk > 1) {
    // exact int32 reduction over the K splits (a warp's atomics on 32
    // consecutive columns); the last block finishes
#pragma unroll 4
    for (int x = tid; x < rows_in * COLS; x += 128) {
      const int r = x / COLS, n = ncol0 + x % COLS;
      if (n < p.N)
        atomicAdd(p.ws + (size_t)(m0 + r) * p.N + n, stg[r * LD + x % COLS]);
    }
    __threadfence();
    named_bar_sync(1, consumers);
    const unsigned tile = blockIdx.y * gridDim.x + blockIdx.x;
    if (c == 0 && tid == 0)
      *last = atomicAdd(p.tickets + tile, 1u) == (unsigned)(p.splitk - 1);
    named_bar_sync(1, consumers);
    if (!*last) return;
    __threadfence();
    // the totals, read from the L2 where the atomics made them (16 bytes a
    // load, several in flight), and the workspace left zeroed for the
    // next launch
#pragma unroll 4
    for (int x = tid; x < rows_in * (COLS / 4); x += 128) {
      const int r = x / (COLS / 4), cl = 4 * (x % (COLS / 4)), n = ncol0 + cl;
      if (n >= p.N) continue;
      int4* w = reinterpret_cast<int4*>(p.ws + (size_t)(m0 + r) * p.N + n);
      *reinterpret_cast<int4*>(stg + r * LD + cl) = __ldcg(w);
      __stcg(w, make_int4(0, 0, 0, 0));
    }
    if (c == 0 && tid == 0) p.tickets[tile] = 0u;
    named_bar_sync(2 + c, 128);
  }
  // 8 columns of a row an item (N is a multiple of 16: a group is inside
  // or outside whole)
#pragma unroll 1
  for (int it = tid; it < rows_in * (COLS / 8); it += 128) {
    const int r = it / (COLS / 8), q = it % (COLS / 8);
    const int n = ncol0 + 8 * q;
    if (n >= p.N) continue;
    const int4 lo4 = *reinterpret_cast<const int4*>(stg + r * LD + 8 * q);
    const int4 hi4 = *reinterpret_cast<const int4*>(stg + r * LD + 8 * q + 4);
    const int av[8] = {lo4.x, lo4.y, lo4.z, lo4.w, hi4.x, hi4.y, hi4.z, hi4.w};
    const float sam = sa_s[r];
    const float* sbq = sb_s + c * COLS + 8 * q;
    const float* bq = bias_s + c * COLS + 8 * q;
    float y[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      y[e] = epilogue_at(p, tab, av[e], sam, sbq[e],
                         p.bias != nullptr ? bq[e] : 0.f);
    const size_t o = (size_t)(m0 + r) * p.N + n;
    if (p.out_bf16) {
      uint4 v;
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        h2[e] = __floats2bfloat162_rn(y[2 * e], y[2 * e + 1]);
      *reinterpret_cast<uint4*>(reinterpret_cast<__nv_bfloat16*>(p.out) + o) =
          v;
    } else {
      float4* dst = reinterpret_cast<float4*>(reinterpret_cast<float*>(p.out) +
                                              o);
      dst[0] = make_float4(y[0], y[1], y[2], y[3]);
      dst[1] = make_float4(y[4], y[5], y[6], y[7]);
    }
  }
}

}  // namespace tq

template <int KIND, int NB, int ROWS, int KS = 4>
cudaError_t launch_tma(const Args& p, int stages, cudaStream_t s) {
  using G = tq::Geo<KIND, NB, ROWS, KS>;
  auto kern = tq::qmm_tma_kernel<KIND, NB, ROWS, KS>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, tq::SMEM_MAX);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  // the ring gives way to the table's bytes
  const int fixed = 16 + G::kVec + p.table_n * (int)sizeof(float);
  while (stages > 1 &&
         tq::ring_bytes<G>(stages) + 16 * stages + fixed > tq::SMEM_MAX)
    --stages;
  const size_t smem = tq::ring_bytes<G>(stages) + 16 * stages + fixed;
  if (smem > (size_t)tq::SMEM_MAX) return cudaErrorInvalidValue;
  hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap mw, mx;
  if (!hopper::encode_2d_u8(fn, &mw, p.B, p.N, p.K, p.N, tq::BOX,
                            G::kWRows) ||
      !hopper::encode_2d_u8(fn, &mx, p.A, p.K, p.M, p.K, tq::BK, ROWS))
    return cudaErrorInvalidValue;
  const dim3 grid((p.N + NB * G::kCols - 1) / (NB * G::kCols),
                  (p.M + ROWS - 1) / ROWS, p.splitk);
  kern<<<grid, G::kThreads, smem, s>>>(mw, mx, p, stages);
  return cudaGetLastError();
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
  if (M < 1 || N < 1 || K < 1 || splitk < 1 || table_n < 0 ||
      table_n > MAX_TABLE)
    return static_cast<int>(cudaErrorInvalidValue);
  Args p;
  p.A = static_cast<const int8_t*>(a);
  p.B = static_cast<const int8_t*>(b);
  p.sa = static_cast<const float*>(sa);
  p.sb = static_cast<const float*>(sb);
  p.bias = static_cast<const float*>(bias);
  p.table = static_cast<const float*>(table);
  p.out = out;
  p.M = M; p.N = N; p.K = K;
  p.vecA = K % 16 == 0 && (uintptr_t)a % 16 == 0;
  p.vecB = N % 16 == 0 && (uintptr_t)b % 16 == 0;
  p.vec_out = N % 8 == 0 && (uintptr_t)out % 16 == 0;
  p.table_n = table_n;
  p.lo = lo; p.step_inv = step_inv;
  p.indexing = indexing; p.gated = gated; p.out_bf16 = out_bf16;
  p.splitk = splitk;
  p.ws = static_cast<int*>(ws);
  p.tickets = static_cast<unsigned*>(tickets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (M <= 8)
    err = launch<16, 1>(p, s);
  else if (M <= 16)
    err = launch<16, 2>(p, s);
  else
    err = launch<128, 1>(p, s);
  return static_cast<int>(err);
}

// The TMA instances (the wrapper's plan): kind 0 the weight stream (nb 1;
// rows 8, 16, 32 or 64), kind 1 wgmma (nb 1 or 2; rows 64 or 128), kind 2
// the narrow wgmma tile (nb 1; rows 32 or 64; K at most 64, one stage).  K
// and N multiples of 16 and 16-byte aligned a, b and out (TMA's rule);
// `stages` ring stages, fewer where a table needs the room.  Scratch as
// qmatmul_launch's, for the plan's tiles.
extern "C" int qmatmul_tma_launch(const void* a, const void* b,
                                  const void* sa, const void* sb,
                                  const void* bias, const void* table,
                                  void* out, int M, int N, int K,
                                  int table_n, float lo, float step_inv,
                                  int indexing, int gated, int out_bf16,
                                  int kind, int nb, int rows, int splitk,
                                  int stages, void* ws, void* tickets,
                                  void* stream) {
  const int kst = (K + tq::BK - 1) / tq::BK;
  if (M < 1 || N < 1 || K < 1 || splitk < 1 || splitk > kst ||
      stages < 1 || table_n < 0 || table_n > MAX_TABLE || K % 16 ||
      N % 16 || ((uintptr_t)a | (uintptr_t)b | (uintptr_t)out) % 16 ||
      (splitk > 1 && (ws == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args p{};
  p.A = static_cast<const int8_t*>(a);
  p.B = static_cast<const int8_t*>(b);
  p.sa = static_cast<const float*>(sa);
  p.sb = static_cast<const float*>(sb);
  p.bias = static_cast<const float*>(bias);
  p.table = static_cast<const float*>(table);
  p.out = out;
  p.M = M; p.N = N; p.K = K;
  p.table_n = table_n;
  p.lo = lo; p.step_inv = step_inv;
  p.indexing = indexing; p.gated = gated; p.out_bf16 = out_bf16;
  p.splitk = splitk;
  p.ws = static_cast<int*>(ws);
  p.tickets = static_cast<unsigned*>(tickets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ks = K <= 32 ? 1 : K <= 64 ? 2 : 4;
#define QMM_TMA(KIND, NB, ROWS, KS)                                 \
  if (kind == KIND && nb == NB && rows == ROWS && ks <= KS)         \
    return static_cast<int>(launch_tma<KIND, NB, ROWS, KS>(p, stages, s));
  QMM_TMA(0, 1, 8, 4) QMM_TMA(0, 1, 16, 4) QMM_TMA(0, 1, 32, 4)
  QMM_TMA(0, 1, 64, 4)
  QMM_TMA(1, 1, 64, 4) QMM_TMA(1, 1, 128, 4) QMM_TMA(1, 2, 64, 4)
  QMM_TMA(1, 2, 128, 4)
  QMM_TMA(2, 1, 32, 1) QMM_TMA(2, 1, 32, 2) QMM_TMA(2, 1, 64, 1)
  QMM_TMA(2, 1, 64, 2)
#undef QMM_TMA
  return static_cast<int>(cudaErrorInvalidValue);
}
