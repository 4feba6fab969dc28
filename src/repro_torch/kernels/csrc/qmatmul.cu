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
// count (8 at decode, 128 for a prefill chunk) while K x N is a whole
// weight matrix (0.5 MB to 33.5 MB of int8), so the kernel does ~2*M int8
// operations per weight byte -- far below the ~590 ops/byte at which the
// int8 tensor cores (1979 TOPS) would overtake HBM (3.35 TB/s).  Only
// whisper's encoder (M = 12000) comes near the operations bound.
//
// What the design does about it:
//  * products on the tensor cores: mma.sync m16n8k32 s8 x s8 -> s32.  The
//    int32 sums are exact (|acc| <= 128^2 * 16384 < 2^31), so the order of
//    the K sum does not matter and no .satfinite is needed;
//  * loads: a ring of shared-memory stages (128 K bytes each at decode, 64
//    otherwise) filled by 16-byte cp.async, so several stages of the weight
//    stream are in flight while the tensor cores work on an earlier one;
//    each thread copies fixed chunk slots of every stage.  Zero-filled
//    cp.async (src-size 0) masks the ragged M, N and K edges; a row that
//    is not 16-byte aligned (K or N not a multiple of 16, an unaligned
//    view) stages with plain byte loads instead.  The wrapper pads nothing;
//  * fragments: A rows are K-contiguous, so ldmatrix (b16) yields mma's A
//    fragment.  B is stored (K, N), N-contiguous, while mma wants four
//    consecutive k of one column in a register: each lane reads four
//    32-bit words (4 k rows x 4 columns) and transposes the 4 x 4 bytes
//    with eight byte permutes (prmt), which gives four columns' k quads.
//    A lane's four columns become one column in each of four n8 tiles (or
//    two rows in each of two m16 tiles); the epilogue maps them back.  B
//    rows are XOR-swizzled by 16-byte chunk so those reads are free of
//    bank conflicts;
//  * two tilings, chosen on M.  M <= 16 (decode): the weights take mma's
//    16-row side (out^T = B^T A^T), tokens its 8 columns (one or two n8
//    tiles), so no tensor-core row is spent on absent tokens; a block of 8
//    warps covers 128 columns, 4 warps across N by 2 across each stage's
//    k32 steps, with 6 stages of 16 KB (80 KB of weights in flight).
//    M > 16: a 128 x 128 block tile, 8 warps of 64 x 32, 4 stages;
//  * split-K when the output tiles cannot fill the card (decode's N 2048
//    and 256; the wrapper's plan): `splitk` blocks share a tile's K range
//    and add their int32 partial sums into a workspace with atomicAdd --
//    integer addition, so the total is exact and independent of order --
//    and the last block of the tile (counted with a fence and an atomic
//    ticket) applies the epilogue and zeroes the workspace and its ticket
//    for the next launch;
//  * the epilogue runs on the int32 accumulator in registers, the table in
//    shared memory: the (M, N) f32 intermediate never reaches HBM.  It uses
//    __fmul_rn/__fmaf_rn so that nvcc contracts nothing on its own: the op
//    order is the reference's, so the output is bitwise the plain
//    version's (repro_torch.kernels.ref.qmatmul_ref, whose table epilogue
//    indexes with the same (y - lo) * step_inv).  M > 16 writes each lane's
//    8 consecutive outputs with 16-byte stores.
// Not yet done (a later change): wgmma, which takes int8 operands only
// K-major, so it needs the weights pre-packed K-major; TMA loads.  The
// workspace is shared by all launches on one device, so launches must not
// run concurrently on two streams (the engine uses one).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "apply_table.cuh"

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
