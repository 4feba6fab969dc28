// Elementwise table-lookup activation (the paper's constant-table
// activations), and the gated MLP's table pass, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/lut_activation.py:74 lut_activation_pallas
// (the Pallas body is _kernel at :66).  Same contract: any tensor x, f32
// or bf16, and a table of n f32 entries over [lo, hi); each element is
// mapped through apply_table (apply_table.cuh, the reference's
// lut_activation.py:36) in f32, and written in x's dtype.
// The gated pass also takes the two products that XLA applies after the
// lookup in the reference (src/repro/nn/activations.py:41 x * lut(x),
// cast to x's dtype; src/repro/nn/blocks.py:72 g * up): from the gate
// projection's g and up, both (T, d_ff) of one dtype dt, it writes
//   h = ((g * T(g)).to(dt)) * up,   T(g) = apply_table(g) rounded to dt,
// each product one round-to-nearest in dt: bitwise the chain the card ran
// as three launches (repro_torch.kernels.ref.lut_gated_mul_plain).
//
// What bounds it on the H100: bytes.  One gather (two for interp) and a
// handful of f32 operations per element against 2 + 2 (bf16) or 4 + 4
// (f32) bytes moved (gated: 3 x 2 or 3 x 4), ~2 operations per byte,
// where the f32 roofline's balance is ~20.  On the serving path the
// gated pass reads one layer's gate and up activations, (tokens, d_ff) =
// 8 x 16384 at decode (768 KB in bf16, a ~0.23 us byte bound), so a launch
// costs its latency: two cold HBM round trips (the table, then x) and a
// grid that fills the card.
//
// What the design does about it:
//  * the gated pass is one pass over g, up and h: 3 tensor passes and 1
//    launch where the unfused chain took 8 and 3;
//  * each thread issues its first 16-byte loads (x; or g and up) before
//    its block stages the table into shared memory, so the cold reads of
//    the data overlap the table fetch instead of following it; inside the
//    grid-stride loop the next vector's loads are issued before the
//    current one is computed;
//  * the grid covers the card: blocks of 256, 128 or 64 threads, the
//    largest that still gives one block per SM (8 x 16384 bf16 is 16384
//    vectors: 256 blocks of 64 threads, not 64 blocks of 256);
//  * the TPU kernel's (rows, 128) lane padding is not carried over: the
//    flat tensor is walked 16 bytes per thread per step (float4, or eight
//    bf16 in a uint4) when the pointers are 16-byte aligned, with a scalar
//    tail for the last < 16 bytes;
//  * each block stages the table once into shared memory (n <= 4096
//    entries, <= 16 KB), so every gather is a shared-memory read at a
//    computed index;
//  * the arithmetic is apply_table.cuh's and the products are __fmul_rn,
//    explicit round-to-nearest intrinsics that nvcc cannot contract into
//    FMAs, so the output is bitwise the plain versions'
//    (repro_torch.kernels.ref.lut_activation_plain, lut_gated_mul_plain).
// Not yet done (a later change): taking g and up from the neighbouring
// matmul's epilogue, which would remove the pass.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "apply_table.cuh"

namespace {

constexpr int THREADS = 256;

struct Table {
  int n;
  float lo, step_inv;
  int indexing;
};

__device__ __forceinline__ float lookup(float x, const float* tab,
                                        const Table& t) {
  return apply_table(x, tab, t.n, t.lo, t.step_inv, t.indexing, 0);
}

__device__ __forceinline__ void stage(const float* __restrict__ table,
                                      float* tab, int n) {
  if (((uintptr_t)table % 16 == 0) && n % 4 == 0) {
    const float4* t4 = reinterpret_cast<const float4*>(table);
    float4* s4 = reinterpret_cast<float4*>(tab);
#pragma unroll 4
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) s4[i] = t4[i];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) tab[i] = table[i];
  }
  __syncthreads();
}

// One element: the table alone, or the gated chain, in x's dtype.
__device__ __forceinline__ float elem(float x, float up, const float* tab,
                                      const Table& t, bool gated) {
  const float z = lookup(x, tab, t);
  return gated ? __fmul_rn(__fmul_rn(x, z), up) : z;
}

__device__ __forceinline__ __nv_bfloat16 elem(__nv_bfloat16 x,
                                              __nv_bfloat16 up,
                                              const float* tab,
                                              const Table& t, bool gated) {
  const float xf = __bfloat162float(x);
  const __nv_bfloat16 z = __float2bfloat16_rn(lookup(xf, tab, t));
  if (!gated) return z;
  // bf16 x bf16 is exact in f32, so each product rounds once, to bf16
  const __nv_bfloat16 p =
      __float2bfloat16_rn(__fmul_rn(xf, __bfloat162float(z)));
  return __float2bfloat16_rn(
      __fmul_rn(__bfloat162float(p), __bfloat162float(up)));
}

// x (and, gated, up) -> out, all of dtype T; 16 / sizeof(T) elements per
// 16-byte vector when vec.  up is unused (may be null) when !GATED.
template <typename T, bool GATED>
__global__ void __launch_bounds__(THREADS)
lut_kernel(const T* __restrict__ x, const T* __restrict__ up,
           T* __restrict__ out, const float* __restrict__ table,
           long long count, Table t, int vec) {
  constexpr int N = 16 / sizeof(T);
  extern __shared__ float tab[];
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nv = vec ? count / N : 0;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* uv = reinterpret_cast<const uint4*>(up);
  uint4 a = {}, b = {};
  // the first vector's loads go out before the table is staged
  if (tid < nv) {
    a = xv[tid];
    if (GATED) b = uv[tid];
  }
  stage(table, tab, t.n);
  uint4* ov = reinterpret_cast<uint4*>(out);
  for (long long i = tid; i < nv; i += stride) {
    const uint4 va = a, vb = b;
    if (i + stride < nv) {          // the next vector's loads, in flight
      a = xv[i + stride];
      if (GATED) b = uv[i + stride];
    }
    uint4 vo;
    const T* ea = reinterpret_cast<const T*>(&va);
    const T* eb = reinterpret_cast<const T*>(&vb);
    T* eo = reinterpret_cast<T*>(&vo);
#pragma unroll
    for (int j = 0; j < N; ++j) eo[j] = elem(ea[j], eb[j], tab, t, GATED);
    ov[i] = vo;
  }
  for (long long i = nv * N + tid; i < count; i += stride)
    out[i] = elem(x[i], GATED ? up[i] : x[i], tab, t, GATED);
}

// blocks of 256, 128 or 64 threads: the largest that still gives every SM
// a block, and at most 4 blocks of 256 threads' worth per SM
struct Grid {
  unsigned blocks, threads;
};

Grid grid_for(long long work, int sms) {
  sms = sms > 0 ? sms : 1;
  int threads = THREADS;
  while (threads > 64 && (work + threads - 1) / threads < sms) threads /= 2;
  long long blocks = (work + threads - 1) / threads;
  const long long cap = 4LL * sms * (THREADS / threads);
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return {(unsigned)blocks, (unsigned)threads};
}

template <bool GATED>
cudaError_t launch(const void* x, const void* up, const void* table,
                   void* out, long long count, const Table& t, int is_bf16,
                   int sms, cudaStream_t s) {
  const int per_vec = is_bf16 ? 8 : 4;
  const int vec = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0) &&
                  (!GATED || (uintptr_t)up % 16 == 0);
  const Grid g = grid_for(vec ? (count + per_vec - 1) / per_vec : count,
                          sms);
  const size_t smem = (size_t)t.n * sizeof(float);
  const float* tbl = static_cast<const float*>(table);
  if (is_bf16)
    lut_kernel<__nv_bfloat16, GATED><<<g.blocks, g.threads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(up),
        static_cast<__nv_bfloat16*>(out), tbl, count, t, vec);
  else
    lut_kernel<float, GATED><<<g.blocks, g.threads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(up),
        static_cast<float*>(out), tbl, count, t, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, up and out hold `count` elements of the same dtype (bf16 when
// is_bf16, else f32), contiguous; table holds table_n f32 entries (<= 4096,
// checked by the wrapper).  `sms` sizes the grid.
extern "C" int lut_activation_launch(const void* x, const void* table,
                                     void* out, long long count, int table_n,
                                     float lo, float step_inv, int indexing,
                                     int is_bf16, int sms, void* stream) {
  return static_cast<int>(launch<false>(
      x, nullptr, table, out, count, Table{table_n, lo, step_inv, indexing},
      is_bf16, sms, static_cast<cudaStream_t>(stream)));
}

// out = ((g * table(g)).to(dt)) * up
extern "C" int lut_gated_mul_launch(const void* g, const void* up,
                                    const void* table, void* out,
                                    long long count, int table_n, float lo,
                                    float step_inv, int indexing, int is_bf16,
                                    int sms, void* stream) {
  return static_cast<int>(launch<true>(
      g, up, table, out, count, Table{table_n, lo, step_inv, indexing},
      is_bf16, sms, static_cast<cudaStream_t>(stream)));
}
