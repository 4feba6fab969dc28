// Elementwise table-lookup activation (the paper's constant-table
// activations), for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/lut_activation.py:74 lut_activation_pallas
// (the Pallas body is _kernel at :66).  Same contract: any tensor x, f32
// or bf16, and a table of n f32 entries over [lo, hi); each element is
// mapped through apply_table (apply_table.cuh, the reference's
// lut_activation.py:36) in f32, and written in x's dtype.
//
// What bounds it on the H100: bytes.  One gather (two for interp) and a
// handful of f32 operations per element against 4 + 4 (f32) or 2 + 2
// (bf16) bytes moved: ~2 operations per byte, where the f32 roofline's
// balance is ~20.  On the serving path x is one layer's gate activations,
// (tokens, d_ff) = 8 x 16384 at decode (256 KB in bf16, a ~0.16 us byte
// bound), so in practice a launch costs its launch latency.
//
// What the design does about it:
//  * the TPU kernel's (rows, 128) lane padding is not carried over: the
//    kernel walks the flat tensor with a grid-stride loop, 16 bytes per
//    thread per step (float4, or eight bf16 in a uint4) when the pointers
//    are 16-byte aligned, and a scalar tail for the last < 16 bytes;
//  * each block stages the table once into shared memory (n <= 4096
//    entries, <= 16 KB), so every gather is a shared-memory read at a
//    computed index;
//  * the arithmetic is apply_table.cuh's, explicit round-to-nearest
//    intrinsics that nvcc cannot contract into FMAs, so the output is
//    bitwise the plain version's (repro_torch.kernels.ref.
//    lut_activation_plain).
// Not yet done (a later change): fusing the gated product x * table(x)
// and the neighbouring matmul, which would remove the launch.

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
  for (int i = threadIdx.x; i < n; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
}

// f32: four elements per 16-byte vector
__global__ void __launch_bounds__(THREADS)
lut_activation_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
                          const float* __restrict__ table, long long count,
                          Table t, int vec) {
  extern __shared__ float tab[];
  stage(table, tab, t.n);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long nv = count / 4;
    const float4* xv = reinterpret_cast<const float4*>(x);
    float4* ov = reinterpret_cast<float4*>(out);
    for (long long i = tid; i < nv; i += stride) {
      float4 v = xv[i];
      v.x = lookup(v.x, tab, t);
      v.y = lookup(v.y, tab, t);
      v.z = lookup(v.z, tab, t);
      v.w = lookup(v.w, tab, t);
      ov[i] = v;
    }
    done = nv * 4;
  }
  for (long long i = done + tid; i < count; i += stride)
    out[i] = lookup(x[i], tab, t);
}

// bf16: eight elements per 16-byte vector
__global__ void __launch_bounds__(THREADS)
lut_activation_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                           __nv_bfloat16* __restrict__ out,
                           const float* __restrict__ table, long long count,
                           Table t, int vec) {
  extern __shared__ float tab[];
  stage(table, tab, t.n);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long nv = count / 8;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* ov = reinterpret_cast<uint4*>(out);
    for (long long i = tid; i < nv; i += stride) {
      uint4 v = xv[i];
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = __float2bfloat16_rn(lookup(__bfloat162float(e[j]), tab, t));
      ov[i] = v;
    }
    done = nv * 8;
  }
  for (long long i = done + tid; i < count; i += stride)
    out[i] = __float2bfloat16_rn(lookup(__bfloat162float(x[i]), tab, t));
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x and out hold `count` elements of the same dtype (bf16 when is_bf16,
// else f32), contiguous; table holds table_n f32 entries (<= 4096, checked
// by the wrapper).  `sms` bounds the grid at a few blocks per SM.
extern "C" int lut_activation_launch(const void* x, const void* table,
                                     void* out, long long count, int table_n,
                                     float lo, float step_inv, int indexing,
                                     int is_bf16, int sms, void* stream) {
  const Table t{table_n, lo, step_inv, indexing};
  const int per_vec = is_bf16 ? 8 : 4;
  const int vec = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const long long work = vec ? (count + per_vec - 1) / per_vec : count;
  long long blocks = (work + THREADS - 1) / THREADS;
  const long long cap = 8LL * (sms > 0 ? sms : 1);
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const size_t smem = (size_t)table_n * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* T = static_cast<const float*>(table);
  if (is_bf16)
    lut_activation_bf16_kernel<<<(unsigned)blocks, THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
        T, count, t, vec);
  else
    lut_activation_f32_kernel<<<(unsigned)blocks, THREADS, smem, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), T, count, t,
        vec);
  return static_cast<int>(cudaGetLastError());
}
