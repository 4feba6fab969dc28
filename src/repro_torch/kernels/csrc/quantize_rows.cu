// Per-row dynamic int8 quantization of a projection's activations, in one
// launch, for Hopper (sm_90a).
//
// Replaces: no Pallas kernel.  The reference quantizes the activation
// before every int8 projection with one XLA fusion
// (src/repro/nn/linear.py:88-89: calibrate_scale, then round / clip /
// astype, src/repro/core/quantize.py calibrate_scale); eager PyTorch ran
// that chain as about nine launches (cast to f32, abs, amax, clamp_min,
// divide, divide, round, clamp, cast), moving ~47 bytes per element.
// Contract, per row of x (T, K), f32 or bf16, every operation in f32:
//   amax = max |x|                     (NaN propagates, as torch.amax)
//   s    = max(amax, 1e-12) / qmax     (one correctly rounded division)
//   q    = int8(clamp(rint(x / s), lo, hi))   (x / s correctly rounded,
//          half to even; NaN passes the clamp, as torch.clamp)
// which is bitwise repro_torch.kernels.ref.quantize_rows_ref, the chain
// above (and the reference's).
//
// What bounds it on the H100: bytes -- 2 (bf16) or 4 (f32) read and 1
// written per element, a handful of f32 operations.  At whisper's
// encoder (12000 rows of 512 or 2048) that is ~5.5 or ~22 us at 3.35
// TB/s; at decode (8 rows) a launch is bound by its latency.
//
// What the design does about it:
//  * x is read from device memory once: the row's 16-byte vectors stay in
//    registers (up to R a thread) between the max and the quantize;
//  * many short rows (>= 8 per SM, <= 32 * R vectors: K <= 2048 bf16,
//    <= 1024 f32; whisper's encoder) take a warp each, 8 rows a block, and
//    reduce with shuffles only; otherwise (decode, prefill chunks, long
//    rows) a row takes a 512-thread block (K <= 32768 bf16, <= 16384
//    f32), with one shared-memory combine of the 16 warps' maxima;
//  * each element's x / s is a multiply and two fmas against the row's
//    correctly rounded reciprocal, corrected to the correctly rounded
//    quotient (Divisor below), not a division per element;
//  * a row that is not 16-byte aligned, or longer still, is read twice
//    with scalar loads (the second pass from L2);
//  * the int8 row is written as 8 (bf16) or 4 (f32) bytes a vector.
// Not yet done (a later change): feeding qmatmul's A stage directly, which
// would remove the int8 round trip and the launch.
//
// The backward (training under --quant int8; no Pallas kernel: XLA's
// autodiff of the chain above): q = round(x / s) is a constant (round's
// gradient is 0), so x gets the gradient of s alone, ds (rows) f32, at
// each row's arg-max-abs elements:
//   g  = ds / qmax;  x 0.5 where amax == 1e-12 (the floor tied), 0 below
//   g /= count of i with |x_i| == amax          (ties split evenly)
//   dx = |x_i| == amax ? (x_i >= 0 ? g : -g) : 0, in x's dtype
// -- jax.grad of calibrate_scale op for op (jnp.max's and jnp.maximum's
// tie rules, jnp.abs's select), bitwise repro_torch.kernels.ref.
// quantize_rows_bwd_plain.  Bound by bytes (x read, dx written; ds a
// float a row).  A simple kernel: a 256-thread block a row, x read twice
// (the max and its count, then dx; the second read from L2).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int R = 8;             // 16-byte vectors a thread keeps
constexpr int WARP_ROWS = 8;     // rows of a 256-thread block, a warp each
constexpr int ROW_THREADS = 512; // threads of a block that takes one row

struct Quant {
  float qmax;     // the scale's divisor, the type's int_max
  float lo, hi;   // the clamp range, int_min and int_max
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// max that keeps NaN from either side (fmaxf drops it); exact otherwise
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// torch.clamp_min(amax, 1e-12) / qmax
__device__ __forceinline__ float row_scale(float amax, const Quant& qp) {
  const float c = amax < 1e-12f ? 1e-12f : amax;   // NaN stays NaN
  return __fdiv_rn(c, qp.qmax);
}

// The row's divisor: s, its reciprocal RN(1 / s) and whether the
// reciprocal route is exact for it (s finite and nonzero; s is never
// subnormal, being at least 1e-12 / 127, and NaN propagates either way).
struct Divisor {
  float s, r;
  bool exact;
};

__device__ __forceinline__ Divisor divisor(float s) {
  return Divisor{s, __frcp_rn(s), isfinite(s) && s != 0.f};
}

// RN(v / s).  With r = RN(1 / s), q0 = RN(v * r) is within an ulp of
// v / s, the remainder v - q0 * s is exact in one fma, and one corrected
// step RN(q0 + rem * r) is the correctly rounded quotient (Markstein's
// theorem): a multiply and two fmas where __fdiv_rn takes a branchy
// sequence per element.  Only for s = inf (a row holding inf) would the
// remainder go NaN: that row divides.
__device__ __forceinline__ float quotient(float v, const Divisor& d) {
  if (!d.exact) return __fdiv_rn(v, d.s);
  const float q0 = __fmul_rn(v, d.r);
  return __fmaf_rn(__fmaf_rn(-q0, d.s, v), d.r, q0);
}

__device__ __forceinline__ int8_t quantize(float v, const Divisor& d,
                                           const Quant& qp) {
  float q = rintf(quotient(v, d));
  q = q < qp.lo ? qp.lo : (q > qp.hi ? qp.hi : q);  // NaN stays NaN
  return static_cast<int8_t>(q);  // the cast torch's .to(int8) makes
}

// the max over a group of G threads (G a multiple of 32, or 32): warp
// shuffles, then, for G > 32, one combine through shared memory
template <int G>
__device__ __forceinline__ float group_max(float m, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if constexpr (G > 32) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) red[warp] = m;
    __syncthreads();
    m = red[0];
#pragma unroll
    for (int w = 1; w < G / 32; ++w) m = nan_max(m, red[w]);
  }
  return m;
}

// 16-byte vectors: 8 bf16 or 4 f32 in, 8 or 4 int8 out
template <typename T>
struct Pack {
  static constexpr int N = 16 / sizeof(T);
  using Out = typename std::conditional<N == 8, uint2, uint32_t>::type;
};

// the row in registers: G threads a row (a warp, or the whole block)
template <typename T, int G>
__global__ void __launch_bounds__(G == 32 ? 32 * WARP_ROWS : G)
quantize_rows_vec_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ s, int rows, int K, Quant qp) {
  constexpr int N = Pack<T>::N;
  using Out = typename Pack<T>::Out;
  __shared__ float red[G > 32 ? G / 32 : 1];
  const int t = G == 32 ? threadIdx.x % 32 : threadIdx.x;
  const int row = G == 32 ? blockIdx.x * WARP_ROWS + threadIdx.x / 32
                          : blockIdx.x;
  if (row >= rows) return;          // uniform over the row's group
  const int nv = K / N;
  const uint4* xv = reinterpret_cast<const uint4*>(x + (size_t)row * K);
  uint4 buf[R];
#pragma unroll
  for (int j = 0; j < R; ++j)
    if (t + j * G < nv) buf[j] = xv[t + j * G];
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if (t + j * G < nv) {
      const T* e = reinterpret_cast<const T*>(&buf[j]);
#pragma unroll
      for (int i = 0; i < N; ++i) m = nan_max(fabsf(to_f32(e[i])), m);
    }
  }
  const float sc = row_scale(group_max<G>(m, red), qp);
  if (t == 0) s[row] = sc;
  const Divisor d = divisor(sc);
  Out* qv = reinterpret_cast<Out*>(q + (size_t)row * K);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if (t + j * G < nv) {
      const T* e = reinterpret_cast<const T*>(&buf[j]);
      Out o;
      int8_t* ob = reinterpret_cast<int8_t*>(&o);
#pragma unroll
      for (int i = 0; i < N; ++i) ob[i] = quantize(to_f32(e[i]), d, qp);
      qv[t + j * G] = o;
    }
  }
}

// any row: scalar loads, read twice (the second pass hits L2)
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
quantize_rows_scalar_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                            float* __restrict__ s, int K, Quant qp) {
  __shared__ float red[ROW_THREADS / 32];
  const size_t base = (size_t)blockIdx.x * K;
  float m = 0.f;
  for (int i = threadIdx.x; i < K; i += ROW_THREADS)
    m = nan_max(fabsf(to_f32(x[base + i])), m);
  const float sc = row_scale(group_max<ROW_THREADS>(m, red), qp);
  if (threadIdx.x == 0) s[blockIdx.x] = sc;
  const Divisor d = divisor(sc);
  for (int i = threadIdx.x; i < K; i += ROW_THREADS)
    q[base + i] = quantize(to_f32(x[base + i]), d, qp);
}

template <typename T>
cudaError_t launch(const void* x, void* q, void* s, int rows, int K,
                   const Quant& qp, int sms, cudaStream_t st) {
  constexpr int N = Pack<T>::N;
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* sf = static_cast<float*>(s);
  const bool vec = K % N == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)q % N == 0;
  const int nv = K / N;
  // a warp a row only when the rows give every SM a block of 8: with
  // fewer rows (decode, a prefill chunk) a block a row spreads the
  // per-element work over 16x more threads
  if (vec && nv <= 32 * R && rows >= WARP_ROWS * sms)
    quantize_rows_vec_kernel<T, 32>
        <<<(rows + WARP_ROWS - 1) / WARP_ROWS, 32 * WARP_ROWS, 0, st>>>(
            xt, qt, sf, rows, K, qp);
  else if (vec && nv <= ROW_THREADS * R)
    quantize_rows_vec_kernel<T, ROW_THREADS>
        <<<rows, ROW_THREADS, 0, st>>>(xt, qt, sf, rows, K, qp);
  else
    quantize_rows_scalar_kernel<T><<<rows, ROW_THREADS, 0, st>>>(
        xt, qt, sf, K, qp);
  return cudaGetLastError();
}

constexpr int BWD_THREADS = 256;

template <typename T>
__device__ __forceinline__ void store_as(T* p, size_t i, float v);
template <>
__device__ __forceinline__ void store_as<float>(float* p, size_t i, float v) {
  p[i] = v;
}
template <>
__device__ __forceinline__ void store_as<__nv_bfloat16>(__nv_bfloat16* p,
                                                        size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
quantize_rows_bwd_kernel(const T* __restrict__ x, const float* __restrict__ ds,
                         T* __restrict__ dx, int K, float qmax) {
  __shared__ float red_m[BWD_THREADS / 32];
  __shared__ int red_c[BWD_THREADS / 32];
  const size_t base = (size_t)blockIdx.x * K;
  // the row's max |x| and how many elements hold it
  float m = 0.f;
  int c = 0;
  for (int i = threadIdx.x; i < K; i += BWD_THREADS) {
    const float a = fabsf(to_f32(x[base + i]));
    if (a > m) {
      m = a;
      c = 1;
    } else if (a == m) {
      ++c;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, off);
    const int oc = __shfl_xor_sync(0xffffffffu, c, off);
    c = (om > m) ? oc : (om == m ? c + oc : c);
    m = fmaxf(m, om);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red_m[warp] = m;
    red_c[warp] = c;
  }
  __syncthreads();
  float amax = red_m[0];
  for (int w = 1; w < BWD_THREADS / 32; ++w) amax = fmaxf(amax, red_m[w]);
  int count = 0;
  for (int w = 0; w < BWD_THREADS / 32; ++w)
    if (red_m[w] == amax) count += red_c[w];
  // ds / qmax through max(amax, 1e-12) (0.5 at the tie), then split
  float g = __fdiv_rn(ds[blockIdx.x], qmax);
  g = amax > 1e-12f ? g : (amax == 1e-12f ? __fmul_rn(g, 0.5f) : 0.f);
  g = __fdiv_rn(g, (float)count);
  for (int i = threadIdx.x; i < K; i += BWD_THREADS) {
    const float v = to_f32(x[base + i]);
    store_as<T>(dx, base + i,
                fabsf(v) == amax ? (v >= 0.f ? g : -g) : 0.f);
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: rows x K contiguous, bf16 when is_bf16 else f32; q: rows x K int8;
// s: rows f32.  qmax divides the row's max (the type's int_max); lo, hi
// clamp the rounded quotient (int_min, int_max, within int8's range).
// `sms` picks the layout (a warp or a block a row).
extern "C" int quantize_rows_launch(const void* x, void* q, void* s, int rows,
                                    int K, float qmax, float lo, float hi,
                                    int is_bf16, int sms, void* stream) {
  if (rows < 1 || K < 1 || !(lo >= -128.f) || !(hi <= 127.f) || !(lo <= hi))
    return static_cast<int>(cudaErrorInvalidValue);
  const Quant qp{qmax, lo, hi};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? launch<__nv_bfloat16>(x, q, s, rows, K, qp, sms, st)
              : launch<float>(x, q, s, rows, K, qp, sms, st));
}

// dx (rows x K, x's dtype) of s = max(max |x_row|, 1e-12) / qmax given ds
// (rows f32); x as in quantize_rows_launch
extern "C" int quantize_rows_bwd_launch(const void* x, const void* ds,
                                        void* dx, int rows, int K, float qmax,
                                        int is_bf16, void* stream) {
  if (rows < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    quantize_rows_bwd_kernel<__nv_bfloat16><<<rows, BWD_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(ds),
        static_cast<__nv_bfloat16*>(dx), K, qmax);
  else
    quantize_rows_bwd_kernel<float><<<rows, BWD_THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(ds),
        static_cast<float*>(dx), K, qmax);
  return static_cast<int>(cudaGetLastError());
}
