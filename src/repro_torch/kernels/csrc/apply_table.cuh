// The in-kernel table gather shared by qmatmul.cu (its LUT epilogue) and
// lut_activation.cu, so that the interp / nearest / trunc numerics have
// one device implementation, as in the reference
// (src/repro/kernels/lut_activation.py:36 apply_table, used by both TPU
// kernels).  The plain twin is repro_torch.kernels.ref.apply_table.
//
//   pos = (y - lo) * step_inv        (step_inv = 1 / step, f32, from the host)
//   interp:  clip pos to [0, n-1]; i0 = floor(pos); frac = pos - i0;
//            z = fma(t[i0], 1 - frac, t[min(i0 + 1, n-1)] * frac)
//   nearest: z = t[clip(rint(pos), 0, n-1)]   (half to even, as jnp.round)
//   trunc:   z = t[clip(floor(pos), 0, n-1)]  (hls4ml-faithful)
//   gated:   y * z, else z
//
// Every f32 operation is an explicit round-to-nearest intrinsic, so nvcc
// contracts nothing on its own.  The one fused multiply-add, in interp, is
// the reference's: XLA compiles lut_activation.py:56 `y0 * (1.0 - frac) +
// y1 * frac` into fma(y0, 1 - frac, y1 * frac) (as its interpret mode on
// the CPU shows), and the plain version computes that same single
// rounding, so the result is bitwise the plain version's.

#pragma once

#include <cuda_runtime.h>

enum TableIndexing { kTrunc = 0, kNearest = 1, kInterp = 2 };

__device__ __forceinline__ float apply_table(float y, const float* t, int n,
                                             float lo, float step_inv,
                                             int indexing, int gated) {
  float pos = __fmul_rn(__fsub_rn(y, lo), step_inv);
  float z;
  if (indexing == kInterp) {
    pos = fminf(fmaxf(pos, 0.f), (float)(n - 1));
    const float i0f = floorf(pos);
    const float frac = __fsub_rn(pos, i0f);
    const int i0 = (int)i0f;
    const int i1 = min(i0 + 1, n - 1);
    z = __fmaf_rn(t[i0], __fsub_rn(1.f, frac), __fmul_rn(t[i1], frac));
  } else {
    float r = (indexing == kNearest) ? rintf(pos) : floorf(pos);
    r = fminf(fmaxf(r, 0.f), (float)(n - 1));
    z = t[(int)r];
  }
  return gated ? __fmul_rn(y, z) : z;
}
