// Shared per-cell step math of the D2Q9-BGK kernels: the forcing guard,
// the pairwise BGK relaxation with omega folded in, and the bounce-back
// select.  Counterpart of ops/kernel_common.py (`forced`, `collide`), whose
// float32 operations these perform in the same order; built with
// -fmad=false so that no multiply-add is contracted and the kernel agrees
// bit for bit with that plain PyTorch version.  Never build with
// --use_fast_math: 1/rho and sqrt must stay IEEE-rounded.
//
// Speed numbering (ops/lattice.py):
//     6 2 5
//     3 0 1     1=E, 2=N, 3=W, 4=S, 5=NE, 6=NW, 7=SW, 8=SE
//     7 4 8
#pragma once

#include <cuda_runtime.h>

namespace lbm {

// float32 scalars of one step, rounded once on the host
// (ops/kernel_common.step_constants); device code never recomputes them.
struct StepConsts {
  float w0_omega;         // W[0] * omega
  float w1_omega;         // W[1] * omega (axis speeds)
  float w2_omega;         // W[5] * omega (diagonal speeds)
  float one_minus_omega;  // 1 - omega
  float accel_w1;         // forcing increment of the axis speeds
  float accel_w2;         // forcing increment of the diagonal speeds
};

// Positivity guard of the row forcing, evaluated at the cell whose
// pre-stream values are being forced: fluid, and the three decremented
// speeds stay strictly positive.
__device__ __forceinline__ bool forcing_ok(bool obst, float f3, float f6,
                                           float f7, const StepConsts& c) {
  return !obst && (f3 - c.accel_w1 > 0.0f) && (f6 - c.accel_w2 > 0.0f) &&
         (f7 - c.accel_w2 > 0.0f);
}

// BGK relaxation + bounce-back of one cell, in place on its 9 streamed
// values.  Returns u_sq of the streamed (pre-collision) moments, which BGK
// conserves, for the ||u|| reduction.
__device__ __forceinline__ float collide(float s[9], bool obst,
                                         const StepConsts& c) {
  float rho = s[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) rho = rho + s[k];
  const float inv_rho = 1.0f / rho;
  const float u_x = (s[1] + s[5] + s[8] - s[3] - s[6] - s[7]) * inv_rho;
  const float u_y = (s[2] + s[5] + s[6] - s[4] - s[7] - s[8]) * inv_rho;
  const float u_sq = u_x * u_x + u_y * u_y;
  const float base = 1.0f - u_sq * 1.5f;
  const float om1 = c.one_minus_omega;

  float o[9];
  o[0] = c.w0_omega * rho * base + om1 * s[0];
  // opposite speeds k / ko share the even part of their equilibrium
  auto pair = [&](int k, int ko, float cu, float w_omega) {
    const float t = w_omega * rho;
    const float even = base + (cu * cu) * 4.5f;
    const float odd = cu * 3.0f;
    o[k] = t * (even + odd) + om1 * s[k];
    o[ko] = t * (even - odd) + om1 * s[ko];
  };
  pair(1, 3, u_x, c.w1_omega);
  pair(2, 4, u_y, c.w1_omega);
  pair(5, 7, u_x + u_y, c.w2_omega);
  pair(8, 6, u_x - u_y, c.w2_omega);

  if (obst) {
    // reflected pull: each speed takes its opposite's streamed value
    const float r1 = s[1], r2 = s[2], r5 = s[5], r6 = s[6];
    s[1] = s[3]; s[3] = r1;
    s[2] = s[4]; s[4] = r2;
    s[5] = s[7]; s[7] = r5;
    s[6] = s[8]; s[8] = r6;
  } else {
#pragma unroll
    for (int k = 0; k < 9; ++k) s[k] = o[k];
  }
  return u_sq;
}

}  // namespace lbm
