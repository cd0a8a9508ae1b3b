// Float32 pair arithmetic shared by the pair kernels, rounded step by step as
// the plain torch versions round it (ops/geometry.py). Every operation is an
// explicitly rounded intrinsic, never contracted into an FMA; the build also
// passes -fmad=false.
#pragma once

#include <cuda_runtime.h>

// One Cartesian component wrapped into the primary image: dx - b * rint(dx / b),
// with ib = 1/b a float32 computed on the host; rintf rounds half to even, as
// torch.round does.
__device__ __forceinline__ float min_image(float dx, float b, float ib) {
  return __fsub_rn(dx, __fmul_rn(b, rintf(__fmul_rn(dx, ib))));
}

// dx*dx + dy*dy + dz*dz, left to right.
__device__ __forceinline__ float squared_norm(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}
