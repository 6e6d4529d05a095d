// The kernel map kmap that B1, B2 and B3 share, and the spec it reads.
//
// Replaces repro/core/kernels.py::tile_transform (the map the Pallas tile
// bodies apply after their MXU matmul of A_i B_j^T). The tile code that
// feeds it, 128 x 128 tiles of CUDA-core FMAs (TileWalk), is in
// kernel_matvec.cu: B1, B2 and B3 all evaluate their tiles through it, and
// each instantiates the map at a compile-time kind (map_tile<KIND>), so
// that the switch below folds away.
//
// IEEE fp32 throughout: every step rounded as written (no contraction into
// FMA), no fast-math intrinsics (expf and sqrtf, not __expf).
#pragma once

#include <cuda_runtime.h>

namespace rt {

// Kernel kinds: the order of repro_torch.kernels.kernel_matvec.KIND_CODES.
enum Kind : int { GAUSSIAN = 0, LAPLACIAN = 1, MATERN32 = 2, LINEAR = 3, POLYNOMIAL = 4 };

// The spec's static parameters, folded on the host exactly as the
// reference folds its Python scalars into fp32:
//   coef = fp32(-0.5 / sigma^2)   ss = fp32(scale^2)
struct KParams {
  int kind;
  float sigma;
  float coef;
  float ss;
  float c;
  int degree;
};

__device__ __forceinline__ float sqdist(float ab, float a2, float b2) {
  // max(a2 + b2 - 2ab, 0), rounded step by step (no contraction into FMA)
  return fmaxf(__fsub_rn(__fadd_rn(a2, b2), __fmul_rn(2.0f, ab)), 0.0f);
}

// The kernel map of repro_torch.core.kernels.tile_transform.
__device__ __forceinline__ float kmap(float ab, float a2, float b2, const KParams& p) {
  switch (p.kind) {
    case GAUSSIAN:
      return expf(__fmul_rn(p.coef, sqdist(ab, a2, b2)));
    case LAPLACIAN: {
      float r = sqrtf(__fadd_rn(sqdist(ab, a2, b2), 1e-12f));
      return expf(__fdiv_rn(-r, p.sigma));
    }
    case MATERN32: {
      float r = sqrtf(__fadd_rn(sqdist(ab, a2, b2), 1e-12f));
      float a = __fdiv_rn(__fmul_rn(1.7320508075688772f, r), p.sigma);
      return __fmul_rn(__fadd_rn(1.0f, a), expf(-a));
    }
    case LINEAR:
      return __fdiv_rn(ab, p.ss);
    default: {  // POLYNOMIAL: repeated multiply, int(degree) times
      float base = __fadd_rn(__fdiv_rn(ab, p.ss), p.c);
      float out = 1.0f;
      for (int i = 0; i < p.degree; ++i) out = __fmul_rn(out, base);
      return out;
    }
  }
}

}  // namespace rt
