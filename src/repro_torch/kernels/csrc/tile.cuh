// B0: one K(A, B) tile, the pairwise Gram's (B3), and the kernel map kmap
// that B1, B2 and B3 share.
//
// Replaces repro/kernels/kernel_matvec.py::_tile and
// repro/core/kernels.py::tile_transform (the Pallas tile body: one MXU
// matmul for A_i B_j^T, row norms on the VPU, then the kernel's map).
//
// What bounds it on an H100: fp32 FMA issue. A (BM x BN) tile costs
// BM*BN*d FMAs for the dot products plus ~10-20 instructions per entry for
// the map; the bytes it reads are BM*d + BN*d floats per tile, two orders
// of magnitude fewer than the flops at d = 18.
//
// Design: 256 threads, each owning a 4 x 4 register micro-tile of dot
// products at rows ty + 16*i and columns tx + 16*j. The A and B rows are
// staged through shared memory in d-chunks of DK, stored k-major with one
// word of padding so the staging stores do not conflict and the inner-loop
// reads broadcast; any d fits (d = 90 and d = 512 run several chunks). The
// row norms a2 and b2 are summed from the same staged fp32 values. IEEE
// fp32 throughout: CUDA-core FMAs, no tensor cores, no fast-math
// intrinsics (expf and sqrtf, not __expf).
#pragma once

#include <cuda_runtime.h>

namespace rt {

constexpr int BM = 64;          // tile rows (A side)
constexpr int BN = 64;          // tile columns (B side)
constexpr int DK = 32;          // d-chunk staged per round
constexpr int TX = 16;          // threads along columns
constexpr int TY = 16;          // threads along rows
constexpr int TM = BM / TY;     // micro-tile rows per thread
constexpr int TN = BN / TX;     // micro-tile columns per thread
constexpr int NT = TX * TY;     // threads per block
constexpr int LDS = BM + 1;     // padded leading dimension of the staging
static_assert(BM == BN, "the staging loop loads A and B rows together");

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

struct TileSmem {
  float a[DK][LDS];
  float b[DK][LDS];
  float a2[BM];
  float b2[BN];
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

// Evaluate K(A[r0:r0+BM], B[c0:c0+BN]) into this thread's micro-tile
// k[i][j] = K(row r0 + ty + TY*i, column c0 + tx + TX*j). Columns at or past
// n are exact zeros; rows at or past m are evaluated on zero-filled inputs
// (finite values) and are the caller's to mask. Every thread of the block
// must call it: it synchronises the block.
__device__ __forceinline__ void eval_tile(const float* __restrict__ A, int m,
                                          const float* __restrict__ B, int n, int d,
                                          int r0, int c0, TileSmem& s, const KParams& kp,
                                          float k[TM][TN]) {
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  float nrm = 0.0f;  // tid < BM: a2 of row tid; BM <= tid < BM + BN: b2 of column

  for (int k0 = 0; k0 < d; k0 += DK) {
    const int kc = min(DK, d - k0);
    __syncthreads();  // the previous chunk (or tile) is no longer read
    for (int e = tid; e < BM * kc; e += NT) {
      const int r = e / kc;
      const int kk = e - r * kc;
      const int gr = r0 + r;
      const int gc = c0 + r;
      s.a[kk][r] = gr < m ? A[(size_t)gr * d + k0 + kk] : 0.0f;
      s.b[kk][r] = gc < n ? B[(size_t)gc * d + k0 + kk] : 0.0f;
    }
    __syncthreads();
    if (tid < BM) {
      for (int kk = 0; kk < kc; ++kk) nrm = fmaf(s.a[kk][tid], s.a[kk][tid], nrm);
    } else if (tid < BM + BN) {
      for (int kk = 0; kk < kc; ++kk) nrm = fmaf(s.b[kk][tid - BM], s.b[kk][tid - BM], nrm);
    }
#pragma unroll 4
    for (int kk = 0; kk < kc; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = s.a[kk][ty + TY * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = s.b[kk][tx + TX * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  if (tid < BM) {
    s.a2[tid] = nrm;
  } else if (tid < BM + BN) {
    s.b2[tid - BM] = nrm;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = tx + TX * j;
      k[i][j] = c0 + col < n ? kmap(acc[i][j], s.a2[ty + TY * i], s.b2[col], kp) : 0.0f;
    }
}

}  // namespace rt
