// Hand-written Hopper tile kernels of the blocked out-of-core Cholesky
// (sm_90a, IEEE fp32). The factorization loop of
// repro_torch/kernels/blocked_cholesky.py keeps the (M, M) matrix on the
// host and calls these on one panel at a time.
//
// B5  potrf_kernel   L = chol(A) of one (b, b) tile, lower, row-major.
//     Replaces repro/kernels/blocked_cholesky.py::_pallas_potrf /
//     _potrf_kernel. Bound on an H100: the column recurrence is sequential
//     (b steps, each needing the previous columns), so one tile runs in one
//     block and the bound is that block's latency, not the card's rates:
//     b^3/3 flops are 0.7 GFLOP at b = 1280, microseconds for the whole card.
//     Design: one block of 1024 threads works in global memory (a 1280^2
//     fp32 tile is 6.5 MB and stays in the 50 MB L2). Column j follows the
//     Pallas body: v = A[:, j] - L[:, :j] L[j, :j]^T, d = sqrt(v_j), column
//     j = [0; d; v_below / d]. Warp 0 forms d first; then each warp takes
//     rows i > j and sums its dot product over k in lane-strided, coalesced
//     reads with a shuffle reduction. A non-positive pivot gives d = NaN, as
//     the Pallas kernel does (no clamp), and NaN spreads to every later
//     column.
//
// B6  trsm_kernel    X = A L^-T of an (r, b) panel (solve X L^T = A).
//     Replaces blocked_cholesky.py::_pallas_trsm / _trsm_kernel. Bound:
//     r*b^2 flops against 67 TFLOP/s (fp32 FMA issue); the bytes (A read, X
//     written once) are 10x smaller at b = 1280. Design: rows are
//     independent, so each block owns 64 rows and walks the columns in
//     chunks of 32: the chunk's right side A[:, J] minus X[:, :J] L[J, :J]^T
//     is a shared-memory-tiled product (X's finished columns and L's rows
//     staged 32 wide), then 64 threads solve the 32 x 32 diagonal triangle
//     by forward substitution in shared memory and the chunk is stored.
//
// B7  update_kernel  O = C - P Q^T: (r, b) = (r, b) - (r, k)(b, k)^T.
//     Replaces blocked_cholesky.py::_pallas_update / _update_kernel. Bound:
//     2*r*b*k flops against 67 TFLOP/s. Design: a 64 x 64 output tile per
//     block, 256 threads with 4 x 4 register micro-tiles, P and Q staged
//     k-major through shared memory 32 columns at a time. The ragged r, b and
//     k edges are masked at the loads, so the contraction width k (the factor
//     panel, 1280) is independent of the output width b (80 on the last
//     panel): the a8ae930 fix of the reference holds by construction. O may
//     be C itself (each entry is read and written by one thread).
//
// CUDA-core fmaf, IEEE division and sqrtf: no tensor cores (TF32 would
// break the fp32 bound), no --use_fast_math. Plain C interface, linked by
// repro_torch/kernels/build.py into one library with kernel_matvec.cu (whose
// rt_error_string names the errors) and loaded with ctypes; every entry
// returns cudaGetLastError() after its launch.
#include <cuda_runtime.h>
#include <math.h>

namespace rb {

constexpr int POTRF_THREADS = 1024;
constexpr int WARP = 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// lane-strided dot of rows a[0:j] and b[0:j], summed over the warp
__device__ __forceinline__ float row_dot(const float* a, const float* b, int j, int lane) {
  float s = 0.0f;
  for (int k = lane; k < j; k += WARP) s = fmaf(a[k], b[k], s);
  return warp_sum(s);
}

__global__ void __launch_bounds__(POTRF_THREADS)
    potrf_kernel(const float* __restrict__ A, float* L, int b) {
  __shared__ float d_s;
  const int tid = threadIdx.x;
  const int lane = tid % WARP;
  const int warp = tid / WARP;
  const int nwarps = blockDim.x / WARP;
  const size_t bb = (size_t)b * b;
  for (size_t e = tid; e < bb; e += blockDim.x) {
    const int r = (int)(e / b);
    const int c = (int)(e - (size_t)r * b);
    L[e] = c <= r ? A[e] : 0.0f;
  }
  __syncthreads();
  for (int j = 0; j < b; ++j) {
    const float* lj = L + (size_t)j * b;
    if (warp == 0) {
      const float v = L[(size_t)j * b + j] - row_dot(lj, lj, j, lane);
      if (lane == 0) {
        const float d = v > 0.0f ? sqrtf(v) : nanf("");
        d_s = d;
        L[(size_t)j * b + j] = d;
      }
    }
    __syncthreads();
    const float d = d_s;
    for (int i = j + 1 + warp; i < b; i += nwarps) {
      float* li = L + (size_t)i * b;
      const float v = li[j] - row_dot(li, lj, j, lane);
      if (lane == 0) li[j] = v / d;
    }
    __syncthreads();
  }
}

constexpr int TR_ROWS = 64;   // rows of X per block
constexpr int TR_COLS = 32;   // columns solved per chunk
constexpr int TR_THREADS = 256;
constexpr int TR_RY = TR_THREADS / TR_COLS;   // 8 row groups
constexpr int TR_RM = TR_ROWS / TR_RY;        // 8 rows per thread

// X must not be __restrict__ const: the block reads back the columns it wrote.
__global__ void __launch_bounds__(TR_THREADS)
    trsm_kernel(const float* __restrict__ L, const float* __restrict__ A, float* X, int r,
                int b) {
  __shared__ float xs[TR_ROWS][TR_COLS + 1];
  __shared__ float ls[TR_COLS][TR_COLS + 1];
  const int tid = threadIdx.x;
  const int tx = tid % TR_COLS;
  const int ty = tid / TR_COLS;
  const int r0 = blockIdx.x * TR_ROWS;
  for (int J0 = 0; J0 < b; J0 += TR_COLS) {
    const int col = J0 + tx;
    float acc[TR_RM];
#pragma unroll
    for (int i = 0; i < TR_RM; ++i) {
      const int row = r0 + ty + TR_RY * i;
      acc[i] = (row < r && col < b) ? A[(size_t)row * b + col] : 0.0f;
    }
    // acc -= X[:, :J0] L[J0:J0+32, :J0]^T, 32 columns of k at a time
    for (int k0 = 0; k0 < J0; k0 += TR_COLS) {
      for (int e = tid; e < TR_ROWS * TR_COLS; e += TR_THREADS) {
        const int rr = e / TR_COLS;
        const int kk = e - rr * TR_COLS;
        const int row = r0 + rr;
        xs[rr][kk] = row < r ? X[(size_t)row * b + k0 + kk] : 0.0f;
      }
      for (int e = tid; e < TR_COLS * TR_COLS; e += TR_THREADS) {
        const int c = e / TR_COLS;
        const int kk = e - c * TR_COLS;
        ls[c][kk] = J0 + c < b ? L[(size_t)(J0 + c) * b + k0 + kk] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < TR_COLS; ++kk) {
        const float lv = ls[tx][kk];
#pragma unroll
        for (int i = 0; i < TR_RM; ++i) acc[i] = fmaf(-xs[ty + TR_RY * i][kk], lv, acc[i]);
      }
      __syncthreads();
    }
    // the 32 x 32 diagonal triangle, by forward substitution
#pragma unroll
    for (int i = 0; i < TR_RM; ++i) xs[ty + TR_RY * i][tx] = acc[i];
    for (int e = tid; e < TR_COLS * TR_COLS; e += TR_THREADS) {
      const int c = e / TR_COLS;
      const int cc = e - c * TR_COLS;
      ls[c][cc] = (J0 + c < b && J0 + cc < b) ? L[(size_t)(J0 + c) * b + J0 + cc] : 0.0f;
    }
    __syncthreads();
    const int width = min(TR_COLS, b - J0);
    if (tid < TR_ROWS) {
      for (int c = 0; c < width; ++c) {
        float x = xs[tid][c];
        for (int cc = 0; cc < c; ++cc) x = fmaf(-xs[tid][cc], ls[c][cc], x);
        xs[tid][c] = x / ls[c][c];
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TR_RM; ++i) {
      const int row = r0 + ty + TR_RY * i;
      if (row < r && col < b) X[(size_t)row * b + col] = xs[ty + TR_RY * i][tx];
    }
    __syncthreads();  // X's new columns are read by the next chunk's staging
  }
}

constexpr int UP_TILE = 64;
constexpr int UP_K = 32;
constexpr int UP_T = 16;                 // threads per tile side
constexpr int UP_M = UP_TILE / UP_T;     // 4 x 4 micro-tile
constexpr int UP_THREADS = UP_T * UP_T;

// O may alias C: neither is __restrict__.
__global__ void __launch_bounds__(UP_THREADS)
    update_kernel(const float* C, const float* __restrict__ P, const float* __restrict__ Q,
                  float* O, int r, int b, int k) {
  __shared__ float ps[UP_K][UP_TILE + 1];
  __shared__ float qs[UP_K][UP_TILE + 1];
  const int tid = threadIdx.x;
  const int tx = tid % UP_T;
  const int ty = tid / UP_T;
  const int r0 = blockIdx.x * UP_TILE;
  const int c0 = blockIdx.y * UP_TILE;
  float acc[UP_M][UP_M];
#pragma unroll
  for (int i = 0; i < UP_M; ++i)
#pragma unroll
    for (int j = 0; j < UP_M; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < k; k0 += UP_K) {
    for (int e = tid; e < UP_TILE * UP_K; e += UP_THREADS) {
      const int rr = e / UP_K;
      const int kk = e - rr * UP_K;
      const bool kin = k0 + kk < k;
      ps[kk][rr] = (kin && r0 + rr < r) ? P[(size_t)(r0 + rr) * k + k0 + kk] : 0.0f;
      qs[kk][rr] = (kin && c0 + rr < b) ? Q[(size_t)(c0 + rr) * k + k0 + kk] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < UP_K; ++kk) {
      float a[UP_M], q[UP_M];
#pragma unroll
      for (int i = 0; i < UP_M; ++i) a[i] = ps[kk][ty + UP_T * i];
#pragma unroll
      for (int j = 0; j < UP_M; ++j) q[j] = qs[kk][tx + UP_T * j];
#pragma unroll
      for (int i = 0; i < UP_M; ++i)
#pragma unroll
        for (int j = 0; j < UP_M; ++j) acc[i][j] = fmaf(a[i], q[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < UP_M; ++i) {
    const int row = r0 + ty + UP_T * i;
    if (row >= r) continue;
#pragma unroll
    for (int j = 0; j < UP_M; ++j) {
      const int col = c0 + tx + UP_T * j;
      if (col < b) {
        const size_t o = (size_t)row * b + col;
        O[o] = C[o] - acc[i][j];
      }
    }
  }
}

}  // namespace rb

extern "C" {

int rb_potrf(const void* A, void* L, int b, void* stream) {
  rb::potrf_kernel<<<1, rb::POTRF_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<float*>(L), b);
  return (int)cudaGetLastError();
}

int rb_trsm(const void* L, const void* A, void* X, int r, int b, void* stream) {
  const int blocks = (r + rb::TR_ROWS - 1) / rb::TR_ROWS;
  rb::trsm_kernel<<<blocks, rb::TR_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), static_cast<const float*>(A), static_cast<float*>(X), r, b);
  return (int)cudaGetLastError();
}

int rb_update(const void* C, const void* P, const void* Q, void* O, int r, int b, int k,
              void* stream) {
  const dim3 grid((r + rb::UP_TILE - 1) / rb::UP_TILE, (b + rb::UP_TILE - 1) / rb::UP_TILE);
  rb::update_kernel<<<grid, rb::UP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(C), static_cast<const float*>(P), static_cast<const float*>(Q),
      static_cast<float*>(O), r, b, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
