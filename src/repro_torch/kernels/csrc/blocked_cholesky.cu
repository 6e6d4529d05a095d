// Hand-written Hopper tile kernels of the blocked out-of-core Cholesky
// (sm_90a, IEEE fp32). The factorization loop of
// repro_torch/kernels/blocked_cholesky.py keeps the (M, M) matrix on the
// host and calls these on one panel at a time.
//
// B7  update_kernel  O = C - P Q^T: (r, b) = (r, b) - (r, k)(b, k)^T, an
//     "NT" SGEMM with the subtraction as its epilogue.
//     Replaces repro/kernels/blocked_cholesky.py::_pallas_update /
//     _update_kernel. Bound on an H100: 2*r*b*k flops against 67 TFLOP/s of
//     fp32 FMA issue (the bytes are 10x smaller at b = k = 1280). Every
//     issue slot that is not an FFMA is lost, and with scalar shared-memory
//     reads a 4 x 4 micro-tile spends one load per two FMAs.
//     Design: a 128 x 128 output tile per block of 256 threads, each
//     holding an 8 x 8 accumulator laid out as 2 x 2 blocks of 4 x 4 (rows
//     ty*4 and 64 + ty*4, columns tx*4 and 64 + tx*4): one k step is four
//     conflict-free float4 shared loads for 64 FMAs. k runs in slices of 8,
//     double-buffered: the next slice is loaded from global memory into
//     registers (one float4 of P and one of Q per thread) while the current
//     one is multiplied, then stored k-major (transposed) into the other
//     shared buffer, one __syncthreads per slice. Register prefetch rather
//     than a cp.async ring, because the transpose to k-major has to pass
//     through registers anyway and keeps the micro-kernel's reads float4.
//     Two blocks fit an SM (128 registers a thread). The ragged r, b and k
//     edges are masked at the loads, so the contraction width k (the factor
//     panel, 1280) is independent of the output width b (80 on the last
//     panel): the a8ae930 fix of the reference holds by construction. When
//     k % 4 != 0, or a pointer or leading dimension is not 16-byte aligned,
//     the launcher takes the scalar-load instantiation of the same kernel.
//     Each output is read and written by one thread, in one k order: O may
//     be C itself, and the result is deterministic (no split-K). Leading
//     dimensions and a `lower` flag (skip tiles wholly above the diagonal,
//     write nothing above it) let B5 run it on sub-blocks of a tile.
//
// B5  rb_potrf       L = chol(A) of one (b, b) tile, lower, row-major.
//     Replaces blocked_cholesky.py::_pallas_potrf / _potrf_kernel. Bound:
//     b^3/3 flops are 0.7 GFLOP at b = 1280, microseconds for the whole
//     card; the real limit is the dependence from column to column, and a
//     column-by-column walk on one SM leaves the other 131 idle. Design: a
//     right-looking blocked Cholesky of the tile, run by a host loop of
//     launches on one stream (no synchronisation, no allocation). For each
//     sub-panel s of width NB = 64:
//       (a) potrf_diag_kernel: one block loads the NB x NB diagonal block
//           into shared memory and runs the Pallas body's column recurrence
//           there, v = a - L l^T, d = sqrt(v_j) (NaN for a non-positive
//           pivot, never clamped), column = [0; d; v_below / d];
//       (b) trsm_kernel (B6's device kernel) on the panel below, in place;
//       (c) update_kernel (B7's) with `lower` on the trailing lower
//           triangle, k = NB.
//     The first sub-panel reads A and writes L, the others work in L, so
//     only A's lower triangle is read; L is zeroed first (one memset), and
//     nothing writes above its diagonal. A bad pivot's NaN enters every
//     later column through (b) and (c), as in the column recurrence.
//     Launches per call: 1 memset and 3 * ceil(b / NB) - 2 kernels (58 at
//     b = 1280; the last sub-panel has no panel below).
//
// B6  trsm_kernel    X = A L^-T of an (r, b) panel (solve X L^T = A).
//     Replaces blocked_cholesky.py::_pallas_trsm / _trsm_kernel. Bound:
//     r*b^2 flops against 67 TFLOP/s (fp32 FMA issue); the bytes (A read, X
//     written once) are 10x smaller at b = 1280. Design: rows are
//     independent, so each block owns 64 rows and walks the columns in
//     chunks of 32: the chunk's right side A[:, J] minus X[:, :J] L[J, :J]^T
//     is a shared-memory-tiled product (X's finished columns and L's rows
//     staged 32 wide), then 64 threads solve the 32 x 32 diagonal triangle
//     by forward substitution in shared memory and the chunk is stored. X
//     may be A (B5's panels): each block reads a chunk of A before it
//     writes that chunk, and no other block touches its rows.
//
// CUDA-core fmaf, IEEE division and sqrtf: no tensor cores (TF32 would
// break the fp32 bound), no --use_fast_math. Plain C interface, linked by
// repro_torch/kernels/build.py into one library with kernel_matvec.cu (whose
// rt_error_string names the errors) and loaded with ctypes; every entry
// returns cudaGetLastError() after its launches.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rb {

// ---------------------------------------------------------------------------
// B7: O = C - P Q^T
// ---------------------------------------------------------------------------
constexpr int UP_TILE = 128;                 // output tile rows and columns
constexpr int UP_HALF = UP_TILE / 2;         // offset of the second 4 x 4 block
constexpr int UP_BK = 8;                     // k-slice per stage
constexpr int UP_THREADS = 256;
constexpr int UP_LDS = UP_TILE + 4;          // padded k-major row of a slice
constexpr int UP_VEC = UP_BK / 4;            // float4 per tile row per slice
constexpr int UP_LOADS = UP_TILE * UP_VEC / UP_THREADS;   // float4 per thread
static_assert(UP_LOADS >= 1 && UP_TILE * UP_VEC % UP_THREADS == 0, "slice loads");

// One slice X[x0 : x0 + 128, k0 : k0 + 8] into registers, zero past the
// ragged edges (x >= rows, k' >= k).
template <bool VEC>
__device__ __forceinline__ void load_slice(const float* __restrict__ X, int ldx, int rows,
                                           int k, int x0, int k0, float (&v)[UP_LOADS][4]) {
#pragma unroll
  for (int l = 0; l < UP_LOADS; ++l) {
    const int idx = threadIdx.x + l * UP_THREADS;
    const int row = x0 + idx / UP_VEC;
    const int kk = k0 + (idx % UP_VEC) * 4;
    const float* src = X + (size_t)row * ldx + kk;
    if (VEC) {   // k % 4 == 0: a float4 lies wholly inside or wholly past k
      const float4 t = (row < rows && kk < k) ? *reinterpret_cast<const float4*>(src)
                                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[l][0] = t.x;
      v[l][1] = t.y;
      v[l][2] = t.z;
      v[l][3] = t.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[l][i] = (row < rows && kk + i < k) ? src[i] : 0.0f;
    }
  }
}

// The registers of load_slice, stored k-major: s[k'][row].
__device__ __forceinline__ void store_slice(float (*s)[UP_LDS], const float (&v)[UP_LOADS][4]) {
#pragma unroll
  for (int l = 0; l < UP_LOADS; ++l) {
    const int idx = threadIdx.x + l * UP_THREADS;
    const int row = idx / UP_VEC;
    const int kk = (idx % UP_VEC) * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) s[kk + i][row] = v[l][i];
  }
}

// O and C may alias: neither is __restrict__.
template <bool VEC>
__global__ void __launch_bounds__(UP_THREADS, 2)
    update_kernel(const float* C, float* O, int ldc, const float* __restrict__ P, int ldp,
                  const float* __restrict__ Q, int ldq, int r, int b, int k, int lower) {
  __shared__ __align__(16) float ps[2][UP_BK][UP_LDS];
  __shared__ __align__(16) float qs[2][UP_BK][UP_LDS];
  const int r0 = blockIdx.y * UP_TILE;
  const int c0 = blockIdx.x * UP_TILE;
  if (lower && c0 > r0 + UP_TILE - 1) return;   // wholly above the diagonal
  // a warp covers 4 x 8 threads: 64 rows of P and 128 columns of Q per k
  // step, so its float4 reads of a slice are 4 and 8 distinct addresses
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ty = (warp / 2) * 4 + lane / 8;    // rows ty*4 + i, UP_HALF + ty*4 + i
  const int tx = (warp % 2) * 8 + lane % 8;    // columns tx*4 + j, UP_HALF + tx*4 + j

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  float pv[UP_LOADS][4], qv[UP_LOADS][4];
  load_slice<VEC>(P, ldp, r, k, r0, 0, pv);
  load_slice<VEC>(Q, ldq, b, k, c0, 0, qv);
  store_slice(ps[0], pv);
  store_slice(qs[0], qv);
  __syncthreads();

  int buf = 0;
  for (int k0 = 0; k0 < k; k0 += UP_BK) {
    const bool more = k0 + UP_BK < k;
    if (more) {   // in flight while this slice is multiplied
      load_slice<VEC>(P, ldp, r, k, r0, k0 + UP_BK, pv);
      load_slice<VEC>(Q, ldq, b, k, c0, k0 + UP_BK, qv);
    }
#pragma unroll
    for (int kk = 0; kk < UP_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&ps[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&ps[buf][kk][UP_HALF + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&qs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&qs[buf][kk][UP_HALF + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float q[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], q[j], acc[i][j]);
    }
    if (more) {   // the other buffer was last read before the previous barrier
      store_slice(ps[buf ^ 1], pv);
      store_slice(qs[buf ^ 1], qv);
    }
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + (i / 4) * UP_HALF + ty * 4 + i % 4;
    if (row >= r) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = c0 + h * UP_HALF + tx * 4;
      const size_t o = (size_t)row * ldc + col;
      if (VEC && col + 3 < b && (!lower || col + 3 <= row)) {
        float4 c = *reinterpret_cast<const float4*>(C + o);
        c.x -= acc[i][h * 4];
        c.y -= acc[i][h * 4 + 1];
        c.z -= acc[i][h * 4 + 2];
        c.w -= acc[i][h * 4 + 3];
        *reinterpret_cast<float4*>(O + o) = c;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < b && (!lower || col + j <= row)) O[o + j] = C[o + j] - acc[i][h * 4 + j];
      }
    }
  }
}

// ldc, ldp and ldq are the row strides of C and O, of P and of Q; `lower`
// writes only the entries on and below the diagonal (row >= column).
cudaError_t launch_update(const float* C, float* O, int ldc, const float* P, int ldp,
                          const float* Q, int ldq, int r, int b, int k, int lower,
                          cudaStream_t stream) {
  const bool vec = k % 4 == 0 && ldc % 4 == 0 && ldp % 4 == 0 && ldq % 4 == 0 &&
                   ((uintptr_t)C | (uintptr_t)O | (uintptr_t)P | (uintptr_t)Q) % 16 == 0;
  const dim3 grid((b + UP_TILE - 1) / UP_TILE, (r + UP_TILE - 1) / UP_TILE);
  if (vec) {
    update_kernel<true><<<grid, UP_THREADS, 0, stream>>>(C, O, ldc, P, ldp, Q, ldq, r, b, k,
                                                         lower);
  } else {
    update_kernel<false><<<grid, UP_THREADS, 0, stream>>>(C, O, ldc, P, ldp, Q, ldq, r, b, k,
                                                          lower);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B6: X = A L^-T
// ---------------------------------------------------------------------------
constexpr int TR_ROWS = 64;   // rows of X per block
constexpr int TR_COLS = 32;   // columns solved per chunk
constexpr int TR_THREADS = 256;
constexpr int TR_RY = TR_THREADS / TR_COLS;   // 8 row groups
constexpr int TR_RM = TR_ROWS / TR_RY;        // 8 rows per thread

// A and X may alias, so neither is __restrict__; the block reads back the
// columns of X it wrote. PACKED: every row stride is b (B6's own panels),
// known to the compiler, whose index arithmetic is then measurably cheaper
// than with three run-time strides (B5's sub-panels).
template <bool PACKED>
__global__ void __launch_bounds__(TR_THREADS)
    trsm_kernel(const float* __restrict__ L, int ldl, const float* A, int lda, float* X,
                int ldx, int r, int b) {
  if (PACKED) ldl = lda = ldx = b;
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
      acc[i] = (row < r && col < b) ? A[(size_t)row * lda + col] : 0.0f;
    }
    // acc -= X[:, :J0] L[J0:J0+32, :J0]^T, 32 columns of k at a time
    for (int k0 = 0; k0 < J0; k0 += TR_COLS) {
      for (int e = tid; e < TR_ROWS * TR_COLS; e += TR_THREADS) {
        const int rr = e / TR_COLS;
        const int kk = e - rr * TR_COLS;
        const int row = r0 + rr;
        xs[rr][kk] = row < r ? X[(size_t)row * ldx + k0 + kk] : 0.0f;
      }
      for (int e = tid; e < TR_COLS * TR_COLS; e += TR_THREADS) {
        const int c = e / TR_COLS;
        const int kk = e - c * TR_COLS;
        ls[c][kk] = J0 + c < b ? L[(size_t)(J0 + c) * ldl + k0 + kk] : 0.0f;
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
      ls[c][cc] = (J0 + c < b && J0 + cc < b) ? L[(size_t)(J0 + c) * ldl + J0 + cc] : 0.0f;
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
      if (row < r && col < b) X[(size_t)row * ldx + col] = xs[ty + TR_RY * i][tx];
    }
    __syncthreads();  // X's new columns are read by the next chunk's staging
  }
}

cudaError_t launch_trsm(const float* L, int ldl, const float* A, int lda, float* X, int ldx,
                        int r, int b, cudaStream_t stream) {
  const int blocks = (r + TR_ROWS - 1) / TR_ROWS;
  if (ldl == b && lda == b && ldx == b) {
    trsm_kernel<true><<<blocks, TR_THREADS, 0, stream>>>(L, ldl, A, lda, X, ldx, r, b);
  } else {
    trsm_kernel<false><<<blocks, TR_THREADS, 0, stream>>>(L, ldl, A, lda, X, ldx, r, b);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B5: the diagonal block of one sub-panel
// ---------------------------------------------------------------------------
constexpr int PO_NB = 64;                        // sub-panel width
constexpr int PO_THREADS = 256;
constexpr int PO_LANES = PO_THREADS / PO_NB;     // 4 adjacent lanes share a row
constexpr int PO_LDS = PO_NB + 4;                // row stride 4 mod 32: lane l at bank l + 4t

// chol of the (w, w) block at S (lower triangle read) into D, both with row
// stride ld; D may be S. Writes the lower triangle of D only.
__global__ void __launch_bounds__(PO_THREADS)
    potrf_diag_kernel(const float* S, float* D, int ld, int w) {
  __shared__ float a[PO_NB][PO_LDS];
  __shared__ float dg[PO_NB];   // the pivots; a[j][j] keeps v's input
  const int tid = threadIdx.x;
  for (int e = tid; e < PO_NB * PO_NB; e += PO_THREADS) {
    const int i = e / PO_NB;
    const int j = e - i * PO_NB;
    a[i][j] = (i < w && j <= i) ? S[(size_t)i * ld + j] : 0.0f;
  }
  __syncthreads();
  const int row = tid / PO_LANES;
  const int q = tid % PO_LANES;
  for (int j = 0; j < w; ++j) {
    // every row group forms the pivot's sum itself (the same sum, in the
    // same order) and its own row's, so one barrier per column suffices;
    // a fixed trip count with the terms past j zeroed lets all the shared
    // loads issue at once instead of one loop turn at a time
    float sj = 0.0f, si = 0.0f;
#pragma unroll
    for (int t = 0; t < PO_NB / PO_LANES; ++t) {
      const int kk = q + PO_LANES * t;
      const float l = kk < j ? a[j][kk] : 0.0f;
      const float x = kk < j ? a[row][kk] : 0.0f;
      sj = fmaf(l, l, sj);
      si = fmaf(x, l, si);
    }
#pragma unroll
    for (int o = 1; o < PO_LANES; o <<= 1) {
      sj += __shfl_xor_sync(0xffffffffu, sj, o);
      si += __shfl_xor_sync(0xffffffffu, si, o);
    }
    const float v = a[j][j] - sj;
    const float d = v > 0.0f ? sqrtf(v) : nanf("");
    if (q == 0) {
      if (row == j) {
        dg[j] = d;
      } else if (row > j && row < w) {
        a[row][j] = (a[row][j] - si) / d;
      }
    }
    __syncthreads();
  }
  for (int e = tid; e < w * w; e += PO_THREADS) {
    const int i = e / w;
    const int j = e - i * w;
    if (j <= i) D[(size_t)i * ld + j] = i == j ? dg[i] : a[i][j];
  }
}

}  // namespace rb

extern "C" {

int rb_potrf(const void* A, void* L, int b, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* Af = static_cast<const float*>(A);
  float* Lf = static_cast<float*>(L);
  cudaError_t err = cudaMemsetAsync(Lf, 0, (size_t)b * b * sizeof(float), st);
  for (int s = 0; err == cudaSuccess && s < b; s += rb::PO_NB) {
    const float* S = s == 0 ? Af : Lf;   // the first sub-panel reads A
    const size_t at = (size_t)s * b + s;
    const int w = b - s < rb::PO_NB ? b - s : rb::PO_NB;
    const int rest = b - s - w;
    rb::potrf_diag_kernel<<<1, rb::PO_THREADS, 0, st>>>(S + at, Lf + at, b, w);
    err = cudaGetLastError();
    if (err != cudaSuccess || rest == 0) break;
    const size_t below = at + (size_t)w * b;   // row s + w, column s
    err = rb::launch_trsm(Lf + at, b, S + below, b, Lf + below, b, rest, w, st);
    if (err != cudaSuccess) break;
    err = rb::launch_update(S + below + w, Lf + below + w, b, Lf + below, b, Lf + below, b,
                            rest, rest, w, 1, st);
  }
  return (int)err;
}

int rb_trsm(const void* L, const void* A, void* X, int r, int b, void* stream) {
  return (int)rb::launch_trsm(static_cast<const float*>(L), b, static_cast<const float*>(A), b,
                              static_cast<float*>(X), b, r, b,
                              static_cast<cudaStream_t>(stream));
}

int rb_update(const void* C, const void* P, const void* Q, void* O, int r, int b, int k,
              int ldc, int ldp, int ldq, int lower, void* stream) {
  return (int)rb::launch_update(static_cast<const float*>(C), static_cast<float*>(O), ldc,
                                static_cast<const float*>(P), ldp, static_cast<const float*>(Q),
                                ldq, r, b, k, lower, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
