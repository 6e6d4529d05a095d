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
//     write nothing above it) let B5 run it on sub-blocks of a tile. Its
//     main loop, product_tile, is also B6's product.
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
//       (b) B6 (launch_trsm) on the panel below, in place: one
//           trsm_block_kernel launch, the panel being 64 wide;
//       (c) update_kernel (B7's) with `lower` on the trailing lower
//           triangle, k = NB.
//     The first sub-panel reads A and writes L, the others work in L, so
//     only A's lower triangle is read; L is zeroed first (one memset), and
//     nothing writes above its diagonal. A bad pivot's NaN enters every
//     later column through (b) and (c), as in the column recurrence.
//     Launches per call: 1 memset and 3 * ceil(b / NB) - 2 kernels (58 at
//     b = 1280; the last sub-panel has no panel below): B6 is one launch on
//     each 64-wide panel.
//
// B6  launch_trsm   X = A L^-T of an (r, b) panel (solve X L^T = A).
//     Replaces blocked_cholesky.py::_pallas_trsm / _trsm_kernel. Bound:
//     r*b^2 flops against 67 TFLOP/s (fp32 FMA issue); the bytes (A read, X
//     written once) are 10x smaller at b = 1280. All but r*b*128/2 of the
//     r*b^2/2 FMAs are products of solved columns with L's rows, an SGEMM
//     bound like B7 by FFMA issue. The rest is the forward substitution,
//     serial along each row: a chain of b IEEE divisions, each behind a
//     branch to its slow path, which a one-thread-a-row walk can neither
//     feed (a shared load for every four FMAs) nor hide. Design: a
//     left-looking blocked solve, one launch of trsm_block_kernel a column
//     block J of 128 columns, in order on one stream (no synchronisation,
//     no allocation). A block of 256 threads owns 128 rows of X[:, J]:
//       (a) X[:, :J0] L[J, :J0]^T on B7's product_tile (its main loop,
//           shared device code) into B7's 8 x 8 register layout, and A[:, J]
//           minus that, in registers;
//       (b) the 128 x 128 tile solved there, right-looking in sub-blocks of
//           16 columns: 128 threads, one row each, substitute the
//           sub-block's 16 x 16 triangle in shared memory and store it to
//           X, then every thread subtracts its rank-16 product from its
//           later columns with B7's float4 loads (64 FMAs for four). L's
//           block is staged once, transposed, its strictly lower part only.
//     Fusing (a) and (b) keeps X[:, J] out of device memory between the two
//     and lets one block's product run beside another's substitution on an
//     SM. Launches per call: ceil(b / 128) (10 at b = 1280); one for B5's
//     64-wide panels. X may be A (B5's panels): a block reads its rows of A
//     before it writes them, and the product reads only X's finished
//     columns. L's strict upper triangle is never read; a NaN pivot gives
//     NaN in its column and, through (b)'s updates and later blocks' (a), in
//     every later one, as in the twin. Deterministic: no atomics, no split-K.
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

// acc = P[r0 : r0 + 128, 0:k] Q[c0 : c0 + 128, 0:k]^T, rows past r and b
// read as 0: this thread's 8 x 8 share, rows ty*4 + i and UP_HALF + ty*4 + i,
// columns tx*4 + j and UP_HALF + tx*4 + j. ps and qs hold two k-slices
// each; they are free again when it returns (it ends on a barrier).
template <bool VEC>
__device__ __forceinline__ void product_tile(const float* __restrict__ P, int ldp,
                                             const float* __restrict__ Q, int ldq, int r, int b,
                                             int k, int r0, int c0, int ty, int tx,
                                             float (*ps)[UP_BK][UP_LDS],
                                             float (*qs)[UP_BK][UP_LDS], float (&acc)[8][8]) {
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
  const int ty = (warp / 2) * 4 + lane / 8;
  const int tx = (warp % 2) * 8 + lane % 8;
  float acc[8][8];
  product_tile<VEC>(P, ldp, Q, ldq, r, b, k, r0, c0, ty, tx, ps, qs, acc);

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
constexpr int TD_W = 128;        // column block: one launch
constexpr int TD_ROWS = 128;     // rows of X a thread block
constexpr int TD_SUB = 16;       // columns substituted between two rank-16 updates
constexpr int TD_THREADS = 256;
constexpr int TD_LDS = TD_W + 4;     // padded row of the shared tiles
constexpr int TD_FILL = 16;          // loads in flight a thread while L is staged
static_assert(TD_W * TD_W % (TD_FILL * TD_THREADS) == 0, "staging loop");
static_assert(TD_ROWS == UP_TILE && TD_W == UP_TILE && TD_LDS == UP_LDS &&
                  TD_THREADS == UP_THREADS && 2 * TD_SUB == 2 * 2 * UP_BK,
              "a column block is one of B7's tiles; xs holds its k-slice buffers");
// lt[k][c] (TD_W rows), two xs[k][row] buffers (TD_SUB rows each), dg
constexpr int TD_SMEM = (TD_W * TD_LDS + 2 * TD_SUB * TD_LDS + TD_W) * (int)sizeof(float);

// acc -= x L^T over one sub-block: x = xb[k][rows] (k < TD_SUB), L^T's rows
// from lt0 (lt + s0); LO and HI select the column halves still to solve.
template <bool LO, bool HI>
__device__ __forceinline__ void td_update(float (&acc)[8][8], const float (*xb)[TD_LDS],
                                          const float (*lt0)[TD_LDS], int ty, int tx) {
#pragma unroll
  for (int kk = 0; kk < TD_SUB; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&xb[kk][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&xb[kk][64 + ty * 4]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 0 ? !LO : !HI) continue;
      const float4 b = *reinterpret_cast<const float4*>(&lt0[kk][h * 64 + tx * 4]);
      const float q[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][h * 4 + j] = fmaf(-a[i], q[j], acc[i][h * 4 + j]);
    }
  }
}

// One column block of B6: X[:, k : k + w] = (S - X[:, 0:k] Lr[:, 0:k]^T)
// Lr[:, k : k + w]^-T, where Lr is the block's w rows of L (w <= TD_W), S
// the block's columns of A and k the block's first column; TD_ROWS rows a
// block. The product runs on B7's product_tile into the same 8 x 8 register
// layout, and the tile is solved there, right-looking in sub-blocks of
// TD_SUB columns. Per sub-block: (1) the threads holding its 16 columns write
// them to shared memory, k-major; (2) 128 threads, one row each, run the
// Pallas body's forward substitution x_j = (s_j - sum_c x_c L[j][c]) /
// L[j][j] on the 16 x 16 triangle and store the solved columns to X; (3)
// every thread subtracts their rank-16 product with L from its later
// columns, as B7 does: four float4 shared loads for 64 FMAs. lt holds the
// triangle transposed, strictly lower part only (the rest 0); L's upper
// triangle is never read. S may be X + k: the block reads its rows of S
// before it writes any of X, and P (X's columns before k) is not written.
template <bool VEC>
__global__ void __launch_bounds__(TD_THREADS, 2)
    trsm_block_kernel(const float* __restrict__ Lr, int ldl, const float* S,
                      const float* __restrict__ P, float* X, int ld, int r, int w, int k) {
  extern __shared__ __align__(16) float td_smem[];
  float(*lt)[TD_LDS] = reinterpret_cast<float(*)[TD_LDS]>(td_smem);
  float(*xs)[TD_SUB][TD_LDS] = reinterpret_cast<float(*)[TD_SUB][TD_LDS]>(td_smem + TD_W * TD_LDS);
  float* dg = td_smem + TD_W * TD_LDS + 2 * TD_SUB * TD_LDS;
  // the product's two k-slice buffers are xs's floats, free before (1)
  float(*ps)[UP_BK][UP_LDS] = reinterpret_cast<float(*)[UP_BK][UP_LDS]>(xs);
  float(*qs)[UP_BK][UP_LDS] = ps + 2;
  const float* Ld = Lr + k;   // the block's diagonal triangle
  const int tid = threadIdx.x;
  // row c of the triangle read coalesced, TD_FILL loads in flight a thread
  for (int e0 = tid; e0 < TD_W * TD_W; e0 += TD_FILL * TD_THREADS) {
    float v[TD_FILL];
#pragma unroll
    for (int u = 0; u < TD_FILL; ++u) {
      const int c = (e0 + u * TD_THREADS) / TD_W;
      const int kk = (e0 + u * TD_THREADS) % TD_W;
      v[u] = (kk < c && c < w) ? Ld[(size_t)c * ldl + kk] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < TD_FILL; ++u)
      lt[(e0 + u * TD_THREADS) % TD_W][(e0 + u * TD_THREADS) / TD_W] = v[u];
  }
  if (tid < TD_W) dg[tid] = tid < w ? Ld[(size_t)tid * ldl + tid] : 1.0f;

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ty = (warp / 2) * 4 + lane / 8;    // rows ty*4 + i, 64 + ty*4 + i
  const int tx = (warp % 2) * 8 + lane % 8;    // columns tx*4 + j, 64 + tx*4 + j
  const int r0 = blockIdx.x * TD_ROWS;
  float acc[8][8];
  // its barriers also publish lt and dg
  product_tile<VEC>(P, ld, Lr, ldl, r, w, k, r0, 0, ty, tx, ps, qs, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + (i / 4) * 64 + ty * 4 + i % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = h * 64 + tx * 4;
      const float* src = S + (size_t)row * ld + col;
      if (VEC) {   // w % 4 == 0: a float4 lies wholly inside or wholly past w
        const float4 t = (row < r && col < w) ? *reinterpret_cast<const float4*>(src)
                                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        acc[i][h * 4] = t.x - acc[i][h * 4];
        acc[i][h * 4 + 1] = t.y - acc[i][h * 4 + 1];
        acc[i][h * 4 + 2] = t.z - acc[i][h * 4 + 2];
        acc[i][h * 4 + 3] = t.w - acc[i][h * 4 + 3];
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][h * 4 + j] = ((row < r && col + j < w) ? src[j] : 0.0f) - acc[i][h * 4 + j];
      }
    }
  }

#pragma unroll 1
  for (int s = 0; s * TD_SUB < w; ++s) {
    const int s0 = s * TD_SUB;
    float(*xb)[TD_LDS] = xs[s & 1];
    // (1) the sub-block's columns h*64 + [16q, 16q + 16), held by tx / 4 == q
    if (tx / 4 == s % 4) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = (i / 4) * 64 + ty * 4 + i % 4;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          xb[(tx % 4) * 4 + j][row] = s < 4 ? acc[i][j] : acc[i][4 + j];
      }
    }
    __syncthreads();
    // (2) forward substitution, one row a thread, right-looking: x_j's
    // division, then its products with column j of L (float4 reads) leave
    // the later columns; the row's solved columns go to X
    if (tid < TD_ROWS) {
      float x[TD_SUB];
#pragma unroll
      for (int m = 0; m < TD_SUB; ++m) x[m] = xb[m][tid];
#pragma unroll
      for (int j = 0; j < TD_SUB; ++j) {
        x[j] = x[j] / dg[s0 + j];
#pragma unroll
        for (int c = 0; c < TD_SUB; c += 4) {   // constant trip counts: the tests fold away
          if (c + 3 <= j) continue;
          const float4 l = *reinterpret_cast<const float4*>(&lt[s0 + j][s0 + c]);
          const float lc[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (c + u > j) x[c + u] = fmaf(-x[j], lc[u], x[c + u]);
        }
      }
#pragma unroll
      for (int m = 0; m < TD_SUB; ++m) xb[m][tid] = x[m];
      const int row = r0 + tid;
      float* dst = X + (size_t)row * ld + s0;
      if (row < r) {
        if (VEC) {   // w % 4 == 0
#pragma unroll
          for (int m = 0; m < TD_SUB; m += 4)
            if (s0 + m < w)
              *reinterpret_cast<float4*>(dst + m) = make_float4(x[m], x[m + 1], x[m + 2], x[m + 3]);
        } else {
#pragma unroll
          for (int m = 0; m < TD_SUB; ++m)
            if (s0 + m < w) dst[m] = x[m];
        }
      }
    }
    __syncthreads();
    // (3) the later columns lose the sub-block's product
    const int next = s0 + TD_SUB;
    if (next >= w) break;
    // a warp's columns are 64h + [cw, cw + 32): it skips a group wholly
    // solved or wholly past w
    const int cw = (warp % 2) * 32;
    const bool lo = cw + 32 > next && cw < w;
    const bool hi = 64 + cw + 32 > next && 64 + cw < w;
    if (lo && hi) {
      td_update<true, true>(acc, xb, lt + s0, ty, tx);
    } else if (hi) {
      td_update<false, true>(acc, xb, lt + s0, ty, tx);
    } else if (lo) {
      td_update<true, false>(acc, xb, lt + s0, ty, tx);
    }
  }
}

// TD_SMEM is past the 48 KB a launch gets by default: raise the limit of
// both instantiations, once a device (a host call of microseconds).
constexpr int TD_MAX_DEVICES = 64;
cudaError_t td_allow_smem() {
  static bool done[TD_MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < TD_MAX_DEVICES && done[dev])) return err;
  err = cudaFuncSetAttribute(trsm_block_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             TD_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(trsm_block_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, TD_SMEM);
  if (err == cudaSuccess && dev < TD_MAX_DEVICES) done[dev] = true;
  return err;
}

// X = A L^-T for A, X (r, b) with row stride ld and L with ldl; X may be A.
// One trsm_block_kernel launch per column block of TD_W columns, in order:
// block J needs every column before it solved.
cudaError_t launch_trsm(const float* L, int ldl, const float* A, float* X, int ld, int r,
                        int b, cudaStream_t stream) {
  if (r <= 0 || b <= 0) return cudaSuccess;
  cudaError_t err = td_allow_smem();
  const dim3 grid((r + TD_ROWS - 1) / TD_ROWS);
  for (int J0 = 0; err == cudaSuccess && J0 < b; J0 += TD_W) {
    const int w = b - J0 < TD_W ? b - J0 : TD_W;
    const float* Lr = L + (size_t)J0 * ldl;
    // float4 loads and stores (k = J0 is a multiple of 4) where rows are aligned
    const bool vec = ld % 4 == 0 && ldl % 4 == 0 && w % 4 == 0 &&
                     ((uintptr_t)Lr | (uintptr_t)(A + J0) | (uintptr_t)X) % 16 == 0;
    if (vec) {
      trsm_block_kernel<true><<<grid, TD_THREADS, TD_SMEM, stream>>>(Lr, ldl, A + J0, X,
                                                                      X + J0, ld, r, w, J0);
    } else {
      trsm_block_kernel<false><<<grid, TD_THREADS, TD_SMEM, stream>>>(Lr, ldl, A + J0, X,
                                                                       X + J0, ld, r, w, J0);
    }
    err = cudaGetLastError();
  }
  return err;
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
    err = rb::launch_trsm(Lf + at, b, S + below, Lf + below, b, rest, w, st);
    if (err != cudaSuccess) break;
    err = rb::launch_update(S + below + w, Lf + below + w, b, Lf + below, b, Lf + below, b,
                            rest, rest, w, 1, st);
  }
  return (int)err;
}

int rb_trsm(const void* L, const void* A, void* X, int r, int b, void* stream) {
  return (int)rb::launch_trsm(static_cast<const float*>(L), b, static_cast<const float*>(A),
                              static_cast<float*>(X), b, r, b, static_cast<cudaStream_t>(stream));
}

int rb_update(const void* C, const void* P, const void* Q, void* O, int r, int b, int k,
              int ldc, int ldp, int ldq, int lower, void* stream) {
  return (int)rb::launch_update(static_cast<const float*>(C), static_cast<float*>(O), ldc,
                                static_cast<const float*>(P), ldp, static_cast<const float*>(Q),
                                ldq, r, b, k, lower, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
