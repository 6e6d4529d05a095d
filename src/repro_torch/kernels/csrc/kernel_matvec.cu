// Hand-written Hopper kernels for FALKON's O(nMt) hot loop (sm_90a, IEEE fp32).
//
// B1  fused_sweep_kernel   w = K(X,C)^T (K(X,C) u + v)
//     Replaces repro/kernels/kernel_matvec.py::fused_sweep_pallas /
//     _fused_sweep_kernel. Bound on an H100: fp32 FMA issue. The function
//     needs about n*M*(2d + 10 + 4p) flops against 67 TFLOP/s (one
//     evaluation per entry); its bytes (X once, u, v, w) are negligible.
//     Design: the TPU kernel keeps a (bm, M) Gram row strip in VMEM so each
//     tile is evaluated once; at M = 10^4 that strip is megabytes and does
//     not fit the 227 KB of shared memory, so this kernel evaluates each
//     tile twice and makes each evaluation cheap. Its tile is 128 x 128
//     (256 threads, an 8 x 8 register micro-tile each in B7's layout: one
//     k step is four conflict-free float4 shared loads for 64 FMAs).
//       - pack_centers (a prologue launch, counted as part of B1) writes C
//         once per sweep into a scratch tensor, k-major per 128-center
//         tile, with ||c||^2 and u behind it, zero past M and p.
//       - A persistent grid of G blocks (occupancy x 132 SMs) walks the
//         128-row blocks i. A block stages X_i k-major into shared memory
//         once per row block (with its row norms, in registers) and keeps
//         it there for every center tile (d <= 128; past that X_i is
//         staged again in 128-deep k-chunks per tile).
//       - The center tiles stream through a two-stage shared-memory ring
//         of 32-deep k-chunks with 16-byte cp.async copies: the copy of
//         the next chunk is in flight while this one's FMAs run, one
//         __syncthreads per chunk.
//       - The kernel map is applied in registers; the kernel is built once per
//         kernel kind, so no switch (and no other kind's slow-path calls)
//         sits in its body.
//         Pass 1 accumulates t_i = K_i u in registers over every tile and
//         reduces it once per row block (shuffles, then the two warps of a
//         row range in a fixed order), adds v_i and zeroes padded and
//         row_mask == 0 rows: masked rows contribute exactly 0. Pass 2
//         evaluates K_ij again; each thread sums its 8 rows x t into column
//         partials in registers, then shuffles and the four warps of a
//         column range reduce them in a fixed order into the block's w
//         partial (shared memory when M*P floats fit, else the block's
//         slice of a global scratch).
//     reduce_partials then sums the G partials in block order: the result is
//     deterministic, with no float atomics. The one atomic is the integer
//     tile-evaluation counter, which reports 2 * nbi * nbj in 128 x 128
//     tiles. The tile code (TileWalk: the staging, the ring, the evaluation
//     and pass 1) is B1's, B2's and B3's, in sweep.cuh; the kernel map is
//     tile.cuh's.
//
// B2  kernel_matmul_kernel  out = K(A,B) V + add
//     Replaces repro/kernels/kernel_matvec.py::kernel_matmul_pallas /
//     _kernel_matmul_kernel. Bound: fp32 FMA issue, m*n*(2d + 12) flops at
//     p = 1 against 67 TFLOP/s; its bytes (A, B, V, out) are negligible.
//     Design: B1's pass 1 alone, on B1's tile code. pack_centers packs B
//     (in C's place, V in u's) once per call; block (i, s) stages A's row
//     block i once and streams slice s of B's packed tiles through the
//     ring, accumulates t in registers and reduces it once, in B1's order.
//     One kernel per kernel kind. When A has too few row blocks to fill the
//     card (B4's transposed pass: 135 row blocks on 264 resident blocks),
//     matmul_slices splits B's tiles into S contiguous slices; each block
//     writes its (128, p) slice partial and reduce_partials sums them in
//     slice order, then adds `add`: deterministic, with no float atomics.
//     With S = 1 the block adds `add` and stores out itself.
//
// B1, B2 (and B4, which is B2's launches) are built four times: fp32
// (here), fp32 compensated (kernel_matvec_f32c.cu), bf16 compensated
// (kernel_matvec_bf16c.cu) and float16 compensated (kernel_matvec_f16c.cu),
// the reference's compensated=True paths with fp32, bf16 or float16 inputs
// and outputs (sweep.cuh says how). The bound is the same FMA issue: a
// 16-bit type halves X's bytes, which were negligible, and the Kahan
// carries add a few flops a tile, not an entry.
//
// B3  pairwise_kernel       K(A,B) materialized
//     Replaces repro/kernels/kernel_matvec.py::pairwise_kernel_pallas /
//     _pairwise_kernel. Bound on an H100: the larger of the m*n*4-byte store
//     against 3.35 TB/s and the m*n*(2d + 10) flops of the entries it
//     evaluates against 67 TFLOP/s: the store at d = 18 (SUSY's K_MM),
//     the flops at d = 90 (MillionSongs') unless each entry pair of a
//     symmetric K is evaluated once.
//     Design: B2's evaluation alone, on the same tile code. pack_centers
//     packs B k-major with ||b||^2 (at P = 1, u = 0) once per call; a
//     persistent grid of G blocks (occupancy x 132 SMs) splits the tiles, in
//     row-major order, into G contiguous ranges that differ by at most one
//     tile (pairwise_range). A block stages A's row block when its range
//     enters a row and streams B's packed tiles through the ring. Each
//     thread stores its 8 x 8 micro-tile straight from registers with
//     streaming float4 stores (a row's 8 lanes cover 128 contiguous bytes;
//     a scalar instantiation takes n % 4 != 0). K(C, C), A and B the same
//     storage, takes the symmetric route: only the tiles bj >= bi are
//     evaluated, and an off-diagonal tile is stored at (bi, bj) and,
//     transposed from the same registers, at (bj, bi) (4 lanes cover 64
//     contiguous bytes of an output row). That is exact: fmaf(a, b, acc) ==
//     fmaf(b, a, acc), both norms are the same k-ordered fmaf sums, and
//     sqdist adds them with a commutative __fadd_rn, so the full route's
//     K(C, C) is symmetric bit for bit. Every entry has one writer: no
//     atomics.
//
// Plain C interface, loaded with ctypes by repro_torch/kernels/build.py:
// every entry returns cudaGetLastError() after its launches.
#include <cuda_runtime.h>

#include "sweep.cuh"

namespace rt {

// B1 and B2 in IEEE fp32, uncompensated (the fp32 policy).
RT_SWEEP_VARIANT(f32, float, false)

// ---------------------------------------------------------------------------
// B3: B2's evaluation alone, stored
// ---------------------------------------------------------------------------
// Shared-memory floats of one pairwise block, in carve order: the ring, the
// extras ring (||b||^2 and the zero row of u: B is packed at P = 1), the A
// block and its row norms. Mirrored by
// repro_torch.kernels.kernel_matvec.pairwise_smem_bytes.
__host__ __device__ constexpr size_t pairwise_smem_floats(int d) {
  return 2 * (size_t)(d < SW_KC ? d : SW_KC) * SW_BN + 2 * 2 * (size_t)SW_BN +
         (size_t)(d < SW_XK ? d : SW_XK) * SW_LDX + SW_BM;
}

// Output tiles [t0, t1) of block b in row-major order over all nbi x nbj
// tiles (sym = 0) or over the upper triangle bj >= bi (sym = 1); (bi, bj)
// is tile t0. The G ranges are contiguous and differ by at most one tile.
// Mirrored by repro_torch.kernels.kernel_matvec.pairwise_range.
struct TileRange {
  long t0, t1;
  int bi, bj;
};

__host__ __device__ inline long pairwise_tiles(int nbi, int nbj, int sym) {
  return sym ? (long)nbi * (nbi + 1) / 2 : (long)nbi * nbj;
}

__host__ __device__ inline TileRange pairwise_range(int nbi, int nbj, int sym, int G, int b) {
  const long T = pairwise_tiles(nbi, nbj, sym);
  TileRange r;
  r.t0 = (long)b * T / G;
  r.t1 = (long)(b + 1) * T / G;
  if (sym) {   // row bi holds tiles bi..nbi-1
    long start = 0;
    r.bi = 0;
    while (r.bi < nbi && start + (nbi - r.bi) <= r.t0) start += nbi - r.bi++;
    r.bj = r.bi + (int)(r.t0 - start);
  } else {
    r.bi = (int)(r.t0 / nbj);
    r.bj = (int)(r.t0 % nbj);
  }
  return r;
}

// Four consecutive entries of an output row at p, `room` of them inside the
// row, with streaming stores (a K of gigabytes never stays in L2): one
// float4 (VEC: p is 16-byte aligned and room is 0 or >= 4), else one float
// at a time.
template <bool VEC>
__device__ __forceinline__ void put4(float* p, int room, float a, float b, float c, float d) {
  if (VEC) {
    if (room > 0) __stcs(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));
  } else {
    if (room > 0) __stcs(p, a);
    if (room > 1) __stcs(p + 1, b);
    if (room > 2) __stcs(p + 2, c);
    if (room > 3) __stcs(p + 3, d);
  }
}

// This thread's micro-tile of the tile at rows r0.., columns c0.. of the
// (rows, cols) output: entry (i, j) at row r0 + (i/4)*64 + ty*4 + i%4,
// column c0 + (j/4)*64 + tx*4 + j%4 (TileWalk's layout). Transposed: entry
// (i, j) at row c0 + (j/4)*64 + tx*4 + j%4, column r0 + (i/4)*64 + ty*4 +
// i%4. Entries past rows or cols are not stored.
template <bool VEC>
__device__ __forceinline__ void store_tile(float* __restrict__ out, int rows, int cols, int r0,
                                           int c0, int ty, int tx, const float (&k)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + (i / 4) * SW_HALF + ty * 4 + i % 4;
    if (row >= rows) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = c0 + h * SW_HALF + tx * 4;
      put4<VEC>(out + (size_t)row * cols + col, cols - col, k[i][4 * h], k[i][4 * h + 1],
                k[i][4 * h + 2], k[i][4 * h + 3]);
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void store_tile_t(float* __restrict__ out, int rows, int cols, int r0,
                                             int c0, int ty, int tx, const float (&k)[8][8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int row = c0 + (j / 4) * SW_HALF + tx * 4 + j % 4;
    if (row >= rows) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = r0 + h * SW_HALF + ty * 4;
      put4<VEC>(out + (size_t)row * cols + col, cols - col, k[4 * h][j], k[4 * h + 1][j],
                k[4 * h + 2][j], k[4 * h + 3][j]);
    }
  }
}

// Block b evaluates its range of output tiles with TileWalk, staging A's
// row block as its range enters each row, and stores each tile from
// registers; sym: the upper triangle of K(A, A), each off-diagonal tile
// stored twice.
template <int KIND, bool VEC>
__global__ void __launch_bounds__(SW_NT, 2)
    pairwise_kernel(const float* __restrict__ A, const float* __restrict__ packed, int m, int n,
                    int d, KParams kp, int sym, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int cr = min(d, SW_KC);
  const int xr = min(d, SW_XK);
  float* cs = reinterpret_cast<float*>(smem4);   // [2][cr][128]
  float* ex = cs + 2 * cr * SW_BN;               // [2][2][128]
  float* xs = ex + 2 * 2 * SW_BN;                // [xr][SW_LDX]
  float* a2s = xs + xr * SW_LDX;                 // [128]

  const int nbi = (m + SW_BM - 1) / SW_BM;
  const int nbj = (n + SW_BN - 1) / SW_BN;
  const int nkc = (d + SW_KC - 1) / SW_KC;
  const TileRange r = pairwise_range(nbi, nbj, sym, gridDim.x, blockIdx.x);
  if (r.t0 == r.t1) return;
  TileWalk<1, KIND, float, false> walk(A, packed, m, d, 0, nbj, (r.t1 - r.t0) * nkc, kp, cs, ex,
                                       xs, a2s, r.bj, sym ? r.bi : 0, sym);
  int bi = r.bi, bj = r.bj, staged = -1;
  for (long t = r.t0; t < r.t1; ++t) {
    if (bi != staged) {
      __syncthreads();   // the last row block's xs and a2s are no longer read
      walk.stage_rows(bi * SW_BM);
      __syncthreads();
      staged = bi;
    }
    float k[8][8];
    walk.eval_tile(k);
    store_tile<VEC>(out, m, n, bi * SW_BM, bj * SW_BN, walk.ty, walk.tx, k);
    if (sym && bj != bi) store_tile_t<VEC>(out, n, m, bi * SW_BM, bj * SW_BN, walk.ty, walk.tx, k);
    if (++bj == nbj) {
      ++bi;
      bj = sym ? bi : 0;
    }
  }
}

using PairwiseKernel = void (*)(const float*, const float*, int, int, int, KParams, int, float*);

// B3's instantiation for a kernel kind, with its dynamic shared memory set.
template <bool VEC>
static cudaError_t pairwise_kernel_vec(int kind, int smem_bytes, PairwiseKernel* k) {
  switch (kind) {
    case GAUSSIAN: *k = pairwise_kernel<GAUSSIAN, VEC>; break;
    case LAPLACIAN: *k = pairwise_kernel<LAPLACIAN, VEC>; break;
    case MATERN32: *k = pairwise_kernel<MATERN32, VEC>; break;
    case LINEAR: *k = pairwise_kernel<LINEAR, VEC>; break;
    case POLYNOMIAL: *k = pairwise_kernel<POLYNOMIAL, VEC>; break;
    default: return cudaErrorInvalidValue;
  }
  return cudaFuncSetAttribute(*k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

static cudaError_t pairwise_kernel_of(int kind, int vec, int smem_bytes, PairwiseKernel* k) {
  return vec ? pairwise_kernel_vec<true>(kind, smem_bytes, k)
             : pairwise_kernel_vec<false>(kind, smem_bytes, k);
}

// B3's shared memory and resident blocks on the card for (kind, d, VEC).
static cudaError_t pairwise_slots_t(int kind, int d, int vec, int* smem_bytes, int* slots) {
  *smem_bytes = (int)(sizeof(float) * pairwise_smem_floats(d));
  PairwiseKernel k = nullptr;
  cudaError_t err = pairwise_kernel_of(kind, vec, *smem_bytes, &k);
  if (err != cudaSuccess) return err;
  return card_slots(k, *smem_bytes, slots);
}

// B3's launches: pack_centers (B k-major with ||b||^2, u = 0), then the
// kernel on min(slots, tiles) blocks. VEC when every output row starts
// 16-byte aligned (n % 4 == 0). sym needs A and B the same (m, d) matrix.
static cudaError_t pairwise_t(const float* A, const float* B, int m, int n, int d, KParams kp,
                              int sym, int slots, float* packed, float* out, cudaStream_t stream) {
  if (sym && (A != B || m != n)) return cudaErrorInvalidValue;
  const int vec = n % 4 == 0 && reinterpret_cast<size_t>(out) % 16 == 0;
  const int smem = (int)(sizeof(float) * pairwise_smem_floats(d));
  PairwiseKernel k = nullptr;
  cudaError_t err = pairwise_kernel_of(kp.kind, vec, smem, &k);
  if (err != cudaSuccess) return err;
  const int nbi = (m + SW_BM - 1) / SW_BM;
  const int nbj = (n + SW_BN - 1) / SW_BN;
  const long tiles = pairwise_tiles(nbi, nbj, sym);
  const int grid = (int)(tiles < slots ? tiles : slots);
  pack_centers<1, float, float><<<nbj, SW_BN, 0, stream>>>(B, nullptr, n, d, 0, packed);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k<<<grid, SW_NT, smem, stream>>>(A, packed, m, n, d, kp, sym, out);
  return cudaGetLastError();
}

static KParams kparams(int kind, float sigma, float coef, float ss, float c, int degree) {
  KParams kp;
  kp.kind = kind;
  kp.sigma = sigma;
  kp.coef = coef;
  kp.ss = ss;
  kp.c = c;
  kp.degree = degree;
  return kp;
}

}  // namespace rt

using rt::KParams;

extern "C" {

const char* rt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// variant: 0 fp32, 1 fp32 compensated, 2 bf16 compensated, 3 float16 compensated
// (repro_torch.kernels.kernel_matvec.VARIANTS). Type codes: rt::DType.
int rt_sweep_grid(int P, int kind, int smem_bytes, int variant, int* grid) {
  switch (variant) {
    case 0: return (int)rt::sweep_grid_f32(P, kind, smem_bytes, grid);
    case 1: return (int)rt::sweep_grid_f32c(P, kind, smem_bytes, grid);
    case 2: return (int)rt::sweep_grid_bf16c(P, kind, smem_bytes, grid);
    case 3: return (int)rt::sweep_grid_f16c(P, kind, smem_bytes, grid);
    default: return (int)cudaErrorInvalidValue;
  }
}

int rt_fused_sweep(int variant, const void* X, const void* C, int ct, const void* u, int ut,
                   const void* v, int vt, const void* mask, int n, int M, int d, int p, int kind,
                   float sigma, float coef, float ss, float c, int degree, int P, int w_in_smem,
                   int smem_bytes, int grid, void* packed, void* partial, void* w, int wt,
                   void* counter, void* stream) {
  rt::SweepArgs a;
  a.X = X; a.C = C; a.u = u; a.v = v;
  a.ct = ct; a.ut = ut; a.vt = vt;
  a.mask = static_cast<const float*>(mask);
  a.n = n; a.M = M; a.d = d; a.p = p;
  a.kp = rt::kparams(kind, sigma, coef, ss, c, degree);
  a.w_in_smem = w_in_smem; a.smem_bytes = smem_bytes; a.grid = grid;
  a.packed = static_cast<float*>(packed);
  a.partial = static_cast<float*>(partial);
  a.w = w; a.wt = wt;
  a.counter = static_cast<int*>(counter);
  a.stream = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return (int)rt::fused_sweep_f32(P, a);
    case 1: return (int)rt::fused_sweep_f32c(P, a);
    case 2: return (int)rt::fused_sweep_bf16c(P, a);
    case 3: return (int)rt::fused_sweep_f16c(P, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

int rt_matmul_slots(int P, int kind, int d, int variant, int* smem_bytes, int* slots) {
  switch (variant) {
    case 0: return (int)rt::matmul_slots_f32(P, kind, d, smem_bytes, slots);
    case 1: return (int)rt::matmul_slots_f32c(P, kind, d, smem_bytes, slots);
    case 2: return (int)rt::matmul_slots_bf16c(P, kind, d, smem_bytes, slots);
    case 3: return (int)rt::matmul_slots_f16c(P, kind, d, smem_bytes, slots);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The slices B2 splits B's tiles into (a count, not an error code).
int rt_matmul_slices(int m, int n, int slots) {
  return rt::matmul_slices((m + rt::SW_BM - 1) / rt::SW_BM, (n + rt::SW_BN - 1) / rt::SW_BN, slots);
}

int rt_kernel_matmul(int variant, const void* A, const void* B, int bt, const void* V, int vt,
                     const void* add, int addt, int m, int n, int d, int p, int kind, float sigma,
                     float coef, float ss, float c, int degree, int P, int slots, void* packed,
                     void* partial, void* out, int ot, void* stream) {
  rt::MatmulArgs a;
  a.A = A; a.B = B; a.V = V; a.add = add;
  a.bt = bt; a.vt = vt; a.addt = addt;
  a.m = m; a.n = n; a.d = d; a.p = p;
  a.kp = rt::kparams(kind, sigma, coef, ss, c, degree);
  a.slots = slots;
  a.packed = static_cast<float*>(packed);
  a.partial = static_cast<float*>(partial);
  a.out = out; a.ot = ot;
  a.stream = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return (int)rt::kernel_matmul_f32(P, a);
    case 1: return (int)rt::kernel_matmul_f32c(P, a);
    case 2: return (int)rt::kernel_matmul_bf16c(P, a);
    case 3: return (int)rt::kernel_matmul_f16c(P, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

int rt_pairwise_slots(int kind, int d, int vec, int* smem_bytes, int* slots) {
  return (int)rt::pairwise_slots_t(kind, d, vec, smem_bytes, slots);
}

// Block b's range of B3's tiles: out = {t0, t1, bi, bj} (rt::pairwise_range).
int rt_pairwise_range(int m, int n, int sym, int G, int b, long long* out) {
  const rt::TileRange r = rt::pairwise_range((m + rt::SW_BM - 1) / rt::SW_BM,
                                             (n + rt::SW_BN - 1) / rt::SW_BN, sym, G, b);
  out[0] = r.t0;
  out[1] = r.t1;
  out[2] = r.bi;
  out[3] = r.bj;
  return 0;
}

int rt_pairwise(const void* A, const void* B, int m, int n, int d, int kind, float sigma,
                float coef, float ss, float c, int degree, int sym, int slots, void* packed,
                void* out, void* stream) {
  const KParams kp = rt::kparams(kind, sigma, coef, ss, c, degree);
  return (int)rt::pairwise_t(static_cast<const float*>(A), static_cast<const float*>(B), m, n, d,
                             kp, sym, slots, static_cast<float*>(packed),
                             static_cast<float*>(out), static_cast<cudaStream_t>(stream));
}

}  // extern "C"
