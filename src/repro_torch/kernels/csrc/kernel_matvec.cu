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
//     and pass 1) is B1's, B2's and B3's; the kernel map is tile.cuh's.
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

#include "tile.cuh"

namespace rt {

// ---------------------------------------------------------------------------
// B1: the sweep's own tile
// ---------------------------------------------------------------------------
constexpr int SW_BM = 128;             // X rows of a row block
constexpr int SW_BN = 128;             // centers of a center tile
constexpr int SW_HALF = 64;            // offset of a thread's second 4 x 4 block
constexpr int SW_KC = 32;              // k depth of a ring chunk
constexpr int SW_XK = 128;             // k depth of X kept resident per row block
constexpr int SW_LDX = SW_BM + 4;      // padded k-major row of the X block
constexpr int SW_NT = 256;
static_assert(SW_XK % SW_KC == 0, "an X chunk holds whole ring chunks");

// Shared-memory floats of one sweep block, in carve order: the center ring
// (2 chunks), the tile extras ring (||c||^2 and u, 2 tiles), the X block,
// t of the row block, the cross-warp reduction buffer, the row norms and
// (optionally) the w partial. Mirrored by
// repro_torch.kernels.kernel_matvec.sweep_smem_bytes.
template <int P>
__host__ __device__ constexpr size_t sweep_smem_floats(int d, int w_rows) {
  return 2 * (size_t)(d < SW_KC ? d : SW_KC) * SW_BN + 2 * (size_t)(1 + P) * SW_BN +
         (size_t)(d < SW_XK ? d : SW_XK) * SW_LDX + (size_t)P * SW_BM +
         4 * (size_t)P * SW_BN + SW_BM + (size_t)w_rows * P;
}

// Floats of one packed center tile: d k-rows, ||c||^2, then P rows of u.
template <int P>
__host__ __device__ constexpr size_t packed_tile_floats(int d) {
  return (size_t)(d + 1 + P) * SW_BN;
}

// The prologue: one thread per center. Column m % 128 of tile m / 128 gets
// C[m] k-major, its squared norm (fmaf in k order, as TileWalk::stage_rows
// sums a row's) and u[m], all zero past M and p.
template <int P>
__global__ void __launch_bounds__(SW_BN)
    pack_centers(const float* __restrict__ C, const float* __restrict__ u, int M, int d, int p,
                 float* __restrict__ packed) {
  const int m = blockIdx.x * SW_BN + threadIdx.x;
  float* dst = packed + blockIdx.x * packed_tile_floats<P>(d) + threadIdx.x;
  float nrm = 0.0f;
  for (int k = 0; k < d; ++k) {
    const float x = m < M ? C[(size_t)m * d + k] : 0.0f;
    nrm = fmaf(x, x, nrm);
    dst[(size_t)k * SW_BN] = x;
  }
  dst[(size_t)d * SW_BN] = nrm;
#pragma unroll
  for (int c = 0; c < P; ++c)
    dst[(size_t)(d + 1 + c) * SW_BN] = (m < M && c < p) ? u[(size_t)m * p + c] : 0.0f;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The kernel map of a whole micro-tile, in registers: tile.cuh's kmap per
// entry, its kind fixed at compile time. A
// switch on the kind inside the kernel costs spills: the other kinds'
// division and sqrt slow paths are calls that save the live tile.
template <int KIND>
__device__ __forceinline__ void map_tile(float (&acc)[8][8], const float (&a2)[8],
                                         const float (&b2)[8], KParams kp) {
  kp.kind = KIND;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = kmap(acc[i][j], a2[i], b2[j], kp);
}

// 8 values at offsets h*64 + base + 0..3 (h = 0, 1) of a shared row, as two
// float4 loads: a thread's rows (base = ty*4) or columns (base = tx*4).
__device__ __forceinline__ void load8(const float* row, int base, float (&out)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(row + base);
  const float4 hi = *reinterpret_cast<const float4*>(row + SW_HALF + base);
  out[0] = lo.x; out[1] = lo.y; out[2] = lo.z; out[3] = lo.w;
  out[4] = hi.x; out[5] = hi.y; out[6] = hi.z; out[7] = hi.w;
}

// X[r0 : r0 + 128, k0 : k0 + kr] into xs k-major, zero past n.
__device__ __forceinline__ void stage_x(const float* __restrict__ X, int n, int d, int r0, int k0,
                                        int kr, float* xs) {
  for (int e = threadIdx.x; e < SW_BM * kr; e += SW_NT) {
    const int r = e / kr;
    const int k = e - r * kr;
    xs[k * SW_LDX + r] = r0 + r < n ? X[(size_t)(r0 + r) * d + k0 + k] : 0.0f;
  }
}

// A block's stream of packed tiles, a tile's k-chunks consecutive: each row
// of the stream walks tiles first..j1-1, then the next row begins at
// first + step (B1, B2: step 0, every row walks j0..j1-1; B3's upper
// triangle: step 1, row i walks i..nbj-1). The n-th chunk fetched lands in
// ring slot n & 1; a tile's first chunk also brings its extras into extras
// slot (tile sequence) & 1.
struct ChunkCursor {
  int chunk;   // k-chunk of the next chunk to fetch
  int tile;    // its packed tile
  int tseq;    // tiles begun before it, over the whole stream
  int slot;    // its ring slot
  int first;   // the tile this row of the stream wrapped to
  int step;    // how far `first` moves at each wrap
};

template <int P>
__device__ __forceinline__ void fetch_chunk(const float* __restrict__ packed, int d, int nkc,
                                            int j1, ChunkCursor& cur, float* cs, float* ex) {
  const int k0 = cur.chunk * SW_KC;
  const int rows = min(SW_KC, d - k0);
  const int cr = min(d, SW_KC);
  const float* tile = packed + cur.tile * packed_tile_floats<P>(d);
  const float* src = tile + (size_t)k0 * SW_BN;
  float* dst = cs + cur.slot * cr * SW_BN;
  for (int e = threadIdx.x; e < rows * SW_BN / 4; e += SW_NT) cp_async16(dst + 4 * e, src + 4 * e);
  if (cur.chunk == 0) {
    const float* xsrc = tile + (size_t)d * SW_BN;
    float* xdst = ex + (cur.tseq & 1) * (1 + P) * SW_BN;
    for (int e = threadIdx.x; e < (1 + P) * SW_BN / 4; e += SW_NT)
      cp_async16(xdst + 4 * e, xsrc + 4 * e);
  }
  cp_async_commit();
  cur.slot ^= 1;
  if (++cur.chunk == nkc) {
    cur.chunk = 0;
    ++cur.tseq;
    if (++cur.tile == j1) {
      cur.first += cur.step;
      cur.tile = cur.first;
    }
  }
}

// The tile code B1, B2 and B3 share: one block's 128-row blocks of X (B2,
// B3: A) against its stream of packed tiles j0..j1-1 (B1: every center
// tile, twice per row block; B2: one slice of B's tiles, once; B3: its
// range of output tiles, the stream beginning at tile `start` and wrapping
// as ChunkCursor says). The shared-memory regions are the caller's: cs
// [2][min(d, 32)][128] (the ring), ex [2][1 + P][128] (the extras ring), xs
// [min(d, 128)][SW_LDX] (the X block, k-major) and a2s [128] (its row
// norms).
template <int P, int KIND>
struct TileWalk {
  const float* __restrict__ X;
  const float* __restrict__ packed;
  int n, d, nkc, j0, j1;
  KParams kp;
  float *cs, *ex, *xs, *a2s;
  int ty, tx;        // B7's map: a warp covers 4 x 8 threads, 32 rows and 64 columns
  long total;        // chunks this block computes
  long s = 0;        // the next chunk to compute
  int tseq = 0;      // tiles begun
  int r0 = 0;        // first row of the staged X block
  int evals = 0;     // tiles evaluated
  ChunkCursor cur;   // the next chunk to fetch

  __device__ __forceinline__ TileWalk(const float* X_, const float* packed_, int n_, int d_,
                                      int j0_, int j1_, long total_, KParams kp_, float* cs_,
                                      float* ex_, float* xs_, float* a2s_, int start, int first,
                                      int step)
      : X(X_), packed(packed_), n(n_), d(d_), nkc((d_ + SW_KC - 1) / SW_KC), j0(j0_), j1(j1_),
        kp(kp_), cs(cs_), ex(ex_), xs(xs_), a2s(a2s_), total(total_),
        cur{0, start, 0, 0, first, step} {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    ty = (warp / 2) * 4 + lane / 8;
    tx = (warp % 2) * 8 + lane % 8;
    fetch_chunk<P>(packed, d, nkc, j1, cur, cs, ex);   // the stream's first chunk
  }

  // X[row0 : row0 + 128] into xs (when it stays resident, d <= 128) and its
  // row norms into a2s. Between two barriers of the caller.
  __device__ __forceinline__ void stage_rows(int row0) {
    r0 = row0;
    if (d <= SW_XK) stage_x(X, n, d, r0, 0, d, xs);
    const int tid = threadIdx.x;
    if (tid < SW_BM) {
      float nrm = 0.0f;   // fmaf in k order, as pack_centers sums
      if (r0 + tid < n)
        for (int k = 0; k < d; ++k) {
          const float x = X[(size_t)(r0 + tid) * d + k];
          nrm = fmaf(x, x, nrm);
        }
      a2s[tid] = nrm;
    }
  }

  // K(X_i, C_j) of the stream's next tile into acc, mapped; returns the
  // tile's extras (||c||^2, u). The norms (and B1's pass-2 t) are read from
  // shared memory after the k loop, so that only acc and the k step's
  // operands are live through it.
  __device__ __forceinline__ const float* eval_tile(float (&acc)[8][8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    const int tile_seq = tseq++;
    const int cr = min(d, SW_KC);
    for (int kc = 0; kc < nkc; ++kc, ++s) {
      cp_async_wait_all();
      __syncthreads();   // chunk s is visible; slot (s + 1) & 1 is no longer read
      if (s + 1 < total) fetch_chunk<P>(packed, d, nkc, j1, cur, cs, ex);
      const int k0 = kc * SW_KC;
      const int kr = min(SW_KC, d - k0);
      const float* xb = xs + k0 * SW_LDX;
      if (d > SW_XK) {
        const int xk0 = (k0 / SW_XK) * SW_XK;
        if (k0 == xk0) {   // a new 128-deep chunk of X; every thread is past the last
          stage_x(X, n, d, r0, xk0, min(SW_XK, d - xk0), xs);
          __syncthreads();
        }
        xb = xs + (k0 - xk0) * SW_LDX;
      }
      const float* cb = cs + (s & 1) * cr * SW_BN;
#pragma unroll 2
      for (int kk = 0; kk < kr; ++kk) {
        float a[8], b[8];
        load8(xb + kk * SW_LDX, ty * 4, a);
        load8(cb + kk * SW_BN, tx * 4, b);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    const float* e = ex + (tile_seq & 1) * (1 + P) * SW_BN;
    float a2[8], b2[8];
    load8(a2s, ty * 4, a2);
    load8(e, tx * 4, b2);
    map_tile<KIND>(acc, a2, b2, kp);
    ++evals;
    return e;
  }

  // Pass 1: t = K(X_i, C_j0..j1-1) u for this thread's 8 rows over its 8
  // columns of every tile, in tile order, then over the 8 threads of a row
  // in the warp. The row range's two warps are combined by combine_rows.
  __device__ __forceinline__ void pass1(float (&t)[8][P]) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < P; ++c) t[i][c] = 0.0f;
    for (int bj = j0; bj < j1; ++bj) {
      float acc[8][8];
      const float* e = eval_tile(acc);
#pragma unroll
      for (int c = 0; c < P; ++c) {
        float uj[8];   // u is zero past the packed rows
        load8(e + (1 + c) * SW_BN, tx * 4, uj);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) t[i][c] = fmaf(acc[i][j], uj[j], t[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < P; ++c) {
        t[i][c] += __shfl_xor_sync(0xffffffffu, t[i][c], 1);
        t[i][c] += __shfl_xor_sync(0xffffffffu, t[i][c], 2);
        t[i][c] += __shfl_xor_sync(0xffffffffu, t[i][c], 4);
      }
  }
};

// The end of pass 1: t over the row range's two warps (warp % 2 = 0 first;
// warp 1's sums go through red, [P][128]), then epi(r, c, t) once for each
// row r of the block and column c < P, on a lane of warp 0. Synchronises the
// block before epi.
template <int P, class Epi>
__device__ __forceinline__ void combine_rows(const float (&t)[8][P], float* red, int ty, Epi epi) {
  const int warp = threadIdx.x / 32;
  const int mine = threadIdx.x % 8;   // the row slot this lane reports
  if (warp % 2 == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i == mine)
#pragma unroll
        for (int c = 0; c < P; ++c) red[c * SW_BM + (i / 4) * SW_HALF + ty * 4 + i % 4] = t[i][c];
  }
  __syncthreads();
  if (warp % 2 == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i == mine) {
        const int r = (i / 4) * SW_HALF + ty * 4 + i % 4;
#pragma unroll
        for (int c = 0; c < P; ++c) epi(r, c, t[i][c] + red[c * SW_BM + r]);
      }
  }
}

template <int P, int KIND>
__global__ void __launch_bounds__(SW_NT, P == 1 ? 2 : 1)
    fused_sweep_kernel(const float* __restrict__ X, const float* __restrict__ packed,
                       const float* __restrict__ v, const float* __restrict__ mask, int n, int M,
                       int d, int p, KParams kp, int w_in_smem, float* __restrict__ partial,
                       int* __restrict__ counter) {
  extern __shared__ float4 smem4[];
  const int cr = min(d, SW_KC);
  const int xr = min(d, SW_XK);
  float* cs = reinterpret_cast<float*>(smem4);   // [2][cr][128]
  float* ex = cs + 2 * cr * SW_BN;               // [2][1 + P][128]
  float* xs = ex + 2 * (1 + P) * SW_BN;          // [xr][SW_LDX]
  float* ts = xs + xr * SW_LDX;                  // [P][128]
  float* red = ts + P * SW_BM;                   // [4][P][128]
  float* a2s = red + 4 * P * SW_BN;              // [128]
  float* wsm = a2s + SW_BM;                      // [M][P] when w_in_smem
  float* gpart = partial + (size_t)blockIdx.x * M * P;
  float* wpart = w_in_smem ? wsm : gpart;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int nbi = (n + SW_BM - 1) / SW_BM;
  const int nbj = (M + SW_BN - 1) / SW_BN;
  const int nkc = (d + SW_KC - 1) / SW_KC;
  const int my_blocks = (nbi - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  // every center tile twice per row block, each in nkc chunks
  TileWalk<P, KIND> walk(X, packed, n, d, 0, nbj, (long)my_blocks * 2 * nbj * nkc, kp, cs, ex,
                         xs, a2s, 0, 0, 0);
  const int ty = walk.ty;
  const int tx = walk.tx;
  for (int e = tid; e < M * P; e += SW_NT) wpart[e] = 0.0f;   // read after a barrier

  for (int bi = blockIdx.x; bi < nbi; bi += gridDim.x) {
    const int r0 = bi * SW_BM;
    __syncthreads();   // the last row block no longer reads xs, ts, red or a2s
    walk.stage_rows(r0);
    __syncthreads();

    // pass 1: t_i = K_i u, then v and the mask; padded rows give 0
    float t[8][P];
    walk.pass1(t);
    combine_rows<P>(t, red, ty, [&](int r, int c, float tv) {
      const int row = r0 + r;
      if (row < n && c < p) {
        if (v != nullptr) tv += v[(size_t)row * p + c];
        if (mask != nullptr) tv *= mask[row];
      } else {
        tv = 0.0f;
      }
      ts[c * SW_BM + r] = tv;
    });
    __syncthreads();

    // pass 2: w_j += K_ij^T t_i. This thread's 8 rows, then the 4 threads of
    // its warp on the same columns, then the 4 warps, in a fixed order
    for (int bj = 0; bj < nbj; ++bj) {
      float acc[8][8];
      walk.eval_tile(acc);
      float wc[8][P];
#pragma unroll
      for (int c = 0; c < P; ++c) {
        float tt[8];   // t_i of this thread's rows
        load8(ts + c * SW_BM, ty * 4, tt);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float sum = 0.0f;
#pragma unroll
          for (int i = 0; i < 8; ++i) sum = fmaf(acc[i][j], tt[i], sum);
          wc[j][c] = sum;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < P; ++c) {
          wc[j][c] += __shfl_xor_sync(0xffffffffu, wc[j][c], 8);
          wc[j][c] += __shfl_xor_sync(0xffffffffu, wc[j][c], 16);
        }
#pragma unroll
      for (int c = 0; c < P; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float4*>(red + ((warp / 2) * P + c) * SW_BN + h * SW_HALF + tx * 4) =
              make_float4(wc[4 * h][c], wc[4 * h + 1][c], wc[4 * h + 2][c], wc[4 * h + 3][c]);
      __syncthreads();
      const int c0 = bj * SW_BN;
      for (int o = tid; o < P * SW_BN; o += SW_NT) {
        const int c = o / SW_BN;
        const int col = o - c * SW_BN;
        if (c0 + col < M) {
          const float sum = ((red[c * SW_BN + col] + red[(P + c) * SW_BN + col]) +
                             red[(2 * P + c) * SW_BN + col]) +
                            red[(3 * P + c) * SW_BN + col];
          wpart[(size_t)(c0 + col) * P + c] += sum;
        }
      }
      // red is written again only after the next chunk's barrier
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (w_in_smem) {
    for (int e = tid; e < M * P; e += SW_NT) gpart[e] = wsm[e];
  }
  if (tid == 0) atomicAdd(counter, walk.evals);
}

// w[m][c] = sum over the G partials in order (+ add[m][c]): B1's block
// partials, B2's slice partials.
__global__ void reduce_partials(const float* __restrict__ partial, int G, int M, int P, int p,
                                const float* __restrict__ add, float* __restrict__ w) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= M * p) return;
  const int m = e / p;
  const int c = e - m * p;
  float s = 0.0f;
  for (int g = 0; g < G; ++g) s += partial[((size_t)g * M + m) * P + c];
  w[e] = add != nullptr ? s + add[e] : s;
}

// ---------------------------------------------------------------------------
// B2: B1's pass 1 alone
// ---------------------------------------------------------------------------
// Shared-memory floats of one kernel-matmul block, in carve order: the ring,
// the extras ring, the A block, the cross-warp buffer of t and the row
// norms. Mirrored by repro_torch.kernels.kernel_matvec.matmul_smem_bytes.
template <int P>
__host__ __device__ constexpr size_t matmul_smem_floats(int d) {
  return 2 * (size_t)(d < SW_KC ? d : SW_KC) * SW_BN + 2 * (size_t)(1 + P) * SW_BN +
         (size_t)(d < SW_XK ? d : SW_XK) * SW_LDX + (size_t)P * SW_BM + SW_BM;
}

// Most slices of B's tiles one launch splits into.
constexpr int MM_MAX_SLICES = 16;

// The slices S of B's nbj tiles for nbi row blocks of A on `slots` resident
// blocks: the S <= min(nbj, 16) with the fewest waves x (tiles a slice + 1),
// the 1 standing for a block's own staging and epilogue; ties go to the
// smaller S. A short grid (B4's transposed pass: 135 row blocks on 264
// slots) splits; a long one (SUSY's predict, 3907 row blocks) does not.
// Mirrored by repro_torch.kernels.kernel_matvec.matmul_slices.
static int matmul_slices(int nbi, int nbj, int slots) {
  int best = 1;
  long best_cost = -1;
  const int top = nbj < MM_MAX_SLICES ? nbj : MM_MAX_SLICES;
  for (int S = 1; S <= top; ++S) {
    const long waves = ((long)nbi * S + slots - 1) / slots;
    const long cost = waves * ((nbj + S - 1) / S + 1);
    if (best_cost < 0 || cost < best_cost) {
      best = S;
      best_cost = cost;
    }
  }
  return best;
}

// Block (i, s) evaluates A's row block i against slice s of B's packed tiles
// (tiles s*nbj/S .. (s+1)*nbj/S - 1) with B1's pass 1, then writes
// out = t + add (S = 1) or its (128, p) slice partial (S > 1), which
// reduce_partials sums in slice order before adding `add`.
template <int P, int KIND>
__global__ void __launch_bounds__(SW_NT, P == 1 ? 2 : 1)
    kernel_matmul_kernel(const float* __restrict__ A, const float* __restrict__ packed,
                         const float* __restrict__ add, int m, int n, int d, int p, KParams kp,
                         float* __restrict__ partial, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int cr = min(d, SW_KC);
  const int xr = min(d, SW_XK);
  float* cs = reinterpret_cast<float*>(smem4);   // [2][cr][128]
  float* ex = cs + 2 * cr * SW_BN;               // [2][1 + P][128]
  float* xs = ex + 2 * (1 + P) * SW_BN;          // [xr][SW_LDX]
  float* red = xs + xr * SW_LDX;                 // [P][128]
  float* a2s = red + P * SW_BM;                  // [128]

  const int nbj = (n + SW_BN - 1) / SW_BN;
  const int S = gridDim.y;
  const int slice = blockIdx.y;
  const int j0 = (int)((long)slice * nbj / S);
  const int j1 = (int)((long)(slice + 1) * nbj / S);
  const int nkc = (d + SW_KC - 1) / SW_KC;
  TileWalk<P, KIND> walk(A, packed, m, d, j0, j1, (long)(j1 - j0) * nkc, kp, cs, ex, xs, a2s, j0,
                         j0, 0);
  const int r0 = blockIdx.x * SW_BM;
  walk.stage_rows(r0);
  __syncthreads();
  float t[8][P];
  walk.pass1(t);
  combine_rows<P>(t, red, walk.ty, [&](int r, int c, float tv) {
    const int row = r0 + r;
    if (row >= m || c >= p) return;
    if (S > 1) {
      partial[((size_t)slice * m + row) * p + c] = tv;
    } else {
      const size_t o = (size_t)row * p + c;
      out[o] = add != nullptr ? tv + add[o] : tv;
    }
  });
}

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
  TileWalk<1, KIND> walk(A, packed, m, d, 0, nbj, (r.t1 - r.t0) * nkc, kp, cs, ex, xs, a2s, r.bj,
                         sym ? r.bi : 0, sym);
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

using SweepKernel = void (*)(const float*, const float*, const float*, const float*, int, int,
                            int, int, KParams, int, float*, int*);
using MatmulKernel = void (*)(const float*, const float*, const float*, int, int, int, int,
                              KParams, float*, float*);
using PairwiseKernel = void (*)(const float*, const float*, int, int, int, KParams, int, float*);

// B1's instantiation for a kernel kind, with its dynamic shared memory set.
template <int P>
static cudaError_t sweep_kernel(int kind, int smem_bytes, SweepKernel* k) {
  switch (kind) {
    case GAUSSIAN: *k = fused_sweep_kernel<P, GAUSSIAN>; break;
    case LAPLACIAN: *k = fused_sweep_kernel<P, LAPLACIAN>; break;
    case MATERN32: *k = fused_sweep_kernel<P, MATERN32>; break;
    case LINEAR: *k = fused_sweep_kernel<P, LINEAR>; break;
    case POLYNOMIAL: *k = fused_sweep_kernel<P, POLYNOMIAL>; break;
    default: return cudaErrorInvalidValue;
  }
  return cudaFuncSetAttribute(*k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

// B2's, likewise.
template <int P>
static cudaError_t matmul_kernel(int kind, int smem_bytes, MatmulKernel* k) {
  switch (kind) {
    case GAUSSIAN: *k = kernel_matmul_kernel<P, GAUSSIAN>; break;
    case LAPLACIAN: *k = kernel_matmul_kernel<P, LAPLACIAN>; break;
    case MATERN32: *k = kernel_matmul_kernel<P, MATERN32>; break;
    case LINEAR: *k = kernel_matmul_kernel<P, LINEAR>; break;
    case POLYNOMIAL: *k = kernel_matmul_kernel<P, POLYNOMIAL>; break;
    default: return cudaErrorInvalidValue;
  }
  return cudaFuncSetAttribute(*k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

// B3's, likewise.
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

// Resident blocks of 256 threads of kernel k on the whole card.
template <class K>
static cudaError_t card_slots(K k, int smem_bytes, int* slots) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k, SW_NT, smem_bytes);
  if (err != cudaSuccess) return err;
  *slots = (occ > 0 ? occ : 1) * sms;
  return cudaSuccess;
}

template <int P>
static cudaError_t sweep_grid_t(int kind, int smem_bytes, int* grid) {
  SweepKernel k = nullptr;
  cudaError_t err = sweep_kernel<P>(kind, smem_bytes, &k);
  if (err != cudaSuccess) return err;
  return card_slots(k, smem_bytes, grid);
}

// B1's launches: pack_centers, fused_sweep_kernel, reduce_partials.
template <int P>
static cudaError_t sweep_t(const float* X, const float* C, const float* u, const float* v,
                           const float* mask, int n, int M, int d, int p, KParams kp,
                           int w_in_smem, int smem_bytes, int grid, float* packed,
                           float* partial, float* w, int* counter, cudaStream_t stream) {
  const size_t need = sizeof(float) * sweep_smem_floats<P>(d, w_in_smem ? M : 0);
  if ((size_t)smem_bytes < need) return cudaErrorInvalidValue;
  SweepKernel k = nullptr;
  cudaError_t err = sweep_kernel<P>(kp.kind, smem_bytes, &k);
  if (err != cudaSuccess) return err;
  const int nbj = (M + SW_BN - 1) / SW_BN;
  pack_centers<P><<<nbj, SW_BN, 0, stream>>>(C, u, M, d, p, packed);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k<<<grid, SW_NT, smem_bytes, stream>>>(X, packed, v, mask, n, M, d, p, kp, w_in_smem, partial,
                                         counter);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int total = M * p;
  reduce_partials<<<(total + 255) / 256, 256, 0, stream>>>(partial, grid, M, P, p, nullptr, w);
  return cudaGetLastError();
}

// B2's shared memory and resident blocks on the card for (P, kind, d).
template <int P>
static cudaError_t matmul_slots_t(int kind, int d, int* smem_bytes, int* slots) {
  *smem_bytes = (int)(sizeof(float) * matmul_smem_floats<P>(d));
  MatmulKernel k = nullptr;
  cudaError_t err = matmul_kernel<P>(kind, *smem_bytes, &k);
  if (err != cudaSuccess) return err;
  return card_slots(k, *smem_bytes, slots);
}

// B2's launches: pack_centers (B k-major with ||b||^2 and V), the kernel on
// an (nbi, S) grid, and for S > 1 reduce_partials over the slices.
template <int P>
static cudaError_t matmul_t(const float* A, const float* B, const float* V, const float* add,
                            int m, int n, int d, int p, KParams kp, int slots, float* packed,
                            float* partial, float* out, cudaStream_t stream) {
  const int smem = (int)(sizeof(float) * matmul_smem_floats<P>(d));
  MatmulKernel k = nullptr;
  cudaError_t err = matmul_kernel<P>(kp.kind, smem, &k);
  if (err != cudaSuccess) return err;
  const int nbi = (m + SW_BM - 1) / SW_BM;
  const int nbj = (n + SW_BN - 1) / SW_BN;
  const int S = matmul_slices(nbi, nbj, slots);
  if (S > 1 && partial == nullptr) return cudaErrorInvalidValue;
  pack_centers<P><<<nbj, SW_BN, 0, stream>>>(B, V, n, d, p, packed);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k<<<dim3(nbi, S), SW_NT, smem, stream>>>(A, packed, add, m, n, d, p, kp, partial, out);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (S > 1) {
    const int total = m * p;
    reduce_partials<<<(total + 255) / 256, 256, 0, stream>>>(partial, S, m, p, p, add, out);
  }
  return cudaGetLastError();
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
  pack_centers<1><<<nbj, SW_BN, 0, stream>>>(B, nullptr, n, d, 0, packed);
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

int rt_sweep_grid(int P, int kind, int smem_bytes, int* grid) {
  switch (P) {
    case 1: return (int)rt::sweep_grid_t<1>(kind, smem_bytes, grid);
    case 4: return (int)rt::sweep_grid_t<4>(kind, smem_bytes, grid);
    default: return (int)cudaErrorInvalidValue;
  }
}

int rt_fused_sweep(const void* X, const void* C, const void* u, const void* v, const void* mask,
                   int n, int M, int d, int p, int kind, float sigma, float coef, float ss,
                   float c, int degree, int P, int w_in_smem, int smem_bytes, int grid,
                   void* packed, void* partial, void* w, void* counter, void* stream) {
  const KParams kp = rt::kparams(kind, sigma, coef, ss, c, degree);
  const float* Xf = static_cast<const float*>(X);
  const float* Cf = static_cast<const float*>(C);
  const float* uf = static_cast<const float*>(u);
  const float* vf = static_cast<const float*>(v);
  const float* mf = static_cast<const float*>(mask);
  float* kf = static_cast<float*>(packed);
  float* pf = static_cast<float*>(partial);
  float* wf = static_cast<float*>(w);
  int* cnt = static_cast<int*>(counter);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 1: return (int)rt::sweep_t<1>(Xf, Cf, uf, vf, mf, n, M, d, p, kp, w_in_smem, smem_bytes, grid, kf, pf, wf, cnt, st);
    case 4: return (int)rt::sweep_t<4>(Xf, Cf, uf, vf, mf, n, M, d, p, kp, w_in_smem, smem_bytes, grid, kf, pf, wf, cnt, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int rt_matmul_slots(int P, int kind, int d, int* smem_bytes, int* slots) {
  switch (P) {
    case 1: return (int)rt::matmul_slots_t<1>(kind, d, smem_bytes, slots);
    case 4: return (int)rt::matmul_slots_t<4>(kind, d, smem_bytes, slots);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The slices B2 splits B's tiles into (a count, not an error code).
int rt_matmul_slices(int m, int n, int slots) {
  return rt::matmul_slices((m + rt::SW_BM - 1) / rt::SW_BM, (n + rt::SW_BN - 1) / rt::SW_BN, slots);
}

int rt_kernel_matmul(const void* A, const void* B, const void* V, const void* add, int m, int n,
                     int d, int p, int kind, float sigma, float coef, float ss, float c,
                     int degree, int P, int slots, void* packed, void* partial, void* out,
                     void* stream) {
  const KParams kp = rt::kparams(kind, sigma, coef, ss, c, degree);
  const float* Af = static_cast<const float*>(A);
  const float* Bf = static_cast<const float*>(B);
  const float* Vf = static_cast<const float*>(V);
  const float* addf = static_cast<const float*>(add);
  float* kf = static_cast<float*>(packed);
  float* pf = static_cast<float*>(partial);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 1: return (int)rt::matmul_t<1>(Af, Bf, Vf, addf, m, n, d, p, kp, slots, kf, pf, of, st);
    case 4: return (int)rt::matmul_t<4>(Af, Bf, Vf, addf, m, n, d, p, kp, slots, kf, pf, of, st);
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
