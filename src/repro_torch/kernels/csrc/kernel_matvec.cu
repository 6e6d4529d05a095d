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
//     tiles. B1 has its own tile code; B2-B4 keep B0 (tile.cuh).
//
// B2  kernel_matmul_kernel  out = K(A,B) V + add
//     Replaces repro/kernels/kernel_matvec.py::kernel_matmul_pallas /
//     _kernel_matmul_kernel. Bound: fp32 FMA issue, m*n*(2d + 10 + 2p) flops
//     against 67 TFLOP/s. Design: one block per 64-row block of A loops over
//     the B tiles with the pass-1 code of B1 (register accumulation, one
//     shuffle reduction at the end); padded B rows are masked; `add` is
//     added at the final store. No cross-block reduction.
//
// B3  pairwise_kernel       K(A,B) materialized
//     Replaces repro/kernels/kernel_matvec.py::pairwise_kernel_pallas /
//     _pairwise_kernel. Bound: the m*n*4-byte store against 3.35 TB/s.
//     Design: a 2-D grid of 64 x 64 output tiles, each evaluated by B0 and
//     stored with 16 consecutive lanes on 16 consecutive floats.
//
// Plain C interface, loaded with ctypes by repro_torch/kernels/build.py:
// every entry returns cudaGetLastError() after its launches.
#include <cuda_runtime.h>

#include "tile.cuh"

namespace rt {

// The whole of B2: t[i][c] = sum_j K(A_row, B_j) V[j][c]
// for this thread's rows (r0 + ty + TY*i), over every B tile. V is staged
// per tile into vs (BN x P, zero past n and p). On return every lane of a
// row holds the full row sum.
template <int P>
__device__ __forceinline__ void forward_rows(const float* __restrict__ A, int m,
                                             const float* __restrict__ B, int n, int d,
                                             const float* __restrict__ V, int p, int r0,
                                             TileSmem& s, float* vs, const KParams& kp,
                                             float t[TM][P], int& evals) {
  const int tid = threadIdx.x;
  const int tx = tid % TX;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < P; ++c) t[i][c] = 0.0f;
  const int nbj = (n + BN - 1) / BN;
  for (int bj = 0; bj < nbj; ++bj) {
    const int c0 = bj * BN;
    __syncthreads();  // vs of the previous tile is no longer read
    for (int e = tid; e < BN * P; e += NT) {
      const int r = e / P;
      const int c = e - r * P;
      vs[e] = (c0 + r < n && c < p) ? V[(size_t)(c0 + r) * p + c] : 0.0f;
    }
    float k[TM][TN];
    eval_tile(A, m, B, n, d, r0, c0, s, kp, k);  // its barrier publishes vs
    ++evals;
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int c = 0; c < P; ++c) {
        const float vj = vs[(tx + TX * j) * P + c];
#pragma unroll
        for (int i = 0; i < TM; ++i) t[i][c] = fmaf(k[i][j], vj, t[i][c]);
      }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < P; ++c) t[i][c] = row_sum(t[i][c]);
}

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
// C[m] k-major, its squared norm (fmaf in k order, as B0 sums it) and u[m],
// all zero past M and p.
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

// The kernel map of a whole micro-tile, in registers: B0's kmap per entry
// (the same rounding as B2 and B3), its kind fixed at compile time. A
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

// A block's center stream: each pass walks tiles 0..nbj-1, a tile's k-chunks
// consecutive. The n-th chunk fetched lands in ring slot n & 1; a tile's
// first chunk also brings its extras into extras slot (tile sequence) & 1.
struct ChunkCursor {
  int chunk;   // k-chunk of the next chunk to fetch
  int tile;    // its center tile
  int tseq;    // tiles begun before it, over the whole stream
  int slot;    // its ring slot
};

template <int P>
__device__ __forceinline__ void fetch_chunk(const float* __restrict__ packed, int d, int nkc,
                                            int nbj, ChunkCursor& cur, float* cs, float* ex) {
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
    if (++cur.tile == nbj) cur.tile = 0;
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
  const int lane = tid % 32;
  // B7's map: a warp covers 4 x 8 threads, 32 rows and 64 columns
  const int ty = (warp / 2) * 4 + lane / 8;
  const int tx = (warp % 2) * 8 + lane % 8;

  const int nbi = (n + SW_BM - 1) / SW_BM;
  const int nbj = (M + SW_BN - 1) / SW_BN;
  const int nkc = (d + SW_KC - 1) / SW_KC;
  const bool resident = d <= SW_XK;
  const int my_blocks = (nbi - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const long total = (long)my_blocks * 2 * nbj * nkc;   // chunks this block computes
  long s = 0;                                           // the next chunk to compute
  int tseq = 0;                                         // tiles begun
  ChunkCursor cur = {0, 0, 0, 0};                       // the next chunk to fetch

  fetch_chunk<P>(packed, d, nkc, nbj, cur, cs, ex);
  for (int e = tid; e < M * P; e += SW_NT) wpart[e] = 0.0f;   // read after a barrier

  int evals = 0;
  int r0 = 0;
  // K(X_i, C_j) into acc, mapped; returns tile j's extras (||c||^2, u).
  // The norms (and pass 2's t) are read from shared memory after the k
  // loop, so that only acc and the k step's operands are live through it.
  auto eval_tile = [&](float (&acc)[8][8]) -> const float* {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    const int tile_seq = tseq++;
    for (int kc = 0; kc < nkc; ++kc, ++s) {
      cp_async_wait_all();
      __syncthreads();   // chunk s is visible; slot (s + 1) & 1 is no longer read
      if (s + 1 < total) fetch_chunk<P>(packed, d, nkc, nbj, cur, cs, ex);
      const int k0 = kc * SW_KC;
      const int kr = min(SW_KC, d - k0);
      const float* xb = xs + k0 * SW_LDX;
      if (!resident) {
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
  };

  for (int bi = blockIdx.x; bi < nbi; bi += gridDim.x) {
    r0 = bi * SW_BM;
    __syncthreads();   // the last row block no longer reads xs, ts, red or a2s
    if (resident) stage_x(X, n, d, r0, 0, d, xs);
    if (tid < SW_BM) {
      float nrm = 0.0f;   // fmaf in k order, as pack_centers and B0 sum
      if (r0 + tid < n)
        for (int k = 0; k < d; ++k) {
          const float x = X[(size_t)(r0 + tid) * d + k];
          nrm = fmaf(x, x, nrm);
        }
      a2s[tid] = nrm;
    }
    __syncthreads();

    // pass 1: t_i = K_i u, this thread's 8 columns of every tile
    float t[8][P];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < P; ++c) t[i][c] = 0.0f;
    for (int bj = 0; bj < nbj; ++bj) {
      float acc[8][8];
      const float* e = eval_tile(acc);
#pragma unroll
      for (int c = 0; c < P; ++c) {
        float uj[8];   // u is zero past M
        load8(e + (1 + c) * SW_BN, tx * 4, uj);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) t[i][c] = fmaf(acc[i][j], uj[j], t[i][c]);
      }
    }
    // t over the 8 threads of a row in a warp, then over the row range's two
    // warps (warp % 2 = 0 first), then v and the mask; padded rows give 0
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < P; ++c) {
        t[i][c] += __shfl_xor_sync(0xffffffffu, t[i][c], 1);
        t[i][c] += __shfl_xor_sync(0xffffffffu, t[i][c], 2);
        t[i][c] += __shfl_xor_sync(0xffffffffu, t[i][c], 4);
      }
    const int mine = lane % 8;   // the row slot this lane reports
    if (warp % 2 == 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i == mine)
#pragma unroll
          for (int c = 0; c < P; ++c)
            red[c * SW_BM + (i / 4) * SW_HALF + ty * 4 + i % 4] = t[i][c];
    }
    __syncthreads();
    if (warp % 2 == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i == mine) {
          const int r = (i / 4) * SW_HALF + ty * 4 + i % 4;
          const int row = r0 + r;
#pragma unroll
          for (int c = 0; c < P; ++c) {
            float tv = t[i][c] + red[c * SW_BM + r];
            if (row < n && c < p) {
              if (v != nullptr) tv += v[(size_t)row * p + c];
              if (mask != nullptr) tv *= mask[row];
            } else {
              tv = 0.0f;
            }
            ts[c * SW_BM + r] = tv;
          }
        }
    }
    __syncthreads();

    // pass 2: w_j += K_ij^T t_i. This thread's 8 rows, then the 4 threads of
    // its warp on the same columns, then the 4 warps, in a fixed order
    for (int bj = 0; bj < nbj; ++bj) {
      float acc[8][8];
      eval_tile(acc);
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
  if (tid == 0) atomicAdd(counter, evals);
}

// w[m][c] = sum over the G block partials, in block order.
__global__ void reduce_partials(const float* __restrict__ partial, int G, int M, int P, int p,
                                float* __restrict__ w) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= M * p) return;
  const int m = e / p;
  const int c = e - m * p;
  float s = 0.0f;
  for (int g = 0; g < G; ++g) s += partial[((size_t)g * M + m) * P + c];
  w[e] = s;
}

template <int P>
__global__ void __launch_bounds__(NT)
    kernel_matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
                         const float* __restrict__ V, const float* __restrict__ add, int m,
                         int n, int d, int p, KParams kp, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  TileSmem& s = *reinterpret_cast<TileSmem*>(smem4);
  float* vs = reinterpret_cast<float*>(&s + 1);
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int r0 = blockIdx.x * BM;
  int evals = 0;
  float t[TM][P];
  forward_rows<P>(A, m, B, n, d, V, p, r0, s, vs, kp, t, evals);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = r0 + ty + TY * i;
      if (row >= m) continue;
#pragma unroll
      for (int c = 0; c < P; ++c) {
        if (c < p) {
          const size_t o = (size_t)row * p + c;
          out[o] = add != nullptr ? t[i][c] + add[o] : t[i][c];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(NT)
    pairwise_kernel(const float* __restrict__ A, const float* __restrict__ B, int m, int n,
                    int d, KParams kp, float* __restrict__ out) {
  __shared__ TileSmem s;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int r0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * BN;
  float k[TM][TN];
  eval_tile(A, m, B, n, d, r0, c0, s, kp, k);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = r0 + ty + TY * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = c0 + tx + TX * j;
      if (col < n) out[(size_t)row * n + col] = k[i][j];
    }
  }
}

using SweepKernel = void (*)(const float*, const float*, const float*, const float*, int, int,
                            int, int, KParams, int, float*, int*);

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

template <int P>
static cudaError_t sweep_grid_t(int kind, int smem_bytes, int* grid) {
  SweepKernel k = nullptr;
  cudaError_t err = sweep_kernel<P>(kind, smem_bytes, &k);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, occ = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k, SW_NT, smem_bytes);
  if (err != cudaSuccess) return err;
  *grid = (occ > 0 ? occ : 1) * sms;
  return cudaSuccess;
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
  reduce_partials<<<(total + 255) / 256, 256, 0, stream>>>(partial, grid, M, P, p, w);
  return cudaGetLastError();
}

template <int P>
static cudaError_t matmul_t(const float* A, const float* B, const float* V, const float* add,
                            int m, int n, int d, int p, KParams kp, float* out,
                            cudaStream_t stream) {
  const int smem = (int)(sizeof(TileSmem) + sizeof(float) * BN * P);
  const int blocks = (m + BM - 1) / BM;
  kernel_matmul_kernel<P><<<blocks, NT, smem, stream>>>(A, B, V, add, m, n, d, p, kp, out);
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

int rt_tile_smem_bytes() { return (int)sizeof(rt::TileSmem); }

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

int rt_kernel_matmul(const void* A, const void* B, const void* V, const void* add, int m, int n,
                     int d, int p, int kind, float sigma, float coef, float ss, float c,
                     int degree, int P, void* out, void* stream) {
  const KParams kp = rt::kparams(kind, sigma, coef, ss, c, degree);
  const float* Af = static_cast<const float*>(A);
  const float* Bf = static_cast<const float*>(B);
  const float* Vf = static_cast<const float*>(V);
  const float* addf = static_cast<const float*>(add);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 1: return (int)rt::matmul_t<1>(Af, Bf, Vf, addf, m, n, d, p, kp, of, st);
    case 4: return (int)rt::matmul_t<4>(Af, Bf, Vf, addf, m, n, d, p, kp, of, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int rt_pairwise(const void* A, const void* B, int m, int n, int d, int kind, float sigma,
                float coef, float ss, float c, int degree, void* out, void* stream) {
  const KParams kp = rt::kparams(kind, sigma, coef, ss, c, degree);
  const dim3 grid((m + rt::BM - 1) / rt::BM, (n + rt::BN - 1) / rt::BN);
  rt::pairwise_kernel<<<grid, rt::NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(B), m, n, d, kp,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
