// The tile code of B1 (fused_sweep_kernel) and B2 (kernel_matmul_kernel),
// templated on the type X (B2: A) is stored in and on Kahan compensation,
// and the host launchers of one build of both. kernel_matvec.cu (its header
// comment gives each kernel's bound and design) builds the fp32 plain
// variant and B3 on this code; kernel_matvec_f32c.cu, kernel_matvec_bf16c.cu
// and kernel_matvec_f16c.cu build the compensated variants, each in its own
// nvcc run, so the four compile in parallel.
//
// The reduced-precision, compensated form replaces the compensated=True
// paths of repro/kernels/kernel_matvec.py (fused_sweep_pallas,
// kernel_matmul_pallas, sharded_sweep_pallas; _two_sum):
//   - Widen at load. X is read at its type (TX) and staged as fp32 into the
//     same shared-memory X block; pack_centers reads C (B2: B) and u (V) at
//     theirs and writes the same fp32 packed tiles. The ring, the FMA loop
//     and shared memory do not change: a bf16 x bf16 product is exact in
//     fp32, as on the MXU with preferred_element_type=float32; so is a
//     float16 x float16 product (11-bit significands). v (B2: add) is read,
//     and the output written, at a type given at run time (the epilogues of
//     the compensated builds only: load_io, store_io); a bf16 or float16
//     output is rounded once (__float2bfloat16_rn, __float2half_rn: round
//     to nearest even, as torch's .to(bfloat16) and .to(float16)).
//   - COMP: a Kahan carry beside each accumulator, where the reference has
//     one. t over the center (B2: B) tiles: each tile's contribution to a
//     thread's t is summed into a delta and two-summed into t; the carry is
//     folded (t - carry) before the cross-thread reduction. w over B1's row
//     blocks: the block's w partial carries a same-size buffer, in shared
//     memory with it or in the global scratch behind the partials.
//     reduce_partials folds each partial with its carry and two-sums them
//     in block (slice) order. two_sum is written with __fadd_rn/__fsub_rn,
//     so that nvcc can neither contract nor reorder it.
//   - COMP = false with TX = float is the fp32 kernel, its arithmetic
//     unchanged.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "tile.cuh"

namespace rt {

constexpr int SW_BM = 128;             // X rows of a row block
constexpr int SW_BN = 128;             // centers of a center tile
constexpr int SW_HALF = 64;            // offset of a thread's second 4 x 4 block
constexpr int SW_KC = 32;              // k depth of a ring chunk
constexpr int SW_XK = 128;             // k depth of X kept resident per row block
constexpr int SW_LDX = SW_BM + 4;      // padded k-major row of the X block
constexpr int SW_NT = 256;
static_assert(SW_XK % SW_KC == 0, "an X chunk holds whole ring chunks");

// Element types of the operands and outputs given at run time
// (repro_torch.kernels.kernel_matvec.DTYPE_CODES).
enum DType : int { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// Element i of a float32, bfloat16 or float16 array, as fp32 (exact).
__device__ __forceinline__ float load_as(const void* p, int dt, size_t i) {
  if (dt == DT_BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dt == DT_F16) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

// x into element i of a float32, bfloat16 or float16 array, rounded once to
// nearest even.
__device__ __forceinline__ void store_as(void* p, int dt, size_t i, float x) {
  if (dt == DT_BF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  else if (dt == DT_F16)
    static_cast<__half*>(p)[i] = __float2half_rn(x);
  else
    static_cast<float*>(p)[i] = x;
}

// The epilogues' v, add and output: of the type given at run time in a
// TYPED build (the compensated ones), fp32 in the fp32 build, whose wrapper
// widens a bf16 v or add and narrows a bf16 output itself, so that its
// epilogues stay plain fp32 loads and stores.
template <bool TYPED>
__device__ __forceinline__ float load_io(const void* p, int dt, size_t i) {
  if constexpr (TYPED) return load_as(p, dt, i);
  return static_cast<const float*>(p)[i];
}

template <bool TYPED>
__device__ __forceinline__ void store_io(void* p, int dt, size_t i, float x) {
  if constexpr (TYPED)
    store_as(p, dt, i, x);
  else
    static_cast<float*>(p)[i] = x;
}

// Kahan/two-sum compensated acc += delta (the reference's _two_sum): comp
// holds what the adds lost, and acc - comp is the sum.
__device__ __forceinline__ void two_sum(float& acc, float& comp, float delta) {
  const float y = __fsub_rn(delta, comp);
  const float s = __fadd_rn(acc, y);
  comp = __fsub_rn(__fsub_rn(s, acc), y);
  acc = s;
}

// Shared-memory floats of one sweep block, in carve order: the center ring
// (2 chunks), the tile extras ring (||c||^2 and u, 2 tiles), the X block,
// t of the row block, the cross-warp reduction buffer, the row norms and
// (optionally) the w partial, with its carry when COMP. Mirrored by
// repro_torch.kernels.kernel_matvec.sweep_smem_bytes.
template <int P, bool COMP>
__host__ __device__ constexpr size_t sweep_smem_floats(int d, int w_rows) {
  return 2 * (size_t)(d < SW_KC ? d : SW_KC) * SW_BN + 2 * (size_t)(1 + P) * SW_BN +
         (size_t)(d < SW_XK ? d : SW_XK) * SW_LDX + (size_t)P * SW_BM +
         4 * (size_t)P * SW_BN + SW_BM + (size_t)w_rows * P * (COMP ? 2 : 1);
}

// Floats of one packed center tile: d k-rows, ||c||^2, then P rows of u.
template <int P>
__host__ __device__ constexpr size_t packed_tile_floats(int d) {
  return (size_t)(d + 1 + P) * SW_BN;
}

// The prologue: one thread per center. Column m % 128 of tile m / 128 gets
// C[m] k-major, its squared norm (fmaf in k order, as TileWalk::stage_rows
// sums a row's) and u[m], all zero past M and p, widened to fp32.
template <int P, class TC, class TU>
__global__ void __launch_bounds__(SW_BN)
    pack_centers(const TC* __restrict__ C, const TU* __restrict__ u, int M, int d, int p,
                 float* __restrict__ packed) {
  const int m = blockIdx.x * SW_BN + threadIdx.x;
  float* dst = packed + blockIdx.x * packed_tile_floats<P>(d) + threadIdx.x;
  float nrm = 0.0f;
  for (int k = 0; k < d; ++k) {
    const float x = m < M ? to_f32(C[(size_t)m * d + k]) : 0.0f;
    nrm = fmaf(x, x, nrm);
    dst[(size_t)k * SW_BN] = x;
  }
  dst[(size_t)d * SW_BN] = nrm;
#pragma unroll
  for (int c = 0; c < P; ++c)
    dst[(size_t)(d + 1 + c) * SW_BN] = (m < M && c < p) ? to_f32(u[(size_t)m * p + c]) : 0.0f;
}

// pack_centers for C and u of the types ct and ut (DType codes).
template <int P>
cudaError_t launch_pack(const void* C, int ct, const void* u, int ut, int M, int d, int p,
                        float* packed, cudaStream_t stream) {
  const int nbj = (M + SW_BN - 1) / SW_BN;
  using bf = __nv_bfloat16;
  using hf = __half;
  if (ct == DT_F32 && ut == DT_F32)
    pack_centers<P, float, float><<<nbj, SW_BN, 0, stream>>>(
        static_cast<const float*>(C), static_cast<const float*>(u), M, d, p, packed);
  else if (ct == DT_BF16 && ut == DT_F32)
    pack_centers<P, bf, float><<<nbj, SW_BN, 0, stream>>>(
        static_cast<const bf*>(C), static_cast<const float*>(u), M, d, p, packed);
  else if (ct == DT_BF16 && ut == DT_BF16)
    pack_centers<P, bf, bf><<<nbj, SW_BN, 0, stream>>>(
        static_cast<const bf*>(C), static_cast<const bf*>(u), M, d, p, packed);
  else if (ct == DT_F32 && ut == DT_BF16)
    pack_centers<P, float, bf><<<nbj, SW_BN, 0, stream>>>(
        static_cast<const float*>(C), static_cast<const bf*>(u), M, d, p, packed);
  else if (ct == DT_F16 && ut == DT_F32)
    pack_centers<P, hf, float><<<nbj, SW_BN, 0, stream>>>(
        static_cast<const hf*>(C), static_cast<const float*>(u), M, d, p, packed);
  else if (ct == DT_F16 && ut == DT_F16)
    pack_centers<P, hf, hf><<<nbj, SW_BN, 0, stream>>>(
        static_cast<const hf*>(C), static_cast<const hf*>(u), M, d, p, packed);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
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

// X[r0 : r0 + 128, k0 : k0 + kr] into xs k-major, widened to fp32, zero
// past n.
template <class TX>
__device__ __forceinline__ void stage_x(const TX* __restrict__ X, int n, int d, int r0, int k0,
                                        int kr, float* xs) {
  for (int e = threadIdx.x; e < SW_BM * kr; e += SW_NT) {
    const int r = e / kr;
    const int k = e - r * kr;
    xs[k * SW_LDX + r] = r0 + r < n ? to_f32(X[(size_t)(r0 + r) * d + k0 + k]) : 0.0f;
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
// B3: A; stored as TX, staged as fp32) against its stream of packed tiles
// j0..j1-1 (B1: every center tile, twice per row block; B2: one slice of
// B's tiles, once; B3: its range of output tiles, the stream beginning at
// tile `start` and wrapping as ChunkCursor says). The shared-memory regions
// are the caller's: cs [2][min(d, 32)][128] (the ring), ex [2][1 + P][128]
// (the extras ring), xs [min(d, 128)][SW_LDX] (the X block, k-major) and
// a2s [128] (its row norms). COMP: pass 1 two-sums t over the tiles.
template <int P, int KIND, class TX, bool COMP>
struct TileWalk {
  const TX* __restrict__ X;
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

  __device__ __forceinline__ TileWalk(const TX* X_, const float* packed_, int n_, int d_, int j0_,
                                      int j1_, long total_, KParams kp_, float* cs_, float* ex_,
                                      float* xs_, float* a2s_, int start, int first, int step)
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
          const float x = to_f32(X[(size_t)(r0 + tid) * d + k]);
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
  // columns of every tile, in tile order (COMP: each tile's 8 products a
  // delta, two-summed into t, the carry folded at the end), then over the
  // 8 threads of a row in the warp. The row range's two warps are combined
  // by combine_rows.
  __device__ __forceinline__ void pass1(float (&t)[8][P]) {
    float tc[8][P];   // t's carries (COMP)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < P; ++c) {
        t[i][c] = 0.0f;
        if constexpr (COMP) tc[i][c] = 0.0f;
      }
    for (int bj = j0; bj < j1; ++bj) {
      float acc[8][8];
      const float* e = eval_tile(acc);
#pragma unroll
      for (int c = 0; c < P; ++c) {
        float uj[8];   // u is zero past the packed rows
        load8(e + (1 + c) * SW_BN, tx * 4, uj);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if constexpr (COMP) {
            float delta = 0.0f;
#pragma unroll
            for (int j = 0; j < 8; ++j) delta = fmaf(acc[i][j], uj[j], delta);
            two_sum(t[i][c], tc[i][c], delta);
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) t[i][c] = fmaf(acc[i][j], uj[j], t[i][c]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < P; ++c) {
        if constexpr (COMP) t[i][c] = __fsub_rn(t[i][c], tc[i][c]);
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

// B1. The partials are [G][M][P] floats, then (COMP) their carries,
// [G][M][P]; v is of type vt.
template <int P, int KIND, class TX, bool COMP>
__global__ void __launch_bounds__(SW_NT, P == 1 ? 2 : 1)
    fused_sweep_kernel(const TX* __restrict__ X, const float* __restrict__ packed,
                       const void* __restrict__ v, int vt, const float* __restrict__ mask, int n,
                       int M, int d, int p, KParams kp, int w_in_smem,
                       float* __restrict__ partial, int* __restrict__ counter) {
  extern __shared__ float4 smem4[];
  const int cr = min(d, SW_KC);
  const int xr = min(d, SW_XK);
  float* cs = reinterpret_cast<float*>(smem4);   // [2][cr][128]
  float* ex = cs + 2 * cr * SW_BN;               // [2][1 + P][128]
  float* xs = ex + 2 * (1 + P) * SW_BN;          // [xr][SW_LDX]
  float* ts = xs + xr * SW_LDX;                  // [P][128]
  float* red = ts + P * SW_BM;                   // [4][P][128]
  float* a2s = red + 4 * P * SW_BN;              // [128]
  float* wsm = a2s + SW_BM;                      // [M][P] when w_in_smem, then its carry
  const size_t wsize = (size_t)M * P;
  float* gpart = partial + (size_t)blockIdx.x * wsize;
  float* wpart = w_in_smem ? wsm : gpart;
  float* gcarry = partial + ((size_t)gridDim.x + blockIdx.x) * wsize;
  float* wcarry = w_in_smem ? wsm + wsize : gcarry;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int nbi = (n + SW_BM - 1) / SW_BM;
  const int nbj = (M + SW_BN - 1) / SW_BN;
  const int nkc = (d + SW_KC - 1) / SW_KC;
  const int my_blocks = (nbi - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  // every center tile twice per row block, each in nkc chunks
  TileWalk<P, KIND, TX, COMP> walk(X, packed, n, d, 0, nbj, (long)my_blocks * 2 * nbj * nkc, kp,
                                   cs, ex, xs, a2s, 0, 0, 0);
  const int ty = walk.ty;
  const int tx = walk.tx;
  for (int e = tid; e < M * P; e += SW_NT) {   // read after a barrier
    wpart[e] = 0.0f;
    if constexpr (COMP) wcarry[e] = 0.0f;
  }

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
        if (v != nullptr) tv += load_io<COMP>(v, vt, (size_t)row * p + c);
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
          const size_t at = (size_t)(c0 + col) * P + c;
          if constexpr (COMP)
            two_sum(wpart[at], wcarry[at], sum);
          else
            wpart[at] += sum;
        }
      }
      // red is written again only after the next chunk's barrier
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (w_in_smem) {
    for (int e = tid; e < M * P; e += SW_NT) {
      gpart[e] = wsm[e];
      if constexpr (COMP) gcarry[e] = wcarry[e];
    }
  }
  if (tid == 0) atomicAdd(counter, walk.evals);
}

// w[m][c] = sum over the G partials in order (+ add[m][c]): B1's block
// partials, B2's slice partials. COMP: each partial less its carry (when
// `carries` is given), two-summed in order and folded. add is of type addt,
// w of type wt.
template <bool COMP>
__global__ void reduce_partials(const float* __restrict__ partial,
                                const float* __restrict__ carries, int G, int M, int P, int p,
                                const void* __restrict__ add, int addt, void* __restrict__ w,
                                int wt) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= M * p) return;
  const int m = e / p;
  const int c = e - m * p;
  float s = 0.0f;
  if constexpr (COMP) {
    float sc = 0.0f;
    for (int g = 0; g < G; ++g) {
      const size_t at = ((size_t)g * M + m) * P + c;
      two_sum(s, sc, carries != nullptr ? __fsub_rn(partial[at], carries[at]) : partial[at]);
    }
    s = __fsub_rn(s, sc);
  } else {
    for (int g = 0; g < G; ++g) s += partial[((size_t)g * M + m) * P + c];
  }
  store_io<COMP>(w, wt, e, add != nullptr ? s + load_io<COMP>(add, addt, e) : s);
}

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
inline int matmul_slices(int nbi, int nbj, int slots) {
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
// reduce_partials sums in slice order before adding `add`. add is of type
// addt, out of type ot.
template <int P, int KIND, class TX, bool COMP>
__global__ void __launch_bounds__(SW_NT, P == 1 ? 2 : 1)
    kernel_matmul_kernel(const TX* __restrict__ A, const float* __restrict__ packed,
                         const void* __restrict__ add, int addt, int m, int n, int d, int p,
                         KParams kp, float* __restrict__ partial, void* __restrict__ out,
                         int ot) {
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
  TileWalk<P, KIND, TX, COMP> walk(A, packed, m, d, j0, j1, (long)(j1 - j0) * nkc, kp, cs, ex, xs,
                                   a2s, j0, j0, 0);
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
      store_io<COMP>(out, ot, o, add != nullptr ? tv + load_io<COMP>(add, addt, o) : tv);
    }
  });
}

template <class TX>
using SweepKernel = void (*)(const TX*, const float*, const void*, int, const float*, int, int,
                             int, int, KParams, int, float*, int*);
template <class TX>
using MatmulKernel = void (*)(const TX*, const float*, const void*, int, int, int, int, int,
                              KParams, float*, void*, int);

// B1's instantiation for a kernel kind, with its dynamic shared memory set.
template <int P, class TX, bool COMP>
cudaError_t sweep_kernel(int kind, int smem_bytes, SweepKernel<TX>* k) {
  switch (kind) {
    case GAUSSIAN: *k = fused_sweep_kernel<P, GAUSSIAN, TX, COMP>; break;
    case LAPLACIAN: *k = fused_sweep_kernel<P, LAPLACIAN, TX, COMP>; break;
    case MATERN32: *k = fused_sweep_kernel<P, MATERN32, TX, COMP>; break;
    case LINEAR: *k = fused_sweep_kernel<P, LINEAR, TX, COMP>; break;
    case POLYNOMIAL: *k = fused_sweep_kernel<P, POLYNOMIAL, TX, COMP>; break;
    default: return cudaErrorInvalidValue;
  }
  return cudaFuncSetAttribute(*k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

// B2's, likewise.
template <int P, class TX, bool COMP>
cudaError_t matmul_kernel(int kind, int smem_bytes, MatmulKernel<TX>* k) {
  switch (kind) {
    case GAUSSIAN: *k = kernel_matmul_kernel<P, GAUSSIAN, TX, COMP>; break;
    case LAPLACIAN: *k = kernel_matmul_kernel<P, LAPLACIAN, TX, COMP>; break;
    case MATERN32: *k = kernel_matmul_kernel<P, MATERN32, TX, COMP>; break;
    case LINEAR: *k = kernel_matmul_kernel<P, LINEAR, TX, COMP>; break;
    case POLYNOMIAL: *k = kernel_matmul_kernel<P, POLYNOMIAL, TX, COMP>; break;
    default: return cudaErrorInvalidValue;
  }
  return cudaFuncSetAttribute(*k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

// Resident blocks of 256 threads of kernel k on the whole card.
template <class K>
cudaError_t card_slots(K k, int smem_bytes, int* slots) {
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

template <int P, class TX, bool COMP>
cudaError_t sweep_grid_t(int kind, int smem_bytes, int* grid) {
  SweepKernel<TX> k = nullptr;
  cudaError_t err = sweep_kernel<P, TX, COMP>(kind, smem_bytes, &k);
  if (err != cudaSuccess) return err;
  return card_slots(k, smem_bytes, grid);
}

// The operands of one B1 call: X, C, u, v of the types ct, ut, vt (X's is
// the variant's), w of type wt; partial holds grid x M x P floats, twice
// that when compensated.
struct SweepArgs {
  const void *X, *C, *u, *v;
  int ct, ut, vt;
  const float* mask;
  int n, M, d, p;
  KParams kp;
  int w_in_smem, smem_bytes, grid;
  float *packed, *partial;
  void* w;
  int wt;
  int* counter;
  cudaStream_t stream;
};

// The operands of one B2 call: A of the variant's type, B, V, add of the
// types bt, vt, addt, out of type ot; partial holds S x m x p floats.
struct MatmulArgs {
  const void *A, *B, *V, *add;
  int bt, vt, addt;
  int m, n, d, p;
  KParams kp;
  int slots;
  float *packed, *partial;
  void* out;
  int ot;
  cudaStream_t stream;
};

// B1's launches: pack_centers, fused_sweep_kernel, reduce_partials.
template <int P, class TX, bool COMP>
cudaError_t sweep_t(const SweepArgs& a) {
  const size_t need = sizeof(float) * sweep_smem_floats<P, COMP>(a.d, a.w_in_smem ? a.M : 0);
  if ((size_t)a.smem_bytes < need) return cudaErrorInvalidValue;
  SweepKernel<TX> k = nullptr;
  cudaError_t err = sweep_kernel<P, TX, COMP>(a.kp.kind, a.smem_bytes, &k);
  if (err != cudaSuccess) return err;
  if ((err = launch_pack<P>(a.C, a.ct, a.u, a.ut, a.M, a.d, a.p, a.packed, a.stream)) !=
      cudaSuccess)
    return err;
  k<<<a.grid, SW_NT, a.smem_bytes, a.stream>>>(static_cast<const TX*>(a.X), a.packed, a.v, a.vt,
                                               a.mask, a.n, a.M, a.d, a.p, a.kp, a.w_in_smem,
                                               a.partial, a.counter);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int total = a.M * a.p;
  const float* carries = COMP ? a.partial + (size_t)a.grid * a.M * P : nullptr;
  reduce_partials<COMP><<<(total + 255) / 256, 256, 0, a.stream>>>(
      a.partial, carries, a.grid, a.M, P, a.p, nullptr, DT_F32, a.w, a.wt);
  return cudaGetLastError();
}

// B2's shared memory and resident blocks on the card for (P, kind, d).
template <int P, class TX, bool COMP>
cudaError_t matmul_slots_t(int kind, int d, int* smem_bytes, int* slots) {
  *smem_bytes = (int)(sizeof(float) * matmul_smem_floats<P>(d));
  MatmulKernel<TX> k = nullptr;
  cudaError_t err = matmul_kernel<P, TX, COMP>(kind, *smem_bytes, &k);
  if (err != cudaSuccess) return err;
  return card_slots(k, *smem_bytes, slots);
}

// B2's launches: pack_centers (B k-major with ||b||^2 and V), the kernel on
// an (nbi, S) grid, and for S > 1 reduce_partials over the slices.
template <int P, class TX, bool COMP>
cudaError_t matmul_t(const MatmulArgs& a) {
  const int smem = (int)(sizeof(float) * matmul_smem_floats<P>(a.d));
  MatmulKernel<TX> k = nullptr;
  cudaError_t err = matmul_kernel<P, TX, COMP>(a.kp.kind, smem, &k);
  if (err != cudaSuccess) return err;
  const int nbi = (a.m + SW_BM - 1) / SW_BM;
  const int nbj = (a.n + SW_BN - 1) / SW_BN;
  const int S = matmul_slices(nbi, nbj, a.slots);
  if (S > 1 && a.partial == nullptr) return cudaErrorInvalidValue;
  if ((err = launch_pack<P>(a.B, a.bt, a.V, a.vt, a.n, a.d, a.p, a.packed, a.stream)) !=
      cudaSuccess)
    return err;
  k<<<dim3(nbi, S), SW_NT, smem, a.stream>>>(static_cast<const TX*>(a.A), a.packed, a.add,
                                             a.addt, a.m, a.n, a.d, a.p, a.kp, a.partial, a.out,
                                             a.ot);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (S > 1) {
    const int total = a.m * a.p;
    reduce_partials<COMP><<<(total + 255) / 256, 256, 0, a.stream>>>(
        a.partial, nullptr, S, a.m, a.p, a.p, a.add, a.addt, a.out, a.ot);
  }
  return cudaGetLastError();
}

// One build of B1 and B2 (X's type, compensation), behind plain functions
// that take the compiled width P (1 or 4): RT_SWEEP_VARIANT defines them in
// the source that builds the variant, RT_SWEEP_DECLARE declares them for
// kernel_matvec.cu's entry points.
#define RT_SWEEP_DECLARE(NAME)                                                \
  cudaError_t sweep_grid_##NAME(int P, int kind, int smem_bytes, int* grid); \
  cudaError_t fused_sweep_##NAME(int P, const SweepArgs& a);                 \
  cudaError_t matmul_slots_##NAME(int P, int kind, int d, int* smem_bytes, int* slots); \
  cudaError_t kernel_matmul_##NAME(int P, const MatmulArgs& a);

#define RT_SWEEP_VARIANT(NAME, TX, COMP)                                               \
  cudaError_t sweep_grid_##NAME(int P, int kind, int smem_bytes, int* grid) {          \
    return P == 1   ? sweep_grid_t<1, TX, COMP>(kind, smem_bytes, grid)                \
           : P == 4 ? sweep_grid_t<4, TX, COMP>(kind, smem_bytes, grid)                \
                    : cudaErrorInvalidValue;                                            \
  }                                                                                     \
  cudaError_t fused_sweep_##NAME(int P, const SweepArgs& a) {                          \
    return P == 1 ? sweep_t<1, TX, COMP>(a) : P == 4 ? sweep_t<4, TX, COMP>(a)          \
                                                     : cudaErrorInvalidValue;           \
  }                                                                                     \
  cudaError_t matmul_slots_##NAME(int P, int kind, int d, int* smem_bytes, int* slots) { \
    return P == 1   ? matmul_slots_t<1, TX, COMP>(kind, d, smem_bytes, slots)          \
           : P == 4 ? matmul_slots_t<4, TX, COMP>(kind, d, smem_bytes, slots)          \
                    : cudaErrorInvalidValue;                                            \
  }                                                                                     \
  cudaError_t kernel_matmul_##NAME(int P, const MatmulArgs& a) {                       \
    return P == 1 ? matmul_t<1, TX, COMP>(a) : P == 4 ? matmul_t<4, TX, COMP>(a)        \
                                                      : cudaErrorInvalidValue;          \
  }

RT_SWEEP_DECLARE(f32)
RT_SWEEP_DECLARE(f32c)
RT_SWEEP_DECLARE(bf16c)
RT_SWEEP_DECLARE(f16c)

}  // namespace rt
