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
//     tile twice. A persistent grid of G blocks (occupancy x 132 SMs) walks
//     the row blocks i. Pass 1 evaluates K_ij for every center tile j and
//     accumulates t_i = K_i u in registers (one 16-lane shuffle reduction
//     per row block, not per tile), then adds v_i and zeroes padded and
//     row_mask == 0 rows, which is what makes masked rows contribute exactly
//     0. Pass 2 evaluates K_ij again and accumulates K_ij^T t_i into the
//     block's own w partial: in shared memory when M*P floats fit, else in
//     the block's slice of a global scratch. reduce_partials then sums the
//     G partials in a fixed order: the result is deterministic, with no
//     float atomics. The one atomic is the integer tile-evaluation counter,
//     which reports 2 * nbi * nbj.
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

// Pass 1 of B1 and the whole of B2: t[i][c] = sum_j K(A_row, B_j) V[j][c]
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

// Shared-memory floats of B1 beyond TileSmem: u tile, t_i, the pass-2
// reduction buffer and (optionally) the w partial. Mirrored by
// repro_torch.kernels.kernel_matvec.sweep_smem_bytes.
template <int P>
__host__ __device__ constexpr size_t sweep_extra_floats() {
  return (size_t)BN * P + (size_t)BM * P + (size_t)TY * BN * P;
}

template <int P>
__global__ void __launch_bounds__(NT)
    fused_sweep_kernel(const float* __restrict__ X, const float* __restrict__ C,
                       const float* __restrict__ u, const float* __restrict__ v,
                       const float* __restrict__ mask, int n, int M, int d, int p, KParams kp,
                       int w_in_smem, float* __restrict__ partial, int* __restrict__ counter) {
  extern __shared__ float4 smem4[];
  TileSmem& s = *reinterpret_cast<TileSmem*>(smem4);
  float* us = reinterpret_cast<float*>(&s + 1);
  float* ts = us + BN * P;
  float* red = ts + BM * P;
  float* wsm = red + TY * BN * P;
  float* gpart = partial + (size_t)blockIdx.x * M * P;
  float* wpart = w_in_smem ? wsm : gpart;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  for (int e = tid; e < M * P; e += NT) wpart[e] = 0.0f;  // read after a barrier

  const int nbi = (n + BM - 1) / BM;
  const int nbj = (M + BN - 1) / BN;
  int evals = 0;
  for (int bi = blockIdx.x; bi < nbi; bi += gridDim.x) {
    const int r0 = bi * BM;
    // pass 1: t_i = K_i u + v_i, padded and masked rows zeroed
    float t[TM][P];
    forward_rows<P>(X, n, C, M, d, u, p, r0, s, us, kp, t, evals);
    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int row = r0 + ty + TY * i;
#pragma unroll
        for (int c = 0; c < P; ++c) {
          float tv = t[i][c];
          if (row < n && c < p) {
            if (v != nullptr) tv += v[(size_t)row * p + c];
            if (mask != nullptr) tv *= mask[row];
          } else {
            tv = 0.0f;
          }
          ts[(ty + TY * i) * P + c] = tv;  // read after eval_tile's barrier
        }
      }
    }
    // pass 2: w_j += K_ij^T t_i, K_ij evaluated again
    for (int bj = 0; bj < nbj; ++bj) {
      const int c0 = bj * BN;
      float k[TM][TN];
      eval_tile(X, n, C, M, d, r0, c0, s, kp, k);
      ++evals;
#pragma unroll
      for (int j = 0; j < TN; ++j)
#pragma unroll
        for (int c = 0; c < P; ++c) {
          float acc = 0.0f;
#pragma unroll
          for (int i = 0; i < TM; ++i) acc = fmaf(k[i][j], ts[(ty + TY * i) * P + c], acc);
          red[(ty * BN + tx + TX * j) * P + c] = acc;
        }
      __syncthreads();
      // fixed-order sum over the TY row groups: deterministic
      for (int o = tid; o < BN * P; o += NT) {
        if (c0 + o / P < M) {
          float sum = 0.0f;
#pragma unroll
          for (int y = 0; y < TY; ++y) sum += red[y * BN * P + o];
          wpart[(size_t)c0 * P + o] += sum;
        }
      }
    }
  }
  __syncthreads();
  if (w_in_smem) {
    for (int e = tid; e < M * P; e += NT) gpart[e] = wsm[e];
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

template <int P>
static cudaError_t set_sweep_smem(int smem_bytes) {
  return cudaFuncSetAttribute(fused_sweep_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
}

template <int P>
static cudaError_t sweep_grid_t(int smem_bytes, int* grid) {
  cudaError_t err = set_sweep_smem<P>(smem_bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, occ = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fused_sweep_kernel<P>, NT, smem_bytes);
  if (err != cudaSuccess) return err;
  *grid = (occ > 0 ? occ : 1) * sms;
  return cudaSuccess;
}

template <int P>
static cudaError_t sweep_t(const float* X, const float* C, const float* u, const float* v,
                           const float* mask, int n, int M, int d, int p, KParams kp,
                           int w_in_smem, int smem_bytes, int grid, float* partial, float* w,
                           int* counter, cudaStream_t stream) {
  const size_t need = sizeof(TileSmem) +
                      sizeof(float) * (sweep_extra_floats<P>() + (w_in_smem ? (size_t)M * P : 0));
  if ((size_t)smem_bytes < need) return cudaErrorInvalidValue;
  cudaError_t err = set_sweep_smem<P>(smem_bytes);
  if (err != cudaSuccess) return err;
  fused_sweep_kernel<P><<<grid, NT, smem_bytes, stream>>>(X, C, u, v, mask, n, M, d, p, kp,
                                                          w_in_smem, partial, counter);
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

int rt_sweep_grid(int P, int smem_bytes, int* grid) {
  switch (P) {
    case 1: return (int)rt::sweep_grid_t<1>(smem_bytes, grid);
    case 4: return (int)rt::sweep_grid_t<4>(smem_bytes, grid);
    default: return (int)cudaErrorInvalidValue;
  }
}

int rt_fused_sweep(const void* X, const void* C, const void* u, const void* v, const void* mask,
                   int n, int M, int d, int p, int kind, float sigma, float coef, float ss,
                   float c, int degree, int P, int w_in_smem, int smem_bytes, int grid,
                   void* partial, void* w, void* counter, void* stream) {
  const KParams kp = rt::kparams(kind, sigma, coef, ss, c, degree);
  const float* Xf = static_cast<const float*>(X);
  const float* Cf = static_cast<const float*>(C);
  const float* uf = static_cast<const float*>(u);
  const float* vf = static_cast<const float*>(v);
  const float* mf = static_cast<const float*>(mask);
  float* pf = static_cast<float*>(partial);
  float* wf = static_cast<float*>(w);
  int* cnt = static_cast<int*>(counter);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 1: return (int)rt::sweep_t<1>(Xf, Cf, uf, vf, mf, n, M, d, p, kp, w_in_smem, smem_bytes, grid, pf, wf, cnt, st);
    case 4: return (int)rt::sweep_t<4>(Xf, Cf, uf, vf, mf, n, M, d, p, kp, w_in_smem, smem_bytes, grid, pf, wf, cnt, st);
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
