"""Hand-written Hopper kernels for FALKON's O(nMt) hot loop, and their twins.

Counterpart of ``repro/kernels/kernel_matvec.py``. Four wrappers, each
beside its plain PyTorch twin:

* :func:`fused_sweep`     (B1) ``w = K(X,C)^T (K(X,C) u + v)`` — the CG sweep;
* :func:`kernel_matmul`   (B2) ``out = K(A,B) V + add``        — prediction;
* :func:`pairwise_kernel` (B3) ``K(A,B)`` materialized          — K_MM;
* :func:`sharded_sweep`   (B4) the sweep as B2 launches over C-shards, for
  M past the fused sweep's device workspace.

The kernels live in ``csrc/kernel_matvec.cu`` and ``csrc/tile.cuh`` (whose
header comments give each kernel's bound on the card and its design). A
wrapper launches its kernel for a CUDA tensor and takes the plain twin only
for a CPU tensor; there is no fallback from one to the other. Each wrapper
counts its kernel launches in its ``launches`` attribute.

The Hopper tiling is fixed: 64 x 64 Gram tiles (:func:`sweep_block_dims`).
The sweep evaluates every tile twice (forward pass, then transposed pass),
so its tile counter reads ``2 * nbi * nbj`` (:func:`sweep_tile_grid`) — the
TPU kernel's one-evaluation-per-tile property does not hold here. Only fp32
inputs are taken: bf16 storage and Kahan compensation are ROADMAP.md A7.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.kernels import KernelSpec, tile_eval

Tensor = torch.Tensor

BM = 64          # Gram tile rows (X / A side)
BN = 64          # Gram tile columns (C / B side)
DK = 32          # d-chunk staged through shared memory per round
TY = 16          # thread rows of a block (pass-2 reduction depth)
NT = 256         # threads of a Gram-tile block
MAX_P = 4        # widest right-hand side the sweep and matmul kernels take
_P_PADS = (1, 4)   # compiled widths; p is padded up to the next one
#: shared memory of one staged tile (csrc/tile.cuh ``TileSmem``)
TILE_SMEM_BYTES = 4 * (2 * DK * (BM + 1) + BM + BN)
#: the sweep keeps its w partial in shared memory while the block's total
#: stays under this, so that at least two blocks fit on an SM
W_SMEM_LIMIT = 100 * 1024
#: pairwise grid: columns of tiles run on gridDim.y (at most 65535)
_MAX_GRID_Y = 65535

#: kernel kind -> the code of csrc/tile.cuh ``Kind``
KIND_CODES = {"gaussian": 0, "laplacian": 1, "matern32": 2, "linear": 3, "polynomial": 4}

#: roadmap item of the reduced-precision path
_A7 = "ROADMAP.md item A7 (bf16 policy)"


def sweep_block_dims(n: int, M: int) -> tuple[int, int]:
    """(bm, bn) the CUDA sweep tiles with: fixed 64 x 64 for every shape."""
    del n, M
    return BM, BN


def sweep_tile_grid(n: int, M: int) -> tuple[int, int]:
    """(nbi, nbj) tile grid the sweep runs over; it evaluates each tile
    twice, so one sweep makes ``2 * nbi * nbj`` tile evaluations."""
    bm, bn = sweep_block_dims(n, M)
    return -(-n // bm), -(-M // bn)


def _pad_p(p: int) -> int:
    if not 1 <= p <= MAX_P:
        raise ValueError(
            f"the CUDA kernels take 1 to {MAX_P} right-hand-side columns, got "
            f"p={p}; split wider blocks into calls of at most {MAX_P}")
    return next(P for P in _P_PADS if P >= p)


def sweep_smem_bytes(M: int, p: int) -> tuple[int, bool]:
    """Dynamic shared memory of one sweep block and whether its w partial
    lives there (else in a per-block slice of global scratch)."""
    P = _pad_p(p)
    base = TILE_SMEM_BYTES + 4 * (BN * P + BM * P + TY * BN * P)
    with_w = base + 4 * M * P
    if with_w <= W_SMEM_LIMIT:
        return with_w, True
    return base, False


#: the card the sweep planner models: SMs, and resident threads and shared
#: memory of one SM (H100 SXM)
SMS = 132
SM_THREADS = 2048
SM_SMEM = 233_472
BLOCK_SMEM_RESERVED = 1024


def sweep_grid_model(M: int, p: int) -> int:
    """Persistent sweep blocks the planner charges for: SMs x the blocks one
    SM can hold by threads and shared memory. The launch queries the card's
    occupancy instead, which registers can only lower, so the model bounds
    the grid, and the w-partial workspace, from above."""
    smem, _ = sweep_smem_bytes(M, p)
    per_sm = min(SM_THREADS // NT, SM_SMEM // (smem + BLOCK_SMEM_RESERVED))
    return SMS * max(per_sm, 1)


def _kparams(spec: KernelSpec) -> tuple:
    """(kind code, sigma, coef, scale^2, c, degree) for the C entry points;
    the Python floats round to fp32 exactly where the reference's do."""
    if spec.kind not in KIND_CODES:
        raise ValueError(f"no CUDA kernel map for kernel kind {spec.kind!r}; "
                         f"have {sorted(KIND_CODES)}")
    p = spec.as_dict()
    sigma = float(p.get("sigma", 1.0))
    scale = float(p.get("scale", 1.0))
    degree = int(p.get("degree", 2))
    if degree < 0:
        raise ValueError(f"polynomial degree must be >= 0, got {degree}")
    return (KIND_CODES[spec.kind], sigma, -0.5 / (sigma * sigma), scale * scale,
            float(p.get("c", 1.0)), degree)


@functools.cache
def _lib():
    from repro_torch.kernels import build   # lazy: needs nvcc, only on the card
    lib = build.load()
    if lib.rt_tile_smem_bytes() != TILE_SMEM_BYTES:
        raise RuntimeError(
            f"csrc/tile.cuh TileSmem is {lib.rt_tile_smem_bytes()} bytes, "
            f"kernel_matvec.py assumes {TILE_SMEM_BYTES}")
    return lib


def _check(code: int, what: str) -> None:
    from repro_torch.kernels import build
    build.check(code, what)


@functools.cache
def _sweep_grid(P: int, smem: int, device_index: int) -> int:
    """Persistent sweep grid: resident blocks per SM x SMs (the caller holds
    the device context of ``device_index``)."""
    grid = ctypes.c_int(0)
    _check(_lib().rt_sweep_grid(P, smem, ctypes.byref(grid)), "sweep grid query")
    return grid.value


def _check_operands(what: str, device: torch.device, **tensors) -> None:
    """The kernels take contiguous fp32 tensors on one CUDA device."""
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise NotImplementedError(
                f"{what}: {name} is {t.dtype}; the CUDA kernels take float32 "
                f"only — reduced and double precision are {_A7}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _ptr(t: Tensor | None):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _route(what: str, *tensors: Tensor) -> str:
    """"cpu" -> plain twin, "cuda" -> kernel; anything else raises."""
    kind = tensors[0].device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel or plain path for device {kind!r}")
    for t in tensors[1:]:
        if t is not None and t.device.type != kind:
            raise ValueError(f"{what}: operands on {kind} and {t.device.type}")
    return kind


# ---------------------------------------------------------------------------
# B1 fused sweep: w = K(X, C)^T (K(X, C) u + v)
# ---------------------------------------------------------------------------
def fused_sweep_plain(X: Tensor, C: Tensor, u: Tensor, v: Tensor | None = None, *,
                      spec: KernelSpec, row_mask: Tensor | None = None,
                      block_rows: int = 2048) -> tuple[Tensor, Tensor]:
    """Plain twin of the sweep kernel, on the same two-evaluation schedule.

    ``u`` (M, p), ``v`` (n, p) or None. Row blocks are zero-padded to
    ``block_rows`` so every block contracts at one shape; ``t`` is zeroed on
    padded rows and multiplied by ``row_mask``, so masked rows contribute
    exactly 0. Returns ``(w, tile evaluations)``: every entry is evaluated
    twice, ``2 * nbi * nbj`` in 64 x 64 tile units.
    """
    n = X.shape[0]
    w = torch.zeros(C.shape[0], u.shape[1], dtype=X.dtype, device=X.device)
    for r0 in range(0, n, block_rows):
        rows = min(block_rows, n - r0)
        pad = block_rows - rows
        xb = torch.nn.functional.pad(X[r0:r0 + rows], (0, 0, 0, pad))
        keep = torch.zeros(block_rows, dtype=X.dtype, device=X.device)
        keep[:rows] = 1.0 if row_mask is None else row_mask[r0:r0 + rows].to(X.dtype)
        t = tile_eval(spec, xb, C) @ u                       # pass 1
        if v is not None:
            t = t + torch.nn.functional.pad(v[r0:r0 + rows], (0, 0, 0, pad))
        t = t * keep[:, None]
        w = w + tile_eval(spec, xb, C).T @ t                 # pass 2
    nbi, nbj = sweep_tile_grid(n, C.shape[0])
    return w, torch.tensor(2 * nbi * nbj, dtype=torch.int32)


def _fused_sweep_cuda(X, C, u, v, spec, row_mask):
    what = "fused_sweep"
    n, d = X.shape
    M = C.shape[0]
    p = u.shape[1]
    if C.shape[1] != d or u.shape[0] != M or (v is not None and v.shape != (n, p)):
        raise ValueError(f"{what}: shapes X {tuple(X.shape)}, C {tuple(C.shape)}, "
                         f"u {tuple(u.shape)}, v {None if v is None else tuple(v.shape)}")
    mask = None
    if row_mask is not None:
        if row_mask.shape != (n,):
            raise ValueError(f"{what}: row_mask shape {tuple(row_mask.shape)} != ({n},)")
        mask = row_mask.to(torch.float32).contiguous()
    if n == 0 or M == 0 or d == 0:
        raise ValueError(f"{what}: empty operand (n={n}, M={M}, d={d})")
    _check_operands(what, X.device, X=X, C=C, u=u, v=v, row_mask=mask)
    P = _pad_p(p)
    smem, w_in_smem = sweep_smem_bytes(M, p)
    w = torch.empty(M, p, dtype=torch.float32, device=X.device)
    counter = torch.zeros(1, dtype=torch.int32, device=X.device)
    nbi, _ = sweep_tile_grid(n, M)
    with torch.cuda.device(X.device):
        lib = _lib()
        grid = min(_sweep_grid(P, smem, X.device.index), nbi)
        partial = torch.empty(grid * M * P, dtype=torch.float32, device=X.device)
        code = lib.rt_fused_sweep(
            _ptr(X), _ptr(C), _ptr(u), _ptr(v), _ptr(mask), n, M, d, p,
            *_kparams(spec), P, int(w_in_smem), smem, grid,
            _ptr(partial), _ptr(w), _ptr(counter), _stream(X.device))
        _check(code, what)
        fused_sweep.launches += 1
    return w, counter[0]


def fused_sweep(X: Tensor, C: Tensor, u: Tensor, v: Tensor | None = None, *,
                spec: KernelSpec, row_mask: Tensor | None = None,
                return_tile_count: bool = False):
    """w = K(X,C)^T (K(X,C) u + v) — the whole CG sweep in one launch.

    X: (n, d), C: (M, d), u: (M,) or (M, p), v like u's rows over n or None
    -> w like u. ``row_mask`` (n,), 0/1: rows with mask 0 contribute EXACTLY
    zero (their t_i is zeroed before the transposed product). With
    ``return_tile_count=True`` also returns the int32 count of 64 x 64 Gram
    tiles evaluated: ``2 * nbi * nbj``.
    """
    squeeze = u.ndim == 1
    u2 = u[:, None] if squeeze else u
    v2 = None if v is None else (v[:, None] if squeeze else v)
    if _route("fused_sweep", X, C, u2, v2, row_mask) == "cpu":
        w, count = fused_sweep_plain(X, C, u2, v2, spec=spec, row_mask=row_mask)
    else:
        w, count = _fused_sweep_cuda(X, C, u2, v2, spec, row_mask)
    w = w[:, 0] if squeeze else w
    return (w, count) if return_tile_count else w


fused_sweep.launches = 0


# ---------------------------------------------------------------------------
# B2 kernel matmul: out = K(A, B) V + add
# ---------------------------------------------------------------------------
def kernel_matmul_plain(A: Tensor, B: Tensor, V: Tensor, add: Tensor | None = None, *,
                        spec: KernelSpec, block_rows: int = 2048) -> Tensor:
    """Plain twin of the kernel matmul: ``V`` (n, p), ``add`` (m, p) or None."""
    out = torch.cat([tile_eval(spec, A[r:r + block_rows], B) @ V
                     for r in range(0, A.shape[0], block_rows)], dim=0)
    return out if add is None else out + add


def _kernel_matmul_cuda(A, B, V, add, spec):
    what = "kernel_matmul"
    m, d = A.shape
    n = B.shape[0]
    p = V.shape[1]
    if B.shape[1] != d or V.shape[0] != n or (add is not None and add.shape != (m, p)):
        raise ValueError(f"{what}: shapes A {tuple(A.shape)}, B {tuple(B.shape)}, "
                         f"V {tuple(V.shape)}, add {None if add is None else tuple(add.shape)}")
    if m == 0 or n == 0 or d == 0:
        raise ValueError(f"{what}: empty operand (m={m}, n={n}, d={d})")
    _check_operands(what, A.device, A=A, B=B, V=V, add=add)
    P = _pad_p(p)
    out = torch.empty(m, p, dtype=torch.float32, device=A.device)
    with torch.cuda.device(A.device):
        code = _lib().rt_kernel_matmul(
            _ptr(A), _ptr(B), _ptr(V), _ptr(add), m, n, d, p, *_kparams(spec), P,
            _ptr(out), _stream(A.device))
        _check(code, what)
        kernel_matmul.launches += 1
    return out


def kernel_matmul(A: Tensor, B: Tensor, V: Tensor, add: Tensor | None = None, *,
                  spec: KernelSpec, out_dtype: torch.dtype | None = None) -> Tensor:
    """out = K(A, B) V (+ add) with Gram tiles that never leave the chip.

    A: (m, d), B: (n, d), V: (n,) or (n, p), add like the output or None.
    ``out_dtype`` is float32 (or None); other output types are ROADMAP A7.
    """
    if out_dtype not in (None, torch.float32):
        raise NotImplementedError(f"kernel_matmul out_dtype={out_dtype}: {_A7}")
    squeeze = V.ndim == 1
    V2 = V[:, None] if squeeze else V
    add2 = None if add is None else (add[:, None] if squeeze else add)
    if _route("kernel_matmul", A, B, V2, add2) == "cpu":
        out = kernel_matmul_plain(A, B, V2, add2, spec=spec)
    else:
        out = _kernel_matmul_cuda(A, B, V2, add2, spec)
    return out[:, 0] if squeeze else out


kernel_matmul.launches = 0


# ---------------------------------------------------------------------------
# B3 pairwise kernel: K(A, B) materialized
# ---------------------------------------------------------------------------
def pairwise_kernel_plain(A: Tensor, B: Tensor, *, spec: KernelSpec) -> Tensor:
    """Plain twin of the pairwise Gram."""
    return tile_eval(spec, A, B)


def _pairwise_kernel_cuda(A, B, spec):
    what = "pairwise_kernel"
    m, d = A.shape
    n = B.shape[0]
    if B.shape[1] != d:
        raise ValueError(f"{what}: shapes A {tuple(A.shape)}, B {tuple(B.shape)}")
    if m == 0 or n == 0 or d == 0:
        raise ValueError(f"{what}: empty operand (m={m}, n={n}, d={d})")
    if -(-n // BN) > _MAX_GRID_Y:
        raise ValueError(f"{what}: B has {n} rows; the grid takes at most "
                         f"{_MAX_GRID_Y * BN}")
    _check_operands(what, A.device, A=A, B=B)
    out = torch.empty(m, n, dtype=torch.float32, device=A.device)
    with torch.cuda.device(A.device):
        code = _lib().rt_pairwise(_ptr(A), _ptr(B), m, n, d, *_kparams(spec),
                                  _ptr(out), _stream(A.device))
        _check(code, what)
        pairwise_kernel.launches += 1
    return out


def pairwise_kernel(A: Tensor, B: Tensor, *, spec: KernelSpec) -> Tensor:
    """K(A, B) materialized tile by tile (the preconditioner's K_MM)."""
    if _route("pairwise_kernel", A, B) == "cpu":
        return pairwise_kernel_plain(A, B, spec=spec)
    return _pairwise_kernel_cuda(A, B, spec)


pairwise_kernel.launches = 0

# ---------------------------------------------------------------------------
# B4 j-sharded sweep: w = K(X, C)^T (K(X, C) u + v) as B2 launches
# ---------------------------------------------------------------------------
#: rows of X per B2 launch in the sharded sweep's transposed pass. B2 sums
#: its B rows in one fp32 chain per lane, which at n = 4.6x10^5 rounds more
#: than B1: on an H100 (tools/sweep_rounding.py, three draws) one chain
#: stood 1.51e-6, 6.92e-7 and 6.53e-7 from a float64 sweep, normwise,
#: 65536-row chunks chained through ``add=`` 1.38e-6, 3.21e-7 and 2.03e-7
#: (B1 1.42e-6, 4.52e-7 and 3.86e-7).
SHARD_ROW_CHUNK = 65_536


def _transposed_pass(matmul, C: Tensor, X: Tensor, t: Tensor, shard: int, **kw) -> Tensor:
    """w = K(C, X) t, one shard of C rows at a time, each summed over X in
    ``SHARD_ROW_CHUNK``-row chunks chained through ``add=``."""
    ws = []
    for j0 in range(0, C.shape[0], shard):
        w = None
        for r0 in range(0, X.shape[0], SHARD_ROW_CHUNK):
            r1 = r0 + SHARD_ROW_CHUNK
            w = matmul(C[j0:j0 + shard], X[r0:r1], t[r0:r1], w, **kw)
        ws.append(w)
    return torch.cat(ws, dim=0)


def sharded_sweep_plain(X: Tensor, C: Tensor, u: Tensor, v: Tensor | None = None, *,
                        spec: KernelSpec, row_mask: Tensor | None = None,
                        shard_m: int) -> Tensor:
    """Plain twin of the sharded sweep: the same composition over the plain
    twin of B2. ``u`` (M, p), ``v`` (n, p) or None."""
    t = kernel_matmul_plain(X, C, u, v, spec=spec)
    if row_mask is not None:
        t = t * row_mask.to(t.dtype)[:, None]
    return _transposed_pass(kernel_matmul_plain, C, X, t, shard_m, spec=spec)


def sharded_sweep(X: Tensor, C: Tensor, u: Tensor, v: Tensor | None = None, *,
                  spec: KernelSpec, row_mask: Tensor | None = None, shard_m: int = 8192,
                  t_dtype: torch.dtype | None = None,
                  out_dtype: torch.dtype | None = None) -> Tensor:
    """w = K(X,C)^T (K(X,C) u + v) for M past the fused sweep's workspace.

    The out-of-core schedule of the reference's ``sharded_sweep_pallas``,
    built from B2: ``t = kernel_matmul(X, C, u, add=v)`` spills (n, p) to
    device memory, rows with ``row_mask == 0`` are multiplied to exactly 0,
    then ``kernel_matmul(C_j, X, t)`` per ``shard_m`` rows of C (over X in
    ``SHARD_ROW_CHUNK``-row chunks chained through ``add=``), and the shards
    are concatenated. Each Gram entry is evaluated twice. This wrapper
    counts one launch per call on a CUDA tensor, and each B2 launch inside
    it counts on ``kernel_matmul``'s counter too. Only float32 ``t_dtype`` /
    ``out_dtype`` (or None) are taken: the others are ROADMAP A7.
    """
    for name, dt in (("t_dtype", t_dtype), ("out_dtype", out_dtype)):
        if dt not in (None, torch.float32):
            raise NotImplementedError(f"sharded_sweep {name}={dt}: {_A7}")
    shard = max(int(shard_m), 1)
    squeeze = u.ndim == 1
    u2 = u[:, None] if squeeze else u
    v2 = None if v is None else (v[:, None] if squeeze else v)
    if _route("sharded_sweep", X, C, u2, v2, row_mask) == "cpu":
        w = sharded_sweep_plain(X, C, u2, v2, spec=spec, row_mask=row_mask, shard_m=shard)
    else:
        t = kernel_matmul(X, C, u2, v2, spec=spec)
        if row_mask is not None:
            if row_mask.shape != (X.shape[0],):
                raise ValueError(f"sharded_sweep: row_mask shape {tuple(row_mask.shape)} "
                                 f"!= ({X.shape[0]},)")
            t = t * row_mask.to(t.dtype)[:, None]
        w = _transposed_pass(kernel_matmul, C, X, t, shard, spec=spec)
        sharded_sweep.launches += 1
    return w[:, 0] if squeeze else w


sharded_sweep.launches = 0

WRAPPERS = (fused_sweep, sharded_sweep, kernel_matmul, pairwise_kernel)


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset: B1-B4 here and the
    blocked Cholesky's B5-B7."""
    from . import blocked_cholesky
    return {**{fn.__name__: fn.launches for fn in WRAPPERS},
            **blocked_cholesky.launch_counts()}


def reset_launch_counts() -> None:
    from . import blocked_cholesky
    for fn in WRAPPERS:
        fn.launches = 0
    blocked_cholesky.reset_launch_counts()
