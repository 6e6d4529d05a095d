"""Hand-written Hopper kernels for FALKON's O(nMt) hot loop, and their twins.

Counterpart of ``repro/kernels/kernel_matvec.py``. Four wrappers, each
beside its plain PyTorch twin:

* :func:`fused_sweep`     (B1) ``w = K(X,C)^T (K(X,C) u + v)`` — the CG sweep;
* :func:`kernel_matmul`   (B2) ``out = K(A,B) V + add``        — prediction;
* :func:`pairwise_kernel` (B3) ``K(A,B)`` materialized          — K_MM;
* :func:`sharded_sweep`   (B4) the sweep as B2 launches over C-shards, for
  M past the fused sweep's device workspace.

The kernels live in ``csrc/kernel_matvec.cu`` (whose header comment gives
each kernel's bound on the card and its design) and the kernel map in
``csrc/tile.cuh``. A
wrapper launches its kernel for a CUDA tensor and takes the plain twin only
for a CPU tensor; there is no fallback from one to the other. Each wrapper
counts its kernel launches in its ``launches`` attribute. The kernels take
1 to MAX_P = 4 right-hand-side columns (compiled widths 1 and 4); the
wrappers of B1, B2 and B4 take any p and run its columns in groups of at
most 4 (:func:`column_groups`), one launch each, on the CPU as on the card.

The sweep (B1) has its own tiling: 128-row blocks of X against 128-center
tiles (:func:`sweep_block_dims`), an 8 x 8 register micro-tile a thread,
the X block resident in shared memory and the centers streamed through a
cp.async ring of 32-deep k-chunks (:func:`sweep_smem_bytes`). It evaluates
every tile twice (forward pass, then transposed pass), so its tile counter
reads ``2 * nbi * nbj`` in 128 x 128 tiles (:func:`sweep_tile_grid`) — the
TPU kernel's one-evaluation-per-tile property does not hold here. The
kernel matmul (B2) is the sweep's pass 1 alone on the same tile code, over
an (A row blocks, slices of B) grid (:func:`matmul_slices`,
:func:`matmul_smem_bytes`). The pairwise Gram (B3) is the same evaluation
alone, stored: a persistent grid splits the output tiles into balanced
contiguous ranges (:func:`pairwise_range`), and K(C, C) of one tensor takes
a symmetric route that evaluates the upper triangle of tiles and stores each
off-diagonal tile twice (:func:`pairwise_symmetric`).
Only fp32 inputs are taken: bf16 storage and Kahan compensation are
ROADMAP.md A7.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.kernels import KernelSpec, tile_eval

Tensor = torch.Tensor

NT = 256         # threads of a Gram-tile block (B1, B2 and B3)
MAX_P = 4        # widest right-hand side one kernel launch takes
_P_PADS = (1, 4)   # compiled widths; p is padded up to the next one
#: the sweep's tiling (csrc/kernel_matvec.cu ``SW_*``): 128-row blocks of
#: X, 128-center tiles, 32-deep k-chunks of C in its ring, X resident up to
#: d = 128 (deeper X is staged again per tile in 128-deep chunks)
SWEEP_BM = 128
SWEEP_BN = 128
SWEEP_KC = 32
SWEEP_XK = 128
SWEEP_LDX = SWEEP_BM + 4
#: most slices of B's tiles one kernel-matmul launch splits into
#: (csrc/kernel_matvec.cu ``MM_MAX_SLICES``)
MM_MAX_SLICES = 16
#: the sweep keeps its w partial in shared memory while the block's total
#: stays under this, so that at least two blocks fit on an SM
W_SMEM_LIMIT = 100 * 1024

#: kernel kind -> the code of csrc/tile.cuh ``Kind``
KIND_CODES = {"gaussian": 0, "laplacian": 1, "matern32": 2, "linear": 3, "polynomial": 4}

#: roadmap item of the reduced-precision path
_A7 = "ROADMAP.md item A7 (bf16 policy)"


def sweep_block_dims(n: int, M: int) -> tuple[int, int]:
    """(bm, bn) the CUDA sweep tiles with: fixed 128 x 128 for every shape."""
    del n, M
    return SWEEP_BM, SWEEP_BN


def sweep_tile_grid(n: int, M: int) -> tuple[int, int]:
    """(nbi, nbj) tile grid the sweep runs over; it evaluates each tile
    twice, so one sweep makes ``2 * nbi * nbj`` tile evaluations."""
    bm, bn = sweep_block_dims(n, M)
    return -(-n // bm), -(-M // bn)


def _pad_p(p: int) -> int:
    """The compiled width one launch runs ``p`` columns at (the kernel-level
    contract: 1 to MAX_P columns; the wrappers split wider blocks)."""
    if not 1 <= p <= MAX_P:
        raise ValueError(
            f"the CUDA kernels take 1 to {MAX_P} right-hand-side columns, got "
            f"p={p}; split wider blocks into calls of at most {MAX_P}")
    return next(P for P in _P_PADS if P >= p)


def column_groups(p: int) -> list[slice]:
    """The column groups a p-column right-hand side runs in: consecutive
    slices of at most MAX_P columns, one launch each (one group for p <= 4)."""
    if p < 1:
        raise ValueError(f"a right-hand side needs at least one column, got p={p}")
    return [slice(c, min(c + MAX_P, p)) for c in range(0, p, MAX_P)]


def _group(t: Tensor | None, g: slice, p: int) -> Tensor | None:
    """Columns ``g`` of a (rows, p) operand; the whole tensor when ``g``
    spans it, so that p <= MAX_P passes its operand through untouched."""
    if t is None or (g.start == 0 and g.stop == p):
        return t
    return t[:, g].contiguous()


def sweep_smem_bytes(M: int, p: int, d: int) -> tuple[int, bool]:
    """Dynamic shared memory of one sweep block and whether its w partial
    lives there (else in a per-block slice of global scratch). Mirrors
    ``sweep_smem_floats`` of csrc/kernel_matvec.cu: the C ring (2 chunks of
    min(d, 32) k-rows), the extras ring (||c||^2 and u of 2 tiles), the X
    block (min(d, 128) k-rows, padded), t, the cross-warp reduction buffer,
    the row norms and, when it fits, the w partial."""
    P = _pad_p(p)
    cr, xr = min(d, SWEEP_KC), min(d, SWEEP_XK)
    base = 4 * (2 * cr * SWEEP_BN + 2 * (1 + P) * SWEEP_BN + xr * SWEEP_LDX
                + P * SWEEP_BM + 4 * P * SWEEP_BN + SWEEP_BM)
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


def sweep_grid_model(M: int, p: int, d: int) -> int:
    """Persistent sweep blocks the planner charges for: SMs x the blocks one
    SM can hold by threads and shared memory. The launch queries the card's
    occupancy instead, which registers can only lower, so the model bounds
    the grid, and the w-partial workspace, from above."""
    smem, _ = sweep_smem_bytes(M, p, d)
    per_sm = min(SM_THREADS // NT, SM_SMEM // (smem + BLOCK_SMEM_RESERVED))
    return SMS * max(per_sm, 1)


def matmul_smem_bytes(p: int, d: int) -> int:
    """Dynamic shared memory of one kernel-matmul (B2) block. Mirrors
    ``matmul_smem_floats`` of csrc/kernel_matvec.cu: the sweep's ring, extras
    ring and A block (as :func:`sweep_smem_bytes`), t's cross-warp buffer
    and the row norms; no w partial."""
    P = _pad_p(p)
    cr, xr = min(d, SWEEP_KC), min(d, SWEEP_XK)
    return 4 * (2 * cr * SWEEP_BN + 2 * (1 + P) * SWEEP_BN + xr * SWEEP_LDX
                + P * SWEEP_BM + SWEEP_BM)


#: resident B2 blocks an SM by registers: its launch bounds ask for 2 blocks
#: of 256 threads at P = 1 (<= 128 registers a thread) and 1 at P = 4
_MATMUL_REG_BLOCKS = {1: 2, 4: 1}


def matmul_grid_model(p: int, d: int) -> int:
    """Resident kernel-matmul blocks on the modelled card: SMs x the blocks
    one SM holds by threads, shared memory and the launch bounds' registers.
    The launch asks the card (``rt_matmul_slots``); ``chip_smoke.py`` holds
    the two equal."""
    smem = matmul_smem_bytes(p, d)
    per_sm = min(SM_THREADS // NT, SM_SMEM // (smem + BLOCK_SMEM_RESERVED),
                 _MATMUL_REG_BLOCKS[_pad_p(p)])
    return SMS * max(per_sm, 1)


def matmul_slices(m: int, n: int, slots: int) -> int:
    """Slices S of B's 128-row tiles that one kernel-matmul launch runs on
    ``slots`` resident blocks: the S <= min(nbj, MM_MAX_SLICES) with the
    fewest waves x (tiles a slice + 1), ties to the smaller S. Mirrors
    ``matmul_slices`` of csrc/kernel_matvec.cu, which decides it."""
    nbi, nbj = -(-m // SWEEP_BM), -(-n // SWEEP_BN)
    costs = [(-(-nbi * S // slots) * (-(-nbj // S) + 1), S)
             for S in range(1, min(nbj, MM_MAX_SLICES) + 1)]
    return min(costs)[1]


def matmul_slice_bounds(n: int, slices: int) -> list[tuple[int, int]]:
    """B rows [b0, b1) of each slice: slice s takes tiles s*nbj//S to
    (s+1)*nbj//S - 1, as the kernel's block (i, s) does."""
    nbj = -(-n // SWEEP_BN)
    return [(s * nbj // slices * SWEEP_BN, min((s + 1) * nbj // slices * SWEEP_BN, n))
            for s in range(slices)]


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


def _lib():
    from repro_torch.kernels import build   # lazy: needs nvcc, only on the card
    return build.load()


def _check(code: int, what: str) -> None:
    from repro_torch.kernels import build
    build.check(code, what)


@functools.cache
def _sweep_grid(P: int, kind: int, smem: int, device_index: int) -> int:
    """Persistent sweep grid: resident blocks per SM x SMs of B1's
    instantiation for (P, kernel kind code) (the caller holds the device
    context of ``device_index``)."""
    grid = ctypes.c_int(0)
    _check(_lib().rt_sweep_grid(P, kind, smem, ctypes.byref(grid)), "sweep grid query")
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
    twice, ``2 * nbi * nbj`` in the kernel's 128 x 128 tile units.
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


def _fused_sweep_cuda(X, C, u, v, *, spec, row_mask):
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
    smem, w_in_smem = sweep_smem_bytes(M, p, d)
    w = torch.empty(M, p, dtype=torch.float32, device=X.device)
    counter = torch.zeros(1, dtype=torch.int32, device=X.device)
    nbi, nbj = sweep_tile_grid(n, M)
    # the prologue's centers: per 128-center tile, C k-major, ||c||^2, u
    packed = torch.empty(nbj * (d + 1 + P) * SWEEP_BN, dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        lib = _lib()
        kp = _kparams(spec)
        grid = min(_sweep_grid(P, kp[0], smem, X.device.index), nbi)
        partial = torch.empty(grid * M * P, dtype=torch.float32, device=X.device)
        code = lib.rt_fused_sweep(
            _ptr(X), _ptr(C), _ptr(u), _ptr(v), _ptr(mask), n, M, d, p,
            *kp, P, int(w_in_smem), smem, grid,
            _ptr(packed), _ptr(partial), _ptr(w), _ptr(counter), _stream(X.device))
        _check(code, what)
        fused_sweep.launches += 1
    return w, counter[0]


def fused_sweep(X: Tensor, C: Tensor, u: Tensor, v: Tensor | None = None, *,
                spec: KernelSpec, row_mask: Tensor | None = None,
                return_tile_count: bool = False):
    """w = K(X,C)^T (K(X,C) u + v) — the whole CG sweep in one launch per
    column group.

    X: (n, d), C: (M, d), u: (M,) or (M, p), v like u's rows over n or None
    -> w like u. Any p >= 1: the columns run in groups of at most MAX_P
    (:func:`column_groups`), one launch (or, on the CPU, one twin call)
    each. ``row_mask`` (n,), 0/1: rows with mask 0 contribute EXACTLY zero
    (their t_i is zeroed before the transposed product). With
    ``return_tile_count=True`` also returns the int32 count of Gram tiles
    evaluated, summed over the groups: ``groups * 2 * nbi * nbj``.
    """
    squeeze = u.ndim == 1
    u2 = u[:, None] if squeeze else u
    v2 = None if v is None else (v[:, None] if squeeze else v)
    p = u2.shape[1]
    sweep = (fused_sweep_plain if _route("fused_sweep", X, C, u2, v2, row_mask) == "cpu"
             else _fused_sweep_cuda)
    ws, count = [], 0
    for g in column_groups(p):
        w, c = sweep(X, C, _group(u2, g, p), _group(v2, g, p), spec=spec, row_mask=row_mask)
        ws.append(w)
        count = count + c
    w = ws[0] if len(ws) == 1 else torch.cat(ws, dim=1)
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


def kernel_matmul_sliced_plain(A: Tensor, B: Tensor, V: Tensor, add: Tensor | None = None, *,
                               spec: KernelSpec, slices: int) -> Tensor:
    """The kernel's split schedule in plain PyTorch, for the tests: B's rows
    in ``slices`` contiguous slices of 128-row tiles
    (:func:`matmul_slice_bounds`), each slice's K(A, B_s) V_s summed in
    slice order, then ``add``."""
    out = None
    for b0, b1 in matmul_slice_bounds(B.shape[0], slices):
        part = kernel_matmul_plain(A, B[b0:b1], V[b0:b1], spec=spec)
        out = part if out is None else out + part
    return out if add is None else out + add


@functools.cache
def _matmul_slots(P: int, kind: int, d: int, device_index: int) -> tuple[int, int]:
    """(shared memory bytes, resident blocks on the card) of B2's
    instantiation for (P, kernel kind code) at depth d (the caller holds
    the device context of ``device_index``)."""
    smem, slots = ctypes.c_int(0), ctypes.c_int(0)
    _check(_lib().rt_matmul_slots(P, kind, d, ctypes.byref(smem), ctypes.byref(slots)),
           "kernel matmul slots query")
    return smem.value, slots.value


def _kernel_matmul_cuda(A, B, V, add, *, spec, slots=None):
    """One B2 launch. ``slots`` stands in for the card's resident blocks in
    the split rule (the checks force S = 1 with 1, and the most slices with
    a large count)."""
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
    # the prologue's B: per 128-row tile, B k-major, ||b||^2, V
    packed = torch.empty(-(-n // SWEEP_BN) * (d + 1 + P) * SWEEP_BN, dtype=torch.float32,
                         device=A.device)
    with torch.cuda.device(A.device):
        lib = _lib()
        kp = _kparams(spec)
        if slots is None:
            slots = _matmul_slots(P, kp[0], d, A.device.index)[1]
        S = lib.rt_matmul_slices(m, n, slots)
        partial = (torch.empty(S * m * p, dtype=torch.float32, device=A.device)
                   if S > 1 else None)
        code = lib.rt_kernel_matmul(
            _ptr(A), _ptr(B), _ptr(V), _ptr(add), m, n, d, p, *kp, P, slots,
            _ptr(packed), _ptr(partial), _ptr(out), _stream(A.device))
        _check(code, what)
        kernel_matmul.launches += 1
    return out


def kernel_matmul(A: Tensor, B: Tensor, V: Tensor, add: Tensor | None = None, *,
                  spec: KernelSpec, out_dtype: torch.dtype | None = None) -> Tensor:
    """out = K(A, B) V (+ add) with Gram tiles that never leave the chip.

    A: (m, d), B: (n, d), V: (n,) or (n, p), add like the output or None.
    Any p >= 1, in groups of at most MAX_P columns, one launch each.
    ``out_dtype`` is float32 (or None); other output types are ROADMAP A7.
    """
    if out_dtype not in (None, torch.float32):
        raise NotImplementedError(f"kernel_matmul out_dtype={out_dtype}: {_A7}")
    squeeze = V.ndim == 1
    V2 = V[:, None] if squeeze else V
    add2 = None if add is None else (add[:, None] if squeeze else add)
    p = V2.shape[1]
    matmul = (kernel_matmul_plain if _route("kernel_matmul", A, B, V2, add2) == "cpu"
              else _kernel_matmul_cuda)
    outs = [matmul(A, B, _group(V2, g, p), _group(add2, g, p), spec=spec)
            for g in column_groups(p)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out[:, 0] if squeeze else out


kernel_matmul.launches = 0


# ---------------------------------------------------------------------------
# B3 pairwise kernel: K(A, B) materialized
# ---------------------------------------------------------------------------
def pairwise_kernel_plain(A: Tensor, B: Tensor, *, spec: KernelSpec) -> Tensor:
    """Plain twin of the pairwise Gram."""
    return tile_eval(spec, A, B)


def pairwise_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one pairwise (B3) block. Mirrors
    ``pairwise_smem_floats`` of csrc/kernel_matvec.cu: the sweep's ring, an
    extras ring of ||b||^2 and u (B is packed at P = 1 with u = 0), the A
    block (as :func:`sweep_smem_bytes`) and its row norms."""
    cr, xr = min(d, SWEEP_KC), min(d, SWEEP_XK)
    return 4 * (2 * cr * SWEEP_BN + 2 * 2 * SWEEP_BN + xr * SWEEP_LDX + SWEEP_BM)


def pairwise_grid_model(d: int) -> int:
    """Resident pairwise blocks on the modelled card: SMs x the blocks one SM
    holds by threads, shared memory and the launch bounds' 2 blocks (<= 128
    registers a thread). The launch asks the card (``rt_pairwise_slots``);
    ``chip_smoke.py`` holds the two equal."""
    per_sm = min(SM_THREADS // NT, SM_SMEM // (pairwise_smem_bytes(d) + BLOCK_SMEM_RESERVED), 2)
    return SMS * max(per_sm, 1)


def pairwise_symmetric(A: Tensor, B: Tensor) -> bool:
    """Whether K(A, B) takes the symmetric route: A and B are one storage
    (same data pointer, shape and strides), so K is symmetric bit for bit."""
    return (A.data_ptr() == B.data_ptr() and A.shape == B.shape
            and A.stride() == B.stride())


def pairwise_tiles(m: int, n: int, sym: bool) -> int:
    """Output tiles B3 evaluates: all nbi x nbj 128 x 128 tiles, or the
    nbi (nbi + 1) / 2 of the upper triangle on the symmetric route."""
    nbi, nbj = -(-m // SWEEP_BM), -(-n // SWEEP_BN)
    return nbi * (nbi + 1) // 2 if sym else nbi * nbj


def pairwise_range(m: int, n: int, sym: bool, G: int, b: int) -> tuple[int, int, int, int]:
    """(t0, t1, bi, bj): block b's output tiles [t0, t1) in row-major order
    (of the upper triangle bj >= bi when ``sym``) and the tile (bi, bj) of
    t0, on a grid of G blocks; the ranges are contiguous and differ by at
    most one tile. Mirrors ``pairwise_range`` of csrc/kernel_matvec.cu,
    which the kernel walks."""
    nbi, nbj = -(-m // SWEEP_BM), -(-n // SWEEP_BN)
    T = pairwise_tiles(m, n, sym)
    t0, t1 = b * T // G, (b + 1) * T // G
    if not sym:
        return t0, t1, t0 // nbj, t0 % nbj
    bi, start = 0, 0
    while bi < nbi and start + nbi - bi <= t0:
        start += nbi - bi
        bi += 1
    return t0, t1, bi, bi + t0 - start


def pairwise_walk(m: int, n: int, sym: bool, G: int, b: int) -> list[tuple[int, int]]:
    """The output tiles (bi, bj) block b evaluates, in its order: row-major
    from :func:`pairwise_range`'s first tile, as the kernel steps."""
    t0, t1, bi, bj = pairwise_range(m, n, sym, G, b)
    nbj = -(-n // SWEEP_BN)
    tiles = []
    for _ in range(t1 - t0):
        tiles.append((bi, bj))
        bj += 1
        if bj == nbj:
            bi += 1
            bj = bi if sym else 0
    return tiles


@functools.cache
def _pairwise_slots(kind: int, d: int, vec: bool, device_index: int) -> tuple[int, int]:
    """(shared memory bytes, resident blocks on the card) of B3's
    instantiation for (kernel kind code, vector stores) at depth d (the
    caller holds the device context of ``device_index``)."""
    smem, slots = ctypes.c_int(0), ctypes.c_int(0)
    _check(_lib().rt_pairwise_slots(kind, d, int(vec), ctypes.byref(smem), ctypes.byref(slots)),
           "pairwise slots query")
    return smem.value, slots.value


def _pairwise_kernel_cuda(A, B, spec):
    what = "pairwise_kernel"
    m, d = A.shape
    n = B.shape[0]
    if B.shape[1] != d:
        raise ValueError(f"{what}: shapes A {tuple(A.shape)}, B {tuple(B.shape)}")
    if m == 0 or n == 0 or d == 0:
        raise ValueError(f"{what}: empty operand (m={m}, n={n}, d={d})")
    _check_operands(what, A.device, A=A, B=B)
    out = torch.empty(m, n, dtype=torch.float32, device=A.device)
    # the prologue's B: per 128-row tile, B k-major, ||b||^2 and a zero row
    packed = torch.empty(-(-n // SWEEP_BN) * (d + 2) * SWEEP_BN, dtype=torch.float32,
                         device=A.device)
    with torch.cuda.device(A.device):
        kp = _kparams(spec)
        slots = _pairwise_slots(kp[0], d, n % 4 == 0, A.device.index)[1]
        code = _lib().rt_pairwise(_ptr(A), _ptr(B), m, n, d, *kp, int(pairwise_symmetric(A, B)),
                                  slots, _ptr(packed), _ptr(out), _stream(A.device))
        _check(code, what)
        pairwise_kernel.launches += 1
    return out


def pairwise_kernel(A: Tensor, B: Tensor, *, spec: KernelSpec) -> Tensor:
    """K(A, B) materialized tile by tile (the preconditioner's K_MM). Passing
    one tensor as both A and B (:func:`pairwise_symmetric`) evaluates each
    symmetric pair of tiles once on the card."""
    if _route("pairwise_kernel", A, B) == "cpu":
        return pairwise_kernel_plain(A, B, spec=spec)
    return _pairwise_kernel_cuda(A, B, spec)


pairwise_kernel.launches = 0

# ---------------------------------------------------------------------------
# B4 j-sharded sweep: w = K(X, C)^T (K(X, C) u + v) as B2 launches
# ---------------------------------------------------------------------------
#: rows of X per B2 launch in the sharded sweep's transposed pass. Chosen
#: when B2 summed its B rows in one fp32 chain per lane, which rounded more
#: than B1 at n = 4.6x10^5 (tools/sweep_rounding.py); B2 now sums as B1's
#: pass 1 and one chain rounds alike (PERF.md), but the chunks stay: they
#: fix the launch counts and the rounding that the checks hold.
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


def _sharded_sweep_cuda(X, C, u, v, *, spec, row_mask, shard_m):
    t = kernel_matmul(X, C, u, v, spec=spec)
    if row_mask is not None:
        if row_mask.shape != (X.shape[0],):
            raise ValueError(f"sharded_sweep: row_mask shape {tuple(row_mask.shape)} "
                             f"!= ({X.shape[0]},)")
        t = t * row_mask.to(t.dtype)[:, None]
    w = _transposed_pass(kernel_matmul, C, X, t, shard_m, spec=spec)
    sharded_sweep.launches += 1
    return w


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
    are concatenated. Each Gram entry is evaluated twice. Any p >= 1: the
    columns run in groups of at most MAX_P, the whole schedule once per
    group. This wrapper counts one launch per group on a CUDA tensor, and
    each B2 launch inside it counts on ``kernel_matmul``'s counter too.
    Only float32 ``t_dtype`` / ``out_dtype`` (or None) are taken: the
    others are ROADMAP A7.
    """
    for name, dt in (("t_dtype", t_dtype), ("out_dtype", out_dtype)):
        if dt not in (None, torch.float32):
            raise NotImplementedError(f"sharded_sweep {name}={dt}: {_A7}")
    shard = max(int(shard_m), 1)
    squeeze = u.ndim == 1
    u2 = u[:, None] if squeeze else u
    v2 = None if v is None else (v[:, None] if squeeze else v)
    p = u2.shape[1]
    sweep = (sharded_sweep_plain if _route("sharded_sweep", X, C, u2, v2, row_mask) == "cpu"
             else _sharded_sweep_cuda)
    ws = [sweep(X, C, _group(u2, g, p), _group(v2, g, p), spec=spec, row_mask=row_mask,
                shard_m=shard) for g in column_groups(p)]
    w = ws[0] if len(ws) == 1 else torch.cat(ws, dim=1)
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
