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

B1, B2 and B4 also run the reference's reduced-precision, compensated form
(``compensated=True``): fp32, bf16 or float16 X, C, u and v, widened to
fp32 as each kernel loads them (a bf16 x bf16 or float16 x float16 product
is exact in fp32), a Kahan/two-sum carry beside each accumulator
(:func:`two_sum`), and an fp32, bf16 or float16 output. The kernels are
built in four variants (:data:`VARIANTS`): fp32 plain, fp32 compensated,
bf16 compensated and float16 compensated; 16-bit X without compensation
runs the fp32 plain kernel on an fp32 copy of X (exact). B3 takes fp32 only
(the policy keeps ``gram`` fp32). Other types (fp8, and float64 on the
card) are refused, naming ROADMAP.md A7.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import trace
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

#: the storage types the kernels take beside the fp32 the twins compute in
#: (csrc ``DT_*`` codes): X, C, u, v and the output of B1, B2 and B4
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the kernels' builds for (X's type, compensated) (csrc ``variant`` codes);
#: 16-bit X without compensation runs variant 0 on an fp32 copy of X
VARIANTS = {(torch.float32, False): 0, (torch.float32, True): 1,
            (torch.bfloat16, True): 2, (torch.float16, True): 3}
#: the builds' names, by code (csrc kernel_matvec.cu, _f32c.cu, _bf16c.cu,
#: _f16c.cu)
VARIANT_NAMES = ("f32", "f32c", "bf16c", "f16c")
#: the roadmap item that names the types the port does not run
_A7 = "ROADMAP.md item A7"


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


def sweep_smem_bytes(M: int, p: int, d: int, compensated: bool = False) -> tuple[int, bool]:
    """Dynamic shared memory of one sweep block and whether its w partial
    lives there (else in a per-block slice of global scratch). Mirrors
    ``sweep_smem_floats`` of csrc/sweep.cuh: the C ring (2 chunks of
    min(d, 32) k-rows), the extras ring (||c||^2 and u of 2 tiles), the X
    block (min(d, 128) k-rows, padded), t, the cross-warp reduction buffer,
    the row norms and, when it fits, the w partial (and, ``compensated``,
    its Kahan carry of the same size: :data:`W_SMEM_LIMIT_COMP`)."""
    P = _pad_p(p)
    cr, xr = min(d, SWEEP_KC), min(d, SWEEP_XK)
    base = 4 * (2 * cr * SWEEP_BN + 2 * (1 + P) * SWEEP_BN + xr * SWEEP_LDX
                + P * SWEEP_BM + 4 * P * SWEEP_BN + SWEEP_BM)
    with_w = base + 4 * M * P * (2 if compensated else 1)
    if with_w <= (W_SMEM_LIMIT_COMP if compensated else W_SMEM_LIMIT):
        return with_w, True
    return base, False


#: the card the sweep planner models: SMs, and resident threads and shared
#: memory of one SM (H100 SXM)
SMS = 132
SM_THREADS = 2048
SM_SMEM = 233_472
BLOCK_SMEM_RESERVED = 1024
#: the compensated sweep keeps its w partial and carry in shared memory up
#: to the most that still fits two blocks on an SM (SUSY's M = 10^4 at p = 1)
W_SMEM_LIMIT_COMP = SM_SMEM // 2 - BLOCK_SMEM_RESERVED


def sweep_grid_model(M: int, p: int, d: int, compensated: bool = False) -> int:
    """Persistent sweep blocks the planner charges for: SMs x the blocks one
    SM can hold by threads and shared memory. The launch queries the card's
    occupancy instead, which registers can only lower, so the model bounds
    the grid, and the w-partial workspace, from above."""
    smem, _ = sweep_smem_bytes(M, p, d, compensated)
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
def _sweep_grid(P: int, kind: int, smem: int, variant: int, device_index: int) -> int:
    """Persistent sweep grid: resident blocks per SM x SMs of B1's
    instantiation for (P, kernel kind code, variant) (the caller holds the
    device context of ``device_index``)."""
    grid = ctypes.c_int(0)
    _check(_lib().rt_sweep_grid(P, kind, smem, variant, ctypes.byref(grid)),
           "sweep grid query")
    return grid.value


def _check_operands(what: str, device: torch.device, *,
                    types: tuple = tuple(DTYPE_CODES), **tensors) -> None:
    """The kernels take contiguous tensors on one CUDA device, of ``types``:
    float32, bfloat16 or float16 for B1, B2 and B4; float32 alone for B3
    and B5-B7."""
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected {device}")
        if t.dtype not in types:
            names = " or ".join(str(dt).removeprefix("torch.") for dt in types)
            raise NotImplementedError(
                f"{what}: {name} is {t.dtype}; this CUDA kernel takes {names} — "
                f"other types are not ported ({_A7})")
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


def _check_out_dtype(what: str, dt: torch.dtype, card: bool = False) -> None:
    """Outputs are float32, bfloat16 or float16 (float64 too from a CPU
    twin)."""
    if dt not in DTYPE_CODES and (card or dt != torch.float64):
        raise NotImplementedError(f"{what}: output type {dt} is not ported ({_A7})")


def _code(t: Tensor | None) -> int:
    return 0 if t is None else DTYPE_CODES[t.dtype]


def _wide(t: Tensor | None) -> Tensor | None:
    """A twin's operand at fp32 or wider: the kernels widen as they load (the
    reference's ``_tile``), so a bf16 twin never computes in bf16."""
    return t if t is None or t.dtype.itemsize >= 4 else t.float()


def _variant(what: str, X: Tensor, compensated: bool) -> tuple[int, Tensor]:
    """(variant code, X as that variant reads it): bf16 or float16 X
    without compensation widens to fp32 (exact) for the fp32 plain build."""
    if X.dtype in (torch.bfloat16, torch.float16) and not compensated:
        X = X.float()
    if (X.dtype, bool(compensated)) not in VARIANTS:
        raise NotImplementedError(f"{what}: X is {X.dtype}; the CUDA kernels take float32, "
                                  f"bfloat16 or float16 ({_A7})")
    return VARIANTS[X.dtype, bool(compensated)], X


def two_sum(acc: Tensor, comp: Tensor, delta: Tensor) -> tuple[Tensor, Tensor]:
    """Kahan/two-sum compensated ``acc += delta``; returns (acc', comp').
    The carry ``comp`` holds the low-order bits each fp32 add lost, so that
    ``acc - comp`` is the sum to O(eps) whatever the number of terms. The
    reference's ``_two_sum``; the kernels' ``two_sum`` in csrc/sweep.cuh."""
    y = delta - comp
    t = acc + y
    return t, (t - acc) - y


def _compensated_sum(deltas: Tensor) -> Tensor:
    """sum(deltas[k] for k in order) through a Kahan carry, folded."""
    acc = torch.zeros_like(deltas[0])
    comp = torch.zeros_like(deltas[0])
    for k in range(deltas.shape[0]):
        acc, comp = two_sum(acc, comp, deltas[k])
    return acc - comp


def _tile_deltas(K: Tensor, V: Tensor) -> Tensor:
    """(tiles, rows, p): each 128-column tile j of K (rows, n) times rows j
    of V (n, p), zero-padded past n — the terms of the kernels' compensated
    loop over B's (or C's) tiles."""
    n = K.shape[1]
    nbj = -(-n // SWEEP_BN)
    pad = nbj * SWEEP_BN - n
    Kt = torch.nn.functional.pad(K, (0, pad)).reshape(K.shape[0], nbj, SWEEP_BN)
    Vt = torch.nn.functional.pad(V, (0, 0, 0, pad)).reshape(nbj, SWEEP_BN, V.shape[1])
    return torch.einsum("rjk,jkp->jrp", Kt, Vt)


# ---------------------------------------------------------------------------
# B1 fused sweep: w = K(X, C)^T (K(X, C) u + v)
# ---------------------------------------------------------------------------
def fused_sweep_plain(X: Tensor, C: Tensor, u: Tensor, v: Tensor | None = None, *,
                      spec: KernelSpec, row_mask: Tensor | None = None,
                      block_rows: int = 2048, compensated: bool = False,
                      out_dtype: torch.dtype | None = None) -> tuple[Tensor, Tensor]:
    """Plain twin of the sweep kernel, on the same two-evaluation schedule.

    ``u`` (M, p), ``v`` (n, p) or None, each widened to fp32 as the kernel
    loads it. Row blocks are zero-padded to ``block_rows`` so every block
    contracts at one shape; ``t`` is zeroed on padded rows and multiplied by
    ``row_mask``, so masked rows contribute exactly 0. ``compensated``
    two-sums t over the kernel's 128-center tiles and w over its 128-row
    blocks, in order (the kernel's compensation points), and folds each
    carry at the end. Returns ``(w, tile evaluations)``, w at ``out_dtype``
    (default: X's and u's promotion): every entry is evaluated twice,
    ``2 * nbi * nbj`` in the kernel's 128 x 128 tile units.
    """
    if out_dtype is None:
        out_dtype = torch.promote_types(X.dtype, u.dtype)
    X, C, u, v = _wide(X), _wide(C), _wide(u), _wide(v)
    n = X.shape[0]
    w = torch.zeros(C.shape[0], u.shape[1], dtype=X.dtype, device=X.device)
    wc = torch.zeros_like(w)   # w's carry (compensated)
    if compensated:
        block_rows = -(-block_rows // SWEEP_BM) * SWEEP_BM
    for r0 in range(0, n, block_rows):
        rows = min(block_rows, n - r0)
        pad = block_rows - rows
        xb = torch.nn.functional.pad(X[r0:r0 + rows], (0, 0, 0, pad))
        keep = torch.zeros(block_rows, dtype=X.dtype, device=X.device)
        keep[:rows] = 1.0 if row_mask is None else row_mask[r0:r0 + rows].to(X.dtype)
        if not compensated:
            t = tile_eval(spec, xb, C) @ u                       # pass 1
            if v is not None:
                t = t + torch.nn.functional.pad(v[r0:r0 + rows], (0, 0, 0, pad))
            t = t * keep[:, None]
            w = w + tile_eval(spec, xb, C).T @ t                 # pass 2
            continue
        K = tile_eval(spec, xb, C)
        t = _compensated_sum(_tile_deltas(K, u))                 # pass 1
        if v is not None:
            t = t + torch.nn.functional.pad(v[r0:r0 + rows], (0, 0, 0, pad))
        t = t * keep[:, None]
        sub = block_rows // SWEEP_BM                             # pass 2
        deltas = torch.einsum("srm,srp->smp", K.reshape(sub, SWEEP_BM, -1),
                              t.reshape(sub, SWEEP_BM, -1))
        for k in range(sub):
            w, wc = two_sum(w, wc, deltas[k])
    if compensated:
        w = w - wc
    nbi, nbj = sweep_tile_grid(n, C.shape[0])
    return w.to(out_dtype), torch.tensor(2 * nbi * nbj, dtype=torch.int32)


def _fused_sweep_cuda(X, C, u, v, *, spec, row_mask, compensated=False, out_dtype=None):
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
    if out_dtype is None:
        out_dtype = torch.promote_types(X.dtype, u.dtype)
    variant, X = _variant(what, X, compensated)
    _check_out_dtype(what, out_dtype, card=True)
    comp = variant != 0
    if not comp:   # the fp32 build reads v and writes w in fp32 only
        v = _wide(v)
    _check_operands(what, X.device, X=X, C=C, u=u, v=v, row_mask=mask)
    P = _pad_p(p)
    smem, w_in_smem = sweep_smem_bytes(M, p, d, comp)
    w = torch.empty(M, p, dtype=out_dtype if comp else torch.float32, device=X.device)
    counter = torch.zeros(1, dtype=torch.int32, device=X.device)
    nbi, nbj = sweep_tile_grid(n, M)
    # the prologue's centers: per 128-center tile, C k-major, ||c||^2, u
    packed = torch.empty(nbj * (d + 1 + P) * SWEEP_BN, dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        lib = _lib()
        kp = _kparams(spec)
        grid = min(_sweep_grid(P, kp[0], smem, variant, X.device.index), nbi)
        # the w partials, then (compensated) their carries
        partial = torch.empty((2 if comp else 1) * grid * M * P, dtype=torch.float32,
                              device=X.device)
        code = lib.rt_fused_sweep(
            variant, _ptr(X), _ptr(C), _code(C), _ptr(u), _code(u), _ptr(v), _code(v),
            _ptr(mask), n, M, d, p, *kp, P, int(w_in_smem), smem, grid,
            _ptr(packed), _ptr(partial), _ptr(w), _code(w), _ptr(counter), _stream(X.device))
        _check(code, what)
        fused_sweep.launches += 1
        fused_sweep.variant_launches[variant] += 1
    return w.to(out_dtype), counter[0]


def fused_sweep(X: Tensor, C: Tensor, u: Tensor, v: Tensor | None = None, *,
                spec: KernelSpec, row_mask: Tensor | None = None,
                return_tile_count: bool = False, compensated: bool = False):
    """w = K(X,C)^T (K(X,C) u + v) — the whole CG sweep in one launch per
    column group.

    X: (n, d), C: (M, d), u: (M,) or (M, p), v like u's rows over n or None
    -> w like u, at X's and u's promotion (the reference's ``out``). X, C,
    u and v are fp32, bf16 or float16; ``compensated`` runs t and w through
    Kahan carries (the reduced-storage policies' accumulation). Any p >= 1: the columns run in
    groups of at most MAX_P (:func:`column_groups`), one launch (or, on the
    CPU, one twin call) each. ``row_mask`` (n,), 0/1: rows with mask 0
    contribute EXACTLY zero (their t_i is zeroed before the transposed
    product). With ``return_tile_count=True`` also returns the int32 count
    of Gram tiles evaluated, summed over the groups:
    ``groups * 2 * nbi * nbj``.
    """
    squeeze = u.ndim == 1
    u2 = u[:, None] if squeeze else u
    v2 = None if v is None else (v[:, None] if squeeze else v)
    p = u2.shape[1]
    sweep = (fused_sweep_plain if _route("fused_sweep", X, C, u2, v2, row_mask) == "cpu"
             else _fused_sweep_cuda)
    ws, count = [], 0
    for g in column_groups(p):
        with trace.span("kernel.launch"):
            w, c = sweep(X, C, _group(u2, g, p), _group(v2, g, p), spec=spec,
                         row_mask=row_mask, compensated=compensated)
        ws.append(w)
        count = count + c
    w = ws[0] if len(ws) == 1 else torch.cat(ws, dim=1)
    w = w[:, 0] if squeeze else w
    return (w, count) if return_tile_count else w


fused_sweep.launches = 0
fused_sweep.variant_launches = [0] * len(VARIANT_NAMES)


# ---------------------------------------------------------------------------
# B2 kernel matmul: out = K(A, B) V + add
# ---------------------------------------------------------------------------
def kernel_matmul_plain(A: Tensor, B: Tensor, V: Tensor, add: Tensor | None = None, *,
                        spec: KernelSpec, block_rows: int = 2048, compensated: bool = False,
                        out_dtype: torch.dtype | None = None) -> Tensor:
    """Plain twin of the kernel matmul: ``V`` (n, p), ``add`` (m, p) or None,
    each widened to fp32 as the kernel loads it. ``compensated`` two-sums
    the products over B's 128-row tiles, in order, and folds the carry
    before ``add``. The result is at ``out_dtype`` (default: A's and V's
    promotion)."""
    if out_dtype is None:
        out_dtype = torch.promote_types(A.dtype, V.dtype)
    A, B, V, add = _wide(A), _wide(B), _wide(V), _wide(add)
    if compensated:
        out = torch.cat([_compensated_sum(_tile_deltas(tile_eval(spec, A[r:r + block_rows], B),
                                                       V))
                         for r in range(0, A.shape[0], block_rows)], dim=0)
    else:
        out = torch.cat([tile_eval(spec, A[r:r + block_rows], B) @ V
                         for r in range(0, A.shape[0], block_rows)], dim=0)
    return (out if add is None else out + add).to(out_dtype)


def kernel_matmul_sliced_plain(A: Tensor, B: Tensor, V: Tensor, add: Tensor | None = None, *,
                               spec: KernelSpec, slices: int, compensated: bool = False,
                               out_dtype: torch.dtype | None = None) -> Tensor:
    """The kernel's split schedule in plain PyTorch, for the tests: B's rows
    in ``slices`` contiguous slices of 128-row tiles
    (:func:`matmul_slice_bounds`), each slice's K(A, B_s) V_s summed in
    slice order (two-summed when ``compensated``), then ``add``."""
    if out_dtype is None:
        out_dtype = torch.promote_types(A.dtype, V.dtype)
    parts = [kernel_matmul_plain(A, B[b0:b1], V[b0:b1], spec=spec, compensated=compensated,
                                 out_dtype=torch.promote_types(A.dtype, torch.float32))
             for b0, b1 in matmul_slice_bounds(B.shape[0], slices)]
    if compensated:
        out = _compensated_sum(torch.stack(parts))
    else:
        out = None
        for part in parts:
            out = part if out is None else out + part
    return (out if add is None else out + _wide(add)).to(out_dtype)


@functools.cache
def _matmul_slots(P: int, kind: int, d: int, variant: int, device_index: int) -> tuple[int, int]:
    """(shared memory bytes, resident blocks on the card) of B2's
    instantiation for (P, kernel kind code, variant) at depth d (the caller
    holds the device context of ``device_index``)."""
    smem, slots = ctypes.c_int(0), ctypes.c_int(0)
    _check(_lib().rt_matmul_slots(P, kind, d, variant, ctypes.byref(smem),
                                  ctypes.byref(slots)),
           "kernel matmul slots query")
    return smem.value, slots.value


def _kernel_matmul_cuda(A, B, V, add, *, spec, slots=None, compensated=False, out_dtype=None):
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
    if out_dtype is None:
        out_dtype = torch.promote_types(A.dtype, V.dtype)
    variant, A = _variant(what, A, compensated)
    _check_out_dtype(what, out_dtype, card=True)
    if variant == 0:   # the fp32 build reads add and writes out in fp32 only
        add = _wide(add)
    _check_operands(what, A.device, A=A, B=B, V=V, add=add)
    out = torch.empty(m, p, dtype=out_dtype if variant else torch.float32, device=A.device)
    P = _pad_p(p)
    # the prologue's B: per 128-row tile, B k-major, ||b||^2, V
    packed = torch.empty(-(-n // SWEEP_BN) * (d + 1 + P) * SWEEP_BN, dtype=torch.float32,
                         device=A.device)
    with torch.cuda.device(A.device):
        lib = _lib()
        kp = _kparams(spec)
        if slots is None:
            slots = _matmul_slots(P, kp[0], d, variant, A.device.index)[1]
        S = lib.rt_matmul_slices(m, n, slots)
        partial = (torch.empty(S * m * p, dtype=torch.float32, device=A.device)
                   if S > 1 else None)
        code = lib.rt_kernel_matmul(
            variant, _ptr(A), _ptr(B), _code(B), _ptr(V), _code(V), _ptr(add), _code(add),
            m, n, d, p, *kp, P, slots, _ptr(packed), _ptr(partial), _ptr(out), _code(out),
            _stream(A.device))
        _check(code, what)
        kernel_matmul.launches += 1
        kernel_matmul.variant_launches[variant] += 1
    return out.to(out_dtype)


def kernel_matmul(A: Tensor, B: Tensor, V: Tensor, add: Tensor | None = None, *,
                  spec: KernelSpec, out_dtype: torch.dtype | None = None,
                  compensated: bool = False) -> Tensor:
    """out = K(A, B) V (+ add) with Gram tiles that never leave the chip.

    A: (m, d), B: (n, d), V: (n,) or (n, p), add like the output or None;
    each fp32, bf16 or float16. Any p >= 1, in groups of at most MAX_P
    columns, one launch each. ``compensated`` runs the sum over B's tiles
    through a Kahan carry. ``out_dtype`` is float32, bfloat16 or float16
    (default: A's and V's promotion, the reference's); a 16-bit result is
    rounded once, from the fp32 sum with ``add``.
    """
    if out_dtype is None:
        out_dtype = torch.promote_types(A.dtype, V.dtype)
    _check_out_dtype("kernel_matmul", out_dtype)
    squeeze = V.ndim == 1
    V2 = V[:, None] if squeeze else V
    add2 = None if add is None else (add[:, None] if squeeze else add)
    p = V2.shape[1]
    matmul = (kernel_matmul_plain if _route("kernel_matmul", A, B, V2, add2) == "cpu"
              else _kernel_matmul_cuda)
    outs = []
    for g in column_groups(p):
        with trace.span("kernel.launch"):
            outs.append(matmul(A, B, _group(V2, g, p), _group(add2, g, p), spec=spec,
                               compensated=compensated, out_dtype=out_dtype))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out[:, 0] if squeeze else out


kernel_matmul.launches = 0
kernel_matmul.variant_launches = [0] * len(VARIANT_NAMES)


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


def _pairwise_kernel_cuda(A, B, spec, out=None):
    what = "pairwise_kernel"
    m, d = A.shape
    n = B.shape[0]
    if B.shape[1] != d:
        raise ValueError(f"{what}: shapes A {tuple(A.shape)}, B {tuple(B.shape)}")
    if m == 0 or n == 0 or d == 0:
        raise ValueError(f"{what}: empty operand (m={m}, n={n}, d={d})")
    if out is None:
        out = torch.empty(m, n, dtype=torch.float32, device=A.device)
    _check_operands(what, A.device, types=(torch.float32,), A=A, B=B, out=out)
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


def pairwise_kernel(A: Tensor, B: Tensor, *, spec: KernelSpec,
                    out: Tensor | None = None) -> Tensor:
    """K(A, B) materialized tile by tile (the preconditioner's K_MM, a row
    tile of the K_nM cache). Passing one tensor as both A and B
    (:func:`pairwise_symmetric`) evaluates each symmetric pair of tiles once
    on the card. ``out``, a contiguous (m, n) float32 tensor (a row slice of
    a larger one), receives the result in place: the kernel stores into it."""
    if out is not None and out.shape != (A.shape[0], B.shape[0]):
        raise ValueError(f"pairwise_kernel: out shape {tuple(out.shape)} != "
                         f"({A.shape[0]}, {B.shape[0]})")
    with trace.span("kernel.launch"):
        if _route("pairwise_kernel", A, B, out) == "cpu":
            K = pairwise_kernel_plain(A, B, spec=spec)
            return K if out is None else out.copy_(K)
        return _pairwise_kernel_cuda(A, B, spec, out)


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


def _transposed_pass(matmul, C: Tensor, X: Tensor, t: Tensor, shard: int, *,
                     out_dtype: torch.dtype, **kw) -> Tensor:
    """w = K(C, X) t, one shard of C rows at a time, each summed over X in
    ``SHARD_ROW_CHUNK``-row chunks chained through ``add=``. The chained w
    stays fp32 (float64 in a float64 twin) whatever ``out_dtype`` is; the
    last chunk of a shard writes ``out_dtype``. A compensated launch's carry
    starts anew in each chunk: the chain between chunks is one plain add."""
    inter = torch.promote_types(out_dtype, torch.float32)
    last = (X.shape[0] - 1) // SHARD_ROW_CHUNK * SHARD_ROW_CHUNK
    ws = []
    for j0 in range(0, C.shape[0], shard):
        w = None
        for r0 in range(0, X.shape[0], SHARD_ROW_CHUNK):
            r1 = r0 + SHARD_ROW_CHUNK
            w = matmul(C[j0:j0 + shard], X[r0:r1], t[r0:r1], w,
                       out_dtype=out_dtype if r0 == last else inter, **kw)
        ws.append(w)
    return torch.cat(ws, dim=0)


def _sharded_dtypes(X, u, C, t_dtype, out_dtype) -> tuple[torch.dtype, torch.dtype]:
    """(t's type, w's type): the reference's defaults, t at X's and u's
    promotion and w at C's and t's."""
    t_dt = t_dtype if t_dtype is not None else torch.promote_types(X.dtype, u.dtype)
    out_dt = out_dtype if out_dtype is not None else torch.promote_types(C.dtype, t_dt)
    return t_dt, out_dt


def sharded_sweep_plain(X: Tensor, C: Tensor, u: Tensor, v: Tensor | None = None, *,
                        spec: KernelSpec, row_mask: Tensor | None = None,
                        shard_m: int, compensated: bool = False,
                        t_dtype: torch.dtype | None = None,
                        out_dtype: torch.dtype | None = None) -> Tensor:
    """Plain twin of the sharded sweep: the same composition over the plain
    twin of B2. ``u`` (M, p), ``v`` (n, p) or None."""
    t_dt, out_dt = _sharded_dtypes(X, u, C, t_dtype, out_dtype)
    t = kernel_matmul_plain(X, C, u, v, spec=spec, compensated=compensated, out_dtype=t_dt)
    if row_mask is not None:
        t = t * row_mask.to(t.dtype)[:, None]
    return _transposed_pass(kernel_matmul_plain, C, X, t, shard_m, spec=spec,
                            compensated=compensated, out_dtype=out_dt)


def _sharded_sweep_cuda(X, C, u, v, *, spec, row_mask, shard_m, compensated=False,
                        t_dtype=None, out_dtype=None):
    t_dt, out_dt = _sharded_dtypes(X, u, C, t_dtype, out_dtype)
    t = kernel_matmul(X, C, u, v, spec=spec, compensated=compensated, out_dtype=t_dt)
    if row_mask is not None:
        if row_mask.shape != (X.shape[0],):
            raise ValueError(f"sharded_sweep: row_mask shape {tuple(row_mask.shape)} "
                             f"!= ({X.shape[0]},)")
        t = t * row_mask.to(t.dtype)[:, None]
    w = _transposed_pass(kernel_matmul, C, X, t, shard_m, spec=spec, compensated=compensated,
                         out_dtype=out_dt)
    sharded_sweep.launches += 1
    # its B2 launches' build (16-bit X without compensation runs the fp32 one)
    sharded_sweep.variant_launches[VARIANTS.get((X.dtype, bool(compensated)), 0)] += 1
    return w


def sharded_sweep(X: Tensor, C: Tensor, u: Tensor, v: Tensor | None = None, *,
                  spec: KernelSpec, row_mask: Tensor | None = None, shard_m: int = 8192,
                  t_dtype: torch.dtype | None = None,
                  out_dtype: torch.dtype | None = None, compensated: bool = False) -> Tensor:
    """w = K(X,C)^T (K(X,C) u + v) for M past the fused sweep's workspace.

    The out-of-core schedule of the reference's ``sharded_sweep_pallas``,
    built from B2: ``t = kernel_matmul(X, C, u, add=v)`` spills (n, p) to
    device memory at ``t_dtype`` (default: X's and u's promotion; the bf16
    policy spills bf16), rows with ``row_mask == 0`` are multiplied to
    exactly 0, then ``kernel_matmul(C_j, X, t)`` per ``shard_m`` rows of C
    (over X in ``SHARD_ROW_CHUNK``-row chunks chained through ``add=`` in
    fp32, the last chunk writing ``out_dtype``, default C's and t's
    promotion), and the shards are concatenated. ``compensated`` runs each
    B2 launch's sum through a Kahan carry; the carry starts anew in each
    row chunk. Each Gram entry is evaluated twice. Any p >= 1: the columns
    run in groups of at most MAX_P, the whole schedule once per group. This
    wrapper counts one launch per group on a CUDA tensor, and each B2 launch
    inside it counts on ``kernel_matmul``'s counter too. ``t_dtype`` and
    ``out_dtype`` are float32, bfloat16 or float16 (or None).
    """
    for name, dt in (("t_dtype", t_dtype), ("out_dtype", out_dtype)):
        if dt is not None and dt not in DTYPE_CODES:
            raise NotImplementedError(f"sharded_sweep {name}={dt}: not ported ({_A7})")
    shard = max(int(shard_m), 1)
    squeeze = u.ndim == 1
    u2 = u[:, None] if squeeze else u
    v2 = None if v is None else (v[:, None] if squeeze else v)
    p = u2.shape[1]
    sweep = (sharded_sweep_plain if _route("sharded_sweep", X, C, u2, v2, row_mask) == "cpu"
             else _sharded_sweep_cuda)
    ws = [sweep(X, C, _group(u2, g, p), _group(v2, g, p), spec=spec, row_mask=row_mask,
                shard_m=shard, compensated=compensated, t_dtype=t_dtype, out_dtype=out_dtype)
          for g in column_groups(p)]
    w = ws[0] if len(ws) == 1 else torch.cat(ws, dim=1)
    return w[:, 0] if squeeze else w


sharded_sweep.launches = 0
sharded_sweep.variant_launches = [0] * len(VARIANT_NAMES)

WRAPPERS = (fused_sweep, sharded_sweep, kernel_matmul, pairwise_kernel)


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset: B1-B4 here and the
    blocked Cholesky's B5-B7."""
    from . import blocked_cholesky
    return {**{fn.__name__: fn.launches for fn in WRAPPERS},
            **blocked_cholesky.launch_counts()}


def variant_launch_counts() -> dict[str, int]:
    """Launches of each build of B1, B2 and B4 since the last reset, keyed
    ``<wrapper>_<build>`` (``fused_sweep_bf16c``: the bf16 compensated B1);
    they sum to the wrappers' ``launch_counts``."""
    return {f"{fn.__name__}_{name}": fn.variant_launches[code]
            for fn in (fused_sweep, sharded_sweep, kernel_matmul)
            for code, name in enumerate(VARIANT_NAMES)}


def reset_launch_counts() -> None:
    from . import blocked_cholesky
    for fn in WRAPPERS:
        fn.launches = 0
        if hasattr(fn, "variant_launches"):
            fn.variant_launches = [0] * len(VARIANT_NAMES)
    blocked_cholesky.reset_launch_counts()
