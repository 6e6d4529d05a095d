"""Tiled right-looking blocked Cholesky — the out-of-core factor path.

Counterpart of ``repro/kernels/blocked_cholesky.py``. The (M, M) matrix stays
on the HOST; only O(block * M) panel bytes are on the device at any moment.
Per column panel k of width b = ``block``:

    POTRF   L_kk      = chol(A_kk)                — one (b, b) tile      (B5)
    TRSM    L_panel   = A[below, k] L_kk^{-T}     — (rows, b) panel     (B6)
    UPDATE  A[j:, j] -= L[j:, k] L[j, k]^T        — per column block j  (B7)

Two tile engines supply the three primitives:

* ``"torch"`` — ``torch.linalg.cholesky_ex`` (a failed pivot gives NaN, as
  ``jnp.linalg.cholesky`` does), ``solve_triangular`` and a matmul, TF32
  off: the counterpart of the reference's ``"jnp"`` engine.
* ``"cuda"``  — the hand-written kernels B5–B7 (``csrc/blocked_cholesky.cu``)
  through :func:`potrf_tile`, :func:`trsm_panel` and :func:`trailing_update`;
  on CPU tensors those wrappers run their plain twins, which follow the
  Pallas bodies' recurrences (column loop, forward substitution, C − PQᵀ).

``"auto"`` is ``"cuda"`` on a GPU device and ``"torch"`` on the CPU.

Where the port differs from the reference, to save host and device memory:

* ``overwrite=True`` factors the caller's host tensor in place, and the
  factor comes back as the upper view ``W.tril_().mT`` of that buffer (no
  transposed copy): at M = 5x10^4 each avoided copy is 10 GB of host memory.
* The fresh factor panel stays on the device through panel k's trailing
  updates, which slice P and Q from it, and B7 updates each trailing tile in
  place: one upload and one download per update instead of the reference's
  three uploads and one download. The device holds at most the panel, one
  trailing tile and the diagonal tiles: under two (M, b) panels.
* On a CUDA device every copy passes through one pinned staging buffer of
  M * b elements (:class:`_HostLink`).

Tiles compute in float32, or in float64 for a float64 input (the CUDA
kernels take float32 only). Factors are UPPER (A = T^T T), the repo-wide
``chol(...).T`` convention.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch import trace

from .kernel_matvec import _check_operands, _ptr, _route, _stream

Tensor = torch.Tensor
#: the tile kernels' one type: the policy keeps the factors float32
FP32 = (torch.float32,)

TILE_IMPLS = ("auto", "torch", "cuda")


def resolve_tile_impl(tile_impl: str, device="cuda") -> str:
    """Resolve ``"auto"`` to the engine of ``device``'s type."""
    if tile_impl not in TILE_IMPLS:
        raise ValueError(f"unknown tile_impl {tile_impl!r}; supported: {TILE_IMPLS}")
    if tile_impl == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    return tile_impl


@contextlib.contextmanager
def _fp32_matmul():
    """Full-fp32 matmuls (no TF32) for the duration, restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# Device-residency accounting
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FactorStats:
    """Device residency of one blocked factorization.

    ``peak_device_bytes`` is self-accounted: every device tensor the factorization
    creates is charged when made and credited when released — the
    algorithmic working set, comparable against
    ``FactorPlan.device_ceiling_bytes``. On a CUDA device
    ``measured_peak_device_bytes`` is the ground truth beside it:
    ``torch.cuda.memory_allocated`` above its level when the factorization
    began, sampled at every charge (the high-water points).
    ``bytes_transferred`` counts host<->device copies, both directions;
    ``copy_seconds`` and ``tile_seconds`` split the factorization's wall time
    between those copies (with the host gathers and scatters of strided
    panels) and the tile operations, each timed to a synchronised end, when
    ``timing`` is set (the default for a ``FactorStats`` made by the caller;
    a fit sets it only when asked for ``stage_times``). Without it the two
    stay 0 and nothing synchronises; the blocks are still the spans
    ``factor.copy`` and ``factor.tile`` while tracing is on
    (``repro_torch.trace``). ``host_copy_bytes`` counts the host copies of
    T T^T that a lam path makes so that each lam factors an unspoiled
    matrix.
    """

    peak_device_bytes: int = 0
    current_device_bytes: int = 0
    bytes_transferred: int = 0
    panels: int = 0
    tiles_updated: int = 0
    measured_peak_device_bytes: int = 0
    copy_seconds: float = 0.0
    tile_seconds: float = 0.0
    host_copy_bytes: int = 0
    timing: bool = True
    _device: torch.device | None = dataclasses.field(default=None, repr=False)
    _base: int = dataclasses.field(default=0, repr=False)

    def begin(self, device: torch.device) -> None:
        self._device = device
        if device.type == "cuda":
            self._base = torch.cuda.memory_allocated(device)

    def clock(self) -> float:
        """Wall time after the device's queued work has finished."""
        return trace.synced_clock(self._device)

    @contextlib.contextmanager
    def timed(self, what: str):
        """The block's span ``factor.<what>``; with ``timing``, also its
        synchronised wall time, added to ``<what>_seconds``."""
        with trace.span(f"factor.{what}", device=self._device,
                        clock=self.clock if self.timing else None) as span:
            yield
        if self.timing:
            setattr(self, f"{what}_seconds", getattr(self, f"{what}_seconds") + span.seconds)

    def alloc(self, nbytes: int) -> None:
        self.current_device_bytes += nbytes
        self.peak_device_bytes = max(self.peak_device_bytes, self.current_device_bytes)
        if self._device is not None and self._device.type == "cuda":
            live = torch.cuda.memory_allocated(self._device) - self._base
            self.measured_peak_device_bytes = max(self.measured_peak_device_bytes, live)

    def free(self, nbytes: int) -> None:
        self.current_device_bytes -= nbytes


def _nbytes(t: Tensor) -> int:
    return t.numel() * t.element_size()


class _HostLink:
    """Copies between the host working matrix and the device, charged to
    ``stats``. On a CUDA device they pass through one reusable pinned
    staging buffer of ``max_numel`` elements: a strided host panel is
    gathered into it by the CPU and crosses PCIe at the pinned rate, instead
    of being gathered into pageable memory and staged again by the CUDA runtime."""

    def __init__(self, stats: FactorStats, device: torch.device, dt, max_numel: int):
        self.stats, self.device, self.dt = stats, device, dt
        self.stage = (torch.empty(max_numel, dtype=dt, pin_memory=True)
                      if device.type == "cuda" else None)

    def _staged(self, shape) -> Tensor:
        return self.stage[:shape[0] * shape[1]].view(shape)

    def put(self, host_block: Tensor) -> Tensor:
        """Upload a (possibly strided) host block as a contiguous device tensor."""
        with self.stats.timed("copy"):
            dev = torch.empty(host_block.shape, dtype=self.dt, device=self.device)
            if self.stage is None:
                dev.copy_(host_block)
            else:
                buf = self._staged(host_block.shape)
                buf.copy_(host_block)
                dev.copy_(buf)            # synchronous: the buffer is free after
        self.stats.alloc(_nbytes(dev))
        self.stats.bytes_transferred += _nbytes(dev)
        return dev

    def take(self, dev: Tensor, host_dst: Tensor) -> None:
        """Copy a device tensor back into its host slot."""
        with self.stats.timed("copy"):
            if self.stage is None:
                host_dst.copy_(dev)
            else:
                buf = self._staged(dev.shape)
                buf.copy_(dev)
                host_dst.copy_(buf)
        self.stats.bytes_transferred += _nbytes(dev)


# ---------------------------------------------------------------------------
# B5-B7: wrappers (kernel on a CUDA tensor, plain twin on a CPU tensor)
# ---------------------------------------------------------------------------
def _lib():
    from repro_torch.kernels import build   # lazy: needs nvcc, only on the card
    return build.load()


def _check(code: int, what: str) -> None:
    from repro_torch.kernels import build
    build.check(code, what)


def potrf_plain(A: Tensor) -> Tensor:
    """Plain twin of B5, the Pallas body's column recurrence: column j is
    ``v = A[:, j] - L[:, :j] L[j, :j]^T``, ``d = sqrt(v_j)`` (NaN for a
    non-positive pivot, never clamped), then ``[0; d; v_below / d]``."""
    b = A.shape[0]
    L = torch.zeros_like(A)
    nan = torch.full((), float("nan"), dtype=A.dtype, device=A.device)
    for j in range(b):
        v = A[j:, j] - L[j:, :j] @ L[j, :j]
        d = torch.where(v[0] > 0, v[0], nan).sqrt()
        L[j, j] = d
        L[j + 1:, j] = v[1:] / d
    return L


#: B5's sub-panel width (``PO_NB`` in csrc/blocked_cholesky.cu)
POTRF_NB = 64


def potrf_blocked_plain(A: Tensor, nb: int = POTRF_NB) -> Tensor:
    """Plain mirror of B5's schedule on the card, for the tests. Per
    sub-panel of width ``nb``: the column recurrence on the diagonal block
    (:func:`potrf_plain`), the panel below (:func:`trsm_plain`) and the
    trailing lower triangle (:func:`update_plain`, nothing written above
    the diagonal). The first sub-panel reads A's lower triangle, the rest
    work in L, whose strict upper triangle stays 0."""
    b = A.shape[0]
    L = torch.zeros_like(A)
    S = A
    for s in range(0, b, nb):
        e = min(s + nb, b)
        L[s:e, s:e] = potrf_plain(S[s:e, s:e])
        if e == b:
            break
        L[e:, s:e] = trsm_plain(L[s:e, s:e], S[e:, s:e])
        L[e:, e:] = update_plain(S[e:, e:], L[e:, s:e], L[e:, s:e]).tril()
        S = L
    return L


def potrf_tile(A: Tensor) -> Tensor:
    """B5: the lower Cholesky factor of one (b, b) tile (its lower triangle
    is read); a non-positive pivot gives NaN from that column on. On the
    card it is a blocked factorization in sub-panels of ``POTRF_NB`` (see
    :func:`potrf_blocked_plain`): one wrapper call, one launch counted."""
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"potrf_tile: expected a square tile, got {tuple(A.shape)}")
    if _route("potrf_tile", A) == "cpu":
        return potrf_plain(A)
    _check_operands("potrf_tile", A.device, types=FP32, A=A)
    L = torch.empty_like(A)
    with torch.cuda.device(A.device):
        code = _lib().rb_potrf(_ptr(A), _ptr(L), A.shape[0], _stream(A.device))
        _check(code, "potrf_tile")
        potrf_tile.launches += 1
    return L


def trsm_plain(L: Tensor, A: Tensor) -> Tensor:
    """Plain twin of B6, the Pallas body's forward substitution:
    ``X[:, j] = (A[:, j] - X[:, :j] L[j, :j]^T) / L[j, j]``."""
    X = torch.zeros_like(A)
    for j in range(L.shape[0]):
        X[:, j] = (A[:, j] - X[:, :j] @ L[j, :j]) / L[j, j]
    return X


#: B6's column-block width (``TD_W`` in csrc/blocked_cholesky.cu)
TRSM_NB = 128


def trsm_blocked_plain(L: Tensor, A: Tensor, nb: int = TRSM_NB) -> Tensor:
    """Plain mirror of B6's schedule on the card, for the tests. Per column
    block J of width ``nb``: X[:, J] = A[:, J] - X[:, :J0] L[J, :J0]^T
    (:func:`update_plain`), then the forward substitution on L[J, J]
    (:func:`trsm_plain`). Reads L's lower triangle only."""
    X = torch.empty_like(A)
    for J0 in range(0, L.shape[0], nb):
        J = slice(J0, J0 + nb)
        X[:, J] = trsm_plain(L[J, J], update_plain(A[:, J], X[:, :J0], L[J, :J0]))
    return X


def trsm_panel(L: Tensor, A: Tensor) -> Tensor:
    """B6: X = A L^{-T} for a lower (b, b) L and an (r, b) panel A (its
    lower triangle is read). On the card it is a blocked solve in column
    blocks of ``TRSM_NB`` (see :func:`trsm_blocked_plain`): one wrapper
    call, one launch counted."""
    r, b = A.shape
    if L.shape != (b, b):
        raise ValueError(f"trsm_panel: L {tuple(L.shape)} does not match A {tuple(A.shape)}")
    if _route("trsm_panel", L, A) == "cpu":
        return trsm_plain(L, A)
    _check_operands("trsm_panel", A.device, types=FP32, L=L, A=A)
    X = torch.empty_like(A)
    with torch.cuda.device(A.device):
        code = _lib().rb_trsm(_ptr(L), _ptr(A), _ptr(X), r, b, _stream(A.device))
        _check(code, "trsm_panel")
        trsm_panel.launches += 1
    return X


def update_plain(C: Tensor, P: Tensor, Q: Tensor) -> Tensor:
    """Plain twin of B7: ``C - P Q^T`` in full fp32 (TF32 off)."""
    with _fp32_matmul():
        return C - P @ Q.mT


def trailing_update(C: Tensor, P: Tensor, Q: Tensor, *, out: Tensor | None = None) -> Tensor:
    """B7: ``C - P Q^T`` for C (r, b), P (r, k), Q (b, k). The contraction
    width k is independent of the output width b. ``out`` may be C itself
    (the in-place update the factorization uses)."""
    r, b = C.shape
    k = P.shape[1]
    if P.shape[0] != r or Q.shape != (b, k):
        raise ValueError(f"trailing_update: shapes C {tuple(C.shape)}, P {tuple(P.shape)}, "
                         f"Q {tuple(Q.shape)}")
    if _route("trailing_update", C, P, Q) == "cpu":
        res = update_plain(C, P, Q)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty_like(C)
    _check_operands("trailing_update", C.device, types=FP32, C=C, P=P, Q=Q,
                    out=out)
    with torch.cuda.device(C.device):
        # row strides of C and out, P, Q (contiguous), and lower = 0: the whole tile
        code = _lib().rb_update(_ptr(C), _ptr(P), _ptr(Q), _ptr(out), r, b, k, b, k, k, 0,
                                _stream(C.device))
        _check(code, "trailing_update")
        trailing_update.launches += 1
    return out


potrf_tile.launches = trsm_panel.launches = trailing_update.launches = 0
WRAPPERS = (potrf_tile, trsm_panel, trailing_update)


# ---------------------------------------------------------------------------
# The two tile engines
# ---------------------------------------------------------------------------
def _torch_potrf(A: Tensor) -> Tensor:
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info > 0, torch.full_like(L, float("nan")), L)


def _torch_trsm(L: Tensor, A: Tensor) -> Tensor:
    return torch.linalg.solve_triangular(L.mT, A, upper=True, left=False)   # X L^T = A


def _engine(tile_impl: str, device: torch.device):
    """(potrf, trsm, update) of the engine; ``update`` may reuse C's buffer."""
    if resolve_tile_impl(tile_impl, device) == "torch":
        return _torch_potrf, _torch_trsm, update_plain
    return potrf_tile, trsm_panel, lambda C, P, Q: trailing_update(C, P, Q, out=C)


def _host_working(K, overwrite: bool) -> Tensor:
    """The host working matrix: K itself (``overwrite`` and already a
    contiguous CPU tensor of the working dtype) or a host copy."""
    K = torch.as_tensor(K)
    if K.ndim != 2 or K.shape[0] != K.shape[1]:
        raise ValueError(f"expected a square matrix, got shape {tuple(K.shape)}")
    dt = torch.float64 if K.dtype == torch.float64 else torch.float32
    if overwrite and K.device.type == "cpu" and K.dtype == dt and K.is_contiguous():
        return K
    return K.to("cpu", dt, copy=True).contiguous()


# ---------------------------------------------------------------------------
# The host-blocked factorization
# ---------------------------------------------------------------------------
def blocked_cholesky(K, block: int = 1024, *, tile_impl: str = "auto",
                     stats: FactorStats | None = None, on_step=None, device="cuda",
                     overwrite: bool = False) -> Tensor:
    """Factor a host-resident SPD matrix; return the UPPER factor T
    (A = T^T T) as a host tensor.

    ``K``: (M, M) tensor or array; its lower triangle is read. Jitter is the
    caller's job. ``device`` runs the tiles (the card unless the caller asks
    for the CPU). With ``overwrite=True`` a contiguous CPU ``K`` of the
    working dtype is factored in place and T is the view ``K.tril_().mT``.
    ``stats`` receives the residency accounting; ``on_step(stage, stats)``
    fires at the residency high-water points.
    """
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    device = torch.device(device)
    stats = stats if stats is not None else FactorStats(timing=False)
    step = on_step if on_step is not None else (lambda stage, s: None)
    potrf, trsm, update = _engine(tile_impl, device)
    W = _host_working(K, overwrite)
    dt = W.dtype
    M = W.shape[0]
    nb = -(-M // block)
    stats.begin(device)
    link = _HostLink(stats, device, dt, M * min(block, M))

    for k in range(nb):
        i0, i1 = k * block, min((k + 1) * block, M)
        stats.panels += 1
        Akk = link.put(W[i0:i1, i0:i1])
        with stats.timed("tile"):
            Lkk = potrf(Akk)
        stats.alloc(_nbytes(Lkk))
        stats.free(_nbytes(Akk))
        del Akk
        Lp = None
        if i1 < M:
            Ak = link.put(W[i1:, i0:i1])
            with stats.timed("tile"):
                Lp = trsm(Lkk, Ak)
            stats.alloc(_nbytes(Lp))
            stats.free(_nbytes(Ak))
            del Ak
            step("panel", stats)
            link.take(Lp, W[i1:, i0:i1])
        link.take(Lkk, W[i0:i1, i0:i1])
        stats.free(_nbytes(Lkk))
        del Lkk

        # Trailing update, one column block at a time: P and Q are slices of
        # the panel still on the device; each step uploads one (rows, b)
        # trailing tile and brings it back updated.
        for j in range(k + 1, nb):
            j0, j1 = j * block, min((j + 1) * block, M)
            Cj = link.put(W[j0:, j0:j1])
            with stats.timed("tile"):
                Cn = update(Cj, Lp[j0 - i1:], Lp[j0 - i1:j1 - i1])
            if Cn is not Cj:
                stats.alloc(_nbytes(Cn))
                stats.free(_nbytes(Cj))
            del Cj
            stats.tiles_updated += 1
            step("update", stats)
            link.take(Cn, W[j0:, j0:j1])
            stats.free(_nbytes(Cn))
            del Cn
        if Lp is not None:
            stats.free(_nbytes(Lp))
            del Lp

    # W's lower triangle holds L (A = L L^T); its strict upper part is stale.
    return W.tril_().mT


def blocked_syrk_tt(T, block: int = 1024, *, stats: FactorStats | None = None,
                    device="cuda") -> Tensor:
    """Host-blocked ``T T^T`` for an UPPER-triangular host factor T, under
    the same O(b * M) device-residency contract; returns a host tensor.

    Block (i, j <= i) is ``T[i0:i1, i0:] T[j0:j1, i0:]^T``: rows of T are
    supported on columns >= their index, so the contraction starts at i0.
    The panels are uploaded as columns of L = T^T (contiguous row runs when
    T is the view :func:`blocked_cholesky` returns). The product is a plain
    fp32 matmul (TF32 off), as the reference leaves it to XLA.
    """
    device = torch.device(device)
    stats = stats if stats is not None else FactorStats(timing=False)
    T = torch.as_tensor(T)
    if T.device.type != "cpu":
        T = T.cpu()
    dt = torch.float64 if T.dtype == torch.float64 else torch.float32
    L = T.mT
    M = T.shape[0]
    nb = -(-M // block)
    out = torch.empty((M, M), dtype=dt)
    stats.begin(device)
    link = _HostLink(stats, device, dt, M * min(block, M))
    with _fp32_matmul():
        for i in range(nb):
            i0, i1 = i * block, min((i + 1) * block, M)
            R = link.put(L[i0:, i0:i1])          # T[i0:i1, i0:]^T
            for j in range(i + 1):
                j0, j1 = j * block, min((j + 1) * block, M)
                S = link.put(L[i0:, j0:j1])      # T[j0:j1, i0:]^T
                with stats.timed("tile"):
                    D = R.mT @ S
                stats.alloc(_nbytes(D))
                stats.free(_nbytes(S))
                del S
                link.take(D, out[i0:i1, j0:j1])
                stats.free(_nbytes(D))
                del D
                if i != j:
                    out[j0:j1, i0:i1] = out[i0:i1, j0:j1].mT
            stats.free(_nbytes(R))
            del R
    return out


def launch_counts() -> dict[str, int]:
    """Kernel launches of B5-B7 since the last reset."""
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
