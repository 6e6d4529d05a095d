"""Plain FALKON (Rudi, Carratino, Rosasco, NIPS 2017, Alg. 1) with the
Gaussian kernel, in blocks of rows.

    C = X[centers],  K_MM = K(C, C)
    T = chol(K_MM + eps M I)          upper, K_MM + eps M I = T^T T
    A = chol(T T^T / M + lam I)       upper
    W = A^-T T^-T (K_nM^T K_nM / n) T^-1 A^-1 + lam A^-T A^-1
    b = A^-T T^-T K_nM^T y / n
    beta = t steps of conjugate gradients on W beta = b, from 0
    alpha = T^-1 A^-1 beta,   prediction K(x, C) alpha
    cond(W): 12 power steps on W from 1/sqrt(M), then on lam_max I - W

``eps`` is the configuration's ``jitter`` or, unset, the machine epsilon
of its ``dtype`` (float32 unless stated) whatever the arithmetic, as the
program's rule is stated for its type. The arithmetic is an
:class:`Arith`: float64 for the reference; float32 with TF32 matrix
products for the control (on a card by cuBLAS, on the CPU by rounding
every product's operands to TF32's 10 mantissa bits).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

Tensor = torch.Tensor

#: bytes of one block of kernel entries
BLOCK_BYTES = 2 ** 31


@contextlib.contextmanager
def _tf32(on: bool):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def round_tf32(a: Tensor) -> Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest."""
    bits = a.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Arith:
    """The type every quantity is held in, and whether float32 products
    run in TF32."""

    dtype: torch.dtype = torch.float64
    tf32: bool = False

    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        if self.tf32 and a.device.type == "cpu":
            return round_tf32(a) @ round_tf32(b)
        with _tf32(self.tf32):
            return a @ b


REFERENCE = Arith(torch.float64, False)
CONTROL = Arith(torch.float32, True)


def block_rows(M: int, itemsize: int) -> int:
    return max(1, min(1 << 20, BLOCK_BYTES // (itemsize * max(M, 1))))


def _augmented(C: Tensor, gamma: float) -> Tensor:
    """[C, 1, -gamma ||c||^2]: one product with ``_rows`` gives the
    exponent -gamma ||x - c||^2."""
    c2 = (C * C).sum(1, keepdim=True)
    one = torch.ones_like(c2)
    return torch.cat([C, one, -gamma * c2], dim=1)


def _rows(Xb: Tensor, gamma: float) -> Tensor:
    x2 = (Xb * Xb).sum(1, keepdim=True)
    one = torch.ones_like(x2)
    return torch.cat([2.0 * gamma * Xb, -gamma * x2, one], dim=1)


def kernel_block(Xb: Tensor, Caug: Tensor, gamma: float, ar: Arith) -> Tensor:
    """exp(-gamma ||x - c||^2) for the rows of Xb against the centers of
    ``Caug`` (``_augmented``)."""
    return ar.mm(_rows(Xb, gamma), Caug.T).exp_()


def sweep(X: Tensor, C: Tensor, u: Tensor | None, v: Tensor | None, gamma: float,
          ar: Arith, absolute: bool = False):
    """K(X, C)^T (K(X, C) u + v); ``u=None`` is u = 0. u, v: (M,) / (n,).
    With ``absolute`` also K^T (K |u| + |v|), the scale of each entry's
    rounding (the Gaussian kernel is positive)."""
    n, M = X.shape[0], C.shape[0]
    Caug = _augmented(C, gamma)
    w = torch.zeros(M, 2 if absolute else 1, dtype=X.dtype, device=X.device)
    step = block_rows(M, X.element_size())
    for i in range(0, n, step):
        K = kernel_block(X[i:i + step], Caug, gamma, ar)
        t = torch.zeros(K.shape[0], w.shape[1], dtype=K.dtype, device=K.device)
        if u is not None:
            t += ar.mm(K, torch.stack([u, u.abs()], 1) if absolute else u[:, None])
        if v is not None:
            vi = v[i:i + step, None]
            t += torch.cat([vi, vi.abs()], 1) if absolute else vi
        w += ar.mm(K.T, t)
    return (w[:, 0], w[:, 1]) if absolute else w[:, 0]


def apply(X: Tensor, C: Tensor, alpha: Tensor, gamma: float, ar: Arith,
          absolute: bool = False) -> Tensor:
    """K(X, C) alpha; with ``absolute`` also K(X, C) |alpha|, the scale
    of each row's rounding."""
    Caug = _augmented(C, gamma)
    step = block_rows(C.shape[0], X.element_size())
    out, scale = [], []
    for i in range(0, X.shape[0], step):
        K = kernel_block(X[i:i + step], Caug, gamma, ar)
        out.append(ar.mm(K, alpha[:, None])[:, 0])
        if absolute:
            scale.append(ar.mm(K, alpha.abs()[:, None])[:, 0])
    return (torch.cat(out), torch.cat(scale)) if absolute else torch.cat(out)


def gram(C: Tensor, gamma: float, ar: Arith) -> Tensor:
    """K(C, C), filled in blocks of rows."""
    M = C.shape[0]
    Caug = _augmented(C, gamma)
    K = torch.empty(M, M, dtype=C.dtype, device=C.device)
    step = block_rows(M, C.element_size())
    for i in range(0, M, step):
        K[i:i + step] = kernel_block(C[i:i + step], Caug, gamma, ar)
    return K


def jitter(M: int, cfg: dict | None = None) -> float:
    """eps M: the configuration's ``jitter``, else its dtype's epsilon
    times M."""
    cfg = cfg or {}
    if cfg.get("jitter") is not None:
        return float(cfg["jitter"])
    return float(torch.finfo(getattr(torch, cfg.get("dtype", "float32"))).eps) * M


def solve_upper(U: Tensor, v: Tensor) -> Tensor:
    return torch.linalg.solve_triangular(U, v[:, None], upper=True)[:, 0]


def solve_lower(L: Tensor, v: Tensor) -> Tensor:
    return torch.linalg.solve_triangular(L, v[:, None], upper=False)[:, 0]


def power(mv, q: int, like: Tensor, iters: int = 12) -> Tensor:
    """The Rayleigh quotient after ``iters`` power steps from 1/sqrt(q)."""
    v = torch.ones(q, dtype=like.dtype, device=like.device) / math.sqrt(q)
    for _ in range(iters):
        w = mv(v)
        v = w / torch.clamp(torch.linalg.norm(w), min=1e-30)
    return torch.dot(v, mv(v))


def fit(X: Tensor, y: Tensor, centers: Tensor, cfg: dict, ar: Arith = REFERENCE,
        record=frozenset(), cond: bool = False) -> dict:
    """Alg. 1 on rows X (n, d), targets y (n,) and the center indices
    ``centers``; returns alpha, the centers C and the factors T and A at
    ``ar.dtype``, the CG residual norms ||r_0|| .. ||r_t||, with ``cond``
    the cond(W) estimate (its 2 x (12 + 1) sweeps after the CG's), and
    (u, v, w) of the sweeps whose numbers in call order (0: the
    right-hand side's) are in ``record``."""
    gamma = 0.5 / cfg["sigma"] ** 2
    lam, t = cfg["lam"], cfg["iterations"]
    X = X.to(ar.dtype)
    y = y.to(ar.dtype)
    C = X[centers]
    n, M = X.shape[0], C.shape[0]
    K = gram(C, gamma, ar)
    K.diagonal().add_(jitter(M, cfg))
    L = torch.linalg.cholesky(K)               # T = L^T
    del K
    S = ar.mm(L.mT, L)                          # T T^T
    S /= M
    S.diagonal().add_(lam)
    LA = torch.linalg.cholesky(S)               # A = LA^T
    del S
    T, A = L.mT, LA.mT
    calls, kept = [0], []

    def sweep_(u, v):
        w = sweep(X, C, u, v, gamma, ar)
        if calls[0] in record:
            kept.append((torch.zeros_like(w) if u is None else u, v, w))
        calls[0] += 1
        return w

    def right(u):                               # T^-1 A^-1 u
        return solve_upper(T, solve_upper(A, u))

    def left(w):                                # A^-T T^-T w
        return solve_lower(LA, solve_lower(L, w))

    def W(u):
        w = sweep_(right(u), None) / n
        return left(w) + lam * solve_lower(LA, solve_upper(A, u))

    b = left(sweep_(None, y) / n)
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rs = torch.dot(r, r)
    res = [rs.sqrt()]
    for _ in range(t):
        Ap = W(p)
        a = rs / torch.dot(p, Ap)
        x += a * p
        r -= a * Ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new
        res.append(rs.sqrt())
    out = {"alpha": right(x), "C": C, "T": T, "A": A, "res": torch.stack(res).tolist(),
           "sweeps": kept}
    if cond:
        lam_max = power(W, M, b)
        lam_min = lam_max - power(lambda v: lam_max * v - W(v), M, b)
        out["cond"] = float(lam_max.abs() / torch.clamp(lam_min.abs(), min=1e-30))
    return out


def solve_residual(X: Tensor, y: Tensor, C: Tensor, alpha: Tensor, T: Tensor, A: Tensor,
                   cfg: dict, preconditioned: bool = True) -> float:
    """How far ``alpha`` is from solving the Nystrom system H alpha = g,
    H = K_nM^T K_nM / n + lam T^T T, g = K_nM^T y / n, in float64, for the
    reference's factors T and A (T^T T = K_MM + eps M I): ||H alpha - g|| /
    ||g||, or with ``preconditioned`` in Alg. 1's norm, ||A^-T T^-T (H alpha
    - g)|| / ||A^-T T^-T g||. A sound solve reads its CG residual; a wrong
    or perturbed one reads the perturbation."""
    gamma = 0.5 / cfg["sigma"] ** 2
    X, y = X.to(torch.float64), y.to(torch.float64)
    C, alpha = C.to(torch.float64), alpha.to(torch.float64)
    n = X.shape[0]

    def left(w):
        return solve_lower(A.mT, solve_lower(T.mT, w)) if preconditioned else w

    g = left(sweep(X, C, None, y, gamma, REFERENCE) / n)
    h = sweep(X, C, alpha, -y, gamma, REFERENCE) / n + cfg["lam"] * (T.mT @ (T @ alpha))
    return float(torch.linalg.norm(left(h)) / torch.linalg.norm(g))


def _to_float64(a: Tensor, device) -> Tensor:
    """A (host) float32 tensor on ``device`` in float64, converted there."""
    return a.to(device).to(torch.float64)


def factor_residual(T: Tensor, C: Tensor, cfg: dict, cols: int | None = None) -> float:
    """||T^T T - (K(C, C) + eps M I)||_F / ||K(C, C) + eps M I||_F in
    float64, for an upper-triangular factor T that another program made."""
    gamma = 0.5 / cfg["sigma"] ** 2
    dev = C.device
    C = C.to(torch.float64)
    T = _to_float64(T, dev)
    M = C.shape[0]
    Caug = _augmented(C, gamma)
    cols = cols or block_rows(M, 8)
    num = den = 0.0
    for j in range(0, M, cols):
        Kj = kernel_block(C[j:j + cols], Caug, gamma, REFERENCE).T   # (M, c)
        Kj[j:j + cols].diagonal().add_(jitter(M, cfg))
        den += float((Kj * Kj).sum())
        Kj -= T.mT @ T[:, j:j + cols]
        num += float((Kj * Kj).sum())
    return math.sqrt(num / den)


def precond_residual(T: Tensor, A: Tensor, lam: float, device,
                     cols: int | None = None) -> float:
    """||A^T A - (T T^T / M + lam I)||_F / ||T T^T / M + lam I||_F in
    float64, for the factors T and A that another program made."""
    T = _to_float64(T, device)
    A = _to_float64(A, device)
    M = T.shape[0]
    cols = cols or block_rows(M, 8)
    num = den = 0.0
    for j in range(0, M, cols):
        S = T @ T[j:j + cols].mT
        S /= M
        S[j:j + cols].diagonal().add_(lam)
        den += float((S * S).sum())
        S -= A.mT @ A[:, j:j + cols]
        num += float((S * S).sum())
    return math.sqrt(num / den)
