"""The port's baselines and K_nM delegates against the JAX package's.

The same numpy data go through ``repro.core.baselines`` / ``repro.core.matvec``
(on the reference's ``"jnp"`` backend) and their port, in float32 and in
float64 (the reference under its x64 mode). Errors are normwise relative;
bounds are the worst case measured on a CPU with ~3x headroom, or the
dtype's rounding where the arithmetic is the same. Then ``nystrom_direct``
serves as the float64 oracle a port fit converges to.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import enable_x64
from repro.core import baselines as jb
from repro.core import knm_apply as jknm_apply
from repro.core import knm_matvec as jknm_matvec
from repro.core import make_kernel as jmake
from repro_torch.core import (
    KernelPredictor,
    falkon_solve,
    knm_apply,
    knm_matvec,
    krr_direct,
    krr_gradient,
    make_kernel,
    make_preconditioner,
    nystrom_direct,
    nystrom_gradient,
)
from repro_torch.core import matvec as tmatvec
from repro_torch.ops import get_ops

N, D, M, SIGMA, LAM = 300, 4, 40, 1.5, 1e-3
#: per dtype, on alpha and predictions alike. The direct solves amplify the
#: Grams' rounding by the conditioning of the system: measured in float32
#: 3.8e-6 (krr_direct) and 3.2e-3 (nystrom_direct: an fp32 LU of H =
#: K_nM^T K_nM + lam n K_MM, whose float64 twin agrees to 6.8e-12), in
#: float64 6.7e-15 and 6.8e-12; the gradient iterations and the K_nM
#: delegates round like their sums (float32 <= 4e-7, float64 <= 6e-16).
TOL = {"float32": dict(krr_direct=2e-5, nystrom_direct=1e-2, gradient=2e-6, delegates=2e-6),
       "float64": dict(krr_direct=1e-13, nystrom_direct=1e-10, gradient=1e-14,
                       delegates=1e-14)}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for each test: its tensors are small, and beside
    the suite's other worker processes more threads only contend for the
    cores (measured: 100 s instead of 1.4 s for one path-fit test)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _data(dtype, p=1):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D)).astype(dtype)
    Y = np.sin(X @ rng.standard_normal((D, p))) + 0.05 * rng.standard_normal((N, p))
    C = X[rng.choice(N, M, replace=False)]
    return X, (Y[:, 0] if p == 1 else Y).astype(dtype), C


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_baselines_match_reference(dtype):
    """All four baselines on the same data, alpha and predictions."""
    X, y, C = _data(dtype)
    Xt, yt, Ct = (torch.from_numpy(a) for a in (X, y, C))
    kern = make_kernel("gaussian", sigma=SIGMA)
    tol = TOL[dtype]
    with enable_x64(dtype == "float64"):
        jk = jmake("gaussian", sigma=SIGMA)
        jX, jy, jC = jnp.asarray(X), jnp.asarray(y), jnp.asarray(C)
        cases = [
            (krr_direct(Xt, yt, kern, LAM), jb.krr_direct(jX, jy, jk, LAM),
             tol["krr_direct"]),
            (krr_gradient(Xt, yt, kern, LAM, 25), jb.krr_gradient(jX, jy, jk, LAM, 25),
             tol["gradient"]),
            (krr_gradient(Xt, yt, kern, LAM, 10, tau=5.0),
             jb.krr_gradient(jX, jy, jk, LAM, 10, tau=5.0), tol["gradient"]),
            (nystrom_direct(Xt, yt, Ct, kern, LAM), jb.nystrom_direct(jX, jy, jC, jk, LAM),
             tol["nystrom_direct"]),
            (nystrom_gradient(Xt, yt, Ct, kern, LAM, 25, block_size=128),
             jb.nystrom_gradient(jX, jy, jC, jk, LAM, 25, block_size=128), tol["gradient"]),
        ]
        Xn = np.random.default_rng(1).standard_normal((50, D)).astype(dtype)
        for got, ref, tol in cases:
            assert isinstance(got, KernelPredictor)
            assert got.alpha.dtype == getattr(torch, dtype)
            assert rel(got.alpha, ref.alpha) <= tol
            assert rel(got.predict(torch.from_numpy(Xn), block_size=32),
                       ref.predict(jnp.asarray(Xn))) <= tol


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("p", [1, 5])
def test_knm_delegates_match_reference(dtype, impl, p):
    """``knm_matvec`` with and without v, and ``knm_apply``, on both port
    backends (the "cuda" wrappers run their twins on CPU tensors, p = 5 in
    two column groups) against the reference's "jnp" delegates."""
    X, Y, C = _data(dtype, p)
    rng = np.random.default_rng(2)
    u = rng.standard_normal((M, p) if p > 1 else (M,)).astype(dtype)
    tol = TOL[dtype]["delegates"]
    kern = make_kernel("gaussian", sigma=SIGMA)
    Xt, Yt, Ct, ut = (torch.from_numpy(a) for a in (X, Y, C, u))
    with enable_x64(dtype == "float64"):
        jk = jmake("gaussian", sigma=SIGMA)
        jX, jY, jC, ju = (jnp.asarray(a) for a in (X, Y, C, u))
        pairs = [
            (knm_matvec(Xt, Ct, ut, None, kern, impl=impl, block_size=128),
             jknm_matvec(jX, jC, ju, None, jk, block_size=128)),
            (knm_matvec(Xt, Ct, ut, Yt, kern, impl=impl, block_size=128),
             jknm_matvec(jX, jC, ju, jY, jk, block_size=128)),
            (knm_apply(Xt, Ct, ut, kern, impl=impl), jknm_apply(jX, jC, ju, jk)),
        ]
        for got, ref in pairs:
            assert got.dtype == getattr(torch, dtype)
            assert rel(got, ref) <= tol


def test_unported_matvec_entry_points_refuse():
    for fn, item in ((tmatvec.make_knm_cache, "A11"), (tmatvec.cached_knm_matvec, "A11"),
                     (tmatvec.cached_knm_apply, "A11"), (tmatvec.streaming_knm_matvec, "A8"),
                     (tmatvec.streaming_knm_apply, "A8")):
        with pytest.raises(NotImplementedError, match=item):
            fn()


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_fit_converges_to_nystrom_direct(impl):
    """``nystrom_direct`` in float64 as the oracle: a 30-iteration float32
    FALKON solve on the same centers (the preconditioner from the backend's
    own K_MM) reaches its predictions to 1e-4 and its alpha to 5e-4
    (measured 1.6e-5 to 2.3e-5 and 8.0e-5 to 1.3e-4 over 1 and 8 CPU
    threads), while 3 iterations stay far from it (measured 0.2)."""
    X, y, C = _data("float32")
    kern = make_kernel("gaussian", sigma=SIGMA)
    oracle = nystrom_direct(*(torch.from_numpy(a).double() for a in (X, y, C)), kern, LAM,
                            jitter=0.0)
    Xt, yt, Ct = (torch.from_numpy(a) for a in (X, y, C))
    ops = get_ops(impl, kern)
    P = make_preconditioner(ops.gram(Ct, Ct), LAM, N, jitter=1e-6)
    Xn = torch.from_numpy(np.random.default_rng(3).standard_normal((100, D)).astype(np.float32))
    ref = oracle.predict(Xn.double())
    for t, far in ((30, False), (3, True)):
        st = falkon_solve(Xt, yt, Ct, P, kern, LAM, t, ops=ops, estimate_cond=False)
        pred = ops.apply(Xn, Ct, st.alpha)
        if far:
            assert rel(pred, ref) > 1e-2
        else:
            assert rel(pred, ref) <= 1e-4 and rel(st.alpha, oracle.alpha) <= 5e-4
