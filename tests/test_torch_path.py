"""The port's lam path (``PreconditionerPath``, ``falkon_solve_path``,
``falkon_fit_path``) against the JAX package's.

Centers cannot share a seed across frameworks, so the reference's K_MM and
path preconditioner are handed to the port (``repro_torch.convert``) and
both packages solve on the same numpy X, y and centers. Errors are normwise
relative; the bounds are the worst case measured on a CPU with ~3x
headroom (both packages round fp32 sums in different orders, and CG and the
triangular solves amplify that by the system's conditioning). Under bf16
the CG iterates round at eps_bf16 ~ 3.9e-3 in both packages, so there the
policy's documented 1e-2 is the bound, as in the reference's own
``tests/test_lambda_path.py``.
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_kernel as jmake
from repro.core import make_preconditioner_path as jmake_path
from repro.core.falkon import _score_path as jscore_path
from repro.core.falkon import falkon_solve_path as jsolve_path
from repro.ops import get_ops as jget_ops
from repro_torch.convert import preconditioner_path_from_numpy
from repro_torch.core import (
    FalkonConfig,
    PreconditionerPath,
    falkon_fit,
    falkon_fit_path,
    falkon_solve_path,
    make_kernel,
    make_preconditioner,
    make_preconditioner_path,
)
from repro_torch.core import falkon as tfalkon
from repro_torch.data.synthetic import PAPER_TASKS, make_kernel_dataset
from repro_torch.kernels.blocked_cholesky import FactorStats
from repro_torch.ops import CountingOps, FactorPlanWarning, get_ops

N, D, M, T_ITERS = 384, 5, 48, 10
SIGMA = 2.0
#: an L = 8 grid from 1e-4 to 1e-1, the reference's test grid
LAMS = tuple(float(10.0**e) for e in np.linspace(-4.0, -1.0, 8))
#: factors and maps of one K_MM in different fp32 orders (the reference's
#: blocked-vs-in-core bound is 1e-5)
FACTOR_TOL = 1e-5
#: the solve against the reference's on its own factors (grid 1e-3 to 1e-1,
#: jitter 1e-5): alpha normwise over the stack (each lam: 2x that) and the
#: residual history; fp32 measured <= 1.4e-4 and 4.3e-6, bf16 <= 6.7e-3
#: (the policy's 1e-2) and 6.7e-4
SOLVE_TOL = {"fp32": dict(alpha=5e-4, res=2e-5), "bf16": dict(alpha=1e-2, res=2e-3)}
#: the path against L sequential fits of the same port (the reference's
#: acceptance bounds, tests/test_lambda_path.py)
REL_TOL = {"fp32": 1e-4, "bf16": 1e-2}


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


def _problem(seed=0, n=N, p=1):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, D)).astype(np.float32)
    W = rng.standard_normal((D, p))
    Y = (np.sin(X @ W) + 0.05 * rng.standard_normal((n, p))).astype(np.float32)
    return X, (Y[:, 0] if p == 1 else Y)


def _centers(X, seed=1):
    idx = np.random.default_rng(seed).choice(X.shape[0], M, replace=False)
    return X[idx]


def _gram(C, kind="gaussian", params=(("sigma", SIGMA),)):
    return np.array(jget_ops("jnp", jmake(kind, **dict(params))).gram(jnp.asarray(C),
                                                                      jnp.asarray(C)))


def _to_numpy(P):
    return {f: None if getattr(P, f) is None else np.asarray(getattr(P, f))
            for f in ("T", "A", "Q", "D", "lams", "n")} | {"diag_T": P.diag_T}


# ---------------------------------------------------------------------------
# The path preconditioner
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rank_deficient,route,with_D", [
    (False, "incore", False), (True, "incore", False), (False, "incore", True),
    (False, "blocked", False), (False, "blocked", True)])
@pytest.mark.filterwarnings("ignore::repro.ops.FactorPlanWarning")
@pytest.mark.filterwarnings("ignore::repro_torch.ops.FactorPlanWarning")
def test_preconditioner_path_matches_reference(rank_deficient, route, with_D):
    """T, the A stack and the maps of the port's path preconditioner against
    the reference's on one K_MM: a gaussian K_MM (ragged M = 333 over
    256-wide tiles on the blocked route, jitter 0.1 as the reference's
    blocked tests), or, for ``rank_deficient``, the linear kernel's rank-7
    K_MM with rank_tol 1e-3, well clear of its fp32 noise eigenvalues. Its
    eigenvectors are defined up to sign, so there Q Q^T and the maps that
    do not depend on the signs (ridge, right o left, right o expand_rhs) are
    compared. The blocked route runs L = 8 >= 3 lams: each must factor its
    own copy of T T^T, so each A[l] is also held against the in-core
    single-lam factor."""
    C = np.random.default_rng(3).standard_normal((333, 7)).astype(np.float32)
    K = _gram(C, "linear", (("scale", 1.0),)) if rank_deficient else _gram(C)
    Dv = np.random.default_rng(5).uniform(0.5, 1.5, 333).astype(np.float32) if with_D else None
    kw = dict(jitter=0.1, rank_deficient=rank_deficient, rank_tol=1e-3, factor_plan=route)
    ref = jmake_path(jnp.asarray(K), LAMS, 1000, D=None if Dv is None else jnp.asarray(Dv), **kw)
    stats = FactorStats()
    Dt = None if Dv is None else torch.from_numpy(Dv)
    got = make_preconditioner_path(torch.from_numpy(K), LAMS, 1000, D=Dt, factor_stats=stats,
                                   **kw)
    assert isinstance(got, PreconditionerPath) and got.L == len(LAMS)
    assert rel(got.T, ref.T) < FACTOR_TOL and rel(got.A, ref.A) < FACTOR_TOL
    assert got.diag_T == rank_deficient
    if rank_deficient:
        assert int((got.Q.abs().sum(0) > 0).sum()) == 7
        assert rel(got.Q @ got.Q.T, ref.Q @ ref.Q.T) < FACTOR_TOL
    assert torch.equal(got.lams, torch.tensor(LAMS, dtype=torch.float32))
    blocked = route == "blocked"
    assert stats.host_copy_bytes == (len(LAMS) - 1) * 333 * 333 * 4 * blocked
    for i, lam in enumerate(LAMS):
        single = make_preconditioner(torch.from_numpy(K), lam, 1000, D=Dt, jitter=0.1,
                                     rank_deficient=rank_deficient, rank_tol=1e-3,
                                     factor_plan="incore")
        assert rel(got.A[i], single.A) < FACTOR_TOL, (i, lam)
        assert rel(got.system(i).A, ref.system(i).A) < FACTOR_TOL
    # the maps on stacked (q, L*p) blocks, p = 2
    rng = np.random.default_rng(9)
    U = rng.standard_normal((got.q, 2 * len(LAMS))).astype(np.float32)
    Wm = rng.standard_normal((333, 2 * len(LAMS))).astype(np.float32)
    w = rng.standard_normal((333, 2)).astype(np.float32)
    Ut, Wt, wt = torch.from_numpy(U), torch.from_numpy(Wm), torch.from_numpy(w)
    jU, jW, jw = jnp.asarray(U), jnp.asarray(Wm), jnp.asarray(w)
    pairs = [(got.ridge(Ut), ref.ridge(jU)), (got.split(Wt), ref.split(jW)),
             (got.right(got.left(Wt)), ref.right(ref.left(jW))),
             (got.right(got.expand_rhs(wt)), ref.right(ref.expand_rhs(jw)))]
    if not rank_deficient:
        pairs += [(got.right(Ut), ref.right(jU)), (got.left(Wt), ref.left(jW)),
                  (got.coeffs(Ut), ref.coeffs(jU)), (got.expand_rhs(wt), ref.expand_rhs(jw))]
    for got_v, ref_v in pairs:
        assert rel(got_v, ref_v) < 5 * FACTOR_TOL


def test_expand_rhs_is_left_of_the_repeated_rhs_and_grid_guards():
    """``expand_rhs(w)`` is ``left`` of w repeated once per system (the
    shared half applied once), for (M,) and (M, p) w; an empty, 2-D or
    non-positive grid is refused, as the reference refuses it."""
    X, _ = _problem()
    K = torch.from_numpy(_gram(_centers(X)))
    P = make_preconditioner_path(K, LAMS, N, D=torch.linspace(0.5, 1.5, M))
    rng = np.random.default_rng(2)
    for shape in ((M,), (M, 3)):
        w = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        w2 = w[:, None] if w.ndim == 1 else w
        torch.testing.assert_close(P.expand_rhs(w), P.left(w2.repeat(1, P.L)),
                                   rtol=1e-5, atol=1e-6)
    for bad in ((), (1e-3, 0.0), (1e-3, -1e-2), ((1e-3, 1e-2),)):
        with pytest.raises(ValueError):
            make_preconditioner_path(K, bad, N)
    for bad in ((), (1e-3, 0.0)):
        with pytest.raises(ValueError, match="lam"):
            tfalkon._check_lams(bad)
    Xv, yv = _problem(seed=4)
    cfg = FalkonConfig(num_centers=M, iterations=2, device="cpu")
    with pytest.raises(ValueError, match="together"):
        falkon_fit_path(0, Xv, yv, cfg, LAMS, X_val=Xv)


# ---------------------------------------------------------------------------
# The path solve and its scoring
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("p", [1, 3])
def test_solve_path_matches_reference(impl, precision, p):
    """``falkon_solve_path`` on the reference's centers and path factors,
    carried across as numpy, against the reference's ``falkon_solve_path``
    on its "jnp" backend: L * p = 12 stacked columns (L = 12 at p = 1,
    L = 4 at p = 3), three column groups on the "cuda" backend. The grid
    starts at 1e-3: below it (1e-4, default jitter) the reference's own
    path and single-lam solves stand 1e-2 apart in fp32, which would hide
    a fault of the stacking."""
    X, Y = _problem(seed=p, p=p)
    C = _centers(X)
    L = 12 // p
    lams = tuple(float(10.0**e) for e in np.linspace(-3.0, -1.0, L))
    jkern = jmake("gaussian", sigma=SIGMA)
    jP = jmake_path(jnp.asarray(_gram(C)), lams, N, jitter=1e-5)
    jst = jsolve_path(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(C), jP, T_ITERS,
                      ops=jget_ops("jnp", jkern, precision=precision))
    P = preconditioner_path_from_numpy(_to_numpy(jP), device="cpu")
    ops = get_ops(impl, make_kernel("gaussian", sigma=SIGMA), precision=precision)
    st = falkon_solve_path(torch.from_numpy(X), torch.from_numpy(Y), torch.from_numpy(C), P,
                           T_ITERS, ops=ops)
    assert st.alphas.shape == jst.alphas.shape == ((L, M) if p == 1 else (L, M, p))
    assert st.residual_norms.shape == (T_ITERS + 1, L * p)
    assert st.beta.dtype == (torch.bfloat16 if precision == "bf16" else torch.float32)
    tol = SOLVE_TOL[precision]
    assert rel(st.residual_norms, jst.residual_norms) <= tol["res"]
    assert rel(st.alphas, jst.alphas) <= tol["alpha"]
    for i in range(L):
        assert rel(st.alphas[i], jst.alphas[i]) <= 2 * tol["alpha"], i


@pytest.mark.parametrize("p", [1, 2])
def test_score_path_matches_reference(p):
    """One stacked apply of width L * p scores every lam as the reference's
    ``_score_path`` does (B2 in column groups on the "cuda" backend)."""
    X, Y = _problem(seed=6, p=p)
    C = _centers(X)
    rng = np.random.default_rng(7)
    alphas = rng.standard_normal((len(LAMS), M) + ((p,) if p > 1 else ())).astype(np.float32)
    jscores, jbest = jscore_path(jget_ops("jnp", jmake("gaussian", sigma=SIGMA)),
                                 jnp.asarray(C), jnp.asarray(alphas), jnp.asarray(X),
                                 jnp.asarray(Y))
    for impl in ("torch", "cuda"):
        ops = CountingOps(get_ops(impl, make_kernel("gaussian", sigma=SIGMA)))
        scores, best = tfalkon._score_path(ops, torch.from_numpy(C), torch.from_numpy(alphas),
                                           torch.from_numpy(X), torch.from_numpy(Y))
        assert ops.applies == 1 and best == jbest
        assert rel(scores, jscores) <= 1e-5


# ---------------------------------------------------------------------------
# The path fit against L sequential fits of the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_path_matches_sequential_fits(impl, precision):
    """``falkon_fit_path`` over the L = 8 grid against L ``falkon_fit`` runs
    on the same generator seed (so the same centers), per alpha, as the
    reference's ``_assert_path_matches_sequential``; the val-selected
    estimator is the argmin of the sequential fits' val MSE."""
    X, y = _problem(seed=11, n=400)
    Xv, yv = _problem(seed=12, n=200)
    cfg = FalkonConfig(kernel_params=(("sigma", 1.0),), num_centers=64, iterations=30,
                       block_size=128, jitter=1e-5, estimate_cond=False, device="cpu",
                       ops_impl=impl, precision=precision)
    times = {}
    res = falkon_fit_path(1, X, y, cfg, LAMS, X_val=Xv, y_val=yv, stage_times=times)
    assert set(times) >= {"centers", "gram", "factor", "solve", "score", "factor_path"}
    assert len(res.estimators) == len(LAMS) and res.state.alphas.shape == (len(LAMS), 64)
    assert res.lams == LAMS
    mses = []
    for i, lam in enumerate(LAMS):
        est, _ = falkon_fit(1, X, y, dataclasses.replace(cfg, lam=lam))
        assert torch.equal(est.centers, res.estimators[i].centers)
        assert res.estimators[i].lam == lam
        r = rel(res.estimators[i].alpha, est.alpha)
        assert r <= REL_TOL[precision], f"lam={lam:.2e}: rel alpha gap {r:.2e}"
        mses.append(float(torch.mean((est.predict(Xv) - torch.from_numpy(yv)) ** 2)))
    assert res.best is res.estimators[res.best_index]
    assert rel(res.val_scores, mses) <= REL_TOL[precision]
    assert res.best_index == int(np.argmin(mses))


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_path_is_the_single_fits_in_float64(impl):
    """At SUSY's lams (1e-8 and 1e-6, on the port's synthetic SUSY task:
    d = 18, gaussian sigma 4) float32 rounding moves alpha by ~1e-3 between
    two orders of the same sums, which would hide a fault of the stacking;
    in float64 the path's beta and alpha are the single fits' to 1e-6
    (measured <= 3.6e-9 and 3.7e-8)."""
    task = PAPER_TASKS["susy"]
    X, y = make_kernel_dataset(torch.Generator().manual_seed(0), task, 3000,
                               fn_generator=torch.Generator().manual_seed(1))
    cfg = FalkonConfig(kernel_params=(("sigma", task.sigma),), num_centers=200, iterations=20,
                       estimate_cond=False, dtype="float64", device="cpu", ops_impl=impl)
    lams = (1e-8, 1e-7, 1e-6, 1e-5)
    res = falkon_fit_path(0, X, y, cfg, lams)
    for i in (0, 2):
        _, st = falkon_fit(0, X, y, dataclasses.replace(cfg, lam=lams[i]))
        assert rel(res.state.beta[:, i], st.beta) <= 1e-6, lams[i]
        assert rel(res.estimators[i].alpha, st.alpha) <= 1e-6, lams[i]


@pytest.mark.filterwarnings("ignore::repro_torch.ops.FactorPlanWarning")
def test_path_fit_on_the_blocked_factor(monkeypatch):
    """Past the factor budget the grid takes the blocked route (each lam on
    its own copy of T T^T): its A stack agrees with the in-core path's to
    FACTOR_TOL (measured <= 1.6e-7) and its alphas to 1e-3 (measured
    1.4e-4 to 2.1e-4 over 1 to 8 CPU threads: the solve amplifies the
    rounding of either route, and the BLAS's thread count changes it)."""
    X, y = _problem(seed=13, n=1500)
    cfg = FalkonConfig(kernel_params=(("sigma", 1.0),), num_centers=320, iterations=20,
                       jitter=1e-3, estimate_cond=False, device="cpu", ops_impl="cuda")
    lams = (1e-2, 3e-2, 1e-1)
    res_in = falkon_fit_path(0, X, y, cfg, lams)
    monkeypatch.setenv("REPRO_FACTOR_BUDGET_MB", "0.2")
    times = {}
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        res = falkon_fit_path(0, X, y, cfg, lams, stage_times=times)
    assert any(isinstance(w.message, FactorPlanWarning) for w in rec)
    assert (times["factor_path"], times["factor_block"]) == ("blocked", 256)
    assert times["factor_stats"].host_copy_bytes == 2 * 320 * 320 * 4
    assert rel(res.state.precond.A, res_in.state.precond.A) <= FACTOR_TOL
    assert rel(res.state.alphas, res_in.state.alphas) <= 1e-3


def test_path_sweeps_once_per_iteration_for_any_grid():
    """CountingOps: t + 1 sweeps for any L (eager counts: the RHS sweep and
    t CG sweeps; the reference's traced facade counts 2 call sites), one
    apply to score and one gram. The "cuda" planner charges the widest
    column group of a widened block."""
    X, y = _problem(seed=14)
    for L in (1, 3, 8):
        ops = CountingOps(get_ops("cuda", make_kernel("gaussian", sigma=SIGMA)))
        cfg = FalkonConfig(kernel_params=(("sigma", SIGMA),), num_centers=M,
                           iterations=T_ITERS, device="cpu")
        res = falkon_fit_path(0, X, y, cfg, LAMS[:L], X_val=X[:50], y_val=y[:50], ops=ops)
        assert (ops.sweeps, ops.applies, ops.grams) == (T_ITERS + 1, 1, 1), L
        assert res.state.residual_norms.shape == (T_ITERS + 1, L)
    ops = get_ops("cuda", make_kernel("gaussian", sigma=SIGMA))
    wide, group, one = (ops.plan(4_000_000, 10_000, 18, 1, systems=8),
                        ops.plan(4_000_000, 10_000, 18, 4), ops.plan(4_000_000, 10_000, 18, 1))
    assert wide.p == 8 and wide.systems == 8
    assert wide.io_bytes == group.io_bytes > one.io_bytes
