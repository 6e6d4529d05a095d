"""CG and the preconditioner against the JAX package on the same inputs.

Errors are normwise, ||got - ref|| / ||ref||: both packages run fp32 with
reductions and triangular solves that round in different orders, and the
rounding scales with the whole vector, not with each entry. CG on a 48 x 48
SPD system with condition number 1e2 runs 15 iterations: iterates within
1e-5. The factors come from one K_MM through the two frameworks' Cholesky /
eigh: within 1e-5. Maps applied to the SAME factors: within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cg as jcg
from repro.core import kernels as jk
from repro.core import preconditioner as jpc
from repro_torch.convert import preconditioner_from_numpy
from repro_torch.core import cg as tcg
from repro_torch.core import preconditioner as tpc
from repro_torch.ops import FactorPlanWarning

ITER_TOL = FACTOR_TOL = MAP_TOL = 1e-5


def assert_close(got, ref, bound, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)
    assert err <= bound, (what, err, bound)


def _spd(q=48, cond=1e2, seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((q, q)))
    s = np.geomspace(1.0, 1.0 / cond, q)
    return ((Q * s) @ Q.T).astype(np.float32), rng


@pytest.mark.parametrize("p", [None, 3])
@pytest.mark.parametrize("tol", [0.0, 1e-2])
def test_cg_matches_reference(p, tol):
    A, rng = _spd()
    b = rng.standard_normal((48,) if p is None else (48, p)).astype(np.float32)
    ref = jcg.conjugate_gradient(lambda x: jnp.asarray(A) @ x, jnp.asarray(b), 15, tol=tol)
    At = torch.from_numpy(A)
    got = tcg.conjugate_gradient(lambda x: At @ x, torch.from_numpy(b), 15, tol=tol)
    assert tuple(got.residual_norms.shape) == tuple(ref.residual_norms.shape)
    assert got.residual_norms.shape[0] == 16          # always t + 1 entries
    assert_close(got.x.numpy(), np.asarray(ref.x), ITER_TOL)
    assert_close(got.residual_norms.numpy(), np.asarray(ref.residual_norms), ITER_TOL)
    assert int(got.iterations) == int(ref.iterations)


def test_cg_fixed_driver_spends_every_matvec_and_host_driver_stops():
    A, rng = _spd(cond=4.0)
    b = rng.standard_normal((48, 2)).astype(np.float32)
    At = torch.from_numpy(A)
    calls = []

    def mv(x):
        calls.append(1)
        return At @ x

    fixed = tcg.conjugate_gradient(mv, torch.from_numpy(b), 30, tol=1e-3)
    assert len(calls) == 30                         # masked, never skipped
    calls.clear()
    host = tcg.conjugate_gradient_host(mv, torch.from_numpy(b), 30, tol=1e-3)
    ref = jcg.conjugate_gradient_host(lambda x: jnp.asarray(A) @ x, jnp.asarray(b), 30,
                                      tol=1e-3)
    assert int(host.iterations) == int(ref.iterations) == len(calls) < 30
    assert host.residual_norms.shape[0] == int(host.iterations) + 1
    assert_close(host.x.numpy(), np.asarray(ref.x), ITER_TOL)
    assert_close(fixed.x.numpy(), host.x.numpy(), ITER_TOL)
    assert int(fixed.iterations) == int(host.iterations)
    x0 = torch.ones(48, 2)
    calls.clear()
    tcg.conjugate_gradient(mv, torch.from_numpy(b), 3, x0=x0)
    assert len(calls) == 4                          # x0 costs one matvec


def test_col_dot_and_active_columns():
    u = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    torch.testing.assert_close(tcg.col_dot(u, u), torch.tensor([10.0, 20.0]))
    act = tcg.active_columns(torch.tensor([0.0, 1e-40, 1.0]), torch.tensor(0.0))
    assert act.tolist() == [False, False, True]


def _kmm(M=40, d=4, seed=1, dup=0, sigma=2.0):
    rng = np.random.default_rng(seed)
    C = rng.standard_normal((M, d)).astype(np.float32)
    if dup:
        C[-dup:] = C[:dup]                          # rank-deficient K_MM
    K = np.array(jk.make_kernel("gaussian", sigma=sigma)(jnp.asarray(C), jnp.asarray(C)))
    return K, rng


@pytest.mark.parametrize("branch", ["cholesky", "cholesky_D", "eig"])
def test_preconditioner_matches_reference(branch):
    # the eig branch: 6 duplicated centers give 6 zero eigenvalues; sigma 0.7
    # keeps the smallest kept one 2.6e-2 of the largest, far above the fp32
    # noise of the zero ones, so both packages keep the same eigenspace
    eig = branch == "eig"
    K, rng = _kmm(dup=6, sigma=0.7) if eig else _kmm()
    M = K.shape[0]
    D = rng.uniform(0.5, 2.0, M).astype(np.float32) if branch == "cholesky_D" else None
    kw = dict(rank_deficient=eig, rank_tol=1e-5 if eig else 1e-7)
    lam, n = 1e-3, 500
    ref = jpc.make_preconditioner(jnp.asarray(K), lam, n,
                                  D=None if D is None else jnp.asarray(D), **kw)
    got = tpc.make_preconditioner(torch.from_numpy(K), lam, n,
                                  D=None if D is None else torch.from_numpy(D), **kw)
    assert got.diag_T == ref.diag_T
    assert_close(got.T.numpy(), np.asarray(ref.T), FACTOR_TOL)
    assert_close(got.A.numpy(), np.asarray(ref.A), FACTOR_TOL)
    if branch == "eig":
        # eigenvectors are defined up to sign: compare the kept projector
        Qg, Qr = got.Q.numpy(), np.asarray(ref.Q)
        assert_close(Qg @ Qg.T, Qr @ Qr.T, FACTOR_TOL)
        assert int((np.abs(Qg).sum(0) > 0).sum()) == M - 6

    # the maps, on the SAME factors handed across
    fields = dict(T=np.asarray(ref.T), A=np.asarray(ref.A), n=np.asarray(ref.n),
                  diag_T=ref.diag_T)
    if ref.Q is not None:
        fields["Q"] = np.asarray(ref.Q)
    if ref.D is not None:
        fields["D"] = np.asarray(ref.D)
    P = preconditioner_from_numpy(fields)
    q = P.q
    u = rng.standard_normal((q, 3)).astype(np.float32)
    w = rng.standard_normal((M, 3)).astype(np.float32)
    for uu, ww in ((u, w), (u[:, 0].copy(), w[:, 0].copy())):
        ut, wt, uj, wj = torch.from_numpy(uu), torch.from_numpy(ww), jnp.asarray(uu), jnp.asarray(ww)
        for name, a_t, a_j in (("right", ut, uj), ("left", wt, wj), ("coeffs", ut, uj),
                               ("beta_of_coeffs", wt, wj)):
            assert_close(getattr(P, name)(a_t).numpy(), np.asarray(getattr(ref, name)(a_j)),
                         MAP_TOL, name)
        assert_close(P.ridge(ut, lam).numpy(), np.asarray(ref.ridge(uj, lam)), MAP_TOL)


def test_coeffs_inverts_beta_of_coeffs_full_rank():
    K, rng = _kmm()
    P = tpc.make_preconditioner(torch.from_numpy(K), 1e-3, 100)
    alpha = torch.from_numpy(rng.standard_normal(K.shape[0]).astype(np.float32))
    torch.testing.assert_close(P.coeffs(P.beta_of_coeffs(alpha)), alpha, rtol=1e-4, atol=1e-4)


def test_factor_past_budget_refuses(monkeypatch):
    """A factor past the budget no longer raises: it routes to the blocked
    Cholesky, warns with the plan, and gives the in-core factors."""
    K, _ = _kmm()
    ref = tpc.make_preconditioner(torch.from_numpy(K), 1e-3, 100)
    monkeypatch.setenv("REPRO_FACTOR_BUDGET_MB", "0.001")
    with pytest.warns(FactorPlanWarning) as rec:
        P = tpc.make_preconditioner(torch.from_numpy(K), 1e-3, 100)
    assert rec[0].message.plan.path == "blocked"
    assert_close(P.T.numpy(), ref.T.numpy(), 1e-5)
    assert_close(P.A.numpy(), ref.A.numpy(), 1e-5)


def test_default_jitter_matches_reference():
    """T = chol(K + eps*M*I) with eps = finfo(float32).eps, as the reference."""
    K, _ = _kmm()
    M = K.shape[0]
    T, _, TTt, _ = tpc._shared_factor(torch.from_numpy(K), None, None, False, 1e-7)
    eps = float(jnp.finfo(jnp.float32).eps) * M
    assert_close((T.mT @ T).numpy(), K + eps * np.eye(M), 1e-6)
    torch.testing.assert_close(TTt, T @ T.mT)
