"""The plain reference on the CPU at a tiny size: its kernel blocks,
sweep and prediction against dense NumPy, and its FALKON against a direct
dense solve of the same Nystrom system, and its rows and center rule."""
import numpy as np
import pytest
import torch

from bench.reference import data
from bench.reference import falkon as ref

CFG = {"task": "regression", "n": 1500, "n_test": 200, "d": 5, "sigma": 1.5,
       "lam": 1e-3, "num_centers": 80, "iterations": 60, "noise": 0.1,
       "target_offset": 0.0, "estimate_cond": True}


def dense_kernel(A, B, sigma):
    d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
    return np.exp(-d2 / (2 * sigma ** 2))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_kernel_sweep_and_apply_against_dense_numpy(monkeypatch):
    monkeypatch.setattr(ref, "BLOCK_BYTES", 8 * 80 * 7)   # 7-row blocks
    g = torch.Generator().manual_seed(0)
    X = torch.randn(50, 4, generator=g, dtype=torch.float64)
    C = torch.randn(9, 4, generator=g, dtype=torch.float64)
    u = torch.randn(9, generator=g, dtype=torch.float64)
    v = torch.randn(50, generator=g, dtype=torch.float64)
    K = dense_kernel(X.numpy(), C.numpy(), 1.3)
    gamma = 0.5 / 1.3 ** 2
    np.testing.assert_allclose(ref.gram(C, gamma, ref.REFERENCE).numpy(),
                               dense_kernel(C.numpy(), C.numpy(), 1.3), rtol=1e-12)
    np.testing.assert_allclose(ref.sweep(X, C, u, v, gamma, ref.REFERENCE).numpy(),
                               K.T @ (K @ u.numpy() + v.numpy()), rtol=1e-11)
    np.testing.assert_allclose(ref.sweep(X, C, None, v, gamma, ref.REFERENCE).numpy(),
                               K.T @ v.numpy(), rtol=1e-11)
    p, s = ref.apply(X, C, u, gamma, ref.REFERENCE, absolute=True)
    np.testing.assert_allclose(p.numpy(), K @ u.numpy(), rtol=1e-11)
    np.testing.assert_allclose(s.numpy(), K @ np.abs(u.numpy()), rtol=1e-11)


def test_falkon_matches_a_direct_nystrom_solve():
    """At a regularizer where 60 CG steps converge, Alg. 1's alpha solves
    (K_nM^T K_nM + lam n (K_MM + eps M I)) alpha = K_nM^T y."""
    X, y, _, _ = data.make_split(5, CFG, "cpu")
    idx = data.center_indices(9, X.shape[0], CFG["num_centers"], "cpu")
    out = ref.fit(X, y, idx, CFG)
    Xn, yn = X.double().numpy(), y.double().numpy()
    C = Xn[idx.numpy()]
    Knm = dense_kernel(Xn, C, CFG["sigma"])
    M, n = C.shape[0], Xn.shape[0]
    Kmm = dense_kernel(C, C, CFG["sigma"]) + ref.jitter(M) * np.eye(M)
    H = Knm.T @ Knm + CFG["lam"] * n * Kmm
    alpha = np.linalg.solve(H, Knm.T @ yn)
    np.testing.assert_allclose(Knm @ out["alpha"].numpy(), Knm @ alpha, rtol=1e-7, atol=1e-8)
    T, A = out["T"].numpy(), out["A"].numpy()
    np.testing.assert_allclose(T.T @ T, Kmm, atol=1e-12)
    np.testing.assert_allclose(A.T @ A, T @ T.T / M + CFG["lam"] * np.eye(M), atol=1e-12)


def test_cond_follows_the_power_iteration_on_the_dense_operator():
    """cond(W) by the program's rule (12 power steps from 1/sqrt(M) on W,
    then on lam_max I - W) on W = A^-T T^-T (K_nM^T K_nM / n + lam T^T T)
    T^-1 A^-1 built densely in NumPy, and the 2 x 13 sweeps it takes."""
    cfg = {**CFG, "iterations": 5}
    X, y, _, _ = data.make_split(6, cfg, "cpu")
    idx = data.center_indices(4, X.shape[0], cfg["num_centers"], "cpu")
    out = ref.fit(X, y, idx, cfg, cond=True, record={0, 5, 6, 31})
    assert [w.shape for _, _, w in out["sweeps"]] == [(80,)] * 4
    T, A = out["T"].numpy(), out["A"].numpy()
    Knm = dense_kernel(X.double().numpy(), X.double().numpy()[idx.numpy()], CFG["sigma"])
    R = np.linalg.inv(T) @ np.linalg.inv(A)
    W = R.T @ (Knm.T @ Knm / X.shape[0]) @ R + CFG["lam"] * np.linalg.inv(A @ A.T)

    def power(mv, q=80):
        v = np.ones(q) / np.sqrt(q)
        for _ in range(12):
            w = mv(v)
            v = w / np.linalg.norm(w)
        return v @ mv(v)

    lam_max = power(lambda v: W @ v)
    lam_min = lam_max - power(lambda v: lam_max * v - W @ v)
    assert out["cond"] == pytest.approx(abs(lam_max / lam_min), rel=1e-7)
    assert len(ref.fit(X, y, idx, cfg, cond=True, record=range(100))["sweeps"]) == 1 + 5 + 26


def test_residuals_read_zero_on_exact_factors_and_grow_with_an_error():
    X, _, _, _ = data.make_split(3, CFG, "cpu")
    C = X[:60].double()
    gamma = 0.5 / CFG["sigma"] ** 2
    K = ref.gram(C, gamma, ref.REFERENCE) + ref.jitter(60) * torch.eye(60, dtype=torch.float64)
    T = torch.linalg.cholesky(K).mT
    assert ref.factor_residual(T, C, CFG, cols=7) < 1e-14
    S = T @ T.mT / 60 + 1e-3 * torch.eye(60, dtype=torch.float64)
    A = torch.linalg.cholesky(S).mT
    assert ref.precond_residual(T, A, 1e-3, "cpu", cols=7) < 1e-14
    assert ref.factor_residual(T * (1 + 1e-4), C, CFG) > 1e-4
    assert ref.precond_residual(T, A * (1 + 1e-4), 1e-3, "cpu") > 1e-4


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11 + 2.0 ** -13, 1.0 + 2.0 ** -12,
                      -3.0 - 2.0 ** -9])
    got = ref.round_tf32(x).tolist()
    assert got == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0, -3.0 - 2.0 ** -9]


def test_rows_and_centers_repeat_from_the_seed():
    a = data.make_split(2**31 + 17, CFG, "cpu")
    b = data.make_split(2**31 + 17, CFG, "cpu")
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    i = data.center_indices(2**40 + 1, 1500, 80, "cpu")
    assert torch.equal(i, data.center_indices(2**40 + 1, 1500, 80, "cpu"))
    assert len(set(i.tolist())) == 80
