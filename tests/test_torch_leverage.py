"""The port's leverage-score centers against the JAX package's.

The packages cannot share random draws, so each stage is held on inputs
handed across as numpy: the pilot Gram against the reference's kernel on the
port's pilot rows, the scores against the reference's on the reference's
own pilot, the approximate scores against the reference's
``exact_leverage_scores``, and a leverage fit against the reference's
preconditioner and solve on the port's centers and D. The draw itself is
held to its distribution (a seeded chi-square bound). The reference's
leverage path fit is not an oracle here: its MSE bar fails for uniform
centers too (ROADMAP C.3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import enable_x64
from repro.core import build_leverage_pilot as jbuild_pilot
from repro.core import exact_leverage_scores as jexact
from repro.core import falkon_solve as jfalkon_solve
from repro.core import leverage_scores_from_pilot as jscores_from_pilot
from repro.core import make_kernel as jmake
from repro.core import make_preconditioner as jmake_preconditioner
from repro.ops import get_ops as jget_ops
from repro_torch.core import (
    FalkonConfig,
    LeveragePilot,
    approximate_leverage_scores,
    approximate_leverage_scores_path,
    build_leverage_pilot,
    exact_leverage_scores,
    falkon_fit,
    leverage_score_centers,
    leverage_scores_from_pilot,
    make_kernel,
    select_centers,
)
from repro_torch.core.nystrom import _blocked_rows

N, D, SIGMA, LAM = 400, 5, 2.0, 1e-3
#: fp32 Gram sums in different orders (K_SS entrywise, K_Sn K_nS over 4
#: row blocks): measured <= 3e-7 normwise
GRAM_TOL = 1e-6
#: scores from one pilot: fp32 solves with G = lam n K_SS + K_Sn K_nS,
#: whose error grows with G's conditioning, ~1/lam: measured 1.7e-3, 3.8e-4,
#: 4.0e-5 and 3.5e-6 at lam = 1e-4, 1e-3, 1e-2 and 1e-1; ~3x that
SCORE_TOL_TIMES_LAM = 1.2e-6
#: the fit on the port's leverage centers against the reference's solve on
#: them (tests/test_torch_falkon.py's fit bounds: alpha 3e-4, predictions
#: 1e-4; measured 2.1e-5 on predictions)
ALPHA_TOL, PRED_TOL = 3e-4, 1e-4


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


def _X(seed=0, n=N, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(dtype)


def test_pilot_grams_match_the_reference_kernel():
    """K_SS and the accumulated K_Sn K_nS of the port's pilot against the
    reference's kernel on the same rows S (block 128: four row blocks, the
    last ragged and masked)."""
    X = _X()
    pilot = build_leverage_pilot(torch.Generator().manual_seed(0), torch.from_numpy(X),
                                 make_kernel("gaussian", sigma=SIGMA), pilot_size=60,
                                 block_size=128)
    idx = pilot.indices.numpy()
    assert len(set(idx.tolist())) == 60 and pilot.n == N
    assert np.array_equal(pilot.S.numpy(), X[idx])
    jk = jmake("gaussian", sigma=SIGMA)
    S = jnp.asarray(X[idx])
    KnS = jk(jnp.asarray(X), S)
    assert rel(pilot.KSS, jk(S, S)) <= GRAM_TOL
    assert rel(pilot.KSnKnS, KnS.T @ KnS) <= GRAM_TOL
    Xb, mask = _blocked_rows(torch.from_numpy(X), 128)
    assert Xb.shape == (4, 128, D) and float(mask.sum()) == N and float(mask[3, 16:].sum()) == 0


def test_scores_from_a_carried_pilot_match_the_reference():
    """``leverage_scores_from_pilot`` on the reference's pilot, carried
    across as numpy, against the reference's scores, at four lams."""
    X = _X(1)
    jk = jmake("gaussian", sigma=SIGMA)
    jp = jbuild_pilot(jax.random.PRNGKey(3), jnp.asarray(X), jk, pilot_size=64, block_size=128)
    pilot = LeveragePilot(*(torch.from_numpy(np.array(a)) for a in
                            (jp.S, jp.KSS, jp.KSnKnS, jp.indices)), n=jp.n)
    kern = make_kernel("gaussian", sigma=SIGMA)
    for lam in (1e-4, 1e-3, 1e-2, 1e-1):
        ref = jscores_from_pilot(jp, jnp.asarray(X), jk, lam, block_size=128)
        got = leverage_scores_from_pilot(pilot, torch.from_numpy(X), kern, lam, block_size=128)
        assert got.shape == (N,) and bool((got >= 1e-12).all())
        assert rel(got, ref) <= SCORE_TOL_TIMES_LAM / lam, lam


def test_path_scores_are_the_single_lam_scores():
    """One pilot build serves the grid: each row of the path's (L, n)
    scores is bit-equal to the single-lam scores from the same draw."""
    X = torch.from_numpy(_X(2))
    kern = make_kernel("gaussian", sigma=SIGMA)
    lams = (1e-4, 1e-3, 1e-2)
    path = approximate_leverage_scores_path(torch.Generator().manual_seed(5), X, kern, lams,
                                            pilot_size=50, block_size=128)
    assert path.shape == (3, N)
    for i, lam in enumerate(lams):
        one = approximate_leverage_scores(torch.Generator().manual_seed(5), X, kern, lam,
                                          pilot_size=50, block_size=128)
        assert torch.equal(path[i], one)


def test_approximate_scores_against_the_reference_exact_scores():
    """In float64, the port's exact scores equal the reference's, and its
    approximate scores from a pilot of every row equal them up to G's
    1e-6 trace jitter (measured 1.4e-3); a pilot of 300 rows keeps the reference's own
    q-approximation test (median ratio in (0.2, 5), correlation > 0.9)."""
    X = _X(3, dtype=np.float64)
    kern = make_kernel("gaussian", sigma=SIGMA)
    with enable_x64(True):
        exact = np.asarray(jexact(jnp.asarray(X), jmake("gaussian", sigma=SIGMA), LAM))
    Xt = torch.from_numpy(X)
    assert rel(exact_leverage_scores(Xt, kern, LAM), exact) <= 1e-10
    full = approximate_leverage_scores(torch.Generator().manual_seed(0), Xt, kern, LAM,
                                       pilot_size=N, block_size=128)
    assert rel(full, exact) <= 5e-3
    part = approximate_leverage_scores(torch.Generator().manual_seed(0), Xt, kern, LAM,
                                       pilot_size=300, block_size=128).numpy()
    ratio = part / exact
    assert 0.2 < float(np.median(ratio)) < 5.0
    assert np.corrcoef(exact, part)[0, 1] > 0.9


def test_leverage_draw_follows_its_distribution_and_weights():
    """D_jj = 1/sqrt(n p_i) for each drawn index, duplicates kept as
    repeated rows, and the draw's frequencies against p: the chi-square
    statistic of 50 categories (49 degrees of freedom) under 85.35, its
    0.999 quantile, at a fixed seed."""
    n, M = 50, 20_000
    X = torch.arange(n, dtype=torch.float32)[:, None].repeat(1, 3)
    scores = torch.linspace(0.1, 2.0, n) ** 2
    sel = leverage_score_centers(torch.Generator().manual_seed(11), X, M, scores)
    p = scores / scores.sum()
    assert sel.centers.shape == (M, 3) and sel.indices.shape == (M,)
    assert torch.equal(sel.centers[:, 0], sel.indices.float())
    torch.testing.assert_close(sel.D, 1.0 / torch.sqrt(n * p[sel.indices]))
    counts = torch.bincount(sel.indices, minlength=n).double()
    expected = M * p.double()
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 85.35, chi2
    # a zero score is never drawn
    zero = scores.clone()
    zero[7] = 0.0
    sel = leverage_score_centers(torch.Generator().manual_seed(12), X, M, zero)
    assert not bool((sel.indices == 7).any())


def test_select_centers_leverage_needs_kernel_and_lam():
    X = torch.from_numpy(_X(4))
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="kernel"):
        select_centers(g, X, 10, scheme="leverage")
    sel = select_centers(g, X, 10, kernel=make_kernel("gaussian", sigma=SIGMA), lam=LAM,
                         scheme="leverage", pilot_size=32)
    assert sel.centers.shape == (10, D) and sel.D.shape == (10,) and sel.D.dtype == X.dtype


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_leverage_fit_matches_reference_solve_on_its_centers(impl):
    """``falkon_fit(center_selection="leverage")`` on both backends against
    the reference's ``make_preconditioner`` (with the port's D) and
    ``falkon_solve`` on the port's centers. The draw keeps duplicates (58
    distinct of 64 here), and the coefficients of one row's copies are
    identifiable only as their sum, so alpha is compared summed over the
    copies of each row."""
    rng = np.random.default_rng(5)
    X = rng.standard_normal((600, D)).astype(np.float32)
    y = (np.sin(X @ rng.standard_normal(D)) + 0.05 * rng.standard_normal(600)).astype(np.float32)
    cfg = FalkonConfig(kernel_params=(("sigma", SIGMA),), lam=LAM, num_centers=64,
                       iterations=15, center_selection="leverage", pilot_size=128,
                       device="cpu", ops_impl=impl)
    est, st = falkon_fit(0, X, y, cfg)
    assert st.precond.D is not None and st.precond.D.shape == (64,)
    C, Dv = st.centers.numpy(), st.precond.D.numpy()
    jk = jmake("gaussian", sigma=SIGMA)
    jops = jget_ops("jnp", jk)
    jP = jmake_preconditioner(jops.gram(jnp.asarray(C), jnp.asarray(C)), LAM, 600,
                              D=jnp.asarray(Dv))
    jst = jfalkon_solve(jnp.asarray(X), jnp.asarray(y), jnp.asarray(C), jP, jk, LAM, 15,
                        ops=jops)
    assert rel(st.precond.T, jP.T) <= 1e-5 and rel(st.precond.A, jP.A) <= 1e-5
    rows, inverse = np.unique(C, axis=0, return_inverse=True)
    assert len(rows) < 64      # duplicates, kept as repeated rows

    def summed(a):
        out = np.zeros(len(rows))
        np.add.at(out, inverse.ravel(), np.asarray(a, np.float64))
        return out

    assert rel(summed(st.alpha), summed(jst.alpha)) <= ALPHA_TOL
    Xn = rng.standard_normal((100, D)).astype(np.float32)
    assert rel(est.predict(Xn), jops.apply(jnp.asarray(Xn), jnp.asarray(C), jst.alpha)) <= PRED_TOL
    mse = float(torch.mean((est.predict(X) - torch.from_numpy(y)) ** 2))
    assert mse < 0.5 * float(np.var(y)), mse
