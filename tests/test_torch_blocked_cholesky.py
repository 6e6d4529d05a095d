"""The port's blocked out-of-core Cholesky against the JAX package's.

The same numpy inputs go through ``repro.kernels.blocked_cholesky`` (its
``"pallas"`` engine in interpret mode, as the JAX package's own tests run
it, and its ``"jnp"`` engine) and ``repro_torch.kernels.blocked_cholesky``
(the ``"torch"`` engine and the ``"cuda"`` engine, whose wrappers run the
plain twins of B5-B7 on CPU tensors). Factor tolerance 1e-5 normwise
relative, the reference's own bound for two fp32 factorizations in
different orders; T T^T 1e-6. The kernels themselves run only on the card
(``python3 chip_smoke.py`` holds them against these twins there).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FalkonConfig as JConfig
from repro.core import falkon_fit as jfit
from repro.core import make_kernel as jmake
from repro.core.preconditioner import make_preconditioner as jmake_preconditioner
from repro.kernels import blocked_cholesky as jbc
from repro.ops import get_ops as jget_ops
from repro.ops import plan_factor as jplan_factor
from repro_torch import FalkonConfig, falkon_fit, falkon_solve
from repro_torch.core import make_kernel, make_preconditioner
from repro_torch.kernels import blocked_cholesky as bc
from repro_torch.ops import (
    FACTOR_PATHS,
    FactorPlan,
    FactorPlanWarning,
    get_ops,
    plan_factor,
)

FACTOR_TOL = 1e-5
SYRK_TOL = 1e-6
KERNELS = [
    ("gaussian", dict(sigma=1.3)),
    ("laplacian", dict(sigma=1.1)),
    ("matern32", dict(sigma=1.7)),
    ("linear", dict(scale=1.5)),
    ("polynomial", dict(degree=2, c=0.5, scale=2.0)),
]
#: (M, block): the reference's wide-block ragged cases (contraction width
#: of the last update > its output width) and two many-panel cases
RAGGED = [(300, 256), (500, 192), (260, 256), (97, 32), (200, 64)]
ENGINES = ["torch", "cuda"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _spd(M, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, M)).astype(np.float32)
    return A @ A.T / M + np.eye(M, dtype=np.float32)


@functools.cache
def _reference(M, block):
    """The JAX package's factors of _spd(M, M + block): pallas, jnp, float64."""
    K = _spd(M, seed=M + block)
    return (K, jbc.blocked_cholesky(K, block, tile_impl="pallas"),
            jbc.blocked_cholesky(K, block, tile_impl="jnp"),
            np.linalg.cholesky(K.astype(np.float64)).T)


def _kernel_gram(name, params, M=333, d=7, seed=0):
    C = np.random.default_rng(seed).standard_normal((M, d)).astype(np.float32)
    return np.array(jget_ops("jnp", jmake(name, **params)).gram(jnp.asarray(C),
                                                                jnp.asarray(C)))


# ---------------------------------------------------------------------------
# plan_factor: the reference's arithmetic, field for field
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("M,itemsize,budget", [
    (1024, 4, None), (11_585, 4, None), (11_586, 4, None), (32_768, 4, None),
    (50_000, 4, None), (8192, 8, None), (300, 4, 2**16), (200_000, 4, None),
])
def test_plan_factor_matches_reference(M, itemsize, budget):
    got = plan_factor(M, itemsize=itemsize, factor_budget=budget)
    ref = jplan_factor(M, itemsize=itemsize, factor_budget=budget)
    for field in ("path", "M", "block", "itemsize", "dense_bytes", "panel_bytes",
                  "factor_budget_bytes", "reason", "tile_dtype", "device_ceiling_bytes"):
        assert getattr(got, field) == getattr(ref, field), field
    assert got.path in FACTOR_PATHS


def test_plan_factor_millionsongs_shape():
    """M = 5x10^4 fp32: 40 panels of 1280, the last 80 wide (contraction
    1280 > output 80), device ceiling ~1.54 GB against a 10 GB factor."""
    plan = plan_factor(50_000)
    assert (plan.path, plan.block) == ("blocked", 1280)
    assert -(-plan.M // plan.block) == 40 and plan.M - 39 * plan.block == 80
    assert plan.device_ceiling_bytes == 1_536_000_000
    assert plan.dense_bytes == 10**10


def test_plan_factor_env_override(monkeypatch):
    monkeypatch.setenv("REPRO_FACTOR_BUDGET_MB", "1")
    assert plan_factor(1024).path == jplan_factor(1024).path == "blocked"
    monkeypatch.setenv("REPRO_FACTOR_BUDGET_MB", "100000")
    assert plan_factor(65536).path == jplan_factor(65536).path == "incore"


def test_plan_factor_policy_floor():
    from repro_torch.ops import POLICIES
    plan = plan_factor(8192, itemsize=2, policy=POLICIES["bf16"])
    assert (plan.tile_dtype, plan.itemsize) == ("float32", 4)


# ---------------------------------------------------------------------------
# The factorization and its tile engines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("M,block", RAGGED)
def test_blocked_cholesky_matches_reference_engines(M, block, engine):
    K, Tp, Tj, T64 = _reference(M, block)
    T = bc.blocked_cholesky(torch.from_numpy(K), block, tile_impl=engine, device="cpu")
    assert T.shape == (M, M)
    assert torch.equal(torch.tril(T, -1), torch.zeros_like(T)), "factor must be upper"
    assert _rel(T, Tp) < FACTOR_TOL
    assert _rel(T, Tj) < FACTOR_TOL
    assert _rel(T, T64) < FACTOR_TOL
    assert torch.equal(torch.from_numpy(K), torch.from_numpy(_reference(M, block)[0]))


def test_blocked_cholesky_overwrite_factors_in_place():
    K = torch.from_numpy(_spd(150, seed=2))
    ref = bc.blocked_cholesky(K, 64, device="cpu")
    W = K.clone()
    T = bc.blocked_cholesky(W, 64, device="cpu", overwrite=True)
    assert T.data_ptr() == W.data_ptr() and torch.equal(T, ref)
    assert torch.equal(W, ref.mT)                       # W now holds L


@pytest.mark.parametrize("engine", ENGINES)
def test_indefinite_tile_yields_nan(engine):
    """An indefinite input fails observably on every engine of both packages."""
    K = _spd(96, seed=11)
    K[48, 48] = -100.0
    T = bc.blocked_cholesky(K, 32, tile_impl=engine, device="cpu")
    assert torch.isnan(T).any()
    assert np.isnan(jbc.blocked_cholesky(K, 32, tile_impl="pallas")).any()
    assert np.isnan(jbc.blocked_cholesky(K, 32, tile_impl="jnp")).any()


def test_potrf_twin_nan_from_the_bad_pivot_on():
    A = torch.from_numpy(_spd(40, seed=4))
    A[17, 17] = -5.0
    L = bc.potrf_tile(A)
    assert torch.isfinite(L[:, :17]).all()
    assert torch.isnan(L[17, 17]) and torch.isnan(L[18:, 17:].diagonal()).all()


def _upper_garbage(A):
    """A copy of A with NaN above the diagonal: B5 reads the lower triangle."""
    G = A.copy()
    G[np.triu_indices(A.shape[0], 1)] = np.nan
    return G


@pytest.mark.parametrize("b", [80, 192, 257])
def test_potrf_blocked_schedule_matches_twin_and_reference(b):
    """B5's sub-panel schedule (nb = 64, ragged last sub-panel) against the
    column recurrence and the reference's Pallas kernel (interpret mode);
    it reads A's lower triangle only and leaves L's strict upper triangle 0."""
    A = _spd(b, seed=b + 1)
    L = bc.potrf_blocked_plain(torch.from_numpy(_upper_garbage(A)), nb=64)
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    assert _rel(L, bc.potrf_plain(torch.from_numpy(A))) < FACTOR_TOL
    assert _rel(L, jbc._pallas_potrf(jnp.asarray(A), interpret=True)) < FACTOR_TOL
    assert _rel(L, np.linalg.cholesky(A.astype(np.float64))) < FACTOR_TOL


@pytest.mark.parametrize("b,col", [(80, 0), (192, 100), (192, 127), (257, 64), (257, 256)])
def test_potrf_blocked_schedule_nan_from_the_bad_pivot_on(b, col):
    """An indefinite pivot at column 0, inside a sub-panel, on a sub-panel's
    last column, on a sub-panel's first and on a ragged tile's last: NaN on
    and below the diagonal from that column on, finite before it, exactly
    where the column recurrence and the reference's kernel put it."""
    A = _spd(b, seed=b + col)
    A[col, col] = -100.0
    L = bc.potrf_blocked_plain(torch.from_numpy(_upper_garbage(A)), nb=64)
    nan = torch.isnan(L)
    assert torch.equal(nan, torch.isnan(bc.potrf_plain(torch.from_numpy(A))))
    ref = np.asarray(jbc._pallas_potrf(jnp.asarray(A), interpret=True))
    assert torch.equal(nan, torch.from_numpy(np.isnan(ref)))
    assert torch.isfinite(L[:, :col]).all()
    assert nan[col:, col:][torch.ones(b - col, b - col, dtype=torch.bool).tril()].all()
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))


def _chol(b, seed):
    """A lower fp32 Cholesky factor of _spd(b, seed), from float64."""
    return np.linalg.cholesky(_spd(b, seed=seed).astype(np.float64)).astype(np.float32)


@pytest.mark.parametrize("nb", [bc.TRSM_NB, 64])
@pytest.mark.parametrize("b", [40, 200, 257])
def test_trsm_blocked_schedule_matches_twin_and_reference(b, nb):
    """B6's column-block schedule (ragged last block) against the forward
    substitution, the reference's Pallas kernel (interpret mode) and
    float64; it reads L's lower triangle only."""
    L = _chol(b, b + 5)
    P = np.random.default_rng(b).standard_normal((70, b)).astype(np.float32)
    X = bc.trsm_blocked_plain(torch.from_numpy(_upper_garbage(L)), torch.from_numpy(P), nb)
    assert _rel(X, bc.trsm_plain(torch.from_numpy(L), torch.from_numpy(P))) < FACTOR_TOL
    ref = jbc._pallas_trsm(jnp.asarray(_upper_garbage(L)), jnp.asarray(P), interpret=True)
    assert _rel(X, ref) < FACTOR_TOL
    X64 = np.linalg.solve(L.astype(np.float64), P.T.astype(np.float64)).T
    assert _rel(X, X64) < FACTOR_TOL


@pytest.mark.parametrize("nb", [bc.TRSM_NB, 64])
@pytest.mark.parametrize("col", [0, 100, 127, 255, 256])
def test_trsm_blocked_schedule_nan_from_the_bad_pivot_on(col, nb):
    """A NaN pivot on L's diagonal at the first column, inside a column
    block, on a column block's last column and on a ragged panel's last: NaN
    from that column on in every row, finite before it, exactly where the
    forward substitution and the reference's kernel put it."""
    b = 257
    L = _upper_garbage(_chol(b, col))
    L[col, col] = np.nan
    P = np.random.default_rng(col).standard_normal((70, b)).astype(np.float32)
    X = bc.trsm_blocked_plain(torch.from_numpy(L), torch.from_numpy(P), nb)
    nan = torch.isnan(X)
    assert torch.equal(nan, torch.isnan(bc.trsm_plain(torch.from_numpy(L), torch.from_numpy(P))))
    ref = np.asarray(jbc._pallas_trsm(jnp.asarray(L), jnp.asarray(P), interpret=True))
    assert torch.equal(nan, torch.from_numpy(np.isnan(ref)))
    assert nan[:, col:].all() and torch.isfinite(X[:, :col]).all()


@pytest.mark.parametrize("b", [40, 128, 200])
def test_tile_twins_match_reference_pallas_kernels(b):
    """B5-B7's twins against the reference's Pallas tile kernels (interpret
    mode), the update with a contraction width k wider than its output b."""
    rng = np.random.default_rng(b)
    A = _spd(b, seed=b)
    L_ref = np.asarray(jbc._pallas_potrf(jnp.asarray(A), interpret=True))
    L = bc.potrf_tile(torch.from_numpy(A))
    assert _rel(L, L_ref) < FACTOR_TOL
    P = rng.standard_normal((70, b)).astype(np.float32)
    X_ref = np.asarray(jbc._pallas_trsm(jnp.asarray(L_ref), jnp.asarray(P), interpret=True))
    assert _rel(bc.trsm_panel(torch.tensor(L_ref), torch.from_numpy(P)), X_ref) < FACTOR_TOL
    C = rng.standard_normal((70, 30)).astype(np.float32)
    Pk = rng.standard_normal((70, b)).astype(np.float32)
    Qk = rng.standard_normal((30, b)).astype(np.float32)
    O_ref = np.asarray(jbc._pallas_update(jnp.asarray(C), jnp.asarray(Pk), jnp.asarray(Qk),
                                          interpret=True))
    Ct = torch.from_numpy(C.copy())
    assert _rel(bc.trailing_update(Ct, torch.from_numpy(Pk), torch.from_numpy(Qk)),
                O_ref) < 1e-6
    out = bc.trailing_update(Ct, torch.from_numpy(Pk), torch.from_numpy(Qk), out=Ct)
    assert out is Ct and _rel(Ct, O_ref) < 1e-6


@pytest.mark.parametrize("M,block", [(97, 32), (500, 128), (300, 256)])
def test_blocked_syrk_tt_matches_reference(M, block):
    T = np.triu(np.random.default_rng(M).standard_normal((M, M)).astype(np.float32))
    ref = jbc.blocked_syrk_tt(T, block)
    got = bc.blocked_syrk_tt(torch.from_numpy(T), block, device="cpu")
    assert _rel(got, ref) < SYRK_TOL
    assert _rel(got, T.astype(np.float64) @ T.T.astype(np.float64)) < SYRK_TOL
    # the upper view blocked_cholesky returns gives the same product
    view = torch.from_numpy(np.ascontiguousarray(T.T)).mT
    assert torch.equal(bc.blocked_syrk_tt(view, block, device="cpu"), got)


def test_resolve_tile_impl():
    assert bc.resolve_tile_impl("auto", "cpu") == "torch"
    assert bc.resolve_tile_impl("auto", "cuda") == "cuda"
    assert bc.resolve_tile_impl("torch", "cuda") == "torch"
    assert bc.resolve_tile_impl("cuda", "cpu") == "cuda"
    with pytest.raises(ValueError, match="tile_impl"):
        bc.resolve_tile_impl("pallas")


def test_blocked_cholesky_rejects_bad_inputs_and_float64():
    with pytest.raises(ValueError, match="square"):
        bc.blocked_cholesky(np.ones((4, 5), np.float32), 2, device="cpu")
    with pytest.raises(ValueError, match="block"):
        bc.blocked_cholesky(np.eye(4, dtype=np.float32), 0, device="cpu")
    K = _spd(150, seed=9).astype(np.float64)
    T = bc.blocked_cholesky(K, 64, device="cpu")
    assert T.dtype == torch.float64
    assert _rel(T, np.linalg.cholesky(K).T) < 1e-12


@pytest.mark.parametrize("engine", ENGINES)
def test_device_residency_is_o_block_m(engine):
    """FactorStats: the peak stays under the plan's O(b * M) ceiling and the
    dense footprint, grows linearly in M at a fixed block, and every device
    buffer is released."""
    block = 64
    peaks = {}
    for M in (512, 1024):
        plan = plan_factor(M, block=block, factor_budget=1)
        assert plan.path == "blocked" and plan.block == block
        stats = bc.FactorStats()
        bc.blocked_cholesky(_spd(M, seed=M), block, tile_impl=engine, stats=stats,
                            device="cpu")
        nb = M // block
        assert (stats.panels, stats.tiles_updated) == (nb, nb * (nb - 1) // 2)
        assert stats.current_device_bytes == 0
        assert stats.peak_device_bytes <= plan.device_ceiling_bytes
        if engine == "cuda":   # B7 updates in place: the panel and one trailing tile
            assert stats.peak_device_bytes <= plan.panel_bytes
        assert stats.peak_device_bytes < plan.dense_bytes
        peaks[M] = stats.peak_device_bytes
        syrk = bc.FactorStats()
        bc.blocked_syrk_tt(np.triu(_spd(M)), block, stats=syrk, device="cpu")
        assert syrk.current_device_bytes == 0
        assert syrk.peak_device_bytes <= plan.device_ceiling_bytes
    assert peaks[1024] <= 3.0 * peaks[512], peaks


# ---------------------------------------------------------------------------
# The preconditioner on the blocked route
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,params", KERNELS)
@pytest.mark.filterwarnings("ignore::repro.ops.FactorPlanWarning")
@pytest.mark.filterwarnings("ignore::repro_torch.ops.FactorPlanWarning")
def test_blocked_preconditioner_matches_reference(name, params):
    """T and A of the forced-blocked build against the reference's, ragged
    M = 333 over 256-wide tiles (jitter 0.1, as the reference's test, so the
    comparison is about the factorization, not the conditioning)."""
    K = _kernel_gram(name, params)
    ref = jmake_preconditioner(jnp.asarray(K), 1e-3, 1000, factor_plan="blocked", jitter=0.1)
    got = make_preconditioner(torch.from_numpy(K), 1e-3, 1000, factor_plan="blocked",
                              jitter=0.1)
    incore = make_preconditioner(torch.from_numpy(K), 1e-3, 1000, factor_plan="incore",
                                 jitter=0.1)
    assert _rel(got.T, ref.T) < FACTOR_TOL
    assert _rel(got.A, ref.A) < FACTOR_TOL
    assert _rel(got.T, incore.T) < FACTOR_TOL
    assert _rel(got.A, incore.A) < FACTOR_TOL
    assert torch.equal(torch.from_numpy(K), torch.from_numpy(_kernel_gram(name, params)))


@pytest.mark.filterwarnings("ignore::repro.ops.FactorPlanWarning")
@pytest.mark.filterwarnings("ignore::repro_torch.ops.FactorPlanWarning")
def test_blocked_preconditioner_with_leverage_diagonal():
    K = _kernel_gram("gaussian", dict(sigma=1.3), M=300)
    D = np.random.default_rng(5).uniform(0.5, 1.5, 300).astype(np.float32)
    ref = jmake_preconditioner(jnp.asarray(K), 1e-3, 1000, D=jnp.asarray(D),
                               factor_plan="blocked")
    stats = bc.FactorStats()
    got = make_preconditioner(torch.from_numpy(K), 1e-3, 1000, D=torch.from_numpy(D),
                              factor_plan="blocked", factor_stats=stats)
    assert _rel(got.T, ref.T) < FACTOR_TOL
    assert _rel(got.A, ref.A) < FACTOR_TOL
    assert stats.panels == 2 * 2 and stats.current_device_bytes == 0   # T and A


def test_blocked_route_warns_with_plan_and_forcing(monkeypatch):
    K = torch.from_numpy(_kernel_gram("gaussian", dict(sigma=1.3), M=300))
    with pytest.warns(FactorPlanWarning) as rec:
        make_preconditioner(K, 1e-3, 1000, factor_plan="blocked")
    plan = rec[0].message.plan
    assert isinstance(plan, FactorPlan) and plan.path == "blocked"
    monkeypatch.setenv("REPRO_FACTOR_BUDGET_MB", "0.05")
    with pytest.warns(FactorPlanWarning):
        auto = make_preconditioner(K, 1e-3, 1000)
    forced = make_preconditioner(K, 1e-3, 1000, factor_plan="incore")   # no warning
    assert _rel(auto.A, forced.A) < FACTOR_TOL
    with pytest.raises(ValueError, match="factor_plan"):
        make_preconditioner(K, 1e-3, 1000, factor_plan="banana")


def test_rank_deficient_refuses_blocked_route():
    K = torch.from_numpy(_kernel_gram("gaussian", dict(sigma=1.3), M=200))
    with pytest.raises(ValueError, match="rank_deficient"):
        make_preconditioner(K, 1e-3, 1000, rank_deficient=True, factor_plan="blocked")
    with pytest.raises(ValueError, match="REPRO_FACTOR_BUDGET_MB"):
        make_preconditioner(K, 1e-3, 1000, rank_deficient=True,
                            factor_plan=plan_factor(200, factor_budget=1))
    assert make_preconditioner(K, 1e-3, 1000, rank_deficient=True,
                               factor_plan="incore").diag_T


# ---------------------------------------------------------------------------
# Forced-blocked end-to-end fit
# ---------------------------------------------------------------------------
FIT_TOL = 1e-4   # the reference's blocked-vs-in-core fit bound (alpha, predictions)


@pytest.mark.filterwarnings("ignore::repro.ops.FactorPlanWarning")
@pytest.mark.filterwarnings("ignore::repro_torch.ops.FactorPlanWarning")
def test_forced_blocked_fit_matches_reference(monkeypatch):
    """The reference's forced-blocked falkon_fit and the port's forced-blocked
    preconditioner and solve, on the reference's centers: alpha and
    predictions within 1e-4 (sigma 1, lam 1e-3, jitter 1e-3, as the
    reference's test keeps the problem well conditioned)."""
    n, d, M, iters = 1500, 6, 320, 30
    rng = np.random.default_rng(7)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (X @ rng.standard_normal(d) + 0.05 * rng.standard_normal(n)).astype(np.float32)
    params = (("sigma", 1.0),)
    monkeypatch.setenv("REPRO_FACTOR_BUDGET_MB", "0.2")          # M = 320 -> blocked
    jcfg = JConfig(kernel="gaussian", kernel_params=params, num_centers=M, lam=1e-3,
                   iterations=iters, jitter=1e-3)
    jest, jst = jfit(jax.random.PRNGKey(7), jnp.asarray(X), jnp.asarray(y), jcfg)
    centers = torch.from_numpy(np.asarray(jst.centers).copy())
    kern = make_kernel("gaussian", sigma=1.0)
    for impl in ("torch", "cuda"):
        ops = get_ops(impl, kern)
        P = make_preconditioner(ops.gram(centers, centers), 1e-3, n, jitter=1e-3)
        st = falkon_solve(torch.from_numpy(X), torch.from_numpy(y), centers, P, kern, 1e-3,
                          iters, ops_impl=impl)
        assert _rel(st.alpha, jst.alpha) < FIT_TOL, impl
        preds = ops.apply(torch.from_numpy(X[:100]), centers, st.alpha)
        assert _rel(preds, jest.predict(jnp.asarray(X[:100]))) < FIT_TOL, impl


def test_port_fit_routes_blocked_and_reports_the_plan(monkeypatch):
    """The port's own fit on the reference test's problem (n = 1500, d = 6,
    M = 320, sigma 1, lam 1e-3, jitter 1e-3): past the budget the factor
    stage takes the blocked route and reports it; alpha and predictions
    match the in-core fit on the same centers."""
    rng = np.random.default_rng(3)
    X = rng.standard_normal((1500, 6)).astype(np.float32)
    y = (X @ rng.standard_normal(6) + 0.05 * rng.standard_normal(1500)).astype(np.float32)
    cfg = FalkonConfig(kernel_params=(("sigma", 1.0),), num_centers=320, lam=1e-3,
                       iterations=30, jitter=1e-3, device="cpu", ops_impl="cuda")
    times_in = {}
    est_in, _ = falkon_fit(0, X, y, cfg, stage_times=times_in)
    assert (times_in["factor_path"], times_in["factor_block"]) == ("incore", None)
    monkeypatch.setenv("REPRO_FACTOR_BUDGET_MB", "0.2")
    times = {}
    with pytest.warns(FactorPlanWarning):
        est, _ = falkon_fit(0, X, y, cfg, stage_times=times)
    assert (times["factor_path"], times["factor_block"]) == ("blocked", 256)
    stats = times["factor_stats"]
    assert stats.measured_peak_device_bytes == 0        # measured on CUDA devices only
    assert (stats.panels, stats.current_device_bytes) == (2 * 2, 0)   # T and A, 2 panels each
    assert stats.copy_seconds > 0 and stats.tile_seconds > 0
    assert torch.equal(est.centers, est_in.centers)
    assert _rel(est.alpha, est_in.alpha) < FIT_TOL
    assert _rel(est.predict(X[:100]), est_in.predict(X[:100])) < FIT_TOL
