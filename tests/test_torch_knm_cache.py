"""The port's materialized K_nM cache (``repro_torch.ops.KernelCache``)
against the JAX package's.

The same numpy inputs go through both packages. Centers cannot share a seed
across frameworks, so the fits run on the reference's centers and factors
(``repro_torch.convert``). The reference runs on its "jnp" backend; the port
on "torch" and on "cuda", whose wrappers take their plain twins on the CPU
(B3 a tile for ``materialize``; the GEMMs are ``torch.matmul``).

What is held, with each bound (normwise relative; measured on a CPU, set
with ~3x headroom unless bit-equality is asserted):

* ``plan_cache``: field for field the reference's, every route;
* the fp32 device-tier cached sweep on the "torch" backend equals that
  backend's recompute sweep bit for bit (ragged n, with and without v,
  under a row mask), and so do the fits and path fits built on it;
* cached sweeps and applies against the reference's ``KernelCache`` (both
  tiers): fp32 1e-6 (measured <= 2.1e-7), bf16 storage 2e-5 and float16
  storage 1e-5 (measured <= 6.0e-6 and 3.4e-6: the port's twins and the
  reference's kernels round some entries to the neighbouring 16-bit value);
* cached fits against the reference's cached fits (lam = 1e-3, both
  backends, both tiers): alpha 7e-4, cond(W) 3e-6, predictions 2e-5
  (measured 1.3e-4, 1.0e-6, 7.1e-6: fp32 sums in other orders, which the
  solve amplifies in alpha); path alphas 7e-4 (measured 2.4e-4); the
  port's host-tier fit against its device-tier fit 1e-6 (measured 0) and
  against its recompute fit 7e-4 (measured 2.0e-4).
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ops as jops
from repro.core import FalkonConfig as JConfig
from repro.core import falkon_fit as jfit
from repro.core import falkon_fit_path as jfit_path
from repro.core import kernels as jk
from repro_torch.convert import preconditioner_from_numpy, preconditioner_path_from_numpy
from repro_torch.core import (
    FalkonConfig,
    FalkonEstimator,
    cached_knm_apply,
    cached_knm_matvec,
    falkon_fit,
    falkon_fit_path,
    falkon_solve,
    falkon_solve_path,
    make_kernel,
    make_knm_cache,
)
from repro_torch.data import ArrayChunkSource, StreamingLoader
from repro_torch.ops import (
    CachePlan,
    CachePlanWarning,
    CountingOps,
    KernelCache,
    PrecisionPolicy,
    data_shards,
    get_ops,
    plan_cache,
    resolve_precision,
)

N, D, M, BS, SIGMA, LAM, T = 1000, 6, 128, 256, 1.5, 1e-3, 8
F16 = PrecisionPolicy(name="fp16", storage="float16", compensated=True)
JF16 = jops.PrecisionPolicy(name="fp16", storage="float16", compensated=True)
#: (port policy, reference policy) of each storage
POLICIES = {"fp32": ("fp32", "fp32"), "bf16": ("bf16", "bf16"), "float16": (F16, JF16)}
SWEEP_TOL = {"fp32": 1e-6, "bf16": 2e-5, "float16": 1e-5}
FIT_TOL = dict(alpha=7e-4, cond=3e-6, pred=2e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: small tensors, beside the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def rel(got, ref) -> float:
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _problem(n=N, d=D, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    return X, (np.sin(X[:, 0]) + 0.1 * rng.standard_normal(n)).astype(np.float32)


def _vectors(n, m, p=None, seed=3):
    rng = np.random.default_rng(seed)
    cols = () if p is None else (p,)
    return (rng.standard_normal((m,) + cols).astype(np.float32),
            rng.standard_normal((n,) + cols).astype(np.float32))


def _kern():
    return make_kernel("gaussian", sigma=SIGMA), jk.make_kernel("gaussian", sigma=SIGMA)


# ---------------------------------------------------------------------------
# plan_cache
# ---------------------------------------------------------------------------
PLAN_CASES = [
    dict(budget=2**20),
    dict(budget=2**18, host_budget=2**20),
    dict(budget=2**18, host_budget=2**18),
    dict(budget=2**18, shards=4),
    dict(budget=2**18, shards=3),
    dict(tier="host", budget=2**30),
    dict(tier="device", budget=0, host_budget=0),
    dict(tier="off"),
    dict(itemsize=2, budget=2**18),
    dict(itemsize=8, budget=2**30),
    dict(policy="fp32"),
    dict(policy="bf16"),
    dict(policy="float16"),
]


@pytest.mark.parametrize("kw", PLAN_CASES, ids=lambda kw: "-".join(f"{k}={v}"
                                                                   for k, v in kw.items()))
def test_plan_cache_matches_reference(kw):
    """Every field of the plan, the reason text included, for the tiers by
    budget, per-shard charging, forced tiers and the policies' itemsizes."""
    kt, kj = dict(kw), dict(kw)
    if "policy" in kw:
        pt, pj = POLICIES[kw["policy"]]
        kt["policy"], kj["policy"] = resolve_precision(pt), jops.resolve_precision(pj)
    for n, m in ((1000, 128), (1_000_000, 10_000)):
        got, ref = plan_cache(n, m, **kt), jops.plan_cache(n, m, **kj)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    if "policy" in kw:
        assert got.storage_dtype == kt["policy"].storage
        assert got.cache_bytes == 1_000_000 * 10_000 * kt["policy"].storage_itemsize


def test_plan_cache_env_budgets_and_refusals(monkeypatch):
    monkeypatch.setenv("REPRO_KNM_BUDGET_MB", "0.25")
    monkeypatch.setenv("REPRO_KNM_HOST_BUDGET_MB", "1")
    assert plan_cache(1000, 128).tier == "host" == jops.plan_cache(1000, 128).tier
    monkeypatch.setenv("REPRO_KNM_HOST_BUDGET_MB", "0.25")
    assert plan_cache(1000, 128).tier == "off"
    monkeypatch.setenv("REPRO_KNM_BUDGET_MB", "1")
    got = plan_cache(1000, 128)
    assert got.tier == "device" and dataclasses.asdict(got) == dataclasses.asdict(
        jops.plan_cache(1000, 128))
    monkeypatch.delenv("REPRO_KNM_BUDGET_MB")
    monkeypatch.delenv("REPRO_KNM_HOST_BUDGET_MB")
    # the reference's defaults: SUSY at n = 10^6 in fp32 (40 GB) routes "off"
    p = plan_cache(1_000_000, 10_000)
    assert (p.budget_bytes, p.host_budget_bytes, p.tier) == (2**30, 8 * 2**30, "off")
    with pytest.raises(ValueError, match="unknown cache tier"):
        plan_cache(1000, 128, tier="hbm")
    X, _ = _problem()
    off = plan_cache(N, M, budget=0, host_budget=0)
    assert off.tier == "off"
    with pytest.raises(ValueError, match="off"):
        KernelCache(get_ops("torch", _kern()[0], block_size=BS), torch.from_numpy(X),
                    torch.from_numpy(X[:M]), plan=off)
    assert data_shards(CountingOps(get_ops("torch", _kern()[0]))) == 1
    assert isinstance(off, CachePlan)


# ---------------------------------------------------------------------------
# the cached primitives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", [None, 3])
def test_device_tier_bit_equal_to_recompute_torch(p):
    """fp32, "torch" backend, ragged n: the cached sweep (with and without
    v, under a row mask) and apply equal the recompute sweep and apply bit
    for bit; masked rows contribute exactly zero."""
    X, _ = _problem()
    u, v = _vectors(N, M, p)
    Xt, Ct, ut, vt = map(torch.from_numpy, (X, X[:M].copy(), u, v))
    ops = get_ops("torch", _kern()[0], block_size=BS)
    cache = KernelCache(ops, Xt, Ct, plan=plan_cache(N, M, tier="device"))
    assert cache.K.shape == (4 * BS, M) and cache.K.dtype == torch.float32
    assert cache.tier == "device" and cache.num_tiles == 4
    assert torch.equal(cache.sweep(ut, vt), ops.sweep(Xt, Ct, ut, vt))
    assert torch.equal(cache.sweep(ut), ops.sweep(Xt, Ct, ut))
    assert torch.equal(cache.apply(ut), ops.apply(Xt, Ct, ut))
    mask = (torch.arange(N) < 600).to(torch.float32)
    assert torch.equal(cache.sweep(ut, vt, row_mask=mask), ops.sweep(Xt[:600], Ct, ut, vt[:600]))
    assert torch.equal(cache.sweep(ut, vt, row_mask=mask), ops.sweep(Xt, Ct, ut, vt, mask))


@pytest.mark.parametrize("storage", ["fp32", "bf16", "float16"])
@pytest.mark.parametrize("tier", ["device", "host"])
def test_cached_primitives_match_reference(tier, storage):
    """The cached sweep and apply of both port backends against the
    reference's ``KernelCache`` on its "jnp" backend, for both tiers and the
    three storage types: the tiles' type and the halved footprint of a
    16-bit policy. Ragged n (the pad mask), p = 2."""
    n, m = 900, 96
    X, _ = _problem(n=n)
    u, v = _vectors(n, m, 2)
    pt, pj = POLICIES[storage]
    kt, kj = _kern()
    jops_ = jops.get_ops("jnp", kj, block_size=BS, precision=pj)
    jc = jops.KernelCache(jops_, jnp.asarray(X), jnp.asarray(X[:m]),
                          plan=jops.plan_cache(n, m, policy=jops_.policy, tier=tier))
    ref_w, ref_a = jc.sweep(jnp.asarray(u), jnp.asarray(v)), jc.apply(jnp.asarray(u))
    for impl in ("torch", "cuda"):
        ops = get_ops(impl, kt, block_size=BS, precision=pt)
        plan = plan_cache(n, m, policy=ops.policy, tier=tier)
        cache = KernelCache(ops, torch.from_numpy(X), torch.from_numpy(X[:m].copy()), plan=plan)
        assert cache.tier == tier and cache.num_tiles == 4
        stored = cache.K if tier == "device" else cache._loader.source.X
        assert stored.shape == (4 * BS, m)
        if storage == "fp32":
            assert stored.dtype in (torch.float32, np.float32)
        else:
            assert plan.cache_bytes * 2 == plan_cache(n, m, tier=tier).cache_bytes
            if tier == "device":
                assert cache.K.dtype == getattr(torch, ops.policy.storage)
        w = cache.sweep(torch.from_numpy(u), torch.from_numpy(v))
        a = cache.apply(torch.from_numpy(u))
        assert w.dtype == a.dtype == torch.float32
        assert rel(w, ref_w) <= SWEEP_TOL[storage], (impl, tier, storage)
        assert rel(a, ref_a) <= SWEEP_TOL[storage], (impl, tier, storage)


def test_host_tier_equals_device_tier():
    """The host tier's streamed tiles (bf16 held as their int16 bits) give
    the device tier's sweep: one GEMM sweep a tile, summed in fp32."""
    X, _ = _problem()
    u, v = map(torch.from_numpy, _vectors(N, M))
    Xt, Ct = torch.from_numpy(X), torch.from_numpy(X[:M].copy())
    for prec in ("fp32", "bf16"):
        ops = get_ops("torch", _kern()[0], block_size=BS, precision=prec)
        dev = KernelCache(ops, Xt, Ct, plan=plan_cache(N, M, tier="device"))
        host = KernelCache(ops, Xt, Ct, plan=plan_cache(N, M, tier="host"))
        assert host.K is None and host.K_host.shape == (4 * BS, M)
        assert rel(host.sweep(u, v), dev.sweep(u, v)) <= 1e-6, prec
        assert torch.equal(host.apply(u), dev.apply(u)), prec


def test_functional_veneer():
    X, _ = _problem(n=512)
    u, v = _vectors(512, 64)
    Xt, Ct, ut, vt = map(torch.from_numpy, (X, X[:64].copy(), u, v))
    kern, jkern = _kern()
    ops = get_ops("torch", kern, block_size=BS)
    cache = make_knm_cache(Xt, Ct, kern, block_size=BS, impl="torch", tier="device")
    assert torch.equal(cached_knm_matvec(cache, ut, vt), ops.sweep(Xt, Ct, ut, vt))
    assert torch.equal(cached_knm_apply(cache, ut), ops.apply(Xt, Ct, ut))
    from repro.core import make_knm_cache as jmake_knm_cache
    jc = jmake_knm_cache(jnp.asarray(X), jnp.asarray(X[:64]), jkern, block_size=BS,
                         tier="device")
    assert rel(cached_knm_matvec(cache, ut, vt), jc.sweep(jnp.asarray(u), jnp.asarray(v))) <= 1e-6
    with pytest.raises(ValueError, match="off"):
        make_knm_cache(Xt, Ct, kern, impl="torch", tier="off")


# ---------------------------------------------------------------------------
# cached fits
# ---------------------------------------------------------------------------
def _reference_fit(X, y, **kw):
    jcfg = JConfig(kernel="gaussian", kernel_params=(("sigma", SIGMA),), lam=LAM,
                   num_centers=M, iterations=T, block_size=BS, knm_cache="device", **kw)
    return jfit(jax.random.PRNGKey(0), jnp.asarray(X), jnp.asarray(y), jcfg)


def _cfg(**kw):
    base = dict(kernel="gaussian", kernel_params=(("sigma", SIGMA),), lam=LAM, num_centers=M,
                iterations=T, block_size=BS, device="cpu")
    base.update(kw)
    return FalkonConfig(**base)


@pytest.mark.parametrize("tier", ["device", "host"])
def test_cached_fit_matches_reference(tier):
    """The reference's cached fit; the port's cached solve on its centers
    and factors (both backends): alpha, cond(W) and test predictions."""
    X, y = _problem()
    jest, jst = _reference_fit(X, y)
    Ct = torch.from_numpy(np.asarray(jst.centers).copy())
    P = preconditioner_from_numpy(dict(T=np.asarray(jst.precond.T), A=np.asarray(jst.precond.A),
                                       n=np.asarray(jst.precond.n)), device="cpu")
    kern = make_kernel("gaussian", sigma=SIGMA)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    X_new = _problem(n=200, seed=7)[0]
    for impl in ("torch", "cuda"):
        ops = get_ops(impl, kern, block_size=BS)
        cache = KernelCache(ops, Xt, Ct, plan=plan_cache(N, M, tier=tier))
        st = falkon_solve(Xt, yt, Ct, P, kern, LAM, T, ops=ops, cache=cache)
        assert rel(st.alpha, jst.alpha) <= FIT_TOL["alpha"], impl
        assert rel(st.cond_estimate, jst.cond_estimate) <= FIT_TOL["cond"], impl
        pred = FalkonEstimator(Ct, st.alpha, kern, ops_impl=impl).predict(X_new)
        assert rel(pred, jest.predict(jnp.asarray(X_new))) <= FIT_TOL["pred"], impl


def test_cached_fit_bit_equal_and_counted():
    """The port's own fit: cached equals recompute bit for bit on the
    "torch" backend (alpha and cond(W)); one tile evaluation per K_nM row
    tile plus K_MM's, no recompute sweep, and every one of the 1 + t + 26
    sweeps (the cond(W) power iteration's too) a GEMM sweep."""
    X, y = _problem()
    _, st0 = falkon_fit(0, X, y, _cfg(ops_impl="torch"))
    cfg = _cfg(ops_impl="torch", knm_cache="device")
    ops = CountingOps(cfg.make_ops())
    est, st1 = falkon_fit(0, X, y, cfg, ops=ops)
    assert torch.equal(st0.alpha, st1.alpha)
    assert torch.equal(st0.cond_estimate, st1.cond_estimate)
    tiles, kmm = -(-N // BS), -(-M // BS)
    assert (ops.sweeps, ops.materializes, ops.gemm_applies) == (0, 1, 0)
    assert ops.gram_tile_evals == tiles + kmm
    assert ops.gemm_sweeps == 1 + T + 26
    ops = CountingOps(cfg.make_ops())
    falkon_fit(0, X, y, dataclasses.replace(cfg, estimate_cond=False), ops=ops)
    assert (ops.sweeps, ops.gemm_sweeps, ops.gram_tile_evals) == (0, 1 + T, tiles + kmm)
    ops = CountingOps(_cfg(ops_impl="torch").make_ops())
    falkon_fit(0, X, y, _cfg(ops_impl="torch"), ops=ops)
    assert (ops.materializes, ops.gemm_sweeps, ops.sweeps) == (0, 0, 1 + T + 26)
    times: dict = {}
    falkon_fit(0, X, y, cfg, stage_times=times)
    assert times["cache"] >= 0.0


def test_cached_path_fit_matches_reference():
    """One cache serves the L systems: the reference's cached path fit, the
    port's cached path solve on its centers and factors; the port's own
    cached path fit builds one cache and equals its recompute path bit for
    bit on the "torch" backend."""
    X, y = _problem()
    lams = (1e-2, 1e-3, 1e-4)
    jcfg = JConfig(kernel="gaussian", kernel_params=(("sigma", SIGMA),), lam=LAM,
                   num_centers=M, iterations=T, block_size=BS, knm_cache="device")
    jres = jfit_path(jax.random.PRNGKey(1), jnp.asarray(X), jnp.asarray(y), jcfg, lams)
    Pj = jres.state.precond
    P = preconditioner_path_from_numpy(
        {f: None if getattr(Pj, f) is None else np.asarray(getattr(Pj, f))
         for f in ("T", "A", "Q", "D", "lams", "n")} | {"diag_T": Pj.diag_T}, device="cpu")
    Ct = torch.from_numpy(np.asarray(jres.state.centers).copy())
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    ops = get_ops("cuda", make_kernel("gaussian", sigma=SIGMA), block_size=BS)
    cache = KernelCache(ops, Xt, Ct, plan=plan_cache(N, M, tier="device"))
    st = falkon_solve_path(Xt, yt, Ct, P, T, ops=ops, cache=cache)
    assert rel(st.alphas, jres.state.alphas) <= FIT_TOL["alpha"]
    r0 = falkon_fit_path(0, X, y, _cfg(ops_impl="torch"), lams)
    cfg = _cfg(ops_impl="torch", knm_cache="device")
    cops = CountingOps(cfg.make_ops())
    r1 = falkon_fit_path(0, X, y, cfg, lams, ops=cops)
    assert torch.equal(r0.state.alphas, r1.state.alphas)
    assert (cops.materializes, cops.sweeps, cops.gemm_sweeps) == (1, 0, 1 + T)
    assert cops.gram_tile_evals == -(-N // BS) + -(-M // BS)


def test_host_tier_fit_equals_device_tier_fit():
    X, y = _problem(n=900)
    _, st_d = falkon_fit(0, X, y, _cfg(knm_cache="device"))
    est_h, st_h = falkon_fit(0, X, y, _cfg(knm_cache="host"))
    _, st_0 = falkon_fit(0, X, y, _cfg())
    assert rel(st_h.alpha, st_d.alpha) <= 1e-6
    assert rel(st_h.alpha, st_0.alpha) <= FIT_TOL["alpha"]


def test_auto_routes_off_and_host_with_a_warning(monkeypatch):
    """``"auto"`` at small budgets: off (the recompute fit, bit for bit) and
    host, each with a ``CachePlanWarning`` carrying the plan; the device
    tier without one."""
    X, y = _problem()
    _, st0 = falkon_fit(0, X, y, _cfg(ops_impl="torch"))
    monkeypatch.setenv("REPRO_KNM_BUDGET_MB", "0.001")
    monkeypatch.setenv("REPRO_KNM_HOST_BUDGET_MB", "0.001")
    cfg = _cfg(ops_impl="torch", knm_cache="auto")
    ops = CountingOps(cfg.make_ops())
    with pytest.warns(CachePlanWarning) as rec:
        _, sta = falkon_fit(0, X, y, cfg, ops=ops)
    assert rec[0].message.plan.tier == "off" and ops.materializes == 0
    assert torch.equal(st0.alpha, sta.alpha)
    monkeypatch.setenv("REPRO_KNM_HOST_BUDGET_MB", "64")
    with pytest.warns(CachePlanWarning) as rec:
        _, sth = falkon_fit(0, X, y, cfg)
    assert rec[0].message.plan.tier == "host"
    assert rel(sth.alpha, st0.alpha) <= 1e-6
    monkeypatch.setenv("REPRO_KNM_BUDGET_MB", "64")
    with warnings.catch_warnings():
        warnings.simplefilter("error", CachePlanWarning)
        _, std = falkon_fit(0, X, y, cfg)
    assert torch.equal(std.alpha, st0.alpha)


# ---------------------------------------------------------------------------
# the estimator's scoring cache
# ---------------------------------------------------------------------------
def test_estimator_scoring_cache_and_staleness():
    """``build_knm_cache`` / ``predict(cache=)`` / ``predict_stream(cache=)``
    against the recompute predict and the reference's cached predict; an
    explicit stale, foreign-centers, wrong-n or wrong-X cache raises; the
    held cache is a fast path for the same X object only."""
    X, y = _problem()
    jest, _ = _reference_fit(X, y)
    Xe = _problem(n=300, seed=9)[0]
    kern = make_kernel("gaussian", sigma=SIGMA)
    est = FalkonEstimator(torch.from_numpy(np.asarray(jest.centers).copy()),
                          torch.from_numpy(np.asarray(jest.alpha).copy()), kern,
                          block_size=BS, ops_impl="torch")
    Xt = torch.from_numpy(Xe)
    cache = est.build_knm_cache(Xt, tier="device")
    direct = est.ops.apply(Xt, est.centers, est.alpha)
    assert torch.equal(est.predict(Xt, cache=cache), direct)
    assert torch.equal(est.predict(Xt), direct)                      # the held fast path
    jc = jest.build_knm_cache(jnp.asarray(Xe), tier="device")
    assert rel(est.predict(Xt, cache=cache), jest.predict(jc.X, cache=jc)) <= FIT_TOL["pred"]
    loader = StreamingLoader(ArrayChunkSource(Xe, chunk_rows=128), device="cpu")
    assert torch.equal(est.predict_stream(loader, cache=cache), direct)
    X2 = torch.from_numpy(_problem(n=300, seed=10)[0])
    with pytest.raises(ValueError, match="different X"):
        est.predict(X2, cache=cache)
    assert torch.equal(est.predict(X2), est.ops.apply(X2, est.centers, est.alpha))
    short = StreamingLoader(ArrayChunkSource(Xe[:200], chunk_rows=128), device="cpu")
    with pytest.raises(ValueError, match="covers 300 rows"):
        est.predict_stream(short, cache=cache)
    other = FalkonEstimator(est.centers.clone(), est.alpha, kern, block_size=BS,
                            ops_impl="torch")
    with pytest.raises(ValueError, match="different centers"):
        other.predict(Xt, cache=cache)
    cache.invalidate()
    with pytest.raises(ValueError, match="stale"):
        est.predict(Xt, cache=cache)
    with pytest.raises(ValueError, match="stale"):
        est.predict_stream(loader, cache=cache)
    assert torch.equal(est.predict(Xt), direct)     # the held one is skipped, not used
    cache = est.build_knm_cache(Xt)                 # auto-routed: the device tier
    assert cache.tier == "device" and torch.equal(est.predict(Xt), direct)
    est.to(torch.float64)     # new buffers: the cache serves the old centers
    with pytest.raises(ValueError, match="different centers"):
        est.predict(Xt, cache=cache)
