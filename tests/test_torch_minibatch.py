"""The port's mini-batch fits (``repro_torch.core.minibatch``,
``falkon_fit_minibatch``, ``falkon_fit_minibatch_streaming``,
``FalkonEstimator.partial_fit``) against the JAX package's.

Both packages get the same numpy inputs from a seed. Centers and state
cannot share a random stream across frameworks, so the reference's centers,
preconditioner, iteration state or fitted estimator are carried over with
``repro_torch.convert``, and whole solves run with ``shuffle=False`` (the
in-core epoch permutation is ``jax.random`` in one package and a
``torch.Generator`` in the other); the streamed driver is held with
shuffling too, on the numpy ``ShuffledChunkSource``, whose chunks are equal
bit for bit in both packages. The reference runs on its "jnp" backend; the
port on both of its backends. Errors are normwise relative; each fp32
bound is the worst case measured on a CPU with ~3x headroom (the packages
round fp32 sums in different orders); bf16 is the policy's 1e-2.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FalkonConfig as JConfig
from repro.core import MinibatchConfig as JMB
from repro.core import falkon_fit as jfit
from repro.core import falkon_fit_minibatch as jfit_mb
from repro.core import falkon_fit_minibatch_streaming as jfit_mb_stream
from repro.core import make_preconditioner as jmake_preconditioner
from repro.core import minibatch_solve as jsolve
from repro.core import minibatch_solve_stream as jsolve_stream
from repro.core.minibatch import estimate_step_size as jstep_size
from repro.core.minibatch import minibatch_init as jinit
from repro.core.minibatch import minibatch_project as jproject
from repro.core.minibatch import minibatch_step as jstep
from repro.data import ArrayChunkSource as JArraySource
from repro.data import ShuffledChunkSource as JShuffledSource
from repro.data import StreamingLoader as JLoader
from repro.ops import get_ops as jget_ops
from repro_torch.convert import (estimator_from_numpy, minibatch_state_from_numpy,
                                 preconditioner_from_numpy)
from repro_torch.core import (FalkonConfig, MinibatchConfig, falkon_fit, falkon_fit_minibatch,
                              falkon_fit_minibatch_streaming, make_kernel, make_preconditioner,
                              minibatch_solve, minibatch_solve_stream)
from repro_torch.core.minibatch import estimate_step_size, minibatch_project, minibatch_step
from repro_torch.data import ArrayChunkSource, ShuffledChunkSource, StreamingLoader
from repro_torch.ops import CountingOps, get_ops

N, D, M, CHUNK, SIGMA, LAM = 2048, 6, 64, 512, 2.0, 1e-4
IMPLS = ("torch", "cuda")
#: one step's accumulator, one projection's fields and gradient norms from
#: one carried-over state (measured <= 1.08e-5, 1.54e-5 and 5.0e-6)
FN_TOL = 5e-5
#: the estimated step size, as a ratio (measured <= 7.5e-6)
ETA_TOL = 2.5e-5
#: whole solves and fits, shuffle=False: alpha, gradient norms and
#: predictions (measured <= 8.7e-5, 1.9e-5 and 2.2e-5 over both backends,
#: p = 1 and 2, in-core and streamed, and partial_fit)
SOLVE_TOL = dict(alpha=3e-4, grad=6e-5, pred=7e-5)
#: the bf16 policy's documented bound (measured <= 8.8e-5)
BF16_TOL = 1e-2


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for each test: its tensors are small, and beside
    the suite's other worker processes more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _problem(n=N, p=None, seed=0):
    """A learnable regression (the reference tests' target) and 1024
    validation rows with their noiseless targets."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((D, p or 1))
    w = 1.2 * w / np.linalg.norm(w, axis=0)

    def f(Z):
        return np.sin(Z @ w) + 0.5 * np.cos(0.6 * Z[:, :1] * Z[:, 1:2])

    X = rng.standard_normal((n, D)).astype(np.float32)
    Y = (f(X) + 0.05 * rng.standard_normal((n, p or 1))).astype(np.float32)
    Xv = rng.standard_normal((1024, D)).astype(np.float32)
    Yv = f(Xv).astype(np.float32)
    if p is None:
        return X, Y[:, 0], Xv, Yv[:, 0]
    return X, Y, Xv, Yv


def _jcfg(**kw):
    base = dict(kernel_params=(("sigma", SIGMA),), lam=LAM, num_centers=M, iterations=20,
                ops_impl="jnp", estimate_cond=False)
    return JConfig(**{**base, **kw})


def _cfg(impl, **kw):
    base = dict(kernel_params=(("sigma", SIGMA),), lam=LAM, num_centers=M, iterations=20,
                ops_impl=impl, estimate_cond=False, device="cpu")
    return FalkonConfig(**{**base, **kw})


def _ops(impl, counting=False):
    ops = get_ops(impl, make_kernel("gaussian", sigma=SIGMA), block_size=2048)
    return CountingOps(ops) if counting else ops


@functools.lru_cache(maxsize=None)
def _reference(n=N, p=None):
    """The problem, its first M rows as centers, and the reference's backend
    and preconditioner on them."""
    X, y, Xv, yv = _problem(n, p)
    C = X[:M]
    jops = jget_ops("jnp", _jcfg().make_kernel(), block_size=2048)
    jP = jmake_preconditioner(jops.gram(jnp.asarray(C), jnp.asarray(C)), LAM, n)
    return X, y, Xv, yv, C, jops, jP


def _port_precond(jP):
    return preconditioner_from_numpy(dict(T=np.asarray(jP.T), A=np.asarray(jP.A),
                                          n=np.asarray(jP.n)), device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _carry(state):
    return minibatch_state_from_numpy({k: np.asarray(v) for k, v in state._asdict().items()},
                                      device="cpu")


# ---------------------------------------------------------------------------
# The update rule, function by function, from one carried-over state
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("p", [None, 2])
def test_step_project_and_step_size_match_reference(impl, p):
    """From a reference state two steps and a projection into a warm start
    (velocity, tail average, g0 set), ``minibatch_step`` (a ragged masked
    chunk), ``minibatch_project`` (tail averaging on, a relative tol) and
    ``estimate_step_size`` (a masked pilot chunk) match the reference's from
    the same state; the counters carry over with their types."""
    X, y, _, _, C, jops, jP = _reference(N, p)
    P, ops = _port_precond(jP), _ops(impl)
    rng = np.random.default_rng(3)
    beta0 = (0.1 * rng.standard_normal((jP.q,) + y.shape[1:])).astype(np.float32)
    mask = (np.arange(CHUNK) < 400).astype(np.float32)
    js = jinit(jP, jnp.asarray(beta0))
    js = jstep(jops, jnp.asarray(C), js, jnp.asarray(X[:CHUNK]), jnp.asarray(y[:CHUNK]))
    js = jstep(jops, jnp.asarray(C), js, jnp.asarray(X[CHUNK:2 * CHUNK]),
               jnp.asarray(y[CHUNK:2 * CHUNK]), row_mask=jnp.asarray(mask))
    kw = dict(step_size=0.05, momentum=0.8, avg_after=0, tol=0.3)
    js, _ = jproject(jP, LAM, js, **kw)
    ps = _carry(js)
    assert (ps.step.dtype, ps.projections.dtype, ps.acc_rows.dtype) == \
        (torch.int32, torch.int32, torch.float32)
    assert (int(ps.step), int(ps.projections), float(ps.acc_rows)) == (2, 1, 0.0)

    s = slice(2 * CHUNK, 3 * CHUNK)
    jn = jstep(jops, jnp.asarray(C), js, jnp.asarray(X[s]), jnp.asarray(y[s]),
               row_mask=jnp.asarray(mask))
    pn = minibatch_step(ops, _t(C), ps, _t(X[s]), _t(y[s]), row_mask=_t(mask))
    assert rel(pn.acc, jn.acc) <= FN_TOL
    assert (float(pn.acc_rows), int(pn.step)) == (float(jn.acc_rows), 3)
    assert torch.equal(pn.beta, ps.beta) and torch.equal(pn.gamma, ps.gamma)

    jq, jg = jproject(jP, LAM, jn, **kw)
    pq, pg = minibatch_project(P, LAM, _carry(jn), **{**kw, "step_size": torch.tensor(0.05)})
    for f in ("beta", "velocity", "beta_bar", "gamma", "g0_sq"):
        assert rel(getattr(pq, f), getattr(jq, f)) <= FN_TOL, f
    assert rel(pg, jg) <= FN_TOL
    assert (float(pq.num_avg), int(pq.projections), float(pq.acc_rows)) == (2.0, 2, 0.0)
    assert not pq.acc.any()

    jeta = jstep_size(jops, jnp.asarray(C), jP, LAM, jnp.asarray(X[:CHUNK]),
                      jnp.asarray(mask), iters=5)
    peta = estimate_step_size(ops, _t(C), P, LAM, _t(X[:CHUNK]), _t(mask), iters=5)
    assert peta.ndim == 0 and abs(float(peta) / float(jeta) - 1) <= ETA_TOL


# ---------------------------------------------------------------------------
# Whole solves and fits against the reference (shuffle=False)
# ---------------------------------------------------------------------------
MB = dict(chunk_rows=CHUNK, project_every=2, epochs=2, shuffle=False)


@functools.lru_cache(maxsize=None)
def _ref_solves(n, p):
    X, y, _, _, C, jops, jP = _reference(n, p)
    mb = JMB(**MB)
    incore = jsolve(jnp.asarray(X), jnp.asarray(y), jnp.asarray(C), jP, LAM, mb, ops=jops,
                    key=jax.random.PRNGKey(0))
    loader = JLoader(JArraySource(X, y, chunk_rows=CHUNK), prefetch=0)
    stream = jsolve_stream(loader, jnp.asarray(C), jP, LAM, mb, ops=jops,
                           out_dim=y.shape[1:])
    return incore, stream


def _held(res, ref):
    assert rel(res.alpha, ref.alpha) <= SOLVE_TOL["alpha"]
    assert rel(res.grad_norms, ref.grad_norms) <= SOLVE_TOL["grad"]
    assert abs(float(res.step_size) / float(ref.step_size) - 1) <= ETA_TOL
    assert (res.pilot_sweeps, res.rows_swept) == (ref.pilot_sweeps, ref.rows_swept)
    assert (int(res.state.step), int(res.state.projections)) == \
        (int(ref.state.step), int(ref.state.projections))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n,p", [(N, None), (1800, 2)])
def test_solves_match_reference(impl, n, p):
    """``minibatch_solve`` and ``minibatch_solve_stream`` (a ragged tail
    at n = 1800) on the reference's preconditioner, step size estimated."""
    X, y, _, _, C, _, jP = _reference(n, p)
    P, ops, mb = _port_precond(jP), _ops(impl), MinibatchConfig(**MB)
    incore, stream = _ref_solves(n, p)
    _held(minibatch_solve(_t(X), _t(y), _t(C), P, LAM, mb, ops=ops), incore)
    loader = StreamingLoader(ArrayChunkSource(X, y, chunk_rows=CHUNK), device="cpu")
    _held(minibatch_solve_stream(loader, _t(C), P, LAM, mb, ops=ops, out_dim=y.shape[1:]),
          stream)


@pytest.mark.parametrize("impl", IMPLS)
def test_streamed_solve_with_shuffled_source_matches_reference(impl):
    """Epoch reshuffling through ``ShuffledChunkSource``: the same numpy
    seed gives both packages the same chunks, so their solves agree."""
    X, y, _, _, C, jops, jP = _reference(1800, None)
    mb = dict(MB, shuffle=True, step_size=0.05)
    ref = jsolve_stream(JLoader(JShuffledSource(JArraySource(X, y, chunk_rows=CHUNK), seed=11),
                                prefetch=0),
                        jnp.asarray(C), jP, LAM, JMB(**mb), ops=jops)
    src = ShuffledChunkSource(ArrayChunkSource(X, y, chunk_rows=CHUNK), seed=11)
    got = minibatch_solve_stream(StreamingLoader(src, device="cpu"), _t(C), _port_precond(jP),
                                 LAM, MinibatchConfig(**mb), ops=_ops(impl))
    _held(got, ref)


@pytest.mark.parametrize("impl", IMPLS)
def test_fits_match_reference(impl):
    """``falkon_fit_minibatch`` and ``falkon_fit_minibatch_streaming`` on
    the reference's centers: alpha and predictions."""
    X, y, Xv, _, C, _, _ = _reference(N, None)
    mb = MinibatchConfig(**MB)
    jest, _ = jfit_mb(jax.random.PRNGKey(1), jnp.asarray(X), jnp.asarray(y), _jcfg(), JMB(**MB),
                      centers=jnp.asarray(C))
    jpred = np.asarray(jest.predict(jnp.asarray(Xv)))
    est, res = falkon_fit_minibatch(1, X, y, _cfg(impl), mb, centers=C)
    assert rel(est.alpha, jest.alpha) <= SOLVE_TOL["alpha"]
    assert rel(est.predict(Xv), jpred) <= SOLVE_TOL["pred"]
    assert (est.precond is not None, est.lam) == (True, LAM)
    jst, _ = jfit_mb_stream(jax.random.PRNGKey(1), JArraySource(X, y, chunk_rows=CHUNK),
                            _jcfg(), JMB(**MB), centers=jnp.asarray(C), prefetch=0)
    st, _ = falkon_fit_minibatch_streaming(1, ArrayChunkSource(X, y, chunk_rows=CHUNK),
                                           _cfg(impl), mb, centers=C)
    assert rel(st.alpha, jst.alpha) <= SOLVE_TOL["alpha"]
    assert rel(st.predict(Xv), jst.predict(jnp.asarray(Xv))) <= SOLVE_TOL["pred"]


@pytest.mark.parametrize("impl", IMPLS)
def test_partial_fit_matches_reference(impl):
    """``partial_fit`` of a carried-over fitted estimator on a tail: the
    refreshed alpha and predictions; the new estimator holds the SAME
    centers tensor and an alpha of the same shape, dtype and device."""
    X, y, Xv, _ = _problem(3072)
    jest, _ = jfit(jax.random.PRNGKey(1), jnp.asarray(X[:2048]), jnp.asarray(y[:2048]), _jcfg())
    mb = dict(chunk_rows=256, project_every=2, epochs=2, shuffle=False)
    jnew = jest.partial_fit(jnp.asarray(X[2048:]), jnp.asarray(y[2048:]), JMB(**mb))
    est = estimator_from_numpy(
        dict(centers=np.asarray(jest.centers), alpha=np.asarray(jest.alpha)),
        ("gaussian", dict(sigma=SIGMA)), ops_impl=impl, device="cpu", lam=LAM,
        precond=dict(T=np.asarray(jest.precond.T), A=np.asarray(jest.precond.A),
                     n=np.asarray(jest.precond.n)))
    new = est.partial_fit(X[2048:], y[2048:], MinibatchConfig(**mb))
    assert new is not est and new.centers is est.centers
    assert (new.alpha.shape, new.alpha.dtype, new.alpha.device) == \
        (est.alpha.shape, est.alpha.dtype, est.alpha.device)
    assert (new.precond, new.lam, new.ops_impl) == (est.precond, est.lam, impl)
    assert rel(new.alpha, jnew.alpha) <= SOLVE_TOL["alpha"]
    assert rel(new.predict(Xv), jnew.predict(jnp.asarray(Xv))) <= SOLVE_TOL["pred"]


# ---------------------------------------------------------------------------
# The reference's contracts, on the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n", [2048, 1800])   # divisible, ragged tail
def test_one_chunk_sweep_per_step_exactly(impl, n):
    X, y, _, _ = _problem(n)
    C = _t(X[:M])
    ops = _ops(impl, counting=True)
    P = make_preconditioner(ops.gram(C, C), LAM, n)
    mb = MinibatchConfig(chunk_rows=CHUNK, project_every=2, epochs=2, power_iters=3,
                         shuffle=False)
    loader = StreamingLoader(ArrayChunkSource(X, y, chunk_rows=CHUNK), device="cpu")
    res = minibatch_solve_stream(loader, C, P, LAM, mb, ops=ops)
    steps = mb.epochs * -(-n // CHUNK)
    assert int(res.state.step) == steps
    assert ops.sweeps == mb.power_iters + steps          # exactly
    assert res.rows_swept == float((mb.power_iters + steps) * CHUNK)
    assert ops.sweep_shapes == {((CHUNK, D), torch.float32)}
    before = ops.sweeps
    res = minibatch_solve(_t(X), _t(y), C, P, LAM, mb, ops=ops)
    assert ops.sweeps - before == mb.power_iters + int(res.state.step)
    assert res.rows_swept == float((mb.power_iters + int(res.state.step)) * CHUNK)


def test_full_batch_period_is_fixed_point_of_exact_solve():
    """``project_every * chunk_rows >= n`` makes the accumulated gradient
    exact, so a converged CG solution stays put under ``partial_fit``."""
    X, y, Xv, _ = _problem(2048)
    est, _ = falkon_fit(1, X, y, _cfg("torch", iterations=40))
    mb = MinibatchConfig(chunk_rows=X.shape[0], project_every=1, epochs=3, momentum=0.0,
                         avg_start=1.0, shuffle=False)
    before = est.predict(Xv).numpy()
    after = est.partial_fit(X, y, mb).predict(Xv).numpy()
    assert np.max(np.abs(after - before)) < 1e-3 * np.max(np.abs(before))


def test_minibatch_reaches_full_cg_quality():
    X, y, Xv, yv = _problem(4096)
    cfg = _cfg("torch", num_centers=128)
    est_full, _ = falkon_fit(1, X, y, cfg)
    mse_full = float(np.mean((est_full.predict(Xv).numpy() - yv) ** 2))
    mb = MinibatchConfig(chunk_rows=512, project_every=2, epochs=8)
    est_mb, res = falkon_fit_minibatch(1, X, y, cfg, mb, centers=est_full.centers)
    mse_mb = float(np.mean((est_mb.predict(Xv).numpy() - yv) ** 2))
    assert mse_full < 0.1 * float(np.var(yv))    # the task is learnable
    assert mse_mb < 1.5 * mse_full
    gn = res.grad_norms.numpy()
    assert gn[-1] < 0.2 * gn[0]


@pytest.mark.parametrize("impl", IMPLS)
def test_incore_and_streamed_drivers_agree_bit_for_bit(impl):
    """shuffle=False: the in-core driver's extra all-masked chunk (n =
    1200 pads to 2048 rows, the stream has 3 chunks) adds exact zeros, and
    every other chunk, mask and the pilot are the same, so alpha, the
    gradient norms and the state are equal bit for bit."""
    X, y, _, _ = _problem(1200)
    C = _t(X[:M])
    ops = _ops(impl)
    P = make_preconditioner(ops.gram(C, C), LAM, 1200)
    mb = MinibatchConfig(chunk_rows=CHUNK, project_every=2, epochs=3, shuffle=False)
    a = minibatch_solve(_t(X), _t(y), C, P, LAM, mb, ops=ops)
    loader = StreamingLoader(ArrayChunkSource(X, y, chunk_rows=CHUNK), device="cpu")
    b = minibatch_solve_stream(loader, C, P, LAM, mb, ops=ops)
    assert torch.equal(a.alpha, b.alpha) and torch.equal(a.grad_norms, b.grad_norms)
    assert torch.equal(a.state.beta, b.state.beta) and torch.equal(a.step_size, b.step_size)
    assert int(a.state.step) == int(b.state.step) + mb.epochs   # the masked chunks
    est_in, _ = falkon_fit_minibatch(0, X, y, _cfg(impl), mb, centers=X[:M])
    est_st, _ = falkon_fit_minibatch_streaming(0, ArrayChunkSource(X, y, chunk_rows=CHUNK),
                                               _cfg(impl), mb, centers=X[:M])
    assert torch.equal(est_in.alpha, est_st.alpha)


def test_incore_shuffle_visits_every_row_once_an_epoch():
    """Each epoch's chunks (their unmasked rows) are a permutation of the
    rows, a fresh one every epoch, drawn from the generator."""
    n = 1500
    X = np.random.default_rng(0).standard_normal((n, D)).astype(np.float32)
    X[:, 0] = np.arange(n)
    seen = []

    class Recording(CountingOps):
        def sweep(self, X, C, u, v=None, row_mask=None):
            seen.append(X[row_mask > 0, 0].clone())
            return super().sweep(X, C, u, v, row_mask)

    ops = Recording(_ops("torch"))
    C = _t(X[:M])
    P = make_preconditioner(ops.gram(C, C), LAM, n)
    mb = MinibatchConfig(chunk_rows=256, project_every=3, epochs=3, step_size=0.01)
    gen = torch.Generator().manual_seed(4)
    minibatch_solve(_t(X), torch.zeros(n), C, P, LAM, mb, ops=ops, generator=gen)
    per_epoch = len(seen) // mb.epochs
    assert per_epoch == 6     # 1500 rows pad to 2 periods of 3 x 256
    orders = [torch.cat(seen[e * per_epoch:(e + 1) * per_epoch]) for e in range(mb.epochs)]
    for order in orders:
        assert torch.equal(torch.sort(order).values, torch.arange(n, dtype=torch.float32))
    assert not torch.equal(orders[0], orders[1])
    assert not torch.equal(orders[0], torch.arange(n, dtype=torch.float32))


@pytest.mark.parametrize("kw", [
    dict(chunk_rows=0), dict(project_every=-1), dict(epochs=0), dict(step_size=0.0),
    dict(step_safety=2.5), dict(power_iters=0), dict(momentum=1.0), dict(avg_start=1.5),
    dict(tol=-1e-3)])
def test_minibatch_config_rejects(kw):
    with pytest.raises(ValueError):
        MinibatchConfig(**kw)
    with pytest.raises(ValueError):
        JMB(**kw)


def test_refusals():
    """A K_nM cache (in-core: the mini-batch message; streamed: the
    streamed fits' message, as in the reference), and ``partial_fit``
    without the fit-time preconditioner or with another output width."""
    X, y, _, _ = _problem(512)
    with pytest.raises(ValueError, match="mini-batch solver does not support knm_cache"):
        falkon_fit_minibatch(0, X, y, _cfg("torch", knm_cache="device"))
    with pytest.raises(ValueError, match="streaming fits do not support knm_cache"):
        falkon_fit_minibatch_streaming(0, ArrayChunkSource(X, y, chunk_rows=128),
                                       _cfg("torch", knm_cache="device"))
    est, _ = falkon_fit(1, X, y, _cfg("torch", iterations=5))
    bare = type(est)(est.centers, est.alpha, est.kernel, ops_impl="torch")
    with pytest.raises(ValueError, match="preconditioner"):
        bare.partial_fit(X[:128], y[:128])
    with pytest.raises(ValueError, match="output width"):
        est.partial_fit(X[:128], np.stack([y[:128], y[:128]], axis=1))
    new = est.partial_fit(X[:256], y[:256], MinibatchConfig(chunk_rows=128, epochs=1))
    assert new.centers is est.centers and new.centers.data_ptr() == est.centers.data_ptr()


# ---------------------------------------------------------------------------
# The bf16 policy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
def test_bf16_fit_matches_reference(impl):
    """The reference quantizes each chunk inside ``ops.sweep``; the port
    quantizes X once. Rounding is per element, so one chunk sweep gives the
    same bits either way, and the bf16 fits agree to the policy's bound."""
    X, y, Xv, _, C, _, _ = _reference(N, None)
    ops = get_ops(impl, make_kernel("gaussian", sigma=SIGMA), precision="bf16")
    u = torch.from_numpy(np.random.default_rng(2).standard_normal(M).astype(np.float32))
    xc, yc = _t(X[:CHUNK]), _t(y[:CHUNK])
    assert torch.equal(ops.sweep(xc, _t(C), u, -yc),
                       ops.sweep(xc.to(torch.bfloat16), _t(C).to(torch.bfloat16), u,
                                 -yc.to(torch.bfloat16)))
    jest, _ = jfit_mb(jax.random.PRNGKey(1), jnp.asarray(X), jnp.asarray(y),
                      _jcfg(precision="bf16"), JMB(**MB), centers=jnp.asarray(C))
    est, _ = falkon_fit_minibatch(1, X, y, _cfg(impl, precision="bf16"),
                                  MinibatchConfig(**MB), centers=C)
    assert rel(est.alpha, jest.alpha) <= BF16_TOL
    assert rel(est.predict(Xv), jest.predict(jnp.asarray(Xv))) <= BF16_TOL


def test_fit_draws_centers_then_shuffles_from_one_generator():
    """Seeded twice alike, a fit repeats itself bit for bit; its centers are
    the ones ``falkon_fit`` draws from the same seed."""
    X, y, _, _ = _problem(1024)
    cfg = _cfg("torch")
    mb = MinibatchConfig(chunk_rows=256, epochs=2)
    a, _ = falkon_fit_minibatch(7, X, y, cfg, mb)
    b, _ = falkon_fit_minibatch(torch.Generator().manual_seed(7), X, y, cfg, mb)
    assert torch.equal(a.alpha, b.alpha)
    assert torch.equal(a.centers, falkon_fit(7, X, y, dataclasses.replace(cfg, iterations=1))[0]
                       .centers)
