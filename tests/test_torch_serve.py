"""The port's coalescing predict server (``repro_torch.serve``) and its
launcher (``repro_torch.launch.serve``) against the JAX package's.

* The coalescing policy is host arithmetic in both packages: the port's
  ladders, bucket picks and dispatch plans equal the reference's on the
  reference tests' cases.
* Bucketed predictions: each dispatch is one ``apply`` of its zero-padded
  bucket, so every request's rows equal, bit for bit, the rows of
  ``predict`` of that padded bucket. On the CPU a matmul's bits depend on
  its row count, so against ``predict`` of the request alone they are held
  to a stated bound (the H100's B2 is row-local at the serving rungs:
  ``chip_smoke.py`` holds them bit-equal there).
* No capture after warmup: on the CPU ``trace_count`` counts rungs warmed
  (graphs are captured on the card only), and must not move after warmup,
  across flushes and a ``swap_model``.
* The port's server against the reference's on the same carried-over
  estimator; the stacked path tier against each estimator.
"""
import ast
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FalkonConfig as JConfig
from repro.core import falkon_fit as jfit
from repro.core import falkon_fit_path as jfit_path
from repro.serve import CoalescingPredictServer as JServer
from repro.serve import bucket_ladder as jladder
from repro.serve import pick_bucket as jpick
from repro.serve import plan_dispatches as jplan
from repro_torch.convert import estimator_from_numpy, path_result_from_numpy
from repro_torch.core import FalkonConfig, MinibatchConfig, falkon_fit, falkon_fit_path
from repro_torch.serve import (CoalescingPredictServer, bucket_ladder, pick_bucket,
                               plan_dispatches)

D = 6
IMPLS = ("torch", "cuda")
#: a request's served rows against ``predict`` of the request alone (the same
#: row through a matmul of another row count), and a stacked path's column
#: block against its estimator served alone (measured <= 1.32e-5 and 3.3e-6
#: relative to the largest |prediction|: alpha is far larger than the
#: predictions it cancels to)
ALONE_TOL = 4e-5
#: the port's server against the reference's on the same estimator (fp32,
#: other summation orders; measured <= 1.75e-5 relative to the largest
#: |prediction|)
REF_TOL = 5e-5


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _max_rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)) if ref.size else 0.0


def _requests(sizes, d=D, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((int(s), d), dtype=np.float32) for s in sizes]


# ---------------------------------------------------------------------------
# The coalescing policy, against the reference's
# ---------------------------------------------------------------------------
def _plan_tuples(plan):
    return [(d.bucket, d.rows, d.pad_rows, [dataclasses.astuple(s) for s in d.segments])
            for d in plan]


def test_ladder_bucket_and_plan_match_reference():
    for args in ((256,), (64, 4), (100, 6), (1, 1), (4, 32)):
        assert bucket_ladder(*args) == jladder(*args)
    assert bucket_ladder(256) == (8, 16, 32, 64, 128, 256)
    ladder = bucket_ladder(64)
    for rows in (1, 8, 9, 63, 64):
        assert pick_bucket(rows, ladder) == jpick(rows, ladder)
    for bad, match in (((0,), "max_batch"), ((8, 0), "min_bucket")):
        with pytest.raises(ValueError, match=match):
            bucket_ladder(*bad)
    for rows, match in ((65, "exceed"), (0, "rows")):
        with pytest.raises(ValueError, match=match):
            pick_bucket(rows, ladder)
    rng = np.random.default_rng(0)
    cases = [([10, 10, 20, 70, 3], 32), ([40, 40, 40], 64), ([0, 0], 32),
             (list(rng.integers(0, 300, size=40)), 256)]
    for sizes, top in cases:
        lad = bucket_ladder(top)
        assert _plan_tuples(plan_dispatches(sizes, lad)) == _plan_tuples(jplan(sizes, lad))
    plan = plan_dispatches([40, 40, 40], bucket_ladder(64))
    assert [d.rows for d in plan] == [64, 56] and plan[1].pad_rows == 8
    with pytest.raises(ValueError, match="negative"):
        plan_dispatches([-1], bucket_ladder(32))


# ---------------------------------------------------------------------------
# The server over a carried-over fitted estimator
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fitted():
    """The reference's fit (its "jnp" backend) and the problem behind it."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((1500, D)).astype(np.float32)
    y = (np.sin(X @ rng.standard_normal(D)) + 0.05 * rng.standard_normal(1500)).astype(
        np.float32)
    cfg = JConfig(kernel_params=(("sigma", 2.0),), lam=1e-4, num_centers=96, iterations=10,
                  block_size=128, estimate_cond=False)
    jest, _ = jfit(jax.random.PRNGKey(1), jnp.asarray(X), jnp.asarray(y), cfg)
    return jest, X, y


def _port(jest, impl):
    return estimator_from_numpy(
        dict(centers=np.asarray(jest.centers), alpha=np.asarray(jest.alpha)),
        ("gaussian", dict(sigma=2.0)), ops_impl=impl, device="cpu", block_size=128,
        lam=1e-4, precond=dict(T=np.asarray(jest.precond.T), A=np.asarray(jest.precond.A),
                               n=np.asarray(jest.precond.n)))


def _check_served(server, est, reqs, outs):
    """Every request's rows equal ``predict`` of its zero-padded bucket bit
    for bit, and ``predict`` of the request alone within ALONE_TOL."""
    plan = plan_dispatches([r.shape[0] for r in reqs], server.ladder)
    for disp in plan:
        buf = np.zeros((disp.bucket, D), np.float32)
        for s in disp.segments:
            buf[s.buf_offset:s.buf_offset + s.rows] = reqs[s.request][s.req_offset:
                                                                       s.req_offset + s.rows]
        bucket = est.predict(torch.from_numpy(buf)).numpy()
        for s in disp.segments:
            got = outs[s.request][s.req_offset:s.req_offset + s.rows]
            np.testing.assert_array_equal(got, bucket[s.buf_offset:s.buf_offset + s.rows])
    for r, o in zip(reqs, outs):
        assert o.shape == (r.shape[0],) + tuple(est.alpha.shape[1:])
        if r.shape[0]:
            assert _max_rel(o, est.predict(torch.from_numpy(r)).numpy()) <= ALONE_TOL


@pytest.mark.parametrize("impl", IMPLS)
def test_bucketed_predictions_match_direct_and_reference(fitted, impl):
    """Co-packing, padding and request splitting (80 rows past a 32-row
    top) against ``predict``, and against the reference's server on the
    same estimator."""
    jest, _, _ = fitted
    est = _port(jest, impl)
    server = CoalescingPredictServer(est, max_batch=32)
    server.warmup()
    reqs = _requests([1, 5, 32, 31, 17, 80, 2, 9])
    outs = server.predict_many(reqs)
    _check_served(server, est, reqs, outs)
    jouts = JServer(jest, max_batch=32).predict_many(reqs)
    for o, jo in zip(outs, jouts):
        assert _max_rel(o, jo) <= REF_TOL
    st = server.stats
    assert st.requests == 8 and st.dispatches == len(st.dispatch_seconds)
    assert st.rung_dispatches == collections.Counter(
        d.bucket for d in plan_dispatches([r.shape[0] for r in reqs], server.ladder))


@pytest.mark.parametrize("impl", IMPLS)
def test_zero_captures_after_warmup(fitted, impl):
    """One warmed rung each; several flushes of ragged mixes (requests past
    the top split) and many dispatches on one rung in one flush (each
    replay's output must be copied out before the next overwrites it)."""
    est = _port(fitted[0], impl)
    server = CoalescingPredictServer(est, max_batch=64, min_bucket=8)
    secs = server.warmup()
    assert set(secs) == set(server.ladder) == {8, 16, 32, 64}
    assert server.trace_count == len(server.ladder)
    assert server.warmup() and server.trace_count == len(server.ladder)   # idempotent
    rng = np.random.default_rng(0)
    for k in range(3):
        sizes = rng.integers(1, 150, size=23)
        reqs = _requests(sizes, seed=k)
        _check_served(server, est, reqs, server.predict_many(reqs))
    reqs = _requests([64] * 12 + [16] * 9, seed=9)
    _check_served(server, est, reqs, server.predict_many(reqs))
    assert server.retraces_since_warmup() == 0
    assert server.stats.requests == 69 + 21


def test_lazy_warmup_submit_flush_and_zero_rows(fitted):
    est = _port(fitted[0], "torch")
    server = CoalescingPredictServer(est, max_batch=16)
    with pytest.raises(RuntimeError, match="warmup"):
        server.retraces_since_warmup()
    assert server.flush() == []
    assert (server.submit(np.zeros((3, D), np.float32)),
            server.submit(np.zeros((5, D), np.float32))) == (0, 1)
    outs = server.flush()                  # warmup ran lazily
    assert [o.shape for o in outs] == [(3,), (5,)]
    assert server.retraces_since_warmup() == 0
    with pytest.raises(ValueError, match="rows"):
        server.submit(np.zeros((3, D + 1), np.float32))
    outs = server.predict_many([np.zeros((0, D), np.float32), np.ones((4, D), np.float32)])
    assert outs[0].shape == (0,) and outs[1].shape == (4,)
    with pytest.raises(TypeError, match="FalkonEstimator"):
        CoalescingPredictServer(object())
    with pytest.raises(ValueError, match="pipeline_depth"):
        CoalescingPredictServer(est, pipeline_depth=0)


@pytest.mark.parametrize("impl", IMPLS)
def test_multioutput_and_stacked_path_tier(fitted, impl):
    """(M, p) coefficients serve (rows, p); a lam path's L estimators serve
    through one stacked apply per bucket, each column block against that
    estimator's own server."""
    _, X, y = fitted
    cfg = FalkonConfig(kernel_params=(("sigma", 1.5),), lam=1e-4, num_centers=64,
                       iterations=8, block_size=128, estimate_cond=False, ops_impl=impl,
                       device="cpu")
    Y = np.stack([np.sin(X[:600, 0]), np.cos(X[:600, 1])], axis=1).astype(np.float32)
    est, _ = falkon_fit(3, X[:600], Y, cfg)
    server = CoalescingPredictServer(est, max_batch=32)
    reqs = _requests([7, 40, 3])
    _check_served(server, est, reqs, server.predict_many(reqs))

    lams = (1e-5, 1e-4, 1e-3)
    path = falkon_fit_path(1, X, y, cfg, lams)
    server = CoalescingPredictServer(path, max_batch=32)
    server.warmup()
    reqs = _requests([9, 33, 4])
    outs = server.predict_many(reqs)
    assert server.retraces_since_warmup() == 0
    for i, e in enumerate(path.estimators):
        alone = CoalescingPredictServer(e, max_batch=32).predict_many(reqs)
        for o, a in zip(outs, alone):
            assert o.shape == (a.shape[0], len(lams))
            assert _max_rel(o[:, i], a) <= ALONE_TOL


@pytest.mark.parametrize("impl", IMPLS)
def test_multioutput_and_path_tier_match_reference(fitted, impl):
    """A reference (M, 2) estimator and a reference 3-lam path result,
    carried over by ``repro_torch.convert``, served by both packages'
    servers on the same requests: every request's (rows, 2) and
    (rows, L) blocks agree with the reference's to REF_TOL."""
    _, X, y = fitted
    cfg = JConfig(kernel_params=(("sigma", 2.0),), lam=1e-4, num_centers=64, iterations=8,
                  block_size=128, estimate_cond=False)
    Y = np.stack([np.sin(X[:600, 0]), np.cos(X[:600, 1])], axis=1).astype(np.float32)
    jmulti, _ = jfit(jax.random.PRNGKey(3), jnp.asarray(X[:600]), jnp.asarray(Y), cfg)
    jpath = jfit_path(jax.random.PRNGKey(4), jnp.asarray(X), jnp.asarray(y), cfg,
                      (1e-5, 1e-4, 1e-3))
    spec = ("gaussian", dict(sigma=2.0))
    multi = estimator_from_numpy(dict(centers=np.asarray(jmulti.centers),
                                      alpha=np.asarray(jmulti.alpha)), spec, ops_impl=impl,
                                 device="cpu", block_size=128)
    st = jpath.state
    pc = st.precond
    path = path_result_from_numpy(
        dict(centers=np.asarray(st.centers), beta=np.asarray(st.beta),
             alphas=np.asarray(st.alphas), residual_norms=np.asarray(st.residual_norms),
             lams=np.asarray(st.lams),
             precond=dict(T=np.asarray(pc.T), A=np.asarray(pc.A), lams=np.asarray(pc.lams),
                          n=np.asarray(pc.n), diag_T=pc.diag_T,
                          Q=None if pc.Q is None else np.asarray(pc.Q),
                          D=None if pc.D is None else np.asarray(pc.D))),
        spec, ops_impl=impl, device="cpu", block_size=128)
    assert all(e.centers is path.estimators[0].centers for e in path.estimators)
    reqs = _requests([9, 33, 4, 40, 1])
    for ours, ref, width in ((multi, jmulti, 2), (path, jpath, 3)):
        server = CoalescingPredictServer(ours, max_batch=32)
        outs = server.predict_many(reqs)
        jouts = JServer(ref, max_batch=32).predict_many(reqs)
        assert server.retraces_since_warmup() == 0
        for r, o, jo in zip(reqs, outs, jouts):
            assert o.shape == np.asarray(jo).shape == (r.shape[0], width)
            assert _max_rel(o, jo) <= REF_TOL


@pytest.mark.parametrize("impl", IMPLS)
def test_partial_fit_swap_serves_with_zero_captures(fitted, impl):
    """The refresh path end to end: serve, ``partial_fit`` on a tail, hot
    swap, serve again: no capture, the refreshed model's predictions, the
    old estimator untouched; another geometry is refused."""
    jest, X, y = fitted
    est = _port(jest, impl)
    server = CoalescingPredictServer(est, max_batch=64)
    server.warmup()
    reqs = [X[i:i + 13] for i in (0, 40, 80)] + _requests([70, 5])
    _check_served(server, est, reqs, server.predict_many(reqs))
    before = est.alpha.clone()
    new = est.partial_fit(X[1000:], y[1000:], MinibatchConfig(chunk_rows=256, epochs=2))
    assert new.centers is est.centers
    server.swap_model(new)
    _check_served(server, new, reqs, server.predict_many(reqs))
    assert server.retraces_since_warmup() == 0
    assert torch.equal(est.alpha, before) and not torch.equal(new.alpha, before)
    small = estimator_from_numpy(dict(centers=np.zeros((48, D), np.float32),
                                      alpha=np.zeros(48, np.float32)),
                                 ("gaussian", dict(sigma=2.0)), ops_impl=impl, device="cpu")
    with pytest.raises(ValueError, match="geometry"):
        server.swap_model(small)
    with pytest.raises(ValueError, match="geometry"):
        server.swap_model(est.to(torch.float64))


def test_scoring_cache_invalidated_on_swap(fitted):
    """A scoring cache serves the deployed model as GEMMs; a swap
    invalidates and detaches it, and the stale cache refuses."""
    jest, X, y = fitted
    est = _port(jest, "torch")
    server = CoalescingPredictServer(est, max_batch=32)
    with pytest.raises(RuntimeError, match="no scoring cache"):
        server.predict_scoring_set()
    Xe = torch.from_numpy(X[:300])
    cache = est.build_knm_cache(Xe, tier="device")
    server.attach_scoring_cache(cache)
    np.testing.assert_allclose(server.predict_scoring_set(), est.predict(Xe).numpy(),
                               rtol=0, atol=1e-5 * float(est.predict(Xe).abs().max()))
    other = _port(jest, "torch")
    with pytest.raises(ValueError, match="different centers"):
        server.attach_scoring_cache(other.build_knm_cache(Xe, tier="device"))
    server.swap_model(est.partial_fit(X[1000:], y[1000:], MinibatchConfig(chunk_rows=256)))
    with pytest.raises(RuntimeError, match="no scoring cache"):
        server.predict_scoring_set()
    with pytest.raises(ValueError, match="stale"):
        cache.check_serves(est.centers)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("extra", [[], ["--per-request"], ["--stream-chunk", "128"]])
def test_serve_main_falkon(capsys, extra):
    from repro_torch.launch import serve as serve_mod
    serve_mod.main(["--falkon", "--device", "cpu", "--n", "512", "--d", "5", "--centers", "48",
                    "--batch", "16", "--requests", "6"] + extra)
    out = capsys.readouterr().out
    assert "falkon[cuda/fp32]: fit n=512 M=48" in out
    if "--per-request" in extra:
        assert "per-request:" in out and "rows/s" in out
    else:
        assert "coalesced:" in out and "retraces after warmup: 0" in out
        assert "ladder (8, 16)" in out and "(2 rungs warmed)" in out


def test_request_trace_and_lm_mode(capsys):
    """The trace's sizes are the reference's draw from the same seed; the
    LM mode runs the reduced config on the CPU and prints the reference's
    two lines."""
    from repro_torch.launch import serve as serve_mod
    trace = serve_mod.make_request_trace(50, 256, 18, seed=3)
    sizes = np.random.default_rng(3).integers(1, 257, size=50)
    assert [t.shape for t in trace] == [(int(s), 18) for s in sizes]
    assert all(t.dtype == np.float32 for t in trace)
    np.testing.assert_array_equal(np.concatenate(trace),
                                  np.concatenate(serve_mod.make_request_trace(50, 256, 18, 3)))
    serve_mod.main(["--device", "cpu", "--arch", "gemma3-1b", "--prompt-len", "8", "--gen", "6"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("gemma3-1b-smoke: prefill 4x8 in ") and "ms/token/batch" in lines[0]
    assert lines[1].startswith("sample: [") and len(ast.literal_eval(lines[1][len("sample: "):])) == 5
    with pytest.raises(SystemExit):          # an unknown architecture
        serve_mod.main(["--device", "cpu", "--arch", "gpt-nope"])
    with pytest.raises(SystemExit):          # no LM option is read in the FALKON mode
        serve_mod.main(["--falkon", "--device", "cpu", "--arch", "gemma3-1b"])
