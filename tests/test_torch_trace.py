"""The port's spans and counters (``repro_torch.trace``) on the CPU: off by
default and free there, on inside ``trace.recording()`` or a
``torch.profiler`` session, the span tree of a fit, and the timers that
read through it (``stage_times``, ``FactorStats``, the mini-batch split,
the server's dispatch time)."""
import collections

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.core import (FalkonConfig, MinibatchConfig, falkon_fit, falkon_fit_minibatch,
                              falkon_fit_streaming)
from repro_torch.data import ArrayChunkSource
from repro_torch.kernels import blocked_cholesky as bc
from repro_torch.ops import FactorPlanWarning
from repro_torch.serve.server import CoalescingPredictServer

N, D, M, T = 1200, 5, 96, 20


@pytest.fixture(autouse=True)
def _clean():
    torch.set_num_threads(1)
    trace.reset()
    yield
    trace.reset()


def _data(n=N):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, D)).astype(np.float32)
    y = np.sin(X @ rng.standard_normal(D)).astype(np.float32)
    return X, y


def _cfg(impl="cuda", **kw):
    return FalkonConfig(kernel_params=(("sigma", 2.0),), num_centers=M, iterations=T,
                        lam=1e-4, device="cpu", ops_impl=impl, **kw)


def test_off_a_fit_and_a_predict_record_nothing():
    X, y = _data()
    est, _ = falkon_fit(0, X, y, _cfg())
    est.predict(X[:50])
    assert trace.spans() == [] and trace.totals() == {"spans": {}, "counters": {}}


def test_off_a_span_makes_no_event_and_no_profiler_call(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("tracing off must not reach this")

    monkeypatch.setattr(torch, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert trace.span("a", device=torch.device("cuda")) is trace.span("b")
    with trace.span("a", device=torch.device("cuda")):
        trace.count("a.rows", 3)
    trace.start("c").end()
    X, y = _data()
    est, _ = falkon_fit(0, X, y, _cfg())
    est.predict(X[:50])
    assert trace.spans() == []


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_a_fit_records_its_tree(impl):
    X, y = _data()
    base = {}
    falkon_fit(0, X, y, _cfg(impl), stage_times=base)
    with trace.recording():
        times = {}
        falkon_fit(0, X, y, _cfg(impl), stage_times=times)
    assert list(times) == list(base)
    recs = trace.spans()
    sweeps = collections.Counter(r.parent.name for r in recs if r.name == "ops.sweep")
    assert sweeps == {"solve.rhs": 1, "solve.cg": T, "solve.cond": 26}
    assert {r.request for r in recs} == {recs[-1].request} and recs[-1].name == "fit"
    for r in recs:
        if r.parent is not None:
            assert r.parent.start_ns <= r.start_ns <= r.end_ns <= r.parent.end_ns
    tot = trace.totals()
    spans = tot["spans"]
    for name, t in spans.items():
        assert 0 <= t["host_self_s"] <= t["host_s"] + 1e-9, name
        if "device_s" in t:
            assert 0 <= t["device_self_s"] <= t["device_s"] + 1e-9, name
    for stage in ("centers", "gram", "factor", "solve"):
        assert spans[f"fit.{stage}"]["count"] == 1
    assert spans["fit.solve"]["device_s"] >= sum(
        spans[f"solve.{p}"]["device_s"] for p in ("rhs", "cg", "cond", "coeffs"))
    assert spans["precond.solve"]["count"] == 2 + 6 * (T + 26) + 2
    launches = spans.get("kernel.launch", {}).get("count", 0)
    assert launches == (1 + 1 + T + 26 if impl == "cuda" else 0)


def test_two_fits_have_two_request_ids_and_a_predict_its_own():
    X, y = _data()
    with trace.recording():
        falkon_fit(0, X, y, _cfg())
        est, _ = falkon_fit(1, X, y, _cfg())
        est.predict(X[:50])
    by = collections.defaultdict(set)
    for r in trace.spans():
        by[r.request].add(r.name)
    roots = sorted(r.name for r in trace.spans() if r.parent is None)
    assert roots == ["estimator.predict", "fit", "fit"] and len(by) == 3
    spans = trace.totals()["spans"]
    assert "device_s" not in spans["estimator.predict"] and "device_s" in spans["ops.sweep"]
    assert "kernel.launch" in {r.name for r in trace.spans() if r.parent is not None
                               and r.parent.name == "estimator.predict"}


def test_under_the_profiler_spans_are_plain_cpu_events_of_the_session_only():
    X, y = _data()
    falkon_fit(0, X, y, _cfg())
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        est, _ = falkon_fit(1, X, y, _cfg())
    est.predict(X[:50])
    events = {e.name: e for e in prof.events()}
    for name in ("fit", "fit.solve", "solve.cg", "solve.cond", "precond.solve", "ops.sweep",
                 "kernel.launch"):
        assert name in events, name
        assert events[name].is_user_annotation is False
        assert events[name].device_type == torch.autograd.DeviceType.CPU
    spans = trace.totals()["spans"]
    assert spans["fit"]["count"] == 1 and "estimator.predict" not in spans


def test_fits_and_predictions_are_bit_equal_traced_or_not():
    X, y = _data()
    est0, st0 = falkon_fit(0, X, y, _cfg())
    p0 = est0.predict(X[:300])
    with trace.recording():
        est1, st1 = falkon_fit(0, X, y, _cfg())
        p1 = est1.predict(X[:300])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        est2, st2 = falkon_fit(0, X, y, _cfg())
        p2 = est2.predict(X[:300])
    for a, b in ((est0.alpha, est1.alpha), (est0.alpha, est2.alpha), (p0, p1), (p0, p2),
                 (st0.cond_estimate, st1.cond_estimate), (st0.cond_estimate,
                                                          st2.cond_estimate)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("route", ["knm_cache", "streamed"])
def test_a_cached_or_streamed_solve_names_its_sweeps_too(route):
    X, y = _data()
    with trace.recording():
        if route == "knm_cache":
            falkon_fit(0, X, y, _cfg("torch", knm_cache="device"))
        else:
            falkon_fit_streaming(0, ArrayChunkSource(X, y, chunk_rows=256), _cfg("torch"))
    sweeps = collections.Counter(r.parent.name for r in trace.spans() if r.name == "ops.sweep")
    phases = {"solve.rhs": 1, "solve.cg": T}
    assert sweeps == (phases | {"solve.cond": 26} if route == "knm_cache" else phases)


def test_past_the_cap_spans_are_counted_not_kept(monkeypatch):
    monkeypatch.setattr(trace, "MAX_RECORDS", 3)
    with trace.recording():
        with trace.span("outer"):
            for _ in range(4):
                with trace.span("inner"):
                    pass
    tot = trace.totals()
    assert len(trace.spans()) == 3 and tot["spans"]["inner"]["count"] == 3
    assert tot["counters"] == {"trace.dropped": 2}


def test_recording_nests_and_reset_clears():
    with trace.recording():
        with trace.recording():
            with trace.span("outer"):
                trace.count("k", 2)
        with trace.span("inner"):
            pass
    with trace.span("after"):
        pass
    tot = trace.totals()
    assert set(tot["spans"]) == {"outer", "inner"} and tot["counters"] == {"k": 2}
    trace.reset()
    assert trace.totals() == {"spans": {}, "counters": {}}


def test_a_span_with_a_clock_is_timed_while_tracing_is_off():
    ticks = iter([10.0, 12.5])
    with trace.span("x", clock=lambda: next(ticks)) as s:
        pass
    assert s.seconds == 2.5 and trace.spans() == []


@pytest.fixture
def blocked(monkeypatch):
    """A fit whose factor takes the blocked route (M = 320, 256-wide panels)."""
    monkeypatch.setenv("REPRO_FACTOR_BUDGET_MB", "0.2")
    rng = np.random.default_rng(3)
    X = rng.standard_normal((1500, 6)).astype(np.float32)
    y = (X @ rng.standard_normal(6)).astype(np.float32)
    cfg = FalkonConfig(kernel_params=(("sigma", 1.0),), num_centers=320, lam=1e-3,
                       iterations=3, jitter=1e-3, device="cpu", ops_impl="cuda",
                       estimate_cond=False)
    return X, y, cfg


def test_a_blocked_fit_that_asked_for_nothing_never_clocks_its_factor(blocked, monkeypatch):
    X, y, cfg = blocked
    calls = []
    clock = bc.FactorStats.clock
    monkeypatch.setattr(bc.FactorStats, "clock", lambda self: calls.append(1) or clock(self))
    with pytest.warns(FactorPlanWarning):
        falkon_fit(0, X, y, cfg)
    assert calls == []
    with pytest.warns(FactorPlanWarning), trace.recording():
        falkon_fit(0, X, y, cfg)
    spans = trace.totals()["spans"]
    assert calls == [] and spans["factor.copy"]["count"] > 0 and spans["factor.tile"]["count"]
    times = {}
    with pytest.warns(FactorPlanWarning):
        falkon_fit(0, X, y, cfg, stage_times=times)
    stats = times["factor_stats"]
    assert calls and stats.copy_seconds > 0 and stats.tile_seconds > 0


def test_the_minibatch_split_keeps_its_keys_and_reads_its_spans():
    X, y = _data(1024)
    mb = MinibatchConfig(chunk_rows=128, project_every=2, epochs=2)
    times = {}
    with trace.recording():
        falkon_fit_minibatch(0, X, y, _cfg(), mb, stage_times=times)
    assert {"steps", "projections", "steps_count", "projections_count"} <= set(times)
    spans = trace.totals()["spans"]
    assert spans["minibatch.step"]["count"] == times["steps_count"] == 8
    assert spans["minibatch.projection"]["count"] == times["projections_count"] == 8
    assert times["steps"] > 0 and times["projections"] > 0


def test_the_server_times_each_dispatch_through_a_span():
    X, y = _data()
    est, _ = falkon_fit(0, X, y, _cfg())
    server = CoalescingPredictServer(est, max_batch=64)
    server.predict_many([X[:10], X[10:100]])
    assert len(server.stats.dispatch_seconds) == server.stats.dispatches > 0
    with trace.recording():
        server.predict_many([X[:10], X[10:100]])
    spans = trace.totals()["spans"]
    assert spans["serve.dispatch"]["count"] == server.stats.dispatches // 2
    assert len(server.stats.dispatch_seconds) == server.stats.dispatches
