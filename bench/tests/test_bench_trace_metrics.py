"""The readers of the program's spans (``cond_s``, ``precond_solve_s``,
``predict_host_ms``) on a traced run of the test-only cells on the CPU, and
None where the program records no such spans (a program without
``repro_torch.trace``, or nothing recorded)."""
import sys
import time

import pytest
import torch

from bench import harness
from bench.tests import tiny

READERS = ("cond_s", "precond_solve_s", "predict_host_ms")


def _traced(cell):
    from repro_torch import trace
    trace.reset()
    line, _ = harness.run_cell(tiny.spec(), cell, 2**31 + 23, 0.3, True,
                               t_start=time.perf_counter(), device="cpu", ops_impl="torch",
                               dirs=tiny.DIRS)
    return line, trace.totals()["spans"]


def test_the_fit_readers_read_the_traced_window():
    torch.set_num_threads(2)
    line, spans = _traced("tiny.stages")
    m = line["metrics"]
    fits = spans["fit.solve"]["count"]
    assert fits == line["attempted"] and "predict_host_ms" not in m
    assert m["cond_s"]["value"] == pytest.approx(spans["solve.cond"]["device_s"] / fits)
    assert m["precond_solve_s"]["value"] == pytest.approx(
        spans["precond.solve"]["device_s"] / fits)
    assert (m["cond_s"]["unit"], m["precond_solve_s"]["unit"]) == ("s", "s")
    phases = sum(spans[f"solve.{p}"]["device_s"] for p in ("rhs", "cg", "cond", "coeffs"))
    assert 0 < phases / fits <= m["solve_s"]["value"] * 1.01


def test_the_predict_reader_reads_the_traced_window():
    torch.set_num_threads(2)
    line, spans = _traced("tiny.predict")
    m = line["metrics"]
    assert set(m) >= {"predict_host_ms"} and not {"cond_s", "precond_solve_s"} & set(m)
    t = spans["estimator.predict"]
    assert t["count"] == line["attempted"]
    assert m["predict_host_ms"]["value"] == pytest.approx(1e3 * t["host_s"] / t["count"])
    assert m["predict_host_ms"]["unit"] == "ms"


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_nothing_where_no_span_was_recorded(name, monkeypatch):
    from repro_torch import trace
    read = harness.load_reader((harness.HERE,), name)
    trace.reset()
    assert read({}) is None
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)   # a program without it
    monkeypatch.delattr(sys.modules["repro_torch"], "trace")
    assert read({}) is None
