"""The check must fail what is wrong. At the test-only size on the CPU:
the control (the plain reference in float32 with TF32 products, in the
program's place) fails the cells' limits on three seeds, and a run driven
with the timed path broken underneath reads ``correct`` false, once for
each fault the cell can have, held to each benchmark cell's own set of
numbers (``tiny.MIRRORS``). One card, so no exchange between chips can be
left out."""
import json
import time

import pytest
import torch

from bench import calibrate, harness
from bench.tests import tiny


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _limits(cell):
    return harness.cell_of(tiny.spec(), cell, harness.REPO, tiny.DIRS)["limits"]


def test_each_test_cell_compares_its_benchmark_cells_numbers():
    for test_cell, cell in tiny.MIRRORS.items():
        limits = json.loads((harness.HERE / "limits" / f"{cell}.json").read_text())
        assert set(_limits(test_cell)) == set(limits), (test_cell, cell)


@pytest.mark.parametrize("cell", tiny.CELLS)
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_the_control_fails_the_limits(cell, seed):
    limits = _limits(cell)
    got = calibrate.calibrate(tiny.spec(), cell, seed, True, device="cpu", ops_impl="torch",
                              dirs=tiny.DIRS)
    assert any(v > limits[k]["limit"] for k, v in got["numbers"].items()), got


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_a_sound_run_passes_the_limits(cell):
    limits = _limits(cell)
    got = calibrate.calibrate(tiny.spec(), cell, 2**31 + 7, False, device="cpu",
                              ops_impl="torch", dirs=tiny.DIRS)
    assert all(v <= limits[k]["limit"] for k, v in got["numbers"].items()), got


class FaultOps:
    """The program's ops with one fault planted where the answer is made."""

    def __init__(self, ops, fault):
        self.ops, self.fault = ops, fault

    def __getattr__(self, name):
        if name in ("ops", "fault"):
            raise AttributeError(name)
        return getattr(self.ops, name)

    def sweep(self, X, C, u, v=None, row_mask=None):
        if self.fault == "half_batch":         # half the rows left out, scaled up
            h = X.shape[0] // 2
            return 2.0 * self.ops.sweep(X[:h], C, u, None if v is None else v[:h], None)
        return self.ops.sweep(X, C, u, v, row_mask)

    def apply(self, X, C, u):
        if self.fault == "half_batch":         # the rest answered by the half's mean
            h = X.shape[0] // 2
            part = self.ops.apply(X[:h], C, u)
            return torch.cat([part, part.mean(0, keepdim=True).expand(X.shape[0] - h,
                                                                        *part.shape[1:])])
        out = self.ops.apply(X, C, u)
        if self.fault == "altered":
            out = out.clone()
            out[0] += out.abs().max() + 1.0
        return out


def _plant(monkeypatch, fault):
    from repro_torch.core import falkon
    from repro_torch.core.cg import CGResult
    real_get_ops, real_cg, real_wrap = falkon.get_ops, falkon.conjugate_gradient, \
        falkon._stage_wrap
    monkeypatch.setattr(falkon, "get_ops",
                        lambda *a, **k: FaultOps(real_get_ops(*a, **k), fault))
    if fault == "unchanged":                   # every CG step keeps its state
        def cg(W, b, t, **kw):
            r = real_cg(W, b, t, **kw)
            flat = r.residual_norms[:1].expand_as(r.residual_norms)
            return CGResult(x=torch.zeros_like(r.x), residual_norms=flat,
                            iterations=r.iterations)
        monkeypatch.setattr(falkon, "conjugate_gradient", cg)
    if fault == "no_cond":                     # the cond(W) power iteration left out
        real_solve = falkon.falkon_solve
        monkeypatch.setattr(falkon, "falkon_solve",
                            lambda *a, **k: real_solve(*a, **{**k, "estimate_cond": False}))
    if fault == "altered":                     # one coefficient altered as it is made
        def wrap(centers, alpha, *a, **k):
            alpha = alpha.clone()
            alpha[0] += alpha.abs().max()
            return real_wrap(centers, alpha, *a, **k)
        monkeypatch.setattr(falkon, "_stage_wrap", wrap)


@pytest.mark.parametrize("cell,fault", [
    *[(c, f) for c in ("tiny.fit", "tiny.stages")
      for f in ("unchanged", "half_batch", "altered", "no_cond")],
    ("tiny.predict", "half_batch"), ("tiny.predict", "altered")])
def test_a_broken_timed_path_reads_not_correct(monkeypatch, cell, fault):
    _plant(monkeypatch, fault)
    line, _ = harness.run_cell(tiny.spec(), cell, 2**31 + 5, 0.2, False,
                               t_start=time.perf_counter(), device="cpu", ops_impl="torch",
                               dirs=tiny.DIRS)
    assert line["correct"] is False, line["checks"]
