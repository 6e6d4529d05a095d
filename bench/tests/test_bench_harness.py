"""The harness without a card: import hygiene, the spec's form against the
benchmark's contract, and each traffic loop driven once at the test-only
size on the "torch" backend, traced and not, with its result line."""
import ast
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from bench import harness, loops
from bench.tests import tiny

BENCH = harness.HERE
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _imports(path: Path) -> list[tuple[str, int]]:
    """(module, level) of every import statement in the file."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [(a.name, 0) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            out.append((node.module or "", node.level))
    return out


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for path in files:
        for mod, level in _imports(path):
            if level == 0:
                assert mod.split(".")[0] not in harness.FORBIDDEN, f"{path}: imports {mod}"


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        for mod, level in _imports(path):
            top = mod.split(".")[0]
            assert level <= 1, f"{path}: reaches out of reference/ by a relative import"
            assert level == 1 or top in ("torch", "math", "dataclasses", "contextlib",
                                         "__future__"), f"{path}: imports {mod}"


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like_name", sys)
    assert "repro_torch_like_name" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert {"repro.core", "jax"} <= set(harness.forbidden_modules())


def test_the_spec_keeps_the_contracts_form():
    spec = harness.load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["bench"] and spec["command"] == ["python3", "bench/run.py"]
    assert 1 <= spec["run_seconds"] <= 51
    names = [c["name"] for c in spec["configs"]]
    used = {w["config"] for w in spec["workloads"]}
    assert len(set(names)) == len(names) and set(names) == used
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(0 < len(c[k]) <= 200 for k in ("why", "source"))
        cfg = json.loads((harness.REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["name"] == c["name"]
        assert all(NAME.match(k) for k in c["reduced"])
    metrics = spec["end_to_end"] + spec["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in metrics:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert m["name"].endswith("_roofline") == (m["unit"] == "%" and "roofline" in m["name"])
    for w in spec["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200 and w["chips"] == 1
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "kinds" / f"{mix['kind']}.py").exists()
        assert (BENCH / "limits" / f"{w['name']}.json").exists()
        shown = {m["name"] for m in harness.metrics_of(spec, w["name"], False)}
        layer = harness.metrics_of(spec, w["name"], True)
        assert "setup_s" in shown and len(shown) >= 2 and layer
        assert all(m["moves"] in shown for m in layer)
    assert len(json.dumps(spec)) < 64 * 1024


def _run(spec, cell, trace):
    return harness.run_cell(spec, cell, 2**31 + 11, 0.3, trace, t_start=time.perf_counter(),
                            device="cpu", ops_impl="torch", dirs=tiny.DIRS)


@pytest.mark.parametrize("cell", tiny.CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_each_loop_runs_once_on_the_cpu(cell, trace):
    torch.set_num_threads(2)
    spec = tiny.spec()
    line, notes = _run(spec, cell, trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks" and line["correct"] is True
    assert line["attempted"] >= 1 and line["failed"] == 0
    want = {m["name"] for m in harness.metrics_of(spec, cell, trace)}
    if trace:
        assert "breakdown" in line and set(line["device"]) >= {"busy_s", "window_s"}
        # no device on the CPU: the device readers find nothing and stay out
        assert set(line["metrics"]) == want - {"device_idle.fit", "device_idle.predict"}
    else:
        assert set(line["metrics"]) == want
    for name, m in line["metrics"].items():
        assert m["value"] > 0, name
    assert len(notes) == len(line["checks"])
    json.dumps(line)


def test_a_test_only_metric_is_a_file_and_an_entry():
    line, _ = _run(tiny.spec(), "tiny.fit", True)
    assert line["metrics"]["fits_in_window"]["value"] == line["attempted"]


def test_a_test_only_kind_of_traffic_is_files_and_entries():
    line, _ = _run(tiny.spec(), "tiny.gram", False)
    assert set(line["metrics"]) == {"grams_per_s", "setup_s"} and line["correct"] is True
    assert set(line["checks"]) == {"gram_gap"}


def test_a_configuration_runs_every_key_it_states():
    cfg = json.loads((BENCH / "tests" / "configs" / "tiny.json").read_text())
    dev = torch.device("cpu")
    fc = loops.falkon_config({**cfg, "precision": "bf16", "block_size": 512}, "torch", dev)
    assert (fc.precision, fc.block_size, fc.num_centers, fc.lam) == ("bf16", 512, 200, 1e-6)
    assert dict(fc.kernel_params) == {"sigma": 4.0} and fc.jitter is None
    for bad in ({"knm_cach": "device"}, {"kernel": "laplacian"}, {"ops_impl": "cuda"}):
        with pytest.raises(ValueError):
            loops.falkon_config({**cfg, **bad}, "torch", dev)


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "susy.fit",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
