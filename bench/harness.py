"""Run one cell of ``BENCHMARK.json`` once and compose its result line.

Everything a cell needs is found by name in the search directories (the
benchmark's own folder, and a test's folder before it): the configuration
file that ``BENCHMARK.json`` names, ``traffic/<mix>.json``, the code of
the mix's kind ``kinds/<kind>.py``, ``limits/<cell>.json`` and one reader
``metrics/<metric>.py`` for every metric, end-to-end or per-layer. Adding
a cell, a configuration, a mix, a kind of traffic or a metric adds files
and entries; no code here changes.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import devtrace

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
#: top-level module names that no run may load: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted(name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN)


def load_spec(path: Path | None = None) -> dict:
    return json.loads((path or REPO / "BENCHMARK.json").read_text())


def _find(dirs, sub: str, name: str, suffix: str) -> Path:
    for d in dirs:
        p = Path(d) / sub / f"{name}{suffix}"
        if p.exists():
            return p
    raise FileNotFoundError(f"no {sub}/{name}{suffix} under {[str(d) for d in dirs]}")


def _load(dirs, sub: str, name: str):
    path = _find(dirs, sub, name, ".py")
    spec = importlib.util.spec_from_file_location(f"bench_{sub}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(dirs, name: str):
    """The ``read(record)`` function of ``metrics/<name>.py``."""
    return _load(dirs, "metrics", name).read


def load_kind(dirs, kind: str):
    """The ``Loop`` class of ``kinds/<kind>.py``."""
    return _load(dirs, "kinds", kind).Loop


def cell_of(spec: dict, workload: str, root: Path = REPO, dirs=(HERE,)) -> dict:
    """The cell's entry, configuration, traffic mix and limits."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; have {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    return {"cell": cell,
            "cfg": json.loads((root / conf["file"]).read_text()),
            "mix": json.loads(_find(dirs, "traffic", cell["traffic"], ".json").read_text()),
            "limits": json.loads(_find(dirs, "limits", workload, ".json").read_text())}


def metrics_of(spec: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics this cell reports: its end-to-end metrics with
    ``--trace 0``, its per-layer metrics with ``--trace 1``."""
    if not trace:
        return [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    e2e = {m["name"] for m in metrics_of(spec, workload, False)}
    return [m for m in spec["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in e2e else [])]


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(spec: dict, workload: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda", ops_impl: str = "cuda",
             dirs=(HERE,), root: Path = REPO) -> tuple[dict, list[str]]:
    """One run: set-up, the window, the check. Returns the result line and
    the lines of the compared numbers beside their limits."""
    c = cell_of(spec, workload, root, dirs)
    loop = load_kind(dirs, c["mix"]["kind"])(c["cfg"], c["mix"], seed, device, ops_impl,
                                              trace, c["limits"])
    dev = torch.device(device)
    loop.setup()
    setup_s = time.perf_counter() - t_start
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts) if trace else contextlib.nullcontext()
    with prof, torch.profiler.record_function(devtrace.WINDOW_SPAN):
        result = loop.window(seconds)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        red = result["reduced"] = devtrace.reduce(prof)
        del prof
        device_info.update(busy_s=red["busy_s"], window_s=red["window_s"],
                           power=power_limit() if dev.type == "cuda" else "cpu")
        breakdown = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
    metrics = {}
    record = {"cfg": c["cfg"], "mix": c["mix"], "result": result, "setup_s": setup_s}
    for m in metrics_of(spec, workload, trace):
        value = load_reader(dirs, m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        elif not trace:
            raise RuntimeError(f"{workload}: the end-to-end metric {m['name']} read nothing")
    numbers = loop.check()
    if set(numbers) != set(c["limits"]):
        raise KeyError(f"compared numbers {sorted(numbers)} != limits "
                       f"{sorted(c['limits'])} of {workload}")
    checks = {k: {"value": v, "limit": c["limits"][k]["limit"]} for k, v in numbers.items()}
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    out = {"correct": correct, "attempted": result["attempted"],
           "failed": 0 if correct else 1, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["info"] = loop.info
    out["checks"] = checks
    notes = [f"{k} {v['value']!r} limit {v['limit']!r}" for k, v in checks.items()]
    return out, notes
