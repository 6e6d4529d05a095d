"""Summarise runs of cells: each metric's median and spread (the distance
between the first and third quartiles of ``statistics.quantiles(v, n=4)``,
as a share of the median) in each set, and the compared numbers' range.

    python3 bench/spread.py runs.jsonl [...]

Each input line is {"cell", "set", "seed", "trace", "rc", "line"}, with
``line`` the run's result line.
"""
from __future__ import annotations

import collections
import json
import statistics
import sys


def spread(values: list[float]) -> float:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def main(paths: list[str]) -> None:
    rows = [json.loads(line) for p in paths for line in open(p) if line.strip()]
    by = collections.defaultdict(lambda: collections.defaultdict(list))
    checks = collections.defaultdict(lambda: collections.defaultdict(list))
    for r in rows:
        line = r["line"]
        if r["rc"] != 0 or not line:
            print("FAILED", r["cell"], r["set"], r["seed"], r["rc"])
            continue
        if not line["correct"]:
            print("NOT CORRECT", r["cell"], r["set"], r["seed"], line["checks"])
        for k, v in line["checks"].items():
            checks[r["cell"]][k].append(v["value"])
        for k, m in line["metrics"].items():
            by[(r["cell"], r["set"])][k].append(m["value"])
        by[(r["cell"], r["set"])]["memory_peak_GiB"].append(
            line["device"]["memory_peak_bytes"] / 2**30)
        if r["trace"]:
            d = line["device"]
            by[(r["cell"], r["set"])]["busy_share"].append(d["busy_s"] / d["window_s"])
    for (cell, s), metrics in sorted(by.items()):
        for k, v in metrics.items():
            sp = f"spread {spread(v):.5f}" if len(v) >= 2 else ""
            print(f"{cell} set {s} {k}: median {statistics.median(v):.6g} "
                  f"min {min(v):.6g} max {max(v):.6g} n {len(v)} {sp}")
    for cell, d in checks.items():
        for k, v in d.items():
            print(f"{cell} check {k}: min {min(v):.4g} max {max(v):.4g} n {len(v)}")


if __name__ == "__main__":
    main(sys.argv[1:])
