"""The frozen counts against the kernel table's bounds (PERF.md, NVIDIA
H100 80GB HBM3, 700 W), and the whole fit's count at both configurations."""
import json
from pathlib import Path

import pytest

from bench.counts import PEAK_BYTES, PEAK_FLOPS, apply, cholesky, fit, gram, sweep, ttt

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def ms(cost) -> float:
    return round(cost.least_seconds * 1e3, 4)


def test_sweep_matches_the_kernel_table():
    assert ms(sweep.cost(4_000_000, 10_000, 18, 1)) == 29.8507
    assert ms(sweep.cost(463_715, 50_000, 90, 1)) == 67.1349
    assert sweep.cost(4_000_000, 10_000, 18, 1).bound_by == "operations"


def test_apply_and_gram_match_the_kernel_table():
    assert ms(apply.cost(500_000, 10_000, 18, 1)) == 3.5821
    assert ms(gram.cost(10_000, 18)) == 0.1196
    assert gram.cost(10_000, 18).bound_by == "bytes"


def test_sweep_bytes_read_each_input_once():
    n, M, d = 1000, 30, 7
    c = sweep.cost(n, M, d, 2, with_v=True)
    assert c.bytes == 4 * (n * d + M * d + 2 * M + 2 * M + 2 * n)
    assert c.flops == n * M * (2 * d + 10 + 8)


@pytest.mark.parametrize("name", ["susy", "msd"])
def test_fit_count_at_each_configuration(name):
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    n, M, d, t = cfg["n"], cfg["num_centers"], cfg["d"], cfg["iterations"]
    assert fit.sweeps(t) == 47
    want = (47 * n * M * (2 * d + 14)            # 47 width-1 sweeps
            + M * (M + 1) // 2 * (2 * d + 10)    # K_MM's distinct entries
            + 3 * M ** 3 / 3)                    # two Choleskys and T T^T
    got = fit.cost(n, M, d, t, cfg["estimate_cond"]).flops
    assert got == pytest.approx(want, rel=1e-12)
    seconds = {"susy": 1.4179, "msd": 5.0246}[name]
    assert round(got / PEAK_FLOPS, 4) == seconds


def test_factor_counts():
    assert cholesky.cost(300).flops == 300 ** 3 / 3
    assert ttt.cost(300).flops == 300 ** 3 / 3
    assert PEAK_BYTES == 3.35e12 and PEAK_FLOPS == 67e12
