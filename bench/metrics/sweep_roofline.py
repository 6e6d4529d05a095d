"""The sweeps' share of their roofline, in %: the frozen least time of
every ``ops.sweep`` call of the traced window (``bench/counts/sweep.py``
at the call's n, M, d, p) over the calls' CUDA-event time."""
from bench.counts import sweep


def read(rec):
    calls = [(shape, s) for f in rec["result"].get("fits", []) for k, shape, s in f["calls"]
             if k == "sweep"]
    if not calls:
        return None
    least = sum(sweep.cost(*shape).least_seconds for shape, _ in calls)
    return 100.0 * least / sum(s for _, s in calls)
