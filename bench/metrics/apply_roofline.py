"""The predictions' share of their roofline, in %: the frozen least time
of every ``ops.apply`` call of the traced window (``bench/counts/apply.py``
at the call's n, M, d, p) over the calls' CUDA-event time."""
from bench.counts import apply


def read(rec):
    calls = [(shape, s) for k, shape, s in rec["result"].get("calls", []) if k == "apply"]
    if not calls:
        return None
    least = sum(apply.cost(*shape).least_seconds for shape, _ in calls)
    return 100.0 * least / sum(s for _, s in calls)
