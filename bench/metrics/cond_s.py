"""Device seconds of a fit's cond(W) power iteration: the program's span
``solve.cond`` (``repro_torch.trace``, CUDA events) summed over the traced
window, per ``fit.solve`` span. None where the program records no such
spans."""


def read(rec):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    spans = trace.totals()["spans"]
    solves = spans.get("fit.solve", {}).get("count", 0)
    cond = spans.get("solve.cond", {}).get("device_s")
    if not solves or cond is None:
        return None
    return cond / solves
