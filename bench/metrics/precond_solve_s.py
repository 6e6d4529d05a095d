"""Device seconds of a fit's preconditioner triangular solves: the
program's spans ``precond.solve`` (``repro_torch.trace``, CUDA events;
those of the right-hand side, CG, cond(W) and the coefficients) summed over
the traced window, per ``fit.solve`` span. None where the program records
no such spans."""


def read(rec):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    spans = trace.totals()["spans"]
    solves = spans.get("fit.solve", {}).get("count", 0)
    tri = spans.get("precond.solve", {}).get("device_s")
    if not solves or tri is None:
        return None
    return tri / solves
