"""Host milliseconds of one ``FalkonEstimator.predict`` call, from its
entry to its return (the launch is asynchronous: its checks, allocations
and the kernel's launch, not the kernel): the program's span
``estimator.predict`` (``repro_torch.trace``) over the traced window, per
call. None where the program records no such span."""


def read(rec):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    t = trace.totals()["spans"].get("estimator.predict")
    if not t or not t["count"]:
        return None
    return 1e3 * t["host_s"] / t["count"]
