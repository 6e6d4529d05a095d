"""Seconds of a fit's factor stage (both Cholesky factorizations and
T T^T: ``falkon_fit(stage_times=)["factor"]``), the mean over the traced
window's fits."""


def read(rec):
    fits = rec["result"].get("fits")
    if not fits or any(not f["stage_times"] for f in fits):
        return None
    return sum(f["stage_times"]["factor"] for f in fits) / len(fits)
