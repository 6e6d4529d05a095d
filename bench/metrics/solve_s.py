"""Seconds of a fit's solve stage (CG and the cond(W) estimate:
``falkon_fit(stage_times=)["solve"]``), the mean over the traced window's
fits."""


def read(rec):
    fits = rec["result"].get("fits")
    if not fits or any(not f["stage_times"] for f in fits):
        return None
    return sum(f["stage_times"]["solve"] for f in fits) / len(fits)
