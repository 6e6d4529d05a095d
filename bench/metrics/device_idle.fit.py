"""The share of the traced fit window in which no device operation ran,
in % (``torch.profiler``, CUDA activity: kernels, copies, fills)."""


def read(rec):
    red, res = rec["result"].get("reduced"), rec["result"]
    if not red or red["busy_s"] <= 0 or "fits" not in res:
        return None
    return 100.0 * (1.0 - red["busy_s"] / red["window_s"])
