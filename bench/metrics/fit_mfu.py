"""A whole fit's share of the card's float32 peak, in %: the fit's frozen
operation count (``bench/counts/fit.py``) over the traced window's
seconds per fit times ``PEAK_FLOPS``."""
from bench.counts import PEAK_FLOPS, fit


def read(rec):
    res, cfg = rec["result"], rec["cfg"]
    if not res.get("fits"):
        return None
    flops = fit.cost(cfg["n"], cfg["num_centers"], cfg["d"], cfg["iterations"],
                     cfg["estimate_cond"]).flops
    return 100.0 * flops / (res["window_s"] / res["attempted"] * PEAK_FLOPS)
