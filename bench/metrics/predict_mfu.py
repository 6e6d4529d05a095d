"""The scoring window's share of the card's float32 peak, in %: the frozen
operation count of every batch (``bench/counts/apply.py``) over the
window's seconds times ``PEAK_FLOPS``."""
from bench.counts import PEAK_FLOPS, apply


def read(rec):
    res, cfg, mix = rec["result"], rec["cfg"], rec["mix"]
    if "latencies" not in res:
        return None
    flops = res["attempted"] * apply.cost(mix["batch_rows"], cfg["num_centers"],
                                          cfg["d"]).flops
    return 100.0 * flops / (res["window_s"] * PEAK_FLOPS)
