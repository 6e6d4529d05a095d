"""The nearest-rank 95th percentile, in ms, of every batch's latency in
the window (from the call to the end of a ``synchronize()``)."""
import math


def read(rec):
    lat = sorted(rec["result"].get("latencies", []))
    if not lat:
        return None
    return lat[max(0, math.ceil(0.95 * len(lat)) - 1)] * 1e3
