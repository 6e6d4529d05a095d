"""A test-only per-layer metric: the fits the traced window completed."""


def read(rec):
    fits = rec["result"].get("fits")
    return float(len(fits)) if fits else None
