"""A test-only per-layer metric of the test-only kind: the Grams the window made."""


def read(rec):
    return float(rec["result"]["grams"]) if "grams" in rec["result"] else None
