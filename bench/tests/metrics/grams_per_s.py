"""A test-only end-to-end metric: Gram matrices a second."""


def read(rec):
    res = rec["result"]
    return res["grams"] / res["window_s"] if "grams" in res else None
