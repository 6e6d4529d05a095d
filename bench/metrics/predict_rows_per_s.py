"""Rows scored a second: every batch's rows over the window's length."""


def read(rec):
    res = rec["result"]
    if "latencies" not in res:
        return None
    return res["rows"] / res["window_s"]
