"""Seconds a whole fit: the window's length over the fits it completed
(the fit running when ``--seconds`` expired finished and counts)."""


def read(rec):
    res = rec["result"]
    if "fits" not in res:
        return None
    return res["window_s"] / res["attempted"]
