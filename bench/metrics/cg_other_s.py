"""Seconds of a fit's solve that its ``ops.sweep`` calls do not take
(the solve stage's wall time minus the CUDA-event time of its sweeps):
the triangular solves, the CG vector work and the host's waits. The mean
over the traced window's fits."""


def read(rec):
    fits = rec["result"].get("fits")
    if not fits or any(not f["stage_times"] for f in fits):
        return None
    other = [f["stage_times"]["solve"] - sum(s for k, _, s in f["calls"] if k == "sweep")
             for f in fits]
    return sum(other) / len(other)
