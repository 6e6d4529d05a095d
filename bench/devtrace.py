"""Reduce a ``torch.profiler`` trace of the measured window to the device's
busy seconds and a breakdown: the device operations that took the most
time, and the idle gaps by what the host was doing."""
from __future__ import annotations

import collections

import numpy as np
import torch

WINDOW_SPAN = "bench.window"
TOP = 10
#: idle gaps named (the longest ones); the rest only count in busy_s
NAMED_GAPS = 400


def _is_device(evt) -> bool:
    """A kernel, copy or fill on the card; the benchmark's own spans, which
    the profiler also lists on the device's rows, are none."""
    return (evt.device_type == torch.autograd.DeviceType.CUDA
            and not evt.name.startswith("bench."))


def reduce(prof) -> dict:
    """busy_s (union of device operations inside the window span),
    window_s (the span's length), device_ops and idle_gaps (each at most
    ``TOP`` [name, seconds] pairs, largest first)."""
    events = list(prof.events())
    spans = [e for e in events if e.name == WINDOW_SPAN
             and e.device_type == torch.autograd.DeviceType.CPU]
    if not spans:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN!r} span")
    ws, we = spans[0].time_range.start, spans[0].time_range.end
    dev = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                  if _is_device(e) and e.time_range.end > ws and e.time_range.start < we))
    by_name: dict[str, float] = collections.defaultdict(float)
    merged: list[list[float]] = []
    for s, e, name in dev:
        s, e = max(s, ws), min(e, we)
        by_name[name] += (e - s) / 1e6
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy_us = sum(e - s for s, e in merged)
    edges = [ws] + [x for iv in merged for x in iv] + [we]
    gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
            for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
            and e.name != WINDOW_SPAN]
    starts = np.array([e.time_range.start for e in host], dtype=np.float64)
    ends = np.array([e.time_range.end for e in host], dtype=np.float64)
    names = [e.name for e in host]
    by_gap: dict[str, float] = collections.defaultdict(float)
    for length, s, e in gaps[:NAMED_GAPS]:
        by_gap[_host_activity(starts, ends, names, (s + e) / 2)] += length / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"busy_s": busy_us / 1e6, "window_s": (we - ws) / 1e6,
            "device_ops": top(by_name), "idle_gaps": top(by_gap)}


def _host_activity(starts, ends, names, t: float) -> str:
    """The benchmark's innermost span and the innermost host operation
    running at time ``t``, as "bench.sweep/aten::copy_"."""
    inside = np.nonzero((starts <= t) & (ends >= t))[0]
    if inside.size == 0:
        return "host: outside any traced operation"
    durations = ends[inside] - starts[inside]
    inner = names[inside[int(np.argmin(durations))]]
    spans = [i for i in inside if names[i].startswith("bench.")]
    if spans:
        outer = names[min(spans, key=lambda i: ends[i] - starts[i])]
        if outer != inner:
            return f"{outer}/{inner}"
    return inner
