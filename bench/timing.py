"""A delegating facade over the program's ``KernelOps`` that times every
``sweep``, ``apply`` and ``gram`` call with CUDA events (the host clock on
the CPU) and names it in the profiler's trace (``bench.sweep`` etc.).
Only the traced run wraps the program's ops in it."""
from __future__ import annotations

import time

import torch


class TimedOps:
    """Pure delegation plus one record a call: (kind, shape, start, end).
    ``shape`` is what the frozen counts take: (n, M, d, p, with_v) for a
    sweep, (n, M, d, p) for an apply, (M, d) for a Gram of one tensor."""

    def __init__(self, ops):
        self.ops = ops
        self.calls: list[tuple] = []

    def __getattr__(self, name):
        if name == "ops":
            raise AttributeError(name)
        return getattr(self.ops, name)

    def _run(self, kind: str, shape: tuple, device: torch.device, fn, *args):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        else:
            start = time.perf_counter()
        with torch.profiler.record_function(f"bench.{kind}"):
            out = fn(*args)
        if device.type == "cuda":
            end.record()
        else:
            end = time.perf_counter()
        self.calls.append((kind, shape, start, end))
        return out

    def sweep(self, X, C, u, v=None, row_mask=None):
        p = u.shape[1] if u.ndim > 1 else 1
        shape = (X.shape[0], C.shape[0], X.shape[1], p, v is not None)
        return self._run("sweep", shape, X.device, self.ops.sweep, X, C, u, v, row_mask)

    def apply(self, X, C, u):
        p = u.shape[1] if u.ndim > 1 else 1
        shape = (X.shape[0], C.shape[0], X.shape[1], p)
        return self._run("apply", shape, X.device, self.ops.apply, X, C, u)

    def gram(self, A, B):
        if B is not A:
            raise ValueError("the benchmark counts K(C, C) of one tensor only")
        return self._run("gram", (A.shape[0], A.shape[1]), A.device, self.ops.gram, A, B)

    def records(self) -> list[tuple[str, tuple, float]]:
        """(kind, shape, seconds) of every call; call after a synchronize."""
        out = []
        for kind, shape, start, end in self.calls:
            sec = (start.elapsed_time(end) / 1e3 if isinstance(start, torch.cuda.Event)
                   else end - start)
            out.append((kind, shape, sec))
        return out
