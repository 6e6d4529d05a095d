"""Traffic of batch scoring: ``FalkonEstimator.predict`` on batches of
``batch_rows`` rows, one caller, closed loop, cycling through
``distinct_batches`` device-resident batches; the check recomputes
``checked_batches`` of them, drawn from the seed. Centers and alpha come
from the seed: no fit runs."""
from __future__ import annotations

import random
import time

import torch

from bench import loops
from bench.reference import data
from bench.reference import falkon as ref
from bench.timing import TimedOps


class Loop:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, ops_impl: str,
                 timed: bool, numbers=()):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device, self.ops_impl, self.timed = torch.device(device), ops_impl, timed
        loops.closed_loop(mix)
        self.info = {}

    def setup(self, warm: bool = True) -> None:
        from repro_torch.core import FalkonEstimator
        from repro_torch.core.kernels import make_kernel
        self.Xb, self.C, self.alpha = data.predict_inputs(self.seed, self.cfg, self.mix,
                                                          self.device)
        self.est = FalkonEstimator(self.C, self.alpha,
                                   make_kernel("gaussian", sigma=self.cfg["sigma"]),
                                   ops_impl=self.ops_impl)
        for b in range(self.Xb.shape[0] if warm else 0):
            self.est.predict(self.Xb[b])
        loops.sync(self.device)
        if self.timed:
            self.est.ops = TimedOps(self.est.ops)

    def window(self, seconds: float) -> dict:
        rng = random.Random(f"{self.seed}/predict")
        keep = self.mix["checked_batches"]
        lat, kept = [], []
        nb = self.Xb.shape[0]
        t0 = time.perf_counter()
        while True:
            b = len(lat) % nb
            s = time.perf_counter()
            with torch.profiler.record_function("bench.predict"):
                out = self.est.predict(self.Xb[b])
            loops.sync(self.device)
            e = time.perf_counter()
            lat.append(e - s)
            if len(kept) < keep:                       # reservoir of ``keep`` batches
                kept.append((b, out))
            else:
                j = rng.randrange(len(lat))
                if j < keep:
                    kept[j] = (b, out)
            del out
            if e - t0 >= seconds:
                break
        self.kept = kept
        ops = self.est.ops
        calls = ops.records() if isinstance(ops, TimedOps) else []
        return {"window_s": e - t0, "attempted": len(lat), "latencies": lat,
                "rows": len(lat) * self.Xb.shape[1], "calls": calls}

    def control(self) -> None:
        """The control's answers for the first ``checked_batches`` batches."""
        gamma = 0.5 / self.cfg["sigma"] ** 2
        self.kept = [(b, ref.apply(self.Xb[b], self.C, self.alpha, gamma, ref.CONTROL))
                     for b in range(min(self.mix["checked_batches"], self.Xb.shape[0]))]

    def check(self) -> dict:
        """The widest gap of a checked batch's rows from the float64
        reference, each row's gap over the scale of its sum, K |alpha|."""
        gamma = 0.5 / self.cfg["sigma"] ** 2
        C, a = self.C.to(torch.float64), self.alpha.to(torch.float64)
        gap = 0.0
        for b, out in self.kept:
            p, scale = ref.apply(self.Xb[b].to(torch.float64), C, a, gamma, ref.REFERENCE,
                                 absolute=True)
            gap = max(gap, float(((out.to(torch.float64) - p).abs() / scale).max()))
        self.info["checked_batches"] = len(self.kept)
        return {"apply_gap": gap}
