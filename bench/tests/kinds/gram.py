"""A test-only kind of traffic, added as files alone: K(C, C) by the
program's ``ops.gram``, back to back, one caller; the check compares the
last Gram with the float64 reference's, entry by entry."""
from __future__ import annotations

import time

import torch

from bench import loops
from bench.reference import data
from bench.reference import falkon as ref


class Loop:
    def __init__(self, cfg, mix, seed, device, ops_impl, timed, numbers=()):
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        loops.closed_loop(mix)
        self.ops = loops.falkon_config(cfg, ops_impl, self.device).make_ops()
        self.info = {}

    def setup(self, warm: bool = True) -> None:
        X = data.make_split(self.seed, self.cfg, self.device)[0]
        self.C = X[data.center_indices(self.seed, X.shape[0], self.cfg["num_centers"],
                                       self.device)]
        if warm:
            self.ops.gram(self.C, self.C)

    def window(self, seconds: float) -> dict:
        calls, t0 = 0, time.perf_counter()
        while True:
            self.kept = self.ops.gram(self.C, self.C)
            loops.sync(self.device)
            calls += 1
            e = time.perf_counter()
            if e - t0 >= seconds:
                return {"window_s": e - t0, "attempted": calls, "grams": calls}

    def control(self) -> None:
        self.kept = ref.gram(self.C, 0.5 / self.cfg["sigma"] ** 2, ref.CONTROL)

    def check(self) -> dict:
        K = ref.gram(self.C.to(torch.float64), 0.5 / self.cfg["sigma"] ** 2, ref.REFERENCE)
        return {"gram_gap": float((self.kept.to(torch.float64) - K).abs().max())}
