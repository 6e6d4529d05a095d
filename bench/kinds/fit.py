"""Traffic of whole fits: ``falkon_fit`` calls back to back, one caller,
closed loop, each fit drawing its own centers from the seed.

The mix's parameters: ``warmup`` (``fits`` whole fits before the window,
each key besides a FalkonConfig field set for them only: a warm-up at the
cell's shapes with less work), ``checked_sweeps`` (how many of a fit's
sweeps the check recomputes).
"""
from __future__ import annotations

import dataclasses
import random
import time

import torch

from bench import loops
from bench.counts import fit as fit_counts
from bench.reference import data
from bench.reference import falkon as ref
from bench.timing import TimedOps


class Loop:
    """``numbers`` names what the check compares (the cell's limits)."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, ops_impl: str,
                 timed: bool, numbers=()):
        self.cfg, self.mix, self.seed, self.numbers = cfg, mix, seed, set(numbers)
        self.device, self.timed = torch.device(device), timed
        loops.closed_loop(mix)
        self.fcfg = loops.falkon_config(cfg, ops_impl, self.device)
        self.info = {}

    def setup(self, warm: bool = True) -> None:
        from repro_torch.core import falkon_fit
        self.X, self.y, self.Xt, _ = data.make_split(self.seed, self.cfg, self.device)
        warmup = dict(self.mix["warmup"])
        fits = warmup.pop("fits")
        wcfg = dataclasses.replace(self.fcfg, **warmup)
        for i in range(-fits if warm else 0, 0):
            falkon_fit(loops.center_seed(self.seed, i), self.X, self.y, wcfg)
        loops.sync(self.device)

    def sampled_sweeps(self) -> set[int]:
        """Sweep calls by their order in a fit, drawn from the seed: the
        right-hand side's (0), one of the t CG sweeps, one of the cond(W)
        power iteration's when it runs, and the rest of ``checked_sweeps``
        from all of them."""
        if "sweep_gap" not in self.numbers:
            return set()
        t = self.fcfg.iterations
        total = fit_counts.sweeps(t, self.fcfg.estimate_cond)
        rng = random.Random(f"{self.seed}/sweeps")
        keep = {0}
        if t:
            keep.add(rng.randint(1, t))
        if total > 1 + t:
            keep.add(rng.randint(1 + t, total - 1))
        rest = [i for i in range(total) if i not in keep]
        return keep | set(rng.sample(rest, max(0, self.mix["checked_sweeps"] - len(keep))))

    def window(self, seconds: float) -> dict:
        from repro_torch.core import falkon_fit
        rng = random.Random(f"{self.seed}/fit")
        keep = self.sampled_sweeps()
        fits, kept = [], None
        t0 = time.perf_counter()
        while True:
            ops = TimedOps(self.fcfg.make_ops()) if self.timed else None
            if keep:
                ops = loops.KeepOps(ops or self.fcfg.make_ops(), keep)
            times = {} if self.timed else None
            with torch.profiler.record_function("bench.fit"):
                est, state = falkon_fit(loops.center_seed(self.seed, len(fits)), self.X,
                                        self.y, self.fcfg, ops=ops, stage_times=times)
            loops.sync(self.device)
            e = time.perf_counter()
            timer = ops.ops if isinstance(ops, loops.KeepOps) else ops
            fits.append({"stage_times": times,
                         "calls": timer.records() if isinstance(timer, TimedOps) else []})
            if rng.random() * len(fits) < 1.0:     # reservoir of one fit
                kept = {"index": len(fits) - 1, "centers": est.centers, "alpha": est.alpha,
                        "T": state.precond.T, "A": state.precond.A,
                        "res": state.residual_norms,
                        "sweeps": ops.kept if isinstance(ops, loops.KeepOps) else []}
            del est, state, ops
            if e - t0 >= seconds:
                break
        self.kept = kept
        return {"window_s": e - t0, "attempted": len(fits), "fits": fits}

    def control(self) -> None:
        """The control's fit, with the same centers and sampled sweeps."""
        idx = data.center_indices(loops.center_seed(self.seed, 0), self.X.shape[0],
                                  self.cfg["num_centers"], self.device)
        r = ref.fit(self.X, self.y, idx, self.cfg, ref.CONTROL, record=self.sampled_sweeps(),
                    cond=self.fcfg.estimate_cond)
        self.kept = {"index": 0, "centers": r["C"], "alpha": r["alpha"], "T": r["T"],
                     "A": r["A"], "res": torch.tensor(r["res"]), "sweeps": r["sweeps"]}

    def check(self) -> dict:
        """The kept fit against the float64 reference. Always: its centers
        (exact). As the cell's limits name them: the sampled sweeps' widest
        entry gap on the program's own inputs, each over its entry's scale
        K^T (K |u| + |v|) (a sampled sweep that never came reads 1); the
        first CG residual ||b||; how far alpha is from solving the Nystrom
        system (in Alg. 1's norm, or plain); the test predictions' gap; the
        residuals of both factors. The reference runs only as far as these
        need. The program's factors go to the
        host first (when compared; else they go), so that the reference has
        the card."""
        k, cfg, dev, want = dict(self.kept), self.cfg, self.device, self.numbers
        self.kept = None
        clock = loops.Clock(dev)
        T, A = (k.pop(n) for n in ("T", "A"))
        T, A = ((T.contiguous().cpu(), A.contiguous().cpu())
                if want & {"factor_residual", "precond_residual"} else (None, None))
        res0 = float(k.pop("res").reshape(-1)[0])
        sweeps = k.pop("sweeps")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        clock("factors_to_host")
        idx = data.center_indices(loops.center_seed(self.seed, k["index"]), self.X.shape[0],
                                  cfg["num_centers"], dev)
        C = self.X[idx]
        gamma = 0.5 / cfg["sigma"] ** 2
        out = {"center_rows_differ": int((k["centers"] != C).any(dim=1).sum())}
        if "sweep_gap" in want:
            X64, C64 = self.X.to(torch.float64), C.to(torch.float64)
            gap = 0.0 if len(sweeps) == len(self.sampled_sweeps()) else 1.0
            for u, v, w in sweeps:
                u64 = None if not bool(u.any()) else u.to(torch.float64)
                v64 = None if v is None else v.to(torch.float64)
                w_ref, scale = ref.sweep(X64, C64, u64, v64, gamma, ref.REFERENCE,
                                         absolute=True)
                gap = max(gap, float(((w.to(torch.float64) - w_ref).abs() / scale).max()))
            out["sweep_gap"] = gap
            del X64, C64
            clock("sweeps")
        whole = "pred_gap" in want
        if whole or want & {"rhs_gap", "solve_residual", "normal_residual"}:
            t = cfg["iterations"] if whole else 0   # 0: the factors and the right-hand side
            r = ref.fit(self.X, self.y, idx, {**cfg, "iterations": t})
            clock("reference_fit")
            if "rhs_gap" in want:
                out["rhs_gap"] = abs(res0 - r["res"][0]) / r["res"][0]
            for name, pre in (("solve_residual", True), ("normal_residual", False)):
                if name in want:
                    out[name] = ref.solve_residual(self.X, self.y, C, k["alpha"], r["T"],
                                                   r["A"], cfg, preconditioned=pre)
            clock("solve_residual")
            if whole:
                Xt = self.Xt.to(torch.float64)
                p_ref = ref.apply(Xt, r["C"], r["alpha"], gamma, ref.REFERENCE)
                p_prog = ref.apply(Xt, k["centers"].to(torch.float64),
                                   k["alpha"].to(torch.float64), gamma, ref.REFERENCE)
                out["pred_gap"] = float(torch.linalg.norm(p_prog - p_ref)
                                        / torch.linalg.norm(p_ref))
                del Xt, p_ref, p_prog
                clock("predictions")
            del r
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        if "factor_residual" in want:
            out["factor_residual"] = ref.factor_residual(T, C, cfg)
        if "precond_residual" in want:
            out["precond_residual"] = ref.precond_residual(T, A, cfg["lam"], dev)
        clock("factor_residuals")
        self.info["check_seconds"] = clock.seconds
        return out
