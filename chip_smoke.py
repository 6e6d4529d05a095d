"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): build, check, fit.

    python3 chip_smoke.py [--seed 0] [--n 4000000] [--n-test 500000] [--checks-only]

Phases, each printed as it runs; any failure exits non-zero before the
result line:

1. device   — needs a CUDA card; prints its name and power limit.
2. build    — compiles the CUDA sources of ``src/repro_torch/kernels/csrc``,
               one ``nvcc`` per source, all started together, into one
               library.
3. kernels  — every kernel (sweep B1, kernel matmul B2, pairwise Gram B3,
               sharded sweep B4) against its plain PyTorch twin on the
               card, for all five kernel kinds, ragged shapes, p = 1 to 4
               and p = 5, 8, 17 (column groups of at most 4, one launch
               each), ``v=None``, ``row_mask`` (masked rows must give
               exactly the prefix result) and ``add=``; B1 also at M = 5000
               (p = 3) and M = 20500 (p = 1), where its w partials live in
               global memory, and around its 128 x 128 tile (n, M in 1,
               127, 128, 129; d in 1, 18, 90, 129: one k-chunk, several,
               and X staged again per tile past d = 128; p = 1 and 4); B2
               likewise around its tile (m, n and d as B1's; p = 1 and 4,
               with and without ``add=``, the five kinds, on the unsplit
               and the most-split grid), its shared memory, resident blocks
               and split of B's tiles against their Python mirror; B3
               likewise around its tile (m, n and d as B1's, the five
               kinds; n % 4 = 0 takes its float4 stores, else the scalar
               ones), its first columns bit-equal to B2's K(A, B) V with V
               one-hot (unsplit and most-split), K(C, C) of one tensor (the
               symmetric route) at M in 1, 127, 128, 129, 300, 513
               bit-equal to the full route on C.clone() and to its
               transpose, its shared memory and resident blocks against
               the mirror, and every block's range of tiles against
               ``pairwise_range``; B4 also against B1, with ragged shards.
   compensated — the compensated builds of B1, B2 and B4 (bf16 and fp32:
               the bf16 policy's and the reference's compensated=True fp32
               case) against their compensated twins, for the five kinds,
               n, M in 1, 127, 128, 129, d in 1, 18, 90, 129, p = 1..5 (u
               at fp32 or at the build's type in turn; bf16 u gives B1 a
               bf16 output): B1 with v, without v, under row_mask (masked
               rows bit-equal to the valid prefix); B2 with and without
               add, fp32 and bf16 out, unsplit and most-split; B4 with its
               t spilled in bf16 (masked rows bit-equal to the prefix); B1
               with its w partial and carry in global memory; both builds'
               plans against their mirrors.
4. blocked  — the blocked Cholesky's tile kernels B5-B7 against their
               twins at the ragged test shapes, a 1280 tile and the last
               80-wide panel's update (k = 1280); B5 at widths around its
               64-wide sub-panels with NaN above the diagonal (L's strict
               upper triangle must be exactly 0) and with non-positive
               pivots (NaN from that column on, where its twin puts it); B6
               at widths around its 128-wide column blocks, ragged, at
               r = 1, 17, 3b + 17, with NaN above L's diagonal, two runs
               bit-equal, with NaN pivots (NaN from that column on, finite
               before it, as its twin), and its quotients bit for bit against
               torch's division; B7
               at ragged tiles and k % 4 != 0, in place bit-equal;
               ``blocked_cholesky`` on the "cuda" engine against the
               "torch" engine and a float64 factor.
5. main     — the port's in-core fit (``falkon_fit``, ops_impl="cuda") on
               synthetic SUSY-shape data (d = 18, gaussian sigma = 4,
               lam = 1e-6, M = 10^4 centers, t = 20) with n training rows,
               then ``predict`` on n-test rows; the kernel launch counts of
               that run (sweep 47, pairwise 1, kernel matmul >= 1); a
               small fit against the plain "torch" backend (and, at
               lam = 1e-6 over 4 center draws, against float64 fits); a
               sweep at that shape against float32 and float64 twins.
   path     — the lam path at SUSY's full width: ``falkon_fit_path`` with
               the main fit's config and seed (so its centers) over the grid
               lam = 10^(-8 + k/2), k = 0..7, the test rows as validation
               set: 21 sweeps, 1 apply and 1 gram at the ops facade, 41 B1
               launches (1 right-hand side + 20 CG sweeps x 2 column
               groups), 2 B2 and 1 B3; stage seconds, device peak and the
               validation MSE of every lam; at lam = 1e-6 the test error
               within 0.002 of the main fit's; one single fit at lam = 1e-8
               (no cond estimate) timed beside the path; at both lams the
               path's alpha against the single fit's under a measured
               bound, and both against a float64 fit of the same system
               (the path no farther than 1.5x the single fit); at
               n = 20,000, M = 500 every lam's alpha against a float64
               ``nystrom_direct`` and float64 single fits (relative to the
               plain float32 path's and single fits' distances) and the
               grid forced onto the blocked factor, its
               A stack against the in-core stack and bit-equal to blocked
               single-lam builds; one leverage-score fit at the SUSY shape
               (pilot, scoring and sampling seconds, distinct centers, D's
               range, test error) and leverage scores on 4,096 rows against
               float64 scorings of the same pilot and float64 exact scores.
   bf16     — the bf16 policy at SUSY's shape: the bf16 compensated B1
               sweep (n = 4x10^6, M = 10^4) and B2 at predict's shape
               against float64 twins on the same bf16 inputs (the kernels'
               accumulation, held like the fp32 checks) and on the
               unquantized inputs (the policy's error, printed), B1 twice
               bit-equal; then the full-size fit with precision="bf16" on
               the fp32 fit's data and seed: stage times, device peak, test
               error and launches by build (47 bf16 B1), beside the fp32
               fit's.
6. msd      — the large-M fit at the paper's MillionSongs size (synthetic
               YearPredictionMSD split: 463,715 / 51,630 rows, d = 90,
               gaussian sigma = 6, lam = 1e-6, M = 5x10^4, t = 20): the
               factor on the blocked route (block 1280, 40 panels) with its
               device peak against the plan's ceiling and the exact launch
               counts (B5 80, B6 78, B7 1560, B3 1, B1 47); test MSE against
               the label variance; a second solve with the sweep forced onto
               B4 (``REPRO_SWEEP_BUDGET_MB``) against the first, and the
               test MSE of both and of a plain float32 solve; two small
               forced-blocked fits (M = 320 and 1024) against in-core and
               float64 fits; then one bf16 sweep on the policy's B4 route
               (t spilled in bf16) and on B1's bf16 build, against a
               float64 twin on the same bf16 inputs, timed.
7. times    — the full-size sweeps (SUSY: B1; MillionSongs: B1 and B4) and
               the predict-shape kernel matmul against float32 and float64
               twins; the MillionSongs fit's blocked T and A against
               in-core float32 (cuSOLVER) and float64 factors of the same
               matrices; B1 at the SUSY shape, B2 at the predict shape
               and at one launch of B4's transposed pass, and B3 at both
               fits' K_MM (symmetric route) and at a 65,536-row K_nM-cache
               block (full route), each twice, bit-equal; B1 at the SUSY
               shape also at p = 4 and 8 and B2 at the predict shape at
               p = 8 (the lam path's widths), against their twins and
               bit-equal over two runs; B6 and B7 at the first panel's shapes against their twins (B6 twice,
               bit-equal); each kernel at its path's shapes (CUDA events)
               beside its plain twin, its bound and its library call (B2
               also at B4's transposed shape, B3 at its three); B1's (at
               both fits' shapes), B2's (at both of its), B3's (at its
               three), B5's and B6's device operations per call by name
               (``torch.profiler``); then one ``kernels`` JSON line (B3's
               entry: SUSY's K_MM; the bf16 builds of B1, B2 and B4 as
               entries of their own, their launches from the bf16 fit and
               the bf16 B4 sweep; B1 at p = 4 and 8 and B2 at p = 8 as
               entries of their own, their launches from the path fit).

The last line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))

FP32_PEAK = 67e12        # H100 SXM fp32 FLOP/s outside the tensor cores
HBM_RATE = 3.35e12       # H100 SXM device memory, bytes/s
TOL = dict(rtol=1e-4, atol=1e-4)   # fp32, summation order differs from the twin
KINDS = [
    ("gaussian", dict(sigma=1.3)),
    ("laplacian", dict(sigma=1.1)),
    ("matern32", dict(sigma=1.7)),
    ("linear", dict(scale=1.5)),
    ("polynomial", dict(degree=2, c=0.5, scale=2.0)),
]
SHAPES = [(300, 97, 13), (513, 129, 33)]
#: right-hand-side widths: the compiled 1 and 4, 2 and 3 padded to 4, and
#: wider blocks that run in column groups of at most 4
WIDTHS = (1, 2, 3, 4, 5, 8, 17)
#: B1 around its 128 x 128 tile: rows and centers at 1, 127, 128, 129; d of
#: one k-chunk (1, 18), several (90), and past the resident X block (129)
EDGE_NM = (1, 127, 128, 129)
EDGE_D = (1, 18, 90, 129)
#: (m, n, d) of B2 on the path: SUSY's predict, the MillionSongs predict and
#: B4's transposed pass (C's 17,280-row shard against a 65,536-row X chunk)
MATMUL_PATH_SHAPES = [(500_000, 10_000, 18), (51_630, 50_000, 90), (17_280, 65_536, 90)]
#: (m, n, d, symmetric) of B3 on the path: SUSY's and MillionSongs' K_MM,
#: and one K_nM-cache row block (65,536 rows against SUSY's centers)
PAIRWISE_PATH_SHAPES = [(10_000, 10_000, 18, True), (50_000, 50_000, 90, True),
                        (65_536, 10_000, 18, False)]
#: B3's symmetric route also at several row blocks, ragged
PAIRWISE_SYM_M = (300, 513)
#: (n, M, d, p) of sweeps whose w partials overflow shared memory
SWEEP_GLOBAL = [(40_000, 5_000, 18, 3), (40_000, 20_500, 18, 1)]
#: (n, M, d, shard_m) of the sharded sweep B4: ragged shards; the last
#: spans two of its transposed pass's row chunks
SHARDED = [(300, 333, 13, 128), (513, 129, 33, 64), (70_000, 333, 13, 128)]
#: MillionSongs (Sect. 5 of the paper): M = 5x10^4 uniform centers on the
#: YearPredictionMSD split of 463,715 training and 51,630 test rows
MSD_CENTERS = 50_000
MSD_N, MSD_N_TEST = 463_715, 51_630
#: REPRO_SWEEP_BUDGET_MB that forces the MillionSongs sweep onto B4 in
#: three C-shards (shard_m = 17280)
MSD_SHARD_BUDGET_MB = 6
#: the j_sharded solve may stand at most this many times as far from the
#: planner-route solve (alpha, predictions) as a plain float32 solve does
AGREE_FACTOR = 2.0
#: forced-blocked vs in-core fit predictions (the reference's bound)
BLOCKED_FIT_TOL = 1e-4
#: normwise bound of a factor against its twin or a float64 factor (the
#: reference's blocked-vs-in-core bound)
FACTOR_TOL = 1e-5
#: the MillionSongs fit's blocked factors may stand at most this many times
#: as far (normwise) from float64 factors of the same matrices as in-core
#: float32 cuSOLVER factors do: two correct fp32 factorizations that sum in
#: other orders round alike to within a small factor, while a wrong panel
#: or update moves the factor by O(1)
FACTOR_AGREE = 4.0
#: (n, d, M) of the small forced-blocked fits: the reference test's problem
#: (tests/test_blocked_cholesky.py, 2 panels of 256) and one with 4 panels
#: and three rounds of trailing updates
SMALL_BLOCKED = [(1500, 6, 320), (20_000, 6, 1024)]
#: B5's tile widths: around its sub-panel width 64, ragged, and the path's 1280
POTRF_SIZES = (1, 63, 64, 65, 80, 127, 192, 256, 1280)
#: (b, column) of B5's indefinite pivots: column 0, inside a sub-panel, a
#: sub-panel's last column, the last column of a ragged tile, and inside the
#: first sub-panel of a ragged 96 tile
BAD_PIVOTS = ((192, 0), (192, 100), (192, 127), (65, 64), (96, 48))
#: B6's panel widths: around its 128-wide column blocks and their halves
#: (B5's panels are 64 wide), ragged, and the path's 1280; each at r = 1, 17
#: and 3b + 17 rows
TRSM_WIDTHS = (1, 31, 63, 64, 65, 80, 127, 128, 129, 192, 256, 257, 1280)
#: (b, column) of NaN pivots on B6's L: the first column, inside a column
#: block, the first block's last column, the second's, and the last column
#: of a ragged panel
TRSM_BAD_PIVOTS = ((300, 0), (300, 100), (300, 127), (300, 255), (257, 256))
#: B6's quotients against torch's division, bit for bit (b = 1: X = A / L):
#: divisors and dividends of random sign, mantissa and exponent in
#: [-DIV_EXP, DIV_EXP] (so quotients also overflow, turn subnormal and
#: underflow), with zeros, subnormals, infinities and NaN
DIV_DIVISORS, DIV_ROWS, DIV_EXP = 64, 1 << 20, 80
#: (r, b, k) of B7's checks, each also in place
UPDATE_SHAPES = ((80, 80, 1280), (44, 44, 256), (116, 116, 192), (4000, 1280, 1280),
                 (1, 1, 1), (129, 127, 33), (300, 97, 1279), (1280, 1280, 64))
#: limit of a float32 result's error per unit of the sum of the magnitudes
#: of its terms (predict: max_i sum_j |K_ij alpha_j|; sweep: K^T K |u|):
#: about two fp32 unit roundoffs (2^-24 = 6.0e-8)
PRED_RTOL = 1e-7
#: center draws of the small lam = 1e-6 fits held against float64 fits
SMALL_SEEDS = 4
#: the lam path's grid: 10^(-8 + k/2), k = 0..7 (L = 8, SUSY's lam = 1e-6 at k = 4)
PATH_LAMS = tuple(10.0 ** (-8 + k / 2) for k in range(8))
#: the path's alpha at lam = 1e-6 against the main fit's, and at the grid's
#: smallest lam against one single fit's (same centers and factors; the
#: stacked sweep at width 8, the batched A solves and the CG's column sums
#: round otherwise, and T^-1 A^-1 amplifies that): measured 0.5675 and
#: 0.6044 on the card (NVIDIA H100 80GB HBM3, 700 W; the same in every run)
PATH_ALPHA_BOUND = 0.75
#: the path may stand at most this many times as far from a float64
#: reference as the float32 fits it replaces: the small path's alphas
#: (summed over the grid) from float64 nystrom_direct against the plain
#: float32 path's, and from float64 single fits against float32 single
#: fits'; the full-size path's alpha and predictions from a float64 fit
#: against the float32 single fit's
PATH_AGREE = 1.5
#: the small path's blocked A stack against its in-core stack, normwise per
#: lam: two correct fp32 routes stand ~1e-5 apart (their T differ in
#: rounding), a factor of a spoiled T T^T stands O(1) off
PATH_STACK_TOL = 1e-4
#: leverage scores on 4,096 rows at lam = 1e-6: the card's float32 scoring
#: against a float64 scoring of the same pilot (normwise; its G = lam n K_SS
#: + K_Sn K_nS is ill conditioned at this lam), and the float64 estimate
#: over the float64 exact score, which the Nystrom estimator never exceeds
#: in exact arithmetic (the K_MM jitter only lowers it): rounding slack
LEVERAGE_FP32_BOUND = 1e-2
LEVERAGE_RATIO_SLACK = 1e-6
#: the compensated builds the kernel checks hold against their twins: bf16
#: (the bf16 policy's) and fp32 (the reference's compensated=True fp32 case)
COMP_DTYPES = ("bfloat16", "float32")
#: right-hand-side widths of the compensated checks, one shape each in turn
COMP_WIDTHS = (1, 2, 3, 4, 5)
#: a bf16 result against its twin: both round the same fp32 sum to bf16,
#: which may fall either side of a rounding boundary, so one bf16 unit in
#: the last place (at most 2^-7 of a value: 8 significant bits) of the
#: largest entry is added to the fp32 tolerance; B4's bf16 t spill likewise
#: moves w_j by up to 2^-7 sum_i |K_ij t_i|
BF16_RTOL = 2.0 ** -7
#: idle seconds on each side of a profiled call (see ``breakdown``)
PROFILE_PAD = 2.0
#: the bf16 policy's error against float64 on unquantized inputs, as the
#: reference documents it (printed, not held: C.1 measures 1.005e-2)
POLICY_BOUND = 1e-2
SOURCE = "src/repro_torch/kernels/csrc/kernel_matvec.cu"
SOURCE_BLOCKED = "src/repro_torch/kernels/csrc/blocked_cholesky.cu"
DEVICE = "cuda"
REPLACES = {
    "fused_sweep": "src/repro/kernels/kernel_matvec.py:361",
    "kernel_matmul": "src/repro/kernels/kernel_matvec.py:174",
    "pairwise_kernel": "src/repro/kernels/kernel_matvec.py:559",
    "sharded_sweep": "src/repro/kernels/kernel_matvec.py:474",
    "potrf_tile": "src/repro/kernels/blocked_cholesky.py:212",
    "trsm_panel": "src/repro/kernels/blocked_cholesky.py:225",
    "trailing_update": "src/repro/kernels/blocked_cholesky.py:246",
}
SOURCES = {name: SOURCE for name in ("fused_sweep", "kernel_matmul", "pairwise_kernel")}
#: B4 is B2's launches in a loop; its source is the wrapper that composes them
SOURCES["sharded_sweep"] = "src/repro_torch/kernels/kernel_matvec.py"
#: the bf16 compensated builds of B1 and B2 (the tile code is csrc/sweep.cuh);
#: B4's is its B2 launches
SOURCES.update(fused_sweep_bf16c="src/repro_torch/kernels/csrc/kernel_matvec_bf16c.cu",
               kernel_matmul_bf16c="src/repro_torch/kernels/csrc/kernel_matvec_bf16c.cu",
               sharded_sweep_bf16c="src/repro_torch/kernels/kernel_matvec.py")
SOURCES.update({name: SOURCE_BLOCKED for name in ("potrf_tile", "trsm_panel",
                                                  "trailing_update")})
#: B1 and B2 timed at the lam path's column widths (the same builds)
SOURCES.update(fused_sweep_p4=SOURCE, fused_sweep_p8=SOURCE, kernel_matmul_p8=SOURCE)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(*parts) -> None:
    print(*parts, flush=True)


def close_err(got, ref, rtol: float = TOL["rtol"]) -> tuple[float, float]:
    """(max |got - ref|, max |got - ref| / (atol + rtol * max |ref|)); the
    second must stay <= 1. The kernel and its twin sum in different orders,
    so the fp32 rounding scales with the magnitudes of the whole result, not
    with each entry (an entry near 0 by cancellation keeps the error of its
    terms). A bf16 result is held with ``rtol`` raised by BF16_RTOL."""
    diff = float((got.double() - ref.double()).abs().max())
    return diff, diff / (TOL["atol"] + rtol * float(ref.double().abs().max()))


def phase_device(torch):
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    say(f"[device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    say(f"[device] nvidia-smi: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain twins in IEEE fp32
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from repro_torch.kernels import build, kernel_matvec as km
    t0 = time.perf_counter()
    lib_path = build.build()      # one nvcc per source, started together, then a link
    km._lib()
    build_s = time.perf_counter() - t0
    say(f"[build] {lib_path.name} in {build_s:.3f} s")
    for log in sorted(lib_path.parent.glob(f"*_{build._sources_hash()}.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                say(f"[build] {line.strip()}")
    return build_s


def check_sweep(torch, km, spec, X, C, u, v, res: dict, tag: str) -> None:
    """B1 against its twin with v, without v and under ``row_mask``; the tile
    counter; masked junk rows giving exactly the valid prefix's result."""
    n, M = X.shape[0], C.shape[0]
    p = u.numel() // M
    u2 = u.reshape(M, p)
    v2 = v.reshape(n, p)
    w, cnt = km.fused_sweep(X, C, u, v, spec=spec, return_tile_count=True)
    ref, _ = km.fused_sweep_plain(X, C, u2, v2, spec=spec)
    res["sweep"] = close_err(w.reshape(M, p), ref)
    nbi, nbj = km.sweep_tile_grid(n, M)
    tiles = len(km.column_groups(p)) * 2 * nbi * nbj
    check(int(cnt) == tiles, f"{tag}: tile count {int(cnt)} != {tiles}")
    w0 = km.fused_sweep(X, C, u, None, spec=spec)
    res["sweep v=None"] = close_err(w0.reshape(M, p),
                                    km.fused_sweep_plain(X, C, u2, None, spec=spec)[0])
    keep = n - min(20, n // 2)
    Xj = X.clone()
    Xj[keep:] = 123.0
    mask = torch.zeros(n, device=X.device)
    mask[:keep] = 1.0
    got_m = km.fused_sweep(Xj, C, u, v, spec=spec, row_mask=mask)
    got_p = km.fused_sweep(X[:keep].contiguous(), C, u, v[:keep].contiguous(), spec=spec)
    torch.cuda.synchronize()
    check(torch.equal(got_m, got_p), f"{tag}: masked rows changed the sweep "
          f"(max diff {float((got_m - got_p).abs().max())})")
    res["sweep row_mask"] = close_err(
        got_m.reshape(M, p), km.fused_sweep_plain(Xj, C, u2, v2, spec=spec, row_mask=mask)[0])


def tally(res: dict, tag: str) -> float:
    worst = 0.0
    for name, (abs_err, ratio) in res.items():
        worst = max(worst, ratio)
        check(ratio <= 1.0, f"{name} {tag}: max abs err {abs_err:.3e} exceeds "
              f"atol 1e-4 + rtol 1e-4 (ratio {ratio:.3f})")
    say(f"[kernels] {tag}: " + ", ".join(f"{k} {a:.2e}" for k, (a, _) in res.items()))
    return worst


def phase_kernels(torch):
    from repro_torch.core.kernels import make_kernel
    from repro_torch.kernels import kernel_matvec as km
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(0)

    def randn(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    worst = 0.0
    cases = 0
    for kind, params in KINDS:
        spec = make_kernel(kind, **params).spec
        for n, M, d in SHAPES:
            for p in WIDTHS:
                cols = () if p == 1 else (p,)
                X, C = randn(n, d), randn(M, d)
                u, v = randn(M, *cols), randn(n, *cols)
                u2, v2 = u.reshape(M, p), v.reshape(n, p)
                res = {}
                tag = f"{kind:10s} n,M,d={n},{M},{d} p={p}"
                check_sweep(torch, km, spec, X, C, u, v, res, tag)
                # B2: plain and with add=
                res["matmul"] = close_err(km.kernel_matmul(X, C, u, spec=spec).reshape(n, p),
                                          km.kernel_matmul_plain(X, C, u2, spec=spec))
                res["matmul add"] = close_err(
                    km.kernel_matmul(X, C, u, v, spec=spec).reshape(n, p),
                    km.kernel_matmul_plain(X, C, u2, v2, spec=spec))
                # B3
                res["pairwise"] = close_err(km.pairwise_kernel(X, C, spec=spec),
                                            km.pairwise_kernel_plain(X, C, spec=spec))
                torch.cuda.synchronize()
                cases += len(res)
                worst = max(worst, tally(res, tag))
        # B1 with its w partials in global scratch (too large for shared
        # memory), more row blocks than resident blocks, at both widths
        for n, M, d, p in SWEEP_GLOBAL:
            smem, in_smem = km.sweep_smem_bytes(M, p, d)
            check(not in_smem, f"sweep M={M} p={p} keeps its w partial in shared memory")
            cols = () if p == 1 else (p,)
            X, C = randn(n, d), randn(M, d)
            res = {}
            tag = f"{kind:10s} n,M,d={n},{M},{d} p={p} (w partial in global memory)"
            check_sweep(torch, km, spec, X, C, randn(M, *cols), randn(n, *cols), res, tag)
            cases += len(res)
            worst = max(worst, tally(res, tag))
        # B4 against its twin and against B1: ragged shards, every width
        for n, M, d, shard in SHARDED:
            for p in WIDTHS:
                cols = () if p == 1 else (p,)
                X, C = randn(n, d), randn(M, d)
                res = {}
                tag = f"{kind:10s} n,M,d={n},{M},{d} shard_m={shard} p={p} (B4)"
                check_sharded(torch, km, spec, X, C, randn(M, *cols), randn(n, *cols), shard,
                              res, tag)
                cases += len(res)
                worst = max(worst, tally(res, tag))
    # B1 around its tile: ragged and exact row blocks and center tiles, one
    # and several k-chunks, X resident and staged again per tile (d = 129)
    spec = make_kernel("gaussian", sigma=1.3).spec
    for d in EDGE_D:
        edge = 0.0
        for n in EDGE_NM:
            for M in EDGE_NM:
                for p in (1, 4):
                    cols = () if p == 1 else (p,)
                    X, C = randn(n, d), randn(M, d)
                    res = {}
                    tag = f"gaussian   n,M,d={n},{M},{d} p={p} (B1 tile edges)"
                    check_sweep(torch, km, spec, X, C, randn(M, *cols), randn(n, *cols), res, tag)
                    cases += len(res)
                    edge = max(edge, *(r for _, r in res.values()))
                    for name, (abs_err, ratio) in res.items():
                        check(ratio <= 1.0, f"{name} {tag}: max abs err {abs_err:.3e} "
                              f"exceeds atol 1e-4 + rtol 1e-4 (ratio {ratio:.3f})")
        say(f"[kernels] B1 tile edges d={d}: n, M in {EDGE_NM}, p = 1 and 4 pass; worst "
            f"ratio {edge:.4f}")
        worst = max(worst, edge)
    n_edge, edge = check_matmul_edges(torch, km, randn)
    cases += n_edge
    worst = max(worst, edge)
    check_matmul_plan(torch, km)
    n_edge, edge = check_pairwise_edges(torch, km, randn)
    cases += n_edge
    worst = max(worst, edge)
    check_pairwise_plan(torch, km)
    say(f"[kernels] {cases} checks pass; worst max|diff|/(1e-4 + 1e-4 max|ref|) = {worst:.4f} (bound 1)")


def check_matmul_edges(torch, km, randn) -> tuple[int, float]:
    """B2 around its 128 x 128 tile for the five kinds: m, n in EDGE_NM, d in
    EDGE_D (one k-chunk, several, A staged again per tile past 128), p = 1
    and 4, with and without ``add``, on the unsplit grid (slots = 1: S = 1)
    and the most-split one (S = min(nbj, 16)). Inputs scaled by 1/sqrt(d),
    so that no kind's entries vanish at d = 129. Returns (checks, worst
    ratio)."""
    from repro_torch.core.kernels import make_kernel
    cases, worst, split = 0, 0.0, 0
    lib = km._lib()
    for kind, params in KINDS:
        spec = make_kernel(kind, **params).spec
        for d in EDGE_D:
            for m in EDGE_NM:
                for n in EDGE_NM:
                    for p in (1, 4):
                        A, B = randn(m, d) / d ** 0.5, randn(n, d) / d ** 0.5
                        V, add = randn(n, p), randn(m, p)
                        for a in (None, add):
                            ref = km.kernel_matmul_plain(A, B, V, a, spec=spec)
                            for slots in (1, 1 << 30):
                                split += lib.rt_matmul_slices(m, n, slots) > 1
                                got = km._kernel_matmul_cuda(A, B, V, a, spec=spec, slots=slots)
                                abs_err, ratio = close_err(got, ref)
                                cases += 1
                                worst = max(worst, ratio)
                                check(ratio <= 1.0, f"B2 {kind} m,n,d={m},{n},{d} p={p} add="
                                      f"{a is not None} slots={slots}: max abs err {abs_err:.3e} "
                                      f"exceeds atol 1e-4 + rtol 1e-4 (ratio {ratio:.3f})")
    torch.cuda.synchronize()
    say(f"[kernels] B2 tile edges: m, n in {EDGE_NM}, d in {EDGE_D}, p = 1 and 4, with and "
        f"without add, five kinds, unsplit and split grids ({split} split launches): {cases} "
        f"checks pass; worst ratio {worst:.4f}")
    return cases, worst


def check_matmul_plan(torch, km) -> None:
    """B2's plan on the card against its Python mirror: shared memory and
    resident blocks (the occupancy query against the model) at each path's
    depth, and the C split rule against ``matmul_slices`` at the path's
    shapes and a grid of others."""
    dev = torch.cuda.current_device()
    lib = km._lib()
    for p in (1, 4):
        for d in (18, 90):
            smem, slots = km._matmul_slots(km._pad_p(p), km.KIND_CODES["gaussian"], d, 0, dev)
            model = km.matmul_grid_model(p, d)
            say(f"[kernels] B2 plan p={p} d={d}: shared memory {smem} B (mirror "
                f"{km.matmul_smem_bytes(p, d)}), resident blocks {slots} (model {model})")
            check(smem == km.matmul_smem_bytes(p, d) and slots == model,
                  f"B2's plan at p={p} d={d} is not its mirror's")
    for m, n, d in MATMUL_PATH_SHAPES:
        slots = km._matmul_slots(1, km.KIND_CODES["gaussian"], d, 0, dev)[1]
        S = lib.rt_matmul_slices(m, n, slots)
        say(f"[kernels] B2 m={m} n={n} d={d}: {S} slices on {slots} resident blocks")
        check(S == km.matmul_slices(m, n, slots), f"B2's split at m={m} n={n} is not the mirror's")
    grid = [1, 127, 129, 1000, 17_280, 51_630, 500_000]
    for m in grid:
        for n in grid + [65_536]:
            for slots in (132, 264):
                check(lib.rt_matmul_slices(m, n, slots) == km.matmul_slices(m, n, slots),
                      f"B2's split at m={m} n={n} slots={slots} is not the mirror's")
    say(f"[kernels] B2 split rule: C and mirror agree on {len(grid) * (len(grid) + 1) * 2} shapes")


def check_pairwise_edges(torch, km, randn) -> tuple[int, float]:
    """B3 around its 128 x 128 tile for the five kinds: m, n in EDGE_NM, d
    in EDGE_D (n % 4 = 0 takes the float4 stores, else the scalar ones)
    against its twin; its first min(n, 4) columns bit-equal to B2's
    K(A, B) V with V one-hot (p = 4; B2 adds exact zeros), on B2's unsplit
    and most-split grids. The symmetric route, K(C, C) of one tensor, at M
    in EDGE_NM and PAIRWISE_SYM_M: against its twin, bit-equal to the full
    route on C.clone() and to its own transpose. Inputs scaled by
    1/sqrt(d), as B2's edges. Returns (checks, worst ratio)."""
    from repro_torch.core.kernels import make_kernel
    cases, worst, bits = 0, 0.0, 0
    for kind, params in KINDS:
        spec = make_kernel(kind, **params).spec
        for d in EDGE_D:
            for m in EDGE_NM:
                for n in EDGE_NM:
                    A, B = randn(m, d) / d ** 0.5, randn(n, d) / d ** 0.5
                    K = km.pairwise_kernel(A, B, spec=spec)
                    abs_err, ratio = close_err(K, km.pairwise_kernel_plain(A, B, spec=spec))
                    cases += 1
                    worst = max(worst, ratio)
                    check(ratio <= 1.0, f"B3 {kind} m,n,d={m},{n},{d}: max abs err {abs_err:.3e} "
                          f"exceeds atol 1e-4 + rtol 1e-4 (ratio {ratio:.3f})")
                    V = torch.eye(n, 4, device=A.device)
                    w = min(n, 4)
                    for slots in (1, 1 << 30):
                        out = km._kernel_matmul_cuda(A, B, V, None, spec=spec, slots=slots)
                        check(torch.equal(out[:, :w], K[:, :w]),
                              f"B3 {kind} m,n,d={m},{n},{d}: first columns differ from B2's "
                              f"one-hot product (slots={slots})")
                        bits += 1
            for M in EDGE_NM + PAIRWISE_SYM_M:
                C = randn(M, d) / d ** 0.5
                K = km.pairwise_kernel(C, C, spec=spec)
                abs_err, ratio = gram_err(km, K, C, spec)
                cases += 1
                worst = max(worst, ratio)
                check(ratio <= 1.0, f"B3 {kind} M={M} d={d} (symmetric): max abs err "
                      f"{abs_err:.3e} exceeds atol 1e-4 + rtol 1e-4 (ratio {ratio:.3f})")
                check(torch.equal(K, km.pairwise_kernel(C, C.clone(), spec=spec)),
                      f"B3 {kind} M={M} d={d}: the symmetric route differs from the full route")
                check(torch.equal(K, K.mT), f"B3 {kind} M={M} d={d}: K(C, C) is not symmetric")
                bits += 2
    torch.cuda.synchronize()
    say(f"[kernels] B3 tile edges: m, n in {EDGE_NM}, d in {EDGE_D}, five kinds: {cases} checks "
        f"against the twin pass (worst ratio {worst:.4f}); {bits} bit-equalities hold (B2's "
        f"one-hot columns, unsplit and split; K(C, C) at M in {EDGE_NM + PAIRWISE_SYM_M} equal "
        "to the full route and to its transpose)")
    return cases, worst


def gram_err(km, K, C, spec) -> tuple[float, float]:
    """``close_err`` of K(C, C): off the diagonal against the float32 twin,
    on it against a float64 twin. The kernel's diagonal is exact: an entry's
    dot product and both norms are one fmaf sum, so its distance is exactly
    0, while the float32 twin's X X^T and row norms sum in other orders and
    leave up to ~4 eps ||c||^2, which the laplacian's sqrt at distance 0
    turns into ~1e-3."""
    ref = km.pairwise_kernel_plain(C, C, spec=spec).double()
    ref.diagonal().copy_(km.pairwise_kernel_plain(C.double(), C.double(), spec=spec).diagonal())
    return close_err(K, ref)


def check_pairwise_plan(torch, km) -> None:
    """B3's plan on the card against its Python mirror: shared memory and
    resident blocks (the occupancy query against the model, both store
    instantiations) at each path's depth, and every block's range of tiles
    (``rt_pairwise_range``) against ``pairwise_range`` on the modelled and
    the queried grids."""
    import ctypes
    dev = torch.cuda.current_device()
    lib = km._lib()
    queried = {}
    for d in (18, 90):
        for vec in (True, False):
            smem, slots = km._pairwise_slots(km.KIND_CODES["gaussian"], d, vec, dev)
            model = km.pairwise_grid_model(d)
            queried[d] = slots
            say(f"[kernels] B3 plan d={d} vec={vec}: shared memory {smem} B (mirror "
                f"{km.pairwise_smem_bytes(d)}), resident blocks {slots} (model {model})")
            check(smem == km.pairwise_smem_bytes(d) and slots == model,
                  f"B3's plan at d={d} vec={vec} is not its mirror's")
    got = (ctypes.c_longlong * 4)()
    shapes = 0
    for m, n, d, sym in PAIRWISE_PATH_SHAPES + [(1, 1, 1, True), (300, 300, 13, True),
                                                 (513, 129, 33, False), (129, 129, 1, True)]:
        for G in sorted({km.pairwise_grid_model(d), queried.get(d, km.pairwise_grid_model(d)),
                         1, 7}):
            G = min(G, km.pairwise_tiles(m, n, sym))
            for b in range(G):
                lib.rt_pairwise_range(m, n, int(sym), G, b, got)
                check(tuple(got) == km.pairwise_range(m, n, sym, G, b),
                      f"B3's range of block {b} of {G} at m={m} n={n} sym={sym}: C {tuple(got)}, "
                      f"mirror {km.pairwise_range(m, n, sym, G, b)}")
            shapes += 1
    say(f"[kernels] B3 schedule: C and mirror agree on every block's range at {shapes} "
        "(shape, grid) pairs")


def check_sharded(torch, km, spec, X, C, u, v, shard: int, res: dict, tag: str) -> None:
    """B4 against its twin and against B1, with v, without v and under
    ``row_mask``; masked junk rows give exactly the valid prefix's result."""
    n, M = X.shape[0], C.shape[0]
    p = u.numel() // M
    u2, v2 = u.reshape(M, p), v.reshape(n, p)
    w = km.sharded_sweep(X, C, u, v, spec=spec, shard_m=shard).reshape(M, p)
    res["sharded"] = close_err(w, km.sharded_sweep_plain(X, C, u2, v2, spec=spec, shard_m=shard))
    res["sharded vs fused"] = close_err(w, km.fused_sweep(X, C, u2, v2, spec=spec))
    w0 = km.sharded_sweep(X, C, u, None, spec=spec, shard_m=shard).reshape(M, p)
    res["sharded v=None"] = close_err(
        w0, km.sharded_sweep_plain(X, C, u2, None, spec=spec, shard_m=shard))
    keep = n - 20
    Xj = X.clone()
    Xj[keep:] = 123.0
    mask = torch.zeros(n, device=X.device)
    mask[:keep] = 1.0
    got_m = km.sharded_sweep(Xj, C, u, v, spec=spec, row_mask=mask, shard_m=shard)
    got_p = km.sharded_sweep(X[:keep].contiguous(), C, u, v[:keep].contiguous(), spec=spec,
                             shard_m=shard)
    torch.cuda.synchronize()
    check(torch.equal(got_m, got_p), f"{tag}: masked rows changed the sharded sweep "
          f"(max diff {float((got_m - got_p).abs().max())})")
    res["sharded row_mask"] = close_err(
        got_m.reshape(M, p),
        km.sharded_sweep_plain(Xj, C, u2, v2, spec=spec, row_mask=mask, shard_m=shard))


def spill_err(torch, km, spec, got, ref, X, C, t) -> tuple[float, float]:
    """(max |got - ref|, max_j |got_j - ref_j| / (atol + rtol max|ref| +
    BF16_RTOL S_j)) for B4 with its t spilled in bf16, S = |K(X, C)|^T |t|:
    the kernel and its twin round t's fp32 sums to bf16, and an entry whose
    sums fall either side of a rounding boundary moves w_j by up to
    one bf16 unit of t_i times |K_ij|. Small shapes only (K is
    materialized)."""
    K = km.pairwise_kernel_plain(X.float(), C.float(), spec=spec).abs().double()
    S = K.T @ t.double().abs()
    diff = (got.double() - ref.double()).abs()
    lim = TOL["atol"] + TOL["rtol"] * float(ref.double().abs().max()) + BF16_RTOL * S
    return float(diff.max()), float((diff / lim).max())


def check_compensated(torch, km, spec, X, C, u, v, tag: str) -> dict:
    """The compensated builds of B1, B2 and B4 against their compensated
    twins, X and C at the build's type: B1 with v, without v and under
    ``row_mask`` (masked junk rows bit-equal to the valid prefix), and its
    tile count; B2 with and without ``add``, fp32 and bf16 out, on the
    unsplit and the most-split grid; B4 with its t spilled in bf16 (ragged
    64-row shards), masked rows bit-equal to the prefix. Returns
    {check: (max abs err, ratio)}."""
    n, M = X.shape[0], C.shape[0]
    p = u.shape[1]
    bf, f32 = torch.bfloat16, torch.float32
    kw = dict(spec=spec, compensated=True)
    res = {}

    def held(name, got, ref):
        res[name] = close_err(got, ref, TOL["rtol"] + (BF16_RTOL if got.dtype == bf else 0.0))

    w, cnt = km.fused_sweep(X, C, u, v, return_tile_count=True, **kw)
    held(f"sweep ({w.dtype})", w, km.fused_sweep_plain(X, C, u, v, **kw)[0])
    nbi, nbj = km.sweep_tile_grid(n, M)
    check(int(cnt) == len(km.column_groups(p)) * 2 * nbi * nbj, f"{tag}: tile count {int(cnt)}")
    held("sweep v=None", km.fused_sweep(X, C, u, None, **kw),
         km.fused_sweep_plain(X, C, u, None, **kw)[0])
    keep = n - min(20, n // 2)
    Xj = X.clone()
    Xj[keep:] = 123.0
    mask = torch.zeros(n, device=X.device)
    mask[:keep] = 1.0
    got_m = km.fused_sweep(Xj, C, u, v, row_mask=mask, **kw)
    got_p = km.fused_sweep(X[:keep].contiguous(), C, u, v[:keep].contiguous(), **kw)
    torch.cuda.synchronize()
    check(torch.equal(got_m, got_p), f"{tag}: masked rows changed the compensated sweep "
          f"(max diff {float((got_m.double() - got_p.double()).abs().max())})")
    for slots, add, out in ((1, v, bf), (1, None, f32), (1 << 30, v, f32), (1 << 30, None, bf)):
        ref = km.kernel_matmul_plain(X, C, u, add, out_dtype=out, **kw)
        got = (km._kernel_matmul_cuda(X, C, u, add, slots=slots, out_dtype=out, **kw) if p <= 4
               else km.kernel_matmul(X, C, u, add, out_dtype=out, **kw))
        held(f"matmul slots={slots} add={add is not None} out={out}", got, ref)
    sk = dict(kw, shard_m=64, t_dtype=bf, out_dtype=f32)
    t = km.kernel_matmul_plain(X, C, u, v, out_dtype=bf, **kw)
    res["sharded bf16 t"] = spill_err(torch, km, spec, km.sharded_sweep(X, C, u, v, **sk),
                                      km.sharded_sweep_plain(X, C, u, v, **sk), X, C, t)
    got_m = km.sharded_sweep(Xj, C, u, v, row_mask=mask, **sk)
    got_p = km.sharded_sweep(X[:keep].contiguous(), C, u, v[:keep].contiguous(), **sk)
    torch.cuda.synchronize()
    check(torch.equal(got_m, got_p), f"{tag}: masked rows changed the compensated sharded sweep")
    return res


def phase_compensated(torch):
    """The compensated builds (bf16 and fp32) of B1, B2 and B4 against their
    twins for the five kinds, around the 128 x 128 tile (n, M in EDGE_NM, d
    in EDGE_D, p = 1..5 one shape each in turn, u at fp32 or at the build's
    type in turn: bf16 u gives B1 a bf16 output), B1 with its w partial and
    carry in global memory (SWEEP_GLOBAL), and B1's and B2's plans for both
    builds against their mirrors."""
    from repro_torch.core.kernels import make_kernel
    from repro_torch.kernels import kernel_matvec as km
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(2)

    def randn(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    total = 0
    for name in COMP_DTYPES:
        dt = getattr(torch, name)
        cases, worst, i, worst_at = 0, 0.0, 0, ""
        for kind, params in KINDS:
            spec = make_kernel(kind, **params).spec
            for d in EDGE_D:
                for n in EDGE_NM:
                    for M in EDGE_NM:
                        p = COMP_WIDTHS[i % len(COMP_WIDTHS)]
                        X, C = (randn(n, d) / d ** 0.5).to(dt), (randn(M, d) / d ** 0.5).to(dt)
                        u = randn(M, p)
                        u = u.to(dt) if i % 2 else u
                        tag = f"{name} {kind} n,M,d={n},{M},{d} p={p} u {u.dtype}"
                        res = check_compensated(torch, km, spec, X, C, u, randn(n, p).to(dt), tag)
                        i += 1
                        for check_name, (abs_err, ratio) in res.items():
                            check(ratio <= 1.0, f"{check_name} {tag}: max abs err {abs_err:.3e} "
                                  f"(ratio {ratio:.3f} of its bound)")
                            if ratio > worst:
                                worst, worst_at = ratio, f"{check_name}, {tag}"
                        cases += len(res)
        for kind, params in KINDS[:2]:
            spec = make_kernel(kind, **params).spec
            for n, M, d, p in SWEEP_GLOBAL:
                check(not km.sweep_smem_bytes(M, p, d, True)[1],
                      f"compensated sweep M={M} p={p} keeps its w partial in shared memory")
                X, C = randn(n, d).to(dt), randn(M, d).to(dt)
                u, v = randn(M, p), randn(n, p).to(dt)
                res = {}
                w = km.fused_sweep(X, C, u, v, spec=spec, compensated=True)
                res["sweep"] = close_err(w, km.fused_sweep_plain(X, C, u, v, spec=spec,
                                                                 compensated=True)[0])
                again = torch.equal(w, km.fused_sweep(X, C, u, v, spec=spec, compensated=True))
                check(again, f"compensated sweep {name} {kind} M={M} not deterministic")
                abs_err, ratio = res["sweep"]
                check(ratio <= 1.0, f"compensated sweep {name} {kind} n,M,d={n},{M},{d} p={p} "
                      f"(w partial in global memory): max abs err {abs_err:.3e} (ratio {ratio:.3f})")
                worst = max(worst, ratio)
                cases += 1
        torch.cuda.synchronize()
        say(f"[compensated] {name} build: {cases} checks of B1, B2 and B4 against their "
            f"compensated twins pass (five kinds; n, M in {EDGE_NM}; d in {EDGE_D}; p = 1..5; "
            f"masked rows bit-equal to the prefix; B1's w partial and carry in global memory at "
            f"{[(M, p) for _, M, _, p in SWEEP_GLOBAL]}); worst ratio {worst:.4f} ({worst_at})")
        total += cases
    dev_i = torch.cuda.current_device()
    for variant in (1, 2):
        for p in (1, 4):
            for d in (18, 90):
                smem, slots = km._matmul_slots(p, km.KIND_CODES["gaussian"], d, variant, dev_i)
                check(smem == km.matmul_smem_bytes(p, d) and slots == km.matmul_grid_model(p, d),
                      f"B2 build {km.VARIANT_NAMES[variant]} p={p} d={d}: smem {smem}, slots "
                      f"{slots}, not its mirror's")
        for M, d in ((10_000, 18), (50_000, 90)):
            smem, in_smem = km.sweep_smem_bytes(M, 1, d, True)
            grid = km._sweep_grid(1, km.KIND_CODES["gaussian"], smem, variant, dev_i)
            model = km.sweep_grid_model(M, 1, d, True)
            say(f"[compensated] B1 build {km.VARIANT_NAMES[variant]} at M={M} d={d}: shared "
                f"memory {smem} B (w partial and carry there: {in_smem}), grid {grid} (model "
                f"{model})")
            check(model >= grid, "the planner's compensated grid model is below the card's")
    say(f"[compensated] {total} checks pass; B2's plans equal their mirrors for both builds")


def rel(a, b) -> float:
    """Normwise relative distance ||a - b|| / ||b||, in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def phase_blocked(torch):
    """B5-B7 against their twins on the card, at the ragged test shapes, at
    the edges of B5's sub-panels, B6's column blocks and B7's tiles, and at
    this slice's widths (a 1280 tile; the last, 80-wide panel's update with
    k = 1280); B5 and B6 with garbage above the diagonal and with bad
    pivots; the blocked factorization on the "cuda" engine against the
    "torch" engine and a float64 factor."""
    from repro_torch.kernels import blocked_cholesky as bc
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(1)

    def spd(M):
        A = torch.tensor(rng.standard_normal((M, M)), dtype=torch.float32, device=dev)
        return A @ A.T / M + torch.eye(M, device=dev)

    def randn(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    def upper_nan(A):
        b = A.shape[0]
        return A.masked_fill(torch.ones(b, b, dtype=torch.bool, device=dev).triu(1),
                             float("nan"))

    worst = 0.0
    # B5 around its sub-panel width (64), ragged, and at the path's 1280, on
    # tiles whose strict upper triangle is NaN: B5 reads the lower triangle
    for b in POTRF_SIZES:
        A = spd(b)
        L = bc.potrf_tile(upper_nan(A))
        e5 = rel(L, bc.potrf_plain(A))
        upper0 = torch.equal(L.triu(1), torch.zeros_like(L))
        say(f"[blocked] B5 b={b} (NaN above the diagonal): vs twin {e5:.3e} (bound "
            f"{FACTOR_TOL:g} normwise), strict upper triangle exactly 0: {upper0}")
        check(e5 <= FACTOR_TOL and upper0, f"B5 off its twin at b={b}")
        worst = max(worst, e5 / FACTOR_TOL)
    # B6 around its 128-wide column blocks, ragged, and at the path's 1280,
    # with NaN above L's diagonal: B6 reads the lower triangle, as the
    # reference's jnp.tril(L)
    for b in TRSM_WIDTHS:
        L = upper_nan(bc.potrf_tile(spd(b)))
        for r in (1, 17, 3 * b + 17):
            Ap = randn(r, b)
            X = bc.trsm_panel(L, Ap)
            again = torch.equal(X, bc.trsm_panel(L, Ap))
            e6 = rel(X, bc.trsm_plain(L, Ap))
            say(f"[blocked] B6 r={r} b={b} (NaN above the diagonal): vs twin {e6:.3e} (bound "
                f"{FACTOR_TOL:g} normwise), two runs bit-equal: {again}")
            check(e6 <= FACTOR_TOL and again,
                  f"B6 off its twin or not deterministic at r={r} b={b}")
            worst = max(worst, e6 / FACTOR_TOL)
    for b, col in TRSM_BAD_PIVOTS:
        L = upper_nan(bc.potrf_tile(spd(b)))
        L[col, col] = float("nan")
        Ap = randn(3 * b + 17, b)
        X = bc.trsm_panel(L, Ap)
        check(torch.equal(torch.isnan(X), torch.isnan(bc.trsm_plain(L, Ap))),
              f"B6 and its twin put NaN in different places (b={b}, pivot {col})")
        check(bool(torch.isnan(X[:, col:]).all()) and bool(torch.isfinite(X[:, :col]).all()),
              f"B6 is not NaN from column {col} on and finite before it (b={b})")
        say(f"[blocked] B6 b={b}, NaN pivot at column {col}: NaN from that column on, finite "
            "before it, as its twin")
    # B6 divides as IEEE division does: its quotients bit for bit against
    # torch's elementwise a / b (a CUDA tensor divisor, never a scalar's
    # reciprocal), NaN where torch has NaN
    gen = torch.Generator(device=dev).manual_seed(3)

    def floats(n):
        mant = torch.rand(n, generator=gen, device=dev) + 1.0
        exp = torch.randint(-DIV_EXP, DIV_EXP + 1, (n,), generator=gen, device=dev)
        sign = torch.randint(0, 2, (n,), generator=gen, device=dev) * 2.0 - 1.0
        v = sign * mant * torch.exp2(exp.float())
        v[:8] = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"), 1e-40,
                              -1e-45, 3.0e38], device=dev)
        return v

    A1 = floats(DIV_ROWS)[:, None]
    for d in floats(DIV_DIVISORS):
        L1 = d.reshape(1, 1)
        X1, ref = bc.trsm_panel(L1, A1), A1 / L1.expand_as(A1)
        nan = torch.isnan(ref)
        check(torch.equal(torch.isnan(X1), nan)
              and torch.equal(X1[~nan].view(torch.int32), ref[~nan].view(torch.int32)),
              f"B6's quotients by {float(d)!r} differ from torch's division")
    say(f"[blocked] B6 b=1: {DIV_DIVISORS} divisors x {DIV_ROWS} dividends bit-equal to torch's "
        "division")
    # B7 at the ragged shapes: (r, b, k) of the last update of M = 5x10^4
    # (80, 80, 1280), of (M, block) = (300, 256) and (500, 192), a full
    # first-panel tile, one entry, ragged tiles with k % 4 != 0 (the
    # scalar-load instantiation) and B5's sub-panel width k = 64
    for r, b, k in UPDATE_SHAPES:
        C, P, Q = randn(r, b), randn(r, k), randn(b, k)
        ref = bc.update_plain(C, P, Q)
        out = bc.trailing_update(C, P, Q)
        abs_err, ratio = close_err(out, ref)
        inplace = bc.trailing_update(C, P, Q, out=C)
        torch.cuda.synchronize()
        check(torch.equal(inplace, out), f"B7 in place differs at r,b,k={r},{b},{k}")
        say(f"[blocked] B7 r,b,k={r},{b},{k}: max abs err {abs_err:.3e}, ratio {ratio:.4f}")
        check(ratio <= 1.0, f"B7 off its twin at r,b,k={r},{b},{k} (ratio {ratio})")
        worst = max(worst, ratio)
    for b, col in BAD_PIVOTS:
        A = spd(b)
        A[col, col] = -100.0
        L = bc.potrf_tile(A)
        nan = torch.isnan(L)
        low = torch.ones(b - col, b - col, dtype=torch.bool, device=dev).tril()
        check(torch.equal(nan, torch.isnan(bc.potrf_plain(A))),
              f"B5 and its twin put NaN in different places (b={b}, pivot {col})")
        check(bool(torch.isfinite(L[:, :col]).all()) and bool(nan[col:, col:][low].all())
              and torch.equal(L.triu(1), torch.zeros_like(L)),
              f"B5 is not NaN from column {col} on and finite before it (b={b})")
        say(f"[blocked] B5 b={b}, non-positive pivot at column {col}: NaN on and below the "
            "diagonal from that column on, finite before it, as its twin")
    for M, block in ((300, 256), (500, 192), (260, 256), (3000, 1280)):
        K = spd(M).cpu()
        T64 = torch.linalg.cholesky(K.double()).mT
        stats = bc.FactorStats()
        Tc = bc.blocked_cholesky(K, block, tile_impl="cuda", device=dev, stats=stats)
        Tt = bc.blocked_cholesky(K, block, tile_impl="torch", device=dev)
        ec, et = rel(Tc, T64), rel(Tt, T64)
        eg = rel(Tc, Tt)
        say(f"[blocked] M={M} block={block}: cuda engine vs float64 {ec:.3e}, torch engine vs "
            f"float64 {et:.3e}, cuda vs torch {eg:.3e} (bound {FACTOR_TOL:g}); device peak "
            f"{stats.measured_peak_device_bytes} B measured, {stats.peak_device_bytes} B "
            f"accounted, panels {stats.panels}, updates {stats.tiles_updated}")
        check(max(ec, eg) <= FACTOR_TOL, f"blocked cholesky M={M} block={block} off")
        check(stats.current_device_bytes == 0, "blocked cholesky left device buffers")
        worst = max(worst, ec / FACTOR_TOL, eg / FACTOR_TOL)
    say(f"[blocked] all checks pass; worst error / bound = {worst:.4f}")


def make_susy(torch, seed: int, n: int, n_test: int):
    from repro_torch.data.synthetic import PAPER_TASKS, make_kernel_dataset
    task = PAPER_TASKS["susy"]
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    X, y = make_kernel_dataset(g, task, n,
                               fn_generator=torch.Generator(device=DEVICE).manual_seed(seed + 1))
    Xt, yt = make_kernel_dataset(g, task, n_test,
                                 fn_generator=torch.Generator(device=DEVICE).manual_seed(seed + 1))
    return task, X, y, Xt, yt


def susy_config(FalkonConfig, task, **kw):
    base = dict(kernel="gaussian", kernel_params=(("sigma", task.sigma),), lam=task.lam,
                num_centers=10_000, iterations=20, ops_impl="cuda", device=DEVICE)
    base.update(kw)
    return FalkonConfig(**base)


def phase_main(torch, args):
    from repro_torch.core import FalkonConfig, falkon_fit
    from repro_torch.kernels import kernel_matvec as km
    t0 = time.perf_counter()
    task, X, y, Xt, yt = make_susy(torch, args.seed, args.n, args.n_test)
    torch.cuda.synchronize()
    say(f"[main] SUSY-shape data n={args.n} n_test={args.n_test} d={task.d} "
        f"in {time.perf_counter() - t0:.3f} s")
    if args.n != 4_000_000:
        say(f"[main] n cut from 4000000 to {args.n} (only n; d, M, sigma, lam, t kept)")
    config = susy_config(FalkonConfig, task)

    km.reset_launch_counts()
    times: dict[str, float] = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    est, state = falkon_fit(args.seed, X, y, config, stage_times=times)
    t1 = time.perf_counter()
    pred = est.predict(Xt)
    torch.cuda.synchronize()
    times["predict"] = time.perf_counter() - t1
    counts = km.launch_counts()
    fit_s = t1 - t0
    say("[main] stage seconds: " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items() if isinstance(v, float))
        + f"; fit total {fit_s:.4f}; factor route {times['factor_path']}")
    peak = torch.cuda.max_memory_allocated()
    say(f"[main] peak device memory {peak / 2**30:.3f} GiB")
    say(f"[main] kernel launches in the main path: {counts}")
    check(counts["fused_sweep"] == 47, f"sweep kernel launched {counts['fused_sweep']} times, not 47")
    check(counts["pairwise_kernel"] == 1, f"pairwise kernel launched {counts['pairwise_kernel']} times")
    check(counts["kernel_matmul"] >= 1, "kernel matmul never launched by predict")

    res = state.residual_norms.cpu()
    cond = float(state.cond_estimate)
    say("[main] residual norms: " + " ".join(f"{float(r):.4e}" for r in res))
    say(f"[main] cond_estimate {cond:.6g}")
    check(state.alpha.shape == (config.num_centers,), f"alpha shape {tuple(state.alpha.shape)}")
    check(pred.shape == (args.n_test,), f"prediction shape {tuple(pred.shape)}")
    check(bool(torch.isfinite(state.alpha).all() and torch.isfinite(pred).all()),
          "non-finite alpha or predictions")
    check(bool(torch.isfinite(res).all()) and float(res[-1]) < float(res[0]),
          "CG residual did not decrease")
    check(np.isfinite(cond) and cond > 0, f"cond_estimate {cond}")
    err = float((torch.sign(pred) != yt).float().mean())
    err_train = float((torch.sign(est.predict(X[:args.n_test])) != y[:args.n_test]).float().mean())
    say(f"[main] test error {err:.6f} (train-subset error {err_train:.6f}; label noise 0.1)")
    check(err < 0.4, f"test error {err} no better than chance")

    # the same fit, small, on the kernels and on the plain "torch" backend.
    # At lam = 1e-3 the two agree to 1e-3. At the slice's lam = 1e-6 the
    # solve amplifies fp32 rounding, so there each float32 fit is held
    # against a float64 "torch" fit over SMALL_SEEDS center draws, each
    # fit's alpha scored in float64 so that only the fit is compared: the
    # kernels' fits may stand at most 1.5x as far (summed over the draws) as
    # the plain float32 fits do.
    ns, ms = 20_000, 500
    Xs, ys, Xts = X[:ns], y[:ns], Xt[:ns]

    def small_fit(seed, impl, lam, dtype="float32"):
        cfg = susy_config(FalkonConfig, task, num_centers=ms, ops_impl=impl, lam=lam,
                          dtype=dtype)
        return falkon_fit(seed, Xs, ys, cfg)[0]

    def scored64(e):
        return km.kernel_matmul_plain(Xts.double(), e.centers.double(),
                                      e.alpha.double()[:, None], spec=e.kernel.spec)[:, 0]

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    r3 = rel(small_fit(args.seed, "cuda", 1e-3).predict(Xts).double(),
             small_fit(args.seed, "torch", 1e-3).predict(Xts).double())
    say(f"[main] small fit n={ns} M={ms} lam=1e-3: cuda vs torch backend predictions "
        f"rel {r3:.3e} (bound 1e-3)")
    check(r3 <= 1e-3, f"cuda fit disagrees with the torch backend: {r3}")
    rc, rt = [], []
    for seed in range(args.seed, args.seed + SMALL_SEEDS):
        ref = scored64(small_fit(seed, "torch", task.lam, "float64"))
        rc.append(rel(scored64(small_fit(seed, "cuda", task.lam)), ref))
        rt.append(rel(scored64(small_fit(seed, "torch", task.lam)), ref))
    say(f"[main] small fit n={ns} M={ms} lam={task.lam:g}, {SMALL_SEEDS} center draws: "
        f"rel distance of the float32 fits from the float64 torch fit: cuda "
        + " ".join(f"{r:.3e}" for r in rc) + "; torch " + " ".join(f"{r:.3e}" for r in rt)
        + f"; sums {sum(rc):.4e} vs {sum(rt):.4e} (bound 1.5x the latter)")
    check(sum(rc) <= 1.5 * sum(rt), f"cuda fits at lam={task.lam:g} stand {sum(rc):.4e} "
          f"from the float64 fits, more than 1.5x the float32 torch fits' {sum(rt):.4e}")
    # one sweep at this shape against a float64 twin
    e = small_fit(args.seed, "cuda", task.lam)
    u = torch.randn(ms, generator=torch.Generator(device=DEVICE).manual_seed(5), device=DEVICE)
    sweep_witness(torch, km, e.kernel.spec, Xs, e.centers, u, f"n={ns} M={ms}")
    return dict(X=X, y=y, Xt=Xt, yt=yt, centers=est.centers, alpha=est.alpha,
                spec=est.kernel.spec, counts=counts, fit_s=fit_s,
                times=times, peak=peak, err=err, pred=pred, task=task)


def phase_path(torch, args, main) -> dict:
    """The lam path at SUSY's full width: ``falkon_fit_path`` with the main
    fit's config and generator seed (so its centers) over PATH_LAMS, the
    test rows as the validation set; its facade and launch counts, stage
    seconds, device peak and every lam's validation MSE; at lam = 1e-6 its
    test error and alpha beside the main fit's; one single fit at the
    grid's smallest lam (no cond estimate) timed beside it, its alpha
    against the path's; then the small checks (``path_small``) and the
    leverage fit (``path_leverage``). Returns the path fit's launch counts,
    which the kernels line reads."""
    from repro_torch.core import FalkonConfig, falkon_fit, falkon_fit_path
    from repro_torch.kernels import kernel_matvec as km
    from repro_torch.ops import CountingOps
    X, y, Xt, yt, task = main["X"], main["y"], main["Xt"], main["yt"], main["task"]
    L, t = len(PATH_LAMS), 20
    config = susy_config(FalkonConfig, task)
    ops = CountingOps(config.make_ops())
    times: dict = {}
    km.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = falkon_fit_path(args.seed, X, y, config, PATH_LAMS, X_val=Xt, y_val=yt, ops=ops,
                          stage_times=times)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    counts = km.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    say(f"[path] lam path, L={L} lams 1e-8 .. {PATH_LAMS[-1]:.4g} (10^(-8 + k/2)), n={X.shape[0]} "
        f"M={config.num_centers} t={t}: stage seconds " + ", ".join(
            f"{k} {v:.4f}" for k, v in times.items() if isinstance(v, float))
        + f"; path fit total {path_s:.4f}; factor route {times['factor_path']}")
    say(f"[path] peak device memory {peak / 2**30:.3f} GiB ({peak} B; the A stack "
        f"{L} x M^2 x 4 = {L * config.num_centers**2 * 4} B)")
    say(f"[path] ops facade: {ops.sweeps} sweeps, {ops.applies} apply, {ops.grams} gram; "
        f"kernel launches: {counts}")
    check((ops.sweeps, ops.applies, ops.grams) == (t + 1, 1, 1),
          f"path facade counts {(ops.sweeps, ops.applies, ops.grams)}, not ({t + 1}, 1, 1)")
    want = {"fused_sweep": 1 + t * 2, "kernel_matmul": 2, "pairwise_kernel": 1}
    check(all(counts[k] == v for k, v in want.items()),
          f"path launches {counts}, expected {want} (1 RHS sweep + {t} x 2 column groups)")
    check(torch.equal(res.estimators[0].centers, main["centers"]),
          "the path's centers are not the main fit's")
    scores = res.val_scores.cpu()
    check(bool(torch.isfinite(scores).all()) and bool(torch.isfinite(res.state.alphas).all()),
          "non-finite path alphas or validation scores")
    say("[path] validation MSE per lam: " + ", ".join(
        f"{lam:.3g}: {float(s):.6f}" for lam, s in zip(PATH_LAMS, scores))
        + f"; best lam {PATH_LAMS[res.best_index]:.3g}")
    res_norms = res.state.residual_norms.cpu()
    check(bool((res_norms[-1] < res_norms[0]).all()), "a path system's residual did not fall")

    i6 = PATH_LAMS.index(task.lam)
    est6 = res.estimators[i6]
    pred6 = est6.predict(Xt)
    err6 = float((torch.sign(pred6) != yt).float().mean())
    say(f"[path] lam={task.lam:g}: test error {err6:.6f} (main fit {main['err']:.6f}, bound "
        f"0.002 apart)")
    check(abs(err6 - main["err"]) <= 0.002, f"path test error {err6} vs main {main['err']}")
    against_single(torch, args, main, f"lam={task.lam:g}, against the main fit", res, i6,
                   main["pred"], main["alpha"])

    lam0 = PATH_LAMS[0]
    stimes: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est0, _ = falkon_fit(args.seed, X, y, susy_config(FalkonConfig, task, lam=lam0,
                                                      estimate_cond=False),
                         stage_times=stimes)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    say(f"[path] one single fit at lam={lam0:g} (estimate_cond=False): {single_s:.4f} s (solve "
        f"{stimes['solve']:.4f}); the path fit {path_s:.4f} s (solve {times['solve']:.4f}) "
        f"beside {L} x the single fit {L * single_s:.4f} s (solves {L * stimes['solve']:.4f})")
    against_single(torch, args, main, f"lam={lam0:g}, against this single fit", res, 0,
                   est0.predict(Xt), est0.alpha)
    del res, est0
    path_small(torch, args, main)
    path_leverage(torch, args, main)
    return dict(counts=counts)


def against_single(torch, args, main, tag: str, res, i: int, single_pred,
                   single_alpha) -> None:
    """The path's estimator ``i`` against a single fit of the same system
    (same centers and factors). At SUSY's small lams float32 rounding alone
    moves alpha far (T^-1 A^-1 amplifies it; in float64 the path is the
    single fits to 1e-6, tests/test_torch_path.py), so the path's alpha is
    held to PATH_ALPHA_BOUND, measured on the card, and both are held
    against a float64 fit of the same system (the "torch" backend, same
    seed and so the same centers): the path's alpha and test predictions
    no farther from it than PATH_AGREE x the single fit's."""
    from repro_torch.core import FalkonConfig, falkon_fit
    X, y, Xt, task = main["X"], main["y"], main["Xt"], main["task"]
    lam = PATH_LAMS[i]
    t0 = time.perf_counter()
    # its 800 MB float64 factor past the 512 MB budget stays in-core: the
    # blocked route's tile kernels are float32
    os.environ["REPRO_FACTOR_BUDGET_MB"] = "1024"
    try:
        ref = falkon_fit(args.seed, X.double(), y.double(),
                         susy_config(FalkonConfig, task, lam=lam, dtype="float64",
                                     ops_impl="torch", estimate_cond=False))[0]
    finally:
        os.environ.pop("REPRO_FACTOR_BUDGET_MB")
    ref_pred = ref.predict(Xt.double())
    torch.cuda.synchronize()
    check(torch.equal(ref.centers.float(), main["centers"]), "the float64 fit drew other centers")
    est = res.estimators[i]
    pred = est.predict(Xt)
    d = dict(alpha=rel(est.alpha, single_alpha), pred=rel(pred, single_pred))
    p64 = dict(alpha=rel(est.alpha, ref.alpha), pred=rel(pred, ref_pred))
    s64 = dict(alpha=rel(single_alpha, ref.alpha), pred=rel(single_pred, ref_pred))
    say(f"[path] {tag}: rel distance of the path's alpha {d['alpha']:.4e} (bound "
        f"{PATH_ALPHA_BOUND:g}) and test predictions {d['pred']:.4e}; from a float64 fit "
        f"({time.perf_counter() - t0:.1f} s): the path's alpha {p64['alpha']:.4e}, predictions "
        f"{p64['pred']:.4e}, the single fit's {s64['alpha']:.4e}, {s64['pred']:.4e} (bound "
        f"{PATH_AGREE:g}x the single fit's)")
    check(d["alpha"] <= PATH_ALPHA_BOUND, f"the path's alpha ({tag}) stands {d['alpha']:.4e} off")
    check(all(p64[k] <= PATH_AGREE * s64[k] for k in p64),
          f"the path ({tag}) stands {p64} from a float64 fit, past {PATH_AGREE:g}x the "
          f"single fit's {s64}")


def path_small(torch, args, main) -> None:
    """The path at n = 20,000, M = 500 on the card: every lam's alpha on
    the "cuda" backend against a float64 ``nystrom_direct`` on the same
    (uniform, distinct) centers, no farther from it (summed over the grid)
    than PATH_AGREE x the plain float32 "torch" path, and against a float64
    single fit of t = 20 no farther than PATH_AGREE x a float32 single fit
    on the card (the path is as accurate as the fits it replaces); then the
    same grid
    forced onto the blocked factor (``REPRO_FACTOR_BUDGET_MB``), its A
    stack against the in-core stack: each lam factors its own copy of
    T T^T."""
    from repro_torch.core import (FalkonConfig, falkon_fit, falkon_fit_path,
                                  make_preconditioner, nystrom_direct)
    from repro_torch.ops import FactorPlanWarning
    task = main["task"]
    ns, ms = 20_000, 500
    Xs, ys = main["X"][:ns], main["y"][:ns]
    cfg = susy_config(FalkonConfig, task, num_centers=ms)
    res = {impl: falkon_fit_path(args.seed, Xs, ys, dataclasses.replace(cfg, ops_impl=impl),
                                 PATH_LAMS) for impl in ("cuda", "torch")}
    C = res["cuda"].estimators[0].centers
    check(torch.equal(C, res["torch"].estimators[0].centers), "small path centers differ")
    kern = cfg.make_kernel()
    dc, dt = [], []
    for i, lam in enumerate(PATH_LAMS):
        oracle = nystrom_direct(Xs.double(), ys.double(), C.double(), kern, lam).alpha
        check(bool(torch.isfinite(oracle).all()), f"nystrom_direct at lam={lam:g} not finite")
        dc.append(rel(res["cuda"].state.alphas[i], oracle))
        dt.append(rel(res["torch"].state.alphas[i], oracle))
    say(f"[path] small path n={ns} M={ms}: rel distance of each lam's alpha from a float64 "
        "nystrom_direct on the same centers: cuda " + " ".join(f"{r:.3e}" for r in dc)
        + "; torch " + " ".join(f"{r:.3e}" for r in dt)
        + f"; sums {sum(dc):.4e} vs {sum(dt):.4e} (bound {PATH_AGREE:g}x the latter)")
    check(sum(dc) <= PATH_AGREE * sum(dt), f"the cuda path stands {sum(dc):.4e} from "
          f"nystrom_direct, more than {PATH_AGREE:g}x the torch path's {sum(dt):.4e}")
    # as accurate as single fits: each lam's path alpha and a float32 single
    # fit's on the card, against a float64 single fit on the same centers
    dp, ds = [], []
    for i, lam in enumerate(PATH_LAMS):
        one = dataclasses.replace(cfg, lam=lam, estimate_cond=False)
        ref = falkon_fit(args.seed, Xs.double(), ys.double(),
                         dataclasses.replace(one, dtype="float64", ops_impl="torch"))[0].alpha
        dp.append(rel(res["cuda"].state.alphas[i], ref))
        ds.append(rel(falkon_fit(args.seed, Xs, ys, one)[0].alpha, ref))
    say(f"[path] small path n={ns} M={ms}: rel distance from a float64 single fit (t = 20) of "
        "each lam's path alpha " + " ".join(f"{r:.3e}" for r in dp) + "; of a float32 "
        "single fit's " + " ".join(f"{r:.3e}" for r in ds)
        + f"; sums {sum(dp):.4e} vs {sum(ds):.4e} (bound {PATH_AGREE:g}x the latter)")
    check(sum(dp) <= PATH_AGREE * sum(ds), f"the path stands {sum(dp):.4e} from float64 "
          f"single fits, more than {PATH_AGREE:g}x the float32 single fits' {sum(ds):.4e}")
    os.environ["REPRO_FACTOR_BUDGET_MB"] = "0.2"
    try:
        stimes: dict = {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FactorPlanWarning)
            blocked = falkon_fit_path(args.seed, Xs, ys, cfg, PATH_LAMS, stage_times=stimes)
            KMM = blocked.estimators[0].ops.gram(C, C)
            singles = [make_preconditioner(KMM, lam, ns, factor_plan="blocked").A
                       for lam in PATH_LAMS]
    finally:
        os.environ.pop("REPRO_FACTOR_BUDGET_MB")
    A_b, A_i = blocked.state.precond.A, res["cuda"].state.precond.A
    ra = [rel(A_b[i], A_i[i]) for i in range(len(PATH_LAMS))]
    same = all(torch.equal(A_b[i], singles[i]) for i in range(len(PATH_LAMS)))
    copies = stimes["factor_stats"].host_copy_bytes
    say(f"[path] small path forced blocked ({stimes['factor_path']} block "
        f"{stimes['factor_block']}): A stack against the in-core stack, per lam rel "
        + " ".join(f"{r:.3e}" for r in ra) + f" (bound {PATH_STACK_TOL:g}); each A bit-equal "
        f"to a blocked single-lam build: {same}; host copies of T T^T {copies} B")
    check(stimes["factor_path"] == "blocked", "the small path did not route blocked")
    check(max(ra) <= PATH_STACK_TOL and same,
          "the blocked path's A stack disagrees with the in-core stack or the single builds")
    check(copies == (len(PATH_LAMS) - 1) * ms * ms * 4, f"host copies {copies} B")


def path_leverage(torch, args, main) -> None:
    """One ``falkon_fit`` at the SUSY shape with leverage-score centers
    (pilot 256, scored at lam = 1e-6): the pilot, scoring and sampling
    stages timed apart on the fit's generator seed (the same draws as the
    fit's), the count of distinct centers, D's range and the test error;
    then on 4,096 rows the card's float32 approximate scores against a
    float64 scoring of the same pilot and against float64
    ``exact_leverage_scores``."""
    from repro_torch.core import (FalkonConfig, approximate_leverage_scores,
                                  build_leverage_pilot, exact_leverage_scores, falkon_fit,
                                  leverage_score_centers, leverage_scores_from_pilot)
    X, y, Xt, yt, task = main["X"], main["y"], main["Xt"], main["yt"], main["task"]
    cfg = susy_config(FalkonConfig, task, center_selection="leverage")
    kern = cfg.make_kernel()
    g = torch.Generator(device=DEVICE).manual_seed(args.seed)
    stage = {}
    for name, fn in (("pilot", lambda: build_leverage_pilot(g, X, kern, pilot_size=256)),
                     ("scoring", lambda: leverage_scores_from_pilot(stage["pilot"][0], X, kern,
                                                                    task.lam)),
                     ("sampling", lambda: leverage_score_centers(g, X, cfg.num_centers,
                                                                 stage["scoring"][0]))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stage[name] = (out, time.perf_counter() - t0)
    sel = stage["sampling"][0]
    times: dict = {}
    est, st = falkon_fit(args.seed, X, y, cfg, stage_times=times)
    check(torch.equal(est.centers, sel.centers), "the leverage fit drew other centers")
    distinct = int(torch.unique(sel.indices).numel())
    D = st.precond.D
    err = float((torch.sign(est.predict(Xt)) != yt).float().mean())
    say(f"[path] leverage centers at n={X.shape[0]} M={cfg.num_centers} (pilot 256, lam "
        f"{task.lam:g}): pilot {stage['pilot'][1]:.4f} s, scoring {stage['scoring'][1]:.4f} s, "
        f"sampling {stage['sampling'][1]:.4f} s; {distinct} distinct centers of "
        f"{cfg.num_centers}; D in [{float(D.min()):.4e}, {float(D.max()):.4e}]; fit stage "
        "seconds " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()
                               if isinstance(v, float))
        + f"; test error {err:.6f} (uniform: {main['err']:.6f})")
    check(bool(torch.isfinite(est.alpha).all()) and bool(torch.isfinite(D).all()),
          "non-finite leverage fit")
    check(err < 0.4, f"leverage fit test error {err} no better than chance")
    Xs = X[:4096]
    gs = torch.Generator(device=DEVICE).manual_seed(args.seed + 3)
    pilot = build_leverage_pilot(gs, Xs, kern, pilot_size=256)
    s32 = leverage_scores_from_pilot(pilot, Xs, kern, task.lam)
    pilot64 = pilot._replace(S=pilot.S.double(), KSS=pilot.KSS.double(),
                             KSnKnS=pilot.KSnKnS.double())
    s64 = leverage_scores_from_pilot(pilot64, Xs.double(), kern, task.lam)
    exact = exact_leverage_scores(Xs.double(), kern, task.lam)
    approx = approximate_leverage_scores(torch.Generator(device=DEVICE).manual_seed(args.seed + 3),
                                         Xs, kern, task.lam, pilot_size=256)
    check(torch.equal(approx, s32), "approximate_leverage_scores is not its two stages")
    r32 = rel(s32, s64)
    ratio = (s64 / exact).cpu()
    corr = float(torch.corrcoef(torch.stack([s32.double(), exact]))[0, 1])
    say(f"[path] leverage scores on {Xs.shape[0]} rows (pilot 256, lam {task.lam:g}): float32 "
        f"on the card vs float64 scoring of the same pilot rel {r32:.4e} (bound "
        f"{LEVERAGE_FP32_BOUND:g}); the float64 scoring against float64 exact scores: ratio "
        f"range [{float(ratio.min()):.4e}, {float(ratio.max()):.10f}] (the estimator is the "
        f"exact score of the pilot's Nystrom kernel, never above the exact one: bound 1 + "
        f"{LEVERAGE_RATIO_SLACK:g}), median {float(ratio.median()):.4f}, correlation of the "
        f"float32 scores with the exact ones {corr:.4f}; sum of the exact scores (effective "
        f"dimension) {float(exact.sum()):.2f} against the pilot's 256 rows")
    check(r32 <= LEVERAGE_FP32_BOUND, f"float32 leverage scores off float64 by {r32:.4e}")
    check(float(ratio.max()) <= 1.0 + LEVERAGE_RATIO_SLACK and float(ratio.min()) > 0.0,
          "approximate leverage scores above the exact ones or not positive")


def phase_bf16(torch, args, main) -> list[dict]:
    """The bf16 policy at SUSY's shape: the compensated bf16 B1 sweep at the
    fit's shape and B2 at predict's against float64 twins, on the same
    bf16-quantized inputs (the kernels' own accumulation) and on the
    unquantized ones (the policy's error), B1 bit-equal over two runs; then
    the full-size fit with ``precision="bf16"`` on the fp32 fit's data and
    generator seed, its stage times, device peak and test error beside the
    fp32 fit's, and its launches. Returns the kernels line's rows."""
    from repro_torch.core import FalkonConfig, falkon_fit
    from repro_torch.kernels import kernel_matvec as km
    bf = torch.bfloat16
    X, Xt, C, alpha, spec = main["X"], main["Xt"], main["centers"], main["alpha"], main["spec"]
    n, d = X.shape
    M, m = C.shape[0], Xt.shape[0]
    Xq, Cq, Xtq = X.to(bf), C.to(bf), Xt.to(bf)
    u = torch.randn(M, generator=torch.Generator(device=DEVICE).manual_seed(11), device=DEVICE)
    rows = []

    sweep = lambda: km.fused_sweep(Xq, Cq, u, spec=spec, compensated=True)
    w = sweep()
    again = torch.equal(w, sweep())
    w64q = km.fused_sweep_plain(Xq.double(), Cq.double(), u.double()[:, None], None,
                                spec=spec)[0][:, 0]
    w64 = km.fused_sweep_plain(X.double(), C.double(), u.double()[:, None], None,
                               spec=spec)[0][:, 0]
    S = km.fused_sweep_plain(Xq.float(), Cq.float(), u.abs()[:, None], None,
                             spec=spec)[0][:, 0].double()
    abs_err, ratio = close_err(w, w64q)
    rs = float(((w.double() - w64q).abs() / (PRED_RTOL * S + 1e-12)).max())
    pol = rel(w, w64)
    say(f"[bf16] SUSY-shape sweep n={n} M={M} d={d}, bf16 compensated B1: against a float64 "
        f"twin on the same bf16 inputs max abs err {abs_err:.4e} (ratio {ratio:.4f} of atol "
        f"1e-4 + rtol 1e-4, bound 1; {rs:.4f} of {PRED_RTOL:g} x sum|terms|); the policy's "
        f"error against float64 on the unquantized inputs {pol:.4e} (normwise; the reference "
        f"documents <= {POLICY_BOUND:g}); two runs bit-equal: {again}")
    check(ratio <= 1.0 and again, "bf16 B1 at the SUSY shape is off its float64 twin or not "
          "deterministic")
    breakdown(torch, f"B1 bf16 n={n} M={M} d={d}", sweep)
    ms = time_cuda(torch, sweep, 5)
    plain = time_cuda(torch, lambda: km.fused_sweep_plain(Xq, Cq, u[:, None], None, spec=spec,
                                                          compensated=True, block_rows=65_536),
                      1, warm=False)
    b, by = bound(n * M * (2 * d + 10 + 4), 2 * (n * d + M * d) + 4 * 2 * M)
    say(f"[bf16] B1 bf16 at the SUSY shape: kernel {ms:.4f} ms, compensated twin {plain:.4f} ms, "
        f"bound {b:.4f} ms ({by})")
    rows.append(dict(name="fused_sweep_bf16c", base="fused_sweep", ms=ms, plain_ms=plain,
                     bound_ms=b, bound_by=by, max_abs_err=abs_err,
                     shape=f"n={n} M={M} d={d} p=1 bf16"))
    del w64, w64q

    predict = lambda: km.kernel_matmul(Xtq, Cq, alpha, spec=spec, compensated=True)
    out = predict().double()
    again = torch.equal(out, predict().double())
    ref64 = km.kernel_matmul_plain(Xtq.double(), Cq.double(), alpha.double()[:, None],
                                   spec=spec)[:, 0]
    Sp = float(km.kernel_matmul_plain(Xtq, Cq, alpha.abs()[:, None], spec=spec).max())
    err64 = float((out - ref64).abs().max())
    say(f"[bf16] predict-shape kernel matmul m={m} n={M}, bf16 compensated B2: max abs err "
        f"{err64:.4e} against a float64 twin on the same bf16 inputs (limit {PRED_RTOL:g} x max "
        f"sum|terms| {Sp:.4e} = {PRED_RTOL * Sp:.4e}); two runs bit-equal: {again}")
    check(err64 <= PRED_RTOL * Sp and again, "bf16 B2 at the predict shape is off its float64 "
          "twin or not deterministic")
    breakdown(torch, f"B2 bf16 m={m} n={M} d={d}", predict)
    ms = time_cuda(torch, predict, 10)
    plain = time_cuda(torch, lambda: km.kernel_matmul_plain(Xtq, Cq, alpha[:, None], spec=spec,
                                                            compensated=True), 1, warm=False)
    b, by = bound(m * M * (2 * d + 10 + 2), 2 * (m * d + M * d) + 4 * (M + m))
    say(f"[bf16] B2 bf16 at the predict shape: kernel {ms:.4f} ms, compensated twin {plain:.4f} "
        f"ms, bound {b:.4f} ms ({by})")
    rows.append(dict(name="kernel_matmul_bf16c", base="kernel_matmul", ms=ms, plain_ms=plain,
                     bound_ms=b, bound_by=by, max_abs_err=err64,
                     shape=f"m={m} n={M} d={d} p=1 bf16"))
    del Xq, Cq, Xtq, out, ref64

    # the fit, on the fp32 fit's data and seed
    config = susy_config(FalkonConfig, main["task"], precision="bf16")
    km.reset_launch_counts()
    times: dict = {}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    est, state = falkon_fit(args.seed, X, main["y"], config, stage_times=times)
    t1 = time.perf_counter()
    pred = est.predict(Xt)
    torch.cuda.synchronize()
    times["predict"] = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    counts, variants = km.launch_counts(), km.variant_launch_counts()
    fit_s = t1 - t0
    ft = main["times"]
    say("[bf16] stage seconds, bf16 fit [fp32 fit]: " + ", ".join(
        f"{k} {v:.4f} [{ft[k]:.4f}]" for k, v in times.items() if isinstance(v, float))
        + f"; fit total {fit_s:.4f} [{main['fit_s']:.4f}]")
    say(f"[bf16] peak device memory {peak / 2**30:.3f} GiB [fp32 fit: {main['peak'] / 2**30:.3f} "
        f"GiB]; {before / 2**30:.3f} GiB was allocated before the fit (the fp32 data); X on the "
        f"card {X.numel() * 2 / 2**20:.1f} MiB in bf16, {X.numel() * 4 / 2**20:.1f} MiB in fp32")
    say(f"[bf16] kernel launches in the bf16 fit: {counts}; by build: "
        + ", ".join(f"{k} {v}" for k, v in variants.items() if v))
    check(variants["fused_sweep_bf16c"] == 47 and counts["fused_sweep"] == 47,
          f"the bf16 fit's sweeps did not all run the bf16 build: {variants}")
    check(variants["kernel_matmul_bf16c"] >= 1 and counts["pairwise_kernel"] == 1,
          f"the bf16 fit's predict or gram did not launch: {counts} {variants}")
    check(state.beta.dtype == bf, f"CG iterates stored as {state.beta.dtype}, not bf16")
    res = state.residual_norms.cpu()
    check(bool(torch.isfinite(state.alpha).all() and torch.isfinite(pred).all()),
          "non-finite alpha or predictions in the bf16 fit")
    check(bool(torch.isfinite(res).all()) and float(res[-1]) < float(res[0]),
          "the bf16 fit's CG residual did not decrease")
    err = float((torch.sign(pred) != main["yt"]).float().mean())
    say("[bf16] residual norms: " + " ".join(f"{float(r):.4e}" for r in res))
    say(f"[bf16] cond_estimate {float(state.cond_estimate):.6g}; test error {err:.6f} [fp32 fit: "
        f"{main['err']:.6f}]; predictions' distance from the fp32 fit's {rel(pred, main['pred']):.4e}")
    check(err < 0.4, f"bf16 fit test error {err} no better than chance")
    for r in rows:
        r["launches"] = variants[r["name"]]
    return rows


def msd_bf16_sweep(torch, msd) -> dict:
    """One bf16 sweep at the MillionSongs shape on the policy's B4 route
    (``REPRO_SWEEP_BUDGET_MB`` forces it off B1: t spilled in bf16, w fp32)
    against a float64 twin on the same bf16 inputs, timed; B1's bf16 build
    (its w partial and carry in global memory) at the same shape against
    the same twin. Returns the kernels line's B4 row."""
    from repro_torch.kernels import kernel_matvec as km
    from repro_torch.ops import SweepPlanWarning, get_ops
    bf = torch.bfloat16
    X, C, spec = msd["X"], msd["centers"], msd["spec"]
    n, d = X.shape
    M = C.shape[0]
    Xq, Cq = X.to(bf), C.to(bf)
    u = torch.randn(M, generator=torch.Generator(device=DEVICE).manual_seed(12), device=DEVICE)
    ops = get_ops("cuda", msd["kernel"], precision="bf16")
    old = os.environ.get("REPRO_SWEEP_BUDGET_MB")
    os.environ["REPRO_SWEEP_BUDGET_MB"] = str(MSD_SHARD_BUDGET_MB)
    try:
        plan = ops.plan(n, M, d)
        check(plan.path == "j_sharded" and plan.compensated and plan.vector_dtype == "bfloat16",
              f"forced bf16 plan {plan}")
        sweep = lambda: ops.sweep(Xq, Cq, u)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", SweepPlanWarning)
            km.reset_launch_counts()
            w = sweep()
            torch.cuda.synchronize()
            variants = km.variant_launch_counts()
            again = torch.equal(w, sweep())
            ms = time_cuda(torch, sweep, 3)
    finally:
        if old is None:
            os.environ.pop("REPRO_SWEEP_BUDGET_MB")
        else:
            os.environ["REPRO_SWEEP_BUDGET_MB"] = old
    shards = -(-M // plan.shard_m)
    chunks = -(-n // km.SHARD_ROW_CHUNK)
    say(f"[bf16] MillionSongs-shape sweep n={n} M={M} d={d} on B4 ({plan.path}, {shards} shards "
        f"of {plan.shard_m}, t {plan.vector_dtype}, w {plan.coeffs_dtype}): launches by build "
        + ", ".join(f"{k} {v}" for k, v in variants.items() if v))
    check(variants["sharded_sweep_bf16c"] == 1
          and variants["kernel_matmul_bf16c"] == 1 + shards * chunks
          and sum(variants.values()) == 2 + shards * chunks,
          f"the forced bf16 sweep's launches {variants}")
    fused = lambda: km.fused_sweep(Xq, Cq, u, spec=spec, compensated=True)
    w1 = fused()
    w64q = km.fused_sweep_plain(Xq.double(), Cq.double(), u.double()[:, None], None,
                                spec=spec)[0][:, 0]
    S = km.fused_sweep_plain(Xq.float(), Cq.float(), u.abs()[:, None], None,
                             spec=spec)[0][:, 0].double()
    w64 = km.fused_sweep_plain(X.double(), C.double(), u.double()[:, None], None,
                               spec=spec)[0][:, 0]
    # t's rounding to bf16 (half a unit, at most 2^-8 |t_i|) moves w_j by at
    # most 2^-8 sum_i K_ij |t_i| <= 2^-8 S_j (K >= 0); each fp32 sum adds
    # PRED_RTOL S_j
    lim4 = (BF16_RTOL / 2 + 2 * PRED_RTOL) * S + 1e-12
    r4 = float(((w.double() - w64q).abs() / lim4).max())
    r1 = float(((w1.double() - w64q).abs() / (PRED_RTOL * S + 1e-12)).max())
    e4 = float((w.double() - w64q).abs().max())
    say(f"[bf16] against a float64 twin on the same bf16 inputs: B4 max abs err {e4:.4e}, "
        f"{r4:.4f} of (2^-8 + {2 * PRED_RTOL:g}) x sum|terms| (t's bf16 rounding; bound 1); B1 "
        f"bf16 {float((w1.double() - w64q).abs().max()):.4e}, {r1:.4f} of {PRED_RTOL:g} x "
        f"sum|terms|; the policy's error against float64 on the unquantized inputs: B4 "
        f"{rel(w, w64):.4e}, B1 {rel(w1, w64):.4e}; B4 two runs bit-equal: {again}")
    check(r4 <= 1.0 and r1 <= 1.0 and again, "a bf16 MillionSongs sweep is off its float64 "
          "twin or B4 is not deterministic")
    ms1 = time_cuda(torch, fused, 3)
    plain = time_cuda(torch, lambda: km.sharded_sweep_plain(
        Xq, Cq, u[:, None], spec=spec, shard_m=plan.shard_m, compensated=True, t_dtype=bf,
        out_dtype=torch.float32), 1, warm=False)
    b, by = bound(n * M * (2 * d + 10 + 4), 2 * (n * d + M * d) + 4 * 2 * M)
    say(f"[bf16] MillionSongs-shape sweep: B4 bf16 {ms:.4f} ms, B1 bf16 {ms1:.4f} ms, "
        f"compensated B4 twin {plain:.4f} ms, bound {b:.4f} ms ({by})")
    return dict(name="sharded_sweep_bf16c", base="sharded_sweep", ms=ms, plain_ms=plain,
                bound_ms=b, bound_by=by, max_abs_err=e4, launches=variants["sharded_sweep_bf16c"],
                shape=f"n={n} M={M} d={d} p=1 shard_m={plan.shard_m} bf16")


def sweep_witness(torch, km, spec, X, C, u, tag: str, kernels=None):
    """Sweep kernels against a float64 twin, entry by entry (gaussian).

    fp32 rounding in w = K^T (K u) scales with S = K^T K |u| (K >= 0), which
    bounds the magnitudes of the terms of both sums: w cancels to far below
    S, and a per-center rounding (of ||c_j||^2, say) moves every term of
    that center together. Each |w_j - w64_j| is held to PRED_RTOL * S_j.
    ``u`` is (M,) or (M, p); ``kernels`` maps a name to a callable giving
    that kernel's w (default: B1). Returns ({name: kernel result}, float32
    twin result)."""
    check(spec.kind == "gaussian", f"sweep witness needs K >= 0, not {spec.kind}")
    if kernels is None:
        kernels = {"B1": lambda: km.fused_sweep(X, C, u, spec=spec)}
    ws = {name: fn() for name, fn in kernels.items()}
    U = u[:, None] if u.ndim == 1 else u
    w32 = km.fused_sweep_plain(X, C, U, None, spec=spec)[0].reshape(u.shape)
    w64 = km.fused_sweep_plain(X.double(), C.double(), U.double(), None,
                               spec=spec)[0].reshape(u.shape)
    S = km.fused_sweep_plain(X, C, U.abs(), None, spec=spec)[0].reshape(u.shape).double()
    limit = PRED_RTOL * S + 1e-12
    rt = float(((w32.double() - w64).abs() / limit).max())
    for name, w in ws.items():
        rk = float(((w.double() - w64).abs() / limit).max())
        say(f"[sweep] {tag} {name}: max|w| {float(w64.abs().max()):.4e}, max S "
            f"{float(S.max()):.4e}; max |w - w64| / ({PRED_RTOL:g} S): kernel {rk:.4f}, "
            f"float32 twin {rt:.4f} (bound 1); max abs err kernel "
            f"{float((w.double() - w64).abs().max()):.4e}, twin "
            f"{float((w32.double() - w64).abs().max()):.4e}")
        check(rk <= 1.0, f"sweep {tag} {name}: off a float64 twin by {rk:.3f} x its limit")
    return ws, w32


def make_msd(torch, seed: int, n: int, n_test: int):
    """The YearPredictionMSD split (463,715 / 51,630 rows, d = 90), made
    synthetic from ``seed`` with the port's MillionSongs task."""
    from repro_torch.data.synthetic import PAPER_TASKS, make_kernel_dataset
    task = PAPER_TASKS["millionsongs"]
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    fg = lambda: torch.Generator(device=DEVICE).manual_seed(seed + 1)
    X, y = make_kernel_dataset(g, task, n, fn_generator=fg())
    Xt, yt = make_kernel_dataset(g, task, n_test, fn_generator=fg())
    return task, X, y, Xt, yt


def host_peak_rss_gib() -> float:
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20   # KiB on Linux


def phase_msd(torch, args):
    """The large-M path at the paper's MillionSongs size: blocked factor on
    B5-B7, the planner's sweep route, a second solve forced onto B4, predict."""
    from repro_torch.core import FalkonConfig, falkon_fit, falkon_solve
    from repro_torch.kernels import kernel_matvec as km
    from repro_torch.ops import FactorPlanWarning, SweepPlanWarning, get_ops, plan_factor
    t0 = time.perf_counter()
    task, X, y, Xt, yt = make_msd(torch, args.seed, MSD_N, MSD_N_TEST)
    torch.cuda.synchronize()
    n, d = X.shape
    M = MSD_CENTERS
    say(f"[msd] MillionSongs-shape data n={n} n_test={Xt.shape[0]} d={d} in "
        f"{time.perf_counter() - t0:.3f} s")
    plan = plan_factor(M)
    nb = -(-M // plan.block)
    say(f"[msd] factor plan: {plan.path}, block {plan.block}, {nb} panels (last "
        f"{M - (nb - 1) * plan.block} wide), device ceiling {plan.device_ceiling_bytes} B, "
        f"dense factor {plan.dense_bytes} B")
    check((plan.path, plan.block, nb) == ("blocked", 1280, 40), f"factor plan {plan}")
    config = FalkonConfig(kernel="gaussian", kernel_params=(("sigma", task.sigma),),
                          lam=task.lam, num_centers=M, iterations=20, ops_impl="cuda",
                          device=DEVICE)
    ops = get_ops("cuda", config.make_kernel())
    splan = ops.plan(n, M, d)
    say(f"[msd] sweep plan: {splan.path} — {splan.reason}")
    # the planner models B1's grid without a card; the launch queries it
    for dd, mm in ((d, M), (18, 10_000)):   # this fit's sweep and the SUSY one
        smem, _ = km.sweep_smem_bytes(mm, 1, dd)
        grid_q = km._sweep_grid(km._pad_p(1), km.KIND_CODES["gaussian"], smem, 0,
                                torch.cuda.current_device())
        model = km.sweep_grid_model(mm, 1, dd)
        say(f"[msd] B1 grid at M={mm} d={dd}: planner's model {model}, occupancy query {grid_q}")
        check(model >= grid_q, "the planner's grid model is below the card's")

    km.reset_launch_counts()
    times: dict = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        est, state = falkon_fit(args.seed, X, y, config, stage_times=times)
    fit_s = time.perf_counter() - t0
    counts = km.launch_counts()
    check(any(isinstance(w.message, FactorPlanWarning) for w in rec),
          "no FactorPlanWarning: the factor did not take the blocked route")
    check(not any(isinstance(w.message, SweepPlanWarning) for w in rec),
          "the planner-route solve left the fused sweep")
    say("[msd] stage seconds: " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items() if isinstance(v, float))
        + f"; fit total {fit_s:.4f}")
    fstats = times["factor_stats"]
    peak = fstats.measured_peak_device_bytes
    say(f"[msd] factor route {times['factor_path']} block {times['factor_block']}; device "
        f"peak during the blocked factorizations {peak} B ({peak / 2**30:.3f} GiB) against "
        f"the plan's ceiling {plan.device_ceiling_bytes} B; peak device memory of the fit "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; host peak RSS "
        f"{host_peak_rss_gib():.3f} GiB")
    say(f"[msd] blocked factor stage: {fstats.bytes_transferred} B moved host<->device; "
        f"{fstats.copy_seconds:.4f} s in copies (with the host gathers of strided "
        f"panels), {fstats.tile_seconds:.4f} s in tile operations (B5-B7 and the "
        f"T T^T products), of the stage's {times['factor']:.4f} s; "
        f"{fstats.panels} panels, {fstats.tiles_updated} trailing updates")
    check((times["factor_path"], times["factor_block"]) == ("blocked", 1280),
          "the fit's factor did not route blocked at 1280")
    check(0 < peak <= plan.device_ceiling_bytes, f"factor device peak {peak} B")
    say(f"[msd] kernel launches in the fit: {counts}")
    want = dict(potrf_tile=2 * nb, trsm_panel=2 * (nb - 1),
                trailing_update=2 * nb * (nb - 1) // 2, pairwise_kernel=1, fused_sweep=47,
                sharded_sweep=0, kernel_matmul=0)
    check(counts == want, f"launch counts {counts} != {want}")

    t1 = time.perf_counter()
    pred = est.predict(Xt)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t1
    res = state.residual_norms.cpu()
    cond = float(state.cond_estimate)
    mse = float(((pred - yt) ** 2).mean())
    var = float(yt.var())
    say("[msd] residual norms: " + " ".join(f"{float(r):.4e}" for r in res))
    say(f"[msd] cond_estimate {cond:.6g}; predict {Xt.shape[0]} rows {predict_s:.4f} s; "
        f"test MSE {mse:.6f}, label variance {var:.6f}, ratio {mse / var:.4f} "
        f"(noise variance {task.noise ** 2:g})")
    check(bool(torch.isfinite(state.alpha).all() and torch.isfinite(pred).all()),
          "non-finite alpha or predictions")
    check(bool(torch.isfinite(res).all()) and float(res[-1]) < float(res[0]),
          "CG residual did not decrease")
    check(mse < var, f"test MSE {mse} not below the label variance {var}")

    # the same solve on the same preconditioner, the sweep forced onto B4
    budget = MSD_SHARD_BUDGET_MB
    old = os.environ.get("REPRO_SWEEP_BUDGET_MB")
    os.environ["REPRO_SWEEP_BUDGET_MB"] = str(budget)
    try:
        jplan = ops.plan(n, M, d)
        check(jplan.path == "j_sharded", f"forced plan {jplan}")
        km.reset_launch_counts()
        t1 = time.perf_counter()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            st2 = falkon_solve(X, y, est.centers, state.precond, est.kernel, task.lam, 20,
                               ops=ops)
        torch.cuda.synchronize()
        solve2_s = time.perf_counter() - t1
        jcounts = km.launch_counts()
    finally:
        if old is None:
            os.environ.pop("REPRO_SWEEP_BUDGET_MB")
        else:
            os.environ["REPRO_SWEEP_BUDGET_MB"] = old
    shards = -(-M // jplan.shard_m)
    check(any(isinstance(w.message, SweepPlanWarning) and w.message.plan.path == "j_sharded"
              for w in rec), "the forced solve did not warn j_sharded")
    say(f"[msd] forced j_sharded solve (REPRO_SWEEP_BUDGET_MB={budget}: {shards} shards of "
        f"{jplan.shard_m}): {solve2_s:.4f} s, launches {jcounts}")
    chunks = -(-n // km.SHARD_ROW_CHUNK)
    jwant = dict(sharded_sweep=47, kernel_matmul=47 * (1 + shards * chunks), fused_sweep=0)
    check(all(jcounts[k] == v for k, v in jwant.items()), f"forced launches {jcounts}")
    # The yardstick: the same solve on the plain float32 "torch" backend. At
    # lam = 1e-6 alpha = T^-1 A^-1 beta, and T (cond ~ sqrt(cond K_MM)) turns
    # fp32 rounding of the sweeps into large differences of alpha along the
    # near-null directions of K_MM; B4 must stand no farther from B1 than a
    # second correct fp32 sweep does.
    t1 = time.perf_counter()
    st3 = falkon_solve(X, y, est.centers, state.precond, est.kernel, task.lam, 20,
                       ops=get_ops("torch", est.kernel))
    torch.cuda.synchronize()
    solve3_s = time.perf_counter() - t1
    pred2 = km.kernel_matmul(Xt, est.centers, st2.alpha, spec=est.kernel.spec)
    pred3 = km.kernel_matmul(Xt, est.centers, st3.alpha, spec=est.kernel.spec)
    ra, rp, rb = rel(st2.alpha, state.alpha), rel(pred2, pred), rel(st2.beta, state.beta)
    ya, yp, yb = rel(st3.alpha, state.alpha), rel(pred3, pred), rel(st3.beta, state.beta)
    say(f"[msd] residuals of the j_sharded solve: "
        + " ".join(f"{float(r):.4e}" for r in st2.residual_norms.cpu()))
    say(f"[msd] plain float32 torch-backend solve on the same preconditioner: "
        f"{solve3_s:.4f} s")
    say(f"[msd] distance from the planner-route (B1) solve, j_sharded (B4) vs plain "
        f"float32: alpha {ra:.3e} vs {ya:.3e}, beta {rb:.3e} vs {yb:.3e}, predictions "
        f"{rp:.3e} vs {yp:.3e} (bound {AGREE_FACTOR:g}x the plain solve's)")
    # how far fp32 rounding alone moves the test MSE at lam = 1e-6: three
    # correct float32 solves on one preconditioner, each summing in its order
    say(f"[msd] test MSE on one preconditioner: B1 solve {mse:.6f}, B4 solve "
        f"{float(((pred2 - yt) ** 2).mean()):.6f}, plain float32 solve "
        f"{float(((pred3 - yt) ** 2).mean()):.6f}")
    check(ra <= AGREE_FACTOR * ya and rp <= AGREE_FACTOR * yp,
          "the j_sharded solve stands farther from the planner-route solve than "
          f"{AGREE_FACTOR:g}x a plain float32 solve does")

    for ns, ds, ms in SMALL_BLOCKED:
        small_blocked_fit(torch, args.seed, ns, ds, ms)
    return dict(X=X, centers=est.centers, spec=est.kernel.spec, kernel=est.kernel, counts=counts,
                jcounts=jcounts, shard_m=jplan.shard_m, plan=plan, fit_s=fit_s,
                factor_s=times["factor"], T=state.precond.T, A=state.precond.A,
                lam=task.lam)


def small_blocked_fit(torch, seed: int, n: int, d: int, M: int) -> None:
    """A fit forced onto the blocked factor (``REPRO_FACTOR_BUDGET_MB``)
    against the in-core fit on the card, gaussian sigma = 1, jitter and lam
    1e-3. Alpha of such an fp32 problem moves at the 1e-4 scale with the
    rounding of either route, so alpha is held against a float64 fit: the
    blocked fit no farther from it than 2x the in-core fit; predictions
    within BLOCKED_FIT_TOL of the in-core fit's."""
    from repro_torch.core import FalkonConfig, falkon_fit
    from repro_torch.ops import FactorPlanWarning
    g = np.random.default_rng(seed + 7)
    Xs = torch.tensor(g.standard_normal((n, d)), dtype=torch.float32, device=DEVICE)
    ys = Xs @ torch.tensor(g.standard_normal(d), dtype=torch.float32, device=DEVICE)
    ys = ys + 0.05 * torch.tensor(g.standard_normal(n), dtype=torch.float32, device=DEVICE)
    scfg = FalkonConfig(kernel="gaussian", kernel_params=(("sigma", 1.0),), lam=1e-3,
                        jitter=1e-3, num_centers=M, iterations=30, device=DEVICE)
    est_in, _ = falkon_fit(seed, Xs, ys, scfg)
    os.environ["REPRO_FACTOR_BUDGET_MB"] = "0.2"
    try:
        stimes: dict = {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FactorPlanWarning)
            est_bl, _ = falkon_fit(seed, Xs, ys, scfg, stage_times=stimes)
    finally:
        os.environ.pop("REPRO_FACTOR_BUDGET_MB")
    est_64, _ = falkon_fit(seed, Xs.double(), ys.double(),
                           dataclasses.replace(scfg, dtype="float64", ops_impl="torch"))
    rb, ri = rel(est_bl.alpha, est_64.alpha), rel(est_in.alpha, est_64.alpha)
    ra = rel(est_bl.alpha, est_in.alpha)
    rp = rel(est_bl.predict(Xs[:100]), est_in.predict(Xs[:100]))
    panels = -(-M // stimes["factor_block"])
    say(f"[msd] small forced-blocked fit (n={n} d={d} M={M}, {stimes['factor_path']} block "
        f"{stimes['factor_block']}, {panels} panels) vs in-core: alpha rel {ra:.3e}, "
        f"predictions rel {rp:.3e} (bound {BLOCKED_FIT_TOL:g}); alpha from a float64 fit: "
        f"blocked {rb:.3e}, in-core {ri:.3e} (bound 2x the in-core)")
    check(stimes["factor_path"] == "blocked", f"small fit M={M} did not route blocked")
    check(rp <= BLOCKED_FIT_TOL and rb <= 2 * ri, f"forced-blocked fit M={M} disagrees")


def time_cuda(torch, fn, reps: int, warm: bool = True) -> float:
    """Median milliseconds of ``fn`` over ``reps`` launches (CUDA events),
    after one warm-up call (``warm``; a twin that takes seconds goes
    without)."""
    if warm:
        fn()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / FP32_PEAK, nbytes / HBM_RATE
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def phase_times(torch, main, msd, bf16_rows, path) -> list[dict]:
    from repro_torch.kernels import kernel_matvec as km
    X, Xt, Cc, alpha, spec = main["X"], main["Xt"], main["centers"], main["alpha"], main["spec"]
    n, d = X.shape
    M = Cc.shape[0]
    m = Xt.shape[0]
    g = torch.Generator(device=DEVICE).manual_seed(7)
    u = torch.randn(M, generator=g, device=DEVICE)
    rows = []

    # B1 at the CG sweep's shape: full X, width 1, v=None
    ws, w_ref = sweep_witness(torch, km, spec, X, Cc, u, f"n={n} M={M} (a CG sweep)")
    abs_err, ratio = close_err(ws["B1"], w_ref)
    say(f"[times] full-size sweep vs plain twin: max abs err {abs_err:.3e}, ratio {ratio:.4f}")
    check(ratio <= 1.0, f"full-size sweep disagrees with its twin (ratio {ratio})")
    again = torch.equal(ws["B1"], km.fused_sweep(X, Cc, u, spec=spec))
    say(f"[times] full-size sweep, two runs bit-equal: {again}")
    check(again, "B1 at the SUSY shape is not deterministic")
    breakdown(torch, f"B1 n={n} M={M} d={d}", lambda: km.fused_sweep(X, Cc, u, spec=spec),
              each=True)
    ms = time_cuda(torch, lambda: km.fused_sweep(X, Cc, u, spec=spec), 5)
    plain = time_cuda(torch, lambda: km.fused_sweep_plain(X, Cc, u[:, None], None, spec=spec), 2)
    b, by = bound(n * M * (2 * d + 10 + 4), 4 * (n * d + M * d + 2 * M))
    rows.append(dict(name="fused_sweep", ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                     max_abs_err=abs_err, shape=f"n={n} M={M} d={d} p=1"))

    # B2 at predict's shape. Predictions are O(1) sums of M = 1e4 terms
    # K * alpha with |alpha| far larger (lam = 1e-6): fp32 rounding scales
    # with S = max_i sum_j |K_ij alpha_j| (K >= 0 for the gaussian), not with
    # |prediction|. The kernel is held to PRED_RTOL * S against its float32
    # twin and a float64 twin; that limit must stay under 5% of the largest
    # prediction, so a kernel off by a typical prediction fails.
    out = km.kernel_matmul(Xt, Cc, alpha, spec=spec).double()
    S = float(km.kernel_matmul_plain(Xt, Cc, alpha.abs()[:, None], spec=spec).max())
    ref32 = km.kernel_matmul_plain(Xt, Cc, alpha[:, None], spec=spec)[:, 0].double()
    ref64 = km.kernel_matmul_plain(Xt.double(), Cc.double(), alpha.double()[:, None],
                                   spec=spec)[:, 0]
    limit = PRED_RTOL * S
    top = float(ref64.abs().max())
    abs_err = float((out - ref32).abs().max())
    err64 = float((out - ref64).abs().max())
    twin64 = float((ref32 - ref64).abs().max())
    say(f"[times] predict-shape kernel matmul: max abs err {abs_err:.3e} vs float32 twin, "
        f"{err64:.3e} vs float64 twin (float32 twin vs float64: {twin64:.3e}); limit "
        f"{PRED_RTOL:g} x max sum|terms| {S:.3e} = {limit:.3e}; largest |prediction| {top:.4f}")
    check(limit <= 0.05 * top, f"predict limit {limit:.3e} is not under 5% of the "
          f"largest prediction {top:.4f}")
    check(abs_err <= limit and err64 <= limit,
          f"predict-shape kernel matmul off its twins ({abs_err:.3e}, {err64:.3e} > {limit:.3e})")
    again = torch.equal(out, km.kernel_matmul(Xt, Cc, alpha, spec=spec).double())
    say(f"[times] predict-shape kernel matmul, two runs bit-equal: {again}")
    check(again, "B2 at the predict shape is not deterministic")
    breakdown(torch, f"B2 m={m} n={M} d={d}", lambda: km.kernel_matmul(Xt, Cc, alpha, spec=spec))
    ms = time_cuda(torch, lambda: km.kernel_matmul(Xt, Cc, alpha, spec=spec), 10)
    plain = time_cuda(torch, lambda: km.kernel_matmul_plain(Xt, Cc, alpha[:, None], spec=spec), 3)
    b, by = bound(m * M * (2 * d + 10 + 2), 4 * (m * d + M * d + M + m))
    rows.append(dict(name="kernel_matmul", ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                     max_abs_err=abs_err, shape=f"m={m} n={M} d={d} p=1"))

    rows += width_times(torch, km, main)

    # B3 at a K_nM-cache row block (full route), then at K_MM's shape
    # (symmetric route; the kernels line's entry)
    pairwise_times(torch, km, X[:65_536], Cc, spec, "a K_nM-cache row block")
    rows.append(pairwise_times(torch, km, Cc, Cc, spec, "SUSY's K_MM", plain=True))

    rows += msd_times(torch, msd)
    counts = {**main["counts"], **{k: msd["counts"][k] for k in
                                   ("potrf_tile", "trsm_panel", "trailing_update")},
              "sharded_sweep": msd["jcounts"]["sharded_sweep"]}
    for r in bf16_rows:   # launches from the bf16 fit and the forced bf16 sweep
        counts[r["name"]] = r["launches"]
    # the path fit's: its 20 CG sweeps of width 8 ran as 40 width-4 launches
    # (the one other B1 launch is the width-1 right-hand side, as its check
    # of 41 pins), and its one stacked apply of width 8 as the 2 B2 launches
    counts["fused_sweep_p4"] = counts["fused_sweep_p8"] = path["counts"]["fused_sweep"] - 1
    counts["kernel_matmul_p8"] = path["counts"]["kernel_matmul"]
    kernels = []
    for r in rows + bf16_rows:
        lib = r.get("library_ms")
        base = r.get("base", r["name"])
        say(f"[times] {r['name']:19s} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"launches per run {counts[r['name']]}, library "
            + ("none" if lib is None else f"{lib:.4f} ms ({r['library']})"))
        kernels.append({
            "name": r["name"], "route": "cuda", "source": SOURCES[r["name"]],
            "replaces": REPLACES[base], "launches": counts[r["name"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": lib,
        })
    return kernels


def width_times(torch, km, main) -> list[dict]:
    """B1 at the SUSY sweep shape with a right-hand side of 4 columns (one
    launch) and of 8 (two launches of 4: the lam path's stacked sweep), and
    B2 at the predict shape with 8 columns (the path's one stacked apply),
    each against its float32 twin (the fp32 tolerance of the kernel checks;
    B1 also entry by entry against a float64 twin, ``sweep_witness``) and
    timed beside the twin and the
    bound of its own width: B1 n M (2d + 10 + 4p) operations over X, C, u
    and w read or written once, B2 m n (2d + 10 + 2p)."""
    X, Xt, Cc, spec = main["X"], main["Xt"], main["centers"], main["spec"]
    n, d = X.shape
    M, m = Cc.shape[0], Xt.shape[0]
    g = torch.Generator(device=DEVICE).manual_seed(13)
    rows = []
    for p in (4, 8):
        U = torch.randn(M, p, generator=g, device=DEVICE)
        sweep = lambda: km.fused_sweep(X, Cc, U, spec=spec)
        groups = -(-p // km.MAX_P)
        ws, ref = sweep_witness(torch, km, spec, X, Cc, U,
                                f"n={n} M={M} p={p} ({groups} launch(es))", {"B1": sweep})
        abs_err, ratio = close_err(ws["B1"], ref)
        again = torch.equal(ws["B1"], sweep())
        say(f"[times] B1 n={n} M={M} d={d} p={p} ({groups} launch(es)): vs twin max "
            f"abs err {abs_err:.3e}, ratio {ratio:.4f}; two runs bit-equal: {again}")
        check(ratio <= 1.0 and again, f"B1 at p={p} is off its twin or not deterministic")
        ms = time_cuda(torch, sweep, 5)
        plain = time_cuda(torch, lambda: km.fused_sweep_plain(X, Cc, U, None, spec=spec), 2)
        b, by = bound(n * M * (2 * d + 10 + 4 * p), 4 * (n * d + M * d + 2 * M * p))
        rows.append(dict(name=f"fused_sweep_p{p}", base="fused_sweep", ms=ms, plain_ms=plain,
                         bound_ms=b, bound_by=by, max_abs_err=abs_err,
                         shape=f"n={n} M={M} d={d} p={p}"))
    V = torch.randn(M, 8, generator=g, device=DEVICE)
    mm = lambda: km.kernel_matmul(Xt, Cc, V, spec=spec)
    out = mm()
    ref = km.kernel_matmul_plain(Xt, Cc, V, spec=spec)
    abs_err, ratio = close_err(out, ref)
    again = torch.equal(out, mm())
    say(f"[times] B2 m={m} n={M} d={d} p=8 (2 launches): vs twin max abs err {abs_err:.3e}, "
        f"ratio {ratio:.4f}; two runs bit-equal: {again}")
    check(ratio <= 1.0 and again, "B2 at p=8 is off its twin or not deterministic")
    ms = time_cuda(torch, mm, 10)
    plain = time_cuda(torch, lambda: km.kernel_matmul_plain(Xt, Cc, V, spec=spec), 3)
    b, by = bound(m * M * (2 * d + 10 + 2 * 8), 4 * (m * d + M * d + M * 8 + m * 8))
    rows.append(dict(name="kernel_matmul_p8", base="kernel_matmul", ms=ms, plain_ms=plain,
                     bound_ms=b, bound_by=by, max_abs_err=abs_err,
                     shape=f"m={m} n={M} d={d} p=8"))
    return rows


def pairwise_times(torch, km, A, B, spec, tag: str, plain: bool = False) -> dict:
    """B3 at one of its path's shapes: its device operations (profiled
    first, while no result is held), against its twin (in row chunks, to
    bound the twin's device memory), two runs bit-equal, and its time (CUDA
    events) beside its bound: the store of
    4mn bytes (and the inputs) against m n (2d + 10) flops of the full grid,
    or nbi (nbi + 1) / 2 128 x 128 tiles of (2d + 10) on the symmetric
    route. ``plain`` also times the twin on the whole shape."""
    (m, d), n = A.shape, B.shape[0]
    sym = km.pairwise_symmetric(A, B)
    route = "symmetric" if sym else "full"
    gram = lambda: km.pairwise_kernel(A, B, spec=spec)
    breakdown(torch, f"B3 m={m} n={n} d={d}", gram)
    K = gram()
    diff = top = 0.0
    for r0 in range(0, m, 4096):
        ref = km.pairwise_kernel_plain(A[r0:r0 + 4096], B, spec=spec).double()
        diff = max(diff, float((K[r0:r0 + 4096].double() - ref).abs().max()))
        top = max(top, float(ref.abs().max()))
        del ref
    ratio = diff / (TOL["atol"] + TOL["rtol"] * top)
    again = torch.equal(K, gram())
    del K
    say(f"[times] B3 at {tag} m={m} n={n} d={d} ({route} route): vs twin {diff:.3e} (ratio "
        f"{ratio:.4f}); two runs bit-equal: {again}")
    check(ratio <= 1.0 and again, f"B3 at {tag} is off its twin or not deterministic")
    ms = time_cuda(torch, gram, 10)
    entries = km.pairwise_tiles(m, n, True) * km.SWEEP_BM * km.SWEEP_BN if sym else m * n
    b, by = bound(entries * (2 * d + 10), 4 * (m * n + (m if sym else m + n) * d))
    plain_ms = time_cuda(torch, lambda: km.pairwise_kernel_plain(A, B, spec=spec), 3) if plain \
        else None
    say(f"[times] B3 at {tag} m={m} n={n} d={d}: kernel {ms:.4f} ms, bound {b:.4f} ms ({by}; "
        f"{entries} entries evaluated)" + ("" if plain_ms is None else f", plain {plain_ms:.4f} ms"))
    return dict(name="pairwise_kernel", ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                max_abs_err=diff, shape=f"m={m} n={n} d={d} {route}")


def msd_times(torch, msd) -> list[dict]:
    """B1 and B4 at the MillionSongs sweep shape (against float32 and float64
    twins), and B5-B7 at the blocked factor's largest shapes (b = 1280, the
    first panel's 48720 rows), each beside its plain twin and its library
    call."""
    from repro_torch.kernels import blocked_cholesky as bc
    from repro_torch.kernels import kernel_matvec as km
    X, C, spec, shard = msd["X"], msd["centers"], msd["spec"], msd["shard_m"]
    n, d = X.shape
    M = C.shape[0]
    u = torch.randn(M, generator=torch.Generator(device=DEVICE).manual_seed(8), device=DEVICE)
    rows = []
    fused = lambda: km.fused_sweep(X, C, u, spec=spec)
    sharded = lambda: km.sharded_sweep(X, C, u, spec=spec, shard_m=shard)
    ws, w32 = sweep_witness(torch, km, spec, X, C, u, f"n={n} M={M} d={d} (MillionSongs)",
                            kernels={"B1": fused, f"B4 shard_m={shard}": sharded})
    w1, w4 = ws["B1"], ws[f"B4 shard_m={shard}"]
    e1, r1 = close_err(w1, w32)
    e4, r4 = close_err(w4, w32)
    say(f"[times] MillionSongs sweeps vs float32 twin: B1 {e1:.3e} (ratio {r1:.4f}), "
        f"B4 {e4:.3e} (ratio {r4:.4f}); B4 vs B1 {close_err(w4, w1)[0]:.3e}")
    check(max(r1, r4) <= 1.0, "MillionSongs sweep off its twin")
    b, by = bound(n * M * (2 * d + 10 + 4), 4 * (n * d + M * d + 2 * M))
    breakdown(torch, f"B1 n={n} M={M} d={d}", fused, each=True)
    ms1 = time_cuda(torch, fused, 3)
    ms4 = time_cuda(torch, sharded, 3)
    plain4 = time_cuda(torch, lambda: km.sharded_sweep_plain(X, C, u[:, None], spec=spec,
                                                             shard_m=shard), 1)
    say(f"[times] MillionSongs sweep n={n} M={M} d={d}: B1 {ms1:.4f} ms, B4 "
        f"({-(-M // shard)} shards of {shard}) {ms4:.4f} ms, bound {b:.4f} ms ({by})")
    rows.append(dict(name="sharded_sweep", ms=ms4, plain_ms=plain4, bound_ms=b, bound_by=by,
                     max_abs_err=e4, shape=f"n={n} M={M} d={d} p=1 shard_m={shard}"))
    matmul_transposed(torch, km, X, C, spec, shard)
    pairwise_times(torch, km, C, C, spec, "MillionSongs' K_MM")

    factor_witness(torch, msd)

    g = np.random.default_rng(9)
    blk = msd["plan"].block
    r = M - blk

    def randn(*shape):
        return torch.tensor(g.standard_normal(shape), dtype=torch.float32, device=DEVICE)

    A = randn(blk, blk)
    A = A @ A.T / blk + torch.eye(blk, device=DEVICE)
    L = bc.potrf_tile(A)
    e5 = float((L - bc.potrf_plain(A)).abs().max())
    breakdown(torch, f"B5 b={blk}", lambda: bc.potrf_tile(A))
    b5, by5 = bound(blk ** 3 / 3, 4 * 2 * blk * blk)
    rows.append(dict(name="potrf_tile", ms=time_cuda(torch, lambda: bc.potrf_tile(A), 10),
                     plain_ms=time_cuda(torch, lambda: bc.potrf_plain(A), 2),
                     library_ms=time_cuda(torch, lambda: torch.linalg.cholesky(A), 10),
                     library="torch.linalg.cholesky", bound_ms=b5, bound_by=by5,
                     max_abs_err=e5, shape=f"b={blk}"))
    # B6 and B7 at the first panel's shapes, held like the tiles in phase 4
    P = randn(r, blk)
    X6, X6p = bc.trsm_panel(L, P), bc.trsm_plain(L, P)
    e6, n6 = float((X6 - X6p).abs().max()), rel(X6, X6p)
    same6 = torch.equal(X6, bc.trsm_panel(L, P))
    del X6, X6p
    breakdown(torch, f"B6 r={r} b={blk}", lambda: bc.trsm_panel(L, P), each=True)
    b6, by6 = bound(r * blk * blk, 4 * (blk * blk + 2 * r * blk))
    rows.append(dict(name="trsm_panel", ms=time_cuda(torch, lambda: bc.trsm_panel(L, P), 5),
                     plain_ms=time_cuda(torch, lambda: bc.trsm_plain(L, P), 1),
                     library_ms=time_cuda(torch, lambda: torch.linalg.solve_triangular(
                         L.mT, P, upper=True, left=False), 5),
                     library="torch.linalg.solve_triangular", bound_ms=b6, bound_by=by6,
                     max_abs_err=e6, shape=f"r={r} b={blk}"))
    Cu, Pu, Qu = randn(r, blk), randn(r, blk), randn(blk, blk)
    O7, O7p = bc.trailing_update(Cu, Pu, Qu), bc.update_plain(Cu, Pu, Qu)
    e7, n7 = float((O7 - O7p).abs().max()), rel(O7, O7p)
    del O7, O7p
    say(f"[times] B6 r={r} b={blk} vs twin {n6:.3e} (two runs bit-equal: {same6}), B7 "
        f"r={r} b=k={blk} vs twin {n7:.3e} (normwise, bound {FACTOR_TOL:g})")
    check(n6 <= FACTOR_TOL and n7 <= FACTOR_TOL and same6,
          f"B6/B7 off their twins at r={r} b={blk}, or B6 not deterministic")
    b7, by7 = bound(2 * r * blk * blk, 4 * (2 * r * blk + r * blk + blk * blk))
    rows.append(dict(name="trailing_update",
                     ms=time_cuda(torch, lambda: bc.trailing_update(Cu, Pu, Qu), 5),
                     plain_ms=time_cuda(torch, lambda: bc.update_plain(Cu, Pu, Qu), 5),
                     library_ms=time_cuda(torch, lambda: torch.addmm(Cu, Pu, Qu.mT, alpha=-1), 5),
                     library="torch.addmm", bound_ms=b7, bound_by=by7, max_abs_err=e7,
                     shape=f"r={r} b={blk} k={blk}"))
    return rows


def matmul_transposed(torch, km, X, C, spec, shard: int) -> None:
    """B2 at one launch of B4's transposed pass (C's first shard against X's
    first SHARD_ROW_CHUNK rows, ``add=``): against its twin, bit-equal over
    two runs, its device operations, and its time beside its bound."""
    Cj, Xr = C[:shard], X[:km.SHARD_ROW_CHUNK]
    m, n, d = Cj.shape[0], Xr.shape[0], X.shape[1]
    g = torch.Generator(device=DEVICE).manual_seed(10)
    t = torch.randn(n, 1, generator=g, device=DEVICE)
    w = torch.randn(m, 1, generator=g, device=DEVICE)
    mm = lambda: km.kernel_matmul(Cj, Xr, t, w, spec=spec)
    got = mm()
    abs_err, ratio = close_err(got, km.kernel_matmul_plain(Cj, Xr, t, w, spec=spec))
    again = torch.equal(got, mm())
    S = km._lib().rt_matmul_slices(m, n, km._matmul_slots(1, km.KIND_CODES[spec.kind], d, 0,
                                                          torch.cuda.current_device())[1])
    say(f"[times] B2 at B4's transposed shape m={m} n={n} d={d} ({S} slices): vs twin "
        f"{abs_err:.3e} (ratio {ratio:.4f}); two runs bit-equal: {again}")
    check(ratio <= 1.0 and again, "B2 at B4's transposed shape is off its twin or not "
          "deterministic")
    breakdown(torch, f"B2 m={m} n={n} d={d}", mm, each=True)
    ms = time_cuda(torch, mm, 10)
    b, by = bound(m * n * (2 * d + 10 + 2), 4 * (m * d + n * d + n + 2 * m))
    say(f"[times] B2 at B4's transposed shape m={m} n={n} d={d}: kernel {ms:.4f} ms, bound "
        f"{b:.4f} ms ({by}); {-(-C.shape[0] // m)} shards x {-(-X.shape[0] // n)} such launches "
        "a sweep")


def breakdown(torch, tag: str, fn, each: bool = False) -> None:
    """One call's device operations, by name, with their summed device time
    (``torch.profiler``): a blocked schedule's launches; ``each`` also lists
    every launch's time in launch order. The profiler has returned no
    device operation for a whole call (B3 at MillionSongs' K_MM; B2 at the
    predict shape) and dropped a call's first one at times: after minutes
    of float64 work on the card its device timestamps stood 0.5 to 2 s off
    its window on the host's clock, and it drops what falls outside (a
    probe on the H100: 2 of 12 profiles of B2 and B3 kept at pads up to
    0.5 s, 12 of 12 at 2 s). So each profile records one call after a
    warm-up step of its own (a ``schedule`` of one warm-up and one active
    step), the active step idles PROFILE_PAD seconds before and after the
    call, and an empty profile is taken again with the pad doubled, up to
    five times in all."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        pad = PROFILE_PAD * 2 ** attempt
        if attempt:
            say(f"[times] {tag}: the profile came back empty; again with {pad:g} s pads")
        held: dict = {}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: held.update(events=list(p.events()))) as prof:
            for step in range(2):
                time.sleep(pad * step)
                fn()
                torch.cuda.synchronize()
                time.sleep(pad * step)
                prof.step()
        events = [e for e in held.get("events", [])   # not the step's own span
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith("ProfilerStep")]
        if events:
            break
    ops: dict[str, list] = {}
    for e in sorted(events, key=lambda e: e.time_range.start):
        name = e.name.split("(")[0].removeprefix("void ")
        ops.setdefault(name, []).append(e.time_range.elapsed_us())
    total = sum(len(us) for us in ops.values())
    say(f"[times] {tag}: {total} device operations in one call: "
        + ", ".join(f"{name} {len(us)} ({sum(us):.1f} us)" for name, us in ops.items()))
    if each:
        for name, us in ops.items():
            say(f"[times] {tag}: {name} launch by launch (us): "
                + " ".join(f"{u:.1f}" for u in us))
    check(total > 0, f"the profiler saw no device operation of {tag}")


def rel_rows(a, b, rows: int = 2048) -> float:
    """``rel`` of two large matrices, in float64 row chunks."""
    num = den = 0.0
    for i in range(0, b.shape[0], rows):
        bi = b[i:i + rows].double()
        num += float((a[i:i + rows].double() - bi).norm() ** 2)
        den += float(bi.norm() ** 2)
    return (num / max(den, 1e-300)) ** 0.5


def factor_witness(torch, msd) -> None:
    """The MillionSongs fit's blocked factors against in-core factors of the
    same matrices. T: the jittered K_MM (D = I for uniform centers) factored
    by ``torch.linalg.cholesky_ex`` in float32 (timed: the route the factor
    budget keeps this fit off) and in float64. A: T T^T / M + lam I, from
    the fit's own T, likewise. Each blocked factor may stand at most
    FACTOR_AGREE x as far from the float64 factor as the float32 library
    factor does. Device memory peaks near 70 GB (T and A stay on the card)."""
    from repro_torch.kernels import kernel_matvec as km
    C, spec, T, A = msd["centers"], msd["spec"], msd.pop("T"), msd.pop("A")
    M = C.shape[0]
    K = km.pairwise_kernel(C, C, spec=spec)
    K.diagonal().add_(float(torch.finfo(torch.float32).eps) * M)
    held = {}

    def chol32():
        held["L"], held["info"] = torch.linalg.cholesky_ex(K)

    chol_ms = time_cuda(torch, chol32, 1)
    L32 = held.pop("L")
    check(int(held.pop("info")) == 0, "in-core float32 cholesky of K_MM failed")
    K64 = K.double()
    del K
    L64, info = torch.linalg.cholesky_ex(K64)
    del K64
    check(int(info) == 0, "float64 cholesky of K_MM failed")
    tb, tl, td = rel_rows(T, L64.mT), rel_rows(L32.mT, L64.mT), rel_rows(T, L32.mT)
    del L32, L64
    say(f"[times] in-core torch.linalg.cholesky of the jittered K_MM (M={M}): {chol_ms:.4f} ms; "
        f"the blocked factor stage took {msd['factor_s']:.4f} s for two factorizations "
        "and T T^T")
    # A from the fit's T: float64 first, then float32 through cuBLAS and
    # cuSOLVER (TF32 off); one (M, M) float64 and two float32 matrices at most
    lam = msd["lam"]
    T64 = T.double()
    S = T64 @ T64.mT
    del T64
    S /= M
    S.diagonal().add_(lam)
    A64, info = torch.linalg.cholesky_ex(S)
    del S
    check(int(info) == 0, "float64 cholesky of T T^T / M + lam I failed")
    S32 = T @ T.mT
    S32 /= M
    S32.diagonal().add_(lam)
    A32, info = torch.linalg.cholesky_ex(S32)
    del S32
    check(int(info) == 0, "float32 cholesky of T T^T / M + lam I failed")
    ab, al, ad = rel_rows(A, A64.mT), rel_rows(A32.mT, A64.mT), rel_rows(A, A32.mT)
    del A32, A64
    say(f"[times] MillionSongs factors, normwise distance from float64 factors of the same "
        f"matrices: T blocked {tb:.3e}, cuSOLVER float32 {tl:.3e} (blocked vs cuSOLVER "
        f"{td:.3e}); A blocked {ab:.3e}, cuSOLVER float32 {al:.3e} (blocked vs cuSOLVER "
        f"{ad:.3e}); bound {FACTOR_AGREE:g}x the cuSOLVER factor's")
    check(tb <= FACTOR_AGREE * tl and ab <= FACTOR_AGREE * al,
          "a blocked MillionSongs factor stands farther from float64 than "
          f"{FACTOR_AGREE:g}x the in-core float32 factor")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=4_000_000, help="training rows (SUSY: 4e6)")
    ap.add_argument("--n-test", type=int, default=500_000, help="rows to predict")
    ap.add_argument("--checks-only", action="store_true",
                    help="build and run the kernel checks only; prints no result line")
    args = ap.parse_args(argv)
    try:
        import torch
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run from the repository root",
              file=sys.stderr)
        return 3
    t_start = time.perf_counter()
    card = phase_device(torch)
    build_s = phase_build()
    phase_kernels(torch)
    phase_compensated(torch)
    phase_blocked(torch)
    if args.checks_only:
        say(f"[done] checks only, {time.perf_counter() - t_start:.1f} s")
        return 0
    main_res = phase_main(torch, args)
    say(f"[time] {time.perf_counter() - t_start:.1f} s after the SUSY phase")
    path_res = phase_path(torch, args, main_res)
    say(f"[time] {time.perf_counter() - t_start:.1f} s after the lam-path phase")
    bf16_rows = phase_bf16(torch, args, main_res)
    say(f"[time] {time.perf_counter() - t_start:.1f} s after the bf16 SUSY phase")
    msd_res = phase_msd(torch, args)
    bf16_rows.append(msd_bf16_sweep(torch, msd_res))
    say(f"[time] {time.perf_counter() - t_start:.1f} s after the MillionSongs phase")
    kernels = phase_times(torch, main_res, msd_res, bf16_rows, path_res)
    say(f"[done] {time.perf_counter() - t_start:.1f} s in all, {build_s:.1f} s of it the build")
    say(f"card: {card}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                          "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
