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
   compensated — the compensated builds of B1, B2 and B4 (bf16, float16
               and fp32: the bf16 policy's, a float16 policy's and the
               reference's compensated=True fp32 case) against their
               compensated twins, for the five kinds, n, M in 1, 127, 128,
               129, d in 1, 18, 90, 129, p = 1..5 (u at fp32 or at the
               build's type in turn; 16-bit u gives B1 a 16-bit output):
               B1 with v, without v, under row_mask (masked rows bit-equal
               to the valid prefix); B2 with and without add, fp32 and
               16-bit out, unsplit and most-split; B4 with its t spilled in
               16 bits (masked rows bit-equal to the prefix); B1 with its w
               partial and carry in global memory; every build's plans
               against their mirrors.
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
   f16      — a float16 policy (storage float16, compensated) as bf16:
               the float16 builds of B1 and B2 against float64 twins, and
               the full-size fit beside the fp32 and bf16 fits (47 f16c B1).
   cache    — the K_nM cache at SUSY's full width on the first 10^6 rows:
               the device-tier cached fit (knm_cache="device": 489 + 1 B3,
               0 B1 launches, 47 GEMM sweeps at the facade) against the
               uncached fit on the same rows and centers (test error within
               0.002, alpha within the path's bound), materialize and solve
               seconds, device peak; one cached sweep against B1 (IEEE fp32
               asserted, a TF32 setting refused), timed beside it and
               profiled; the bf16 cache's sweep and fit; "auto" at the
               reference's default budgets ("off", warned, the uncached fit
               bit for bit); cached vs uncached at n = 20,000, M = 500,
               lam = 1e-3; the host tier on 131,072 rows against the device
               tier; a scoring cache over the test rows against B2's
               predict; B3 at one 2048-row cache tile for the kernels line.
   stream   — the host-streamed fits at SUSY's full size, X, y and the
               test rows as host numpy in chunks of 2^18 rows (16 chunks,
               the last padded and masked): the fp32 fit on the main fit's
               centers (21 passes: 336 B1, 1 B3, 0 B4 launches, every chunk
               sweep at X (262,144, 18)) and ``predict_stream`` (2 B2), test
               error within 0.002 of the main fit's; one streamed sweep
               against a float64 twin, bit-equal at prefetch 2 and 0 over
               two runs each; a full chunk without a mask bit-equal to one
               with a ones mask; n = 20,000, M = 500, lam = 1e-3 streamed
               against in-core predictions (1e-3); the device peaks of two
               fits drawing their own centers at n = 10^6 and 4x10^6 (64 MiB
               apart at most, below the in-core fit's); the bf16 fit (bf16
               chunks; its test error beside the in-core bf16 fit's and an
               in-core solve's on rolled rows: at lam = 1e-6 the order of
               the sums alone moves it past 0.002), X in one chunk solved
               bit-equal to the in-core solve, fp32 and bf16, and the
               n = 20,000 bf16 fit against in-core (1e-2); the 8-lam path
               (every lam within 0.002 of the in-core path's); the
               streamed solve beside the in-core one, prefetch 2 beside 0,
               chunks of 2^15 beside 2^18, the loader alone; B1 at the
               chunk shape for the kernels line.
   minibatch — mini-batch fits and the coalescing server on the main
               fit's data, centers and configuration: the in-core fit at
               the default ``MinibatchConfig`` (chunks of 2048, a
               projection every 4, 2 epochs: exactly 8 + 3912 B1, 1 B3, 0
               B4 launches, 978 projections, 8,028,160 rows swept; stage
               seconds with the solve split into steps and projections,
               device peak, finite falling gradient norms, test error below
               the majority class's); the same fit streamed from host numpy
               in chunks of 2048 (3916 B1) bit-equal to in-core with
               shuffle=False; ``partial_fit`` of the main estimator on
               5x10^5 fresh rows (the centers' storage shared, alpha's
               geometry kept); ``CoalescingPredictServer(max_batch=256)``
               over 2,000 ragged requests: 6 graphs captured at warmup (12
               B2 launches), none after 4 + 2 flushes and a
               ``swap_model``, no B2 launch from Python while serving, every
               request bit-equal to ``predict`` of it alone before and
               after the swap, requests/s, rows/s and dispatch p50/p99
               beside the per-request loop; the 8-lam path served stacked
               (24 B2 launches at warmup) against each estimator; a scoring
               cache against B2, refused after a swap; at n = 20,000,
               M = 500, lam = 1e-3 the "cuda" and "torch" backends' solves
               and a float64 one, and the full-batch fixed point; B1 at the
               chunk and B2 at rungs 8 and 256 (and their graphs' replays)
               for the kernels line.
   mesh     — multi-device fits (``FalkonConfig(mesh=...)``, A14) on the
               one card, each rank a process of this script started with
               ``--mesh-worker`` once the library is built (a rank that finds
               none stops; no rank compiles): a world of one NCCL rank runs
               the SUSY fit bit-equal to the main fit (47 all-reduces, 47
               B1 launches); then 4 gloo ranks sharing the card run the
               SUSY fit at full size (47 all-reduces of 10^4 floats, 47 B1
               launches of 10^6 rows a rank, alpha bit-equal on every rank,
               predictions and test error against the main fit's), the
               ragged sweep (4x10^6 - 3 rows: junk rows under a mask
               bit-equal to the internal zero padding), ``apply`` bit-equal
               to the wrapped backend's, the int8 wire, and the 8-lam path,
               the streamed fit, the device-tier cached fit (n = 10^6) and
               the default mini-batch fit (n = 2.5x10^5) against the same
               fits on one device run first in this process (predictions,
               test errors, facade counts, one all-reduce a sweep); stage
               seconds, the all-reduce time and each rank's device peak.
               A world past 300 s or a failed rank fails the smoke.
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
   lm       — the LM serving path (A15.1) at gemma3-1b's full width (26
               layers, d_model 1152, 4 query heads padded to 16 over 1 KV
               head, d_head 256, d_ff 6912, vocab 262,144, window 512;
               random weights on the card from --seed): (a) in fp32, B = 2
               rows of 1,040 tokens: ``forward`` over all of them,
               ``prefill`` of the first 1,024 (past the window) into a
               cache of 1,040 and 16 ``decode_step``s, the prefill logits
               against the forward's at position 1,023 (2e-3) and each step
               against its position (5e-3), the reference test's bounds;
               (b) in fp32, B = 1, S = 4,096 > dense_attn_max_seq = 2,048:
               the chunked attention (2 query blocks x 4 KV chunks of 1,024,
               whole chunks masked in every sliding layer) against the same
               forward under dense_attn_max_seq = 4,096 (LM_CHUNK_TOL);
               (c) bf16, the config's own dtype: ``serve_lm`` (batch 4,
               prompt 1,024, 32 generated), its prefill ms, decode ms per
               token and device peak; (d) the FALKON head on that bf16
               model's frozen features: 16 batches of the synthetic token
               stream (vocab 512, 8 x 512 tokens, seed 7) through
               ``_backbone``, 65,536 rows of 1,152 features in fp32, target
               ``tokens % 8`` one-hot, 52,428 rows to fit and 13,108 to
               score; ``falkon_fit`` (gaussian, sigma the median pairwise
               distance of 4,096 training rows, lam = 1e-6, t = 15,
               M = 4,096, "cuda") and ``predict``: accuracy above the
               majority class by 10 standard errors (the example's 0.2
               printed beside it: random weights miss it), and
               the launch counts of serve + features + fit + predict (the
               counts zeroed before it): B3 1, B1 (1 + t) x 2 + 26 = 58,
               B2 2; the same fit on the "torch" backend (plain versions on
               the card, the same centers) within LM_HEAD_PRED_TOL; B1 at
               the head's sweep shape (52,428 x 4,096, d = 1,152 > 128:
               X staged again per tile, p = 8) against float32 and float64
               twins, B2 at its predict shape and B3 at its K_MM, timed for
               the kernels line.
   train    — LM training (A15.2): (a) examples/train_lm_falkon_head.py's
               recipe on the card: its ``make_lm(256, 4, 512)`` in fp32,
               ``TrainConfig(3e-4, warmup 20, total 200)``, a ``Trainer`` on
               a temporary directory (async saves every 100 steps), 200
               steps of 8 x 128 token-stream batches: the last loss below
               the first, the step ms, straggler events, the codec written;
               a second ``Trainer`` on the directory resumes at step 200
               with every leaf of the state bit-equal; the head on 8
               batches (seed 7) of its ``_backbone`` features (gaussian
               sigma 4, lam 1e-6, M = 512, t = 15, "cuda"): accuracy above
               the example's 0.2, exactly 1 B3, (1 + t) x 2 + 26 = 58 B1 and
               2 B2 launches over training + features + fit + predict (the
               counts zeroed before training), the same fit on "torch"
               within LM_HEAD_PRED_TOL, and B1 (d = 256 > 128), B2 and B3 at
               its shapes for the kernels line; (b) gemma3-1b at full width
               in its own bf16 with AdamW and remat="full": 5 steps on one
               fixed batch of 4 x 1,024 tokens (halved while it does not
               fit), warmup 1: loss, grad norm, step ms, tokens/s and the
               device peak; the loss finite and falling; then one step with
               microbatch=2 against one with microbatch=1 from the same
               state (GEMMA_MB_LOSS_RTOL, GEMMA_MB_PARAM_REL); one profiled
               step's device operations by kind and its idle share, and the
               forward + backward and one AdamW update timed alone. Training
               runs plain torch ops: no kernel of the port.
   shard    — the sharding rules (A15.3) on one NCCL rank, a (1, 1)
               ("data", "model") DeviceMesh: (a) gemma3-1b at full width,
               bf16 AdamW under remat, SHARD_STEPS steps on 4 x 1,024 tokens
               through Trainer(mesh=, rules=AxisRules(mesh)) from the state
               of as many unsharded steps: losses and parameters after the
               last step bit-equal (every placement on a (1, 1) mesh is
               Replicate()), step ms and device peaks side by side; a
               blocking save, restored onto a (1, 1, 1) ("pod", "data",
               "model") mesh leaf for leaf bit-equal, and the next step's
               loss there equal to the uninterrupted one's; (b)
               granite-moe-3b-a800m at full width (48 experts, top-8), one
               forward and backward under two-level checkpointing against
               one-level remat (bit-equal; both device peaks), then under
               the mesh's rules through the expert-parallel MoE (its
               all_to_alls over the one-rank "model" group) against the
               local MoE (loss and expert gradients bit-equal); (c) a world
               of SHARD_WORLD NCCL ranks on the one card (beside (a)'s
               save and restore), reported. Plain
               torch ops and DTensor: no kernel of the port.
   dryrun   — the dry-run and roofline tools (A15.4): (a) ``python -m
               repro_torch.launch.dryrun`` for gemma3-1b at train_4k,
               prefill_32k and decode_32k on the single-pod mesh and for the
               FALKON solver cell, each its own process, all started
               together, on the card's torch (a fake world of 256 ranks, meta
               tensors, counted on rank 0): each cell's flops, bytes and
               collective bytes per device, memory, fits_hbm, bottleneck and
               seconds; a status other than "ok" fails; meanwhile on the card
               (b) gemma3-1b's train step as train (b) runs it, counted once by
               ``op_cost.analyze`` and then timed over DRYRUN_STEPS steps:
               max(compute, memory) of the count at most the measured step,
               the useful flops ratio in (0, 1], the counted peak within
               DRYRUN_MEM_BAND of ``max_memory_allocated``; (c) the FALKON
               cell at SUSY's shape on one rank (the "torch" backend's plain
               ops): its compute term at most the main fit's solve (47 B1
               launches), its memory term printed beside it; at
               DRYRUN_SMALL_N rows the cell's bound at most the same solve
               timed on the card on the "torch" backend.
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
               the bf16 B4 sweep; the float16 builds of B1 and B2 likewise,
               from the float16 fit; B3 at a K_nM-cache tile, its launches
               from the cached fit; B1 at p = 4 and 8 and B2 at p = 8 as
               entries of their own, their launches from the path fit; B1
               at a streamed chunk, 262,144 rows, its launches from the
               streamed fp32 fit; B1 at a mini-batch chunk, 2048 rows, its
               launches from the default mini-batch fit; B2 at the server's
               rungs of 8 and 256 rows, its launches the eager and captured
               ones of the rung's warmup: a served dispatch replays the
               rung's graph and launches nothing from Python; B1, B2 and
               B3 at the LM head's shapes, their launches from the head's
               fit and predict; likewise at the trained example LM's head).

The last line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
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
#: (the bf16 policy's), float16 (a float16 policy's) and fp32 (the
#: reference's compensated=True fp32 case)
COMP_DTYPES = ("bfloat16", "float16", "float32")
#: right-hand-side widths of the compensated checks, one shape each in turn
COMP_WIDTHS = (1, 2, 3, 4, 5)
#: a bf16 result against its twin: both round the same fp32 sum to bf16,
#: which may fall either side of a rounding boundary, so one bf16 unit in
#: the last place (at most 2^-7 of a value: 8 significant bits) of the
#: largest entry is added to the fp32 tolerance; B4's bf16 t spill likewise
#: moves w_j by up to 2^-7 sum_i |K_ij t_i|. A float16 result (11
#: significant bits) likewise, one float16 unit: 2^-10
BF16_RTOL = 2.0 ** -7
F16_RTOL = 2.0 ** -10
#: idle seconds on each side of a profiled call (see ``breakdown``)
PROFILE_PAD = 2.0
#: the bf16 policy's error against float64 on unquantized inputs, as the
#: reference documents it (printed, not held: C.1 measures 1.005e-2)
POLICY_BOUND = 1e-2
#: the streamed fits' chunk height (SUSY: 16 chunks, the last of 67,840
#: rows padded) and the smaller one timed beside it
STREAM_CHUNK = 2**18
STREAM_SMALL_CHUNK = 2**15
#: a streamed fit's test error against the in-core fit's, and its device
#: peak at n = 10^6 against n = 4x10^6
STREAM_ERR = 0.002
STREAM_PEAK_AGREE = 64 * 2**20
#: the fits where rounding is tame: n, M, lam, and the fp32 predictions'
#: bound (bf16: POLICY_BOUND)
STREAM_SMALL = (20_000, 500, 1e-3)
STREAM_PRED_TOL = 1e-3
#: the rows an in-core bf16 solve is rolled by, to show what the order of
#: the sums alone does to its test error
STREAM_ROLL = 786_432
#: the K_nM cache's fits: the first 10^6 SUSY rows on the device tier (a
#: 1,001,472 x 10^4 fp32 K_nM, 4.0e10 B), the first 131,072 on the host tier
#: (64 tiles, 5.24 GB), and the scoring cache over the 5x10^5 test rows
CACHE_N = 1_000_000
CACHE_HOST_N = 131_072
#: the cached fit's test error against the uncached fit's on the same rows
#: and centers (the streamed fit's bound); its alpha and predictions are
#: held against a float64 fit of the same system, no farther than
#: PATH_AGREE x the uncached fit's (at lam = 1e-6 fp32 rounding moves alpha
#: far: C.11; measured on the card, the two fp32 alphas stand 1.138 apart);
#: at lam = 1e-3 (STREAM_SMALL) the cached fit's predictions against the
#: uncached fit's, normwise
CACHE_ERR = 0.002
CACHE_SMALL_PRED_TOL = 1e-4
#: the host tier's alpha against the device tier's on the same rows: the
#: same GEMMs, summed across tiles in the same order
CACHE_HOST_TOL = 1e-5
#: the mini-batch phase: a fresh partial_fit tail of the SUSY task (its rows
#: drawn from seed + MB_TAIL_SEED), the served trace, a scoring cache's rows
MB_TAIL = 500_000
MB_TAIL_SEED = 1000
SERVE_REQUESTS = 2000
SERVE_BATCH = 256
SCORING_ROWS = 16_384
#: the stacked path tier against each estimator's predict: max |diff| over
#: max_i sum_j |K_ij alpha_j| (fp32 sums of M = 10^4 terms)
SERVE_STACK_RTOL = 1e-6
#: n = 20,000, M = 500, lam = 1e-3 mini-batch solves: the backends and
#: float64 (predictions, normwise), and the full-batch fixed point (max
#: |move| over the largest prediction, the reference test's bound)
MB_SMALL_TOL = 1e-3
MB_FIXED_TOL = 1e-3
#: the small partial_fit's move of the predictions (normwise) must exceed
#: this, so that a refresh that returned the deployed alpha fails it
MB_PF_MOVE = 1e-2
#: the mesh phase: ranks of the gloo world sharing the card; the rows of its
#: path, streamed, cached and lam = 1e-3 fits and of its mini-batch fit; a
#: world's time limit (s); a mesh fit's test error against the same fit on
#: one device (the fp32 order of the sums alone moves SUSY's by 0.00057,
#: C.12); its predictions (normwise) against the same fit on one device,
#: ~2x what PR 24's call 2 measured on an NVIDIA H100 80GB HBM3, 700 W
#: (the 4 ranks' sums run in another order, and at SUSY's lam = 1e-6 that
#: order decides alpha, C.11: measured 0.1220 for the full-size fit,
#: 0.1128 streamed, 0.1123 cached, 1.08e-3 mini-batch; 3.81e-4 at the
#: well-posed lam = 1e-3, held inside the reference's 2e-3); the 8-lam
#: path's, lam = 10^-8 up (measured 0.481 0.405 0.279 0.158 0.0843 0.0422
#: 0.0178 0.00652) and its test errors (measured 0.0041 0.0031 0.0019 at
#: the three smallest lams, <= 0.0005 above); the int8 wire's band of
#: relative error (the reference's); the timed all-reduce's repetitions
MESH_RANKS = 4
MESH_N = 1_000_000
MESH_MB_N = 250_000
MESH_TIMEOUT = 300
MESH_ERR = 0.002
MESH_WELL_POSED_LAM = 1e-3
MESH_PRED_TOL = {"susy": 0.25, "stream": 0.25, "cache": 0.25, "minibatch": 3e-3,
                 "lam1e-3": 1e-3}
MESH_PATH_PRED_TOL = (1.0, 0.8, 0.56, 0.32, 0.17, 0.085, 0.036, 0.013)
MESH_PATH_ERR = (0.008, 0.006, 0.004, 0.002, 0.002, 0.002, 0.002, 0.002)
MESH_INT8 = (0.0, 2e-2)
MESH_ALLREDUCE_REPS = 50
LM_ARCH = "gemma3-1b"
LM_TOKENS = (2, 1040, 1024)       # (a): rows, tokens forwarded, tokens prefilled
LM_DECODE_TOL = ((2e-3, 2e-3), (5e-3, 5e-3))   # (rtol, atol): prefill, decode steps
LM_CHUNK_S = 4096
#: (b): chunked vs dense attention over 26 fp32 layers, |diff| <= tol (1 + |dense|)
#: on the logits: both sum in fp32 in other orders (the dense softmax over
#: 4,096 keys, the chunked one in 4 rescaled pieces)
LM_CHUNK_TOL = 1e-3
LM_SERVE = (4, 1024, 32)          # (c): batch, prompt, generated tokens
LM_STREAM = dict(vocab=512, seq_len=512, batch=8)
LM_BATCHES = 16
LM_HEAD = dict(num_centers=4096, lam=1e-6, iterations=15)
LM_SIGMA_ROWS = 4096
#: (d): the example's accuracy bar (chance 0.125), printed beside the
#: reading. It was set for features of a trained LM; those of random weights
#: at gemma3-1b's full depth (26 bf16 layers, the embedding at scale 0.02
#: under O(1) layer outputs) carry less of the current token: 0.1772 on an
#: H100 80GB HBM3 at 700 W (PERF.md §6). The check holds the head to having
#: learned from them: above the test rows' majority-class rate by LM_ACC_SE
#: binomial standard errors.
LM_ACC_EXAMPLE = 0.2
LM_ACC_SE = 10
#: (d): the "torch" backend's predictions against the "cuda" backend's,
#: normwise, same centers: fp32 sums in other orders through a lam = 1e-6
#: solve (a 64-wide CPU head moves 4e-4 at M = 128 and 1.2e-3 at M = 256)
LM_HEAD_PRED_TOL = 5e-2
LM_HEAD_AGREE = 0.98              # share of test rows given the same class
#: train (a): examples/train_lm_falkon_head.py's defaults: make_lm(d_model,
#: layers, vocab) in fp32, TrainConfig(3e-4, warmup 20, total 200), a Trainer
#: checkpointing every 100 steps, token_stream batches of 8 x 128, then a
#: head on 8 batches of seed 7 (gaussian sigma 4, lam 1e-6, M 512, t 15)
TRAIN_LM = (256, 4, 512)
TRAIN_STEPS = 200
TRAIN_CFG = dict(learning_rate=3e-4, warmup_steps=20, total_steps=200)
TRAIN_STREAM = dict(vocab=512, seq_len=128, batch=8)
TRAIN_CKPT_EVERY = 100
TRAIN_HEAD_BATCHES = 8
TRAIN_HEAD = dict(kernel="gaussian", kernel_params=(("sigma", 4.0),), lam=1e-6,
                  num_centers=512, iterations=15)
TRAIN_ACC = 0.2                   # the example's own bar (its line 99)
TRAIN_REF_ACC = 0.654             # the reference example's reading on a CPU
#: train (b): gemma3-1b at full width, its own bf16, AdamW and remat="full":
#: (batch, tokens, steps) on one fixed batch, warmup 1
GEMMA_TRAIN = (4, 1024, 5)
#: (b): one step with microbatch=2 against one with microbatch=1 from the same
#: state (after the 5 steps, under total_steps=100 so that the learning rate
#: is near its peak): the losses (bf16 forwards of 2 rows and of 4 rows sum in
#: other orders) and the parameters' difference relative to the step's change
#: (bf16 rounding of updates near half a unit flips with the gradients' last
#: bits)
GEMMA_MB_LOSS_RTOL = 1e-2
GEMMA_MB_PARAM_REL = 0.25
#: shard (a): gemma3-1b at full width on a (1, 1) ("data", "model") mesh of
#: one NCCL rank: steps through Trainer(mesh=, rules=) from the state of as
#: many unsharded steps, on train (b)'s batch shape. Every spec resolves onto
#: size-1 axes, so every placement is Replicate() and the sharded step runs
#: the unsharded one's ops: losses and parameters bit-equal
SHARD_STEPS = 3
#: shard (b): granite-moe-3b-a800m at full width, one forward and backward
#: of (batch, tokens): the expert-parallel MoE against the local one, the
#: loss and the expert weights' gradients bit-equal (one rank: the same
#: dispatch at capacity ceil(T K cf / E) = int(T K cf / E) = 1024 here, and
#: all_to_alls that copy)
SHARD_MOE_ARCH = "granite-moe-3b-a800m"
SHARD_MOE_BATCH = (4, 1024)
#: shard (c): a world of this many NCCL ranks on the one card, each its
#: own process, given this long
SHARD_WORLD = 4
SHARD_WORLD_TIMEOUT = 90
#: dryrun (a): the cells of ``repro_torch.launch.dryrun`` run on the card's
#: torch, each its own process (all started together), on the single-pod
#: mesh, and the FALKON solver cell; each process is given this long
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
DRYRUN_TIMEOUT = 240
#: dryrun (b): gemma3-1b's train step as train (b) runs it (GEMMA_TRAIN's
#: batch), counted once, then timed over this many steps; the counted peak
#: (storages alive at once) against ``max_memory_allocated`` over the
#: counted step, within this relative band (the allocator's rounding and
#: cuBLAS's workspace are the difference)
DRYRUN_STEPS = 3
DRYRUN_MEM_BAND = 0.10
#: dryrun (c): the FALKON cell at SUSY's shape on one rank, counted on the
#: "torch" backend; and at this many rows, counted and timed on the card on
#: that backend (the implementation the count reads)
DRYRUN_SMALL_N = 400_000
DRYRUN_BLOCK = 8192
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
#: B1 and B2 timed at the lam path's column widths (the same builds), and
#: B1 at a streamed fit's chunk
SOURCES.update(fused_sweep_p4=SOURCE, fused_sweep_p8=SOURCE, kernel_matmul_p8=SOURCE,
               fused_sweep_chunk=SOURCE)
#: the float16 compensated builds of B1 and B2, and B3 at one K_nM-cache
#: tile (2048 rows, the cached fit's 489 launches)
SOURCES.update(fused_sweep_f16c="src/repro_torch/kernels/csrc/kernel_matvec_f16c.cu",
               kernel_matmul_f16c="src/repro_torch/kernels/csrc/kernel_matvec_f16c.cu",
               pairwise_kernel_tile=SOURCE)
#: B1 at the mini-batch chunk (2048 rows), B2 at the server's rungs of 8 and
#: 256 rows
SOURCES.update(fused_sweep_mb=SOURCE, kernel_matmul_rung8=SOURCE, kernel_matmul_rung256=SOURCE)
#: B1, B2 and B3 at the LM head's shapes (d = 1152: B1's d > 128 route)
SOURCES.update(fused_sweep_head=SOURCE, kernel_matmul_head=SOURCE, pairwise_kernel_head=SOURCE)
#: B1, B2 and B3 at the trained example LM's head (d = 256: B1's d > 128 route)
SOURCES.update(fused_sweep_trained=SOURCE, kernel_matmul_trained=SOURCE,
               pairwise_kernel_trained=SOURCE)


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


def unit_rtol(torch, dt) -> float:
    """One unit in the last place of a 16-bit result, relative (0 for
    fp32): what a rounding boundary between kernel and twin may cost."""
    return {torch.bfloat16: BF16_RTOL, torch.float16: F16_RTOL}.get(dt, 0.0)


def spill_err(torch, km, spec, got, ref, X, C, t) -> tuple[float, float]:
    """(max |got - ref|, max_j |got_j - ref_j| / (atol + rtol max|ref| +
    u S_j)) for B4 with its t spilled in 16 bits (u one unit of t's type),
    S = |K(X, C)|^T |t|: the kernel and its twin round t's fp32 sums to
    t's type, and an entry whose sums fall either side of a rounding
    boundary moves w_j by up to one unit of t_i times |K_ij|. Small shapes
    only (K is materialized)."""
    K = km.pairwise_kernel_plain(X.float(), C.float(), spec=spec).abs().double()
    S = K.T @ t.double().abs()
    diff = (got.double() - ref.double()).abs()
    lim = (TOL["atol"] + TOL["rtol"] * float(ref.double().abs().max())
           + unit_rtol(torch, t.dtype) * S)
    return float(diff.max()), float((diff / lim).max())


def check_compensated(torch, km, spec, X, C, u, v, tag: str) -> dict:
    """The compensated builds of B1, B2 and B4 against their compensated
    twins, X and C at the build's type: B1 with v, without v and under
    ``row_mask`` (masked junk rows bit-equal to the valid prefix), and its
    tile count; B2 with and without ``add``, fp32 and 16-bit out (the
    build's type; bf16 for the fp32 build), on the unsplit and the
    most-split grid; B4 with its t spilled in that type (ragged 64-row
    shards), masked rows bit-equal to the prefix. Returns {check: (max abs
    err, ratio)}."""
    n, M = X.shape[0], C.shape[0]
    p = u.shape[1]
    bf = X.dtype if X.dtype.itemsize == 2 else torch.bfloat16
    f32 = torch.float32
    kw = dict(spec=spec, compensated=True)
    res = {}

    def held(name, got, ref):
        res[name] = close_err(got, ref, TOL["rtol"] + unit_rtol(torch, got.dtype))

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
    res[f"sharded {bf} t"] = spill_err(torch, km, spec, km.sharded_sweep(X, C, u, v, **sk),
                                      km.sharded_sweep_plain(X, C, u, v, **sk), X, C, t)
    got_m = km.sharded_sweep(Xj, C, u, v, row_mask=mask, **sk)
    got_p = km.sharded_sweep(X[:keep].contiguous(), C, u, v[:keep].contiguous(), **sk)
    torch.cuda.synchronize()
    check(torch.equal(got_m, got_p), f"{tag}: masked rows changed the compensated sharded sweep")
    return res


def phase_compensated(torch):
    """The compensated builds (bf16, float16 and fp32) of B1, B2 and B4
    against their twins for the five kinds, around the 128 x 128 tile (n, M
    in EDGE_NM, d in EDGE_D, p = 1..5 one shape each in turn, u at fp32 or
    at the build's type in turn: 16-bit u gives B1 a 16-bit output), B1
    with its w partial and carry in global memory (SWEEP_GLOBAL), and B1's
    and B2's plans for every build against their mirrors."""
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
    for variant in (1, 2, 3):
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
    say(f"[compensated] {total} checks pass; B2's plans equal their mirrors for every build")


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
    return dict(X=X, y=y, Xt=Xt, yt=yt, kernel=est.kernel, centers=est.centers,
                alpha=est.alpha, spec=est.kernel.spec, counts=counts, fit_s=fit_s,
                times=times, peak=peak, err=err, pred=pred, task=task, est=est)


def phase_path(torch, args, main) -> dict:
    """The lam path at SUSY's full width: ``falkon_fit_path`` with the main
    fit's config and generator seed (so its centers) over PATH_LAMS, the
    test rows as the validation set; its facade and launch counts, stage
    seconds, device peak and every lam's validation MSE; at lam = 1e-6 its
    test error and alpha beside the main fit's; one single fit at the
    grid's smallest lam (no cond estimate) timed beside it, its alpha
    against the path's; then the small checks (``path_small``) and the
    leverage fit (``path_leverage``). Returns the path fit's launch counts,
    which the kernels line reads, and every lam's test error, which the
    stream phase reads."""
    from repro_torch.core import (FalkonConfig, FalkonEstimator, FalkonPathResult, falkon_fit,
                                  falkon_fit_path)
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
    errs = [float((torch.sign(e.predict(Xt)) != yt).float().mean()) for e in res.estimators]
    say("[path] test error per lam: " + ", ".join(
        f"{lam:.3g}: {e:.6f}" for lam, e in zip(PATH_LAMS, errs)))
    # what the minibatch phase serves stacked: the estimators and their
    # (L, M) alphas, without the (L, M, M) A stack
    served = FalkonPathResult(
        estimators=tuple(FalkonEstimator(e.centers, e.alpha, e.kernel) for e in res.estimators),
        state=res.state._replace(precond=None, beta=None), lams=res.lams, val_scores=None,
        best_index=None)
    del res, est0
    path_small(torch, args, main)
    path_leverage(torch, args, main)
    return dict(counts=counts, errs=errs, served=served)


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


def reduced_kernels(torch, main, dt, tag: str, seed: int) -> list[dict]:
    """A 16-bit compensated build (``dt``: bf16 or float16) at SUSY's shape:
    B1 at the fit's shape and B2 at predict's against float64 twins, on the
    same quantized inputs (the kernels' own accumulation) and on the
    unquantized ones (the policy's error), each twice bit-equal, timed
    beside its compensated twin and its bound (2-byte X and C). Returns the
    kernels line's rows (launches filled in by the fit)."""
    from repro_torch.kernels import kernel_matvec as km
    X, Xt, C, alpha, spec = main["X"], main["Xt"], main["centers"], main["alpha"], main["spec"]
    n, d = X.shape
    M, m = C.shape[0], Xt.shape[0]
    build = km.VARIANT_NAMES[km.VARIANTS[dt, True]]
    Xq, Cq, Xtq = X.to(dt), C.to(dt), Xt.to(dt)
    u = torch.randn(M, generator=torch.Generator(device=DEVICE).manual_seed(seed), device=DEVICE)
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
    say(f"[{tag}] SUSY-shape sweep n={n} M={M} d={d}, {build} B1: against a float64 "
        f"twin on the same {tag} inputs max abs err {abs_err:.4e} (ratio {ratio:.4f} of atol "
        f"1e-4 + rtol 1e-4, bound 1; {rs:.4f} of {PRED_RTOL:g} x sum|terms|); the policy's "
        f"error against float64 on the unquantized inputs {pol:.4e} (normwise; the reference "
        f"documents <= {POLICY_BOUND:g} for bf16); two runs bit-equal: {again}")
    check(ratio <= 1.0 and again, f"{build} B1 at the SUSY shape is off its float64 twin or "
          "not deterministic")
    breakdown(torch, f"B1 {tag} n={n} M={M} d={d}", sweep)
    ms = time_cuda(torch, sweep, 5)
    plain = time_cuda(torch, lambda: km.fused_sweep_plain(Xq, Cq, u[:, None], None, spec=spec,
                                                          compensated=True, block_rows=65_536),
                      1, warm=False)
    b, by = bound(n * M * (2 * d + 10 + 4), 2 * (n * d + M * d) + 4 * 2 * M)
    say(f"[{tag}] B1 {tag} at the SUSY shape: kernel {ms:.4f} ms, compensated twin "
        f"{plain:.4f} ms, bound {b:.4f} ms ({by})")
    rows.append(dict(name=f"fused_sweep_{build}", base="fused_sweep", ms=ms, plain_ms=plain,
                     bound_ms=b, bound_by=by, max_abs_err=abs_err,
                     shape=f"n={n} M={M} d={d} p=1 {tag}"))
    del w64, w64q

    predict = lambda: km.kernel_matmul(Xtq, Cq, alpha, spec=spec, compensated=True)
    out = predict().double()
    again = torch.equal(out, predict().double())
    ref64 = km.kernel_matmul_plain(Xtq.double(), Cq.double(), alpha.double()[:, None],
                                   spec=spec)[:, 0]
    Sp = float(km.kernel_matmul_plain(Xtq, Cq, alpha.abs()[:, None], spec=spec).max())
    err64 = float((out - ref64).abs().max())
    say(f"[{tag}] predict-shape kernel matmul m={m} n={M}, {build} B2: max abs err "
        f"{err64:.4e} against a float64 twin on the same {tag} inputs (limit {PRED_RTOL:g} x "
        f"max sum|terms| {Sp:.4e} = {PRED_RTOL * Sp:.4e}); two runs bit-equal: {again}")
    check(err64 <= PRED_RTOL * Sp and again, f"{build} B2 at the predict shape is off its "
          "float64 twin or not deterministic")
    breakdown(torch, f"B2 {tag} m={m} n={M} d={d}", predict)
    ms = time_cuda(torch, predict, 10)
    plain = time_cuda(torch, lambda: km.kernel_matmul_plain(Xtq, Cq, alpha[:, None], spec=spec,
                                                            compensated=True), 1, warm=False)
    b, by = bound(m * M * (2 * d + 10 + 2), 2 * (m * d + M * d) + 4 * (M + m))
    say(f"[{tag}] B2 {tag} at the predict shape: kernel {ms:.4f} ms, compensated twin "
        f"{plain:.4f} ms, bound {b:.4f} ms ({by})")
    rows.append(dict(name=f"kernel_matmul_{build}", base="kernel_matmul", ms=ms,
                     plain_ms=plain, bound_ms=b, bound_by=by, max_abs_err=err64,
                     shape=f"m={m} n={M} d={d} p=1 {tag}"))
    return rows


def reduced_fit(torch, args, main, precision, dt, tag: str, rows: list[dict],
                beside: dict) -> dict:
    """The full-size SUSY fit under a 16-bit policy (``precision``: a name
    or a ``PrecisionPolicy``) on the fp32 fit's data and generator seed (so
    its centers): stage times, device peak and test error beside the fits
    in ``beside`` (tag -> their results), launches by build (47 B1 of the
    policy's build), CG iterates stored at ``dt``. Fills ``rows``'
    launches; returns the fit's results."""
    from repro_torch.core import FalkonConfig, falkon_fit
    from repro_torch.kernels import kernel_matvec as km
    X, Xt = main["X"], main["Xt"]
    build = km.VARIANT_NAMES[km.VARIANTS[dt, True]]
    config = susy_config(FalkonConfig, main["task"], precision=precision)
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
    names = "][".join(beside)
    say(f"[{tag}] stage seconds, {tag} fit [{names} fits]: " + ", ".join(
        f"{k} {v:.4f} [" + "][".join(f"{b['times'][k]:.4f}" for b in beside.values()) + "]"
        for k, v in times.items() if isinstance(v, float))
        + f"; fit total {fit_s:.4f} [" + "][".join(f"{b['fit_s']:.4f}" for b in beside.values())
        + "]")
    say(f"[{tag}] peak device memory {peak / 2**30:.3f} GiB [fp32 fit: "
        f"{main['peak'] / 2**30:.3f} GiB]; {before / 2**30:.3f} GiB was allocated before the fit "
        f"(the fp32 data); X on the card {X.numel() * 2 / 2**20:.1f} MiB in {tag}, "
        f"{X.numel() * 4 / 2**20:.1f} MiB in fp32")
    say(f"[{tag}] kernel launches in the {tag} fit: {counts}; by build: "
        + ", ".join(f"{k} {v}" for k, v in variants.items() if v))
    check(variants[f"fused_sweep_{build}"] == 47 and counts["fused_sweep"] == 47,
          f"the {tag} fit's sweeps did not all run the {build} build: {variants}")
    check(variants[f"kernel_matmul_{build}"] >= 1 and counts["pairwise_kernel"] == 1,
          f"the {tag} fit's predict or gram did not launch: {counts} {variants}")
    check(state.beta.dtype == dt, f"CG iterates stored as {state.beta.dtype}, not {dt}")
    res = state.residual_norms.cpu()
    check(bool(torch.isfinite(state.alpha).all() and torch.isfinite(pred).all()),
          f"non-finite alpha or predictions in the {tag} fit")
    check(bool(torch.isfinite(res).all()) and float(res[-1]) < float(res[0]),
          f"the {tag} fit's CG residual did not decrease")
    err = float((torch.sign(pred) != main["yt"]).float().mean())
    say(f"[{tag}] residual norms: " + " ".join(f"{float(r):.4e}" for r in res))
    say(f"[{tag}] cond_estimate {float(state.cond_estimate):.6g}; test error {err:.6f} ["
        + "][".join(f"{k} fit: {b['err']:.6f}" for k, b in beside.items())
        + f"]; predictions' distance from the fp32 fit's {rel(pred, main['pred']):.4e}")
    check(err < 0.4, f"{tag} fit test error {err} no better than chance")
    for r in rows:
        r["launches"] = variants[r["name"]]
    return dict(times=times, fit_s=fit_s, err=err, peak=peak)


def phase_bf16(torch, args, main) -> tuple[list[dict], dict]:
    """The bf16 policy at SUSY's shape: the bf16 compensated B1 sweep at the
    fit's shape and B2 at predict's against float64 twins
    (``reduced_kernels``), then the full-size fit with ``precision="bf16"``
    on the fp32 fit's data and generator seed beside the fp32 fit
    (``reduced_fit``). Returns the kernels line's rows and the fit's
    results."""
    rows = reduced_kernels(torch, main, torch.bfloat16, "bf16", 11)
    fit = reduced_fit(torch, args, main, "bf16", torch.bfloat16, "bf16", rows,
                      {"fp32": main})
    return rows, fit


def phase_f16(torch, args, main, bf16) -> list[dict]:
    """A float16 policy (``PrecisionPolicy(storage="float16",
    compensated=True)``) at SUSY's shape, as the bf16 phase: the float16
    compensated builds of B1 and B2 against float64 twins, then the
    full-size fit on the fp32 fit's data and seed, beside the fp32 and bf16
    fits. Returns the kernels line's rows."""
    from repro_torch.ops import PrecisionPolicy
    policy = PrecisionPolicy(name="fp16", storage="float16", compensated=True)
    rows = reduced_kernels(torch, main, torch.float16, "f16", 13)
    reduced_fit(torch, args, main, policy, torch.float16, "f16", rows,
                {"fp32": main, "bf16": bf16})
    return rows


def sign_err(torch, pred, yt) -> float:
    return float((torch.sign(pred) != yt).float().mean())


def synced(torch, fn):
    """(fn's result, its synchronised wall seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_cache(torch, args, main, card: str) -> list[dict]:
    """The K_nM cache (A11) at SUSY's full width. A device-tier cached fit
    (``knm_cache="device"``) on the first CACHE_N rows beside the uncached
    fit on the same rows and seed (so the same centers): one B3 launch per
    2048-row tile, no B1, every one of the 47 sweeps a GEMM sweep; the test
    error held against the uncached fit's, alpha and predictions against a
    float64 fit of the same system (PATH_AGREE x the uncached fit's
    distance); the stage seconds and the device peak. Then the cached
    sweep against B1 at that n (IEEE fp32 GEMMs asserted; a TF32 setting
    refused), the bf16 cache's sweep and fit, the
    "auto" route at the reference's default budgets ("off", with a
    ``CachePlanWarning``, the uncached fit bit for bit), a cached fit
    against an uncached one at lam = 1e-3, the host tier on CACHE_HOST_N
    rows against the device tier, and a scoring cache over the test rows
    against B2's predict. Returns the kernels line's B3-tile row."""
    from repro_torch.core import FalkonConfig, FalkonEstimator, falkon_fit
    from repro_torch.kernels import kernel_matvec as km
    from repro_torch.ops import CachePlanWarning, CountingOps, KernelCache, plan_cache
    X, y, Xt, yt, task, spec = (main[k] for k in ("X", "y", "Xt", "yt", "task", "spec"))
    n = min(CACHE_N, X.shape[0])
    X1, y1 = X[:n], y[:n]
    M, bs = main["centers"].shape[0], 2048
    tiles, kmm_tiles = -(-n // bs), -(-M // bs)
    ieee = (not torch.backends.cuda.matmul.allow_tf32
            and torch.get_float32_matmul_precision() == "highest")
    say(f"[cache] matmuls in IEEE fp32: allow_tf32 {torch.backends.cuda.matmul.allow_tf32}, "
        f"float32 matmul precision {torch.get_float32_matmul_precision()!r}")
    check(ieee, "the cached path's GEMMs would not run in IEEE fp32")
    plan = plan_cache(n, M, tier="device")
    say(f"[cache] plan (forced): {plan}")
    auto = plan_cache(n, M)
    say(f"[cache] plan at the reference's default budgets: tier {auto.tier!r} — {auto.reason}")
    check(auto.tier == "off", f"the default budgets route SUSY's n={n} cache {auto.tier!r}")

    # the uncached fit, then the cached one, on the same rows and seed
    cfg = susy_config(FalkonConfig, task)
    times0: dict = {}
    est0, st0 = falkon_fit(args.seed, X1, y1, cfg, stage_times=times0)
    torch.cuda.synchronize()
    km.reset_launch_counts()
    cfg_c = susy_config(FalkonConfig, task, knm_cache="device")
    ops = CountingOps(cfg_c.make_ops())
    times1: dict = {}
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    est1, st1 = falkon_fit(args.seed, X1, y1, cfg_c, ops=ops, stage_times=times1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts = km.launch_counts()
    say(f"[cache] cached fit n={n} M={M}: stage seconds " + ", ".join(
        f"{k} {v:.4f}" for k, v in times1.items() if isinstance(v, float))
        + f"; uncached fit: " + ", ".join(f"{k} {v:.4f}" for k, v in times0.items()
                                          if isinstance(v, float)))
    say(f"[cache] materialize {times1['cache']:.4f} s ({counts['pairwise_kernel']} B3 launches: "
        f"{tiles} tiles of {bs} rows and K_MM); solve {times1['solve']:.4f} s cached, "
        f"{times0['solve']:.4f} s uncached ({times1['solve'] / times0['solve']:.4f}x); "
        f"device peak {peak} B ({peak / 2**30:.3f} GiB; {before / 2**30:.3f} GiB held before); "
        f"the cache {plan.cache_bytes} B in K_nM, {tiles * bs * M * 4} B stored")
    say(f"[cache] launches {counts}; facade: sweeps {ops.sweeps}, materializes "
        f"{ops.materializes}, gemm_sweeps {ops.gemm_sweeps}, gram_tile_evals "
        f"{ops.gram_tile_evals}")
    check(counts["pairwise_kernel"] == tiles + 1 and counts["fused_sweep"] == 0
          and counts["sharded_sweep"] == 0, f"the cached fit's launches {counts}")
    check(ops.sweeps == 0 and ops.materializes == 1 and ops.gemm_sweeps == 47
          and ops.gram_tile_evals == tiles + kmm_tiles,
          f"the cached fit's facade counts: sweeps {ops.sweeps}, gemm_sweeps {ops.gemm_sweeps}")
    check(torch.equal(est0.centers, est1.centers), "the cached and uncached fits' centers differ")
    p0, p1 = est0.predict(Xt), est1.predict(Xt)
    e0, e1 = sign_err(torch, p0, yt), sign_err(torch, p1, yt)
    t64 = time.perf_counter()
    os.environ["REPRO_FACTOR_BUDGET_MB"] = "1024"   # the float64 factor stays in-core
    try:
        ref = falkon_fit(args.seed, X1.double(), y1.double(), susy_config(
            FalkonConfig, task, dtype="float64", ops_impl="torch", estimate_cond=False))[0]
    finally:
        os.environ.pop("REPRO_FACTOR_BUDGET_MB")
    ref_pred = ref.predict(Xt.double())
    check(torch.equal(ref.centers.float(), est0.centers), "the float64 fit drew other centers")
    c64 = dict(alpha=rel(st1.alpha, ref.alpha), pred=rel(p1, ref_pred))
    u64 = dict(alpha=rel(st0.alpha, ref.alpha), pred=rel(p0, ref_pred))
    say(f"[cache] test error cached {e1:.6f}, uncached {e0:.6f} (bound {CACHE_ERR} apart); "
        f"alpha {rel(st1.alpha, st0.alpha):.4e} apart, predictions {rel(p1, p0):.4e}; from a "
        f"float64 fit ({time.perf_counter() - t64:.1f} s): the cached fit's alpha "
        f"{c64['alpha']:.4e}, predictions {c64['pred']:.4e}, the uncached fit's "
        f"{u64['alpha']:.4e}, {u64['pred']:.4e} (bound {PATH_AGREE:g}x the uncached fit's); "
        f"cond {float(st1.cond_estimate):.6g} vs {float(st0.cond_estimate):.6g}")
    check(abs(e1 - e0) <= CACHE_ERR and bool(torch.isfinite(st1.alpha).all())
          and all(c64[k] <= PATH_AGREE * u64[k] for k in c64),
          "the cached fit is off the uncached fit or farther from the float64 fit")
    del ref, ref_pred

    # one cached sweep against B1 at this n; a TF32 setting is refused
    cache = KernelCache(cfg_c.make_ops(), X1, main["centers"], plan=plan)
    u = torch.randn(M, generator=torch.Generator(device=DEVICE).manual_seed(17), device=DEVICE)
    wc, wb = cache.sweep(u), km.fused_sweep(X1, main["centers"], u, spec=spec)
    abs_err, ratio = close_err(wc, wb)
    again = torch.equal(wc, cache.sweep(u))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        cache.sweep(u)
        refused = False
    except RuntimeError:
        refused = True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    say(f"[cache] cached sweep vs B1 at n={n}: max abs err {abs_err:.3e} (ratio {ratio:.4f}); "
        f"two runs bit-equal: {again}; refused under allow_tf32: {refused}")
    check(ratio <= 1.0 and again and refused, "the cached sweep is off B1, not deterministic, "
          "or ran with TF32")
    breakdown(torch, f"cached sweep n={n} M={M}", lambda: cache.sweep(u))
    ms_c = time_cuda(torch, lambda: cache.sweep(u), 5)
    ms_b = time_cuda(torch, lambda: km.fused_sweep(X1, main["centers"], u, spec=spec), 5)
    say(f"[cache] one sweep at n={n} M={M}: cached {ms_c:.4f} ms, B1 {ms_b:.4f} ms "
        f"({ms_c / ms_b:.4f}x); {card}")
    del cache, wc, wb

    # bf16 storage: half the bytes, a widened strip per product
    cfg_b = susy_config(FalkonConfig, task, precision="bf16", knm_cache="device")
    cache = KernelCache(cfg_b.make_ops(), X1.to(torch.bfloat16), main["centers"],
                        plan=plan_cache(n, M, policy=cfg_b.make_ops().policy, tier="device"))
    Xq, Cq = X1.to(torch.bfloat16), main["centers"].to(torch.bfloat16)
    wc = cache.sweep(u)
    wb = km.fused_sweep(Xq, Cq, u, spec=spec, compensated=True)
    abs_err, ratio = close_err(wc, wb, TOL["rtol"] + BF16_RTOL)
    ms_cb = time_cuda(torch, lambda: cache.sweep(u), 5)
    ms_bb = time_cuda(torch, lambda: km.fused_sweep(Xq, Cq, u, spec=spec, compensated=True), 5)
    say(f"[cache] bf16 cache: {cache.K.dtype}, {cache.K.numel() * cache.K.element_size()} B; "
        f"sweep vs bf16 B1 max abs err {abs_err:.3e} (ratio {ratio:.4f}, rtol + 2^-7); one sweep "
        f"cached {ms_cb:.4f} ms, bf16 B1 {ms_bb:.4f} ms ({ms_cb / ms_bb:.4f}x); {card}")
    check(ratio <= 1.0 and cache.K.dtype == torch.bfloat16, "the bf16 cached sweep is off B1")
    del cache, wc, wb, Xq, Cq
    times_b: dict = {}
    est_b, st_b = falkon_fit(args.seed, X1, y1, cfg_b, stage_times=times_b)
    e_b = sign_err(torch, est_b.predict(Xt), yt)
    say(f"[cache] bf16 cached fit: stage seconds " + ", ".join(
        f"{k} {v:.4f}" for k, v in times_b.items() if isinstance(v, float))
        + f"; test error {e_b:.6f} (fp32 cached {e1:.6f})")
    check(bool(torch.isfinite(st_b.alpha).all()) and e_b < 0.4, "the bf16 cached fit failed")

    # "auto" at the reference's default budgets: off, warned, the uncached fit
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        _, st_a = falkon_fit(args.seed, X1, y1, susy_config(FalkonConfig, task,
                                                            knm_cache="auto"))
    plans = [w.message.plan for w in rec if issubclass(w.category, CachePlanWarning)]
    say(f"[cache] knm_cache='auto': {len(plans)} CachePlanWarning, tier "
        f"{plans[0].tier if plans else None!r}; alpha bit-equal to the uncached fit: "
        f"{torch.equal(st_a.alpha, st0.alpha)}")
    check(len(plans) == 1 and plans[0].tier == "off" and torch.equal(st_a.alpha, st0.alpha),
          "the auto route did not fall back to the uncached fit with a warning")
    del est0, est1, st0, st1, st_a, est_b, st_b

    # a tame lam: cached and uncached predictions nearly equal
    ns, ms, lam_s = STREAM_SMALL
    small = [falkon_fit(args.seed, X[:ns], y[:ns], susy_config(
        FalkonConfig, task, num_centers=ms, lam=lam_s, knm_cache=mode))[0].predict(Xt[:ns])
        for mode in ("off", "device")]
    rs = rel(small[1], small[0])
    say(f"[cache] n={ns} M={ms} lam={lam_s:g}: cached vs uncached predictions {rs:.3e} "
        f"(bound {CACHE_SMALL_PRED_TOL:g})")
    check(rs <= CACHE_SMALL_PRED_TOL, f"the cached fit at lam={lam_s:g} is off the uncached")

    # the host tier on CACHE_HOST_N rows against the device tier
    nh = CACHE_HOST_N
    hplan = plan_cache(nh, M, tier="host")
    cache = KernelCache(cfg_c.make_ops(), X[:nh], main["centers"], plan=hplan)
    w_h, s_h = synced(torch, lambda: cache.sweep(u))
    _, s_h2 = synced(torch, lambda: cache.sweep(u))
    del cache
    dcache = KernelCache(cfg_c.make_ops(), X[:nh], main["centers"],
                         plan=plan_cache(nh, M, tier="device"))
    w_d, s_d = synced(torch, lambda: dcache.sweep(u))
    del dcache
    fits = {}
    for mode in ("device", "host"):
        t_: dict = {}
        fits[mode] = falkon_fit(args.seed, X[:nh], y[:nh], susy_config(
            FalkonConfig, task, knm_cache=mode, estimate_cond=False), stage_times=t_)[1], t_
    rh = rel(fits["host"][0].alpha, fits["device"][0].alpha)
    say(f"[cache] host tier n={nh}: {hplan.cache_bytes} B in {-(-nh // bs)} tiles; one sweep "
        f"{s_h:.4f} s, again {s_h2:.4f} s (device tier {s_d * 1e3:.4f} ms, synchronised wall "
        f"clock); sweep vs device tier {rel(w_h, w_d):.3e}; fits (no cond estimate): host "
        f"cache {fits['host'][1]['cache']:.4f} s, solve {fits['host'][1]['solve']:.4f} s; "
        f"device cache {fits['device'][1]['cache']:.4f} s, solve "
        f"{fits['device'][1]['solve']:.4f} s; alpha {rh:.3e} apart (bound {CACHE_HOST_TOL:g})")
    check(rh <= CACHE_HOST_TOL, "the host-tier fit is off the device-tier fit")
    del fits, w_h, w_d

    # a scoring cache over the test rows, against B2's predict
    Cc, alpha = main["centers"], main["alpha"]
    est = FalkonEstimator(Cc, alpha, main["kernel"])
    scache, s_build = synced(torch, lambda: est.build_knm_cache(Xt, tier="device"))
    pc = est.predict(Xt, cache=scache)
    pb = km.kernel_matmul(Xt, Cc, alpha, spec=spec)
    S = float(km.kernel_matmul_plain(Xt, Cc, alpha.abs()[:, None], spec=spec).max())
    limit, top = 2 * PRED_RTOL * S, float(pb.abs().max())
    diff = float((pc.double() - pb.double()).abs().max())
    ms_pc = time_cuda(torch, lambda: est.predict(Xt, cache=scache), 10)
    ms_pb = time_cuda(torch, lambda: km.kernel_matmul(Xt, Cc, alpha, spec=spec), 10)
    say(f"[cache] scoring cache m={Xt.shape[0]} n={M}: built in {s_build:.4f} s "
        f"({scache.K.numel() * 4} B); cached predict vs B2 max abs err {diff:.3e} (limit 2 x "
        f"{PRED_RTOL:g} x max sum|terms| {S:.4e} = {limit:.3e}; largest |prediction| "
        f"{top:.4f}); cached predict {ms_pc:.4f} ms, B2 {ms_pb:.4f} ms "
        f"({ms_pc / ms_pb:.4f}x); {card}")
    check(limit <= 0.05 * top and diff <= limit, "the cached predict is off B2's")
    del est, scache, pc, pb
    # the 40 GB and 20 GB blocks go back to the card: later phases' tensors
    # are not carved out of them (their fragments left the MillionSongs
    # factor witness without room for its 18.6 GiB float64 K_MM)
    torch.cuda.empty_cache()

    row = pairwise_times(torch, km, X1[:bs].contiguous(), Cc, spec, "a K_nM-cache tile",
                         plain=True)
    row.update(name="pairwise_kernel_tile", base="pairwise_kernel",
               launches=counts["pairwise_kernel"])
    return [row]


def phase_stream(torch, args, main, path, bf16_err, card: str) -> dict:
    """The host-streamed fits (A8) at SUSY's full size, from host numpy
    copies of the main phase's rows in chunks of STREAM_CHUNK: the fp32 fit
    on the main fit's centers (B1 launched once per chunk and pass, one
    chunk shape, B3 once, no B4) and ``predict_stream`` over the test rows;
    one streamed sweep against a float64 twin and bit-equal over prefetch 2
    and 0; a tame-rounding fit against the in-core fit; the device peaks of
    two fits that draw their own centers at n = 10^6 and 4x10^6; the bf16
    and 8-lam path fits streamed; the streamed solve beside the in-core one,
    prefetch 2 beside 0, chunks of 2^15 beside 2^18 and the loader alone.
    Returns the kernels line's row of B1 at the chunk shape."""
    from repro_torch.core import (FalkonConfig, falkon_fit, falkon_fit_path_streaming,
                                  falkon_fit_streaming, falkon_solve, falkon_solve_streaming)
    from repro_torch.data import ArrayChunkSource, StreamingLoader, streaming_sweep
    from repro_torch.kernels import kernel_matvec as km
    from repro_torch.ops import CountingOps
    t_phase = time.perf_counter()
    X, y, Xt, yt, C, spec = (main[k] for k in ("X", "y", "Xt", "yt", "centers", "spec"))
    task, t, CH = main["task"], 20, STREAM_CHUNK
    (n, d), M = X.shape, C.shape[0]
    Xh, yh, Xth = (a.cpu().numpy() for a in (X, y, Xt))
    src = ArrayChunkSource(Xh, yh, chunk_rows=CH)
    tsrc = ArrayChunkSource(Xth, chunk_rows=CH)
    chunks = src.num_chunks
    config = susy_config(FalkonConfig, task)
    say(f"[stream] host X {Xh.nbytes} B in {chunks} chunks of {CH} rows (the last "
        f"{n - (chunks - 1) * CH}, padded), {Xh.nbytes / chunks / 1e6:.1f} MB a chunk")

    # the fp32 fit on the main fit's centers, and its predictions
    ops = CountingOps(config.make_ops())
    times: dict = {}
    km.reset_launch_counts()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (est, state), fit_s = synced(torch, lambda: falkon_fit_streaming(
        args.seed, src, config, centers=C, ops=ops, stage_times=times))
    peak = torch.cuda.max_memory_allocated() - before
    counts = km.launch_counts()
    say("[stream] fp32 fit stage seconds: " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items() if isinstance(v, float))
        + f"; fit total {fit_s:.4f} (in-core fit {main['fit_s']:.4f}, with the cond estimate)")
    say(f"[stream] launches {counts}; sweep calls {ops.sweeps}, X shapes {ops.sweep_shapes}; "
        f"device peak above the {before} B held before it: {peak} B ({peak / 2**30:.3f} GiB)")
    want = dict(fused_sweep=(t + 1) * chunks, pairwise_kernel=1, sharded_sweep=0,
                kernel_matmul=0)
    check(all(counts[k] == v for k, v in want.items()),
          f"streamed fit launches {counts}, expected {want}")
    check(ops.sweep_shapes == {((CH, d), torch.float32)},
          f"chunk sweeps saw X shapes {ops.sweep_shapes}, not one ({CH}, {d})")
    res = state.residual_norms.cpu()
    check(bool(torch.isfinite(state.alpha).all()) and float(res[-1]) < float(res[0]),
          "the streamed fit's alpha is not finite or its residual did not fall")
    km.reset_launch_counts()
    pred = est.predict_stream(StreamingLoader(tsrc, device=DEVICE))
    b2 = km.launch_counts()["kernel_matmul"]
    err = sign_err(torch, pred, yt)
    say(f"[stream] predict_stream over {Xth.shape[0]} rows: {b2} B2 launches; test error "
        f"{err:.6f} (in-core fit {main['err']:.6f}, bound {STREAM_ERR} apart); predictions "
        f"{rel(pred, main['pred']):.4e} from the in-core fit's, {rel(pred, est.predict(Xt)):.4e} "
        "from its own in-core predict")
    check(b2 == tsrc.num_chunks and pred.shape == (Xth.shape[0],),
          f"predict_stream launched B2 {b2} times for {tsrc.num_chunks} chunks")
    check(abs(err - main["err"]) <= STREAM_ERR, f"streamed test error {err} vs {main['err']}")

    # races: one streamed sweep against a float64 twin, bit-equal over prefetch 2 and 0
    u = torch.randn(M, generator=torch.Generator(device=DEVICE).manual_seed(17), device=DEVICE)
    sweep_ops = config.make_ops()

    def streamed(pf):
        return streaming_sweep(sweep_ops, StreamingLoader(src, device=DEVICE, prefetch=pf), C,
                               u, use_targets=False)
    ws, _ = sweep_witness(torch, km, spec, X, C, u, f"streamed n={n} M={M} chunk {CH}",
                          {"streamed B1": lambda: streamed(2)})
    same = [torch.equal(ws["streamed B1"], streamed(pf)) for pf in (2, 0, 2, 0)]
    Xc = X[:CH]
    ones = torch.equal(km.fused_sweep(Xc, C, u, spec=spec),
                       km.fused_sweep(Xc, C, u, spec=spec,
                                      row_mask=torch.ones(CH, device=DEVICE)))
    say(f"[stream] streamed sweep at prefetch 2, 0, 2, 0 bit-equal to the first: {same}; a "
        f"full chunk without a mask bit-equal to one with a ones mask: {ones}")
    check(all(same) and ones, "streamed sweeps differ between runs or prefetch depths")

    # fits where rounding is tame: streamed against in-core on the same centers
    ns, ms, lam_s = STREAM_SMALL
    for prec, tol in (("fp32", STREAM_PRED_TOL), ("bf16", POLICY_BOUND)):
        cfg_s = susy_config(FalkonConfig, task, num_centers=ms, lam=lam_s, estimate_cond=False,
                            precision=prec)
        est_i = falkon_fit(args.seed, X[:ns], y[:ns], cfg_s)[0]
        est_s = falkon_fit_streaming(args.seed, ArrayChunkSource(Xh[:ns], yh[:ns],
                                                                 chunk_rows=8192),
                                     cfg_s, centers=est_i.centers)[0]
        r = rel(est_s.predict(Xt[:ns]), est_i.predict(Xt[:ns]))
        say(f"[stream] n={ns} M={ms} lam={lam_s:g} {prec}, chunks of 8192: streamed against "
            f"in-core predictions rel {r:.4e} (bound {tol:g}); alpha rel "
            f"{rel(est_s.alpha, est_i.alpha):.4e}")
        check(r <= tol, f"the small streamed {prec} fit stands {r:.4e} from the in-core fit")
    del est_i, est_s

    # memory that does not grow with n: own centers at n = 10^6 and 4x10^6
    peaks = {}
    for nm in (1_000_000, n):
        s_m = ArrayChunkSource(Xh[:nm], yh[:nm], chunk_rows=CH)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tm: dict = {}
        e_m, fs = synced(torch, lambda: falkon_fit_streaming(args.seed, s_m, config,
                                                             stage_times=tm))
        peaks[nm] = torch.cuda.max_memory_allocated() - base
        say(f"[stream] n={nm}, own centers: fit {fs:.4f} s (centers {tm['centers']:.4f}, solve "
            f"{tm['solve']:.4f}), device peak {peaks[nm]} B ({peaks[nm] / 2**30:.3f} GiB), "
            f"{len(torch.unique(e_m[0].centers, dim=0))} distinct centers")
        del e_m
    p1, p4 = peaks[1_000_000], peaks[n]
    say(f"[stream] device peaks {p1} / {p4} B apart {abs(p4 - p1)} B (bound {STREAM_PEAK_AGREE}); "
        f"in-core fit {main['peak']} B ({main['peak'] / 2**30:.3f} GiB)")
    check(abs(p4 - p1) <= STREAM_PEAK_AGREE and p4 < main["peak"],
          f"streamed device peaks {p1}, {p4} grow with n or reach the in-core {main['peak']}")

    # the bf16 policy, streamed: bf16 chunks over the bus
    cfg_b = susy_config(FalkonConfig, task, precision="bf16")
    ops_b = CountingOps(cfg_b.make_ops())
    tb: dict = {}
    km.reset_launch_counts()
    (est_b, st_b), fb = synced(torch, lambda: falkon_fit_streaming(
        args.seed, src, cfg_b, centers=C, ops=ops_b, stage_times=tb))
    variants = km.variant_launch_counts()
    err_b = sign_err(torch, est_b.predict_stream(StreamingLoader(tsrc, device=DEVICE,
                                                                    dtype=torch.bfloat16)), yt)
    say(f"[stream] bf16 fit {fb:.4f} s (solve {tb['solve']:.4f}), X shapes "
        f"{ops_b.sweep_shapes}, {Xh.size * 2 / chunks / 1e6:.1f} MB a chunk over the bus; "
        f"launches by build: " + ", ".join(f"{k} {v}" for k, v in variants.items() if v)
        + f"; test error {err_b:.6f} (in-core bf16 fit {bf16_err:.6f})")
    check(ops_b.sweep_shapes == {((CH, d), torch.bfloat16)}
          and variants["fused_sweep_bf16c"] == (t + 1) * chunks,
          f"the bf16 streamed fit's chunks or sweeps were not bf16: {ops_b.sweep_shapes} "
          f"{variants}")
    check(err_b < 0.4, f"bf16 streamed fit test error {err_b} no better than chance")
    # At lam = 1e-6 the order of the sums alone moves the bf16 fit's test
    # error by more than 0.002 (bf16 CG iterates round at 2^-8): so the
    # streamed solve is held bit-equal to the in-core solve where both sum
    # alike (X in one chunk), fp32 and bf16, and the 16-chunk fit's error is
    # printed beside an in-core bf16 solve on rows rolled by STREAM_ROLL.
    one = ArrayChunkSource(Xh, yh, chunk_rows=n)
    for tag, cfg_x, pre_x in (("fp32", config, state.precond), ("bf16", cfg_b, st_b.precond)):
        s1 = falkon_solve_streaming(StreamingLoader(one, device=DEVICE), C, pre_x, task.lam, t,
                                    ops=cfg_x.make_ops())
        si = falkon_solve(X, y, C, pre_x, est.kernel, task.lam, t, estimate_cond=False,
                          ops=cfg_x.make_ops())
        same = torch.equal(s1.alpha, si.alpha) and torch.equal(s1.residual_norms,
                                                                  si.residual_norms)
        say(f"[stream] {tag}: X streamed in one chunk, the solve bit-equal to the in-core "
            f"falkon_solve(estimate_cond=False) on the same preconditioner: {same}")
        check(same, f"the one-chunk streamed {tag} solve differs from the in-core solve")
    Xr, yr = torch.roll(X, STREAM_ROLL, 0), torch.roll(y, STREAM_ROLL, 0)
    sr = falkon_solve(Xr, yr, C, st_b.precond, est.kernel, task.lam, t, estimate_cond=False,
                      ops=cfg_b.make_ops())
    err_r = sign_err(torch, cfg_b.make_ops().apply(Xt, C, sr.alpha), yt)
    say(f"[stream] bf16 test errors: streamed in {chunks} chunks {err_b:.6f}, in-core fit "
        f"{bf16_err:.6f}, in-core solve on rows rolled by {STREAM_ROLL} {err_r:.6f} (the order "
        "of the sums alone)")
    del est_b, st_b, Xr, yr, sr

    # the 8-lam path, streamed
    tp: dict = {}
    km.reset_launch_counts()
    pres, fp = synced(torch, lambda: falkon_fit_path_streaming(
        args.seed, src, config, PATH_LAMS, centers=C, stage_times=tp))
    cp = km.launch_counts()
    errs = [sign_err(torch, e.predict(Xt), yt) for e in pres.estimators]
    say(f"[stream] 8-lam path fit {fp:.4f} s (solve {tp['solve']:.4f}), {cp['fused_sweep']} B1 "
        "launches; test error per lam, streamed [in-core path]: " + ", ".join(
            f"{lam:.3g}: {e:.6f} [{p:.6f}]" for lam, e, p in zip(PATH_LAMS, errs, path["errs"])))
    check(cp["fused_sweep"] == chunks * (1 + t * 2), f"streamed path launched B1 {cp}")
    check(all(abs(e - p) <= STREAM_ERR for e, p in zip(errs, path["errs"])),
          "a streamed path lam's test error is off the in-core path's")
    del pres

    # timings: the streamed solve beside the in-core one on the same preconditioner
    pre, kernel = state.precond, est.kernel
    small = ArrayChunkSource(Xh, yh, chunk_rows=STREAM_SMALL_CHUNK)

    def incore():
        return falkon_solve(X, y, C, pre, kernel, task.lam, t, estimate_cond=False,
                            ops=config.make_ops())

    def solve_streamed(source, pf):
        return falkon_solve_streaming(StreamingLoader(source, device=DEVICE, prefetch=pf), C, pre,
                                      task.lam, t,
                                      ops=config.make_ops())
    runs = [("in-core", incore), ("streamed 2^18 prefetch 2", lambda: solve_streamed(src, 2)),
            ("streamed 2^18 prefetch 0", lambda: solve_streamed(src, 0)),
            ("streamed 2^15 prefetch 2", lambda: solve_streamed(small, 2))]
    secs: dict = {name: [] for name, _ in runs}
    for name, fn in runs + runs[::-1]:      # in turns: a, b, c, d, d, c, b, a
        secs[name].append(synced(torch, fn)[1])

    def loader_pass(pf):
        for _ in StreamingLoader(src, device=DEVICE, prefetch=pf).iter_chunks(
                with_targets=False):
            pass
    passes = {pf: [synced(torch, lambda: loader_pass(pf))[1] for _ in range(3)] for pf in (2, 0)}
    say(f"[stream] {card}: solve seconds (t = 20, no cond estimate; two runs each, in turns): "
        + "; ".join(f"{k} " + " ".join(f"{v:.4f}" for v in vs) for k, vs in secs.items()))
    s_in, s_st = min(secs["in-core"]), min(secs["streamed 2^18 prefetch 2"])
    say(f"[stream] streamed / in-core solve {s_st / s_in:.4f}; prefetch 0 / 2 "
        f"{min(secs['streamed 2^18 prefetch 0']) / s_st:.4f}; chunks 2^15 / 2^18 "
        f"{min(secs['streamed 2^15 prefetch 2']) / s_st:.4f}")
    say(f"[stream] {card}: one pass of the loader alone, synchronised, no sweep ({Xh.nbytes} B "
        "fp32): "
        + "; ".join(f"prefetch {pf}: " + " ".join(f"{v * 1e3:.2f}" for v in vs) + " ms"
                    for pf, vs in passes.items()))

    # the kernels line's row: B1 at the chunk shape
    sweep = lambda: km.fused_sweep(Xc, C, u, spec=spec)
    abs_err, ratio = close_err(sweep(), km.fused_sweep_plain(Xc, C, u[:, None], None,
                                                             spec=spec)[0][:, 0])
    check(ratio <= 1.0, f"B1 at the chunk shape disagrees with its twin (ratio {ratio})")
    ms = time_cuda(torch, sweep, 20)
    plain = time_cuda(torch, lambda: km.fused_sweep_plain(Xc, C, u[:, None], None, spec=spec), 3)
    b, by = bound(CH * M * (2 * d + 10 + 4), 4 * (CH * d + M * d + 2 * M))
    say(f"[stream] {card}: B1 at the chunk shape n={CH} M={M} d={d}: kernel {ms:.4f} ms "
        f"({chunks} a pass: {ms * chunks:.2f} ms), twin {plain:.4f} ms, bound {b:.4f} ms ({by}); "
        f"max abs err {abs_err:.3e} (ratio {ratio:.4f}); phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return dict(name="fused_sweep_chunk", base="fused_sweep", ms=ms, plain_ms=plain,
                bound_ms=b, bound_by=by, max_abs_err=abs_err, launches=counts["fused_sweep"],
                shape=f"n={CH} M={M} d={d} p=1")


def phase_minibatch(torch, args, main, path, card: str) -> list[dict]:
    """Mini-batch fits (A12) and the coalescing server (A13) at SUSY's full
    width, on the main fit's data, centers and configuration: the in-core
    fit at the reference's default ``MinibatchConfig`` (exact launch counts,
    stage seconds with the solve split into steps and projections, device
    peak, rows swept, gradient norms, test error); the streamed fit from
    host numpy in chunks of 2048 against the in-core fit, shuffle=False,
    bit for bit; ``partial_fit`` of the main estimator on a fresh tail
    (shared centers storage, alpha moved); the server over a ragged trace (6 captures
    at warmup, none after flushes and a ``swap_model``, every request
    bit-equal to ``predict`` of it alone, beside the per-request loop), the
    lam path served stacked, a scoring cache refused after a swap; at
    n = 20,000, M = 500, lam = 1e-3 the "cuda" and "torch" backends'
    solves against a float64 one, the full-batch fixed point, and
    ``partial_fit`` on rows the fit has not seen against the "torch"
    backend's and a float64 one. Returns
    the kernels line's rows: B1 at the chunk shape, B2 at rungs 8 and 256."""
    from repro_torch.core import (FalkonConfig, MinibatchConfig, falkon_fit_minibatch,
                                  falkon_fit_minibatch_streaming)
    from repro_torch.data import ArrayChunkSource
    from repro_torch.data.synthetic import make_kernel_dataset
    from repro_torch.kernels import kernel_matvec as km
    from repro_torch.launch.serve import make_request_trace, serve_per_request
    from repro_torch.serve import CoalescingPredictServer
    t_phase = time.perf_counter()
    X, y, Xt, yt, C, spec, task, est = (main[k] for k in ("X", "y", "Xt", "yt", "centers",
                                                          "spec", "task", "est"))
    (n, d), M = X.shape, C.shape[0]
    config = susy_config(FalkonConfig, task)
    mb = MinibatchConfig()
    c, k = mb.chunk_rows, mb.project_every
    periods = -(-n // (k * c))
    n_pad = periods * k * c
    steps, projections = mb.epochs * n_pad // c, mb.epochs * periods
    majority = min(float((yt > 0).float().mean()), float((yt < 0).float().mean()))

    # the in-core fit at the reference's default configuration
    times: dict = {}
    km.reset_launch_counts()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (est_mb, res), fit_s = synced(torch, lambda: falkon_fit_minibatch(
        args.seed, X, y, config, mb, centers=C, stage_times=times))
    peak = torch.cuda.max_memory_allocated() - before
    counts = km.launch_counts()
    gn = res.grad_norms.cpu()
    err_mb = sign_err(torch, est_mb.predict(Xt), yt)
    say(f"[minibatch] {mb}: n={n} pads to {n_pad} rows, {periods} periods of {k} chunks of "
        f"{c} an epoch: {steps} steps, {projections} projections, {mb.power_iters} pilot sweeps")
    say(f"[minibatch] {card}: fit stage seconds: " + ", ".join(
        f"{key} {v:.4f}" for key, v in times.items() if isinstance(v, float))
        + f"; fit total {fit_s:.4f}; a step {times['steps'] / steps * 1e3:.4f} ms, a projection "
        f"{times['projections'] / projections * 1e3:.4f} ms (CUDA events); main CG fit "
        f"{main['fit_s']:.4f} s (solve {main['times']['solve']:.4f})")
    say(f"[minibatch] launches {counts}; device peak above the {before} B held before it: "
        f"{peak} B ({peak / 2**30:.3f} GiB); rows swept {res.rows_swept:.0f}; step size "
        f"{float(res.step_size):.6g}; grad norms first {float(gn[0]):.4e} last "
        f"{float(gn[-1]):.4e}; test error {err_mb:.6f} (main CG fit {main['err']:.6f}, the "
        f"majority class's {majority:.6f})")
    want = dict(fused_sweep=mb.power_iters + steps, pairwise_kernel=1, sharded_sweep=0,
                kernel_matmul=0)
    check(all(counts[key] == v for key, v in want.items()),
          f"mini-batch fit launches {counts}, expected {want}")
    check((int(res.state.step), int(res.state.projections), times["projections_count"])
          == (steps, projections, projections)
          and res.rows_swept == float(mb.epochs * n_pad + mb.power_iters * c),
          f"mini-batch steps {int(res.state.step)}, projections {int(res.state.projections)}, "
          f"rows swept {res.rows_swept}")
    check(bool(torch.isfinite(gn).all()) and float(gn[-1]) < float(gn[0])
          and bool(torch.isfinite(est_mb.alpha).all()),
          "mini-batch gradient norms or alpha not finite, or the gradient did not fall")
    check(err_mb < majority, f"mini-batch test error {err_mb} not below the majority "
          f"class's {majority}")
    del est_mb, res

    # streamed against in-core, shuffle=False: bit for bit
    mb0 = dataclasses.replace(mb, shuffle=False)
    Xh, yh = X.cpu().numpy(), y.cpu().numpy()
    src = ArrayChunkSource(Xh, yh, chunk_rows=c)
    ts: dict = {}
    km.reset_launch_counts()
    (est_s, res_s), s_s = synced(torch, lambda: falkon_fit_minibatch_streaming(
        args.seed, src, config, mb0, centers=C, stage_times=ts))
    cs = km.launch_counts()
    ti: dict = {}
    (est_i, res_i), s_i = synced(torch, lambda: falkon_fit_minibatch(
        args.seed, X, y, config, mb0, centers=C, stage_times=ti))
    same = (torch.equal(est_s.alpha, est_i.alpha)
            and torch.equal(res_s.grad_norms, res_i.grad_norms))
    say(f"[minibatch] shuffle=False: streamed from host numpy in {src.num_chunks} chunks of {c} "
        f"(prefetch 2): {cs['fused_sweep']} B1 launches, solve {ts['solve']:.4f} s (steps "
        f"{ts['steps']:.4f}, projections {ts['projections']:.4f}); in-core solve "
        f"{ti['solve']:.4f} s; alpha and gradient norms bit-equal: {same} (alpha rel "
        f"{rel(est_s.alpha, est_i.alpha):.3e})")
    check(cs["fused_sweep"] == mb.power_iters + mb.epochs * src.num_chunks,
          f"streamed mini-batch fit launched B1 {cs['fused_sweep']} times")
    check(same, "the streamed shuffle=False mini-batch fit differs from the in-core one")
    del est_s, res_s, est_i, res_i, Xh, yh, src

    # partial_fit of the main estimator on a fresh tail (the same target)
    g = torch.Generator(device=DEVICE).manual_seed(args.seed + MB_TAIL_SEED)
    Xtail, ytail = make_kernel_dataset(
        g, task, MB_TAIL, fn_generator=torch.Generator(device=DEVICE).manual_seed(args.seed + 1))
    km.reset_launch_counts()
    new, pf_s = synced(torch, lambda: est.partial_fit(Xtail, ytail, mb, generator=args.seed))
    cp = km.launch_counts()
    err_new = sign_err(torch, new.predict(Xt), yt)
    shared = new.centers is est.centers and new.centers.data_ptr() == est.centers.data_ptr()
    moved_pf = rel(new.alpha, est.alpha)
    say(f"[minibatch] partial_fit on {MB_TAIL} fresh rows: {pf_s:.4f} s, {cp['fused_sweep']} B1 "
        f"launches; centers storage shared: {shared}; alpha {tuple(new.alpha.shape)} "
        f"{new.alpha.dtype} {new.alpha.device}, moved {moved_pf:.3e} (normwise) from the "
        f"deployed alpha; test error {err_new:.6f} (before {main['err']:.6f})")
    check(shared and (new.alpha.shape, new.alpha.dtype, new.alpha.device)
          == (est.alpha.shape, est.alpha.dtype, est.alpha.device),
          "partial_fit did not keep the centers storage or alpha's geometry")
    check(bool(torch.isfinite(new.alpha).all()) and err_new < majority,
          f"partial_fit's alpha not finite or test error {err_new} at chance")
    check(not torch.equal(new.alpha, est.alpha), "partial_fit returned the deployed alpha")
    check(cp["fused_sweep"] == mb.power_iters + mb.epochs * -(-MB_TAIL // (k * c)) * k,
          f"partial_fit launched B1 {cp['fused_sweep']} times")
    del Xtail, ytail

    # the server at full width
    trace = make_request_trace(SERVE_REQUESTS, SERVE_BATCH, d, seed=args.seed)
    nrows = sum(r.shape[0] for r in trace)
    server = CoalescingPredictServer(est, max_batch=SERVE_BATCH)
    km.reset_launch_counts()
    warm = server.warmup()
    b2_warm = km.launch_counts()["kernel_matmul"]
    say(f"[minibatch] server ladder {server.ladder}: {server.trace_count} graphs captured in "
        f"{sum(warm.values()):.4f} s (" + ", ".join(f"{r}: {s:.4f}" for r, s in warm.items())
        + f"); B2 launches at warmup {b2_warm}")
    check(server.trace_count == len(server.ladder) == 6 and b2_warm == 2 * len(server.ladder),
          f"warmup captured {server.trace_count} graphs with {b2_warm} B2 launches, not 6 and "
          "12 (one eager and one captured launch a rung)")

    def served_alone(model, outs, tag):
        """Requests whose served rows are not bit-equal to predict alone."""
        bad = [i for i, (r, o) in enumerate(zip(trace, outs))
               if not np.array_equal(o, model.predict(torch.from_numpy(r).to(DEVICE)).cpu()
                                     .numpy())]
        say(f"[minibatch] {tag}: {len(trace)} requests, {len(bad)} not bit-equal to predict of "
            "the request alone" + (f" (first {bad[:5]})" if bad else ""))
        return bad

    outs = []
    for i in range(0, len(trace), len(trace) // 4):        # several flushes
        outs += server.predict_many(trace[i:i + len(trace) // 4])
    check(not served_alone(est, outs, "served, 4 flushes"), "a served request differs from "
          "predict of it alone")
    runs: dict = {"coalesced": [], "per-request": []}
    lat: dict = {}
    for name in ("coalesced", "per-request", "per-request", "coalesced"):   # in turns
        if name == "coalesced":
            server.stats.dispatch_seconds.clear()
            b2 = km.launch_counts()["kernel_matmul"]
            t0 = time.perf_counter()
            server.predict_many(trace)
            runs[name].append(time.perf_counter() - t0)
            lat[name] = list(server.stats.dispatch_seconds)
            check(km.launch_counts()["kernel_matmul"] == b2,
                  "a dispatch launched B2 from Python instead of replaying its graph")
        else:
            secs = serve_per_request(est, trace)
            runs[name].append(sum(secs))
            lat[name] = secs
    st = server.stats
    for name, secs in runs.items():
        q = np.percentile(np.asarray(lat[name]) * 1e3, [50, 99])
        say(f"[minibatch] {card}: {name}: {len(trace)} requests ({nrows} rows) in "
            + " / ".join(f"{s:.4f}" for s in secs) + f" s: {len(trace) / min(secs):.1f} "
            f"requests/s, {nrows / min(secs):.0f} rows/s; per "
            + ("dispatch" if name == "coalesced" else "request") + f" p50 {q[0]:.4f} ms, p99 "
            f"{q[1]:.4f} ms")
    say(f"[minibatch] server stats: {st.dispatches} dispatches, {st.requests} requests, pad "
        f"fraction {st.pad_fraction:.4f}; coalesced / per-request "
        f"{min(runs['coalesced']) / min(runs['per-request']):.4f}")
    server.swap_model(new)
    outs = server.predict_many(trace)
    check(not served_alone(new, outs, "after swap_model(partial_fit's model)"),
          "a request served after the swap differs from the new model's predict")
    check(server.retraces_since_warmup() == 0,
          f"{server.retraces_since_warmup()} captures after warmup")
    say(f"[minibatch] captures after warmup, 8 flushes and a swap: "
        f"{server.retraces_since_warmup()}")

    # the lam path, served stacked
    pres = path["served"]
    pserver = CoalescingPredictServer(pres, max_batch=SERVE_BATCH)
    km.reset_launch_counts()
    pserver.warmup()
    b2_path = km.launch_counts()["kernel_matmul"]
    sub = trace[:200]
    pouts = pserver.predict_many(sub)
    Xcat = torch.from_numpy(np.concatenate(sub)).to(DEVICE)
    got = torch.from_numpy(np.concatenate(pouts)).to(DEVICE)
    A = torch.stack([e.alpha for e in pres.estimators], dim=1)
    S = km.kernel_matmul_plain(Xcat, C, A.abs(), spec=spec).amax(dim=0)
    worst, bit = 0.0, True
    for i, e in enumerate(pres.estimators):
        alone = torch.cat([e.predict(torch.from_numpy(r).to(DEVICE)) for r in sub])
        bit = bit and torch.equal(alone, got[:, i])
        worst = max(worst, float((alone - got[:, i]).abs().max() / S[i]))
    say(f"[minibatch] 8-lam path served stacked: {pserver.trace_count} captures with {b2_path} "
        f"B2 launches (2 column groups a rung, eager and captured); {len(sub)} requests against "
        f"each estimator's predict: bit-equal {bit}, worst max |diff| / max sum|terms| "
        f"{worst:.3e} (bound {SERVE_STACK_RTOL:g}); captures after warmup "
        f"{pserver.retraces_since_warmup()}")
    check(b2_path == 4 * len(pserver.ladder) and worst <= SERVE_STACK_RTOL
          and pserver.retraces_since_warmup() == 0, "the stacked path tier is off")
    del pserver, Xcat, got

    # a scoring cache, refused once the model is swapped
    Xs = Xt[:SCORING_ROWS]
    cache = new.build_knm_cache(Xs, tier="device")
    server.attach_scoring_cache(cache)
    sc = torch.from_numpy(server.predict_scoring_set()).to(DEVICE)
    pb = km.kernel_matmul(Xs, C, new.alpha, spec=spec)     # new.predict(Xs) would hit the cache
    S = float(km.kernel_matmul_plain(Xs, C, new.alpha.abs()[:, None], spec=spec).max())
    diff = float((sc.double() - pb.double()).abs().max())
    server.swap_model(est)
    try:
        server.predict_scoring_set()
        refused = False
    except RuntimeError:
        refused = True
    try:
        cache.check_serves(new.centers)
        stale = False
    except ValueError:
        stale = True
    say(f"[minibatch] scoring cache over {SCORING_ROWS} rows: served vs B2 max abs err "
        f"{diff:.3e} (limit 2 x {PRED_RTOL:g} x {S:.4e}); after a swap detached: {refused}, "
        f"refuses as stale: {stale}; captures after warmup {server.retraces_since_warmup()}")
    check(diff <= 2 * PRED_RTOL * S and refused and stale
          and server.retraces_since_warmup() == 0, "the scoring cache was not refused")
    del cache, sc, pb

    phase_minibatch_small(torch, args, main)

    # the kernels line's rows: B1 at the mini-batch chunk, B2 at rungs 8 and 256
    rows = []
    Xc = X[:c]
    u = torch.randn(M, generator=torch.Generator(device=DEVICE).manual_seed(23), device=DEVICE)
    sweep = lambda: km.fused_sweep(Xc, C, u, spec=spec)
    abs_err, ratio = close_err(sweep(), km.fused_sweep_plain(Xc, C, u[:, None], None,
                                                             spec=spec)[0][:, 0])
    check(ratio <= 1.0, f"B1 at the mini-batch chunk disagrees with its twin (ratio {ratio})")
    ms = time_cuda(torch, sweep, 50)
    plain = time_cuda(torch, lambda: km.fused_sweep_plain(Xc, C, u[:, None], None, spec=spec), 5)
    b, by = bound(c * M * (2 * d + 10 + 4), 4 * (c * d + M * d + 2 * M))
    say(f"[minibatch] {card}: B1 at the chunk n={c} M={M} d={d}: kernel {ms:.4f} ms, twin "
        f"{plain:.4f} ms, bound {b:.4f} ms ({by}); max abs err {abs_err:.3e} (ratio "
        f"{ratio:.4f})")
    rows.append(dict(name="fused_sweep_mb", base="fused_sweep", ms=ms, plain_ms=plain,
                     bound_ms=b, bound_by=by, max_abs_err=abs_err,
                     launches=counts["fused_sweep"], shape=f"n={c} M={M} d={d} p=1"))
    alpha = est.alpha
    for m in (8, 256):
        Xr = Xt[:m].contiguous()
        mm = lambda: km.kernel_matmul(Xr, C, alpha, spec=spec)
        out = mm()
        ref = km.kernel_matmul_plain(Xr, C, alpha[:, None], spec=spec)[:, 0]
        S = float(km.kernel_matmul_plain(Xr, C, alpha.abs()[:, None], spec=spec).max())
        abs_err = float((out.double() - ref.double()).abs().max())
        check(abs_err <= PRED_RTOL * S, f"B2 at rung {m} off its twin ({abs_err:.3e})")
        ms = time_cuda(torch, mm, 50)
        plain = time_cuda(torch, lambda: km.kernel_matmul_plain(Xr, C, alpha[:, None],
                                                                spec=spec), 10)
        replay = time_cuda(torch, lambda: server._rungs[m].graph.replay(), 50)
        b, by = bound(m * M * (2 * d + 10 + 2), 4 * (m * d + M * d + M + m))
        say(f"[minibatch] {card}: B2 at rung {m} (n={M} d={d}): kernel {ms:.4f} ms, its "
            f"captured graph replayed {replay:.4f} ms, twin {plain:.4f} ms, bound {b:.5f} ms "
            f"({by}); max abs err {abs_err:.3e} (limit {PRED_RTOL:g} x {S:.4e}); "
            f"{server.stats.rung_dispatches[m]} replays served in this phase")
        # the main path runs B2 here as its rung's graph: the replay is its
        # time (an eager call at this size is mostly the host's launch work)
        rows.append(dict(name=f"kernel_matmul_rung{m}", base="kernel_matmul", ms=replay,
                         plain_ms=plain, bound_ms=b, bound_by=by, max_abs_err=abs_err,
                         launches=b2_warm // len(server.ladder),
                         replays=server.stats.rung_dispatches[m],
                         shape=f"m={m} n={M} d={d} p=1, timed as its graph's replay"))
    del server, new
    main.pop("est")
    torch.cuda.empty_cache()
    say(f"[minibatch] phase {time.perf_counter() - t_phase:.1f} s")
    return rows


def phase_minibatch_small(torch, args, main) -> None:
    """The mini-batch checks at n = 20,000, M = 500, lam = 1e-3 on the main
    fit's SUSY rows (small, so that the plain twins are cheap): the "cuda"
    and "torch" backends' ``minibatch_solve`` against a float64 one on one
    fixed step size (shuffle=False), the full-batch fixed point of a
    40-iteration CG fit, and that fit's ``partial_fit`` on the next 20,000
    rows against the "torch" backend's and a float64 one."""
    from repro_torch.core import (FalkonConfig, FalkonEstimator, MinibatchConfig, falkon_fit,
                                  make_preconditioner, minibatch_solve)
    from repro_torch.core.minibatch import estimate_step_size
    from repro_torch.kernels import kernel_matvec as km
    from repro_torch.ops import get_ops
    X, y, Xt, spec, task, est = (main[k] for k in ("X", "y", "Xt", "spec", "task", "est"))
    mb = MinibatchConfig()
    c, k = mb.chunk_rows, mb.project_every
    ns, ms_, lam_s = STREAM_SMALL
    Xs, ys, Xts = X[:ns], y[:ns], Xt[:ns]
    gsel = torch.Generator(device=DEVICE).manual_seed(args.seed + 3)
    Cs = Xs[torch.randperm(ns, generator=gsel, device=DEVICE)[:ms_]]
    ops_c, ops_t = (get_ops(i, est.kernel) for i in ("cuda", "torch"))
    P32 = make_preconditioner(ops_c.gram(Cs, Cs), lam_s, ns)
    P64 = make_preconditioner(ops_t.gram(Cs.double(), Cs.double()), lam_s, ns)
    eta = float(estimate_step_size(ops_t, Cs.double(), P64, lam_s, Xs[:c].double(), None))
    mbs = MinibatchConfig(shuffle=False, step_size=eta)
    alphas = {"cuda": minibatch_solve(Xs, ys, Cs, P32, lam_s, mbs, ops=ops_c).alpha,
              "torch": minibatch_solve(Xs, ys, Cs, P32, lam_s, mbs, ops=ops_t).alpha,
              "float64": minibatch_solve(Xs.double(), ys.double(), Cs.double(), P64, lam_s, mbs,
                                         ops=ops_t).alpha}
    pr = {key: km.kernel_matmul_plain(Xts.double(), Cs.double(), a.double()[:, None],
                                      spec=spec)[:, 0] for key, a in alphas.items()}
    r_ct, r_c64, r_t64 = (rel(pr[a], pr[b]) for a, b in (("cuda", "torch"),
                                                          ("cuda", "float64"),
                                                          ("torch", "float64")))
    small = susy_config(FalkonConfig, task, num_centers=ms_, lam=lam_s, iterations=40,
                        estimate_cond=False)
    est_s = falkon_fit(args.seed, Xs, ys, small)[0]
    before_p = est_s.predict(Xts)
    fixed = MinibatchConfig(chunk_rows=ns, project_every=1, epochs=3, momentum=0.0,
                            avg_start=1.0, shuffle=False)
    moved = float((est_s.partial_fit(Xs, ys, fixed).predict(Xts) - before_p).abs().max()
                  / before_p.abs().max())
    say(f"[minibatch] n={ns} M={ms_} lam={lam_s:g}, shuffle=False, step {eta:.6g}: predictions "
        f"cuda vs torch backend rel {r_ct:.3e}, cuda vs float64 {r_c64:.3e}, torch vs float64 "
        f"{r_t64:.3e} (bound {MB_SMALL_TOL:g}); the full-batch period moves a 40-iteration CG "
        f"fit's predictions by {moved:.3e} of their largest (bound {MB_FIXED_TOL:g})")
    check(max(r_ct, r_c64, r_t64) <= MB_SMALL_TOL, "the small mini-batch solves disagree")
    check(moved <= MB_FIXED_TOL, "an exact solve is not a fixed point of the full-batch period")
    # partial_fit on the next ns rows, which the fit has not seen: the
    # card's refresh (B1 at 2048-row chunks, the warm start through
    # beta_of_coeffs) against the "torch" backend's and a float64 one,
    # on one fixed step size, shuffle=False
    Xn, yn = X[ns:2 * ns], y[ns:2 * ns]
    C64 = est_s.centers.double()
    P64s = make_preconditioner(ops_t.gram(C64, C64), lam_s, ns)
    eta_s = float(estimate_step_size(ops_t, C64, P64s, lam_s, Xn[:c].double(), None))
    tail_mb = MinibatchConfig(shuffle=False, step_size=eta_s)
    twins = {"cuda": est_s,
             "torch": FalkonEstimator(est_s.centers, est_s.alpha, est_s.kernel, ops_impl="torch",
                                      precond=est_s.precond, lam=lam_s),
             "float64": FalkonEstimator(C64, est_s.alpha.double(), est_s.kernel,
                                        ops_impl="torch", precond=P64s, lam=lam_s)}
    km.reset_launch_counts()
    refreshed = {key: e.partial_fit(Xn, yn, tail_mb).alpha for key, e in twins.items()}
    b1_pf = km.launch_counts()["fused_sweep"]
    pr = {key: km.kernel_matmul_plain(Xts.double(), C64, a.double()[:, None], spec=spec)[:, 0]
          for key, a in refreshed.items()}
    pr_before = km.kernel_matmul_plain(Xts.double(), C64, est_s.alpha.double()[:, None],
                                       spec=spec)[:, 0]
    p_ct, p_c64, p_t64 = (rel(pr[a], pr[b]) for a, b in (("cuda", "torch"),
                                                          ("cuda", "float64"),
                                                          ("torch", "float64")))
    p_move = rel(pr["cuda"], pr_before)
    say(f"[minibatch] partial_fit of that fit on the next {ns} rows (step {eta_s:.6g}, "
        f"shuffle=False, {b1_pf} B1 launches on the card): predictions moved {p_move:.3e} "
        f"(bound > {MB_PF_MOVE:g}); cuda vs torch backend rel {p_ct:.3e}, cuda vs float64 "
        f"{p_c64:.3e}, torch vs float64 {p_t64:.3e} (bound {MB_SMALL_TOL:g})")
    check(b1_pf == mb.epochs * -(-ns // (k * c)) * k,           # a given step: no pilot
          f"the card's partial_fit launched B1 {b1_pf} times")
    check(max(p_ct, p_c64, p_t64) <= MB_SMALL_TOL and p_move > MB_PF_MOVE,
          "the small partial_fits disagree, or the refresh did not move the model")


def mesh_single(torch, args, main) -> dict:
    """The single-device counterparts of the mesh phase's fit variants, in
    this process before any rank starts: the 8-lam path and the device-tier
    cached fit on the first MESH_N rows (centers from the seed), the
    streamed fit on those rows and the default mini-batch fit on the first
    MESH_MB_N rows (the main fit's centers). Their predictions over the
    test rows, counts and solve seconds, for the ranks' fits to be held
    against."""
    from repro_torch.core import FalkonConfig
    from repro_torch.ops import CountingOps
    cfg = susy_config(FalkonConfig, main["task"])
    out = {}
    for tag, fit in mesh_variants(torch, args.seed, main, cfg):
        ops = CountingOps(cfg.make_ops())
        times: dict = {}
        torch.cuda.synchronize()
        res = fit(ops, times)
        torch.cuda.synchronize()
        out[tag] = dict(res, counts=facade_counts(ops), solve=times["solve"])
        say(f"[mesh] one device, {tag}: solve {times['solve']:.4f} s, facade "
            f"{out[tag]['counts']}")
        del res
        torch.cuda.empty_cache()
    return out


def facade_counts(ops) -> dict:
    return dict(sweeps=ops.sweeps, applies=ops.applies, grams=ops.grams,
                materializes=ops.materializes, gemm_sweeps=ops.gemm_sweeps)


def mesh_variants(torch, seed: int, data: dict, cfg):
    """(tag, fit(ops, stage_times) -> {alpha, pred, err[, scores]}) of each
    fit variant, the same call on one device and under the mesh (``cfg``
    carries it): the 8-lam path, the streamed fit, the device-tier cached
    fit (each on the first MESH_N rows), the default mini-batch fit (on
    the first MESH_MB_N) and the in-core fit at lam = MESH_WELL_POSED_LAM
    on the first MESH_N rows; the streamed and mini-batch fits on the main
    fit's centers, the others on the seed's."""
    from repro_torch.core import (MinibatchConfig, falkon_fit, falkon_fit_minibatch,
                                  falkon_fit_path, falkon_fit_streaming)
    from repro_torch.data import ArrayChunkSource
    X, y, Xt, yt, C = (data[k] for k in ("X", "y", "Xt", "yt", "centers"))
    n, nm = min(MESH_N, X.shape[0]), min(MESH_MB_N, X.shape[0])

    def scored(est):
        pred = est.predict(Xt)
        return dict(alpha=est.alpha.cpu(), pred=pred.cpu(), err=sign_err(torch, pred, yt))

    def path(ops, times):
        res = falkon_fit_path(seed, X[:n], y[:n], cfg, PATH_LAMS, X_val=Xt, y_val=yt, ops=ops,
                              stage_times=times)
        preds = torch.stack([e.predict(Xt) for e in res.estimators])
        return dict(alpha=res.state.alphas.cpu(), pred=preds.cpu(),
                    scores=res.val_scores.cpu(), err=[sign_err(torch, p, yt) for p in preds])

    def stream(ops, times):
        src = ArrayChunkSource(X[:n].cpu().numpy(), y[:n].cpu().numpy(),
                               chunk_rows=STREAM_CHUNK)
        return scored(falkon_fit_streaming(seed, src, cfg, centers=C, ops=ops,
                                           stage_times=times)[0])

    def cached(ops, times):
        c = dataclasses.replace(cfg, knm_cache="device")
        return scored(falkon_fit(seed, X[:n], y[:n], c, ops=ops, stage_times=times)[0])

    def minibatch(ops, times):
        return scored(falkon_fit_minibatch(seed, X[:nm], y[:nm], cfg, MinibatchConfig(),
                                           centers=C, ops=ops, stage_times=times)[0])

    def posed(ops, times):
        c = dataclasses.replace(cfg, lam=MESH_WELL_POSED_LAM)
        return scored(falkon_fit(seed, X[:n], y[:n], c, ops=ops, stage_times=times)[0])

    return (("path", path), ("stream", stream), ("cache", cached), ("minibatch", minibatch),
            ("lam1e-3", posed))


def phase_mesh(torch, args, main, card: str) -> None:
    """Multi-device FALKON (A14) on the one card: ``FalkonConfig(mesh=...)``
    over ``DistributedOps``. The kernel library is built already (no rank
    compiles; a rank refuses to start without it). First a world of one
    NCCL rank in a fresh process: the SUSY fit through the mesh, bit-equal
    to the main fit with 47 all-reduces and 47 B1 launches. Then one spawn
    of MESH_RANKS gloo ranks sharing the card (``file://`` rendezvous), in
    turn: the SUSY fit at full size (47 all-reduces of 10^4 floats, 47 B1
    launches of 10^6 rows a rank, alpha bit-equal across the ranks,
    predictions within MESH_PRED_TOL and test error within MESH_ERR of the
    main fit's), the ragged sweep (n - 3 rows: junk rows under a mask
    bit-equal to the internal zero padding), ``apply`` bit-equal to the
    wrapped backend's, the int8 wire (relative error in MESH_INT8), and the
    path, streamed, cached and mini-batch fits against the same fits on one
    device (``mesh_single``, run here first): predictions within
    MESH_PRED_TOL, test errors within MESH_ERR, the facade counts equal and
    one all-reduce a sweep. Prints the stage seconds, the all-reduce time a
    sweep and the device peak of every rank. A rank that fails or a world
    past MESH_TIMEOUT fails the phase."""
    import tempfile
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()      # the cache phase left device memory reserved
    single = mesh_single(torch, args, main)
    torch.cuda.empty_cache()
    say(f"[mesh] {card}: the single-device fits took {time.perf_counter() - t_phase:.1f} s; "
        f"this process holds {torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        one = run_world(args, "nccl", 1, d)[0]
        alpha = main["alpha"].cpu()
        say(f"[mesh] NCCL world of one: solve {one['times']['solve']:.4f} s (main fit "
            f"{main['times']['solve']:.4f}; the first all-reduce, timed apart, "
            f"{one['setup_s']:.4f} s); all-reduces {one['psums']} of "
            f"{one['psum_floats']} floats, sweeps {one['sweeps']}, B1 launches {one['b1']}; "
            f"alpha bit-equal to the main fit's: {torch.equal(one['alpha'], alpha)}")
        check(torch.equal(one["alpha"], alpha) and one["alpha"].numpy().tobytes()
              == alpha.numpy().tobytes(), "the 1-rank NCCL mesh fit's alpha differs from the "
              "main fit's")
        check(one["psums"] == one["sweeps"] == one["b1"] == 47
              and one["psum_floats"] == 47 * alpha.shape[0],
              f"the 1-rank mesh fit: {one['psums']} all-reduces, {one['sweeps']} sweeps, "
              f"{one['b1']} B1 launches")
        ranks = run_world(args, "gloo", MESH_RANKS, d)
    mesh_report(torch, main, single, ranks)
    say(f"[mesh] phase {time.perf_counter() - t_phase:.1f} s")


def run_world(args, backend: str, world: int, d: Path) -> list[dict]:
    """Start ``world`` ranks of this script (``--mesh-worker``), wait for all
    of them within MESH_TIMEOUT, print their logs and return their results.
    A rank that exits non-zero or a world past its time fails the smoke;
    every rank is killed before this returns."""
    import torch
    cmd = [sys.executable, str(Path(__file__).resolve()), "--seed", str(args.seed), "--n",
           str(args.n), "--n-test", str(args.n_test)]
    logs = [d / f"{backend}_{r}.log" for r in range(world)]
    procs = []
    t0 = time.perf_counter()
    try:
        for r, log in enumerate(logs):
            with open(log, "w") as fh:
                procs.append(subprocess.Popen(
                    cmd + ["--mesh-worker", backend, str(r), str(world), str(d)],
                    stdout=fh, stderr=subprocess.STDOUT, cwd=Path(__file__).resolve().parent))
        late = None
        for p in procs:
            try:
                p.wait(timeout=max(MESH_TIMEOUT - (time.perf_counter() - t0), 1.0))
            except subprocess.TimeoutExpired:
                late = p
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for log in logs:
        for line in log.read_text().splitlines():
            say(f"[mesh {backend} {log.stem}] {line}")
    check(late is None, f"the {backend} world of {world} overran its {MESH_TIMEOUT} s")
    codes = [p.returncode for p in procs]
    check(all(c == 0 for c in codes), f"the {backend} world's ranks exited {codes}")
    say(f"[mesh] the {backend} world of {world} took {time.perf_counter() - t0:.1f} s")
    return [torch.load(d / f"{backend}_{r}.pt", weights_only=True) for r in range(world)]


def mesh_report(torch, main, single: dict, ranks: list[dict]) -> None:
    """Hold the gloo world's results (``mesh_world``) against each other, the
    main fit and the single-device fits, print every reading, then fail on
    every check that did not hold."""
    r0 = ranks[0]
    M = main["alpha"].shape[0]
    fails: list[str] = []

    def need(cond: bool, msg: str) -> None:
        if not cond:
            fails.append(msg)

    need(all(torch.equal(r["centers"], main["centers"].cpu()) for r in ranks),
         "a rank drew other centers than the main fit's")
    for tag in ("susy",) + tuple(single):
        a = r0[tag]["alpha"].numpy().tobytes()
        need(all(r[tag]["alpha"].numpy().tobytes() == a for r in ranks),
             f"the {tag} mesh fit's alpha differs across the ranks")
    s = r0["susy"]
    pr, de = rel(s["pred"], main["pred"].cpu()), abs(s["err"] - main["err"])
    say(f"[mesh] gloo x{len(ranks)}, SUSY n={main['X'].shape[0]}: alpha bit-equal on every "
        f"rank; predictions {pr:.4e} from the main fit's (bound {MESH_PRED_TOL['susy']:g}); "
        f"test error {s['err']:.6f} vs {main['err']:.6f} (bound {MESH_ERR} apart); solve "
        f"{s['times']['solve']:.4f} s vs {main['times']['solve']:.4f} s")
    need(pr <= MESH_PRED_TOL["susy"] and de <= MESH_ERR, "the 4-rank SUSY fit is off the main "
         f"fit: predictions {pr:.4e}, test error {de:.6f} apart")
    for i, r in enumerate(ranks):
        s = r["susy"]
        say(f"[mesh] rank {i}: shard {r['shard']}, SUSY stage seconds " + ", ".join(
            f"{k} {v:.4f}" for k, v in s["times"].items()) + f"; all-reduce of {M} floats "
            f"{r['allreduce_ms']:.4f} ms (gloo, {MESH_ALLREDUCE_REPS} reps, first "
            f"{r['setup_s']:.4f} s); device peak {s['peak'] / 2**30:.3f} GiB (SUSY), "
            + ", ".join(f"{t} {r[t]['peak'] / 2**30:.3f}" for t in single) + " GiB")
        need(s["psums"] == s["sweeps"] == s["b1"] == 47 and s["psum_floats"] == 47 * M
             and s["shapes"] == [[[main["X"].shape[0] // len(ranks), main["X"].shape[1]],
                                  "torch.float32"]],
             f"rank {i}'s SUSY fit: {s['psums']} all-reduces ({s['psum_floats']} floats), "
             f"{s['sweeps']} sweeps, {s['b1']} B1 launches, sweep shapes {s['shapes']}")
        need(r["ragged_bit_equal"] and r["apply_bit_equal"],
             f"rank {i}: ragged masked sweep bit-equal {r['ragged_bit_equal']}, apply "
             f"bit-equal {r['apply_bit_equal']}")
        need(MESH_INT8[0] < r["int8_rel"] < MESH_INT8[1],
             f"rank {i}: the int8 wire's relative error {r['int8_rel']}")
        for t, one in single.items():
            counts = dict(r[t]["counts"])
            psums = counts.pop("psums")
            need(counts == one["counts"] and psums == one["counts"]["sweeps"]
                 + one["counts"]["gemm_sweeps"],
                 f"rank {i}'s {t} mesh fit counts {r[t]['counts']}, one device's "
                 f"{one['counts']}")
    say(f"[mesh] ragged sweep (n - 3 rows): junk rows under a mask bit-equal to the zero "
        f"padding on every rank: {all(r['ragged_bit_equal'] for r in ranks)}; apply: each "
        f"rank's rows bit-equal to the wrapped backend's apply of them: "
        f"{all(r['apply_bit_equal'] for r in ranks)}, all rows {r0['apply_rel']:.4e} from its "
        f"apply of all rows (B2 slices the centers {r0['apply_slices'][0]}-fold at a rank's "
        f"rows, {r0['apply_slices'][1]}-fold at all); int8 wire relative error "
        f"{r0['int8_rel']:.4e} (band {MESH_INT8})")
    for t, one in single.items():
        m = r0[t]
        if t == "path":
            prs = [rel(a, b) for a, b in zip(m["pred"], one["pred"])]
            des = [abs(a - b) for a, b in zip(m["err"], one["err"])]
            say(f"[mesh] path: mesh solve {m['times']['solve']:.4f} s (rank 0) vs one device "
                f"{one['solve']:.4f} s; per lam (10^-8 up) predictions "
                + " ".join(f"{x:.3e}" for x in prs) + " apart (bounds "
                + " ".join(f"{x:g}" for x in MESH_PATH_PRED_TOL) + "), test errors "
                + " ".join(f"{x:.6f}" for x in des) + " apart (bounds "
                + " ".join(f"{x:g}" for x in MESH_PATH_ERR) + "), validation MSE "
                f"{rel(m['scores'], one['scores']):.4e} apart; facade {m['counts']}")
            need(all(x <= b for x, b in zip(prs, MESH_PATH_PRED_TOL))
                 and all(x <= b for x, b in zip(des, MESH_PATH_ERR)),
                 "the path mesh fit is off the single-device path")
            continue
        pr, de = rel(m["pred"], one["pred"]), abs(m["err"] - one["err"])
        say(f"[mesh] {t}: mesh solve {m['times']['solve']:.4f} s (rank 0) vs one device "
            f"{one['solve']:.4f} s; predictions {pr:.4e} apart (bound "
            f"{MESH_PRED_TOL[t]:g}), test error {de:.6f} from one device's (bound "
            f"{MESH_ERR}); facade {m['counts']}")
        need(pr <= MESH_PRED_TOL[t] and de <= MESH_ERR,
             f"the {t} mesh fit is off the single-device fit: predictions {pr:.4e}, test "
             f"error {de:.6f} apart")
    check(not fails, "mesh phase: " + "; ".join(fails))


def mesh_worker(torch, args) -> int:
    """One rank of the mesh phase (``--mesh-worker BACKEND RANK WORLD DIR``):
    the card, the process group (``file://`` rendezvous in DIR), a 1-D
    ``DeviceMesh`` over the world, then the world-of-one SUSY fit (NCCL) or
    ``mesh_world`` (gloo); its results to DIR/<backend>_<rank>.pt."""
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.distributed import data_group
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_mesh
    backend, rank, world, d = args.mesh_worker
    rank, world, d = int(rank), int(world), Path(d)
    check(torch.cuda.is_available(), "a mesh rank needs the card")
    check(build.library().exists(), f"rank {rank}: no kernel library at {build.library()}; "
          "the smoke builds it before it starts the ranks")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"file://{d / ('store_' + backend)}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=MESH_TIMEOUT))
    try:
        mesh = make_mesh((world,), ("data",), device_type=DEVICE)
        # the data group's first all-reduce sets up its communicator (NCCL
        # lazily): timed apart, so that no fit's solve pays it
        group = data_group(mesh, ("data",))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(torch.zeros(1, device=DEVICE), group=group)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        fn = mesh_one if backend == "nccl" else mesh_world
        torch.save(dict(fn(torch, args, mesh, rank), setup_s=setup_s),
                   d / f"{backend}_{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


def mesh_fit(torch, fit, mesh, cfg):
    """Run ``fit(ops, stage_times)`` under the mesh with a ``CountingOps``
    inside the ``DistributedOps`` (what ``FalkonConfig(mesh=...)`` resolves
    a counting facade to): (its result, the facade and all-reduce counts,
    the B1 launches, the sweeps' X shapes, the stage seconds, the device
    peak)."""
    from repro_torch.kernels import kernel_matvec as km
    from repro_torch.ops import CountingOps, DistributedOps, get_ops
    inner = CountingOps(get_ops(cfg.ops_impl, cfg.make_kernel(), block_size=cfg.block_size,
                                precision=cfg.precision))
    ops = DistributedOps(inner, mesh, cfg.data_axes)
    times: dict = {}
    km.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = fit(ops, times)
    torch.cuda.synchronize()
    counts = dict(facade_counts(inner), psums=ops.psums)
    return res, dict(counts=counts, psums=ops.psums, psum_floats=ops.psum_floats,
                     sweeps=inner.sweeps, b1=km.launch_counts()["fused_sweep"],
                     shapes=sorted([list(s), str(t)] for s, t in inner.sweep_shapes),
                     times={k: v for k, v in times.items() if isinstance(v, float)},
                     peak=torch.cuda.max_memory_allocated())


def mesh_one(torch, args, mesh, rank: int) -> dict:
    """The world of one: the SUSY fit through ``FalkonConfig(mesh=...)``."""
    from repro_torch.core import FalkonConfig, falkon_fit
    task, X, y, _, _ = make_susy(torch, args.seed, args.n, args.n_test)
    cfg = susy_config(FalkonConfig, task, mesh=mesh)
    (est, st), info = mesh_fit(torch, lambda ops, times: falkon_fit(
        args.seed, X, y, cfg, ops=ops, stage_times=times), mesh, cfg)
    say(f"rank {rank}: SUSY fit, {info['psums']} all-reduces, {info['b1']} B1 launches")
    return dict(info, alpha=st.alpha.cpu())


def mesh_world(torch, args, mesh, rank: int) -> dict:
    """A gloo rank: the SUSY fit at full size, the ragged sweep, ``apply``,
    the int8 wire, the fit variants of ``mesh_variants`` and the all-reduce
    time."""
    import torch.distributed as dist

    from repro_torch.core import FalkonConfig, falkon_fit
    from repro_torch.kernels import kernel_matvec as km
    from repro_torch.ops import DistributedOps, get_ops
    task, X, y, Xt, yt = make_susy(torch, args.seed, args.n, args.n_test)
    cfg = susy_config(FalkonConfig, task, mesh=mesh)
    out = {}
    (est, st), info = mesh_fit(torch, lambda ops, times: falkon_fit(
        args.seed, X, y, cfg, ops=ops, stage_times=times), mesh, cfg)
    pred = est.predict(Xt)
    out["susy"] = dict(info, alpha=st.alpha.cpu(), pred=pred.cpu(), err=sign_err(torch, pred, yt))
    out["centers"] = est.centers.cpu()
    say(f"rank {rank}: SUSY fit, {info['psums']} all-reduces, {info['b1']} B1 launches, "
        f"solve {info['times']['solve']:.4f} s")

    C, alpha = est.centers, st.alpha
    inner = get_ops("cuda", est.kernel)
    ops = DistributedOps(inner, mesh, ("data",))
    out["shard"] = (ops.shard_index, ops.num_shards)
    g = torch.Generator(device=DEVICE).manual_seed(args.seed + 7)
    u = torch.randn(C.shape[0], generator=g, device=DEVICE)
    v = torch.randn(X.shape[0], generator=g, device=DEVICE)
    n = X.shape[0] - 3
    Xj, vj = X.clone(), v.clone()
    Xj[n:] = 1e3 * torch.randn(3, X.shape[1], generator=g, device=DEVICE)
    vj[n:] = 1e6
    mask = (torch.arange(X.shape[0], device=DEVICE) < n).to(torch.float32)
    padded = ops.sweep(X[:n], C, u, v[:n])
    masked = ops.sweep(Xj, C, u, vj, row_mask=mask)
    out["ragged_bit_equal"] = bool(torch.equal(padded, masked))
    del Xj, vj
    # apply: the rank's rows of the reassembled output bit-equal to the
    # wrapped backend's apply of those rows (the reassembly adds zeros).
    # B2 picks its slices of the centers from the row count (matmul_slices),
    # so against an apply of all rows a row may sum its center tiles in
    # another grouping: that distance is printed beside the slice counts.
    full = ops.apply(Xt, C, alpha)
    rows = -(-Xt.shape[0] // ops.num_shards)
    mine = slice(ops.shard_index * rows, min((ops.shard_index + 1) * rows, Xt.shape[0]))
    out["apply_bit_equal"] = bool(torch.equal(full[mine], inner.apply(Xt[mine], C, alpha)))
    out["apply_rel"] = rel(full, inner.apply(Xt, C, alpha))
    slots = km.matmul_grid_model(1, Xt.shape[1])
    out["apply_slices"] = (km.matmul_slices(rows, C.shape[0], slots),
                           km.matmul_slices(Xt.shape[0], C.shape[0], slots))
    w = ops.sweep(X, C, u)
    w8 = DistributedOps(inner, mesh, ("data",), compress="int8").sweep(X, C, u)
    out["int8_rel"] = rel(w8, w)

    data = dict(X=X, y=y, Xt=Xt, yt=yt, centers=C)
    for tag, fit in mesh_variants(torch, args.seed, data, cfg):
        res, info = mesh_fit(torch, fit, mesh, cfg)
        out[tag] = dict(res, **info)
        say(f"rank {rank}: {tag} fit, {info['psums']} all-reduces, solve "
            f"{info['times']['solve']:.4f} s, device peak {info['peak'] / 2**30:.3f} GiB")
        torch.cuda.empty_cache()

    wr = torch.randn(C.shape[0], generator=g, device=DEVICE)
    for _ in range(5):
        dist.all_reduce(wr, group=ops.group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MESH_ALLREDUCE_REPS):
        dist.all_reduce(wr, group=ops.group)
    torch.cuda.synchronize()
    out["allreduce_ms"] = (time.perf_counter() - t0) / MESH_ALLREDUCE_REPS * 1e3
    return out


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


def sweep_witness(torch, km, spec, X, C, u, tag: str, kernels=None,
                  twin_factor: float | None = None):
    """Sweep kernels against a float64 twin, entry by entry (gaussian).

    fp32 rounding in w = K^T (K u) scales with S = K^T K |u| (K >= 0), which
    bounds the magnitudes of the terms of both sums: w cancels to far below
    S, and a per-center rounding (of ||c_j||^2, say) moves every term of
    that center together. Each |w_j - w64_j| is held to PRED_RTOL * S_j.
    ``u`` is (M,) or (M, p); ``kernels`` maps a name to a callable giving
    that kernel's w (default: B1). With ``twin_factor``, for inputs at
    which the float32 twin itself misses that bound (features of large norm
    against a narrow kernel: each entry's exponent cancels in fp32), a
    kernel is held instead to within ``twin_factor`` times the twin's own
    distance. Returns ({name: kernel result}, float32 twin result)."""
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
        bar = 1.0 if twin_factor is None else max(1.0, twin_factor * rt)
        if bar > 1.0:
            say(f"[sweep] {tag} {name}: the float32 twin misses the bound, so the kernel is "
                f"held to {twin_factor:g} x the twin's ratio: {bar:.4f}")
        check(rk <= bar, f"sweep {tag} {name}: off a float64 twin by {rk:.3f} x its limit")
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


def make_lm(ModelConfig, d_model: int, layers: int, vocab: int):
    """``examples/train_lm_falkon_head.py``'s ``make_lm``: a dense fp32 LM."""
    return ModelConfig(name=f"lm-{d_model}x{layers}", family="dense", n_layers=layers,
                       d_model=d_model, n_heads=max(4, d_model // 64),
                       n_kv_heads=max(2, d_model // 128), d_head=64, d_ff=4 * d_model,
                       vocab=vocab, vocab_pad_multiple=64, dtype="float32", remat="none",
                       dense_attn_max_seq=4096)


def phase_train(torch, args, card: str) -> list[dict]:
    """LM training (A15.2; see the module doc, phase ``train``). Returns the
    kernels line's rows of B1, B2 and B3 at the trained head's shapes."""
    import tempfile

    from repro_torch.checkpoint import step_dir
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import FalkonConfig, falkon_fit
    from repro_torch.data import TokenStreamConfig, token_stream
    from repro_torch.kernels import kernel_matvec as km
    from repro_torch.models.model import _backbone
    from repro_torch.optim import tree_leaves
    from repro_torch.train import TrainConfig, Trainer, TrainerConfig, state_tree

    t_phase = time.perf_counter()
    cfg = make_lm(ModelConfig, *TRAIN_LM)
    tcfg = TrainConfig(**TRAIN_CFG)
    n_params = cfg.param_count()

    # (a) the example's recipe: train, resume, then the head on its features
    km.reset_launch_counts()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        rcfg = TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=TRAIN_CKPT_EVERY)
        trainer = Trainer(cfg, tcfg, rcfg, device=DEVICE)
        stream = token_stream(TokenStreamConfig(**TRAIN_STREAM), device=DEVICE)
        t0 = time.perf_counter()
        hist = trainer.fit(stream, steps=TRAIN_STEPS)
        t_fit = time.perf_counter() - t0
        first, last = hist[0]["loss"], hist[-1]["loss"]
        steps_ms = [1e3 * t for t in trainer.step_seconds]
        with open(os.path.join(step_dir(ckpt_dir, TRAIN_STEPS), "MANIFEST.json")) as f:
            manifest = json.load(f)
        kept = sorted(os.listdir(ckpt_dir))
        say(f"[train] (a) {card}: {cfg.name} ({n_params / 1e6:.2f}M parameters, fp32), "
            f"{len(hist)} steps of {TRAIN_STREAM['batch']} x {TRAIN_STREAM['seq_len']} tokens: "
            f"loss {first:.4f} -> {last:.4f} (the reference on a CPU: 6.289 -> 5.350); a step "
            f"median {statistics.median(steps_ms):.3f} ms, min {min(steps_ms):.3f}, max "
            f"{max(steps_ms):.3f} (synchronised; the first {steps_ms[0]:.3f}); fit {t_fit:.3f} s "
            f"with the token stream and 2 async saves; straggler events "
            f"{trainer.straggler_events}; checkpoints kept {kept}, codec "
            f"{manifest['codec']!r}, {len(manifest['leaves'])} leaves")
        check(len(hist) == TRAIN_STEPS and all(np.isfinite(h["loss"]) for h in hist)
              and last < first, f"the example's LM did not learn ({first:.4f} -> {last:.4f})")
        check(manifest["step"] == TRAIN_STEPS and kept == [os.path.basename(step_dir(
            ckpt_dir, s)) for s in (TRAIN_CKPT_EVERY, TRAIN_STEPS)], "the checkpoints are off")
        again = Trainer(cfg, tcfg, rcfg, device=DEVICE)
        mine = tree_leaves(state_tree(trainer.state, cfg))
        theirs = tree_leaves(state_tree(again.state, cfg))
        bit_equal = len(mine) == len(theirs) and all(
            a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(mine, theirs))
        say(f"[train] (a) a second Trainer on the same directory resumed at step "
            f"{int(again.state.step)}: all {len(mine)} leaves of the state (parameters, AdamW "
            f"moments, step) bit-equal to the first's: {bit_equal}")
        check(int(again.state.step) == TRAIN_STEPS and bit_equal,
              "the resumed Trainer differs from the one that saved")
        model = trainer.state.params
        del again, trainer

    stream = token_stream(TokenStreamConfig(**TRAIN_STREAM), seed=7, device=DEVICE)
    feats, labels = [], []
    with torch.no_grad():
        for _ in range(TRAIN_HEAD_BATCHES):
            b = next(stream)
            feats.append(_backbone(model, cfg, {"tokens": b["tokens"]}).reshape(-1, cfg.d_model))
            labels.append(b["tokens"].reshape(-1).long() % 8)
    X, ylab = torch.cat(feats), torch.cat(labels)
    n, d = X.shape
    ntr = int(0.8 * n)
    Xtr, Xte, Y = X[:ntr], X[ntr:], torch.nn.functional.one_hot(ylab, 8).float()
    check(bool(torch.isfinite(X).all()) and X.dtype == torch.float32,
          "the trained LM's features are malformed")
    t0 = time.perf_counter()
    est, state = falkon_fit(args.seed, Xtr, Y[:ntr],
                            FalkonConfig(ops_impl="cuda", device=DEVICE, **TRAIN_HEAD))
    pred = est.predict(Xte)
    torch.cuda.synchronize()
    t_head = time.perf_counter() - t0
    counts = km.launch_counts()
    acc = float((pred.argmax(-1) == ylab[ntr:]).float().mean())
    t_it, p = TRAIN_HEAD["iterations"], Y.shape[1]
    groups = -(-p // km.MAX_P)
    want = {"pairwise_kernel": 1, "fused_sweep": (1 + t_it) * groups + 26,
            "kernel_matmul": groups}
    say(f"[train] (a) {card}: head on the trained features, n={ntr} M="
        f"{TRAIN_HEAD['num_centers']} d={d} p={p} sigma 4 lam {TRAIN_HEAD['lam']:g} t={t_it}: "
        f"fit + predict {t_head:.3f} s; accuracy {acc:.4f} on {n - ntr} rows (the example's bar "
        f"{TRAIN_ACC}; the reference on a CPU read {TRAIN_REF_ACC}; chance 0.125); cond(W) "
        f"{float(state.cond_estimate):.2f}; launches on the main path (train, features, fit, "
        f"predict) {counts} (want {want})")
    check(acc > TRAIN_ACC, f"the trained LM's head reads {acc:.4f}, not above {TRAIN_ACC}")
    for name, v in want.items():
        check(counts[name] == v, f"{name}: {counts[name]} launches on the train path, want {v}")
    check(counts["sharded_sweep"] == 0, "the trained head's sweeps left B1")
    est_t, _ = falkon_fit(args.seed, Xtr, Y[:ntr],
                          FalkonConfig(ops_impl="torch", device=DEVICE, **TRAIN_HEAD))
    pred_t = est_t.predict(Xte)
    same = torch.equal(est_t.centers, est.centers)
    prel = float(torch.linalg.norm((pred_t - pred).double()) / torch.linalg.norm(pred.double()))
    agree = float((pred_t.argmax(-1) == pred.argmax(-1)).float().mean())
    acc_t = float((pred_t.argmax(-1) == ylab[ntr:]).float().mean())
    say(f"[train] (a) the same head on the \"torch\" backend: same centers {same}; predictions "
        f"vs \"cuda\" normwise {prel:.3e} (bound {LM_HEAD_PRED_TOL:g}), same class on "
        f"{agree:.4f} of rows (bound {LM_HEAD_AGREE}), accuracy {acc_t:.4f}")
    check(same and prel <= LM_HEAD_PRED_TOL and agree >= LM_HEAD_AGREE,
          "the trained head's cuda fit disagrees with its plain fit")
    norms = Xtr.square().sum(1)
    say(f"[train] (a) the trained features' squared norms: median {float(norms.median()):.2f}, "
        f"max {float(norms.max()):.2f}, against 2 sigma^2 = 32")
    rows = head_rows(torch, km, est, Xtr, Xte, counts, "trained", "[train]",
                     "the trained LM's head", card, twin_factor=AGREE_FACTOR)
    del X, Xtr, Xte, est, est_t, pred, pred_t, model
    torch.cuda.empty_cache()

    gemma_train(torch, args, card)
    say(f"[train] phase {time.perf_counter() - t_phase:.1f} s")
    return rows


def gemma_train(torch, args, card: str) -> None:
    """(b) gemma3-1b at full width: bf16 AdamW steps under remat on one
    fixed batch, then one step with microbatch=2 against microbatch=1."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.compression import _tree_map as tree_map
    from repro_torch.models import LeafGroup, loss_fn, param_tree
    from repro_torch.optim import make_optimizer, tree_leaves
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    cfg = get_config(LM_ARCH)
    check(cfg.dtype == "bfloat16" and cfg.optimizer == "adamw" and cfg.remat == "full",
          f"{cfg.name} does not train in bf16 with AdamW under remat")
    B, S, n_steps = GEMMA_TRAIN
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=n_steps)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    while True:
        try:
            g = torch.Generator(device=DEVICE).manual_seed(args.seed)
            state = init_train_state(g, cfg, tcfg)
            toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=g, device=DEVICE,
                                 dtype=torch.int32)
            batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
            step = make_train_step(cfg, tcfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step(state, batch)
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError:
            check(B > 1, f"{cfg.name} does not train at batch 1 x {S}")
            say(f"[train] (b) batch {B} x {S} does not fit; halving it")
            state = batch = met = None
            torch.cuda.empty_cache()
            B //= 2
    times, hist = [time.perf_counter() - t0], [met]
    for _ in range(n_steps - 1):
        t0 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        hist.append(met)
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    n_params = sum(p.numel() for p in state.params.parameters())
    opt_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(state.opt_state))
    loss = [float(m["loss"]) for m in hist]
    gn = [float(m["grad_norm"]) for m in hist]
    steady = statistics.median(times[1:])
    say(f"[train] (b) {card}: {cfg.name} full width ({n_params} parameters, bf16; AdamW "
        f"moments {opt_bytes / 1e9:.3f} GB fp32), remat {cfg.remat!r}, batch {B} x {S} tokens, "
        f"{n_steps} steps on one fixed batch (warmup 1): loss {[round(v, 4) for v in loss]}; "
        f"grad norm {[round(v, 4) for v in gn]}; step ms {[round(1e3 * t, 3) for t in times]} "
        f"(the first with cuBLAS's warm-up); after the first: median {1e3 * steady:.3f} ms, "
        f"{B * S / steady:.1f} tokens/s; device peak {peak:.3f} GiB above the "
        f"{held / 2**30:.3f} GiB held before it")
    check(all(np.isfinite(loss)) and loss[-1] < loss[0],
          f"{cfg.name}'s loss does not fall on its fixed batch: {loss}")

    # one step with microbatch=2 against microbatch=1, from the same state
    cmp = dataclasses.replace(tcfg, total_steps=100)
    params = list(state.params.parameters())
    before = [p.detach().clone() for p in params]
    opt_before = [x.clone() for x in tree_leaves(state.opt_state)]
    step1 = make_train_step(cfg, cmp)
    state, m1 = step1(state, batch)
    after1 = [p.detach().clone() for p in params]
    with torch.no_grad():
        for p, b in zip(params, before):
            p.copy_(b)
        for x, b in zip(tree_leaves(state.opt_state), opt_before):
            x.copy_(b)
    state = state._replace(step=state.step - 1)
    del opt_before
    step2 = make_train_step(cfg, dataclasses.replace(cmp, microbatch=2))
    state, m2 = step2(state, batch)
    torch.cuda.synchronize()
    num = sum(float(torch.sum((p.detach().float() - a.float()) ** 2))
              for p, a in zip(params, after1))
    den = sum(float(torch.sum((a.float() - b.float()) ** 2)) for a, b in zip(after1, before))
    rel = (num / den) ** 0.5
    l1, l2 = float(m1["loss"]), float(m2["loss"])
    lrel = abs(l2 - l1) / abs(l1)
    say(f"[train] (b) one step from step {n_steps} (lr {float(m1['lr']):.4e}), microbatch=2 "
        f"against microbatch=1 on the same batch: loss {l2:.6f} vs {l1:.6f} (relative "
        f"{lrel:.3e}, bound {GEMMA_MB_LOSS_RTOL:g}); grad norm {float(m2['grad_norm']):.4f} vs "
        f"{float(m1['grad_norm']):.4f}; parameters' difference / the step's change, normwise "
        f"{rel:.4f} (bound {GEMMA_MB_PARAM_REL:g})")
    check(np.isfinite(l2) and lrel <= GEMMA_MB_LOSS_RTOL and rel <= GEMMA_MB_PARAM_REL,
          "microbatch=2 disagrees with microbatch=1")
    del before, after1

    # where a step's time goes on the device: one profiled step (after a
    # warm-up step), its operations by kind and the device's idle share
    held_state = [state]

    def one_step():
        held_state[0], _ = step(held_state[0], batch)

    ops = device_ops(torch, f"{cfg.name} train step", one_step)
    check(bool(ops), f"the profiler saw no device operation of {cfg.name}'s train step")
    busy = sum(us for _, _, us in ops) / 1e3
    span = (max(t + us for _, t, us in ops) - min(t for _, t, _ in ops)) / 1e3
    kinds: dict[str, float] = {}
    names: dict[str, list] = {}
    for name, _, us in ops:
        names.setdefault(name, []).append(us)
        low = name.lower()
        kind = ("matmul" if any(k in low for k in ("gemm", "cutlass", "xmma", "sm90_", "gemv",
                                                   "nvjet"))
                else "attention" if any(k in low for k in ("flash", "fmha", "attention"))
                else "reduction" if "reduce" in low
                else "elementwise" if any(k in low for k in ("elementwise", "vectorized",
                                                              "unrolled"))
                else "other")
        kinds[kind] = kinds.get(kind, 0.0) + us / 1e3
    top = sorted(names.items(), key=lambda kv: -sum(kv[1]))[:8]
    say(f"[train] (b) {card}: one profiled step: {len(ops)} device operations, busy "
        f"{busy:.3f} ms of a {span:.3f} ms span (idle {1 - busy / span:.4f}); by kind (ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(kinds.items(), key=lambda kv: -kv[1]))
        + "; the largest: " + "; ".join(f"{n[:60]} x{len(us)} {sum(us) / 1e3:.3f} ms"
                                         for n, us in top))

    # the step's parts, each synchronised: the forward and backward alone
    # (loss_fn and autograd.grad), then one optimizer update alone; the rest
    # of a step is the gradients' stacking into the reference's leaves and
    # the clip
    state = held_state[0]
    model = state.params
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = loss_fn(model, cfg, batch)
    grads = torch.autograd.grad(loss, params)
    torch.cuda.synchronize()
    t_fb = time.perf_counter() - t0
    del loss, grads
    tree = param_tree(model, cfg)
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=p.dtype, device=p.device), tree,
                     is_leaf=lambda x: isinstance(x, (torch.Tensor, LeafGroup)))
    opt, lr = make_optimizer(cfg.optimizer), torch.tensor(1e-5, device=DEVICE)
    opt.update(zeros, state.opt_state, tree, lr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.update(zeros, state.opt_state, tree, lr)
    torch.cuda.synchronize()
    t_opt = time.perf_counter() - t0
    say(f"[train] (b) {card}: a step's parts: forward + backward {1e3 * t_fb:.3f} ms, one "
        f"AdamW update {1e3 * t_opt:.3f} ms, the rest (stacking, clip) "
        f"{1e3 * (steady - t_fb - t_opt):.3f} ms of the {1e3 * steady:.3f} ms median step")
    del state, held_state, batch, params, model, tree, zeros
    torch.cuda.empty_cache()


def phase_shard(torch, args, card: str) -> None:
    """The sharding rules (A15.3; see the module doc, phase ``shard``): (a)
    and (b) on a (1, 1) mesh of one NCCL rank; (c) runs beside (a)'s save
    and restore, which wait on the disk."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/store", rank=0, world_size=1,
                                device_id=torch.device(DEVICE, torch.cuda.current_device()))
        try:
            mesh = make_mesh((1, 1), ("data", "model"), device_type=DEVICE)
            world = []
            shard_gemma(torch, args, card, mesh, Path(d),
                        lambda: world.append(shard_world_start(Path(d))))
            shard_granite(torch, args, card, mesh)
        finally:
            dist.destroy_process_group()
            if world:
                shard_world_report(*world[0])
    gc.collect()
    torch.cuda.empty_cache()
    left = (torch.cuda.memory_allocated() - held) / 2**30
    say(f"[shard] phase {time.perf_counter() - t_phase:.1f} s; it leaves {left:.3f} GiB "
        f"allocated above the {held / 2**30:.3f} GiB it found")
    check(left < 0.5, "the shard phase left its states on the card")


def shard_gemma(torch, args, card: str, mesh, d: Path, before_save) -> None:
    """(a) gemma3-1b: SHARD_STEPS unsharded steps, then as many through
    ``Trainer(mesh=, rules=)`` from the same state on the same batch; a
    blocking save (``before_save()`` first); one more step (the
    uninterrupted run); the checkpoint restored onto a (1, 1, 1) ("pod",
    "data", "model") mesh, every leaf against the saved one, and the next
    step there."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.mesh import AxisRules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import tree_leaves
    from repro_torch.train import (TrainConfig, Trainer, TrainerConfig, init_train_state,
                                   make_train_step, state_tree)

    cfg = get_config(LM_ARCH)
    B, S, _ = GEMMA_TRAIN
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=100)
    g = torch.Generator(device=DEVICE).manual_seed(args.seed + 1)
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=g, device=DEVICE, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}

    def fresh():
        return init_train_state(torch.Generator(device=DEVICE).manual_seed(args.seed), cfg, tcfg)

    def full(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    state = fresh()
    step = make_train_step(cfg, tcfg)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss, ms = [], []
    for k in range(SHARD_STEPS):
        (state, met), t = synced(torch, lambda: step(state, batch))
        loss.append(float(met["loss"]))
        ms.append(1e3 * t)
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    after = [p.detach().clone() for p in state.params.parameters()]
    del state, step
    torch.cuda.empty_cache()

    rules = AxisRules(mesh)
    rcfg = TrainerConfig(ckpt_dir=str(d / "ckpt"), ckpt_every=0, async_ckpt=False)
    (tr, t_place) = synced(torch, lambda: Trainer(cfg, tcfg, rcfg, mesh=mesh, rules=rules,
                                                 state=fresh()))
    held_m = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    hist = tr.fit(iter([batch] * SHARD_STEPS), steps=SHARD_STEPS)
    peak_m = (torch.cuda.max_memory_allocated() - held_m) / 2**30
    loss_m, ms_m = [h["loss"] for h in hist], [1e3 * t for t in tr.step_seconds]
    n_dtensor = sum(hasattr(p, "placements") for p in tr.state.params.parameters())
    params_m = [full(p).detach() for p in tr.state.params.parameters()]
    same = all(torch.equal(m, a) for m, a in zip(params_m, after))
    worst = max(float((m.float() - a.float()).abs().max()) for m, a in zip(params_m, after))
    lrel = max(abs(a - b) / abs(b) for a, b in zip(loss_m, loss))
    del after, params_m
    say(f"[shard] (a) {card}: {cfg.name} full width, bf16 AdamW remat {cfg.remat!r}, batch "
        f"{B} x {S}, {SHARD_STEPS} steps from one seed: unsharded loss "
        f"{[round(v, 6) for v in loss]}, step ms {[round(v, 3) for v in ms]}, device peak "
        f"{peak:.3f} GiB above the {held / 2**30:.3f} GiB held; through Trainer(mesh (1, 1) "
        f"('data', 'model'), AxisRules) with {n_dtensor} DTensor parameters (placed in "
        f"{t_place:.3f} s): loss {[round(v, 6) for v in loss_m]} (largest relative difference "
        f"{lrel:.3e}), step ms {[round(v, 3) for v in ms_m]} (synchronised), device peak "
        f"{peak_m:.3f} GiB above the {held_m / 2**30:.3f} GiB held; parameters after the last "
        f"step bit-equal to the unsharded ones: {same} (largest difference {worst:.3e})")
    check(n_dtensor == sum(1 for _ in tr.state.params.parameters()),
          "the Trainer on a mesh left plain parameters")
    check(all(np.isfinite(loss_m)) and loss_m == loss and same,
          "the sharded gemma3-1b steps are not bit-equal to the unsharded ones")

    before_save()
    (_, t_save) = synced(torch, lambda: tr.save(blocking=True))
    saved = [full(x).to("cpu", copy=True) for x in tree_leaves(state_tree(tr.state, cfg))]
    n_bytes = sum(x.numel() * x.element_size() for x in saved)
    next_loss = tr.fit(iter([batch]), steps=1)[0]["loss"]
    del tr
    torch.cuda.empty_cache()
    target = make_mesh((1, 1, 1), ("pod", "data", "model"), device_type=DEVICE)
    tr = Trainer(cfg, tcfg, rcfg, mesh=target, rules=AxisRules(target), state=fresh())
    (restored, t_load) = synced(torch, tr.restore)
    got = tree_leaves(state_tree(tr.state, cfg))
    equal = len(got) == len(saved) and all(
        a.dtype == b.dtype and torch.equal(full(a).cpu(), b) for a, b in zip(got, saved))
    del got, saved
    next_t = tr.fit(iter([batch]), steps=1)[0]["loss"]
    say(f"[shard] (a) saved {n_bytes / 1e9:.3f} GB in {t_save:.3f} s (rank 0 writes, raw "
        f"codec), restored at step {restored} onto a (1, 1, 1) ('pod', 'data', 'model') mesh in "
        f"{t_load:.3f} s: every leaf bit-equal to the saved one: {equal}; the next step's loss "
        f"there {next_t:.6f}, uninterrupted {next_loss:.6f}")
    check(restored == SHARD_STEPS and equal and np.isfinite(next_t) and next_t == next_loss,
          "the elastic restore of gemma3-1b is off")
    del tr
    torch.cuda.empty_cache()


def shard_granite(torch, args, card: str, mesh) -> None:
    """(b) granite-moe-3b-a800m: one forward and backward without rules
    under two-level checkpointing, again with one level, then under the
    mesh's rules (expert-parallel MoE)."""
    import contextlib

    from repro_torch.configs import get_config
    from repro_torch.distributed.mesh import AxisRules, use_rules
    from repro_torch.models import layers as L
    from repro_torch.models import loss_fn, model_params, place_module
    from repro_torch.models import model as model_mod

    cfg = get_config(SHARD_MOE_ARCH)
    _, n_per, _ = model_mod.split_periods(cfg.layer_pattern)
    a = model_mod._sqrt_factor(n_per)
    check(cfg.remat == "full" and n_per >= 12 and a > 1,
          f"{cfg.name} does not reach the two-level checkpointing")
    B, S = SHARD_MOE_BATCH
    model = model_params(torch.Generator(device=DEVICE).manual_seed(args.seed), cfg)
    n_params = sum(p.numel() for p in model.parameters())
    g = torch.Generator(device=DEVICE).manual_seed(args.seed + 2)
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=g, device=DEVICE, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
    names = [n for n, _ in model.named_parameters()]
    experts = [i for i, n in enumerate(names) if ".mlp.w_" in n]
    sharded_calls = [0]
    inner = L._moe_sharded

    def counted(*a, **kw):
        sharded_calls[0] += 1
        return inner(*a, **kw)

    def run(rules=None):
        """(loss, the expert weights' gradients, seconds, device peak GiB,
        GiB the forward left allocated for the backward)."""
        params = list(model.parameters())
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kept = [0.0]

        def fb():
            loss, _ = loss_fn(model, cfg, batch)
            kept[0] = (torch.cuda.memory_allocated() - held) / 2**30
            return loss, torch.autograd.grad(loss, params)

        with use_rules(rules) if rules else contextlib.nullcontext():
            (loss, grads), t = synced(torch, fb)
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        loss = float((loss.full_tensor() if hasattr(loss, "full_tensor") else loss).detach())
        grads = [grads[i] for i in experts]
        return (loss, [x.full_tensor() if hasattr(x, "full_tensor") else x for x in grads], t,
                peak, kept[0])

    loss2, g2, t2, peak2, kept2 = run()
    model_mod._sqrt_factor, saved_factor = (lambda n: 1), model_mod._sqrt_factor
    try:
        loss1, g1, t1, peak1, kept1 = run()
    finally:
        model_mod._sqrt_factor = saved_factor
    equal = loss1 == loss2 and all(torch.equal(x, y) for x, y in zip(g1, g2))
    worst = max(float((x.float() - y.float()).abs().max()) for x, y in zip(g1, g2))
    del g1
    torch.cuda.empty_cache()
    place_module(model, AxisRules(mesh))
    L._moe_sharded = counted
    try:
        loss_s, g_s, t_s, peak_s, _ = run(AxisRules(mesh))
    finally:
        L._moe_sharded = inner
    num = sum(float(torch.sum((x.float() - y.float()) ** 2)) for x, y in zip(g_s, g2))
    den = sum(float(torch.sum(y.float() ** 2)) for y in g2)
    grel = (num / den) ** 0.5
    lrel = abs(loss_s - loss2) / abs(loss2)
    equal_s = loss_s == loss2 and all(torch.equal(x, y) for x, y in zip(g_s, g2))
    say(f"[shard] (b) {card}: {cfg.name} full width ({n_params} parameters, bf16, "
        f"{cfg.padded_experts} experts of which {cfg.n_experts} real, top-{cfg.top_k}), one "
        f"forward and backward of {B} x {S} tokens: two-level checkpointing (n_per {n_per}, "
        f"a = {a}) loss {loss2:.6f}, {1e3 * t2:.3f} ms, device peak {peak2:.3f} GiB above "
        f"what was held before (the parameters), {kept2:.4f} GiB kept by the forward for the "
        f"backward; one-level remat loss {loss1:.6f}, {1e3 * t1:.3f} ms, device peak "
        f"{peak1:.3f} GiB, {kept1:.4f} GiB kept; loss and the expert weights' {len(experts)} gradients bit-equal: "
        f"{equal} (largest difference {worst:.3e})")
    say(f"[shard] (b) {card}: under AxisRules on the (1, 1) mesh (expert-parallel MoE, "
        f"_moe_sharded called {sharded_calls[0]} times, two all_to_all_single over the "
        f"'model' group each): loss {loss_s:.6f} (relative {lrel:.3e}), expert gradients "
        f"normwise {grel:.3e} of the local ones, bit-equal to the local MoE: {equal_s}, "
        f"{1e3 * t_s:.3f} ms, device peak {peak_s:.3f} GiB")
    check(equal, "two-level checkpointing changed the loss or the gradients")
    check(kept2 < kept1, "two-level checkpointing kept no less for the backward than one level")
    check(sharded_calls[0] >= len(cfg.layer_pattern), "the MoE did not take the sharded path")
    check(np.isfinite(loss_s) and equal_s,
          "the expert-parallel MoE is not bit-equal to the local one")
    del model, g2, g_s
    torch.cuda.empty_cache()


def shard_world_start(d: Path):
    """(c) SHARD_WORLD NCCL ranks on the one card (``--shard-worker``), each
    building a (2, 2) DeviceMesh and redistributing a DTensor, started.
    Returns what ``shard_world_report`` reads."""
    cmd = [sys.executable, str(Path(__file__).resolve()), "--shard-worker"]
    logs = [d / f"shard_{r}.log" for r in range(SHARD_WORLD)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as fh:
            procs.append(subprocess.Popen(cmd + [str(r), str(SHARD_WORLD), str(d)],
                                          stdout=fh, stderr=subprocess.STDOUT,
                                          cwd=Path(__file__).resolve().parent))
    return procs, logs, time.perf_counter()


def shard_world_report(procs, logs, t0: float) -> None:
    """Wait for (c)'s ranks until SHARD_WORLD_TIMEOUT after their start,
    kill what is left, and report, whatever happened: the multi-rank checks
    are the CPU tests'."""
    try:
        for p in procs:
            try:
                p.wait(timeout=max(SHARD_WORLD_TIMEOUT - (time.perf_counter() - t0), 1.0))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    codes = [p.returncode for p in procs]
    said = []
    for log in logs:
        lines = [x for x in log.read_text().splitlines() if x.strip()]
        said.append(next((x for x in lines if x.startswith("[shard-worker]")),
                         next((x for x in reversed(lines) if "Error" in x),
                              lines[-1] if lines else "(no output)")))
    say(f"[shard] (c) {SHARD_WORLD} NCCL ranks on one card, each a process: exit codes "
        f"{codes}, done {time.perf_counter() - t0:.1f} s after their start (killed at "
        f"{SHARD_WORLD_TIMEOUT} s); " + " | ".join(str(x)[:300] for x in said))


def shard_worker(torch, args) -> int:
    """One rank of shard (c): a (2, 2) mesh over NCCL on card 0, one DTensor
    redistributed from Shard to Replicate (an all-gather)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_mesh
    rank, world, d = int(args.shard_worker[0]), int(args.shard_worker[1]), args.shard_worker[2]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{d}/shard_store", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh((2, world // 2), ("data", "model"), device_type=DEVICE)
        x = torch.arange(8.0, device=DEVICE).reshape(4, 2)
        y = distribute_tensor(x, mesh, [Shard(0), Shard(1)]).redistribute(
            mesh, [Replicate(), Replicate()]).to_local()
        torch.cuda.synchronize()
        say(f"[shard-worker] rank {rank}: the (2, 2) mesh redistributed over NCCL: "
            f"{bool(torch.equal(x, y))}")
    finally:
        dist.destroy_process_group()
    return 0


def phase_dryrun(torch, args, main, card: str) -> None:
    """The dry-run and roofline tools (A15.4; see the module doc, phase
    ``dryrun``): (a) the cells run in processes of their own while (b) and
    (c) use the card in this one."""
    import tempfile
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        procs = dryrun_start(Path(d))
        try:
            dryrun_step(torch, args, card)
            dryrun_solve(torch, args, main, card)
        finally:
            dryrun_report(procs, Path(d), card)
    say(f"[dryrun] phase {time.perf_counter() - t_phase:.1f} s")


def dryrun_start(d: Path) -> list:
    """(a) One ``python -m repro_torch.launch.dryrun`` a cell, all started
    together, each writing its artifact into ``d``."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", "single", "--force",
            "--out", str(d)]
    cmds = [base + ["--arch", LM_ARCH, "--shape", s] for s in DRYRUN_SHAPES]
    cmds.append(base + ["--falkon"])
    procs = []
    for i, cmd in enumerate(cmds):
        with open(d / f"cell{i}.log", "w") as fh:
            procs.append((subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT, env=env),
                          time.perf_counter(), d / f"cell{i}.log"))
    return procs


def dryrun_report(procs: list, d: Path, card: str) -> None:
    """(a) Wait for every cell within DRYRUN_TIMEOUT of its start (killing
    what is left), print each artifact's per-device figures, and fail on a
    process that did not exit 0 or a cell whose status is not "ok"."""
    codes = []
    for p, t0, log in procs:
        try:
            p.wait(timeout=max(DRYRUN_TIMEOUT - (time.perf_counter() - t0), 1.0))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        codes.append((p.returncode, time.perf_counter() - t0))
        tail = log.read_text().splitlines()[-3:]
        say(f"[dryrun] (a) {log.stem}: exit {p.returncode}: " + " | ".join(tail))
    cells = [(f"{LM_ARCH}__{s}__single.json") for s in DRYRUN_SHAPES]
    cells.append("falkon-solver__solve__single.json")
    bad = []
    for name, (code, secs) in zip(cells, codes):
        path = d / name
        res = json.loads(path.read_text()) if path.exists() else {"status": "missing"}
        if code != 0 or res.get("status") != "ok":
            bad.append(f"{name}: exit {code}, status {res.get('status')} {res.get('error', '')}")
            continue
        r, mem = res["roofline"], res["memory"]
        say(f"[dryrun] (a) {card}: {res['arch']} x {res['shape']} x {res['mesh']} "
            f"({res['chips']} ranks, counted on rank 0 in {res['compile_s']} s; its process "
            f"ended within {secs:.1f} s): per device flops {r['flops_per_device']:.6e}, bytes "
            f"{r['bytes_per_device']:.6e}, collective bytes "
            + json.dumps({k: f"{v:.6e}" for k, v in r["collective_bytes"].items()})
            + f"; memory total {mem['total_per_device'] / 1e9:.3f} GB (arguments "
            f"{mem['argument_size_in_bytes'] / 1e9:.3f}, temp {mem['temp_size_in_bytes'] / 1e9:.3f}"
            f"), fits_hbm {res['fits_hbm']}; compute {r['compute_s']:.6e} s, memory "
            f"{r['memory_s']:.6e} s, collective {r['collective_s']:.6e} s: bottleneck "
            f"{r['bottleneck']}; useful flops ratio {r['useful_flops_ratio']:.4f}")
    check(not bad, "dry-run cells failed: " + "; ".join(bad))


def dryrun_step(torch, args, card: str) -> None:
    """(b) The roofline of gemma3-1b's train step (train (b)'s step: bf16
    AdamW under remat, GEMMA_TRAIN's batch, unsharded) counted on the card
    by ``op_cost.analyze``, against the synchronised steps that follow."""
    from repro_torch.configs import get_config
    from repro_torch.roofline import (PEAK_FLOPS, derive_roofline, memory_report,
                                      train_model_flops)
    from repro_torch.roofline.op_cost import analyze_with_result
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    cfg = get_config(LM_ARCH)
    B, S, _ = GEMMA_TRAIN
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=100)
    held = torch.cuda.memory_allocated()
    g = torch.Generator(device=DEVICE).manual_seed(args.seed)
    state = init_train_state(g, cfg, tcfg)
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=g, device=DEVICE,
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
    del toks
    step = make_train_step(cfg, tcfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cost, (state, _) = analyze_with_result(step, state, batch)
    torch.cuda.synchronize()
    t_count = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    times = []
    for _ in range(DRYRUN_STEPS):
        t0 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times)
    roof = derive_roofline(cost, chips=1, model_flops=train_model_flops(cfg, B * S))
    mem = memory_report(cost)
    bound = max(roof.compute_s, roof.memory_s)
    band = mem["total_per_device"] / peak - 1.0
    say(f"[dryrun] (b) {card}: {cfg.name} train step (bf16 AdamW, remat {cfg.remat!r}, "
        f"{B} x {S} tokens, one card), counted by op_cost.analyze in {t_count:.3f} s "
        f"({cost.ops} ops): flops {cost.flops:.6e}, bytes {cost.bytes:.6e}; compute "
        f"{1e3 * roof.compute_s:.3f} ms at {PEAK_FLOPS:.4g} FLOP/s, memory "
        f"{1e3 * roof.memory_s:.3f} ms at {HBM_RATE:.4g} B/s: bound {1e3 * bound:.3f} ms "
        f"({roof.bottleneck}; PERF.md's hand-worked bound ~56 ms); useful flops ratio "
        f"{roof.useful_flops_ratio:.4f} (model flops 6 N D = {roof.model_flops:.6e}); the "
        f"next {DRYRUN_STEPS} steps (synchronised) {[round(1e3 * t, 3) for t in times]} ms, "
        f"median {1e3 * step_s:.3f} ms: bound / step {bound / step_s:.4f}")
    say(f"[dryrun] (b) {card}: counted memory: arguments {mem['argument_size_in_bytes'] / 2**30:.3f}"
        f" GiB, aliased {mem['alias_size_in_bytes'] / 2**30:.3f}, temp "
        f"{mem['temp_size_in_bytes'] / 2**30:.3f}, total {mem['total_per_device'] / 2**30:.3f} "
        f"GiB; max_memory_allocated over the counted step {peak / 2**30:.3f} GiB above the "
        f"{held / 2**30:.3f} GiB held before the state (the state and batch "
        f"{(base - held) / 2**30:.3f} GiB): counted / measured - 1 = {band:+.4f} (band "
        f"{DRYRUN_MEM_BAND:g})")
    check(bound <= step_s, f"the derived bound {bound:.4f} s exceeds the measured step "
          f"{step_s:.4f} s")
    check(0.0 < roof.useful_flops_ratio <= 1.0,
          f"useful flops ratio {roof.useful_flops_ratio} outside (0, 1]")
    check(abs(band) <= DRYRUN_MEM_BAND, f"counted peak {mem['total_per_device']} B is "
          f"{band:+.4f} from max_memory_allocated {peak} B")
    check(np.isfinite(float(met["loss"])), "non-finite loss after the counted steps")
    del state, batch, step, met
    gc.collect()
    torch.cuda.empty_cache()


def dryrun_solve(torch, args, main, card: str) -> None:
    """(c) The FALKON cell at SUSY's shape on one rank (``dryrun.falkon_cost``
    on the "torch" backend: plain ops on meta tensors; t = 20, no cond
    estimate), its terms at the fp32 peak against the main fit's measured
    solve (47 B1 launches); then at DRYRUN_SMALL_N rows against the same
    solve timed on the card on the "torch" backend."""
    from repro_torch.core import falkon_solve, make_preconditioner
    from repro_torch.launch.dryrun import falkon_cost
    from repro_torch.ops import get_ops
    from repro_torch.roofline import PEAK_FLOPS_FP32, derive_roofline

    task, kernel, centers = main["task"], main["kernel"], main["centers"]
    M, d, t = centers.shape[0], centers.shape[1], 20
    ops = get_ops("torch", kernel, block_size=DRYRUN_BLOCK)

    def roof(n):
        t0 = time.perf_counter()
        cost = falkon_cost(ops, n, d, M, t, block_size=DRYRUN_BLOCK)
        r = derive_roofline(cost, chips=1, model_flops=(t + 2) * 4.0 * n * M * d,
                            peak_flops=PEAK_FLOPS_FP32)
        return r, cost, time.perf_counter() - t0

    r, cost, secs = roof(args.n)
    solve_s = main["times"]["solve"]
    say(f"[dryrun] (c) {card}: the FALKON cell at n={args.n}, d={d}, M={M}, t={t} on one "
        f"rank, counted on the 'torch' backend in {secs:.1f} s ({cost.ops} ops): flops "
        f"{r.flops_per_device:.6e}, bytes {r.bytes_per_device:.6e}; compute "
        f"{r.compute_s:.4f} s at {PEAK_FLOPS_FP32:.4g} FLOP/s, memory {r.memory_s:.4f} s: "
        f"bound {max(r.compute_s, r.memory_s):.4f} s ({r.bottleneck}); the main fit's solve "
        f"(47 B1 launches) {solve_s:.4f} s: compute / solve {r.compute_s / solve_s:.4f}, "
        f"bound / solve {max(r.compute_s, r.memory_s) / solve_s:.4f} (the plain ops write "
        f"every K(X, C) strip to memory; B1 keeps it on chip)")
    check(r.compute_s <= solve_s, f"the cell's compute term {r.compute_s:.4f} s exceeds "
          f"the measured solve {solve_s:.4f} s")

    n = DRYRUN_SMALL_N
    r, cost, secs = roof(n)
    X, y = main["X"][:n], main["y"][:n]
    pre = make_preconditioner(ops.gram(centers, centers), task.lam, n)
    timed = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = falkon_solve(X, y, centers, pre, kernel, task.lam, t, ops=ops,
                          estimate_cond=False, tol=0.0)
        torch.cuda.synchronize()
        timed.append(time.perf_counter() - t0)
    bound = max(r.compute_s, r.memory_s)
    say(f"[dryrun] (c) {card}: at n={n} the cell counted in {secs:.1f} s: compute "
        f"{r.compute_s:.4f} s, memory {r.memory_s:.4f} s: bound {bound:.4f} s; the same solve "
        f"on the card on the 'torch' backend {[round(v, 4) for v in timed]} s: bound / solve "
        f"{bound / min(timed):.4f}")
    check(bool(torch.isfinite(st.alpha).all()), "non-finite alpha from the 'torch' solve")
    check(bound <= min(timed), f"the derived bound {bound:.4f} s exceeds the 'torch' "
          f"backend's solve {min(timed):.4f} s")
    del X, y, st, pre


def lm_close(torch, got, ref, rtol: float, atol: float) -> tuple[float, float]:
    """(max |got - ref|, max |got - ref| / (atol + rtol |ref|)): the second
    is <= 1 where ``allclose`` holds."""
    diff = (got.double() - ref.double()).abs()
    return float(diff.max()), float((diff / (atol + rtol * ref.double().abs())).max())


def phase_lm(torch, args, card: str) -> list[dict]:
    """The LM serving path at gemma3-1b's full width (see the module doc,
    phase ``lm``). Returns the kernels line's rows of B1, B2 and B3 at the
    head's shapes."""
    import types

    from repro_torch.configs import get_config
    from repro_torch.core import FalkonConfig, falkon_fit
    from repro_torch.data import TokenStreamConfig, token_stream
    from repro_torch.kernels import kernel_matvec as km
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import decode_step, forward, model_params, prefill
    from repro_torch.models.model import _backbone

    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    say(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads {cfg.n_heads} "
        f"(padded {cfg.padded_heads}) over {cfg.n_kv_heads} KV, d_head {cfg.d_head}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, window {cfg.sliding_window}")

    # (a) decode against the teacher-forced forward, fp32
    B, S, k = LM_TOKENS
    g = torch.Generator(device=DEVICE).manual_seed(args.seed)
    t0 = time.perf_counter()
    model = model_params(g, cfg32)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    say(f"[lm] fp32 model: {n_params} parameters ({n_params * 4 / 1e9:.3f} GB) made on the "
        f"card in {time.perf_counter() - t0:.2f} s")
    check(abs(n_params - 1.486e9) < 1e6, f"gemma3-1b stores {n_params} parameters, not 1.486e9")
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=g, device=DEVICE, dtype=torch.int32)
    with torch.no_grad():
        full = forward(model, cfg32, {"tokens": tokens})
    logits, cache = prefill(model, cfg32, {"tokens": tokens[:, :k]}, S_max=S)
    (rt, at), (rt2, at2) = LM_DECODE_TOL
    err, ratio = lm_close(torch, logits, full[:, k - 1], rt, at)
    worst = (err, ratio)
    for t in range(k, S):
        logits, cache = decode_step(model, cfg32, cache, {"token": tokens[:, t]})
        e, r = lm_close(torch, logits, full[:, t], rt2, at2)
        worst = max(worst, (e, r), key=lambda x: x[1])
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(full).all())
    say(f"[lm] (a) fp32 B={B}: forward over {S} tokens, prefill {k} into a cache of {S}, "
        f"{S - k} decode steps: prefill vs forward max abs err {err:.3e} (ratio {ratio:.4f} "
        f"of rtol=atol={rt:g}); decode steps vs forward worst max abs err {worst[0]:.3e} "
        f"(ratio {worst[1]:.4f} of rtol=atol={rt2:g}); cache pos {int(cache['pos'])}; "
        f"logits finite {finite}, max |logit| {float(full.abs().max()):.4f}")
    check(finite and ratio <= 1.0 and worst[1] <= 1.0 and int(cache["pos"]) == S,
          "decode disagrees with the teacher-forced forward")
    del full, cache, logits

    # (b) chunked against dense attention, fp32
    toks = torch.randint(0, cfg.vocab, (1, LM_CHUNK_S), generator=g, device=DEVICE,
                         dtype=torch.int32)
    check(LM_CHUNK_S > cfg32.dense_attn_max_seq, "the chunked case must exceed the dense limit")
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunked = forward(model, cfg32, {"tokens": toks})
        torch.cuda.synchronize()
        t_chunked = time.perf_counter() - t0
        t0 = time.perf_counter()
        dense = forward(model, dataclasses.replace(cfg32, dense_attn_max_seq=LM_CHUNK_S),
                        {"tokens": toks})
        torch.cuda.synchronize()
        t_dense = time.perf_counter() - t0
    err, ratio = lm_close(torch, chunked, dense, LM_CHUNK_TOL, LM_CHUNK_TOL)
    nq = LM_CHUNK_S // 2048 if LM_CHUNK_S > 2048 and LM_CHUNK_S % 2048 == 0 else 1
    say(f"[lm] (b) fp32 B=1 S={LM_CHUNK_S}: chunked ({nq} query block(s) x "
        f"{LM_CHUNK_S // cfg.attn_chunk} KV chunks of {cfg.attn_chunk}) vs dense attention: "
        f"max abs diff {err:.3e} (ratio {ratio:.4f} of {LM_CHUNK_TOL:g}); forward "
        f"{t_chunked:.3f} s chunked, {t_dense:.3f} s dense")
    check(ratio <= 1.0 and bool(torch.isfinite(chunked).all()),
          "chunked attention disagrees with dense")
    del chunked, dense, model
    torch.cuda.empty_cache()

    # (c) serving in bf16, then (d) the head on its features: the main path
    km.reset_launch_counts()
    held = torch.cuda.memory_allocated()          # what earlier phases still hold
    torch.cuda.reset_peak_memory_stats()
    nb, npr, ngen = LM_SERVE
    served = serve_lm(types.SimpleNamespace(arch=LM_ARCH, reduced=False, batch=nb,
                                            prompt_len=npr, gen=ngen, device=DEVICE,
                                            seed=args.seed))
    serve_peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    model, bcfg = served["model"], served["cfg"]
    check(bcfg.dtype == "bfloat16" and model.embed.dtype == torch.bfloat16,
          "serve_lm did not run the config's bf16")
    check(tuple(served["tokens"].shape) == (nb, ngen - 1)
          and int(served["tokens"].max()) < cfg.padded_vocab, "serve_lm's tokens are malformed")
    say(f"[lm] (c) {card}: bf16 serve_lm batch {nb}, prompt {npr}, {ngen} generated: prefill "
        f"{served['prefill_s'] * 1e3:.1f} ms, decode {served['decode_s'] * 1e3:.2f} ms/token/batch "
        f"(eager), device peak {serve_peak:.2f} GiB above the {held / 2**30:.2f} GiB held "
        f"before it")

    stream = token_stream(TokenStreamConfig(**LM_STREAM), seed=7, device=DEVICE)
    feats, labels = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(LM_BATCHES):
            b = next(stream)
            feats.append(_backbone(model, bcfg, {"tokens": b["tokens"]})
                         .reshape(-1, bcfg.d_model).float())
            labels.append(b["tokens"].reshape(-1).long() % 8)
    X, ylab = torch.cat(feats), torch.cat(labels)
    torch.cuda.synchronize()
    t_feat = time.perf_counter() - t0
    del feats, model, served
    torch.cuda.empty_cache()
    n, d = X.shape
    ntr = int(0.8 * n)
    Xtr, Xte, Y = X[:ntr], X[ntr:], torch.nn.functional.one_hot(ylab, 8).float()
    D = torch.cdist(Xtr[:LM_SIGMA_ROWS].double(), Xtr[:LM_SIGMA_ROWS].double())
    iu = torch.triu_indices(LM_SIGMA_ROWS, LM_SIGMA_ROWS, 1, device=DEVICE)
    sigma = float(D[iu[0], iu[1]].median())
    del D, iu
    say(f"[lm] (d) features: {LM_BATCHES} batches of {LM_STREAM['batch']} x "
        f"{LM_STREAM['seq_len']} tokens through _backbone in {t_feat:.3f} s: X {tuple(X.shape)} "
        f"fp32, finite {bool(torch.isfinite(X).all())}; sigma = median pairwise distance of "
        f"{LM_SIGMA_ROWS} training rows = {sigma:.4f} (sqrt(2 d) = {np.sqrt(2 * d):.2f})")
    check(n == LM_BATCHES * LM_STREAM["batch"] * LM_STREAM["seq_len"] and d == cfg.d_model
          and bool(torch.isfinite(X).all()), "the head's features are malformed")
    hcfg = dict(kernel="gaussian", kernel_params=(("sigma", sigma),), device=DEVICE, **LM_HEAD)
    st: dict = {}
    t0 = time.perf_counter()
    est, state = falkon_fit(args.seed, Xtr, Y[:ntr], FalkonConfig(ops_impl="cuda", **hcfg),
                            stage_times=st)
    pred = est.predict(Xte)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    counts = km.launch_counts()
    acc = float((pred.argmax(-1) == ylab[ntr:]).float().mean())
    major = float(torch.bincount(ylab[ntr:], minlength=8).max()) / (n - ntr)
    acc_bar = major + LM_ACC_SE * float(np.sqrt(major * (1 - major) / (n - ntr)))
    t_it, p = LM_HEAD["iterations"], Y.shape[1]
    groups = -(-p // km.MAX_P)
    want = {"pairwise_kernel": 1, "fused_sweep": (1 + t_it) * groups + 26,
            "kernel_matmul": groups}
    say(f"[lm] (d) {card}: head fit n={ntr} M={LM_HEAD['num_centers']} d={d} p={p} "
        f"lam={LM_HEAD['lam']:g} t={t_it}: fit + predict {t_fit:.3f} s (stages "
        + ", ".join(f"{k_} {v:.3f} s" for k_, v in st.items() if isinstance(v, float))
        + f"); accuracy {acc:.4f} on {n - ntr} rows (bar {acc_bar:.4f}: the majority class "
        f"{major:.4f} + {LM_ACC_SE} standard errors; the example's bar {LM_ACC_EXAMPLE} "
        f"{'met' if acc > LM_ACC_EXAMPLE else 'not met'}; chance 0.125); "
        f"cond(W) {float(state.cond_estimate):.2f}; launches on the main path (serve, "
        f"features, fit, predict) {counts} (want {want})")
    check(acc > acc_bar, f"the LM head's accuracy {acc:.4f} is not above {acc_bar:.4f}")
    for name, v in want.items():
        check(counts[name] == v, f"{name}: {counts[name]} launches on the head's path, want {v}")
    check(counts["sharded_sweep"] == 0, "the head's sweeps left B1")

    t0 = time.perf_counter()
    est_t, _ = falkon_fit(args.seed, Xtr, Y[:ntr], FalkonConfig(ops_impl="torch", **hcfg))
    pred_t = est_t.predict(Xte)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    same = torch.equal(est_t.centers, est.centers)
    prel = float(torch.linalg.norm((pred_t - pred).double()) / torch.linalg.norm(pred.double()))
    agree = float((pred_t.argmax(-1) == pred.argmax(-1)).float().mean())
    acc_t = float((pred_t.argmax(-1) == ylab[ntr:]).float().mean())
    say(f"[lm] (d) the same fit on the \"torch\" backend (plain, on the card, {t_plain:.3f} s): "
        f"same centers {same}; predictions vs \"cuda\" normwise {prel:.3e} (bound "
        f"{LM_HEAD_PRED_TOL:g}), same class on {agree:.4f} of rows (bound {LM_HEAD_AGREE}), "
        f"accuracy {acc_t:.4f}")
    check(same and prel <= LM_HEAD_PRED_TOL and agree >= LM_HEAD_AGREE,
          "the head's cuda fit disagrees with its plain fit")

    # the kernels line's rows: B1, B2, B3 at the head's shapes
    rows = head_rows(torch, km, est, Xtr, Xte, counts, "head", "[lm]", "the LM head", card)
    del X, Xtr, Xte, est, est_t, pred, pred_t
    torch.cuda.empty_cache()
    say(f"[lm] phase {time.perf_counter() - t_phase:.1f} s")
    return rows


def head_rows(torch, km, est, Xtr, Xte, counts: dict, suffix: str, tag: str, what: str,
              card: str, twin_factor: float | None = None) -> list[dict]:
    """The kernels line's rows of a FALKON head's kernels at its shapes: B1
    at its sweep (n x M, p columns) against float32 and float64 twins and
    bit-equal over two runs, B2 at its predict against its twin, B3 at its
    K_MM (``pairwise_times``), each timed beside its twin and bound; the
    rows are named ``<kernel>_<suffix>`` and carry ``counts``' launches.
    With ``twin_factor`` (features of large norm, whose entries cancel in
    fp32) B1 is held as ``sweep_witness`` says and B2 against float64 to
    the fp32 error model below, which its float32 twin must meet too."""
    n, d = Xtr.shape
    C, spec, M = est.centers, est.kernel.spec, est.centers.shape[0]
    alpha, m = est.alpha, Xte.shape[0]
    p = alpha.shape[1]
    groups = -(-p // km.MAX_P)
    rows = []
    U = torch.randn(M, p, generator=torch.Generator(device=DEVICE).manual_seed(31),
                    device=DEVICE)
    sweep = lambda: km.fused_sweep(Xtr, C, U, spec=spec)
    ws, ref = sweep_witness(torch, km, spec, Xtr, C, U, f"{what} n={n} M={M} d={d} p={p}",
                            {"B1": sweep}, twin_factor=twin_factor)
    abs_err, ratio = close_err(ws["B1"], ref)
    again = torch.equal(ws["B1"], sweep())
    check(ratio <= 1.0 and again, f"B1 at {what}'s shape is off its twin or not deterministic")
    ms = time_cuda(torch, sweep, 5)
    plain = time_cuda(torch, lambda: km.fused_sweep_plain(Xtr, C, U, None, spec=spec), 3)
    b, by = bound(n * M * (2 * d + 10 + 4 * p), 4 * (n * d + M * d + 2 * M * p))
    say(f"{tag} {card}: B1 at {what} n={n} M={M} d={d} p={p} ({groups} launches): kernel "
        f"{ms:.4f} ms, twin {plain:.4f} ms, bound {b:.4f} ms ({by}); vs twin max abs err "
        f"{abs_err:.3e} (ratio {ratio:.4f}); two runs bit-equal {again}")
    rows.append(dict(name=f"fused_sweep_{suffix}", base="fused_sweep", ms=ms, plain_ms=plain,
                     bound_ms=b, bound_by=by, max_abs_err=abs_err,
                     launches=counts["fused_sweep"], shape=f"n={n} M={M} d={d} p={p}"))
    mm = lambda: km.kernel_matmul(Xte, C, alpha, spec=spec)
    out = mm().double()
    S_ = float(km.kernel_matmul_plain(Xte, C, alpha.abs(), spec=spec).max())
    ref32 = km.kernel_matmul_plain(Xte, C, alpha, spec=spec).double()
    abs_err = float((out - ref32).abs().max())
    limit = PRED_RTOL * S_
    if twin_factor is not None:
        # inputs of large norm: each entry's squared distance cancels in fp32,
        # with an error ~ u sqrt(d) (|a|^2 + |c|^2) (d roundings of random
        # sign), u = 2^-24, so an entry's relative error is ~ u sqrt(d) kappa,
        # kappa = (max |a|^2 + max |c|^2) / (2 sigma^2); both fp32 versions are
        # held to that against float64
        sigma = dict(spec.params)["sigma"]
        kappa = float(Xte.square().sum(1).max() + C.square().sum(1).max()) / (2 * sigma**2)
        limit = 2.0**-24 * d**0.5 * max(kappa, 1.0) * S_
        ref64 = km.kernel_matmul_plain(Xte.double(), C.double(), alpha.double(), spec=spec)
        rk, rt = (float((v - ref64).abs().max()) / limit for v in (out, ref32))
        say(f"{tag} B2 at {what}'s predict vs float64, over u sqrt(d) kappa S = {limit:.4e} "
            f"(kappa {kappa:.2f}): kernel {rk:.4f}, float32 twin {rt:.4f} (bound 1)")
        check(rt <= 1.0, f"B2's float32 twin at {what}'s predict exceeds the error model")
        abs_err = float((out - ref64).abs().max())
    check(abs_err <= limit and torch.equal(out, mm().double()),
          f"B2 at {what}'s predict shape off its twin ({abs_err:.3e}) or not deterministic")
    ms = time_cuda(torch, mm, 10)
    plain = time_cuda(torch, lambda: km.kernel_matmul_plain(Xte, C, alpha, spec=spec), 3)
    b, by = bound(m * M * (2 * d + 10 + 2 * p), 4 * (m * d + M * d + M * p + m * p))
    say(f"{tag} {card}: B2 at {what}'s predict m={m} n={M} d={d} p={p}: kernel {ms:.4f} ms, "
        f"twin {plain:.4f} ms, bound {b:.4f} ms ({by}); max abs err {abs_err:.3e} (limit "
        f"{limit:.4e})")
    rows.append(dict(name=f"kernel_matmul_{suffix}", base="kernel_matmul", ms=ms, plain_ms=plain,
                     bound_ms=b, bound_by=by, max_abs_err=abs_err,
                     launches=counts["kernel_matmul"], shape=f"m={m} n={M} d={d} p={p}"))
    row = pairwise_times(torch, km, C, C, spec, f"{what}'s K_MM", plain=True)
    rows.append(dict(row, name=f"pairwise_kernel_{suffix}", base="pairwise_kernel",
                     launches=counts["pairwise_kernel"]))
    return rows


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
            f"launches per run {counts[r['name']]}"
            + (f" (then {r['replays']} graph replays)" if "replays" in r else "")
            + ", library " + ("none" if lib is None else f"{lib:.4f} ms ({r['library']})"))
        kernels.append({
            "name": r["name"], "route": "cuda", "source": SOURCES[r["name"]],
            "replaces": REPLACES[base], "launches": counts[r["name"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": lib,
            **({"replays": r["replays"]} if "replays" in r else {}),
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


def device_ops(torch, tag: str, fn) -> list[tuple[str, float, float]]:
    """One call's device operations (``torch.profiler``) as (name, start us,
    elapsed us), in launch order. The profiler has returned no device
    operation for a whole call (B3 at MillionSongs' K_MM; B2 at the predict
    shape) and dropped a call's first one at times: after minutes of
    float64 work on the card its device timestamps stood 0.5 to 2 s off its
    window on the host's clock, and it drops what falls outside (a probe on
    the H100: 2 of 12 profiles of B2 and B3 kept at pads up to 0.5 s, 12 of
    12 at 2 s). So each profile records one call after a warm-up step of
    its own (a ``schedule`` of one warm-up and one active step), the active
    step idles PROFILE_PAD seconds before and after the call, and an empty
    profile is taken again with the pad doubled, up to five times in all."""
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
    return [(e.name.split("(")[0].removeprefix("void "), e.time_range.start,
             e.time_range.elapsed_us()) for e in sorted(events, key=lambda e: e.time_range.start)]


def breakdown(torch, tag: str, fn, each: bool = False) -> None:
    """One call's device operations, by name, with their summed device time
    (``device_ops``): a blocked schedule's launches; ``each`` also lists
    every launch's time in launch order."""
    ops: dict[str, list] = {}
    for name, _, us in device_ops(torch, tag, fn):
        ops.setdefault(name, []).append(us)
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
    ap.add_argument("--mesh-worker", nargs=4, help=argparse.SUPPRESS)   # one mesh rank
    ap.add_argument("--shard-worker", nargs=3, help=argparse.SUPPRESS)  # one rank of shard (c)
    args = ap.parse_args(argv)
    try:
        import torch
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run from the repository root",
              file=sys.stderr)
        return 3
    if args.mesh_worker:
        return mesh_worker(torch, args)
    if args.shard_worker:
        return shard_worker(torch, args)
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
    bf16_rows, bf16 = phase_bf16(torch, args, main_res)
    say(f"[time] {time.perf_counter() - t_start:.1f} s after the bf16 SUSY phase")
    bf16_rows += phase_f16(torch, args, main_res, bf16)
    say(f"[time] {time.perf_counter() - t_start:.1f} s after the float16 SUSY phase")
    bf16_rows += phase_cache(torch, args, main_res, card)
    say(f"[time] {time.perf_counter() - t_start:.1f} s after the K_nM-cache phase")
    bf16_rows.append(phase_stream(torch, args, main_res, path_res, bf16["err"], card))
    say(f"[time] {time.perf_counter() - t_start:.1f} s after the streaming phase")
    bf16_rows += phase_minibatch(torch, args, main_res, path_res, card)
    say(f"[time] {time.perf_counter() - t_start:.1f} s after the mini-batch phase")
    phase_mesh(torch, args, main_res, card)
    say(f"[time] {time.perf_counter() - t_start:.1f} s after the mesh phase")
    msd_res = phase_msd(torch, args)
    bf16_rows.append(msd_bf16_sweep(torch, msd_res))
    say(f"[time] {time.perf_counter() - t_start:.1f} s after the MillionSongs phase")
    bf16_rows += phase_lm(torch, args, card)
    say(f"[time] {time.perf_counter() - t_start:.1f} s after the LM phase")
    bf16_rows += phase_train(torch, args, card)
    say(f"[time] {time.perf_counter() - t_start:.1f} s after the training phase")
    phase_shard(torch, args, card)
    say(f"[time] {time.perf_counter() - t_start:.1f} s after the sharding phase")
    phase_dryrun(torch, args, main_res, card)
    say(f"[time] {time.perf_counter() - t_start:.1f} s after the dry-run phase")
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
