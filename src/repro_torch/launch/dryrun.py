"""Multi-pod dry run: every (architecture x shape) cell on the production
mesh, counted on one rank of a fake world.

Counterpart of ``repro/launch/dryrun.py``. For every cell and each mesh
(single-pod 16x16, multi-pod 2x16x16) the reference lowers and compiles the
step on 512 virtual host devices and reads XLA's memory and cost analyses.
The port runs the step itself, once, on rank 0 of a fake world of 256 or
512 ranks in this process (``torch.distributed``'s ``"fake"`` backend:
collectives return at once and move nothing), on tensors of the ``meta``
device (shapes, no data: nothing is allocated), and counts what that rank
runs (``repro_torch.roofline.op_cost``): the local ops on the local shards,
the collectives DTensor issues, the bytes alive. So every figure is one
card's, at the H100's constants (``repro_torch.roofline.analysis``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
        [--shape train_4k] [--mesh single|multi|both] [--all] [--force]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --falkon [--mesh single]

Results are JSON artifacts under ``artifacts/dryrun/`` (``--out``), one a
cell, with the reference's keys and ``"status"`` (``"error"`` and the
reason where a cell cannot be counted); a cached cell is skipped unless
``--force``. The FALKON solver cells read ``FALKON_FULL_MESH=1`` (the sweep
over the whole mesh, the idle ``"model"`` axis included) and
``FALKON_BLOCK`` (rows a sweep block, default 8192).

A cell means: ``train`` — one optimizer step on the global batch with
gradient accumulation down to one batch row a data shard (microbatches
``global_batch // dp``; the global batch and the math unchanged, one
microbatch's activations live at once); ``prefill`` — the prompt through
the stack, building a cache of ``seq_len``; ``decode`` — one token against
a cache of ``seq_len``. ``fits_hbm`` holds the rank's peak against one
H100's 80 GB.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, ShapeCell, get_config, input_specs
from repro_torch.distributed.mesh import AxisRules, NamedSharding, placements_for, use_rules
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline.analysis import (HBM_BYTES, PEAK_FLOPS_FP32, analytic_memory,
                                           decode_model_flops, derive_roofline,
                                           memory_report, train_model_flops)
from repro_torch.roofline.op_cost import analyze

ART_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun"

FALKON_N, FALKON_D, FALKON_M, FALKON_T = 134_217_728, 90, 16_384, 20


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of ``world`` ranks, this process rank 0: the
    collectives return at once and move nothing. Refuses to replace a
    running process group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already running; the dry run starts its own "
                           "fake world")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _place(tree: dict, cfg, rules) -> dict:
    """Batch inputs on the mesh at ``batch_pspecs``."""
    from repro_torch.train.steps import batch_pspecs
    mesh = rules.mesh
    return {k: NamedSharding(mesh, placements_for(mesh, spec), spec).place(tree[k])
            for k, spec in batch_pspecs(cfg, tree, rules).items()}


def cell_args(cfg, cell: ShapeCell, microbatch: int, rules) -> tuple:
    """(fn, fn's arguments..., model_flops) of one cell (a ``ShapeCell``):
    the port's own step on ``meta`` tensors placed on ``rules.mesh``."""
    from repro_torch.models import Model, place_module
    from repro_torch.models import model as M
    from repro_torch.train.steps import (TrainConfig, make_serve_step, make_train_step,
                                         param_shardings, place_train_state,
                                         train_state_structs)
    specs = input_specs(cfg, cell)
    if cell.kind == "train":
        tcfg = TrainConfig(microbatch=microbatch)
        state = place_train_state(train_state_structs(cfg, tcfg), cfg, tcfg, rules)
        step = make_train_step(cfg, tcfg, grad_shardings=param_shardings(state.params, cfg))
        return (step, state, _place(specs, cfg, rules),
                train_model_flops(cfg, cell.global_batch * cell.seq_len))
    model = place_module(Model(cfg, device="meta"), rules)
    if cell.kind == "prefill":
        batch = _place({k: v for k, v in specs.items() if k != "labels"}, cfg, rules)
        n_act = cfg.param_count(active_only=bool(cfg.n_experts))
        return (lambda m, b: M.prefill(m, cfg, b, S_max=cell.seq_len), model, batch,
                2.0 * n_act * cell.global_batch * cell.seq_len)
    B, S_max = cell.global_batch, cell.seq_len
    with use_rules(rules):
        cache = M.init_cache(cfg, B, S_max, device="meta")
    return (make_serve_step(cfg), model, cache, _place(specs, cfg, rules),
            decode_model_flops(cfg, B, S_max))


def run_cell(arch: str, shape: str, multi_pod: bool, *, overrides: dict | None = None) -> dict:
    """Count one (arch x shape) cell on rank 0 of the production mesh."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cell = SHAPES[shape]
    dp = 32 if multi_pod else 16
    mb = max(1, cell.global_batch // dp) if cell.kind == "train" else 0
    t0 = time.time()
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        chips = mesh.size()
        rules = AxisRules(mesh=mesh, fsdp=cfg.fsdp)
        *args, model_flops = cell_args(cfg, cell, mb, rules)
        with use_rules(rules):
            cost = analyze(*args)
        mem = memory_report(cost)
        roof = derive_roofline(cost, chips=chips, model_flops=model_flops)
    return {
        "arch": arch, "shape": shape,
        "microbatch": mb,
        "mesh": _mesh_name(multi_pod),
        "chips": chips,
        "kind": cell.kind,
        "compile_s": round(time.time() - t0, 1),
        "memory": mem,
        "analytic_memory_gb": analytic_memory(cfg, cell, rules, microbatch=mb or 1),
        "fits_hbm": mem["total_per_device"] < HBM_BYTES,
        "bytes_per_device_gb": round(mem["total_per_device"] / 1e9, 3),
        "roofline": roof.as_dict(),
        "status": "ok",
    }


def falkon_cost(ops, n: int, d: int, M: int, t: int, *, block_size: int):
    """One rank's ``op_cost`` of ``falkon_solve`` (t CG iterations, lam =
    1e-6, no cond estimate, tol = 0: no value is read on the host) through
    ``ops`` on ``meta`` inputs: X (n, d) and y (n,), the centers (M, d), T
    and A (M, M)."""
    from repro_torch.core import falkon_solve
    from repro_torch.core.preconditioner import Preconditioner

    def meta(*shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    def solve(X, y, C, T, A):
        pre = Preconditioner(T=T, A=A, Q=None, D=None,
                             n=torch.tensor(float(n), device="meta"), diag_T=False)
        return falkon_solve(X, y, C, pre, ops.kernel, 1e-6, t, block_size=block_size,
                            ops=ops, estimate_cond=False, tol=0.0).alpha

    return analyze(solve, meta(n, d), meta(n), meta(M, d), meta(M, M), meta(M, M))


def run_falkon_cell(multi_pod: bool, *, block_size: int = 8192, impl: str = "torch",
                    full_mesh_data: bool = False, n: int = FALKON_N, d: int = FALKON_D,
                    M: int = FALKON_M, t: int = FALKON_T) -> dict:
    """Count the paper's own solver on the production mesh: n = 2^27 rows,
    d = 90 (MillionSongs-like), M = 16,384 centers, t = 20 CG iterations,
    X and y sharded over the data axes (``DistributedOps``: a rank sweeps its
    rows, one all-reduce of the (M, 1) partial a sweep), the preconditioner
    replicated (``n``, ``d``, ``M``, ``t`` cut it down). ``impl`` is the
    backend a rank sweeps with: ``"torch"``, the plain ops, is the
    reference's ``"jnp"``. The compute term is at the fp32 peak: the solve
    runs in fp32."""
    from repro_torch.core import GaussianKernel
    from repro_torch.distributed.mesh import data_axes
    from repro_torch.ops import DistributedOps, get_ops

    kern = GaussianKernel(sigma=6.0)
    t0 = time.time()
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        chips = mesh.size()
        # the CG sweep is data-parallel: over the whole mesh (the idle
        # "model" axis included) with full_mesh_data, else the data axes
        dp = data_axes(mesh) + ("model",) if full_mesh_data else data_axes(mesh)
        dops = DistributedOps(get_ops(impl, kern, block_size=block_size), mesh, dp)
        cost = falkon_cost(dops, n, d, M, t, block_size=block_size)
        mem = memory_report(cost)
        # paper flop count: (t+2) sweeps x 2 kernel matmuls x 2nMd
        model_flops = (t + 2) * 4.0 * n * M * d
        roof = derive_roofline(cost, chips=chips, model_flops=model_flops,
                               peak_flops=PEAK_FLOPS_FP32)
    return {
        "arch": "falkon-solver",
        "shape": f"n{n >> 20}M_M{M}_t{t}",
        "mesh": _mesh_name(multi_pod),
        "chips": chips,
        "kind": "solve",
        "compile_s": round(time.time() - t0, 1),
        "memory": mem,
        "fits_hbm": mem["total_per_device"] < HBM_BYTES,
        "bytes_per_device_gb": round(mem["total_per_device"] / 1e9, 3),
        "block_size": block_size,
        "impl": impl,
        "data_axes": list(dp),
        "psums": dops.psums,
        "psum_floats": dops.psum_floats,
        "roofline": roof.as_dict(),
        "status": "ok",
    }


def cell_path(arch, shape, multi_pod, art_dir: Path | str | None = None) -> str:
    art_dir = Path(ART_DIR if art_dir is None else art_dir)
    art_dir.mkdir(parents=True, exist_ok=True)
    mesh = "multi" if multi_pod else "single"
    return str(art_dir / f"{arch}__{shape}__{mesh}.json")


def _write(path: str, res: dict) -> None:
    with open(path, "w") as f:
        json.dump(res, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS) + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--falkon", action="store_true", help="run the FALKON-solver cells only")
    ap.add_argument("--out", default=None, help="artifact directory (default artifacts/dryrun)")
    args = ap.parse_args(argv)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    if args.falkon:
        full = os.environ.get("FALKON_FULL_MESH", "0") == "1"
        bs = int(os.environ.get("FALKON_BLOCK", "8192"))
        for mp in meshes:
            res = run_falkon_cell(mp, full_mesh_data=full, block_size=bs)
            _write(cell_path("falkon-solver", "solve", mp, args.out), res)
            print(f"falkon cell ({res['mesh']}): {res['bytes_per_device_gb']} GB/dev, "
                  f"bottleneck={res['roofline']['bottleneck']}")
        return 0

    archs = list(ARCH_IDS) if (args.all or args.arch is None) else [args.arch]
    failures = []
    for arch in archs:
        cfg = get_config(arch)
        shapes = [args.shape] if args.shape else cfg.runnable_shapes()
        for shape in shapes:
            if shape in cfg.skip_shapes:
                print(f"SKIP {arch} x {shape} (the config's skip_shapes)")
                continue
            for mp in meshes:
                path = cell_path(arch, shape, mp, args.out)
                if os.path.exists(path) and not args.force:
                    print(f"cached {path}")
                    continue
                tag = f"{arch} x {shape} x {'multi' if mp else 'single'}"
                print(f"=== dry-run {tag} ===", flush=True)
                try:
                    res = run_cell(arch, shape, mp)
                    print(f"    ok: {res['bytes_per_device_gb']} GB/dev, "
                          f"bottleneck={res['roofline']['bottleneck']}", flush=True)
                except Exception as e:   # the cell's artifact records the failure
                    traceback.print_exc()
                    res = {"arch": arch, "shape": shape, "mesh": "multi" if mp else "single",
                           "status": "error", "error": repr(e)}
                    failures.append(tag)
                _write(path, res)
    if failures:
        print("FAILURES:", failures)
        return 1
    print("dry-run complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
