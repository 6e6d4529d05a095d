"""Training launcher.

Counterpart of ``repro/launch/train.py``, with its flags:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b --steps 100 \\
        [--reduced] [--mesh DxM | PxDxM] [--ckpt-dir DIR] [--device cuda]

trains the architecture (its full config, or the reduced one with
``--reduced``) on the synthetic token stream with the ``Trainer``:
checkpoints and restart, straggler reports, and a blocking save when the
process gets SIGTERM. It runs on the card unless ``--device cpu``.

``--mesh`` trains on a mesh of one process a rank, over the reference's
axes (``("data", "model")`` or ``("pod", "data", "model")``) under
``AxisRules(mesh, fsdp=cfg.fsdp)``; start it with ``torchrun
--nproc-per-node N`` (N the mesh's size; NCCL on cards, one card a rank,
gloo with ``--device cpu``) or in ranks whose process group is already
running. Each rank takes its rows of every batch (``ShardedLoader``) and
wraps them as a DTensor by ``batch_pspecs``.
"""
from __future__ import annotations

import argparse
import signal

import os

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.data import ShardedLoader, TokenStreamConfig, token_stream
from repro_torch.distributed.mesh import AxisRules, placements_for
from repro_torch.train import TrainConfig, Trainer, TrainerConfig, batch_pspecs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--mesh", default=None,
                    help="e.g. 16x16 or 2x16x16 (None = single device)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    mesh = rules = None
    if args.mesh:
        mesh = _mesh(args.mesh, args.device)
        rules = AxisRules(mesh=mesh, fsdp=cfg.fsdp)
    tcfg = TrainConfig(
        learning_rate=args.lr,
        warmup_steps=args.steps // 10,
        total_steps=args.steps,
        microbatch=args.microbatch,
        grad_compression=args.grad_compression,
    )
    rcfg = TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=max(10, args.steps // 5))
    trainer = Trainer(
        cfg, tcfg, rcfg, mesh=mesh, rules=rules, device=args.device,
        straggler_cb=lambda i, dt, z: print(f"[straggler] step {i}: {dt*1e3:.0f}ms "
                                            f"(z={z:.1f})"),
    )
    previous = signal.signal(signal.SIGTERM, lambda *_: trainer.request_preemption())
    try:
        stream = token_stream(TokenStreamConfig(vocab=min(cfg.vocab, 4096), seq_len=args.seq,
                                                batch=args.batch),
                              device="cpu" if mesh else trainer.device)
        if mesh is not None:
            stream = _mesh_batches(ShardedLoader(stream, mesh=mesh), cfg, rules,
                                   (args.batch, args.seq))
        hist = trainer.fit(stream, steps=args.steps)
    finally:
        signal.signal(signal.SIGTERM, previous)
    if hist:
        print(f"{len(hist)} steps; loss {hist[0]['loss']:.4f} -> "
              f"{hist[-1]['loss']:.4f}; stragglers={len(trainer.straggler_events)}")
    return {"history": hist, "trainer": trainer}


def _mesh(spec: str, device: str):
    """The mesh of ``--mesh DxM`` or ``PxDxM``, over the default process
    group (started from torchrun's environment when none is running)."""
    from repro_torch.launch.mesh import make_mesh
    dims = tuple(int(x) for x in spec.split("x"))
    axes = ("pod", "data", "model")[-len(dims):]
    device_type = torch.device(device).type
    if not dist.is_initialized():
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    return make_mesh(dims, axes, device_type)


def _mesh_batches(loader, cfg, rules, shape):
    """Each rank's rows of each batch as DTensors of the global batch
    ``shape`` (rows, tokens), placed by ``batch_pspecs``: rows the loader
    split over the data axes are this rank's shard, whole rows a replica;
    either is then redistributed to the spec. Other values pass through."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed.mesh import data_axes, data_shard, device_of
    mesh = rules.mesh
    axes = data_axes(mesh)
    _, shards = data_shard(mesh, axes)
    names = list(mesh.mesh_dim_names)
    specs = batch_pspecs(cfg, {k: torch.empty(shape, device="meta")
                               for k in ("tokens", "labels")}, rules)
    for batch in loader:
        out = dict(batch)
        for k, spec in specs.items():
            v = batch[k].to(device_of(mesh))
            split = v.shape[0] != shape[0]
            if split and v.shape[0] * shards != shape[0]:
                raise ValueError(f"{k}: {v.shape[0]} rows of {shape[0]} on {shards} shards")
            given = [Shard(0) if split and a in axes else Replicate() for a in names]
            t = DTensor.from_local(v, mesh, given, run_check=False, shape=torch.Size(shape),
                                   stride=(shape[1], 1))
            out[k] = t.redistribute(mesh, placements_for(mesh, spec))
        yield out


if __name__ == "__main__":
    main()
