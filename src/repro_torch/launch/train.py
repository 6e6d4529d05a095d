"""Training launcher.

Counterpart of ``repro/launch/train.py``, with its flags:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b --steps 100 \\
        [--reduced] [--ckpt-dir DIR] [--device cuda]

trains the architecture (its full config, or the reduced one with
``--reduced``) on the synthetic token stream with the ``Trainer``:
checkpoints and restart, straggler reports, and a blocking save when the
process gets SIGTERM. It runs on the card unless ``--device cpu``.
``--mesh`` (the reference's production mesh) waits for the sharding rules,
ROADMAP.md item A15.3, and is refused.
"""
from __future__ import annotations

import argparse
import signal

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.data import TokenStreamConfig, token_stream
from repro_torch.train import TrainConfig, Trainer, TrainerConfig


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
    if args.mesh:
        raise NotImplementedError("--mesh: the sharding rules are not ported "
                                  "(ROADMAP.md item A15.3)")

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    tcfg = TrainConfig(
        learning_rate=args.lr,
        warmup_steps=args.steps // 10,
        total_steps=args.steps,
        microbatch=args.microbatch,
        grad_compression=args.grad_compression,
    )
    rcfg = TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=max(10, args.steps // 5))
    trainer = Trainer(
        cfg, tcfg, rcfg, device=args.device,
        straggler_cb=lambda i, dt, z: print(f"[straggler] step {i}: {dt*1e3:.0f}ms "
                                            f"(z={z:.1f})"),
    )
    previous = signal.signal(signal.SIGTERM, lambda *_: trainer.request_preemption())
    try:
        stream = token_stream(TokenStreamConfig(vocab=min(cfg.vocab, 4096), seq_len=args.seq,
                                                batch=args.batch), device=trainer.device)
        hist = trainer.fit(stream, steps=args.steps)
    finally:
        signal.signal(signal.SIGTERM, previous)
    if hist:
        print(f"{len(hist)} steps; loss {hist[0]['loss']:.4f} -> "
              f"{hist[-1]['loss']:.4f}; stragglers={len(trainer.straggler_events)}")
    return {"history": hist, "trainer": trainer}


if __name__ == "__main__":
    main()
