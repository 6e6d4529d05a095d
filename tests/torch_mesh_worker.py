"""One rank of the 4-rank gloo world of ``tests/test_torch_mesh_train.py``.

Run as ``python tests/torch_mesh_worker.py RANK WORLD STORE OUTDIR``: the
rank joins a gloo world (``file://`` rendezvous at STORE, one torch
thread) and runs the port's mesh paths on CPU tensors on a (2, 2) ("data",
"model") mesh, rank 0 writing what the tests read to ``OUTDIR/world.npz``.
No JAX here: the initial states are
drawn with numpy from the port's own copy of the reference's descriptor
trees (``stacked_model_pd``, the same shapes, init kinds and scales), and
the MoE's inputs come from ``OUTDIR/moe_inputs.npz``, which the test wrote.
"""
import dataclasses
import os
import sys
import time
import warnings
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent.parent / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

#: (arch, fsdp) of the sharded train steps; each with microbatch 0 and 2
TRAIN = (("gemma3-1b", False), ("qwen2-72b", True))
MICROBATCHES = (0, 2)
SCHED = dict(warmup_steps=2, total_steps=10)
BATCH = (4, 32)
STEPS = 2
#: the elastic restore of the fsdp state: meshes the (2, 2) checkpoint is
#: loaded onto (its "embed" dimensions shard over 4 data ranks on both)
RESTORE = {"data4_model1": ((4, 1), ("data", "model")),
           "pod2_data2_model1": ((2, 2, 1), ("pod", "data", "model"))}
LAUNCH = ["--arch", "gemma3-1b", "--reduced", "--steps", "3", "--batch", "4", "--seq", "16",
          "--device", "cpu"]
#: the MoE setting of tests/test_distributed.py::test_shardmap_moe_matches_local,
#: at a capacity factor that drops no token and at one that drops
MOE = dict(n_experts=4, expert_pad_multiple=2, top_k=2)
MOE_CFS = (4.0, 0.5)
MOE_X = (4, 16)


def np_leaf(pd, rng):
    """One leaf of the reference's ``init_params`` drawn with numpy: its
    init kinds and scales (a stacked leaf's fan-in counts its repeats)."""
    if pd.init in ("zeros", "ones"):
        return np.full(pd.shape, 1.0 if pd.init == "ones" else 0.0, np.float32)
    if pd.init == "ssm_A":
        return np.log(rng.uniform(1.0, 16.0, pd.shape)).astype(np.float32)
    fan_in = pd.shape[0] if len(pd.shape) == 1 else int(np.prod(pd.shape[:-1]))
    scale = pd.scale if pd.scale is not None else fan_in ** -0.5
    if pd.init == "embed":
        scale = 1.0 if pd.scale is None else pd.scale
    return (rng.standard_normal(pd.shape) * scale).astype(np.float32)


def draw(tree, rng):
    """``np_leaf`` over a descriptor tree (dicts sorted by key, as the
    reference's flattening order, lists in order)."""
    if isinstance(tree, dict):
        out = {k: draw(tree[k], rng) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, list):
        return [draw(v, rng) for v in tree]
    return np_leaf(tree, rng)


def train_cfg(arch, fsdp):
    from repro_torch.configs import reduced_config
    return dataclasses.replace(reduced_config(arch), fsdp=fsdp)


def initial_state(cfg, tcfg):
    """The port's unsharded initial state on the CPU: the reference's
    parameters drawn by ``np_leaf`` (seed 0), the optimizer's zero state."""
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.models import stacked_model_pd
    from repro_torch.train.steps import _state_for
    tree = draw(stacked_model_pd(cfg), np.random.default_rng(0))
    return _state_for(model_params_from_numpy(tree, cfg, device="cpu"), cfg, tcfg)


def batch(cfg, seed=1):
    return lm_batch(cfg, *BATCH, seed=seed)


def moe_inputs():
    """(params, x) of the MoE check, as numpy."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.layers import moe_pd
    cfg = dataclasses.replace(reduced_config("granite-moe-3b-a800m"), **MOE)
    rng = np.random.default_rng(3)
    params = draw(moe_pd(cfg), rng)
    x = (rng.standard_normal(MOE_X + (cfg.d_model,)) * 0.5).astype(np.float32)
    return params, x


def _full(t):
    """A copy of the whole value (a replicated DTensor's full tensor is its
    local tensor, which later steps update in place)."""
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().clone().numpy()


def _placed(tree, cfg, rules):
    from repro_torch.distributed.mesh import NamedSharding, placements_for
    from repro_torch.train import batch_pspecs
    out = {k: torch.from_numpy(v) for k, v in tree.items()}
    specs = batch_pspecs(cfg, out, rules)
    return {k: NamedSharding(rules.mesh, placements_for(rules.mesh, specs[k])).place(v)
            for k, v in out.items()}


def train_steps(res: dict, mesh) -> None:
    from repro_torch.distributed.mesh import AxisRules, use_rules
    from repro_torch.optim import tree_leaves
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.steps import param_shardings, place_train_state
    for arch, fsdp in TRAIN:
        cfg = train_cfg(arch, fsdp)
        rules = AxisRules(mesh, fsdp=fsdp)
        for mb in MICROBATCHES:
            tag = f"{arch}_mb{mb}"
            tcfg = TrainConfig(**SCHED, microbatch=mb)
            state = place_train_state(initial_state(cfg, tcfg), cfg, tcfg, rules)
            step = make_train_step(cfg, tcfg, param_shardings(state.params, cfg))
            b = _placed(batch(cfg), cfg, rules)
            with use_rules(rules):
                for k in range(STEPS):
                    state, met = step(state, b)
                    for name in ("loss", "grad_norm", "lr"):
                        res[f"{tag}_{name}_{k}"] = float(met[name])
            for name, p in state.params.named_parameters():
                res[f"{tag}_param_{name}"] = _full(p)
            for i, leaf in enumerate(tree_leaves(state.opt_state)):
                res[f"{tag}_opt_{i}"] = _full(leaf)
            if fsdp and mb == 0:
                elastic(res, cfg, tcfg, rules, state)


def elastic(res: dict, cfg, tcfg, rules, state) -> None:
    """Save the (2, 2) state after its steps (recording the bytes each rank
    copied to the host for it), take one more step there (the
    uninterrupted run), and restore the checkpoint onto each mesh of
    ``RESTORE`` through ``Trainer.restore``: every leaf against the saved
    one, then the next step's loss."""
    import torch.distributed as dist

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.distributed.mesh import AxisRules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import tree_leaves
    from repro_torch.train import Trainer, TrainerConfig, state_tree
    root = Path(os.environ["MESH_TEST_OUT"]) / "ckpt"
    rcfg = TrainerConfig(ckpt_dir=str(root), async_ckpt=False)
    saver = Trainer(cfg, tcfg, rcfg, mesh=rules.mesh, rules=rules, state=state)
    # the bytes of the host copies this rank made for the save
    held = [0]
    inner = ckpt._to_host

    def counted(leaf, keep=True):
        out = inner(leaf, keep)
        held[0] += 0 if out is None else out.nbytes
        return out

    ckpt._to_host = counted
    try:
        saver.save(blocking=True)
    finally:
        ckpt._to_host = inner
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, held[0])
    res["elastic_host_bytes"] = np.array(per_rank)
    saved = [_full(x) for x in tree_leaves(state_tree(state, cfg))]
    res["elastic_saved_step"] = int(state.step)
    hist = saver.fit(iter([batch(cfg, seed=2)]), steps=1)
    res["elastic_loss_uninterrupted"] = hist[0]["loss"]
    for name, (shape, axes) in RESTORE.items():
        target = make_mesh(shape, axes, device_type="cpu")
        trules = AxisRules(target, fsdp=cfg.fsdp)
        fresh = initial_state(cfg, tcfg)
        tr = Trainer(cfg, tcfg, rcfg, mesh=target, rules=trules, state=fresh)
        res[f"elastic_{name}_step"] = tr.restore()
        got = [_full(x) for x in tree_leaves(state_tree(tr.state, cfg))]
        res[f"elastic_{name}_bit_equal"] = len(got) == len(saved) and all(
            a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
            for a, b in zip(got, saved))
        res[f"elastic_{name}_sharded"] = sum(
            any(p.is_shard() for p in x.placements) for x in tree_leaves(tr.state.opt_state)
            if hasattr(x, "placements"))
        res[f"elastic_{name}_loss"] = tr.fit(iter([batch(cfg, seed=2)]), steps=1)[0]["loss"]
    dist.barrier()


def launch(res: dict) -> None:
    from repro_torch.launch import train as launcher
    ckpt = Path(os.environ["MESH_TEST_OUT"]) / "launch_ckpt"
    out = launcher.main(LAUNCH + ["--mesh", "2x2", "--ckpt-dir", str(ckpt)])
    res["launch_loss"] = np.array([h["loss"] for h in out["history"]])
    res["launch_mesh"] = "x".join(map(str, out["trainer"].mesh.shape))


def moe(res: dict, mesh) -> None:
    from repro_torch.configs import reduced_config
    from repro_torch.distributed.mesh import AxisRules, NamedSharding, P, placements_for, use_rules
    from repro_torch.models import layers as L
    from repro_torch.models.params import place_module
    rules = AxisRules(mesh)
    with np.load(Path(os.environ["MESH_TEST_OUT"]) / "moe_inputs.npz") as f:
        arrays = {k: f[k] for k in f.files}
    for cf in MOE_CFS:
        cfg = dataclasses.replace(reduced_config("granite-moe-3b-a800m"), **MOE,
                                  capacity_factor=cf)
        m = L.MoE(cfg, dtype=torch.float32)
        with torch.no_grad():
            for name, p in m.named_parameters():
                p.copy_(torch.from_numpy(arrays[name]))
        place_module(m, rules)
        x = NamedSharding(mesh, placements_for(mesh, P("data"))).place(
            torch.from_numpy(arrays["x"])).requires_grad_()
        with use_rules(rules):
            y = m(x, cfg)
            grads = torch.autograd.grad((y * y).sum(), [x] + list(m.parameters()))
        res[f"moe_{cf}_y"] = _full(y)
        for name, g in zip(["x"] + [n for n, _ in m.named_parameters()], grads):
            res[f"moe_{cf}_g_{name}"] = _full(g)


def lm_batch(cfg, B: int, S: int, seed: int = 1) -> dict:
    """``tests/torch_lm_parity.py``'s ``make_batch``: numpy inputs of the
    config's frontend."""
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "embeds":
        batch["embeds"] = (rng.standard_normal((B, S, cfg.d_model)) * 0.05).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.frontend == "tokens+vision":
        batch["vision_embeds"] = (rng.standard_normal((B, cfg.n_image_tokens, cfg.d_vision))
                                  * 0.05).astype(np.float32)
    return batch


#: every architecture's reduced config under fsdp rules, one forward and
#: backward of ARCH_BATCH
ARCH_BATCH = (4, 32)


def arch_model(arch):
    """(cfg with fsdp, the model drawn from seed 0 on the CPU)."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import model_params
    cfg = dataclasses.replace(reduced_config(arch), fsdp=True)
    return cfg, model_params(torch.Generator().manual_seed(0), cfg, device="cpu")


def archs(res: dict, mesh) -> None:
    from repro_torch.configs import ARCH_IDS
    from repro_torch.distributed.mesh import AxisRules, use_rules
    from repro_torch.models import loss_fn, place_module
    for arch in ARCH_IDS:
        cfg, model = arch_model(arch)
        rules = AxisRules(mesh, fsdp=True)
        place_module(model, rules)
        b = _placed(lm_batch(cfg, *ARCH_BATCH), cfg, rules)
        with use_rules(rules):
            loss, _ = loss_fn(model, cfg, b)
            grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
        res[f"{arch}_loss"] = float(loss.full_tensor())
        res[f"{arch}_sharded"] = sum(any(p.is_shard() for p in w.placements)
                                     for w in model.parameters())
        for (name, _), g in zip(model.named_parameters(), grads):
            if g is not None:
                res[f"{arch}_g_{name}"] = _full(g)


def main(rank: int, world: int, store: str, out: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    warnings.simplefilter("ignore")
    os.environ["MESH_TEST_OUT"] = out
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    try:
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        res: dict = {}
        for part in (moe, train_steps, launch, archs):
            t0 = time.perf_counter()
            part(res, mesh) if part is not launch else part(res)
            res[f"seconds_{part.__name__}"] = time.perf_counter() - t0
        if rank == 0:
            np.savez(os.path.join(out, "world.npz"), **{k: np.asarray(v) for k, v in res.items()})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
