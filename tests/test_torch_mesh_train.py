"""The port's LM substrate on a mesh (DTensor) against its single-device
path and the JAX package's.

The port runs as one gloo world of 4 CPU processes on a (2, 2) ("data",
"model") mesh, each rank running ``tests/torch_mesh_worker.py`` (one torch
thread, ``file://`` rendezvous, the world's own timeout: a hung rank fails
this file's world tests and nothing else). Beside it, the reference's
expert-parallel MoE runs in a subprocess over 4 forced host devices, as
``tests/test_distributed.py`` runs it, and this process computes the
single-device runs: the reference's jitted train step (matmuls at
"highest") and the port's unsharded step from the same initial state (the
reference's parameters drawn with numpy, carried across by
``convert.model_params_from_numpy``). The same world also runs every
architecture's reduced config under ``AxisRules(fsdp=True)``, one
forward and backward through the DTensor path (the rules' activations,
the expert-parallel MoE of granite, kimi and jamba, Mamba-2, MLA, cross
attention, frame embeddings), against the same model and inputs on one
device here, which ``tests/test_torch_lm_models.py`` holds to the
reference.

Tolerances: losses and gradient norms rtol 1e-5 (fp32, the sharded step
reduces its partial sums in another order); parameters normwise on their
change, ||(p - p0) - (p_ref - p0)|| <= 1e-2 ||p_ref - p0|| (AdamW's and
Adafactor's first updates are about lr * sign(g): where |g| is tiny its
last bits decide, as ``tests/test_torch_train.py`` holds them), optimizer
state normwise 1e-3; the MoE at the reference test's rtol = atol = 2e-4;
restored checkpoint leaves bit for bit; each architecture's loss rtol
1e-5 and each gradient normwise 2e-4 (fp32; the mesh sums partial
products in another order: measured up to 6.1e-5, on Mamba-2's
``A_log``, whose gradient cancels along the scan; 1e-5 or less
elsewhere).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from repro import configs as jc
from repro.models import layers as JL
from repro.models.model import model_pd as j_model_pd
from repro.optim import make_optimizer as j_make_optimizer
from repro.train import TrainConfig as JTrainConfig
from repro.train import TrainState as JTrainState
from repro.train import make_train_step as j_make_train_step
from repro_torch import configs as tc
from repro_torch.configs import ARCH_IDS
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch import train as launcher
from repro_torch.models import loss_fn
from repro_torch.models import model as tmodel
from repro_torch.optim import tree_leaves
from repro_torch.train import TrainConfig, make_train_step

jax.config.update("jax_default_matmul_precision", "highest")

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
WORLD = 4
WORLD_TIMEOUT = 750
REF_TIMEOUT = 300
STEP_RTOL = 1e-5
PARAM_REL = 1e-2
STATE_REL = 1e-3
MOE_TOL = dict(rtol=2e-4, atol=2e-4)
ARCH_LOSS_RTOL, ARCH_GRAD_REL = 1e-5, 2e-4

_REF_MOE = """
import dataclasses, jax, jax.numpy as jnp, numpy as np
from repro.configs import reduced_config
from repro.distributed.mesh import AxisRules, use_rules
from repro.models import layers as L
jax.config.update("jax_default_matmul_precision", "highest")
assert len(jax.devices()) == 4
with np.load({inputs!r}) as f:
    a = {{k: f[k] for k in f.files}}
x = jnp.asarray(a.pop("x"))
p = {{k: jnp.asarray(v) for k, v in a.items()}}
mesh = jax.make_mesh((2, 2), ("data", "model"))
for cf in {cfs!r}:
    cfg = dataclasses.replace(reduced_config("granite-moe-3b-a800m"), n_experts=4,
                              expert_pad_multiple=2, top_k=2, capacity_factor=cf)
    with mesh, use_rules(AxisRules(mesh=mesh)):
        y = jax.jit(lambda p, x: L.moe_apply(p, x, cfg))(p, x)
        gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(L.moe_apply(p, x, cfg) ** 2),
                                  argnums=(0, 1)))(p, x)
    np.savez({out!r}.format(cf), y=np.asarray(y), g_x=np.asarray(gx),
             **{{"g_" + k: np.asarray(v) for k, v in gp.items()}})
"""


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", **extra)
    return env


class _Run:
    """Processes started together, waited on with one deadline."""

    def __init__(self, name: str, cmds: list, env: dict, logdir: Path, timeout: float):
        self.name, self.timeout, self.logs, self.procs = name, timeout, [], []
        self.deadline = time.monotonic() + timeout
        for i, cmd in enumerate(cmds):
            log = logdir / f"{name}_{i}.log"
            self.logs.append(log)
            with open(log, "w") as fh:
                self.procs.append(subprocess.Popen(cmd, env=env, stdout=fh,
                                                   stderr=subprocess.STDOUT, cwd=HERE.parent))
        self.error, self.waited = None, False

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def wait(self) -> None:
        """Fail (for every test that needs this run) on a timeout or a
        non-zero exit, with each process's log."""
        if not self.waited:
            self.waited = True
            try:
                for p in self.procs:
                    p.wait(timeout=max(self.deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                self.error = f"{self.name} overran its {self.timeout} s timeout"
            self.kill()
            bad = [p.returncode for p in self.procs if p.returncode != 0]
            if self.error is None and bad:
                self.error = f"{self.name} exited {bad}"
            if self.error:
                self.error += "".join(f"\n--- {log.name}\n" + log.read_text()[-4000:]
                                      for log in self.logs)
        if self.error:
            pytest.fail(self.error)


@pytest.fixture(scope="module")
def _runs(tmp_path_factory):
    """The world and the reference's sharded MoE, started at once."""
    tmp = tmp_path_factory.mktemp("mesh")
    params, x = W.moe_inputs()
    np.savez(tmp / "moe_inputs.npz", x=x, **params)
    ref_env = _env(XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu")
    code = textwrap.dedent(_REF_MOE).format(inputs=str(tmp / "moe_inputs.npz"), cfs=W.MOE_CFS,
                                            out=str(tmp / "ref_moe_{}.npz"))
    runs = {"ref_moe": _Run("ref_moe", [[sys.executable, "-c", code]], ref_env, tmp,
                            REF_TIMEOUT)}
    runs["world"] = _Run("world", [[sys.executable, str(HERE / "torch_mesh_worker.py"), str(r),
                                    str(WORLD), str(tmp / "store"), str(tmp)]
                                   for r in range(WORLD)], _env(), tmp, WORLD_TIMEOUT)
    yield tmp, runs
    for run in runs.values():
        run.kill()


def _load(path: Path) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def world(_runs):
    tmp, runs = _runs
    runs["world"].wait()
    return _load(tmp / "world.npz")


@pytest.fixture(scope="module")
def singles(_runs):
    """The single-device runs, computed while the world runs: the
    reference's and the port's unsharded train steps, the reference's
    local MoE."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {(arch, mb): (_reference_steps(arch, fsdp, mb), _port_steps(arch, fsdp, mb))
               for arch, fsdp in W.TRAIN for mb in W.MICROBATCHES}
        out["moe"] = _ref_moe_local(W.MOE_CFS[0])
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference_steps(arch, fsdp, mb):
    """The reference's jitted step, 2 steps from ``W.initial_state``'s
    values: (metrics per step, final state as numpy)."""
    jcfg = dataclasses.replace(jc.reduced_config(arch), fsdp=fsdp)
    rng = np.random.default_rng(0)
    params = jax.tree.map(jnp.asarray, W.draw(j_model_pd(jcfg), rng))
    jt = JTrainConfig(**W.SCHED, microbatch=mb)
    state = JTrainState(params=params, opt_state=j_make_optimizer(jcfg.optimizer).init(params),
                        residuals={}, step=jnp.zeros((), jnp.int32))
    step = jax.jit(j_make_train_step(jcfg, jt))
    b = {k: jnp.asarray(v) for k, v in W.batch(jcfg).items()}
    mets = []
    for _ in range(W.STEPS):
        state, m = step(state, b)
        mets.append({k: float(v) for k, v in m.items()})
    return mets, jax.tree.map(np.asarray, state)


def _port_steps(arch, fsdp, mb):
    cfg = W.train_cfg(arch, fsdp)
    tcfg = TrainConfig(**W.SCHED, microbatch=mb)
    state = W.initial_state(cfg, tcfg)
    step = make_train_step(cfg, tcfg)
    b = {k: torch.from_numpy(v) for k, v in W.batch(cfg).items()}
    mets = []
    for _ in range(W.STEPS):
        state, m = step(state, b)
        mets.append({k: float(v) for k, v in m.items()})
    return mets, state


@pytest.mark.parametrize("mb", W.MICROBATCHES)
@pytest.mark.parametrize("arch,fsdp", W.TRAIN)
def test_sharded_train_steps_match(singles, world, one_thread, arch, fsdp, mb):
    """2 steps on the (2, 2) mesh against the port's unsharded steps and the
    reference's: losses, gradient norms, parameters, optimizer state."""
    tag = f"{arch}_mb{mb}"
    (ref_mets, ref), (mets, plain) = singles[arch, mb]
    for k in range(W.STEPS):
        for name in ("loss", "grad_norm", "lr"):
            got = float(world[f"{tag}_{name}_{k}"])
            np.testing.assert_allclose(got, mets[k][name], rtol=STEP_RTOL,
                                       err_msg=f"{tag} step {k} {name} vs unsharded")
            np.testing.assert_allclose(got, ref_mets[k][name], rtol=STEP_RTOL,
                                       err_msg=f"{tag} step {k} {name} vs the reference")
    cfg = W.train_cfg(arch, fsdp)
    p0 = dict(W.initial_state(cfg, TrainConfig(**W.SCHED)).params.named_parameters())
    ref_params = dict(model_params_from_numpy(ref.params, cfg, device="cpu").named_parameters())
    for name, p in plain.params.named_parameters():
        got = world[f"{tag}_param_{name}"] - p0[name].detach().numpy()
        for want, what in ((p.detach().numpy(), "unsharded"),
                           (ref_params[name].detach().numpy(), "reference")):
            change = want - p0[name].detach().numpy()
            assert np.linalg.norm(change) > 0, (tag, name)
            assert _rel(got, change) <= PARAM_REL, (tag, name, what, _rel(got, change))
    want_opt = tree_leaves(plain.opt_state)
    ref_opt = jax.tree.leaves(ref.opt_state)
    assert len(want_opt) == len(ref_opt)
    for i, (w, r) in enumerate(zip(want_opt, ref_opt)):
        got = world[f"{tag}_opt_{i}"]
        assert got.shape == tuple(w.shape) == r.shape, (tag, i)
        assert _rel(got, w.numpy()) <= STATE_REL, (tag, i, "unsharded", _rel(got, w.numpy()))
        assert _rel(got, r) <= STATE_REL, (tag, i, "reference", _rel(got, r))


def _ref_moe_local(cf):
    cfg = dataclasses.replace(jc.reduced_config("granite-moe-3b-a800m"), **W.MOE,
                              capacity_factor=cf)
    params, x = W.moe_inputs()
    p = {k: jnp.asarray(v) for k, v in params.items()}
    y = JL._moe_local(p, jnp.asarray(x), cfg)
    gp, gx = jax.grad(lambda p, x: jnp.sum(JL._moe_local(p, x, cfg) ** 2), argnums=(0, 1))(
        p, jnp.asarray(x))
    return {"y": np.asarray(y), "g_x": np.asarray(gx),
            **{"g_" + k: np.asarray(v) for k, v in gp.items()}}


def _moe_pairs(world, cf, ref):
    yield "y", world[f"moe_{cf}_y"], ref["y"]
    for name in ("x", "router", "w_gate", "w_up", "w_down"):
        yield f"grad {name}", world[f"moe_{cf}_g_{name}"], ref[f"g_{name}"]


def test_moe_sharded_matches_local_without_drops(singles, world):
    """At capacity factor 4 no token is dropped: the port's expert-parallel
    MoE (two all_to_alls over the "model" group) against the reference's
    ``_moe_local``, forward and gradients."""
    ref = singles["moe"]
    for what, got, want in _moe_pairs(world, W.MOE_CFS[0], ref):
        np.testing.assert_allclose(got, want, **MOE_TOL, err_msg=what)


def test_moe_sharded_matches_reference_sharded_with_drops(_runs, world):
    """At capacity factor 0.5 tokens are dropped at each rank's capacity
    ceil(T_local K cf / E): the port against the reference's own sharded
    ``moe_apply`` on a jax (2, 2) mesh, forward and gradients."""
    tmp, runs = _runs
    cf = W.MOE_CFS[1]
    runs["ref_moe"].wait()
    ref = _load(tmp / f"ref_moe_{cf}.npz")
    for what, got, want in _moe_pairs(world, cf, ref):
        np.testing.assert_allclose(got, want, **MOE_TOL, err_msg=what)
    # it drops: the no-drop output differs
    assert np.abs(world[f"moe_{cf}_y"] - world[f"moe_{W.MOE_CFS[0]}_y"]).max() > 1e-3


def test_moe_reference_sharded_without_drops_agrees(_runs, world):
    tmp, runs = _runs
    cf = W.MOE_CFS[0]
    runs["ref_moe"].wait()
    ref = _load(tmp / f"ref_moe_{cf}.npz")
    for what, got, want in _moe_pairs(world, cf, ref):
        np.testing.assert_allclose(got, want, **MOE_TOL, err_msg=what)


@pytest.mark.parametrize("target", list(W.RESTORE))
def test_elastic_restore_is_bit_equal(world, target):
    """The (2, 2) checkpoint restored onto another mesh through
    ``Trainer.restore``: every leaf bit-equal to the saved one, the state
    sharded on the target, and the next step's loss that of the
    uninterrupted run."""
    assert int(world["elastic_saved_step"]) == int(world[f"elastic_{target}_step"]) == W.STEPS
    assert bool(world[f"elastic_{target}_bit_equal"])
    assert int(world[f"elastic_{target}_sharded"]) > 0
    np.testing.assert_allclose(float(world[f"elastic_{target}_loss"]),
                               float(world["elastic_loss_uninterrupted"]), rtol=STEP_RTOL)


def test_checkpoint_from_a_mesh_is_copied_to_the_host_on_rank_0_alone(world):
    """Saving the (2, 2) state gathers every leaf on every rank (a
    collective) and copies it to the host on rank 0 alone: ranks 1-3 hold
    no host copy of the state."""
    held = world["elastic_host_bytes"]
    assert held.shape == (WORLD,)
    assert int(held[0]) > 0
    assert all(int(b) == 0 for b in held[1:]), held


def test_launch_train_mesh_2x2(world, tmp_path, one_thread):
    """``launch/train.py --mesh 2x2`` trains 3 steps; its losses are the
    single-device launcher's on the same stream."""
    got = world["launch_loss"]
    assert str(world["launch_mesh"]) == "2x2" and got.shape == (3,)
    want = launcher.main(W.LAUNCH + ["--ckpt-dir", str(tmp_path)])["history"]
    np.testing.assert_allclose(got, [h["loss"] for h in want], rtol=STEP_RTOL)


def _deep_cfg():
    """A narrow config of 16 identical global-attention layers with remat:
    n_per 16, a = 4, so the two-level checkpointing runs 4 groups of 4."""
    base = tc.reduced_config("qwen2-72b")
    cfg = dataclasses.replace(base, n_layers=16, layer_pattern=base.layer_pattern[:1] * 16,
                              remat="full")
    period, n_per, tail = tmodel.split_periods(cfg.layer_pattern)
    assert (len(period), n_per, tail, tmodel._sqrt_factor(n_per)) == (1, 16, (), 4)
    return cfg


def test_sqrt_checkpointing_matches_one_level_remat(one_thread, monkeypatch):
    """Two-level (sqrt) checkpointing changes memory only: the loss and every
    gradient equal those of one-level remat and of no remat."""
    cfg = _deep_cfg()
    model = tmodel.model_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in W.batch(cfg).items()}
    calls = []
    inner = tmodel._checkpointed_layers

    def counted(layers, *a):
        calls.append(len(layers))
        return inner(layers, *a)

    def run(c):
        loss, _ = loss_fn(model, c, b)
        return loss, torch.autograd.grad(loss, list(model.parameters()))

    monkeypatch.setattr(tmodel, "_checkpointed_layers", counted)
    loss2, g2 = run(cfg)
    assert calls[:4] == [4, 4, 4, 4], calls          # 4 outer groups of 4 layers
    monkeypatch.setattr(tmodel, "_sqrt_factor", lambda n: 1)
    calls.clear()
    loss1, g1 = run(cfg)
    assert calls[:1] == [16], calls
    loss0, g0 = run(dataclasses.replace(cfg, remat="none"))
    assert torch.equal(loss2, loss1)
    assert all(torch.equal(a, b) for a, b in zip(g2, g1))
    torch.testing.assert_close(loss2, loss0, rtol=1e-6, atol=0)
    for a, b in zip(g2, g0):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_trainer_on_a_mesh_is_freed_without_the_cycle_collector(tmp_path, one_thread):
    """A Trainer on a mesh holds no reference cycle: dropping it frees its
    state at once (on a card, a state left to the cycle collector holds
    gigabytes until it runs)."""
    import gc
    import weakref

    import torch.distributed as dist

    from repro_torch.distributed.mesh import AxisRules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import Trainer, TrainerConfig
    cfg = tc.reduced_config("gemma3-1b")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    gc.disable()
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        tr = Trainer(cfg, TrainConfig(**W.SCHED), TrainerConfig(ckpt_dir=str(tmp_path / "c")),
                     mesh=mesh, rules=AxisRules(mesh), device="cpu")
        tr.fit(iter([W.batch(cfg)]), steps=1)
        alive = weakref.ref(tr)
        del tr
        assert alive() is None
    finally:
        gc.enable()
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_forward_backward_on_mesh(world, arch, one_thread):
    """One forward and backward of the architecture's reduced config on
    the (2, 2) mesh under fsdp rules against one device: the loss, and
    every gradient (a parameter unused on one device has none on the
    mesh)."""
    cfg, model = W.arch_model(arch)
    b = {k: torch.from_numpy(v) for k, v in W.lm_batch(cfg, *W.ARCH_BATCH).items()}
    loss, _ = loss_fn(model, cfg, b)
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    np.testing.assert_allclose(float(world[f"{arch}_loss"]), float(loss.detach()),
                               rtol=ARCH_LOSS_RTOL)
    assert int(world[f"{arch}_sharded"]) > 0, "nothing of the model was sharded"
    n = 0
    for (name, _), g in zip(model.named_parameters(), grads):
        if g is None:
            assert f"{arch}_g_{name}" not in world, name
            continue
        rel = _rel(world[f"{arch}_g_{name}"], g.numpy())
        assert rel <= ARCH_GRAD_REL, (arch, name, rel)
        n += 1
    assert n > 0
