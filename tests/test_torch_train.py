"""The port's train step, remat, Trainer and launcher against the JAX package's.

Both packages start from one ``TrainState``: the reference's, its
parameters drawn with numpy at the reference's init kinds and scales and
its optimizer state and residuals from its own ``init``, carried across as
numpy by ``convert.train_state_from_numpy``. Each reduced config (fp32) takes 2
steps on the same batch in both (the reference's step jitted, matmuls at
"highest"): the loss and the gradient norm at each step agree to rtol
1e-5; then the parameters and the optimizer state. AdamW's and Adafactor's
first updates are about lr * sign(g), so where |g| is tiny its last bits
decide the update: the parameters are held normwise on their change, each
leaf's ||(p_port - p_0) - (p_ref - p_0)|| <= 1e-2 ||p_ref - p_0||, and
each optimizer-state leaf normwise to 1e-3 of its norm (5e-3 with int8
error feedback, whose dequantized gradient moves by a quantization unit
where a value sits at a rounding boundary). The error-feedback residuals
jump by up to that unit at such a value, and carry the jump into the next
step: all but at most 5% of a leaf's entries agree to 1e-3 of its largest.
"""
import dataclasses
import os
import signal
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jc
from repro.distributed.compression import init_residuals
from repro.models.model import model_pd
from repro.models.params import PD
from repro.optim import make_optimizer
from repro.train import TrainConfig as JTrainConfig
from repro.train import TrainState as JTrainState
from repro.train import make_train_step as j_make
from repro_torch import configs as tc
from repro_torch import models as tm
from repro_torch.convert import model_params_from_numpy, train_state_from_numpy
from repro_torch.optim import tree_leaves
from repro_torch.train import (TrainConfig, Trainer, TrainerConfig, batch_pspecs,
                               init_train_state, make_serve_step, make_train_step,
                               state_tree, train_state_pspecs, train_state_structs)
from torch_lm_parity import J, T, _one_thread, make_batch  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")

ARCHS = jc.ARCH_IDS
SCHED = dict(warmup_steps=2, total_steps=10)
STEP_RTOL = 1e-5
PARAM_REL = 1e-2
STATE_REL = {False: 1e-3, True: 5e-3}
RESIDUAL_AGREE, RESIDUAL_FLIPS = 1e-3, 0.05


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np_leaf(pd, rng):
    """One leaf of ``repro.models.params.init_params``, drawn with numpy: the
    same init kinds and scales (a stacked leaf's fan-in counts its repeats)
    without the reference's per-leaf compiles."""
    if pd.init in ("zeros", "ones"):
        return np.full(pd.shape, 1.0 if pd.init == "ones" else 0.0, np.float32)
    if pd.init == "ssm_A":
        return np.log(rng.uniform(1.0, 16.0, pd.shape)).astype(np.float32)
    fan_in = pd.shape[0] if len(pd.shape) == 1 else int(np.prod(pd.shape[:-1]))
    scale = pd.scale if pd.scale is not None else fan_in ** -0.5
    if pd.init == "embed":
        scale = 1.0 if pd.scale is None else pd.scale
    return (rng.standard_normal(pd.shape) * scale).astype(np.float32)


def _reference_state(jcfg, jt, seed=0):
    """The reference's initial ``TrainState`` (its optimizer's and residuals'
    own ``init``) on parameters drawn by ``_np_leaf``."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda pd: jnp.asarray(_np_leaf(pd, rng)), model_pd(jcfg),
                          is_leaf=lambda x: isinstance(x, PD))
    return JTrainState(params=params, opt_state=make_optimizer(jcfg.optimizer).init(params),
                       residuals=init_residuals(params) if jt.grad_compression else {},
                       step=jnp.zeros((), jnp.int32))


def _run_both(arch, **train_kw):
    jcfg, tcfg = jc.reduced_config(arch), tc.reduced_config(arch)
    jt, tt = JTrainConfig(**SCHED, **train_kw), TrainConfig(**SCHED, **train_kw)
    js = _reference_state(jcfg, jt)
    ts = train_state_from_numpy(jax.tree.map(np.asarray, js), tcfg, tt, device="cpu")
    p0 = {k: v.detach().clone() for k, v in ts.params.named_parameters()}
    batch = make_batch(jcfg, 4, 32)
    jstep, tstep = jax.jit(j_make(jcfg, jt)), make_train_step(tcfg, tt)
    for k in range(2):
        js, jm = jstep(js, J(batch))
        ts, tmet = tstep(ts, T(batch))
        for name in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[name]), float(jm[name]), rtol=STEP_RTOL,
                                       err_msg=f"{arch} step {k}: {name}")
    ref = jax.tree.map(np.asarray, js)
    assert int(ts.step) == int(ref.step) == 2
    ref_model = model_params_from_numpy(ref.params, tcfg, device="cpu")
    for (name, p), (_, r) in zip(ts.params.named_parameters(), ref_model.named_parameters()):
        change, ref_change = p.detach() - p0[name], r.detach() - p0[name]
        assert float(ref_change.norm()) > 0, name
        assert _rel(change, ref_change) <= PARAM_REL, (arch, name, _rel(change, ref_change))
    tol = STATE_REL[train_kw.get("grad_compression", False)]
    for what in ("opt_state", "residuals"):
        got, want = tree_leaves(getattr(ts, what)), jax.tree.leaves(getattr(ref, what))
        assert len(got) == len(want), (arch, what)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape, (arch, what)
            if what == "opt_state":
                assert _rel(g, w) <= tol, (arch, what, g.shape, _rel(g, w))
                continue
            off = np.abs(g.numpy() - w) > RESIDUAL_AGREE * np.abs(w).max()
            assert off.sum() <= RESIDUAL_FLIPS * w.size, (arch, g.shape, off.sum())
    return ts


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch):
    """Two steps of every architecture (AdamW for six, Adafactor on the
    stacked leaves for jamba, qwen2, llama-vision and kimi)."""
    _run_both(arch)


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2-72b"])
def test_microbatches_and_int8_error_feedback_match_reference(arch):
    """microbatch=2 (fp32 accumulation of g / 2) with grad_compression on
    (int8 error feedback, one scale a stacked leaf): gemma3 (AdamW) and
    qwen2 (Adafactor)."""
    ts = _run_both(arch, microbatch=2, grad_compression=True)
    assert ts.residuals and all(float(r.abs().max()) > 0 for r in tree_leaves(ts.residuals))


def test_grad_tree_has_the_reference_layout():
    """``param_tree`` of a converted model is the reference's tree: every
    stacked leaf is its repeats' tensors, the reference's leaf order."""
    jcfg, tcfg = jc.reduced_config("gemma3-1b"), tc.reduced_config("gemma3-1b")
    rng = np.random.default_rng(3)
    tree = jax.tree.map(lambda pd: _np_leaf(pd, rng), model_pd(jcfg),
                        is_leaf=lambda x: isinstance(x, PD))
    model = model_params_from_numpy(tree, tcfg, device="cpu")
    got = tree_leaves(tm.param_tree(model, tcfg))
    want = jax.tree.leaves(tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


def jc_params(cfg):
    from repro.models import model_params
    return model_params(jax.random.PRNGKey(3), cfg)


def test_init_scales_are_the_references():
    """The port's draws have the reference's per-leaf scale: a period
    layer's is that of the stacked leaf, whose fan-in counts the repeats
    (each leaf's standard deviation within 10%)."""
    cfg, jcfg = tc.reduced_config("qwen2-72b"), jc.reduced_config("qwen2-72b")
    ref = jax.tree.map(np.asarray, jc_params(jcfg))
    assert len(ref["period"][0]["mlp"]["w_up"]) == 2          # 2 repeats: a 1/sqrt(2) scale
    model = tm.model_params(torch.Generator().manual_seed(0), cfg)
    for g, w in zip(tree_leaves(tm.param_tree(model, cfg)), jax.tree.leaves(ref)):
        if w.std() > 0:
            assert abs(float(g.std()) / float(w.std()) - 1) < 0.1, (g.shape, g.std(), w.std())


@pytest.mark.parametrize("arch", ["gemma3-1b", "jamba-1.5-large-398b", "llama-3.2-vision-90b"])
def test_remat_gives_the_same_gradients(arch):
    """remat="full" recomputes each layer and each CE chunk in the backward
    pass (each layer's forward starts twice) and changes no bit of the loss
    or the gradients."""
    cfg = tc.reduced_config(arch)
    batch = T(make_batch(cfg, 2, 32))
    out = {}
    for remat in ("none", "full"):
        c = dataclasses.replace(cfg, remat=remat)
        model = tm.model_params(torch.Generator().manual_seed(0), c)
        calls = [0]
        for block in model.layers:
            block.register_forward_pre_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))
        loss, _ = tm.loss_fn(model, c, batch, ce_chunk=16)
        grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
        out[remat] = (loss, grads, calls[0])
    (l0, g0, n0), (l1, g1, n1) = out["none"], out["full"]
    assert n0 == cfg.n_layers and n1 == 2 * cfg.n_layers
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert (a is None and b is None) or torch.equal(a, b)


def _tiny():
    return tc.reduced_config("gemma3-1b"), TrainConfig(warmup_steps=2, total_steps=20)


def _stream(cfg, seed=0):
    from repro_torch.data import TokenStreamConfig, token_stream
    return token_stream(TokenStreamConfig(vocab=cfg.vocab, seq_len=16, batch=2), seed=seed)


def _leaves(trainer):
    return tree_leaves(state_tree(trainer.state, trainer.cfg))


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_trainer_restarts_from_latest_and_keeps_last(tmp_path, async_ckpt):
    """Saves every 2 steps keep the last 2 (async, as the reference's, the
    collection after a save does not yet see the save in flight: one more
    stays); a new trainer resumes at the latest, bit-equal, and goes on as
    the first."""
    cfg, tcfg = _tiny()
    rcfg = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=2, keep_last=2,
                         async_ckpt=async_ckpt)
    tr = Trainer(cfg, tcfg, rcfg, device="cpu")
    hist = tr.fit(_stream(cfg), steps=6)
    assert len(hist) == 6 and all(isinstance(v, float) for v in hist[0].values())
    kept = ["step_00000004", "step_00000006"]
    assert sorted(os.listdir(tmp_path)) == (["step_00000002"] if async_ckpt else []) + kept
    again = Trainer(cfg, tcfg, rcfg, device="cpu")
    assert int(again.state.step) == 6
    assert all(torch.equal(a, b) for a, b in zip(_leaves(tr), _leaves(again)))
    # a fresh trainer on an empty directory starts at step 0, from seed 0
    fresh = Trainer(cfg, tcfg, TrainerConfig(ckpt_dir=str(tmp_path / "none")), device="cpu")
    assert int(fresh.state.step) == 0
    with pytest.raises(FileNotFoundError):
        fresh.restore()
    # the restarted trainer continues as the first would have: same batches
    # after step 6 give the same state
    tr.fit((b for i, b in enumerate(_stream(cfg)) if i >= 6), steps=2)
    again.fit((b for i, b in enumerate(_stream(cfg)) if i >= 6), steps=2)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(tr), _leaves(again)))


def test_trainer_saves_on_preemption(tmp_path):
    cfg, tcfg = _tiny()
    rcfg = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=0)
    tr = Trainer(cfg, tcfg, rcfg, device="cpu")

    def stream():
        for i, b in enumerate(_stream(cfg)):
            if i == 3:
                tr.request_preemption()
            yield b

    hist = tr.fit(stream(), steps=10)
    assert len(hist) == 3 and tr.preempted
    assert os.listdir(tmp_path) == ["step_00000003"]


def test_trainer_reports_a_slowed_step(tmp_path, monkeypatch):
    """The straggler z-score, on a clock the test drives (10 ms a step with
    a 0.3 ms wobble, 500 ms for the 10th): exactly that step is reported,
    with its index and time, to the callback and in ``straggler_events``."""
    from repro_torch.train import trainer as trainer_mod
    cfg, tcfg = _tiny()
    events = []
    tr = Trainer(cfg, tcfg, TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=0),
                 straggler_cb=lambda i, dt, z: events.append((i, dt, z)), device="cpu")
    clock, calls, step_fn = [0.0], [0], tr.step_fn

    def timed(state, batch):
        calls[0] += 1
        clock[0] += 0.5 if calls[0] == 10 else 0.010 + 0.0003 * (calls[0] % 3)
        return step_fn(state, batch)

    tr.step_fn = timed
    monkeypatch.setattr(trainer_mod, "time", types.SimpleNamespace(perf_counter=lambda: clock[0]))
    tr.fit(_stream(cfg), steps=12)
    assert [e[0] for e in events] == [9] == [i for i, _ in tr.straggler_events]
    assert abs(events[0][1] - 0.5) < 1e-9 and events[0][2] > tr.rcfg.straggler_zscore
    assert len(tr.step_seconds) == 12


def test_state_structs_serve_step_and_refusals():
    cfg, tcfg = tc.reduced_config("qwen2-72b"), TrainConfig(grad_compression=True)
    structs = train_state_structs(cfg, tcfg)
    assert structs.step.device.type == "meta"
    assert all(x.device.type == "meta" for x in tree_leaves(structs.opt_state))
    state = init_train_state(torch.Generator().manual_seed(0), cfg, tcfg)
    shapes = lambda t: [(tuple(x.shape), x.dtype) for x in tree_leaves(t)]  # noqa: E731
    assert shapes(structs.opt_state) == shapes(state.opt_state)
    assert shapes(structs.residuals) == shapes(state.residuals)
    # without a mesh every spec replicates, as the reference's
    from repro_torch.distributed.mesh import AxisRules
    rules = AxisRules(mesh=None)
    specs = train_state_pspecs(cfg, tcfg, rules)
    assert specs.step == () and specs.opt_state["step"] == ()
    assert set(specs.opt_state) == {"f", "step"} and specs.residuals
    assert batch_pspecs(cfg, {"tokens": torch.empty(4, 8, device="meta")}, rules) == {"tokens": ()}
    with pytest.raises(ValueError, match="mesh and rules together"):
        Trainer(cfg, tcfg, TrainerConfig(), mesh=object(), device="cpu")
    assert make_train_step(cfg, tcfg, grad_shardings=None) is not None
    serve = make_serve_step(cfg)
    cache = tm.init_cache(cfg, 2, 8, device="cpu")
    logits, cache = serve(state.params, cache, {"token": torch.tensor([1, 2])})
    assert logits.shape == (2, cfg.padded_vocab) and int(cache["pos"]) == 1


def test_launch_train_reduced_on_cpu(tmp_path, capsys, monkeypatch):
    from repro_torch.launch import train as launch
    before = signal.getsignal(signal.SIGTERM)
    out = launch.main(["--arch", "mamba2-370m", "--reduced", "--steps", "3", "--batch", "2",
                       "--seq", "16", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert len(out["history"]) == 3 and signal.getsignal(signal.SIGTERM) is before
    assert "3 steps; loss" in capsys.readouterr().out
    # --mesh on a one-rank gloo world that the launcher starts from torchrun's
    # environment variables
    import socket

    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK="0",
                     WORLD_SIZE="1", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    try:
        out = launch.main(["--arch", "qwen2-72b", "--reduced", "--mesh", "1x1", "--steps", "2",
                           "--batch", "2", "--seq", "16", "--device", "cpu", "--ckpt-dir",
                           str(tmp_path / "mesh")])
        assert out["trainer"].mesh.mesh_dim_names == ("data", "model")
        assert len(out["history"]) == 2 and all(np.isfinite(h["loss"]) for h in out["history"])
    finally:
        dist.destroy_process_group()
    assert sys.modules["repro_torch.launch.train"] is launch
