"""Shared helpers of the LM parity tests (``tests/test_torch_lm_*.py``).

Both packages get the same weights (the reference's ``model_params`` as
numpy, llama-3.2-vision's zero-initialized cross gates set to 0.5 so that
the cross layers output something) and the same numpy inputs. The JAX side
runs as ``tests/test_archs_smoke.py`` runs it (matmuls at "highest").
Tolerance rtol = atol = 1e-4: fp32 with another summation order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jc
from repro import models as jm
from repro_torch import configs as tc
from repro_torch import models as tm
from repro_torch.convert import layer_trees, model_params_from_numpy

jax.config.update("jax_default_matmul_precision", "highest")

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tensors are small, and beside the suite's
    other worker processes more threads only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def reference_tree(cfg, seed=0):
    """The reference's parameters as numpy, cross gates set to 0.5."""
    tree = jax.tree.map(np.asarray, jm.model_params(jax.random.PRNGKey(seed), cfg))
    period, _, tail = jm.split_periods(cfg.layer_pattern)
    for slots, specs in ((tree["period"], period), (tree["tail"], tail)):
        for slot, spec in zip(slots, specs):
            if spec.kind == "cross":
                slot["mixer"]["gate"] = np.full_like(slot["mixer"]["gate"], 0.5)
    return tree


def both(arch, tokens_frontend=False, **overrides):
    jcfg, tcfg = jc.reduced_config(arch), tc.reduced_config(arch)
    if tokens_frontend and jcfg.frontend == "embeds":
        overrides["frontend"] = "tokens"
    jcfg, tcfg = (dataclasses.replace(jcfg, **overrides),
                  dataclasses.replace(tcfg, **overrides))
    tree = reference_tree(jcfg)
    params = jax.tree.map(jnp.asarray, tree)
    model = model_params_from_numpy(tree, tcfg, device="cpu")
    return jcfg, tcfg, params, model


def make_batch(cfg, B, S, seed=1):
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


def J(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def T(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def close(got, ref, what, **tol):
    if isinstance(ref, torch.Tensor):
        ref = ref.detach().numpy()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **(tol or TOL),
                               err_msg=what)


def assert_caches_close(tcache, jcache, jcfg, what):
    assert int(tcache["pos"]) == int(jcache["pos"]) and tcache["pos"].dtype == torch.int32
    ref_layers = layer_trees(jax.tree.map(np.asarray, jcache), jcfg)
    assert len(ref_layers) == len(tcache["layers"])
    for i, (tl, jl) in enumerate(zip(tcache["layers"], ref_layers)):
        assert sorted(tl) == sorted(jl), (what, i)
        for name in jl:
            close(tl[name], jl[name], f"{what}: layer {i} cache {name}")


def run_serving(arch, B, S, k, **overrides):
    """prefill(tokens[:, :k]) then decode the rest, in both packages: the
    logits of each step and the caches after prefill and after the last
    step."""
    jcfg, tcfg, params, model = both(arch, tokens_frontend=True, **overrides)
    batch = make_batch(jcfg, B, S)
    pre = {kk: (v[:, :k] if kk in ("tokens", "embeds") else v)
           for kk, v in batch.items() if kk != "labels"}
    jl, jcache = jm.prefill(params, jcfg, J(pre), S_max=S)
    tl, tcache = tm.prefill(model, tcfg, T(pre), S_max=S)
    close(tl, jl, f"{arch}: prefill logits")
    assert_caches_close(tcache, jcache, jcfg, f"{arch}: prefill")
    for t in range(k, S):
        tok = batch["tokens"][:, t]
        jl, jcache = jm.decode_step(params, jcfg, jcache, {"token": jnp.asarray(tok)})
        tl, tcache = tm.decode_step(model, tcfg, tcache, {"token": torch.from_numpy(tok)})
        close(tl, jl, f"{arch}: decode step {t}")
    assert_caches_close(tcache, jcache, jcfg, f"{arch}: after decode")
    return tcfg, model, batch
