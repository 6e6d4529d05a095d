"""The port's LM forward and loss against the JAX package's, per architecture,
and the numerics the port is most likely to get wrong.

Each reduced config (fp32) runs in both packages on the same weights and
inputs (``tests/torch_lm_parity.py``): ``forward`` logits and ``loss_fn``'s
value at rtol = atol = 1e-4, and one backward through the port's loss.
musicgen's forward and loss take frame embeddings. The named hazards: head
padding and the KV group order, the chunked core's -1e30 masks over fully
masked chunks, MoE capacity drops and padded experts, gelu's tanh form,
RoPE's half split and rms_norm's cast points. Prefill and decode are in
``tests/test_torch_lm_decode.py``, the chunked path at S = 80 and converted
caches in ``tests/test_torch_lm_chunked.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jc
from repro import models as jm
from repro_torch import configs as tc
from repro_torch import models as tm
from torch_lm_parity import J, T, _one_thread, both, close, make_batch, run_serving  # noqa: F401

ARCHS = jc.ARCH_IDS


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    jcfg, tcfg, params, model = both(arch)
    batch = make_batch(jcfg, 2, 32)
    close(tm.forward(model, tcfg, T(batch)), jm.forward(params, jcfg, J(batch)),
          f"{arch}: forward logits")
    jloss, jmet = jm.loss_fn(params, jcfg, J(batch))
    tloss, tmet = tm.loss_fn(model, tcfg, T(batch))
    close(tloss, jloss, f"{arch}: loss")
    close(tmet["ppl_proxy"], jmet["ppl_proxy"], f"{arch}: ppl proxy")
    # autograd-ready: one backward reaches every parameter the loss reads
    # (an "embeds" frontend reads no embed table, a plain "gelu" MLP no gate)
    tloss.backward()
    for name, p in model.named_parameters():
        unread = ((name == "embed" and tcfg.frontend == "embeds")
                  or (name.endswith("mlp.w_gate") and tcfg.act == "gelu"))
        if unread:
            assert p.grad is None, name
        else:
            assert p.grad is not None and torch.isfinite(p.grad).all(), name


def test_chunked_core_masked_chunks():
    """A query whose window misses a whole KV chunk: the -1e30 masks keep
    the result finite and equal to dense attention (-inf would give NaN
    in the masked chunk's rescale)."""
    from repro_torch.models.layers import _chunked_sdpa_core, _mask, _sdpa
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 40, 2, 8, generator=g) for _ in range(3))
    pos = torch.arange(40)
    got = _chunked_sdpa_core(q, k, v, pos, pos, True, 4, 8)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, _sdpa(q, k, v, _mask(pos, pos, True, 4)),
                               rtol=1e-5, atol=1e-5)


def test_init_cache_and_specs_agree():
    cfg = tc.reduced_config("llama-3.2-vision-90b")
    cache = tm.init_cache(cfg, 2, 24, device="cpu")
    specs = tm.cache_specs(cfg, 2, 24)
    assert cache["pos"].dtype == torch.int32 and int(cache["pos"]) == 0
    for got, spec in zip(cache["layers"], specs["layers"]):
        assert {k: (v.shape, v.dtype) for k, v in got.items()} == \
            {k: (v.shape, v.dtype) for k, v in spec.items()}
        assert all(torch.all(v == 0) for v in got.values())


def test_head_padding_and_group_order():
    """gemma3's padded query heads: the dummy heads' outputs are zeroed (so
    their weights change nothing), and query head h reads KV head h // G in
    both the expanded (train / prefill) and grouped (decode) forms."""
    from repro_torch.models.layers import _expand_kv
    k = torch.arange(2 * 3).reshape(1, 1, 2, 3).float()
    assert torch.equal(_expand_kv(k, 4)[0, 0, :, 0], torch.tensor([0., 0, 0, 0, 3, 3, 3, 3]))
    arch = "gemma3-1b"
    jcfg, tcfg, params, model = both(arch, n_heads=3, n_kv_heads=1, head_pad_multiple=4)
    assert tcfg.padded_heads == 4
    batch = make_batch(jcfg, 2, 12, seed=9)
    ref = tm.forward(model, tcfg, T(batch))
    with torch.no_grad():
        for block in model.layers:
            block.mixer.wq[:, 3:] = 7.0
            block.mixer.wo[3:] = -7.0
    torch.testing.assert_close(tm.forward(model, tcfg, T(batch)), ref, rtol=0, atol=0)
    run_serving(arch, B=2, S=12, k=8, n_heads=4, n_kv_heads=2, head_pad_multiple=8)


def test_moe_capacity_drops_like_reference():
    """granite at capacity factor 1.25: the capacity C = int(T K / E cf)
    drops tokens, differently for a 32-token forward and a 1-token decode;
    padded experts (a pad multiple of 8 over 4 experts) are masked."""
    jcfg, tcfg, params, model = both("granite-moe-3b-a800m", capacity_factor=1.25,
                                     expert_pad_multiple=8)
    assert tcfg.padded_experts == 8
    batch = make_batch(jcfg, 2, 32, seed=11)
    close(tm.forward(model, tcfg, T(batch)), jm.forward(params, jcfg, J(batch)),
          "MoE forward with drops")
    run_serving("granite-moe-3b-a800m", B=2, S=20, k=16, capacity_factor=1.25,
                expert_pad_multiple=8)


def test_gelu_is_the_tanh_approximation():
    """musicgen's "gelu" is jax.nn.gelu's default, the tanh approximation,
    which differs from the erf form by up to 5e-4 on [-4, 4]; the two tanh
    formulas differ by float rounding in the left tail (1e-5)."""
    from repro.models.layers import _act as j_act
    from repro_torch.models.layers import _act
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    tol = dict(rtol=1e-5, atol=1e-5)
    close(_act("gelu", None, torch.from_numpy(x)), j_act("gelu", None, jnp.asarray(x)), "gelu",
          **tol)
    close(_act("geglu", torch.from_numpy(x), torch.from_numpy(x[::-1].copy())),
          j_act("geglu", jnp.asarray(x), jnp.asarray(x[::-1].copy())), "geglu", **tol)
    erf = torch.nn.functional.gelu(torch.from_numpy(x))
    assert (erf - _act("gelu", None, torch.from_numpy(x))).abs().max() > 1e-4


def test_rope_and_rms_norm_casts():
    """rope: fp32 angles and half-split rotation; rms_norm: normalized in
    fp32, cast back, then scaled (bf16 inputs, bit-equal to the reference)."""
    from repro.models.layers import rms_norm as j_rms, rope as j_rope
    from repro_torch.models.layers import rms_norm, rope
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 3, 8)).astype(np.float32)
    pos = np.arange(100, 109, dtype=np.int32)
    close(rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
          j_rope(jnp.asarray(x), jnp.asarray(pos), 1e4), "rope", rtol=1e-5, atol=1e-5)
    xb = jnp.asarray(x, jnp.bfloat16)
    sb = jnp.asarray(rng.standard_normal(8), jnp.bfloat16)
    ref = np.asarray(j_rms(xb, sb, 1e-6).astype(jnp.float32))
    got = rms_norm(torch.from_numpy(x).bfloat16(),
                   torch.from_numpy(np.asarray(sb.astype(jnp.float32))).bfloat16(), 1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref)
