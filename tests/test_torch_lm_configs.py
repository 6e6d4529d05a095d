"""The port's LM configs and token stream against the JAX package's.

For all ten architectures, ``get_config`` and ``reduced_config`` equal the
reference's field for field, and so do ``param_count``, the padded sizes,
``split_periods`` and the shapes and dtypes of ``input_specs`` (meta
tensors in the port). The synthetic token stream is bit-equal to the
reference's for the same seed. The parameter and cache trees of the port
(``model_param_structs``, ``cache_specs``) hold the reference's leaves one
to one, as ``convert`` maps them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jc
from repro.configs import base as jbase
from repro.data import TokenStreamConfig as JTokenStreamConfig
from repro.data import token_stream as j_token_stream
from repro.models import cache_specs as j_cache_specs
from repro.models import model_param_structs as j_param_structs
from repro.models import split_periods as j_split_periods
from repro_torch import configs as tc
from repro_torch.configs import base as tbase
from repro_torch.convert import layer_trees
from repro_torch.data import TokenStreamConfig, token_stream
from repro_torch.models import cache_specs, model_param_structs, split_periods
from repro_torch.models.params import init_params, param_shape_structs, stack_pds

ARCHS = jc.ARCH_IDS


def test_arch_ids_match():
    assert tc.ARCH_IDS == jc.ARCH_IDS
    assert len(tc.ARCH_IDS) == 10
    with pytest.raises(ValueError, match="unknown arch"):
        tc.get_config("nope")


def _spec_tuple(s):
    return (s.kind, s.moe)


def _asdict(cfg):
    d = dataclasses.asdict(cfg)
    d["layer_pattern"] = tuple(_spec_tuple(s) for s in cfg.layer_pattern)
    return d


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_field_for_field(arch):
    for getter in ("get_config", "reduced_config"):
        j, t = getattr(jc, getter)(arch), getattr(tc, getter)(arch)
        assert _asdict(t) == _asdict(j), (arch, getter)
        for prop in ("padded_vocab", "padded_heads", "padded_experts", "d_inner",
                     "ssm_heads", "group_size"):
            assert getattr(t, prop) == getattr(j, prop), (arch, getter, prop)
        assert t.param_count() == j.param_count()
        assert t.param_count(active_only=True) == j.param_count(active_only=True)
        assert t.runnable_shapes() == j.runnable_shapes()
        jp, jn, jt = j_split_periods(j.layer_pattern)
        tp, tn, tt = split_periods(t.layer_pattern)
        assert ([_spec_tuple(s) for s in tp], tn, [_spec_tuple(s) for s in tt]) == \
            ([_spec_tuple(s) for s in jp], jn, [_spec_tuple(s) for s in jt])


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_are_meta_with_the_reference_shapes(arch):
    j, t = jc.get_config(arch), tc.get_config(arch)
    for shape in t.runnable_shapes():
        js, ts = jbase.input_specs(j, shape), tbase.input_specs(t, shape)
        assert sorted(js) == sorted(ts)
        for name in js:
            assert ts[name].device.type == "meta"
            assert tuple(ts[name].shape) == tuple(js[name].shape), (arch, shape, name)
            assert str(ts[name].dtype).removeprefix("torch.") == str(js[name].dtype)


def test_padded_heads_and_gemma3_sizes():
    """gemma3-1b's 4 query heads pad to 16 over 1 KV head (G = 16), and its
    full-width model stores 1.486e9 parameters."""
    cfg = tc.get_config("gemma3-1b")
    assert (cfg.n_heads, cfg.padded_heads, cfg.n_kv_heads) == (4, 16, 1)
    structs = model_param_structs(cfg)
    n = sum(t.numel() for t in jax.tree.leaves(structs))
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16
               for t in jax.tree.leaves(structs))
    assert abs(n - 1.486e9) < 1e6, n


@pytest.mark.parametrize("arch", ["gemma3-1b", "jamba-1.5-large-398b", "llama-3.2-vision-90b",
                                  "minicpm3-4b"])
def test_param_and_cache_trees_map_one_to_one(arch):
    """The reference's stacked trees, split per layer, have the port's
    leaves at the same shapes (full widths, meta tensors only)."""
    j, t = jc.get_config(arch), tc.get_config(arch)

    def views(structs):     # zero-byte arrays of the structs' shapes
        return jax.tree.map(lambda s: np.broadcast_to(np.empty((), np.int8), s.shape), structs)

    def shapes(tree):
        return jax.tree.map(lambda x: tuple(x.shape), tree)

    per_layer = layer_trees(views(j_param_structs(j)), j)
    tstructs = model_param_structs(t)
    assert len(per_layer) == len(tstructs["layers"]) == t.n_layers
    assert [shapes(x) for x in per_layer] == [shapes(x) for x in tstructs["layers"]]
    for name in ("embed", "ln_f", "lm_head"):
        assert tuple(tstructs[name].shape) == tuple(j_param_structs(j)[name].shape)
    tc_specs = cache_specs(t, 2, 64)
    jl = layer_trees(views(j_cache_specs(j, 2, 64)), j)
    assert [shapes(x) for x in jl] == [shapes(x) for x in tc_specs["layers"]]
    assert tc_specs["pos"].dtype == torch.int32 and tc_specs["pos"].device.type == "meta"


def test_params_tree_helpers():
    """init_params keeps the reference's init kinds: zeros, ones, ssm_A in
    [0, log 16], embed at its scale, normal at 1/sqrt(fan_in); stack_pds
    prepends the stacked axis; param_shape_structs allocates nothing."""
    from repro_torch.models.params import PD
    tree = {"z": PD((3,), (None,), "zeros"), "o": PD((2, 2), (None, None), "ones"),
            "a": PD((4096,), (None,), "ssm_A"), "e": PD((64, 512), (None, None), "embed",
                                                       scale=0.02),
            "w": [PD((256, 128), (None, None))]}
    out = init_params(torch.Generator().manual_seed(0), tree, torch.float32)
    assert torch.all(out["z"] == 0) and torch.all(out["o"] == 1)
    assert 0 <= out["a"].min() and out["a"].max() <= np.log(16.0) + 1e-6
    assert abs(out["e"].std().item() - 0.02) < 1e-3
    assert abs(out["w"][0].std().item() - 256 ** -0.5) < 2e-3
    st = stack_pds(tree, 5)
    assert st["w"][0].shape == (5, 256, 128) and st["w"][0].axes[0] == "fsdp"
    meta = param_shape_structs(st, torch.bfloat16)
    assert meta["e"].shape == (5, 64, 512) and meta["e"].device.type == "meta"


@pytest.mark.parametrize("seed", [0, 7])
def test_token_stream_bit_equal(seed):
    jcfg, tcfg = (JTokenStreamConfig(vocab=97, seq_len=33, batch=3),
                  TokenStreamConfig(vocab=97, seq_len=33, batch=3))
    js, ts = j_token_stream(jcfg, seed=seed), token_stream(tcfg, seed=seed)
    for step in range(4):
        jb, tb = next(js), next(ts)
        assert tb["step"] == jb["step"] == step
        for k in ("tokens", "labels"):
            assert tb[k].dtype == torch.int32
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


def test_batch_sample_shapes():
    cfg = tc.reduced_config("llama-3.2-vision-90b")
    jcfg = jc.reduced_config("llama-3.2-vision-90b")
    cfg = dataclasses.replace(cfg, dtype="float32")
    out = tbase.batch_sample(cfg, "train_4k", torch.Generator().manual_seed(0))
    ref = jbase.batch_sample(jcfg, "train_4k", jax.random.PRNGKey(0))
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in out.items()} \
        == {k: (tuple(v.shape), str(jnp.dtype(v.dtype))) for k, v in ref.items()}
    assert int(out["tokens"].max()) < cfg.vocab and int(out["tokens"].min()) >= 0


def test_unported_lm_entry_points_refuse(tmp_path):
    """The spec functions of the sharding rules (A15.3) return the
    reference's specs, which replicate everything without a mesh; the dry
    run (A15.4), which refused until it was ported, runs and writes its
    artifact."""
    from repro.distributed.mesh import AxisRules as JAxisRules
    from repro.models import cache_pspecs as j_cache_pspecs
    from repro.models import model_param_pspecs as j_model_param_pspecs
    from repro_torch.distributed.mesh import AxisRules
    from repro_torch.launch import dryrun
    from repro_torch.models import cache_pspecs, model_param_pspecs
    from repro_torch.models.params import param_pspecs
    cfg, jcfg = tc.reduced_config("gemma3-1b"), jc.reduced_config("gemma3-1b")
    rules, jrules = AxisRules(mesh=None), JAxisRules(mesh=None)
    for got, want in ((model_param_pspecs(cfg, rules), j_model_param_pspecs(jcfg, jrules)),
                      (cache_pspecs(cfg, 2, 8, rules), j_cache_pspecs(jcfg, 2, 8, jrules))):
        got_leaves = jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, tuple))
        want_leaves = jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, tuple))
        assert len(got_leaves) == len(want_leaves) > 0
        assert all(tuple(g) == tuple(w) == () for g, w in zip(got_leaves, want_leaves))
    assert param_pspecs({}, rules) == {}
    assert dryrun.main(["--arch", "gemma3-1b", "--shape", "decode_32k", "--mesh", "single",
                        "--out", str(tmp_path)]) == 0
    assert (tmp_path / "gemma3-1b__decode_32k__single.json").exists()
