"""The port's sharding rules against the JAX package's, with no process.

``AxisRules.spec_for`` reads only a mesh's named sizes, so both packages
resolve the production meshes (16 x 16 and 2 x 16 x 16) and two small
ones described by a fake mesh that has only ``shape``, as
``tests/test_substrates.py`` does. For all ten architectures at their full
configs, with ``fsdp`` off and on, every spec of ``model_param_pspecs``,
``cache_pspecs``, ``train_state_pspecs`` (each optimizer, with and without
int8 error feedback) and ``batch_pspecs`` (each shape cell's inputs)
equals the reference's exactly, as ``tuple(spec)``, leaf by leaf under the
same tree path. Descriptors only: nothing is allocated.
"""
import dataclasses

import jax
import pytest
from jax.sharding import PartitionSpec as JP

from repro import configs as jc
from repro.distributed.mesh import AxisRules as JAxisRules
from repro.models import cache_pspecs as j_cache_pspecs
from repro.models import model_param_pspecs as j_model_param_pspecs
from repro.train import TrainConfig as JTrainConfig
from repro.train.steps import batch_pspecs as j_batch_pspecs
from repro.train.steps import train_state_pspecs as j_train_state_pspecs
from repro_torch import configs as tc
from repro_torch.distributed.mesh import AxisRules, PartitionSpec, placements_for
from repro_torch.models import cache_pspecs, model_param_pspecs
from repro_torch.train import TrainConfig, batch_pspecs, train_state_pspecs

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2x2": {"pod": 2, "data": 2, "model": 2},
          "4x2": {"data": 4, "model": 2}}
OPTIMIZERS = ("adamw", "adafactor", "sgdm")
CACHE_CELLS = ("prefill_32k", "decode_32k", "long_500k")


class FakeMesh:
    """A mesh as its named sizes alone (the reference's ``Mesh.shape``)."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _specs(tree) -> dict:
    """keystr(path) -> tuple(spec), a spec of either package a leaf."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (JP, PartitionSpec)))
    out = {}
    for path, spec in flat:
        assert isinstance(spec, (JP, PartitionSpec)), (jax.tree_util.keystr(path), spec)
        out[jax.tree_util.keystr(path)] = tuple(spec)
    return out


def _assert_same(got, want, what):
    got, want = _specs(got), _specs(want)
    assert got.keys() == want.keys(), (what, sorted(got.keys() ^ want.keys())[:5])
    bad = [(k, got[k], want[k]) for k in want if got[k] != want[k]]
    assert not bad, (what, bad[:5])
    return len(want)


def _both(arch, mesh, fsdp):
    sizes = MESHES[mesh]
    return (tc.get_config(arch), jc.get_config(arch), AxisRules(FakeMesh(sizes), fsdp=fsdp),
            JAxisRules(FakeMesh(sizes), fsdp=fsdp))


@pytest.mark.parametrize("fsdp", [False, True], ids=["replicated", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", jc.ARCH_IDS)
def test_specs_match_reference(arch, mesh, fsdp):
    cfg, jcfg, rules, jrules = _both(arch, mesh, fsdp)
    n = _assert_same(model_param_pspecs(cfg, rules), j_model_param_pspecs(jcfg, jrules),
                     "params")
    assert n > 0
    for cell in CACHE_CELLS:
        B, S = jc.SHAPES[cell].global_batch, jc.SHAPES[cell].seq_len
        _assert_same(cache_pspecs(cfg, B, S, rules), j_cache_pspecs(jcfg, B, S, jrules),
                     f"cache {cell}")
    for opt in OPTIMIZERS:
        for compression in (False, True):
            c, jcf = (dataclasses.replace(x, optimizer=opt) for x in (cfg, jcfg))
            _assert_same(train_state_pspecs(c, TrainConfig(grad_compression=compression), rules),
                         j_train_state_pspecs(jcf, JTrainConfig(grad_compression=compression),
                                              jrules),
                         f"train state {opt} {compression}")
    for cell in jc.SHAPES:
        _assert_same(batch_pspecs(cfg, tc.input_specs(cfg, cell), rules),
                     j_batch_pspecs(jcfg, jc.input_specs(jcfg, cell), jrules), f"batch {cell}")


@pytest.mark.parametrize("arch", jc.ARCH_IDS)
def test_per_layer_specs_give_the_stacked_bytes(arch):
    """A layer's parameter takes its own descriptor's spec; where the
    stacked leaf's ``"fsdp"`` axis and ``"embed"`` both divide, the per-rank
    share is the reference's (one of the data axes' size either way)."""
    from repro_torch.models.model import layer_pd, split_periods
    from repro_torch.models.params import tree_map
    cfg = tc.get_config(arch)
    rules = AxisRules(FakeMesh(MESHES["16x16"]), fsdp=True)
    period, n_per, _ = split_periods(cfg.layer_pattern)

    def share(shape, spec):
        n = 1
        for entry in spec:
            for a in (entry,) if isinstance(entry, str) else entry or ():
                n *= MESHES["16x16"][a]
        return n

    for spec in period:
        def check(pd):
            stacked = rules.spec_for((n_per,) + pd.shape, ("fsdp",) + pd.axes)
            layer = rules.spec_for(pd.shape, pd.axes)
            if n_per % 16 == 0 and "embed" in pd.axes and \
                    pd.shape[pd.axes.index("embed")] % 16 == 0:
                assert share(pd.shape, layer) == share(pd.shape, stacked), (pd, layer, stacked)
            return layer
        tree_map(check, layer_pd(cfg, spec))


def test_axis_rules_divisibility_fallback():
    """``tests/test_substrates.py``'s case on a 1 x 1 mesh."""
    rules = AxisRules(mesh=FakeMesh({"data": 1, "model": 1}))
    spec = rules.spec_for((8, 16, 64), ("batch", None, "heads"))
    assert spec[0] in (("data",), "data")
    jrules = JAxisRules(mesh=FakeMesh({"data": 1, "model": 1}))
    assert tuple(spec) == tuple(jrules.spec_for((8, 16, 64), ("batch", None, "heads")))


@pytest.mark.parametrize("dims,axes", [
    ((1152, 4, 256), ("embed", "heads", None)),          # gemma3-1b's 4 heads: replicated
    ((1152, 6912), ("embed", "ff")),                      # ff shards
    ((128, 32768, 8, 128), ("batch", "kv_seq", "kv_heads", None)),   # seq absorbs model
    ((1, 524288, 8, 128), ("batch", "cache_seq", "kv_heads", None)),
    ((48, 4096, 1536), ("experts", "expert_cap", None)),
])
def test_axis_rules_replicates_non_divisible(dims, axes):
    """``tests/test_substrates.py``'s cases on the 16 x 16 mesh, and more,
    against the reference's engine."""
    for fsdp in (False, True):
        got = AxisRules(FakeMesh(MESHES["16x16"]), fsdp=fsdp).spec_for(dims, axes)
        want = JAxisRules(FakeMesh(MESHES["16x16"]), fsdp=fsdp).spec_for(dims, axes)
        assert tuple(got) == tuple(want)
    rules = AxisRules(FakeMesh(MESHES["16x16"]))
    if axes[1] == "heads":
        assert all(s is None for s in rules.spec_for(dims, axes))
    if axes[1] == "ff":
        assert rules.spec_for(dims, axes)[1] == "model"
    if axes[1] == "kv_seq":
        assert "model" in tuple(rules.spec_for(dims, axes))


def test_sharding_for_placements():
    """Placements of specs with tuple entries: a tuple shards one tensor
    dimension over several mesh dimensions, row-major in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard
    rules = AxisRules(FakeMesh(MESHES["2x16x16"]), fsdp=True)
    sh = rules.sharding_for((256, 4096), ("batch", None))
    assert tuple(sh.spec) == (("pod", "data"),)
    assert sh.placements == (Shard(0), Shard(0), Replicate())
    sh = rules.sharding_for((48, 4096, 1536), ("experts", "expert_cap", None))
    assert tuple(sh.spec) == ("model", ("pod", "data"))
    assert sh.placements == (Shard(1), Shard(1), Shard(0))
    sh = rules.sharding_for((40, 4096, 1536), ("experts", "expert_cap", None))
    assert tuple(sh.spec) == (None, ("pod", "data", "model"))
    assert sh.placements == (Shard(1),) * 3
    sh = rules.sharding_for((8, 1536, 512), ("fsdp", "embed", None))
    assert tuple(sh.spec) == (None, ("pod", "data"))
    assert sh.placements == (Shard(1), Shard(1), Replicate())
    assert AxisRules(FakeMesh(MESHES["4x2"])).sharding_for((3, 5), ("batch", "ff")).placements \
        == (Replicate(), Replicate())
    assert AxisRules(None).spec_for((3, 5), ("batch", "ff")) == ()
    assert placements_for(FakeMesh(MESHES["2x2x2"]), PartitionSpec(None, "model")) == \
        (Replicate(), Replicate(), Shard(1))
    # a mesh dimension of size 1 holds the whole dimension: it replicates
    one = FakeMesh({"pod": 1, "data": 2, "model": 1})
    assert placements_for(one, PartitionSpec(("pod", "data"), "model")) == \
        (Replicate(), Shard(0), Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        placements_for(FakeMesh(MESHES["2x2x2"]), PartitionSpec(("data", "pod")))
