"""The port's checkpoints: round trips, codecs, atomicity, async saves, and
the reference's on-disk layout read by both packages.

A bfloat16 leaf is stored as its 16 bits under the dtype name
"bfloat16"; the port's checkpoints and the reference's are read by either
package (leaves numbered in the reference's order, dict keys sorted). Every
comparison is exact: a checkpoint moves bits.
"""
import json
import os
import threading
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as RC
from repro_torch.checkpoint import checkpoint as C
from repro_torch.checkpoint import latest_step, load_checkpoint, save_checkpoint, step_dir
from repro_torch.models import LeafGroup


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _State(NamedTuple):
    params: dict
    step: torch.Tensor


def _tree():
    g = torch.Generator().manual_seed(0)
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": {"c": (torch.randn(5, generator=g) * 3).to(torch.bfloat16)},
        "grp": LeafGroup([torch.randn(2, 3, generator=g) for _ in range(4)]),
        "n": [torch.tensor(7, dtype=torch.int32), torch.ones(2, dtype=torch.int64)],
    }


def _like(tree):
    return {"a": torch.zeros(3, 4), "b": {"c": torch.zeros(5, dtype=torch.bfloat16)},
            "grp": LeafGroup([torch.zeros(2, 3) for _ in range(4)]),
            "n": [torch.zeros((), dtype=torch.int32), torch.zeros(2, dtype=torch.int64)]}


def _assert_restored(out, tree):
    assert torch.equal(out["a"], tree["a"])
    assert out["b"]["c"].dtype == torch.bfloat16 and torch.equal(out["b"]["c"], tree["b"]["c"])
    assert torch.equal(out["grp"], tree["grp"].stack())      # a group restores stacked
    assert out["n"][0].dtype == torch.int32 and int(out["n"][0]) == 7
    assert out["n"][1].dtype == torch.int64 and torch.equal(out["n"][1], tree["n"][1])


@pytest.mark.parametrize("codec", ["zstd", "raw"])
def test_roundtrip_both_codecs(tmp_path, monkeypatch, codec):
    """A bf16 leaf, a LeafGroup and integer leaves round-trip bit for bit;
    with ``_zstd`` patched to None the raw codec is written and recorded."""
    if codec == "raw":
        monkeypatch.setattr(C, "_zstd", lambda: None)
    tree = _tree()
    p = step_dir(str(tmp_path), 3)
    assert save_checkpoint(p, tree, 3, blocking=True, extra={"note": "x"}) is None
    manifest = json.load(open(os.path.join(p, "MANIFEST.json")))
    assert manifest["codec"] == codec and manifest["step"] == 3
    assert manifest["extra"] == {"note": "x"}
    ext = ".npy.zst" if codec == "zstd" else ".npy.raw"
    assert sorted(os.listdir(p)) == ["MANIFEST.json"] + [f"leaf_{i:05d}{ext}" for i in range(5)]
    # the reference's order: keys sorted; the bf16 leaf under its own name
    assert manifest["leaves"]["leaf_00001"] == {"shape": [5], "dtype": "bfloat16"}
    assert manifest["leaves"]["leaf_00002"] == {"shape": [4, 2, 3], "dtype": "float32"}
    out, step = load_checkpoint(p, _like(tree))
    assert step == 3
    _assert_restored(out, tree)
    assert latest_step(str(tmp_path)) == 3


def test_zstd_without_the_module_raises(tmp_path, monkeypatch):
    p = step_dir(str(tmp_path), 1)
    save_checkpoint(p, {"w": torch.ones(3)}, 1)
    monkeypatch.setattr(C, "_zstd", lambda: None)
    with pytest.raises(RuntimeError, match="zstandard"):
        load_checkpoint(p, {"w": torch.zeros(3)})


def test_shape_mismatch_raises(tmp_path):
    p = step_dir(str(tmp_path), 1)
    save_checkpoint(p, _tree(), 1)
    bad = _like(None)
    bad["a"] = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(p, bad)
    bad = _like(None)
    bad["grp"] = LeafGroup([torch.zeros(2, 3) for _ in range(3)])
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(p, bad)


def test_latest_step_ignores_leftover_tmp(tmp_path):
    """A save cut mid-write leaves ``step_xxxxxxxx.tmp``: not a checkpoint."""
    save_checkpoint(step_dir(str(tmp_path), 2), {"w": torch.ones(2)}, 2)
    os.makedirs(step_dir(str(tmp_path), 9) + ".tmp")
    assert latest_step(str(tmp_path)) == 2
    assert latest_step(str(tmp_path / "missing")) is None


def test_async_save_then_restore(tmp_path):
    tree = {"w": torch.full((16,), 7.0)}
    t = save_checkpoint(step_dir(str(tmp_path), 1), tree, 1, blocking=False)
    assert isinstance(t, threading.Thread)
    t.join(timeout=60)
    assert not t.is_alive()
    out, _ = load_checkpoint(step_dir(str(tmp_path), 1), tree)
    assert float(out["w"][0]) == 7.0


def test_save_is_a_snapshot_under_in_place_updates(tmp_path, monkeypatch):
    """The leaves are copied before ``save_checkpoint`` returns: an in-place
    update right after it (the writer held back until then) is not saved."""
    tree = {"w": torch.full((1000,), 1.0), "g": LeafGroup([torch.full((4,), 2.0)] * 2),
            "h": torch.full((8,), 3.0, dtype=torch.bfloat16)}
    go = threading.Event()
    real_rename = os.rename

    def held_rename(a, b):
        go.wait(timeout=60)
        real_rename(a, b)

    monkeypatch.setattr(C.os, "rename", held_rename)
    t = save_checkpoint(step_dir(str(tmp_path), 5), tree, 5, blocking=False)
    with torch.no_grad():
        tree["w"].add_(1.0)
        tree["g"].tensors[0].mul_(10.0)
        tree["h"].sub_(1.0)
    go.set()
    t.join(timeout=60)
    assert not t.is_alive()
    out, _ = load_checkpoint(step_dir(str(tmp_path), 5), {"w": torch.zeros(1000),
                                                          "g": torch.zeros(2, 4),
                                                          "h": torch.zeros(8)})
    assert torch.all(out["w"] == 1.0) and torch.all(out["g"] == 2.0)
    assert torch.all(out["h"] == 3.0)


def test_reference_checkpoints_load_in_the_port_and_back(tmp_path):
    """The reference's checkpoint (a bf16 leaf, a NamedTuple, nested dicts)
    loads in the port bit for bit, and the port's loads in the reference."""
    rng = np.random.default_rng(0)
    raw = {"w": rng.standard_normal((3, 4)).astype(np.float32),
           "z": {"b": (rng.standard_normal(6) * 5).astype(np.float32)}}
    jtree = {"w": jnp.asarray(raw["w"]), "z": {"b": jnp.asarray(raw["z"]["b"], jnp.bfloat16)}}
    RC.save_checkpoint(RC.step_dir(str(tmp_path), 4), jtree, 4, blocking=True)
    ttree = {"w": torch.zeros(3, 4), "z": {"b": torch.zeros(6, dtype=torch.bfloat16)}}
    out, step = load_checkpoint(step_dir(str(tmp_path), 4), ttree)
    assert step == 4 and torch.equal(out["w"], torch.from_numpy(raw["w"]))
    bits = np.asarray(jtree["z"]["b"]).view(np.uint16)
    assert out["z"]["b"].dtype == torch.bfloat16
    assert np.array_equal(out["z"]["b"].view(torch.int16).numpy().view(np.uint16), bits)

    state = _State(params={"w": out["w"], "z": {"b": out["z"]["b"]}},
                   step=torch.tensor(4, dtype=torch.int32))
    save_checkpoint(step_dir(str(tmp_path), 8), state, 8)
    like = jax.tree.map(jnp.zeros_like, (jtree, jnp.zeros((), jnp.int32)))
    back, step = RC.load_checkpoint(step_dir(str(tmp_path), 8), like)
    assert step == 8
    np.testing.assert_array_equal(np.asarray(back[0]["w"]), raw["w"])
    assert back[0]["z"]["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back[0]["z"]["b"]).view(np.uint16), bits)
    assert int(back[1]) == 4
