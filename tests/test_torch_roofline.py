"""The port's roofline tools (``repro_torch.roofline``) against the JAX
package's (``repro.roofline``).

The analytic functions take the same configs in both packages and must
agree: the model flops of all ten full configs, and the analytic per-device
memory of every config x runnable shape x production mesh (a fake mesh of
named sizes, as ``tests/test_torch_sharding_rules.py`` uses). The op
counter (``op_cost.analyze``) is held against the reference's HLO walk
(``hlo_cost.analyze``) on the reference test's scanned matmul loop and on
one plain sweep, and, on a fake 256-rank world in this process, counts one
rank's share of a sharded matmul and its redistribution's bytes. Each test
runs on one torch thread.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jc
from repro.configs.base import SHAPES as J_SHAPES
from repro.distributed.mesh import AxisRules as JAxisRules
from repro.roofline import analysis as jan
from repro.roofline.hlo_cost import analyze as hlo_analyze
from repro_torch import configs as tc
from repro_torch.distributed.mesh import AxisRules
from repro_torch.roofline import analysis as an
from repro_torch.roofline import analyze

MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test, beside the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class FakeMesh:
    """A mesh as its named sizes alone (the reference's ``Mesh.shape``)."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("arch", tc.ARCH_IDS)
def test_model_flops_are_the_references(arch):
    cfg, jcfg = tc.get_config(arch), jc.get_config(arch)
    for tokens in (4096, 256 * 4096):
        got, want = an.train_model_flops(cfg, tokens), jan.train_model_flops(jcfg, tokens)
        assert abs(got - want) <= 1e-12 * abs(want), (tokens, got, want)
    for shape in ("decode_32k", "long_500k"):
        cell = tc.SHAPES[shape]
        got = an.decode_model_flops(cfg, cell.global_batch, cell.seq_len)
        want = jan.decode_model_flops(jcfg, cell.global_batch, cell.seq_len)
        assert abs(got - want) <= 1e-12 * abs(want), (shape, got, want)


@pytest.mark.parametrize("arch", tc.ARCH_IDS)
def test_analytic_memory_is_the_references(arch):
    """Every runnable shape on both production meshes, fsdp as configured:
    equal in the reference's 3-decimal GB, key by key."""
    cfg, jcfg = tc.get_config(arch), jc.get_config(arch)
    assert cfg.runnable_shapes() == jcfg.runnable_shapes()
    for mesh_name, sizes in MESHES.items():
        rules = AxisRules(mesh=FakeMesh(sizes), fsdp=cfg.fsdp)
        jrules = JAxisRules(mesh=FakeMesh(sizes), fsdp=jcfg.fsdp)
        dp = 32 if mesh_name == "multi" else 16
        for shape in cfg.runnable_shapes():
            cell = tc.SHAPES[shape]
            mb = cell.global_batch // dp if cell.kind == "train" else 1
            got = an.analytic_memory(cfg, cell, rules, microbatch=mb)
            want = jan.analytic_memory(jcfg, J_SHAPES[shape], jrules, microbatch=mb)
            assert got == want, (mesh_name, shape, got, want)


def test_scan_loop_flops_match_hlo_cost():
    """The reference test's loop (``tests/test_substrates.py``: 7 chained
    256^2 matmuls in a ``scan``): the eager count equals 7 * 2 * 256^3, as
    the reference's trip-count-corrected HLO walk does (within 1%)."""
    M = 256

    def loop(a, b):
        def body(c, _):
            return c @ b, None
        out, _ = jax.lax.scan(body, a, None, length=7)
        return out

    s = jax.ShapeDtypeStruct((M, M), jnp.float32)
    ref = hlo_analyze(jax.jit(loop).lower(s, s).compile().as_text())

    def tloop(a, b):
        c = a
        for _ in range(7):
            c = c @ b
        return c

    a = torch.empty(M, M, device="meta")
    cost = analyze(tloop, a, torch.empty(M, M, device="meta"))
    assert cost.flops == 7 * 2 * M ** 3
    assert abs(ref.flops / (7 * 2 * M ** 3) - 1.0) < 0.01
    assert abs(cost.flops / ref.flops - 1.0) < 0.01
    assert cost.unbounded_whiles == ref.unbounded_whiles == 0


def test_lone_matmul_bytes():
    """Operand plus output bytes: 3 * 256^2 * 4 for one fp32 matmul; its
    transpose view moves nothing."""
    a, b = torch.randn(256, 256), torch.randn(256, 256)
    cost = analyze(lambda x, y: x @ y, a, b)
    assert cost.bytes == 3 * 256 ** 2 * 4
    assert cost.flops == 2 * 256 ** 3
    assert analyze(lambda x, y: x @ y.t(), a, b).bytes == 3 * 256 ** 2 * 4
    mem = cost.memory
    assert (mem.arguments, mem.outputs, mem.aliased, mem.peak, mem.temp) == (
        2 * 256 ** 2 * 4, 256 ** 2 * 4, 0, 3 * 256 ** 2 * 4, 0)


def test_memory_counts_in_place_outputs_as_aliased():
    """An argument updated in place is an aliased output; a fresh one is not."""
    a = torch.zeros(1024)

    def step(x):
        x.add_(1.0)
        return x, x * 2.0

    cost = analyze(step, a)
    assert cost.memory.arguments == 4096
    assert cost.memory.outputs == 2 * 4096
    assert cost.memory.aliased == 4096
    assert cost.memory.peak == 2 * 4096
    assert cost.memory.temp == 0


def test_meta_counts_equal_real_counts():
    """The counter reuses a functional op's output metadata on meta tensors:
    the counts of a small MLP step equal those on real tensors."""
    torch.manual_seed(0)

    def mlp(x, w1, w2):
        h = torch.nn.functional.gelu(x @ w1)
        for _ in range(3):
            h = torch.where(h > 0, h * 0.5, h) + 1.0
        return (h @ w2).sum()

    shapes = ((64, 32), (32, 128), (128, 16))
    real = analyze(mlp, *(torch.randn(s) for s in shapes))
    meta = analyze(mlp, *(torch.empty(s, device="meta") for s in shapes))
    assert (meta.flops, meta.bytes, meta.ops) == (real.flops, real.bytes, real.ops)
    assert dataclasses.astuple(meta.memory) == dataclasses.astuple(real.memory)


def test_sharded_matmul_is_counted_per_device():
    """On a fake 256-rank (16, 16) world: one (Shard(0), Shard(1)) matmul
    of 4096^2 operands counts 2 * 4096^3 / 256 flops on this rank (the
    local shards' product after DTensor's redistribution, not the global
    op), and a redistribution reads the shard's bytes under all-gather."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_mesh
    N = 4096
    with fake_world(256):
        mesh = make_mesh((16, 16), ("data", "model"), "cpu")
        da, db = (distribute_tensor(torch.empty(N, N, device="meta"), mesh, [Shard(0), Shard(1)])
                  for _ in range(2))
        cost = analyze(lambda x, y: x @ y, da, db)
        assert cost.flops == 2 * N ** 3 / 256
        assert cost.collective_bytes.get("all-gather", 0) > 0
        shard = (N // 16) ** 2 * 4
        red = analyze(lambda x: x.redistribute(mesh, [Replicate(), Shard(1)]), da)
        assert red.collective_bytes == {"all-gather": shard}
        assert red.flops == 0


def test_sweep_flops_match_hlo_cost():
    """One plain sweep at n = 4096, M = 512, d = 18 (p = 1): the port's
    "torch" backend counts 2 n M (d + 2) flops (its three mm ops a row
    block: K(X, C)'s cross term, K u and K^T t), within 2% of the
    reference's HLO walk of its "jnp" ops.sweep, which counts the same three
    dots (the row norms are reductions in both). The bytes differ and are
    not compared: XLA fuses the kernel's elementwise chain into one pass
    over each Gram strip, the eager ops make one pass an op."""
    from repro.core.kernels import GaussianKernel as JGaussian
    from repro.ops import get_ops as j_get_ops
    from repro_torch.core.kernels import GaussianKernel
    from repro_torch.ops import get_ops
    n, M, d, bs = 4096, 512, 18, 1024
    jops = j_get_ops("jnp", JGaussian(sigma=4.0), block_size=bs)
    X = jax.ShapeDtypeStruct((n, d), jnp.float32)
    C = jax.ShapeDtypeStruct((M, d), jnp.float32)
    u = jax.ShapeDtypeStruct((M, 1), jnp.float32)
    ref = hlo_analyze(jax.jit(lambda X, C, u: jops.sweep(X, C, u, None))
                      .lower(X, C, u).compile().as_text())
    ops = get_ops("torch", GaussianKernel(sigma=4.0), block_size=bs)
    meta = [torch.empty(s, device="meta") for s in ((n, d), (M, d), (M, 1))]
    cost = analyze(ops.sweep, *meta, None)
    assert cost.flops == 2 * n * M * (d + 2)
    assert abs(cost.flops / ref.flops - 1.0) <= 0.02, (cost.flops, ref.flops)


def test_derive_roofline_terms_at_the_h100():
    """The three terms at the H100's constants, the bottleneck the largest,
    the reference's fields; the fp32 peak where a solve asks for it."""
    from repro_torch.roofline.op_cost import OpCost
    cost = OpCost(flops=989.4e12, bytes=3.35e12 * 2, collective_bytes={"all-reduce": 450e9})
    r = an.derive_roofline(cost, chips=4, model_flops=989.4e12 * 2)
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 2.0, 1.0)
    assert r.bottleneck == "memory" and r.useful_flops_ratio == 0.5
    assert r.xla_flops_once == r.flops_per_device and r.unbounded_whiles == 0
    assert set(r.as_dict()) == set(jan.Roofline.__dataclass_fields__)
    fp32 = an.derive_roofline(cost, chips=1, model_flops=1.0, peak_flops=an.PEAK_FLOPS_FP32)
    assert fp32.compute_s == pytest.approx(989.4 / 66.9)
    rep = an.memory_report(OpCost())
    assert set(rep) == {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
                        "alias_size_in_bytes", "generated_code_size_in_bytes",
                        "total_per_device"}
    np.testing.assert_equal(rep["total_per_device"], 0)
