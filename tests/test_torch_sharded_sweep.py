"""The port's out-of-core sweep (B4) and its Hopper sweep planner.

* ``sharded_sweep`` (on CPU tensors its plain twin, built on B2's twin)
  against the JAX package's ``sharded_sweep_pallas`` in interpret mode, as
  the JAX package's own tests run it, on the same numpy inputs: the five
  kernels, ragged shards, p None / 3, ``v=None`` and ``row_mask``.
  Tolerance: max |got - ref| <= 1e-4 + 1e-4 * max |ref|, the reference's
  ``TOL`` scaled by the result's magnitude as ``chip_smoke.py`` scales it:
  the two sum in different fp32 orders, and an entry that cancels to near 0
  keeps the rounding of its terms (the linear kernel's do).
* ``plan_sweep`` / ``CudaKernelOps.plan()``: the fused route at the main
  path's shapes, the two_pass and j_sharded routes under the
  ``REPRO_SWEEP_BUDGET_MB`` override, shard sizing, the structured
  ``SweepPlanWarning`` and ``sweep_with_stats``' refusal off the fused route.

The kernels run only on the card (``python3 chip_smoke.py`` holds B4 against
its twin and against B1 there).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernels as jk
from repro.kernels.kernel_matvec import sharded_sweep_pallas
from repro.ops import get_ops as jget_ops
from repro_torch.core import make_kernel
from repro_torch.kernels import kernel_matvec as km
from repro_torch.ops import SWEEP_PATHS, SweepPlanWarning, get_ops, plan_sweep

KERNELS = [
    ("gaussian", dict(sigma=1.3)),
    ("laplacian", dict(sigma=1.1)),
    ("matern32", dict(sigma=1.7)),
    ("linear", dict(scale=1.5)),
    ("polynomial", dict(degree=2, c=0.5, scale=2.0)),
]
TOL = dict(rtol=1e-4, atol=1e-4)
T = torch.from_numpy
J = jnp.asarray


def _data(n, M, d, p=None, seed=0):
    rng = np.random.default_rng(seed)
    cols = () if p is None else (p,)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(n, d), f(M, d), f(M, *cols), f(n, *cols)


def assert_close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= TOL["atol"] + TOL["rtol"] * float(np.abs(ref).max()), err


def _specs(name, params):
    return jk.spec_of(jk.make_kernel(name, **params)), make_kernel(name, **params).spec


# ---------------------------------------------------------------------------
# B4 against sharded_sweep_pallas
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,params", KERNELS)
def test_sharded_sweep_matches_pallas_all_kernels(name, params):
    """M = 333 with shard_m = 128: shards of 128, 128 and 77."""
    n, M, d = 200, 333, 13
    X, C, u, v = _data(n, M, d, seed=len(name))
    jspec, tspec = _specs(name, params)
    ref = sharded_sweep_pallas(J(X), J(C), J(u), J(v), spec=jspec, shard_m=128)
    got = km.sharded_sweep(T(X), T(C), T(u), T(v), spec=tspec, shard_m=128)
    assert_close(got, ref)


@pytest.mark.parametrize("p", [None, 3])
@pytest.mark.parametrize("shard_m", [100, 512])
def test_sharded_sweep_multirhs_and_vnone(p, shard_m):
    n, M, d = 150, 257, 9
    X, C, u, v = _data(n, M, d, p=p, seed=7)
    jspec, tspec = _specs("gaussian", dict(sigma=1.5))
    for vv in (v, None):
        ref = sharded_sweep_pallas(J(X), J(C), J(u), None if vv is None else J(vv),
                                   spec=jspec, shard_m=shard_m)
        got = km.sharded_sweep(T(X), T(C), T(u), None if vv is None else T(vv), spec=tspec,
                               shard_m=shard_m)
        assert_close(got, ref)


@pytest.mark.parametrize("p", [None, 3])
def test_sharded_sweep_row_mask(p):
    """Masked rows contribute zero: junk rows under the mask give the valid
    prefix's result, and the reference's masked sweep."""
    n, keep, M, d = 257, 200, 150, 6
    X, C, u, v = _data(n, M, d, p=p, seed=3)
    jspec, tspec = _specs("gaussian", dict(sigma=1.5))
    Xj = X.copy()
    Xj[keep:] = 123.0
    mask = np.zeros(n, np.float32)
    mask[:keep] = 1.0
    got = km.sharded_sweep(T(Xj), T(C), T(u), T(v), spec=tspec, row_mask=T(mask), shard_m=64)
    prefix = km.sharded_sweep(T(X[:keep]), T(C), T(u), T(v[:keep]), spec=tspec, shard_m=64)
    assert_close(got, prefix)
    ref = sharded_sweep_pallas(J(Xj), J(C), J(u), J(v), spec=jspec, row_mask=J(mask),
                               shard_m=64)
    assert_close(got, ref)


@pytest.mark.parametrize("chunk", [64, 100])
def test_sharded_sweep_row_chunks(monkeypatch, chunk):
    """The transposed pass summed over X in row chunks (ragged last chunk)
    is the same sweep; masked rows still contribute zero."""
    n, M, d = 257, 150, 6
    X, C, u, v = _data(n, M, d, p=2, seed=9)
    jspec, tspec = _specs("gaussian", dict(sigma=1.5))
    mask = np.ones(n, np.float32)
    mask[::7] = 0.0
    ref = sharded_sweep_pallas(J(X), J(C), J(u), J(v), spec=jspec, row_mask=J(mask),
                               shard_m=64)
    monkeypatch.setattr(km, "SHARD_ROW_CHUNK", chunk)
    got = km.sharded_sweep(T(X), T(C), T(u), T(v), spec=tspec, row_mask=T(mask), shard_m=64)
    assert_close(got, ref)


def test_sharded_sweep_matches_fused_twin_and_counts_no_cpu_launch():
    km.reset_launch_counts()
    X, C, u, v = _data(300, 97, 13, p=2, seed=5)
    spec = make_kernel("gaussian", sigma=2.0).spec
    w4 = km.sharded_sweep(T(X), T(C), T(u), T(v), spec=spec, shard_m=64)
    w1 = km.fused_sweep(T(X), T(C), T(u), T(v), spec=spec)
    assert_close(w4, w1)
    assert km.launch_counts()["sharded_sweep"] == 0
    assert km.launch_counts()["kernel_matmul"] == 0


def test_sharded_sweep_dtype_rules():
    X, C, u, v = map(T, _data(20, 10, 3, seed=1))
    spec = make_kernel("gaussian").spec
    for kw in (dict(t_dtype=torch.float8_e4m3fn), dict(out_dtype=torch.float8_e4m3fn)):
        with pytest.raises(NotImplementedError, match="A7"):
            km.sharded_sweep(X, C, u, v, spec=spec, **kw)
    w = km.sharded_sweep(X, C, u, v, spec=spec, t_dtype=torch.bfloat16)
    assert w.shape == (10,) and w.dtype == torch.float32    # C's and t's promotion
    w = km.sharded_sweep(X, C, u, v, spec=spec, t_dtype=torch.float32,
                         out_dtype=torch.float32)
    assert w.shape == (10,) and w.dtype == torch.float32


# ---------------------------------------------------------------------------
# The Hopper sweep planner and the backend's routing
# ---------------------------------------------------------------------------
def test_plan_sweep_routes_main_path_shapes_fused():
    """SUSY (M = 10^4) and MillionSongs (M = 5x10^4) shapes stay on B1."""
    ops = get_ops("cuda", make_kernel("gaussian", sigma=6.0))
    for n, M, d in ((4_000_000, 10_000, 18), (463_715, 50_000, 90)):
        plan = ops.plan(n, M, d)
        assert plan.path == "fused" and plan.shard_m is None
        grid = km.sweep_grid_model(M, 1, d)
        assert plan.io_bytes == min(grid, -(-n // 128)) * M * 4
        assert plan.io_bytes <= plan.workspace_budget_bytes
        assert plan.scratch_bytes == km.sweep_smem_bytes(M, 1, d)[0]
    # M = 5x10^4, d = 90: w partials in global memory, two 85 KB blocks per SM
    assert km.sweep_grid_model(50_000, 1, 90) == 132 * 2
    assert ops.plan(463_715, 50_000, 90).io_bytes == 264 * 50_000 * 4


def test_plan_sweep_transitions_with_budget():
    """fused -> two_pass -> j_sharded as the budget shrinks, M fixed."""
    args = dict(bm=64, bn=64, width=1, scratch_bytes=21760, grid=1056)
    n, M, d = 463_715, 50_000, 90
    big = plan_sweep(n, M, d, 1, workspace_budget=2**31, **args)
    assert big.path == "fused"
    mid = plan_sweep(n, M, d, 1, workspace_budget=100 * 2**20, **args)
    assert (mid.path, mid.shard_m) == ("two_pass", None)
    tiny = plan_sweep(n, M, d, 1, workspace_budget=6 * 2**20, **args)
    assert tiny.path == "j_sharded"
    assert tiny.shard_m == (6 * 2**20 // (4 * (d + 1))) // 64 * 64 == 17280
    assert str(tiny.workspace_budget_bytes) in tiny.reason and "3 C-shards" in tiny.reason
    forced = plan_sweep(n, M, d, 1, workspace_budget=1, shard_m=100, **args)
    assert forced.shard_m == 64                         # tile-aligned, at least one tile
    wide = plan_sweep(n, M, d, 1, systems=3, workspace_budget=2**31, **args)
    assert (wide.p, wide.systems) == (3, 3)
    assert {big.path, mid.path, tiny.path} <= set(SWEEP_PATHS)


def test_backend_env_override_routes_and_matches(monkeypatch):
    """REPRO_SWEEP_BUDGET_MB forces each route; every route agrees with the
    reference's jnp sweep, and leaving the fused route warns with the plan."""
    n, M, d = 2000, 333, 13
    X, C, u, v = _data(n, M, d, p=2, seed=11)
    ops = get_ops("cuda", make_kernel("gaussian", sigma=1.5))
    ref = np.asarray(jget_ops("jnp", jk.make_kernel("gaussian", sigma=1.5), block_size=64)
                     .sweep(J(X), J(C), J(u), J(v)))
    assert ops.plan(n, M, d, 2).path == "fused"
    assert_close(ops.sweep(T(X), T(C), T(u), T(v)), ref)
    # fused workspace: 16 row blocks x M x 4 columns x 4 B = 85,248 B
    assert ops.plan(n, M, d, 2).io_bytes == 16 * M * 4 * 4
    budgets = {"two_pass": 0.05, "j_sharded": 128 * 4 * (d + 4) / 2**20}
    for path, mb in budgets.items():
        monkeypatch.setenv("REPRO_SWEEP_BUDGET_MB", str(mb))
        plan = ops.plan(n, M, d, 2)
        assert plan.path == path
        assert plan.shard_m == (128 if path == "j_sharded" else None)
        with pytest.warns(SweepPlanWarning) as rec:
            got = ops.sweep(T(X), T(C), T(u), T(v))
        assert rec[0].message.plan.path == path
        assert_close(got, ref)
        with pytest.raises(ValueError, match="workspace budget"):
            ops.sweep_with_stats(T(X), T(C), T(u), T(v))
    monkeypatch.delenv("REPRO_SWEEP_BUDGET_MB")
    w, count = ops.sweep_with_stats(T(X), T(C), T(u), T(v))
    assert int(count) == 2 * 16 * 3


def test_torch_backend_plan_fields():
    plan = get_ops("torch", make_kernel("gaussian"), block_size=512).plan(1000, 64, 5)
    assert (plan.path, plan.shard_m, plan.io_bytes) == ("torch", None, 0)
