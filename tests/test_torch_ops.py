"""The port's KernelOps layer: registry, CountingOps, and the "torch" backend
against the JAX package's "jnp" backend.

Parity tolerance rtol = atol = 1e-4 (tests/test_kernel_ops.py's TOL): both
backends run the same blocked fp32 math in a different summation order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ops as jops
from repro.core import make_kernel as jmake
from repro_torch.core import make_kernel
from repro_torch.ops import (
    POLICIES,
    CountingOps,
    KernelOps,
    SweepPlanWarning,
    available_ops,
    get_ops,
    resolve_precision,
)

KERNELS = [
    ("gaussian", dict(sigma=1.3)),
    ("laplacian", dict(sigma=1.1)),
    ("matern32", dict(sigma=1.7)),
    ("linear", dict(scale=1.5)),
    ("polynomial", dict(degree=2, c=0.5, scale=2.0)),
]
TOL = dict(rtol=1e-4, atol=1e-4)


def _data(n, M, d, p, seed):
    rng = np.random.default_rng(seed)
    cols = () if p is None else (p,)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(n, d), f(M, d), f(M, *cols), f(n, *cols)


def test_registry_and_errors():
    assert available_ops() == ("cuda", "torch")
    assert "cuda" not in jops.available_ops()       # nothing leaks into repro
    kern = make_kernel("gaussian")
    for impl in available_ops():
        assert isinstance(get_ops(impl, kern), KernelOps)
    with pytest.raises(ValueError, match="unknown KernelOps impl"):
        get_ops("pallas", kern)
    with pytest.raises(ValueError, match="unknown precision"):
        get_ops("torch", kern, precision="fp8")
    with pytest.raises(NotImplementedError, match="A7"):
        get_ops("cuda", kern, precision="bf16")
    assert resolve_precision("fp32") is POLICIES["fp32"]
    assert POLICIES["bf16"].buffer_dtype("gram") == "float32"
    assert POLICIES["bf16"].buffer_dtype("data") == "bfloat16"


def test_plans():
    kern = make_kernel("gaussian")
    plan = get_ops("cuda", kern).plan(4_000_000, 10_000, 18)
    assert (plan.path, plan.block_m, plan.block_n) == ("fused", 64, 64)
    assert plan.shard_m is None and plan.io_bytes <= plan.workspace_budget_bytes
    assert plan.hbm_bytes == 4 * ((4_000_000 + 10_000) * 18 + 4_000_000 + 2 * 10_000)
    tplan = get_ops("torch", kern, block_size=512).plan(1000, 64, 5, p=2, systems=3)
    assert (tplan.path, tplan.p, tplan.systems) == ("torch", 6, 3)
    w = SweepPlanWarning(plan)
    assert w.plan is plan and "fused" in str(w)


@pytest.mark.parametrize("name,params", KERNELS)
def test_torch_backend_matches_jnp(name, params):
    n, M, d = 300, 97, 13
    X, C, u, v = _data(n, M, d, None, seed=len(name))
    ref = jops.get_ops("jnp", jmake(name, **params), block_size=100)
    got = get_ops("torch", make_kernel(name, **params), block_size=100)
    Xj, Cj, uj, vj = map(jnp.asarray, (X, C, u, v))
    Xt, Ct, ut, vt = map(torch.from_numpy, (X, C, u, v))
    np.testing.assert_allclose(got.sweep(Xt, Ct, ut, vt).numpy(),
                               np.asarray(ref.sweep(Xj, Cj, uj, vj)), **TOL)
    np.testing.assert_allclose(got.sweep(Xt, Ct, ut).numpy(),
                               np.asarray(ref.sweep(Xj, Cj, uj)), **TOL)
    np.testing.assert_allclose(got.apply(Xt, Ct, ut).numpy(),
                               np.asarray(ref.apply(Xj, Cj, uj)), **TOL)
    np.testing.assert_allclose(got.gram(Xt, Ct).numpy(),
                               np.asarray(ref.gram(Xj, Cj)), **TOL)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("p", [None, 3])
def test_backends_multi_rhs_and_row_mask(impl, p):
    """Both backends (cuda on CPU tensors = the plain twins) against jnp,
    and the row_mask rule: masked junk rows equal the valid prefix exactly."""
    n, keep, M, d = 257, 200, 64, 6
    X, C, u, v = _data(n, M, d, p, seed=3)
    ref = jops.get_ops("jnp", jmake("gaussian", sigma=1.5), block_size=64)
    ops = get_ops(impl, make_kernel("gaussian", sigma=1.5), block_size=64)
    T = torch.from_numpy
    np.testing.assert_allclose(
        ops.sweep(T(X), T(C), T(u), T(v)).numpy(),
        np.asarray(ref.sweep(*map(jnp.asarray, (X, C, u, v)))), **TOL)
    Xj = X.copy()
    Xj[keep:] = 123.0
    mask = torch.zeros(n)
    mask[:keep] = 1.0
    got = ops.sweep(T(Xj), T(C), T(u), T(v), row_mask=mask)
    assert torch.equal(got, ops.sweep(T(X[:keep]), T(C), T(u), T(v[:keep])))
    got0 = ops.sweep(T(Xj), T(C), T(u), None, row_mask=mask)
    assert torch.equal(got0, ops.sweep(T(X[:keep]), T(C), T(u), None))


def test_float64_stays_float64_on_torch_backend():
    X, C, u, v = _data(50, 20, 3, None, seed=4)
    ops = get_ops("torch", make_kernel("gaussian"))
    T = lambda a: torch.from_numpy(a).double()
    assert ops.sweep(T(X), T(C), T(u), T(v)).dtype == torch.float64
    assert ops.gram(T(C), T(C)).dtype == torch.float64
    assert ops.gram(T(C).half(), T(C).half()).dtype == torch.float32   # widened


def test_cuda_backend_sweep_with_stats_counts_two_evals_per_tile():
    n, M, d = 300, 97, 13
    X, C, u, v = map(torch.from_numpy, _data(n, M, d, None, seed=6))
    ops = get_ops("cuda", make_kernel("gaussian", sigma=2.0))
    w, count = ops.sweep_with_stats(X, C, u, v)
    assert int(count) == 2 * 5 * 2
    torch.testing.assert_close(w, ops.sweep(X, C, u, v), rtol=0, atol=0)


def test_counting_ops_delegates_and_counts():
    X, C, u, v = map(torch.from_numpy, _data(300, 40, 4, None, seed=8))
    inner = get_ops("torch", make_kernel("gaussian"), block_size=128)
    ops = CountingOps(inner)
    assert (ops.kernel, ops.block_size, ops.precision) == (inner.kernel, 128, "fp32")
    assert ops.policy is POLICIES["fp32"]
    torch.testing.assert_close(ops.sweep(X, C, u, v), inner.sweep(X, C, u, v))
    ops.apply(X, C, u)
    ops.gram(C, C)
    assert (ops.sweeps, ops.applies, ops.grams) == (1, 1, 1)
    assert ops.gram_tile_evals == 3 + 3 + 1            # ceil(300/128) x2 + ceil(40/128)
    assert ops.plan(300, 40, 4) == inner.plan(300, 40, 4)
    ops.reset()
    assert (ops.sweeps, ops.applies, ops.grams, ops.gram_tile_evals) == (0, 0, 0, 0)
