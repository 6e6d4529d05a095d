"""The plain twins of the CUDA kernels B1-B3 against the Pallas kernels.

On the CPU each wrapper (``fused_sweep``, ``kernel_matmul``,
``pairwise_kernel``) runs its plain PyTorch twin; the JAX side runs
``fused_sweep_pallas`` / ``kernel_matmul_pallas`` / ``pairwise_kernel_pallas``
in interpret mode, as the JAX package's own tests do. Tolerance
rtol = atol = 1e-4, the ``TOL`` of tests/test_kernel_ops.py: fp32 with a
different summation order. The kernels themselves run only on the card
(``python3 chip_smoke.py`` holds them against these twins there).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernels as jk
from repro.kernels.kernel_matvec import (
    fused_sweep_pallas,
    kernel_matmul_pallas,
    pairwise_kernel_pallas,
)
from repro_torch.core import kernels as tk
from repro_torch.kernels import kernel_matvec as km
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

KERNELS = [
    ("gaussian", dict(sigma=1.3)),
    ("laplacian", dict(sigma=1.1)),
    ("matern32", dict(sigma=1.7)),
    ("linear", dict(scale=1.5)),
    ("polynomial", dict(degree=2, c=0.5, scale=2.0)),
]
SHAPES = [(300, 97, 13), (37, 200, 5), (513, 129, 33)]
TOL = dict(rtol=1e-4, atol=1e-4)


def _data(n, M, d, p, seed):
    rng = np.random.default_rng(seed)
    cols = () if p is None else (p,)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(n, d), f(M, d), f(M, *cols), f(n, *cols)


def _specs(name, params):
    return jk.spec_of(jk.make_kernel(name, **params)), tk.make_kernel(name, **params).spec


T = torch.from_numpy
J = jnp.asarray


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("p", [None, 3])
def test_sweep_twin_matches_pallas_ragged(shape, p):
    n, M, d = shape
    X, C, u, v = _data(n, M, d, p, seed=SHAPES.index(shape))
    jspec, tspec = _specs("gaussian", dict(sigma=1.5))
    ref = fused_sweep_pallas(J(X), J(C), J(u), J(v), spec=jspec, interpret=True)
    got, count = km.fused_sweep(T(X), T(C), T(u), T(v), spec=tspec, return_tile_count=True)
    assert got.shape == tuple(ref.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    nbi, nbj = km.sweep_tile_grid(n, M)
    assert int(count) == 2 * nbi * nbj          # two evaluations per tile
    ref0 = fused_sweep_pallas(J(X), J(C), J(u), None, spec=jspec, interpret=True)
    got0 = km.fused_sweep(T(X), T(C), T(u), None, spec=tspec)
    np.testing.assert_allclose(got0.numpy(), np.asarray(ref0), **TOL)


@pytest.mark.parametrize("name,params", KERNELS)
def test_all_kernels_sweep_apply_gram(name, params):
    n, M, d = 211, 77, 9
    X, C, u, v = _data(n, M, d, 3, seed=len(name))
    jspec, tspec = _specs(name, params)
    np.testing.assert_allclose(
        km.fused_sweep(T(X), T(C), T(u), T(v), spec=tspec).numpy(),
        np.asarray(fused_sweep_pallas(J(X), J(C), J(u), J(v), spec=jspec, interpret=True)),
        **TOL)
    np.testing.assert_allclose(
        km.kernel_matmul(T(X), T(C), T(u), spec=tspec).numpy(),
        np.asarray(kernel_matmul_pallas(J(X), J(C), J(u), spec=jspec, interpret=True)),
        **TOL)
    np.testing.assert_allclose(
        km.pairwise_kernel(T(X), T(C), spec=tspec).numpy(),
        np.asarray(pairwise_kernel_pallas(J(X), J(C), spec=jspec, interpret=True)),
        **TOL)


@pytest.mark.parametrize("p", [None, 3])
def test_matmul_add_matches_pallas(p):
    n, M, d = 150, 70, 6
    X, C, u, v = _data(n, M, d, p, seed=21)
    jspec, tspec = _specs("matern32", dict(sigma=1.2))
    u2, v2 = (u[:, None], v[:, None]) if p is None else (u, v)
    ref = kernel_matmul_pallas(J(X), J(C), J(u2), spec=jspec, add=J(v2), interpret=True)
    got = km.kernel_matmul(T(X), T(C), T(u), T(v), spec=tspec)
    np.testing.assert_allclose(got.numpy().reshape(ref.shape), np.asarray(ref), **TOL)


@pytest.mark.parametrize("p", [None, 3])
def test_row_mask_gives_exactly_the_prefix(p):
    """Masked rows contribute EXACTLY zero: junk rows under a 0 mask equal
    sweeping the valid prefix alone, bit for bit (with and without v)."""
    n, keep, M, d = 300, 260, 64, 7
    X, C, u, v = _data(n, M, d, p, seed=5)
    tspec = tk.make_kernel("gaussian", sigma=1.4).spec
    Xj = X.copy()
    Xj[keep:] = 123.0
    mask = torch.zeros(n)
    mask[:keep] = 1.0
    for vv, vp in ((T(v), T(v[:keep])), (None, None)):
        got = km.fused_sweep(T(Xj), T(C), T(u), vv, spec=tspec, row_mask=mask)
        want = km.fused_sweep(T(X[:keep]), T(C), T(u), vp, spec=tspec)
        assert torch.equal(got, want)
    # and the same against the Pallas kernel's masked sweep
    jspec = jk.spec_of(jk.make_kernel("gaussian", sigma=1.4))
    ref = fused_sweep_pallas(J(Xj), J(C), J(u), J(v), spec=jspec,
                             row_mask=jnp.asarray(mask.numpy()), interpret=True)
    np.testing.assert_allclose(
        km.fused_sweep(T(Xj), T(C), T(u), T(v), spec=tspec, row_mask=mask).numpy(),
        np.asarray(ref), **TOL)


def test_kernel_ops_and_dense_oracles():
    X, C, u, v = _data(120, 40, 4, None, seed=9)
    kern = tk.make_kernel("laplacian", sigma=1.2)
    w = kops.fused_knm_matvec(T(X), T(C), T(u), T(v), kern)
    np.testing.assert_allclose(
        w.numpy(), kref.fused_knm_matvec_ref(T(X), T(C), T(u), T(v), "laplacian", 1.2).numpy(),
        **TOL)
    np.testing.assert_allclose(
        kops.two_pass_knm_matvec(T(X), T(C), T(u), T(v), kern).numpy(), w.numpy(), **TOL)
    np.testing.assert_allclose(
        kops.kernel_matmul(T(X), T(C), T(u), kern).numpy(),
        kref.kernel_matmul_ref(T(X), T(C), T(u), "laplacian", 1.2).numpy(), **TOL)
    np.testing.assert_allclose(
        kops.pairwise_kernel(T(X), T(C), kern).numpy(),
        kref.pairwise_kernel_ref(T(X), T(C), "laplacian", 1.2).numpy(), **TOL)
    with pytest.raises(ValueError, match="sigma kernels"):
        kref.kernel_tile(T(X), T(C), "linear", 1.0)


def test_cpu_tensors_take_the_twin_and_count_no_launch():
    km.reset_launch_counts()
    X, C, u, v = _data(64, 32, 3, None, seed=2)
    spec = tk.make_kernel("gaussian").spec
    km.fused_sweep(T(X), T(C), T(u), T(v), spec=spec)
    km.kernel_matmul(T(X), T(C), T(u), spec=spec)
    km.pairwise_kernel(T(X), T(C), spec=spec)
    km.sharded_sweep(T(X), T(C), T(u), T(v), spec=spec, shard_m=16)
    assert km.launch_counts() == {
        "fused_sweep": 0, "sharded_sweep": 0, "kernel_matmul": 0, "pairwise_kernel": 0,
        "potrf_tile": 0, "trsm_panel": 0, "trailing_update": 0}
    with pytest.raises(ValueError, match="no kernel or plain path"):
        km.pairwise_kernel(T(X).to("meta"), T(C).to("meta"), spec=spec)


def test_kernel_operand_rules():
    """What the CUDA path refuses, checked without a card."""
    cpu = torch.device("cpu")
    with pytest.raises(NotImplementedError, match="A7"):
        km._check_operands("sweep", cpu, X=torch.zeros(4, 2, dtype=torch.float64))
    with pytest.raises(NotImplementedError, match="A7"):
        km._check_operands("sweep", cpu, X=torch.zeros(4, 2, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        km._check_operands("sweep", cpu, X=torch.zeros(4, 2).T)
    with pytest.raises(ValueError, match="at most 4"):
        km._pad_p(5)
    assert [km._pad_p(p) for p in (1, 2, 3, 4)] == [1, 4, 4, 4]
    with pytest.raises(NotImplementedError, match="A7"):
        km.kernel_matmul(torch.zeros(2, 2), torch.zeros(2, 2), torch.zeros(2),
                         spec=tk.make_kernel("gaussian").spec, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no CUDA kernel map"):
        km._kparams(tk.KernelSpec("rbf"))


def test_sweep_tiling_and_shared_memory_plan():
    assert km.sweep_block_dims(10, 10) == (64, 64)
    assert km.sweep_tile_grid(4_000_000, 10_000) == (62_500, 157)
    # the main path (M = 10^4, p = 1) keeps its w partial in shared memory
    smem, in_smem = km.sweep_smem_bytes(10_000, 1)
    assert in_smem and smem == km.TILE_SMEM_BYTES + 4 * (64 + 64 + 16 * 64) + 4 * 10_000
    assert smem <= km.W_SMEM_LIMIT
    smem, in_smem = km.sweep_smem_bytes(100_000, 3)
    assert not in_smem and smem == km.TILE_SMEM_BYTES + 4 * 4 * (64 + 64 + 16 * 64)
    # the tiling constants the CUDA sources assume
    assert km.TILE_SMEM_BYTES == 17152
    kind, sigma, coef, ss, c, degree = km._kparams(tk.make_kernel("gaussian", sigma=4.0).spec)
    assert (kind, sigma, coef) == (0, 4.0, -0.5 / 16.0)
