"""repro_torch.core.kernels against repro.core.kernels on the same inputs.

The dense K of all five registered kernels matches the JAX package to
rtol = atol = 1e-5: both evaluate the same fp32 formula (one matmul, the
norms, the map), so only matmul summation order differs.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernels as jk
from repro_torch.core import kernels as tk

KERNELS = [
    ("gaussian", dict(sigma=1.3)),
    ("laplacian", dict(sigma=1.1)),
    ("matern32", dict(sigma=1.7)),
    ("linear", dict(scale=1.5)),
    ("polynomial", dict(degree=3, c=0.5, scale=2.0)),
]
TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(n, m, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((m, d)).astype(np.float32))


@pytest.mark.parametrize("name,params", KERNELS)
@pytest.mark.parametrize("shape", [(37, 29, 5), (128, 64, 18)])
def test_dense_kernel_matches_reference(name, params, shape):
    A, B = _pair(*shape, seed=len(name) + shape[0])
    ref = np.asarray(jk.make_kernel(name, **params)(jnp.asarray(A), jnp.asarray(B)))
    got = tk.make_kernel(name, **params)(torch.from_numpy(A), torch.from_numpy(B))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # the block K(A, A): on the diagonal a2 + a2 - 2ab is fp32 rounding
    # noise of size ~eps * ||a||^2 in both packages. The laplacian takes its
    # square root, so there the two packages' roundings differ by
    # sqrt(4 eps max||a||^2) / sigma (~2e-3 here); the other maps are smooth
    # at 0 and keep the 1e-5 bound.
    ref_aa = np.asarray(jk.make_kernel(name, **params)(jnp.asarray(A), jnp.asarray(A)))
    got_aa = tk.make_kernel(name, **params)(torch.from_numpy(A), torch.from_numpy(A))
    tol = TOL
    if name == "laplacian":
        eps = np.finfo(np.float32).eps
        tol = dict(rtol=1e-5, atol=2 * np.sqrt(4 * eps * (A * A).sum(1).max()) / params["sigma"])
    np.testing.assert_allclose(got_aa.numpy(), ref_aa, **tol)


@pytest.mark.parametrize("name,params", KERNELS)
def test_spec_round_trips_between_packages(name, params):
    jspec = jk.spec_of(jk.make_kernel(name, **params))
    tspec = tk.spec_of(tk.make_kernel(name, **params))
    assert dataclasses.astuple(tspec) == dataclasses.astuple(jspec)
    carried = tk.KernelSpec(jspec.kind, jspec.params)
    assert carried == tspec
    assert tk.kernel_from_spec(carried).spec == tspec
    assert tk.make_kernel(name, **params).kappa_sq == 1.0


def test_registry_matches_reference():
    assert tk.available_kernels() == jk.available_kernels()
    with pytest.raises(ValueError, match="unknown kernel"):
        tk.make_kernel("rbf")
    with pytest.raises(ValueError, match="unknown kernel kind"):
        tk.tile_transform(torch.zeros(1, 1), torch.zeros(1, 1), torch.zeros(1, 1),
                          tk.KernelSpec("rbf"))


def test_spec_of_refuses_objects_without_a_spec():
    @dataclasses.dataclass(frozen=True)
    class GaussianLookalikeKernel:
        sigma: float = 1.0

    with pytest.raises(TypeError, match="KernelSpec"):
        tk.spec_of(GaussianLookalikeKernel())
    spec = tk.KernelSpec("gaussian", (("sigma", 2.0),))
    assert tk.spec_of(spec) is spec


def test_tile_transform_formulas_pinned():
    """The exact formulas the CUDA map (csrc/tile.cuh) mirrors."""
    ab = torch.tensor([[0.5]])
    a2 = torch.tensor([[1.0]])
    b2 = torch.tensor([[2.0]])
    sq = 2.0                                   # 1 + 2 - 2 * 0.5
    r = np.sqrt(sq + 1e-12)
    cases = {
        "gaussian": (dict(sigma=2.0), np.exp(-0.5 / 4.0 * sq)),
        "laplacian": (dict(sigma=2.0), np.exp(-r / 2.0)),
        "matern32": (dict(sigma=2.0), (1 + np.sqrt(3.0) * r / 2) * np.exp(-np.sqrt(3.0) * r / 2)),
        "linear": (dict(scale=2.0), 0.5 / 4.0),
        "polynomial": (dict(degree=3, c=1.0, scale=2.0), (0.5 / 4.0 + 1.0) ** 3),
    }
    for kind, (params, want) in cases.items():
        spec = tk.make_kernel(kind, **params).spec
        got = float(tk.tile_transform(ab, a2, b2, spec))
        assert got == pytest.approx(want, rel=1e-6), kind
    # negative rounding of the distance is clamped to exactly 0
    spec = tk.make_kernel("gaussian", sigma=1.0).spec
    assert float(tk.tile_transform(torch.tensor([[1.0]]), torch.tensor([[1.0]]),
                                   torch.tensor([[0.9999999]]), spec)) == 1.0
