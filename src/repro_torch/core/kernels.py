"""Kernel functions for FALKON, plus the declarative kernel-spec registry.

PyTorch counterpart of ``repro/core/kernels.py``. Each kernel is a small
frozen dataclass with ``__call__(X, Y) -> (n, m)`` returning the Gram block
K(X, Y), and every registered kernel carries a :class:`KernelSpec`
(``kind`` string + sorted static params tuple) with the same fields as the
JAX package's, so a spec crosses packages unchanged.

All backends evaluate kernels through :func:`tile_transform`, a pure function
of the matmul precursors

    ab = A @ B^T,   a2 = ||a_i||^2,   b2 = ||b_j||^2

keyed by ``spec.kind``. The hand-written CUDA kernels implement the same
formulas in ``repro_torch/kernels/csrc/tile.cuh`` (``kmap``); a change here
must be mirrored there.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Protocol

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Declarative, hashable description of a kernel: (kind, static params).

    ``params`` is a sorted tuple of (name, value) pairs so specs are hashable.
    """

    kind: str
    params: tuple[tuple[str, float], ...] = ()

    def as_dict(self) -> dict:
        return dict(self.params)


def _sqdist_of(ab: Tensor, a2: Tensor, b2: Tensor) -> Tensor:
    """||a||^2 + ||b||^2 - 2 a.b, clamped at 0 for numerical safety."""
    return torch.clamp(a2 + b2 - 2.0 * ab, min=0.0)


def tile_transform(ab: Tensor, a2: Tensor, b2: Tensor, spec: KernelSpec) -> Tensor:
    """Map matmul precursors to a Gram tile for any registered kernel kind.

    ``ab`` is (m, n) = A @ B^T; ``a2`` is (m, 1); ``b2`` is (1, n).
    """
    p = spec.as_dict()
    kind = spec.kind
    if kind == "gaussian":
        sigma = p.get("sigma", 1.0)
        return torch.exp(-0.5 / (sigma * sigma) * _sqdist_of(ab, a2, b2))
    if kind == "laplacian":
        sigma = p.get("sigma", 1.0)
        d = torch.sqrt(_sqdist_of(ab, a2, b2) + 1e-12)
        return torch.exp(-d / sigma)
    if kind == "matern32":
        sigma = p.get("sigma", 1.0)
        r = torch.sqrt(_sqdist_of(ab, a2, b2) + 1e-12)
        a = math.sqrt(3.0) * r / sigma
        return (1.0 + a) * torch.exp(-a)
    if kind == "linear":
        scale = p.get("scale", 1.0)
        return ab / (scale * scale)
    if kind == "polynomial":
        scale = p.get("scale", 1.0)
        base = ab / (scale * scale) + p.get("c", 1.0)
        out = torch.ones_like(base)
        for _ in range(int(p.get("degree", 2))):   # repeated multiply
            out = out * base
        return out
    raise ValueError(f"unknown kernel kind {spec.kind!r}; have {sorted(_REGISTRY)}")


def tile_eval(spec: KernelSpec, X: Tensor, Y: Tensor) -> Tensor:
    """K(X, Y) from a spec: one matmul plus elementwise work."""
    a2 = torch.sum(X * X, dim=-1, keepdim=True)             # (n, 1)
    b2 = torch.sum(Y * Y, dim=-1, keepdim=True).T           # (1, m)
    ab = X @ Y.T                                            # (n, m)
    return tile_transform(ab, a2, b2, spec)


class KernelFn(Protocol):
    def __call__(self, X: Tensor, Y: Tensor) -> Tensor: ...

    @property
    def kappa_sq(self) -> float: ...

    @property
    def spec(self) -> KernelSpec: ...


_REGISTRY: dict[str, type] = {}


def _make_spec(self) -> KernelSpec:
    return KernelSpec(
        kind=type(self).kind,
        params=tuple(sorted((f.name, getattr(self, f.name))
                            for f in dataclasses.fields(self))),
    )


def register_kernel(kind: str):
    """Register a kernel dataclass under ``kind`` and attach its ``spec``."""
    def deco(cls):
        cls.kind = kind
        cls.spec = property(_make_spec)
        _REGISTRY[kind] = cls
        return cls
    return deco


def spec_of(kernel) -> KernelSpec:
    """The KernelSpec of a kernel object (or a spec passed as-is)."""
    spec = getattr(kernel, "spec", None)
    if isinstance(spec, KernelSpec):
        return spec
    if isinstance(kernel, KernelSpec):
        return kernel
    raise TypeError(
        f"{type(kernel).__name__} carries no KernelSpec; register it with "
        "@register_kernel in repro_torch.core.kernels")


class _SpecKernel:
    """Shared ``__call__`` and ``kappa_sq`` of the registered kernels."""

    def __call__(self, X: Tensor, Y: Tensor) -> Tensor:
        return tile_eval(self.spec, X, Y)

    @property
    def kappa_sq(self) -> float:
        return 1.0


@register_kernel("gaussian")
@dataclasses.dataclass(frozen=True)
class GaussianKernel(_SpecKernel):
    """K(x, y) = exp(-||x - y||^2 / (2 sigma^2)).  kappa^2 = 1."""

    sigma: float = 1.0


@register_kernel("laplacian")
@dataclasses.dataclass(frozen=True)
class LaplacianKernel(_SpecKernel):
    """K(x, y) = exp(-||x - y|| / sigma).  kappa^2 = 1."""

    sigma: float = 1.0


@register_kernel("matern32")
@dataclasses.dataclass(frozen=True)
class Matern32Kernel(_SpecKernel):
    """Matern nu=3/2: (1 + sqrt(3) r / sigma) exp(-sqrt(3) r / sigma)."""

    sigma: float = 1.0


@register_kernel("linear")
@dataclasses.dataclass(frozen=True)
class LinearKernel(_SpecKernel):
    """K(x, y) = x.y / scale^2; kappa^2 is nominal (bounded domains only)."""

    scale: float = 1.0


@register_kernel("polynomial")
@dataclasses.dataclass(frozen=True)
class PolynomialKernel(_SpecKernel):
    """K(x, y) = (x.y / scale^2 + c)^degree."""

    degree: int = 2
    c: float = 1.0
    scale: float = 1.0


def make_kernel(name: str, **kwargs) -> KernelFn:
    if name not in _REGISTRY:
        raise ValueError(f"unknown kernel {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def kernel_from_spec(spec: KernelSpec) -> KernelFn:
    """The registered kernel object a spec describes."""
    return make_kernel(spec.kind, **spec.as_dict())


def available_kernels() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
