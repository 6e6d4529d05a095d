"""The ``KernelOps`` backend protocol and registry (PyTorch port).

Counterpart of ``repro/ops/base.py``. FALKON's O(n sqrt(n)) time budget
reduces to three primitives over an (n, d) dataset ``X``, (M, d) Nystrom
centers ``C`` and coefficient vectors:

    sweep(X, C, u, v)  =  K(X,C)^T (K(X,C) u + v)    — one CG iteration
    apply(X, C, u)     =  K(X,C) u                    — the prediction path
    gram(A, B)         =  K(A, B)                     — the preconditioner path

Registered implementations (this package's registry only):

* ``"torch"`` — plain blocked PyTorch row scan; runs on any device, fp32/fp64,
  the CPU path and the port's own oracle (counterpart of ``"jnp"``).
* ``"cuda"``  — the hand-written Hopper kernels of
  ``repro_torch.kernels.kernel_matvec`` (counterpart of ``"pallas"``).

This module imports nothing from ``repro_torch.core`` or
``repro_torch.kernels``; backends duck-type the kernel via its ``spec``.

``precision`` names a :class:`PrecisionPolicy`. Only ``"fp32"`` runs in this
port so far: the bf16 end-to-end policy (reduced storage, Kahan-compensated
accumulation) is ROADMAP item A7, and backends refuse it with
``NotImplementedError`` rather than running fp32 under its name.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol, runtime_checkable

PRECISIONS = ("fp32", "bf16")

#: dtype-name -> bytes
_ITEMSIZE = {
    "float64": 8,
    "float32": 4,
    "bfloat16": 2,
    "float16": 2,
}


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """The precision contract of the FALKON hot loop.

    ``storage`` is the dtype of the data-space (n-sized) buffers,
    ``accumulate`` the dtype every contraction reduces in, ``compensated``
    turns on Kahan carries in the tile loops, and ``overrides`` pins named
    buffers (``gram``, ``cholesky``, ``coeffs``) to their own dtype. See the
    JAX package's ``PrecisionPolicy`` for why those three stay float32.
    """

    name: str
    storage: str = "float32"
    accumulate: str = "float32"
    compensated: bool = False
    overrides: tuple[tuple[str, str], ...] = (
        ("gram", "float32"), ("cholesky", "float32"), ("coeffs", "float32")
    )

    def buffer_dtype(self, buffer: str) -> str:
        """Storage dtype for a named buffer, honoring per-buffer overrides."""
        return dict(self.overrides).get(buffer, self.storage)

    @property
    def storage_itemsize(self) -> int:
        return _ITEMSIZE[self.storage]

    @property
    def accumulate_itemsize(self) -> int:
        return _ITEMSIZE[self.accumulate]

    @property
    def coeffs_itemsize(self) -> int:
        return _ITEMSIZE[self.buffer_dtype("coeffs")]


#: Named policies ``get_ops(precision=...)`` accepts as strings.
POLICIES: dict[str, PrecisionPolicy] = {
    "fp32": PrecisionPolicy(name="fp32"),
    "bf16": PrecisionPolicy(name="bf16", storage="bfloat16",
                            accumulate="float32", compensated=True),
}


def resolve_precision(precision) -> PrecisionPolicy:
    """Resolve a policy name (or pass through a ``PrecisionPolicy``)."""
    if isinstance(precision, PrecisionPolicy):
        return precision
    if precision in POLICIES:
        return POLICIES[precision]
    raise ValueError(
        f"unknown precision {precision!r}; supported: {PRECISIONS} "
        f"(or a PrecisionPolicy instance)")


def require_fp32_policy(policy: PrecisionPolicy) -> None:
    """Refuse a reduced-storage policy: it is not ported yet."""
    if policy.storage != "float32" or policy.compensated:
        raise NotImplementedError(
            f"precision policy {policy.name!r} (storage {policy.storage}, "
            f"compensated={policy.compensated}) is not ported yet: the bf16 "
            "end-to-end policy is ROADMAP.md item A7")


#: ``"two_eval"`` — the CUDA sweep: one kernel launch per sweep that
#: evaluates every Gram tile twice (forward pass, then transposed pass);
#: ``"torch"`` — the plain blocked row scan.
SWEEP_PATHS = ("two_eval", "torch")


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """The sweep-path decision for one (n, M, d, p) problem, with the memory
    numbers behind it — exposed via ``KernelOps.plan()`` so tests can assert
    on routing instead of reverse-engineering it."""

    path: str                  # one of SWEEP_PATHS
    n: int
    M: int
    d: int
    p: int                     # TOTAL column width charged (= systems * p_rhs)
    block_m: int               # (bm, bn) tile dims the sweep runs with
    block_n: int
    scratch_bytes: int         # on-chip scratch per block (CUDA: shared memory)
    reason: str
    input_dtype: str = "float32"
    accum_dtype: str = "float32"
    systems: int = 1

    @property
    def hbm_bytes(self) -> int:
        """Device-memory working set of one sweep: X, C, v, u and w."""
        item = _ITEMSIZE[self.input_dtype]
        return item * ((self.n + self.M) * self.d + self.n * self.p
                       + 2 * self.M * self.p)


class SweepPlanWarning(UserWarning):
    """Structured notice that a sweep left a backend's default path. Carries
    the full ``SweepPlan`` as ``.plan``. No route of this port emits it yet:
    the out-of-core routing it announces is ROADMAP.md item A9."""

    def __init__(self, plan: SweepPlan):
        self.plan = plan
        super().__init__(
            f"falkon sweep (n={plan.n}, M={plan.M}, d={plan.d}, p={plan.p}): "
            f"taking the {plan.path!r} path — {plan.reason}")


@runtime_checkable
class KernelOps(Protocol):
    """The three primitives the whole solver needs, plus ``plan``."""

    kernel: Any
    block_size: int
    precision: "str | PrecisionPolicy"

    def sweep(self, X, C, u, v=None, row_mask=None):
        """K(X,C)^T (K(X,C) u + v); ``v=None`` means v == 0.

        ``row_mask`` (n,), 0/1 (or None = all valid): rows with mask 0
        contribute EXACTLY zero to the result.
        """
        ...

    def apply(self, X, C, u):
        """K(X,C) u — the prediction path."""
        ...

    def gram(self, A, B):
        """K(A, B) materialized — the preconditioner path."""
        ...

    def plan(self, n: int, M: int, d: int, p: int = 1, systems: int = 1) -> SweepPlan:
        """The sweep path this backend would take for these shapes."""
        ...


_REGISTRY: dict[str, type] = {}


def register_ops(name: str):
    """Class decorator registering a KernelOps implementation under ``name``."""
    def deco(cls):
        cls.impl_name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def available_ops() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_ops(
    impl: str,
    kernel,
    *,
    block_size: int = 2048,
    precision: "str | PrecisionPolicy" = "fp32",
) -> KernelOps:
    """Construct the named backend for ``kernel`` (which must carry a
    ``KernelSpec``)."""
    if impl not in _REGISTRY:
        raise ValueError(
            f"unknown KernelOps impl {impl!r}; registered: {available_ops()}"
        )
    resolve_precision(precision)  # validate early
    return _REGISTRY[impl](kernel=kernel, block_size=block_size, precision=precision)


@dataclasses.dataclass(frozen=True)
class OpsBase:
    """Shared constructor shape for backends (kernel + static knobs)."""

    kernel: Any
    block_size: int = 2048
    precision: "str | PrecisionPolicy" = "fp32"

    def __post_init__(self):
        require_fp32_policy(self.policy)

    @property
    def policy(self) -> PrecisionPolicy:
        """The resolved :class:`PrecisionPolicy` this backend runs under."""
        return resolve_precision(self.precision)


class CountingOps:
    """Invocation-counting facade over any :class:`KernelOps`.

    Pure delegation plus the counters ``sweeps``, ``applies``, ``grams`` and
    ``gram_tile_evals`` (kernel-entry evaluation work in units of
    ceil(rows / block_size) row tiles, charged by every primitive that
    evaluates kernel entries). PyTorch runs eagerly, so unlike the JAX
    facade these are executed-call counts: a fit's 20 CG iterations count
    20 sweeps, not one traced program point.
    """

    def __init__(self, ops):
        self.ops = ops
        self.sweeps = 0
        self.applies = 0
        self.grams = 0
        self.gram_tile_evals = 0

    @property
    def kernel(self):
        return self.ops.kernel

    @property
    def block_size(self):
        return self.ops.block_size

    @property
    def precision(self):
        return self.ops.precision

    @property
    def policy(self):
        return self.ops.policy

    def _tiles(self, rows) -> int:
        return -(-int(rows) // self.ops.block_size)

    def sweep(self, X, C, u, v=None, row_mask=None):
        self.sweeps += 1
        self.gram_tile_evals += self._tiles(X.shape[0])
        return self.ops.sweep(X, C, u, v, row_mask)

    def apply(self, X, C, u):
        self.applies += 1
        self.gram_tile_evals += self._tiles(X.shape[0])
        return self.ops.apply(X, C, u)

    def gram(self, A, B):
        self.grams += 1
        self.gram_tile_evals += self._tiles(A.shape[0])
        return self.ops.gram(A, B)

    def plan(self, n: int, M: int, d: int, p: int = 1, systems: int = 1) -> SweepPlan:
        return self.ops.plan(n, M, d, p, systems)

    def reset(self) -> None:
        self.sweeps = self.applies = self.grams = 0
        self.gram_tile_evals = 0
