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

``precision`` names a :class:`PrecisionPolicy`: ``"fp32"`` (every buffer
float32, plain accumulation) or ``"bf16"``, the end-to-end policy: every
n-sized buffer (X, C and v, the CG iterates, the sharded sweep's t spill)
stored bfloat16, every contraction accumulated in float32 with Kahan
carries, and the ``gram``, ``cholesky`` and ``coeffs`` buffers kept float32
by override. A custom policy may store float32, bfloat16 or float16,
compensated or not; other storage types (fp8) are refused with
``NotImplementedError`` naming ROADMAP item A7.

It also hosts the three memory planners, pure arithmetic like the
reference's, each with a structured warning carrying the plan:

* :func:`plan_sweep` -> :class:`SweepPlan` (+ ``SweepPlanWarning``): routes
  a sweep fused -> two_pass -> j_sharded against Hopper's device-workspace
  model (``REPRO_SWEEP_BUDGET_MB``), not the TPU's VMEM model.
* :func:`plan_factor` -> :class:`FactorPlan` (+ ``FactorPlanWarning``):
  routes the preconditioner's Cholesky factors incore -> blocked against the
  reference's dense-factor budget (``REPRO_FACTOR_BUDGET_MB``, 512 MB).
* :func:`plan_cache` -> :class:`CachePlan` (+ ``CachePlanWarning``): routes a
  materialized K_nM (``repro_torch.ops.knm_cache.KernelCache``) device ->
  host -> off against the reference's budgets (``REPRO_KNM_BUDGET_MB``,
  1 GiB; ``REPRO_KNM_HOST_BUDGET_MB``, 8 GiB).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Protocol, runtime_checkable

import torch

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


#: storage types the port runs a policy at
STORAGES = ("float32", "bfloat16", "float16")


def require_supported_policy(policy: PrecisionPolicy) -> None:
    """Refuse a policy whose storage the port does not run: float32,
    bfloat16 and float16 storage, compensated or not, are ported; fp8 is
    not."""
    if policy.storage not in STORAGES or policy.accumulate != "float32":
        raise NotImplementedError(
            f"precision policy {policy.name!r} (storage {policy.storage}, "
            f"accumulate {policy.accumulate}) is not ported: the port stores "
            f"{', '.join(STORAGES)} and accumulates in float32; other "
            "storage types are ROADMAP.md item A7")


def quantize_storage(policy: PrecisionPolicy, a):
    """Data-space storage quantization, fp32 compute: round through the
    storage dtype and widen back. float32 storage passes ``a`` through
    untouched (a float64 caller keeps its float64). After
    ``repro.ops.gemm.quantize_storage``."""
    if a is None or policy.storage == "float32":
        return a
    return a.to(getattr(torch, policy.storage)).to(torch.float32)


def quantize_coeffs(policy: PrecisionPolicy, u):
    """u at the policy's coefficient dtype (float32 by override): a
    reduced-storage u (a bf16 CG iterate) is widened for compute, a float64
    u is never narrowed. After ``repro.ops.gemm.quantize_coeffs``."""
    co_name = policy.buffer_dtype("coeffs")
    co = getattr(torch, co_name)
    if co_name != "float32":
        return u.to(co).to(torch.float32)
    if u.dtype.itemsize < co.itemsize:
        return u.to(torch.float32)
    return u


#: ``"fused"`` — B1: one launch per sweep that evaluates every Gram tile
#: twice and folds K^T t into per-block w partials (a device workspace of
#: grid x M x P floats); ``"two_pass"`` / ``"j_sharded"`` — B4: the sweep as
#: B2 launches, t = K(X,C)u + v spilled to device memory, then K(C_j,X)t per
#: C-shard (one shard covering all of M is the two-pass case); ``"torch"`` —
#: the plain blocked row scan.
SWEEP_PATHS = ("fused", "two_pass", "j_sharded", "torch")

#: Default device-memory budget for the fused sweep's w-partial workspace.
#: Override per process with ``REPRO_SWEEP_BUDGET_MB`` (the port's
#: counterpart of the JAX package's ``REPRO_VMEM_BUDGET_MB``; tests and the
#: chip smoke use it to force each route) or per call via
#: ``plan_sweep(workspace_budget=)``. 2 GiB keeps M up to ~5x10^5 at p = 1
#: (M = 5x10^4 at p = 4) on the fused route of an 80 GB card.
DEFAULT_SWEEP_BUDGET = 2 * 2**30


def _sweep_budget() -> int:
    mb = os.environ.get("REPRO_SWEEP_BUDGET_MB")
    return int(float(mb) * 2**20) if mb else DEFAULT_SWEEP_BUDGET


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
    shard_m: int | None        # C-shard rows of the j_sharded route
    scratch_bytes: int         # shared memory of one fused-sweep block
    io_bytes: int              # device workspace of the fused route: its w partials
    workspace_budget_bytes: int
    reason: str
    input_dtype: str = "float32"    # X/C storage dtype
    vector_dtype: str = "float32"   # v/t data-space storage dtype
    accum_dtype: str = "float32"    # contraction accumulate dtype
    coeffs_dtype: str = "float32"   # u-in / w-out coefficient dtype
    compensated: bool = False       # Kahan carries beside the w partials
    systems: int = 1

    @property
    def hbm_bytes(self) -> int:
        """Device-memory working set of one fused sweep: X, C and v at
        storage width, u and w at coefficient width (the footprint the bf16
        policy halves; the n-sized terms dominate)."""
        return (_ITEMSIZE[self.input_dtype] * (self.n + self.M) * self.d
                + _ITEMSIZE[self.vector_dtype] * self.n * self.p
                + _ITEMSIZE[self.coeffs_dtype] * 2 * self.M * self.p)


def plan_sweep(n: int, M: int, d: int, p: int = 1, *, bm: int, bn: int,
               width: int, scratch_bytes: int, grid: int, systems: int = 1,
               policy: "PrecisionPolicy | None" = None,
               workspace_budget: int | None = None,
               shard_m: int | None = None) -> SweepPlan:
    """Pick fused / two_pass / j_sharded from Hopper's device-memory model.

    The fused sweep (B1) runs ``grid`` persistent blocks, each holding
    ``scratch_bytes`` of shared memory and its own w partial of M x
    ``width`` floats (``width`` = the compiled column width, p padded up) in
    a global workspace of ``min(grid, ceil(n / bm)) * M * width * 4`` bytes,
    doubled when the policy is ``compensated`` (each partial carries a
    same-size Kahan buffer, as the reference doubles its accumulators).
    When that workspace passes the budget, the sweep takes B4: each Gram
    entry is still evaluated twice, and only the C-shard size is left to
    choose. ``shard_m`` is sized so that one shard's C rows (at the storage
    width) and w rows (``width`` floats) fill the budget, in multiples of
    ``bn``; a single shard covering all of M is the two-pass route.

    ``systems`` charges stacked lam-path systems at the widened width
    ``p * systems``, as the reference planner does. Pure arithmetic.
    """
    pol = resolve_precision(policy if policy is not None else "fp32")
    if workspace_budget is None:
        workspace_budget = _sweep_budget()
    systems = max(systems, 1)
    p = max(p, 1) * systems
    nbi = -(-n // bm)
    workspace = min(grid, nbi) * M * width * 4 * (2 if pol.compensated else 1)
    base = dict(n=n, M=M, d=d, p=p, block_m=bm, block_n=bn, systems=systems,
                scratch_bytes=scratch_bytes, io_bytes=workspace,
                workspace_budget_bytes=workspace_budget,
                input_dtype=pol.storage, vector_dtype=pol.storage,
                accum_dtype=pol.accumulate, coeffs_dtype=pol.buffer_dtype("coeffs"),
                compensated=pol.compensated)
    if workspace <= workspace_budget:
        return SweepPlan(
            path="fused", shard_m=None,
            reason=(f"fused w-partial workspace {workspace}B fits the "
                    f"{workspace_budget}B device workspace budget"),
            **base)
    if shard_m is None:
        shard_m = workspace_budget // (pol.storage_itemsize * d + 4 * width)
    shard_m = max(bn, (int(shard_m) // bn) * bn)
    over = (f"fused w-partial workspace {workspace}B exceeds the "
            f"{workspace_budget}B device workspace budget")
    if shard_m >= M:
        return SweepPlan(
            path="two_pass", shard_m=None,
            reason=f"{over}; single C-shard covers M={M} — two-pass sweep",
            **base)
    return SweepPlan(
        path="j_sharded", shard_m=shard_m,
        reason=(f"{over}; j-sharded sweep over {-(-M // shard_m)} C-shards "
                f"of {shard_m} rows"),
        **base)


class SweepPlanWarning(UserWarning):
    """Structured notice that a sweep left the fused route: its w-partial
    workspace passed the device budget and the B4 route (two_pass or
    j_sharded) was chosen. Carries the full ``SweepPlan`` as ``.plan``."""

    def __init__(self, plan: SweepPlan):
        self.plan = plan
        super().__init__(
            f"falkon sweep (n={plan.n}, M={plan.M}, d={plan.d}, p={plan.p}): "
            f"taking the {plan.path!r} path — {plan.reason}")


# ---------------------------------------------------------------------------
# Factorization planning: in-core vs blocked (out-of-core) Cholesky
# ---------------------------------------------------------------------------
FACTOR_PATHS = ("incore", "blocked")

#: Default budget for a DENSE in-core Cholesky factor, the reference's: past
#: it ``plan_factor`` routes to the blocked right-looking Cholesky
#: (``repro_torch.kernels.blocked_cholesky``), which keeps the matrix on the
#: host and holds only O(b * M) panel bytes on the device. Override per
#: process with ``REPRO_FACTOR_BUDGET_MB``.
DEFAULT_FACTOR_BUDGET = 512 * 2**20

#: Blocked-path tile bounds (multiples of 256), as the reference's.
_FACTOR_BLOCK_MIN = 256
_FACTOR_BLOCK_MAX = 2048


def _factor_budget() -> int:
    mb = os.environ.get("REPRO_FACTOR_BUDGET_MB")
    return int(float(mb) * 2**20) if mb else DEFAULT_FACTOR_BUDGET


@dataclasses.dataclass(frozen=True)
class FactorPlan:
    """The Cholesky-path decision for one (M, M) factorization.

    ``dense_bytes`` is what the in-core path keeps on the device;
    ``panel_bytes`` is the blocked path's working set model, two (M, block)
    panels; ``device_ceiling_bytes`` (3x that) is the bound its measured
    device peak must stay under.
    """

    path: str                  # one of FACTOR_PATHS
    M: int
    block: int | None          # (b, b) tile side for the blocked path
    itemsize: int              # bytes per element of the factor dtype
    dense_bytes: int           # M * M * itemsize — in-core factor residency
    panel_bytes: int           # 2 * block * M * itemsize — blocked working set
    factor_budget_bytes: int
    reason: str
    tile_dtype: str = "float32"   # policy ``cholesky`` override (fp32 floor)

    @property
    def device_ceiling_bytes(self) -> int:
        """3x the two-panel model: still O(b * M), never O(M^2)."""
        return 3 * self.panel_bytes


def plan_factor(M: int, *, itemsize: int = 4,
                policy: "PrecisionPolicy | None" = None, block: int | None = None,
                factor_budget: int | None = None) -> FactorPlan:
    """Pick in-core vs blocked Cholesky from a dense-factor budget model.

    The reference's arithmetic, field for field: in-core while
    ``M^2 * itemsize`` fits the budget, else blocked with ``block`` sized so
    two (M, block) panels fit it (multiples of 256, clamped to [256, 2048]).
    """
    if factor_budget is None:
        factor_budget = _factor_budget()
    tile_dtype = "float32"
    if policy is not None:
        tile_dtype = policy.buffer_dtype("cholesky")
        itemsize = max(_ITEMSIZE[tile_dtype], 4)  # fp32 floor
    dense = M * M * itemsize
    if block is None:
        block = factor_budget // max(2 * M * itemsize, 1)
        block = (block // _FACTOR_BLOCK_MIN) * _FACTOR_BLOCK_MIN
        block = max(_FACTOR_BLOCK_MIN, min(_FACTOR_BLOCK_MAX, block))
    panel = 2 * block * M * itemsize
    base = dict(M=M, itemsize=itemsize, dense_bytes=dense,
                factor_budget_bytes=factor_budget, tile_dtype=tile_dtype)
    if dense <= factor_budget:
        return FactorPlan(
            path="incore", block=None, panel_bytes=0,
            reason=(f"dense factor {dense}B fits the {factor_budget}B "
                    f"factor budget — in-core cholesky"),
            **base)
    return FactorPlan(
        path="blocked", block=block, panel_bytes=panel,
        reason=(f"dense factor {dense}B exceeds the {factor_budget}B factor "
                f"budget — blocked right-looking cholesky over "
                f"{-(-M // block)} panels of {block} columns "
                f"(device working set ~{panel}B)"),
        **base)


class FactorPlanWarning(UserWarning):
    """Structured notice that a factorization left the in-core path for the
    blocked out-of-core Cholesky. Carries the full ``FactorPlan`` as ``.plan``."""

    def __init__(self, plan: FactorPlan):
        self.plan = plan
        super().__init__(
            f"falkon preconditioner (M={plan.M}): taking the {plan.path!r} "
            f"factor path — {plan.reason}")


# ---------------------------------------------------------------------------
# K_nM cache planning: device-resident vs host-streamed vs recompute
# ---------------------------------------------------------------------------
CACHE_TIERS = ("device", "host", "off")

#: Default device-memory budget for a materialized K_nM, the reference's:
#: up to it the cache lives on the device ("device" tier); past it the tiles
#: stay on the host and stream through a ``StreamingLoader`` ("host" tier);
#: past ``REPRO_KNM_HOST_BUDGET_MB`` no cache is built ("off": the recompute
#: path). Override per process with ``REPRO_KNM_BUDGET_MB``.
DEFAULT_KNM_BUDGET = 1024 * 2**20
DEFAULT_KNM_HOST_BUDGET = 8192 * 2**20


def _knm_budget() -> int:
    mb = os.environ.get("REPRO_KNM_BUDGET_MB")
    return int(float(mb) * 2**20) if mb is not None else DEFAULT_KNM_BUDGET


def _knm_host_budget() -> int:
    mb = os.environ.get("REPRO_KNM_HOST_BUDGET_MB")
    return int(float(mb) * 2**20) if mb is not None else DEFAULT_KNM_HOST_BUDGET


@dataclasses.dataclass(frozen=True)
class CachePlan:
    """The K_nM-residency decision for one (n, M) problem, the reference's
    field for field. ``cache_bytes`` is the whole K_nM at the policy's
    storage width (a 16-bit policy halves it); ``shard_bytes`` is what one
    data shard holds, which the budgets are charged on."""

    tier: str                  # one of CACHE_TIERS
    n: int
    M: int
    shards: int                # data shards splitting the rows (1 = local)
    itemsize: int              # bytes per stored kernel entry
    cache_bytes: int           # n * M * itemsize — the full cache
    shard_bytes: int           # per-shard residency the budgets are charged on
    budget_bytes: int          # device budget
    host_budget_bytes: int     # host budget for the streamed tier
    reason: str
    storage_dtype: str = "float32"  # dtype the tiles are stored at


def plan_cache(n: int, M: int, *, itemsize: int = 4,
               policy: "PrecisionPolicy | None" = None, shards: int = 1,
               tier: str | None = None, budget: int | None = None,
               host_budget: int | None = None) -> CachePlan:
    """Pick the K_nM cache tier (device / host / off) from a bytes model.

    ``n * M * itemsize`` bytes at the policy's storage width (its
    ``overrides`` do not apply: the cache stores at the data-space storage
    type), charged per data shard. ``tier`` forces a tier; ``None`` routes
    device -> host -> off against the budgets (``REPRO_KNM_BUDGET_MB`` /
    ``REPRO_KNM_HOST_BUDGET_MB``). Pure arithmetic, the reference's.
    """
    if policy is not None:
        itemsize = policy.storage_itemsize
        storage_dtype = policy.storage
    else:
        storage_dtype = {8: "float64", 4: "float32", 2: "bfloat16"}.get(itemsize, "float32")
    if budget is None:
        budget = _knm_budget()
    if host_budget is None:
        host_budget = _knm_host_budget()
    shards = max(int(shards), 1)
    total = n * M * itemsize
    shard_bytes = -(-total // shards)
    base = dict(n=n, M=M, shards=shards, itemsize=itemsize, cache_bytes=total,
                shard_bytes=shard_bytes, budget_bytes=budget, host_budget_bytes=host_budget,
                storage_dtype=storage_dtype)
    if tier is not None:
        if tier not in CACHE_TIERS:
            raise ValueError(f"unknown cache tier {tier!r}; supported: {CACHE_TIERS}")
        return CachePlan(tier=tier, reason=f"tier {tier!r} forced by caller", **base)
    if shard_bytes <= budget:
        return CachePlan(
            tier="device",
            reason=(f"K_nM shard {shard_bytes}B fits the {budget}B device "
                    f"budget — device-resident cache"),
            **base)
    if shard_bytes <= host_budget:
        return CachePlan(
            tier="host",
            reason=(f"K_nM shard {shard_bytes}B exceeds the {budget}B device "
                    f"budget but fits the {host_budget}B host budget — "
                    f"host-pinned tiles, streamed sweeps"),
            **base)
    return CachePlan(
        tier="off",
        reason=(f"K_nM shard {shard_bytes}B exceeds the {host_budget}B host "
                f"budget — recompute path (no cache)"),
        **base)


class CachePlanWarning(UserWarning):
    """Structured notice that a requested K_nM cache routed off the device
    tier (host-streamed tiles, or no cache and the recompute path). Carries
    the full ``CachePlan`` as ``.plan``."""

    def __init__(self, plan: CachePlan):
        self.plan = plan
        super().__init__(
            f"falkon K_nM cache (n={plan.n}, M={plan.M}, "
            f"shards={plan.shards}): taking the {plan.tier!r} tier — "
            f"{plan.reason}")


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
        require_supported_policy(self.policy)

    @property
    def policy(self) -> PrecisionPolicy:
        """The resolved :class:`PrecisionPolicy` this backend runs under."""
        return resolve_precision(self.precision)


class CountingOps:
    """Invocation-counting facade over any :class:`KernelOps`.

    Pure delegation plus the counters ``sweeps``, ``applies``, ``grams`` and
    ``gram_tile_evals`` (kernel-entry evaluation work in units of
    ceil(rows / block_size) row tiles, charged by every primitive that
    evaluates kernel entries: ``sweep``, ``apply``, ``gram`` and the K_nM
    cache's ``materialize``), the cache's ``materializes``, ``gemm_sweeps``
    and ``gemm_applies`` (GEMMs over stored entries, which charge no tile
    evaluations), and ``sweep_shapes``, the set of (shape, dtype) of the X
    every sweep was given (a streamed fit's: one). PyTorch runs eagerly, so
    unlike the JAX facade these are executed-call counts: a fit's 20 CG
    iterations count 20 sweeps, not one traced program point.
    """

    def __init__(self, ops):
        self.ops = ops
        self.sweeps = 0
        self.applies = 0
        self.grams = 0
        self.gram_tile_evals = 0
        self.materializes = 0
        self.gemm_sweeps = 0
        self.gemm_applies = 0
        self.sweep_shapes: set[tuple[tuple[int, ...], torch.dtype]] = set()

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
        self.sweep_shapes.add((tuple(X.shape), X.dtype))
        return self.ops.sweep(X, C, u, v, row_mask)

    def apply(self, X, C, u):
        self.applies += 1
        self.gram_tile_evals += self._tiles(X.shape[0])
        return self.ops.apply(X, C, u)

    def gram(self, A, B):
        self.grams += 1
        self.gram_tile_evals += self._tiles(A.shape[0])
        return self.ops.gram(A, B)

    def materialize(self, X, C):
        # one kernel evaluation per row tile: the only K_nM entry
        # evaluation a cached fit performs
        self.materializes += 1
        self.gram_tile_evals += self._tiles(X.shape[0])
        return self.ops.materialize(X, C)

    def gemm_sweep(self, K, u, v=None, row_mask=None):
        self.gemm_sweeps += 1
        return self.ops.gemm_sweep(K, u, v, row_mask)

    def gemm_apply(self, K, u):
        self.gemm_applies += 1
        return self.ops.gemm_apply(K, u)

    def plan(self, n: int, M: int, d: int, p: int = 1, systems: int = 1) -> SweepPlan:
        return self.ops.plan(n, M, d, p, systems)

    def reset(self) -> None:
        self.sweeps = self.applies = self.grams = 0
        self.gram_tile_evals = 0
        self.materializes = self.gemm_sweeps = self.gemm_applies = 0
        self.sweep_shapes = set()
