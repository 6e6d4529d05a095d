"""The port's ``KernelOps`` layer: protocol, registry, the two backends, the
materialized K_nM cache (``KernelCache``) and the data-parallel wrapper
(``DistributedOps``).

Importing this package registers ``"torch"`` (plain blocked reference) and
``"cuda"`` (hand-written Hopper kernels) in this package's own registry.
"""
from .base import (
    CACHE_TIERS,
    FACTOR_PATHS,
    POLICIES,
    PRECISIONS,
    SWEEP_PATHS,
    CachePlan,
    CachePlanWarning,
    CountingOps,
    FactorPlan,
    FactorPlanWarning,
    KernelOps,
    OpsBase,
    PrecisionPolicy,
    SweepPlan,
    SweepPlanWarning,
    available_ops,
    get_ops,
    plan_cache,
    plan_factor,
    plan_sweep,
    register_ops,
    resolve_precision,
)
from .cuda_backend import CudaKernelOps
from .distributed_backend import DistributedOps
from .knm_cache import KernelCache, data_shards
from .torch_backend import TorchKernelOps

__all__ = [
    "CACHE_TIERS", "FACTOR_PATHS", "POLICIES", "PRECISIONS", "SWEEP_PATHS", "CachePlan",
    "CachePlanWarning", "CountingOps", "CudaKernelOps", "DistributedOps", "FactorPlan",
    "FactorPlanWarning", "KernelCache", "KernelOps", "OpsBase", "PrecisionPolicy", "SweepPlan",
    "SweepPlanWarning", "TorchKernelOps", "available_ops", "data_shards", "get_ops",
    "plan_cache", "plan_factor", "plan_sweep", "register_ops", "resolve_precision",
]
