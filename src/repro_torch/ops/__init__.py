"""The port's ``KernelOps`` layer: protocol, registry and the two backends.

Importing this package registers ``"torch"`` (plain blocked reference) and
``"cuda"`` (hand-written Hopper kernels) in this package's own registry.
"""
from .base import (
    FACTOR_PATHS,
    POLICIES,
    PRECISIONS,
    SWEEP_PATHS,
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
    plan_factor,
    plan_sweep,
    register_ops,
    resolve_precision,
)
from .cuda_backend import CudaKernelOps
from .torch_backend import TorchKernelOps

__all__ = [
    "FACTOR_PATHS", "POLICIES", "PRECISIONS", "SWEEP_PATHS", "CountingOps",
    "CudaKernelOps", "FactorPlan", "FactorPlanWarning", "KernelOps", "OpsBase",
    "PrecisionPolicy", "SweepPlan", "SweepPlanWarning", "TorchKernelOps",
    "available_ops", "get_ops", "plan_factor", "plan_sweep", "register_ops",
    "resolve_precision",
]
