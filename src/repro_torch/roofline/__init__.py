"""The roofline tools: per-device cost of a step counted op by op
(``op_cost``) and the roofline at the H100's constants (``analysis``).
Counterpart of ``repro.roofline``."""
from .analysis import (HBM_BW, HBM_BYTES, NVLINK_BW, PEAK_FLOPS, PEAK_FLOPS_FP32, Roofline,
                       analytic_memory, decode_model_flops, derive_roofline, memory_report,
                       train_model_flops)
from .op_cost import Memory, OpCost, analyze, analyze_with_result

__all__ = ["HBM_BW", "HBM_BYTES", "Memory", "NVLINK_BW", "OpCost", "PEAK_FLOPS",
           "PEAK_FLOPS_FP32", "Roofline", "analytic_memory", "analyze", "analyze_with_result",
           "decode_model_flops", "derive_roofline", "memory_report", "train_model_flops"]
