"""``KernelOps`` backend over the hand-written Hopper kernels.

Counterpart of ``repro/ops/pallas_backend.py``:

* ``sweep`` — routed by :func:`repro_torch.ops.base.plan_sweep`:

  - ``fused`` — ONE launch of the CUDA sweep kernel (B1) per CG iteration,
    each Gram tile evaluated twice (forward pass, then transposed pass),
    its w partials in a device workspace of grid x M x P floats;
  - ``two_pass`` / ``j_sharded`` — past the workspace budget, the sharded
    sweep (B4): B2 launches with t spilled to device memory, per C-shard.
    Leaving the fused route emits a ``SweepPlanWarning``.
* ``apply`` — the kernel matmul (B2); ``gram`` — the pairwise Gram (B3),
  held at float32 by the policy's ``gram`` override.

CUDA tensors run the kernels; CPU tensors run their plain twins (the same
wrappers decide, by device). Inputs are made contiguous here; the wrappers
refuse anything but float32.
"""
from __future__ import annotations

import dataclasses
import warnings

import torch

from repro_torch.core.kernels import spec_of
from repro_torch.kernels import kernel_matvec as km

from .base import OpsBase, SweepPlan, SweepPlanWarning, plan_sweep, register_ops

Tensor = torch.Tensor


def _c(t: Tensor | None) -> Tensor | None:
    return None if t is None else t.contiguous()


@register_ops("cuda")
@dataclasses.dataclass(frozen=True)
class CudaKernelOps(OpsBase):
    """KernelOps over the CUDA kernels, keyed by the kernel's spec."""

    @property
    def _spec(self):
        return spec_of(self.kernel)

    def plan(self, n: int, M: int, d: int, p: int = 1, systems: int = 1) -> SweepPlan:
        """The route ``sweep`` takes for these shapes, from the Hopper
        workspace model (``REPRO_SWEEP_BUDGET_MB``)."""
        width = max(p, 1) * max(systems, 1)
        bm, bn = km.sweep_block_dims(n, M)
        smem, _ = km.sweep_smem_bytes(M, width)
        return plan_sweep(n, M, d, p, bm=bm, bn=bn, width=km._pad_p(width),
                          scratch_bytes=smem, grid=km.sweep_grid_model(M, width),
                          systems=systems, policy=self.policy)

    def sweep(self, X: Tensor, C: Tensor, u: Tensor, v: Tensor | None = None,
              row_mask: Tensor | None = None) -> Tensor:
        """``row_mask`` (n,), 0/1: masked rows contribute EXACTLY zero (B1
        zeroes their t_i before the transposed pass; B4 zeroes the spilled
        t rows)."""
        p = u.shape[1] if u.ndim > 1 else 1
        plan = self.plan(X.shape[0], C.shape[0], X.shape[1], p)
        if plan.path == "fused":
            return km.fused_sweep(_c(X), _c(C), _c(u), _c(v), spec=self._spec,
                                  row_mask=row_mask)
        warnings.warn(SweepPlanWarning(plan), stacklevel=2)
        return km.sharded_sweep(_c(X), _c(C), _c(u), _c(v), spec=self._spec,
                                row_mask=row_mask, shard_m=plan.shard_m or plan.M)

    def sweep_with_stats(self, X: Tensor, C: Tensor, u: Tensor,
                         v: Tensor | None = None) -> tuple[Tensor, Tensor]:
        """sweep() plus the kernel's Gram-tile evaluation counter (int32):
        ``2 * nbi * nbj`` (see ``kernel_matvec.sweep_tile_grid``). Only the
        fused kernel counts tiles, so shapes planned off the fused route are
        refused rather than measured on another path."""
        p = u.shape[1] if u.ndim > 1 else 1
        plan = self.plan(X.shape[0], C.shape[0], X.shape[1], p)
        if plan.path != "fused":
            raise ValueError(
                f"fused sweep workspace for n={X.shape[0]}, M={C.shape[0]}, "
                f"d={X.shape[1]}, p={p} exceeds the device workspace budget "
                f"({plan.reason}); sweep() would take the {plan.path!r} path, "
                "which has no tile counter")
        return km.fused_sweep(_c(X), _c(C), _c(u), _c(v), spec=self._spec,
                              return_tile_count=True)

    def apply(self, X: Tensor, C: Tensor, u: Tensor) -> Tensor:
        return km.kernel_matmul(_c(X), _c(C), _c(u), spec=self._spec)

    def gram(self, A: Tensor, B: Tensor) -> Tensor:
        # Per-buffer override: gram feeds the preconditioner's Cholesky and
        # stays float32 (a narrower input is widened, never the reverse).
        if A.dtype.itemsize < 4:
            A = A.float()
        if B.dtype.itemsize < 4:
            B = B.float()
        return km.pairwise_kernel(_c(A), _c(B), spec=self._spec)
