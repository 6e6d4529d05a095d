"""``KernelOps`` backend over the hand-written Hopper kernels.

Counterpart of ``repro/ops/pallas_backend.py``:

* ``sweep`` — routed by :func:`repro_torch.ops.base.plan_sweep`:

  - ``fused`` — the CUDA sweep (B1: its center prologue, the sweep kernel,
    the partial sum) per CG iteration and column group, each Gram tile
    evaluated twice (forward pass, then transposed pass), its w partials in
    a device workspace of grid x M x P floats;
  - ``two_pass`` / ``j_sharded`` — past the workspace budget, the sharded
    sweep (B4): B2 launches with t spilled to device memory, per C-shard.
    Leaving the fused route emits a ``SweepPlanWarning``.
* ``apply`` — the kernel matmul (B2); ``gram`` — the pairwise Gram (B3),
  held at float32 by the policy's ``gram`` override.
* ``materialize`` / ``gemm_sweep`` / ``gemm_apply`` — the K_nM cache
  (``GemmCacheMixin``): one B3 launch per row tile, written straight into
  its row slice of the fp32 cache (a 16-bit cache takes a rounded copy of
  each tile), then IEEE-fp32 cuBLAS GEMMs over the stored entries.

Under a reduced-storage policy (after the reference's ``_inputs`` and
``_vectors``) X, C and v are cast to the storage type (a tensor already at
it is passed as it is, so a solve that quantized X once never casts it
again), u is widened to the coefficient type, the kernels run their
compensated variants when the policy says so, and B4 spills t at the
storage type and returns w at the coefficient type. ``gram`` stays float32.

CUDA tensors run the kernels; CPU tensors run their plain twins (the same
wrappers decide, by device). Inputs are made contiguous here; the wrappers
take float32, bfloat16 and float16.
"""
from __future__ import annotations

import dataclasses
import warnings

import torch

from repro_torch.core.kernels import spec_of
from repro_torch.kernels import kernel_matvec as km

from .base import OpsBase, SweepPlan, SweepPlanWarning, plan_sweep, register_ops
from .gemm import GemmCacheMixin

Tensor = torch.Tensor


def _c(t: Tensor | None) -> Tensor | None:
    return None if t is None else t.contiguous()


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


@register_ops("cuda")
@dataclasses.dataclass(frozen=True)
class CudaKernelOps(GemmCacheMixin, OpsBase):
    """KernelOps over the CUDA kernels, keyed by the kernel's spec."""

    @property
    def _spec(self):
        return spec_of(self.kernel)

    def _inputs(self, X: Tensor, C: Tensor) -> tuple[Tensor, Tensor]:
        """X and C at the storage type (float32 storage: as they are)."""
        if self.policy.storage == "float32":
            return _c(X), _c(C)
        st = _dtype(self.policy.storage)
        return _c(X.to(st)), _c(C.to(st))

    def _vectors(self, u: Tensor, v: Tensor | None) -> tuple[Tensor, Tensor | None]:
        """u at the coefficient type (a narrower u is widened, never the
        reverse), v at the storage type."""
        pol = self.policy
        if pol.storage != "float32" and v is not None:
            v = v.to(_dtype(pol.storage))
        co = _dtype(pol.buffer_dtype("coeffs"))
        if u.dtype != co and (co != torch.float32 or u.dtype.itemsize < co.itemsize):
            u = u.to(co)
        return _c(u), _c(v)

    def plan(self, n: int, M: int, d: int, p: int = 1, systems: int = 1) -> SweepPlan:
        """The route ``sweep`` takes for these shapes, from the Hopper
        workspace model (``REPRO_SWEEP_BUDGET_MB``). A block wider than
        ``km.MAX_P`` columns runs one launch per column group, each with its
        own w-partial workspace, so it is planned at its widest group."""
        width = max(p, 1) * max(systems, 1)
        group = min(width, km.MAX_P)
        bm, bn = km.sweep_block_dims(n, M)
        comp = self.policy.compensated
        smem, _ = km.sweep_smem_bytes(M, group, d, comp)
        return plan_sweep(n, M, d, p, bm=bm, bn=bn, width=km._pad_p(group),
                          scratch_bytes=smem, grid=km.sweep_grid_model(M, group, d, comp),
                          systems=systems, policy=self.policy)

    def sweep(self, X: Tensor, C: Tensor, u: Tensor, v: Tensor | None = None,
              row_mask: Tensor | None = None) -> Tensor:
        """``row_mask`` (n,), 0/1: masked rows contribute EXACTLY zero (B1
        zeroes their t_i before the transposed pass; B4 zeroes the spilled
        t rows)."""
        pol = self.policy
        X, C = self._inputs(X, C)
        u, v = self._vectors(u, v)
        p = u.shape[1] if u.ndim > 1 else 1
        plan = self.plan(X.shape[0], C.shape[0], X.shape[1], p)
        if plan.path == "fused":
            return km.fused_sweep(X, C, u, v, spec=self._spec, row_mask=row_mask,
                                  compensated=pol.compensated)
        warnings.warn(SweepPlanWarning(plan), stacklevel=2)
        # a reduced-storage policy spills t at storage width and returns w
        # at the coefficient type; float32 keeps the types' promotion
        t_dt = out_dt = None
        if pol.storage != "float32":
            t_dt, out_dt = _dtype(pol.storage), _dtype(pol.buffer_dtype("coeffs"))
        return km.sharded_sweep(X, C, u, v, spec=self._spec, row_mask=row_mask,
                                shard_m=plan.shard_m or plan.M, compensated=pol.compensated,
                                t_dtype=t_dt, out_dtype=out_dt)

    def sweep_with_stats(self, X: Tensor, C: Tensor, u: Tensor,
                         v: Tensor | None = None) -> tuple[Tensor, Tensor]:
        """sweep() plus the kernel's Gram-tile evaluation counter (int32):
        ``2 * nbi * nbj`` per column group, summed over the groups (see
        ``kernel_matvec.sweep_tile_grid``, ``column_groups``). Only the
        fused kernel counts tiles, so shapes planned off the fused route are
        refused rather than measured on another path."""
        X, C = self._inputs(X, C)
        u, v = self._vectors(u, v)
        p = u.shape[1] if u.ndim > 1 else 1
        plan = self.plan(X.shape[0], C.shape[0], X.shape[1], p)
        if plan.path != "fused":
            raise ValueError(
                f"fused sweep workspace for n={X.shape[0]}, M={C.shape[0]}, "
                f"d={X.shape[1]}, p={p} exceeds the device workspace budget "
                f"({plan.reason}); sweep() would take the {plan.path!r} path, "
                "which has no tile counter")
        return km.fused_sweep(X, C, u, v, spec=self._spec, return_tile_count=True,
                              compensated=self.policy.compensated)

    def apply(self, X: Tensor, C: Tensor, u: Tensor) -> Tensor:
        """K(X, C) u on B2: X and C at storage, u at the coefficient type,
        the result at their promotion (float32 under the bf16 policy)."""
        X, C = self._inputs(X, C)
        u, _ = self._vectors(u, None)
        return km.kernel_matmul(X, C, u, spec=self._spec, compensated=self.policy.compensated)

    def gram(self, A: Tensor, B: Tensor) -> Tensor:
        # Per-buffer override: gram feeds the preconditioner's Cholesky and
        # stays float32 (a narrower input is widened, never the reverse).
        # One tensor passed twice stays one, so K(C, C) takes the kernel's
        # symmetric route.
        same = B is A
        A = _c(A.float() if A.dtype.itemsize < 4 else A)
        B = A if same else _c(B.float() if B.dtype.itemsize < 4 else B)
        return km.pairwise_kernel(A, B, spec=self._spec)

    def _gram_into(self, A: Tensor, B: Tensor, out: Tensor) -> None:
        """One B3 launch writing K(A, B) into ``out``: in place when ``out``
        is float32, else through a float32 tile rounded into it."""
        if out.dtype != torch.float32:
            out.copy_(self.gram(A, B))
            return
        A = _c(A.float() if A.dtype.itemsize < 4 else A)
        B = _c(B.float() if B.dtype.itemsize < 4 else B)
        km.pairwise_kernel(A, B, spec=self._spec, out=out)
