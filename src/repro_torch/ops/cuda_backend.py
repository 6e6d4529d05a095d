"""``KernelOps`` backend over the hand-written Hopper kernels.

Counterpart of ``repro/ops/pallas_backend.py``:

* ``sweep`` — ONE launch of the CUDA sweep kernel (B1) per CG iteration.
  Its route, ``"two_eval"``, evaluates each Gram tile twice (forward pass,
  then transposed pass) and needs no row strip, so every M that fits the
  device takes it: this port has no out-of-core routing yet (ROADMAP A9).
* ``apply`` — the kernel matmul (B2); ``gram`` — the pairwise Gram (B3),
  held at float32 by the policy's ``gram`` override.

CUDA tensors run the kernels; CPU tensors run their plain twins (the same
wrappers decide, by device). Inputs are made contiguous here; the wrappers
refuse anything but float32.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.kernels import spec_of
from repro_torch.kernels import kernel_matvec as km

from .base import OpsBase, SweepPlan, register_ops

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
        """The one route of this backend, with its shared-memory figure."""
        systems = max(systems, 1)
        p = max(p, 1) * systems
        bm, bn = km.sweep_block_dims(n, M)
        smem, w_in_smem = km.sweep_smem_bytes(M, p)
        where = "shared memory" if w_in_smem else "a per-block global slice"
        return SweepPlan(
            path="two_eval", n=n, M=M, d=d, p=p, systems=systems,
            block_m=bm, block_n=bn, scratch_bytes=smem,
            reason=(f"CUDA sweep: persistent blocks walk {bm}-row blocks, "
                    f"each {bm}x{bn} tile evaluated twice; w partial in {where}"))

    def sweep(self, X: Tensor, C: Tensor, u: Tensor, v: Tensor | None = None,
              row_mask: Tensor | None = None) -> Tensor:
        """``row_mask`` (n,), 0/1: masked rows contribute EXACTLY zero (the
        kernel zeroes their t_i before the transposed pass)."""
        return km.fused_sweep(_c(X), _c(C), _c(u), _c(v), spec=self._spec,
                              row_mask=row_mask)

    def sweep_with_stats(self, X: Tensor, C: Tensor, u: Tensor,
                         v: Tensor | None = None) -> tuple[Tensor, Tensor]:
        """sweep() plus the kernel's Gram-tile evaluation counter (int32):
        ``2 * nbi * nbj`` (see ``kernel_matvec.sweep_tile_grid``)."""
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
