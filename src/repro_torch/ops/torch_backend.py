"""Reference ``KernelOps`` backend: plain blocked PyTorch, runs anywhere.

Counterpart of ``repro/ops/jnp_backend.py``. The sweep is the paper's Alg. 1
``KnM_times_vector``: a loop over row blocks of X, each step materializing
one (block, M) Gram strip, using it for both the forward product and the
transposed accumulation, then discarding it — O(M * block) memory, never
the full K_nM. It is the CPU path of the port and its own oracle; fp64
inputs stay fp64. Under a reduced-storage policy it quantizes as the
reference's ``"jnp"`` backend does: X, C and v rounded through the storage
type and computed in fp32, u at the coefficient type, and the row-block
reduction of the sweep two-summed when the policy is ``compensated``.
Over a materialized K_nM (``GemmCacheMixin``) the same strips give the same
sweep bit for bit under fp32.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.kernel_matvec import two_sum

from .base import (OpsBase, SweepPlan, _sweep_budget, quantize_coeffs, quantize_storage,
                   register_ops)
from .gemm import GemmCacheMixin

Tensor = torch.Tensor


def _pad_blocks(X: Tensor, v: Tensor | None, block_size: int,
                row_mask: Tensor | None = None):
    """Pad rows of X (and v) to a multiple of block_size; return the
    (nb, block, d) blocks, the (nb, block) validity mask and the padded v.

    ``row_mask`` (n,), 0/1 is folded into the block-padding mask, so masked
    rows drop out of the sweep exactly like the block padding does."""
    n, d = X.shape
    nb = -(-n // block_size)
    pad = nb * block_size - n
    Xp = torch.nn.functional.pad(X, (0, 0, 0, pad))
    valid = (torch.ones(n, dtype=X.dtype, device=X.device) if row_mask is None
             else row_mask.to(X.dtype))
    mask = torch.nn.functional.pad(valid, (0, pad))
    vp = None
    if v is not None:
        vp = torch.nn.functional.pad(v, (0, 0) * (v.ndim - 1) + (0, pad))
    return Xp.reshape(nb, block_size, d), mask.reshape(nb, block_size), vp, nb


@register_ops("torch")
@dataclasses.dataclass(frozen=True)
class TorchKernelOps(GemmCacheMixin, OpsBase):
    """Blocked row-scan reference implementation of the three primitives
    (and the K_nM cache's, ``GemmCacheMixin``)."""

    def _quant(self, a: Tensor | None) -> Tensor | None:
        """Storage quantization, fp32 compute (``base.quantize_storage``)."""
        return quantize_storage(self.policy, a)

    def _quant_coeffs(self, u: Tensor) -> Tensor:
        """u at the coefficient type (``base.quantize_coeffs``)."""
        return quantize_coeffs(self.policy, u)

    def _inputs(self, X: Tensor, C: Tensor) -> tuple[Tensor, Tensor]:
        return self._quant(X), self._quant(C)

    def sweep(self, X: Tensor, C: Tensor, u: Tensor, v: Tensor | None = None,
              row_mask: Tensor | None = None) -> Tensor:
        """K_nM^T (K_nM u + v) with blocked O(M * block) memory.

        ``u``: (M,) or (M, p); ``v``: (n,) or (n, p) or None (treated as 0).
        ``row_mask`` (n,), 0/1: rows with mask 0 contribute EXACTLY zero.
        Under a reduced-storage policy the inputs are quantized (X, C and v
        through the storage type, u at the coefficient type), the row-block
        reduction is two-summed when ``compensated``, and w comes back at
        the coefficient type.
        """
        pol = self.policy
        X, C = self._inputs(X, C)
        u, v = self._quant_coeffs(u), self._quant(v)
        bs = self.block_size
        Xb, mask, vp, nb = _pad_blocks(X, v, bs, row_mask)
        w = torch.zeros((C.shape[0],) + tuple(u.shape[1:]), dtype=X.dtype,
                        device=X.device)
        wc = torch.zeros_like(w) if pol.compensated else None
        for i in range(nb):
            mb = mask[i]
            Kb = self.kernel(Xb[i], C) * mb[:, None]          # mask padded rows
            t = Kb @ u
            if vp is not None:
                # Kb's zeroed rows already null padded contributions in
                # Kb.T @ t; masking v too keeps t finite for arbitrary pads.
                vb = vp[i * bs:(i + 1) * bs]
                t = t + vb * (mb[:, None] if vb.ndim > 1 else mb)
            if wc is None:
                w = w + Kb.T @ t
            else:   # the reference's _two_sum across row blocks
                w, wc = two_sum(w, wc, Kb.T @ t)
        co = pol.buffer_dtype("coeffs")
        return w if co == "float32" else w.to(getattr(torch, co))

    def apply(self, X: Tensor, C: Tensor, u: Tensor) -> Tensor:
        """K_nM u (prediction path), blocked over rows of X; the inputs
        quantized as in ``sweep``."""
        X, C = self._inputs(X, C)
        u = self._quant_coeffs(u)
        bs = self.block_size
        return torch.cat([self.kernel(X[i:i + bs], C) @ u
                          for i in range(0, X.shape[0], bs)], dim=0)

    def gram(self, A: Tensor, B: Tensor) -> Tensor:
        """K(A, B) dense, at least float32 (policy ``gram`` override; an
        fp64 input is never downcast)."""
        if A.dtype.itemsize < 4:
            A = A.float()
        if B.dtype.itemsize < 4:
            B = B.float()
        return self.kernel(A, B)

    def plan(self, n: int, M: int, d: int, p: int = 1, systems: int = 1) -> SweepPlan:
        """One path: the blocked row scan."""
        systems = max(systems, 1)
        p = max(p, 1) * systems
        pol = self.policy
        return SweepPlan(
            path="torch", n=n, M=M, d=d, p=p, systems=systems,
            block_m=self.block_size, block_n=M, shard_m=None,
            scratch_bytes=4 * self.block_size * M, io_bytes=0,
            workspace_budget_bytes=_sweep_budget(),
            input_dtype=pol.storage, vector_dtype=pol.storage,
            accum_dtype=pol.accumulate, coeffs_dtype=pol.buffer_dtype("coeffs"),
            compensated=pol.compensated,
            reason=(f"torch reference: loop over {self.block_size}-row "
                    f"blocks, O(block * M) live memory"))
