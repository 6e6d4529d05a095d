"""Frozen operation and byte counts, and the H100 peaks they are held to.

These formulas are the benchmark's yardstick: each counts the work the
algorithm needs for one call at its shapes (every input byte read once,
every output byte written once), whatever an implementation does. The
least time of a call is ``max(flops / PEAK_FLOPS, bytes / PEAK_BYTES)``.

The peaks are the data sheet's for one H100 SXM at its 700 W limit: the
IEEE float32 rate outside the tensor cores (the port forbids TF32), and
HBM3 bandwidth. A card set below 700 W reads lower shares; the harness
prints the card's power limit beside every share.
"""
from __future__ import annotations

import dataclasses

#: IEEE float32 FLOP/s outside the tensor cores (data sheet: 67 TFLOP/s)
PEAK_FLOPS = 67e12
#: HBM3 bytes/s (data sheet: 3.35 TB/s)
PEAK_BYTES = 3.35e12
#: bytes of one float32
F32 = 4


@dataclasses.dataclass(frozen=True)
class Cost:
    """Operations and bytes of one call."""

    flops: float
    bytes: float

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(self.flops + other.flops, self.bytes + other.bytes)

    def __mul__(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.bytes * k)

    __rmul__ = __mul__

    @property
    def least_seconds(self) -> float:
        """The least time the card can take for this work."""
        return max(self.flops / PEAK_FLOPS, self.bytes / PEAK_BYTES)

    @property
    def bound_by(self) -> str:
        return "operations" if self.flops / PEAK_FLOPS >= self.bytes / PEAK_BYTES else "bytes"


def kernel_entry_flops(d: int) -> int:
    """Operations of one Gram entry from its (d)-wide rows: the dot product
    (2d) and the distance-to-kernel map (10, the kernel table's count)."""
    return 2 * d + 10
