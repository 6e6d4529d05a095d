"""The prediction K(X, C) u (B2's work): every entry of K(X, C) evaluated,
and 2p operations an entry for the product."""
from . import F32, Cost, kernel_entry_flops


def cost(n: int, M: int, d: int, p: int = 1) -> Cost:
    entries = n * M
    flops = entries * (kernel_entry_flops(d) + 2 * p)
    nbytes = F32 * (n * d + M * d + M * p + n * p)
    return Cost(flops, nbytes)
