"""The CG sweep w = K(X,C)^T (K(X,C) u + v) (B1's work): every entry of
K(X, C) evaluated, and 4p operations an entry for the two products."""
from . import F32, Cost, kernel_entry_flops


def cost(n: int, M: int, d: int, p: int = 1, with_v: bool = False) -> Cost:
    entries = n * M
    flops = entries * (kernel_entry_flops(d) + 4 * p)
    nbytes = F32 * (n * d + M * d + M * p + M * p + (n * p if with_v else 0))
    return Cost(flops, nbytes)
