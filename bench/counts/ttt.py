"""T T^T of an upper-triangular M x M factor: the symmetric result's
M(M+1)/2 entries, each a dot product over the shared nonzeros, M^3 / 3
operations in all; the factor read once and the product written once."""
from . import F32, Cost


def cost(M: int) -> Cost:
    return Cost(M ** 3 / 3, F32 * (M * (M + 1) // 2 + M * M))
