"""A dense M x M Cholesky factorization: M^3 / 3 operations, the matrix
read and its triangular factor written once."""
from . import F32, Cost


def cost(M: int) -> Cost:
    return Cost(M ** 3 / 3, F32 * (M * M + M * (M + 1) // 2))
