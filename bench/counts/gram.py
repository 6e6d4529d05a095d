"""K(C, C) of one M x d tensor (B3's work in a fit): the M(M+1)/2 distinct
entries evaluated, the input read once and the full M x M output written."""
from . import F32, Cost, kernel_entry_flops


def cost(M: int, d: int) -> Cost:
    flops = (M * (M + 1) // 2) * kernel_entry_flops(d)
    nbytes = F32 * (M * d + M * M)
    return Cost(flops, nbytes)
