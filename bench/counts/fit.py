"""One whole FALKON fit with the FalkonConfig defaults (paper Alg. 1):
the Gram K_MM, the two Cholesky factorizations, the T T^T product and the
solve's sweeps: one right-hand side, t CG sweeps and, with the cond(W)
power iteration on, 2 x (12 + 1) more, each counted once at the needed
work. The triangular solves and the CG vector work are O(M^2) a sweep and
left out."""
from . import Cost, cholesky, gram, sweep, ttt

#: width-1 sweeps of the default cond(W) estimate: two power iterations
#: of 12 steps and one Rayleigh quotient each
COND_SWEEPS = 2 * (12 + 1)


def sweeps(iterations: int, estimate_cond: bool = True) -> int:
    return 1 + iterations + (COND_SWEEPS if estimate_cond else 0)


def cost(n: int, M: int, d: int, iterations: int, estimate_cond: bool = True) -> Cost:
    solve = sweep.cost(n, M, d, 1, with_v=False) * sweeps(iterations, estimate_cond)
    return gram.cost(M, d) + cholesky.cost(M) * 2 + ttt.cost(M) + solve
