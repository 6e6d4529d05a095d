"""The plain twins of the CUDA kernels B1-B3 against the Pallas kernels.

On the CPU each wrapper (``fused_sweep``, ``kernel_matmul``,
``pairwise_kernel``) runs its plain PyTorch twin; the JAX side runs
``fused_sweep_pallas`` / ``kernel_matmul_pallas`` / ``pairwise_kernel_pallas``
in interpret mode, as the JAX package's own tests do. Tolerance
rtol = atol = 1e-4, the ``TOL`` of tests/test_kernel_ops.py: fp32 with a
different summation order. The kernels themselves run only on the card
(``python3 chip_smoke.py`` holds them against these twins there).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernels as jk
from repro.kernels.kernel_matvec import (
    fused_sweep_pallas,
    kernel_matmul_pallas,
    pairwise_kernel_pallas,
    sharded_sweep_pallas,
)
from repro_torch.core import kernels as tk
from repro_torch.kernels import kernel_matvec as km
from repro_torch.ops import get_ops
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

KERNELS = [
    ("gaussian", dict(sigma=1.3)),
    ("laplacian", dict(sigma=1.1)),
    ("matern32", dict(sigma=1.7)),
    ("linear", dict(scale=1.5)),
    ("polynomial", dict(degree=2, c=0.5, scale=2.0)),
]
SHAPES = [(300, 97, 13), (37, 200, 5), (513, 129, 33)]
TOL = dict(rtol=1e-4, atol=1e-4)


def _data(n, M, d, p, seed):
    rng = np.random.default_rng(seed)
    cols = () if p is None else (p,)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(n, d), f(M, d), f(M, *cols), f(n, *cols)


def _specs(name, params):
    return jk.spec_of(jk.make_kernel(name, **params)), tk.make_kernel(name, **params).spec


T = torch.from_numpy
J = jnp.asarray


@pytest.fixture
def _one_thread():
    """One intra-op thread: the ragged-sweep twin is held to TOL, and beside
    the suite's other worker processes a first call on the default thread
    pool has been seen to miss it (by 1.7e-4) where one thread never has."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gaussian_sweep_f64(X, C, u, v, sigma):
    """K(X, C)^T (K(X, C) u + v) in float64 from direct differences."""
    X, C = X.astype(np.float64), C.astype(np.float64)
    K = np.exp(-((X[:, None] - C[None]) ** 2).sum(-1) / (2 * sigma * sigma))
    t = K @ u.astype(np.float64)
    return K.T @ (t if v is None else t + v)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("p", [None, 3])
def test_sweep_twin_matches_pallas_ragged(shape, p, _one_thread):
    """The twin against the Pallas kernel, and each of them against a float64
    oracle of the same inputs, so that a miss names its side."""
    n, M, d = shape
    X, C, u, v = _data(n, M, d, p, seed=SHAPES.index(shape))
    jspec, tspec = _specs("gaussian", dict(sigma=1.5))
    ref = fused_sweep_pallas(J(X), J(C), J(u), J(v), spec=jspec, interpret=True)
    got, count = km.fused_sweep(T(X), T(C), T(u), T(v), spec=tspec, return_tile_count=True)
    assert got.shape == tuple(ref.shape)
    exact = _gaussian_sweep_f64(X, C, u, v, 1.5)
    np.testing.assert_allclose(np.asarray(ref), exact, **TOL, err_msg="Pallas vs float64")
    np.testing.assert_allclose(got.numpy(), exact, **TOL, err_msg="twin vs float64")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    nbi, nbj = km.sweep_tile_grid(n, M)
    assert int(count) == 2 * nbi * nbj          # two evaluations per tile
    ref0 = fused_sweep_pallas(J(X), J(C), J(u), None, spec=jspec, interpret=True)
    got0 = km.fused_sweep(T(X), T(C), T(u), None, spec=tspec)
    exact0 = _gaussian_sweep_f64(X, C, u, None, 1.5)
    np.testing.assert_allclose(np.asarray(ref0), exact0, **TOL, err_msg="Pallas vs float64")
    np.testing.assert_allclose(got0.numpy(), exact0, **TOL, err_msg="twin vs float64")
    np.testing.assert_allclose(got0.numpy(), np.asarray(ref0), **TOL)


@pytest.mark.parametrize("name,params", KERNELS)
def test_all_kernels_sweep_apply_gram(name, params):
    n, M, d = 211, 77, 9
    X, C, u, v = _data(n, M, d, 3, seed=len(name))
    jspec, tspec = _specs(name, params)
    np.testing.assert_allclose(
        km.fused_sweep(T(X), T(C), T(u), T(v), spec=tspec).numpy(),
        np.asarray(fused_sweep_pallas(J(X), J(C), J(u), J(v), spec=jspec, interpret=True)),
        **TOL)
    np.testing.assert_allclose(
        km.kernel_matmul(T(X), T(C), T(u), spec=tspec).numpy(),
        np.asarray(kernel_matmul_pallas(J(X), J(C), J(u), spec=jspec, interpret=True)),
        **TOL)
    np.testing.assert_allclose(
        km.pairwise_kernel(T(X), T(C), spec=tspec).numpy(),
        np.asarray(pairwise_kernel_pallas(J(X), J(C), spec=jspec, interpret=True)),
        **TOL)


@pytest.mark.parametrize("p", [None, 3])
def test_matmul_add_matches_pallas(p):
    n, M, d = 150, 70, 6
    X, C, u, v = _data(n, M, d, p, seed=21)
    jspec, tspec = _specs("matern32", dict(sigma=1.2))
    u2, v2 = (u[:, None], v[:, None]) if p is None else (u, v)
    ref = kernel_matmul_pallas(J(X), J(C), J(u2), spec=jspec, add=J(v2), interpret=True)
    got = km.kernel_matmul(T(X), T(C), T(u), T(v), spec=tspec)
    np.testing.assert_allclose(got.numpy().reshape(ref.shape), np.asarray(ref), **TOL)


@pytest.mark.parametrize("p", [None, 3])
def test_row_mask_gives_exactly_the_prefix(p):
    """Masked rows contribute EXACTLY zero: junk rows under a 0 mask equal
    sweeping the valid prefix alone, bit for bit (with and without v)."""
    n, keep, M, d = 300, 260, 64, 7
    X, C, u, v = _data(n, M, d, p, seed=5)
    tspec = tk.make_kernel("gaussian", sigma=1.4).spec
    Xj = X.copy()
    Xj[keep:] = 123.0
    mask = torch.zeros(n)
    mask[:keep] = 1.0
    for vv, vp in ((T(v), T(v[:keep])), (None, None)):
        got = km.fused_sweep(T(Xj), T(C), T(u), vv, spec=tspec, row_mask=mask)
        want = km.fused_sweep(T(X[:keep]), T(C), T(u), vp, spec=tspec)
        assert torch.equal(got, want)
    # and the same against the Pallas kernel's masked sweep
    jspec = jk.spec_of(jk.make_kernel("gaussian", sigma=1.4))
    ref = fused_sweep_pallas(J(Xj), J(C), J(u), J(v), spec=jspec,
                             row_mask=jnp.asarray(mask.numpy()), interpret=True)
    np.testing.assert_allclose(
        km.fused_sweep(T(Xj), T(C), T(u), T(v), spec=tspec, row_mask=mask).numpy(),
        np.asarray(ref), **TOL)


def test_kernel_ops_and_dense_oracles():
    X, C, u, v = _data(120, 40, 4, None, seed=9)
    kern = tk.make_kernel("laplacian", sigma=1.2)
    w = kops.fused_knm_matvec(T(X), T(C), T(u), T(v), kern)
    np.testing.assert_allclose(
        w.numpy(), kref.fused_knm_matvec_ref(T(X), T(C), T(u), T(v), "laplacian", 1.2).numpy(),
        **TOL)
    np.testing.assert_allclose(
        kops.two_pass_knm_matvec(T(X), T(C), T(u), T(v), kern).numpy(), w.numpy(), **TOL)
    np.testing.assert_allclose(
        kops.kernel_matmul(T(X), T(C), T(u), kern).numpy(),
        kref.kernel_matmul_ref(T(X), T(C), T(u), "laplacian", 1.2).numpy(), **TOL)
    np.testing.assert_allclose(
        kops.pairwise_kernel(T(X), T(C), kern).numpy(),
        kref.pairwise_kernel_ref(T(X), T(C), "laplacian", 1.2).numpy(), **TOL)
    with pytest.raises(ValueError, match="sigma kernels"):
        kref.kernel_tile(T(X), T(C), "linear", 1.0)


def test_cpu_tensors_take_the_twin_and_count_no_launch():
    km.reset_launch_counts()
    X, C, u, v = _data(64, 32, 3, None, seed=2)
    spec = tk.make_kernel("gaussian").spec
    km.fused_sweep(T(X), T(C), T(u), T(v), spec=spec)
    km.kernel_matmul(T(X), T(C), T(u), spec=spec)
    km.pairwise_kernel(T(X), T(C), spec=spec)
    km.sharded_sweep(T(X), T(C), T(u), T(v), spec=spec, shard_m=16)
    assert km.launch_counts() == {
        "fused_sweep": 0, "sharded_sweep": 0, "kernel_matmul": 0, "pairwise_kernel": 0,
        "potrf_tile": 0, "trsm_panel": 0, "trailing_update": 0}
    with pytest.raises(ValueError, match="no kernel or plain path"):
        km.pairwise_kernel(T(X).to("meta"), T(C).to("meta"), spec=spec)


def test_kernel_operand_rules():
    """What the CUDA path refuses, checked without a card."""
    cpu = torch.device("cpu")
    with pytest.raises(NotImplementedError, match="A7"):
        km._check_operands("sweep", cpu, X=torch.zeros(4, 2, dtype=torch.float64))
    km._check_operands("sweep", cpu, X=torch.zeros(4, 2, dtype=torch.bfloat16))
    with pytest.raises(NotImplementedError, match="A7"):
        km._check_operands("gram", cpu, types=(torch.float32,),
                           X=torch.zeros(4, 2, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        km._check_operands("sweep", cpu, X=torch.zeros(4, 2).T)
    with pytest.raises(ValueError, match="at most 4"):
        km._pad_p(5)
    assert [km._pad_p(p) for p in (1, 2, 3, 4)] == [1, 4, 4, 4]
    with pytest.raises(NotImplementedError, match="A7"):
        km.kernel_matmul(torch.zeros(2, 2), torch.zeros(2, 2), torch.zeros(2),
                         spec=tk.make_kernel("gaussian").spec, out_dtype=torch.float8_e4m3fn)
    with pytest.raises(ValueError, match="no CUDA kernel map"):
        km._kparams(tk.KernelSpec("rbf"))


def test_sweep_tiling_and_shared_memory_plan():
    assert km.sweep_block_dims(10, 10) == (128, 128)
    assert km.sweep_tile_grid(4_000_000, 10_000) == (31_250, 79)
    # the main path (M = 10^4, d = 18, p = 1) keeps its w partial in shared
    # memory: C ring 2 x 18 k-rows, extras 2 x (1 + 1), X 18 x 132, t,
    # reduction 4 x 1, norms (x 128 floats each but X's padded rows)
    smem, in_smem = km.sweep_smem_bytes(10_000, 1, 18)
    base = 4 * (2 * 18 * 128 + 2 * 2 * 128 + 18 * 132 + 128 + 4 * 128 + 128)
    assert in_smem and smem == base + 4 * 10_000
    assert smem <= km.W_SMEM_LIMIT
    smem, in_smem = km.sweep_smem_bytes(100_000, 3, 18)
    assert not in_smem and smem == 4 * (2 * 18 * 128 + 2 * 5 * 128 + 18 * 132 + 4 * 128
                                        + 4 * 4 * 128 + 128)
    # the ring stays 32 k-rows deep and X resident up to d = 128
    assert km.sweep_smem_bytes(10**6, 1, 90)[0] == 4 * (2 * 32 * 128 + 2 * 2 * 128 + 90 * 132
                                                        + 128 + 4 * 128 + 128)
    assert km.sweep_smem_bytes(10**6, 1, 512)[0] == km.sweep_smem_bytes(10**6, 1, 128)[0]
    # the pairwise Gram's (B3) plan on the same tile (csrc/kernel_matvec.cu
    # pairwise_smem_floats): ring 2 x min(d, 32) k-rows, extras 2 x (1 + 1)
    # (||b||^2 and the zero row of u), A block min(d, 128) x 132, row norms;
    # two blocks an SM at both fits' depths
    assert km.pairwise_smem_bytes(18) == 4 * (2 * 18 * 128 + 2 * 2 * 128 + 18 * 132 + 128)
    assert km.pairwise_smem_bytes(90) == 4 * (2 * 32 * 128 + 2 * 2 * 128 + 90 * 132 + 128)
    assert km.pairwise_smem_bytes(512) == km.pairwise_smem_bytes(128)
    assert km.pairwise_grid_model(18) == km.pairwise_grid_model(90) == 264
    kind, sigma, coef, ss, c, degree = km._kparams(tk.make_kernel("gaussian", sigma=4.0).spec)
    assert (kind, sigma, coef) == (0, 4.0, -0.5 / 16.0)


# (m, n, d, S) of the kernel matmul (B2) at p = 1 on the modelled card's 264
# resident blocks: SUSY's predict fills the card without a split, the
# MillionSongs predict's second wave is short, and B4's transposed pass
# (C's 17,280-row shard against a 65,536-row chunk of X) has 135 row blocks
MATMUL_PLANS = [(500_000, 10_000, 18, 1), (51_630, 50_000, 90, 7), (17_280, 65_536, 90, 13)]


@pytest.mark.parametrize("m,n,d,S", MATMUL_PLANS)
def test_matmul_split_rule_and_shared_memory_plan(m, n, d, S):
    """B2's shared memory, resident blocks and slices, as the CUDA source
    plans them (``matmul_smem_floats``, the launch bounds, ``matmul_slices``)."""
    cr, xr = min(d, 32), min(d, 128)
    # ring 2 x cr k-rows, extras 2 x (1 + P), A block xr x 132, t's
    # cross-warp buffer P, row norms (x 128 floats each but A's padded rows)
    assert km.matmul_smem_bytes(1, d) == 4 * (2 * cr * 128 + 2 * 2 * 128 + xr * 132 + 128 + 128)
    assert km.matmul_smem_bytes(3, d) == 4 * (2 * cr * 128 + 2 * 5 * 128 + xr * 132 + 4 * 128
                                              + 128)
    slots = km.matmul_grid_model(1, d)
    assert slots == 264 and km.matmul_grid_model(4, d) == 132
    assert km.matmul_slices(m, n, slots) == S
    # the rule's cost, waves x (tiles a slice + 1), is least at S
    nbi, nbj = -(-m // 128), -(-n // 128)
    cost = lambda s: -(-nbi * s // slots) * (-(-nbj // s) + 1)
    assert all(cost(S) < cost(s) for s in range(1, S)) and all(
        cost(S) <= cost(s) for s in range(S, min(nbj, km.MM_MAX_SLICES) + 1))
    bounds = km.matmul_slice_bounds(n, S)
    assert bounds[0][0] == 0 and bounds[-1][1] == n and len(bounds) == S
    assert all(b1 == c0 and b1 % 128 == 0 for (_, b1), (c0, _) in zip(bounds, bounds[1:]))
    # one slots count forces the whole B axis into one slice, a large one
    # the most slices B's tiles allow
    assert km.matmul_slices(m, n, 1) == 1
    assert km.matmul_slices(m, n, 1 << 30) == min(nbj, km.MM_MAX_SLICES)


@pytest.mark.parametrize("m,n,d", [(150, 300, 6), (37, 513, 13), (129, 129, 129)])
@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("with_add", [False, True])
def test_matmul_sliced_schedule_matches_pallas(m, n, d, p, with_add):
    """B2's split schedule (slice partials summed in slice order, then
    ``add``) against the reference's kernel matmul in interpret mode, at
    ragged shapes and every slice count the B rows allow; TOL."""
    A, B, V, add = _data(m, n, d, p, seed=m + n + d + p)
    add = add if with_add else None
    jspec, tspec = _specs("gaussian", dict(sigma=float(np.sqrt(d))))
    ref = kernel_matmul_pallas(J(A), J(B), J(V), spec=jspec,
                               add=None if add is None else J(add), interpret=True)
    nbj = -(-n // 128)
    for slices in sorted({1, 2, nbj, km.matmul_slices(m, n, 264)}):
        if slices > nbj:
            continue
        got = km.kernel_matmul_sliced_plain(T(A), T(B), T(V), None if add is None else T(add),
                                            spec=tspec, slices=slices)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # one slice is the plain twin itself
    assert torch.equal(km.kernel_matmul_sliced_plain(T(A), T(B), T(V), spec=tspec, slices=1),
                       km.kernel_matmul_plain(T(A), T(B), T(V), spec=tspec))


# ---------------------------------------------------------------------------
# Right-hand sides wider than the kernels' 4 columns (the reference pads p to
# 128 lanes and takes any width): the wrappers split them into column groups
# of at most 4, one launch each, on the CPU as on the card.
# ---------------------------------------------------------------------------
WIDE = [5, 8, 17]


@pytest.mark.parametrize("p", WIDE)
def test_wide_rhs_backend_matches_pallas(p):
    """CudaKernelOps' sweep (B1) and apply (B2), and the sharded sweep (B4),
    at p > 4 against the reference's kernels in interpret mode; TOL."""
    n, M, d = 150, 70, 6
    X, C, u, v = _data(n, M, d, p, seed=30 + p)
    jspec, tspec = _specs("gaussian", dict(sigma=1.5))
    ops = get_ops("cuda", tk.make_kernel("gaussian", sigma=1.5))
    ref = fused_sweep_pallas(J(X), J(C), J(u), J(v), spec=jspec, interpret=True)
    got = ops.sweep(T(X), T(C), T(u), T(v))
    assert got.shape == (M, p)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    ref0 = fused_sweep_pallas(J(X), J(C), J(u), None, spec=jspec, interpret=True)
    np.testing.assert_allclose(ops.sweep(T(X), T(C), T(u)).numpy(), np.asarray(ref0), **TOL)
    refa = kernel_matmul_pallas(J(X), J(C), J(u), spec=jspec, interpret=True)
    np.testing.assert_allclose(ops.apply(T(X), T(C), T(u)).numpy(), np.asarray(refa), **TOL)
    refs = sharded_sweep_pallas(J(X), J(C), J(u), J(v), spec=jspec, shard_m=32)
    np.testing.assert_allclose(
        km.sharded_sweep(T(X), T(C), T(u), T(v), spec=tspec, shard_m=32).numpy(),
        np.asarray(refs), **TOL)


@pytest.mark.parametrize("p", WIDE)
def test_wide_rhs_groups_are_the_narrow_calls(p):
    """Each group of a wide call is exactly the call on its columns alone,
    masked junk rows still give exactly the valid prefix, and the matmul's
    ``add=`` splits with V."""
    n, keep, M, d = 200, 170, 60, 5
    X, C, u, v = _data(n, M, d, p, seed=p)
    spec = tk.make_kernel("matern32", sigma=1.3).spec
    w = km.fused_sweep(T(X), T(C), T(u), T(v), spec=spec)
    out = km.kernel_matmul(T(X), T(C), T(u), T(v), spec=spec)
    for g in km.column_groups(p):
        assert g.stop - g.start <= km.MAX_P
        assert torch.equal(w[:, g], km.fused_sweep(T(X), T(C), T(u[:, g].copy()),
                                                   T(v[:, g].copy()), spec=spec))
        assert torch.equal(out[:, g], km.kernel_matmul(T(X), T(C), T(u[:, g].copy()),
                                                       T(v[:, g].copy()), spec=spec))
    Xj = X.copy()
    Xj[keep:] = 123.0
    mask = torch.zeros(n)
    mask[:keep] = 1.0
    got = km.fused_sweep(T(Xj), T(C), T(u), T(v), spec=spec, row_mask=mask)
    assert torch.equal(got, km.fused_sweep(T(X[:keep]), T(C), T(u), T(v[:keep]), spec=spec))


def test_wide_rhs_tile_count_sums_the_groups():
    """p = 5 runs two groups (4 + 1): the tile counter reads 2 x 2 nbi nbj,
    on the wrapper and through CudaKernelOps.sweep_with_stats."""
    n, M, d, p = 300, 97, 7, 5
    X, C, u, v = _data(n, M, d, p, seed=4)
    spec = tk.make_kernel("gaussian", sigma=2.0).spec
    nbi, nbj = km.sweep_tile_grid(n, M)
    assert [(g.start, g.stop) for g in km.column_groups(p)] == [(0, 4), (4, 5)]
    _, count = km.fused_sweep(T(X), T(C), T(u), T(v), spec=spec, return_tile_count=True)
    assert int(count) == 2 * (2 * nbi * nbj)
    ops = get_ops("cuda", tk.make_kernel("gaussian", sigma=2.0))
    w, count = ops.sweep_with_stats(T(X), T(C), T(u), T(v))
    assert w.shape == (M, p) and int(count) == 2 * (2 * nbi * nbj)
    with pytest.raises(ValueError, match="at least one column"):
        km.column_groups(0)


def test_wide_rhs_plan_is_per_group():
    """CudaKernelOps.plan at width 17 (groups 4, 4, 4, 4, 1) charges one
    launch's workspace at the compiled width 4, as p = 4 does."""
    ops = get_ops("cuda", tk.make_kernel("gaussian", sigma=2.0))
    n, M, d = 4_000_000, 10_000, 18
    wide, four = ops.plan(n, M, d, 17), ops.plan(n, M, d, 4)
    assert (wide.path, wide.p) == ("fused", 17)
    assert wide.io_bytes == four.io_bytes
    assert wide.io_bytes == min(km.sweep_grid_model(M, 4, d), -(-n // wide.block_m)) * M * 4 * 4
    assert wide.scratch_bytes == km.sweep_smem_bytes(M, 4, d)[0]
    stacked = ops.plan(n, M, d, 3, systems=6)
    assert (stacked.p, stacked.systems, stacked.io_bytes) == (18, 6, four.io_bytes)


# ---------------------------------------------------------------------------
# The pairwise Gram (B3): a persistent grid over balanced ranges of output
# tiles, and a symmetric route for K(C, C) of one tensor.
# ---------------------------------------------------------------------------
# (m, n, symmetric) on the path: SUSY's and MillionSongs' K_MM, one K_nM-cache
# row block (65,536 rows against SUSY's centers), and the full grid at K_MM's
# shape (K(C, C.clone()))
PAIRWISE_PLANS = [(10_000, 10_000, True), (50_000, 50_000, True), (65_536, 10_000, False),
                  (10_000, 10_000, False)]


@pytest.mark.parametrize("m,n,sym", PAIRWISE_PLANS)
@pytest.mark.parametrize("G", [264, 7])
def test_pairwise_schedule_covers_each_tile_once(m, n, sym, G):
    """Every tile once (the upper ones once and, mirrored, the lower ones
    once on the symmetric route); ranges contiguous, in row-major order and
    balanced to within one tile; each range's first tile is its t0."""
    nbi, nbj = -(-m // 128), -(-n // 128)
    T = km.pairwise_tiles(m, n, sym)
    assert T == (nbi * (nbi + 1) // 2 if sym else nbi * nbj)
    order = [(bi, bj) for bi in range(nbi) for bj in range(bi if sym else 0, nbj)]
    assert len(order) == T
    walked, sizes, t_next = [], [], 0
    for b in range(G):
        t0, t1, bi, bj = km.pairwise_range(m, n, sym, G, b)
        assert t0 == t_next and (t1 == t0 or order[t0] == (bi, bj))
        tiles = km.pairwise_walk(m, n, sym, G, b)
        assert len(tiles) == t1 - t0
        walked += tiles
        sizes.append(t1 - t0)
        t_next = t1
    assert t_next == T and walked == order
    assert max(sizes) - min(sizes) <= 1
    if sym:
        stored = walked + [(bj, bi) for bi, bj in walked if bi != bj]
        assert sorted(stored) == [(bi, bj) for bi in range(nbi) for bj in range(nbj)]


def _scheduled_gram(A, B, spec, G):
    """K(A, B) filled tile by tile as the kernel's grid walks it (the
    symmetric route for one tensor: each upper tile also stored transposed);
    entries no block writes stay NaN."""
    m, n = A.shape[0], B.shape[0]
    sym = km.pairwise_symmetric(A, B)
    K = torch.full((m, n), float("nan"))
    G = min(G, km.pairwise_tiles(m, n, sym))   # as the launch caps its grid
    for b in range(G):
        for bi, bj in km.pairwise_walk(m, n, sym, G, b):
            r, c = slice(bi * 128, (bi + 1) * 128), slice(bj * 128, (bj + 1) * 128)
            K[r, c] = km.pairwise_kernel_plain(A[r], B[c], spec=spec)
            if sym and bi != bj:
                K[c, r] = K[r, c].T
    return K


def _assert_gram_close(got, ref, C, name, params):
    """TOL, but on the diagonal of a laplacian K(C, C): there each side's
    fp32 ||c||^2 + ||c||^2 - 2<c, c> leaves up to ~4 eps ||c||^2 of its own
    cancellation (its norm and dot product summed in other orders), which
    the laplacian's sqrt at distance 0 turns into sqrt(4 eps ||c||^2) / sigma
    a side."""
    off = ~np.eye(len(C), dtype=bool)
    np.testing.assert_allclose(got[off], ref[off], **TOL)
    slack = 0.0
    if name == "laplacian":
        eps = np.finfo(np.float32).eps / 2
        slack = 2 * np.sqrt(4 * eps * (C.astype(np.float64) ** 2).sum(1)) / params["sigma"]
    assert (np.abs(got.diagonal() - ref.diagonal())
            <= TOL["atol"] + TOL["rtol"] * np.abs(ref.diagonal()) + slack).all()


@pytest.mark.parametrize("name,params", KERNELS)
@pytest.mark.parametrize("M", [127, 129, 300])
def test_pairwise_symmetric_route_matches_pallas(name, params, M):
    """K(C, C) with one tensor passed twice (the fit's K_MM) through
    ``km.pairwise_kernel`` and ``CudaKernelOps.gram``, and filled as the
    kernel's symmetric schedule fills it (and its full one, for C and a
    copy), against the reference's pairwise kernel in interpret mode at
    ragged M around the 128 tile; TOL (see :func:`_assert_gram_close`)."""
    C = _data(M, 1, 7, None, seed=M)[0]
    jspec, tspec = _specs(name, params)
    ref = np.asarray(pairwise_kernel_pallas(J(C), J(C), spec=jspec, interpret=True))
    Ct = T(C)
    assert km.pairwise_symmetric(Ct, Ct) and not km.pairwise_symmetric(Ct, Ct.clone())
    ops = get_ops("cuda", tk.make_kernel(name, **params))
    for got in (km.pairwise_kernel(Ct, Ct, spec=tspec), ops.gram(Ct, Ct),
                _scheduled_gram(Ct, Ct, tspec, G=5), _scheduled_gram(Ct, Ct.clone(), tspec, G=5)):
        _assert_gram_close(got.numpy(), ref, C, name, params)


def test_gram_passes_one_tensor_twice(monkeypatch):
    """CudaKernelOps.gram hands the kernel one tensor for K(C, C), after its
    float32 widening and contiguity, so the fit's K_MM takes the symmetric
    route; two tensors stay two."""
    seen = []
    monkeypatch.setattr(km, "pairwise_kernel",
                        lambda A, B, spec: seen.append(km.pairwise_symmetric(A, B)))
    ops = get_ops("cuda", tk.make_kernel("gaussian"))
    C = T(_data(40, 1, 6, None, seed=3)[0])
    ops.gram(C, C)
    ops.gram(C.half(), C.half())
    Cn = C.T.contiguous().T             # not contiguous
    ops.gram(Cn, Cn)
    ops.gram(C, C.clone())
    assert seen == [True, False, True, False]
    half = C.half()
    ops.gram(half, half)
    assert seen[-1]

