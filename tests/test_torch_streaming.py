"""The port's host-streamed fits (``repro_torch.data.streaming``,
``falkon_fit_streaming``, ``falkon_fit_path_streaming``,
``FalkonEstimator.predict_stream``) against the JAX package's.

The chunk sources are numpy in both packages and are held equal chunk by
chunk, bit for bit. Centers cannot share a seed across frameworks, so the
fits run on the reference's centers, and the center draw is held by its
indices from the seed the reference derives from its key. The reference
runs on its "jnp" backend (its "pallas" backend in interpret mode at n <=
512, M <= 64). Errors are normwise relative; fp32 bounds are the worst case
measured on a CPU with ~3x headroom (both packages round fp32 sums in
different orders); in float64 the streamed fit is the in-core solve.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FalkonConfig as JConfig
from repro.core import GaussianKernel as JGaussian
from repro.core import falkon_fit_path_streaming as jfit_path_streaming
from repro.core import falkon_fit_streaming as jfit_streaming
from repro.data import ArrayChunkSource as JArraySource
from repro.data import ShardedChunkSource as JShardedSource
from repro.data import ShuffledChunkSource as JShuffledSource
from repro.data import StreamingLoader as JLoader
from repro.data import streaming_apply as jstreaming_apply
from repro.data import streaming_sweep as jstreaming_sweep
from repro.data import streaming_uniform_centers as jstreaming_centers
from repro.ops import get_ops as jget_ops
from repro_torch.core import (
    FalkonConfig,
    falkon_fit,
    falkon_fit_path_streaming,
    falkon_fit_streaming,
    falkon_solve,
    make_kernel,
    streaming_knm_apply,
    streaming_knm_matvec,
)
from repro_torch.data import (
    ArrayChunkSource,
    ShardedChunkSource,
    ShuffledChunkSource,
    StreamingLoader,
    default_prefetch,
    shard_chunk_sources,
    streaming_apply,
    streaming_sweep,
    streaming_uniform_centers,
)
from repro_torch.data.streaming import _uniform_indices
from repro_torch.ops import CountingOps, get_ops

N, D, M, CHUNK, SIGMA = 1000, 6, 64, 300, 2.0
#: the streamed sweep and apply against the reference's (fp32, other
#: summation orders; measured <= 2.0e-7 on the "jnp" and "pallas" backends)
SWEEP_TOL = 1e-6
#: the streamed fits against the reference's on its centers, lam = 1e-3,
#: over three center draws: fp32 alpha, residual history and predictions
#: (measured <= 1.03e-4, 3.8e-6 and 9.8e-5); bf16 the policy's documented
#: 1e-2 (measured <= 5.9e-3, 2.5e-3 and 6.9e-3: the CG iterates round at
#: 2^-8 in both packages)
FIT_TOL = {"fp32": dict(alpha=3e-4, res=1.5e-5, pred=3e-4),
           "bf16": dict(alpha=1e-2, res=1e-2, pred=1e-2)}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for each test: its tensors are small, and beside
    the suite's other worker processes more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _problem(n=N, p=None, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, D)).astype(np.float32)
    W = rng.standard_normal((D, p or 1))
    Y = (np.sin(X @ W) + 0.05 * rng.standard_normal((n, p or 1))).astype(np.float32)
    return X, Y[:, 0] if p is None else Y


def _chunks_equal(got, ref):
    got, ref = list(got), list(ref)
    assert len(got) == len(ref)
    for (gx, gy), (rx, ry) in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(gx), np.asarray(rx))
        assert (gy is None) == (ry is None)
        if gy is not None:
            np.testing.assert_array_equal(np.asarray(gy), np.asarray(ry))


def _cfg(cls, **kw):
    base = dict(kernel="gaussian", kernel_params=(("sigma", SIGMA),), lam=1e-3, num_centers=M,
                iterations=12, block_size=128)
    return cls(**{**base, **kw})


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------
def test_array_and_sharded_sources_match_reference():
    """The ragged tail, (chunk, None) without targets, the refusals, and
    every shard's row range and chunks for shard counts that divide n and
    that do not (the last shard short or empty)."""
    X, y = _problem()
    src, ref = ArrayChunkSource(X, y, chunk_rows=CHUNK), JArraySource(X, y, chunk_rows=CHUNK)
    assert src.num_chunks == ref.num_chunks == 4
    assert [c[0].shape[0] for c in src.chunks()] == [300, 300, 300, 100]
    _chunks_equal(src.chunks(), ref.chunks())
    assert next(iter(ArrayChunkSource(X, chunk_rows=256).chunks()))[1] is None
    with pytest.raises(ValueError, match="chunk_rows"):
        ArrayChunkSource(X, y, chunk_rows=0)
    with pytest.raises(ValueError, match="rows"):
        ArrayChunkSource(X, y[:10])
    for shards in (1, 3, 4, 7, 1001):
        got = shard_chunk_sources(src, shards)
        for i, g in enumerate(got):
            r = JShardedSource(ref, i, shards)
            assert (g.row_start, g.row_stop, g.n_rows, g.chunk_rows) == \
                (r.row_start, r.row_stop, r.n_rows, r.chunk_rows)
            _chunks_equal(g.chunks(), r.chunks())
        np.testing.assert_array_equal(
            np.concatenate([c[0] for g in got for c in g.chunks()]), X)
    for bad in ((0, 0), (-1, 2), (2, 2)):
        with pytest.raises(ValueError):
            ShardedChunkSource(src, *bad)


@pytest.mark.parametrize("buffer_chunks,shuffle_rows", [(2, True), (8, True), (1, False)])
def test_shuffled_source_replays_reference_order(buffer_chunks, shuffle_rows):
    """The windowed shuffle draws the reference's permutations bit for bit,
    pass after pass (the pass counter folded into the seed), over a ragged
    parent; every pass is a permutation of the rows."""
    X, y = _problem()
    kw = dict(seed=5, buffer_chunks=buffer_chunks, shuffle_rows=shuffle_rows)
    got = ShuffledChunkSource(ArrayChunkSource(X, y, chunk_rows=128), **kw)
    ref = JShuffledSource(JArraySource(X, y, chunk_rows=128), **kw)
    passes = []
    for _ in range(3):
        chunks = list(got.chunks())
        _chunks_equal(chunks, ref.chunks())
        passes.append(np.concatenate([c[1] for c in chunks]))
        assert sorted(passes[-1].tolist()) == sorted(y.tolist())
    assert not np.array_equal(passes[0], passes[1])
    with pytest.raises(ValueError):
        ShuffledChunkSource(ArrayChunkSource(X), buffer_chunks=0)


# ---------------------------------------------------------------------------
# The loader (on the CPU: its thread and queue without streams or pinning)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("prefetch", [0, 2])
def test_loader_order_reiteration_targets_and_dtype(prefetch):
    X, y = _problem(n=700)
    src = ArrayChunkSource(X, y, chunk_rows=256)
    loader = StreamingLoader(src, device="cpu", prefetch=prefetch)
    assert (loader.n_rows, loader.dim, loader.chunk_rows) == (700, D, 256)
    for _ in range(2):   # re-iterable: two full passes
        got = list(loader)
        assert [xc.shape[0] for xc, _ in got] == [256, 256, 188]
        np.testing.assert_array_equal(torch.cat([xc for xc, _ in got]).numpy(), X)
        np.testing.assert_array_equal(torch.cat([yc for _, yc in got]).numpy(), y)
    assert all(yc is None for _, yc in loader.iter_chunks(with_targets=False))
    bf = list(StreamingLoader(src, device="cpu", prefetch=prefetch, dtype=torch.bfloat16))
    assert all(xc.dtype == yc.dtype == torch.bfloat16 for xc, yc in bf)
    assert torch.equal(torch.cat([xc for xc, _ in bf]), torch.from_numpy(X).to(torch.bfloat16))
    # a chunk is a fresh tensor: the source's arrays are never aliased
    xc, _ = next(iter(loader))
    xc.zero_()
    assert np.abs(X[:256]).sum() > 0


@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_loader_errors_and_early_break(prefetch):
    """A source error reaches the consumer; an early break stops the
    producer thread, and the loader iterates whole again afterwards."""
    X, y = _problem(n=900)

    class Boom(ArrayChunkSource):
        def chunks(self):
            yield from super().chunks()
            raise RuntimeError("disk on fire")

    with pytest.raises(RuntimeError, match="disk on fire"):
        list(StreamingLoader(Boom(X, y, chunk_rows=128), device="cpu", prefetch=prefetch))
    loader = StreamingLoader(ArrayChunkSource(X, y, chunk_rows=64), device="cpu",
                             prefetch=prefetch)
    it = iter(loader)
    next(it)
    it.close()
    alive = [t for t in threading.enumerate() if t.name == "StreamingLoader" and t.is_alive()]
    assert not alive
    assert sum(xc.shape[0] for xc, _ in loader) == 900
    with pytest.raises(ValueError, match="prefetch"):
        StreamingLoader(ArrayChunkSource(X), device="cpu", prefetch=-1)


def test_loader_defaults_to_the_card():
    assert (default_prefetch("cpu"), default_prefetch("cuda")) == (0, 2)
    src = ArrayChunkSource(_problem()[0])
    assert StreamingLoader(src, device="cpu").prefetch == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            StreamingLoader(src)


# ---------------------------------------------------------------------------
# Streamed sweep and apply
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("p", [None, 3])
def test_streamed_sweep_and_apply_match_reference(impl, p):
    """With and without v, p = None and 3, ragged tail: against the
    reference's streamed sweep and apply on its "jnp" backend; and against
    the port's own in-core sweep in float64 (the chunked sum is the in-core
    sum, rounding aside)."""
    X, Y = _problem(p=p)
    rng = np.random.default_rng(4)
    u = rng.standard_normal((M,) if p is None else (M, p)).astype(np.float32)
    C = X[:M]
    kern = make_kernel("gaussian", sigma=SIGMA)
    ops = get_ops(impl, kern, block_size=128)
    jops = jget_ops("jnp", JGaussian(sigma=SIGMA), block_size=128)
    loader = StreamingLoader(ArrayChunkSource(X, Y, chunk_rows=CHUNK), device="cpu")
    jloader = JLoader(JArraySource(X, Y, chunk_rows=CHUNK), prefetch=0)
    Ct, ut = torch.from_numpy(C), torch.from_numpy(u)
    for targets in (True, False):
        got = streaming_sweep(ops, loader, Ct, ut, use_targets=targets)
        ref = jstreaming_sweep(jops, jloader, jnp.asarray(C), jnp.asarray(u), use_targets=targets)
        assert got.shape == ut.shape and rel(got, ref) < SWEEP_TOL
    got_a = streaming_apply(ops, loader, Ct, ut)
    assert rel(got_a, jstreaming_apply(jops, jloader, jnp.asarray(C), jnp.asarray(u))) < SWEEP_TOL
    # float64: the streamed sweep is the in-core sweep
    l64 = StreamingLoader(ArrayChunkSource(X, Y, chunk_rows=CHUNK), device="cpu",
                          dtype=torch.float64)
    C64, u64 = Ct.double(), ut.double()
    X64, Y64 = torch.from_numpy(X).double(), torch.from_numpy(Y).double()
    assert rel(streaming_sweep(ops, l64, C64, u64), ops.sweep(X64, C64, u64, Y64)) < 1e-12
    assert rel(streaming_sweep(ops, l64, C64, u64, use_targets=False),
               ops.sweep(X64, C64, u64, None)) < 1e-12
    assert rel(streaming_apply(ops, l64, C64, u64), ops.apply(X64, C64, u64)) < 1e-12


def test_streamed_sweep_matches_pallas_reference():
    """At n <= 512, M <= 64, the reference's "pallas" backend in interpret
    mode, and the delegates ``streaming_knm_matvec`` / ``_apply``."""
    X, y = _problem(n=500)
    u = np.random.default_rng(6).standard_normal(M).astype(np.float32)
    C = X[:M]
    jops = jget_ops("pallas", JGaussian(sigma=SIGMA), block_size=128)
    jloader = JLoader(JArraySource(X, y, chunk_rows=200), prefetch=0)
    ref = jstreaming_sweep(jops, jloader, jnp.asarray(C), jnp.asarray(u), use_targets=True)
    ref_a = jstreaming_apply(jops, jloader, jnp.asarray(C), jnp.asarray(u))
    loader = StreamingLoader(ArrayChunkSource(X, y, chunk_rows=200), device="cpu", prefetch=2)
    kern = make_kernel("gaussian", sigma=SIGMA)
    Ct, ut = torch.from_numpy(C), torch.from_numpy(u)
    got = streaming_knm_matvec(loader, Ct, ut, kern, use_targets=True, block_size=128)
    assert rel(got, ref) < SWEEP_TOL
    assert rel(streaming_knm_apply(loader, Ct, ut, kern, impl="torch"), ref_a) < SWEEP_TOL


def test_one_chunk_shape_and_tail_mask():
    """Every chunk sweep sees one X shape (the ragged tail padded, its pad
    rows masked out exactly): recorded by ``CountingOps`` over passes; the
    padded stream equals the unpadded one bit for bit on the plain backend."""
    X, y = _problem()
    kern = make_kernel("gaussian", sigma=SIGMA)
    cnt = CountingOps(get_ops("cuda", kern, block_size=128))
    loader = StreamingLoader(ArrayChunkSource(X, y, chunk_rows=CHUNK), device="cpu")
    u = torch.from_numpy(np.random.default_rng(1).standard_normal(M).astype(np.float32))
    C = torch.from_numpy(X[:M])
    for _ in range(3):
        streaming_sweep(cnt, loader, C, u, use_targets=False)
    assert cnt.sweeps == 12 and cnt.sweep_shapes == {((CHUNK, D), torch.float32)}
    ops = get_ops("torch", kern, block_size=100)
    assert torch.equal(streaming_sweep(ops, loader, C, u),
                       streaming_sweep(ops, loader, C, u, pad_ragged=False))
    with pytest.raises(ValueError, match="targets"):
        streaming_sweep(ops, StreamingLoader(ArrayChunkSource(X, chunk_rows=CHUNK),
                                             device="cpu"), C, u)


def test_center_indices_from_the_reference_seed():
    """``_uniform_indices`` from the seed the reference derives from its key
    gives the reference's indices; the streamed draw gathers exactly those
    rows, distinct, whatever the chunking."""
    X, y = _problem(n=500)
    key = jax.random.PRNGKey(3)
    ref_c, ref_idx = jstreaming_centers(key, JArraySource(X, y, chunk_rows=128), 40)
    seed = int(jax.random.randint(key, (), 0, np.iinfo(np.int32).max))
    np.testing.assert_array_equal(_uniform_indices(seed, 500, 40), ref_idx)
    g = torch.Generator().manual_seed(0)
    c1, i1 = streaming_uniform_centers(g, ArrayChunkSource(X, y, chunk_rows=128), 40)
    g = torch.Generator().manual_seed(0)
    c2, i2 = streaming_uniform_centers(g, ArrayChunkSource(X, y, chunk_rows=77), 40)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(c1, X[i1])
    np.testing.assert_array_equal(c2, c1)
    assert len(np.unique(i1)) == 40 and ref_c.shape == c1.shape
    with pytest.raises(ValueError):
        streaming_uniform_centers(g, ArrayChunkSource(X), 501)


# ---------------------------------------------------------------------------
# Streamed fits
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_streamed_fit_matches_reference(precision):
    """``falkon_fit_streaming`` on the reference's centers against
    ``repro.falkon_fit_streaming`` (lam = 1e-3, ragged tail): alpha and
    test predictions, on both port backends; ``predict_stream`` against the
    reference's and against ``predict``."""
    X, y = _problem()
    Xn = _problem(n=200, seed=9)[0]
    jcfg = _cfg(JConfig, ops_impl="jnp", precision=precision)
    jest, jst = jfit_streaming(jax.random.PRNGKey(1), JArraySource(X, y, chunk_rows=CHUNK), jcfg)
    C = np.asarray(jst.centers)
    jpred = jest.predict_stream(JLoader(JArraySource(Xn, chunk_rows=64), prefetch=0))
    tol = FIT_TOL[precision]
    for impl in ("torch", "cuda"):
        cfg = _cfg(FalkonConfig, ops_impl=impl, precision=precision, device="cpu")
        est, st = falkon_fit_streaming(0, ArrayChunkSource(X, y, chunk_rows=CHUNK), cfg,
                                       centers=C, prefetch=2)
        assert rel(st.alpha, jst.alpha) < tol["alpha"], impl
        assert rel(st.residual_norms, jst.residual_norms) < tol["res"]
        assert float(st.cond_estimate) == 0.0
        pred = est.predict_stream(StreamingLoader(ArrayChunkSource(Xn, chunk_rows=64),
                                                  device="cpu"))
        assert rel(pred, jpred) < tol["pred"]
        assert rel(pred, est.predict(Xn)) < 1e-6


@pytest.mark.parametrize("p", [None, 2])
def test_streamed_fit_is_the_incore_solve_in_float64(p):
    """In float64 the streamed fit (ragged tail, prefetch 2) equals the
    in-core ``falkon_solve(estimate_cond=False)`` on the same centers and
    preconditioner to 1e-10."""
    X, Y = _problem(p=p)
    cfg = _cfg(FalkonConfig, ops_impl="torch", dtype="float64", device="cpu")
    est, st = falkon_fit_streaming(0, ArrayChunkSource(X, Y, chunk_rows=CHUNK), cfg,
                                   prefetch=2)
    X64, Y64 = torch.from_numpy(X).double(), torch.from_numpy(Y).double()
    ref = falkon_solve(X64, Y64, est.centers, st.precond, est.kernel, cfg.lam, cfg.iterations,
                       ops_impl="torch", estimate_cond=False)
    assert st.alpha.dtype == torch.float64 and st.alpha.shape == ref.alpha.shape
    assert rel(st.alpha, ref.alpha) < 1e-10
    assert rel(st.residual_norms, ref.residual_norms) < 1e-10
    # its own centers: uniform rows of X, drawn in one host pass
    rows = {tuple(r) for r in X.astype(np.float64).tolist()}
    assert all(tuple(c) in rows for c in est.centers.tolist())


def test_streamed_path_fit_matches_reference():
    """``falkon_fit_path_streaming`` on the reference's centers against the
    reference's, every lam's alpha, and every lam against the port's own
    streamed single fit."""
    X, y = _problem()
    lams = (1e-3, 1e-2, 1e-1)
    jcfg = _cfg(JConfig, ops_impl="jnp")
    jres = jfit_path_streaming(jax.random.PRNGKey(2), JArraySource(X, y, chunk_rows=CHUNK),
                               jcfg, lams)
    C = np.asarray(jres.state.centers)
    cfg = _cfg(FalkonConfig, ops_impl="cuda", device="cpu")
    ops = CountingOps(cfg.make_ops())
    res = falkon_fit_path_streaming(0, ArrayChunkSource(X, y, chunk_rows=CHUNK), cfg, lams,
                                    centers=C, ops=ops)
    assert ops.sweeps == 4 * (cfg.iterations + 1) and res.val_scores is None
    assert rel(res.state.alphas, jres.state.alphas) < FIT_TOL["fp32"]["alpha"]
    for i, lam in enumerate(lams):
        single = falkon_fit_streaming(0, ArrayChunkSource(X, y, chunk_rows=CHUNK),
                                      _cfg(FalkonConfig, lam=lam, device="cpu"), centers=C)[1]
        assert rel(res.estimators[i].alpha, single.alpha) < FIT_TOL["fp32"]["alpha"], lam
        assert res.estimators[i].lam == lam


def test_streamed_fit_refusals():
    """Leverage centers need a pilot pass that is not chunk-additive; a
    source without targets would solve for zero; a streamed fit refuses a
    K_nM cache, and ``predict_stream`` refuses a cache over other rows; the
    in-core fit's estimator predicts a stream too."""
    X, y = _problem(n=300)
    src = ArrayChunkSource(X, y, chunk_rows=128)
    with pytest.raises(ValueError, match="uniform"):
        falkon_fit_streaming(0, src, _cfg(FalkonConfig, center_selection="leverage",
                                          device="cpu"))
    with pytest.raises(ValueError, match="targets"):
        falkon_fit_streaming(0, ArrayChunkSource(X, chunk_rows=128), _cfg(FalkonConfig,
                                                                          device="cpu"))
    est = falkon_fit(0, X, y, _cfg(FalkonConfig, num_centers=16, iterations=3, device="cpu"))[0]
    loader = StreamingLoader(src, device="cpu")
    with pytest.raises(ValueError, match="knm_cache"):
        falkon_fit_streaming(0, src, _cfg(FalkonConfig, knm_cache="device", device="cpu"))
    with pytest.raises(ValueError, match="covers 100 rows"):
        est.predict_stream(loader, cache=est.build_knm_cache(X[:100]))
    assert rel(est.predict_stream(loader), est.predict(X)) < 1e-6
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            falkon_fit_streaming(0, src, _cfg(FalkonConfig))   # never quietly on the CPU
