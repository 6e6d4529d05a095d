"""The port's data-parallel FALKON (``repro_torch.ops.DistributedOps`` on
torch.distributed) against the JAX package's ``DistributedOps``.

The reference needs several devices, so it runs in one subprocess over 8
forced host devices (``XLA_FLAGS``, as ``tests/test_distributed.py`` runs
it) and writes its results to an .npz. The port runs as gloo worlds of 4
CPU processes (``file://`` rendezvous in the test's directory, one torch
thread a rank), each rank running this file as a script and writing its
own results. The reference and the worlds start together; each has its own
timeout, so a hung rank fails its world's tests and nothing else.

Centers cannot share a random stream across the frameworks: where the port
is held against the reference, both take X's first M rows as centers (and
each builds its own preconditioner from them); where the port's mesh fit is
held against its own single-device fit, both draw from one seed.

Counts: the reference counts its collectives at trace time (a path fit's
scanned CG counts 2 psums); PyTorch runs eagerly and the port counts
executed calls (t + 1 for the same fit), so the tests assert the port's.

Tolerances are normwise relative unless stated; each is the worst case
measured on a CPU with ~3x headroom, none looser than the reference's own
(sweeps rtol 2e-4 / atol 2e-3, fit predictions 2e-3).
"""
import dataclasses
import math
import os
import subprocess
import sys
import textwrap
import time
import warnings
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
#: the port's worlds: (mesh shape, dimension names)
WORLDS = {"a": ((4,), ("data",)), "b": ((2, 1, 2), ("pod", "data", "model"))}
#: seconds a world or the reference may take before its tests fail
WORLD_TIMEOUT = 180
REF_TIMEOUT = 300
SIGMA_SWEEP, SIGMA_FIT, LAM = 1.5, 2.0, 1e-4
FIT_N, FIT_D, FIT_M, FIT_T = 1024, 5, 128, 20
PATH_LAMS = (1e-2, 1e-3, 1e-4)
#: the port against the reference: one problem, X's first M rows as centers,
#: a better-posed lam (at 1e-4 two fp32 solves of this system stand ~1.5e-3
#: apart in predictions whatever computes them)
REF_LAM, REF_PATH_LAMS = 1e-3, (1e-1, 1e-2, 1e-3)
CHUNK = 128
MB_N, MB_CHUNK = 2048, 256
#: sweeps (and K_nM blocks) against the reference and the wrapped backend:
#: max |got - ref| over max |ref| (measured <= 5.4e-7, fp32 and the bf16
#: policy's twins on the same quantized inputs; the reference's own bar is
#: rtol 2e-4 / atol 2e-3)
SWEEP_TOL = 2e-6
#: a mesh fit's predictions against one device's, from one seed (measured
#: <= 2.9e-4 over the in-core, cached, streamed and mini-batch fits and the
#: (pod, data) mesh; the reference's bar is 2e-3)
FIT_TOL = 1e-3
#: the lam path's validation curve (relative, measured 2.5e-5) and
#: predictions (measured <= 2.4e-4; the reference's bars 5e-2 for both)
PATH_SCORE_RTOL = 1e-4
PATH_PRED_TOL = 1e-3
#: the port's mesh solves against the reference's on one problem and
#: centers at REF_LAM, in-core, cached, streamed (and path), mini-batch:
#: alpha (measured <= 1.35e-3: alpha is the ill-posed quantity) and
#: predictions (measured <= 1.25e-4)
REF_TOL = dict(alpha=4e-3, pred=4e-4)
#: int8 wire: the reference's band of relative error from the fp32 sweep
#: (both packages measure 3.0e-3, 1e-5 apart)
INT8_BAND = (0.0, 2e-2)


# ----------------------------------------------------------------------------
# Problems: numpy from a seed, the same in both packages
# ----------------------------------------------------------------------------
def sweep_problem(n=512, d=6, M=64):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, d)).astype(np.float32)
    return X, X[:M].copy(), rng.standard_normal(M).astype(np.float32), \
        rng.standard_normal(n).astype(np.float32)


def ragged_problem(n=397, n_pad=400, M=48):
    """n = 397 rows: ceil(397 / 4) * 4 = ceil(397 / 8) * 8 = 400; the junk
    rows and their huge targets must vanish under the mask."""
    X, C, u, v = sweep_problem(n, 6, M)
    rng = np.random.default_rng(3)
    junk = (1e3 * rng.standard_normal((n_pad - n, 6))).astype(np.float32)
    X_junk = np.concatenate([X, junk])
    v_junk = np.concatenate([v, np.full(n_pad - n, 1e6, np.float32)])
    mask = (np.arange(n_pad) < n).astype(np.float32)
    return X, C, u, v, X_junk, v_junk, mask


def fit_problem(n=FIT_N, d=FIT_D, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(d)
    y = (np.sin(X @ w) + 0.05 * rng.standard_normal(n)).astype(np.float32)
    return X, y


def int8_inputs():
    """Ties at half a unit (63.5, 0.5, 1.5, 2.5 with scale 1), a zero
    tensor, and random tensors of both signs."""
    rng = np.random.default_rng(5)
    return {"ties": np.array([127, 63.5, -63.5, 0.5, 1.5, 2.5, -2.5, 0], np.float32),
            "zeros": np.zeros(7, np.float32),
            "rand": rng.standard_normal((33, 5)).astype(np.float32),
            "wide": (1e4 * rng.standard_normal(64)).astype(np.float32)}


def grad_tree():
    rng = np.random.default_rng(7)
    g = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    # no 2-tuple of leaves: the reference takes any 2-tuple for a (q, scale)
    # pair when it decompresses
    return {"a": g(5, 3), "b": [g(4), (g(2, 2), g(3), g(1))], "c": {"d": g(6)}}


def tree_leaves(tree, prefix="") -> dict:
    """{path: leaf} over nested dicts, lists and tuples (dict keys sorted)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(tree_leaves(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, t in enumerate(tree):
            out.update(tree_leaves(t, f"{prefix}/{i}"))
        return out
    return {prefix: np.asarray(tree)}


def loader_batches():
    """Rows divisible by every data axis, rows that are not (replicated), a
    scalar and a non-array value."""
    rng = np.random.default_rng(9)
    return [{"x": rng.standard_normal((8, 3)).astype(np.float32),
             "y": np.arange(8, dtype=np.int64),
             "odd": rng.standard_normal((5, 2)).astype(np.float32),
             "s": np.float32(i), "tag": f"batch{i}"} for i in range(3)]


# ----------------------------------------------------------------------------
# The reference side: one subprocess over 8 host devices
# ----------------------------------------------------------------------------
_REF_PRELUDE = """
import dataclasses, sys, warnings
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
sys.path.insert(0, {tests!r})
import test_torch_distributed as T
from repro.core import (FalkonConfig, GaussianKernel, MinibatchConfig, falkon_fit_minibatch,
                        falkon_fit_path_streaming, falkon_fit_streaming, falkon_solve,
                        make_preconditioner)
from repro.data import ArrayChunkSource, ShardedLoader
from repro.distributed.compression import compressed_grads, init_residuals, quantize_int8
from repro.ops import DistributedOps, KernelCache, get_ops, plan_cache
warnings.simplefilter("ignore")
devs = jax.devices()
assert len(devs) == 8, devs
mesh = Mesh(np.array(devs[:4]), ("data",))
mesh_pod = Mesh(np.array(devs[:4]).reshape(2, 1, 2), ("pod", "data", "model"))
out = {{}}
kern = GaussianKernel(sigma=T.SIGMA_SWEEP)
X, y = T.fit_problem()
Xf, yf, Cf = jnp.asarray(X), jnp.asarray(y), jnp.asarray(X[:T.FIT_M])
cfg = FalkonConfig(kernel="gaussian", kernel_params=(("sigma", T.SIGMA_FIT),), lam=T.REF_LAM,
                   num_centers=T.FIT_M, iterations=T.FIT_T, block_size=128)
cfg_m = dataclasses.replace(cfg, mesh=mesh)
fk = cfg.make_kernel()
"""

#: the reference's cases in three processes that run at once (each is
#: mostly XLA compiling its shard_maps)
_REF_PARTS = ("""
X, C, u, v = T.sweep_problem()
for impl in ("jnp", "pallas"):
    dist = DistributedOps(get_ops(impl, kern, block_size=64), mesh, ("data",))
    out["sweep_" + impl] = dist.sweep(X, C, u, v)
    out["apply_" + impl] = dist.apply(X, C, u)

X, C, u, v, Xj, vj, mask = T.ragged_problem()
for impl, prec in (("jnp", "fp32"), ("pallas", "fp32"), ("jnp", "bf16")):
    dist = DistributedOps(get_ops(impl, kern, block_size=64, precision=prec), mesh, ("data",))
    out["ragged_%s_%s" % (impl, prec)] = dist.sweep(X, C, u, v)

for tag, m in (("a", mesh), ("b", mesh_pod)):
    pos = {{d.id: idx for idx, d in np.ndenumerate(m.devices)}}
    for i, batch in enumerate(ShardedLoader(iter(T.loader_batches()), m, prefetch=1)):
        for k, a in batch.items():
            if not hasattr(a, "addressable_shards"):
                continue
            for sh in a.addressable_shards:
                coord = "_".join(map(str, pos[sh.device.id]))
                out["load_%s_%d_%s_%s" % (tag, i, k, coord)] = sh.data
""", """
Xs, Cs, us, vs = T.sweep_problem()
inner = get_ops("jnp", kern, block_size=64)
ref = DistributedOps(inner, mesh, ("data",)).sweep(Xs, Cs, us, vs)
got = DistributedOps(inner, mesh, ("data",), compress="int8").sweep(Xs, Cs, us, vs)
out["int8_rel"] = jnp.linalg.norm(got - ref) / jnp.linalg.norm(ref)
for name, a in T.int8_inputs().items():
    q, s = quantize_int8(jnp.asarray(a))
    out["q_" + name], out["s_" + name] = q, s

g = jax.tree.map(jnp.asarray, T.grad_tree())
r0 = init_residuals(g)
d1, r1 = compressed_grads(g, r0)
d2, r2 = compressed_grads(g, r1)
for tag, tree in (("d1", d1), ("r1", r1), ("d2", d2), ("r2", r2)):
    for path, leaf in T.tree_leaves(jax.tree.map(np.asarray, tree)).items():
        out[tag + path] = leaf

# solves on the first M rows as centers, the port's side does the same
for tag, m, axes in (("fit", mesh, ("data",)), ("pod", mesh_pod, ("pod", "data"))):
    ops = DistributedOps(get_ops("jnp", fk, block_size=128), m, axes)
    P = make_preconditioner(ops.gram(Cf, Cf), T.REF_LAM, T.FIT_N)
    st = falkon_solve(Xf, yf, Cf, P, fk, T.REF_LAM, T.FIT_T, ops=ops, estimate_cond=False)
    out[tag + "_alpha"] = st.alpha
    out[tag + "_pred"] = ops.apply(Xf, Cf, st.alpha)
    if tag == "fit":
        plan = plan_cache(T.FIT_N, T.FIT_M, shards=4, tier="device")
        cache = KernelCache(ops, Xf, Cf, plan=plan)
        for i, sh in enumerate(sorted(cache.K.addressable_shards,
                                      key=lambda s: s.index[0].start or 0)):
            out["cache_block_%d" % i] = sh.data
        stc = falkon_solve(Xf, yf, Cf, P, fk, T.REF_LAM, T.FIT_T, ops=ops, estimate_cond=False,
                           cache=cache)
        out["cached_alpha"] = stc.alpha
""", """
src = ArrayChunkSource(X, y, chunk_rows=T.CHUNK)
est, _ = falkon_fit_streaming(jax.random.PRNGKey(1), src, cfg_m, centers=Cf, prefetch=0)
out["stream_pred"] = est.predict(Xf)
res = falkon_fit_path_streaming(jax.random.PRNGKey(1), src, cfg_m, T.REF_PATH_LAMS, centers=Cf,
                                prefetch=0)
out["path_stream_pred"] = jnp.stack([e.predict(Xf) for e in res.estimators])

Xm, ym = T.fit_problem(T.MB_N, seed=2)
mb = MinibatchConfig(chunk_rows=T.MB_CHUNK, shuffle=False)
est, _ = falkon_fit_minibatch(jax.random.PRNGKey(1), jnp.asarray(Xm), jnp.asarray(ym),
                              dataclasses.replace(cfg_m, estimate_cond=False), mb,
                              centers=jnp.asarray(Xm[:T.FIT_M]))
out["mb_alpha"] = est.alpha
out["mb_pred"] = est.predict(jnp.asarray(Xm))
""")
_REF_SAVE = """
np.savez({path!r}, **{{k: np.asarray(a) for k, a in out.items()}})
"""


# ----------------------------------------------------------------------------
# The port's side: one process a rank (this file run as a script)
# ----------------------------------------------------------------------------
def _t(a):
    return torch.from_numpy(np.array(a))


def _world_a(mesh) -> dict:
    """Every case on a 1-D mesh of 4 ranks."""
    import repro_torch.core.falkon as tfalkon
    from repro_torch.core import (FalkonConfig, MinibatchConfig, falkon_fit,
                                  falkon_fit_minibatch, falkon_fit_path,
                                  falkon_fit_path_streaming, falkon_fit_streaming,
                                  falkon_solve, make_kernel, make_preconditioner)
    from repro_torch.data import ArrayChunkSource, ShardedLoader
    from repro_torch.ops import (CountingOps, DistributedOps, KernelCache, get_ops,
                                 plan_cache)
    r = {}
    kern = make_kernel("gaussian", sigma=SIGMA_SWEEP)
    X, C, u, v = map(_t, sweep_problem())
    for impl in ("torch", "cuda"):
        inner = get_ops(impl, kern, block_size=64)
        d = DistributedOps(inner, mesh, ("data",))
        r[f"sweep_{impl}"] = d.sweep(X, C, u, v)
        r[f"sweep_counts_{impl}"] = (d.psums, d.psum_floats, d.gathers)
        r[f"single_{impl}"] = inner.sweep(X, C, u, v)
        r[f"apply_{impl}"] = d.apply(X, C, u)
        r[f"inner_apply_{impl}"] = inner.apply(X, C, u)
        r[f"apply_counts_{impl}"] = (d.psums, d.psum_floats, d.gathers, d.gather_floats)
        d.sweep(X, C, torch.stack([u, -u, 2 * u], 1))      # p = 3: one (M, 3) all-reduce
        r[f"p3_counts_{impl}"] = (d.psums, d.psum_floats)
        d.reset_comm_stats()
        r[f"reset_counts_{impl}"] = (d.psums, d.psum_floats, d.gathers, d.gather_floats)
    r["shard"] = (d.shard_index, d.num_shards)
    r["coord"] = mesh.get_coordinate()
    for bad in (dict(data_axes=()), dict(data_axes=("pod",)), dict(compress="fp8")):
        try:
            DistributedOps(inner, mesh, **bad)
            r["refused_" + "_".join(bad)] = False
        except ValueError:
            r["refused_" + "_".join(bad)] = True
    try:
        FalkonConfig(device="cpu", mesh=mesh, data_axes=("pod",))
        r["config_refused"] = False
    except ValueError:
        r["config_refused"] = True

    # the ragged n: junk rows under a mask == internal zero padding
    X, C, u, v, Xj, vj, mask = map(_t, ragged_problem())
    for impl, prec, budget in (("torch", "fp32", None), ("cuda", "fp32", None),
                               ("torch", "bf16", None), ("cuda", "bf16", None),
                               ("cuda", "fp32", "0.0001")):
        tag = f"{impl}_{prec}" + ("_b4" if budget else "")
        if budget:
            os.environ["REPRO_SWEEP_BUDGET_MB"] = budget
        inner = get_ops(impl, kern, block_size=64, precision=prec)
        d = DistributedOps(inner, mesh, ("data",))
        r[f"ragged_plan_{tag}"] = d.plan(X.shape[0], C.shape[0], X.shape[1]).path
        r[f"ragged_single_{tag}"] = inner.sweep(X, C, u, v)
        r[f"ragged_{tag}"] = d.sweep(X, C, u, v)
        r[f"ragged_masked_{tag}"] = d.sweep(Xj, C, u, vj, row_mask=mask)
        os.environ.pop("REPRO_SWEEP_BUDGET_MB", None)
    # a ragged cache: 397 rows padded to 4 * 128; each rank its slice of the
    # pad mask, of a caller's mask and of v
    d = DistributedOps(get_ops("torch", kern, block_size=64), mesh, ("data",))
    cache = KernelCache(d, X, C, plan=plan_cache(X.shape[0], C.shape[0], shards=4,
                                                 tier="device"))
    odd = (torch.arange(X.shape[0]) % 3 != 0).to(torch.float32)
    r["cache_ragged_rows"] = (cache.K.shape[0], cache.n_pad)
    r["cache_ragged"] = cache.sweep(u, v, row_mask=odd)
    r["cache_ragged_ref"] = d.sweep(X, C, u, v, row_mask=odd)
    r["cache_ragged_apply"] = cache.apply(u)
    r["cache_ragged_apply_ref"] = d.apply(X, C, u)

    # the int8 wire
    X, C, u, v = map(_t, sweep_problem())
    inner = get_ops("torch", kern, block_size=64)
    ref = DistributedOps(inner, mesh, ("data",)).sweep(X, C, u, v)
    got = DistributedOps(inner, mesh, ("data",), compress="int8").sweep(X, C, u, v)
    r["int8_rel"] = float((got - ref).norm() / ref.norm())

    # fits: the mesh fit against one device's, from one seed
    X, y = fit_problem()
    cfg = FalkonConfig(kernel="gaussian", kernel_params=(("sigma", SIGMA_FIT),), lam=LAM,
                       num_centers=FIT_M, iterations=FIT_T, block_size=128, device="cpu",
                       ops_impl="torch")
    cfg_m = dataclasses.replace(cfg, mesh=mesh)
    fk = cfg.make_kernel()
    Xt = _t(X)
    count_1 = CountingOps(get_ops("torch", fk, block_size=128))
    est_1, _ = falkon_fit(1, X, y, cfg, ops=count_1)
    count_m = CountingOps(get_ops("torch", fk, block_size=128))
    dist_m = tfalkon._resolve_ops(cfg_m, fk, count_m)
    r["resolved_distributed"] = isinstance(dist_m, DistributedOps) and dist_m.inner is count_m
    est_m, _ = falkon_fit(1, X, y, cfg_m, ops=dist_m)
    r["made_distributed"] = isinstance(cfg_m.make_ops(), DistributedOps)
    est_c, _ = falkon_fit(1, X, y, cfg_m)
    est_k, _ = falkon_fit(1, X, y, cfg, mesh=mesh, data_axes=("data",))
    r["fit_pred_1"], r["fit_pred_m"] = est_1.predict(Xt), est_m.predict(Xt)
    r["fit_alpha_m"], r["fit_alpha_c"], r["fit_alpha_k"] = est_m.alpha, est_c.alpha, est_k.alpha
    r["fit_counts_1"] = (count_1.sweeps, count_1.grams, count_1.applies)
    r["fit_counts_m"] = (count_m.sweeps, count_m.grams, count_m.applies, dist_m.psums,
                         dist_m.psum_floats)
    counted = CountingOps(DistributedOps(get_ops("torch", fk, block_size=128), mesh, ("data",)))
    r["outer_passes"] = tfalkon._resolve_ops(cfg_m, fk, counted) is counted
    est_o, _ = falkon_fit(1, X, y, cfg_m, ops=counted)
    r["fit_alpha_o"] = est_o.alpha
    r["outer_counts"] = (counted.sweeps, counted.ops.psums)

    # the port's solve on the reference's problem: X's first M rows as centers
    Cf = Xt[:FIT_M].clone()
    ops = DistributedOps(get_ops("torch", fk, block_size=128), mesh, ("data",))
    P = make_preconditioner(ops.gram(Cf, Cf), REF_LAM, FIT_N)
    st = falkon_solve(Xt, _t(y), Cf, P, fk, REF_LAM, FIT_T, ops=ops, estimate_cond=False)
    r["ref_fit_alpha"], r["ref_fit_pred"] = st.alpha, ops.apply(Xt, Cf, st.alpha)
    plan = plan_cache(FIT_N, FIT_M, shards=4, tier="device")
    cache = KernelCache(ops, Xt, Cf, plan=plan)
    r["cache_block"], r["cache_n_pad"] = cache.K, cache.n_pad
    ops.reset_comm_stats()
    stc = falkon_solve(Xt, _t(y), Cf, P, fk, REF_LAM, FIT_T, ops=ops, estimate_cond=False,
                       cache=cache)
    r["cached_alpha"], r["cached_psums"] = stc.alpha, ops.psums
    r["cached_pred"] = cache.apply(stc.alpha)
    try:
        KernelCache(ops, Xt, Cf, plan=plan_cache(FIT_N, FIT_M, shards=4, tier="host"))
        r["host_refused"] = False
    except ValueError:
        r["host_refused"] = True
    try:
        falkon_fit(1, X, y, dataclasses.replace(cfg_m, knm_cache="host"))
        r["host_fit_refused"] = False
    except ValueError:
        r["host_fit_refused"] = True
    # the cached fit under the mesh against one device's, from one seed
    counts = {}
    for tag, c in (("1", cfg), ("m", cfg_m)):
        cnt = CountingOps(get_ops("torch", fk, block_size=128))
        ops = tfalkon._resolve_ops(c, fk, cnt)
        est, _ = falkon_fit(1, X, y, dataclasses.replace(c, knm_cache="device"), ops=ops)
        r[f"cfit_pred_{tag}"] = est.predict(Xt)
        counts[tag] = (cnt.materializes, cnt.gemm_sweeps, cnt.sweeps,
                       getattr(ops, "psums", cnt.gemm_sweeps))
    r["cfit_counts_1"], r["cfit_counts_m"] = counts["1"], counts["m"]

    # the lam path in-core, from one seed
    for tag, c in (("1", cfg), ("m", cfg_m)):
        cnt = CountingOps(get_ops("torch", fk, block_size=128))
        ops = tfalkon._resolve_ops(c, fk, cnt)
        res = falkon_fit_path(1, X, y, c, PATH_LAMS, X_val=X[:96], y_val=y[:96], ops=ops)
        r[f"path_scores_{tag}"] = res.val_scores
        r[f"path_pred_{tag}"] = torch.stack([e.predict(Xt) for e in res.estimators])
        r[f"path_counts_{tag}"] = (cnt.sweeps, cnt.applies, getattr(ops, "psums", cnt.sweeps),
                                   getattr(ops, "psum_floats", 0),
                                   getattr(ops, "gathers", 0))
    # streamed fits: on the reference's centers, and from one seed
    src = ArrayChunkSource(X, y, chunk_rows=CHUNK)
    cnt = CountingOps(get_ops("torch", fk, block_size=128))
    cfg_r = dataclasses.replace(cfg_m, lam=REF_LAM)
    ops = tfalkon._resolve_ops(cfg_r, fk, cnt)
    est, _ = falkon_fit_streaming(1, src, cfg_r, centers=Cf, ops=ops)
    r["stream_pred"] = est.predict(Xt)
    r["stream_counts"] = (cnt.sweeps, ops.psums)
    res = falkon_fit_path_streaming(1, src, cfg_r, REF_PATH_LAMS, centers=Cf)
    r["path_stream_pred"] = torch.stack([e.predict(Xt) for e in res.estimators])
    c25 = dataclasses.replace(cfg, iterations=25)
    for tag, c in (("1", c25), ("m", dataclasses.replace(c25, mesh=mesh))):
        est, _ = falkon_fit_streaming(1, src, c)
        r[f"sfit_pred_{tag}"] = est.predict(Xt)

    # mini-batch fits: on the reference's centers without shuffling, and from
    # one seed with it
    Xm, ym = fit_problem(MB_N, seed=2)
    mb_cfg = dataclasses.replace(cfg, estimate_cond=False)
    mb = MinibatchConfig(chunk_rows=MB_CHUNK, shuffle=False)
    cnt = CountingOps(get_ops("torch", fk, block_size=128))
    cfg_r = dataclasses.replace(mb_cfg, mesh=mesh, lam=REF_LAM)
    ops = tfalkon._resolve_ops(cfg_r, fk, cnt)
    est, _ = falkon_fit_minibatch(1, Xm, ym, cfg_r, mb, centers=Xm[:FIT_M], ops=ops)
    r["mb_alpha"], r["mb_pred"] = est.alpha, est.predict(_t(Xm))
    r["mb_counts"] = (cnt.sweeps, ops.psums, ops.psum_floats)
    mb = MinibatchConfig(chunk_rows=MB_CHUNK)
    for tag, c in (("1", mb_cfg), ("m", dataclasses.replace(mb_cfg, mesh=mesh))):
        est, res = falkon_fit_minibatch(1, Xm, ym, c, mb)
        r[f"mfit_pred_{tag}"] = est.predict(_t(Xm))

    for i, batch in enumerate(ShardedLoader(iter(loader_batches()), mesh, prefetch=1)):
        for k, a in batch.items():
            r[f"load_{i}_{k}"] = a if isinstance(a, torch.Tensor) else str(a)
    return r


def _world_b(mesh) -> dict:
    """A (pod, data, model) mesh: rows shard over ("pod", "data"), the model
    dimension replicates."""
    from repro_torch.core import FalkonConfig, falkon_fit, falkon_solve, make_preconditioner
    from repro_torch.data import ShardedLoader
    from repro_torch.distributed import data_axes
    from repro_torch.ops import DistributedOps, get_ops
    r = {}
    X, y = fit_problem()
    Xt = _t(X)
    cfg = FalkonConfig(kernel="gaussian", kernel_params=(("sigma", SIGMA_FIT),), lam=LAM,
                       num_centers=FIT_M, iterations=FIT_T, block_size=128, device="cpu",
                       ops_impl="torch", mesh=mesh, data_axes=("pod", "data"))
    fk = cfg.make_kernel()
    ops = cfg.make_ops(fk)
    r["coord"] = mesh.get_coordinate()
    r["shard"] = (ops.shard_index, ops.num_shards)
    r["group_ranks"] = torch.distributed.get_process_group_ranks(ops.group)
    r["data_axes"] = "/".join(data_axes(mesh))
    est_1, _ = falkon_fit(1, X, y, dataclasses.replace(cfg, mesh=None))
    est_m, _ = falkon_fit(1, X, y, cfg)
    r["fit_pred_1"], r["fit_pred_m"], r["fit_alpha_m"] = (est_1.predict(Xt), est_m.predict(Xt),
                                                          est_m.alpha)
    Cf = Xt[:FIT_M].clone()
    ops = DistributedOps(get_ops("torch", fk, block_size=128), mesh, ("pod", "data"))
    P = make_preconditioner(ops.gram(Cf, Cf), REF_LAM, FIT_N)
    st = falkon_solve(Xt, _t(y), Cf, P, fk, REF_LAM, FIT_T, ops=ops, estimate_cond=False)
    r["ref_pod_alpha"], r["ref_pod_pred"] = st.alpha, ops.apply(Xt, Cf, st.alpha)
    for i, batch in enumerate(ShardedLoader(iter(loader_batches()), mesh, prefetch=1)):
        for k, a in batch.items():
            r[f"load_{i}_{k}"] = a if isinstance(a, torch.Tensor) else str(a)
    return r


def _to_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _worker(world: str, rank: int, store: str, out: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    warnings.simplefilter("ignore")
    shape, axes = WORLDS[world]
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=math.prod(shape), timeout=timedelta(seconds=60))
    try:
        mesh = make_mesh(shape, axes, device_type="cpu")
        res = {"a": _world_a, "b": _world_b}[world](mesh)
        np.savez(os.path.join(out, f"{world}_{rank}.npz"),
                 **{k: _to_numpy(v) for k, v in res.items()})
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------------
# Launching and collecting
# ----------------------------------------------------------------------------
def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", **extra)
    return env


class _Run:
    """Processes started together, waited on with one deadline."""

    def __init__(self, name: str, cmds: list, env: dict, logdir: Path, timeout: float):
        self.name, self.timeout, self.logs = name, timeout, []
        self.deadline = time.monotonic() + timeout
        self.procs = []
        for i, cmd in enumerate(cmds):
            log = logdir / f"{name}_{i}.log"
            self.logs.append(log)
            with open(log, "w") as fh:
                self.procs.append(subprocess.Popen(cmd, env=env, stdout=fh,
                                                   stderr=subprocess.STDOUT, cwd=HERE.parent))
        self.error = None
        self.waited = False

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def wait(self) -> None:
        """Fail (for every test that needs this run) on a timeout or a
        non-zero exit, with each process's log."""
        if not self.waited:
            self.waited = True
            try:
                for p in self.procs:
                    p.wait(timeout=max(self.deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                self.error = f"{self.name} overran its {self.timeout} s timeout"
            self.kill()
            bad = [p.returncode for p in self.procs if p.returncode != 0]
            if self.error is None and bad:
                self.error = f"{self.name} exited {bad}"
            if self.error:
                self.error += "".join(f"\n--- {log.name}\n" + log.read_text()[-4000:]
                                      for log in self.logs)
        if self.error:
            pytest.fail(self.error)


@pytest.fixture(scope="module")
def _runs(tmp_path_factory):
    """The reference's parts and both worlds, started at once."""
    tmp = tmp_path_factory.mktemp("dist")
    ref_env = _env(XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu")
    runs = {f"ref{i}": _Run(f"ref{i}", [[sys.executable, "-c", textwrap.dedent(
        _REF_PRELUDE + part + _REF_SAVE).format(tests=str(HERE), path=str(tmp / f"ref{i}.npz"))]],
        ref_env, tmp, REF_TIMEOUT) for i, part in enumerate(_REF_PARTS)}
    for world, (shape, _) in WORLDS.items():
        store = tmp / f"store_{world}"
        runs[world] = _Run(world, [[sys.executable, str(Path(__file__)), world, str(r),
                                    str(store), str(tmp)] for r in range(math.prod(shape))],
                           _env(), tmp, WORLD_TIMEOUT)
    yield tmp, runs
    for run in runs.values():
        run.kill()


def _load(path: Path) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def ref(_runs):
    tmp, runs = _runs
    out = {}
    for i in range(len(_REF_PARTS)):
        runs[f"ref{i}"].wait()
        out.update(_load(tmp / f"ref{i}.npz"))
    return out


@pytest.fixture(scope="module")
def world_a(_runs):
    tmp, runs = _runs
    runs["a"].wait()
    return [_load(tmp / f"a_{r}.npz") for r in range(4)]


@pytest.fixture(scope="module")
def world_b(_runs):
    tmp, runs = _runs
    runs["b"].wait()
    return [_load(tmp / f"b_{r}.npz") for r in range(4)]


def rel(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def close(got, ref, tol: float) -> None:
    """max |got - ref| <= tol * max |ref|."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))
    assert err <= tol, err


def same_on_every_rank(world, key) -> np.ndarray:
    """The value every rank holds for ``key``, asserted bit-equal."""
    first = world[0][key]
    for w in world[1:]:
        np.testing.assert_array_equal(w[key], first)
        assert w[key].tobytes() == first.tobytes(), key
    return first


# ----------------------------------------------------------------------------
# Tests
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("impl,ref_impl", [("torch", "jnp"), ("cuda", "pallas")])
def test_sweep_and_apply_match_reference(world_a, ref, impl, ref_impl):
    """One sharded sweep equals the wrapped backend's and the reference's
    sharded sweep; ``apply`` is bit-equal to the wrapped backend's on every
    rank."""
    got = same_on_every_rank(world_a, f"sweep_{impl}")
    close(got, world_a[0][f"single_{impl}"], SWEEP_TOL)
    close(got, ref[f"sweep_{ref_impl}"], SWEEP_TOL)
    for w in world_a:
        assert w[f"apply_{impl}"].tobytes() == w[f"inner_apply_{impl}"].tobytes()
    close(world_a[0][f"apply_{impl}"], ref[f"apply_{ref_impl}"], SWEEP_TOL)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_one_all_reduce_per_sweep_and_apply_apart(world_a, impl):
    """A sweep is one (M, p) all-reduce (``psums``, ``psum_floats``); apply's
    reassembly is counted apart (``gathers``), never as a psum."""
    for w in world_a:
        assert tuple(w[f"sweep_counts_{impl}"]) == (1, 64, 0)
        assert tuple(w[f"apply_counts_{impl}"]) == (1, 64, 1, 512)
        assert tuple(w[f"p3_counts_{impl}"]) == (2, 64 + 3 * 64)
        assert tuple(w[f"reset_counts_{impl}"]) == (0, 0, 0, 0)
    assert sorted(tuple(w["shard"]) for w in world_a) == [(i, 4) for i in range(4)]


class _StubMesh:
    """The three things ``data_shard`` reads of a ``DeviceMesh``."""

    def __init__(self, shape, names, coord):
        self.shape, self.mesh_dim_names, self._coord = tuple(shape), tuple(names), list(coord)

    def get_coordinate(self):
        return self._coord


@pytest.mark.parametrize("axes", [("pod", "data"), ("data", "pod"), ("data",), ("pod",)])
def test_shard_order_is_row_major_over_the_data_axes(axes):
    """On a (2, 2, 2) (pod, data, model) mesh the shard index is row-major
    over ``axes`` in the order given (the reference's ``P(axes)``), and the
    model coordinate does not move it."""
    from repro_torch.distributed import data_shard
    sizes = {"pod": 2, "data": 2, "model": 2}
    for pod in range(2):
        for data in range(2):
            for model in range(2):
                coord = {"pod": pod, "data": data, "model": model}
                mesh = _StubMesh((2, 2, 2), ("pod", "data", "model"), (pod, data, model))
                want = 0
                for a in axes:
                    want = want * sizes[a] + coord[a]
                assert data_shard(mesh, axes) == (want, math.prod(sizes[a] for a in axes))


def test_validation_refuses_bad_axes_and_compression(world_a):
    for w in world_a:
        assert w["refused_data_axes"] and w["refused_compress"] and w["config_refused"]


def test_fit_matches_single_device_and_kwargs(world_a):
    """The mesh fit's predictions against the single-device fit's from the
    same seed (the reference's bar); the ``mesh=`` / ``data_axes=`` keywords
    are the config's route bit for bit; alpha is the same bits on every
    rank."""
    alpha = same_on_every_rank(world_a, "fit_alpha_m")
    w = world_a[0]
    assert rel(w["fit_pred_m"], w["fit_pred_1"]) < FIT_TOL
    assert alpha.tobytes() == w["fit_alpha_c"].tobytes() == w["fit_alpha_k"].tobytes()
    assert w["made_distributed"]


def test_counting_inside_distributed_counts_like_one_device(world_a):
    """``_resolve_ops`` wraps a ``CountingOps`` in ``DistributedOps``: the
    mesh fit makes the single-device fit's sweeps, grams and applies, and
    each sweep is one (M, 1) all-reduce."""
    for w in world_a:
        assert w["resolved_distributed"]
        sweeps, grams, applies, psums, floats = w["fit_counts_m"]
        assert (sweeps, grams, applies) == tuple(w["fit_counts_1"])
        assert sweeps == 1 + FIT_T + 26
        assert psums == sweeps and floats == sweeps * FIT_M


def test_counting_outside_distributed_is_not_wrapped_again(world_a):
    """``CountingOps(DistributedOps(...))`` passes through unwrapped: one
    all-reduce a counted sweep, and the fit equals the config's mesh fit."""
    for w in world_a:
        assert w["outer_passes"]
        sweeps, psums = w["outer_counts"]
        assert sweeps == psums == 1 + FIT_T + 26
        assert w["fit_alpha_o"].tobytes() == w["fit_alpha_c"].tobytes()


@pytest.mark.parametrize("tag,ref_tag", [("torch_fp32", "jnp_fp32"), ("cuda_fp32", "pallas_fp32"),
                                         ("torch_bf16", "jnp_bf16"), ("cuda_bf16", "jnp_bf16"),
                                         ("cuda_fp32_b4", "pallas_fp32")])
def test_ragged_mask_and_pad(world_a, ref, tag, ref_tag):
    """n = 397 over 4 shards: the pad rows add nothing. Junk rows under a
    mask are bit-identical to the internal zero padding in fp32 (B1's twin
    and, past the sweep budget, B4's); bf16 holds to the compensated
    tolerance. Both against the wrapped backend and the reference."""
    w = world_a[0]
    if tag.endswith("_b4"):
        assert str(w[f"ragged_plan_{tag}"]) != "fused"
    got = same_on_every_rank(world_a, f"ragged_{tag}")
    masked = same_on_every_rank(world_a, f"ragged_masked_{tag}")
    close(got, w[f"ragged_single_{tag}"], SWEEP_TOL)
    if "fp32" in tag:
        assert masked.tobytes() == got.tobytes()
    else:
        close(masked, got, SWEEP_TOL)
    close(got, ref[f"ragged_{ref_tag}"], SWEEP_TOL)


def test_ragged_cache_hands_each_rank_its_rows(world_a):
    """A cache over 397 rows: each rank stores 128 of the 512 padded rows,
    and its GEMM sweep (v and a caller's mask cut to its rows, the pad rows
    masked) and apply equal the recompute sweep and apply."""
    for w in world_a:
        assert tuple(w["cache_ragged_rows"]) == (128, 512)
        close(w["cache_ragged"], w["cache_ragged_ref"], SWEEP_TOL)
        close(w["cache_ragged_apply"], w["cache_ragged_apply_ref"], SWEEP_TOL)
    same_on_every_rank(world_a, "cache_ragged")


def test_quantize_int8_matches_reference(ref):
    """Half to even, the clamp at 1e-30: bit-equal to the reference's."""
    from repro_torch.distributed import dequantize_int8, quantize_int8
    for name, a in int8_inputs().items():
        q, s = quantize_int8(torch.from_numpy(a))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), ref[f"q_{name}"])
        assert s.numpy().tobytes() == ref[f"s_{name}"].tobytes(), name
        back = dequantize_int8(q, s, torch.float32).numpy()
        assert np.abs(back - a).max() <= float(s) / 2 * (1 + 1e-6)
    q, _ = quantize_int8(torch.from_numpy(int8_inputs()["ties"]))
    assert q.tolist() == [127, 64, -64, 0, 2, 2, -2, 0]


def test_int8_wire_sweep(world_a, ref):
    """The int8 round trip before the all-reduce: relative error from the
    fp32 sweep inside the reference's band."""
    for w in world_a:
        assert INT8_BAND[0] < float(w["int8_rel"]) < INT8_BAND[1], float(w["int8_rel"])
        assert abs(float(w["int8_rel"]) / float(ref["int8_rel"]) - 1) < 1e-2


def test_compression_tree_matches_reference(ref):
    """``compressed_grads`` with error feedback over a nested dict of lists
    and tuples, twice: the decompressed gradients and the residuals equal
    the reference's."""
    from repro_torch.distributed import compress_tree, compressed_grads, init_residuals
    from repro_torch.distributed.compression import _tree_map
    tree = _tree_map(_t, grad_tree())
    r0 = init_residuals(tree)
    d1, r1 = compressed_grads(tree, r0)
    d2, r2 = compressed_grads(tree, r1)
    assert isinstance(d1["b"], list) and isinstance(d1["b"][1], tuple)
    for tag, t in (("d1", d1), ("r1", r1), ("d2", d2), ("r2", r2)):
        leaves = tree_leaves(_tree_map(lambda a: a.numpy(), t))
        assert set(leaves) == set(tree_leaves(grad_tree()))
        for path, leaf in leaves.items():
            assert leaf.tobytes() == ref[tag + path].tobytes(), tag + path
    qs, _ = compress_tree(tree, r0)
    assert qs["c"]["d"][0].dtype == torch.int8 and qs["c"]["d"][1].ndim == 0


def test_solve_matches_reference_mesh_solve(world_a, ref):
    """The port's mesh solve on the reference's problem and centers (X's
    first M rows) against the reference's mesh solve."""
    alpha = same_on_every_rank(world_a, "ref_fit_alpha")
    assert rel(alpha, ref["fit_alpha"]) < REF_TOL["alpha"]
    assert rel(world_a[0]["ref_fit_pred"], ref["fit_pred"]) < REF_TOL["pred"]


def test_multipod_axes_and_replicated_model_dimension(world_b, ref):
    """Rows shard over ("pod", "data") of a (2, 1, 2) mesh in the reference's
    row-major order; ranks that differ only along "model" hold the same
    shard, reduce in separate groups and hold the same bits."""
    for w in world_b:
        pod, data, model = (int(c) for c in w["coord"])
        assert tuple(w["shard"]) == (pod * 1 + data, 2)
        # the group: the ranks with this rank's model coordinate, in shard order
        assert [int(r) for r in w["group_ranks"]] == [model, 2 + model]
        assert str(w["data_axes"]) == "pod/data"
    same_on_every_rank(world_b, "fit_alpha_m")
    w = world_b[0]
    assert rel(w["fit_pred_m"], w["fit_pred_1"]) < FIT_TOL
    alpha = same_on_every_rank(world_b, "ref_pod_alpha")
    assert rel(alpha, ref["pod_alpha"]) < REF_TOL["alpha"]
    assert rel(w["ref_pod_pred"], ref["pod_pred"]) < REF_TOL["pred"]


def test_path_fit_under_mesh(world_a):
    """The lam path stacks its L systems into one (M, L) all-reduce a sweep:
    t + 1 executed all-reduces (the reference traces 2), the single-device
    fit's sweeps and applies, its validation curve and predictions within
    the reference's bars."""
    w = world_a[0]
    sweeps_1, applies_1 = tuple(w["path_counts_1"])[:2]
    for v in world_a:
        sweeps, applies, psums, floats, gathers = v["path_counts_m"]
        assert (sweeps, applies) == (sweeps_1, applies_1) == (FIT_T + 1, 1)
        assert psums == sweeps and floats == FIT_M * (1 + FIT_T * len(PATH_LAMS))
        assert gathers == 1
    np.testing.assert_allclose(w["path_scores_m"], w["path_scores_1"], rtol=PATH_SCORE_RTOL)
    for pm, p1 in zip(w["path_pred_m"], w["path_pred_1"]):
        assert rel(pm, p1) < PATH_PRED_TOL


def test_streamed_fits_under_mesh(world_a, ref):
    """The streamed fit and the streamed path on the reference's centers
    against the reference's mesh fits; a streamed mesh fit from a seed
    against one device's. Every chunk sweep is one all-reduce (each rank
    reads every chunk and sweeps its rows of it)."""
    w = world_a[0]
    assert rel(w["stream_pred"], ref["stream_pred"]) < REF_TOL["pred"]
    for pm, pr in zip(w["path_stream_pred"], ref["path_stream_pred"]):
        assert rel(pm, pr) < REF_TOL["pred"]
    for v in world_a:
        sweeps, psums = v["stream_counts"]
        assert sweeps == psums == (FIT_T + 1) * math.ceil(FIT_N / CHUNK)
    assert rel(w["sfit_pred_m"], w["sfit_pred_1"]) < FIT_TOL


def test_cached_fit_per_shard_blocks(world_a, ref):
    """Each rank stores only its row block of K_nM, equal to the reference's
    shard of its cache; the cached mesh solve against the reference's, one
    all-reduce a GEMM sweep; the cached mesh fit against one device's; the
    host tier refused under sharding."""
    unit = 4 * 128
    n_pad = math.ceil(FIT_N / unit) * unit
    for i, v in enumerate(world_a):
        assert int(v["cache_n_pad"]) == n_pad
        assert v["cache_block"].shape == (n_pad // 4, FIT_M)
        close(v["cache_block"], ref[f"cache_block_{i}"], SWEEP_TOL)
        assert v["host_refused"] and v["host_fit_refused"]
        assert int(v["cached_psums"]) == FIT_T + 1
    alpha = same_on_every_rank(world_a, "cached_alpha")
    assert rel(alpha, ref["cached_alpha"]) < REF_TOL["alpha"]
    w = world_a[0]
    assert rel(w["cached_pred"], w["ref_fit_pred"]) < REF_TOL["pred"]
    assert rel(w["cfit_pred_m"], w["cfit_pred_1"]) < FIT_TOL
    mat_1, gemm_1, sweeps_1, _ = w["cfit_counts_1"]
    for v in world_a:
        mat, gemm, sweeps, psums = v["cfit_counts_m"]
        assert (mat, gemm, sweeps) == (mat_1, gemm_1, sweeps_1) == (1, 1 + FIT_T + 26, 0)
        assert psums == gemm


def test_minibatch_fit_under_mesh(world_a, ref):
    """The mini-batch fit: on the reference's centers without shuffling
    against the reference's mesh fit, one all-reduce a chunk sweep; from a
    seed with shuffling against one device's."""
    alpha = same_on_every_rank(world_a, "mb_alpha")
    assert rel(alpha, ref["mb_alpha"]) < REF_TOL["alpha"]
    w = world_a[0]
    assert rel(w["mb_pred"], ref["mb_pred"]) < REF_TOL["pred"]
    for v in world_a:
        sweeps, psums, floats = v["mb_counts"]
        assert sweeps == psums and floats == sweeps * FIT_M and sweeps > 0
    assert rel(w["mfit_pred_m"], w["mfit_pred_1"]) < FIT_TOL


@pytest.mark.parametrize("world_name", ["a", "b"])
def test_sharded_loader_matches_reference_shards(request, ref, world_name):
    """Each rank's batch holds the reference's addressable shard of every
    array whose rows divide by the first data axis, the whole array
    otherwise; non-arrays pass through."""
    world = request.getfixturevalue(f"world_{world_name}")
    batches = loader_batches()
    for w in world:
        key = "_".join(str(int(c)) for c in w["coord"])
        for i, batch in enumerate(batches):
            for k, a in batch.items():
                got = w[f"load_{i}_{k}"]
                if k == "tag":
                    assert str(got) == a
                    continue
                np.testing.assert_array_equal(got, ref[f"load_{world_name}_{i}_{k}_{key}"])


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4])
