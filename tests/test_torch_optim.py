"""The port's optimizers and schedule against the JAX package's.

Both packages get the same numpy parameters and gradients. fp32: the
updates agree to rtol 1e-6, atol 1e-7 (the same formulas, term by term,
except Adafactor's means and the schedule's cosine, which sum and round in
other orders: the last bit). bf16 parameters: equal (each update is taken
in fp32 and rounded once to bf16; a last-bit difference in fp32 may flip
that rounding, so they are held to one bf16 unit, 2^-8 relative). The
moments are fp32 in both: rtol 1e-5. Adafactor on a ``LeafGroup`` (the
port's tensors of one period slot) is held to the reference's update of
the stacked leaf. Then the counterparts of ``tests/test_substrates.py``'s
optimizer tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as R
from repro_torch.models import LeafGroup
from repro_torch.optim import optimizers as P

SHAPES = {"w": (8, 4), "b": (4,), "s": (3, 5, 6)}
F32 = dict(rtol=1e-6, atol=1e-7)
BF16 = dict(rtol=2.0 ** -8, atol=0.0)
STATE = dict(rtol=1e-5, atol=1e-12)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


def _j(a, dt):
    return jnp.asarray(a).astype(dt)


def _t(a, dt):
    return torch.from_numpy(np.array(a)).to(getattr(torch, dt))


def _same_leaves(got, ref, tol, what):
    flat_j = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_t = P.tree_leaves(got)
    assert len(flat_j) == len(flat_t), what
    for (path, r), g in zip(flat_j, flat_t):
        np.testing.assert_allclose(_np(g), _np(r), **tol,
                                   err_msg=f"{what}{jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgdm"])
def test_update_matches_reference(name, dtype):
    """Five updates on identical gradients under the warmup-cosine schedule:
    parameters and optimizer state."""
    rng = np.random.default_rng(0)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    jp = {k: _j(v, dtype) for k, v in p0.items()}
    tp = {k: _t(v, dtype) for k, v in p0.items()}
    ropt, popt = R.make_optimizer(name), P.make_optimizer(name)
    js, ts = ropt.init(jp), popt.init(tp)
    jlr, tlr = R.warmup_cosine(1e-2, 2, 10), P.warmup_cosine(1e-2, 2, 10)
    for _ in range(5):
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
        jp, js = ropt.update({k: _j(v, dtype) for k, v in g.items()}, js, jp, jlr(js["step"]))
        tp2, ts2 = popt.update({k: _t(v, dtype) for k, v in g.items()}, ts, tp, tlr(ts["step"]))
        assert tp2 is tp and ts2 is ts       # in place
    for k in SHAPES:
        assert tp[k].dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), **(F32 if dtype == "float32" else BF16),
                                   err_msg=f"{name} {dtype}: {k}")
        assert not np.allclose(_np(tp[k]), p0[k])
    assert int(ts["step"]) == int(js["step"]) == 5 and ts["step"].dtype == torch.int32
    _same_leaves(ts, js, STATE, f"{name} {dtype} state")


def test_adafactor_groups_are_the_stacked_leaf():
    """A LeafGroup of 3 tensors is updated as the reference's stacked leaf:
    a 1-D parameter becomes 2-D (factored moments, vc a mean over the
    repeats) and the update RMS spans all repeats. Updating each tensor
    alone differs."""
    rng = np.random.default_rng(1)
    stacked = {"ln": rng.standard_normal((3, 16)).astype(np.float32),
               "w": rng.standard_normal((3, 6, 5)).astype(np.float32)}
    ropt, popt = R.adafactor(), P.adafactor()
    jp = {k: jnp.asarray(v) for k, v in stacked.items()}
    js = ropt.init(jp)
    tensors = {k: [torch.from_numpy(v[r].copy()) for r in range(3)] for k, v in stacked.items()}
    tp = {k: LeafGroup(ts) for k, ts in tensors.items()}
    ts = popt.init(tp)
    assert tuple(ts["f"]["ln"]["vr"].shape) == (3,) and tuple(ts["f"]["ln"]["vc"].shape) == (16,)
    alone = {k: [t.clone() for t in ts_] for k, ts_ in tensors.items()}
    alone_state = {k: [popt.init({"x": t}) for t in ts_] for k, ts_ in alone.items()}
    for _ in range(4):
        g = {k: (rng.standard_normal(v.shape) * rng.uniform(0.1, 10, (3,) + (1,) * (v.ndim - 1))
                 ).astype(np.float32) for k, v in stacked.items()}
        jp, js = ropt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp, 1e-2)
        popt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp, 1e-2)
        for k in g:
            for r in range(3):
                popt.update({"x": torch.from_numpy(g[k][r])}, alone_state[k][r],
                            {"x": alone[k][r]}, 1e-2)
    for k in stacked:
        got = np.stack([t.numpy() for t in tensors[k]])
        np.testing.assert_allclose(got, np.asarray(jp[k]), **F32, err_msg=k)
        per_tensor = np.stack([t.numpy() for t in alone[k]])
        assert np.abs(per_tensor - got).max() > 1e-4, k
    _same_leaves(ts, js, STATE, "adafactor grouped state")


@pytest.mark.parametrize("make_opt", [P.adamw, P.adafactor, P.sgdm])
def test_optimizers_reduce_quadratic(make_opt):
    opt = make_opt()
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(8, 4, generator=g), "b": torch.ones(4)}
    target = {k: torch.full_like(v, 0.5) for k, v in params.items()}

    def loss(p):
        return sum(torch.sum((p[k] - target[k]) ** 2) for k in p)

    state = opt.init(params)
    l0 = float(loss(params))
    for _ in range(60):
        grads = {k: 2 * (v - target[k]) for k, v in params.items()}
        params, state = opt.update(grads, state, params, 0.05)
    assert float(loss(params)) < 0.05 * l0


def test_adafactor_state_is_sublinear():
    st = P.adafactor().init({"w": torch.zeros(256, 512)})
    assert sum(x.numel() for x in P.tree_leaves(st)) < 256 * 512 / 50


def test_clip_by_global_norm_matches_reference():
    """Clipped to norm 1 (the counterpart's check), and each leaf cast back
    to its dtype after an fp32 scale, as the reference: bf16 leaves equal."""
    tree = {"a": torch.full((10,), 10.0)}
    clipped, norm = P.clip_by_global_norm(tree, 1.0)
    assert abs(float(P.global_norm(clipped)) - 1.0) < 1e-5 and float(norm) > 30
    rng = np.random.default_rng(2)
    raw = {"x": rng.standard_normal((7, 3)).astype(np.float32),
           "y": {"z": (rng.standard_normal(5) * 4).astype(np.float32)}}
    for dt in ("float32", "bfloat16"):
        jt = jax.tree.map(lambda a: _j(a, dt), raw)
        tt = {"x": _t(raw["x"], dt), "y": {"z": _t(raw["y"]["z"], dt)}}
        jc, jn = R.clip_by_global_norm(jt, 0.5)
        tc, tn = P.clip_by_global_norm(tt, 0.5)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        assert tc["x"].dtype == getattr(torch, dt)
        np.testing.assert_allclose(_np(tc["x"]), _np(jc["x"]), rtol=1e-6, atol=0)
        np.testing.assert_allclose(_np(tc["y"]["z"]), _np(jc["y"]["z"]), rtol=1e-6, atol=0)


def test_warmup_cosine_every_step():
    """The schedule at each step of a 100-step run, float32 in both: the
    reference's values to 4 float32 units (the cosine's last bit, carried
    through 0.1 + 0.9 (1 + cos) / 2), and the
    counterpart's three checks."""
    jlr, tlr = R.warmup_cosine(1e-3, warmup=10, total=100), P.warmup_cosine(1e-3, 10, 100)
    got = np.array([float(tlr(torch.tensor(s, dtype=torch.int32))) for s in range(100)])
    ref = np.array([float(jlr(jnp.asarray(s, jnp.int32))) for s in range(100)])
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -21, atol=0)
    assert tlr(torch.tensor(3)).dtype == torch.float32
    assert got[0] < 2e-4 and abs(got[10] - 1e-3) < 1e-4 and got[99] < 3e-4
