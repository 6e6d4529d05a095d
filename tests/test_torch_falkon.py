"""The port's fit end to end against the JAX package's ``falkon_fit``.

Centers cannot share a seed across frameworks, so the reference fit's
centers and preconditioner are handed to the port (``repro_torch.convert``)
and the port's ``falkon_solve`` runs on the same X, y. Errors are normwise
relative (||got - ref|| / ||ref||), bounds measured on this CPU and set with
headroom: both packages run fp32 whose sums round in different orders, and
CG plus the triangular solves amplify that by the system's conditioning.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FalkonConfig as JConfig
from repro.core import falkon_fit as jfit
from repro.ops import get_ops as jget_ops
from repro_torch import FalkonConfig, FalkonEstimator, falkon_fit, falkon_solve
from repro_torch.convert import estimator_from_numpy, preconditioner_from_numpy
from repro_torch.core import falkon as tfalkon
from repro_torch.core import make_kernel, make_preconditioner
from repro_torch.ops import CountingOps, PrecisionPolicy, get_ops

ROOT = Path(__file__).resolve().parents[1]
KERNELS = [
    ("gaussian", (("sigma", 2.0),)),
    ("laplacian", (("sigma", 2.0),)),
    ("matern32", (("sigma", 2.0),)),
    ("linear", (("scale", 2.0),)),
    ("polynomial", (("c", 1.0), ("degree", 2), ("scale", 2.0))),
]
N, D, M, T_ITERS, LAM = 384, 5, 48, 10, 1e-3
# The linear and polynomial kernels have finite-rank feature maps: at d = 5
# their K_MM has rank 5 and 21 < M, alpha is not identifiable and both
# packages' alphas differ by null-space noise. Their cases run at a width
# whose feature space covers the M centers, so alpha is well posed.
DIM = {"linear": 64, "polynomial": 16}
# Normwise bounds: the worst case measured over CASES on a CPU, with ~3x
# headroom. The laplacian gets its own K_MM and prediction bounds: on the
# diagonal of K_MM its sqrt turns the fp32 rounding noise of a2 + b2 - 2ab
# (~eps * ||c||^2) into ~1e-3 differences between the packages (measured
# 7.6e-5 normwise on K_MM, 1.0e-4 on predictions, 3.1e-4 on alpha).
BOUNDS = dict(kmm=1e-6, factor=1e-5, residual=3e-5, cond=4e-5, alpha=3e-4, pred=1e-4)
LAPLACIAN_BOUNDS = dict(BOUNDS, kmm=2e-4, alpha=1e-3, pred=3e-4)


def rel(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _problem(seed=0, d=D):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, d)).astype(np.float32)
    y = np.sin(X @ rng.standard_normal(d) / np.sqrt(d / D)).astype(np.float32)
    y += 0.05 * rng.standard_normal(N).astype(np.float32)
    return X, y


CASES = [(k, p, "jnp") for k, p in KERNELS] + [("gaussian", KERNELS[0][1], "pallas")]


@pytest.mark.parametrize("kind,params,ref_impl", CASES)
def test_port_solve_matches_reference_fit(kind, params, ref_impl):
    d = DIM.get(kind, D)
    bounds = LAPLACIAN_BOUNDS if kind == "laplacian" else BOUNDS
    X, y = _problem(d=d)
    jcfg = JConfig(kernel=kind, kernel_params=params, lam=LAM, num_centers=M,
                   iterations=T_ITERS, ops_impl=ref_impl, block_size=128)
    jest, jst = jfit(jax.random.PRNGKey(0), jnp.asarray(X), jnp.asarray(y), jcfg)
    centers = np.asarray(jst.centers)
    kern = make_kernel(kind, **dict(params))
    Ct = torch.from_numpy(centers.copy())

    # K_MM and the factors, built by the port from the same centers
    kmm_ref = np.asarray(jget_ops(ref_impl, jcfg.make_kernel()).gram(jst.centers, jst.centers))
    for impl in ("torch", "cuda"):
        assert rel(get_ops(impl, kern).gram(Ct, Ct), kmm_ref) <= bounds["kmm"]
    P_port = make_preconditioner(torch.from_numpy(kmm_ref.copy()), LAM, N)
    assert rel(P_port.T, jst.precond.T) <= bounds["factor"]
    assert rel(P_port.A, jst.precond.A) <= bounds["factor"]

    # the solve, on the reference's factors, on both port backends
    P = preconditioner_from_numpy(dict(T=np.asarray(jst.precond.T),
                                       A=np.asarray(jst.precond.A),
                                       n=np.asarray(jst.precond.n)), device="cpu")
    X_new = np.random.default_rng(1).standard_normal((100, d)).astype(np.float32)
    pred_ref = np.asarray(jest.predict(jnp.asarray(X_new)))
    for impl in ("torch", "cuda"):
        st = falkon_solve(torch.from_numpy(X), torch.from_numpy(y), Ct, P, kern, LAM,
                          T_ITERS, ops_impl=impl, block_size=128)
        assert st.residual_norms.shape == jst.residual_norms.shape
        assert rel(st.residual_norms, jst.residual_norms) <= bounds["residual"], impl
        assert rel(st.cond_estimate, jst.cond_estimate) <= bounds["cond"], impl
        assert rel(st.alpha, jst.alpha) <= bounds["alpha"], impl
        est = FalkonEstimator(Ct, st.alpha, kern, ops_impl=impl)
        assert rel(est.predict(X_new), pred_ref) <= bounds["pred"], impl


def test_estimator_carried_over_predicts_like_reference():
    kind, params = KERNELS[4]
    X, y = _problem(seed=3, d=DIM[kind])
    jcfg = JConfig(kernel=kind, kernel_params=params, lam=LAM, num_centers=M,
                   iterations=T_ITERS, block_size=128)
    jest, jst = jfit(jax.random.PRNGKey(2), jnp.asarray(X), jnp.asarray(y), jcfg)
    spec = jest.kernel.spec
    est = estimator_from_numpy(
        dict(centers=np.asarray(jest.centers), alpha=np.asarray(jest.alpha)),
        (spec.kind, spec.params),
        precond=dict(T=np.asarray(jst.precond.T), A=np.asarray(jst.precond.A),
                     n=np.asarray(jst.precond.n)),
        lam=LAM, device="cpu")
    assert isinstance(est, torch.nn.Module)
    assert set(est.state_dict()) == {"centers", "alpha"}
    assert est.kernel.spec == type(est.kernel.spec)(spec.kind, spec.params)
    assert est.lam == LAM and est.precond.q == M
    # the same alpha: only the apply's fp32 summation order differs
    assert rel(est.predict(X), np.asarray(jest.predict(jnp.asarray(X)))) <= 1e-5
    torch.testing.assert_close(est(torch.from_numpy(X)), est.predict(X))


def test_port_fit_on_cpu():
    """The port's own pipeline (its own centers) on both backends."""
    X, y = _problem(seed=5)
    base = dict(kernel_params=(("sigma", 2.0),), lam=LAM, num_centers=M,
                iterations=T_ITERS, block_size=128, device="cpu")
    preds = {}
    for impl in ("torch", "cuda"):
        ops = CountingOps(get_ops(impl, make_kernel("gaussian", sigma=2.0), block_size=128))
        times = {}
        est, st = falkon_fit(torch.Generator().manual_seed(0), X, y,
                             FalkonConfig(**base, ops_impl=impl), ops=ops, stage_times=times)
        assert set(times) == {"centers", "gram", "factor", "solve", "factor_path",
                              "factor_block", "factor_stats"}
        assert (times["factor_path"], times["factor_block"]) == ("incore", None)
        # 1 RHS sweep + t CG sweeps + 2 x (12 + 1) power-iteration sweeps
        assert (ops.sweeps, ops.grams) == (1 + T_ITERS + 26, 1)
        res = st.residual_norms
        assert res.shape == (T_ITERS + 1,) and float(res[-1]) < 1e-2 * float(res[0])
        assert 1.0 <= float(st.cond_estimate) < 100.0
        assert est.centers.shape == (M, D) and est.alpha.shape == (M,)
        preds[impl] = est.predict(X)
        mse = float(torch.mean((preds[impl] - torch.from_numpy(y)) ** 2))
        assert mse < 0.5 * float(np.var(y)), mse
    assert rel(preds["cuda"], preds["torch"]) <= 1e-4
    # a seed gives the same centers as the generator it seeds
    est_a, _ = falkon_fit(0, X, y, FalkonConfig(**base, ops_impl="torch"))
    est_b, _ = falkon_fit(torch.Generator().manual_seed(0), X, y,
                          FalkonConfig(**base, ops_impl="torch"))
    assert torch.equal(est_a.centers, est_b.centers)


def test_multi_output_fit():
    X, y = _problem(seed=6)
    Y = np.stack([y, -y, 2 * y], axis=1)
    cfg = FalkonConfig(kernel_params=(("sigma", 2.0),), lam=LAM, num_centers=M,
                       iterations=T_ITERS, device="cpu", ops_impl="cuda")
    est, st = falkon_fit(0, X, Y, cfg)
    assert st.alpha.shape == (M, 3) and st.residual_norms.shape == (T_ITERS + 1, 3)
    torch.testing.assert_close(st.alpha[:, 1], -st.alpha[:, 0], rtol=1e-5, atol=1e-6)


def test_multiclass_fit_on_the_cuda_backend():
    """A 6-class one-vs-all fit (one-hot y, 6 columns: two column groups on
    the "cuda" backend) on the CPU: ``falkon_fit`` fits, agrees with the
    "torch" backend on the same centers, and its solve on the reference
    fit's centers and factors (``repro_torch.convert``) matches the
    reference's residuals within BOUNDS and its alpha and predictions
    within the bounds measured below."""
    X, _ = _problem(seed=8)
    labels = np.argmax(X @ np.random.default_rng(8).standard_normal((D, 6)), axis=1)
    Y = np.eye(6, dtype=np.float32)[labels]
    base = dict(kernel_params=(("sigma", 2.0),), lam=LAM, num_centers=M,
                iterations=T_ITERS, device="cpu")
    est, st = falkon_fit(0, X, Y, FalkonConfig(**base, ops_impl="cuda"))
    est_t, _ = falkon_fit(0, X, Y, FalkonConfig(**base, ops_impl="torch"))
    assert torch.equal(est.centers, est_t.centers)
    assert st.alpha.shape == (M, 6) and st.residual_norms.shape == (T_ITERS + 1, 6)
    assert bool((st.residual_norms[-1] < 1e-2 * st.residual_norms[0]).all())
    pred = est.predict(X)
    assert pred.shape == (N, 6)
    assert rel(pred, est_t.predict(X)) <= 1e-4
    assert float((pred.argmax(1).numpy() == labels).mean()) > 0.5   # chance: 1/6

    jcfg = JConfig(kernel="gaussian", kernel_params=base["kernel_params"], lam=LAM,
                   num_centers=M, iterations=T_ITERS, block_size=128)
    jest, jst = jfit(jax.random.PRNGKey(0), jnp.asarray(X), jnp.asarray(Y), jcfg)
    P = preconditioner_from_numpy(dict(T=np.asarray(jst.precond.T),
                                       A=np.asarray(jst.precond.A),
                                       n=np.asarray(jst.precond.n)), device="cpu")
    Ct = torch.from_numpy(np.asarray(jst.centers).copy())
    kern = make_kernel("gaussian", sigma=2.0)
    solve = {impl: falkon_solve(torch.from_numpy(X), torch.from_numpy(Y), Ct, P, kern, LAM,
                                T_ITERS, ops_impl=impl) for impl in ("cuda", "torch")}
    st = solve["cuda"]
    # the column groups add nothing the plain backend does not round alike
    assert rel(st.alpha, solve["torch"].alpha) <= 1e-5
    assert rel(st.residual_norms, jst.residual_norms) <= BOUNDS["residual"]
    # one-hot targets are worse conditioned than _problem's: on this problem
    # both port backends stand 1.53e-3 (alpha) and 1.48e-4 (predictions)
    # from the reference, whose own one-column solves stand 3.5e-4 to
    # 1.9e-3 from its 6-column solve; ~3x headroom
    assert rel(st.alpha, jst.alpha) <= 5e-3
    X_new = np.random.default_rng(9).standard_normal((100, D)).astype(np.float32)
    pred = FalkonEstimator(Ct, st.alpha, kern, ops_impl="cuda").predict(X_new)
    assert rel(pred, jest.predict(jnp.asarray(X_new))) <= 5e-4


def test_unported_options_refuse():
    base = dict(device="cpu")
    for kw, item in ((dict(precision=PrecisionPolicy(name="fp16", storage="float16")), "A7"),
                     (dict(knm_cache="auto"), "A11"),
                     (dict(mesh=object()), "A14")):
        with pytest.raises(NotImplementedError, match=item):
            FalkonConfig(**base, **kw)
    for kw in (dict(ops_impl="pallas"), dict(knm_cache="sometimes"),
               dict(center_selection="greedy"), dict(dtype="float16")):
        with pytest.raises(ValueError):
            FalkonConfig(**base, **kw)
    for fn, item in ((tfalkon.falkon_fit_streaming, "A8"),
                     (tfalkon.falkon_fit_path_streaming, "A8"),
                     (tfalkon.falkon_solve_path_streaming, "A8"),
                     (tfalkon.falkon_fit_minibatch, "A12")):
        with pytest.raises(NotImplementedError, match=item):
            fn()
    assert (FalkonConfig().device, FalkonConfig().ops_impl) == ("cuda", "cuda")
    if not torch.cuda.is_available():
        X, y = _problem()
        with pytest.raises(RuntimeError, match="cuda"):
            falkon_fit(0, X, y, FalkonConfig(num_centers=8))   # never quietly on the CPU


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_port_is_jax_free():
    """``import repro_torch`` loads no JAX, and no port file (nor
    chip_smoke.py) imports jax or the reference package."""
    code = ("import sys, repro_torch, repro_torch.ops, repro_torch.convert, "
            "repro_torch.data.synthetic, repro_torch.kernels.ops, repro_torch.kernels.ref, "
            "repro_torch.kernels.build; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.')); print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)
