"""A float16 storage policy in the port against the JAX package's.

``PrecisionPolicy(storage="float16", compensated=True)`` runs like the bf16
policy: X, C, v, the CG iterates and B4's t spill stored float16, every
contraction accumulated in float32 with Kahan carries, K_MM, the factors
and the coefficients float32. On the CPU the wrappers of B1, B2 and B4 run
their compensated twins (float16 widened to fp32 on load, exactly); the
JAX side runs ``fused_sweep_pallas`` / ``kernel_matmul_pallas`` /
``sharded_sweep_pallas`` with ``compensated=True`` in interpret mode, as
its own tests do. The float16 builds themselves (``kernel_matvec_f16c.cu``)
run only on the card, where ``python3 chip_smoke.py`` holds them against
these twins.

Tolerances, normwise relative, each measured on the CPU and set with ~3x
headroom:

* twins against the Pallas kernels on float16 inputs: fp32 outputs of B1
  and B2 1.5e-6 (measured <= 5.0e-7: the tiles sum in other orders);
  float16 outputs, and B4's fp32 output after its float16 t spill, 2^-12
  (measured <= 5.3e-5 and 2.4e-5: an entry whose fp32 sums fall either
  side of a float16 rounding boundary, 2^-11 apart, rounds to the
  neighbouring value; B4 then carries that into w);
* the backends under the policy against the reference's: 2e-6 (measured
  <= 1.9e-7);
* a float16 fit on the reference's centers and factors against the
  reference's float16 fit (M = 192, lam = 1e-3): alpha 2e-3, predictions
  1.5e-3, residual norms 1e-4 (measured 6.8e-4, 4.9e-4, 2.7e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ops as jops
from repro.core import FalkonConfig as JConfig
from repro.core import falkon_fit as jfit
from repro.core import kernels as jk
from repro.kernels.kernel_matvec import (
    fused_sweep_pallas,
    kernel_matmul_pallas,
    sharded_sweep_pallas,
)
from repro_torch import FalkonConfig, FalkonEstimator, falkon_fit, falkon_solve
from repro_torch.convert import preconditioner_from_numpy
from repro_torch.core import make_kernel
from repro_torch.kernels import kernel_matvec as km
from repro_torch.ops import PrecisionPolicy, get_ops

KERNELS = [
    ("gaussian", dict(sigma=1.3)),
    ("laplacian", dict(sigma=1.1)),
    ("matern32", dict(sigma=1.7)),
    ("linear", dict(scale=1.5)),
    ("polynomial", dict(degree=2, c=0.5, scale=2.0)),
]
F16, JF16 = torch.float16, jnp.float16
F32_TOL, F16_TOL = 1.5e-6, 2.0 ** -12
FIT_BOUNDS = dict(alpha=2e-3, pred=1.5e-3, residual=1e-4)
POLICY = PrecisionPolicy(name="fp16", storage="float16", compensated=True)
JPOLICY = jops.PrecisionPolicy(name="fp16", storage="float16", compensated=True)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: small tensors, beside the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel(got, ref) -> float:
    got = got.double().numpy() if isinstance(got, torch.Tensor) else np.asarray(
        jnp.asarray(got).astype(jnp.float32), np.float64)
    ref = ref.double().numpy() if isinstance(ref, torch.Tensor) else np.asarray(
        jnp.asarray(ref).astype(jnp.float32), np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _f16(*arrays):
    """The same arrays as float16 tensors for the port and float16 arrays for
    the reference (one rounding each, to nearest even in both)."""
    return ([torch.from_numpy(a).to(F16) for a in arrays],
            [jnp.asarray(a).astype(JF16) for a in arrays])


@pytest.mark.parametrize("p", [1, 4, 5])
@pytest.mark.parametrize("name,params", KERNELS)
def test_f16_twins_match_pallas(name, params, p):
    """B1, B2 and B4 on float16 inputs: the compensated twins against the
    reference's compensated Pallas kernels, fp32 and float16 results."""
    rng = np.random.default_rng(p + len(name))
    n, M, d = 300, 97, 13
    X, C = (rng.standard_normal(s).astype(np.float32) for s in ((n, d), (M, d)))
    u, v = (rng.standard_normal(s).astype(np.float32) for s in ((M, p), (n, p)))
    jspec, tspec = jk.spec_of(jk.make_kernel(name, **params)), make_kernel(name, **params).spec
    (Xt, Ct, ut, vt), (Xj, Cj, uj, vj) = _f16(X, C, u, v)
    u32, uj32 = torch.from_numpy(u), jnp.asarray(u)
    kw = dict(spec=jspec, compensated=True, interpret=True)

    # B1: u at fp32 (w fp32, the policy's), and all in float16 (w float16)
    w = km.fused_sweep(Xt, Ct, u32, vt, spec=tspec, compensated=True)
    assert w.dtype == torch.float32
    assert rel(w, fused_sweep_pallas(Xj, Cj, uj32, vj, **kw)) <= F32_TOL
    w = km.fused_sweep(Xt, Ct, ut, vt, spec=tspec, compensated=True)
    ref = fused_sweep_pallas(Xj, Cj, uj, vj, **kw)
    assert w.dtype == F16 and ref.dtype == JF16
    assert rel(w, ref) <= F16_TOL

    # B2: fp32 out; float16 out with add (B4's t spill)
    out = km.kernel_matmul(Xt, Ct, u32, spec=tspec, compensated=True)
    assert rel(out, kernel_matmul_pallas(Xj, Cj, uj32, **kw)) <= F32_TOL
    out = km.kernel_matmul(Xt, Ct, u32, vt, spec=tspec, compensated=True, out_dtype=F16)
    ref = kernel_matmul_pallas(Xj, Cj, uj32, add=vj, out_dtype=JF16, **kw)
    assert out.dtype == F16 and rel(out, ref) <= F16_TOL

    # B4: t spilled in float16, w fp32, ragged 64-row shards; all in float16
    w = km.sharded_sweep(Xt, Ct, u32, vt, spec=tspec, shard_m=64, compensated=True,
                         t_dtype=F16, out_dtype=torch.float32)
    ref = sharded_sweep_pallas(Xj, Cj, uj32, vj, shard_m=64, t_dtype=JF16,
                               out_dtype=jnp.float32, **kw)
    assert w.dtype == torch.float32 and rel(w, ref) <= F16_TOL
    w = km.sharded_sweep(Xt, Ct, ut, vt, spec=tspec, shard_m=64, compensated=True)
    ref = sharded_sweep_pallas(Xj, Cj, uj, vj, shard_m=64, **kw)
    assert w.dtype == F16 and ref.dtype == JF16 and rel(w, ref) <= F16_TOL


def test_f16_policy_runs_on_both_backends():
    """The policy is accepted everywhere a name is: the backends sweep and
    apply at fp32 coefficient width (the coeffs override) and plan float16
    storage; without compensation float16 X widens exactly to fp32."""
    rng = np.random.default_rng(2)
    X, C = rng.standard_normal((96, 7)).astype(np.float32), rng.standard_normal(
        (48, 7)).astype(np.float32)
    u, v = rng.standard_normal(48).astype(np.float32), rng.standard_normal(96).astype(np.float32)
    kern = make_kernel("gaussian", sigma=1.5)
    for impl, ref_impl in (("torch", "jnp"), ("cuda", "pallas")):
        ops = get_ops(impl, kern, block_size=64, precision=POLICY)
        ref = jops.get_ops(ref_impl, jk.make_kernel("gaussian", sigma=1.5), block_size=64,
                           precision=JPOLICY)
        w = ops.sweep(*map(torch.from_numpy, (X, C)), torch.from_numpy(u).to(F16),
                      torch.from_numpy(v))
        assert w.dtype == torch.float32, impl
        assert rel(w, ref.sweep(*map(jnp.asarray, (X, C)), jnp.asarray(u).astype(JF16),
                                jnp.asarray(v))) <= 2e-6, impl
        plan = ops.plan(96, 48, 7, 1)
        assert (plan.input_dtype, plan.vector_dtype, plan.coeffs_dtype) == (
            "float16", "float16", "float32")
    plain = PrecisionPolicy(name="f16-plain", storage="float16")
    Xh, Ch = torch.from_numpy(X).to(F16), torch.from_numpy(C).to(F16)
    spec = kern.spec
    assert torch.equal(km.fused_sweep(Xh, Ch, torch.from_numpy(u), spec=spec),
                       km.fused_sweep(Xh.float(), Ch, torch.from_numpy(u), spec=spec))
    get_ops("cuda", kern, precision=plain)


def test_f16_fit_matches_reference_fit():
    """A small float16 fit (M = 192, lam = 1e-3) on the reference's centers
    and factors: the port's solve on the "cuda" backend (its twins on the
    CPU) against the reference's float16 fit ("jnp"), and the port's own fit
    end to end: CG iterates stored float16, coefficients fp32."""
    rng = np.random.default_rng(5)
    n, d, M, t, lam = 2048, 6, 192, 12, 1e-3
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (np.sin(X @ rng.standard_normal(d)) + 0.05 * rng.standard_normal(n)).astype(np.float32)
    params = (("sigma", 2.0),)
    jcfg = JConfig(kernel="gaussian", kernel_params=params, lam=lam, num_centers=M,
                   iterations=t, ops_impl="jnp", block_size=512, precision=JPOLICY)
    jest, jst = jfit(jax.random.PRNGKey(0), jnp.asarray(X), jnp.asarray(y), jcfg)
    Ct = torch.from_numpy(np.asarray(jst.centers).copy())
    P = preconditioner_from_numpy(dict(T=np.asarray(jst.precond.T), A=np.asarray(jst.precond.A),
                                       n=np.asarray(jst.precond.n)), device="cpu")
    kern = make_kernel("gaussian", sigma=2.0)
    X_new = rng.standard_normal((200, d)).astype(np.float32)
    st = falkon_solve(torch.from_numpy(X), torch.from_numpy(y), Ct, P, kern, lam, t,
                      ops_impl="cuda", block_size=512, precision=POLICY)
    assert st.beta.dtype == F16 and st.alpha.dtype == torch.float32
    assert rel(st.alpha, jst.alpha) <= FIT_BOUNDS["alpha"]
    assert rel(st.residual_norms, jst.residual_norms) <= FIT_BOUNDS["residual"]
    est = FalkonEstimator(Ct, st.alpha, kern, ops_impl="cuda", precision=POLICY)
    assert rel(est.predict(X_new), jest.predict(jnp.asarray(X_new))) <= FIT_BOUNDS["pred"]
    cfg = FalkonConfig(kernel="gaussian", kernel_params=params, lam=lam, num_centers=M,
                       iterations=t, block_size=512, precision=POLICY, device="cpu")
    est2, st2 = falkon_fit(0, X, y, cfg)
    assert st2.beta.dtype == F16 and bool(torch.isfinite(st2.alpha).all())
    assert float(st2.residual_norms[-1]) < float(st2.residual_norms[0])
