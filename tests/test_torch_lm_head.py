"""A FALKON head on an LM's frozen features, in both packages.

The recipe of ``examples/train_lm_falkon_head.py`` (its second half) at the
reduced gemma3-1b: ``_backbone`` features of the synthetic token stream,
an 8-way target ``tokens % 8`` as one-hot columns, an 80/20 split, and a
Gaussian FALKON fit at lam = 1e-6, t = 15, with sigma the median pairwise
distance of the training rows (``_backbone`` ends in ``rms_norm``, so
rows sit about sqrt(2 d) apart whatever the width).

The port's features are held to the reference's ``_backbone`` at
rtol = atol = 1e-4; the head is the reference's fit on the reference's
features, whose centers and preconditioner are handed to the port's
``falkon_solve`` on its "torch" and "cuda" backends (the CPU twins here),
held by the bounds of ``tests/test_torch_falkon.py`` at that file's
lam = 1e-3: residuals and predictions by its ``BOUNDS``, alpha by its
larger ``LAPLACIAN_BOUNDS`` alpha bound (measured here 7.6e-4 normwise,
CG converged to a residual of 1e-7 where fp32 rounding alone moves alpha).
At the example's lam = 1e-6 the two packages' fp32 rounding moves alpha by
1.2e-3 and the predictions by 3.9e-4 (measured at M = 128; 2.9e-3 and
1.2e-3 at M = 256), so that fit is held by its predictions at 1e-3 and by
every predicted class. The reduced
model's random weights leave little of the token in its 64-wide features,
so these tests hold the packages to each other, not to the example's
accuracy bar (``chip_smoke.py``'s phase ``lm`` reads the full-width
head's accuracy on the H100).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FalkonConfig as JConfig
from repro.core import falkon_fit as jfit
from repro.data import TokenStreamConfig as JTokenStreamConfig
from repro.data import token_stream as j_token_stream
from repro.models.model import _backbone as j_backbone
from repro_torch import FalkonEstimator, falkon_fit, falkon_solve
from repro_torch.convert import preconditioner_from_numpy
from repro_torch.core import FalkonConfig, make_kernel
from repro_torch.data import TokenStreamConfig, token_stream
from repro_torch.models.model import _backbone
from test_torch_falkon import BOUNDS, LAPLACIAN_BOUNDS, rel
from torch_lm_parity import _one_thread, both, close  # noqa: F401

ARCH = "gemma3-1b"
STREAM = dict(vocab=512, seq_len=64, batch=8)
BATCHES, M, LAM, T_ITERS = 2, 128, 1e-6, 15
PARITY_LAM = 1e-3                     # tests/test_torch_falkon.py's LAM
SMALL_LAM_PRED = 1e-3


def median_distance(X: np.ndarray, rows: int = 512) -> float:
    Xd = X[:rows].astype(np.float64)
    d2 = (Xd * Xd).sum(1)[:, None] + (Xd * Xd).sum(1)[None] - 2 * Xd @ Xd.T
    iu = np.triu_indices(len(Xd), 1)
    return float(np.median(np.sqrt(np.maximum(d2[iu], 0))))


@pytest.fixture(scope="module")
def features():
    """Both packages' features of the same token batches, and the targets."""
    jcfg, tcfg, params, model = both(ARCH)
    js = j_token_stream(JTokenStreamConfig(**STREAM), seed=7)
    ts = token_stream(TokenStreamConfig(**STREAM), seed=7)
    jf, tf, ys = [], [], []
    with torch.no_grad():
        for _ in range(BATCHES):
            jb, tb = next(js), next(ts)
            jf.append(np.asarray(j_backbone(params, jcfg, {"tokens": jb["tokens"]}))
                      .reshape(-1, jcfg.d_model))
            tf.append(_backbone(model, tcfg, {"tokens": tb["tokens"]}).reshape(-1, tcfg.d_model))
            ys.append(tb["tokens"].reshape(-1).numpy() % 8)
    return np.concatenate(jf), torch.cat(tf), np.concatenate(ys)


def test_features_match_reference(features):
    jX, tX, _ = features
    assert tX.shape == (BATCHES * STREAM["batch"] * STREAM["seq_len"], 64)
    close(tX, jX, "_backbone features")


@pytest.mark.parametrize("lam", [PARITY_LAM, LAM])
def test_head_solve_matches_reference_fit(features, lam):
    jX, tX, ylab = features
    X = jX.astype(np.float32)
    Y = np.eye(8, dtype=np.float32)[ylab]
    ntr = int(0.8 * X.shape[0])
    sigma = median_distance(X[:ntr])
    assert 0.5 * np.sqrt(2 * 64) < sigma < 2 * np.sqrt(2 * 64)
    params = (("sigma", sigma),)
    jcfg = JConfig(kernel="gaussian", kernel_params=params, lam=lam, num_centers=M,
                   iterations=T_ITERS, block_size=128)
    jest, jst = jfit(jax.random.PRNGKey(0), jnp.asarray(X[:ntr]), jnp.asarray(Y[:ntr]), jcfg)
    jpred = np.asarray(jest.predict(jnp.asarray(X[ntr:])))

    kern = make_kernel("gaussian", sigma=sigma)
    Ct = torch.from_numpy(np.asarray(jst.centers).copy())
    P = preconditioner_from_numpy(dict(T=np.asarray(jst.precond.T), A=np.asarray(jst.precond.A),
                                       n=np.asarray(jst.precond.n)), device="cpu")
    for impl in ("torch", "cuda"):
        st = falkon_solve(torch.from_numpy(X[:ntr]), torch.from_numpy(Y[:ntr]), Ct, P, kern,
                          lam, T_ITERS, ops_impl=impl, block_size=128)
        pred = FalkonEstimator(Ct, st.alpha, kern, ops_impl=impl).predict(
            torch.from_numpy(X[ntr:]))
        if lam == PARITY_LAM:
            assert rel(st.residual_norms, jst.residual_norms) <= BOUNDS["residual"], impl
            assert rel(st.alpha, jst.alpha) <= LAPLACIAN_BOUNDS["alpha"], impl
            assert rel(pred, jpred) <= BOUNDS["pred"], impl
        else:
            assert rel(pred, jpred) <= SMALL_LAM_PRED, impl
        np.testing.assert_array_equal(pred.argmax(-1).numpy(), jpred.argmax(-1))


def test_head_fit_on_port_features(features):
    """The port's whole head, as the smoke runs it on the card: its own
    features, centers and fit on the "cuda" backend (the CPU twins here),
    against the "torch" backend on the same centers."""
    _, tX, ylab = features
    Y = torch.nn.functional.one_hot(torch.from_numpy(ylab).long(), 8).float()
    ntr = int(0.8 * tX.shape[0])
    sigma = median_distance(tX[:ntr].numpy())
    cfg = FalkonConfig(kernel="gaussian", kernel_params=(("sigma", sigma),), lam=LAM,
                       num_centers=M, iterations=T_ITERS, ops_impl="cuda", device="cpu")
    est, _ = falkon_fit(0, tX[:ntr], Y[:ntr], cfg)
    est2, _ = falkon_fit(0, tX[:ntr], Y[:ntr], FalkonConfig(
        kernel="gaussian", kernel_params=(("sigma", sigma),), lam=LAM, num_centers=M,
        iterations=T_ITERS, ops_impl="torch", device="cpu"))
    assert torch.equal(est2.centers, est.centers)
    assert rel(est2.predict(tX[ntr:]), est.predict(tX[ntr:]).numpy()) <= BOUNDS["pred"]
