"""Prefill and decode of the port's LMs against the JAX package's.

For each reduced config (fp32), on the reference's weights carried across
by ``convert.model_params_from_numpy`` and the same numpy tokens: the
prefill logits and every cache leaf, each decode step's logits, and the
caches the steps leave, at rtol = atol = 1e-4 (helpers and conventions in
``tests/torch_lm_parity.py``); and the port's decode against its own
teacher-forced forward within the reference test's bounds.
"""
import pytest
import torch

from repro import configs as jc
from repro_torch import models as tm
from torch_lm_parity import _one_thread, close, run_serving  # noqa: F401


@pytest.mark.parametrize("arch", jc.ARCH_IDS)
def test_prefill_and_decode_match_reference(arch):
    """prefill of 16 tokens into a cache of 24, then 8 decode steps, against
    the reference, and against the port's own teacher-forced forward within
    the reference test's bounds (2e-3 prefill, 5e-3 decode)."""
    tcfg, model, batch = run_serving(arch, B=2, S=24, k=16)
    full = tm.forward(model, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()
                                    if k in ("tokens", "vision_embeds")})
    tl, cache = tm.prefill(model, tcfg, {k: torch.from_numpy(v[:, :16] if k == "tokens" else v)
                                         for k, v in batch.items()
                                         if k in ("tokens", "vision_embeds")}, S_max=24)
    close(tl, full[:, 15], f"{arch}: prefill vs forward", rtol=2e-3, atol=2e-3)
    for t in range(16, 24):
        tl, cache = tm.decode_step(model, tcfg, cache,
                                   {"token": torch.from_numpy(batch["tokens"][:, t])})
        close(tl, full[:, t], f"{arch}: decode vs forward {t}", rtol=5e-3, atol=5e-3)
