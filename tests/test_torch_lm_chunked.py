"""The port's chunked attention and converted caches against the JAX package's.

S = 80 runs above the reduced configs' ``dense_attn_max_seq`` = 64 with
window 8 and chunk 16, so query blocks meet KV chunks whose keys are all
outside their window; a reference cache carried across by
``convert.cache_from_numpy`` decodes on as the reference's does. Helpers
and conventions in ``tests/torch_lm_parity.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro_torch import models as tm
from repro_torch.convert import cache_from_numpy
from torch_lm_parity import J, T, _one_thread, both, close, make_batch, run_serving  # noqa: F401


@pytest.mark.parametrize("arch", ["gemma3-1b", "minicpm3-4b", "jamba-1.5-large-398b"])
def test_chunked_attention_matches_reference(arch):
    """S = 80 > dense_attn_max_seq: the chunked online softmax (sliding
    window 8, chunk 16: fully masked chunks; MLA's expanded keys; jamba's
    attention layer beside five SSD chunks), in forward and prefill, then
    two decode steps; and the chunked forward against the same weights
    under a dense limit of 128."""
    jcfg, tcfg, params, model = both(arch)
    assert 80 > tcfg.dense_attn_max_seq and tcfg.attn_chunk == 16
    batch = make_batch(jcfg, 1, 80, seed=3)
    got = tm.forward(model, tcfg, T(batch))
    close(got, jm.forward(params, jcfg, J(batch)), f"{arch}: chunked forward")
    dense = tm.forward(model, dataclasses.replace(tcfg, dense_attn_max_seq=128), T(batch))
    close(got, dense, f"{arch}: chunked vs dense")
    run_serving(arch, B=1, S=82, k=80)


def test_cache_from_numpy_round_trip():
    """A reference cache carried across decodes on in the port as it does in
    the reference (jamba: SSD state and conv window, attention k/v)."""
    arch = "jamba-1.5-large-398b"
    jcfg, tcfg, params, model = both(arch)
    batch = make_batch(jcfg, 2, 20, seed=5)
    _, jcache = jm.prefill(params, jcfg, {"tokens": jnp.asarray(batch["tokens"][:, :12])},
                           S_max=20)
    tcache = cache_from_numpy(jax.tree.map(np.asarray, jcache), tcfg, device="cpu")
    assert tcache["layers"][1]["state"].dtype == torch.float32
    for t in range(12, 15):
        tok = batch["tokens"][:, t]
        jl, jcache = jm.decode_step(params, jcfg, jcache, {"token": jnp.asarray(tok)})
        tl, tcache = tm.decode_step(model, tcfg, tcache, {"token": torch.from_numpy(tok)})
        close(tl, jl, f"decode from a converted cache, step {t}")
