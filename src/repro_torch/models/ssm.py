"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) in torch.

Counterpart of ``repro/models/ssm.py``: the chunked SSD algorithm for train
and prefill (quadratic within a chunk of ``cfg.ssm_chunk``, recurrent
across chunks, a Python loop over the chunks) and the O(1) recurrent update
for decode. B/C are shared across heads (n_groups = 1), heads H = d_inner /
head_dim.

Recurrence (head h, step i):
    a_i = exp(dt_i * A_h)            (A_h < 0)
    h_i = a_i * h_{i-1} + dt_i * B_i (x) x_i
    y_i = C_i . h_i + D_h * x_i
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.mesh import local_apply, lshard
from .layers import rms_norm
from .params import PD, ParamModule

Tensor = torch.Tensor


def ssm_pd(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    di, N, H, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    return {
        "w_x": PD((D, di), ("embed", "ff")),
        "w_z": PD((D, di), ("embed", "ff")),
        "w_B": PD((D, N), ("embed", None)),
        "w_C": PD((D, N), ("embed", None)),
        "w_dt": PD((D, H), ("embed", "heads")),
        "dt_bias": PD((H,), ("heads",), "zeros"),
        "conv_w": PD((K, di + 2 * N), (None, "ff"), scale=0.2),
        "A_log": PD((H,), ("heads",), "ssm_A"),
        "D_skip": PD((H,), ("heads",), "ones"),
        "out_norm": PD((di,), ("ff",), "ones"),
        "w_out": PD((di, D), ("ff", "embed")),
    }


class Mamba2Mixer(ParamModule):
    def __init__(self, cfg: ModelConfig, *, dtype, device=None):
        super().__init__(ssm_pd(cfg), dtype=dtype, device=device)

    def forward(self, x, cfg, *, cache=None):
        return ssm_apply(self, x, cfg, cache=cache)


def _causal_conv(xBC: Tensor, w: Tensor) -> Tensor:
    """Depthwise causal conv, xBC: (B,S,Ch), w: (K,Ch)."""
    K = w.shape[0]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = torch.zeros_like(xBC)
    for i in range(K):                       # K is tiny (4): unrolled taps
        out = out + pad[:, i:i + xBC.shape[1]] * w[i]
    return out


def ssm_apply(p: Mamba2Mixer, x_in: Tensor, cfg: ModelConfig, *, cache: dict | None = None):
    """x_in: (B,S,D). Returns (out, new_cache).

    cache (decode): {"state": (B,H,N,P), "conv": (B,K-1,di+2N)}; the state
    is carried in fp32 once a prefill or a step has written it.
    """
    B, S, D = x_in.shape
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    P_ = cfg.ssm_head_dim
    K = cfg.ssm_conv

    xz = x_in @ p.w_x                                               # (B,S,di)
    z = x_in @ p.w_z
    Bc = x_in @ p.w_B
    Cc = x_in @ p.w_C
    dt = F.softplus((x_in @ p.w_dt).float() + p.dt_bias.float())    # (B,S,H)
    A = -torch.exp(p.A_log.float())                                  # (H,)
    xBC = torch.cat([xz, Bc, Cc], -1)                                # (B,S,di+2N)

    # on a mesh each rank convolves its batch rows, every channel
    conv = lambda t, w: F.silu(_causal_conv(t, w))
    if cache is None:
        xBC = local_apply(conv, (xBC, p.conv_w), _CONV_AXES, ("batch", None, None))
        new_cache = None
    else:
        window = torch.cat([cache["conv"].to(xBC.dtype), xBC], 1)   # (B,K-1+S,Ch)
        xBC = local_apply(conv, (window, p.conv_w), _CONV_AXES,
                          ("batch", None, None))[:, K - 1:]          # aligned outputs
        new_cache = {"conv": window[:, -(K - 1):]}

    xs, Bs, Cs = torch.split(xBC, [di, N, N], dim=-1)
    xh = lshard(xs.reshape(B, S, H, P_), ("batch", None, "heads", None))

    if cache is not None and S == 1:
        # O(1) decode update
        a = torch.exp(dt[:, 0] * A)                                  # (B,H)
        dBx = torch.einsum("bh,bn,bhp->bhnp", dt[:, 0], Bs[:, 0].float(), xh[:, 0].float())
        state = cache["state"] * a[..., None, None] + dBx            # (B,H,N,P)
        y = torch.einsum("bn,bhnp->bhp", Cs[:, 0].float(), state)
        y = y + p.D_skip.float()[None, :, None] * xh[:, 0]
        y = y.reshape(B, 1, di).to(x_in.dtype)
        new_cache = {"state": state, "conv": new_cache["conv"]}
    else:
        # on a mesh each rank scans its block of batch rows and heads
        y, state = local_apply(lambda *a: _ssd_chunked(*a, cfg),
                               (xh, dt, A, Bs, Cs, p.D_skip), _SSD_AXES,
                               [("batch", None, "heads", None), ("batch", "heads", None, None)])
        if cache is not None:
            new_cache = {"state": state, "conv": new_cache["conv"]}
        y = y.reshape(B, S, di).to(x_in.dtype)

    y = rms_norm(y * F.silu(z), p.out_norm, cfg.norm_eps)
    return y @ p.w_out, new_cache


#: the convolution's input and taps (``local_apply``)
_CONV_AXES = (("batch", None, None), (None, None))
#: ``_ssd_chunked``'s operands' logical axes (``local_apply``)
_SSD_AXES = (("batch", None, "heads", None), ("batch", None, "heads"), ("heads",),
             ("batch", None, None), ("batch", None, None), ("heads",))


def _ssd_chunked(xh: Tensor, dt: Tensor, A: Tensor, Bs: Tensor, Cs: Tensor, D_skip: Tensor,
                 cfg: ModelConfig):
    """Chunked SSD, sequential over chunks. xh: (B,S,H,P); dt: (B,S,H) fp32;
    A: (H,) fp32; Bs/Cs: (B,S,N). Returns (y (B,S,H,P) fp32, state (B,H,N,P)
    fp32). Padded steps have dt = 0: they neither decay nor feed the state."""
    B, S, H, P_ = xh.shape
    N = Bs.shape[-1]
    Q = min(cfg.ssm_chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bs = F.pad(Bs, (0, 0, 0, pad))
        Cs = F.pad(Cs, (0, 0, 0, pad))

    out_dtype = xh.dtype
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))[None, :, :, None]
    D32 = D_skip.float()[None, None, :, None]
    h = torch.zeros((B, H, N, P_), dtype=torch.float32, device=xh.device)
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        x_, dt_ = xh[:, sl].float(), dt[:, sl]
        B_, C_ = Bs[:, sl].float(), Cs[:, sl].float()
        l = dt_ * A                                                  # (B,Q,H) <= 0
        cl = torch.cumsum(l, dim=1)
        # intra: scores[i,j] = (C_i.B_j) exp(cl_i - cl_j) dt_j, j <= i; the
        # exponent is masked to -inf BEFORE exp (it is positive for j > i)
        CB = torch.einsum("bin,bjn->bij", C_, B_)
        diff = cl[:, :, None, :] - cl[:, None, :, :]                 # (B,i,j,H)
        decay = torch.exp(torch.where(tri, diff, float("-inf")))
        y = torch.einsum("bijh,bjh,bjhp->bihp", CB[..., None] * decay, dt_, x_)
        # inter: y_i += C_i . (exp(cl_i) h_prev)
        y = y + torch.einsum("bin,bih,bhnp->bihp", C_, torch.exp(cl), h)
        y = y + D32 * x_
        # state update
        dec_end = torch.exp(cl[:, -1:, :] - cl)                      # (B,Q,H)
        h = h * torch.exp(cl[:, -1, :])[..., None, None] + torch.einsum(
            "bjh,bjh,bjn,bjhp->bhnp", dec_end, dt_, B_, x_)
        ys.append(y.to(out_dtype))
    y = torch.cat(ys, dim=1)[:, :S]
    return y.float(), h
