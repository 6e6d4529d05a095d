"""int8 symmetric quantization with error feedback.

Counterpart of ``repro/distributed/compression.py``. ``quantize_int8``
rounds a tensor to int8 with one scale, ``max|x| / 127`` clamped at 1e-30,
rounding half to even (as ``jnp.round``); ``DistributedOps(compress=
"int8")`` sends each rank's (M, p) sweep partial through that round trip
before its all-reduce. The tree helpers apply it with an error-feedback
residual (Karimireddy et al. 2019: g' = Q(g + r), r' = (g + r) - deQ(g'))
over nested dicts, lists and tuples of tensors, for a trainer's gradients.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def quantize_int8(x: Tensor) -> tuple[Tensor, Tensor]:
    """(q, scale): q int8 in [-127, 127], scale a 0-d float32 tensor."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().max() / 127.0, min=1e-30)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: Tensor, scale: Tensor, dtype: torch.dtype = torch.float32) -> Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def _is_pair(x) -> bool:
    """A quantized leaf: the (int8 tensor, scale) pair ``quantize_int8`` returns."""
    return (isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], Tensor)
            and x[0].dtype == torch.int8)


def _tree_map(fn, tree, *rest, is_leaf=lambda x: False):
    """``fn`` over the leaves of nested dicts, lists and tuples (``rest``:
    trees of the same structure, walked alongside)."""
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
               for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(tree, *rest)


def compress_tree(grads, residuals):
    """Error-feedback compress: a tree of (q, scale) pairs and the new
    residuals."""
    def one(g, r):
        acc = g.to(torch.float32) + r
        q, s = quantize_int8(acc)
        return (q, s), acc - dequantize_int8(q, s)

    pairs = _tree_map(one, grads, residuals)
    is_out = lambda x: isinstance(x, tuple) and len(x) == 2 and _is_pair(x[0])  # noqa: E731
    qs = _tree_map(lambda t: t[0], pairs, is_leaf=is_out)
    new_res = _tree_map(lambda t: t[1], pairs, is_leaf=is_out)
    return qs, new_res


def decompress_tree(qs, dtype: torch.dtype = torch.float32):
    return _tree_map(lambda t: dequantize_int8(t[0], t[1], dtype), qs, is_leaf=_is_pair)


def init_residuals(params):
    """fp32 zeros beside each parameter leaf (on a mesh, at its sharding)."""
    from .mesh import zeros_for
    return _tree_map(lambda p: zeros_for(p, p.shape, torch.float32), params)


def compressed_grads(grads, residuals, dtype: torch.dtype = torch.float32):
    """Round-trip compress/decompress with error feedback: what a reduction
    of the result moves is bounded to int8 precision per tensor."""
    qs, new_res = compress_tree(grads, residuals)
    return decompress_tree(qs, dtype), new_res
