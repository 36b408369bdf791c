"""Gradient compression with error feedback (the JAX package's
``train/grad_compress.py``): int8 per-block quantization of each gradient
leaf, the quantization residual carried to the next step.  Rounding is half
to even on both sides, so the int8 values are the JAX package's.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

_BLOCK = 256


class ErrorFeedbackState(NamedTuple):
    residual: Any  # tree like grads, fp32


def ef_init(grads_like) -> ErrorFeedbackState:
    return ErrorFeedbackState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_like))


def _quantize_leaf(g: torch.Tensor):
    """Symmetric int8 per-block quantization: returns (q, scales)."""
    flat = g.float().reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.shape[0]) % _BLOCK))
    blocks = flat.reshape(-1, _BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)), -127, 127).to(
        torch.int8)
    return q, scale


def _dequantize_leaf(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    return flat[: math.prod(shape)].reshape(shape)


def compress_decompress(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Round-trip a gradient leaf through int8; returns (g_hat, error)."""
    q, scale = _quantize_leaf(g)
    g_hat = _dequantize_leaf(q, scale, g.shape)
    return g_hat, g.float() - g_hat


@torch.no_grad()
def apply_error_feedback(grads, ef: ErrorFeedbackState):
    """grads + residual -> int8 round trip -> (compressed grads, new state)."""
    out = []
    for g, r in zip(tree_leaves(grads), tree_leaves(ef.residual)):
        g_hat, err = compress_decompress(g.float() + r)
        out.append((g_hat.to(g.dtype), err))
    return (tree_unflatten(grads, [o[0] for o in out]),
            ErrorFeedbackState(residual=tree_unflatten(ef.residual, [o[1] for o in out])))
