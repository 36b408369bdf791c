"""Shared layer primitives: norms, rotary embeddings (RoPE / M-RoPE),
sinusoidal positions, FFNs (the JAX package's ``models/layers.py``).

Every function keeps the JAX package's cast order: statistics in fp32, the
result cast back to the input's dtype, *then* scaled; rotations in fp32 and
cast back; each weight cast to the activations' dtype before its product.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * scale


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * scale + bias


def sinusoidal_positions(positions: torch.Tensor, dim: int, dtype=torch.float32):
    """(...,) int positions -> (..., dim) sinusoidal embeddings (whisper)."""
    half = dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(10000.0) * ar / (half - 1))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _inv_freq(half: int, theta: float, device) -> torch.Tensor:
    ar = torch.arange(half, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / half))


def _rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., L) -> cos/sin of shape (..., L, head_dim//2)."""
    inv = _inv_freq(head_dim // 2, theta, positions.device)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """x (B, L, H, hd), positions (B, L) -> rotated (interleaved-half layout)."""
    cos, sin = _rope_angles(positions, x.shape[-1], theta)  # (B, L, hd/2)
    return _rotate(x, cos[:, :, None, :], sin[:, :, None, :])


def apply_mrope(
    x: torch.Tensor,
    positions: torch.Tensor,
    sections: tuple[int, ...],
    theta: float = 1e6,
) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.

    positions (3, B, L) — temporal / height / width position streams; the
    rotary half-dim is split into ``sections`` (sums to hd/2), each section
    taking its angles from the corresponding stream.  For pure-text tokens
    all three streams are equal, recovering standard RoPE.
    """
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"mrope sections {sections} must sum to head_dim / 2 = {hd // 2}")
    inv = _inv_freq(hd // 2, theta, x.device)
    cos_parts, sin_parts = [], []
    offset = 0
    for s, sec in zip(positions, sections):
        ang = s.float()[..., None] * inv[offset: offset + sec]
        cos_parts.append(torch.cos(ang))
        sin_parts.append(torch.sin(ang))
        offset += sec
    cos = torch.cat(cos_parts, -1)[:, :, None, :]  # (B, L, 1, hd/2)
    sin = torch.cat(sin_parts, -1)[:, :, None, :]
    return _rotate(x, cos, sin)


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU FFN used by every modern assigned arch."""
    g = F.silu(x @ w_gate.to(x.dtype))
    u = x @ w_up.to(x.dtype)
    return (g * u) @ w_down.to(x.dtype)


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    """GELU MLP (whisper); ``jax.nn.gelu``'s default, the tanh form."""
    h = F.gelu(x @ w_in.to(x.dtype) + b_in.to(x.dtype), approximate="tanh")
    return h @ w_out.to(x.dtype) + b_out.to(x.dtype)
