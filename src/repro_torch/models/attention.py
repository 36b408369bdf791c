"""Attention: GQA (+qk_norm, bias, RoPE / M-RoPE), dense and blockwise
(flash-style online softmax) over the same GQA-native contractions (the JAX
package's ``models/attention.py``; its MLA and cross attention are ROADMAP
item 12.2).

Conventions: hidden x is (B, L, D); caches are dicts of tensors; ``cache_len``
is the number of tokens already in the cache (a Python int or a 0-d tensor)
for decode.  Scores are taken in the activations' dtype and the softmax in
fp32, cast back, as in the JAX package.

The JAX package's activation-sharding constraints (``constrain`` /
``tp_size``, no-ops outside a mesh) are left out with the mesh context
(ROADMAP item 12.5).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import apply_mrope, apply_rope, rms_norm

_NEG = -1e30
FLASH_THRESHOLD = 8192  # switch to blockwise attention above this seq len
Q_BLOCK = 2048
KV_BLOCK = 2048


def _rope_q_k(cfg: ArchConfig, q, k, positions):
    if cfg.rope == "rope":
        return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta)
    if cfg.rope == "mrope":
        pos3 = positions[None].expand((3,) + tuple(positions.shape))
        return (
            apply_mrope(q, pos3, cfg.mrope_sections, cfg.rope_theta),
            apply_mrope(k, pos3, cfg.mrope_sections, cfg.rope_theta),
        )
    return q, k


def _gqa_scores(q, k):
    """q (B, Lq, KV, G, hd), k (B, Lk, KV, hd) -> (B, KV, G, Lq, Lk).

    KV heads are never materialized at full head count (GQA-native)."""
    return torch.einsum("bqkgh,bskh->bkgqs", q, k)


def _gqa_out(p, v):
    """p (B, KV, G, Lq, Lk), v (B, Lk, KV, hd) -> (B, Lq, KV, G, hd)."""
    return torch.einsum("bkgqs,bskh->bqkgh", p, v)


def _causal_mask(q_start: int, lq: int, k_start: int, lk: int, device) -> torch.Tensor:
    qpos = torch.arange(lq, device=device) + q_start
    kpos = torch.arange(lk, device=device) + k_start
    return qpos[:, None] >= kpos[None, :]


def dense_attention(q, k, v, causal: bool, q_offset: int = 0):
    """Materializes the score matrix — used for short sequences / decode."""
    B, Lq, KV, G, hd = q.shape
    Lk = k.shape[1]
    scores = _gqa_scores(q, k) * (hd ** -0.5)
    if causal:
        mask = _causal_mask(q_offset, Lq, 0, Lk, q.device)
        scores = torch.where(mask, scores, _NEG)
    p = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return _gqa_out(p, v)


def blockwise_attention(q, k, v, causal: bool):
    """Flash-style attention: a loop over query blocks, an inner loop over KV
    blocks with an online softmax.  Never materializes more than a
    (B, KV, G, Q_BLOCK, KV_BLOCK) score tile.  Like the JAX package's, it
    visits every KV block, the ones above a causal diagonal too."""
    B, L, KV, G, hd = q.shape
    Lk = k.shape[1]
    qb, kb = min(Q_BLOCK, L), min(KV_BLOCK, Lk)
    if L % qb or Lk % kb:
        raise ValueError(f"sequence lengths {(L, Lk)} must divide into blocks {(qb, kb)}")
    scale = hd ** -0.5
    outs = []
    for q_start in range(0, L, qb):
        q_blk = q[:, q_start: q_start + qb]  # (B, qb, KV, G, hd)
        acc = torch.zeros((B, KV, G, qb, hd), dtype=torch.float32, device=q.device)
        m = torch.full((B, KV, G, qb), _NEG, dtype=torch.float32, device=q.device)
        denom = torch.zeros((B, KV, G, qb), dtype=torch.float32, device=q.device)
        for k_start in range(0, Lk, kb):
            k_blk, v_blk = k[:, k_start: k_start + kb], v[:, k_start: k_start + kb]
            s = _gqa_scores(q_blk, k_blk).float() * scale
            if causal:
                s = torch.where(_causal_mask(q_start, qb, k_start, kb, q.device), s, _NEG)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            denom = denom * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + _gqa_out(p.to(q.dtype), v_blk).float().permute(
                0, 2, 3, 1, 4)
            m = m_new
        out = acc / torch.clamp(denom[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))  # (B, qb, KV, G, hd)
    return torch.cat(outs, dim=1)


def _maybe_qk_norm(cfg: ArchConfig, params, q, k):
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    return q, k


def _write_cache(cache: torch.Tensor, new: torch.Tensor, start: int) -> torch.Tensor:
    """``jax.lax.dynamic_update_slice_in_dim`` along the sequence: a new
    tensor, ``start`` clamped so that ``new`` fits."""
    start = max(0, min(start, cache.shape[1] - new.shape[1]))
    out = cache.clone()
    out[:, start: start + new.shape[1]] = new
    return out


def gqa_attention(
    cfg: ArchConfig,
    params: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: dict | None = None,
    cache_len=None,
    causal: bool = True,
):
    """Returns (out (B, L, D), new_cache or None)."""
    B, L, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    G = H // KV
    dt = x.dtype

    def proj(w, b, heads):
        y = x @ w.to(dt)
        if b is not None:
            y = y + b.to(dt)
        return y.reshape(B, L, heads, hd)

    q = proj(params["wq"], params.get("bq"), H)
    k = proj(params["wk"], params.get("bk"), KV)
    v = proj(params["wv"], params.get("bv"), KV)
    q, k = _maybe_qk_norm(cfg, params, q, k)
    q, k = _rope_q_k(cfg, q, k, positions)
    q = q.reshape(B, L, KV, G, hd)

    if cache is not None:
        start = int(cache_len)
        k_cache = _write_cache(cache["k"], k, start)
        v_cache = _write_cache(cache["v"], v, start)
        new_cache = {"k": k_cache, "v": v_cache}
        if L > 1:
            # prefill-with-cache: attention over the freshly written prefix
            # (requires cache_len == 0, which is how prefill() calls us)
            if L > FLASH_THRESHOLD:
                out = blockwise_attention(q, k, v, causal=True)
            else:
                out = dense_attention(q, k, v, causal=True)
        else:
            # decode: one query attends over the whole (masked) cache
            valid = torch.arange(k_cache.shape[1], device=x.device) < (start + L)
            scores = _gqa_scores(q, k_cache) * (hd ** -0.5)
            scores = torch.where(valid, scores, _NEG)
            p = torch.softmax(scores.float(), dim=-1).to(dt)
            out = _gqa_out(p, v_cache)
    else:
        if L > FLASH_THRESHOLD:
            out = blockwise_attention(q, k, v, causal)
        else:
            out = dense_attention(q, k, v, causal)
        new_cache = None

    y = out.reshape(B, L, H * hd) @ params["wo"].to(dt)
    if params.get("bo") is not None:
        y = y + params["bo"].to(dt)
    return y, new_cache
