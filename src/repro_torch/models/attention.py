"""Attention (the JAX package's ``models/attention.py``): GQA (+qk_norm,
bias, RoPE / M-RoPE), dense and blockwise (flash-style online softmax) over
the same GQA-native contractions, MLA (DeepSeek latent attention with the
absorbed decode against the compressed cache) and cross-attention for
encoder-decoder models.

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


def cross_attention(cfg: ArchConfig, params: dict, x: torch.Tensor, enc_kv: dict):
    """Decoder cross-attention over precomputed encoder K/V (whisper)."""
    B, L, D = x.shape
    H, hd = cfg.n_heads, cfg.head_dim_
    dt = x.dtype
    q = x @ params["wq"].to(dt)
    if params.get("bq") is not None:
        q = q + params["bq"].to(dt)
    q = q.reshape(B, L, H, hd)
    k, v = enc_kv["k"], enc_kv["v"]  # (B, Lk, H, hd)
    scores = torch.einsum("blhd,bshd->bhls", q, k) * (hd ** -0.5)
    p = torch.softmax(scores.float(), dim=-1).to(dt)
    out = torch.einsum("bhls,bshd->blhd", p, v).reshape(B, L, H * hd)
    y = out @ params["wo"].to(dt)
    if params.get("bo") is not None:
        y = y + params["bo"].to(dt)
    return y


def mla_attention(
    cfg: ArchConfig,
    params: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: dict | None = None,
    cache_len=None,
):
    """DeepSeek-V2 Multi-head Latent Attention.

    Prefill: uncompressed compute; the cache stores only the compressed
    latent c_kv (kv_lora_rank) and the shared rope key (rope_head_dim).
    Decode: the *absorbed* form: q_nope is folded through w_uk so scores are
    taken directly against the latent cache; the attention output stays in
    latent space and is expanded through w_uv once.
    """
    B, L, D = x.shape
    H, hd, r = cfg.n_heads, cfg.head_dim_, cfg.rope_head_dim
    dt = x.dtype

    # --- projections ---
    c_kv = rms_norm(x @ params["w_dkv"].to(dt), params["kv_norm"], cfg.norm_eps)
    k_rope = x @ params["w_krope"].to(dt)
    # one (B, L, 1, r) head, shared by every query head
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]

    if cfg.q_lora_rank:
        c_q = rms_norm(x @ params["w_dq"].to(dt), params["q_norm_lora"], cfg.norm_eps)
    else:
        c_q = x
    q_full = torch.einsum("blr,rho->blho", c_q, params["w_uq"].to(dt))
    q_nope, q_rope = q_full[..., :hd], q_full[..., hd:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    scale = (hd + r) ** -0.5

    new_cache = None
    if cache is not None:
        start = int(cache_len)
        new_cache = {"c_kv": _write_cache(cache["c_kv"], c_kv, start),
                     "k_rope": _write_cache(cache["k_rope"], k_rope, start)}

    if cache is None or L > 1:
        # uncompressed prefill (a cache, if given, is written above; as in
        # gqa_attention this needs cache_len == 0)
        k_nope = torch.einsum("blr,rho->blho", c_kv, params["w_uk"].to(dt))
        v = torch.einsum("blr,rho->blho", c_kv, params["w_uv"].to(dt))
        if L > FLASH_THRESHOLD:
            # pack the shared rope key beside each head's nope key, so the
            # blockwise attention sees one (hd + r) head dim
            q_pack = torch.cat([q_nope, q_rope], dim=-1).reshape(B, L, H, 1, hd + r)
            k_pack = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, L, H, r)], dim=-1)
            v_pad = torch.nn.functional.pad(v, (0, r))
            out = blockwise_attention(q_pack, k_pack, v_pad, causal=True)
            out = out.reshape(B, L, H, hd + r)[..., :hd]
        else:
            s = (torch.einsum("blho,bsho->bhls", q_nope, k_nope)
                 + torch.einsum("blhr,bsr->bhls", q_rope, k_rope)) * scale
            s = torch.where(_causal_mask(0, L, 0, L, x.device), s, _NEG)
            p = torch.softmax(s.float(), dim=-1).to(dt)
            out = torch.einsum("bhls,bsho->blho", p, v)
    else:
        # absorbed decode: q_nope -> latent space through w_uk; attention and
        # its output stay in the compressed latent space
        ckv, krope = new_cache["c_kv"], new_cache["k_rope"]
        q_lat = torch.einsum("blho,rho->blhr", q_nope, params["w_uk"].to(dt))
        s = (torch.einsum("blhr,bsr->bhls", q_lat, ckv)
             + torch.einsum("blhr,bsr->bhls", q_rope, krope)) * scale
        valid = torch.arange(ckv.shape[1], device=x.device) < (start + L)
        s = torch.where(valid, s, _NEG)
        p = torch.softmax(s.float(), dim=-1).to(dt)
        out_lat = torch.einsum("bhls,bsr->blhr", p, ckv)
        out = torch.einsum("blhr,rho->blho", out_lat, params["w_uv"].to(dt))

    y = torch.einsum("blho,hod->bld", out, params["wo_mla"].to(dt))
    return y, new_cache
