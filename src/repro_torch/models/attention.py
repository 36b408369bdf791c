"""Attention (the JAX package's ``models/attention.py``): GQA (+qk_norm,
bias, RoPE / M-RoPE), dense and blockwise (flash-style online softmax) over
the same GQA-native contractions, MLA (DeepSeek latent attention with the
absorbed decode against the compressed cache) and cross-attention for
encoder-decoder models.

Conventions: hidden x is (B, L, D); caches are dicts of tensors; ``cache_len``
is the number of tokens already in the cache (a Python int or a 0-d tensor)
for decode.  Scores are taken in the activations' dtype and the softmax in
fp32, cast back, as in the JAX package.

Inside an activation-sharding context (``distributed/act_sharding.py``)
the GQA activations take the JAX package's TP placement and MLA's query
heads carry the model axis; outside one, ``constrain`` changes nothing.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.act_sharding import (
    constrain, local_blocks, mergeable, tp_size, whole_tokens,
)
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


def _causal_mask(qpos: torch.Tensor, k_start: int, lk: int) -> torch.Tensor:
    """Whether query ``qpos[i]`` sees key ``k_start + j``: (len(qpos), lk)."""
    kpos = torch.arange(lk, device=qpos.device) + k_start
    return qpos[:, None] >= kpos[None, :]


def _qpos(lq: int, q_offset: int, qpos, device) -> torch.Tensor:
    """The queries' positions: ``qpos`` where given (a block of a split
    sequence), else ``q_offset`` + 0 .. lq - 1."""
    return torch.arange(lq, device=device) + q_offset if qpos is None else qpos


def dense_attention(q, k, v, causal: bool, q_offset: int = 0, qpos=None):
    """Materializes the score matrix — used for short sequences / decode.
    ``qpos`` (Lq,) gives the queries' positions for the causal mask in
    place of ``q_offset``."""
    B, Lq, KV, G, hd = q.shape
    Lk = k.shape[1]
    scores = _gqa_scores(q, k) * (hd ** -0.5)
    if causal:
        mask = _causal_mask(_qpos(Lq, q_offset, qpos, q.device), 0, Lk)
        scores = torch.where(mask, scores, _NEG)
    p = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return _gqa_out(p, v)


def blockwise_attention(q, k, v, causal: bool, qpos=None):
    """Flash-style attention: a loop over query blocks, an inner loop over KV
    blocks with an online softmax.  Never materializes more than a
    (B, KV, G, Q_BLOCK, KV_BLOCK) score tile.  Like the JAX package's, it
    visits every KV block, the ones above a causal diagonal too.  ``qpos``
    (L,) gives the queries' positions (default 0 .. L - 1)."""
    B, L, KV, G, hd = q.shape
    qpos = _qpos(L, 0, qpos, q.device)
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
                s = torch.where(_causal_mask(qpos[q_start: q_start + qb], k_start, kb), s, _NEG)
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


def _viewable(y: torch.Tensor, dim: int, parts: int) -> torch.Tensor:
    """``y`` ready for its dim ``dim`` to be viewed as ``parts`` leading
    groups: a DTensor split over that dim into a number of shards that does
    not divide ``parts`` (8 KV heads on a model axis of 16) is gathered over
    it first, as GSPMD replicates them; anything else as it is."""
    if not isinstance(y, DTensor):
        return y
    split = Shard(dim)
    shards = math.prod(y.device_mesh.size(d) for d, p in enumerate(y.placements) if p == split)
    if parts % shards == 0:
        return y
    return y.redistribute(y.device_mesh, [Replicate() if p == split else p for p in y.placements])


def _maybe_qk_norm(cfg: ArchConfig, params, q, k):
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    return q, k


def _write_cache(cache: torch.Tensor, new: torch.Tensor, start: int) -> torch.Tensor:
    """``jax.lax.dynamic_update_slice_in_dim`` along the sequence: a new
    tensor, ``start`` clamped so that ``new`` fits.  A DTensor cache is
    written block by block (:func:`_write_blocks`)."""
    start = max(0, min(start, cache.shape[1] - new.shape[1]))
    if isinstance(cache, DTensor):
        return _write_blocks(cache, new, start)
    out = cache.clone()
    out[:, start: start + new.shape[1]] = new
    return out


def _write_blocks(cache, new, start: int):
    """:func:`_write_cache` on each rank's block of a DTensor cache: ``new``
    taken in the cache's placements with its sequence whole, and the part
    of it that falls in this rank's positions written there.  (An assignment
    into a slice of a DTensor split along the sliced dim writes into a
    redistributed copy, and the cache keeps its zeros.)"""
    from repro_torch.distributed.sharding import local_box

    mesh, pl = cache.device_mesh, cache.placements
    if not isinstance(new, DTensor):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim, run_check=False)
    seq_whole = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p for p in pl]
    new = new.redistribute(mesh, seq_whole).to_local()
    shape, off = local_box(cache.shape, mesh, pl)
    lo = off[1]
    a, b = max(start, lo), min(start + new.shape[1], lo + shape[1])
    out = cache.to_local().clone()
    if a < b:
        out[:, a - lo: b - lo] = new[:, a - start: b - start]
    return DTensor.from_local(out, mesh, pl, run_check=False, shape=cache.shape,
                              stride=cache.stride())


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
    x = whole_tokens(x)
    B, L, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    G = H // KV
    dt = x.dtype

    def proj(w, b, heads):
        y = x @ w.to(dt)
        if b is not None:
            y = y + b.to(dt)
        return _viewable(y, 2, heads).reshape(B, L, heads, hd)

    q = proj(params["wq"], params.get("bq"), H)
    k = proj(params["wk"], params.get("bk"), KV)
    v = proj(params["wv"], params.get("bv"), KV)
    q, k = _maybe_qk_norm(cfg, params, q, k)
    q, k = _rope_q_k(cfg, q, k, positions)
    q = _viewable(q, 2, KV).reshape(B, L, KV, G, hd)
    # the TP placement of the attention activations, in preference order:
    #   1. the KV-head dim (head TP; KV caches shard too)
    #   2. the query-group dim (GQA: Q heads shard, K / V replicate over TP)
    #   3. the sequence dim (when the head counts do not divide the axis:
    #      scores shard over Lq, K / V replicate)
    ts = tp_size()
    kv_roles = ("dp", None, None, None)
    if KV % ts == 0:
        q_roles, kv_roles = ("dp", None, "tp", None, None), ("dp", None, "tp", None)
    elif G % ts == 0:
        q_roles = ("dp", None, None, "tp", None)
    elif L % ts == 0 and L > 1:
        q_roles = ("dp", "tp", None, None, None)
    else:
        q_roles = ("dp", None, None, None, None)
    if q_roles != ("dp", None, None, None, None):
        q, k, v = constrain(q, q_roles), constrain(k, kv_roles), constrain(v, kv_roles)
    # the products run on each rank's blocks (no view of a DTensor folds a
    # split dim); the queries' positions follow a split sequence
    # (prefill with a cache is causal)
    causal = causal or cache is not None
    attend = blockwise_attention if L > FLASH_THRESHOLD else dense_attention
    region = local_blocks(lambda q, k, v, qpos: attend(q, k, v, causal, qpos=qpos),
                          (q_roles, kv_roles, kv_roles, (q_roles[1],)), q_roles)
    qpos = torch.arange(L, device=x.device)

    if cache is not None:
        start = int(cache_len)
        k_cache = _write_cache(cache["k"], k, start)
        v_cache = _write_cache(cache["v"], v, start)
        new_cache = {"k": k_cache, "v": v_cache}
        if L > 1:
            # prefill-with-cache: attention over the freshly written prefix
            # (requires cache_len == 0, which is how prefill() calls us)
            out = region(q, k, v, qpos)
        else:
            # decode: one query attends over the whole (masked) cache
            valid = torch.arange(k_cache.shape[1], device=x.device) < (start + L)
            out = local_blocks(_decode_attention, (q_roles, kv_roles, kv_roles, (None,)),
                               q_roles)(q, k_cache, v_cache, valid)
    else:
        out = region(q, k, v, qpos)
        new_cache = None

    # the heads' merge gathers a split query-group dim; (its gradient comes
    # back as a placement the heads' view can take)
    out = mergeable(out, 2, 4).reshape(B, L, H * hd)
    y = whole_tokens(out) @ params["wo"].to(dt)
    if params.get("bo") is not None:
        y = y + params["bo"].to(dt)
    return y, new_cache


def _decode_attention(q, k_cache, v_cache, valid):
    """One query (B, 1, KV, G, hd) over the cache's ``valid`` positions."""
    scores = _gqa_scores(q, k_cache) * (q.shape[-1] ** -0.5)
    scores = torch.where(valid, scores, _NEG)
    p = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return _gqa_out(p, v_cache)


def cross_attention(cfg: ArchConfig, params: dict, x: torch.Tensor, enc_kv: dict):
    """Decoder cross-attention over precomputed encoder K/V (whisper)."""
    x = whole_tokens(x)
    B, L, D = x.shape
    H, hd = cfg.n_heads, cfg.head_dim_
    dt = x.dtype
    q = x @ params["wq"].to(dt)
    if params.get("bq") is not None:
        q = q + params["bq"].to(dt)
    q = _viewable(q, 2, H).reshape(B, L, H, hd)
    heads = ("dp", None, "tp", None)  # (B, L or Lk, H, hd): each rank's heads
    out = local_blocks(_cross_attend, (heads, heads, heads), heads)(q, enc_kv["k"], enc_kv["v"])
    y = whole_tokens(mergeable(out, 2, 3).reshape(B, L, H * hd)) @ params["wo"].to(dt)
    if params.get("bo") is not None:
        y = y + params["bo"].to(dt)
    return y


def _cross_attend(q, k, v):
    """q (B, L, H, hd) over the encoder's k, v (B, Lk, H, hd), no mask."""
    scores = torch.einsum("blhd,bshd->bhls", q, k) * (q.shape[-1] ** -0.5)
    p = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhls,bshd->blhd", p, v)


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
    x = whole_tokens(x)
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
    q_full = constrain(q_full, ("dp", None, "tp", None))  # H carries TP
    q_nope, q_rope = q_full[..., :hd], q_full[..., hd:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        start = int(cache_len)
        new_cache = {"c_kv": _write_cache(cache["c_kv"], c_kv, start),
                     "k_rope": _write_cache(cache["k_rope"], k_rope, start)}

    # the heads' products run on each rank's blocks of heads
    heads, shared = ("dp", None, "tp", None), ("dp", None, None)
    w_roles = (None, "tp", None)
    if cache is None or L > 1:
        # uncompressed prefill (a cache, if given, is written above; as in
        # gqa_attention this needs cache_len == 0)
        out = local_blocks(_mla_prefill, (heads, heads, shared, shared, w_roles, w_roles),
                           heads)(q_nope, q_rope, c_kv, k_rope, params["w_uk"].to(dt),
                                  params["w_uv"].to(dt))
    else:
        ckv, krope = new_cache["c_kv"], new_cache["k_rope"]
        valid = torch.arange(ckv.shape[1], device=x.device) < (start + L)
        out = local_blocks(_mla_decode, (heads, heads, shared, shared, w_roles, w_roles, (None,)),
                           heads)(q_nope, q_rope, ckv, krope, params["w_uk"].to(dt),
                                  params["w_uv"].to(dt), valid)

    y = torch.einsum("blho,hod->bld", out, params["wo_mla"].to(dt))
    return y, new_cache


def _mla_prefill(q_nope, q_rope, c_kv, k_rope, w_uk, w_uv):
    """MLA's uncompressed causal attention: q_nope (B, L, H, hd), q_rope
    (B, L, H, r), the latent c_kv (B, L, kv_lora_rank) and the shared rope
    key (B, L, r) -> (B, L, H, hd)."""
    B, L, H, hd = q_nope.shape
    r = q_rope.shape[-1]
    k_nope = torch.einsum("blr,rho->blho", c_kv, w_uk)
    v = torch.einsum("blr,rho->blho", c_kv, w_uv)
    if L > FLASH_THRESHOLD:
        # pack the shared rope key beside each head's nope key, so the
        # blockwise attention sees one (hd + r) head dim
        q_pack = torch.cat([q_nope, q_rope], dim=-1).reshape(B, L, H, 1, hd + r)
        k_pack = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, L, H, r)], dim=-1)
        v_pad = torch.nn.functional.pad(v, (0, r))
        out = blockwise_attention(q_pack, k_pack, v_pad, causal=True)
        return out.reshape(B, L, H, hd + r)[..., :hd]
    s = (torch.einsum("blho,bsho->bhls", q_nope, k_nope)
         + torch.einsum("blhr,bsr->bhls", q_rope, k_rope)) * (hd + r) ** -0.5
    s = torch.where(_causal_mask(torch.arange(L, device=s.device), 0, L), s, _NEG)
    p = torch.softmax(s.float(), dim=-1).to(q_nope.dtype)
    return torch.einsum("bhls,bsho->blho", p, v)


def _mla_decode(q_nope, q_rope, ckv, krope, w_uk, w_uv, valid):
    """MLA's absorbed decode: q_nope -> latent space through w_uk; attention
    over the cache's ``valid`` positions and its output stay in the
    compressed latent space, expanded through w_uv once."""
    hd, r = q_nope.shape[-1], q_rope.shape[-1]
    q_lat = torch.einsum("blho,rho->blhr", q_nope, w_uk)
    s = (torch.einsum("blhr,bsr->bhls", q_lat, ckv)
         + torch.einsum("blhr,bsr->bhls", q_rope, krope)) * (hd + r) ** -0.5
    s = torch.where(valid, s, _NEG)
    p = torch.softmax(s.float(), dim=-1).to(q_nope.dtype)
    out_lat = torch.einsum("bhls,bsr->blhr", p, ckv)
    return torch.einsum("blhr,rho->blho", out_lat, w_uv)
