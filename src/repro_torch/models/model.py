"""Model assembly for the data-selection-for-training testbed (the JAX
package's ``models/model.py``).  ``launch/train.py`` trains these models with
per-round submodular coreset selection over their embeddings.  Families:
dense / moe / vlm (decoder-only transformer), hybrid (jamba period loop),
ssm (mamba2), audio (whisper encoder-decoder).

The parameter tree is the JAX package's: nested dicts of tensors with the
same key paths, each layer stack stacked on a leading axis (a hybrid model's
``pos{p}`` stacks over its periods), so a tree moves across as a plain numpy
map (``interop.params_from_arrays``).  A stack runs as a loop over the layer
index with ``torch.utils.checkpoint`` around each layer while gradients are
on (``jax.checkpoint`` in the JAX package), and the loss recomputes its
logits in backward.

Public entry points:
  init_params(cfg, seed, device | abstract=True)
  train_forward(cfg, params, batch) -> (loss, metrics)
  prefill(cfg, params, batch)       -> (logits_last, cache)
  decode_step(cfg, params, cache, tokens, cache_len) -> (logits, cache)
  init_cache(cfg, batch_size, max_len, device | abstract=True)

The ssm and hybrid families' ``prefill`` runs the chunked scan over its
tokens and leaves the scan's final state in the cache (``mamba_block``), so
a prefill equals the no-cache forward; the JAX package's handles the first
token only (ROADMAP queue 3).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.common import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.act_sharding import constrain, mergeable, pin, whole_tokens
from repro_torch.models.attention import cross_attention, gqa_attention, mla_attention
from repro_torch.models.layers import gelu_mlp, layer_norm, rms_norm, sinusoidal_positions, swiglu
from repro_torch.models.mamba import mamba_block
from repro_torch.models.moe import moe_ffn
from repro_torch.tree import tree_map

# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class _Init:
    """Draws from one ``torch.Generator``: N(0, 1) in fp32, scaled, then cast
    to the parameter dtype, as the JAX package's ``_Init.mat`` does.  An
    abstract ``_Init`` draws nothing and makes no generator: every leaf is
    an empty tensor (on the meta device, or fake under a ``FakeTensorMode``)."""

    def __init__(self, seed: int, dtype: torch.dtype, device: torch.device,
                 abstract: bool = False):
        self.gen = None if abstract else torch.Generator(device=device).manual_seed(seed)
        self.dtype, self.device = dtype, device

    def _empty(self, shape):
        return torch.empty(shape, dtype=self.dtype, device=self.device)

    def mat(self, *shape, scale=0.02):
        if self.gen is None:
            return self._empty(shape)
        x = torch.randn(shape, generator=self.gen, dtype=torch.float32, device=self.device)
        return (x * scale).to(self.dtype)

    def zeros(self, *shape):
        if self.gen is None:
            return self._empty(shape)
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def ones(self, *shape):
        if self.gen is None:
            return self._empty(shape)
        return torch.ones(shape, dtype=self.dtype, device=self.device)


def _abstract_device(device) -> torch.device:
    """An abstract tree's device: ``device`` when given (a fake tensor's
    device under a ``FakeTensorMode``), else the meta device."""
    return torch.device("meta" if device is None else device)


def _attn_params(cfg: ArchConfig, ini: _Init) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    if cfg.mla:
        r_kv, r_q, r_r = cfg.kv_lora_rank, cfg.q_lora_rank, cfg.rope_head_dim
        p = {
            "w_dkv": ini.mat(D, r_kv),
            "kv_norm": ini.ones(r_kv),
            "w_krope": ini.mat(D, r_r),
            "w_uk": ini.mat(r_kv, H, hd),
            "w_uv": ini.mat(r_kv, H, hd),
            "wo_mla": ini.mat(H, hd, D),
        }
        if r_q:
            p["w_dq"] = ini.mat(D, r_q)
            p["q_norm_lora"] = ini.ones(r_q)
            p["w_uq"] = ini.mat(r_q, H, hd + r_r)
        else:
            p["w_uq"] = ini.mat(D, H, hd + r_r)
        return p
    p = {
        "wq": ini.mat(D, H * hd),
        "wk": ini.mat(D, KV * hd),
        "wv": ini.mat(D, KV * hd),
        "wo": ini.mat(H * hd, D),
    }
    if cfg.use_bias:
        p.update(bq=ini.zeros(H * hd), bk=ini.zeros(KV * hd), bv=ini.zeros(KV * hd))
    if cfg.qk_norm:
        p.update(q_norm=ini.ones(hd), k_norm=ini.ones(hd))
    return p


def _ffn_params(cfg: ArchConfig, ini: _Init, gelu: bool = False) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    if gelu:
        return {"w_in": ini.mat(D, F), "b_in": ini.zeros(F), "w_out": ini.mat(F, D),
                "b_out": ini.zeros(D)}
    return {"w_gate": ini.mat(D, F), "w_up": ini.mat(D, F), "w_down": ini.mat(F, D)}


def _moe_params(cfg: ArchConfig, ini: _Init) -> dict:
    D, E, F = cfg.d_model, cfg.n_experts, cfg.d_expert_
    p = {"router": ini.mat(D, E), "w_gate": ini.mat(E, D, F), "w_up": ini.mat(E, D, F),
         "w_down": ini.mat(E, F, D)}
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * F
        p.update(shared_gate=ini.mat(D, Fs), shared_up=ini.mat(D, Fs),
                 shared_down=ini.mat(Fs, D))
    return p


def _mamba_params(cfg: ArchConfig, ini: _Init) -> dict:
    D, di, N, H, W = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads,
                      cfg.ssm_conv_width)
    return {
        "in_proj": ini.mat(D, 2 * di + 2 * N + H),
        "conv_w": ini.mat(W, di + 2 * N, scale=0.1),
        "dt_bias": ini.zeros(H),
        "A_log": ini.zeros(H),
        "D": ini.ones(H),
        "norm": ini.ones(di),
        "out_proj": ini.mat(di, D),
    }


def _decoder_layer_params(cfg: ArchConfig, ini: _Init, moe: bool = False,
                          mamba: bool = False) -> dict:
    """A pre-norm block's parameters.  An ssm layer keeps an FFN of width
    ``d_ff`` (0 for mamba2-370m: zero-size matrices, as in the JAX
    package's tree)."""
    D = cfg.d_model
    p: dict[str, Any] = {"ln1": ini.ones(D)}
    if mamba:
        p["mixer"] = _mamba_params(cfg, ini)
    else:
        p["attn"] = _attn_params(cfg, ini)
    p["ln2"] = ini.ones(D)
    if moe:
        p["moe"] = _moe_params(cfg, ini)
    else:
        p["ffn"] = _ffn_params(cfg, ini, gelu=cfg.family == "audio")
    return p


def _whisper_enc_layer_params(cfg: ArchConfig, ini: _Init) -> dict:
    D = cfg.d_model
    return {"ln1": ini.ones(D), "b1": ini.zeros(D), "attn": _attn_params(cfg, ini),
            "ln2": ini.ones(D), "b2": ini.zeros(D), "ffn": _ffn_params(cfg, ini, gelu=True)}


def _whisper_dec_layer_params(cfg: ArchConfig, ini: _Init) -> dict:
    D = cfg.d_model
    return {
        "ln1": ini.ones(D),
        "b1": ini.zeros(D),
        "attn": _attn_params(cfg, ini),
        "ln_x": ini.ones(D),
        "bx": ini.zeros(D),
        "xattn": _attn_params(cfg, ini),
        "ln2": ini.ones(D),
        "b2": ini.zeros(D),
        "ffn": _ffn_params(cfg, ini, gelu=True),
    }


def _stack(trees: list):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _unstack(stacked) -> list:
    """A stacked layer tree -> one tree per layer.  One ``unbind`` per leaf,
    so backward writes each stacked gradient once."""
    if isinstance(stacked, dict):
        per_key = {k: _unstack(v) for k, v in stacked.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(stacked, 0))


def _n_pre(cfg: ArchConfig) -> int:
    """Leading dense layers of an MoE decoder (``layers_pre``)."""
    return cfg.first_dense_layers if cfg.n_experts else 0


def _n_periods(cfg: ArchConfig) -> int:
    return cfg.n_layers // cfg.attn_every


def init_params(cfg: ArchConfig, seed: int = 0, device=None, abstract: bool = False) -> dict:
    """Parameters drawn from ``seed`` on ``device`` (default: the card).
    ``abstract``: the same tree of empty tensors, drawn from nothing, on the
    meta device by default (``jax.eval_shape``'s counterpart)."""
    dev = _abstract_device(device) if abstract else resolve_device(device)
    ini = _Init(seed, _dtype(cfg.param_dtype), dev, abstract)
    D, V = cfg.d_model, cfg.vocab
    params: dict[str, Any] = {"embed": ini.mat(V, D)}
    if not cfg.tie_embeddings:
        params["lm_head"] = ini.mat(D, V)
    params["final_norm"] = ini.ones(D)

    if cfg.family == "audio":
        # whisper: encoder self-attention stack + decoder (self + cross) stack
        params["enc_layers"] = _stack([_whisper_enc_layer_params(cfg, ini)
                                       for _ in range(cfg.enc_layers)])
        params["enc_norm"] = ini.ones(D)
        params["enc_norm_b"] = ini.zeros(D)
        params["dec_layers"] = _stack([_whisper_dec_layer_params(cfg, ini)
                                       for _ in range(cfg.n_layers)])
        params["final_norm_b"] = ini.zeros(D)
        return params

    if cfg.family == "hybrid":
        period = cfg.attn_every
        for pos in range(period):
            params[f"pos{pos}"] = _stack([
                _decoder_layer_params(cfg, ini, moe=cfg.is_moe_layer(per * period + pos),
                                      mamba=not cfg.is_attn_layer(per * period + pos))
                for per in range(_n_periods(cfg))])
        return params

    if cfg.family == "ssm":
        params["layers"] = _stack([_decoder_layer_params(cfg, ini, mamba=True)
                                   for _ in range(cfg.n_layers)])
        return params

    if cfg.family == "vlm":
        params["patch_proj"] = ini.mat(D, D)

    # dense / moe / vlm decoder-only stacks
    n_pre = _n_pre(cfg)
    if n_pre:
        params["layers_pre"] = _stack([_decoder_layer_params(cfg, ini) for _ in range(n_pre)])
    params["layers"] = _stack([_decoder_layer_params(cfg, ini, moe=cfg.is_moe_layer(l))
                               for l in range(n_pre, cfg.n_layers)])
    return params


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------


def _apply_ffn(cfg: ArchConfig, lp: dict, h: torch.Tensor):
    h = whole_tokens(h)
    if "moe" in lp:
        return moe_ffn(cfg, lp["moe"], h)
    f = lp["ffn"]
    if cfg.family == "audio":
        return gelu_mlp(h, f["w_in"], f["b_in"], f["w_out"], f["b_out"])
    return swiglu(h, f["w_gate"], f["w_up"], f["w_down"])


def _norm(cfg: ArchConfig, x, scale, bias=None):
    if cfg.family == "audio":
        return layer_norm(x, scale, bias, cfg.norm_eps)
    return rms_norm(x, scale, cfg.norm_eps)


def _decoder_layer(cfg: ArchConfig, lp: dict, x: torch.Tensor, positions: torch.Tensor,
                   cache: dict | None, cache_len):
    """Pre-norm block: mixer (attention | mamba | MLA) + FFN / MoE.  Returns
    (x, new_cache)."""
    # the layer-boundary residual: the batch over the data axes and the
    # sequence over the model axis (Megatron-SP); norms and the FFN are
    # token-pointwise, so the sequence shard flows through.  Each
    # sublayer's output takes that layout before the add (Megatron-SP's
    # reduce-scatter), so its gradient comes back gathered over the
    # sequence, as the products' views take it
    sp = ("dp", "tp", None)
    x = constrain(x, sp)
    h = _norm(cfg, x, lp["ln1"], lp.get("b1"))
    if "mixer" in lp:
        out, new_cache = mamba_block(cfg, lp["mixer"], h, cache)
    elif cfg.mla:
        out, new_cache = mla_attention(cfg, lp["attn"], h, positions, cache, cache_len)
    else:
        out, new_cache = gqa_attention(cfg, lp["attn"], h, positions, cache, cache_len)
    x = x + constrain(out, sp)
    x = constrain(x, sp)
    h = _norm(cfg, x, lp["ln2"], lp.get("b2"))
    x = x + constrain(_apply_ffn(cfg, lp, h), sp)
    return x, new_cache


def _run_layer(layer, remat: bool, *args):
    """``layer(*args)``, recomputed in backward when ``remat`` and gradients
    are on."""
    if remat and torch.is_grad_enabled():
        return checkpoint(layer, *args, use_reentrant=False)
    return layer(*args)


def _scan_stack(cfg, stacked, x, positions, caches, cache_len, remat=True):
    """Run a stacked layer group layer by layer.  caches: a stacked tree or
    None."""
    new_caches = []
    layer_caches = _unstack(caches) if caches is not None else None
    for i, lp in enumerate(_unstack(stacked)):
        c = None if layer_caches is None else layer_caches[i]
        x, new_c = _run_layer(_decoder_layer, remat, cfg, lp, x, positions, c, cache_len)
        new_caches.append(new_c)
    return x, (_stack(new_caches) if caches is not None else None)


def _period_stack(cfg, params, x, positions, caches, cache_len, remat=True):
    """The hybrid family's layers, period by period: position p of period k
    is layer ``k * attn_every + p``, its parameters (and cache) row k of
    ``pos{p}``."""
    period = cfg.attn_every
    per_params = [_unstack(params[f"pos{p}"]) for p in range(period)]
    per_caches = None if caches is None else [_unstack(caches[f"pos{p}"])
                                              for p in range(period)]
    new = [[] for _ in range(period)]
    for k in range(_n_periods(cfg)):
        for p in range(period):
            c = None if per_caches is None else per_caches[p][k]
            x, new_c = _run_layer(_decoder_layer, remat, cfg, per_params[p][k], x, positions,
                                  c, cache_len)
            new[p].append(new_c)
    if caches is None:
        return x, None
    return x, {f"pos{p}": _stack(new[p]) for p in range(period)}


# ---------------------------------------------------------------------------
# embeddings and heads
# ---------------------------------------------------------------------------


def _embed(cfg: ArchConfig, params, tokens):
    # F.embedding, not indexing: on a mesh its backward leaves a replicated
    # table's gradient as a partial sum, where indexing's gathers every
    # rank's activations.  A table split over the vocabulary is gathered
    # over it first: DTensor cannot reduce the masked partial lookup of
    # sharded tokens
    table = params["embed"]
    if isinstance(table, DTensor) and Shard(0) in table.placements:
        table = table.redistribute(
            table.device_mesh, [Replicate() if p == Shard(0) else p for p in table.placements])
    return F.embedding(tokens, table).to(_dtype(cfg.compute_dtype))


def _head_matrix(cfg: ArchConfig, params):
    if cfg.tie_embeddings:
        return params["embed"].T  # (D, V)
    return params["lm_head"]


def _xent_piece(h, head, t):
    logits = (h @ head.to(h.dtype)).float()
    lse = torch.logsumexp(logits, dim=-1)
    # the label logit: the JAX package's one-hot contraction adds only zeros
    # to it, so a gather gives the same value.  On a mesh the contraction
    # stays: a DTensor gather's backward fills a zero gradient of the whole
    # (B, L, V) logits on every rank
    if not isinstance(logits, DTensor):
        ll = torch.gather(logits, -1, t.long()[..., None])[..., 0]
        return (lse - ll).sum()
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    per_token = lse - torch.where(vocab == t[..., None], logits, 0.0).sum(-1)
    # the loss's replicated gradient comes back split here, before it is
    # broadcast over the vocabulary
    return pin(per_token).sum()


def chunked_xent(cfg: ArchConfig, hidden: torch.Tensor, head: torch.Tensor,
                 targets: torch.Tensor, chunk: int | None = None):
    """Mean cross-entropy.  Each piece recomputes its (B, L, V) logits in
    backward and never keeps them; ``chunk`` splits the sequence into
    pieces of that length."""
    hidden = whole_tokens(hidden)
    B, L, D = hidden.shape

    def piece(h, t):
        if torch.is_grad_enabled():
            return checkpoint(_xent_piece, h, head, t, use_reentrant=False)
        return _xent_piece(h, head, t)

    if chunk is None or chunk >= L:
        return piece(hidden, targets) / (B * L)
    if L % chunk:
        raise ValueError(f"chunk {chunk} must divide the sequence length {L}")
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, L, chunk):
        total = total + piece(hidden[:, i: i + chunk], targets[:, i: i + chunk])
    return total / (B * L)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


def _positions(B: int, L: int, device) -> torch.Tensor:
    return torch.arange(L, device=device)[None].expand(B, L)


def _backbone(cfg: ArchConfig, params, x, positions):
    """Token-embedded input -> final hidden states (no cache)."""
    if cfg.family == "hybrid":
        return _period_stack(cfg, params, x, positions, None, None)[0]
    if "layers_pre" in params:
        x, _ = _scan_stack(cfg, params["layers_pre"], x, positions, None, None)
    x, _ = _scan_stack(cfg, params["layers"], x, positions, None, None)
    return x


def _whisper_enc_layer(cfg: ArchConfig, lp: dict, h, positions):
    a = layer_norm(h, lp["ln1"], lp["b1"], cfg.norm_eps)
    out, _ = gqa_attention(cfg, lp["attn"], a, positions, causal=False)
    # (each sublayer's output pinned: where the residual's sum splits the
    # sequence, its gradient comes back gathered, as the products' views
    # take it)
    h = h + pin(out)
    f = whole_tokens(layer_norm(h, lp["ln2"], lp["b2"], cfg.norm_eps))
    return h + pin(gelu_mlp(f, lp["ffn"]["w_in"], lp["ffn"]["b_in"], lp["ffn"]["w_out"],
                            lp["ffn"]["b_out"]))


def _whisper_encode(cfg: ArchConfig, params, frames):
    """frames (B, T, D) stub embeddings -> encoder output (non-causal)."""
    B, T, D = frames.shape
    x = frames.to(_dtype(cfg.compute_dtype))
    x = x + sinusoidal_positions(torch.arange(T, device=x.device), D, x.dtype)[None]
    positions = _positions(B, T, x.device)
    for lp in _unstack(params["enc_layers"]):
        x = _run_layer(_whisper_enc_layer, True, cfg, lp, x, positions)
    return layer_norm(x, params["enc_norm"], params["enc_norm_b"], cfg.norm_eps)


def _whisper_dec_layer(cfg: ArchConfig, lp: dict, h, positions, enc_out, cache, cache_len):
    B = h.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim_
    a = layer_norm(h, lp["ln1"], lp["b1"], cfg.norm_eps)
    out, new_c = gqa_attention(cfg, lp["attn"], a, positions, cache, cache_len)
    h = h + pin(out)  # (as in the encoder's layers)
    xa = layer_norm(h, lp["ln_x"], lp["bx"], cfg.norm_eps)
    # the cross-attention's K / V from enc_out, in every layer: V takes bv,
    # K no bias
    ek = _enc_heads(enc_out @ lp["xattn"]["wk"].to(h.dtype), B, H, hd)
    ev = _enc_heads(enc_out @ lp["xattn"]["wv"].to(h.dtype) + lp["xattn"]["bv"].to(h.dtype),
                    B, H, hd)
    h = h + pin(cross_attention(cfg, lp["xattn"], xa, {"k": ek, "v": ev}))
    f = whole_tokens(layer_norm(h, lp["ln2"], lp["b2"], cfg.norm_eps))
    h = h + pin(gelu_mlp(f, lp["ffn"]["w_in"], lp["ffn"]["b_in"], lp["ffn"]["w_out"],
                         lp["ffn"]["b_out"]))
    return h, new_c


def _enc_heads(y, B: int, H: int, hd: int):
    """The encoder's K or V (B, T, n) as (B, -1, H, hd), the JAX package's
    reshape.  Where n is not H·hd (a config with fewer KV heads than
    heads) it folds T into the heads, so a split of n is gathered first."""
    if y.shape[-1] != H * hd:
        y = mergeable(y, 1, 2)
    return y.reshape(B, -1, H, hd)


def _whisper_decoder(cfg, params, x, positions, enc_out, caches, cache_len):
    """Decoder stack; the cross-attention's K / V recomputed from enc_out in
    each layer."""
    layer_caches = _unstack(caches) if caches is not None else None
    new_caches = []
    for i, lp in enumerate(_unstack(params["dec_layers"])):
        c = None if layer_caches is None else layer_caches[i]
        x, new_c = _run_layer(_whisper_dec_layer, True, cfg, lp, x, positions, enc_out, c,
                              cache_len)
        new_caches.append(new_c)
    return x, (_stack(new_caches) if caches is not None else None)


def _whisper_inputs(cfg: ArchConfig, params, tokens, positions):
    x = _embed(cfg, params, tokens)
    return x + sinusoidal_positions(positions, cfg.d_model, x.dtype)


def _embed_inputs(cfg: ArchConfig, params, batch):
    """Token embeddings; for ``vlm`` the first n_patches positions take the
    projected patches."""
    x = _embed(cfg, params, batch["tokens"])
    if cfg.family == "vlm":
        patches = batch["patches"].to(x.dtype) @ params["patch_proj"].to(x.dtype)
        x = torch.cat([patches, x[:, patches.shape[1]:]], dim=1)
    return x


def train_forward(cfg: ArchConfig, params, batch) -> tuple[torch.Tensor, dict]:
    """batch: tokens (B, L) [+ frames (B, T, D) for audio, patches
    (B, Np, D) for vlm].  Returns (mean xent loss, metrics)."""
    tokens = batch["tokens"]
    B, L = tokens.shape
    positions = _positions(B, L, tokens.device)
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
    if cfg.family == "audio":
        enc_out = _whisper_encode(cfg, params, batch["frames"])
        x = _whisper_inputs(cfg, params, tokens, positions)
        x, _ = _whisper_decoder(cfg, params, x, positions, enc_out, None, None)
        x = layer_norm(x, params["final_norm"], params["final_norm_b"], cfg.norm_eps)
    else:
        x = _backbone(cfg, params, _embed_inputs(cfg, params, batch), positions)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    loss = chunked_xent(cfg, x, _head_matrix(cfg, params), targets)
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def _layer_cache_shape(cfg: ArchConfig, layer: int, B: int, max_len: int) -> dict:
    """{name: (shape, dtype)} of layer ``layer``'s cache."""
    dt = _dtype(cfg.compute_dtype)
    if cfg.family in ("ssm", "hybrid") and not cfg.is_attn_layer(layer):
        di, N, H, P, W = (cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim,
                          cfg.ssm_conv_width)
        return {"conv": ((B, W - 1, di + 2 * N), dt), "ssm": ((B, H, P, N), torch.float32)}
    if cfg.mla:
        return {"c_kv": ((B, max_len, cfg.kv_lora_rank), dt),
                "k_rope": ((B, max_len, cfg.rope_head_dim), dt)}
    shape = (B, max_len, cfg.n_kv_heads, cfg.head_dim_)
    return {"k": (shape, dt), "v": (shape, dt)}


def init_cache(cfg: ArchConfig, B: int, max_len: int, device=None,
               abstract: bool = False) -> dict:
    """Zero caches stacked like the layer stacks, on ``device`` (default: the
    card); ``abstract`` as for :func:`init_params`."""
    dev = _abstract_device(device) if abstract else resolve_device(device)
    make = torch.empty if abstract else torch.zeros

    def stacked(layers) -> dict:
        shapes = [_layer_cache_shape(cfg, l, B, max_len) for l in layers]
        return {k: make((len(shapes),) + s, dtype=dt, device=dev)
                for k, (s, dt) in shapes[0].items()}

    if cfg.family == "audio":
        return {"dec": stacked(range(cfg.n_layers)),
                "enc_out": make((B, cfg.enc_positions, cfg.d_model),
                                dtype=_dtype(cfg.compute_dtype), device=dev)}
    if cfg.family == "hybrid":
        period = cfg.attn_every
        return {f"pos{p}": stacked([k * period + p for k in range(_n_periods(cfg))])
                for p in range(period)}
    caches = {}
    n_pre = _n_pre(cfg)
    if n_pre:
        caches["pre"] = stacked(range(n_pre))
    caches["layers"] = stacked(range(n_pre, cfg.n_layers))
    return caches


def _logits(cfg: ArchConfig, params, x):
    return (whole_tokens(x) @ _head_matrix(cfg, params).to(x.dtype)).float()


def _cached_stacks(cfg: ArchConfig, params, x, positions, caches, cache_len):
    """The decoder-only families' stacks over their caches; returns (x,
    new_caches)."""
    if cfg.family == "hybrid":
        return _period_stack(cfg, params, x, positions, caches, cache_len)
    new_caches = {}
    if "pre" in caches:
        x, new_caches["pre"] = _scan_stack(cfg, params["layers_pre"], x, positions,
                                           caches["pre"], cache_len)
    x, new_caches["layers"] = _scan_stack(cfg, params["layers"], x, positions,
                                          caches["layers"], cache_len)
    return x, new_caches


def decode_step(cfg: ArchConfig, params, caches, tokens, cache_len):
    """One decode step: tokens (B, 1) at position cache_len.  Returns
    (logits (B, 1, V), new_caches)."""
    B = tokens.shape[0]
    positions = torch.full((B, 1), int(cache_len), dtype=torch.int32, device=tokens.device)
    if cfg.family == "audio":
        x = _whisper_inputs(cfg, params, tokens, positions)
        x, dec = _whisper_decoder(cfg, params, x, positions, caches["enc_out"], caches["dec"],
                                  cache_len)
        x = layer_norm(x, params["final_norm"], params["final_norm_b"], cfg.norm_eps)
        return _logits(cfg, params, x), {"dec": dec, "enc_out": caches["enc_out"]}
    x, new_caches = _cached_stacks(cfg, params, _embed(cfg, params, tokens), positions, caches,
                                   cache_len)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x), new_caches


def prefill(cfg: ArchConfig, params, batch, max_len: int | None = None, caches=None):
    """Processes batch['tokens'] (B, L), returns (last-token logits, caches
    filled up to L).  ``caches``: the zero caches to fill, by default
    :func:`init_cache`'s for ``max_len`` on the tokens' device (a caller on
    a mesh passes them placed)."""
    tokens = batch["tokens"]
    B, L = tokens.shape
    if caches is None:
        caches = init_cache(cfg, B, max_len or L, tokens.device)
    positions = _positions(B, L, tokens.device)
    if cfg.family == "audio":
        enc_out = _whisper_encode(cfg, params, batch["frames"])
        x = _whisper_inputs(cfg, params, tokens, positions)
        x, dec = _whisper_decoder(cfg, params, x, positions, enc_out, caches["dec"], 0)
        x = layer_norm(x, params["final_norm"], params["final_norm_b"], cfg.norm_eps)
        return _logits(cfg, params, x[:, -1:]), {"dec": dec, "enc_out": enc_out}
    x, new_caches = _cached_stacks(cfg, params, _embed_inputs(cfg, params, batch), positions,
                                   caches, 0)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x[:, -1:]), new_caches
