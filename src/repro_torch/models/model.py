"""Model assembly for the data-selection-for-training testbed (the JAX
package's ``models/model.py``): the decoder-only ``dense`` and ``vlm``
families.  ``launch/train.py`` trains them with per-round submodular coreset
selection over their embeddings.

The parameter tree is the JAX package's: nested dicts of tensors with the
same key paths, each layer stack stacked on a leading axis, so a tree moves
across as a plain numpy map (``interop.params_from_arrays``).  The stack runs
as a loop over the layer index with ``torch.utils.checkpoint`` around each
layer while gradients are on (``jax.checkpoint`` in the JAX package), and the
loss recomputes its logits in backward.

Public entry points:
  init_params(cfg, seed, device)
  train_forward(cfg, params, batch) -> (loss, metrics)
  prefill(cfg, params, batch)       -> (logits_last, cache)
  decode_step(cfg, params, cache, tokens, cache_len) -> (logits, cache)
  init_cache(cfg, batch_size, max_len, device)

The ``moe``, ``hybrid``, ``ssm`` and ``audio`` families and MLA attention
are ROADMAP item 12.2: their configs raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import gqa_attention
from repro_torch.models.layers import rms_norm, swiglu
from repro_torch.tree import tree_map

FAMILIES = ("dense", "vlm")


def check_family(cfg: ArchConfig) -> None:
    """Raise for a config this slice of the port does not run yet."""
    if cfg.family not in FAMILIES or cfg.n_experts or cfg.mla:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family{' with MLA' if cfg.mla else ''} is ROADMAP "
            f"item 12.2 (MoE, Mamba, MLA, whisper, hybrid); the port runs {FAMILIES} so far"
        )


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class _Init:
    """Draws from one ``torch.Generator``: N(0, 1) in fp32, scaled, then cast
    to the parameter dtype, as the JAX package's ``_Init.mat`` does."""

    def __init__(self, seed: int, dtype: torch.dtype, device: torch.device):
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.dtype, self.device = dtype, device

    def mat(self, *shape, scale=0.02):
        x = torch.randn(shape, generator=self.gen, dtype=torch.float32, device=self.device)
        return (x * scale).to(self.dtype)

    def zeros(self, *shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def ones(self, *shape):
        return torch.ones(shape, dtype=self.dtype, device=self.device)


def _attn_params(cfg: ArchConfig, ini: _Init) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
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


def _ffn_params(cfg: ArchConfig, ini: _Init) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    return {"w_gate": ini.mat(D, F), "w_up": ini.mat(D, F), "w_down": ini.mat(F, D)}


def _decoder_layer_params(cfg: ArchConfig, ini: _Init) -> dict:
    D = cfg.d_model
    return {"ln1": ini.ones(D), "attn": _attn_params(cfg, ini), "ln2": ini.ones(D),
            "ffn": _ffn_params(cfg, ini)}


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


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """Parameters drawn from ``seed`` on ``device`` (default: the card)."""
    check_family(cfg)
    ini = _Init(seed, _dtype(cfg.param_dtype), resolve_device(device))
    D, V = cfg.d_model, cfg.vocab
    params: dict[str, Any] = {"embed": ini.mat(V, D)}
    if not cfg.tie_embeddings:
        params["lm_head"] = ini.mat(D, V)
    params["final_norm"] = ini.ones(D)
    if cfg.family == "vlm":
        params["patch_proj"] = ini.mat(D, D)
    params["layers"] = _stack([_decoder_layer_params(cfg, ini) for _ in range(cfg.n_layers)])
    return params


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------


def _apply_ffn(cfg: ArchConfig, lp: dict, h: torch.Tensor):
    return swiglu(h, lp["ffn"]["w_gate"], lp["ffn"]["w_up"], lp["ffn"]["w_down"])


def _norm(cfg: ArchConfig, x, scale):
    return rms_norm(x, scale, cfg.norm_eps)


def _decoder_layer(cfg: ArchConfig, lp: dict, x: torch.Tensor, positions: torch.Tensor,
                   cache: dict | None, cache_len):
    """Pre-norm block: attention + FFN.  Returns (x, new_cache)."""
    h = _norm(cfg, x, lp["ln1"])
    out, new_cache = gqa_attention(cfg, lp["attn"], h, positions, cache, cache_len)
    x = x + out
    h = _norm(cfg, x, lp["ln2"])
    x = x + _apply_ffn(cfg, lp, h)
    return x, new_cache


def _scan_stack(cfg, stacked, x, positions, caches, cache_len, remat=True):
    """Run a stacked layer group layer by layer.  caches: a stacked tree or
    None.  Each layer is recomputed in backward (``remat``) when gradients
    are on."""
    remat = remat and torch.is_grad_enabled()
    new_caches = []
    layer_caches = _unstack(caches) if caches is not None else None
    for i, lp in enumerate(_unstack(stacked)):
        c = None if layer_caches is None else layer_caches[i]
        if remat:
            x, new_c = checkpoint(_decoder_layer, cfg, lp, x, positions, c, cache_len,
                                  use_reentrant=False)
        else:
            x, new_c = _decoder_layer(cfg, lp, x, positions, c, cache_len)
        new_caches.append(new_c)
    return x, (_stack(new_caches) if caches is not None else None)


# ---------------------------------------------------------------------------
# embeddings and heads
# ---------------------------------------------------------------------------


def _embed(cfg: ArchConfig, params, tokens):
    return params["embed"][tokens].to(_dtype(cfg.compute_dtype))


def _head_matrix(cfg: ArchConfig, params):
    if cfg.tie_embeddings:
        return params["embed"].T  # (D, V)
    return params["lm_head"]


def _xent_piece(h, head, t):
    logits = (h @ head.to(h.dtype)).float()
    lse = torch.logsumexp(logits, dim=-1)
    # the label logit: the JAX package's one-hot contraction adds only zeros
    # to it, so a gather gives the same value
    ll = torch.gather(logits, -1, t.long()[..., None])[..., 0]
    return (lse - ll).sum()


def chunked_xent(cfg: ArchConfig, hidden: torch.Tensor, head: torch.Tensor,
                 targets: torch.Tensor, chunk: int | None = None):
    """Mean cross-entropy.  Each piece recomputes its (B, L, V) logits in
    backward and never keeps them; ``chunk`` splits the sequence into
    pieces of that length."""
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
    x, _ = _scan_stack(cfg, params["layers"], x, positions, None, None)
    return x


def _embed_inputs(cfg: ArchConfig, params, batch):
    """Token embeddings; for ``vlm`` the first n_patches positions take the
    projected patches."""
    x = _embed(cfg, params, batch["tokens"])
    if cfg.family == "vlm":
        patches = batch["patches"].to(x.dtype) @ params["patch_proj"].to(x.dtype)
        x = torch.cat([patches, x[:, patches.shape[1]:]], dim=1)
    return x


def train_forward(cfg: ArchConfig, params, batch) -> tuple[torch.Tensor, dict]:
    """batch: tokens (B, L) [+ patches (B, Np, D) for vlm].  Returns (mean
    xent loss, metrics)."""
    check_family(cfg)
    tokens = batch["tokens"]
    B, L = tokens.shape
    positions = _positions(B, L, tokens.device)
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
    x = _backbone(cfg, params, _embed_inputs(cfg, params, batch), positions)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    loss = chunked_xent(cfg, x, _head_matrix(cfg, params), targets)
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def _layer_cache_shape(cfg: ArchConfig, B: int, max_len: int) -> dict:
    """Shapes and dtype of one attention layer's cache."""
    shape = (B, max_len, cfg.n_kv_heads, cfg.head_dim_)
    return {"k": shape, "v": shape}


def init_cache(cfg: ArchConfig, B: int, max_len: int, device=None) -> dict:
    """Zero caches stacked like the layer stack, on ``device`` (default: the
    card)."""
    check_family(cfg)
    dev, dt = resolve_device(device), _dtype(cfg.compute_dtype)
    shapes = _layer_cache_shape(cfg, B, max_len)
    return {"layers": {k: torch.zeros((cfg.n_layers,) + s, dtype=dt, device=dev)
                       for k, s in shapes.items()}}


def _logits(cfg: ArchConfig, params, x):
    return (x @ _head_matrix(cfg, params).to(x.dtype)).float()


def decode_step(cfg: ArchConfig, params, caches, tokens, cache_len):
    """One decode step: tokens (B, 1) at position cache_len.  Returns
    (logits (B, 1, V), new_caches)."""
    check_family(cfg)
    B = tokens.shape[0]
    positions = torch.full((B, 1), int(cache_len), dtype=torch.int32, device=tokens.device)
    x = _embed(cfg, params, tokens)
    x, layers = _scan_stack(cfg, params["layers"], x, positions, caches["layers"], cache_len)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x), {"layers": layers}


def prefill(cfg: ArchConfig, params, batch, max_len: int | None = None):
    """Processes batch['tokens'] (B, L), returns (last-token logits, caches
    filled up to L)."""
    check_family(cfg)
    tokens = batch["tokens"]
    B, L = tokens.shape
    caches = init_cache(cfg, B, max_len or L, tokens.device)
    positions = _positions(B, L, tokens.device)
    x = _embed_inputs(cfg, params, batch)
    x, layers = _scan_stack(cfg, params["layers"], x, positions, caches["layers"], 0)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x[:, -1:]), {"layers": layers}
