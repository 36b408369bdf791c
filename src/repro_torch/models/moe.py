"""Mixture-of-Experts (the JAX package's ``models/moe.py``): token-choice
top-k routing with GShard-style grouped one-hot dispatch (capacity-dropped),
plus dense shared experts.

- Tokens are reshaped into groups of ``moe_group_size``, so the dispatch
  einsum costs g / (3 d_ff) of the expert FFN instead of growing with the
  whole token count.
- Capacity with token dropping: a (token, k) pair past its expert's
  capacity passes through the residual only.  Slots are taken in the order
  of the flattened (g·K) axis, token-major and k-minor, as in the JAX
  package, so the same pairs drop.
- The router runs in fp32; dispatch / combine are built in fp32 and cast
  to the activations' dtype.
- The group count is rounded up to a multiple of the model axis' size
  (``tp_size()``, 1 outside a mesh), so the group dim carries the ``"tp"``
  sharding; that changes g, the capacity and so which pairs drop, as in
  the JAX package.

The group layout is (B, nL, g, D): the batch dim keeps its ``"dp"``
sharding and the group dim its ``"tp"`` sharding through every einsum.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.act_sharding import constrain, dense, tp_size
from repro_torch.models.layers import swiglu


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, equal values
    lowest index first (a stable descending sort; ``torch.topk`` promises
    no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _einsum(eq: str, *operands):
    """``torch.einsum`` whose DTensor operands and result keep global
    strides that describe their local blocks (``act_sharding.dense``)."""
    return dense(torch.einsum(eq, *(dense(x) for x in operands)))


def dispatch_combine(gate_vals: torch.Tensor, gate_idx: torch.Tensor, n_experts: int, cap: int):
    """(dispatch, combine, kept) of one routing: gate_vals / gate_idx
    (B, nL, g, K) -> dispatch and combine (B, nL, g, E, cap) in fp32, and
    ``kept`` (B, nL, g, K), whether each (token, k) pair found a slot."""
    B, nL, g, K = gate_idx.shape
    onehot = F.one_hot(gate_idx.long(), n_experts).float()  # (B, nL, g, K, E)
    # position of each (token, k) inside its expert's capacity buffer
    pos = torch.cumsum(onehot.reshape(B, nL, g * K, n_experts), dim=2).reshape(
        B, nL, g, K, n_experts) * onehot - 1.0
    kept = (pos >= 0) & (pos < cap)
    pos = torch.where(kept, pos, 0.0).long()
    cap_oh = F.one_hot(pos, cap).float() * kept[..., None]
    dispatch = (onehot[..., None] * cap_oh).sum(dim=3)
    combine = (gate_vals[..., None, None] * onehot[..., None] * cap_oh).sum(dim=3)
    return dispatch, combine, kept.any(dim=-1)


def moe_ffn(cfg: ArchConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, L, D) -> (B, L, D)."""
    B, L, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    dt = x.dtype
    ts = max(tp_size(), 1)
    g_target = min(cfg.moe_group_size, L)
    nL = -(-L // g_target)  # ceil
    nL = -(-nL // ts) * ts  # round up to a multiple of ts
    g = -(-L // nL)
    pad = nL * g - L
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    cap = max(1, int(g * K * cfg.capacity_factor / E))

    xt = x.reshape(B, nL, g, D)
    xt = constrain(xt, ("dp", "tp", None, None))
    router_logits = _einsum("bngd,de->bnge", xt.float(), params["router"].float())
    # the routing tensors keep the tokens' sharding
    router_logits = constrain(router_logits, ("dp", "tp", None, None))
    probs = torch.softmax(router_logits, dim=-1)  # (B, nL, g, E)
    gate_vals, gate_idx = top_k(probs, K)  # (B, nL, g, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    dispatch, combine, _ = dispatch_combine(gate_vals, gate_idx, E, cap)

    # group (blocks over tp) -> expert (E over tp): the MoE all-to-all, between
    # these two constraints
    expert_in = _einsum("bngec,bngd->bnecd", dispatch.to(dt), xt)
    expert_in = constrain(expert_in, ("dp", None, "tp", None, None))
    h = F.silu(_einsum("bnecd,edf->bnecf", expert_in, params["w_gate"].to(dt))) * \
        _einsum("bnecd,edf->bnecf", expert_in, params["w_up"].to(dt))
    expert_out = _einsum("bnecf,efd->bnecd", h, params["w_down"].to(dt))
    expert_out = constrain(expert_out, ("dp", None, "tp", None, None))
    y = _einsum("bngec,bnecd->bngd", combine.to(dt), expert_out)
    y = constrain(y, ("dp", "tp", None, None))

    y = y.reshape(B, L + pad, D)
    if cfg.n_shared_experts:
        y = y + swiglu(x, params["shared_gate"], params["shared_up"], params["shared_down"])
    if pad:
        y = y[:, :L]
    return y


def moe_aux_loss(router_probs: torch.Tensor, gate_idx: torch.Tensor, n_experts: int):
    """Switch-style load-balancing auxiliary loss (for the training loop)."""
    me = router_probs.mean(dim=tuple(range(router_probs.ndim - 1)))
    ce = F.one_hot(gate_idx[..., 0].long(), n_experts).float().mean(
        dim=tuple(range(gate_idx.ndim - 1)))
    return n_experts * torch.sum(me * ce)
