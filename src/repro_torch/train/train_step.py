"""Training step factory (the JAX package's ``train/train_step.py``):
forward and backward, optional microbatch gradient accumulation (fp32
accumulators), gradient clipping, optional int8 error-feedback compression,
AdamW.  ``torch.autograd`` takes the place of ``jax.value_and_grad``."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import init_params, train_forward
from repro_torch.train.grad_compress import apply_error_feedback, ef_init
from repro_torch.train.optim import (
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    ef: Any  # ErrorFeedbackState | None


def init_train_state(cfg: ArchConfig, seed: int = 0, device=None, moment_dtype=None,
                     compress: bool = False) -> TrainState:
    """Parameters drawn from ``seed`` on ``device`` (default: the card),
    zero moments and, with ``compress``, a zero error-feedback residual."""
    params = init_params(cfg, seed, device)
    return TrainState(params=params, opt=adamw_init(params, moment_dtype=moment_dtype),
                      ef=ef_init(params) if compress else None)


def value_and_grad(cfg: ArchConfig, params, batch):
    """(loss, grads): grads in the parameters' dtypes and tree.  A leaf the
    loss does not reach (whisper's cross-attention ``bk``) gets a zero
    gradient, as ``jax.grad`` gives it."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, _ = train_forward(cfg, tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(cfg: ArchConfig, lr_schedule: Callable | None = None, grad_accum: int = 1,
                    max_grad_norm: float = 1.0, compress_grads: bool = False):
    lr_schedule = lr_schedule or cosine_schedule(3e-4, 100, 10000)

    def compute_grads(params, batch):
        if grad_accum == 1:
            return value_and_grad(cfg, params, batch)
        # microbatch accumulation: batch (B, ...) -> A microbatches (B/A, ...)
        micro = [{k: v.reshape((grad_accum, v.shape[0] // grad_accum) + v.shape[1:])[i]
                  for k, v in batch.items()} for i in range(grad_accum)]
        first = tree_leaves(params)[0]
        loss = torch.zeros((), dtype=torch.float32, device=first.device)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                         params)
        for mb in micro:
            l, g = value_and_grad(cfg, params, mb)
            loss = loss + l
            grads = tree_map(lambda a, b: a + b.to(a.dtype), grads, g)
        scale = 1.0 / grad_accum
        return loss * scale, tree_map(lambda g: g * scale, grads)

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        loss, grads = compute_grads(state.params, batch)
        ef = state.ef
        if compress_grads:
            grads, ef = apply_error_feedback(grads, ef)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        lr = lr_schedule(state.opt.step)
        params, opt = adamw_update(grads, state.opt, state.params, lr)
        return TrainState(params=params, opt=opt, ef=ef), {"loss": loss, "grad_norm": gnorm,
                                                           "lr": lr}

    return train_step
