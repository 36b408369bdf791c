"""AdamW from scratch (the JAX package's ``train/optim.py``): the state
mirrors the parameter tree; ``moment_dtype`` allows bf16 moments.

Plain functions over trees of tensors.  Not ``torch.optim.AdamW``: the
update below adds the decay to the Adam direction before the learning rate
scales both, and puts ``eps`` outside the bias-corrected square root.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    m: Any
    v: Any


def adamw_init(params, moment_dtype=None) -> AdamWState:
    def zeros_like(p):
        return torch.zeros(p.shape, dtype=moment_dtype or p.dtype, device=p.device)

    leaf = tree_leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=leaf.device),
        m=tree_map(zeros_like, params),
        v=tree_map(zeros_like, params),
    )


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, lr, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1):
    """Returns (new_params, new_state).  ``lr`` may be a 0-d tensor."""
    step = state.step + 1
    stepf = step.float()
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)

    def upd(p, g, m, v):
        g32 = g.float()
        m_new = b1 * m.float() + (1 - b1) * g32
        v_new = b2 * v.float() + (1 - b2) * g32 * g32
        mhat = m_new / c1
        vhat = v_new / c2
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
        p_new = p.float() - lr * delta
        return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)

    out = [upd(*leaves) for leaves in zip(*map(tree_leaves, (params, grads, state.m, state.v)))]
    new_p, new_m, new_v = (tree_unflatten(like, [o[i] for o in out])
                            for i, like in enumerate((params, state.m, state.v)))
    return new_p, AdamWState(step=step, m=new_m, v=new_v)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(leaf.float() ** 2) for leaf in tree_leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1) -> Callable[[torch.Tensor], torch.Tensor]:
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return lr
