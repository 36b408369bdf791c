"""Shared cases of the port's mesh-training tests
(``tests/test_torch_sharding.py``, ``tests/test_torch_sharded_steps.py``):
a stand-in mesh of axis names and sizes, token batches, the port's
unsharded steps, and the MoE layer's inputs."""
import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.distributed.act_sharding import activation_sharding
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.tree import flatten_with_names


class StubMesh:
    """Axis names and sizes of a mesh, as both packages' rules read them:
    the port's ``mesh_dim_names`` / ``size(dim)``, the JAX package's
    ``axis_names`` / ``shape[name]``."""

    def __init__(self, shape, names):
        self.mesh_dim_names = self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))
        self._sizes = tuple(shape)

    def size(self, dim=None):
        return int(np.prod(self._sizes)) if dim is None else self._sizes[dim]


def batches(cfg, n, B, L, seed):
    rng = np.random.default_rng(seed)
    return [{"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, L)).astype(np.int32))}
            for _ in range(n)]


def unsharded(cfg, batches, seed=0, tp=1):
    """The port's unsharded steps (losses, final state by name); ``tp`` > 1
    runs them inside an activation-sharding context of a (2, tp) stub mesh,
    where the tensors stay whole and ``tp_size()`` is ``tp``."""
    state, step, losses = init_train_state(cfg, seed=seed, device="cpu"), make_train_step(cfg), []
    for b in batches:
        if tp > 1:
            with activation_sharding(StubMesh((2, tp), ("data", "model"))):
                state, m = step(state, b)
        else:
            state, m = step(state, b)
        losses.append(m["loss"])
    return losses, dict(flatten_with_names(state))


def drop_cfg(arch):
    # capacity 1: some (token, k) pairs drop, so the group count matters
    return dataclasses.replace(get_config(arch).reduced(), capacity_factor=1.0)


def moe_inputs():
    cfg = drop_cfg("deepseek-v2-236b")
    rng = np.random.default_rng(7)
    D, E, F = cfg.d_model, cfg.n_experts, cfg.d_expert_
    Fs = cfg.n_shared_experts * F
    params = {k: (rng.normal(size=s) * 0.05).astype(np.float32) for k, s in {
        "router": (D, E), "w_gate": (E, D, F), "w_up": (E, D, F), "w_down": (E, F, D),
        "shared_gate": (D, Fs), "shared_up": (D, Fs), "shared_down": (Fs, D)}.items()}
    # 160 tokens in groups of 64: 3 groups, 4 at tp_size 2
    x = rng.normal(size=(4, 160, D)).astype(np.float32)
    return cfg, params, x
