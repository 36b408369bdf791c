"""SubmodularSelector — the paper's technique as a training-pipeline stage
(the JAX package's ``data/selection.py``).

Every ``rounds`` steps: embed a candidate pool with the current model, build
a similarity kernel (the CUDA kernel where ``use_pallas_kernel``), maximize a
submodular function (the distributed partition greedy on the training
mesh, :meth:`SubmodularSelector.selection_step`), train on the coreset.

Selection objectives (paper §1 applications):
  representative : FacilityLocation       — vanilla coreset ("efficient training")
  targeted       : FLQMI vs a query set   — "targeted learning"
  diverse        : DisparitySum           — diversity sampling
  privacy        : FLCG vs a private set  — "privacy-preserving selection"

:class:`SelectorConfig` keeps the JAX package's fields, so a config moves
across unchanged.  ``use_pallas_kernel`` (the JAX package's name) selects
the CUDA kernels: the similarity kernel, and the FL and DisparitySum gain
sweeps by the backend gate (``use_kernel=None``: the kernels on the card at
kernel-sized n); False keeps every step on torch ops.  StochasticGreedy
draws with key 0, ``jax.random.PRNGKey(0)``'s bits, so every optimizer
picks the JAX package's ids on the same kernel.  Embeddings given as numpy
go to ``device`` (default: the card); a tensor keeps its device.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import (
    FLCG,
    FLQMI,
    DisparitySum,
    FacilityLocation,
    create_kernel,
    lazy_greedy,
    naive_greedy,
    stochastic_greedy,
)
from repro_torch.core.optimizers import _threefry


@dataclasses.dataclass
class SelectorConfig:
    objective: Literal["representative", "targeted", "diverse", "privacy"] = (
        "representative"
    )
    budget: int = 64
    metric: str = "euclidean"
    optimizer: str = "LazyGreedy"
    eta: float = 1.0
    nu: float = 1.0
    use_pallas_kernel: bool = True


class SubmodularSelector:
    def __init__(self, cfg: ArchConfig, sel: SelectorConfig, device=None):
        self.cfg = cfg
        self.sel = sel
        self.device = device

    def _kernel(self, x, y=None) -> torch.Tensor:
        return create_kernel(x, y, metric=self.sel.metric, use_pallas=self.sel.use_pallas_kernel,
                             device=self.device)

    def build_function(self, pool_emb, query_emb=None, private_emb=None):
        uk = None if self.sel.use_pallas_kernel else False
        if self.sel.objective == "representative":
            return FacilityLocation.from_kernel(self._kernel(pool_emb), use_kernel=uk)
        if self.sel.objective == "targeted":
            assert query_emb is not None
            return FLQMI.build(self._kernel(query_emb, pool_emb), eta=self.sel.eta)
        if self.sel.objective == "diverse":
            sim = self._kernel(pool_emb)
            dist = 1.0 / torch.clamp(sim, min=1e-6) - 1.0  # invert 1/(1+d)
            return DisparitySum.from_distance(dist, use_kernel=uk)
        if self.sel.objective == "privacy":
            assert private_emb is not None
            return FLCG.build(self._kernel(pool_emb), self._kernel(pool_emb, private_emb),
                              nu=self.sel.nu)
        raise ValueError(self.sel.objective)

    def select(self, pool_emb, query_emb=None, private_emb=None) -> np.ndarray:
        fn = self.build_function(pool_emb, query_emb, private_emb)
        budget = min(self.sel.budget, fn.n)
        if self.sel.optimizer == "LazyGreedy":
            res = lazy_greedy(fn, budget, 8, False, False)
        elif self.sel.optimizer == "StochasticGreedy":
            res = stochastic_greedy(fn, budget, _threefry.prng_key(0), 0.01, None, False, False)
        else:
            res = naive_greedy(fn, budget, False, False)
        order = res.order.cpu().numpy()
        return order[order >= 0]

    def selection_step(self, pool_emb, mesh, budget: int | None = None):
        """Distributed selection on the training mesh (``launch/dryrun.py``
        calls it in the JAX package): every rank builds the kernel and keeps
        its block, rows over ``"model"`` and columns over the mesh's data
        axes, and the partition greedy elects each step's winner with O(1)
        payloads.  Every rank calls it; returns (order, gains), the same on
        every rank."""
        from repro_torch.core import distributed_fl_greedy
        from repro_torch.distributed.sharding import data_axes

        sim = self._kernel(pool_emb)
        return distributed_fl_greedy(
            sim,
            budget or self.sel.budget,
            mesh,
            row_axes=("model",),
            col_axes=data_axes(mesh),
        )
