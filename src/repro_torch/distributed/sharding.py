"""The training mesh's axis names (the JAX package's
``distributed/sharding.py:25``).

The single-pod mesh shards the batch over ``("data",)`` and the multi-pod
mesh over ``("pod", "data")``; the model axis is ``"model"``.  The
per-architecture parameter rules of the JAX module wait for the model
slice (ROADMAP queue 1, item 12).
"""
from __future__ import annotations

TP = "model"


def data_axes(mesh) -> tuple[str, ...]:
    """The dimension names of ``mesh`` (a ``DeviceMesh``, e.g. from
    ``distributed.make_mesh``) among ``("pod", "data")``, in mesh order."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
