"""Device meshes for the dry run and training (the JAX package's
``launch/mesh.py``).

``make_production_mesh`` builds the 256-rank single-pod (16, 16)
``("data", "model")`` mesh or the 512-rank (2, 16, 16) ``("pod", "data",
"model")`` multi-pod mesh that ``launch/dryrun.py`` traces against (over a
fake process group there); ``make_test_mesh`` builds small meshes for tests
and runs on one host.  Both go through
:func:`repro_torch.core.optimizers.distributed.make_mesh`, so every rank
must have called ``torch.distributed.init_process_group`` first, and every
axis group carries that function's timeout.

Functions, not module constants: importing this module touches no process
group.
"""
from __future__ import annotations

import math

import torch.distributed as dist


def make_production_mesh(*, multi_pod: bool = False, device=None, **kw):
    """The (16, 16) or (2, 16, 16) production mesh over the default process
    group; raises when the world is smaller than the mesh.  ``device`` and
    ``timeout`` as for ``make_mesh`` (default: the card)."""
    from repro_torch.core.optimizers.distributed import make_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}; the world has {world}. The dry run "
            "(launch/dryrun.py) starts a fake process group of that size."
        )
    return make_mesh(shape, axes, device=device, **kw)


def make_test_mesh(shape=(1, 1), axes=("data", "model"), device=None, **kw):
    """A small mesh over the default process group, for tests and one-host
    runs; ``device`` and ``timeout`` as for ``make_mesh``."""
    from repro_torch.core.optimizers.distributed import make_mesh

    return make_mesh(shape, axes, device=device, **kw)
