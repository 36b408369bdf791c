"""torch 2.11's DTensor view rule, enforced on a torch that folds split dims.

torch 2.11's DTensor refuses a view or reshape that flattens several dims of
a DTensor when one of them other than the group's first is split ("Attempted
to flatten multiple dimensions, with dimension N being sharded"); later
torches make a strided shard and run it.  :class:`RefuseSplitFolds` is a
dispatch mode that raises 2.11's error there.  A dispatch mode runs before
DTensor's own dispatch, so it sees the DTensor and its global shape; the
local ops DTensor then runs pass through.  It imports the port alone (no
JAX): the spawned worlds of ``tests/_torch_dist_world.py`` use it too.
"""
from torch.utils._python_dispatch import TorchDispatchMode

_VIEWS = ("view", "_unsafe_view", "reshape")


def _flattens(rule) -> list:
    """The Flatten groups of a ``view_groups`` rule, as lists of input dims
    (a Split of a Flatten counts as its Flatten)."""
    from torch.distributed.tensor._ops._view_ops import Flatten, InputDim, Split

    groups = []
    for spec in rule:
        while isinstance(spec, Split):
            spec = spec.input_dim
        if isinstance(spec, Flatten):
            groups.append([d.input_dim for d in spec.input_dims if isinstance(d, InputDim)])
    return groups


def refused_dim(x, shape) -> int | None:
    """The split dim that a view of DTensor ``x`` to ``shape`` folds behind
    its group's first, where torch 2.11 refuses; None where it runs."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor._ops._view_ops import view_groups

    split = {p.dim for p in x.placements if isinstance(p, Shard)}
    for group in _flattens(view_groups(tuple(x.shape), tuple(shape))):
        for d in group[1:]:
            if d in split:
                return d
    return None


def check(func, args, refused: list | None = None) -> None:
    """Raises torch 2.11's RuntimeError where ``func`` is a view,
    ``_unsafe_view`` or reshape of a DTensor that folds a split dim not
    first in its group (appending it to ``refused`` first)."""
    from torch.distributed.tensor import DTensor

    name = func.overloadpacket.__name__
    if name not in _VIEWS or len(args) < 2 or not isinstance(args[0], DTensor):
        return
    d = refused_dim(args[0], args[1])
    if d is None:
        return
    if refused is not None:
        refused.append((name, tuple(args[0].shape), tuple(args[1]), d))
    raise RuntimeError(f"Attempted to flatten multiple dimensions, with dimension {d} being "
                       f"sharded. It cannot be performed without redistribution, which is "
                       f"disallowed by the current operator. ({name} of {tuple(args[0].shape)} "
                       f"to {tuple(args[1])}, placements {tuple(args[0].placements)})")


class RefuseSplitFolds(TorchDispatchMode):
    """:func:`check` on every op, which then runs as it would.  ``refused``
    lists what was refused.  A mode entered inside this one that hands
    DTensor ops on to DTensor (``launch/dryrun.py``'s ``CostCounter``)
    keeps them from it: use :func:`refusing_counter` there."""

    def __init__(self):
        super().__init__()
        self.refused = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        check(func, args, self.refused)
        return func(*args, **(kwargs or {}))


def refusing_counter():
    """``launch/dryrun.py``'s ``CostCounter`` with :func:`check` before it
    counts: the dry run refuses as torch 2.11 does."""
    from repro_torch.launch.dryrun import CostCounter

    class RefusingCounter(CostCounter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            check(func, args)
            return super().__torch_dispatch__(func, types, args, kwargs)

    return RefusingCounter
