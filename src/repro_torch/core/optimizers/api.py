"""Deprecated submodlib-style ``maximize`` entry point (paper §7).

    greedy_list = maximize(fn, budget=10, optimizer="NaiveGreedy")

``maximize`` is a thin shim over the typed front door::

    from repro_torch.core import SelectionSpec, solve
    result = solve(SelectionSpec(fn, 10, "NaiveGreedy"))
    greedy_list = result.as_list()

The shim keeps the bit-identical contract (ids, gains, ``n_evals``) and the
submodlib-style ``[(index, gain), ...]`` return value, but emits a single
``DeprecationWarning`` per call.  Unknown or misspelled options (e.g.
``stopIfZeroGian``) raise ``TypeError`` naming the valid set, and stop-rule
defaults resolve against the per-family table.
"""
from __future__ import annotations

import warnings

from repro_torch.core.optimizers.greedy import GreedyResult
from repro_torch.core.optimizers.spec import SelectionSpec, solve


def _warn_shim(old: str, new: str) -> None:
    """One DeprecationWarning per legacy call."""
    warnings.warn(
        f"{old} is deprecated; use {new} (see docs/api.md for the migration table)",
        DeprecationWarning,
        stacklevel=3,
    )


def maximize(
    fn,
    budget: int,
    optimizer: str = "NaiveGreedy",
    return_result: bool = False,
    **kwargs,
) -> list | GreedyResult:
    """Deprecated: delegate to ``solve(SelectionSpec(...))``.

    kwargs are split exactly as the spec constructor does: stop rules go to
    the :class:`SelectionSpec`, everything else is validated as optimizer
    hyperparameters."""
    _warn_shim("maximize()", "solve(SelectionSpec(fn, budget, optimizer, ...))")
    spec = SelectionSpec(
        fn,
        budget,
        optimizer,
        stopIfZeroGain=kwargs.pop("stopIfZeroGain", None),
        stopIfNegativeGain=kwargs.pop("stopIfNegativeGain", None),
        **kwargs,
    )
    result = solve(spec)
    return result if return_result else result.as_list()
