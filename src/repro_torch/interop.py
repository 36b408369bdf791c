"""Carry state between the JAX package and the port as numpy arrays.

The port never sees a JAX type: a caller pulls arrays out of a JAX object
(``np.asarray(jfn.sim)``, ``np.asarray(jstate.curmax)``) and hands them
over here; results come back as numpy for comparison.
"""
from __future__ import annotations

import numpy as np

from repro_torch.common import as_float_tensor
from repro_torch.core.functions.facility_location import FacilityLocation, FLState
from repro_torch.core.optimizers.greedy import GreedyResult


def facility_location_from_arrays(
    sim: np.ndarray, use_kernel: bool | None = False, device=None
) -> FacilityLocation:
    """Port :class:`FacilityLocation` over a (|U|, n) similarity array, on
    ``device`` (default: the card)."""
    return FacilityLocation.from_kernel(np.asarray(sim, np.float32), use_kernel, device)


def fl_state_from_arrays(curmax: np.ndarray, device=None) -> FLState:
    """Port :class:`FLState` from a JAX state's ``curmax`` array."""
    cm = as_float_tensor(np.asarray(curmax, np.float32), device)
    return FLState(curmax=cm, n_rows=int(cm.shape[0]))


def result_to_numpy(res: GreedyResult) -> tuple[np.ndarray, np.ndarray, int, float]:
    """(order int32, gains fp32, n_evals, value) of a port result."""
    return (
        res.order.cpu().numpy().astype(np.int32),
        res.gains.cpu().numpy().astype(np.float32),
        int(res.n_evals),
        float(res.value),
    )
