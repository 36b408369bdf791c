"""Carry state between the JAX package and the port as numpy arrays.

The port never sees a JAX type: a caller pulls arrays out of a JAX object
(``np.asarray(jfn.sim)``, ``np.asarray(jstate.curmax)``) and hands them
over here; results come back as numpy for comparison.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.common import as_float_tensor
from repro_torch.core.functions.disparity import (
    DisparityMin,
    DisparityMinSum,
    DisparitySum,
    DMinState,
    DMinSumState,
    DSumState,
)
from repro_torch.core.functions.facility_location import FacilityLocation, FLState
from repro_torch.core.functions.feature_based import FBState, FeatureBased
from repro_torch.core.functions.graph_cut import GCState, GraphCut, GraphCutMF
from repro_torch.core.functions.log_det import LogDet, LogDetState
from repro_torch.core.functions.set_cover import (
    ProbabilisticSetCover,
    PSCState,
    SCState,
    SetCover,
    probs_of,
)
from repro_torch.core.info.com import ConcaveOverModular
from repro_torch.core.info.fl import FLCG, FLCMI, FLQMI, FLVMI
from repro_torch.core.info.gc import GCMI
from repro_torch.core.optimizers.greedy import GreedyResult
from repro_torch.core.sources import FeatureSource, KnnSource, knn_source


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


def feature_source_from_arrays(
    x: np.ndarray,
    y: np.ndarray,
    xx: np.ndarray,
    yy: np.ndarray,
    metric: str,
    rbf_sigma: float | None = None,
    row_labels: np.ndarray | None = None,
    col_labels: np.ndarray | None = None,
    device=None,
) -> FeatureSource:
    """Port :class:`FeatureSource` from a JAX source's fields, taken as they
    are (rows already normalised for cosine, norms already computed)."""
    x_t = as_float_tensor(np.asarray(x, np.float32), device).contiguous()
    dev = x_t.device

    def lab(a):
        return None if a is None else torch.as_tensor(np.asarray(a, np.int32), device=dev)

    y_t = as_float_tensor(np.asarray(y, np.float32), dev).contiguous()
    return FeatureSource(
        x=x_t, y=y_t,
        xx=as_float_tensor(np.asarray(xx, np.float32), dev),
        yy=as_float_tensor(np.asarray(yy, np.float32), dev),
        row_labels=lab(row_labels), col_labels=lab(col_labels),
        metric=metric, rbf_sigma=rbf_sigma, d=int(x_t.shape[1]),
        n_rows=int(x_t.shape[0]), n_cols=int(y_t.shape[0]),
    )


def knn_source_from_arrays(
    indices: np.ndarray, weights: np.ndarray, n_cols: int | None = None, device=None
) -> KnnSource:
    """Port :class:`KnnSource` from a JAX source's ``indices`` / ``weights``
    arrays (``np.asarray(jsrc.indices)``), on ``device`` (default: the card)."""
    return knn_source(
        np.asarray(indices, np.int32), np.asarray(weights, np.float32), n_cols=n_cols,
        device=device,
    )


def graph_cut_mf_from_arrays(
    src: FeatureSource,
    total: np.ndarray,
    diag: np.ndarray,
    lam,
    use_kernel: bool | None = False,
) -> GraphCutMF:
    """Port :class:`GraphCutMF` over a ported square source, with a JAX
    function's ``total``, ``diag`` and ``lam``."""
    dev = src.device
    return GraphCutMF(
        src=src,
        total=as_float_tensor(np.asarray(total, np.float32), dev),
        diag=as_float_tensor(np.asarray(diag, np.float32), dev),
        lam=as_float_tensor(np.asarray(lam, np.float32), dev).reshape(()),
        n=src.n_cols,
        use_kernel=use_kernel,
    )


def gc_state_from_arrays(
    selsum: np.ndarray, value, selmask: np.ndarray, device=None
) -> GCState:
    """Port :class:`GCState` from a JAX state's arrays."""
    selsum_t = as_float_tensor(np.asarray(selsum, np.float32), device)
    dev = selsum_t.device
    return GCState(
        selsum=selsum_t,
        value=as_float_tensor(np.asarray(value, np.float32), dev).reshape(()),
        selmask=as_float_tensor(np.asarray(selmask, np.float32), dev),
    )


def graph_cut_from_arrays(
    sim: np.ndarray, total: np.ndarray, lam, use_kernel: bool | None = False, device=None
) -> GraphCut:
    """Port :class:`GraphCut` from a JAX function's ``sim_ground``, ``total``
    and ``lam``, on ``device`` (default: the card)."""
    sim_t = as_float_tensor(np.asarray(sim, np.float32), device).contiguous()
    dev = sim_t.device
    return GraphCut(
        sim_ground=sim_t,
        total=as_float_tensor(np.asarray(total, np.float32), dev),
        lam=as_float_tensor(np.asarray(lam, np.float32), dev).reshape(()),
        n=int(sim_t.shape[0]),
        use_kernel=use_kernel,
    )


def disparity_sum_from_arrays(
    dist: np.ndarray, use_kernel: bool | None = False, device=None
) -> DisparitySum:
    """Port :class:`DisparitySum` over an (n, n) distance array."""
    return DisparitySum.from_distance(np.asarray(dist, np.float32), use_kernel, device)


def disparity_min_from_arrays(
    dist: np.ndarray, use_kernel: bool | None = False, device=None
) -> DisparityMin:
    """Port :class:`DisparityMin` over an (n, n) distance array."""
    return DisparityMin.from_distance(np.asarray(dist, np.float32), use_kernel, device)


def disparity_min_sum_from_arrays(dist: np.ndarray, device=None) -> DisparityMinSum:
    """Port :class:`DisparityMinSum` over an (n, n) distance array."""
    return DisparityMinSum.from_distance(np.asarray(dist, np.float32), device)


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=device).to(dtype)


def dsum_state_from_arrays(selsum: np.ndarray, selmask: np.ndarray, device=None) -> DSumState:
    """Port :class:`DSumState` from a JAX state's arrays."""
    selsum_t = as_float_tensor(np.asarray(selsum, np.float32), device)
    return DSumState(selsum=selsum_t, selmask=_tensor(selmask, torch.float32, selsum_t.device))


def dmin_state_from_arrays(
    mind: np.ndarray, curmin, count, selmask: np.ndarray, device=None
) -> DMinState:
    """Port :class:`DMinState` from a JAX state's arrays."""
    mind_t = as_float_tensor(np.asarray(mind, np.float32), device)
    dev = mind_t.device
    return DMinState(
        mind=mind_t,
        curmin=_tensor(curmin, torch.float32, dev).reshape(()),
        count=_tensor(count, torch.int32, dev).reshape(()),
        selmask=_tensor(selmask, torch.float32, dev),
    )


def dmin_sum_state_from_arrays(
    t: np.ndarray, selected: np.ndarray, count, value, device=None
) -> DMinSumState:
    """Port :class:`DMinSumState` from a JAX state's arrays."""
    t_t = as_float_tensor(np.asarray(t, np.float32), device)
    dev = t_t.device
    return DMinSumState(
        t=t_t,
        selected=_tensor(selected, torch.bool, dev),
        count=_tensor(count, torch.int32, dev).reshape(()),
        value=_tensor(value, torch.float32, dev).reshape(()),
    )


def feature_based_from_arrays(
    feats: np.ndarray, w: np.ndarray, concave: str = "sqrt", use_kernel: bool | None = False,
    device=None,
) -> FeatureBased:
    """Port :class:`FeatureBased` from a JAX function's ``feats`` (already
    clamped at 0) and ``w``."""
    return FeatureBased.from_features(np.asarray(feats, np.float32), np.asarray(w, np.float32),
                                      concave, use_kernel, device)


def set_cover_from_arrays(
    cover: np.ndarray, w: np.ndarray, use_kernel: bool | None = False, device=None
) -> SetCover:
    """Port :class:`SetCover` from a JAX function's ``cover`` and ``w``."""
    return SetCover.from_cover(np.asarray(cover, np.float32), np.asarray(w, np.float32),
                               use_kernel, device)


def probabilistic_set_cover_from_arrays(
    log_miss: np.ndarray, w: np.ndarray, use_kernel: bool | None = False, device=None
) -> ProbabilisticSetCover:
    """Port :class:`ProbabilisticSetCover` from a JAX function's ``log_miss``
    and ``w``, taking ``log_miss`` as it is (not recomputed from
    probabilities), so both packages hold the same bits; ``probs`` is formed
    from it with the JAX package's expression."""
    lm = as_float_tensor(np.asarray(log_miss, np.float32), device).contiguous()
    return ProbabilisticSetCover(
        log_miss=lm, probs=probs_of(lm),
        w=as_float_tensor(np.asarray(w, np.float32), lm.device),
        n=int(lm.shape[0]), use_kernel=use_kernel,
    )


def fb_state_from_arrays(acc: np.ndarray, device=None) -> FBState:
    """Port :class:`FBState` from a JAX state's ``acc`` array."""
    return FBState(acc=as_float_tensor(np.asarray(acc, np.float32), device))


def sc_state_from_arrays(covered: np.ndarray, device=None) -> SCState:
    """Port :class:`SCState` from a JAX state's ``covered`` array."""
    return SCState(covered=as_float_tensor(np.asarray(covered, np.float32), device))


def psc_state_from_arrays(miss: np.ndarray, device=None) -> PSCState:
    """Port :class:`PSCState` from a JAX state's ``miss`` array."""
    return PSCState(miss=as_float_tensor(np.asarray(miss, np.float32), device))


def log_det_from_arrays(L: np.ndarray, max_select: int | None = None, device=None) -> LogDet:
    """Port :class:`LogDet` over a JAX function's ``L`` and ``max_select``."""
    return LogDet.from_kernel(np.asarray(L, np.float32), max_select, device)


def log_det_state_from_arrays(C: np.ndarray, d2: np.ndarray, count, value,
                              device=None) -> LogDetState:
    """Port :class:`LogDetState` from a JAX state's arrays."""
    C_t = as_float_tensor(np.asarray(C, np.float32), device)
    dev = C_t.device
    return LogDetState(
        C=C_t,
        d2=as_float_tensor(np.asarray(d2, np.float32), dev),
        count=_tensor(count, torch.int32, dev).reshape(()),
        value=_tensor(value, torch.float32, dev).reshape(()),
    )


def _f32(a, device) -> torch.Tensor:
    return as_float_tensor(np.asarray(a, np.float32), device)


def flvmi_from_arrays(sim: np.ndarray, qmax: np.ndarray, device=None) -> FLVMI:
    """Port :class:`FLVMI` from a JAX function's ``sim`` and (eta-scaled) ``qmax``."""
    sim_t = _f32(sim, device).contiguous()
    return FLVMI(sim=sim_t, qmax=_f32(qmax, sim_t.device), n=int(sim_t.shape[1]))


def flqmi_from_arrays(sim_qv: np.ndarray, modular: np.ndarray, device=None) -> FLQMI:
    """Port :class:`FLQMI` from a JAX function's ``sim_qv`` and ``modular``."""
    sim_t = _f32(sim_qv, device).contiguous()
    return FLQMI(sim_qv=sim_t, modular=_f32(modular, sim_t.device), n=int(sim_t.shape[1]))


def flcg_from_arrays(sim: np.ndarray, pmax: np.ndarray, device=None) -> FLCG:
    """Port :class:`FLCG` from a JAX function's ``sim`` and (nu-scaled) ``pmax``."""
    sim_t = _f32(sim, device).contiguous()
    return FLCG(sim=sim_t, pmax=_f32(pmax, sim_t.device), n=int(sim_t.shape[1]))


def flcmi_from_arrays(sim: np.ndarray, qmax: np.ndarray, pmax: np.ndarray,
                      device=None) -> FLCMI:
    """Port :class:`FLCMI` from a JAX function's ``sim``, ``qmax`` and ``pmax``."""
    sim_t = _f32(sim, device).contiguous()
    dev = sim_t.device
    return FLCMI(sim=sim_t, qmax=_f32(qmax, dev), pmax=_f32(pmax, dev), n=int(sim_t.shape[1]))


def gcmi_from_arrays(qsum: np.ndarray, device=None) -> GCMI:
    """Port :class:`GCMI` from a JAX function's ``qsum``."""
    q = _f32(qsum, device)
    return GCMI(qsum=q, n=int(q.shape[0]))


def com_from_arrays(sim_vq: np.ndarray, modular: np.ndarray, concave: str = "sqrt",
                    device=None) -> ConcaveOverModular:
    """Port :class:`ConcaveOverModular` from a JAX function's ``sim_vq``,
    ``modular`` and ``concave``."""
    sim_t = _f32(sim_vq, device).contiguous()
    return ConcaveOverModular(sim_vq=sim_t, modular=_f32(modular, sim_t.device),
                              n=int(sim_t.shape[0]), concave=concave)


def state_from_arrays(arrays, like):
    """Port any state from the arrays of a JAX state, shaped by ``like`` (the
    port function's ``init_state()``): a bare tensor state (GCMI's running
    value, COM's ``acc``) takes one array, a tuple state (the difference
    combinator's pair) a tuple of states, a dataclass state an object with
    the same field names (the JAX state itself) or a dict.  Each tensor
    takes ``like``'s dtype and device; static fields keep ``like``'s."""
    if isinstance(like, torch.Tensor):
        return _tensor(arrays, like.dtype, like.device).reshape(like.shape)
    if isinstance(like, (tuple, list)):
        return type(like)(state_from_arrays(a, s) for a, s in zip(arrays, like))
    kw = {}
    for f in dataclasses.fields(like):
        v = getattr(like, f.name)
        if isinstance(v, torch.Tensor) or dataclasses.is_dataclass(v):
            a = arrays[f.name] if isinstance(arrays, dict) else getattr(arrays, f.name)
            kw[f.name] = state_from_arrays(a, v)
        else:
            kw[f.name] = v
    return type(like)(**kw)


def state_to_arrays(state):
    """A port state as numpy, for the way back: a dataclass state as a dict
    of its tensor fields by name (the JAX state's names), a bare tensor
    state as one array, a tuple state as a tuple of these."""
    if isinstance(state, torch.Tensor):
        return state.cpu().numpy()
    if isinstance(state, (tuple, list)):
        return tuple(state_to_arrays(s) for s in state)
    return {
        f.name: getattr(state, f.name).cpu().numpy()
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)
    }


def result_to_numpy(res: GreedyResult) -> tuple[np.ndarray, np.ndarray, int, float]:
    """(order int32, gains fp32, n_evals, value) of a port result."""
    return (
        res.order.cpu().numpy().astype(np.int32),
        res.gains.cpu().numpy().astype(np.float32),
        int(res.n_evals),
        float(res.value),
    )
