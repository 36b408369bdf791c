"""The training pipeline's selection stage in the port (``repro_torch.configs``,
``repro_torch.data.selection``, ``repro_torch.distributed.sharding``)
against the JAX package's, on the CPU.

- Every registered architecture config equals the JAX package's, field for
  field (``dataclasses.asdict``), and so do their reduced views.
- ``SubmodularSelector.select`` over the four objectives and the three
  optimizers: on the JAX package's similarity kernel (handed to the port
  through numpy) it picks the JAX package's ids exactly; end to end, on
  each package's own euclidean kernel, ids agree up to the first parting,
  where the two picks must be a near-tie within what the two kernels'
  gains differ by (the ~1e-6 ``d2`` residual of a self pair turns into
  ~1e-3 of euclidean similarity, ROADMAP queue 3); the step and the
  top-two gap are recorded in the test report.
- ``selection_step`` on a world of 1 in this process and on a spawned 2x2
  ("data", "model") world against the JAX package's ``selection_step`` on
  a (1, 1) mesh.
"""
import dataclasses
import datetime

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_dist_world import results, start_world
from repro.configs import archs as jarchs
from repro.configs.base import get_config as jget_config
from repro.configs.base import list_configs as jlist_configs
from repro.core import create_kernel as jcreate_kernel
from repro.data.selection import SelectorConfig as JSelectorConfig
from repro.data.selection import SubmodularSelector as JSubmodularSelector
from repro.distributed.sharding import data_axes as jdata_axes
from repro_torch.configs import archs
from repro_torch.configs.base import ArchConfig, get_config, list_configs
from repro_torch.core import DisparitySum, FacilityLocation, make_mesh
from repro_torch.core.info.fl import FLCG, FLQMI
from repro_torch.data.selection import SelectorConfig, SubmodularSelector
from repro_torch.distributed.sharding import data_axes

CPU = "cpu"
ARCH = "qwen3-0.6b"
OBJECTIVES = ("representative", "targeted", "diverse", "privacy")
OPTIMIZERS = ("LazyGreedy", "NaiveGreedy", "StochasticGreedy")
N, D, EXTRA, BUDGET = 96, 32, 10, 40
# the dense euclidean kernel's bar against the JAX package (ROADMAP queue 3)
EUCLID_RTOL, EUCLID_ATOL = 1e-3, 5e-2
STEP_N, STEP_D, STEP_BUDGET = 64, 16, 12


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(70)
    return tuple(rng.normal(size=(m, D)).astype(np.float32) for m in (N, EXTRA, EXTRA))


def _selectors(objective, optimizer, use_pallas_kernel=True):
    kw = dict(objective=objective, budget=BUDGET, optimizer=optimizer,
              use_pallas_kernel=use_pallas_kernel)
    return (SubmodularSelector(get_config(ARCH), SelectorConfig(**kw), device=CPU),
            JSubmodularSelector(jget_config(ARCH), JSelectorConfig(**kw)))


# -- configs -------------------------------------------------------------------


def test_configs_equal_the_jax_packages():
    assert list_configs() == jlist_configs()
    assert archs.ALL_ARCHS == jarchs.ALL_ARCHS and sorted(archs.ALL_ARCHS) == list_configs()
    for name in list_configs():
        cfg, jcfg = get_config(name), jget_config(name)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), name
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(jcfg.reduced()), name
        assert cfg.param_count() == jcfg.param_count(), name
        assert cfg.active_param_count() == jcfg.active_param_count(), name
        assert [cfg.is_moe_layer(l) for l in range(cfg.n_layers)] == \
            [jcfg.is_moe_layer(l) for l in range(cfg.n_layers)], name
        assert [cfg.is_attn_layer(l) for l in range(cfg.n_layers)] == \
            [jcfg.is_attn_layer(l) for l in range(cfg.n_layers)], name
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("nope")


def test_a_config_moves_across_unchanged():
    """ArchConfig and SelectorConfig have the JAX package's fields and
    defaults, so either package's config rebuilds the other's."""
    for ours, theirs in ((ArchConfig, type(jget_config(ARCH))),
                         (SelectorConfig, JSelectorConfig)):
        assert [(f.name, f.default) for f in dataclasses.fields(ours)] == \
            [(f.name, f.default) for f in dataclasses.fields(theirs)]
    jcfg = jget_config("jamba-1.5-large-398b")
    assert ArchConfig(**dataclasses.asdict(jcfg)) == get_config("jamba-1.5-large-398b")
    sel = JSelectorConfig(objective="privacy", budget=7, metric="cosine", nu=0.5)
    assert dataclasses.asdict(SelectorConfig(**dataclasses.asdict(sel))) == \
        dataclasses.asdict(sel)


# -- select ----------------------------------------------------------------------


def test_build_function_objectives(data):
    """The four objectives build the JAX package's families; "diverse" turns
    the kernel into the same distances bit for bit; use_pallas_kernel picks
    the kernel gate (None) or the torch sweeps (False)."""
    pool, q, p = data
    families = {"representative": FacilityLocation, "targeted": FLQMI,
                "diverse": DisparitySum, "privacy": FLCG}
    for objective, family in families.items():
        sel, jsel = _selectors(objective, "NaiveGreedy")
        fn = sel.build_function(pool, q, p)
        assert type(fn) is family and type(jsel.build_function(pool, q, p)).__name__ == \
            family.__name__
        if objective in ("representative", "diverse"):
            assert fn.use_kernel is None
            off = _selectors(objective, "NaiveGreedy", False)[0].build_function(pool, q, p)
            assert off.use_kernel is False
    sel, jsel = _selectors("diverse", "NaiveGreedy")
    S = np.asarray(jcreate_kernel(pool, metric="euclidean"))
    sel._kernel = lambda x, y=None: torch.tensor(S)
    np.testing.assert_array_equal(sel.build_function(pool).dist.numpy().view(np.int32),
                                  np.asarray(1.0 / np.maximum(S, 1e-6) - 1.0).view(np.int32))
    with pytest.raises(ValueError):
        SubmodularSelector(get_config(ARCH), SelectorConfig(objective="nope"),
                           device=CPU).build_function(pool)


@pytest.mark.parametrize("use_pallas_kernel", [True, False])
@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_select_on_the_jax_kernel_picks_the_jax_ids(objective, optimizer, use_pallas_kernel,
                                                      data):
    """Both packages on the JAX package's similarity kernel (the port's
    selector handed it through numpy): the same ids, StochasticGreedy's key
    0 drawing jax.random's samples."""
    pool, q, p = data
    sel, jsel = _selectors(objective, optimizer, use_pallas_kernel)

    def jax_kernel(x, y=None):
        return torch.tensor(np.asarray(jcreate_kernel(
            x, y, metric="euclidean", use_pallas=use_pallas_kernel)))

    sel._kernel = jax_kernel
    got, want = sel.select(pool, q, p), np.asarray(jsel.select(pool, q, p))
    assert got.dtype == np.int32 and len(got) == BUDGET
    np.testing.assert_array_equal(got, want)


def _replay(fn, jfn, ids):
    """Both packages' states after adding ``ids`` in order."""
    state, jstate = fn.init_state(), jfn.init_state()
    for j in ids:
        state, jstate = fn.update(state, torch.tensor([int(j)])), jfn.update(jstate, int(j))
    return state, jstate


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_select_end_to_end_agrees_up_to_its_first_near_tie(objective, optimizer, data,
                                                           request):
    """Each package on its own euclidean kernel: ids agree up to the first
    parting; at every agreed step the picked gain, and at the parting every
    candidate's gain, lie within the euclidean bar of the other package's;
    the two picks there are a near-tie (each package's top-two gap within
    twice the largest gain difference between the packages), recorded in
    the test report (``first_parting``) and printed."""
    pool, q, p = data
    sel, jsel = _selectors(objective, optimizer)
    got, want = sel.select(pool, q, p), np.asarray(jsel.select(pool, q, p))
    assert len(got) == len(want) == BUDGET
    parted = np.nonzero(got != want)[0]
    t = int(parted[0]) if parted.size else BUDGET
    fn, jfn = sel.build_function(pool, q, p), jsel.build_function(pool, q, p)
    state, jstate = fn.init_state(), jfn.init_state()
    for j in got[:t]:
        g, jg = fn.gains(state).numpy(), np.asarray(jfn.gains(jstate))
        np.testing.assert_allclose(g[j], jg[j], rtol=EUCLID_RTOL, atol=EUCLID_ATOL)
        state, jstate = fn.update(state, torch.tensor([int(j)])), jfn.update(jstate, int(j))
    if not parted.size:
        return
    a, b = int(got[t]), int(want[t])
    g, jg = fn.gains(state).numpy(), np.asarray(jfn.gains(jstate))
    np.testing.assert_allclose(g, jg, rtol=EUCLID_RTOL, atol=EUCLID_ATOL)
    spread = float(np.max(np.abs(g - jg)))
    gaps = (float(g[a] - g[b]), float(jg[b] - jg[a]))  # each package's own pick first
    parting = {"step": t, "port_pick": a, "jax_pick": b, "gain_spread": spread,
               "top_two_gap": {"port": gaps[0], "jax": gaps[1]}}
    request.node.user_properties.append(("first_parting", parting))
    print("first parting:", parting)
    if optimizer != "StochasticGreedy":  # a sampled pick is the best of its sample only
        assert all(0.0 <= gap for gap in gaps), parting
    assert all(abs(gap) <= 2 * spread for gap in gaps), parting


# -- the mesh -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A world of 1 over gloo in this process, torn down after the module."""
    tmp = tmp_path_factory.mktemp("sel_world1")
    timeout = datetime.timedelta(seconds=60)
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'store'}", rank=0,
                            world_size=1, timeout=timeout)
    try:
        yield timeout
    finally:
        dist.destroy_process_group()


def test_data_axes(world1):
    m2 = make_mesh((1, 1), ("data", "model"), device=CPU, timeout=world1)
    m3 = make_mesh((1, 1, 1), ("pod", "data", "model"), device=CPU, timeout=world1)
    assert data_axes(m2) == ("data",) and data_axes(m3) == ("pod", "data")
    assert data_axes(m2) == jdata_axes(jax.make_mesh((1, 1), ("data", "model")))


def _step_data():
    rng = np.random.default_rng(71)
    pool = rng.normal(size=(STEP_N, STEP_D)).astype(np.float32)
    return pool, np.asarray(jcreate_kernel(pool, metric="euclidean"))


def _jax_step(pool):
    """The JAX package's selection_step on a (1, 1) ("data", "model") mesh."""
    jsel = JSubmodularSelector(jget_config(ARCH), JSelectorConfig(budget=STEP_BUDGET))
    order, gains = jsel.selection_step(pool, jax.make_mesh((1, 1), ("data", "model")))
    return np.asarray(order), np.asarray(gains)


def _hold_step(got, want, what):
    """The JAX package's ids; gains within 1e-5 (on a 2x2 mesh the row split
    changes the order of the row sums)."""
    np.testing.assert_array_equal(got[0], want[0], err_msg=what)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5, err_msg=what)


def _hold_step_to_parting(got, want, pool, S, what, request):
    """On each package's own kernel: ids equal up to the first parting, gains
    within the euclidean bar before it; at the parting the two picks are a
    near-tie within twice the two kernels' largest gain difference
    (recorded in the test report and printed)."""
    from repro.core import FacilityLocation as JFacilityLocation
    from repro_torch.core import create_kernel

    parted = np.nonzero(got[0] != want[0])[0]
    t = int(parted[0]) if parted.size else len(got[0])
    np.testing.assert_allclose(got[1][:t], want[1][:t], rtol=EUCLID_RTOL, atol=EUCLID_ATOL,
                               err_msg=what)
    if not parted.size:
        return
    fn = FacilityLocation.from_kernel(create_kernel(pool, metric="euclidean", use_pallas=True,
                                                    device=CPU))
    state, jstate = _replay(fn, JFacilityLocation.from_kernel(S), got[0][:t])
    g, jg = fn.gains(state).numpy(), np.asarray(JFacilityLocation.from_kernel(S).gains(jstate))
    a, b = int(got[0][t]), int(want[0][t])
    spread = float(np.max(np.abs(g - jg)))
    gaps = (float(g[a] - g[b]), float(jg[b] - jg[a]))
    parting = {"what": what, "step": t, "port_pick": a, "jax_pick": b, "gain_spread": spread,
               "top_two_gap": {"port": gaps[0], "jax": gaps[1]}}
    request.node.user_properties.append(("first_parting", parting))
    print("first parting:", parting)
    assert all(0.0 <= gap <= 2 * spread for gap in gaps), parting


def _port_step(pool, mesh, S=None):
    sel = SubmodularSelector(get_config(ARCH), SelectorConfig(budget=STEP_BUDGET), device=CPU)
    if S is not None:
        sel._kernel = lambda x, y=None: torch.tensor(S)
    order, gains = sel.selection_step(torch.tensor(pool), mesh)
    return order.numpy(), gains.numpy()


def test_selection_step_world_of_one_matches_jax(world1, request):
    """A (1, 1) ("data", "model") mesh: on the JAX package's kernel the
    port's selection_step picks its ids; on its own, up to a near-tie."""
    pool, S = _step_data()
    mesh = make_mesh((1, 1), ("data", "model"), device=CPU, timeout=world1)
    want = _jax_step(pool)
    _hold_step(_port_step(pool, mesh, S), want, "the JAX package's kernel")
    _hold_step_to_parting(_port_step(pool, mesh), want, pool, S, "own kernel", request)


def test_selection_step_on_a_2x2_world_matches_jax(tmp_path, request):
    """Four ranks, rows over "model" and columns over "data": on the JAX
    package's kernel every rank picks the JAX package's selection_step ids
    (on a (1, 1) mesh); on its own kernel, up to a near-tie; every rank the
    same."""
    pool, S = _step_data()
    job = {"meshes": {"dm": ((2, 2), ("data", "model"))},
           "selection": {"mesh": "dm", "arch": ARCH, "pool": pool, "S": S,
                         "budget": STEP_BUDGET, "config": {"budget": STEP_BUDGET}}}
    ranks = results(start_world(job, 4, tmp_path), tmp_path)
    want = _jax_step(pool)
    for r, out in enumerate(ranks):
        _hold_step(out["selection"]["given"], want, f"rank {r}")
        np.testing.assert_array_equal(out["selection"]["own"][0], ranks[0]["selection"]["own"][0])
    _hold_step_to_parting(ranks[0]["selection"]["own"], want, pool, S, "own kernel, 2x2",
                          request)
