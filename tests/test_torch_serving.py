"""The port's serving front door (``repro_torch.launch.serve`` +
``coalesce``) on the CPU, against the port's own sequential solves and the
JAX package's.

Every served answer is held two ways (``_torch_serving_pairs``): bit for
bit against the port's sequential ``solve(spec)`` (ids, gains, ``n_evals``,
value), and against the JAX package's sequential solve over the same numpy
arrays (ids and ``n_evals`` equal, gains within the family's bar).

Mirrors the single-device tests of tests/test_serving.py (coalescing, the
server, per-group queues, failure discipline, backpressure, latency and
stats); the mesh cases wait for the sharded engine (ROADMAP queue 1, item
11).  Times are driven by replacing ``coalesce.clock``, not by sleeping.
"""
import warnings

import numpy as np
import pytest
import torch

from repro.core import SelectionSpec as JSelectionSpec
from repro.core import solve as jsolve
from repro.launch.serve import _random_requests as j_random_requests
from repro_torch.core import (
    BatchedEngine,
    DisparityMinSum,
    FacilityLocation,
    GraphCut,
    SelectionSpec,
    backend_name,
    solve,
)
from repro_torch.core.optimizers.backends import KERNEL_MIN_N
from repro_torch.launch import coalesce
from repro_torch.launch.coalesce import (
    SelectionRequest,
    bucket_for,
    bucket_size,
    group_key,
    next_pow2,
    pad_function,
    resolve_gate,
    served_unpadded,
)
from repro_torch.launch.serve import (
    DISPERSION_FAMILIES,
    FlushError,
    SelectionServer,
    ServerOverloaded,
    _random_requests,
    main,
)

from _torch_serving_pairs import (
    CPU,
    FAMILIES,
    card_gate,
    near_ref,
    pair,
    port_fn,
    same,
    stops,
)


class FakeClock:
    """A replacement for ``coalesce.clock``: time moves only when told."""

    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(coalesce, "clock", c)
    return c


def _fl(rng, n):
    return pair("fl", rng, n)[0]


# -- coalescing ---------------------------------------------------------------


def test_bucket_size():
    """Power-of-two buckets; the FL family (whose padded layout would keep
    its n rows) rides at its own n, as does a FacilityLocationMF whose
    represented rows are its ground set, while one over a fixed
    represented set pads its candidates."""
    assert next_pow2(1) == 1 and next_pow2(5) == 8 and next_pow2(64) == 64
    assert bucket_size(33) == 64 and bucket_size(3) == 4 and bucket_size(2) == 2
    rng = np.random.default_rng(2)
    for kind in ("fl", "flvmi", "flcg", "flcmi", "flmf", "flmf_dense", "flmf_knn"):
        assert served_unpadded(port_fn(kind, rng, 23)) and bucket_for(port_fn(kind, rng, 23)) == 23
    for kind in ("gc", "flqmi", "gcmf", "flmf_rep", "flmf_knn_rep"):
        assert bucket_for(port_fn(kind, rng, 23)) == 32, kind


@pytest.mark.parametrize("kind", sorted(FAMILIES))
def test_pad_function_preserves_selection_exactly(kind):
    """Zero-padding the candidate axis to the request's bucket + a valid
    mask is bit-invisible: the wave member equals the unpadded sequential
    solve (the port's bit for bit, the JAX package's to its bar);
    NaiveGreedy for half the families, LazyGreedy for the other half.  A
    family served at its own n refuses any other size."""
    optimizer = ("NaiveGreedy", "LazyGreedy")[sorted(FAMILIES).index(kind) % 2]
    rng = np.random.default_rng(3)
    fn, jfn = pair(kind, rng, 23)
    n_to = bucket_for(fn)
    if served_unpadded(fn):
        assert n_to == 23
        with pytest.raises(ValueError, match="own n"):
            pad_function(fn, 32)
    padded = pad_function(fn, n_to)
    assert padded.n == n_to and type(padded) is type(fn)
    valid = np.zeros((1, n_to), bool)
    valid[:, :23] = True
    kw = stops(kind)
    spec = SelectionSpec(fn, 6, optimizer, **kw)
    got = BatchedEngine([padded], valid=valid).run(
        [6], spec.optimizer, stop_if_zero=spec.stop_if_zero,
        stop_if_negative=spec.stop_if_negative)[0]
    same(solve(spec), got, f"{kind} {optimizer}")
    near_ref(got, jsolve(JSelectionSpec(jfn, 6, optimizer, **kw)), FAMILIES[kind], kind)


def test_coalesce_groups_and_pads():
    """Mixed families/sizes coalesce into per-(family, shape) waves: padded
    families of different n share their bucket's wave, FL rides at its own
    n; each member's valid row masks its own padding."""
    rng = np.random.default_rng(4)
    reqs = [
        SelectionRequest(rid="a", spec=SelectionSpec(pair("gc", rng, 24)[0], 4)),
        SelectionRequest(rid="b", spec=SelectionSpec(pair("gc", rng, 19)[0], 7)),
        SelectionRequest(rid="c", spec=SelectionSpec(_fl(rng, 24), 3)),
        SelectionRequest(rid="d", spec=SelectionSpec(pair("gc", rng, 40)[0], 4)),
    ]
    waves = coalesce.coalesce(reqs)
    by_rids = {tuple(sorted(r.rid for r in w.requests)): w for w in waves}
    assert set(by_rids) == {("a", "b"), ("c",), ("d",)}
    w_ab = by_rids[("a", "b")]
    assert w_ab.n_bucket == 32 and len(w_ab.fns) == 2
    assert w_ab.budgets == [4, 7]
    assert w_ab.max_budget == 7  # the largest budget (no power-of-two bucket: nothing compiles)
    assert w_ab.valid.shape == (2, 32) and w_ab.valid[0, :24].all() and w_ab.valid[1, :19].all()
    assert not w_ab.valid[0, 24:].any() and not w_ab.valid[1, 19:].any()
    assert by_rids[("c",)].n_bucket == 24 and by_rids[("c",)].valid.all()
    assert by_rids[("d",)].n_bucket == 64
    assert w_ab.demux(["r0", "r1"]) == {"a": "r0", "b": "r1"}


def test_coalesce_splits_at_max_wave():
    fn = _fl(np.random.default_rng(5), 16)
    reqs = [SelectionRequest(rid=i, spec=SelectionSpec(fn, 3)) for i in range(5)]
    assert sorted(len(w.requests) for w in coalesce.coalesce(reqs, max_wave=2)) == [1, 2, 2]


def _unsupported_family(rng):
    """DisparityMinSum registers no padder: its gains reduce over ALL rows
    of the distance matrix, so zero row-padding would change them."""
    d = rng.uniform(0, 2, size=(8, 8)).astype(np.float32)
    np.fill_diagonal(d, 0.0)
    return DisparityMinSum.from_distance(d, device=CPU)


def test_coalesce_rejects_unknown_family():
    fn = _unsupported_family(np.random.default_rng(6))
    with pytest.raises(NotImplementedError, match="register_padder"):
        coalesce.coalesce([SelectionRequest(rid=0, spec=SelectionSpec(fn, 2))])


def test_server_rejects_unknown_family_with_clear_error():
    """An unsupported family is refused AT SUBMIT TIME, naming
    register_padder, and does not poison co-pending valid requests."""
    rng = np.random.default_rng(7)
    server = SelectionServer()
    spec_ok = SelectionSpec(_fl(rng, 16), 3)
    rid_ok = server.submit_spec(spec_ok)
    with pytest.raises(NotImplementedError, match="register_padder"):
        server.submit_spec(SelectionSpec(_unsupported_family(rng), 3))
    same(server.flush()[rid_ok], solve(spec_ok))


def test_server_mesh_raises_naming_item_11():
    with pytest.raises(ValueError, match="item 11"):
        SelectionServer(mesh=object())


# -- the server ---------------------------------------------------------------

_CLI_FAMILIES = ("fl", "gc", "fb", "sc", "psc", "dsum", "dmin", "flqmi", "gcmi", "logdet")


@pytest.mark.parametrize("optimizer", ["NaiveGreedy", "LazyGreedy"])
def test_server_bit_identical_to_sequential(optimizer):
    """The JAX CLI's mixed workload over its ten families (heterogeneous n
    and budgets, the same draws in both packages): every served answer
    equals the port's sequential solve bit for bit and the JAX package's
    sequential solve to the family's bar."""
    port = _random_requests(10, seed=3, families=_CLI_FAMILIES, device=CPU)
    ref = j_random_requests(10, seed=3, families=_CLI_FAMILIES)
    kinds = list(_CLI_FAMILIES)
    specs = [
        SelectionSpec(fn, b, optimizer, stopIfNegativeGain=k not in DISPERSION_FAMILIES)
        for (fn, b), k in zip(port, kinds)
    ]
    server = SelectionServer()
    responses = server.select(specs)
    for spec, resp, (jfn, _), kind in zip(specs, responses, ref, kinds):
        same(resp, solve(spec), kind)
        jspec = JSelectionSpec(jfn, spec.budget, optimizer,
                               stopIfNegativeGain=kind not in DISPERSION_FAMILIES)
        near_ref(resp, jsolve(jspec), FAMILIES[kind], kind)
        assert resp.attempts == 1
        assert resp.n_bucket == bucket_for(spec.fn)
    s = server.stats.summary()
    assert s["requests"] == 10 and s["waves"] == len(_CLI_FAMILIES) and s["qps"] > 0


def test_server_every_family_in_one_flush():
    """Every family with a padder, two requests each at n 17..32 (bucket
    32, or their own n), one flush: each answer equals its sequential solve
    bit for bit (the JAX package's solves are held per family in
    test_pad_function_preserves_selection_exactly)."""
    rng = np.random.default_rng(8)
    specs = []
    for i, kind in enumerate(sorted(FAMILIES)):
        opt = "LazyGreedy" if i % 2 else "NaiveGreedy"
        for n in (17 + i % 16, 32 - i % 16):
            specs.append(SelectionSpec(port_fn(kind, rng, n), 5, opt, **stops(kind)))
    server = SelectionServer()
    for spec, resp in zip(specs, server.select(specs)):
        same(resp, solve(spec), type(spec.fn).__name__)
        assert resp.n_bucket == bucket_for(spec.fn) in (32, spec.fn.n)
    assert server.stats.waves < len(specs)


def test_server_coalesces_same_shape_requests():
    """Same-family same-bucket requests ride one wave."""
    rng = np.random.default_rng(9)
    specs = [SelectionSpec(_fl(rng, 24), 4) for _ in range(6)]
    server = SelectionServer(max_wave=8)
    responses = server.select(specs)
    assert server.stats.waves == 1
    for s, r in zip(specs, responses):
        assert r.wave_size == 6
        same(r, solve(s))


def test_server_screen_k_reaches_engine():
    """A non-default screen_k is honored (n_evals proves it ran)."""
    rng = np.random.default_rng(10)
    spec = SelectionSpec(_fl(rng, 32), 5, "LazyGreedy", screen_k=3)
    server = SelectionServer()
    rid = server.submit_spec(spec)
    out = server.flush()
    same(out[rid], solve(spec))
    assert int(out[rid].result.n_evals) != int(solve(SelectionSpec(spec.fn, 5, "LazyGreedy")).n_evals)


def test_server_legacy_submit_shim_and_unknown_options():
    """The deprecated submit(fn, budget, ...) builds the spec (and warns);
    a misspelled option raises at submit time."""
    rng = np.random.default_rng(11)
    fn = _fl(rng, 16)
    server = SelectionServer()
    with pytest.warns(DeprecationWarning):
        rid = server.submit(fn, 5, optimizer="LazyGreedy")
    same(server.flush()[rid], solve(SelectionSpec(fn, 5, "LazyGreedy")))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(TypeError, match="unknown option"):
            server.submit(fn, 3, stopIfZeroGains=False)
    with pytest.raises(TypeError, match="no extra options"):
        server.submit(SelectionSpec(fn, 3), 4)


def test_server_never_drops_submitted_requests():
    """select() re-holds answers to requests enqueued earlier via submit():
    they surface on the next flush()."""
    rng = np.random.default_rng(12)
    sa, sb = SelectionSpec(_fl(rng, 16), 3), SelectionSpec(_fl(rng, 24), 4)
    server = SelectionServer()
    rid_a = server.submit_spec(sa)
    (resp_b,) = server.select([sb])
    same(resp_b, solve(sb))
    same(server.flush()[rid_a], solve(sa))


def test_server_stop_flags_ride_the_wave_key():
    """Stop flags key the wave and reach the engine."""
    fn = _fl(np.random.default_rng(13), 8)
    server = SelectionServer()
    s_stop = SelectionSpec(fn, 8)
    s_nostop = SelectionSpec(fn, 8, stopIfZeroGain=False, stopIfNegativeGain=False)
    rids = [server.submit_spec(s_stop), server.submit_spec(s_nostop)]
    out = server.flush()
    assert server.stats.waves == 2
    same(out[rids[0]], solve(s_stop))
    same(out[rids[1]], solve(s_nostop))


def test_server_disparity_stop_default():
    """Disparity* specs default stopIfZeroGain=False (their empty-set gain
    is 0), so served selections are not empty; an explicit flag wins."""
    rng = np.random.default_rng(14)
    fns = {k: pair(k, rng, 24)[0] for k in ("dsum", "dmin")}
    server = SelectionServer()
    rids = {k: server.submit_spec(SelectionSpec(f, 5)) for k, f in fns.items()}
    explicit = server.submit_spec(SelectionSpec(fns["dsum"], 5, stopIfZeroGain=True))
    out = server.flush()
    for k, f in fns.items():
        assert out[rids[k]].selection, k
        same(out[rids[k]], solve(SelectionSpec(f, 5, stopIfZeroGain=False)), k)
    assert out[explicit].selection == []


def test_server_rejects_unknown_optimizer_at_submit():
    rng = np.random.default_rng(15)
    server = SelectionServer()
    spec = SelectionSpec(_fl(rng, 16), 3)
    rid_ok = server.submit_spec(spec)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(ValueError, match="unknown optimizer"):
            server.submit(spec.fn, 3, optimizer="lazygreedy")
    same(server.flush()[rid_ok], solve(spec))


# -- the backend gate under padding -------------------------------------------


def test_gate_crossing_request_keeps_its_sequential_backend(monkeypatch):
    """With the decision table answering as on the card, a GraphCut request
    of n = 3,072 (torch route, under KERNEL_MIN_N) padded into the 4,096
    bucket keeps the torch route its sequential solve takes, and a request
    of n = 4,096 keeps the kernel route: separate groups, separate waves,
    each answer bit-equal to its sequential solve."""
    card_gate(monkeypatch)
    rng = np.random.default_rng(16)
    small_n, big_n = KERNEL_MIN_N * 3 // 4, KERNEL_MIN_N
    specs = []
    for n in (small_n, big_n):
        x = rng.normal(size=(n, 4)).astype(np.float32)
        sq = (x * x).sum(1)
        d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), 0.0)
        S = (1.0 / (1.0 + np.sqrt(d2))).astype(np.float32)
        gc = GraphCut.from_kernel(S, lam=0.3, use_kernel=None, device=CPU)
        fl = pair("fl", np.random.default_rng(n), 8)[0]  # a small FL rides along
        specs += [SelectionSpec(gc, 3), SelectionSpec(gc, 2, "LazyGreedy")]
        if n == small_n:
            specs.append(SelectionSpec(fl, 3))
    assert backend_name(specs[0].fn) == "torch" and backend_name(specs[3].fn) == "cuda-gc"
    padded = resolve_gate(specs[0].fn)
    assert padded.use_kernel is False and resolve_gate(specs[3].fn).use_kernel is True
    reqs = [SelectionRequest(rid=i, spec=s) for i, s in enumerate(specs)]
    keys = [group_key(r) for r in reqs]
    assert keys[0] != keys[3]  # the resolved gate keys the group
    server = SelectionServer()
    responses = server.select(specs)
    for spec, resp in zip(specs, responses):
        same(resp, solve(spec), f"n={spec.fn.n}")
        assert resp.backend == backend_name(spec.fn)
    assert [r.n_bucket for r in responses[:2]] == [big_n, big_n]
    assert {r.backend for r in responses[:2]} == {"torch"}
    assert {r.backend for r in responses[3:]} == {"cuda-gc"}


def test_gate_resolves_on_the_requests_own_device():
    """On the CPU the decision table picks the torch sweeps whatever n is,
    so use_kernel=None resolves to False; an explicit flag stays, padded."""
    rng = np.random.default_rng(17)
    x = rng.normal(size=(KERNEL_MIN_N, 2)).astype(np.float32)
    fn = FacilityLocation.from_kernel(x @ x.T, use_kernel=None, device=CPU)
    assert resolve_gate(fn).use_kernel is False
    on = GraphCut.from_kernel(np.abs(x[:8] @ x[:8].T), lam=0.3, use_kernel=True, device=CPU)
    assert resolve_gate(on) is on
    assert pad_function(on, 16).use_kernel is True


# -- per-group queues, failure discipline, backpressure, latency --------------


def test_group_key_is_the_wave_identity():
    """group_key (shape-only, at submit time) partitions requests as wave
    coalescing does; budgets and deadlines never key."""
    rng = np.random.default_rng(18)

    def req(fn, budget, *args, **kw):
        return SelectionRequest(rid=0, spec=SelectionSpec(fn, budget, *args, **kw))

    a = req(_fl(rng, 24), 3)
    b = req(_fl(rng, 24), 7, deadline_s=0.5)
    c = req(_fl(rng, 48), 3)
    d = req(pair("gc", rng, 24)[0], 3)
    e = req(_fl(rng, 24), 3, stopIfZeroGain=False)
    f = req(_fl(rng, 24), 3, "LazyGreedy")
    g = req(_fl(rng, 24), 3, use_kernel=True)
    keys = [group_key(r) for r in (a, b, c, d, e, f, g)]
    assert keys[0] == keys[1]
    assert len({keys[0], keys[2], keys[3], keys[4], keys[5], keys[6]}) == 6
    assert hash(keys[0]) == hash(group_key(a))


def test_server_queues_per_group_and_group_states(clock):
    rng = np.random.default_rng(19)
    server = SelectionServer()
    server.submit_spec(SelectionSpec(_fl(rng, 24), 3))
    server.submit_spec(SelectionSpec(_fl(rng, 24), 5, deadline_s=9.0))
    server.submit_spec(SelectionSpec(pair("gc", rng, 24)[0], 3))
    states = server.group_states()
    assert sorted(depth for _, depth, _, _ in states) == [1, 2]
    assert server.pending_count == 3
    fl_state = next(s for s in states if s[1] == 2)
    assert fl_state[2] == clock.t and fl_state[3] == clock.t + 9.0
    assert next(s for s in states if s[1] == 1)[3] is None
    out = server.flush()
    assert len(out) == 3 and server.pending_count == 0


def test_flush_error_loses_no_requests_or_responses():
    """Wave 2 of 3 fails: wave 1's responses are re-held, the failed and the
    never-dispatched waves re-enqueued, and the next flush answers all."""

    class Boom(RuntimeError):
        pass

    class PoisonServer(SelectionServer):
        armed = True

        def _dispatch(self, wave):
            if self.armed and wave.n_bucket == 64:
                raise Boom("engine on fire")
            return super()._dispatch(wave)

    rng = np.random.default_rng(20)
    server = PoisonServer()
    specs = [SelectionSpec(_fl(rng, 32), 4), SelectionSpec(_fl(rng, 64), 4),
             SelectionSpec(_fl(rng, 16), 3)]
    rid_good, rid_poison, rid_late = (server.submit_spec(s) for s in specs)
    with pytest.raises(FlushError) as excinfo:
        server.flush()
    e = excinfo.value
    assert isinstance(e.__cause__, Boom)
    assert e.failed_rids == [rid_poison] and e.undispatched_rids == [rid_late]
    assert set(e.completed) == {rid_good}
    assert server.pending_count == 2
    assert server.metrics.counters["flush_errors"] == 1
    assert server.metrics.counters["requeued"] == 2
    server.armed = False
    out = server.flush()
    assert set(out) == {rid_good, rid_poison, rid_late}
    for spec, rid in zip(specs, (rid_good, rid_poison, rid_late)):
        same(out[rid], solve(spec))


def test_flush_error_cancel_escape_hatch():
    class PoisonServer(SelectionServer):
        def _dispatch(self, wave):
            if wave.n_bucket == 64:
                raise RuntimeError("this request always fails")
            return super()._dispatch(wave)

    rng = np.random.default_rng(21)
    server = PoisonServer()
    rid_ok = server.submit_spec(SelectionSpec(_fl(rng, 32), 4))
    rid_bad = server.submit_spec(SelectionSpec(_fl(rng, 64), 4))
    with pytest.raises(FlushError):
        server.flush()
    assert server.cancel(rid_bad)
    assert not server.cancel(rid_bad)
    assert set(server.flush()) == {rid_ok}


def test_latency_reports_queue_time_truthfully(clock, monkeypatch):
    """queue_s is the submit -> dispatch wait on the serving clock, wave_s
    the dispatch's own span, latency_s their sum; a deadline that lapses
    during the wave is flagged and counted."""
    rng = np.random.default_rng(22)
    server = SelectionServer()
    rid = server.submit_spec(SelectionSpec(_fl(rng, 24), 4, deadline_s=0.3))
    clock.t += 0.25  # the request waits in its queue
    run = BatchedEngine.run

    def slow_run(self, *a, **kw):  # the wave takes 0.125 s on the clock
        clock.t += 0.125
        return run(self, *a, **kw)

    monkeypatch.setattr(BatchedEngine, "run", slow_run)
    resp = server.flush()[rid]
    assert resp.queue_s == 0.25 and resp.wave_s == 0.125
    assert resp.latency_s == resp.queue_s + resp.wave_s
    assert resp.deadline_missed is True
    m = server.metrics.snapshot()
    assert m["queue_s"]["count"] == 1 and m["queue_s"]["max"] == 0.25
    assert m["counters"]["deadline_misses"] == 1


def test_server_backpressure_and_cancel_free_space():
    rng = np.random.default_rng(23)
    server = SelectionServer(max_queue=2)
    rid_a = server.submit_spec(SelectionSpec(_fl(rng, 24), 3))
    server.submit_spec(SelectionSpec(pair("gc", rng, 24)[0], 3))
    with pytest.raises(ServerOverloaded, match="2/2"):
        server.submit_spec(SelectionSpec(_fl(rng, 24), 3))
    assert server.stats.rejections == 1
    assert server.cancel(rid_a)
    server.submit_spec(SelectionSpec(_fl(rng, 24), 3))
    assert len(server.flush()) == 2
    with pytest.raises(ValueError, match="max_queue"):
        SelectionServer(max_queue=0)


def test_server_stats_bounded_with_stable_summary_keys():
    """summary() has exactly the JAX package's keys; the reservoir is
    bounded."""
    from repro.launch.serve import SelectionServer as JSelectionServer

    rng = np.random.default_rng(24)
    spec = SelectionSpec(_fl(rng, 16), 3)
    server = SelectionServer()
    for _ in range(3):
        server.select([spec])
    s = server.stats.summary()
    assert set(s) == set(JSelectionServer().stats.summary())
    assert set(server.stats.snapshot()) == set(JSelectionServer().stats.snapshot())
    assert s["requests"] == 3 and s["waves"] == 3
    assert 0 < s["wave_p50_s"] <= s["wave_p99_s"] <= s["total_s"]
    h = server.metrics.wave_s
    assert h.count == 3 and len(h._reservoir._sample) <= h._reservoir.capacity


def test_solve_served_and_async_routes_equal_sequential():
    """solve(specs, mode="served" | "async") over a mixed list (and through
    a caller's server) returns the sequential results, bit for bit."""
    rng = np.random.default_rng(25)
    specs = [SelectionSpec(pair(k, rng, n)[0], 4, **stops(k))
             for k, n in (("fl", 20), ("gc", 30), ("fb", 17), ("dmin", 12))]
    seq = [solve(s) for s in specs]
    for mode in ("served", "async"):
        for got, want in zip(solve(specs, mode=mode), seq):
            same(got, want, mode)
    server = SelectionServer()
    for got, want in zip(solve(specs, mode="served", server=server), seq):
        same(got, want)
    assert server.stats.requests == len(specs)


def test_serve_cli_runs_on_cpu(capsys):
    main(["--device", "cpu", "--requests", "6", "--rounds", "2",
          "--families", "fl,gc,fb,sc,psc,dsum,dmin,flqmi,gcmi,logdet", "--metrics"])
    out = capsys.readouterr().out
    assert "round 1: 6 requests" in out and "server stats" in out and '"counters"' in out
    with pytest.raises(ValueError, match="item 11"):
        main(["--device", "cpu", "--requests", "2", "--mesh", "2x2"])


def test_served_results_lie_on_the_host():
    rng = np.random.default_rng(26)
    (resp,) = SelectionServer().select([SelectionSpec(_fl(rng, 12), 3)])
    assert resp.result.order.device == torch.device("cpu")
    assert resp.selection == resp.result.as_list()
