"""The port's distributed engine (``core/optimizers/distributed.py``)
against its own sequential solves and the JAX package, on the CPU.

Two worlds run the same cases over ``gloo``:
- a **world of 1**, in this process (a file store), on (1, 1) meshes: the
  whole sharded program with live collectives over groups of one, the
  counterpart of the JAX package's (1, 1) mesh tests;
- one **spawned 2x2 world** (``tests/_torch_dist_world.py``), four ranks,
  started once for the module: the batch over ``batch``, the candidates
  over ``data``.

Every member of every sharded wave (13 families, NaiveGreedy and
LazyGreedy, budgets that differ, a zero-padded ``valid`` mask, the
``use_kernel`` routes, FL at a shape where ``torch.sum``'s blocking follows
the shard's width) is held bit for bit against the port's own sequential
solve (ids, gains, ``n_evals``, value) and against the JAX package's
sequential solve (ids and ``n_evals`` equal, gains within ROADMAP's
bars).  The partition greedies are held against the JAX package on a
(1, 1) mesh and on a forced 4-device host mesh (one JAX subprocess, as
tests/test_spec.py runs its 2x2 mesh); the stochastic variant's draws are
``jax.random``'s, so its ids are equal.  Mirrors tests/test_optimizers.py:146,
tests/test_serving.py:324-510 (engine level) and tests/test_spec.py:273,445.
"""
import datetime
import os
import subprocess
import sys
import textwrap
import time
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_dist_world import partition, results, start_world
from _torch_serving_pairs import FAMILIES, pair, stops
from repro.core import SelectionSpec as JSelectionSpec
from repro.core import create_kernel as jcreate_kernel
from repro.core import distributed_fl_greedy as jdistributed_fl_greedy
from repro.core import distributed_flqmi_greedy as jdistributed_flqmi_greedy
from repro.core import solve as jsolve
from repro.core import wave_capable_names as jwave_capable_names
from repro.core.optimizers.distributed import (
    distributed_stochastic_fl_greedy as jdistributed_stochastic_fl_greedy,
)
from repro_torch.core import (
    BatchedEngine,
    FacilityLocation,
    OptimizerSpec,
    SelectionSpec,
    make_mesh,
    solve,
    wave_capable_names,
)
from repro_torch.interop import facility_location_from_arrays, result_to_numpy

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"
N = 32
BUDGETS = [6, 3, 6, 3]  # two budgets: the JAX package compiles one program each
OPTIMIZERS = ("NaiveGreedy", "LazyGreedy")
PARAMS = {"NaiveGreedy": {}, "LazyGreedy": {"screen_k": 6}}
# the 13 families with a shard rule, and the use_kernel routes of those
# whose kernels keep the memoized bits (their plain versions on the CPU)
KINDS = ("fl", "fl_kernel", "gc", "fb", "fb_kernel", "sc", "sc_kernel", "psc", "psc_kernel",
         "dsum", "dmin", "gcmi", "logdet", "flqmi", "flvmi", "flcg", "flcmi")
BLOCK_N = 96  # FL: torch.sum's order over 96 columns differs from over 48
PAD_N, PAD_SMALL = 32, 20
PART_N, PART_BUDGET, PART_SEED, PART_SAMPLE = 64, 12, 3, 8


# -- the cases, built once --------------------------------------------------


def _members(kind, seed, n=N):
    rng = np.random.default_rng(seed)
    return [pair(kind, rng, n) for _ in BUDGETS]


def _jax_seq(jfns, budgets, opt, kind):
    st = stops(kind)
    return [jsolve(JSelectionSpec(j, b, opt, **st, **PARAMS[opt])) for j, b in zip(jfns, budgets)]


def _padded(uk, seed):
    """(padded port fns, unpadded port fns, JAX fns, valid): FL zero-padded
    from PAD_SMALL to PAD_N candidates."""
    rng = np.random.default_rng(seed)
    small, padded, jfns = [], [], []
    for _ in BUDGETS:
        x = rng.normal(size=(PAD_SMALL, 6)).astype(np.float32)
        S = np.asarray(jcreate_kernel(x, metric="euclidean"))
        Sp = np.zeros((PAD_N, PAD_N), np.float32)
        Sp[:PAD_SMALL, :PAD_SMALL] = S
        small.append(facility_location_from_arrays(S, uk, device=CPU))
        padded.append(facility_location_from_arrays(Sp, uk, device=CPU))
        jfns.append(_jfl(S))
    valid = np.zeros((len(BUDGETS), PAD_N), bool)
    valid[:, :PAD_SMALL] = True
    return padded, small, jfns, valid


def _jfl(S):
    from repro.core import FacilityLocation as JFacilityLocation

    return JFacilityLocation.from_kernel(S)


def _cases():
    """name -> case: the waves both worlds run, with the JAX package's
    sequential results and the family's bar."""
    cases = {}
    for k, kind in enumerate(KINDS):
        pairs = _members(kind, 100 + k)
        for opt in OPTIMIZERS:
            cases[f"{kind}-{opt}"] = dict(
                fns=[p for p, _ in pairs], budgets=BUDGETS, optimizer=opt, params=PARAMS[opt],
                stops=tuple(stops(kind).values()), jax=_jax_seq([j for _, j in pairs], BUDGETS,
                                                                opt, kind),
                tol=FAMILIES[kind])
    for uk in (False, True):
        padded, small, jfns, valid = _padded(uk, 200 + uk)
        for opt in OPTIMIZERS:
            cases[f"padded-{'kernel' if uk else 'torch'}-{opt}"] = dict(
                fns=padded, seq_fns=small, valid=valid, budgets=BUDGETS, optimizer=opt,
                params=PARAMS[opt], stops=(True, True), jax=_jax_seq(jfns, BUDGETS, opt, "fl"),
                tol=1e-5)
    pairs = _members("fl", 300, BLOCK_N)
    for opt in OPTIMIZERS:
        cases[f"fl-blocking-{opt}"] = dict(
            fns=[p for p, _ in pairs], budgets=[8, 5, 8, 5], optimizer=opt, params=PARAMS[opt],
            stops=(True, True), jax=_jax_seq([j for _, j in pairs], [8, 5, 8, 5], opt, "fl"),
            tol=1e-5)
    return cases


def _partition_data():
    rng = np.random.default_rng(400)
    x = rng.normal(size=(PART_N, 8)).astype(np.float32)
    q = rng.normal(size=(6, 8)).astype(np.float32)
    S = np.asarray(jcreate_kernel(x, metric="euclidean"))
    sim_qv = np.asarray(jcreate_kernel(q, x, metric="euclidean"))
    return dict(S=S, sim_qv=sim_qv, modular=sim_qv.max(axis=0), budget=PART_BUDGET,
                seed=PART_SEED, sample=PART_SAMPLE)


_JAX_MESH_SCRIPT = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax
    from repro.core.optimizers.distributed import (
        distributed_fl_greedy, distributed_flqmi_greedy, distributed_stochastic_fl_greedy)

    d = dict(np.load(sys.argv[1]))
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    assert len(jax.devices()) == 4
    b = int(d["budget"])
    out = {
        "fl": distributed_fl_greedy(d["S"], b, mesh),
        "fl_dtensor": distributed_fl_greedy(d["S"], b, mesh),
        "fl_cols": distributed_fl_greedy(d["S"], b, mesh, row_axes=None),
        "fl_cols4": distributed_fl_greedy(d["S"], b, mesh, row_axes=None,
                                          col_axes=("data", "model")),
        "fl_cols4_rev": distributed_fl_greedy(d["S"], b, mesh, row_axes=None,
                                              col_axes=("model", "data")),
        "stochastic": distributed_stochastic_fl_greedy(
            d["S"], b, mesh, jax.random.PRNGKey(int(d["seed"])),
            sample_per_shard=int(d["sample"])),
        "flqmi": distributed_flqmi_greedy(d["sim_qv"], d["modular"], b, mesh),
    }
    np.savez(sys.argv[2], **{f"{k}_{i}": np.asarray(v[i])
                             for k, v in out.items() for i in (0, 1)})
    print("JAX_MESH_OK")
    """
)


def _jax_partition(d, mesh):
    fl = jdistributed_fl_greedy(d["S"], d["budget"], mesh)
    return {
        "fl": fl,
        "fl_dtensor": fl,
        "fl_cols": jdistributed_fl_greedy(d["S"], d["budget"], mesh, row_axes=None),
        "fl_cols4": jdistributed_fl_greedy(d["S"], d["budget"], mesh, row_axes=None,
                                           col_axes=("data", "model")),
        "fl_cols4_rev": jdistributed_fl_greedy(d["S"], d["budget"], mesh, row_axes=None,
                                               col_axes=("model", "data")),
        "stochastic": jdistributed_stochastic_fl_greedy(
            d["S"], d["budget"], mesh, jax.random.PRNGKey(d["seed"]),
            sample_per_shard=d["sample"]),
        "flqmi": jdistributed_flqmi_greedy(d["sim_qv"], d["modular"], d["budget"], mesh),
    }


def _job_waves(cases):
    return {name: {k: v for k, v in c.items() if k not in ("jax", "tol")} | {"mesh": "bd"}
            for name, c in cases.items()}


@pytest.fixture(scope="module")
def cases():
    return _cases()


@pytest.fixture(scope="module")
def partition_data():
    return _partition_data()


@pytest.fixture(scope="module")
def world4(cases, partition_data, tmp_path_factory):
    """The spawned 2x2 world's per-rank results and the JAX 4-device run's,
    both started together."""
    tmp = tmp_path_factory.mktemp("world4")
    np.savez(tmp / "partition.npz", **partition_data)
    jax_run = subprocess.Popen(
        [sys.executable, "-c", _JAX_MESH_SCRIPT, str(tmp / "partition.npz"),
         str(tmp / "jax_out.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"},
    )
    job = {
        "meshes": {"bd": ((2, 2), ("batch", "data")), "dm": ((2, 2), ("data", "model"))},
        "waves": _job_waves(cases) | _rejected_waves(cases),
        "partition": partition_data | {"mesh": "dm"},
    }
    ranks = results(start_world(job, 4, tmp), tmp)
    try:
        out, err = jax_run.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        jax_run.kill()
        raise
    assert "JAX_MESH_OK" in out, out + err
    jout = np.load(tmp / "jax_out.npz")
    return ranks, {k: (jout[f"{k}_0"], jout[f"{k}_1"]) for k in ranks[0]["partition"]}


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A world of 1 in this process over gloo, torn down after the module
    (later test files run in the same worker)."""
    tmp = tmp_path_factory.mktemp("world1")
    timeout = datetime.timedelta(seconds=60)
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'store'}", rank=0,
                            world_size=1, timeout=timeout)
    try:
        yield {"bd": make_mesh((1, 1), ("batch", "data"), device=CPU, timeout=timeout),
               "dm": make_mesh((1, 1), ("data", "model"), device=CPU, timeout=timeout)}
    finally:
        dist.destroy_process_group()


def _rejected_waves(cases):
    """Waves every rank of the 2x2 world must refuse before a collective."""
    fl = cases["fl-NaiveGreedy"]
    odd = [facility_location_from_arrays(np.ones((N + 1, N + 1), np.float32), device=CPU)] * 4
    return {
        "reject-odd-B": dict(fns=fl["fns"][:3], budgets=[3] * 3, optimizer="NaiveGreedy",
                             mesh="bd"),
        "reject-odd-n": dict(fns=odd, budgets=[3] * 4, optimizer="NaiveGreedy", mesh="bd"),
    }


# -- holding a result --------------------------------------------------------


def _same(a, b, what=""):
    """Bit identity of two results in result_to_numpy form."""
    np.testing.assert_array_equal(a[0], b[0], err_msg=what)
    np.testing.assert_array_equal(a[1].view(np.int32), b[1].view(np.int32), err_msg=what)
    assert a[2] == b[2], (what, a[2], b[2])
    assert np.float32(a[3]).view(np.int32) == np.float32(b[3]).view(np.int32), what


def _near_ref(a, jres, tol, what=""):
    np.testing.assert_array_equal(a[0], np.asarray(jres.order), err_msg=what)
    assert a[2] == int(jres.n_evals), (what, a[2], int(jres.n_evals))
    np.testing.assert_allclose(a[1], np.asarray(jres.gains), rtol=tol, atol=tol, err_msg=what)


def _hold(name, case, sharded, sequential):
    assert len(sharded) == len(case["budgets"])
    for b, (got, want, jres) in enumerate(zip(sharded, sequential, case["jax"])):
        _same(got, want, f"{name} member {b}")
        _near_ref(got, jres, case["tol"], f"{name} member {b}")


def _run_world1(case, mesh):
    opt = OptimizerSpec(case["optimizer"], **case["params"])
    z, ng = case["stops"]
    got = BatchedEngine(case["fns"], valid=case.get("valid"), mesh=mesh).run(
        case["budgets"], opt, stop_if_zero=z, stop_if_negative=ng)
    seq = [solve(SelectionSpec(f, b, opt, stopIfZeroGain=z, stopIfNegativeGain=ng))
           for f, b in zip(case.get("seq_fns", case["fns"]), case["budgets"])]
    return [result_to_numpy(r) for r in got], [result_to_numpy(r) for r in seq]


CASE_NAMES = ([f"{k}-{o}" for k in KINDS for o in OPTIMIZERS]
              + [f"padded-{r}-{o}" for r in ("torch", "kernel") for o in OPTIMIZERS]
              + [f"fl-blocking-{o}" for o in OPTIMIZERS])


# -- the sharded waves -------------------------------------------------------


@pytest.mark.parametrize("name", CASE_NAMES)
def test_world1_sharded_wave_matches_sequential_and_jax(name, cases, world1):
    """mesh=(1, 1): the whole sharded program, collectives over groups of
    one; every member bit-equal to its sequential solve and within its bar
    of the JAX package's."""
    case = cases[name]
    sharded, sequential = _run_world1(case, world1["bd"])
    _hold(name, case, sharded, sequential)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_world4_sharded_wave_matches_sequential_and_jax(name, cases, world4):
    """The 2x2 world: each rank holds two members' halves; every rank
    returns the whole batch, each member bit-equal to rank 0's sequential
    solve and within its bar of the JAX package's."""
    ranks, _ = world4
    got = ranks[0][name]
    _hold(name, cases[name], got["sharded"], got["sequential"])
    for r in ranks[1:]:
        for a, b in zip(r[name]["sharded"], got["sharded"]):
            _same(a, b, f"{name}: a rank's batch")


def test_fl_blocking_case_parts_under_torch_sum(cases):
    """The blocking case is one where torch.sum over a shard's 48 columns
    sums some column in another order than over all 96: the sweep's fixed
    order is what the sharded FL cases above hold."""
    S = cases["fl-blocking-NaiveGreedy"]["fns"][0].sim
    full = S.clamp(min=0.0).sum(dim=0)
    halves = torch.cat([S[:, : BLOCK_N // 2].contiguous().clamp(min=0.0).sum(dim=0),
                        S[:, BLOCK_N // 2 :].contiguous().clamp(min=0.0).sum(dim=0)])
    assert not torch.equal(full, halves)


def test_world4_rejects_sizes_that_do_not_split(world4):
    ranks, _ = world4
    for r in ranks:
        assert r["reject-odd-B"]["raised"][0] == "ValueError"
        assert "batch size 3 is not a multiple of mesh axis 'batch' size 2" in \
            r["reject-odd-B"]["raised"][1]
        assert r["reject-odd-n"]["raised"][0] == "ValueError"
        assert "ground-set size 33" in r["reject-odd-n"]["raised"][1]


# -- the partition greedies --------------------------------------------------


def _hold_partition(got, want, what):
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k][0]), np.asarray(want[k][0]),
                                      err_msg=f"{what} {k}")
        np.testing.assert_allclose(np.asarray(got[k][1]), np.asarray(want[k][1]), rtol=1e-5,
                                   atol=1e-5, err_msg=f"{what} {k}")


def test_world1_partition_greedies_match_jax(partition_data, world1):
    """On (1, 1) meshes the three partition greedies pick the JAX package's
    ids (rows and columns sharded, a DTensor block, columns over both mesh
    dimensions in either order); the stochastic one draws jax.random's
    samples."""
    d = partition_data
    got = partition(d, world1["dm"])
    _hold_partition(got, _jax_partition(d, jax.make_mesh((1, 1), ("data", "model"))), "(1, 1)")
    # the plain FL greedy over one shard is the sequential NaiveGreedy
    seq = solve(SelectionSpec(FacilityLocation.from_kernel(d["S"], device=CPU), d["budget"]))
    np.testing.assert_array_equal(got["fl"][0], seq.order.numpy())


def test_world4_partition_greedies_match_a_jax_4_device_mesh(world4):
    """Rows over `model` and columns over `data` on both sides (and columns
    over both dimensions, in mesh order and reversed, four shards): ids
    equal, gains within 1e-5 (the row split changes the order of the row
    sums)."""
    ranks, jax_out = world4
    for r in ranks:
        _hold_partition(r["partition"], jax_out, "(2, 2)")


# -- rejections, routes and the registry --------------------------------------


def test_mesh_rejections(cases, world1):
    """The JAX package's mesh rejections (tests/test_serving.py:440-485):
    use_kernel=True GraphCut / DisparitySum / DisparityMin, a family without
    a shard rule, a missing axis; and a mesh not built by make_mesh."""
    mesh = world1["bd"]
    rng = np.random.default_rng(500)
    for kind in ("gc_kernel", "dsum_kernel", "dmin_kernel"):
        fn = pair(kind, rng, N)[0]
        with pytest.raises(ValueError, match="use_kernel"):
            BatchedEngine([fn], mesh=mesh)
        # one device serves the same function
        solve([SelectionSpec(fn, 3, **stops(kind))], mode="batched")
    from repro_torch.core import DisparityMinSum

    dms = DisparityMinSum.from_distance(np.ones((N, N), np.float32), device=CPU)
    with pytest.raises(NotImplementedError, match="register_shard_rule"):
        BatchedEngine([dms], mesh=mesh)
    fns = cases["fl-NaiveGreedy"]["fns"]
    with pytest.raises(ValueError, match="no axis"):
        BatchedEngine(fns, mesh=mesh, batch_axis="x")
    with pytest.raises(ValueError, match="no axis"):
        solve([SelectionSpec(f, 3) for f in fns], mesh=mesh, data_axis="model")
    with pytest.raises(TypeError, match="make_mesh"):
        BatchedEngine(fns, mesh=object())
    with pytest.raises(ValueError, match="valid mask"):
        BatchedEngine(fns, mesh=mesh, valid=np.ones((4, N + 1), bool))
    with pytest.raises(ValueError, match='needs a 2-D mesh'):
        solve([SelectionSpec(fns[0], 3)], mode="sharded")
    # serving on a mesh (tests/test_torch_mesh_serving.py): a missing axis
    # is refused as the sharded route refuses it
    with pytest.raises(ValueError, match="no axis"):
        solve([SelectionSpec(fns[0], 3)], mode="served", mesh=mesh, data_axis="model")
    with pytest.raises(ValueError, match="no axis"):
        solve([SelectionSpec(fns[0], 3)], mode="async", mesh=mesh, batch_axis="x")
    with pytest.raises(ValueError, match="holds 4 ranks"):
        make_mesh((2, 2), ("batch", "data"), device=CPU)


def test_wave_capable_names_equal_the_jax_packages():
    """The JAX package's rule: a batched hook and a sharded one (or
    mesh_replicated)."""
    assert wave_capable_names() == jwave_capable_names()


def test_sampled_optimizers_are_refused_on_a_mesh(cases, world1):
    fns = cases["fl-NaiveGreedy"]["fns"]
    with pytest.raises(ValueError, match="batched-capable"):
        solve([SelectionSpec(f, 3, "StochasticGreedy") for f in fns], mesh=world1["bd"])


def test_streaming_optimizers_run_replicated_on_a_mesh(cases, world1):
    """SieveStreaming / ThresholdGreedy have no sharded engine; on a mesh
    their batched hook runs on every rank and equals the sequential solve."""
    fns = cases["fl-NaiveGreedy"]["fns"]
    for opt in ("SieveStreaming", "ThresholdGreedy"):
        specs = [SelectionSpec(f, b, opt) for f, b in zip(fns, BUDGETS)]
        for s, r in zip(specs, solve(specs, mesh=world1["bd"])):
            _same(result_to_numpy(r), result_to_numpy(solve(s)), opt)


def test_solve_single_vs_all_modes_bit_identical(world1):
    """tests/test_spec.py:273: one spec through the sequential, batched,
    sharded (1, 1), served and async routes gives the same bits."""
    rng = np.random.default_rng(501)
    spec = SelectionSpec(pair("fl", rng, N)[0], 4, "LazyGreedy", screen_k=6)
    seq = result_to_numpy(solve(spec))
    routes = [*solve([spec, spec], mode="batched"), *solve([spec, spec], mesh=world1["bd"]),
              *solve([spec, spec], mode="sharded", mesh=world1["bd"]),
              solve(spec, mesh=world1["bd"]), solve([spec], mode="served")[0],
              solve([spec], mode="async")[0]]
    for r in routes:
        _same(result_to_numpy(r), seq)


def test_internal_paths_emit_no_warnings(world1):
    """tests/test_spec.py:445: no route touches a deprecated shim (and the
    gather's name, deprecated in newer torch, warns nothing either)."""
    rng = np.random.default_rng(502)
    spec = SelectionSpec(pair("fl", rng, N)[0], 3, "LazyGreedy")
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        solve([spec], mesh=world1["bd"])
        solve([spec, spec], mode="sharded", mesh=world1["bd"])
    assert not [w for w in record if issubclass(w.category, (DeprecationWarning, FutureWarning))]


def test_an_engine_answers_again_from_its_slices(cases, world1):
    """The engine slices once: it answers repeated calls, with other
    budgets and a higher loop bound, after the caller drops the functions."""
    case = cases["gc-LazyGreedy"]
    fns = list(case["fns"])
    engine = BatchedEngine(fns, mesh=world1["bd"])
    del fns
    first = engine.run(BUDGETS, OptimizerSpec("LazyGreedy", screen_k=6))
    again = engine.run(BUDGETS, OptimizerSpec("LazyGreedy", screen_k=6), max_budget=9)
    for a, b in zip(first, again):
        _same(result_to_numpy(a), result_to_numpy(b))


# -- a rank that dies ----------------------------------------------------------


def test_a_dead_rank_fails_the_world_within_its_timeout(cases, tmp_path):
    """Rank 1 exits before its first collective: rank 0 raises within the
    process group's timeout and the world ends failed, well inside the
    join timeout (never the test run's clock)."""
    case = cases["fl-NaiveGreedy"]
    job = {"meshes": {"bd": ((1, 2), ("batch", "data"))}, "timeout_s": 10, "die_rank": 1,
           "waves": {"w": dict(fns=case["fns"], budgets=BUDGETS, optimizer="NaiveGreedy",
                               mesh="bd")}}
    t0 = time.monotonic()
    with pytest.raises(AssertionError, match="rank 1: exit 3"):
        results(start_world(job, 2, tmp_path), tmp_path, timeout=60)
    assert time.monotonic() - t0 < 60
    assert not os.path.exists(tmp_path / "result0.pt")
