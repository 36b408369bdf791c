"""The plain reference against the port's plain paths at tiny sizes, the
work counts against hand-worked shapes, and the last line's keys."""
import math

import pytest
import torch

from portbench import generator, reference, work
from portbench.tests import tiny


def _features(n=200, d=16, seed=3):
    g = torch.Generator().manual_seed(seed)
    return generator.mixture(g, n, d, 10, "cpu")


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_similarity_matches_the_ports_create_kernel(metric):
    from repro_torch.core import create_kernel

    x = _features()
    got = create_kernel(x, metric=metric, use_pallas=True).double()
    want = reference.similarity(x, x, metric)
    off = ~torch.eye(x.shape[0], dtype=torch.bool)
    assert float((got - want)[off].abs().max()) < 1e-6
    if metric == "cosine":  # the euclidean diagonal is an open question of PERF.md
        assert float((got - want).diagonal().abs().max()) < 1e-6


@pytest.mark.parametrize("kind", ["fl_dense", "flmf"])
def test_the_ports_greedy_reads_near_zero(kind):
    from repro_torch.core import (
        FacilityLocation, FacilityLocationMF, SelectionSpec, create_kernel, solve)

    x = _features()
    if kind == "fl_dense":
        fn = FacilityLocation.from_kernel(create_kernel(x, metric="cosine", use_pallas=True),
                                          use_kernel=None)
    else:
        fn = FacilityLocationMF.from_features(x, metric="cosine", use_kernel=None)
    res = solve(SelectionSpec(fn, 30, "NaiveGreedy"))
    a = reference.Answer(x, "cosine", 30, res.order.tolist(), res.gains.tolist())
    got = reference.judge([a], ["gain_err", "pick_regret"])
    assert got["gain_err"] < 1e-5 and got["pick_regret"] < 1e-5, got


def test_teacher_forced_matches_a_plain_greedy_in_float64():
    x = _features(seed=5)
    S = reference.similarity(x, x, "cosine")
    ids, gains = reference.greedy(S, 25)
    got, best = reference.teacher_forced(x, "cosine", ids)
    assert got == pytest.approx(gains, rel=1e-6)
    assert got == pytest.approx(best[:-1], rel=1e-6)


def test_broken_answers_read_one_or_more():
    x = _features()
    ids, gains = reference.greedy(reference.similarity(x, x, "cosine"), 10)

    def judge(i, g):
        a = reference.Answer(x, "cosine", 10, i, g)
        return reference.judge([a], ["gain_err", "pick_regret"])

    assert judge(ids[:5] + ids[4:9], gains)["pick_regret"] >= 1.0  # a pick taken twice
    assert math.isinf(judge(ids[:5] + [10**6] + ids[6:], gains)["gain_err"])
    assert math.isinf(judge(ids[:5], gains[:5])["gain_err"])  # short while gains are left
    assert math.isinf(judge(ids, gains[:-1] + [float("nan")])["gain_err"])


def test_round_tf32_keeps_ten_mantissa_bits():
    t = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-12)])
    assert reference.round_tf32(t).tolist() == [1.0 + 2**-10, 1.0, 1.0 + 2**-9, -1.0]


def test_work_counts_against_hand_worked_shapes():
    config = {"n": 50_000, "d": 512}
    # cifar10.naive: 500 steps each read the 50,000^2 fp32 S once at 3.35 TB/s
    naive = 500 * generator.plugin(tiny.ROOT, "functions", "fl_dense").step_s(config)
    assert naive == pytest.approx(500 * 50_000**2 * 4 / 3.35e12, rel=1e-4)
    assert naive == pytest.approx(1.4925, abs=1e-3)
    # cifar10.mf: 2 n^2 d of matrix work a step at 495 / 3 TFLOP/s
    assert generator.plugin(tiny.ROOT, "functions", "flmf").step_s(config) == pytest.approx(
        2 * 50_000**2 * 512 / 165e12, rel=1e-9)
    assert work.least_s(2 * 50_000**2 * 512, 0) > 50_000**2 * 4 / 3.35e12  # compute-bound


@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line_has_its_keys_in_order(trace):
    c = tiny.cell("cifar10.naive")
    _, _, line = tiny.run(c, trace=trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert ("breakdown" in line) == trace
    names = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(line["metrics"]) == names
    assert line["correct"] is True
