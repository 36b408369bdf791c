"""The port's serving metrics (``repro_torch.launch.metrics``): bounded
counters, reservoir percentiles and the snapshot schema, as
tests/test_metrics.py holds the JAX package's — and, for the same events,
the snapshot equal to the JAX package's, sampled values included (the
reservoirs are seeded from the metric names as there).
"""
import random

import numpy as np
import pytest

from repro.launch import metrics as jmetrics
from repro_torch.launch.metrics import Histogram, Reservoir, ServerMetrics, _seed_for


def test_reservoir_is_bounded_and_uniform():
    r = Reservoir(capacity=64, seed=0)
    for v in range(10_000):
        r.add(float(v))
    assert len(r._sample) == 64  # O(capacity) memory, 10k values in
    assert r.seen == 10_000
    # a uniform sample of 0..9999: the median estimate lands mid-range
    assert 2_000 < r.percentile(0.5) < 8_000
    assert r.percentile(0.0) <= r.percentile(0.5) <= r.percentile(1.0)


def test_reservoir_small_stream_is_exact():
    r = Reservoir(capacity=512)
    for v in [5.0, 1.0, 3.0]:
        r.add(v)
    assert r.percentile(0.0) == 1.0
    assert r.percentile(0.5) == 3.0
    assert r.percentile(1.0) == 5.0
    assert np.isnan(Reservoir().percentile(0.5))  # empty -> NaN, not a crash
    with pytest.raises(ValueError, match="capacity"):
        Reservoir(capacity=0)


def test_reservoir_is_deterministic():
    a, b = Reservoir(capacity=8, seed=3), Reservoir(capacity=8, seed=3)
    for v in range(1000):
        a.add(float(v))
        b.add(float(v))
    assert a._sample == b._sample  # seeded: reproducible accounting


def test_histogram_exact_aggregates_bounded_percentiles():
    h = Histogram(reservoir_size=16)
    for v in range(100):
        h.record(float(v))
    assert h.count == 100
    assert h.total == float(sum(range(100)))  # count/sum/min/max are EXACT
    assert h.min == 0.0 and h.max == 99.0
    assert h.mean == pytest.approx(49.5)
    snap = h.snapshot()
    assert set(snap) == {"count", "sum", "max", "p50", "p99"}
    assert snap["count"] == 100 and snap["max"] == 99.0
    empty = Histogram().snapshot()
    assert empty == {"count": 0, "sum": 0.0, "max": 0.0, "p50": 0.0, "p99": 0.0}


def test_server_metrics_snapshot_schema():
    m = ServerMetrics()
    m.observe_enqueue("FacilityLocation/n32/NaiveGreedy", depth=1)
    m.observe_enqueue("FacilityLocation/n32/NaiveGreedy", depth=2)
    m.observe_wave("FacilityLocation/n32/NaiveGreedy", 0.5,
                   requests=2, slots=4, padded_slots=2)
    m.observe_served("FacilityLocation/n32/NaiveGreedy", 0.01)
    m.observe_served("FacilityLocation/n32/NaiveGreedy", 0.02,
                     deadline_missed=True)
    m.inc("rejections")
    m.observe_delta(0.25, churn=3)
    m.set_breaker("FacilityLocation/kernel", "open")
    snap = m.snapshot()
    assert set(snap) == {
        "counters", "queue_s", "wave_s", "queue_depth", "delta_s",
        "breakers", "groups",
    }
    assert snap["breakers"] == {"FacilityLocation/kernel": "open"}
    c = snap["counters"]
    assert c["retries_total"] == 0
    assert c["fallbacks_total"] == 0
    assert c["quarantined_total"] == 0
    assert c["requests"] == 2 and c["waves"] == 1
    assert c["slots"] == 4 and c["padded_slots"] == 2
    assert c["rejections"] == 1 and c["deadline_misses"] == 1
    assert c["session_deltas"] == 1 and c["session_churn"] == 3
    assert snap["queue_s"]["count"] == 2
    assert snap["wave_s"]["max"] == 0.5
    assert snap["queue_depth"]["max"] == 2
    assert snap["delta_s"]["count"] == 1 and snap["delta_s"]["max"] == 0.25
    g = snap["groups"]["FacilityLocation/n32/NaiveGreedy"]
    assert g["requests"] == 2 and g["waves"] == 1
    assert g["queue_s"]["count"] == 2 and g["wave_s"]["count"] == 1
    # snapshots are detached: mutating the server doesn't alter them
    m.inc("rejections")
    assert snap["counters"]["rejections"] == 1


def test_server_metrics_thread_safe_under_contention():
    import threading

    m = ServerMetrics()

    def hammer():
        for _ in range(500):
            m.inc("requests")
            m.observe_served("G/n8/NaiveGreedy", 0.001)

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert m.counters["requests"] == 2000
    assert m.queue_s.count == 2000


def _replay(m, events):
    for name, args, kw in events:
        getattr(m, name)(*args, **kw)
    return m.snapshot()


def test_snapshot_equals_the_reference_for_the_same_events():
    """A few thousand seeded events (past every reservoir's capacity, so
    evictions happen) into the port's and the JAX package's ServerMetrics:
    the snapshots are equal, keys, counts, sums and sampled percentiles."""
    rng = random.Random(11)
    labels = ["FacilityLocation/n4096/NaiveGreedy", "GraphCut/n8192/LazyGreedy",
              "FeatureBased/n32/NaiveGreedy"]
    events = []
    for _ in range(3000):
        label = rng.choice(labels)
        kind = rng.randrange(6)
        if kind == 0:
            events.append(("observe_enqueue", (label, rng.randrange(1, 65)), {}))
        elif kind == 1:
            slots = rng.randrange(1, 65)
            events.append(("observe_wave", (label, rng.random()),
                           {"requests": slots - 1, "slots": slots, "padded_slots": 1}))
        elif kind == 2:
            events.append(("observe_served", (label, rng.random()),
                           {"deadline_missed": rng.random() < 0.1}))
        elif kind == 3:
            events.append(("observe_delta", (rng.random(),), {"churn": rng.randrange(5)}))
        elif kind == 4:
            events.append(("inc", (rng.choice(["rejections", "retries_total", "requeued"]),), {}))
        else:
            events.append(("set_breaker", (f"{label.split('/')[0]}/kernel",
                                           rng.choice(["open", "closed", "half_open"])), {}))
    for size in (8, 512):
        mine = _replay(ServerMetrics(reservoir_size=size), events)
        ref = _replay(jmetrics.ServerMetrics(reservoir_size=size), events)
        assert mine == ref
        assert mine["wave_s"]["count"] > size  # the reservoirs evicted


def test_reservoir_and_seeds_equal_the_reference():
    for name in ("queue_s", "wave_s", "G/n8/NaiveGreedy/queue_s"):
        assert jmetrics._seed_for(name) == _seed_for(name)
    a, b = Reservoir(capacity=16, seed=5), jmetrics.Reservoir(capacity=16, seed=5)
    for v in range(2000):
        a.add(v * 0.5)
        b.add(v * 0.5)
    assert a._sample == b._sample and a.percentile(0.99) == b.percentile(0.99)
