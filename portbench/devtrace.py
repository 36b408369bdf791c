"""The device trace of a traced window: ``torch.profiler`` over the card.

:class:`DeviceTrace` profiles the code inside it (CPU and CUDA activity),
synchronizes the card at both ends, and reads the exported trace:

- ``busy_s``: the union of the intervals in which a kernel, a copy or a
  memset ran on the device, inside the window;
- ``window_s``: the window's length, from the annotation that spans it;
- ``kernels``: how many kernels ran in it, the port's and torch's alike;
- ``device_ops``: the ten device operations that took the most time;
- ``idle_gaps``: the device's idle time inside the window, summed by the
  host operation that was running at the middle of each gap (the latest
  started one that covers it, on any thread), the ten largest.

It runs only on the card: without one it raises, and nothing falls back to
the CPU.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile

import torch

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function", "user_annotation")
TOP = 10
_LOOK_BACK = 4096  # host events searched back from a gap for the one covering it


@dataclasses.dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    kernels: int
    device_ops: list  # [[name, seconds], ...]
    idle_gaps: list  # [[host op, seconds], ...]


class DeviceTrace:
    """Context manager: profile the body on the card; ``summary`` afterwards."""

    def __init__(self):
        self.summary: TraceSummary | None = None
        self._prof = None
        self._mark = None

    def __enter__(self) -> "DeviceTrace":
        if not torch.cuda.is_available():
            raise RuntimeError("the device trace needs the card")
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._mark = record_function(WINDOW)
        self._mark.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        self.summary = summarize(events)
        if self.summary.busy_s <= 0.0:
            raise RuntimeError("the profiler's trace holds no device activity")


def warm_up() -> None:
    """Start and stop the profiler once, so that a later start is quick."""
    with DeviceTrace():
        torch.zeros(1, device="cuda").add_(1)


def _merge(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def summarize(events: list) -> TraceSummary:
    """Reduce a chrome trace's events (times in microseconds) to the window's
    device busy time, kernel count, top device ops and idle gaps."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
    marks = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError(f"the trace holds no {WINDOW!r} annotation")
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])
    dev, by_name, kernels = [], collections.Counter(), 0
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        lo, hi = max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"]))
        if hi <= lo:
            continue
        dev.append((lo, hi))
        by_name[e["name"]] += (hi - lo) * 1e-6
        kernels += e.get("cat") == "kernel"
    busy = _merge(dev)
    busy_s = sum(hi - lo for lo, hi in busy) * 1e-6
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    host = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        for e in xs if e.get("cat") in HOST_CATS and e.get("name") != WINDOW
    )
    starts = [h[0] for h in host]
    idle = collections.Counter()
    for lo, hi in gaps:
        idle[_host_at(host, starts, 0.5 * (lo + hi))] += (hi - lo) * 1e-6
    return TraceSummary(
        busy_s=busy_s,
        window_s=(w1 - w0) * 1e-6,
        kernels=int(kernels),
        device_ops=[[k, v] for k, v in by_name.most_common(TOP)],
        idle_gaps=[[k, v] for k, v in idle.most_common(TOP)],
    )


def _host_at(host, starts, t) -> str:
    """Name of the latest started host event that covers time ``t``."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - _LOOK_BACK), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "python (no op recorded)"
