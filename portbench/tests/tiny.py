"""Each cell of ``BENCHMARK.json`` at a size the CPU runs in a second, and a
stand-in for the device trace (the trace needs the card)."""
import json
import shutil
import time
from pathlib import Path

from portbench import bench, devtrace

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("cifar10.naive", "cifar10.mf")
SEED = 2**31 + 12345  # larger than 32 signed bits hold


class StubTrace:
    """What ``DeviceTrace`` gives, with fixed numbers."""

    def __enter__(self):
        self.summary = None
        return self

    def __exit__(self, *exc):
        self.summary = devtrace.TraceSummary(
            busy_s=1.0, window_s=2.0, kernels=100, device_ops=[["k", 1.0]],
            idle_gaps=[["aten::argmax", 1.0]])


def cell(name: str, root: Path = ROOT) -> bench.Cell:
    """The cell as ``BENCHMARK.json`` has it, cut to a tiny size."""
    c = bench.Cell(root, name)
    c.config.update(n=160, d=12)
    c.traffic["budget"] = 12
    return c


def run(c: bench.Cell, trace: bool = False, seconds: float = 0.5, seed: int = SEED):
    """One run of ``c`` on the CPU; returns (run, checks, last line)."""
    r, checks = bench.run_cell(c, seed, seconds, trace, "cpu", time.perf_counter(),
                                tracer=StubTrace)
    line = bench.result(c, r, checks, trace, {"platform": "cpu", "kind": "cpu", "count": 1,
                                               "memory_peak_bytes": 0})
    return r, checks, line


def copy_benchmark(tmp: Path) -> dict:
    """``portbench/`` copied into ``tmp``; returns BENCHMARK.json's entries,
    to be written to ``tmp`` with whatever a test adds."""
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return json.loads((ROOT / "BENCHMARK.json").read_text())
