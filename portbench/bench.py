"""One run of one cell: find it by name, check the card, drive the traffic,
judge the answers, and print the result as the last line of stdout.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``portbench/configs/<config>.json`` (the entry's ``file``): the deployment;
- ``portbench/traffic/<traffic>.json``: the parameters the one generator of
  ``portbench/generator.py`` reads, which name its loop
  (``portbench/loops/<loop>.py``) and its function
  (``portbench/functions/<function>.py``);
- ``portbench/limits/<workload>.json``: the numbers the comparison reads for
  the cell, each with its limit (``portbench/reference.py``);
- ``portbench/metrics/<metric>.py``: a reader ``read(run)`` of the metric,
  returning None where the run holds nothing to read.

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones, read from a traced phase that follows the
measured window.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

from portbench import generator, work

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
# top-level module names the process must not hold once the window closed:
# JAX and the JAX package the port was made from (compared whole, so the
# port's own ``repro_torch`` does not match ``repro``)
FOREIGN = ("jax", "jaxlib", "flax", "repro")


class Cell:
    """A workload of ``BENCHMARK.json`` with its files read."""

    def __init__(self, root: Path, name: str):
        spec = json.loads((root / "BENCHMARK.json").read_text())
        self.root, self.name = root, name
        wl = _named(spec["workloads"], name, "workload")
        self.chips = int(wl["chips"])
        cfg = _named(spec["configs"], wl["config"], "config")
        self.config = json.loads((root / cfg["file"]).read_text())
        self.traffic = json.loads((root / "portbench" / "traffic" / f"{wl['traffic']}.json")
                                  .read_text())
        self.limits = json.loads((root / "portbench" / "limits" / f"{name}.json").read_text())
        self.end_to_end = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
        moves = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if name in m.get("workloads", [name] if m["moves"] in moves else [])]


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def reader(root: Path, name: str):
    """The ``read`` function of ``portbench/metrics/<name>.py``."""
    return generator.plugin(root, "metrics", name).read


def foreign_modules(modules=None) -> list:
    """Top-level names in ``sys.modules`` (the part before the first dot,
    compared whole) that are JAX's or the JAX package's."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FOREIGN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, tracer=None):
    """Drive the cell once and judge it; returns (run, checks) where checks
    maps each number compared to (value, limit)."""
    ctx = generator.Context(cell.config, cell.traffic, seed, device, cell.root)
    kwargs = {} if tracer is None else {"tracer": tracer}
    run, answers = generator.drive(ctx, seconds, trace, t_start, **kwargs)
    _free(ctx)
    t = time.perf_counter()
    values = ctx.function_module.judge(answers, list(cell.limits))
    run.judged, run.judge_s = len(answers), time.perf_counter() - t
    if not answers:
        values = {k: math.inf for k in cell.limits}
    checks = {k: (values[k], float(cell.limits[k])) for k in cell.limits}
    return run, checks


def _free(ctx) -> None:
    """Drop what the program made before the reference runs: the reference
    must neither set the peak nor share memory with the program."""
    import gc

    import torch

    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def result(cell: Cell, run, checks: dict, trace: bool, device: dict) -> dict:
    """The last line's object; ``checks`` comes last."""
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = reader(cell.root, m["name"])(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct = run.failed == 0 and all(v <= lim for v, lim in checks.values())
    line = {"correct": bool(correct), "attempted": int(run.attempted),
            "failed": int(run.failed), "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        line["device"] = {**device, "busy_s": run.trace.busy_s, "window_s": run.trace.window_s}
        line["breakdown"] = {"device_ops": run.trace.device_ops,
                             "idle_gaps": run.trace.idle_gaps}
    line["checks"] = {k: {"value": _num(v), "limit": lim} for k, (v, lim) in checks.items()}
    return line


def _num(v: float):
    return v if math.isfinite(v) else str(v)


def _smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    try:
        cell = Cell(ROOT, a.workload)
    except (KeyError, FileNotFoundError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {a.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    # the configurations state fp32: every product in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}, count {cell.chips}, nvidia-smi name, power.limit: {_smi()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"peaks: fp32 {work.PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s (published), "
          f"3xTF32 matrix work {work.PEAK_MATMUL_FLOPS / 1e12:.0f} TFLOP/s (roofline divisor), "
          f"HBM {work.PEAK_BYTES_PER_S / 1e12:.2f} TB/s")
    sys.stdout.flush()
    run, checks = run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda", t_start)
    print(f"backend_name: {run.backend}")
    from repro_torch.kernels._build import BUILD_INFO

    print(f"set-up parts (s): {run.setup_parts}; kernel library cached "
          f"{BUILD_INFO.get('cached')}, loaded in {BUILD_INFO.get('seconds')} s")
    print(f"reference: {run.judged} answers judged in {run.judge_s:.3f} s after the window")
    bad = foreign_modules()
    if bad:
        print(f"portbench: the process holds {', '.join(bad)} after the window", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    line = result(cell, run, checks, bool(a.trace), device)
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
