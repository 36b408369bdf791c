"""The readings that set a cell's limits.

    python3 portbench/calibrate.py --workload NAME --seeds 1,2,... \
        [--control-seeds 7,8,9] [--seconds S]

On the card, in one process:

- the program: for each of ``--seeds``, a run of the cell (``--seconds`` of
  window, untraced), and the numbers its comparison reads;
- the control: for each of ``--control-seeds``, the cell's inputs made from
  the seed and answered by the reference in the program's place one
  precision step below (the cell's function's ``control``: TF32 products,
  S held in bfloat16 where the program holds S), judged by the same
  comparison, at the cell's own sizes and sample (the loop's
  ``control_answers``).

One JSON line a reading; nothing is written.  The benchmark's own runs do
not run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    _root = Path(__file__).resolve().parent.parent
    _here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(_root), str(_root / "src")] + [p for p in sys.path if p != _here]


def _ints(s: str) -> list:
    return [int(v) for v in s.split(",") if v]


def control_values(cell, seed: int, device: str) -> dict:
    """The control's numbers on the inputs of ``seed``, by the cell's own
    comparison."""
    from portbench import generator

    ctx = generator.Context(cell.config, cell.traffic, seed, device, cell.root)
    names = list(cell.limits)
    return ctx.function_module.judge(ctx.loop().control_answers(ctx, names), names)


def main(argv) -> int:
    import torch

    from portbench import bench

    ap = argparse.ArgumentParser(prog="portbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, default=5.0)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs the card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = bench.Cell(bench.ROOT, a.workload)
    for seed in a.seeds:
        torch.cuda.reset_peak_memory_stats()
        run, checks = bench.run_cell(cell, seed, a.seconds, False, "cuda", time.perf_counter())
        e2e = {m["name"]: bench.reader(cell.root, m["name"])(run) for m in cell.end_to_end}
        print(json.dumps({"kind": "program", "seed": seed, "attempted": run.attempted,
                          "failed": run.failed, "checks": {k: v for k, (v, _) in checks.items()},
                          "metrics": e2e, "peak": run.memory_peak_bytes,
                          "backend": run.backend}), flush=True)
    for seed in a.control_seeds:
        t = time.perf_counter()
        values = control_values(cell, seed, "cuda")
        print(json.dumps({"kind": "control", "seed": seed, "checks": values,
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
