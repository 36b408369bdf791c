"""A configuration, a traffic mix, a cell, a function, a loop and a
per-layer metric added as new files, with their entries in BENCHMARK.json,
are found by name and run: no file the benchmark already has is edited."""
import json

import pytest

from portbench import bench
from portbench.tests import tiny

CONFIG = {"name": "tiny-fl", "source": "https://arxiv.org/abs/2202.10680", "family":
          "FacilityLocation", "n": 120, "d": 8, "metric": "cosine",
          "data": {"kind": "gaussian_mixture", "components": 6}, "assumed": {}, "reduced": []}
TRAFFIC = {"loop": "solve_again", "function": "fl_torch", "optimizer": "NaiveGreedy",
           "budget": 9, "trace_solves": 2, "check_solves": 1}
FUNCTION = '''"""FacilityLocation on the port's torch sweep (use_kernel=False)."""
from portbench import reference, work

FAMILY = "FacilityLocation"
judge = reference.judge


def build(x, config):
    from repro_torch.core import FacilityLocation, create_kernel

    config["built_by"] = "fl_torch"
    S = create_kernel(x, metric=config["metric"], use_pallas=False)
    return FacilityLocation.from_kernel(S, use_kernel=False), S


def step_s(config):
    return work.fl_sweep_s(config["n"], config["n"])


def control(x, config, budget):
    return reference.control(x, config["metric"], budget, held=True)
'''
METRIC = '''"""Greedy steps a second of the traced window."""


def read(run):
    if run.trace is None:
        return None
    return run.trace_steps / run.trace.window_s
'''


def _add_cell(tmp_path):
    spec = tiny.copy_benchmark(tmp_path)
    pb = tmp_path / "portbench"
    (pb / "configs" / "tiny-fl.json").write_text(json.dumps(CONFIG))
    (pb / "traffic" / "tiny_solve.json").write_text(json.dumps(TRAFFIC))
    (pb / "functions" / "fl_torch.py").write_text(FUNCTION)
    (pb / "loops" / "solve_again.py").write_text((pb / "loops" / "solve.py").read_text())
    (pb / "limits" / "tiny.solve.json").write_text(json.dumps({"gain_err": 1e-5}))
    (pb / "metrics" / "steps_per_s.solve.py").write_text(METRIC)
    spec["configs"].append({"name": "tiny-fl", "source": CONFIG["source"],
                            "file": "portbench/configs/tiny-fl.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "tiny.solve", "config": "tiny-fl",
                              "traffic": "tiny_solve", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "solve_s":
            m["workloads"].append("tiny.solve")
    spec["per_layer"].append({"name": "steps_per_s.solve", "unit": "steps/s",
                              "better": "higher", "source": "device_trace", "layer": "engines",
                              "moves": "solve_s", "workloads": ["tiny.solve"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench.Cell(tmp_path, "tiny.solve")


def test_new_files_are_found_and_run(tmp_path):
    cell = _add_cell(tmp_path)
    assert cell.config["n"] == 120 and cell.traffic["budget"] == 9
    _, _, e2e = tiny.run(cell)
    assert set(e2e["metrics"]) == {"setup_s", "solve_s"} and e2e["correct"] is True
    assert cell.config["built_by"] == "fl_torch"  # the new function file built it
    _, _, traced = tiny.run(cell, trace=True)
    assert traced["metrics"]["steps_per_s.solve"]["value"] == 18 / 2.0
    # the cells' own per-layer metrics list the cells they read
    assert set(traced["metrics"]) == {"steps_per_s.solve"}


def test_a_function_of_another_family_is_refused(tmp_path):
    cell = _add_cell(tmp_path)
    cell.config["family"] = "GraphCut"
    with pytest.raises(KeyError, match="GraphCut"):
        tiny.run(cell)
