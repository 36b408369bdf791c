"""The import guard: after a run no module of JAX or of the JAX package is
loaded, by top-level name compared whole; and a run that finds no card, or
no program, prints no result and exits non-zero."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import bench
from portbench.tests import tiny


def test_top_level_names_are_compared_whole():
    mods = {"jax.numpy": 1, "jaxlib": 1, "repro.core": 1, "repro_torch.core": 1,
            "reprox": 1, "flax.linen": 1, "numpy": 1}
    assert bench.foreign_modules(mods) == ["flax", "jax", "jaxlib", "repro"]
    assert bench.foreign_modules({"repro_torch": 1, "jaxtyping": 1}) == []


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from portbench import bench\n"
        "from portbench.tests import tiny\n"
        "for name in tiny.CELLS:\n"
        "    tiny.run(tiny.cell(name))\n"
        "print(bench.foreign_modules())\n"
    ) % (str(tiny.ROOT), str(tiny.ROOT / "src"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=tiny.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _cli(cwd, workload="cifar10.naive"):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload, "--seed", str(tiny.SEED),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})


def _no_result(out) -> bool:
    for line in out.stdout.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        return False
    return True


def test_no_card_means_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _cli(tiny.ROOT)
    assert out.returncode != 0 and _no_result(out)


def test_the_benchmark_alone_is_not_enough(tmp_path):
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and _no_result(out)


def test_an_unknown_workload_is_refused():
    out = _cli(tiny.ROOT, workload="no.such.cell")
    assert out.returncode == 2 and _no_result(out)
