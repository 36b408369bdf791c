"""Run one benchmark cell once, on the card:

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The last line of stdout is the result (see
``portbench/bench.py``); the numbers compared for ``correct`` are the last
lines of stderr.
"""
import time

T_START = time.perf_counter()  # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment() -> None:
    # libraries that would load JAX by themselves stay off it
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # kernel caches at fixed paths inside the checkout: only a checkout's
    # first run builds (the port's own library builds under
    # src/repro_torch/kernels/build/)
    cache = ROOT / "build" / "portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    # the package and the port, not this script's folder, whose module
    # names would shadow others
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [p for p in sys.path if p != here]


if __name__ == "__main__":
    _environment()
    from portbench import bench

    sys.exit(bench.main(sys.argv[1:], T_START))
