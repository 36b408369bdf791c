"""Time this checkout's similarity kernel against the same kernel built from
other directories of kernel sources (an older checkout's
``src/repro_torch/kernels/csrc``), side by side on one card:

    python -m repro_torch.kernels.compare_similarity OTHER_CSRC [OTHER_CSRC ...]

Every library is built with the same nvcc flags and loaded into one
process.  At the dense path's shape (n = m = 50,000, d = 512) and for dot
and cosine, each of two rounds times the kernels forward and back (this,
B, C, C, B, this), ten launches each with CUDA events,
so a drift of clock or power falls on all alike.  All outputs must be equal
bit for bit.  Prints the similarity kernels' ptxas lines, then one JSON line
with every time; exits non-zero on a mismatch.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.similarity_kernel import _METRIC_CODE, _normalize, inv_two_sigma_sq

N, D = 50_000, 512  # the dense path's shape (chip_smoke.py phase 4)
REPS, ROUNDS = 10, 2


def _library(csrc: Path, name: str) -> ctypes.CDLL:
    target = _build.BUILD_DIR / f"compare_{name}.so"
    for line in _build._compile(target, csrc):
        if "similarity" in line and ("registers" in line or "spill" in line):
            print(f"{name}: {line}", file=sys.stderr)
    lib = ctypes.CDLL(str(target))
    argtypes, restype = _build._SIGNATURES["similarity_launch"]
    lib.similarity_launch.argtypes = argtypes
    lib.similarity_launch.restype = restype
    return lib


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("other_csrc", type=Path, nargs="+")
    args = p.parse_args(argv)
    libs = {"this": _library(_build.CSRC, "this")}
    for i, csrc in enumerate(args.other_csrc):
        libs[str(csrc)] = _library(csrc, f"other{i}")
    order = list(libs) + list(reversed(libs))
    n, d = N, D
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((n, d), generator=gen, device="cuda")
    outs = {k: torch.empty((n, n), device="cuda") for k in libs}
    stream = torch.cuda.current_stream().cuda_stream
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    result = {"card": gpu, "n": n, "d": d, "reps": REPS, "ms": {}}
    ok = True
    for metric in ("dot", "cosine"):
        xm = _normalize(x).contiguous() if metric == "cosine" else x
        xx = (xm * xm).sum(1)

        def launch(which):
            rc = libs[which].similarity_launch(
                xm.data_ptr(), xm.data_ptr(), xx.data_ptr(), xx.data_ptr(),
                outs[which].data_ptr(), n, n, d, _METRIC_CODE[metric],
                inv_two_sigma_sq(d, None), stream)
            if rc != 0:
                raise RuntimeError(f"{which} similarity kernel: CUDA error {rc}")

        times = {k: [] for k in libs}
        for which in libs:  # warm up (and fill every output)
            launch(which)
        for _ in range(ROUNDS):
            for which in order:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(REPS):
                    launch(which)
                end.record()
                end.synchronize()
                times[which].append(start.elapsed_time(end) / REPS)
        equal = all(torch.equal(outs["this"], out) for out in outs.values())
        ok &= equal
        result["ms"][metric] = {**times, "bit_equal": equal}
        print(f"{metric}: {times} ms, bit-equal {equal}", file=sys.stderr, flush=True)
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
