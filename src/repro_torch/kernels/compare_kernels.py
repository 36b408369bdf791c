"""Time this checkout's kernels against the same kernels built from other
directories of kernel sources (an older checkout's
``src/repro_torch/kernels/csrc``), side by side on one card:

    python -m repro_torch.kernels.compare_kernels [--kernels NAME,...] OTHER_CSRC [OTHER_CSRC ...]

Every library is built with the same nvcc flags and loaded into one
process.  At the dense path's shapes (chip_smoke.py phases 4 and 7: n =
50,000, d = 512), each kernel named (``similarity``, dot and cosine; the
dense pairwise full sweeps ``gc_gains``, ``dsum_gains``, ``dmin_gains`` on a
random (n, n) matrix and a mask of 500 ones) is timed forward and back
(this, B, C, C, B, this) in each of two rounds, ten launches each with CUDA
events, so a drift of clock or power falls on all alike.  All outputs of a
kernel must be equal bit for bit.  Prints the kernels' ptxas lines, then
one JSON line with every time; exits non-zero on a mismatch.
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
N_SEL = 500  # selected items in the dense pairwise sweeps' mask (phase 7 (e)'s budget)
REPS, ROUNDS = 10, 2
KERNELS = ("similarity", "gc_gains", "dsum_gains", "dmin_gains")


def _library(csrc: Path, name: str, kernels) -> ctypes.CDLL:
    target = _build.BUILD_DIR / f"compare_{name}.so"
    for line in _build._compile(target, csrc):
        if any(k in line for k in kernels) and ("registers" in line or "spill" in line):
            print(f"{name}: {line}", file=sys.stderr)
    lib = ctypes.CDLL(str(target))
    for k in kernels:
        argtypes, restype = _build._SIGNATURES[f"{k}_launch"]
        getattr(lib, f"{k}_launch").argtypes = argtypes
        getattr(lib, f"{k}_launch").restype = restype
    return lib


def _cases(kernels, stream):
    """Yield (label, output shape, launch(lib, out) -> CUDA error code)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "similarity" in kernels:
        x = torch.randn((N, D), generator=gen, device="cuda")
        for metric in ("dot", "cosine"):
            xm = _normalize(x).contiguous() if metric == "cosine" else x
            xx = (xm * xm).sum(1)
            yield f"similarity {metric}", (N, N), lambda lib, out, xm=xm, xx=xx, metric=metric: (
                lib.similarity_launch(xm.data_ptr(), xm.data_ptr(), xx.data_ptr(), xx.data_ptr(),
                                      out.data_ptr(), N, N, D, _METRIC_CODE[metric],
                                      inv_two_sigma_sq(D, None), stream))
        del x, xm, xx
    if not set(kernels) & {"gc_gains", "dsum_gains", "dmin_gains"}:
        return
    mat = torch.rand((N, N), generator=gen, device="cuda")
    mask = torch.zeros((N,), device="cuda")
    mask[torch.randperm(N, generator=gen, device="cuda")[:N_SEL]] = 1.0
    total = mat.sum(dim=0)
    lam = torch.tensor(0.4, device="cuda")
    count = torch.tensor(N_SEL, dtype=torch.int32, device="cuda")
    curmin = torch.tensor(0.05, device="cuda")
    if "gc_gains" in kernels:
        yield "gc_gains", (N,), lambda lib, out: lib.gc_gains_launch(
            mat.data_ptr(), N, mask.data_ptr(), total.data_ptr(), lam.data_ptr(), None, N,
            out.data_ptr(), stream)
    if "dsum_gains" in kernels:
        yield "dsum_gains", (N,), lambda lib, out: lib.dsum_gains_launch(
            mat.data_ptr(), N, mask.data_ptr(), out.data_ptr(), stream)
    if "dmin_gains" in kernels:
        yield "dmin_gains", (N,), lambda lib, out: lib.dmin_gains_launch(
            mat.data_ptr(), N, mask.data_ptr(), count.data_ptr(), curmin.data_ptr(),
            out.data_ptr(), stream)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("other_csrc", type=Path, nargs="+")
    p.add_argument("--kernels", default="similarity",
                   help=f"comma-separated, of {','.join(KERNELS)} (default: similarity)")
    args = p.parse_args(argv)
    args.kernels = args.kernels.split(",")
    if not set(args.kernels) <= set(KERNELS):
        p.error(f"--kernels: not a kernel of {KERNELS}: {args.kernels}")
    libs = {"this": _library(_build.CSRC, "this", args.kernels)}
    for i, csrc in enumerate(args.other_csrc):
        libs[str(csrc)] = _library(csrc, f"other{i}", args.kernels)
    order = list(libs) + list(reversed(libs))
    stream = torch.cuda.current_stream().cuda_stream
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    result = {"card": gpu, "n": N, "d": D, "reps": REPS, "ms": {}}
    ok = True
    for label, shape, launch in _cases(args.kernels, stream):
        outs = {k: torch.empty(shape, device="cuda") for k in libs}

        def run(which):
            rc = launch(libs[which], outs[which])
            if rc != 0:
                raise RuntimeError(f"{which} {label} kernel: CUDA error {rc}")

        times = {k: [] for k in libs}
        for which in libs:  # warm up (and fill every output)
            run(which)
        for _ in range(ROUNDS):
            for which in order:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(REPS):
                    run(which)
                end.record()
                end.synchronize()
                times[which].append(start.elapsed_time(end) / REPS)
        equal = all(torch.equal(outs["this"], out) for out in outs.values())
        ok &= equal
        result["ms"][label] = {**times, "bit_equal": equal}
        print(f"{label}: {times} ms, bit-equal {equal}", file=sys.stderr, flush=True)
        del outs
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
