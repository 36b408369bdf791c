#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one GPU and hold every kernel of
that path against its plain PyTorch version.

    python3 chip_smoke.py                  # full size: n=50,000, d=512
    python3 chip_smoke.py --n 8192 --naive-budget 50 --lazy-budget 200

The main path is the paper's core loop: ``create_kernel`` (CUDA similarity
kernel) -> ``FacilityLocation`` -> NaiveGreedy and LazyGreedy through
``SelectionSpec`` + ``solve()`` (CUDA FL-sweep kernel, full and gathered).
The ground set is CIFAR-10-sized: n items with d features drawn from
``--seed`` as a 100-component Gaussian mixture, cosine similarity.

Phases, each of which raises on failure (the exit code is then non-zero):
  1 device   CUDA present; the card's name and power limit
  2 build    nvcc every kernel source for sm_90a; ptxas registers/spills
  3 kernels  each kernel against its plain version at small and ragged shapes
  4 main     the main path at full size, its launch counts, and the same
             solves on the plain path, compared step by step
  5 times    each kernel, its plain version and the library call, timed
             with CUDA events at the main path's shapes
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Details go to chiprun_out/chip_smoke.json.
Without a CUDA device, or without the repo's ``src/`` beside it, the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# published H100 SXM peaks at 700 W (NVIDIA data sheet): fp32 off the tensor
# cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

SIM_TOL = {  # (rtol, atol) of the JAX package's similarity tests
    "dot": (1e-4, 1e-3),
    "cosine": (1e-4, 1e-3),
    "euclidean": (1e-3, 5e-2),
    "rbf": (1e-3, 5e-2),
}
FL_TOL = (1e-5, 1e-4)  # fl_gains kernel vs plain: fp32 sums of <= 50k terms
NEAR_TIE_REL = 1e-4  # top-two gains this close (relative) may flip the pick
GAIN_RTOL = 1e-5  # kernel-path vs plain-path gains over the agreeing prefix


def log(msg: str) -> None:
    print(msg, flush=True)


def max_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max()) if got.numel() else 0.0


def check_close(what: str, got, want, rtol: float, atol: float) -> float:
    """Raise unless |got - want| <= atol + rtol * |want| everywhere."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    g, w = got.double(), want.double()
    bad = (g - w).abs() > atol + rtol * w.abs()
    err = max_err(got, want)
    if not bool(g.isfinite().all()):
        raise AssertionError(f"{what}: non-finite values")
    if bool(bad.any()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} elements outside rtol={rtol} atol={atol}; max abs err {err:.3e}"
        )
    log(f"  ok  {what}: max abs err {err:.3e} (rtol {rtol}, atol {atol})")
    return err


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of one call in ms, CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time (ms) the card could take, and what sets it."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes")


def gaussian_mixture(seed: int, n: int, d: int, components: int = 100) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(components, d)).astype(np.float32)
    labels = rng.integers(0, components, size=n)
    return centers[labels] + rng.normal(size=(n, d)).astype(np.float32)


# ---------------------------------------------------------------------------


def phase_device(torch) -> dict:
    log("== phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"torch.cuda.get_device_name(0) = {name}; device_count = {torch.cuda.device_count()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return {"kind": name, "count": torch.cuda.device_count(), "nvidia_smi": smi}


def phase_build() -> dict:
    from repro_torch.kernels import _build

    log("== phase 2: build")
    _build.load()
    info = dict(_build.BUILD_INFO)
    log(f"built {info['library']} in {info['seconds']:.1f} s (cached: {info['cached']})")
    for line in info["ptxas"]:
        if "ptxas info" in line or "spill" in line or "error" in line.lower():
            log("  " + line)
    return info


def phase_kernels(torch, seed: int) -> None:
    from repro_torch.common import NEG_INF
    from repro_torch.kernels import ops
    from repro_torch.kernels.fl_gains import fl_gains_at_plain, fl_gains_plain
    from repro_torch.kernels.similarity_kernel import similarity_plain

    log("== phase 3: kernels vs plain, small and ragged shapes")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    for n, m, d in [(4096, 4096, 512), (1000, 777, 130)]:
        x = torch.randn((n, d), generator=gen, device=dev)
        y = torch.randn((m, d), generator=gen, device=dev)
        for metric, (rtol, atol) in SIM_TOL.items():
            got = ops.similarity(x, y, metric)
            torch.cuda.synchronize()
            check_close(f"similarity {metric} ({n},{m},{d})", got,
                        similarity_plain(x, y, metric), rtol, atol)
    for u, n in [(4096, 4096), (1000, 777), (333, 5000), (129, 1)]:
        sim = torch.rand((u, n), generator=gen, device=dev)
        cm = 0.8 * torch.rand((u,), generator=gen, device=dev)
        full = ops.fl_gains(sim, cm)
        torch.cuda.synchronize()
        check_close(f"fl_gains ({u},{n})", full, fl_gains_plain(sim, cm), *FL_TOL)
        for k in (1, 8, 100, 777):
            idx = torch.randint(0, n, (k,), generator=gen, device=dev)
            idx[::7] = -1  # padding slots, the first among them
            got = ops.fl_gains_at(sim, cm, idx)
            torch.cuda.synchronize()
            keep = idx >= 0
            if not torch.equal(got[keep], full[idx[keep]]):
                raise AssertionError(f"fl_gains_at ({u},{n}) k={k}: not bit-equal to fl_gains")
            if not bool((got[~keep] == NEG_INF).all()):
                raise AssertionError(f"fl_gains_at ({u},{n}) k={k}: pads are not NEG_INF")
            check_close(f"fl_gains_at ({u},{n}) k={k} (bit-equal to fl_gains, pads NEG_INF)",
                        got, fl_gains_at_plain(sim, cm, idx), *FL_TOL)


def _replay_check(torch, name, fn_plain, kern, plain) -> dict:
    """Hold the kernel path's ids against the plain path's.

    They must agree at every step before the first step where the plain
    path's top two gains lie within NEAR_TIE_REL of each other, and their
    gains must agree to GAIN_RTOL over the agreeing prefix.  The plain
    path's top two gains are found by replaying its selections through its
    own gains() sweep."""
    from repro_torch.common import NEG_INF
    from repro_torch.core import FLState

    ko, po = kern.order.cpu().numpy(), plain.order.cpu().numpy()
    kg, pg = kern.gains.cpu().numpy(), plain.gains.cpu().numpy()
    diff = np.nonzero(ko != po)[0]
    t_dis = int(diff[0]) if diff.size else None
    u = fn_plain.sim.shape[0]
    cm = torch.zeros((u,), device="cuda")
    selected = torch.zeros((fn_plain.n,), dtype=torch.bool, device="cuda")
    t_tie, gap = None, None
    steps = int((po >= 0).sum())
    for t in range(steps):
        g = torch.where(selected, NEG_INF, fn_plain.gains(FLState(curmax=cm, n_rows=u)))
        g1, g2 = (float(v) for v in torch.topk(g, 2).values)
        if g1 - g2 <= NEAR_TIE_REL * abs(g1):
            t_tie, gap = t, g1 - g2
            break
        if t_dis is not None and t >= t_dis:
            break
        j = int(po[t])
        cm = torch.maximum(cm, fn_plain.sim[:, j])
        selected[j] = True
    agree = len(ko) if t_dis is None else t_dis
    if t_dis is not None and (t_tie is None or t_dis < t_tie):
        raise AssertionError(
            f"{name}: kernel path picks {ko[t_dis]} at step {t_dis}, plain path {po[t_dis]}, "
            f"before any near-tie (first near-tie: {t_tie})"
        )
    rel = np.abs(kg[:agree] - pg[:agree]) > GAIN_RTOL * np.abs(pg[:agree])
    if rel.any():
        t = int(np.nonzero(rel)[0][0])
        raise AssertionError(f"{name}: gains differ beyond rtol {GAIN_RTOL} at step {t}: {kg[t]} vs {pg[t]}")
    log(f"  ok  {name}: ids agree over {agree} steps; first near-tie of the plain path "
        f"(top two within {NEAR_TIE_REL} rel): {'none' if t_tie is None else t_tie}"
        + ("" if gap is None else f" (gap {gap:.3e})")
        + f"; first disagreement: {'none' if t_dis is None else t_dis}")
    return {"first_near_tie": t_tie, "near_tie_gap": gap, "first_disagreement": t_dis,
            "agreeing_steps": agree}


def _timed_solve(torch, spec) -> tuple:
    from repro_torch.core import solve

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = solve(spec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, torch.cuda.max_memory_allocated()


def phase_main(torch, args) -> dict:
    from repro_torch.core import (
        FacilityLocation, SelectionSpec, backend_name, create_kernel,
    )
    from repro_torch.kernels import ops
    from repro_torch.kernels.similarity_kernel import similarity_plain

    n, d = args.n, args.d
    log(f"== phase 4: main path, n={n}, d={d}, cosine, NaiveGreedy {args.naive_budget}, "
        f"LazyGreedy {args.lazy_budget}")
    x = gaussian_mixture(args.seed, n, d)
    out = {"n": n, "d": d, "naive_budget": args.naive_budget, "lazy_budget": args.lazy_budget}

    # ---- the main path, counted: counts to 0 just before, read just after
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    S = create_kernel(x, metric="cosine", use_pallas=True)
    torch.cuda.synchronize()
    out["create_kernel_s"] = time.perf_counter() - t0
    fn = FacilityLocation.from_kernel(S, use_kernel=None)
    name = backend_name(fn)
    if name != "cuda-fl":
        raise AssertionError(f"backend_name is {name!r}, expected 'cuda-fl'")
    runs = {}
    for opt, budget in (("NaiveGreedy", args.naive_budget), ("LazyGreedy", args.lazy_budget)):
        runs[opt] = _timed_solve(torch, SelectionSpec(fn, budget, opt))
    launches = dict(ops.LAUNCHES)
    log(f"  backend_name = {name}; launches on the main path: {launches}")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    out["launches"] = launches
    log(f"  create_kernel: {out['create_kernel_s']:.3f} s (host clock, synchronized)")

    # ---- outputs: S against the plain version on its first and last rows
    rows = min(1024, n)
    for label, sl in (("first", slice(0, rows)), ("last", slice(n - rows, n))):
        want = similarity_plain(torch.as_tensor(x[sl], device="cuda"),
                                torch.as_tensor(x, device="cuda"), "cosine")
        out[f"S_{label}_rows_err"] = check_close(
            f"S {label} {rows} rows vs similarity_plain", S[sl], want, 0.0, 1e-5)
        del want
    out["S_max_abs_err"] = max(out["S_first_rows_err"], out["S_last_rows_err"])

    # ---- the same solves on the plain path, compared step by step
    fn_plain = FacilityLocation.from_kernel(S, use_kernel=False)
    before = dict(ops.LAUNCHES)
    for opt, budget in (("NaiveGreedy", args.naive_budget), ("LazyGreedy", args.lazy_budget)):
        kern, wall, peak = runs[opt]
        plain, pwall, ppeak = _timed_solve(torch, SelectionSpec(fn_plain, budget, opt))
        for r in (kern, plain):
            if not (bool(r.gains.isfinite().all()) and r.order.shape == (budget,)):
                raise AssertionError(f"{opt}: malformed result")
        info = _replay_check(torch, opt, fn_plain, kern, plain)
        info.update(
            n_evals=int(kern.n_evals), value=float(kern.value), wall_s=wall, peak_bytes=peak,
            plain_n_evals=int(plain.n_evals), plain_value=float(plain.value),
            plain_wall_s=pwall, plain_peak_bytes=ppeak,
            selected=int((kern.order >= 0).sum()),
        )
        log(f"  {opt}: kernel path n_evals={info['n_evals']} f(A)={info['value']:.6f} "
            f"wall={wall:.3f} s peak={peak / 2**30:.2f} GiB; plain path "
            f"n_evals={info['plain_n_evals']} f(A)={info['plain_value']:.6f} "
            f"wall={pwall:.3f} s peak={ppeak / 2**30:.2f} GiB")
        out[opt] = info
    if ops.LAUNCHES != before:
        raise AssertionError("the plain path launched a kernel")

    naive_ids = runs["NaiveGreedy"][0].order.cpu().numpy()
    lazy_ids = runs["LazyGreedy"][0].order.cpu().numpy()
    common = min(len(naive_ids), len(lazy_ids))
    diff = np.nonzero(naive_ids[:common] != lazy_ids[:common])[0]
    out["lazy_vs_naive_first_difference"] = int(diff[0]) if diff.size else None
    log(f"  LazyGreedy vs NaiveGreedy over the first {common} steps: first difference at "
        f"{'none' if not diff.size else int(diff[0])}")
    log(f"  NaiveGreedy ids[:{common}] = {naive_ids[:common].tolist()}")
    log(f"  LazyGreedy  ids[:{common}] = {lazy_ids[:common].tolist()}")
    out["naive_ids"] = naive_ids.tolist()
    out["lazy_ids"] = lazy_ids.tolist()
    return out, fn, runs["NaiveGreedy"][0]


def phase_times(torch, args, fn, naive_res, main: dict) -> list[dict]:
    from repro_torch.core import FacilityLocation, FLState
    from repro_torch.kernels import ops
    from repro_torch.kernels.fl_gains import fl_gains_at_plain, fl_gains_plain
    from repro_torch.kernels.similarity_kernel import _normalize, similarity_plain

    log("== phase 5: times at the main path's shapes (CUDA events)")
    n, d = args.n, args.d
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    x = torch.as_tensor(gaussian_mixture(args.seed, n, d), device="cuda")
    reps = args.reps
    sim = fn.sim
    launches = main["launches"]

    # similarity: the main path's cosine; library = one addmm on normalised rows
    sim_ms = cuda_ms(torch, lambda: ops.similarity(x, x, "cosine"), max(2, reps // 10), warmup=1)
    plain_ms = cuda_ms(torch, lambda: similarity_plain(x, x, "cosine"), max(2, reps // 10), warmup=1)
    xn = _normalize(x)
    half = torch.full((1, 1), 0.5, device="cuda")
    lib_ms = cuda_ms(torch, lambda: torch.addmm(half, xn, xn.T, beta=1.0, alpha=0.5),
                     max(2, reps // 10), warmup=1)
    dot_ms = cuda_ms(torch, lambda: ops.similarity(x, x, "dot"), max(2, reps // 10), warmup=1)
    matmul_ms = cuda_ms(torch, lambda: torch.matmul(x, x.T), max(2, reps // 10), warmup=1)
    del xn
    b_ms, b_by = bound(2.0 * n * n * d, 4.0 * (2 * n * d + n * n))
    rows = [{
        "name": "similarity", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/similarity.cu",
        "replaces": "src/repro/kernels/similarity_kernel.py:73",
        "shape": f"({n},{d})x({n},{d})->({n},{n}) cosine",
        "launches": launches["similarity"], "launches_on_path": launches["similarity"],
        "max_abs_err": main["S_max_abs_err"],
        "ms": sim_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms, "library_call": "torch.addmm(0.5, xn, xn.T, alpha=0.5)",
        "dot_ms": dot_ms, "dot_library_ms": matmul_ms,
    }]
    log(f"  similarity cosine {n}x{n}x{d}: kernel {sim_ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"addmm {lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}); dot: kernel {dot_ms:.3f} ms, "
        f"matmul {matmul_ms:.3f} ms")

    # fl_gains at u = n: curmax of the naive selection, a state the path reaches
    order = naive_res.order[naive_res.order >= 0].long()
    cm = sim[:, order].amax(dim=1).contiguous()
    full = ops.fl_gains(sim, cm)
    fl_err = check_close(f"fl_gains ({n},{n}) vs fl_gains_plain", full, fl_gains_plain(sim, cm), *FL_TOL)
    fl_ms = cuda_ms(torch, lambda: ops.fl_gains(sim, cm), reps)
    fl_plain_ms = cuda_ms(torch, lambda: fl_gains_plain(sim, cm), max(2, reps // 10), warmup=1)
    fn_plain, state = FacilityLocation(sim=sim, n=n, use_kernel=False), FLState(cm, n)
    torch_ms = cuda_ms(torch, lambda: fn_plain.gains(state), max(2, reps // 10), warmup=1)
    b_ms, b_by = bound(3.0 * n * n, 4.0 * (n * n + 2 * n))
    rows.append({
        "name": "fl_gains", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fl_gains.cu",
        "replaces": "src/repro/kernels/fl_gains.py:51",
        "shape": f"sim ({n},{n}), curmax ({n},) -> ({n},)",
        "launches": launches["fl_gains"], "launches_on_path": launches["fl_gains"],
        "max_abs_err": fl_err, "bit_equal_to_plain": bool(torch.equal(full, fl_gains_plain(sim, cm))),
        "ms": fl_ms, "plain_ms": fl_plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "torch_backend_ms": torch_ms,
    })
    log(f"  fl_gains {n}x{n}: kernel {fl_ms:.3f} ms, plain {fl_plain_ms:.3f} ms, torch backend "
        f"expression {torch_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")

    # fl_gains_at: a fresh random index set per launch, so L2 holds no column
    at = {}
    for k in (8, 512):
        sets = [torch.randperm(n, generator=gen, device="cuda")[:k].to(torch.int32) for _ in range(64)]
        got = ops.fl_gains_at(sim, cm, sets[0])
        err = check_close(f"fl_gains_at ({n},{n}) k={k} vs fl_gains_at_plain", got,
                          fl_gains_at_plain(sim, cm, sets[0]), *FL_TOL)
        if not torch.equal(got, full[sets[0].long()]):
            raise AssertionError(f"fl_gains_at k={k}: not bit-equal to fl_gains")
        it = itertools.cycle(sets)
        k_ms = cuda_ms(torch, lambda: ops.fl_gains_at(sim, cm, next(it)), reps)
        k_plain = cuda_ms(torch, lambda: fl_gains_at_plain(sim, cm, next(it)),
                          max(2, reps // 10), warmup=1)
        kb_ms, kb_by = bound(3.0 * n * k, 4.0 * (n * k + n + 3 * k))
        at[k] = {"ms": k_ms, "plain_ms": k_plain, "bound_ms": kb_ms, "bound_by": kb_by,
                 "max_abs_err": err}
        log(f"  fl_gains_at {n}x{n} k={k}: kernel {k_ms:.4f} ms, plain {k_plain:.3f} ms, "
            f"bound {kb_ms:.5f} ms ({kb_by}); bit-equal to fl_gains")
    rows.append({
        "name": "fl_gains_at", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fl_gains.cu",
        "replaces": "src/repro/kernels/fl_gains.py:93",
        "shape": f"sim ({n},{n}), curmax ({n},), idx (8,) -> (8,)",
        "launches": launches["fl_gains_at"], "launches_on_path": launches["fl_gains_at"],
        "max_abs_err": at[8]["max_abs_err"],
        "ms": at[8]["ms"], "plain_ms": at[8]["plain_ms"], "bound_ms": at[8]["bound_ms"],
        "bound_by": at[8]["bound_by"], "library_ms": None,
        "k512": at[512],
    })

    # the KERNEL_MIN_N gate: kernel vs the torch backend's sweep at n = 4096
    g_n = 4096
    gsim = torch.rand((g_n, g_n), generator=gen, device="cuda")
    gcm = 0.8 * torch.rand((g_n,), generator=gen, device="cuda")
    gate_k = cuda_ms(torch, lambda: ops.fl_gains(gsim, gcm), reps)
    gate_t = cuda_ms(torch, lambda: torch.clamp(gsim - gcm[:, None], min=0.0).sum(dim=0), reps)
    gate_p = cuda_ms(torch, lambda: fl_gains_plain(gsim, gcm), max(2, reps // 10))
    log(f"  KERNEL_MIN_N gate, fl_gains at u=n={g_n}: kernel {gate_k:.4f} ms, torch backend "
        f"expression {gate_t:.4f} ms, fl_gains_plain {gate_p:.3f} ms")
    main["kernel_min_n_gate"] = {"n": g_n, "kernel_ms": gate_k, "torch_ms": gate_t,
                                 "plain_ms": gate_p}
    return rows


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n", type=int, default=50_000)
    p.add_argument("--d", type=int, default=512)
    p.add_argument("--naive-budget", type=int, default=500)
    p.add_argument("--lazy-budget", type=int, default=5_000)
    p.add_argument("--reps", type=int, default=50, help="timed launches per kernel")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch/ not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # the plain versions run in full fp32 on the card: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    device = phase_device(torch)
    build = phase_build()
    phase_kernels(torch, args.seed)
    main_out, fn, naive_res = phase_main(torch, args)
    kernels = phase_times(torch, args, fn, naive_res, main_out)
    record = {"device": device, "build": {k: build[k] for k in ("seconds", "cached")},
              "main": main_out, "kernels": kernels,
              "seconds": time.perf_counter() - t_start}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(f"total {record['seconds']:.1f} s; details in {OUT_DIR / 'chip_smoke.json'}")
    log(device["nvidia_smi"])
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                             "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
