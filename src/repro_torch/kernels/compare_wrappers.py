"""Time the gathered FL and FB sweeps through their public wrappers
(``repro_torch.kernels.ops``), host cost included, on this checkout and on
other checkouts' ``src/`` directories, in turns on one card:

    python src/repro_torch/kernels/compare_wrappers.py [--crossover] [--layouts] \
        [--turns T] [--fl-only] [OTHER_SRC ...]

Each tree runs in a process of its own (its own package and kernel build),
in the order this, B, C, C, B, this, ``--turns`` times over, so a drift of
clock or power falls on all alike.  A process, with ``--seed`` 0 as
``chip_smoke.py``:

- builds phase 4's dense path (n = 50,000, d = 512, cosine S from the
  Gaussian mixture) and runs its LazyGreedy 5,000 on the CUDA backend,
  counting ``fl_gains_at``'s launches by width k; records ids, gains,
  ``n_evals`` and f(A);
- times ``fl_gains`` (the full sweep) and ``fl_gains_at`` at every width
  that run launched, on fresh random index sets, with int64 ids (the
  engine's) and int32 ids, with CUDA events;
- measures the host's cost of one ``fl_gains_at`` call at k = 8 with int64
  ids (``chip_smoke.host_us``: runs of 200 calls with no synchronisation,
  on a host clock), and the parts such a call is made of;
- builds phase 8 (f)'s FeatureBased (relu of the 2^20-row mixture drawn on
  the card, sqrt) and runs its LazyGreedy 1,000 the same way, counting and
  timing ``fb_gains_at`` by width, and times ``fb_gains`` (sqrt, log,
  inverse) at the state of its first 100 picks;
- with ``--fl-only``, keeps the FL LazyGreedy, the full sweep's time and
  the host cost, and leaves out the times by width and FB;
- with ``--crossover`` (this tree only), times ``fl_gains_at`` with the
  crossover forced off and on (``fl_gains.sweeps_every_column``) at widths
  around it, both bit-equal;
- with ``--layouts`` (this tree only), times ``fl_gains_at`` below the
  crossover with ``fl_gains.CLUSTERS`` (the gathered kernel's cluster count
  at wide k) at 8, 16 and 64.

Every gathered output is held bit-equal to the full sweep; across trees the
LazyGreedy ids, gains, ``n_evals`` and f(A) must be equal, and so must the
outputs at fixed index sets.  Prints one JSON line per process, then a
summary line of each number's median and its (min, max) spread by tree;
exits non-zero on any difference.  Run it on the
card; all numbers are the card's (``nvidia-smi`` name and power limit in
the record).  The timing helpers, the mixtures and the width counter are
``chip_smoke.py``'s, imported from this checkout's root.
"""
from __future__ import annotations

import argparse
import collections
import hashlib
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()
THIS_SRC = HERE.parents[2]  # src/ of this checkout
# chip_smoke.py's helpers; appended, so the tree under test's src/ stays first
sys.path.append(str(HERE.parents[3]))
from chip_smoke import (  # noqa: E402
    HOST_BATCHES, HOST_CALLS, counting_widths, cuda_ms, gaussian_mixture, gaussian_mixture_cuda,
    host_us,
)

N, D, LAZY = 50_000, 512, 5_000  # chip_smoke.py phase 4
FB_N, FB_LAZY, FB_STATE = 1 << 20, 1_000, 100  # phase 8 (f)
REPS = 10
CROSSOVER_K = (1024, 2048, 2176, 2304, 2432, 2560, 3072, 4096)
LAYOUT_K, LAYOUT_CLUSTERS = (8, 64, 256, 512, 1024, 2048), (8, 16, 64)


def _digest(t) -> str:
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def _lazy(torch, ops, spec_fn, budget: int, name: str) -> dict:
    from repro_torch.core import SelectionSpec, solve

    widths = collections.Counter()
    fn = counting_widths(ops, name, 2 if name == "fl_gains_at" else 3, widths)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(SelectionSpec(spec_fn, budget, "LazyGreedy"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        setattr(ops, name, fn)
    return {"wall_s": wall, "n_evals": int(res.n_evals), "value": float(res.value),
            "ids": _digest(res.order), "gains": _digest(res.gains),
            "picks": res.order[res.order >= 0].tolist(), "widths": dict(sorted(widths.items()))}


def _sets(torch, gen, n: int, k: int, count: int, dtype):
    return [torch.randperm(n, generator=gen, device="cuda")[:k].to(dtype) for _ in range(count)]


def _by_width(torch, gen, widths: dict, n: int, call, full) -> dict:
    """ms per call at each width, int64 and int32 ids, fresh sets per call,
    each set's output held bit-equal to the full sweep."""
    out = {}
    for k in widths:
        row = {"launches": widths[k]}
        for dtype in (torch.int64, torch.int32):
            sets = _sets(torch, gen, n, k, 16, dtype)
            for s in sets[:2]:
                if not torch.equal(call(s), full[s.long()]):
                    raise AssertionError(f"k={k} {dtype}: not bit-equal to the full sweep")
            it = itertools.cycle(sets)
            row[str(dtype).removeprefix("torch.")] = cuda_ms(
                torch, lambda: call(next(it)), max(3, REPS if k <= 4096 else REPS // 3))
        out[k] = row
    return out


def _layouts(torch, gen, S, cm, full) -> dict:
    from repro_torch.kernels import fl_gains as flg
    from repro_torch.kernels import ops

    rule, clusters, out = flg.sweeps_every_column, flg.CLUSTERS, {}
    flg.sweeps_every_column = lambda k, n: False
    try:
        for c in LAYOUT_CLUSTERS:
            flg.CLUSTERS = c
            flg.sweep_layout.cache_clear()
            row = {}
            for k in LAYOUT_K:
                sets = _sets(torch, gen, N, k, 16, torch.int64)
                if not torch.equal(ops.fl_gains_at(S, cm, sets[0]), full[sets[0]]):
                    raise AssertionError(f"clusters {c} k={k}: not bit-equal")
                it = itertools.cycle(sets)
                row[k] = cuda_ms(torch, lambda: ops.fl_gains_at(S, cm, next(it)), REPS)
            out[c] = row
    finally:
        flg.sweeps_every_column, flg.CLUSTERS = rule, clusters
        flg.sweep_layout.cache_clear()
    return out


def measure(seed: int, crossover: bool, layouts: bool, fl_only: bool = False) -> dict:
    import torch

    from repro_torch.core import FacilityLocation, FeatureBased, create_kernel
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import fl_gains as flg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_build = time.perf_counter()
    _build.load()
    rec = {"src": str(Path(ops.__file__).resolve().parents[2]),
           "build_s": time.perf_counter() - t_build}
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)

    # ---- FL: phase 4's S and LazyGreedy
    S = create_kernel(gaussian_mixture(seed, N, D), metric="cosine", use_pallas=True)
    fn = FacilityLocation.from_kernel(S, use_kernel=None)
    lazy = _lazy(torch, ops, fn, LAZY, "fl_gains_at")
    cm = S[:, torch.tensor(lazy["picks"][:500], device="cuda")].amax(dim=1).contiguous()
    full = ops.fl_gains(S, cm)
    fl = {"lazy": {k: v for k, v in lazy.items() if k != "picks"},
          "fl_gains_ms": cuda_ms(torch, lambda: ops.fl_gains(S, cm), 2 * REPS)}
    if not fl_only:
        fl["by_width"] = _by_width(torch, gen, lazy["widths"], N,
                                   lambda s: ops.fl_gains_at(S, cm, s), full)
    fixed = _sets(torch, torch.Generator(device="cuda").manual_seed(seed + 2), N, 512, 1,
                  torch.int64)[0]
    fl["out_at_fixed"] = _digest(ops.fl_gains_at(S, cm, fixed))
    fl["out_full"] = _digest(full)

    # ---- host cost of one call at k = 8 (int64 ids) and its parts
    idx8 = _sets(torch, gen, N, 8, 1, torch.int64)[0]
    before = ops.LAUNCHES["fl_gains_at"]
    parts = {"call": host_us(torch, lambda: ops.fl_gains_at(S, cm, idx8))}
    rec["launches_per_call"] = ((ops.LAUNCHES["fl_gains_at"] - before)
                               / (1 + HOST_BATCHES * HOST_CALLS))
    dev = S.device
    parts["checks"] = host_us(torch, lambda: (ops._check_fl(S, cm), ops._check_idx(idx8, S)))
    # the launcher alone, with the ids its tree takes (a tree without the
    # crossover rule takes int32 ids only)
    native = idx8 if hasattr(flg, "sweeps_every_column") else idx8.to(torch.int32)
    parts["launcher"] = host_us(torch, lambda: flg.fl_gains_at_cuda(S, cm, native))
    parts["load"] = host_us(torch, _build.load)
    parts["current_stream"] = host_us(torch, lambda: torch.cuda.current_stream(dev).cuda_stream)
    parts["raw_stream"] = host_us(torch, lambda: torch._C._cuda_getCurrentRawStream(dev.index))
    parts["cast_int32"] = host_us(torch, lambda: idx8.to(torch.int32).contiguous())
    parts["empty"] = host_us(torch, lambda: torch.empty((8,), dtype=torch.float32, device=dev))
    parts["data_ptr_x4"] = host_us(
        torch, lambda: (S.data_ptr(), cm.data_ptr(), idx8.data_ptr(), S.stride(0)))
    fl["host_us"] = parts

    if crossover:
        rule, cross = flg.sweeps_every_column, {}
        try:
            for k in CROSSOVER_K:
                sets = _sets(torch, gen, N, k, 8, torch.int64)
                row = {}
                for forced in (False, True):
                    flg.sweeps_every_column = lambda k_, n_, f=forced: f
                    if not torch.equal(ops.fl_gains_at(S, cm, sets[0]), full[sets[0]]):
                        raise AssertionError(f"crossover k={k} forced {forced}: not bit-equal")
                    it = itertools.cycle(sets)
                    row["full_sweep" if forced else "gather"] = cuda_ms(
                        torch, lambda: ops.fl_gains_at(S, cm, next(it)), 5)
                cross[k] = row
        finally:
            flg.sweeps_every_column = rule
        fl["crossover"] = cross
    if layouts:
        fl["layouts"] = _layouts(torch, gen, S, cm, full)
    rec["fl"] = fl
    del S, fn, full, cm
    if fl_only:
        return rec

    # ---- FB: phase 8 (f)'s FeatureBased and LazyGreedy
    feats = torch.relu(gaussian_mixture_cuda(torch, seed, FB_N, D))
    fb = FeatureBased.from_features(feats, concave="sqrt", use_kernel=True)
    lazy = _lazy(torch, ops, fb, FB_LAZY, "fb_gains_at")
    state = fb.init_state()
    for j in lazy["picks"][:FB_STATE]:
        state = fb.update(state, j)
    fbr = {"lazy": {k: v for k, v in lazy.items() if k != "picks"}}
    fbr["fb_gains_ms"] = {c: cuda_ms(torch, lambda c=c: ops.fb_gains(fb.feats, state.acc, fb.w, c),
                                       2 * REPS) for c in ("sqrt", "log", "inverse")}
    full = ops.fb_gains(fb.feats, state.acc, fb.w, "sqrt")
    fbr["by_width"] = _by_width(torch, gen, lazy["widths"], FB_N,
                                lambda s: ops.fb_gains_at(fb.feats, state.acc, fb.w, s), full)
    idx8 = _sets(torch, gen, FB_N, 8, 1, torch.int64)[0]
    fbr["host_us"] = {"call": host_us(
        torch, lambda: ops.fb_gains_at(fb.feats, state.acc, fb.w, idx8))}
    fixed = _sets(torch, torch.Generator(device="cuda").manual_seed(seed + 2), FB_N, 512, 1,
                  torch.int64)[0]
    fbr["out_at_fixed"] = _digest(ops.fb_gains_at(fb.feats, state.acc, fb.w, fixed))
    fbr["out_full"] = _digest(full)
    rec["fb"] = fbr
    return rec


def _flatten(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("other_src", type=Path, nargs="*", help="other checkouts' src/ directories")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--crossover", action="store_true",
                   help="this tree: time fl_gains_at with the crossover forced off and on")
    p.add_argument("--layouts", action="store_true",
                   help="this tree: time fl_gains_at at several cluster counts")
    p.add_argument("--turns", type=int, default=1,
                   help="times over the order this, B, .., B, this")
    p.add_argument("--fl-only", action="store_true",
                   help="the FL LazyGreedy, full sweep and host cost only")
    p.add_argument("--measure", type=Path, help=argparse.SUPPRESS)  # one tree, in this process
    args = p.parse_args(argv)
    if args.measure is not None:
        print(json.dumps(measure(args.seed, args.crossover, args.layouts, args.fl_only)),
              flush=True)
        return 0

    trees = [THIS_SRC] + [s.resolve() for s in args.other_src]
    order = args.turns * (trees + list(reversed(trees)) if len(trees) > 1 else trees)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    runs = collections.defaultdict(list)
    for src in order:
        # this file's measure(), with the tree's package first on the path
        # (the other tree's package may predate this script)
        cmd = [sys.executable, "-c",
               "import sys, runpy; sys.path.insert(0, sys.argv[1]); "
               f"m = runpy.run_path({str(HERE)!r}); sys.exit(m['main'](sys.argv[2:]))",
               str(src), "--measure", str(src), "--seed", str(args.seed)]
        for flag in ("crossover", "layouts"):
            if getattr(args, flag) and src == THIS_SRC:
                cmd.append("--" + flag)
        if args.fl_only:
            cmd.append("--fl-only")
        proc = subprocess.run(cmd, capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"compare_wrappers: {src} failed ({proc.returncode})", file=sys.stderr)
            return 1
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)
        runs[str(src)].append(rec)

    ok = True
    same = ("fl.lazy.ids", "fl.lazy.gains", "fl.lazy.n_evals", "fl.lazy.value", "fl.out_at_fixed",
            "fl.out_full", "fb.lazy.ids", "fb.lazy.gains", "fb.lazy.n_evals", "fb.lazy.value",
            "fb.out_at_fixed", "fb.out_full")
    flat = {src: [_flatten(r) for r in recs] for src, recs in runs.items()}
    for key in same:
        values = {json.dumps(f.get(key)) for recs in flat.values() for f in recs}
        if len(values) != 1:
            ok = False
            print(f"compare_wrappers: {key} differs across runs: {sorted(values)}", file=sys.stderr)
    summary = {"card": gpu, "order": [str(s) for s in order], "same": ok, "median": {},
               "spread": {}}
    for src, recs in flat.items():
        med, spread = {}, {}
        for key in recs[0]:
            vals = [r.get(key) for r in recs]
            if all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in vals):
                med[key], spread[key] = statistics.median(vals), (min(vals), max(vals))
        summary["median"][src], summary["spread"][src] = med, spread
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
