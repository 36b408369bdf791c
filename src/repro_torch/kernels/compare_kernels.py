"""Time this checkout's kernels against the same kernels built from other
directories of kernel sources (an older checkout's
``src/repro_torch/kernels/csrc``), side by side on one card:

    python -m repro_torch.kernels.compare_kernels [--kernels NAME,...] OTHER_CSRC [OTHER_CSRC ...]

Every library is built with the same nvcc flags and loaded into one
process, and each is called through its own C signature: where a tree's
``dmin_gains``, ``gcmf_gains``, ``gc_gains`` or ``dsum_gains`` launch
function takes no compacted list (no ``nsel`` or ``blk``: sources older
than the mask compaction, ``csrc/select_cols.cu``, or than the
selected-columns sums), it is called without one.  At the dense path's shapes
(chip_smoke.py phases 4, 6 and 7: n = 50,000, d = 512), each kernel named
(``similarity``, dot and cosine, and dot at d = 130 on rows offset by one
row, which no 16-byte copy can take; ``fused_fl_sweep`` at phase 9 (i)'s
shape, u = 512 unit relu rows against n = 2^20, fp32 and bf16, in the
launcher's column slices; the dense pairwise full sweeps
``gc_gains``, ``dsum_gains``, ``dmin_gains`` on a random (n, n) matrix and
a mask of 500 ones, ``dmin_gains`` also at n / 4 ones, where it streams
every column, ``gc_gains_at`` at k = 8 and 512 on the same mask,
including the compaction where the tree has it; ``gcmf_gains`` and
``gcmf_gains_at`` at k = 8 and 512 on
cosine features with a mask of 100 ones, including the compaction) is
timed forward and back (this, B, C, C, B, this) in each of two rounds, ten
launches each with CUDA events, so a drift of clock or power falls on all
alike.  Each library's output must be the same after the timed launches as
before them.  Across libraries the outputs must be equal bit for bit,
except where a sum over the selected columns runs in another order than a
sum over every column, by design: gcmf's outputs are held to the
kernel-vs-plain bar (rtol 2e-5, atol 1e-4) across libraries, gc's and
dsum's to chip_smoke.py's dense bar (rtol 1e-5, atol 1e-5).  Prints the
kernels' ptxas lines, then one JSON line with every time; exits non-zero on
a mismatch.

The matrix-free FL sweeps: ``flmf_gains`` at phase 6's shapes (u = n =
50,000 cosine, and u = 512 represented rows against n = 2^20 for every
metric, on 16-byte aligned rows at d = 512 and on rows offset by one
element at d = 130), ``flmf_gains_at`` at k = 8 and 512 on the first and at
k = 512 on the second, all bit for bit across libraries.  The coverage
sweeps at phase 8's shape, n = 2^20, m = 1,000: ``sc_gains`` on a binary G
and covered with unit weights (integer sums, bit for bit across libraries
whatever their order) and with weights and a fractional covered (the
coverage bar, rtol 1e-5, atol 1e-5: the order is a layout's choice), and
``psc_gains``, bit for bit.
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
from repro_torch.kernels.flmf_gains import TILE_ROWS, column_slice
from repro_torch.kernels.gcmf_gains import slice_width
from repro_torch.kernels.select_cols import PREDICATES, scratch
from repro_torch.kernels.similarity_kernel import _METRIC_CODE, _normalize, inv_two_sigma_sq

N, D = 50_000, 512  # the dense path's shape (chip_smoke.py phase 4)
ODD_D = 130  # the misaligned similarity case: rows of 520 bytes
FUSED_U, FUSED_N = 512, 1 << 20  # phase 9 (i)'s fused sweep
N_SEL = 500  # selected items in the dense pairwise sweeps' mask (phase 7 (e)'s budget)
GC_SEL = 100  # selected items in the gcmf sweeps' mask (phase 6 (c)'s budget)
GC_TOL = (2e-5, 1e-4)  # gcmf across libraries: chip_smoke.py's MF_TOL for cosine
DENSE_TOL = (1e-5, 1e-5)  # gc and dsum across libraries: chip_smoke.py's DENSE_TOL
REPS, ROUNDS = 10, 2
MF_U, MF_N = 512, 1 << 20  # phase 6 (b)'s represented rows and candidates
COVER_M = 1000  # phase 8's concepts
COVER_TOL = (1e-5, 1e-5)  # sc with weights across libraries: chip_smoke.py's COVER_TOL
KERNELS = ("similarity", "fused_fl_sweep", "gc_gains", "gc_gains_at", "dsum_gains", "dmin_gains",
           "gcmf_gains", "gcmf_gains_at", "flmf_gains", "flmf_gains_at", "sc_gains", "psc_gains")
_P, _I64 = ctypes.c_void_p, ctypes.c_int64
# the C signatures of trees whose launch function takes no compacted list
# (no sel / nsel or sel / blk)
_WITHOUT_SEL = {
    "dmin_gains_launch": ([_P, _I64, _P, _P, _P, _P, _P], ctypes.c_int),
    "gcmf_gains_launch": (
        [_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_int, ctypes.c_float, _P, _P, _P],
        ctypes.c_int,
    ),
    "gc_gains_launch": ([_P, _I64, _P, _P, _P, _P, _I64, _P, _P], ctypes.c_int),
    "dsum_gains_launch": ([_P, _I64, _P, _P, _P], ctypes.c_int),
}


def _list_param(csrc: Path, fn: str) -> str | None:
    """How the C function ``fn`` of the sources ``csrc`` takes the selected
    columns: "nsel" (the caller compacts and passes the list and its
    count), "blk" (the launcher compacts into the caller's scratch) or None
    (it sums every column)."""
    for src in Path(csrc).glob("*.cu"):
        text = src.read_text()
        at = text.find(f'extern "C" int {fn}(')
        if at >= 0:
            params = text[at : text.index(")", at)]
            return next((p for p in ("nsel", "blk") if p in params), None)
    return None


def _library(csrc: Path, name: str, kernels) -> ctypes.CDLL:
    """Build ``csrc`` and bind the launch functions of ``kernels`` through
    the library's own signatures; ``lib.list_param[fn]`` says how its
    launch function ``fn`` takes the compacted list (see ``_list_param``)."""
    target = _build.BUILD_DIR / f"compare_{name}.so"
    for line in _build._compile(target, csrc):
        if any(k in line for k in kernels) and ("registers" in line or "spill" in line):
            print(f"{name}: {line}", file=sys.stderr)
    lib = ctypes.CDLL(str(target))
    lib.list_param = {fn: _list_param(csrc, fn) for fn in _WITHOUT_SEL}
    sigs = {**_build._SIGNATURES,
            **{fn: sig for fn, sig in _WITHOUT_SEL.items() if lib.list_param[fn] is None}}
    launches = {f"{k.removesuffix('_at')}_launch" for k in kernels}
    if any(lib.list_param.get(fn) == "nsel" for fn in launches):
        launches.add("select_cols_launch")
    for fn in launches:
        argtypes, restype = sigs[fn]
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def _compacted(lib, fn, mask, pred, stream):
    """The list arguments of ``lib``'s launch function ``fn`` for ``mask``:
    (error code, pointers, the scratch that holds them).  Where ``fn``
    takes the list and its count, the compaction runs here."""
    param = lib.list_param[fn]
    if param is None:
        return 0, [], None
    n = mask.shape[0]
    buf, sel, blk = scratch(n, "cuda")
    if param == "blk":  # the launcher compacts
        return 0, [sel, blk], buf
    rc = lib.select_cols_launch(mask.data_ptr(), n, PREDICATES[pred], sel, blk, stream)
    return rc, [sel, blk + 4 * (buf.shape[0] - n - 1)], buf  # the count: blk's last entry


def _cases(kernels, stream):
    """Yield (label, output shape, tolerance across libraries or None for
    bit equality, launch(lib, out) -> CUDA error code)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "similarity" in kernels:
        x = torch.randn((N, D), generator=gen, device="cuda")
        odd = torch.randn((N + 1, ODD_D), generator=gen, device="cuda")[1:]  # base 520 bytes in
        for metric, xm in (("dot", x), ("cosine", _normalize(x).contiguous()), ("dot", odd)):
            d = xm.shape[1]
            xx = (xm * xm).sum(1)
            label = f"similarity {metric}" + ("" if d == D else f" d={d} rows offset by one row")
            yield label, (N, N), None, lambda lib, out, xm=xm, xx=xx, metric=metric, d=d: (
                lib.similarity_launch(xm.data_ptr(), xm.data_ptr(), xx.data_ptr(), xx.data_ptr(),
                                      out.data_ptr(), N, N, d, _METRIC_CODE[metric],
                                      inv_two_sigma_sq(d, None), stream))
        del x, odd, xm, xx
    if "fused_fl_sweep" in kernels:
        yield from _fused_cases(stream, gen)
    if set(kernels) & {"gcmf_gains", "gcmf_gains_at"}:
        yield from _gcmf_cases(kernels, stream, gen)
    if set(kernels) & {"flmf_gains", "flmf_gains_at"}:
        yield from _flmf_cases(kernels, stream, gen)
    if set(kernels) & {"sc_gains", "psc_gains"}:
        yield from _cover_cases(kernels, stream, gen)
    if not set(kernels) & {"gc_gains", "gc_gains_at", "dsum_gains", "dmin_gains"}:
        return
    mat = torch.rand((N, N), generator=gen, device="cuda")
    mask = torch.zeros((N,), device="cuda")
    mask[torch.randperm(N, generator=gen, device="cuda")[:N_SEL]] = 1.0
    total = mat.sum(dim=0)
    lam = torch.tensor(0.4, device="cuda")
    count = torch.tensor(N_SEL, dtype=torch.int32, device="cuda")
    curmin = torch.tensor(0.05, device="cuda")

    def gc(lib, out, idx):
        rc, sel, _ = _compacted(lib, "gc_gains_launch", mask, "nonzero", stream)
        return rc or lib.gc_gains_launch(
            mat.data_ptr(), N, mask.data_ptr(), *sel, total.data_ptr(),
            lam.data_ptr(), None if idx is None else idx.data_ptr(), out.shape[0],
            out.data_ptr(), stream)

    if "gc_gains" in kernels:
        yield "gc_gains", (N,), DENSE_TOL, lambda lib, out: gc(lib, out, None)
    if "gc_gains_at" in kernels:
        for k in (8, 512):
            idx = torch.randperm(N, generator=gen, device="cuda")[:k].to(torch.int32)
            yield f"gc_gains_at k={k}", (k,), DENSE_TOL, lambda lib, out, idx=idx: gc(lib, out, idx)
    if "dsum_gains" in kernels:

        def dsum(lib, out):
            rc, sel, _ = _compacted(lib, "dsum_gains_launch", mask, "nonzero", stream)
            return rc or lib.dsum_gains_launch(mat.data_ptr(), N, mask.data_ptr(), *sel,
                                               out.data_ptr(), stream)

        yield "dsum_gains", (N,), DENSE_TOL, dsum
    if "dmin_gains" in kernels:
        wide = torch.zeros((N,), device="cuda")  # 8 |A| >= n: the stream branch
        wide[torch.randperm(N, generator=gen, device="cuda")[: N // 4]] = 1.0
        for label, m, cnt in (("dmin_gains", mask, count),
                              ("dmin_gains |A| = n/4", wide,
                               torch.tensor(N // 4, dtype=torch.int32, device="cuda"))):

            def dmin(lib, out, m=m, cnt=cnt):
                rc, sel, _ = _compacted(lib, "dmin_gains_launch", m, "positive", stream)
                return rc or lib.dmin_gains_launch(
                    mat.data_ptr(), N, m.data_ptr(), *sel,
                    cnt.data_ptr(), curmin.data_ptr(), out.data_ptr(), stream)

            yield label, (N,), None, dmin


def _fused_cases(stream, gen):
    """The fused sweep at phase 9 (i)'s shape, fp32 and bf16, in the
    launcher's column slices (kernels/fused_fl_sweep.py)."""
    y = torch.randn((FUSED_N, D), generator=gen, device="cuda").relu_()
    y /= torch.linalg.norm(y, dim=1, keepdim=True).clamp_(min=1e-12)
    x = y[:: FUSED_N // FUSED_U][:FUSED_U].contiguous()
    cm = 0.5 * torch.rand((FUSED_U,), generator=gen, device="cuda")
    nblocks = -(-FUSED_U // TILE_ROWS)
    cols = column_slice(nblocks)
    partial = torch.empty((nblocks, min(FUSED_N, cols)), device="cuda")

    def fused(lib, out, xk, yk):
        row_bytes = D * yk.element_size()
        for lo in range(0, FUSED_N, cols):
            hi = min(FUSED_N, lo + cols)
            rc = lib.fused_fl_sweep_launch(
                xk.data_ptr(), int(xk.dtype == torch.bfloat16), yk.data_ptr() + lo * row_bytes,
                int(yk.dtype == torch.bfloat16), cm.data_ptr(), FUSED_U, hi - lo, D,
                partial.data_ptr(), out[lo:hi].data_ptr(), stream)
            if rc:
                return rc
        return 0

    for key, xk, yk in (("fp32", x, y), ("bf16", x.bfloat16(), y.bfloat16())):
        yield (f"fused_fl_sweep {key}", (FUSED_N,), None,
               lambda lib, out, xk=xk, yk=yk: fused(lib, out, xk, yk))


def _gcmf_cases(kernels, stream, gen):
    """gcmf at phase 6 (c)'s shapes: cosine features, a mask of GC_SEL ones;
    the full sweep in the launcher's candidate slices, the gathered one at
    k = 8 and 512."""
    y = _normalize(torch.randn((N, D), generator=gen, device="cuda")).contiguous()
    yy = (y * y).sum(1)
    mask = torch.zeros((N,), device="cuda")
    mask[torch.randperm(N, generator=gen, device="cuda")[:GC_SEL]] = 1.0
    total = N * torch.rand((N,), generator=gen, device="cuda")
    diag = torch.rand((N,), generator=gen, device="cuda")
    lam = torch.tensor(0.4, device="cuda")
    nblocks = -(-N // TILE_ROWS)
    cols = slice_width(N, nblocks)
    partial = torch.empty((nblocks, cols), device="cuda")
    every = torch.arange(N, dtype=torch.int32, device="cuda")

    def gcmf(lib, out, idx):
        j = out.shape[0]
        if idx is None and j > cols:
            idx = every
        rc, sel, _ = _compacted(lib, "gcmf_gains_launch", mask, "nonzero", stream)
        if rc:
            return rc
        head = [y.data_ptr(), yy.data_ptr(), mask.data_ptr(), *sel]
        for lo in range(0, j, cols):
            hi = min(j, lo + cols)
            rc = lib.gcmf_gains_launch(
                *head, total.data_ptr(), diag.data_ptr(), lam.data_ptr(),
                None if idx is None else idx[lo:hi].data_ptr(), N, hi - lo, D,
                _METRIC_CODE["cosine"], inv_two_sigma_sq(D, None), partial.data_ptr(),
                out[lo:hi].data_ptr(), stream)
            if rc:
                return rc
        return 0

    if "gcmf_gains" in kernels:
        yield "gcmf_gains", (N,), GC_TOL, lambda lib, out: gcmf(lib, out, None)
    if "gcmf_gains_at" in kernels:
        for k in (8, 512):
            idx = torch.randperm(N, generator=gen, device="cuda")[:k].to(torch.int32)
            yield f"gcmf_gains_at k={k}", (k,), GC_TOL, lambda lib, out, idx=idx: gcmf(lib, out, idx)


def _offset(t):
    """A copy of ``t`` one element into a flat buffer: no row starts 16-byte
    aligned."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return view.copy_(t)


def _flmf_cases(kernels, stream, gen):
    """flmf at phase 6 (a)'s shape (u = n = N, cosine) and (b)'s (MF_U rows
    against MF_N candidates) for every metric, aligned at D and offset by one
    element at ODD_D; the full sweep in the launcher's column slices."""
    square = torch.randn((N, D), generator=gen, device="cuda")
    sets = [(f"u=n={N} d={D}", square, square, ("cosine",), False)]
    for d in (D, ODD_D):
        y = torch.randn((MF_N, d), generator=gen, device="cuda")
        sets.append((f"u={MF_U} n={MF_N} d={d}" + ("" if d == D else " rows offset by one"),
                     y[:: MF_N // MF_U][:MF_U].contiguous(), y, tuple(_METRIC_CODE), d != D))
    for name, x, y, metrics, offset in sets:
        (u, d), n = x.shape, y.shape[0]
        nblocks = -(-u // TILE_ROWS)
        cols = column_slice(nblocks)
        partial = torch.empty((nblocks, min(n, cols)), device="cuda")
        every = torch.arange(n, dtype=torch.int32, device="cuda")
        cm = 0.5 * torch.rand((u,), generator=gen, device="cuda")
        for metric in metrics:
            xm, ym = (_normalize(x), _normalize(y)) if metric == "cosine" else (x, y)
            xm, ym = (_offset(xm), _offset(ym)) if offset else (xm.contiguous(), ym.contiguous())
            xx, yy = (xm * xm).sum(1), (ym * ym).sum(1)

            def flmf(lib, out, idx, xm=xm, ym=ym, xx=xx, yy=yy, metric=metric, u=u, n=n, d=d,
                     cm=cm, cols=cols, partial=partial, every=every):
                k = out.shape[0]
                if idx is None and k > cols:
                    idx = every
                for lo in range(0, k, cols):
                    hi = min(k, lo + cols)
                    rc = lib.flmf_gains_launch(
                        xm.data_ptr(), ym.data_ptr(), xx.data_ptr(), yy.data_ptr(), cm.data_ptr(),
                        None if idx is None else idx[lo:hi].data_ptr(), u, n, hi - lo, d,
                        _METRIC_CODE[metric], inv_two_sigma_sq(d, None), partial.data_ptr(),
                        out[lo:hi].data_ptr(), stream)
                    if rc:
                        return rc
                return 0

            if "flmf_gains" in kernels:
                yield (f"flmf_gains {metric} {name}", (n,), None,
                       lambda lib, out, f=flmf: f(lib, out, None))
            if "flmf_gains_at" in kernels:
                for k in (8, 512) if u == n else (512,):
                    idx = torch.randperm(n, generator=gen, device="cuda")[:k].to(torch.int32)
                    yield (f"flmf_gains_at {metric} {name} k={k}", (k,), None,
                           lambda lib, out, f=flmf, idx=idx: f(lib, out, idx))


def _cover_cases(kernels, stream, gen):
    """sc and psc at phase 8's shape: n = MF_N items, m = COVER_M concepts."""
    n, m = MF_N, COVER_M
    if "sc_gains" in kernels:
        cover = (torch.rand((n, m), generator=gen, device="cuda") < 0.02).float()
        binary = (torch.rand((m,), generator=gen, device="cuda") < 0.3).float()
        ones = torch.ones((m,), device="cuda")
        frac = torch.rand((m,), generator=gen, device="cuda")
        w = 0.5 + torch.rand((m,), generator=gen, device="cuda")
        for label, covered, wk, tol in (("binary, unit w", binary, ones, None),
                                        ("fractional covered, weights", frac, w, COVER_TOL)):
            yield (f"sc_gains {label}", (n,), tol,
                   lambda lib, out, covered=covered, wk=wk: lib.sc_gains_launch(
                       cover.data_ptr(), n, m, covered.data_ptr(), wk.data_ptr(), out.data_ptr(),
                       stream))
    if "psc_gains" in kernels:
        probs = torch.rand((n, m), generator=gen, device="cuda")
        wm = torch.rand((m,), generator=gen, device="cuda")
        yield "psc_gains", (n,), None, lambda lib, out: lib.psc_gains_launch(
            probs.data_ptr(), n, m, wm.data_ptr(), out.data_ptr(), stream)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("other_csrc", type=Path, nargs="+")
    p.add_argument("--kernels", default="similarity",
                   help=f"comma-separated, of {','.join(KERNELS)} (default: similarity: dot "
                        "and cosine at 50,000 x 50,000 x 512 and dot at d = 130 on misaligned "
                        "rows; fused_fl_sweep: fp32 and bf16 at u = 512, n = 2^20, d = 512)")
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
    for label, shape, tol, launch in _cases(args.kernels, stream):
        outs = {k: torch.empty(shape, device="cuda") for k in libs}

        def run(which):
            rc = launch(libs[which], outs[which])
            if rc != 0:
                raise RuntimeError(f"{which} {label} kernel: CUDA error {rc}")

        times = {k: [] for k in libs}
        for which in libs:  # warm up (and fill every output)
            run(which)
        first = {k: v.clone() for k, v in outs.items()}
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
        repeatable = all(torch.equal(first[k], outs[k]) for k in libs)
        if tol is None:
            agree = all(torch.equal(outs["this"], out) for out in outs.values())
            held = {"bit_equal": agree}
        else:
            agree = all(torch.allclose(out, outs["this"], rtol=tol[0], atol=tol[1])
                        for out in outs.values())
            held = {"within_tol": agree, "max_abs_err": max(
                float((out.double() - outs["this"].double()).abs().max()) for out in outs.values())}
        ok &= repeatable and agree
        result["ms"][label] = {**times, "repeatable": repeatable, **held}
        print(f"{label}: {times} ms, repeatable {repeatable}, {held}", file=sys.stderr, flush=True)
        del outs, first
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
