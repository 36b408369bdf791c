"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` file (including the shared ``csrc/*.cuh`` headers) is
compiled by its own ``nvcc`` process for ``sm_90a`` (all started together),
then linked into one shared library with a plain C interface.  Nothing
includes PyTorch's headers, so a build takes seconds.  The library lands in
``kernels/build/`` next to this file (the ``build/`` pattern in
``.gitignore`` keeps it out of git), named by a hash of the sources and
flags, so an edited source is never served by a stale build.  The build's
ptxas report (registers, shared memory, spills) lies beside it, so a
cached load reports the library it loads.

Importing this module builds nothing: :func:`load` runs on the first kernel
launch, so CPU-only machines import the whole package freely.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

from repro_torch.kernels.row_reduce import SEL_CHUNK as ROW_REDUCE_SEL_CHUNK
from repro_torch.kernels.row_reduce import THREADS as ROW_REDUCE_THREADS

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "build"  # listed in .gitignore via `build/`

SELECT_CHUNK = 4096  # mask elements per block of csrc/select_cols.cu's scan
FL_CLUSTER = 8  # blocks per thread-block cluster of csrc/fl_gains.cu's gathered sweep

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")  # the `a`: wgmma/setmaxnreg
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              # the row reductions' block width and staged chunk have one source,
              # their plain version
              f"-DROW_REDUCE_THREADS={ROW_REDUCE_THREADS}",
              f"-DROW_REDUCE_SEL_CHUNK={ROW_REDUCE_SEL_CHUNK}",
              # the compaction's chunk, by which kernels/select_cols.py sizes its scratch
              f"-DSELECT_CHUNK={SELECT_CHUNK}",
              # the gathered FL sweep's cluster, by which kernels/fl_gains.py lays it out
              f"-DFL_CLUSTER={FL_CLUSTER}")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_C_INT = ctypes.c_int
# C signatures of the exported launch functions (see csrc/*.cu); every
# pointer and the stream are c_void_p, or ctypes would cut them to 32 bits
_SIGNATURES = {
    "similarity_launch": (
        [_P, _P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_int, ctypes.c_float, _P],
        ctypes.c_int,
    ),
    "similarity_blocks_per_sm": ([ctypes.c_int, ctypes.c_int, _P], ctypes.c_int),
    "fl_gains_launch": (
        [_P, _I64, _I64, _I64, _P, _P, _C_INT, _I64, _I64, _C_INT, _C_INT, _C_INT, _P, _P, _P,
         _P],
        ctypes.c_int,
    ),
    "fl_gains_wave_launch": (
        [_P, _I64, _I64, _I64, _I64, _I64, _P, _I64, _P, _C_INT, _I64, _I64, _I64, _C_INT,
         _C_INT, _C_INT, _P, _P, _P, _P, _C_INT],
        ctypes.c_int,
    ),
    "flmf_gains_launch": (
        [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, ctypes.c_int, ctypes.c_float,
         _P, _P, _P],
        ctypes.c_int,
    ),
    "gcmf_gains_launch": (
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_int, ctypes.c_float,
         _P, _P, _P],
        ctypes.c_int,
    ),
    "gc_gains_launch": ([_P, _I64, _P, _P, _P, _P, _P, _P, _I64, _P, _P], ctypes.c_int),
    "dsum_gains_launch": ([_P, _I64, _P, _P, _P, _P, _P], ctypes.c_int),
    "dmin_gains_launch": ([_P, _I64, _P, _P, _P, _P, _P, _P, _P], ctypes.c_int),
    "select_cols_launch": ([_P, _I64, ctypes.c_int, _P, _P, _P], ctypes.c_int),
    "fb_gains_launch": (
        [_P, _I64, _I64, _P, _P, _C_INT, _P, _C_INT, _I64, _P, _P, _P], ctypes.c_int,
    ),
    "sc_gains_launch": ([_P, _I64, _I64, _P, _P, _P, _P], ctypes.c_int),
    "psc_gains_launch": ([_P, _I64, _I64, _P, _P, _P], ctypes.c_int),
    "fused_fl_sweep_launch": (
        [_P, ctypes.c_int, _P, ctypes.c_int, _P, _I64, _I64, _I64, _P, _P, _P], ctypes.c_int,
    ),
    "fused_fl_sweep_blocks_per_sm": (
        [ctypes.c_int, ctypes.c_int, ctypes.c_int, _P], ctypes.c_int,
    ),
    "repro_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# what the last load did: {"seconds", "cached", "library", "ptxas"}; "ptxas" is
# the loaded library's report, read back from beside it when it was cached
BUILD_INFO: dict = {}


class KernelError(RuntimeError):
    """A kernel failed to build or to launch: ``nvcc`` missing or failing, or
    a launch function returning a CUDA error.  The serving stack charges
    these, and only these, to a family's kernel breaker; wrong inputs raise
    ``TypeError`` / ``ValueError`` before any launch."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels are built on the machine with the card"
        )
    return found


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the .cuh headers too
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def _report_path(target: Path) -> Path:
    return target.with_suffix(".ptxas.txt")


def _compile(target: Path, csrc: Path = CSRC) -> list[str]:
    """nvcc every source of ``csrc`` in parallel, link into ``target`` and
    write the ptxas report lines (registers, shared memory, spills) beside
    it; returns them."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sorted(Path(csrc).glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        report, failed = [], []
        for src, _, p in procs:
            out, err = p.communicate()
            report += [f"{src.name}: {line}" for line in (out + err).splitlines() if line.strip()]
            if p.returncode != 0:
                failed.append(f"{src.name} (exit {p.returncode})")
        if failed:
            raise KernelError("nvcc failed for " + ", ".join(failed) + ":\n" + "\n".join(report))
        tmp_lib = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _ in procs)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise KernelError("nvcc link failed:\n" + link.stdout + link.stderr)
        tmp_report = Path(tmp) / _report_path(target).name
        tmp_report.write_text("".join(line + "\n" for line in report))
        # atomic, the report first: a concurrent loader that sees the library sees its report
        os.replace(tmp_report, _report_path(target))
        os.replace(tmp_lib, target)
    return report


def load() -> ctypes.CDLL:
    """The kernel library, built on first call (thread-safe, once per process;
    once it is loaded, a call takes no lock)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        target = _library_path()
        t0 = time.perf_counter()
        cached = target.exists()
        if not cached:
            report = _compile(target)
        elif _report_path(target).exists():
            report = _report_path(target).read_text().splitlines()
        else:  # a library built before its report was kept
            report = []
        lib = ctypes.CDLL(str(target))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        BUILD_INFO.update(
            seconds=time.perf_counter() - t0, cached=cached,
            library=str(target), ptxas=report,
        )
        _lib = lib
        return lib


def raw_stream(t) -> int:
    """The handle of the current CUDA stream on tensor ``t``'s device, as
    the launch functions take it (no ``torch.cuda.Stream`` object built)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def check(rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        msg = load().repro_cuda_error_string(rc).decode()
        raise KernelError(f"{what}: CUDA error {rc} ({msg})")
