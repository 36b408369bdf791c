"""Facility-location gain sweeps: the CUDA kernel's launchers and their plain
versions.

``gains_j = sum_i max(S[i, j] - curmax_i, 0)`` over a materialised (u, n)
similarity, for every column (``fl_gains``, the port of
``repro/kernels/fl_gains.py::fl_gains_pallas``) or for a gathered subset
``idx`` (``fl_gains_at``, the port of ``fl_gains_at_pallas``; slots with
idx < 0 return NEG_INF).

The summation order is fixed by u alone: the rows are cut into chunks of
:data:`ROWS_PER_CHUNK`, each chunk is summed row by row, and the chunk sums
are added in chunk order.  The kernel (``csrc/fl_gains.cu``) and the plain
versions below add in exactly that order, so

- the gathered sweep equals the full sweep bit for bit at the same index,
  whichever of the two implementations runs, and
- the kernel and its plain version agree bit for bit as well.

The first makes the crossover exact: a gathered sweep of k >=
:data:`FULL_SWEEP_RATIO` * n columns sweeps every column and gathers the k
slots from that (:func:`sweeps_every_column`).

S is fp32 or bf16, as the TPU kernel takes either: each element is widened
to fp32 as it is read (exact), and curmax, the sums and the gains are fp32,
so a bf16 sweep equals the fp32 sweep of ``sim.float()`` bit for bit.

Waves: every function here also takes B members of one shape at once, sim
(B, u, n) (each member's (u, n) contiguous, any stride between members, as
the batched engine stacks them), curmax (B, u) and idx (B, k), and returns
(B, n) or (B, k) in one launch.  Each member's row equals its own call bit
for bit, since the order above depends on u alone.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.common import NEG_INF
from repro_torch.kernels import _build

ROWS_PER_CHUNK = 128  # rows summed in order before the chunk sums are added
# csrc/fl_gains.cu's gathered launch: a cluster of CLUSTER blocks owns G
# columns; a block's thread sums one chunk of one column per window
CLUSTER = _build.FL_CLUSTER
MAX_THREADS = 256  # the kernel's launch bound
# G = ceil(k / CLUSTERS), at most MAX_THREADS: the widest blocks, the fewest
# clusters.  On the card (NVIDIA H100 80GB HBM3, 700.00 W; u = n = 50,000,
# compare_wrappers.py --layouts) 8 clusters beat 16 and 64 from k = 256 up
# and tie them below: 0.73 / 0.80 / 0.81-0.84 ms at k = 512, 1.95 / 2.89-2.91
# / 3.15-3.23 ms at k = 2,048 (two calls); a ninth cluster (k > 8 * 256)
# costs more than its share (2.34-2.58 ms at k = 2,176).
CLUSTERS = 8
# The crossover: a gathered sweep of k >= FULL_SWEEP_RATIO * n columns sweeps
# every column into an n-long scratch and gathers from it, as the full
# sweep's cost grows with n and the gather's with k.  On the card (NVIDIA
# H100 80GB HBM3, 700.00 W; u = n = 50,000, compare_wrappers.py
# --crossover, the gather forced on and off) the gather takes 1.96 ms at
# k = 2,048, 3.31 at 2,432, 3.34 at 2,560 and 4.19 at 3,072, the full
# sweep and gather 3.38-3.40 ms at every k.
FULL_SWEEP_RATIO = 0.05


def _column_sums(cols: torch.Tensor, curmax: torch.Tensor) -> torch.Tensor:
    """(u, k) fp32 or bf16 columns -> (k,) fp32 sums of relu(cols - curmax)
    in the kernel's order, each row of a chunk widened as it is added."""
    u, k = cols.shape
    r_len = ROWS_PER_CHUNK
    n_full, tail = divmod(u, r_len)
    part = curmax.new_zeros((n_full + (tail > 0), k))
    body = cols[: n_full * r_len].reshape(n_full, r_len, k)
    cm_body = curmax[: n_full * r_len].reshape(n_full, r_len, 1)
    for r in range(r_len):
        if n_full:
            part[:n_full] += torch.clamp(body[:, r].float() - cm_body[:, r], min=0.0)
        if r < tail:
            i = n_full * r_len + r
            part[n_full] += torch.clamp(cols[i].float() - curmax[i], min=0.0)
    out = curmax.new_zeros((k,))
    for c in range(part.shape[0]):
        out += part[c]
    return out


def fl_gains_plain(sim: torch.Tensor, curmax: torch.Tensor) -> torch.Tensor:
    """sim (u, n), curmax (u,) -> gains (n,) fp32, in plain PyTorch; a wave
    (B, u, n), (B, u) -> (B, n), member by member."""
    if sim.dim() == 3:
        return torch.stack([_column_sums(s, c) for s, c in zip(sim, curmax)])
    return _column_sums(sim, curmax)


def fl_gains_at_plain(sim: torch.Tensor, curmax: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gathered sweep in plain PyTorch: idx (k,) -> gains (k,); idx < 0 -> NEG_INF;
    a wave (B, u, n), (B, u), (B, k) -> (B, k), member by member."""
    if sim.dim() == 3:
        return torch.stack([fl_gains_at_plain(s, c, i) for s, c, i in zip(sim, curmax, idx)])
    idx = idx.to(device=sim.device, dtype=torch.long)
    cols = sim[:, torch.clamp(idx, 0, sim.shape[1] - 1)]
    return torch.where(idx < 0, NEG_INF, _column_sums(cols, curmax))


def sweeps_every_column(k: int, n: int) -> bool:
    """Whether a gathered sweep of k of n columns runs as the full sweep
    and a gather (the crossover, :data:`FULL_SWEEP_RATIO`)."""
    return k >= FULL_SWEEP_RATIO * n


@functools.lru_cache(maxsize=4096)
def sweep_layout(u: int, k: int) -> tuple[int, int, int, int, int]:
    """The gathered kernel's launch over k columns of u rows: (G columns
    per cluster, L chunk slots per block and window, threads per block,
    blocks, windows).  G = ceil(k / CLUSTERS), at most MAX_THREADS; a block
    holds G columns x L slots, one chunk per thread and window, with L as
    large as MAX_THREADS allows and no larger than the chunks need; the
    blocks run along the grid's x axis only, and the windows loop over the
    chunks, so no grid limit bounds u (the first design's grid.y did, at
    65,535 chunks)."""
    g = min(MAX_THREADS, -(-k // CLUSTERS))
    nchunks = -(-u // ROWS_PER_CHUNK)
    slots = max(1, min(-(-nchunks // CLUSTER), MAX_THREADS // g))
    threads = -(-g * slots // 32) * 32
    return g, slots, threads, -(-k // g) * CLUSTER, -(-nchunks // (CLUSTER * slots))


def _launch(sim: torch.Tensor, curmax: torch.Tensor, idx: torch.Tensor | None) -> torch.Tensor:
    """One launch of a sweep, or of a wave of them when sim is 3-D."""
    wave = sim.dim() == 3
    members = sim.shape[0] if wave else 1
    u, n = sim.shape[-2:]
    k = n if idx is None else idx.shape[-1]
    out = torch.empty((members, k) if wave else (k,), dtype=torch.float32, device=sim.device)
    if k == 0:
        return out
    if u == 0:  # no rows: every sum is empty
        out.zero_()
        if idx is not None:
            out.masked_fill_(idx < 0, NEG_INF)
        return out
    partial = full = None
    group = slots = threads = 0
    if idx is None or sweeps_every_column(k, n):
        # the full sweep's scratch, from the caching allocator: dropping it on
        # return is safe while the kernel runs, as the block is reused only by
        # later work on this stream
        partial = torch.empty(
            (members * -(-u // ROWS_PER_CHUNK), n), dtype=torch.float32, device=sim.device
        )
        if idx is not None:
            full = torch.empty((members, n), dtype=torch.float32, device=sim.device)
    else:
        group, slots, threads, _, _ = sweep_layout(u, k)
    lib = _build.load()
    ids = (None, 0) if idx is None else (idx.data_ptr(), idx.element_size())
    tail = (ROWS_PER_CHUNK, group, slots, threads, None if partial is None else partial.data_ptr(),
            None if full is None else full.data_ptr(), out.data_ptr(), _build.raw_stream(sim))
    if wave:  # member b at b * stride(0) of each tensor
        rc = lib.fl_gains_wave_launch(
            sim.data_ptr(), sim.stride(0), sim.stride(1), u, n, members, curmax.data_ptr(),
            curmax.stride(0), *ids, 0 if idx is None else idx.stride(0), k, *tail,
            sim.element_size(),
        )
    elif sim.dtype != torch.float32:  # a bf16 sweep: the wave entry with one member
        rc = lib.fl_gains_wave_launch(sim.data_ptr(), 0, sim.stride(0), u, n, 1, curmax.data_ptr(),
                                      0, *ids, 0, k, *tail, sim.element_size())
    else:
        rc = lib.fl_gains_launch(sim.data_ptr(), sim.stride(0), u, n, curmax.data_ptr(), *ids, k,
                                 *tail)
    _build.check(rc, "fl_gains kernel")
    return out


def fl_gains_cuda(sim: torch.Tensor, curmax: torch.Tensor) -> torch.Tensor:
    """Launch the full sweep, or a wave of them, on checked CUDA tensors
    (see ``ops.fl_gains``)."""
    return _launch(sim, curmax, None)


def fl_gains_at_cuda(sim: torch.Tensor, curmax: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the gathered sweep, or a wave of them; ``idx`` is an int32 or
    int64 CUDA tensor whose rows are contiguous, taken as it is."""
    return _launch(sim, curmax, idx)
