"""The plain reference, and the comparison that decides ``correct``.

Plain PyTorch, independent of the program: it imports neither ``jax``, nor
the JAX package, nor anything of ``repro_torch``.  It works every similarity
and every greedy state out again from the features the harness hands to
both sides, in float64, and reads the program's answers only to judge them.

Facility Location (Submodlib's definition): f(A) = sum_i max_{j in A} S_ij
over the rows i of the ground set, with S the similarity of the features
under ``metric``, as the port documents it: ``cosine`` is 0.5 * (1 + cos),
shifted into [0, 1]; ``euclidean`` is 1 / (1 + ||x_i - x_j||).  Greedy
takes, at each step, the candidate of largest gain f(j | A), the first
index on ties.

The comparison follows the program's own picks (as a served model's check
follows its served tokens): at each step t it works out the gain of every
candidate given the program's first t - 1 picks, and reads these numbers,
each the largest over the steps of the answers judged:

- ``gain_err``: |the program's gain - the reference's gain of the program's
  pick| / the step's best gain;
- ``pick_regret``: (the step's best gain - the gain of the program's pick) /
  the step's best gain;
- ``sim_err``: the largest absolute error of sampled rows of the program's
  S off its diagonal, against S worked out from the features;
- ``diag_err``: the same on the diagonal (each item against itself).

A pick out of range, a pick taken twice or an answer short of its budget
while gains are left reads 1 or more.  The control is this reference in the
program's place, one precision step below the configurations' fp32 in each
part: its products in TF32 (:func:`similarity` with ``tf32=True``) and,
where the program holds S, S held in bfloat16 for the sweeps
(:func:`control`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

F64 = torch.float64
ROW_BLOCK = 2048  # rows of S worked out at once: (2048, 50,000) float64 is 0.8 GB


@dataclasses.dataclass
class Answer:
    """One answer of the program, and what it was asked: the ground set's
    features (rows = the represented set = the candidates), the metric, the
    budget; the picks and gains in pick order; sampled rows of its S."""

    x: torch.Tensor
    metric: str
    budget: int
    ids: list
    gains: list
    sim_rows: torch.Tensor | None = None  # (k,) row indices
    sim_values: torch.Tensor | None = None  # (k, n) the program's S at those rows


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32's 10 stored mantissa bits, to nearest even:
    what a tensor core reads of an fp32 operand."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def _matmul_precision(tf32: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _product(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    """a @ b.T in a's dtype; with ``tf32`` the operands are TF32 (the card's
    tensor cores, or the rounding itself on a CPU) and the sums fp32."""
    if not tf32:
        with _matmul_precision(False):
            return a @ b.T
    if a.is_cuda:
        with _matmul_precision(True):
            return a @ b.T
    return round_tf32(a) @ round_tf32(b).T


def similarity(x: torch.Tensor, y: torch.Tensor, metric: str, dtype=F64,
               tf32: bool = False) -> torch.Tensor:
    """(a, d), (b, d) -> (a, b) similarity in ``dtype``."""
    x, y = x.to(dtype), y.to(dtype)
    if metric == "cosine":
        xn = x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)
        yn = y / y.norm(dim=1, keepdim=True).clamp_min(1e-12)
        return 0.5 * (1.0 + _product(xn, yn, tf32))
    if metric == "euclidean":
        d2 = (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :] - 2.0 * _product(x, y, tf32)
        return 1.0 / (1.0 + d2.clamp_min(0.0).sqrt())
    raise ValueError(f"the reference has no metric {metric!r}")


def _sum_rows(rows_of, idx, fn, out):
    """out += sum over the rows ``idx`` (in blocks) of fn(S[rows], rows)."""
    for lo in range(0, idx.numel(), ROW_BLOCK):
        blk = idx[lo : lo + ROW_BLOCK]
        out += fn(rows_of(blk), blk).sum(0)
    return out


def teacher_forced(x: torch.Tensor, metric: str, picks: list) -> tuple[list, list]:
    """For each step t of ``picks``: the float64 gain of picks[t] and the best
    gain over the candidates not yet picked, both given picks[:t], over S
    worked out from ``x``.  One more step than ``picks`` is read, so that a
    short answer can be judged.

    The gains are kept for every candidate and moved by the rows whose
    curmax a pick raises, the only rows whose terms change."""
    n = x.shape[0]
    dev = x.device

    def rows_of(idx):
        return similarity(x[idx], x, metric)

    gains = _sum_rows(rows_of, torch.arange(n, device=dev), lambda s, _: s,
                      torch.zeros(n, dtype=F64, device=dev))
    cur = torch.zeros(n, dtype=F64, device=dev)
    taken = torch.zeros(n, dtype=torch.bool, device=dev)
    got, best = [], []
    for t in range(len(picks) + 1):
        free = torch.where(taken, -math.inf, gains)
        best.append(float(free.max()))
        if t == len(picks):
            break
        p = int(picks[t])
        if not 0 <= p < n:
            got.append(-math.inf)
            continue
        got.append(0.0 if taken[p] else float(gains[p]))
        taken[p] = True
        col = similarity(x, x[p : p + 1], metric)[:, 0]
        new = torch.maximum(cur, col)
        moved = torch.nonzero(new > cur)[:, 0]

        def delta(s, blk, new=new, cur=cur):
            return (s - new[blk, None]).clamp_min(0.0) - (s - cur[blk, None]).clamp_min(0.0)

        _sum_rows(rows_of, moved, delta, gains)
        cur = new
    return got, best


def greedy(S: torch.Tensor, budget: int) -> tuple[list, list]:
    """Plain dense FL greedy over the matrix S as it is held (fp32 or
    bfloat16), its gains summed in fp32 in row blocks each step, the first
    index on ties."""
    n = S.shape[1]
    dev = S.device
    cur = torch.zeros(S.shape[0], dtype=torch.float32, device=dev)
    taken = torch.zeros(n, dtype=torch.bool, device=dev)
    ids, gains = [], []
    for _ in range(budget):
        g = torch.zeros(n, dtype=torch.float32, device=dev)
        for lo in range(0, S.shape[0], ROW_BLOCK):
            blk = S[lo : lo + ROW_BLOCK].float()
            g += (blk - cur[lo : lo + ROW_BLOCK, None]).clamp_min(0.0).sum(0)
        g = torch.where(taken, -math.inf, g)
        j = int(torch.argmax(g))
        if not float(g[j]) > 0.0:
            break
        ids.append(j)
        gains.append(float(g[j]))
        taken[j] = True
        cur = torch.maximum(cur, S[:, j].float())
    return ids, gains


def control(x: torch.Tensor, metric: str, budget: int,
            held: bool) -> tuple[list, list, torch.Tensor]:
    """The control's answer in the program's place: S built with TF32
    products (fp32 values, in row blocks), swept as held in bfloat16 where
    ``held`` (the program keeps S) or as built (a matrix-free program).
    Returns its picks, its gains and the S it built."""
    n = x.shape[0]
    S = torch.cat([similarity(x[lo : lo + ROW_BLOCK], x, metric, torch.float32, tf32=True)
                   for lo in range(0, n, ROW_BLOCK)])
    ids, gains = greedy(S.to(torch.bfloat16) if held else S, budget)
    return ids, gains, S


SIM_NUMBERS = ("sim_err", "diag_err")


def judge(answers: list, names) -> dict:
    """The numbers ``names`` (of gain_err, pick_regret, sim_err, diag_err)
    over the answers: each the largest over answers and steps; inf where an
    answer cannot be read at all, or where no answer carries S."""
    out = {k: 0.0 for k in names}
    seen, sims = {}, 0
    for a in answers:
        if "gain_err" in out or "pick_regret" in out:
            key = (id(a.x), tuple(a.ids))
            if key not in seen:
                seen[key] = teacher_forced(a.x, a.metric, a.ids)
            g_err, regret = _step_errors(a, *seen[key])
            if "gain_err" in out:
                out["gain_err"] = max(out["gain_err"], g_err)
            if "pick_regret" in out:
                out["pick_regret"] = max(out["pick_regret"], regret)
        wanted = [k for k in SIM_NUMBERS if k in out]
        if wanted and a.sim_rows is not None:
            sims += 1
            for k, v in zip(SIM_NUMBERS, _sim_errs(a)):
                if k in out:
                    out[k] = max(out[k], v)
    for k in SIM_NUMBERS:
        if k in out and not sims:
            out[k] = math.inf
    return out


def _sim_errs(a: Answer) -> tuple[float, float]:
    """Largest absolute error of the program's sampled rows of S off and on
    its diagonal."""
    rows = a.sim_rows
    err = (a.sim_values.to(F64) - similarity(a.x[rows], a.x, a.metric)).abs()
    at = torch.arange(rows.numel(), device=err.device)
    diag = float(err[at, rows].max())
    err[at, rows] = 0.0
    off = float(err.max())
    return tuple(v if math.isfinite(v) else math.inf for v in (off, diag))


def _step_errors(a: Answer, got: list, best: list) -> tuple[float, float]:
    g_err = regret = 0.0
    if len(a.ids) != len(a.gains) or len(a.ids) > a.budget:
        return math.inf, math.inf
    for t, (g_prog, g_ref) in enumerate(zip(a.gains, got)):
        b = best[t]
        if not b > 0.0 or not math.isfinite(g_ref) or not math.isfinite(float(g_prog)):
            return math.inf, math.inf
        g_err = max(g_err, abs(float(g_prog) - g_ref) / b)
        regret = max(regret, (b - g_ref) / b)
    if len(a.ids) < a.budget and best[len(a.ids)] > 0.0:
        return math.inf, math.inf  # stopped while gains were left
    return g_err, regret
