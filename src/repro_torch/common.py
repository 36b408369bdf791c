"""Shared utilities: the NEG_INF sentinel, tie-breaking argmax, concave fns,
index masks, one-element indices, row padding, member views of a stacked
tensor, row blocks, row sums in a fixed order (and the FL column sums over
them) and device resolution."""
from __future__ import annotations

from typing import Callable

import torch

NEG_INF = -1e30


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds its tensors on: ``device`` when
    given, else the card.  Asking for CUDA where there is none raises; the
    port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for {str(dev)!r}: this entry point runs on the "
            "card unless called with device='cpu'"
        )
    return dev


def as_float_tensor(x, device=None) -> torch.Tensor:
    """fp32 tensor of ``x``.  A tensor keeps its device unless ``device``
    names another; anything else (numpy, lists) goes to
    :func:`resolve_device`."""
    if isinstance(x, torch.Tensor):
        dev = x.device if device is None else resolve_device(device)
        return x.to(device=dev, dtype=torch.float32)
    return torch.tensor(x, dtype=torch.float32, device=resolve_device(device))


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first occurrence of the maximum (paper's tie rule);
    ``torch.argmax`` returns the first maximal index on CPU and CUDA."""
    return torch.argmax(x)


def masked_first_argmax(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """First argmax over entries where ``valid`` is True."""
    return torch.argmax(torch.where(valid, x, NEG_INF))


CONCAVE_FNS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    # g(0) = 0 and concave increasing on x >= 0 — paper supports log / sqrt / inverse.
    "sqrt": lambda x: torch.sqrt(torch.clamp(x, min=0.0)),
    "log": lambda x: torch.log1p(torch.clamp(x, min=0.0)),
    "inverse": lambda x: x / (1.0 + torch.clamp(x, min=0.0)),
}


def get_concave(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name not in CONCAVE_FNS:
        raise ValueError(f"unknown concave fn {name!r}; choose from {sorted(CONCAVE_FNS)}")
    return CONCAVE_FNS[name]


def mask_from_indices(idxs, n: int, device=None) -> torch.Tensor:
    """(k,) int indices (possibly with -1 padding) -> (n,) bool mask on
    ``device`` (default: the device of ``idxs``, or the CPU for a list).
    Negative and out-of-range indices are dropped."""
    idxs = torch.as_tensor(idxs, dtype=torch.long)
    if device is not None:
        idxs = idxs.to(device)
    mask = torch.zeros((n,), dtype=torch.bool, device=idxs.device)
    mask[idxs[(idxs >= 0) & (idxs < n)]] = True
    return mask


def one_index(j, device) -> torch.Tensor:
    """``j`` (an int or a one-element tensor) as a (1,) int64 tensor on
    ``device``: indexing with a 0-d tensor would read it back to the host,
    a one-element index tensor does not."""
    return torch.as_tensor(j, device=device).reshape(1).to(torch.long)


def pad_rows(a: torch.Tensor, rows: int, value=0) -> torch.Tensor:
    """``a`` with its first axis padded to ``rows`` by ``value`` (``a``
    itself when it already has that many)."""
    if a.shape[0] == rows:
        return a
    out = a.new_full((rows,) + tuple(a.shape[1:]), value)
    out[: a.shape[0]] = a
    return out


def stacked_view(tensors) -> torch.Tensor | None:
    """The (B, ...) tensor of which ``tensors`` are the B members, as one
    view (no copy), or None when they are not such members: the same shape,
    strides and dtype, in one storage, at offsets that step by one stride.
    The batched engine hands its functions such member views of the tensors
    it stacked once, so a wave kernel can read them all in one launch."""
    t0 = tensors[0]
    if len(tensors) == 1:
        return t0[None]
    step = tensors[1].data_ptr() - t0.data_ptr()
    if step < 0 or step % t0.element_size():
        return None
    for b, t in enumerate(tensors):
        if (t.data_ptr() - t0.data_ptr() != b * step or t.shape != t0.shape
                or t.stride() != t0.stride() or t.dtype != t0.dtype):
            return None
    if t0.untyped_storage().data_ptr() != tensors[-1].untyped_storage().data_ptr():
        return None
    return t0.as_strided(
        (len(tensors),) + tuple(t0.shape), (step // t0.element_size(),) + t0.stride()
    )


ROW_BLOCK = 1 << 16  # rows per block of the coverage families' streamed torch paths


def map_row_blocks(fn: Callable[[torch.Tensor], torch.Tensor], mat: torch.Tensor,
                   rows: torch.Tensor | None = None) -> torch.Tensor:
    """``fn`` over blocks of at most :data:`ROW_BLOCK` rows of ``mat`` (all
    rows, or the rows ``rows``), concatenated: a torch path whose gains
    form (n, m) temporaries holds one (ROW_BLOCK, m) block of them at a
    time."""
    k = mat.shape[0] if rows is None else rows.shape[0]
    if k <= ROW_BLOCK:
        return fn(mat if rows is None else mat[rows])
    return torch.cat([
        fn(mat[lo : lo + ROW_BLOCK] if rows is None else mat[rows[lo : lo + ROW_BLOCK]])
        for lo in range(0, k, ROW_BLOCK)
    ])


# elements of one (rows, columns) temporary of :func:`relu_col_sums`
COL_BLOCK_ELEMS = 1 << 24


def relu_col_sums(sim: torch.Tensor, curmax: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(k,) ``sum_i max(sim[i, idx_j] - curmax_i, 0)`` for indices ``idx``
    >= 0, each column summed in :func:`row_sums_fixed`'s order, a block of
    columns at a time: a column's bits depend on its own values alone, not
    on which or how many columns are gathered with it, on the CPU and the
    card alike."""
    idx = idx.to(device=sim.device, dtype=torch.long)
    out = sim.new_empty(idx.shape)
    step = max(1, COL_BLOCK_ELEMS // max(sim.shape[0], 1))
    for lo in range(0, idx.numel(), step):
        cols = sim.index_select(1, idx[lo : lo + step])
        out[lo : lo + step] = row_sums_fixed(cols.sub_(curmax[:, None]).clamp_(min=0.0))
    return out


def row_sums_fixed(t: torch.Tensor) -> torch.Tensor:
    """(R, C) -> (C,): the sum of ``t``'s rows, in a fixed order.

    The rows are folded onto the first h, h the largest power of two below
    the count (row i += row h + i), until one is left: elementwise adds
    only, so a column's bits never depend on how many columns there are, and
    trailing zero rows add exact zeros.  ``torch.sum`` over rows picks its
    blocking from the column count too, on the CPU and the card alike, so a
    column summed inside a zero-padded matrix (a served wave's member) could
    part by ulps from the same column summed unpadded.  ``t`` is
    overwritten."""
    r = t.shape[0]
    if r == 0:
        return t.new_zeros(t.shape[1:])
    while r > 1:
        h = 1 << ((r - 1).bit_length() - 1)
        t[: r - h].add_(t[h:r])
        r = h
    return t[0].clone()
