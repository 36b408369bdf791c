"""Similarity sources: where a kernel-based function's sim(i, j) comes from.

The dense families (``FacilityLocation.from_kernel``) take a materialised
(|U|, n) similarity matrix, which caps n at what the card can hold.  A
source is the matrix-free replacement: an object that answers the queries
the memoized statistics need — a single column, a full gain sweep, a
gathered-subset sweep — without writing the n x n matrix.

- :class:`FeatureSource` — feature rows plus a metric (dot / cosine /
  euclidean / rbf, as ``kernels/similarity_kernel.py``).  Sweeps stream
  column tiles of :data:`TILE` candidates: each tile's similarity block is
  one ``torch.matmul`` plus the metric epilogue, so peak memory is
  O(n_rows * TILE) per step, O(n * d) overall.  Optional integer
  ``labels`` block-mask the similarity (``sim_ij = 0`` unless
  ``label_i == label_j``), the paper's §8 clustered decomposition, streamed.
- :class:`DenseSource` — the materialised matrix itself, so dense requests
  ride the same contract (and the dense FL-sweep kernels).
- :class:`KnnSource` — sparse k-NN similarity (each row's k neighbour ids
  and weights, :func:`knn_source`, :func:`knn_from_features`), the
  sparsified matrix never written.  Its column sums run over a fixed-order
  layout built once per source, never through atomics, so a sweep gives the
  same bits on every run.

The queries every source answers:

  col(j)                    (n_rows,)  similarity of every row to candidate j
  col_sums()                (n_cols,)  per-candidate column sums (GC ``total``)
  diag()                    (n_cols,)  sim(j, j) for square sources (GC diag)
  fl_gains(curmax)          (n_cols,)  sum_i max(sim_ij - curmax_i, 0)
  fl_gains_at(curmax, idx)  (k,)       gathered subset; idx < 0 -> NEG_INF
  masked_rowmax(mask)       (n_rows,)  max_{j: mask_j} sim_ij (empty -> 0)
  quad(mask)                scalar     m^T S m (square sources; GC evaluate)

Bit stability: the gathered sweep must equal the full sweep bit for bit at
the same index (the JAX package gets this from an explicit add-tree dot and
a fixed tile width).  Here every similarity block, the single column of
``col`` included, is a matmul against exactly TILE candidate rows (the
last tile and gathered sets zero-padded), and a matmul of one fixed shape
computes each output column independently of its position; the tests in
``tests/test_torch_sources.py`` hold that on the CPU and
``tests/test_torch_gpu.py`` on the card.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.common import NEG_INF, as_float_tensor, one_index, pad_rows, resolve_device
from repro_torch.kernels.similarity_kernel import (
    METRICS,
    TILE,
    _normalize,
    inv_two_sigma_sq,
    similarity_tiles,
)


@dataclasses.dataclass(frozen=True, eq=False)
class FeatureSource:
    """Features + metric: sim(i, j) = metric(x_i, y_j), computed on demand.

    ``x`` are the represented-set rows, ``y`` the candidate columns (the
    same tensor for symmetric sources — build with :func:`feature_source`).
    For cosine the rows arrive pre-normalised (a zero-norm row stays the
    zero vector and lands on the 0.5 midpoint after the [0, 1] shift);
    ``xx`` / ``yy`` are the squared norms of the rows as stored, feeding the
    euclidean / rbf epilogues.  ``row_labels`` / ``col_labels`` (integer,
    >= 0) switch on clustered block-masking.
    """

    x: torch.Tensor  # (n_rows, d) fp32
    y: torch.Tensor  # (n_cols, d) fp32
    xx: torch.Tensor  # (n_rows,) squared norms
    yy: torch.Tensor  # (n_cols,)
    row_labels: torch.Tensor | None
    col_labels: torch.Tensor | None
    metric: str
    rbf_sigma: float | None
    d: int
    n_rows: int
    n_cols: int

    @property
    def device(self) -> torch.device:
        return self.x.device

    # -- similarity blocks ---------------------------------------------------
    def _tiles(self):
        """Yield (lo, w, block): the similarity of the candidates
        lo .. lo + w - 1, as an (n_rows, TILE) block whose columns past w
        are padding.  Peak live bytes: one block, never (n_rows, n_cols)."""
        inv2s2 = inv_two_sigma_sq(self.d, self.rbf_sigma)
        for lo, w, s in similarity_tiles(self.x, self.xx, self.y, self.yy, self.metric, inv2s2):
            if self.col_labels is not None:
                lt = pad_rows(self.col_labels[lo : lo + w], TILE, -1)
                s = torch.where(self.row_labels[:, None] == lt[None, :], s, 0.0)
            yield lo, w, s

    def _gather(self, idx: torch.Tensor) -> "FeatureSource":
        """The sub-source of candidates ``idx`` (clipped into range)."""
        safe = torch.clamp(idx, 0, self.n_cols - 1)
        return dataclasses.replace(
            self,
            y=self.y.index_select(0, safe),
            yy=self.yy.index_select(0, safe),
            col_labels=None if self.col_labels is None else self.col_labels.index_select(0, safe),
            n_cols=int(idx.shape[0]),
        )

    # -- source contract -----------------------------------------------------
    def col(self, j) -> torch.Tensor:
        """sim(i, j) for every row i, shape (n_rows,); run through a full
        TILE-wide block, so it equals the sweeps' similarity bit for bit."""
        ((_, _, block),) = self._gather(one_index(j, self.device))._tiles()
        return block[:, 0]

    def col_sums(self) -> torch.Tensor:
        out = self.x.new_empty((self.n_cols,))
        for lo, w, s in self._tiles():
            out[lo : lo + w] = s.sum(dim=0)[:w]
        return out

    def diag(self) -> torch.Tensor:
        """sim(j, j) for square sources, computed metric-exactly (d2 = 0)."""
        if self.metric == "dot":
            return self.yy
        if self.metric == "cosine":
            # yy is the squared norm of the pre-normalised row: 1.0, or 0.0
            # for a zero-norm row (which similarity maps to the 0.5 midpoint)
            return 0.5 * (1.0 + self.yy)
        return torch.ones_like(self.yy)

    def fl_gains(self, curmax: torch.Tensor) -> torch.Tensor:
        out = self.x.new_empty((self.n_cols,))
        for lo, w, s in self._tiles():
            out[lo : lo + w] = torch.clamp(s - curmax[:, None], min=0.0).sum(dim=0)[:w]
        return out

    def fl_gains_at(self, curmax: torch.Tensor, idx) -> torch.Tensor:
        # the gathered sub-source runs the same TILE-wide blocks as the full
        # sweep, so its gains equal the full sweep's bit for bit
        idx = torch.as_tensor(idx, device=self.device).to(torch.long)
        g = self._gather(idx).fl_gains(curmax)
        return torch.where(idx < 0, NEG_INF, g)

    def masked_rowmax(self, mask) -> torch.Tensor:
        mask = torch.as_tensor(mask, device=self.device).to(torch.bool)
        best = self.x.new_zeros((self.n_rows,))  # max over an empty set is 0
        for lo, w, s in self._tiles():
            m_t = pad_rows(mask[lo : lo + w], TILE, False)
            best = torch.maximum(best, torch.where(m_t[None, :], s, 0.0).amax(dim=1))
        return best

    def quad(self, mask) -> torch.Tensor:
        """m^T S m for square sources, streamed (GC evaluate oracle)."""
        m = torch.as_tensor(mask, device=self.device).to(torch.float32)
        m_rows = m[: self.n_rows]
        acc = self.x.new_zeros(())
        for lo, w, s in self._tiles():
            v = (s * m_rows[:, None]).sum(dim=0)
            acc = acc + (v[:w] * m[lo : lo + w]).sum()
        return acc


def feature_source(
    x,
    y=None,
    metric: str = "dot",
    rbf_sigma: float | None = None,
    labels=None,
    col_labels=None,
    device=None,
) -> FeatureSource:
    """Build a :class:`FeatureSource` from raw feature rows.

    ``y=None`` builds the symmetric (square) source over ``x`` itself — the
    ground-set kernel shape Graph Cut and self-represented FL want.
    ``labels`` attaches clustered block-masking to the rows (and, for the
    symmetric case, the columns); ``col_labels`` overrides the column side.
    A tensor keeps its device; numpy input goes to ``device`` (default: the
    card).
    """
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; choose from {METRICS}")
    x32 = as_float_tensor(x, device)
    dev = x32.device
    if metric == "cosine":
        x32 = _normalize(x32)
    x32 = x32.contiguous()
    xx = (x32 * x32).sum(dim=1)

    def _labels(lab):
        return None if lab is None else torch.as_tensor(lab, device=dev).to(torch.int32)

    row_labels = _labels(labels)
    if y is None:
        y32, yy = x32, xx
        clab = row_labels if col_labels is None else _labels(col_labels)
    else:
        y32 = as_float_tensor(y, dev)
        if metric == "cosine":
            y32 = _normalize(y32)
        y32 = y32.contiguous()
        yy = (y32 * y32).sum(dim=1)
        clab = _labels(col_labels)
    if (row_labels is None) != (clab is None):
        raise ValueError("clustered sources need labels on both axes")
    return FeatureSource(
        x=x32, y=y32, xx=xx, yy=yy, row_labels=row_labels, col_labels=clab,
        metric=metric, rbf_sigma=rbf_sigma, d=int(x32.shape[1]),
        n_rows=int(x32.shape[0]), n_cols=int(y32.shape[0]),
    )


@dataclasses.dataclass(frozen=True, eq=False)
class DenseSource:
    """The materialised matrix, riding the same source contract."""

    sim: torch.Tensor  # (n_rows, n_cols)
    n_rows: int
    n_cols: int

    @property
    def device(self) -> torch.device:
        return self.sim.device

    def col(self, j) -> torch.Tensor:
        return self.sim.index_select(1, one_index(j, self.device))[:, 0]

    def col_sums(self) -> torch.Tensor:
        return self.sim.sum(dim=0)

    def diag(self) -> torch.Tensor:
        return torch.diagonal(self.sim).contiguous()

    def fl_gains(self, curmax: torch.Tensor) -> torch.Tensor:
        return torch.clamp(self.sim - curmax[:, None], min=0.0).sum(dim=0)

    def fl_gains_at(self, curmax: torch.Tensor, idx) -> torch.Tensor:
        idx = torch.as_tensor(idx, device=self.device).to(torch.long)
        cols = self.sim.index_select(1, torch.clamp(idx, 0, self.n_cols - 1))
        g = torch.clamp(cols - curmax[:, None], min=0.0).sum(dim=0)
        return torch.where(idx < 0, NEG_INF, g)

    def masked_rowmax(self, mask) -> torch.Tensor:
        mask = torch.as_tensor(mask, device=self.device).to(torch.bool)
        masked = torch.where(mask[None, :], self.sim, 0.0)
        return torch.clamp(masked.amax(dim=1), min=0.0)  # max over an empty set is 0

    def quad(self, mask) -> torch.Tensor:
        m = torch.as_tensor(mask, device=self.device).to(self.sim.dtype)
        return m[: self.n_rows] @ self.sim @ m


def dense_source(sim, device=None) -> DenseSource:
    """A :class:`DenseSource` over a similarity matrix; a tensor keeps its
    device, numpy input goes to ``device`` (default: the card)."""
    sim = as_float_tensor(sim, device).contiguous()
    return DenseSource(sim=sim, n_rows=int(sim.shape[0]), n_cols=int(sim.shape[1]))


@dataclasses.dataclass(frozen=True, eq=False)
class KnnSource:
    """Sparse k-NN similarity in padded CSR-ish form.

    Row i's neighbours are ``indices[i]`` (int32 column ids, -1 = empty pad
    slot) with similarities ``weights[i]`` (>= 0; pad slots 0).  sim(i, j) is
    ``weights[i, s]`` where ``indices[i, s] == j`` and exactly 0 elsewhere:
    the sparsified matrix of ``similarity.sparsify_topk``, never written.
    FL sweeps are O(n * k): off-neighbourhood entries contribute
    max(0 - curmax, 0) = 0 exactly (curmax >= 0), so the sparse sweep is the
    dense sweep over the sparsified matrix.

    The JAX package sums each column with a scatter-add; on the card a
    scatter-add (``index_add_``) adds in an order that changes from run to
    run.  Here every column sum runs over :attr:`_layout`, built from
    ``indices`` alone at the first sweep: a column's entries in row-major
    order, zero-padded to a power-of-two width, summed pairwise (halves added
    elementwise until one is left).  The order depends on the column's own
    entries alone, so a sum is the same on every run and two columns with
    the same entries get the same bits.  Ids >= n_cols are dropped, as the
    JAX package's ``mode="drop"`` drops them.
    """

    indices: torch.Tensor  # (n_rows, k) int32, -1 pads
    weights: torch.Tensor  # (n_rows, k) fp32 >= 0
    n_rows: int
    n_cols: int
    k: int

    @property
    def device(self) -> torch.device:
        return self.indices.device

    @functools.cached_property
    def _layout(self) -> tuple[tuple[torch.Tensor, torch.Tensor], ...]:
        """((columns, table), ...) by in-degree bucket: the columns of
        in-degree in (W/2, W], and for each a row of W flat entry positions
        (row-major, into ``indices.reshape(-1)``) padded with the position
        n_rows * k, which the sums read as +0.0."""
        flat = self.indices.reshape(-1).long()
        entries = torch.nonzero((flat >= 0) & (flat < self.n_cols)).reshape(-1)
        cols, perm = torch.sort(flat[entries], stable=True)  # by column, then row-major
        entries = entries[perm]
        deg = torch.bincount(cols, minlength=self.n_cols)
        start = torch.cumsum(deg, 0) - deg
        bucket = torch.where(deg > 0, torch.ceil(torch.log2(deg.clamp(min=1).double())), -1.0)
        pad = self.n_rows * self.k
        layout = []
        for b in torch.unique(bucket).tolist():
            if b < 0:
                continue
            width = 1 << int(b)
            cols_b = torch.nonzero(bucket == b).reshape(-1)
            pos = start[cols_b][:, None] + torch.arange(width, device=self.device)[None, :]
            live = pos < (start + deg)[cols_b][:, None]
            table = torch.where(live, entries[pos.clamp(max=max(entries.shape[0] - 1, 0))], pad)
            layout.append((cols_b, table))
        return tuple(layout)

    def _column_sums(self, contrib: torch.Tensor) -> torch.Tensor:
        """(n_cols,) sums of the (n_rows, k) per-entry terms by column, in
        the layout's fixed order."""
        vals = torch.cat([contrib.reshape(-1), contrib.new_zeros(1)])
        out = contrib.new_zeros((self.n_cols,))
        for cols, table in self._layout:
            v = vals[table]
            while v.shape[1] > 1:
                half = v.shape[1] // 2
                v = v[:, :half] + v[:, half:]
            out[cols] = v[:, 0]
        return out

    def _live_w(self) -> torch.Tensor:
        return torch.where(self.indices >= 0, self.weights, 0.0)

    def col(self, j) -> torch.Tensor:
        j = one_index(j, self.device)
        return torch.where(self.indices == j, self.weights, 0.0).sum(dim=1)

    def col_sums(self) -> torch.Tensor:
        return self._column_sums(self._live_w())

    def diag(self) -> torch.Tensor:
        # square sources only (Graph Cut): sim(j, j) is the self-neighbour
        # weight when present, else exactly 0
        rows = torch.arange(self.n_rows, dtype=torch.int32, device=self.device)[:, None]
        d = torch.where(self.indices == rows, self.weights, 0.0).sum(dim=1)
        if self.n_rows == self.n_cols:
            return d
        out = d.new_zeros((self.n_cols,))
        m = min(self.n_rows, self.n_cols)
        out[:m] = d[:m]
        return out

    def fl_gains(self, curmax: torch.Tensor) -> torch.Tensor:
        contrib = torch.where(
            self.indices >= 0, torch.clamp(self.weights - curmax[:, None], min=0.0), 0.0
        )
        return self._column_sums(contrib)

    def fl_gains_at(self, curmax: torch.Tensor, idx) -> torch.Tensor:
        # the full sweep, then a gather, as in the JAX package
        idx = torch.as_tensor(idx, device=self.device).to(torch.long)
        full = self.fl_gains(curmax)
        return torch.where(idx >= 0, full[torch.clamp(idx, 0, self.n_cols - 1)], NEG_INF)

    def masked_rowmax(self, mask) -> torch.Tensor:
        mask = torch.as_tensor(mask, device=self.device).to(torch.bool)
        safe = torch.clamp(self.indices, 0, self.n_cols - 1).long()
        live = (self.indices >= 0) & mask[safe]
        if self.k == 0:
            return self.weights.new_zeros((self.n_rows,))
        # max over an empty set is 0
        return torch.clamp(torch.where(live, self.weights, 0.0).amax(dim=1), min=0.0)

    def quad(self, mask) -> torch.Tensor:
        m = torch.as_tensor(mask, device=self.device).to(torch.float32)
        safe = torch.clamp(self.indices, 0, self.n_cols - 1).long()
        inner = (self._live_w() * m[safe]).sum(dim=1)  # (n_rows,)
        return (inner * m[: self.n_rows]).sum()

    def to_dense(self) -> torch.Tensor:
        """The sparsified matrix, written out (tests / small-n interop)."""
        live = (self.indices >= 0) & (self.indices < self.n_cols)
        rows = torch.arange(self.n_rows, device=self.device)[:, None].expand_as(self.indices)
        out = self.weights.new_zeros((self.n_rows, self.n_cols))
        out.index_put_((rows[live], self.indices[live].long()), self.weights[live], accumulate=True)
        return out


def knn_source(indices, weights, n_cols: int | None = None, device=None) -> KnnSource:
    """A :class:`KnnSource` over (n, k) neighbour ids and weights; tensors
    keep their device, numpy input goes to ``device`` (default: the card).
    ``n_cols`` defaults to n (the square source Graph Cut needs)."""
    if isinstance(indices, torch.Tensor):
        dev = indices.device if device is None else resolve_device(device)
        indices = indices.to(device=dev, dtype=torch.int32)
    else:
        indices = torch.tensor(indices, dtype=torch.int32, device=resolve_device(device))
    weights = as_float_tensor(weights, indices.device)
    if indices.shape != weights.shape or indices.dim() != 2:
        raise ValueError(
            f"indices/weights must both be (n, k); got {tuple(indices.shape)} "
            f"vs {tuple(weights.shape)}"
        )
    n_rows, k = indices.shape
    return KnnSource(
        indices=indices.contiguous(), weights=weights.contiguous(), n_rows=int(n_rows),
        n_cols=int(n_cols) if n_cols is not None else int(n_rows), k=int(k),
    )


def knn_from_features(
    x, k: int, metric: str = "dot", rbf_sigma: float | None = None, batch: int = 2048,
    device=None,
) -> KnnSource:
    """Top-k symmetric k-NN source from features, built in row batches so
    peak memory is O(batch * n), never the full (n, n) matrix.  Each row
    keeps its k largest similarities in descending order, ties to the lower
    column index (``lax.top_k``'s rule): a stable sort of the negated row.
    The similarity is the :class:`FeatureSource`'s (the matrix-free path's
    TILE-wide blocks)."""
    src = feature_source(x, metric=metric, rbf_sigma=rbf_sigma, device=device)
    n = src.n_rows
    if not 0 <= k <= n:
        raise ValueError(f"k must lie in [0, {n}], got {k}")
    idx_out, w_out = [], []
    for lo in range(0, n, batch):
        block = dataclasses.replace(
            src, x=src.x[lo : lo + batch], xx=src.xx[lo : lo + batch],
            n_rows=min(batch, n - lo),
        )
        sim = torch.cat([s[:, :w] for _, w, s in block._tiles()], dim=1)  # (b, n)
        neg, order = torch.sort(-sim, dim=1, stable=True)
        idx_out.append(order[:, :k].to(torch.int32))
        w_out.append(-neg[:, :k])
    return knn_source(torch.cat(idx_out), torch.cat(w_out), n_cols=n)
