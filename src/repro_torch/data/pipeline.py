"""Data pipeline (the JAX package's ``data/pipeline.py``): the synthetic
deterministic token stream, and the embeddings the selection stage
(:mod:`repro_torch.data.selection`) picks coresets over.

The stream draws with numpy exactly as the JAX package's does, so tokens,
patches and frames are the JAX package's bit for bit; ``batch`` puts them
on ``device`` (default: the card).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.configs.base import ArchConfig


class SyntheticTokens:
    """Deterministic clustered token stream.

    Examples are drawn from ``n_modes`` latent modes (each mode = a Zipf-ish
    distribution over a vocab slice) so that subset selection has real
    structure to exploit: a representative coreset covers the modes."""

    def __init__(self, cfg: ArchConfig, seq_len: int, n_modes: int = 16, seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.seq_len = seq_len
        self.n_modes = n_modes
        self.seed = seed
        self.device = device

    def example(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        mode = idx % self.n_modes
        lo = (self.cfg.vocab * mode) // self.n_modes
        hi = (self.cfg.vocab * (mode + 1)) // self.n_modes
        # Zipf-ish: most mass on a few mode-anchor tokens, then the mode's
        # vocab slice, then global noise
        anchor_rng = np.random.default_rng(self.seed * 7919 + mode)
        anchors = anchor_rng.integers(lo, hi, 8)
        tok_anchor = anchors[rng.integers(0, 8, self.seq_len)]
        tok_local = rng.integers(lo, hi, self.seq_len)
        tok_noise = rng.integers(0, self.cfg.vocab, self.seq_len)
        u = rng.random(self.seq_len)
        return np.where(u < 0.7, tok_anchor, np.where(u < 0.9, tok_local, tok_noise)).astype(
            np.int32)

    def mode_of(self, idx: int) -> int:
        return idx % self.n_modes

    def batch(self, indices) -> dict:
        """Tokens (B, L) int32 [+ patches / frames fp32] on the device."""
        out = {"tokens": np.stack([self.example(int(i)) for i in indices])}
        if self.cfg.family == "audio":
            rng = np.random.default_rng(self.seed + 7)
            out["frames"] = rng.normal(
                size=(len(indices), self.cfg.enc_positions, self.cfg.d_model)).astype(np.float32)
        if self.cfg.family == "vlm":
            rng = np.random.default_rng(self.seed + 11)
            out["patches"] = rng.normal(
                size=(len(indices), self.cfg.n_patches, self.cfg.d_model)).astype(np.float32)
        dev = resolve_device(self.device)
        return {k: torch.from_numpy(v).to(dev) for k, v in out.items()}

    def stream(self, batch_size: int, start: int = 0) -> Iterator[dict]:
        i = start
        while True:
            yield self.batch(range(i, i + batch_size))
            i += batch_size


def embed_examples(cfg: ArchConfig, params, batch) -> torch.Tensor:
    """Mean-pooled final hidden states (before the final norm) as fp32 — the
    selection feature space; for ``audio`` the mean of the encoder's
    output."""
    from repro_torch.models.model import _backbone, _embed, _positions, _whisper_encode

    if cfg.family == "audio":
        return _whisper_encode(cfg, params, batch["frames"]).mean(dim=1).float()
    tokens = batch["tokens"]
    B, L = tokens.shape
    x = _backbone(cfg, params, _embed(cfg, params, tokens), _positions(B, L, tokens.device))
    return x.mean(dim=1).float()
