"""Input shape cells for the dry run's architectures x shapes sweep (the
JAX package's ``launch/specs.py``), and their stand-in inputs: tensors
that hold no data (``launch/dryrun.py`` traces
each cell)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}

# long_500k needs sub-quadratic attention: only the SSM / hybrid archs run it
LONG_CONTEXT_ARCHS = {"jamba-1.5-large-398b", "mamba2-370m"}


def cell_applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True


def input_specs(cfg: ArchConfig, cell: ShapeCell, device="meta") -> dict:
    """The model inputs of a shape cell as empty tensors on ``device``: the
    meta device by default, or any device under a ``FakeTensorMode``."""
    B = cell.global_batch

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    if cell.kind == "decode":
        # one new token against a seq_len cache (built separately)
        return {"tokens": empty((B, 1), torch.int32)}
    batch = {"tokens": empty((B, cell.seq_len), torch.int32)}
    if cfg.family == "audio":
        batch["frames"] = empty((B, cfg.enc_positions, cfg.d_model), torch.float32)
    if cfg.family == "vlm":
        batch["patches"] = empty((B, cfg.n_patches, cfg.d_model), torch.float32)
    return batch
