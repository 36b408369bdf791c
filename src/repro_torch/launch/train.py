"""End-to-end training launcher with submodular data selection (the JAX
package's ``launch/train.py``): real steps on ``device`` (default: the
card), checkpoint / restart, per-round submodular coreset selection, and
logging.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --steps 50 --batch 8 --seq 256 --select-every 10 --ckpt-dir /tmp/ck

Each selection round embeds a pool of ``batch * select_every * pool_factor``
examples with the model being trained (under ``torch.inference_mode``),
picks a coreset of ``budget`` (default ``batch * select_every``) with
:class:`~repro_torch.data.selection.SubmodularSelector` (on the card at
n >= 4,096: the CUDA similarity and FL-sweep kernels), and trains on it,
padding from the stream once the coreset runs out.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.common import resolve_device
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import SyntheticTokens, embed_examples
from repro_torch.data.selection import SelectorConfig, SubmodularSelector
from repro_torch.train.train_step import init_train_state, make_train_step


def run(
    arch: str,
    steps: int = 50,
    batch: int = 8,
    seq: int = 256,
    select_every: int = 0,
    pool_factor: int = 4,
    budget: int | None = None,
    ckpt_dir: str | None = None,
    ckpt_every: int = 25,
    reduced: bool = True,
    objective: str = "representative",
    seed: int = 0,
    log_every: int = 10,
    device=None,
):
    """Train ``arch`` for ``steps`` steps; returns the losses of the steps
    this call ran."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    data = SyntheticTokens(cfg, seq, seed=seed, device=dev)
    state = init_train_state(cfg, seed, dev)
    step_fn = make_train_step(cfg)

    start_step = 0
    if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        state, meta = ckpt.restore(ckpt_dir, state)
        start_step = meta["step"]
        print(f"[ckpt] resumed from step {start_step}")

    selector = (
        SubmodularSelector(
            cfg,
            SelectorConfig(objective=objective, budget=budget or batch * select_every),
            device=dev,
        )
        if select_every
        else None
    )

    cursor = start_step * batch
    queue: list[int] = []
    losses = []
    t0 = time.monotonic()
    for step in range(start_step, steps):
        if selector and not queue:
            # selection round: embed a pool, pick a representative coreset
            pool_n = batch * select_every * pool_factor
            pool_idx = list(range(cursor, cursor + pool_n))
            with torch.inference_mode():
                emb = torch.cat([embed_examples(cfg, state.params,
                                                data.batch(pool_idx[i: i + batch]))
                                 for i in range(0, pool_n, batch)])
            chosen = selector.select(emb)
            queue = [pool_idx[i] for i in chosen]
            cursor += pool_n
            print(f"[select] step {step}: pool {pool_n} -> coreset {len(queue)}")
        if selector:
            idx, queue = queue[:batch], queue[batch:]
            while len(idx) < batch:  # pad from the stream if coreset exhausted
                idx.append(cursor)
                cursor += 1
        else:
            idx = list(range(cursor, cursor + batch))
            cursor += batch
        state, metrics = step_fn(state, data.batch(idx))
        losses.append(float(metrics["loss"]))
        if (step + 1) % log_every == 0:
            dt = time.monotonic() - t0
            print(
                f"step {step + 1:5d}  loss {losses[-1]:.4f}  "
                f"gnorm {float(metrics['grad_norm']):.3f}  "
                f"{dt / log_every:.2f}s/step"
            )
            t0 = time.monotonic()
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, step + 1, state, {"arch": arch})
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--select-every", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--objective", default="representative")
    ap.add_argument("--full", action="store_true", help="full (non-reduced) config")
    ap.add_argument("--device", default=None, help="default: the card (cuda)")
    a = ap.parse_args(argv)
    run(
        a.arch,
        steps=a.steps,
        batch=a.batch,
        seq=a.seq,
        select_every=a.select_every,
        ckpt_dir=a.ckpt_dir,
        ckpt_every=a.ckpt_every,
        reduced=not a.full,
        objective=a.objective,
        device=a.device,
    )


if __name__ == "__main__":
    main()
