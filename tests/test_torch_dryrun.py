"""The port's dry run (``launch/dryrun.py``) on the CPU.

- The CLI in a subprocess (300 s limit): ``--arch qwen3-0.6b --shape
  train_4k --mesh single --device cpu`` on a fake world of 256 ranks writes a
  record with the JAX package's keys (``trace_s`` in place of ``lower_s`` /
  ``compile_s``), ``n_devices`` 256 and the ``dp`` policy, whose
  ``flops_per_device`` lies within ``FLOPS_RTOL`` of an analytic count:
  8·N·T/256 for the weight products (forward, the layers' recompute in
  backward, backward twice), N the weights that enter a product (every
  layer's projections and the tied head; the embedding lookup is no
  product), T the batch's tokens; plus the dense attention's score and
  value products as the port computes them (L = 4,096 is below
  ``FLASH_THRESHOLD``), 2·2·B·H·L²·hd a layer's forward, four times over.
- ``CostCounter`` on small DTensor programs over fake meshes: a product's
  local flops, an all-gather's result bytes, a step's arguments and
  outputs by their local bytes; every cell kind (train, prefill, decode,
  a batch of 1) of each family's reduced config traces, and a train step with fewer
  KV heads than the model axis has ranks (kimi-k2's 8 on 16) under fsdp.
- ``--arch selection`` is refused with ROADMAP's entry.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.specs import ShapeCell

ROOT = Path(__file__).resolve().parent.parent
FLOPS_RTOL = 0.2
# the JAX package's record keys (src/repro/launch/dryrun.py:326-338 and its
# cost phase), the compile times replaced by trace_s, and tp_activations
# (whether activations were split over the model axis)
RECORD_KEYS = {"arch", "shape", "mesh", "mesh_shape", "n_devices", "policy", "trace_s",
               "memory", "flops_per_device", "bytes_per_device", "collectives",
               "params_total", "params_active", "tp_activations"}


def _analytic_train_flops(cfg, batch, seq, n_devices) -> float:
    D, H, KV, hd, F = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, cfg.d_ff
    per_layer = D * H * hd + 2 * D * KV * hd + H * hd * D + 3 * D * F
    weights = cfg.n_layers * per_layer + cfg.vocab * D  # the tied head
    tokens = batch * seq
    attention = cfg.n_layers * 2 * 2 * batch * H * seq * seq * hd
    return (8 * weights * tokens + 4 * attention) / n_devices


def test_cli_writes_the_production_record(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen3-0.6b", "--shape",
         "train_4k", "--mesh", "single", "--device", "cpu", "--out", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "dry-run OK: 1 cells" in proc.stdout
    rec = json.load(open(tmp_path / "qwen3-0.6b__train_4k__single.json"))
    assert set(rec) == RECORD_KEYS
    assert rec["n_devices"] == 256 and rec["mesh_shape"] == [16, 16]
    assert rec["policy"] == "dp" and rec["tp_activations"] is False
    assert set(rec["memory"]) == {"argument_size_in_bytes", "output_size_in_bytes",
                                  "temp_size_in_bytes"}
    assert set(rec["collectives"]) == set(dryrun.COLLECTIVES) | {"total", "counts"}
    cfg = get_config("qwen3-0.6b")
    want = _analytic_train_flops(cfg, 256, 4096, 256)
    assert abs(rec["flops_per_device"] - want) <= FLOPS_RTOL * want, (rec["flops_per_device"],
                                                                      want)
    # dp: every weight replicated in bf16 (2 bytes), the moments sharded
    assert rec["memory"]["argument_size_in_bytes"] > 2 * cfg.param_count()
    assert rec["params_total"] == cfg.param_count()


def test_cost_counter_counts_local_products_and_collective_bytes():
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with dryrun.fake_world(4):
        mesh = make_test_mesh((4,), ("data",), device="cpu")
        a = DTensor.from_local(torch.empty(8, 32, device="meta"), mesh, [Shard(0)],
                               run_check=False)
        b = DTensor.from_local(torch.empty(32, 16, device="meta"), mesh, [Replicate()],
                               run_check=False)
        counter = dryrun.CostCounter()
        with counter:
            c = a @ b
            whole = c.redistribute(mesh, [Replicate()])
        assert tuple(whole.shape) == (32, 16)
    assert counter.flops == 2 * 8 * 32 * 16  # the local (8, 32) x (32, 16) product
    coll = counter.collectives()
    assert coll["counts"]["all-gather"] == 1
    assert coll["all-gather"] == 32 * 16 * 4 == coll["total"]
    assert counter.peak >= 8 * 16 * 4 + 32 * 16 * 4


# one architecture of each family (kimi-k2's GQA MoE: the fewer-heads test)
FAMILY_ARCHS = ("qwen3-0.6b", "deepseek-v2-236b", "jamba-1.5-large-398b", "mamba2-370m",
                "whisper-small", "qwen2-vl-7b")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_every_cell_kind_traces_on_a_fake_2x2_mesh(arch):
    cfg = get_config(arch).reduced()
    cells = [ShapeCell("t", "train", 32, 4), ShapeCell("p", "prefill", 32, 4),
             ShapeCell("d", "decode", 32, 4), ShapeCell("l", "decode", 32, 1)]
    with dryrun.fake_world(4):
        mesh = make_test_mesh((2, 2), device="cpu")
        for cell in cells:
            rec = dryrun.trace_cell(cfg, cell, mesh, "dp")
            assert rec["flops_per_device"] > 0 and rec["memory"]["argument_size_in_bytes"] > 0
            assert rec["memory"]["temp_size_in_bytes"] > 0, (arch, cell.kind)


def test_selection_cells_are_refused_with_the_roadmap_entry():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dryrun.run_cell("selection", "select_1m", "single")


def test_fewer_kv_heads_than_the_model_axis_trace_under_fsdp():
    """2 KV heads on a model axis of 4 (kimi-k2's 8 on the production 16):
    the heads' views gather the split dim first, forward and backward."""
    cfg = get_config("qwen3-0.6b").reduced()
    assert cfg.n_kv_heads % 4 and cfg.n_heads % 4 == 0
    with dryrun.fake_world(4):
        mesh = make_test_mesh((1, 4), device="cpu")
        rec = dryrun.trace_cell(cfg, ShapeCell("t", "train", 32, 4), mesh, "fsdp")
    assert rec["flops_per_device"] > 0 and rec["collectives"]["counts"]["all-gather"] > 0


def test_without_folding_split_dims_the_tp_roles_are_off(monkeypatch):
    """Where DTensor cannot fold a split dim (torch 2.11), fsdp keeps its
    parameter placements but splits no activation over the model axis: the
    "tp" role is off, the record says so, and a train step traces on a fake
    2x2 mesh.  tp_size() stays 2, so moe_ffn rounds its group count as on a
    torch that folds: the same function, bit for bit."""
    from _torch_mesh_cases import moe_inputs

    from repro_torch.distributed import act_sharding
    from repro_torch.models.moe import moe_ffn

    cfg = get_config("deepseek-v2-236b").reduced()
    mcfg, params, x = moe_inputs()
    params = {k: torch.as_tensor(v) for k, v in params.items()}
    x = torch.as_tensor(x)
    with dryrun.fake_world(4):
        mesh = make_test_mesh((2, 2), device="cpu")
        assert act_sharding.folds_split_dims(mesh)  # this torch folds them
        with act_sharding.activation_sharding(mesh):
            assert act_sharding.tp_size() == 2 and act_sharding.splits_activations()
            folded = moe_ffn(mcfg, params, x)
        monkeypatch.setattr(act_sharding, "folds_split_dims", lambda mesh: False)
        with act_sharding.activation_sharding(mesh):
            assert act_sharding.tp_size() == 2 and not act_sharding.splits_activations()
            unfolded = moe_ffn(mcfg, params, x)
        with act_sharding.activation_sharding(mesh, policy="dp"):
            assert act_sharding.tp_size() == 1 and not act_sharding.splits_activations()
        rec = dryrun.trace_cell(cfg, ShapeCell("t", "train", 32, 4), mesh, "fsdp")
    assert torch.equal(folded, unfolded)
    # 3 groups outside a mesh, 4 at tp_size 2: other pairs drop
    assert not torch.equal(moe_ffn(mcfg, params, x), folded)
    assert rec["tp_activations"] is False
    assert rec["flops_per_device"] > 0 and rec["collectives"]["counts"]["all-gather"] > 0
