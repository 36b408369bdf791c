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
- The selection cells (the paper's distributed FL greedy, budget 512, over a
  (16,384 x 2^20) kernel placed rows over "model", columns over the data
  axes): each of the four variants on the fake (16, 16) world, through
  ``run_cell`` or the CLI, and ``select_1m`` on the (2, 16, 16) world, with
  the argument bytes (the 1,024 x 65,536 block, or 1,024 x 32,768; 4 or 2
  bytes an element), the 2,048 all-reduces (4 a step: the gains' psum over
  "model", the winner's pmax and its int64 pmin, its column's psum) and
  their bytes, exactly, and the FL sweeps' bytes by their kernels' formula;
  ``--all`` and ``--arch selection``'s cells.
- The FL operators on meta tensors under ``CostCounter``: one operation a
  call, its kernel's bytes.
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


# -- the selection cells ------------------------------------------------------

STEPS = 512  # build_selection_step's budget
U_LOC = (1 << 14) // 16  # the rows over "model"
# a step's all-reduces: the gains' psum over "model" (v_loc or 1,024 sampled
# fp32 gains), the winner's gain (pmax, fp32) and id (pmin, int64), its column
# (psum, u_loc fp32)
def _allreduce_bytes(v_loc: int, stochastic: bool) -> int:
    return STEPS * (4 * (1024 if stochastic else v_loc) + 4 + 8 + 4 * U_LOC)


def _sweep_bytes(v_loc: int, elt: int, stochastic: bool) -> int:
    """A step's FL sweep, by its kernel's formula: u·n·elt + 4u + 4n, or for
    the 1,024 gathered columns u·k·elt + 4u + k·(4 + 8)."""
    if stochastic:
        return U_LOC * 1024 * elt + 4 * U_LOC + 1024 * (4 + 8)
    return U_LOC * v_loc * elt + 4 * U_LOC + 4 * v_loc


SELECTION_KEYS = {"arch", "shape", "mesh", "mesh_shape", "n_devices", "policy", "memory",
                  "collectives", "trace_s", "bytes_per_device", "flops_per_device",
                  "kernel_bytes"}


def _hold_selection_record(rec, shape, mesh_kind):
    stochastic, elt = "stoch" in shape, 2 if "bf16" in shape else 4
    v_loc = (1 << 20) // (32 if mesh_kind == "multi" else 16)
    assert set(rec) == SELECTION_KEYS
    assert (rec["arch"], rec["shape"], rec["mesh"]) == ("selection", shape, mesh_kind)
    assert rec["n_devices"] == (512 if mesh_kind == "multi" else 256)
    assert rec["policy"] == "fsdp" and rec["flops_per_device"] == 0.0
    assert rec["memory"]["argument_size_in_bytes"] == U_LOC * v_loc * elt
    assert rec["memory"]["output_size_in_bytes"] == STEPS * (4 + 4)  # int32 ids, fp32 gains
    coll = rec["collectives"]
    assert coll["counts"] == {k: (4 * STEPS if k == "all-reduce" else 0)
                              for k in dryrun.COLLECTIVES}
    assert coll["all-reduce"] == coll["total"] == _allreduce_bytes(v_loc, stochastic)
    op = "fl_gains_at" if stochastic else "fl_gains"
    assert rec["kernel_bytes"] == {op: STEPS * _sweep_bytes(v_loc, elt, stochastic)}
    assert rec["bytes_per_device"] > rec["kernel_bytes"][op]


@pytest.mark.parametrize("shape", ["select_1m", "select_1m_stoch", "select_1m_stoch_bf16"])
def test_selection_cell_on_the_single_pod_world(shape):
    rec = dryrun.run_cell("selection", shape, "single", device="cpu")
    _hold_selection_record(rec, shape, "single")


def test_select_1m_on_the_multi_pod_world():
    """The columns split 32 ways over ("pod", "data"): half the block."""
    rec = dryrun.run_cell("selection", "select_1m", "multi", device="cpu")
    assert rec["mesh_shape"] == [2, 16, 16]
    assert rec["memory"]["argument_size_in_bytes"] == 134_217_728
    _hold_selection_record(rec, "select_1m", "multi")


def test_cli_writes_the_bf16_selection_record(tmp_path):
    dryrun.main(["--arch", "selection", "--shape", "select_1m_bf16", "--device", "cpu",
                 "--out", str(tmp_path)])
    rec = json.load(open(tmp_path / "selection__select_1m_bf16__single.json"))
    _hold_selection_record(rec, "select_1m_bf16", "single")
    assert rec["memory"]["argument_size_in_bytes"] == 134_217_728


def test_all_and_arch_selection_cells():
    every = dryrun.cells_of(True, None, None)
    assert every[-1] == ("selection", "select_1m")
    assert [c for c in every if c[0] == "selection"] == [("selection", "select_1m")]
    assert dryrun.cells_of(False, "selection", None) == [("selection", "select_1m")]
    for shape in dryrun.SELECTION_SHAPES:
        assert dryrun.cells_of(False, "selection", shape) == [("selection", shape)]
    with pytest.raises(ValueError, match="select_1m_stoch"):
        dryrun.run_cell("selection", "select_2m", "single", device="cpu")
    # a dense step's FL bytes over a stochastic one's: the ~64x of the JAX
    # package's docstring (src/repro/core/optimizers/distributed.py:156-160)
    assert _sweep_bytes(65536, 4, False) == 268_701_696
    assert _sweep_bytes(65536, 4, True) == 4_210_688
    assert 63.8 < 268_701_696 / 4_210_688 < 63.9


def test_selection_step_traces_on_a_mesh_of_one_rank():
    """On a (1, 1) mesh the kernel's placements replicate (a dimension of one
    rank splits nothing) and the step takes its block whole: the counts at
    a small pool and budget."""
    with dryrun.fake_world(1):
        mesh = make_test_mesh((1, 1), ("data", "model"), device="cpu")
        rec = dryrun.trace_selection(mesh, "stochastic_bf16", pool=4096, budget=8)
    assert rec["memory"]["argument_size_in_bytes"] == (1 << 14) * 4096 * 2
    assert rec["collectives"]["counts"]["all-reduce"] == 4 * 8
    assert rec["collectives"]["all-reduce"] == 8 * (4 * 1024 + 4 + 8 + 4 * (1 << 14))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fl_operators_on_meta_tensors_count_once_with_their_kernel_bytes(dtype):
    """Each call is one operation of ``torch.ops.repro_torch``, its output
    the right shape, its bytes its kernel's (a wave's for every member; past
    the crossover the full sweep's)."""
    from repro_torch.kernels import ops

    elt = torch.empty((), dtype=dtype).element_size()
    u, n, B = 300, 2000, 3
    sim, cm = torch.empty((u, n), dtype=dtype, device="meta"), torch.empty(u, device="meta")
    ids32 = torch.empty(7, dtype=torch.int32, device="meta")
    wide = torch.empty(100, dtype=torch.int64, device="meta")  # k = 0.05 n: the crossover
    waves = torch.empty((B, u, n), dtype=dtype, device="meta")
    wcm, wids = torch.empty((B, u), device="meta"), torch.empty((B, 7), dtype=torch.int64,
                                                                 device="meta")
    cases = [
        (lambda: ops.fl_gains(sim, cm), "fl_gains", (n,), u * n * elt + 4 * u + 4 * n),
        (lambda: ops.fl_gains_at(sim, cm, ids32), "fl_gains_at", (7,),
         u * 7 * elt + 4 * u + 7 * (4 + 4)),
        (lambda: ops.fl_gains_at(sim, cm, wide), "fl_gains_at", (100,),
         u * n * elt + 4 * u + 4 * n + 100 * (4 + 8)),
        (lambda: ops.fl_gains(waves, wcm), "fl_gains", (B, n), B * (u * n * elt + 4 * u + 4 * n)),
        (lambda: ops.fl_gains_at(waves, wcm, wids), "fl_gains_at", (B, 7),
         B * (u * 7 * elt + 4 * u + 7 * (4 + 8))),
    ]
    for call, name, shape, nbytes in cases:
        counter = dryrun.CostCounter()
        with counter:
            out = call()
        assert out.device.type == "meta" and out.dtype == torch.float32
        assert tuple(out.shape) == shape
        assert counter.kernel_bytes == {name: nbytes} and counter.bytes == nbytes
        assert counter.flops == 0 and counter.collectives()["total"] == 0


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
