"""The port's sharded checkpoint and its elastic restore
(``ckpt/checkpoint.py``), on the CPU.

- A spawned 2x2 world (``tests/_torch_dist_world.py``, its timeouts) places
  the reduced qwen3-0.6b's train state in bf16 by ``fsdp``, saves it
  sharded (one ``shard_{rank:05d}.npz`` per rank that holds a block,
  rank 0's manifest) and restores it in the same world onto (4, 1) and
  (1, 4) meshes: every leaf bit-equal, with the asked placements.  This
  process restores the same step onto a world of 1 (no process group,
  whole tensors), bit-equal to what the world saved, bf16 leaves included.
- A world of 1 in this process (gloo): a restore with ``shardings`` returns
  DTensors with the asked placements; ``tests/test_train_substrate.py:116-160``'s
  round trip, retention and atomicity (a stale ``.tmp`` directory) for the
  sharded format; a plain tree keeps the single-process format's behaviour
  (one file of rank 0, the values bit for bit).
"""
import dataclasses
import datetime
import json
import os

import pytest
import torch
import torch.distributed as dist

from _torch_dist_world import results, start_world
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import get_config
from repro_torch.distributed.sharding import distribute, param_shardings
from repro_torch.train.train_step import init_train_state
from repro_torch.tree import flatten_with_names, leaves_like


def _bf16_cfg():
    return dataclasses.replace(get_config("qwen3-0.6b").reduced(), param_dtype="bfloat16",
                               compute_dtype="bfloat16")


@pytest.fixture(scope="module")
def saved_on_2x2(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt2x2")
    cfg = _bf16_cfg()
    job = {"meshes": {"2x2": ((2, 2), ("data", "model")), "4x1": ((4, 1), ("data", "model")),
                      "1x4": ((1, 4), ("data", "model"))}, "timeout_s": 300,
           "training": {"cases": {"bf16": {
               "mesh": "2x2", "cfg": cfg, "policy": "fsdp", "seed": 0, "batches": [],
               "ckpt": str(d / "ck"), "restore_on": ["4x1", "1x4"]}}}}
    return str(d / "ck"), cfg, results(start_world(job, 4, d), d, timeout=600)


def test_2x2_save_restores_onto_4x1_and_1x4_bit_equal(saved_on_2x2):
    _, _, ranks = saved_on_2x2
    for r, out in enumerate(ranks):
        for mesh, got in out["training"]["bf16"]["restored"].items():
            assert got == {"placed": True, "step": 1, "equal": True}, (r, mesh)


def test_2x2_save_writes_one_file_per_rank_and_a_manifest_of_blocks(saved_on_2x2):
    d, _, _ = saved_on_2x2
    step_dir = os.path.join(d, "step_0000000001")
    assert sorted(os.listdir(step_dir)) == ["manifest.json"] + [
        f"shard_{r:05d}.npz" for r in range(4)]
    manifest = json.load(open(os.path.join(step_dir, "manifest.json")))
    by_name = {e["name"]: e for e in manifest["leaves"]}
    wq = by_name[".params/layers/attn/wq"]  # (layers, D, H·hd): data x model
    assert wq["dtype"] == "bfloat16" and len(wq["blocks"]) == 4
    assert sorted(tuple(b["offset"]) for b in wq["blocks"]) == [
        (0, 0, 0), (0, 0, 64), (0, 64, 0), (0, 64, 64)]
    norm = by_name[".params/final_norm"]  # replicated: one block, rank 0's
    assert norm["blocks"] == [{"rank": 0, "offset": [0], "shape": [128]}]


def test_2x2_save_restores_onto_a_world_of_1(saved_on_2x2):
    d, cfg, ranks = saved_on_2x2
    like = init_train_state(cfg, seed=5, device="cpu")
    got, meta = ckpt.restore(d, like)
    assert meta["step"] == 1
    saved = ranks[0]["training"]["bf16"]["state"]
    leaves = dict(flatten_with_names(got))
    assert set(leaves) == set(saved)
    for name, t in leaves.items():
        assert not hasattr(t, "device_mesh")
        assert t.dtype == saved[name].dtype and torch.equal(t, saved[name]), name


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    from repro_torch.launch.mesh import make_test_mesh

    yield make_test_mesh((1, 1), device="cpu")
    dist.destroy_process_group()


def _assert_equal_trees(a, b):
    la, lb = dict(flatten_with_names(a)), dict(flatten_with_names(b))
    assert set(la) == set(lb)
    for name in la:
        x = la[name].full_tensor() if hasattr(la[name], "full_tensor") else la[name]
        y = lb[name].full_tensor() if hasattr(lb[name], "full_tensor") else lb[name]
        assert x.dtype == y.dtype and torch.equal(x, y), name


def test_restore_with_shardings_returns_dtensors_with_the_asked_placements(tmp_path,
                                                                          world_of_one):
    from torch.distributed.tensor import DTensor

    cfg = _bf16_cfg()
    plain = init_train_state(cfg, seed=0, device="cpu")
    state = distribute(plain, param_shardings(plain, world_of_one, "fsdp"))
    d = str(tmp_path / "ck")
    ckpt.save(d, 3, state, {"arch": "qwen3-0.6b"})
    abstract = init_train_state(cfg, abstract=True)
    want = param_shardings(abstract, world_of_one, "dp")
    got, meta = ckpt.restore(d, abstract, shardings=want)
    assert meta == {"arch": "qwen3-0.6b", "step": 3}
    for (name, t), (mesh, pl) in zip(flatten_with_names(got), leaves_like(abstract, want)):
        assert isinstance(t, DTensor) and t.device_mesh is mesh, name
        assert tuple(t.placements) == tuple(pl) and t.to_local().device.type == "cpu", name
    _assert_equal_trees(got, plain)


def test_sharded_checkpoint_roundtrip(tmp_path, world_of_one):
    cfg = get_config("qwen3-0.6b").reduced()
    plain = init_train_state(cfg, seed=0, device="cpu")
    state = distribute(plain, param_shardings(plain, world_of_one, "fsdp"))
    d = str(tmp_path / "ck")
    ckpt.save(d, 7, state, {"arch": "qwen3-0.6b"})
    assert ckpt.latest_step(d) == 7
    restored, meta = ckpt.restore(d, state, shardings=param_shardings(state, world_of_one,
                                                                      "fsdp"))
    assert meta["step"] == 7 and meta["arch"] == "qwen3-0.6b"
    _assert_equal_trees(restored, state)


def test_sharded_checkpoint_retention_and_atomicity(tmp_path, world_of_one):
    cfg = get_config("mamba2-370m").reduced()
    plain = init_train_state(cfg, seed=0, device="cpu")
    state = distribute(plain, param_shardings(plain, world_of_one, "fsdp"))
    d = str(tmp_path / "ck")
    # a crash mid-save leaves a stale .tmp: the next save of that step
    # replaces it, and no .tmp is left published
    os.makedirs(os.path.join(d, "step_0000000005.tmp"))
    open(os.path.join(d, "step_0000000005.tmp", "shard_00003.npz"), "w").close()
    for s in [1, 2, 3, 4, 5]:
        ckpt.save(d, s, state, keep_last=2)
    assert sorted(os.listdir(d)) == ["step_0000000004", "step_0000000005"]
    assert sorted(os.listdir(os.path.join(d, "step_0000000005"))) == [
        "manifest.json", "shard_00000.npz"]
    assert ckpt.latest_step(d) == 5


def test_plain_tree_saves_as_one_file_and_restores_bit_for_bit(tmp_path):
    cfg = _bf16_cfg()
    state = init_train_state(cfg, seed=0, device="cpu")
    d = str(tmp_path / "ck")
    ckpt.save(d, 2, state)
    assert sorted(os.listdir(os.path.join(d, "step_0000000002"))) == [
        "manifest.json", "shard_00000.npz"]
    got, meta = ckpt.restore(d, init_train_state(cfg, seed=1, device="cpu"))
    assert meta["step"] == 2
    _assert_equal_trees(got, state)
