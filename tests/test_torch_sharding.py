"""Training on a mesh in the port (``distributed/sharding.py``,
``distributed/act_sharding.py``, ``launch/mesh.py``, ``launch/specs.py``)
against the JAX package and against the port's own unsharded step, on the
CPU.

- **Spec parity**: for all ten architectures at full size, on stub meshes of
  the production shapes (16, 16) and (2, 16, 16) (only the axis names and
  sizes are read, so no 256 processes), under ``fsdp`` and ``dp``: the
  port's ``param_specs`` of ``init_params(abstract=True)`` and of
  ``init_train_state(abstract=True)`` equal the JAX package's leaf by leaf
  (its ``PartitionSpec`` padded with ``None`` to the leaf's rank), and so do
  ``batch_specs`` of every shape cell's inputs and ``cache_specs`` of every
  decode cell's cache; ``SHAPES``, ``cell_applicable`` and ``input_specs``'
  shapes and dtypes equal the JAX package's.  Also the cases of
  ``tests/test_launch_infra.py:40-94``.
- **A world of 1** (gloo, in this process): two train steps on DTensors
  placed on a (1, 1) mesh equal the unsharded steps bit for bit (a mesh dim
  of one rank replicates, so the two policies place alike there: each
  architecture takes one).
- **A spawned 2x2 world**: ``tests/test_torch_sharded_steps.py``.
- **MoE at a model axis of 2**: ``moe_ffn`` with ``tp_size()`` 2 against the
  JAX package's ``moe_ffn`` run in a 4-device JAX subprocess under its own
  ``activation_sharding(make_test_mesh((2, 2)))``: the same (token, k)
  pairs dropped, outputs within ``MOE_ATOL``.
"""
import dataclasses
import datetime
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_mesh_cases import StubMesh, batches, moe_inputs, unsharded
from repro.ckpt.checkpoint import _flatten_with_names as jflatten
from repro.configs.base import get_config as jget_config
from repro.distributed import sharding as jsharding
from repro.launch import specs as jspecs
from repro.models.model import init_cache as jinit_cache
from repro.models.model import init_params as jinit_params
from repro.train.train_step import init_train_state as jinit_train_state
from repro_torch.configs.archs import ALL_ARCHS
from repro_torch.configs.base import get_config
from repro_torch.distributed import sharding
from repro_torch.distributed.act_sharding import activation_sharding, constrain, tp_size
from repro_torch.launch import specs
from repro_torch.models.model import init_cache, init_params
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.tree import flatten_with_names, leaves_like

ROOT = Path(__file__).resolve().parent.parent
MOE_ATOL = 1e-5
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _padded(spec, ndim) -> tuple:
    entries = tuple(spec)
    return entries + (None,) * (ndim - len(entries))


def _jax_specs(specs_tree, like) -> dict:
    """The JAX package's spec tree by leaf name, each padded to its leaf's
    rank."""
    names = [n for n, _ in jflatten(like)]
    flat = jax.tree_util.tree_leaves(specs_tree, is_leaf=lambda s: isinstance(
        s, jax.sharding.PartitionSpec))
    return {n: _padded(s, len(l.shape)) for n, s, (_, l) in zip(names, flat, jflatten(like))}


def _port_specs(specs_tree, like) -> dict:
    return {n: s for (n, _), s in zip(flatten_with_names(like), leaves_like(like, specs_tree))}


def _shapes(tree, flatten) -> dict:
    return {n: (tuple(l.shape), str(l.dtype).replace("torch.", "")) for n, l in flatten(tree)}


@pytest.fixture(scope="module")
def abstract_trees():
    """Each architecture's abstract parameters and train states, both
    packages, at full size."""
    out = {}
    for arch in ALL_ARCHS:
        jcfg, cfg = jget_config(arch), get_config(arch)
        out[arch] = {"jparams": jinit_params(jcfg, abstract=True),
                     "params": init_params(cfg, abstract=True),
                     "jstate": jinit_train_state(jcfg, abstract=True),
                     "state": init_train_state(cfg, abstract=True)}
    return out


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_and_state_specs_match_the_jax_package(arch, abstract_trees):
    t = abstract_trees[arch]
    assert _shapes(t["params"], flatten_with_names) == _shapes(t["jparams"], jflatten)
    assert set(_shapes(t["state"], flatten_with_names)) == set(_shapes(t["jstate"], jflatten))
    for shape, names in MESHES.values():
        mesh = StubMesh(shape, names)
        for policy in ("fsdp", "dp"):
            for mine, theirs in (("params", "jparams"), ("state", "jstate")):
                got = _port_specs(sharding.param_specs(t[mine], mesh, policy), t[mine])
                want = _jax_specs(jsharding.param_specs(t[theirs], mesh, policy), t[theirs])
                assert got == want, (arch, shape, policy, mine)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_batch_and_cache_specs_match_the_jax_package(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for shape, names in MESHES.values():
        mesh = StubMesh(shape, names)
        for cell_name, cell in specs.SHAPES.items():
            if not specs.cell_applicable(arch, cell_name):
                continue
            batch = specs.input_specs(cfg, cell)
            jbatch = jspecs.input_specs(jcfg, jspecs.SHAPES[cell_name])
            assert _shapes(batch, flatten_with_names) == _shapes(jbatch, jflatten)
            for policy in ("fsdp", "dp"):
                for shard in (True, False):
                    got = _port_specs(sharding.batch_specs(batch, mesh, shard, policy), batch)
                    want = _jax_specs(jsharding.batch_specs(jbatch, mesh, shard, policy), jbatch)
                    assert got == want, (arch, cell_name, shape, policy, shard)
            if cell.kind != "decode":
                continue
            B, L = cell.global_batch, cell.seq_len
            cache = init_cache(cfg, B, L, abstract=True)
            jcache = jinit_cache(jcfg, B, L, abstract=True)
            assert _shapes(cache, flatten_with_names) == _shapes(jcache, jflatten)
            got = _port_specs(sharding.cache_specs(cache, mesh, B, L), cache)
            want = _jax_specs(jsharding.cache_specs(jcache, mesh, B, L), jcache)
            assert got == want, (arch, cell_name, shape)


def test_shape_cells_and_applicability_match_the_jax_package():
    assert {k: dataclasses.asdict(v) for k, v in specs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jspecs.SHAPES.items()}
    assert specs.LONG_CONTEXT_ARCHS == jspecs.LONG_CONTEXT_ARCHS
    for arch in ALL_ARCHS:
        for cell in specs.SHAPES:
            assert specs.cell_applicable(arch, cell) == jspecs.cell_applicable(arch, cell)
    assert sum(specs.cell_applicable(a, s) for a in ALL_ARCHS for s in specs.SHAPES) == 32


# --- the cases of tests/test_launch_infra.py:40-94 ---------------------------

def test_filter_divisible_drops_uneven_axes():
    one = StubMesh((1, 1), ("data", "model"))
    assert sharding.filter_divisible(("model", "data"), (28, 64), one) == ("model", "data")
    assert sharding.axis_size(one, ("data", "model")) == 1
    big = StubMesh((16, 16), ("data", "model"))
    assert sharding.filter_divisible(("model", "data"), (28, 64), big) == (None, "data")
    assert sharding.axis_size(big, ("data", "model")) == 256


def test_param_specs_policies():
    mesh = StubMesh((1, 1), ("data", "model"))
    params = {"layers": {"attn": {"wq": torch.zeros((2, 64, 64))}},
              "m": {"layers": {"attn": {"wq": torch.zeros((2, 64, 64))}}}}
    fsdp = sharding.param_specs(params, mesh, "fsdp")
    dp = sharding.param_specs(params, mesh, "dp")
    # dp: compute weights replicated, optimizer moments still sharded
    assert dp["layers"]["attn"]["wq"] == (None, None, None)
    assert dp["m"]["layers"]["attn"]["wq"] == fsdp["m"]["layers"]["attn"]["wq"] == \
        (None, "data", "model")


def test_auto_policy_thresholds():
    for arch in ("whisper-small", "qwen3-0.6b", "mamba2-370m"):
        assert sharding.auto_policy(get_config(arch).param_count()) == "dp"
    for arch in ("kimi-k2-1t-a32b", "command-r-plus-104b"):
        assert sharding.auto_policy(get_config(arch).param_count()) == "fsdp"


def test_cell_applicability_rules():
    assert specs.cell_applicable("mamba2-370m", "long_500k")
    assert specs.cell_applicable("jamba-1.5-large-398b", "long_500k")
    for arch in ("qwen3-0.6b", "kimi-k2-1t-a32b", "whisper-small"):
        assert not specs.cell_applicable(arch, "long_500k")
        assert specs.cell_applicable(arch, "train_4k")


def test_input_specs_shapes_and_dtypes():
    spec = specs.input_specs(get_config("whisper-small"), specs.SHAPES["train_4k"])
    assert spec["tokens"].shape == (256, 4096) and spec["tokens"].dtype == torch.int32
    assert spec["frames"].shape == (256, 1500, 768) and spec["frames"].dtype == torch.float32
    assert spec["tokens"].device.type == "meta"
    spec = specs.input_specs(get_config("qwen2-vl-7b"), specs.SHAPES["prefill_32k"])
    assert spec["patches"].shape == (32, 256, 3584)
    spec = specs.input_specs(get_config("qwen3-0.6b"), specs.SHAPES["decode_32k"])
    assert spec["tokens"].shape == (128, 1)


# --- placements and the activation context ---------------------------------

def test_to_placements_and_local_box_follow_dtensor():
    from torch.distributed.tensor import Replicate, Shard

    mesh = StubMesh((2, 4, 3), ("pod", "data", "model"))
    assert sharding.to_placements((("pod", "data"), "model"), mesh) == \
        [Shard(0), Shard(0), Shard(1)]
    assert sharding.to_placements((None, "data"), mesh) == [Replicate(), Shard(1), Replicate()]
    # a mesh dim of one rank replicates
    assert sharding.to_placements(("data", "model"), StubMesh((1, 2), ("data", "model"))) == \
        [Replicate(), Shard(1)]
    # DTensor's split: torch.chunk along each sharded dim in mesh order, the
    # ranks past the last chunk empty
    index = torch.arange(13 * 7).reshape(13, 7)
    for pl in ([Shard(0), Shard(0), Shard(1)], [Shard(1), Replicate(), Shard(1)],
               [Replicate(), Shard(0), Shard(0)], [Shard(1), Shard(1), Shard(1)]):
        for coord in np.ndindex(2, 4, 3):
            block = index
            for d, p in enumerate(pl):
                if isinstance(p, Shard):
                    chunks = torch.chunk(block, mesh.size(d), dim=p.dim)
                    block = (chunks[coord[d]] if coord[d] < len(chunks)
                             else block.narrow(p.dim, block.shape[p.dim], 0))
            shape, off = sharding.local_box((13, 7), mesh, pl, coord)
            assert shape == tuple(block.shape), (pl, coord)
            if block.numel():
                assert off == (int(block[0, 0]) // 7, int(block[0, 0]) % 7), (pl, coord)


def test_constrain_and_tp_size_outside_and_inside_a_context():
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert tp_size() == 1 and constrain(x, ("dp", "tp", None)) is x
    mesh = StubMesh((2, 4), ("data", "model"))
    with activation_sharding(mesh):
        assert tp_size() == 4
        assert constrain(x, ("dp", "tp", None)) is x  # a plain tensor passes
        with activation_sharding(mesh, policy="dp"):
            assert tp_size() == 1
        with activation_sharding(mesh, enable=False):
            assert tp_size() == 1
        assert tp_size() == 4
    assert tp_size() == 1


# --- a world of 1 in this process -------------------------------------------

@pytest.fixture
def world_of_one(tmp_path):
    """A gloo world of 1 in this process, torn down after the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    from repro_torch.launch.mesh import make_test_mesh

    yield make_test_mesh((1, 1), device="cpu")
    dist.destroy_process_group()


@pytest.mark.parametrize("arch,policy", [("qwen3-0.6b", "fsdp"), ("deepseek-v2-236b", "dp")])
def test_world_of_one_steps_equal_the_unsharded_step_bit_for_bit(arch, policy, world_of_one):
    from repro_torch.distributed.sharding import batch_specs, distribute, param_shardings
    from repro_torch.distributed.sharding import shardings_of

    cfg = get_config(arch).reduced()
    steps = batches(cfg, 2, 4, 32, 1)
    want_losses, want = unsharded(cfg, steps)
    mesh = world_of_one
    state = init_train_state(cfg, seed=0, device="cpu")
    state = distribute(state, param_shardings(state, mesh, policy))
    step = make_train_step(cfg)
    for b, want_loss in zip(steps, want_losses):
        b = distribute(b, shardings_of(b, batch_specs(b, mesh, policy=policy), mesh))
        with activation_sharding(mesh, policy=policy):
            state, m = step(state, b)
        assert torch.equal(m["loss"].full_tensor(), want_loss)
    for name, leaf in flatten_with_names(state):
        assert torch.equal(leaf.full_tensor(), want[name]), name


# --- moe_ffn at a model axis of 2 against the JAX package --------------------

_JAX_MOE = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.distributed.act_sharding import activation_sharding, tp_size
    from repro.launch.mesh import make_test_mesh
    from repro.models.moe import moe_ffn
    data = np.load(sys.argv[1], allow_pickle=True).item()
    cfg, params, x = data["cfg"], data["params"], data["x"]
    mesh = make_test_mesh((2, 2))
    with activation_sharding(mesh), jax.sharding.set_mesh(mesh):
        ts = tp_size()
        y = np.asarray(jax.jit(lambda p, x: moe_ffn(cfg, p, x))(params, x))
    # the routing's kept pairs, as moe_ffn computes them (its group count
    # rounded to tp_size)
    B, L, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    nL = -(-L // min(cfg.moe_group_size, L))
    nL = -(-nL // ts) * ts
    g = -(-L // nL)
    xp = np.pad(x, ((0, 0), (0, nL * g - L), (0, 0))).reshape(B, nL, g, D)
    cap = max(1, int(g * K * cfg.capacity_factor / E))
    probs = jax.nn.softmax(jnp.einsum("bngd,de->bnge", xp, params["router"]), -1)
    _, idx = jax.lax.top_k(probs, K)
    onehot = jax.nn.one_hot(idx, E, dtype=jnp.float32)
    pos = jnp.cumsum(onehot.reshape(B, nL, g * K, E), axis=2).reshape(B, nL, g, K, E) * onehot - 1
    kept = np.asarray(((pos >= 0) & (pos < cap)).any(-1))
    np.save(sys.argv[2], {"y": y, "kept": kept, "tp_size": ts, "nL": nL}, allow_pickle=True)
""")


def test_moe_ffn_at_a_model_axis_of_2_matches_the_jax_package(tmp_path):
    from repro.configs.base import ArchConfig as JArchConfig
    from repro_torch.models.moe import dispatch_combine, moe_ffn, top_k

    cfg, params, x = moe_inputs()
    jcfg = JArchConfig(**dataclasses.asdict(cfg))
    np.save(tmp_path / "in.npy", {"cfg": jcfg, "params": params, "x": x}, allow_pickle=True)
    script = tmp_path / "moe.py"
    script.write_text(_JAX_MOE)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    subprocess.run([sys.executable, str(script), str(tmp_path / "in.npy"),
                    str(tmp_path / "out.npy")], check=True, env=env, cwd=ROOT, timeout=300)
    want = np.load(tmp_path / "out.npy", allow_pickle=True).item()
    assert want["tp_size"] == 2 and want["nL"] == 4

    tparams = {k: torch.as_tensor(v) for k, v in params.items()}
    with activation_sharding(StubMesh((2, 2), ("data", "model"))):
        assert tp_size() == 2
        y = moe_ffn(cfg, tparams, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, want["y"], rtol=0, atol=MOE_ATOL)
    # the same pairs drop: the port's routing at the same group count
    B, L, D = x.shape
    nL = want["nL"]
    g = -(-L // nL)
    xp = torch.nn.functional.pad(torch.as_tensor(x), (0, 0, 0, nL * g - L)).reshape(B, nL, g, D)
    probs = torch.softmax(torch.einsum("bngd,de->bnge", xp, tparams["router"]), -1)
    vals, idx = top_k(probs, cfg.top_k)
    cap = max(1, int(g * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    kept = dispatch_combine(vals, idx, cfg.n_experts, cap)[2].numpy()
    np.testing.assert_array_equal(kept, want["kept"])
    assert not kept.all()  # some pairs do drop
    # outside the context the group count is 3, and the drops differ
    y1 = moe_ffn(cfg, tparams, torch.as_tensor(x)).numpy()
    assert np.abs(y1 - y).max() > 1e-3
