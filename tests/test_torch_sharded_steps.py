"""Sharded training steps in the port on a spawned 2x2 gloo world
(``tests/_torch_dist_world.py``, its timeouts), on the CPU.

Two sharded ``fsdp`` steps of the reduced qwen3-0.6b and deepseek-v2 (fp32)
and two ``dp`` steps of qwen3-0.6b against the port's unsharded steps:
losses within rtol ``LOSS_RTOL``, every leaf within ``LEAF_ATOL`` +
``LEAF_RTOL`` of its scale (the sums of partial gradients and losses run
in another order).  The MoE layers' group count follows ``tp_size()``, so
deepseek's unsharded step runs inside an activation-sharding context of a
(2, 2) stand-in mesh, where ``tp_size()`` is 2 and the tensors stay whole.
Every rank's collectives, counted by ``CostCounter``, equal in count and
bytes what the dry run (``launch/dryrun.py``) counts for the same cell on a
fake (2, 2) mesh.  ``moe_ffn`` on DTensors equals ``moe_ffn`` on the whole
tensors under the same group count within ``MOE_ATOL``.
"""
import numpy as np
import pytest

from _torch_dist_world import results, start_world
from _torch_mesh_cases import batches, drop_cfg, moe_inputs, unsharded
from repro_torch.launch import specs

# the world's process-group and join timeouts: DTensor plans each new
# redistribution on the host, tens of seconds a step under a loaded test run
WORLD_PG_TIMEOUT_S, WORLD_JOIN_TIMEOUT_S = 300, 600
LOSS_RTOL = 1e-5
LEAF_RTOL, LEAF_ATOL = 1e-4, 1e-7
MOE_ATOL = 1e-5

TRAIN_CASES = {  # name: (arch, batch seed, policy)
    "qwen3": ("qwen3-0.6b", 1, "fsdp"),
    "deepseek": ("deepseek-v2-236b", 2, "fsdp"),
    "qwen3_dp": ("qwen3-0.6b", 3, "dp"),
}
TRAIN_SHAPE = (4, 32)  # batch, sequence


@pytest.fixture(scope="module")
def world_2x2(tmp_path_factory):
    d = tmp_path_factory.mktemp("train2x2")
    cases = {name: {"mesh": "2x2", "cfg": drop_cfg(arch), "policy": policy, "seed": 0,
                    "batches": batches(drop_cfg(arch), 2, *TRAIN_SHAPE, seed)}
             for name, (arch, seed, policy) in TRAIN_CASES.items()}
    cfg, params, x = moe_inputs()
    job = {"meshes": {"2x2": ((2, 2), ("data", "model"))}, "timeout_s": WORLD_PG_TIMEOUT_S,
           "training": {"cases": cases, "moe": {"mesh": "2x2", "cfg": cfg, "params": params,
                                                 "x": x}}}
    return job, results(start_world(job, 4, d), d, timeout=WORLD_JOIN_TIMEOUT_S)


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_2x2_world_steps_match_the_unsharded_step(name, world_2x2):
    job, ranks = world_2x2
    case = job["training"]["cases"][name]
    tp = 2 if case["cfg"].n_experts and case["policy"] == "fsdp" else 1
    want_losses, want = unsharded(case["cfg"], case["batches"], tp=tp)
    for r, out in enumerate(ranks):
        got = out["training"][name]
        np.testing.assert_allclose([float(x) for x in got["losses"]],
                                   [float(x) for x in want_losses], rtol=LOSS_RTOL)
        for leaf, value in got["state"].items():
            ref = want[leaf].double()
            scale = float(ref.abs().max()) if ref.numel() else 0.0
            np.testing.assert_allclose(value.double().numpy(), ref.numpy(), rtol=0,
                                       atol=LEAF_ATOL + LEAF_RTOL * scale,
                                       err_msg=f"rank {r} {leaf}")


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_2x2_world_collectives_equal_the_dry_run(name, world_2x2):
    from repro_torch.launch.dryrun import fake_world, trace_cell
    from repro_torch.launch.mesh import make_test_mesh

    job, ranks = world_2x2
    case = job["training"]["cases"][name]
    with fake_world(4):
        mesh = make_test_mesh((2, 2), device="cpu")
        want = trace_cell(case["cfg"], specs.ShapeCell("x", "train", TRAIN_SHAPE[1],
                                                       TRAIN_SHAPE[0]), mesh, case["policy"])
    assert want["collectives"]["total"] > 0
    for r, out in enumerate(ranks):
        for s, got in enumerate(out["training"][name]["collectives"]):
            assert got == want["collectives"], (r, s)


def test_moe_ffn_on_a_2x2_world_equals_the_whole_tensors(world_2x2):
    job, ranks = world_2x2
    for out in ranks:
        assert out["training"]["moe"]["tp_size"] == 2
        np.testing.assert_allclose(out["training"]["moe"]["sharded"].numpy(),
                                   out["training"]["moe"]["whole"].numpy(), rtol=0,
                                   atol=MOE_ATOL)
