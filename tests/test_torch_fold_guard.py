"""The CPU's stand-in for torch 2.11's DTensor view rule
(``tests/_torch_fold_guard.py``) and the port's answer to it,
``act_sharding.local_blocks``, on a fake (2, 2) ("data", "model") world.

- The guard refuses exactly the views that torch 2.11.0+cu128 refuses among
  ``tools/gloo_cuda_probe.py``'s ``FOLDS`` (``--folds`` on the card prints
  ``REFUSED_ON_2_11``'s verdicts), and this torch runs them all.
- ``_gqa_scores`` on query and key heads split over "model" and the batch
  over "data" folds (B, KV) in its einsum: refused under the guard, while
  ``local_blocks`` runs it on each rank's blocks, placed as its roles say
  and equal there to the product of the local blocks.
- Outside an activation-sharding context, or on plain tensors, a region is
  its function.
"""
import pytest
import torch
from _torch_fold_guard import RefuseSplitFolds, refused_dim
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.act_sharding import activation_sharding, local_blocks
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.attention import _gqa_scores

# tools/gloo_cuda_probe.py --folds on torch 2.11.0+cu128 (NVIDIA H100 80GB
# HBM3): the split dim each view refused, None where it ran
REFUSED_ON_2_11 = {
    "batch_and_sequence_split_to_tokens": 1,
    "batch_split_to_tokens": None,
    "sequence_split_to_tokens": 1,
    "sequence_split_to_sequence_by_width": None,
    "width_split_to_sequence_by_width": 2,
    "width_split_to_heads": None,
    "kv_heads_split_merged": None,
    "query_groups_split_merged": 3,
}


def _folds():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "tools" / "gloo_cuda_probe.py"
    spec = importlib.util.spec_from_file_location("gloo_cuda_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FOLDS


def _dtensor(mesh, shape, dims):
    local = [n // 2 if i in dims else n for i, n in enumerate(shape)]
    return DTensor.from_local(torch.randn(local), mesh,
                              [Replicate() if d is None else Shard(d) for d in dims],
                              run_check=False)


@pytest.mark.parametrize("name", list(REFUSED_ON_2_11))
def test_the_guard_refuses_what_torch_2_11_refuses(name):
    shape, dims, view = _folds()[name]
    with fake_world(4):
        mesh = make_test_mesh((2, 2), device="cpu")
        x = _dtensor(mesh, shape, dims)
        assert refused_dim(x, view) == REFUSED_ON_2_11[name]
        assert tuple(x.view(view).shape) == view  # this torch runs it
        with RefuseSplitFolds() as guard:
            if REFUSED_ON_2_11[name] is None:
                x.view(view)
            else:
                with pytest.raises(RuntimeError, match="Attempted to flatten multiple dimensions"):
                    x.view(view)
    assert len(guard.refused) == (REFUSED_ON_2_11[name] is not None)


def test_gqa_scores_on_split_heads_need_local_blocks():
    B, L, KV, G, hd = 4, 8, 2, 3, 5
    with fake_world(4):
        mesh = make_test_mesh((2, 2), device="cpu")
        q = _dtensor(mesh, (B, L, KV, G, hd), (0, 2))
        k = _dtensor(mesh, (B, L, KV, hd), (0, 2))
        with RefuseSplitFolds():
            with pytest.raises(RuntimeError, match="with dimension 1 being sharded"):
                _gqa_scores(q, k)
            with activation_sharding(mesh):
                s = local_blocks(_gqa_scores, (("dp", None, "tp", None, None),
                                               ("dp", None, "tp", None)),
                                 ("dp", "tp", None, None, None))(q, k)
    assert tuple(s.shape) == (B, KV, G, L, L)
    assert tuple(s.placements) == (Shard(0), Shard(1))
    assert torch.equal(s.to_local(), _gqa_scores(q.to_local(), k.to_local()))


def test_local_blocks_outside_a_context_is_the_function():
    calls = []

    def fn(a, b):
        calls.append((a, b))
        return a * b

    a, b = torch.randn(3, 4), torch.randn(3, 4)
    region = local_blocks(fn, (("dp", "tp"), ("dp", "tp")), ("dp", "tp"))
    assert torch.equal(region(a, b), a * b)
    with fake_world(4):
        mesh = make_test_mesh((2, 2), device="cpu")
        with activation_sharding(mesh):
            assert torch.equal(region(a, b), a * b)  # plain tensors
    assert all(x is a and y is b for x, y in calls) and len(calls) == 2
