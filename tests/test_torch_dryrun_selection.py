"""The dry run's selection step (``launch/dryrun.py``'s
``build_selection_step``) on real tensors, on the CPU.

- A world of 1 in this process, a (1, 1) ("data", "model") mesh, against
  the JAX package's ``build_selection_step`` step on a one-device mesh, at
  rows 128, pool 2,048, budget 32 over a seeded mixture: ``dense`` and
  ``stochastic`` (the same seed) pick the JAX package's ids, gains within
  the FL bar (1e-5).
- The bf16 variants: the port's bf16 step equals its own fp32 step on the
  widened kernel bit for bit (ids and gains), and the JAX package's step on
  those widened fp32 values (ids, gains within 1e-5).  The JAX package's
  own bf16 run adds in bf16 (its curmax and sums take the kernel's type),
  so it is recorded, not held equal: its largest gain gap and its first id
  parting with the top-two gap there (the test report's properties).
- A spawned 2x2 ("data", "model") gloo world (``tests/_torch_dist_world.py``)
  running the ``bf16`` variant at 256 rows, one 128-row chunk a model
  shard, so the gains' psum adds the world of 1's two chunk sums: every
  rank equal to the world of 1 bit for bit.
"""
import datetime
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_dist_world import results, start_world
from repro_torch.core.optimizers import _threefry
from repro_torch.launch.dryrun import build_selection_step
from repro_torch.launch.mesh import make_test_mesh

ROWS, POOL, BUDGET, SEED = 128, 2048, 32, 5
FL_TOL = dict(rtol=1e-5, atol=1e-5)


def _kernel(rows: int, pool: int, seed: int) -> np.ndarray:
    """(rows, pool) fp32: (1 + cos) / 2 of a 12-component mixture at d = 16,
    the rows a sample of the pool."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(12, 16))
    x = centers[rng.integers(0, 12, size=pool)] + 0.4 * rng.normal(size=(pool, 16))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    rows_x = x[rng.choice(pool, rows, replace=False)]
    return ((1.0 + rows_x @ x.T) / 2.0).astype(np.float32)


def _widened(S: np.ndarray) -> np.ndarray:
    return torch.tensor(S).bfloat16().float().numpy()


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A (1, 1) ("data", "model") mesh on a world of 1 over gloo in this
    process, torn down after the module."""
    tmp = tmp_path_factory.mktemp("dryrun_world1")
    timeout = datetime.timedelta(seconds=60)
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'store'}", rank=0,
                            world_size=1, timeout=timeout)
    try:
        yield make_test_mesh((1, 1), ("data", "model"), device="cpu", timeout=timeout)
    finally:
        dist.destroy_process_group()


def _port(mesh, variant: str, S: np.ndarray, cast_bf16: bool = False):
    fn, _, _ = build_selection_step(mesh, pool=S.shape[1], budget=BUDGET, variant=variant)
    sim = torch.tensor(S)
    sim = sim.bfloat16() if cast_bf16 else sim
    args = (_threefry.prng_key(SEED),) if "stochastic" in variant else ()
    order, gains = fn(sim, *args)
    return order.numpy(), gains.numpy()


def _jax(variant: str, S):
    """The JAX package's selection step on a one-device mesh."""
    jax.devices()  # the backend first: the module below sets a 512-device flag at import
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import build_selection_step as jbuild_selection_step
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    step = jbuild_selection_step(jmesh, pool=S.shape[1], budget=BUDGET, variant=variant)[0]
    args = (jax.random.PRNGKey(SEED),) if "stochastic" in variant else ()
    order, gains = jax.jit(step)(S, *args)
    return np.asarray(order), np.asarray(gains, dtype=np.float32)


def _hold(got, want, what: str) -> None:
    np.testing.assert_array_equal(got[0], want[0], err_msg=what)
    np.testing.assert_allclose(got[1], want[1], **FL_TOL, err_msg=what)


@pytest.mark.parametrize("variant", ["dense", "stochastic"])
def test_selection_step_matches_the_jax_package(mesh, variant):
    S = _kernel(ROWS, POOL, SEED)
    got = _port(mesh, variant, S)
    assert (got[0] >= 0).all() and len(set(got[0].tolist())) == BUDGET
    _hold(got, _jax(variant, S), variant)


def _gains_after(S: np.ndarray, picked) -> np.ndarray:
    """FL gains of every column once ``picked`` are selected."""
    curmax = S[:, list(picked)].max(axis=1) if len(picked) else np.zeros(S.shape[0], S.dtype)
    return np.maximum(S - curmax[:, None], 0.0).sum(axis=0)


@pytest.mark.parametrize("variant", ["bf16", "stochastic_bf16"])
def test_bf16_selection_step_is_the_fp32_step_on_the_widened_kernel(mesh, variant, request):
    S = _kernel(ROWS, POOL, SEED + 1)
    Sw = _widened(S)
    fp32 = variant.replace("_bf16", "").replace("bf16", "dense")
    got = _port(mesh, variant, S, cast_bf16=True)
    widened = _port(mesh, fp32, Sw)
    np.testing.assert_array_equal(got[0], widened[0])
    assert got[1].dtype == np.float32 and np.array_equal(got[1].view(np.uint32),
                                                         widened[1].view(np.uint32))
    _hold(got, _jax(fp32, Sw), f"{variant} on the widened kernel")
    # the JAX package's bf16 arithmetic: recorded, not held equal
    own = _jax(variant, jnp.asarray(S, dtype=jnp.bfloat16))
    parted = np.nonzero(own[0] != got[0])[0]
    t = int(parted[0]) if parted.size else BUDGET
    record = {"variant": variant, "gain_gap": float(np.max(np.abs(own[1] - got[1]))),
              "first_parting": t}
    if parted.size:
        g = _gains_after(Sw, got[0][:t])
        record.update(port_pick=int(got[0][t]), jax_pick=int(own[0][t]),
                      top_two_gap=float(g[got[0][t]] - g[own[0][t]]))
    request.node.user_properties.append(("jax_bf16_arithmetic", record))
    print("the JAX package's bf16 run:", record)


def test_bf16_step_on_a_2x2_world_equals_the_world_of_one(mesh, tmp_path):
    """Rows over "model" (two shards of one 128-row chunk each) and columns
    over "data": every rank's ids and gains are the world of 1's bits."""
    S = _kernel(2 * 128, 1024, SEED + 2)
    want = _port(mesh, "bf16", S, cast_bf16=True)
    job = {"meshes": {"dm": ((2, 2), ("data", "model"))},
           "dryrun_step": {"mesh": "dm", "S": S, "budget": BUDGET, "variant": "bf16",
                           "seed": SEED}}
    for r, out in enumerate(results(start_world(job, 4, tmp_path), tmp_path)):
        order, gains = out["dryrun_step"]
        np.testing.assert_array_equal(order, want[0], err_msg=f"rank {r}")
        assert np.array_equal(gains.view(np.uint32), want[1].view(np.uint32)), f"rank {r}"
