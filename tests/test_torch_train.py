"""The training substrate in the port (``repro_torch.train``,
``repro_torch.ckpt``) against the JAX package's and against numpy, on the
CPU.

Bars: AdamW against numpy rtol 1e-5 / atol 1e-6 (``test_train_substrate.py``'s)
and against the JAX package rtol 1e-6 / atol 1e-7; the int8 quantization
bit-equal (both round half to even); three train steps on the reduced
qwen3-0.6b in fp32 from the JAX package's parameters: losses rtol 1e-5,
grad norms rtol 1e-4, parameters and moments rtol 1e-4 / atol 1e-6; with
compressed gradients a gradient ~1e-7 from the JAX package's can round to
the next int8 value, so there at most 1% of the elements may leave that bar,
each by no more than the steps' summed learning rate.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs.base import get_config as jget_config
from repro.train import grad_compress as jgc
from repro.train import optim as joptim
from repro.train.train_step import init_train_state as jinit_train_state
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import get_config
from repro_torch.interop import train_state_from_arrays, tree_to_arrays
from repro_torch.train import grad_compress as gc
from repro_torch.train.optim import (
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
)
from repro_torch.train.train_step import TrainState, init_train_state, make_train_step
from repro_torch.tree import tree_leaves

CPU = "cpu"
ARCH = "qwen3-0.6b"
STEP_RTOL, STEP_ATOL = 1e-4, 1e-6
COMPRESS_FLIPS = 1e-2  # share of elements a flipped int8 rounding may move


def _numpy_adamw(p, g, m, v, step, lr, b1=0.9, b2=0.95, eps=1e-8, wd=0.1):
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    mhat = m / (1 - b1 ** step)
    vhat = v / (1 - b2 ** step)
    p = p - lr * (mhat / (np.sqrt(vhat) + eps) + wd * p)
    return p, m, v


def test_adamw_matches_numpy_and_the_jax_package(rng):
    p0 = rng.normal(size=(64,)).astype(np.float32)
    params = {"w": torch.from_numpy(p0.copy())}
    state = adamw_init(params)
    jparams = {"w": jnp.asarray(p0)}
    jstate = joptim.adamw_init(jparams)
    pn, mn, vn = p0.copy(), np.zeros_like(p0), np.zeros_like(p0)
    sched, jsched = cosine_schedule(1e-2, 2, 10), joptim.cosine_schedule(1e-2, 2, 10)
    for step in range(1, 6):
        g = rng.normal(size=(64,)).astype(np.float32)
        params, state = adamw_update({"w": torch.from_numpy(g)}, state, params, lr=1e-2)
        jparams, jstate = joptim.adamw_update({"w": jnp.asarray(g)}, jstate, jparams, lr=1e-2)
        pn, mn, vn = _numpy_adamw(pn, g, mn, vn, step, 1e-2)
        np.testing.assert_allclose(params["w"].numpy(), pn, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(params["w"].numpy(), np.asarray(jparams["w"]), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(state.v["w"].numpy(), np.asarray(jstate.v["w"]), rtol=1e-6,
                                   atol=1e-9)
        assert int(state.step) == step and state.step.dtype == torch.int32
        lr, jlr = sched(state.step), jsched(jstate.step)
        np.testing.assert_allclose(float(lr), float(jlr), rtol=1e-6)
    # bf16 moments, as moment_dtype asks
    st = adamw_init({"w": torch.zeros(3)}, moment_dtype=torch.bfloat16)
    assert st.m["w"].dtype == torch.bfloat16


def test_clip_and_cosine_schedule(rng):
    g = rng.normal(size=(32,)).astype(np.float32) * 100
    clipped, norm = clip_by_global_norm({"a": torch.from_numpy(g)}, 1.0)
    jclipped, jnorm = joptim.clip_by_global_norm({"a": jnp.asarray(g)}, 1.0)
    assert float(global_norm(clipped)) <= 1.0 + 1e-5 and float(norm) > 1.0
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    np.testing.assert_allclose(clipped["a"].numpy(), np.asarray(jclipped["a"]), rtol=1e-6)
    small, _ = clip_by_global_norm({"a": torch.ones(4) * 0.1}, 1.0)
    assert torch.equal(small["a"], torch.ones(4) * 0.1)
    sched, jsched = cosine_schedule(1e-3, warmup=10, total=100), joptim.cosine_schedule(
        1e-3, warmup=10, total=100)
    assert float(sched(torch.tensor(0))) == 0.0
    assert abs(float(sched(torch.tensor(10))) - 1e-3) < 1e-9
    assert float(sched(torch.tensor(100))) < float(sched(torch.tensor(50)))
    assert float(sched(torch.tensor(100))) >= 1e-4 - 1e-9
    for s in (0, 3, 10, 11, 57, 100, 250):
        np.testing.assert_allclose(float(sched(torch.tensor(s, dtype=torch.int32))),
                                   float(jsched(jnp.asarray(s, jnp.int32))), rtol=1e-6)


def test_quantization_bit_equal_and_error_feedback(rng):
    """int8 values and block scales bit-equal to the JAX package's (ties at
    .5 included); the error feedback loop against the JAX package's and
    test_train_substrate.py's convergence bar."""
    g = rng.normal(size=(1000,)).astype(np.float32)
    ties = np.zeros(300, np.float32)  # a block of scale 1: exact halves
    ties[:8] = [0.5, -0.5, 1.5, 2.5, -2.5, 127.0, 63.5, -126.5]
    for leaf in (g, ties):
        q, scale = gc._quantize_leaf(torch.from_numpy(leaf))
        jq, jscale = jgc._quantize_leaf(jnp.asarray(leaf))
        assert np.array_equal(q.numpy(), np.asarray(jq)) and q.dtype == torch.int8
        assert np.array_equal(scale.numpy(), np.asarray(jscale))
    assert q[0, :8].tolist() == [0, 0, 2, 2, -2, 127, 64, -126]
    g_hat, err = gc.compress_decompress(torch.from_numpy(g))
    jg_hat, jerr = jgc.compress_decompress(jnp.asarray(g))
    assert np.array_equal(g_hat.numpy(), np.asarray(jg_hat))
    np.testing.assert_allclose((g_hat + err).numpy(), g, rtol=1e-6, atol=1e-6)
    assert float(err.abs().max()) < float(np.abs(g).max()) / 64
    grads, jgrads = {"w": torch.from_numpy(g)}, {"w": jnp.asarray(g)}
    ef, jef = gc.ef_init(grads), jgc.ef_init(jgrads)
    total = np.zeros(1000, np.float32)
    for _ in range(20):
        out, ef = gc.apply_error_feedback(grads, ef)
        jout, jef = jgc.apply_error_feedback(jgrads, jef)
        np.testing.assert_allclose(out["w"].numpy(), np.asarray(jout["w"]), rtol=1e-6,
                                   atol=1e-7)
        total += out["w"].numpy()
    np.testing.assert_allclose(total / 20, g, rtol=0.02, atol=1e-3)


@pytest.fixture(scope="module")
def states():
    cfg, jcfg = get_config(ARCH).reduced(), jget_config(ARCH).reduced()
    jstate = jinit_train_state(jcfg, jax.random.PRNGKey(0), compress=True)
    return cfg, jcfg, jstate


def _jtokens(seed, b=4, l=64, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, l)).astype(np.int32)


@pytest.mark.parametrize("accum,compress", [(1, False), (2, False), (2, True)])
def test_three_train_steps_match_the_jax_package(states, accum, compress):
    """Three steps from the JAX package's state (handed over as numpy):
    losses, grad norms and lr per step, then every parameter and both
    moments, within the stated bars."""
    cfg, jcfg, jstate = states
    if not compress:
        jstate = jstate._replace(ef=None)
    state = train_state_from_arrays(cfg, jax.tree.map(np.asarray, jstate), CPU)
    sched = (cosine_schedule(3e-3, 2, 100), joptim.cosine_schedule(3e-3, 2, 100))
    step = make_train_step(cfg, sched[0], grad_accum=accum, compress_grads=compress)
    jstep = jax.jit(jmake_train_step(jcfg, sched[1], grad_accum=accum, compress_grads=compress))
    for i in range(3):
        tokens = _jtokens(30 + i)
        state, m = step(state, {"tokens": torch.from_numpy(tokens)})
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    got = tree_to_arrays(state)
    want = {n: np.asarray(v) for n, v in jckpt._flatten_with_names(jstate)}
    assert sorted(got) == sorted(want)
    lr_sum = sum(float(sched[0](torch.tensor(i))) for i in range(3))
    for n in got:
        if not compress:
            np.testing.assert_allclose(got[n], want[n], rtol=STEP_RTOL, atol=STEP_ATOL,
                                       err_msg=n)
            continue
        # the int8 rounding of a gradient ~1e-7 away from the JAX package's
        # can land one quantum over: such elements move by at most the
        # steps' summed learning rate, and they are few
        off = ~np.isclose(got[n], want[n], rtol=STEP_RTOL, atol=STEP_ATOL)
        assert off.mean() <= COMPRESS_FLIPS, (n, off.mean())
        assert np.abs(got[n] - want[n]).max() <= lr_sum, n
    assert int(state.opt.step) == 3


def test_grad_accum_matches_one_batch(states):
    cfg, _, jstate = states
    state = train_state_from_arrays(cfg, jax.tree.map(np.asarray, jstate._replace(ef=None)),
                                    CPU)
    batch = {"tokens": torch.from_numpy(_jtokens(40))}
    s1, m1 = make_train_step(cfg, grad_accum=1)(state, batch)
    s2, m2 = make_train_step(cfg, grad_accum=2)(state, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-4)
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-2, atol=2e-4)


def test_train_step_descends_loss(rng):
    """test_train_substrate.py's case in the port: 12 steps on one fixed
    batch, cosine_schedule(3e-3, 2, 1000), lose at least 0.5."""
    cfg = get_config(ARCH).reduced()
    state = init_train_state(cfg, seed=0, device=CPU)
    step = make_train_step(cfg, cosine_schedule(3e-3, 2, 1000))
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (4, 64)).astype(np.int32))}
    losses = []
    for _ in range(12):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def _bf16_state():
    cfg = dataclasses.replace(get_config(ARCH).reduced(), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    state = init_train_state(cfg, seed=3, device=CPU, compress=True)
    step = make_train_step(cfg, cosine_schedule(1e-3, 1, 100), compress_grads=True)
    batch = {"tokens": torch.from_numpy(_jtokens(50))}
    return step(step(state, batch)[0], batch)[0]


def test_checkpoint_round_trip_bf16_train_state(tmp_path, states):
    """A TrainState after two steps (bf16 params and moments, fp32 residual,
    int32 step) comes back bit-equal in its dtypes; its leaf names are the
    ones the JAX package's checkpoint writes for its TrainState."""
    state = _bf16_state()
    assert state.params["embed"].dtype == torch.bfloat16
    assert state.opt.m["embed"].dtype == torch.bfloat16
    d = str(tmp_path / "ck")
    ckpt.save(d, 7, state, {"arch": ARCH})
    assert ckpt.latest_step(d) == 7
    like = init_train_state(dataclasses.replace(get_config(ARCH).reduced(),
                                                param_dtype="bfloat16"), device=CPU,
                            compress=True)
    restored, meta = ckpt.restore(d, like)
    assert meta["step"] == 7 and meta["arch"] == ARCH
    assert isinstance(restored, TrainState) and type(restored.opt) is type(state.opt)
    names = [n for n, _ in jckpt._flatten_with_names(states[2])]
    with open(os.path.join(d, "step_0000000007", "manifest.json")) as f:
        manifest = json.load(f)
    assert [e["name"] for e in manifest["leaves"]] == names
    assert {e["dtype"] for e in manifest["leaves"]} == {"bfloat16", "float32", "int32"}
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype and a.device == b.device and a.shape == b.shape
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


def test_checkpoint_retention_atomicity_and_numpy_leaves(tmp_path):
    """keep_last prunes; no .tmp is left; a numpy ``like`` leaf (the session
    journal's) still comes back as numpy."""
    cfg = get_config(ARCH).reduced()
    state = init_train_state(cfg, device=CPU)
    d = str(tmp_path / "ck")
    for s in [1, 2, 3, 4, 5]:
        ckpt.save(d, s, state, keep_last=2)
    assert sorted(os.listdir(d)) == ["step_0000000004", "step_0000000005"]
    assert not any(p.endswith(".tmp") for p in os.listdir(d))
    j = str(tmp_path / "journal")
    ckpt.save(j, 1, {"payload": np.arange(5, dtype=np.int64)}, meta={"seq": 1})
    tree, meta = ckpt.restore(j, {"payload": 0})
    assert isinstance(tree["payload"], np.ndarray) and tree["payload"].tolist() == [0, 1, 2, 3,
                                                                                      4]
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), state)
