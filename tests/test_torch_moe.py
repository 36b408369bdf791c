"""The port's Mixture-of-Experts layer (``repro_torch.models.moe``) against
the JAX package's, on the CPU.

Inputs come from numpy with a seed; the JAX package's parameters are handed
over through ``interop.params_from_arrays``.  Bars (fp32, reduced configs):
``moe_ffn`` rtol 1e-5 / atol 1e-6, at capacity factor 4.0 (nothing drops)
and at the full configs' 1.0, where the dropped tokens must be the JAX
package's: the tokens whose outputs move between the two capacities (by
more than 1e-5) are the same in both packages, and each of them lost a slot
in the port's routing; ``moe_aux_loss`` rtol 1e-6;
``top_k`` equal to ``jax.lax.top_k`` in values and ids, ties included.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch.configs.base import get_config
from repro_torch.interop import params_from_arrays
from repro_torch.models import moe

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-6
MOVED = 1e-5  # a token "moved" between capacities: some output this far apart


def _t(a):
    return torch.from_numpy(np.array(a))


def _moe_params(arch, router_scale, seed=0, **kw):
    """One MoE layer's parameters of the reduced ``arch`` (from the JAX
    package's init), with the router scaled so that the routing is skewed
    and capacity 1.0 drops slots."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **kw)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    jlp = jax.tree.map(lambda a: a[-1], jp["layers" if "layers" in jp else "pos1"]["moe"])
    jlp = {**jlp, "router": jlp["router"] * router_scale}
    return cfg, jcfg, params_from_arrays(cfg, jax.tree.map(np.asarray, jlp), CPU), jlp


def _x(seed, B, L, D):
    return np.random.default_rng(seed).normal(size=(B, L, D)).astype(np.float32)


# kimi: GQA + 8 experts top-2 + a shared expert; jamba: 8 experts top-2, none
# shared; L = 75 and 130 pad the groups of 64 (g 38 and 44)
CASES = [("kimi-k2-1t-a32b", 64), ("kimi-k2-1t-a32b", 75), ("kimi-k2-1t-a32b", 130),
         ("jamba-1.5-large-398b", 75), ("deepseek-v2-236b", 130)]


@pytest.mark.parametrize("arch,L", CASES)
@pytest.mark.parametrize("capacity", [4.0, 1.0])
def test_moe_ffn_matches_the_jax_package(arch, L, capacity):
    cfg, jcfg, p, jp = _moe_params(arch, 40.0, capacity_factor=capacity)
    x = _x(L, 2, L, cfg.d_model)
    got = moe.moe_ffn(cfg, p, _t(x))
    want = jmoe.moe_ffn(jcfg, jp, jnp.asarray(x))
    assert got.shape == (2, L, cfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch,L", CASES)
def test_capacity_one_drops_the_jax_packages_tokens(arch, L):
    """At capacity 1.0 slots drop (cap = int(g K / E) under the mean load);
    the tokens that lose a slot are the same in both packages (slots follow
    the flattened (g K) order, token-major, k-minor)."""
    cfg1, jcfg1, p, jp = _moe_params(arch, 40.0, capacity_factor=1.0)
    cfg4, jcfg4 = (dataclasses.replace(c, capacity_factor=4.0) for c in (cfg1, jcfg1))
    x = _x(L + 1, 2, L, cfg1.d_model)
    moved = (moe.moe_ffn(cfg1, p, _t(x)) - moe.moe_ffn(cfg4, p, _t(x))).abs().amax(-1).numpy()
    jmoved = np.abs(np.asarray(jmoe.moe_ffn(jcfg1, jp, jnp.asarray(x))
                               - jmoe.moe_ffn(jcfg4, jp, jnp.asarray(x)))).max(-1)
    dropped, jdropped = moved > MOVED, jmoved > MOVED
    assert 0 < dropped.sum() < dropped.size, "capacity 1.0 should drop some slots, not all"
    assert np.array_equal(dropped, jdropped)
    # every token that moved lost a slot (a lost slot of a near-zero gate
    # may move its token by less than MOVED)
    seen = []
    plain = moe.dispatch_combine
    try:
        moe.dispatch_combine = lambda *a: seen.append(plain(*a)) or seen[-1]
        moe.moe_ffn(cfg1, p, _t(x))
    finally:
        moe.dispatch_combine = plain
    (dispatch, combine, kept), = seen
    g = dispatch.shape[2]
    lost = ~kept.all(-1).reshape(2, -1)[:, :L].numpy()
    assert np.all(lost[dropped]) and lost.sum() < lost.size
    # each expert's buffer holds at most cap tokens, one each slot
    assert float(dispatch.sum(2).amax()) <= 1.0 and dispatch.shape[-1] == max(
        1, int(g * cfg1.top_k * 1.0 / cfg1.n_experts))


def test_top_k_ties_go_to_the_lowest_index():
    x = np.array([[0.1, 0.3, 0.3, 0.2, 0.3, 0.0],
                  [0.5, 0.5, 0.5, 0.5, 0.5, 0.5],
                  [0.0, -1.0, 0.0, 2.0, -1.0, 2.0]], np.float32)
    for k in (1, 2, 3, 6):
        vals, idx = moe.top_k(_t(x), k)
        jvals, jidx = jax.lax.top_k(jnp.asarray(x), k)
        assert np.array_equal(idx.numpy(), np.asarray(jidx)), k
        assert np.array_equal(vals.numpy(), np.asarray(jvals)), k
    rng = np.random.default_rng(2)
    r = rng.integers(0, 4, (64, 16)).astype(np.float32)  # many ties
    vals, idx = moe.top_k(_t(r), 5)
    jvals, jidx = jax.lax.top_k(jnp.asarray(r), 5)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))


def test_moe_aux_loss_matches_the_jax_package():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(2, 3, 40, 8)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    _, jidx = jax.lax.top_k(jnp.asarray(probs), 2)
    _, idx = moe.top_k(_t(probs), 2)
    got = moe.moe_aux_loss(_t(probs), idx, 8)
    want = jmoe.moe_aux_loss(jnp.asarray(probs), jidx, 8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # a balanced router scores 1
    flat = torch.full((4, 8), 1 / 8)
    assert abs(float(moe.moe_aux_loss(flat, torch.arange(8).reshape(8, 1)[:4], 8)) - 1.0) < 1e-6


def test_moe_ffn_bf16_keeps_the_jax_packages_cast_order():
    """bf16 activations and weights: the router in fp32, dispatch / combine
    cast to bf16; outputs within 2% of their norm of the JAX package's (the
    two packages round inside every bf16 product)."""
    cfg, jcfg, p, jp = _moe_params("kimi-k2-1t-a32b", 40.0, param_dtype="bfloat16",
                                   compute_dtype="bfloat16")
    x = _x(9, 2, 64, cfg.d_model)
    got = moe.moe_ffn(cfg, {k: v.to(torch.bfloat16) for k, v in p.items()},
                      _t(x).to(torch.bfloat16))
    want = np.asarray(jmoe.moe_ffn(jcfg, jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp),
                                   jnp.asarray(x, jnp.bfloat16)), np.float32)
    assert got.dtype == torch.bfloat16
    err = np.linalg.norm(got.float().numpy() - want) / np.linalg.norm(want)
    assert err < 2e-2, err
