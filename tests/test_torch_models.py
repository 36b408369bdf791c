"""The training testbed's models in the port (``repro_torch.models``)
against the JAX package's, on the CPU.

Inputs come from numpy with a seed; the JAX package's parameters are handed
over through ``interop.params_from_arrays`` (the port never replays
``jax.random``).  Bars: fp32 layer functions rtol 1e-5 / atol 1e-6 (rope
and mrope 1e-5 / 1e-5: their angles reach ~60 rad, where the two sin / cos
differ by ulps of the angle); ``train_forward``'s loss rtol 1e-5 and every
gradient rtol 1e-4 / atol 1e-6 on the reduced configs in fp32; the bf16
case loss rtol 1e-2 and each gradient within 5% of its norm (bf16 carries
8 bits: the two packages round differently inside every product).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _flatten_with_names
from repro.configs.base import get_config as jget_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch.configs.base import get_config
from repro_torch.interop import params_from_arrays, tree_to_arrays
from repro_torch.models import attention, layers, model
from repro_torch.train.train_step import value_and_grad

CPU = "cpu"
DENSE = ("starcoder2-3b", "qwen3-0.6b", "internlm2-20b", "command-r-plus-104b")
ARCHS = DENSE + ("qwen2-vl-7b",)
B, L = 2, 64
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
BF16_LOSS_RTOL, BF16_GRAD_REL = 1e-2, 5e-2


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _cfgs(arch, **kw):
    return (dataclasses.replace(get_config(arch).reduced(), **kw),
            dataclasses.replace(jget_config(arch).reduced(), **kw))


def _params(cfg, jcfg, seed=0):
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    return params_from_arrays(cfg, jax.tree.map(np.asarray, jp), CPU), jp


def _batch(cfg, seed, seq=L):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, seq)).astype(np.int32)}
    if cfg.family == "vlm":
        b["patches"] = rng.normal(size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return b


# -- layers.py ---------------------------------------------------------------


@pytest.fixture
def xs():
    rng = np.random.default_rng(3)
    return {"x": rng.normal(size=(2, 9, 4, 32)).astype(np.float32),
            "h": rng.normal(size=(2, 9, 48)).astype(np.float32),
            "scale": rng.normal(size=(32,)).astype(np.float32),
            "bias": rng.normal(size=(32,)).astype(np.float32),
            "pos": rng.integers(0, 60, (2, 9)).astype(np.int32),
            "w1": (rng.normal(size=(48, 80)) * 0.1).astype(np.float32),
            "w2": (rng.normal(size=(48, 80)) * 0.1).astype(np.float32),
            "w3": (rng.normal(size=(80, 48)) * 0.1).astype(np.float32),
            "b1": rng.normal(size=(80,)).astype(np.float32),
            "b3": rng.normal(size=(48,)).astype(np.float32)}


LAYER_CASES = {
    "rms_norm": (lambda m, a, x: m.rms_norm(x(a["x"]), x(a["scale"])), 1e-5, 1e-6),
    "layer_norm": (lambda m, a, x: m.layer_norm(x(a["x"]), x(a["scale"]), x(a["bias"])),
                   1e-5, 1e-6),
    "sinusoidal_positions": (lambda m, a, x: m.sinusoidal_positions(x(a["pos"]), 48),
                             1e-5, 1e-5),
    "rope_angles": (lambda m, a, x: m._rope_angles(x(a["pos"]), 32, 1e4)[0], 1e-5, 1e-5),
    "apply_rope": (lambda m, a, x: m.apply_rope(x(a["x"]), x(a["pos"]), 1e6), 1e-5, 1e-5),
    "apply_mrope": (lambda m, a, x: m.apply_mrope(
        x(a["x"]), x(np.stack([a["pos"], a["pos"] // 2, a["pos"] % 7])), (4, 6, 6), 1e6),
        1e-5, 1e-5),
    "swiglu": (lambda m, a, x: m.swiglu(x(a["h"]), x(a["w1"]), x(a["w2"]), x(a["w3"])),
               1e-5, 1e-6),
    "gelu_mlp": (lambda m, a, x: m.gelu_mlp(x(a["h"]), x(a["w1"]), x(a["b1"]), x(a["w3"]),
                                            x(a["b3"])), 1e-5, 1e-5),
}


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_layer_functions_match_the_jax_package(name, xs):
    fn, rtol, atol = LAYER_CASES[name]
    _close(fn(layers, xs, _t), fn(jlayers, xs, jnp.asarray), rtol, atol)


def test_layers_keep_the_cast_order_in_bf16(xs):
    """bf16 in: statistics in fp32, cast back, then scaled — bit-equal to the
    JAX package where both round the same fp32 values."""
    x = xs["x"].astype(jnp.bfloat16)
    s = xs["scale"].astype(jnp.bfloat16)
    got = layers.rms_norm(_t(x.view(np.uint16)).view(torch.bfloat16),
                          _t(s.view(np.uint16)).view(torch.bfloat16))
    want = np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(s)))
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want.astype(np.float32))
    # one bf16 ulp at most, where the fp32 rsqrt differs in its last bit
    assert float((diff > np.abs(want.astype(np.float32)) * 2 ** -7).mean()) == 0.0
    with pytest.raises(ValueError, match="sum to head_dim"):
        layers.apply_mrope(_t(xs["x"]), _t(np.stack([xs["pos"]] * 3)), (4, 6, 5))


# -- attention.py --------------------------------------------------------------


def _qkv(seed, Lq=64, Lk=64, KV=2, G=2, hd=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, Lq, KV, G, hd)).astype(np.float32),
            rng.normal(size=(2, Lk, KV, hd)).astype(np.float32),
            rng.normal(size=(2, Lk, KV, hd)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_equals_dense_attention(causal, monkeypatch):
    """With the block constants made small (16 x 32 tiles over 64), the
    online softmax equals the dense one, in the port and against the JAX
    package's blockwise attention at the same blocks."""
    q, k, v = _qkv(5)
    monkeypatch.setattr(attention, "Q_BLOCK", 16)
    monkeypatch.setattr(attention, "KV_BLOCK", 32)
    monkeypatch.setattr(jattn, "Q_BLOCK", 16)
    monkeypatch.setattr(jattn, "KV_BLOCK", 32)
    got = attention.blockwise_attention(_t(q), _t(k), _t(v), causal)
    _close(got, attention.dense_attention(_t(q), _t(k), _t(v), causal), 1e-5, 1e-6)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(got, jattn.blockwise_attention(jq, jk, jv, causal), 1e-5, 1e-6)
    _close(attention.dense_attention(_t(q), _t(k), _t(v), causal),
           jattn.dense_attention(jq, jk, jv, causal), 1e-5, 1e-6)
    with pytest.raises(ValueError, match="divide into blocks"):
        attention.blockwise_attention(_t(q[:, :40]), _t(k), _t(v), causal)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "starcoder2-3b", "qwen2-vl-7b"])
def test_gqa_attention_three_branches(arch, monkeypatch):
    """No cache (dense and, past FLASH_THRESHOLD, blockwise), prefill into a
    cache and a single-token decode over it with its valid mask, each
    against the JAX package; qk_norm, bias and M-RoPE as the arch has them."""
    cfg, jcfg = _cfgs(arch)
    params, jp = _params(cfg, jcfg, seed=2)
    lp = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tp = {k: v[0] for k, v in params["layers"]["attn"].items()}
    if cfg.use_bias:  # non-zero biases, so the bias path shows
        rng = np.random.default_rng(9)
        for name in ("bq", "bk", "bv"):
            b = rng.normal(size=lp[name].shape).astype(np.float32) * 0.1
            lp[name], tp[name] = jnp.asarray(b), _t(b)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, 32, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(32)[None], (B, 32)).astype(np.int32)
    # 1. no cache, dense then blockwise
    got, c = attention.gqa_attention(cfg, tp, _t(x), _t(pos))
    want, _ = jattn.gqa_attention(jcfg, lp, jnp.asarray(x), jnp.asarray(pos))
    assert c is None
    _close(got, want, 1e-5, 1e-5)
    for mod, blocks in ((attention, 8), (jattn, 8)):
        monkeypatch.setattr(mod, "FLASH_THRESHOLD", 16)
        monkeypatch.setattr(mod, "Q_BLOCK", blocks)
        monkeypatch.setattr(mod, "KV_BLOCK", blocks)
    got_b, _ = attention.gqa_attention(cfg, tp, _t(x), _t(pos))
    _close(got_b, want, 1e-5, 1e-5)
    # 2. prefill into a 40-slot cache
    shape = (B, 40, cfg.n_kv_heads, cfg.head_dim_)
    cache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    jcache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    got_p, cache = attention.gqa_attention(cfg, tp, _t(x), _t(pos), cache, 0)
    want_p, jcache = jattn.gqa_attention(jcfg, lp, jnp.asarray(x), jnp.asarray(pos), jcache, 0)
    _close(got_p, want_p, 1e-5, 1e-5)
    for name in ("k", "v"):
        _close(cache[name], jcache[name], 1e-5, 1e-5)
    # 3. decode one token at position 32 over the masked cache
    x1 = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    p1 = np.full((B, 1), 32, np.int32)
    got_d, cache = attention.gqa_attention(cfg, tp, _t(x1), _t(p1), cache, 32)
    want_d, jcache = jattn.gqa_attention(jcfg, lp, jnp.asarray(x1), jnp.asarray(p1), jcache,
                                         jnp.asarray(32))
    _close(got_d, want_d, 1e-5, 1e-5)
    _close(cache["k"], jcache["k"], 1e-5, 1e-5)


# -- model.py ------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_the_jax_package(arch):
    """Same key paths, shapes and dtypes as the JAX package's tree (layers
    stacked on a leading axis); matrices N(0, 0.02) from the seed, norms
    ones, biases zeros; the same seed draws the same tree."""
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    p = model.init_params(cfg, seed=1, device=CPU)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(1))
    got = tree_to_arrays(p)
    want = {n: np.asarray(v) for n, v in _flatten_with_names(jp)}
    assert sorted(got) == sorted(want)
    for n in got:
        assert got[n].shape == want[n].shape and got[n].dtype == want[n].dtype, n
    assert abs(float(got["embed"].std()) - 0.02) < 1e-3
    assert np.all(got["layers/ln1"] == 1.0)
    again = tree_to_arrays(model.init_params(cfg, seed=1, device=CPU))
    assert all(np.array_equal(got[n], again[n]) for n in got)
    full = dataclasses.replace(cfg, param_dtype="bfloat16")
    assert model.init_params(full, device=CPU)["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_loss_and_every_gradient(arch):
    """fp32 reduced config: the loss within rtol 1e-5 and every gradient
    leaf within rtol 1e-4 / atol 1e-6 of the JAX package's."""
    cfg, jcfg = _cfgs(arch)
    params, jp = _params(cfg, jcfg)
    batch = _batch(cfg, 11)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jmodel.train_forward(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jp)
    loss, grads = value_and_grad(cfg, params, {k: _t(v) for k, v in batch.items()})
    assert 0.2 * np.log(cfg.vocab) < float(loss) < 3.0 * np.log(cfg.vocab)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    got = tree_to_arrays(grads)
    want = {n: np.asarray(v) for n, v in _flatten_with_names(jgrads)}
    assert sorted(got) == sorted(want)
    for n in got:
        np.testing.assert_allclose(got[n], want[n], rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=n)
    loss2, _ = model.train_forward(cfg, params, {k: _t(v) for k, v in batch.items()})
    assert float(loss2) == float(loss)  # no grad: no checkpoint, the same values


def test_train_forward_bf16_qwen3():
    """The card runs bf16: reduced qwen3-0.6b with bf16 params and compute,
    the loss within rtol 1e-2 and each gradient leaf within 5% of its norm."""
    cfg, jcfg = _cfgs("qwen3-0.6b", param_dtype="bfloat16", compute_dtype="bfloat16")
    params, jp = _params(cfg, jcfg)
    assert params["embed"].dtype == torch.bfloat16
    batch = _batch(cfg, 12)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jmodel.train_forward(jcfg, p, {"tokens": jnp.asarray(batch["tokens"])}),
        has_aux=True)(jp)
    loss, grads = value_and_grad(cfg, params, {"tokens": _t(batch["tokens"])})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=BF16_LOSS_RTOL)
    got = tree_to_arrays(grads)
    want = {n: np.asarray(v, np.float32) for n, v in _flatten_with_names(jgrads)}
    for n in got:
        assert _leaf_dtype(grads, n) == torch.bfloat16
        err = np.linalg.norm(got[n] - want[n]) / max(np.linalg.norm(want[n]), 1e-12)
        assert err < BF16_GRAD_REL, (n, err)


def _leaf_dtype(tree, name):
    node = tree
    for part in name.split("/"):
        node = node[part]
    return node.dtype


def test_chunked_xent_chunks_equal_one_piece():
    cfg = get_config("qwen3-0.6b").reduced()
    rng = np.random.default_rng(8)
    h = _t(rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32))
    head = _t(rng.normal(size=(cfg.d_model, cfg.vocab)).astype(np.float32) * 0.05)
    t = _t(rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32))
    one = model.chunked_xent(cfg, h, head, t)
    _close(model.chunked_xent(cfg, h, head, t, chunk=8), one.numpy(), 1e-6, 1e-6)
    want = jmodel.chunked_xent(jget_config("qwen3-0.6b").reduced(), jnp.asarray(h.numpy()),
                               jnp.asarray(head.numpy()), jnp.asarray(t.numpy()))
    _close(one, want, 1e-6, 1e-6)
    with pytest.raises(ValueError, match="divide"):
        model.chunked_xent(cfg, h, head, t, chunk=5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_jax_package_and_each_other(arch):
    """prefill over 32 tokens and one decode step against the JAX package
    (logits rtol 1e-4 / atol 1e-4, caches 1e-5); the decode logits equal a
    prefill over the 33 tokens within test_archs.py's 2e-2 bar, and here
    within 1e-4."""
    cfg, jcfg = _cfgs(arch)
    params, jp = _params(cfg, jcfg)
    batch = _batch(cfg, 13, seq=32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits_p, caches = model.prefill(cfg, params, {k: _t(v) for k, v in batch.items()},
                                     max_len=40)
    jlogits_p, jcaches = jmodel.prefill(jcfg, jp, jb, max_len=40)
    assert logits_p.shape == (B, 1, cfg.vocab) and logits_p.dtype == torch.float32
    _close(logits_p, jlogits_p, 1e-4, 1e-4)
    _close(caches["layers"]["k"], jcaches["layers"]["k"], 1e-5, 1e-5)
    nxt = np.asarray(jnp.argmax(jlogits_p[:, -1], -1)).astype(np.int32)[:, None]
    logits_d, caches = model.decode_step(cfg, params, caches, _t(nxt), 32)
    jlogits_d, _ = jmodel.decode_step(jcfg, jp, jcaches, jnp.asarray(nxt), jnp.asarray(32))
    _close(logits_d, jlogits_d, 1e-4, 1e-4)
    ext = {**batch, "tokens": np.concatenate([batch["tokens"], nxt], axis=1)}
    logits_ref, _ = model.prefill(cfg, params, {k: _t(v) for k, v in ext.items()}, max_len=40)
    _close(logits_d[:, 0], logits_ref[:, 0].numpy(), 1e-4, 1e-4)
    zero = model.init_cache(cfg, B, 40, CPU)["layers"]["k"]
    assert zero.shape == (cfg.n_layers, B, 40, cfg.n_kv_heads, cfg.head_dim_)
