"""Every registered architecture in the port (``repro_torch.models``)
against the JAX package's, on the CPU: the moe (kimi-k2, deepseek-v2 with
MLA), hybrid (jamba), ssm (mamba2) and audio (whisper) families beside the
dense / vlm ones of ``test_torch_models.py``.

Inputs come from numpy with a seed; the JAX package's parameters are handed
over through ``interop.params_from_arrays``.  Bars, reduced configs in fp32:
``cross_attention`` and ``mla_attention``'s three branches rtol 1e-5 / atol
1e-5 (as GQA's in ``test_torch_models.py``: rope angles); ``train_forward``'s
loss rtol 1e-5 and every gradient leaf rtol 1e-4 / atol 1e-6; bf16
(deepseek-v2, mamba2) loss rtol 1e-2 and each gradient leaf within 5% of its
norm, ``test_torch_models.py``'s bf16 bars; ``prefill`` / ``decode_step`` logits rtol 1e-4 /
atol 1e-4 and caches 1e-5 / 1e-5 against the JAX package's (kimi,
deepseek, whisper).  The ssm and hybrid families' ``prefill`` is held
against the JAX package's no-cache forward and its chain of single-token
``decode_step``s at 1e-4 (ROADMAP queue 3: the JAX package's own prefill
handles the first token only; a test records its gap).  ``param_count`` /
``active_param_count`` equal; whisper's ``embed_examples`` rtol 1e-5 / atol
1e-6; train steps from the JAX package's state with zero-size leaves
(mamba2's ``d_ff = 0`` FFN) at ``test_torch_train.py``'s bars.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _flatten_with_names
from repro.configs.base import get_config as jget_config
from repro.configs.base import list_configs as jlist_configs
from repro.data import pipeline as jpipeline
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.train import optim as joptim
from repro.train.train_step import init_train_state as jinit_train_state
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import get_config, list_configs
from repro_torch.data import pipeline
from repro_torch.interop import params_from_arrays, train_state_from_arrays, tree_to_arrays
from repro_torch.launch import train
from repro_torch.models import attention, model
from repro_torch.train.optim import cosine_schedule
from repro_torch.train.train_step import init_train_state, make_train_step, value_and_grad
from repro_torch.tree import flatten_with_names, tree_leaves

CPU = "cpu"
NEW = ("kimi-k2-1t-a32b", "deepseek-v2-236b", "jamba-1.5-large-398b", "mamba2-370m",
       "whisper-small")
ALL = sorted(jlist_configs())
B, L = 2, 64
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
BF16_LOSS_RTOL, BF16_GRAD_REL = 1e-2, 5e-2
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=msg)


def _cfgs(arch, **kw):
    return (dataclasses.replace(get_config(arch).reduced(), **kw),
            dataclasses.replace(jget_config(arch).reduced(), **kw))


def _params(cfg, jcfg, seed=0):
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    return params_from_arrays(cfg, jax.tree.map(np.asarray, jp), CPU), jp


def _batch(cfg, seed, seq=L):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, seq)).astype(np.int32)}
    if cfg.family == "audio":
        b["frames"] = rng.normal(size=(B, cfg.enc_positions, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["patches"] = rng.normal(size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return b


def _port(batch):
    return {k: _t(v) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _named(tree):
    return {n: np.asarray(v) for n, v in _flatten_with_names(tree)}


def _jshapes(cfg):
    """{leaf name: (shape, dtype)} of the JAX package's tree, unmaterialized."""
    tree = jax.eval_shape(lambda: jmodel.init_params(cfg, jax.random.PRNGKey(0)))
    return {n: (tuple(v.shape), np.dtype(v.dtype)) for n, v in _flatten_with_names(tree)}


# -- attention.py: cross and MLA --------------------------------------------


def test_cross_attention_matches_the_jax_package():
    cfg, jcfg = _cfgs("whisper-small")
    _, jp = _params(cfg, jcfg, seed=2)
    rng = np.random.default_rng(3)
    lp = jax.tree.map(lambda a: a[0], jp["dec_layers"]["xattn"])
    lp = {**lp, "bq": jnp.asarray(rng.normal(size=lp["bq"].shape), jnp.float32) * 0.1}
    tp = {k: _t(v) for k, v in lp.items()}
    H, hd = cfg.n_heads, cfg.head_dim_
    x = rng.normal(size=(B, 7, cfg.d_model)).astype(np.float32)
    kv = {k: rng.normal(size=(B, 20, H, hd)).astype(np.float32) for k in ("k", "v")}
    got = attention.cross_attention(cfg, tp, _t(x), {k: _t(v) for k, v in kv.items()})
    want = jattn.cross_attention(jcfg, lp, jnp.asarray(x), {k: jnp.asarray(v)
                                                            for k, v in kv.items()})
    _close(got, want, 1e-5, 1e-5)


@pytest.mark.parametrize("q_lora", [64, 0])
def test_mla_attention_three_branches(q_lora, monkeypatch):
    """No cache (dense and, past FLASH_THRESHOLD, the packed blockwise form),
    prefill into a latent cache, and the absorbed decode against it (keys
    at positions >= cache_len + 1 masked), each against the JAX package;
    with and without query compression."""
    cfg, jcfg = _cfgs("deepseek-v2-236b", q_lora_rank=q_lora)
    params, jp = _params(cfg, jcfg, seed=4)
    lp = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tp = {k: v[0] for k, v in params["layers"]["attn"].items()}
    assert ("w_dq" in tp) == bool(q_lora)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, 32, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(32)[None], (B, 32)).astype(np.int32)
    got, c = attention.mla_attention(cfg, tp, _t(x), _t(pos))
    want, _ = jattn.mla_attention(jcfg, lp, jnp.asarray(x), jnp.asarray(pos))
    assert c is None
    _close(got, want, 1e-5, 1e-5)
    for mod in (attention, jattn):
        monkeypatch.setattr(mod, "FLASH_THRESHOLD", 16)
        monkeypatch.setattr(mod, "Q_BLOCK", 8)
        monkeypatch.setattr(mod, "KV_BLOCK", 8)
    got_b, _ = attention.mla_attention(cfg, tp, _t(x), _t(pos))
    want_b, _ = jattn.mla_attention(jcfg, lp, jnp.asarray(x), jnp.asarray(pos))
    _close(got_b, want_b, 1e-5, 1e-5)
    _close(got_b, want, 1e-5, 1e-5)  # the packed form is the dense one
    shapes = {"c_kv": (B, 40, cfg.kv_lora_rank), "k_rope": (B, 40, cfg.rope_head_dim)}
    cache = {k: torch.zeros(s) for k, s in shapes.items()}
    jcache = {k: jnp.zeros(s) for k, s in shapes.items()}
    got_p, cache = attention.mla_attention(cfg, tp, _t(x), _t(pos), cache, 0)
    want_p, jcache = jattn.mla_attention(jcfg, lp, jnp.asarray(x), jnp.asarray(pos), jcache, 0)
    _close(got_p, want_p, 1e-5, 1e-5)
    for name in shapes:
        _close(cache[name], jcache[name], 1e-5, 1e-5)
    for at in (32, 33):
        x1 = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        p1 = np.full((B, 1), at, np.int32)
        got_d, cache = attention.mla_attention(cfg, tp, _t(x1), _t(p1), cache, at)
        want_d, jcache = jattn.mla_attention(jcfg, lp, jnp.asarray(x1), jnp.asarray(p1),
                                             jcache, jnp.asarray(at))
        _close(got_d, want_d, 1e-5, 1e-5)
        _close(cache["c_kv"], jcache["c_kv"], 1e-5, 1e-5)


# -- model.py ------------------------------------------------------------------


def test_every_registered_arch_is_ported():
    assert sorted(list_configs()) == ALL and len(ALL) == 10
    assert not hasattr(model, "check_family")


@pytest.mark.parametrize("arch", ALL)
def test_init_params_tree_matches_the_jax_package(arch):
    """Same key paths (``pos{p}``, ``enc_layers`` / ``dec_layers``,
    ``layers_pre``), shapes and dtypes as the JAX package's tree; the same
    seed draws the same tree."""
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    got = tree_to_arrays(model.init_params(cfg, seed=1, device=CPU))
    assert {n: (v.shape, v.dtype) for n, v in got.items()} == _jshapes(jcfg)
    again = tree_to_arrays(model.init_params(cfg, seed=1, device=CPU))
    assert all(np.array_equal(got[n], again[n]) for n in got)


def test_zero_width_ffn_leaves_match_the_jax_package():
    """mamba2-370m's ``d_ff = 0``: every ssm layer carries (D, 0) / (0, D)
    FFN matrices, in both trees."""
    cfg, jcfg = _cfgs("mamba2-370m", d_ff=0)
    got = tree_to_arrays(model.init_params(cfg, device=CPU))
    assert {n: (v.shape, v.dtype) for n, v in got.items()} == _jshapes(jcfg)
    assert got["layers/ffn/w_gate"].shape == (cfg.n_layers, cfg.d_model, 0)
    assert get_config("mamba2-370m").d_ff == 0


@pytest.mark.parametrize("arch", NEW)
def test_train_forward_loss_and_every_gradient(arch):
    """fp32 reduced config: the loss within rtol 1e-5 and every gradient
    leaf within rtol 1e-4 / atol 1e-6 of the JAX package's (whisper's
    cross-attention ``bk``, which the loss does not reach, zero in both)."""
    cfg, jcfg = _cfgs(arch)
    params, jp = _params(cfg, jcfg)
    batch = _batch(cfg, 11)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jmodel.train_forward(jcfg, p, _jax(batch)), has_aux=True)(jp)
    loss, grads = value_and_grad(cfg, params, _port(batch))
    assert 0.2 * np.log(cfg.vocab) < float(loss) < 3.0 * np.log(cfg.vocab)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    got, want = tree_to_arrays(grads), _named(jgrads)
    assert sorted(got) == sorted(want)
    for n in got:
        np.testing.assert_allclose(got[n], want[n], rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=n)
    loss2, _ = model.train_forward(cfg, params, _port(batch))
    assert float(loss2) == float(loss)  # no grad: no checkpoint, the same values


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "mamba2-370m"])
def test_train_forward_bf16(arch):
    """bf16 params and compute: the loss within rtol 1e-2 and each gradient
    leaf within 5% of its norm (test_torch_models.py's bf16 bars); every gradient in bf16
    and finite."""
    cfg, jcfg = _cfgs(arch, param_dtype="bfloat16", compute_dtype="bfloat16")
    params, jp = _params(cfg, jcfg)
    batch = _batch(cfg, 12)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jmodel.train_forward(jcfg, p, _jax(batch)), has_aux=True)(jp)
    loss, grads = value_and_grad(cfg, params, _port(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=BF16_LOSS_RTOL)
    want = {n: v.astype(np.float32) for n, v in _named(jgrads).items()}
    named = flatten_with_names(grads)
    assert sorted(n for n, _ in named) == sorted(want)
    for name, g in named:
        assert g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all(), name
        got = g.float().numpy()
        err = np.linalg.norm(got - want[name]) / max(np.linalg.norm(want[name]), 1e-12)
        assert err < BF16_GRAD_REL, (name, err)


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "deepseek-v2-236b", "whisper-small"])
def test_prefill_and_decode_match_the_jax_package(arch):
    """prefill over 32 tokens (layers_pre's and layers' caches, MLA's latent
    cache, whisper's decoder caches and enc_out) and two decode steps against
    the JAX package; each decode's logits equal a prefill over the extended
    tokens within test_archs.py's 2e-2, here 1e-4."""
    cfg, jcfg = _cfgs(arch)
    params, jp = _params(cfg, jcfg)
    batch = _batch(cfg, 13, seq=32)
    logits, caches = model.prefill(cfg, params, _port(batch), max_len=40)
    jlogits, jcaches = jmodel.prefill(jcfg, jp, _jax(batch), max_len=40)
    assert logits.shape == (B, 1, cfg.vocab) and logits.dtype == torch.float32
    _close(logits, jlogits, LOGIT_TOL, LOGIT_TOL)
    got_c, want_c = tree_to_arrays(caches), _named(jcaches)
    assert sorted(got_c) == sorted(want_c)
    for n in got_c:
        _close(_t(got_c[n]), want_c[n], CACHE_TOL, CACHE_TOL, n)
    tokens = batch["tokens"]
    for at in (32, 33):
        nxt = np.asarray(jnp.argmax(jlogits[:, -1], -1)).astype(np.int32)[:, None]
        logits, caches = model.decode_step(cfg, params, caches, _t(nxt), at)
        jlogits, jcaches = jmodel.decode_step(jcfg, jp, jcaches, jnp.asarray(nxt),
                                              jnp.asarray(at))
        _close(logits, jlogits, LOGIT_TOL, LOGIT_TOL)
        tokens = np.concatenate([tokens, nxt], axis=1)
        ref, _ = model.prefill(cfg, params, _port({**batch, "tokens": tokens}), max_len=40)
        _close(logits[:, 0], ref[:, 0].numpy(), LOGIT_TOL, LOGIT_TOL)
    for n, v in tree_to_arrays(caches).items():
        _close(_t(v), _named(jcaches)[n], CACHE_TOL, CACHE_TOL, n)


def _jforward_last(jcfg, jp, tokens):
    """The JAX package's no-cache forward at the last position."""
    Bn, Ln = tokens.shape
    x = jmodel._embed(jcfg, jp, jnp.asarray(tokens))
    x = jmodel._backbone(jcfg, jp, x, jnp.broadcast_to(jnp.arange(Ln)[None], (Bn, Ln)))
    x = jmodel.rms_norm(x, jp["final_norm"], jcfg.norm_eps)
    head = jmodel._head_matrix(jcfg, jp)
    return np.asarray(jnp.einsum("bld,dv->blv", x[:, -1:], head.astype(x.dtype)))


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-1.5-large-398b"])
def test_ssm_prefill_equals_the_forward_and_the_decode_chain(arch):
    """Defect 2, model level.  The port's prefill over 64 tokens (two chunks
    of 32) equals the JAX package's no-cache forward at the last position
    and its chain of 64 single-token decode_steps from an empty cache, caches
    included; a decode that follows continues the sequence (the chain's 65th
    step).  The JAX package's own prefill parts from both by far more (its
    mamba layers see the first token only)."""
    cfg, jcfg = _cfgs(arch)
    params, jp = _params(cfg, jcfg, seed=1)
    tokens = np.random.default_rng(21).integers(0, cfg.vocab, (B, 65)).astype(np.int32)
    head = tokens[:, :64]
    logits, caches = model.prefill(cfg, params, {"tokens": _t(head)}, max_len=72)
    forward = _jforward_last(jcfg, jp, head)
    _close(logits, forward, LOGIT_TOL, LOGIT_TOL)
    jc = jmodel.init_cache(jcfg, B, 72)
    jdecode = jax.jit(lambda c, tok, at: jmodel.decode_step(jcfg, jp, c, tok, at))
    for t in range(64):
        chain, jc = jdecode(jc, jnp.asarray(head[:, t: t + 1]), jnp.asarray(t))
    _close(logits, chain, LOGIT_TOL, LOGIT_TOL)
    got_c, want_c = tree_to_arrays(caches), _named(jc)
    assert sorted(got_c) == sorted(want_c)
    for n in got_c:
        _close(_t(got_c[n]), want_c[n], 1e-4, 1e-5, n)
    nxt, _ = model.decode_step(cfg, params, caches, _t(tokens[:, 64:]), 64)
    jnxt, _ = jdecode(jc, jnp.asarray(tokens[:, 64:]), jnp.asarray(64))
    _close(nxt, jnxt, LOGIT_TOL, LOGIT_TOL)
    jprefill, _ = jmodel.prefill(jcfg, jp, {"tokens": jnp.asarray(head)}, max_len=72)
    gap = float(np.abs(np.asarray(jprefill) - forward).max())
    ours = float(np.abs(logits.numpy() - forward).max())
    assert gap > 1e-4 > ours and gap > 30 * ours, (gap, ours)


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-1.5-large-398b", "whisper-small",
                                  "deepseek-v2-236b"])
def test_init_cache_matches_the_jax_package(arch):
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    got = tree_to_arrays(model.init_cache(cfg, 3, 24, CPU))
    want = _named(jmodel.init_cache(jcfg, 3, 24))
    assert {n: (v.shape, v.dtype) for n, v in got.items()} == {
        n: (v.shape, v.dtype) for n, v in want.items()}
    assert all(not v.any() for v in got.values())


@pytest.mark.parametrize("arch", ALL)
def test_param_counts_equal_the_jax_packages(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    r, jr = cfg.reduced(), jcfg.reduced()
    assert r.param_count() == jr.param_count()


def test_whisper_embed_examples_is_the_encoders_mean():
    cfg, jcfg = get_config("whisper-small").reduced(), jget_config("whisper-small").reduced()
    params, jp = _params(cfg, jcfg, seed=4)
    idx = list(range(40, 46))
    want = np.asarray(jpipeline.embed_examples(jcfg, jp, jpipeline.SyntheticTokens(
        jcfg, 32).batch(idx)))
    with torch.inference_mode():
        got = pipeline.embed_examples(cfg, params, pipeline.SyntheticTokens(
            cfg, 32, device=CPU).batch(idx))
    assert got.dtype == torch.float32 and got.shape == (6, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-1.5-large-398b", "deepseek-v2-236b"])
def test_embed_examples_matches_the_jax_package(arch):
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    params, jp = _params(cfg, jcfg, seed=5)
    idx = list(range(6))
    want = np.asarray(jpipeline.embed_examples(jcfg, jp, jpipeline.SyntheticTokens(
        jcfg, 32).batch(idx)))
    with torch.inference_mode():
        got = pipeline.embed_examples(cfg, params, pipeline.SyntheticTokens(
            cfg, 32, device=CPU).batch(idx))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_train_steps_with_zero_size_leaves_match_the_jax_package(tmp_path):
    """mamba2-370m with its published d_ff = 0 (zero-size FFN leaves): two
    compressed steps from the JAX package's state at test_torch_train.py's
    bars; the zero-size leaves come through AdamW, the int8 compression,
    tree_to_arrays and the checkpoint as they went in."""
    cfg, jcfg = _cfgs("mamba2-370m", d_ff=0)
    jstate = jinit_train_state(jcfg, jax.random.PRNGKey(0), compress=True)
    state = train_state_from_arrays(cfg, jax.tree.map(np.asarray, jstate), CPU)
    sched = (cosine_schedule(3e-3, 2, 100), joptim.cosine_schedule(3e-3, 2, 100))
    step = make_train_step(cfg, sched[0], compress_grads=True)
    jstep = jax.jit(jmake_train_step(jcfg, sched[1], compress_grads=True))
    for i in range(2):
        tokens = np.random.default_rng(30 + i).integers(0, cfg.vocab, (2, 32)).astype(np.int32)
        state, m = step(state, {"tokens": _t(tokens)})
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    got, want = tree_to_arrays(state), _named(jstate)
    assert sorted(got) == sorted(want)
    empty = [n for n in got if got[n].size == 0]
    assert len(empty) == 12  # w_gate / w_up / w_down in params, m, v and the residual
    lr_sum = sum(float(sched[0](torch.tensor(i))) for i in range(2))
    for n in got:
        assert got[n].shape == want[n].shape, n
        off = ~np.isclose(got[n], want[n], rtol=1e-4, atol=1e-6)
        assert off.mean() <= 1e-2 if off.size else True, (n, off.mean())
        assert (np.abs(got[n] - want[n]).max() if off.size else 0.0) <= lr_sum, n
    d = str(tmp_path / "ck")
    ckpt.save(d, 2, state)
    restored, _ = ckpt.restore(d, init_train_state(cfg, seed=9, device=CPU, compress=True))
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch", ["mamba2-370m", "whisper-small"])
def test_launch_train_run_and_resume(arch, tmp_path, capsys):
    """launch.train.run on the reduced config with a selection round, a
    checkpoint, and a resumed run: finite losses, the restored state the
    saved one."""
    d = str(tmp_path / "ck")
    kw = dict(batch=2, seq=32, select_every=2, ckpt_dir=d, ckpt_every=2, device=CPU,
              log_every=1)
    first = train.run(arch, steps=2, **kw)
    assert len(first) == 2 and np.isfinite(first).all()
    saved, _ = ckpt.restore(d, init_train_state(get_config(arch).reduced(), seed=3,
                                                device=CPU))
    resumed = train.run(arch, steps=3, **kw)
    assert len(resumed) == 1 and np.isfinite(resumed).all()
    out = capsys.readouterr().out
    assert "[ckpt] resumed from step 2" in out and "[select] step 2: pool 16 -> coreset 4" in out
    again, meta = ckpt.restore(d, saved, step=2)
    assert meta["step"] == 2
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(saved), tree_leaves(again)))
