"""The data pipeline and the training launcher in the port
(``repro_torch.data.pipeline``, ``repro_torch.launch.train``) against the
JAX package's, on the CPU.

- ``SyntheticTokens``: tokens, vlm patches and audio frames bit-equal.
- ``embed_examples`` on the JAX package's parameters: rtol 1e-5 / atol 1e-6.
- ``launch.train.run(device="cpu")`` against the JAX package's ``run()``,
  both starting from the JAX package's state (handed over through
  ``interop``): without selection every step's loss within rtol 1e-5; with
  selection, each round's chosen queue equals the JAX package's up to its
  first parting, which must be a near-tie (each package's top-two gap within
  twice the two packages' largest gain difference, as in
  ``test_torch_selection.py``), recorded in the report; the losses of the
  steps before any parting within rtol 1e-5.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.data import pipeline as jpipeline
from repro.data import selection as jselection
from repro.launch import train as jtrain
from repro.models import model as jmodel
from repro.train import train_step as jtrain_step
from repro_torch.configs.base import get_config
from repro_torch.data import pipeline, selection
from repro_torch.interop import params_from_arrays, train_state_from_arrays
from repro_torch.launch import train

CPU = "cpu"
LOSS_RTOL = 1e-5


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-vl-7b", "whisper-small", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_tokens_bit_equal(arch, seed):
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    data = pipeline.SyntheticTokens(cfg, 48, seed=seed, device=CPU)
    jdata = jpipeline.SyntheticTokens(jcfg, 48, seed=seed)
    idx = [0, 1, 17, 1000, 123457]
    got, want = data.batch(idx), jdata.batch(idx)
    assert sorted(got) == sorted(want)
    for k in got:
        w = np.asarray(want[k])
        assert got[k].device.type == "cpu" and got[k].numpy().dtype == w.dtype, k
        assert np.array_equal(got[k].numpy(), w), k
    assert [data.mode_of(i) for i in idx] == [jdata.mode_of(i) for i in idx]
    first = next(data.stream(3, start=9))["tokens"].numpy()
    assert np.array_equal(first, np.asarray(next(jdata.stream(3, start=9))["tokens"]))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "starcoder2-3b", "qwen2-vl-7b"])
def test_embed_examples_matches_the_jax_package(arch):
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(4))
    params = params_from_arrays(cfg, jax.tree.map(np.asarray, jp), CPU)
    idx = list(range(40, 46))
    want = np.asarray(jpipeline.embed_examples(jcfg, jp, jpipeline.SyntheticTokens(
        jcfg, 32).batch(idx)))
    with torch.inference_mode():
        got = pipeline.embed_examples(cfg, params, pipeline.SyntheticTokens(
            cfg, 32, device=CPU).batch(idx))
    assert got.dtype == torch.float32 and got.shape == (6, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.fixture
def same_start(monkeypatch):
    """Both launchers start from the JAX package's state for the seed; every
    selection both make is recorded with its pool embeddings."""
    def init(cfg, seed=0, device=None, **kw):
        jstate = jtrain_step.init_train_state(jget_config(cfg.name).reduced(),
                                              jax.random.PRNGKey(seed))
        return train_state_from_arrays(cfg, jax.tree.map(np.asarray, jstate), device)

    monkeypatch.setattr(train, "init_train_state", init)
    rounds = {"port": [], "jax": []}
    for key, cls in (("port", selection.SubmodularSelector),
                     ("jax", jselection.SubmodularSelector)):
        plain = cls.select

        def select(self, pool_emb, *a, _plain=plain, _key=key, **kw):
            ids = np.asarray(_plain(self, pool_emb, *a, **kw))
            rounds[_key].append((self, pool_emb, ids))
            return ids

        monkeypatch.setattr(cls, "select", select)
    return rounds


RUN = dict(arch="qwen3-0.6b", steps=6, batch=4, seq=32, log_every=2)


def test_run_without_selection_matches_the_jax_package(same_start, capsys):
    got = train.run(**RUN, device=CPU)
    want = jtrain.run(**RUN)
    assert len(got) == len(want) == RUN["steps"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    out = capsys.readouterr().out
    assert out.count("step     2  loss") == 2  # the same log lines from both


def _parting(rnd, jrnd):
    """First step where the two queues part (None if they never do), after
    checking it is a near-tie on each package's own kernel."""
    (sel, emb, got), (jsel, jemb, want) = rnd, jrnd
    parted = np.nonzero(got != want)[0]
    if not parted.size:
        return None
    t = int(parted[0])
    fn, jfn = sel.build_function(emb), jsel.build_function(jemb)
    state, jstate = fn.init_state(), jfn.init_state()
    for j in got[:t]:
        state, jstate = fn.update(state, torch.tensor([int(j)])), jfn.update(jstate, int(j))
    g, jg = fn.gains(state).numpy(), np.asarray(jfn.gains(jstate))
    spread = float(np.max(np.abs(g - jg)))
    a, b = int(got[t]), int(want[t])
    gaps = (float(g[a] - g[b]), float(jg[b] - jg[a]))
    assert all(0.0 <= gap <= 2 * spread for gap in gaps), (t, gaps, spread)
    return {"step": t, "port_pick": a, "jax_pick": b, "top_two_gap": gaps,
            "gain_spread": spread}


def test_run_with_selection_matches_the_jax_package(same_start, request, tmp_path):
    """Two selection rounds (pool 32 -> coreset 8): each round's queue equals
    the JAX package's up to a near-tie; while the queues agree the losses do
    too."""
    kw = dict(RUN, select_every=2)
    got = train.run(**kw, device=CPU)
    want = jtrain.run(**kw)
    rounds = same_start
    assert len(rounds["port"]) == len(rounds["jax"]) == 3
    agree_steps = 0
    for i, (rnd, jrnd) in enumerate(zip(rounds["port"], rounds["jax"])):
        assert rnd[2].shape == jrnd[2].shape == (8,)
        np.testing.assert_allclose(rnd[1].numpy(), np.asarray(jrnd[1]), rtol=1e-5, atol=1e-5)
        parting = _parting(rnd, jrnd)
        if parting is not None:
            request.node.user_properties.append(("first_parting", {"round": i, **parting}))
            print("first parting:", {"round": i, **parting})
            agree_steps += parting["step"] // kw["batch"]
            break
        agree_steps += 2
    np.testing.assert_allclose(got[:agree_steps], want[:agree_steps], rtol=LOSS_RTOL)
    assert np.isfinite(got).all() and len(got) == kw["steps"]


def test_run_checkpoints_and_resumes(tmp_path, capsys):
    """A run saves at every ckpt_every steps; a second run resumes from the
    latest step, restoring the saved state, and runs the remaining steps."""
    d = str(tmp_path / "ck")
    first = train.run("qwen3-0.6b", steps=4, batch=2, seq=16, ckpt_dir=d, ckpt_every=2,
                      device=CPU)
    from repro_torch.ckpt import checkpoint as ckpt

    assert ckpt.latest_step(d) == 4 and len(first) == 4
    resumed = train.run("qwen3-0.6b", steps=6, batch=2, seq=16, ckpt_dir=d, ckpt_every=2,
                        device=CPU, log_every=1)
    assert len(resumed) == 2 and np.isfinite(resumed).all()
    out = capsys.readouterr().out
    assert "[ckpt] resumed from step 4" in out and "step     5  loss" in out
    assert ckpt.latest_step(d) == 6


def test_cli_runs_on_the_cpu(capsys):
    train.main(["--arch", "qwen2-vl-7b", "--steps", "2", "--batch", "2", "--seq", "16",
                "--select-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[select] step 0: pool 8 -> coreset 2" in out
