"""The port's Mamba2 / SSD mixer (``repro_torch.models.mamba``) against the
JAX package's, on the CPU.

Inputs come from numpy with a seed; the JAX package's parameters are handed
over through ``interop.params_from_arrays``.  Bars (fp32): the causal conv and
``mamba_block`` with and without a state, rtol 1e-5 / atol 1e-6;
``ssd_chunked``'s y, final state and gradients rtol 1e-5 (gradients 1e-4)
and an atol of Q 2^-24 times the largest |value| of the JAX package's
output, Q the longer of the two chunk lengths: each output sums up to Q
terms C·B x dt whose magnitude the largest output bounds here, and an fp32
sum of Q terms is within (Q - 1) 2^-24 of their magnitude of the exact sum
(measured at chunk 32: each package 2.0e-5 from a float64 scan at max |y|
55, the bar 1.0e-4).

The two deliberate differences (ROADMAP queue 3):
- defect 1: at chunk 256 the JAX package's ``dt`` gradient is NaN (its
  acausal ``exp(cum_t - cum_s)`` overflows to inf before ``where`` zeroes it,
  and backward multiplies the zero by inf); the port masks the exponent, so
  its forward is the JAX package's and its gradients at chunk 256 are finite
  and equal to the JAX package's at chunk 32 within the bar above at
  Q = 256 (the chunked scan is one function at any chunk length; the two
  chunkings sum the same terms in other orders, and decays past exp(-103)
  are subnormal or zero in fp32 either way);
- defect 2: with a state and L > 1 the port runs the chunked scan from the
  state (a prefill), equal to the JAX package's chain of single-token
  recurrent steps; the JAX package's own block reads only the first token.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import mamba as jmamba
from repro.models import model as jmodel
from repro_torch.configs.base import get_config
from repro_torch.interop import params_from_arrays
from repro_torch.models import mamba

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=msg)


def _close_ssd(got, want, chunk, rtol=RTOL, msg=""):
    """The SSD bar: ``rtol`` and ``chunk`` 2^-24 times the largest |want|."""
    want = np.asarray(want, np.float32)
    _close(got, want, rtol, chunk * 2.0 ** -24 * float(np.abs(want).max()), msg)


def _ssd_inputs(seed, B=2, L=64, H=4, P=8, N=16, dt_sd=0.6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, H, P)).astype(np.float32)
    dt = np.asarray(jax.nn.softplus(jnp.asarray(rng.normal(0, dt_sd, (B, L, H)), jnp.float32)))
    A = -np.exp(rng.normal(0, 0.5, (H,))).astype(np.float32)
    Bm = rng.normal(size=(B, L, N)).astype(np.float32)
    Cm = rng.normal(size=(B, L, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_the_jax_package(with_state):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 10, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    st = rng.normal(size=(2, 3, 12)).astype(np.float32) if with_state else None
    y, s = mamba._causal_conv(_t(x), _t(w), None if st is None else _t(st))
    jy, js = jmamba._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 None if st is None else jnp.asarray(st))
    _close(y, jy)
    _close(s, js)
    assert s.shape == (2, 3, 12)
    np.testing.assert_array_equal(s.numpy(), x[:, -3:])  # the last W-1 inputs


@pytest.mark.parametrize("L,chunk", [(64, 32), (96, 32), (32, 32), (48, 64)])
def test_ssd_chunked_matches_the_jax_package(L, chunk):
    ins = _ssd_inputs(L, L=L)
    y, S = mamba.ssd_chunked(*map(_t, ins), chunk)
    jy, jS = jmamba.ssd_chunked(*map(jnp.asarray, ins), chunk)
    _close_ssd(y, jy, chunk)
    _close_ssd(S, jS, chunk)


def test_ssd_chunked_from_a_state_continues_the_sequence():
    """The scan over 96 tokens equals the scan over the first 64, then over
    the last 32 from the first's final state; and a length that does not
    divide into chunks (where the JAX package asserts) ends in a partial
    chunk, the same function."""
    ins = _ssd_inputs(4, L=96)
    y, S = mamba.ssd_chunked(*map(_t, ins), 32)
    head = [a[:, :64] if a.ndim > 1 else a for a in ins]
    tail = [a[:, 64:] if a.ndim > 1 else a for a in ins]
    y1, S1 = mamba.ssd_chunked(*map(_t, head), 32)
    y2, S2 = mamba.ssd_chunked(*map(_t, tail), 32, state=S1)
    _close_ssd(torch.cat([y1, y2], 1), y.numpy(), 32)
    _close_ssd(S2, S.numpy(), 32)
    odd = [a[:, :70] if a.ndim > 1 else a for a in ins]
    y3, S3 = mamba.ssd_chunked(*map(_t, odd), 32)
    jy3, jS3 = jmamba.ssd_chunked(*map(jnp.asarray, odd), 70)  # one chunk of 70
    _close_ssd(y3, jy3, 70)
    _close_ssd(S3, jS3, 70)


def _ssd_loss(module, arrays, chunk, wy, ws):
    y, S = module.ssd_chunked(*arrays, chunk)
    return (y * wy).sum() + (S * ws).sum()


def test_ssd_gradients_at_chunk_256_finite_and_equal_to_chunk_32():
    """Defect 1.  B 1, L 256, H 2, P 4, N 4, dt = softplus(N(0, 0.6)), A = -1
    (A_log = 0 at init): the JAX package's forward is fine at chunk 256 but
    its dt gradient is not finite; the port's gradients at 256 are finite
    and equal the JAX package's at 32."""
    rng = np.random.default_rng(7)
    x, dt, _, Bm, Cm = _ssd_inputs(7, B=1, L=256, H=2, P=4, N=4)
    A = -np.ones(2, np.float32)
    wy = rng.normal(size=(1, 256, 2, 4)).astype(np.float32)
    ws = rng.normal(size=(1, 2, 4, 4)).astype(np.float32)
    arrays = (x, dt, A, Bm, Cm)
    jarr = tuple(map(jnp.asarray, arrays))
    # the JAX package: forward equal at both chunkings, dt's gradient NaN at 256
    jgrad = jax.grad(lambda *a: _ssd_loss(jmamba, a, 32, wy, ws), argnums=(0, 1, 3, 4))
    jgrads32 = jgrad(*jarr)
    jgrads256 = jax.grad(lambda *a: _ssd_loss(jmamba, a, 256, wy, ws),
                         argnums=(0, 1, 3, 4))(*jarr)
    assert all(np.isfinite(np.asarray(g)).all() for g in jgrads32)
    assert not np.isfinite(np.asarray(jgrads256[1])).all()  # d dt: the reference's NaN
    # the port at 256: forward the JAX package's, gradients finite and = chunk 32's
    leaves = [_t(a).requires_grad_(i != 2) for i, a in enumerate(arrays)]
    y, S = mamba.ssd_chunked(*leaves, 256)
    jy, jS = jmamba.ssd_chunked(*jarr, 256)
    _close_ssd(y, jy, 256)
    _close_ssd(S, jS, 256)
    loss = (y * _t(wy)).sum() + (S * _t(ws)).sum()
    grads = torch.autograd.grad(loss, [leaves[i] for i in (0, 1, 3, 4)])
    for name, g, jg in zip(("x", "dt", "Bm", "Cm"), grads, jgrads32):
        assert torch.isfinite(g).all(), name
        _close_ssd(g, jg, 256, GRAD_RTOL, name)


@pytest.fixture(scope="module")
def mixer():
    cfg, jcfg = get_config("mamba2-370m").reduced(), jget_config("mamba2-370m").reduced()
    jp = jax.tree.map(lambda a: a[0], jmodel.init_params(jcfg, jax.random.PRNGKey(3))
                      ["layers"]["mixer"])
    rng = np.random.default_rng(3)
    # a live dt_bias / A_log / D, so their paths show
    jp = {**jp, "dt_bias": jnp.asarray(rng.normal(0, 0.5, jp["dt_bias"].shape), jnp.float32),
          "A_log": jnp.asarray(rng.normal(0, 0.5, jp["A_log"].shape), jnp.float32),
          "D": jnp.asarray(rng.normal(1, 0.3, jp["D"].shape), jnp.float32)}
    return cfg, jcfg, params_from_arrays(cfg, jax.tree.map(np.asarray, jp), CPU), jp


def _state(cfg, seed, B=2):
    rng = np.random.default_rng(seed)
    conv = rng.normal(size=(B, cfg.ssm_conv_width - 1, cfg.d_inner + 2 * cfg.ssm_state))
    ssm = rng.normal(size=(B, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)) * 0.3
    return {"conv": conv.astype(np.float32), "ssm": ssm.astype(np.float32)}


def test_mamba_block_without_state(mixer):
    cfg, jcfg, p, jp = mixer
    x = np.random.default_rng(5).normal(size=(2, 64, cfg.d_model)).astype(np.float32)
    out, st = mamba.mamba_block(cfg, p, _t(x))
    jout, jst = jmamba.mamba_block(jcfg, jp, jnp.asarray(x))
    _close(out, jout)
    _close(st["conv"], jst["conv"])
    _close(st["ssm"], jst["ssm"], 1e-5, 1e-5)


def test_mamba_block_single_token_with_state(mixer):
    """The recurrent decode (L == 1) from a non-zero state."""
    cfg, jcfg, p, jp = mixer
    x = np.random.default_rng(6).normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    state = _state(cfg, 6)
    out, st = mamba.mamba_block(cfg, p, _t(x), {k: _t(v) for k, v in state.items()})
    jout, jst = jmamba.mamba_block(jcfg, jp, jnp.asarray(x),
                                   {k: jnp.asarray(v) for k, v in state.items()})
    _close(out, jout)
    _close(st["conv"], jst["conv"])
    _close(st["ssm"], jst["ssm"], 1e-5, 1e-5)


@pytest.mark.parametrize("L", [8, 40])
def test_mamba_block_prefill_from_a_state_equals_the_token_chain(mixer, L):
    """Defect 2 at the block.  With a state and L > 1 the port's block equals
    the JAX package's L single-token steps from that state (outputs and the
    final state); from a zero state it equals the no-state block.  The JAX
    package's own block with a state reads the first token only: it parts
    from the chain."""
    cfg, jcfg, p, jp = mixer
    x = np.random.default_rng(L).normal(size=(2, L, cfg.d_model)).astype(np.float32)
    state = _state(cfg, L)
    out, st = mamba.mamba_block(cfg, p, _t(x), {k: _t(v) for k, v in state.items()})
    jst = {k: jnp.asarray(v) for k, v in state.items()}
    chain = []
    for t in range(L):
        o, jst = jmamba.mamba_block(jcfg, jp, jnp.asarray(x[:, t: t + 1]), jst)
        chain.append(np.asarray(o))
    chain = np.concatenate(chain, axis=1)
    _close(out, chain, 1e-5, 1e-5)
    _close(st["conv"], jst["conv"])
    _close(st["ssm"], jst["ssm"], 1e-5, 1e-5)
    zero = {k: torch.zeros(v.shape) for k, v in state.items()}
    out0, st0 = mamba.mamba_block(cfg, p, _t(x), zero)
    ref0, sref0 = mamba.mamba_block(cfg, p, _t(x))
    _close(out0, ref0.numpy())
    _close(st0["ssm"], sref0["ssm"].numpy(), 1e-5, 1e-5)
    jself, _ = jmamba.mamba_block(jcfg, jp, jnp.asarray(x),
                                  {k: jnp.asarray(v) for k, v in state.items()})
    gap = float(np.abs(np.asarray(jself) - chain).max())
    assert gap > 1e-2 * float(np.abs(chain).max()), gap  # the reference's prefill gap


def test_mamba_block_bf16_cast_order(mixer):
    """bf16 in: dt / A in fp32, the state in fp32, y cast back before the D
    skip; within 2% of the JAX package's output norm."""
    cfg, jcfg, p, jp = mixer
    cfg, jcfg = (dataclasses.replace(c, compute_dtype="bfloat16") for c in (cfg, jcfg))
    x = np.random.default_rng(8).normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    out, st = mamba.mamba_block(cfg, {k: v.to(torch.bfloat16) for k, v in p.items()},
                                _t(x).to(torch.bfloat16))
    jout, jst = jmamba.mamba_block(jcfg, jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp),
                                   jnp.asarray(x, jnp.bfloat16))
    assert out.dtype == torch.bfloat16 and st["ssm"].dtype == torch.float32
    want = np.asarray(jout, np.float32)
    err = np.linalg.norm(out.float().numpy() - want) / np.linalg.norm(want)
    assert err < 2e-2, err
