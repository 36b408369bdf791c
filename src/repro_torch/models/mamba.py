"""Mamba2 / SSD (state-space duality) block [arXiv:2405.21060] (the JAX
package's ``models/mamba.py``).

The chunked SSD algorithm maps the selective scan onto matmuls instead of a
length-L sequential scan:
- intra-chunk: a (Q, Q) causal "attention-like" product per chunk;
- inter-chunk: a loop over the chunks carrying the (H, P, N) state.

Decode is the O(1) recurrent update  S <- dA * S + dt * (B ⊗ x),
y = C · S + D * x.  Single B / C group (n_groups = 1), heads
H = d_inner / ssm_head_dim.

Two deliberate differences from the JAX package (ROADMAP queue 3):
- ``ssd_chunked`` masks the exponent, ``exp(where(causal, cum_t - cum_s,
  -inf))``, not the exponential: the forward is the same, and the
  gradients stay finite where an acausal ``cum_t - cum_s`` overflows fp32
  (a chunk of 256 at init), which gives the JAX package NaN through ``dt``;
- ``mamba_block`` with a ``state`` and L > 1 (a prefill) runs the chunked
  scan over its L tokens from that state and returns the scan's final
  state; the JAX package's recurrent branch reads the first token only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.act_sharding import constrain, whole_tokens
from repro_torch.models.layers import rms_norm


def _split_proj(cfg: ArchConfig, z_x_b_c_dt: torch.Tensor):
    di, N = cfg.d_inner, cfg.ssm_state
    rest = z_x_b_c_dt.shape[-1] - 2 * di - 2 * N
    z, x, B, C, dt = torch.split(z_x_b_c_dt, [di, di, N, N, rest], dim=-1)
    return z, x, B, C, dt  # dt: (B, L, H)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state: torch.Tensor | None = None):
    """Depthwise causal conv, x (B, L, C), w (W, C).  Returns (y, new_state)
    where state is the last W-1 inputs for streaming decode."""
    W = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, L+W-1, C)
    y = sum(xp[:, i: i + x.shape[1]] * w[i].to(x.dtype) for i in range(W))
    new_state = xp[:, -(W - 1):] if W > 1 else pad
    return F.silu(y), new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, state: torch.Tensor | None = None):
    """Chunked SSD scan.

    x (B, L, H, P)   dt (B, L, H)  [post-softplus]
    A (H,) negative  Bm, Cm (B, L, N)
    state (B, H, P, N) or None (zeros): the state before the first token.
    Returns y (B, L, H, P) and the final state (B, H, P, N).  A length past
    ``chunk`` that does not divide into chunks (where the JAX package
    asserts) ends in a partial chunk.
    """
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    pad = (-L) % Q
    if pad:
        # tokens with dt = 0 neither decay the state nor add to it: the
        # outputs at the real positions and the final state are unchanged
        x, Bm, Cm = (F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad)) for t in (x, Bm, Cm))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = (L + pad) // Q

    xr = x.reshape(Bsz, nc, Q, H, P)
    dtr = dt.reshape(Bsz, nc, Q, H)
    Br = Bm.reshape(Bsz, nc, Q, N)
    Cr = Cm.reshape(Bsz, nc, Q, N)

    dA = dtr * A  # (B, nc, Q, H), negative
    cum = torch.cumsum(dA, dim=2)  # within-chunk cumulative log-decay
    total = cum[:, :, -1]  # (B, nc, H)

    # intra-chunk (causal quadratic form): M[t,s] = C_t·B_s * exp(cum_t - cum_s) * dt_s
    CB = torch.einsum("bnqm,bnsm->bnqs", Cr, Br)  # (B, nc, Q, Q)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, Q, Q, H)
    decay = torch.exp(torch.where(causal[None, None, :, :, None], seg, -torch.inf))
    M = CB[..., None] * decay
    y_intra = torch.einsum("bnqsh,bnshp->bnqhp", M * dtr[:, :, None], xr)

    # chunk summaries: S_n = sum_s exp(total - cum_s) dt_s B_s ⊗ x_s
    w_state = torch.exp(total[:, :, None, :] - cum) * dtr  # (B, nc, Q, H)
    S_chunk = torch.einsum("bnqhp,bnqm->bnhpm", w_state[..., None] * xr, Br)

    # inter-chunk recurrence over chunk states, in chunk order
    S = torch.zeros((Bsz, H, P, N), dtype=x.dtype, device=x.device) if state is None else state
    S_prevs = []
    for c in range(nc):
        S_prevs.append(S)
        S = S * torch.exp(total[:, c])[:, :, None, None] + S_chunk[:, c]
    S_prevs = torch.stack(S_prevs, dim=1)  # (B, nc, H, P, N)

    # inter-chunk contribution: y_t += C_t · (exp(cum_t) * S_prev)
    y_inter = torch.einsum("bnqm,bnhpm->bnqhp", Cr, S_prevs) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, L + pad, H, P)
    return y[:, :L], S


def mamba_block(cfg: ArchConfig, params: dict, x: torch.Tensor, state: dict | None = None):
    """Full Mamba2 mixer.  x (B, L, D).  ``state`` enables streaming:
    {"conv": (B, W-1, conv_ch), "ssm": (B, H, P, N)}; with L > 1 the
    chunked scan runs from it, with L == 1 the recurrent update."""
    x = whole_tokens(x)
    B, L, D = x.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    dt_ = x.dtype

    zxbcdt = x @ params["in_proj"].to(dt_)
    z, xs, Bm, Cm, dt = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv_out, conv_state = _causal_conv(conv_in, params["conv_w"],
                                        None if state is None else state["conv"])
    xs, Bm, Cm = torch.split(conv_out, [di, N, N], dim=-1)
    dt = _softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())  # (H,)
    xh = xs.reshape(B, L, H, P)
    xh = constrain(xh, ("dp", None, "tp", None))  # SSM heads carry TP

    if state is None or L > 1:
        y, S = ssd_chunked(xh.float(), dt, A, Bm.float(), Cm.float(), cfg.ssm_chunk,
                           None if state is None else state["ssm"].float())
    else:
        # recurrent decode (L == 1)
        S = state["ssm"].float()  # (B, H, P, N)
        dA = torch.exp(dt[:, 0] * A)  # (B, H)
        inc = torch.einsum("bh,bm,bhp->bhpm", dt[:, 0], Bm[:, 0].float(), xh[:, 0].float())
        S = S * dA[:, :, None, None] + inc
        y = torch.einsum("bm,bhpm->bhp", Cm[:, 0].float(), S)[:, None]
    new_state = {"conv": conv_state, "ssm": S}

    y = y.to(dt_) + xh * params["D"].to(dt_)[None, None, :, None]
    y = y.reshape(B, L, di)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)  # gated norm
    return y @ params["out_proj"].to(dt_), new_state
