"""The JAX package's fp32 ``exp`` and ``log``, bit for bit, on any device.

The streaming optimizers decide with fp32 ladders: SieveStreaming's rung
window is ``ceil(log(m) / log1p(eps))`` and its rung values
``exp(rung * log1p(eps))``, ThresholdGreedy's thresholds ``d *
exp((l - 1) * log1p(-eps))``.  XLA on the CPU evaluates ``exp`` and
``log`` with Cephes polynomials whose multiply-adds are fused, and neither
agrees with torch's ``exp`` / ``log`` (nor with the correctly rounded
values) in the last bit for every input: about 6% of the rung values part.
So the port evaluates the same polynomials with the same fused
multiply-adds.  A fused multiply-add of fp32 values is formed in fp64 (the
product is exact there), rounded to odd, then to fp32: that is the single
rounding of ``a * b + c``, on the CPU and the card alike.  A division by a
Python constant is XLA's multiplication by the fp32 reciprocal
(:func:`recip32`), and XLA flushes subnormal results to zero.
"""
from __future__ import annotations

import numpy as np
import torch

_F32 = np.float32

# exp: n = floor(x log2(e) + 1/2), a = x - n ln 2 in two parts, e^a by a
# degree-5 polynomial, times 2^n
_EXP_LO, _EXP_HI = _F32(-87.8), _F32(88.8)
_LOG2E = _F32(1.44269504088896341)
_LN2_HI, _LN2_LO = _F32(0.693359375), _F32(-2.12194440e-4)
_EXP_P = tuple(_F32(p) for p in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1,
))
# log: x = 2^e * f with f in [sqrt(1/2), sqrt(2)), log(f) by a degree-8
# polynomial in three parts, plus e ln 2 in two parts
_SQRT_HALF = _F32(0.707106781186547524)
_LOG_P = tuple(_F32(p) for p in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1,
))
_MIN_NORMAL = np.array(0x00800000, np.int32).view(_F32)


def recip32(c: float) -> float:
    """The fp32 reciprocal of the fp32 constant ``c``: XLA turns ``x / c``
    into ``x * recip32(c)``."""
    return float(_F32(1.0) / _F32(c))


def _c(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def fma32(a, b, c) -> torch.Tensor:
    """fp32 ``a * b + c`` rounded once, as a fused multiply-add rounds it.

    The fp64 product of two fp32 values is exact; the fp64 sum is rounded
    to odd (its lowest bit set when inexact, after stepping toward zero if
    it was rounded away), and rounding that to fp32 is the correctly
    rounded fp32 result (fp64 carries more than two extra bits)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    t = s - p  # two-sum: err is exactly (p + c) - s
    err = (p - (s - t)) + (c - t)
    bits = s.view(torch.int64)
    inexact = err != 0
    bits = bits - (inexact & ((err < 0) != (s < 0))).to(torch.int64)
    bits = torch.where(inexact, bits | 1, bits)
    return bits.view(torch.float64).to(torch.float32)


def exp32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``exp`` of an fp32 tensor, as XLA on the CPU evaluates it."""
    x = torch.clamp(x, _c(_EXP_LO, x), _c(_EXP_HI, x))
    n = torch.floor(fma32(x, _c(_LOG2E, x), _c(0.5, x)))
    n = torch.clamp(n, _c(-127.0, x), _c(127.0, x))
    a = fma32(_c(-_LN2_HI, x), n, x)
    a = fma32(_c(-_LN2_LO, x), n, a)
    z = fma32(a, _c(_EXP_P[0], x), _c(_EXP_P[1], x))
    for p in _EXP_P[2:]:
        z = fma32(z, a, _c(p, x))
    z = fma32(z, a * a, a)
    z = 1.0 + z
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    out = z * pow2
    # XLA runs with subnormals flushed to zero
    return torch.where(out < _c(_MIN_NORMAL, x), 0.0, out)


def log32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``log`` of an fp32 tensor, as XLA on the CPU evaluates it, for
    positive finite inputs; others take ``torch.log``, a subnormal read as
    zero (the ladders pass neither)."""
    f = torch.maximum(x, _c(_MIN_NORMAL, x))
    bits = f.view(torch.int32)
    e = 1.0 + ((bits >> 23) - 127).to(torch.float32)
    f = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = f < _c(_SQRT_HALF, x)
    lift = torch.where(small, f, 0.0)
    f = f - 1.0
    e = e - small.to(torch.float32)
    f = f + lift
    f2 = f * f
    f3 = f2 * f
    P = [_c(p, x) for p in _LOG_P]
    y = fma32(f, P[0], P[1])
    y1 = fma32(f, P[3], P[4])
    y2 = fma32(f, P[6], P[7])
    y = fma32(y, f, P[2])
    y1 = fma32(y1, f, P[5])
    y2 = fma32(y2, f, P[8])
    y = fma32(y, f3, y1)
    y = fma32(y, f3, y2)
    y = fma32(y, f3, _c(_LN2_LO, x) * e)
    out = fma32(_c(-0.5, x), f2, f)
    out = out + y
    out = fma32(_c(_LN2_HI, x), e, out)
    normal = _c(_MIN_NORMAL, x)
    ok = (x >= normal) & torch.isfinite(x)
    return torch.where(ok, out, torch.log(torch.where((x > 0) & (x < normal), 0.0, x)))
