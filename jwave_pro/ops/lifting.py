"""Lifting-scheme transforms: CDF 5/3 (LeGall) and CDF 9/7 (JPEG2000).

The reference ships tap tables for these (``other/CDF53.java``,
``other/CDF97.java``) but its builder *refuses to construct them* — the
odd tap counts don't fit its stride-2 convolution algorithm
(``WaveletBuilder.java:363-385`` throws).  Here they run properly via the
lifting scheme (predict/update steps on even/odd polyphase components with
periodic boundaries) — pure elementwise adds/rolls, in-place-friendly, and exactly
invertible by reversing the steps.

Layout matches the FWT convention: ``[approx | detail]`` halves on the
prefix, multi-level on the shrinking approximation.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.validation import check_power_of_two, exponent

__all__ = ["cdf53", "icdf53", "cdf97", "icdf97", "lifting_fwt",
           "lifting_ifwt"]

# JPEG2000 9/7 lifting constants (Daubechies–Sweldens factorization)
_A = -1.5861343420693648
_B = -0.05298011857296141
_G = 0.8829110755411875
_D = 0.44350685204397454
_K = 1.2301741049140097


def _split(x):
    return x[..., 0::2], x[..., 1::2]


def _merge(e, o):
    out = jnp.stack([e, o], axis=-1)
    return out.reshape(e.shape[:-1] + (2 * e.shape[-1],))


def _cdf53_step(x):
    e, o = _split(x)
    # predict: d[i] = o[i] − ½(e[i] + e[i+1]);  periodic wrap
    d = o - 0.5 * (e + jnp.roll(e, -1, axis=-1))
    # update: s[i] = e[i] + ¼(d[i−1] + d[i])
    s = e + 0.25 * (jnp.roll(d, 1, axis=-1) + d)
    return jnp.concatenate([s, d], axis=-1)


def _icdf53_step(y):
    half = y.shape[-1] // 2
    s, d = y[..., :half], y[..., half:]
    e = s - 0.25 * (jnp.roll(d, 1, axis=-1) + d)
    o = d + 0.5 * (e + jnp.roll(e, -1, axis=-1))
    return _merge(e, o)


def _cdf97_step(x):
    e, o = _split(x)
    d = o + _A * (e + jnp.roll(e, -1, axis=-1))
    s = e + _B * (jnp.roll(d, 1, axis=-1) + d)
    d = d + _G * (s + jnp.roll(s, -1, axis=-1))
    s = s + _D * (jnp.roll(d, 1, axis=-1) + d)
    return jnp.concatenate([_K * s, d / _K], axis=-1)


def _icdf97_step(y):
    half = y.shape[-1] // 2
    s, d = y[..., :half] / _K, y[..., half:] * _K
    s = s - _D * (jnp.roll(d, 1, axis=-1) + d)
    d = d - _G * (s + jnp.roll(s, -1, axis=-1))
    e = s - _B * (jnp.roll(d, 1, axis=-1) + d)
    o = d - _A * (e + jnp.roll(e, -1, axis=-1))
    return _merge(e, o)


_STEPS = {"cdf53": (_cdf53_step, _icdf53_step),
          "cdf97": (_cdf97_step, _icdf97_step)}


def lifting_fwt(x: jax.Array, scheme: str = "cdf97", level=None) -> jax.Array:
    """Multi-level lifting pyramid on the last axis (power-of-2 length)."""
    x = jnp.asarray(x)
    n = x.shape[-1]
    check_power_of_two(n)
    fwd, _ = _STEPS[scheme]
    level = exponent(n) if level is None else level
    h = n
    lvl = 0
    while h >= 2 and lvl < level:
        head = fwd(x[..., :h])
        x = jnp.concatenate([head, x[..., h:]], axis=-1) if h < n else head
        h //= 2
        lvl += 1
    return x


def lifting_ifwt(y: jax.Array, scheme: str = "cdf97", level=None) -> jax.Array:
    y = jnp.asarray(y)
    n = y.shape[-1]
    check_power_of_two(n)
    _, inv = _STEPS[scheme]
    level = exponent(n) if level is None else level
    widths = []
    h = n
    lvl = 0
    while h >= 2 and lvl < level:
        widths.append(h)
        h //= 2
        lvl += 1
    for h in reversed(widths):
        head = inv(y[..., :h])
        y = jnp.concatenate([head, y[..., h:]], axis=-1) if h < n else head
    return y


def cdf53(x, level=None):
    """CDF 5/3 (LeGall) forward lifting transform."""
    return lifting_fwt(x, "cdf53", level)


def icdf53(y, level=None):
    return lifting_ifwt(y, "cdf53", level)


def cdf97(x, level=None):
    """CDF 9/7 (JPEG2000 irreversible) forward lifting transform."""
    return lifting_fwt(x, "cdf97", level)


def icdf97(y, level=None):
    return lifting_ifwt(y, "cdf97", level)
