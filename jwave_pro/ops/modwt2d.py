"""2D/3D separable MODWT (undecimated wavelet transform for images/volumes).

Beyond the reference's scope (its MODWT is 1D-only, SURVEY §2.1) but the
natural extension: per level j the à-trous filter pair runs along rows
then columns (then depth for 3D), producing full-resolution detail bands and
an approximation that feeds the next level — all batched convolutions.

Band-letter convention (consistent across 2D and 3D): letters read in the
same order as the printed shape — (row, col) for 2D, (depth, row, col) for
3D — with L applying the scaling filter g and H the wavelet filter h along
that axis.  ``modwt2`` returns ``(3·level+1, ..., R, C)``: rows
``3(j−1) .. 3(j−1)+2`` are (LH_j, HL_j, HH_j) — (g@rows·h@cols,
h@rows·g@cols, h@rows·h@cols) — and the last row is LL_J.
``modwt3`` returns ``(7·level+1, ..., D, R, C)``: rows ``7(j−1)..7(j−1)+6``
are the detail octants in increasing binary order of the letter string
(LLH, LHL, LHH, HLL, HLH, HHL, HHH), and the final row is LLL_J.
Perfect reconstruction follows per axis from the 1D identity
``Conv_gᵀConv_g + Conv_hᵀConv_h = I`` (the √2-normalized MODWT filter bank).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..wavelets.base import DiscreteWavelet
from .modwt import (MAX_DECOMPOSITION_LEVEL, _combined_adjoint,
                    _conv_channels, modwt_base_filters)

__all__ = ["modwt2", "imodwt2", "modwt2_mra", "modwt3", "imodwt3",
           "modwt3_mra"]


def _conv_last(x, f, d, adjoint):
    """Dilated circular conv with one filter along the last axis."""
    return _conv_channels(x, (f,), d, adjoint)[..., 0, :]


def _conv_axis(x, f, d, axis, adjoint=False):
    """Dilated circular conv along ``axis`` (transpose to the last axis,
    shared-roll kernel, transpose back).  Whether rolling the axis in place
    is faster on the H100 is not yet measured (PERF.md)."""
    if axis in (-1, x.ndim - 1):
        return _conv_last(x, f, d, adjoint)
    xt = jnp.swapaxes(x, -1, axis)
    return jnp.swapaxes(_conv_last(xt, f, d, adjoint), -1, axis)


def _conv_axis_pair(x, g, h, d, axis, adjoint=False):
    """(x⋆g, x⋆h) along ``axis`` sharing the rolled copies (rides the
    2-channel path of :func:`..modwt._conv_channels`; one transpose pair
    serves both filters)."""
    if axis in (-1, x.ndim - 1):
        out = _conv_channels(x, (g, h), d, adjoint)
        return out[..., 0, :], out[..., 1, :]
    xt = jnp.swapaxes(x, -1, axis)
    out = _conv_channels(xt, (g, h), d, adjoint)
    return (jnp.swapaxes(out[..., 0, :], -1, axis),
            jnp.swapaxes(out[..., 1, :], -1, axis))


def _combined_adjoint_axis(v, w, g, h, d, axis):
    """Σ_k roll(g[k]·v + h[k]·w, −k·d) along ``axis`` (transposed to the
    lane axis — see :func:`_conv_axis`'s measurement note)."""
    if axis in (-1, v.ndim - 1):
        return _combined_adjoint(v, w, g, h, d)
    vt = jnp.swapaxes(v, -1, axis)
    wt = jnp.swapaxes(w, -1, axis)
    return jnp.swapaxes(_combined_adjoint(vt, wt, g, h, d), -1, axis)


def _conv_cols(x, f, d, adjoint):
    """Dilated circular conv along the second-to-last axis."""
    return _conv_axis(x, f, d, -2, adjoint)


def _check_nd(dims, level):
    if level < 1 or level > MAX_DECOMPOSITION_LEVEL:
        raise ValueError(f"level must be in [1, {MAX_DECOMPOSITION_LEVEL}]")
    theo = min(d.bit_length() for d in dims) - 1
    if level > theo:
        raise ValueError(f"level {level} exceeds theoretical limit {theo} "
                         f"for shape {tuple(dims)}")


def modwt2(x: jax.Array, wavelet: DiscreteWavelet, level: int,
           method: str = "auto") -> jax.Array:
    """Forward 2D MODWT over the last two axes (any sizes).

    ``method``: 'auto' or 'direct' (both the XLA separable path).
    """
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.integer):
        x = x.astype(jnp.float32)
    _check_nd(x.shape[-2:], level)
    if method not in ("auto", "direct"):
        raise ValueError(f"unknown method {method!r}")
    g64, h64 = modwt_base_filters(wavelet)
    g = jnp.asarray(g64, dtype=x.dtype)
    h = jnp.asarray(h64, dtype=x.dtype)
    rows = []
    ll = x
    for j in range(1, level + 1):
        d = 1 << (j - 1)
        cl, ch = _conv_axis_pair(ll, g, h, d, -1)   # col pass (last axis)
        ll, hl = _conv_axis_pair(cl, g, h, d, -2)   # row pass, shared rolls
        lh, hh = _conv_axis_pair(ch, g, h, d, -2)
        rows.extend([lh, hl, hh])
    rows.append(ll)
    return jnp.stack(rows, axis=0)


def imodwt2(coeffs: jax.Array, wavelet: DiscreteWavelet,
            method: str = "auto") -> jax.Array:
    """Inverse 2D MODWT: ``(3·level+1, ..., R, C)`` → ``(..., R, C)``.

    ``method`` as in :func:`modwt2`.
    """
    coeffs = jnp.asarray(coeffs)
    if coeffs.shape[0] % 3 != 1:
        raise ValueError(
            f"2D MODWT coefficient stack must have 3·level+1 rows, got "
            f"{coeffs.shape[0]}")
    level = (coeffs.shape[0] - 1) // 3
    if method not in ("auto", "direct"):
        raise ValueError(f"unknown method {method!r}")
    g64, h64 = modwt_base_filters(wavelet)
    g = jnp.asarray(g64, dtype=coeffs.dtype)
    h = jnp.asarray(h64, dtype=coeffs.dtype)
    ll = coeffs[3 * level]
    for j in range(level, 0, -1):
        d = 1 << (j - 1)
        lh = coeffs[3 * (j - 1)]
        hl = coeffs[3 * (j - 1) + 1]
        hh = coeffs[3 * (j - 1) + 2]

        cl = _combined_adjoint_axis(ll, hl, g, h, d, -2)
        ch = _combined_adjoint_axis(lh, hh, g, h, d, -2)
        ll = _combined_adjoint_axis(cl, ch, g, h, d, -1)
    return ll


def modwt2_mra(x: jax.Array, wavelet: DiscreteWavelet, level: int) -> jax.Array:
    """Additive 2D MRA: per-band components summing to the image."""
    c = modwt2(x, wavelet, level)
    comps = []
    zeros = jnp.zeros_like(c)
    for i in range(c.shape[0]):
        comps.append(imodwt2(zeros.at[i].set(c[i]), wavelet))
    return jnp.stack(comps, axis=0)


def _conv_depth(x, f, d, adjoint):
    """Dilated circular conv along the third-to-last axis."""
    return _conv_axis(x, f, d, -3, adjoint)


def modwt3(x: jax.Array, wavelet: DiscreteWavelet, level: int,
           method: str = "auto") -> jax.Array:
    """Forward 3D MODWT over the last three axes (any sizes).

    Separable octant cascade — the undecimated analog of the reference's
    3D dispatch pattern (``BasicTransform.java:509-566``), with the à-trous
    level-j filters applied along cols, rows, then depth.

    ``method``: 'auto' or 'direct' (both the XLA separable path).
    """
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.integer):
        x = x.astype(jnp.float32)
    _check_nd(x.shape[-3:], level)
    if method not in ("auto", "direct"):
        raise ValueError(f"unknown method {method!r}")
    g64, h64 = modwt_base_filters(wavelet)
    g = jnp.asarray(g64, dtype=x.dtype)
    h = jnp.asarray(h64, dtype=x.dtype)
    rows = []
    lll = x
    for j in range(1, level + 1):
        d = 1 << (j - 1)
        cl, ch = _conv_axis_pair(lll, g, h, d, -1)    # col pass
        rll, rhl = _conv_axis_pair(cl, g, h, d, -2)   # row pass
        rlh, rhh = _conv_axis_pair(ch, g, h, d, -2)
        # depth pass: order (depth, row, col) = (b2, b1, b0) binary octants
        lll, hll = _conv_axis_pair(rll, g, h, d, -3)
        llh, hlh = _conv_axis_pair(rlh, g, h, d, -3)
        lhl, hhl = _conv_axis_pair(rhl, g, h, d, -3)
        lhh, hhh = _conv_axis_pair(rhh, g, h, d, -3)
        rows.extend([llh, lhl, lhh, hll, hlh, hhl, hhh])
    rows.append(lll)
    return jnp.stack(rows, axis=0)


def imodwt3(coeffs: jax.Array, wavelet: DiscreteWavelet,
            method: str = "auto") -> jax.Array:
    """Inverse 3D MODWT: ``(7·level+1, ..., D, R, C)`` → ``(..., D, R, C)``.

    ``method`` as in :func:`modwt3`.
    """
    coeffs = jnp.asarray(coeffs)
    if coeffs.shape[0] % 7 != 1:
        raise ValueError(
            f"3D MODWT coefficient stack must have 7·level+1 rows, got "
            f"{coeffs.shape[0]}")
    level = (coeffs.shape[0] - 1) // 7
    if method not in ("auto", "direct"):
        raise ValueError(f"unknown method {method!r}")
    g64, h64 = modwt_base_filters(wavelet)
    g = jnp.asarray(g64, dtype=coeffs.dtype)
    h = jnp.asarray(h64, dtype=coeffs.dtype)
    lll = coeffs[7 * level]
    for j in range(level, 0, -1):
        d = 1 << (j - 1)
        llh, lhl, lhh, hll, hlh, hhl, hhh = (
            coeffs[7 * (j - 1) + k] for k in range(7))
        # undo depth pass per (row, col) quadrant
        rll = _combined_adjoint_axis(lll, hll, g, h, d, -3)
        rlh = _combined_adjoint_axis(llh, hlh, g, h, d, -3)
        rhl = _combined_adjoint_axis(lhl, hhl, g, h, d, -3)
        rhh = _combined_adjoint_axis(lhh, hhh, g, h, d, -3)
        # undo row pass per col band
        cl = _combined_adjoint_axis(rll, rhl, g, h, d, -2)
        ch = _combined_adjoint_axis(rlh, rhh, g, h, d, -2)
        # undo col pass
        lll = _combined_adjoint_axis(cl, ch, g, h, d, -1)
    return lll


def modwt3_mra(x: jax.Array, wavelet: DiscreteWavelet, level: int) -> jax.Array:
    """Additive 3D MRA: per-band components summing to the volume."""
    c = modwt3(x, wavelet, level)
    comps = []
    zeros = jnp.zeros_like(c)
    for i in range(c.shape[0]):
        comps.append(imodwt3(zeros.at[i].set(c[i]), wavelet))
    return jnp.stack(comps, axis=0)
