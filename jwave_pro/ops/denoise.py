"""Wavelet denoising: soft/hard thresholding + MODWT denoise pipeline.

The reference demonstrates MODWT soft-threshold denoising in
``jwave/examples/MODWTExample.java:125-172`` (universal threshold
σ·√(2·ln N) with σ estimated from level-1 detail coefficients via
MAD/0.6745, soft-shrink details, keep approximation, inverse).  Implemented
here as library functions that jit and batch.
"""
from __future__ import annotations

import functools
import math

import numpy as np

import jax
import jax.numpy as jnp

from ..wavelets.base import DiscreteWavelet
from .modwt import _check_level, imodwt, modwt

__all__ = [
    "soft_threshold", "hard_threshold", "universal_threshold",
    "sure_threshold", "bayes_threshold",
    "mad_sigma", "modwt_denoise", "modwt_denoise_inplace",
    "modwt2_denoise", "modwt3_denoise", "wpt_denoise", "wpt2_denoise",
]


def soft_threshold(c: jax.Array, t) -> jax.Array:
    """sign(c)·max(|c|−t, 0)."""
    c = jnp.asarray(c)
    return jnp.sign(c) * jnp.maximum(jnp.abs(c) - t, 0.0)


def hard_threshold(c: jax.Array, t) -> jax.Array:
    """c·1[|c|>t]."""
    c = jnp.asarray(c)
    return jnp.where(jnp.abs(c) > t, c, 0.0).astype(c.dtype)


def mad_sigma(d: jax.Array, axis=-1) -> jax.Array:
    """Robust noise estimate σ = median(|d|)/0.6745."""
    return jnp.median(jnp.abs(d), axis=axis) / 0.6745


def universal_threshold(d: jax.Array, n: int | None = None, axis=-1) -> jax.Array:
    """Donoho–Johnstone universal threshold σ·√(2·ln N)."""
    if n is None:
        n = d.shape[axis]
    return mad_sigma(d, axis=axis) * math.sqrt(2.0 * math.log(n))


def sure_threshold(d: jax.Array, sigma=None, axis=-1) -> jax.Array:
    """SURE-optimal soft threshold (SureShrink, Donoho–Johnstone 1995).

    Minimizes Stein's unbiased risk estimate
    ``SURE(t) = N − 2·#{|d|≤t} + Σ min(|d|, t)²`` over candidate thresholds
    (taken, as in the classical algorithm, at the sorted ``|d|/σ`` values),
    with the sparse-case safeguard: when the coefficients' energy is below
    the ``log₂(N)^{3/2}/√N`` sparsity bound, SURE is unreliable and the
    universal threshold is used instead (the "hybrid" scheme).

    All candidate evaluation is a fixed-shape cumulative sum over the sorted
    magnitudes, so the estimator jits and batches (reduction over ``axis``).
    Returns the threshold on the original (unnormalized) coefficient scale.
    """
    d = jnp.asarray(d)
    if sigma is None:
        sigma = mad_sigma(d, axis=axis)
    n = d.shape[axis]
    y = jnp.moveaxis(d, axis, -1) / jnp.expand_dims(jnp.asarray(sigma), -1)
    a = jnp.sort(jnp.abs(y), axis=-1)          # candidates t = a[k]
    a2 = a * a
    csum = jnp.cumsum(a2, axis=-1)
    k = jnp.arange(1, n + 1, dtype=a.dtype)
    # risk at t=a[k-1]: N − 2k + (cum energy below t) + (n−k)·t²
    risk = (n - 2.0 * k) + csum + (n - k) * a2
    t_sure = jnp.take_along_axis(a, jnp.argmin(risk, axis=-1)[..., None],
                                 axis=-1)[..., 0]
    # hybrid safeguard: sparse signals → universal threshold
    t_univ = math.sqrt(2.0 * math.log(n))
    energy = (csum[..., -1] - n) / n
    bound = (math.log2(n) ** 1.5) / math.sqrt(n)
    t = jnp.where(energy <= bound, t_univ, jnp.minimum(t_sure, t_univ))
    return t * jnp.asarray(sigma)


def bayes_threshold(d: jax.Array, sigma, axis=-1) -> jax.Array:
    """BayesShrink threshold σ²/σ̂ₓ (Chang–Yu–Vetterli 2000).

    ``σ`` is the noise scale (estimate it once from the finest detail level
    via :func:`mad_sigma`); the signal scale is
    ``σ̂ₓ = √max(mean(d²) − σ², 0)`` per band.  When the band is all noise
    (σ̂ₓ = 0) the threshold degenerates to max|d| (kill the band).
    """
    d = jnp.asarray(d)
    sigma = jnp.asarray(sigma)
    var_y = jnp.mean(d * d, axis=axis)
    sig_x = jnp.sqrt(jnp.maximum(var_y - sigma**2, 0.0))
    dmax = jnp.max(jnp.abs(d), axis=axis)
    return jnp.where(sig_x > 0.0, sigma**2 / jnp.where(sig_x > 0, sig_x, 1.0),
                     dmax)


def _fused_threshold(x, wavelet, level, threshold):
    """The per-(level, signal) threshold table the fused kernel takes, or
    None where the requested rule needs the coefficient rows themselves
    ('sure', 'bayes') or the array threshold varies along N."""
    batch = x.shape[:-1]
    if threshold is None or isinstance(threshold, str):
        if threshold not in (None, "universal"):
            return None
        # the universal rule's median is a global statistic of W_1, so it
        # costs one single-level XLA pass before the kernel
        w1 = modwt(x, wavelet, 1, "direct")[0]
        return universal_threshold(w1, x.shape[-1])
    shape = jnp.shape(threshold)
    if shape and shape[-1] != 1:
        return None
    try:
        target = np.broadcast_shapes(shape, (level,) + batch + (1,))
    except ValueError:
        return None
    if target != (level,) + batch + (1,):
        return None
    return jnp.broadcast_to(jnp.asarray(threshold, jnp.float32),
                            target)[..., 0]


def _try_fused_denoise(x, wavelet, level, mode, threshold):
    from ..kernels import modwt_cuda as kc

    if not kc.applies("denoise", x, level, wavelet):
        return None
    thr = _fused_threshold(x, wavelet, level, threshold)
    if thr is None:
        return None
    return kc.modwt_denoise_fused(x, thr, wavelet, level, mode)


def modwt_denoise(x: jax.Array, wavelet: DiscreteWavelet, level: int,
                  mode: str = "soft", method: str = "auto",
                  threshold=None) -> jax.Array:
    """Denoise via MODWT: shrink detail rows, keep approximation, invert.

    Matches the pipeline of ``MODWTExample.java:125-172``.  ``threshold``
    defaults to the universal threshold estimated from the level-1 details;
    the strings ``'universal'``, ``'sure'`` and ``'bayes'`` select the
    corresponding estimator applied PER DETAIL LEVEL (σ always from the
    level-1 MAD); an array is used as-is (broadcast against the detail rows).

    On a CUDA GPU, float32/bfloat16 input with the universal rule or a
    threshold that is constant along N runs forward → shrink → inverse as
    ONE kernel (kernels/modwt_cuda.py): the coefficients never reach device
    memory, about 2 passes of the signal instead of 2(L+2).
    ``method='fused'`` requires that kernel; any other method runs the
    transform pipeline with that method.
    """
    x = jnp.asarray(x)
    if mode not in ("soft", "hard"):
        raise ValueError(f"mode must be 'soft' or 'hard', got {mode!r}")
    if method in ("auto", "fused"):
        _check_level(x.shape[-1], level)
        out = _try_fused_denoise(x, wavelet, level, mode, threshold)
        if out is not None:
            return out
        if method == "fused":
            raise ValueError(
                f"fused denoise unavailable for shape {x.shape} dtype "
                f"{x.dtype}, threshold {threshold!r} on "
                f"{jax.devices()[0].platform} devices")
        method = "auto"
    c = modwt(x, wavelet, level, method)
    n = x.shape[-1]
    if threshold is None or isinstance(threshold, str):
        kind = threshold or "universal"
        if kind == "universal":
            threshold = universal_threshold(c[0], n)[..., None]
        elif kind == "sure":
            threshold = sure_threshold(c[:level], mad_sigma(c[0]))[..., None]
        elif kind == "bayes":
            threshold = bayes_threshold(c[:level], mad_sigma(c[0]))[..., None]
        else:
            raise ValueError(f"unknown threshold rule {threshold!r}")
    shrink = soft_threshold if mode == "soft" else hard_threshold
    details = shrink(c[:level], threshold)
    c = jnp.concatenate([details, c[level:]], axis=0)
    return imodwt(c, wavelet, method)


@functools.partial(jax.jit, donate_argnums=0,
                   static_argnames=("wavelet", "level", "mode", "method"))
def modwt_denoise_inplace(x: jax.Array, wavelet: DiscreteWavelet, level: int,
                          mode: str = "soft", method: str = "auto"
                          ) -> jax.Array:
    """:func:`modwt_denoise` with the input buffer donated.

    This is the JAX replacement for the reference's in-place/pooled
    tier (``InPlaceFastWaveletTransform.java:70-100``,
    ``utils/ArrayBufferPool.java:24-256``): ``donate_argnums=0`` lets XLA
    alias the reconstruction onto the input signal's buffer, so the
    whole denoise roundtrip allocates no second signal-sized output — the
    same zero-copy guarantee the reference's buffer pool chases, provided by
    the compiler.  The caller's ``x`` is consumed (deleted) by the call;
    tests/test_donation.py asserts the input→output aliasing on the compiled
    executable.  (The fused CUDA denoise reads neighbouring tiles' context
    while it writes, so it takes no alias: on a GPU the donation frees the
    input instead.)
    """
    return modwt_denoise(x, wavelet, level, mode=mode, method=method)


def modwt2_denoise(x: jax.Array, wavelet: DiscreteWavelet, level: int,
                   mode: str = "soft", threshold=None,
                   method: str = "auto") -> jax.Array:
    """Image denoising via the 2D MODWT (undecimated, shift-invariant).

    The 2D extension of :func:`modwt_denoise` (``MODWTExample.java:125-172``
    pipeline): shrink every detail band (LH/HL/HH per level), keep LL,
    invert.  σ is estimated from the finest diagonal band HH₁ — the
    standard image-denoising convention (Donoho–Johnstone: HH₁ is almost
    pure noise) — and ``threshold`` defaults to the universal threshold
    σ·√(2·ln(R·C)); the strings ``'universal'``, ``'sure'``, ``'bayes'``
    select the rule applied per band, an array is used as-is.
    """
    from .modwt2d import imodwt2, modwt2

    x = jnp.asarray(x)
    if method not in ("auto", "direct"):
        raise ValueError(f"unknown method {method!r}")
    c = modwt2(x, wavelet, level, method=method)   # (3L+1, ..., R, C)
    n_bands = 3 * level
    r, ccols = x.shape[-2], x.shape[-1]
    flat = c[:n_bands].reshape((n_bands,) + c.shape[1:-2] + (-1,))
    if threshold is None or isinstance(threshold, str):
        kind = threshold or "universal"
        hh1 = c[2].reshape(c.shape[1:-2] + (-1,))   # finest diagonal band
        if kind == "universal":
            sigma = mad_sigma(hh1)
            threshold = (sigma * jnp.sqrt(2.0 * jnp.log(float(r * ccols)))
                         )[..., None, None]
        elif kind == "sure":
            threshold = sure_threshold(flat, mad_sigma(hh1)
                                       )[..., None, None]
        elif kind == "bayes":
            threshold = bayes_threshold(flat, mad_sigma(hh1)
                                        )[..., None, None]
        else:
            raise ValueError(f"unknown threshold rule {threshold!r}")
    shrink = soft_threshold if mode == "soft" else hard_threshold
    details = shrink(c[:n_bands], threshold)
    c = jnp.concatenate([details, c[n_bands:]], axis=0)
    return imodwt2(c, wavelet, method=method)


def modwt3_denoise(x: jax.Array, wavelet: DiscreteWavelet, level: int,
                   mode: str = "soft", threshold=None) -> jax.Array:
    """Volume denoising via the 3D MODWT.

    The 3D extension of :func:`modwt2_denoise`: shrink every detail octant
    (7 per level), keep LLL, invert.  σ is estimated from the finest
    all-highpass octant HHH₁ (the 3D analog of the HH₁ convention — the
    corner octant is almost pure noise); ``threshold`` defaults to the
    universal threshold σ·√(2·ln(D·R·C)); ``'universal'``/``'sure'``/
    ``'bayes'`` select the rule, an array is used as-is.
    """
    from .modwt2d import imodwt3, modwt3

    x = jnp.asarray(x)
    c = modwt3(x, wavelet, level)          # (7L+1, ..., D, R, C)
    n_bands = 7 * level
    vox = float(x.shape[-3] * x.shape[-2] * x.shape[-1])
    flat = c[:n_bands].reshape((n_bands,) + c.shape[1:-3] + (-1,))
    if threshold is None or isinstance(threshold, str):
        kind = threshold or "universal"
        hhh1 = c[6].reshape(c.shape[1:-3] + (-1,))  # finest corner octant
        if kind == "universal":
            sigma = mad_sigma(hhh1)
            threshold = (sigma * jnp.sqrt(2.0 * jnp.log(vox))
                         )[..., None, None, None]
        elif kind == "sure":
            threshold = sure_threshold(flat, mad_sigma(hhh1)
                                       )[..., None, None, None]
        elif kind == "bayes":
            threshold = bayes_threshold(flat, mad_sigma(hhh1)
                                        )[..., None, None, None]
        else:
            raise ValueError(f"unknown threshold rule {threshold!r}")
    shrink = soft_threshold if mode == "soft" else hard_threshold
    details = shrink(c[:n_bands], threshold)
    c = jnp.concatenate([details, c[n_bands:]], axis=0)
    return imodwt3(c, wavelet)


def wpt_denoise(x: jax.Array, wavelet: DiscreteWavelet, level=None,
                cost: str = "sure", mode: str = "soft",
                threshold=None, per_sample: bool = False) -> jax.Array:
    """Best-basis packet denoising: adapt the BASIS to the signal, then
    shrink.

    Coifman–Wickerhauser best-basis selection (:func:`..ops.wpt.best_basis`,
    default ``cost='sure'`` — risk-matched to the soft shrinkage applied
    after) on the noisy signal, then threshold the mixed-level basis
    coefficients and reconstruct, keeping the pure low-pass packet (node 0
    at its leaf level) unshrunk — the packet analog of
    :func:`modwt_denoise`'s keep-the-approximation convention.

    Beyond the reference: its README advertises best-basis selection
    (``ops/wpt.py`` implements it) and its denoise demo stops at the octave
    tree (``MODWTExample.java:125-172``); combining them resolves tonal
    noise structure the octave tree cannot isolate (a packet basis can
    place narrow bands on interfering tones).  ``threshold`` defaults to
    the universal threshold from the level-1 detail MAD; jits and batches
    (one basis is selected for the whole batch, costs summed — unless
    ``per_sample=True`` (r5): the cost DP runs vectorized over the batch
    and every sample adapts its OWN basis, the right choice when batch
    rows are heterogeneous series, e.g. the financial tier's per-asset
    panels).

    Mode guidance: for strong narrowband (tonal) content prefer
    ``mode='hard'`` — soft thresholding biases every kept coefficient by
    t, and a deep packet concentrating a tone has MANY coefficients just
    a few t above threshold (measured: hard 0.17 vs noisy 0.35 MSE on an
    interfering-tones signal where soft WORSENS to 0.43 and the octave
    tree's :func:`modwt_denoise` reaches only 1.02 — the adaptive basis
    beats the octave tree 6× on exactly this signal class).
    """
    from .wpt import basis_coefficients, basis_reconstruct, best_basis

    x = jnp.asarray(x)
    n = x.shape[-1]
    masks, _, tree = best_basis(x, wavelet, level, cost,
                                per_sample=per_sample)
    flat = basis_coefficients(tree, masks)
    if threshold is None:
        d1 = tree[1][..., n // 2:]            # level-1 details
        threshold = universal_threshold(d1, n)[..., None]
    shrink = soft_threshold if mode == "soft" else hard_threshold
    shrunk = shrink(flat, threshold)
    # keep the low-pass packet: positions [0, n >> l) of the level l whose
    # leaf mask covers node 0 (static loop over levels; masks are traced;
    # per-sample masks broadcast their batch axes into ``keep``)
    keep = jnp.zeros((n,), dtype=bool)
    pos = jnp.arange(n)
    for l, m in enumerate(masks):
        keep = keep | (m[..., 0:1] & (pos < (n >> l)))
    out = jnp.where(keep, flat, shrunk)
    return basis_reconstruct(out, masks, wavelet)


def wpt2_denoise(x: jax.Array, wavelet: DiscreteWavelet, level=None,
                 cost: str = "sure", mode: str = "soft",
                 threshold=None, per_sample: bool = False) -> jax.Array:
    """2D best-basis packet denoising (quad-tree analog of
    :func:`wpt_denoise`).

    Basis from :func:`..ops.wpt.best_basis2`; σ estimated from the finest
    diagonal packet (node (1,1) at level 1 — the HH₁ convention of
    :func:`modwt2_denoise`); the low-pass packet (node (0,0) at its leaf
    level) is kept unshrunk.
    """
    from .wpt import basis_coefficients2, basis_reconstruct2, best_basis2

    x = jnp.asarray(x)
    r, c = x.shape[-2], x.shape[-1]
    masks, _, tree = best_basis2(x, wavelet, level, cost,
                                 per_sample=per_sample)
    flat = basis_coefficients2(tree, masks)
    if threshold is None:
        hh1 = tree[1][..., r // 2:, c // 2:]
        sigma = mad_sigma(hh1.reshape(hh1.shape[:-2] + (-1,)))
        threshold = (sigma * jnp.sqrt(2.0 * jnp.log(float(r * c)))
                     )[..., None, None]
    shrink = soft_threshold if mode == "soft" else hard_threshold
    shrunk = shrink(flat, threshold)
    rows = jnp.arange(r)[:, None]
    cols = jnp.arange(c)[None, :]
    keep = jnp.zeros((r, c), dtype=bool)
    for l, m in enumerate(masks):
        keep = keep | (m[..., 0:1, 0:1] & (rows < (r >> l))
                       & (cols < (c >> l)))
    out = jnp.where(keep, flat, shrunk)
    return basis_reconstruct2(out, masks, wavelet)
