"""Maximal Overlap Discrete Wavelet Transform (MODWT).

Reference semantics (``jwave/transforms/MODWTTransform.java``):
  * base filters = wavelet's decomposition banks, L2-normalized then ÷ √2
    (``initializeFilterCache``, ``:452-484`` and ``normalize``, ``:595-608``);
  * level-j filter = base filter upsampled with ``2^(j-1) - 1`` zeros between
    taps (``upsample``, ``:618-630``);
  * forward: ``W_j = x ⊛ h̃_j``, ``V_j = x ⊛ g̃_j`` with circular convolution
    ``y[n] = Σ_m x[(n-m) mod N] f[m]`` (``circularConvolve``, ``:677-690``);
  * inverse: adjoint convolution ``y[n] = Σ_m x[(n+m) mod N] f[m]``
    (``circularConvolveAdjoint``, ``:703-716``), summed over the two branches
    (``inverseMODWT``, ``:337-375``).

The upsampled filter is never materialized in the compute: circular
convolution with an upsampled filter ≡ *dilated* (à-trous) convolution with
the M-tap base filter (dilation ``2^(j-1)``), so the per-sample cost stays
2·M multiply-adds per level independent of depth.  The reference's direct
path is O(N · M·2^(j-1)) which is why its FFT path wins by up to 47×
(``README.md:16``); here the dilated direct path is already optimal and the
FFT path (kept for parity and for very long filters) is rarely needed.
Both filters (g, h) share each rolled signal copy; batching over leading
axes replaces the reference's thread-level parallelism.  On a CUDA GPU the
fused kernels (kernels/modwt_cuda.py) run the whole level chain in one
pass for float32/bfloat16 input when their plan fits.

Filters are computed at trace time with numpy float64 → they are jit constants
(the analog of the reference's ConcurrentHashMap filter cache, ``:490-560``).

The level loop is sequential by data dependence (V_j feeds V_{j+1}) but is a
cheap unrolled chain of convs; all parallelism is per-sample/batch.
"""
from __future__ import annotations

import functools
import math

import numpy as np

import jax
import jax.numpy as jnp

from ..wavelets.base import DiscreteWavelet

__all__ = [
    "modwt", "imodwt", "modwt_mra", "modwt_base_filters",
    "MAX_DECOMPOSITION_LEVEL", "circular_convolve", "circular_convolve_adjoint",
]

#: Maximum supported decomposition level (MODWTTransform.java:107-111).
MAX_DECOMPOSITION_LEVEL = 13

#: N·M product above which the reference's AUTO mode picks FFT convolution
#: (MODWTTransform.java:118-144).  Our direct path is dilated, so AUTO here
#: compares the *base* filter cost instead — see :func:`_use_fft`.
FFT_CONVOLUTION_THRESHOLD = 4096


def modwt_base_filters(wavelet: DiscreteWavelet):
    """(g̃, h̃): unit-L2-normalized decomposition banks divided by √2.

    Mirrors ``MODWTTransform.initializeFilterCache`` (``:452-484``).
    Returns numpy float64 arrays (host-side constants).
    """
    def norm(f):
        f = np.asarray(f, dtype=np.float64)
        e = math.sqrt(float(np.sum(f * f)))
        if e > 1e-12:
            f = f / e
        return f / math.sqrt(2.0)

    return norm(wavelet.dec_lo), norm(wavelet.dec_hi)


def _conv_channels(x: jax.Array, kernels, dilation: int, adjoint: bool) -> jax.Array:
    """Circular (adjoint-)convolution of ``x`` with each kernel, dilated.

    ``y_c[n] = Σ_k x[(n ∓ k·d) mod N] f_c[k]`` — computed as a sum of
    circularly rolled copies, sharing the rolls across output channels.
    Matches ``circularConvolve``/``Adjoint`` (``MODWTTransform.java:
    677-716``) applied to upsampled filters, without ever materializing the
    upsampled filter (the zeros are skipped by construction).

    ``jnp.roll`` with a static shift lowers to two slices and a concat
    that XLA fuses into the adds.
    """
    m = int(kernels[0].shape[0])
    sign = -1 if adjoint else 1
    outs = [None] * len(kernels)
    for k in range(m):
        r = jnp.roll(x, sign * k * dilation, axis=-1) if k else x
        for c, f in enumerate(kernels):
            term = f[k] * r
            outs[c] = term if outs[c] is None else outs[c] + term
    return jnp.stack(outs, axis=-2)  # (..., C, N)


def _wrapped_filter_fft(f: np.ndarray, dilation: int, n: int):
    """rFFT of the level filter wrapped to length ``n`` (host-side constant).

    The mod-N accumulate of ``wrapFilterToSignalLength``
    (``MODWTTransform.java:729-741``) equals evaluating the filter's DTFT at
    the N DFT frequencies, done here on the upsampled filter without
    materializing it: index of tap k is ``(k·d) mod n``.
    """
    w = np.zeros(n, dtype=np.float64)
    idx = (np.arange(f.shape[0]) * dilation) % n
    np.add.at(w, idx, f)
    return np.fft.rfft(w)


@functools.lru_cache(maxsize=128)
def _composite_fft_multipliers(wavelet: DiscreteWavelet, level: int, n: int):
    """The whole à-trous cascade as one (level+1, F) multiplier stack.

    Circular convolutions compose exactly on the DFT grid, so
    ``W_j = (Π_{i<j} G_i)·H_j·X`` and ``V_J = (Π G_i)·X`` — algebraically
    identical to the per-level ``circularConvolveFFT`` cascade
    (``MODWTTransform.java:752-786``) but collapsing 3·J FFT passes into
    one rfft + one batched irfft.  Host-side complex128; row order matches
    :func:`modwt` (W_1..W_J then V_J).
    """
    g, h = modwt_base_filters(wavelet)
    rows = []
    cum = np.ones(n // 2 + 1, dtype=np.complex128)
    for j in range(1, level + 1):
        d = 1 << (j - 1)
        rows.append(cum * _wrapped_filter_fft(h, d, n))
        cum = cum * _wrapped_filter_fft(g, d, n)
    rows.append(cum)
    return np.stack(rows)


def _composite_shape(mult: np.ndarray, batch_ndim: int):
    """Reshape the (R, F) stack to broadcast over leading batch dims."""
    r, f = mult.shape
    return mult.reshape((r,) + (1,) * batch_ndim + (f,))


def _use_fft(method: str, n: int, m_base: int, dilation: int) -> bool:
    if method == "fft":
        return True
    if method == "direct":
        return False
    if method == "auto":
        # Cost-based: the dilated direct path is O(N·M_base); FFT is
        # O(N log N).  Direct wins unless the base filter is very long.
        return m_base > 4 * max(math.log2(max(n, 2)), 1.0)
    if method == "auto_reference":
        # The reference's heuristic on the *upsampled* length
        # (MODWTTransform.java:640-664).
        m_up = (m_base - 1) * dilation + 1
        return n * m_up > FFT_CONVOLUTION_THRESHOLD
    raise ValueError(f"unknown convolution method {method!r}")


def _level_conv(v, g, h, j, method, adjoint=False, w=None):
    """One MODWT level: returns (V-branch, W-branch) results."""
    n = v.shape[-1]
    d = 1 << (j - 1)
    if _use_fft(method, n, g.shape[0], d):
        gf = jnp.asarray(_wrapped_filter_fft(g, d, n))
        hf = jnp.asarray(_wrapped_filter_fft(h, d, n))
        if adjoint:
            gf, hf = jnp.conj(gf), jnp.conj(hf)
        vf = jnp.fft.rfft(v)
        wf = vf if w is None else jnp.fft.rfft(w)
        out_v = jnp.fft.irfft(vf * gf.astype(vf.dtype), n=n).astype(v.dtype)
        out_w = jnp.fft.irfft(wf * hf.astype(wf.dtype), n=n).astype(v.dtype)
        return out_v, out_w
    gk = jnp.asarray(g, dtype=v.dtype)
    hk = jnp.asarray(h, dtype=v.dtype)
    if w is None:
        out = _conv_channels(v, (gk, hk), d, adjoint)
        return out[..., 0, :], out[..., 1, :]
    out_v = _conv_channels(v, (gk,), d, adjoint)[..., 0, :]
    out_w = _conv_channels(w, (hk,), d, adjoint)[..., 0, :]
    return out_v, out_w


def _combined_adjoint(v, w, g, h, d, axis=-1):
    """Σ_k roll(g[k]·v + h[k]·w, −k·d) — one inverse MODWT level.

    The caller of the adjoint pair only ever needs the SUM of the two
    branches, so combining BEFORE rolling does one roll per tap instead of
    two.
    """
    m = int(g.shape[0])
    acc = None
    for k in range(m):
        t = g[k] * v + h[k] * w
        if k:
            t = jnp.roll(t, -k * d, axis=axis)
        acc = t if acc is None else acc + t
    return acc


def _check_level(n: int, level: int) -> None:
    if level < 1:
        raise ValueError(f"decomposition level must be ≥ 1, got {level}")
    if level > MAX_DECOMPOSITION_LEVEL:
        raise ValueError(
            f"maximum supported decomposition level is "
            f"{MAX_DECOMPOSITION_LEVEL}, requested {level} "
            "[parity: MODWTTransform.java:107-111]"
        )
    theo = n.bit_length() - 1 if n > 0 else 0
    if level > theo:
        raise ValueError(
            f"decomposition level {level} exceeds theoretical limit {theo} "
            f"for signal length {n} [parity: MODWTTransform.java:279-284]"
        )


def _try_fused(x, wavelet, level, inverse=False):
    """The fused CUDA kernel's result, or None where it does not apply
    (dtype, filter length, depth, no CUDA GPU)."""
    from ..kernels import modwt_cuda as kc

    if not kc.applies("inverse" if inverse else "forward", x, level, wavelet):
        return None
    if inverse:
        return kc.imodwt_fused(x, wavelet)
    return kc.modwt_fused(x, wavelet, level)


def modwt(x: jax.Array, wavelet: DiscreteWavelet, level: int,
          method: str = "auto") -> jax.Array:
    """Forward MODWT on the last axis; works for arbitrary (non-pow2) N.

    Returns shape ``(level+1, ..., N)``: rows 0..level-1 are detail
    coefficients W_1..W_J, row level is the approximation V_J — the layout of
    ``MODWTTransform.forwardMODWT`` (``MODWTTransform.java:256-306``).

    ``method``: 'direct' (dilated à-trous conv), 'fft', 'fused' (the CUDA
    kernel; raises where it cannot run), 'auto' (the fused kernel where it
    runs, else a cost model between direct/fft), or 'auto_reference' (the
    reference's N·M>4096 rule, ``MODWTTransform.java:640-664``).
    """
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.integer):
        x = x.astype(jnp.float32)
    _check_level(x.shape[-1], level)
    if method in ("auto", "fused"):
        out = _try_fused(x, wavelet, level)
        if out is not None:
            return out
        if method == "fused":
            raise ValueError(
                f"fused kernel unavailable for shape {x.shape} dtype "
                f"{x.dtype} on {jax.devices()[0].platform} devices")
        method = "auto"
    g, h = modwt_base_filters(wavelet)
    n = x.shape[-1]
    if method in ("fft", "auto") and _use_fft(method, n, g.shape[0], 1):
        # composite spectral cascade: one rfft + one batched irfft
        mult = _composite_shape(
            _composite_fft_multipliers(wavelet, level, n), x.ndim - 1)
        xf = jnp.fft.rfft(x)
        prod = xf[None] * jnp.asarray(mult).astype(xf.dtype)
        return jnp.fft.irfft(prod, n=n).astype(x.dtype)
    rows = []
    v = x
    for j in range(1, level + 1):
        v_next, w_next = _level_conv(v, g, h, j, method)
        rows.append(w_next)
        v = v_next
    rows.append(v)
    return jnp.stack(rows, axis=0)


def imodwt(coeffs: jax.Array, wavelet: DiscreteWavelet,
           method: str = "auto") -> jax.Array:
    """Inverse MODWT: reconstruct the signal from ``(level+1, ..., N)`` coeffs.

    Mirrors ``MODWTTransform.inverseMODWT`` (``:337-375``): top-down
    ``V_{j-1} = adjoint(V_j, g̃_j) + adjoint(W_j, h̃_j)``.
    """
    coeffs = jnp.asarray(coeffs)
    level = coeffs.shape[0] - 1
    if level < 1:
        raise ValueError("need at least level 1 (rows W_1 and V_1)")
    if method in ("auto", "fused"):
        out = _try_fused(coeffs, wavelet, level, inverse=True)
        if out is not None:
            return out
        if method == "fused":
            raise ValueError(
                f"fused kernel unavailable for shape {coeffs.shape} dtype "
                f"{coeffs.dtype} on {jax.devices()[0].platform} devices")
        method = "auto"
    g, h = modwt_base_filters(wavelet)
    v = coeffs[level]
    n = coeffs.shape[-1]
    if method in ("fft", "auto") and _use_fft(method, n, g.shape[0], 1):
        # adjoint composite cascade: the per-level conj multipliers compose
        # to the conj of the forward stack — (level+1) rffts, ONE irfft
        mult = _composite_shape(
            _composite_fft_multipliers(wavelet, level, n), coeffs.ndim - 2)
        cf = jnp.fft.rfft(coeffs)
        acc = jnp.sum(cf * jnp.conj(jnp.asarray(mult)).astype(cf.dtype),
                      axis=0)
        return jnp.fft.irfft(acc, n=n).astype(coeffs.dtype)
    for j in range(level, 0, -1):
        d = 1 << (j - 1)
        if _use_fft(method, n, g.shape[0], d):
            va, wa = _level_conv(v, g, h, j, method, adjoint=True,
                                 w=coeffs[j - 1])
            v = va + wa
        else:
            v = _combined_adjoint(v, coeffs[j - 1],
                                  jnp.asarray(g, dtype=v.dtype),
                                  jnp.asarray(h, dtype=v.dtype), d)
    return v


def modwt_mra(x: jax.Array, wavelet: DiscreteWavelet, level: int,
              method: str = "auto") -> jax.Array:
    """Multiresolution analysis: additive detail/smooth components.

    Returns ``(level+1, ..., N)``: rows 0..level-1 are details D_j, row level
    is the smooth S_J, with ``x = Σ D_j + S_J`` (the reference demonstrates
    this decomposition in ``examples/MODWTExample.java``).
    """
    c = modwt(x, wavelet, level, method)
    comps = []
    zeros = jnp.zeros_like(c)
    for j in range(level + 1):
        cj = zeros.at[j].set(c[j])
        comps.append(imodwt(cj, wavelet, method))
    return jnp.stack(comps, axis=0)


def circular_convolve(x, f, method: str = "direct"):
    """Public helper: ``y[n] = Σ_m x[(n-m) mod N] f[m]`` (non-dilated)."""
    x = jnp.asarray(x)
    fk = jnp.asarray(f, dtype=x.dtype)
    return _conv_channels(x, (fk,), 1, adjoint=False)[..., 0, :]


def circular_convolve_adjoint(x, f, method: str = "direct"):
    """Public helper: ``y[n] = Σ_m x[(n+m) mod N] f[m]`` (non-dilated)."""
    x = jnp.asarray(x)
    fk = jnp.asarray(f, dtype=x.dtype)
    return _conv_channels(x, (fk,), 1, adjoint=True)[..., 0, :]
