"""1D wavelet scattering transform — batched-FFT formulation.

The scattering transform (Mallat 2012; Andén & Mallat 2014) cascades
complex analytic wavelet convolutions and modulus nonlinearities, then
low-pass averages every path:

    S0    =  x ⋆ φ
    S1[λ] = |x ⋆ ψ¹_λ| ⋆ φ
    S2[λ,μ] = ||x ⋆ ψ¹_λ| ⋆ ψ²_μ| ⋆ φ      (ξ_μ < ξ_λ·2^{-1/Q})

yielding a translation-invariant (up to the averaging scale T = 2^J),
deformation-stable signal representation — the standard wavelet-domain
feature extractor for ML on audio/biomedical/financial series.  The
reference framework has no scattering tier; this extends its capability
surface using the same machinery as ``ops/cwt.py``
(``ContinuousWaveletTransform.java:183-229``'s one-FFT-many-multiplies
pattern, taken two layers deep).

Design: every path at a given order is one batched complex
multiply + one batched (i)FFT — the λ/path axis is a pure batch axis
(vmap-free broadcasting; shards across devices like the CWT scale axis).
Second-order paths are gathered with static index tables so shapes stay
fixed under jit.  Low-pass + ↓T subsampling is done spectrally: the
spectrum is folded ``Ŷ → mean over m of Ŷ[k + m·N/T]`` (a reshape-mean,
no lane-strided slicing) followed by a length-N/T inverse FFT.

Filters are host-side float64 constants (like the discrete tap tables):
Gabor log-spaced band-pass atoms ψ̂_k(ω) = exp(−(ω−ξ_k)²/2σ_k²) with Q
filters/octave over J octaves (ξ_max = 0.425 cycles/sample, adjacent
filters crossing at half power) and a Gaussian low-pass φ̂ of time scale
~2^J, jointly renormalized so the Littlewood–Paley sum
|φ̂|² + Σ|ψ̂_k|² ≤ 1 (nonexpansive frame ⇒ ‖S(x)−S(y)‖ ≤ ‖x−y‖).
"""
from __future__ import annotations

import functools
import math
import typing

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["ScatteringResult", "scattering1d", "scattering_filters"]


class ScatteringResult(typing.NamedTuple):
    """Scattering coefficients; all arrays share the leading batch dims.

    ``s0``: (..., N/T) — low-passed signal (order 0).
    ``s1``: (..., L1, N/T) — first-order paths.
    ``s2``: (..., P, N/T) — second-order paths, or None if order < 2.
    ``xi1``: (L1,) numpy — first-order center frequencies (cycles/sample).
    ``pairs``: (P, 2) numpy — (first-order index, ξ² frequency) per path.
    """

    s0: jax.Array
    s1: jax.Array
    s2: jax.Array | None
    xi1: np.ndarray
    pairs: np.ndarray

    def stack(self) -> jax.Array:
        """All coefficients stacked on one path axis: (..., 1+L1+P, N/T)."""
        parts = [self.s0[..., None, :], self.s1]
        if self.s2 is not None:
            parts.append(self.s2)
        return jnp.concatenate(parts, axis=-2)


XI_MAX = 0.425  # highest center frequency, cycles/sample (below Nyquist)

_HALF_CROSS = 1.0 / (2.0 * math.sqrt(2.0 * math.log(2.0)))  # ≈ 0.4246


def _filter_params(j: int, nq: int):
    """(ξ, σ) grids for a constant-Q bank: ``nq`` filters/octave, ``j`` octaves."""
    k = np.arange(j * nq, dtype=np.float64)
    xi = XI_MAX * 2.0 ** (-k / nq)
    sig = xi * (1.0 - 2.0 ** (-1.0 / (2.0 * nq))) / _HALF_CROSS * 0.5
    return xi, sig


def _gabor_bank(n: int, xis: np.ndarray, sigmas: np.ndarray) -> np.ndarray:
    """ψ̂ rows on the length-``n`` DFT grid (ω in cycles/sample, periodic)."""
    omega = np.arange(n, dtype=np.float64) / n
    # evaluate on ω and ω−1 so tails wrap on the periodic grid
    d0 = omega[None, :] - xis[:, None]
    d1 = omega[None, :] - 1.0 - xis[:, None]
    s2 = 2.0 * sigmas[:, None] ** 2
    g = np.exp(-d0 * d0 / s2) + np.exp(-d1 * d1 / s2)
    # Morlet-style DC correction: subtract ψ̂(0)·(zero-centered Gaussian) so
    # every atom has exactly zero mean (admissibility; also keeps the
    # Littlewood–Paley renormalization below well-posed at ω = 0).
    osym = np.minimum(omega, 1.0 - omega)
    g -= g[:, :1] * np.exp(-osym[None, :] ** 2 / s2)
    return g


@functools.lru_cache(maxsize=64)
def scattering_filters(n: int, j: int, q: int):
    """Build the (ψ¹, ψ², φ) frequency-domain filter bank for length ``n``.

    Returns ``(psi1 (L1, n), xi1 (L1,), psi2 (L2, n), xi2 (L2,), phi (n,))``
    as float64 numpy.  First order: L1 = J·Q constant-Q atoms spanning J
    octaves below ``XI_MAX``; second order: L2 = J single-octave atoms
    (Q₂ = 1, the standard choice — modulus envelopes are broadband).
    """
    if j < 1:
        raise ValueError("need at least one octave (j >= 1)")
    if q < 1:
        raise ValueError("need at least one filter per octave (q >= 1)")
    xi1, sig1 = _filter_params(j, q)
    xi2, sig2 = _filter_params(j, 1)
    psi1 = _gabor_bank(n, xi1, sig1)
    psi2 = _gabor_bank(n, xi2, sig2)
    omega = np.arange(n, dtype=np.float64) / n
    omega = np.minimum(omega, 1.0 - omega)  # symmetric low-pass
    sig_phi = 0.35 / (1 << j)
    phi = np.exp(-(omega**2) / (2.0 * sig_phi**2))
    # Littlewood–Paley renormalization: scale each bank by the largest c
    # with |φ̂|² + c·Σ|ψ̂_k|² ≤ 1 everywhere, so each wavelet layer (and
    # hence the whole cascade) is nonexpansive.  (φ̂ ≤ 1 by construction;
    # the atoms are exactly zero at ω = 0 after the DC correction.)
    for bank in (psi1, psi2):
        lp = (bank**2).sum(axis=0)
        mask = lp > 1e-10
        c = float(np.min(np.maximum(1.0 - phi[mask] ** 2, 0.0) / lp[mask]))
        bank *= math.sqrt(min(c, 1.0))
    return psi1, xi1, psi2, xi2, phi


@functools.lru_cache(maxsize=64)
def _pair_table(n: int, j: int, q: int):
    """Static (i1, i2) index tables for frequency-decreasing 2nd-order paths."""
    _, xi1, _, xi2, _ = scattering_filters(n, j, q)
    sel = xi2[None, :] < xi1[:, None] * 2.0 ** (-1.0 / q)
    i1, i2 = np.nonzero(sel)
    return i1, i2


def _lowpass_subsample(yhat: jax.Array, phi: jax.Array, t: int) -> jax.Array:
    """ifft(fold(Ŷ·φ̂, T)) — low-pass then exact ↓T, no lane striding."""
    yhat = yhat * phi
    if t > 1:
        m = yhat.shape[-1] // t
        yhat = yhat.reshape(*yhat.shape[:-1], t, m).mean(axis=-2)
    return jnp.fft.ifft(yhat).real


def _spectral_fold(yhat: jax.Array, d: int) -> jax.Array:
    """Fold Ŷ to length N/d — the spectrum of the ↓d-decimated signal."""
    if d == 1:
        return yhat
    m = yhat.shape[-1] // d
    return yhat.reshape(*yhat.shape[:-1], d, m).mean(axis=-2)


def _subsample_filter(f_full: np.ndarray, d: int) -> np.ndarray:
    """Exact DFT-grid restriction of a length-N filter to the N/d grid.

    Decimated-signal DFT bin k′ < m/2 is original bin k′; bins past m/2 are
    the original negative frequencies N−m+k′ — for a filter whose support
    fits inside the decimated Nyquist band this is exact (no aliasing of
    the filter itself), so the multiresolution cascade uses the SAME
    renormalized filter values as the full-resolution one.
    """
    if d == 1:
        return f_full
    n = f_full.shape[-1]
    m = n // d
    lo = m // 2 + 1
    return np.concatenate([f_full[..., :lo], f_full[..., n - (m - lo):]],
                          axis=-1)


def _decimations(top: np.ndarray, t: int, oversampling: int) -> np.ndarray:
    """Per-atom pow-2 decimation keeping Nyquist ≥ 2^oversampling× ``top``.

    ``top`` is the per-atom spectral top edge the decimated grid must keep
    resolvable (band top ξ+3σ of the widest filter still to be applied at
    that rate, which also bounds the modulus envelope's bandwidth).
    Decimating by d keeps the decimated Nyquist 1/(2d) at least
    2^oversampling×top — the kymatio-style multiresolution rule.  Strides
    are capped by the output stride T (never coarser than the final grid).
    """
    lim = 1.0 / (2.0 ** (1 + oversampling) * np.maximum(top, 1e-12))
    d = np.ones(len(top), dtype=np.int64)
    for i in range(len(top)):
        while d[i] * 2 <= lim[i] and d[i] * 2 <= t:
            d[i] *= 2
    return d


def scattering1d(x: jax.Array, j: int, q: int = 8, order: int = 2,
                 subsample: int | None = None,
                 oversampling: int = 1) -> ScatteringResult:
    """Wavelet scattering of ``x`` (..., N) over ``j`` octaves, ``q``/octave.

    ``subsample``: output stride T (defaults to 2^j, the averaging scale;
    pass 1 to keep full resolution).  N must be a multiple of T.  Jits,
    batches over any leading dims, and differentiates (the modulus
    subgradient at 0 is the JAX `abs` convention).

    Multiresolution evaluation: each path runs at its own pow-2-decimated
    rate — spectra are folded (:func:`_spectral_fold`; a fold + short iFFT
    IS the decimated signal, exactly) as soon as a path's remaining band
    content fits the coarser Nyquist, so low-frequency paths cost N/d
    instead of N per FFT.  Decimation never goes below what keeps every
    filter still to be applied (ψ², φ̂) plus the modulus envelope resolvable
    at 2^``oversampling``× margin; raising ``oversampling`` tightens parity
    with the full-resolution cascade (large values force every stride to 1,
    recovering it bit-exactly), lowering it buys speed.  The default (1)
    keeps ~1e-4 (s1) / ~1e-3 (s2) relative agreement — envelope-harmonic
    aliasing, the kymatio tradeoff.
    """
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        # S0 = ifft(X·φ̂).real would silently drop the imaginary half
        raise ValueError("scattering1d expects a real signal")
    n = x.shape[-1]
    t = (1 << j) if subsample is None else subsample
    if t < 1 or n % t:
        raise ValueError(f"subsample stride {t} must divide N={n}")
    if order not in (1, 2):
        raise ValueError("order must be 1 or 2")
    psi1_np, xi1, psi2_np, xi2, phi_np = scattering_filters(n, j, q)
    sig1 = _filter_params(j, q)[1]
    sig2 = _filter_params(j, 1)[1]
    rdt = jnp.result_type(x.dtype, jnp.float32)
    phi_by: dict[int, jax.Array] = {}

    def phi_at(d):
        if d not in phi_by:
            phi_by[d] = jnp.asarray(_subsample_filter(phi_np, d), dtype=rdt)
        return phi_by[d]

    i1, i2 = _pair_table(n, j, q)
    # First-stage rate must resolve the atom's own band AND the widest ψ²
    # later applied to its envelope; second-stage rate only the ψ² band
    # (φ̂'s support is narrower than any of these).
    need1 = xi1 + 3.0 * sig1
    top2 = xi2 + 3.0 * sig2
    if order == 2:
        for a, b in zip(i1, i2):
            need1[a] = max(need1[a], top2[b])
    d1 = _decimations(need1, t, oversampling)
    d2p = (np.maximum(d1[i1], _decimations(top2, t, oversampling)[i2])
           if i1.size else np.zeros(0, np.int64))

    xhat = jnp.fft.fft(x)
    s0 = _lowpass_subsample(xhat, phi_at(1), t)

    s1_parts, idx_parts, u1hat_by = [], [], {}
    for d in sorted(set(d1.tolist())):
        idx = np.nonzero(d1 == d)[0]
        psi_g = jnp.asarray(psi1_np[idx], dtype=rdt)
        yhat = _spectral_fold(xhat[..., None, :] * psi_g, d)
        u1hat = jnp.fft.fft(jnp.abs(jnp.fft.ifft(yhat)))  # (..., Lg, N/d)
        s1_parts.append(_lowpass_subsample(u1hat, phi_at(d), t // d))
        idx_parts.append(idx)
        u1hat_by[d] = (idx, u1hat)
    s1 = (s1_parts[0] if len(s1_parts) == 1
          else jnp.concatenate(s1_parts, axis=-2))
    perm = np.concatenate(idx_parts)
    if not np.array_equal(perm, np.arange(len(xi1))):
        s1 = jnp.take(s1, jnp.asarray(np.argsort(perm)), axis=-2)

    s2 = None
    if order == 2 and i1.size:
        s2_parts, pair_parts = [], []
        for d, (idx, u1hat) in sorted(u1hat_by.items()):
            pos = {a: k for k, a in enumerate(idx)}
            in_g = np.nonzero(d1[i1] == d)[0]
            for dd in sorted(set(d2p[in_g].tolist())):
                sel = in_g[d2p[in_g] == dd]
                loc = np.asarray([pos[a] for a in i1[sel]])
                rows = jnp.take(u1hat, jnp.asarray(loc), axis=-2)
                psi2_g = jnp.asarray(_subsample_filter(psi2_np[i2[sel]], d),
                                     dtype=rdt)
                u2hat = _spectral_fold(rows * psi2_g, dd // d)
                u2 = jnp.abs(jnp.fft.ifft(u2hat))
                s2_parts.append(_lowpass_subsample(jnp.fft.fft(u2),
                                                   phi_at(dd), t // dd))
                pair_parts.append(sel)
        s2 = (s2_parts[0] if len(s2_parts) == 1
              else jnp.concatenate(s2_parts, axis=-2))
        po = np.concatenate(pair_parts)
        if not np.array_equal(po, np.arange(len(i1))):
            s2 = jnp.take(s2, jnp.asarray(np.argsort(po)), axis=-2)
    elif order == 2:
        s2 = jnp.zeros((*x.shape[:-1], 0, n // t), dtype=s1.dtype)

    pairs = np.stack([i1, xi2[i2]], axis=-1) if i1.size else np.zeros((0, 2))
    return ScatteringResult(s0=s0, s1=s1, s2=s2, xi1=xi1, pairs=pairs)
