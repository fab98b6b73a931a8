"""Wavelet-domain analysis: MODWT variance / covariance / correlation /
cross-correlation, CWT wavelet coherence, per-scale energies.

The reference's ``docs/FINANCIAL_ROADMAP.md`` proposes (but never implements)
MODWT-based market analysis; the core statistical tool behind all of it is
the Percival–Walden MODWT wavelet variance: the signal's variance decomposed
by scale, ``Var[x] = Σ_j ν²_j``.  Implemented here on the shift-invariant
MODWT (biased estimator over all N coefficients — the circular-boundary
convention matching this library's transform), plus the standard tools built
on it: per-scale correlation, lagged cross-correlation (lead/lag by
horizon), and CWT squared wavelet coherence with Torrence–Compo smoothing.
"""
from __future__ import annotations

import functools
import math
import typing

import numpy as np

import jax
import jax.numpy as jnp

from ..wavelets.base import DiscreteWavelet
from .modwt import modwt

__all__ = [
    "modwt_variance", "modwt_variance_ci", "VarianceCI", "modwt_covariance",
    "modwt_correlation", "modwt_cross_correlation", "modwt_hurst",
    "scale_energies", "WTCResult", "wavelet_coherence", "hilbert",
    "ChangePoints", "modwt_changepoints",
    "envelope", "instantaneous_frequency",
]


def hilbert(x: jax.Array) -> jax.Array:
    """Analytic signal x + i·H[x] of real ``x`` (..., N) — one-sided FFT.

    The spectral one-sided multiplier (2 on positive bins, 1 at DC and
    Nyquist, 0 on negative bins) — the standard FFT construction; batches
    over leading dims, jits (static N).  The discrete companion of the
    analytic continuous wavelets (``wavelets/continuous.py``): |result| is
    the amplitude envelope, its phase derivative the instantaneous
    frequency used by the SSQ/ridge tier.
    """
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise ValueError("hilbert expects a real signal")
    n = x.shape[-1]
    xf = jnp.fft.fft(x)
    mult = np.zeros(n)
    mult[0] = 1.0
    if n % 2 == 0:
        mult[n // 2] = 1.0
        mult[1:n // 2] = 2.0
    else:
        mult[1:(n + 1) // 2] = 2.0
    return jnp.fft.ifft(xf * jnp.asarray(mult, dtype=xf.real.dtype))


def envelope(x: jax.Array) -> jax.Array:
    """Amplitude envelope |x + i·H[x]| of a real signal."""
    return jnp.abs(hilbert(x))


def instantaneous_frequency(x: jax.Array,
                            sampling_rate: float = 1.0) -> jax.Array:
    """Instantaneous frequency (Hz) of real ``x`` (..., N) → (..., N−1).

    Phase increments of the analytic signal via the wrap-free identity
    angle(z_{k+1}·conj(z_k)) — no unwrap pass (branch-free, jit-friendly);
    divided by 2πΔt.  Meaningful for (locally) monocomponent signals; for
    multicomponent ones use :func:`..ops.ssq.ssq_cwt` + ridge extraction.
    """
    z = hilbert(x)
    dphi = jnp.angle(z[..., 1:] * jnp.conj(z[..., :-1]))
    return dphi * (float(sampling_rate) / (2.0 * math.pi))


def _boundary_counts(n: int, level: int, filter_len: int):
    """(L_j − 1, M_j) per level: boundary-coefficient count and the number
    of interior coefficients for the unbiased Percival–Walden estimator.

    L_j = (2^j − 1)(L − 1) + 1 is the level-j equivalent-filter width
    (Percival & Walden eq. 169); the first L_j − 1 MODWT coefficients are
    affected by the circular wrap and are excluded ("brick wall").
    """
    out = []
    for j in range(1, level + 1):
        lj = ((1 << j) - 1) * (filter_len - 1) + 1
        out.append((lj - 1, n - lj + 1))
    return out


def _extend(x: jax.Array, boundary: str) -> jax.Array:
    if boundary == "periodic":
        return x
    if boundary == "reflect":
        # Percival–Walden §5.9 / waveslim convention: analyze the
        # reflection-extended series [x, reverse(x)] (length 2N) with the
        # circular machinery, removing the wrap discontinuity.
        return jnp.concatenate([x, jnp.flip(x, axis=-1)], axis=-1)
    raise ValueError(f"boundary must be 'periodic' or 'reflect', "
                     f"got {boundary!r}")


def modwt_variance(x: jax.Array, wavelet: DiscreteWavelet, level: int,
                   method: str = "auto", estimator: str = "biased",
                   boundary: str = "periodic") -> jax.Array:
    """Per-scale wavelet variance ν²_j, shape ``(level, ...)``.

    ``estimator='biased'`` (default): mean over all coefficients — the
    detail rows then partition the sample variance,
    ``Σ_j ν²_j + mean(V_J²) − mean(x)² = Var[x]`` (energy preservation of
    the √2-normalized filter bank).

    ``estimator='unbiased'``: the Percival–Walden estimator — the first
    L_j − 1 boundary-affected coefficients of each level are excluded and
    the mean runs over the M_j = N − L_j + 1 interior ones (requires
    M_j > 0 at the deepest level).  ``boundary='reflect'`` additionally
    analyzes the reflection-extended series [x, reverse(x)] (length 2N),
    removing the circular-wrap discontinuity entirely — the standard
    choice for nonperiodic data such as financial series.

    On a CUDA GPU, float32/bfloat16 inputs auto-dispatch the biased case
    to the single-pass fused kernel (kernels/modwt_cuda.py) — the
    coefficients never reach device memory, so the whole statistic costs
    about one read of the signal.  ``method='fused'`` forces it (raising if the
    shape/estimator is unsupported); any other explicit method uses the
    corresponding transform path.
    """
    if estimator not in ("biased", "unbiased"):
        raise ValueError(f"estimator must be 'biased' or 'unbiased', "
                         f"got {estimator!r}")
    x = _extend(jnp.asarray(x), boundary)
    if estimator == "biased":
        out = _try_var_fused(x, wavelet, level, method)
        if out is not None:
            return out
        c = modwt(x, wavelet, level, method)
        return jnp.mean(c[:level] ** 2, axis=-1)
    if method == "fused":
        raise ValueError("the fused single-pass kernel computes the biased "
                         "estimator; use method='auto' with "
                         "estimator='unbiased'")
    n = x.shape[-1]
    counts = _boundary_counts(n, level, wavelet.length)
    if counts[-1][1] <= 0:
        raise ValueError(
            f"unbiased estimator needs N > (2^level − 1)(L − 1) interior "
            f"samples; level {level} with L={wavelet.length} leaves "
            f"M_J = {counts[-1][1]} ≤ 0 for N={n}")
    c = modwt(x, wavelet, level, method)
    rows = [jnp.sum(c[j - 1, ..., nb:] ** 2, axis=-1) / m
            for j, (nb, m) in enumerate(counts, start=1)]
    return jnp.stack(rows, axis=0)


class VarianceCI(typing.NamedTuple):
    """Wavelet variance with χ² confidence band, all shaped ``(level, ...)``
    except ``edf`` (``(level,)`` numpy)."""
    variance: jax.Array
    lower: jax.Array
    upper: jax.Array
    edf: np.ndarray


def modwt_variance_ci(x: jax.Array, wavelet: DiscreteWavelet, level: int,
                      confidence: float = 0.95, method: str = "auto",
                      estimator: str = "unbiased",
                      boundary: str = "periodic") -> VarianceCI:
    """Wavelet variance with the Percival–Walden χ² confidence interval.

    Uses the large-sample approximation ν̂²_j ~ ν²_j·χ²_η/η with the EDF-3
    band-limited heuristic η_j = max(M_j / 2^j, 1) (Percival & Walden
    eq. 313/314's practical fallback; M_j = interior-coefficient count for
    the unbiased estimator, N for the biased one), giving

        CI = [ η ν̂² / Q_η(1−α/2) ,  η ν̂² / Q_η(α/2) ]

    with Q_η the χ²_η quantile (host-side scipy, static per (N, level)).
    Batched and jittable in ``x`` — only the data-independent quantiles
    live on the host.

    With ``boundary='reflect'`` the variance averages over the 2N-length
    extended series, but the EDF is still based on the original N — the
    reflected half repeats the same N observations and adds no degrees of
    freedom (verified empirically: the sampling EDF of the reflected
    estimator matches the periodic one, not 2×).
    """
    if not 0.0 < confidence < 1.0:
        raise ValueError(f"confidence must be in (0, 1), got {confidence}")
    from scipy.stats import chi2

    var = modwt_variance(x, wavelet, level, method, estimator, boundary)
    n = jnp.asarray(x).shape[-1]
    if estimator == "unbiased":
        m = [max(mj, 1)
             for _, mj in _boundary_counts(n, level, wavelet.length)]
    else:
        m = [n] * level
    eta = np.maximum(np.asarray(m, dtype=np.float64)
                     / 2.0 ** np.arange(1, level + 1), 1.0)
    alpha = 1.0 - confidence
    qhi = chi2.ppf(1.0 - alpha / 2.0, eta)
    qlo = chi2.ppf(alpha / 2.0, eta)
    shape = (level,) + (1,) * (var.ndim - 1)
    scale_lo = jnp.asarray(eta / qhi, dtype=var.dtype).reshape(shape)
    scale_hi = jnp.asarray(eta / qlo, dtype=var.dtype).reshape(shape)
    return VarianceCI(var, var * scale_lo, var * scale_hi, eta)


def _try_var_fused(x, wavelet, level, method):
    """The fused single-pass variance (kernels/modwt_cuda.py), or None where
    it does not apply and ``method`` is not 'fused'."""
    if method not in ("auto", "fused"):
        return None
    from ..kernels import modwt_cuda as kc

    x = jnp.asarray(x)
    if method == "fused" and x.dtype not in (jnp.float32, jnp.bfloat16):
        raise ValueError(f"fused variance needs a float32/bfloat16 input, "
                         f"got {x.dtype} with shape {x.shape}")
    if not kc.applies("variance", x, level, wavelet):
        if method == "fused":
            raise ValueError(
                f"fused variance unavailable for shape {x.shape} on "
                f"{jax.devices()[0].platform} devices")
        return None
    return kc.modwt_var_fused(x, wavelet, level)[:level]


def modwt_covariance(x: jax.Array, y: jax.Array, wavelet: DiscreteWavelet,
                     level: int, method: str = "auto") -> jax.Array:
    """Per-scale wavelet covariance mean(W^x_j · W^y_j), shape ``(level, ...)``.

    Decomposes Cov[x, y] by scale (plus the V_J cross term) — the tool
    behind lead/lag and co-movement analysis across horizons.

    When the fused variance kernel applies (see :func:`modwt_variance`),
    the covariance is computed by polarization —
    ``cov = (var(x+y) − var(x−y))/4`` — exact by linearity of the MODWT,
    two single-pass kernels instead of 2·(L+2) coefficient passes.

    Numerics note: polarization differences two nearly-equal variances, so
    in the kernel's f32 accumulation the absolute error is ~√N·ε·ν²; when
    the true per-scale correlation is far below f32 ε (|ρ| ≲ 1e-5) use
    ``method='direct'`` — the direct mean(W^x·W^y) path has no
    cancellation.
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    if x.shape != y.shape:
        if method == "fused":
            raise ValueError(
                f"fused covariance needs x.shape == y.shape, got "
                f"{x.shape} vs {y.shape}")
    else:
        out = _try_var_fused(x + y, wavelet, level, method)
        if out is not None:
            return (out - _try_var_fused(x - y, wavelet, level, method)) / 4.0
    cx = modwt(x, wavelet, level, method)
    cy = modwt(y, wavelet, level, method)
    return jnp.mean(cx[:level] * cy[:level], axis=-1)


def modwt_correlation(x: jax.Array, y: jax.Array, wavelet: DiscreteWavelet,
                      level: int, method: str = "auto") -> jax.Array:
    """Per-scale wavelet correlation ρ_j = cov_j / √(ν²_j(x)·ν²_j(y)),
    shape ``(level, ...)``.

    The scale-decomposed Pearson correlation: how strongly two series
    co-move at each horizon (ρ ∈ [−1, 1] per scale).  Built on the same
    fused single-pass kernels as :func:`modwt_variance` when they apply —
    variance(x), variance(y) and the polarization covariance cost four
    single-pass sweeps total, no coefficients in HBM.
    """
    cov = modwt_covariance(x, y, wavelet, level, method)
    vx = modwt_variance(x, wavelet, level, method)
    vy = modwt_variance(y, wavelet, level, method)
    return cov / jnp.sqrt(vx * vy)


def modwt_cross_correlation(x: jax.Array, y: jax.Array,
                            wavelet: DiscreteWavelet, level: int,
                            max_lag: int, method: str = "auto") -> jax.Array:
    """Per-scale, per-lag wavelet cross-correlation, shape
    ``(level, 2·max_lag+1, ...)``.

    ``out[j-1, max_lag+τ] = mean_t(W^x_j[t] · W^y_j[t+τ]) /
    √(ν²_j(x)·ν²_j(y))`` for τ ∈ [−max_lag, max_lag] — the Percival–Walden
    lead/lag tool by horizon: the argmax over τ at scale j estimates how
    many samples x leads (τ > 0) or trails (τ < 0) y in that frequency
    band.  Lags are circular (the library's boundary convention); the lag
    axis is a static unrolled stack of ``jnp.roll`` s, so the whole table
    is one jit-compiled program.
    """
    if method == "fused":
        raise ValueError(
            "cross-correlation has no fused single-pass path (every lag "
            "needs the coefficient rows); use method='auto'")
    cx = modwt(x, wavelet, level, method)[:level]
    cy = modwt(y, wavelet, level, method)[:level]
    vx = jnp.mean(cx ** 2, axis=-1)
    vy = jnp.mean(cy ** 2, axis=-1)
    lags = range(-max_lag, max_lag + 1)
    # y[t+τ] = roll(y, −τ)[t]
    cc = jnp.stack([jnp.mean(cx * jnp.roll(cy, -tau, axis=-1), axis=-1)
                    for tau in lags], axis=1)
    return cc / jnp.sqrt(vx * vy)[:, None]


def modwt_hurst(x: jax.Array, wavelet: DiscreteWavelet, level: int,
                min_level: int = 2, max_level: int | None = None,
                kind: str = "fgn", weighted: bool = True,
                method: str = "auto", return_fit: bool = False):
    """Wavelet-based Hurst exponent via log-scale variance regression.

    The Abry–Veitch / Percival–Walden long-memory estimator: for a process
    with spectral density S(f) ∝ |f|^{−α}, the wavelet variance scales as
    ν²_j ∝ τ_j^{α−1} with τ_j = 2^{j−1}, so the slope β of the weighted
    least-squares fit of log₂ ν̂²_j on log₂ τ_j estimates α − 1, and

        kind='fgn':  H = (β + 2) / 2   (stationary fGn-like series,
                                        e.g. financial *returns*; white
                                        noise → H = 1/2)
        kind='fbm':  H = β / 2         (nonstationary fBm-like *levels*,
                                        e.g. log-prices; random walk
                                        → H = 1/2)

    Regression uses octaves ``min_level ≤ j ≤ max_level`` (default 2..level
    — octave 1 carries most of the filter's spectral leakage) with weights
    ∝ the per-octave effective degrees of freedom N/2^j (Percival–Walden
    ch. 9 large-sample χ² approximation); ``weighted=False`` gives plain LS.

    Batched over leading axes; returns H with shape ``x.shape[:-1]`` (or
    ``(H, slope, intercept)`` with ``return_fit=True``).  Fully jittable —
    the variance rides the fused single-pass kernel when it applies.
    """
    if max_level is None:
        max_level = level
    if not (1 <= min_level <= max_level <= level):
        raise ValueError(f"need 1 ≤ min_level ≤ max_level ≤ level, got "
                         f"{min_level}..{max_level} of {level}")
    if max_level - min_level < 1:
        raise ValueError("regression needs at least 2 octaves")
    if kind not in ("fgn", "fbm"):
        raise ValueError(f"kind must be 'fgn' or 'fbm', got {kind!r}")
    x = jnp.asarray(x)
    n = x.shape[-1]
    var = modwt_variance(x, wavelet, level, method)  # (level, ...)
    v = var[min_level - 1:max_level]                 # (J, ...)
    logv = jnp.log2(jnp.maximum(v, jnp.finfo(v.dtype).tiny))
    js = np.arange(min_level, max_level + 1)
    t = np.asarray(js - 1.0)                         # log2 τ_j
    w = (n / 2.0 ** js) if weighted else np.ones_like(t)
    w = w / w.sum()
    tbar = float((w * t).sum())
    denom = float((w * (t - tbar) ** 2).sum())
    cw = jnp.asarray(((t - tbar) * w / denom), dtype=logv.dtype)
    shape = (len(js),) + (1,) * (logv.ndim - 1)
    slope = jnp.sum(cw.reshape(shape) * logv, axis=0)
    h = (slope + 2.0) / 2.0 if kind == "fgn" else slope / 2.0
    if return_fit:
        wj = jnp.asarray(w, dtype=logv.dtype).reshape(shape)
        intercept = jnp.sum(wj * logv, axis=0) - slope * tbar
        return h, slope, intercept
    return h


class WTCResult(typing.NamedTuple):
    """Squared wavelet coherence + cross-wavelet phase over (scale, time)."""
    coherence: jax.Array      # (..., S, N) real in [0, 1]
    phase: jax.Array          # (..., S, N) radians; x-leads-y angle
    scales: jax.Array         # (S,)
    times: jax.Array          # (N,)


@functools.lru_cache(maxsize=64)
def _coherence_smoothers(scales: tuple, n: int, sampling_rate: float,
                         octaves: float):
    """Host-precomputed smoothing operators for Torrence–Compo coherence.

    Time smoothing: per-scale circular convolution with the unit-sum
    Gaussian ``exp(−d²/(2a²))`` of circular distance d (a in samples),
    realized as a (S, F) multiplier on the rfft of each scale row — the
    kernel's exact DFT, so the FFT path matches a direct-convolution oracle
    to f64 precision.  Scale smoothing: boxcar over ``octaves``
    (Morlet decorrelation length 0.6, Torrence & Compo 1998 §6a) assuming
    a log-spaced grid; width 1 (no-op) if the grid has < 3 scales.
    """
    a = np.asarray(scales, dtype=np.float64) * sampling_rate  # in samples
    t = np.arange(n, dtype=np.float64)
    t = np.minimum(t, n - t)                     # circular distance
    ker = np.exp(-0.5 * (t[None, :] / a[:, None]) ** 2)
    ker /= ker.sum(axis=1, keepdims=True)
    tmult = np.fft.rfft(ker, axis=1)             # (S, n//2+1) complex
    s_count = len(scales)
    width = 1
    if s_count >= 3:
        dj = np.diff(np.log2(np.asarray(scales, dtype=np.float64)))
        djm = float(np.mean(dj))
        if djm > 0 and np.allclose(dj, djm, rtol=0.05):
            width = min(s_count, max(1, int(round(octaves / djm))))
    return tmult, width


def _smooth(p: jax.Array, tmult: np.ndarray, width: int) -> jax.Array:
    """Apply the (time × scale) smoothing operator to (..., S, N) rows."""
    n = p.shape[-1]
    if jnp.issubdtype(p.dtype, jnp.complexfloating):
        mult = jnp.asarray(np.fft.fft(np.fft.irfft(tmult, n=n, axis=1),
                                      axis=1)).astype(p.dtype)
        sm = jnp.fft.ifft(jnp.fft.fft(p, axis=-1) * mult, axis=-1)
    else:
        sm = jnp.fft.irfft(jnp.fft.rfft(p, axis=-1)
                           * jnp.asarray(tmult), n=n, axis=-1).astype(p.dtype)
    if width > 1:
        # boxcar over the scale axis, edge-truncated (normalize by the
        # number of in-range scales at each position)
        s_count = sm.shape[-2]
        h = width // 2
        pad = [(0, 0)] * (sm.ndim - 2) + [(h, width - 1 - h), (0, 0)]
        c = jnp.cumsum(jnp.pad(sm, pad), axis=-2)
        c = jnp.concatenate([jnp.zeros_like(c[..., :1, :]), c], axis=-2)
        sums = c[..., width:, :] - c[..., :-width, :]
        idx = np.arange(s_count)
        cnt = (np.minimum(idx + (width - 1 - h), s_count - 1)
               - np.maximum(idx - h, 0) + 1)
        sm = sums / jnp.asarray(cnt, dtype=sums.real.dtype)[:, None]
    return sm


def wavelet_coherence(x: jax.Array, y: jax.Array, scales,
                      wavelet=None, sampling_rate: float = 1.0,
                      padding: str = "zero",
                      smoothing_octaves: float = 0.6) -> WTCResult:
    """Squared wavelet coherence R²(a, t) of two signals (Torrence–Compo).

    ``R² = |S(a⁻¹·W_x·conj(W_y))|² / (S(a⁻¹|W_x|²)·S(a⁻¹|W_y|²))`` where S
    smooths in time (per-scale Gaussian of std a) and scale (boxcar over
    ``smoothing_octaves``); without S the ratio is identically 1, which is
    why the reference's CWT alone cannot express this tool.  ``phase`` is
    the smoothed cross-spectrum angle — the local lead/lag of x over y in
    radians at that scale.  Complements :func:`modwt_cross_correlation`
    with a time-resolved (non-stationary) view.

    Smoothing is circular along time (the library-wide boundary
    convention); scales must be static (host-precomputed operators, like
    :func:`~jwave_pro.ops.cwt.cwt`'s multipliers).  Output coherence is
    clipped to [0, 1].  The body is jit-compiled per (shape, scales,
    wavelet), so repeat calls reuse one compiled program.
    """
    scales_t = tuple(float(s) for s in np.atleast_1d(np.asarray(scales)))
    r2, phase, scales_arr, times = _coherence_impl(
        jnp.asarray(x), jnp.asarray(y), scales_t, wavelet,
        float(sampling_rate), padding, float(smoothing_octaves))
    return WTCResult(r2, phase, scales_arr, times)


@functools.partial(jax.jit, static_argnames=("scales_t", "wavelet",
                                             "sampling_rate", "padding",
                                             "octaves"))
def _coherence_impl(x, y, scales_t, wavelet, sampling_rate, padding,
                    octaves):
    from .cwt import cwt

    rx = cwt(x, scales_t, wavelet, sampling_rate, padding)
    ry = cwt(y, scales_t, wavelet, sampling_rate, padding)
    wx, wy = rx.coefficients, ry.coefficients
    n = wx.shape[-1]
    tmult, width = _coherence_smoothers(scales_t, n, sampling_rate, octaves)
    inv_a = (1.0 / jnp.asarray(np.asarray(scales_t)))[:, None]
    cross = wx * jnp.conj(wy) if jnp.iscomplexobj(wx) or \
        jnp.iscomplexobj(wy) else wx * wy
    s_xy = _smooth(cross * inv_a.astype(cross.dtype), tmult, width)
    s_xx = _smooth((jnp.abs(wx) ** 2) * inv_a, tmult, width)
    s_yy = _smooth((jnp.abs(wy) ** 2) * inv_a, tmult, width)
    # tiny-floor the denominator: a dead (all-zero-W) channel would give
    # 0/0 = NaN, which clip cannot remove — floor it so coherence is 0 there
    denom = jnp.maximum((s_xx * s_yy).real,
                        jnp.finfo(s_xx.real.dtype).tiny)
    r2 = (jnp.abs(s_xy) ** 2) / denom
    r2 = jnp.clip(r2.real, 0.0, 1.0)
    phase = jnp.angle(s_xy) if jnp.iscomplexobj(s_xy) \
        else jnp.where(s_xy < 0, jnp.pi, 0.0).astype(r2.dtype)
    return r2, phase, rx.scales, rx.time_axis


def scale_energies(coeffs: jax.Array) -> jax.Array:
    """Total energy per row of a ``(rows, ..., N)`` coefficient array
    (the per-level energy table the reference's MODWT example prints).
    Complex (e.g. Morlet CWT) rows use |c|², returning a real table."""
    coeffs = jnp.asarray(coeffs)
    if jnp.issubdtype(coeffs.dtype, jnp.complexfloating):
        return jnp.sum(jnp.abs(coeffs) ** 2, axis=-1)
    return jnp.sum(coeffs ** 2, axis=-1)


class ChangePoints(typing.NamedTuple):
    """Per-scale variance change-point test (see :func:`modwt_changepoints`).

    ``d``: the NCSS D-statistic per level, ``(level, ...)``;
    ``locations``: the argmax sample index (the most likely change point),
    ``(level, ...)`` int32; ``critical``: the level's asymptotic critical
    value at the requested α (shape ``(level,)``); ``significant``:
    ``d > critical`` broadcast over the batch.
    """

    d: jax.Array
    locations: jax.Array
    critical: jax.Array
    significant: jax.Array


# two-sided sup|Brownian bridge| quantiles (Kolmogorov distribution):
# P(sup|B(t)| > K_α) = α
_KOLMOGOROV_Q = {0.10: 1.2238, 0.05: 1.3581, 0.01: 1.6276}


def modwt_changepoints(x: jax.Array, wavelet: DiscreteWavelet, level: int,
                       method: str = "auto", alpha: float = 0.05
                       ) -> ChangePoints:
    """Per-scale variance change-point detection via the normalized
    cumulative sum of squares (NCSS) on MODWT coefficients.

    Whitcher–Byers–Guttorp–Percival ("Testing for homogeneity of variance
    in time series", 2002): under variance homogeneity the rotated
    cumulative energy ``P_k = Σ_{t≤k} W_j[t]² / Σ_t W_j[t]²`` of the
    level-j coefficients tracks the diagonal, and

        D_j = max_k |P_k − k/N|

    converges (suitably scaled) to the sup of a Brownian bridge.  A
    variance REGIME SWITCH at time t₀ — the volatility break structure the
    reference's FINANCIAL_ROADMAP.md targets — bends P away from the
    diagonal with its maximum deviation AT t₀, so ``locations[j]`` both
    tests and localizes the break, per scale: a microstructure-level shift
    fires at fine scales only, a macro regime change at every scale.

    Scaling uses the per-level equivalent sample size ``N_j = N/2^j``
    (the MODWT's 2^j-fold coefficient redundancy leaves ~N/2^j effective
    degrees of freedom — same EDF argument as :func:`modwt_variance_ci`),
    i.e. significance is declared when ``D_j > K_α/√(N_j/2)`` with K_α
    the Kolmogorov quantile.  Asymptotic and approximate (exact critical
    values need simulation; Whitcher et al. table them within a few % of
    this).  Jits, batches; the single pass is one MODWT.
    """
    if alpha not in _KOLMOGOROV_Q:
        raise ValueError(f"alpha must be one of {sorted(_KOLMOGOROV_Q)}")
    from .modwt import modwt

    x = jnp.asarray(x)
    n = x.shape[-1]
    c = modwt(x, wavelet, level, method)[:level]     # (level, ..., N)
    e = c * c
    tot = jnp.sum(e, axis=-1, keepdims=True)
    p = jnp.cumsum(e, axis=-1) / jnp.maximum(tot, jnp.finfo(e.dtype).tiny)
    diag = jnp.arange(1, n + 1, dtype=p.dtype) / n
    dev = jnp.abs(p - diag)
    d = jnp.max(dev, axis=-1)
    loc = jnp.argmax(dev, axis=-1).astype(jnp.int32)
    n_j = n / 2.0 ** np.arange(1, level + 1)
    crit = jnp.asarray(_KOLMOGOROV_Q[alpha] / np.sqrt(n_j / 2.0), d.dtype)
    crit_b = crit.reshape((level,) + (1,) * (d.ndim - 1))
    return ChangePoints(d, loc, crit, d > crit_b)
