"""Synchrosqueezed CWT — sharpened time-frequency analysis + mode extraction.

Beyond the reference's scope (its CWT tier stops at scalograms,
``jwave/transforms/ContinuousWaveletTransform.java``): synchrosqueezing
(Daubechies–Lu–Wu 2011) reassigns each CWT coefficient W(a, t) to the
frequency bin of its *instantaneous frequency*

    ω(a, t) = Im[ ∂_t W(a, t) / W(a, t) ]

collapsing the wavelet's scale smear into near-line ridges — the standard
modern tool for multicomponent signals (mode decomposition, ridge
extraction) in finance/biomedicine/geophysics.

Formulation (no finite differences, no data-dependent shapes):

* ∂_t W is computed EXACTLY in the frequency domain: the CWT half-spectrum
  multipliers (A, B) (``ops/cwt.py:_half_spectrum_multipliers``) have the
  derivative counterparts (iω·A, iω·B) — host-precomputed f64 constants, so
  W and ∂_t W come from one shared rfft + four batched irffts.
* The frequency reassignment is a fixed-shape scatter: a ``lax.scan`` over
  the scale axis accumulates one-hot(bin(ω)) outer products into the
  (..., n_freqs, N) output — compiler-friendly (no dynamic scatter), with
  a small per-step (N, n_freqs) panel.
* Each reassigned summand carries the inverse-CWT weight Δln(a)/√a
  (``ops/cwt.py:_icwt_weights``), so ``Σ_bins Tx ≡ Σ_scales w_a·W`` and
  :func:`issq_cwt` inverts with the same calibrated deconvolution filter as
  :func:`..ops.cwt.icwt` — including band-masked inversion, i.e. extraction
  of individual signal components from their ridges.

Use analytic wavelets (Morlet — the default — or Paul): real-ψ̂ families
(Mexican Hat, even DOG) have real W whose phase transform is degenerate.
"""
from __future__ import annotations

import functools
import math
import typing

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..utils.validation import next_power_of_two
from ..wavelets.continuous import ContinuousWavelet, MorletWavelet
from .cwt import (
    _half_irfft_chunked, _half_spectrum_multipliers, _icwt_weights,
    _recon_filter, _scale_chunk, pad_signal,
)

__all__ = ["ssq_cwt", "issq_cwt", "SSQResult"]


class SSQResult(typing.NamedTuple):
    """Synchrosqueezed CWT output.

    ``Tx``: complex, shape ``(..., n_freqs, N)`` — reassigned, inverse-
    weighted coefficients (``Σ_l Tx[l] = Σ_a Δln(a)/√a·W(a)``).
    ``Wx``: the underlying CWT coefficients ``(..., n_scales, N)``.
    ``ssq_freqs``: the log-spaced frequency bin centers in Hz.
    """

    Tx: jax.Array
    Wx: jax.Array
    ssq_freqs: jax.Array
    scales: jax.Array
    time_axis: jax.Array
    sampling_rate: float
    wavelet_name: str

    @property
    def magnitude(self):
        return jnp.abs(self.Tx)

    @property
    def energy_profile(self):
        """Per-bin energy Σ_t |Tx|² (the sharpened 'scalogram')."""
        return jnp.sum(jnp.abs(self.Tx) ** 2, axis=-1)


@functools.lru_cache(maxsize=256)
def _ssq_multipliers(wavelet: ContinuousWavelet, scales: tuple,
                     padded_n: int, sampling_rate: float):
    """(A, B, iωA, iωB) half-spectrum stacks — host-side f64 numpy.

    The derivative pair follows from linearity of the Hermitian split:
    replacing M(ω) by iω·M(ω) maps (A_k, B_k) → (iω_k·A_k, iω_k·B_k)
    (shown in the module docstring of ``ops/cwt.py``: both halves scale by
    the same self-conjugate-odd factor).  The Nyquist bin of the derivative
    pair is zeroed — iω there breaks the real-output symmetry irfft needs,
    and a well-sampled signal has no energy at exactly fs/2.
    """
    a, b, _, _ = _half_spectrum_multipliers(wavelet, scales, padded_n,
                                            sampling_rate)
    f = padded_n // 2 + 1
    omega = 2.0 * math.pi * np.arange(f) * sampling_rate / padded_n
    iw = 1j * omega[None, :]
    ad = iw * a
    bd = iw * b
    if padded_n % 2 == 0:
        ad[:, -1] = 0.0
        bd[:, -1] = 0.0
    return a, b, ad, bd


def _ssq_reassign(xp, n, mults, weights, log_lo, dlog, n_freqs, gamma,
                  rdtype, cdtype, axis_name: str | None = None):
    """Core SSQ pipeline: padded signal → (Tx, Wx).

    ``mults``/``weights`` may cover only a shard of the scale axis: with
    ``axis_name`` set (inside a ``shard_map`` over that mesh axis) the
    default-γ peak is a ``lax.pmax`` and the reassigned Tx is a ``lax.psum``
    over the scale shards — reassignment is additive over scales, so the
    partial one-hot accumulations sum exactly
    (``parallel.sharded.ssq_sharded``).
    """
    padded_n = xp.shape[-1]
    a_m, b_m, ad_m, bd_m = mults
    s_count = a_m.shape[0]
    xh = jnp.fft.rfft(xp, axis=-1)[..., None, :]  # (..., 1, F)

    # chunk the scale axis past the XLA-FFT fusion knee, exactly like the
    # plain CWT (ops/cwt.py:_scale_chunk) — ssq materializes FOUR (..., S, N)
    # products (W and ∂_t W quadratures), so the knee bites sooner
    batch_elems = int(np.prod(xp.shape[:-1], dtype=np.int64))
    chunk = _scale_chunk(batch_elems, padded_n, s_count)

    def half(mult):
        return _half_irfft_chunked(xh, mult, padded_n, n, cdtype, rdtype,
                                   chunk)

    w_re, w_im = half(a_m), half(b_m)          # W     (..., S, N)
    d_re, d_im = half(ad_m), half(bd_m)        # ∂_t W (..., S, N)
    return _reassign_planes(w_re, w_im, d_re, d_im, weights, log_lo, dlog,
                            n_freqs, gamma, rdtype, cdtype, axis_name)


def _reassign_planes(w_re, w_im, d_re, d_im, weights, log_lo, dlog, n_freqs,
                     gamma, rdtype, cdtype, axis_name: str | None = None):
    """(W, ∂_t W) quadrature planes → (Tx, W) — the reassignment scatter."""
    n = w_re.shape[-1]
    s_count = w_re.shape[-2]
    batch_elems = int(np.prod(w_re.shape[:-2], dtype=np.int64))
    mag2 = w_re * w_re + w_im * w_im
    if gamma is None:
        peak = jnp.max(mag2, axis=(-2, -1), keepdims=True)
        if axis_name is not None:
            peak = lax.pmax(peak, axis_name)
        thresh2 = (1e-6 ** 2) * peak
    else:
        thresh2 = jnp.asarray(float(gamma) ** 2, dtype=rdtype)
    # phase transform: ω_inst = Im[∂_t W / W] (rad/s) → Hz
    inst_f = (d_im * w_re - d_re * w_im) / (
        2.0 * math.pi * jnp.maximum(mag2, jnp.finfo(rdtype).tiny))
    valid = (mag2 > thresh2) & (inst_f > 0)
    # log-spaced bin index; round to the nearest center
    safe_f = jnp.maximum(inst_f, jnp.finfo(rdtype).tiny)
    idx_f = (jnp.log(safe_f) - log_lo) / dlog
    idx = jnp.round(idx_f).astype(jnp.int32)
    valid &= (idx >= 0) & (idx < n_freqs)
    idx = jnp.clip(idx, 0, n_freqs - 1)

    w_coef = jax.lax.complex(w_re, w_im)

    # Reassignment: one-hot scatter into the bin axis, vectorized over
    # scale BLOCKS.  A per-scale scan serializes S steps of tiny (N, L)
    # panels; blocking lets the whole (K, N, L) one-hot product run as one
    # fused batched reduction per step while capping the intermediate at
    # ~64 MB.  K = S when it fits → a single fully-parallel step.
    contrib = jnp.where(valid, w_coef, 0) * jnp.asarray(
        weights, dtype=rdtype)[:, None]  # broadcasting over (..., S, N)
    blk = max(1, min(s_count, int((64 << 20) // max(
        1, batch_elems * n * n_freqs * np.dtype(rdtype).itemsize))))
    groups = -(-s_count // blk)
    pad = groups * blk - s_count
    if pad:
        contrib = jnp.concatenate(
            [contrib, jnp.zeros(contrib.shape[:-2] + (pad, n),
                                contrib.dtype)], axis=-2)
        idx = jnp.concatenate(
            [idx, jnp.zeros(idx.shape[:-2] + (pad, n), idx.dtype)], axis=-2)
    # (..., G, K, N) → scan over G (1 step when everything fits)
    shp = contrib.shape[:-2] + (groups, blk, n)
    scan_c = jnp.moveaxis(contrib.reshape(shp), -3, 0)
    scan_i = jnp.moveaxis(idx.reshape(shp), -3, 0)

    def body(acc, si):
        c_k, i_k = si  # (..., K, N)
        onehot = jax.nn.one_hot(i_k, n_freqs, dtype=rdtype,
                                axis=-1)  # (..., K, N, L)
        return acc + jnp.sum(c_k[..., None] * onehot, axis=-3), None

    acc0 = jnp.zeros(w_re.shape[:-2] + (n, n_freqs), dtype=cdtype)
    # shard_map VMA check: the scan carry must be varying over the same
    # manual mesh axes as the scanned operands; deriving the zero init from
    # an operand inherits exactly those (a no-op XLA folds away).
    acc0 = acc0 + 0.0 * scan_c[0][..., 0, :, None]
    tx_nl, _ = lax.scan(body, acc0, (scan_c, scan_i))
    tx = jnp.moveaxis(tx_nl, -1, -2)  # (..., L, N)
    if axis_name is not None:
        tx = lax.psum(tx, axis_name)
    return tx, w_coef


def ssq_cwt(x: jax.Array, scales, wavelet: ContinuousWavelet | None = None,
            sampling_rate: float = 1.0, n_freqs: int | None = None,
            freq_range: tuple[float, float] | None = None,
            padding: str = "zero", gamma: float | None = None,
            method: str = "auto", precision=None) -> SSQResult:
    """Synchrosqueezed CWT of a real signal over a static scale grid.

    ``x``: real ``(batch…, N)``.  ``scales``: static positive floats
    (physical units; bin defaults assume f = fc/a).  ``n_freqs``: number of
    log-spaced output frequency bins (default ``len(scales)``).
    ``freq_range``: (f_min, f_max) in Hz for the bin grid — defaults to the
    scale grid's own band [fc/a_max, fc/a_min].  ``gamma``: magnitude
    threshold below which coefficients are dropped instead of reassigned
    (default 1e-6 of the per-signal peak |W|).

    Fully jittable: multipliers, bin edges, and weights are trace-time
    constants; the scatter is a fixed-shape one-hot ``lax.scan``.

    ``method``: the (W, ∂_t W) front end — 'auto' or 'fft' (four
    half-spectrum irffts), or 'banded' (the pruned-band matmul plan of
    ops/cwt_banded.py).  On an H100 the irfft front end measured faster at
    4×4096 with 32 scales (PERF.md), so 'auto' never picks 'banded'.
    ``precision``: the banded front end's matmul precision, as in
    :func:`..ops.cwt.cwt`.
    """
    if method not in ("auto", "fft", "banded"):
        raise ValueError(f"unknown SSQ method {method!r}")
    if wavelet is None:
        wavelet = MorletWavelet()
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.integer):
        x = x.astype(jnp.float32)
    low_prec = x.dtype == jnp.bfloat16
    if low_prec:
        x = x.astype(jnp.float32)
    from .cwt import _resolve_precision
    mxu_prec = _resolve_precision(precision, low_prec)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise ValueError("ssq_cwt expects a real signal")
    n = x.shape[-1]
    padded_n = next_power_of_two(n)
    try:
        scales_np = np.atleast_1d(np.asarray(scales, dtype=np.float64))
    except (jax.errors.TracerArrayConversionError, TypeError) as e:
        raise ValueError(
            "ssq_cwt needs a STATIC scale grid (multipliers and bin edges "
            "are host-precomputed): pass scales as concrete floats, not a "
            "traced array") from e
    if np.any(scales_np <= 0):
        raise ValueError("Scales must be positive")
    s_count = scales_np.shape[0]
    if n_freqs is None:
        n_freqs = s_count
    if n_freqs < 2:
        raise ValueError("need at least 2 frequency bins")

    fc = float(wavelet.center_frequency)
    if freq_range is None:
        f_lo = fc / float(scales_np.max())
        f_hi = fc / float(scales_np.min())
    else:
        f_lo, f_hi = float(freq_range[0]), float(freq_range[1])
    if not (0 < f_lo < f_hi):
        raise ValueError("freq_range must satisfy 0 < f_min < f_max")
    log_lo, log_hi = math.log(f_lo), math.log(f_hi)
    dlog = (log_hi - log_lo) / (n_freqs - 1)

    rdtype = jnp.float64 if x.dtype == jnp.float64 else jnp.float32
    cdtype = jnp.complex128 if x.dtype == jnp.float64 else jnp.complex64
    xp = pad_signal(x, padded_n, padding)
    weights = _icwt_weights(scales_np)  # (S,) host f64

    from .cwt_banded import banded_supported, cwt_banded_wd

    if method == "banded":
        # Pruned-band front end (ops/cwt_banded.py): W and ∂_t W from one
        # shared band plan instead of four full-length irffts.
        if not banded_supported(padded_n, n):
            raise ValueError(
                f"banded SSQ needs a 128-divisible padded length ≥ 512, "
                f"got {padded_n}")
        xh = jnp.fft.rfft(xp, axis=-1)
        w_c, d_c = cwt_banded_wd(xh, n, scales_np, wavelet,
                                 float(sampling_rate), padded_n,
                                 precision=mxu_prec)
        tx, w_coef = _reassign_planes(
            jnp.real(w_c), jnp.imag(w_c), jnp.real(d_c), jnp.imag(d_c),
            weights, log_lo, dlog, n_freqs, gamma, rdtype, cdtype)
    else:
        a_m, b_m, ad_m, bd_m = _ssq_multipliers(
            wavelet, tuple(float(s) for s in scales_np), padded_n,
            float(sampling_rate))
        tx, w_coef = _ssq_reassign(xp, n, (a_m, b_m, ad_m, bd_m), weights,
                                   log_lo, dlog, n_freqs, gamma, rdtype,
                                   cdtype)

    freqs = np.exp(log_lo + dlog * np.arange(n_freqs))
    dt = 1.0 / sampling_rate
    return SSQResult(tx, w_coef, jnp.asarray(freqs).astype(rdtype),
                     jnp.asarray(scales_np).astype(rdtype),
                     jnp.asarray(np.arange(n) * dt), sampling_rate,
                     wavelet.name)


def issq_cwt(result: SSQResult, wavelet: ContinuousWavelet | None = None,
             freq_range: tuple[float, float] | None = None,
             scales=None) -> jax.Array:
    """Invert a synchrosqueezed CWT — optionally over a frequency band.

    Because each Tx entry carries its inverse-CWT weight, ``Σ_l Tx[l, t]``
    equals :func:`..ops.cwt.icwt`'s weighted scale sum, and the same cached
    deconvolution filter (``ops/cwt.py:_recon_filter``) closes the loop.

    ``freq_range=(f_lo, f_hi)`` restricts the sum to bins inside the band —
    reconstructing ONE component of a multicomponent signal from its ridge
    (the synchrosqueezing mode-extraction property; bins are sharp, so a
    band that isolates the ridge isolates the mode).

    Jittable; under jit pass the static scale grid via ``scales=``.
    """
    if wavelet is None:
        wavelet = MorletWavelet()
    if scales is None:
        if isinstance(result.scales, jax.core.Tracer):
            raise ValueError(
                "issq_cwt under jit needs a static scale grid: pass "
                "scales= explicitly")
        scales = np.asarray(result.scales, dtype=np.float64)
    scales_np = np.atleast_1d(np.asarray(scales, dtype=np.float64))
    tx = result.Tx
    n = tx.shape[-1]
    if isinstance(result.sampling_rate, jax.core.Tracer):
        raise ValueError("issq_cwt needs a static sampling_rate")
    if freq_range is not None:
        if isinstance(result.ssq_freqs, jax.core.Tracer):
            raise ValueError(
                "issq_cwt(freq_range=...) under jit needs static bin "
                "frequencies; trace ssq_cwt and issq_cwt together")
        freqs = np.asarray(result.ssq_freqs, dtype=np.float64)
        mask = (freqs >= float(freq_range[0])) & \
               (freqs <= float(freq_range[1]))
        if not mask.any():
            raise ValueError("freq_range selects no bins")
        r = jnp.einsum("l,...lt->...t", jnp.asarray(
            mask.astype(np.float64)).astype(tx.dtype), tx,
            precision=jax.lax.Precision.HIGHEST)
    else:
        r = jnp.sum(tx, axis=-2)
    g, p = _recon_filter(wavelet, tuple(float(a) for a in scales_np), n,
                         float(result.sampling_rate))
    rf = jnp.fft.fft(r, n=p, axis=-1)[..., :p // 2 + 1]
    x = jnp.fft.irfft(rf * jnp.asarray(g).astype(rf.dtype), n=p, axis=-1)
    return x[..., :n]
