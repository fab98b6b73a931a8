"""2D Continuous Wavelet Transform — batched FFT-multiplier formulation.

Beyond the reference's scope (its CWT tier, ``jwave/transforms/
ContinuousWaveletTransform.java``, is 1D-only); rounds out the imaging use
case with the standard Antoine–Murenzi 2D CWT:

    W(a, θ, b) = IFFT2[ X̂(k) · conj(a·ψ̂(a·r_{−θ}k)) ]

Same shape as the 1D tier (``ops/cwt.py``): the whole
(scale × angle) grid of multipliers is one host-precomputed f64 constant
(cached per wavelet/scales/angles/shape), the image is FFT'd ONCE, and the
per-(a, θ) products inverse-transform as one batch — matmul-free,
bandwidth-bound, with the scale axis chunked via ``lax.map`` when the
complex intermediate would grow past the 1D tier's chunk bound
(``ops/cwt.py:_scale_chunk``).  For real images and real-even ψ̂ (isotropic
Mexican Hat) the whole pipeline runs in the rfft2 half-plane and returns
REAL coefficients — half the FLOPs and HBM traffic of the complex path.

Boundary convention: periodic (the DFT's own), matching the library-wide
circular convention; pre-pad the image if another extension is wanted.
"""
from __future__ import annotations

import functools
import math
import typing

import numpy as np

import jax
import jax.numpy as jnp

from ..wavelets.continuous2d import ContinuousWavelet2D, MexicanHat2D

__all__ = ["cwt2", "icwt2", "CWT2Result"]


class CWT2Result(typing.NamedTuple):
    """2D CWT output container (1D analog: ``ops/cwt.py:CWTResult``).

    ``coefficients``: shape ``(..., S, H, W)`` — or ``(..., S, A, H, W)``
    when an angle grid was swept; real when ψ̂ is real-even, else complex.
    """

    coefficients: jax.Array
    scales: jax.Array
    angles: jax.Array | None
    sampling_rate: float
    wavelet_name: str

    @property
    def magnitude(self):
        return jnp.abs(self.coefficients)

    @property
    def phase(self):
        return jnp.angle(self.coefficients)

    @property
    def scalogram(self):
        """Per-(scale[, angle]) energy Σ_b |W|² over the image plane."""
        return jnp.sum(jnp.abs(self.coefficients) ** 2, axis=(-2, -1))


@functools.lru_cache(maxsize=8)  # full (S·A, h, w) planes — entries are
# ~h× costlier than the 1D tier's (S, F) rows, so the cache is kept small
def _multipliers2d(wavelet: ContinuousWavelet2D, scales: tuple,
                   angles: tuple | None, h: int, w: int,
                   sampling_rate: float, half: bool):
    """Host-side f64 multiplier stack conj(a·ψ̂(a·r_{−θ}k)) on the DFT grid.

    With ``half=True`` (real image × real-even ψ̂) the stack has shape
    ``(S·A, h, w//2+1)`` on the rfft2 half-plane — a real-even multiplier
    keeps the product Hermitian, so irfft2 closes the loop exactly; else
    the full ``(S·A, h, w)`` plane.  ψ̂ is evaluated through the library's
    jnp formulas on the host CPU inside ``ensure_compile_time_eval`` (same
    pattern as the 1D tier's ``_half_spectrum_multipliers``).
    """
    fs = sampling_rate
    ky = 2.0 * math.pi * np.fft.fftfreq(h) * fs
    is_real = half
    kx = (2.0 * math.pi * np.fft.rfftfreq(w) * fs if is_real
          else 2.0 * math.pi * np.fft.fftfreq(w) * fs)
    gky = ky[:, None]
    gkx = kx[None, :]
    ang = (0.0,) if angles is None else angles
    planes = []
    with jax.ensure_compile_time_eval(), \
            jax.default_device(jax.local_devices(backend="cpu")[0]):
        for a in scales:
            for th in ang:
                # no explicit dtype: f64 under x64, silently f32 otherwise
                # (matches the 1D tier; an explicit f64 request would warn)
                m = np.asarray(jnp.conj(wavelet.psi_hat_scaled(
                    jnp.asarray(gkx), jnp.asarray(gky),
                    float(a), float(th))))
                planes.append(np.real(m) if is_real else m)
    return np.stack(planes)


def cwt2(x: jax.Array, scales, wavelet: ContinuousWavelet2D | None = None,
         angles=None, sampling_rate: float = 1.0) -> CWT2Result:
    """2D CWT of an image (or batch of images) over static scale/angle grids.

    ``x``: ``(..., H, W)`` real or complex.  ``scales``: static positive
    floats.  ``angles``: optional static orientation grid in radians — when
    given, coefficients gain an angle axis ``(..., S, A, H, W)``; for
    isotropic wavelets leave it ``None``.  Boundary is periodic.

    One image FFT + one batched multiplier product + one batched inverse
    FFT; real-output fast path for real images under real-even ψ̂ (see
    module docstring).  Scale/angle chunked with ``lax.map`` past the 8M-
    element intermediate knee.  Fully jittable (static scales/angles).
    """
    if wavelet is None:
        wavelet = MexicanHat2D()
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.integer):
        x = x.astype(jnp.float32)
    if x.ndim < 2:
        raise ValueError("cwt2 needs at least a (H, W) image")
    h, w = x.shape[-2], x.shape[-1]
    scales_np = np.atleast_1d(np.asarray(scales, dtype=np.float64))
    if np.any(scales_np <= 0):
        raise ValueError("Scales must be positive")
    angles_np = None
    if angles is not None:
        angles_np = np.atleast_1d(np.asarray(angles, dtype=np.float64))
    scales_t = tuple(float(a) for a in scales_np)
    angles_t = None if angles_np is None else tuple(float(t)
                                                    for t in angles_np)
    use_real = wavelet.real_even_hat and not jnp.issubdtype(
        x.dtype, jnp.complexfloating)
    m_np = _multipliers2d(wavelet, scales_t, angles_t, h, w,
                          float(sampling_rate), use_real)
    f64 = x.dtype == jnp.float64 or x.dtype == jnp.complex128
    cdtype = jnp.complex128 if f64 else jnp.complex64
    rdtype = jnp.float64 if f64 else jnp.float32

    n_planes = m_np.shape[0]
    if use_real:
        xf = jnp.fft.rfft2(x, axes=(-2, -1))[..., None, :, :]
        # keep the real-even multiplier REAL: complex×real products are two
        # real multiplies (vs four) and the stack's HBM bytes halve
        mult = jnp.asarray(m_np).astype(rdtype)

        def run(m):
            return jnp.fft.irfft2(xf * m, s=(h, w),
                                  axes=(-2, -1)).astype(rdtype)
    else:
        xf = jnp.fft.fft2(x.astype(cdtype), axes=(-2, -1))[..., None, :, :]
        mult = jnp.asarray(m_np).astype(cdtype)

        def run(m):
            return jnp.fft.ifft2(xf * m, axes=(-2, -1))

    # Chunk the plane axis past the fusion knee (1D analog: cwt.py:316-342).
    batch_elems = int(np.prod(x.shape[:-2], dtype=np.int64))
    chunk = n_planes
    if batch_elems * h * w * n_planes > (1 << 23):
        target = max(1, (1 << 22) // max(batch_elems * h * w, 1))
        if target < n_planes:
            chunk = max(c for c in range(1, min(target, n_planes) + 1)
                        if n_planes % c == 0)
    if chunk == n_planes:
        coeff = run(mult)
    else:
        cs = mult.reshape(n_planes // chunk, chunk, *mult.shape[1:])
        out = jax.lax.map(run, cs)  # (nchunks, ..., chunk, h, w)
        out = jnp.moveaxis(out, 0, -4)
        coeff = out.reshape(*out.shape[:-4], n_planes, h, w)

    lead = x.shape[:-2]
    if angles_t is None:
        coeff = coeff.reshape(lead + (len(scales_t), h, w))
        angles_arr = None
    else:
        coeff = coeff.reshape(lead + (len(scales_t), len(angles_t), h, w))
        angles_arr = jnp.asarray(angles_np).astype(rdtype)
    return CWT2Result(coeff, jnp.asarray(scales_np).astype(rdtype),
                      angles_arr, sampling_rate, wavelet.name)


@functools.lru_cache(maxsize=8)
def _recon_filter2d(wavelet: ContinuousWavelet2D, scales: tuple,
                    angles: tuple | None, h: int, w: int,
                    sampling_rate: float):
    """Regularized 2D reconstruction filter G(k) — host-side, cached.

    2D analog of the 1D tier's ``ops/cwt.py:_recon_filter``: the weighted
    plane sum R(b) = Σ_{a,θ} w_a/A · W(a,θ,b) is the image convolved with a
    kernel of spectrum H(k) = Σ w_a/A · conj(a·ψ̂(a·r_{−θ}k)); with
    w_a = Δln(a)/a the radial integrand is scale-invariant (∫ψ̂(u) dln u),
    so H is ~flat over the covered band, and G = conj(H)/(|H|² + ε²)
    (ε = 5% of the in-band peak) deconvolves it — exact in-band, zero at DC
    (wavelets are zero-mean).
    """
    m = _multipliers2d(wavelet, scales, angles, h, w, sampling_rate,
                       half=False)
    scales_np = np.asarray(scales, dtype=np.float64)
    dln = (np.gradient(np.log(scales_np)) if scales_np.size > 1
           else np.ones(1))
    wts = dln / scales_np
    na = 1 if angles is None else len(angles)
    wfull = np.repeat(wts, na) / na
    hk = np.tensordot(wfull, m, axes=(0, 0))  # (h, w) complex
    # Effective response on a REAL image: directional grids span θ ∈ [0, π)
    # so H covers only a k half-plane; the Hermitian half supplies the
    # rest.  With S(k) = FFT(2·Re r) = X̂·[H(k) + conj(H(−k))] (derivation
    # in :func:`icwt2`), calibrate against H₂ = H(k) + conj(H(−k)) — for
    # real-even isotropic ψ̂ this is just 2H, consistent with the real path.
    h2 = hk + np.conj(np.roll(hk[::-1, ::-1], (1, 1), axis=(0, 1)))
    peak = float(np.max(np.abs(h2)))
    if peak < 1e-30:
        raise ValueError("wavelet/scale grid cannot be calibrated for icwt2")
    eps2 = (0.05 * peak) ** 2
    g = np.conj(h2) / (np.abs(h2) ** 2 + eps2)
    return g, wfull


def icwt2(result: CWT2Result, wavelet: ContinuousWavelet2D | None = None,
          scales=None, angles=None) -> jax.Array:
    """Approximate inverse 2D CWT (real-image reconstruction).

    Single-integral reconstruction with frequency compensation, the 2D
    analog of :func:`..cwt.icwt`: the Δln(a)/a-weighted plane sum is
    deconvolved by the grid's aggregate response (see
    :func:`_recon_filter2d`).  Assumes a REAL source image (directional
    grids span θ ∈ [0, π); the Hermitian half-plane supplies the rest).
    Accuracy is that of the method — in-band components reconstruct to a
    few %, the image mean (DC) is not recoverable.  Fully jittable with
    static ``scales=``/``angles=`` grids.
    """
    if wavelet is None:
        wavelet = MexicanHat2D()
    coeffs = result.coefficients
    if scales is None:
        if isinstance(result.scales, jax.core.Tracer):
            raise ValueError("icwt2 under jit needs a static scale grid: "
                             "pass scales= explicitly")
        scales = np.asarray(result.scales, dtype=np.float64)
    scales_np = np.atleast_1d(np.asarray(scales, dtype=np.float64))
    if angles is None and result.angles is not None:
        if isinstance(result.angles, jax.core.Tracer):
            raise ValueError("icwt2 under jit needs a static angle grid: "
                             "pass angles= explicitly")
        angles = np.asarray(result.angles, dtype=np.float64)
    angles_t = (None if angles is None else
                tuple(float(t) for t in np.atleast_1d(angles)))
    h, w = coeffs.shape[-2], coeffs.shape[-1]
    g, wfull = _recon_filter2d(
        wavelet, tuple(float(a) for a in scales_np), angles_t, h, w,
        float(result.sampling_rate))
    n_planes = wfull.shape[0]
    lead = coeffs.ndim - (4 if angles_t is not None else 3)
    flat = coeffs.reshape(coeffs.shape[:lead] + (n_planes, h, w))
    r = jnp.einsum("s,...shw->...hw",
                   jnp.asarray(wfull).astype(jnp.abs(flat).dtype), flat,
                   precision=jax.lax.Precision.HIGHEST)
    # S(k) = FFT(2·Re r) = X̂·(H(k) + conj(H(−k))): FFT(r) + FFT(conj r)
    # folds the Hermitian half-plane in, matching the H₂ calibration.
    rf = jnp.fft.fft2(2.0 * jnp.real(r), axes=(-2, -1))
    cdt = jnp.complex128 if rf.dtype == jnp.complex128 else jnp.complex64
    x = jnp.fft.ifft2(rf * jnp.asarray(g).astype(cdt), axes=(-2, -1))
    return jnp.real(x)
