"""2D CWT tests: wavelet consistency, detection behavior, path parity.

The reference has no 2D CWT (its CWT tier is 1D-only,
ContinuousWaveletTransform.java) — this tier is beyond-reference, so the
referee is mathematics itself: psi-hat must equal FFT2(psi), the L2 norms
must be 1, the Mexican Hat must detect blobs at the matched scale, and the
directional Morlet must resolve orientation.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import jwave_pro as jw
from jwave_pro.ops.cwt2d import cwt2
from jwave_pro.wavelets.continuous2d import (
    MexicanHat2D, Morlet2D, continuous_wavelet2d,
)

WAVELETS_2D = [MexicanHat2D(), MexicanHat2D(sigma=1.7), Morlet2D(),
               Morlet2D(k0=6.0)]


@pytest.mark.parametrize("w", WAVELETS_2D,
                         ids=lambda w: f"{w.name}")
def test_psi_hat_matches_numerical_fft2_of_psi(w):
    # psi-hat(k) must be the 2D Fourier transform of psi(x) under the
    # module's convention psi_hat(k) = integral psi(x) e^{-i k.x} d2x.
    # Unlike the 1D reference families (which carry parity-mandated
    # normalization quirks), these are our own formulas: exact match.
    n = 256
    dx = 0.125
    t = (np.arange(n) - n // 2) * dx
    X, Y = np.meshgrid(t, t, indexing="xy")
    psi = np.asarray(w.psi(jnp.asarray(X), jnp.asarray(Y)))
    ft = np.fft.fft2(psi) * dx * dx
    k = 2 * np.pi * np.fft.fftfreq(n, dx)
    # undo the n//2 grid offset phase in both axes
    phase = np.exp(1j * k * (n // 2) * dx)
    ft = ft * phase[None, :] * phase[:, None]
    KX, KY = np.meshgrid(k, k, indexing="xy")
    sel = (np.abs(KX) < 12) & (np.abs(KY) < 12)
    want = np.asarray(w.psi_hat(jnp.asarray(KX), jnp.asarray(KY)))
    scale = np.abs(want[sel]).max()
    assert scale > 0.1  # the window actually contains the passband
    np.testing.assert_allclose(ft[sel], want[sel], atol=2e-6 * scale)


@pytest.mark.parametrize("w", WAVELETS_2D, ids=lambda w: f"{w.name}")
def test_unit_l2_norm(w):
    n = 512
    dx = 0.0625
    t = (np.arange(n) - n // 2) * dx
    X, Y = np.meshgrid(t, t, indexing="xy")
    psi = np.asarray(w.psi(jnp.asarray(X), jnp.asarray(Y)))
    assert abs(np.sum(np.abs(psi) ** 2) * dx * dx - 1.0) < 1e-6


@pytest.mark.parametrize("w", WAVELETS_2D, ids=lambda w: f"{w.name}")
def test_zero_mean_admissibility_2d(w):
    val = complex(np.asarray(w.psi_hat(jnp.array(0.0), jnp.array(0.0))))
    # Morlet2D omits the admissibility correction (k0 >= 5 regime).
    tol = 1e-10 if w.real_even_hat else 1e-5
    assert abs(val) < tol


def test_scaling_law_preserves_l2():
    # psi_scaled = a^-1 psi(r(-theta) x / a) must keep unit L2 at any (a, th).
    w = MexicanHat2D()
    n, dx = 512, 0.125
    t = (np.arange(n) - n // 2) * dx
    X, Y = np.meshgrid(t, t, indexing="xy")
    for a, th in [(2.0, 0.0), (0.5, 0.7), (3.0, -1.1)]:
        psi = np.asarray(w.psi_scaled(jnp.asarray(X), jnp.asarray(Y), a, th))
        assert abs(np.sum(np.abs(psi) ** 2) * dx * dx - 1.0) < 1e-4


def test_mexican_hat_blob_detection():
    # A Gaussian blob of width sigma_b: under the L2-preserving (1/a)
    # normalization the LoG center response is W(a) ~ a^3/(sigma_b^2+a^2)^2,
    # which peaks at a = sqrt(3)*sigma_b — the scale-space matched-filter
    # property in this convention.
    n = 128
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64)
    sigma_b = 4.0
    img = np.exp(-((xx - n / 2) ** 2 + (yy - n / 2) ** 2) / (2 * sigma_b**2))
    scales = np.linspace(1.0, 10.0, 19)
    res = cwt2(img, scales, MexicanHat2D())
    assert res.coefficients.shape == (19, n, n)
    # real fast path: real image x real-even psi-hat -> real dtype out
    assert not jnp.issubdtype(res.coefficients.dtype, jnp.complexfloating)
    center = np.asarray(res.coefficients)[:, n // 2, n // 2]
    best = scales[np.argmax(np.abs(center))]
    assert abs(best - np.sqrt(3.0) * sigma_b) <= 0.5


def test_morlet2d_orientation_selectivity():
    # A plane wave along direction theta0: the angle sweep must peak there.
    n = 128
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64)
    theta0 = np.pi / 3
    kmag = 2 * np.pi * 8 / n  # 8 cycles across the image
    img = np.cos(kmag * (np.cos(theta0) * xx + np.sin(theta0) * yy))
    w = Morlet2D()
    scale = w.k0 / kmag  # passband center |k| = k0/a matches kmag
    angles = np.linspace(0, np.pi, 12, endpoint=False)
    res = cwt2(img, [scale], w, angles=angles)
    assert res.coefficients.shape == (1, 12, n, n)
    energy = np.asarray(res.scalogram)[0]
    assert angles[np.argmax(energy)] == pytest.approx(theta0, abs=np.pi / 12)


def test_real_fast_path_matches_complex_path():
    # Force the full complex plane by feeding a complex-cast image; the real
    # half-plane path must agree to float tolerance.
    rng = np.random.default_rng(7)
    img = rng.standard_normal((64, 48))
    scales = [2.0, 3.5, 5.0]
    w = MexicanHat2D()
    r_real = cwt2(img, scales, w)
    r_cplx = cwt2(img.astype(np.complex128), scales, w)
    assert jnp.issubdtype(r_cplx.coefficients.dtype, jnp.complexfloating)
    np.testing.assert_allclose(np.asarray(r_real.coefficients),
                               np.asarray(r_cplx.coefficients.real),
                               atol=1e-10)
    assert np.abs(np.asarray(r_cplx.coefficients.imag)).max() < 1e-10


def test_batched_and_jitted(rng=np.random.default_rng(3)):
    imgs = rng.standard_normal((2, 3, 32, 32))
    scales = (1.5, 3.0)
    f = jax.jit(lambda x: cwt2(x, scales, MexicanHat2D()).coefficients)
    out = f(jnp.asarray(imgs))
    assert out.shape == (2, 3, 2, 32, 32)
    one = cwt2(imgs[1, 2], scales, MexicanHat2D()).coefficients
    np.testing.assert_allclose(np.asarray(out[1, 2]), np.asarray(one),
                               rtol=0, atol=1e-9)


def test_chunked_path_matches_unchunked():
    # Enough (scale x angle) planes on a big-enough image to cross the
    # 8M-element chunking knee; parity vs a small case computed per-plane.
    rng = np.random.default_rng(11)
    img = rng.standard_normal((256, 256))
    scales = np.linspace(2.0, 20.0, 16)
    angles = np.linspace(0, np.pi, 10, endpoint=False)
    w = Morlet2D()
    full = cwt2(img, scales, w, angles=angles)  # 160 planes > knee
    assert full.coefficients.shape == (16, 10, 256, 256)
    # spot-check three (scale, angle) cells against single-plane runs
    for si, ai in [(0, 0), (7, 4), (15, 9)]:
        single = cwt2(img, [scales[si]], w, angles=[angles[ai]])
        np.testing.assert_allclose(
            np.asarray(full.coefficients[si, ai]),
            np.asarray(single.coefficients[0, 0]), atol=1e-10)


def test_result_container_and_factory():
    img = np.zeros((16, 16))
    img[8, 8] = 1.0
    res = cwt2(img, [1.0, 2.0], continuous_wavelet2d("log"))
    assert res.wavelet_name == "Mexican Hat 2D"
    assert res.angles is None
    assert res.scalogram.shape == (2,)
    assert res.magnitude.shape == (2, 16, 16)
    w = continuous_wavelet2d("morlet 2d", 6.5)
    assert isinstance(w, Morlet2D) and w.k0 == 6.5
    with pytest.raises(ValueError):
        continuous_wavelet2d("nope")
    with pytest.raises(ValueError):
        cwt2(np.zeros(8), [1.0])
    with pytest.raises(ValueError):
        cwt2(img, [-1.0])
    with pytest.raises(ValueError):
        MexicanHat2D(sigma=0.0)
    with pytest.raises(ValueError):
        Morlet2D(k0=-1.0)


def test_icwt2_reconstructs_band_limited_image(rng):
    n = 64
    xg, yg = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    img = (np.sin(2 * np.pi * xg / 8) * np.cos(2 * np.pi * yg / 10)
           + 0.5 * np.sin(2 * np.pi * (xg + yg) / 16))
    img -= img.mean()
    scales = np.asarray(jw.generate_log_scales(1.0, 8.0, 24))
    # isotropic (real coefficients)
    res = jw.cwt2(img, scales, jw.MexicanHat2D())
    rec = np.asarray(jw.icwt2(res, jw.MexicanHat2D()))
    e = np.linalg.norm(rec - img) / np.linalg.norm(img)
    assert e < 0.05, e
    # directional complex grid: Hermitian-completed calibration
    angles = np.linspace(0, np.pi, 8, endpoint=False)
    res2 = jw.cwt2(img, scales, jw.Morlet2D(), angles=angles)
    rec2 = np.asarray(jw.icwt2(res2, jw.Morlet2D()))
    e2 = np.linalg.norm(rec2 - img) / np.linalg.norm(img)
    assert e2 < 0.05, e2


def test_icwt2_jit_static_grids(rng):
    img = rng.standard_normal((2, 32, 32))
    img -= img.mean(axis=(-2, -1), keepdims=True)
    scales = tuple(float(s) for s in jw.generate_log_scales(1.0, 6.0, 16))
    import jax
    f = jax.jit(lambda c: jw.icwt2(jw.cwt2(c, scales, jw.MexicanHat2D()),
                                   jw.MexicanHat2D(), scales=scales))
    out = np.asarray(f(img))
    assert out.shape == img.shape and np.isfinite(out).all()
