"""Empirical Wavelet Transform (ops/ewt.py).

Validates the defining properties: tight frame (Σf² ≡ 1), exact adjoint
reconstruction, adaptive boundary placement between spectral peaks, mode
separation of multicomponent signals, and jit/batch/grad mechanics.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import jwave_pro as jw
from jwave_pro.ops.ewt import ewt_filter_bank


def _three_tone(n=2048, noise=0.05, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = (np.sin(2 * np.pi * 0.03 * t) + 0.7 * np.sin(2 * np.pi * 0.13 * t)
         + 0.5 * np.sin(2 * np.pi * 0.31 * t))
    return x + noise * rng.standard_normal(n)


def test_tight_frame_and_exact_reconstruction():
    x = jnp.asarray(_three_tone())
    r = jw.ewt1d(x, 3)
    lp = np.asarray((r.filters ** 2).sum(axis=-2))
    np.testing.assert_allclose(lp, 1.0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(r.reconstruct()), np.asarray(x),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(jw.iewt1d(r.components, r.filters)),
                               np.asarray(x), atol=1e-12)


def test_peak_detection_and_mode_separation():
    x = _three_tone()
    r = jw.ewt1d(jnp.asarray(x), 3)
    freqs = np.asarray(r.peaks) / (2 * np.pi)
    np.testing.assert_allclose(freqs, [0.03, 0.13, 0.31], atol=2e-3)
    b = np.asarray(r.boundaries) / (2 * np.pi)
    assert np.all(b > freqs[:-1]) and np.all(b < freqs[1:])
    # each mode carries exactly one tone
    n = x.shape[-1]
    for k, f0 in enumerate([0.03, 0.13, 0.31]):
        c = np.asarray(r.components)[k]
        assert abs(np.abs(np.fft.rfft(c)).argmax() / n - f0) < 2e-3
    # energy: tight frame is an isometry on the analysis side
    e = float(np.sum(np.asarray(r.components) ** 2))
    assert abs(e - np.sum(x ** 2)) / np.sum(x ** 2) < 1e-10


def test_explicit_boundaries_and_filter_bank():
    x = jnp.asarray(_three_tone())
    b = jnp.asarray([0.5, 1.5])
    r = jw.ewt1d(x, 3, boundaries=b)
    np.testing.assert_allclose(np.asarray(r.boundaries), np.asarray(b))
    np.testing.assert_allclose(np.asarray(r.reconstruct()), np.asarray(x),
                               atol=1e-12)
    f = np.asarray(ewt_filter_bank(b, 2048))
    assert f.shape == (3, 1025)
    np.testing.assert_allclose((f ** 2).sum(axis=0), 1.0, atol=1e-12)
    # scaling function is 1 at DC, last wavelet is 1 at Nyquist
    assert abs(f[0, 0] - 1.0) < 1e-12 and abs(f[-1, -1] - 1.0) < 1e-12


def test_batched_adaptive_banks_differ():
    n = 1024
    t = np.arange(n)
    xa = np.sin(2 * np.pi * 0.05 * t) + np.sin(2 * np.pi * 0.4 * t)
    xb = np.sin(2 * np.pi * 0.15 * t) + np.sin(2 * np.pi * 0.25 * t)
    r = jw.ewt1d(jnp.asarray(np.stack([xa, xb])), 2)
    assert r.components.shape == (2, 2, n)
    b = np.asarray(r.boundaries)
    assert b.shape == (2, 1)
    assert abs(b[0, 0] - b[1, 0]) > 0.1  # per-signal adaptation
    np.testing.assert_allclose(np.asarray(r.reconstruct()),
                               np.stack([xa, xb]), atol=1e-12)


def test_jit_and_grad():
    x = jnp.asarray(_three_tone(512), jnp.float32)
    f = jax.jit(lambda v: jw.ewt1d(v, 3).components)
    c = np.asarray(f(x))
    assert c.shape == (3, 512) and np.isfinite(c).all()
    g = jax.grad(lambda v: jnp.sum(jw.ewt1d(v, 3).components ** 2))(x)
    assert g.shape == x.shape and bool(jnp.all(jnp.isfinite(g)))


def test_validation():
    x = jnp.asarray(_three_tone(512))
    with pytest.raises(ValueError, match="at least 2"):
        jw.ewt1d(x, 1)
    with pytest.raises(ValueError, match="too large"):
        jw.ewt1d(x, 200)
    with pytest.raises(ValueError, match="real"):
        jw.ewt1d(x.astype(complex), 3)
    with pytest.raises(ValueError, match="boundaries"):
        jw.ewt1d(x, 3, boundaries=jnp.asarray([0.5]))
    with pytest.raises(ValueError, match="boundary"):
        ewt_filter_bank(jnp.zeros((0,)), 512)
