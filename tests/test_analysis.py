"""Wavelet-domain analysis tests: variance-built statistics + coherence.

Covers the tools built on the reference's proposed (never implemented)
financial roadmap (`docs/FINANCIAL_ROADMAP.md`): per-scale correlation,
lagged cross-correlation, and CWT squared wavelet coherence with
Torrence–Compo smoothing.  The MODWT variance/covariance primitives
themselves are covered in test_modwt.py / test_pallas_kernels.py.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import jwave_pro as jw
from jwave_pro.ops.analysis import (
    _coherence_smoothers, _smooth, modwt_correlation,
    modwt_cross_correlation, wavelet_coherence,
)
from jwave_pro.ops.cwt import generate_log_scales
from jwave_pro.wavelets.continuous import (
    MexicanHatWavelet, MorletWavelet,
)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


DB4 = jw.wavelet("Daubechies 4")


class TestModwtCorrelation:
    def test_self_correlation_is_one(self, rng):
        x = rng.standard_normal(512)
        rho = np.asarray(modwt_correlation(x, x, DB4, 4))
        np.testing.assert_allclose(rho, 1.0, atol=1e-10)

    def test_bounded_and_symmetric(self, rng):
        x = rng.standard_normal(512)
        y = 0.5 * x + rng.standard_normal(512)
        rho = np.asarray(modwt_correlation(x, y, DB4, 4))
        assert np.all(np.abs(rho) <= 1.0 + 1e-12)
        rho_t = np.asarray(modwt_correlation(y, x, DB4, 4))
        np.testing.assert_allclose(rho, rho_t, atol=1e-10)

    def test_anticorrelated(self, rng):
        x = rng.standard_normal(512)
        rho = np.asarray(modwt_correlation(x, -x, DB4, 3))
        np.testing.assert_allclose(rho, -1.0, atol=1e-10)


class TestModwtCrossCorrelation:
    def test_recovers_circular_lag(self, rng):
        x = rng.standard_normal(1024)
        lag = 5
        y = np.roll(x, lag)  # y[t] = x[t-lag] → x leads y by `lag`
        cc = np.asarray(modwt_cross_correlation(x, y, DB4, 4, 8))
        assert cc.shape == (4, 17)
        assert np.all(cc.argmax(axis=1) - 8 == lag)
        np.testing.assert_allclose(cc.max(axis=1), 1.0, atol=1e-10)

    def test_zero_lag_column_matches_correlation(self, rng):
        x = rng.standard_normal(512)
        y = rng.standard_normal(512)
        cc = np.asarray(modwt_cross_correlation(x, y, DB4, 3, 4))
        rho = np.asarray(modwt_correlation(x, y, DB4, 3, method="direct"))
        np.testing.assert_allclose(cc[:, 4], rho, atol=1e-10)

    def test_oracle_parity(self, rng):
        """Brute-force definition: mean_t W^x[t]·W^y[t+τ] / √(ν_x ν_y)."""
        x = rng.standard_normal(256)
        y = rng.standard_normal(256)
        lvl, ml = 3, 3
        cc = np.asarray(modwt_cross_correlation(x, y, DB4, lvl, ml))
        cx = np.asarray(jw.modwt(x, DB4, lvl))[:lvl]
        cy = np.asarray(jw.modwt(y, DB4, lvl))[:lvl]
        denom = np.sqrt((cx ** 2).mean(-1) * (cy ** 2).mean(-1))
        for ti, tau in enumerate(range(-ml, ml + 1)):
            want = np.mean(cx * np.roll(cy, -tau, axis=-1), axis=-1) / denom
            np.testing.assert_allclose(cc[:, ti], want, atol=1e-10)


class TestWaveletCoherence:
    def test_self_coherence_is_one(self, rng):
        x = rng.standard_normal(512)
        scales = np.asarray(generate_log_scales(2, 32, 16))
        res = wavelet_coherence(x, x, scales)
        r2 = np.asarray(res.coherence)
        np.testing.assert_allclose(r2, 1.0, atol=1e-8)

    def test_bounded(self, rng):
        x = rng.standard_normal(512)
        y = rng.standard_normal(512)
        scales = np.asarray(generate_log_scales(2, 32, 16))
        r2 = np.asarray(wavelet_coherence(x, y, scales).coherence)
        assert r2.min() >= 0.0 and r2.max() <= 1.0

    def test_common_tone_high_coherence(self, rng):
        """Two noisy copies of one tone: coherence ≈ 1 at the tone scale,
        low elsewhere."""
        n = 1024
        t = np.arange(n)
        tone = np.sin(2 * np.pi * t / 32)
        x = tone + 0.05 * rng.standard_normal(n)
        y = -0.7 * tone + 0.05 * rng.standard_normal(n)
        w = MorletWavelet()
        scales = np.asarray(generate_log_scales(2, 64, 24))
        res = wavelet_coherence(x, y, scales, w)
        # Morlet: scale for period P is a ≈ P·fc (fc ≈ 0.849/ω0-form);
        # just pick the scale row with max mean |Wx| as "the tone scale"
        mag = np.asarray(jw.cwt(x, scales, w).magnitude).mean(-1)
        srow = int(mag.argmax())
        r2 = np.asarray(res.coherence)
        assert r2[srow].mean() > 0.9
        # anti-phase relationship → phase ≈ ±π at the tone scale
        ph = np.asarray(res.phase)[srow]
        assert np.abs(ph).mean() > 2.5

    def test_smoothing_matches_direct_oracle(self, rng):
        """FFT-realized smoothing == direct circular convolution + boxcar."""
        n, s_count = 128, 10
        scales = tuple(np.exp(np.linspace(np.log(2), np.log(16), s_count)))
        tmult, width = _coherence_smoothers(scales, n, 1.0, 0.6)
        p = rng.standard_normal((s_count, n))
        got = np.asarray(_smooth(jnp.asarray(p), tmult, width))
        a = np.asarray(scales)
        d = np.arange(n, dtype=float)
        d = np.minimum(d, n - d)
        ker = np.exp(-0.5 * (d[None, :] / a[:, None]) ** 2)
        ker /= ker.sum(1, keepdims=True)
        ts = np.stack([np.real(np.fft.ifft(np.fft.fft(p[s]) *
                                           np.fft.fft(ker[s])))
                       for s in range(s_count)])
        # edge-truncated boxcar over scales
        h = width // 2
        want = np.zeros_like(ts)
        for i in range(s_count):
            lo, hi = max(i - h, 0), min(i + (width - 1 - h), s_count - 1)
            want[i] = ts[lo:hi + 1].mean(0)
        np.testing.assert_allclose(got, want, atol=1e-12)

    def test_complex_smoothing_matches_real_pair(self, rng):
        n, s_count = 128, 8
        scales = tuple(np.linspace(2.0, 9.0, s_count))  # non-log → width 1
        tmult, width = _coherence_smoothers(scales, n, 1.0, 0.6)
        assert width == 1
        pr = rng.standard_normal((s_count, n))
        pi = rng.standard_normal((s_count, n))
        got = np.asarray(_smooth(jnp.asarray(pr + 1j * pi), tmult, width))
        wr = np.asarray(_smooth(jnp.asarray(pr), tmult, width))
        wi = np.asarray(_smooth(jnp.asarray(pi), tmult, width))
        np.testing.assert_allclose(got, wr + 1j * wi, atol=1e-12)

    def test_real_psi_hat_wavelet(self, rng):
        """Mexican Hat returns real coefficients; coherence stays valid and
        phase is the sign (0 / π)."""
        x = rng.standard_normal(256)
        y = rng.standard_normal(256)
        scales = np.asarray(generate_log_scales(2, 16, 10))
        res = wavelet_coherence(x, y, scales, MexicanHatWavelet())
        r2 = np.asarray(res.coherence)
        assert r2.min() >= 0.0 and r2.max() <= 1.0
        assert set(np.round(np.unique(np.asarray(res.phase)), 6)) <= {
            0.0, np.round(np.pi, 6)}

    def test_jittable(self, rng):
        x = rng.standard_normal(256).astype(np.float32)
        y = rng.standard_normal(256).astype(np.float32)
        scales = tuple(np.asarray(generate_log_scales(2, 16, 8)))

        @jax.jit
        def f(x, y):
            return wavelet_coherence(x, y, scales).coherence

        r2 = np.asarray(f(x, y))
        want = np.asarray(wavelet_coherence(x, y, np.asarray(scales))
                          .coherence)
        np.testing.assert_allclose(r2, want, rtol=2e-5, atol=2e-5)


def _spectral_long_memory(rng, n, alpha, batch=()):
    """Gaussian series with S(f) ∝ |f|^{−alpha} via spectral synthesis."""
    f = np.fft.rfftfreq(n)
    amp = np.zeros_like(f)
    amp[1:] = f[1:] ** (-alpha / 2.0)
    z = rng.standard_normal(batch + (f.size,)) \
        + 1j * rng.standard_normal(batch + (f.size,))
    x = np.fft.irfft(z * amp, n=n)
    return x / x.std(axis=-1, keepdims=True)


class TestHurst:
    def test_white_noise_is_half(self, rng):
        x = rng.standard_normal((8, 1 << 14))
        h = np.asarray(jw.modwt_hurst(x, jw.wavelet("db4"), 8))
        assert np.abs(h.mean() - 0.5) < 0.05

    def test_random_walk_fbm_half(self, rng):
        x = np.cumsum(rng.standard_normal((8, 1 << 14)), axis=-1)
        h = np.asarray(jw.modwt_hurst(x, jw.wavelet("db4"), 8, kind="fbm"))
        assert np.abs(h.mean() - 0.5) < 0.07

    @pytest.mark.parametrize("h_true", [0.65, 0.8])
    def test_recovers_synthetic_long_memory(self, rng, h_true):
        # fGn-like: alpha = 2H − 1
        x = _spectral_long_memory(rng, 1 << 14, 2 * h_true - 1, batch=(8,))
        h = np.asarray(jw.modwt_hurst(x, jw.wavelet("db4"), 8))
        assert np.abs(h.mean() - h_true) < 0.06

    def test_antipersistent(self, rng):
        x = _spectral_long_memory(rng, 1 << 14, 2 * 0.3 - 1, batch=(8,))
        h = np.asarray(jw.modwt_hurst(x, jw.wavelet("db4"), 8))
        assert np.abs(h.mean() - 0.3) < 0.08

    def test_jittable_and_fit_outputs(self, rng):
        x = rng.standard_normal((2, 4096)).astype(np.float32)
        w = jw.wavelet("sym8")
        f = jax.jit(lambda v: jw.modwt_hurst(v, w, 6, return_fit=True))
        h, slope, intercept = f(x)
        assert h.shape == (2,) and slope.shape == (2,)
        np.testing.assert_allclose(np.asarray(h),
                                   (np.asarray(slope) + 2.0) / 2.0,
                                   atol=1e-6)
        # intercept reproduces the weighted fit at tbar
        h2 = np.asarray(jw.modwt_hurst(x, w, 6))
        np.testing.assert_allclose(np.asarray(h), h2, atol=1e-5)

    def test_validation(self, rng):
        x = rng.standard_normal(1024)
        w = jw.wavelet("db4")
        with pytest.raises(ValueError):
            jw.modwt_hurst(x, w, 5, min_level=5, max_level=5)
        with pytest.raises(ValueError):
            jw.modwt_hurst(x, w, 5, min_level=0)
        with pytest.raises(ValueError):
            jw.modwt_hurst(x, w, 5, max_level=9)
        with pytest.raises(ValueError):
            jw.modwt_hurst(x, w, 5, kind="nope")


class TestRobustness:
    """Regression tests for the round-2 review findings."""

    def test_coherence_dead_channel_no_nan(self, rng):
        # an all-zero channel must give 0 coherence, not NaN (0/0)
        x = rng.standard_normal(1024)
        y = np.zeros(1024)
        scales = generate_log_scales(2.0, 32.0, 8)
        r = jw.wavelet_coherence(x, y, scales, MexicanHatWavelet())
        c = np.asarray(r.coherence)
        assert np.isfinite(c).all()
        assert c.max() <= 1e-6

    def test_fused_variance_guards(self, rng):
        w = jw.wavelet("db4")
        x3 = rng.standard_normal((2, 3, 512)).astype(np.float32)
        with pytest.raises(ValueError, match="fused variance"):
            jw.modwt_variance(x3, w, 3, method="fused")
        x64 = rng.standard_normal((4, 512))  # float64
        with pytest.raises(ValueError, match="float32"):
            jw.modwt_variance(x64, w, 3, method="fused")

    def test_fused_covariance_shape_mismatch(self, rng):
        w = jw.wavelet("db4")
        x = rng.standard_normal((4, 512)).astype(np.float32)
        y = rng.standard_normal((4, 256)).astype(np.float32)
        with pytest.raises(ValueError, match="x.shape == y.shape"):
            jw.modwt_covariance(x, y, w, 3, method="fused")

    def test_cross_correlation_rejects_fused(self, rng):
        w = jw.wavelet("db4")
        x = rng.standard_normal((4, 512)).astype(np.float32)
        with pytest.raises(ValueError, match="no fused"):
            jw.modwt_cross_correlation(x, x, w, 3, 4, method="fused")

    def test_scale_energies_complex(self, rng):
        x = rng.standard_normal(256)
        c = jw.cwt(x, [2.0, 4.0], MorletWavelet()).coefficients
        e = np.asarray(jw.scale_energies(c))
        assert not np.iscomplexobj(e)
        np.testing.assert_allclose(
            e, np.sum(np.abs(np.asarray(c)) ** 2, axis=-1), rtol=1e-6)


class TestUnbiasedVarianceAndCI:
    def test_unbiased_matches_masked_oracle(self, rng):
        from jwave_pro.ops.analysis import _boundary_counts
        x = rng.standard_normal(300)
        lvl = 3
        c = np.asarray(jw.modwt(x, DB4, lvl, method="direct"))
        got = np.asarray(jw.modwt_variance(x, DB4, lvl, method="direct",
                                           estimator="unbiased"))
        for j, (nb, m) in enumerate(_boundary_counts(300, lvl, DB4.length),
                                    start=1):
            want = np.sum(c[j - 1, nb:] ** 2) / m
            np.testing.assert_allclose(got[j - 1], want, rtol=1e-12)

    def test_unbiased_level_guard(self, rng):
        # level 5 Db4: L_5 - 1 = 31*7 = 217 boundary coeffs > N=200 interior
        with pytest.raises(ValueError, match="interior"):
            jw.modwt_variance(rng.standard_normal(200), DB4, 5,
                              estimator="unbiased")

    def test_reflect_boundary_shrinks_leakage(self, rng):
        # A strong linear trend leaks into coarse scales via the circular
        # wrap (x[N-1] -> x[0] jump); reflection removes the jump.  The
        # biased estimator includes the wrap-affected coefficients, so the
        # deepest-scale variance must drop by orders of magnitude (the
        # unbiased brick-wall excludes them by construction and is already
        # clean — checked too).
        n = 512
        x = np.linspace(0.0, 10.0, n) + 0.01 * rng.standard_normal(n)
        vp = np.asarray(jw.modwt_variance(x, DB4, 4, method="direct"))
        vr = np.asarray(jw.modwt_variance(x, DB4, 4, method="direct",
                                          boundary="reflect"))
        assert vr[-1] < 1e-2 * vp[-1]
        vu_p = np.asarray(jw.modwt_variance(x, DB4, 4, method="direct",
                                            estimator="unbiased"))
        assert vu_p[-1] < 1e-2 * vp[-1]

    def test_ci_brackets_point_estimate_and_coverage(self, rng):
        x = rng.standard_normal((8, 1024))
        ci = jw.modwt_variance_ci(x, DB4, 3, confidence=0.95,
                                  method="direct")
        v, lo, hi = (np.asarray(a) for a in (ci.variance, ci.lower, ci.upper))
        assert np.all(lo < v) and np.all(v < hi)
        assert ci.edf.shape == (3,) and np.all(np.diff(ci.edf) < 0)
        # white noise: true per-scale variance is 1/2^j (energy split in
        # half per octave); the 95% band should contain it nearly always
        truth = 0.5 ** np.arange(1, 4)[:, None]
        hits = np.mean((lo <= truth) & (truth <= hi))
        assert hits > 0.8

    def test_ci_jits(self, rng):
        x = rng.standard_normal(256)
        f = jax.jit(lambda v: jw.modwt_variance_ci(v, DB4, 2,
                                                   method="direct")[:3])
        v, lo, hi = f(x)
        assert np.all(np.asarray(lo) < np.asarray(v))

    def test_biased_default_unchanged(self, rng):
        x = rng.standard_normal(128)
        a = np.asarray(jw.modwt_variance(x, DB4, 3, method="direct"))
        c = np.asarray(jw.modwt(x, DB4, 3, method="direct"))
        np.testing.assert_allclose(a, np.mean(c[:3] ** 2, axis=-1),
                                   rtol=1e-12)


class TestHilbert:
    def test_analytic_signal_of_tone(self):
        # H[cos] = sin → analytic signal of cos(ωt) is e^{iωt}
        # (bin-aligned tone: the circular Hilbert transform is exact)
        n, f0 = 1024, 50.0 / 1024
        t = np.arange(n)
        z = np.asarray(jw.hilbert(jnp.asarray(np.cos(2 * np.pi * f0 * t))))
        np.testing.assert_allclose(z.real, np.cos(2 * np.pi * f0 * t),
                                   atol=1e-10)
        np.testing.assert_allclose(z.imag, np.sin(2 * np.pi * f0 * t),
                                   atol=1e-10)

    def test_envelope_of_am_signal(self):
        n = 2048
        t = np.arange(n)
        am = 1.0 + 0.5 * np.sin(2 * np.pi * 0.004 * t)
        x = am * np.sin(2 * np.pi * 0.2 * t)
        env = np.asarray(jw.envelope(jnp.asarray(x)))
        # interior only (circular edge effects at the AM rate)
        np.testing.assert_allclose(env[64:-64], am[64:-64], rtol=2e-2)

    def test_instantaneous_frequency_of_chirp(self):
        n, fs = 4096, 1000.0
        t = np.arange(n) / fs
        f_inst = 50.0 + 100.0 * t  # linear chirp
        phase = 2 * np.pi * (50.0 * t + 50.0 * t**2)
        fi = np.asarray(jw.instantaneous_frequency(
            jnp.asarray(np.sin(phase)), sampling_rate=fs))
        mid = slice(256, -256)
        np.testing.assert_allclose(fi[mid], f_inst[:-1][mid], rtol=3e-2)

    def test_batch_odd_length_and_validation(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((3, 501))
        z = np.asarray(jw.hilbert(jnp.asarray(x)))
        assert z.shape == (3, 501)
        np.testing.assert_allclose(z.real, x, atol=1e-10)  # Re part exact
        one = np.asarray(jw.hilbert(jnp.asarray(x[1])))
        np.testing.assert_allclose(z[1], one, atol=1e-12)
        with pytest.raises(ValueError, match="real"):
            jw.hilbert(jnp.asarray(x, dtype=complex))
