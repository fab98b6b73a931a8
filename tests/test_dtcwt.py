"""Dual-tree complex wavelet transform (ops/dtcwt.py).

Validates the q-shift common-factor DESIGN (orthonormality, vanishing
moments, half-sample delay, wavelet-pair analyticity) and the transform's
defining properties (exact PR, energy partition, near-shift-invariant
magnitudes vs the shift-variant per-tree coefficients).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import jwave_pro as jw


def _freq_resp(taps, omega):
    return sum(c * np.exp(-1j * k * omega) for k, c in enumerate(taps))


class TestQShiftDesign:
    @pytest.mark.parametrize("k,l", [(2, 2), (3, 2), (3, 3), (4, 3)])
    def test_orthonormal_and_unit_sum(self, k, l):
        for h in jw.qshift_design(k, l):
            assert len(h) % 2 == 0
            for lag in range(1, len(h) // 2):
                assert abs(np.dot(h[:len(h) - 2 * lag], h[2 * lag:])) < 1e-12
            assert abs(np.linalg.norm(h) - 1.0) < 1e-12
            assert abs(h.sum() - np.sqrt(2)) < 1e-10

    def test_vanishing_moments(self):
        k, l = 4, 3
        h0a, _ = jw.qshift_design(k, l)
        n = np.arange(len(h0a))
        # K vanishing moments ⇔ Σ (−1)^n n^p h0[n] = 0 for p < K
        for p in range(k):
            assert abs(np.sum((-1.0) ** n * n**p * h0a)) < 1e-8, p

    def test_half_sample_delay(self):
        h0a, h0b = jw.qshift_design(4, 3)
        w = np.linspace(-0.8 * np.pi, 0.8 * np.pi, 1001)
        err = np.abs(_freq_resp(h0b, w)
                     - np.exp(-1j * w / 2) * _freq_resp(h0a, w))
        # the Thiran flatness is centered at ω = 0; the absolute error
        # grows into the stopband where |H| itself decays
        assert err[np.abs(w) < np.pi / 2].max() < 5e-3
        assert err.max() < 2e-2

    @pytest.mark.parametrize("k,l,bound", [(3, 2, 1e-3), (4, 3, 1e-4)])
    def test_wavelet_pair_analyticity(self, k, l, bound):
        # ψ̂ via the truncated infinite product; ψ_a + iψ_b must be
        # (near-)one-sided in frequency
        wa, wb = jw.qshift_wavelets(k, l)
        n = 1 << 13
        om = 2 * np.pi * (np.arange(n) - n // 2) / (n / 64)

        def psi_hat(wav):
            h0 = wav.dec_lo / np.sqrt(2)
            h1 = wav.dec_hi / np.sqrt(2)
            out = _freq_resp(h1, om / 2)
            for j in range(2, 12):
                out = out * _freq_resp(h0, om / 2**j)
            return out

        pc = psi_hat(wa) + 1j * psi_hat(wb)
        e = np.abs(pc) ** 2
        frac = e[om < 0].sum() / e.sum()
        assert frac < bound, frac

    def test_design_validation(self):
        with pytest.raises(ValueError):
            jw.qshift_design(0, 3)


class TestDTCWT:
    def test_exact_reconstruction_and_energy(self, rng):
        x = jnp.asarray(rng.standard_normal((3, 768)))  # 768 = 2^8·3
        r = jw.dtcwt(x, 5)
        assert [h.shape[-1] for h in r.highpass] == [384, 192, 96, 48, 24]
        np.testing.assert_allclose(np.asarray(jw.idtcwt(r)), np.asarray(x),
                                   atol=1e-10)
        e = (sum(float(jnp.sum(jnp.abs(h) ** 2)) for h in r.highpass)
             + 0.5 * float(jnp.sum(r.lowpass_a**2) + jnp.sum(r.lowpass_b**2)))
        assert abs(e / float(jnp.sum(x**2)) - 1.0) < 1e-12

    def test_magnitude_shift_invariance(self, rng):
        # the POINT of the dual tree: |w| barely moves under a 1-sample
        # shift while the per-tree (real DWT) coefficients scramble
        x = jnp.asarray(rng.standard_normal(1024))
        r0 = jw.dtcwt(x, 4)
        r1 = jw.dtcwt(jnp.roll(x, 1), 4)
        for j in range(1, 4):  # levels 2..4 (level 1 is trivially good)
            a, b = r0.highpass[j], r1.highpass[j]
            mag_var = abs(float(jnp.sum(jnp.abs(a) ** 2))
                          - float(jnp.sum(jnp.abs(b) ** 2))) / float(
                              jnp.sum(jnp.abs(a) ** 2))
            re_var = abs(float(jnp.sum(jnp.real(a) ** 2))
                         - float(jnp.sum(jnp.real(b) ** 2))) / max(
                             float(jnp.sum(jnp.real(a) ** 2)), 1e-30)
            assert mag_var < 0.02, (j, mag_var)
            assert mag_var < 0.25 * re_var, (j, mag_var, re_var)

    def test_tone_magnitude_is_smooth(self):
        # analytic subband: a tone's |w| is a near-constant envelope,
        # while the real part oscillates through zero
        n = 1024
        x = jnp.asarray(np.sin(2 * np.pi * 24 / n * np.arange(n)))
        r = jw.dtcwt(x, 4)
        w = np.asarray(r.highpass[3])  # level-4 band ≈ [fs/32, fs/16]
        mag, re = np.abs(w), np.real(w)
        assert mag.std() / mag.mean() < 0.05
        # the real part oscillates through zero (|cos|-like: std/mean ≈ .48)
        assert np.abs(re).std() / max(np.abs(re).mean(), 1e-30) > 0.3

    def test_jit_batch_grad_f32(self, rng):
        x = jnp.asarray(rng.standard_normal((2, 256)), jnp.float32)
        f = jax.jit(lambda v: jw.dtcwt(v, 3).magnitudes)
        mags = f(x)
        assert mags[0].dtype == jnp.float32
        single = jw.dtcwt(x[1], 3).magnitudes
        np.testing.assert_allclose(np.asarray(mags[0][1]),
                                   np.asarray(single[0]), atol=1e-5)
        g = jax.grad(lambda v: sum(jnp.sum(m) for m in
                                   jw.dtcwt(v, 3).magnitudes))(x)
        assert g.shape == x.shape and bool(jnp.all(jnp.isfinite(g)))

    def test_custom_level1_and_design_params(self, rng):
        x = jnp.asarray(rng.standard_normal(256))
        w1 = jw.wavelet("Daubechies 6")
        r = jw.dtcwt(x, 3, level1=w1, k=3, l=2)
        np.testing.assert_allclose(
            np.asarray(jw.idtcwt(r, level1=w1, k=3, l=2)), np.asarray(x),
            atol=1e-10)

    def test_validation(self, rng):
        x = jnp.asarray(rng.standard_normal(100))
        with pytest.raises(ValueError, match="divisible"):
            jw.dtcwt(x, 3)
        with pytest.raises(ValueError, match="level"):
            jw.dtcwt(x, 0)
        with pytest.raises(ValueError, match="real"):
            jw.dtcwt(x.astype(complex), 2)


class TestDTCWTDenoise:
    def test_1d_mse_improves_and_shift_consistency(self, rng):
        # piecewise-constant signal — the standard wavelet-thresholding
        # setting (sustained tones spread energy across many mid-size
        # coefficients and defeat ANY universal rule: the MODWT pipeline
        # measures 5.7× WORSE-than-noisy there, dtcwt 1.3×)
        n = 2048
        t = np.arange(n)
        clean = np.where((t // 256) % 2 == 0, 1.0, -1.0).astype(float)
        noisy = clean + 0.3 * rng.standard_normal(n)
        mse_in = np.mean((noisy - clean) ** 2)
        den_soft = np.asarray(jw.dtcwt_denoise(jnp.asarray(noisy), 5))
        assert np.mean((den_soft - clean) ** 2) < 0.6 * mse_in
        den = np.asarray(jw.dtcwt_denoise(jnp.asarray(noisy), 5,
                                          mode="hard"))
        assert np.mean((den - clean) ** 2) < 0.3 * mse_in
        # near shift-invariance of the PIPELINE: denoise(roll) ≈ roll(denoise)
        den_s = np.asarray(jw.dtcwt_denoise(jnp.asarray(np.roll(noisy, 1)),
                                            5, mode="hard"))
        drift = np.linalg.norm(den_s - np.roll(den, 1)) / np.linalg.norm(den)
        assert drift < 0.15, drift

    def test_2d_mse_improves(self, rng):
        h = w = 64
        i, j = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        clean = np.sin(2 * np.pi * (3 * i + 5 * j) / h)
        noisy = clean + 0.5 * rng.standard_normal((h, w))
        den = np.asarray(jw.dtcwt2_denoise(jnp.asarray(noisy), 3))
        assert (np.mean((den - clean) ** 2)
                < 0.35 * np.mean((noisy - clean) ** 2))

    def test_hard_mode_and_explicit_threshold(self, rng):
        x = jnp.asarray(rng.standard_normal(256))
        out = jw.dtcwt_denoise(x, 3, mode="hard", threshold=10.0)
        # huge threshold kills every detail band; only lowpass survives
        r = jw.dtcwt(out, 3)
        assert float(sum(jnp.sum(jnp.abs(h) ** 2)
                         for h in r.highpass)) < 0.05 * float(jnp.sum(x**2))
        with pytest.raises(ValueError, match="mode"):
            jw.dtcwt_denoise(x, 2, mode="bogus")


class TestDTCWT2D:
    def test_exact_reconstruction_and_energy(self, rng):
        x = jnp.asarray(rng.standard_normal((2, 64, 96)))
        r = jw.dtcwt2(x, 3)
        assert [h.shape[-3:] for h in r.highpass] == [
            (6, 32, 48), (6, 16, 24), (6, 8, 12)]
        assert r.lowpass.shape[-3:] == (4, 8, 12)
        np.testing.assert_allclose(np.asarray(jw.idtcwt2(r)), np.asarray(x),
                                   atol=1e-10)
        e = (0.5 * sum(float(jnp.sum(jnp.abs(h) ** 2)) for h in r.highpass)
             + 0.25 * float(jnp.sum(r.lowpass**2)))
        assert abs(e / float(jnp.sum(x**2)) - 1.0) < 1e-12

    def test_orientation_sign_selectivity(self):
        # ±45° gratings in the level-1 band must land in opposite members
        # of each (z+, z−) pair with strong selectivity
        i, j = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
        f0 = 0.3  # cycles/sample → in the level-1 half-band
        rp = jw.dtcwt2(jnp.asarray(np.cos(2 * np.pi * f0 * (i + j))), 2)
        rm = jw.dtcwt2(jnp.asarray(np.cos(2 * np.pi * f0 * (i - j))), 2)
        ep = [float(jnp.sum(jnp.abs(rp.highpass[0][b]) ** 2))
              for b in range(6)]
        em = [float(jnp.sum(jnp.abs(rm.highpass[0][b]) ** 2))
              for b in range(6)]
        # HH pair (bands 4, 5) dominates for diagonal gratings and flips
        assert ep[4] > 5 * ep[5] and em[5] > 5 * em[4]
        assert ep[4] > 2 * max(ep[0], ep[1], ep[2], ep[3])

    def test_magnitude_shift_invariance_2d(self, rng):
        x = jnp.asarray(rng.standard_normal((64, 64)))
        r0 = jw.dtcwt2(x, 3)
        r1 = jw.dtcwt2(jnp.roll(x, (1, 1), axis=(-2, -1)), 3)
        for jlev in range(1, 3):
            a, b = r0.highpass[jlev], r1.highpass[jlev]
            ea = float(jnp.sum(jnp.abs(a) ** 2))
            var = abs(ea - float(jnp.sum(jnp.abs(b) ** 2))) / ea
            assert var < 0.03, (jlev, var)

    def test_jit_batch_f32(self, rng):
        x = jnp.asarray(rng.standard_normal((2, 32, 32)), jnp.float32)
        f = jax.jit(lambda v: jw.idtcwt2(jw.dtcwt2(v, 2)))
        np.testing.assert_allclose(np.asarray(f(x)), np.asarray(x),
                                   atol=1e-5)

    def test_validation(self, rng):
        with pytest.raises(ValueError, match="divisible"):
            jw.dtcwt2(jnp.asarray(rng.standard_normal((60, 64))), 3)
        with pytest.raises(ValueError, match="image"):
            jw.dtcwt2(jnp.asarray(rng.standard_normal(64)), 2)
