"""CWT tests: wavelet properties, FFT path behavior, result container.

Mirrors ContinuousWaveletTransformTest / DOGWaveletTest / PaulWaveletTest /
MeyerWaveletTest themes (SURVEY §4.5) without the JVM.
"""
import numpy as np
import pytest

import jwave_pro as jw
from jwave_pro.ops.cwt import (
    cwt, cwt_direct, generate_linear_scales, generate_log_scales, pad_signal,
)
from jwave_pro.wavelets.continuous import (
    DOGWavelet, MexicanHatWavelet, MeyerWavelet, MorletWavelet, PaulWavelet,
)

WAVELETS = [MorletWavelet(), MexicanHatWavelet(), PaulWavelet(4),
            DOGWavelet(2), MeyerWavelet()]


@pytest.mark.parametrize("w", WAVELETS, ids=lambda w: w.name)
def test_psi_hat_matches_numerical_fft_of_psi(w):
    # ψ̂(ω) must be the Fourier transform ∫ψ(t)e^{-iωt}dt of ψ(t) — checked
    # numerically on a fine grid (the internal consistency the reference
    # never tests but relies on when mixing direct and FFT CWT paths).
    if isinstance(w, MeyerWavelet):
        pytest.skip("reference Meyer time-domain psi is an approximation "
                    "(MeyerWavelet.java:180-210)")
    if isinstance(w, DOGWavelet) and not isinstance(w, MexicanHatWavelet):
        pytest.skip(
            "reference DOG psi uses H_n(t/sigma) (DOGWavelet.java:166-176) "
            "whose true FT is not proportional to its psi-hat formula "
            "omega^n exp(-sigma^2 omega^2/2) (:187-217) — the Hermite "
            "argument would need t/(sigma*sqrt(2)); kept as-is for parity")
    n = 1 << 14
    dt = 1.0 / 64
    t = (np.arange(n) - n // 2) * dt
    psi = np.asarray(w.psi(t))
    freqs = np.fft.fftfreq(n, dt) * 2 * np.pi
    ft = np.fft.fft(psi) * dt * np.exp(1j * freqs * (n // 2) * dt)
    sel = np.abs(freqs) < 20.0
    want = np.asarray(w.psi_hat(freqs[sel]))
    # The reference's analytic psi-hat formulas carry family-specific
    # normalization constants that differ from the true FT of its psi
    # (e.g. Morlet psi-hat has an extra sqrt(2*pi*fb), MorletWavelet.java:
    # 114-125 vs :90-105).  Parity means reproducing that, so compare
    # SHAPES: the two must be proportional by one complex constant.
    big = np.abs(want) > 1e-2 * np.abs(want).max()
    ratio = ft[sel][big] / want[big]
    assert np.std(ratio.real) < 5e-3 * abs(np.mean(ratio))
    assert np.std(ratio.imag) < 5e-3 * abs(np.mean(ratio))


def test_dog_standard_presets():
    # DOGWavelet.java:401-406 createStandard + :56-76 WaveletType orders
    assert DOGWavelet.standard("edge").n == 1
    assert DOGWavelet.standard("MEXICAN_HAT").n == 2
    assert DOGWavelet.standard("Ricker", sigma=2.0).sigma == 2.0
    assert DOGWavelet.standard("zero_crossing").n == 3
    assert DOGWavelet.standard("ridge").n == 4
    with pytest.raises(ValueError, match="unknown DOG preset"):
        DOGWavelet.standard("bogus")


@pytest.mark.parametrize("w", WAVELETS, ids=lambda w: w.name)
def test_zero_mean_admissibility(w):
    # Admissible wavelets have ψ̂(0) = 0 (zero mean).
    val = complex(np.asarray(w.psi_hat(np.array(0.0))))
    assert abs(val) < 1e-6 or isinstance(w, MorletWavelet)  # Morlet ≈ 0


def test_morlet_detects_oscillation_frequency():
    fs = 100.0
    t = np.arange(512) / fs
    f0 = 10.0
    x = np.sin(2 * np.pi * f0 * t)
    w = MorletWavelet()
    scales = generate_log_scales(0.005, 0.3, 40)
    res = cwt(x, scales, w, sampling_rate=fs)
    mag = np.asarray(res.magnitude)[:, 100:400]  # avoid edges
    best = np.argmax(mag.mean(axis=1))
    # Physical-unit scales: f = fc/a.  (CWTResult.scaleToFrequency uses
    # fc*fs/a, i.e. sample-unit scales — a reference convention quirk kept
    # for parity; see CWTResult.java:185-197.)
    f_est = w.center_frequency / float(scales[best])
    assert abs(f_est - f0) / f0 < 0.15


def test_cwt_direct_close_to_fft_path():
    fs = 50.0
    t = np.arange(128) / fs
    x = np.sin(2 * np.pi * 5.0 * t) * np.exp(-((t - 1.2) ** 2))
    w = MorletWavelet()
    scales = np.array([0.05, 0.1, 0.2])
    r_fft = np.asarray(cwt(x, scales, w, fs).coefficients)
    r_dir = np.asarray(cwt_direct(x, scales, w, fs).coefficients)
    # The two reference paths differ by a constant factor per wavelet family
    # (Morlet: sqrt(2*pi*fb), see psi-hat test above) and in edge handling —
    # compare normalized interior shapes.
    mid = slice(30, 98)
    a = r_fft[:, mid] / np.abs(r_fft[:, mid]).max()
    b = r_dir[:, mid] / np.abs(r_dir[:, mid]).max()
    assert np.abs(a - b).max() < 0.05


def test_cwt_result_container():
    x = np.sin(np.linspace(0, 20, 256))
    scales = generate_linear_scales(1.0, 10.0, 8)
    res = cwt(x, scales, MexicanHatWavelet(), 1.0)
    assert res.coefficients.shape == (8, 256)
    assert res.magnitude.shape == (8, 256)
    assert res.phase.shape == (8, 256)
    assert res.scalogram.shape == (8,)
    assert res.wavelet_name == "Mexican Hat (Ricker)"
    assert np.asarray(res.time_axis)[1] == 1.0


def test_batched_cwt(rng):
    xb = rng.standard_normal((3, 128))
    scales = np.array([1.0, 2.0])
    res = cwt(xb, scales, MorletWavelet(), 1.0)
    assert res.coefficients.shape == (3, 2, 128)
    single = cwt(xb[1], scales, MorletWavelet(), 1.0)
    np.testing.assert_allclose(np.asarray(res.coefficients[1]),
                               np.asarray(single.coefficients), atol=1e-12)


def test_padding_modes(rng):
    x = rng.standard_normal(6)
    zp = np.asarray(pad_signal(x, 8, "zero"))
    np.testing.assert_allclose(zp[6:], 0)
    cp = np.asarray(pad_signal(x, 8, "constant"))
    np.testing.assert_allclose(cp[6:], x[-1])
    pp = np.asarray(pad_signal(x, 8, "periodic"))
    np.testing.assert_allclose(pp[6:], x[:2])
    sp = np.asarray(pad_signal(x, 8, "symmetric"))
    # reference convention: mirror index 2N-i-2 (ContinuousWaveletTransform
    # .java:288-295) → for i=6: idx 4; i=7: idx 3
    np.testing.assert_allclose(sp[6:], [x[4], x[3]])


def test_scale_generators_match_reference_semantics():
    s = generate_log_scales(1.0, 100.0, 3)
    np.testing.assert_allclose(s, [1.0, 10.0, 100.0], rtol=1e-12)
    s = generate_linear_scales(1.0, 3.0, 3)
    np.testing.assert_allclose(s, [1.0, 2.0, 3.0])
    with pytest.raises(ValueError):
        generate_log_scales(0.0, 1.0, 4)
    with pytest.raises(ValueError):
        generate_log_scales(2.0, 1.0, 4)
    with pytest.raises(ValueError):
        generate_linear_scales(1.0, 2.0, 1)


def test_paul_analytic_no_negative_frequencies():
    w = PaulWavelet(4)
    vals = np.asarray(w.psi_hat(np.array([-5.0, -0.1, 0.0])))
    np.testing.assert_allclose(vals, 0)


def test_dog_formula_matches_reference_convention():
    # psi(t) = C * H_n(t/sigma) * exp(-t^2/(2 sigma^2)) with physicists'
    # Hermite H_2(x) = 4x^2 - 2 and C = sqrt((2n-1)!!/(2^n sqrt(pi)
    # sigma^(2n+1))) (DOGWavelet.java:157-177, :357-367).
    d = DOGWavelet(2, 1.5)
    t = np.linspace(-4, 4, 11)
    x = t / 1.5
    c = np.sqrt(3.0 / (4.0 * np.sqrt(np.pi) * 1.5 ** 5))
    want = c * (4 * x * x - 2) * np.exp(-0.5 * x * x)
    np.testing.assert_allclose(np.asarray(d.psi(t)).real, want, atol=1e-12)


def test_continuous_factory():
    from jwave_pro.wavelets.continuous import continuous_wavelet
    assert continuous_wavelet("morlet").name == "Morlet"
    assert continuous_wavelet("dog", 3).n == 3
    with pytest.raises(ValueError):
        continuous_wavelet("nope")


def test_morlet_omega0_convention():
    # BASELINE eval config "Morlet(6.0)": Torrence–Compo omega0 mapping.
    w = MorletWavelet.from_omega0(6.0)
    assert abs(w.center_frequency - 6.0 / (2 * np.pi)) < 1e-12
    assert w.fb == 2.0
    # peak of psi-hat at omega = omega0 (within grid resolution)
    om = np.linspace(0.1, 12, 2000)
    vals = np.abs(np.asarray(w.psi_hat(om)))
    assert abs(om[np.argmax(vals)] - 6.0) < 0.02


def test_batched_pod_style_cwt(rng):
    # eval config: 64-scale batched scalogram on an ECG-like signal
    from jwave_pro.utils.signals import ecg_like
    xb = np.stack([ecg_like(1024, seed=i) for i in range(4)])
    scales = jw.generate_log_scales(1.0, 128.0, 64)
    res = cwt(xb, scales, MorletWavelet.from_omega0(6.0), 360.0)
    assert res.coefficients.shape == (4, 64, 1024)
    assert np.isfinite(np.asarray(res.magnitude)).all()


def test_icwt_reconstructs_morlet():
    # Inverse CWT (absent in the reference): flat-kernel reconstruction for
    # band-covered signals within a few percent.
    fs = 100.0
    t = np.arange(1024) / fs
    x = np.sin(2 * np.pi * 5 * t) + 0.5 * np.sin(2 * np.pi * 15 * t)
    scales = generate_log_scales(0.005, 1.0, 96)
    res = cwt(x, scales, MorletWavelet(), fs)
    xr = np.asarray(jw.icwt(res, MorletWavelet()))
    mid = slice(100, 924)  # trim edge cones
    rel = np.linalg.norm(xr[mid] - x[mid]) / np.linalg.norm(x[mid])
    assert rel < 0.05


@pytest.mark.parametrize("wav", [
    MorletWavelet(),
    jw.MexicanHatWavelet(),
    jw.PaulWavelet(4),
    jw.DOGWavelet(n=3),
    jw.MeyerWavelet(),
], ids=["morlet", "mexhat", "paul4", "dog3", "meyer"])
def test_icwt_all_families_within_bound(wav):
    """Documented accuracy bound: ≤5% relative L2 error on band-covered
    signals for every continuous family (VERDICT r1 item 10)."""
    fs = 100.0
    t = np.arange(1024) / fs
    x = np.sin(2 * np.pi * 5 * t) + 0.5 * np.sin(2 * np.pi * 15 * t)
    scales = generate_log_scales(0.005, 2.0, 128)
    res = cwt(x, scales, wav, fs)
    xr = np.asarray(jw.icwt(res, wav))
    mid = slice(100, 924)
    rel = np.linalg.norm(xr[mid] - x[mid]) / np.linalg.norm(x[mid])
    assert rel < 0.05, f"{wav.name}: rel err {rel:.3f}"


def test_icwt_jittable():
    """icwt compiles under jit with a static scale grid (K_ψ is a cached
    host-side constant — VERDICT r1 weak #5)."""
    import jax

    fs = 50.0
    t = np.arange(512) / fs
    x = np.sin(2 * np.pi * 3 * t)
    scales = generate_log_scales(0.01, 2.0, 64)
    wav = MorletWavelet()

    @jax.jit
    def roundtrip(v):
        res = cwt(v, scales, wav, fs)
        return jw.icwt(res, wav, scales=scales)

    xr = np.asarray(roundtrip(x))
    mid = slice(64, 448)
    rel = np.linalg.norm(xr[mid] - x[mid]) / np.linalg.norm(x[mid])
    assert rel < 0.05
    # without static scales under jit: clear error, not a crash
    import jax.numpy as jnp

    @jax.jit
    def bad(v, s):
        return jw.icwt(cwt(v, s, wav, fs), wav)

    with pytest.raises((ValueError, jax.errors.TracerArrayConversionError)):
        bad(x, jnp.asarray(scales))
