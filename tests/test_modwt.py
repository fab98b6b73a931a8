"""MODWT tests: oracle parity, inverse, shift-invariance, FFT≡direct, denoise.

Mirrors the reference suites: MODWTInverseTest, MODWTFFTConvolutionTest,
PropertyBasedTest MODWT shift-invariance, MODWTLevelLimitTest (SURVEY §4.5).
"""
import numpy as np
import pytest

import jwave_pro as jw
from jwave_pro.ops import denoise
from . import oracles

DB4 = jw.wavelet("Daubechies 4")
HAAR = jw.wavelet("Haar")


@pytest.mark.parametrize("n", [37, 64, 100])
@pytest.mark.parametrize("name", ["Haar", "Daubechies 4", "Symlet 8"])
def test_modwt_matches_oracle(name, n, rng):
    w = jw.wavelet(name)
    x = rng.standard_normal(n)
    level = min(4, n.bit_length() - 1)
    got = np.asarray(jw.modwt(x, w, level, method="direct"))
    want = oracles.modwt(x, w, level)
    np.testing.assert_allclose(got, want, atol=1e-10)


def test_modwt_inverse_roundtrip(rng):
    # MODWTInverseTest analog — arbitrary (non-pow2) length.
    x = rng.standard_normal(123)
    c = jw.modwt(x, DB4, 5)
    xr = np.asarray(jw.imodwt(c, DB4))
    np.testing.assert_allclose(xr, x, atol=1e-8)


def test_modwt_inverse_matches_oracle(rng):
    x = rng.standard_normal(41)
    c = oracles.modwt(x, DB4, 3)
    got = np.asarray(jw.imodwt(np.asarray(c), DB4, method="direct"))
    want = oracles.imodwt(c, DB4)
    np.testing.assert_allclose(got, want, atol=1e-10)


def test_fft_equals_direct(rng):
    # MODWTFFTConvolutionTest analog.
    x = rng.standard_normal(200)
    d = np.asarray(jw.modwt(x, DB4, 4, method="direct"))
    f = np.asarray(jw.modwt(x, DB4, 4, method="fft"))
    np.testing.assert_allclose(d, f, atol=1e-9)
    xr_d = np.asarray(jw.imodwt(d, DB4, method="direct"))
    xr_f = np.asarray(jw.imodwt(f, DB4, method="fft"))
    np.testing.assert_allclose(xr_d, xr_f, atol=1e-9)


def test_shift_invariance(rng):
    # PropertyBasedTest analog: MODWT of a circularly shifted signal equals
    # the circularly shifted MODWT.
    x = rng.standard_normal(64)
    s = 7
    c = np.asarray(jw.modwt(x, DB4, 3))
    c_shift = np.asarray(jw.modwt(np.roll(x, s), DB4, 3))
    np.testing.assert_allclose(c_shift, np.roll(c, s, axis=-1), atol=1e-9)


def test_energy_preservation(rng):
    # MODWT preserves energy: ||x||² = Σ_j ||W_j||² + ||V_J||².
    x = rng.standard_normal(128)
    c = np.asarray(jw.modwt(x, HAAR, 5))
    np.testing.assert_allclose(np.sum(c * c), np.sum(x * x), rtol=1e-10)


def test_level_limits():
    with pytest.raises(ValueError, match="theoretical limit"):
        jw.modwt(np.zeros(16), DB4, 5)
    with pytest.raises(ValueError, match="maximum supported"):
        jw.modwt(np.zeros(1 << 15), DB4, 14)
    with pytest.raises(ValueError, match="must be"):
        jw.modwt(np.zeros(16), DB4, 0)


def test_deep_level_filters_longer_than_signal(rng):
    # Level-5 upsampled Db4 filter has 113 taps > N=40: the mod-N wrap
    # accumulation (MODWTTransform.java:729-741) must still hold.
    x = rng.standard_normal(40)
    got = np.asarray(jw.modwt(x, DB4, 5, method="direct"))
    want = oracles.modwt(x, DB4, 5)
    np.testing.assert_allclose(got, want, atol=1e-10)
    fft = np.asarray(jw.modwt(x, DB4, 5, method="fft"))
    np.testing.assert_allclose(fft, want, atol=1e-9)
    np.testing.assert_allclose(np.asarray(jw.imodwt(got, DB4)), x, atol=1e-8)


def test_batched_modwt(rng):
    xb = rng.standard_normal((3, 50))
    got = np.asarray(jw.modwt(xb, HAAR, 3))
    for i in range(3):
        np.testing.assert_allclose(got[:, i, :],
                                   oracles.modwt(xb[i], HAAR, 3), atol=1e-10)


def test_mra_sums_to_signal(rng):
    x = rng.standard_normal(90)
    comps = np.asarray(jw.modwt_mra(x, DB4, 4))
    np.testing.assert_allclose(comps.sum(axis=0), x, atol=1e-8)


def test_denoise_reduces_noise(rng):
    t = np.linspace(0, 1, 256)
    clean = np.sin(2 * np.pi * 5 * t)
    noisy = clean + 0.3 * rng.standard_normal(256)
    den = np.asarray(denoise.modwt_denoise(noisy, DB4, 4))
    assert np.mean((den - clean) ** 2) < np.mean((noisy - clean) ** 2)


def test_jit_and_grad(rng):
    import jax
    x = rng.standard_normal(64)

    @jax.jit
    def roundtrip(v):
        return jw.imodwt(jw.modwt(v, DB4, 3), DB4)

    np.testing.assert_allclose(np.asarray(roundtrip(x)), x, atol=1e-8)
    g = jax.grad(lambda v: jw.modwt(v, DB4, 2).sum())(x)
    assert np.all(np.isfinite(np.asarray(g)))


def test_flat_interface_auto_detection(rng):
    # MODWT1DInterfaceTest analog: flat forward + auto shape detect reverse.
    t = jw.MODWTTransform(DB4, method="direct")
    x = rng.standard_normal(64)
    flat = np.asarray(t.forward_flat(x))
    assert flat.shape == (64 * 7,)  # log2(64)=6 levels + V_6
    xr = np.asarray(t.reverse_flat(flat))
    np.testing.assert_allclose(xr, x, atol=1e-8)


def test_modwt2_roundtrip_energy_shift(rng):
    from jwave_pro.ops.modwt2d import imodwt2, modwt2
    x = rng.standard_normal((24, 40))
    c = np.asarray(modwt2(x, DB4, 3))
    assert c.shape == (10, 24, 40)
    np.testing.assert_allclose(np.asarray(imodwt2(c, DB4)), x, atol=1e-10)
    np.testing.assert_allclose(np.sum(c * c), np.sum(x * x), rtol=1e-10)
    # 2D shift-invariance (both axes)
    cs = np.asarray(modwt2(np.roll(np.roll(x, 3, 0), 5, 1), DB4, 2))
    c2 = np.asarray(modwt2(x, DB4, 2))
    np.testing.assert_allclose(cs, np.roll(np.roll(c2, 3, 1), 5, 2),
                               atol=1e-10)


def test_modwt2_batched(rng):
    from jwave_pro.ops.modwt2d import modwt2
    xb = rng.standard_normal((2, 16, 16))
    cb = np.asarray(modwt2(xb, HAAR, 2))
    for i in range(2):
        np.testing.assert_allclose(cb[:, i], np.asarray(modwt2(xb[i], HAAR, 2)),
                                   atol=1e-12)


def test_modwt_all_orthogonal_wavelets_roundtrip(rng):
    # all-family MODWT PR sweep.  Biorthogonal families are excluded: the
    # MODWT inverse applies the *decomposition* bank as its own adjoint
    # (MODWTTransform.java:337-375 uses initializeFilterCache filters both
    # ways), which reconstructs only for orthogonal banks — verified that
    # the reference's own math fails PR for e.g. BiOrthogonal 3/5 (err 0.77
    # via the faithful oracle), so this is reference behavior, not a bug.
    x = rng.standard_normal(48)
    for w in jw.good_wavelets():
        if w.family == "biorthogonal":
            continue
        c = jw.modwt(x, w, 3, method="direct")
        xr = np.asarray(jw.imodwt(c, w, method="direct"))
        np.testing.assert_allclose(xr, x, atol=1e-6, err_msg=w.name)


def test_modwt_biorthogonal_not_pr(rng):
    # Documents the reference quirk above: biorthogonal banks do NOT
    # round-trip through MODWT (in the reference or here).
    x = rng.standard_normal(48)
    w = jw.wavelet("BiOrthogonal 3/5")
    xr = np.asarray(jw.imodwt(jw.modwt(x, w, 3, method="direct"), w,
                              method="direct"))
    assert np.abs(xr - x).max() > 0.1


def test_method_selection_rules():
    from jwave_pro.ops.modwt import _use_fft
    # reference rule: N·M_upsampled > 4096 → FFT (MODWTTransform.java:640)
    assert _use_fft("auto_reference", n=1024, m_base=8, dilation=16)
    assert not _use_fft("auto_reference", n=64, m_base=4, dilation=1)
    # our cost-based rule ignores dilation (a-trous skips the zeros)
    assert not _use_fft("auto", n=1 << 20, m_base=8, dilation=4096)
    assert _use_fft("auto", n=1 << 20, m_base=102, dilation=1)  # dmey
    with np.testing.assert_raises(ValueError):
        _use_fft("bogus", 8, 8, 1)


def test_modwt2_matches_separable_oracle(rng):
    # independent check: 2D MODWT == 1D oracle convolutions applied
    # separably per level.  Band letters read (row, col): LH = g along
    # rows (axis -2), h along cols (axis -1).
    from jwave_pro.ops.modwt2d import modwt2
    x = rng.standard_normal((12, 17))
    g, h = oracles.modwt_filters(DB4)
    got = np.asarray(modwt2(x, DB4, 2))

    def conv_last(a, f):
        return np.stack([oracles.circular_convolve(r, f) for r in a])

    def conv_rows(a, f):
        return conv_last(a.T, f).T

    ll = x
    want = []
    for j in (1, 2):
        gj, hj = oracles.upsample(g, j), oracles.upsample(h, j)
        cl, ch = conv_last(ll, gj), conv_last(ll, hj)
        want.extend([conv_rows(ch, gj),    # LH
                     conv_rows(cl, hj),    # HL
                     conv_rows(ch, hj)])   # HH
        ll = conv_rows(cl, gj)
    want.append(ll)
    np.testing.assert_allclose(got, np.stack(want), atol=1e-10)


def test_wavelet_variance_partitions_total(rng):
    from jwave_pro.ops.analysis import modwt_variance
    x = rng.standard_normal(512)
    lvl = 6
    nu2 = np.asarray(modwt_variance(x, DB4, lvl))
    c = np.asarray(jw.modwt(x, DB4, lvl, method="direct"))
    total = nu2.sum() + np.mean(c[lvl] ** 2)
    np.testing.assert_allclose(total, np.mean(x ** 2), rtol=1e-10)
    # white noise: variance roughly halves per scale (detail bands)
    assert nu2[0] > nu2[3]


def test_wavelet_covariance_of_identical_signals(rng):
    from jwave_pro.ops.analysis import modwt_covariance, modwt_variance
    x = rng.standard_normal(256)
    cov = np.asarray(modwt_covariance(x, x, DB4, 3))
    var = np.asarray(modwt_variance(x, DB4, 3))
    np.testing.assert_allclose(cov, var, rtol=1e-12)

def test_modwt3_roundtrip_energy_shift(rng):
    from jwave_pro.ops.modwt2d import imodwt3, modwt3
    x = rng.standard_normal((8, 12, 20))
    c = np.asarray(modwt3(x, DB4, 2))
    assert c.shape == (15, 8, 12, 20)
    np.testing.assert_allclose(np.asarray(imodwt3(c, DB4)), x, atol=1e-10)
    np.testing.assert_allclose(np.sum(c * c), np.sum(x * x), rtol=1e-10)
    # 3D shift-invariance (all axes)
    xs = np.roll(np.roll(np.roll(x, 2, 0), 3, 1), 5, 2)
    cs = np.asarray(modwt3(xs, DB4, 1))
    c1 = np.asarray(modwt3(x, DB4, 1))
    np.testing.assert_allclose(
        cs, np.roll(np.roll(np.roll(c1, 2, 1), 3, 2), 5, 3), atol=1e-10)


def test_modwt3_batched_and_band_octants(rng):
    from jwave_pro.ops.modwt2d import modwt2, modwt3
    xb = rng.standard_normal((2, 8, 8, 8))
    cb = np.asarray(modwt3(xb, HAAR, 1))
    for i in range(2):
        np.testing.assert_allclose(
            cb[:, i], np.asarray(modwt3(xb[i], HAAR, 1)), atol=1e-12)
    # depth-constant volume: depth-high octants vanish, depth-low octants
    # equal the 2D bands of the slice (scaled by the depth DC gain Σg).
    from jwave_pro.ops.modwt import modwt_base_filters
    g, _ = modwt_base_filters(DB4)
    dc = float(np.sum(np.asarray(g)))
    img = rng.standard_normal((16, 16))
    vol = np.broadcast_to(img, (8, 16, 16))
    c3 = np.asarray(modwt3(vol, DB4, 1))
    c2 = np.asarray(modwt2(img, DB4, 1))
    assert np.abs(c3[3:7]).max() < 1e-10          # HLL, HLH, HHL, HHH
    # consistent letter convention: 3D LLH (depth-low) pairs with 2D LH etc.
    np.testing.assert_allclose(c3[0][0], dc * c2[0], atol=1e-10)  # LLH ~ LH
    np.testing.assert_allclose(c3[1][0], dc * c2[1], atol=1e-10)  # LHL ~ HL
    np.testing.assert_allclose(c3[2][0], dc * c2[2], atol=1e-10)  # LHH ~ HH
    np.testing.assert_allclose(c3[7][0], dc * c2[3], atol=1e-10)  # LLL ~ LL


def test_modwt3_mra_sums_to_volume(rng):
    from jwave_pro.ops.modwt2d import modwt3_mra
    x = rng.standard_normal((8, 8, 8))
    comps = np.asarray(modwt3_mra(x, HAAR, 2))
    assert comps.shape == (15, 8, 8, 8)
    np.testing.assert_allclose(comps.sum(axis=0), x, atol=1e-10)

def test_imodwt_nd_rejects_malformed_stacks(rng):
    from jwave_pro.ops.modwt2d import imodwt2, imodwt3, modwt2, modwt3
    c2 = modwt2(rng.standard_normal((16, 16)), HAAR, 1)   # 4 rows
    c3 = modwt3(rng.standard_normal((8, 8, 8)), HAAR, 1)  # 8 rows
    with np.testing.assert_raises(ValueError):
        imodwt3(c2, HAAR)   # 4 % 7 != 1
    with np.testing.assert_raises(ValueError):
        imodwt2(c3, HAAR)   # 8 % 3 != 1
