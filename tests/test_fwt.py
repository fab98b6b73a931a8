"""FWT tests: oracle parity, perfect reconstruction sweeps, 2D/3D, levels.

Mirrors the reference's test strategy (SURVEY §4): all-wavelet PR sweeps
(GeneralTest.java:36-83), stepping per level (SteppingTest.java:37-169),
repeated-transform rounding stability (RoundingTest.java:37-68).
"""
import numpy as np
import pytest

import jwave_pro as jw
from . import oracles


HAAR = jw.wavelet("Haar")
DB4 = jw.wavelet("Daubechies 4")


def test_haar_length8_quickstart():
    # README quick start: constant signal → all energy in the DC coefficient.
    x = np.ones(8)
    y = np.asarray(jw.fwt(x, HAAR))
    expected = np.zeros(8)
    expected[0] = np.sqrt(8.0)  # ||x||_2 of a constant-1 length-8 signal
    np.testing.assert_allclose(y, expected, atol=1e-12)
    np.testing.assert_allclose(np.asarray(jw.ifwt(y, HAAR)), x, atol=1e-12)


@pytest.mark.parametrize("n", [8, 64, 256])
@pytest.mark.parametrize("name", ["Haar", "Daubechies 4", "Symlet 8",
                                  "Coiflet 2", "BiOrthogonal 3/5",
                                  "Daubechies 20", "Haar orthogonal"])
def test_fwt_matches_oracle(name, n, rng):
    w = jw.wavelet(name)
    x = rng.standard_normal(n)
    got = np.asarray(jw.fwt(x, w))
    want = oracles.fwt(x, w)
    np.testing.assert_allclose(got, want, atol=1e-10)
    # inverse against oracle too
    got_inv = np.asarray(jw.ifwt(want, w))
    want_inv = oracles.ifwt(want, w)
    np.testing.assert_allclose(got_inv, want_inv, atol=1e-10)


def test_all_good_wavelets_perfect_reconstruction(rng):
    # GeneralTest.java:36-83 analog: every create2arr wavelet round-trips.
    # Tolerance 1e-6 matches the reference's own delta (GeneralTest.java:38,
    # "due to a lot of wavelets with different precisions").
    x = rng.standard_normal(32)
    for w in jw.good_wavelets():
        y = jw.fwt(x, w)
        xr = np.asarray(jw.ifwt(y, w))
        np.testing.assert_allclose(xr, x, atol=1e-6, err_msg=w.name)


def test_stepping_every_level(rng):
    # SteppingTest analog: forward/reverse at every level round-trips.
    x = rng.standard_normal(64)
    for level in range(0, 7):
        y = jw.fwt(x, DB4, level)
        xr = np.asarray(jw.ifwt(y, DB4, level))
        np.testing.assert_allclose(xr, x, atol=1e-8)
        np.testing.assert_allclose(np.asarray(y),
                                   oracles.fwt(x, DB4, level), atol=1e-10)


def test_rounding_repeated_1000(rng):
    # RoundingTest.java:37-68: 1000 forward+reverse keep error ≤ 1e-8.
    x = rng.standard_normal(32)
    import jax

    @jax.jit
    def roundtrip(v):
        return jw.ifwt(jw.fwt(v, HAAR), HAAR)

    v = x
    for _ in range(1000):
        v = roundtrip(v)
    np.testing.assert_allclose(np.asarray(v), x, atol=1e-8)


def test_fwt2_matches_row_col_oracle(rng):
    m = rng.standard_normal((8, 16))
    got = np.asarray(jw.fwt2(m, DB4))
    # rows first (length-16 axis), then columns (length-8 axis)
    step1 = np.stack([oracles.fwt(r, DB4) for r in m])
    want = np.stack([oracles.fwt(c, DB4) for c in step1.T]).T
    np.testing.assert_allclose(got, want, atol=1e-10)
    back = np.asarray(jw.ifwt2(got, DB4))
    np.testing.assert_allclose(back, m, atol=1e-8)


def test_fwt3_roundtrip(rng):
    s = rng.standard_normal((8, 4, 16))
    y = jw.fwt3(s, HAAR)
    np.testing.assert_allclose(np.asarray(jw.ifwt3(y, HAAR)), s, atol=1e-8)


def test_decompose_recompose(rng):
    x = rng.standard_normal(32)
    mat = np.asarray(jw.decompose(x, DB4))
    assert mat.shape == (6, 32)
    np.testing.assert_allclose(mat[0], x, atol=0)
    for level in range(6):
        np.testing.assert_allclose(
            np.asarray(jw.recompose(jw.decompose(x, DB4), DB4, level)),
            x, atol=1e-8)


def test_non_power_of_two_raises():
    with pytest.raises(ValueError, match="not a power of 2"):
        jw.fwt(np.zeros(12), HAAR)


def test_level_out_of_range():
    with pytest.raises(ValueError, match="out of range"):
        jw.fwt(np.zeros(16), HAAR, level=5)


def test_batched_fwt_matches_loop(rng):
    xb = rng.standard_normal((5, 32))
    got = np.asarray(jw.fwt(xb, DB4))
    for i in range(5):
        np.testing.assert_allclose(got[i], oracles.fwt(xb[i], DB4), atol=1e-10)


def test_haar_orthogonal_energy_correction(rng):
    w = jw.wavelet("Haar orthogonal")
    x = rng.standard_normal(16)
    y = jw.fwt(x, w)
    np.testing.assert_allclose(np.asarray(jw.ifwt(y, w)), x, atol=1e-8)


def test_grad_through_fwt(rng):
    import jax
    x = rng.standard_normal(16)
    g = jax.grad(lambda v: jw.fwt(v, DB4).sum())(x)
    assert np.all(np.isfinite(np.asarray(g)))


def test_pywt_style_wavedec_waverec(rng):
    x = rng.standard_normal(64)
    coeffs = jw.wavedec(x, DB4, 3)
    assert len(coeffs) == 4
    assert coeffs[0].shape == (8,)   # cA_3
    assert coeffs[1].shape == (8,)   # cD_3
    assert coeffs[2].shape == (16,)  # cD_2
    assert coeffs[3].shape == (32,)  # cD_1
    np.testing.assert_allclose(np.asarray(jw.waverec(coeffs, DB4)), x,
                               atol=1e-8)
    # layout equivalence with the flat FWT array
    flat = np.asarray(jw.fwt(x, DB4, 3))
    np.testing.assert_allclose(np.asarray(jw.coeffs_to_flat(coeffs)), flat)

def test_pywt_style_dwt_idwt(rng):
    x = rng.standard_normal((3, 32))
    ca, cd = jw.dwt(x, DB4)
    assert ca.shape == cd.shape == (3, 16)
    np.testing.assert_allclose(np.asarray(jw.idwt(ca, cd, DB4)), x, atol=1e-8)
    # one dwt level == the deepest slice of a level-1 wavedec
    c1 = jw.wavedec(x[0], DB4, 1)
    np.testing.assert_allclose(np.asarray(ca[0]), np.asarray(c1[0]),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(cd[0]), np.asarray(c1[1]),
                               atol=1e-12)

def test_dwt_idwt_validation(rng):
    with np.testing.assert_raises(ValueError):
        jw.dwt(rng.standard_normal(33), DB4)       # odd length
    with np.testing.assert_raises(ValueError):
        jw.idwt(rng.standard_normal(6), rng.standard_normal(4), DB4)

def test_dwt2_idwt2_roundtrip_and_band_semantics(rng):
    img = rng.standard_normal((2, 32, 48))
    ca, (ch, cv, cd) = jw.dwt2(img, DB4)
    assert ca.shape == (2, 16, 24)
    np.testing.assert_allclose(np.asarray(jw.idwt2(ca, (ch, cv, cd), DB4)),
                               img, atol=1e-8)
    # energy preservation (orthonormal bank)
    tot = sum(float(np.sum(np.asarray(a) ** 2)) for a in (ca, ch, cv, cd))
    np.testing.assert_allclose(tot, float(np.sum(img ** 2)), rtol=1e-10)
    # semantics: a horizontal-stripe image concentrates in cH
    stripes = np.broadcast_to(
        ((-1.0) ** np.arange(32))[:, None], (32, 48)).copy()
    _, (sh, sv, sd) = jw.dwt2(stripes, jw.wavelet("Haar"))
    eh, ev, ed = (float(np.sum(np.asarray(a) ** 2)) for a in (sh, sv, sd))
    assert eh > 100 * max(ev, ed)


def test_wavedec2_waverec2_mallat(rng):
    img = rng.standard_normal((64, 32))
    coeffs = jw.wavedec2(img, DB4, 3)
    assert len(coeffs) == 4
    assert coeffs[0].shape == (8, 4)            # cA_3
    assert coeffs[1][0].shape == (8, 4)         # level-3 details
    assert coeffs[3][0].shape == (32, 16)       # level-1 details
    np.testing.assert_allclose(np.asarray(jw.waverec2(coeffs, DB4)), img,
                               atol=1e-8)
    # default level picks the full even-halving depth
    c2 = jw.wavedec2(img, jw.wavelet("Haar"))
    assert len(c2) == 6  # 5 levels: 64x32 -> 2x1? floor=2: 32/2^5=1 stop at 5
    with np.testing.assert_raises(ValueError):
        jw.dwt2(rng.standard_normal((15, 16)), DB4)


def test_dwt3_idwt3_roundtrip_energy_and_consistency(rng):
    vol = rng.standard_normal((2, 16, 32, 8))
    ca, det = jw.dwt3(vol, DB4)
    assert ca.shape == (2, 8, 16, 4)
    assert set(det) == {"aad", "ada", "add", "daa", "dad", "dda", "ddd"}
    np.testing.assert_allclose(np.asarray(jw.idwt3(ca, det, DB4)), vol,
                               atol=1e-8)
    # energy preservation (orthonormal bank)
    tot = float(np.sum(np.asarray(ca) ** 2)) + sum(
        float(np.sum(np.asarray(a) ** 2)) for a in det.values())
    np.testing.assert_allclose(tot, float(np.sum(vol ** 2)), rtol=1e-10)
    # consistency: octants are slices of the level-(1,1,1) flat fwt3 cube
    flat = np.asarray(jw.fwt3(vol, DB4, (1, 1, 1)))
    np.testing.assert_allclose(np.asarray(ca), flat[:, :8, :16, :4],
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(det["ddd"]), flat[:, 8:, 16:, 4:],
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(det["daa"]), flat[:, 8:, :16, :4],
                               atol=1e-10)
    # semantics: a depth-alternating volume concentrates in the daa octant
    stripes = np.broadcast_to(((-1.0) ** np.arange(16))[:, None, None],
                              (16, 16, 16)).copy()
    _, sdet = jw.dwt3(stripes, jw.wavelet("Haar"))
    e = {k: float(np.sum(np.asarray(v) ** 2)) for k, v in sdet.items()}
    assert e["daa"] > 100 * max(v for k, v in e.items() if k != "daa")


def test_wavedec3_waverec3_mallat(rng):
    vol = rng.standard_normal((32, 16, 64))
    coeffs = jw.wavedec3(vol, DB4, 2)
    assert len(coeffs) == 3
    assert coeffs[0].shape == (8, 4, 16)              # cAAA_2
    assert coeffs[1]["ddd"].shape == (8, 4, 16)       # level-2 details
    assert coeffs[2]["aad"].shape == (16, 8, 32)      # level-1 details
    np.testing.assert_allclose(np.asarray(jw.waverec3(coeffs, DB4)), vol,
                               atol=1e-8)
    # default level halves until the smallest side hits the filter floor
    c2 = jw.wavedec3(vol, jw.wavelet("Haar"))
    assert len(c2) == 5  # 4 levels: 16 -> 8 -> 4 -> 2 -> 1 (check pre-halve)
    with np.testing.assert_raises(ValueError):
        jw.dwt3(rng.standard_normal((15, 16, 16)), DB4)
    with np.testing.assert_raises(ValueError):
        jw.idwt3(np.zeros((4, 4, 4)), {"ddd": np.zeros((4, 4, 4))}, DB4)
