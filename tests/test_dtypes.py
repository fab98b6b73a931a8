"""Dtype behavior: f32 accuracy (the accelerator throughput dtype),
preservation, integer promotion."""
import numpy as np

import jwave_pro as jw

DB4 = jw.wavelet("Daubechies 4")


def test_f32_roundtrips(rng):
    x = rng.standard_normal(256).astype(np.float32)
    assert jw.fwt(x, DB4).dtype == np.float32
    np.testing.assert_allclose(np.asarray(jw.ifwt(jw.fwt(x, DB4), DB4)), x,
                               atol=1e-4)
    c = jw.modwt(x, DB4, 4, method="direct")
    assert c.dtype == np.float32
    np.testing.assert_allclose(np.asarray(jw.imodwt(c, DB4, method="direct")),
                               x, atol=1e-4)
    y = jw.wpt(x, DB4, 4)
    assert y.dtype == np.float32
    np.testing.assert_allclose(np.asarray(jw.iwpt(y, DB4, 4)), x, atol=1e-4)


def test_f64_preserved(rng):
    x = rng.standard_normal(64)  # float64 under the test config
    assert jw.fwt(x, DB4).dtype == np.float64
    assert jw.modwt(x, DB4, 3).dtype == np.float64


def test_integer_input_promotes(rng):
    x = (rng.standard_normal(64) * 10).astype(np.int32)
    c = jw.modwt(x, DB4, 3)
    assert c.dtype in (np.float32, np.float64)
    res = jw.cwt(x, np.array([1.0, 2.0]), jw.MorletWavelet())
    assert np.iscomplexobj(np.asarray(res.coefficients))


def test_cwt_f32_complex64(rng):
    x = rng.standard_normal(128).astype(np.float32)
    res = jw.cwt(x, np.array([1.0, 4.0]), jw.MorletWavelet())
    assert np.asarray(res.coefficients).dtype == np.complex64
    x64 = rng.standard_normal(128)
    res64 = jw.cwt(x64, np.array([1.0, 4.0]), jw.MorletWavelet())
    assert np.asarray(res64.coefficients).dtype == np.complex128
