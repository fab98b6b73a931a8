"""Golden-vector regression tests (tests/golden/golden.npz pins the fast
paths against the float64 oracle outputs; see tools/generate_golden.py)."""
from pathlib import Path

import numpy as np
import pytest

import jwave_pro as jw

GOLDEN = Path(__file__).parent / "golden" / "golden.npz"


@pytest.fixture(scope="module")
def golden():
    if not GOLDEN.exists():
        pytest.skip("golden.npz not generated")
    return np.load(GOLDEN)


def _wname(key):
    return key.replace("_", " ").replace("-", "/")


def test_fwt_golden(golden):
    x = golden["input_64"]
    for key in [k for k in golden.files if k.startswith("fwt_")]:
        w = jw.wavelet(_wname(key[4:]))
        got = np.asarray(jw.fwt(x, w))
        np.testing.assert_allclose(got, golden[key], atol=1e-10, err_msg=key)


def test_wpt_golden(golden):
    x = golden["input_64"]
    for key in [k for k in golden.files if k.startswith("wpt_")]:
        w = jw.wavelet(_wname(key[4:]))
        got = np.asarray(jw.wpt(x, w, 3))
        np.testing.assert_allclose(got, golden[key], atol=1e-10, err_msg=key)


def test_modwt_golden(golden):
    x = golden["input_100"]
    for key in [k for k in golden.files if k.startswith("modwt_")]:
        w = jw.wavelet(_wname(key[6:-3]))
        got = np.asarray(jw.modwt(x, w, 4, method="direct"))
        np.testing.assert_allclose(got, golden[key], atol=1e-10, err_msg=key)


def test_modwpt_golden(golden):
    x = golden["input_100"]
    for key in [k for k in golden.files if k.startswith("modwpt_")]:
        w = jw.wavelet(_wname(key[7:-3]))
        got = np.asarray(jw.modwpt(x, w, 2, method="direct"))
        np.testing.assert_allclose(got, golden[key], atol=1e-10, err_msg=key)


def test_golden_covers_all_pr_wavelets(golden):
    """Breadth pin: every good_wavelets() member has FWT+WPT+MODWT+MODWPT
    vectors."""
    names = {w.name for w in jw.good_wavelets()}
    for name in names:
        key = name.replace(" ", "_").replace("/", "-")
        for prefix, suffix in (("fwt_", ""), ("wpt_", ""),
                               ("modwt_", "_L4"), ("modwpt_", "_L2")):
            assert f"{prefix}{key}{suffix}" in golden.files, (prefix, name)


_CWT_WAVELETS = {
    "morlet": lambda: jw.MorletWavelet(),
    "mexican_hat": lambda: jw.MexicanHatWavelet(),
    "paul": lambda: jw.PaulWavelet(4),
    "dog3": lambda: jw.DOGWavelet(n=3),
    "meyer": lambda: jw.MeyerWavelet(),
}


def test_cwt_golden(golden):
    """FFT-path CWT pinned for all five continuous families (the golden
    vectors come from the numpy oracle in tests/oracles.py, an independent
    restatement of ContinuousWaveletTransform.java:183-229)."""
    x = golden["input_64"].astype(np.float64)
    scales = golden["cwt_scales"]
    for cname, make in _CWT_WAVELETS.items():
        key = f"cwt_{cname}"
        if key not in golden.files:
            continue
        got = np.asarray(jw.cwt(x, scales, make(), 1.0).coefficients)
        np.testing.assert_allclose(got, golden[key], atol=1e-10,
                                   err_msg=cname)


def test_modwt2_golden(golden):
    img = golden["input_img_16x20"]
    want = golden["modwt2_Daubechies_4_L2"]
    got = np.asarray(jw.modwt2(img, jw.wavelet("Daubechies 4"), 2))
    np.testing.assert_allclose(got, want, atol=1e-10)


def test_modwt3_golden(golden):
    vol = golden["input_vol_8x10x12"]
    want = golden["modwt3_Daubechies_4_L1"]
    got = np.asarray(jw.modwt3(vol, jw.wavelet("Daubechies 4"), 1))
    np.testing.assert_allclose(got, want, atol=1e-10)


@pytest.fixture(scope="module")
def regression():
    import pathlib
    p = pathlib.Path(__file__).parent / "golden" / "regression.npz"
    return np.load(p)


def test_ssq_regression_pin(regression):
    x = regression["input_512"]
    scales = regression["ssq_scales"]
    res = jw.ssq_cwt(x, scales, sampling_rate=256.0, gamma=1e-6)
    np.testing.assert_allclose(np.asarray(res.Tx), regression["ssq_Tx"],
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(res.ssq_freqs),
                               regression["ssq_freqs"], rtol=1e-12)
    rid = jw.extract_ridges(res.Tx, res.ssq_freqs, n_ridges=2, mask_width=2)
    np.testing.assert_array_equal(np.asarray(rid.indices),
                                  regression["ridge_indices"])


def test_scattering_regression_pin(regression):
    x = regression["input_512"].astype(np.float64)
    sc = jw.scattering1d(x, j=4, q=2)
    np.testing.assert_allclose(np.asarray(sc.s0), regression["scat_s0"],
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(sc.s1), regression["scat_s1"],
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(sc.s2), regression["scat_s2"],
                               atol=1e-10)


def test_variance_ci_regression_pin(regression):
    x = regression["input_512"]
    ci = jw.modwt_variance_ci(x, jw.wavelet("Daubechies 4"), 4,
                              estimator="unbiased", boundary="reflect")
    np.testing.assert_allclose(np.asarray(ci.variance),
                               regression["varci_var"], rtol=1e-12)
    np.testing.assert_allclose(np.asarray(ci.lower), regression["varci_lo"],
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(ci.upper), regression["varci_hi"],
                               rtol=1e-12)
    np.testing.assert_allclose(ci.edf, regression["varci_edf"], rtol=1e-12)
