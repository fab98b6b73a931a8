"""Consume EVERY file in the reference's committed testdata (VERDICT r2 #5).

The fft_dc/fft_impulse/haar_simple/filter_* files are pinned in
test_fft_facade.py; this module consumes the remaining four:
``haar_constant_input.txt``, ``haar_linear_input.txt``,
``fft_sine_simple_input.txt`` (inputs from the reference's
``scripts/generate_basic_reference.py:40-71``) and ``cwt_test_params.txt``
(``generate_basic_reference.py:124-132``), with loader parity to
``TestDataLoader.java:46-242`` (comment lines, one value per line;
key=value for the params file).
"""
import math
import os

import numpy as np
import pytest

import jwave_pro as jw
from jwave_pro.ops import cwt as jcwt
from jwave_pro.ops import fft as jfft
from . import oracles

TESTDATA = "/root/reference/src/test/resources/testdata"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(TESTDATA), reason="reference testdata not available")


def _load_vec(name):
    vals = []
    with open(f"{TESTDATA}/{name}") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals.extend(float(t) for t in line.split())
    return np.asarray(vals)


def _load_props(name):
    # TestDataLoader's properties parity: '#' comments, key=value lines.
    props = {}
    with open(f"{TESTDATA}/{name}") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            k, v = line.split("=", 1)
            props[k.strip()] = v.strip()
    return props


def test_haar_constant_input():
    x = _load_vec("haar_constant_input.txt")
    assert x.shape == (8,) and np.all(x == 5.0)
    w = jw.wavelet("Haar")
    y = np.asarray(jw.fwt(x, w))
    # A constant signal is pure scaling content: every detail coefficient is
    # exactly 0 and the DC atom carries the full energy (5·√8).
    np.testing.assert_allclose(y[0], 5.0 * math.sqrt(8.0), atol=1e-12)
    np.testing.assert_allclose(y[1:], 0.0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(jw.ifwt(y, w)), x, atol=1e-12)
    # MODWT shares the DC property: all W_j rows vanish, V_J stays constant.
    c = np.asarray(jw.modwt(x, w, 3, method="direct"))
    np.testing.assert_allclose(c[:3], 0.0, atol=1e-12)
    np.testing.assert_allclose(c[3], 5.0 / math.sqrt(8.0) * math.sqrt(8.0),
                               atol=1e-12)  # V_3 = 5·(1/√2)³·2^{3/2}


def test_haar_linear_input():
    x = _load_vec("haar_linear_input.txt")
    np.testing.assert_allclose(x, np.arange(8.0))
    w = jw.wavelet("Haar")
    y = np.asarray(jw.fwt(x, w, level=1))
    s2 = math.sqrt(2.0)
    # Level-1 Haar on [0..7]: approx (x₂ᵢ+x₂ᵢ₊₁)/√2, detail (x₂ᵢ−x₂ᵢ₊₁)/√2.
    np.testing.assert_allclose(y[:4], np.array([1, 5, 9, 13]) / s2,
                               atol=1e-12)
    np.testing.assert_allclose(y[4:], np.full(4, -1.0 / s2), atol=1e-12)
    np.testing.assert_allclose(y, oracles.fwt(x, w, level=1), atol=1e-12)


def test_fft_sine_simple_input():
    x = _load_vec("fft_sine_simple_input.txt")
    assert x.shape == (8,)
    np.testing.assert_allclose(x, np.sin(2 * np.pi * np.arange(8) / 8),
                               atol=1e-15)
    got = np.asarray(jfft.fft(x))
    # One full cycle over 8 points: X[1] = −4i, X[7] = +4i, all else 0.
    want = np.zeros(8, dtype=complex)
    want[1], want[7] = -4.0j, 4.0j
    np.testing.assert_allclose(got, want, atol=1e-12)
    np.testing.assert_allclose(np.asarray(jfft.ifft(got)).real, x, atol=1e-12)


@pytest.mark.slow
def test_cwt_params_pin():
    """CWT pinned at the reference's published parameter set.

    Slow-marked (r5 suite diet): two direct-CWT jit compiles cost ~45 s
    on CPU; the banded/fft facade parity stays in the default suite.

    ``cwt_test_params.txt`` is the reference's only committed CWT golden
    artifact (the scipy matrices were never checked in), so the pin is:
    run the direct CWT at exactly those parameters and compare against a
    brute-force numpy restatement of ``computeCoefficient``
    (``ContinuousWaveletTransform.java:240-260``) with the Morlet ψ written
    out longhand (independent of the library's formula).
    """
    p = _load_props("cwt_test_params.txt")
    fs = float(p["sampling_rate"])
    n = int(p["signal_length"])
    scales = np.asarray(jcwt.generate_linear_scales(
        float(p["scale_min"]), float(p["scale_max"]), int(p["num_scales"])))
    assert fs == 1000.0 and n == 256 and scales.shape == (20,)
    np.testing.assert_allclose(scales[[0, -1]], [1.0, 50.0])

    # chirp test signal, like the reference's generator uses for CWT
    t = np.arange(n) / fs
    x = np.sin(2 * np.pi * (10.0 + 40.0 * t) * t)

    wav = jw.MorletWavelet()
    res = jcwt.cwt_direct(x, scales, wav, sampling_rate=fs)
    got = np.asarray(res.coefficients)
    assert got.shape == (20, n)

    # Brute-force oracle: c[a,b] = dt·Σᵢ x[i]·conj(ψ((i−b)dt / a))/√a over
    # the clipped effective-support window.
    dt = 1.0 / fs
    s0, s1 = wav.effective_support()
    fb = fc = 1.0

    def psi(tv):
        return ((2 * np.pi * fb) ** -0.5 * np.exp(-tv * tv / (2 * fb))
                * np.exp(2j * np.pi * fc * tv))

    want = np.zeros((len(scales), n), dtype=complex)
    for si, a in enumerate(scales):
        off_lo = max(int(s0 * a * fs), -(n - 1))
        off_hi = min(int(s1 * a * fs), n - 1)
        offs = np.arange(off_lo, off_hi + 1)
        taps = np.conj(psi(offs * dt / a)) / np.sqrt(a) * dt
        for b in range(n):
            lo = max(0, b + off_lo)
            hi = min(n - 1, b + off_hi)
            idx = np.arange(lo, hi + 1)
            want[si, b] = np.dot(x[idx], taps[idx - b - off_lo])
    np.testing.assert_allclose(got, want, atol=1e-10)

    # Physics cross-check: the transform's time axis is in seconds, so at
    # fs=1000 the 1..50 scale grid covers 0.02–1 Hz — far below the chirp.
    # The parameter set is physically meaningful in SAMPLE units (periods
    # of 1..50 samples against a 256-sample window), so run the ridge check
    # at sampling_rate=1: instantaneous frequency 0.01→0.09 cycles/sample
    # maps to scales 100→11, entering the grid near its top — the dominant
    # scale must fall with time.
    res1 = jcwt.cwt_direct(x, scales, wav, sampling_rate=1.0)
    mag = np.abs(np.asarray(res1.coefficients))
    early = np.argmax(mag[:, 140])   # IF ≈ 0.021 c/s ⇒ a ≈ 47
    late = np.argmax(mag[:, 240])    # IF ≈ 0.029 c/s ⇒ a ≈ 34
    assert scales[early] > scales[late] > 1.0


def test_all_reference_testdata_files_consumed():
    """Every committed reference testdata file is read by some test."""
    consumed = {
        # test_fft_facade.py
        "fft_dc_input.txt", "fft_dc_output_real.txt", "fft_dc_output_imag.txt",
        "fft_impulse_input.txt", "fft_impulse_output_real.txt",
        "fft_impulse_output_imag.txt", "haar_simple_input.txt",
        "haar_level1_approx_manual.txt", "haar_level1_detail_manual.txt",
        "filter_haar_dec_lo.txt", "filter_haar_dec_hi.txt",
        "filter_haar_rec_lo.txt", "filter_haar_rec_hi.txt",
        "filter_db2_dec_lo.txt", "filter_db4_dec_lo.txt",
        "filter_db4_dec_hi.txt",
        # this module
        "haar_constant_input.txt", "haar_linear_input.txt",
        "fft_sine_simple_input.txt", "cwt_test_params.txt",
    }
    present = set(os.listdir(TESTDATA))
    assert present <= consumed, f"unconsumed: {sorted(present - consumed)}"
