"""Fused multi-level matmul constants vs the single-step recursion.

The r3.2 fused tier (`fwt._analysis_matrix_fused` & friends) folds several
pyramid/tree levels into one banded constant via host-f64 composite taps.
These tests pin the structural identity — fused chunking must equal the
per-level recursion to f64 roundoff — for the pyramid (FWT), the full tree
(WPT), mixed filter SEQUENCES (the dual tree's level1+qshift chain), and
the Haar-orthogonal energy-correction bookkeeping (correctionʲ per segment
on the synthesis side).
"""
import numpy as np
import pytest

import jax.numpy as jnp

import jwave_pro as jw
from jwave_pro.ops.fwt import (
    _analysis_fused_matmul, _fused_levels_limit, _fused_synth_limit,
    _seq_fits_analysis, _synthesis_fused_matmul, analysis_step,
    synthesis_step,
)
from jwave_pro.ops.wpt import _level_widths


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _stepwise_fwt(x, w, level):
    h = x.shape[-1]
    cur = jnp.asarray(x)
    details = []
    for _ in range(level):
        out = analysis_step(cur, w)
        cur = out[..., :h // 2]
        details.append(out[..., h // 2:])
        h //= 2
    return jnp.concatenate([cur, *reversed(details)], -1)


def _stepwise_wpt(x, w, level):
    n = x.shape[-1]
    lead = x.shape[:-1]
    x = jnp.asarray(x)
    for h in _level_widths(n, level, w.transform_wavelength):
        x = analysis_step(x.reshape(lead + (n // h, h)), w).reshape(
            lead + (n,))
    return x


@pytest.mark.parametrize("name", ["Daubechies 4", "Symlet 8", "Haar",
                                  "Haar orthogonal", "BiOrthogonal 3/5",
                                  "Coiflet 2"])
def test_fwt_fused_equals_stepwise(rng, name):
    w = jw.wavelet(name)
    x = rng.standard_normal((2, 2048))
    got = np.asarray(jw.fwt(x, w, 6))
    want = np.asarray(_stepwise_fwt(x, w, 6))
    np.testing.assert_allclose(got, want, atol=1e-12)
    xr = np.asarray(jw.ifwt(jnp.asarray(got), w, 6))
    np.testing.assert_allclose(xr, x, atol=1e-8)


@pytest.mark.parametrize("name", ["Daubechies 4", "Symlet 8",
                                  "Haar orthogonal", "BiOrthogonal 3/5"])
def test_wpt_fused_equals_stepwise(rng, name):
    w = jw.wavelet(name)
    x = rng.standard_normal((2, 2048))
    got = np.asarray(jw.wpt(x, w, 6))
    want = np.asarray(_stepwise_wpt(x, w, 6))
    np.testing.assert_allclose(got, want, atol=1e-12)
    xr = np.asarray(jw.iwpt(jnp.asarray(got), w, 6))
    np.testing.assert_allclose(xr, x, atol=1e-8)


def test_fused_limits():
    # the (512, 256) block pair bounds the composite span
    assert _fused_levels_limit(jw.wavelet("Daubechies 4")) == 5
    assert _fused_levels_limit(jw.wavelet("Symlet 8")) == 4
    assert _fused_levels_limit(jw.wavelet("Haar")) == 8
    assert _fused_synth_limit(jw.wavelet("Daubechies 4")) == 5
    # mixed sequence: span adds per level
    w1, db = jw.wavelet("Symlet 8"), jw.wavelet("Daubechies 4")
    assert _seq_fits_analysis((w1, db, db, db, db))
    assert not _seq_fits_analysis((w1,) * 6)


def test_mixed_sequence_matches_per_level_recursion(rng):
    # the dual-tree shape: level 1 one wavelet, deeper levels another
    w1 = jw.wavelet("Symlet 8")
    db = jw.wavelet("Daubechies 4")
    seq = (w1, db, db)
    x = jnp.asarray(rng.standard_normal((3, 1024)))
    lo, details = _analysis_fused_matmul(x, seq)
    cur = x
    for j, w in enumerate(seq, 1):
        h = cur.shape[-1]
        out = analysis_step(cur, w)
        cur = out[..., :h // 2]
        np.testing.assert_allclose(np.asarray(details[j - 1]),
                                   np.asarray(out[..., h // 2:]), atol=1e-12)
    np.testing.assert_allclose(np.asarray(lo), np.asarray(cur), atol=1e-12)
    # fused synthesis inverts the fused analysis exactly
    back = _synthesis_fused_matmul(lo, details[::-1], seq)
    np.testing.assert_allclose(np.asarray(back), np.asarray(x), atol=1e-10)


def test_dtcwt_fused_roundtrip_and_sharded_parity_basis(rng):
    # dtcwt now runs through the fused sequence path; PR must stay exact
    x = jnp.asarray(rng.standard_normal((2, 1024)))
    res = jw.dtcwt(x, 4)
    xr = np.asarray(jw.idtcwt(res))
    np.testing.assert_allclose(xr, np.asarray(x), atol=1e-9)


def test_long_filter_fused_equals_stepwise(rng):
    # Discrete Meyer (102 taps, fused limit 2): the chunked path must equal
    # the recursion exactly.  (Its PUBLISHED taps are only ~1e-2 PR-accurate
    # — the reference excludes it from the PR set for the same reason,
    # WaveletBuilder.java:493 — so only stepwise-parity is assertable.)
    w = jw.wavelet("Discrete Meyer")
    x = rng.standard_normal((2, 2048))
    got = np.asarray(jw.fwt(x, w, 4))
    want = np.asarray(_stepwise_fwt(x, w, 4))
    np.testing.assert_allclose(got, want, atol=1e-12)
    # and fused inverse equals the stepwise inverse
    cur = jnp.asarray(got[..., :2048 >> 4])
    y = jnp.asarray(got)
    h = 2048 >> 3
    for _ in range(4):
        cur = synthesis_step(jnp.concatenate([cur, y[..., h // 2:h]], -1), w)
        h *= 2
    np.testing.assert_allclose(np.asarray(jw.ifwt(y, w, 4)),
                               np.asarray(cur), atol=1e-12)


def test_packed_synthesis_matrix_matches_segments():
    # r4: the packed (2*BLK, BLK) synthesis constant must be exactly the
    # per-segment constants row-offset by the [a_L | d_L | ... | d_1]
    # block layout (the packing is a pure reindexing, not a new bank)
    from jwave_pro.ops.fwt import (
        _BLK, _synthesis_matrices_fused, _synthesis_matrix_fused_packed,
    )
    for names in (("Daubechies 4",) * 5, ("Symlet 8",) * 4,
                  ("Haar orthogonal",) * 3,
                  ("Symlet 8", "Daubechies 4", "Haar")):
        ws = tuple(jw.wavelet(n) for n in names)
        prev, cur = _synthesis_matrix_fused_packed(ws, "float64")
        mats = _synthesis_matrices_fused(ws, "float64")
        off = 0
        for mat in mats:
            cnt = mat.shape[0] // 2
            np.testing.assert_array_equal(prev[off:off + cnt], mat[:cnt])
            np.testing.assert_array_equal(cur[off:off + cnt], mat[cnt:])
            off += cnt
        assert off == _BLK
