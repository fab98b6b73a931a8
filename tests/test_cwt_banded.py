"""Pruned-band CWT (ops/cwt_banded.py) — parity and plan behavior.

The banded path must be algebraically identical to the half-spectrum irfft
path up to the 1e-8 relative band truncation; on CPU f64 that bound is
directly observable (~1e-9).
"""
import numpy as np
import pytest

import jax.numpy as jnp

import jwave_pro as jw
from jwave_pro.ops import cwt as jcwt
from jwave_pro.ops.cwt_banded import band_plan, banded_supported

SCALES = jw.generate_log_scales(1.0, 256.0, 64)

FAMILIES = [
    (jw.MorletWavelet(), "analytic"),       # ψ̂(ω<0) ~ 3e-9·peak
    (jw.PaulWavelet(), "analytic"),         # exactly analytic
    (jw.MexicanHatWavelet(), "real"),       # real-even ψ̂ → real output
    (jw.DOGWavelet(n=2), "real"),
    (jw.DOGWavelet(n=3), "general"),        # odd order: imaginary odd ψ̂
]


@pytest.mark.parametrize("wav,mode", FAMILIES,
                         ids=[w.name + str(i) for i, (w, _) in
                              enumerate(FAMILIES)])
def test_banded_matches_half_spectrum(rng, wav, mode):
    x = jnp.asarray(rng.standard_normal((2, 4000)))
    ref = np.asarray(jcwt.cwt(x, SCALES, wav, 1.0, method="fft").coefficients)
    got = np.asarray(jcwt.cwt(x, SCALES, wav, 1.0,
                              method="banded").coefficients)
    assert got.dtype == ref.dtype        # real stays real, complex complex
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(got - ref)) / scale < 5e-8
    plan_mode = band_plan(wav, tuple(map(float, SCALES)), 4096, 1.0, 4000)[0]
    assert plan_mode == mode


def test_banded_mode_detection_covers_meyer(rng):
    # Meyer's ψ̂ is real-even up to ~1e-13 numerical asymmetry — lands in
    # 'general' mode, which must still match exactly.
    x = jnp.asarray(rng.standard_normal((2, 2048)))
    wav = jw.MeyerWavelet()
    ref = np.asarray(jcwt.cwt(x, SCALES, wav, 1.0, method="fft").coefficients)
    got = np.asarray(jcwt.cwt(x, SCALES, wav, 1.0,
                              method="banded").coefficients)
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 5e-8


def test_banded_descending_grid_restores_order(rng):
    # A descending scale grid defeats the identity-order fast path and
    # exercises the inv_perm take.
    x = jnp.asarray(rng.standard_normal(3000))
    sd = np.asarray(SCALES)[::-1].copy()
    ref = np.asarray(jcwt.cwt(x, sd, jw.MorletWavelet(), 2.5,
                              method="fft").coefficients)
    got = np.asarray(jcwt.cwt(x, sd, jw.MorletWavelet(), 2.5,
                              method="banded").coefficients)
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 5e-8


def test_banded_respects_padding_modes(rng):
    x = jnp.asarray(rng.standard_normal(1500))   # pads 1500 → 2048
    for mode in ("zero", "symmetric", "periodic", "constant"):
        ref = np.asarray(jcwt.cwt(x, SCALES[:16], None, 1.0, padding=mode,
                                  method="fft").coefficients)
        got = np.asarray(jcwt.cwt(x, SCALES[:16], None, 1.0, padding=mode,
                                  method="banded").coefficients)
        assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 5e-8, mode


def test_banded_guards():
    assert not banded_supported(100, 50)       # not 128-divisible
    assert not banded_supported(256, 256)      # T = 2 < 4
    assert banded_supported(4096, 4000)
    with pytest.raises(ValueError, match="128-divisible"):
        jcwt.cwt(jnp.ones(100), SCALES[:4], method="banded")
    with pytest.raises(ValueError, match="unknown CWT method"):
        jcwt.cwt(jnp.ones(1024), SCALES[:4], method="bogus")


@pytest.mark.parametrize("wav", [jw.MorletWavelet(), jw.PaulWavelet(),
                                 jw.DOGWavelet(n=3), jw.MexicanHatWavelet()],
                         ids=["morlet", "paul", "dog3", "mexhat"])
def test_banded_wd_matches_full_derivative(rng, wav):
    # (W, ∂_t W) from the shared derivative plan must match the full-length
    # half-spectrum path built from _ssq_multipliers (the SSQ front end).
    from jwave_pro.ops.cwt_banded import cwt_banded_wd
    from jwave_pro.ops.ssq import _ssq_multipliers
    from jwave_pro.ops.cwt import _half_irfft_chunked, pad_signal

    n, padded_n, fs = 4000, 4096, 3.0
    x = jnp.asarray(rng.standard_normal((2, n)))
    xp = pad_signal(x, padded_n, "zero")
    xh = jnp.fft.rfft(xp, axis=-1)
    scales = tuple(map(float, SCALES))
    a, b, ad, bd = _ssq_multipliers(wav, scales, padded_n, fs)
    xh1 = xh[..., None, :]

    def half(m):
        return _half_irfft_chunked(xh1, m, padded_n, n, jnp.complex128,
                                   jnp.float64, len(scales))

    w_ref = np.asarray(half(a) + 1j * half(b))
    d_ref = np.asarray(half(ad) + 1j * half(bd))
    w, d = cwt_banded_wd(xh, n, np.asarray(SCALES), wav, fs, padded_n)
    w, d = np.asarray(w), np.asarray(d)
    assert np.iscomplexobj(w) and np.iscomplexobj(d)  # real mode promoted
    assert np.max(np.abs(w - w_ref)) / np.max(np.abs(w_ref)) < 5e-8
    assert np.max(np.abs(d - d_ref)) / np.max(np.abs(d_ref)) < 5e-8


def test_banded_band_plan_prunes(rng):
    # Large scales must actually get narrow bands (the point of the path).
    _, row_groups, _, _, _, _, _ = band_plan(
        jw.MorletWavelet(), tuple(map(float, SCALES)), 4096, 1.0, 4096)
    widths = sorted({g.b2 for g in row_groups[0]})
    assert widths[0] == 1                        # 128-bin bands exist
    total_bins = sum(g.b2 * 128 * len(g.offsets) for g in row_groups[0])
    assert total_bins < 0.55 * 64 * 2049         # < 55% of the full grid


def test_precision_tier_api(rng):
    # low-precision tier: precision='high'/'highest' and bf16 inputs are
    # accepted everywhere; on CPU all tiers agree to f32 noise (reduced
    # precision matmul passes exist only on accelerators).  'default' and
    # bad strings.
    import jax
    from jax import lax
    from jwave_pro.ops.cwt import _resolve_precision

    assert _resolve_precision(None, False) == lax.Precision.HIGHEST
    assert _resolve_precision(None, True) == lax.Precision.HIGH
    assert _resolve_precision("high", False) == lax.Precision.HIGH
    assert _resolve_precision(lax.Precision.DEFAULT, False) \
        == lax.Precision.DEFAULT
    with pytest.raises(ValueError):
        _resolve_precision("bogus", False)

    wav = jw.MorletWavelet.from_omega0(6.0)
    scales = jw.generate_log_scales(1.0, 64.0, 16)
    x = jnp.asarray(rng.standard_normal((2, 1024)), jnp.float32)
    ref = np.asarray(jw.cwt(x, scales, wav, 100.0).coefficients)
    hi = np.asarray(jw.cwt(x, scales, wav, 100.0,
                           precision="high").coefficients)
    assert np.max(np.abs(hi - ref)) <= 1e-3 * np.max(np.abs(ref)) + 1e-6
    # bf16 input: implicit fast tier; only input-rounding error on CPU
    b16 = np.asarray(jw.cwt(x.astype(jnp.bfloat16), scales, wav,
                            100.0).coefficients)
    assert b16.dtype == ref.dtype          # complex64 — no complex-bf16
    assert np.max(np.abs(b16 - ref)) <= 2e-2 * np.max(np.abs(ref))
    # ssq accepts the knob and keeps its sum identity across tiers
    sc = tuple(float(s) for s in np.asarray(scales))
    r1 = jw.ssq_cwt(x, sc, wav, 100.0)
    r2 = jw.ssq_cwt(x, sc, wav, 100.0, precision="high")
    lhs = np.asarray(jnp.sum(r2.Tx, axis=-2))
    rhs = np.asarray(jnp.sum(r1.Tx, axis=-2))
    assert np.max(np.abs(lhs - rhs)) <= 1e-3 * np.max(np.abs(rhs)) + 1e-6
