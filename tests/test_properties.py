"""Property-based tests (``PropertyBasedTest.java:53-400`` analogs) +
concurrency analogs (``MODWTThreadSafetyTest``, ``ParallelWPTTest``)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import jwave_pro as jw
from jwave_pro.ops import fft as jfft

HAAR = jw.wavelet("Haar")
DB4 = jw.wavelet("Daubechies 4")


# ---------------------------------------------------------------- FFT props
def test_fft_linearity(rng):
    x, y = rng.standard_normal((2, 64))
    a, b = 2.5, -1.3
    lhs = np.asarray(jfft.fft(a * x + b * y))
    rhs = a * np.asarray(jfft.fft(x)) + b * np.asarray(jfft.fft(y))
    np.testing.assert_allclose(lhs, rhs, atol=1e-10)


def test_fft_conjugate_symmetry_real_input(rng):
    x = rng.standard_normal(64)
    X = np.asarray(jfft.fft(x))
    np.testing.assert_allclose(X[1:], np.conj(X[1:][::-1]), atol=1e-10)


def test_fft_time_shift_theorem(rng):
    x = rng.standard_normal(64)
    s = 5
    Xs = np.asarray(jfft.fft(np.roll(x, s)))
    k = np.arange(64)
    np.testing.assert_allclose(
        Xs, np.asarray(jfft.fft(x)) * np.exp(-2j * np.pi * k * s / 64),
        atol=1e-9)


# ------------------------------------------------------------- wavelet props
def test_fwt_energy_conservation_orthonormal(rng):
    x = rng.standard_normal(128)
    for name in ("Haar", "Daubechies 4", "Symlet 8", "Coiflet 3"):
        y = np.asarray(jw.fwt(x, jw.wavelet(name)))
        np.testing.assert_allclose(np.sum(y * y), np.sum(x * x), rtol=1e-8,
                                   err_msg=name)


def test_fwt_linearity(rng):
    x, y = rng.standard_normal((2, 64))
    lhs = np.asarray(jw.fwt(2.0 * x - 3.0 * y, DB4))
    rhs = 2.0 * np.asarray(jw.fwt(x, DB4)) - 3.0 * np.asarray(jw.fwt(y, DB4))
    np.testing.assert_allclose(lhs, rhs, atol=1e-10)


def test_constant_signal_dc_property():
    # All energy of a constant signal lands in the approximation coefficient.
    x = np.full(64, 3.7)
    y = np.asarray(jw.fwt(x, HAAR))
    np.testing.assert_allclose(y[0], 3.7 * 8.0, rtol=1e-12)
    np.testing.assert_allclose(y[1:], 0.0, atol=1e-12)


def test_wpt_sum_preservation(rng):
    # WPT level-1 lo coefficients preserve the signal sum (scaled by √2 for
    # Haar): Σ lo = Σ x / √2 · √2 ... concretely Σ y_lo·√2 = Σ x.
    x = rng.standard_normal(64)
    y = np.asarray(jw.wpt(x, HAAR, 1))
    np.testing.assert_allclose(np.sum(y[:32]) * np.sqrt(2.0), np.sum(x),
                               rtol=1e-10)


def test_modwt_energy_and_shift(rng):
    x = rng.standard_normal(100)
    c = np.asarray(jw.modwt(x, HAAR, 4))
    np.testing.assert_allclose(np.sum(c * c), np.sum(x * x), rtol=1e-10)
    for s in (1, 17):
        cs = np.asarray(jw.modwt(np.roll(x, s), HAAR, 4))
        np.testing.assert_allclose(cs, np.roll(c, s, axis=-1), atol=1e-10)


def test_gradients_are_adjoints(rng):
    # <fwt(x), y> == <x, ifwt-with-transposed-banks(y)>: check via jax.vjp
    x = rng.standard_normal(32)
    y = rng.standard_normal(32)
    out, vjp = jax.vjp(lambda v: jw.fwt(v, DB4), x)
    (xbar,) = vjp(jnp.asarray(y))
    lhs = float(jnp.sum(jnp.asarray(out) * 0 + jw.fwt(x, DB4) * y))
    rhs = float(jnp.sum(x * xbar))
    assert abs(lhs - rhs) < 1e-8


# ------------------------------------------------------- concurrency analogs
def test_shared_transform_vmapped_consistency(rng):
    # MODWTThreadSafetyTest analog: one transform object used by many
    # "threads" (vmap lanes) must equal per-signal application.
    xb = rng.standard_normal((8, 64))
    t = jw.MODWTTransform(DB4)
    batched = np.asarray(jax.vmap(lambda v: t.forward_1d(v, 3))(xb))
    for i in range(8):
        np.testing.assert_allclose(batched[i],
                                   np.asarray(t.forward_1d(xb[i], 3)),
                                   atol=1e-12)


def test_parallel_equals_sequential_wpt(rng):
    # ParallelWPTTest analog: batched path ≡ one-by-one path bit-for-bit.
    xb = rng.standard_normal((4, 128))
    batched = np.asarray(jw.wpt(xb, jw.wavelet("Symlet 8"), 4))
    for i in range(4):
        np.testing.assert_allclose(
            batched[i], np.asarray(jw.wpt(xb[i], jw.wavelet("Symlet 8"), 4)),
            atol=1e-12)


# ----------------------------------------------------------- perf (gated)
@pytest.mark.skipif(
    __import__("os").environ.get("JWAVE_TEST_PERFORMANCE") != "1",
    reason="set JWAVE_TEST_PERFORMANCE=1 to run "
           "(TestUtils.skipIfPerformanceTestsDisabled analog)")
def test_performance_table(rng):
    import time
    x = jnp.asarray(rng.standard_normal((8, 1 << 16)), dtype=jnp.float32)
    for name, fn in [
        ("fwt", jax.jit(lambda v: jw.fwt(v, DB4))),
        ("modwt_L5", jax.jit(lambda v: jw.modwt(v, DB4, 5)[5])),
        ("wpt_L6", jax.jit(lambda v: jw.wpt(v, jw.wavelet("Symlet 8"), 6))),
    ]:
        jax.block_until_ready(fn(x))
        t0 = time.perf_counter()
        for _ in range(5):
            out = fn(x)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / 5
        print(f"{name:10s} {x.size / dt / 1e9:8.3f} Gsamples/s")


@pytest.mark.slow
def test_roundtrip_fuzz_arbitrary_shapes(rng):
    """Seeded roundtrip sweep over (wavelet, level, N) incl. arbitrary N —
    the broad safety net behind the r4 padded-dispatch tier (CPU: XLA
    paths; the kernels' own parity lives in test_pallas_kernels).
    Slow-marked (r5 suite diet): 52 s of XLA CPU compiles; the same
    roundtrips are covered at single shapes by the default suite."""
    cases = [("Haar", 3, 1024), ("Daubechies 4", 4, 6000),
             ("Symlet 8", 2, 7777), ("Coiflet 2", 3, 100003 // 16)]
    for name, level, n in cases:
        w = jw.wavelet(name)
        x = rng.standard_normal((2, n))
        c = jw.modwt(x, w, level)
        np.testing.assert_allclose(np.asarray(jw.imodwt(c, w)), x,
                                   atol=1e-8, err_msg=f"modwt {name} {n}")
        cp = jw.modwpt(x, w, level)
        np.testing.assert_allclose(np.asarray(jw.imodwpt(cp, w)), x,
                                   atol=1e-8, err_msg=f"modwpt {name} {n}")
