"""Wavelet scattering transform (ops/scattering.py).

Validates the defining properties of the representation (Mallat 2012):
Littlewood–Paley frame bound, nonexpansiveness, translation invariance at
the averaging scale, energy contraction, second-order sensitivity to
amplitude modulation — plus jit/batch/grad mechanics.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import jwave_pro as jw


def _sig(n, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.normal(size=n))


def test_filterbank_littlewood_paley_bound():
    n, j, q = 1024, 5, 8
    psi1, xi1, psi2, xi2, phi = jw.scattering_filters(n, j, q)
    assert psi1.shape == (j * q, n) and psi2.shape == (j, n)
    for bank in (psi1, psi2):
        lp = phi**2 + (bank**2).sum(axis=0)
        assert lp.max() <= 1.0 + 1e-3
    # the bank actually covers the band: LP stays near 1 between the
    # lowest and highest first-order center frequencies
    omega = np.arange(n) / n
    band = (omega >= xi1.min()) & (omega <= xi1.max())
    lp1 = phi**2 + (psi1**2).sum(axis=0)
    assert lp1[band].min() > 0.35
    assert np.all(np.diff(xi1) < 0) and np.all(np.diff(xi2) < 0)


def test_shapes_and_metadata():
    x = _sig((3, 512))
    r = jw.scattering1d(x, j=4, q=2)
    t = 16
    assert r.s0.shape == (3, 512 // t)
    assert r.s1.shape == (3, 8, 512 // t)
    assert r.s2.shape[0] == 3 and r.s2.shape[-1] == 512 // t
    assert r.pairs.shape == (r.s2.shape[1], 2)
    # every pair is frequency-decreasing
    xi1 = r.xi1[r.pairs[:, 0].astype(int)]
    assert np.all(r.pairs[:, 1] < xi1)
    stacked = r.stack()
    assert stacked.shape == (3, 1 + 8 + r.s2.shape[1], 512 // t)


def test_subsample_override_and_validation():
    x = _sig(256)
    r = jw.scattering1d(x, j=3, q=1, subsample=1)
    assert r.s0.shape == (256,)
    with pytest.raises(ValueError):
        jw.scattering1d(x, j=3, q=1, subsample=100)  # does not divide N
    with pytest.raises(ValueError):
        jw.scattering1d(x, j=3, q=1, order=3)
    with pytest.raises(ValueError):
        jw.scattering1d(x, j=0, q=1)


def test_energy_contraction():
    x = _sig(2048, seed=1)
    r = jw.scattering1d(x, j=5, q=4, subsample=1)
    e = float(jnp.sum(r.stack() ** 2))
    assert e <= 1.01 * float(jnp.sum(x**2))


def test_nonexpansive():
    x, y = _sig(1024, seed=2), _sig(1024, seed=3)
    rx = jw.scattering1d(x, j=4, q=4, subsample=1).stack()
    ry = jw.scattering1d(y, j=4, q=4, subsample=1).stack()
    d_s = float(jnp.linalg.norm(rx - ry))
    d_x = float(jnp.linalg.norm(x - y))
    assert d_s <= 1.01 * d_x


@pytest.mark.slow
def test_translation_invariance_at_averaging_scale():
    n, j = 4096, 7  # T = 128
    t_ax = np.arange(n)
    x = jnp.asarray(np.sin(2 * np.pi * 0.05 * t_ax)
                    * np.exp(-((t_ax - n / 2) ** 2) / (2 * 400.0**2)))
    a = jw.scattering1d(x, j=j, q=4).stack()
    b = jw.scattering1d(jnp.roll(x, 3), j=j, q=4).stack()
    rel = float(jnp.linalg.norm(a - b) / jnp.linalg.norm(a))
    assert rel < 0.05, rel
    # shifting by exactly T rolls the (circular) output by one sample
    c = jw.scattering1d(jnp.roll(x, 1 << j), j=j, q=4).stack()
    np.testing.assert_allclose(np.asarray(c),
                               np.asarray(jnp.roll(a, 1, axis=-1)),
                               rtol=1e-5, atol=1e-8)


def test_first_order_discriminates_frequencies():
    n = 2048
    t_ax = np.arange(n)
    for f1, f2 in [(0.05, 0.2), (0.02, 0.3)]:
        s1a = jw.scattering1d(jnp.asarray(np.sin(2 * np.pi * f1 * t_ax)),
                              j=5, q=8).s1
        s1b = jw.scattering1d(jnp.asarray(np.sin(2 * np.pi * f2 * t_ax)),
                              j=5, q=8).s1
        ka = int(jnp.argmax(s1a.mean(axis=-1)))
        kb = int(jnp.argmax(s1b.mean(axis=-1)))
        r = jw.scattering1d(jnp.zeros(n), j=5, q=8)
        assert ka != kb
        # the winning filter's center frequency is the tone's frequency
        assert abs(r.xi1[ka] - f1) / f1 < 2 ** (1 / 8.0) - 1 + 0.05
        assert abs(r.xi1[kb] - f2) / f2 < 2 ** (1 / 8.0) - 1 + 0.05


def test_second_order_detects_amplitude_modulation():
    n = 4096
    t_ax = np.arange(n)
    carrier = np.sin(2 * np.pi * 0.25 * t_ax)
    am = (1.0 + 0.8 * np.sin(2 * np.pi * 0.01 * t_ax)) * carrier
    r_pure = jw.scattering1d(jnp.asarray(carrier), j=6, q=8)
    r_am = jw.scattering1d(jnp.asarray(am), j=6, q=8)

    def s2_rel(r):
        return float(jnp.sum(r.s2**2) / jnp.sum(r.s1**2))

    assert s2_rel(r_am) > 3.0 * s2_rel(r_pure)


def test_multiresolution_matches_full_resolution():
    # default (oversampling=1) multires cascade vs the exact full-res one
    # (huge oversampling forces every decimation stride to 1)
    x = _sig((2, 4096), seed=7)
    exact = jw.scattering1d(x, j=6, q=8, oversampling=64)
    fast = jw.scattering1d(x, j=6, q=8)
    for name, tol in (("s0", 1e-12), ("s1", 5e-4), ("s2", 5e-3)):
        a = np.asarray(getattr(fast, name))
        b = np.asarray(getattr(exact, name))
        assert np.abs(a - b).max() / np.abs(b).max() < tol, name
    # metadata identical: same paths in the same order
    np.testing.assert_array_equal(fast.pairs, exact.pairs)
    np.testing.assert_array_equal(fast.xi1, exact.xi1)


def test_jit_batch_grad():
    x = _sig((2, 512), seed=4)
    f = jax.jit(lambda v: jw.scattering1d(v, j=4, q=2).stack())
    batched = f(x)
    single = jw.scattering1d(x[0], j=4, q=2).stack()
    np.testing.assert_allclose(np.asarray(batched[0]), np.asarray(single),
                               rtol=1e-6, atol=1e-10)
    g = jax.grad(lambda v: jnp.sum(jw.scattering1d(v, j=4, q=2).stack()))(x[0])
    assert g.shape == x[0].shape and bool(jnp.all(jnp.isfinite(g)))


def test_order1_skips_second_order():
    x = _sig(512, seed=5)
    r = jw.scattering1d(x, j=4, q=2, order=1)
    assert r.s2 is None


def test_scattering_rejects_complex(rng):
    x = (rng.standard_normal(512) + 1j * rng.standard_normal(512))
    with pytest.raises(ValueError, match="real"):
        jw.scattering1d(x, j=3)


class TestScattering2D:
    H = W = 64

    def _img(self, rng):
        return rng.standard_normal((self.H, self.W))

    def test_shapes_and_paths(self, rng):
        res = jw.scattering2d(self._img(rng), j=3, l=4)
        assert res.s0.shape == (8, 8)
        assert res.s1.shape == (12, 8, 8)          # J·L
        assert res.s2.shape == (3 * 16, 8, 8)      # Σ_{j1<j2} L² = 3·L²
        assert res.pairs.shape == (48, 3)
        assert np.asarray(res.stack()).shape == (61, 8, 8)

    def test_littlewood_paley_frame(self):
        from jwave_pro.ops.scattering2d import scattering2d_filters
        psi, phi, _ = scattering2d_filters(self.H, self.W, 3, 8)
        neg = np.roll(psi[:, ::-1, ::-1], (1, 1), axis=(-2, -1))
        lp = phi ** 2 + 0.5 * (psi ** 2 + neg ** 2).sum(axis=0)
        assert lp.max() <= 1.0 + 1e-12
        assert np.abs(psi[:, 0, 0]).max() < 1e-12  # exact zero mean

    def test_t_shift_equivariance_exact(self, rng):
        x = self._img(rng)
        st = np.asarray(jw.scattering2d(x, j=3, l=4).stack())
        xs = np.roll(x, (8, 16), axis=(0, 1))
        st2 = np.asarray(jw.scattering2d(xs, j=3, l=4).stack())
        np.testing.assert_allclose(
            np.roll(st, (1, 2), axis=(-2, -1)), st2, atol=1e-10)

    def test_translation_stability(self, rng):
        # small shifts: global-mean descriptor ~exactly invariant on the
        # full-resolution cascade, invariant to within the documented
        # envelope-aliasing level on the default multires one; the local
        # S-distance is a small fraction of the raw image distance
        x = self._img(rng)
        xs = np.roll(x, (3, 5), axis=(0, 1))
        for os_, tol in ((64, 1e-5), (0, 5e-4)):
            st = np.asarray(jw.scattering2d(x, j=3, l=8,
                                            oversampling=os_).stack())
            st2 = np.asarray(jw.scattering2d(xs, j=3, l=8,
                                             oversampling=os_).stack())
            m1, m2 = st.mean(axis=(-2, -1)), st2.mean(axis=(-2, -1))
            assert np.abs(m1 - m2).max() / np.abs(m1).max() < tol, os_
            ratio = (np.linalg.norm(st - st2) * 8) / np.linalg.norm(x - xs)
            assert ratio < 0.15, os_

    def test_nonexpansive(self, rng):
        x = self._img(rng)
        y = x + 0.1 * rng.standard_normal(x.shape)
        sx = np.asarray(jw.scattering2d(x, j=3, l=8).stack())
        sy = np.asarray(jw.scattering2d(y, j=3, l=8).stack())
        # the ↓T grid scales the feature L2 norm by T per axis
        assert np.linalg.norm(sx - sy) * 8 <= np.linalg.norm(x - y)

    def test_multiresolution_matches_full_resolution(self, rng):
        # default (oversampling=0) multires cascade vs the exact full-res
        # one; same path metadata, documented ~2e-3 aliasing bound
        x = rng.standard_normal((2, 128, 128))
        exact = jw.scattering2d(x, j=4, l=8, oversampling=64)
        fast = jw.scattering2d(x, j=4, l=8)
        for name, tol in (("s0", 1e-12), ("s1", 1e-3), ("s2", 5e-3)):
            a = np.asarray(getattr(fast, name))
            b = np.asarray(getattr(exact, name))
            assert np.abs(a - b).max() / np.abs(b).max() < tol, name
        np.testing.assert_array_equal(fast.pairs, exact.pairs)
        np.testing.assert_array_equal(fast.meta1, exact.meta1)

    def test_jit_batch_f32(self, rng):
        x = rng.standard_normal((2, 3, self.H, self.W)).astype(np.float32)
        f = jax.jit(lambda v: jw.scattering2d(v, j=2, l=4).stack())
        out = np.asarray(f(x))
        assert out.shape[:2] == (2, 3) and out.dtype == np.float32
        assert np.isfinite(out).all()
        one = np.asarray(jw.scattering2d(x[1, 2], j=2, l=4).stack())
        np.testing.assert_allclose(out[1, 2], one, atol=1e-5)

    def test_order1_and_validation(self, rng):
        x = self._img(rng)
        res = jw.scattering2d(x, j=2, l=4, order=1)
        assert res.s2 is None
        with pytest.raises(ValueError, match="real"):
            jw.scattering2d(x.astype(complex), j=2)
        with pytest.raises(ValueError, match="divide"):
            jw.scattering2d(rng.standard_normal((60, 64)), j=3)
        with pytest.raises(ValueError):
            jw.scattering2d(x, j=0)
