"""Fused MODWT kernels (kernels/modwt_cuda.py) and the transform paths whose
earlier hand-written kernels were retired.

A CUDA kernel has no interpret mode, so on the CPU the kernel entry points
run with ``interpret=True``, which puts the XLA cascade (``method="direct"``
in f32) where the custom call would be.  These tests pin the wrapper around
the kernels: the launch plan, reshaping of batches and the 1D contract,
arbitrary-N shapes, bf16 in and out, the threshold tables, the dispatch
choice, the routing by platform and the VJP rules, against the f64
reference.  The compiled kernels' tiling, context and seams are checked
against a float64 NumPy reference on the card by ``chip_smoke.py``.
"""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import jwave_pro as jw
from jwave_pro.kernels.modwt_cuda import (
    imodwt_fused, modwt_denoise_fused, modwt_fused, modwt_var_fused, plan,
)

from . import oracles

DB4 = jw.wavelet("Daubechies 4")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ref(x, level):
    return np.asarray(jw.modwt(np.asarray(x, np.float64), DB4, level,
                               method="direct"))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("batch,n,level", [
    (8, 2048, 3),     # one tile per row
    (16, 2048, 2),
    (1, 16384, 3),    # batch=1, eight tiles
    (2, 8192, 2),
    (3, 16384, 2),    # non-pow2 batch
])
def test_forward_matches_direct(batch, n, level, rng):
    x = jnp.asarray(rng.standard_normal((batch, n)), jnp.float32)
    assert plan("forward", batch, n, level, DB4.length) is not None
    got = np.asarray(modwt_fused(x, DB4, level, interpret=True))
    np.testing.assert_allclose(got, _ref(x, level), atol=2e-5)


@pytest.mark.parametrize("batch,n,level", [
    (8, 2048, 3),
    (1, 16384, 3),
    (2, 8192, 2),
])
def test_roundtrip(batch, n, level, rng):
    x = jnp.asarray(rng.standard_normal((batch, n)), jnp.float32)
    c = modwt_fused(x, DB4, level, interpret=True)
    xr = np.asarray(imodwt_fused(c, DB4, interpret=True))
    np.testing.assert_allclose(xr, np.asarray(x), atol=2e-5)


def test_level1_inverse(rng):
    x = jnp.asarray(rng.standard_normal((8, 2048)), jnp.float32)
    c = modwt_fused(x, DB4, 1, interpret=True)
    xr = np.asarray(imodwt_fused(c, DB4, interpret=True))
    np.testing.assert_allclose(xr, np.asarray(x), atol=2e-5)


def test_bfloat16_runs_fused(rng):
    """bf16 in and out, f32 arithmetic inside the block."""
    x32 = jnp.asarray(rng.standard_normal((8, 2048)), jnp.float32)
    x16 = x32.astype(jnp.bfloat16)
    c = modwt_fused(x16, DB4, 3, interpret=True)
    assert c.dtype == jnp.bfloat16
    # bf16 has ~3 decimal digits; compare against f64 reference loosely
    np.testing.assert_allclose(np.asarray(c, np.float64),
                               _ref(x32, 3), atol=3e-2)
    xr = imodwt_fused(c, DB4, interpret=True)
    assert xr.dtype == jnp.bfloat16
    np.testing.assert_allclose(np.asarray(xr, np.float64),
                               np.asarray(x32, np.float64), atol=5e-2)


def test_plan_fold_preferences():
    """Tile choice: the default tile, grown for long contexts, shrunk to
    short signals; halo = (M−1)(2^L−1) rounded up to 32 samples."""
    p = plan("forward", 32, 1 << 20, 5, 8)
    assert (p.tile, p.halo) == (2048, 224)
    assert p.smem == 2 * (2048 + 224) * 4
    # Sym8 L7: context 1905 → 1920 samples; the tile grows past 2·halo
    p = plan("forward", 8, 1 << 20, 7, 16)
    assert p.halo == 1920 and p.tile >= 2 * p.halo
    # short signals: the tile shrinks to the next power of two ≥ N
    assert plan("forward", 4, 300, 3, 8).tile == 512
    # a context wider than the tile, too many taps, or a non-32 tile: None
    assert plan("forward", 8, 1 << 20, 10, 8) is None
    assert plan("forward", 8, 1 << 20, 2, 66) is None
    assert plan("forward", 8, 4096, 2, 8, tile=1000) is None
    # the inverse holds three windows, so it fits less than the forward
    assert plan("inverse", 8, 1 << 20, 7, 16).smem > \
        plan("forward", 8, 1 << 20, 7, 16).smem


def test_plan_arbitrary_n():
    """Arbitrary N needs no padded copy: the last tile is partial and the
    blocks wrap their own context mod N (forwardMODWT has no power-of-2
    guard, MODWTTransform.java:256-306)."""
    for rows, n in [(1, 100003), (1, 1_000_000), (32, 100003)]:
        p = plan("forward", rows, n, 5, 8)
        assert p is not None and n % p.tile != 0
        assert p.tile % 32 == 0 and p.halo < p.tile
    assert plan("forward", 1, 16_000_003, 5, 8).tile == 2048


@pytest.mark.parametrize("batch,n,level", [
    (8, 2000, 3),       # partial single tile
    (16, 100003, 2),    # batched headline length
    (1, 100003, 5),     # one long series, partial last tile
    (3, 7777, 2),       # non-pow2 batch and length
])
def test_forward_arbitrary_n_matches_direct(batch, n, level, rng):
    x = jnp.asarray(rng.standard_normal((batch, n)), jnp.float32)
    p = plan("forward", batch, n, level, DB4.length)
    assert p is not None and n % p.tile != 0
    got = np.asarray(modwt_fused(x, DB4, level, interpret=True))
    assert got.shape == (level + 1, batch, n)
    np.testing.assert_allclose(got, _ref(x, level), atol=2e-5)


@pytest.mark.parametrize("batch,n,level", [
    (8, 2000, 3),
    (1, 100003, 5),
])
def test_roundtrip_arbitrary_n(batch, n, level, rng):
    x = jnp.asarray(rng.standard_normal((batch, n)), jnp.float32)
    c = modwt_fused(x, DB4, level, interpret=True)
    xr = np.asarray(imodwt_fused(c, DB4, interpret=True))
    np.testing.assert_allclose(xr, np.asarray(x), atol=2e-5)


def test_arbitrary_n_1d_contract(rng):
    """(N,) in, (level+1, N) out: the financial single-series shape."""
    n = 100003
    x = jnp.asarray(rng.standard_normal(n), jnp.float32)
    got = np.asarray(modwt_fused(x, DB4, 5, interpret=True))
    assert got.shape == (6, n)
    np.testing.assert_allclose(got, _ref(x[None], 5)[:, 0], atol=2e-5)
    xr = np.asarray(imodwt_fused(jnp.asarray(got), DB4, interpret=True))
    np.testing.assert_allclose(xr, np.asarray(x), atol=2e-5)


def test_batch1_long_series_parity(rng):
    """One long series over several tiles of the plan: the entry point
    agrees with the reference around the tile seams (on the card each
    block loads its own context there; chip_smoke.py checks the kernel)."""
    n = 1 << 15
    x = jnp.asarray(rng.standard_normal((1, n)), jnp.float32)
    got = np.asarray(modwt_fused(x, DB4, 5, interpret=True))
    want = _ref(x, 5)
    np.testing.assert_allclose(got, want, atol=2e-5)
    tile = plan("forward", 1, n, 5, DB4.length).tile
    for seam in (tile, n - tile):
        np.testing.assert_allclose(got[..., seam - 64:seam + 64],
                                   want[..., seam - 64:seam + 64], atol=2e-5)


def test_grad_through_fused(rng):
    x = jnp.asarray(rng.standard_normal((8, 2048)), jnp.float32)
    g = jax.grad(lambda v: jnp.sum(
        modwt_fused(v, DB4, 2, 2048, True) ** 2))(x)
    # A is orthonormal-ish (PR property): grad of ||Ax||² = 2·AᵀAx = 2x
    np.testing.assert_allclose(np.asarray(g), 2 * np.asarray(x), atol=1e-4)


class TestDenoiseFused:
    """Single-pass denoise entry point vs the XLA modwt_denoise pipeline."""

    @pytest.mark.parametrize("batch,n,level", [
        (8, 4096, 3),     # two tiles per row
        (1, 32768, 4),    # one long row (seams exercise both contexts)
        (2, 16384, 3),
    ])
    def test_matches_xla_pipeline(self, batch, n, level, rng):
        x = jnp.asarray(rng.standard_normal((batch, n)), jnp.float32)
        assert plan("denoise", batch, n, level, DB4.length)
        thr = jnp.full((batch,), 0.8, jnp.float32)
        got = np.asarray(modwt_denoise_fused(x, thr, DB4, level,
                                             interpret=True))
        want = np.asarray(jw.modwt_denoise(x, DB4, level, threshold=0.8,
                                           method="direct"))
        np.testing.assert_allclose(got, want, atol=2e-5)

    def test_hard_mode(self, rng):
        x = jnp.asarray(rng.standard_normal((8, 4096)), jnp.float32)
        thr = jnp.full((8,), 0.5, jnp.float32)
        got = np.asarray(modwt_denoise_fused(x, thr, DB4, 3, mode="hard",
                                             interpret=True))
        want = np.asarray(jw.modwt_denoise(x, DB4, 3, mode="hard",
                                           threshold=0.5, method="direct"))
        np.testing.assert_allclose(got, want, atol=2e-5)

    def test_public_method_fused_default_threshold(self, rng):
        """The universal-threshold table the public path hands the kernel,
        through the entry point, equals the XLA pipeline; on the CPU the
        public method='fused' raises instead of interpreting."""
        from jwave_pro.ops.denoise import _fused_threshold

        x = jnp.asarray(rng.standard_normal((2, 8192)), jnp.float32)
        thr = _fused_threshold(x, DB4, 3, None)
        got = np.asarray(modwt_denoise_fused(x, thr, DB4, 3, interpret=True))
        want = np.asarray(jw.modwt_denoise(x, DB4, 3, method="direct"))
        np.testing.assert_allclose(got, want, atol=2e-5)
        with pytest.raises(ValueError, match="fused denoise unavailable"):
            jw.modwt_denoise(x, DB4, 3, method="fused")
        # rules that need every detail row stay on the pipeline
        assert _fused_threshold(x, DB4, 3, "sure") is None
        assert _fused_threshold(x, DB4, 3, np.ones((2, 8192))) is None

    def test_per_row_thresholds(self, rng):
        x = jnp.asarray(rng.standard_normal((8, 4096)), jnp.float32)
        thr = jnp.asarray(np.linspace(0.1, 2.0, 8), jnp.float32)
        got = np.asarray(modwt_denoise_fused(x, thr, DB4, 2, interpret=True))
        c = jw.modwt(x, DB4, 2, method="direct")
        det = jw.soft_threshold(c[:2], thr[None, :, None])
        want = np.asarray(jw.imodwt(jnp.concatenate([det, c[2:]], 0), DB4,
                                    method="direct"))
        np.testing.assert_allclose(got, want, atol=2e-5)

    @pytest.mark.parametrize("mode", ["soft", "hard"])
    def test_grad_matches_pipeline(self, mode, rng):
        """The custom VJP (in x and in the per-signal threshold) equals
        autodiff through the XLA pipeline."""
        x = jnp.asarray(rng.standard_normal((2, 4096)), jnp.float32)
        r = jnp.asarray(rng.standard_normal((2, 4096)), jnp.float32)
        thr = jnp.asarray([0.5, 0.9], jnp.float32)
        got = jax.grad(lambda v, t: jnp.sum(r * modwt_denoise_fused(
            v, t, DB4, 3, mode, interpret=True)), argnums=(0, 1))(x, thr)
        want = jax.grad(lambda v, t: jnp.sum(r * jw.modwt_denoise(
            v, DB4, 3, mode=mode, method="direct", threshold=t[:, None])),
            argnums=(0, 1))(x, thr)
        np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                                   rtol=1e-4, atol=1e-4)

    def test_unsupported_window(self):
        # Sym8 L7: the two-sided window plus seven detail rows exceed the
        # block's shared memory, though the transform kernels still fit
        assert plan("forward", 8, 1 << 16, 7, 16) is not None
        assert plan("denoise", 8, 1 << 16, 7, 16) is None


class Test1DFastPath:
    """(N,) → (L+1, N) contract."""

    def test_forward_1d_matches_2d(self, rng):
        x = jnp.asarray(rng.standard_normal(1 << 15), jnp.float32)
        got = np.asarray(modwt_fused(x, DB4, 4, interpret=True))
        assert got.shape == (5, 1 << 15)
        want = np.asarray(modwt_fused(x[None, :], DB4, 4,
                                      interpret=True))[:, 0]
        np.testing.assert_allclose(got, want, atol=0)

    def test_roundtrip_1d(self, rng):
        x = jnp.asarray(rng.standard_normal(1 << 15), jnp.float32)
        c = modwt_fused(x, DB4, 3, interpret=True)
        xr = np.asarray(imodwt_fused(c, DB4, interpret=True))
        assert xr.shape == x.shape
        np.testing.assert_allclose(xr, np.asarray(x), atol=2e-5)

    def test_public_1d_dispatch_cpu_falls_back(self, rng):
        # On CPU the public API uses the XLA path; semantics must agree
        x = jnp.asarray(rng.standard_normal(1 << 14), jnp.float32)
        c = jw.modwt(x, DB4, 3)
        assert c.shape == (4, 1 << 14)
        np.testing.assert_allclose(np.asarray(jw.imodwt(c, DB4)),
                                   np.asarray(x), atol=1e-5)


class TestVarianceFused:
    """Single-pass wavelet variance: shape, statistic and VJP of the
    entry point (on the card: per-tile partial sums, summed in XLA)."""

    @pytest.mark.parametrize("batch,n,level", [
        (8, 4096, 3),
        (1, 32768, 5),
        (2, 16384, 2),
    ])
    def test_matches_transform_then_mean(self, batch, n, level, rng):
        x = jnp.asarray(rng.standard_normal((batch, n)), jnp.float32)
        got = np.asarray(modwt_var_fused(x, DB4, level, interpret=True))
        assert got.shape == (level + 1, batch)
        c = _ref(x, level)
        want = np.mean(c ** 2, axis=-1)
        np.testing.assert_allclose(got, want, rtol=2e-5)

    def test_1d_shape(self, rng):
        x = jnp.asarray(rng.standard_normal(1 << 14), jnp.float32)
        got = np.asarray(modwt_var_fused(x, DB4, 3, interpret=True))
        assert got.shape == (4,)

    def test_public_method_fused(self, rng):
        x = jnp.asarray(rng.standard_normal((4, 8192)), jnp.float32)
        got = np.asarray(modwt_var_fused(x, DB4, 3, interpret=True))[:3]
        want = np.asarray(jw.modwt_variance(x, DB4, 3, method="direct"))
        assert got.shape == want.shape == (3, 4)
        np.testing.assert_allclose(got, want, rtol=2e-5)
        with pytest.raises(ValueError, match="fused variance unavailable"):
            jw.modwt_variance(x, DB4, 3, method="fused")
        # 'auto' takes the XLA path here
        np.testing.assert_allclose(
            np.asarray(jw.modwt_variance(x, DB4, 3)), want, rtol=1e-6)

    def test_grad_matches_direct(self, rng):
        """VJP Aᵀ((2/N)·cot·A·x) equals autodiff through the XLA path."""
        x = jnp.asarray(rng.standard_normal((2, 4096)), jnp.float32)
        wts = jnp.asarray([1.0, 2.0, 3.0, 4.0])[:, None]

        def direct(v):
            c = jw.modwt(v, DB4, 3, method="direct")
            return jnp.mean(c ** 2, axis=-1)

        got = jax.grad(lambda v: jnp.sum(
            wts * modwt_var_fused(v, DB4, 3, interpret=True)))(x)
        want = jax.grad(lambda v: jnp.sum(wts * direct(v)))(x)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-6)

    def test_variance_partition(self, rng):
        """Σ_j ν²_j + mean(V²) = mean(x²) (energy preservation)."""
        x = jnp.asarray(rng.standard_normal((8, 4096)), jnp.float32)
        v = np.asarray(modwt_var_fused(x, DB4, 4, interpret=True))
        np.testing.assert_allclose(v.sum(0), np.mean(np.asarray(x) ** 2, -1),
                                   rtol=1e-5)

    def test_covariance_polarization(self, rng):
        """cov = (var(x+y) − var(x−y))/4 — exact by MODWT linearity."""
        x = jnp.asarray(rng.standard_normal((4, 8192)), jnp.float32)
        y = jnp.asarray(0.5 * np.asarray(x)
                        + rng.standard_normal((4, 8192)), jnp.float32)
        vp = modwt_var_fused(x + y, DB4, 3, interpret=True)[:3]
        vm = modwt_var_fused(x - y, DB4, 3, interpret=True)[:3]
        got = np.asarray((vp - vm) / 4.0)
        want = np.asarray(jw.modwt_covariance(x, y, DB4, 3, method="direct"))
        np.testing.assert_allclose(got, want, atol=1e-5)


class TestBf16Tier:
    """bf16 I/O with f32 arithmetic, with error bounds vs the f32 path
    (bf16 mantissa = 8 bits ⇒ ~4e-3 relative representation error; the
    pipelines stay within ~1e-2 absolute for unit-variance signals)."""

    def test_denoise_bf16(self, rng):
        x32 = jnp.asarray(rng.standard_normal((8, 4096)), jnp.float32)
        thr = jnp.full((8,), 0.8, jnp.float32)
        got = modwt_denoise_fused(x32.astype(jnp.bfloat16), thr, DB4, 3,
                                  interpret=True)
        assert got.dtype == jnp.bfloat16
        want = np.asarray(modwt_denoise_fused(x32, thr, DB4, 3,
                                              interpret=True))
        np.testing.assert_allclose(np.asarray(got, np.float64), want,
                                   atol=6e-2)

    def test_variance_bf16(self, rng):
        x32 = jnp.asarray(rng.standard_normal((8, 4096)), jnp.float32)
        got = np.asarray(modwt_var_fused(x32.astype(jnp.bfloat16), DB4, 3,
                                         interpret=True))
        assert got.dtype == np.float32  # the statistic stays f32
        want = np.asarray(modwt_var_fused(x32, DB4, 3, interpret=True))
        np.testing.assert_allclose(got, want, rtol=3e-2, atol=1e-4)

    def test_modwt2_dispatch_accepts_bf16(self, rng):
        # the public modwt2/imodwt2 XLA path keeps bf16 end to end
        x16 = jnp.asarray(rng.standard_normal((2, 64, 256)), jnp.bfloat16)
        w = jw.wavelet("Daubechies 4")
        c = jw.modwt2(x16, w, 2)
        assert c.dtype == jnp.bfloat16
        xr = jw.imodwt2(c, w)
        assert xr.dtype == jnp.bfloat16


class TestPaddedDispatchSweep:
    def test_modwt_bf16_with_pad(self, rng):
        # bf16 I/O with a partial last tile of the plan — pin their
        # composition
        p = plan("forward", 8, 2000, 3, DB4.length)
        assert p is not None and 2000 % p.tile != 0
        x32 = jnp.asarray(rng.standard_normal((8, 2000)), jnp.float32)
        got = np.asarray(modwt_fused(x32.astype(jnp.bfloat16), DB4, 3,
                                     interpret=True).astype(jnp.float32))
        want = np.asarray(modwt_fused(x32, DB4, 3, interpret=True))
        assert np.max(np.abs(got - want)) < 5e-2


class TestPaddedSinglePass:
    """Arbitrary N for the single-pass kernels: denoise through the
    two-sided mod-N context, variance through the position mask that
    keeps a partial tile's tail out of the sums."""

    @pytest.mark.parametrize("batch,n,level", [(8, 2000, 3), (8, 6250, 4)])
    def test_denoise_padded(self, batch, n, level, rng):
        p = plan("denoise", batch, n, level, DB4.length)
        assert p is not None and n % p.tile != 0
        x = jnp.asarray(rng.standard_normal((batch, n)), jnp.float32)
        thr = jnp.full((batch,), 0.8, jnp.float32)
        got = np.asarray(modwt_denoise_fused(x, thr, DB4, level,
                                             interpret=True))
        want = np.asarray(jw.modwt_denoise(np.asarray(x, np.float64), DB4,
                                           level, threshold=0.8,
                                           method="direct"))
        np.testing.assert_allclose(got, want, atol=2e-5)

    @pytest.mark.parametrize("batch,n,level", [(8, 2000, 3), (16, 6250, 4)])
    def test_variance_padded_masks_duplicates(self, batch, n, level, rng):
        p = plan("variance", batch, n, level, DB4.length)
        assert p is not None and n % p.tile != 0
        x = jnp.asarray(rng.standard_normal((batch, n)), jnp.float32)
        got = np.asarray(modwt_var_fused(x, DB4, level, interpret=True))
        c = np.asarray(jw.modwt(np.asarray(x, np.float64), DB4, level,
                                method="direct"))
        want = np.mean(c ** 2, axis=-1)
        np.testing.assert_allclose(got, want, rtol=1e-5)


class TestPaddedDtypeCompositions:
    def test_variance_bf16_padded(self, rng):
        p = plan("variance", 8, 2000, 3, DB4.length)
        assert p is not None and 2000 % p.tile != 0
        x32 = jnp.asarray(rng.standard_normal((8, 2000)), jnp.float32)
        got = np.asarray(modwt_var_fused(x32.astype(jnp.bfloat16), DB4, 3,
                                         interpret=True))
        want = np.asarray(modwt_var_fused(x32, DB4, 3, interpret=True))
        assert np.max(np.abs(got / want - 1.0)) < 3e-2


# ---------------------------------------------------------------------------
# Kernel entry points off the card, and the card's smoke test off the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", [
    lambda x: modwt_fused(x, DB4, 3),
    lambda x: imodwt_fused(jnp.stack([x] * 4), DB4),
    lambda x: modwt_denoise_fused(x, 0.5, DB4, 3),
    lambda x: modwt_var_fused(x, DB4, 3),
], ids=["forward", "inverse", "denoise", "variance"])
def test_kernel_entry_without_interpret_raises_on_cpu(call, rng):
    """Without interpret=True an entry point runs the CUDA kernel or
    raises; it never falls back to interpreting."""
    x = jnp.asarray(rng.standard_normal((2, 1024)), jnp.float32)
    with pytest.raises(ValueError, match="needs a CUDA GPU"):
        call(x)


@pytest.mark.parametrize("kind", ["forward", "inverse", "denoise", "variance"])
def test_route_lowers_only_the_platform_branch(kind, rng, monkeypatch):
    """The custom call is lowered only for a CUDA GPU.  Lowered for any
    other platform (here the CPU, as for arrays placed on the host of a GPU
    machine) the program holds the XLA cascade alone, even where the
    kernels are available."""
    from jwave_pro.kernels import modwt_cuda as kc

    monkeypatch.setattr(kc, "available", lambda: True)
    x = jnp.asarray(rng.standard_normal((3, 1000)), jnp.float32)
    c = jnp.asarray(_ref(x, 2), jnp.float32)
    call, arg, want = {
        "forward": (lambda v: modwt_fused(v, DB4, 2), x, c),
        "inverse": (lambda v: imodwt_fused(v, DB4), c, x),
        "denoise": (lambda v: modwt_denoise_fused(v, 0.5, DB4, 2), x,
                    jw.modwt_denoise(x, DB4, 2, threshold=0.5,
                                     method="direct")),
        "variance": (lambda v: modwt_var_fused(v, DB4, 2), x,
                     jnp.mean(c ** 2, axis=-1)),
    }[kind]
    f = jax.jit(call)
    try:
        assert "jwave_modwt" not in f.lower(arg).as_text()
        np.testing.assert_allclose(np.asarray(f(arg)), np.asarray(want),
                                   rtol=1e-5, atol=2e-5)
    finally:    # drop the traces made with the kernels marked available
        for fn in (kc._forward, kc._inverse, kc._denoise, kc._variance):
            fn.clear_cache()


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize("wname,level,n", [
    ("Daubechies 4", 1, 64),
    ("Daubechies 4", 3, 100),
    ("Daubechies 4", 5, 257),
    ("Symlet 8", 2, 96),
    ("Haar", 4, 33),
    ("Coiflet 3", 2, 128),
])
def test_smoke_reference_matches_oracle(wname, level, n, rng):
    """chip_smoke.py's vectorized f64 reference ≡ tests/oracles.py's
    scalar-loop re-statement of MODWTTransform, forward and inverse."""
    cs = _chip_smoke()
    w = jw.wavelet(wname)
    g, h = cs.reference_filters(w.dec_lo, w.dec_hi)
    x = rng.standard_normal(n)
    c = cs.reference_modwt(x, g, h, level)
    np.testing.assert_allclose(c, oracles.modwt(x, w, level), atol=1e-12)
    np.testing.assert_allclose(cs.reference_imodwt(c, g, h),
                               oracles.imodwt(c, w), atol=1e-12)


def test_smoke_reference_denoise_matches_pipeline(rng):
    cs = _chip_smoke()
    g, h = cs.reference_filters(DB4.dec_lo, DB4.dec_hi)
    x = rng.standard_normal((3, 512))
    for thr in (0.8, None):
        got = cs.reference_denoise(x, g, h, 3, thr)
        want = np.asarray(jw.modwt_denoise(x, DB4, 3, threshold=thr,
                                           method="direct"))
        np.testing.assert_allclose(got, want, atol=1e-12)


# ---------------------------------------------------------------------------
# Retired kernels: the same cases on the public XLA paths, against the
# brute-force oracles (packet trees, 2D/3D per axis, MP select, bf16, grads)
# ---------------------------------------------------------------------------

PACKET_CASES = [
    ("Daubechies 4", (2, 256), 3),   # batched
    ("Daubechies 4", (1, 300), 3),   # arbitrary N
    ("Symlet 8", (2, 200), 2),       # long filter
    ("Daubechies 4", (3, 97), 2),    # odd batch and length
    ("Haar", (1, 64), 4),
    ("Daubechies 4", (256,), 2),     # 1D contract
]


def _oracle_modwpt(x, w, level):
    rows = x.reshape(-1, x.shape[-1])
    c = np.stack([oracles.modwpt(r, w, level) for r in rows], axis=1)
    return c.reshape((1 << level,) + x.shape)


@pytest.mark.parametrize("wname,shape,level", PACKET_CASES)
def test_modwpt_matches_oracle(wname, shape, level, rng):
    w = jw.wavelet(wname)
    x = rng.standard_normal(shape)
    got = np.asarray(jw.modwpt(jnp.asarray(x, jnp.float32), w, level))
    np.testing.assert_allclose(got, _oracle_modwpt(x, w, level), atol=2e-5)


@pytest.mark.parametrize("wname,shape,level", PACKET_CASES)
def test_imodwpt_inverts_oracle(wname, shape, level, rng):
    w = jw.wavelet(wname)
    x = rng.standard_normal(shape)
    c = _oracle_modwpt(x, w, level)
    back = np.asarray(jw.imodwpt(jnp.asarray(c, jnp.float32), w))
    np.testing.assert_allclose(back, x, atol=2e-5)


@pytest.mark.parametrize("wname", ["Daubechies 4", "Symlet 8"])
def test_modwpt_bf16_bound(wname, rng):
    w = jw.wavelet(wname)
    x32 = rng.standard_normal((4, 512)).astype(np.float32)
    c = jw.modwpt(jnp.asarray(x32, jnp.bfloat16), w, 2)
    assert c.dtype == jnp.bfloat16
    np.testing.assert_allclose(np.asarray(c, np.float64),
                               _oracle_modwpt(x32.astype(np.float64), w, 2),
                               atol=4e-2)
    back = jw.imodwpt(c, w)
    assert back.dtype == jnp.bfloat16
    np.testing.assert_allclose(np.asarray(back, np.float64), x32, atol=8e-2)


@pytest.mark.parametrize("method", ["direct", "fft"])
def test_modwpt_grad_is_adjoint(method, rng):
    """‖modwpt(x)‖² = ‖x‖² per level, so its gradient is 2x."""
    x = jnp.asarray(rng.standard_normal((4, 512)), jnp.float32)
    g = jax.grad(lambda v: jnp.sum(jw.modwpt(v, DB4, 2, method=method)
                                   ** 2))(x)
    np.testing.assert_allclose(np.asarray(g), 2 * np.asarray(x), atol=1e-4)


@pytest.mark.parametrize("wname,shape,level", [
    ("Daubechies 4", (16, 16), 2),
    ("Symlet 8", (12, 20), 1),
    ("Haar", (8, 24), 2),
])
def test_modwpt2_matches_oracle(wname, shape, level, rng):
    w = jw.wavelet(wname)
    x = rng.standard_normal(shape)
    got = np.asarray(jw.modwpt2(jnp.asarray(x, jnp.float32), w, level))
    np.testing.assert_allclose(got, oracles.modwpt2(x, w, level), atol=2e-5)


def _oracle_axis(x, w, j, axis, band):
    """Level-j V (band 'L') or W (band 'H') of the 1D oracle along one
    axis."""
    row = j if band == "L" else j - 1
    return np.apply_along_axis(lambda r: oracles.modwt(r, w, j)[row],
                               axis, x)


def _oracle_modwt_nd(x, w, level):
    """2D/3D MODWT from the 1D oracle applied per axis: a band's letters
    read in axis order (L = V_j, H = W_j along that axis), detail bands in
    increasing binary order, the all-L band last."""
    nd = x.ndim
    letters = ["".join("LH"[(k >> (nd - 1 - a)) & 1] for a in range(nd))
               for k in range(1, 1 << nd)]
    rows = []
    for j in range(1, level + 1):
        for name in letters:
            y = x
            for a, band in enumerate(name):
                y = _oracle_axis(y, w, j, a, band)
            rows.append(y)
    y = x
    for a in range(nd):
        y = _oracle_axis(y, w, level, a, "L")
    rows.append(y)
    return np.stack(rows)


@pytest.mark.parametrize("wname,shape,level", [
    ("Daubechies 4", (16, 16), 2),
    ("Symlet 8", (12, 20), 1),
    ("Haar", (8, 24), 2),
])
def test_modwt2_matches_per_axis_oracle(wname, shape, level, rng):
    w = jw.wavelet(wname)
    x = rng.standard_normal(shape)
    got = np.asarray(jw.modwt2(jnp.asarray(x, jnp.float32), w, level))
    np.testing.assert_allclose(got, _oracle_modwt_nd(x, w, level), atol=2e-5)
    back = np.asarray(jw.imodwt2(jnp.asarray(got), w))
    np.testing.assert_allclose(back, x, atol=2e-5)


@pytest.mark.parametrize("wname,shape,level", [
    ("Daubechies 4", (8, 8, 8), 1),
    ("Haar", (4, 8, 8), 2),
])
def test_modwt3_matches_per_axis_oracle(wname, shape, level, rng):
    w = jw.wavelet(wname)
    x = rng.standard_normal(shape)
    got = np.asarray(jw.modwt3(jnp.asarray(x, jnp.float32), w, level))
    np.testing.assert_allclose(got, _oracle_modwt_nd(x, w, level), atol=2e-5)
    back = np.asarray(jw.imodwt3(jnp.asarray(got), w))
    np.testing.assert_allclose(back, x, atol=2e-5)


def test_modwt2_bf16_bound(rng):
    x32 = rng.standard_normal((2, 16, 32)).astype(np.float32)
    c = jw.modwt2(jnp.asarray(x32, jnp.bfloat16), DB4, 2)
    assert c.dtype == jnp.bfloat16
    want = np.stack([_oracle_modwt_nd(x.astype(np.float64), DB4, 2)
                     for x in x32], axis=1)
    np.testing.assert_allclose(np.asarray(c, np.float64), want, atol=4e-2)


@pytest.mark.parametrize("call", [
    lambda x: jw.modwpt(x, DB4, 2, method="pallas"),
    lambda x: jw.imodwpt(jnp.stack([x] * 4), DB4, method="pallas"),
    lambda x: jw.modwt2(x, DB4, 1, method="pallas"),
    lambda x: jw.imodwt2(jnp.stack([x] * 4), DB4, method="pallas"),
    lambda x: jw.modwt3(x[None], DB4, 1, method="pallas"),
    lambda x: jw.modwt2_denoise(x, DB4, 1, method="fused"),
    lambda x: jw.cwt(x, [2.0, 4.0], jw.MorletWavelet(), method="fused"),
], ids=["modwpt", "imodwpt", "modwt2", "imodwt2", "modwt3",
        "modwt2_denoise", "cwt"])
def test_retired_kernel_methods_raise(call, rng):
    x = jnp.asarray(rng.standard_normal((16, 16)), jnp.float32)
    with pytest.raises(ValueError):
        call(x)


@pytest.mark.parametrize("batch,n,level", [(8, 256, 2), (2, 300, 2),
                                           (3, 100, 3)])
def test_mp_select_matches_coefficient_argmax(batch, n, level, rng):
    """MP's first pick is the argmax of |⟨x, atom⟩| = |W_n[t]|/‖f_n‖ over
    the oracle's packet coefficients (node, shift and signed amplitude)."""
    from jwave_pro.ops.mp import _atom_tables

    x = rng.standard_normal((batch, n))
    res = jw.matching_pursuit(jnp.asarray(x), DB4, level, 1, method="direct")
    _, norms = _atom_tables(DB4, level, n)
    for b in range(batch):
        c = oracles.modwpt(x[b], DB4, level) / norms[:, None]
        node, t = np.unravel_index(np.argmax(np.abs(c)), c.shape)
        assert int(res.nodes[b, 0]) == node and int(res.shifts[b, 0]) == t
        np.testing.assert_allclose(float(res.amps[b, 0]), c[node, t],
                                   atol=1e-10)
