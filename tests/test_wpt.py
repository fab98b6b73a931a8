"""WPT tests: oracle parity, PR sweeps, best-basis properties."""
import numpy as np
import pytest

import jwave_pro as jw
from . import oracles

DB4 = jw.wavelet("Daubechies 4")
SYM8 = jw.wavelet("Symlet 8")
HAAR = jw.wavelet("Haar")


@pytest.mark.parametrize("level", [1, 2, 3, None])
def test_wpt_matches_oracle(level, rng):
    x = rng.standard_normal(32)
    got = np.asarray(jw.wpt(x, DB4, level))
    want = oracles.wpt(x, DB4, level)
    np.testing.assert_allclose(got, want, atol=1e-10)


def test_iwpt_matches_oracle(rng):
    y = rng.standard_normal(32)
    got = np.asarray(jw.iwpt(y, DB4, 3))
    want = oracles.iwpt(y, DB4, 3)
    np.testing.assert_allclose(got, want, atol=1e-10)


def test_wpt_roundtrip_all_good(rng):
    x = rng.standard_normal(32)
    for w in jw.good_wavelets():
        xr = np.asarray(jw.iwpt(jw.wpt(x, w), w))
        np.testing.assert_allclose(xr, x, atol=1e-6, err_msg=w.name)


def test_parallel_equivalence(rng):
    # ParallelWPTTest analog: the batched level step must equal the
    # sequential per-packet result (here: big batch to engage the same code).
    xb = rng.standard_normal((4, 64))
    got = np.asarray(jw.wpt(xb, SYM8, 3))
    for i in range(4):
        np.testing.assert_allclose(got[i], oracles.wpt(xb[i], SYM8, 3),
                                   atol=1e-10)


def test_wpt_tree_rows(rng):
    x = rng.standard_normal(16)
    tree = np.asarray(jw.wpt_tree(x, HAAR, 4))
    assert tree.shape == (5, 16)
    np.testing.assert_allclose(tree[0], x)
    for l in (1, 2, 3, 4):
        np.testing.assert_allclose(tree[l], oracles.wpt(x, HAAR, l),
                                   atol=1e-10)


def test_best_basis_beats_or_ties_full_tree(rng):
    x = rng.standard_normal(64)
    masks, cost, tree = jw.best_basis(x, SYM8, 4)
    # The chosen basis cost never exceeds the level-0 (input) or deepest cost.
    c0 = float(jw.shannon_entropy_cost(np.asarray(tree[0])))
    assert float(cost) <= c0 + 1e-9
    # masks form a valid tiling: total span = N
    n = 64
    total = sum(int(np.sum(np.asarray(m))) * (n >> l)
                for l, m in enumerate(masks))
    assert total == n


def test_best_basis_picks_leaf_for_packet_concentrated_signal():
    # A pure level-2 packet impulse should keep a coarse (split) basis whose
    # cost equals the minimal entropy (perfect concentration).
    n = 32
    y = np.zeros(n)
    y[5] = 1.0  # impulse is already maximally concentrated at level 0
    masks, cost, _ = jw.best_basis(y, HAAR, 3)
    assert float(cost) <= 1e-9  # -1²·ln(1²) = 0


def test_basis_coefficients_roundtrip(rng):
    x = rng.standard_normal(32)
    masks, _, tree = jw.best_basis(x, DB4, 3)
    flat = np.asarray(jw.basis_coefficients(tree, masks))
    # Energy of any orthonormal-basis representation equals signal energy.
    np.testing.assert_allclose(np.sum(flat**2), np.sum(x**2), rtol=1e-8)


def test_symlet8_level6_65536(rng):
    # BASELINE.json eval config: WPT Symlet8 6-level on 65536 samples.
    x = rng.standard_normal(65536)
    y = jw.wpt(x, SYM8, 6)
    xr = np.asarray(jw.iwpt(y, SYM8, 6))
    np.testing.assert_allclose(xr, x, atol=1e-7)


def test_basis_reconstruct_roundtrip(rng):
    x = rng.standard_normal(64)
    for wname in ("Haar", "Symlet 8"):
        w = jw.wavelet(wname)
        masks, _, tree = jw.best_basis(x, w, 4)
        flat = jw.basis_coefficients(tree, masks)
        xr = np.asarray(jw.basis_reconstruct(flat, masks, w))
        np.testing.assert_allclose(xr, x, atol=1e-8, err_msg=wname)


def test_basis_reconstruct_under_jit(rng):
    import jax
    x = rng.standard_normal(32)
    w = jw.wavelet("Daubechies 4")

    @jax.jit
    def roundtrip(v):
        masks, cost, tree = jw.best_basis(v, w, 3)
        flat = jw.basis_coefficients(tree, masks)
        return jw.basis_reconstruct(flat, masks, w)

    np.testing.assert_allclose(np.asarray(roundtrip(x)), x, atol=1e-8)


def test_lifting_cdf_roundtrip_and_moments(rng):
    from jwave_pro.ops import lifting
    x = rng.standard_normal(64)
    for scheme, f, i in (("cdf53", lifting.cdf53, lifting.icdf53),
                         ("cdf97", lifting.cdf97, lifting.icdf97)):
        y = f(x)
        np.testing.assert_allclose(np.asarray(i(y)), x, atol=1e-10,
                                   err_msg=scheme)
    # CDF 5/3 has 2 vanishing moments: constant signal -> zero details
    # (periodic boundary keeps linears only approximately at the wrap).
    const = np.full(32, 2.5)
    y = np.asarray(lifting.cdf53(const, level=1))
    np.testing.assert_allclose(y[16:], 0.0, atol=1e-12)
    y97 = np.asarray(lifting.cdf97(const, level=1))
    np.testing.assert_allclose(y97[16:], 0.0, atol=1e-9)


def test_wpt2_roundtrip_and_separable(rng):
    m = rng.standard_normal((16, 32))
    y = np.asarray(jw.wpt2(m, DB4, 2, 3))
    # separability: cols then rows must equal manual passes
    manual = np.asarray(jw.wpt(m, DB4, 3))
    manual = np.swapaxes(np.asarray(jw.wpt(np.swapaxes(manual, -1, -2),
                                           DB4, 2)), -1, -2)
    np.testing.assert_allclose(y, manual, atol=1e-12)
    np.testing.assert_allclose(np.asarray(jw.iwpt2(y, DB4, 2, 3)), m,
                               atol=1e-8)


def test_wpt3_roundtrip_and_facade(rng):
    """3D WPT — the reference's generic 3D dispatch applied to the packet
    engine (BasicTransform.java:509-566)."""
    s = rng.standard_normal((8, 16, 32))
    y = np.asarray(jw.wpt3(s, DB4, (1, 2, 2)))
    assert y.shape == s.shape
    np.testing.assert_allclose(np.asarray(jw.iwpt3(y, DB4, (1, 2, 2))), s,
                               atol=1e-8)
    eng = jw.WaveletPacketTransform(DB4)
    np.testing.assert_allclose(np.asarray(eng.forward(s, (1, 2, 2))), y,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(eng.reverse(y, (1, 2, 2))), s,
                               atol=1e-8)
    # full-depth default levels also roundtrip
    y2 = jw.wpt3(s, HAAR)
    np.testing.assert_allclose(np.asarray(jw.iwpt3(y2, HAAR)), s, atol=1e-8)


def test_wpt2_tree_quadtree_layout(rng):
    # row 1 of the quad tree == one separable step at full size == wpt2 with
    # level 1 on both axes
    img = rng.standard_normal((16, 32))
    tree = np.asarray(jw.wpt2_tree(img, HAAR, 2))
    assert tree.shape == (3, 16, 32)
    np.testing.assert_allclose(tree[1],
                               np.asarray(jw.wpt2(img, HAAR, 1, 1)),
                               atol=1e-12)
    # energy preserved per row (orthonormal steps)
    for l in range(3):
        np.testing.assert_allclose(np.sum(tree[l] ** 2), np.sum(img ** 2),
                                   rtol=1e-10)


def test_best_basis2_impulse_keeps_root(rng):
    img = np.zeros((16, 16))
    img[3, 7] = 1.0  # maximally concentrated at level 0
    masks, cost, _ = jw.best_basis2(img, HAAR, 3)
    assert bool(masks[0][0, 0]) and float(cost) <= 1e-9


def test_best_basis2_oscillation_prefers_depth(rng):
    # a pure high-frequency checkerboard concentrates only at depth ≥ 1:
    # the root must split
    r = np.indices((16, 16)).sum(axis=0)
    img = ((-1.0) ** r).astype(float)
    masks, _, _ = jw.best_basis2(img, HAAR, 3)
    assert not bool(masks[0][0, 0])


def test_basis2_flatten_reconstruct_roundtrip(rng):
    img = rng.standard_normal((32, 32))
    for wname in ("Haar", "Daubechies 4"):
        w = jw.wavelet(wname)
        masks, _, tree = jw.best_basis2(img, w, 3)
        flat = jw.basis_coefficients2(tree, masks)
        # any orthonormal mixed basis preserves energy
        np.testing.assert_allclose(np.sum(np.asarray(flat) ** 2),
                                   np.sum(img ** 2), rtol=1e-8)
        xr = np.asarray(jw.basis_reconstruct2(flat, masks, w))
        np.testing.assert_allclose(xr, img, atol=1e-8, err_msg=wname)


def test_basis2_masks_tile_plane(rng):
    img = rng.standard_normal((32, 16))
    masks, _, _ = jw.best_basis2(img, DB4, 2)
    cover = np.zeros((32, 16))
    for l, m in enumerate(masks):
        p = 1 << l
        cover += np.kron(np.asarray(m, dtype=float),
                         np.ones((32 // p, 16 // p)))
    np.testing.assert_allclose(cover, 1.0)  # exact tiling, no overlap


def test_best_basis2_level_validation(rng):
    img = rng.standard_normal((16, 16))
    with pytest.raises(ValueError, match="out of range"):
        jw.best_basis2(img, HAAR, -1)
    with pytest.raises(ValueError, match="out of range"):
        jw.best_basis2(img, HAAR, 99)
