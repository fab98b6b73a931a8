"""MODWPT tests: oracle parity, inverse, shift-invariance, sequency order,
energy preservation, MRA additivity, best basis.

The MODWPT has no reference-Java counterpart (it completes the decimated
packet engine ``WaveletPacketTransform.java`` with the MODWT's
shift-invariant filter pipeline, ``MODWTTransform.java:452-484``); the
referee is the brute-force sequency-ordered oracle in oracles.py.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import jwave_pro as jw
from jwave_pro.ops.modwpt import (
    imodwpt, modwpt, modwpt_basis_reconstruct, modwpt_best_basis,
    modwpt_mra, modwpt_node_path, modwpt_tree,
)
from . import oracles

DB4 = jw.wavelet("Daubechies 4")
HAAR = jw.wavelet("Haar")


@pytest.mark.parametrize("n", [45, 64])
@pytest.mark.parametrize("name", ["Haar", "Daubechies 4", "Symlet 8"])
def test_modwpt_matches_oracle(name, n, rng):
    w = jw.wavelet(name)
    x = rng.standard_normal(n)
    level = 3
    got = np.asarray(modwpt(x, w, level, method="direct"))
    want = oracles.modwpt(x, w, level)
    np.testing.assert_allclose(got, want, atol=1e-10)


def test_modwpt_fft_equals_direct(rng):
    x = rng.standard_normal(100)
    d = np.asarray(modwpt(x, DB4, 3, method="direct"))
    f = np.asarray(modwpt(x, DB4, 3, method="fft"))
    np.testing.assert_allclose(d, f, atol=1e-9)


@pytest.mark.parametrize("name", ["Haar", "Daubechies 4", "Coiflet 2"])
@pytest.mark.parametrize("n", [51, 128])
def test_modwpt_roundtrip(name, n, rng):
    w = jw.wavelet(name)
    x = rng.standard_normal(n)
    for level in (1, 2, 3):
        xr = np.asarray(imodwpt(modwpt(x, w, level), w))
        np.testing.assert_allclose(xr, x, atol=1e-8)


def test_imodwpt_matches_oracle(rng):
    x = rng.standard_normal(33)
    c = oracles.modwpt(x, DB4, 2)
    got = np.asarray(imodwpt(jnp.asarray(c), DB4, method="direct"))
    want = oracles.imodwpt(c, DB4)
    np.testing.assert_allclose(got, want, atol=1e-10)


def test_modwpt_level1_equals_modwt(rng):
    # Node 0 = V_1 (scaling), node 1 = W_1 (wavelet): sequency order.
    x = rng.standard_normal(64)
    p = np.asarray(modwpt(x, DB4, 1))
    m = np.asarray(jw.modwt(x, DB4, 1, method="direct"))
    np.testing.assert_allclose(p[0], m[1], atol=1e-12)  # V_1
    np.testing.assert_allclose(p[1], m[0], atol=1e-12)  # W_1
    # At any level J: node 0 = V_J, node 1 = W_J.
    p3 = np.asarray(modwpt(x, DB4, 3))
    m3 = np.asarray(jw.modwt(x, DB4, 3, method="direct"))
    np.testing.assert_allclose(p3[0], m3[3], atol=1e-12)  # V_3
    np.testing.assert_allclose(p3[1], m3[2], atol=1e-12)  # W_3


def test_modwpt_energy_preserved_per_level(rng):
    x = rng.standard_normal(90)
    e0 = np.sum(x * x)
    tree = modwpt_tree(x, DB4, 4)
    for row in tree:
        np.testing.assert_allclose(float(jnp.sum(row * row)), e0, rtol=1e-10)


def test_modwpt_shift_invariance(rng):
    # The defining property: a circular shift of the input circularly
    # shifts every node (PropertyBasedTest MODWT analog, extended).
    x = rng.standard_normal(77)
    s = 13
    a = np.asarray(modwpt(np.roll(x, s), DB4, 3))
    b = np.roll(np.asarray(modwpt(x, DB4, 3)), s, axis=-1)
    np.testing.assert_allclose(a, b, atol=1e-10)


def test_modwpt_sequency_ordering():
    # A pure tone at normalized frequency f concentrates in node
    # floor(f / (fs/2) * 2^J) when read in sequency order.
    n, fs = 512, 1.0
    t = np.arange(n) / fs
    level = 3
    for frac in (0.07, 0.21, 0.33, 0.47):  # fractions of Nyquist
        x = np.sin(2 * np.pi * (frac * fs / 2) * t)
        nodes = np.asarray(modwpt(x, DB4, level))
        energies = np.sum(nodes * nodes, axis=-1)
        assert int(np.argmax(energies)) == int(frac * (1 << level))


def test_modwpt_mra_sums_to_signal(rng):
    x = rng.standard_normal(60)
    comps = np.asarray(modwpt_mra(x, DB4, 3))
    assert comps.shape == (8, 60)
    np.testing.assert_allclose(comps.sum(axis=0), x, atol=1e-8)


def test_modwpt_mra_isolates_band():
    # The component of a mid-band tone should carry nearly all its energy.
    n = 512
    t = np.arange(n)
    x = np.sin(2 * np.pi * 0.17 * t)
    # Db4's level-2 band separation leaks ~24%; Symlet 12's longer filters
    # confine the tone's component to its band.
    comps = np.asarray(modwpt_mra(x, jw.wavelet("Symlet 12"), 2))
    # 0.17 of fs → 0.34 of Nyquist → node 1 of 4
    frac = np.sum(comps[1] ** 2) / np.sum(x * x)
    assert frac > 0.8


def test_modwpt_best_basis_reconstructs(rng):
    x = rng.standard_normal(128)
    masks, total, tree = modwpt_best_basis(x, DB4, 3)
    # masks form a valid tiling: leaf fractions sum to 1
    frac = sum(float(jnp.sum(m)) / (1 << l) for l, m in enumerate(masks))
    np.testing.assert_allclose(frac, 1.0, atol=1e-12)
    xr = np.asarray(modwpt_basis_reconstruct(tree, masks, DB4))
    np.testing.assert_allclose(xr, x, atol=1e-8)


def test_modwpt_best_basis_prefers_matching_leaf():
    # A single tone is sparsest in the deep node covering its band: the DP
    # should descend there rather than stay at the root.
    n = 256
    x = np.sin(2 * np.pi * 0.11 * np.arange(n))
    masks, total, tree = modwpt_best_basis(x, DB4, 3, cost="shannon")
    # cost of chosen basis must be ≤ every fixed-level basis cost
    from jwave_pro.ops.wpt import shannon_entropy_cost
    for l in (0, 3):
        row = tree[l]
        fixed = float(jnp.sum(shannon_entropy_cost(
            row.reshape(row.shape[0], -1), axis=-1)))
        assert float(total) <= fixed + 1e-9


def test_modwpt_batched_and_jit(rng):
    x = rng.standard_normal((3, 4, 64))
    c = modwpt(x, HAAR, 2)
    assert c.shape == (4, 3, 4, 64)
    single = modwpt(x[1, 2], HAAR, 2)
    np.testing.assert_allclose(np.asarray(c[:, 1, 2]), np.asarray(single),
                               atol=1e-12)
    jitted = jax.jit(lambda v: imodwpt(modwpt(v, HAAR, 2), HAAR))
    np.testing.assert_allclose(np.asarray(jitted(x)), x, atol=1e-8)


def test_modwpt_node_path():
    assert modwpt_node_path(1, 0) == ["g"]
    assert modwpt_node_path(1, 1) == ["h"]
    # level 2 sequency: GG, GH, HH, HG
    assert [modwpt_node_path(2, n) for n in range(4)] == [
        ["g", "g"], ["g", "h"], ["h", "h"], ["h", "g"]]
    with pytest.raises(ValueError):
        modwpt_node_path(2, 4)


def test_modwpt_validation(rng):
    x = rng.standard_normal(32)
    with pytest.raises(ValueError):
        modwpt(x, DB4, 0)
    with pytest.raises(ValueError):
        modwpt(x, DB4, 6)  # exceeds log2(32)
    with pytest.raises(ValueError):
        imodwpt(jnp.zeros((3, 32)), DB4)  # non-pow2 node count


# ---------------------------------------------------------------------------
# 2D quad-tree
# ---------------------------------------------------------------------------

from jwave_pro.ops.modwpt import (  # noqa: E402
    imodwpt2, modwpt2, modwpt2_basis_reconstruct, modwpt2_best_basis,
    modwpt2_tree,
)


def test_modwpt2_matches_oracle(rng):
    x = rng.standard_normal((16, 12))
    got = np.asarray(modwpt2(x, DB4, 2, method="direct"))
    want = oracles.modwpt2(x, DB4, 2)
    assert got.shape == (4, 4, 16, 12)
    np.testing.assert_allclose(got, want, atol=1e-10)


def test_modwpt2_roundtrip_and_batch(rng):
    x = rng.standard_normal((3, 20, 24))
    c = modwpt2(x, HAAR, 2)
    assert c.shape == (4, 4, 3, 20, 24)
    xr = np.asarray(imodwpt2(c, HAAR))
    np.testing.assert_allclose(xr, x, atol=1e-8)
    single = np.asarray(modwpt2(x[1], HAAR, 2))
    np.testing.assert_allclose(np.asarray(c[:, :, 1]), single, atol=1e-12)


def test_modwpt2_node00_is_modwt2_LL(rng):
    x = rng.standard_normal((24, 24))
    c = np.asarray(modwpt2(x, DB4, 2, method="direct"))
    m = np.asarray(jw.modwt2(x, DB4, 2, method="direct"))
    np.testing.assert_allclose(c[0, 0], m[-1], atol=1e-10)  # LL_2


def test_modwpt2_shift_invariance_both_axes(rng):
    x = rng.standard_normal((20, 28))
    a = np.asarray(modwpt2(np.roll(np.roll(x, 5, 0), 9, 1), DB4, 2,
                           method="direct"))
    b = np.roll(np.roll(np.asarray(modwpt2(x, DB4, 2, method="direct")),
                        5, -2), 9, -1)
    np.testing.assert_allclose(a, b, atol=1e-10)


def test_modwpt2_energy_and_orientation():
    n = 64
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    # pure horizontal-axis oscillation (varies along columns only)
    x = np.sin(2 * np.pi * 0.21 * xx)
    c = np.asarray(modwpt2(x, jw.wavelet("Symlet 8"), 2, method="direct"))
    e = np.sum(c * c, axis=(-2, -1))
    np.testing.assert_allclose(e.sum(), np.sum(x * x), rtol=1e-9)
    nr, nc = np.unravel_index(np.argmax(e), e.shape)
    # no row variation → row node 0; 0.21·2 = 0.42 of Nyquist → col node 1
    assert (nr, nc) == (0, 1)


def test_modwpt2_tree_and_best_basis(rng):
    x = rng.standard_normal((24, 24))
    masks, total, tree = modwpt2_best_basis(x, DB4, 2)
    frac = sum(float(jnp.sum(m)) / (1 << (2 * l))
               for l, m in enumerate(masks))
    np.testing.assert_allclose(frac, 1.0, atol=1e-12)
    xr = np.asarray(modwpt2_basis_reconstruct(tree, masks, DB4))
    np.testing.assert_allclose(xr, x, atol=1e-8)
    # chosen basis beats (or ties) every fixed-level basis
    from jwave_pro.ops.wpt import shannon_entropy_cost
    for l in (0, 2):
        row = tree[l]
        fixed = float(jnp.sum(shannon_entropy_cost(
            row.reshape(row.shape[0] * row.shape[1], -1), axis=-1)))
        assert float(total) <= fixed + 1e-9


def test_modwpt2_tree_levels_match_modwpt2(rng):
    x = rng.standard_normal((16, 16))
    tree = modwpt2_tree(x, DB4, 2, method="direct")
    full = np.asarray(modwpt2(x, DB4, 2, method="direct"))
    np.testing.assert_allclose(np.asarray(tree[2]), full, atol=1e-10)
    np.testing.assert_allclose(np.asarray(tree[0][0, 0]), x, atol=1e-12)


def test_modwpt2_validation(rng):
    x = rng.standard_normal((16, 16))
    with pytest.raises(ValueError):
        modwpt2(x, DB4, 5)  # exceeds log2(16)
    with pytest.raises(ValueError):
        modwpt2(rng.standard_normal(16), DB4, 1)  # 1D input
    with pytest.raises(ValueError):
        imodwpt2(jnp.zeros((3, 3, 16, 16)), DB4)  # non-pow2 nodes
    with pytest.raises(ValueError):
        imodwpt2(jnp.zeros((2, 4, 16, 16)), DB4)  # unequal node axes


def test_modwpt3_roundtrip_shift_invariance_and_lll(rng):
    """r5 oct-tree: tensor product of three 1D packet cascades —
    roundtrip, exact 3-axis shift invariance, node (0,0,0) = MODWT LLL,
    energy preservation, batching."""
    w = jw.wavelet("Daubechies 4")
    x = jnp.asarray(rng.standard_normal((2, 8, 16, 8)))
    c = jw.modwpt3(x, w, 1)
    assert c.shape == (2, 2, 2, 2, 8, 16, 8)
    np.testing.assert_allclose(np.asarray(jw.imodwpt3(c, w)),
                               np.asarray(x), atol=1e-10)
    lll = np.asarray(jw.modwt3(x, w, 1, method="direct")[-1])
    np.testing.assert_allclose(np.asarray(c[0, 0, 0]), lll, atol=1e-12)
    np.testing.assert_allclose(float(jnp.sum(c ** 2)),
                               float(jnp.sum(x ** 2)), rtol=1e-10)
    for ax in (-3, -2, -1):
        cs = jw.modwpt3(jnp.roll(x, 3, axis=ax), w, 1)
        np.testing.assert_allclose(np.asarray(cs),
                                   np.asarray(jnp.roll(c, 3, axis=ax)),
                                   atol=1e-10)
    # single volume == batch row
    c1 = jw.modwpt3(x[0], w, 1)
    np.testing.assert_allclose(np.asarray(c1), np.asarray(c[:, :, :, 0]),
                               atol=1e-12)
    with np.testing.assert_raises(ValueError):
        jw.imodwpt3(np.zeros((2, 2, 3, 8, 8, 8)), w)
