"""Matching pursuit tests — greedy sparse decomposition over MODWPT atoms.

Beyond-reference tier (the reference's adaptive-basis story stops at the
README's "optimal basis selection" claim; `SURVEY.md §6` notes no best-basis
code exists there at all).  Referee is the mathematics plus a brute-force
oracle: the scan's picks must equal an explicit-dictionary greedy loop, the
greedy energy identity ‖r_k‖² = ‖r_{k-1}‖² − α_k² must hold exactly, a pure
atom must be recovered in one step, and reconstruct + residual must equal
the input to machine precision.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import jwave_pro as jw
from jwave_pro.ops.mp import _atom_tables

W = jw.wavelet("Daubechies 4")
N, LEVEL = 64, 2


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _dictionary(wavelet, level, n):
    """Explicit (2^level·n, n) unit-atom matrix, node-major like the scan."""
    rev, _ = _atom_tables(wavelet, level, n)
    return np.stack([np.roll(rev[nd], t)
                     for nd in range(1 << level) for t in range(n)])


def test_matches_bruteforce_oracle(rng):
    x = rng.standard_normal(N)
    k = 6
    res = jw.matching_pursuit(jnp.asarray(x), W, LEVEL, k, method="direct")
    d = _dictionary(W, LEVEL, N)
    r = x.astype(np.float64)
    for i in range(k):
        c = d @ r
        j = int(np.argmax(np.abs(c)))
        assert int(res.nodes[i]) == j // N
        assert int(res.shifts[i]) == j % N
        assert abs(float(res.amps[i]) - c[j]) < 1e-10
        r = r - c[j] * d[j]
    np.testing.assert_allclose(np.asarray(res.residual), r, atol=1e-12)


def test_energy_identity_and_reconstruction(rng):
    x = jnp.asarray(rng.standard_normal(N))
    res = jw.matching_pursuit(x, W, LEVEL, 10, method="direct")
    # unit atoms ⇒ exact greedy energy bookkeeping
    e_in = float(jnp.sum(x ** 2))
    e_res = float(jnp.sum(res.residual ** 2))
    assert abs((e_in - float(jnp.sum(res.energies))) - e_res) < 1e-10
    # residual energy strictly decreases (amps nonzero for a generic signal)
    assert e_res < e_in
    xr = jw.mp_reconstruct(res, W) + res.residual
    np.testing.assert_allclose(np.asarray(xr), np.asarray(x), atol=1e-12)


def test_single_atom_exact_recovery():
    rev, _ = _atom_tables(W, LEVEL, N)
    atom = np.roll(rev[2], 17)
    res = jw.matching_pursuit(jnp.asarray(3.5 * atom), W, LEVEL, 1,
                              method="direct")
    assert int(res.nodes[0]) == 2 and int(res.shifts[0]) == 17
    assert abs(float(res.amps[0]) - 3.5) < 1e-9
    assert float(jnp.max(jnp.abs(res.residual))) < 1e-9


def test_two_atoms_separate_transient_from_tone():
    # a tone (narrow-band packet) + a localized bump: MP's first two picks
    # must land on distinct nodes — the super-completeness win over a single
    # best basis
    t = np.arange(256)
    tone = np.sin(2 * np.pi * 0.23 * t)
    res = jw.matching_pursuit(jnp.asarray(tone), W, 3, 8, method="direct")
    # a steady tone at ~0.46·Nyquist concentrates in the matching band
    # (node ≈ f/fs·2^(J+1) = 0.23·16 ≈ 3.7 → nodes 3/4)
    assert int(res.nodes[0]) in (3, 4)


def test_batched_and_jitted(rng):
    xb = jnp.asarray(rng.standard_normal((3, N)))
    f = jax.jit(lambda z: jw.matching_pursuit(z, W, LEVEL, 4,
                                              method="direct")[:4])
    nodes, shifts, amps, resid = f(xb)
    assert nodes.shape == shifts.shape == amps.shape == (3, 4)
    assert resid.shape == (3, N)
    r0 = jw.matching_pursuit(xb[0], W, LEVEL, 4, method="direct")
    assert bool(jnp.all(nodes[0] == r0.nodes))
    np.testing.assert_allclose(np.asarray(resid[0]),
                               np.asarray(r0.residual), atol=1e-12)


def test_correlations_are_one_modwpt():
    # the design identity: ⟨x, atom[n,t]⟩ == modwpt(x)[n,t]/‖f_n‖
    rng = np.random.default_rng(3)
    x = rng.standard_normal(N)
    w = np.asarray(jw.modwpt(jnp.asarray(x), W, LEVEL, method="direct"))
    d = _dictionary(W, LEVEL, N)
    _, norms = _atom_tables(W, LEVEL, N)
    corr = (d @ x).reshape(1 << LEVEL, N)
    np.testing.assert_allclose(w / norms[:, None], corr, atol=1e-12)


def test_omp_orthogonality_and_improvement(rng):
    x = jnp.asarray(rng.standard_normal(N))
    k = 6
    omp = jw.matching_pursuit(x, W, LEVEL, k, method="direct",
                              orthogonalize=True)
    mp = jw.matching_pursuit(x, W, LEVEL, k, method="direct")
    rev, _ = _atom_tables(W, LEVEL, N)
    r = np.asarray(omp.residual)
    # residual exactly orthogonal to every selected atom's span
    for i in range(k):
        atom = np.roll(rev[int(omp.nodes[i])], int(omp.shifts[i]))
        assert abs(np.dot(r, atom)) < 1e-12
    # least-squares remainder never worse than plain MP's
    assert float(jnp.sum(omp.residual ** 2)) <= \
        float(jnp.sum(mp.residual ** 2)) + 1e-12
    xr = jw.mp_reconstruct(omp, W) + omp.residual
    np.testing.assert_allclose(np.asarray(xr), np.asarray(x), atol=1e-12)


def test_omp_exact_two_atom_recovery():
    rev, _ = _atom_tables(W, LEVEL, N)
    mix = 2.0 * np.roll(rev[1], 5) - 1.5 * np.roll(rev[3], 40)
    res = jw.matching_pursuit(jnp.asarray(mix), W, LEVEL, 2, method="direct",
                              orthogonalize=True)
    assert set(map(int, np.asarray(res.nodes))) == {1, 3}
    assert set(map(int, np.asarray(res.shifts))) == {5, 40}
    assert sorted(map(float, np.asarray(res.amps))) == pytest.approx(
        [-1.5, 2.0], abs=1e-9)
    assert float(jnp.max(jnp.abs(res.residual))) < 1e-9


def test_omp_batched_jit(rng):
    xb = jnp.asarray(rng.standard_normal((3, N)))
    f = jax.jit(lambda z: jw.matching_pursuit(
        z, W, LEVEL, 4, method="direct", orthogonalize=True)[:4])
    nodes, shifts, amps, resid = f(xb)
    r0 = jw.matching_pursuit(xb[0], W, LEVEL, 4, method="direct",
                             orthogonalize=True)
    assert bool(jnp.all(nodes[0] == r0.nodes))
    np.testing.assert_allclose(np.asarray(resid[0]),
                               np.asarray(r0.residual), atol=1e-12)


def test_validation():
    with pytest.raises(ValueError, match="n_atoms"):
        jw.matching_pursuit(jnp.zeros(N), W, LEVEL, 0)


def test_omp_rank_deficient_stays_finite():
    """ADVICE r3 (medium): n_atoms beyond the signal's effective sparsity —
    once the residual is ~0 the scan re-picks an atom and the Gram goes
    singular; the ridge-regularized solve must keep every output finite and
    the reconstruction exact."""
    rev, _ = _atom_tables(W, LEVEL, N)
    x = jnp.asarray(3.0 * np.roll(rev[2], 11), jnp.float64)  # one pure atom
    r = jw.matching_pursuit(x, W, LEVEL, 6, method="direct",
                            orthogonalize=True)
    assert bool(jnp.all(jnp.isfinite(r.amps)))
    assert bool(jnp.all(jnp.isfinite(r.residual)))
    xr = jw.mp_reconstruct(r, W) + r.residual
    np.testing.assert_allclose(np.asarray(xr), np.asarray(x), atol=1e-8)
    assert float(jnp.max(jnp.abs(r.residual))) < 1e-6


def test_mpresult_is_jittable_pytree(rng):
    """ADVICE r3 (low): level/wavelet_name are pytree aux_data, so a jitted
    function can RETURN the full MPResult (a str leaf used to fail at
    trace time)."""
    x = jnp.asarray(rng.standard_normal((2, N)))
    f = jax.jit(lambda v: jw.matching_pursuit(v, W, LEVEL, 3,
                                              method="direct"))
    r = f(x)
    assert r.level == LEVEL and r.wavelet_name == W.name
    r2 = jw.matching_pursuit(x, W, LEVEL, 3, method="direct")
    np.testing.assert_allclose(np.asarray(r.residual),
                               np.asarray(r2.residual), atol=1e-12)
    # vmap over the batch axis reaches the same picks
    rv = jax.vmap(lambda v: jw.matching_pursuit(v, W, LEVEL, 3,
                                                method="direct"))(x)
    assert bool(jnp.all(rv.nodes == r2.nodes))
