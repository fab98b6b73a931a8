"""Dual-Tree Complex Wavelet Transform — near-analytic, near-shift-invariant.

The DTCWT (Kingsbury 1998-2001; Selesnick, Baraniuk & Kingsbury 2005) runs
TWO parallel orthonormal DWT trees whose wavelets form an approximate
Hilbert pair, ψ_b ≈ H[ψ_a]; the complex coefficients w = (w_a + i·w_b)/√2
then have a smooth, nearly shift-invariant magnitude at only 2× redundancy
— the classic middle ground between the critically-sampled FWT (shift-
variant) and the fully-redundant MODWT.  Beyond the reference's scope (its
discrete tier is the plain FWT, ``WaveletTransform.java``); complements
this library's MODWT tier at 2× instead of (J+1)× redundancy.

**Q-shift filters are DESIGNED here, not transcribed** — Selesnick's
common-factor construction (IEEE SPL 2002 / IEEE TSP 2002):

    h_a(z) = F(z)·D(z),      h_b(z) = F(z)·z^{-L}·D(1/z)

where D is the degree-L Thiran maximally-flat fractional-delay polynomial
for τ = ½ (so z^{-L}D(1/z)/D(z) is an allpass ≈ e^{-jω/2}: h_b is h_a
delayed by exactly half a sample to order-L flatness) and F = (1+z⁻¹)^K·G
carries K vanishing moments.  Both trees share the SAME product filter
H(z)H(1/z), so one halfband linear solve + one spectral factorization
(numpy, host-side f64) yields an orthonormal pair: PR is EXACT in each
tree (machine-ε orthonormality), analyticity is approximate (measured
negative-frequency wavelet energy: 0.05% at K=3,L=2; 0.004% at K=4,L=3).

Each tree's level step is the FWT tier's banded block-circulant
constant matmul (``ops/fwt.py:analysis_step`` — stride-2 absorbed into a
constant matrix, no strided slicing); the two trees batch through the same
compiled steps.  Level 1 uses a standard orthonormal wavelet with tree b
offset by ONE input sample (the Kingsbury trick: a 1-sample delay before
↓2 is a half-sample offset after it), implemented as a circular roll.
"""
from __future__ import annotations

import functools
import math
import typing
from math import comb

import numpy as np

import jax
import jax.numpy as jnp

from ..wavelets.base import DiscreteWavelet, qmf_orthonormal
from .fwt import analysis_step, synthesis_step

__all__ = ["DTCWTResult", "dtcwt", "idtcwt", "DTCWT2Result", "dtcwt2",
           "idtcwt2", "dtcwt_denoise", "dtcwt2_denoise", "qshift_wavelets",
           "qshift_design"]


def _thiran_half_delay(l: int) -> np.ndarray:
    """Degree-``l`` Thiran polynomial D: z^{-l}D(1/z)/D(z) ≈ e^{-jω/2}.

    Maximally-flat fractional-delay allpass for τ = ½ (Thiran 1971) —
    measured phase delay stays within 2e-4 of ½ over |ω| ≤ 1 at l = 3.
    """
    d = np.zeros(l + 1)
    d[0] = 1.0
    tau = 0.5
    for k in range(1, l + 1):
        p = 1.0
        for n in range(l + 1):
            p *= (tau - l + n) / (tau - l + k + n)
        d[k] = (-1) ** k * comb(l, k) * p
    return d


def _sym_conv(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """One-sided convolution of symmetric (centered) Laurent coefficients."""
    fa = np.concatenate([a[::-1], a[1:]])
    fb = np.concatenate([b[::-1], b[1:]])
    return np.convolve(fa, fb)[len(a) + len(b) - 2:]


@functools.lru_cache(maxsize=16)
def qshift_design(k: int = 4, l: int = 3):
    """Design the common-factor q-shift lowpass pair → (h0a, h0b) f64.

    ``k``: vanishing moments; ``l``: Thiran order (half-sample-delay
    flatness).  Filter length is 2·ceil((k+l+1)/2)... concretely k+l+1 +
    (k+l-1) = even 2(k+l).  Steps: (1) halfband linear solve for the
    symmetric factor U with P = (2+z+z⁻¹)^K·D(z)D(1/z)·U(z) halfband;
    (2) spectral factorization U = G·G(1/z) (roots inside the unit
    circle); (3) h0a = (1+z⁻¹)^K G D, h0b = (1+z⁻¹)^K G rev(D), both
    normalized to unit L2 (they share one autocorrelation, hence one PR
    certificate).  Raises if U(ω) < 0 (never observed for k,l ≤ 6).
    """
    if k < 1 or l < 1:
        raise ValueError("need k >= 1 vanishing moments and l >= 1")
    d = _thiran_half_delay(l)
    r = np.array([np.dot(d[:len(d) - m], d[m:]) for m in range(l + 1)])
    b = np.array([comb(2 * k, k + m) for m in range(k + 1)], float)
    m_u = k + l - 1
    br = _sym_conv(b, r)
    n_eq = k + l
    a_mat = np.zeros((n_eq, m_u + 1))
    for j in range(m_u + 1):
        u = np.zeros(m_u + 1)
        u[j] = 1.0
        p = _sym_conv(br, u)
        for i in range(n_eq):
            a_mat[i, j] = p[2 * i] if 2 * i < len(p) else 0.0
    rhs = np.zeros(n_eq)
    rhs[0] = 1.0
    u = np.linalg.solve(a_mat, rhs)
    w = np.linspace(0, np.pi, 8192)
    u_w = u[0] + 2 * sum(u[m] * np.cos(m * w) for m in range(1, m_u + 1))
    if u_w.min() < -1e-12:
        raise ValueError(f"common-factor design infeasible (U min "
                         f"{u_w.min():.2e}) for k={k}, l={l}")
    fu = np.concatenate([u[::-1], u[1:]])
    roots = np.roots(fu)
    g = np.real(np.poly(roots[np.abs(roots) < 1.0]))
    f = g.copy()
    for _ in range(k):
        f = np.convolve(f, [1.0, 1.0])
    h0a = np.convolve(f, d)
    h0b = np.convolve(f, d[::-1])
    h0a /= np.linalg.norm(h0a)
    h0b /= np.linalg.norm(h0b)
    return h0a, h0b


@functools.lru_cache(maxsize=16)
def qshift_wavelets(k: int = 4, l: int = 3):
    """The designed q-shift pair as :class:`DiscreteWavelet` objects.

    Each tree is a standard orthonormal wavelet (alternating-flip QMF
    highpass, reconstruction = decomposition — the library convention),
    so the whole FWT matmul machinery applies per tree.
    """
    h0a, h0b = qshift_design(k, l)
    wa = qmf_orthonormal(f"QShift-a (k={k}, l={l})", h0a, family="QShift")
    wb = qmf_orthonormal(f"QShift-b (k={k}, l={l})", h0b, family="QShift")
    return wa, wb


class DTCWTResult(typing.NamedTuple):
    """Dual-tree coefficients; all arrays share the input's leading dims.

    ``highpass``: tuple over levels 1..J of COMPLEX (..., N/2^j) subbands
    w = (w_a + i·w_b)/√2 — magnitude is near shift-invariant, and
    Σ_j ‖w_j‖² + (‖low_a‖² + ‖low_b‖²)/2 = ‖x‖² exactly.
    ``lowpass_a``/``lowpass_b``: the two trees' real V_J rows (..., N/2^J).
    """

    highpass: tuple
    lowpass_a: jax.Array
    lowpass_b: jax.Array

    @property
    def magnitudes(self):
        return tuple(jnp.abs(w) for w in self.highpass)


def _tree_params(level1: DiscreteWavelet | None, k: int, l: int):
    if level1 is None:
        from ..wavelets.families import wavelet as _lookup
        level1 = _lookup("Symlet 8")
    wa, wb = qshift_wavelets(k, l)
    return level1, wa, wb


def dtcwt(x: jax.Array, level: int, level1: DiscreteWavelet | None = None,
          k: int = 4, l: int = 3) -> DTCWTResult:
    """Dual-tree CWT of real ``x`` (..., N) to depth ``level``.

    ``level1``: orthonormal wavelet for the first stage (default Symlet 8;
    tree b runs it one sample late — the half-sample offset after ↓2).
    ``k``/``l``: q-shift design parameters for levels ≥ 2.  N must be
    divisible by 2^level (circular boundary, like the FWT tier).  Jits,
    batches over leading dims, differentiates; roundtrip with
    :func:`idtcwt` is exact (each tree is orthonormal).
    """
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.integer):
        x = x.astype(jnp.float32)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise ValueError("dtcwt expects a real signal")
    n = x.shape[-1]
    if level < 1:
        raise ValueError("level must be >= 1")
    if n % (1 << level):
        raise ValueError(f"N={n} must be divisible by 2^level={1 << level}")
    w1, wa, wb = _tree_params(level1, k, l)
    inv_sqrt2 = 1.0 / math.sqrt(2.0)

    # Both trees ride the FWT tier's FUSED multi-level matmuls where block
    # structure allows (`fwt._analysis_matrix_fused` with a per-level filter
    # SEQUENCE — level 1 is the orthonormal level1 wavelet, deeper levels the
    # q-shift pair), falling back to single steps for small widths.
    from .fwt import _BLK, _analysis_fused_matmul, _seq_fits_analysis

    seq_a = [w1] + [wa] * (level - 1)
    seq_b = [w1] + [wb] * (level - 1)
    la, lb = x, jnp.roll(x, -1, axis=-1)
    highs = []
    idx = 0
    h = n
    while idx < level:
        lf = 1
        if h % _BLK == 0 and max(w.length for w in seq_a[idx:]) <= _BLK:
            for cand in range(min(level - idx, 8), 1, -1):
                if _seq_fits_analysis(tuple(seq_a[idx:idx + cand])):
                    lf = cand
                    break
        if lf > 1:
            la, da = _analysis_fused_matmul(la, tuple(seq_a[idx:idx + lf]))
            lb, db = _analysis_fused_matmul(lb, tuple(seq_b[idx:idx + lf]))
            highs.extend((a + 1j * b) * inv_sqrt2 for a, b in zip(da, db))
            h >>= lf
        else:
            ya = analysis_step(la, seq_a[idx])
            yb = analysis_step(lb, seq_b[idx])
            la, lb = ya[..., :h // 2], yb[..., :h // 2]
            highs.append((ya[..., h // 2:] + 1j * yb[..., h // 2:])
                         * inv_sqrt2)
            h //= 2
        idx += lf
    return DTCWTResult(highpass=tuple(highs), lowpass_a=la, lowpass_b=lb)


class DTCWT2Result(typing.NamedTuple):
    """2D dual-tree coefficients.

    ``highpass``: tuple over levels of COMPLEX (..., 6, H/2^j, W/2^j)
    subbands, type-major: [HL+, HL−, LH+, LH−, HH+, HH−] — each type's
    (z+, z−) pair selects one diagonal-frequency sign (single-quadrant
    support), giving six orientations ≈ {∓15°, ∓75°, ∓45°} off horizontal.
    ``lowpass``: the four trees' real LL_J rows, stacked
    (..., 4, H/2^J, W/2^J) in (aa, ab, ba, bb) order (row tree, col tree).
    Energy: ‖x‖² = ½·Σ‖highpass‖² + ¼·‖lowpass‖².
    """

    highpass: tuple
    lowpass: jax.Array

    @property
    def magnitudes(self):
        return tuple(jnp.abs(w) for w in self.highpass)


def _step2(x, wrow, wcol, roll_row=False, roll_col=False):
    """One separable analysis level: (..., H, W) → (LL, LH, HL, HH).

    ``roll_*``: the level-1 tree-b one-sample offset on that axis.
    Band letters are (row filter, col filter); rows = axis −2.
    """
    if roll_col:
        x = jnp.roll(x, -1, axis=-1)
    y = analysis_step(x, wcol)                     # filter the col axis
    w = y.shape[-1] // 2
    lo_c, hi_c = y[..., :w], y[..., w:]
    if roll_row:
        lo_c = jnp.roll(lo_c, -1, axis=-2)
        hi_c = jnp.roll(hi_c, -1, axis=-2)
    ylo = jnp.swapaxes(analysis_step(jnp.swapaxes(lo_c, -1, -2), wrow),
                       -1, -2)
    yhi = jnp.swapaxes(analysis_step(jnp.swapaxes(hi_c, -1, -2), wrow),
                       -1, -2)
    h = ylo.shape[-2] // 2
    return (ylo[..., :h, :], ylo[..., h:, :],
            yhi[..., :h, :], yhi[..., h:, :])     # LL, HL, LH, HH


def _istep2(ll, hl, lh, hh, wrow, wcol, roll_row=False, roll_col=False):
    """Adjoint of :func:`_step2`."""
    ylo = jnp.concatenate([ll, hl], axis=-2)
    yhi = jnp.concatenate([lh, hh], axis=-2)
    lo_c = jnp.swapaxes(synthesis_step(jnp.swapaxes(ylo, -1, -2), wrow),
                        -1, -2)
    hi_c = jnp.swapaxes(synthesis_step(jnp.swapaxes(yhi, -1, -2), wrow),
                        -1, -2)
    if roll_row:
        lo_c = jnp.roll(lo_c, 1, axis=-2)
        hi_c = jnp.roll(hi_c, 1, axis=-2)
    x = synthesis_step(jnp.concatenate([lo_c, hi_c], axis=-1), wcol)
    if roll_col:
        x = jnp.roll(x, 1, axis=-1)
    return x


def _combine6(bands):
    """Four trees' (HL, LH, HH) → six oriented complex subbands.

    ``bands[(u, v)]`` = (HL, LH, HH) of row-tree u, col-tree v.  For each
    type the (aa, bb) pair forms the real part and (ba, ab) the imaginary
    part of two conjugate-orientation bands (Kingsbury's sum/difference):
    z± = ((aa ∓ bb) + i(ba ± ab))/2 — each selecting one sign of the
    diagonal frequency, hence single-quadrant support.
    """
    out = []
    for t in range(3):
        p, s = bands[("a", "a")][t], bands[("b", "b")][t]
        r, q = bands[("b", "a")][t], bands[("a", "b")][t]
        out.append(((p - s) + 1j * (r + q)) * 0.5)
        out.append(((p + s) + 1j * (r - q)) * 0.5)
    # order: [HL+, HL-, LH+, LH-, HH+, HH-] → orientations; regroup below
    return out


def _split6(z6):
    """Adjoint of :func:`_combine6`: six complex bands → four trees."""
    bands = {k: [] for k in (("a", "a"), ("a", "b"), ("b", "a"), ("b", "b"))}
    for t in range(3):
        z1, z2 = z6[2 * t], z6[2 * t + 1]
        bands[("a", "a")].append(jnp.real(z1) + jnp.real(z2))
        bands[("b", "b")].append(jnp.real(z2) - jnp.real(z1))
        bands[("b", "a")].append(jnp.imag(z1) + jnp.imag(z2))
        bands[("a", "b")].append(jnp.imag(z1) - jnp.imag(z2))
    return bands


_TREES = (("a", "a"), ("a", "b"), ("b", "a"), ("b", "b"))


def dtcwt2(x: jax.Array, level: int, level1: DiscreteWavelet | None = None,
           k: int = 4, l: int = 3) -> DTCWT2Result:
    """2D dual-tree CWT of a real image (..., H, W): six oriented,
    near-analytic complex subbands per level at 4× redundancy.

    Four separable wavelet trees (row tree × col tree ∈ {a, b}²) run
    through the FWT step matmuls; per level the four (HL, LH, HH)
    triplets combine into six single-quadrant complex subbands whose
    magnitudes are near shift-invariant AND orientation-selective —
    the standard texture/registration front end.  H, W divisible by
    2^level; exact PR via :func:`idtcwt2`.
    """
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.integer):
        x = x.astype(jnp.float32)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise ValueError("dtcwt2 expects a real image")
    if x.ndim < 2:
        raise ValueError("dtcwt2 needs at least a (H, W) image")
    h, w = x.shape[-2], x.shape[-1]
    if level < 1:
        raise ValueError("level must be >= 1")
    if h % (1 << level) or w % (1 << level):
        raise ValueError(
            f"H={h}, W={w} must be divisible by 2^level={1 << level}")
    w1, wa, wb = _tree_params(level1, k, l)
    by_tree = {"a": wa, "b": wb}

    lows = {t: x for t in _TREES}
    highs = []
    for j in range(1, level + 1):
        bands = {}
        for (u, v) in _TREES:
            if j == 1:
                ll, hl, lh, hh = _step2(lows[(u, v)], w1, w1,
                                        roll_row=(u == "b"),
                                        roll_col=(v == "b"))
            else:
                ll, hl, lh, hh = _step2(lows[(u, v)], by_tree[u], by_tree[v])
            lows[(u, v)] = ll
            bands[(u, v)] = (hl, lh, hh)
        highs.append(jnp.stack(_combine6(bands), axis=-3))
    return DTCWT2Result(highpass=tuple(highs),
                        lowpass=jnp.stack([lows[t] for t in _TREES],
                                          axis=-3))


def idtcwt2(res: DTCWT2Result, level1: DiscreteWavelet | None = None,
            k: int = 4, l: int = 3) -> jax.Array:
    """Inverse 2D dual-tree CWT — exact (average of the four trees)."""
    w1, wa, wb = _tree_params(level1, k, l)
    by_tree = {"a": wa, "b": wb}
    lows = {t: res.lowpass[..., i, :, :] for i, t in enumerate(_TREES)}
    level = len(res.highpass)
    for j in range(level, 0, -1):
        z6 = [res.highpass[j - 1][..., i, :, :] for i in range(6)]
        bands = _split6(z6)
        for (u, v) in _TREES:
            hl, lh, hh = bands[(u, v)]
            if j == 1:
                lows[(u, v)] = _istep2(lows[(u, v)], hl, lh, hh, w1, w1,
                                       roll_row=(u == "b"),
                                       roll_col=(v == "b"))
            else:
                lows[(u, v)] = _istep2(lows[(u, v)], hl, lh, hh,
                                       by_tree[u], by_tree[v])
    return 0.25 * sum(lows.values())


def idtcwt(res: DTCWTResult, level1: DiscreteWavelet | None = None,
           k: int = 4, l: int = 3) -> jax.Array:
    """Inverse DTCWT: exact reconstruction (average of the two trees).

    Pass the same ``level1``/``k``/``l`` as the forward.  Real/imaginary
    parts of each complex subband re-scale by √2 back into the per-tree
    coefficients; each orthonormal tree inverts exactly, and averaging the
    two reconstructions keeps the inverse exact for any coefficient
    modification that treats the trees symmetrically (e.g. magnitude
    shrinkage of w).
    """
    from .fwt import _BLK, _seq_fits_synthesis, _synthesis_fused_matmul

    w1, wa, wb = _tree_params(level1, k, l)
    sqrt2 = math.sqrt(2.0)
    level = len(res.highpass)
    seq_a = [w1] + [wa] * (level - 1)
    seq_b = [w1] + [wb] * (level - 1)
    la, lb = res.lowpass_a, res.lowpass_b
    j = level  # deepest remaining synthesis step
    while j >= 1:
        lf = 1
        if max(w.length for w in seq_a[:j]) <= _BLK:
            for cand in range(min(j, 8), 1, -1):
                out_w = res.highpass[j - cand].shape[-1] * 2
                if (out_w % _BLK == 0
                        and _seq_fits_synthesis(tuple(seq_a[j - cand:j]))):
                    lf = cand
                    break
        if lf > 1:
            segs = res.highpass[j - lf:j][::-1]  # deepest first
            la = _synthesis_fused_matmul(
                la, [sqrt2 * jnp.real(w) for w in segs],
                tuple(seq_a[j - lf:j]))
            lb = _synthesis_fused_matmul(
                lb, [sqrt2 * jnp.imag(w) for w in segs],
                tuple(seq_b[j - lf:j]))
        else:
            w = res.highpass[j - 1]
            ha, hb = sqrt2 * jnp.real(w), sqrt2 * jnp.imag(w)
            la = synthesis_step(jnp.concatenate([la, ha], axis=-1),
                                seq_a[j - 1])
            lb = synthesis_step(jnp.concatenate([lb, hb], axis=-1),
                                seq_b[j - 1])
        j -= lf
    return 0.5 * (la + jnp.roll(lb, 1, axis=-1))


def _shrink_magnitude(w: jax.Array, t, mode: str) -> jax.Array:
    """Shrink |w| keeping the phase — the complex analog of soft/hard
    thresholding; phase preservation is why dual-tree denoising avoids the
    FWT's shift-dependent artifacts."""
    mag = jnp.abs(w)
    if mode == "soft":
        new = jnp.maximum(mag - t, 0.0)
    elif mode == "hard":
        new = jnp.where(mag > t, mag, 0.0)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return w * (new / jnp.maximum(mag, jnp.finfo(mag.dtype).tiny))


def _universal_complex_threshold(w1: jax.Array, n: int, axes) -> jax.Array:
    """σ·√(2·ln N) with σ from the MAD of the tree-a level-1 details
    (√2·Re w — an orthonormal tree passes input noise through at unit
    gain)."""
    d = math.sqrt(2.0) * jnp.real(w1)
    med = jnp.median(d, axis=axes, keepdims=True)
    sigma = jnp.median(jnp.abs(d - med), axis=axes, keepdims=True) / 0.6745
    return sigma * math.sqrt(2.0 * math.log(n))


def dtcwt_denoise(x: jax.Array, level: int, mode: str = "soft",
                  threshold=None, level1: DiscreteWavelet | None = None,
                  k: int = 4, l: int = 3) -> jax.Array:
    """Denoise by dual-tree magnitude shrinkage — near shift-invariant at
    2× redundancy (vs the MODWT pipeline's (J+1)×; vs the FWT pipeline's
    shift-dependent artifacts).

    ``threshold`` defaults to the universal threshold from the level-1
    complex band (σ via MAD of the tree-a details); pass an array to
    override.  Magnitudes shrink, phases are preserved, and the exact
    inverse averages the two trees.
    """
    r = dtcwt(x, level, level1, k, l)
    if threshold is None:
        threshold = _universal_complex_threshold(
            r.highpass[0], x.shape[-1], axes=-1)
    highs = tuple(_shrink_magnitude(h, threshold, mode) for h in r.highpass)
    return idtcwt(DTCWTResult(highs, r.lowpass_a, r.lowpass_b), level1, k, l)


def dtcwt2_denoise(x: jax.Array, level: int, mode: str = "soft",
                   threshold=None, level1: DiscreteWavelet | None = None,
                   k: int = 4, l: int = 3) -> jax.Array:
    """2D dual-tree denoising: magnitude shrinkage over the six oriented
    complex subbands (σ from the finest level's HH⁺ band MAD)."""
    r = dtcwt2(x, level, level1, k, l)
    if threshold is None:
        n = x.shape[-2] * x.shape[-1]
        threshold = _universal_complex_threshold(
            r.highpass[0][..., 4, :, :], n, axes=(-2, -1))[..., None, :, :]
    highs = tuple(_shrink_magnitude(h, threshold, mode) for h in r.highpass)
    return idtcwt2(DTCWT2Result(highs, r.lowpass), level1, k, l)
