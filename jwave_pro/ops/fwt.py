"""Fast Wavelet Transform (Mallat pyramid).

The reference's per-level step is a scalar double loop with circular indexing
``k = (2i + j) mod h`` (``jwave/transforms/wavelets/Wavelet.java:236-303``) and
the pyramid runs that step on a shrinking prefix
(``jwave/transforms/FastWaveletTransform.java:71-153``).  Here each level is
ONE batched op over all leading axes — the 2D/3D separable loops of
``BasicTransform.java:361-659`` and the row/column fork-join of
``ParallelTransform.java`` collapse into it.  Two formulations, picked by
width:

  * width ≥ 256: a block-pair matmul — the stride-2 downsample and the
    filter taps are absorbed into a banded ``(512, 256)`` constant, so
    there are no strided slices at all (the matmul form against a
    polyphase form is not yet measured on the H100; PERF.md);
  * small/odd widths: an even/odd polyphase roll+FMA form.

Level loops are unrolled in Python: shapes halve every level (≤ ~30 levels),
so everything under ``jit`` stays static-shaped.

Coefficient layout matches the reference: ``[approx | detail]`` halves
recursively on the prefix of the array.
"""
from __future__ import annotations

import functools as _functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..wavelets.base import DiscreteWavelet
from ..utils.validation import check_power_of_two

__all__ = [
    "fwt", "ifwt", "fwt2", "ifwt2", "fwt3", "ifwt3",
    "analysis_step", "synthesis_step", "decompose", "recompose",
]


def _filters(wavelet: DiscreteWavelet, dtype):
    return (jnp.asarray(f, dtype=dtype) for f in
            (wavelet.dec_lo, wavelet.dec_hi, wavelet.rec_lo, wavelet.rec_hi))


_BLK = 256  # input block width for the matmul step (outputs 128 lo + 128 hi)


@_functools.lru_cache(maxsize=None)
def _analysis_matrix(wavelet: DiscreteWavelet, dtype_name: str):
    """(2·BLK, BLK) banded constant: block-pair inputs → [lo(128) | hi(128)].

    Column v<128: lo_i with i = 128·a + v ⇒ rows 2v+j weight dec_lo[j];
    column v≥128: hi likewise.  The stride-2 downsample is absorbed into the
    matrix so the step is one large batched matmul with no strided
    slices.
    """
    m = wavelet.length
    w = np.zeros((2 * _BLK, _BLK), dtype=np.float64)
    for v in range(128):
        for j in range(m):
            w[(2 * v + j) % (2 * _BLK), v] += wavelet.dec_lo[j]
            w[(2 * v + j) % (2 * _BLK), 128 + v] += wavelet.dec_hi[j]
    # cache HOST numpy (a jnp array created inside a trace would leak the
    # tracer into later traces through the lru_cache)
    return np.asarray(w, dtype=dtype_name)


def _composite_bank(wavelets: tuple):
    """Host-f64 composite filters for stacked analysis steps, one wavelet
    per level (a uniform pyramid passes ``(w,)*L``; the dual-tree passes
    ``(level1, qshift, qshift, …)``).

    ``C_j = C_{j-1} ⊛ (dec_lo_j ↑ 2^{j-1})`` (scaling chain), detail taps
    ``E_j = C_{j-1} ⊛ (dec_hi_j ↑ 2^{j-1})`` — so ``hi_j[p] = Σ_s E_j[s] ·
    x[(2^j·p + s) mod h]`` exactly equals j recursive steps (the à-trous
    composition; spans grow as Σ_j 2^{j−1}(M_j−1)).
    """
    def up(f, d):
        out = np.zeros((len(f) - 1) * d + 1)
        out[::d] = f
        return out

    c = np.ones(1)
    details = []
    for j, w in enumerate(wavelets, start=1):
        lo = np.asarray(w.dec_lo, dtype=np.float64)
        hi = np.asarray(w.dec_hi, dtype=np.float64)
        details.append(np.convolve(c, up(hi, 1 << (j - 1))))
        c = np.convolve(c, up(lo, 1 << (j - 1)))
    return c, details


def _fused_levels_limit(wavelet: DiscreteWavelet) -> int:
    """Max L with every composite row index inside the block pair:
    worst output (p = BLK/2^j − 1) touches row BLK − 2^j + (2^j−1)(M−1),
    which must stay < 2·BLK."""
    m = wavelet.length
    lmax = 0
    for lev in range(1, 9):
        if _BLK - (1 << lev) + ((1 << lev) - 1) * (m - 1) < 2 * _BLK:
            lmax = lev
        else:
            break
    return lmax


def _seq_fits_analysis(wavelets: tuple) -> bool:
    """Block-pair fit test for a mixed filter sequence: span =
    Σ_j 2^{j−1}(M_j−1); worst row BLK − 2^L + span must stay < 2·BLK."""
    lev = len(wavelets)
    if lev > 8:
        return False
    span = sum((1 << (j - 1)) * (w.length - 1)
               for j, w in enumerate(wavelets, start=1))
    return _BLK - (1 << lev) + span < 2 * _BLK


@_functools.lru_cache(maxsize=None)
def _analysis_matrix_fused(wavelets: tuple, dtype_name: str):
    """(2·BLK, BLK) banded constant running ``len(wavelets)`` pyramid steps
    in ONE matmul pass.

    Column layout per input block of 256: ``[lo_L (256/2^L) | hi_L | … |
    hi_1 (128)]`` — the per-block slice of the packed pyramid
    ``[a_L | d_L | … | d_1]``, so outputs reshape straight into the final
    layout.  Same matrix shape as the single-level step, so L levels cost
    FEWER FLOPs than L separate passes (512 MACs/output, but only
    (1+2^{1−L})·h/2 outputs instead of h per extra level) and exactly one
    HBM round trip.  Composite taps are composed on the host in f64 —
    parity with the recursive steps is exact to matmul roundoff.
    """
    levels = len(wavelets)
    c, details = _composite_bank(wavelets)
    w = np.zeros((2 * _BLK, _BLK), dtype=np.float64)
    col = 0
    segs = [(levels, c)] + [(j, e) for j, e in
                            zip(range(levels, 0, -1), details[::-1])]
    for j, taps in segs:
        cnt = _BLK >> j
        for p in range(cnt):
            base = (1 << j) * p
            for s, t in enumerate(taps):
                w[base + s, col + p] += t
        col += cnt
    assert col == _BLK
    return np.asarray(w, dtype=dtype_name)


def _analysis_fused_matmul(x: jax.Array, wavelets: tuple):
    """Apply the fused matrix; returns ``(lo_L, [d_1, …, d_L])``."""
    levels = len(wavelets)
    h = x.shape[-1]
    k = h // _BLK
    lead = x.shape[:-1]
    xb = x.reshape(lead + (k, _BLK))
    w = _analysis_matrix_fused(wavelets, jnp.dtype(x.dtype).name)
    w_cur = jnp.asarray(w[:_BLK])
    w_nxt = jnp.asarray(w[_BLK:])
    out = (jnp.einsum("...ku,uv->...kv", xb, w_cur,
                      preferred_element_type=x.dtype,
                      precision=lax.Precision.HIGHEST)
           + jnp.einsum("...ku,uv->...kv", jnp.roll(xb, -1, axis=-2), w_nxt,
                        preferred_element_type=x.dtype,
                        precision=lax.Precision.HIGHEST))
    col = 0
    lo = out[..., :_BLK >> levels].reshape(lead + (h >> levels,))
    col = _BLK >> levels
    details = []  # returned in ascending level order d_1 .. d_L
    for j in range(levels, 0, -1):
        cnt = _BLK >> j
        details.append(
            out[..., col:col + cnt].reshape(lead + (h >> j,)))
        col += cnt
    return lo, details[::-1]


def _composite_rec_bank(wavelets: tuple):
    """Synthesis twin of :func:`_composite_bank` over the REC banks
    (one wavelet per level, like the analysis version).

    ``RC_j = RC_{j-1} ⊛ (rec_lo_j ↑ 2^{j-1})``, ``RE_j = RC_{j-1} ⊛
    (rec_hi_j ↑ 2^{j-1})`` — so the j-level upsample chain contributes
    ``x[k] += RE_j[k − 2^j·p] · hi_j[p]`` exactly like j recursive
    synthesis steps; each passes through steps 1..j, so the Haar-orthogonal
    energy correction enters as ``Π_{i≤j} correction_i`` per segment.
    """
    def up(f, d):
        out = np.zeros((len(f) - 1) * d + 1)
        out[::d] = f
        return out

    c = np.ones(1)
    details = []
    corrections = []
    ec = 1.0
    for j, w in enumerate(wavelets, start=1):
        lo = np.asarray(w.rec_lo, dtype=np.float64)
        hi = np.asarray(w.rec_hi, dtype=np.float64)
        details.append(np.convolve(c, up(hi, 1 << (j - 1))))
        c = np.convolve(c, up(lo, 1 << (j - 1)))
        ec *= float(w.energy_correction)
        corrections.append(ec)
    return c, details, corrections


def _fused_synth_limit(wavelet: DiscreteWavelet) -> int:
    """Max L with the composite rec span inside one previous block:
    (2^L−1)(M−1) ≤ BLK (the (prev, cur) pair covers p_rel ≥ −cnt)."""
    m = wavelet.length
    lmax = 0
    for lev in range(1, 9):
        if ((1 << lev) - 1) * (m - 1) <= _BLK:
            lmax = lev
        else:
            break
    return lmax


def _seq_fits_synthesis(wavelets: tuple) -> bool:
    """(prev, cur) pair fit for a mixed rec sequence: span ≤ BLK."""
    if len(wavelets) > 8:
        return False
    span = sum((1 << (j - 1)) * (w.length - 1)
               for j, w in enumerate(wavelets, start=1))
    return span <= _BLK


@_functools.lru_cache(maxsize=None)
def _synthesis_matrices_fused(wavelets: tuple, dtype_name: str):
    """Per-segment (2·cnt_r, BLK) constants for ``len(wavelets)`` fused
    synthesis steps: list ordered ``[lo(L), hi(L), hi(L−1), …, hi(1)]``
    (deepest first, matching the packed ``[a | d_deep | … | d_1]`` layout).

    Row u ↦ segment entry ``p_rel = u − cnt`` of the (previous, current)
    block pair; column t the output sample; weight ``taps[t − 2^r·p_rel]``
    times the accumulated energy correction of steps 1..r.
    """
    levels = len(wavelets)
    c, details, corrections = _composite_rec_bank(wavelets)
    mats = []
    segs = [(levels, c)] + [(r, e) for r, e in
                            zip(range(levels, 0, -1), details[::-1])]
    for r, taps in segs:
        cnt = _BLK >> r
        mat = np.zeros((2 * cnt, _BLK), dtype=np.float64)
        scale = corrections[r - 1]
        for u in range(2 * cnt):
            p_rel = u - cnt
            base = (1 << r) * p_rel
            for s, tap in enumerate(taps):
                t = base + s
                if 0 <= t < _BLK:
                    mat[u, t] += tap * scale
        mats.append(np.asarray(mat, dtype=dtype_name))
    return mats


@_functools.lru_cache(maxsize=None)
def _synthesis_matrix_fused_packed(wavelets: tuple, dtype_name: str):
    """The per-segment synthesis constants assembled into ONE (2·BLK, BLK)
    pair, row-offset by the packed per-block layout ``[a_L | d_L | … |
    d_1]`` (Σ cnt_r = BLK exactly).

    Why: applying the segments separately is L+1 einsums whose contraction
    dims are the tiny cnt_r = BLK/2^r (8–128), each too shallow to use a
    matmul unit well.  Packing the segments per block makes the inverse
    structurally IDENTICAL to :func:`_analysis_fused_matmul`: one
    (prev‖cur) block pair times a (2·BLK, BLK) constant.
    """
    mats = _synthesis_matrices_fused(wavelets, dtype_name)
    prev = np.zeros((_BLK, _BLK), dtype=dtype_name)
    cur = np.zeros((_BLK, _BLK), dtype=dtype_name)
    off = 0
    for mat in mats:
        cnt = mat.shape[0] // 2
        prev[off:off + cnt] = mat[:cnt]
        cur[off:off + cnt] = mat[cnt:]
        off += cnt
    assert off == _BLK
    return prev, cur


def _synthesis_fused_matmul(lo: jax.Array, segs_desc: list,
                            wavelets: tuple) -> jax.Array:
    """Fused inverse chunk: ``lo`` = deepest approximation, ``segs_desc`` =
    detail segments deepest-first; returns the chunk-top approximation
    (width = 2^len(segs_desc) · lo width).

    The segments are packed per output block (reshape-to-(k, cnt) + one
    concat — a single extra pass over the coefficients) so the whole chunk
    is TWO full-depth matmuls against the packed constant; see
    :func:`_synthesis_matrix_fused_packed` for why the per-segment
    formulation is avoided.
    """
    levels = len(segs_desc)
    h = lo.shape[-1] << levels
    k = h // _BLK
    lead = lo.shape[:-1]
    w_prev, w_cur = _synthesis_matrix_fused_packed(
        wavelets, jnp.dtype(lo.dtype).name)
    pack = jnp.concatenate(
        [seg.reshape(lead + (k, seg.shape[-1] // k))
         for seg in [lo, *segs_desc]], axis=-1)          # (..., k, BLK)
    ein = lambda u, m: jnp.einsum("...ku,uv->...kv", u, m,
                                  preferred_element_type=lo.dtype,
                                  precision=lax.Precision.HIGHEST)
    out = (ein(jnp.roll(pack, 1, axis=-2), jnp.asarray(w_prev))
           + ein(pack, jnp.asarray(w_cur)))
    return out.reshape(lead + (h,))


@_functools.lru_cache(maxsize=None)
def _synthesis_matrices(wavelet: DiscreteWavelet, dtype_name: str):
    """Two (2·BLKH, BLK) constants A, B with x_blk = lo_pair@A + hi_pair@B.

    Row u indexes lo/hi element i = 128·(a−1) + u over the previous+current
    half-blocks; column k the output sample 256·a + k; weight rec_lo/rec_hi
    [k + 256 − 2u] where in range (adjoint of the analysis band structure).
    """
    m = wavelet.length
    a = np.zeros((2 * 128, _BLK), dtype=np.float64)
    b = np.zeros((2 * 128, _BLK), dtype=np.float64)
    for u in range(2 * 128):
        for k in range(_BLK):
            j = k + 256 - 2 * u
            if 0 <= j < m:
                a[u, k] += wavelet.rec_lo[j] * wavelet.energy_correction
                b[u, k] += wavelet.rec_hi[j] * wavelet.energy_correction
    return (np.asarray(a, dtype=dtype_name), np.asarray(b, dtype=dtype_name))


@_functools.lru_cache(maxsize=None)
def _analysis_matrix_small(wavelet: DiscreteWavelet, h: int, dtype_name: str):
    """Full (h, h) circulant-step constant for widths ≤ _BLK.

    ``out = x @ W`` with ``W[(2v+j) mod h, v] += dec_lo[j]`` (columns v <
    h/2) and the high-pass in columns v ≥ h/2 — the whole circular step as
    one small matmul (batch = packets/rows rides the matmul batch
    dimension).
    """
    m = wavelet.length
    w = np.zeros((h, h), dtype=np.float64)
    for v in range(h // 2):
        for j in range(m):
            w[(2 * v + j) % h, v] += wavelet.dec_lo[j]
            w[(2 * v + j) % h, h // 2 + v] += wavelet.dec_hi[j]
    return np.asarray(w, dtype=dtype_name)


@_functools.lru_cache(maxsize=None)
def _synthesis_matrix_small(wavelet: DiscreteWavelet, h: int, dtype_name: str):
    """Full (h, h) adjoint constant: ``x = y @ S`` with
    ``S[i, (2i+j) mod h] += rec_lo[j]`` (rows i < h/2) and rec_hi in rows
    i ≥ h/2, times the energy-correction factor."""
    m = wavelet.length
    s = np.zeros((h, h), dtype=np.float64)
    for i in range(h // 2):
        for j in range(m):
            s[i, (2 * i + j) % h] += wavelet.rec_lo[j]
            s[h // 2 + i, (2 * i + j) % h] += wavelet.rec_hi[j]
    s *= wavelet.energy_correction
    return np.asarray(s, dtype=dtype_name)


def _analysis_step_matmul(x: jax.Array, wavelet: DiscreteWavelet) -> jax.Array:
    h = x.shape[-1]
    k = h // _BLK
    lead = x.shape[:-1]
    xb = x.reshape(lead + (k, _BLK))
    w = _analysis_matrix(wavelet, jnp.dtype(x.dtype).name)
    w_cur = jnp.asarray(w[:_BLK])
    w_nxt = jnp.asarray(w[_BLK:])
    # split matmul instead of materializing a (…, k, 2·BLK) pairs buffer.
    # Precision.HIGHEST: a reduced-precision f32 matmul (TF32 on a GPU)
    # costs ~1e-3 reconstruction error — unacceptable vs the 1e-6 target.
    out = (jnp.einsum("...ku,uv->...kv", xb, w_cur,
                      preferred_element_type=x.dtype,
                      precision=lax.Precision.HIGHEST)
           + jnp.einsum("...ku,uv->...kv", jnp.roll(xb, -1, axis=-2), w_nxt,
                        preferred_element_type=x.dtype,
                        precision=lax.Precision.HIGHEST))
    lo = out[..., :128].reshape(lead + (h // 2,))
    hi = out[..., 128:].reshape(lead + (h // 2,))
    return jnp.concatenate([lo, hi], axis=-1)


def _synthesis_step_matmul(y: jax.Array, wavelet: DiscreteWavelet) -> jax.Array:
    h = y.shape[-1]
    half = h // 2
    k = half // 128
    lead = y.shape[:-1]
    lo = y[..., :half].reshape(lead + (k, 128))
    hi = y[..., half:].reshape(lead + (k, 128))
    a, b = _synthesis_matrices(wavelet, jnp.dtype(y.dtype).name)
    a_prev, a_cur = jnp.asarray(a[:128]), jnp.asarray(a[128:])
    b_prev, b_cur = jnp.asarray(b[:128]), jnp.asarray(b[128:])
    lo_prev = jnp.roll(lo, 1, axis=-2)
    hi_prev = jnp.roll(hi, 1, axis=-2)
    ein = lambda u, m: jnp.einsum("...ku,uv->...kv", u, m,
                                  preferred_element_type=y.dtype,
                                  precision=lax.Precision.HIGHEST)
    out = ein(lo_prev, a_prev) + ein(lo, a_cur) \
        + ein(hi_prev, b_prev) + ein(hi, b_cur)
    return out.reshape(lead + (h,))


def analysis_step(x: jax.Array, wavelet: DiscreteWavelet) -> jax.Array:
    """One filter-bank analysis step on the last axis (length h, even).

    ``out[..., :h/2]`` are scaling coefficients ``lo[i] = Σ_j x[(2i+j) mod h]
    · dec_lo[j]``, ``out[..., h/2:]`` the wavelet coefficients — the batched
    equivalent of ``Wavelet.forward`` (``Wavelet.java:236-260``).

    Dispatch: h divisible by 256 → banded block-pair matmul; even h ≤ 256 →
    full circulant matmul (both without strided slices); otherwise an
    even/odd polyphase roll form (filters longer than the signal wrap
    correctly because ``jnp.roll`` is mod-h/2 ≡ the ``(2i+j) mod h`` wrap).
    """
    h = x.shape[-1]
    m = wavelet.length
    if h % _BLK == 0 and m <= _BLK:
        return _analysis_step_matmul(x, wavelet)
    if h % 2 == 0 and h <= _BLK:
        w = jnp.asarray(_analysis_matrix_small(
            wavelet, h, jnp.dtype(x.dtype).name))
        return jnp.einsum("...u,uv->...v", x, w,
                          preferred_element_type=x.dtype,
                          precision=lax.Precision.HIGHEST)
    g = np.asarray(wavelet.dec_lo, dtype=x.dtype)
    f = np.asarray(wavelet.dec_hi, dtype=x.dtype)
    xe = x[..., 0::2]
    xo = x[..., 1::2]
    lo = hi = None
    for j in range(m):
        ph = xe if j % 2 == 0 else xo
        r = jnp.roll(ph, -(j // 2), axis=-1) if j // 2 else ph
        tl = g[j] * r
        th = f[j] * r
        lo = tl if lo is None else lo + tl
        hi = th if hi is None else hi + th
    return jnp.concatenate([lo, hi], axis=-1)


def synthesis_step(y: jax.Array, wavelet: DiscreteWavelet) -> jax.Array:
    """Adjoint of :func:`analysis_step` using the reconstruction banks.

    ``x[k] = Σ_{i,j: (2i+j)≡k (mod h)} lo[i]·rec_lo[j] + hi[i]·rec_hi[j]``
    — the batched equivalent of ``Wavelet.reverse`` (``Wavelet.java:277-303``),
    including the unnormalized-Haar energy-correction factor
    (``Haar1Orthogonal.java:196-201``).

    Dispatch mirrors :func:`analysis_step` (matmul paths); odd widths
    (reachable via the Shifting WT reverse) fall back to a transposed
    strided convolution with circular fold-back.
    """
    h = y.shape[-1]
    m = wavelet.length
    if h % _BLK == 0 and m <= _BLK:
        return _synthesis_step_matmul(y, wavelet)
    if h % 2 == 0 and h <= _BLK:
        s_mat = jnp.asarray(_synthesis_matrix_small(
            wavelet, h, jnp.dtype(y.dtype).name))
        return jnp.einsum("...u,uv->...v", y, s_mat,
                          preferred_element_type=y.dtype,
                          precision=lax.Precision.HIGHEST)
    if h % 2 == 0:
        # Polyphase adjoint (elementwise): even outputs x_e[p] = Σ_m rl[2m]·
        # roll(lo, m)[p] + rh[2m]·roll(hi, m)[p]; odd outputs likewise with
        # the odd taps; interleave at the end.
        rl = np.asarray(wavelet.rec_lo, dtype=y.dtype)
        rh = np.asarray(wavelet.rec_hi, dtype=y.dtype)
        half = h // 2
        lo = y[..., :half]
        hi = y[..., half:]
        xe = xo = None
        for j in range(m):
            sh = j // 2
            rlo = jnp.roll(lo, sh, axis=-1) if sh else lo
            rhi = jnp.roll(hi, sh, axis=-1) if sh else hi
            t = rl[j] * rlo + rh[j] * rhi
            if j % 2 == 0:
                xe = t if xe is None else xe + t
            else:
                xo = t if xo is None else xo + t
        if xo is None:
            xo = jnp.zeros_like(xe)
        x = jnp.stack([xe, xo], axis=-1).reshape(y.shape[:-1] + (h,))
        if wavelet.energy_correction != 1.0:
            x = x * jnp.asarray(wavelet.energy_correction, dtype=y.dtype)
        return x
    # Odd h — reachable only via the Shifting WT reverse.  The reference
    # reads lo = y[0:h//2], hi = y[h//2:2·(h//2)], ignores the last element,
    # and scatters modulo h (Wavelet.java:277-303 with integer halving).
    _, _, rec_lo, rec_hi = _filters(wavelet, y.dtype)
    lead = y.shape[:-1]
    half = h // 2
    lo = y[..., :half].reshape((-1, 1, half))
    hi = y[..., half:2 * half].reshape((-1, 1, half))
    lhs = jnp.concatenate([lo, hi], axis=1)  # (B, 2, h//2)
    # Transposed strided correlation == lhs-dilated correlation with the
    # flipped kernels and full padding.
    rhs = jnp.stack([rec_lo[::-1], rec_hi[::-1]])[None, :, :]  # (O=1, I=2, M)
    ext = lax.conv_general_dilated(
        lhs, rhs, window_strides=(1,), padding=[(m - 1, m - 1)],
        lhs_dilation=(2,), dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=y.dtype,
    )[:, 0, :]  # (B, 2·(h//2) + m - 2)
    total = ext.shape[-1]
    # Circular fold: x[k] = Σ_r ext[k + r·h]
    if total > h:
        reps = -(-total // h)
        ext = jnp.pad(ext, ((0, 0), (0, reps * h - total)))
        x = ext.reshape((-1, reps, h)).sum(axis=1)
    else:
        x = jnp.pad(ext, ((0, 0), (0, h - total)))
    if wavelet.energy_correction != 1.0:
        x = x * jnp.asarray(wavelet.energy_correction, dtype=y.dtype)
    return x.reshape(lead + (h,))


def _resolve_level(n: int, level, wavelet: DiscreteWavelet) -> int:
    # The reference accepts 0 ≤ level ≤ log2(N) (FastWaveletTransform.java:80-84)
    # and the step loop additionally stops when the prefix width drops below the
    # wavelet's transform_wavelength (":90-97").
    from ..utils.validation import exponent

    maxl = exponent(n)
    if level is None:
        return maxl
    level = int(level)
    if level < 0 or level > maxl:
        raise ValueError(f"level {level} out of range [0, {maxl}] for length {n}")
    return level


def fwt(x: jax.Array, wavelet: DiscreteWavelet, level=None) -> jax.Array:
    """Multi-level forward FWT on the last axis (length must be a power of 2).

    Equivalent to ``FastWaveletTransform.forward(arr, level)``
    (``FastWaveletTransform.java:71-101``).
    """
    x = jnp.asarray(x)
    n = x.shape[-1]
    check_power_of_two(n)
    level = _resolve_level(n, level, wavelet)
    # Accumulate detail segments and concatenate ONCE: a per-level
    # ``concat([head, rest])`` would copy the full N-width array every level
    # (≈ 2·L·N bytes of pure shuffling for an L-level pyramid — this was the
    # round-1 "tail levels are slow" cost, not kernel-launch overhead).
    # Big widths take the FUSED multi-level matmul (`_analysis_matrix_fused`):
    # composite taps fold up to `_fused_levels_limit` pyramid steps into one
    # (512, 256) constant — one HBM round trip (and fewer FLOPs) per chunk of
    # levels instead of one per level.
    h = n
    cur = x
    details = []
    done = 0
    while done < level and h >= wavelet.transform_wavelength and h >= 2:
        lf = 0
        if h % _BLK == 0 and wavelet.length <= _BLK:
            lf = min(_fused_levels_limit(wavelet), level - done)
            # sub-level ℓ of the fused chunk acts on width h >> (ℓ−1);
            # honor the same per-level stopping guard as the step loop
            while lf > 1 and (h >> (lf - 1)) < wavelet.transform_wavelength:
                lf -= 1
        if lf > 1:
            cur, segs = _analysis_fused_matmul(cur, (wavelet,) * lf)
            details.extend(segs)  # ascending level order d_{done+1}…
            h >>= lf
            done += lf
        else:
            out = analysis_step(cur, wavelet)
            cur = out[..., :h // 2]
            details.append(out[..., h // 2:])
            h //= 2
            done += 1
    if not details:
        return x
    # widths always sum to n: [a_L | d_L | d_{L-1} | … | d_1]
    return jnp.concatenate([cur, *reversed(details)], axis=-1)


def ifwt(y: jax.Array, wavelet: DiscreteWavelet, level=None) -> jax.Array:
    """Multi-level inverse FWT (``FastWaveletTransform.reverse``, ``:119-153``)."""
    y = jnp.asarray(y)
    n = y.shape[-1]
    check_power_of_two(n)
    level = _resolve_level(n, level, wavelet)
    # Mirror the forward's width sequence, then synthesize in reverse order
    # (FastWaveletTransform.java:134-148 starts at h = twl << (steps - level)).
    widths = []
    hh = n
    for _ in range(level):
        if hh < wavelet.transform_wavelength or hh < 2:
            break
        widths.append(hh)
        hh //= 2
    if not widths:
        return y
    # Work on the growing prefix only; detail segments are read in place and
    # the final signal assembles without per-level full-N concats (mirror of
    # the forward's single-concat structure).  Chunks of levels whose output
    # width divides the block take the FUSED composite-rec matmul
    # (`_synthesis_matrices_fused`) — one HBM pass per chunk.
    cur = y[..., :widths[-1] // 2]  # a_L
    j = len(widths)  # deepest remaining synthesis step
    while j >= 1:
        lf = 0
        if wavelet.length <= _BLK:
            lf = min(_fused_synth_limit(wavelet), j)
            while lf > 1 and widths[j - lf] % _BLK != 0:
                lf -= 1
        if lf > 1:
            # detail segment of step jj sits at y[n>>jj : n>>(jj−1)]
            segs = [y[..., widths[jj - 1] // 2:widths[jj - 1]]
                    for jj in range(j, j - lf, -1)]
            cur = _synthesis_fused_matmul(cur, segs, (wavelet,) * lf)
            j -= lf
        else:
            h = widths[j - 1]
            head = jnp.concatenate([cur, y[..., h // 2:h]], axis=-1)
            cur = synthesis_step(head, wavelet)
            j -= 1
    return cur


def fwt2(m: jax.Array, wavelet: DiscreteWavelet, level_rows=None,
         level_cols=None) -> jax.Array:
    """2D forward: all rows (last axis), then all columns (second-to-last).

    Matches ``BasicTransform.forward(double[][], lvlM, lvlN)``
    (``BasicTransform.java:361-399``); the reference's per-row loop and the
    fork-join of ``ParallelTransform.java:70-93`` are one batched conv here.
    """
    m = jnp.asarray(m)
    m = fwt(m, wavelet, level_cols)
    m = jnp.swapaxes(fwt(jnp.swapaxes(m, -1, -2), wavelet, level_rows), -1, -2)
    return m


def ifwt2(m: jax.Array, wavelet: DiscreteWavelet, level_rows=None,
          level_cols=None) -> jax.Array:
    """2D inverse: columns first, then rows (``BasicTransform.java:436-474``)."""
    m = jnp.asarray(m)
    m = jnp.swapaxes(ifwt(jnp.swapaxes(m, -1, -2), wavelet, level_rows), -1, -2)
    m = ifwt(m, wavelet, level_cols)
    return m


def fwt3(s: jax.Array, wavelet: DiscreteWavelet, levels=(None, None, None)) -> jax.Array:
    """3D forward over the last three axes (``BasicTransform.java:509-566``)."""
    s = jnp.asarray(s)
    lp, lq, lr = levels
    s = fwt(s, wavelet, lr)                                   # last axis
    s = jnp.swapaxes(fwt(jnp.swapaxes(s, -1, -2), wavelet, lq), -1, -2)
    s = jnp.swapaxes(fwt(jnp.swapaxes(s, -1, -3), wavelet, lp), -1, -3)
    return s


def ifwt3(s: jax.Array, wavelet: DiscreteWavelet, levels=(None, None, None)) -> jax.Array:
    """3D inverse (mirror of :func:`fwt3`, ``BasicTransform.java:602-659``)."""
    s = jnp.asarray(s)
    lp, lq, lr = levels
    s = jnp.swapaxes(ifwt(jnp.swapaxes(s, -1, -3), wavelet, lp), -1, -3)
    s = jnp.swapaxes(ifwt(jnp.swapaxes(s, -1, -2), wavelet, lq), -1, -2)
    s = ifwt(s, wavelet, lr)
    return s


def decompose(x: jax.Array, wavelet: DiscreteWavelet) -> jax.Array:
    """All-level decomposition matrix, shape ``(maxLevel+1, ..., N)``.

    Row 0 is the input signal; row p is the FWT at level p — equivalent to
    ``WaveletTransform.decompose`` (``WaveletTransform.java:136-146``).
    """
    x = jnp.asarray(x)
    n = x.shape[-1]
    check_power_of_two(n)
    from ..utils.validation import exponent

    maxl = exponent(n)
    rows = [x]
    for p in range(1, maxl + 1):
        h = n >> (p - 1)
        prev = rows[-1]
        if h < max(wavelet.transform_wavelength, 2):
            rows.append(prev)
            continue
        head = analysis_step(prev[..., :h], wavelet)
        rows.append(jnp.concatenate([head, prev[..., h:]], axis=-1)
                    if h < n else head)
    return jnp.stack(rows, axis=0)


def recompose(mat: jax.Array, wavelet: DiscreteWavelet, level: int) -> jax.Array:
    """Reconstruct the time signal from row ``level`` of a decompose matrix
    (``WaveletTransform.recompose``, ``WaveletTransform.java:173-182``)."""
    return ifwt(mat[level], wavelet, level)
