"""Pruned-band CWT: per-scale spectral support + factorized zoom-iDFT matmuls.

The XLA FFT path computes, per scale,
a full-length product and a full-length inverse FFT even though the
multiplier M_s(ω) = conj(√a·ψ̂(a·ω)) is ~zero outside a band of width
O(P/a) (Gaussian/polynomial ψ̂ decay): at 64 log scales most rows are
>90% zeros, and XLA's FFT is a fusion boundary.

Each coefficient row is computed from ONLY its band:

    c_s[n] = e^{2πi·o_s·n/P} · Σ_{b<B_s} Y_s[b] · e^{2πi·b·n/P},
    Y_s[b] = X⁺[o_s+b] · mult_s[b]

with the band sum as a two-stage factorized DFT in matmuls
(b = 128·b₂ + b₁;  n = q·T + m,  T = P/128):

    G_s[b₁, m] = Σ_{b₂} Y_s[128·b₂+b₁] · e^{2πi·b₂·m/T}      (tiny: B₂ ≤ 17)
    H_s[b₁, m] = G_s · e^{2πi·b₁·m/P} · e^{2πi·o_s·m/P}      (carrier m-part
                                                              folded in)
    z_s[m, q]  = Σ_{b₁} H_s[b₁, m] · e^{2πi·b₁·q/128}        (ONE batched
                                                              128-contraction
                                                              for ALL scales)
    c_s[qT+m]  = z_s[m, q] · e^{2πi·o_s·q·T/P}               (tiny (S, Q)
                                                              q-part)

so the per-row cost is N·128 + B_s·T MACs — essentially independent of
band width — instead of a full-length irfft.  Design notes:

  * per-scale STATIC SLICES of the rfft, not a gather;
  * all groups merge after stage 1 — H is (S, 128, T) regardless of band
    width, so stage 2, the carrier q-part and the (T, Q) interleave run
    ONCE for all 64 scales;
  * complex einsums via 3-multiply Karatsuba with explicit precision
    (an f32 einsum may otherwise run at reduced precision: TF32 on a GPU);
  * the carrier's m-part folds into the per-scale twiddle constant, the
    q-part is a (S, Q) broadcast — no (S, N) complex carrier pass.

Constants (band offsets, folded multipliers, twiddles) are host-side
numpy, planned once per (wavelet, scale grid, P, fs) and baked into the
jit (the CWT analog of the MODWT filter cache).

Wavelet regimes, detected from ψ̂ on the host:
  * analytic (Morlet, Paul): max|ψ̂(ω<0)| ≤ ε·peak → one-sided complex sum,
    one row per scale, weights 1/P;
  * real-even ψ̂ (Mexican Hat, even DOG): coefficients are real — one row
    per scale (half-spectrum A multiplier, weights 2/P, DC/Nyquist 1/P),
    c = Re(·);
  * general (odd DOG, Meyer's tiny asymmetry): two rows per scale (A and
    B), c = Re(row_A) + i·Re(row_B).

Parity: identical math to ``ops/cwt.py``'s half-spectrum path up to the
ε = 1e-8 relative band truncation; tests pin f64-CPU agreement at ~1e-9.
On an H100 the irfft path measured faster at the benchmark's shapes, so
:func:`..ops.cwt.cwt` reaches this path only through ``method='banded'``.  Reference semantics: the ψ̂ conj-multiply
loop of ``ContinuousWaveletTransform.java:183-229`` — the band structure
exists because that multiplier decays; the reference never exploits it.
"""
from __future__ import annotations

import functools
import math

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..wavelets.continuous import ContinuousWavelet

__all__ = ["cwt_banded_coefficients", "cwt_banded_wd", "banded_supported",
           "band_plan"]

_EPS = 1e-8          # relative ψ̂ truncation threshold
_B1 = 128            # stage-2 contraction size


def banded_supported(padded_n: int, n_out: int) -> bool:
    """Shape guard: needs P a multiple of 128 with T = P/128 ≥ 4."""
    return padded_n % _B1 == 0 and padded_n // _B1 >= 4 and n_out >= 1


class _Group:
    """Scales sharing one padded band width (b2 = width/128 blocks)."""

    __slots__ = ("offsets", "b2", "mult", "twc")

    def __init__(self, offsets, b2, mult, twc):
        self.offsets = offsets   # (Sg,) python ints — static slice starts
        self.b2 = b2             # band width in 128-blocks
        self.mult = mult         # (Sg, b2·128) complex128 folded multiplier
        self.twc = twc           # (Sg, 128, T) complex128 twiddle·carrier_m


@functools.lru_cache(maxsize=128)
def band_plan(wavelet: ContinuousWavelet, scales_t: tuple, padded_n: int,
              sampling_rate: float, n_out: int, eps: float = _EPS,
              derivative: bool = False):
    """Static plan: (mode, row_groups, inv_perm, e1, carr_q, t, q).

    ``row_groups``: one list of _Group per output row set (1 for
    analytic/real, 2 for general).  Scale order within the concatenated
    groups is restored by ``inv_perm``.  Widths are padded to
    128·{1,2,4,…} — bands widen symmetrically into the padding with their
    true (tiny) multiplier values, so padding adds accuracy, not error.
    """
    scales = np.asarray(scales_t, dtype=np.float64)
    s_count = scales.shape[0]
    p = padded_n
    f = p // 2 + 1
    t_dim = p // _B1
    omega = (2.0 * math.pi * np.arange(f) * sampling_rate / p)[None, :]
    with jax.ensure_compile_time_eval(), \
            jax.default_device(jax.local_devices(backend="cpu")[0]):
        m_pos = np.asarray(jnp.conj(wavelet.psi_hat_scaled(
            jnp.asarray(omega), jnp.asarray(scales[:, None]))))
        psi_neg = np.asarray(wavelet.psi_hat_scaled(
            jnp.asarray(-omega), jnp.asarray(scales[:, None])))

    peak = max(float(np.max(np.abs(m_pos))), float(np.max(np.abs(psi_neg))),
               1e-300)
    # Analytic when the negative-frequency tail is below the band-truncation
    # budget (Morlet's tail is ~3e-9·peak — "analytic" at any ε ≥ 1e-8).
    if np.max(np.abs(psi_neg[:, 1:])) <= eps * peak:
        mode = "analytic"
        mults = [m_pos / p]
    else:
        a_mult = 0.5 * (m_pos + psi_neg)            # conj-folded halves
        b_mult = -0.5j * (m_pos - psi_neg)
        a_mult[:, 0] = np.real(m_pos[:, 0])
        b_mult[:, 0] = np.imag(m_pos[:, 0])
        if p % 2 == 0:
            a_mult[:, -1] = np.real(m_pos[:, -1])
            b_mult[:, -1] = np.imag(m_pos[:, -1])
        w_half = np.full(f, 2.0 / p)
        w_half[0] = 1.0 / p
        if p % 2 == 0:
            w_half[-1] = 1.0 / p
        if np.max(np.abs(b_mult)) <= 1e-14 * peak:
            mode = "real"
            mults = [a_mult * w_half]
        else:
            mode = "general"
            mults = [a_mult * w_half, b_mult * w_half]

    if derivative:
        # ∂_t rows: multiplier iω·M shares M's band support (the extra ω
        # factor cannot widen a Gaussian/polynomial-decay band beyond ε);
        # the Nyquist bin is zeroed — iω there breaks the real-output
        # symmetry (see ops/ssq.py:_ssq_multipliers).
        iw = 1j * (2.0 * math.pi * np.arange(f) * sampling_rate / p)
        deriv = [mu * iw for mu in mults]
        if p % 2 == 0:
            for d in deriv:
                d[:, -1] = 0.0
        mults = mults + deriv

    support = np.zeros((s_count, f))
    for mu in mults:
        support = np.maximum(support, np.abs(mu))

    by_width: dict[int, list] = {}
    for s in range(s_count):
        row = support[s]
        thr = eps * max(float(row.max()), 1e-300)
        nz = np.nonzero(row > thr)[0]
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 1)
        width = hi - lo
        b2 = 1
        while b2 * _B1 < width:
            b2 *= 2
        b2 = min(b2, -(-f // _B1))
        bw = b2 * _B1
        lo = max(0, min(lo - (bw - width) // 2, f - bw)) if f >= bw else 0
        by_width.setdefault(b2, []).append((s, lo))

    m_axis = np.arange(t_dim)
    tw = np.exp(2j * np.pi * np.arange(_B1)[:, None] * m_axis[None, :] / p)
    # Descending width order: band width is non-increasing along an
    # ascending scale grid, so group concatenation then lands in the
    # caller's scale order and the inv_perm take is skipped entirely.
    width_order = sorted(by_width, reverse=True)
    perm = [s for b2 in width_order for s, _ in by_width[b2]]
    inv_perm = np.argsort(np.asarray(perm, dtype=np.int64))

    row_groups = []
    for mu in mults:
        groups = []
        for b2 in width_order:
            entries = by_width[b2]
            bw = b2 * _B1
            sg = len(entries)
            mult = np.zeros((sg, bw), dtype=np.complex128)
            twc = np.zeros((sg, _B1, t_dim), dtype=np.complex128)
            for i, (s, lo) in enumerate(entries):
                hi = min(lo + bw, f)
                mult[i, :hi - lo] = mu[s, lo:hi]
                twc[i] = tw * np.exp(2j * np.pi * lo * m_axis / p)[None, :]
            groups.append(_Group(tuple(lo for _, lo in entries), b2,
                                 mult, twc))
        row_groups.append(groups)

    q_dim = -(-n_out // t_dim)
    e1 = np.exp(2j * np.pi * np.arange(_B1)[:, None]
                * np.arange(q_dim)[None, :] / _B1)
    # carrier q-part e^{2πi·o_s·q·T/P} = e^{2πi·o_s·q/128}, per group
    carr_qs = tuple(
        np.exp(2j * np.pi
               * np.asarray([lo for _, lo in by_width[b2]],
                            dtype=np.float64)[:, None]
               * np.arange(q_dim)[None, :] / _B1)
        for b2 in width_order)
    return mode, tuple(tuple(g) for g in row_groups), inv_perm, e1, \
        carr_qs, t_dim, q_dim


# ---------------------------------------------------------------------------
# Trace-time evaluation
# ---------------------------------------------------------------------------

def _kara_einsum(spec, ar, ai, br, bi, bsum, precision):
    """Complex einsum, 3 real einsums (Karatsuba; bsum = br+bi precomputed)."""
    kw = dict(preferred_element_type=ar.dtype, precision=precision)
    p1 = jnp.einsum(spec, ar, br, **kw)
    p2 = jnp.einsum(spec, ai, bi, **kw)
    p3 = jnp.einsum(spec, ar + ai, bsum, **kw)
    return p1 - p2, p3 - p1 - p2


def _group_stage1(xr, xi, grp, rdt, precision):
    """Slices → banded Y → twiddled H (…, Sg, 128, T) for one group."""
    bw = grp.b2 * _B1
    gr = jnp.stack([lax.slice_in_dim(xr, o, o + bw, axis=-1)
                    for o in grp.offsets], axis=-2)
    gi = jnp.stack([lax.slice_in_dim(xi, o, o + bw, axis=-1)
                    for o in grp.offsets], axis=-2)
    mr = jnp.asarray(grp.mult.real, rdt)
    mi = jnp.asarray(grp.mult.imag, rdt)
    yr = gr * mr - gi * mi
    yi = gr * mi + gi * mr
    lead = yr.shape[:-1]
    if grp.b2 == 1:
        gr2, gi2 = yr[..., None], yi[..., None]       # (…, Sg, 128, 1)
    else:
        yr = yr.reshape(lead + (grp.b2, _B1))
        yi = yi.reshape(lead + (grp.b2, _B1))
        t_dim = grp.twc.shape[-1]
        e2 = np.exp(2j * np.pi * np.arange(grp.b2)[:, None]
                    * np.arange(t_dim)[None, :] / t_dim)
        gr2, gi2 = _kara_einsum("...bk,bm->...km", yr, yi,
                                jnp.asarray(e2.real, rdt),
                                jnp.asarray(e2.imag, rdt),
                                jnp.asarray(e2.real + e2.imag, rdt),
                                precision)
    twr = jnp.asarray(grp.twc.real, rdt)
    twi = jnp.asarray(grp.twc.imag, rdt)
    return gr2 * twr - gi2 * twi, gr2 * twi + gi2 * twr


def _rows_to_z(hr, hi, e1, carr_q, t_dim, q_dim, n_out, rdt, precision):
    """(…, S, 128, T) H rows → (…, S, n_out) z (split parts).

    The einsum emits (…, q, m) directly — n = q·T + m is then a plain
    reshape, with the transpose absorbed into the matmul's output layout
    instead of a separate relayout pass.
    """
    e1r = jnp.asarray(e1.real, rdt)
    e1i = jnp.asarray(e1.imag, rdt)
    e1s = jnp.asarray(e1.real + e1.imag, rdt)
    zr, zi = _kara_einsum("...km,kq->...qm", hr, hi, e1r, e1i, e1s,
                          precision)
    cqr = jnp.asarray(carr_q.real, rdt)[:, :, None]   # (S, Q, 1)
    cqi = jnp.asarray(carr_q.imag, rdt)[:, :, None]
    zr, zi = zr * cqr - zi * cqi, zr * cqi + zi * cqr
    lead = zr.shape[:-2]
    zr = zr.reshape(lead + (q_dim * t_dim,))[..., :n_out]
    zi = zi.reshape(lead + (q_dim * t_dim,))[..., :n_out]
    return zr, zi


def _run_plan(xh, plan, n_out, precision):
    """Evaluate every row set of a plan → list of (zr, zi) in caller order."""
    mode, row_groups, inv_perm, e1, carr_qs, t_dim, q_dim = plan
    rdt = jnp.float64 if xh.dtype == jnp.complex128 else jnp.float32
    xr, xi = jnp.real(xh).astype(rdt), jnp.imag(xh).astype(rdt)
    # The widest band window is 128-padded past F = P/2+1; zero-pad the
    # half-spectrum once so every slice stays in range (the folded
    # multipliers are zero on the padding bins).
    f = xh.shape[-1]
    f_pad = max(max(g.offsets) + g.b2 * _B1 - f
                for gs in row_groups for g in gs)
    if f_pad > 0:
        zeros = jnp.zeros(xr.shape[:-1] + (f_pad,), rdt)
        xr = jnp.concatenate([xr, zeros], axis=-1)
        xi = jnp.concatenate([xi, zeros], axis=-1)
    identity = np.array_equal(inv_perm, np.arange(inv_perm.shape[0]))

    def run_rows(groups):
        # Per-group stage 2: the group z outputs concatenate straight into
        # the final (S, N) buffer (XLA aliases einsum outputs into concat
        # slices) — no intermediate (S, 128, T) concat pass.
        zrs, zis = [], []
        for g, cq in zip(groups, carr_qs):
            hr, hi = _group_stage1(xr, xi, g, rdt, precision)
            zr, zi = _rows_to_z(hr, hi, e1, cq, t_dim, q_dim, n_out, rdt,
                                precision)
            zrs.append(zr)
            zis.append(zi)
        zr = zrs[0] if len(zrs) == 1 else jnp.concatenate(zrs, axis=-2)
        zi = zis[0] if len(zis) == 1 else jnp.concatenate(zis, axis=-2)
        if not identity:
            ip = jnp.asarray(inv_perm)
            zr = jnp.take(zr, ip, axis=-2)
            zi = jnp.take(zi, ip, axis=-2)
        return zr, zi

    return [run_rows(gs) for gs in row_groups]


def _combine(mode, zs):
    """Row-set results → coefficient array per the wavelet regime."""
    if mode == "analytic":
        return lax.complex(*zs[0])
    if mode == "real":
        return zs[0][0]
    return lax.complex(zs[0][0], zs[1][0])


def cwt_banded_coefficients(xh: jax.Array, n_out: int, scales_np: np.ndarray,
                            wavelet: ContinuousWavelet, sampling_rate: float,
                            padded_n: int,
                            precision=lax.Precision.HIGHEST) -> jax.Array:
    """Coefficients (..., S, n_out) from the rfft half-spectrum ``xh``.

    ``xh``: (..., P/2+1) complex rfft of the padded real signal.  Output is
    complex (analytic/general ψ̂) or real (real-even ψ̂ — same convention as
    the unpruned path in :func:`ops.cwt.cwt`).
    """
    plan = band_plan(wavelet, tuple(float(s) for s in scales_np), padded_n,
                     float(sampling_rate), int(n_out))
    zs = _run_plan(xh, plan, int(n_out), precision)
    return _combine(plan[0], zs)


def cwt_banded_wd(xh: jax.Array, n_out: int, scales_np: np.ndarray,
                  wavelet: ContinuousWavelet, sampling_rate: float,
                  padded_n: int, precision=lax.Precision.HIGHEST):
    """(W, ∂_t W) pair from one shared plan — the synchrosqueezing front end.

    The derivative rows use the multiplier iω·M, which shares M's band
    support, so band slices, twiddles and the stage-2 structure are reused;
    vs four independent irffts this is the same ~4–6× win the plain banded
    CWT measures (see ops/ssq.py).
    """
    plan = band_plan(wavelet, tuple(float(s) for s in scales_np), padded_n,
                     float(sampling_rate), int(n_out), derivative=True)
    mode, row_groups = plan[0], plan[1]
    zs = _run_plan(xh, plan, int(n_out), precision)
    base = len(row_groups) // 2
    w = _combine(mode, zs[:base])
    dw = _combine(mode, zs[base:])
    if mode == "real":
        # real-ψ̂ W is real; callers expect complex W for phase transforms —
        # promote with zero imaginary part (degenerate SSQ case, kept for
        # API uniformity).
        w = w.astype(jnp.complex128 if w.dtype == jnp.float64
                     else jnp.complex64)
        dw = dw.astype(w.dtype)
    return w, dw
