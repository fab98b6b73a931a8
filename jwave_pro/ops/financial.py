"""Market-data preprocessing for wavelet analysis.

The reference's ``docs/FINANCIAL_ROADMAP.md:29-120`` proposes (but never
implements) a ``FinancialWaveletTransform`` whose forward pass runs a
preprocessing chain — gap handling, volatility normalization, outlier
detection — before the MODWT, configured by a ``FinancialConfig`` builder.
Implemented here as composable pure functions instead of a subclass: each
stage is jittable, batches over leading axes, and feeds any transform in
the library (the roadmap hard-wires MODWT; composition is the JAX
shape of the same idea — no preprocessing state to pool or synchronize).

Conventions: prices are ``(..., N)`` with time on the last axis; NaN marks
a gap (halted session, missing print).  All stages are NaN-safe and emit
gap-free output, so the chain ``log_returns → fill_gaps →
winsorize_outliers → normalize_volatility`` yields an array every
``ops/``-tier transform accepts.
"""
from __future__ import annotations

import functools
import math

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "log_returns", "cumulate_returns", "fill_gaps", "median_select",
    "winsorize_outliers", "ewma_volatility", "normalize_volatility",
    "realized_volatility", "preprocess_prices",
]


def log_returns(prices: jax.Array, scale: float = 1.0) -> jax.Array:
    """``scale·(ln p[t] − ln p[t−1])`` with r[0] = 0 — length-preserving.

    Length preservation (rather than the textbook N−1) keeps the output
    shape transform-friendly: every engine in the library takes the same
    N the prices had.  NaN prices propagate NaN returns at both affected
    lags (fill with :func:`fill_gaps` afterwards).
    """
    p = jnp.asarray(prices)
    lp = jnp.log(p)
    r = jnp.diff(lp, axis=-1, prepend=lp[..., :1])
    return r * scale


def cumulate_returns(returns: jax.Array, p0=1.0,
                     scale: float = 1.0) -> jax.Array:
    """Inverse of :func:`log_returns`: ``p0·exp(cumsum(r/scale))``.

    Roundtrip identity: ``cumulate_returns(log_returns(p), p[..., :1])``
    reproduces ``p`` exactly (r[0] = 0 makes the first sample p0).
    """
    r = jnp.asarray(returns) / scale
    return jnp.asarray(p0) * jnp.exp(jnp.cumsum(r, axis=-1))


def fill_gaps(x: jax.Array, method: str = "ffill") -> jax.Array:
    """Replace NaNs: ``'ffill'`` last-observation-carried-forward (a scan;
    leading NaNs fall back to the first finite value), ``'zero'`` (the
    right choice for RETURNS — a halted market realizes no return), or
    ``'mean'`` (per-series finite-sample mean).

    The roadmap's ``handleMarketGaps`` (FINANCIAL_ROADMAP.md:69-74) is a
    calendar-aware imputer; calendars are host-side data preparation, so
    the in-graph contract here is mask-based: anything the caller marks
    NaN is a gap, wherever it came from.
    """
    x = jnp.asarray(x)
    finite = jnp.isfinite(x)
    if method == "zero":
        return jnp.where(finite, x, 0.0)
    if method == "mean":
        cnt = jnp.maximum(jnp.sum(finite, axis=-1, keepdims=True), 1)
        mean = jnp.sum(jnp.where(finite, x, 0.0), axis=-1,
                       keepdims=True) / cnt
        return jnp.where(finite, x, mean)
    if method != "ffill":
        raise ValueError(f"unknown gap method {method!r}")
    # Parallel LOCF by log-doubling: pass k copies values rightward by 2^k
    # into still-empty slots, so after ⌈log₂N⌉ passes every slot holds its
    # nearest finite predecessor.  Pure shift+select: ~log₂N elementwise
    # passes instead of a latency-bound length-N lax.scan or a
    # cummax+gather.
    n = x.shape[-1]
    nan = jnp.asarray(jnp.nan, x.dtype)
    y = jnp.where(finite, x, nan)
    width = [(0, 0)] * (x.ndim - 1)
    shift = 1
    while shift < n:
        sh = jnp.pad(y[..., :n - shift], width + [(shift, 0)],
                     constant_values=np.nan)
        y = jnp.where(jnp.isnan(y), sh, y)
        shift *= 2
    # leading NaNs backfill with the first finite value (0 if none)
    idx = jnp.argmax(finite, axis=-1)
    first = jnp.take_along_axis(x, idx[..., None], axis=-1)[..., 0]
    first = jnp.where(jnp.isfinite(first), first, 0.0)
    return jnp.where(jnp.isnan(y), first[..., None], y)


def _order_keys(x: jax.Array) -> jax.Array:
    """Map floats to unsigned ints whose natural order equals float order.

    Positive floats keep their bit pattern with the sign bit set; negative
    floats are bit-complemented (IEEE-754 sign-magnitude ⇒ this is a strict
    monotone bijection, so selecting the k-th key selects the k-th value).
    NaNs map above +inf — callers must be NaN-free (the preprocessing chain
    gap-fills first).
    """
    if x.dtype == jnp.float64:
        u = lax.bitcast_convert_type(x, jnp.uint64)
        sign = jnp.uint64(1 << 63)
    else:
        if x.dtype != jnp.float32:          # bf16/f16: select in f32, exact
            x = x.astype(jnp.float32)
        u = lax.bitcast_convert_type(x, jnp.uint32)
        sign = jnp.uint32(1 << 31)
    return jnp.where((u & sign) != 0, ~u, u | sign)


def _keys_to_float(k: jax.Array, dtype) -> jax.Array:
    sign = k.dtype.type(1 << (k.dtype.itemsize * 8 - 1))
    b = jnp.where((k & sign) != 0, k ^ sign, ~k)
    f = lax.bitcast_convert_type(
        b, jnp.float64 if k.dtype == jnp.uint64 else jnp.float32)
    return f.astype(dtype)


def _kth_key(keys: jax.Array, k: int) -> jax.Array:
    """Exact k-th smallest (0-indexed) along the last axis by 4-way value
    bisection: ~bits/2 fused compare-count passes instead of a full sort.

    Each pass counts against three interval midpoints in ONE fused read
    of the data (the passes are memory-bound, so quartering the interval
    per pass instead of halving cuts the pass count ~2× for 3× the — far
    cheaper — compares).  The interval [lo, hi] always contains the k-th
    key; width shrinks to ≤ span/4 + 1 per pass, so bits/2 + 2 passes
    reach width 0 — far fewer passes than a full sort.
    """
    bits = keys.dtype.itemsize * 8
    lead = keys.shape[:-1]
    lo = jnp.zeros(lead, keys.dtype)
    hi = jnp.full(lead, ~keys.dtype.type(0), keys.dtype)
    kk = k + 1

    def body(_, lh):
        lo, hi = lh
        span = hi - lo
        m1 = lo + (span >> 2)
        m2 = lo + (span >> 1)
        m3 = m2 + (span >> 2)
        # three sibling compare-sums: XLA fuses them over ONE data read
        # (a stacked (…, 3, N) broadcast would defeat the fusion)
        c1 = jnp.sum(keys <= m1[..., None], axis=-1)
        c2 = jnp.sum(keys <= m2[..., None], axis=-1)
        c3 = jnp.sum(keys <= m3[..., None], axis=-1)
        lo2 = jnp.where(c1 >= kk, lo,
                        jnp.where(c2 >= kk, m1 + 1,
                                  jnp.where(c3 >= kk, m2 + 1, m3 + 1)))
        hi2 = jnp.where(c1 >= kk, m1,
                        jnp.where(c2 >= kk, m2,
                                  jnp.where(c3 >= kk, m3, hi)))
        return lo2, hi2

    lo, hi = lax.fori_loop(0, bits // 2 + 2, body, (lo, hi))
    return lo


def median_select(x: jax.Array, axis: int = -1) -> jax.Array:
    """Exact median without sorting (matches ``jnp.median`` semantics,
    including the mean-of-two-middles for even lengths AND NaN
    propagation) via bitwise k-th-element selection — the winsorize
    stage's former ``jnp.median`` sorts were ~60% of the whole
    preprocessing chain (VERDICT r4 #4).
    """
    x = jnp.asarray(x)
    if axis % x.ndim != x.ndim - 1:
        x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    keys = _order_keys(x)
    # NaN keys sort above +inf, which would yield a confidently WRONG
    # median on gappy data (code-review r5) — propagate like jnp.median
    # instead; one cheap fused reduction.
    has_nan = jnp.any(jnp.isnan(x), axis=-1)
    k1 = _kth_key(keys, (n - 1) // 2)
    if n % 2:
        med = _keys_to_float(k1, x.dtype)
    else:
        # second middle (rank n/2): equals k1 when k1's tie run covers rank
        # n/2, else the smallest key strictly above k1 — one fused pass
        # computing both the tie count and the masked min.
        top = jnp.full_like(keys, ~keys.dtype.type(0))
        above = keys > k1[..., None]
        nxt = jnp.min(jnp.where(above, keys, top), axis=-1)
        leq = jnp.sum(~above, axis=-1)          # count of keys ≤ k1
        k2 = jnp.where(leq >= n // 2 + 1, k1,
                       jnp.where(nxt == top[..., 0], k1, nxt))
        med = (_keys_to_float(k1, x.dtype)
               + _keys_to_float(k2, x.dtype)) / 2
    return jnp.where(has_nan, jnp.asarray(jnp.nan, med.dtype), med)


def winsorize_outliers(r: jax.Array, n_sigmas: float = 5.0,
                       axis: int = -1) -> jax.Array:
    """Clip returns to ``±n_sigmas·σ`` with σ the robust MAD scale.

    The roadmap's ``detectOutliers`` stage: MAD/0.6745 is immune to the
    very outliers being clipped (a plain std is not — one bad print
    inflates it and hides the rest).  Median/MAD are computed over
    ``axis``; clipping is centered on the median, so a trend in the
    window is not mistaken for outliers at the edges.

    Median/MAD use exact bitwise selection (:func:`median_select`, no
    sort); NaN input propagates loudly (NaN output), like the sorting
    formulation — run :func:`fill_gaps` first, as
    :func:`preprocess_prices` does.
    """
    r = jnp.asarray(r)
    med = jnp.expand_dims(median_select(r, axis=axis), axis)
    sigma = jnp.expand_dims(
        median_select(jnp.abs(r - med), axis=axis), axis) / 0.6745
    # Degenerate scale: >50% of the window identical (thin sessions full of
    # exactly-zero returns) gives MAD = 0, and clipping to [med, med] would
    # silently destroy the whole series — no robust scale ⇒ no clipping.
    lim = jnp.where(sigma > 0, n_sigmas * sigma, jnp.inf)
    return jnp.clip(r, med - lim, med + lim)


_FIR_BLK = 512


@functools.lru_cache(maxsize=32)
def _fir_block_constants(lam: float, k_taps: int, dtype_name: str):
    """(prev, cur) (BLK, BLK) banded constants for the exponential FIR:
    output t of a block reads ``taps[k]`` at input t−k, the previous
    block supplying the negative offsets (k_taps ≤ BLK guaranteed)."""
    a = np.zeros((_FIR_BLK, _FIR_BLK))
    b = np.zeros((_FIR_BLK, _FIR_BLK))
    taps = (1.0 - lam) * lam ** np.arange(k_taps)
    for t in range(_FIR_BLK):
        for k in range(k_taps):
            u = t - k
            if u >= 0:
                b[u, t] += taps[k]
            else:
                a[_FIR_BLK + u, t] += taps[k]
    return a.astype(dtype_name), b.astype(dtype_name)


def ewma_volatility(r: jax.Array, lam: float = 0.94,
                    min_periods: int = 10) -> jax.Array:
    """RiskMetrics EWMA volatility: ``σ²[t] = λ·σ²[t−1] + (1−λ)·r²[t]``.

    The roadmap's ``VolatilityNormalizer.normalize(data, volModel)``
    (FINANCIAL_ROADMAP.md:76-79) names GARCH; the λ=0.94 EWMA is the
    standard zero-fit member of that family (IGARCH(1,1) with fixed
    parameters) and the only one that needs no per-series optimization —
    the right default for an in-graph, jit-once pipeline.
    STRICTLY CAUSAL: σ[t] depends only on r[0..t] — the
    recursion seeds at r[0]² and the first ``min_periods`` steps blend
    toward the EXPANDING mean of r²[:t+1] (not the full-sample mean,
    which would leak future returns into a backtest's warm-up) so the
    warm-up does not divide by near-zero.
    """
    if not 0.0 <= lam < 1.0:
        raise ValueError(f"lam must be in [0, 1), got {lam}")
    r = jnp.asarray(r)
    if not jnp.issubdtype(r.dtype, jnp.floating):
        r = r.astype(jnp.float32)
    n = r.shape[-1]
    r2 = r * r
    # The recursion v[t] = λ·v[t−1] + (1−λ)·r²[t] unrolls to an
    # EXPONENTIAL FIR: v[t] = (1−λ)·Σ_k λ^k·r²[t−k] (+ the λ^{t+1}·r²[0]
    # seed term).  Run it as ONE truncated causal convolution — weights
    # past λ^K below the dtype's resolution are unrepresentable, so
    # truncating at K = ⌈−mant·ln2/lnλ⌉ (269 taps f32 / 594 f64 at
    # λ=0.94) is exact in-dtype — instead of a length-N time scan, which
    # is latency-bound, or lax.associative_scan, whose log-depth slicing
    # compiles slowly at production batches.
    bits = jnp.finfo(r.dtype).nmant + 1
    if lam == 0.0:
        k_taps = 1                                 # v[t] = r²[t]
    else:
        k_taps = int(min(n, np.ceil(-bits * np.log(2.0) / np.log(lam))))
        k_taps = max(k_taps, 1)
    taps = (1.0 - lam) * lam ** np.arange(k_taps)  # host f64
    lead = r2.shape[:-1]
    if k_taps <= _FIR_BLK:
        # Banded block-pair matmul (the FWT tier's trick at stride 1):
        # two (BLK, BLK) constants against the (prev, cur) block pair, as
        # einsums at HIGHEST precision (a reduced-precision product would
        # break the exact-in-dtype claim).  Not yet measured on the H100
        # against a 1-channel lax.conv (PERF.md open questions).
        a_np, b_np = _fir_block_constants(lam, k_taps,
                                          jnp.dtype(r2.dtype).name)
        npad = (-n) % _FIR_BLK
        x2p = jnp.pad(r2, [(0, 0)] * (r2.ndim - 1) + [(0, npad)])
        kb = (n + npad) // _FIR_BLK
        xb = x2p.reshape(lead + (kb, _FIR_BLK))
        prev = jnp.concatenate(
            [jnp.zeros(lead + (1, _FIR_BLK), r2.dtype), xb[..., :-1, :]],
            axis=-2)
        ein = lambda u, m: jnp.einsum(
            "...ku,uv->...kv", u, jnp.asarray(m),
            preferred_element_type=r2.dtype,
            precision=lax.Precision.HIGHEST)
        var = (ein(prev, a_np) + ein(xb, b_np)).reshape(
            lead + (n + npad,))[..., :n]
    else:
        # long-memory λ (K > BLK, e.g. λ ≥ ~0.989 in f32): 1-channel conv
        xp = jnp.pad(r2, [(0, 0)] * (r2.ndim - 1) + [(k_taps - 1, 0)])
        xp = xp.reshape((-1, 1, n + k_taps - 1))
        kern = jnp.asarray(taps[::-1].copy(),
                           dtype=r2.dtype).reshape(1, 1, k_taps)
        var = lax.conv_general_dilated(
            xp, kern, (1,), "VALID",
            dimension_numbers=("NCH", "OIH", "NCH"),
            precision=lax.Precision.HIGHEST)[:, 0, :]
        var = var.reshape(lead + (n,))
    # seed: v[0] = r²[0] exactly (strictly causal) ⇒ add λ^{t+1}·r²[0]
    if lam > 0.0:
        t_idx = jnp.arange(n, dtype=r.dtype)
        var = var + jnp.exp((t_idx + 1.0) * float(np.log(lam))) * r2[..., :1]
    if min_periods > 0:
        # the blend is 1 for every t ≥ min_periods, so the expanding mean
        # is only ever READ on the first min_periods columns — computing
        # it full-length would cost a length-N prefix sum.  Head-only is
        # exact-identical.
        head = min(min_periods, n)
        t = jnp.arange(head, dtype=r.dtype)
        blend = t / float(min_periods)
        var_exp = jnp.cumsum(r2[..., :head], axis=-1) / (t + 1.0)
        var = var.at[..., :head].set(
            blend * var[..., :head] + (1.0 - blend) * var_exp)
    return jnp.sqrt(var)


@functools.lru_cache(maxsize=4)
def _tri_ones(blk: int, dtype_name: str):
    # T[j, i] = 1 for j ≤ i: out[i] = Σ_{j≤i} x[j] as one (BLK, BLK) matmul
    return np.triu(np.ones((blk, blk))).astype(dtype_name)


def _cumsum_last(x: jax.Array) -> jax.Array:
    """Inclusive prefix sum along the last axis via matmuls.

    Per-512-block prefix via one upper-triangular-ones matmul (HIGHEST),
    plus an exclusive scan of the 128 block sums (tiny) — the same
    O(N·eps) summation error class as ``jnp.cumsum`` (a different but
    equally valid association order).  Not yet measured on the H100
    against ``jnp.cumsum`` (PERF.md open questions).
    """
    n = x.shape[-1]
    if n < 2 * _FIR_BLK:                   # matmul waste beats nothing here
        return jnp.cumsum(x, axis=-1)
    lead = x.shape[:-1]
    npad = (-n) % _FIR_BLK
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, npad)])
    kb = (n + npad) // _FIR_BLK
    xb = xp.reshape(lead + (kb, _FIR_BLK))
    tri = jnp.asarray(_tri_ones(_FIR_BLK, jnp.dtype(x.dtype).name))
    intra = jnp.einsum("...kj,ji->...ki", xb, tri,
                       preferred_element_type=x.dtype,
                       precision=lax.Precision.HIGHEST)
    sums = xb.sum(axis=-1)                               # (..., kb)
    offs = jnp.cumsum(sums, axis=-1) - sums              # exclusive
    out = (intra + offs[..., None]).reshape(lead + (n + npad,))
    return out[..., :n]


def normalize_volatility(r: jax.Array, lam: float = 0.94,
                         eps: float = 1e-12, rel_floor: float = 1e-3):
    """Devolatize returns: ``z[t] = r[t]/σ[t−1]`` (σ lagged one step so
    the normalizer is strictly causal — r[t] never sees its own shock).

    Returns ``(z, sigma)``; multiply back (``z·σ_lagged``) to restore.
    Wavelet variance/spectra of ``z`` then measure STRUCTURE (memory,
    scaling) instead of being dominated by volatility clustering — the
    reason the roadmap front-loads this before its MODWT.

    The divisor is floored at ``eps + rel_floor·(causal expanding RMS)``:
    after a long flat stretch (a halted session gap-filled to constant
    prices ⇒ zero returns) the EWMA σ decays toward 0, and a bare-eps
    floor would amplify the first resumed return by up to 1e12× — a
    spurious spike that would then dominate every downstream wavelet
    statistic.  The relative floor caps the amplification at
    ``1/rel_floor`` times the series' own running scale while leaving
    normal regimes untouched (σ ≫ rel_floor·RMS there).
    """
    r = jnp.asarray(r)
    if not jnp.issubdtype(r.dtype, jnp.floating):
        r = r.astype(jnp.float32)
    sigma = ewma_volatility(r, lam)
    lagged = jnp.concatenate([sigma[..., :1], sigma[..., :-1]], axis=-1)
    t = jnp.arange(r.shape[-1], dtype=r.dtype)
    rms_exp = jnp.sqrt(_cumsum_last(r * r) / (t + 1.0))
    lag_rms = jnp.concatenate([rms_exp[..., :1], rms_exp[..., :-1]],
                              axis=-1)
    floor = eps + rel_floor * lag_rms
    return r / jnp.maximum(lagged, floor), sigma


def realized_volatility(r: jax.Array, window: int,
                        annualize: float | None = None) -> jax.Array:
    """Rolling realized volatility ``√(Σ_window r²)`` per step (same
    length; the first ``window−1`` entries use the partial sum).
    ``annualize``: multiply by ``√annualize`` (e.g. 252 for daily bars).
    """
    r = jnp.asarray(r)
    n = r.shape[-1]
    c = _cumsum_last(r * r)
    width = [(0, 0)] * (r.ndim - 1) + [(window, 0)]
    shifted = jnp.pad(c, width)[..., :n]     # c delayed by `window`, 0-filled
    rv = jnp.sqrt(jnp.maximum(c - shifted, 0.0))
    if annualize is not None:
        rv = rv * math.sqrt(annualize)
    return rv


def preprocess_prices(prices: jax.Array, gap_method: str = "ffill",
                      n_sigmas: float = 5.0, devolatize: bool = True,
                      lam: float = 0.94):
    """The roadmap's full ``FinancialWaveletTransform`` preprocessing
    chain (FINANCIAL_ROADMAP.md:47-66) as one call: gap-fill prices →
    log returns → winsorize outliers → (optionally) devolatize.

    Returns ``(z, sigma)`` ready for any transform in the library
    (``sigma`` is the EWMA scale, or ones when ``devolatize=False``) —
    compose with ``modwt``/``modwt_variance``/``ssq_cwt`` instead of
    subclassing a transform.  Jits; batches.
    """
    p = fill_gaps(prices, gap_method)
    r = log_returns(p)
    r = winsorize_outliers(r, n_sigmas)
    if devolatize:
        return normalize_volatility(r, lam)
    return r, jnp.ones_like(r)
