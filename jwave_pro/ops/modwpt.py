"""Maximal-Overlap Discrete Wavelet Packet Transform (MODWPT).

The shift-invariant analog of the wavelet packet transform, completing the
transform matrix the same way MODWT completes the FWT:

=============  ==================  =============================
decimated      shift-invariant     subband structure
=============  ==================  =============================
``fwt``        ``modwt``           octave (dyadic) bands
``wpt``        ``modwpt`` (here)   full binary tree, 2^J bands
=============  ==================  =============================

The reference ships the decimated packet engine
(``WaveletPacketTransform.java:73-189``) and the shift-invariant octave
engine (``MODWTTransform.java:256-375``) but not their combination; MODWPT
is the canonical completion (Percival & Walden 2000, §6.1) and is what the
reference's README-level "shift-invariant analysis" tier implies for packet
bases.  Same filter pipeline as the MODWT (unit-L2-normalized banks ÷ √2,
``MODWTTransform.java:452-484``), same à-trous dilation per level, same
circular boundary.

Sequency (frequency) ordering: node n at level j is produced from parent
⌊n/2⌋ by the *scaling* filter g̃ when ``n mod 4 ∈ {0, 3}`` and the *wavelet*
filter h̃ when ``n mod 4 ∈ {1, 2}`` (the Gray-code rule that compensates the
spectral inversion of high-pass branches), so node n covers the frequency
band ``[n, n+1) · fs / 2^(j+1)`` and node energies read left-to-right in
frequency.  As a permutation of the natural (filter-order) tree this is
``nat = n XOR ((n >> 1) & 1)`` — an involution, shared by both directions.

A level is ONE batched pair-conv — all 2^(j-1) parents stack on a
leading axis and the (g̃, h̃) dilated circular convolutions share every rolled
copy (``ops.modwt._conv_channels``); the sequency reorder is a single static
gather.  No per-packet loops, no upsampled filters materialized.  The level-j
cost is 2^j · N · M MACs; the full tree is O(2^J · N · M).
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..wavelets.base import DiscreteWavelet
import functools

from .modwt import (
    _check_level, _combined_adjoint, _composite_shape, _level_conv,
    _use_fft, _wrapped_filter_fft, modwt_base_filters,
)

__all__ = [
    "modwpt", "imodwpt", "modwpt_tree", "modwpt_mra",
    "modwpt_best_basis", "modwpt_basis_reconstruct", "modwpt_node_path",
    "modwpt2", "imodwpt2", "modwpt2_tree", "modwpt2_best_basis",
    "modwpt2_basis_reconstruct", "modwpt3", "imodwpt3",
]


def _seq_perm(num_children: int) -> np.ndarray:
    """Sequency↔natural child permutation (involution): ``n ^ ((n>>1)&1)``."""
    n = np.arange(num_children)
    return n ^ ((n >> 1) & 1)


def modwpt_node_path(level: int, node: int) -> list[str]:
    """Filter path ('g'/'h' per level, root first) producing ``(level, node)``.

    Follows the sequency rule above; useful for interpreting which cascade
    of low/high-pass branches a packet corresponds to.
    """
    if not 0 <= node < (1 << level):
        raise ValueError(f"node {node} out of range for level {level}")
    path = []
    m = node
    for _ in range(level):
        path.append("g" if m % 4 in (0, 3) else "h")
        m //= 2
    return list(reversed(path))


@functools.lru_cache(maxsize=64)
def _composite_packet_multipliers(wavelet: DiscreteWavelet, level: int,
                                  n: int):
    """The whole packet cascade as one (2^level, F) multiplier stack.

    Replays :func:`_level_forward`'s recursion (child stack + sequency
    permutation) on host-side complex128 spectral multipliers — circular
    convs compose on the DFT grid, so the stack is algebraically identical
    to the per-level FFT cascade while costing 1 rfft + 1 batched irfft
    (the packet analog of ``ops.modwt._composite_fft_multipliers``).
    """
    g, h = modwt_base_filters(wavelet)
    mults = np.ones((1, n // 2 + 1), dtype=np.complex128)
    for j in range(1, level + 1):
        d = 1 << (j - 1)
        gf = _wrapped_filter_fft(g, d, n)
        hf = _wrapped_filter_fft(h, d, n)
        nat = np.stack([mults * gf, mults * hf], axis=1)
        nat = nat.reshape(2 * mults.shape[0], -1)
        mults = nat[_seq_perm(nat.shape[0])]
    return mults


def _level_forward(parents: jax.Array, g, h, j: int, method: str
                   ) -> jax.Array:
    """(P, ..., N) level-(j-1) nodes → (2P, ..., N) level-j nodes (sequency)."""
    gv, hv = _level_conv(parents, g, h, j, method)
    nat = jnp.stack([gv, hv], axis=1)          # (P, 2, ..., N)
    nat = nat.reshape((2 * parents.shape[0],) + parents.shape[1:])
    return jnp.take(nat, _seq_perm(nat.shape[0]), axis=0)


def _level_inverse(children: jax.Array, g, h, j: int, method: str
                   ) -> jax.Array:
    """(2P, ..., N) level-j nodes (sequency) → (P, ..., N) parents."""
    nat = jnp.take(children, _seq_perm(children.shape[0]), axis=0)
    child_g, child_h = nat[0::2], nat[1::2]
    n = children.shape[-1]
    if _use_fft(method, n, g.shape[0], 1 << (j - 1)):
        va, wa = _level_conv(child_g, g, h, j, method, adjoint=True,
                             w=child_h)
        return va + wa
    d = 1 << (j - 1)
    return _combined_adjoint(child_g, child_h,
                             jnp.asarray(g, dtype=children.dtype),
                             jnp.asarray(h, dtype=children.dtype), d)


def modwpt(x: jax.Array, wavelet: DiscreteWavelet, level: int,
           method: str = "auto") -> jax.Array:
    """Forward MODWPT on the last axis: ``(..., N) → (2^level, ..., N)``.

    Node axis is sequency-ordered (node n ≈ band ``[n, n+1)·fs/2^(level+1)``).
    Works for arbitrary (non-pow2) N; every level preserves energy
    (``Σ_n ‖W_{level,n}‖² = ‖x‖²``).  Node 0 equals the MODWT's V_level and
    node 1 its W_level.

    ``method``: 'direct' (dilated à-trous conv), 'fft', 'auto' (the cost
    model between them), or 'auto_reference' — the
    :func:`..modwt.modwt` convolution engines.
    """
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.integer):
        x = x.astype(jnp.float32)
    _check_level(x.shape[-1], level)
    g, h = modwt_base_filters(wavelet)
    n = x.shape[-1]
    if method in ("fft", "auto") and _use_fft(method, n, g.shape[0], 1):
        mult = _composite_shape(
            _composite_packet_multipliers(wavelet, level, n), x.ndim - 1)
        xf = jnp.fft.rfft(x)
        prod = xf[None] * jnp.asarray(mult).astype(xf.dtype)
        return jnp.fft.irfft(prod, n=n).astype(x.dtype)
    nodes = x[jnp.newaxis]
    for j in range(1, level + 1):
        nodes = _level_forward(nodes, g, h, j, method)
    return nodes


def imodwpt(coeffs: jax.Array, wavelet: DiscreteWavelet,
            method: str = "auto") -> jax.Array:
    """Inverse MODWPT: ``(2^level, ..., N) → (..., N)``.

    Adjoint cascade (the packet analog of ``MODWTTransform.inverseMODWT``,
    ``:337-375``): each parent is the sum of its two children's adjoint
    convolutions, filters assigned by the same sequency rule.
    """
    coeffs = jnp.asarray(coeffs)
    p = coeffs.shape[0]
    if p < 2 or p & (p - 1):
        raise ValueError(
            f"leading axis must be 2^level ≥ 2 packet nodes, got {p}")
    level = p.bit_length() - 1
    g, h = modwt_base_filters(wavelet)
    n = coeffs.shape[-1]
    if method in ("fft", "auto") and _use_fft(method, n, g.shape[0], 1):
        mult = _composite_shape(
            _composite_packet_multipliers(wavelet, level, n),
            coeffs.ndim - 2)
        cf = jnp.fft.rfft(coeffs)
        acc = jnp.sum(cf * jnp.conj(jnp.asarray(mult)).astype(cf.dtype),
                      axis=0)
        return jnp.fft.irfft(acc, n=n).astype(coeffs.dtype)
    nodes = coeffs
    for j in range(level, 0, -1):
        nodes = _level_inverse(nodes, g, h, j, method)
    return nodes[0]


def modwpt_tree(x: jax.Array, wavelet: DiscreteWavelet, level: int,
                method: str = "direct") -> list[jax.Array]:
    """Full packet tree: list over levels 0..level of ``(2^l, ..., N)``.

    Row 0 is the input (one node); row l the sequency-ordered level-l nodes.
    Levels are nested analyses of the same signal (each preserves energy),
    so additive information costs are comparable across levels — the
    precondition for :func:`modwpt_best_basis`.
    """
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.integer):
        x = x.astype(jnp.float32)
    _check_level(x.shape[-1], level)
    g, h = modwt_base_filters(wavelet)
    rows = [x[jnp.newaxis]]
    for j in range(1, level + 1):
        rows.append(_level_forward(rows[-1], g, h, j, method))
    return rows


def modwpt_mra(x: jax.Array, wavelet: DiscreteWavelet, level: int,
               method: str = "direct") -> jax.Array:
    """Per-node additive components: ``(2^level, ..., N)`` with Σ_n D_n = x.

    Component n is the adjoint cascade applied to node n alone (its unique
    root path), the packet analog of :func:`..modwt.modwt_mra` / MATLAB's
    ``modwptdetails``.  Each component is the part of the signal living in
    node n's frequency band; the decomposition is exact by linearity of the
    inverse.

    Batched formulation: at adjoint level j every node's branch filter is
    static (g̃ when its level-j ancestor ``m = n >> (level-j)`` has
    ``m mod 4 ∈ {0, 3}``, else h̃), so ONE shared-roll pair-conv over all
    2^level components plus a per-node select replaces the per-node loop —
    2 batched ops per level instead of 2^level small convs.
    """
    nodes = modwpt(x, wavelet, level, method)
    g, h = modwt_base_filters(wavelet)
    p = 1 << level
    comps = nodes
    for j in range(level, 0, -1):
        m = np.arange(p) >> (level - j)
        use_g = (m % 4 == 0) | (m % 4 == 3)
        cg, ch = _level_conv(comps, g, h, j, method, adjoint=True)
        sel = jnp.asarray(use_g).reshape((p,) + (1,) * (comps.ndim - 1))
        comps = jnp.where(sel, cg, ch)
    return comps


def modwpt_best_basis(x: jax.Array, wavelet: DiscreteWavelet, level: int,
                      cost: str = "shannon", method: str = "direct"):
    """Coifman–Wickerhauser best basis over the shift-invariant packet tree.

    Returns ``(masks, total_cost, tree)``: ``masks[l]`` is a boolean
    ``(2^l,)`` array — True where node (l, n) is a leaf of the optimal
    basis; ``tree`` the :func:`modwpt_tree` list.  Same DP as
    :func:`.wpt.best_basis` (costs are additive and every level preserves
    energy); node costs here are whole-node costs over all N samples.
    Batched input selects one basis for the whole batch.
    """
    from .wpt import _COSTS

    cost_fn = _COSTS[cost] if isinstance(cost, str) else cost
    tree = modwpt_tree(x, wavelet, level, method)

    costs = []
    for l in range(level + 1):
        row = tree[l]                                    # (2^l, ..., N)
        flat = row.reshape((row.shape[0], -1))
        costs.append(cost_fn(flat, axis=-1))             # (2^l,)

    best = costs[level]
    split = []
    for l in range(level - 1, -1, -1):
        children = best.reshape((-1, 2)).sum(axis=-1)
        take = children < costs[l]
        split.append(take)
        best = jnp.where(take, children, costs[l])
    split.reverse()

    masks = []
    reach = jnp.ones((1,), dtype=bool)
    for l in range(level + 1):
        if l < level:
            leaf = reach & ~split[l]
            reach = jnp.repeat(reach & split[l], 2)
        else:
            leaf = reach
        masks.append(leaf)
    return masks, best[0], tree


def modwpt_basis_reconstruct(tree, masks, wavelet: DiscreteWavelet,
                             method: str = "direct") -> jax.Array:
    """Reconstruct the signal from a best-basis selection.

    ``tree`` from :func:`modwpt_tree`, ``masks`` from
    :func:`modwpt_best_basis`.  Bottom-up: non-leaf deep nodes carry the
    running partial inverses; at each level the leaf nodes' own coefficients
    are added in (the adjoint is linear, so zeroed non-leaves contribute
    nothing).  jit-friendly — masks may be traced booleans.
    """
    level = len(masks) - 1
    g, h = modwt_base_filters(wavelet)

    def mask_mul(row, m):
        shape = (row.shape[0],) + (1,) * (row.ndim - 1)
        return row * m.reshape(shape).astype(row.dtype)

    cur = mask_mul(tree[level], masks[level])
    for l in range(level, 0, -1):
        parents = _level_inverse(cur, g, h, l, method)
        cur = parents + mask_mul(tree[l - 1], masks[l - 1])
    return cur[0]


# ---------------------------------------------------------------------------
# 2D MODWPT — shift-invariant quad-tree (tensor product of two 1D trees)
# ---------------------------------------------------------------------------

def modwpt2(x: jax.Array, wavelet: DiscreteWavelet, level: int,
            method: str = "auto") -> jax.Array:
    """2D MODWPT: ``(..., R, C) → (2^level, 2^level, ..., R, C)``.

    The undecimated quad-tree completing the 2D transform matrix the same
    way :func:`modwpt` completes the 1D one (fwt2 : modwt2 :: wpt2 :
    modwpt2); separability makes it the tensor product of two 1D packet
    trees, so node ``(n_r, n_c)`` applies the row cascade of 1D node
    ``n_r`` and the column cascade of node ``n_c`` — both axes sequency-
    ordered (node (n_r, n_c) ≈ the 2D frequency cell
    ``[n_r, n_r+1)×[n_c, n_c+1) · fs/2^(level+1)``).  Node (0, 0) equals
    the 2D MODWT's LL_level.  Exactly shift-invariant in both axes;
    every level preserves energy.

    Computed as two big-batch 1D transforms (rows then columns, the
    orthogonal-axis samples flattened into the batch).
    """
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.integer):
        x = x.astype(jnp.float32)
    if x.ndim < 2:
        raise ValueError("modwpt2 needs at least 2 dims (..., R, C)")
    *lead, r, c = x.shape
    _check_level(r, level)
    _check_level(c, level)
    p = 1 << level
    xt = jnp.swapaxes(x, -1, -2).reshape(-1, r)        # (B·C, R)
    nr = modwpt(xt, wavelet, level, method)            # (P, B·C, R)
    nr = jnp.swapaxes(nr.reshape([p] + lead + [c, r]), -1, -2)
    nc = modwpt(nr.reshape(-1, c), wavelet, level, method)   # (P, P·B·R, C)
    nc = nc.reshape([p, p] + lead + [r, c])            # (n_col, n_row, ...)
    return jnp.swapaxes(nc, 0, 1)


def imodwpt2(coeffs: jax.Array, wavelet: DiscreteWavelet,
             method: str = "auto") -> jax.Array:
    """Inverse 2D MODWPT: ``(2^level, 2^level, ..., R, C) → (..., R, C)``."""
    coeffs = jnp.asarray(coeffs)
    if coeffs.ndim < 4:
        raise ValueError(
            "imodwpt2 expects (nodes_r, nodes_c, ..., R, C)")
    pr, pc = coeffs.shape[0], coeffs.shape[1]
    if pr != pc or pr < 2 or pr & (pr - 1):
        raise ValueError(
            f"leading node axes must be equal powers of two ≥ 2, got "
            f"({pr}, {pc})")
    *lead, r, c = coeffs.shape[2:]
    t = jnp.swapaxes(coeffs, 0, 1)                     # (n_col, n_row, ...)
    sig_r = imodwpt(t.reshape(pc, -1, c), wavelet, method)   # (P·B·R, C)
    sig_r = sig_r.reshape([pr] + lead + [r, c])
    t = jnp.swapaxes(sig_r, -1, -2)                    # (P, ..., C, R)
    sig = imodwpt(t.reshape(pr, -1, r), wavelet, method)     # (B·C, R)
    return jnp.swapaxes(sig.reshape(lead + [c, r]), -1, -2)


def _level_forward2(nodes: jax.Array, g, h, j: int, method: str
                    ) -> jax.Array:
    """One quad-tree level: (P, P, ..., R, C) → (2P, 2P, ..., R, C)."""
    t = jnp.swapaxes(nodes, -1, -2)          # rows to the conv axis
    t = _level_forward(t, g, h, j, method)   # (2P_r, P_c, ..., C, R)
    t = jnp.swapaxes(jnp.swapaxes(t, -1, -2), 0, 1)
    t = _level_forward(t, g, h, j, method)   # (2P_c, 2P_r, ..., R, C)
    return jnp.swapaxes(t, 0, 1)


def _level_inverse2(nodes: jax.Array, g, h, j: int, method: str
                    ) -> jax.Array:
    """One quad-tree adjoint level: (2P, 2P, ..., R, C) → (P, P, ...)."""
    t = jnp.swapaxes(nodes, 0, 1)            # (2P_c, 2P_r, ..., R, C)
    t = _level_inverse(t, g, h, j, method)   # (P_c, 2P_r, ..., R, C)
    t = jnp.swapaxes(jnp.swapaxes(t, 0, 1), -1, -2)
    t = _level_inverse(t, g, h, j, method)   # (P_r, P_c, ..., C, R)
    return jnp.swapaxes(t, -1, -2)


def modwpt2_tree(x: jax.Array, wavelet: DiscreteWavelet, level: int,
                 method: str = "auto") -> list[jax.Array]:
    """Full quad tree: list over levels 0..level of ``(2^l, 2^l, ..., R, C)``.

    Row 0 is the input under (1, 1) node axes; every level is a nested
    energy-preserving analysis — the precondition for
    :func:`modwpt2_best_basis`.
    """
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.integer):
        x = x.astype(jnp.float32)
    _check_level(x.shape[-2], level)
    _check_level(x.shape[-1], level)
    g, h = modwt_base_filters(wavelet)
    rows = [x[jnp.newaxis, jnp.newaxis]]
    for j in range(1, level + 1):
        rows.append(_level_forward2(rows[-1], g, h, j, method))
    return rows


def modwpt2_best_basis(x: jax.Array, wavelet: DiscreteWavelet, level: int,
                       cost: str = "shannon", method: str = "auto"):
    """Quad-tree Coifman–Wickerhauser best basis over the shift-invariant
    2D packet tree (the undecimated analog of :func:`.wpt.best_basis2`).

    Returns ``(masks, total_cost, tree)``: ``masks[l]`` is a boolean
    ``(2^l, 2^l)`` grid — True where node (l, n_r, n_c) is a leaf of the
    optimal basis.  Node costs are whole-node costs over all R·C samples
    (summed over leading batch axes).
    """
    from .wpt import _COSTS

    cost_fn = _COSTS[cost] if isinstance(cost, str) else cost
    tree = modwpt2_tree(x, wavelet, level, method)

    costs = []
    for l in range(level + 1):
        row = tree[l]                                  # (2^l, 2^l, ..., R, C)
        flat = row.reshape((row.shape[0], row.shape[1], -1))
        costs.append(cost_fn(flat, axis=-1))           # (2^l, 2^l)

    best = costs[level]
    split = []
    for l in range(level - 1, -1, -1):
        p = 1 << l
        quads = best.reshape((p, 2, p, 2))
        children = quads.sum(axis=(1, 3))
        take = children < costs[l]
        split.append(take)
        best = jnp.where(take, children, costs[l])
    split.reverse()

    masks = []
    reach = jnp.ones((1, 1), dtype=bool)
    for l in range(level + 1):
        if l < level:
            leaf = reach & ~split[l]
            nxt = reach & split[l]
            reach = jnp.repeat(jnp.repeat(nxt, 2, axis=0), 2, axis=1)
        else:
            leaf = reach
        masks.append(leaf)
    return masks, best[0, 0], tree


def modwpt2_basis_reconstruct(tree, masks, wavelet: DiscreteWavelet,
                              method: str = "auto") -> jax.Array:
    """Reconstruct the image from a quad-tree best-basis selection.

    Bottom-up adjoint cascade mirroring :func:`modwpt_basis_reconstruct`;
    masks may be traced booleans (jit-friendly).
    """
    level = len(masks) - 1
    g, h = modwt_base_filters(wavelet)

    def mask_mul(row, m):
        shape = row.shape[:2] + (1,) * (row.ndim - 2)
        return row * m.reshape(shape).astype(row.dtype)

    cur = mask_mul(tree[level], masks[level])
    for l in range(level, 0, -1):
        parents = _level_inverse2(cur, g, h, l, method)
        cur = parents + mask_mul(tree[l - 1], masks[l - 1])
    return cur[0, 0]


def modwpt3(x: jax.Array, wavelet: DiscreteWavelet, level: int,
            method: str = "auto") -> jax.Array:
    """3D MODWPT: ``(..., D, R, C) → (2^L, 2^L, 2^L, ..., D, R, C)``.

    The undecimated OCT-tree (r5) completing the 3D transform matrix the
    way :func:`modwpt2` completes the 2D one (fwt3 : modwt3 :: wpt3 :
    modwpt3): separability makes it the tensor product of three 1D packet
    trees, so node ``(n_d, n_r, n_c)`` applies the depth cascade of 1D
    node ``n_d``, the row cascade of ``n_r`` and the column cascade of
    ``n_c`` — all axes sequency-ordered.  Node (0, 0, 0) equals the 3D
    MODWT's LLL_level; exactly shift-invariant in all three axes; every
    level preserves energy.  Output is 8^L full-resolution volumes —
    keep ``level`` small (L1: 8 nodes, L2: 64).

    Computed as three big-batch 1D transforms (the orthogonal axes
    flattened into the batch).
    """
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.integer):
        x = x.astype(jnp.float32)
    if x.ndim < 3:
        raise ValueError("modwpt3 needs at least 3 dims (..., D, R, C)")
    *lead, dd, r, c = x.shape
    _check_level(dd, level)
    _check_level(r, level)
    _check_level(c, level)
    p = 1 << level
    # depth pass
    t = jnp.moveaxis(x, -3, -1)                         # (..., R, C, D)
    nd = modwpt(t.reshape(-1, dd), wavelet, level, method)
    nd = jnp.moveaxis(nd.reshape([p] + lead + [r, c, dd]), -1, -3)
    # row pass
    t = jnp.swapaxes(nd, -1, -2)                        # (P_d, ..., D, C, R)
    nr = modwpt(t.reshape(-1, r), wavelet, level, method)
    nr = jnp.swapaxes(nr.reshape([p, p] + lead + [dd, c, r]), -1, -2)
    # column pass
    nc = modwpt(nr.reshape(-1, c), wavelet, level, method)
    nc = nc.reshape([p, p, p] + lead + [dd, r, c])      # (n_c, n_r, n_d, …)
    perm = [2, 1, 0] + list(range(3, nc.ndim))
    return jnp.transpose(nc, perm)                      # (n_d, n_r, n_c, …)


def imodwpt3(coeffs: jax.Array, wavelet: DiscreteWavelet,
             method: str = "auto") -> jax.Array:
    """Inverse 3D MODWPT: ``(2^L, 2^L, 2^L, ..., D, R, C) → (..., D, R, C)``."""
    coeffs = jnp.asarray(coeffs)
    if coeffs.ndim < 6:
        raise ValueError(
            "imodwpt3 expects (nodes_d, nodes_r, nodes_c, ..., D, R, C)")
    pd, pr, pc = coeffs.shape[0], coeffs.shape[1], coeffs.shape[2]
    if not (pd == pr == pc) or pd < 2 or pd & (pd - 1):
        raise ValueError(
            f"leading node axes must be equal powers of two ≥ 2, got "
            f"({pd}, {pr}, {pc})")
    *lead, dd, r, c = coeffs.shape[3:]
    # undo column pass (consume n_c), then rows, then depth
    t = jnp.transpose(coeffs,
                      [2, 1, 0] + list(range(3, coeffs.ndim)))
    sig_c = imodwpt(t.reshape(pc, -1, c), wavelet, method)
    sig_c = sig_c.reshape([pr, pd] + lead + [dd, r, c])  # (n_r, n_d, …)
    t = jnp.swapaxes(sig_c, -1, -2)                      # (…, D, C, R)
    sig_r = imodwpt(t.reshape(pr, -1, r), wavelet, method)
    sig_r = jnp.swapaxes(sig_r.reshape([pd] + lead + [dd, c, r]), -1, -2)
    t = jnp.moveaxis(sig_r, -3, -1)                      # (n_d, …, R, C, D)
    sig = imodwpt(t.reshape(pd, -1, dd), wavelet, method)
    return jnp.moveaxis(sig.reshape(lead + [r, c, dd]), -1, -3)
