"""Matching pursuit over the shift-invariant wavelet-packet dictionary.

Greedy sparse decomposition (Mallat & Zhang 1993): pick the dictionary atom
most correlated with the residual, subtract its projection, repeat.  The
reference's README-level "optimal basis selection" tier stops at best-basis
(``ops/wpt.py``/``ops/modwpt.py``); matching pursuit is the adaptive
*super-complete* counterpart — instead of one orthogonal basis chosen from
the packet tree, any atom of the full time×frequency grid may be used, which
resolves transients and tones simultaneously.

Dictionary = the level-J MODWPT atoms: for node ``n`` and shift ``t`` the
atom is the node's effective circular filter time-reversed and rolled to t,

    atom[n, t][u] = f_n[(t − u) mod N] / ‖f_n‖₂ ,

so the correlation of the residual with EVERY atom at once is exactly one
forward MODWPT (``⟨r, atom[n,t]⟩ = W_n[t]/‖f_n‖``) — 2^J·N inner products
for one transform pass.  No per-atom loops, no explicit
(2^J·N, N) dictionary matrix, and the greedy iteration is a fixed-length
``lax.scan`` (static shapes; one transform + one argmax + one S-wide
windowed subtraction per step — the atom's finite support
S = (M−1)(2^J−1)+1 ≪ N makes the update a dynamic-slice add, not an
N-length roll; see ``_subtract_atom_windowed``).

The effective node filters come from the same host-side spectral cascade the
FFT path uses (``ops/modwpt._composite_packet_multipliers``), so the
dictionary is exactly consistent with :func:`..ops.modwpt.modwpt` — parity
between the scan's correlations and the transform is structural, not
numerical luck.
"""
from __future__ import annotations

import functools
import typing

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..wavelets.base import DiscreteWavelet
from .modwpt import _composite_packet_multipliers, modwpt

__all__ = ["matching_pursuit", "mp_reconstruct", "MPResult"]

# f32 products here feed least-squares solves and an exact residual ⊥ span
# identity, so they must not drop to TF32 (the GPU default for f32 dots).
_EXACT = lax.Precision.HIGHEST


class MPResult(typing.NamedTuple):
    """Greedy decomposition ``x ≈ Σ_k amps[k] · atom(nodes[k], shifts[k])``.

    ``nodes``/``shifts``/``amps``: ``(..., K)`` — packet node (sequency
    order), circular time shift, and coefficient on the UNIT-norm atom, in
    selection order.  ``residual``: ``(..., N)`` after all K subtractions.
    ``level``/``wavelet_name``: the dictionary parameters (needed to rebuild
    atoms in :func:`mp_reconstruct`).
    """

    nodes: jax.Array
    shifts: jax.Array
    amps: jax.Array
    residual: jax.Array
    level: int
    wavelet_name: str

    @property
    def energies(self):
        """Per-atom captured energy |α_k|² — **plain MP only** (unit atoms ⇒
        the greedy identity ‖r_k‖² = ‖r_{k-1}‖² − α_k² holds, so a post-hoc
        energy cutoff over these is exact).  For ``orthogonalize=True`` the
        amps are the final joint least-squares coefficients over a
        NON-orthogonal atom set: amps² are not per-step captured energies
        and do not sum to ‖x‖² − ‖r‖²; rank atoms by re-running with
        increasing K and differencing ‖residual‖² instead (ADVICE r3)."""
        return self.amps ** 2


# level / wavelet_name are STATIC dictionary parameters, not array leaves:
# registered as pytree aux_data so jit/vmap over functions returning an
# MPResult work (a str leaf fails at trace time; explicit registrations
# take precedence over the default namedtuple flattening).  ADVICE r3.
jax.tree_util.register_pytree_node(
    MPResult,
    lambda r: ((r.nodes, r.shifts, r.amps, r.residual),
               (r.level, r.wavelet_name)),
    lambda aux, ch: MPResult(*ch, *aux),
)


@functools.lru_cache(maxsize=64)
def _atom_tables(wavelet: DiscreteWavelet, level: int, n: int):
    """Host f64 tables: reversed unit atoms ``(2^level, N)`` + filter norms.

    ``rev_unit[n, u] = f_n[(−u) mod N] / ‖f_n‖`` so the atom at shift t is
    ``jnp.roll(rev_unit[n], t)`` (equivalently a ``(u − t) mod N`` gather).
    """
    mults = _composite_packet_multipliers(wavelet, level, n)
    f = np.fft.irfft(mults, n=n, axis=-1)          # (2^L, N) effective filters
    norms = np.linalg.norm(f, axis=-1)
    rev = np.roll(f[:, ::-1], 1, axis=-1)          # rev[u] = f[(−u) mod N]
    return rev / norms[:, None], norms


@functools.lru_cache(maxsize=64)
def _gram_lag_table(wavelet: DiscreteWavelet, level: int, n: int):
    """Host f64 cross-correlation table ``(2^L, 2^L, 2S−1)``:
    ``tab[m, m', d+S−1] = ⟨atom(m, t), atom(m', t−d)⟩`` for circular lags
    ``d ∈ [−(S−1), S−1]`` — zero beyond (finite atom support S).

    r5 (VERDICT r4 #8 attempt): OMP's per-pick Gram row
    ``⟨atom_j, atom_k⟩`` was an einsum over the whole (…, K, N) atom
    buffer — a full device-memory read of the buffer EVERY pick (~134 MB at B=8
    K=64 N=64K).  Inner products of shift-invariant atoms depend only on
    (node_j, node_k, t_j − t_k), so the whole Gram geometry fits in this
    ~25 KB host table and the row becomes a K-element gather.

    Built from the COMPACT (2^L, S) support windows with length-2S FFTs
    — a length-N outer product would be an O(4^L·N) host blowup (2 GB at
    L=6, N=64K; code-review r5).  Zero-padding to 2S makes the circular
    correlation equal the linear one on every needed lag; equality with
    the length-N form holds because atoms ≥ 2S apart never overlap (the
    caller gates on n ≥ 2S).
    """
    win, s = _support_window_table(wavelet, level, n)
    p = 2 * s
    spec = np.fft.rfft(win, n=p, axis=-1)
    cc = np.fft.irfft(np.conj(spec[:, None]) * spec[None, :], n=p, axis=-1)
    lags = np.arange(-(s - 1), s) % p
    return cc[:, :, lags], s


@functools.lru_cache(maxsize=64)
def _support_window_table(wavelet: DiscreteWavelet, level: int, n: int):
    """(2^L, S) window per node: the atom's only nonzero samples.

    A level-L MODWPT node's effective filter has finite support
    ``S = (M−1)(2^L−1)+1`` ≪ N, so the unit atom at shift t occupies just
    the S positions ``[t−S+1, t] mod N``.  ``win[node][i]`` is the atom
    value at position ``t − S + 1 + i`` (i.e. ``rev_unit[node]`` values
    reordered): subtracting ``amp·atom`` is an S-wide windowed update, not
    an N-length roll.  Returns (win, S).
    """
    rev, _ = _atom_tables(wavelet, level, n)
    s = min((wavelet.length - 1) * ((1 << level) - 1) + 1, n)
    win = np.concatenate([rev[:, n - s + 1:], rev[:, :1]], axis=1)
    return win, s


def _subtract_atom_windowed(r, win_table, s: int, node, t, amp):
    """``r − amp·atom(node, t)`` via an S-wide dynamic-slice add.

    The window [t−S+1, t] may wrap; the update lands in a zero (…, N+S)
    staging buffer at start = (t−S+1) mod N ∈ [0, N) so it never crosses
    the buffer end more than once, and the overflow [N, N+S) folds back
    onto [0, S).  All shapes static; batched starts vmap to a scatter of
    S·B elements.
    """
    n = r.shape[-1]
    vals = amp[..., None] * jnp.take(win_table, node, axis=0)   # (..., S)
    start = (t - (s - 1)) % n
    z = jnp.zeros(r.shape[:-1] + (n + s,), r.dtype)

    def upd(zrow, vrow, st):
        return lax.dynamic_update_slice(zrow, vrow, (st,))

    for _ in range(r.ndim - 1):
        upd = jax.vmap(upd)
    z = upd(z, vals, start)
    return r - z[..., :n].at[..., :s].add(z[..., n:])


def _gather_atoms(rev_unit: jax.Array, nodes: jax.Array, shifts: jax.Array,
                  n: int) -> jax.Array:
    """Atom values ``(..., N)`` (or ``(..., K, N)``) for (node, shift) picks:
    ``roll(rev_unit[node], shift)`` with traced per-element shifts, as an
    exact gather.  (A spectral phase-ramp irfft route measured no faster
    on an H100 and 15% slower inside OMP; PERF.md.)"""
    rows = jnp.take(rev_unit, nodes, axis=0)               # (..., N)
    idx = (jnp.arange(n, dtype=shifts.dtype) - shifts[..., None]) % n
    return jnp.take_along_axis(rows, idx, axis=-1)


def matching_pursuit(x: jax.Array, wavelet: DiscreteWavelet, level: int,
                     n_atoms: int, method: str = "auto",
                     orthogonalize: bool = False) -> MPResult:
    """Greedy MP of ``x`` ``(..., N)`` over the level-``level`` MODWPT atoms.

    ``n_atoms``: static iteration count K (the classic stopping rule; check
    ``result.energies`` to pick an energy cutoff post hoc — entries past the
    point of interest can be dropped before :func:`mp_reconstruct` by
    slicing all three coefficient arrays).  ``method`` is forwarded to the
    per-iteration :func:`..ops.modwpt.modwpt`.

    ``orthogonalize=True`` runs Orthogonal Matching Pursuit (Pati–
    Rezaiifar–Krishnaprasad 1993): after each pick the residual is the
    least-squares remainder over ALL selected atoms, so it is exactly
    orthogonal to their span and ``amps`` are the final joint LS
    coefficients (not the per-step correlations).  The Gram matrix grows by one incrementally-written row/column per step
    inside the scan, identity-padded on unselected rows so one fixed-shape
    ``(K, K)`` batched solve per step stays static — no dynamic shapes.

    Fully jittable and vmap-friendly: per-batch-element argmax and rolled
    subtraction, fixed shapes throughout.
    """
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.integer):
        x = x.astype(jnp.float32)
    if n_atoms < 1:
        raise ValueError("n_atoms must be >= 1")
    n = x.shape[-1]
    num_nodes = 1 << level
    rev_np, norms_np = _atom_tables(wavelet, level, n)
    rev_unit = jnp.asarray(rev_np, dtype=x.dtype)
    inv_norms = jnp.asarray(1.0 / norms_np, dtype=x.dtype)
    # broadcast 1/‖f_n‖ over the (2^L, ..., N) coefficient stack
    inv_b = inv_norms.reshape((num_nodes,) + (1,) * x.ndim)
    def select(r):
        """Best (node, shift, correlation) per batch element.

        Two-stage argmax on the native (2^L, ..., N) layout — per-node best
        shift, then best node — so the 2^L·N coefficient block is never
        transposed (the moveaxis alternative materializes it twice).
        """
        w = modwpt(r, wavelet, level, method=method) * inv_b
        a = jnp.abs(w)
        t_per = jnp.argmax(a, axis=-1).astype(jnp.int32)        # (2^L, ...)
        v_per = jnp.max(a, axis=-1)                             # (2^L, ...)
        node = jnp.argmax(v_per, axis=0).astype(jnp.int32)      # (...,)
        t = jnp.take_along_axis(t_per, node[None], axis=0)[0]
        # signed amp: small (2^L·batch)-output gather, then the node pick
        w_bt = jnp.take_along_axis(w, t_per[..., None], axis=-1)[..., 0]
        amp = jnp.take_along_axis(w_bt, node[None], axis=0)[0]
        return node, t, amp

    if not orthogonalize:
        win_np, s_win = _support_window_table(wavelet, level, n)
        win_tab = jnp.asarray(win_np, dtype=x.dtype)

        def body(r, _):
            node, t, amp = select(r)
            return (_subtract_atom_windowed(r, win_tab, s_win, node, t, amp),
                    (node, t, amp))

        residual, (nodes, shifts, amps) = lax.scan(body, x, None,
                                                   length=n_atoms)
        to_last = lambda a: jnp.moveaxis(a, 0, -1)      # (K, ...) → (..., K)
        return MPResult(to_last(nodes), to_last(shifts), to_last(amps),
                        residual, level, wavelet.name)

    k_tot = n_atoms
    batch = x.shape[:-1]
    buf0 = jnp.zeros(batch + (k_tot, n), x.dtype)        # selected atoms
    # identity-padded Gram: unselected rows stay e_j, so solve() returns 0
    # for slots not yet filled — the fixed-shape trick that keeps OMP static
    gram0 = jnp.broadcast_to(jnp.eye(k_tot, dtype=x.dtype),
                             batch + (k_tot, k_tot))
    b0 = jnp.zeros(batch + (k_tot,), x.dtype)

    # Degenerate-pick guard (ADVICE r3 medium): when n_atoms exceeds the
    # signal's effective sparsity the residual hits ~0 and the argmax
    # re-picks an already-selected atom — the identity-padded Gram then goes
    # exactly singular and a plain solve floods every output with NaN.
    # OMP's residual is exactly ⊥ span(selected), so a re-picked atom's
    # correlation is ~0: gate on |amp| and PARK the slot (zero atom,
    # identity Gram row ⇒ coef stays 0) instead of regularizing — a ridge
    # would bias the well-posed steps and break the exact-orthogonality
    # property the tests pin at 1e-12.
    amp_tol = 50 * jnp.finfo(x.dtype).eps * jnp.linalg.norm(x, axis=-1)

    # Gram rows from the lag table (see _gram_lag_table) when the signal
    # is long enough that clipped circular lags are unambiguous (table
    # built lazily — only when actually usable).
    s_g = min((wavelet.length - 1) * ((1 << level) - 1) + 1, n)
    use_gram_tab = n >= 2 * s_g
    gram_tab = None
    if use_gram_tab:
        gram_np, s_g = _gram_lag_table(wavelet, level, n)
        gram_tab = jnp.asarray(gram_np, dtype=x.dtype)
    nodes0 = jnp.zeros(batch + (k_tot,), jnp.int32)
    ts0 = jnp.zeros(batch + (k_tot,), jnp.int32)
    live0 = jnp.zeros(batch + (k_tot,), bool)

    from jax.scipy.linalg import solve_triangular

    def obody(carry, k):
        """One OMP pick with an INCREMENTAL Cholesky factor (r4.1).

        The Gram matrix grows by one row/column per step, so maintaining
        ``chol`` with G = chol·cholᵀ (identity-padded like the Gram) needs
        only a rank-1 extension: y = chol⁻¹·row gives the new off-diagonal
        entries (identity padding makes the full-size triangular solve
        return exactly [l_k | g_kk | 0…]), and the pivot is
        l_kk = √(g_kk − ‖l_k‖²).  The joint LS coefficients come from two
        triangular solves — 3 triangular solves/step total, replacing the
        per-step batched LU.  A parked slot's row is e_k ⇒ y = e_k ⇒
        pivot 1: the identity row survives.
        """
        r, buf, chol, b, nodes_a, ts_a, live_a = carry
        node, t, amp = select(r)
        live = (jnp.abs(amp) > amp_tol)[..., None]            # (..., 1)
        atom = _gather_atoms(rev_unit, node, t, n)             # (..., N)
        atom = jnp.where(live, atom, jnp.zeros_like(atom))
        buf = _update_index(buf, atom, k, axis=-2)
        ek = (jnp.arange(k_tot) == k).astype(x.dtype)
        if use_gram_tab:
            # ⟨atom_j, atom_k⟩ = tab[node_j, node_k, (t_j − t_k) + S−1]:
            # K-element gather instead of a full (…, K, N) buffer read
            dt = ts_a - t[..., None]
            dt = (dt + n // 2) % n - n // 2
            idx = jnp.clip(dt, -(s_g - 1), s_g - 1) + (s_g - 1)
            val = gram_tab[nodes_a, node[..., None], idx]
            valid = (live_a & (jnp.abs(dt) < s_g)
                     & (jnp.arange(k_tot) < k) & live)
            row = jnp.where(valid, val, 0.0) + ek   # diag: unit atoms ⇒ 1
        else:
            row = jnp.einsum("...ln,...n->...l", buf, atom,
                             precision=_EXACT)
            # parked slot: keep the identity row's 1 on the diagonal
            row = row + jnp.where(live, 0.0, 1.0) * ek
        nodes_a = _update_index(nodes_a, node.astype(jnp.int32), k, axis=-1)
        ts_a = _update_index(ts_a, t.astype(jnp.int32), k, axis=-1)
        live_a = _update_index(live_a, live[..., 0], k, axis=-1)
        y = solve_triangular(chol, row[..., None], lower=True)[..., 0]
        yk = lax.dynamic_index_in_dim(y, k, axis=y.ndim - 1, keepdims=False)
        # ‖l_k‖² = ‖y‖² − y_k² (entries past k are exactly 0)
        d = yk - (jnp.sum(y * y, axis=-1) - yk * yk)
        pivot = jnp.sqrt(jnp.maximum(d, jnp.finfo(x.dtype).tiny))
        mask = (jnp.arange(k_tot) < k).astype(x.dtype)
        lrow = y * mask + pivot[..., None] * ek
        chol = _update_index(chol, lrow, k, axis=-2)
        b = _update_index(b, jnp.einsum("...n,...n->...", atom, x,
                                          precision=_EXACT), k,
                          axis=-1)
        z = solve_triangular(chol, b[..., None], lower=True)
        coef = solve_triangular(chol, z, lower=True, trans="T")[..., 0]
        r = x - jnp.einsum("...k,...kn->...n", coef, buf,
                           precision=_EXACT)
        return (r, buf, chol, b, nodes_a, ts_a, live_a), (node, t, coef)

    (residual, *_), (nodes, shifts, coefs) = lax.scan(
        obody, (x, buf0, gram0, b0, nodes0, ts0, live0), jnp.arange(k_tot))
    to_last = lambda a: jnp.moveaxis(a, 0, -1)
    # amps = the FINAL joint LS coefficients, aligned with pick order
    return MPResult(to_last(nodes), to_last(shifts), coefs[-1],
                    residual, level, wavelet.name)


def _update_index(a: jax.Array, val: jax.Array, k, axis: int) -> jax.Array:
    """Batched ``a[..., k, :] = val`` (or last-axis) with a traced index."""
    return lax.dynamic_update_index_in_dim(a, val, k, axis=a.ndim + axis
                                           if axis < 0 else axis)


def mp_reconstruct(result: MPResult, wavelet: DiscreteWavelet,
                   n: int | None = None) -> jax.Array:
    """Rebuild ``Σ_k amps[k]·atom(nodes[k], shifts[k])`` → ``(..., N)``.

    ``x ≈ mp_reconstruct(r) + r.residual`` to working precision: the scan's
    windowed subtraction uses the atom's exact finite support while this
    sums full-length gathered atoms, which differ only by the irfft's
    numerical junk (~eps·N) outside the support (on-chip identity 7e-7
    f32, 1e-12 vs the f64 oracle).  ``n`` defaults to the residual length.
    """
    if n is None:
        n = result.residual.shape[-1]
    if isinstance(result.level, jax.core.Tracer):
        raise ValueError(
            "mp_reconstruct under jit needs a static dictionary level: "
            "trace matching_pursuit and mp_reconstruct together, or close "
            "over the level instead of passing it through the jit boundary")
    level = int(result.level)
    rev_np, _ = _atom_tables(wavelet, level, n)
    rev_unit = jnp.asarray(rev_np, dtype=result.amps.dtype)
    atoms = _gather_atoms(rev_unit, result.nodes, result.shifts, n)
    return jnp.einsum("...k,...kn->...n", result.amps, atoms,
                      precision=_EXACT)
