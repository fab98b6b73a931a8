"""Ridge extraction from time-frequency planes (CWT / synchrosqueezed).

The standard companion to :mod:`.ssq`: given a magnitude plane |Tx|(bin, t)
(or a CWT scalogram), find the curve(s) b(t) that maximize energy along the
ridge subject to a smoothness penalty — the penalized-forward/backtrack
dynamic program used by the synchrosqueezing literature (Meignen et al.;
the ``ridge_ext``/``extract_ridges`` tool of the public toolboxes).  The
reference framework has no ridge tier (its CWT stops at scalograms,
``ContinuousWaveletTransform.java``); this extends the capability surface
with the piece that turns sharpened planes into instantaneous-frequency
tracks (mode curves, chirp laws, regime lines).

Formulation:

* The forward pass is a ``lax.scan`` over time of a fixed-shape Bellman
  update: ``E[l, t] = −U[l, t] + min_k (E[k, t−1] + λ·(l−k)²)`` — the
  (L, L) transition penalty is a trace-time constant and the min runs as
  one batched reduction, no data-dependent shapes.
* Backtracking is a second ``lax.scan`` (reverse) over the stored argmin
  tables — int32 throughout, fixed shapes.
* Multiple ridges: extract, mask ``±mask_width`` bins around the found
  curve, repeat (Python loop over ``n_ridges``, unrolled under jit).

Energy convention: ``U = log(|plane|² + eps)`` — log energy makes the
penalty scale-free against amplitude differences between components.
"""
from __future__ import annotations

import functools
import typing

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["RidgeResult", "extract_ridges"]


class RidgeResult(typing.NamedTuple):
    """Extracted ridges.

    ``indices``: (..., n_ridges, N) int32 — bin index per time step.
    ``frequencies``: (..., n_ridges, N) — bin frequency (or scale) values if
    an axis was provided, else a float copy of ``indices``.
    ``energy``: (..., n_ridges) — mean log-energy along each ridge (ridges
    come out strongest-first).
    """

    indices: jax.Array
    frequencies: jax.Array
    energy: jax.Array


def _ridge_once(u, penalty_mat):
    """Single-plane DP: u (L, N) log-energy → (N,) int32 ridge."""
    l, n = u.shape

    def fwd(e_prev, u_t):
        # cost[k, l] = e_prev[k] + penalty[k, l]
        tot = e_prev[:, None] + penalty_mat
        best = jnp.min(tot, axis=0)
        arg = jnp.argmin(tot, axis=0).astype(jnp.int32)
        return best - u_t, arg

    e0 = -u[:, 0]
    e_final, args = lax.scan(fwd, e0, u[:, 1:].T)  # args: (N-1, L)

    end = jnp.argmin(e_final).astype(jnp.int32)

    def back(carry, a_t):
        nxt = a_t[carry]
        return nxt, nxt

    _, path_rev = lax.scan(back, end, args, reverse=True)
    return jnp.concatenate([path_rev, end[None]], axis=0)  # (N,)


@functools.partial(jax.jit, static_argnames=("n_ridges", "penalty",
                                             "mask_width"))
def _extract_impl(u, n_ridges, penalty, mask_width):
    l, n = u.shape[-2], u.shape[-1]
    # scale-free penalty: λ·(Δbin)² normalized by the bin count so the same
    # λ behaves alike across grid resolutions
    dl = jnp.arange(l, dtype=u.dtype)
    pen = penalty * ((dl[:, None] - dl[None, :]) / l) ** 2 * l

    def plane(u2):
        cur = u2
        idxs = []
        energies = []
        for _ in range(n_ridges):
            p = _ridge_once(cur, pen)
            idxs.append(p)
            energies.append(jnp.mean(cur[p, jnp.arange(n)]))
            band = jnp.abs(jnp.arange(l)[:, None] - p[None, :]) <= mask_width
            cur = jnp.where(band, -jnp.inf, cur)
        return jnp.stack(idxs), jnp.stack(energies)

    fn = plane
    for _ in range(u.ndim - 2):
        fn = jax.vmap(fn)
    return fn(u)


def extract_ridges(plane, axis_values=None, n_ridges: int = 1,
                   penalty: float = 2.0, mask_width: int = 2,
                   eps: float = 1e-12) -> RidgeResult:
    """Extract ``n_ridges`` smooth maximum-energy curves from ``plane``.

    ``plane``: (..., L, N) — complex or real coefficients over (bin, time);
    pass ``SSQResult.Tx``, ``CWTResult.coefficients``, or any magnitude
    plane.  ``axis_values``: optional (L,) bin→frequency (or scale) map used
    to fill ``RidgeResult.frequencies`` (e.g. ``SSQResult.ssq_freqs``).
    ``penalty``: smoothness weight λ of the (Δbin/L)²·L transition cost —
    0 reduces to per-column argmax; larger values rigidify the curve.
    ``mask_width``: bins zeroed on each side of an extracted ridge before
    searching for the next one.

    Jits and batches over leading axes; fixed shapes throughout (the DP is
    a ``lax.scan`` Bellman recursion, see module docstring).
    """
    plane = jnp.asarray(plane)
    if jnp.issubdtype(plane.dtype, jnp.complexfloating):
        mag2 = jnp.real(plane) ** 2 + jnp.imag(plane) ** 2
    else:
        mag2 = plane.astype(jnp.result_type(plane.dtype, jnp.float32)) ** 2
    u = jnp.log(mag2 + eps)
    if plane.ndim < 2:
        raise ValueError("plane must have shape (..., bins, time)")
    if not 1 <= int(n_ridges) <= plane.shape[-2]:
        raise ValueError(f"n_ridges must be in [1, {plane.shape[-2]}]")
    if (int(n_ridges) - 1) * (2 * int(mask_width) + 1) >= plane.shape[-2]:
        raise ValueError(
            f"n_ridges={n_ridges} with mask_width={mask_width} can mask all "
            f"{plane.shape[-2]} bins before the last ridge is extracted; "
            f"reduce one of them")
    idx, energy = _extract_impl(u, int(n_ridges), float(penalty),
                                int(mask_width))
    if axis_values is not None:
        vals = jnp.asarray(axis_values)
        freqs = vals[idx]
    else:
        freqs = idx.astype(u.dtype)
    return RidgeResult(indices=idx, frequencies=freqs, energy=energy)
