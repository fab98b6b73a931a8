"""Sharded transforms: signal-axis MODWT/conv via ppermute halo exchange,
scale-sharded CWT, packet-sharded WPT, batch-parallel everything.

This is the tier the reference lacks entirely (its "distributed backend" is
a shared-memory ForkJoinPool, SURVEY §5.8).  Mapping:

  * batch axes: just ``NamedSharding`` — jit inserts no collectives.
  * signal axis (long 1D series): each chip holds a contiguous shard; the
    à-trous circular convolution of level j needs ``(M−1)·2^(j−1)`` samples
    of left context from the circularly-previous shard — fetched with
    ``lax.ppermute`` ring hops (the signal analog of context/ring
    parallelism).  Level depth is bounded so the halo fits in a few hops.
  * CWT scales / WPT packets: independent subproblems → shard the axis,
    zero communication in the kernel (the reference's P1/P2 strategies).

All functions take an explicit ``Mesh`` and work under ``jit`` with a
``shard_map`` body; XLA hands the collectives to NCCL on GPUs (NVLink
between the cards of one host).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from ..ops.cwt import CWTResult, cwt as _cwt
from ..ops.modwt import _check_level, modwt_base_filters
from ..wavelets.base import DiscreteWavelet

__all__ = [
    "modwt_sharded", "imodwt_sharded", "cwt_sharded", "cwt_signal_sharded",
    "cwt2_sharded", "wpt_sharded", "iwpt_sharded", "fwt2_sharded",
    "fwt_sharded", "ifwt_sharded", "gather_fwt_layout",
    "modwpt_sharded", "imodwpt_sharded",
    "scattering_sharded", "scattering2d_sharded", "ssq_sharded",
    "modwt2_sharded", "imodwt2_sharded", "dtcwt_sharded", "idtcwt_sharded",
]


def _left_context(x_shard, halo: int, axis_name: str):
    """Fetch ``halo`` samples of circular left context along a ring axis.

    Generalizes to halos larger than one shard with multiple ppermute hops:
    after hop t the device holds the previous (t+1) shards' tails.
    """
    n_dev = lax.axis_size(axis_name)
    s = x_shard.shape[-1]
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    pieces = []
    got = 0
    send = x_shard
    while got < halo:
        send = lax.ppermute(send, axis_name, perm)
        take = min(halo - got, s)
        pieces.append(send[..., s - take:])
        got += take
        # For multi-hop halos, keep forwarding the *original* shard of the
        # sender chain: after hop t, `send` holds shard (i-t); its tail is
        # the context at distance t.
    # pieces[t] is the tail of shard (i-t-1): nearest context first → the
    # full left context in signal order is [piece_last, ..., piece_0]
    return jnp.concatenate(list(reversed(pieces)), axis=-1)[..., -halo:]


def _right_context(x_shard, halo: int, axis_name: str):
    n_dev = lax.axis_size(axis_name)
    s = x_shard.shape[-1]
    perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    pieces = []
    got = 0
    send = x_shard
    while got < halo:
        send = lax.ppermute(send, axis_name, perm)
        take = min(halo - got, s)
        pieces.append(send[..., :take])
        got += take
    return jnp.concatenate(pieces, axis=-1)[..., :halo]


def _halo_conv(x, f, d, axis_name, adjoint=False):
    """Dilated circular conv along the sharded LAST axis: local slices +
    ring halo exchange.

    Forward: y[n] = Σ_k f[k]·x[n − k·d] (needs left context);
    adjoint:  y[n] = Σ_k f[k]·x[n + k·d] (right context).
    """
    m = f.shape[0]
    halo = (m - 1) * d
    if adjoint:
        ctx = _right_context(x, halo, axis_name)
        xe = jnp.concatenate([x, ctx], axis=-1)
        base = 0
    else:
        ctx = _left_context(x, halo, axis_name)
        xe = jnp.concatenate([ctx, x], axis=-1)
        base = halo
    s = x.shape[-1]
    acc = None
    for k in range(m):
        off = base + (k * d if adjoint else -k * d)
        seg = lax.slice_in_dim(xe, off, off + s, axis=-1)
        t = f[k] * seg
        acc = t if acc is None else acc + t
    return acc


def _dilated_conv_shard(v, g, h, d, axis_name, adjoint=False, w=None):
    """One sharded MODWT level: the (g, h) filter pair via :func:`_halo_conv`."""
    out_v = _halo_conv(v, g, d, axis_name, adjoint)
    out_w = _halo_conv(v if w is None else w, h, d, axis_name, adjoint)
    return out_v, out_w


def _modwt_shard_body(x, g, h, level, axis_name):
    rows = []
    v = x
    for j in range(1, level + 1):
        d = 1 << (j - 1)
        v, w = _dilated_conv_shard(v, g, h, d, axis_name)
        rows.append(w)
    rows.append(v)
    return jnp.stack(rows, axis=0)


def _imodwt_shard_body(c, g, h, axis_name):
    level = c.shape[0] - 1
    v = c[level]
    for j in range(level, 0, -1):
        d = 1 << (j - 1)
        va, wa = _dilated_conv_shard(v, g, h, d, axis_name, adjoint=True,
                                     w=c[j - 1])
        v = va + wa
    return v


def _specs(mesh: Mesh, ndim: int, signal_axis: str, batch_axis: str | None):
    """PartitionSpec for (..., N) data: batch on leading, signal on last."""
    names = [None] * ndim
    if batch_axis and batch_axis in mesh.axis_names and ndim > 1:
        names[0] = batch_axis
    names[-1] = signal_axis
    return P(*names)


def modwt_sharded(x, wavelet: DiscreteWavelet, level: int, mesh: Mesh,
                  signal_axis: str = "signal", batch_axis: str = "data"):
    """Forward MODWT with the signal axis sharded across ``mesh``.

    Output layout matches :func:`ops.modwt.modwt`: ``(level+1, ..., N)``
    with the last axis still sharded.  Per level the only communication is
    one ring ppermute of ``(M−1)·2^(j−1)`` halo samples.
    """
    x = jnp.asarray(x)
    _check_level(x.shape[-1], level)
    g64, h64 = modwt_base_filters(wavelet)
    g = jnp.asarray(g64, dtype=x.dtype)
    h = jnp.asarray(h64, dtype=x.dtype)
    in_spec = _specs(mesh, x.ndim, signal_axis, batch_axis)
    out_spec = P(None, *in_spec)

    n_shard = x.shape[-1] // mesh.shape[signal_axis]
    max_halo = (g64.shape[0] - 1) * (1 << (level - 1))
    if n_shard < 1 or max_halo > n_shard * mesh.shape[signal_axis]:
        raise ValueError("halo exceeds total signal length")

    body = functools.partial(_modwt_shard_body, level=level,
                             axis_name=signal_axis)
    fn = shard_map(lambda v: body(v, g, h),
                   mesh=mesh, in_specs=(in_spec,), out_specs=out_spec)
    return fn(x)


def imodwt_sharded(c, wavelet: DiscreteWavelet, mesh: Mesh,
                   signal_axis: str = "signal", batch_axis: str = "data"):
    """Inverse MODWT with the signal axis sharded across ``mesh``."""
    c = jnp.asarray(c)
    g64, h64 = modwt_base_filters(wavelet)
    g = jnp.asarray(g64, dtype=c.dtype)
    h = jnp.asarray(h64, dtype=c.dtype)
    inner = _specs(mesh, c.ndim - 1, signal_axis, batch_axis)
    in_spec = P(None, *inner)
    fn = shard_map(lambda v: _imodwt_shard_body(v, g, h, signal_axis),
                   mesh=mesh, in_specs=(in_spec,), out_specs=inner)
    return fn(c)


def cwt_sharded(x, scales, wavelet, mesh: Mesh, sampling_rate: float = 1.0,
                scale_axis: str = "scale", batch_axis: str = "data",
                padding: str = "zero") -> CWTResult:
    """CWT with the scale axis sharded (reference strategy P2, zero comms).

    The signal FFT is computed per device (cheap, amortized over its local
    scales); each device evaluates only its shard of ψ̂(a·ω) products.
    """
    import numpy as np

    x = jnp.asarray(x)
    scales_np = np.atleast_1d(np.asarray(scales, dtype=float))
    n_dev = mesh.shape[scale_axis]
    if scales_np.shape[0] % n_dev:
        raise ValueError(f"n_scales {scales_np.shape[0]} not divisible by "
                         f"mesh axis {scale_axis}={n_dev}")
    # shard_map over the scale axis: each device FFTs the (replicated)
    # signal once and evaluates only its local shard of ψ̂(a·ω) products —
    # exactly the reference's per-thread work split (P2) over chips.
    bspec = [None] * x.ndim
    if batch_axis in mesh.axis_names and x.ndim > 1:
        bspec[0] = batch_axis
    lead = bspec[:-1]  # batch dims of x (last dim = signal, replicated)

    def body(xl, scales_l):
        return _cwt(xl, scales_l, wavelet, sampling_rate,
                    padding).coefficients

    fn = shard_map(body, mesh=mesh,
                   in_specs=(P(*bspec), P(scale_axis)),
                   out_specs=P(*lead, scale_axis, None))
    coeffs = fn(x, jnp.asarray(scales_np))
    dt = 1.0 / sampling_rate
    time_axis = jnp.asarray(np.arange(x.shape[-1]) * dt)
    return CWTResult(coeffs, jnp.asarray(scales_np), time_axis,
                     sampling_rate, wavelet.name)


def cwt_signal_sharded(x, scales, wavelet, mesh: Mesh,
                       sampling_rate: float = 1.0,
                       signal_axis: str = "signal",
                       batch_axis: str = "data", padding: str = "zero",
                       halo: int | None = None,
                       halo_factor: float = 2.0,
                       check_aliasing: bool = True) -> CWTResult:
    """CWT of a LONG signal with the time axis sharded: overlap-save blocks.

    The long-signal path SURVEY §5.7 calls for (the reference's nearest
    mechanisms are CWT pow-2 padding and chunked-MODWT callbacks): the CWT
    is a per-scale convolution, so each device can transform its contiguous
    block independently given ``halo`` samples of context from the ring
    neighbors — `lax.ppermute` hops (multi-hop when the halo
    exceeds a shard), then the standard FFT CWT on the extended block, then
    a central crop.  Zero collectives besides the halo exchange; per-device
    FFT cost scales with N/n_dev + 2·halo instead of N.

    ``halo`` defaults to ``max(scales) ·`` the wavelet's unit-scale
    effective support radius (``ContinuousWavelet.effectiveSupport``
    conventions) ``· halo_factor``.  The block result matches the
    single-device periodic-padding CWT up to the wavelet's *integrated*
    amplitude beyond the halo; the support-radius conventions put ~1e-7
    pointwise amplitude at the edge, which integrates to ~1e-4 absolute
    error, so the default ``halo_factor=2.0`` doubles the radius (≤1e-14
    for the Gaussian-envelope families — measured, Morlet fb=1, scale 64).
    Lower it toward 1.0 to shrink the exchanged context when a few
    relative digits suffice.  Output coefficients (..., S, N) keep the
    time axis sharded.

    Small-scale caveat: overlap-save assumes the effective kernel is
    compactly supported, but a scale whose ψ̂(a·ω) is still non-negligible
    at the Nyquist truncation acquires slowly-decaying (≈1/t) sinc tails
    from the hard spectral cutoff, which no practical halo covers — those
    scales are already aliased in ANY discrete CWT and their block result
    would silently differ from the single-device one.  By default this
    function rejects scales with relative |ψ̂| at Nyquist above 1e-3
    (for the default Morlet that means a ≳ 4.4 at fs = 1); pass
    ``check_aliasing=False`` to accept the (self-consistent, per-block)
    small-scale output anyway.
    """
    import numpy as np

    x = jnp.asarray(x)
    scales_np = np.atleast_1d(np.asarray(scales, dtype=float))
    n = x.shape[-1]
    n_dev = mesh.shape[signal_axis]
    if n % n_dev:
        raise ValueError(f"signal length {n} not divisible by mesh axis "
                         f"{signal_axis}={n_dev}")
    nloc = n // n_dev
    if halo is None:
        lo, hi = wavelet.effective_support()
        halo = int(np.ceil(float(scales_np.max()) * max(abs(lo), abs(hi))
                           * halo_factor))
    halo = min(halo, n - nloc)  # context beyond the rest of the ring is moot
    if halo >= n:
        raise ValueError("halo exceeds total signal length")

    if check_aliasing:
        import math

        # host-side: per-scale |√a·ψ̂(a·ω)| on a coarse grid up to Nyquist.
        # local_devices, not devices: under jax.distributed the global
        # device list starts with process 0's devices, and fetching a value
        # computed on another process's device raises (caught by the
        # 2-process full battery, tools/distributed_smoke.py --full).
        grid = np.linspace(0.0, math.pi * sampling_rate, 257)[None, :]
        with jax.ensure_compile_time_eval(), \
                jax.default_device(jax.local_devices(backend="cpu")[0]):
            amp = np.abs(np.asarray(wavelet.psi_hat_scaled(
                jnp.asarray(grid), jnp.asarray(scales_np[:, None]))))
        nyq_rel = amp[:, -1] / np.maximum(amp.max(axis=-1), 1e-300)
        bad = scales_np[nyq_rel > 1e-3]
        if bad.size:
            raise ValueError(
                f"scales {bad} are Nyquist-aliased (relative |ψ̂(a·π·fs)| > "
                f"1e-3): their spectral-truncation tails exceed any block "
                f"halo.  Drop them or pass check_aliasing=False.")

    if not jnp.issubdtype(x.dtype, jnp.complexfloating):
        # Pre-warm the host-side ψ̂ multiplier cache for the extended block
        # length: inside shard_map everything is traced, and the eager
        # host evaluation in _half_spectrum_multipliers cannot run there —
        # with the cache warm the body is a pure lookup.
        from ..ops.cwt import _half_spectrum_multipliers
        from ..utils.validation import next_power_of_two
        _half_spectrum_multipliers(wavelet,
                                   tuple(float(s) for s in scales_np),
                                   next_power_of_two(nloc + 2 * halo),
                                   float(sampling_rate))

    def body(xl):
        if halo > 0:
            lctx = _left_context(xl, halo, signal_axis)
            rctx = _right_context(xl, halo, signal_axis)
            xe = jnp.concatenate([lctx, xl, rctx], axis=-1)
        else:
            xe = xl
        c = _cwt(xe, scales_np, wavelet, sampling_rate, padding).coefficients
        return c[..., halo:halo + nloc]

    bspec = [None] * (x.ndim - 1)
    if batch_axis in mesh.axis_names and x.ndim > 1:
        bspec[0] = batch_axis
    in_spec = P(*bspec, signal_axis)
    out_spec = P(*bspec, None, signal_axis)
    coeffs = shard_map(body, mesh=mesh, in_specs=(in_spec,),
                       out_specs=out_spec)(x)
    dt = 1.0 / sampling_rate
    time_axis = jnp.asarray(np.arange(n) * dt)
    return CWTResult(coeffs, jnp.asarray(scales_np), time_axis,
                     sampling_rate, wavelet.name)


def cwt2_sharded(x, scales, wavelet=None, mesh: Mesh | None = None,
                 angles=None, sampling_rate: float = 1.0,
                 scale_axis: str = "scale", batch_axis: str = "data"):
    """2D CWT with the (scale × angle) plane axis sharded (P2 analog, 2D).

    The multiplier stack conj(a·ψ̂(a·r_{−θ}k)) is host-precomputed once
    (static scales/angles, exactly as :func:`..ops.cwt2d.cwt2`) and fed in
    SHARDED over its plane axis — each device FFTs its (replicated or
    batch-sharded) image locally and inverse-transforms only its local
    planes.  Zero collectives in the body; output planes land sharded.
    """
    import numpy as np

    from ..ops.cwt2d import CWT2Result, _multipliers2d
    from ..wavelets.continuous2d import MexicanHat2D

    if wavelet is None:
        wavelet = MexicanHat2D()
    if mesh is None:
        raise ValueError("cwt2_sharded needs an explicit Mesh")
    x = jnp.asarray(x)
    if x.ndim < 2:
        raise ValueError("cwt2_sharded needs at least a (H, W) image")
    h, w = x.shape[-2], x.shape[-1]
    scales_np = np.atleast_1d(np.asarray(scales, dtype=np.float64))
    angles_np = (None if angles is None
                 else np.atleast_1d(np.asarray(angles, dtype=np.float64)))
    scales_t = tuple(float(a) for a in scales_np)
    angles_t = (None if angles_np is None
                else tuple(float(t) for t in angles_np))
    n_planes = len(scales_t) * (1 if angles_t is None else len(angles_t))
    n_dev = mesh.shape[scale_axis]
    if n_planes % n_dev:
        raise ValueError(f"(scales × angles) = {n_planes} planes not "
                         f"divisible by mesh axis {scale_axis}={n_dev}")
    use_real = wavelet.real_even_hat and not jnp.issubdtype(
        x.dtype, jnp.complexfloating)
    m_np = _multipliers2d(wavelet, scales_t, angles_t, h, w,
                          float(sampling_rate), use_real)
    f64 = x.dtype in (jnp.float64, jnp.complex128)
    cdtype = jnp.complex128 if f64 else jnp.complex64
    rdtype = jnp.float64 if f64 else jnp.float32
    # real-even ψ̂ stacks stay REAL (half the bytes, 2 vs 4 real multiplies)
    mult = jnp.asarray(m_np).astype(rdtype if use_real else cdtype)

    bspec = [None] * x.ndim
    if batch_axis in mesh.axis_names and x.ndim > 2:
        bspec[0] = batch_axis
    lead = bspec[:-2]  # (H, W) replicated on the last two dims

    if use_real:
        def body(xl, ml):
            xf = jnp.fft.rfft2(xl, axes=(-2, -1))[..., None, :, :]
            return jnp.fft.irfft2(xf * ml, s=(h, w),
                                  axes=(-2, -1)).astype(rdtype)
    else:
        def body(xl, ml):
            xf = jnp.fft.fft2(xl.astype(cdtype),
                              axes=(-2, -1))[..., None, :, :]
            return jnp.fft.ifft2(xf * ml, axes=(-2, -1))

    fn = shard_map(body, mesh=mesh,
                   in_specs=(P(*bspec), P(scale_axis, None, None)),
                   out_specs=P(*lead, scale_axis, None, None))
    coeff = fn(x, mult)
    leadshape = x.shape[:-2]
    if angles_t is None:
        coeff = coeff.reshape(leadshape + (len(scales_t), h, w))
        angles_arr = None
    else:
        coeff = coeff.reshape(leadshape + (len(scales_t), len(angles_t),
                                           h, w))
        angles_arr = jnp.asarray(angles_np).astype(rdtype)
    return CWT2Result(coeff, jnp.asarray(scales_np).astype(rdtype),
                      angles_arr, sampling_rate, wavelet.name)


def _wpt_subtree_body(xl, wavelet, level, k, n_dev, axis_name):
    """shard_map body: replicated levels 1..k, then a purely-local subtree.

    ``xl`` is the full (replicated) signal on every device.  The first ``k``
    levels run identically everywhere (they are the only levels whose
    packets span devices); each device then slices the level-k packet it
    owns — by ``lax.axis_index`` — and runs the remaining ``level − k``
    levels on that 1/n_dev-length segment only.  No collective ops at all:
    the locality test pins this on the compiled HLO.
    """
    from ..ops.wpt import wpt as _wpt

    n = xl.shape[-1]
    y = _wpt(xl, wavelet, k) if k else xl
    seg = n // n_dev
    idx = lax.axis_index(axis_name)
    local = lax.dynamic_slice_in_dim(y, idx * seg, seg, axis=-1)
    if level > k:
        local = _wpt(local, wavelet, level - k)
    return local


def _iwpt_subtree_body(yl, wavelet, level, k, n_dev, axis_name):
    """Inverse: local subtree inverse, one all-gather, replicated top.

    Every device computes the same top-k inverse after the gather and
    returns its own slice (out_spec reassembles the global layout without a
    replication proof)."""
    from ..ops.wpt import iwpt as _iwpt

    seg = yl.shape[-1]
    if level > k:
        yl = _iwpt(yl, wavelet, level - k)
    full = lax.all_gather(yl, axis_name, axis=yl.ndim - 1, tiled=True)
    if k:
        full = _iwpt(full, wavelet, k)
    idx = lax.axis_index(axis_name)
    return lax.dynamic_slice_in_dim(full, idx * seg, seg, axis=-1)


def wpt_sharded(x, wavelet: DiscreteWavelet, level: int, mesh: Mesh,
                packet_axis: str = "scale", batch_axis: str = "data"):
    """WPT with the packet subtrees distributed across chips.

    The honest analog of reference strategy P1 (ForkJoinPool work-stealing
    over packets, ``ParallelWaveletPacketTransform.java:188-263``): levels
    1..k (k = log2(n_dev)) are replicated — their packets span devices —
    and every deeper level runs on each device's own contiguous level-k
    packet with **zero communication** (tests assert the compiled HLO
    contains no collectives).  Output is the usual flat WPT layout with the
    last axis sharded over ``packet_axis``.
    """
    x = jnp.asarray(x)
    n_dev = mesh.shape[packet_axis]
    if n_dev & (n_dev - 1):
        raise ValueError(f"packet mesh axis must be a power of two, "
                         f"got {n_dev}")
    n = x.shape[-1]
    if n % n_dev:
        raise ValueError("signal length not divisible by packet mesh axis")
    k = n_dev.bit_length() - 1
    if level < k and n_dev > 1:
        # fewer tree levels than devices: still distribute storage at the
        # deepest level computed (packets remain whole per device only when
        # 2^level ≥ n_dev; fall back to k = level → pure slice distribution)
        k = level

    bspec = [None] * (x.ndim - 1)
    if batch_axis in mesh.axis_names and x.ndim > 1:
        bspec[0] = batch_axis
    in_spec = P(*bspec, None)          # signal replicated
    out_spec = P(*bspec, packet_axis)  # packets sharded

    body = functools.partial(_wpt_subtree_body, wavelet=wavelet, level=level,
                             k=k, n_dev=n_dev, axis_name=packet_axis)
    return shard_map(body, mesh=mesh, in_specs=(in_spec,),
                     out_specs=out_spec)(x)


def iwpt_sharded(y, wavelet: DiscreteWavelet, level: int, mesh: Mesh,
                 packet_axis: str = "scale", batch_axis: str = "data"):
    """Inverse of :func:`wpt_sharded` (packet-sharded in, replicated out).

    The deep (local) levels invert with zero communication; one tiled
    ``all_gather`` reassembles the level-k row before the replicated top-k
    inverse — the only collective in the compiled program.
    """
    y = jnp.asarray(y)
    n_dev = mesh.shape[packet_axis]
    if n_dev & (n_dev - 1):
        raise ValueError(f"packet mesh axis must be a power of two, "
                         f"got {n_dev}")
    if y.shape[-1] % n_dev:
        raise ValueError("signal length not divisible by packet mesh axis")
    k = min(n_dev.bit_length() - 1, level)

    bspec = [None] * (y.ndim - 1)
    if batch_axis in mesh.axis_names and y.ndim > 1:
        bspec[0] = batch_axis
    in_spec = P(*bspec, packet_axis)
    out_spec = P(*bspec, packet_axis)

    body = functools.partial(_iwpt_subtree_body, wavelet=wavelet,
                             level=level, k=k, n_dev=n_dev,
                             axis_name=packet_axis)
    return shard_map(body, mesh=mesh, in_specs=(in_spec,),
                     out_specs=out_spec)(y)


def _modwpt_local_levels(local, g, h, k, level, axis_name, method):
    """Run MODWPT levels k+1..level on this device's level-k node.

    Sequency bookkeeping under sharding: descendants of a level-k node form
    a CONTIGUOUS sequency block (the per-level reorder only swaps sibling
    pairs), so every deeper level is local.  The filter-assignment rule
    (global node n: g̃ when n mod 4 ∈ {0,3}) is static for levels ≥ k+2
    (the local block size ≥ 4 makes n mod 4 local) but depends on the
    *device index's parity* at the first local level (2 children, global
    indices 2·idx, 2·idx+1) — resolved with one traced pair-swap select.
    """
    from ..ops.modwpt import _level_forward
    from ..ops.modwt import _level_conv

    for j in range(k + 1, level + 1):
        p = local.shape[0]
        if p > 1:
            local = _level_forward(local, g, h, j, method)
            continue
        gv, hv = _level_conv(local, g, h, j, method)
        nat = jnp.concatenate([gv, hv], axis=0)          # (2, ..., N)
        odd = (lax.axis_index(axis_name) % 2).astype(bool)
        local = jnp.where(odd, nat[::-1], nat)
    return local


def _modwpt_subtree_body(xl, wavelet, level, k, axis_name, method):
    """shard_map body: replicated levels 1..k, then a purely-local subtree."""
    from ..ops.modwpt import _level_forward

    g, h = modwt_base_filters(wavelet)
    nodes = xl[jnp.newaxis]
    for j in range(1, k + 1):
        nodes = _level_forward(nodes, g, h, j, method)
    if k:
        idx = lax.axis_index(axis_name)
        nodes = lax.dynamic_slice_in_dim(nodes, idx, 1, axis=0)
    return _modwpt_local_levels(nodes, g, h, k, level, axis_name, method)


def _imodwpt_subtree_body(yl, wavelet, level, k, n_dev, axis_name, method):
    """Inverse: local subtree adjoints, ONE all-gather at level k, then the
    replicated top-k inverse; returns this device's signal slice."""
    from ..ops.modwpt import _level_inverse
    from ..ops.modwt import _combined_adjoint, _level_conv, _use_fft

    g, h = modwt_base_filters(wavelet)
    local = yl
    for j in range(level, k, -1):
        p2 = local.shape[0]
        if p2 > 2:
            local = _level_inverse(local, g, h, j, method)
            continue
        odd = (lax.axis_index(axis_name) % 2).astype(bool)
        nat = jnp.where(odd, local[::-1], local)
        child_g, child_h = nat[0:1], nat[1:2]
        if _use_fft(method, local.shape[-1], g.shape[0], 1 << (j - 1)):
            va, wa = _level_conv(child_g, g, h, j, method, adjoint=True,
                                 w=child_h)
            local = va + wa
        else:
            local = _combined_adjoint(
                child_g, child_h, jnp.asarray(g, dtype=local.dtype),
                jnp.asarray(h, dtype=local.dtype), 1 << (j - 1))
    if k:
        full = lax.all_gather(local, axis_name, axis=0, tiled=True)
        for j in range(k, 0, -1):
            full = _level_inverse(full, g, h, j, method)
        local = full
    sig = local[0]
    seg = sig.shape[-1] // n_dev
    idx = lax.axis_index(axis_name)
    return lax.dynamic_slice_in_dim(sig, idx * seg, seg, axis=-1)


def modwpt_sharded(x, wavelet: DiscreteWavelet, level: int, mesh: Mesh,
                   node_axis: str = "scale", batch_axis: str = "data",
                   method: str = "direct"):
    """MODWPT with the packet-node subtrees distributed across chips.

    The shift-invariant counterpart of :func:`wpt_sharded` (reference
    strategy P1, ``ParallelWaveletPacketTransform.java:188-263``): levels
    1..k (k = log2(n_dev)) are replicated, then each device owns ONE
    level-k node and computes its whole subtree — a contiguous sequency
    block — with **zero communication**.  Output ``(2^level, ..., N)`` has
    the node axis sharded over ``node_axis``.  Requires
    ``level ≥ log2(n_dev)``.
    """
    x = jnp.asarray(x)
    n_dev = mesh.shape[node_axis]
    if n_dev & (n_dev - 1):
        raise ValueError(f"node mesh axis must be a power of two, "
                         f"got {n_dev}")
    k = n_dev.bit_length() - 1
    if level < k:
        raise ValueError(
            f"MODWPT level {level} must be ≥ log2(n_dev)={k} to give every "
            "device a whole subtree")
    _check_level(x.shape[-1], level)

    bspec = [None] * x.ndim
    if batch_axis in mesh.axis_names and x.ndim > 1:
        bspec[0] = batch_axis
    in_spec = P(*bspec)
    out_spec = P(node_axis, *bspec)

    body = functools.partial(_modwpt_subtree_body, wavelet=wavelet,
                             level=level, k=k, axis_name=node_axis,
                             method=method)
    return shard_map(body, mesh=mesh, in_specs=(in_spec,),
                     out_specs=out_spec)(x)


def imodwpt_sharded(y, wavelet: DiscreteWavelet, mesh: Mesh,
                    node_axis: str = "scale", batch_axis: str = "data",
                    method: str = "direct"):
    """Inverse of :func:`modwpt_sharded` (node-sharded in, signal out).

    Local subtrees invert with zero communication; one tiled ``all_gather``
    reassembles the 2^k level-k nodes before the replicated top-k adjoint —
    the only collective in the compiled program.  The signal length must be
    divisible by n_dev (the output is returned slice-distributed and
    reassembled by the out sharding).
    """
    y = jnp.asarray(y)
    p = y.shape[0]
    if p < 2 or p & (p - 1):
        raise ValueError(
            f"leading axis must be 2^level ≥ 2 packet nodes, got {p}")
    level = p.bit_length() - 1
    n_dev = mesh.shape[node_axis]
    if n_dev & (n_dev - 1):
        raise ValueError(f"node mesh axis must be a power of two, "
                         f"got {n_dev}")
    k = n_dev.bit_length() - 1
    if level < k:
        raise ValueError(
            f"MODWPT level {level} must be ≥ log2(n_dev)={k}")
    if y.shape[-1] % n_dev:
        raise ValueError("signal length not divisible by node mesh axis")

    bspec = [None] * (y.ndim - 2)
    if batch_axis in mesh.axis_names and y.ndim > 2:
        bspec[0] = batch_axis
    in_spec = P(node_axis, *bspec, None)
    out_spec = P(*bspec, node_axis)

    body = functools.partial(_imodwpt_subtree_body, wavelet=wavelet,
                             level=level, k=k, n_dev=n_dev,
                             axis_name=node_axis, method=method)
    return shard_map(body, mesh=mesh, in_specs=(in_spec,),
                     out_specs=out_spec)(y)


def fwt2_sharded(m, wavelet: DiscreteWavelet, mesh: Mesh,
                 batch_axis: str = "data"):
    """2D FWT with rows data-parallel across the mesh (reference P4).

    Rows transform with rows sharded; the transpose before the column pass
    is an XLA all-to-all.
    """
    from ..ops.fwt import fwt2 as _fwt2

    m = jnp.asarray(m)
    m = jax.device_put(
        m, NamedSharding(mesh, P(*([None] * (m.ndim - 2)), batch_axis, None)))
    return _fwt2(m, wavelet)


# ---------------------------------------------------------------------------
# Signal-sharded FWT: decimating pyramid with per-level ring halo exchange.
# ---------------------------------------------------------------------------

def _local_analysis(active, ctx, wavelet):
    """Non-circular analysis of a local segment with right context.

    lo[i] = Σ_j ext[2i+j]·g[j] with ext = [active | ctx]; valid for all
    i < len(active)/2 because len(ctx) = M−2 (no wrap ever needed).
    """
    import numpy as np

    h = active.shape[-1]
    m = wavelet.length
    ext = jnp.concatenate([active, ctx], axis=-1)
    g = np.asarray(wavelet.dec_lo, dtype=active.dtype)
    f = np.asarray(wavelet.dec_hi, dtype=active.dtype)
    lo = hi = None
    for j in range(m):
        # strided slice yielding exactly h/2 entries: indices j, j+2, …, j+h−2
        seg = lax.slice_in_dim(ext, j, j + h - 1, stride=2, axis=-1)
        tl = g[j] * seg
        th = f[j] * seg
        lo = tl if lo is None else lo + tl
        hi = th if hi is None else hi + th
    return lo, hi


def _local_synthesis(lo, hi, lo_ctx, hi_ctx, wavelet):
    """Adjoint of :func:`_local_analysis` with left context.

    x[k] = Σ_{i,j: 2i+j = k} lo[i]·rl[j] + hi[i]·rh[j] where i may reach
    ⌈(M−1)/2⌉ entries into the left neighbor (lo_ctx/hi_ctx, newest last).
    """
    import numpy as np

    half = lo.shape[-1]
    c = lo_ctx.shape[-1]
    m = wavelet.length
    rl = np.asarray(wavelet.rec_lo, dtype=lo.dtype)
    rh = np.asarray(wavelet.rec_hi, dtype=lo.dtype)
    lo_e = jnp.concatenate([lo_ctx, lo], axis=-1)
    hi_e = jnp.concatenate([hi_ctx, hi], axis=-1)
    # Scatter computed as gather: x[k] = Σ_j r[j]·y[(k−j)/2] where parity
    # matches (j ≡ k mod 2).  For k = j%2 + 2t: y index = t − j//2, i.e.
    # slice of the left-extended y starting at c − j//2.  Accumulate the two
    # output phases separately and interleave at the end.
    even = odd = None
    for j in range(m):
        start = c - j // 2
        seg_lo = lax.slice_in_dim(lo_e, start, start + half, axis=-1)
        seg_hi = lax.slice_in_dim(hi_e, start, start + half, axis=-1)
        contrib = rl[j] * seg_lo + rh[j] * seg_hi  # values at k = j%2 + 2t
        if j % 2 == 0:
            even = contrib if even is None else even + contrib
        else:
            odd = contrib if odd is None else odd + contrib
    if odd is None:
        odd = jnp.zeros_like(even)
    res = jnp.stack([even, odd], axis=-1).reshape(lo.shape[:-1] + (2 * half,))
    if wavelet.energy_correction != 1.0:
        res = res * jnp.asarray(wavelet.energy_correction, dtype=lo.dtype)
    return res


def fwt_sharded(x, wavelet: DiscreteWavelet, level: int, mesh: Mesh,
                signal_axis: str = "signal", batch_axis: str = "data"):
    """Signal-sharded multi-level FWT (per-shard prefix layout).

    Each device holds a contiguous shard; per level one ring ppermute
    fetches the M−2 right-context samples of the circularly-next shard's
    active prefix (the decimating analog of the MODWT halo ring, SURVEY
    §5.7).  The result shard keeps the reference's ``[approx | detail]``
    prefix layout *locally*; `gather_fwt_layout` converts stacked shards to
    the exact single-device layout.  Requires (N / n_shards) % 2^level == 0.
    """
    x = jnp.asarray(x)
    n = x.shape[-1]
    d = mesh.shape[signal_axis]
    if (n // d) % (1 << level) != 0:
        raise ValueError(f"shard length {n//d} not divisible by 2^{level}")

    def body(xl):
        h = xl.shape[-1]
        out = xl
        for _ in range(level):
            active = out[..., :h]
            ctx = _right_context(active, wavelet.length - 2, signal_axis) \
                if wavelet.length > 2 else active[..., :0]
            lo, hi = _local_analysis(active, ctx, wavelet)
            out = jnp.concatenate([lo, hi, out[..., h:]], axis=-1)
            h //= 2
        return out

    in_spec = _specs(mesh, x.ndim, signal_axis, batch_axis)
    return shard_map(body, mesh=mesh, in_specs=(in_spec,),
                     out_specs=in_spec)(x)


def ifwt_sharded(y, wavelet: DiscreteWavelet, level: int, mesh: Mesh,
                 signal_axis: str = "signal", batch_axis: str = "data"):
    """Inverse of :func:`fwt_sharded` (same per-shard layout in/out)."""
    y = jnp.asarray(y)
    n = y.shape[-1]
    d = mesh.shape[signal_axis]
    if (n // d) % (1 << level) != 0:
        raise ValueError(f"shard length {n//d} not divisible by 2^{level}")

    def body(yl):
        nloc = yl.shape[-1]
        widths = [nloc >> l for l in range(level)]
        out = yl
        for h in reversed(widths):
            half = h // 2
            lo = out[..., :half]
            hi = out[..., half:h]
            c = (wavelet.length + 1) // 2
            lo_ctx = _left_context(lo, c, signal_axis)
            hi_ctx = _left_context(hi, c, signal_axis)
            rec = _local_synthesis(lo, hi, lo_ctx, hi_ctx, wavelet)
            out = jnp.concatenate([rec, out[..., h:]], axis=-1)
        return out

    in_spec = _specs(mesh, y.ndim, signal_axis, batch_axis)
    return shard_map(body, mesh=mesh, in_specs=(in_spec,),
                     out_specs=in_spec)(y)


def dtcwt_sharded(x, level: int, mesh: Mesh, level1=None, k: int = 4,
                  l: int = 3, signal_axis: str = "signal",
                  batch_axis: str = "data"):
    """Signal-sharded dual-tree complex WT (parity layout with `ops.dtcwt`).

    Both orthonormal trees ride the decimating halo ring (`_local_analysis`
    + one `ppermute` right-context fetch per level per tree); tree b's
    one-sample level-1 offset (`dtcwt` docstring) is a 1-sample halo fetch.
    Unlike :func:`fwt_sharded`'s packed prefix, every subband is a separate
    array whose shards ARE contiguous slices of the global decimated signal,
    so outputs match :func:`..ops.dtcwt.dtcwt` elementwise with no gather
    step.  Requires (N / n_shards) % 2^level == 0.
    """
    import math as _math

    from ..ops.dtcwt import DTCWTResult, _tree_params

    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.integer):
        x = x.astype(jnp.float32)
    n = x.shape[-1]
    d = mesh.shape[signal_axis]
    if (n // d) % (1 << level) != 0:
        raise ValueError(f"shard length {n//d} not divisible by 2^{level}")
    w1, wa, wb = _tree_params(level1, k, l)
    inv_sqrt2 = 1.0 / _math.sqrt(2.0)

    def step(v, w):
        ctx = _right_context(v, w.length - 2, signal_axis) \
            if w.length > 2 else v[..., :0]
        return _local_analysis(v, ctx, w)

    def body(xl):
        xb = jnp.concatenate(
            [xl[..., 1:], _right_context(xl, 1, signal_axis)], axis=-1)
        la, ha = step(xl, w1)
        lb, hb = step(xb, w1)
        highs = [(ha + 1j * hb) * inv_sqrt2]
        for _ in range(2, level + 1):
            la, ha = step(la, wa)
            lb, hb = step(lb, wb)
            highs.append((ha + 1j * hb) * inv_sqrt2)
        return tuple(highs), la, lb

    in_spec = _specs(mesh, x.ndim, signal_axis, batch_axis)
    out_specs = (tuple(in_spec for _ in range(level)), in_spec, in_spec)
    highs, la, lb = shard_map(body, mesh=mesh, in_specs=(in_spec,),
                              out_specs=out_specs)(x)
    return DTCWTResult(highpass=highs, lowpass_a=la, lowpass_b=lb)


def idtcwt_sharded(res, mesh: Mesh, level1=None, k: int = 4, l: int = 3,
                   signal_axis: str = "signal", batch_axis: str = "data"):
    """Inverse of :func:`dtcwt_sharded` (exact, each tree orthonormal)."""
    import math as _math

    from ..ops.dtcwt import _tree_params

    w1, wa, wb = _tree_params(level1, k, l)
    sqrt2 = _math.sqrt(2.0)

    def syn(lo, hi, w):
        c = (w.length + 1) // 2
        lo_ctx = _left_context(lo, c, signal_axis)
        hi_ctx = _left_context(hi, c, signal_axis)
        return _local_synthesis(lo, hi, lo_ctx, hi_ctx, w)

    def body(highs, la, lb):
        for w in highs[:0:-1]:
            ha, hb = sqrt2 * jnp.real(w), sqrt2 * jnp.imag(w)
            la = syn(la, ha, wa)
            lb = syn(lb, hb, wb)
        w0 = highs[0]
        ha, hb = sqrt2 * jnp.real(w0), sqrt2 * jnp.imag(w0)
        xa = syn(la, ha, w1)
        xb = syn(lb, hb, w1)
        xb = jnp.concatenate(
            [_left_context(xb, 1, signal_axis), xb[..., :-1]], axis=-1)
        return 0.5 * (xa + xb)

    ndim = res.lowpass_a.ndim
    spec = _specs(mesh, ndim, signal_axis, batch_axis)
    in_specs = (tuple(spec for _ in res.highpass), spec, spec)
    return shard_map(body, mesh=mesh, in_specs=in_specs,
                     out_specs=spec)(tuple(res.highpass), res.lowpass_a,
                                     res.lowpass_b)


def gather_fwt_layout(y, level: int, n_shards: int):
    """Convert per-shard prefix layout → the single-device reference layout.

    Band boundaries per shard: [approx(w_L) | d_L(w_L) | d_{L-1}(2w_L) | …];
    the global layout concatenates each band across shards in order.
    """
    y = jnp.asarray(y)
    n = y.shape[-1]
    loc = n // n_shards
    shards = y.reshape(y.shape[:-1] + (n_shards, loc))
    bands = []
    # local band offsets
    off = 0
    sizes = [loc >> level]  # approx
    sizes += [loc >> (level - l) for l in range(level)]  # d_L .. d_1
    pieces = []
    for sz in sizes:
        pieces.append(shards[..., :, off:off + sz])
        off += sz
    return jnp.concatenate(
        [p.reshape(y.shape[:-1] + (-1,)) for p in pieces], axis=-1)


def scattering_sharded(x, j: int, q: int = 8, order: int = 2,
                       mesh: Mesh | None = None,
                       scale_axis: str = "scale",
                       batch_axis: str = "data",
                       subsample: int | None = None):
    """Wavelet scattering with the first-order path axis sharded.

    The scattering cascade is an independent-subproblem tree: every
    second-order path ``(λ, μ)`` depends on exactly one first-order
    envelope ``U1[λ]``, so sharding the λ axis makes the ENTIRE second
    order local to the chip that owns λ — the expert-parallel analog of
    the reference's P1 packet distribution
    (``ParallelWaveletPacketTransform.java:188-263``), one level deeper.
    The shard_map body contains no collectives at all: each device FFTs
    the (replicated) signal once, applies its L1/n_dev first-order
    filters, and runs its own second-order paths.

    Second-order path counts differ per shard (low-frequency λ admit
    fewer μ), so each shard's path list is padded to the max with
    all-zero ψ² rows — padded outputs are exactly zero, no masking.
    Returns a :class:`~jwave_pro.ops.scattering.ScatteringResult`
    whose ``s2`` has ``n_dev·P_max`` rows in shard-major order and whose
    ``pairs`` table marks padding rows with ``i1 = -1``; filter with
    ``pairs[:, 0] >= 0`` to recover exactly the unsharded path order.
    """
    import numpy as np

    from ..ops.scattering import (
        ScatteringResult, _lowpass_subsample, _pair_table, scattering_filters)

    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise ValueError("scattering_sharded expects a real signal")
    if mesh is None:
        raise ValueError("scattering_sharded requires a mesh "
                         "(use ops.scattering.scattering1d single-device)")
    n = x.shape[-1]
    t = (1 << j) if subsample is None else subsample
    if t < 1 or n % t:
        raise ValueError(f"subsample stride {t} must divide N={n}")
    if order not in (1, 2):
        raise ValueError("order must be 1 or 2")
    n_dev = mesh.shape[scale_axis]
    psi1_np, xi1, psi2_np, xi2, phi_np = scattering_filters(n, j, q)
    l1 = psi1_np.shape[0]
    if l1 % n_dev:
        raise ValueError(f"first-order path count L1 = J·Q = {l1} not "
                         f"divisible by mesh axis {scale_axis}={n_dev}")
    loc = l1 // n_dev
    rdt = jnp.result_type(x.dtype, jnp.float32)

    # per-shard second-order tables, padded to the max local path count
    i1, i2 = _pair_table(n, j, q)
    per = [np.nonzero((i1 >= d * loc) & (i1 < (d + 1) * loc))[0]
           for d in range(n_dev)]
    pmax = max((len(p) for p in per), default=0)
    psi2_pad = np.zeros((n_dev, max(pmax, 1), n))
    i1_rel = np.zeros((n_dev, max(pmax, 1)), dtype=np.int32)
    pairs = np.full((n_dev, max(pmax, 1), 2), -1.0)
    for d, idx in enumerate(per):
        psi2_pad[d, :len(idx)] = psi2_np[i2[idx]]
        i1_rel[d, :len(idx)] = i1[idx] - d * loc
        pairs[d, :len(idx), 0] = i1[idx]
        pairs[d, :len(idx), 1] = xi2[i2[idx]]

    phi = jnp.asarray(phi_np, dtype=rdt)
    want2 = order == 2 and i1.size > 0

    def body(xl, psi1_l, psi2_l, i1rel_l):
        xhat = jnp.fft.fft(xl)
        s0 = _lowpass_subsample(xhat, phi, t)
        u1 = jnp.abs(jnp.fft.ifft(xhat[..., None, :] * psi1_l))
        u1hat = jnp.fft.fft(u1)
        s1 = _lowpass_subsample(u1hat, phi, t)
        if not want2:
            return s0, s1
        u2hat = jnp.take(u1hat, i1rel_l[0], axis=-2) * psi2_l[0]
        u2 = jnp.abs(jnp.fft.ifft(u2hat))
        s2 = _lowpass_subsample(jnp.fft.fft(u2), phi, t)
        return s0, s1, s2

    bspec = [None] * x.ndim
    if batch_axis in mesh.axis_names and x.ndim > 1:
        bspec[0] = batch_axis
    lead = tuple(bspec[:-1])
    out_specs = (P(*bspec), P(*lead, scale_axis, None))
    in_specs = (P(*bspec), P(scale_axis, None),
                P(scale_axis, None, None), P(scale_axis, None))
    if want2:
        out_specs = out_specs + (P(*lead, scale_axis, None),)
    fn = shard_map(body, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
    out = fn(x, jnp.asarray(psi1_np, dtype=rdt),
             jnp.asarray(psi2_pad, dtype=rdt), jnp.asarray(i1_rel))
    if want2:
        s0, s1, s2 = out
        pairs_out = pairs.reshape(-1, 2)
    else:
        s0, s1 = out
        s2 = (None if order == 1
              else jnp.zeros((*x.shape[:-1], 0, n // t), dtype=s1.dtype))
        pairs_out = np.zeros((0, 2))
    return ScatteringResult(s0=s0, s1=s1, s2=s2, xi1=xi1, pairs=pairs_out)


def ssq_sharded(x, scales, wavelet=None, mesh: Mesh | None = None,
                sampling_rate: float = 1.0, n_freqs: int | None = None,
                freq_range: tuple[float, float] | None = None,
                padding: str = "zero", gamma: float | None = None,
                scale_axis: str = "scale", batch_axis: str = "data"):
    """Synchrosqueezed CWT with the scale axis sharded.

    Unlike the zero-comms CWT/scattering shards, synchrosqueezing needs a
    genuine cross-scale reduction: every scale's coefficients reassign
    into the SAME frequency-bin plane.  Each device computes W and ∂ₜW for
    its shard of scales (multipliers enter pre-sharded), scatters its own
    one-hot partial Tx, and the shards combine with ONE ``lax.psum`` over
    the mesh axis (reassignment is additive over scales); the default-γ
    magnitude floor adds one scalar-plane ``lax.pmax``.  Tx comes back
    replicated across the scale axis, Wx stays scale-sharded.

    Requires log-UNIFORM scales (e.g. ``generate_log_scales``): the icwt
    trapezoid weights use the global grid spacing, which equals every
    shard's local spacing only on a uniform-in-ln(a) grid.
    """
    import math

    import numpy as np

    from ..ops.cwt import _icwt_weights, pad_signal
    from ..ops.ssq import SSQResult, _ssq_multipliers, _ssq_reassign
    from ..utils.validation import next_power_of_two
    from ..wavelets.continuous import MorletWavelet

    if wavelet is None:
        wavelet = MorletWavelet()
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.integer):
        x = x.astype(jnp.float32)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise ValueError("ssq_sharded expects a real signal")
    if mesh is None:
        raise ValueError("ssq_sharded requires a mesh "
                         "(use ops.ssq.ssq_cwt single-device)")
    scales_np = np.atleast_1d(np.asarray(scales, dtype=np.float64))
    if np.any(scales_np <= 0):
        raise ValueError("Scales must be positive")
    dln = np.diff(np.log(scales_np))
    if dln.size and (dln.max() - dln.min()) > 1e-9 * max(dln.max(), 1e-30):
        raise ValueError("ssq_sharded needs a log-uniform scale grid "
                         "(generate_log_scales); got non-uniform ln-spacing")
    n_dev = mesh.shape[scale_axis]
    s_count = scales_np.shape[0]
    if s_count % n_dev:
        raise ValueError(f"n_scales {s_count} not divisible by mesh axis "
                         f"{scale_axis}={n_dev}")
    n = x.shape[-1]
    padded_n = next_power_of_two(n)
    if n_freqs is None:
        n_freqs = s_count
    if n_freqs < 2:
        raise ValueError("need at least 2 frequency bins")
    fc = float(wavelet.center_frequency)
    if freq_range is None:
        f_lo, f_hi = fc / float(scales_np.max()), fc / float(scales_np.min())
    else:
        f_lo, f_hi = float(freq_range[0]), float(freq_range[1])
    if not (0 < f_lo < f_hi):
        raise ValueError("freq_range must satisfy 0 < f_min < f_max")
    log_lo, log_hi = math.log(f_lo), math.log(f_hi)
    dlog = (log_hi - log_lo) / (n_freqs - 1)

    rdtype = jnp.float64 if x.dtype == jnp.float64 else jnp.float32
    cdtype = jnp.complex128 if x.dtype == jnp.float64 else jnp.complex64
    mults_np = _ssq_multipliers(wavelet, tuple(float(s) for s in scales_np),
                                padded_n, float(sampling_rate))
    weights_np = _icwt_weights(scales_np)
    mdt = tuple(cdtype if np.iscomplexobj(m) else rdtype for m in mults_np)

    def body(xl, a, b, ad, bd, wts):
        xp = pad_signal(xl, padded_n, padding)
        return _ssq_reassign(xp, n, (a, b, ad, bd), wts, log_lo, dlog,
                             n_freqs, gamma, rdtype, cdtype,
                             axis_name=scale_axis)

    bspec = [None] * x.ndim
    if batch_axis in mesh.axis_names and x.ndim > 1:
        bspec[0] = batch_axis
    lead = tuple(bspec[:-1])
    fn = shard_map(
        body, mesh=mesh,
        in_specs=(P(*bspec),) + (P(scale_axis, None),) * 4 + (P(scale_axis),),
        out_specs=(P(*lead, None, None), P(*lead, scale_axis, None)))
    tx, wx = fn(x, *(jnp.asarray(m, dtype=d)
                     for m, d in zip(mults_np, mdt)),
                jnp.asarray(weights_np, dtype=rdtype))
    freqs = np.exp(log_lo + dlog * np.arange(n_freqs))
    dt = 1.0 / sampling_rate
    return SSQResult(tx, wx, jnp.asarray(freqs).astype(rdtype),
                     jnp.asarray(scales_np).astype(rdtype),
                     jnp.asarray(np.arange(n) * dt), sampling_rate,
                     wavelet.name)


def _conv_axis_shard(x, f, d, axis_name, axis: int, adjoint=False):
    """Dilated circular conv along ``axis``; sharded iff axis == -2.

    The last axis is always local (each device holds full rows of its row
    block); the row axis (−2) is sharded, so its convolution swaps the row
    axis to the back, rides :func:`_halo_conv`, and swaps back.
    """
    if axis == -1:
        from ..ops.modwt2d import _conv_last
        return _conv_last(x, f, d, adjoint)
    xt = jnp.swapaxes(x, -1, -2)
    return jnp.swapaxes(_halo_conv(xt, f, d, axis_name, adjoint), -1, -2)


def modwt2_sharded(x, wavelet: DiscreteWavelet, level: int, mesh: Mesh,
                   row_axis: str = "signal", batch_axis: str = "data"):
    """2D MODWT of a LARGE image with the row axis sharded.

    Each device holds a contiguous block of image rows.  Column-direction
    convolutions (along the last axis) are purely local; row-direction
    convolutions exchange ``(M−1)·2^(j−1)`` halo rows with the ring
    neighbors per level via the same multi-hop ``ppermute`` helper as the
    1D signal-sharded MODWT.  Band layout identical to
    :func:`~jwave_pro.ops.modwt2d.modwt2`.
    """
    from ..ops.modwt2d import _check_nd

    x = jnp.asarray(x)
    _check_nd(x.shape[-2:], level)
    g64, h64 = modwt_base_filters(wavelet)
    max_halo = (g64.shape[0] - 1) * (1 << (level - 1))
    if max_halo > x.shape[-2]:
        raise ValueError(
            f"level-{level} halo ({max_halo} rows) exceeds the image height "
            f"{x.shape[-2]}")
    g = jnp.asarray(g64, dtype=x.dtype)
    h = jnp.asarray(h64, dtype=x.dtype)

    def body(xl):
        rows = []
        ll = xl
        for j in range(1, level + 1):
            d = 1 << (j - 1)
            cl = _conv_axis_shard(ll, g, d, row_axis, -1)
            ch = _conv_axis_shard(ll, h, d, row_axis, -1)
            lh = _conv_axis_shard(ch, g, d, row_axis, -2)
            hl = _conv_axis_shard(cl, h, d, row_axis, -2)
            hh = _conv_axis_shard(ch, h, d, row_axis, -2)
            ll = _conv_axis_shard(cl, g, d, row_axis, -2)
            rows.extend([lh, hl, hh])
        rows.append(ll)
        return jnp.stack(rows, axis=0)

    spec = [None] * x.ndim
    if batch_axis in mesh.axis_names and x.ndim > 2:
        spec[0] = batch_axis
    spec[-2] = row_axis
    in_spec = P(*spec)
    return shard_map(body, mesh=mesh, in_specs=(in_spec,),
                     out_specs=P(None, *spec))(x)


def imodwt2_sharded(coeffs, wavelet: DiscreteWavelet, mesh: Mesh,
                    row_axis: str = "signal", batch_axis: str = "data"):
    """Inverse of :func:`modwt2_sharded` (same row sharding in/out)."""
    coeffs = jnp.asarray(coeffs)
    if coeffs.shape[0] % 3 != 1:
        raise ValueError(
            f"2D MODWT coefficient stack must have 3·level+1 rows, got "
            f"{coeffs.shape[0]}")
    level = (coeffs.shape[0] - 1) // 3
    g64, h64 = modwt_base_filters(wavelet)
    g = jnp.asarray(g64, dtype=coeffs.dtype)
    h = jnp.asarray(h64, dtype=coeffs.dtype)

    def body(cl_):
        ll = cl_[3 * level]
        for j in range(level, 0, -1):
            d = 1 << (j - 1)
            lh = cl_[3 * (j - 1)]
            hl = cl_[3 * (j - 1) + 1]
            hh = cl_[3 * (j - 1) + 2]
            cl = (_conv_axis_shard(ll, g, d, row_axis, -2, adjoint=True)
                  + _conv_axis_shard(hl, h, d, row_axis, -2, adjoint=True))
            ch = (_conv_axis_shard(lh, g, d, row_axis, -2, adjoint=True)
                  + _conv_axis_shard(hh, h, d, row_axis, -2, adjoint=True))
            ll = (_conv_axis_shard(cl, g, d, row_axis, -1, adjoint=True)
                  + _conv_axis_shard(ch, h, d, row_axis, -1, adjoint=True))
        return ll

    spec = [None] * (coeffs.ndim - 1)
    if batch_axis in mesh.axis_names and coeffs.ndim > 3:
        spec[0] = batch_axis
    spec[-2] = row_axis
    return shard_map(body, mesh=mesh, in_specs=(P(None, *spec),),
                     out_specs=P(*spec))(coeffs)


def scattering2d_sharded(x, j: int, l: int = 8, order: int = 2,
                         mesh: Mesh | None = None,
                         scale_axis: str = "scale",
                         batch_axis: str = "data",
                         subsample: int | None = None, slant: float = 0.5):
    """2D wavelet scattering with the first-order (j₁, θ₁) path axis sharded.

    The image analog of :func:`scattering_sharded`: every second-order path
    (j₁θ₁ → j₂θ₂) reads exactly one first-order envelope, so distributing
    the J·L first-order paths makes the entire second order local.  Shard
    path lists are padded to the max with zero-ψ rows (padded outputs are
    exactly zero); ``pairs`` marks padding rows with ``i1 = −1`` — filter
    with ``pairs[:, 0] >= 0`` to recover the unsharded path order.  The
    shard_map body contains no collectives.
    """
    import numpy as np

    from ..ops.scattering2d import (
        Scattering2DResult, _lowpass_subsample2, _pair_table2d,
        scattering2d_filters)

    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise ValueError("scattering2d_sharded expects a real image")
    if mesh is None:
        raise ValueError("scattering2d_sharded requires a mesh "
                         "(use ops.scattering2d.scattering2d single-device)")
    if jnp.issubdtype(x.dtype, jnp.integer):
        x = x.astype(jnp.float32)
    h, w = x.shape[-2], x.shape[-1]
    t = (1 << j) if subsample is None else subsample
    if t < 1 or h % t or w % t:
        raise ValueError(f"subsample stride {t} must divide H={h} and W={w}")
    if order not in (1, 2):
        raise ValueError("order must be 1 or 2")
    n_dev = mesh.shape[scale_axis]
    psi_np, phi_np, meta1 = scattering2d_filters(h, w, j, l, slant)
    l1 = psi_np.shape[0]
    if l1 % n_dev:
        raise ValueError(f"first-order path count J·L = {l1} not divisible "
                         f"by mesh axis {scale_axis}={n_dev}")
    loc = l1 // n_dev
    rdt = jnp.result_type(x.dtype, jnp.float32)

    i1, j2, t2 = _pair_table2d(j, l)
    per = [np.nonzero((i1 >= d * loc) & (i1 < (d + 1) * loc))[0]
           for d in range(n_dev)]
    pmax = max((len(p) for p in per), default=0)
    psi2_pad = np.zeros((n_dev, max(pmax, 1), h, w))
    i1_rel = np.zeros((n_dev, max(pmax, 1)), dtype=np.int32)
    pairs = np.full((n_dev, max(pmax, 1), 3), -1, dtype=np.int64)
    for d, idx in enumerate(per):
        psi2_pad[d, :len(idx)] = psi_np[j2[idx] * l + t2[idx]]
        i1_rel[d, :len(idx)] = i1[idx] - d * loc
        pairs[d, :len(idx)] = np.stack([i1[idx], j2[idx], t2[idx]], axis=-1)

    phi = jnp.asarray(phi_np, dtype=rdt)
    want2 = order == 2 and i1.size > 0

    def body(xl, psi1_l, psi2_l, i1rel_l):
        xhat = jnp.fft.fft2(xl, axes=(-2, -1))
        s0 = _lowpass_subsample2(xhat, phi, t)
        u1 = jnp.abs(jnp.fft.ifft2(xhat[..., None, :, :] * psi1_l,
                                   axes=(-2, -1)))
        u1hat = jnp.fft.fft2(u1, axes=(-2, -1))
        s1 = _lowpass_subsample2(u1hat, phi, t)
        if not want2:
            return s0, s1
        u2hat = jnp.take(u1hat, i1rel_l[0], axis=-3) * psi2_l[0]
        u2 = jnp.abs(jnp.fft.ifft2(u2hat, axes=(-2, -1)))
        s2 = _lowpass_subsample2(jnp.fft.fft2(u2, axes=(-2, -1)), phi, t)
        return s0, s1, s2

    bspec = [None] * x.ndim
    if batch_axis in mesh.axis_names and x.ndim > 2:
        bspec[0] = batch_axis
    lead = tuple(bspec[:-2])
    out_specs = (P(*bspec), P(*lead, scale_axis, None, None))
    in_specs = (P(*bspec), P(scale_axis, None, None),
                P(scale_axis, None, None, None), P(scale_axis, None))
    if want2:
        out_specs = out_specs + (P(*lead, scale_axis, None, None),)
    fn = shard_map(body, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
    out = fn(x, jnp.asarray(psi_np, dtype=rdt),
             jnp.asarray(psi2_pad, dtype=rdt), jnp.asarray(i1_rel))
    if want2:
        s0, s1, s2 = out
        pairs_out = pairs.reshape(-1, 3)
    else:
        s0, s1 = out
        s2 = (None if order == 1
              else jnp.zeros((*x.shape[:-2], 0, h // t, w // t),
                             dtype=s1.dtype))
        pairs_out = np.zeros((0, 3), dtype=np.int64)
    return Scattering2DResult(s0=s0, s1=s1, s2=s2, meta1=meta1,
                              pairs=pairs_out)
