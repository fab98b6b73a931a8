#!/usr/bin/env python3
"""Smoke test on the card: the MODWT main path at full size, every public
transform family once, and the fused kernels against XLA's plain version.

    python chip_smoke.py             # one CUDA GPU
    python chip_smoke.py --four      # the sharded paths on four GPUs

Every check prints its error, its bound and the bound's reason.  The run
exits non-zero, without the result line, when JAX's default device is not a
GPU or any check fails.  The last line of a passing run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

The reference for the main path is a float64 NumPy MODWT written here with
one ``np.roll`` per tap, independent of ``jwave_pro``; only the wavelets'
decomposition filter banks come from the package's registry.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

SEED = 0
BATCH, N = 32, 1 << 20      # the bench headline: 128 MiB of f32 in
N_ARB = 100_003             # arbitrary N, partial last tile
N_1D = 16_000_003           # one long series through the 1D contract
REACH = 4096                # the reach phase's base length
N_FOUR = 1 << 22            # samples per row of the four-card MODWT


# ---------------------------------------------------------------------------
# float64 NumPy reference
# ---------------------------------------------------------------------------

def reference_filters(dec_lo, dec_hi):
    """MODWT filters: the decomposition banks normalised to unit L2 norm,
    then divided by √2 (MODWTTransform.java:452-484)."""
    def norm(f):
        f = np.asarray(f, np.float64)
        return f / math.sqrt(float(np.sum(f * f))) / math.sqrt(2.0)
    return norm(dec_lo), norm(dec_hi)


def reference_modwt(x, g, h, level):
    """(..., N) → (level+1, ..., N): W_1..W_L, V_L with
    W_j[n] = Σ_k h[k]·V_{j-1}[(n − k·2^(j-1)) mod N], V_j likewise."""
    v = np.asarray(x, np.float64)
    rows = []
    for j in range(1, level + 1):
        d = 1 << (j - 1)
        w_acc = np.zeros_like(v)
        v_acc = np.zeros_like(v)
        for k in range(len(g)):
            r = np.roll(v, k * d, axis=-1)
            w_acc += h[k] * r
            v_acc += g[k] * r
        rows.append(w_acc)
        v = v_acc
    rows.append(v)
    return np.stack(rows)


def reference_imodwt(c, g, h):
    """Inverse: V_{j-1}[n] = Σ_k g[k]·V_j[n + k·2^(j-1)] + h[k]·W_j[…]."""
    c = np.asarray(c, np.float64)
    level = c.shape[0] - 1
    v = c[level]
    for j in range(level, 0, -1):
        d = 1 << (j - 1)
        acc = np.zeros_like(v)
        for k in range(len(g)):
            acc += np.roll(g[k] * v + h[k] * c[j - 1], -k * d, axis=-1)
        v = acc
    return v


def reference_denoise(x, g, h, level, threshold):
    """Soft-shrink W_1..W_L by ``threshold`` (scalar or per-row), keep V_L,
    invert.  ``threshold=None``: the universal rule from W_1's MAD."""
    c = reference_modwt(x, g, h, level)
    if threshold is None:
        n = c.shape[-1]
        sigma = np.median(np.abs(c[0]), axis=-1) / 0.6745
        threshold = (sigma * math.sqrt(2.0 * math.log(n)))[..., None]
    d = c[:level]
    c[:level] = np.sign(d) * np.maximum(np.abs(d) - threshold, 0.0)
    return reference_imodwt(c, g, h)


# ---------------------------------------------------------------------------
# Bookkeeping
# ---------------------------------------------------------------------------

class Checks:
    def __init__(self):
        self.failed = []

    def bound(self, name, err, limit, reason):
        ok = bool(np.isfinite(err)) and err <= limit
        print(f"  {'PASS' if ok else 'FAIL'} {name}: err {err:.3e} "
              f"<= {limit:.3e} ({reason})", flush=True)
        if not ok:
            self.failed.append(name)

    def true(self, name, cond, detail):
        print(f"  {'PASS' if cond else 'FAIL'} {name}: {detail}", flush=True)
        if not cond:
            self.failed.append(name)

    def phase(self, name, fn, *args):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn(*args)
        except Exception:  # noqa: BLE001 — reported, then the run fails
            traceback.print_exc()
            self.failed.append(f"{name} (exception)")
        print(f"   {name} took {time.perf_counter() - t0:.1f} s", flush=True)


def wall(fn, *args, reps=5):
    """Median wall seconds of ``fn(*args)`` after one warm-up call; also
    the first call's seconds (compilation included)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), first


def path_of(fn, *args):
    """'kernel' when the lowered program calls a fused CUDA kernel."""
    import jax

    return ("kernel" if "jwave_modwt" in jax.jit(fn).lower(*args).as_text()
            else "xla")


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def main_path(ck, jw, x, wavelet, level, label, full=True):
    """modwt → imodwt, denoise (fixed and universal threshold) and variance
    on device array ``x`` (B, N) or (N,), checked on a few full rows."""
    import jax

    b = 1 if x.ndim == 1 else x.shape[0]
    rows = np.unique(np.linspace(0, b - 1, min(4, b)).astype(int))
    if x.ndim == 1:
        pick, pick_c = (lambda a: a[None]), (lambda a: a[:, None])
    else:
        pick, pick_c = (lambda a: a[rows]), (lambda a: a[:, rows])
    xs = np.asarray(pick(x), np.float64)
    g, h = reference_filters(wavelet.dec_lo, wavelet.dec_hi)
    amax = float(np.max(np.abs(xs)))

    def run(name, fn, arg):
        path = path_of(fn, arg)
        f = jax.jit(fn)
        t, _ = wall(f, arg, reps=3)
        out = f(arg)
        ck.true(f"{label} {name} path", path == "kernel",
                f"ran {path} in {t * 1e3:.3f} ms")
        return out

    ref = reference_modwt(xs, g, h, level)
    c = run("modwt", lambda v: jw.modwt(v, wavelet, level), x)
    got = np.asarray(pick_c(c), np.float64)
    ck.bound(f"{label} modwt", float(np.max(np.abs(got - ref))),
             2e-5 * amax, "f32 rounding over L levels x M taps: 2e-5·max|x|")
    xr = run("imodwt", lambda cc: jw.imodwt(cc, wavelet), c)
    del c
    ck.bound(f"{label} imodwt(modwt)",
             float(np.max(np.abs(np.asarray(pick(xr), np.float64) - xs))),
             1e-4 * amax, "two f32 cascades compound: 1e-4·max|x|")
    if not full:
        return
    dn = run("denoise thr=0.8",
             lambda v: jw.modwt_denoise(v, wavelet, level, threshold=0.8), x)
    ck.bound(f"{label} denoise thr=0.8",
             float(np.max(np.abs(np.asarray(pick(dn), np.float64)
                                 - reference_denoise(xs, g, h, level, 0.8)))),
             1e-4 * amax, "two f32 cascades compound: 1e-4·max|x|")
    du = run("denoise universal",
             lambda v: jw.modwt_denoise(v, wavelet, level), x)
    ck.bound(f"{label} denoise universal",
             float(np.max(np.abs(np.asarray(pick(du), np.float64)
                                 - reference_denoise(xs, g, h, level, None)))),
             1e-4 * amax, "two f32 cascades compound: 1e-4·max|x|")
    var = run("variance", lambda v: jw.modwt_variance(v, wavelet, level), x)
    vref = np.mean(ref[:level] ** 2, axis=-1)
    vgot = np.asarray(pick_c(var), np.float64)
    ck.bound(f"{label} variance", float(np.max(np.abs(vgot / vref - 1.0))),
             1e-4, "f32 accumulation over 2^20 terms: relative 1e-4")


def bf16_path(ck, jw, x, wavelet, level, label):
    """bf16 in/out, f32 arithmetic: compared with the f64 reference of the
    bf16-rounded input, so the error left is the output rounding."""
    import jax
    import jax.numpy as jnp

    x16 = x.astype(jnp.bfloat16)
    rows = np.unique(np.linspace(0, x.shape[0] - 1, 4).astype(int))
    xs = np.asarray(x16[rows].astype(jnp.float32), np.float64)
    g, h = reference_filters(wavelet.dec_lo, wavelet.dec_hi)
    fwd = lambda v: jw.modwt(v, wavelet, level)  # noqa: E731
    path = path_of(fwd, x16)
    c = jax.jit(fwd)(x16)
    ck.true(f"{label} bf16 modwt path", path == "kernel" and
            c.dtype == jnp.bfloat16, f"ran {path}, dtype {c.dtype}")
    got = np.asarray(c[:, rows].astype(jnp.float32), np.float64)
    ck.bound(f"{label} bf16 modwt",
             float(np.max(np.abs(got - reference_modwt(xs, g, h, level)))),
             3e-2, "f32 arithmetic, bf16 output rounding: TestBf16Tier "
             "bound 3e-2")
    del c
    dn_f = lambda v: jw.modwt_denoise(v, wavelet, level,  # noqa: E731
                                      threshold=0.8)
    path = path_of(dn_f, x16)
    dn = jax.jit(dn_f)(x16)
    ck.true(f"{label} bf16 denoise path", path == "kernel" and
            dn.dtype == jnp.bfloat16, f"ran {path}, dtype {dn.dtype}")
    got = np.asarray(dn[rows].astype(jnp.float32), np.float64)
    ck.bound(f"{label} bf16 denoise",
             float(np.max(np.abs(
                 got - reference_denoise(xs, g, h, level, 0.8)))),
             6e-2, "bf16 output rounding, TestBf16Tier bound 6e-2")


def gradients(ck, jw, x, wavelet, level, label):
    """The kernels' VJP rules on the card, against autodiff through the
    XLA path (method='direct')."""
    import jax
    import jax.numpy as jnp

    r = jnp.cos(jnp.arange(x.shape[-1], dtype=jnp.float32))
    amax = float(jnp.max(jnp.abs(x)))
    calls = {
        "modwt": lambda v, m: jnp.sum(jw.modwt(v, wavelet, level, m) ** 2),
        "denoise thr=0.8": lambda v, m: jnp.sum(r * jw.modwt_denoise(
            v, wavelet, level, threshold=0.8, method=m)),
        "variance": lambda v, m: jnp.sum(jw.modwt_variance(
            v, wavelet, level, method=m)),
    }
    for name, f in calls.items():
        got = jax.jit(jax.grad(lambda v: f(v, "auto")))(x)
        want = jax.jit(jax.grad(lambda v: f(v, "direct")))(x)
        scale = float(jnp.max(jnp.abs(want)))
        ck.bound(f"{label} grad {name} vs direct",
                 float(jnp.max(jnp.abs(got - want))),
                 1e-4 * max(scale, amax),
                 "f32 VJP cascades: 1e-4·max(|grad|, |x|)")


def phase_main(ck, jw):
    import jax.numpy as jnp

    rng = np.random.default_rng(SEED)
    db4 = jw.wavelet("Daubechies 4")
    sym8 = jw.wavelet("Symlet 8")
    x = jnp.asarray(rng.standard_normal((BATCH, N), np.float32))
    main_path(ck, jw, x, db4, 5, f"Db4 L5 {BATCH}x{N}")
    main_path(ck, jw, x, sym8, 5, f"Sym8 L5 {BATCH}x{N}", full=False)
    bf16_path(ck, jw, x, db4, 5, f"Db4 L5 {BATCH}x{N}")
    xg = x[:4, :1 << 16]
    gradients(ck, jw, xg, db4, 5, f"Db4 L5 {xg.shape[0]}x{xg.shape[1]}")
    del x
    xa = jnp.asarray(rng.standard_normal((BATCH, N_ARB), np.float32))
    main_path(ck, jw, xa, db4, 5, f"Db4 L5 {BATCH}x{N_ARB}")
    del xa
    x1 = jnp.asarray(rng.standard_normal(N_1D, np.float32))
    main_path(ck, jw, x1, db4, 5, f"Db4 L5 {N_1D}")


def phase_host(ck, jw):
    """The main path on float32 arrays placed on the host CPU of the GPU
    machine: the programs are lowered for the CPU, so they must hold the
    XLA cascade and no custom call, and still agree with the reference."""
    import jax

    cpu = jax.local_devices(backend="cpu")[0]
    rng = np.random.default_rng(SEED + 4)
    db4 = jw.wavelet("Daubechies 4")
    xs = rng.standard_normal((4, N_ARB // 16)).astype(np.float32)
    g, h = reference_filters(db4.dec_lo, db4.dec_hi)
    ref = reference_modwt(xs, g, h, 5)
    amax = float(np.max(np.abs(xs)))
    with jax.default_device(cpu):
        x = jax.device_put(xs, cpu)
        calls = {
            "modwt": (lambda v: jw.modwt(v, db4, 5), x, ref, 2e-5),
            "imodwt": (lambda c: jw.imodwt(c, db4),
                       jax.device_put(ref.astype(np.float32), cpu), xs, 1e-4),
            "denoise thr=0.8": (lambda v: jw.modwt_denoise(
                v, db4, 5, threshold=0.8), x,
                reference_denoise(xs, g, h, 5, 0.8), 1e-4),
        }
        for name, (fn, arg, want, rel) in calls.items():
            path = path_of(fn, arg)
            out = jax.jit(fn)(arg)
            ck.true(f"host f32 {name} path", path == "xla" and
                    out.devices() == {cpu}, f"ran {path} on {out.devices()}")
            ck.bound(f"host f32 {name}",
                     float(np.max(np.abs(np.asarray(out, np.float64) - want))),
                     rel * amax, f"f32 XLA cascade: {rel:g}·max|x|")
        var = np.asarray(jax.jit(lambda v: jw.modwt_variance(v, db4, 5))(x))
        ck.bound("host f32 variance",
                 float(np.max(np.abs(var / np.mean(ref[:5] ** 2, -1) - 1))),
                 1e-4, "f32 accumulation: relative 1e-4")
    hlo = jax.jit(lambda v: jw.modwt(v, db4, 5)).lower(
        jax.device_put(xs)).compile().as_text()
    ck.true("card program keeps no routing branch",
            "jwave_modwt_fwd" in hlo and "conditional" not in hlo,
            "the compiled GPU program calls the kernel with no conditional")


def cpu_f64(fn, *args):
    """``fn`` on the host CPU in float64 (the XLA counterpart of a check)."""
    import jax

    cpu = jax.local_devices(backend="cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        args = [jax.device_put(np.asarray(a, np.float64), cpu) for a in args]
        return jax.tree.map(np.asarray, fn(*args))


def phase_reach(ck, jw):
    """Every public transform family once, on the card, at a small real
    size: by round trip, or against its float64 CPU counterpart."""
    import jax
    import jax.numpy as jnp
    from jwave_pro import streaming

    rng = np.random.default_rng(SEED + 1)
    db4 = jw.wavelet("Daubechies 4")
    s = REACH

    def sig(*shape):
        return jnp.asarray(rng.standard_normal(shape, np.float32))

    def roundtrip(name, fwd, inv, x, rel=1e-4):
        y = jax.jit(lambda v: inv(fwd(v)))(x)
        err = float(jnp.max(jnp.abs(y - x)))
        ck.bound(f"{name} round trip", err,
                 rel * float(jnp.max(jnp.abs(x))),
                 f"f32 analysis + synthesis: {rel:g}·max|x|")

    def versus_f64(name, fn, x, rel, reason):
        got = np.asarray(jax.jit(fn)(x))
        want = cpu_f64(fn, x)
        scale = float(np.max(np.abs(want)))
        ck.bound(f"{name} vs f64 CPU", float(np.max(np.abs(got - want))),
                 rel * scale, f"{reason}: {rel:g}·max|ref|")

    x1 = sig(8, 16 * s)
    roundtrip("fwt", lambda v: jw.fwt(v, db4), lambda y: jw.ifwt(y, db4), x1)
    roundtrip("wpt", lambda v: jw.wpt(v, db4, 6),
              lambda y: jw.iwpt(y, db4, 6), x1)
    roundtrip("modwpt", lambda v: jw.modwpt(v, db4, 3),
              lambda y: jw.imodwpt(y, db4), x1)
    roundtrip("dtcwt", lambda v: jw.dtcwt(v, 5), jw.idtcwt, x1)
    roundtrip("ewt1d", lambda v: jw.ewt1d(v, 5),
              lambda r: jw.iewt1d(r.components, r.filters), x1)
    x2 = sig(4, 2 * s // 16, 2 * s // 16)
    roundtrip("fwt2", lambda v: jw.fwt2(v, db4), lambda y: jw.ifwt2(y, db4),
              x2)
    roundtrip("modwt2", lambda v: jw.modwt2(v, db4, 3),
              lambda y: jw.imodwt2(y, db4), x2)
    x3 = sig(2, s // 64, s // 64, s // 64)
    roundtrip("fwt3", lambda v: jw.fwt3(v, db4), lambda y: jw.ifwt3(y, db4),
              x3)
    roundtrip("modwt3", lambda v: jw.modwt3(v, db4, 2),
              lambda y: jw.imodwt3(y, db4), x3[:1])

    xc = sig(16, s // 1)
    scales = tuple(float(a) for a in jw.generate_log_scales(1.0, 256.0, 64))
    versus_f64("cwt Morlet 64 scales",
               lambda v: jw.cwt(v, scales, jw.MorletWavelet()).coefficients,
               xc, 1e-4, "f32 FFT products")
    wav = jw.MorletWavelet()
    fc = float(wav.center_frequency)
    sscales = tuple(float(a) for a in
                    jw.generate_log_scales(fc / 0.4, fc / 0.01, 32))
    versus_f64("ssq_cwt sum over bins",
               lambda v: jnp.sum(jw.ssq_cwt(v, sscales, wavelet=wav,
                                            gamma=1e-4).Tx, axis=-2),
               xc[:4], 1e-3, "f32 FFTs; the bin sum is blind to binning")
    versus_f64("scattering1d J8 Q8",
               lambda v: jw.scattering1d(v, 8, 8).s1, x1[:2], 1e-3,
               "f32 FFT cascade with modulus")
    versus_f64("scattering2d J4 L8",
               lambda v: jw.scattering2d(v, 4, 8).s1, x2[:2], 1e-3,
               "f32 FFT cascade with modulus")
    prices = jnp.asarray(100.0 * np.exp(np.cumsum(
        0.01 * rng.standard_normal((64, 16 * s)), axis=-1)), jnp.float32)
    versus_f64("preprocess_prices after EWMA warm-up",
               lambda p: jw.preprocess_prices(p)[0][..., 64:], prices, 1e-3,
               "f32 log differences of ~1% returns cancel 3 digits")

    mp = jw.matching_pursuit(x1, db4, 3, 16)
    rec = jw.mp_reconstruct(mp, db4)
    ck.bound("matching_pursuit reconstruct + residual",
             float(jnp.max(jnp.abs(rec + mp.residual - x1))),
             1e-4 * float(jnp.max(jnp.abs(x1))), "f32 atoms: 1e-4·max|x|")
    omp = jw.matching_pursuit(x1, db4, 3, 8, orthogonalize=True)
    w = jw.modwpt(omp.residual, db4, 3, method="direct")
    from jwave_pro.ops.mp import _atom_tables
    _, norms = _atom_tables(db4, 3, x1.shape[-1])
    corr = jnp.take_along_axis(
        jnp.moveaxis(w, 0, -2).reshape(x1.shape[0], -1),
        omp.nodes * x1.shape[-1] + omp.shifts, axis=-1) / jnp.asarray(
            norms, jnp.float32)[omp.nodes]
    ck.bound("OMP residual ⊥ span", float(jnp.max(jnp.abs(corr))),
             1e-4 * float(jnp.sqrt(jnp.max(jnp.sum(x1 * x1, -1)))),
             "HIGHEST-precision f32 solves: 1e-4·‖x‖")

    n_st, chunk = 4 * s, s // 4
    cfg = streaming.StreamingConfig(buffer_size=s, max_level=5)
    sm = streaming.StreamingMODWT(db4, cfg)
    stream = rng.standard_normal(n_st).astype(np.float32)
    out = None
    for i in range(0, n_st, chunk):
        out = sm.update(stream[i:i + chunk])
    g, h = reference_filters(db4.dec_lo, db4.dec_hi)
    want = reference_modwt(stream, g, h, 5)[:, -chunk:]
    ck.bound("StreamingMODWT newest chunk",
             float(np.max(np.abs(np.asarray(out)[:, -chunk:] - want))),
             2e-5 * float(np.max(np.abs(stream))),
             "f32 rounding over L levels x M taps: 2e-5·max|x|")


def phase_timing(ck, jw, card):
    """Each main-path public call, fused kernel against method='direct'
    (what XLA makes of the plain roll form), with first-call seconds
    (compilation included; runs before the other phases so those calls
    compile cold unless a persistent cache already holds them)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(SEED + 2)
    db4 = jw.wavelet("Daubechies 4")
    sym8 = jw.wavelet("Symlet 8")
    b, n = BATCH, N
    x = jnp.asarray(rng.standard_normal((b, n), np.float32))
    xa = jnp.asarray(rng.standard_normal((b, N_ARB), np.float32))
    x1 = jnp.asarray(rng.standard_normal(N_1D, np.float32))
    c = jw.modwt(x, db4, 5, "direct")
    cases = [
        (f"modwt Db4 L5 {b}x{n}", lambda m: lambda v: jw.modwt(v, db4, 5, m), x),
        (f"imodwt Db4 L5 {b}x{n}", lambda m: lambda v: jw.imodwt(v, db4, m), c),
        (f"denoise thr=0.8 Db4 L5 {b}x{n}", lambda m: lambda v:
         jw.modwt_denoise(v, db4, 5, threshold=0.8, method=m), x),
        (f"denoise universal Db4 L5 {b}x{n}", lambda m: lambda v:
         jw.modwt_denoise(v, db4, 5, method=m), x),
        (f"variance Db4 L5 {b}x{n}", lambda m: lambda v:
         jw.modwt_variance(v, db4, 5, method=m), x),
        (f"modwt Sym8 L5 {b}x{n}", lambda m: lambda v: jw.modwt(v, sym8, 5, m), x),
        (f"modwt Db4 L5 {b}x{N_ARB}",
         lambda m: lambda v: jw.modwt(v, db4, 5, m), xa),
        (f"modwt Db4 L5 {N_1D}",
         lambda m: lambda v: jw.modwt(v, db4, 5, m), x1),
    ]
    for name, make, arg in cases:
        tk, ck_first = wall(jax.jit(make("fused")), arg, reps=20)
        tx, cx_first = wall(jax.jit(make("direct")), arg, reps=20)
        ck.true(f"timing {name}", tk < tx,
                f"kernel {tk * 1e3:.4f} ms (first call {ck_first:.3f} s) vs "
                f"direct {tx * 1e3:.4f} ms (first call {cx_first:.3f} s), "
                f"speed-up {tx / tk:.2f}x [{card}]")


def branch_timing(jw, card):
    """CWT and SSQ at the bench shapes, 'auto' (the half-spectrum irfft
    path) against method='banded' (the pruned-band matmul plan): the
    measurement behind 'auto''s choice, reported and not asserted."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(SEED + 5)
    xc = jnp.asarray(rng.standard_normal((16, 4096), np.float32))
    scales = tuple(float(a) for a in jw.generate_log_scales(1.0, 256.0, 64))
    wav = jw.MorletWavelet()
    fc = float(wav.center_frequency)
    sscales = tuple(float(a) for a in
                    jw.generate_log_scales(fc / 0.4, fc / 0.01, 32))
    cases = [
        ("cwt Morlet 16x4096 64 scales", lambda m: lambda v: jw.cwt(
            v, scales, wav, method=m).coefficients, xc),
        ("cwt Mexican Hat 16x4096 64 scales", lambda m: lambda v: jw.cwt(
            v, scales, jw.MexicanHatWavelet(), method=m).coefficients, xc),
        ("ssq_cwt Morlet 4x4096 32 scales", lambda m: lambda v: jw.ssq_cwt(
            v, sscales, wavelet=wav, gamma=1e-4, method=m).Tx, xc[:4]),
    ]
    for name, make, arg in cases:
        ta, _ = wall(jax.jit(make("auto")), arg, reps=20)
        tb, _ = wall(jax.jit(make("banded")), arg, reps=20)
        print(f"  INFO branch {name}: auto {ta * 1e3:.4f} ms vs banded "
              f"{tb * 1e3:.4f} ms, auto {'faster' if ta < tb else 'SLOWER'} "
              f"[{card}]", flush=True)


def phase_four(ck, jw):
    """Signal-sharded MODWT (ppermute halo ring) and scale-sharded CWT on a
    4-device mesh, against the single-device results."""
    import jax
    import jax.numpy as jnp
    from jwave_pro.parallel import make_mesh
    from jwave_pro.parallel.sharded import (
        cwt_sharded, imodwt_sharded, modwt_sharded)

    devs = jax.devices()[:4]
    ck.true("four devices", len(devs) == 4, f"{devs}")
    rng = np.random.default_rng(SEED + 3)
    db4 = jw.wavelet("Daubechies 4")

    def spread(name, arr):
        devices = {s.device for s in arr.addressable_shards}
        ck.true(f"{name} spread", len(devices) == 4,
                f"{len(devices)} devices, shard shape "
                f"{arr.addressable_shards[0].data.shape}")

    x = jnp.asarray(rng.standard_normal((8, N_FOUR), np.float32))
    mesh = make_mesh({"signal": 4}, devices=devs)
    c = jax.jit(lambda v: modwt_sharded(v, db4, 5, mesh))(x)
    spread("modwt_sharded", c)
    single = jax.device_put(x, devs[0])
    c1 = jax.jit(lambda v: jw.modwt(v, db4, 5))(single)
    amax = float(jnp.max(jnp.abs(single)))
    ck.bound("modwt_sharded vs single device",
             float(jnp.max(jnp.abs(jax.device_put(c, devs[0]) - c1))),
             2e-5 * amax, "f32 rounding over L levels x M taps: 2e-5·max|x|")
    xr = jax.jit(lambda cc: imodwt_sharded(cc, db4, mesh))(c)
    spread("imodwt_sharded", xr)
    ck.bound("imodwt_sharded(modwt_sharded) vs input",
             float(jnp.max(jnp.abs(jax.device_put(xr, devs[0]) - single))),
             1e-4 * amax, "two f32 cascades compound: 1e-4·max|x|")

    xc = jnp.asarray(rng.standard_normal((16, REACH), np.float32))
    scales = tuple(float(a) for a in jw.generate_log_scales(1.0, 256.0, 64))
    smesh = make_mesh({"scale": 4}, devices=devs)
    cs = cwt_sharded(xc, scales, jw.MorletWavelet(), smesh).coefficients
    spread("cwt_sharded", cs)
    c1 = jw.cwt(jax.device_put(xc, devs[0]), scales,
                jw.MorletWavelet()).coefficients
    ck.bound("cwt_sharded vs single device",
             float(jnp.max(jnp.abs(jax.device_put(cs, devs[0]) - c1))),
             1e-4 * float(jnp.max(jnp.abs(c1))),
             "f32 FFT products, full vs half spectrum: 1e-4·max|ref|")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded paths")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    platform = devs[0].platform
    print(f"devices: {devs}", flush=True)
    print(f"device_kind: {devs[0].device_kind}", flush=True)
    if platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {platform!r}); "
              "this test runs only on the card", file=sys.stderr)
        return 2
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(REPO, ".jax_cache"))
    card = card_line()
    print(f"card: {card}", flush=True)

    sys.path.insert(0, REPO)
    import jwave_pro as jw

    ck = Checks()
    if args.four:
        ck.phase("four devices", phase_four, ck, jw)
    else:
        from jwave_pro.kernels import modwt_cuda

        t0 = time.perf_counter()
        ck.true("fused kernels available", modwt_cuda.available(),
                f"build and registration {time.perf_counter() - t0:.1f} s")
        # first, so its first calls are cold compiles
        ck.phase("kernel against XLA", phase_timing, ck, jw, card)
        ck.phase("XLA branch choices", branch_timing, jw, card)
        ck.phase("main path", phase_main, ck, jw)
        ck.phase("host-placed arrays", phase_host, ck, jw)
        ck.phase("reach", phase_reach, ck, jw)
    if ck.failed:
        print(f"FAILED: {ck.failed}", flush=True)
        return 1
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devs[0].device_kind,
        "count": 4 if args.four else len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
