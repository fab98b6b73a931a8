#!/usr/bin/env python3
"""Benchmark harness — headline metric: MODWT Db4 5-level samples/s/chip.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
vs_baseline is the value over a fixed 1e9 samples/s/chip reference rate
(the reference publishes no absolute throughput numbers).

Run with JWAVE_BENCH_ALL=1 for the full per-config table on stderr.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.abspath(__file__))
# Persistent compilation cache: $JAX_COMPILATION_CACHE_DIR when set (JAX
# reads it itself), else a fixed directory in the checkout.
if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(REPO, ".jax_cache"))

sys.path.insert(0, REPO)

import jwave_pro as jw  # noqa: E402

TARGET = 1e9  # samples/s/chip reference rate for vs_baseline


from jwave_pro.utils.profiling import time_chain as _time_chain  # noqa: E402


def _runs_kernel(fn, x) -> bool:
    """Whether ``fn(x)`` lowers to one of the fused CUDA kernels."""
    return "jwave_modwt" in jax.jit(fn).lower(x).as_text()


def bench_modwt(dtype=jnp.float32, batch=32, n=1 << 20, level=5,
                method="auto"):
    w = jw.wavelet("Daubechies 4")
    x = jnp.asarray(np.random.default_rng(0).standard_normal((batch, n)),
                    dtype=dtype)
    # The chain feeds V_J forward.  On XLA paths that alone would let the
    # compiler dead-code-eliminate the detail-row convolutions, so the step
    # also consumes W_1..W_J through a vanishing (1e-30-scaled) feedback —
    # the measured step provably computes and reads back the full transform.
    # The fused kernel is structurally DCE-proof (one opaque custom call
    # writes the whole (L+1, B, N) output buffer), so its step skips the
    # artificial extra (L)·N read pass and reflects pure transform cost.
    uses_kernel = _runs_kernel(lambda v: jw.modwt(v, w, level, method), x)

    def step(v):
        c = jw.modwt(v, w, level, method=method)
        if uses_kernel:
            return c[level]
        return c[level] + 1e-30 * jnp.sum(c[:level], axis=0)

    dt = _time_chain(step, x)
    return batch * n / dt


def bench_modwt_roundtrip(dtype=jnp.float32, batch=8, n=1 << 20, level=5):
    w = jw.wavelet("Daubechies 4")
    x = jnp.asarray(np.random.default_rng(0).standard_normal((batch, n)),
                    dtype=dtype)
    dt = _time_chain(lambda v: jw.imodwt(jw.modwt(v, w, level), w), x)
    # One-shot error check through the donating entry point: the roundtrip
    # reuses the input signal's buffer for the reconstruction (the
    # InPlaceFastWaveletTransform / ArrayBufferPool analog — see
    # tests/test_donation.py).
    rt = jax.jit(lambda v: jw.imodwt(jw.modwt(v, w, level), w),
                 donate_argnums=0)
    x2 = x + 0.0  # private copy; donation invalidates it
    err = float(jnp.max(jnp.abs(rt(x2) - x)))
    return batch * n / dt, err


def bench_fwt(dtype=jnp.float32, batch=32, n=1 << 20):
    w = jw.wavelet("Daubechies 4")
    x = jnp.asarray(np.random.default_rng(0).standard_normal((batch, n)),
                    dtype=dtype)
    dt = _time_chain(lambda v: jw.fwt(v, w), x)
    return batch * n / dt


def bench_fwt_roundtrip(batch=32, n=1 << 20, level=5):
    """FWT fwd+inv, both directions on the fused multi-level matmuls (the
    packed synthesis constant of ops/fwt.py)."""
    w = jw.wavelet("Daubechies 4")
    x = jnp.asarray(np.random.default_rng(0).standard_normal((batch, n)),
                    jnp.float32)
    from jwave_pro.ops.fwt import fwt, ifwt
    dt = _time_chain(lambda v: ifwt(fwt(v, w, level=level), w, level=level),
                     x)
    return batch * n / dt


def bench_dtcwt_roundtrip(batch=32, n=1 << 20, level=5):
    """Dual-tree fwd+inv (two orthonormal trees + complex combine/split)."""
    x = jnp.asarray(np.random.default_rng(0).standard_normal((batch, n)),
                    jnp.float32)
    dt = _time_chain(lambda v: jw.idtcwt(jw.dtcwt(v, level)), x)
    return batch * n / dt


def bench_fwt2d(dtype=jnp.float32, batch=16, n=1024):
    w = jw.wavelet("Daubechies 4")
    x = jnp.asarray(np.random.default_rng(0).standard_normal((batch, n, n)),
                    dtype=dtype)
    dt = _time_chain(lambda v: jw.fwt2(v, w), x)
    return batch * n * n / dt


def bench_modwpt(batch=32, n=1 << 18, level=3, dtype=jnp.float32):
    """Shift-invariant packet tree: input samples/s (2^level full-length
    nodes per level — 2^level× output expansion at the leaf level)."""
    w = jw.wavelet("Daubechies 4")
    x = jnp.asarray(np.random.default_rng(0).standard_normal((batch, n)),
                    dtype)

    def step(v):
        c = jw.modwpt(v, w, level)  # (2^L, B, N)
        return c[0] + 1e-30 * jnp.sum(c[1:], axis=0)  # DCE-proof feedback

    return batch * n / _time_chain(step, x)


def bench_modwpt2(batch=8, n=512, level=2, method="auto"):
    """2D quad-tree: input pixels/s (4^level full-resolution nodes)."""
    w = jw.wavelet("Daubechies 4")
    x = jnp.asarray(np.random.default_rng(0).standard_normal((batch, n, n)),
                    jnp.float32)

    def step(v):
        c = jw.modwpt2(v, w, level, method=method)  # (2^L, 2^L, B, R, C)
        return c[0, 0] + 1e-30 * jnp.sum(c, axis=(0, 1))

    return batch * n * n / _time_chain(step, x)


def bench_mp(batch=8, n=65536, level=3, k=16):
    """Matching pursuit: K greedy picks, each one fused MODWPT pass over the
    residual + argmax + rolled subtraction.  Input samples/s for the full
    K-atom decomposition (so per-pick rate is k× this)."""
    w = jw.wavelet("Daubechies 4")
    x = jnp.asarray(np.random.default_rng(0).standard_normal((batch, n)),
                    jnp.float32)

    def step(v):
        r = jw.matching_pursuit(v, w, level, k)
        # residual depends on every pick; amps feedback pins the outputs too
        return r.residual + 1e-30 * jnp.sum(r.amps, axis=-1, keepdims=True)

    return batch * n / _time_chain(step, x)


def bench_wpt_denoise(batch=8, n=65536, level=6, per_sample=False):
    """Best-basis denoise: full tree + cost DP + shrink + mixed-level
    reconstruct (r4 wpt_denoise; r5 per_sample = one basis per row)."""
    w = jw.wavelet("Symlet 8")
    x = jnp.asarray(np.random.default_rng(0).standard_normal((batch, n)),
                    jnp.float32)
    dt = _time_chain(lambda v: jw.wpt_denoise(v, w, level, mode="hard",
                                              per_sample=per_sample), x)
    return batch * n / dt


def bench_financial_chain(batch=64, n=1 << 16):
    """preprocess_prices: gap-fill scan + returns + winsorize + causal EWMA
    devolatize (r4 financial tier) — prices/s through the whole chain."""
    p = np.exp(np.cumsum(
        0.01 * np.random.default_rng(0).standard_normal((batch, n)),
        axis=-1))
    x = jnp.asarray(p, jnp.float32)
    dt = _time_chain(lambda v: jw.preprocess_prices(v)[0], x)
    return batch * n / dt


def bench_dtcwt(batch=32, n=1 << 20, level=5):
    """Dual-tree complex WT forward, DCE-proof (every subband of both trees
    feeds back through the chain)."""
    x = jnp.asarray(np.random.default_rng(0).standard_normal((batch, n)),
                    jnp.float32)

    def step(v):
        r = jw.dtcwt(v, level)
        fb = sum(jnp.sum(jnp.real(w), -1, keepdims=True)
                 + jnp.sum(jnp.imag(w), -1, keepdims=True)
                 for w in r.highpass)
        fb = fb + jnp.sum(r.lowpass_a, -1, keepdims=True) \
            + jnp.sum(r.lowpass_b, -1, keepdims=True)
        return v + 1e-30 * fb

    return batch * n / _time_chain(step, x)


def bench_streaming(batch=64, buffer=16384, chunk=4096, level=5):
    """Incremental streaming MODWT: samples/s through the causal-tail
    update (`streaming._incremental_modwt_step`'s compute: recompute only
    the newest `chunk` columns from a halo+chunk window, shift the rest).
    Batched = many concurrent channels, the realistic streaming shape."""
    from jwave_pro.streaming import _causal_tail
    w = jw.wavelet("Daubechies 4")
    halo = (w.length - 1) * ((1 << level) - 1)
    c0 = jnp.asarray(np.random.default_rng(0).standard_normal(
        (level + 1, batch, buffer)), jnp.float32)

    def step(c):
        # window drawn from the carried state (data dependence for the
        # chain); same shapes/compute as one incremental update per channel
        window = c[-1, :, : halo + chunk]
        tail = _causal_tail(window, chunk, w, level)  # (L+1, B, chunk)
        return jnp.roll(c, -chunk, axis=-1).at[..., -chunk:].set(tail)

    return batch * chunk / _time_chain(step, c0)


def bench_wpt(dtype=jnp.float32, batch=64, n=65536, level=6):
    w = jw.wavelet("Symlet 8")
    x = jnp.asarray(np.random.default_rng(0).standard_normal((batch, n)),
                    dtype=dtype)
    dt = _time_chain(lambda v: jw.wpt(v, w, level), x)
    return batch * n / dt


def bench_wpt_roundtrip(batch=64, n=65536, level=6):
    """Full-tree WPT fwd+inv (both directions on the fused full-tree
    (2*BLK, BLK) constants — the inverse is a single fat matmul pair,
    unlike the pre-r4 FWT synthesis)."""
    w = jw.wavelet("Symlet 8")
    x = jnp.asarray(np.random.default_rng(0).standard_normal((batch, n)),
                    jnp.float32)
    dt = _time_chain(lambda v: jw.iwpt(jw.wpt(v, w, level), w, level), x)
    return batch * n / dt


def bench_cwt(dtype=jnp.float32, batch=16, n=4096, n_scales=64,
              wavelet=None, method="auto", precision=None):
    wav = wavelet if wavelet is not None else jw.MorletWavelet()
    scales = jw.generate_log_scales(1.0, 256.0, n_scales)
    x = jnp.asarray(np.random.default_rng(0).standard_normal((batch, n)),
                    dtype=dtype)

    def step(v):
        # DCE-proof: the scale axis is an FFT *batch* dim, so consuming only
        # c[0] / c[-1] would let XLA slice away 62 of 64 scales' inverse
        # FFTs entirely (this inflated the round-1 CWT figure).  The
        # 1e-30-scaled sums force every scale row (and both quadratures) to
        # be computed and read back.
        c = jw.cwt(v, scales, wav, 1.0, method=method,
                   precision=precision).coefficients
        re = jnp.real(c)
        out = re[..., 0, :] + 1e-30 * jnp.sum(re, axis=-2)
        if jnp.iscomplexobj(c):
            im = jnp.imag(c)
            out = out + im[..., -1, :] + 1e-30 * jnp.sum(im, axis=-2)
        return out

    dt = _time_chain(step, x)
    return batch * n / dt  # input samples/s (each producing 64 scales)


def bench_modwt_arbn(batch=32, n=100003, level=5, method="auto"):
    """Arbitrary-N (the reference's headline use case): the fused kernel's
    partial last tile vs the XLA path (method='direct')."""
    return bench_modwt(batch=batch, n=n, level=level, method=method)


def bench_modwt_arbn_1d(n=16_000_003, level=5, method="auto"):
    """Single long arbitrary-length series through the 1D contract."""
    w = jw.wavelet("Daubechies 4")
    x = jnp.asarray(np.random.default_rng(0).standard_normal(n), jnp.float32)
    uses_kernel = _runs_kernel(lambda v: jw.modwt(v, w, level, method), x)

    def step(v):
        c = jw.modwt(v, w, level, method=method)
        if uses_kernel:
            return c[level]
        return c[level] + 1e-30 * jnp.sum(c[:level], axis=0)

    return n / _time_chain(step, x)


def bench_fwt3d(batch=4, n=128, level=2):
    """3D separable FWT: voxels/s (VERDICT r3 weak #6 — measure, don't
    assert, the separable-=-batched claim)."""
    w = jw.wavelet("Daubechies 4")
    x = jnp.asarray(np.random.default_rng(0).standard_normal((batch, n, n, n)),
                    jnp.float32)
    dt = _time_chain(lambda v: jw.fwt3(v, w, (level,) * 3), x)
    return batch * n ** 3 / dt


def bench_modwt3d(batch=2, n=64, level=2, method="auto"):
    """3D MODWT: voxels/s ((7·level+1)× output expansion), XLA separable
    path."""
    w = jw.wavelet("Daubechies 4")
    x = jnp.asarray(np.random.default_rng(0).standard_normal((batch, n, n, n)),
                    jnp.float32)

    def step(v):
        c = jw.modwt3(v, w, level, method=method)
        return c[-1] + 1e-30 * jnp.sum(c[:-1], axis=0)

    return batch * n ** 3 / _time_chain(step, x)


def bench_modwt3d_roundtrip(batch=2, n=64, level=2):
    """3D MODWT roundtrip (XLA separable path both directions)."""
    w = jw.wavelet("Daubechies 4")
    x = jnp.asarray(np.random.default_rng(0).standard_normal((batch, n, n, n)),
                    jnp.float32)
    return batch * n ** 3 / _time_chain(
        lambda v: jw.imodwt3(jw.modwt3(v, w, level), w), x)


def bench_modwt_batch1(n=1 << 24, level=5):
    """Single long series (the financial use case) as a (1, N) batch."""
    return bench_modwt(batch=1, n=n, level=level)


def bench_modwt_1d(n=1 << 24, level=5):
    """Single long series through the 1D (N,) contract — avoids the
    degenerate (1, N) layout that throttles the batch=1 entry."""
    w = jw.wavelet("Daubechies 4")
    x = jnp.asarray(np.random.default_rng(0).standard_normal(n), jnp.float32)

    def step(v):
        c = jw.modwt(v, w, level)
        return c[level] + 1e-30 * jnp.sum(c[:level], axis=0)

    return n / _time_chain(step, x)


def bench_variance(batch=32, n=1 << 20, level=5, dtype=jnp.float32):
    """Fused single-pass wavelet variance (coefficients never reach device
    memory)."""
    w = jw.wavelet("Daubechies 4")
    x = jnp.asarray(np.random.default_rng(0).standard_normal((batch, n)),
                    dtype)

    def step(v):
        s = jw.modwt_variance(v, w, level, method="fused")
        return v + (1e-30 * jnp.sum(s)).astype(v.dtype)

    return batch * n / _time_chain(step, x)


def bench_denoise(batch=32, n=1 << 20, level=5, method="fused",
                  dtype=jnp.float32):
    """Full denoise round trip (forward → soft-shrink → inverse).

    method='fused' = single-pass kernel (coefficients never reach device
    memory);
    fixed threshold so the entry measures the transform chain, not the
    universal-threshold median.  Both methods compute the identical
    pipeline — nothing here is DCE-able (output depends on every level).
    """
    w = jw.wavelet("Daubechies 4")
    x = jnp.asarray(np.random.default_rng(0).standard_normal((batch, n)),
                    dtype=dtype)
    dt = _time_chain(
        lambda v: jw.modwt_denoise(v, w, level, threshold=0.8,
                                   method=method), x)
    return batch * n / dt


def bench_scattering(batch=8, n=65536, j=8, q=8):
    """1D scattering (order 2): input samples/s through the full cascade."""
    x = jnp.asarray(np.random.default_rng(0).standard_normal((batch, n)),
                    jnp.float32)

    def step(v):
        r = jw.scattering1d(v, j=j, q=q)
        # feed a full-rank reduction back at input length (shape-preserving)
        mix = (jnp.sum(r.s1, axis=-2) + jnp.sum(r.s2, axis=-2)
               + r.s0)  # (..., N/T)
        return v + 1e-30 * jnp.repeat(mix, 1 << j, axis=-1)

    return batch * n / _time_chain(step, x)


def bench_scattering2d(batch=4, n=256, j=4, l=8):
    """2D scattering (order 2): input pixels/s through the full cascade."""
    x = jnp.asarray(np.random.default_rng(0).standard_normal((batch, n, n)),
                    jnp.float32)

    def step(v):
        r = jw.scattering2d(v, j=j, l=l)
        mix = (jnp.sum(r.s1, axis=-3) + jnp.sum(r.s2, axis=-3)
               + r.s0)  # (..., N/T, N/T)
        up = jnp.repeat(jnp.repeat(mix, 1 << j, axis=-2), 1 << j, axis=-1)
        return v + 1e-30 * up

    return batch * n * n / _time_chain(step, x)


def bench_ssq(batch=4, n=4096, n_scales=32, method="auto", precision=None):
    """Synchrosqueezed CWT: input samples/s (W, ∂W, reassignment, Tx)."""
    wav = jw.MorletWavelet()
    fc = float(wav.center_frequency)
    scales = jw.generate_log_scales(fc / 0.4, fc / 0.01, n_scales)
    x = jnp.asarray(np.random.default_rng(0).standard_normal((batch, n)),
                    jnp.float32)

    def step(v):
        r = jw.ssq_cwt(v, scales, wavelet=wav, gamma=1e-4, method=method,
                       precision=precision)
        return v + 1e-30 * (jnp.sum(jnp.real(r.Tx), axis=-2)
                            + jnp.sum(jnp.imag(r.Tx), axis=-2))

    return batch * n / _time_chain(step, x)


def bench_modwt2(batch=8, n=512, level=3, method="auto", dtype=jnp.float32):
    """2D MODWT forward: pixels/s.  ``n=None`` → an arbitrary-size
    (1000, 750) image."""
    w = jw.wavelet("Daubechies 4")
    shape = (batch, n, n) if n is not None else (batch, 1000, 750)
    x = jnp.asarray(np.random.default_rng(0).standard_normal(shape), dtype)

    def step(v):
        c = jw.modwt2(v, w, level, method=method)
        return c[-1] + 1e-30 * jnp.sum(c[:-1], axis=0)

    return x.size / _time_chain(step, x)


def bench_modwt2_denoise(batch=8, n=512, level=3):
    """2D image denoise (undecimated): pixels/s."""
    w = jw.wavelet("Daubechies 4")
    x = jnp.asarray(np.random.default_rng(0).standard_normal((batch, n, n)),
                    jnp.float32)
    dt = _time_chain(lambda v: jw.modwt2_denoise(v, w, level, threshold=0.8),
                     x)
    return batch * n * n / dt


def main():
    results = {}
    results["modwt_db4_L5"] = bench_modwt()
    if os.environ.get("JWAVE_BENCH_ALL"):
        # print incrementally: a timeout should not lose completed configs
        def run(name, fn):
            results[name] = fn()
            print(f"  {name:24s} {results[name]/1e9:8.3f} Gsamples/s",
                  file=sys.stderr, flush=True)

        print(f"  {'modwt_db4_L5':24s} "
              f"{results['modwt_db4_L5']/1e9:8.3f} Gsamples/s",
              file=sys.stderr, flush=True)

        def _rt():
            sps, err = bench_modwt_roundtrip()
            print(f"  roundtrip max-abs-err {err:.2e}", file=sys.stderr,
                  flush=True)
            return sps

        run("modwt_roundtrip", _rt)
        run("modwt_batch1_16M", bench_modwt_batch1)
        run("modwt_bf16", lambda: bench_modwt(dtype=jnp.bfloat16))
        run("modwt_1d_16M", bench_modwt_1d)
        run("modwt_arbN_b32_100003", bench_modwt_arbn)
        run("modwt_arbN_b32_xla", lambda: bench_modwt_arbn(method="direct"))
        run("modwt_arbN_1d_16M", bench_modwt_arbn_1d)
        run("modwt_arbN_1d_xla",
            lambda: bench_modwt_arbn_1d(method="direct"))
        run("fwt3_db4_128", bench_fwt3d)
        run("modwt3_db4_64", bench_modwt3d)
        run("modwt3_roundtrip", bench_modwt3d_roundtrip)
        run("modwt3_db4_128", lambda: bench_modwt3d(batch=1, n=128))
        run("variance_fused", bench_variance)
        run("variance_arbN_100003", lambda: bench_variance(n=100003))
        run("variance_bf16", lambda: bench_variance(dtype=jnp.bfloat16))
        run("denoise_fused", bench_denoise)
        run("denoise_arbN_100003", lambda: bench_denoise(n=100003))
        run("denoise_bf16", lambda: bench_denoise(dtype=jnp.bfloat16))
        run("denoise_xla", lambda: bench_denoise(method="direct"))
        run("modwt_xla_direct", lambda: bench_modwt(method="direct"))
        run("modwt_fft_method", lambda: bench_modwt(method="fft", batch=8))
        run("fwt_db4_1m", bench_fwt)
        run("fwt_roundtrip", bench_fwt_roundtrip)
        run("dtcwt_roundtrip", bench_dtcwt_roundtrip)
        run("fwt2_db4_1024", bench_fwt2d)
        run("wpt_sym8_L6", bench_wpt)
        run("wpt_roundtrip", bench_wpt_roundtrip)
        run("wpt_denoise_L6", bench_wpt_denoise)
        run("wpt_denoise_L6_per_sample",
            lambda: bench_wpt_denoise(per_sample=True))
        run("financial_chain", bench_financial_chain)
        run("modwpt_db4_L3", bench_modwpt)
        run("modwpt_arbN_100003", lambda: bench_modwpt(n=100003))
        run("modwpt_bf16", lambda: bench_modwpt(dtype=jnp.bfloat16))
        run("modwpt2_db4_L2", bench_modwpt2)
        run("mp_db4_L3_k16", bench_mp)
        run("mp_arbN_100003", lambda: bench_mp(n=100003))
        run("streaming_modwt_inc", bench_streaming)
        run("dtcwt_L5", bench_dtcwt)
        run("cwt_morlet_64scales", bench_cwt)
        run("cwt_morlet_64scales_banded_high",
            lambda: bench_cwt(method="banded", precision="high"))
        run("cwt_mexhat_64scales",
            lambda: bench_cwt(wavelet=jw.MexicanHatWavelet()))
        run("cwt_mexhat_64scales_banded_high",
            lambda: bench_cwt(wavelet=jw.MexicanHatWavelet(),
                              method="banded", precision="high"))
        run("scattering1d_j8q8", bench_scattering)
        run("scattering2d_j4l8", bench_scattering2d)
        run("ssq_morlet_32scales", bench_ssq)
        run("ssq_morlet_32scales_banded_high",
            lambda: bench_ssq(method="banded", precision="high"))
        run("modwt2_fwd_512", bench_modwt2)
        run("modwt2_arb_1000x750", lambda: bench_modwt2(n=None))
        run("modwt2_bf16_512", lambda: bench_modwt2(dtype=jnp.bfloat16))
        run("modwt2_denoise_512", bench_modwt2_denoise)
    value = results["modwt_db4_L5"]
    print(json.dumps({
        "metric": "modwt_db4_level5_samples_per_sec_per_chip",
        "value": value,
        "unit": "samples/s",
        "vs_baseline": value / TARGET,
    }))


if __name__ == "__main__":
    main()
