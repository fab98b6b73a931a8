#!/usr/bin/env python3
"""Run the five evaluation configs end-to-end and report.

    python tools/eval_configs.py          # the default device (GPU or CPU)

Each config prints its correctness figure (max-abs reconstruction error or
equivalent); correctness is reduced on-device.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

# $JAX_COMPILATION_CACHE_DIR when set (JAX reads it itself), else a fixed
# directory in the checkout.
if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
    jax.config.update("jax_compilation_cache_dir", str(REPO / ".jax_cache"))

import jax.numpy as jnp  # noqa: E402

import jwave_pro as jw  # noqa: E402
from jwave_pro.utils.signals import chirp, ecg_like  # noqa: E402


def err_of(fn, x):
    return float(jax.jit(lambda v: jnp.max(jnp.abs(fn(v) - v)))(x))


def main():
    # JWAVE_EVAL_CONFIGS="1,3,5" runs a subset.
    sel = os.environ.get("JWAVE_EVAL_CONFIGS", "1,2,3,4,5")
    want = {int(t) for t in sel.split(",")}
    print(f"backend: {jax.devices()[0].platform} (configs {sorted(want)})")
    rng = np.random.default_rng(0)
    f32 = jnp.float32

    if 1 in want:
        haar = jw.wavelet("Haar")
        x8 = jnp.asarray(rng.standard_normal(8))
        e = err_of(lambda v: jw.ifwt(jw.fwt(v, haar), haar), x8)
        print(f"1. Haar FWT len-8 roundtrip:            {e:.2e}")

    if 2 in want:
        db4 = jw.wavelet("Daubechies 4")
        x1 = jnp.asarray(rng.standard_normal((4, 1 << 20)), dtype=f32)
        e = err_of(lambda v: jw.ifwt(jw.fwt(v, db4), db4), x1)
        print(f"2a. Db4 FWT 1D 2^20 roundtrip:          {e:.2e}")
        x2 = jnp.asarray(rng.standard_normal((1024, 1024)), dtype=f32)
        e = err_of(lambda v: jw.ifwt2(jw.fwt2(v, db4), db4), x2)
        print(f"2b. Db4 FWT 2D 1024^2 roundtrip:        {e:.2e}")

    if 3 in want:
        db4 = jw.wavelet("Daubechies 4")
        xs = jnp.asarray(rng.standard_normal(100_003), dtype=f32)
        e = err_of(lambda v: jw.imodwt(jw.modwt(v, db4, 5), db4), xs)
        print(f"3a. MODWT Db4 L5 N=100003 roundtrip:    {e:.2e}")
        noisy = jnp.asarray(
            np.sin(np.linspace(0, 40 * np.pi, 4096))
            + 0.3 * rng.standard_normal(4096), dtype=f32)
        den = jax.jit(lambda v: jw.modwt_denoise(v, db4, 4))(noisy)
        clean = jnp.sin(jnp.linspace(0, 40 * jnp.pi, 4096))
        mse_n = float(jnp.mean((noisy - clean) ** 2))
        mse_d = float(jnp.mean((den - clean) ** 2))
        print(f"3b. MODWT denoise MSE: {mse_n:.4f} -> {mse_d:.4f} "
              f"({'improved' if mse_d < mse_n else 'WORSE'})")

    if 4 in want:
        sym8 = jw.wavelet("Symlet 8")
        xw = jnp.asarray(rng.standard_normal(65536), dtype=f32)
        e = err_of(lambda v: jw.iwpt(jw.wpt(v, sym8, 6), sym8, 6), xw)
        print(f"4a. WPT Sym8 L6 65536 roundtrip:        {e:.2e}")
        sig = jnp.asarray(chirp(65536, 1, 400, 8000.0), dtype=f32)
        masks, cost, tree = jw.best_basis(sig, sym8, 6)
        flat = jw.basis_coefficients(tree, masks)
        e = float(jnp.max(jnp.abs(
            jw.basis_reconstruct(flat, masks, sym8) - sig)))
        leaves = sum(int(np.sum(np.asarray(m))) for m in masks)
        print(f"4b. best basis: {leaves} leaves, cost {float(cost):.1f}, "
              f"reconstruction {e:.2e}")

    if 5 in want:
        wav = jw.MorletWavelet.from_omega0(6.0)
        scales = jw.generate_log_scales(1.0, 256.0, 64)
        batch = jnp.asarray(np.stack([chirp(4096, 1, 100, 1000.0),
                                      ecg_like(4096, fs=360.0)]), dtype=f32)
        # Parity of the banded path vs the irfft formulation — a
        # wrong-but-finite band plan must FAIL here, so reduce
        # max|banded − fft| on device.
        stats = jax.jit(lambda v: (
            jnp.max(jnp.abs(jw.cwt(v, scales, wav, 360.0).coefficients)),
            jnp.max(jnp.abs(
                jw.cwt(v, scales, wav, 360.0, method="banded").coefficients
                - jw.cwt(v, scales, wav, 360.0,
                         method="fft").coefficients))))(batch)
        mag, dev = (float(s) for s in stats)
        bound = 2e-5 * max(mag, 1.0)
        status = "OK" if dev <= bound else "FAIL"
        print(f"5. CWT Morlet(6.0) 64-scale batched:    max|c| = "
              f"{mag:.3f}, banded-vs-fft parity {dev:.2e} "
              f"(bound {bound:.1e}) {status}")
        if dev > bound:
            raise SystemExit("config 5 FAILED: banded CWT diverges from "
                             "the irfft reference path")

    print("eval configs: DONE")


if __name__ == "__main__":
    main()
