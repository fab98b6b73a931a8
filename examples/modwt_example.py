#!/usr/bin/env python3
"""MODWT walkthrough (``jwave/examples/MODWTExample.java`` analog):
decomposition, soft-threshold denoising, multi-resolution analysis."""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import _bootstrap  # noqa: E402,F401 — repo path, CPU mesh

import jwave_pro as jw  # noqa: E402


def basic_decomposition():
    print("=== Basic MODWT Decomposition ===")
    n = 256
    i = np.arange(n)
    x = np.sin(2 * np.pi * i / 64.0) + 0.3 * np.cos(2 * np.pi * i / 16.0)
    w = jw.wavelet("Daubechies 4")
    coeffs = jw.modwt(x, w, 4)
    for j in range(4):
        e = float(np.sum(np.asarray(coeffs[j]) ** 2))
        print(f"  W_{j+1} energy: {e:10.4f}")
    print(f"  V_4 energy: {float(np.sum(np.asarray(coeffs[4])**2)):10.4f}")
    rec = np.asarray(jw.imodwt(coeffs, w))
    rms = float(np.sqrt(np.mean((rec - x) ** 2)))
    print(f"  reconstruction RMS error: {rms:.2e}  "
          f"(perfect: {'YES' if rms < 1e-6 else 'NO'})")


def denoising():
    print("\n=== Denoising (soft threshold) ===")
    n = 256
    i = np.arange(n)
    clean = np.sin(2 * np.pi * i / 64.0) + 0.3 * np.cos(2 * np.pi * i / 16.0)
    rng = np.random.default_rng(7)
    noisy = clean + 0.25 * rng.standard_normal(n)
    w = jw.wavelet("Daubechies 4")
    # default threshold = universal sigma*sqrt(2 ln N) from level-1 details
    den = np.asarray(jw.modwt_denoise(noisy, w, 4))
    print(f"  noisy  MSE: {np.mean((noisy - clean) ** 2):.5f}")
    print(f"  denoised MSE: {np.mean((den - clean) ** 2):.5f}")


def mra():
    print("\n=== Multi-Resolution Analysis ===")
    from jwave_pro.utils.signals import noisy_sine
    x, _ = noisy_sine(128, oscillations=4)
    w = jw.wavelet("Symlet 8")
    comps = np.asarray(jw.modwt_mra(x, w, 3))
    print(f"  D_1..D_3 + S_3 shapes: {comps.shape}")
    err = np.abs(comps.sum(axis=0) - x).max()
    print(f"  additivity |ΣD_j + S_J − x|∞ = {err:.2e}")


if __name__ == "__main__":
    basic_decomposition()
    denoising()
    mra()
