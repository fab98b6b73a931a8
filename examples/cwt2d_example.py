#!/usr/bin/env python3
"""2D CWT image analysis: blob scale-space + texture orientation.

Beyond the reference's (1D-only) CWT tier: the Antoine–Murenzi 2D CWT
(`jw.cwt2`) with

  * the isotropic Mexican Hat (LoG) — blob detection: the scale response at
    a blob's center peaks at a = √3·σ_blob (L2 normalization), and the
    real half-plane fast path returns REAL coefficients at half the HBM
    traffic;
  * the directional Morlet — orientation-selective texture analysis: the
    (scale × angle) energy grid localizes each texture patch's stripe
    direction and period.

Whole (scale × angle) grids are one batched FFT product — on a mesh the
plane axis shards with zero communication (`parallel.cwt2_sharded`).
"""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import _bootstrap  # noqa: E402,F401 — repo path, CPU mesh

import jwave_pro as jw  # noqa: E402


def main():
    rng = np.random.default_rng(0)
    n = 256

    # --- blob detection with the LoG scale space ------------------------
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64)
    blobs = [(64, 64, 3.0), (64, 192, 6.0), (192, 128, 12.0)]
    img = 0.05 * rng.standard_normal((n, n))
    for (cy, cx, s) in blobs:
        img += np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))

    scales = np.exp(np.linspace(np.log(2.0), np.log(32.0), 25))
    res = jw.cwt2(img, scales, jw.MexicanHat2D())
    coeff = np.asarray(res.coefficients)   # REAL: (S, H, W)
    print(f"LoG scale space: {coeff.shape} {coeff.dtype}")
    print(f"{'blob σ':>7} {'detected a':>11} {'√3·σ (theory)':>14}")
    for (cy, cx, s) in blobs:
        a_hat = scales[np.abs(coeff[:, cy, cx]).argmax()]
        print(f"{s:7.1f} {a_hat:11.2f} {np.sqrt(3) * s:14.2f}")

    # --- texture orientation with the directional Morlet ----------------
    theta_true, period = np.pi / 6, 12.0
    k = 2 * np.pi / period
    tex = np.cos(k * (np.cos(theta_true) * xx + np.sin(theta_true) * yy))
    tex += 0.2 * rng.standard_normal((n, n))

    w = jw.Morlet2D()
    a_match = w.k0 / k
    angles = np.linspace(0, np.pi, 18, endpoint=False)
    rt = jw.cwt2(tex, [a_match / 1.5, a_match, a_match * 1.5], w,
                 angles=angles)
    energy = np.asarray(rt.scalogram)      # (S, A)
    si, ai = np.unravel_index(energy.argmax(), energy.shape)
    p_hat = 2 * np.pi * float(np.asarray(rt.scales)[si]) / w.k0
    print(f"\ntexture: detected θ={np.degrees(angles[ai]):.0f}° "
          f"(true {np.degrees(theta_true):.0f}°), "
          f"period={p_hat:.1f} (true {period:.0f})")


if __name__ == "__main__":
    main()
