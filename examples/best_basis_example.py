#!/usr/bin/env python3
"""Best-basis selection demo (the feature the reference README advertises
but never implemented — SURVEY §6)."""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import _bootstrap  # noqa: E402,F401 — repo path, CPU mesh

import jwave_pro as jw  # noqa: E402


def main():
    n = 1024
    t = np.arange(n) / n
    # two chirping bursts + a tone: a signal with structure at mixed depths
    x = (np.sin(2 * np.pi * 40 * t)
         + np.exp(-((t - 0.3) / 0.02) ** 2) * np.sin(2 * np.pi * 200 * t)
         + np.exp(-((t - 0.7) / 0.05) ** 2) * np.sin(2 * np.pi * 90 * t))

    w = jw.wavelet("Symlet 8")
    masks, cost, tree = jw.best_basis(x, w, level=6)
    flat = jw.basis_coefficients(tree, masks)

    full_cost = float(jw.shannon_entropy_cost(np.asarray(tree[6])))
    sig_cost = float(jw.shannon_entropy_cost(np.asarray(x)))
    print(f"entropy: signal {sig_cost:9.3f} | full level-6 WPT "
          f"{full_cost:9.3f} | best basis {float(cost):9.3f}")
    for lvl, m in enumerate(masks):
        k = int(np.sum(np.asarray(m)))
        if k:
            print(f"  level {lvl}: {k} leaf packets "
                  f"(width {n >> lvl} each)")

    xr = np.asarray(jw.basis_reconstruct(flat, masks, w))
    print(f"reconstruction max-abs-err: {np.abs(xr - x).max():.2e}")

    kept = np.asarray(jw.compress_magnitude(np.asarray(flat)))
    rate = float(jw.compression_rate(kept))
    xr2 = np.asarray(jw.basis_reconstruct(kept, masks, w))
    rel = np.linalg.norm(xr2 - x) / np.linalg.norm(x)
    print(f"magnitude-compressed basis: {rate:.1f}% zeros, "
          f"relative error {rel:.3f}")

    # --- best-basis DENOISING (r4): adapt the basis, then shrink -------
    # Interfering tones are the octave tree's blind spot — their energy
    # lands in wide detail bands and universal thresholding crushes them.
    # The adaptive packet basis places narrow bands on each tone.
    rng = np.random.default_rng(0)
    tones = (np.sin(2 * np.pi * 0.11 * np.arange(n))
             + np.sin(2 * np.pi * 0.13 * np.arange(n)))
    noisy = tones + 0.6 * rng.standard_normal(n)
    den_bb = np.asarray(jw.wpt_denoise(noisy, w, 6, mode="hard"))
    den_oct = np.asarray(jw.modwt_denoise(noisy, w, 6, mode="hard"))
    print(f"interfering-tones denoise MSE: noisy "
          f"{np.mean((noisy - tones) ** 2):.3f} | octave tree "
          f"{np.mean((den_oct - tones) ** 2):.3f} | best basis "
          f"{np.mean((den_bb - tones) ** 2):.3f}")


if __name__ == "__main__":
    main()
