"""Image-processing tour: shift-invariant denoising, adaptive-basis
compression, and scattering features — the 2D tier in one script.

Run on CPU with: JAX_PLATFORMS=cpu python examples/image_processing_example.py
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _bootstrap  # noqa: E402,F401 — repo path, CPU mesh

import numpy as np

import jwave_pro as jw


def make_image(n=128, rng=None):
    """Piecewise-smooth test image: disk + oriented texture."""
    rng = rng or np.random.default_rng(0)
    xg, yg = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    disk = ((xg - n / 2) ** 2 + (yg - n / 2) ** 2 < (n / 4) ** 2) * 1.0
    texture = 0.4 * np.sin((xg + 2 * yg) / 3.0)
    return disk + texture


def main():
    rng = np.random.default_rng(7)
    w = jw.wavelet("Symlet 8")
    clean = make_image(128, rng)
    noisy = clean + 0.3 * rng.standard_normal(clean.shape)

    # --- 1. shift-invariant denoising (2D MODWT + BayesShrink) ----------
    def psnr(a):
        return 10 * np.log10(np.ptp(clean) ** 2 / np.mean((a - clean) ** 2))

    den = np.asarray(jw.modwt2_denoise(noisy, w, 4, threshold="bayes"))
    print(f"denoise: PSNR {psnr(noisy):.1f} dB -> {psnr(den):.1f} dB "
          f"(BayesShrink, undecimated — fully shift-equivariant)")

    # --- 2. adaptive-basis compression (quad-tree best basis) -----------
    masks, cost, tree = jw.best_basis2(clean, w, 4, cost="threshold")
    flat = np.asarray(jw.basis_coefficients2(tree, masks))
    keep = 0.05  # keep the top 5% of coefficients
    k = int(flat.size * keep)
    thr = np.partition(np.abs(flat).ravel(), -k)[-k]
    comp = np.where(np.abs(flat) >= thr, flat, 0.0)
    rec = np.asarray(jw.basis_reconstruct2(comp, masks, w))
    err = np.linalg.norm(rec - clean) / np.linalg.norm(clean)
    leaves = sum(int(m.sum()) for m in masks)
    print(f"compression: best basis has {leaves} leaf packets; top-{keep:.0%}"
          f" coefficients rebuild the image at {err:.1%} relative error")

    # --- 3. scattering features (translation-invariant texture) ---------
    s = jw.scattering2d(clean.astype(np.float32), j=3, l=6)
    s_roll = jw.scattering2d(
        np.roll(np.roll(clean, 8, 0), 8, 1).astype(np.float32), j=3, l=6)
    fa = np.asarray(s.stack()).mean(axis=(-2, -1))
    fb = np.asarray(s_roll.stack()).mean(axis=(-2, -1))
    drift = np.abs(fa - fb).max() / np.abs(fa).max()
    print(f"scattering: {fa.shape[0]} paths; global features drift "
          f"{drift:.2e} under an 8-pixel shift (translation-invariant)")


if __name__ == "__main__":
    main()
