"""Volume-processing tour: the 3D tier — 3D MODWT analysis,
shift-invariant volume denoising, and 3D multiresolution bands.

Run on CPU with: JAX_PLATFORMS=cpu python examples/volume_processing_example.py

The 3D MODWT runs the XLA separable path (cols, rows, then depth per
level).
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _bootstrap  # noqa: E402,F401 — repo path, CPU mesh

import numpy as np

import jwave_pro as jw


def make_volume(n=32):
    """Piecewise-smooth test volume: a ball + an oriented 3D texture."""
    zg, xg, yg = np.meshgrid(np.arange(n), np.arange(n), np.arange(n),
                             indexing="ij")
    ball = (((zg - n / 2) ** 2 + (xg - n / 2) ** 2 + (yg - n / 2) ** 2)
            < (n / 4) ** 2) * 1.0
    texture = 0.4 * np.sin((zg + xg + 2 * yg) / 3.0)
    return ball + texture


def main():
    rng = np.random.default_rng(7)
    w = jw.wavelet("Daubechies 4")
    clean = make_volume(32)
    noisy = clean + 0.3 * rng.standard_normal(clean.shape)

    # --- 3D MODWT analysis: 7 detail octants per level + LLL ----------
    c = np.asarray(jw.modwt3(noisy, w, 2))
    names = ["LLH", "LHL", "LHH", "HLL", "HLH", "HHL", "HHH"]
    print("3D MODWT octant energies (level 1):")
    for k, nm in enumerate(names):
        print(f"  {nm}1: {float(np.sum(c[k] ** 2)):8.1f}")
    print(f"  LLL2 (approximation): {float(np.sum(c[-1] ** 2)):8.1f}")

    # --- shift-invariant volume denoising -----------------------------
    for kind in (None, "bayes"):
        den = np.asarray(jw.modwt3_denoise(noisy, w, 2, threshold=kind))
        mse_n = float(np.mean((noisy - clean) ** 2))
        mse_d = float(np.mean((den - clean) ** 2))
        print(f"denoise ({kind or 'universal'}): MSE {mse_n:.4f} -> "
              f"{mse_d:.4f} ({mse_n / mse_d:.1f}x better)")

    # --- 3D packet oct-tree: 8 shift-invariant full-resolution nodes --
    oc = np.asarray(jw.modwpt3(noisy, w, 1))
    energies = (oc ** 2).sum(axis=(-3, -2, -1))
    print("modwpt3 L1 oct-tree node energies (d,r,c sequency order):")
    for nd in range(2):
        for nr_ in range(2):
            row = "  ".join(f"({nd},{nr_},{ncl}): {energies[nd, nr_, ncl]:8.1f}"
                            for ncl in range(2))
            print("  " + row)
    rt = float(np.max(np.abs(np.asarray(jw.imodwpt3(oc, w)) - noisy)))
    print(f"oct-tree roundtrip: max err {rt:.2e}")

    # --- additive 3D MRA: per-band components sum back to the volume --
    mra = np.asarray(jw.modwt3_mra(noisy, w, 1))
    recon = mra.sum(axis=0)
    print(f"3D MRA additivity: {mra.shape[0]} bands, "
          f"max |sum - volume| = {float(np.max(np.abs(recon - noisy))):.2e}")


if __name__ == "__main__":
    main()
