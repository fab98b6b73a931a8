#!/usr/bin/env python3
"""MODWPT demo: shift-invariant packet band analysis (1D) and quad-tree
texture energies (2D) — the transform tier the reference's decimated packet
engine (WaveletPacketTransform.java) implies but never makes
shift-invariant."""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import _bootstrap  # noqa: E402,F401 — repo path, CPU mesh

import jwave_pro as jw  # noqa: E402


def main():
    # --- 1D: uniform band decomposition of a dual-tone + burst ------------
    fs, n = 1000.0, 2048
    t = np.arange(n) / fs
    x = (np.sin(2 * np.pi * 60 * t) + 0.7 * np.sin(2 * np.pi * 215 * t)
         + np.exp(-((t - 1.2) / 0.01) ** 2) * np.sin(2 * np.pi * 380 * t))

    w = jw.wavelet("Symlet 8")
    level = 4                              # 16 uniform bands of fs/32 Hz
    nodes = np.asarray(jw.modwpt(x, w, level))
    band_hz = fs / 2 / (1 << level)
    energies = np.sum(nodes**2, axis=-1)
    print(f"MODWPT level {level}: {1 << level} bands of {band_hz:.1f} Hz")
    for nd in np.argsort(energies)[::-1][:3]:
        print(f"  band [{nd * band_hz:5.1f}, {(nd + 1) * band_hz:5.1f}) Hz"
              f"  energy {energies[nd]:8.2f}")

    # band-limited components sum exactly to the signal
    comps = np.asarray(jw.modwpt_mra(x, w, level))
    print(f"  MRA additivity max-err: "
          f"{np.abs(comps.sum(axis=0) - x).max():.2e}")

    # shift-invariance: the energy profile ignores circular shifts
    e_shift = np.sum(np.asarray(jw.modwpt(np.roll(x, 123), w, level))**2,
                     axis=-1)
    print(f"  shift-invariant band energies max-rel-err: "
          f"{np.abs(e_shift / energies - 1).max():.2e}")

    # --- 2D: quad-tree orientation/scale texture signature ----------------
    size = 128
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    texture = (np.sin(2 * np.pi * 0.18 * xx)            # vertical stripes
               + 0.5 * np.sin(2 * np.pi * 0.30 * (xx + yy) / np.sqrt(2)))

    q = np.asarray(jw.modwpt2(texture, jw.wavelet("Daubechies 4"), 2))
    e2 = np.sum(q**2, axis=(-2, -1))
    print(f"\nMODWPT2 level 2: {e2.shape[0]}x{e2.shape[1]} frequency cells")
    top = np.dstack(np.unravel_index(np.argsort(e2.ravel())[::-1][:2],
                                     e2.shape))[0]
    for nr, nc in top:
        print(f"  cell (row-band {nr}, col-band {nc}) "
              f"energy {e2[nr, nc]:9.1f}")
    rec = np.asarray(jw.imodwpt2(jw.modwpt2(texture,
                                            jw.wavelet("Daubechies 4"), 2),
                                 jw.wavelet("Daubechies 4")))
    print(f"  roundtrip max-abs-err: {np.abs(rec - texture).max():.2e}")


if __name__ == "__main__":
    main()
