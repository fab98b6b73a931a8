#!/usr/bin/env python3
"""CWT scalogram of a chirp (``jwave/examples/CWTExample.java`` analog) plus
the Paul/DOG/Meyer wavelet demos collapsed into one batched run."""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import _bootstrap  # noqa: E402,F401 — repo path, CPU mesh

import jwave_pro as jw  # noqa: E402
from jwave_pro.utils.signals import chirp  # noqa: E402


def main():
    fs = 1000.0
    x = chirp(1024, f0=5.0, f1=100.0, fs=fs)
    scales = jw.generate_log_scales(0.002, 0.2, 64)

    for wav in (jw.MorletWavelet(), jw.PaulWavelet(4), jw.DOGWavelet(2),
                jw.MeyerWavelet()):
        res = jw.cwt(x, scales, wav, sampling_rate=fs)
        mag = np.asarray(res.magnitude)
        ridge = scales[np.argmax(mag, axis=0)]
        f_start = wav.center_frequency / ridge[100]
        f_end = wav.center_frequency / ridge[-100]
        print(f"{wav.name:22s} scalogram {mag.shape}  ridge f: "
              f"{f_start:7.1f} Hz → {f_end:7.1f} Hz")


if __name__ == "__main__":
    main()
