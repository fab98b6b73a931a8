"""Console demo (``jwave/JWave.java:40-124`` analog).

Usage::

    python -m jwave_pro.cli "Fast Wavelet Transform" "Daubechies 4"

Builds the named transform, runs a forward/reverse round trip on a constant
length-16 array and prints the three arrays — exactly the reference's toy
demo, on whatever JAX backend is active.
"""
from __future__ import annotations

import sys

import numpy as np


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    t_name = argv[0] if argv else "Fast Wavelet Transform"
    w_name = argv[1] if len(argv) > 1 else "Haar"

    from .transforms import build_transform

    try:
        t = build_transform(t_name, w_name)
    except ValueError as e:
        print(f"error: {e}")
        return 1

    x = np.ones(16)
    print(f"transform: {t_name}  wavelet: {w_name}")
    print("time domain:     ", np.array2string(x, precision=4))
    y = np.asarray(t.forward(x))
    print("hilbert domain:  ", np.array2string(y, precision=4))
    xr = np.asarray(t.reverse(y))
    print("reconstructed:   ", np.array2string(xr, precision=4))
    err = float(np.max(np.abs(xr - x)))
    print(f"max |x - rec| = {err:.3e}")
    return 0 if err < 1e-6 else 2


if __name__ == "__main__":
    raise SystemExit(main())
