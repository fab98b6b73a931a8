#!/usr/bin/env python3
"""Pin drift-regression vectors for the spectral subsystems.

Unlike ``tests/golden/golden.npz`` (independent numpy oracles), these are
the LIBRARY'S OWN float64 CPU outputs, committed to catch unintended drift
when the implementations are refactored (the SSQ reassignment and
scattering paths have gone through several performance rewrites; their
semantics are property-tested, and this file pins the exact values on top).
Regenerate deliberately with ``python tools/generate_regression.py`` after
an INTENDED semantic change, and say so in the commit message.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

import jwave_pro as jw  # noqa: E402

OUT = ROOT / "tests" / "golden"


def main():
    rng = np.random.default_rng(20260818)
    fs = 256.0
    t = np.arange(512) / fs
    x = (np.sin(2 * np.pi * 30 * t)
         + 0.5 * np.sin(2 * np.pi * 80 * t)
         + 0.1 * rng.standard_normal(512))
    payload = {"input_512": x}

    fc = float(jw.MorletWavelet().center_frequency)
    scales = np.asarray(jw.generate_log_scales(fc / 120, fc / 15, 16))
    payload["ssq_scales"] = scales
    res = jw.ssq_cwt(x, scales, sampling_rate=fs, gamma=1e-6)
    payload["ssq_Tx"] = np.asarray(res.Tx)
    payload["ssq_freqs"] = np.asarray(res.ssq_freqs)

    rid = jw.extract_ridges(res.Tx, res.ssq_freqs, n_ridges=2, mask_width=2)
    payload["ridge_indices"] = np.asarray(rid.indices)

    sc = jw.scattering1d(x.astype(np.float64), j=4, q=2)
    payload["scat_s0"] = np.asarray(sc.s0)
    payload["scat_s1"] = np.asarray(sc.s1)
    payload["scat_s2"] = np.asarray(sc.s2)

    w = jw.wavelet("Daubechies 4")
    ci = jw.modwt_variance_ci(x, w, 4, estimator="unbiased",
                              boundary="reflect")
    payload["varci_var"] = np.asarray(ci.variance)
    payload["varci_lo"] = np.asarray(ci.lower)
    payload["varci_hi"] = np.asarray(ci.upper)
    payload["varci_edf"] = ci.edf

    np.savez_compressed(OUT / "regression.npz", **payload)
    print(f"wrote {OUT/'regression.npz'} with {len(payload)} arrays")


if __name__ == "__main__":
    main()
