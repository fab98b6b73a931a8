#!/usr/bin/env python3
"""Scale-resolved market analysis with the fused MODWT pipelines.

The reference proposes this workflow in ``docs/FINANCIAL_ROADMAP.md``
("PROPOSED — Not Yet Implemented"); here it runs end-to-end, on a CUDA
GPU through the single-pass fused MODWT kernels:

  * wavelet variance of returns by horizon (which time scales carry risk),
  * wavelet covariance/correlation between two series by horizon
    (lead/lag structure — polarization identity, two fused passes),
  * lagged wavelet cross-correlation (HOW MANY ticks one series leads
    the other, per horizon),
  * time-resolved squared wavelet coherence (when and at what scale the
    two series locked together),
  * MODWT soft-threshold denoising of the price path
    (forward → shrink → inverse in ONE kernel; the coefficients never
    exist in memory).

On the CPU the same code runs on the XLA paths with identical semantics.
"""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import _bootstrap  # noqa: E402,F401 — repo path, CPU mesh

import jwave_pro as jw  # noqa: E402


def synth_returns(n, rng, vol_scale):
    """AR(1)-ish returns with volatility clustered at a chosen horizon."""
    base = rng.standard_normal(n)
    env = 1.0 + 0.8 * np.sin(2 * np.pi * np.arange(n) / vol_scale)
    return (base * env).astype(np.float32)


def main():
    rng = np.random.default_rng(7)
    n = 1 << 15
    level = 8
    w = jw.wavelet("Daubechies 4")

    # --- r4: the FINANCIAL_ROADMAP.md preprocessing chain --------------
    # dirty prices: gaps (halted sessions), a fat-finger print, and a
    # volatility regime switch — preprocess_prices gap-fills, winsorizes
    # (MAD-robust), and devolatizes (causal EWMA) in one jittable call
    clean_r = np.concatenate([0.01 * rng.standard_normal(n // 2),
                              0.04 * rng.standard_normal(n // 2)])
    prices = 100.0 * np.exp(np.cumsum(clean_r))
    prices[5000:5040] = np.nan                       # a halted session
    prices[20000] *= 1.5                             # a bad print
    z, sigma = jw.preprocess_prices(prices)
    z = np.asarray(z)
    print("preprocess: gaps filled, outlier winsorized; devolatized std "
          f"regime1 {np.std(z[1000:n // 2 - 100]):.2f} / regime2 "
          f"{np.std(z[n // 2 + 1000:]):.2f} (clustering removed ≈ both 1)")

    # where did the volatility regime switch?  NCSS change-point test on
    # the RAW (un-devolatized) returns localizes it per scale
    raw_r = jw.winsorize_outliers(jw.log_returns(jw.fill_gaps(prices)))
    cp = jw.modwt_changepoints(raw_r, w, 5)
    fired = [f"j={j + 1}@t={int(np.asarray(cp.locations)[j])}"
             for j in range(5) if bool(np.asarray(cp.significant)[j])]
    print(f"variance change points (true break t={n // 2}): "
          + (", ".join(fired) if fired else "none"))

    # two co-moving series: y trails x at coarse scales
    x = synth_returns(n, rng, 512.0)
    y = 0.6 * np.roll(x, 16) + 0.8 * synth_returns(n, rng, 64.0)

    # --- variance by horizon (fused single-pass kernel on a GPU) -------
    nu2_x = np.asarray(jw.modwt_variance(x, w, level))
    nu2_y = np.asarray(jw.modwt_variance(y, w, level))
    cov = np.asarray(jw.modwt_covariance(x, y, w, level))
    rho = cov / np.sqrt(nu2_x * nu2_y)

    print(f"{'scale j':>8} {'~period':>8} {'var(x)':>9} {'var(y)':>9} "
          f"{'corr':>6}")
    for j in range(level):
        print(f"{j + 1:8d} {2 ** (j + 1):8d} {nu2_x[j]:9.4f} "
              f"{nu2_y[j]:9.4f} {rho[j]:6.2f}")
    print(f"variance partition check: Σν² + mean(V²) = "
          f"{nu2_x.sum() + np.mean(np.asarray(jw.modwt(x, w, level))[level] ** 2):.4f}"
          f" vs mean(x²) = {np.mean(x ** 2):.4f}")

    # --- statistically honest version: unbiased estimator + 95% CI -----
    # (Percival-Walden brick-wall over reflection-extended series)
    ci = jw.modwt_variance_ci(x, w, 6, confidence=0.95,
                              estimator="unbiased", boundary="reflect")
    print(f"\n{'scale j':>8} {'var(x)':>9} {'95% CI':>23} {'edf':>7}")
    for j in range(6):
        print(f"{j + 1:8d} {float(ci.variance[j]):9.4f} "
              f"[{float(ci.lower[j]):9.4f}, {float(ci.upper[j]):9.4f}] "
              f"{ci.edf[j]:7.0f}")

    # --- lead/lag by horizon: lagged wavelet cross-correlation ---------
    max_lag = 24
    cc = np.asarray(jw.modwt_cross_correlation(x, y, w, level, max_lag))
    print(f"\n{'scale j':>8} {'lead (ticks)':>13} {'peak corr':>10}")
    for j in range(level):
        k = int(cc[j].argmax())
        print(f"{j + 1:8d} {k - max_lag:13d} {cc[j, k]:10.2f}")
    print("(y = 0.6·roll(x, 16) + noise → peak near lag +16: "
          "x leads y by 16 ticks)")

    # --- time-resolved co-movement: squared wavelet coherence ----------
    scales = np.asarray(jw.generate_log_scales(4, 256, 24))
    wtc = jw.wavelet_coherence(x, y, scales)
    r2 = np.asarray(wtc.coherence)
    srow = int(r2.mean(axis=-1).argmax())
    print(f"\ncoherence: strongest co-movement at scale "
          f"a≈{float(np.asarray(wtc.scales)[srow]):.0f} "
          f"(mean R²={r2[srow].mean():.2f}; "
          f"global mean {r2.mean():.2f})")

    # --- denoise a smooth trend (single-pass fused kernel) -------------
    t = np.arange(n, dtype=np.float32) / n
    price = (100.0 + 8.0 * np.sin(2 * np.pi * 3 * t)
             + 4.0 * np.sin(2 * np.pi * 11 * t)).astype(np.float32)
    noisy = price + 2.0 * rng.standard_normal(n).astype(np.float32)
    den = np.asarray(jw.modwt_denoise(noisy, w, 6))
    mse_before = float(np.mean((noisy - price) ** 2))
    mse_after = float(np.mean((den - price) ** 2))
    print(f"denoise: MSE {mse_before:.3f} -> {mse_after:.3f} "
          f"({'improved' if mse_after < mse_before else 'worse'})")

    # --- long memory: wavelet Hurst exponent ---------------------------
    # returns (fgn convention): white-ish → H ≈ 0.5; persistent series
    # (here: smoothed returns) → H > 0.5
    h_ret = float(jw.modwt_hurst(x, w, level))
    # persistent fGn-like series (H=0.75) via spectral synthesis
    h_true = 0.75
    fgrid = np.fft.rfftfreq(n)
    amp = np.zeros_like(fgrid)
    amp[1:] = fgrid[1:] ** (-(2 * h_true - 1) / 2.0)
    z = rng.standard_normal(fgrid.size) + 1j * rng.standard_normal(fgrid.size)
    persistent = np.fft.irfft(z * amp, n=n).astype(np.float32)
    h_per = float(jw.modwt_hurst(persistent, w, level))
    print(f"\nHurst (returns): {h_ret:.2f} (≈0.5 = no memory); "
          f"synthetic persistent series: {h_per:.2f} (true 0.75)")

    # --- regime timing: synchrosqueezed CWT ----------------------------
    # a volatility cycle that switches period mid-sample shows up as a
    # sharp ridge jump in the synchrosqueezed plane (the plain scalogram
    # smears it across scales)
    fs = 1.0
    seg = n // 2
    vol = np.concatenate([
        np.sin(2 * np.pi * np.arange(seg) / 256.0),
        np.sin(2 * np.pi * np.arange(seg) / 64.0)]).astype(np.float32)
    scales_s = jw.generate_log_scales(16.0, 512.0, 48)
    res = jw.ssq_cwt(vol, scales_s, sampling_rate=fs)
    mag = np.abs(np.asarray(res.Tx))
    freqs = np.asarray(res.ssq_freqs)
    f_first = freqs[mag[:, seg // 2].argmax()]
    f_second = freqs[mag[:, seg + seg // 2].argmax()]
    print(f"ssq regime detection: period {1 / f_first:.0f} ticks → "
          f"{1 / f_second:.0f} ticks (true: 256 → 64)")


if __name__ == "__main__":
    main()
