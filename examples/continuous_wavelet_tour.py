"""Tour of the continuous-wavelet family APIs — properties, presets, and
the classic analysis patterns.

Parity walk of the reference's three family deep-dive examples:
``PaulWaveletExample.java`` (properties / chirp frequency analysis / phase
analysis), ``DOGWaveletExample.java`` (preset types / edge detection /
singularity analysis across orders / Mexican-Hat equivalence) and
``MeyerWaveletExample.java`` (ψ, ψ̂ tables / dominant-frequency analysis).
All transforms run batched through the one jitted CWT entry point; scale
grids and property tables are host-side f64 exactly like the filter banks.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _bootstrap  # noqa: E402,F401 — repo path, CPU mesh

import numpy as np

import jax.numpy as jnp

import jwave_pro as jw


def properties_table():
    """Per-family property walk (Paul §1, DOG §1, Meyer header)."""
    print("1. Wavelet properties")
    print("---------------------")
    fams = ([jw.PaulWavelet(m) for m in (2, 4, 6, 8)]
            + [jw.DOGWavelet.standard(k) for k in
               ("edge", "mexican_hat", "zero_crossing", "ridge")]
            + [jw.MeyerWavelet(), jw.MorletWavelet()])
    hdr = f"{'wavelet':<22}{'fc [Hz]':>9}{'C_psi':>9}" \
          f"{'support':>18}{'bandwidth [Hz]':>18}"
    print(hdr)
    for w in fams:
        lo, hi = w.effective_support()
        b0, b1 = w.bandwidth()
        print(f"{w.name:<22}{w.center_frequency:>9.3f}"
              f"{w.admissibility_constant():>9.3f}"
              f"{f'[{lo:.1f}, {hi:.1f}]':>18}"
              f"{f'[{b0:.3f}, {b1:.3f}]':>18}")


def paul_chirp_tracking():
    """Chirp instantaneous-frequency tracking with Paul m=8 (Paul §2)."""
    print("\n2. Paul m=8: linear chirp 10→50 Hz")
    print("----------------------------------")
    n, fs = 512, 256.0
    t = np.arange(n) / fs
    x = jnp.asarray(np.sin(2 * np.pi * (10 * t + 10 * t * t)))  # f = 10+20t
    paul = jw.PaulWavelet(8)
    freqs = np.linspace(5.0, 60.0, 20)
    # physical-unit scales: f = fc/a (CWTResult.java's scaleToFrequency
    # fc·fs/a is a sample-unit reference quirk — see tests/test_cwt.py)
    scales = paul.center_frequency / freqs
    res = jw.cwt(x, scales, paul, sampling_rate=fs)
    mag = np.asarray(res.magnitude)
    for i in range(64, n - 64, 96):
        f_est = freqs[int(mag[:, i].argmax())]
        f_true = 10 + 20 * t[i]
        print(f"  t={t[i]:.2f}s  tracked {f_est:5.1f} Hz  "
              f"(instantaneous {f_true:5.1f} Hz)")


def paul_phase_jump():
    """Analytic phase across a π/2 jump (Paul §3)."""
    print("\n3. Paul m=4: phase of a 20 Hz tone with a π/2 jump at t=0.5 s")
    print("--------------------------------------------------------------")
    n, fs, f0 = 256, 256.0, 20.0
    t = np.arange(n) / fs
    x = np.cos(2 * np.pi * f0 * t + np.pi / 2 * (t >= 0.5))
    paul = jw.PaulWavelet(4)
    scale = paul.center_frequency / f0
    res = jw.cwt(jnp.asarray(x), np.asarray([scale]), paul, sampling_rate=fs)
    # carrier-removed analytic phase: rotate W by e^{-i2πf0t}, then the
    # wrapped angle is the tone's phase offset on each side of the jump
    dev = np.asarray(res.coefficients)[0] * np.exp(-2j * np.pi * f0 * t)
    before = np.angle(dev[n // 4: n // 2 - 8].mean())
    after = np.angle(dev[n // 2 + 8: 3 * n // 4].mean())
    print(f"  carrier-removed phase before jump: {before:+.2f} rad")
    print(f"  carrier-removed phase after jump:  {after:+.2f} rad")
    jump = (after - before + np.pi) % (2 * np.pi) - np.pi
    print(f"  measured jump: {jump:+.2f} rad (true +π/2 = +1.57)")


def dog_edge_detection():
    """Step-edge localization with the DOG 'edge' preset (DOG §2)."""
    print("\n4. DOG edge preset (n=1): step-edge detection")
    print("---------------------------------------------")
    n = 512
    x = np.zeros(n)
    x[n // 4: n // 2] = 1.0
    x[n // 2: 3 * n // 4] = 0.5
    x[3 * n // 4:] = 0.8
    edge = jw.DOGWavelet.standard("edge", 2.0)
    res = jw.cwt(jnp.asarray(x), np.asarray([5.0]), edge, sampling_rate=1.0)
    mag = np.asarray(res.magnitude)[0]
    thr = 0.2 * mag.max()
    # local maxima with plateau handling: edges sit between two samples, so
    # |W| peaks as an equal-valued pair — accept the left end of a plateau
    peaks = [i for i in range(1, n - 1)
             if mag[i] > thr and mag[i] > mag[i - 1] and mag[i] >= mag[i + 1]]
    print(f"  true edges at samples {[n // 4, n // 2, 3 * n // 4]}")
    print(f"  detected |W| maxima at {peaks} (edge falls between sample "
          f"pairs)")


def dog_singularity_orders():
    """Which derivative order responds to which singularity (DOG §3)."""
    print("\n5. DOG orders 1–4 vs singularity type")
    print("-------------------------------------")
    n = 512
    t = np.arange(n, dtype=np.float64)
    sigs = {
        "step (0-order jump)": (t >= n / 2).astype(float),
        "ramp kink (1st-deriv jump)": np.abs(t - n / 2) / n,
        "cusp |t|^0.5": np.sqrt(np.abs(t - n / 2) / n),
    }
    scales = jw.generate_log_scales(1.0, 20.0, 10)
    for label, s in sigs.items():
        print(f"  {label}:")
        for order in (1, 2, 3, 4):
            res = jw.cwt(jnp.asarray(s), scales, jw.DOGWavelet(order),
                         sampling_rate=1.0)
            m = np.asarray(res.magnitude)[:, 64:-64]  # interior only
            k, i = np.unravel_index(m.argmax(), m.shape)
            print(f"    n={order}: max|W|={m.max():7.3f} at scale "
                  f"{np.asarray(scales)[k]:4.1f}, sample {i + 64} "
                  f"(singularity at {n // 2})")


def dog2_vs_mexican_hat():
    """DOG n=2 ≡ Mexican Hat up to normalization (DOG §5)."""
    print("\n6. DOG n=2 vs Mexican Hat")
    print("-------------------------")
    dog2, mex = jw.DOGWavelet.standard("ricker"), jw.MexicanHatWavelet()
    om = np.array([0.1, 0.5, 1.0, 2.0])
    dh = np.abs(np.asarray(dog2.psi_hat(jnp.asarray(om))))
    mh = np.abs(np.asarray(mex.psi_hat(jnp.asarray(om))))
    print("  ω     |DOGψ̂|      |Mexψ̂|      ratio")
    for w, a, b in zip(om, dh, mh):
        print(f"  {w:.1f}  {a:9.6f}  {b:9.6f}   {a / b:.3f}")
    print("  (same ω²e^{-ω²/2} shape — a constant normalization apart;"
          " both CWT paths agree)")
    ts = np.array([0.0, 0.5, 1.5, 2.0])
    dv = np.real(np.asarray(dog2.psi(jnp.asarray(ts))))
    mv = np.real(np.asarray(mex.psi(jnp.asarray(ts))))
    print("  t     DOG(n=2)ψ   MexHat ψ")
    for t, a, b in zip(ts, dv, mv):
        print(f"  {t:.1f}  {a:9.6f}  {b:9.6f}")
    print("  (time-domain profiles differ: the reference evaluates DOG ψ as"
          " Hₙ(t/σ)e^{-t²/2σ²}")
    print("   with the physicists' Hermite — not a true Gaussian derivative"
          " — and we keep its")
    print("   quirk for parity; see DOGWavelet.java:166-176 vs :187-217 and"
          " tests/test_cwt.py)")


def meyer_tables_and_dominant_frequency():
    """ψ/ψ̂ tables + segment-wise dominant frequency (Meyer example)."""
    print("\n7. Meyer: ψ(t), ψ̂(ω) tables and dominant-frequency analysis")
    print("------------------------------------------------------------")
    w = jw.MeyerWavelet()
    ts = np.array([-10.0, -5.0, -2.0, -1.0, 0.0, 1.0, 2.0, 5.0, 10.0])
    pv = np.asarray(w.psi(jnp.asarray(ts)))
    print("  t      ψ(t)")
    for t, v in zip(ts, np.real(pv)):
        print(f"  {t:5.1f}  {v:+.6f}")
    om = np.array([0.5, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 8.0, 10.0])
    hv = np.asarray(w.psi_hat(jnp.asarray(om)))
    print("  ω      |ψ̂|       Re        Im   (support is [2π/3, 8π/3])")
    for o, v in zip(om, hv):
        print(f"  {o:5.1f}  {abs(v):8.6f}  {v.real:+.6f}  {v.imag:+.6f}")

    fs, n = 100.0, 512
    t = np.arange(n) / fs
    rng = np.random.default_rng(42)
    x = np.where(t < n / fs / 3, np.sin(2 * np.pi * 5 * t),
                 np.where(t < 2 * n / fs / 3, np.sin(2 * np.pi * 15 * t),
                          np.sin(2 * np.pi * 25 * t)))
    x = jnp.asarray(x + 0.1 * rng.standard_normal(n))
    # Scale→frequency for Meyer: its ψ̂ peaks at ω_pk ≈ 4.16 rad/s (found
    # numerically from the API), NOT at 2π·center_frequency — the reference
    # hard-codes fc = 0.7/2π (MeyerWavelet.java), a constant ~6× below the
    # spectral peak; using ψ̂'s true peak makes the scale→frequency map honest.
    om = np.linspace(2.0, 9.0, 2001)
    w_pk = om[int(np.abs(np.asarray(w.psi_hat(jnp.asarray(om)))).argmax())]
    scales = np.asarray(jw.generate_log_scales(
        w_pk / (2 * np.pi * 30.0), w_pk / (2 * np.pi * 2.0), 30))
    freqs = w_pk / (2 * np.pi * scales)  # 2..30 Hz analysis band
    res = jw.cwt(x, scales, w, sampling_rate=fs)
    mag = np.asarray(res.magnitude)
    print("  segment dominant frequencies (true 5 / 15 / 25 Hz):")
    for k, (lo, hi) in enumerate([(0, n // 3), (n // 3, 2 * n // 3),
                                  (2 * n // 3, n)]):
        # |W(a)|/√a removes the L2 normalization's √a tilt, so a pure tone
        # peaks exactly where ψ̂(aω₀) does
        prof = (mag[:, lo + 16: hi - 16].mean(axis=1) / np.sqrt(scales))
        print(f"    segment {k + 1}: {freqs[int(prof.argmax())]:5.1f} Hz")


if __name__ == "__main__":
    properties_table()
    paul_chirp_tracking()
    paul_phase_jump()
    dog_edge_detection()
    dog_singularity_orders()
    dog2_vs_mexican_hat()
    meyer_tables_and_dominant_frequency()
