#!/usr/bin/env python3
"""Wavelet scattering features for signal classification.

The scattering transform (ops/scattering.py) is the wavelet-domain feature
extractor for ML: translation-invariant up to the averaging scale 2^J,
stable to deformations, and sensitive to amplitude/frequency modulation
that plain spectra lose.  This example builds scattering feature vectors
for three signal classes — a pure tone, an amplitude-modulated tone, and a
frequency-modulated chirp — and shows that

  * first-order coefficients (≈ a constant-Q mel-like spectrum) separate
    carriers but CONFUSE pure vs AM tones of the same carrier,
  * second-order coefficients expose the modulation structure and separate
    all three classes,
  * features are invariant to shifting the signal.

Everything is one batched jit: the (class, realization) axes are plain
batch dims and shard across chips like any other batch.
"""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import _bootstrap  # noqa: E402,F401 — repo path, CPU mesh

import jax.numpy as jnp  # noqa: E402

import jwave_pro as jw  # noqa: E402


def make_classes(n, n_real, rng):
    t = np.arange(n)
    carrier = 0.20
    sigs = []
    for _ in range(n_real):
        ph = rng.uniform(0, 2 * np.pi)
        tone = np.sin(2 * np.pi * carrier * t + ph)
        am = (1 + 0.8 * np.sin(2 * np.pi * 0.008 * t + ph)) * tone
        fm = np.sin(2 * np.pi * (carrier * t + 8 * np.sin(2 * np.pi * 0.004 * t + ph)))
        sigs.append([tone, am, fm])
    x = np.asarray(sigs)  # (n_real, 3, n)
    return x + 0.01 * rng.normal(size=x.shape)


def main():
    rng = np.random.default_rng(0)
    n, n_real = 4096, 8
    x = jnp.asarray(make_classes(n, n_real, rng), dtype=jnp.float32)

    r = jw.scattering1d(x, j=6, q=8)  # averaging scale T = 64
    # time-average the invariant coefficients into one feature vector
    f1 = jnp.mean(r.s1, axis=-1)  # (n_real, 3, L1)
    f2 = jnp.mean(r.s2, axis=-1)  # (n_real, 3, P)

    names = ["tone", "am  ", "fm  "]
    print(f"first-order paths: {r.s1.shape[-2]}, "
          f"second-order paths: {r.s2.shape[-2]}")

    def dist(f, a, b):
        d = jnp.linalg.norm(jnp.mean(f[:, a], 0) - jnp.mean(f[:, b], 0))
        return float(d / jnp.linalg.norm(jnp.mean(f[:, a], 0)))

    print("\nrelative class distances      S1-only   S1+S2")
    for a in range(3):
        for b in range(a + 1, 3):
            d1 = dist(f1, a, b)
            d12 = dist(jnp.concatenate([f1, f2], -1), a, b)
            print(f"  {names[a]} vs {names[b]}            {d1:7.3f}  {d12:7.3f}")

    # shift invariance: features barely move under a 5-sample shift
    r_s = jw.scattering1d(jnp.roll(x, 5, axis=-1), j=6, q=8)
    drift = float(jnp.linalg.norm(jnp.mean(r_s.s1, -1) - f1)
                  / jnp.linalg.norm(f1))
    print(f"\nfeature drift under 5-sample shift: {drift:.4f}")

    # the dominant first-order path sits at the carrier frequency
    k = int(jnp.argmax(jnp.mean(f1[:, 0], 0)))
    print(f"tone class: strongest ψ at ξ = {r.xi1[k]:.3f} cycles/sample "
          f"(carrier 0.200)")


if __name__ == "__main__":
    main()
