#!/usr/bin/env python3
"""Multi-device example: signal-sharded MODWT + scale-sharded CWT.

Run on CPU with a virtual mesh:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/sharded_example.py
or on a host with several GPUs (uses all visible devices).
"""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import _bootstrap  # noqa: E402,F401 — repo path, CPU mesh

import jax  # noqa: E402

import jwave_pro as jw  # noqa: E402
from jwave_pro.parallel import make_mesh  # noqa: E402
from jwave_pro.parallel.sharded import (  # noqa: E402
    cwt_sharded, imodwt_sharded, modwt_sharded,
)


def main():
    n_dev = len(jax.devices())
    print(f"devices: {n_dev} × {jax.devices()[0].platform}")
    mesh = make_mesh({"signal": n_dev})

    w = jw.wavelet("Daubechies 4")
    x = np.random.default_rng(0).standard_normal(1 << 16)

    c = modwt_sharded(x, w, 5, mesh)
    rec = np.asarray(imodwt_sharded(c, w, mesh))
    print(f"sharded MODWT roundtrip err: {np.abs(rec - x).max():.2e}")

    scales = jw.generate_log_scales(1.0, 256.0, 8 * n_dev)
    res = cwt_sharded(x[:4096], scales, jw.MorletWavelet(), mesh,
                      scale_axis="signal")
    print(f"sharded CWT coefficients: {res.coefficients.shape} "
          f"sharding={res.coefficients.sharding}")


if __name__ == "__main__":
    main()
