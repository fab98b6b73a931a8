#!/usr/bin/env python3
"""Streaming/chunked processing demo — the subsystem the reference only
scaffolds (its factory throws for every transform type)."""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import _bootstrap  # noqa: E402,F401 — repo path, CPU mesh

import jwave_pro as jw  # noqa: E402
from jwave_pro import streaming as st  # noqa: E402
from jwave_pro.utils.signals import ecg_like  # noqa: E402


def main():
    fs = 360.0
    sig = ecg_like(4096, fs=fs)
    w = jw.wavelet("Daubechies 4")

    # 1) incremental streaming MODWT: one chunk in, newest columns out
    sm = st.streaming_transform(
        "modwt", w, st.StreamingConfig(buffer_size=1024, max_level=4))
    for i in range(0, 2048, 256):
        coeffs = sm.update(sig[i:i + 256])
    print(f"streaming MODWT buffer state: coeffs {coeffs.shape}, "
          f"detail-1 energy {float((coeffs[0]**2).sum()):.4f}")

    # 2) bounded-memory chunked MODWT over the full record
    chunks = (sig[i:i + 512] for i in range(0, 4096, 512))
    total = 0
    for block in st.modwt_chunked(chunks, w, level=4):
        total += np.asarray(block).shape[-1]
    print(f"chunked MODWT processed {total} samples in 512-sample blocks")

    # 3) checkpoint / resume
    st.save_state(sm, "/tmp/stream_state.npz")
    sm2 = st.streaming_transform(
        "modwt", w, st.StreamingConfig(buffer_size=1024, max_level=4))
    st.load_state(sm2, "/tmp/stream_state.npz")
    a = np.asarray(sm.update(sig[2048:2304]))
    b = np.asarray(sm2.update(sig[2048:2304]))
    print(f"resume parity: {np.abs(a - b).max():.1e}")


if __name__ == "__main__":
    main()
