#!/usr/bin/env python3
"""Regenerate docs/API.md from module ``__all__``s + docstring summaries.

Run on CPU:  python tools/gen_api.py
"""
from __future__ import annotations

import importlib
import inspect
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SECTIONS = [
    ("jwave_pro", "Top-level functional API"),
    ("jwave_pro.wavelets", "Wavelet registry"),
    ("jwave_pro.wavelets.continuous", "Continuous wavelets"),
    ("jwave_pro.ops.fwt", "Fast Wavelet Transform"),
    ("jwave_pro.ops.wpt", "Wavelet Packet Transform + best basis"),
    ("jwave_pro.ops.modwt", "MODWT"),
    ("jwave_pro.ops.modwt2d", "2D MODWT"),
    ("jwave_pro.ops.modwpt", "MODWPT (shift-invariant packets)"),
    ("jwave_pro.ops.analysis", "Wavelet variance/covariance"),
    ("jwave_pro.ops.cwt", "Continuous Wavelet Transform (+ inverse)"),
    ("jwave_pro.ops.cwt2d", "2D Continuous Wavelet Transform"),
    ("jwave_pro.ops.ssq", "Synchrosqueezed CWT"),
    ("jwave_pro.ops.ridge", "Ridge extraction"),
    ("jwave_pro.ops.dtcwt", "Dual-tree complex WT"),
    ("jwave_pro.ops.ewt", "Empirical wavelet transform"),
    ("jwave_pro.ops.mp", "Matching pursuit"),
    ("jwave_pro.ops.scattering", "Wavelet scattering (1D)"),
    ("jwave_pro.ops.scattering2d", "Wavelet scattering (2D)"),
    ("jwave_pro.ops.fft", "Fourier transforms"),
    ("jwave_pro.ops.lifting", "Lifting schemes (CDF 5/3, 9/7)"),
    ("jwave_pro.ops.arbitrary", "Arbitrary-length wrappers"),
    ("jwave_pro.ops.compress", "Threshold compression"),
    ("jwave_pro.ops.denoise", "Denoising"),
    ("jwave_pro.ops.pywt_compat", "PyWavelets-style API"),
    ("jwave_pro.transforms", "Object facade + builders"),
    ("jwave_pro.parallel", "Meshes + sharded transforms"),
    ("jwave_pro.streaming", "Streaming + chunked processing"),
    ("jwave_pro.kernels.modwt_cuda", "Fused MODWT kernels (CUDA)"),
    ("jwave_pro.datatypes", "Data stores"),
    ("jwave_pro.exceptions", "Exception hierarchy"),
    ("jwave_pro.utils.validation", "Shape/level helpers"),
    ("jwave_pro.utils.signals", "Test-signal generators"),
    ("jwave_pro.utils.profiling", "Profiling helpers"),
]


def _kind(obj) -> str:
    if inspect.isclass(obj):
        return "class"
    if callable(obj):
        return "fn"
    return "const"


def _summary(obj) -> str:
    doc = inspect.getdoc(obj) or ""
    return doc.split("\n", 1)[0].strip()


def main() -> None:
    lines = [
        "# API reference (public surface)",
        "",
        "Generated from module `__all__`s and docstring summaries "
        "(`tools/gen_api.py`).",
    ]
    for modname, title in SECTIONS:
        mod = importlib.import_module(modname)
        names = getattr(mod, "__all__", None)
        if names is None:
            names = [n for n in dir(mod) if not n.startswith("_")]
        lines += ["", f"## `{modname}` — {title}", ""]
        for name in sorted(names):
            obj = getattr(mod, name)
            summ = _summary(obj)
            lines.append(f"- **`{name}`** ({_kind(obj)}) — {summ}")
    out = ROOT / "docs" / "API.md"
    out.write_text("\n".join(lines) + "\n")
    print(f"wrote {out} ({len(lines)} lines)")


if __name__ == "__main__":
    main()
