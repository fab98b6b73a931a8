"""Facade layer: transform objects + string builders.

Mirrors the reference's L4 (``jwave/Transform.java``, ``jwave/
TransformBuilder.java``) on top of the functional ops.  Unlike the reference
facade — which catches exceptions and returns null (``Transform.java:83-89``)
— errors raise: silent nulls don't survive contact with jit.

Objects are thin, stateless, hashable wrappers: they close over the wavelet
(a host-side constant) and dispatch 1D/2D/3D on ``ndim`` like
``BasicTransform`` does on overloads.  All methods jit/vmap/shard.
"""
from __future__ import annotations

import dataclasses
import typing

import jax.numpy as jnp

from .ops import arbitrary
from .ops.cwt import cwt as _cwt_fft, cwt_direct as _cwt_direct
from .ops.fft import (
    dft as _dft, fft as _fft_c, fft_interleaved as _fft_i, idft as _idft,
    ifft as _ifft_c, ifft_interleaved as _ifft_i,
)
from .ops.fwt import (
    decompose as _decompose, fwt as _fwt_f, fwt2 as _fwt2, fwt3 as _fwt3,
    ifwt as _ifwt_f, ifwt2 as _ifwt2, ifwt3 as _ifwt3,
    recompose as _recompose,
)
from .ops.modwt import (
    imodwt as _imodwt, modwt as _modwt_f, modwt_mra as _modwt_mra,
)
from .ops.wpt import best_basis as _best_basis, iwpt as _iwpt, wpt as _wpt_f
from .wavelets.base import DiscreteWavelet
from .wavelets.continuous import ContinuousWavelet
from .wavelets.families import wavelet as _wavelet

__all__ = [
    "Transform", "FastWaveletTransform", "WaveletPacketTransform",
    "MODWTTransform", "ContinuousWaveletTransform", "FastFourierTransform",
    "DiscreteFourierTransform", "AncientEgyptianDecomposition",
    "ShiftingWaveletTransform", "build_transform",
]


class BaseTransform:
    """1D/2D/3D dispatch surface (``BasicTransform.java:42-699`` analog)."""

    def forward(self, x, *args, **kwargs):
        x = jnp.asarray(x)
        if x.ndim == 1:
            return self.forward_1d(x, *args, **kwargs)
        if x.ndim == 2:
            return self.forward_2d(x, *args, **kwargs)
        if x.ndim == 3:
            return self.forward_3d(x, *args, **kwargs)
        raise ValueError("use the batched functional API for ndim > 3")

    def reverse(self, y, *args, **kwargs):
        y = jnp.asarray(y)
        if y.ndim == 1:
            return self.reverse_1d(y, *args, **kwargs)
        if y.ndim == 2:
            return self.reverse_2d(y, *args, **kwargs)
        if y.ndim == 3:
            return self.reverse_3d(y, *args, **kwargs)
        raise ValueError("use the batched functional API for ndim > 3")

    def forward_2d(self, m, *a, **k):
        raise NotImplementedError(f"{type(self).__name__} is 1D-only")

    def reverse_2d(self, m, *a, **k):
        raise NotImplementedError(f"{type(self).__name__} is 1D-only")

    forward_3d = forward_2d
    reverse_3d = reverse_2d


@dataclasses.dataclass(frozen=True)
class FastWaveletTransform(BaseTransform):
    """FWT engine (``FastWaveletTransform.java``)."""

    wavelet: DiscreteWavelet

    def forward_1d(self, x, level=None):
        return _fwt_f(x, self.wavelet, level)

    def reverse_1d(self, y, level=None):
        return _ifwt_f(y, self.wavelet, level)

    def forward_2d(self, m, level_rows=None, level_cols=None):
        return _fwt2(m, self.wavelet, level_rows, level_cols)

    def reverse_2d(self, m, level_rows=None, level_cols=None):
        return _ifwt2(m, self.wavelet, level_rows, level_cols)

    def forward_3d(self, s, levels=(None, None, None)):
        return _fwt3(s, self.wavelet, levels)

    def reverse_3d(self, s, levels=(None, None, None)):
        return _ifwt3(s, self.wavelet, levels)

    def decompose(self, x):
        return _decompose(x, self.wavelet)

    def recompose(self, mat, level):
        return _recompose(mat, self.wavelet, level)


@dataclasses.dataclass(frozen=True)
class WaveletPacketTransform(BaseTransform):
    """WPT engine (``WaveletPacketTransform.java``); subsumes the reference's
    Pooled/Parallel variants (buffering and threading are XLA's job)."""

    wavelet: DiscreteWavelet

    def forward_1d(self, x, level=None):
        return _wpt_f(x, self.wavelet, level)

    def reverse_1d(self, y, level=None):
        return _iwpt(y, self.wavelet, level)

    def forward_2d(self, m, level_rows=None, level_cols=None):
        from .ops.wpt import wpt2

        return wpt2(m, self.wavelet, level_rows, level_cols)

    def reverse_2d(self, m, level_rows=None, level_cols=None):
        from .ops.wpt import iwpt2

        return iwpt2(m, self.wavelet, level_rows, level_cols)

    def forward_3d(self, s, levels=(None, None, None)):
        from .ops.wpt import wpt3

        return wpt3(s, self.wavelet, levels)

    def reverse_3d(self, s, levels=(None, None, None)):
        from .ops.wpt import iwpt3

        return iwpt3(s, self.wavelet, levels)

    def best_basis(self, x, level=None, cost="shannon"):
        return _best_basis(x, self.wavelet, level, cost)

    def decompose(self, x):
        """All-level WPT matrix (generic ``WaveletTransform.decompose``,
        ``WaveletTransform.java:136-146``, applied to the packet engine)."""
        from .ops.wpt import wpt_tree

        return wpt_tree(x, self.wavelet)

    def recompose(self, mat, level):
        return _iwpt(mat[level], self.wavelet, level)


@dataclasses.dataclass(frozen=True)
class MODWTTransform(BaseTransform):
    """MODWT engine (``MODWTTransform.java``); also covers the Pooled and
    Efficient variants (zero-copy pooling is XLA buffer management)."""

    wavelet: DiscreteWavelet
    method: str = "auto"

    def forward(self, x, level=None):
        """Batched over leading axes; last axis is the signal."""
        return self.forward_1d(x, level)

    def reverse(self, c):
        """1D input = flattened coefficients (auto shape detection); ≥2D
        input = the (level+1, ..., N) coefficient matrix."""
        c = jnp.asarray(c)
        if c.ndim == 1:
            return self.reverse_flat(c)
        return self.reverse_1d(c)

    def forward_1d(self, x, level=None):
        if level is None:
            # auto level = log2(N) (MODWTTransform.java:858-861; like the
            # reference this raises when it exceeds the level-13 cap)
            from .utils.validation import exponent

            level = exponent(jnp.asarray(x).shape[-1])
        return _modwt_f(x, self.wavelet, level, self.method)

    def reverse_1d(self, c):
        return _imodwt(c, self.wavelet, self.method)

    # flat-interface parity (MODWTTransform.java:854-912): (level+1)·N array
    def forward_flat(self, x, level=None):
        c = self.forward_1d(x, level)
        return c.reshape((-1,))

    def reverse_flat(self, flat, n=None):
        flat = jnp.asarray(flat)
        if n is None:
            # auto shape detection: smallest pow-2 N with total = N·(lvl+1)
            # and lvl ≤ log2(N) (MODWTTransform.java:884-901)
            from .utils.validation import exponent, is_power_of_two

            total = flat.shape[-1]
            for test_n in range(1, total + 1):
                if total % test_n == 0 and is_power_of_two(test_n):
                    lvl = total // test_n - 1
                    if 0 <= lvl <= exponent(test_n):
                        n = test_n
                        break
            if n is None:
                raise ValueError("cannot determine signal dimensions from "
                                 "flattened coefficient length "
                                 f"{total} [parity: MODWTTransform.java:899]")
        c = flat.reshape((-1, n))
        return _imodwt(c, self.wavelet, self.method)

    def mra(self, x, level):
        return _modwt_mra(x, self.wavelet, level, self.method)


@dataclasses.dataclass(frozen=True)
class ContinuousWaveletTransform:
    """CWT engine (``ContinuousWaveletTransform.java``); the parallel
    variants are the same call — the scale axis is batched/shardable."""

    wavelet: ContinuousWavelet
    padding: str = "zero"

    def transform(self, x, scales, sampling_rate=1.0):
        return _cwt_direct(x, scales, self.wavelet, sampling_rate)

    def transform_fft(self, x, scales, sampling_rate=1.0):
        return _cwt_fft(x, scales, self.wavelet, sampling_rate, self.padding)

    def inverse(self, result):
        """Approximate signal reconstruction (``ops.cwt.icwt``; the
        reference has no inverse CWT)."""
        from .ops.cwt import icwt as _icwt

        return _icwt(result, self.wavelet)

    # parallel aliases for API familiarity
    transform_parallel = transform
    transform_fft_parallel = transform_fft


class FastFourierTransform(BaseTransform):
    """FFT engine on interleaved arrays (``FastFourierTransform.java``)."""

    def forward_1d(self, x):
        return _fft_i(x)

    def reverse_1d(self, y):
        return _ifft_i(y)

    def forward_complex(self, z):
        return _fft_c(z)

    def reverse_complex(self, z):
        return _ifft_c(z)


class DiscreteFourierTransform(FastFourierTransform):
    """O(N²) DFT baseline (``DiscreteFourierTransform.java``); the
    ForkJoinPool-parallel variant is the same matmul."""

    def forward_complex(self, z):
        return _dft(z)

    def reverse_complex(self, z):
        return _idft(z)


@dataclasses.dataclass(frozen=True)
class AncientEgyptianDecomposition(BaseTransform):
    """Arbitrary-length wrapper (``AncientEgyptianDecomposition.java``)."""

    inner: BaseTransform

    def forward_1d(self, x, level=None):
        return arbitrary.aed_forward(
            x, self.inner.wavelet,
            transform=lambda b, w, lv: self.inner.forward_1d(b, lv),
            level=level)

    def reverse_1d(self, y, level=None):
        return arbitrary.aed_inverse(
            y, self.inner.wavelet,
            transform=lambda b, w, lv: self.inner.reverse_1d(b, lv),
            level=level)


@dataclasses.dataclass(frozen=True)
class ShiftingWaveletTransform(BaseTransform):
    """SWT engine (``ShiftingWaveletTransform.java``)."""

    wavelet: DiscreteWavelet

    def forward_1d(self, x):
        return arbitrary.swt_forward(x, self.wavelet)

    def reverse_1d(self, y):
        return arbitrary.swt_inverse(y, self.wavelet)


@dataclasses.dataclass(frozen=True)
class Transform:
    """Top-level facade (``jwave/Transform.java``)."""

    engine: typing.Any

    def forward(self, x, *args, **kwargs):
        return self.engine.forward(x, *args, **kwargs)

    def reverse(self, y, *args, **kwargs):
        return self.engine.reverse(y, *args, **kwargs)

    def forward_complex(self, z, *args, **kwargs):
        """Complex 1D input via the interleaved-real trick: the reference
        flattens (re, im) pairs into one real array of length 2N and runs the
        real transform on it (``BasicTransform.java:257-283``)."""
        z = jnp.asarray(z)
        inter = jnp.stack([jnp.real(z), jnp.imag(z)], axis=-1)
        inter = inter.reshape(z.shape[:-1] + (2 * z.shape[-1],))
        out = self.engine.forward(inter, *args, **kwargs)
        out = out.reshape(z.shape[:-1] + (z.shape[-1], 2))
        return out[..., 0] + 1j * out[..., 1]

    def reverse_complex(self, z, *args, **kwargs):
        """Inverse of :meth:`forward_complex` (``BasicTransform.java:
        297-322``)."""
        z = jnp.asarray(z)
        inter = jnp.stack([jnp.real(z), jnp.imag(z)], axis=-1)
        inter = inter.reshape(z.shape[:-1] + (2 * z.shape[-1],))
        out = self.engine.reverse(inter, *args, **kwargs)
        out = out.reshape(z.shape[:-1] + (z.shape[-1], 2))
        return out[..., 0] + 1j * out[..., 1]

    def decompose(self, x):
        return self.engine.decompose(x)

    def recompose(self, mat, level):
        return self.engine.recompose(mat, level)


_TRANSFORMS = {
    "discrete fourier transform": lambda w: DiscreteFourierTransform(),
    "fast fourier transform": lambda w: FastFourierTransform(),
    "fast wavelet transform": lambda w: FastWaveletTransform(_wavelet(w)),
    "wavelet packet transform": lambda w: WaveletPacketTransform(_wavelet(w)),
    "maximal overlap discrete wavelet transform":
        lambda w: MODWTTransform(_wavelet(w)),
    "shifting wavelet transform":
        lambda w: ShiftingWaveletTransform(_wavelet(w)),
}


def build_transform(name: str, wavelet_name: str = "Haar") -> Transform:
    """String factory (``TransformBuilder.create``, ``TransformBuilder.java:
    41-93``) extended with the engines the reference builder omits."""
    key = name.strip().lower()
    if key not in _TRANSFORMS:
        from .exceptions import NotKnown

        raise NotKnown(
            f"unknown transform {name!r}; known: {sorted(_TRANSFORMS)}")
    return Transform(_TRANSFORMS[key](wavelet_name))
