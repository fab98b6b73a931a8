"""Fourier transforms — thin wrappers over ``jnp.fft`` with reference parity.

The reference hand-rolls iterative Cooley-Tukey for 2^p and Bluestein chirp-z
for arbitrary N (``jwave/transforms/FastFourierTransform.java:172-324``) with
NumPy normalization (forward unscaled, inverse 1/N, ``:205-211``).  XLA's FFT
(``jnp.fft``) natively handles arbitrary N with the same normalization, so
both reference engines collapse into one call; the O(N²) educational DFTs
(``DiscreteFourierTransform.java``, ``ParallelDiscreteFourierTransform.java``)
are provided as an explicit matrix product for cross-validation.

The interleaved real-array API (re,im,re,im,...) of the reference's 1D
``forward(double[])`` is kept for drop-in familiarity.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = [
    "fft", "ifft", "fft_interleaved", "ifft_interleaved",
    "dft_matrix", "dft", "idft",
]


def _as_complex(x: jax.Array) -> jax.Array:
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        return x
    if x.dtype == jnp.float64:
        return x.astype(jnp.complex128)
    return x.astype(jnp.complex64)


def fft(x: jax.Array, axis: int = -1) -> jax.Array:
    """Forward FFT, unscaled (FastFourierTransform.java:112-134)."""
    return jnp.fft.fft(_as_complex(x), axis=axis)


def ifft(x: jax.Array, axis: int = -1) -> jax.Array:
    """Inverse FFT with 1/N (FastFourierTransform.java:142-164)."""
    return jnp.fft.ifft(_as_complex(x), axis=axis)


def _deinterleave(arr: jax.Array) -> jax.Array:
    re = arr[..., 0::2]
    im = arr[..., 1::2]
    return re + 1j * im


def _interleave(z: jax.Array):
    out = jnp.stack([jnp.real(z), jnp.imag(z)], axis=-1)
    return out.reshape(out.shape[:-2] + (out.shape[-2] * 2,))


def fft_interleaved(arr: jax.Array) -> jax.Array:
    """FFT of an interleaved (re,im,...) real array → interleaved result.

    Parity with ``BasicTransform.forward(double[])`` FFT path
    (``BasicTransform.java:257-322`` complex adapters).
    """
    return _interleave(fft(_deinterleave(jnp.asarray(arr))))


def ifft_interleaved(arr: jax.Array) -> jax.Array:
    return _interleave(ifft(_deinterleave(jnp.asarray(arr))))


def dft_matrix(n: int, inverse: bool = False, dtype=np.complex128):
    """The DFT matrix W[k,t] = e^{∓2πi·kt/n} (÷n when inverse) as a constant.

    The O(N²) baseline of ``DiscreteFourierTransform.java:73-117`` as one
    matmul — the "output-bin parallel" ForkJoinPool variant
    (``ParallelDiscreteFourierTransform.java:202-268``) is subsumed by
    the matmul.
    """
    k = np.arange(n)
    sign = 2.0j if inverse else -2.0j
    w = np.exp(sign * np.pi * np.outer(k, k) / n)
    if inverse:
        w = w / n
    return w.astype(dtype)


def dft(x: jax.Array) -> jax.Array:
    """Naive DFT via matrix product (educational / cross-validation)."""
    from jax import lax

    x = _as_complex(x)
    w = jnp.asarray(dft_matrix(x.shape[-1]), dtype=x.dtype)
    return jnp.tensordot(x, w, axes=[[-1], [1]],
                         precision=lax.Precision.HIGHEST)


def idft(x: jax.Array) -> jax.Array:
    from jax import lax

    x = _as_complex(x)
    w = jnp.asarray(dft_matrix(x.shape[-1], inverse=True), dtype=x.dtype)
    return jnp.tensordot(x, w, axes=[[-1], [1]],
                         precision=lax.Precision.HIGHEST)
