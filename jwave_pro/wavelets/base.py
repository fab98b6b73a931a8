"""Discrete wavelet filter-bank objects.

Design: a wavelet is *data* — four float64 filter banks held as numpy
arrays on the host.  Transforms close over them, so under ``jax.jit`` the taps
become compile-time constants (the analog of the reference's per-instance filter
caching, ``jwave/transforms/MODWTTransform.java:452-593``, for free).

Parity notes (reference = /root/reference, Prophetizo/JWave-Pro):
  * QMF construction from the low-pass decomposition filter mirrors
    ``jwave/transforms/wavelets/Wavelet.java:104-122``.
  * Biorthogonal reconstruction-bank construction mirrors
    ``jwave/transforms/wavelets/biorthogonal/BiOrthogonal.java:28-66``.
  * ``energy_correction`` reproduces the unnormalized-Haar reverse factor
    (``jwave/transforms/wavelets/haar/Haar1Orthogonal.java:165-205``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DiscreteWavelet", "qmf_orthonormal", "qmf_biorthogonal"]


@dataclasses.dataclass(frozen=True)
class DiscreteWavelet:
    """A discrete wavelet: four filter banks + metadata (all host-side float64)."""

    name: str
    dec_lo: np.ndarray  # scaling (low-pass) decomposition filter
    dec_hi: np.ndarray  # wavelet (high-pass) decomposition filter
    rec_lo: np.ndarray  # scaling reconstruction filter
    rec_hi: np.ndarray  # wavelet reconstruction filter
    transform_wavelength: int = 2  # minimal input length for one step
    energy_correction: float = 1.0  # multiplies the synthesis step output
    family: str = ""

    def __post_init__(self):
        for f in ("dec_lo", "dec_hi", "rec_lo", "rec_hi"):
            object.__setattr__(
                self, f, np.ascontiguousarray(getattr(self, f), dtype=np.float64)
            )

    @property
    def length(self) -> int:
        """Number of taps (the reference's ``_motherWavelength``)."""
        return int(self.dec_lo.shape[0])

    def __repr__(self):  # pragma: no cover
        return f"DiscreteWavelet({self.name!r}, taps={self.length})"

    # pytree-free: wavelets are static metadata, passed as Python constants.
    def __hash__(self):
        return hash((self.name, self.length, self.dec_lo.tobytes()))

    def __eq__(self, other):
        return (
            isinstance(other, DiscreteWavelet)
            and self.name == other.name
            and np.array_equal(self.dec_lo, other.dec_lo)
            and np.array_equal(self.dec_hi, other.dec_hi)
            and np.array_equal(self.rec_lo, other.rec_lo)
            and np.array_equal(self.rec_hi, other.rec_hi)
        )


def qmf_orthonormal(name, dec_lo, *, transform_wavelength=2, family="",
                    dec_hi=None, energy_correction=1.0) -> DiscreteWavelet:
    """Build an orthonormal wavelet from its low-pass decomposition taps.

    High-pass via the quadrature-mirror relation ``hi[i] = ±lo[M-1-i]``
    (sign + on even i), reconstruction banks equal to decomposition banks —
    exactly the reference's ``Wavelet._buildOrthonormalSpace``
    (``Wavelet.java:104-122``).  ``dec_hi`` may be given explicitly for the
    classes that define it directly (both Haar variants).
    """
    lo = np.asarray(dec_lo, dtype=np.float64)
    m = lo.shape[0]
    if dec_hi is None:
        hi = lo[::-1].copy()
        hi[1::2] *= -1.0
    else:
        hi = np.asarray(dec_hi, dtype=np.float64)
    return DiscreteWavelet(
        name=name, dec_lo=lo, dec_hi=hi, rec_lo=lo.copy(), rec_hi=hi.copy(),
        transform_wavelength=transform_wavelength,
        energy_correction=energy_correction, family=family,
    )


def qmf_biorthogonal(name, dec_lo, dec_hi, *, transform_wavelength=2,
                     family="biorthogonal") -> DiscreteWavelet:
    """Build a biorthogonal wavelet from both decomposition banks.

    Reconstruction banks via the reference's alternating-sign swap
    (``BiOrthogonal.java:44-66``): on even i ``rec_lo[i] = -dec_hi[i]``,
    ``rec_hi[i] = -dec_lo[i]``; on odd i the unnegated swap.
    """
    lo = np.asarray(dec_lo, dtype=np.float64)
    hi = np.asarray(dec_hi, dtype=np.float64)
    rec_lo = hi.copy()
    rec_hi = lo.copy()
    rec_lo[0::2] *= -1.0
    rec_hi[0::2] *= -1.0
    return DiscreteWavelet(
        name=name, dec_lo=lo, dec_hi=hi, rec_lo=rec_lo, rec_hi=rec_hi,
        transform_wavelength=transform_wavelength, family=family,
    )
