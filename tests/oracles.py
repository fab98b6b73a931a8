"""Brute-force numpy oracles — independent re-statements of the transform math.

These deliberately use the slow, obviously-correct O(N·M) index formulas from
the reference's scalar loops (cited per function) so the fast paths can be
validated against them without any JVM.
"""
from __future__ import annotations

import numpy as np


def fwt_step(x, dec_lo, dec_hi):
    """One analysis step: Wavelet.java:236-260."""
    h = len(x)
    m = len(dec_lo)
    out = np.zeros(h)
    for i in range(h // 2):
        for j in range(m):
            k = (2 * i + j) % h
            out[i] += x[k] * dec_lo[j]
            out[i + h // 2] += x[k] * dec_hi[j]
    return out


def ifwt_step(y, rec_lo, rec_hi, energy_correction=1.0):
    """One synthesis step: Wavelet.java:277-303 (+Haar1Orthogonal.java:196)."""
    h = len(y)
    m = len(rec_lo)
    out = np.zeros(h)
    for i in range(h // 2):
        for j in range(m):
            k = (2 * i + j) % h
            out[k] += energy_correction * (
                y[i] * rec_lo[j] + y[i + h // 2] * rec_hi[j]
            )
    return out


def fwt(x, w, level=None):
    """FastWaveletTransform.java:71-101."""
    x = np.asarray(x, dtype=np.float64).copy()
    n = len(x)
    if level is None:
        level = n.bit_length() - 1
    h = n
    lvl = 0
    while h >= max(w.transform_wavelength, 2) and lvl < level:
        x[:h] = fwt_step(x[:h], w.dec_lo, w.dec_hi)
        h //= 2
        lvl += 1
    return x


def ifwt(y, w, level=None):
    """FastWaveletTransform.java:119-153."""
    y = np.asarray(y, dtype=np.float64).copy()
    n = len(y)
    if level is None:
        level = n.bit_length() - 1
    widths = []
    h = n
    lvl = 0
    while h >= max(w.transform_wavelength, 2) and lvl < level:
        widths.append(h)
        h //= 2
        lvl += 1
    for h in reversed(widths):
        y[:h] = ifwt_step(y[:h], w.rec_lo, w.rec_hi, w.energy_correction)
    return y


def wpt(x, w, level=None):
    """WaveletPacketTransform.java:73-124."""
    x = np.asarray(x, dtype=np.float64).copy()
    n = len(x)
    if level is None:
        level = n.bit_length() - 1
    h = n
    lvl = 0
    while h >= max(w.transform_wavelength, 2) and lvl < level:
        for p in range(n // h):
            x[p * h:(p + 1) * h] = fwt_step(x[p * h:(p + 1) * h],
                                            w.dec_lo, w.dec_hi)
        h //= 2
        lvl += 1
    return x


def iwpt(y, w, level=None):
    """WaveletPacketTransform.java:141-189."""
    y = np.asarray(y, dtype=np.float64).copy()
    n = len(y)
    if level is None:
        level = n.bit_length() - 1
    widths = []
    h = n
    lvl = 0
    while h >= max(w.transform_wavelength, 2) and lvl < level:
        widths.append(h)
        h //= 2
        lvl += 1
    for h in reversed(widths):
        for p in range(n // h):
            y[p * h:(p + 1) * h] = ifwt_step(y[p * h:(p + 1) * h],
                                             w.rec_lo, w.rec_hi,
                                             w.energy_correction)
    return y


def modwt_filters(w):
    """MODWTTransform.initializeFilterCache (:452-484)."""
    def norm(f):
        f = np.asarray(f, dtype=np.float64)
        e = np.sqrt(np.sum(f * f))
        if e > 1e-12:
            f = f / e
        return f / np.sqrt(2.0)
    return norm(w.dec_lo), norm(w.dec_hi)


def upsample(f, level):
    """MODWTTransform.upsample (:618-630)."""
    if level <= 1:
        return np.asarray(f, dtype=np.float64)
    gap = (1 << (level - 1)) - 1
    out = np.zeros(len(f) + (len(f) - 1) * gap)
    out[::gap + 1] = f
    return out


def circular_convolve(x, f):
    """MODWTTransform.circularConvolve (:677-690)."""
    n, m = len(x), len(f)
    out = np.zeros(n)
    for i in range(n):
        for j in range(m):
            out[i] += x[(i - j) % n] * f[j]
    return out


def circular_convolve_adjoint(x, f):
    """MODWTTransform.circularConvolveAdjoint (:703-716)."""
    n, m = len(x), len(f)
    out = np.zeros(n)
    for i in range(n):
        for j in range(m):
            out[i] += x[(i + j) % n] * f[j]
    return out


def modwt(x, w, level):
    """MODWTTransform.forwardMODWT (:256-306)."""
    g, h = modwt_filters(w)
    v = np.asarray(x, dtype=np.float64).copy()
    rows = []
    for j in range(1, level + 1):
        gj, hj = upsample(g, j), upsample(h, j)
        rows.append(circular_convolve(v, hj))
        v = circular_convolve(v, gj)
    rows.append(v)
    return np.stack(rows)


def imodwt(coeffs, w):
    """MODWTTransform.inverseMODWT (:337-375)."""
    g, h = modwt_filters(w)
    level = coeffs.shape[0] - 1
    v = coeffs[level].copy()
    for j in range(level, 0, -1):
        gj, hj = upsample(g, j), upsample(h, j)
        v = (circular_convolve_adjoint(v, gj)
             + circular_convolve_adjoint(coeffs[j - 1], hj))
    return v


def modwpt(x, w, level):
    """Maximal-overlap wavelet packet tree, sequency-ordered (Percival &
    Walden 2000 §6.1: node n from parent ⌊n/2⌋ via g̃ when n mod 4 ∈ {0,3},
    h̃ when n mod 4 ∈ {1,2}; level-j filters upsampled with 2^(j-1)-1
    zeros).  Brute-force per-node circular convolutions."""
    g, h = modwt_filters(w)
    nodes = [np.asarray(x, dtype=np.float64).copy()]
    for j in range(1, level + 1):
        gj, hj = upsample(g, j), upsample(h, j)
        new = []
        for n in range(1 << j):
            f = gj if n % 4 in (0, 3) else hj
            new.append(circular_convolve(nodes[n // 2], f))
        nodes = new
    return np.stack(nodes)


def imodwpt(coeffs, w):
    """Adjoint packet cascade: parent = Σ adjoint-conv of its two children
    (filter assignment by the same sequency rule)."""
    g, h = modwt_filters(w)
    level = int(np.log2(coeffs.shape[0]))
    nodes = [coeffs[n].copy() for n in range(coeffs.shape[0])]
    for j in range(level, 0, -1):
        gj, hj = upsample(g, j), upsample(h, j)
        new = []
        for p in range(len(nodes) // 2):
            acc = np.zeros_like(nodes[0])
            for n in (2 * p, 2 * p + 1):
                f = gj if n % 4 in (0, 3) else hj
                acc += circular_convolve_adjoint(nodes[n], f)
            new.append(acc)
        nodes = new
    return nodes[0]


# ---------------------------------------------------------------------------
# CWT (FFT path) oracle — numpy re-statement of the reference's transformFFT
# (ContinuousWaveletTransform.java:183-229): pad to next pow-2, one FFT,
# per-scale multiply by conj(√a·ψ̂(aω)), IFFT, truncate.  ψ̂ formulas are
# independent numpy restatements of wavelets/continuous/*.java.
# ---------------------------------------------------------------------------

def _np_psi_hat_morlet(omega, fb=1.0, fc=1.0):
    f = omega / (2.0 * np.pi)
    return (np.sqrt(2.0 * np.pi * fb)
            * np.exp(-2.0 * np.pi ** 2 * fb * (f - fc) ** 2)) + 0j


def _np_psi_hat_mexhat(omega, sigma=1.0):
    norm = 2.0 / (np.sqrt(3.0 * sigma) * np.pi ** 0.25)
    return (norm * sigma * np.sqrt(2.0 * np.pi) * omega ** 2
            * np.exp(-0.5 * sigma ** 2 * omega ** 2)) + 0j


def _np_psi_hat_paul(omega, m=4):
    pos = omega > 0
    safe = np.where(pos, omega, 1.0)
    return np.where(pos, np.sqrt(2.0 * np.pi) * safe ** m * np.exp(-safe),
                    0.0) + 0j


def _np_psi_hat_dog(omega, n=2, sigma=1.0):
    df = 1.0
    k = 2 * n - 1
    while k > 1:
        df *= k
        k -= 2
    norm = np.sqrt(df / (2.0 ** n * np.sqrt(np.pi) * sigma ** (2 * n + 1)))
    mag = (norm * np.sqrt(2.0 * np.pi) * sigma ** (n + 1)
           * np.abs(omega) ** n * np.exp(-0.5 * sigma ** 2 * omega ** 2))
    return mag * (1j ** (n % 4)) * np.where(n % 2, np.sign(omega), 1.0)


def _np_psi_hat_meyer(omega):
    def nu(x):
        x = np.clip(x, 0.0, 1.0)
        return x ** 4 * (35.0 + x * (-84.0 + x * (70.0 - 20.0 * x)))

    aw = np.abs(omega)
    lo, mid, hi = 2 * np.pi / 3, 4 * np.pi / 3, 8 * np.pi / 3
    sin_b = np.sin(np.pi / 2 * nu(3 * aw / (2 * np.pi) - 1))
    cos_b = np.cos(np.pi / 2 * nu(3 * aw / (4 * np.pi) - 1))
    val = np.where((aw >= lo) & (aw <= mid), sin_b,
                   np.where((aw > mid) & (aw <= hi), cos_b, 0.0))
    return val * np.sqrt(2 * np.pi) * np.exp(1j * omega / 2.0)


NP_PSI_HATS = {
    "morlet": _np_psi_hat_morlet,
    "mexican_hat": _np_psi_hat_mexhat,
    "paul": _np_psi_hat_paul,
    "dog3": lambda w: _np_psi_hat_dog(w, n=3),
    "meyer": _np_psi_hat_meyer,
}


def cwt_fft(x, scales, psi_hat, fs=1.0):
    """Zero-padded FFT CWT, complex (n_scales, N) output."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[-1]
    p = 1
    while p < n:
        p *= 2
    xp = np.concatenate([x, np.zeros(p - n)])
    xf = np.fft.fft(xp)
    omega = 2.0 * np.pi * np.arange(p) * fs / p
    omega[np.arange(p) > p // 2] -= 2.0 * np.pi * fs
    rows = []
    for a in np.asarray(scales, dtype=np.float64):
        wf = np.conj(np.sqrt(a) * psi_hat(a * omega))
        rows.append(np.fft.ifft(xf * wf)[:n])
    return np.stack(rows)


def modwpt2(x, w, level):
    """Brute-force 2D MODWPT: tensor product of two 1D sequency-ordered
    packet cascades (rows for n_r, columns for n_c)."""
    x = np.asarray(x, dtype=np.float64)
    r, c = x.shape
    p = 1 << level
    tmp = np.empty((p, r, c))
    for col in range(c):
        tmp[:, :, col] = modwpt(x[:, col], w, level)
    out = np.empty((p, p, r, c))
    for nr in range(p):
        for row in range(r):
            out[nr, :, row, :] = modwpt(tmp[nr, row, :], w, level)
    return out
