"""Fused MODWT kernels for NVIDIA GPUs: forward, inverse, denoise, variance.

The XLA roll form of the MODWT writes every level's (V, W) pair to device
memory and reads V back for the next level: about L reads and 2L writes of
the signal for L levels.  These kernels (``modwt_cuda.cu``, CUDA C++ called
through ``jax.ffi``) keep the whole level chain of one (row, tile) window in
shared memory, so the forward moves one read and L+1 writes, the inverse
L+1 reads and one write, the denoise one read and one write, and the
variance one read and a few partial sums per tile.

Block program.  Each CUDA block owns the window of one tile of one row plus
``halo = (M-1)(2^L-1)`` samples of circular context (rounded up to 32), on
the left for analysis, on the right for synthesis, on both sides for the
denoise.  Context comes from the block's own indexed loads (position mod N),
so any N works without padding and no state passes between blocks.

Routing.  Each entry point holds two programs, chosen by
``jax.lax.platform_dependent`` when the call is lowered: the custom call
where it is lowered for a CUDA GPU, the XLA cascade (``method="direct"`` in
f32) for any other platform, so arrays placed on the host CPU of a GPU
machine take XLA.  A CUDA kernel has no interpret mode; ``interpret=True``
runs the XLA cascade in its place, which lets the CPU tests pin the plan,
the reshaping, the threshold tables and the VJP rules.  The compiled
kernels' tiling, context and seams are checked on the card by
``chip_smoke.py`` against a float64 NumPy reference.

Build.  The library is compiled from ``modwt_cuda.cu`` with ``nvcc`` for
``sm_90a`` on first use, into ``_build/`` beside this file (listed in
``.gitignore``), keyed by a hash of the source.  :func:`available` is false
where JAX's default device is not a CUDA GPU or the build fails; the public
ops then take their XLA path.

Gradients.  The MODWT analysis operator A satisfies Aᵀ = A⁻¹ with the
reference's √2-normalised filters (the perfect-reconstruction identity,
MODWTTransform.java:337-375), so each of :func:`modwt_fused` and
:func:`imodwt_fused` has the other as its VJP.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import pathlib
import shutil
import subprocess
import tempfile
import warnings
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from ..ops.modwt import _check_level, imodwt, modwt, modwt_base_filters
from ..wavelets.base import DiscreteWavelet

__all__ = [
    "Plan", "plan", "available", "applies", "build_library",
    "modwt_fused", "imodwt_fused", "modwt_denoise_fused", "modwt_var_fused",
]

SOURCE = pathlib.Path(__file__).with_name("modwt_cuda.cu")
BUILD_DIR = pathlib.Path(__file__).with_name("_build")

DEFAULT_TILE = 2048     # output samples per block
SMEM_BUDGET = 100 * 1024  # bytes per block: keeps two blocks on each SM
MAX_TAPS = 64           # Taps struct in modwt_cuda.cu
_ALIGN = 32             # samples per 128-byte line of f32

_TARGETS = {
    "jwave_modwt_fwd": "JwaveModwtFwd",
    "jwave_modwt_inv": "JwaveModwtInv",
    "jwave_modwt_denoise": "JwaveModwtDenoise",
    "jwave_modwt_var": "JwaveModwtVar",
}
_MODES = {"soft": 0, "hard": 1}


class Plan(NamedTuple):
    """Launch plan: ``tile`` output samples per block, ``halo`` context
    samples, ``smem`` bytes of shared memory per block."""
    tile: int
    halo: int
    smem: int


def _smem_bytes(kind: str, tile: int, halo: int, level: int) -> int:
    """Shared memory of one block; the same formulas as the handlers in
    modwt_cuda.cu."""
    if kind in ("forward", "variance"):
        floats = 2 * (tile + halo)
    elif kind == "inverse":
        floats = 3 * (tile + halo)
    elif kind == "denoise":
        floats = 2 * (tile + 2 * halo) + level * (tile + halo)
    else:
        raise ValueError(f"unknown kernel kind {kind!r}")
    return 4 * floats


def plan(kind: str, rows: int, n: int, level: int, m: int,
         tile: int | None = None) -> Plan | None:
    """Plan one launch over ``rows`` signals of length ``n``, or None when
    the kernel does not fit: more than 64 taps, a context wider than the
    tile (more than half the block's work would be redundant), or a block
    above :data:`SMEM_BUDGET`.

    Without an explicit ``tile`` the default grows (in powers of two) while
    the context exceeds half a tile and the block still fits, and shrinks
    to the signal for short signals.
    """
    if m > MAX_TAPS or n < 1 or rows < 1:
        return None
    halo = -(-(m - 1) * ((1 << level) - 1) // _ALIGN) * _ALIGN
    if tile is None:
        t = DEFAULT_TILE
        while (t < 2 * halo
               and _smem_bytes(kind, 2 * t, halo, level) <= SMEM_BUDGET):
            t *= 2
        while t > _ALIGN and t // 2 >= n:
            t //= 2
    else:
        t = int(tile)
        if t % _ALIGN:
            return None
    smem = _smem_bytes(kind, t, halo, level)
    if halo > t or smem > SMEM_BUDGET:
        return None
    if rows * -(-n // t) >= 2 ** 31:
        return None
    return Plan(t, halo, smem)


# ---------------------------------------------------------------------------
# Build and registration
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (set CUDA_HOME or put it on PATH)")


def build_library() -> pathlib.Path:
    """Compile ``modwt_cuda.cu`` into ``_build/`` (once per source hash)
    and return the shared library's path."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src).hexdigest()[:16]
    lib = BUILD_DIR / f"libjwave_modwt_{key}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", tmp, str(SOURCE)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, lib)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"nvcc failed:\n{e.stderr[-4000:]}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.cache
def _register() -> ctypes.CDLL:
    """Load the library and register its handlers; the cache keeps the
    library (and so the handlers' code) alive for the process."""
    lib = ctypes.cdll.LoadLibrary(str(build_library()))
    for name, symbol in _TARGETS.items():
        handler = getattr(lib, symbol)
        handler.restype = ctypes.c_void_p       # XLA_FFI_Error*
        handler.argtypes = [ctypes.c_void_p]    # XLA_FFI_CallFrame*
        jax.ffi.register_ffi_target(
            name, jax.ffi.pycapsule(handler), platform="CUDA")
    return lib


@functools.cache
def available() -> bool:
    """True when JAX's default device is a CUDA GPU and the kernel library
    builds and registers; the public ops take the XLA path otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu" or "rocm" in dev.client.platform_version.lower():
        return False
    try:
        _register()
    except (OSError, RuntimeError) as e:
        warnings.warn(f"fused MODWT kernels unavailable: {e}")
        return False
    return True


def applies(kind: str, x, level: int, wavelet: DiscreteWavelet) -> bool:
    """Whether a public op should run the ``kind`` kernel on ``x``: float32
    or bfloat16 data, a plan that fits, and :func:`available`.  ``x`` is
    the op's input — coefficients ``(level+1, ..., N)`` for the inverse."""
    if x.dtype not in (jnp.float32, jnp.bfloat16):
        return False        # f64 and integer inputs stay on the XLA path
    if kind == "inverse" and x.ndim < 2:
        return False
    lead = x.shape[1:-1] if kind == "inverse" else x.shape[:-1]
    return (plan(kind, math.prod(lead), x.shape[-1], level, wavelet.length)
            is not None and available())


def _require() -> None:
    if not available():
        raise ValueError(
            "a fused MODWT kernel needs a CUDA GPU and nvcc; this process "
            f"has {jax.devices()[0].platform} devices (interpret=True runs "
            "the XLA cascade in its place)")


# ---------------------------------------------------------------------------
# Routing: the kernel where the call is lowered for a CUDA GPU, XLA elsewhere
# ---------------------------------------------------------------------------

def _route(kernel, plain, *args, interpret=False):
    """``kernel(*args)`` in a program lowered for a CUDA GPU, ``plain(*args)``
    (the XLA cascade) in one lowered for any other platform, so that work
    placed on the host CPU of a GPU machine never reaches the CUDA-only
    custom call.  ``interpret=True`` runs ``plain`` on any backend."""
    if interpret:
        return plain(*args)
    _require()
    return jax.lax.platform_dependent(*args, cuda=kernel, default=plain)


def _plain_forward(x2, wavelet, level):
    return modwt(x2.astype(jnp.float32), wavelet, level,
                 "direct").astype(x2.dtype)


def _plain_inverse(c3, wavelet):
    return imodwt(c3.astype(jnp.float32), wavelet, "direct").astype(c3.dtype)


def _shrink(w, t, mode):
    if mode == "soft":
        return jnp.sign(w) * jnp.maximum(jnp.abs(w) - t, 0.0)
    return jnp.where(jnp.abs(w) > t, w, 0.0)


def _plain_denoise(x2, thr, wavelet, level, mode):
    c = modwt(x2.astype(jnp.float32), wavelet, level, "direct")
    det = _shrink(c[:level], thr[..., None], mode)
    return imodwt(jnp.concatenate([det, c[level:]]), wavelet,
                  "direct").astype(x2.dtype)


def _plain_variance(x2, wavelet, level):
    c = modwt(x2.astype(jnp.float32), wavelet, level, "direct")
    return jnp.mean(jnp.square(c), axis=-1)       # (level+1, rows)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _taps(wavelet):
    g, h = modwt_base_filters(wavelet)
    return np.asarray(g, np.float32), np.asarray(h, np.float32)


def _check_dtype(x, what):
    if x.dtype not in (jnp.float32, jnp.bfloat16):
        raise ValueError(f"{what} takes float32 or bfloat16, got {x.dtype}")


def _plan_or_raise(kind, rows, n, level, m, tile, shape):
    p = plan(kind, rows, n, level, m, tile)
    if p is None:
        raise ValueError(f"no {kind} kernel plan for shape {shape}, "
                         f"level {level}, {m} taps")
    return p


@functools.partial(jax.jit, static_argnames=("wavelet", "level", "tile",
                                             "interpret"))
def _forward(x, wavelet, level, tile=None, interpret=False):
    _check_dtype(x, "the fused MODWT")
    batch, n = x.shape[:-1], x.shape[-1]
    _check_level(n, level)
    x2 = x.reshape(-1, n)
    g, h = _taps(wavelet)
    p = _plan_or_raise("forward", x2.shape[0], n, level, len(g), tile,
                       x.shape)
    kernel = jax.ffi.ffi_call(
        "jwave_modwt_fwd",
        jax.ShapeDtypeStruct((level + 1,) + x2.shape, x.dtype),
        vmap_method="sequential")
    out = _route(
        lambda v: kernel(v, level=np.int32(level), tile=np.int32(p.tile),
                         halo=np.int32(p.halo), g=g, h=h),
        lambda v: _plain_forward(v, wavelet, level), x2, interpret=interpret)
    return out.reshape((level + 1,) + batch + (n,))


@functools.partial(jax.jit, static_argnames=("wavelet", "tile", "interpret"))
def _inverse(c, wavelet, tile=None, interpret=False):
    _check_dtype(c, "the fused inverse MODWT")
    level = c.shape[0] - 1
    if level < 1:
        raise ValueError("need at least level 1 (rows W_1 and V_1)")
    batch, n = c.shape[1:-1], c.shape[-1]
    c3 = c.reshape(level + 1, -1, n)
    g, h = _taps(wavelet)
    p = _plan_or_raise("inverse", c3.shape[1], n, level, len(g), tile,
                       c.shape)
    kernel = jax.ffi.ffi_call(
        "jwave_modwt_inv", jax.ShapeDtypeStruct(c3.shape[1:], c.dtype),
        vmap_method="sequential")
    out = _route(
        lambda v: kernel(v, tile=np.int32(p.tile), halo=np.int32(p.halo),
                         g=g, h=h),
        lambda v: _plain_inverse(v, wavelet), c3, interpret=interpret)
    return out.reshape(batch + (n,))


@functools.partial(jax.custom_vjp, nondiff_argnums=(1, 2, 3, 4))
def modwt_fused(x, wavelet: DiscreteWavelet, level: int,
                tile: int | None = None, interpret: bool = False):
    """Fused forward MODWT: x (..., N) → (level+1, ..., N); differentiable.

    float32 or bfloat16 in and out, f32 arithmetic.  ``interpret=True`` runs
    the XLA cascade in the kernel's place on any backend; otherwise this
    needs :func:`available`.
    """
    return _forward(x, wavelet, level, tile, interpret)


def _modwt_fwd(x, wavelet, level, tile, interpret):
    return _forward(x, wavelet, level, tile, interpret), None


def _modwt_bwd(wavelet, level, tile, interpret, _, cot):
    return (_inverse(cot, wavelet, tile, interpret),)


modwt_fused.defvjp(_modwt_fwd, _modwt_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1, 2, 3))
def imodwt_fused(c, wavelet: DiscreteWavelet, tile: int | None = None,
                 interpret: bool = False):
    """Fused inverse MODWT: (level+1, ..., N) → (..., N); differentiable."""
    return _inverse(c, wavelet, tile, interpret)


def _imodwt_fwd(c, wavelet, tile, interpret):
    return _inverse(c, wavelet, tile, interpret), c.shape[0] - 1


def _imodwt_bwd(wavelet, tile, interpret, level, cot):
    return (_forward(cot, wavelet, level, tile, interpret),)


imodwt_fused.defvjp(_imodwt_fwd, _imodwt_bwd)


def _threshold_table(threshold, level, batch):
    return jnp.broadcast_to(jnp.asarray(threshold, jnp.float32),
                            (level,) + batch)


@functools.partial(jax.jit, static_argnames=("wavelet", "level", "mode",
                                             "tile", "interpret"))
def _denoise(x, threshold, wavelet, level, mode, tile, interpret):
    _check_dtype(x, "the fused denoise")
    if mode not in _MODES:
        raise ValueError(f"mode must be 'soft' or 'hard', got {mode!r}")
    batch, n = x.shape[:-1], x.shape[-1]
    _check_level(n, level)
    x2 = x.reshape(-1, n)
    thr = _threshold_table(threshold, level, batch).reshape(level, -1)
    g, h = _taps(wavelet)
    p = _plan_or_raise("denoise", x2.shape[0], n, level, len(g), tile,
                       x.shape)
    kernel = jax.ffi.ffi_call(
        "jwave_modwt_denoise", jax.ShapeDtypeStruct(x2.shape, x.dtype),
        vmap_method="sequential")
    out = _route(
        lambda v, t: kernel(v, t, level=np.int32(level),
                            tile=np.int32(p.tile), halo=np.int32(p.halo),
                            mode=np.int32(_MODES[mode]), g=g, h=h),
        lambda v, t: _plain_denoise(v, t, wavelet, level, mode),
        x2, thr, interpret=interpret)
    return out.reshape(x.shape)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4, 5, 6))
def modwt_denoise_fused(x, threshold, wavelet: DiscreteWavelet, level: int,
                        mode: str = "soft", tile: int | None = None,
                        interpret: bool = False):
    """Single-pass MODWT denoise: x (..., N) → (..., N); differentiable in
    ``x`` and ``threshold``.

    ``threshold`` broadcasts to ``(level, ...)``: one value per detail level
    and signal (a scalar, a per-signal ``(...)`` array, or a per-level
    ``(level, 1…)`` array), as the detail rows W_1..W_L are shrunk
    (MODWTExample.java:125-172).
    """
    return _denoise(x, threshold, wavelet, level, mode, tile, interpret)


def _denoise_fwd(x, threshold, wavelet, level, mode, tile, interpret):
    out = _denoise(x, threshold, wavelet, level, mode, tile, interpret)
    return out, (x, threshold)


def _denoise_bwd(wavelet, level, mode, tile, interpret, res, cot):
    """y = Aᵀ·S(A·x) with Aᵀ = A⁻¹, so the VJP in x is Aᵀ(S'(c) ⊙ A·cot)
    and, for soft shrinkage, the one in t is Σ_n A·cot ⊙ (−sign(c))·S'(c),
    where c = A·x and S'(c) = 1[|c| > t] on the detail rows."""
    x, threshold = res
    c = _forward(x, wavelet, level, tile, interpret).astype(jnp.float32)
    u = _forward(cot, wavelet, level, tile, interpret).astype(jnp.float32)
    table, unbroadcast = jax.vjp(
        lambda t: _threshold_table(t, level, x.shape[:-1]), threshold)
    keep = jnp.abs(c[:level]) > table[..., None]
    details = jnp.where(keep, u[:level], 0.0)
    gx = _inverse(jnp.concatenate([details, u[level:]]).astype(x.dtype),
                  wavelet, tile, interpret)
    if mode == "soft":
        gt = -jnp.sum(jnp.where(keep, u[:level] * jnp.sign(c[:level]), 0.0),
                      axis=-1)
    else:   # a hard threshold moves no kept value: zero almost everywhere
        gt = jnp.zeros_like(table)
    return gx, unbroadcast(gt)[0]


modwt_denoise_fused.defvjp(_denoise_fwd, _denoise_bwd)


@functools.partial(jax.jit, static_argnames=("wavelet", "level", "tile",
                                             "interpret"))
def _variance(x, wavelet, level, tile, interpret):
    _check_dtype(x, "the fused variance")
    batch, n = x.shape[:-1], x.shape[-1]
    _check_level(n, level)
    x2 = x.reshape(-1, n)
    g, h = _taps(wavelet)
    p = _plan_or_raise("variance", x2.shape[0], n, level, len(g), tile,
                       x.shape)
    kernel = jax.ffi.ffi_call(
        "jwave_modwt_var",
        jax.ShapeDtypeStruct((x2.shape[0], -(-n // p.tile), level + 1),
                             jnp.float32),
        vmap_method="sequential")

    def on_card(v):     # per-tile partial sums, summed here
        partial = kernel(v, level=np.int32(level), tile=np.int32(p.tile),
                         halo=np.int32(p.halo), g=g, h=h)
        return (jnp.sum(partial, axis=1) / n).T     # (level+1, rows)

    out = _route(on_card, lambda v: _plain_variance(v, wavelet, level), x2,
                 interpret=interpret)
    return out.reshape((level + 1,) + batch)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1, 2, 3, 4))
def modwt_var_fused(x, wavelet: DiscreteWavelet, level: int,
                    tile: int | None = None, interpret: bool = False):
    """Per-scale second moments in one pass: x (..., N) → (level+1, ...)
    with rows ``mean(W_1²) … mean(W_L²), mean(V_L²)`` (the biased,
    circular Percival–Walden wavelet variance of ops/analysis.py);
    differentiable.

    Each block writes f32 partial sums of its tile; XLA sums the tiles.
    """
    return _variance(x, wavelet, level, tile, interpret)


def _variance_fwd(x, wavelet, level, tile, interpret):
    return _variance(x, wavelet, level, tile, interpret), x


def _variance_bwd(wavelet, level, tile, interpret, x, cot):
    """ν_j = mean_n (A·x)_j², so the VJP is Aᵀ((2/N)·cot_j·(A·x)_j)."""
    c = _forward(x, wavelet, level, tile, interpret).astype(jnp.float32)
    scaled = (2.0 / x.shape[-1]) * cot[..., None] * c
    return (_inverse(scaled.astype(x.dtype), wavelet, tile, interpret),)


modwt_var_fused.defvjp(_variance_fwd, _variance_bwd)
