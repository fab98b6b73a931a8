"""Ahead-of-time export for production serving.

The reference deploys as a JAR — any JVM can call it years later.  The
JAX-native equivalent of that stability story is `jax.export`: trace+lower
a jitted pipeline ONCE, serialize the StableHLO artifact (a versioned,
compiler-independent format), and reload it in a serving process that
needs neither this library nor tracing — just jax and the bytes.  This
module wraps that flow for the library's pipelines:

* serving processes skip all host-side planning (filter-bank construction,
  kernel tile planning, fused-constant composition happen at EXPORT time);
* the artifact pins the compute graph — library upgrades cannot silently
  change a deployed model's numerics;
* `batch_polymorphic=True` exports one artifact serving ANY batch size
  (shape-polymorphic leading dim), the common serving dimension.

Example::

    import jwave_pro as jw
    w = jw.wavelet("Daubechies 4")
    art = jw.export_pipeline(
        lambda x: jw.modwt_denoise(x, w, 5, threshold=0.8),
        jnp.zeros((8, 100003), jnp.float32), batch_polymorphic=True)
    open("denoise.jwx", "wb").write(art)
    # -- serving side --
    fn = jw.load_pipeline(open("denoise.jwx", "rb").read())
    y = fn(batch)          # any batch size, same compiled graph
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import export as _jexport

__all__ = ["export_pipeline", "load_pipeline"]


def export_pipeline(fn, *example_args, batch_polymorphic: bool = False,
                    platforms=None) -> bytes:
    """Serialize ``jit(fn)`` at the example arguments' shapes → bytes.

    ``fn`` must be a jit-able pure function of array arguments (close over
    wavelets/levels/thresholds — static configuration belongs at export
    time, exactly like the reference bakes its config into the built JAR).
    ``batch_polymorphic=True`` replaces every example argument's LEADING
    axis with one shared symbolic dimension ``b`` so a single artifact
    serves any batch size.  ``platforms``: lowering targets (default: the
    current backend; pass ``("cuda", "cpu")`` to build one artifact usable
    on both — trace such a pipeline with ``method="direct"``, since on a
    CUDA host the MODWT family otherwise embeds its CUDA-only kernels).
    """
    if platforms is None:
        platforms = (jax.default_backend(),)
    if batch_polymorphic:
        (b,) = _jexport.symbolic_shape("b")
        # scalars/0-d args (thresholds, knobs) have no batch axis to
        # substitute — pass their shapes through unchanged
        specs = tuple(
            jax.ShapeDtypeStruct(
                ((b,) + jnp.shape(a)[1:]) if jnp.ndim(a) else (),
                jnp.asarray(a).dtype)
            for a in example_args)
    else:
        specs = tuple(jax.ShapeDtypeStruct(jnp.shape(a),
                                           jnp.asarray(a).dtype)
                      for a in example_args)
    exported = _jexport.export(jax.jit(fn),
                               platforms=tuple(platforms))(*specs)
    return bytes(exported.serialize())


def load_pipeline(data: bytes):
    """Rebuild the callable from :func:`export_pipeline` bytes.

    The returned function is jit-compatible and executes the EXPORTED
    graph (recompiled for the local topology on first call, numerics
    pinned by the artifact).
    """
    exported = _jexport.deserialize(data)
    return jax.jit(exported.call)
