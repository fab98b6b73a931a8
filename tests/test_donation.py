"""Buffer donation — the JAX in-place/pooled tier.

The reference dedicates whole classes to buffer reuse
(``InPlaceFastWaveletTransform.java:70-100``, ``PooledMODWTTransform``,
``utils/ArrayBufferPool.java:24-256``).  Here that tier is XLA buffer
donation: ``donate_argnums`` aliases an output onto the input's buffer, so
a denoise/roundtrip allocates no second signal-sized array.  These tests
assert the aliasing actually happens on the compiled executable — not just
that the flag was passed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import jwave_pro as jw


@pytest.fixture(scope="module")
def x():
    return jnp.asarray(
        np.random.default_rng(7).standard_normal((8, 1024)), jnp.float32)


def test_denoise_inplace_hlo_aliases_input(x):
    w = jw.wavelet("Daubechies 4")
    lowered = jw.modwt_denoise_inplace.lower(x, w, 4)
    # donation is recorded in the stablehlo input attributes…
    assert ("tf.aliasing_output" in lowered.as_text()
            or "jax.buffer_donor" in lowered.as_text())
    # …and must survive into the compiled executable's aliasing config
    # (XLA rejects donations it cannot honor — shape/dtype mismatch).
    hlo = lowered.compile().as_text()
    assert "input_output_alias" in hlo


def test_denoise_inplace_consumes_input(x):
    w = jw.wavelet("Daubechies 4")
    ref = jw.modwt_denoise(x, w, 4)
    x2 = x + 0.0  # private buffer to donate
    out = jw.modwt_denoise_inplace(x2, w, 4)
    assert x2.is_deleted()  # the input buffer was truly donated
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-6)


def test_roundtrip_donation_aliases(x):
    """The bench's donating roundtrip step aliases input → output."""
    w = jw.wavelet("Daubechies 4")
    rt = jax.jit(lambda v: jw.imodwt(jw.modwt(v, w, 5), w), donate_argnums=0)
    hlo = rt.lower(x).compile().as_text()
    assert "input_output_alias" in hlo
    x2 = x + 0.0
    out = rt(x2)
    assert x2.is_deleted()
    np.testing.assert_allclose(np.asarray(out), np.asarray(x), atol=1e-5)
