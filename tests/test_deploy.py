"""AOT export/serving artifacts (utils/deploy.py): serialize a pipeline,
reload it WITHOUT retracing library code, check numerics are pinned."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import jwave_pro as jw

DB4 = jw.wavelet("Daubechies 4")


@pytest.fixture
def rng():
    return np.random.default_rng(3)


def test_export_roundtrip_denoise(rng):
    x = jnp.asarray(rng.standard_normal((4, 2048)), jnp.float32)
    fn = lambda v: jw.modwt_denoise(v, DB4, 4, threshold=0.8)
    art = jw.export_pipeline(fn, x)
    assert isinstance(art, bytes) and len(art) > 100
    served = jw.load_pipeline(art)
    np.testing.assert_allclose(np.asarray(served(x)), np.asarray(fn(x)),
                               atol=1e-6)


@pytest.mark.slow
def test_export_batch_polymorphic(rng):
    fn = lambda v: jw.preprocess_prices(v)[0]
    p8 = jnp.asarray(np.exp(np.cumsum(
        0.01 * rng.standard_normal((8, 512)), -1)), jnp.float32)
    art = jw.export_pipeline(fn, p8, batch_polymorphic=True)
    served = jw.load_pipeline(art)
    # one artifact serves multiple batch sizes
    for b in (1, 3, 8):
        pb = p8[:b]
        np.testing.assert_allclose(np.asarray(served(pb)),
                                   np.asarray(fn(pb)), atol=1e-5)


def test_export_analysis_pipeline(rng):
    x = jnp.asarray(rng.standard_normal((2, 4096)), jnp.float32)
    fn = lambda v: jw.modwt_variance(v, DB4, 5)
    served = jw.load_pipeline(jw.export_pipeline(fn, x))
    np.testing.assert_allclose(np.asarray(served(x)), np.asarray(fn(x)),
                               rtol=1e-6)
