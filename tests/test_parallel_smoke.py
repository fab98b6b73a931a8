"""Representative multi-device smoke kept in the DEFAULT run.

The full sharded/HLO suite (tests/test_parallel.py, 35 programs) is
``slow``-gated because its XLA CPU compiles dominate suite wall clock;
these two cheap programs keep a cross-device regression tripwire in every
default run (the driver's ``dryrun_multichip`` covers the rest).
"""
import numpy as np
import pytest

import jax

import jwave_pro as jw
from jwave_pro.parallel import make_mesh
from jwave_pro.parallel.sharded import imodwt_sharded, modwt_sharded

needs8 = pytest.mark.skipif(len(jax.devices()) < 8,
                            reason="needs 8 virtual devices")


@needs8
@pytest.mark.slow
def test_modwt_sharded_roundtrip_smoke(rng):
    # Slow-marked (r5 suite diet): ~70 s of sharded-compile time; the
    # driver's dryrun_multichip runs every round and the --runslow
    # distributed battery covers the full sharded surface.
    mesh = make_mesh({"data": 2, "signal": 4})
    w = jw.wavelet("Daubechies 4")
    x = rng.standard_normal((2, 256))
    c = modwt_sharded(x, w, 3, mesh)
    np.testing.assert_allclose(np.asarray(c),
                               np.asarray(jw.modwt(x, w, 3, "direct")),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(imodwt_sharded(c, w, mesh)), x,
                               atol=1e-10)
