"""Multi-device tests on the 8-device virtual CPU mesh (SURVEY §4.8).

The whole file is ``slow``-marked (VERDICT r2 #7): 35 shard_map programs
dominate the suite's XLA CPU compile time.  The default run keeps
multi-device coverage through ``__graft_entry__.dryrun_multichip`` (the
driver's gate) and a representative smoke below; run the full file with
``--runslow`` / ``JWAVE_TEST_SLOW=1``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import jwave_pro as jw
from jwave_pro.parallel import make_mesh
from jwave_pro.parallel.sharded import (
    cwt2_sharded, cwt_sharded, cwt_signal_sharded, fwt2_sharded,
    imodwt_sharded, modwt_sharded, wpt_sharded,
)

DB4 = jw.wavelet("Daubechies 4")

needs8 = pytest.mark.skipif(len(jax.devices()) < 8,
                            reason="needs 8 virtual devices")

pytestmark = pytest.mark.slow


@needs8
def test_modwt_signal_sharded_matches_single(rng):
    mesh = make_mesh({"signal": 8})
    x = rng.standard_normal((3, 512))
    got = np.asarray(modwt_sharded(x, DB4, 4, mesh))
    want = np.asarray(jw.modwt(x, DB4, 4, method="direct"))
    np.testing.assert_allclose(got, want, atol=1e-10)


@needs8
def test_modwt_sharded_deep_halo_multihop(rng):
    # Level 5 halo = 7·16 = 112 > shard (64) → multi-hop ppermute path.
    mesh = make_mesh({"signal": 8})
    x = rng.standard_normal(512)
    got = np.asarray(modwt_sharded(x, DB4, 5, mesh))
    want = np.asarray(jw.modwt(x, DB4, 5, method="direct"))
    np.testing.assert_allclose(got, want, atol=1e-10)


@needs8
def test_imodwt_sharded_roundtrip(rng):
    mesh = make_mesh({"signal": 8})
    x = rng.standard_normal(512)
    c = modwt_sharded(x, DB4, 4, mesh)
    xr = np.asarray(imodwt_sharded(c, DB4, mesh))
    np.testing.assert_allclose(xr, x, atol=1e-8)


@needs8
def test_modwt_2d_mesh_batch_and_signal(rng):
    mesh = make_mesh({"data": 2, "signal": 4})
    x = rng.standard_normal((4, 256))
    got = np.asarray(modwt_sharded(x, DB4, 3, mesh))
    want = np.asarray(jw.modwt(x, DB4, 3, method="direct"))
    np.testing.assert_allclose(got, want, atol=1e-10)


@needs8
def test_cwt_scale_sharded_matches(rng):
    mesh = make_mesh({"scale": 8})
    x = rng.standard_normal(256)
    scales = jw.generate_log_scales(1.0, 32.0, 16)
    got = np.asarray(cwt_sharded(x, scales, jw.MorletWavelet(), mesh
                                 ).coefficients)
    want = np.asarray(jw.cwt(x, scales, jw.MorletWavelet()).coefficients)
    np.testing.assert_allclose(got, want, atol=1e-10)


@needs8
def test_cwt_signal_sharded_matches_single(rng):
    # overlap-save long-signal CWT: time axis sharded, ring halo context
    mesh = make_mesh({"signal": 8})
    x = rng.standard_normal(4096)
    scales = jw.generate_log_scales(5.0, 16.0, 8)
    got = np.asarray(cwt_signal_sharded(x, scales, jw.MorletWavelet(), mesh
                                        ).coefficients)
    want = np.asarray(jw.cwt(x, scales, jw.MorletWavelet(),
                             padding="periodic").coefficients)
    np.testing.assert_allclose(got, want, atol=2e-6)


@needs8
def test_cwt_signal_sharded_multihop_halo(rng):
    # max scale 96 → default halo 96·4·2 = 768 > shard 512: needs two
    # ppermute hops per side for the ring context
    mesh = make_mesh({"signal": 8})
    x = rng.standard_normal(4096)
    scales = jw.generate_log_scales(8.0, 96.0, 4)
    got = np.asarray(cwt_signal_sharded(x, scales, jw.MorletWavelet(), mesh
                                        ).coefficients)
    want = np.asarray(jw.cwt(x, scales, jw.MorletWavelet(),
                             padding="periodic").coefficients)
    np.testing.assert_allclose(got, want, atol=2e-6)


@needs8
def test_cwt_signal_sharded_batch_and_signal(rng):
    mesh = make_mesh({"data": 2, "signal": 4})
    x = rng.standard_normal((2, 2048))
    scales = jw.generate_log_scales(2.0, 8.0, 6)
    got = np.asarray(cwt_signal_sharded(x, scales, jw.MexicanHatWavelet(),
                                        mesh).coefficients)
    want = np.asarray(jw.cwt(x, scales, jw.MexicanHatWavelet(),
                             padding="periodic").coefficients)
    np.testing.assert_allclose(got, want, atol=2e-6)
    with pytest.raises(ValueError):
        cwt_signal_sharded(rng.standard_normal(2049), scales,
                           jw.MexicanHatWavelet(), mesh)


@needs8
def test_cwt_signal_sharded_halo_only_comms(rng):
    """The overlap-save body's ONLY collectives are the ring halo
    permutes — no all-gathers/all-reduces sneak in (the per-device FFT
    must stay local for the O(N/D log N/D) cost claim to hold)."""
    mesh = make_mesh({"signal": 8})
    x = jnp.asarray(rng.standard_normal(4096))
    scales = tuple(float(s) for s in jw.generate_log_scales(5.0, 16.0, 4))
    fn = jax.jit(lambda v: cwt_signal_sharded(
        x=v, scales=scales, wavelet=jw.MorletWavelet(),
        mesh=mesh).coefficients)
    hlo = fn.lower(x).compile().as_text()
    others = [c for c in _COLLECTIVES
              if c != "collective-permute" and c in hlo]
    assert not others, f"unexpected collectives in sharded CWT HLO: {others}"
    assert "collective-permute" in hlo  # the halo exchange itself


@needs8
def test_cwt_signal_sharded_aliasing_gate(rng):
    # Nyquist-aliased small scales are rejected (their spectral-truncation
    # sinc tails cannot be covered by any halo) unless explicitly accepted.
    mesh = make_mesh({"signal": 8})
    x = rng.standard_normal(1024)
    with pytest.raises(ValueError, match="Nyquist-aliased"):
        cwt_signal_sharded(x, [1.0, 8.0], jw.MorletWavelet(), mesh)
    res = cwt_signal_sharded(x, [1.0, 8.0], jw.MorletWavelet(), mesh,
                             check_aliasing=False)
    assert res.coefficients.shape == (2, 1024)


@needs8
def test_cwt2_plane_sharded_matches(rng):
    # 4 scales x 2 angles = 8 planes over 8 devices (directional Morlet,
    # complex path) and 8 scales for the real Mexican-Hat half-plane path.
    mesh = make_mesh({"scale": 8})
    img = rng.standard_normal((24, 32))
    angles = np.linspace(0, np.pi, 2, endpoint=False)
    scales4 = np.linspace(2.0, 8.0, 4)
    w = jw.Morlet2D()
    got = np.asarray(cwt2_sharded(img, scales4, w, mesh,
                                  angles=angles).coefficients)
    want = np.asarray(jw.cwt2(img, scales4, w, angles=angles).coefficients)
    np.testing.assert_allclose(got, want, atol=1e-10)

    scales8 = np.linspace(1.5, 9.0, 8)
    got_r = cwt2_sharded(img, scales8, jw.MexicanHat2D(), mesh).coefficients
    assert not jnp.issubdtype(got_r.dtype, jnp.complexfloating)
    want_r = jw.cwt2(img, scales8, jw.MexicanHat2D()).coefficients
    np.testing.assert_allclose(np.asarray(got_r), np.asarray(want_r),
                               atol=1e-10)
    with pytest.raises(ValueError):
        cwt2_sharded(img, scales4, jw.MexicanHat2D(), mesh)  # 4 % 8 != 0


@needs8
def test_cwt2_sharded_batched(rng):
    mesh = make_mesh({"data": 2, "scale": 4})
    imgs = rng.standard_normal((4, 16, 16))
    scales = np.linspace(2.0, 6.0, 8)
    got = np.asarray(cwt2_sharded(imgs, scales, jw.MexicanHat2D(), mesh,
                                  ).coefficients)
    want = np.asarray(jw.cwt2(imgs, scales, jw.MexicanHat2D()).coefficients)
    np.testing.assert_allclose(got, want, atol=1e-10)


@needs8
def test_wpt_packet_sharded_matches(rng):
    mesh = make_mesh({"scale": 8})
    x = rng.standard_normal(1024)
    got = np.asarray(wpt_sharded(x, DB4, 5, mesh))
    want = np.asarray(jw.wpt(x, DB4, 5))
    np.testing.assert_allclose(got, want, atol=1e-10)


_COLLECTIVES = ("all-gather", "all-reduce", "collective-permute",
                "all-to-all", "reduce-scatter")


@needs8
def test_wpt_sharded_subtree_locality(rng):
    """The distributed-subtree levels communicate NOTHING: the compiled HLO
    of the whole forward contains zero collective ops (the honest P1 analog
    of ``ParallelWaveletPacketTransform.java:188-263`` — packets are
    independent subproblems)."""
    mesh = make_mesh({"scale": 8})
    x = jnp.asarray(rng.standard_normal(1024), jnp.float64)
    fn = jax.jit(lambda v: wpt_sharded(v, DB4, 5, mesh))
    hlo = fn.lower(x).compile().as_text()
    found = [c for c in _COLLECTIVES if c in hlo]
    assert not found, f"unexpected collectives in sharded WPT HLO: {found}"


@needs8
def test_iwpt_sharded_roundtrip_and_single_gather(rng):
    from jwave_pro.parallel.sharded import iwpt_sharded
    mesh = make_mesh({"scale": 8})
    x = jnp.asarray(rng.standard_normal(1024), jnp.float64)
    y = wpt_sharded(x, DB4, 5, mesh)
    xr = np.asarray(iwpt_sharded(y, DB4, 5, mesh))
    np.testing.assert_allclose(xr, np.asarray(x), atol=1e-8)
    # exactly one collective: the tiled all-gather reassembling level k
    fn = jax.jit(lambda v: iwpt_sharded(v, DB4, 5, mesh))
    hlo = fn.lower(y).compile().as_text()
    assert hlo.count("all-gather-start") <= 1
    others = [c for c in _COLLECTIVES if c != "all-gather" and c in hlo]
    assert not others, f"unexpected collectives in sharded iWPT HLO: {others}"


@needs8
def test_modwpt_node_sharded_matches(rng):
    """Sequency blocks are contiguous per device and the traced parity swap
    at the first local level lands every node exactly where the unsharded
    transform puts it (odd- and even-indexed devices take different filter
    assignments)."""
    from jwave_pro.parallel.sharded import modwpt_sharded
    mesh = make_mesh({"scale": 8})
    x = rng.standard_normal(96)
    for level in (3, 5):  # level == k and level > k
        got = np.asarray(modwpt_sharded(x, DB4, level, mesh))
        want = np.asarray(jw.modwpt(x, DB4, level))
        np.testing.assert_allclose(got, want, atol=1e-10)


@needs8
def test_modwpt_sharded_subtree_locality(rng):
    from jwave_pro.parallel.sharded import modwpt_sharded
    mesh = make_mesh({"scale": 8})
    x = jnp.asarray(rng.standard_normal(96), jnp.float64)
    fn = jax.jit(lambda v: modwpt_sharded(v, DB4, 4, mesh))
    hlo = fn.lower(x).compile().as_text()
    found = [c for c in _COLLECTIVES if c in hlo]
    assert not found, f"unexpected collectives in sharded MODWPT HLO: {found}"


@needs8
def test_imodwpt_sharded_roundtrip_and_single_gather(rng):
    from jwave_pro.parallel.sharded import (imodwpt_sharded,
                                                modwpt_sharded)
    mesh = make_mesh({"scale": 8})
    x = jnp.asarray(rng.standard_normal(128), jnp.float64)
    y = modwpt_sharded(x, DB4, 4, mesh)
    xr = np.asarray(imodwpt_sharded(y, DB4, mesh))
    np.testing.assert_allclose(xr, np.asarray(x), atol=1e-8)
    fn = jax.jit(lambda v: imodwpt_sharded(v, DB4, mesh))
    hlo = fn.lower(y).compile().as_text()
    assert hlo.count("all-gather-start") <= 1
    others = [c for c in _COLLECTIVES if c != "all-gather" and c in hlo]
    assert not others, f"unexpected collectives in sharded iMODWPT: {others}"


@needs8
def test_modwpt_sharded_batched(rng):
    from jwave_pro.parallel.sharded import (imodwpt_sharded,
                                                modwpt_sharded)
    mesh = make_mesh({"data": 2, "scale": 4})
    x = rng.standard_normal((4, 64))
    got = np.asarray(modwpt_sharded(x, DB4, 2, mesh, node_axis="scale",
                                    batch_axis="data"))
    want = np.asarray(jw.modwpt(x, DB4, 2))
    np.testing.assert_allclose(got, want, atol=1e-10)
    xr = np.asarray(imodwpt_sharded(jnp.asarray(got), DB4, mesh,
                                    node_axis="scale", batch_axis="data"))
    np.testing.assert_allclose(xr, x, atol=1e-8)


@needs8
def test_wpt_sharded_batched_shallow(rng):
    """level < log2(n_dev) degenerates to distributed storage; batched in."""
    from jwave_pro.parallel.sharded import iwpt_sharded
    mesh = make_mesh({"data": 2, "scale": 4})
    x = rng.standard_normal((4, 512))
    got = np.asarray(wpt_sharded(x, DB4, 2, mesh, batch_axis="data"))
    want = np.asarray(jw.wpt(x, DB4, 2))
    np.testing.assert_allclose(got, want, atol=1e-10)
    xr = np.asarray(iwpt_sharded(jnp.asarray(got), DB4, 2, mesh,
                                 batch_axis="data"))
    np.testing.assert_allclose(xr, x, atol=1e-8)


@needs8
def test_fwt2_row_sharded(rng):
    mesh = make_mesh({"data": 8})
    m = rng.standard_normal((16, 32))
    got = np.asarray(fwt2_sharded(m, DB4, mesh))
    want = np.asarray(jw.fwt2(m, DB4))
    np.testing.assert_allclose(got, want, atol=1e-10)


@needs8
def test_graft_entry_dryrun():
    import sys
    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert np.all(np.isfinite(np.asarray(out)))
    ge.dryrun_multichip(8)


@needs8
def test_fwt_signal_sharded_exact(rng):
    from jwave_pro.parallel.sharded import (
        fwt_sharded, gather_fwt_layout, ifwt_sharded,
    )
    mesh = make_mesh({"signal": 8})
    for name, lvl in (("Haar", 3), ("Daubechies 4", 3), ("Symlet 8", 2)):
        w = jw.wavelet(name)
        x = rng.standard_normal(512)
        y = fwt_sharded(x, w, lvl, mesh)
        ref = np.asarray(jw.fwt(x, w, lvl))
        np.testing.assert_allclose(np.asarray(gather_fwt_layout(y, lvl, 8)),
                                   ref, atol=1e-10, err_msg=name)
        np.testing.assert_allclose(np.asarray(ifwt_sharded(y, w, lvl, mesh)),
                                   x, atol=1e-8, err_msg=name)


@needs8
def test_fwt_sharded_batched(rng):
    from jwave_pro.parallel.sharded import fwt_sharded, gather_fwt_layout
    mesh = make_mesh({"data": 2, "signal": 4})
    xb = rng.standard_normal((4, 256))
    y = fwt_sharded(xb, DB4, 2, mesh)
    ref = np.asarray(jw.fwt(xb, DB4, 2))
    np.testing.assert_allclose(np.asarray(gather_fwt_layout(y, 2, 4)), ref,
                               atol=1e-10)


@needs8
def test_scattering_scale_sharded_matches(rng):
    from jwave_pro.parallel.sharded import scattering_sharded
    mesh = make_mesh({"scale": 8})
    x = rng.standard_normal(1024).astype(np.float32)
    # scattering_sharded runs the full-resolution cascade on each shard —
    # compare against the exact (undecimated) single-device reference
    want = jw.scattering1d(x, j=4, q=2, oversampling=64)   # L1 = 8 paths
    got = scattering_sharded(x, j=4, q=2, mesh=mesh)
    np.testing.assert_allclose(np.asarray(got.s0), np.asarray(want.s0),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.s1), np.asarray(want.s1),
                               atol=1e-5)
    # compacting the padded shard-major s2 recovers the global path order
    keep = got.pairs[:, 0] >= 0
    np.testing.assert_allclose(np.asarray(got.s2)[keep],
                               np.asarray(want.s2), atol=1e-5)
    np.testing.assert_allclose(got.pairs[keep], want.pairs, atol=0)
    # padding rows are exactly zero (zero psi2 rows, no masking needed)
    assert np.all(np.asarray(got.s2)[~keep] == 0.0)


@needs8
def test_scattering_sharded_batched_order1(rng):
    from jwave_pro.parallel.sharded import scattering_sharded
    mesh = make_mesh({"data": 2, "scale": 4})
    xb = rng.standard_normal((4, 512)).astype(np.float32)
    want = jw.scattering1d(xb, j=4, q=1, order=1, oversampling=64)
    got = scattering_sharded(xb, j=4, q=1, order=1, mesh=mesh)
    np.testing.assert_allclose(np.asarray(got.s1), np.asarray(want.s1),
                               atol=1e-5)
    assert got.s2 is None


@needs8
def test_scattering_sharded_zero_collectives(rng):
    # the whole cascade is local: the compiled HLO must contain no
    # all-gathers / collective-permutes / all-reduces at all.
    from jwave_pro.parallel.sharded import scattering_sharded
    mesh = make_mesh({"scale": 8})
    x = rng.standard_normal(1024).astype(np.float32)
    txt = jax.jit(lambda v: scattering_sharded(v, j=4, q=2, mesh=mesh).s2
                  ).lower(x).compile().as_text()
    for op in ("all-gather", "collective-permute", "all-reduce",
               "all-to-all", "reduce-scatter"):
        assert op not in txt, op


@needs8
def test_ssq_scale_sharded_matches(rng):
    from jwave_pro.parallel.sharded import ssq_sharded
    mesh = make_mesh({"scale": 8})
    t = np.arange(512) / 512.0
    x = np.sin(2 * np.pi * 40 * t).astype(np.float32)
    # scales bracketing the 40 Hz tone so Tx is non-trivial (scales are in
    # seconds here: f = fc/a)
    fc = float(jw.MorletWavelet().center_frequency)
    scales = np.asarray(jw.generate_log_scales(fc / 160, fc / 10, 16))
    want = jw.ssq_cwt(x, scales, sampling_rate=512.0)
    assert float(np.abs(np.asarray(want.Tx)).max()) > 1e-2  # not vacuous
    got = ssq_sharded(x, scales, mesh=mesh, sampling_rate=512.0)
    np.testing.assert_allclose(np.asarray(got.Tx), np.asarray(want.Tx),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(got.Wx), np.asarray(want.Wx),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.ssq_freqs),
                               np.asarray(want.ssq_freqs), rtol=1e-12)


@needs8
def test_ssq_sharded_single_psum(rng):
    # with explicit gamma the ONLY collective is the one Tx psum
    from jwave_pro.parallel.sharded import ssq_sharded
    mesh = make_mesh({"scale": 8})
    x = rng.standard_normal(256).astype(np.float32)
    scales = np.asarray(jw.generate_log_scales(1.0, 16.0, 8))
    txt = jax.jit(lambda v: ssq_sharded(v, scales, mesh=mesh,
                                        gamma=1e-4).Tx
                  ).lower(x).compile().as_text()
    assert txt.count("all-reduce-start") + txt.count("all-reduce(") == 1
    for op in ("all-gather", "collective-permute", "all-to-all"):
        assert op not in txt, op


@needs8
def test_ssq_sharded_rejects_nonuniform_grid(rng):
    from jwave_pro.parallel.sharded import ssq_sharded
    mesh = make_mesh({"scale": 8})
    with pytest.raises(ValueError, match="log-uniform"):
        ssq_sharded(rng.standard_normal(256).astype(np.float32),
                    np.asarray([1., 2., 3., 4., 5., 6., 7., 8.]), mesh=mesh)


@needs8
def test_modwt2_row_sharded_matches(rng):
    from jwave_pro.parallel.sharded import imodwt2_sharded, modwt2_sharded
    mesh = make_mesh({"signal": 8})
    x = rng.standard_normal((64, 48))
    got = np.asarray(modwt2_sharded(x, DB4, 3, mesh))
    want = np.asarray(jw.modwt2(x, DB4, 3))
    np.testing.assert_allclose(got, want, atol=1e-10)
    xr = np.asarray(imodwt2_sharded(jw.modwt2(x, DB4, 3), DB4, mesh))
    np.testing.assert_allclose(xr, x, atol=1e-10)


@needs8
def test_modwt2_row_sharded_batched_2dmesh(rng):
    from jwave_pro.parallel.sharded import modwt2_sharded
    mesh = make_mesh({"data": 2, "signal": 4})
    xb = rng.standard_normal((2, 32, 16))
    got = np.asarray(modwt2_sharded(xb, DB4, 2, mesh))
    want = np.asarray(jw.modwt2(xb, DB4, 2))
    np.testing.assert_allclose(got, want, atol=1e-10)


@needs8
def test_modwt2_row_sharded_multihop_halo(rng):
    # level-3 halo = 7*4 = 28 rows > per-device 8 rows -> multi-hop ring
    from jwave_pro.parallel.sharded import modwt2_sharded
    mesh = make_mesh({"signal": 8})
    x = rng.standard_normal((64, 32))
    got = np.asarray(modwt2_sharded(x, DB4, 3, mesh))
    want = np.asarray(jw.modwt2(x, DB4, 3))
    np.testing.assert_allclose(got, want, atol=1e-10)


@needs8
def test_scattering2d_path_sharded_matches(rng):
    from jwave_pro.parallel.sharded import scattering2d_sharded
    mesh = make_mesh({"scale": 8})
    img = rng.standard_normal((32, 32)).astype(np.float32)
    # the sharded cascade is full-resolution — compare vs the exact
    # (undecimated) single-device reference
    want = jw.scattering2d(img, j=2, l=4, oversampling=64)  # J·L = 8 paths
    got = scattering2d_sharded(img, j=2, l=4, mesh=mesh)
    np.testing.assert_allclose(np.asarray(got.s0), np.asarray(want.s0),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.s1), np.asarray(want.s1),
                               atol=1e-5)
    keep = got.pairs[:, 0] >= 0
    np.testing.assert_allclose(np.asarray(got.s2)[keep],
                               np.asarray(want.s2), atol=1e-5)
    np.testing.assert_allclose(got.pairs[keep], want.pairs, atol=0)
    assert np.all(np.asarray(got.s2)[~keep] == 0.0)
    # zero collectives in the compiled HLO
    txt = jax.jit(lambda v: scattering2d_sharded(v, j=2, l=4, mesh=mesh).s2
                  ).lower(img).compile().as_text()
    bad = [c for c in _COLLECTIVES if c in txt]
    assert not bad, bad


@needs8
def test_sharded_entry_validation(rng):
    from jwave_pro.parallel.sharded import (
        modwt2_sharded, scattering2d_sharded, scattering_sharded,
        ssq_sharded)
    mesh = make_mesh({"scale": 8})
    x = rng.standard_normal(256).astype(np.float32)
    for fn in (lambda: scattering_sharded(x, j=2, q=4),
               lambda: ssq_sharded(x, [1.0, 2.0, 4.0, 8.0]),
               lambda: scattering2d_sharded(rng.standard_normal((16, 16)),
                                            j=2, l=4)):
        with pytest.raises(ValueError, match="requires a mesh"):
            fn()
    with pytest.raises(ValueError, match="frequency bins"):
        ssq_sharded(x, np.asarray(jw.generate_log_scales(1., 16., 8)),
                    mesh=mesh, n_freqs=1)
    # modwt2_sharded enforces the same depth limit as modwt2
    mesh_s = make_mesh({"signal": 8})
    with pytest.raises(ValueError, match="theoretical limit|halo"):
        modwt2_sharded(rng.standard_normal((16, 16)), DB4, 5, mesh_s)


@needs8
def test_dtcwt_signal_sharded_matches_single(rng):
    # subband-for-subband parity with the single-device dual tree — the
    # sharded outputs need no gather step (contiguous decimated shards)
    from jwave_pro.parallel.sharded import dtcwt_sharded
    mesh = make_mesh({"signal": 8})
    x = rng.standard_normal((2, 1024))
    got = dtcwt_sharded(x, 3, mesh)
    want = jw.dtcwt(jnp.asarray(x), 3)
    for g, w in zip(got.highpass, want.highpass):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-10)
    np.testing.assert_allclose(np.asarray(got.lowpass_a),
                               np.asarray(want.lowpass_a), atol=1e-10)
    np.testing.assert_allclose(np.asarray(got.lowpass_b),
                               np.asarray(want.lowpass_b), atol=1e-10)


@needs8
def test_idtcwt_sharded_roundtrip(rng):
    from jwave_pro.parallel.sharded import dtcwt_sharded, idtcwt_sharded
    mesh = make_mesh({"data": 2, "signal": 4})
    x = rng.standard_normal((2, 512))
    res = dtcwt_sharded(x, 2, mesh)
    xr = np.asarray(idtcwt_sharded(res, mesh))
    np.testing.assert_allclose(xr, x, atol=1e-8)


@needs8
def test_dtcwt_sharded_validation(rng):
    from jwave_pro.parallel.sharded import dtcwt_sharded
    mesh = make_mesh({"signal": 8})
    with pytest.raises(ValueError, match="not divisible"):
        dtcwt_sharded(rng.standard_normal(128), 5, mesh)


@needs8
def test_batch_sharded_adaptive_ops_zero_collectives(rng):
    """Pure data parallelism for the adaptive tier (EWT's per-element bank,
    MP's per-element greedy scan): each device runs its own elements end to
    end, ZERO collectives in the compiled HLO.

    MP partitions under plain NamedSharding (rolls/convs/argmax all have
    batch-dim partitioners); EWT goes through shard_map because XLA's
    FFT/TopK custom-calls don't SPMD-partition even on batch dims (the
    global-jit route all-gathers) — the same reason `cwt_sharded` keeps its
    per-device FFTs inside shard_map."""
    from jwave_pro.parallel import NamedSharding, P, make_mesh
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    mesh = make_mesh({"data": 8})
    x = jax.device_put(
        jnp.asarray(rng.standard_normal((8, 256)), jnp.float32),
        NamedSharding(mesh, P("data", None)))

    fn_ewt = jax.jit(shard_map(
        lambda v: jw.ewt1d(v, 3).components, mesh=mesh,
        in_specs=P("data", None), out_specs=P("data", None, None)))
    hlo = fn_ewt.lower(x).compile().as_text()
    found = [c for c in _COLLECTIVES if c in hlo]
    assert not found, f"collectives in batch-sharded EWT: {found}"
    got = np.asarray(fn_ewt(x))
    want = np.asarray(jw.ewt1d(np.asarray(x), 3).components)
    np.testing.assert_allclose(got, want, atol=1e-5)

    fn_mp = jax.jit(lambda v: jw.matching_pursuit(
        v, DB4, 2, 4, method="direct").residual)
    hlo = fn_mp.lower(x).compile().as_text()
    found = [c for c in _COLLECTIVES if c in hlo]
    assert not found, f"collectives in batch-sharded MP: {found}"
    got = np.asarray(fn_mp(x))
    want = np.asarray(jw.matching_pursuit(np.asarray(x), DB4, 2, 4,
                                          method="direct").residual)
    np.testing.assert_allclose(got, want, atol=1e-5)


@needs8
def test_batch_sharded_financial_and_bestbasis_zero_collectives(rng):
    """r4 additions stay data-parallel: the financial preprocessing chain
    (scans along TIME, batch-dim partitionable) and best-basis denoising
    shard over batch with ZERO collectives.

    wpt_denoise picks ONE basis per call (costs summed over the batch), so
    under data sharding each device's shard must run the SAME basis — we
    shard_map it so every device selects over its local elements (the
    per-shard basis may differ; parity is vs per-shard local calls)."""
    from jwave_pro.parallel import NamedSharding, P, make_mesh
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    mesh = make_mesh({"data": 8})
    p = np.exp(np.cumsum(
        0.01 * rng.standard_normal((8, 256)), axis=-1)).astype(np.float32)
    p[0, 40:50] = np.nan
    x = jax.device_put(jnp.asarray(p),
                       NamedSharding(mesh, P("data", None)))

    fn_fin = jax.jit(lambda v: jw.preprocess_prices(v)[0])
    hlo = fn_fin.lower(x).compile().as_text()
    found = [c for c in _COLLECTIVES if c in hlo]
    assert not found, f"collectives in batch-sharded preprocess: {found}"
    np.testing.assert_allclose(np.asarray(fn_fin(x)),
                               np.asarray(jw.preprocess_prices(p)[0]),
                               atol=1e-5)

    fn_cp = jax.jit(lambda v: jw.modwt_changepoints(v, DB4, 3).d)
    hlo = fn_cp.lower(x).compile().as_text()
    found = [c for c in _COLLECTIVES if c in hlo]
    assert not found, f"collectives in batch-sharded changepoints: {found}"

    fn_bb = jax.jit(shard_map(
        lambda v: jw.wpt_denoise(v, DB4, 3, mode="hard"), mesh=mesh,
        in_specs=P("data", None), out_specs=P("data", None)))
    hlo = fn_bb.lower(x).compile().as_text()
    found = [c for c in _COLLECTIVES if c in hlo]
    assert not found, f"collectives in batch-sharded wpt_denoise: {found}"
    got = np.asarray(fn_bb(x))
    want = np.stack([np.asarray(jw.wpt_denoise(p[i], DB4, 3, mode="hard"))
                     for i in range(8)])
    np.testing.assert_allclose(got, want, atol=1e-5)
