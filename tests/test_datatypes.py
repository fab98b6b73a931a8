"""datatypes / exceptions / signals / CLI coverage."""
import numpy as np
import pytest

import jwave_pro as jw
from jwave_pro import cli, datatypes, exceptions
from jwave_pro.utils import signals


def test_line_block_space_dense():
    ln = datatypes.Line.create(8).set(3, 5.0)
    assert float(ln.get(3)) == 5.0
    blk = datatypes.Block.create(4, 4, offset=(2, 2)).set(3, 3, 7.0)
    assert float(blk.get(3, 3)) == 7.0
    spc = datatypes.Space.create(2, 3, 4).set(1, 2, 3, 9.0)
    assert float(spc.get(1, 2, 3)) == 9.0
    assert spc.shape == (2, 3, 4)


def test_sparse_stores():
    blk = datatypes.Block.sparse_create(4, 4).set(1, 2, 7.0)
    assert float(blk.get(1, 2)) == 7.0
    assert np.asarray(blk.to_array()).shape == (4, 4)


def test_super_lifecycle_parity():
    """Super.java:36-100 alloc/erase lifecycle: access before alloc raises
    NotAllocated; erase drops storage."""
    ln = datatypes.Line.unallocated(8)
    assert not ln.is_allocated
    with pytest.raises(exceptions.NotAllocated):
        ln.get(0)
    with pytest.raises(exceptions.NotAllocated):
        ln.set(0, 1.0)
    ln = ln.alloc()
    ln = ln.set(2, 4.0)
    assert float(ln.get(2)) == 4.0
    ln2 = ln.erase()
    with pytest.raises(exceptions.NotAllocated):
        ln2.get(2)
    # alloc is idempotent (LineHash.java:159-168)
    assert ln.alloc() is ln


def test_hash_store_semantics():
    """LineHash parity: O(1) sparse set (no densify), NotFound for unset
    indices (LineHash.java:183-199), NotValid out of range."""
    ln = datatypes.Line.sparse_create(1 << 20)  # huge logical size: stays O(1)
    ln = ln.set(5, 2.5).set(999999, 1.5)
    assert ln.nnz == 2
    assert float(ln.get(5)) == 2.5
    with pytest.raises(exceptions.NotFound):
        ln.get(6)  # allocated but unset → NotFound, matching the reference
    with pytest.raises(exceptions.NotValid):
        ln.get(1 << 21)
    bc = ln.to_bcoo()
    assert bc.nse == 2 and bc.shape == (1 << 20,)
    blk = datatypes.Block.sparse_create(4, 4, offset=(1, 1)).set(2, 3, 7.0)
    dense = np.asarray(blk.to_array())
    assert dense[1, 2] == 7.0 and dense.sum() == 7.0
    assert np.asarray(blk.to_bcoo().todense()).sum() == 7.0
    cp = blk.copy()
    assert float(cp.get(2, 3)) == 7.0


def test_superline_windows():
    sl = datatypes.SuperLine(np.arange(10.0), window=4, hop=2)
    w = np.asarray(sl.windows())
    assert w.shape == (4, 4)
    np.testing.assert_allclose(w[1], [2, 3, 4, 5])


def test_exception_hierarchy():
    assert issubclass(exceptions.NotValid, exceptions.JWaveFailure)
    assert issubclass(exceptions.JWaveFailure, exceptions.JWaveException)
    assert issubclass(exceptions.JWaveException, ValueError)
    with pytest.raises(exceptions.NotValid):
        jw.fwt(np.zeros(12), jw.wavelet("Haar"))
    with pytest.raises(exceptions.NotKnown):
        jw.wavelet("nope")
    with pytest.raises(exceptions.NotKnown):
        jw.build_transform("nope")


def test_signal_generators():
    s = signals.sine_oscillation(64, oscillations=2)
    assert abs(s[0]) < 1e-12 and len(s) == 64
    c = signals.cosine_oscillation(64)
    assert abs(c[0] - 1.0) < 1e-12
    ch = signals.chirp(256)
    assert len(ch) == 256
    e = signals.ecg_like(720)
    assert len(e) == 720 and np.max(e) > 0.5
    noisy, clean = signals.noisy_sine(128)
    assert np.std(noisy - clean) > 0


def test_cli_roundtrip(capsys):
    assert cli.main(["Fast Wavelet Transform", "Haar"]) == 0
    out = capsys.readouterr().out
    assert "reconstructed" in out
    assert cli.main(["bogus transform"]) == 1
