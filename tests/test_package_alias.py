"""The package's former name still imports, as the same modules."""
import importlib
import pathlib
import sys
import warnings

import pytest

import jwave_pro

REPO = pathlib.Path(__file__).resolve().parents[1]
ALIASES = sorted(p.name for p in REPO.glob("jwave_pro_*/__init__.py")
                 for p in [p.parent])


def _import_alias(name):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fresh = name not in sys.modules
        mod = importlib.import_module(name)
    if fresh:
        assert any(issubclass(w.category, DeprecationWarning)
                   and jwave_pro.__name__ in str(w.message) for w in caught)
    return mod


def test_alias_package_exists():
    assert ALIASES, "no alias package beside jwave_pro"


@pytest.mark.parametrize("alias", ALIASES)
@pytest.mark.parametrize("sub", [
    "", ".ops.modwt", ".kernels.modwt_cuda", ".parallel.sharded",
    ".streaming",
])
def test_alias_resolves_to_the_same_module(alias, sub):
    """``<alias>.X`` is ``jwave_pro.X`` itself, not a second copy."""
    _import_alias(alias)
    assert importlib.import_module(alias + sub) is \
        importlib.import_module(jwave_pro.__name__ + sub)


@pytest.mark.parametrize("alias", ALIASES)
def test_alias_from_import_shares_objects(alias):
    _import_alias(alias)
    mod = importlib.import_module(alias + ".wavelets")
    assert mod.wavelet is jwave_pro.wavelet
    assert mod.wavelet("Daubechies 4").length == 8
