"""The package's former name, kept so that existing imports still work.

This name is :mod:`jwave_pro` itself, and every submodule ``<name>.X`` is
the module ``jwave_pro.X`` (not a second copy), so classes, registries and
jit caches are shared between the two spellings.  New code imports
:mod:`jwave_pro`.
"""
import importlib
import importlib.abc
import importlib.machinery
import sys
import warnings

import jwave_pro

_OLD, _NEW = __name__, jwave_pro.__name__


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``<old>.X`` to the already-importable ``jwave_pro.X``."""

    def find_spec(self, fullname, path=None, target=None):
        if fullname.startswith(_OLD + "."):
            return importlib.machinery.ModuleSpec(fullname, self)
        return None

    def create_module(self, spec):
        return None     # a placeholder, replaced in exec_module

    def exec_module(self, module):
        # the import system hands back whatever sys.modules holds for the
        # name once exec_module returns: here, the real module
        sys.modules[module.__name__] = importlib.import_module(
            _NEW + module.__name__[len(_OLD):])


warnings.warn(f"{_OLD} was renamed {_NEW}; import {_NEW} instead",
              DeprecationWarning, stacklevel=2)
sys.meta_path.insert(0, _Alias())
sys.modules[_OLD] = jwave_pro
