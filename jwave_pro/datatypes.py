"""Dense/sparse 1D/2D/3D value stores (``jwave/datatypes/`` analogs).

The reference's ``Line/Block/Space`` hierarchy — dense ``*Full`` array
stores vs sparse ``*Hash`` HashMap stores, both behind the ``Super``
alloc/erase lifecycle (``datatypes/Super.java:36-100``,
``lines/LineFull.java``, ``lines/LineHash.java:147-225``) — is a side tier
the transform hot path never touches (SURVEY §2.3).  The JAX mapping:

  * dense (*Full*): a ``jnp`` array with an offset, allocated lazily;
  * sparse (*Hash*): a host-side ``{index: value}`` mapping with O(1)
    get/set and NO densification (round-1 review flagged the old BCOO
    wrapper as cosmetic — it densified on every ``set``).  ``to_bcoo()``
    exports a ``jax.experimental.sparse.BCOO`` built directly from the
    mapping, ``to_array()`` a dense array.

Lifecycle parity: ``alloc()``/``erase()``/``is_allocated`` mirror
``Super.java``; access before ``alloc`` raises
:class:`~jwave_pro.exceptions.NotAllocated` (``Super.checkMemory``),
out-of-range indices raise :class:`~jwave_pro.exceptions.NotValid`
(``Line.checkIndex``), and a hash-store ``get`` of an unset index raises
:class:`~jwave_pro.exceptions.NotFound` exactly like
``LineHash.get`` (``LineHash.java:183-199``).

Divergence (by design): stores are immutable pytree-style values —
``alloc``/``erase``/``set`` return a NEW store instead of mutating, the
functional convention used across this library.
"""
from __future__ import annotations

import dataclasses
import typing

import jax
import jax.numpy as jnp

from .exceptions import NotAllocated, NotFound, NotValid

__all__ = ["Line", "Block", "Space", "SuperLine"]


@dataclasses.dataclass(frozen=True)
class _Store:
    """Offset + size store with the Super alloc/erase lifecycle.

    ``data`` is None (unallocated), a jnp array (dense/*Full*), or a
    host dict {relative-index-tuple: float} (sparse/*Hash*).
    """

    sizes: tuple[int, ...]
    offset: tuple[int, ...]
    data: typing.Any = None
    sparse: bool = False
    dtype: typing.Any = jnp.float64

    # -- construction (LineFull/LineHash ctor surface) ----------------------
    @classmethod
    def create(cls, *sizes, offset=None, dtype=jnp.float64):
        """Dense (*Full*) store, allocated immediately for convenience."""
        off = tuple(offset) if offset else (0,) * len(sizes)
        return cls(tuple(sizes), off, jnp.zeros(sizes, dtype=dtype),
                   False, dtype)

    @classmethod
    def sparse_create(cls, *sizes, offset=None, dtype=jnp.float64):
        """Sparse (*Hash*) store — O(1) get/set, nothing densified."""
        off = tuple(offset) if offset else (0,) * len(sizes)
        return cls(tuple(sizes), off, {}, True, dtype)

    @classmethod
    def unallocated(cls, *sizes, offset=None, sparse=False,
                    dtype=jnp.float64):
        """Pre-``alloc()`` store (Super lifecycle start state)."""
        off = tuple(offset) if offset else (0,) * len(sizes)
        return cls(tuple(sizes), off, None, sparse, dtype)

    # -- Super lifecycle (Super.java:36-100) --------------------------------
    @property
    def is_allocated(self) -> bool:
        return self.data is not None

    def alloc(self) -> "_Store":
        """Allocate backing storage (no-op if already allocated, like
        ``LineHash.alloc``, ``LineHash.java:159-168``)."""
        if self.is_allocated:
            return self
        data = {} if self.sparse else jnp.zeros(self.sizes, dtype=self.dtype)
        return dataclasses.replace(self, data=data)

    def erase(self) -> "_Store":
        """Drop the backing storage (``LineHash.erase``)."""
        return dataclasses.replace(self, data=None)

    def copy(self) -> "_Store":
        """Deep copy incl. data if allocated (``Super.copy``)."""
        data = dict(self.data) if isinstance(self.data, dict) else self.data
        return dataclasses.replace(self, data=data)

    # -- checked access -----------------------------------------------------
    def _check_memory(self):
        if not self.is_allocated:
            raise NotAllocated(
                "no memory allocated for this object "
                "[parity: Super.checkMemory, Super.java:54-60]")

    def _rel(self, idx):
        if len(idx) != len(self.sizes):
            raise NotValid(f"expected {len(self.sizes)} indices, got "
                           f"{len(idx)}")
        rel = tuple(int(i) - o for i, o in zip(idx, self.offset))
        for r, s in zip(rel, self.sizes):
            if not 0 <= r < s:
                raise NotValid(
                    f"index {idx} out of range for offset {self.offset} "
                    f"sizes {self.sizes} [parity: Line.checkIndex]")
        return rel

    def get(self, *idx):
        self._check_memory()
        rel = self._rel(idx)
        if isinstance(self.data, dict):
            if rel not in self.data:
                raise NotFound(
                    f"no value stored for requested index {idx} "
                    "[parity: LineHash.java:192-195]")
            return self.data[rel]
        return self.data[rel]

    def set(self, *idx_and_value) -> "_Store":
        *idx, value = idx_and_value
        self._check_memory()
        rel = self._rel(idx)
        if isinstance(self.data, dict):
            new = dict(self.data)
            new[rel] = value
            return dataclasses.replace(self, data=new)
        return dataclasses.replace(self, data=self.data.at[rel].set(value))

    # -- export -------------------------------------------------------------
    @property
    def shape(self):
        return self.sizes

    @property
    def nnz(self) -> int:
        """Stored-entry count (sparse) or total size (dense)."""
        if isinstance(self.data, dict):
            return len(self.data)
        return int(jnp.size(self.data)) if self.is_allocated else 0

    def to_array(self) -> jax.Array:
        """Dense jnp array (unset sparse entries are 0)."""
        self._check_memory()
        if isinstance(self.data, dict):
            import numpy as np

            out = np.zeros(self.sizes, dtype=np.result_type(self.dtype))
            for rel, v in self.data.items():
                out[rel] = v
            return jnp.asarray(out, dtype=self.dtype)
        return self.data

    def to_bcoo(self):
        """Export the sparse store as BCOO — built from the stored entries
        directly, never via a dense intermediate."""
        from jax.experimental import sparse

        self._check_memory()
        if not isinstance(self.data, dict):
            return sparse.BCOO.fromdense(self.data)
        import numpy as np

        items = sorted(self.data.items())
        if items:
            indices = jnp.asarray(np.array([k for k, _ in items],
                                           dtype=np.int32))
            values = jnp.asarray(np.array([v for _, v in items]),
                                 dtype=self.dtype)
        else:
            indices = jnp.zeros((0, len(self.sizes)), jnp.int32)
            values = jnp.zeros((0,), self.dtype)
        return sparse.BCOO((values, indices), shape=self.sizes)


class Line(_Store):
    """1D store (datatypes/lines/Line.java; Full/Hash via create/sparse_create)."""


class Block(_Store):
    """2D store (datatypes/blocks/Block.java)."""


class Space(_Store):
    """3D store (datatypes/spaces/Space.java)."""


@dataclasses.dataclass(frozen=True)
class SuperLine:
    """Windowing container over a long signal (datatypes/SuperLine.java).

    Produces fixed-size windows with hop — the functional analog of the
    reference's windowed iteration."""

    data: jax.Array
    window: int
    hop: int

    def windows(self) -> jax.Array:
        """(num_windows, window) view of the signal."""
        n = self.data.shape[-1]
        num = max(0, (n - self.window) // self.hop + 1)
        idx = (jnp.arange(num)[:, None] * self.hop
               + jnp.arange(self.window)[None, :])
        return self.data[..., idx]
