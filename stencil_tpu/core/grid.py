"""Halo'd dense grid: the JAX analog of the reference's
``BoundaryMatrix<T>`` / ``BoundaryMatrixView<T>``
(``/root/reference/include/stencil/boundary_matrix.hpp:31-245``).

Where the reference distinguishes an owning matrix from borrowed strided
views crossing the host->device ABI, JAX arrays are already immutable views
onto device buffers — so ``HaloGrid`` is a lightweight pytree wrapping one
padded array plus static halo/BC metadata. ``block_subview``-style tiling
(``boundary_matrix.hpp:190-218``) becomes static slices in the XLA sweep,
d0 chunks in the streamed path, and sharding metadata in the multi-device
path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class DirichletBC:
    """Per-dimension boundary conditions: Dirichlet (constant faces) or
    periodic (wrap-around) per dim.

    ``values[d] = (low_value, high_value)`` for dimension ``d``. The default
    matches the reference's initial conditions (``stencil.cpp:199-204``):
    left/right (last dim) = 1.0, top/bottom (first dim) = 0.0 — extended to
    rank n as: last dim faces 1.0, all other faces 0.0.

    ``periodic[d] = True`` makes dimension ``d`` wrap-around instead
    (its ``values`` entry is ignored). ``neumann[d] = True`` makes it
    zero-flux: ghost layer ``j`` mirrors interior layer ``j-1`` across
    the face plane (NumPy's ``mode='symmetric'``), the cell-centered
    reflection under which the normal derivative vanishes at the face.
    The reference is Dirichlet-only (``stencil.cpp:190-207``); periodic
    and Neumann dims are capability extensions. Empty
    ``periodic``/``neumann`` tuples (the
    default) mean all-Dirichlet, keeping every existing call site and
    cache key unchanged. The class name is kept for API stability. A
    dim may be periodic or Neumann, not both.

    Corner/edge regions of the halo where two faces meet: Dirichlet faces
    are filled in *increasing dimension order*, so the highest Dirichlet
    dimension's value wins in Dirichlet/Dirichlet corners; the dynamic
    dims (periodic wraps and Neumann mirrors) run after, in increasing
    dimension order (and re-run every sweep), copying the full extent of
    the other dims — so dynamic/dynamic corners hold the transitively
    wrapped/mirrored value and Dirichlet/dynamic corners carry the
    Dirichlet value through the wrap/mirror. Deterministic, and only
    observable through box stencils (star stencils never read halo
    corners).
    """

    values: Tuple[Tuple[float, float], ...]
    periodic: Tuple[bool, ...] = ()
    neumann: Tuple[bool, ...] = ()

    @staticmethod
    def reference_default(ndim: int) -> "DirichletBC":
        vals = [(0.0, 0.0)] * (ndim - 1) + [(1.0, 1.0)]
        return DirichletBC(values=tuple(vals))

    @staticmethod
    def zero(ndim: int) -> "DirichletBC":
        return DirichletBC(values=tuple([(0.0, 0.0)] * ndim))

    @staticmethod
    def periodic_all(ndim: int) -> "DirichletBC":
        return DirichletBC(values=tuple([(0.0, 0.0)] * ndim),
                           periodic=tuple([True] * ndim))

    def with_periodic(self, dims) -> "DirichletBC":
        """This BC with the given dims made periodic."""
        ndim = len(self.values)
        per = list(self.periodic_mask(ndim))
        neu = self.neumann_mask(ndim)
        for d in dims:
            if not -ndim <= d < ndim:
                raise ValueError(f"periodic dim {d} out of range for "
                                 f"rank {ndim}")
            if neu[d % ndim]:
                raise ValueError(
                    f"dim {d % ndim} is already Neumann; a dim may be "
                    "periodic or Neumann, not both")
            per[d % ndim] = True
        # normalize the all-Dirichlet mask to () so BCs that are
        # semantically equal compare (and hash) equal
        return dataclasses.replace(
            self, periodic=tuple(per) if any(per) else ()
        )

    def with_neumann(self, dims) -> "DirichletBC":
        """This BC with the given dims made zero-flux (mirror) Neumann."""
        ndim = len(self.values)
        neu = list(self.neumann_mask(ndim))
        per = self.periodic_mask(ndim)
        for d in dims:
            if not -ndim <= d < ndim:
                raise ValueError(f"Neumann dim {d} out of range for "
                                 f"rank {ndim}")
            if per[d % ndim]:
                raise ValueError(
                    f"dim {d % ndim} is already periodic; a dim may be "
                    "periodic or Neumann, not both")
            neu[d % ndim] = True
        return dataclasses.replace(
            self, neumann=tuple(neu) if any(neu) else ()
        )

    def periodic_mask(self, ndim: int) -> Tuple[bool, ...]:
        """``periodic`` normalized to length ``ndim``."""
        per = tuple(self.periodic)
        return per + (False,) * (ndim - len(per))

    def neumann_mask(self, ndim: int) -> Tuple[bool, ...]:
        """``neumann`` normalized to length ``ndim``."""
        neu = tuple(self.neumann)
        return neu + (False,) * (ndim - len(neu))

    def dynamic_mask(self, ndim: int) -> Tuple[bool, ...]:
        """Dims whose ghosts hold *current-iterate* data (periodic wrap
        or Neumann mirror) rather than Dirichlet constants."""
        per = self.periodic_mask(ndim)
        neu = self.neumann_mask(ndim)
        return tuple(p or n for p, n in zip(per, neu))

    @property
    def any_periodic(self) -> bool:
        return any(self.periodic)

    @property
    def any_neumann(self) -> bool:
        return any(self.neumann)

    @property
    def any_dynamic(self) -> bool:
        return any(self.periodic) or any(self.neumann)

    def __hash__(self):
        return hash((self.values, self.periodic, self.neumann))


def as_device_array(f, dtype) -> jax.Array:
    """``f`` as a device array of ``dtype`` WITHOUT a host round trip
    when it already is one.

    ``jnp.asarray(np.asarray(f))`` — the obvious spelling — copies a
    ``jax.Array`` to the host and re-uploads it on every call, which
    would dominate repeated-solve timings. Solver entry points take
    their right-hand sides through this instead: device arrays pass
    through (dtype cast stays on device), host data uploads once."""
    if isinstance(f, jax.Array):
        return jnp.asarray(f, dtype)
    return jnp.asarray(np.asarray(f), dtype)


def _face_slices(shape, halo: int, d: int):
    """(lo_ghost, hi_ghost, lo_src, hi_src) index tuples for dim ``d`` of a
    ``halo``-padded array: the two ghost slabs and the two interior bands
    a periodic wrap copies from (hi interior rows -> lo ghosts and vice
    versa). Each slab spans the full extent of the other dims."""
    ndim = len(shape)
    s = shape[d]

    def at(d_slice):
        return tuple(d_slice if i == d else slice(None) for i in range(ndim))

    return (at(slice(0, halo)), at(slice(s - halo, None)),
            at(slice(s - 2 * halo, s - halo)), at(slice(halo, 2 * halo)))


def _check_dynamic_depth(shape, halo: int, d: int, kind: str):
    n = shape[d] - 2 * halo
    if n < halo:
        raise ValueError(
            f"{kind} dim {d} needs interior extent >= halo depth "
            f"({n} < {halo}); shrink the temporal depth or grow the grid"
        )


def _mirror_slices(shape, halo: int, d: int):
    """(lo_src, hi_src) bands whose dim-``d`` FLIP fills the lo/hi ghost
    slabs of a Neumann (zero-flux) dim: ghost layer ``j`` mirrors
    interior layer ``j-1`` across the face plane (``mode='symmetric'``)."""
    ndim = len(shape)
    s = shape[d]

    def at(d_slice):
        return tuple(d_slice if i == d else slice(None) for i in range(ndim))

    return at(slice(halo, 2 * halo)), at(slice(s - 2 * halo, s - halo))


def fill_halo(padded: jax.Array, halo: int, bc: DirichletBC) -> jax.Array:
    """Write BC values into the full halo ring of a padded array.

    Analog of ``BoundaryMatrix::fill_boundary``
    (``boundary_matrix.hpp:129-170``) applied to all four (2D) / six (3D)
    faces. Dirichlet faces are constant slabs spanning the full extent of
    the other dims, later dims overwriting earlier ones in corner regions;
    dynamic dims (periodic wraps, Neumann mirrors) are then filled from
    the interior (see :func:`refresh_dynamic`).
    """
    ndim = padded.ndim
    dyn = bc.dynamic_mask(ndim)
    for d in range(ndim):
        if dyn[d]:
            continue
        lo, hi = bc.values[d]
        idx_lo, idx_hi, _, _ = _face_slices(padded.shape, halo, d)
        padded = padded.at[idx_lo].set(lo)
        padded = padded.at[idx_hi].set(hi)
    return refresh_dynamic(padded, halo, bc)


def refresh_dynamic(padded: jax.Array, halo: int,
                    bc: DirichletBC) -> jax.Array:
    """Re-fill the ghost slabs of dynamic dims: periodic dims by
    wrap-around copy, Neumann dims by mirror (symmetric) copy.

    Unlike Dirichlet ghosts (constants the sweeps never write),
    dynamic ghosts hold data derived from the *current iterate* (the
    opposite face's rows, or the face-adjacent rows reflected), so every
    sweep must refresh them before its taps read the halo. Dims are
    processed in increasing order, each copying the full extent of the
    other dims — corner regions become exactly the doubly-wrapped /
    doubly-mirrored values (the same transitivity as the sharded
    dim-ordered halo exchange, ``parallel/halo.py``).
    No-op for all-Dirichlet BCs.
    """
    ndim = padded.ndim
    per = bc.periodic_mask(ndim)
    neu = bc.neumann_mask(ndim)
    for d in range(ndim):
        if per[d]:
            _check_dynamic_depth(padded.shape, halo, d, "periodic")
            idx_lo, idx_hi, src_lo, src_hi = _face_slices(
                padded.shape, halo, d)
            padded = padded.at[idx_lo].set(padded[src_lo])
            padded = padded.at[idx_hi].set(padded[src_hi])
        elif neu[d]:
            _check_dynamic_depth(padded.shape, halo, d, "Neumann")
            idx_lo, idx_hi, _, _ = _face_slices(padded.shape, halo, d)
            src_lo, src_hi = _mirror_slices(padded.shape, halo, d)
            padded = padded.at[idx_lo].set(jnp.flip(padded[src_lo], axis=d))
            padded = padded.at[idx_hi].set(jnp.flip(padded[src_hi], axis=d))
    return padded


def fill_halo_np(padded: np.ndarray, halo: int, bc: DirichletBC) -> np.ndarray:
    """NumPy twin of :func:`fill_halo` for the float64 golden model."""
    ndim = padded.ndim
    dyn = bc.dynamic_mask(ndim)
    for d in range(ndim):
        if dyn[d]:
            continue
        lo, hi = bc.values[d]
        idx_lo, idx_hi, _, _ = _face_slices(padded.shape, halo, d)
        padded[idx_lo] = lo
        padded[idx_hi] = hi
    return refresh_dynamic_np(padded, halo, bc)


def refresh_dynamic_np(padded: np.ndarray, halo: int,
                       bc: DirichletBC) -> np.ndarray:
    """NumPy twin of :func:`refresh_dynamic` (golden model, per sweep)."""
    ndim = padded.ndim
    per = bc.periodic_mask(ndim)
    neu = bc.neumann_mask(ndim)
    for d in range(ndim):
        if per[d]:
            _check_dynamic_depth(padded.shape, halo, d, "periodic")
            idx_lo, idx_hi, src_lo, src_hi = _face_slices(
                padded.shape, halo, d)
            padded[idx_lo] = padded[src_lo]
            padded[idx_hi] = padded[src_hi]
        elif neu[d]:
            _check_dynamic_depth(padded.shape, halo, d, "Neumann")
            idx_lo, idx_hi, _, _ = _face_slices(padded.shape, halo, d)
            src_lo, src_hi = _mirror_slices(padded.shape, halo, d)
            padded[idx_lo] = np.flip(padded[src_lo], axis=d)
            padded[idx_hi] = np.flip(padded[src_hi], axis=d)
    return padded


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class HaloGrid:
    """A dense grid with a BC-filled halo ring of width ``halo``.

    ``data`` has shape ``interior_shape + 2 * halo`` per dim. The halo ring
    always holds the Dirichlet BC values (the reference applies its BCs to
    *both* ping-pong buffers up front, ``stencil.cpp:199-207``, so they
    survive the swap; we keep the same invariant functionally: every array
    produced by a sweep carries a valid BC ring).
    """

    data: jax.Array
    halo: int
    bc: DirichletBC

    # -- pytree protocol (halo/bc are static aux data) -------------------------
    def tree_flatten(self):
        return (self.data,), (self.halo, self.bc)

    @classmethod
    def tree_unflatten(cls, aux, children):
        halo, bc = aux
        return cls(data=children[0], halo=halo, bc=bc)

    # -- constructors ----------------------------------------------------------
    @staticmethod
    def create(
        interior_shape: Sequence[int],
        halo: int = 1,
        bc: Optional[DirichletBC] = None,
        dtype=jnp.float32,
        interior_value: float = 0.0,
    ) -> "HaloGrid":
        """Interior = ``interior_value`` (reference inits to 0,
        ``stencil.cpp:195-198``), halo = BC values."""
        ndim = len(interior_shape)
        if bc is None:
            bc = DirichletBC.reference_default(ndim)
        padded_shape = tuple(s + 2 * halo for s in interior_shape)
        padded = jnp.full(padded_shape, interior_value, dtype=dtype)
        padded = fill_halo(padded, halo, bc)
        return HaloGrid(data=padded, halo=halo, bc=bc)

    @staticmethod
    def from_interior(
        interior: jax.Array,
        halo: int = 1,
        bc: Optional[DirichletBC] = None,
    ) -> "HaloGrid":
        ndim = interior.ndim
        if bc is None:
            bc = DirichletBC.reference_default(ndim)
        padded = jnp.pad(interior, halo)
        padded = fill_halo(padded, halo, bc)
        return HaloGrid(data=padded, halo=halo, bc=bc)

    # -- accessors ---------------------------------------------------------
    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def interior_shape(self) -> Tuple[int, ...]:
        return tuple(s - 2 * self.halo for s in self.data.shape)

    def interior(self) -> jax.Array:
        """Analog of ``elem_at`` interior addressing
        (``boundary_matrix.hpp:115-118``)."""
        h = self.halo
        idx = tuple(slice(h, s - h) for s in self.data.shape)
        return self.data[idx]

    def with_interior(self, interior: jax.Array) -> "HaloGrid":
        h = self.halo
        idx = tuple(slice(h, s - h) for s in self.data.shape)
        return HaloGrid(
            data=self.data.at[idx].set(interior), halo=h, bc=self.bc
        )

    def with_halo(self, halo: int) -> "HaloGrid":
        """Re-pad to a different halo width; every ghost ring carries the
        BC face value (or the wrap/mirror of the interior)."""
        if halo == self.halo:
            return self
        padded = jnp.pad(self.interior(), halo)
        return HaloGrid(data=fill_halo(padded, halo, self.bc), halo=halo,
                        bc=self.bc)
