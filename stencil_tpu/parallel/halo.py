"""Multi-chip halo exchange: ``shard_map`` + ``ppermute`` over the device
mesh.

JAX re-design of the reference's RMA kernel
(``/root/reference/src/stencil/slave/stencil_rma.cpp``), which pushes edge
strips scratchpad-to-scratchpad over the 8x8 CPE mesh:

  =====================================  =====================================
  reference (Sunway athread RMA)         here (JAX over the device mesh)
  =====================================  =====================================
  ``athread_rma_iput`` to mesh neighbor  ``jax.lax.ppermute`` (NCCL)
  target CPE id ``row*8+col``            named mesh axes + ``axis_index``
  edge CPEs synthesize Dirichlet halo    mesh-edge devices ``where`` in BC
    (``generate_boundary``, :150-166)      face values (ppermute yields zeros
                                           at ring ends — exactly the hook)
  double-buffered reply counters         XLA dataflow: the permute for step
    pipelining iterations (:333-361)       i+1 can overlap step i's interior
                                           compute (no barrier semantics)
  per-CPE ``block_subview`` tiles        ``shard_map`` PartitionSpec blocks
  "multiple rounds" for big grids        arbitrary per-device block sizes
    (documented, never implemented,        fall out of the sharding — no
    ``program_options.hpp:11-14``)         round logic needed
  =====================================  =====================================

Corner/diagonal neighbors (needed by box stencils) are handled by exchanging
dims in order: the strips exchanged along dim d+1 already contain the halo
received along dim d, so corners ride along — no explicit diagonal sends
(the reference never solved this; its RMA kernel is radius-1 star only).

Periodic dims (``bc.periodic``, a beyond-reference capability) fall out
of the same machinery: a periodic SHARDED dim replaces the open
permutation chain with the circular one (``(i, (i±1) % n)``) — the ring
topology ``ppermute`` natively expresses — and drops the mesh-edge BC
synthesis; a periodic unsharded dim uses the block's own opposite-edge
strips as ghosts. Neumann dims
(``bc.neumann``, zero-flux mirror) keep the OPEN chain: mesh-edge
devices synthesize their ghosts by mirroring their own edge strips — a
purely local operation, exactly like Dirichlet synthesis but
data-dependent; unsharded Neumann dims mirror in place.

``overlap=True`` splits each sweep into an interior region that depends only
on local data and a boundary band that waits on the received halos, giving
XLA's latency-hiding scheduler room to overlap ppermute with interior
compute — the analog of the reference's interior-first ordering
(``stencil_rma.cpp:338-360``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from stencil_tpu.core.grid import DirichletBC, HaloGrid
from stencil_tpu.core.spec import StencilSpec
from stencil_tpu.ops.xla import apply_spec


@functools.lru_cache(maxsize=64)
def _sharded_iterate_fn(method: "ShardedStencil", mesh: Mesh,
                        bc: DirichletBC):
    """One executable serves every iteration count (the count is a traced
    fori_loop bound) — a static count would recompile the whole shard_map
    for each n the benchmark autoranger probes."""
    pspec = method.partition_spec()

    def device_fn(block, n):
        def body(_, b):
            return method._local_sweep(b, bc)

        return lax.fori_loop(0, n, body, block)

    mapped = jax.shard_map(
        device_fn, mesh=mesh, in_specs=(pspec, P()), out_specs=pspec
    )
    return jax.jit(mapped)


def make_mesh(
    axis_sizes: Sequence[int],
    axis_names: Optional[Sequence[str]] = None,
    devices=None,
) -> Mesh:
    """Build a Mesh from axis sizes (row-major over ``jax.devices()``)."""
    if axis_names is None:
        axis_names = tuple(f"d{i}" for i in range(len(axis_sizes)))
    if devices is None:
        devices = jax.devices()
    n = int(np.prod(axis_sizes))
    if n > len(devices):
        raise ValueError(
            f"mesh wants {n} devices, only {len(devices)} available"
        )
    arr = np.array(devices[:n]).reshape(tuple(axis_sizes))
    return Mesh(arr, tuple(axis_names))


def _dim_halos(
    x: jax.Array,
    dim: int,
    axis_name: Optional[str],
    r: int,
    bc_lo: float,
    bc_hi: float,
    periodic: bool = False,
    neumann: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Ghost layers (lo_halo, hi_halo), each r thick along ``dim``.

    If ``axis_name`` is None the dim is not sharded: ghosts are the BC
    faces — or, for a periodic dim, the block's own opposite-edge
    strips; for a Neumann dim, the block's own edge strips MIRRORED
    (zero-flux reflection). Otherwise edge strips are pushed to mesh
    neighbors with ppermute (push model, like the reference's rma_iput):
    Dirichlet dims use an open permutation chain and mesh-edge devices
    synthesize the BC locally (``generate_boundary`` analog) — Neumann
    mesh-edge devices mirror their OWN edge strips, a purely local
    synthesis like Dirichlet's; periodic dims use the CIRCULAR
    permutation — the wrap-around IS the ring topology ppermute natively
    expresses, so the periodic capability costs nothing extra on the
    wire.
    """
    ndim = x.ndim

    def face(value):
        shape = tuple(r if d == dim else x.shape[d] for d in range(ndim))
        return jnp.full(shape, value, x.dtype)

    lo_strip = lax.slice_in_dim(x, 0, r, axis=dim)
    hi_strip = lax.slice_in_dim(x, x.shape[dim] - r, x.shape[dim], axis=dim)
    if axis_name is None:
        if periodic:
            return hi_strip, lo_strip
        if neumann:
            return jnp.flip(lo_strip, axis=dim), jnp.flip(hi_strip, axis=dim)
        return face(bc_lo), face(bc_hi)
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    if periodic:
        hi_halo = lax.ppermute(
            lo_strip, axis_name, [(i, (i - 1) % n) for i in range(n)]
        )
        lo_halo = lax.ppermute(
            hi_strip, axis_name, [(i, (i + 1) % n) for i in range(n)]
        )
        return lo_halo, hi_halo
    # my low strip -> previous device's high halo
    hi_halo = lax.ppermute(
        lo_strip, axis_name, [(i, i - 1) for i in range(1, n)]
    )
    # my high strip -> next device's low halo
    lo_halo = lax.ppermute(
        hi_strip, axis_name, [(i, i + 1) for i in range(n - 1)]
    )
    if neumann:
        lo_halo = jnp.where(idx == 0, jnp.flip(lo_strip, axis=dim), lo_halo)
        hi_halo = jnp.where(idx == n - 1, jnp.flip(hi_strip, axis=dim),
                            hi_halo)
    else:
        lo_halo = jnp.where(idx == 0, face(bc_lo), lo_halo)
        hi_halo = jnp.where(idx == n - 1, face(bc_hi), hi_halo)
    return lo_halo, hi_halo


def _exchange_dim(
    x: jax.Array,
    dim: int,
    axis_name: Optional[str],
    r: int,
    bc_lo: float,
    bc_hi: float,
    periodic: bool = False,
    neumann: bool = False,
) -> jax.Array:
    """Extend ``x`` by r ghost layers on both sides of ``dim``."""
    lo_halo, hi_halo = _dim_halos(x, dim, axis_name, r, bc_lo, bc_hi,
                                  periodic, neumann)
    return jnp.concatenate([lo_halo, x, hi_halo], axis=dim)


@dataclasses.dataclass(frozen=True)
class ShardedStencil:
    """Distributed Jacobi iteration over a named device mesh.

    ``axis_names[d]`` names the mesh axis sharding grid dim d (None = not
    sharded). The inner per-device sweep is the fused-slice XLA sweep; the
    halo ring moves between devices each sweep.
    """

    spec: StencilSpec
    axis_names: Tuple[Optional[str], ...]
    overlap: bool = True

    def partition_spec(self) -> P:
        return P(*self.axis_names)

    # ---- one local step (runs inside shard_map) ---------------------------

    def _local_sweep(self, block: jax.Array, bc: DirichletBC) -> jax.Array:
        r = self.spec.radius
        n0 = block.shape[0]
        per = bc.periodic_mask(self.spec.ndim)
        neu = bc.neumann_mask(self.spec.ndim)
        if not self.overlap or self.axis_names[0] is None or n0 < 4 * r:
            ext = block
            for d in range(self.spec.ndim):
                lo, hi = bc.values[d]
                ext = _exchange_dim(ext, d, self.axis_names[d], r, lo, hi,
                                    per[d], neu[d])
            return apply_spec(ext, self.spec)

        # Overlapped variant (interior-first, like stencil_rma.cpp:338-360):
        # exchange minor dims synchronously, start the dim-0 permute, compute
        # the interior band from purely-local data while it is in flight,
        # then finish the two r-thick boundary bands.
        ext1 = block
        for d in range(1, self.spec.ndim):
            lo, hi = bc.values[d]
            ext1 = _exchange_dim(ext1, d, self.axis_names[d], r, lo, hi,
                                 per[d], neu[d])
        lo0, hi0 = bc.values[0]
        lo_halo, hi_halo = _dim_halos(
            ext1, 0, self.axis_names[0], r, lo0, hi0, per[0], neu[0]
        )
        # Corner fix: where THIS device sits on a physical minor boundary,
        # the minor-ghost cells of the dim-0 halos must hold the minor-dim
        # face values (later dims win in corners — the non-overlap path gets
        # this for free from its exchange order). Devices in the minor
        # interior received correct diagonal data via ppermute and are left
        # untouched.
        for d in range(1, self.spec.ndim):
            if per[d] or neu[d]:
                # dynamic (periodic/Neumann) minor dims need NO corner
                # fix: the dim-0 strips were cut from ext1 AFTER its
                # wrapped/mirrored minor extension, so the halos already
                # carry the neighbor's dynamic minor ghosts — exactly
                # the values the exchange-in-dim-order (non-overlap)
                # path produces transitively.
                continue
            lo_d, hi_d = bc.values[d]
            name = self.axis_names[d]
            if name is None:
                lo_edge = hi_edge = jnp.bool_(True)
            else:
                di = lax.axis_index(name)
                lo_edge = di == 0
                hi_edge = di == lax.axis_size(name) - 1
            for h_idx, halo in enumerate((lo_halo, hi_halo)):
                size_d = halo.shape[d]
                pos = lax.broadcasted_iota(jnp.int32, halo.shape, d)
                halo = jnp.where((pos < r) & lo_edge, jnp.asarray(lo_d, halo.dtype), halo)
                halo = jnp.where((pos >= size_d - r) & hi_edge,
                                 jnp.asarray(hi_d, halo.dtype), halo)
                if h_idx == 0:
                    lo_halo = halo
                else:
                    hi_halo = halo
        # interior: out rows [r, n0 - r) read only local rows [0, n0) — no
        # dependence on the permute results, so XLA can overlap.
        inner = apply_spec(ext1, self.spec)
        # lo band: out rows [0, r) read rows [-r, 2r)
        lo_src = jnp.concatenate(
            [lo_halo, lax.slice_in_dim(ext1, 0, 2 * r, axis=0)], axis=0
        )
        lo_band = apply_spec(lo_src, self.spec)
        # hi band: out rows [n0 - r, n0) read rows [n0 - 2r, n0 + r)
        hi_src = jnp.concatenate(
            [lax.slice_in_dim(ext1, n0 - 2 * r, n0, axis=0), hi_halo], axis=0
        )
        hi_band = apply_spec(hi_src, self.spec)
        return jnp.concatenate([lo_band, inner, hi_band], axis=0)

    # ---- public API --------------------------------------------------------

    def iterate_fn(self, mesh: Mesh, bc: DirichletBC):
        """Jitted (global array, n) -> global array iteration function.

        Cached per (self, mesh, bc): rebuilding the jit closure per call
        would re-trace every time; the iteration count is traced.
        """
        return _sharded_iterate_fn(self, mesh, bc)

    def __hash__(self):
        return hash((self.spec, self.axis_names, self.overlap))

    def iterate(self, grid: HaloGrid, iterations: int, mesh: Mesh) -> HaloGrid:
        interior = grid.interior()
        for d, name in enumerate(self.axis_names):
            if name is not None and interior.shape[d] % mesh.shape[name] != 0:
                raise ValueError(
                    f"dim {d} ({interior.shape[d]}) not divisible by mesh "
                    f"axis {name!r} ({mesh.shape[name]})"
                )
        sharding = NamedSharding(mesh, self.partition_spec())
        interior = jax.device_put(interior, sharding)
        out = self.iterate_fn(mesh, grid.bc)(interior, jnp.int32(iterations))
        return HaloGrid.from_interior(out, halo=grid.halo, bc=grid.bc)
