"""Out-of-core streaming: grids larger than device memory.

The host (RAM) holds the full iterate; the device sweeps it one
d0-chunk at a time with the XLA sweep (``ops/xla.py:apply_spec``). Per
outer step (``k`` sweeps), every chunk is padded host-side with
``k*r``-deep d0 ghost rows taken from the PREVIOUS outer iterate —
neighbor-chunk rows on chunk-internal faces, the global BC at physical
faces (Dirichlet constants, periodic wrap, or Neumann mirror) — and an
``r``-deep BC ring on the other dims, then uploaded and swept ``k`` times
in ONE jitted call. Each sweep recomputes every row but the outermost
``r`` of the chunk buffer (a trapezoid: the stale outer rows corrupt at
most ``r`` more rows per sweep, never the chunk's own ``k*r``-deep
core) and keeps Dirichlet ghost rows of physical d0 faces pinned; the
other dims' dynamic ghosts are refreshed after every sweep. Its interior
core is fetched back into the ping-pong destination buffer. Chunks
within one outer step all read the source buffer, so the schedule is
iteration-order exact: the result matches the in-core ``xla`` method.

Upload/compute overlap: chunk ``c+1`` is padded, uploaded, and its step
dispatched BEFORE chunk ``c``'s result is fetched (JAX dispatch is
asynchronous), so the device computes chunk ``c+1`` while the host
round-trips chunk ``c``. Peak device footprint is bounded by ~5 padded
chunk buffers (input and output of two in-flight chunks plus one fetched
core), which is what the auto-chunking budget provisions for.

Analog: the reference DOCUMENTS this capability as "multiple rounds"
for matrices exceeding one round's memory but never implements it —
``/root/reference/include/stencil/program_options.hpp:11-14``
("Currently we only support data of one round."). Here it is
implemented, differential-tested against both golden models, and sized
from the device's reported memory limit (``platform.device_memory_bytes``).

Correctness constraints (each raised eagerly with guidance):

- every chunk must be at least ``k*r`` planes deep when chunked: its
  ghost rows come from the neighbor chunks only;
- a dynamic (periodic/Neumann) d0 needs interior extent >= ``k*r``, and
  a Neumann d0 at ``k>1`` needs the stencil mirror-symmetric in d0 (the
  host seeds ``k*r`` mirror rows once per outer step; only a symmetric
  sweep keeps them the mirror of the evolving rows).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np

from stencil_tpu.core.grid import DirichletBC, HaloGrid, fill_halo_np
from stencil_tpu.core.spec import StencilSpec


def host_halo_grid(
    interior_shape,
    halo: int = 1,
    bc: Optional[DirichletBC] = None,
    dtype="float32",
    interior=None,
) -> HaloGrid:
    """A HaloGrid whose ``data`` is a host NumPy array — the entry point
    for grids exceeding device memory (``HaloGrid.create`` would allocate
    on device). Same initial conditions: interior 0 (or the given
    array), halo = BC values (``fill_halo_np``)."""
    ndim = len(interior_shape)
    if bc is None:
        bc = DirichletBC.reference_default(ndim)
    if interior is None:
        interior = np.zeros(tuple(interior_shape), np.dtype(dtype))
    else:
        interior = np.asarray(interior, np.dtype(dtype))
    padded = np.pad(interior, halo)
    padded = fill_halo_np(padded, halo, bc)
    return HaloGrid(data=padded, halo=halo, bc=bc)


def _chunk_bounds(n0: int, chunks: int) -> Tuple[Tuple[int, int], ...]:
    """Near-equal chunk extents along d0 (first ``n0 % chunks`` chunks
    one plane deeper)."""
    base, extra = divmod(n0, chunks)
    bounds = []
    start = 0
    for c in range(chunks):
        stop = start + base + (1 if c < extra else 0)
        bounds.append((start, stop))
        start = stop
    return tuple(bounds)


def auto_chunks(spec: StencilSpec, interior_shape, dtype, sweeps_per_call,
                device_bytes: Optional[int] = None) -> int:
    """Smallest chunk count whose in-flight device footprint (~5 padded
    chunk buffers, see module docstring) fits a conservative share of
    the device's memory limit (``device_bytes``, default: what the
    device reports; a device that reports none is an error)."""
    from stencil_tpu import platform

    if device_bytes is None:
        device_bytes = platform.device_memory_bytes()
    if device_bytes is None:
        raise ValueError(
            "the device reports no memory limit to size chunks from; "
            "pass --chunks (or set STENCIL_TPU_HBM_MB)")
    n0 = interior_shape[0]
    r = spec.radius
    kr = sweeps_per_call * r
    itemsize = np.dtype(dtype).itemsize
    plane = int(np.prod([n + 2 * r for n in interior_shape[1:]]))
    cap = int(0.4 * device_bytes) // 5

    def chunk_bytes(c: int) -> int:
        b0 = -(-n0 // c)
        return (b0 + 2 * kr) * plane * itemsize

    c = 1
    while chunk_bytes(c) > cap:
        c += 1
        if c > n0 or (c > 1 and n0 // c < max(kr, 1)):
            raise ValueError(
                f"grid {tuple(interior_shape)} ({dtype}) cannot be "
                f"streamed at k={sweeps_per_call}: even {c - 1} chunks "
                f"exceed the device budget ({cap / 2**20:.2f} MiB/chunk) "
                f"while chunks must stay >= k*r = {kr} planes; reduce -k "
                "or the grid")
    return c


def _other_dims_bc(bc: DirichletBC, ndim: int) -> DirichletBC:
    """``bc`` with d0 made Dirichlet: the per-sweep ghost refresh of a
    chunk covers the other dims only (its d0 ghosts are neighbor rows)."""
    per = bc.periodic_mask(ndim)
    neu = bc.neumann_mask(ndim)
    out = DirichletBC(values=bc.values)
    rest_p = tuple(d for d in range(1, ndim) if per[d])
    rest_n = tuple(d for d in range(1, ndim) if neu[d])
    if rest_p:
        out = out.with_periodic(rest_p)
    if rest_n:
        out = out.with_neumann(rest_n)
    return out


@functools.lru_cache(maxsize=64)
def _cached_chunk_step(spec: StencilSpec, k: int, kr: int,
                       bc: DirichletBC):
    """Jitted chunk step: ``k`` sweeps on a padded chunk buffer (d0 ghosts
    ``kr`` deep, other dims ``r`` deep), returning only the interior core.
    ``pins = (lo, hi)`` (runtime, so one executable serves every chunk of
    a shape) keeps the d0 ghost rows of a physical Dirichlet face
    constant."""
    import jax
    import jax.numpy as jnp

    from stencil_tpu.core.grid import refresh_dynamic
    from stencil_tpu.ops.xla import apply_spec

    r = spec.radius
    rest_bc = _other_dims_bc(bc, spec.ndim)

    @jax.jit
    def step(buf, pins):
        inner = tuple(slice(r, s - r) for s in buf.shape)
        rows = jnp.arange(r, buf.shape[0] - r)
        pinned = (((rows < kr) & (pins[0] == 1))
                  | ((rows >= buf.shape[0] - kr) & (pins[1] == 1)))
        pinned = pinned.reshape((-1,) + (1,) * (buf.ndim - 1))
        for _ in range(k):
            new = apply_spec(buf, spec, halo=r)
            buf = buf.at[inner].set(jnp.where(pinned, buf[inner], new))
            if rest_bc.any_dynamic:
                buf = refresh_dynamic(buf, r, rest_bc)
        core = (slice(kr, buf.shape[0] - kr),) + inner[1:]
        return buf[core]

    return step


class StreamedStencil:
    """Out-of-core d0-chunked iteration driver (host-resident iterate).

    ``chunks=None`` sizes the chunk count from the device's memory limit;
    an explicit count forces it (tests stream tiny grids in 3 chunks).
    """

    def __init__(self, spec: StencilSpec, interior_shape, dtype="float32",
                 sweeps_per_call: int = 1, chunks: Optional[int] = None):
        if spec.ndim != 3 or len(interior_shape) != 3:
            raise ValueError(
                "streamed method is 3D-only; 2D grids fit the device "
                "in-core")
        self.spec = spec
        self.interior_shape = tuple(int(s) for s in interior_shape)
        self.dtype = str(np.dtype(dtype))
        self.k = int(sweeps_per_call)
        if self.k < 1:
            raise ValueError(f"sweeps_per_call must be >= 1, got {self.k}")
        n0 = self.interior_shape[0]
        if chunks is None:
            chunks = auto_chunks(spec, self.interior_shape, self.dtype,
                                 self.k)
        chunks = int(chunks)
        if chunks < 1 or chunks > n0:
            raise ValueError(f"chunks={chunks} out of range [1, {n0}]")
        kr = self.k * spec.radius
        if chunks > 1 and n0 // chunks < kr:
            raise ValueError(
                f"chunk depth {n0 // chunks} < k*r = {kr}: a chunk's "
                "ghost rows must come from its neighbor chunks; use "
                "fewer chunks or a shallower -k"
            )
        self.num_chunks = chunks
        self.bounds = _chunk_bounds(n0, chunks)

    # -- host-side chunk padding ------------------------------------------

    def _pad_chunk(self, host: np.ndarray, ci: int, kr: int,
                   bc: DirichletBC) -> np.ndarray:
        """Chunk ``ci`` padded ``kr`` deep along d0 and ``r`` deep along
        the other dims. Fill order replicates ``fill_halo``: interior,
        then per-dim constant slabs in increasing dim order (later dims
        win in corners), then the d0 ghost rows seeded from the previous
        outer iterate (``host``) — neighbor-chunk rows on chunk-internal
        faces, wrap/mirror images on dynamic global faces, face
        constants on physical Dirichlet faces — then the other dims'
        dynamic rings over the full d0 extent, so corner ghosts carry the
        same wrapped/mirrored values as the in-core grid."""
        start, stop = self.bounds[ci]
        r = self.spec.radius
        n0 = self.interior_shape[0]
        c0 = stop - start
        ndim = len(self.interior_shape)
        per = bc.periodic_mask(ndim)
        neu = bc.neumann_mask(ndim)
        pads = [kr] + [r] * (ndim - 1)
        shape = tuple(n + 2 * p for n, p in
                      zip((c0,) + self.interior_shape[1:], pads))
        inner = tuple(slice(p, s - p) for p, s in zip(pads, shape))

        out = np.empty(shape, np.dtype(self.dtype))
        out[(slice(kr, kr + c0),) + inner[1:]] = host[start:stop]
        for d in range(ndim):
            lo = tuple(slice(0, pads[d]) if e == d else slice(None)
                       for e in range(ndim))
            hi = tuple(slice(shape[d] - pads[d], None) if e == d
                       else slice(None) for e in range(ndim))
            out[lo] = bc.values[d][0]
            out[hi] = bc.values[d][1]

        def src_index(gi: int) -> Optional[int]:
            if 0 <= gi < n0:
                return gi
            if per[0]:
                return gi % n0
            if neu[0]:
                return -gi - 1 if gi < 0 else 2 * n0 - 1 - gi
            return None  # physical Dirichlet face: keep the constant

        for j in range(kr):
            si = src_index(start - kr + j)
            if si is not None:
                out[(j,) + inner[1:]] = host[si]
            si = src_index(stop + j)
            if si is not None:
                out[(kr + c0 + j,) + inner[1:]] = host[si]

        from stencil_tpu.core.grid import refresh_dynamic_np

        rest_bc = _other_dims_bc(bc, ndim)
        if rest_bc.any_dynamic:
            refresh_dynamic_np(out, r, rest_bc)
        return out

    def _pins(self, ci: int, bc: DirichletBC) -> np.ndarray:
        """(lo, hi) d0 pins of chunk ``ci``: 1 on a physical Dirichlet
        face, 0 on chunk-internal faces and on a dynamic d0 (their ghost
        rows hold live data)."""
        dyn0 = bc.dynamic_mask(3)[0]
        lo = 0 if (dyn0 or ci > 0) else 1
        hi = 0 if (dyn0 or ci < self.num_chunks - 1) else 1
        return np.asarray([lo, hi], np.int32)

    def _validate_bc(self, bc: DirichletBC, k: int) -> None:
        per = bc.periodic_mask(3)
        neu = bc.neumann_mask(3)
        kr = k * self.spec.radius
        problems = []
        if k > 1 and neu[0] and not self.spec.symmetric_in(0):
            problems.append(
                "a Neumann d0 at sweeps_per_call>1 needs the stencil "
                "mirror-symmetric in dim 0 (use -k 1 for asymmetric "
                "taps)")
        if (per[0] or neu[0]) and self.interior_shape[0] < kr:
            problems.append(
                f"dynamic dim 0 needs interior extent >= k*r "
                f"({self.interior_shape[0]} < {kr})")
        if problems:
            raise ValueError(
                "periodic/Neumann BCs on the streamed method: "
                + "; ".join(problems))

    # -- iteration ----------------------------------------------------------

    def _outer_step(self, src: np.ndarray, dst: np.ndarray, k: int,
                    bc: DirichletBC) -> None:
        """One outer step (k sweeps) over all chunks, dispatching chunk
        c+1's upload and step before fetching chunk c's result."""
        import jax

        kr = k * self.spec.radius
        step = _cached_chunk_step(self.spec, k, kr, bc)

        def launch(ci: int):
            buf = jax.device_put(self._pad_chunk(src, ci, kr, bc))
            return step(buf, self._pins(ci, bc))

        pending = launch(0)
        for ci in range(self.num_chunks):
            nxt = launch(ci + 1) if ci + 1 < self.num_chunks else None
            start, stop = self.bounds[ci]
            dst[start:stop] = np.asarray(pending)
            pending = nxt

    def iterate_host(self, x0: np.ndarray, iterations: int,
                     bc: Optional[DirichletBC] = None) -> np.ndarray:
        """Run ``iterations`` sweeps on a host-resident interior array;
        returns the new host interior. Remainder sweeps (``iterations %
        k``) run as one shallower outer step."""
        if bc is None:
            bc = DirichletBC.reference_default(3)
        x0 = np.asarray(x0)
        if x0.shape != self.interior_shape:
            raise ValueError(
                f"interior shape {x0.shape} != plan shape "
                f"{self.interior_shape}")
        self._validate_bc(bc, self.k)
        src = np.array(x0, np.dtype(self.dtype), copy=True)
        dst = np.empty_like(src)
        n_outer, rem = divmod(int(iterations), self.k)
        for _ in range(n_outer):
            self._outer_step(src, dst, self.k, bc)
            src, dst = dst, src
        if rem:
            self._outer_step(src, dst, rem, bc)
            src, dst = dst, src
        return src

    def iterate(self, grid: HaloGrid, iterations: int) -> HaloGrid:
        """Registry/CLI adapter: HaloGrid in (host or device), host
        HaloGrid out (never allocates the full grid on device)."""
        if np.dtype(str(grid.dtype)) != np.dtype(self.dtype):
            raise ValueError(
                f"grid dtype {grid.dtype} != plan dtype {self.dtype}")
        out = self.iterate_host(np.asarray(grid.interior()), iterations,
                                bc=grid.bc)
        return host_halo_grid(self.interior_shape, halo=grid.halo,
                              bc=grid.bc, dtype=self.dtype, interior=out)
