"""Method registry: name -> iterate implementation.

Analog of the reference's method-name map (``stencil.cpp:61-66``:
``{DMA, DMAStaticUnroll, DMASlavePack, RMA}``). The method families and
their reference counterparts:

  ``xla``              pure-XLA fused-slice sweep — no reference analog
                       (the baseline every hand-written kernel must beat)
  ``sharded``          shard_map + ppermute halo exchange over the device
                       mesh ≙ RMA core-to-core push (``stencil_rma.cpp``),
                       with interior-first overlap ≙ its pipeline
  ``sharded_noverlap`` same without the interior/boundary split (≙ DMA-family
                       per-iteration barrier semantics)
  ``streamed``         out-of-core: a host-resident grid swept one d0 chunk
                       at a time (the reference's documented, never
                       implemented "multiple rounds")
  ``varcoeff``         variable-coefficient diffusion marching

Each entry is a factory ``(config, spec, grid) -> Runner`` where a Runner
has ``iterate(grid, n) -> HaloGrid``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import jax

from stencil_tpu.core.grid import HaloGrid
from stencil_tpu.core.spec import StencilSpec


@dataclasses.dataclass
class Runner:
    name: str
    iterate: Callable[[HaloGrid, int], HaloGrid]
    description: str = ""
    # benchmark protocol hints: iteration counts that are multiples of
    # `granularity` avoid compiling remainder steps inside timed regions
    granularity: int = 1
    # what the runner was built with (chunking, solver levels, ...),
    # recorded into the CLI JSON
    plan_info: dict = dataclasses.field(default_factory=dict)
    # optional method-specific golden model for -c: (x0_f64, iters, bc)
    # -> interior_f64. Methods whose update the SPEC golden cannot
    # represent (per-point tap fields: 'varcoeff') provide one; the
    # driver prefers it over the spec golden (NumPy — the driver caps
    # iterations like the spec fallback and warns).
    golden_fn: object = None


def make_xla(config, spec: StencilSpec, grid: HaloGrid) -> Runner:
    import jax.numpy as jnp

    from stencil_tpu.ops import xla

    # dynamic iteration count: one executable serves every n (the sweep
    # harness varies n over orders of magnitude, SURVEY §7 hard part (e))
    return Runner(
        name="xla",
        iterate=lambda g, n: xla.iterate_dynamic(g, spec, jnp.int32(n)),
        description="pure-XLA fused-slice sweep (baseline)",
    )


def _make_sharded(config, spec, grid, overlap: bool) -> Runner:
    from stencil_tpu.parallel.halo import ShardedStencil, make_mesh

    mesh_sizes = tuple(config.mesh) if config is not None and config.mesh else None
    if mesh_sizes is None:
        n = len(jax.devices())
        mesh_sizes = (n,)
    axis_names = []
    names = iter(("x", "y", "z"))
    for d in range(spec.ndim):
        if d < len(mesh_sizes) and mesh_sizes[d] > 1:
            axis_names.append(next(names))
        else:
            axis_names.append(None)
    mesh = make_mesh(
        [s for s in mesh_sizes if s > 1],
        [n for n in axis_names if n is not None],
    )
    method = ShardedStencil(spec, tuple(axis_names), overlap=overlap)
    return Runner(
        name="sharded" if overlap else "sharded_noverlap",
        iterate=lambda g, n: method.iterate(g, n, mesh),
        description=(
            "shard_map + ppermute halo exchange over the device mesh"
            + (" (interior-first overlap)" if overlap else "")
        ),
    )


def make_sharded(config, spec, grid) -> Runner:
    # --no-overlap switches off the interior-first comm/compute overlap
    # (kept as the separate `sharded_noverlap` method name too, matching
    # the reference's habit of naming variants as methods)
    overlap = not (config is not None and config.no_overlap)
    return _make_sharded(config, spec, grid, overlap)


def make_sharded_noverlap(config, spec, grid) -> Runner:
    return _make_sharded(config, spec, grid, False)


def make_streamed(config, spec, grid) -> Runner:
    """Out-of-core host-streamed iteration: grids larger than device
    memory, swept one d0 chunk at a time by the XLA sweep with k*r-deep
    host-seeded ghosts (the reference documents this as "multiple
    rounds" and never implements it, ``program_options.hpp:11-14``).
    ``--chunks`` forces the chunk count; the default sizes it from the
    device's reported memory limit."""
    from stencil_tpu.streaming import StreamedStencil

    k = config.temporal if config is not None and config.temporal > 1 else 1
    method = StreamedStencil(
        spec,
        grid.interior_shape,
        dtype=str(grid.dtype),
        sweeps_per_call=k,
        chunks=getattr(config, "chunks", None),
    )
    return Runner(
        name=f"streamed(C={method.num_chunks},k={k})",
        iterate=method.iterate,
        description=(
            "out-of-core host-resident grid swept one d0 chunk at a time "
            "by the XLA sweep (k*r-deep host-seeded ghosts)"
        ),
        granularity=k,
        plan_info={
            "kernel": "streamed", "chunks": method.num_chunks,
            "chunk_planes": [b - a for a, b in method.bounds], "k": k,
        },
    )


def make_varcoeff(config, spec: StencilSpec, grid: HaloGrid) -> Runner:
    """Variable-coefficient (heterogeneous) FTCS diffusion marching —
    the model family behind ``--solve hetero``, exposed as an ITERATE
    method so the per-point-weight XLA sweep is CLI-benchmarkable like
    every other method. The coefficient field
    is the deterministic two-material a(x) with ratio ``--contrast``
    (same field ``--solve hetero`` uses); the requested spec must be
    the radius-1 star the scheme discretizes (jacobi5/7 by rank).
    ``-c`` checks against the float64 FIELD golden model via the
    runner's ``golden_fn`` hook (``ops.golden.golden_iterate_fields``;
    the native spec golden cannot represent per-point taps)."""
    from stencil_tpu.models.diffusion import (
        HeterogeneousDiffusion, two_material,
    )
    from stencil_tpu.ops import golden as golden_mod

    if spec.name not in ("jacobi5", "jacobi7"):
        raise ValueError(
            "varcoeff discretizes the radius-1 star; run it with "
            "--spec jacobi5 (2D) or jacobi7 (3D)")
    contrast = float(getattr(config, "contrast", 100.0) or 100.0)
    if contrast < 1.0:
        raise ValueError(f"--contrast must be >= 1 (got {contrast})")
    a = two_material(tuple(config.size), lo=1.0 / contrast, hi=1.0,
                     seed=0)
    het = HeterogeneousDiffusion(shape=tuple(config.size), a=a,
                                 bc=grid.bc, dtype=config.dtype)
    runner = het.runner()
    offsets, fields = het.tap_fields()

    def golden_fn(x0, iters, bc):
        return golden_mod.golden_iterate_fields(x0, offsets, fields,
                                                iters, bc=bc)

    runner.plan_info["contrast"] = contrast
    runner.golden_fn = golden_fn
    return runner


REGISTRY: Dict[str, Callable] = {
    "xla": make_xla,
    "sharded": make_sharded,
    "sharded_noverlap": make_sharded_noverlap,
    "streamed": make_streamed,
    "varcoeff": make_varcoeff,
}

# Dynamic BCs — periodic (wrap-around) and Neumann (zero-flux mirror)
# dims, capability extensions beyond the Dirichlet-only reference
# (stencil.cpp:190-207) — are accepted by every method: the XLA sweeps
# refresh the wrap/mirror ghosts after each sweep, sharded takes periodic
# as the circular permutation and Neumann as local mirror synthesis on
# mesh-edge devices, streamed seeds k*r-deep wrap/mirror rows per chunk.


def get_runner(name: str, config, spec: StencilSpec, grid: HaloGrid) -> Runner:
    try:
        factory = REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown method {name!r}; available: {sorted(REGISTRY)}"
        ) from None
    return factory(config, spec, grid)
