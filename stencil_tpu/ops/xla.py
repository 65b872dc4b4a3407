"""Pure-XLA stencil sweep: the baseline "let the compiler do it" method.

This is the JAX-idiomatic expression of the reference's computation with no
hand-written kernel at all — shifted static slices summed elementwise, the
time loop as ``lax.fori_loop`` with functional ping-pong (the analog of the
reference's buffer swap, ``stencil_dma.cpp:556-557``). XLA fuses the tap
accumulation into a single pass; this is the method any hand-written kernel
must beat, and the inner compute reused by the sharded and streamed paths.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from stencil_tpu.core.grid import HaloGrid, refresh_dynamic
from stencil_tpu.core.spec import StencilSpec


def apply_spec(padded: jax.Array, spec: StencilSpec,
               halo: int | None = None) -> jax.Array:
    """One sweep over a padded array; returns the new interior.

    Tap accumulation follows the spec's canonical order; uniform-weight specs
    sum first and multiply once (matches reference arithmetic,
    ``stencil.cpp:85-125``).
    """
    r = spec.radius if halo is None else halo
    ndim = padded.ndim
    interior_shape = tuple(s - 2 * r for s in padded.shape)
    uw = spec.uniform_weight
    dtype = padded.dtype
    acc = None
    # one multiply per distinct weight (12-tap/2-weight high-order
    # stencils pay 2 multiplies, not 12)
    for w, offs in spec.weight_groups():
        gacc = None
        for off in offs:
            start = tuple(r + off[d] for d in range(ndim))
            limit = tuple(start[d] + interior_shape[d] for d in range(ndim))
            tap = lax.slice(padded, start, limit)
            gacc = tap if gacc is None else gacc + tap
        term = gacc if uw is not None else gacc * jnp.asarray(w, dtype)
        acc = term if acc is None else acc + term
    if uw is not None:
        acc = acc * jnp.asarray(uw, dtype)
    return acc


def sweep(grid: HaloGrid, spec: StencilSpec) -> HaloGrid:
    """One full sweep: new interior computed, BC ring preserved.

    Dirichlet ghosts are constants and survive ``with_interior``
    untouched; dynamic ghosts (periodic wraps, Neumann mirrors) must be
    refreshed from the new interior (XLA fuses the small edge copies
    into the sweep)."""
    new_interior = apply_spec(grid.data, spec, halo=grid.halo)
    out = grid.with_interior(new_interior)
    if grid.bc.any_dynamic:
        out = HaloGrid(
            data=refresh_dynamic(out.data, out.halo, out.bc),
            halo=out.halo, bc=out.bc,
        )
    return out


@partial(jax.jit, static_argnames=("spec", "iterations"))
def iterate(grid: HaloGrid, spec: StencilSpec, iterations: int) -> HaloGrid:
    """``iterations`` Jacobi sweeps under one jit.

    The iteration count is static here for simplicity; :func:`iterate_dynamic`
    avoids recompilation across the sweep harness's iteration axis
    (fixing SURVEY §7 hard part (e))."""
    return lax.fori_loop(
        0, iterations, lambda _, g: sweep(g, spec), grid
    )


@partial(jax.jit, static_argnames=("spec",))
def iterate_dynamic(grid: HaloGrid, spec: StencilSpec,
                    iterations: jax.Array) -> HaloGrid:
    """Same as :func:`iterate` but with a traced iteration count, so the
    experiment sweep (iterations axis: 1..1e5, ``run_expr.py:6-15``) reuses
    one executable."""
    return lax.fori_loop(
        0, iterations, lambda _, g: sweep(g, spec), grid
    )


def sweep_source(grid: HaloGrid, spec: StencilSpec,
                 scaled_source: jax.Array) -> HaloGrid:
    """One affine sweep ``u' = S(u) + scaled_source`` (interior-shaped
    ``scaled_source`` already carries its scale factor). XLA fuses the add
    into the tap-accumulation pass — one extra read per point, no extra
    HBM round trip. This is the update behind Poisson relaxation
    (``models/poisson.py``); the reference has no source-term capability
    (its update is purely homogeneous, ``stencil.cpp:85-125``)."""
    new_interior = apply_spec(grid.data, spec, halo=grid.halo) + scaled_source
    out = grid.with_interior(new_interior)
    if grid.bc.any_dynamic:
        out = HaloGrid(
            data=refresh_dynamic(out.data, out.halo, out.bc),
            halo=out.halo, bc=out.bc,
        )
    return out


@partial(jax.jit, static_argnames=("spec",))
def iterate_source_dynamic(grid: HaloGrid, spec: StencilSpec,
                           iterations: jax.Array,
                           scaled_source: jax.Array) -> HaloGrid:
    """``iterations`` affine sweeps ``u' = S(u) + scaled_source`` under one
    jit with a traced iteration count (one executable serves every chunk
    size of a convergence-driven solve, ``solver.solve``)."""
    return lax.fori_loop(
        0, iterations, lambda _, g: sweep_source(g, spec, scaled_source),
        grid,
    )


def apply_fields(padded: jax.Array, offsets, fields: jax.Array,
                 halo: int) -> jax.Array:
    """One VARIABLE-COEFFICIENT sweep: ``out[p] = sum_t fields[t][p] *
    in[p + offsets[t]]`` — per-point tap weights, which the static-weight
    ``StencilSpec`` cannot express (heterogeneous-media stencils,
    ``models/diffusion.py``). ``fields`` is a stacked ``(T,) + interior``
    array; XLA fuses the T multiply-adds into one pass."""
    r = halo
    ndim = padded.ndim
    interior_shape = tuple(s - 2 * r for s in padded.shape)
    acc = None
    for i, off in enumerate(offsets):
        start = tuple(r + off[d] for d in range(ndim))
        limit = tuple(start[d] + interior_shape[d] for d in range(ndim))
        term = fields[i] * lax.slice(padded, start, limit)
        acc = term if acc is None else acc + term
    return acc


@partial(jax.jit, static_argnames=("offsets", "halo"))
def iterate_fields_dynamic(grid: HaloGrid, offsets,
                           fields: jax.Array,
                           iterations: jax.Array,
                           halo: int = 1) -> HaloGrid:
    """``iterations`` variable-coefficient sweeps under one jit
    (traced count). ``offsets`` must be a (hashable) tuple of offset
    tuples; ``fields`` stacks one interior-shaped weight array per
    offset."""

    def sweep_fields(g):
        out = g.with_interior(apply_fields(g.data, offsets, fields,
                                           halo))
        if g.bc.any_dynamic:
            out = HaloGrid(
                data=refresh_dynamic(out.data, out.halo, out.bc),
                halo=out.halo, bc=out.bc,
            )
        return out

    return lax.fori_loop(
        0, iterations, lambda _, g: sweep_fields(g), grid
    )
