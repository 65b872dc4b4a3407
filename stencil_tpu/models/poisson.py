"""Poisson equation model family: solve ``laplacian(u) = f`` by Jacobi
relaxation with a fused source term.

The reference relaxes only the homogeneous Laplace equation (its update is
a pure neighbor average, ``/root/reference/src/stencil/stencil.cpp:85-125``,
and its CLI has no way to supply a right-hand side,
``program_options.cpp:13-37``). The standard 2nd-order discretization of
``laplacian(u) = f`` on an h-spaced grid turns each Jacobi sweep into the
affine update

    u' = S(u) - h^2 / (2*ndim) * f

where ``S`` is exactly the reference's radius-1 star average. This module
exposes that as a model: the homogeneous stencil machinery (including its
golden model and convergence solver) plus one fused interior-shaped add per
sweep (``ops/xla.py:sweep_source`` — XLA fuses the add into the tap
accumulation, so a source costs one extra read per point, not an extra HBM
round trip).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from stencil_tpu.core.grid import DirichletBC, HaloGrid
from stencil_tpu.core.spec import StencilSpec, star
from stencil_tpu.registry import Runner


@dataclasses.dataclass(frozen=True)
class PoissonProblem:
    """``laplacian(u) = f`` on a unit-spacing-``h`` grid with Dirichlet
    (default 0) or periodic/Neumann walls.

    ``shape`` is the interior point count per dim; with the default
    ``h = 1 / (shape[d] + 1)`` convention the interior samples the open
    unit cube at ``x_i = (i + 1) * h`` (Dirichlet walls sit ON the domain
    boundary). Pass ``h`` explicitly for physical domains.
    """

    shape: Tuple[int, ...]
    h: Optional[float] = None
    bc: Optional[DirichletBC] = None
    dtype: str = "float32"

    def __post_init__(self):
        if self.h is None:
            object.__setattr__(self, "h", 1.0 / (self.shape[0] + 1))
        if self.bc is None:
            object.__setattr__(
                self, "bc", DirichletBC.zero(len(self.shape)))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def spec(self) -> StencilSpec:
        """The Jacobi iteration matrix: the reference's radius-1 star
        average (uniform weight ``1/(2*ndim)``)."""
        return star(self.ndim, 1)

    @property
    def operator_spec(self) -> StencilSpec:
        """The equation's left-hand side as taps: the discrete
        ``laplacian`` (center ``-2 ndim / h^2``, faces ``+1/h^2``), so
        ``apply_spec(operator_spec) u = f`` IS ``laplacian(u) = f``.
        The matrix-free form generic Krylov solvers consume
        (``krylov.BiCGStab``; ``ConjugateGradient`` hardcodes the
        negated — SPD — star, same solution by linearity)."""
        from stencil_tpu.core.spec import weighted

        nd, h = self.ndim, float(self.h)
        inv_h2 = 1.0 / (h * h)
        taps = [((0,) * nd, -2.0 * nd * inv_h2)]
        for d in range(nd):
            for sign in (-1, 1):
                off = [0] * nd
                off[d] = sign
                taps.append((tuple(off), inv_h2))
        return weighted(nd, taps, name=f"laplace{nd}d")

    def with_discretization(self, shape, h) -> "PoissonProblem":
        """The same continuous problem on another grid (zero walls) —
        the per-level rediscretization hook of
        ``multigrid.OperatorMultigrid``."""
        import dataclasses

        return dataclasses.replace(
            self, shape=tuple(shape), h=float(h),
            bc=DirichletBC.zero(self.ndim))

    # -- matrix-free operator protocol (see advection_diffusion.py) --

    def operator_data(self):
        return None

    def operator_apply(self, padded, data=None):
        from stencil_tpu.ops.xla import apply_spec

        return apply_spec(padded, self.operator_spec, halo=1)

    def operator_inv_diagonal(self, data=None) -> float:
        # laplacian center tap: -2 ndim / h^2 (negative-definite
        # operator; the sign folds into the Jacobi step)
        return -float(self.h) ** 2 / (2 * self.ndim)

    @property
    def source_scale(self) -> float:
        """``u' = S(u) + source_scale * f``: the fused per-sweep factor
        ``-h^2 / (2*ndim)`` of the 2nd-order Jacobi splitting."""
        return -(self.h ** 2) / (2 * self.ndim)

    def initial_grid(self, interior=None) -> HaloGrid:
        if interior is None:
            return HaloGrid.create(self.shape, halo=1, bc=self.bc,
                                   dtype=self.dtype)
        import jax.numpy as jnp
        return HaloGrid.from_interior(
            jnp.asarray(interior, dtype=self.dtype), halo=1, bc=self.bc)

    def apply_f64(self, interior) -> np.ndarray:
        """``laplacian(u)`` in float64 with the true wall values in the
        ghost ring — the golden twin of the device operator."""
        from stencil_tpu.ops.golden import apply_spec_f64

        return apply_spec_f64(interior, self.operator_spec, self.bc)

    def residual_f64(self, grid: HaloGrid, f) -> float:
        """``max |f - laplacian(u)|`` in float64 — the certificate."""
        r = np.asarray(f, np.float64) - self.apply_f64(
            np.asarray(grid.interior(), np.float64))
        return float(np.max(np.abs(r)))

    def runner(self, f) -> Runner:
        """A registry-compatible Runner whose every sweep applies the
        fused source: plugs straight into ``solver.solve``."""
        import jax
        import jax.numpy as jnp

        from stencil_tpu.ops import xla

        if isinstance(f, jax.Array):
            # device-resident source: scale on device (no host
            # round trip — see core.grid.as_device_array)
            scaled = jnp.asarray(f, self.dtype) * jnp.asarray(
                self.source_scale, dtype=self.dtype)
        else:
            scaled = jnp.asarray(np.asarray(f) * self.source_scale,
                                 dtype=self.dtype)
        if scaled.shape != tuple(self.shape):
            raise ValueError(
                f"source shape {scaled.shape} != interior "
                f"{self.shape}")
        return Runner(
            name=f"poisson_xla({self.ndim}d)",
            iterate=lambda g, n: xla.iterate_source_dynamic(
                g, self.spec, jnp.int32(n), scaled),
            description="Jacobi relaxation of laplacian(u)=f "
                        "(fused source term)",
        )

    def solve(self, f, tolerance: float = 1e-6,
              max_iterations: int = 200_000, check_every: int = 200,
              progress=None):
        """Relax to the discrete solution of ``laplacian(u) = f``;
        returns ``solver.SolveResult``."""
        from stencil_tpu import solver

        return solver.solve(self.runner(f),
                            self.initial_grid(),
                            tolerance=tolerance,
                            max_iterations=max_iterations,
                            check_every=check_every, progress=progress)


def manufactured_sine(shape: Tuple[int, ...], h: Optional[float] = None):
    """Manufactured Dirichlet-0 test problem: ``u*(x) = prod_d
    sin(pi x_d / L_d)`` on the box with per-dim extent
    ``L_d = (shape[d] + 1) * h`` (the domain a uniform-``h`` grid of
    that shape actually spans — the unit cube when the grid is cubic
    with the default ``h``), so u* vanishes on EVERY wall and
    ``laplacian(u*) = -pi^2 (sum_d 1/L_d^2) u*``. Returns
    ``(f, u_exact)`` as float64 arrays on the interior points
    ``x_i = (i + 1) * h``; the discrete solve converges to ``u_exact``
    up to the O(h^2) discretization error."""
    if h is None:
        h = 1.0 / (shape[0] + 1)
    extents = [(n + 1) * h for n in shape]
    axes = [np.sin(np.pi * (np.arange(1, n + 1) * h) / L)
            for n, L in zip(shape, extents)]
    u = axes[0]
    for a in axes[1:]:
        u = np.multiply.outer(u, a)
    f = -np.pi ** 2 * sum(1.0 / (L * L) for L in extents) * u
    return f, u
