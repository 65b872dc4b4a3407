"""Wave equation model family: explicit leapfrog time stepping.

The reference's only recursion shape is first-order in time (next iterate
from one previous iterate, ``/root/reference/src/stencil/stencil.cpp:23-57``
buffer ping-pong). The wave equation ``u_tt = c^2 laplacian(u)`` is
second-order: the standard leapfrog update reads TWO time levels,

    u_{n+1} = S(u_n) - u_{n-1}

where ``S`` is a radius-1 star WITH center: center weight
``2 - 2*ndim*s^2``, neighbor weights ``s^2``, with the Courant number
``s = c*dt/h`` (stable iff ``ndim * s^2 <= 1``). The stencil spec
machinery provides ``S`` (one fused XLA pass), the
two-level recursion is a ``lax.fori_loop`` carrying a ``(prev, cur)``
HaloGrid pair, and the subtraction fuses into the same pass — one extra
interior read per point, no extra HBM round trip.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from stencil_tpu.core.grid import (
    DirichletBC, HaloGrid, fill_halo_np, refresh_dynamic_np,
)
from stencil_tpu.core.spec import StencilSpec, weighted
from stencil_tpu.ops.golden import golden_sweep


@dataclasses.dataclass(frozen=True)
class WaveEquation:
    """``u_tt = c^2 laplacian(u)`` with fixed (Dirichlet-0, default),
    periodic, or reflecting (Neumann) walls.

    ``dt=None`` picks the largest stable step ``h / (c * sqrt(ndim))``
    (the CFL limit, at which the scheme is exact along grid diagonals).
    """

    shape: Tuple[int, ...]
    c: float = 1.0
    h: float = 1.0
    dt: Optional[float] = None
    bc: Optional[DirichletBC] = None
    dtype: str = "float32"

    def __post_init__(self):
        if self.bc is None:
            object.__setattr__(self, "bc",
                               DirichletBC.zero(len(self.shape)))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def courant(self) -> float:
        """``s = c*dt/h``; stability requires ``ndim * s^2 <= 1``."""
        ndim = self.ndim
        if self.dt is None:
            return 1.0 / np.sqrt(ndim)
        s = self.c * self.dt / self.h
        if ndim * s * s > 1.0 + 1e-12:
            raise ValueError(
                f"unstable: ndim*s^2 = {ndim * s * s:.4f} > 1 (reduce dt "
                f"below {self.h / (self.c * np.sqrt(ndim)):g})")
        return s

    @property
    def spec(self) -> StencilSpec:
        """The one-level part ``S`` of the leapfrog update: center
        ``2 - 2*ndim*s^2``, radius-1 star neighbors ``s^2``."""
        ndim = self.ndim
        s2 = self.courant ** 2
        taps = [((0,) * ndim, 2.0 - 2 * ndim * s2)]
        for d in range(ndim):
            for sign in (-1, 1):
                off = [0] * ndim
                off[d] = sign
                taps.append((tuple(off), s2))
        return weighted(ndim, taps, name=f"wave{ndim}d")

    # -- initialization ------------------------------------------------------

    def initial_pair(self, u0, v0=None) -> Tuple[HaloGrid, HaloGrid]:
        """The ``(prev, cur) = (u_0, u_1)`` pair from displacement ``u0``
        and velocity ``v0`` (default 0) at t=0, via the 2nd-order Taylor
        start ``u_1 = u_0 + dt*v0 + (1/2) * (S(u_0) - 2 u_0)`` (the
        ``S - 2I`` term IS ``(c*dt)^2 laplacian`` discretely)."""
        import jax.numpy as jnp

        u0 = np.asarray(u0, np.float64)
        if u0.shape != tuple(self.shape):
            raise ValueError(f"u0 shape {u0.shape} != {self.shape}")
        dt = (self.dt if self.dt is not None
              else self.courant * self.h / self.c)
        padded = fill_halo_np(np.pad(u0, 1), 1, self.bc)
        u1 = u0 + 0.5 * (golden_sweep(padded, self.spec) - 2.0 * u0)
        if v0 is not None:
            u1 = u1 + dt * np.asarray(v0, np.float64)
        prev = HaloGrid.from_interior(jnp.asarray(u0, self.dtype), halo=1,
                                      bc=self.bc)
        cur = HaloGrid.from_interior(jnp.asarray(u1, self.dtype), halo=1,
                                     bc=self.bc)
        return prev, cur

    # -- time stepping ---------------------------------------------------------

    def simulate(self, prev: HaloGrid, cur: HaloGrid,
                 steps: int) -> Tuple[HaloGrid, HaloGrid]:
        """Advance ``steps`` leapfrog steps (one fused XLA pass each);
        returns the new ``(prev, cur)`` pair (``cur`` is
        ``u_{n+steps}``)."""
        import jax.numpy as jnp

        return _simulate_jit(prev, cur, self.spec, jnp.int32(steps))

    def simulate_interior(self, u0, steps: int, v0=None) -> np.ndarray:
        """Convenience: from initial conditions to the interior after
        ``steps`` steps (counting u_1 as step 1)."""
        prev, cur = self.initial_pair(u0, v0)
        if steps <= 1:
            return np.asarray((prev if steps == 0 else cur).interior())
        _, cur = self.simulate(prev, cur, steps - 1)
        return np.asarray(cur.interior())


def _simulate_impl(prev: HaloGrid, cur: HaloGrid, spec: StencilSpec,
                   steps) -> Tuple[HaloGrid, HaloGrid]:
    from jax import lax

    from stencil_tpu.core.grid import refresh_dynamic
    from stencil_tpu.ops.xla import apply_spec

    def step(_, pair):
        prev, cur = pair
        new_interior = apply_spec(cur.data, spec, halo=cur.halo) \
            - prev.interior()
        new = cur.with_interior(new_interior)
        if cur.bc.any_dynamic:
            new = HaloGrid(data=refresh_dynamic(new.data, new.halo, new.bc),
                           halo=new.halo, bc=new.bc)
        return (cur, new)

    return lax.fori_loop(0, steps, step, (prev, cur))


def _make_simulate_jit():
    import jax

    return jax.jit(_simulate_impl, static_argnames=("spec",))


_simulate_jit = _make_simulate_jit()


def golden_wave(u0: np.ndarray, spec: StencilSpec, steps: int,
                bc: DirichletBC, v0=None, dt: float = 1.0) -> np.ndarray:
    """Independent float64 two-level reference loop (the differential
    twin of ``WaveEquation.simulate``, same role as ``ops/golden.py`` for
    the first-order methods). Returns the interior after ``steps`` steps."""
    u0 = np.asarray(u0, np.float64)
    padded = fill_halo_np(np.pad(u0, 1), 1, bc)
    idx = tuple(slice(1, s - 1) for s in padded.shape)
    u1 = u0 + 0.5 * (golden_sweep(padded, spec) - 2.0 * u0)
    if v0 is not None:
        u1 = u1 + dt * np.asarray(v0, np.float64)
    if steps == 0:
        return u0
    prev = padded
    cur = fill_halo_np(np.pad(u1, 1), 1, bc)
    for _ in range(steps - 1):
        new = golden_sweep(cur, spec) - prev[idx]
        prev, cur = cur, prev
        cur[idx] = new
        if bc.any_dynamic:
            refresh_dynamic_np(cur, 1, bc)
    return cur[idx]
