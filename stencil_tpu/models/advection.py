"""Linear advection model family: ``du/dt + v . grad(u) = 0``.

The reference's only physics is the symmetric Jacobi/Laplace relaxation
(``/root/reference/src/stencil/stencil.cpp:85-125``); transport adds the
one structural class none of the other families exercise: **one-sided
(asymmetric) tap sets**, whose interaction with the framework's deep
machinery is non-trivial — Neumann faces at temporal depth k>1 are gated
on per-dim mirror symmetry (``StencilSpec.symmetric_in``), while periodic
wrap and Dirichlet pins take asymmetric taps at any depth.

Two dimensionally-split explicit schemes over a constant velocity ``v``:

- ``upwind`` (donor cell, 1st order): per dim, the tap one cell on the
  UPSTREAM side with weight ``|c_d|`` and center ``1 - sum |c_d|`` where
  ``c_d = v_d dt / h`` is the per-dim CFL number. A convex combination
  for ``sum |c_d| <= 1`` (monotone, unconditionally positive), exact for
  integer ``c_d``.
- ``lax_wendroff`` (2nd order per dim, split): per dim taps
  ``-c_d/2 + c_d^2/2`` (downstream), ``+c_d/2 + c_d^2/2`` (upstream),
  center ``1 - sum c_d^2``. Dispersive rather than diffusive; the
  dimensional splitting drops the O(c_i c_j) cross terms (documented
  standard practice for structured-grid transport).

Both are plain ``StencilSpec``s, so every method in the registry — XLA,
the sharded paths, streaming — runs them unchanged, and the
float64 golden model verifies them like any other spec.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from stencil_tpu.core.grid import DirichletBC, HaloGrid
from stencil_tpu.core.spec import StencilSpec, weighted


@dataclasses.dataclass(frozen=True)
class Advection:
    """Constant-velocity linear transport on a periodic (default) box.

    ``velocity`` has one component per dim; ``dt=None`` picks the largest
    stable step (CFL sum = 1 for upwind, max |c_d| = 1 for Lax-Wendroff,
    scaled by ``cfl_safety``).
    """

    shape: Tuple[int, ...]
    velocity: Tuple[float, ...]
    h: float = 1.0
    dt: Optional[float] = None
    scheme: str = "upwind"
    cfl_safety: float = 1.0
    bc: Optional[DirichletBC] = None
    dtype: str = "float32"

    def __post_init__(self):
        if len(self.velocity) != len(self.shape):
            raise ValueError(
                f"velocity rank {len(self.velocity)} != grid rank "
                f"{len(self.shape)}")
        if self.scheme not in ("upwind", "lax_wendroff"):
            raise ValueError(
                f"unknown scheme {self.scheme!r} (upwind | lax_wendroff)")
        if self.bc is None:
            object.__setattr__(
                self, "bc", DirichletBC.periodic_all(len(self.shape)))
        if self.dt is None:
            vsum = sum(abs(v) for v in self.velocity)
            vmax = max(abs(v) for v in self.velocity)
            if self.scheme == "upwind":
                base = self.h / vsum if vsum else 1.0
            else:
                base = self.h / vmax if vmax else 1.0
            object.__setattr__(self, "dt", self.cfl_safety * base)
        self.courant  # validate stability at construction

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def courant(self) -> Tuple[float, ...]:
        """Per-dim CFL numbers ``c_d = v_d dt / h``; raises if unstable."""
        c = tuple(v * self.dt / self.h for v in self.velocity)
        if self.scheme == "upwind":
            if sum(abs(x) for x in c) > 1.0 + 1e-12:
                raise ValueError(
                    f"unstable upwind step: sum |c_d| = "
                    f"{sum(abs(x) for x in c):.4f} > 1 (reduce dt)")
        else:
            if max(abs(x) for x in c) > 1.0 + 1e-12:
                raise ValueError(
                    f"unstable Lax-Wendroff step: max |c_d| = "
                    f"{max(abs(x) for x in c):.4f} > 1 (reduce dt)")
        return c

    @property
    def spec(self) -> StencilSpec:
        c = self.courant
        taps = []
        center = 1.0
        for d, cd in enumerate(c):
            if cd == 0.0:
                continue
            lo = [0] * self.ndim
            hi = [0] * self.ndim
            lo[d], hi[d] = -1, 1
            if self.scheme == "upwind":
                center -= abs(cd)
                up = tuple(lo) if cd > 0 else tuple(hi)
                taps.append((up, abs(cd)))
            else:
                center -= cd * cd
                taps.append((tuple(lo), 0.5 * cd + 0.5 * cd * cd))
                taps.append((tuple(hi), -0.5 * cd + 0.5 * cd * cd))
        taps = [(off, w) for off, w in taps if w != 0.0]
        if center != 0.0 or not taps:  # integer-CFL upwind drops the center
            taps = [((0,) * self.ndim, center)] + taps
        return weighted(self.ndim, taps,
                        name=f"advect_{self.scheme}{self.ndim}d")

    def initial_grid(self, interior) -> HaloGrid:
        import jax.numpy as jnp

        return HaloGrid.from_interior(
            jnp.asarray(interior, dtype=self.dtype), halo=1, bc=self.bc)

    def exact_translate(self, interior0: np.ndarray,
                        steps: int) -> np.ndarray:
        """Exact solution on a fully periodic box: the initial field
        translated by ``v * steps * dt`` (cell-roll, valid when the total
        displacement per dim is an integer number of cells — pick
        ``dt``/``steps`` accordingly in tests)."""
        out = np.asarray(interior0)
        for d, v in enumerate(self.velocity):
            disp = v * steps * self.dt / self.h
            r = int(round(disp))
            if abs(disp - r) > 1e-9:
                raise ValueError(
                    f"displacement {disp} along dim {d} is not a whole "
                    "number of cells; exact_translate does not apply")
            out = np.roll(out, r, axis=d)
        return out
