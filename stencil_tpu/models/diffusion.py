"""Heterogeneous (variable-coefficient) diffusion:
``u_t = div(a(x) grad u)`` with a spatially varying diffusivity.

The reference's stencil weights are compile-time constants (the hardcoded
``1/(2*(bw+bh))`` average, ``stencil.cpp:85-125``), and this framework's
``StencilSpec`` generalizes them to arbitrary but still CONSTANT weights.
Real heterogeneous media need PER-POINT weights: the standard conservative
FTCS discretization is

    u'_i = u_i + (dt/h^2) * sum_faces a_face * (u_nb - u_i)

with the face diffusivity ``a_face`` the harmonic mean of the two cell
values (flux continuity across material interfaces). As a stencil that is
``T = 2*ndim + 1`` taps whose weights are fields: neighbor tap d+/- gets
``(dt/h^2) * a_face``, the center gets ``1 - sum(neighbor weights)``.
``ops/xla.py:apply_fields`` evaluates it in one fused XLA pass.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from stencil_tpu.core.grid import DirichletBC, HaloGrid
from stencil_tpu.registry import Runner


def face_harmonic_means(a: np.ndarray,
                        periodic=None) -> Tuple[np.ndarray, ...]:
    """Per-dim (lo, hi) face diffusivities: harmonic mean of the two
    adjacent cell values. At physical walls the neighbor is
    edge-replicated (the boundary face sees the wall cell's own
    diffusivity); on PERIODIC dims the neighbor wraps — both cells of a
    wrap face must see the SAME coefficient or the scheme stops being
    conservative (a replicate there leaks mass, caught by
    ``test_mass_conservation_periodic``)."""
    ndim = a.ndim
    if periodic is None:
        periodic = (False,) * ndim
    faces = []
    for d in range(ndim):
        def shift(sign, _d=d):
            if periodic[_d]:
                return np.roll(a, -sign, axis=_d)
            pads = [(1, 1) if e == _d else (0, 0) for e in range(ndim)]
            ap = np.pad(a, pads, mode="edge")
            idx = tuple(
                slice(1 + sign, a.shape[e] + 1 + sign) if e == _d
                else slice(None)
                for e in range(ndim)
            )
            return ap[idx]

        for sign in (-1, 1):
            nb = shift(sign)
            faces.append(2.0 * a * nb / (a + nb))
    return tuple(faces)


def two_material(shape, lo: float = 0.01, hi: float = 1.0,
                 seed: int = 0) -> np.ndarray:
    """A deterministic two-material coefficient field: each cell is
    ``hi`` or ``lo`` with equal probability (seeded). The standard
    high-contrast test field for heterogeneous operators (also the
    CLI's ``--solve hetero`` field, with ``--contrast`` = hi/lo)."""
    rng = np.random.default_rng(seed)
    return np.where(rng.random(shape) > 0.5, float(hi), float(lo))


@dataclasses.dataclass(frozen=True)
class HeterogeneousDiffusion:
    """Explicit FTCS for ``u_t = div(a(x) grad u)``.

    ``a`` is the cell-centered diffusivity field (interior-shaped,
    positive). ``dt=None`` picks the largest stable step
    ``h^2 / (2 * ndim * max(a))``.
    """

    shape: Tuple[int, ...]
    a: np.ndarray
    h: float = 1.0
    dt: Optional[float] = None
    bc: Optional[DirichletBC] = None
    dtype: str = "float32"

    def __post_init__(self):
        a = np.asarray(self.a, np.float64)
        object.__setattr__(self, "a", a)
        if a.shape != tuple(self.shape):
            raise ValueError(f"a shape {a.shape} != interior {self.shape}")
        if not np.all(a > 0):
            raise ValueError("diffusivity a(x) must be positive")
        if self.bc is None:
            object.__setattr__(
                self, "bc", DirichletBC.reference_default(len(self.shape)))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def stable_dt(self) -> float:
        return self.h ** 2 / (2 * self.ndim * float(self.a.max()))

    def tap_fields(self):
        """(offsets, fields): center + 2*ndim neighbor taps with
        per-point weights. Raises on an unstable ``dt``."""
        dt = self.dt if self.dt is not None else self.stable_dt
        if dt > self.stable_dt * (1 + 1e-12):
            raise ValueError(
                f"unstable: dt={dt:g} > h^2/(2*ndim*max(a)) = "
                f"{self.stable_dt:g}")
        lam = dt / self.h ** 2
        faces = face_harmonic_means(self.a,
                                    self.bc.periodic_mask(self.ndim))
        offsets = [(0,) * self.ndim]
        fields = [np.zeros(self.shape, np.float64)]  # center placeholder
        fi = 0
        for d in range(self.ndim):
            for sign in (-1, 1):
                off = [0] * self.ndim
                off[d] = sign
                offsets.append(tuple(off))
                fields.append(lam * faces[fi])
                fi += 1
        fields[0] = 1.0 - sum(fields[1:])
        return tuple(offsets), np.stack(fields)

    def runner(self) -> Runner:
        """Registry-compatible Runner (the fused per-point-weight XLA
        sweep); plugs into ``solver.solve`` for steady states."""
        import jax.numpy as jnp

        from stencil_tpu.ops import xla

        offsets, fields = self.tap_fields()
        fields = jnp.asarray(fields, self.dtype)
        return Runner(
            name=f"hetero_diffusion_xla({self.ndim}d)",
            iterate=lambda g, n: xla.iterate_fields_dynamic(
                g, offsets, fields, jnp.int32(n), halo=1),
            description="variable-coefficient FTCS diffusion "
                        "(per-point tap weights, harmonic face means)",
        )

    def initial_grid(self, interior=None) -> HaloGrid:
        if interior is None:
            return HaloGrid.create(self.shape, halo=1, bc=self.bc,
                                   dtype=self.dtype)
        import jax.numpy as jnp
        return HaloGrid.from_interior(
            jnp.asarray(interior, dtype=self.dtype), halo=1, bc=self.bc)


def _restrict_fw_np(r: np.ndarray) -> np.ndarray:
    """NumPy full-weighting restriction (per-dim [1/4, 1/2, 1/4],
    factor-2 subsample; fine width n = 2 n_c + 1) — the host-side twin
    of ``multigrid._restrict_fw`` used to coarsen coefficient fields."""
    for d in range(r.ndim):
        n = r.shape[d]

        def take(lo, hi, _d=d):
            idx = tuple(
                slice(lo, hi, 2) if e == _d else slice(None)
                for e in range(r.ndim)
            )
            return r[idx]

        r = 0.25 * take(0, n - 2) + 0.5 * take(1, n - 1) \
            + 0.25 * take(2, n)
    return r


@dataclasses.dataclass(frozen=True)
class HeterogeneousPoissonProblem:
    """Steady heterogeneous diffusion: ``-div(a(x) grad u) = f`` on
    Dirichlet walls — the boundary-value companion of the FTCS
    time-marcher above, and the one solver-stack family whose operator
    is a FIELD, not constant taps.

    Discretization: conservative flux form with harmonic face means
    (the same ``face_harmonic_means`` the FTCS path uses — flux
    continuity across material interfaces): center ``sum_faces
    a_face / h^2``, face taps ``-a_face / h^2``. The operator is an
    SPD M-matrix; it plugs into the matrix-free Krylov stack through
    the generic operator protocol (``operator_apply`` over stacked
    weight fields evaluated by ``ops/xla.py:apply_fields``; the field
    arrays are runtime data THREADED through the jitted solve, never
    baked into the compile payload) and into
    ``multigrid.OperatorMultigrid`` via coefficient coarsening
    (``with_discretization`` full-weights a(x) down the vertex-centered
    ladder — the standard geometric-MG treatment of rough
    coefficients).
    """

    shape: Tuple[int, ...]
    a: np.ndarray
    h: Optional[float] = None
    bc: Optional[DirichletBC] = None
    dtype: str = "float32"

    def __post_init__(self):
        a = np.asarray(self.a, np.float64)
        object.__setattr__(self, "a", a)
        if a.shape != tuple(self.shape):
            raise ValueError(f"a shape {a.shape} != interior {self.shape}")
        if not np.all(a > 0):
            raise ValueError("diffusivity a(x) must be positive")
        if self.h is None:
            object.__setattr__(self, "h", 1.0 / (self.shape[0] + 1))
        if self.bc is None:
            object.__setattr__(
                self, "bc", DirichletBC.zero(len(self.shape)))
        if self.bc.any_dynamic:
            raise ValueError(
                "the steady heterogeneous operator needs Dirichlet "
                "walls (periodic/Neumann annihilate constants; march "
                "HeterogeneousDiffusion in time instead)")
        object.__setattr__(self, "_data_cache", None)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def operator_fields(self):
        """(offsets, stacked float64 fields) of the operator ``A``."""
        inv_h2 = 1.0 / (float(self.h) ** 2)
        faces = face_harmonic_means(self.a)
        offsets = [(0,) * self.ndim]
        fields = [np.zeros(self.shape, np.float64)]
        fi = 0
        for d in range(self.ndim):
            for sign in (-1, 1):
                off = [0] * self.ndim
                off[d] = sign
                offsets.append(tuple(off))
                fields.append(-inv_h2 * faces[fi])
                fi += 1
        fields[0] = -sum(fields[1:])
        return tuple(offsets), np.stack(fields)

    # -- matrix-free operator protocol --------------------------------

    def operator_data(self):
        """The operator's runtime arrays, cached: the stacked weight
        fields the matvec and the Jacobi diagonal read. Threaded through
        the jitted solves as arguments, never closed over."""
        if self._data_cache is None:
            import jax.numpy as jnp

            _, fields = self.operator_fields()
            object.__setattr__(self, "_data_cache",
                               jnp.asarray(fields, self.dtype))
        return self._data_cache

    def operator_apply(self, padded, data):
        from stencil_tpu.ops import xla

        nd = self.ndim
        offs = [(0,) * nd]
        for d in range(nd):
            for sign in (-1, 1):
                off = [0] * nd
                off[d] = sign
                offs.append(tuple(off))
        return xla.apply_fields(padded, tuple(offs), data, halo=1)

    def operator_inv_diagonal(self, data):
        if data is None:
            raise TypeError("field operator diagonal needs data")
        return 1.0 / data[0]

    def with_discretization(self, shape,
                            h) -> "HeterogeneousPoissonProblem":
        """Coarsen the coefficient field down the vertex-centered
        ladder (full weighting per skipped level) and rediscretize."""
        a = self.a
        while a.shape != tuple(shape):
            if any(n % 2 == 0 or n < 3 for n in a.shape):
                raise ValueError(
                    f"cannot coarsen a{a.shape} toward {tuple(shape)}")
            a = _restrict_fw_np(a)
        return dataclasses.replace(
            self, shape=tuple(shape), a=a, h=float(h),
            bc=DirichletBC.zero(self.ndim))

    # -- golden twin / convenience ------------------------------------

    def initial_grid(self, interior=None) -> HaloGrid:
        if interior is None:
            return HaloGrid.create(self.shape, halo=1, bc=self.bc,
                                   dtype=self.dtype)
        import jax.numpy as jnp
        return HaloGrid.from_interior(
            jnp.asarray(interior, dtype=self.dtype), halo=1, bc=self.bc)

    def apply_f64(self, interior) -> np.ndarray:
        """``A u`` in float64 with the true wall ghosts (certificate)."""
        from stencil_tpu.core.grid import fill_halo_np

        u = np.asarray(interior, np.float64)
        if u.shape != tuple(self.shape):
            raise ValueError(f"interior shape {u.shape} != {self.shape}")
        padded = fill_halo_np(np.pad(u, 1), 1, self.bc)
        offsets, fields = self.operator_fields()
        n = tuple(self.shape)
        out = np.zeros(n, np.float64)
        for off, w in zip(offsets, fields):
            idx = tuple(slice(1 + off[d], 1 + off[d] + n[d])
                        for d in range(self.ndim))
            out += w * padded[idx]
        return out

    def residual_f64(self, grid: HaloGrid, f) -> float:
        r = np.asarray(f, np.float64) - self.apply_f64(
            np.asarray(grid.interior(), np.float64))
        return float(np.max(np.abs(r)))

    def solve(self, f, tolerance: float = 1e-5,
              max_iterations: int = 2000, preconditioned: bool = True,
              mesh=None, dim: int = 0):
        """Solve by (by default MG-preconditioned) BiCGStab; returns
        its ``CGResult``. The operator is SPD, but the field-operator
        Krylov path is the BiCGStab one — its extra matvec per
        iteration is the price of one code path for constant AND field
        operators. ``mesh`` distributes the solve (GSPMD)."""
        from stencil_tpu.krylov import BiCGStab
        from stencil_tpu.multigrid import OperatorMultigrid

        pre = OperatorMultigrid(self) if preconditioned else None
        return BiCGStab(self, preconditioner=pre).solve(
            f, tolerance=tolerance, max_iterations=max_iterations,
            mesh=mesh, dim=dim)
