"""Geometric multigrid for ``laplacian(u) = f``: O(N) time-to-solution.

The reference (and this framework's ``solver.solve``) relaxes toward the
solution by plain fixed-point sweeps, whose iteration count grows like
O(n^2) in the grid width — thousands of sweeps for production grids. A
V-cycle contracts ALL error frequencies at once by smoothing each on the
level where it is high-frequency, converging in a grid-size-INDEPENDENT
~10 cycles; each cycle costs only ~(nu1 + nu2 + 1) fine-grid sweeps plus
a geometric tail (sum over levels of (1/2^ndim)^l < 2x in 2D, <8/7x in
3D). Nothing in the reference corresponds (`stencil.cpp:85-125` is the
plain sweep); this is a time-to-solution capability on top of the same
discretization.

Shape: every level's smoother/residual/transfer is a fused XLA pass over
a STATIC shape; the level recursion is a trace-time Python
loop, so one ``jax.jit`` holds the entire V-cycle (no host round trips
between levels — the scalar residual crosses to the host only between
cycles, via the chunked ``solver.solve`` protocol that MG plugs into as
a registry ``Runner``: one "iteration" = one V-cycle).

Discretization/transfer choices (the textbook vertex-centered stack):
2nd-order star Laplacian (exactly ``PoissonProblem``'s operator, so MG
and the Jacobi path converge to the SAME discrete solution), weighted-
Jacobi smoothing (damping ``omega``, default 2/3), full-weighting
restriction (tensor of [1/4, 1/2, 1/4]), linear prolongation (tensor of
[1/2, 1, 1/2]), coarsest level relaxed directly. Vertex-centered
factor-2 coarsening nests only ODD interior widths (n_c = (n-1)/2, the
classic n = 2^m - 1 ladder); coarsening stops at the first level where
any dim is even or < 3, so 2^m - 1 widths get full depth and others
degrade gracefully (a shallower hierarchy still contracts, just slower —
``levels`` in the runner's ``plan_info`` says what was built).

Boundary handling: the fine level reads the problem's Dirichlet walls
from the HaloGrid ghost pins; every coarse level solves the CORRECTION
equation ``laplacian(e) = r``, whose walls are exactly zero (the error
vanishes where u is pinned). Periodic/Neumann walls make the pure-
Neumann/periodic Poisson problem singular (solutions modulo constants)
and are refused.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from stencil_tpu.core.grid import HaloGrid, as_device_array
from stencil_tpu.models.poisson import PoissonProblem
from stencil_tpu.registry import Runner


def _nb_sum(padded: jax.Array) -> jax.Array:
    """Sum of the 2*ndim face neighbors, interior-shaped (padded has one
    ghost layer per face)."""
    nd = padded.ndim
    acc = None
    for d in range(nd):
        for lo in (0, 2):
            idx = tuple(
                slice(lo, padded.shape[e] - 2 + lo) if e == d
                else slice(1, padded.shape[e] - 1)
                for e in range(nd)
            )
            t = padded[idx]
            acc = t if acc is None else acc + t
    return acc


def _smooth(padded: jax.Array, f_scaled: jax.Array, omega: float,
            inv2d: float, sweeps: int) -> jax.Array:
    """``sweeps`` weighted-Jacobi sweeps on a zero-wall level:
    ``u' = (1 - omega) u + omega * (nb_sum(u) - h^2 f) / (2 ndim)``.
    ``f_scaled`` carries ``h^2 * f`` pre-multiplied."""
    nd = padded.ndim
    idx = tuple(slice(1, s - 1) for s in padded.shape)
    for _ in range(sweeps):
        u = padded[idx]
        jac = (_nb_sum(padded) - f_scaled) * inv2d
        padded = padded.at[idx].set(u + omega * (jac - u))
    return padded


def _residual(padded: jax.Array, f: jax.Array, inv_h2: float,
              two_d: float) -> jax.Array:
    """``r = f - (nb_sum(u) - 2 ndim u) / h^2``, interior-shaped."""
    idx = tuple(slice(1, s - 1) for s in padded.shape)
    return f - (_nb_sum(padded) - two_d * padded[idx]) * inv_h2


def _smooth_cheby(padded: jax.Array, f: jax.Array, inv_h2: float,
                  two_d: float, sweeps: int, ratio: float) -> jax.Array:
    """``sweeps`` steps of Chebyshev polynomial smoothing on the
    Jacobi-preconditioned operator (the production AMG/hypre smoother).

    The diagonal of the SPD operator ``A = -L`` is the CONSTANT
    ``2 ndim / h^2`` here, so ``D^-1 A`` has its spectrum inside
    ``(0, 2)`` exactly (no power-iteration estimate needed — the
    analytic bound is tight for the star Laplacian). The degree-nu
    polynomial equioscillates on the upper band ``[2/ratio, 2]``
    (ratio=4: the band factor-2 coarsening leaves to the smoother),
    which damps it by ``1/T_nu(sigma)`` — ~0.22 at nu=2 vs weighted
    Jacobi's 0.44 — at identical per-sweep cost (one residual + axpys,
    all trace-time coefficients, XLA fuses like the Jacobi sweep).
    Symmetric (a fixed polynomial in ``D^-1 A`` with constant ``D``),
    so PCG accepts it."""
    if sweeps <= 0:
        return padded
    lmax = 2.0
    lmin = lmax / float(ratio)
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    inv_d = 1.0 / (two_d * inv_h2)
    idx = tuple(slice(1, s - 1) for s in padded.shape)
    # residual of the SPD form: (-f) - A u = -(f - L u)
    r = -_residual(padded, f, inv_h2, two_d)
    d = (inv_d / theta) * r
    padded = padded.at[idx].add(d)
    rho_prev = 1.0 / sigma
    for _ in range(1, sweeps):
        rho = 1.0 / (2.0 * sigma - rho_prev)
        r = -_residual(padded, f, inv_h2, two_d)
        d = (rho * rho_prev) * d + (2.0 * rho / delta) * inv_d * r
        padded = padded.at[idx].add(d)
        rho_prev = rho
    return padded


def _restrict_fw(r: jax.Array) -> jax.Array:
    """Full-weighting restriction: per-dim [1/4, 1/2, 1/4] then factor-2
    subsample (fine width n = 2 n_c + 1, all dims)."""
    for d in range(r.ndim):
        n = r.shape[d]

        def take(lo, hi):
            idx = tuple(
                slice(lo, hi, 2) if e == d else slice(None)
                for e in range(r.ndim)
            )
            return r[idx]

        r = 0.25 * take(0, n - 2) + 0.5 * take(1, n - 1) \
            + 0.25 * take(2, n)
    return r


def _prolong_lin(e: jax.Array) -> jax.Array:
    """Linear prolongation: coarse point i lands on fine 2i+1; fine even
    points average their coarse neighbors (walls are zero). Separable."""
    for d in range(e.ndim):
        n_c = e.shape[d]
        n_f = 2 * n_c + 1
        shape = tuple(n_f if i == d else s for i, s in enumerate(e.shape))
        z = jnp.zeros(shape, e.dtype)
        inject = tuple(
            slice(1, None, 2) if i == d else slice(None)
            for i in range(e.ndim)
        )
        z = z.at[inject].set(e)
        zp = jnp.pad(z, [(1, 1) if i == d else (0, 0)
                         for i in range(e.ndim)])

        def take(lo):
            idx = tuple(
                slice(lo, lo + n_f) if i == d else slice(None)
                for i in range(e.ndim)
            )
            return zp[idx]

        e = z + 0.5 * (take(0) + take(2))
    return e


def _prolong_full(u_pad: jax.Array) -> jax.Array:
    """Ghost-aware linear prolongation for FMG: coarse PADDED level
    (nc+2 per dim, walls in the ghosts) -> fine PADDED level (2 nc+3).
    Fine even index 2j injects coarse j (ghosts land on ghosts: the
    vertex-centered levels share their physical walls); fine odd 2j+1
    averages coarse j, j+1 — so first-interior points see the WALL
    value, which plain zero-padded prolongation (correction equations)
    must not and ``_prolong_lin`` doesn't."""
    for d in range(u_pad.ndim):
        nc2 = u_pad.shape[d]  # nc + 2
        nf2 = 2 * nc2 - 1     # (2 nc + 1) + 2
        shape = tuple(nf2 if i == d else s
                      for i, s in enumerate(u_pad.shape))
        z = jnp.zeros(shape, u_pad.dtype)

        def at(lo, hi, step):
            return tuple(slice(lo, hi, step) if i == d else slice(None)
                         for i in range(u_pad.ndim))

        z = z.at[at(0, None, 2)].set(u_pad)
        z = z.at[at(1, None, 2)].set(
            0.5 * (u_pad[at(0, nc2 - 1, 1)] + u_pad[at(1, None, 1)]))
        u_pad = z
    return u_pad


@functools.lru_cache(maxsize=32)
def _residual_norm_fn(shape, dtype, h, ndim):
    inv_h2 = 1.0 / (h * h)
    two_d = float(2 * ndim)

    @jax.jit
    def fn(padded, f):
        return jnp.max(jnp.abs(_residual(padded, f, inv_h2, two_d)))

    return fn


def _level_shapes(shape: Tuple[int, ...],
                  min_size: int) -> Tuple[Tuple[int, ...], ...]:
    shapes = [tuple(shape)]
    while all(n % 2 == 1 and n >= max(3, min_size) for n in shapes[-1]) \
            and any(n > max(3, min_size) for n in shapes[-1]):
        nxt = tuple((n - 1) // 2 for n in shapes[-1])
        if any(n < 1 for n in nxt):
            break
        shapes.append(nxt)
    return tuple(shapes)


def _level_shardings_for(shapes, ndim: int, mesh, dim: int = 0,
                         replicate_below: Optional[int] = None):
    """Per-level ``NamedSharding``s for a coarsening hierarchy over a
    1D or 2D mesh: mesh axis ``a`` shards grid dim ``dim + a`` on
    levels at least ``replicate_below`` interior points wide along
    that dim; narrower levels drop that axis (the redundant-coarse-
    solve design, decided PER AXIS — a level can stay sharded along
    d0 while its d1 width has already collapsed). The 2D form is the
    analog of the reference's natively-2D 8x8 CPE mesh
    (``stencil_rma.cpp:194-196``). Shared by ``Multigrid`` and
    ``OperatorMultigrid``; returns ``(shardings, sharded_flags,
    replicate_below_per_axis)``."""
    naxes = len(mesh.axis_names)
    if naxes not in (1, 2):
        raise ValueError(
            f"distributed multigrid wants a 1D or 2D mesh, got axes "
            f"{mesh.axis_names}")
    if not 0 <= dim <= ndim - naxes:
        raise ValueError(
            f"mesh axes {mesh.axis_names} shard grid dims "
            f"{dim}..{dim + naxes - 1}, out of range for {ndim}D")
    if replicate_below is None:
        # keep >= 2 interior planes per shard along each sharded dim,
        # never below the point where halo traffic rivals the level's
        # volume (per AXIS: each axis sees only its own device count)
        rb = tuple(max(2 * int(s), 17) for s in mesh.devices.shape)
    else:
        rb = (int(replicate_below),) * naxes
    shardings = []
    sharded_levels = []
    for shp in shapes:
        spec = [None] * ndim
        used = False
        for a, axis in enumerate(mesh.axis_names):
            if shp[dim + a] >= rb[a]:
                spec[dim + a] = axis
                used = True
        shardings.append(NamedSharding(mesh, P(*spec)))
        sharded_levels.append(used)
    missing = [axis for a, axis in enumerate(mesh.axis_names)
               if shapes[0][dim + a] < rb[a]]
    if missing:
        raise ValueError(
            f"fine level {tuple(shapes[0])} is too narrow to use mesh "
            f"axis(es) {missing} (needs >= {rb} interior points along "
            f"dims {tuple(range(dim, dim + naxes))}); use a smaller/"
            "1D mesh or a bigger grid")
    return shardings, sharded_levels, rb


@dataclasses.dataclass(frozen=True)
class Multigrid:
    """V-cycle solver for a ``PoissonProblem`` (Dirichlet walls only).

    ``nu1``/``nu2`` pre/post smoothing sweeps, ``omega`` the Jacobi
    damping, ``coarse_sweeps`` relaxations on the coarsest level.
    """

    problem: PoissonProblem
    nu1: int = 2
    nu2: int = 2
    omega: float = 2.0 / 3.0
    coarse_sweeps: int = 32
    min_size: int = 3
    # 'wjacobi' (damped Jacobi, the reference-compatible default) or
    # 'chebyshev' (polynomial smoothing on the upper spectral band —
    # ~2x the per-sweep damping at the same cost). The coarsest level
    # always relaxes with damped Jacobi (it is a solve over the WHOLE
    # spectrum, not a band smoother).
    smoother: str = "wjacobi"
    cheby_ratio: float = 4.0
    # cycle index: 1 = V-cycle, 2 = W-cycle (each level visits its
    # coarse correction gamma times; W buys a stronger, nearly
    # level-count-independent contraction for ~2x the coarse-tail cost
    # — the fine level is visited once either way)
    gamma: int = 1

    def __post_init__(self):
        if self.problem.bc.any_dynamic:
            raise ValueError(
                "multigrid supports Dirichlet walls only (the pure "
                "periodic/Neumann Poisson problem is singular)")
        if self.smoother not in ("wjacobi", "chebyshev"):
            raise ValueError(
                f"unknown smoother {self.smoother!r} "
                "(wjacobi | chebyshev)")
        if self.cheby_ratio <= 1.0:
            raise ValueError("cheby_ratio must be > 1")
        if self.gamma not in (1, 2):
            raise ValueError("gamma must be 1 (V-cycle) or 2 (W-cycle)")
        shapes = _level_shapes(self.problem.shape, self.min_size)
        object.__setattr__(self, "_shapes", shapes)
        object.__setattr__(self, "_fmg_cache", {})

    @property
    def levels(self) -> int:
        return len(self._shapes)

    def _make_cycle(self, constrain=None):
        """The trace-time V-cycle recursion ``cycle(padded, f_scaled, f,
        level) -> padded`` over static level shapes (all-XLA; shared by
        the V-cycle runner and the FMG pass).

        ``constrain(arr, level)`` (optional) re-anchors each level's
        arrays to that level's sharding — the hook ``sharded_runner``
        uses to express the distributed cycle (see there)."""
        omega = float(self.omega)
        nu1, nu2 = int(self.nu1), int(self.nu2)
        coarse = int(self.coarse_sweeps)
        gamma = int(self.gamma)
        n_levels = self.levels
        ndim = self.problem.ndim
        two_d = float(2 * ndim)
        inv2d = 1.0 / two_d
        h0 = float(self.problem.h)

        def pin(arr, level):
            return constrain(arr, level) if constrain is not None else arr

        use_cheby = self.smoother == "chebyshev"
        ratio = float(self.cheby_ratio)

        def smooth(padded, f_scaled, f, inv_h2, n):
            if use_cheby:
                return _smooth_cheby(padded, f, inv_h2, two_d, n, ratio)
            return _smooth(padded, f_scaled, omega, inv2d, n)

        def cycle(padded, f_scaled, f, level):
            # f_scaled = h^2 * f at this level's h
            h = h0 * (2.0 ** level)
            inv_h2 = 1.0 / (h * h)
            padded = pin(padded, level)
            if level == n_levels - 1:
                # the coarsest level is a SOLVE over the whole spectrum
                # — always damped Jacobi (see the smoother field note)
                return _smooth(padded, f_scaled, omega, inv2d,
                               coarse if n_levels > 1
                               else max(coarse, nu1 + nu2))
            padded = smooth(padded, f_scaled, f, inv_h2, nu1)
            r = _residual(padded, f, inv_h2, two_d)
            rc = pin(_restrict_fw(r), level + 1)
            rc_scaled = (4.0 * h * h) * rc  # (2h)^2 * r_c
            # mu-cycle: solve the coarse error equation by gamma
            # applications of the coarse method (gamma=2 -> W-cycle),
            # each continuing from the previous estimate
            ec_pad = jnp.zeros(tuple(s + 2 for s in rc.shape),
                               padded.dtype)
            for _ in range(gamma):
                ec_pad = cycle(ec_pad, rc_scaled, rc, level + 1)
            e = pin(_prolong_lin(ec_pad[tuple(slice(1, s - 1)
                                              for s in ec_pad.shape)]),
                    level)
            idx = tuple(slice(1, s - 1) for s in padded.shape)
            padded = padded.at[idx].add(e)
            return smooth(padded, f_scaled, f, inv_h2, nu2)

        return cycle

    def _vcycle_fn(self):
        """The whole-hierarchy V-cycle: (padded_u, f) -> padded_u.
        Trace-time recursion over static level shapes."""
        h0 = float(self.problem.h)
        cycle = self._make_cycle()

        def vcycle(padded_u, f):
            f_scaled = (h0 * h0) * f
            return cycle(padded_u, f_scaled, f, 0)

        return vcycle

    def runner(self, f) -> Runner:
        """Registry Runner: ``iterate(grid, n)`` = n V-cycles (so
        ``solver.solve`` drives MG with its usual chunked-residual
        protocol; use ``check_every=1``)."""
        f_dev = as_device_array(f, self.problem.dtype)
        if f_dev.shape != tuple(self.problem.shape):
            raise ValueError(
                f"source shape {f_dev.shape} != interior "
                f"{self.problem.shape}")
        vcycle = self._vcycle_fn()

        @jax.jit
        def iterate_impl(padded_u, f_arr, n):
            return jax.lax.fori_loop(
                0, n, lambda _, p: vcycle(p, f_arr), padded_u)

        def iterate(grid: HaloGrid, n: int) -> HaloGrid:
            if grid.halo != 1:
                raise ValueError("multigrid expects halo=1 grids")
            data = iterate_impl(grid.data, f_dev, jnp.int32(n))
            return HaloGrid(data=data, halo=1, bc=grid.bc)

        info = {"levels": self.levels,
                "level_shapes": [list(s) for s in self._shapes],
                "nu": (self.nu1, self.nu2),
                "omega": self.omega,
                "smoother": self.smoother,
                "gamma": self.gamma}
        return Runner(
            name=f"multigrid({self.levels} levels)",
            iterate=iterate,
            description="geometric V-cycle (weighted-Jacobi smoother, "
                        "full-weighting / linear transfers)",
            plan_info=info,
        )

    def _level_shardings(self, mesh, dim: int = 0,
                         replicate_below: Optional[int] = None):
        """Per-level ``NamedSharding``s for the hierarchy over a 1D/2D
        mesh: levels at least ``replicate_below`` interior points wide
        along ``dim`` shard on the mesh axis, the rest replicate.
        Returns ``(shardings, sharded_flags, replicate_below)``; shared
        by ``sharded_runner`` and the distributed PCG
        (``krylov.ConjugateGradient.solve(mesh=...)``)."""
        return _level_shardings_for(self._shapes,
                                    self.problem.ndim, mesh, dim,
                                    replicate_below)

    def sharded_runner(self, f, mesh, dim: int = 0,
                       replicate_below: Optional[int] = None) -> Runner:
        """Distributed V/W-cycle over a 1D or 2D ``jax.sharding.Mesh``.

        Shape: the whole hierarchy stays ONE jitted SPMD
        computation — each level's arrays carry a
        ``with_sharding_constraint`` along grid dim ``dim`` and XLA's
        SPMD partitioner inserts the halo collectives the neighbor-sum
        slices need (no hand-written exchange; contrast
        ``parallel/halo.py``, which is the explicit-ppermute analog for
        the plain-sweep methods). Vertex-centered coarsening halves the
        sharded width per level; once a level is narrower than
        ``replicate_below`` interior points it is constrained
        REPLICATED — every device redundantly relaxes the (tiny) coarse
        tail instead of chattering per-sweep halos across it, the
        standard redundant-coarse-solve design. Levels above the
        threshold stay sharded even when their width does not divide
        the mesh (GSPMD shards unevenly by padding).

        ``f`` may be host or device resident; it is pinned to the fine
        level's sharding inside the jitted cycle (the odd vertex-
        centered widths shard UNEVENLY, which ``with_sharding_constraint``
        takes and eager ``device_put`` refuses). ``iterate`` accepts
        grids on any placement (level-0's constraint reshards on entry).
        """
        shardings, sharded_levels, replicate_below = \
            self._level_shardings(mesh, dim, replicate_below)
        nsh = int(np.prod(mesh.devices.shape))

        def constrain(arr, level):
            return jax.lax.with_sharding_constraint(arr, shardings[level])

        cycle = self._make_cycle(constrain)
        h0 = float(self.problem.h)
        f_dev = as_device_array(f, self.problem.dtype)
        if f_dev.shape != tuple(self.problem.shape):
            raise ValueError(
                f"source shape {f_dev.shape} != interior "
                f"{self.problem.shape}")

        @jax.jit
        def iterate_impl(padded_u, f_arr, n):
            f_arr = constrain(f_arr, 0)
            f_scaled = constrain((h0 * h0) * f_arr, 0)
            return jax.lax.fori_loop(
                0, n, lambda _, p: cycle(p, f_scaled, f_arr, 0), padded_u)

        def iterate(grid: HaloGrid, n: int) -> HaloGrid:
            if grid.halo != 1:
                raise ValueError("multigrid expects halo=1 grids")
            data = iterate_impl(grid.data, f_dev, jnp.int32(n))
            return HaloGrid(data=data, halo=1, bc=grid.bc)

        info = {"levels": self.levels,
                "level_shapes": [list(s) for s in self._shapes],
                "nu": (self.nu1, self.nu2),
                "omega": self.omega,
                "smoother": self.smoother,
                "gamma": self.gamma,
                "partitioner": "gspmd",
                "mesh": list(mesh.devices.shape),
                "sharded_dim": dim,
                "sharded_levels": sharded_levels,
                "replicate_below": list(replicate_below)}
        return Runner(
            name=f"multigrid_sharded({self.levels} levels, "
                 f"{nsh}-device mesh)",
            iterate=iterate,
            description="distributed geometric V-cycle (GSPMD-sharded "
                        "levels, redundant replicated coarse tail)",
            plan_info=info,
        )

    def fmg(self, f, n_vcycles: int = 2) -> HaloGrid:
        """Full multigrid: coarse-to-fine initialization that reaches
        discretization-level error in ONE pass (then ``runner``'s
        V-cycles refine further if asked).

        Every level solves the full problem with its own exact walls
        (see ``_fmg_build``); the whole pass — RHS restriction chain,
        coarsest relax, ghost-aware prolongation, per-level V-cycles —
        is one jitted XLA computation. The FMG prolongation is linear
        (order 2 = the discretization order, the textbook minimum).

        ``n_vcycles=2`` is the reliable default HERE, not pessimism:
        the FMG bound needs the per-level error amplification
        ``4 delta^nu < 1`` (factor 4 = the h^2 ratio between levels);
        this stack's V(2,2) contraction is measured delta ~ 0.25-0.3 in
        3D, so nu=1 sits AT the divergence threshold (measured 7-9x the
        converged discrete error) while nu=2 lands below it (~0.3 h^2,
        error-cancellation range; measured 31^3/63^3, fp32).
        """
        f_dev = as_device_array(f, self.problem.dtype)
        if f_dev.shape != tuple(self.problem.shape):
            raise ValueError(
                f"source shape {f_dev.shape} != interior "
                f"{self.problem.shape}")
        G = self.problem.initial_grid()
        n_vcycles = int(n_vcycles)
        fn = self._fmg_cache.get(n_vcycles)
        if fn is None:
            # f enters the pass as a traced argument, so one build
            # serves every f
            fn = self._fmg_build(n_vcycles)
            self._fmg_cache[n_vcycles] = fn
        return HaloGrid(data=fn(G.data, f_dev), halo=1, bc=G.bc)

    def _fmg_build(self, n_vcycles: int):
        """One jitted FMG pass ``(G_padded, f) -> padded_u``.

        Every level solves the FULL problem with its OWN pinned walls
        (vertex-centered levels share physical walls: level l's padded
        template is the fine template subsampled at even indices), so
        level solutions stay smooth and linear interpolation between
        levels holds its O(h^2) accuracy — homogenizing the walls
        instead would hand FMG a boundary-layer solution that linear
        prolongation cannot represent (measured: ~2% wall error).
        ``f`` is full-weighting-restricted down; the coarsest level is
        relaxed from the zero-interior template; each finer level is
        initialized by the ghost-aware prolongation and polished with
        ``n_vcycles`` V-cycles (level 0's are the runner's own)."""
        cycle = self._make_cycle()
        vcycle = self._vcycle_fn()
        n_levels = self.levels
        ndim = self.problem.ndim
        h0 = float(self.problem.h)

        def fmg_pass(G_padded, f):
            tmpl = [G_padded]
            fs = [f]
            for _ in range(n_levels - 1):
                tmpl.append(tmpl[-1][(slice(None, None, 2),) * ndim])
                fs.append(_restrict_fw(fs[-1]))
            h_c = h0 * (2.0 ** (n_levels - 1))
            u = cycle(tmpl[-1], (h_c * h_c) * fs[-1], fs[-1],
                      n_levels - 1)
            for level in range(n_levels - 2, -1, -1):
                u = _prolong_full(u)
                # exact walls: the prolongation interpolates ghost faces
                # between injected points; re-seat the interior into the
                # level's template (which carries the true face values)
                idx = tuple(slice(1, s - 1) for s in u.shape)
                u = tmpl[level].at[idx].set(u[idx])
                if level == 0:
                    for _ in range(n_vcycles):
                        u = vcycle(u, fs[0])
                else:
                    h_l = h0 * (2.0 ** level)
                    for _ in range(n_vcycles):
                        u = cycle(u, (h_l * h_l) * fs[level],
                                  fs[level], level)
            return u

        return jax.jit(fmg_pass)

    def residual_norm(self, grid: HaloGrid, f) -> float:
        """max |f - A u| on the fine level (true algebraic residual —
        unlike the solver's update-norm this certifies the solution).

        fp32 floor: evaluating A u rounds at ``eps * 2 ndim |u| / h^2``,
        so the achievable residual is ~``1e-4 .. 1e-2 * |f|`` depending on
        grid size (measured 255^3: 3.7e-3 relative) — the SOLUTION keeps
        converging to discretization error regardless; use the solver's
        update-norm tolerance for stopping and this as the certificate."""
        fn = _residual_norm_fn(self.problem.shape, self.problem.dtype,
                               float(self.problem.h), self.problem.ndim)
        return float(fn(grid.data,
                        as_device_array(f, self.problem.dtype)))

    def solve(self, f, tolerance: float = 1e-6,
              max_cycles: int = 50, progress=None):
        """Run V-cycles until the per-cycle update norm < tolerance;
        returns ``solver.SolveResult`` (iterations = cycles)."""
        from stencil_tpu import solver

        return solver.solve(self.runner(f), self.problem.initial_grid(),
                            tolerance=tolerance,
                            max_iterations=max_cycles, check_every=1,
                            progress=progress)


@dataclasses.dataclass(frozen=True)
class OperatorMultigrid:
    """Geometric multigrid for a GENERAL (possibly nonsymmetric) stencil
    operator, built by per-level REDISCRETIZATION — the preconditioning
    cycle for ``krylov.BiCGStab`` on steady advection-diffusion.

    Where ``Multigrid`` hardcodes the Poisson star (and its Jacobi
    splitting, wall handling, FMG machinery), this class asks the
    problem for its operator AT EVERY LEVEL via
    ``problem.with_discretization(shape, h)`` — each level applies the
    same continuous operator discretized at its own spacing (a
    central-scheme fine level falls back to upwind on levels whose
    coarser h breaks monotonicity — the problem's hook decides). The
    smoother is damped point Jacobi on the level operator's CONSTANT
    diagonal (its center tap); transfers are the same full-weighting /
    linear pair as the Poisson stack. Everything is interior-shaped
    with zero walls: the cycle only ever solves correction equations.

    Not a standalone solver by design: plain MG iteration on a
    nonsymmetric operator can stall once advection dominates a level's
    smoother; wrapped as a preconditioner inside BiCGStab the cycle
    only needs to APPROXIMATE the inverse, and the Krylov recurrence
    supplies the robustness (measured: it collapses the 255^3
    advection-dominated iteration count by an order of magnitude —
    `results/ROUND4.md`)."""

    problem: object
    nu1: int = 2
    nu2: int = 2
    omega: float = 2.0 / 3.0
    coarse_sweeps: int = 32
    min_size: int = 3
    gamma: int = 1

    def __post_init__(self):
        if self.gamma not in (1, 2):
            raise ValueError("gamma must be 1 (V-cycle) or 2 (W-cycle)")
        if self.nu1 < 0 or self.nu2 < 0 or self.nu1 + self.nu2 == 0:
            raise ValueError("need nu1 + nu2 >= 1 smoothing sweeps")
        shapes = _level_shapes(tuple(self.problem.shape), self.min_size)
        h0 = float(self.problem.h)
        probs = tuple(
            self.problem.with_discretization(shp, h0 * (2.0 ** lvl))
            for lvl, shp in enumerate(shapes))
        for lvl, p in enumerate(probs):
            try:
                p.operator_inv_diagonal(None)
            except ValueError as e:
                raise ValueError(f"level {lvl}: {e}") from e
            except TypeError:
                pass  # diagonal needs runtime data (field operators)
        object.__setattr__(self, "_shapes", shapes)
        object.__setattr__(self, "_probs", probs)
        object.__setattr__(self, "_datas_cache", None)

    @property
    def levels(self) -> int:
        return len(self._probs)

    def _level_shardings(self, mesh, dim: int = 0,
                         replicate_below: Optional[int] = None):
        """Per-level shardings over a 1D/2D mesh — the same replicated-
        coarse-tail policy as ``Multigrid`` (shared helper); consumed
        by distributed preconditioned BiCGStab."""
        return _level_shardings_for(self._shapes,
                                    len(self.problem.shape), mesh, dim,
                                    replicate_below)

    def _level_datas(self):
        """Per-level runtime operator data (None for constant-tap
        operators; the stacked weight-field arrays for field
        operators). Built once and cached — these are device arrays
        that must be THREADED through the jitted solve as arguments,
        never closed over (a captured concrete array embeds in the
        compile payload — see the dev-notes jit-constant gotcha)."""
        if self._datas_cache is None:
            object.__setattr__(
                self, "_datas_cache",
                tuple(p.operator_data() for p in self._probs))
        return self._datas_cache

    def _make_cycle(self, constrain=None):
        """``cycle(x, f, level, datas) -> x`` over interior-shaped
        zero-wall arrays; trace-time recursion (one jit holds the
        hierarchy). ``datas`` is the ``_level_datas()`` tuple, passed
        as a traced argument. ``constrain(arr, level)`` (optional)
        re-anchors each level's arrays to its sharding — the
        distributed-preconditioning hook."""
        probs = self._probs
        nu1, nu2 = int(self.nu1), int(self.nu2)
        omega = float(self.omega)
        coarse = int(self.coarse_sweeps)
        gamma = int(self.gamma)
        n_levels = self.levels

        def pin(a, level):
            return constrain(a, level) if constrain is not None else a

        def A(e, level, data):
            return probs[level].operator_apply(jnp.pad(e, 1), data)

        def smooth(x, f, level, data, n):
            w = omega * probs[level].operator_inv_diagonal(data)
            for _ in range(n):
                x = x + w * (f - A(x, level, data))
            return x

        def cycle(x, f, level, datas):
            x = pin(x, level)
            if level == n_levels - 1:
                return smooth(x, f, level, datas[level],
                              coarse if n_levels > 1
                              else max(coarse, nu1 + nu2))
            x = smooth(x, f, level, datas[level], nu1)
            rc = pin(_restrict_fw(f - A(x, level, datas[level])),
                     level + 1)
            ec = jnp.zeros_like(rc)
            for _ in range(gamma):
                ec = cycle(ec, rc, level + 1, datas)
            x = x + pin(_prolong_lin(ec), level)
            return smooth(x, f, level, datas[level], nu2)

        return cycle
