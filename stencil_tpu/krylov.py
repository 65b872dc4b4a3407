"""Matrix-free Krylov solvers: conjugate gradients for the SPD Poisson
operator (optionally multigrid-preconditioned — the production-standard
companion to the geometric-multigrid stack in ``multigrid.py``), and
``BiCGStab`` for nonsymmetric stencil operators (steady
advection-diffusion, ``models/advection_diffusion.py``).

Nothing in the reference corresponds (its only iteration is the plain
Jacobi sweep, ``/root/reference/src/stencil/stencil.cpp:85-125``); this
is a time-to-solution capability on the same discretization: where plain
relaxation needs O(n^2) sweeps and a V-cycle contracts at a fixed ~0.2
per cycle, MG-preconditioned CG squeezes the same contraction into
fewer, cheaper certificates and is robust where the smoother's
contraction degrades (anisotropy, large jumps in h).

Shape: the ENTIRE solve — operator applications, dot products, the
preconditioning V-cycle, the convergence test — is one jitted
``lax.while_loop``. The scalar residual never crosses to the host
mid-solve; exactly one device->host fetch returns the result.

Formulation: the discrete operator ``A = -L`` (``L u ~ (nb_sum(u) -
2 ndim u)/h^2``) is SPD on the zero-Dirichlet interior, so CG applies.
Nonzero walls are handled in correction form: ``u = u0 + e`` with
``u0`` the wall-pinned zero-interior grid, ``A e = -(f - L u0)``
solved with the ZERO-wall operator (pad-with-zeros), then ``e`` is
seated back into the pinned grid.

Preconditioner: one multigrid cycle per CG iteration, applied to the
current residual as a zero-walled correction solve (``Multigrid``'s own
cycle closure — V or W per its ``gamma``). With symmetric smoothing
(``nu1 == nu2``, weighted Jacobi) and full-weighting/linear transfers
(restriction proportional to prolongation-transpose) the cycle is a
symmetric positive operator, as textbook PCG requires.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from stencil_tpu.core.grid import HaloGrid, as_device_array
from stencil_tpu.models.poisson import PoissonProblem
from stencil_tpu.multigrid import Multigrid, _nb_sum, _residual


@dataclasses.dataclass(frozen=True)
class CGResult:
    grid: HaloGrid
    iterations: int
    residual: float          # final ||f - L u||_2 (absolute)
    residual_rel: float      # relative to ||b||_2
    converged: bool

    def summary(self) -> str:
        return (f"{'converged' if self.converged else 'NOT converged'} "
                f"in {self.iterations} iterations, "
                f"|r|_2 = {self.residual:.3e} "
                f"(rel {self.residual_rel:.3e})")


def _fine_sharding(mesh, dim: int, ndim: int):
    """The unpreconditioned solvers' Krylov-vector sharding: mesh axis
    ``a`` shards grid dim ``dim + a`` (1D or 2D meshes). Preconditioned
    solves instead inherit the cycle's per-level ladder
    (``multigrid._level_shardings_for``)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    naxes = len(mesh.axis_names)
    if naxes not in (1, 2):
        raise ValueError(
            f"distributed Krylov wants a 1D or 2D mesh, got axes "
            f"{mesh.axis_names}")
    if not 0 <= dim <= ndim - naxes:
        raise ValueError(
            f"mesh axes {mesh.axis_names} shard grid dims "
            f"{dim}..{dim + naxes - 1}, out of range for {ndim}D")
    spec = [None] * ndim
    for a, axis in enumerate(mesh.axis_names):
        spec[dim + a] = axis
    return NamedSharding(mesh, P(*spec))


def _initial_or(problem, initial: Optional[HaloGrid]) -> HaloGrid:
    """The warm-start iterate, validated, or the problem's zero-interior
    wall-pinned grid."""
    if initial is None:
        return problem.initial_grid()
    if initial.halo != 1:
        raise ValueError("warm-start grids must have halo=1")
    if initial.interior_shape != tuple(problem.shape):
        raise ValueError(
            f"warm-start interior {initial.interior_shape} != "
            f"{tuple(problem.shape)}")
    if initial.bc != problem.bc:
        raise ValueError(
            "warm-start grid carries different boundary conditions "
            "than the problem")
    return initial


@dataclasses.dataclass(frozen=True)
class ConjugateGradient:
    """CG / MG-preconditioned CG for a ``PoissonProblem`` (Dirichlet
    walls only — same well-posedness condition as ``Multigrid``).

    ``preconditioner=None`` gives plain CG; pass a ``Multigrid`` built
    on the SAME problem for PCG (one cycle per iteration; keep
    ``nu1 == nu2`` so the preconditioner is symmetric).
    """

    problem: PoissonProblem
    preconditioner: Optional[Multigrid] = None
    # run the preconditioning cycle's ARRAYS in this dtype (e.g.
    # 'bfloat16': every level's iterate/residual/transfer halves its
    # HBM traffic; the cycle only has to APPROXIMATE A^-1, so low
    # precision costs at most an extra iteration while the Krylov
    # recurrence and its certificate stay in the problem dtype).
    # None = the problem dtype.
    precond_dtype: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "_fn_cache", {})
        if self.problem.bc.any_dynamic:
            raise ValueError(
                "CG needs the SPD Dirichlet operator (the pure "
                "periodic/Neumann Poisson problem is singular)")
        if self.precond_dtype is not None:
            if self.preconditioner is None:
                raise ValueError(
                    "precond_dtype needs a preconditioner")
        mg = self.preconditioner
        if mg is not None:
            if mg.problem.shape != self.problem.shape or \
                    float(mg.problem.h) != float(self.problem.h):
                raise ValueError(
                    "preconditioner built on a different problem "
                    f"({mg.problem.shape}, h={mg.problem.h}) than "
                    f"({self.problem.shape}, h={self.problem.h})")
            if mg.nu1 != mg.nu2:
                raise ValueError(
                    "PCG needs a symmetric preconditioner: build the "
                    f"Multigrid with nu1 == nu2 (got {mg.nu1}, {mg.nu2})")

    def _solve_fn(self, tolerance: float, max_iterations: int,
                  mesh=None, dim: int = 0,
                  replicate_below: Optional[int] = None):
        ndim = self.problem.ndim
        h = float(self.problem.h)
        inv_h2 = 1.0 / (h * h)
        two_d = float(2 * ndim)
        tol2 = float(tolerance) ** 2
        maxit = jnp.int32(max_iterations)
        if mesh is None:
            cycle = (self.preconditioner._make_cycle()
                     if self.preconditioner is not None else None)

            def pin(a):
                return a
        elif self.preconditioner is not None:
            # distributed PCG: the Krylov vectors carry the fine
            # level's sharding, the preconditioning cycle its full
            # per-level sharding ladder (same GSPMD design as
            # Multigrid.sharded_runner — XLA inserts the halo
            # collectives; dot products become all-reduces)
            shardings, _, _ = self.preconditioner._level_shardings(
                mesh, dim, replicate_below)

            def constrain(arr, level):
                return jax.lax.with_sharding_constraint(
                    arr, shardings[level])

            cycle = self.preconditioner._make_cycle(constrain)

            def pin(a):
                return jax.lax.with_sharding_constraint(a, shardings[0])
        else:
            # distributed plain CG: fine sharding only
            s0 = _fine_sharding(mesh, dim, ndim)
            cycle = None

            def pin(a):
                return jax.lax.with_sharding_constraint(a, s0)

        def A(e):  # zero-wall SPD operator on interior-shaped arrays
            return (two_d * e - _nb_sum(jnp.pad(e, 1))) * inv_h2

        pdt = (np.dtype(self.precond_dtype)
               if self.precond_dtype is not None else None)

        def precond(r):
            # one MG cycle on the zero-walled correction problem
            # L e ~ r  =>  A^-1 r ~ -e  (cycle is linear in (0, rhs))
            if cycle is None:
                return r
            rdt = r.dtype
            rc = r.astype(pdt) if pdt is not None else r
            e_pad = cycle(jnp.zeros(tuple(s + 2 for s in r.shape),
                                    rc.dtype),
                          (h * h) * rc, rc, 0)
            if pdt is not None:
                e_pad = e_pad.astype(rdt)
            return -e_pad[tuple(slice(1, s - 1) for s in e_pad.shape)]

        def dot(a, b):
            return jnp.sum(a * b)

        @jax.jit
        def solve(padded0, f):
            # b = -(f - L u0): the zero-wall correction RHS
            b = pin(-_residual(padded0, f, inv_h2, two_d))
            bb = dot(b, b)
            x = jnp.zeros_like(b)
            r = b
            z = pin(precond(r))
            p = z
            rz = dot(r, z)

            def cond(st):
                x, r, p, rz, k = st
                return (dot(r, r) > tol2 * bb) & (k < maxit)

            def body(st):
                x, r, p, rz, k = st
                q = pin(A(p))
                alpha = rz / dot(p, q)
                x = x + alpha * p
                r = r - alpha * q
                z = pin(precond(r))
                rz_new = dot(r, z)
                p = z + (rz_new / rz) * p
                return (x, r, p, rz_new, k + 1)

            x, r, p, rz, k = jax.lax.while_loop(
                cond, body, (x, r, p, rz, jnp.int32(0)))
            idx = tuple(slice(1, s - 1) for s in padded0.shape)
            padded = padded0.at[idx].add(x)
            rr = dot(r, r)
            # ONE stats vector -> ONE device->host fetch (three scalar
            # fetches would be three round trips per solve)
            stats = jnp.stack([
                k.astype(jnp.float32),
                jnp.sqrt(rr).astype(jnp.float32),
                jnp.sqrt(rr / bb).astype(jnp.float32),
            ])
            return padded, stats

        return solve

    def solve(self, f, tolerance: float = 1e-5,
              max_iterations: int = 1000, mesh=None, dim: int = 0,
              replicate_below: Optional[int] = None,
              initial: Optional[HaloGrid] = None) -> CGResult:
        """Solve to ``||r||_2 <= tolerance * ||b||_2`` (relative
        2-norm; fp32 floors near ~1e-6 — see
        ``Multigrid.residual_norm`` for the rounding argument).

        ``mesh`` (a 1D or 2D ``jax.sharding.Mesh``) distributes the
        solve: Krylov vectors shard along grid dims ``dim..`` (one per
        mesh axis), the
        preconditioning cycle runs its per-level sharding ladder
        (replicated coarse tail), dot products become all-reduces —
        all inside the same single jitted while_loop.

        ``initial`` warm-starts from an existing iterate (time
        stepping, FMG polish). NOTE the convergence baseline follows:
        ``b`` is the residual OF THE INITIAL GUESS (the correction
        form's rhs), so ``tolerance`` then means "contract the initial
        residual by this factor" — the standard r0-relative Krylov
        semantics."""
        f_dev = as_device_array(f, self.problem.dtype)
        if f_dev.shape != tuple(self.problem.shape):
            raise ValueError(
                f"source shape {f_dev.shape} != interior "
                f"{self.problem.shape}")
        g0 = _initial_or(self.problem, initial)
        key = (float(tolerance), int(max_iterations), mesh, dim,
               replicate_below)
        fn = self._fn_cache.get(key)
        if fn is None:
            fn = self._solve_fn(tolerance, max_iterations, mesh, dim,
                                replicate_below)
            self._fn_cache[key] = fn
        padded, stats = fn(g0.data, f_dev)
        stats = np.asarray(stats)  # single fetch
        rrel = float(stats[2])
        return CGResult(
            grid=HaloGrid(data=padded, halo=1, bc=g0.bc),
            iterations=int(stats[0]),
            residual=float(stats[1]),
            residual_rel=rrel,
            converged=bool(rrel <= tolerance),
        )


@dataclasses.dataclass(frozen=True)
class BiCGStab:
    """Stabilized bi-conjugate gradients for NONSYMMETRIC stencil
    operators — the Krylov method for the operator class CG's SPD
    precondition rules out (steady advection-diffusion's upwind/central
    transport taps, ``models/advection_diffusion.py``).

    ``problem`` is any model exposing ``shape``/``dtype``/``bc``/
    ``initial_grid()`` and the discrete operator as taps
    (``operator_spec``) — ``AdvectionDiffusionProblem`` natively, and
    ``PoissonProblem`` too (on the symmetric case BiCGStab lands on
    CG's solution; differential-tested). Pass
    ``preconditioner=multigrid.OperatorMultigrid(problem)`` for the
    rediscretized-cycle right preconditioning (measured: collapses the
    iteration count by ~an order of magnitude in both the diffusion-
    and advection-dominated regimes).

    Same shape as CG: the whole solve — two operator
    applications and four dot products per iteration, the convergence
    test — is ONE jitted ``lax.while_loop``; one device->host fetch
    returns the result. Nonzero Dirichlet walls ride the same
    correction form (``u = u0 + e`` with the zero-wall operator on
    ``e``). The final residual is re-evaluated from the SOLUTION (not
    the recurrence) inside the jit, so the certificate is immune to the
    recurrence drift BiCGStab is known for.

    Breakdown handling: the van der Vorst recurrence divides by
    ``<rhat, r>``, ``<rhat, v>`` and ``<t, t>``; an exact zero is
    guarded to the dtype's tiny (a true breakdown then stalls the
    residual and the iteration cap reports ``converged=False`` with the
    honest certificate), and the half-step exit (``|s|`` already below
    tolerance) skips the stabilization step whose ``<t, t>`` is
    degenerate at convergence.

    Restarts: after a few hundred fp32 iterations the recurrence
    residual drifts from the true one (measured at 255^3,
    advection-dominated: recurrence said 5e-5 while the solution's
    residual was 5e-4). When the certificate misses the tolerance, the
    solve RESTARTS from the current solution — the next call recomputes
    ``b = f - A u`` exactly, resetting the drift — while the relative
    tolerance stays anchored to the ORIGINAL ``||b||`` (a restart must
    not rebaseline convergence to its own residual). Restarts reuse
    the same compiled function; the iteration budget is shared.
    """

    problem: object
    # a multigrid.OperatorMultigrid built on the SAME problem: its
    # rediscretized cycle right-preconditions the recurrence (two
    # cycle applications per iteration), collapsing the iteration
    # count by ~an order of magnitude on advection-diffusion
    preconditioner: Optional[object] = None

    def __post_init__(self):
        object.__setattr__(self, "_fn_cache", {})
        if self.problem.bc.any_dynamic:
            raise ValueError(
                "BiCGStab solves Dirichlet-wall problems (the "
                "periodic/Neumann steady operator annihilates "
                "constants and is singular)")
        mg = self.preconditioner
        if mg is not None:
            if tuple(mg.problem.shape) != tuple(self.problem.shape) \
                    or float(mg.problem.h) != float(self.problem.h):
                raise ValueError(
                    "preconditioner built on a different problem "
                    f"({tuple(mg.problem.shape)}, h={mg.problem.h}) "
                    f"than ({tuple(self.problem.shape)}, "
                    f"h={self.problem.h})")

    def _solve_fn(self, tolerance: float, mesh=None, dim: int = 0,
                  replicate_below: Optional[int] = None):
        ndim = len(self.problem.shape)
        # the loop watches the RECURRENCE residual but the certificate
        # is re-evaluated from the solution; exit 2x tighter so the
        # (slightly larger) true residual lands under the requested
        # tolerance instead of a hair above it
        tol2 = (0.5 * float(tolerance)) ** 2

        constrain = None
        if mesh is None:
            def pin(a):
                return a
        elif self.preconditioner is not None:
            # distributed preconditioned BiCGStab: Krylov vectors carry
            # the fine sharding, the rediscretized cycle its per-level
            # ladder (replicated coarse tail), dots -> all-reduces —
            # the same GSPMD design as distributed PCG
            shardings, _, _ = self.preconditioner._level_shardings(
                mesh, dim, replicate_below)

            def constrain(arr, level):
                return jax.lax.with_sharding_constraint(
                    arr, shardings[level])

            def pin(a):
                return jax.lax.with_sharding_constraint(a, shardings[0])
        else:
            s0 = _fine_sharding(mesh, dim, ndim)

            def pin(a):
                return jax.lax.with_sharding_constraint(a, s0)

        apply_op = self.problem.operator_apply

        if self.preconditioner is not None:
            mg_cycle = self.preconditioner._make_cycle(constrain)
        else:
            mg_cycle = None

        def dot(a, b):
            return jnp.sum(a * b)

        def safe(d):
            tiny = jnp.asarray(jnp.finfo(d.dtype).tiny, d.dtype)
            return jnp.where(d == 0, tiny, d)

        @jax.jit
        def solve(padded0, f, budget, bb_ref, op_data, kdatas):
            # op_data / kdatas: the problem's and the preconditioner
            # hierarchy's runtime operator arrays (None for constant-
            # tap operators) — THREADED as arguments so field operators
            # never embed in the compile payload

            def A(e):  # zero-wall operator on interior-shaped arrays
                return apply_op(jnp.pad(e, 1), op_data)

            if mg_cycle is not None:
                def K(r):  # right preconditioner: one cycle ~ A^-1 r
                    return mg_cycle(jnp.zeros_like(r), r, 0, kdatas)
            else:
                def K(r):
                    return r

            # b = f - A u0 with the TRUE walls (u0's ghost ring); on a
            # restart padded0 is the current solution, so b is the
            # exact current residual — but convergence stays relative
            # to the ORIGINAL rhs norm (bb_ref > 0 carries it in)
            b = pin(f - apply_op(padded0, op_data))
            bb = jnp.where(bb_ref > 0, bb_ref, dot(b, b))
            one = jnp.asarray(1.0, b.dtype)
            zero = jnp.zeros_like(b)
            state = (zero, b, zero, zero, one, one, one, jnp.int32(0))

            def cond(st):
                x, r, p, v, rho, alpha, omega, k = st
                return (dot(r, r) > tol2 * bb) & (k < budget)

            def body(st):
                x, r, p, v, rho, alpha, omega, k = st
                rho_new = dot(b, r)          # rhat = r0 = b
                beta = (rho_new / safe(rho)) * (alpha / safe(omega))
                p = pin(r + beta * (p - omega * v))
                y = K(p)                     # right-preconditioned
                v = pin(A(y))
                alpha = rho_new / safe(dot(b, v))
                s = r - alpha * v
                ss = dot(s, s)
                z = K(s)
                t = pin(A(z))
                # half-step exit: s below tolerance -> skip the
                # stabilization step (its <t,t> is degenerate there);
                # omega = 0 leaves x += alpha y, r = s, loop exits
                omega = jnp.where(ss <= tol2 * bb,
                                  jnp.asarray(0.0, b.dtype),
                                  dot(t, s) / safe(dot(t, t)))
                x = x + alpha * y + omega * z
                r = s - omega * t
                return (x, r, p, v, rho_new, alpha, omega, k + 1)

            x, r, p, v, rho, alpha, omega, k = jax.lax.while_loop(
                cond, body, state)
            idx = tuple(slice(1, s - 1) for s in padded0.shape)
            padded = padded0.at[idx].add(x)
            # certificate from the SOLUTION, not the recurrence
            r_true = f - apply_op(padded, op_data)
            rr = dot(r_true, r_true)
            # one stats vector -> one fetch per (re)start (see CG)
            stats = jnp.stack([
                k.astype(jnp.float32),
                jnp.sqrt(rr).astype(jnp.float32),
                jnp.sqrt(rr / bb).astype(jnp.float32),
                bb.astype(jnp.float32),
            ])
            return padded, stats

        return solve

    def solve(self, f, tolerance: float = 1e-5,
              max_iterations: int = 2000, mesh=None,
              dim: int = 0, restarts: int = 8,
              initial: Optional[HaloGrid] = None,
              replicate_below: Optional[int] = None) -> CGResult:
        """Solve ``A u = f`` to ``||f - A u||_2 <= tolerance * ||b||_2``
        (the certificate is the true residual of the returned solution;
        fp32 floors apply as for CG). ``mesh`` (1D or 2D) shards the
        Krylov vectors along grid dims ``dim..`` (one per mesh axis); dot products become
        all-reduces, the operator's halo slices GSPMD collectives.
        ``restarts`` bounds the drift-recovery restarts (see class
        docstring); ``max_iterations`` is the TOTAL budget across
        them. ``initial`` warm-starts from an existing iterate; the
        tolerance is then relative to the INITIAL residual (r0-relative
        Krylov semantics, same as CG's warm start)."""
        f_dev = as_device_array(f, self.problem.dtype)
        if f_dev.shape != tuple(self.problem.shape):
            raise ValueError(
                f"source shape {f_dev.shape} != interior "
                f"{self.problem.shape}")
        g0 = _initial_or(self.problem, initial)
        key = (float(tolerance), mesh, dim, replicate_below)
        fn = self._fn_cache.get(key)
        if fn is None:
            fn = self._solve_fn(tolerance, mesh, dim, replicate_below)
            self._fn_cache[key] = fn
        dtype = np.dtype(self.problem.dtype)
        op_data = self.problem.operator_data()
        kdatas = (self.preconditioner._level_datas()
                  if self.preconditioner is not None else None)
        padded = g0.data
        total = 0
        remaining = int(max_iterations)
        bb0 = 0.0
        for attempt in range(max(0, int(restarts)) + 1):
            padded, stats = fn(
                padded, f_dev, jnp.int32(remaining),
                jnp.asarray(bb0, dtype), op_data, kdatas)
            stats = np.asarray(stats)  # single fetch per (re)start
            k = int(stats[0])
            total += k
            remaining -= k
            rnorm = float(stats[1])
            rrel = float(stats[2])
            bb0 = float(stats[3])
            if rrel <= tolerance or remaining <= 0 or k == 0:
                break
        return CGResult(
            grid=HaloGrid(data=padded, halo=1, bc=g0.bc),
            iterations=total,
            residual=rnorm,
            residual_rel=rrel,
            converged=bool(rrel <= tolerance),
        )


@dataclasses.dataclass(frozen=True)
class GMRES:
    """Restarted GMRES(m) for nonsymmetric stencil operators — the
    long-recurrence member of the Krylov family (CG: SPD; BiCGStab:
    nonsymmetric short recurrence; GMRES: nonsymmetric with a
    monotonically non-increasing residual, the robust choice where
    BiCGStab's two-term recurrence is erratic or breaks down).

    Takes the same operator protocol as ``BiCGStab`` (``shape``/
    ``dtype``/``bc``/``initial_grid()``/``operator_spec``-or-field
    ``operator_apply``/``operator_data``) — constant-tap operators
    (``AdvectionDiffusionProblem``, ``PoissonProblem``) and field
    operators (``HeterogeneousPoissonProblem``) alike — and the same
    right preconditioning: pass ``multigrid.OperatorMultigrid`` (one
    rediscretized cycle per Arnoldi step; right preconditioning keeps
    the minimized residual the TRUE residual, so the in-loop estimate
    needs no back-transformation).

    Same shape as CG/BiCGStab: each restart cycle — up to ``restart``
    Arnoldi steps, classical Gram-Schmidt run TWICE (CGS2: two fat
    ``tensordot`` contractions per pass over the stacked basis, where
    modified Gram-Schmidt would serialize into ~j thin dependent dots;
    every contraction asks for ``Precision.HIGHEST``, so a GPU does not
    run them in TF32), the Givens-rotation least squares, the
    back substitution, and the basis recombination — is ONE jitted
    ``lax.while_loop``; one device->host fetch returns per cycle. The
    basis lives on device as a single ``(m+1,) + shape`` stack (memory
    note: ``(restart+1)`` interior-sized arrays — 17 x 66 MB at 255^3
    fp32 with the default m=16).

    Convergence watches the Givens residual estimate ``|g[j]|`` (exact
    in exact arithmetic) at half tolerance, then re-certifies from the
    SOLUTION; a cycle whose certificate misses restarts from the
    current iterate with the tolerance anchored to the ORIGINAL
    ``||b||`` — the same drift-proof restart contract as ``BiCGStab``.
    A (lucky) Arnoldi breakdown zeroes the estimate and exits the
    cycle; the certificate decides whether it was a true solution.

    Nothing in the reference corresponds (its only iteration is the
    plain Jacobi sweep, ``stencil.cpp:85-125``).
    """

    problem: object
    preconditioner: Optional[object] = None
    # Arnoldi steps per restart cycle (the Krylov subspace dimension m
    # in GMRES(m)). Memory and per-step Gram-Schmidt cost grow with m;
    # iteration count shrinks. With an OperatorMultigrid
    # preconditioner solves finish in ~3-8 steps, so small m suffices.
    restart: int = 16

    def __post_init__(self):
        object.__setattr__(self, "_fn_cache", {})
        if self.restart < 1:
            raise ValueError(f"restart must be >= 1, got {self.restart}")
        if self.problem.bc.any_dynamic:
            raise ValueError(
                "GMRES solves Dirichlet-wall problems (the "
                "periodic/Neumann steady operator annihilates "
                "constants and is singular)")
        mg = self.preconditioner
        if mg is not None:
            if tuple(mg.problem.shape) != tuple(self.problem.shape) \
                    or float(mg.problem.h) != float(self.problem.h):
                raise ValueError(
                    "preconditioner built on a different problem "
                    f"({tuple(mg.problem.shape)}, h={mg.problem.h}) "
                    f"than ({tuple(self.problem.shape)}, "
                    f"h={self.problem.h})")

    def _check_basis_budget(self, f_dev, mesh) -> None:
        """Refuse an ``(m+1) x grid`` Arnoldi basis that cannot fit in
        device memory BEFORE the allocator discovers it mid-solve.

        The basis is the solve's dominant allocation (restart=16 at
        511^3 fp32 is ~9 GiB); the working set on top (padded iterate,
        rhs, w, the preconditioner hierarchy, and XLA's while_loop
        double-buffering of V) takes the practical ceiling well below
        capacity, so gate at half of the device's memory limit. A
        sharded solve divides the basis across the mesh devices. A
        device that reports no limit (the CPU backend) is not gated."""
        import math

        from stencil_tpu import platform

        limit = platform.device_memory_bytes()
        if limit is None:
            return
        n_dev = 1 if mesh is None else int(np.prod(mesh.devices.shape))
        per_vec = (math.prod(f_dev.shape) * f_dev.dtype.itemsize
                   // n_dev)
        basis = (self.restart + 1) * per_vec
        budget = limit // 2
        if basis > budget:
            fit = max(1, budget // per_vec - 1)
            raise ValueError(
                f"GMRES basis (restart+1) x grid = {self.restart + 1} "
                f"x {f_dev.shape} {f_dev.dtype} = {basis / 2**30:.2f} "
                f"GiB per device exceeds half of device memory "
                f"({budget / 2**30:.2f} GiB of "
                f"{limit / 2**30:.0f} GiB). Reduce "
                f"restart to <= {fit}, shard the solve over a mesh, or "
                f"use BiCGStab (O(1) vectors)")

    def _solve_fn(self, tolerance: float, mesh=None, dim: int = 0,
                  replicate_below: Optional[int] = None):
        ndim = len(self.problem.shape)
        m = int(self.restart)
        # exit the Arnoldi loop on the recurrence estimate at half
        # tolerance; the certificate (true residual of the returned
        # solution) is what `converged` reports — same contract as
        # BiCGStab
        tol2 = (0.5 * float(tolerance)) ** 2

        constrain = None
        if mesh is None:
            def pin(a):
                return a
        elif self.preconditioner is not None:
            shardings, _, _ = self.preconditioner._level_shardings(
                mesh, dim, replicate_below)

            def constrain(arr, level):
                return jax.lax.with_sharding_constraint(
                    arr, shardings[level])

            def pin(a):
                return jax.lax.with_sharding_constraint(a, shardings[0])
        else:
            s0 = _fine_sharding(mesh, dim, ndim)

            def pin(a):
                return jax.lax.with_sharding_constraint(a, s0)

        apply_op = self.problem.operator_apply

        if self.preconditioner is not None:
            mg_cycle = self.preconditioner._make_cycle(constrain)
        else:
            mg_cycle = None

        def dot(a, b):
            return jnp.sum(a * b)

        def safe(d):
            tiny = jnp.asarray(jnp.finfo(d.dtype).tiny, d.dtype)
            return jnp.where(d == 0, tiny, d)

        # contraction axes: basis stack (m+1, *shape) against *shape
        ax_vw = (tuple(range(1, ndim + 1)), tuple(range(ndim)))
        hi = jax.lax.Precision.HIGHEST

        @jax.jit
        def solve(padded0, f, budget, bb_ref, op_data, kdatas):
            # op_data / kdatas threaded as arguments so field operators
            # never embed in the compile payload (see BiCGStab)

            def A(e):
                return apply_op(jnp.pad(e, 1), op_data)

            if mg_cycle is not None:
                def K(r):  # right preconditioner (LINEAR in r: the
                    # cycle from a zero initial guess — which is what
                    # lets the final recombination apply K to the
                    # basis COMBINATION instead of per-vector)
                    return mg_cycle(jnp.zeros_like(r), r, 0, kdatas)
            else:
                def K(r):
                    return r

            b = pin(f - apply_op(padded0, op_data))
            bb = jnp.where(bb_ref > 0, bb_ref, dot(b, b))
            beta = jnp.sqrt(dot(b, b))
            dt = b.dtype
            V = jnp.zeros((m + 1,) + b.shape, dt).at[0].set(
                b / safe(beta))
            H = jnp.zeros((m + 1, m), dt)
            cs = jnp.ones((m,), dt)
            sn = jnp.zeros((m,), dt)
            g = jnp.zeros((m + 1,), dt).at[0].set(beta)

            def make_body(pr):
                # CGS2: classical Gram-Schmidt, two passes — each pass
                # two stacked contractions instead of MGS's j dependent
                # thin dots. ``pr`` is the number of basis rows this
                # stage contracts: step j only needs rows 0..j (the
                # rest are still zero), so the Arnoldi loop runs in
                # doubling-prefix STAGES (4, 8, ..., m steps), each a
                # while_loop whose contractions slice V[:pr]
                # statically — measured round 4: the full-stack
                # contraction made gmres(16) 14% slower than gmres(8)
                # at 6 steps (ROUND4.md §23); the prefix stages remove
                # the m-independent cost for early steps.
                def body(st):
                    V, H, cs, sn, g, j = st
                    w = pin(A(K(V[j])))
                    Vp = V[:pr]
                    # rows > j of V are zero so the mask only guards
                    # exactness of the stored column
                    mask = (jnp.arange(pr) <= j).astype(dt)
                    h1 = mask * jnp.tensordot(Vp, w, axes=ax_vw,
                                              precision=hi)
                    w = w - jnp.tensordot(h1, Vp, axes=([0], [0]),
                                          precision=hi)
                    h2 = mask * jnp.tensordot(Vp, w, axes=ax_vw,
                                              precision=hi)
                    w = w - jnp.tensordot(h2, Vp, axes=([0], [0]),
                                          precision=hi)
                    hnorm = jnp.sqrt(dot(w, w))
                    V = V.at[j + 1].set(pin(w / safe(hnorm)))
                    hcol = jnp.zeros((m + 1,), dt).at[:pr].set(h1 + h2)
                    hcol = hcol.at[j + 1].set(hnorm)

                    # accumulated Givens rotations (i < j), then a new
                    # one zeroing the subdiagonal; |g| tracks the
                    # least-squares residual exactly
                    def rot(i, hc):
                        hi = cs[i] * hc[i] + sn[i] * hc[i + 1]
                        hi1 = -sn[i] * hc[i] + cs[i] * hc[i + 1]
                        on = i < j
                        return (hc.at[i].set(jnp.where(on, hi, hc[i]))
                                .at[i + 1].set(jnp.where(on, hi1,
                                                         hc[i + 1])))

                    hcol = jax.lax.fori_loop(0, m, rot, hcol)
                    denom = jnp.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
                    c = hcol[j] / safe(denom)
                    s = hcol[j + 1] / safe(denom)
                    hcol = hcol.at[j].set(denom).at[j + 1].set(0.0)
                    gj = g[j]
                    g = g.at[j + 1].set(-s * gj).at[j].set(c * gj)
                    return (V, H.at[:, j].set(hcol), cs.at[j].set(c),
                            sn.at[j].set(s), g, j + 1)

                return body

            caps = []
            p = 4
            while p < m:
                caps.append(p)
                p *= 2
            caps.append(m)
            st = (V, H, cs, sn, g, jnp.int32(0))
            for cap in caps:
                def cond(st, _cap=cap):
                    V, H, cs, sn, g, j = st
                    return ((g[j] * g[j] > tol2 * bb) & (j < _cap)
                            & (j < budget))

                st = jax.lax.while_loop(cond, make_body(cap + 1), st)
            V, H, cs, sn, g, jfin = st

            # back substitution on the rotated (upper-triangular) H,
            # masked to the jfin live columns; a breakdown row has
            # H[i, i] == 0 AND g[i] == 0, so safe() lands y_i = 0
            def back(t, y):
                i = m - 1 - t
                num = g[i] - jnp.dot(H[i, :], y, precision=hi)
                yi = jnp.where(i < jfin, num / safe(H[i, i]),
                               jnp.asarray(0.0, dt))
                return y.at[i].set(yi)

            y = jax.lax.fori_loop(0, m, back, jnp.zeros((m,), dt))
            update = jnp.tensordot(y, V[:m], axes=([0], [0]),
                                   precision=hi)
            idx = tuple(slice(1, s_ - 1) for s_ in padded0.shape)
            padded = padded0.at[idx].add(pin(K(update)))
            r_true = f - apply_op(padded, op_data)
            rr = dot(r_true, r_true)
            stats = jnp.stack([
                jfin.astype(jnp.float32),
                jnp.sqrt(rr).astype(jnp.float32),
                jnp.sqrt(rr / bb).astype(jnp.float32),
                bb.astype(jnp.float32),
            ])
            return padded, stats

        return solve

    def solve(self, f, tolerance: float = 1e-5,
              max_iterations: int = 2000, mesh=None, dim: int = 0,
              initial: Optional[HaloGrid] = None,
              replicate_below: Optional[int] = None,
              stall_ratio: Optional[float] = 0.9) -> CGResult:
        """Solve ``A u = f`` to ``||f - A u||_2 <= tolerance * ||b||_2``
        (true-residual certificate; fp32 floors as for CG).
        ``max_iterations`` is the TOTAL Arnoldi-step budget across
        restart cycles (each cycle runs at most ``self.restart``);
        ``max_iterations <= 0`` runs zero Arnoldi steps but still
        returns the honest certificate of the initial iterate (and
        ``converged=True`` if a warm start already meets tolerance) —
        same budget-0 contract as BiCGStab.
        ``mesh`` distributes the solve exactly as for BiCGStab;
        ``initial`` warm-starts with r0-relative tolerance semantics.
        ``stall_ratio`` stops restarting when a full cycle fails to
        contract the TRUE residual below ``stall_ratio * previous``
        (the fp32 certificate floor shows up as exactly such a stall);
        pass ``None`` to disable for legitimately slow-contracting
        unpreconditioned GMRES(m) near-stagnation regimes and spend the
        whole ``max_iterations`` budget."""
        f_dev = as_device_array(f, self.problem.dtype)
        if f_dev.shape != tuple(self.problem.shape):
            raise ValueError(
                f"source shape {f_dev.shape} != interior "
                f"{self.problem.shape}")
        self._check_basis_budget(f_dev, mesh)
        g0 = _initial_or(self.problem, initial)
        key = (float(tolerance), mesh, dim, replicate_below)
        fn = self._fn_cache.get(key)
        if fn is None:
            fn = self._solve_fn(tolerance, mesh, dim, replicate_below)
            self._fn_cache[key] = fn
        dtype = np.dtype(self.problem.dtype)
        op_data = self.problem.operator_data()
        kdatas = (self.preconditioner._level_datas()
                  if self.preconditioner is not None else None)
        padded = g0.data
        total = 0
        remaining = int(max_iterations)
        bb0 = 0.0
        rnorm = rrel = prev_rrel = float("inf")
        while True:
            # budget <= 0 still runs ONE cycle of zero Arnoldi steps:
            # the cycle computes and returns the true-residual
            # certificate of the current iterate (a warm start that
            # already meets tolerance reports converged=True)
            padded, stats = fn(
                padded, f_dev, jnp.int32(max(0, remaining)),
                jnp.asarray(bb0, dtype), op_data, kdatas)
            stats = np.asarray(stats)  # single fetch per cycle
            k = int(stats[0])
            total += k
            remaining -= k
            rnorm = float(stats[1])
            rrel = float(stats[2])
            bb0 = float(stats[3])
            if rrel <= tolerance or k == 0 or remaining <= 0:
                break
            # stall guard: the certificate is the TRUE residual of the
            # solution, which floors at fp32 rounding (~1e-6 relative,
            # higher for stiff inv_h2 operators) regardless of what the
            # Arnoldi recurrence reports — a cycle that fails to
            # improve it past stall_ratio means further cycles re-solve
            # rounding noise; stop and report honestly rather than
            # grinding the budget (cf. BiCGStab's bounded `restarts`)
            if stall_ratio is not None and rrel > stall_ratio * prev_rrel:
                break
            prev_rrel = rrel
        return CGResult(
            grid=HaloGrid(data=padded, halo=1, bc=g0.bc),
            iterations=total,
            residual=rnorm,
            residual_rel=rrel,
            converged=bool(rrel <= tolerance),
        )
