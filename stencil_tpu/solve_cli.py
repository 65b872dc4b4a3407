"""Solver CLI driver — name→solver dispatch for the steady-state stack.

The reference's entire UX is name→method dispatch from the command line
(``/root/reference/src/main.cpp:46-50``,
``src/stencil/stencil.cpp:61-66``); this module gives the solver stack
(multigrid / FMG / CG / PCG / BiCGStab / GMRES — capabilities the
reference lacks entirely) the same first-class surface: ``--solve``
picks a problem family, ``--solver`` a method, and every solver
parameter (preconditioner, smoother, tolerance, restart, warm start)
is a live ``RunConfig`` field protected by the anti-drift test.

Output protocol mirrors the iterate driver (``cli.run_all``): human
lines + a JSON record per solve with iterations, the solver's
certified residual, wall-clock repeats, and a ``plan`` provenance
block; ``-c`` re-certifies the residual in float64 OUTSIDE the solve
(``models/*.residual_f64`` — the golden twin of the device operator).

Checkpoint/resume: ``--checkpoint-dir`` chunks the solve at
``--checkpoint-every`` iterations via warm starts with the tolerance
re-anchored to the ORIGINAL ``||b||`` (each chunk's relative target is
rescaled by the measured warm-start residual, so the convergence
criterion is invariant under chunking); an existing checkpoint resumes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from stencil_tpu.config import RunConfig

FAMILIES = ("poisson", "hetero", "advdiff")
SOLVERS = ("auto", "relax", "mg", "fmg", "cg", "pcg", "bicgstab",
           "gmres")


def _solve_bc(config: RunConfig):
    """Zero Dirichlet walls (the steady-problem convention), with
    --periodic/--neumann dims applied; problems that cannot pose a
    well-defined steady equation under dynamic walls refuse
    themselves."""
    from stencil_tpu.core.grid import DirichletBC

    bc = DirichletBC.zero(len(config.size))
    if config.periodic:
        bc = bc.with_periodic(config.periodic_dims())
    if config.neumann:
        bc = bc.with_neumann(config.neumann_dims())
    return bc


def build_problem(config: RunConfig):
    """The ``--solve`` family -> problem object."""
    family = config.solve
    shape = tuple(config.size)
    bc = _solve_bc(config)
    if family == "poisson":
        from stencil_tpu.models.poisson import PoissonProblem

        return PoissonProblem(shape=shape, bc=bc, dtype=config.dtype)
    if family == "hetero":
        from stencil_tpu.models.diffusion import (
            HeterogeneousPoissonProblem, two_material,
        )

        if config.contrast < 1.0:
            raise ValueError(
                f"--contrast must be >= 1 (got {config.contrast})")
        a = two_material(shape, lo=1.0 / config.contrast, hi=1.0,
                         seed=0)
        return HeterogeneousPoissonProblem(
            shape=shape, a=a, bc=bc, dtype=config.dtype)
    if family == "advdiff":
        from stencil_tpu.models.advection_diffusion import (
            AdvectionDiffusionProblem,
        )

        vel = (tuple(config.velocity) if config.velocity
               else (1.0,) * len(shape))
        return AdvectionDiffusionProblem(
            shape=shape, velocity=vel, nu=config.nu, bc=bc,
            dtype=config.dtype, scheme=config.scheme)
    raise ValueError(
        f"unknown --solve family {family!r} (choose from {FAMILIES})")


def build_rhs(config: RunConfig, problem):
    """(f, u_exact_or_None). ``auto`` = the manufactured sine for
    poisson (so the run can report the error against the EXACT
    solution), seeded random otherwise."""
    mode = config.rhs
    if mode == "auto":
        mode = "sine" if config.solve == "poisson" else "random"
    shape = tuple(config.size)
    if mode == "sine":
        from stencil_tpu.models.poisson import manufactured_sine

        f, u_exact = manufactured_sine(shape, h=float(problem.h))
        # the manufactured u* solves laplacian(u)=f; the OTHER families
        # use the same smooth RHS but have no closed-form solution
        return (f.astype(config.dtype),
                u_exact if config.solve == "poisson" else None)
    if mode == "random":
        rng = np.random.default_rng(0)
        return rng.normal(size=shape).astype(config.dtype), None
    if mode == "ones":
        return np.ones(shape, config.dtype), None
    raise ValueError(f"unknown --rhs {mode!r}")


def _resolve_solver(config: RunConfig) -> str:
    if config.solver != "auto":
        return config.solver
    # MG-preconditioned CG is the SPD choice; MG-preconditioned
    # BiCGStab the general one
    return "pcg" if config.solve == "poisson" else "bicgstab"


def _make_mesh(config: RunConfig):
    if not config.mesh:
        return None
    from stencil_tpu.parallel.halo import make_mesh

    if len(config.mesh) > 2:
        raise ValueError(
            "--mesh must be 1D or 2D over the leading grid dims")
    axes = ("x", "y")[: len(config.mesh)]
    return make_mesh(tuple(config.mesh), axes)


def build_solver(config: RunConfig, problem):
    """(solver_object, kind, plan_info). ``kind`` selects the driver
    loop: 'krylov' (CGResult protocol), 'mg' (cycle iteration), 'fmg'
    (one pass), 'relax' (runner + solver.solve)."""
    name = _resolve_solver(config)
    family = config.solve
    nu1, nu2 = (int(v) for v in config.nu_smooth)
    mesh = _make_mesh(config)
    plan: dict = {"solver": name, "family": family,
                  "tolerance": config.tolerance}
    if mesh is not None:
        plan["mesh"] = list(config.mesh)

    def poisson_only(what):
        if family != "poisson":
            raise ValueError(
                f"--solver {what} runs the hardcoded Poisson stack; "
                f"family {family!r} needs bicgstab/gmres (rediscretized"
                " operator preconditioning) or relax")

    def make_mg():
        from stencil_tpu.multigrid import Multigrid

        plan.update(smoother=config.smoother, gamma=config.gamma,
                    nu_smooth=[nu1, nu2])
        return Multigrid(
            problem, nu1=nu1, nu2=nu2, smoother=config.smoother,
            gamma=config.gamma)

    def make_opmg():
        from stencil_tpu.multigrid import OperatorMultigrid

        plan.update(precond="opmg", gamma=config.gamma,
                    nu_smooth=[nu1, nu2])
        return OperatorMultigrid(problem, nu1=nu1, nu2=nu2,
                                 gamma=config.gamma)

    precond = config.precond
    if name == "relax":
        poisson_only("relax (Jacobi splitting)")
        plan["method"] = "jacobi relaxation"
        return problem, "relax", plan
    if name in ("mg", "fmg"):
        poisson_only(name)
        if precond not in (None, "none"):
            raise ValueError(f"--solver {name} takes no --precond")
        if name == "fmg" and mesh is not None:
            raise ValueError(
                "FMG is the single-device initializer; distributed "
                "solves use --solver mg/pcg (per-level sharding "
                "ladder) or a Krylov method")
        return make_mg(), name, plan
    if name in ("cg", "pcg"):
        poisson_only(name)
        from stencil_tpu.krylov import ConjugateGradient

        if precond is None:
            precond = "none" if name == "cg" else "mg"
        if precond == "opmg":
            raise ValueError(
                "cg/pcg precondition with the SPD Poisson cycle "
                "(--precond mg); opmg is the bicgstab/gmres "
                "rediscretized cycle")
        pre = make_mg() if precond == "mg" else None
        if pre is None and config.precond_dtype is not None:
            raise ValueError("--precond-dtype needs a preconditioner")
        plan["precond"] = precond
        if config.precond_dtype:
            plan["precond_dtype"] = config.precond_dtype
        return (ConjugateGradient(problem, preconditioner=pre,
                                  precond_dtype=config.precond_dtype),
                "krylov", plan)
    if name in ("bicgstab", "gmres"):
        from stencil_tpu.krylov import BiCGStab, GMRES

        if precond is None:
            precond = "opmg"
        if precond == "mg":
            raise ValueError(
                "bicgstab/gmres precondition with the rediscretized "
                "operator cycle (--precond opmg); mg is the cg/pcg "
                "Poisson cycle")
        if config.precond_dtype is not None:
            raise ValueError(
                "--precond-dtype is a pcg option (the opmg cycle runs "
                "in the problem dtype)")
        pre = make_opmg() if precond == "opmg" else None
        plan["precond"] = precond
        if name == "gmres":
            plan["restart"] = config.restart
            return (GMRES(problem, preconditioner=pre,
                          restart=config.restart), "krylov", plan)
        return BiCGStab(problem, preconditioner=pre), "krylov", plan
    raise ValueError(
        f"unknown --solver {name!r} (choose from {SOLVERS})")


def _warm_start(config: RunConfig, problem, f):
    """--warm-start fmg: one full-multigrid pass as the Krylov initial
    iterate (poisson; reaches discretization-level error in one pass,
    so the Krylov solve only polishes)."""
    if config.warm_start is None:
        return None
    if config.warm_start != "fmg":
        raise ValueError(f"unknown --warm-start {config.warm_start!r}")
    if config.solve != "poisson":
        raise ValueError(
            "--warm-start fmg runs the Poisson FMG stack; other "
            "families start from zero")
    from stencil_tpu.multigrid import Multigrid

    nu1, nu2 = (int(v) for v in config.nu_smooth)
    mg = Multigrid(problem, nu1=nu1, nu2=nu2)
    return mg.fmg(f)


def _solve_once(config: RunConfig, solver, kind, problem, f, mesh,
                initial=None, budget=None, tolerance=None):
    """One (possibly chunked) solve -> (grid, iterations, residual,
    residual_rel, converged)."""
    budget = int(budget if budget is not None else config.iterations)
    tol = float(tolerance if tolerance is not None
                else config.tolerance)
    if kind == "krylov":
        kw = {}
        if mesh is not None:
            kw["mesh"] = mesh
        res = solver.solve(f, tolerance=tol, max_iterations=budget,
                           initial=initial, **kw)
        return (res.grid, res.iterations, res.residual,
                res.residual_rel, res.converged)
    if kind == "fmg":
        grid = solver.fmg(f)
        r = solver.residual_norm(grid, f)
        fnorm = float(np.max(np.abs(np.asarray(f, np.float64))))
        rrel = r / fnorm if fnorm else r
        # FMG is a one-pass initializer: 'converged' means it reached
        # its contract (discretization-level error), certified by the
        # f64 recheck -c adds; the algebraic tolerance does not apply
        return grid, 1, r, rrel, True
    if kind == "mg":
        from stencil_tpu import solver as solver_mod

        g0 = (initial if initial is not None
              else solver.problem.initial_grid())
        runner = (solver.runner(f) if mesh is None
                  else solver.sharded_runner(f, mesh))
        res = solver_mod.solve(runner, g0, tolerance=tol,
                               max_iterations=budget, check_every=1)
        r = solver.residual_norm(res.grid, f)
        fnorm = float(np.max(np.abs(np.asarray(f, np.float64))))
        return (res.grid, res.iterations, r,
                r / fnorm if fnorm else r, res.converged)
    if kind == "relax":
        from stencil_tpu import solver as solver_mod

        runner = (solver.runner(f) if mesh is None
                  else solver.sharded_runner(f, mesh))
        g0 = initial if initial is not None else solver.initial_grid()
        res = solver_mod.solve(runner, g0, tolerance=tol,
                               max_iterations=budget,
                               check_every=max(1, min(200, budget)))
        return (res.grid, res.iterations, res.residual, res.residual,
                res.converged)
    raise AssertionError(kind)


def run_solve(config: RunConfig, out, device: dict) -> List[dict]:
    """Solve-mode driver: build, solve (with optional checkpointing +
    timed repeats), certify, report. Returns JSON-able records; each
    names the ``device`` (``platform.device_info()``) it ran on."""
    import json as _json

    import jax

    from stencil_tpu.platform import describe
    from stencil_tpu.utils.timing import measure_wall

    try:
        problem = build_problem(config)
        f, u_exact = build_rhs(config, problem)
        solver, kind, plan = build_solver(config, problem)
        mesh = _make_mesh(config)
    except (ValueError, KeyError) as e:
        # config-level contradictions are user errors, not tracebacks —
        # the solve-mode twin of the iterate driver's per-method
        # 'unavailable' contract
        name = _resolve_solver(config)
        print(f"[{name}] unavailable: {e}", file=out)
        rec = {"solve": config.solve, "solver": name, "error": str(e),
               "device": device}
        if config.json_out:
            with open(config.json_out, "w") as fh:
                fh.write(_json.dumps(rec) + "\n")
        return [rec]
    name = plan["solver"]
    rec: dict = {"solve": config.solve, "solver": name,
                 "size": list(config.size), "dtype": config.dtype,
                 "tolerance": config.tolerance, "plan": plan,
                 "device": device}
    print(f"# device: {describe(device)}", file=out)

    initial = _warm_start(config, problem, f)
    tol_eff = None
    bnorm2 = None
    if initial is not None:
        plan["warm_start"] = "fmg"
        if kind == "krylov":
            # Krylov tolerances are r0-relative; a warm start's r0 is
            # already small, so re-anchor to ||b|| (= ||f||_2 here:
            # solve-mode walls are zero) so --tol keeps meaning
            # "relative to the right-hand side"
            r0 = np.asarray(f, np.float64) - problem.apply_f64(
                np.asarray(initial.interior(), np.float64))
            rw = float(np.linalg.norm(r0.ravel()))
            bnorm2 = float(np.linalg.norm(
                np.asarray(f, np.float64).ravel()))
            if rw > 0.0:
                tol_eff = config.tolerance * bnorm2 / rw

    ckpt_dir = config.checkpoint_dir
    if ckpt_dir and kind == "fmg":
        print(f"[{name}] checkpointing skipped: FMG is one pass",
              file=out)
        ckpt_dir = None

    if ckpt_dir:
        grid, iters, r, rrel, conv = _solve_checkpointed(
            config, solver, kind, problem, f, mesh, initial, ckpt_dir,
            name, out)
        rec["checkpointed"] = True
    else:
        grid, iters, r, rrel, conv = _solve_once(
            config, solver, kind, problem, f, mesh, initial=initial,
            tolerance=tol_eff)
        if bnorm2:
            rrel = r / bnorm2  # report relative to ||b||, not r0
            conv = bool(rrel <= config.tolerance * (1 + 1e-9))
    jax.block_until_ready(grid.data)
    rec.update(iterations=iters, residual=r, residual_rel=rrel,
               converged=bool(conv))
    tag = "converged" if conv else "NOT converged"
    print(f"[{name}] {tag}: {iters} iterations, residual {r:.3e} "
          f"(rel {rrel:.3e})", file=out)

    if config.check:
        # float64 re-certification OUTSIDE the solve: the golden twin
        # of the device operator applied to the returned solution
        r64 = problem.residual_f64(grid, f)
        fnorm = float(np.max(np.abs(np.asarray(f, np.float64))))
        r64_rel = r64 / fnorm if fnorm else r64
        rec["check"] = {"residual_f64": r64, "residual_f64_rel": r64_rel}
        print(f"[{name}] certificate (float64): max |f - A u| = "
              f"{r64:.3e} (rel {r64_rel:.3e})", file=out)
        if u_exact is not None:
            err = float(np.max(np.abs(
                np.asarray(grid.interior(), np.float64) - u_exact)))
            rec["check"]["error_vs_exact"] = err
            h2 = float(problem.h) ** 2
            print(f"[{name}] error vs exact solution: {err:.3e} "
                  f"(O(h^2) bar ~ {h2:.1e})", file=out)

    # timed repeats (reference -R protocol): re-run the FULL solve;
    # checkpointed runs resume instantly, so time only fresh solves
    if config.repeat > 1 and not ckpt_dir:
        wall = measure_wall(
            lambda: _solve_once(config, solver, kind, problem, f,
                                mesh, initial=initial)[0].data,
            repeats=config.repeat)
        rec["wall_seconds"] = [float(t) for t in wall]
        for j, t in enumerate(wall, 1):
            print(f"[{name}] run {j}: {t * 1e3:.3f} ms", file=out)
        print(f"[{name}] average: "
              f"{sum(wall) / len(wall) * 1e3:.3f} ms", file=out)

    if config.dump_image:
        from stencil_tpu.utils.image import dump_heatmap

        u = np.asarray(grid.interior())
        if u.ndim == 3:  # mid-plane heat map for volumes
            u = u[u.shape[0] // 2]
        dump_heatmap(config.dump_image, u)
        print(f"[{name}] heat map -> {config.dump_image}", file=out)

    if config.json_out:
        with open(config.json_out, "w") as fh:
            fh.write(_json.dumps(rec) + "\n")
    return [rec]


def _solve_checkpointed(config, solver, kind, problem, f, mesh,
                        initial, ckpt_dir, name, out):
    """Chunked solve with warm-start checkpoints every
    ``checkpoint_every`` iterations. The convergence criterion stays
    anchored to the ORIGINAL ``||b||`` (= ``||f||_2``: solve-mode walls
    are zero): Krylov chunk tolerances are r0-relative, so each warm
    chunk's relative target is rescaled by its measured starting
    residual (on resume, one host-side float64 operator application
    recovers it)."""
    from pathlib import Path

    from stencil_tpu.utils import checkpoint as ckpt

    every = max(1, int(config.checkpoint_every))
    budget = int(config.iterations)
    done = 0
    grid = initial
    spec_tag = f"solve:{config.solve}:{name}"
    resume = ckpt.latest(ckpt_dir)
    if resume is not None:
        state = ckpt.load(resume)
        if state.spec_name != spec_tag:
            raise ValueError(
                f"checkpoint {resume} is from {state.spec_name!r}, "
                f"not this solve ({spec_tag!r}); refusing to resume")
        grid = state.to_grid(dtype=problem.dtype)
        done = state.iteration
        print(f"[{name}] resumed at iteration {done} from {resume}",
              file=out)
    rescale = kind == "krylov"  # mg/relax watch update norms: chunk-
    # invariant already, no ||b|| re-anchoring needed
    bnorm = float(np.linalg.norm(np.asarray(f, np.float64).ravel()))
    r = bnorm
    if rescale and grid is not None:
        r = float(np.linalg.norm((
            np.asarray(f, np.float64) - problem.apply_f64(
                np.asarray(grid.interior(), np.float64))).ravel()))
    rrel = r / bnorm if bnorm else r
    conv = rescale and rrel <= config.tolerance * (1 + 1e-9)
    while not conv and done < budget:
        chunk = min(every, budget - done)
        tol = config.tolerance
        if rescale and r > 0.0:
            # tol * r_chunk_start == config.tolerance * ||b||
            tol = config.tolerance * bnorm / r
        grid_out, k, r, rrel_chunk, conv = _solve_once(
            config, solver, kind, problem, f, mesh, initial=grid,
            budget=chunk, tolerance=tol)
        grid = grid_out
        done += max(1, k)
        if rescale:
            rrel = r / bnorm if bnorm else rrel_chunk
            conv = conv and rrel <= config.tolerance * (1 + 1e-9)
        else:
            rrel = rrel_chunk
        path = ckpt.save(Path(ckpt_dir) / f"step_{done:08d}.npz",
                         grid, done, spec_name=spec_tag)
        print(f"[{name}] checkpoint at {done} -> {path} "
              f"(residual {r:.3e})", file=out)
        if k == 0:
            break
    return grid, done, r, rrel, conv
