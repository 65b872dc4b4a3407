"""Benchmark CLI driver.

Analog of the reference's ``main`` (``/root/reference/src/main.cpp:12-62``):
for each requested method, optionally run a correctness check against the
golden model, then run ``--repeat`` timed runs and report per-run and
average timings — extended with GLUPS/roofline reporting, marginal timing,
JSON output, and heat-map dumps. Every record names the device it ran on.

Usage examples:

  python -m stencil_tpu -s 512 512 512 --spec jacobi7 -i 100 -m xla -c
  python -m stencil_tpu -s 4096 4096 --spec jacobi9 -i 400 -c
  python -m stencil_tpu --platform cpu -s 64 64 64 --spec jacobi7 -m xla streamed --chunks 4 -c
"""

from __future__ import annotations

import json
import sys
from typing import List, Optional, Sequence

import numpy as np

from stencil_tpu.config import RunConfig, parse_args
from stencil_tpu.core.grid import HaloGrid
from stencil_tpu.ops import golden
from stencil_tpu import platform, registry
from stencil_tpu.utils import roofline
from stencil_tpu.utils.timing import TinyTimer, measure_marginal, measure_wall


def make_grid(config: RunConfig, spec) -> HaloGrid:
    """Reference initial conditions: interior 0, Dirichlet halo
    (``stencil.cpp:190-207``); ``--periodic`` dims wrap and ``--neumann``
    dims mirror (zero-flux) instead.

    When EVERY dim is dynamic there is no Dirichlet face left to inject
    signal: a zero interior is then a fixed point of wrap/mirror + any
    linear stencil, which would make ``-c`` compare zero with zero (a
    vacuous pass for any kernel, however broken). Seed a deterministic
    nonzero interior in that one case so the differential check
    exercises the BC machinery; partial-dynamic and all-Dirichlet grids
    keep the reference's zero interior."""
    bc = None
    interior_seed = None
    if config.periodic or config.neumann:
        from stencil_tpu.core.grid import DirichletBC

        bc = DirichletBC.reference_default(len(config.size))
        if config.periodic:
            bc = bc.with_periodic(config.periodic_dims())
        if config.neumann:
            bc = bc.with_neumann(config.neumann_dims())
        if all(bc.dynamic_mask(len(config.size))):
            interior_seed = np.random.default_rng(0).random(
                config.size).astype(config.dtype)
    grid_bytes = int(np.prod(config.size)) * np.dtype(config.dtype).itemsize
    limit = platform.device_memory_bytes()
    if limit is not None and 2 * grid_bytes > limit:
        # grids that cannot hold two device iterates live on the HOST:
        # only the 'streamed' method can run them (other methods fail
        # with a clean OOM when they try to materialize the grid)
        from stencil_tpu.streaming import host_halo_grid

        return host_halo_grid(config.size, halo=spec.radius, bc=bc,
                              dtype=config.dtype, interior=interior_seed)
    if interior_seed is not None:
        import jax.numpy as jnp

        return HaloGrid.from_interior(
            jnp.asarray(interior_seed), halo=spec.radius, bc=bc
        )
    return HaloGrid.create(
        config.size, halo=spec.radius, dtype=config.dtype, bc=bc
    )


def check_method(config: RunConfig, spec, runner):
    """Run the golden-model differential check.

    Returns ``(CheckResult, iterations_checked)``. The reference's -c
    verifies the FULL iteration count (stencil.cpp:94-131); the
    multithreaded native golden (native/golden.cpp) makes that
    affordable here. Only when no C++ toolchain is available do we fall
    back to the NumPy golden, capped at 50 iterations to keep -c usable
    on big sweeps — the caller must surface that cap (a capped check is
    NOT a full-run check and must never silently read as one).
    """
    grid = make_grid(config, spec)
    from stencil_tpu import native

    # the golden run starts from the grid's ACTUAL interior (zero for
    # reference ICs; the seeded nonzero field for all-dynamic BCs —
    # hardcoding zeros here would make that check vacuous again)
    x0 = np.asarray(grid.interior(), dtype=np.float64)
    iters = config.iterations
    if getattr(runner, "golden_fn", None) is not None:
        # method-specific golden (per-point tap fields the spec golden
        # cannot represent) — NumPy float64, capped like the fallback
        iters = min(config.iterations, 50)
        ref = runner.golden_fn(x0, iters, grid.bc)
    else:
        ref = native.golden_iterate_native(x0, spec, iters, bc=grid.bc)
    if ref is None:
        iters = min(config.iterations, 50)
        ref = golden.golden_iterate(x0, spec, iters, bc=grid.bc)
    out = runner.iterate(grid, iters)
    tol = config.check_tolerance
    if tol is None:
        tol = 3e-2 if config.dtype == "bfloat16" else 1e-4
    chk = golden.check_against_golden(
        np.asarray(out.interior()), ref, tolerance=tol
    )
    return chk, iters


def bench_method(config: RunConfig, spec, runner):
    grid = make_grid(config, spec)

    def run_n(n: int):
        return runner.iterate(grid, n).data

    # marginal + autoranged timing: cancels the fixed per-call dispatch
    # overhead and grows iteration counts until the signal dominates that
    # noise; excludes compilation.
    # Counts stay multiples of the runner's granularity (``streamed``'s k
    # sweeps per chunk round trip) so that remainder steps never compile
    # inside the timed region.
    # --warmup scales the untimed warmup sweep count.
    g = max(1, getattr(runner, "granularity", 1))
    m = measure_marginal(run_n, warmup_iters=max(1, config.warmup) * g,
                         granularity=g, repeats=max(2, config.repeat))
    return m


def run_all(config: RunConfig, out=None) -> List[dict]:
    out = out if out is not None else sys.stdout
    device = platform.device_info()
    if config.solve:
        # --solve: the steady-solver surface (multigrid/Krylov) —
        # same dispatch-by-name UX, its own driver (solve_cli.py)
        from stencil_tpu import solve_cli

        return solve_cli.run_solve(config, out, device)
    spec = config.resolved_spec()
    points = int(np.prod(config.size))
    results = []
    print(f"# device: {platform.describe(device)}", file=out)
    copy_gbps = roofline.measure_copy_bandwidth(device["platform"])

    for name in config.methods:
        rec: dict = {"method": name, "size": list(config.size),
                     "spec": spec.name, "iterations": config.iterations,
                     "dtype": config.dtype, "device": device}
        grid = make_grid(config, spec)
        try:
            runner = registry.get_runner(name, config, spec, grid)
        except Exception as e:
            print(f"[{name}] unavailable: {e}", file=out)
            rec["error"] = str(e)
            results.append(rec)
            continue
        if getattr(runner, "plan_info", None):
            rec["plan"] = runner.plan_info

        if config.check:
            chk, iters_checked = check_method(config, spec, runner)
            capped = iters_checked < config.iterations
            rec["check"] = {
                "ok": bool(chk.ok),
                "max_abs_err": chk.max_abs_err,
                "max_rel_err": chk.max_rel_err,
                "iterations_checked": iters_checked,
                "capped": capped,
            }
            status = "OK" if chk.ok else "FAILED"
            print(f"[{name}] correctness: {status} "
                  f"({iters_checked} iterations verified) — "
                  f"{chk.message()}", file=out)
            if capped:
                why = ("method-specific field golden"
                       if getattr(runner, "golden_fn", None) is not None
                       else "no C++ toolchain — NumPy golden fallback")
                print(
                    f"[{name}] WARNING: {why} verified only "
                    f"{iters_checked} of {config.iterations} "
                    f"iterations", file=out,
                )
            if not chk.ok:
                results.append(rec)
                continue

        if config.profile_dir:
            import contextlib

            import jax

            prof = jax.profiler.trace(config.profile_dir)
        else:
            import contextlib

            prof = contextlib.nullcontext()
        with prof:
            m = bench_method(config, spec, runner)
        if config.profile_dir:
            print(f"[{name}] profiler trace -> {config.profile_dir}",
                  file=out)
        rep = roofline.report(
            points, 1, m.seconds_per_iteration, config.dtype, copy_gbps
        )
        rec["seconds_per_sweep"] = rep.seconds_per_sweep
        rec["glups"] = rep.glups
        rec["copy_gbps"] = rep.copy_gbps
        rec["roofline_fraction"] = rep.roofline_fraction
        print(f"[{name}] {rep.summary()}", file=out)

        # reference protocol alongside the marginal headline: -R wall-clock
        # repeats of the full iteration count with per-run + average lines
        # (main.cpp:29-43). Includes dispatch overhead by design.
        wall = measure_wall(
            lambda: runner.iterate(grid, config.iterations).data,
            repeats=config.repeat,
        )
        rec["wall_seconds"] = [float(t) for t in wall]
        for j, t in enumerate(wall, 1):
            print(f"[{name}] run {j}: {t * 1e3:.3f} ms", file=out)
        print(
            f"[{name}] average: {sum(wall) / len(wall) * 1e3:.3f} ms "
            f"({config.iterations} iterations)", file=out,
        )
        results.append(rec)

        if config.checkpoint_dir:
            from pathlib import Path

            from stencil_tpu.utils.checkpoint import CheckpointedRun

            # per-method subdirectory: a shared directory would make every
            # method after the first silently "resume" from the previous
            # method's final checkpoint and do no work
            ckpt_dir = (Path(config.checkpoint_dir) / name
                        if len(config.methods) > 1
                        else config.checkpoint_dir)
            ckpt = CheckpointedRun(
                runner, ckpt_dir,
                every=config.checkpoint_every, spec_name=spec.name,
            )
            final, done = ckpt.run(
                make_grid(config, spec), config.iterations,
                progress=lambda m: print(f"[{name}] {m}", file=out),
            )
            rec["checkpointed_iterations"] = done

        if config.dump_image:
            from pathlib import Path

            from stencil_tpu.utils.image import dump_heatmap

            final = runner.iterate(grid, config.iterations)
            # per-method FILENAME prefix (not path prefix — that would
            # mangle absolute paths) when several methods share the flag
            p = Path(config.dump_image)
            path = (str(p) if len(config.methods) == 1
                    else str(p.with_name(f"{name}_{p.name}")))
            dump_heatmap(path, np.asarray(final.interior()))
            print(f"[{name}] heat map -> {path}", file=out)

    if config.json_out:
        with open(config.json_out, "w") as f:
            for rec in results:
                f.write(json.dumps(rec) + "\n")
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    config = parse_args(argv)
    config.apply_platform()
    try:
        platform.require_device(config.platform)
    except platform.NoAcceleratorError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    platform.setup_compile_cache()
    try:
        if not config.solve:  # solve mode has no iterate spec
            config.resolved_spec()
        overlap = set(config.periodic_dims()) & set(config.neumann_dims())
        if overlap:
            raise ValueError(
                f"dim(s) {sorted(overlap)} listed as both --periodic and "
                "--neumann; a dim may be periodic or Neumann, not both"
            )
    except (ValueError, KeyError) as e:
        # config-level contradictions (spec/size rank mismatch, unknown
        # spec, conflicting BC modes) are user errors, not tracebacks —
        # same contract as the per-method 'unavailable' reporting
        print(f"error: {e}", file=sys.stderr)
        return 2
    timer = TinyTimer().start()
    results = run_all(config)
    if config.verbose:
        print(f"total driver time: {timer.pretty()}")
    bad = [r for r in results
           if r.get("check", {}).get("ok") is False or "error" in r
           or r.get("converged") is False]
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
