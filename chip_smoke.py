#!/usr/bin/env python
"""Smoke test of the main path on the GPU, at real sizes, in one process.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs of one host: the mesh
                                       # paths and their one-card twins

One card: the device; marching (512^3 jacobi7 and 4096^2 jacobi9 through
the CLI with its float64 golden check); the models (variable-coefficient
diffusion through the CLI, the leapfrog wave and upwind advection against
their float64 references); the four solves of the solve CLI; and the
out-of-core ``streamed`` method against ``xla`` on the same grid. Each
phase drives the normal entry points (``stencil_tpu.cli.main``, the
registry, the model classes) and prints one line per result with the
card's name and power limit beside it.

The last line of standard output is ``{"ok": true, "device": {...}}`` —
printed only when every phase passed. With no GPU, or when the
``stencil_tpu`` package beside this file is missing, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent

# one-card sizes and iteration counts. The marching counts are chosen so
# that the native float64 golden of the full iteration count takes about
# a minute on the card's 16-core host (200 iterations of 512^3 took ~30 s,
# 1000 of 4096^2 ~20 s there).
MARCH_3D = ((512, 512, 512), "jacobi7", 400)
MARCH_2D = ((4096, 4096), "jacobi9", 2500)
MODEL_SHAPE = (256, 256, 256)
MODEL_STEPS = 50
POISSON_SHAPE = (511, 511, 511)
SOLVE_SHAPE = (255, 255, 255)
STREAM = ((512, 512, 512), 4, 4)  # shape, chunks, iterations
# four cards
SHARDED_SHAPE = (2048, 512, 512)
SHARDED_ITERS = 20
SHARDED_TOL = 1e-6


class PhaseFailed(AssertionError):
    """A phase ran but its result is wrong."""


class Report:
    """Prints every result beside the card it was measured on."""

    def __init__(self, card: str):
        self.card = card

    def say(self, phase: str, msg: str) -> None:
        print(f"[{phase}] {msg} | {self.card}", flush=True)


def _import_package():
    """The ``stencil_tpu`` package that sits beside this script, or exit
    2 (a lone copy of this script must not find some other install)."""
    sys.path.insert(0, str(HERE))
    try:
        import stencil_tpu
    except ImportError as e:
        print(f"error: stencil_tpu is not beside {HERE} ({e})",
              file=sys.stderr)
        raise SystemExit(2)
    if Path(stencil_tpu.__file__).resolve().parent.parent != HERE:
        print(f"error: imported stencil_tpu from {stencil_tpu.__file__}, "
              f"not from {HERE}", file=sys.stderr)
        raise SystemExit(2)
    return stencil_tpu


def _cli(args, workdir: Path) -> list:
    """``stencil_tpu.cli.main(args)`` with its records as JSON lines;
    a non-zero return is a failed phase."""
    from stencil_tpu import cli

    out = workdir / f"rec_{time.monotonic_ns()}.jsonl"
    rc = cli.main(list(args) + ["--json-out", str(out)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    if rc != 0:
        raise PhaseFailed(f"cli {' '.join(args)} returned {rc}: {recs}")
    return recs


# ---- phases -----------------------------------------------------------


def phase_march(rep: Report, workdir: Path, shape, spec: str,
                iters: int) -> dict:
    """``python -m stencil_tpu -s <shape> --spec <spec> -m xla -i <iters>
    -c``: the float64 golden check of the full iteration count, GLUPS
    and the copy bandwidth measured in the same call."""
    size = [str(n) for n in shape]
    t0 = time.perf_counter()
    (rec,) = _cli(["-s", *size, "--spec", spec, "-m", "xla", "-i",
                   str(iters), "-c"], workdir)
    chk = rec["check"]
    tol = 3e-2 if rec["dtype"] == "bfloat16" else 1e-4
    label = f"{'x'.join(size)} {spec} xla"
    capped = (" (NumPy golden, capped at "
              f"{chk['iterations_checked']} iterations)"
              if chk["capped"] else "")
    rep.say("march", f"{label}: N={iters} iterations; check "
            f"{'OK' if chk['ok'] else 'FAILED'}{capped}, max abs err "
            f"{chk['max_abs_err']:.3e} (tol {tol:g}); {rec['glups']:.2f} "
            f"GLUPS, copy {rec['copy_gbps']} GB/s, "
            f"{rec['roofline_fraction']} of copy roofline; "
            f"{time.perf_counter() - t0:.1f} s")
    if not chk["ok"]:
        raise PhaseFailed(f"{label}: golden check failed")
    return rec


def phase_memory(rep: Report, shape, spec_name: str) -> None:
    """``compiled.memory_analysis()`` of the sweep's executable and the
    device's peak bytes in use so far."""
    import jax
    import jax.numpy as jnp

    from stencil_tpu.core.grid import HaloGrid
    from stencil_tpu.core.spec import get_spec
    from stencil_tpu.ops import xla

    spec = get_spec(spec_name)
    grid = HaloGrid.create(shape, halo=spec.radius)
    ma = xla.iterate_dynamic.lower(grid, spec, jnp.int32(1)) \
        .compile().memory_analysis()
    stats = jax.devices()[0].memory_stats() or {}
    rep.say("memory", f"{'x'.join(map(str, shape))} {spec_name} step: "
            f"argument {ma.argument_size_in_bytes} B, output "
            f"{ma.output_size_in_bytes} B, temp {ma.temp_size_in_bytes} B;"
            f" peak_bytes_in_use {stats.get('peak_bytes_in_use')} B")


def phase_varcoeff(rep: Report, workdir: Path, shape, iters: int) -> dict:
    """``-m varcoeff --contrast 30 -c``: the per-point-weight sweep
    against its float64 field golden (NumPy, capped at 50 iterations)."""
    size = [str(n) for n in shape]
    (rec,) = _cli(["-s", *size, "--spec", "jacobi7", "-m", "varcoeff",
                   "--contrast", "30", "-i", str(iters), "-c"], workdir)
    chk = rec["check"]
    rep.say("varcoeff", f"{'x'.join(size)} contrast 30: "
            f"{chk['iterations_checked']} iterations checked, max abs err "
            f"{chk['max_abs_err']:.3e} (tol 1e-4); {rec['glups']:.2f} GLUPS")
    if not chk["ok"]:
        raise PhaseFailed("varcoeff golden check failed")
    return rec


def phase_wave(rep: Report, shape, steps: int, tol: float = 1e-4) -> float:
    """Leapfrog wave (``WaveEquation.simulate``) from an off-centre
    Gaussian pulse of unit amplitude against the float64 two-level
    reference (``golden_wave``); ``tol`` is absolute."""
    from stencil_tpu.models.wave import WaveEquation, golden_wave

    w = WaveEquation(shape=tuple(shape))
    axes = np.meshgrid(*[np.arange(n) / n for n in shape], indexing="ij")
    r2 = sum((x - c) ** 2 for x, c in zip(axes, (0.4, 0.5, 0.55)))
    u0 = np.exp(-r2 / 0.01)
    t0 = time.perf_counter()
    got = w.simulate_interior(u0.astype(np.float32), steps)
    dt = time.perf_counter() - t0
    want = golden_wave(u0, w.spec, steps, w.bc)
    err = float(np.max(np.abs(np.asarray(got, np.float64) - want)))
    rep.say("wave", f"{'x'.join(map(str, shape))} leapfrog, {steps} steps: "
            f"max abs err {err:.3e} (tol {tol:g}); {dt:.2f} s "
            "(compilation included)")
    if not err <= tol:
        raise PhaseFailed(f"wave error {err} > {tol}")
    return err


def phase_advection(rep: Report, shape, steps: int,
                    tol: float = 1e-4) -> float:
    """Upwind advection (its spec on the XLA sweep) against the float64
    golden."""
    import jax.numpy as jnp

    from stencil_tpu import native
    from stencil_tpu.core.grid import HaloGrid
    from stencil_tpu.models.advection import Advection
    from stencil_tpu.ops import golden, xla

    adv = Advection(shape=tuple(shape), velocity=(0.5, -0.25, 0.125))
    x0 = np.random.default_rng(2).random(shape)
    grid = HaloGrid.from_interior(jnp.asarray(x0, jnp.float32), halo=1,
                                  bc=adv.bc)
    got = np.asarray(xla.iterate_dynamic(grid, adv.spec,
                                         jnp.int32(steps)).interior())
    want = native.golden_iterate_native(x0, adv.spec, steps, bc=adv.bc)
    if want is None:
        want = golden.golden_iterate(x0, adv.spec, steps, bc=adv.bc)
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    rep.say("advection", f"{'x'.join(map(str, shape))} upwind, {steps} "
            f"steps, periodic: max abs err {err:.3e} (tol {tol:g})")
    if not err <= tol:
        raise PhaseFailed(f"advection error {err} > {tol}")
    return err


def phase_solve(rep: Report, workdir: Path, family: str, solver: str,
                shape, mesh=(), bar: bool = True) -> dict:
    """``--solve <family> --solver <solver> --tol 1e-5 -c -R 2``:
    converged, the float64 certificate, and (poisson) the error against
    the exact sine solution, held under the O(h^2) bar when ``bar``."""
    size = [str(n) for n in shape]
    args = ["--solve", family, "--solver", solver, "-s", *size, "--tol",
            "1e-5", "-c", "-R", "2"]
    if mesh:
        args += ["--mesh", *map(str, mesh)]
    (rec,) = _cli(args, workdir)
    chk = rec["check"]
    ms = 1e3 * float(np.median(rec["wall_seconds"]))
    label = (f"{family} {solver} {'x'.join(size)}"
             + (f" mesh {'x'.join(map(str, mesh))}" if mesh else ""))
    msg = (f"{label}: {'converged' if rec['converged'] else 'NOT converged'}"
           f" in {rec['iterations']} iterations, {ms:.1f} ms per solve "
           f"(median of 2); f64 certificate max|f-Au| "
           f"{chk['residual_f64']:.3e} (rel {chk['residual_f64_rel']:.3e})")
    if "error_vs_exact" in chk:
        h2 = (1.0 / (shape[0] + 1)) ** 2
        msg += (f"; error vs exact {chk['error_vs_exact']:.3e} "
                f"(O(h^2) bar {h2:.2e})")
        if bar and not chk["error_vs_exact"] < h2:
            raise PhaseFailed(f"{label} error above the O(h^2) bar: {msg}")
    rep.say("solve", msg)
    if not rec["converged"]:
        raise PhaseFailed(f"{label} did not converge")
    return rec


def phase_streamed(rep: Report, shape, chunks: int, iters: int) -> float:
    """``-m streamed --chunks <chunks>`` against ``-m xla`` on the same
    grid, both built by the CLI's own registry dispatch."""
    from stencil_tpu import registry
    from stencil_tpu.cli import make_grid
    from stencil_tpu.config import parse_args

    size = [str(n) for n in shape]
    cfg = parse_args(["-s", *size, "--spec", "jacobi7", "-m", "xla",
                      "streamed", "--chunks", str(chunks), "-i",
                      str(iters)])
    spec = cfg.resolved_spec()
    outs = {}
    for name in ("xla", "streamed"):
        grid = make_grid(cfg, spec)
        runner = registry.get_runner(name, cfg, spec, grid)
        t0 = time.perf_counter()
        outs[name] = np.asarray(runner.iterate(grid, iters).interior())
        outs[name + "_s"] = time.perf_counter() - t0
    diff = float(np.max(np.abs(outs["xla"] - outs["streamed"])))
    rep.say("streamed", f"{'x'.join(size)} jacobi7, {chunks} chunks, "
            f"{iters} iterations: max |streamed - xla| {diff:.3e} "
            f"(tol 1e-6); streamed {outs['streamed_s']:.2f} s, xla "
            f"{outs['xla_s']:.2f} s (compilation included)")
    if not diff <= 1e-6:
        raise PhaseFailed(f"streamed differs from xla by {diff}")
    return diff


def phase_sharded(rep: Report, shape, mesh, iters: int,
                  tol: float = SHARDED_TOL) -> float:
    """``-m sharded --mesh <mesh>`` against single-device ``-m xla`` on
    the same grid (same registry dispatch as the CLI); prints which
    devices hold the sharded result."""
    from stencil_tpu import registry
    from stencil_tpu.cli import make_grid
    from stencil_tpu.config import parse_args

    size = [str(n) for n in shape]
    cfg = parse_args(["-s", *size, "--spec", "jacobi7", "-m", "sharded",
                      "--mesh", *map(str, mesh), "-i", str(iters)])
    spec = cfg.resolved_spec()
    grid = make_grid(cfg, spec)
    ref = np.asarray(registry.get_runner("xla", cfg, spec, grid)
                     .iterate(grid, iters).interior())
    out = registry.get_runner("sharded", cfg, spec, grid).iterate(grid,
                                                                  iters)
    # the sharded result as it left the mesh, before HaloGrid re-pads it
    devs = sorted({s.device.id for s in out.data.addressable_shards})
    diff = float(np.max(np.abs(np.asarray(out.interior()) - ref)))
    rep.say("sharded", f"{'x'.join(size)} jacobi7 mesh "
            f"{'x'.join(map(str, mesh))}, {iters} iterations: max "
            f"|sharded - xla| {diff:.3e} (tol {tol:g}); result on devices "
            f"{devs}")
    if not diff <= tol:
        raise PhaseFailed(f"sharded mesh {mesh} differs by {diff}")
    return diff


def phase_sharded_solve(rep: Report, workdir: Path, shape, mesh) -> None:
    """``--solve poisson --solver pcg --mesh <mesh>`` against the one-card
    solve: both converged, iteration counts within one. The mesh solve's
    error against the exact solution is reported, not held to the O(h^2)
    bar: at 511^3 the fp32 discretization error sits within ~10% of the
    bar, and the all-reduced dot products round differently."""
    one = phase_solve(rep, workdir, "poisson", "pcg", shape)
    many = phase_solve(rep, workdir, "poisson", "pcg", shape, mesh=mesh,
                       bar=False)
    gap = abs(one["iterations"] - many["iterations"])
    rep.say("solve", f"mesh {'x'.join(map(str, mesh))} vs one card: "
            f"{many['iterations']} vs {one['iterations']} iterations")
    if gap > 1:
        raise PhaseFailed(f"mesh solve took {gap} iterations more or less")


# ---- driver -----------------------------------------------------------


def one_card_phases(rep: Report, workdir: Path):
    shape3, spec3, n3 = MARCH_3D
    shape2, spec2, n2 = MARCH_2D
    yield lambda: phase_march(rep, workdir, shape3, spec3, n3)
    yield lambda: phase_memory(rep, shape3, spec3)
    yield lambda: phase_march(rep, workdir, shape2, spec2, n2)
    yield lambda: phase_varcoeff(rep, workdir, MODEL_SHAPE, MODEL_STEPS)
    yield lambda: phase_wave(rep, MODEL_SHAPE, MODEL_STEPS)
    yield lambda: phase_advection(rep, MODEL_SHAPE, MODEL_STEPS)
    yield lambda: phase_solve(rep, workdir, "poisson", "pcg",
                              POISSON_SHAPE)
    for family, solver in (("advdiff", "bicgstab"), ("advdiff", "gmres"),
                           ("hetero", "bicgstab")):
        yield (lambda f=family, s=solver:
               phase_solve(rep, workdir, f, s, SOLVE_SHAPE))
    yield lambda: phase_streamed(rep, *STREAM)


def four_card_phases(rep: Report, workdir: Path):
    for mesh in ((4,), (2, 2)):
        yield (lambda m=mesh:
               phase_sharded(rep, SHARDED_SHAPE, m, SHARDED_ITERS))
    yield lambda: phase_sharded_solve(rep, workdir, POISSON_SHAPE, (4,))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run the four-card mesh paths (and their one-card "
                         "comparisons) instead of the one-card phases")
    ns = ap.parse_args(argv)
    _import_package()
    from stencil_tpu import platform

    try:
        device = platform.require_gpu()
    except platform.NoAcceleratorError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    want = 4 if ns.four_cards else 1
    if device["count"] < want:
        print(f"error: {want} GPUs needed, {device['count']} found",
              file=sys.stderr)
        return 2
    cache = platform.setup_compile_cache()
    rep = Report(device["card"])
    rep.say("device", f"platform {device['platform']}, kind "
            f"{device['kind']}, count {device['count']}; compile cache "
            f"{cache}")
    print(f"# nvidia-smi name, power.limit: {device['card']}", flush=True)

    failed = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        phases = (four_card_phases if ns.four_cards
                  else one_card_phases)(rep, Path(tmp))
        for i, phase in enumerate(phases):
            try:
                phase()
            except Exception as e:  # report every phase, then fail
                failed.append(i)
                print(f"[phase {i}] FAILED: {type(e).__name__}: {e}",
                      flush=True)
                import traceback

                traceback.print_exc()
    rep.say("total", f"{time.perf_counter() - t0:.1f} s; "
            f"{len(failed)} phase(s) failed")
    if failed:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
