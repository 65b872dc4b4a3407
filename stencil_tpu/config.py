"""Typed configuration — the single source of truth for CLI, benchmarks, and
the sweep harness.

Analog of the reference's ``ProgramOptions``
(``/root/reference/include/stencil/program_options.hpp:8-29``,
``src/program_options.cpp:8-47``): matrix size, iterations, block size,
radius, repeats, method list, check flag — extended with rank, dtype,
stencil-spec name, temporal depth, mesh shape, and output options.

The reference's sweep harness drifted out of sync with its own CLI (stale
``-m``/``-w`` flags, ``run.sh:2``, ``run_expr.py:18`` vs
``program_options.cpp:13-37``); here the sweep generator consumes the same
dataclass the CLI parses into, so that class of drift cannot happen
(SURVEY §5 "config" note).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Sequence, Tuple


DEFAULT_METHODS = ("xla",)


@dataclasses.dataclass
class RunConfig:
    """One benchmark run: a grid, a stencil, a method list, a protocol."""

    # problem
    size: Tuple[int, ...] = (512, 512)   # interior shape (-s, reference -s/--matrix-size)
    iterations: int = 1000               # (-i, reference -i/--iteration)
    spec: str = "jacobi5"                # named stencil (generalizes -r/--radius)
    radius: Optional[int] = None         # override radius for star specs
    dtype: str = "float32"

    # execution
    methods: Tuple[str, ...] = DEFAULT_METHODS  # (-m, reference -m/--methods)
    # 'streamed': sweeps per host->device chunk round trip (k)
    temporal: int = 1
    mesh: Tuple[int, ...] = ()           # device mesh axis sizes ('' = single device)
    no_overlap: bool = False             # disable comm/compute overlap (sharded)
    # out-of-core 'streamed' method: host->device d0 chunk count
    # (None = auto-sized from the device's reported memory limit)
    chunks: Optional[int] = None

    # boundary conditions: dims that wrap around (periodic) or mirror
    # (Neumann zero-flux) instead of holding the Dirichlet face values
    # ("all" = every dim). Capability extensions — the reference is
    # Dirichlet-only (stencil.cpp:190-207).
    periodic: Tuple[object, ...] = ()
    neumann: Tuple[object, ...] = ()

    # -- steady-state solver mode (--solve) -------------------------
    # The iterate surface above benchmarks kernels; --solve runs the
    # SOLVER stack (multigrid / Krylov) on a named problem family with
    # the same name->method dispatch UX the reference's CLI has for
    # kernels (main.cpp:46-50, stencil.cpp:61-66). In solve mode,
    # -i/--iterations is the solver's TOTAL iteration budget (Krylov
    # steps / MG cycles / relaxation sweeps) and -c re-certifies the
    # returned residual in float64 outside the solve.
    solve: Optional[str] = None          # poisson | hetero | advdiff
    solver: str = "auto"                 # auto|relax|mg|fmg|cg|pcg|bicgstab|gmres
    tolerance: float = 1e-5              # --tol: relative residual target
    precond: Optional[str] = None        # none|mg|opmg (None = per-solver default)
    precond_dtype: Optional[str] = None  # preconditioning-cycle dtype (e.g. bfloat16)
    smoother: str = "wjacobi"            # MG smoothing: wjacobi | chebyshev
    gamma: int = 1                       # MG cycle index: 1 = V, 2 = W
    nu_smooth: Tuple[int, int] = (2, 2)  # MG pre/post smoothing sweeps
    restart: int = 16                    # GMRES restart length m
    warm_start: Optional[str] = None     # 'fmg': initialize Krylov from an FMG pass
    velocity: Tuple[float, ...] = ()     # advdiff transport velocity per dim
    nu: float = 1.0                      # advdiff viscosity
    scheme: str = "upwind"               # advdiff transport: upwind | central
    contrast: float = 100.0              # hetero two-material ratio max(a)/min(a)
    rhs: str = "auto"                    # auto|sine|random|ones

    # protocol
    repeat: int = 1                      # (-R, reference -R/--repeat)
    check: bool = False                  # (-c, reference -c/--check-result)
    # None = per-dtype default: 1e-4 for float32 (reference bar,
    # stencil.cpp:137), 3e-2 for bfloat16 (its ~3 significant digits
    # make the float32 bar a guaranteed false failure)
    check_tolerance: Optional[float] = None
    warmup: int = 1                      # untimed warmup sweeps (x granularity)

    # checkpoint/resume (reference has none — SURVEY §5)
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 100

    # output
    dump_image: Optional[str] = None     # heat-map BMP path (to_bmp analog)
    json_out: Optional[str] = None
    verbose: bool = False
    profile_dir: Optional[str] = None    # jax.profiler trace directory

    # platform override ('' = whatever JAX picks; 'cpu' = run on the
    # CPU, which the CLI otherwise refuses as a silent fallback)
    platform: str = ""

    def apply_platform(self) -> None:
        if self.platform:
            import jax

            jax.config.update("jax_platforms", self.platform)

    def periodic_dims(self) -> Tuple[int, ...]:
        """``periodic`` normalized to a tuple of dim indices."""
        if any(str(d) == "all" for d in self.periodic):
            return tuple(range(len(self.size)))
        return tuple(int(d) for d in self.periodic)

    def neumann_dims(self) -> Tuple[int, ...]:
        """``neumann`` normalized to a tuple of dim indices."""
        if any(str(d) == "all" for d in self.neumann):
            return tuple(range(len(self.size)))
        return tuple(int(d) for d in self.neumann)

    def resolved_spec(self):
        from stencil_tpu.core.spec import get_spec, star

        if self.radius is not None:
            return star(len(self.size), self.radius)
        sp = get_spec(self.spec)
        if sp.ndim != len(self.size):
            raise ValueError(
                f"spec {self.spec!r} is {sp.ndim}D but size is "
                f"{len(self.size)}D"
            )
        return sp


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="stencil-tpu",
        description="structured-grid stencil benchmark and solver driver",
    )
    p.add_argument("-s", "--size", type=int, nargs="+", default=[512, 512],
                   help="interior grid shape, e.g. -s 512 512 or -s 256 256 256")
    p.add_argument("-i", "--iterations", type=int, default=1000)
    p.add_argument("--spec", type=str, default="jacobi5",
                   help="named stencil spec (jacobi5/jacobi9/jacobi7/"
                        "jacobi27/star2d_r2/star3d_r2/laplace2d_ho/laplace3d_ho)")
    p.add_argument("-r", "--radius", type=int, default=None,
                   help="star-stencil radius override (reference -r)")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("-m", "--methods", type=str, nargs="+",
                   default=list(DEFAULT_METHODS),
                   help="methods to run (see registry: xla, sharded, "
                        "sharded_noverlap, streamed, varcoeff)")
    p.add_argument("-k", "--temporal", type=int, default=1,
                   help="'streamed' method: sweeps per host->device chunk "
                        "round trip")
    p.add_argument("--mesh", type=int, nargs="*", default=[],
                   help="device mesh axis sizes for sharded methods")
    p.add_argument("--no-overlap", action="store_true",
                   help="disable the interior-first comm/compute overlap "
                        "in the 'sharded' method")
    p.add_argument("--chunks", type=int, default=None,
                   help="out-of-core 'streamed' method: number of host->"
                        "device d0 chunks (default: auto-sized from the "
                        "device's reported memory limit)")
    p.add_argument("--periodic", type=str, nargs="*", default=[],
                   help="dims with periodic (wrap-around) boundaries "
                        "instead of Dirichlet faces, e.g. --periodic 0 1 "
                        "or --periodic all (reference: Dirichlet-only)")
    p.add_argument("--neumann", type=str, nargs="*", default=[],
                   help="dims with Neumann (zero-flux mirror) boundaries "
                        "instead of Dirichlet faces, e.g. --neumann 0 or "
                        "--neumann all; combinable with --periodic on "
                        "OTHER dims (reference: Dirichlet-only)")
    p.add_argument("--solve", type=str, default=None,
                   choices=["poisson", "hetero", "advdiff"],
                   help="run the SOLVER stack on a steady problem "
                        "family instead of benchmarking iterate "
                        "kernels (-i becomes the solver's total "
                        "iteration budget; -c re-certifies the "
                        "residual in float64)")
    p.add_argument("--solver", type=str, default="auto",
                   choices=["auto", "relax", "mg", "fmg", "cg", "pcg",
                            "bicgstab", "gmres"],
                   help="solver for --solve (auto: pcg for poisson, "
                        "MG-preconditioned bicgstab otherwise)")
    p.add_argument("--tol", type=float, default=1e-5, dest="tolerance",
                   help="solver relative-residual target")
    p.add_argument("--precond", type=str, default=None,
                   choices=["none", "mg", "opmg"],
                   help="Krylov preconditioner (default per solver: "
                        "pcg=mg, bicgstab/gmres=opmg, cg=none)")
    p.add_argument("--precond-dtype", type=str, default=None,
                   choices=["float32", "bfloat16"],
                   help="run the preconditioning cycle's arrays in "
                        "this dtype (bfloat16 halves its HBM traffic; "
                        "the Krylov recurrence + certificate stay in "
                        "the problem dtype)")
    p.add_argument("--smoother", type=str, default="wjacobi",
                   choices=["wjacobi", "chebyshev"],
                   help="multigrid smoother (chebyshev: ~2x per-sweep "
                        "damping at the same cost)")
    p.add_argument("--gamma", type=int, default=1, choices=[1, 2],
                   help="multigrid cycle index (1 = V-cycle, 2 = W)")
    p.add_argument("--nu-smooth", type=int, nargs=2, default=[2, 2],
                   metavar=("NU1", "NU2"),
                   help="multigrid pre/post smoothing sweeps")
    p.add_argument("--restart", type=int, default=16,
                   help="GMRES restart length m (device basis is "
                        "(m+1) x grid; an oversized basis is refused "
                        "with sizing guidance)")
    p.add_argument("--warm-start", type=str, default=None,
                   choices=["fmg"],
                   help="initialize the Krylov solve from a full-"
                        "multigrid pass instead of zero (poisson)")
    p.add_argument("--velocity", type=float, nargs="+", default=[],
                   help="advdiff transport velocity per dim "
                        "(default 1 per dim)")
    p.add_argument("--nu", type=float, default=1.0,
                   help="advdiff viscosity (diffusion coefficient)")
    p.add_argument("--scheme", type=str, default="upwind",
                   choices=["upwind", "central"],
                   help="advdiff transport discretization")
    p.add_argument("--contrast", type=float, default=100.0,
                   help="hetero two-material coefficient ratio "
                        "max(a)/min(a)")
    p.add_argument("--rhs", type=str, default="auto",
                   choices=["auto", "sine", "random", "ones"],
                   help="solve-mode right-hand side (auto: the "
                        "manufactured sine for poisson — reports the "
                        "error vs the exact solution — random "
                        "otherwise)")
    p.add_argument("-R", "--repeat", type=int, default=1,
                   help="timed wall-clock repeats (per-run + average "
                        "report, reference -R) and marginal-timing "
                        "repeats")
    p.add_argument("-c", "--check-result", action="store_true", dest="check")
    p.add_argument("--check-tolerance", type=float, default=None,
                   help="|err| bar for -c; default 1e-4 (float32, the "
                        "reference bar) or 3e-2 (bfloat16)")
    p.add_argument("--warmup", type=int, default=1,
                   help="untimed warmup sweeps before timing (scaled by "
                        "the method's granularity)")
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="directory for periodic checkpoints; an existing "
                        "checkpoint there is resumed automatically")
    p.add_argument("--checkpoint-every", type=int, default=100)
    p.add_argument("--dump-image", type=str, default=None,
                   help="write a blue-green-red heat-map BMP of the result")
    p.add_argument("--json-out", type=str, default=None,
                   help="write results as JSON lines to this path")
    p.add_argument("--profile", type=str, default=None, dest="profile_dir",
                   help="capture a jax.profiler trace of the timed runs "
                        "into this directory (view with TensorBoard / "
                        "xprof)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--platform", type=str, default="",
                   help="force a JAX platform (e.g. 'cpu' to run on the "
                        "host, or the sharded methods on a virtual device "
                        "mesh)")
    return p


def parse_args(argv: Optional[Sequence[str]] = None) -> RunConfig:
    ns = build_parser().parse_args(argv)
    return RunConfig(
        size=tuple(ns.size),
        iterations=ns.iterations,
        spec=ns.spec,
        radius=ns.radius,
        dtype=ns.dtype,
        methods=tuple(ns.methods),
        temporal=ns.temporal,
        mesh=tuple(ns.mesh),
        no_overlap=ns.no_overlap,
        chunks=ns.chunks,
        periodic=tuple(ns.periodic),
        neumann=tuple(ns.neumann),
        solve=ns.solve,
        solver=ns.solver,
        tolerance=ns.tolerance,
        precond=ns.precond,
        precond_dtype=ns.precond_dtype,
        smoother=ns.smoother,
        gamma=ns.gamma,
        nu_smooth=tuple(ns.nu_smooth),
        restart=ns.restart,
        warm_start=ns.warm_start,
        velocity=tuple(ns.velocity),
        nu=ns.nu,
        scheme=ns.scheme,
        contrast=ns.contrast,
        rhs=ns.rhs,
        repeat=ns.repeat,
        check=ns.check,
        check_tolerance=ns.check_tolerance,
        warmup=ns.warmup,
        checkpoint_dir=ns.checkpoint_dir,
        checkpoint_every=ns.checkpoint_every,
        dump_image=ns.dump_image,
        json_out=ns.json_out,
        verbose=ns.verbose,
        profile_dir=ns.profile_dir,
        platform=ns.platform,
    )
