#!/usr/bin/env python
"""Headline + per-config benchmark (one process, one JSON line).

The primary metric stays the BASELINE north-star config — single-device 3D
7-point Jacobi GLUPS, with ``vs_baseline`` the fraction of the roofline
set by a copy measured in the same process. The JSON line also carries a
``configs`` map with every BASELINE configuration and the model and solver
rows, all on their XLA forms, measured in the SAME process.

Runs on a GPU only: with no GPU it exits non-zero (no CPU fallback). Every
printed record names the device.
"""

import json
import sys
import time

import numpy as np


def main() -> int:
    from stencil_tpu import platform

    try:
        device = platform.require_gpu()
    except platform.NoAcceleratorError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    platform.setup_compile_cache()
    print(f"# device: {platform.describe(device)}", file=sys.stderr)

    import jax
    import jax.numpy as jnp

    from stencil_tpu.core.grid import DirichletBC, HaloGrid
    from stencil_tpu.core.spec import get_spec
    from stencil_tpu.ops import xla
    from stencil_tpu.registry import Runner
    from stencil_tpu.utils import roofline
    from stencil_tpu.utils.timing import measure_marginal

    t_start = time.perf_counter()
    shape = (256, 256, 256)
    dtype = "float32"

    def sweep_runner(spec):
        return Runner(name="xla", iterate=lambda g, n: xla.iterate_dynamic(
            g, spec, jnp.int32(n)))

    # (key, spec, shape, dtype): the BASELINE config vector
    # (BASELINE.md rows), each on the XLA sweep
    config_rows = [
        ("cfg1_2d5pt_512", "jacobi5", (512, 512), "float32"),
        ("cfg2_2d9pt_4096", "jacobi9", (4096, 4096), "float32"),
        ("cfg3_3d7pt_256_bf16", "jacobi7", (256, 256, 256), "bfloat16"),
        ("cfg4_3dr2_384", "laplace3d_ho", (384, 384, 384), "float32"),
        ("cfg4_3dr2_384_bf16", "laplace3d_ho", (384, 384, 384),
         "bfloat16"),
        ("cfg6_ragged_257", "jacobi7", (257, 257, 257), "float32"),
        ("cfg5_local_256x256x1024", "jacobi7", (256, 256, 1024),
         "float32"),
    ]

    headline_spec = get_spec("jacobi7")
    grid = HaloGrid.create(shape, halo=1, dtype=dtype)
    points = int(np.prod(shape))
    cfg_runners = []
    for key, spec_name, cshape, cdtype in config_rows:
        cspec = get_spec(spec_name)
        cgrid = HaloGrid.create(cshape, halo=cspec.radius, dtype=cdtype)
        cfg_runners.append((key, cgrid, sweep_runner(cspec),
                            int(np.prod(cshape)), cdtype))

    from stencil_tpu.models.poisson import PoissonProblem

    pshape = (256, 256, 256)
    prob = PoissonProblem(shape=pshape)
    pf = np.random.default_rng(0).normal(size=pshape).astype(np.float32)
    cfg_runners.append(("cfg8_poisson_256_src", prob.initial_grid(),
                        prob.runner(pf), int(np.prod(pshape)), "float32"))

    from stencil_tpu.models.wave import WaveEquation

    wshape = (256, 256, 256)
    wave = WaveEquation(shape=wshape)
    wprev, wcur = wave.initial_pair(
        (np.random.default_rng(1).normal(size=wshape) * 0.01)
        .astype(np.float32))

    def wave_iter(g, n, _w=wave, _p=wprev):
        return _w.simulate(_p, g, int(n))[1]

    cfg_runners.append(("cfg9_wave_256", wcur,
                        Runner(name="wave", iterate=wave_iter),
                        int(np.prod(wshape)), "float32"))

    from stencil_tpu.multigrid import Multigrid

    mshape = (255, 255, 255)
    mprob = PoissonProblem(shape=mshape)
    mf = np.random.default_rng(2).normal(size=mshape).astype(np.float32)
    mgrid = mprob.initial_grid()
    # "glups" of an MG row = interior points per cycle-second; a cycle
    # is not a naive sweep, so these rows report x_roofline: null
    for key, mg in (
            ("cfg10_mg_vcycle_255_nu4", Multigrid(mprob, nu1=4, nu2=4)),
            ("cfg11_mg_vcycle_255_cheby", Multigrid(mprob,
                                                    smoother="chebyshev")),
            ("cfg17_mg_vcycle_255_cheby_nu4",
             Multigrid(mprob, nu1=4, nu2=4, smoother="chebyshev"))):
        cfg_runners.append((key, mgrid, mg.runner(mf),
                            int(np.prod(mshape)), "float32"))

    from stencil_tpu.models.advection import Advection

    ashape = (256, 256, 256)
    adv = Advection(shape=ashape, velocity=(0.5, -0.25, 0.125),
                    bc=DirichletBC.reference_default(3))
    cfg_runners.append(("cfg12_advection_upwind_256",
                        HaloGrid.create(ashape, halo=1, dtype="float32"),
                        sweep_runner(adv.spec), int(np.prod(ashape)),
                        "float32"))

    from stencil_tpu.models.diffusion import (
        HeterogeneousDiffusion, HeterogeneousPoissonProblem, two_material,
    )

    vshape = (256, 256, 256)
    vdiff = HeterogeneousDiffusion(
        shape=vshape, a=two_material(vshape, lo=0.01, hi=1.0, seed=0))
    cfg_runners.append(("cfg16b_varcoeff_256",
                        HaloGrid.create(vshape, halo=1, dtype="float32"),
                        vdiff.runner(), int(np.prod(vshape)), "float32"))

    copy_gbps = roofline.measure_copy_bandwidth("gpu")
    REPEATS = 3

    def measure(runner, igrid):
        g = max(1, runner.granularity)
        return measure_marginal(lambda n: runner.iterate(igrid, n).data,
                                warmup_iters=g, granularity=g,
                                repeats=REPEATS)

    def band(m, npoints):
        gl = sorted(npoints / s / 1e9 for s in m.marginals)
        return round(gl[0], 2), round(gl[-1], 2)

    m = measure(sweep_runner(headline_spec), grid)
    best_glups = points / m.seconds_per_iteration / 1e9
    best_lo, best_hi = band(m, points)
    print(f"# headline xla: {best_glups:.1f} GLUPS [{best_lo}, {best_hi}]",
          file=sys.stderr)

    configs_out = {}
    for key, cgrid, runner, cpoints, cdtype in cfg_runners:
        try:
            m = measure(runner, cgrid)
        except Exception as e:  # one failing row must not hide the rest
            print(f"# {key} measure failed: {e!r}", file=sys.stderr)
            configs_out[key] = {"glups": 0.0, "x_roofline": None,
                                "error": repr(e)}
            continue
        glups = cpoints / m.seconds_per_iteration / 1e9
        lo, hi = band(m, cpoints)
        roof_c = (copy_gbps / roofline.ideal_bytes_per_point(cdtype)
                  if copy_gbps and "_mg_" not in key else None)
        configs_out[key] = {
            "glups": round(glups, 2),
            "glups_min": lo, "glups_max": hi, "repeats": REPEATS,
            "x_roofline": round(glups / roof_c, 3) if roof_c else None,
        }
        print(f"# {key}: {glups:.1f} GLUPS [{lo}, {hi}]", file=sys.stderr)

    # time-to-solution rows (solve protocol, not runner protocol):
    # compile + warm on the first solve, then REPEATS timed solves
    from stencil_tpu.krylov import GMRES, BiCGStab, ConjugateGradient
    from stencil_tpu.models.advection_diffusion import (
        AdvectionDiffusionProblem,
    )
    from stencil_tpu.multigrid import OperatorMultigrid

    pcg = ConjugateGradient(
        mprob, preconditioner=Multigrid(mprob, smoother="chebyshev"))
    mf_dev = jnp.asarray(mf)
    adp = AdvectionDiffusionProblem(shape=mshape, velocity=(1.0, -0.5, 0.25),
                                    nu=0.05)
    fad = jnp.asarray(np.random.default_rng(3).normal(size=mshape)
                      .astype(np.float32))
    opmg = OperatorMultigrid(adp)
    hprob = HeterogeneousPoissonProblem(
        shape=mshape, a=two_material(mshape, lo=0.01, hi=1.0, seed=0))
    fhet = jnp.asarray(np.random.default_rng(7).normal(size=mshape)
                       .astype(np.float32))
    hsolver = BiCGStab(hprob, preconditioner=OperatorMultigrid(hprob))
    solve_items = [
        ("cfg13_pcg_cheby_255",
         lambda: pcg.solve(mf_dev, tolerance=1e-4, max_iterations=50)),
        ("cfg14_bicgstab_mg_advdiff_255",
         lambda: BiCGStab(adp, preconditioner=opmg).solve(
             fad, tolerance=1e-4, max_iterations=3000)),
        ("cfg15_gmres_mg_advdiff_255",
         lambda: GMRES(adp, preconditioner=opmg, restart=8).solve(
             fad, tolerance=1e-4, max_iterations=3000)),
        ("cfg18_bicgstab_hetero_255",
         lambda: hsolver.solve(fhet, tolerance=1e-4, max_iterations=1000)),
    ]
    for key, run_solve in solve_items:
        try:
            res = run_solve()  # compile + warm
            times = []
            for _ in range(REPEATS):
                t = time.perf_counter()
                res = run_solve()
                jax.block_until_ready(res.grid.data)
                times.append(1e3 * (time.perf_counter() - t))
        except Exception as e:  # one failing row must not hide the rest
            print(f"# {key} measure failed: {e!r}", file=sys.stderr)
            configs_out[key] = {"error": repr(e)}
            continue
        ts = sorted(times)
        configs_out[key] = {
            "solve_ms": round(ts[len(ts) // 2], 1),
            "solve_ms_min": round(ts[0], 1),
            "solve_ms_max": round(ts[-1], 1),
            "iterations": res.iterations,
            "converged": res.converged,
            "repeats": REPEATS,
        }
        print(f"# {key}: {ts[len(ts) // 2]:.1f} ms "
              f"[{ts[0]:.1f}, {ts[-1]:.1f}] iters={res.iterations}",
              file=sys.stderr)

    roof = (copy_gbps / roofline.ideal_bytes_per_point(dtype)
            if copy_gbps else None)
    out = {
        "metric": f"3d7pt_jacobi_{shape[0]}^3_fp32_glups[xla]",
        "value": round(best_glups, 2),
        "unit": "GLUPS",
        "vs_baseline": round(best_glups / roof, 3) if roof else 0.0,
        "value_min": best_lo, "value_max": best_hi, "repeats": REPEATS,
        "copy_gbps": copy_gbps,
        "device": device,
    }
    print(f"# total: {time.perf_counter() - t_start:.1f}s", file=sys.stderr)
    # the full detail goes on an EARLIER stdout line; the FINAL line
    # stays compact (headline fields plus config names) so it parses
    # within a capture window of ~2000 characters
    print(json.dumps(dict(out, configs=configs_out)))
    out["config_names"] = sorted(configs_out)
    line = json.dumps(out)
    if len(line) > 1900:
        out.pop("config_names")
        line = json.dumps(out)
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
