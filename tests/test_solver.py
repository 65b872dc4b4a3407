"""Convergence solver tests: Jacobi relaxation of the Laplace problem must
converge to the harmonic function with the reference's wall BCs."""

import numpy as np

from stencil_tpu.core.grid import HaloGrid
from stencil_tpu.core.spec import get_spec
from stencil_tpu import registry, solver


def _runner(shape):
    spec = get_spec("jacobi5")
    grid = HaloGrid.create(shape, halo=1, dtype="float32")
    return spec, grid, registry.get_runner("xla", None, spec, grid)


def test_converges_on_small_grid():
    spec, grid, runner = _runner((24, 24))
    res = solver.solve(runner, grid, tolerance=1e-6, check_every=200,
                       max_iterations=50_000)
    assert res.converged, res.summary()
    # steady state: one more sweep changes nothing (within fp32 noise)
    after = runner.iterate(res.grid, 1)
    np.testing.assert_allclose(
        np.asarray(after.interior()), np.asarray(res.grid.interior()),
        atol=5e-6,
    )
    # the solution is symmetric about the horizontal midline (BCs are:
    # left/right walls 1.0, top/bottom walls 0.0)
    sol = np.asarray(res.grid.interior())
    np.testing.assert_allclose(sol, sol[::-1, :], atol=1e-4)
    np.testing.assert_allclose(sol, sol[:, ::-1], atol=1e-4)


def test_max_iterations_respected():
    spec, grid, runner = _runner((64, 64))
    res = solver.solve(runner, grid, tolerance=0.0, check_every=10,
                       max_iterations=30)
    assert not res.converged
    assert res.iterations == 30


def test_progress_callback():
    spec, grid, runner = _runner((16, 16))
    msgs = []
    solver.solve(runner, grid, tolerance=1e-5, check_every=100,
                 max_iterations=10_000, progress=msgs.append)
    assert msgs and all("residual" in m for m in msgs)


def test_solver_with_temporal_pallas_kernel():
    """The convergence loop composes with the streamed method's k sweeps
    per chunk round trip: check intervals that are not multiples of k
    exercise the remainder path inside a single solve."""
    from stencil_tpu.config import RunConfig

    spec = get_spec("jacobi7")
    grid = HaloGrid.create((12, 12, 12), halo=1, dtype="float32")
    cfg = RunConfig(size=(12, 12, 12), spec="jacobi7",
                    methods=("streamed",), temporal=4, chunks=2)
    runner = registry.get_runner("streamed", cfg, spec, grid)
    res = solver.solve(runner, grid, tolerance=1e-6, check_every=150,
                       max_iterations=50_000)
    assert res.converged, res.summary()
    # cross-method: identical steady state as the xla solver result
    xruner = registry.get_runner("xla", None, spec, grid)
    xres = solver.solve(xruner, grid, tolerance=1e-6, check_every=200,
                        max_iterations=50_000)
    np.testing.assert_allclose(
        np.asarray(res.grid.interior()), np.asarray(xres.grid.interior()),
        atol=1e-4,
    )


def test_solver_with_periodic_dim():
    """Convergence with a periodic d0 (a cylinder: wrap in d0, Dirichlet
    walls in d1): the fixed point is invariant under the wrap, i.e.
    constant along d0 — rows converge to the 1D harmonic profile set by
    the lane walls."""
    from stencil_tpu.core.grid import DirichletBC

    spec = get_spec("jacobi5")
    bc = DirichletBC.reference_default(2).with_periodic((0,))
    grid = HaloGrid.create((24, 24), halo=1, dtype="float32", bc=bc)
    runner = registry.get_runner("xla", None, spec, grid)
    res = solver.solve(runner, grid, tolerance=1e-6, check_every=200,
                       max_iterations=50_000)
    assert res.converged, res.summary()
    sol = np.asarray(res.grid.interior())
    # translation invariance along the periodic dim
    np.testing.assert_allclose(sol, np.roll(sol, 5, axis=0), atol=5e-5)
    # steady state survives one more sweep
    after = runner.iterate(res.grid, 1)
    np.testing.assert_allclose(
        np.asarray(after.interior()), sol, atol=5e-6)
