"""Krylov solvers (stencil_tpu/krylov.py): CG and MG-preconditioned CG
convergence, agreement with the MG/Jacobi discrete solution, nonzero
Dirichlet walls through the correction form, iteration-count
superiority of PCG, and the well-posedness/symmetry gates.
"""

import numpy as np
import pytest

from stencil_tpu.core.grid import DirichletBC
from stencil_tpu.krylov import ConjugateGradient
from stencil_tpu.models.poisson import PoissonProblem, manufactured_sine
from stencil_tpu.multigrid import Multigrid
from stencil_tpu.parallel.halo import make_mesh


def test_cg_converges_to_manufactured_2d():
    shape = (63, 63)
    prob = PoissonProblem(shape=shape)
    f, u = manufactured_sine(shape)
    res = ConjugateGradient(prob).solve(f, tolerance=1e-5,
                                        max_iterations=500)
    assert res.converged, res.summary()
    err = np.max(np.abs(np.asarray(res.grid.interior(), np.float64) - u))
    assert err < 1.2 * (1.0 / 64) ** 2, err


def test_cg_manufactured_is_one_eigenvector():
    """The manufactured sine RHS is a single eigenvector of the
    discrete Laplacian — CG must resolve it in O(1) iterations (a
    sharp correctness check of the Krylov recurrence itself)."""
    shape = (63, 63, 63)
    prob = PoissonProblem(shape=shape)
    f, u = manufactured_sine(shape)
    cg = ConjugateGradient(prob).solve(f, tolerance=1e-5,
                                       max_iterations=1000)
    assert cg.converged and cg.iterations <= 8, cg.summary()
    err = np.max(np.abs(np.asarray(cg.grid.interior(), np.float64) - u))
    assert err < 1.2 * (1.0 / 64) ** 2, err


def test_pcg_beats_cg_and_matches_mg():
    """On a full-spectrum (random) RHS, one V-cycle per iteration must
    cut the iteration count by several-fold vs plain CG, stay
    mesh-independently small, and land on the same discrete solution
    as the MG solve."""
    shape = (63, 63, 63)
    prob = PoissonProblem(shape=shape)
    rng = np.random.default_rng(7)
    f = rng.normal(size=shape).astype(np.float32)
    cg = ConjugateGradient(prob).solve(f, tolerance=1e-5,
                                       max_iterations=1000)
    mg = Multigrid(prob)
    pcg = ConjugateGradient(prob, preconditioner=mg).solve(
        f, tolerance=1e-5, max_iterations=100)
    assert cg.converged and pcg.converged, (cg.summary(), pcg.summary())
    assert pcg.iterations * 5 <= cg.iterations, \
        (pcg.iterations, cg.iterations)
    assert pcg.iterations <= 12, pcg.iterations  # mesh-independent
    mg_res = mg.solve(f, tolerance=1e-6, max_cycles=40)
    d = np.max(np.abs(np.asarray(pcg.grid.interior(), np.float64)
                      - np.asarray(mg_res.grid.interior(), np.float64)))
    assert d < 5e-5 * np.max(np.abs(
        np.asarray(mg_res.grid.interior(), np.float64))) + 5e-6, d


def test_pcg_wcycle_preconditioner():
    shape = (31, 31)
    prob = PoissonProblem(shape=shape)
    f, u = manufactured_sine(shape)
    res = ConjugateGradient(
        prob, preconditioner=Multigrid(prob, gamma=2)).solve(
        f, tolerance=1e-5, max_iterations=50)
    assert res.converged and res.iterations <= 10, res.summary()
    err = np.max(np.abs(np.asarray(res.grid.interior(), np.float64) - u))
    assert err < 1.2 * (1.0 / 32) ** 2, err


def test_cg_nonzero_walls():
    """f = 0, all walls pinned at 1: u = 1 exactly solves the discrete
    problem; the correction form must recover it."""
    prob = PoissonProblem(shape=(31, 31),
                          bc=DirichletBC(values=((1.0, 1.0), (1.0, 1.0))))
    f = np.zeros((31, 31), np.float32)
    res = ConjugateGradient(prob).solve(f, tolerance=1e-6,
                                        max_iterations=500)
    got = np.asarray(res.grid.interior(), np.float64)
    np.testing.assert_allclose(got, 1.0, atol=1e-5, rtol=0)


def test_cg_iteration_count_scales_with_width():
    """Plain CG needs O(n) iterations (condition number O(n^2));
    PCG's count stays flat. Checked as a ratio, not absolutes."""
    def iters(n, pre):
        prob = PoissonProblem(shape=(n, n))
        rng = np.random.default_rng(n)
        f = rng.normal(size=(n, n)).astype(np.float32)
        mg = Multigrid(prob) if pre else None
        return ConjugateGradient(prob, preconditioner=mg).solve(
            f, tolerance=1e-5, max_iterations=2000).iterations

    assert iters(63, False) >= 1.5 * iters(31, False)
    assert iters(63, True) <= iters(31, True) + 3


def test_gates():
    prob = PoissonProblem(shape=(31, 31))
    bc = DirichletBC.zero(2).with_periodic((0,))
    with pytest.raises(ValueError, match="SPD"):
        ConjugateGradient(PoissonProblem(shape=(31, 31), bc=bc))
    with pytest.raises(ValueError, match="different problem"):
        ConjugateGradient(
            prob, preconditioner=Multigrid(PoissonProblem(shape=(15, 15))))
    with pytest.raises(ValueError, match="nu1 == nu2"):
        ConjugateGradient(
            prob, preconditioner=Multigrid(prob, nu1=2, nu2=1))
    with pytest.raises(ValueError, match="source shape"):
        ConjugateGradient(prob).solve(np.zeros((31, 30), np.float32))
    with pytest.raises(ValueError, match="1D or 2D"):
        ConjugateGradient(prob).solve(
            np.zeros((31, 31), np.float32),
            mesh=make_mesh((2, 2, 2), ("x", "y", "z")))


def test_pcg_pallas_fine_matches_xla_fine():
    """PCG with nonzero walls: the correction cycle runs ZERO walls
    whatever the problem's walls are, so it converges as fast as the
    zero-wall problem and reaches the dense-correction solution."""
    shape = (31, 31, 31)
    rng = np.random.default_rng(11)
    f = rng.normal(size=shape).astype(np.float32)
    runs = {}
    for name, bc in (("zero", DirichletBC.zero(3)),
                     ("ref", DirichletBC.reference_default(3))):
        prob = PoissonProblem(shape=shape, bc=bc)
        runs[name] = ConjugateGradient(
            prob, preconditioner=Multigrid(prob)).solve(
            f, tolerance=1e-5, max_iterations=100)
        assert runs[name].converged, runs[name].summary()
        r64 = prob.residual_f64(runs[name].grid, f)
        assert r64 < 1e-2 * np.max(np.abs(f)), (name, r64)
    assert abs(runs["zero"].iterations - runs["ref"].iterations) <= 2


def test_pcg_pallas_fine_nu4():
    """The V(4,4) cycle through PCG: converges in the mesh-independent
    few iterations to discretization-level error."""
    shape = (31, 31, 31)
    prob = PoissonProblem(shape=shape)
    f, u = manufactured_sine(shape)
    mg = Multigrid(prob, nu1=4, nu2=4)
    res = ConjugateGradient(prob, preconditioner=mg).solve(
        f, tolerance=1e-5, max_iterations=50)
    assert res.converged and res.iterations <= 8, res.summary()
    err = np.max(np.abs(np.asarray(res.grid.interior(), np.float64) - u))
    assert err < 1.2 * (1.0 / 32) ** 2, err


# ---------------- distributed (GSPMD) CG / PCG ----------------

def _mesh1d(n):
    from stencil_tpu.parallel.halo import make_mesh
    return make_mesh((n,), ("x",))


def test_distributed_pcg_matches_single_device():
    """mesh= distributes the same computation (constraints change
    placement, not math): iterations identical, solutions equal to
    fp32 noise, on both plain CG and MG-PCG."""
    shape = (31, 63)
    prob = PoissonProblem(shape=shape)
    rng = np.random.default_rng(9)
    f = rng.normal(size=shape).astype(np.float32)
    for pre in (None, Multigrid(prob)):
        cg = ConjugateGradient(prob, preconditioner=pre)
        r1 = cg.solve(f, tolerance=1e-5, max_iterations=500)
        r4 = cg.solve(f, tolerance=1e-5, max_iterations=500,
                      mesh=_mesh1d(4), dim=1)
        assert r1.converged and r4.converged
        # fp32 all-reduce reordering may shift the count by a step
        assert abs(r1.iterations - r4.iterations) <= 2, \
            (r1.iterations, r4.iterations)
        d = np.max(np.abs(
            np.asarray(r1.grid.interior(), np.float64)
            - np.asarray(r4.grid.interior(), np.float64)))
        assert d < 1e-6, d


def test_distributed_pcg_converges_3d_and_caches():
    shape = (31, 31, 31)
    prob = PoissonProblem(shape=shape)
    f, u = manufactured_sine(shape)
    cg = ConjugateGradient(prob, preconditioner=Multigrid(prob))
    mesh = _mesh1d(8)
    res = cg.solve(f, tolerance=1e-5, mesh=mesh, replicate_below=8)
    assert res.converged, res.summary()
    err = np.max(np.abs(np.asarray(res.grid.interior(), np.float64) - u))
    assert err < 1.2 * (1.0 / 32) ** 2, err
    assert len(cg._fn_cache) == 1
    cg.solve(f, tolerance=1e-5, mesh=mesh, replicate_below=8)
    assert len(cg._fn_cache) == 1  # jitted solve reused, not rebuilt


def test_distributed_gates():
    prob = PoissonProblem(shape=(63, 63))
    f = np.zeros((63, 63), np.float32)
    from stencil_tpu.parallel.halo import make_mesh
    with pytest.raises(ValueError, match="1D or 2D"):
        ConjugateGradient(prob).solve(
            f, mesh=make_mesh((2, 2, 2), ("x", "y", "z")))
    with pytest.raises(ValueError, match="too narrow"):
        ConjugateGradient(prob, preconditioner=Multigrid(prob)).solve(
            f, mesh=_mesh1d(4), replicate_below=64)


# ---------------- warm starts ----------------

def test_cg_warm_start_composes():
    """Warm-start semantics: tolerance is relative to the INITIAL
    residual, so a 1e-2 solve chained with a 1e-3 warm-started solve
    reaches ~1e-5 of the original rhs in about the iterations of a
    direct 1e-5 solve."""
    shape = (31, 31, 31)
    prob = PoissonProblem(shape=shape)
    rng = np.random.default_rng(21)
    f = rng.normal(size=shape).astype(np.float32)
    cg = ConjugateGradient(prob)
    cold = cg.solve(f, tolerance=1e-2, max_iterations=500)
    warm = cg.solve(f, tolerance=1e-3, max_iterations=500,
                    initial=cold.grid)
    assert warm.converged, warm.summary()
    # absolute residuals compose: |r_warm| <= 1e-3 |r_cold|
    assert warm.residual <= 1.05e-3 * cold.residual
    direct = cg.solve(f, tolerance=1e-5, max_iterations=500)
    assert cold.iterations + warm.iterations <= direct.iterations + 10


def test_bicgstab_warm_start():
    from stencil_tpu.krylov import BiCGStab
    from stencil_tpu.models.advection_diffusion import (
        AdvectionDiffusionProblem,
    )

    prob = AdvectionDiffusionProblem(shape=(15, 16, 17),
                                     velocity=(1.0, -0.5, 0.25),
                                     nu=0.5)
    rng = np.random.default_rng(22)
    f = rng.normal(size=prob.shape).astype(np.float32)
    s = BiCGStab(prob)
    cold = s.solve(f, tolerance=1e-2, max_iterations=300)
    warm = s.solve(f, tolerance=1e-3, max_iterations=300,
                   initial=cold.grid)
    assert warm.converged
    assert warm.residual <= 1.1e-3 * cold.residual


def test_warm_start_gates():
    shape = (15, 15)
    prob = PoissonProblem(shape=shape)
    f = np.zeros(shape, np.float32)
    from stencil_tpu.core.grid import HaloGrid
    bad_shape = HaloGrid.create((14, 15), halo=1,
                                bc=DirichletBC.zero(2))
    with pytest.raises(ValueError, match="warm-start interior"):
        ConjugateGradient(prob).solve(f, initial=bad_shape)
    bad_bc = HaloGrid.create(shape, halo=1,
                             bc=DirichletBC.reference_default(2))
    with pytest.raises(ValueError, match="boundary conditions"):
        ConjugateGradient(prob).solve(f, initial=bad_bc)


def test_pcg_bf16_preconditioning_cycle():
    """precond_dtype='bfloat16' runs the whole preconditioning cycle in
    bf16 (half the cycle's HBM traffic); the Krylov recurrence and the
    certificate stay fp32, so the solution is the same — the cheap
    preconditioner costs at most an extra iteration."""
    shape = (63, 63, 63)
    prob = PoissonProblem(shape=shape)
    rng = np.random.default_rng(23)
    f = rng.normal(size=shape).astype(np.float32)
    full = ConjugateGradient(prob, preconditioner=Multigrid(
        prob, smoother="chebyshev")).solve(
        f, tolerance=1e-5, max_iterations=50)
    half = ConjugateGradient(prob, preconditioner=Multigrid(
        prob, smoother="chebyshev"), precond_dtype="bfloat16").solve(
        f, tolerance=1e-5, max_iterations=50)
    assert full.converged and half.converged, \
        (full.summary(), half.summary())
    assert half.iterations <= full.iterations + 2, \
        (half.iterations, full.iterations)
    uf = np.asarray(full.grid.interior(), np.float64)
    uh = np.asarray(half.grid.interior(), np.float64)
    assert np.max(np.abs(uf - uh)) < 1e-3 * np.max(np.abs(uf)) + 1e-6
    # distributed variant compiles and converges too
    half_d = ConjugateGradient(prob, preconditioner=Multigrid(prob),
                               precond_dtype="bfloat16").solve(
        f, tolerance=1e-5, max_iterations=50, mesh=_mesh1d(4),
        replicate_below=16)
    assert half_d.converged


def test_precond_dtype_gates():
    prob = PoissonProblem(shape=(15, 15, 15))
    with pytest.raises(ValueError, match="needs a preconditioner"):
        ConjugateGradient(prob, precond_dtype="bfloat16")
