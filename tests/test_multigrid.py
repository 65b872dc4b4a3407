"""Geometric multigrid (stencil_tpu/multigrid.py): V-cycle contraction,
convergence to the same discrete solution as the Jacobi path, analytic
manufactured solutions, nonzero-Dirichlet walls, hierarchy construction
on non-2^m-1 widths, and the dynamic-BC refusal.
"""

import numpy as np
import pytest

from stencil_tpu.core.grid import DirichletBC
from stencil_tpu.models.poisson import PoissonProblem, manufactured_sine
from stencil_tpu.multigrid import Multigrid, _level_shapes


def test_level_shapes():
    assert _level_shapes((63, 63), 3) == (
        (63, 63), (31, 31), (15, 15), (7, 7), (3, 3))
    # even widths cannot vertex-coarsen: single level
    assert _level_shapes((64, 64), 3) == ((64, 64),)
    # mixed widths coarsen while every dim stays odd
    assert _level_shapes((31, 15), 3)[0:2] == ((31, 15), (15, 7))


def test_vcycle_contraction_2d():
    """The per-cycle residual contraction on 63^2 must be the textbook
    grid-size-independent factor (measured ~0.17 with nu=2,2 omega=2/3),
    far below any single-level smoother's."""
    prob = PoissonProblem(shape=(63, 63))
    f, _ = manufactured_sine((63, 63))
    mg = Multigrid(prob)
    assert mg.levels == 5
    g = prob.initial_grid()
    r = mg.runner(f)
    res = []
    for _ in range(4):
        g = r.iterate(g, 1)
        res.append(mg.residual_norm(g, f))
    # ratios over the early cycles (before the fp32 residual floor)
    assert res[1] / res[0] < 0.35
    assert res[2] / res[1] < 0.35


def test_2d_manufactured_solution():
    prob = PoissonProblem(shape=(63, 63))
    f, u_exact = manufactured_sine((63, 63))
    mg = Multigrid(prob)
    res = mg.solve(f, tolerance=1e-6, max_cycles=30)
    assert res.converged, res.summary()
    assert res.iterations <= 15  # grid-size-independent cycle count
    err = np.max(np.abs(
        np.asarray(res.grid.interior(), np.float64) - u_exact))
    assert err < 1.2 * (1.0 / 64) ** 2  # discretization-level accuracy


def test_3d_matches_jacobi_solution():
    """MG and the plain Jacobi solver converge to the SAME discrete
    solution (same operator, different iteration)."""
    shape = (15, 15, 15)
    prob = PoissonProblem(shape=shape)
    f, _ = manufactured_sine(shape)
    mg = Multigrid(prob)
    res = mg.solve(f, tolerance=1e-6, max_cycles=30)
    assert res.converged, res.summary()
    resj = prob.solve(f, tolerance=1e-7, max_iterations=5000,
                      check_every=100)
    assert resj.converged
    d = np.max(np.abs(np.asarray(res.grid.interior(), np.float64)
                      - np.asarray(resj.grid.interior(), np.float64)))
    assert d < 2e-5, d
    # and MG got there in order(s) of magnitude fewer fine sweeps
    assert res.iterations * (mg.nu1 + mg.nu2 + 1) * 2 < resj.iterations


def test_nonzero_dirichlet_walls():
    """f = 0 with all walls pinned at 1 has the exact discrete solution
    u = 1 (fine level reads the pins; coarse levels are zero-walled
    correction equations)."""
    prob = PoissonProblem(shape=(31, 31),
                          bc=DirichletBC(values=((1.0, 1.0), (1.0, 1.0))))
    f = np.zeros((31, 31), np.float32)
    mg = Multigrid(prob)
    res = mg.solve(f, tolerance=1e-6, max_cycles=30)
    assert res.converged, res.summary()
    got = np.asarray(res.grid.interior(), np.float64)
    np.testing.assert_allclose(got, 1.0, atol=5e-6, rtol=0)


def test_residual_norm_certifies():
    prob = PoissonProblem(shape=(31, 31))
    f, _ = manufactured_sine((31, 31))
    mg = Multigrid(prob)
    res = mg.solve(f, tolerance=1e-6, max_cycles=30)
    # true algebraic residual, bounded by the fp32 floor ~ eps|f|/h^2
    assert mg.residual_norm(res.grid, f) < 5e-3


def test_even_width_single_level_still_works():
    prob = PoissonProblem(shape=(32, 32))
    f, _ = manufactured_sine((32, 32))
    mg = Multigrid(prob)
    assert mg.levels == 1
    r = mg.runner(f)
    info = r.plan_info
    assert info["levels"] == 1
    g = r.iterate(prob.initial_grid(), 1)  # pure smoothing, no crash
    assert np.all(np.isfinite(np.asarray(g.interior())))


def test_partial_depth_mixed_widths():
    prob = PoissonProblem(shape=(31, 15))
    f = np.ones((31, 15), np.float32)
    mg = Multigrid(prob)
    assert mg.levels >= 3
    res = mg.solve(f, tolerance=1e-6, max_cycles=40)
    assert res.converged, res.summary()


def test_pallas_fine_level_matches_xla():
    """n V-cycles in one traced-count call equal n single-cycle calls
    (the runner's fori_loop carries the whole cycle state)."""
    shape = (15, 15, 15)
    prob = PoissonProblem(shape=shape)
    f, _ = manufactured_sine(shape)
    r = Multigrid(prob).runner(f)
    g1 = prob.initial_grid()
    for _ in range(3):
        g1 = r.iterate(g1, 1)
    g3 = r.iterate(prob.initial_grid(), 3)
    np.testing.assert_allclose(np.asarray(g3.interior()),
                               np.asarray(g1.interior()), atol=1e-6)


def test_pallas_fine_smoother_specs():
    """Consistency of the XLA level passes: the weighted-Jacobi smoother
    keeps a constant field with equal walls and f = 0 fixed, and the
    residual annihilates it."""
    import jax.numpy as jnp

    from stencil_tpu.multigrid import _residual, _smooth

    pad = jnp.full((11, 11, 11), 2.5, jnp.float32)
    f = jnp.zeros((9, 9, 9), jnp.float32)
    out = _smooth(pad, f, 2.0 / 3.0, 1.0 / 6.0, 3)
    np.testing.assert_allclose(np.asarray(out), 2.5, atol=1e-6)
    r = _residual(pad, f, 64.0, 6.0)
    np.testing.assert_allclose(np.asarray(r), 0.0, atol=1e-4)


def test_pallas_fine_gates():
    with pytest.raises(ValueError, match="gamma"):
        Multigrid(PoissonProblem(shape=(15, 15, 15)), gamma=3)
    with pytest.raises(TypeError):
        # the tiled fine level is gone; its option with it
        Multigrid(PoissonProblem(shape=(15, 15, 15)),
                  fine_method="pallas_tiled")


def test_fmg_discretization_error_one_pass_2d():
    """One FMG pass (default n_vcycles=2) reaches discretization-level
    error — the whole point of FMG: no iteration count at all. nu=1 is
    the measured divergence threshold (4 delta ~ 1) and only has to be
    finite-and-loose, not accurate."""
    shape = (63, 63)
    prob = PoissonProblem(shape=shape)
    f, u_exact = manufactured_sine(shape)
    mg = Multigrid(prob)
    ref = mg.solve(f, tolerance=1e-6, max_cycles=30)
    err_ref = np.max(np.abs(
        np.asarray(ref.grid.interior(), np.float64) - u_exact))
    g2 = mg.fmg(f)
    err2 = np.max(np.abs(np.asarray(g2.interior(), np.float64) - u_exact))
    assert err2 < 1.2 * err_ref, (err2, err_ref)
    g1 = mg.fmg(f, n_vcycles=1)
    err1 = np.max(np.abs(np.asarray(g1.interior(), np.float64) - u_exact))
    assert err1 < 15.0 * err_ref, (err1, err_ref)


def test_fmg_3d_and_vcycle_continuation():
    """FMG in 3D reaches the discrete-error band in one pass (measured
    0.30 h^2 at 31^3 vs converged 0.82 h^2 — cancellation range), and
    its output is a valid iterate: runner V-cycles keep contracting."""
    shape = (31, 31, 31)
    prob = PoissonProblem(shape=shape)
    f, u_exact = manufactured_sine(shape)
    mg = Multigrid(prob)
    g = mg.fmg(f)
    err_fmg = np.max(np.abs(np.asarray(g.interior(), np.float64) - u_exact))
    assert err_fmg < 1.2 * (1.0 / 32) ** 2, err_fmg
    g = mg.runner(f).iterate(g, 2)
    err = np.max(np.abs(np.asarray(g.interior(), np.float64) - u_exact))
    assert err < 1.2 * (1.0 / 32) ** 2, err


def test_wcycle_contraction_and_solution():
    """gamma=2 (W-cycle) contracts at least as fast per cycle as the
    V-cycle and converges to the same discrete solution."""
    shape = (63, 63)
    prob = PoissonProblem(shape=shape)
    f, _ = manufactured_sine(shape)
    mg_v = Multigrid(prob)
    mg_w = Multigrid(prob, gamma=2)
    assert mg_w.runner(f).plan_info["gamma"] == 2
    gv, gw = prob.initial_grid(), prob.initial_grid()
    rv, rw = mg_v.runner(f), mg_w.runner(f)
    for _ in range(3):
        gv = rv.iterate(gv, 1)
        gw = rw.iterate(gw, 1)
    assert mg_w.residual_norm(gw, f) \
        <= 1.05 * mg_v.residual_norm(gv, f)
    resw = mg_w.solve(f, tolerance=1e-6, max_cycles=20)
    assert resw.converged
    resv = mg_v.solve(f, tolerance=1e-6, max_cycles=20)
    d = np.max(np.abs(np.asarray(resw.grid.interior(), np.float64)
                      - np.asarray(resv.grid.interior(), np.float64)))
    assert d < 5e-6, d


def test_gamma_gate():
    with pytest.raises(ValueError, match="gamma"):
        Multigrid(PoissonProblem(shape=(31, 31)), gamma=3)


def test_fmg_nonzero_walls():
    """Wall homogenization: f = 0, all walls pinned at 1 -> u = 1 exactly
    solves the discrete problem; one FMG pass must recover it."""
    prob = PoissonProblem(shape=(31, 31),
                          bc=DirichletBC(values=((1.0, 1.0), (1.0, 1.0))))
    f = np.zeros((31, 31), np.float32)
    g = Multigrid(prob).fmg(f, n_vcycles=2)
    np.testing.assert_allclose(np.asarray(g.interior(), np.float64), 1.0,
                               atol=1e-4, rtol=0)


def test_fmg_pallas_fine_matches_xla():
    """3D FMG: one pass with the default two V-cycles per level lands
    at discretization-level error (measured ~0.38 h^2 at 15^3); one
    V-cycle per level sits at the divergence threshold (~3.9 h^2)."""
    shape = (15, 15, 15)
    prob = PoissonProblem(shape=shape)
    f, u = manufactured_sine(shape)
    g = Multigrid(prob).fmg(f)
    err = np.max(np.abs(np.asarray(g.interior(), np.float64) - u))
    assert err < float(prob.h) ** 2, err


def test_fmg_xla_pass_is_cached():
    prob = PoissonProblem(shape=(31, 31))
    f, _ = manufactured_sine((31, 31))
    mg = Multigrid(prob)
    mg.fmg(f, n_vcycles=1)
    fn = mg._fmg_cache[1]
    mg.fmg(f, n_vcycles=1)
    assert mg._fmg_cache[1] is fn


def test_refuses_dynamic_bc():
    bc = DirichletBC.zero(2).with_periodic((0,))
    with pytest.raises(ValueError, match="Dirichlet"):
        Multigrid(PoissonProblem(shape=(31, 31), bc=bc))


def test_source_shape_gate():
    prob = PoissonProblem(shape=(31, 31))
    mg = Multigrid(prob)
    with pytest.raises(ValueError, match="source shape"):
        mg.runner(np.zeros((31, 30), np.float32))


# ---------------- distributed (GSPMD) multigrid ----------------

def _mesh1d(n):
    from stencil_tpu.parallel.halo import make_mesh
    return make_mesh((n,), ("x",))


def test_sharded_runner_matches_single_device():
    """The GSPMD cycle is the SAME computation as the single-device one
    (sharding constraints change placement, not math): results must
    match to fp32 noise, on 1D and mixed-level hierarchies."""
    shape = (63, 63)
    prob = PoissonProblem(shape=shape)
    f, _ = manufactured_sine(shape)
    mg = Multigrid(prob)
    r1 = mg.runner(f)
    r4 = mg.sharded_runner(f, _mesh1d(4))
    info = r4.plan_info
    # 63, 31 sharded; 15, 7, 3 replicated (replicate_below = 17)
    assert info["sharded_levels"] == [True, True, False, False, False]
    g1, g4 = prob.initial_grid(), prob.initial_grid()
    g1, g4 = r1.iterate(g1, 3), r4.iterate(g4, 3)
    d = np.max(np.abs(np.asarray(g1.data, np.float64)
                      - np.asarray(g4.data, np.float64)))
    assert d < 1e-6, d


def test_sharded_runner_converges_3d():
    shape = (31, 31, 31)
    prob = PoissonProblem(shape=shape)
    f, u = manufactured_sine(shape)
    mg = Multigrid(prob, gamma=2)  # W-cycle through the sharded path
    r = mg.sharded_runner(f, _mesh1d(8), replicate_below=8)
    g = prob.initial_grid()
    for _ in range(6):
        g = r.iterate(g, 1)
    err = float(np.max(np.abs(np.asarray(g.interior(), np.float64) - u)))
    h2 = (1.0 / 32) ** 2
    assert err < 1.2 * h2, err


def test_sharded_runner_nonlead_dim():
    shape = (31, 63)
    prob = PoissonProblem(shape=shape)
    f, _ = manufactured_sine(shape)
    mg = Multigrid(prob)
    r1 = mg.runner(f)
    rs = mg.sharded_runner(f, _mesh1d(4), dim=1)
    g1 = r1.iterate(prob.initial_grid(), 2)
    gs = rs.iterate(prob.initial_grid(), 2)
    d = np.max(np.abs(np.asarray(g1.data, np.float64)
                      - np.asarray(gs.data, np.float64)))
    assert d < 1e-6, d


def test_sharded_runner_gates():
    prob = PoissonProblem(shape=(63, 63))
    f = np.zeros((63, 63), np.float32)
    with pytest.raises(ValueError, match="1D or 2D"):
        from stencil_tpu.parallel.halo import make_mesh
        Multigrid(prob).sharded_runner(
            f, make_mesh((2, 2, 2), ("x", "y", "z")))
    with pytest.raises(ValueError, match="too narrow"):
        Multigrid(prob).sharded_runner(f, _mesh1d(4), replicate_below=64)
    with pytest.raises(ValueError, match="out of range"):
        Multigrid(prob).sharded_runner(f, _mesh1d(4), dim=2)


def test_sharded_runner_really_distributes():
    """The compiled SPMD module must contain the collectives the design
    implies — collective-permute for the sharded levels' halo slices
    and an all-gather where the hierarchy drops to the replicated
    coarse tail. Guards against a silently-replicated (vacuous) cycle."""
    import re
    import jax.numpy as jnp

    prob = PoissonProblem(shape=(63, 63))
    f, _ = manufactured_sine((63, 63))
    r = Multigrid(prob).sharded_runner(f, _mesh1d(4))
    impl = [c.cell_contents for c in r.iterate.__closure__
            if callable(c.cell_contents)
            and hasattr(c.cell_contents, "lower")][0]
    g = prob.initial_grid()
    txt = impl.lower(g.data, jnp.asarray(f),
                     jnp.int32(1)).compile().as_text()
    colls = set(re.findall(
        r"collective-permute|all-gather", txt))
    assert "collective-permute" in colls, colls
    assert "all-gather" in colls, colls


def test_wcycle_pallas_fine_matches_xla():
    """gamma=2 applies the W recursion at every level: per cycle it
    contracts at least as hard as the V-cycle."""
    shape = (15, 15, 15)
    prob = PoissonProblem(shape=shape)
    f, _ = manufactured_sine(shape)
    res = {}
    for gamma in (1, 2):
        mg = Multigrid(prob, gamma=gamma)
        g = mg.runner(f).iterate(prob.initial_grid(), 3)
        res[gamma] = mg.residual_norm(g, f)
    assert res[2] <= res[1], res


def test_fmg_pallas_pass_is_cached_and_f_independent():
    """The FMG pass must not bake f into the computation: one build
    serves every right-hand side, and matches a fresh build."""
    shape = (15, 15, 15)
    prob = PoissonProblem(shape=shape)
    mg = Multigrid(prob)
    f1, _ = manufactured_sine(shape)
    mg.fmg(f1, n_vcycles=1)
    fn = mg._fmg_cache[1]
    rng = np.random.default_rng(5)
    f2 = rng.normal(size=shape).astype(np.float32)
    g2 = mg.fmg(f2, n_vcycles=1)
    assert mg._fmg_cache[1] is fn  # reused, not rebuilt
    gx = Multigrid(prob).fmg(f2, n_vcycles=1)
    d = np.max(np.abs(np.asarray(gx.interior(), np.float64)
                      - np.asarray(g2.interior(), np.float64)))
    assert d < 5e-6, d


# ---------------- Chebyshev smoother ----------------

def test_chebyshev_cycle_reaches_discretization_error():
    shape = (63, 63, 63)
    prob = PoissonProblem(shape=shape)
    f, u = manufactured_sine(shape)
    mg = Multigrid(prob, smoother="chebyshev")
    res = mg.solve(f, tolerance=1e-6, max_cycles=30)
    err = np.max(np.abs(np.asarray(res.grid.interior(), np.float64) - u))
    assert err < 1.2 * (1.0 / 64) ** 2, err


def test_chebyshev_contracts_faster_than_wjacobi():
    """Same nu=(2,2), same cycles: the Chebyshev band polynomial must
    contract the residual at least 2x faster over 4 cycles (its
    per-sweep band damping is ~0.22 vs weighted Jacobi's 0.44)."""
    shape = (63, 63)
    prob = PoissonProblem(shape=shape)
    rng = np.random.default_rng(13)
    f = rng.normal(size=shape).astype(np.float32)
    g_w = prob.initial_grid()
    g_c = prob.initial_grid()
    r_w = Multigrid(prob).runner(f)
    r_c = Multigrid(prob, smoother="chebyshev").runner(f)
    g_w = r_w.iterate(g_w, 4)
    g_c = r_c.iterate(g_c, 4)
    res_w = Multigrid(prob).residual_norm(g_w, f)
    res_c = Multigrid(prob).residual_norm(g_c, f)
    assert res_c < 0.5 * res_w, (res_c, res_w)


def test_chebyshev_wcycle_and_fmg():
    shape = (31, 31)
    prob = PoissonProblem(shape=shape)
    f, u = manufactured_sine(shape)
    mg = Multigrid(prob, smoother="chebyshev", gamma=2)
    res = mg.solve(f, tolerance=1e-6, max_cycles=20)
    err = np.max(np.abs(np.asarray(res.grid.interior(), np.float64) - u))
    assert err < 1.2 * (1.0 / 32) ** 2, err
    g = Multigrid(prob, smoother="chebyshev").fmg(f, n_vcycles=2)
    err = np.max(np.abs(np.asarray(g.interior(), np.float64) - u))
    assert err < 1.2 * (1.0 / 32) ** 2, err


def test_chebyshev_sharded_matches_single_device():
    from stencil_tpu.parallel.halo import make_mesh

    shape = (31, 15, 15)
    prob = PoissonProblem(shape=shape)
    rng = np.random.default_rng(14)
    f = rng.normal(size=shape).astype(np.float32)
    mg = Multigrid(prob, smoother="chebyshev")
    g1 = mg.runner(f).iterate(prob.initial_grid(), 3)
    mesh = make_mesh((4,), ("x",))
    g4 = mg.sharded_runner(f, mesh, replicate_below=8).iterate(
        prob.initial_grid(), 3)
    d = np.max(np.abs(np.asarray(g1.interior(), np.float64)
                      - np.asarray(g4.interior(), np.float64)))
    assert d < 1e-5, d


def test_pcg_chebyshev_preconditioner():
    from stencil_tpu.krylov import ConjugateGradient

    shape = (63, 63, 63)
    prob = PoissonProblem(shape=shape)
    rng = np.random.default_rng(15)
    f = rng.normal(size=shape).astype(np.float32)
    pcg_w = ConjugateGradient(prob, preconditioner=Multigrid(prob)) \
        .solve(f, tolerance=1e-5, max_iterations=50)
    pcg_c = ConjugateGradient(
        prob, preconditioner=Multigrid(prob, smoother="chebyshev")) \
        .solve(f, tolerance=1e-5, max_iterations=50)
    assert pcg_w.converged and pcg_c.converged
    assert pcg_c.iterations <= pcg_w.iterations, \
        (pcg_c.iterations, pcg_w.iterations)


def test_chebyshev_gates():
    prob3 = PoissonProblem(shape=(15, 15, 15))
    with pytest.raises(ValueError, match="unknown smoother"):
        Multigrid(prob3, smoother="sor")
    with pytest.raises(ValueError, match="cheby_ratio"):
        Multigrid(prob3, smoother="chebyshev", cheby_ratio=1.0)


@pytest.mark.parametrize("nu1,nu2,gamma", [(2, 2, 1), (3, 1, 1),
                                           (2, 2, 2)])
def test_chebyshev_pallas_fine_matches_xla_cycle(nu1, nu2, gamma):
    """Chebyshev cycles with asymmetric nu and W recursion contract the
    residual by at least 10x over three cycles from a random RHS."""
    prob = PoissonProblem(shape=(31, 31, 31))
    rng = np.random.default_rng(11)
    f = rng.normal(size=prob.shape).astype(np.float32)
    mg = Multigrid(prob, nu1=nu1, nu2=nu2, gamma=gamma,
                   smoother="chebyshev")
    g0 = prob.initial_grid()
    r0 = mg.residual_norm(g0, f)
    r3 = mg.residual_norm(mg.runner(f).iterate(g0, 3), f)
    assert np.isfinite(r3) and r3 < 0.1 * r0, (r0, r3)


def test_chebyshev_pallas_fine_reaches_discretization_error():
    from stencil_tpu import solver

    prob = PoissonProblem(shape=(31, 31, 31))
    f, u_exact = manufactured_sine(prob.shape, h=prob.h)
    mg = Multigrid(prob, smoother="chebyshev")
    res = solver.solve(mg.runner(f.astype(np.float32)),
                       prob.initial_grid(), tolerance=1e-6,
                       max_iterations=30, check_every=1)
    assert res.converged
    err = np.max(np.abs(np.asarray(res.grid.interior(), np.float64)
                        - u_exact))
    assert err < 3 * float(prob.h) ** 2


def test_pcg_chebyshev_pallas_preconditioner():
    """A bfloat16 Chebyshev preconditioning cycle costs PCG at most two
    iterations over the float32 cycle and reaches the same solution."""
    from stencil_tpu.krylov import ConjugateGradient

    prob = PoissonProblem(shape=(31, 31, 31))
    rng = np.random.default_rng(12)
    f = rng.normal(size=prob.shape).astype(np.float32)
    pre = Multigrid(prob, smoother="chebyshev")
    rx = ConjugateGradient(prob, preconditioner=pre).solve(
        f, tolerance=1e-5, max_iterations=50)
    rp = ConjugateGradient(prob, preconditioner=pre,
                           precond_dtype="bfloat16").solve(
        f, tolerance=1e-5, max_iterations=50)
    assert rx.converged and rp.converged
    assert rp.iterations <= rx.iterations + 2, (rp.iterations,
                                                rx.iterations)
    np.testing.assert_allclose(np.asarray(rp.grid.interior()),
                               np.asarray(rx.grid.interior()),
                               atol=5e-4)


def _cheby_sweep_coeffs(nu, ratio, ndim, h):
    """Per-sweep affine coefficients ``(c, n, pv, s)`` of the degree-nu
    Chebyshev smoother written as a three-term recurrence

      u_t = c_t u_{t-1} + n_t nbsum(u_{t-1}) + pv_t u_{t-2} + s_t f

    (substitute ``d_{t-1} = u_{t-1} - u_{t-2}`` into ``_smooth_cheby``'s
    recurrence) — an independent float64 reference for it."""
    lmax = 2.0
    lmin = lmax / float(ratio)
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    two_d = 2.0 * ndim
    inv_d = (h * h) / two_d
    out = []
    a, b = 1.0 / theta, 0.0
    rho_prev = 1.0 / sigma
    for t in range(nu):
        if t > 0:
            rho = 1.0 / (2.0 * sigma - rho_prev)
            b = rho * rho_prev
            a = 2.0 * rho / delta
            rho_prev = rho
        out.append((1.0 + b - a, a / two_d, -b, -a * inv_d))
    return tuple(out)


def test_cheby_sweep_coeffs_match_smooth_cheby():
    """_smooth_cheby against its algebraic rewrite (u_t from the d_t
    substitution) run in float64 NumPy."""
    from stencil_tpu.multigrid import _smooth_cheby

    rng = np.random.default_rng(13)
    shape = (9, 9, 9)
    h, ratio, nu = 0.1, 4.0, 4
    u0 = rng.normal(size=shape)
    f = rng.normal(size=shape)
    import jax.numpy as jnp

    pad = jnp.asarray(np.pad(u0, 1))
    want = np.asarray(_smooth_cheby(pad, jnp.asarray(f), 1.0 / h ** 2,
                                    6.0, nu, ratio))[1:-1, 1:-1, 1:-1]

    def nbsum(p):
        acc = np.zeros(shape)
        for d in range(3):
            for o in (0, 2):
                idx = tuple(slice(o, shape[e] + o) if e == d
                            else slice(1, -1) for e in range(3))
                acc += p[idx]
        return acc

    u_prev, u = None, np.pad(u0, 1)
    for c, n, pv, sc in _cheby_sweep_coeffs(nu, ratio, 3, h):
        y = c * u[1:-1, 1:-1, 1:-1] + n * nbsum(u) + sc * f
        if u_prev is not None:
            y = y + pv * u_prev[1:-1, 1:-1, 1:-1]
        u_prev, u = u, np.pad(y, 1)
    np.testing.assert_allclose(u[1:-1, 1:-1, 1:-1], want, atol=1e-5)
