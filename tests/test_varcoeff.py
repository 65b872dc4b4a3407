"""Variable-coefficient (heterogeneous) stencils: per-point tap weights.

The constant-weight ``StencilSpec`` cannot express these; the
``apply_fields`` path is differential-tested against its float64 twin,
cross-checked against the constant-coefficient spec path in the uniform
limit, and validated against the analytic two-material steady state
(flux continuity across the interface — the physics the harmonic face
mean exists for).
"""

import numpy as np
import pytest

from stencil_tpu.core.grid import DirichletBC, HaloGrid
from stencil_tpu.models.diffusion import (
    HeterogeneousDiffusion, face_harmonic_means,
)
from stencil_tpu.models.heat import HeatDiffusion
from stencil_tpu.ops import golden, xla
from stencil_tpu import solver


def test_fields_match_golden_random():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    shape = (16, 20)
    offsets = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1), (1, 1))
    fields = rng.uniform(0.0, 0.2, size=(len(offsets),) + shape)
    u0 = rng.normal(size=shape).astype(np.float32)
    want = golden.golden_iterate_fields(u0, offsets, fields, 7)
    g = HaloGrid.from_interior(jnp.asarray(u0), halo=1)
    got = xla.iterate_fields_dynamic(
        g, offsets, jnp.asarray(fields, jnp.float32), jnp.int32(7),
        halo=1)
    np.testing.assert_allclose(np.asarray(got.interior(), np.float64),
                               want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("shape", [(16, 20), (10, 12, 14)])
def test_uniform_limit_matches_constant_spec(shape):
    """a(x) = const reduces exactly to the constant-coefficient
    HeatDiffusion stencil (harmonic mean of equal values is the value)."""
    bc = DirichletBC.zero(len(shape))
    a0 = 0.7
    het = HeterogeneousDiffusion(shape=shape, a=np.full(shape, a0),
                                 bc=bc, dt=0.08)
    hom = HeatDiffusion(shape=shape, alpha=a0, dt=0.08, bc=bc)
    rng = np.random.default_rng(5)
    u0 = rng.normal(size=shape).astype(np.float32)
    g = het.initial_grid(u0)
    got = np.asarray(het.runner().iterate(g, 9).interior(), np.float64)
    want = golden.golden_iterate(u0, hom.spec, 9, bc=bc)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=0)


def test_two_material_steady_state_analytic():
    """Steady conduction through a two-material slab: the converged
    profile equals the EXACT discrete steady state — constant flux
    through the chain of face conductances (ghost-cell Dirichlet walls:
    T=0 at ghost -1, T=1 at ghost n; the interface gap carries the
    harmonic mean 2*a1*a2/(a1+a2)). This is THE discriminating test for
    the harmonic face mean — an arithmetic interface coefficient
    (a1+a2)/2 = 2.5 vs harmonic 1.6 shifts the whole profile."""
    n = 32
    shape = (8, n)
    a = np.ones(shape)
    a1, a2 = 1.0, 4.0
    half = n // 2
    a[:, :half] = a1
    a[:, half:] = a2
    # walls: T=0 at x-lo, T=1 at x-hi (last dim); zero-flux side walls
    bc = DirichletBC(values=((0.0, 0.0), (0.0, 1.0))).with_neumann((0,))
    het = HeterogeneousDiffusion(shape=shape, a=a, bc=bc)
    res = solver.solve(het.runner(), het.initial_grid(),
                       tolerance=2e-7, max_iterations=60_000,
                       check_every=500)
    assert res.converged, res.summary()
    prof = np.asarray(res.grid.interior(), np.float64).mean(axis=0)
    # exact discrete steady state: gap conductances g_j between nodes
    # (-1..n), edge-replicated at walls, harmonic at the interface;
    # T_j = (sum of resistances up to j) / (total resistance)
    gaps = []
    cells = [a1] + [a1] * half + [a2] * half + [a2]  # ghost..ghost
    for j in range(n + 1):
        al, ar = cells[j], cells[j + 1]
        gaps.append(2 * al * ar / (al + ar))
    resist = np.cumsum([1.0 / g for g in gaps])
    want = resist[:-1] / resist[-1]
    np.testing.assert_allclose(prof, want, atol=5e-4, rtol=0)
    # and the arithmetic-mean interface would land measurably elsewhere
    gaps[half] = (a1 + a2) / 2.0
    resist_arith = np.cumsum([1.0 / g for g in gaps])
    want_arith = resist_arith[:-1] / resist_arith[-1]
    assert np.max(np.abs(prof - want_arith)) > 5e-3


def test_harmonic_mean_properties():
    a = np.asarray([[1.0, 4.0], [9.0, 1.0]])
    faces = face_harmonic_means(a)
    # lo face of dim 1, cell (0,1): harmonic(4, 1) = 1.6
    assert abs(faces[2][0, 1] - 1.6) < 1e-12
    # edge replicate: lo face of dim 0, cell (0,0) = harmonic(1,1) = 1
    assert abs(faces[0][0, 0] - 1.0) < 1e-12


def test_stability_gate():
    with pytest.raises(ValueError, match="unstable"):
        HeterogeneousDiffusion(shape=(8, 8), a=np.full((8, 8), 2.0),
                               dt=0.2).tap_fields()
    with pytest.raises(ValueError, match="positive"):
        HeterogeneousDiffusion(shape=(8, 8), a=np.zeros((8, 8)))


def test_fields_periodic_bc():
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    shape = (12, 16)
    bc = DirichletBC.zero(2).with_periodic((0, 1))
    het = HeterogeneousDiffusion(
        shape=shape, a=rng.uniform(0.5, 2.0, size=shape), bc=bc)
    offsets, fields = het.tap_fields()
    u0 = rng.normal(size=shape).astype(np.float32)
    want = golden.golden_iterate_fields(u0, offsets, fields, 6, bc=bc)
    g = het.initial_grid(u0)
    got = het.runner().iterate(g, 6)
    np.testing.assert_allclose(np.asarray(got.interior(), np.float64),
                               want, atol=2e-5, rtol=0)


def test_mass_conservation_periodic():
    """div-form diffusion on a fully periodic domain conserves the mean
    exactly (the discrete scheme is conservative) — a wrong
    (non-symmetric) face coefficient breaks this."""
    rng = np.random.default_rng(13)
    shape = (16, 16)
    bc = DirichletBC.zero(2).with_periodic((0, 1))
    het = HeterogeneousDiffusion(
        shape=shape, a=rng.uniform(0.5, 3.0, size=shape), bc=bc)
    u0 = rng.normal(size=shape).astype(np.float32)
    g = het.initial_grid(u0)
    out = het.runner().iterate(g, 50)
    m0 = float(np.asarray(u0, np.float64).mean())
    m1 = float(np.asarray(out.interior(), np.float64).mean())
    assert abs(m1 - m0) < 1e-6, (m0, m1)


# ---- the variable-coefficient runner (XLA field sweep) ---------------


def _runner_vs_golden(shape, a, bc, iters, atol=5e-5):
    rng = np.random.default_rng(21)
    het = HeterogeneousDiffusion(shape=shape, a=a, bc=bc)
    offsets, fields = het.tap_fields()
    u0 = rng.normal(size=shape).astype(np.float32)
    g = HaloGrid.from_interior(np.asarray(u0), halo=1, bc=bc)
    got = np.asarray(het.runner().iterate(g, iters).interior(), np.float64)
    want = golden.golden_iterate_fields(u0, offsets, fields, iters,
                                        bc=bc)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("iters", [3, 4, 7, 8])
def test_pallas_coeff_matches_golden_3d(iters):
    """HeterogeneousDiffusion.runner against the float64 golden field
    model — ragged grid, nonzero reference walls."""
    shape = (10, 12, 14)
    a = np.random.default_rng(20).uniform(0.2, 3.0, size=shape)
    _runner_vs_golden(shape, a, DirichletBC.reference_default(3), iters)


def test_pallas_coeff_uniform_limit_matches_spec_kernel():
    """a = const: the field runner must agree with the constant-spec
    XLA sweep on the same update — the uniform-limit cross-check
    between the per-point and static-weight paths."""
    import jax.numpy as jnp

    from stencil_tpu.core.spec import weighted

    shape = (9, 16, 12)
    a0 = 0.7
    bc = DirichletBC.reference_default(3)
    het = HeterogeneousDiffusion(shape=shape, a=np.full(shape, a0), bc=bc)
    lam = het.stable_dt / het.h ** 2
    u0 = np.random.default_rng(22).normal(size=shape).astype(np.float32)
    taps = [((0, 0, 0), 1.0 - 6 * lam * a0)]
    for d in range(3):
        for s in (-1, 1):
            off = [0, 0, 0]
            off[d] = s
            taps.append((tuple(off), lam * a0))
    spec = weighted(3, taps, name="uniform_ftcs")
    g = HaloGrid.from_interior(np.asarray(u0), halo=1, bc=bc)
    got = np.asarray(het.runner().iterate(g, 6).interior(), np.float64)
    want = np.asarray(xla.iterate_dynamic(g, spec, jnp.int32(6))
                      .interior(), np.float64)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=0)


def test_pallas_coeff_dynamic_leading_dims():
    """Periodic d0 + Neumann d1 + Dirichlet lane on the field runner
    against the golden field model."""
    shape = (10, 12, 14)
    a = np.random.default_rng(23).uniform(0.2, 3.0, size=shape)
    bc = DirichletBC.zero(3).with_periodic((0,)).with_neumann((1,))
    _runner_vs_golden(shape, a, bc, 6)


def test_runner_pallas_matches_xla_runner():
    """A dynamic LANE dim (Neumann d2, periodic d1) on the field runner:
    the rank-general XLA path takes every BC on every dim."""
    shape = (12, 13, 15)
    a = np.random.default_rng(24).uniform(0.5, 2.0, size=shape)
    bc = DirichletBC.zero(3).with_periodic((1,)).with_neumann((2,))
    _runner_vs_golden(shape, a, bc, 6, atol=3e-5)


def test_coeff_mode_gates():
    """Malformed coefficient fields and steps are refused."""
    shape = (8, 8, 8)
    with pytest.raises(ValueError, match="shape"):
        HeterogeneousDiffusion(shape=shape, a=np.ones((8, 8, 9)))
    with pytest.raises(ValueError, match="positive"):
        HeterogeneousDiffusion(shape=shape, a=np.zeros(shape))
    het = HeterogeneousDiffusion(shape=shape, a=np.ones(shape), dt=1.0)
    with pytest.raises(ValueError, match="unstable"):
        het.runner()


def test_varcoeff_registry_method_cli():
    """Variable-coefficient marching is CLI-reachable as method
    'varcoeff': the driver check rides the runner's field-golden hook."""
    import io

    from stencil_tpu.cli import run_all
    from stencil_tpu.config import RunConfig

    out = io.StringIO()
    cfg = RunConfig(size=(16, 14, 18), iterations=7, spec="jacobi7",
                    methods=("varcoeff",), temporal=3, contrast=30.0,
                    check=True)
    (rec,) = run_all(cfg, out=out)
    assert rec["check"]["ok"], out.getvalue()
    assert rec["plan"]["contrast"] == 30.0
    # 2D runs under the same method name
    cfg2 = RunConfig(size=(24, 16), iterations=5, spec="jacobi5",
                     methods=("varcoeff",), contrast=10.0, check=True)
    (rec2,) = run_all(cfg2, out=out)
    assert rec2["check"]["ok"], out.getvalue()
    # wrong spec is a polite record, not a traceback
    cfg3 = RunConfig(size=(16, 16), iterations=5, spec="jacobi9",
                     methods=("varcoeff",))
    (rec3,) = run_all(cfg3, out=out)
    assert "error" in rec3 and "radius-1" in rec3["error"]
