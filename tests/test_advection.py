"""Advection model family (``models/advection.py``): the framework's one
ASYMMETRIC-spec physics. Exact integer-CFL translation, periodic mass
conservation, upwind-vs-Lax-Wendroff accuracy ordering, stability gates,
the tiled kernel running asymmetric taps at temporal depth over periodic
leading dims, and the Neumann k>1 mirror-symmetry gate firing on them.
"""

import numpy as np
import pytest

from stencil_tpu.core.grid import DirichletBC, HaloGrid
from stencil_tpu.models.advection import Advection
from stencil_tpu.ops import golden, xla


def _gaussian(shape, width=0.08):
    axes = [np.linspace(0, 1, n, endpoint=False) for n in shape]
    grids = np.meshgrid(*axes, indexing="ij")
    r2 = sum((g - 0.35) ** 2 for g in grids)
    return np.exp(-r2 / (2 * width ** 2)).astype(np.float32)


def test_spec_properties():
    adv = Advection(shape=(16, 16), velocity=(0.7, -0.3))
    s = adv.spec
    assert abs(sum(s.weights) - 1.0) < 1e-12  # conservation
    assert not s.symmetric_in(0) and not s.symmetric_in(1)
    lw = Advection(shape=(16, 16), velocity=(0.7, -0.3),
                   scheme="lax_wendroff")
    assert abs(sum(lw.spec.weights) - 1.0) < 1e-12
    assert not lw.spec.symmetric_in(0)
    # zero-velocity dim contributes no taps and stays symmetric
    s0 = Advection(shape=(16, 16), velocity=(1.0, 0.0), dt=0.5).spec
    assert s0.symmetric_in(1) and not s0.symmetric_in(0)


def test_stability_gates():
    with pytest.raises(ValueError, match="unstable upwind"):
        Advection(shape=(8, 8), velocity=(1.0, 1.0), dt=0.75)
    with pytest.raises(ValueError, match="unstable Lax-Wendroff"):
        Advection(shape=(8, 8), velocity=(2.0, 0.0), dt=0.75,
                  scheme="lax_wendroff")
    with pytest.raises(ValueError, match="velocity rank"):
        Advection(shape=(8, 8), velocity=(1.0,))
    with pytest.raises(ValueError, match="unknown scheme"):
        Advection(shape=(8, 8), velocity=(1.0, 0.0), scheme="bogus")


@pytest.mark.parametrize("scheme", ["upwind", "lax_wendroff"])
def test_integer_cfl_is_exact_translation(scheme):
    """c_d = 1 makes both schemes the exact shift operator; on a periodic
    box n steps translate the field by n cells bitwise-exactly."""
    shape = (16, 24)
    adv = Advection(shape=shape, velocity=(1.0, 0.0), dt=1.0,
                    scheme=scheme)
    u0 = _gaussian(shape)
    g = adv.initial_grid(u0)
    g = xla.iterate(g, adv.spec, 5)
    want = adv.exact_translate(u0, 5)
    np.testing.assert_array_equal(np.asarray(g.interior()), want)


def test_periodic_mass_conservation():
    shape = (20, 16)
    adv = Advection(shape=shape, velocity=(0.6, -0.4), cfl_safety=0.9)
    u0 = _gaussian(shape)
    g = adv.initial_grid(u0)
    g = xla.iterate(g, adv.spec, 12)
    got = np.asarray(g.interior(), np.float64)
    assert abs(got.sum() - np.float64(u0.astype(np.float64).sum())) \
        < 1e-3 * abs(u0.sum())
    assert got.min() > -1e-6  # upwind is monotone: no undershoots


def test_lax_wendroff_beats_upwind():
    """Second-order LW must beat first-order upwind against the exact
    translated solution at matched CFL (fractional, so the schemes
    actually interpolate)."""
    shape = (64, 64)
    v = (0.5, 0.25)
    steps = 16  # total displacement (4, 2) cells -> exact_translate valid
    u0 = _gaussian(shape)
    errs = {}
    for scheme in ("upwind", "lax_wendroff"):
        adv = Advection(shape=shape, velocity=v, dt=0.5, scheme=scheme)
        g = adv.initial_grid(u0)
        g = xla.iterate(g, adv.spec, steps)
        want = adv.exact_translate(u0, steps)
        errs[scheme] = float(np.max(np.abs(
            np.asarray(g.interior(), np.float64) - want)))
    assert errs["lax_wendroff"] < 0.4 * errs["upwind"], errs


def test_tiled_kernel_runs_asymmetric_taps_at_depth():
    """The streamed method at k=4 over periodic LEADING dims with an
    asymmetric spec (wrap needs no symmetry, unlike Neumann) matches the
    float64 golden model."""
    from stencil_tpu.streaming import StreamedStencil

    shape = (12, 16, 18)
    bc = DirichletBC.zero(3).with_periodic((0, 1))
    adv = Advection(shape=shape, velocity=(0.6, -0.3, 0.4),
                    cfl_safety=0.8, bc=bc)
    u0 = _gaussian(shape)
    m = StreamedStencil(adv.spec, shape, sweeps_per_call=4, chunks=2)
    got = m.iterate_host(u0.astype(np.float32), 8, bc=bc)
    want = golden.golden_iterate(u0, adv.spec, 8, bc=bc)
    np.testing.assert_allclose(got, want, atol=5e-6, rtol=0)


def test_neumann_depth_gate_fires_on_asymmetric_spec():
    """The d0 mirror-symmetry gate exists exactly for this family: a
    streamed Neumann d0 at k>1 refuses asymmetric taps, k=1 runs and
    matches."""
    from stencil_tpu.streaming import StreamedStencil

    shape = (12, 16, 18)
    bc = DirichletBC.zero(3).with_neumann((0,))
    adv = Advection(shape=shape, velocity=(0.5, 0.0, 0.0), dt=0.5, bc=bc)
    u0 = _gaussian(shape).astype(np.float32)
    m2 = StreamedStencil(adv.spec, shape, sweeps_per_call=2, chunks=2)
    with pytest.raises(ValueError, match="mirror-symmetric"):
        m2.iterate_host(u0, 2, bc=bc)
    m1 = StreamedStencil(adv.spec, shape, sweeps_per_call=1, chunks=2)
    got = m1.iterate_host(u0, 3, bc=bc)
    want = golden.golden_iterate(_gaussian(shape), adv.spec, 3, bc=bc)
    np.testing.assert_allclose(got, want, atol=5e-6, rtol=0)


def test_exact_translate_rejects_fractional_displacement():
    adv = Advection(shape=(8, 8), velocity=(0.3, 0.0), dt=1.0)
    with pytest.raises(ValueError, match="whole number"):
        adv.exact_translate(np.zeros((8, 8), np.float32), 1)
