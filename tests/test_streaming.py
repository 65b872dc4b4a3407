"""Differential tests for the out-of-core streamed method
(``stencil_tpu.streaming``).

The streamed path must be ITERATION-ORDER EXACT: chunks within one
outer step all read the previous iterate (ping-pong host buffers), and
each chunk runs the same XLA sweep as the in-core ``xla`` method — so the
result matches it bit for bit, which is asserted alongside the
float64-golden differential checks.
"""

import numpy as np
import pytest

from stencil_tpu.core.grid import DirichletBC, HaloGrid
from stencil_tpu.core.spec import get_spec, star, weighted
from stencil_tpu.ops import golden, xla
from stencil_tpu.streaming import (
    StreamedStencil, auto_chunks, host_halo_grid,
)


def _run(spec, shape, k, chunks, iters, dtype="float32", bc=None,
         seed=False):
    bc = bc if bc is not None else DirichletBC.reference_default(3)
    if seed or all(bc.dynamic_mask(3)):
        x0 = np.random.default_rng(0).random(shape).astype(dtype)
    else:
        x0 = np.zeros(shape, dtype)
    m = StreamedStencil(spec, shape, dtype=dtype, sweeps_per_call=k,
                        chunks=chunks)
    out = m.iterate_host(x0, iters, bc=bc)
    return x0, out


def _check(spec, shape, k, chunks, iters, dtype="float32", bc=None,
           atol=5e-6, seed=False):
    bc = bc if bc is not None else DirichletBC.reference_default(3)
    x0, out = _run(spec, shape, k, chunks, iters, dtype=dtype, bc=bc,
                   seed=seed)
    ref = golden.golden_iterate(
        np.asarray(x0, np.float64), spec, iters, bc=bc
    )
    np.testing.assert_allclose(
        np.asarray(out, np.float64), ref, atol=atol, rtol=atol
    )


@pytest.mark.parametrize("chunks", [1, 2, 3])
def test_dirichlet_star_chunks(chunks):
    _check(get_spec("jacobi7"), (18, 16, 20), 1, chunks, iters=5)


@pytest.mark.parametrize("k", [2, 4])
def test_temporal_chunked(k):
    # chunk-internal faces with k*r-deep host-seeded ghosts
    _check(get_spec("jacobi7"), (24, 16, 20), k, 3, iters=2 * k)


def test_box_corners_through_chunk_faces():
    # box stencils read halo corners: the d0 ghost rows' d1/d2 pad
    # columns must carry the later-dims-win constants
    _check(get_spec("jacobi27"), (16, 16, 20), 2, 2, iters=4)


def test_radius2_chunked():
    _check(star(3, 2), (16, 16, 20), 2, 2, iters=4)


def test_remainder_iterations():
    # 7 = 2 outer steps of k=3 + a remainder plan of k=1
    _check(get_spec("jacobi7"), (18, 16, 20), 3, 3, iters=7)


def test_ragged_chunks_and_shape():
    # n0=19 over 3 chunks -> extents 7/6/6; ragged d1/d2 too
    _check(get_spec("jacobi7"), (19, 13, 21), 2, 3, iters=4)


def _xla_ref(grid, spec, iters):
    import jax.numpy as jnp

    return xla.iterate_dynamic(grid, spec, jnp.int32(iters))


def test_bitwise_vs_single_chip_tiled():
    # same sweep, same per-point tap order, ping-pong outer steps:
    # streaming must be invisible in the bits
    spec = get_spec("jacobi7")
    shape = (18, 16, 20)
    for k, iters in ((1, 5), (4, 8)):
        grid = HaloGrid.create(shape, halo=spec.radius)
        ref = _xla_ref(grid, spec, iters)
        m = StreamedStencil(spec, shape, sweeps_per_call=k, chunks=3)
        out = m.iterate_host(np.zeros(shape, np.float32), iters,
                             bc=grid.bc)
        np.testing.assert_array_equal(out, np.asarray(ref.interior()))


def test_periodic_d0_through_chunks():
    # the wrap crosses BOTH physical d0 faces, which live in different
    # chunks: ghost rows come from the opposite end of the host iterate
    bc = DirichletBC.reference_default(3).with_periodic([0])
    _check(get_spec("jacobi7"), (18, 16, 20), 2, 3, iters=4, bc=bc,
           seed=True)


def test_neumann_d0_and_periodic_d1():
    bc = (DirichletBC.reference_default(3)
          .with_neumann([0]).with_periodic([1]))
    _check(get_spec("jacobi7"), (18, 16, 20), 2, 2, iters=4, bc=bc,
           seed=True)


def test_box_dynamic_corners_chunked():
    bc = (DirichletBC.reference_default(3)
          .with_periodic([0]).with_neumann([1]))
    _check(get_spec("jacobi27"), (16, 16, 20), 2, 2, iters=4, bc=bc,
           seed=True)


def test_dynamic_lane_k1_slice():
    bc = DirichletBC.reference_default(3).with_periodic([2])
    _check(get_spec("jacobi7"), (16, 16, 20), 1, 2, iters=4, bc=bc,
           seed=True)


def test_bf16_smoke():
    _check(get_spec("jacobi7"), (16, 16, 20), 2, 2, iters=4,
           dtype="bfloat16", atol=3e-2)


def test_iterate_adapter_roundtrip():
    # HaloGrid in -> host HaloGrid out, equal to the in-core xla method
    spec = get_spec("jacobi7")
    shape = (16, 16, 20)
    grid = HaloGrid.create(shape, halo=spec.radius)
    m = StreamedStencil(spec, shape, sweeps_per_call=2, chunks=2)
    out = m.iterate(grid, 4)
    ref = _xla_ref(grid, spec, 4)
    assert isinstance(out.data, np.ndarray)  # never a device array
    np.testing.assert_array_equal(
        np.asarray(out.interior()), np.asarray(ref.interior()))


def test_host_halo_grid_matches_device_grid():
    g_host = host_halo_grid((6, 7, 9), halo=2)
    g_dev = HaloGrid.create((6, 7, 9), halo=2)
    np.testing.assert_array_equal(
        np.asarray(g_host.data), np.asarray(g_dev.data))


def test_auto_chunks_small_hbm():
    # a simulated 2 MiB device forces chunking; correctness must hold
    spec = get_spec("jacobi7")
    c = auto_chunks(spec, (18, 16, 140), "float32", 1,
                    device_bytes=2 << 20)
    assert c > 1
    _check(spec, (18, 16, 140), 1, c, iters=3)


def test_auto_chunks_env_override(monkeypatch):
    monkeypatch.setenv("STENCIL_TPU_HBM_MB", "2")
    spec = get_spec("jacobi7")
    m = StreamedStencil(spec, (18, 16, 140), sweeps_per_call=1)
    assert m.num_chunks > 1


def test_gate_chunk_shallower_than_kr():
    with pytest.raises(ValueError, match="k\\*r"):
        StreamedStencil(get_spec("jacobi7"), (8, 16, 20),
                        sweeps_per_call=8, chunks=4)


def test_gate_asymmetric_neumann_deep_k():
    asym = weighted(3, [((0, 0, 0), 0.5), ((1, 0, 0), 0.5)],
                    name="asym3d")
    bc = DirichletBC.reference_default(3).with_neumann([0])
    m = StreamedStencil(asym, (16, 16, 20), sweeps_per_call=2, chunks=2)
    with pytest.raises(ValueError, match="mirror-symmetric"):
        m.iterate_host(np.zeros((16, 16, 20), np.float32), 4, bc=bc)
    # and the k=1 run it suggests works
    m1 = StreamedStencil(asym, (16, 16, 20), sweeps_per_call=1, chunks=2)
    out = m1.iterate_host(
        np.random.default_rng(0).random((16, 16, 20)).astype(np.float32),
        3, bc=bc)
    assert np.isfinite(out).all()


def test_gate_dynamic_lane_needs_k1():
    # the XLA chunk step refreshes the lane dim's ghosts after every
    # sweep, so a periodic/Neumann lane dim runs at any k (the former
    # gate is gone) and matches the golden
    bc = (DirichletBC.reference_default(3).with_periodic([2])
          .with_neumann([1]))
    _check(get_spec("jacobi27"), (16, 16, 20), 2, 2, iters=5, bc=bc,
           seed=True)


def test_gate_2d_refused():
    with pytest.raises(ValueError, match="3D-only"):
        StreamedStencil(get_spec("jacobi5"), (64, 64), chunks=2)


def test_registry_runner():
    # the CLI path: registry factory consumes config.chunks
    from stencil_tpu.config import RunConfig
    from stencil_tpu import registry

    spec = get_spec("jacobi7")
    cfg = RunConfig(size=(16, 16, 20), spec="jacobi7",
                    methods=("streamed",), chunks=2, temporal=2)
    grid = HaloGrid.create((16, 16, 20), halo=spec.radius)
    runner = registry.get_runner("streamed", cfg, spec, grid)
    assert runner.plan_info["chunks"] == 2
    out = runner.iterate(grid, 4)
    ref = golden.golden_iterate(
        np.zeros((16, 16, 20), np.float64), spec, 4, bc=grid.bc)
    np.testing.assert_allclose(
        np.asarray(out.interior(), np.float64), ref, atol=5e-6, rtol=5e-6)
