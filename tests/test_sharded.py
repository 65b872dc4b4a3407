"""Multi-device halo-exchange tests on the 8-device virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stencil_tpu.core.grid import DirichletBC, HaloGrid
from stencil_tpu.core import spec as S
from stencil_tpu.ops import golden
from stencil_tpu.parallel.halo import ShardedStencil, make_mesh


def run_case(spec, shape, axis_sizes, axis_names, iters, overlap,
             bc=None, tol=1e-4):
    rng = np.random.default_rng(7)
    x0 = rng.random(shape).astype(np.float32)
    g = HaloGrid.from_interior(jnp.asarray(x0), halo=spec.radius, bc=bc)
    mesh = make_mesh(axis_sizes, [n for n in axis_names if n is not None])
    method = ShardedStencil(spec, tuple(axis_names), overlap=overlap)
    out = method.iterate(g, iters, mesh)
    ref = golden.golden_iterate(x0, spec, iters, bc=g.bc)
    chk = golden.check_against_golden(
        np.asarray(out.interior()), ref, tolerance=tol
    )
    assert chk.ok, chk.message()


def test_devices_available():
    # >= 8 so every 8-device mesh below is buildable (the conftest
    # forces 10)
    assert len(jax.devices()) >= 8


@pytest.mark.parametrize("overlap", [False, True])
def test_2d_1d_mesh(overlap):
    run_case(S.jacobi5(), (64, 40), (8,), ("x", None), 5, overlap)


@pytest.mark.parametrize("overlap", [False, True])
def test_2d_2d_mesh(overlap):
    run_case(S.jacobi5(), (32, 48), (4, 2), ("x", "y"), 5, overlap)


def test_2d_box_corners_cross_devices():
    # box stencil needs corner values; two-phase exchange must carry them
    run_case(S.jacobi9(), (32, 48), (4, 2), ("x", "y"), 4, True)


def test_2d_radius2_sharded():
    run_case(S.star(2, 2), (32, 48), (4, 2), ("x", "y"), 3, True)


@pytest.mark.parametrize("overlap", [False, True])
def test_3d_1d_mesh(overlap):
    run_case(S.jacobi7_3d(), (16, 12, 40), (8,), ("z", None, None), 3,
             overlap)


def test_3d_3d_mesh():
    run_case(S.jacobi27_3d(), (8, 8, 32), (2, 2, 2), ("z", "x", "y"), 3, True)


def test_3d_2d_mesh_minor_dims():
    run_case(S.jacobi7_3d(), (8, 16, 32), (4, 2), (None, "x", "y"), 3, True)


def test_custom_bc_sharded():
    bc = DirichletBC(values=((5.0, -2.0), (1.5, 0.25)))
    run_case(S.jacobi5(), (32, 48), (4, 2), ("x", "y"), 4, True, bc=bc)


def test_indivisible_shape_raises():
    g = HaloGrid.create((30, 40), halo=1)
    mesh = make_mesh((8,), ("x",))
    m = ShardedStencil(S.jacobi5(), ("x", None))
    with pytest.raises(ValueError):
        m.iterate(g, 1, mesh)


def test_matches_single_device_bitwise():
    # sharded and single-device XLA paths should agree to fp32 roundoff
    from stencil_tpu.ops import xla

    rng = np.random.default_rng(3)
    x0 = rng.random((32, 48)).astype(np.float32)
    g = HaloGrid.from_interior(jnp.asarray(x0), halo=1)
    mesh = make_mesh((4, 2), ("x", "y"))
    m = ShardedStencil(S.jacobi5(), ("x", "y"), overlap=False)
    sharded = m.iterate(g, 5, mesh)
    single = xla.iterate(g, S.jacobi5(), 5)
    np.testing.assert_allclose(
        np.asarray(sharded.interior()),
        np.asarray(single.interior()),
        rtol=0, atol=1e-6,
    )


def test_iterate_is_device_resident():
    """Regression guard: iterate() paths must not fetch device data to
    the host (a NumPy scatter/gather inside iterate once cost 170 ms per
    sweep on an accelerator — invisible on CPU, catastrophic there)."""
    import jax

    from stencil_tpu.core.spec import get_spec
    from stencil_tpu.ops import xla
    from stencil_tpu.parallel.halo import ShardedStencil, make_mesh

    spec = get_spec("jacobi7")
    shape = (16, 16, 24)
    g = HaloGrid.create(shape, halo=1, dtype="float32")
    g2 = HaloGrid.create((32, 40), halo=1, dtype="float32")
    mesh = make_mesh((2,), ("x",))
    mesh2 = make_mesh((2, 2), ("x", "y"))
    cases = [
        (g, lambda grid, n: xla.iterate_dynamic(grid, spec, jnp.int32(n))),
        (g, lambda grid, n: ShardedStencil(
            spec, ("x", None, None)).iterate(grid, n, mesh)),
        (g, lambda grid, n: ShardedStencil(
            spec, ("x", "y", None)).iterate(grid, n, mesh2)),
        (g2, lambda grid, n: ShardedStencil(
            get_spec("jacobi5"), ("x", None)).iterate(grid, n, mesh)),
    ]
    for grid, fn in cases:
        fn(grid, 4)  # compile outside the guard
        with jax.transfer_guard_device_to_host("disallow"):
            fn(grid, 4)


@pytest.mark.parametrize("mesh_sizes", [(2,), (2, 2)])
def test_bf16_sharded_pallas(mesh_sizes):
    from stencil_tpu.core.spec import get_spec
    from stencil_tpu.ops import golden
    from stencil_tpu.parallel.halo import make_mesh

    spec = get_spec("jacobi7")
    shape = (32, 16, 24)
    axes = ("x", "y")[: len(mesh_sizes)]
    mesh = make_mesh(mesh_sizes, axes)
    grid = HaloGrid.create(shape, halo=1, dtype="bfloat16")
    m = ShardedStencil(spec, axes + (None,) * (3 - len(axes)))
    out = m.iterate(grid, 4, mesh)
    assert out.dtype == jnp.bfloat16
    ref = golden.golden_iterate(np.zeros(shape, np.float64), spec, 4,
                                bc=grid.bc)
    np.testing.assert_allclose(
        np.asarray(out.interior(), np.float64), ref, atol=3e-2, rtol=3e-2
    )
