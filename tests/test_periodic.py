"""Periodic (wrap-around) boundary conditions.

A capability extension beyond the reference, which is Dirichlet-only
(``stencil.cpp:190-207``). Every method (xla, sharded, streamed) and
both golden models (NumPy + native C++) support periodic dims.

Validation strategy mirrors the framework's differential-testing
doctrine with a third, fully independent reference for the all-periodic
case: circular convolution via ``np.roll`` (no shared ghost-fill code at
all).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from stencil_tpu.config import RunConfig
from stencil_tpu.core import spec as S
from stencil_tpu.core.grid import (
    DirichletBC, HaloGrid, fill_halo, refresh_dynamic,
)
from stencil_tpu.ops import golden, xla
from stencil_tpu import registry


# ---- DirichletBC periodic-mask semantics ----------------------------------


def test_with_periodic_marks_dims():
    bc = DirichletBC.reference_default(3).with_periodic((0, 2))
    assert bc.periodic == (True, False, True)
    assert bc.any_periodic
    assert bc.periodic_mask(3) == (True, False, True)


def test_with_periodic_empty_is_identity():
    base = DirichletBC.reference_default(2)
    bc = base.with_periodic(())
    # semantically all-Dirichlet must compare AND hash equal to the
    # default (jit cache keys and checkpoint mismatch checks rely on it)
    assert bc == base
    assert hash(bc) == hash(base)
    assert not bc.any_periodic


def test_with_periodic_negative_and_out_of_range():
    bc = DirichletBC.reference_default(2).with_periodic((-1,))
    assert bc.periodic == (False, True)
    with pytest.raises(ValueError, match="out of range"):
        DirichletBC.reference_default(2).with_periodic((2,))


def test_periodic_all():
    bc = DirichletBC.periodic_all(3)
    assert bc.periodic == (True, True, True)
    assert bc.any_periodic


# ---- halo fill / refresh semantics -----------------------------------------


def test_refresh_periodic_wraps_both_faces():
    # padded 1D-ish (2D) array with distinct interior values
    interior = np.arange(1, 7, dtype=np.float32).reshape(6, 1) * [[1.0]]
    g = HaloGrid.from_interior(
        jnp.asarray(np.tile(interior, (1, 4))), halo=1,
        bc=DirichletBC.reference_default(2).with_periodic((0,)),
    )
    data = np.asarray(g.data)
    # dim-0 ghosts wrap: low ghost row == last interior row, and vice versa
    np.testing.assert_array_equal(data[0, 1:-1], data[6, 1:-1])
    np.testing.assert_array_equal(data[7, 1:-1], data[1, 1:-1])
    # dim-1 stays Dirichlet (last dim faces = 1.0)
    np.testing.assert_array_equal(data[1:-1, 0], 1.0)
    np.testing.assert_array_equal(data[1:-1, -1], 1.0)


def test_periodic_corner_transitivity():
    # all-periodic: the corner ghost must hold the doubly-wrapped value
    x = np.arange(12, dtype=np.float64).reshape(3, 4)
    padded = jnp.pad(jnp.asarray(x), 1)
    padded = fill_halo(padded, 1, DirichletBC.periodic_all(2))
    p = np.asarray(padded)
    assert p[0, 0] == x[-1, -1]
    assert p[-1, -1] == x[0, 0]
    assert p[0, -1] == x[-1, 0]


def test_periodic_depth_check():
    bc = DirichletBC.periodic_all(2)
    with pytest.raises(ValueError, match="interior extent"):
        # interior extent 1 < halo depth 2 along dim 0
        fill_halo(jnp.zeros((5, 10)), 2, bc)


def test_refresh_dynamic_noop_for_dirichlet():
    padded = fill_halo(jnp.zeros((6, 6)), 1, DirichletBC.reference_default(2))
    out = refresh_dynamic(padded, 1, DirichletBC.reference_default(2))
    np.testing.assert_array_equal(np.asarray(out), np.asarray(padded))


# ---- golden model vs independent circular convolution ----------------------


def _circular_reference(x0, sp, iterations):
    """Fully independent all-periodic reference: circular convolution in
    float64 via np.roll (shares NO code with the golden ghost machinery)."""
    x = x0.astype(np.float64)
    for _ in range(iterations):
        acc = np.zeros_like(x)
        for off, w in zip(sp.offsets, sp.weights):
            acc += w * np.roll(x, shift=tuple(-o for o in off),
                               axis=tuple(range(x.ndim)))
        x = acc
    return x


@pytest.mark.parametrize("spec_name,shape", [
    ("jacobi5", (12, 16)),       # 2D star r=1
    ("jacobi9", (12, 16)),       # 2D box r=1 (corners exercised)
    ("star2d_r2", (12, 16)),     # 2D star r=2 (deep ghosts)
    ("jacobi7", (8, 10, 12)),    # 3D star r=1
    ("jacobi27", (8, 10, 12)),   # 3D box r=1 (3D corners exercised)
])
def test_golden_periodic_equals_circular(rng, spec_name, shape):
    sp = S.get_spec(spec_name)
    x0 = rng.random(shape)
    out = golden.golden_iterate(
        x0, sp, 6, bc=DirichletBC.periodic_all(sp.ndim)
    )
    ref = _circular_reference(x0, sp, 6)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)


def test_golden_periodic_fixed_point(rng):
    # uniform star average of a constant field under all-periodic BCs is
    # exactly that constant (no boundary leak anywhere)
    out = golden.golden_iterate(
        np.full((7, 9), 3.25), S.jacobi5(), 20,
        bc=DirichletBC.periodic_all(2),
    )
    np.testing.assert_array_equal(out, 3.25)


def test_golden_periodic_translation_equivariance(rng):
    # all-periodic iteration commutes with circular shifts of the input
    sp = S.jacobi9()
    x0 = rng.random((10, 14))
    bc = DirichletBC.periodic_all(2)
    a = golden.golden_iterate(np.roll(x0, (3, 5), (0, 1)), sp, 4, bc=bc)
    b = np.roll(golden.golden_iterate(x0, sp, 4, bc=bc), (3, 5), (0, 1))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-13)


# ---- XLA method vs golden (mixed Dirichlet/periodic) ------------------------


@pytest.mark.parametrize("spec_name", ["jacobi5", "jacobi9", "star2d_r2"])
@pytest.mark.parametrize("dims", [(0,), (1,), (0, 1)])
def test_xla_matches_golden_periodic_2d(rng, spec_name, dims):
    sp = S.get_spec(spec_name)
    bc = DirichletBC.reference_default(2).with_periodic(dims)
    x0 = rng.random((20, 24)).astype(np.float32)
    g = HaloGrid.from_interior(jnp.asarray(x0), halo=sp.radius, bc=bc)
    out = xla.iterate(g, sp, 7)
    ref = golden.golden_iterate(x0, sp, 7, bc=bc)
    chk = golden.check_against_golden(np.asarray(out.interior()), ref)
    assert chk.ok, chk.message()


@pytest.mark.parametrize("spec_name", ["jacobi7", "jacobi27", "laplace3d_ho"])
@pytest.mark.parametrize("dims", [(2,), (0, 2), (0, 1, 2)])
def test_xla_matches_golden_periodic_3d(rng, spec_name, dims):
    sp = S.get_spec(spec_name)
    bc = DirichletBC.reference_default(3).with_periodic(dims)
    x0 = rng.random((8, 10, 12)).astype(np.float32)
    g = HaloGrid.from_interior(jnp.asarray(x0), halo=sp.radius, bc=bc)
    out = xla.iterate(g, sp, 5)
    ref = golden.golden_iterate(x0, sp, 5, bc=bc)
    chk = golden.check_against_golden(np.asarray(out.interior()), ref)
    assert chk.ok, chk.message()


def test_xla_dynamic_periodic_matches_static(rng):
    sp = S.jacobi5()
    bc = DirichletBC.reference_default(2).with_periodic((0,))
    x0 = rng.random((16, 16)).astype(np.float32)
    g = HaloGrid.from_interior(jnp.asarray(x0), halo=1, bc=bc)
    a = xla.iterate(g, sp, 9)
    b = xla.iterate_dynamic(g, sp, jnp.int32(9))
    np.testing.assert_array_equal(
        np.asarray(a.interior()), np.asarray(b.interior())
    )


# ---- native C++ golden twin --------------------------------------------------


@pytest.mark.parametrize("spec_name,shape,dims", [
    ("jacobi5", (16, 20), (0,)),
    ("jacobi9", (16, 20), (0, 1)),
    ("star2d_r2", (16, 20), (1,)),
    ("jacobi7", (8, 10, 12), (0, 2)),
    ("jacobi27", (8, 10, 12), (0, 1, 2)),
])
def test_native_golden_periodic_matches_numpy(rng, spec_name, shape, dims):
    from stencil_tpu.native import available, golden_iterate_native

    if not available():
        pytest.skip("no C++ toolchain for the native verifier")
    sp = S.get_spec(spec_name)
    bc = DirichletBC.reference_default(sp.ndim).with_periodic(dims)
    x0 = rng.random(shape)
    a = golden.golden_iterate(x0, sp, 5, bc=bc)
    b = golden_iterate_native(x0, sp, 5, bc=bc)
    assert b is not None
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-13)


# ---- method gating + CLI -----------------------------------------------------


REMOVED_METHODS = ["pallas", "pallas_temporal", "pallas_tiled",
                   "sharded_pallas", "rma"]


@pytest.mark.parametrize("method", REMOVED_METHODS)
def test_unsupported_methods_gate_cleanly(method):
    # removed kernel methods: the registry names them unknown instead
    # of running something else in their place
    sp = S.jacobi5()
    bc = DirichletBC.reference_default(2).with_periodic((1,))
    g = HaloGrid.create((16, 16), halo=1, bc=bc)
    cfg = RunConfig(size=(16, 16), iterations=2, methods=(method,))
    with pytest.raises(ValueError, match="unknown method"):
        registry.get_runner(method, cfg, sp, g)


def _streamed_check(sp, shape, bc, k, chunks, iters, rng):
    from stencil_tpu.streaming import StreamedStencil

    x0 = rng.random(shape).astype(np.float32)
    m = StreamedStencil(sp, shape, sweeps_per_call=k, chunks=chunks)
    out = m.iterate_host(x0, iters, bc=bc)
    ref = golden.golden_iterate(x0, sp, iters, bc=bc)
    chk = golden.check_against_golden(out, ref)
    assert chk.ok, chk.message()


def test_periodic_lane_temporal_blocking_gates(rng):
    # a periodic LANE dim at k>1 is no longer gated: the streamed chunk
    # step refreshes every non-chunked dim's wrap after each sweep
    sp = S.get_spec("jacobi7")
    bc = DirichletBC.reference_default(3).with_periodic((2,))
    _streamed_check(sp, (16, 16, 16), bc, 4, 2, 9, rng)


def test_rma_gates_eagerly_on_shallow_unsharded_dynamic_dim():
    # a periodic d0 shallower than the streamed k*r ghost depth must be
    # refused eagerly, not produce a mid-run traceback
    from stencil_tpu.streaming import StreamedStencil

    sp = S.get_spec("jacobi7")
    bc = DirichletBC.reference_default(3).with_periodic((0,))
    m = StreamedStencil(sp, (3, 16, 16), sweeps_per_call=4, chunks=1)
    with pytest.raises(ValueError, match="interior extent"):
        m.iterate_host(np.zeros((3, 16, 16), np.float32), 8, bc=bc)


# ---- sharded and streamed methods vs golden ---------------------------------


@pytest.mark.parametrize("dims", [(0,), (1,), (0, 1)])
@pytest.mark.parametrize("spec_name", ["jacobi5", "jacobi9", "star2d_r2"])
def test_slab_kernel_matches_golden_periodic_2d(spec_name, dims):
    # 2D grids over a 2D mesh: periodic on each sharded dim in turn
    _run_sharded_periodic(S.get_spec(spec_name), (32, 48), (4, 2),
                          ("x", "y"), dims, 6, True)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("dims", [(0,), (1,), (2,), (0, 1, 2)])
def test_tiled_kernel_matches_golden_periodic_3d(rng, k, dims):
    sp = S.get_spec("jacobi7")
    bc = DirichletBC.reference_default(3).with_periodic(dims)
    _streamed_check(sp, (12, 16, 20), bc, k, 3, 5, rng)


@pytest.mark.parametrize("spec_name", ["jacobi27", "laplace3d_ho"])
def test_tiled_kernel_periodic_box_and_r2(rng, spec_name):
    # box corners and radius-2 ghost rings through the wrap and the
    # chunk faces
    sp = S.get_spec(spec_name)
    bc = DirichletBC.reference_default(3).with_periodic((0, 2))
    _streamed_check(sp, (12, 16, 20), bc, 1, 2, 4, rng)


def test_tiled_kernel_periodic_ragged(rng):
    # ragged chunk extents (13 over 2 chunks) + periodic wrap everywhere
    _streamed_check(S.get_spec("jacobi7"), (13, 17, 19),
                    DirichletBC.periodic_all(3), 1, 2, 3, rng)


def test_registry_pallas_periodic_defaults_to_slice():
    # the streamed method through the registry (the CLI's dispatch) on
    # a lane- and d0-periodic grid
    sp = S.get_spec("jacobi7")
    bc = DirichletBC.reference_default(3).with_periodic((0, 2))
    g = HaloGrid.create((12, 16, 20), halo=1, bc=bc)
    cfg = RunConfig(size=(12, 16, 20), spec="jacobi7",
                    methods=("streamed",), chunks=2)
    runner = registry.get_runner("streamed", cfg, sp, g)
    assert runner.plan_info["chunks"] == 2
    out = runner.iterate(g, 3)
    ref = golden.golden_iterate(np.zeros((12, 16, 20)), sp, 3, bc=bc)
    chk = golden.check_against_golden(np.asarray(out.interior()), ref)
    assert chk.ok, chk.message()


def test_cli_periodic_xla_checked(tmp_path):
    from stencil_tpu.cli import run_all

    cfg = RunConfig(size=(20, 24), iterations=8, methods=("xla",),
                    check=True, periodic=("0",),
                    json_out=str(tmp_path / "out.jsonl"))
    results = run_all(cfg, out=open("/dev/null", "w"))
    assert results[0]["check"]["ok"]


def test_cli_periodic_all_parses_and_runs():
    from stencil_tpu import cli

    rc = cli.main(["-s", "12", "16", "-i", "4", "-m", "xla", "-c",
                   "--periodic", "all", "--platform", "cpu"])
    assert rc == 0


def test_cli_periodic_unsupported_method_reports_unavailable(capsys):
    from stencil_tpu import cli

    rc = cli.main(["-s", "16", "16", "-i", "2", "-m", "pallas_temporal",
                   "--periodic", "1", "--platform", "cpu"])
    assert rc == 1
    assert "unknown method 'pallas_temporal'" in capsys.readouterr().out


def test_cli_periodic_pallas_checked(tmp_path):
    # the streamed and sharded paths end-to-end under --periodic, checked
    from stencil_tpu.cli import run_all

    cfg = RunConfig(size=(12, 16, 20), spec="jacobi7", iterations=6,
                    methods=("streamed", "sharded"), check=True,
                    periodic=("0", "2"), chunks=2, mesh=(2, 2),
                    json_out=str(tmp_path / "out.jsonl"))
    results = run_all(cfg, out=open("/dev/null", "w"))
    assert [r["check"]["ok"] for r in results] == [True, True]
    assert results[0]["plan"]["chunks"] == 2


def test_periodic_dims_normalization():
    cfg = RunConfig(size=(8, 8, 8), periodic=("all",))
    assert cfg.periodic_dims() == (0, 1, 2)
    cfg = RunConfig(size=(8, 8), periodic=("1",))
    assert cfg.periodic_dims() == (1,)


# ---- streamed temporal depth (k>1) with periodic dims ------------------------
#
# The streamed chunk step runs k sweeps per host round trip on k*r-deep
# ghost rows; periodic d0 ghosts are wrapped rows of the previous iterate
# (live data, recomputed in the trapezoid), other periodic dims refresh
# their wrap after every sweep.


@pytest.mark.parametrize("dims", [(0,), (1,), (0, 1)])
@pytest.mark.parametrize("k", [4, 8])
def test_tiled_temporal_periodic_leading_dims(rng, dims, k):
    sp = S.get_spec("jacobi7")
    bc = DirichletBC.reference_default(3).with_periodic(dims)
    # 2k + 3 iterations exercise the k'=3 remainder step too
    _streamed_check(sp, (16, 24, 20), bc, k, 2, 2 * k + 3, rng)


def test_tiled_temporal_periodic_rotacc_box(rng):
    sp = S.get_spec("jacobi27")
    bc = DirichletBC.reference_default(3).with_periodic((0, 1))
    _streamed_check(sp, (16, 24, 20), bc, 4, 2, 8, rng)


def test_tiled_temporal_periodic_radius2(rng):
    sp = S.get_spec("laplace3d_ho")
    bc = DirichletBC.reference_default(3).with_periodic((0, 1))
    _streamed_check(sp, (14, 18, 16), bc, 3, 2, 6, rng)


def test_tiled_temporal_periodic_ragged(rng):
    sp = S.get_spec("jacobi7")
    bc = DirichletBC.reference_default(3).with_periodic((0, 1))
    _streamed_check(sp, (13, 17, 19), bc, 4, 2, 8, rng)


def test_registry_pallas_temporal_periodic_leading():
    # the registry's streamed runner honours -k (temporal) on periodic
    # leading dims
    sp = S.get_spec("jacobi7")
    bc = DirichletBC.reference_default(3).with_periodic((0, 1))
    g = HaloGrid.create((16, 24, 20), halo=1, bc=bc)
    cfg = RunConfig(size=(16, 24, 20), spec="jacobi7", temporal=4,
                    chunks=2, methods=("streamed",))
    runner = registry.get_runner("streamed", cfg, sp, g)
    assert runner.granularity == 4
    out = runner.iterate(g, 8)
    ref = golden.golden_iterate(np.zeros((16, 24, 20)), sp, 8, bc=bc)
    chk = golden.check_against_golden(np.asarray(out.interior()), ref)
    assert chk.ok, chk.message()


def test_periodic_interior_shallower_than_temporal_halo_raises():
    # k*r wrap depth needs interior extent >= k*r in the periodic d0
    from stencil_tpu.streaming import StreamedStencil

    sp = S.get_spec("jacobi7")
    bc = DirichletBC.reference_default(3).with_periodic((0,))
    m = StreamedStencil(sp, (6, 16, 16), sweeps_per_call=8, chunks=1)
    with pytest.raises(ValueError, match="interior extent"):
        m.iterate_host(np.zeros((6, 16, 16), np.float32), 8, bc=bc)


# ---- sharded (ppermute halo) over the virtual device mesh --------------------


def _run_sharded_periodic(spec, shape, axis_sizes, axis_names, dims,
                          iters, overlap):
    from stencil_tpu.parallel.halo import ShardedStencil, make_mesh

    rng = np.random.default_rng(11)
    bc = DirichletBC.reference_default(len(shape)).with_periodic(dims)
    x0 = rng.random(shape).astype(np.float32)
    g = HaloGrid.from_interior(jnp.asarray(x0), halo=spec.radius, bc=bc)
    mesh = make_mesh(axis_sizes, [n for n in axis_names if n is not None])
    method = ShardedStencil(spec, tuple(axis_names), overlap=overlap)
    out = method.iterate(g, iters, mesh)
    ref = golden.golden_iterate(x0, spec, iters, bc=bc)
    chk = golden.check_against_golden(np.asarray(out.interior()), ref)
    assert chk.ok, chk.message()


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("dims", [(0,), (1,), (0, 1)])
def test_sharded_periodic_1d_mesh(dims, overlap):
    # periodic along the SHARDED dim = circular ppermute; along the
    # unsharded dim = local wrap strips
    _run_sharded_periodic(S.jacobi5(), (64, 40), (8,), ("x", None),
                          dims, 5, overlap)


@pytest.mark.parametrize("overlap", [False, True])
def test_sharded_periodic_2d_mesh_box(overlap):
    # box corners through doubly-wrapped device boundaries
    _run_sharded_periodic(S.jacobi9(), (32, 48), (4, 2), ("x", "y"),
                          (0, 1), 4, overlap)


def test_sharded_periodic_mixed_2d_mesh():
    # periodic dim 0 over a 4-device ring, Dirichlet dim 1 over 2 devices
    _run_sharded_periodic(S.jacobi9(), (32, 48), (4, 2), ("x", "y"),
                          (0,), 4, True)


def test_sharded_periodic_radius2():
    _run_sharded_periodic(S.star(2, 2), (32, 48), (4, 2), ("x", "y"),
                          (0, 1), 3, True)


def test_sharded_periodic_3d():
    _run_sharded_periodic(S.get_spec("jacobi7"), (16, 12, 40), (8,),
                          ("z", None, None), (0, 2), 3, True)


# ---- checkpoint round trip ---------------------------------------------------


def test_checkpoint_preserves_periodic(tmp_path, rng):
    from stencil_tpu.utils import checkpoint

    bc = DirichletBC.reference_default(2).with_periodic((0,))
    g = HaloGrid.from_interior(
        jnp.asarray(rng.random((10, 12)).astype(np.float32)), halo=1, bc=bc
    )
    p = checkpoint.save(tmp_path / "step_0000000005.npz", g, 5, "jacobi5")
    state = checkpoint.load(p)
    assert state.bc == bc
    assert state.bc.periodic == (True, False)
    # resuming onto a grid with different periodicity must refuse
    g2 = HaloGrid.from_interior(
        jnp.asarray(rng.random((10, 12)).astype(np.float32)), halo=1,
        bc=DirichletBC.reference_default(2),
    )
    run = checkpoint.CheckpointedRun(
        runner=None, directory=tmp_path, spec_name="jacobi5"
    )
    with pytest.raises(ValueError, match="periodic"):
        run.run(g2, 10)


def test_checkpoint_dirichlet_roundtrip_unchanged(tmp_path, rng):
    # pre-periodic semantics: an all-Dirichlet checkpoint loads to a BC
    # that compares equal to the default
    from stencil_tpu.utils import checkpoint

    g = HaloGrid.from_interior(
        jnp.asarray(rng.random((8, 8)).astype(np.float32)), halo=1
    )
    p = checkpoint.save(tmp_path / "step_0000000001.npz", g, 1, "jacobi5")
    state = checkpoint.load(p)
    assert state.bc == DirichletBC.reference_default(2)
    assert not state.bc.any_periodic


# ---- 3D grids over a 2D mesh ----------------------------------------------------


@pytest.mark.parametrize("dims", [(1,), (0,), (2,)])
def test_slab_3d_periodic_k1_matches_golden(dims):
    # each dim periodic in turn: sharded x, sharded y, unsharded lane
    _run_sharded_periodic(S.get_spec("jacobi7"), (16, 16, 40), (2, 2),
                          ("x", "y", None), dims, 3, True)


def test_slab_3d_periodic_d0_temporal_ok(rng):
    # periodic d0 at streamed depth k=2 on a wide lane dim
    sp = S.get_spec("jacobi7")
    bc = DirichletBC.reference_default(3).with_periodic((0,))
    _streamed_check(sp, (16, 16, 128), bc, 2, 2, 4, rng)


def test_cli_check_all_dynamic_bcs_is_not_vacuous(tmp_path):
    # --periodic all on the reference's zero interior would compare
    # 0 with 0 (a zero field is a fixed point of wrap + any linear
    # stencil) — make_grid seeds a nonzero interior when EVERY dim is
    # dynamic so -c actually exercises the BC machinery
    from stencil_tpu.cli import make_grid
    from stencil_tpu.config import RunConfig as RC

    cfg = RC(size=(12, 16), iterations=4, methods=("xla",), check=True,
             periodic=("all",))
    sp = S.get_spec("jacobi5")
    g = make_grid(cfg, sp)
    assert float(np.abs(np.asarray(g.interior())).max()) > 0
    # partial-dynamic grids keep the reference's zero interior
    cfg2 = RC(size=(12, 16), iterations=4, methods=("xla",),
              periodic=("0",))
    g2 = make_grid(cfg2, sp)
    assert float(np.abs(np.asarray(g2.interior())).max()) == 0
    # and the checked run passes end-to-end
    from stencil_tpu.cli import run_all

    results = run_all(cfg, out=open("/dev/null", "w"))
    assert results[0]["check"]["ok"]
