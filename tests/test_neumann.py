"""Neumann (zero-flux mirror) boundary conditions.

A capability extension beyond the reference, which is Dirichlet-only
(``stencil.cpp:190-207``). Ghost layer ``j`` mirrors interior layer
``j-1`` across the face plane (NumPy's ``mode='symmetric'``) — the
cell-centered reflection under which the normal derivative vanishes.

Validation strategy mirrors ``tests/test_periodic.py``, with a third,
fully independent reference for the all-Neumann case: per-sweep
``np.pad(mode='symmetric')`` plus direct shifted-window sums (no shared
ghost-fill code at all). The streamed method's k>1 chunk step on a
Neumann d0 requires the stencil mirror-symmetric in d0 — only then does
a sweep preserve the mirror extension its deep ghosts seed — and it
gates asymmetric specs with a clean error; every other dim refreshes its
mirror after each sweep and takes any spec.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from stencil_tpu.config import RunConfig
from stencil_tpu.core import spec as S
from stencil_tpu.core.grid import DirichletBC, HaloGrid, fill_halo
from stencil_tpu.ops import golden, xla
from stencil_tpu import registry


def _asym_spec2d():
    """Radius-1 2D spec asymmetric in dim 0, symmetric in dim 1."""
    return S.weighted(2, [((-1, 0), 0.5), ((1, 0), 0.1), ((0, -1), 0.2),
                          ((0, 1), 0.2)], name="asym2d")


def _asym_spec3d():
    """Radius-1 3D spec asymmetric in dim 1 only."""
    return S.weighted(3, [((-1, 0, 0), 0.2), ((1, 0, 0), 0.2),
                          ((0, -1, 0), 0.3), ((0, 1, 0), 0.1),
                          ((0, 0, -1), 0.1), ((0, 0, 1), 0.1)],
                      name="asym3d")


# ---- DirichletBC neumann-mask semantics --------------------------------------


def test_with_neumann_marks_dims():
    bc = DirichletBC.reference_default(3).with_neumann((0, 2))
    assert bc.neumann == (True, False, True)
    assert bc.any_neumann and bc.any_dynamic and not bc.any_periodic
    assert bc.neumann_mask(3) == (True, False, True)
    assert bc.dynamic_mask(3) == (True, False, True)


def test_with_neumann_empty_is_identity():
    base = DirichletBC.reference_default(2)
    bc = base.with_neumann(())
    assert bc == base
    assert hash(bc) == hash(base)
    assert not bc.any_neumann


def test_neumann_and_periodic_mutually_exclusive():
    with pytest.raises(ValueError, match="not both"):
        DirichletBC.reference_default(2).with_periodic((0,)).with_neumann((0,))
    with pytest.raises(ValueError, match="not both"):
        DirichletBC.reference_default(2).with_neumann((1,)).with_periodic((1,))
    # different dims combine fine
    bc = DirichletBC.reference_default(3).with_periodic((0,)).with_neumann((1,))
    assert bc.periodic_mask(3) == (True, False, False)
    assert bc.neumann_mask(3) == (False, True, False)
    assert bc.dynamic_mask(3) == (True, True, False)


def test_with_neumann_out_of_range():
    bc = DirichletBC.reference_default(2).with_neumann((-1,))
    assert bc.neumann == (False, True)
    with pytest.raises(ValueError, match="out of range"):
        DirichletBC.reference_default(2).with_neumann((2,))


# ---- halo fill / refresh semantics -------------------------------------------


def test_fill_halo_mirrors_neumann_dim():
    x = np.arange(12, dtype=np.float64).reshape(3, 4)
    padded = jnp.pad(jnp.asarray(x), 2)
    padded = fill_halo(padded, 2, DirichletBC.zero(2).with_neumann((0,)))
    p = np.asarray(padded)
    # ghost layer j mirrors interior layer j-1 (symmetric reflection)
    np.testing.assert_array_equal(p[1, 2:-2], x[0])
    np.testing.assert_array_equal(p[0, 2:-2], x[1])
    np.testing.assert_array_equal(p[-2, 2:-2], x[-1])
    np.testing.assert_array_equal(p[-1, 2:-2], x[-2])
    # dim 1 stays Dirichlet (zero faces)
    np.testing.assert_array_equal(p[:, 0], 0.0)


def test_neumann_corner_transitivity():
    # all-Neumann r=1: corner ghost = doubly mirrored = nearest interior
    x = np.arange(12, dtype=np.float64).reshape(3, 4)
    padded = jnp.pad(jnp.asarray(x), 1)
    padded = fill_halo(padded, 1, DirichletBC.zero(2).with_neumann((0, 1)))
    p = np.asarray(padded)
    assert p[0, 0] == x[0, 0]
    assert p[-1, -1] == x[-1, -1]
    assert p[0, -1] == x[0, -1]


def test_neumann_depth_check():
    bc = DirichletBC.zero(2).with_neumann((0,))
    with pytest.raises(ValueError, match="interior extent"):
        fill_halo(jnp.zeros((5, 10)), 2, bc)  # interior 1 < depth 2


# ---- golden model vs independent symmetric-pad reference ---------------------


def _mirror_reference(x0, sp, iterations):
    """Fully independent all-Neumann reference: per-sweep symmetric pad
    + shifted-window sums (shares NO code with the ghost machinery)."""
    x = x0.astype(np.float64)
    r = sp.radius
    for _ in range(iterations):
        ext = np.pad(x, r, mode="symmetric")
        acc = np.zeros_like(x)
        for off, w in zip(sp.offsets, sp.weights):
            idx = tuple(slice(r + o, r + o + n)
                        for o, n in zip(off, x.shape))
            acc = acc + w * ext[idx]
        x = acc
    return x


@pytest.mark.parametrize("spec_name,shape", [
    ("jacobi5", (12, 16)),       # 2D star r=1
    ("jacobi9", (12, 16)),       # 2D box r=1 (corners exercised)
    ("star2d_r2", (12, 16)),     # 2D star r=2 (deep ghosts)
    ("jacobi7", (8, 10, 12)),    # 3D star r=1
    ("jacobi27", (8, 10, 12)),   # 3D box r=1 (3D corners exercised)
])
def test_golden_neumann_equals_mirror_pad(rng, spec_name, shape):
    sp = S.get_spec(spec_name)
    x0 = rng.random(shape)
    bc = DirichletBC.zero(sp.ndim).with_neumann(tuple(range(sp.ndim)))
    out = golden.golden_iterate(x0, sp, 6, bc=bc)
    ref = _mirror_reference(x0, sp, 6)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)


def test_golden_neumann_fixed_point():
    # a constant field under all-Neumann zero-flux BCs with an averaging
    # stencil is exactly preserved (nothing leaks through any face)
    out = golden.golden_iterate(
        np.full((7, 9), 3.25), S.jacobi5(), 20,
        bc=DirichletBC.zero(2).with_neumann((0, 1)),
    )
    np.testing.assert_array_equal(out, 3.25)


def test_golden_neumann_reflection_equivariance(rng):
    # all-Neumann iteration commutes with flipping the field (the mirror
    # BC has no preferred orientation)
    sp = S.jacobi9()
    x0 = rng.random((10, 14))
    bc = DirichletBC.zero(2).with_neumann((0, 1))
    a = golden.golden_iterate(x0[::-1, ::-1].copy(), sp, 4, bc=bc)
    b = golden.golden_iterate(x0, sp, 4, bc=bc)[::-1, ::-1]
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-13)


def test_golden_mixed_periodic_neumann(rng):
    # periodic dim 0 + Neumann dim 1: wrap one way, mirror the other;
    # independent reference built by hand (np.pad wrap then symmetric)
    sp = S.jacobi9()
    x = rng.random((10, 14))
    bc = DirichletBC.zero(2).with_periodic((0,)).with_neumann((1,))
    out = golden.golden_iterate(x, sp, 5, bc=bc)
    ref = x.astype(np.float64)
    for _ in range(5):
        ext = np.pad(ref, ((1, 1), (0, 0)), mode="wrap")
        ext = np.pad(ext, ((0, 0), (1, 1)), mode="symmetric")
        acc = np.zeros_like(ref)
        for off, w in zip(sp.offsets, sp.weights):
            idx = tuple(slice(1 + o, 1 + o + n)
                        for o, n in zip(off, ref.shape))
            acc = acc + w * ext[idx]
        ref = acc
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)


# ---- spec symmetry ------------------------------------------------------------


def test_named_specs_symmetric_everywhere():
    for name in ("jacobi5", "jacobi9", "star2d_r2", "jacobi7", "jacobi27",
                 "laplace3d_ho"):
        sp = S.get_spec(name)
        for d in range(sp.ndim):
            assert sp.symmetric_in(d), (name, d)


def test_asym_spec_symmetry_per_dim():
    sp2 = _asym_spec2d()
    assert not sp2.symmetric_in(0)
    assert sp2.symmetric_in(1)
    sp3 = _asym_spec3d()
    assert sp3.symmetric_in(0)
    assert not sp3.symmetric_in(1)
    assert sp3.symmetric_in(2)


# ---- XLA method vs golden (mixed Dirichlet/Neumann/periodic) ------------------


@pytest.mark.parametrize("spec_name", ["jacobi5", "jacobi9", "star2d_r2"])
@pytest.mark.parametrize("dims", [(0,), (1,), (0, 1)])
def test_xla_matches_golden_neumann_2d(rng, spec_name, dims):
    sp = S.get_spec(spec_name)
    bc = DirichletBC.reference_default(2).with_neumann(dims)
    x0 = rng.random((20, 24)).astype(np.float32)
    g = HaloGrid.from_interior(jnp.asarray(x0), halo=sp.radius, bc=bc)
    out = xla.iterate(g, sp, 7)
    ref = golden.golden_iterate(x0, sp, 7, bc=bc)
    chk = golden.check_against_golden(np.asarray(out.interior()), ref)
    assert chk.ok, chk.message()


@pytest.mark.parametrize("spec_name", ["jacobi7", "jacobi27", "laplace3d_ho"])
@pytest.mark.parametrize("dims", [(2,), (0, 2), (0, 1, 2)])
def test_xla_matches_golden_neumann_3d(rng, spec_name, dims):
    sp = S.get_spec(spec_name)
    bc = DirichletBC.reference_default(3).with_neumann(dims)
    x0 = rng.random((8, 10, 12)).astype(np.float32)
    g = HaloGrid.from_interior(jnp.asarray(x0), halo=sp.radius, bc=bc)
    out = xla.iterate(g, sp, 5)
    ref = golden.golden_iterate(x0, sp, 5, bc=bc)
    chk = golden.check_against_golden(np.asarray(out.interior()), ref)
    assert chk.ok, chk.message()


def test_xla_mixed_periodic_neumann_dirichlet(rng):
    # all three BC kinds on one 3D grid
    sp = S.get_spec("jacobi27")
    bc = (DirichletBC.reference_default(3)
          .with_periodic((0,)).with_neumann((2,)))
    x0 = rng.random((8, 10, 12)).astype(np.float32)
    g = HaloGrid.from_interior(jnp.asarray(x0), halo=1, bc=bc)
    out = xla.iterate(g, sp, 5)
    ref = golden.golden_iterate(x0, sp, 5, bc=bc)
    chk = golden.check_against_golden(np.asarray(out.interior()), ref)
    assert chk.ok, chk.message()


def test_xla_asymmetric_spec_neumann(rng):
    # asymmetric taps are fine at the XLA method (refresh every sweep)
    sp = _asym_spec2d()
    bc = DirichletBC.zero(2).with_neumann((0, 1))
    x0 = rng.random((12, 16)).astype(np.float32)
    g = HaloGrid.from_interior(jnp.asarray(x0), halo=1, bc=bc)
    out = xla.iterate(g, sp, 6)
    ref = golden.golden_iterate(x0, sp, 6, bc=bc)
    chk = golden.check_against_golden(np.asarray(out.interior()), ref)
    assert chk.ok, chk.message()


# ---- native C++ golden twin ----------------------------------------------------


@pytest.mark.parametrize("spec_name,shape,dims", [
    ("jacobi5", (16, 20), (0,)),
    ("jacobi9", (16, 20), (0, 1)),
    ("star2d_r2", (16, 20), (1,)),
    ("jacobi7", (8, 10, 12), (0, 2)),
    ("jacobi27", (8, 10, 12), (0, 1, 2)),
])
def test_native_golden_neumann_matches_numpy(rng, spec_name, shape, dims):
    from stencil_tpu.native import available, golden_iterate_native

    if not available():
        pytest.skip("no C++ toolchain for the native verifier")
    sp = S.get_spec(spec_name)
    bc = DirichletBC.reference_default(sp.ndim).with_neumann(dims)
    x0 = rng.random(shape)
    a = golden.golden_iterate(x0, sp, 5, bc=bc)
    b = golden_iterate_native(x0, sp, 5, bc=bc)
    assert b is not None
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-13)


def test_native_golden_mixed_modes(rng):
    from stencil_tpu.native import available, golden_iterate_native

    if not available():
        pytest.skip("no C++ toolchain for the native verifier")
    sp = S.get_spec("jacobi27")
    bc = (DirichletBC.reference_default(3)
          .with_periodic((1,)).with_neumann((0, 2)))
    x0 = rng.random((8, 10, 12))
    a = golden.golden_iterate(x0, sp, 5, bc=bc)
    b = golden_iterate_native(x0, sp, 5, bc=bc)
    assert b is not None
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-13)


# ---- streamed (out-of-core chunks) and sharded vs golden ------------------------


def _check_tiled(sp, shape, bc, k, iters, rng, dtype="float32", tol=None,
                 chunks=2):
    """The streamed method (``chunks`` d0 chunks, ``k`` sweeps per chunk
    round trip) against the float64 golden."""
    from stencil_tpu.streaming import StreamedStencil

    x0 = rng.random(shape).astype(np.float32)
    m = StreamedStencil(sp, shape, dtype=dtype, sweeps_per_call=k,
                        chunks=chunks)
    out = m.iterate_host(x0.astype(dtype), iters, bc=bc)
    ref = golden.golden_iterate(x0, sp, iters, bc=bc)
    kw = {} if tol is None else {"tolerance": tol}
    chk = golden.check_against_golden(np.asarray(out, np.float64), ref,
                                      **kw)
    assert chk.ok, chk.message()


def test_slab_neumann_lead_k1():
    bc = DirichletBC.reference_default(2).with_neumann((0,))
    _run_sharded_neumann(S.jacobi5(), (32, 40), (2, 2), ("x", "y"), bc, 5,
                         True)


def test_slab_neumann_lead_temporal():
    # a long run over a mirrored sharded d0
    bc = DirichletBC.reference_default(2).with_neumann((0,))
    _run_sharded_neumann(S.jacobi5(), (32, 40), (4,), ("x", None), bc, 19,
                         True)


def test_slab_neumann_lane_k1_slice():
    bc = DirichletBC.reference_default(2).with_neumann((0, 1))
    _run_sharded_neumann(S.jacobi9(), (24, 40), (2, 2), ("x", "y"), bc, 5,
                         False)


def test_slab_neumann_asymmetric_gates_at_temporal():
    # the sharded sweep refreshes mirrors every sweep, so a spec
    # asymmetric in the mirrored, sharded dim needs no gate there
    bc = DirichletBC.zero(2).with_neumann((0,))
    _run_sharded_neumann(_asym_spec2d(), (32, 40), (4,), ("x", None), bc,
                         8, True)


def test_slab_neumann_asymmetric_k1_ok():
    bc = DirichletBC.zero(2).with_neumann((0, 1))
    _run_sharded_neumann(_asym_spec2d(), (32, 40), (2, 2), ("x", "y"), bc,
                         5, True)


@pytest.mark.parametrize("dims", [(0,), (1,), (0, 1)])
@pytest.mark.parametrize("k", [1, 4])
def test_tiled_neumann_leading_dims(rng, dims, k):
    bc = DirichletBC.reference_default(3).with_neumann(dims)
    _check_tiled(S.get_spec("jacobi7"), (16, 24, 20), bc, k, 2 * k + 3, rng)


def test_tiled_neumann_rotacc_box(rng):
    bc = DirichletBC.reference_default(3).with_neumann((0, 1))
    _check_tiled(S.get_spec("jacobi27"), (16, 24, 20), bc, 4, 8, rng)


def test_tiled_neumann_radius2(rng):
    bc = DirichletBC.reference_default(3).with_neumann((0, 1))
    _check_tiled(S.get_spec("laplace3d_ho"), (14, 18, 16), bc, 3, 6, rng)


def test_tiled_neumann_ragged(rng):
    bc = DirichletBC.reference_default(3).with_neumann((0, 1))
    _check_tiled(S.get_spec("jacobi7"), (13, 17, 19), bc, 4, 8, rng)


def test_tiled_neumann_bf16(rng):
    bc = DirichletBC.reference_default(3).with_neumann((0, 1))
    _check_tiled(S.get_spec("jacobi7"), (16, 24, 20), bc, 4, 8, rng,
                 dtype="bfloat16", tol=3e-2)


def test_tiled_mixed_periodic_neumann(rng):
    bc = (DirichletBC.reference_default(3)
          .with_periodic((0,)).with_neumann((1,)))
    _check_tiled(S.get_spec("jacobi7"), (16, 24, 20), bc, 4, 9, rng)


def test_tiled_neumann_lane_k1_slice(rng):
    bc = DirichletBC.reference_default(3).with_neumann((2,))
    _check_tiled(S.get_spec("jacobi27"), (12, 16, 20), bc, 1, 4, rng)


def test_tiled_neumann_lane_gates_at_temporal(rng):
    # a Neumann lane dim at k=4 runs on the streamed chunk step (its
    # mirror is refreshed after every sweep)
    bc = DirichletBC.reference_default(3).with_neumann((2,))
    _check_tiled(S.get_spec("jacobi7"), (16, 16, 16), bc, 4, 8, rng)


def test_tiled_neumann_asymmetric_gates_at_temporal():
    # a spec asymmetric in d0 at k>1 with a Neumann d0 is refused
    from stencil_tpu.streaming import StreamedStencil

    sp = S.weighted(3, [((-1, 0, 0), 0.5), ((1, 0, 0), 0.1),
                        ((0, 1, 0), 0.2), ((0, -1, 0), 0.2)],
                    name="asym_d0")
    bc = DirichletBC.zero(3).with_neumann((0,))
    m = StreamedStencil(sp, (16, 16, 16), sweeps_per_call=4, chunks=2)
    with pytest.raises(ValueError, match="mirror-symmetric"):
        m.iterate_host(np.zeros((16, 16, 16), np.float32), 4, bc=bc)


def test_tiled_neumann_asymmetric_k1_ok(rng):
    # the asymmetric dim-1 spec is fine at k=1 (refresh every sweep)
    bc = DirichletBC.zero(3).with_neumann((1,))
    _check_tiled(_asym_spec3d(), (16, 24, 20), bc, 1, 5, rng)


def test_tiled_neumann_asymmetric_temporal_ok_on_symmetric_dim(rng):
    # the same spec IS symmetric in dim 0 — Neumann dim 0 runs at k>1,
    # and its asymmetric (refreshed) dim 1 may be Neumann too
    bc = DirichletBC.zero(3).with_neumann((0, 1))
    _check_tiled(_asym_spec3d(), (16, 24, 20), bc, 4, 8, rng)


# ---- sharded (ppermute halo) over the virtual device mesh ----------------------


def _run_sharded_neumann(spec, shape, axis_sizes, axis_names, bc,
                         iters, overlap):
    from stencil_tpu.parallel.halo import ShardedStencil, make_mesh

    rng = np.random.default_rng(17)
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
def test_sharded_neumann_1d_mesh(dims, overlap):
    # Neumann along the SHARDED dim = mesh-edge devices mirror their own
    # edge strips; along the unsharded dim = local mirror strips
    bc = DirichletBC.reference_default(2).with_neumann(dims)
    _run_sharded_neumann(S.jacobi5(), (64, 40), (8,), ("x", None),
                         bc, 5, overlap)


@pytest.mark.parametrize("overlap", [False, True])
def test_sharded_neumann_2d_mesh_box(overlap):
    # box corners through doubly-mirrored device boundaries
    bc = DirichletBC.reference_default(2).with_neumann((0, 1))
    _run_sharded_neumann(S.jacobi9(), (32, 48), (4, 2), ("x", "y"),
                         bc, 4, overlap)


def test_sharded_mixed_periodic_neumann_2d_mesh():
    # periodic ring on dim 0, Neumann mirror on dim 1, over a 4x2 mesh
    bc = (DirichletBC.reference_default(2)
          .with_periodic((0,)).with_neumann((1,)))
    _run_sharded_neumann(S.jacobi9(), (32, 48), (4, 2), ("x", "y"),
                         bc, 4, True)


def test_sharded_neumann_radius2():
    bc = DirichletBC.reference_default(2).with_neumann((0, 1))
    _run_sharded_neumann(S.star(2, 2), (32, 48), (4, 2), ("x", "y"),
                         bc, 3, True)


def test_sharded_neumann_3d():
    bc = DirichletBC.reference_default(3).with_neumann((0, 2))
    _run_sharded_neumann(S.get_spec("jacobi7"), (16, 12, 40), (8,),
                         ("z", None, None), bc, 3, True)


# ---- method gating + registry + CLI --------------------------------------------


def test_rma_gates_cleanly_on_lane_neumann():
    # a Neumann lane dim on a sharded 2D grid (local mirror strips)
    bc = DirichletBC.reference_default(2).with_neumann((1,))
    _run_sharded_neumann(S.jacobi9(), (32, 40), (4,), ("x", None), bc, 5,
                         True)


def test_sharded_pallas_gates_on_dynamic_lane():
    # a Neumann lane dim on a 3D grid sharded over a 2x2 mesh
    bc = DirichletBC.reference_default(3).with_neumann((2,))
    _run_sharded_neumann(S.get_spec("jacobi27"), (16, 16, 20), (2, 2),
                         ("x", "y", None), bc, 4, True)


def test_sharded_pallas_gates_asymmetric_neumann_at_temporal():
    # asymmetric taps in the SHARDED, mirrored dim 1: mesh-edge devices
    # mirror their own strips every sweep
    bc = DirichletBC.zero(3).with_neumann((1,))
    _run_sharded_neumann(_asym_spec3d(), (16, 16, 16), (2, 2),
                         ("x", "y", None), bc, 6, True)


def test_registry_tiled_neumann_leading():
    sp = S.get_spec("jacobi7")
    bc = DirichletBC.reference_default(3).with_neumann((0, 1))
    g = HaloGrid.create((16, 24, 20), halo=1, bc=bc)
    cfg = RunConfig(size=(16, 24, 20), spec="jacobi7", temporal=4,
                    chunks=2, methods=("streamed",))
    runner = registry.get_runner("streamed", cfg, sp, g)
    out = runner.iterate(g, 8)
    ref = golden.golden_iterate(np.zeros((16, 24, 20)), sp, 8, bc=bc)
    chk = golden.check_against_golden(np.asarray(out.interior()), ref)
    assert chk.ok, chk.message()


def test_registry_neumann_lane_defaults_to_slice():
    # the registry's sharded runner on a Neumann lane dim
    sp = S.get_spec("jacobi7")
    bc = DirichletBC.reference_default(3).with_neumann((2,))
    g = HaloGrid.create((12, 16, 20), halo=1, bc=bc)
    cfg = RunConfig(size=(12, 16, 20), spec="jacobi7", mesh=(2, 2),
                    methods=("sharded",))
    runner = registry.get_runner("sharded", cfg, sp, g)
    out = runner.iterate(g, 3)
    ref = golden.golden_iterate(np.zeros((12, 16, 20)), sp, 3, bc=bc)
    chk = golden.check_against_golden(np.asarray(out.interior()), ref)
    assert chk.ok, chk.message()


def test_cli_neumann_checked(tmp_path):
    from stencil_tpu.cli import run_all

    cfg = RunConfig(size=(20, 24), iterations=8, methods=("xla",),
                    check=True, neumann=("0",),
                    json_out=str(tmp_path / "out.jsonl"))
    results = run_all(cfg, out=open("/dev/null", "w"))
    assert results[0]["check"]["ok"]


def test_cli_mixed_periodic_neumann_pallas_checked(tmp_path):
    from stencil_tpu.cli import run_all

    cfg = RunConfig(size=(16, 20, 24), spec="jacobi7", iterations=8,
                    methods=("streamed", "sharded"), check=True,
                    periodic=("0",), neumann=("1",), chunks=2, mesh=(2,),
                    json_out=str(tmp_path / "out.jsonl"))
    results = run_all(cfg, out=open("/dev/null", "w"))
    assert [r["check"]["ok"] for r in results] == [True, True]


def test_cli_neumann_all_parses_and_runs():
    from stencil_tpu import cli

    rc = cli.main(["-s", "12", "16", "-i", "4", "-m", "xla", "-c",
                   "--neumann", "all", "--platform", "cpu"])
    assert rc == 0


def test_cli_same_dim_periodic_and_neumann_errors(capsys):
    from stencil_tpu import cli

    rc = cli.main(["-s", "12", "16", "-i", "2", "-m", "xla",
                   "--periodic", "0", "--neumann", "0",
                   "--platform", "cpu"])
    assert rc == 2
    assert "not both" in capsys.readouterr().err


def test_neumann_dims_normalization():
    cfg = RunConfig(size=(8, 8, 8), neumann=("all",))
    assert cfg.neumann_dims() == (0, 1, 2)
    cfg = RunConfig(size=(8, 8), neumann=("1",))
    assert cfg.neumann_dims() == (1,)


# ---- checkpoint round trip -------------------------------------------------------


def test_checkpoint_preserves_neumann(tmp_path, rng):
    from stencil_tpu.utils import checkpoint

    bc = DirichletBC.reference_default(2).with_neumann((0,))
    g = HaloGrid.from_interior(
        jnp.asarray(rng.random((10, 12)).astype(np.float32)), halo=1, bc=bc
    )
    p = checkpoint.save(tmp_path / "step_0000000005.npz", g, 5, "jacobi5")
    state = checkpoint.load(p)
    assert state.bc == bc
    assert state.bc.neumann == (True, False)
    # resuming onto a grid with different BC modes must refuse
    g2 = HaloGrid.from_interior(
        jnp.asarray(rng.random((10, 12)).astype(np.float32)), halo=1,
        bc=DirichletBC.reference_default(2).with_periodic((0,)),
    )
    run = checkpoint.CheckpointedRun(
        runner=None, directory=tmp_path, spec_name="jacobi5"
    )
    with pytest.raises(ValueError, match="neumann"):
        run.run(g2, 10)


# ---- seeded fuzz: random BC-mode assignments ------------------------------------


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_random_bc_modes_tiled(seed):
    """Random per-dim BC modes (Dirichlet/periodic/Neumann) x random
    ragged shapes x random streamed depth and chunk count, differential
    vs golden."""
    from stencil_tpu.streaming import StreamedStencil

    rng = np.random.default_rng(1000 + seed)
    shape = tuple(int(rng.integers(10, 28)) for _ in range(3))
    modes = [int(rng.integers(0, 3)) for _ in range(3)]
    per = tuple(d for d in range(3) if modes[d] == 1)
    neu = tuple(d for d in range(3) if modes[d] == 2)
    bc = DirichletBC.reference_default(3)
    if per:
        bc = bc.with_periodic(per)
    if neu:
        bc = bc.with_neumann(neu)
    k = int(rng.choice([1, 2, 4]))
    chunks = int(rng.integers(1, 4))
    while chunks > 1 and shape[0] // chunks < k:
        chunks -= 1
    iters = max(int(rng.integers(1, 3)) * k + int(rng.integers(0, k)), 1)

    x0 = rng.random(shape).astype(np.float32)
    m = StreamedStencil(S.get_spec("jacobi7"), shape, sweeps_per_call=k,
                        chunks=chunks)
    out = m.iterate_host(x0, iters, bc=bc)
    ref = golden.golden_iterate(x0, S.get_spec("jacobi7"), iters, bc=bc)
    chk = golden.check_against_golden(out, ref)
    assert chk.ok, (shape, modes, k, chunks, iters, chk.message())
