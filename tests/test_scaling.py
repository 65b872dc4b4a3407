"""Weak-scaling harness tests on the virtual mesh: the machinery is what's
validated (CPU timings carry no meaning), but the validation is real — the
full mesh ladder runs up to the 8-device mesh the suite forces, and the
widest mesh's numerical result is cross-checked against the float64
golden model."""

import numpy as np
from jax.sharding import NamedSharding

from stencil_tpu.core.grid import DirichletBC
from stencil_tpu.core.spec import get_spec
from stencil_tpu.ops import golden
from stencil_tpu.parallel.halo import ShardedStencil, make_mesh
from stencil_tpu.scaling import run_weak_scaling


def _measured_path(gshape, n, iters, bc):
    """The exact step run_weak_scaling times: the sharded interior array
    through ShardedStencil.iterate_fn."""
    import jax
    import jax.numpy as jnp

    spec = get_spec("jacobi7")
    method = ShardedStencil(spec, ("x", None, None))
    mesh = make_mesh((n,), ("x",))
    x = jax.device_put(jnp.zeros(gshape, jnp.float32),
                       NamedSharding(mesh, method.partition_spec()))
    out = method.iterate_fn(mesh, bc)(x, jnp.int32(iters))
    ref = golden.golden_iterate(np.zeros(gshape, np.float64), spec, iters,
                                bc=bc)
    np.testing.assert_allclose(np.asarray(out, np.float64), ref,
                               atol=5e-6, rtol=5e-6)


def test_weak_scaling_full_ladder():
    msgs = []
    pts = run_weak_scaling(
        local_shape=(8, 16, 24), spec_name="jacobi7",
        mesh_sizes=[1, 2, 4, 8], progress=msgs.append,
    )
    assert [p.n_devices for p in pts] == [1, 2, 4, 8]
    assert pts[0].efficiency == 1.0
    assert pts[-1].global_shape == (64, 16, 24)
    assert all(p.glups > 0 for p in pts)
    audit = [m for m in msgs if m.startswith("comm audit")]
    assert len(audit) == 1 and "ppermutes/sweep" in audit[0]
    assert "hidden" not in audit[0]
    assert all("GLUPS" in m for m in msgs if not m.startswith("comm audit"))


def test_weak_scaling_8dev_matches_golden():
    """The configuration the harness times at n=8 must produce the
    golden-model result."""
    _measured_path((64, 16, 24), 8, 6, DirichletBC.reference_default(3))


def test_weak_scaling_periodic_torus():
    """Wrapped weak scaling: periodic sharded d0 (the circular ppermute
    ring) + Neumann d1, through the harness's measured path,
    cross-checked against the golden model at the widest mesh."""
    msgs = []
    pts = run_weak_scaling(
        local_shape=(8, 16, 24), spec_name="jacobi7",
        mesh_sizes=[1, 4], periodic=(0,), neumann=(1,),
        progress=msgs.append,
    )
    assert [p.n_devices for p in pts] == [1, 4]
    assert all(p.glups > 0 for p in pts)
    bc = (DirichletBC.reference_default(3)
          .with_periodic((0,)).with_neumann((1,)))
    _measured_path((32, 16, 24), 4, 6, bc)
