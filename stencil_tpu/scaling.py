"""Weak-scaling harness: per-chip throughput vs mesh size.

BASELINE.json's multi-chip target is "sharded 3D 7-point Jacobi,
ppermute halo exchange overlapped with interior compute, >= 90%
weak-scaling efficiency". This harness measures that protocol on the
``sharded`` method (``parallel/halo.py``): hold the per-device block
constant, grow the 1D mesh, report per-device GLUPS and efficiency vs the
single-device run.

The reference has no multi-node story at all (its LSF scripts always run
one node, ``run.sh:2``; the "multiple rounds" chunking its options
describe was never implemented, ``program_options.hpp:11-14``).

On a CPU host this runs on the virtual device mesh (functional
validation + plumbing check; CPU "efficiency" numbers are not meaningful).
On a multi-GPU host the same entry point, one process driving every
card, produces the measurement.

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python -m stencil_tpu.scaling --platform cpu --local 64 128 128
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class ScalePoint:
    n_devices: int
    global_shape: Tuple[int, ...]
    glups: float
    glups_per_chip: float
    efficiency: float  # vs the 1-device per-chip rate


def run_weak_scaling(
    local_shape: Sequence[int] = (64, 128, 128),
    spec_name: str = "jacobi7",
    mesh_sizes: Optional[Sequence[int]] = None,
    dtype: str = "float32",
    periodic: Sequence[int] = (),
    neumann: Sequence[int] = (),
    progress=print,
) -> List[ScalePoint]:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from stencil_tpu.core.grid import DirichletBC
    from stencil_tpu.core.spec import get_spec
    from stencil_tpu.parallel.halo import ShardedStencil, make_mesh
    from stencil_tpu.utils.timing import measure_marginal

    spec = get_spec(spec_name)
    ndim = len(local_shape)
    # dynamic BCs ride the same sharded machinery (a periodic sharded d0
    # is the wrapped domain classic weak scaling assumes: the ppermute
    # chain closes into the circular permutation)
    bc = DirichletBC.reference_default(ndim)
    if periodic:
        bc = bc.with_periodic(tuple(periodic))
    if neumann:
        bc = bc.with_neumann(tuple(neumann))
    n_avail = len(jax.devices())
    if mesh_sizes is None:
        mesh_sizes = [n for n in (1, 2, 4, 8, 16, 32, 64) if n <= n_avail]
    method = ShardedStencil(spec, ("x",) + (None,) * (ndim - 1))

    points: List[ScalePoint] = []
    base_per_chip = None
    audited = False
    for n in mesh_sizes:
        gshape = (local_shape[0] * n,) + tuple(local_shape[1:])
        mesh = make_mesh((n,), ("x",))
        # the raw sharded step on the interior array: HaloGrid.iterate
        # re-pads the global array per call, which is not part of the
        # steady-state scaling cost
        x = jax.device_put(jnp.zeros(gshape, dtype),
                           NamedSharding(mesh, method.partition_spec()))
        fn = method.iterate_fn(mesh, bc)

        def run(it, fn=fn, x=x):
            return fn(x, jnp.int32(it))

        if not audited and n > 1:
            # static comm audit: per-device exchanged bytes and the
            # no-hidden-collective guarantee the >=90% target rests on
            # (mesh-size independent; tests/test_comm_volume.py pins it)
            from stencil_tpu.parallel.comm_audit import audit_step

            a = audit_step(fn, jax.ShapeDtypeStruct(gshape, x.dtype),
                           jax.ShapeDtypeStruct((), np.int32))
            extra = (f", PLUS hidden collectives: "
                     f"{a['other_collectives']}"
                     if a["other_collectives"] else "")
            progress(
                f"comm audit: {a['ppermute_count']} ppermutes/sweep, "
                f"{a['ppermute_bytes'] / 1e6:.2f} MB/device/sweep "
                f"(mesh-size independent){extra}"
            )
            audited = True

        m = measure_marginal(run)
        glups = float(np.prod(gshape)) / m.seconds_per_iteration / 1e9
        per_chip = glups / n
        if base_per_chip is None:
            base_per_chip = per_chip
        pt = ScalePoint(
            n_devices=n, global_shape=gshape, glups=glups,
            glups_per_chip=per_chip,
            efficiency=per_chip / base_per_chip,
        )
        points.append(pt)
        progress(
            f"n={n:3d}  global={'x'.join(map(str, gshape))}  "
            f"{glups:8.2f} GLUPS  {per_chip:7.2f}/device  "
            f"eff={100 * pt.efficiency:.0f}%"
        )
    return points


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="stencil-tpu-scaling")
    p.add_argument("--local", type=int, nargs="+", default=[64, 128, 128],
                   help="per-device interior block (weak scaling holds "
                        "this constant)")
    p.add_argument("--spec", type=str, default="jacobi7")
    p.add_argument("--mesh-sizes", type=int, nargs="*", default=None)
    p.add_argument("--dtype", type=str, default="float32")
    p.add_argument("--periodic", type=int, nargs="*", default=[],
                   help="dims with wrap-around BCs (a periodic sharded "
                        "d0 = the wrapped weak-scaling domain)")
    p.add_argument("--neumann", type=int, nargs="*", default=[],
                   help="dims with zero-flux mirror BCs")
    p.add_argument("--json-out", type=str, default=None)
    p.add_argument("--platform", type=str, default="")
    ns = p.parse_args(argv)
    if ns.platform:
        import jax

        jax.config.update("jax_platforms", ns.platform)
    pts = run_weak_scaling(tuple(ns.local), ns.spec,
                           ns.mesh_sizes, ns.dtype,
                           periodic=ns.periodic, neumann=ns.neumann)
    if ns.json_out:
        with open(ns.json_out, "w") as f:
            for pt in pts:
                f.write(json.dumps(dataclasses.asdict(pt)) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
