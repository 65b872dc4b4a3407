"""The ``xla`` method across the BC x spec x shape x dtype grid.

The fused-slice XLA sweep is the single-device marching path, so this
grid covers the cases a hand-written kernel is most likely to get wrong:
ragged extents, radius-2 stars and high-order Laplacians, 27-point box
corners, bfloat16, and periodic or Neumann faces on every dim.
Each case starts from a seeded random interior (so no check compares
zero with zero) on a ragged grid and runs through the registry, the CLI's
own dispatch, against the float64 golden model (``ops/golden.py``) at the
reference bar (1e-4 for float32, 3e-2 for bfloat16).
"""

import numpy as np
import pytest

from stencil_tpu import registry
from stencil_tpu.config import RunConfig
from stencil_tpu.core.grid import DirichletBC, HaloGrid
from stencil_tpu.core.spec import get_spec
from stencil_tpu.ops import golden

# Dirichlet faces with distinct values per face, so a face or corner
# read from the wrong side shows
CUSTOM = {2: ((0.1, 0.2), (0.3, 0.4)),
          3: ((0.1, 0.2), (0.3, 0.4), (0.5, 0.6))}

BCS_3D = {
    "dirichlet": ((), ()),
    "periodic0": ((0,), ()),
    "periodic1": ((1,), ()),
    "periodic2": ((2,), ()),
    "neumann0": ((), (0,)),
    "neumann1": ((), (1,)),
    "neumann2": ((), (2,)),
    "mixed": ((0,), (2,)),
}
BCS_2D = {
    "dirichlet": ((), ()),
    "periodic0": ((0,), ()),
    "periodic1": ((1,), ()),
    "neumann0": ((), (0,)),
    "neumann1": ((), (1,)),
    "mixed": ((1,), (0,)),
}


def _bc(ndim, name):
    per, neu = (BCS_3D if ndim == 3 else BCS_2D)[name]
    bc = DirichletBC(values=CUSTOM[ndim])
    if per:
        bc = bc.with_periodic(per)
    if neu:
        bc = bc.with_neumann(neu)
    return bc


def _check(method, spec_name, shape, bc_name, iters, dtype="float32",
           **cfg_kw):
    spec = get_spec(spec_name)
    bc = _bc(len(shape), bc_name)
    x0 = np.random.default_rng(len(shape) * 100 + iters).random(shape)
    grid = HaloGrid.from_interior(np.asarray(x0, dtype), halo=spec.radius,
                                  bc=bc)
    cfg = RunConfig(size=tuple(shape), spec=spec_name, dtype=dtype,
                    methods=(method,), **cfg_kw)
    out = registry.get_runner(method, cfg, spec, grid).iterate(grid, iters)
    ref = golden.golden_iterate(np.asarray(grid.interior(), np.float64),
                                spec, iters, bc=bc)
    chk = golden.check_against_golden(
        np.asarray(out.interior(), np.float64), ref,
        tolerance=3e-2 if dtype == "bfloat16" else 1e-4)
    assert chk.ok, chk.message()



@pytest.mark.parametrize("bc_name", sorted(BCS_3D))
@pytest.mark.parametrize("spec_name", ["jacobi7", "jacobi27", "star3d_r2",
                                       "laplace3d_ho"])
def test_xla_3d_ragged(spec_name, bc_name):
    _check("xla", spec_name, (57, 50, 46), bc_name, 4)


@pytest.mark.parametrize("bc_name", sorted(BCS_2D))
@pytest.mark.parametrize("spec_name", ["jacobi5", "jacobi9", "star2d_r2",
                                       "laplace2d_ho"])
def test_xla_2d_ragged(spec_name, bc_name):
    _check("xla", spec_name, (57, 46), bc_name, 6)


@pytest.mark.parametrize("bc_name", ["dirichlet", "periodic2", "neumann0"])
@pytest.mark.parametrize("spec_name", ["jacobi7", "jacobi27"])
def test_xla_3d_bf16(spec_name, bc_name):
    _check("xla", spec_name, (17, 18, 19), bc_name, 4, dtype="bfloat16")


@pytest.mark.parametrize("bc_name", ["dirichlet", "periodic1"])
@pytest.mark.parametrize("spec_name", ["jacobi5", "jacobi9"])
def test_xla_2d_bf16(spec_name, bc_name):
    _check("xla", spec_name, (33, 30), bc_name, 6, dtype="bfloat16")
