"""The ``sharded`` method across the BC x spec x mesh grid.

shard_map + ppermute halo exchange is the multi-device marching
path (NCCL on GPUs). Each case runs on a 1D mesh of 4 devices
(d0 sharded) and a 2x2 mesh (d0 and d1 sharded): periodic
sharded dims take the circular permutation, Neumann ones mirror
on mesh-edge devices, box stencils carry corners through the
dim-ordered exchange.
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



MESHES = [(4,), (2, 2)]


@pytest.mark.parametrize("mesh", MESHES, ids=["mesh4", "mesh2x2"])
@pytest.mark.parametrize("bc_name", sorted(BCS_3D))
@pytest.mark.parametrize("spec_name", ["jacobi7", "jacobi27", "star3d_r2"])
def test_sharded_3d(spec_name, bc_name, mesh):
    _check("sharded", spec_name, (56, 50, 46), bc_name, 4, mesh=mesh)


@pytest.mark.parametrize("mesh", MESHES, ids=["mesh4", "mesh2x2"])
@pytest.mark.parametrize("bc_name", sorted(BCS_2D))
@pytest.mark.parametrize("spec_name", ["jacobi5", "jacobi9", "star2d_r2"])
def test_sharded_2d(spec_name, bc_name, mesh):
    _check("sharded", spec_name, (56, 46), bc_name, 5, mesh=mesh)


@pytest.mark.parametrize("mesh", MESHES, ids=["mesh4", "mesh2x2"])
@pytest.mark.parametrize("bc_name", ["dirichlet", "mixed"])
def test_sharded_noverlap_3d_box(bc_name, mesh):
    _check("sharded_noverlap", "jacobi27", (56, 50, 46), bc_name, 4,
           mesh=mesh)


@pytest.mark.parametrize("mesh", MESHES, ids=["mesh4", "mesh2x2"])
@pytest.mark.parametrize("bc_name", ["dirichlet", "periodic0"])
def test_sharded_3d_bf16(bc_name, mesh):
    _check("sharded", "jacobi7", (16, 18, 20), bc_name, 4,
           dtype="bfloat16", mesh=mesh)
