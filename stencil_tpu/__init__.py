"""stencil_tpu — a JAX structured-grid stencil framework.

A from-scratch JAX/XLA rebuild of the capabilities of the Sunway SW26010
``athread`` stencil benchmark suite (Pluto-Zy/stencil, surveyed in
``SURVEY.md``): halo'd grids with Dirichlet boundary conditions, 2D/3D
star/box stencil specs of arbitrary radius, a float64 golden model with
differential checking, fused XLA sweeps, multi-device halo exchange via
``shard_map`` + ``ppermute``, out-of-core streaming, the solver stack
(multigrid, CG, BiCGStab, GMRES), and a typed config + benchmark driver
with GLUPS/roofline reporting.
"""

__version__ = "0.2.0"

from stencil_tpu.core.grid import DirichletBC, HaloGrid
from stencil_tpu.core.spec import (
    StencilSpec,
    box,
    get_spec,
    jacobi5,
    jacobi7_3d,
    jacobi9,
    jacobi27_3d,
    star,
    weighted,
)

def __getattr__(name):
    """Lazy top-level access to the solver stack (keeps ``import
    stencil_tpu`` light): ``Multigrid``, ``ConjugateGradient``, and the
    model classes live in their own modules but read naturally from the
    package root."""
    lazy = {
        "Multigrid": ("stencil_tpu.multigrid", "Multigrid"),
        "OperatorMultigrid": ("stencil_tpu.multigrid",
                              "OperatorMultigrid"),
        "ConjugateGradient": ("stencil_tpu.krylov", "ConjugateGradient"),
        "BiCGStab": ("stencil_tpu.krylov", "BiCGStab"),
        "GMRES": ("stencil_tpu.krylov", "GMRES"),
        "PoissonProblem": ("stencil_tpu.models.poisson", "PoissonProblem"),
        "AdvectionDiffusionProblem": (
            "stencil_tpu.models.advection_diffusion",
            "AdvectionDiffusionProblem"),
        "HeterogeneousPoissonProblem": (
            "stencil_tpu.models.diffusion",
            "HeterogeneousPoissonProblem"),
    }
    if name in lazy:
        import importlib

        mod, attr = lazy[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'stencil_tpu' has no attribute {name!r}")


def get_runner(name, config, spec, grid):
    """Convenience re-export of :func:`stencil_tpu.registry.get_runner`."""
    from stencil_tpu import registry

    return registry.get_runner(name, config, spec, grid)


def solve(runner, grid, **kwargs):
    """Convenience re-export of :func:`stencil_tpu.solver.solve`."""
    from stencil_tpu import solver

    return solver.solve(runner, grid, **kwargs)


__all__ = [
    "AdvectionDiffusionProblem",
    "BiCGStab",
    "ConjugateGradient",
    "GMRES",
    "HeterogeneousPoissonProblem",
    "OperatorMultigrid",
    "DirichletBC",
    "HaloGrid",
    "Multigrid",
    "PoissonProblem",
    "StencilSpec",
    "box",
    "get_runner",
    "get_spec",
    "jacobi5",
    "jacobi7_3d",
    "jacobi9",
    "jacobi27_3d",
    "solve",
    "star",
    "weighted",
]
