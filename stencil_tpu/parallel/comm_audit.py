"""Static communication audit: the testable proxy for the weak-scaling
north star.

One chip cannot *measure* multi-chip scaling, but the property the >=90%
weak-scaling claim rests on is static and checkable: a distributed outer
step exchanges exactly the halo strips — ``2 * k * r`` ghost planes per
sharded dim, whose bytes depend on the LOCAL block geometry only — and
nothing else (no hidden all-gather/reshard that would grow with the mesh
or the global problem). This module extracts that from the jaxpr of the
jitted step function: every collective primitive inside (transitively,
through pjit/shard_map/while/scan sub-jaxprs) is collected with its
operand aval, so a test can assert the exact byte count and fail the
moment anyone introduces an extra collective.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

# jax.lax collective primitive names (jax 0.9 spelling). ppermute is the
# only one the halo exchange is allowed to use.
COLLECTIVE_PRIMITIVES = {
    "ppermute",
    "pbroadcast",
    "psum",
    "psum_invariant",
    "pmin",
    "pmax",
    "all_gather",
    "all_gather_invariant",
    "all_to_all",
    "psum_scatter",
    "reduce_scatter",
    "pgather",
}


def _walk(jaxpr, found: List[Tuple[str, Any]]) -> None:
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name in COLLECTIVE_PRIMITIVES:
            found.append((name, eqn.invars[0].aval))
        for v in eqn.params.values():
            stack = [v]
            while stack:
                u = stack.pop()
                if isinstance(u, (tuple, list)):
                    stack.extend(u)
                elif hasattr(u, "jaxpr") and hasattr(u.jaxpr, "eqns"):
                    _walk(u.jaxpr, found)
                elif hasattr(u, "eqns"):
                    _walk(u, found)


def collectives_in(fn, *example_args) -> List[Tuple[str, Any]]:
    """All collective (primitive name, operand aval) pairs in the jaxpr of
    ``fn`` traced at ``example_args`` (``jax.ShapeDtypeStruct`` accepted).

    Equations inside loop bodies appear ONCE — i.e. the result counts
    collectives *per executed step*, which is exactly the per-outer-step
    accounting the weak-scaling proxy needs.
    """
    import jax

    traced = jax.jit(fn).trace(*example_args)
    found: List[Tuple[str, Any]] = []
    _walk(traced.jaxpr.jaxpr, found)
    return found


GSPMD_COLLECTIVE_OPS = (
    "collective-permute",
    "all-reduce",
    "all-gather",
    "all-to-all",
    "reduce-scatter",
)


def audit_gspmd(fn, *example_args) -> Dict[str, int]:
    """Collective-op counts in the COMPILED HLO of a GSPMD computation.

    The jaxpr walk above cannot see ``with_sharding_constraint``
    communication — XLA's SPMD partitioner materializes those
    collectives at compile time — so the solver stack's distributed
    paths (the sharded multigrid cycle, distributed CG/PCG/BiCGStab)
    are audited here instead: lower + compile under the shardings the
    function closes over, then count the collective ops in the HLO
    text (async ``-start`` forms counted once, ``-done`` ignored).

    What is and is not invariant (measured, ``tests/test_comm_volume.py``):
    ``all-reduce`` is exactly the algorithm's dot products and
    ``all-gather`` the constant sharded->replicated coarse-tail
    transitions — both independent of mesh size; ``collective-permute``
    (the halo exchanges) varies in OP COUNT with the device count
    because GSPMD specializes uneven odd-width shards per mesh, while
    per-device halo BYTES stay local-geometry-bound; ``all-to-all`` /
    ``reduce-scatter`` must never appear.

    ``fn`` may be a plain callable or an already-jitted function;
    ``example_args`` may be ``jax.ShapeDtypeStruct``s.
    """
    import re

    import jax

    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    txt = jitted.lower(*example_args).compile().as_text()
    return {
        op: len(re.findall(r"= \S+ " + op + r"(?:-start)?\(", txt))
        for op in GSPMD_COLLECTIVE_OPS
    }


def audit_step(fn, *example_args) -> Dict[str, Any]:
    """Summary of a distributed step function's communication:

    ``ppermute_count``/``ppermute_bytes``: halo-exchange sends per
    executed outer step and their total per-device payload bytes (aval
    shapes inside ``shard_map`` are device-local).
    ``other_collectives``: names of any non-ppermute collective — must be
    empty for a pure halo-exchange step.
    """
    found = collectives_in(fn, *example_args)
    pbytes = 0
    pcount = 0
    others = []
    for name, aval in found:
        if name == "ppermute":
            pcount += 1
            pbytes += int(np.prod(aval.shape)) * aval.dtype.itemsize
        else:
            others.append(name)
    return {
        "ppermute_count": pcount,
        "ppermute_bytes": pbytes,
        "other_collectives": others,
    }
