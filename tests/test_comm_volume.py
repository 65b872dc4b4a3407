"""Comm-volume regression proof: the testable single-device proxy for the
>=90% weak-scaling north star (BASELINE).

The claim rests on a static property: a distributed sweep exchanges
exactly ``2 * r`` ghost planes per sharded dim — bytes a function of the
LOCAL block geometry only, independent of mesh size — and introduces no
other collective (a hidden all-gather/reshard would scale with the global
problem and sink weak scaling). These tests pin that property via jaxpr
inspection (``parallel.comm_audit``) for the ``sharded`` path, so they
FAIL the moment anyone adds a collective or widens a strip.
"""

import jax
import numpy as np
import pytest

from stencil_tpu.core.grid import DirichletBC
from stencil_tpu.core.spec import get_spec
from stencil_tpu.parallel import comm_audit
from stencil_tpu.parallel.halo import ShardedStencil, make_mesh


def _audit_sharded(shape, mesh_sizes, overlap, spec_name="jacobi7"):
    spec = get_spec(spec_name)
    axes = ("x", "y")[: len(mesh_sizes)]
    mesh = make_mesh(mesh_sizes, axes)
    names = axes + (None,) * (len(shape) - len(axes))
    method = ShardedStencil(spec, names, overlap=overlap)
    bc = DirichletBC.reference_default(len(shape))
    fn = method.iterate_fn(mesh, bc)
    data = jax.ShapeDtypeStruct(tuple(shape), np.float32)
    n = jax.ShapeDtypeStruct((), np.int32)
    return spec, fn, comm_audit.audit_step(fn, data, n)


def _expected_bytes(shape, mesh_sizes, r, overlap):
    """Independent strip-geometry derivation per sweep. Without overlap
    the dims are exchanged in order: each sharded dim's lo+hi strips are
    ``r`` deep and span the ghost-extended extent of EARLIER dims and the
    local interior of later ones. With overlap the minor dims go first
    and the d0 strips span the ghost-extended minor extents."""
    local = [n // (mesh_sizes[d] if d < len(mesh_sizes) else 1)
             for d, n in enumerate(shape)]
    nd = len(shape)
    total = 0
    if not overlap:
        for d in range(len(mesh_sizes)):
            ext = [local[e] + 2 * r if e < d else local[e]
                   for e in range(nd)]
            ext[d] = r
            total += 2 * int(np.prod(ext))
    else:
        for d in range(1, len(mesh_sizes)):
            ext = [local[e] + 2 * r if 0 < e < d else local[e]
                   for e in range(nd)]
            ext[d] = r
            total += 2 * int(np.prod(ext))
        total += 2 * r * int(np.prod([n + 2 * r for n in local[1:]]))
    return total * 4


@pytest.mark.parametrize("spec_name", ["jacobi7", "star3d_r2"])
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("mesh_sizes", [(4,), (2, 4)])
def test_sharded_pallas_exchanges_exactly_the_halo(mesh_sizes, overlap,
                                                   spec_name):
    # local d0 >= 4r on every mesh, so the overlapped split is taken
    shape = (32, 16, 20)
    spec, _, audit = _audit_sharded(shape, mesh_sizes, overlap, spec_name)
    assert audit["other_collectives"] == [], (
        "halo exchange must be pure ppermute; found "
        f"{audit['other_collectives']}"
    )
    assert audit["ppermute_count"] == 2 * len(mesh_sizes)
    assert audit["ppermute_bytes"] == _expected_bytes(
        shape, mesh_sizes, spec.radius, overlap)


def test_sharded_pallas_comm_independent_of_mesh_size():
    """Weak scaling's static half: per-device exchanged bytes depend on
    the LOCAL block only — growing the mesh (with the global problem)
    must not change them."""
    results = []
    for n in (2, 4, 8):
        shape = (8 * n, 16, 20)  # local block fixed at (8, 16, 20)
        _, _, audit = _audit_sharded(shape, (n,), True)
        assert audit["other_collectives"] == []
        results.append(audit["ppermute_bytes"])
    assert results[0] == results[1] == results[2]


@pytest.mark.parametrize("overlap", [False, True])
def test_sharded_pallas_2d_grid_slab_path(overlap):
    shape = (64, 40)
    spec, _, audit = _audit_sharded(shape, (4,), overlap, "jacobi5")
    assert audit["other_collectives"] == []
    assert audit["ppermute_count"] == 2
    assert audit["ppermute_bytes"] == _expected_bytes(
        shape, (4,), spec.radius, overlap)


def _loop_body(jaxpr):
    """The innermost jaxpr that contains the ppermutes (the per-sweep
    loop body inside shard_map)."""
    if any(e.primitive.name == "ppermute" for e in jaxpr.eqns):
        return jaxpr
    for eqn in jaxpr.eqns:
        stack = list(eqn.params.values())
        while stack:
            u = stack.pop()
            if isinstance(u, (tuple, list)):
                stack.extend(u)
            elif hasattr(u, "jaxpr") and hasattr(u.jaxpr, "eqns"):
                r = _loop_body(u.jaxpr)
                if r is not None:
                    return r
            elif hasattr(u, "eqns"):
                r = _loop_body(u)
                if r is not None:
                    return r
    return None


def test_interior_kernel_is_independent_of_the_exchange():
    """The static proof behind the overlapped sharded sweep: inside the
    per-sweep loop body, the interior band's transitive inputs contain
    NO d0 ppermute (XLA is free to overlap them), while the two boundary
    bands consume the exchanged strips. This is the dependency-structure
    expression of the reference's interior-first RMA pipeline —
    checkable on one device."""
    _, fn, _ = _audit_sharded((96, 24, 32), (4,), True)
    traced = jax.jit(fn).trace(jax.ShapeDtypeStruct((96, 24, 32),
                                                    np.float32),
                               jax.ShapeDtypeStruct((), np.int32))
    body = _loop_body(traced.jaxpr.jaxpr)
    assert body is not None
    perm_ids = {id(e) for e in body.eqns if e.primitive.name == "ppermute"}
    assert len(perm_ids) == 2
    # the sweep's result: concatenate([lo_band, interior, hi_band], 0)
    cat = [e for e in body.eqns if e.primitive.name == "concatenate"
           and e.params["dimension"] == 0 and len(e.invars) == 3][-1]
    producer = {}
    for eqn in body.eqns:
        for ov in eqn.outvars:
            producer[id(ov)] = eqn

    def ancestors(var):
        acc, stack = set(), [var]
        while stack:
            p = producer.get(id(stack.pop()))
            if p is not None and id(p) not in acc:
                acc.add(id(p))
                stack.extend(p.invars)
        return acc

    lo, inner, hi = (ancestors(v) for v in cat.invars)
    assert not (inner & perm_ids), (
        "interior band depends on the exchange — overlap impossible"
    )
    assert perm_ids <= (lo | hi), (
        "boundary bands must consume every exchanged strip"
    )


# ---------------- GSPMD solver-stack audit (compiled-HLO level) -------

def _gspmd_cycle_counts(mesh_n, width=63):
    import jax

    from stencil_tpu.models.poisson import PoissonProblem
    from stencil_tpu.multigrid import Multigrid
    from stencil_tpu.parallel.comm_audit import audit_gspmd
    from stencil_tpu.parallel.halo import make_mesh

    prob = PoissonProblem((width, 15, 15))
    mg = Multigrid(prob)
    sh, _, _ = mg._level_shardings(make_mesh((mesh_n,), ("x",)), 0, 16)
    cycle = mg._make_cycle(
        lambda a, l: jax.lax.with_sharding_constraint(a, sh[l]))
    h0 = float(prob.h)

    def fn(padded, f):
        return cycle(padded, (h0 * h0) * f, f, 0)

    pad = jax.ShapeDtypeStruct(tuple(s + 2 for s in prob.shape),
                               np.float32)
    fs = jax.ShapeDtypeStruct(tuple(prob.shape), np.float32)
    return audit_gspmd(fn, pad, fs)


def test_sharded_mg_cycle_collective_profile():
    """The distributed V-cycle's compiled-HLO collective profile: halo
    exchanges are collective-permutes, the sharded->replicated coarse
    transition is a CONSTANT number of all-gathers (mesh-size
    independent), and there is NO all-reduce / all-to-all /
    reduce-scatter — a V-cycle contains no global reduction, so any
    appearing is a partitioning regression."""
    c2 = _gspmd_cycle_counts(2)
    c4 = _gspmd_cycle_counts(4)
    for c in (c2, c4):
        assert c["collective-permute"] > 0, c
        assert c["all-reduce"] == 0, c
        assert c["all-to-all"] == 0 and c["reduce-scatter"] == 0, c
    assert c2["all-gather"] == c4["all-gather"], (c2, c4)


def test_distributed_pcg_reductions_are_exactly_the_krylov_dots():
    """Distributed PCG's only all-reduces are the algorithm's 4 dot
    products per iteration (rz, p.q, r.r in the loop condition, r.z) —
    independent of mesh size; no all-to-all / reduce-scatter."""
    import jax

    from stencil_tpu.krylov import ConjugateGradient
    from stencil_tpu.models.poisson import PoissonProblem
    from stencil_tpu.multigrid import Multigrid
    from stencil_tpu.parallel.comm_audit import audit_gspmd
    from stencil_tpu.parallel.halo import make_mesh

    def counts(mesh_n):
        prob = PoissonProblem((63, 15, 15))
        cg = ConjugateGradient(prob, preconditioner=Multigrid(prob))
        fn = cg._solve_fn(1e-5, 100, make_mesh((mesh_n,), ("x",)), 0, 16)
        pad = jax.ShapeDtypeStruct(tuple(s + 2 for s in prob.shape),
                                   np.float32)
        fs = jax.ShapeDtypeStruct(tuple(prob.shape), np.float32)
        return audit_gspmd(fn, pad, fs)

    c2, c4 = counts(2), counts(4)
    assert c2["all-reduce"] == c4["all-reduce"] == 4, (c2, c4)
    assert c2["all-gather"] == c4["all-gather"], (c2, c4)
    for c in (c2, c4):
        assert c["all-to-all"] == 0 and c["reduce-scatter"] == 0, c
