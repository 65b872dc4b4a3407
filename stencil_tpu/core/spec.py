"""Stencil specification: the set of (offset, weight) taps applied per sweep.

This generalizes the reference's hardcoded cross-shaped (von Neumann) average
(``/root/reference/src/stencil/stencil.cpp:85-125`` — sum of the four arms of
radius r, center excluded, multiplied by ``1 / (2 * (bw + bh))``) into a typed,
hashable spec covering 2D/3D star and box stencils of arbitrary radius.

The spec is a *static* (trace-time) object: kernels specialize on it the way
the reference's ``stencil_dma_static_unroll.cpp`` specializes on its
``<BoundaryWidth, BoundaryHeight>`` template parameters — except JAX tracing
gives us that specialization for free.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

Offset = Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    """A linear stencil: ``out[p] = sum_k weights[k] * in[p + offsets[k]]``.

    Attributes:
      ndim:    spatial rank (2 or 3 supported by the shipped kernels).
      radius:  max Chebyshev distance of any tap from the center. This is the
               halo width required per sweep (analog of the reference's
               ``boundary_width``/``boundary_height``).
      offsets: tap offsets, canonically ordered (see ``canonical_order``).
      weights: one weight per tap.
      name:    human-readable identifier used by configs / the CLI.
    """

    ndim: int
    radius: int
    offsets: Tuple[Offset, ...]
    weights: Tuple[float, ...]
    name: str = "custom"

    def __post_init__(self):
        if len(self.offsets) != len(self.weights):
            raise ValueError("offsets and weights must have the same length")
        if len(self.offsets) == 0:
            raise ValueError("a stencil needs at least one tap")
        for off in self.offsets:
            if len(off) != self.ndim:
                raise ValueError(f"offset {off} is not rank {self.ndim}")
            if max(abs(o) for o in off) > self.radius:
                raise ValueError(f"offset {off} exceeds radius {self.radius}")
        if self.radius < 1:
            raise ValueError("radius must be >= 1")

    # ---- derived properties -------------------------------------------------

    @property
    def num_taps(self) -> int:
        return len(self.offsets)

    @property
    def uniform_weight(self) -> Optional[float]:
        """If all taps share one weight, return it; else None.

        Uniform-weight stencils are computed as ``(sum of taps) * w`` — a
        single multiply after the accumulation — to match the reference's
        arithmetic exactly (``stencil_dma.cpp:632-633``,
        ``stencil.cpp:85-125``: arms summed, one final multiply).
        """
        w0 = self.weights[0]
        return w0 if all(w == w0 for w in self.weights) else None

    @property
    def flops_per_point(self) -> int:
        """FLOPs per output point per sweep (adds + multiplies)."""
        if self.uniform_weight is not None:
            return self.num_taps - 1 + 1  # (taps-1) adds + 1 multiply
        return self.num_taps + (self.num_taps - 1)  # muls + adds

    def halo_for_steps(self, steps: int) -> int:
        """Halo depth needed to advance ``steps`` sweeps without refresh
        (temporal blocking)."""
        return self.radius * steps

    def symmetric_in(self, d: int) -> bool:
        """True if the tap set is mirror-symmetric in dim ``d``: for
        every tap, the offset with component ``d`` negated exists with
        the same weight.

        A mirror-symmetric stencil preserves reflection symmetry of the
        field, which is what makes Neumann (zero-flux) faces compatible
        with temporal blocking: evolving the mirror-extended field keeps
        it mirror-extended, so ``k*r``-deep mirrored ghosts stay exact
        for ``k`` sweeps per chunk round trip (the streamed method's
        deep-halo argument). All named specs (star/box
        Jacobi, high-order Laplacian) are symmetric in every dim."""
        wmap = {}
        for off, w in zip(self.offsets, self.weights):
            wmap[off] = wmap.get(off, 0.0) + w
        for off, w in wmap.items():
            m = tuple(-c if i == d else c for i, c in enumerate(off))
            if wmap.get(m) != w:
                return False
        return True

    def weight_groups(self) -> Tuple[Tuple[float, Tuple[Offset, ...]], ...]:
        """Taps grouped by weight value, preserving first-seen order.

        Evaluators accumulate each group's taps first and multiply once
        per group: a stencil with many taps but few distinct weights (the
        4th-order Laplacian has 12 taps, 2 weights) pays per-group
        multiplies instead of per-tap ones.
        """
        groups: dict = {}
        order = []
        for off, w in zip(self.offsets, self.weights):
            if w not in groups:
                groups[w] = []
                order.append(w)
            groups[w].append(off)
        return tuple((w, tuple(groups[w])) for w in order)

    @property
    def uniform_box_minus_center(self) -> Optional[float]:
        """If this spec is a full (2r+1)^ndim box with one uniform weight
        and the center excluded, return that weight; else None.

        Such stencils evaluate SEPARABLY: ``w * (prod_d S_d(x) - x)``
        where ``S_d`` is the (2r+1)-tap sum along dim d — ndim*(2r+1)
        shifted adds instead of (2r+1)^ndim - 1 taps (10 ops vs 26 for
        the 27-point box). Kernels use this to pick the cheap evaluator.
        """
        uw = self.uniform_weight
        if uw is None:
            return None
        side = 2 * self.radius + 1
        if self.num_taps != side ** self.ndim - 1:
            return None
        if (0,) * self.ndim in self.offsets:
            return None
        # full box: every offset within Chebyshev radius present
        if len(set(self.offsets)) != self.num_taps:
            return None
        return uw

    def __hash__(self):
        return hash((self.ndim, self.radius, self.offsets, self.weights))


def canonical_order(offsets: Sequence[Offset]) -> Tuple[Offset, ...]:
    """Deterministic tap order: by dimension-major arm, negative arm first,
    near-to-far, matching the reference's left/right/up/down arm accumulation
    order (``stencil.cpp:96-123``)."""

    def key(off: Offset):
        nz = [i for i, o in enumerate(off) if o != 0]
        if len(nz) == 0:
            return (-1, 0, 0, off)  # center first
        if len(nz) == 1:
            d = nz[0]
            o = off[d]
            return (d, 0 if o < 0 else 1, abs(o), off)
        return (len(offsets) + 10, 0, 0, off)  # diagonal taps after axial ones

    return tuple(sorted(offsets, key=key))


# ---- factories ---------------------------------------------------------------


def star(ndim: int, radius: int = 1, name: Optional[str] = None) -> StencilSpec:
    """Cross/von-Neumann average of ``2 * ndim * radius`` neighbors, center
    excluded, uniform weight ``1 / (2 * ndim * radius)``.

    For ndim=2 this is exactly the reference's update
    (``stencil.cpp:85-125``): weight ``1 / (2*(bw+bh))`` with bw=bh=radius.
    """
    offsets = []
    for d in range(ndim):
        for dist in range(1, radius + 1):
            for sign in (-1, 1):
                off = [0] * ndim
                off[d] = sign * dist
                offsets.append(tuple(off))
    offsets = canonical_order(offsets)
    w = 1.0 / (2 * ndim * radius)
    return StencilSpec(
        ndim=ndim,
        radius=radius,
        offsets=offsets,
        weights=tuple([w] * len(offsets)),
        name=name or f"star{ndim}d_r{radius}",
    )


def box(ndim: int, radius: int = 1, include_center: bool = False,
        name: Optional[str] = None) -> StencilSpec:
    """Box/Moore average over the full ``(2r+1)^ndim`` neighborhood.

    Center excluded by default (Jacobi-style relaxation); uniform weights.
    """
    offsets = []
    ranges = range(-radius, radius + 1)

    def rec(prefix):
        if len(prefix) == ndim:
            off = tuple(prefix)
            if not include_center and all(o == 0 for o in off):
                return
            offsets.append(off)
            return
        for o in ranges:
            rec(prefix + [o])

    rec([])
    offsets = canonical_order(offsets)
    w = 1.0 / len(offsets)
    return StencilSpec(
        ndim=ndim,
        radius=radius,
        offsets=offsets,
        weights=tuple([w] * len(offsets)),
        name=name or f"box{ndim}d_r{radius}",
    )


def weighted(ndim: int, taps: Sequence[Tuple[Offset, float]],
             name: str = "custom") -> StencilSpec:
    """Arbitrary linear stencil from explicit (offset, weight) taps."""
    offsets = tuple(off for off, _ in taps)
    weights = tuple(float(w) for _, w in taps)
    radius = max(max(abs(o) for o in off) for off in offsets)
    radius = max(radius, 1)
    return StencilSpec(ndim=ndim, radius=radius, offsets=offsets,
                       weights=weights, name=name)


def laplacian_high_order(ndim: int, name: Optional[str] = None) -> StencilSpec:
    """4th-order accurate Laplacian (radius-2 star), Jacobi-normalized.

    Per-dimension second derivative weights (-1/12, 16/12, -30/12, 16/12,
    -1/12); assembled as a relaxation update ``x + lap/|diag|`` is left to the
    caller — here we expose the raw high-order star used by BASELINE config 4.
    Normalized so weights sum to 1 (convex-like average for stability of the
    iterate loop, center included with its residual weight).
    """
    taps = []
    c1, c2 = 16.0 / 12.0, -1.0 / 12.0
    diag = ndim * 30.0 / 12.0
    for d in range(ndim):
        for dist, c in ((1, c1), (2, c2)):
            for sign in (-1, 1):
                off = [0] * ndim
                off[d] = sign * dist
                taps.append((tuple(off), c / diag))
    offsets = canonical_order(tuple(off for off, _ in taps))
    wmap = {off: w for off, w in taps}
    return StencilSpec(
        ndim=ndim,
        radius=2,
        offsets=offsets,
        weights=tuple(wmap[o] for o in offsets),
        name=name or f"laplace{ndim}d_ho",
    )


# ---- named specs (BASELINE.json configs 1-4) ---------------------------------

def jacobi5() -> StencilSpec:
    """2D 5-point Jacobi (reference semantics, radius 1)."""
    return star(2, 1, name="jacobi5")


def jacobi9() -> StencilSpec:
    """2D 9-point box stencil."""
    return box(2, 1, name="jacobi9")


def jacobi7_3d() -> StencilSpec:
    """3D 7-point Jacobi — the north-star benchmark stencil."""
    return star(3, 1, name="jacobi7")


def jacobi27_3d() -> StencilSpec:
    """3D 27-point box stencil."""
    return box(3, 1, name="jacobi27")


NAMED_SPECS = {
    "jacobi5": jacobi5,
    "jacobi9": jacobi9,
    "jacobi7": jacobi7_3d,
    "jacobi27": jacobi27_3d,
    "star2d_r2": lambda: star(2, 2),
    "star3d_r2": lambda: star(3, 2),
    "laplace3d_ho": lambda: laplacian_high_order(3),
    "laplace2d_ho": lambda: laplacian_high_order(2),
}


def get_spec(name: str) -> StencilSpec:
    try:
        return NAMED_SPECS[name]()
    except KeyError:
        raise KeyError(
            f"unknown stencil spec {name!r}; available: {sorted(NAMED_SPECS)}"
        ) from None
