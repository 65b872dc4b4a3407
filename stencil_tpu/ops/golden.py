"""Golden model + differential checker.

Analog of the reference's naive host verifier
(``/root/reference/src/stencil/stencil.cpp:75-151``): an independent,
deliberately-simple implementation run at float64, compared element-wise
against every optimized kernel at an absolute tolerance (reference bar:
``1e-4``, ``stencil.cpp:137``), reporting the first mismatch.

The reference's verifier is general-radius even though three of its four
kernels are radius-1-only; ours is general-spec and checks every method.

A multithreaded C++ implementation of the same sweep (``stencil_tpu/native``)
accelerates large-grid checks; this module is the always-available NumPy
fallback and the definition of correctness.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from stencil_tpu.core.grid import (
    DirichletBC, fill_halo_np, refresh_dynamic_np,
)
from stencil_tpu.core.spec import StencilSpec


def golden_sweep(padded: np.ndarray, spec: StencilSpec) -> np.ndarray:
    """One sweep at float64: returns the new *interior*.

    Accumulates taps in canonical order; uniform-weight specs do a single
    final multiply, matching the reference's sum-then-multiply ordering
    (``stencil.cpp:85-125``).
    """
    r = spec.radius
    ndim = padded.ndim
    interior_shape = tuple(s - 2 * r for s in padded.shape)
    acc = np.zeros(interior_shape, dtype=np.float64)
    uw = spec.uniform_weight
    for off, w in zip(spec.offsets, spec.weights):
        idx = tuple(
            slice(r + off[d], r + off[d] + interior_shape[d])
            for d in range(ndim)
        )
        tap = padded[idx].astype(np.float64)
        acc += tap if uw is not None else w * tap
    if uw is not None:
        acc *= uw
    return acc


def apply_spec_f64(interior, spec: StencilSpec,
                   bc: Optional[DirichletBC] = None) -> np.ndarray:
    """``A u`` in float64 with the problem's wall values in the ghost
    ring — the golden twin of a device-side OPERATOR application (one
    tap contraction, no iteration). Shared by the steady-problem
    residual certificates (``models/*.residual_f64``): pure NumPy so
    the certificate never rounds through the device dtype."""
    u = np.asarray(interior, np.float64)
    r = spec.radius
    padded = np.pad(u, r)
    if bc is not None:
        padded = fill_halo_np(padded, r, bc)
        if bc.any_dynamic:
            padded = refresh_dynamic_np(padded, r, bc)
    n = u.shape
    out = np.zeros(n, np.float64)
    for off, w in zip(spec.offsets, spec.weights):
        idx = tuple(slice(r + off[d], r + off[d] + n[d])
                    for d in range(u.ndim))
        out += float(w) * padded[idx]
    return out


def golden_iterate(
    interior0: np.ndarray,
    spec: StencilSpec,
    iterations: int,
    bc: Optional[DirichletBC] = None,
    source: Optional[np.ndarray] = None,
    source_scale: float = 1.0,
) -> np.ndarray:
    """Run ``iterations`` Jacobi sweeps at float64, returning the final
    interior. Ping-pong parity is handled functionally (the reference tracks
    it with a ``swapped`` flag, ``stencil.cpp:88-134``).

    ``source`` (interior-shaped, optional) adds ``source_scale * source``
    to every sweep — the affine update ``u' = S(u) + c*f`` behind Poisson
    relaxation and forced diffusion (``models/poisson.py``). The reference
    has no source-term capability."""
    if bc is None:
        bc = DirichletBC.reference_default(interior0.ndim)
    r = spec.radius
    padded = np.pad(np.asarray(interior0, dtype=np.float64), r)
    padded = fill_halo_np(padded, r, bc)
    idx = tuple(slice(r, s - r) for s in padded.shape)
    src = None
    if source is not None:
        src = source_scale * np.asarray(source, dtype=np.float64)
        if src.shape != padded[idx].shape:
            raise ValueError(
                f"source shape {src.shape} != interior {padded[idx].shape}")
    for _ in range(iterations):
        new = golden_sweep(padded, spec)
        padded[idx] = new if src is None else new + src
        if bc.any_dynamic:
            # dynamic ghosts (periodic wraps, Neumann mirrors) hold data
            # derived from the *current* iterate
            refresh_dynamic_np(padded, r, bc)
    return padded[idx]


def golden_iterate_fields(
    interior0: np.ndarray,
    offsets,
    fields: np.ndarray,
    iterations: int,
    bc: Optional[DirichletBC] = None,
) -> np.ndarray:
    """Float64 twin of the variable-coefficient sweep
    (``ops/xla.py:apply_fields``): ``out[p] = sum_t fields[t][p] *
    in[p + offsets[t]]``. ``fields`` stacks one interior-shaped weight
    array per offset; halo width is the max offset magnitude."""
    interior0 = np.asarray(interior0, np.float64)
    fields = np.asarray(fields, np.float64)
    ndim = interior0.ndim
    r = max(1, max(abs(o) for off in offsets for o in off))
    if bc is None:
        bc = DirichletBC.reference_default(ndim)
    padded = fill_halo_np(np.pad(interior0, r), r, bc)
    idx = tuple(slice(r, s - r) for s in padded.shape)
    shape = interior0.shape
    for _ in range(iterations):
        acc = np.zeros(shape, np.float64)
        for i, off in enumerate(offsets):
            tap_idx = tuple(
                slice(r + off[d], r + off[d] + shape[d])
                for d in range(ndim)
            )
            acc += fields[i] * padded[tap_idx]
        padded[idx] = acc
        if bc.any_dynamic:
            refresh_dynamic_np(padded, r, bc)
    return padded[idx]


@dataclasses.dataclass
class CheckResult:
    """Outcome of a differential check (analog of ``check_result``'s bool +
    printed first-mismatch diagnostic, ``stencil.cpp:137-145``)."""

    ok: bool
    max_abs_err: float
    max_rel_err: float
    first_mismatch: Optional[Tuple[Tuple[int, ...], float, float]] = None
    tolerance: float = 1e-4

    def __bool__(self):
        return self.ok

    def message(self) -> str:
        if self.ok:
            return (
                f"max abs err {self.max_abs_err:.3e}, "
                f"max rel err {self.max_rel_err:.3e}"
            )
        idx, got, want = self.first_mismatch
        return (
            f"MISMATCH at {idx}: got {got!r}, expected {want!r} "
            f"(|err| {abs(got - want):.3e} > tol {self.tolerance:g}; "
            f"max abs err {self.max_abs_err:.3e})"
        )


def check_against_golden(
    result: np.ndarray,
    golden: np.ndarray,
    tolerance: float = 1e-4,
) -> CheckResult:
    """Element-wise absolute-tolerance comparison with first-mismatch report
    (reference: abs err < 1e-4 per element, ``stencil.cpp:134-148``)."""
    result = np.asarray(result, dtype=np.float64)
    golden = np.asarray(golden, dtype=np.float64)
    if result.shape != golden.shape:
        raise ValueError(f"shape mismatch: {result.shape} vs {golden.shape}")
    err = np.abs(result - golden)
    max_abs = float(err.max()) if err.size else 0.0
    denom = np.maximum(np.abs(golden), 1e-30)
    max_rel = float((err / denom).max()) if err.size else 0.0
    bad = err >= tolerance
    if not bad.any():
        return CheckResult(
            ok=True, max_abs_err=max_abs, max_rel_err=max_rel,
            tolerance=tolerance,
        )
    first_flat = int(np.argmax(bad.reshape(-1)))
    idx = np.unravel_index(first_flat, bad.shape)
    idx = tuple(int(i) for i in idx)
    return CheckResult(
        ok=False,
        max_abs_err=max_abs,
        max_rel_err=max_rel,
        first_mismatch=(idx, float(result[idx]), float(golden[idx])),
        tolerance=tolerance,
    )
