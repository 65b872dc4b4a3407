"""Timing utilities.

``TinyTimer`` is the analog of the reference's pause/resume accumulating
timer (``/root/reference/include/stencil/tiny_timer.hpp:40-78``) — which is
dead code there; here it is actually used by the CLI driver.

``measure_marginal`` implements the benchmark protocol: the reference
brackets spawn→join with ``std::chrono::steady_clock`` and averages ``-R``
repeats (``main.cpp:27-43``). A per-call dispatch overhead would swamp the
wall clock of a short run, so we time *marginally*: run the jitted loop at
two iteration counts and divide the time difference by the iteration
delta. Every timed region ends in ``jax.block_until_ready`` on the result
(JAX returns before the device finishes).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import jax


class TinyTimer:
    """Accumulating start/pause/restart timer (seconds)."""

    def __init__(self):
        self._acc = 0.0
        self._t0 = None

    def start(self) -> "TinyTimer":
        if self._t0 is None:
            self._t0 = time.perf_counter()
        return self

    def pause(self) -> "TinyTimer":
        if self._t0 is not None:
            self._acc += time.perf_counter() - self._t0
            self._t0 = None
        return self

    def restart(self) -> "TinyTimer":
        self._acc = 0.0
        self._t0 = time.perf_counter()
        return self

    @property
    def seconds(self) -> float:
        extra = (time.perf_counter() - self._t0) if self._t0 is not None else 0.0
        return self._acc + extra

    def pretty(self) -> str:
        s = self.seconds
        if s < 1e-6:
            return f"{s * 1e9:.1f} ns"
        if s < 1e-3:
            return f"{s * 1e6:.1f} us"
        if s < 1.0:
            return f"{s * 1e3:.2f} ms"
        return f"{s:.3f} s"


@dataclasses.dataclass
class Measurement:
    seconds_per_iteration: float
    iterations_measured: int
    raw_seconds: tuple
    # per-repeat marginal seconds/iteration (median of these is
    # seconds_per_iteration): the noise band, so a delta between runs can
    # be judged against the within-process spread
    marginals: tuple = ()


def measure_marginal(
    run: Callable[[int], object],
    iters_lo: int = 0,
    iters_hi: int = 0,
    warmup_iters: int = 2,
    repeats: int = 2,
    granularity: int = 1,
    min_signal_seconds: float = 0.75,
) -> Measurement:
    """Marginal per-iteration time of ``run(n)``.

    ``run(n)`` must execute n iterations on device and return a jax value.
    Returns median-over-repeats of (t(hi) - t(lo)) / (hi - lo), which
    cancels the fixed per-call overhead; compilation is excluded by
    the warmup call.

    By default the iteration counts AUTORANGE (like ``timeit``): ``lo`` is
    grown until one run takes >= ``min_signal_seconds / 3`` and ``hi`` is
    ``4 * lo``, so the measured difference is >= ``min_signal_seconds``.
    A small fixed iteration delta of a fast kernel drowns in per-call
    dispatch noise and can even come out negative. Explicit
    ``iters_lo``/``iters_hi`` skip autoranging (use only when the cost per
    iteration is large and known).
    """
    import statistics

    g = max(1, granularity)
    jax.block_until_ready(run(max(warmup_iters, g)))

    def timed(n: int) -> float:
        t0 = time.perf_counter()
        jax.block_until_ready(run(n))
        return time.perf_counter() - t0

    if not iters_lo or not iters_hi:
        # Autorange on the marginal SIGNAL t(n) - t(g), not on t(n): some
        # runners carry a large fixed per-call cost (host gather/scatter,
        # dispatch), and thresholding total time would stop growing while
        # the iteration-dependent part is still noise-sized.
        t_base = timed(g)
        lo = 4 * g
        t_lo = timed(lo)
        while (t_lo - t_base) < min_signal_seconds / 3 and lo < 1_000_000:
            per_iter = max((t_lo - t_base) / max(lo - g, 1), 1e-7)
            need = (min_signal_seconds / 3) / per_iter
            grow = max(2.0, min(need / lo, 64.0))
            lo = int(-(-int(lo * grow) // g) * g)
            t_lo = timed(lo)
        iters_lo, iters_hi = lo, 4 * lo

    marginals = []
    raws = []
    for _ in range(repeats):
        t_lo = timed(iters_lo)
        t_hi = timed(iters_hi)
        raws.append((t_lo, t_hi))
        marginal = (t_hi - t_lo) / (iters_hi - iters_lo)
        # guard against residual noise: never report below the
        # overhead-inclusive bound of the big run
        marginals.append(max(marginal, 0.0) or t_hi / iters_hi)
    best = statistics.median(marginals)
    return Measurement(
        seconds_per_iteration=best,
        iterations_measured=iters_hi - iters_lo,
        raw_seconds=tuple(raws),
        marginals=tuple(marginals),
    )


def measure_wall(run: Callable[[], object], repeats: int = 3) -> Sequence[float]:
    """Plain wall-clock repeats (reference protocol, ``main.cpp:29-43``):
    returns the per-repeat seconds including dispatch overhead."""
    jax.block_until_ready(run())
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        out.append(time.perf_counter() - t0)
    return out
