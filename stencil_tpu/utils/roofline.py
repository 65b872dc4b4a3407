"""Roofline accounting: GLUPS, bytes/point, and fraction of the measured
copy bandwidth.

The reference reports only wall-clock ms (``main.cpp:33-43``); the north
star is stated as a fraction of the memory-bandwidth roofline
(BASELINE.json), so the driver derives:

  GLUPS      = grid points * sweeps / seconds / 1e9
  roofline   = measured_copy_BW / ideal_bytes_per_point_per_sweep
  fraction   = GLUPS / roofline

``ideal_bytes_per_point`` is the compulsory traffic of a non-temporally-
blocked sweep: one read + one write per point.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import numpy as np


def ideal_bytes_per_point(dtype: str = "float32") -> int:
    return 2 * np.dtype(dtype).itemsize


_measured_bw_cache: dict = {}


def copy_probe_size(platform: str):
    """(bytes, loop count) of the bandwidth probe for ``platform``.

    On a GPU the probe must stream device memory, not the last-level
    cache: 1 GiB is 20x the H100's 50 MB L2. The CPU keeps a small probe
    (its number describes the host, never a device). Any other platform
    has no sizing here and raises."""
    if platform == "gpu":
        return 1 << 30, 100
    if platform == "cpu":
        return 32 << 20, 8
    raise ValueError(
        f"no copy-probe size for platform {platform!r} (gpu or cpu)")


@functools.lru_cache(maxsize=1)
def _copy_fn():
    import jax

    # one jitted callable: jax.jit caches per function object
    @functools.partial(jax.jit, static_argnames=("iters",))
    def run(x, iters):
        return jax.lax.fori_loop(
            0, iters, lambda _, c: c * 1.000001 + 1e-7, x
        )

    return run


def measure_copy_bandwidth(platform: Optional[str] = None) -> Optional[float]:
    """Measured read+write bandwidth (GB/s) of a fused ``x*a+b`` stream
    under one jit, marginal over two loop counts and sized for the
    device (:func:`copy_probe_size`). None when scheduler noise makes the
    marginal non-positive twice (tiny CPU probes)."""
    import jax
    import jax.numpy as jnp

    if platform is None:
        platform = jax.devices()[0].platform
    nbytes, loops = copy_probe_size(platform)
    if platform in _measured_bw_cache:
        return _measured_bw_cache[platform]
    side = int(np.sqrt(nbytes // 4))
    x = jnp.ones((side, side), jnp.float32)
    run = _copy_fn()

    def timed(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(run(x, iters))
        return time.perf_counter() - t0

    timed(2)
    lo, hi = loops, 3 * loops
    timed(lo)
    timed(hi)  # compile both loop counts outside the timed pair
    bw = None
    for _ in range(2):
        dt = (timed(hi) - timed(lo)) / (hi - lo)
        if dt > 0:
            bw = x.size * 4 * 2 / dt / 1e9
            break
    _measured_bw_cache[platform] = bw
    return bw


@dataclasses.dataclass
class PerfReport:
    seconds_per_sweep: float
    glups: float
    effective_gbps: float       # ideal traffic moved per second
    copy_gbps: Optional[float]   # measured copy bandwidth
    roofline_glups: Optional[float]
    roofline_fraction: Optional[float]

    def summary(self) -> str:
        s = (f"{self.seconds_per_sweep * 1e3:.3f} ms/sweep, "
             f"{self.glups:.2f} GLUPS")
        if self.roofline_fraction is not None:
            s += (f", {100 * self.roofline_fraction:.0f}% of copy roofline "
                  f"({self.roofline_glups:.1f} GLUPS @ "
                  f"{self.copy_gbps:.0f} GB/s copy)")
        return s


def report(
    points: int,
    sweeps: int,
    seconds: float,
    dtype: str = "float32",
    copy_gbps: Optional[float] = None,
) -> PerfReport:
    sec_per_sweep = seconds / max(sweeps, 1)
    glups = points * sweeps / seconds / 1e9
    bpp = ideal_bytes_per_point(dtype)
    eff = glups * bpp
    roof = copy_gbps / bpp if copy_gbps else None
    return PerfReport(
        seconds_per_sweep=sec_per_sweep,
        glups=glups,
        effective_gbps=eff,
        copy_gbps=copy_gbps,
        roofline_glups=roof,
        roofline_fraction=(glups / roof) if roof else None,
    )
