"""The device this process runs on, decided in one place.

Every entry point asks this module which device it has, how much memory
that device offers, and where JAX's persistent compile cache lives:

- :func:`device_info` names the device as JAX reports it (platform,
  ``device_kind``, device count) and, on a GPU, the card's name and power
  limit as ``nvidia-smi`` prints them (read in a child process that never
  imports JAX, so it cannot claim the card);
- :func:`require_gpu` is the gate of the measurement entry points
  (``bench.py``, ``chip_smoke.py``): no GPU is an error, never a switch
  to the CPU;
- :func:`require_device` is the CLI's gate: the CPU is accepted only when
  it was asked for (``--platform cpu`` or ``JAX_PLATFORMS=cpu``);
- :func:`device_memory_bytes` is the device's memory limit as the runtime
  reports it (``memory_stats()["bytes_limit"]``);
- :func:`setup_compile_cache` places the compile cache.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path
from typing import Optional

MIB = 1 << 20

# one fixed path in the checkout (listed in .gitignore): the cache key
# includes the directory, so a path that moved between runs never hits
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"

# test hook: simulate a device with this many MiB of memory
MEMORY_ENV = "STENCIL_TPU_HBM_MB"

NVIDIA_SMI_QUERY = ("nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader")


class NoAcceleratorError(RuntimeError):
    """The device an entry point needs is not there."""


def nvidia_smi() -> str:
    """``name, power.limit`` of every card, one per line as
    ``nvidia-smi`` prints them, joined by ``"; "``."""
    try:
        out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True,
                             text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())


def device_info() -> dict:
    """``{"platform", "kind", "count"}`` of JAX's default backend, plus
    ``"card"`` (``nvidia-smi``'s name and power limit) on a GPU."""
    import jax

    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    if info["platform"] == "gpu":
        info["card"] = nvidia_smi()
    return info


def describe(info: dict) -> str:
    """One-line device label printed beside every number."""
    s = f"{info['platform']}:{info['kind']} x{info['count']}"
    if "card" in info:
        s += f" [{info['card']}]"
    return s


def require_gpu() -> dict:
    """:func:`device_info` if JAX's default backend is a GPU; raises
    :class:`NoAcceleratorError` otherwise."""
    info = device_info()
    if info["platform"] != "gpu":
        raise NoAcceleratorError(
            f"no GPU found (JAX's default device is {describe(info)}); "
            "this entry point measures the GPU and does not fall back")
    return info


def cpu_requested(platform_flag: str = "") -> bool:
    """True when the CPU was asked for explicitly."""
    if platform_flag:
        return platform_flag == "cpu"
    env = os.environ.get("JAX_PLATFORMS", "")
    return "cpu" in [p.strip() for p in env.split(",")]


def require_device(platform_flag: str = "") -> dict:
    """:func:`device_info`, refusing a CPU that JAX fell back to without
    being asked (``--platform cpu`` / ``JAX_PLATFORMS=cpu`` ask)."""
    info = device_info()
    if info["platform"] == "cpu" and not cpu_requested(platform_flag):
        raise NoAcceleratorError(
            "no accelerator found; pass --platform cpu (or set "
            "JAX_PLATFORMS=cpu) to run on the CPU")
    return info


def device_memory_bytes() -> Optional[int]:
    """Memory limit of the default device in bytes: the runtime's
    ``memory_stats()["bytes_limit"]`` (``STENCIL_TPU_HBM_MB`` first).
    None when the device reports no limit (the CPU backend)."""
    env = os.environ.get(MEMORY_ENV)
    if env:
        return int(env) * MIB
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    limit = int(stats.get("bytes_limit", 0))
    return limit or None


def setup_compile_cache() -> str:
    """Place JAX's persistent compile cache; returns its directory.

    A set ``JAX_COMPILATION_CACHE_DIR`` is JAX's own setting and is left
    alone; otherwise the cache goes to :data:`DEFAULT_CACHE_DIR`."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
