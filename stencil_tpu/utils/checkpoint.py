"""Checkpoint / resume for long iteration runs.

The reference has NO checkpoint capability (SURVEY §5: one-shot LSF batch
jobs; its only artifact path is an unused BMP dump, ``stencil.cpp:153-188``).
Long stencil relaxations (the sweep harness goes to 1e5 iterations,
``run_expr.py:6-15``) lose everything on preemption — on shared clusters
that is the common case, so this build treats resumable state as a
first-class subsystem.

State = (grid interior, spec name, iteration counter, BC values, dtype).
Format: a single ``.npz`` with a JSON-encoded metadata entry — no extra
dependencies, portable across hosts, and safe against torn writes (incl.
host crash / power loss) via the write-to-temp + fsync + atomic-rename +
directory-fsync protocol. An optional rolling-window retention
keeps the newest N checkpoints.

``CheckpointedRun`` wraps any registry Runner with periodic saves and
resume-on-restart, turning every method (XLA, sharded, streamed) into a
preemption-safe run without the method knowing.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from stencil_tpu.core.grid import DirichletBC, HaloGrid

FORMAT_VERSION = 1


@dataclasses.dataclass
class CheckpointState:
    interior: np.ndarray
    iteration: int
    spec_name: str
    bc: DirichletBC
    halo: int

    def to_grid(self, dtype=None, host: bool = False) -> HaloGrid:
        """Rebuild the HaloGrid. ``host=True`` keeps the iterate a host
        NumPy array (the streamed method's residency — a grid exceeding
        device HBM must never be materialized on device; the resume
        path would otherwise OOM exactly on the grids long enough to
        need checkpointing)."""
        interior = (self.interior if dtype is None
                    else self.interior.astype(np.dtype(str(dtype))))
        if host:
            from stencil_tpu.core.grid import fill_halo_np

            padded = np.pad(interior, self.halo)
            padded = fill_halo_np(padded, self.halo, self.bc)
            return HaloGrid(data=padded, halo=self.halo, bc=self.bc)
        import jax.numpy as jnp

        return HaloGrid.from_interior(jnp.asarray(interior),
                                      halo=self.halo, bc=self.bc)


def save(path: str | Path, grid: HaloGrid, iteration: int,
         spec_name: str = "") -> Path:
    """Atomically and durably write a checkpoint (temp file + fsync +
    rename + directory fsync)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    meta = {
        "version": FORMAT_VERSION,
        "iteration": int(iteration),
        "spec_name": spec_name,
        "halo": int(grid.halo),
        "bc": [list(v) for v in grid.bc.values],
        "bc_periodic": [bool(p) for p in grid.bc.periodic],
        "bc_neumann": [bool(p) for p in grid.bc.neumann],
        "dtype": str(grid.dtype),
    }
    interior = np.asarray(grid.interior())
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, interior=interior,
                     meta=np.frombuffer(
                         json.dumps(meta).encode(), dtype=np.uint8
                     ))
            # durability, not just atomicity: without the fsync the rename
            # can land with empty/partial contents after a host crash
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        dirfd = os.open(path.parent, os.O_RDONLY)
        try:
            os.fsync(dirfd)  # persist the rename itself
        finally:
            os.close(dirfd)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def load(path: str | Path) -> CheckpointState:
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta.get("version") != FORMAT_VERSION:
            raise ValueError(
                f"unsupported checkpoint version {meta.get('version')}"
            )
        return CheckpointState(
            interior=z["interior"],
            iteration=meta["iteration"],
            spec_name=meta["spec_name"],
            bc=DirichletBC(
                values=tuple(tuple(v) for v in meta["bc"]),
                # absent in older checkpoints -> all-Dirichlet;
                # normalized to () so it compares equal to default BCs
                periodic=tuple(
                    bool(p) for p in meta.get("bc_periodic", ())
                ) if any(meta.get("bc_periodic", ())) else (),
                neumann=tuple(
                    bool(p) for p in meta.get("bc_neumann", ())
                ) if any(meta.get("bc_neumann", ())) else (),
            ),
            halo=meta["halo"],
        )


def latest(directory: str | Path) -> Optional[Path]:
    """Newest checkpoint in a directory (by step number in the name)."""
    directory = Path(directory)
    if not directory.is_dir():
        return None
    cands = sorted(directory.glob("step_*.npz"))
    return cands[-1] if cands else None


def _step_path(directory: Path, step: int) -> Path:
    return directory / f"step_{step:010d}.npz"


@dataclasses.dataclass
class CheckpointedRun:
    """Wrap a Runner with periodic checkpointing + resume.

    ``run(grid, iterations)`` resumes from the newest checkpoint in
    ``directory`` (if any), then alternates compute and saves every
    ``every`` iterations, retaining the newest ``keep`` files.
    """

    runner: object                 # registry.Runner
    directory: str | Path
    every: int = 100
    keep: int = 2
    spec_name: str = ""

    def run(self, grid: HaloGrid, iterations: int,
            progress=None) -> Tuple[HaloGrid, int]:
        directory = Path(self.directory)
        start = 0
        ckpt = latest(directory)
        if ckpt is not None:
            state = load(ckpt)
            if state.interior.shape != grid.interior_shape:
                raise ValueError(
                    f"checkpoint shape {state.interior.shape} does not "
                    f"match grid {grid.interior_shape}"
                )
            if (self.spec_name and state.spec_name
                    and state.spec_name != self.spec_name):
                raise ValueError(
                    f"checkpoint at {ckpt} is from stencil "
                    f"{state.spec_name!r}, not {self.spec_name!r}; refusing "
                    "to resume a different problem (use a fresh directory)"
                )
            if state.bc != grid.bc:
                raise ValueError(
                    f"checkpoint at {ckpt} has boundary conditions "
                    f"{state.bc.values} (periodic={state.bc.periodic}, "
                    f"neumann={state.bc.neumann}), "
                    f"grid has {grid.bc.values} "
                    f"(periodic={grid.bc.periodic}, "
                    f"neumann={grid.bc.neumann}); "
                    "refusing to resume (use a fresh directory)"
                )
            # preserve the incoming grid's residency: a host NumPy
            # iterate (the streamed out-of-core method) must resume
            # host-side — it may not fit device HBM at all
            grid = state.to_grid(dtype=grid.dtype,
                                 host=isinstance(grid.data, np.ndarray))
            start = state.iteration
            if progress:
                progress(f"resumed from {ckpt} at iteration {start}")
        done = start
        while done < iterations:
            chunk = min(self.every, iterations - done)
            grid = self.runner.iterate(grid, chunk)
            done += chunk
            save(_step_path(directory, done), grid, done, self.spec_name)
            if progress:
                progress(f"checkpoint at iteration {done}")
            existing = sorted(directory.glob("step_*.npz"))
            for old in existing[:-self.keep]:
                old.unlink(missing_ok=True)
        return grid, done
