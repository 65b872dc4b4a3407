"""Checkpoint/resume subsystem tests (SURVEY §5: reference has none; this
framework adds preemption-safe runs as a first-class aux subsystem)."""

import numpy as np
import pytest

from stencil_tpu.config import RunConfig
from stencil_tpu.core.grid import DirichletBC, HaloGrid
from stencil_tpu.core.spec import get_spec
from stencil_tpu.ops import golden
from stencil_tpu import registry
from stencil_tpu.utils import checkpoint


@pytest.fixture
def setup():
    spec = get_spec("jacobi5")
    grid = HaloGrid.create((32, 24), halo=1, dtype="float32")
    runner = registry.get_runner("xla", None, spec, grid)
    return spec, grid, runner


def test_save_load_roundtrip(tmp_path, setup):
    spec, grid, runner = setup
    out = runner.iterate(grid, 5)
    p = checkpoint.save(tmp_path / "step_0000000005.npz", out, 5, "jacobi5")
    state = checkpoint.load(p)
    assert state.iteration == 5
    assert state.spec_name == "jacobi5"
    assert state.bc == grid.bc
    np.testing.assert_array_equal(
        state.interior, np.asarray(out.interior())
    )
    g2 = state.to_grid()
    np.testing.assert_allclose(
        np.asarray(g2.interior()), np.asarray(out.interior())
    )


def test_latest_picks_newest(tmp_path, setup):
    spec, grid, runner = setup
    for step in (3, 12, 7):
        checkpoint.save(tmp_path / f"step_{step:010d}.npz", grid, step)
    assert checkpoint.latest(tmp_path).name == "step_0000000012.npz"
    assert checkpoint.latest(tmp_path / "nope") is None


def test_checkpointed_run_matches_uninterrupted(tmp_path, setup):
    spec, grid, runner = setup
    ref = runner.iterate(grid, 20)
    run = checkpoint.CheckpointedRun(runner, tmp_path, every=6,
                                     spec_name="jacobi5")
    out, done = run.run(grid, 20)
    assert done == 20
    np.testing.assert_allclose(
        np.asarray(out.interior()), np.asarray(ref.interior()),
        atol=1e-6,
    )
    # retention: only the newest `keep` files survive
    files = sorted(p.name for p in tmp_path.glob("step_*.npz"))
    assert len(files) == 2


def test_resume_after_interrupt(tmp_path, setup):
    """Kill after 12/20 iterations; a fresh run must resume, not restart."""
    spec, grid, runner = setup
    ref = runner.iterate(grid, 20)
    run = checkpoint.CheckpointedRun(runner, tmp_path, every=6,
                                     spec_name="jacobi5")
    run.run(grid, 12)  # "preempted" here
    msgs = []
    out, done = checkpoint.CheckpointedRun(
        runner, tmp_path, every=6, spec_name="jacobi5"
    ).run(grid, 20, progress=msgs.append)
    assert done == 20
    assert any("resumed" in m and "iteration 12" in m for m in msgs)
    np.testing.assert_allclose(
        np.asarray(out.interior()), np.asarray(ref.interior()),
        atol=1e-6,
    )


def test_shape_mismatch_rejected(tmp_path, setup):
    spec, grid, runner = setup
    checkpoint.save(tmp_path / "step_0000000001.npz", grid, 1)
    other = HaloGrid.create((16, 24), halo=1)
    with pytest.raises(ValueError, match="does not match"):
        checkpoint.CheckpointedRun(runner, tmp_path).run(other, 5)


def test_torn_write_leaves_no_partial(tmp_path, setup, monkeypatch):
    """A crash mid-save must not leave a corrupt step_*.npz behind."""
    spec, grid, runner = setup

    def boom(*a, **k):
        raise KeyboardInterrupt

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(KeyboardInterrupt):
        checkpoint.save(tmp_path / "step_0000000001.npz", grid, 1)
    assert list(tmp_path.glob("step_*.npz")) == []
    assert list(tmp_path.glob("*.tmp")) == []


def test_spec_mismatch_rejected(tmp_path, setup):
    spec, grid, runner = setup
    checkpoint.save(tmp_path / "step_0000000005.npz", grid, 5, "jacobi5")
    with pytest.raises(ValueError, match="refusing to resume a different"):
        checkpoint.CheckpointedRun(
            runner, tmp_path, spec_name="jacobi9"
        ).run(grid, 10)


def test_bc_mismatch_rejected(tmp_path, setup):
    spec, grid, runner = setup
    checkpoint.save(tmp_path / "step_0000000005.npz", grid, 5, "jacobi5")
    other = HaloGrid.create((32, 24), halo=1, bc=DirichletBC.zero(2))
    with pytest.raises(ValueError, match="boundary conditions"):
        checkpoint.CheckpointedRun(
            runner, tmp_path, spec_name="jacobi5"
        ).run(other, 10)


def test_resume_stays_host_resident_for_streamed(tmp_path, monkeypatch):
    """The streamed (out-of-core) method's iterate lives in host RAM; a
    grid needing streaming may exceed device HBM, so resume must rebuild
    it HOST-side (``to_grid(host=True)``) — the device path would OOM on
    exactly the runs long enough to need checkpointing."""
    from stencil_tpu.streaming import host_halo_grid

    spec = get_spec("jacobi7")
    shape = (18, 16, 20)
    cfg = RunConfig(size=shape, spec="jacobi7", methods=("streamed",),
                    chunks=3, temporal=2)
    grid = host_halo_grid(shape, halo=spec.radius)
    runner = registry.get_runner("streamed", cfg, spec, grid)
    ref = runner.iterate(grid, 12)

    host_flags = []
    orig = checkpoint.CheckpointState.to_grid

    def spy(self, dtype=None, host=False):
        host_flags.append(host)
        return orig(self, dtype=dtype, host=host)

    monkeypatch.setattr(checkpoint.CheckpointState, "to_grid", spy)
    d = tmp_path / "streamed"
    checkpoint.CheckpointedRun(runner, d, every=4,
                               spec_name="jacobi7").run(grid, 8)
    out, done = checkpoint.CheckpointedRun(
        runner, d, every=4, spec_name="jacobi7"
    ).run(grid, 12)
    assert done == 12
    assert host_flags == [True]        # the resume rebuilt host-side
    assert isinstance(out.data, np.ndarray)
    np.testing.assert_allclose(
        np.asarray(out.interior()), np.asarray(ref.interior()), atol=1e-6)
    # and the host rebuild carries the same halo content the streamed
    # entry point (host_halo_grid) would give a fresh grid
    state = checkpoint.load(checkpoint.latest(d))
    g = state.to_grid(host=True)
    fresh = host_halo_grid(shape, halo=spec.radius,
                           interior=state.interior)
    np.testing.assert_array_equal(g.data, fresh.data)


@pytest.mark.parametrize("method,cfg_kwargs", [
    ("streamed", {"temporal": 2, "chunks": 2}),
    ("sharded", {"mesh": (2,)}),
    ("sharded", {"mesh": (2, 2)}),
    ("sharded_noverlap", {"mesh": (2, 2)}),
])
def test_checkpoint_resume_across_methods(tmp_path, method, cfg_kwargs):
    """Resume must work with every method family, not just the xla
    baseline — streamed keeps the iterate on the host and the sharded
    paths a device mesh, none of which may leak into the checkpoint
    state."""
    spec = get_spec("jacobi7")
    grid = HaloGrid.create((16, 16, 24), halo=1, dtype="float32")
    cfg = RunConfig(size=(16, 16, 24), spec="jacobi7",
                    methods=(method,), **cfg_kwargs)
    runner = registry.get_runner(method, cfg, spec, grid)
    ref = runner.iterate(grid, 12)
    d = tmp_path / method
    checkpoint.CheckpointedRun(runner, d, every=4,
                               spec_name="jacobi7").run(grid, 8)
    out, done = checkpoint.CheckpointedRun(
        runner, d, every=4, spec_name="jacobi7"
    ).run(grid, 12)
    assert done == 12
    np.testing.assert_allclose(
        np.asarray(out.interior()), np.asarray(ref.interior()), atol=1e-6,
    )
