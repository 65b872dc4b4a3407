"""Test configuration: force a virtual CPU mesh.

The reference only ever runs on real Sunway hardware (SURVEY §4); we do
strictly better by making the whole suite CPU-runnable — the
shard_map/ppermute halo path and the distributed solvers on virtual
devices via ``--xla_force_host_platform_device_count`` — so correctness
is testable anywhere, and GPU runs (``chip_smoke.py``) are a performance
and bring-up concern.

Environment must be set before the first ``import jax`` anywhere in the
test process, hence this lives at the top of conftest.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    # 10 devices: the largest test meshes use 8; methods that default to
    # every device (``sharded`` without --mesh) get a 10-device mesh
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=10"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# no persistent compile cache in tests (cli.main places one in the
# checkout; the test workers must not write there)
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# ---- fast/slow markers from MEASURED durations ------------------------
#
# The suite has grown past a usable inner-loop budget. Rather than
# hand-curating
# markers (they drift), tests are marked from a checked-in measurement:
# ``tests/durations.json`` maps nodeid -> seconds from a full run.
# ``-m fast`` is the inner loop; ``-m slow`` the long tail; unknown
# (new) tests default to FAST so they are never silently skipped.
#
# Refresh the data with:
#   STENCIL_RECORD_TEST_DURATIONS=1 python -m pytest tests/ -q
# (partial runs MERGE into the file, so a targeted re-run updates only
# its own entries).

import json as _json
import pathlib as _pathlib

_DURATIONS_PATH = _pathlib.Path(__file__).parent / "durations.json"
# chosen so `-m 'not slow'` stays a few minutes
SLOW_SECONDS = 3.0
_recorded: dict = {}


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        f"slow: measured >= {SLOW_SECONDS}s in tests/durations.json "
        "(full suite runs these; `-m fast` is the inner loop)")
    config.addinivalue_line(
        "markers", "fast: complement of slow; new tests default fast")


def pytest_collection_modifyitems(config, items):
    try:
        dur = _json.loads(_DURATIONS_PATH.read_text())
    except Exception:
        dur = {}
    for item in items:
        d = dur.get(item.nodeid)
        if d is not None and d >= SLOW_SECONDS:
            item.add_marker(pytest.mark.slow)
        else:
            item.add_marker(pytest.mark.fast)


def pytest_runtest_logreport(report):
    if (report.when == "call"
            and os.environ.get("STENCIL_RECORD_TEST_DURATIONS")):
        _recorded[report.nodeid] = round(report.duration, 3)


def pytest_sessionfinish(session, exitstatus):
    if not _recorded:
        return
    try:
        old = _json.loads(_DURATIONS_PATH.read_text())
    except Exception:
        old = {}
    old.update(_recorded)
    _DURATIONS_PATH.write_text(
        _json.dumps(dict(sorted(old.items())), indent=0) + "\n")
