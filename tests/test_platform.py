"""The one module that decides the device (``stencil_tpu.platform``), and
what rests on it: the measurement entry points refuse a machine without a
GPU, the CLI refuses a CPU it was not asked for, the copy probe is sized
per platform, the compile cache is placed from outside or at one fixed
path, and GMRES's contractions ask for full float32 precision."""

import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stencil_tpu import platform
from stencil_tpu.utils import roofline


def test_device_info_names_the_device():
    info = platform.device_info()
    assert info["platform"] == "cpu"
    assert info["count"] == len(jax.devices())
    assert info["kind"] == jax.devices()[0].device_kind
    assert "card" not in info  # nvidia-smi is read on a GPU only
    assert platform.describe(info).startswith("cpu:")


def test_describe_carries_the_card():
    info = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
            "card": "NVIDIA H100 80GB HBM3, 700.00 W"}
    assert platform.describe(info) == (
        "gpu:NVIDIA H100 80GB HBM3 x1 [NVIDIA H100 80GB HBM3, 700.00 W]")


def test_nvidia_smi_joins_every_card(monkeypatch):
    def fake_run(cmd, **kw):
        assert tuple(cmd) == platform.NVIDIA_SMI_QUERY
        return subprocess.CompletedProcess(
            cmd, 0, stdout="H100, 700.00 W\nH100, 500.00 W\n", stderr="")

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert platform.nvidia_smi() == "H100, 700.00 W; H100, 500.00 W"


def test_nvidia_smi_missing_is_reported(monkeypatch):
    def fake_run(cmd, **kw):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert platform.nvidia_smi().startswith("nvidia-smi unavailable")


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(platform.NoAcceleratorError, match="no GPU"):
        platform.require_gpu()


@pytest.mark.parametrize("flag,env,ok", [
    ("", "cpu", True),
    ("cpu", None, True),
    ("", None, False),
    ("", "cuda", False),
])
def test_require_device_needs_an_explicit_cpu(monkeypatch, flag, env, ok):
    if env is None:
        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    else:
        monkeypatch.setenv("JAX_PLATFORMS", env)
    if ok:
        assert platform.require_device(flag)["platform"] == "cpu"
    else:
        with pytest.raises(platform.NoAcceleratorError,
                           match="--platform cpu"):
            platform.require_device(flag)


def test_cli_refuses_an_implicit_cpu(monkeypatch, capsys):
    from stencil_tpu import cli

    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    assert cli.main(["-s", "8", "8", "-i", "1"]) == 2
    assert "no accelerator" in capsys.readouterr().err


def test_bench_refuses_without_gpu(capsys):
    import bench

    assert bench.main() == 2
    out = capsys.readouterr()
    assert "no GPU" in out.err and out.out == ""


@pytest.mark.parametrize("name", ["rocm", "metal", "neuron"])
def test_copy_probe_refuses_unknown_platforms(name):
    with pytest.raises(ValueError, match="no copy-probe size"):
        roofline.copy_probe_size(name)


def test_copy_probe_sizes():
    nbytes, loops = roofline.copy_probe_size("gpu")
    assert nbytes >= 4 * 50 * 10**6  # >= 4x the H100's 50 MB L2
    assert loops > 0
    cpu_bytes, _ = roofline.copy_probe_size("cpu")
    assert cpu_bytes < nbytes


def test_copy_bandwidth_on_cpu_is_a_host_number():
    bw = roofline.measure_copy_bandwidth()
    assert bw is None or bw > 0
    rep = roofline.report(10**6, 1, 1e-3, "float32", bw)
    assert rep.copy_gbps == bw
    if bw:
        assert "copy" in rep.summary()


def test_compile_cache_env_is_left_to_jax(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert platform.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_one_fixed_checkout_path(monkeypatch):
    from pathlib import Path

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        first = platform.setup_compile_cache()
        second = platform.setup_compile_cache()
        assert first == second == str(platform.DEFAULT_CACHE_DIR)
        assert jax.config.jax_compilation_cache_dir == first
        repo = Path(__file__).resolve().parent.parent
        assert Path(first) == repo / ".jax_cache"
        assert ".jax_cache/" in (repo / ".gitignore").read_text()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_device_memory_limit(monkeypatch):
    monkeypatch.delenv("STENCIL_TPU_HBM_MB", raising=False)
    assert platform.device_memory_bytes() is None  # the CPU reports none
    monkeypatch.setenv("STENCIL_TPU_HBM_MB", "3")
    assert platform.device_memory_bytes() == 3 << 20


def test_streaming_refuses_an_unknown_memory_limit(monkeypatch):
    from stencil_tpu.core.spec import get_spec
    from stencil_tpu.streaming import StreamedStencil

    monkeypatch.delenv("STENCIL_TPU_HBM_MB", raising=False)
    with pytest.raises(ValueError, match="no memory limit"):
        StreamedStencil(get_spec("jacobi7"), (16, 16, 16))
    # an explicit chunk count needs no limit
    assert StreamedStencil(get_spec("jacobi7"), (16, 16, 16),
                           chunks=2).num_chunks == 2


def test_gmres_basis_gate_skips_an_unknown_limit(monkeypatch):
    from stencil_tpu.krylov import GMRES
    from stencil_tpu.models.poisson import PoissonProblem

    monkeypatch.delenv("STENCIL_TPU_HBM_MB", raising=False)
    prob = PoissonProblem(shape=(15, 15, 15))
    GMRES(prob, restart=16)._check_basis_budget(
        jnp.zeros((15, 15, 15), jnp.float32), None)


def _dot_generals(jaxpr, found):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            found.append(eqn)
        for v in eqn.params.values():
            stack = [v]
            while stack:
                u = stack.pop()
                if isinstance(u, (tuple, list)):
                    stack.extend(u)
                elif hasattr(u, "jaxpr") and hasattr(u.jaxpr, "eqns"):
                    _dot_generals(u.jaxpr, found)
                elif hasattr(u, "eqns"):
                    _dot_generals(u, found)
    return found


@pytest.mark.parametrize("preconditioned", [False, True])
def test_gmres_contractions_ask_for_highest_precision(preconditioned):
    """On a GPU an unqualified float32 contraction may run in TF32; every
    dot_general in the GMRES solve (the CGS2 projections, the back
    substitution and the basis recombination) must carry HIGHEST."""
    from stencil_tpu.krylov import GMRES
    from stencil_tpu.models.advection_diffusion import (
        AdvectionDiffusionProblem,
    )
    from stencil_tpu.multigrid import OperatorMultigrid

    prob = AdvectionDiffusionProblem(shape=(15, 15, 15),
                                     velocity=(1.0, 0.5, 0.25), nu=0.5)
    pre = OperatorMultigrid(prob) if preconditioned else None
    g = GMRES(prob, preconditioner=pre, restart=8)
    fn = g._solve_fn(1e-5)
    padded = prob.initial_grid().data
    f = jnp.zeros(prob.shape, jnp.float32)
    kdatas = pre._level_datas() if pre is not None else None
    traced = fn.trace(padded, f, jnp.int32(8), jnp.float32(0.0),
                      prob.operator_data(), kdatas)
    dots = _dot_generals(traced.jaxpr.jaxpr, [])
    assert len(dots) >= 6
    for eqn in dots:
        prec = eqn.params["precision"]
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec), prec


def test_no_pallas_left_in_the_package():
    """Nothing left in the package imports Pallas, switches an
    interpreter on, or compares the platform with anything but the GPU
    and the CPU."""
    import re
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    files = list((root / "stencil_tpu").rglob("*.py")) + [
        root / "bench.py", root / "__graft_entry__.py",
        root / "chip_smoke.py"]
    for path in files:
        text = path.read_text()
        for needle in ("jax.experimental.pallas", "interpret="):
            assert needle not in text, (path, needle)
        for name in re.findall(r"platform\s*[!=]=\s*[\"'](\w+)[\"']", text):
            assert name in ("gpu", "cpu"), (path, name)
