"""``chip_smoke.py``'s phases at tiny sizes on the CPU (the script's
``main`` refuses the CPU; its phase functions are the same code the GPU
run takes, so their plumbing and comparisons are testable here)."""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def rep(cs, capsys):
    return cs.Report("test-card, 1.00 W")


def _lines(capsys):
    return capsys.readouterr().out.splitlines()


def test_report_puts_the_card_beside_every_line(cs, capsys):
    cs.Report("H100, 700.00 W").say("x", "1.5 GLUPS")
    assert _lines(capsys) == ["[x] 1.5 GLUPS | H100, 700.00 W"]


def test_main_refuses_the_cpu(cs, capsys):
    assert cs.main([]) == 2
    out = capsys.readouterr()
    assert "no GPU" in out.err
    assert '"ok"' not in out.out


def test_main_four_cards_refuses_the_cpu(cs, capsys):
    assert cs.main(["--four-cards"]) == 2
    assert '"ok"' not in capsys.readouterr().out


def test_lone_script_exits_nonzero(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "stencil_tpu is not beside" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_phase_memory(cs, rep, capsys):
    cs.phase_memory(rep, (8, 8, 8), "jacobi7")
    (line,) = _lines(capsys)
    assert line.startswith("[memory] 8x8x8 jacobi7 step: argument ")
    assert line.endswith("| test-card, 1.00 W")


def test_phase_wave(cs, rep, capsys):
    err = cs.phase_wave(rep, (10, 12, 14), 6)
    assert err < 1e-5
    assert _lines(capsys)[-1].startswith("[wave] 10x12x14 leapfrog")


def test_phase_wave_fails_on_a_tight_tolerance(cs, rep):
    with pytest.raises(cs.PhaseFailed, match="wave error"):
        cs.phase_wave(rep, (10, 12, 14), 6, tol=0.0)


def test_phase_advection(cs, rep, capsys):
    err = cs.phase_advection(rep, (10, 12, 14), 6)
    assert err < 1e-5
    assert "periodic" in _lines(capsys)[-1]


def test_phase_advection_fails_on_a_tight_tolerance(cs, rep):
    with pytest.raises(cs.PhaseFailed, match="advection error"):
        cs.phase_advection(rep, (10, 12, 14), 6, tol=0.0)


def test_phase_streamed(cs, rep, capsys):
    assert cs.phase_streamed(rep, (16, 8, 8), 4, 3) == 0.0
    assert "max |streamed - xla| 0.000e+00" in _lines(capsys)[-1]


@pytest.mark.parametrize("mesh", [(4,), (2, 2)])
def test_phase_sharded(cs, rep, capsys, mesh):
    assert cs.phase_sharded(rep, (16, 8, 8), mesh, 3) == 0.0
    assert "result on devices [0, 1, 2, 3]" in _lines(capsys)[-1]


def test_phase_march(cs, rep, capsys, tmp_path):
    rec = cs.phase_march(rep, tmp_path, (12, 10, 8), "jacobi7", 4)
    assert rec["check"]["ok"] and rec["device"]["platform"] == "cpu"
    line = _lines(capsys)[-1]
    assert line.startswith("[march] 12x10x8 jacobi7 xla: N=4 iterations")


def test_phase_solve_poisson_holds_the_bar(cs, rep, capsys, tmp_path):
    rec = cs.phase_solve(rep, tmp_path, "poisson", "pcg", (15, 15, 15))
    assert rec["converged"]
    assert "O(h^2) bar" in _lines(capsys)[-1]


def test_phase_cli_failure_is_a_failed_phase(cs, tmp_path):
    with pytest.raises(cs.PhaseFailed, match="returned 1"):
        cs._cli(["-s", "8", "8", "-m", "pallas", "-i", "1"], tmp_path)


def test_last_line_contract(cs, capsys, monkeypatch):
    """With every phase passing (stubbed here), the last stdout line is
    the JSON result with the device as JAX reports it."""
    from stencil_tpu import platform

    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
           "card": "NVIDIA H100 80GB HBM3, 700.00 W"}
    monkeypatch.setattr(platform, "require_gpu", lambda: dev)
    monkeypatch.setattr(platform, "setup_compile_cache", lambda: "/c")
    monkeypatch.setattr(cs, "one_card_phases", lambda rep, wd: iter(()))
    assert cs.main([]) == 0
    lines = _lines(capsys)
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert any("nvidia-smi name, power.limit: NVIDIA H100 80GB HBM3, "
               "700.00 W" in line for line in lines[:-1])


def test_a_failed_phase_fails_the_run(cs, capsys, monkeypatch):
    from stencil_tpu import platform

    dev = {"platform": "gpu", "kind": "k", "count": 1, "card": "c"}
    monkeypatch.setattr(platform, "require_gpu", lambda: dev)
    monkeypatch.setattr(platform, "setup_compile_cache", lambda: "/c")

    def phases(rep, wd):
        def bad():
            raise cs.PhaseFailed("wrong")

        yield bad
        yield lambda: None

    monkeypatch.setattr(cs, "one_card_phases", phases)
    assert cs.main([]) == 1
    out = capsys.readouterr().out
    assert "FAILED" in out and '"ok"' not in out
