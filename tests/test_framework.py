"""Framework-layer tests: config parsing, CLI driver, sweep harness,
image output, timing, models."""

import json
import os

import numpy as np
import pytest

from stencil_tpu.config import RunConfig, parse_args
from stencil_tpu.core.grid import HaloGrid
from stencil_tpu.core import spec as S
from stencil_tpu.models.heat import HeatDiffusion, LaplaceRelaxation
from stencil_tpu.ops import golden
from stencil_tpu.utils.image import colorize, dump_heatmap, write_bmp
from stencil_tpu.utils.timing import TinyTimer


# ---- config ------------------------------------------------------------------


def test_parse_defaults():
    cfg = parse_args([])
    assert cfg.size == (512, 512)
    assert cfg.iterations == 1000
    assert cfg.methods == ("xla",)
    assert not cfg.check


def test_parse_reference_style_flags():
    # mirrors the reference CLI surface (program_options.cpp:13-37)
    # minus -b/--block-size, which sized the removed slab kernels
    cfg = parse_args(["-s", "400", "400", "-i", "1000",
                      "-R", "3", "-m", "xla", "sharded", "-c", "-r", "2"])
    assert cfg.size == (400, 400)
    assert cfg.repeat == 3
    assert cfg.methods == ("xla", "sharded")
    assert cfg.check
    sp = cfg.resolved_spec()
    assert sp.radius == 2 and sp.num_taps == 8


def test_parse_3d():
    cfg = parse_args(["-s", "64", "64", "64", "--spec", "jacobi7"])
    assert cfg.resolved_spec().ndim == 3


def test_spec_rank_mismatch():
    cfg = parse_args(["-s", "64", "64", "--spec", "jacobi7"])
    with pytest.raises(ValueError):
        cfg.resolved_spec()


# ---- CLI driver ----------------------------------------------------------------


def test_cli_run_xla_with_check(tmp_path, capsys):
    from stencil_tpu.cli import run_all

    cfg = RunConfig(size=(24, 32), iterations=8, methods=("xla",),
                    check=True, json_out=str(tmp_path / "out.jsonl"))
    results = run_all(cfg)
    assert len(results) == 1
    assert results[0]["check"]["ok"]
    # honest -c reporting: the record must say how many iterations the
    # golden comparison actually covered (8 <= the NumPy fallback's 50
    # cap, so both the native and fallback paths verify all 8)
    assert results[0]["check"]["iterations_checked"] == 8
    assert results[0]["check"]["capped"] is False
    assert results[0]["glups"] > 0
    lines = (tmp_path / "out.jsonl").read_text().strip().split("\n")
    assert json.loads(lines[0])["method"] == "xla"


def test_cli_check_reports_numpy_fallback_cap(monkeypatch, capsys):
    """Without a C++ toolchain the NumPy golden caps the check at 50
    iterations — the CLI must say so loudly instead of printing a bare
    'OK' (round-3 verdict item 4)."""
    import io

    from stencil_tpu import native
    from stencil_tpu.cli import run_all

    monkeypatch.setattr(native, "golden_iterate_native",
                        lambda *a, **k: None)
    cfg = RunConfig(size=(16, 24), iterations=60, methods=("xla",),
                    check=True)
    buf = io.StringIO()
    results = run_all(cfg, out=buf)
    chk = results[0]["check"]
    assert chk["ok"]
    assert chk["iterations_checked"] == 50
    assert chk["capped"] is True
    text = buf.getvalue()
    assert "WARNING" in text and "50 of 60" in text
    assert "(50 iterations verified)" in text


def test_cli_unknown_method(capsys):
    from stencil_tpu.cli import run_all

    cfg = RunConfig(size=(16, 16), iterations=2, methods=("nope",))
    results = run_all(cfg)
    assert "error" in results[0]


def test_cli_dump_image(tmp_path):
    from stencil_tpu.cli import run_all

    img = tmp_path / "heat.bmp"
    cfg = RunConfig(size=(16, 16), iterations=4, methods=("xla",),
                    dump_image=str(img))
    run_all(cfg)
    data = img.read_bytes()
    assert data[:2] == b"BM"


def test_sweep_configs_consistent_with_cli():
    from stencil_tpu.sweep import sweep_configs

    cfgs = sweep_configs(sizes=[32], iterations=[4], methods=["xla"])
    assert all(isinstance(c, RunConfig) for c in cfgs)
    assert cfgs[0].size == (32, 32)


def test_sweep_runs_end_to_end(tmp_path):
    from stencil_tpu.sweep import run_sweep, sweep_configs

    cfgs = sweep_configs(sizes=[16], iterations=[2], methods=["xla"])
    rows = run_sweep(cfgs, csv_path=tmp_path / "s.csv",
                     json_path=tmp_path / "s.jsonl",
                     progress=lambda *_: None)
    assert rows and rows[0]["glups"] > 0
    assert (tmp_path / "s.csv").exists()


def test_no_overlap_flag_is_live():
    """--no-overlap must actually switch the sharded method (silent no-op
    flags are the reference's run.sh/run_expr.py drift bug)."""
    from stencil_tpu import registry

    cfg = RunConfig(size=(32, 32), iterations=2, mesh=(2,))
    spec = cfg.resolved_spec()
    grid = HaloGrid.create(cfg.size, halo=spec.radius)
    r_overlap = registry.get_runner("sharded", cfg, spec, grid)
    cfg_no = RunConfig(size=(32, 32), iterations=2, mesh=(2,),
                       no_overlap=True)
    r_no = registry.get_runner("sharded", cfg_no, spec, grid)
    assert r_overlap.name == "sharded"
    assert r_no.name == "sharded_noverlap"


def test_warmup_flag_is_live():
    """--warmup must change the warmup sweep count handed to the timer."""
    from stencil_tpu import cli, registry

    calls = []

    class FakeRunner:
        granularity = 1

        def iterate(self, grid, n):
            calls.append(int(n))
            return grid

    cfg = RunConfig(size=(16, 16), iterations=4, warmup=7)
    spec = cfg.resolved_spec()
    cli.bench_method(cfg, spec, FakeRunner())
    assert calls[0] == 7  # first (warmup) call runs warmup*granularity sweeps


def test_every_config_field_is_consumed(tmp_path):
    """Anti-drift guard: every RunConfig field must be READ by the driver
    stack during a full-featured run. A field nobody reads is a silent
    no-op flag — the exact bug class the reference's harness had
    (SURVEY §5 config note)."""
    import dataclasses as dc

    from stencil_tpu import cli

    read = set()

    class TrackingConfig(RunConfig):
        def __getattribute__(self, name):
            if not name.startswith("_"):
                read.add(name)
            return super().__getattribute__(name)

    cfg = TrackingConfig(
        size=(16, 16), iterations=2,
        methods=("xla", "streamed", "sharded"),
        temporal=2, mesh=(2,), chunks=2, check=True,
        json_out=str(tmp_path / "o.jsonl"),
        dump_image=str(tmp_path / "h.bmp"),
        checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=1,
        profile_dir=None, verbose=True,
    )
    cli.run_all(cfg, out=open(os.devnull, "w"))
    cfg.apply_platform()          # consumed on the main() path
    # the SOLVER surface reads the solve-mode fields — same guarantee
    # (round-4 verdict: "no solver capability reachable only by
    # writing Python", and no dead solver flag either)
    devnull = open(os.devnull, "w")
    for kw in (
        dict(solve="poisson", solver="gmres", iterations=40,
             restart=8, precond="none", warm_start="fmg",
             tolerance=1e-3, rhs="sine", check=True,
             checkpoint_dir=str(tmp_path / "sckpt"),
             checkpoint_every=20, repeat=1),
        dict(solve="poisson", solver="pcg", iterations=40,
             smoother="chebyshev", gamma=2, nu_smooth=(1, 1),
             precond_dtype="bfloat16",
             tolerance=1e-3, repeat=2,
             dump_image=str(tmp_path / "s.bmp"),
             json_out=str(tmp_path / "s.jsonl")),
        dict(solve="advdiff", solver="bicgstab", iterations=40,
             velocity=(1.0, 0.5), nu=0.5, scheme="upwind",
             tolerance=1e-3),
        dict(solve="hetero", solver="bicgstab", iterations=40,
             contrast=10.0, tolerance=1e-3),
    ):
        scfg = TrackingConfig(size=(15, 15), **kw)
        cli.run_all(scfg, out=devnull)
    fields = {f.name for f in dc.fields(RunConfig)}
    unread = fields - read
    # `verbose` is consumed by main() (total-driver-time line), which we
    # can't call here without re-parsing argv — pin it by source instead
    import inspect

    assert "config.verbose" in inspect.getsource(cli.main)
    unread -= {"verbose"}
    assert not unread, f"RunConfig fields never read by the driver: {unread}"


def test_colorize_ramp():
    rgb = colorize(np.array([[0.0, 0.5, 1.0]]))
    assert tuple(rgb[0, 0]) == (0, 0, 255)      # cold = blue
    assert tuple(rgb[0, 2]) == (255, 0, 0)      # hot = red
    assert rgb[0, 1][1] > 200                    # mid = green-ish


def test_colorize_reference_exact_pixels():
    """Golden pixels of the reference's 4-segment ramp
    (stencil.cpp:162-183), incl. its u8 truncation semantics."""
    v = np.array([0.0, 0.1, 0.25, 0.3, 0.5, 0.6, 0.75, 0.9, 1.0])
    rgb = colorize(v)
    def ref_pixel(x):
        if x < 0.25:
            return (0, int(4 * x * 255), 255)
        if x < 0.5:
            return (0, 255, int((1 + 4 * (0.25 - x)) * 255))
        if x < 0.75:
            return (int(4 * (x - 0.5) * 255), 255, 0)
        return (255, int((1 + 4 * (0.75 - x)) * 255), 0)
    for i, x in enumerate(v):
        assert tuple(rgb[i]) == ref_pixel(float(x)), (x, tuple(rgb[i]))
    # v = 0.25 is cyan in the reference ramp (second branch, b = 255)
    assert tuple(colorize(np.array([0.25]))[0]) == (0, 255, 255)


def test_write_bmp_format(tmp_path):
    p = tmp_path / "x.bmp"
    rgb = np.zeros((3, 5, 3), np.uint8)
    rgb[0, 0] = (255, 0, 0)
    write_bmp(p, rgb)
    data = p.read_bytes()
    assert data[:2] == b"BM"
    # 24-bit, 40-byte info header
    assert data[14] == 40
    import struct
    w, h = struct.unpack("<ii", data[18:26])
    assert (w, h) == (5, 3)
    bpp = struct.unpack("<H", data[28:30])[0]
    assert bpp == 24
    # bottom-up rows, BGR: our (0,0) red pixel is at start of the LAST row
    row_bytes = (5 * 3 + 3) // 4 * 4
    off = 54 + 2 * row_bytes
    assert data[off:off + 3] == bytes([0, 0, 255])  # BGR of red


def test_dump_heatmap_3d_takes_middle_slice(tmp_path):
    p = tmp_path / "h.bmp"
    vol = np.zeros((4, 6, 8))
    dump_heatmap(p, vol)
    assert p.read_bytes()[:2] == b"BM"


# ---- timing --------------------------------------------------------------------


def test_tiny_timer_accumulates():
    t = TinyTimer().start()
    t.pause()
    s1 = t.seconds
    t.start()
    t.pause()
    assert t.seconds >= s1
    t.restart()
    assert t.seconds < 1.0
    assert "s" in t.pretty()


# ---- models --------------------------------------------------------------------


def test_laplace_relaxation_is_reference_spec():
    m = LaplaceRelaxation(shape=(32, 32))
    assert m.spec.uniform_weight == pytest.approx(0.25)
    g = m.initial_grid()
    assert g.interior_shape == (32, 32)


def test_heat_diffusion_stability():
    m = HeatDiffusion(shape=(16, 16), alpha=1.0, h=1.0, dt=0.25)
    assert m.fourier == pytest.approx(0.25)
    sp = m.spec  # center weight vanishes at the stability limit
    assert (0, 0) not in sp.offsets
    with pytest.raises(ValueError):
        HeatDiffusion(shape=(16, 16), dt=0.3).fourier


def test_heat_diffusion_conserves_mean_with_insulated_analogue(rng):
    # with all-BC = initial uniform value, diffusion keeps the field constant
    from stencil_tpu.core.grid import DirichletBC
    from stencil_tpu.ops import xla

    bc = DirichletBC(values=((3.0, 3.0), (3.0, 3.0)))
    m = HeatDiffusion(shape=(12, 12), dt=0.1, bc=bc)
    g = m.initial_grid(interior=np.full((12, 12), 3.0, np.float32))
    out = xla.iterate(g, m.spec, 20)
    np.testing.assert_allclose(np.asarray(out.interior()), 3.0, atol=1e-5)


def test_heat_matches_golden(rng):
    from stencil_tpu.ops import xla

    m = HeatDiffusion(shape=(16, 20), dt=0.2)
    x0 = rng.random((16, 20)).astype(np.float32)
    g = m.initial_grid(interior=x0)
    out = xla.iterate(g, m.spec, 6)
    ref = golden.golden_iterate(x0, m.spec, 6, bc=g.bc)
    chk = golden.check_against_golden(np.asarray(out.interior()), ref)
    assert chk.ok, chk.message()


def test_cli_spec_rank_mismatch_is_clean_error(capsys):
    from stencil_tpu import cli

    rc = cli.main(["-s", "64", "40", "64", "-m", "xla", "-i", "2",
                   "--platform", "cpu"])
    assert rc == 2
    assert "is 2D but size is 3D" in capsys.readouterr().err
