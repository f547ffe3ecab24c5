"""The port's utils (profiling, visualize, roofline counts) and the
profile_matching entry point, against the JAX package's utils where it has
them.

- PhaseTimer, collect_stages and stage: the same phases and stage names as
  the JAX module for the same regions; a stage is free without a collector
  (no barrier at all) and, unlike the JAX module, a failed barrier raises.
- device_trace writes a Chrome trace that TensorBoard and Perfetto read.
- save_match_visualization writes the same PNG bytes as the JAX package's.
- chip_smoke.py and scripts/torch_roofline.py count work through one module
  and time it with one timer on one set of standard inputs (kernel_bench),
  whose inputs are the standard problem's and whose random top2 sets keep
  their ties.
"""

import ast
import dataclasses
import json
import pathlib
import re

import numpy as np
import pytest
import torch

import tests.torch_port_helpers  # noqa: F401  (caps torch's threads)

from orthosfm_tpu.utils import profiling as jprof
from orthosfm_tpu.utils import visualize as jvis

from orthosfm_torch.config import BundleAdjustConfig
from orthosfm_torch.solvers import ba
from orthosfm_torch.testbench import profile_matching
from orthosfm_torch.testbench.problems import make_problem
from orthosfm_torch.utils import profiling, roofline, visualize

ROOT = pathlib.Path(__file__).resolve().parents[1]
FRONT_END_STAGES = {
    "extract/prepare_gray", "extract/sift", "sift/pyramid_detect", "sift/ori_desc",
    "extract/surf", "extract/assemble", "match/lowres_gate", "match/full_sift",
    "match/full_surf", "match/verify_ransac", "tracks/union_find", "tracks/assemble"}


def _regions(timer_phase):
    with timer_phase("load"):
        pass
    with timer_phase("solve"):
        pass
    with timer_phase("load"):
        pass


def test_phase_timer_matches_jax():
    got, ref = profiling.PhaseTimer(), jprof.PhaseTimer()
    _regions(got.phase)
    _regions(ref.phase)
    assert list(got.elapsed()) == list(ref.elapsed()) == ["load", "solve"]
    pattern = re.compile(r"^(load|solve): \d+\.\d{3} s$")
    lines = got.report().splitlines()
    assert len(lines) == len(ref.report().splitlines()) == 2
    assert all(pattern.match(ln) for ln in lines)


def test_stages_nest_and_sum_like_jax(monkeypatch):
    def regions(stage):
        with stage("outer"):
            with stage("inner"):
                pass
            with stage("inner"):
                pass

    got, ref = {}, {}
    with profiling.collect_stages(got, "cpu") as out:
        assert out is got
        regions(profiling.stage)
    with jprof.collect_stages(ref):
        regions(jprof.stage)
    assert list(got) == list(ref) == ["inner", "outer"]
    assert got["outer"] >= got["inner"] >= 0.0
    # outside a collector nothing is recorded and no barrier runs
    monkeypatch.setattr(torch.cuda, "synchronize", _raise)
    regions(profiling.stage)
    assert list(got) == ["inner", "outer"]


def _raise(*args, **kwargs):
    raise RuntimeError("device fault")


def test_a_failed_stage_barrier_raises(monkeypatch):
    """The JAX module swallows its barrier's exceptions; here a failed
    torch.cuda.synchronize() surfaces from the stage that ran into it."""
    monkeypatch.setattr(torch.cuda, "synchronize", _raise)
    out = {}
    with pytest.raises(RuntimeError, match="device fault"):
        with profiling.collect_stages(out, "cuda"):
            with profiling.stage("extract/sift"):
                pass
    assert out == {}


def test_device_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    with profiling.device_trace(str(tmp_path), device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        with profiling.device_trace(str(tmp_path)):
            pass


def test_ba_recorder_counts_the_calls_by_camera_count():
    cfg = BundleAdjustConfig(max_iterations=7)
    recorder = profiling.BARecorder()
    with recorder.recording():
        results = [ba.run(*make_problem("quat", "cpu", v, 200), True, cfg) for v in (3, 3, 5)]
    ba.run(*make_problem("quat", "cpu", 4, 200), True, cfg)  # outside: not recorded
    s = recorder.summary()
    worked = [int(r.iterations) for r in results]
    assert s["ba_calls"] == 3 and s["iterations_launched"] == 21
    assert s["iterations_worked"] == sum(worked) > 0
    assert s["by_views"] == {3: {"ba_calls": 2, "iterations_launched": 14,
                                 "iterations_worked": worked[0] + worked[1]},
                             5: {"ba_calls": 1, "iterations_launched": 7,
                                 "iterations_worked": worked[2]}}
    assert s["enqueue_ms_per_it"] > 0.0
    assert profiling.ba_recorder() is None


def test_ba_recorder_counts_each_route():
    """The fused route runs the iterations that work and stops, so its
    launched iterations are those; the per-iteration routes launch
    max_iterations a call, and only they give the host's time an
    iteration."""
    cfg = BundleAdjustConfig()  # converges well inside max_iterations
    M = cfg.max_iterations
    problem = make_problem("quat", "cpu", 3, 200)
    recorder = profiling.BARecorder()
    with recorder.recording():
        r_f = ba.run(*problem, True, dataclasses.replace(cfg, impl="fused"))
        r_t = ba.run(*problem, True, dataclasses.replace(cfg, impl="torch"))
    s = recorder.summary()
    worked = int(r_f.iterations)
    assert int(r_t.iterations) == worked < M
    assert s["by_route"]["fused"]["iterations_launched"] == worked
    assert s["by_route"]["torch"]["iterations_launched"] == M
    assert s["iterations_launched"] == M + worked and s["iterations_worked"] == 2 * worked
    assert s["by_views"] == {3: {"ba_calls": 2, "iterations_launched": M + worked,
                                 "iterations_worked": 2 * worked}}
    assert s["enqueue_ms_per_it"] == pytest.approx(s["by_route"]["torch"]["host_ms"] / M)


def test_lm_solve_work_is_the_stages_an_iteration():
    maskT = torch.zeros((4, 10))
    maskT[:2, :6] = 1.0  # 12 observations
    work = roofline.ba_work(maskT, True)
    stages = ("schur_assemble", "camera_solve", "point_update_cost")
    flops, nbytes, stages_ms = roofline.lm_solve_work(maskT, True, 7)
    assert flops == pytest.approx(2 * 18 * 12 + 7 * sum(work[k][0] for k in stages))
    assert nbytes == 16 * 10 + 12 * 4 * 10 + 72 * 4 + 2 * (16 * 10 + 48 * 4) + 32
    assert stages_ms == pytest.approx(7 * sum(roofline.bound(*work[k])[0] for k in stages))
    assert roofline.lm_solve_work(maskT, True, 0)[0] == pytest.approx(2 * 18 * 12)
    smoke, roof = ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_roofline.py"
    _, roof_counts = _defined_and_imported(roof, "orthosfm_torch.utils.roofline")
    _, roof_timing = _defined_and_imported(roof, "orthosfm_torch.utils.kernel_bench")
    _, smoke_timing = _defined_and_imported(smoke, "orthosfm_torch.utils.kernel_bench")
    assert "lm_solve_work" in roof_counts
    assert "time_lm_solve" in roof_timing and "time_lm_solve" in smoke_timing


@pytest.mark.parametrize("views", [3, 64, 192])
@pytest.mark.parametrize("ragged", [False, True])
def test_the_benchmarks_solve_count_is_lm_solve_work(views, ragged):
    """sfm_bench/roofline.py, the benchmark's own count (it imports nothing
    of the program), gives lm_solve_work's flops and bytes from a BA
    record's numbers: views, tracks, observations, the sum of squared views
    a track and the iterations; with and without point optimization."""
    from sfm_bench import roofline as broof

    T = 257
    maskT = torch.ones((views, T))
    if ragged:
        gen = torch.Generator().manual_seed(views)
        maskT = (torch.rand((views, T), generator=gen) < 0.6).float()
        maskT[:, :5] = 0.0  # tracks seen by no view
        maskT[: views - 1, 5:9] = 0.0  # by one view
    m = maskT.sum(0)
    for opt in (True, False):
        flops, nbytes, _ = roofline.lm_solve_work(maskT, opt, 11)
        got = broof.solve_work(views, T, int(m.sum()), int((m * m).sum()), 11, opt)
        assert got[0] == pytest.approx(flops, rel=1e-12) and got[1] == nbytes
    assert broof.F32_FLOPS == roofline.F32_FLOPS and broof.HBM_BYTES == roofline.HBM_BYTES
    assert broof.floor_s(flops, nbytes) * 1e3 == pytest.approx(roofline.bound(flops, nbytes)[0])


def test_save_match_visualization_writes_the_jax_png_bytes(tmp_path):
    rng = np.random.default_rng(0)
    im1 = rng.integers(0, 256, (40, 60, 3), dtype=np.uint8)
    im2 = rng.integers(0, 256, (50, 45, 3), dtype=np.uint8)
    for m in (30, 500):  # all matches drawn, and a random 200 of them
        xy1 = rng.uniform(0, 40, (m, 2)).astype(np.float32)
        xy2 = rng.uniform(0, 45, (m, 2)).astype(np.float32)
        jvis.save_match_visualization(im1, im2, xy1, xy2, str(tmp_path / "jax.png"))
        visualize.save_match_visualization(torch.as_tensor(im1), im2, torch.as_tensor(xy1), xy2,
                                           str(tmp_path / "port.png"))
        assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()


def test_profile_matching_prints_the_jax_keys(tmp_path, capsys):
    """profile_matching on the CPU at 3 views of 160^2: the keys of the JAX
    package's docs/matching_profile.json rows, with the device beside the
    platform, and only the JAX package's stage names."""
    out_file = tmp_path / "profile.json"
    assert profile_matching.main(["--views", "3", "--width", "160", "--no-warmup",
                                  "--platform", "cpu", "--json", str(out_file)]) == 0
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed[0].startswith("track building profile — 3 views × 160² on cpu")
    row = json.loads(printed[-1])
    assert json.loads(out_file.read_text()) == {"3x160": row}
    ref = json.loads((ROOT / "docs" / "matching_profile.json").read_text())["16x2048"]
    assert set(row) == set(ref) | {"device"}
    assert row["platform"] == "cpu" and row["device"] == "cpu"
    assert {"extract/prepare_gray", "extract/sift", "sift/pyramid_detect",
            "sift/ori_desc"} <= set(row["stages"]) <= FRONT_END_STAGES


def _defined_and_imported(path, module):
    tree = ast.parse(path.read_text())
    defined = {n.name for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
                and n.module == module for a in n.names}
    return defined, imported


def test_chip_smoke_and_the_roofline_script_share_one_work_count():
    """One work count (utils/roofline.py) and one timer with one set of
    standard inputs (utils/kernel_bench.py): neither script defines its own,
    and the roofline script does not load the smoke script."""
    counts = {"bound", "ba_work", "top2_work", "camera_solve_work"}
    timing = {"cuda_ms", "host_ms", "stage_inputs", "time_ba_kernels", "random_top2_set"}
    smoke, roof = ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_roofline.py"
    smoke_defs, smoke_counts = _defined_and_imported(smoke, "orthosfm_torch.utils.roofline")
    roof_defs, roof_counts = _defined_and_imported(roof, "orthosfm_torch.utils.roofline")
    _, smoke_timing = _defined_and_imported(smoke, "orthosfm_torch.utils.kernel_bench")
    _, roof_timing = _defined_and_imported(roof, "orthosfm_torch.utils.kernel_bench")
    assert not (smoke_defs | roof_defs) & (counts | timing)
    assert {"bound", "top2_work", "camera_solve_work"} <= smoke_counts
    assert {"ba_work", "top2_work", "bound"} <= roof_counts
    assert {"cuda_ms", "stage_inputs", "time_ba_kernels", "random_top2_set"} <= smoke_timing
    assert {"cuda_ms", "stage_inputs", "time_ba_kernels", "random_top2_set"} <= roof_timing
    assert not re.search(r"spec_from_file_location|import chip_smoke", roof.read_text())
    for path in (smoke, roof):
        assert not re.search(r"\b(67e12|3\.35e12|K1_OBS_FMA\s*=)", path.read_text())


def test_work_counts():
    assert roofline.bound(67e9, 1.0) == (pytest.approx(1.0), "operations")
    assert roofline.bound(0.0, 3.35e9) == (pytest.approx(1.0), "bytes")
    maskT = torch.zeros((4, 10))
    maskT[:2, :6] = 1.0  # 6 tracks seen by 2 views: 12 observations
    work = roofline.ba_work(maskT, True)
    schur = 6 * 3 * 12 * 13 / 2
    assert work["schur_assemble"][0] == pytest.approx(2 * (schur + roofline.K1_OBS_FMA * 12))
    assert work["point_update_cost"][0] == pytest.approx(2 * roofline.K2_OBS_FMA * 12)
    assert work["camera_solve"] == roofline.camera_solve_work(4)
    assert roofline.camera_solve_work(4)[0] == pytest.approx(2 * (24 ** 3 / 6 + 24 ** 2))
    stack = torch.zeros((3, 100, 64))
    ci, cj = torch.tensor([100, 50]), torch.tensor([10, 0])
    flops, nbytes = roofline.top2_work(stack, ci, cj)
    assert flops == 2.0 * 1000 * 64 and nbytes == 4.0 * (160 * 64 + 6 * 2 * 100)


def test_kernel_bench_inputs():
    """The standard inputs are make_problem()'s through ba.prepare, a camera
    step moves the free views only, and the random top2 set holds its unit
    rows, its exact ties and its eight pairs' counts."""
    from orthosfm_torch.solvers import ba_kernels as bk
    from orthosfm_torch.utils import kernel_bench as kb

    inputs = kb.stage_inputs("quat", "cpu", 3, 64)
    cams, points, obs, mask = make_problem("quat", "cpu", 3, 64, 2048.0)
    for got, want in zip(inputs[:3], ba.prepare(points, obs, mask)):
        assert torch.equal(got, want)
    pT, obsT, maskT, rot, camp, free = inputs
    S, dU, rhs = bk.normal_eq_schur_ref("quat", *kb.lm_inputs(inputs), bk.new_state(1e-3, "cpu"),
                                        1.0, True)
    delta, rot_c, camp_c = kb.camera_step(bk.camera_solve_ref, "quat", S, dU, rhs, free, 1e-3,
                                          rot, camp)
    assert delta.shape == (3, 6) and torch.equal(rot_c[0], rot[0])
    assert not torch.equal(rot_c[1:], rot[1:])
    n = 512
    stack, (bi, bj, ci, cj) = kb.random_top2_set("cpu", 64, n=n)
    assert stack.shape == (11, n, 64)
    assert torch.allclose(torch.linalg.vector_norm(stack, dim=-1), torch.ones(11, n))
    assert torch.equal(stack[3, n // 2:], stack[3, :n // 2])
    assert bi.tolist() == [0, 2, 4, 6, 8, 1, 10, 3] and bj.tolist() == [1, 3, 5, 7, 9, 1, 2, 0]
    assert ci.tolist() == [n, n, n - 37, n, n, n, n // 8, n] and cj[3] == 0 and cj[4] == 1
