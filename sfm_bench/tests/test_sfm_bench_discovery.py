"""The harness finds a configuration, a mix, limits and a per-layer metric
added as new files (and entries in BENCHMARK.json) in a copy of the
benchmark, with no edit to a file that is there; and a checkout that holds
only the benchmark stops with no result."""

import json
import os
import shutil

import pytest

from helpers import ROOT, run_harness


def copy_benchmark(tmp_path, with_program=True):
    dst = tmp_path / "checkout"
    dst.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst / "BENCHMARK.json")
    shutil.copytree(os.path.join(ROOT, "sfm_bench"), dst / "sfm_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    if with_program:
        os.symlink(os.path.join(ROOT, "orthosfm_torch"), dst / "orthosfm_torch")
    return dst


def test_new_cell_found_by_name(tmp_path):
    root = copy_benchmark(tmp_path)
    sb = root / "sfm_bench"
    config = json.loads((sb / "configs" / "from_tracks.json").read_text())
    config["reconstruction"]["global_ba_interval"] = 2
    (sb / "configs" / "from_tracks_b.json").write_text(json.dumps(config))
    mix = json.loads((sb / "mixes" / "sweep16.json").read_text())
    mix["dry_run"]["noise_px_range"] = [2, 2]
    (sb / "mixes" / "tiny.json").write_text(json.dumps(mix))
    (sb / "limits" / "b.tiny.json").write_text(
        (sb / "limits" / "from_tracks.sweep16.json").read_text())
    (sb / "layer_metrics" / "tk_share.py").write_text(
        "def read(records):\n"
        "    jobs = [j for j in records['jobs'] if 'stages' in j]\n"
        "    return sum(j['stages'].get('pose/tk', 0.0) / j['wall_s'] for j in jobs) / len(jobs)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="from_tracks_b",
                                 file="sfm_bench/configs/from_tracks_b.json"))
    bench["workloads"].append({"name": "b.tiny", "config": "from_tracks_b", "traffic": "tiny",
                               "chips": 1, "why": "a cell added by data alone"})
    bench["per_layer"].append({"name": "tk_share", "unit": "%", "better": "lower",
                               "source": "program_span", "layer": "TK initialization",
                               "moves": "recon_s", "workloads": ["b.tiny"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and m["name"] in ("glue_s", "recon_s"):
            m["workloads"].append("b.tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, line, err = run_harness(["--workload", "b.tiny", "--seed", "5", "--seconds", "0.1",
                                 "--trace", "1", "--dry-run"], root=str(root))
    assert rc == 0, err[-3000:]
    assert "cpu_tk_share" in line["dry_run"] and "cpu_glue_s" in line["dry_run"]
    assert line["metrics"] == {} and line["device"]["platform"] == "cpu"
    assert list(line)[-1] == "checks"


def test_benchmark_alone_stops_without_a_result(tmp_path):
    root = copy_benchmark(tmp_path, with_program=False)
    rc, line, err = run_harness(["--workload", "from_tracks.sweep16", "--seed", "1",
                                 "--seconds", "1", "--trace", "0", "--dry-run"], root=str(root))
    assert rc != 0 and line is None and "orthosfm_torch" in err


def test_measured_path_stops_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the measured path would run")
    rc, line, err = run_harness(["--workload", "from_tracks.sweep16", "--seed", "1",
                                 "--seconds", "1", "--trace", "0"])
    assert rc != 0 and line is None and "CUDA" in err
