"""Each cell's measured path on the card, for a short window: the result
line's keys, the device, and `correct`. Marked `cuda`; skips without a
card (decided inside the test)."""

import json
import os

import pytest

from helpers import ROOT, run_harness

pytestmark = pytest.mark.cuda

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rc, line, err = run_harness(["--workload", cell, "--seed", "4000000007", "--seconds", "3",
                                 "--trace", str(trace)])
    assert rc == 0, err[-3000:]
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert "device_idle_pct" in line["metrics"]
    else:
        assert {"setup_s", "recon_s", "peak_device_gb"} <= set(line["metrics"])
