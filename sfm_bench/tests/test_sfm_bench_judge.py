"""What decides `correct`, held on the CPU at the dry run's toy size: the
program's answer passes, the control (the reference's step in TF32 put in
the program's place by --control) comes out not correct through the same
checks, and a run whose timed path is broken underneath comes out not
correct, for each fault a reconstruction cell can have."""

import json
import pathlib

import numpy as np
import pytest
import torch

from helpers import run_harness

from sfm_bench.reference import refine as rf

LIMITS = pathlib.Path(__file__).parents[1] / "limits" / "from_tracks.sweep16.json"
ARGS = ["--workload", "from_tracks.sweep16", "--seed", "29", "--seconds", "0.1",
        "--trace", "0", "--dry-run"]


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-12, -3.0 - 2**-12, 1e-30], dtype=torch.float32)
    y = rf.tf32_round(x)
    assert y[0] == 1.0 and y[1] == 1.0 + 2**-10 and y[2] == 1.0 and y[3] == -3.0
    bits = y.view(torch.int32) & 0x1FFF
    assert bool((bits == 0).all())


def test_program_passes_and_the_control_fails():
    rc, line, err = run_harness(ARGS)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, line["checks"]
    rc, line, err = run_harness(ARGS + ["--control"])
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]
    assert set(line["checks"]) == set(json.loads(LIMITS.read_text())), line["checks"]
    assert any(c["value"] > c["limit"] for c in line["checks"].values()), line["checks"]
    assert "judged program {" in err


FAULTS = {
    # a step that returns its state unchanged: every BA gives back its start
    "state_unchanged": (
        "import torch\n"
        "from orthosfm_torch.solvers import ba\n"
        "_run = ba.run\n"
        "def run(cams, points4, obs, mask, optimize_points=True, config=ba.BundleAdjustConfig()):\n"
        "    r = _run(cams, points4, obs, mask, optimize_points, config)\n"
        "    n = torch.linalg.vector_norm(points4, dim=-1, keepdim=True)\n"
        "    p = points4 / n.clamp(min=1e-20)\n"
        "    return r._replace(cams=cams, points=p)\n"
        "ba.run = run\n"),
    # half of the batch left out: the job's odd views lose their observations
    "half_the_views": (
        "from orthosfm_torch.pipeline import incremental\n"
        "_rpe = incremental.run_pose_estimation\n"
        "def rpe(tracks, *a, **k):\n"
        "    m = tracks.obs_mask.clone(); m[:, 1::2] = False\n"
        "    return _rpe(tracks.replace(obs_mask=m), *a, **k)\n"
        "incremental.run_pose_estimation = rpe\n"),
    # an answer altered where it is produced: one camera's pose turned slightly
    "answer_altered": (
        "from orthosfm_torch.pipeline import incremental\n"
        "_rpe = incremental.run_pose_estimation\n"
        "def rpe(*a, **k):\n"
        "    res = _rpe(*a, **k)\n"
        "    rot = res.cameras.rot.clone(); k_ = 1 if res.insertion_order[0] != 1 else 2\n"
        "    rot[k_, 1] += 2e-3\n"
        "    res.cameras = res.cameras.replace(rot=rot)\n"
        "    return res\n"
        "incremental.run_pose_estimation = rpe\n"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault):
    rc, line, err = run_harness(ARGS, prelude=FAULTS[fault])
    if rc != 0:  # the fault stopped the run (its warm-up raised): no result at all
        assert line is None, err[-3000:]
        return
    assert line["correct"] is False, (fault, line["checks"], line["failed"])


def test_refine_reaches_the_optimum_of_a_perturbed_truth():
    """The reference alone: from a perturbed true solution of noise-free
    observations it returns to the truth (pixel gaps at float64 rounding)."""
    from sfm_bench.inputs import synthetic
    from sfm_bench.reference import camera_model as cm

    pts = synthetic.blob_cloud(150, seed=1)
    angles = synthetic.ring_angles(5, 3)
    obs, R = synthetic.project_cloud(pts, angles, 2048.0, 2048.0)
    T, V = obs.shape[:2]
    t_idx, v_idx = np.nonzero(np.ones((T, V), bool))
    f64 = dict(dtype=torch.float64)
    truth = rf.Problem(obs=torch.as_tensor(obs[t_idx, v_idx], **f64).clone(),
                       t_idx=torch.as_tensor(t_idx), v_idx=torch.as_tensor(v_idx),
                       wh=torch.full((V, 2), 2048.0, **f64), scale=torch.ones(V, **f64),
                       free=torch.tensor([False] + [True] * (V - 1)),
                       R=torch.as_tensor(R, **f64), offset=torch.zeros((V, 2), **f64),
                       X=torch.as_tensor(pts / synthetic.SCENE_SCALE, **f64))
    truth.obs = rf.residuals(truth) + truth.obs  # exact in float64
    g = torch.Generator().manual_seed(0)
    start = truth.with_solution(
        cm.so3_exp(1e-3 * torch.randn((V, 3), generator=g, **f64)
                   * truth.free[:, None]) @ truth.R,
        truth.offset + 1e-4 * torch.randn((V, 2), generator=g, **f64) * truth.free[:, None],
        truth.X + 1e-3 * torch.randn((T, 3), generator=g, **f64))
    opt = rf.refine(start)
    assert float(rf.residuals(opt).abs().max()) < 1e-6


@pytest.mark.parametrize("euler", [False, True])
def test_trust_region_bounds_a_step_and_leaves_a_small_one(euler):
    from sfm_bench.reference import camera_model as cm

    f64 = dict(dtype=torch.float64)
    V = 3
    angles = torch.tensor([[0.1, 0.2, 0.3]] * V, **f64) if euler else None
    R = cm.euler_basis(angles) if euler else torch.eye(3, **f64).repeat(V, 1, 1)
    p = rf.Problem(obs=torch.zeros((1, 2), **f64), t_idx=torch.zeros(1, dtype=torch.long),
                   v_idx=torch.zeros(1, dtype=torch.long), wh=torch.full((V, 2), 2048.0, **f64),
                   scale=torch.ones(V, **f64), free=torch.tensor([False, True, True]), R=R,
                   offset=torch.zeros((V, 2), **f64), X=torch.zeros((1, 3), **f64),
                   angles=angles)
    big = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.5, -0.4, 0.3]], **f64)
    off, dX = torch.ones((V, 2), **f64), torch.ones((1, 3), **f64)
    q = rf.bounded(p, big, off, dX)
    turn = cm.rotation_angle_deg(q.R, p.R)
    assert float(turn.max()) <= rf.MAX_TURN_DEG + 1e-9
    scale = float(q.offset[2, 0] - p.offset[2, 0])
    assert 0 < scale < 0.05  # the whole step shortened alike
    small = big * 1e-4
    q = rf.bounded(p, small, off, dX)
    assert float(q.offset[2, 0]) == 1.0  # inside the region: the step as it is
