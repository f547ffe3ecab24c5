"""What decides `correct`: each judged reconstruction against the plain
reference.

A job's answer is what the program returns: every camera's pose, the sparse
points, which views it placed and which observations its final bundle
adjustment kept. Three kinds of number are read from it.

- The gaps to the reference's optimum. The reference (refine.py, float64)
  starts from the program's answer over the observations the program kept,
  and runs Levenberg's method, in a trust region, to the optimum of
  upstream's objective in the basin the answer lies in. The program's
  final global bundle adjustment should have stopped there, up to float32
  and its function tolerance. Read: the objective's excess over the optimum
  a kept observation (`cost_gap_px2`), the widest rotation gap of a camera
  (`pose_gap_deg`) and the RMS gap of the points seen in two views or more,
  in pixels at the largest scale of a camera (`point_rms_px`). Each cell's
  limits file names the numbers it compares. The cost gap of the jobs whose
  noise the cell's mix states a bar for is read again apart
  (`cost_gap_low_noise_px2`): there the program's answer lies at its
  float32 floor. Where noise is high, its final BA stops by its relative
  tolerance (or its max_iterations) short of that floor, and a step of the
  reference in TF32 comes nearer the optimum, not farther: no precision
  below the program's separates there.
- The distance to the ground truth that the benchmark generated, where the
  cell's mix states a bar for the job's noise: the mean (and the widest)
  angle between a placed camera and its true pose, after the pipeline's
  anchor camera is aligned and the mirror pair resolved as upstream's
  testbench does (full_pipeline_tests.cpp:235-297). Read as a share of the
  bar (`gt_bar_share`).
- Placement: every view placed (a job that places fewer counts as failed).

The observations are the benchmark's own copy of what it handed the
program (from tracks), or the tracks the program's front end built (from
images): those are then part of the answer, judged through the poses' bar.

The control is judged by the same code in the program's place: its answer
is the reference's step from the program's answer, computed in TF32.
"""

from __future__ import annotations

import numpy as np
import torch

from sfm_bench.reference import camera_model as cm
from sfm_bench.reference import refine as rf

FLIP = np.diag([1.0, 1.0, -1.0])


def problem_of(answer: dict, obs: np.ndarray, wh: np.ndarray, device) -> rf.Problem:
    """The reference's problem over the observations the answer kept, with the
    answer's solution (float64). Tracks kept in fewer than two views are left
    out: they fix nothing and their depth is free."""
    mask = np.asarray(answer["mask"], bool) & answer["present"][None, :]
    mask &= (mask.sum(1) >= 2)[:, None]
    t_idx, v_idx = np.nonzero(mask)
    keep = np.unique(t_idx)
    remap = np.full(mask.shape[0], -1, np.int64)
    remap[keep] = np.arange(len(keep))
    f64 = dict(dtype=torch.float64, device=device)
    rot = torch.as_tensor(np.asarray(answer["rot"], np.float64), **f64)
    pts = np.asarray(answer["points"], np.float64)[keep]
    free = answer["present"].copy()
    free[answer["anchor"]] = False
    return rf.Problem(
        obs=torch.as_tensor(np.asarray(obs, np.float64)[t_idx, v_idx], **f64),
        t_idx=torch.as_tensor(remap[t_idx], device=device),
        v_idx=torch.as_tensor(v_idx, device=device),
        wh=torch.as_tensor(np.asarray(wh, np.float64), **f64),
        scale=torch.as_tensor(np.asarray(answer["scale"], np.float64), **f64),
        free=torch.as_tensor(free, device=device),
        R=cm.basis(answer["kind"], rot),
        offset=torch.as_tensor(np.asarray(answer["offset"], np.float64), **f64),
        X=torch.as_tensor(pts[:, :3] / pts[:, 3:4], **f64),
        angles=rot[:, :3].clone() if answer["kind"] == "euler" else None)


def gaps(a: rf.Problem, b: rf.Problem) -> dict:
    """The widest gaps of solution a to solution b (same problem); none where
    the answer kept no observation."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    if a.obs.shape[0] == 0:
        return {}  # nothing kept: nothing to compare
    used = torch.zeros(a.R.shape[0], dtype=torch.bool, device=a.R.device)
    used[a.v_idx] = True
    ang = cm.rotation_angle_deg(a.R[used], b.R[used])
    px_per_unit = torch.max(b.wh / (2.0 * b.scale[:, None]))
    pt = torch.linalg.vector_norm(a.X - b.X, dim=-1) * px_per_unit
    excess = (rf.cost(rf.residuals(a)) - rf.cost(rf.residuals(b))) / a.obs.shape[0]
    return {"cost_gap_px2": float(excess), "pose_gap_deg": float(ang.max()),
            "point_rms_px": float(torch.sqrt(torch.mean(pt * pt)))}


def gt_errors(R: np.ndarray, present: np.ndarray, anchor: int,
              gt_R: np.ndarray) -> np.ndarray:
    """Angle in degrees between each placed camera's basis R (V, 3, 3) and
    its true pose, with the true poses expressed in the anchor's frame (the
    pipeline sets the anchor's basis to the identity) and the mirror pair
    resolved from the first two cameras' centres, as upstream's testbench
    does."""
    G = np.einsum("ji,vjk->vik", gt_R[anchor], gt_R)  # R_a^T R_v

    def unit(v):
        return v / max(np.linalg.norm(v), 1e-12)

    o_est, o_ref = -10.0 * R[:, :, 2], -10.0 * G[:, :, 2]
    d_est = unit(unit(o_est[1]) - unit(o_est[0]))
    d_ref = unit(unit(o_ref[1]) - unit(o_ref[0]))
    if float(np.dot(d_est, d_ref)) < 0.0:
        R = np.einsum("ij,vjk,kl->vil", FLIP, R, FLIP)
    ang = cm.rotation_angle_deg(torch.as_tensor(R), torch.as_tensor(G)).numpy()
    return ang[present]


def bar_for(bars, noise_px):
    """The cell's stated bar for a job's noise: the first entry whose
    `noise_px_max` the noise does not exceed, or None."""
    for b in bars:
        if noise_px is not None and noise_px <= b["noise_px_max"]:
            return b
    return None


def judge(answer: dict, job: dict, bars, device, control: bool = False) -> dict:
    """The numbers of one answer. `job`: obs (T, V, 2) where the benchmark
    made them (else the answer's `obs`), wh (V, 2), gt_R (V, 3, 3), noise_px.
    With `control`, the control's answer is judged in the program's place:
    the reference's step from the program's answer in TF32, taken."""
    obs = job["obs"] if job.get("obs") is not None else answer["obs"]
    p = problem_of(answer, obs, job["wh"], device)
    if control:
        p = rf.control_step(p)
    out = gaps(p, rf.refine(p))
    b = bar_for(bars, job.get("noise_px"))
    if b is not None:
        if "cost_gap_px2" in out:
            out["cost_gap_low_noise_px2"] = out["cost_gap_px2"]
        ang = gt_errors(p.R.to(torch.float64).cpu().numpy(), answer["present"],
                        answer["anchor"], job["gt_R"])
        share = float(np.mean(ang)) / b["mean_deg"]
        if "max_deg" in b:
            share = max(share, float(np.max(ang)) / b["max_deg"])
        out["gt_bar_share"] = share
        out["gt_mean_deg"] = float(np.mean(ang))
        out["gt_max_deg"] = float(np.max(ang))
    return out
