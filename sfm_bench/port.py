"""The benchmark's only door into the system under test, orthosfm_torch:
its entry points, its stage spans and its bundle-adjustment recorder (the
kernels' names are read in layer_metrics/). Everything of the program is
imported inside the functions, so that the rest of the harness loads
without it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import os
import time

import numpy as np


def present(root: str) -> bool:
    """Whether the program's package sits in the checkout at `root`."""
    spec = importlib.util.find_spec("orthosfm_torch")
    return (spec is not None and spec.origin is not None
            and os.path.dirname(os.path.dirname(os.path.abspath(spec.origin)))
            == os.path.abspath(root))


def reconstruction_config(fields: dict, solver: str, seed: int, **paths):
    """A ReconstructionConfig from the configuration file's fields (nested
    groups as dicts), the input's solver and RANSAC seed, and the folders."""
    from orthosfm_torch import config as c

    groups = {"ransac": c.RansacConfig, "ba": c.BundleAdjustConfig,
              "filters": c.FilterConfig, "matching": c.MatchingConfig}
    kw = {k: (groups[k](**v) if k in groups else v) for k, v in fields.items()}
    return c.ReconstructionConfig(solver=c.SolverType[solver], seed=seed, **kw, **paths)


def build_kernels(device) -> None:
    """Build (first run in a checkout) or load the program's kernel libraries."""
    if device.type != "cuda":
        return
    from orthosfm_torch.ops import matching_kernels as mk
    from orthosfm_torch.solvers import ba_kernels as bk
    from orthosfm_torch.solvers import tk_kernels as tkk

    bk.library()
    tkk.library()
    mk.library()


def trackset(obs: np.ndarray, device):
    """The program's TrackSet of full-length tracks (every view observed)."""
    import torch

    from orthosfm_torch.data import tracks as tracks_mod

    T, V = obs.shape[:2]
    ts = tracks_mod.empty(T, V, device=device)
    ids = torch.arange(T, device=device)
    ts.obs[:] = torch.as_tensor(obs, device=device)
    ts.obs_mask[:] = True
    ts.local_ids[:] = ids.to(torch.int32)[:, None]
    ts.global_ids[:] = (ids[:, None] * V + torch.arange(V, device=device)[None, :]).to(
        torch.int32)
    ts.alive[:] = True
    return ts


def run_tracks(tracks, wh: np.ndarray, cfg):
    from orthosfm_torch.pipeline import incremental

    return incremental.run_pose_estimation(tracks, wh[:, 0], wh[:, 1], cfg, verbose=False)


def run_images(cfg, device):
    from orthosfm_torch.pipeline import reconstruct

    # the pipeline's notices ("No masks available ...") stay off the result's stream
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        result, _ = reconstruct.reconstruct(cfg, verbose=False, device=device)
    return result


def answer(result, with_obs: bool) -> dict:
    """The program's answer as host arrays: the cameras' raw parameters, the
    placed views, the anchor (first placed) camera, the points, the
    observations its final bundle adjustment kept, and (images) the
    tracks' observations."""
    cams, ts = result.cameras, result.tracks
    vids = cams.view_ids.cpu().numpy()
    col_of = {int(v): i for i, v in enumerate(vids)}
    present_ = np.asarray(result.present, bool)
    mask = (ts.obs_mask & ts.alive[:, None] & ts.has_point[:, None]).cpu().numpy()
    out = {"kind": cams.kind, "rot": cams.rot.cpu().numpy(), "offset": cams.offset.cpu().numpy(),
           "scale": cams.scale.cpu().numpy(), "present": present_,
           "anchor": col_of[int(result.insertion_order[0])],
           "points": ts.points.cpu().numpy(), "mask": mask & present_[None, :]}
    if with_obs:
        out["obs"] = ts.obs.cpu().numpy()
    return out


@dataclasses.dataclass
class Recording:
    """What one traced job left: its stage sums and spans (host clock,
    time.monotonic) and its bundle adjustments."""

    stages: dict
    spans: list
    recorder: object


class _StageLog(dict):
    """The dict that the program's collect_stages adds each stage's seconds
    to (out[name] = out.get(name, 0) + dt as the stage ends); it also keeps
    each stage's span."""

    def __init__(self):
        super().__init__()
        self.spans = []

    def __setitem__(self, name, total):
        end = time.monotonic()
        self.spans.append((name, end - (total - self.get(name, 0.0)), end))
        super().__setitem__(name, total)


@contextlib.contextmanager
def recording(device):
    """Run the enclosed job under the program's stage collector (each stage
    ends in a device barrier) and its BA recorder."""
    from orthosfm_torch.utils import profiling

    log = _StageLog()
    rec = profiling.BARecorder()
    with profiling.collect_stages(log, device), rec.recording():
        yield Recording(stages=log, spans=log.spans, recorder=rec)


def ba_iterations(rec: Recording) -> int:
    return int(rec.recorder.summary()["iterations_worked"])
