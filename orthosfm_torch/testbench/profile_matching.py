"""Per-stage profile of the track-building stage (feature extraction →
pairwise matching → union-find). Port of
orthosfm_tpu/testbench/profile_matching.py.

Renders the benchmark's sphere scene (seed 7, a 200° ring) on the card,
runs one warm-up pass of pipeline.matching.build_tracks, then runs it again
under utils.profiling.collect_stages: each stage ends in a device barrier
there, so asynchronous device work is attributed to the stage that enqueued
it. The views hold host arrays, as images loaded from files do. The
reference's analog is per-stage WallTimer prints inside MVE
(src/matching/matching_mve.cpp:337-341,411-417) and CudaSift's kernel timers
(src/cuda_sift/cudaSiftH.cu:170).

Usage:
    python -m orthosfm_torch.testbench.profile_matching [--views 16]
        [--width 2048] [--no-warmup] [--json OUT] [--platform cpu|gpu|cuda]

It prints the stage table and one JSON line, the keys of the JAX package's
docs/matching_profile.json rows, with platform "cuda" (or "cpu") and the
card's name and power limit beside it; --json merges the row into OUT under
"{views}x{width}".
"""

from __future__ import annotations

import argparse
import json
import os
import time

SEED = 7
RING_DEGREES = 200.0


def scene_views(num_views: int, width: int, seed: int = SEED, device="cuda"):
    """(ground-truth cameras, views) of the benchmark's sphere scene rendered
    on `device`, each view holding its image as a host array."""
    from orthosfm_torch.data.views import View
    from orthosfm_torch.testbench import render

    gt, images, _ = render.make_scene_views(num_views, width, width, seed=seed,
                                            ring_degrees=RING_DEGREES, device=device)
    return gt, [View(i, f"view_{i:02d}.png", width, width, pixels=img.cpu().numpy())
                for i, img in enumerate(images)]


def profile_matching(num_views: int = 16, width: int = 2048, seed: int = SEED,
                     warmup: bool = True, device="cuda") -> dict:
    """build_tracks on the rendered scene, on `device` (CUDA unless the
    caller names another), with the seconds of each stage."""
    import torch

    from orthosfm_torch.config import ReconstructionConfig
    from orthosfm_torch.pipeline import matching
    from orthosfm_torch.testbench import bench_pipeline
    from orthosfm_torch.utils import profiling

    device = matching.checked_device(device)
    _, views = scene_views(num_views, width, seed, device)
    cfg = ReconstructionConfig()
    if warmup:
        matching.build_tracks(views, cfg, verbose=False, device=device)
    stages: dict = {}
    with profiling.collect_stages(stages, device, trace=False):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.monotonic()
        ts = matching.build_tracks(views, cfg, verbose=False, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        total = time.monotonic() - t0
    return {"num_views": num_views, "width": width, "platform": device.type,
            "device": bench_pipeline.card() if device.type == "cuda" else "cpu",
            "total_s": total, "num_tracks": int(ts.alive.sum()), "stages": stages}


def format_table(out: dict) -> str:
    # Top-level stage keys (extract/, match/, tracks/); sift/* rows are
    # nested inside extract/sift and indent below it.
    stages = out["stages"]
    lines = [f"track building profile — {out['num_views']} views × "
             f"{out['width']}² on {out['platform']} {out['device']} "
             f"(total {out['total_s']:.3f} s, {out['num_tracks']} tracks)"]
    for k in (k for k in stages if not k.startswith("sift/")):
        lines.append(f"  {k:<24s} {stages[k]:8.3f} s")
        if k == "extract/sift":
            for sk in (x for x in stages if x.startswith("sift/")):
                lines.append(f"    {sk:<22s} {stages[sk]:8.3f} s")
    return "\n".join(lines)


def main(argv=None) -> int:
    from orthosfm_torch.app import PLATFORMS

    p = argparse.ArgumentParser(prog="orthosfm-torch-profile-matching")
    p.add_argument("--views", type=int, default=16)
    p.add_argument("--width", type=int, default=2048)
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--json", default="")
    p.add_argument("--platform", default="cuda", choices=sorted(PLATFORMS),
                   help="cpu runs on the CPU, gpu or cuda (the default) on the card")
    args = p.parse_args(argv)

    out = profile_matching(num_views=args.views, width=args.width, warmup=not args.no_warmup,
                           device=PLATFORMS[args.platform])
    print(format_table(out))
    print(json.dumps(out))
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        rows = {}
        if os.path.exists(args.json):
            with open(args.json) as f:
                try:
                    rows = json.load(f)
                except ValueError:
                    rows = {}
        rows[f"{args.views}x{args.width}"] = out
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
