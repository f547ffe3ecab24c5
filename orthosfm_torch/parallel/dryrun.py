"""Multi-device dry run: one full reconstruction from images through the
sharded path. Port of the JAX package's __graft_entry__.dryrun_multichip.

Every rank of a process group (parallel.mesh.init_distributed) calls
dryrun_multichip(mesh): it renders the same 6 sphere views of 224² (seed 3,
a 140° arc) on its device, extracts SIFT and SURF, matches and verifies the
pairs sharded over the ranks (match_all_pairs(mesh=)), builds the tracks and
runs the incremental pose estimation with every TK initialization and every
local and global BA sharded (run_pose_estimation(mesh=)). NCCL ranks run it
on cards, gloo ranks on the CPU.

    python -m orthosfm_torch.parallel.dryrun [--ranks N] [--platform cpu|gpu|cuda]

starts N ranks here (one a card on CUDA, which needs N cards; N gloo
processes with --platform cpu) and raises if a rank's checks fail.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import numpy as np

NUM_VIEWS = 6
WIDTH = 224  # 140° arc at 224²: ~29 full-size tracks for the seed group


def dryrun_multichip(mesh, verbose: bool = True) -> dict:
    """The sharded reconstruction from images on `mesh`'s rank; raises unless
    at least NUM_VIEWS - 1 pairs matched, every camera was placed and the
    mean angular error is under 5°. Returns what it found."""
    from orthosfm_torch.config import (BundleAdjustConfig, RansacConfig,
                                       ReconstructionConfig, SolverType)
    from orthosfm_torch.data import views as views_mod
    from orthosfm_torch.pipeline import incremental, matching
    from orthosfm_torch.testbench import metrics, render

    device = mesh.device
    img_dir = tempfile.mkdtemp(prefix="osfm_dryrun_imgs_")
    try:
        gt = render.make_image_dataset(img_dir, num_views=NUM_VIEWS, width=WIDTH, height=WIDTH,
                                       seed=3, ring_degrees=140.0, device=device)
        config = ReconstructionConfig(
            solver=SolverType.ORTHO_QUATERNION, seed=0,
            ba=BundleAdjustConfig(max_iterations=4),
            ransac=RansacConfig(min_consensus_size=10))
        views = views_mod.load_views(img_dir)
        features = matching.extract_all_view_features(views, config, device)
        pair_matches = matching.match_all_pairs(features, config, verbose=False, mesh=mesh)
        tracks = matching.tracks_from_matches(views, features, pair_matches, device=device)
        res = incremental.run_pose_estimation(
            tracks, np.full(NUM_VIEWS, float(WIDTH)), np.full(NUM_VIEWS, float(WIDTH)), config,
            verbose=False, mesh=mesh)
        ang, _ = metrics.pose_errors(res.cameras, gt)
    finally:
        shutil.rmtree(img_dir, ignore_errors=True)
    out = {"ranks": mesh.size, "pairs": len(pair_matches), "tracks": int(tracks.alive.sum()),
           "placed": len(res.insertion_order), "mean_angular_error_deg": float(np.mean(ang)),
           "rot": res.cameras.rot.cpu()}
    if verbose:
        print(f"dryrun_multichip({mesh.size}) rank {mesh.rank}: full sharded image pipeline — "
              f"{NUM_VIEWS} rendered views, {out['pairs']} matched pairs (pair-sharded "
              f"matching+RANSAC), {out['tracks']} tracks, {out['placed']} cameras placed; "
              f"mean angular error {out['mean_angular_error_deg']:.3f} deg")
    if out["pairs"] < NUM_VIEWS - 1:
        raise RuntimeError(f"dryrun_multichip: too few matched pairs ({out['pairs']})")
    if not res.present.all():
        raise RuntimeError("dryrun_multichip: not all cameras were placed")
    if out["mean_angular_error_deg"] >= 5.0:
        raise RuntimeError("dryrun_multichip: the sharded pipeline diverged from the ground "
                           f"truth ({out['mean_angular_error_deg']} deg)")
    return out


def _rank_main(rank: int, world: int, port: int, device_type: str) -> None:
    import torch
    import torch.distributed as dist

    from orthosfm_torch.parallel import mesh as mesh_mod

    cuda = device_type == "cuda"
    if not cuda:  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh = mesh_mod.init_distributed(f"tcp://localhost:{port}", world, rank,
                                     "nccl" if cuda else "gloo",
                                     device=f"cuda:{rank}" if cuda else "cpu")
    try:
        dryrun_multichip(mesh)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    import torch
    import torch.multiprocessing as mp

    from orthosfm_torch.app import PLATFORMS, _free_port, check_ranks
    from orthosfm_torch.pipeline.matching import checked_device

    p = argparse.ArgumentParser(prog="orthosfm-torch-dryrun")
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--platform", default="cuda", choices=sorted(PLATFORMS),
                   help="cpu: gloo ranks on the CPU; gpu or cuda (the default): NCCL, a card "
                        "a rank")
    args = p.parse_args(argv)
    device = checked_device(PLATFORMS[args.platform])
    check_ranks(device, args.ranks)
    mp.spawn(_rank_main, args=(args.ranks, _free_port(), device.type), nprocs=args.ranks,
             join=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
