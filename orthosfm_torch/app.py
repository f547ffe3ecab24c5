"""CLI entry point — mirror of the reference orthosfm-app
(src/app/main.cpp:21-131), port of orthosfm_tpu/app.py.

Usage:
    python -m orthosfm_torch.app PROJECT_FOLDER IMAGE_FOLDER \
        [--calculated-tracks tracks.txt] [--solver N] [--device cuda|cpu]
        [--platform cpu|gpu|cuda] [--devices N]

Without --calculated-tracks the tracks are built from the images. The
device is CUDA unless --device (or the JAX package's --platform, so that
its command lines run here unchanged) names another; without a CUDA device
the CLI stops rather than run on the CPU unasked. --devices N (N > 1)
starts N ranks, one a card (cuda:0 .. cuda:N-1, NCCL), or N CPU processes
(gloo) on the CPU, and shards the reconstruction over them
(parallel.mesh); only rank 0 writes the project's files.
"""

from __future__ import annotations

import argparse
import os
import socket
import sys

#: --platform's values and the torch device each names
PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="orthosfm-torch",
        description="Structure from motion for orthographic images (PyTorch + CUDA)",
    )
    p.add_argument("project_folder", help="folder to store the project in")
    p.add_argument("image_folder", help="folder with input images")
    p.add_argument("--calculated-tracks", default="",
                   help="path to a txt file with pre-calculated tracks")
    p.add_argument("--export-pairwise-tracks", action="store_true",
                   help="export pairwise track files for interop with other tools")
    p.add_argument("--mask-folder", default="",
                   help="folder with masks named {imageName}_mask.png")
    p.add_argument("--downscale-factor", type=int, default=1,
                   help="downscale images by this factor before matching")
    p.add_argument("--overwrite", action="store_true",
                   help="overwrite an existing project in the project folder")
    p.add_argument("--solver", type=int, default=0, choices=[0, 1, 2, 3],
                   help="0=Quaternion 1=EulerHorizontal 2=EulerHorizontalVertical "
                        "3=EulerAllDof")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda; pass cpu to run on the CPU)")
    p.add_argument("--platform", default="", choices=["", *PLATFORMS],
                   help="the JAX package's flag: cpu runs on the CPU, gpu or cuda on the "
                        "card; it overrides --device")
    p.add_argument("--devices", type=int, default=1,
                   help="shard the reconstruction over this many devices (tracks, pairs and "
                        "RANSAC hypotheses split over the ranks; on CUDA one rank a card, so "
                        "this many cards must be present)")
    return p


def device_of(args) -> str:
    """The torch device the parsed flags name: --platform, else --device."""
    return PLATFORMS[args.platform] if args.platform else args.device


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, device_type: str, config) -> None:
    """One rank of `--devices N`: joins the group (NCCL on cards, gloo on
    the CPU) and runs the reconstruction over the mesh."""
    import torch.distributed as dist

    from orthosfm_torch.parallel import mesh as mesh_mod
    from orthosfm_torch.pipeline.reconstruct import reconstruct

    import torch

    backend = "nccl" if device_type == "cuda" else "gloo"
    device = f"cuda:{rank}" if device_type == "cuda" else "cpu"
    if device_type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh = mesh_mod.init_distributed(f"tcp://localhost:{port}", world, rank, backend,
                                     device=device)
    try:
        reconstruct(config, mesh=mesh)
    finally:
        dist.destroy_process_group()


def check_ranks(device, n: int) -> None:
    """Raises unless n ranks can run on `device`'s type: on CUDA, n cards."""
    import torch

    if n < 1:
        raise ValueError(f"--devices must be at least 1, not {n}")
    if device.type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"--devices {n} needs {n} CUDA devices; "
                           f"{torch.cuda.device_count()} present")


def run_ranks(config, device, n: int) -> None:
    """Runs the reconstruction on n ranks started here (torch.multiprocessing
    spawn, a free localhost port): one a card on CUDA, which needs n cards,
    else n CPU processes. A rank that fails raises here."""
    import torch.multiprocessing as mp

    check_ranks(device, n)
    mp.spawn(_rank_main, args=(n, _free_port(), device.type, config), nprocs=n, join=True)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from orthosfm_torch.config import ReconstructionConfig, SolverType
    from orthosfm_torch.io import project as project_io
    from orthosfm_torch.pipeline.reconstruct import reconstruct

    if not os.path.isdir(args.image_folder):
        print("Error: The specified image folder does not exist.")
        return 1
    if args.calculated_tracks and not os.path.isfile(args.calculated_tracks):
        print("Error: The specified track file does not exist.")
        return 1
    device = torch.device(device_of(args))
    if device.type == "cuda" and not torch.cuda.is_available():
        print("Error: no CUDA device is available; pass --device cpu to run on the CPU.")
        return 1
    check_ranks(device, args.devices)
    if not project_io.create_project(args.project_folder, overwrite=args.overwrite):
        return 1

    config = ReconstructionConfig(
        project_folder=args.project_folder,
        image_folder=args.image_folder,
        mask_folder=args.mask_folder,
        track_file=args.calculated_tracks,
        downscale_factor=args.downscale_factor,
        solver=SolverType(args.solver),
        export_pairwise_tracks=args.export_pairwise_tracks,
    )
    if args.devices > 1:
        print(f"Using solver: {config.solver.describe()} on {args.devices} {device.type} ranks")
        run_ranks(config, device, args.devices)
        return 0
    print(f"Using solver: {config.solver.describe()} on {device}")
    reconstruct(config, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
