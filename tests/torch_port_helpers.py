"""Shared set-up for the orthosfm_torch parity tests (tests/test_torch_*.py).

The Tier-1 gate runs several pytest workers on one machine, so each test
process caps torch's intra-op threads. The helpers convert the JAX package's
inputs and outputs to torch through numpy, casting floats to f32.
"""

import numpy as np
import torch

torch.set_num_threads(2)


def t(x, dtype=None):
    """A torch (CPU) tensor holding a copy of the array x."""
    a = np.array(x)
    if dtype is None and a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(a if dtype is None else a.astype(dtype))


def n(x):
    """A numpy copy of a torch tensor or a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Ranks over gloo (tests/test_torch_parallel.py): each rank is a Python
# process of its own that imports torch and the port, never jax.

_RANK_MAIN = "import sys; from tests.torch_port_helpers import rank_entry; rank_entry(sys.argv[1:])"


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(target: str, world: int, workdir, timeout: float = 120.0, **kwargs):
    """Runs rank_<target>(mesh, **kwargs) of this module on `world` gloo
    ranks on the CPU, each a process of its own joined over localhost on a
    free port, and returns each rank's result. The ranks are killed after
    `timeout` seconds, so a hung rendezvous fails the test instead of the
    run."""
    import os
    import subprocess
    import sys
    import time
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    workdir = Path(workdir)
    tag = f"{target}_{world}"
    args_file = workdir / f"{tag}_args.pt"
    torch.save(kwargs, args_file)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(root), *filter(None, [env.get("PYTHONPATH")])])
    port = free_port()
    logs = [workdir / f"{tag}_rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RANK_MAIN, target, str(world), str(r), str(port),
                 str(workdir), str(args_file)],
                cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        raise AssertionError(f"{tag}: the ranks ran past {timeout} s:\n" +
                             "\n".join(log.read_text()[-2000:] for log in logs))
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"{tag} rank {r}:\n{logs[r].read_text()[-4000:]}"
    return [torch.load(workdir / f"{tag}_rank{r}.pt", weights_only=False) for r in range(world)]


def rank_entry(argv):
    """A rank's process: joins the gloo group, runs rank_<target> and saves
    what it returns."""
    from pathlib import Path

    import torch.distributed as dist

    from orthosfm_torch.parallel import mesh as mesh_mod

    target, world, rank, port, workdir, args_file = argv
    mesh = mesh_mod.init_distributed(f"tcp://localhost:{port}", int(world), int(rank), "gloo",
                                     device="cpu")
    kwargs = torch.load(args_file, weights_only=False)
    out = globals()[f"rank_{target}"](mesh, **kwargs)
    torch.save(out, Path(workdir) / f"{target}_{world}_rank{rank}.pt")
    dist.destroy_process_group()


def sharded_ba(mesh, problem, config):
    """parallel.ba_sharded on this rank's shard of problem's tracks."""
    from orthosfm_torch.parallel import ba_sharded

    cams, points, obs, mask = problem
    padded, T = ba_sharded.pad_tracks([points, obs, mask], mesh.size)
    res = ba_sharded.make_sharded_ba(mesh, True, config)(
        cams, *ba_sharded.shard_track_arrays(mesh, padded))
    return {"rot": res.cams.rot, "offset": res.cams.offset, "scale": res.cams.scale,
            "points": res.points[:T], "cost": float(res.cost),
            "initial_cost": float(res.initial_cost), "iterations": int(res.iterations)}


def sharded_tk(mesh, obs, valid, seed, cfg):
    """parallel.tk_sharded with the draws of a CPU generator seeded `seed`."""
    from orthosfm_torch.parallel import tk_sharded

    gen = torch.Generator().manual_seed(seed)
    res = tk_sharded.make_sharded_tk(mesh, cfg)(obs, valid, 2048.0, 2048.0, generator=gen)
    return res._asdict()


def pose_cameras(res):
    """A PoseEstimationResult's cameras, present mask and order, as tensors."""
    return {"rot": res.cameras.rot, "offset": res.cameras.offset, "scale": res.cameras.scale,
            "present": res.present, "order": list(res.insertion_order)}


def rank_world2(mesh, problem, ba_config, features, config, tracks, wh):
    """Everything the world-size-2 tests read: the sharded BA, the sharded
    pair matching and the sharded pose estimation."""
    from orthosfm_torch.pipeline import incremental
    from orthosfm_torch.pipeline import matching as pipe

    pose = incremental.run_pose_estimation(tracks, wh, wh, config, verbose=False, mesh=mesh)
    return {"ba": sharded_ba(mesh, problem, ba_config),
            "matches": pipe.match_all_pairs(features, config, verbose=False, mesh=mesh),
            "pose": pose_cameras(pose)}


def rank_world3(mesh, problem, ba_config, tk_args):
    """Everything the world-size-3 tests read: the sharded BA (its tracks
    padded to a multiple of 3) and the sharded TK (its 241 hypotheses
    padded to 243)."""
    return {"ba": sharded_ba(mesh, problem, ba_config), "tk": sharded_tk(mesh, **tk_args)}
