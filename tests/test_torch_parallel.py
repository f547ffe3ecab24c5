"""The port's multi-device path (orthosfm_torch/parallel/, MeshRunners, the
mesh= arguments and the CLI's --devices) on the CPU: ranks over gloo, each
a process of its own (tests/torch_port_helpers.spawn_ranks, killed after
120 s), against one device and against the JAX package's sharded functions
on the 8 virtual devices tests/conftest.py provides.

Tolerances: the sharded BA sums the camera system and the cost over the
ranks in another order than one device does, so it lands on the same
optimum, not the same bits: quaternion |dot| within 1e-4 of 1 and a cost
below 1e-3 of the initial one, as tests/test_parallel.py holds the JAX
package's. TK, matching: each rank scores or matches its share of the
hypotheses or pairs with the draws of one device, so TK agrees to 1e-6 and
the matches exactly.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.torch_port_helpers import n, spawn_ranks, t
from tests.test_parallel import _problem as _jax_problem

from orthosfm_tpu.parallel import ba_sharded as jba_sharded
from orthosfm_tpu.parallel import mesh as jmesh

from orthosfm_torch import app
from orthosfm_torch.config import BundleAdjustConfig, RansacConfig, ReconstructionConfig
from orthosfm_torch.core import cameras as cam_mod
from orthosfm_torch.core import quaternions as quat
from orthosfm_torch.data import synthetic
from orthosfm_torch.data.views import View
from orthosfm_torch.io import cameras_io, tracks_io
from orthosfm_torch.parallel import ba_sharded, matching_sharded, mesh as mesh_mod
from orthosfm_torch.pipeline import incremental
from orthosfm_torch.pipeline import matching as pipe
from orthosfm_torch.solvers import ba
from orthosfm_torch.solvers import ba_kernels as bk
from orthosfm_torch.solvers import tomasi_kanade as tk
from orthosfm_torch.testbench import render

ROOT = pathlib.Path(__file__).resolve().parents[1]
BA_CONFIG = BundleAdjustConfig()
TK_SEED = 7


@pytest.fixture(scope="module")
def problem():
    """tests/test_parallel.py's BA problem (6 views, 256 sphere tracks,
    perturbed quaternion cameras, camera 0 fixed): JAX's arrays and the
    port's CPU tensors of the same values."""
    cams, pts, obs, mask = _jax_problem()
    return (cams, pts, obs, mask), (cam_mod.from_numpy(cams), t(pts), t(obs), t(mask))


@pytest.fixture(scope="module")
def features():
    """The port's SIFT + SURF features of 3 rendered sphere views at 160²
    (test_torch_frontend.py's scene), on the CPU."""
    _, images, _ = render.make_scene_views(3, 160, 160, seed=3, ring_degrees=60.0,
                                          device="cpu")
    views = [View(i, f"view_{i:02d}.png", 160, 160, pixels=im.numpy())
             for i, im in enumerate(images)]
    return views, pipe.extract_all_view_features(views, ReconstructionConfig(), "cpu")


@pytest.fixture(scope="module")
def tracks():
    """6 views of a 300-point blob with 1 px noise, on the CPU."""
    ds = synthetic.generate_dataset(synthetic.blob_cloud(300), num_views=6, seed=0,
                                    device="cpu")
    return synthetic.add_observation_noise(ds.tracks, 1.0, np.random.default_rng(4))


def _tk_inputs():
    ds = synthetic.generate_dataset(synthetic.sphere_cloud(200), num_views=6, seed=5,
                                    device="cpu")
    cols = torch.tensor([0, 1, 2])
    obs = ds.tracks.obs[:, cols].contiguous()
    valid = ds.tracks.alive & torch.all(ds.tracks.obs_mask[:, cols], dim=1)
    return {"obs": obs, "valid": valid, "seed": TK_SEED, "cfg": RansacConfig()}


@pytest.fixture(scope="module")
def ranks(problem, features, tracks, tmp_path_factory):
    """The results of every rank at world sizes 2 and 3 (one spawn each)."""
    work = tmp_path_factory.mktemp("ranks")
    wh = np.full(6, 2048.0, np.float32)
    world2 = spawn_ranks("world2", 2, work, problem=problem[1], ba_config=BA_CONFIG,
                         features=features[1], config=ReconstructionConfig(), tracks=tracks,
                         wh=wh)
    world3 = spawn_ranks("world3", 3, work, problem=problem[1], ba_config=BA_CONFIG,
                         tk_args=_tk_inputs())
    return {2: world2, 3: world3}


@pytest.fixture(scope="module")
def one_device_ba(problem):
    cams, points, obs, mask = problem[1]
    return ba.run(cams, points, obs, mask, True, BA_CONFIG)


@pytest.fixture(scope="module")
def jax_sharded_ba(problem):
    cams, pts, obs, mask = problem[0]
    run = jba_sharded.make_sharded_ba(jmesh.make_mesh(8))
    (pts_p, obs_p, mask_p), _ = jba_sharded.pad_tracks([pts, obs, mask], 8)
    return run(cams, pts_p, obs_p, mask_p)


def _same_optimum(res, rot_ref):
    assert res["cost"] < res["initial_cost"] * 1e-3
    q = n(quat.normalize(res["rot"]))
    q_ref = n(quat.normalize(torch.as_tensor(np.array(rot_ref))))
    np.testing.assert_allclose(np.abs(np.sum(q * q_ref, axis=-1)), 1.0, atol=1e-4)


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_ba_matches_one_device(ranks, one_device_ba, world):
    for res in ranks[world]:
        _same_optimum(res["ba"], n(one_device_ba.cams.rot))
        np.testing.assert_allclose(res["ba"]["initial_cost"], float(one_device_ba.initial_cost),
                                   rtol=1e-5)


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_ba_matches_the_jax_sharded_ba(ranks, jax_sharded_ba, world):
    for res in ranks[world]:
        _same_optimum(res["ba"], jax_sharded_ba.cams.rot)


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_ba_ranks_agree_bit_for_bit(ranks, problem, world):
    """The replicated control flow: every rank ends with the same cameras,
    cost and iterations, and the gathered points of every track."""
    first = ranks[world][0]["ba"]
    assert first["points"].shape == problem[1][1].shape
    for res in ranks[world][1:]:
        for key in ("rot", "offset", "scale", "points"):
            assert torch.equal(res["ba"][key], first[key]), key
        assert res["ba"]["cost"] == first["cost"]
        assert res["ba"]["iterations"] == first["iterations"]


def test_sharded_ba_of_one_device_is_ba_run(problem, one_device_ba):
    """A mesh of one device and no group: the sharded loop (K2 in split
    mode, then lm_accept) gives ba.run's bits."""
    cams, points, obs, mask = problem[1]
    m = mesh_mod.make_mesh(1, device="cpu")
    padded, T = ba_sharded.pad_tracks([points, obs, mask], 1)
    res = ba_sharded.make_sharded_ba(m, True, BA_CONFIG)(
        cams, *ba_sharded.shard_track_arrays(m, padded))
    assert torch.equal(res.cams.rot, one_device_ba.cams.rot)
    assert torch.equal(res.points, one_device_ba.points)
    assert float(res.cost) == float(one_device_ba.cost)
    assert int(res.iterations) == int(one_device_ba.iterations)


def test_sharded_tk_matches_unsharded(ranks):
    """241 hypotheses over 3 ranks (padded to 243, the copies masked to
    −inf) against robust_factorization on the same draws."""
    args = _tk_inputs()
    gen = torch.Generator().manual_seed(args["seed"])
    ref = tk.robust_factorization(args["obs"], args["valid"], 2048.0, 2048.0, args["cfg"],
                                  generator=gen)
    for got in (r["tk"] for r in ranks[3]):
        assert bool(got["found"]) == bool(ref.found)
        assert int(got["num_inliers"]) == int(ref.num_inliers)
        np.testing.assert_allclose(n(got["model1"]), n(ref.model1), rtol=0, atol=1e-6)
        np.testing.assert_allclose(n(got["model2"]), n(ref.model2), rtol=0, atol=1e-6)


def test_sharded_matching_matches_one_device(ranks, features):
    """match_all_pairs(mesh=) over 2 ranks (3 pairs, padded to 4): the
    matches and the tracks of one device, exactly."""
    views, feats = features
    ref = pipe.match_all_pairs(feats, ReconstructionConfig(), verbose=False)
    assert ref
    for got in (r["matches"] for r in ranks[2]):
        assert [(i, j) for i, j, _, _ in got] == [(i, j) for i, j, _, _ in ref]
        for (_, _, a1, b1), (_, _, a2, b2) in zip(ref, got):
            np.testing.assert_array_equal(a1, a2)
            np.testing.assert_array_equal(b1, b2)
        t_ref = pipe.tracks_from_matches(views, feats, ref, device="cpu")
        t_got = pipe.tracks_from_matches(views, feats, got, device="cpu")
        for name in ("obs", "obs_mask", "alive", "global_ids"):
            assert torch.equal(getattr(t_ref, name), getattr(t_got, name)), name


def test_sharded_pose_estimation_matches_one_device(ranks, tracks):
    """run_pose_estimation(mesh=) over 2 ranks: every view placed in the
    same order, the cameras at the one-device optimum."""
    wh = np.full(6, 2048.0, np.float32)
    ref = incremental.run_pose_estimation(tracks, wh, wh, ReconstructionConfig(), verbose=False)
    for got in (r["pose"] for r in ranks[2]):
        assert got["present"].all() and got["order"] == list(ref.insertion_order)
        q = n(quat.normalize(got["rot"]))
        q_ref = n(quat.normalize(ref.cameras.rot))
        np.testing.assert_allclose(np.abs(np.sum(q * q_ref, axis=-1)), 1.0, atol=1e-4)
        np.testing.assert_allclose(n(got["offset"]), n(ref.cameras.offset), atol=1e-3)


def test_cli_devices_writes_the_cameras_of_one_device(tmp_path):
    """python -m orthosfm_torch.app ... --devices 2 --platform cpu (two gloo
    ranks, only rank 0 writing) writes the cameras.txt of --devices 1: six
    blank 256² views and the perfect tracks of a 300-point blob seen at
    256²."""
    from PIL import Image

    images = tmp_path / "images"
    images.mkdir()
    for i in range(6):
        Image.new("RGB", (256, 256)).save(images / f"view_{i:02d}.png")
    ds = synthetic.generate_dataset(synthetic.blob_cloud(300), num_views=6, width=256,
                                    height=256, seed=0, device="cpu")
    track_file = str(tmp_path / "tracks.txt")
    tracks_io.save_tracks(ds.tracks, track_file)
    texts = []
    for devices in (1, 2):
        proj = tmp_path / f"project{devices}"
        argv = [str(proj), str(images), "--calculated-tracks", track_file, "--platform", "cpu",
                "--devices", str(devices)]
        if devices == 1:
            assert app.main(argv) == 0
        else:
            proc = subprocess.run([sys.executable, "-m", "orthosfm_torch.app", *argv], cwd=ROOT,
                                  capture_output=True, text=True, timeout=120)
            assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        texts.append((proj / "cameras.txt").read_text())
    assert len(texts[0].splitlines()) == 6
    names = [[line.split(";")[0] for line in text.splitlines()] for text in texts]
    assert names[0] == names[1]
    a, b = (np.stack([c.transform for c in cameras_io.import_cameras(str(proj / "cameras.txt"))])
            for proj in (tmp_path / "project1", tmp_path / "project2"))
    # to the printed digits (6 decimals), as far as f32 allows: the two sum
    # the camera system over the ranks in different orders, so a number may
    # move by its f32 rounding (~1e-7 of its size: 1e-6 at the cameras'
    # distance of 10) plus one unit of its last digit
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_cli_devices_needs_that_many_cards(monkeypatch):
    """--devices N on CUDA needs N cards (as the JAX CLI needs N devices)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--devices 2 needs 2 CUDA devices; 1 present"):
        app.check_ranks(torch.device("cuda"), 2)
    app.check_ranks(torch.device("cuda"), 1)
    app.check_ranks(torch.device("cpu"), 4)
    with pytest.raises(ValueError):
        app.check_ranks(torch.device("cpu"), 0)


def test_split_k2_then_lm_accept_equals_the_folded_tail(problem):
    """K2's split mode (the shard's cost, no rule) followed by lm_accept (K4,
    here its plain version lm_accept_state_ref over lm_accept_ref) writes
    the state point_update_accept_ref writes, for the initial cost and for
    an accepted and a rejected step."""
    cams, points, obs, mask = problem[1]
    pT, obsT, maskT = ba.prepare(points, obs, mask)
    free = cam_mod.free_mask(cams).float().contiguous()
    cfg = bk.LMConfig.of(BA_CONFIG)
    states, bufs = [], []
    for split in (False, True):
        p2, r2, c2 = bk.lm_buffers(pT, cams.rot.contiguous(), ba.pack_camp(cams))
        st = torch.zeros((4, bk.STATE_SIZE))
        k2 = bk.PointUpdateCost(cams.kind, p2, obsT, maskT, r2, c2, free, 1.0, True, cfg,
                                split=split)
        if split:
            bk.lm_accept(k2(None, None), None, st[0], cfg)
        else:
            k2(None, st[0])
        S, dU, rhs = bk.schur_assemble(cams.kind, p2, obsT, maskT, r2, c2, free, st[0], 1.0, True)
        delta = bk.camera_solve(cams.kind, S, dU, rhs, free, st[0], r2, c2)
        st[1] = st[0]
        st[1, bk.COST] = 1e-9  # a step that cannot lower the cost: rejected
        for s_in, s_out in ((st[0], st[2]), (st[1], st[3])):
            if split:
                bk.lm_accept(k2(s_in, None, delta), s_in, s_out, cfg)
            else:
                k2(s_in, s_out, delta)
        states.append(st)
        bufs.append((p2, r2, c2))
    assert torch.equal(states[0], states[1])
    assert states[0][2, bk.CUR] == 1.0 and states[0][3, bk.CUR] == 0.0
    for a, b in zip(*bufs):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="split mode"):
        k2(st[0], st[1], delta)


def test_single_device_mesh_and_pair_padding():
    """A mesh of one device with no group passes tensors through; the pair
    axis pads to the world size with zeros and run_over_pairs cuts the
    padding off again."""
    m = mesh_mod.make_mesh(1, device="cpu")
    assert (m.rank, m.size, m.device.type, m.axis) == (0, 1, "cpu", mesh_mod.TRACK_AXIS)
    x = torch.arange(5.0)
    assert torch.equal(m.all_reduce(x.clone()), x) and torch.equal(m.all_gather(x), x)
    padded, p0 = matching_sharded.pad_pair_axis([x, torch.ones(5, 2, dtype=torch.bool)], 4)
    assert p0 == 5 and padded[0].shape == (8,) and not padded[1][5:].any()
    assert torch.equal(matching_sharded.run_over_pairs(m, lambda a: a * 2, x), 2 * x)
    assert mesh_mod.pad_to_multiple(241, 3) == 243
    (p,), T = ba_sharded.pad_tracks([torch.ones(5, 4)], 3)
    assert T == 5 and p.shape == (6, 4) and not p[5].any()
    with pytest.raises(RuntimeError, match="process group"):
        mesh_mod.make_mesh(2)


def test_parallel_modules_import_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "orthosfm_torch" / "parallel").glob("*.py"))
    assert {f.name for f in files} >= {"mesh.py", "ba_sharded.py", "tk_sharded.py",
                                       "matching_sharded.py"}
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "orthosfm_tpu"), (path, name)
