"""The port's BA bench (orthosfm_torch/bench.py) against the JAX system's
bench.py, on the CPU at small sizes.

The problem is compared at 4 views x 512 tracks: both packages triangulate
in f32 in their own order, so rotations and points agree to 1e-6 and the
observations, pixels of 2048^2 images, to 1e-3 px (measured: 1.2e-7,
6.9e-7 and 1.2e-4). On CPU tensors every route runs the plain versions of
the kernels, so the timing tests check the method and its counts, not the
kernels: tests/test_torch_cuda.py checks the routes' launches on the card.
"""

import json
import pathlib
import re

import numpy as np
import pytest
import torch

import bench as jax_bench
from tests.torch_port_helpers import n

from orthosfm_torch import bench
from orthosfm_torch.core import cameras as cam_mod

# bench.py:147-153 and its extras (bench.py:121-145)
JAX_KEYS = ("metric", "value", "unit", "vs_baseline", "synced_single_call_iter_per_s",
            "sync_floor_ms", "pallas_iter_per_s", "xla_iter_per_s", "euler_iter_per_s")
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tiny():
    return bench.make_problem("cpu", 3, 256)


def test_problem_is_the_jax_benchs():
    """bench.make_problem and the Euler cameras of bench.py's Euler key,
    both packages on the CPU at 4 views x 512 tracks."""
    from orthosfm_tpu.core import cameras as jcam

    jc, jp, jo, jm = jax_bench.make_problem(num_views=4, n_points=512)
    cams, points, obs, mask = bench.make_problem("cpu", 4, 512)
    np.testing.assert_allclose(n(cams.rot), n(jc.rot), rtol=0, atol=1e-6)
    np.testing.assert_allclose(n(points), n(jp), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(n(mask), n(jm))
    np.testing.assert_allclose(n(obs), n(jo), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(n(cams.fixed), n(jc.fixed))
    assert cams.kind == "quat" and bool(cams.fixed[0]) and not bool(cams.fixed[1:].any())
    # bench.py:135-143
    je = jcam.make_euler(np.arange(len(jc.scale)), 2048.0, 2048.0,
                         angles=np.asarray(jcam.basis_to_phi_theta_roll(jcam.basis(jc))))
    je = je.replace(fixed=jc.fixed)
    e = bench.euler_cameras(cams)
    assert e.kind == "euler" and e.solver == int(je.solver)
    np.testing.assert_allclose(n(e.rot), n(je.rot), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(n(e.fixed), n(je.fixed))
    # the same rotations as the quaternion cameras
    np.testing.assert_allclose(n(cam_mod.basis(e)), n(cam_mod.basis(cams)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("impl", ["auto", "pallas", "xla"])
def test_time_ba_runs_the_benchs_method(tiny, impl):
    """A warm-up, `repeats` synced solves and `repeats` runs of `calls`
    pipelined ones, each of `iters` iterations; no kernel on CPU tensors."""
    t = bench.time_ba("cpu", *tiny, iters=2, repeats=1, impl=impl, calls=2)
    assert t.iterations == 2 and t.calls == 1 + 1 + 2
    assert len(t.pipelined) == len(t.synced) == 1
    assert t.iter_per_s == max(t.pipelined) > 0 and t.synced_iter_per_s == max(t.synced) > 0
    assert t.launches == dict.fromkeys(t.launches, 0)
    ips, iterations, synced = t[:3]  # bench.py's three numbers
    assert (ips, iterations, synced) == (t.iter_per_s, 2, t.synced_iter_per_s)


def test_time_ba_raises_when_the_warm_up_stops_early(tiny, monkeypatch):
    """The warm-up solve must run all its iterations (here a solver that
    reports one)."""
    from orthosfm_torch.solvers import ba

    real = ba.run

    def stops_early(*args, **kwargs):
        return real(*args, **kwargs)._replace(iterations=torch.tensor(1, dtype=torch.int32))

    monkeypatch.setattr(ba, "run", stops_early)
    with pytest.raises(RuntimeError, match="warm-up solve ran 1 iterations, not 2"):
        bench.time_ba("cpu", *tiny, iters=2, repeats=1, calls=1)


def test_line_has_the_jax_benchs_keys_and_the_device(monkeypatch, capsys):
    """main() prints one JSON line, built by measure() (here at 3 x 256,
    2 iterations): bench.py's keys, then `device`; vs_baseline 1.0 on the
    CPU. Every key bench.py prints is named in its source."""
    src = (ROOT / "bench.py").read_text()
    for key in JAX_KEYS:
        assert f'"{key}"' in src, key
    real = bench.measure

    def tiny_measure(device):
        return real(device, 3, 256, iters=2, repeats=1, calls=2)

    monkeypatch.setattr(bench, "measure", tiny_measure)
    assert bench.main(["--device", "cpu"]) == 0
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == [*JAX_KEYS, "device"]
    assert line["metric"] == bench.METRIC == "ba_iterations_per_s_16cam_8192trk"
    assert line["unit"] == "iter/s" and line["vs_baseline"] == 1.0 and line["device"] == "cpu"
    assert all(line[k] > 0 for k in JAX_KEYS if k.endswith("_iter_per_s") or k == "value")
    # every repeat's rates and each route's launches go to stderr
    for key in ("value", "pallas_iter_per_s", "xla_iter_per_s", "euler_iter_per_s"):
        assert re.search(rf"^{key}: {{.*\"pipelined\": \[", out.err, re.M), key


def test_measure_is_bench_py_at_its_defaults():
    """measure()'s defaults are bench.py's problem and method: 16 views x
    8192 tracks, 30 iterations, 3 repeats of 10 calls (2 on the secondary
    routes)."""
    import inspect

    sig = inspect.signature(bench.measure).parameters
    assert (sig["num_views"].default, sig["n_points"].default, sig["iters"].default,
            sig["repeats"].default, sig["calls"].default) == (16, 8192, 30, 3, 10)
    sig = inspect.signature(bench.time_ba).parameters
    assert (sig["iters"].default, sig["repeats"].default, sig["impl"].default,
            sig["calls"].default) == (30, 3, "auto", 10)


def test_main_without_a_card_raises_naming_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench.main([])
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench.main(["--device", "cuda"])
