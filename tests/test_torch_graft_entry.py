"""The single-device entry point (orthosfm_torch/entry.py) against the
JAX system's __graft_entry__.entry(), on the CPU.

The JAX fn runs on its own example_args (XLA on the CPU); the port's fn runs
on the same arrays, and again on its own example_args, which first must
equal JAX's to the bench problem's tolerances (tests/test_torch_bench.py).
The bars are tests/test_torch_ba.py's for one LM step: initial cost 1e-5
relative, rotations 1e-4 relative / 2e-6 absolute, points 1e-3 / 1e-5,
and both solves run the same iterations. The final cost is held to 1e-3
relative beside an absolute floor: after 5 iterations both solves sit at
the f32 floor of the cost (measured: 4.8e-5 JAX, 4.5e-5 and 5.1e-5 the
port, from 96 636), where every residual is the rounding of a pixel
coordinate below 2048 (half an f32 ulp there, 1.2e-4 px), so the two sum
orders part by tens of percent. The floor is that rounding on every
observation, 0.5 * 2 * n_obs * (1.2e-4)^2 (4.9e-4 at 32 768
observations), and both costs must lie under it.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from tests.torch_port_helpers import n, t

from orthosfm_torch import entry as entry_mod
from orthosfm_torch.config import BundleAdjustConfig
from orthosfm_torch.core import cameras as cam_mod
from orthosfm_torch.solvers import ba


@pytest.fixture(scope="module")
def jax_run():
    """The JAX fn on its example_args, and the same solve's initial cost
    and iterations (solvers.ba.run with entry()'s config)."""
    from orthosfm_tpu.config import BundleAdjustConfig as JBAConfig
    from orthosfm_tpu.solvers import ba as jba

    fn, args = jentry.entry()
    out = [np.asarray(x) for x in fn(*args)]
    full = jba.run(*args, optimize_points=True,
                   config=JBAConfig(max_iterations=entry_mod.MAX_ITERATIONS))
    return args, out, float(full.initial_cost), int(full.iterations)


def _cost_floor(mask):
    half_ulp = float(np.spacing(np.float32(entry_mod.WIDTH))) / 2
    return 0.5 * 2 * int(n(mask).sum()) * half_ulp ** 2


def _hold(got, args, jax_run):
    """The port's fn output and its solve on `args` against JAX's."""
    _, (j_cost, j_rot, j_points), j_init, j_iters = jax_run
    cost, rot, points = got
    full = ba.run(*args, True, BundleAdjustConfig(max_iterations=entry_mod.MAX_ITERATIONS))
    np.testing.assert_allclose(float(full.initial_cost), j_init, rtol=1e-5)
    assert int(full.iterations) == j_iters == entry_mod.MAX_ITERATIONS
    floor = _cost_floor(args[3])
    assert 0.0 < float(cost) < floor and 0.0 < float(j_cost) < floor, (float(cost), j_cost)
    np.testing.assert_allclose(float(cost), float(j_cost), rtol=1e-3, atol=floor)
    np.testing.assert_allclose(n(rot), j_rot, rtol=1e-4, atol=2e-6)
    np.testing.assert_allclose(n(points), j_points, rtol=1e-3, atol=1e-5)


def test_entry_on_the_jax_arrays_is_the_jax_entry(jax_run):
    jargs = jax_run[0]
    fn, _ = entry_mod.entry("cpu")
    args = (cam_mod.from_numpy(jargs[0]), t(jargs[1]), t(jargs[2]), t(jargs[3]))
    _hold(fn(*args), args, jax_run)


def test_entry_on_its_own_example_args_is_the_jax_entry(jax_run):
    jargs = jax_run[0]
    fn, args = entry_mod.entry("cpu")
    cams, points, obs, mask = args
    assert (len(cams), points.shape[0]) == (entry_mod.N_VIEWS, entry_mod.N_POINTS) == (16, 2048)
    assert cams.kind == "quat" and points.device.type == "cpu"
    np.testing.assert_allclose(n(cams.rot), n(jargs[0].rot), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(n(cams.fixed), n(jargs[0].fixed))
    np.testing.assert_allclose(n(points), n(jargs[1]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(n(obs), n(jargs[2]), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(n(mask), n(jargs[3]))
    _hold(fn(*args), args, jax_run)


def test_entry_is_a_plain_function_of_its_args():
    """fn takes the four example arguments and returns (cost, rot, points);
    a second call gives the same bits; impl="torch" is the plain route,
    which is "auto" on the CPU; entry() runs on CUDA unless asked."""
    fn, args = entry_mod.entry("cpu")
    a, b = fn(*args), fn(*args)
    assert len(a) == 3 and a[1].shape == (16, 4) and a[2].shape == (2048, 4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    plain, _ = entry_mod.entry("cpu", impl="torch")
    assert all(torch.equal(x, y) for x, y in zip(a, plain(*args)))


def test_entry_runs_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        entry_mod.entry()
