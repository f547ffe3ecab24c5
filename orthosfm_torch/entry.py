"""The single-device entry point: port of the JAX system's
__graft_entry__.entry() (at the repo root).

    fn, example_args = entry()          # on CUDA; entry("cpu") on the CPU
    cost, rot, points = fn(*example_args)

entry() returns one robust Schur-LM bundle-adjustment solve, ba.run with 5
iterations at most (the main path's function tolerance), on the synthetic
16-view x 2048-track problem of __graft_entry__._make_problem
(testbench.problems.make_problem, the BA bench's problem at 2048 tracks).
fn is a plain function: the JAX package's caller jits it, and nothing
stands in for that here. On the card "auto" takes lm_fused (16 x 2048
fits), so a call is one launch of it.

__graft_entry__.dryrun_multichip's counterpart is parallel/dryrun.py.
"""

from __future__ import annotations

N_VIEWS = 16
N_POINTS = 2048
WIDTH = 2048.0
MAX_ITERATIONS = 5


def entry(device="cuda", impl: str = "auto"):
    """(fn, example_args): fn(cams, points, obs, mask) -> (cost, final
    camera rotations (V, 4), final points (T, 4)), and its example
    arguments on `device` (CUDA unless the caller names another; without a
    card CUDA raises). `impl` is BundleAdjustConfig.impl ("torch" runs the
    plain route on any device)."""
    from orthosfm_torch.config import BundleAdjustConfig
    from orthosfm_torch.solvers import ba
    from orthosfm_torch.testbench.problems import make_problem

    example_args = make_problem("quat", device, N_VIEWS, N_POINTS, WIDTH)
    config = BundleAdjustConfig(max_iterations=MAX_ITERATIONS, impl=impl)

    def fn(cams, points, obs, mask):
        res = ba.run(cams, points, obs, mask, optimize_points=True, config=config)
        return res.cost, res.cams.rot, res.points

    return fn, example_args
