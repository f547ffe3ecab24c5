"""The multi-device dry run (the JAX package's __graft_entry__.dryrun_multichip,
the port's parallel/dryrun.py): one reconstruction from rendered images
through the sharded matching and pose estimation, on 2 devices of each
package (conftest's virtual CPU devices for JAX, two gloo ranks for the
port).

Both render the same 6 views; their RANSAC draws come from different
generators, so the comparison is of outcomes: the same matched pairs and
placed cameras, track counts within 10% (a pair's inliers near the RANSAC
threshold move with the draws), both under the function's own 5 degree bar,
and the two ranks' cameras bit for bit alike."""

import re

import numpy as np
import torch

from tests.torch_port_helpers import spawn_ranks

import __graft_entry__ as jentry


def test_dryrun_multichip_over_two_gloo_ranks_matches_jax(tmp_path, capsys):
    jentry.dryrun_multichip(2)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    m = re.search(r"(\d+) matched pairs .* (\d+) tracks, (\d+) cameras placed; mean angular "
                  r"error ([0-9.]+) deg", line)
    assert m, line
    pairs, tracks, placed, err = int(m[1]), int(m[2]), int(m[3]), float(m[4])

    ranks = spawn_ranks("dryrun", 2, tmp_path, timeout=240.0)
    for got in ranks:
        assert got["ranks"] == 2
        assert got["pairs"] == pairs and got["placed"] == placed == 6
        assert abs(got["tracks"] - tracks) <= 0.1 * tracks, (got["tracks"], tracks)
        assert got["mean_angular_error_deg"] < 5.0 and err < 5.0
    assert torch.equal(ranks[0]["rot"], ranks[1]["rot"])
    assert np.isfinite(ranks[0]["rot"].numpy()).all()
