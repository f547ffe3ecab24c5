"""The one generator of jobs: a configuration and a traffic mix, read from
their files, and a seed give the list of inputs that the window cycles
through.

A mix names its `generator`:

- "synthetic_tracks": every combination of `clouds` x `solvers` x
  `noise_px_slots` x `copies`, each with its own ring of `views` cameras
  and its own noise. The whole noise levels of `noise_px_range` [lo, hi]
  are drawn evenly: the slots of all the pairs of cloud and solver take N
  levels spaced (hi - lo + 1) / N apart from one offset drawn by the seed,
  each pair one level in each N-th of the range (which pair takes which
  level in it, the seed draws). So each level is as likely as any other, as
  in upstream's sweep (one run a level), and every seed runs the same
  spread of noise.
- "rendered_images": `copies` scenes of `views` views of `width` pixels
  square, each with its own texture and ring, written as PNG files.

The list is shuffled by the seed: every seed runs the same sizes, in
another order.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

from sfm_bench.inputs import render, synthetic


@dataclasses.dataclass
class Input:
    name: str
    solver: str
    program_seed: int  # the RANSAC seed handed to the program
    gt_R: np.ndarray  # (V, 3, 3) true local->world bases
    wh: np.ndarray  # (V, 2)
    noise_px: Optional[float]
    obs: Optional[np.ndarray] = None  # (T, V, 2) float32: tracks handed over
    image_folder: str = ""  # images handed over
    key: str = ""  # inputs with one key share their shapes (one warm-up each)


def _child_seeds(seed: int, n: int) -> List[int]:
    return [int(s.generate_state(1, np.uint32)[0])
            for s in np.random.SeedSequence(seed).spawn(n)]


def noise_levels(mix: dict, seed: int) -> np.ndarray:
    """(pairs, slots) whole noise levels in pixels, pairs in the order of
    clouds x solvers: evenly over `noise_px_range`, from the seed."""
    lo, hi = mix["noise_px_range"]
    pairs, slots = len(mix["clouds"]) * len(mix["solvers"]), mix["noise_px_slots"]
    rng = np.random.default_rng(seed)
    offset = rng.random()
    pos = np.stack([rng.permutation(pairs) for _ in range(slots)], 1) + np.arange(slots) * pairs
    return lo + np.floor((pos + offset) * (hi - lo + 1) / (pairs * slots))


def synthetic_tracks(mix: dict, seed: int) -> List[Input]:
    pairs = [(c, s) for c in mix["clouds"] for s in mix["solvers"]]
    combos = [(c, s, k, m) for k, (c, s) in enumerate(pairs)
              for m in range(mix["noise_px_slots"]) for _ in range(mix.get("copies", 1))]
    *seeds, level_seed = _child_seeds(seed, len(combos) + 1)
    levels = noise_levels(mix, level_seed)
    out = []
    width, height = mix["image_size_px"]
    for (cloud, solver, k, m), s in zip(combos, seeds):
        rng = np.random.default_rng(s)
        noise = float(levels[k, m])
        pts = synthetic.cloud(cloud, s)
        angles = synthetic.ring_angles(mix["views"], s, mix["theta_range_deg"],
                                       mix["roll_range_deg"], mix.get("ring_degrees", 360.0))
        obs, R = synthetic.project_cloud(pts, angles, width, height)
        obs = synthetic.add_noise(obs, noise, rng, mix.get("noise_frequency", 1.0))
        out.append(Input(name=f"{cloud['name']}/{solver}/{noise:g}px", solver=solver,
                         program_seed=s % (2**31), gt_R=R,
                         wh=np.tile([[width, height]], (mix["views"], 1)).astype(np.float64),
                         noise_px=noise, obs=obs, key=f"{cloud['name']}/{solver}"))
    return out


def rendered_images(mix: dict, seed: int, workdir: str, device) -> List[Input]:
    from PIL import Image

    out = []
    n, w = mix["views"], mix["width"]
    for k, s in enumerate(_child_seeds(seed, mix["copies"])):
        rng = np.random.default_rng(s)
        angles = render.circle_angles(n, mix["ring_degrees"], mix["theta_range_deg"],
                                      mix["roll_range_deg"], rng)
        tex = render.FourierTexture3D(seed=int(rng.integers(2**31)))
        images, R = render.render_sphere(angles, w, w, tex, mix.get("radius", 0.75), device)
        folder = os.path.join(workdir, f"scene_{k}")
        os.makedirs(folder, exist_ok=True)
        for i, img in enumerate(images.cpu().numpy()):
            Image.fromarray(img).save(os.path.join(folder, f"view_{i:02d}.png"),
                                      compress_level=1)
        for solver in mix["solvers"]:
            out.append(Input(name=f"scene_{k}/{solver}", solver=solver,
                             program_seed=s % (2**31), gt_R=R,
                             wh=np.full((n, 2), float(w)), noise_px=0.0,
                             image_folder=folder, key=solver))
    return out


def make_inputs(mix: dict, seed: int, workdir: str, device) -> List[Input]:
    gen = mix["generator"]
    if gen == "synthetic_tracks":
        inputs = synthetic_tracks(mix, seed)
    elif gen == "rendered_images":
        inputs = rendered_images(mix, seed, workdir, device)
    else:
        raise ValueError(f"unknown generator {gen!r}")
    order = np.random.default_rng(np.random.SeedSequence([seed, 1])).permutation(len(inputs))
    return [inputs[i] for i in order]
