#!/usr/bin/env python3
"""Times the port's pose estimation of several source trees in turns, on one
GPU, stage by stage, at chip_smoke.py's phase 9 (64 views x 50 000 tracks)
and phase 11 (192 views x 4096 tracks), both at 1 px of noise, seed 0.

    python3 scripts/torch_scale_turns.py TREE [TREE ...] [--runs N] [--json OUT]

Each TREE is a checkout of this repository (for example the parent commit
unpacked with `git archive` into a directory that .gitignore lists, then
`.`, `.`, and the parent again). Every tree runs in a process of its own
(scripts/torch_turns.py), which imports that tree's
orthosfm_torch.testbench.scale_demo, builds its kernels from its own csrc/
and runs run_scale_demo at both shapes: N timed reconstructions (the first
cold) and one more under utils.profiling.collect_stages, whose stages each
end in a device barrier. Prints one JSON line per tree and a table of every
stage of every turn; needs CUDA.
"""

import argparse
import json
import os
import sys

import torch_turns

SHAPES = {"phase9": (64, 50000), "phase11": (192, 4096)}
NOISE_PX = 1.0
STAGES = ("pose/grouping", "pose/tk", "pose/filters", "pose/local_ba", "pose/merge",
          "pose/global_ba")


def time_tree(tree, runs):
    """Runs in the child process: both shapes on `tree`."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from orthosfm_torch.testbench import scale_demo

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    out = {"tree": tree, "device": torch.cuda.get_device_name(0)}
    for phase, (views, tracks) in SHAPES.items():
        r = scale_demo.run_scale_demo(views, tracks, noise_px=NOISE_PX, runs=runs)
        out[phase] = {k: r[k] for k in ("wall_s_runs", "staged_wall_s", "stages_s",
                                        "views_placed", "mean_angular_error_deg",
                                        "max_angular_error_deg", "build_s")}
    print(json.dumps(out))


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trees", nargs="*")
    p.add_argument("--runs", type=int, default=2, help="timed runs a shape, the first cold")
    p.add_argument("--json", default="")
    p.add_argument("--one", default="", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.one:
        time_tree(args.one, args.runs)
        return 0
    if not args.trees:
        p.error("give at least one TREE")
    card = torch_turns.card()
    print(card)
    turns = torch_turns.run_turns(__file__, args.trees, ["--runs", str(args.runs)], timeout=1500)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"nvidia_smi": card, "turns": turns}, f, indent=1)
    for phase in SHAPES:
        print(f"== {phase}: seconds under the stage barriers")
        print(f"{'turn':4s} {'tree':24s} {'staged':>8s} {'warm':>8s} "
              + " ".join(f"{s.split('/')[1]:>10s}" for s in STAGES))
        for i, r in enumerate(turns):
            t = r[phase]
            print(f"{i + 1:<4d} {r['tree']:24s} {t['staged_wall_s']:8.3f} {t['wall_s_runs'][-1]:8.3f} "
                  + " ".join(f"{t['stages_s'].get(s, 0.0):10.3f}" for s in STAGES))
    return 0


if __name__ == "__main__":
    sys.exit(main())
