#!/usr/bin/env python3
"""Times the port's BA kernels K1 (schur_assemble), K3 (camera_solve) and
K2 (point_update_cost with the LM accept rule) of several source trees in
turns, on one GPU.

    python3 scripts/torch_ba_kernel_turns.py TREE [TREE ...] [--json OUT]

Each TREE is a checkout of this repository (for example the parent commit
unpacked with `git archive` into a directory that .gitignore lists, then
`.`, `.`, and the parent again). Every tree runs in a process of its own,
which imports that tree's orthosfm_torch, builds its kernels from its own
csrc/ and times them with CUDA events (mean over many launches) at the
three shapes of the main path: 3 views x 7800 tracks (the local BA,
n = 18), 16 x 8192 (the global BA and make_problem(), n = 96) and
64 x 4096 (n = 384), quaternion cameras, points optimized, lambda 1e-3.
It also times torch.linalg.solve_ex alone on the same prepared system. K2
is timed with the accept of an LM step: in a tree whose K2 carries the
accept rule in its last CTA (PointUpdateCost), one launch, and also without
that tail; in an older tree, its K2 then its K4 (lm_accept, which copies
the accepted step), and K2 alone. Prints one JSON line per tree and a
table; needs CUDA.
"""

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys

SHAPES = ((3, 7800), (16, 8192), (64, 4096))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """This checkout's chip_smoke module (for its timer), whichever tree is
    being timed."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _stage_calls(bk, pT, obsT, maskT, rot, camp, free, state):
    """(K1, K3, K2 with the accept of a step that lowers the cost, K2 without
    it, the plain Schur system (S, dU, rhs)) as calls of `bk`, whichever tree
    it comes from: a tree with PointUpdateCost takes the points and cameras
    as LM buffers (K3 writes its candidate cameras into half 1, where K2
    reads them and K1 does not), an older one as single tensors."""
    import torch

    cfg = bk.LMConfig(1e-4, 1e-6, 4.0, 0.5, 1e-12, 1e8)
    s_in = state.clone()
    s_in[bk.COST] = 1e30
    s_out = torch.zeros_like(s_in)
    if hasattr(bk, "PointUpdateCost"):
        p2, r2, c2 = bk.lm_buffers(pT, rot, camp)
        args = ("quat", p2, obsT, maskT, r2, c2, free, state, 1.0, True)
        S, dU, rhs = bk.normal_eq_schur_ref(*args)
        sargs = ("quat", S, dU, rhs, free, state, r2, c2)
        delta = bk.camera_solve_ref(*sargs)
        stage = bk.PointUpdateCost("quat", p2, obsT, maskT, r2, c2, free, 1.0, True, cfg)
        return ((lambda: bk.schur_assemble(*args)), (lambda: bk.camera_solve(*sargs)),
                (lambda: stage(s_in, s_out, delta)), (lambda: stage(s_in, None, delta)),
                (S, dU, rhs))
    args = ("quat", pT, obsT, maskT, rot, camp, free, state, 1.0, True)
    S, dU, rhs = bk.normal_eq_schur_ref(*args)
    sargs = ("quat", S, dU, rhs, free, state, rot, camp)
    delta, rot_c, camp_c = bk.camera_solve_ref(*sargs)
    uargs = ("quat", pT, obsT, maskT, rot, camp, free, state, delta, rot_c, camp_c, 1.0, True)
    r_, c_, p_ = rot.clone(), camp.clone(), pT.clone()

    def k2_k4():
        p_new, parts = bk.point_update_cost(*uargs)
        bk.lm_accept(parts, s_in, s_out, r_, c_, p_, rot_c, camp_c, p_new, cfg)

    return ((lambda: bk.schur_assemble(*args)), (lambda: bk.camera_solve(*sargs)), k2_k4,
            (lambda: bk.point_update_cost(*uargs)), (S, dU, rhs))


def time_tree(tree):
    """Runs in the child process: the kernels of `tree` at every shape."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from orthosfm_torch.core import cameras as cam_mod
    from orthosfm_torch.solvers import ba
    from orthosfm_torch.solvers import ba_kernels as bk
    from orthosfm_torch.testbench.problems import make_problem

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda:0")
    bk.library()
    cuda_ms = _smoke().cuda_ms

    def profile(fn, n):
        """Device microseconds per call of each kernel fn launches
        (torch.profiler), or {} where the profiler sees no device time."""
        from torch.profiler import ProfilerActivity, profile as prof

        fn()
        torch.cuda.synchronize()
        with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        times = {}
        for e in p.key_averages():
            us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
            name = re.search(r"(\w+_kernel(<\w+>)?)", e.key)
            if us > 0 and name:
                times[name.group(1)] = times.get(name.group(1), 0.0) + us / n
        return times

    out = {"tree": tree, "source": os.path.relpath(bk.SOURCE, os.path.abspath(tree))}
    for V, T in SHAPES:
        cams, points, obs, mask = make_problem("quat", dev, V, T, 2048.0)
        pT, obsT, maskT = ba.prepare(points, obs, mask)
        free = cam_mod.free_mask(cams).float().contiguous()
        rot, camp = cams.rot.contiguous(), ba.pack_camp(cams)
        state = bk.new_state(1e-3, dev)
        k1, k3, k2, k2_alone, (S, dU, rhs) = _stage_calls(bk, pT, obsT, maskT, rot, camp, free,
                                                          state)
        # the prepared system of ba.prepare_camera_system, written out: older
        # trees do not have that function
        S_f = S + torch.diag(1e-3 * torch.clamp(dU, min=1e-8))
        fm = free.reshape(-1)
        S_f = S_f * fm[:, None] * fm[None, :] + torch.diag(1.0 - fm)
        d = torch.sqrt(torch.clamp(torch.abs(torch.diagonal(S_f)), min=1e-12))
        S_s, b = S_f / d[:, None] / d[None, :], rhs * fm / d
        n = 50 if V <= 16 else 20
        out[f"{V}x{T}"] = {
            "schur_assemble_ms": cuda_ms(k1, n),
            "camera_solve_ms": cuda_ms(k3, n),
            "solve_ex_ms": cuda_ms(lambda: torch.linalg.solve_ex(S_s, b), n),
            "point_update_cost_ms": cuda_ms(k2, n),
            "point_update_cost_no_tail_ms": cuda_ms(k2_alone, n),
            "device_us_per_call": profile(lambda: (k1(), k3(), k2()), 10),
        }
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trees", nargs="+")
    p.add_argument("--json", default="")
    p.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.one:
        time_tree(args.trees[0])
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    runs = []
    for tree in args.trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for V, T in SHAPES:
        key = f"{V}x{T}"
        for r in runs:
            t = r[key]
            print(f"{key:8s} {r['tree']:24s} K1 {t['schur_assemble_ms']:.4f} ms   "
                  f"K3 {t['camera_solve_ms']:.4f} ms   solve_ex {t['solve_ex_ms']:.4f} ms   "
                  f"K2 + accept {t['point_update_cost_ms']:.4f} ms   "
                  f"K2 alone {t['point_update_cost_no_tail_ms']:.4f} ms")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"nvidia_smi": smi.stdout.strip(), "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
