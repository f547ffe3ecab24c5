#!/usr/bin/env python3
"""Where lm_fused's stages lose time against the same code in launches of
their own: its timing build (ba_kernels.timing_library) beside variants of
its source, each timed by kernel_bench.lm_fused_split (ms a working
iteration of each stage and of each grid barrier's own wait; 30 iterations
that all work on make_problem()):
  own_barrier      grid.sync() replaced by a barrier of its own: one arrival
                   (atom.add.acq_rel.gpu) and an ld.acquire spin on a
                   generation word;
  alone_<stage>    every other stage's body emptied, so the stage runs
                   alone in the launch (the solve's results are then wrong;
                   only the times are read);
  no_product       every stage but K1's product;
  noinline         the five stages as functions of their own (__noinline__,
                   the argument __grid_constant__);
and CTA 0's SM clock over each stage (%clock64 stamped beside %globaltimer),
the per-iteration kernels' own device time a working iteration
(torch.profiler), and the SASS size of every kernel of the main build
(cuobjdump). The variants are built from copies of the source under
orthosfm_torch/_build/variants/, never into the main path's library.

    python3 scripts/torch_lm_fused_variants.py [--json OUT]

Needs a CUDA device and the toolkit's nvcc and cuobjdump; prints the card's
name and power limit first.
"""

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SHAPES = ((16, 8192), (64, 50000))
# lm_fused's instantiation below the grid route (its mangled name), the one SHAPES run
LM_FUSED_ENTRY = "lm_fused_kernelILb0"
ITERATIONS = 30
STAGE_HEADS = {
    "blocks": "void fused_blocks(const FusedArgs& a, const float* st, float* fsm) {\n",
    "product": "void fused_product(const FusedArgs& a, float* fsm) {\n",
    "reduce": "void fused_reduce(const FusedArgs& a) {\n",
    "solve": "                                            int& s_failed, cg::grid_group& grid) {\n",
    "k2": "                                         float* fsm) {\n",
}
OWN_BARRIER = r'''
__device__ unsigned fused_bar[2];  // arrivals, generation
__device__ __forceinline__ void own_grid_sync() {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned gen, old, g;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(gen) : "l"(fused_bar + 1) : "memory");
    __threadfence();
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;" : "=r"(old) : "l"(fused_bar)
                 : "memory");
    if (old == gridDim.x - 1) {
      asm volatile("st.relaxed.gpu.global.u32 [%0], 0;" ::"l"(fused_bar) : "memory");
      asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(fused_bar + 1), "r"(gen + 1)
                   : "memory");
    } else {
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(g) : "l"(fused_bar + 1)
                     : "memory");
      } while (g == gen);
    }
  }
  __syncthreads();
}
'''


def variants(src):
    """{name: source text} of the variants."""
    for head in STAGE_HEADS.values():
        if src.count(head) != 1:
            raise RuntimeError(f"the source no longer has one {head.strip()!r}")

    def only(keep):
        out = src
        for name, head in STAGE_HEADS.items():
            if name not in keep:
                out = out.replace(head, head + "  if (a.V > 0) return;\n")
        return out

    anchor = "// CTA 0's stamp into slot `slot` (the timing build only)."
    sync = "  grid.sync();\n  fused_stamp(a, slot + 1);"
    stamp = "  if (a.stamps && blockIdx.x == 0 && threadIdx.x == 0) a.stamps[slot] = global_ns();"
    for needle in (anchor, sync, stamp, "lm_fused_kernel(const FusedArgs a)"):
        if needle not in src:
            raise RuntimeError(f"the source no longer has {needle!r}")
    noinline = src.replace("lm_fused_kernel(const FusedArgs a)",
                           "lm_fused_kernel(const __grid_constant__ FusedArgs a)")
    for name in STAGE_HEADS:
        noinline = noinline.replace(f"__device__ __forceinline__ void fused_{name}(",
                                    f"__device__ __noinline__ void fused_{name}(")
    clock = src.replace(stamp, (
        "  if (a.stamps && blockIdx.x == 0 && threadIdx.x == 0) {\n"
        "    a.stamps[slot] = global_ns();\n"
        "    a.stamps[slot + FUSED_STAMP_HEAD + FUSED_STAMP_SLOTS * a.max_iters] = clock64();\n"
        "  }"))
    return {"own_barrier": src.replace(anchor, OWN_BARRIER + anchor).replace(
                sync, "  own_grid_sync();\n  fused_stamp(a, slot + 1);"),
            "alone_blocks": only(("blocks",)), "alone_solve": only(("solve",)),
            "alone_k2": only(("k2",)), "no_product": only(("blocks", "reduce", "solve", "k2")),
            "noinline": noinline, "clock": clock}


def sass_kb(so):
    """KB of SASS of each kernel in the library `so` (16 bytes an instruction)."""
    from orthosfm_torch import kernel_build

    work = kernel_build.BUILD_DIR / "variants" / "sass"
    work.mkdir(parents=True, exist_ok=True)
    for old in work.glob("*.cubin"):
        old.unlink()
    subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-xelf", "all", str(so)], cwd=work,
                   check=True, capture_output=True)
    out = {}
    for cubin in work.glob("*.cubin"):
        text = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(cubin)],
                              check=True, capture_output=True, text=True).stdout
        name = None
        for line in text.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                k = re.search(r"\d+([a-z_0-9]+_kernel)(I[^E]*E)?", m[1])
                name = (k[1] + (k[2] or "")) if k else m[1]
                out[name] = 0
            elif name and re.match(r"\s*/\*[0-9a-f]+\*/\s+\S", line):
                out[name] += 16
    return {k: v / 1024 for k, v in sorted(out.items(), key=lambda x: -x[1])}


def clock_mhz(lib, device, num_views, n_tracks, cfg):
    """CTA 0's SM clock (MHz) over each stage and its barrier, one solve."""
    import torch

    from orthosfm_torch.solvers import ba_kernels as bk
    from orthosfm_torch.utils.kernel_bench import stage_inputs

    pT, obsT, maskT, rot, camp, free = stage_inputs("quat", device, num_views, n_tracks)
    n = bk.FUSED_STAMP_HEAD + bk.FUSED_STAMP_SLOTS * ITERATIONS
    stamps = torch.zeros((2 * n,), dtype=torch.int64, device=device)
    for _ in range(2):
        p2, r2, c2 = bk.lm_buffers(pT, rot, camp)
        stamps.zero_()
        lib.osfm_lm_fused_stamps(stamps.data_ptr())
        st = bk.lm_solve("quat", p2, obsT, maskT, r2, c2, free, 1.0, True, bk.LMConfig.of(cfg),
                         ITERATIONS, lib=lib)
    s = stamps.cpu().tolist()
    names = (*bk.FUSED_BARRIERS, "accept")
    ns, cyc = dict.fromkeys(names, 0), dict.fromkeys(names, 0)
    for it in range(int(st[bk.ITERS])):
        b = bk.FUSED_STAMP_HEAD + bk.FUSED_STAMP_SLOTS * it
        pts = [b] + [b + 2 + 2 * k for k in range(len(bk.FUSED_BARRIERS))] + [
            b + bk.FUSED_STAMP_SLOTS - 1]
        for k, name in enumerate(names):
            ns[name] += s[pts[k + 1]] - s[pts[k]]
            cyc[name] += s[n + pts[k + 1]] - s[n + pts[k]]
    return {k: 1e3 * cyc[k] / ns[k] if ns[k] else None for k in names}


def per_iteration_kernels(device, num_views, n_tracks, cfg):
    """The per-iteration route's device ms a working iteration, by kernel."""
    import torch

    from orthosfm_torch.solvers import ba
    from orthosfm_torch.testbench.problems import make_problem

    args = make_problem("quat", device, num_views, n_tracks)
    kcfg = dataclasses.replace(cfg, impl="kernel")
    ba.run(*args, True, kcfg)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        r = ba.run(*args, True, kcfg)
        torch.cuda.synchronize()
    its = int(r.iterations)
    out = {}
    for e in prof.key_averages():
        m = re.search(r"(\w+_kernel)", e.key)
        t = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
        if m and t:
            out[m[1]] = out.get(m[1], 0.0) + t / 1e3 / its
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--json", default="")
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_lm_fused_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    from orthosfm_torch import kernel_build
    from orthosfm_torch.config import BundleAdjustConfig
    from orthosfm_torch.solvers import ba_kernels as bk
    from orthosfm_torch.utils.kernel_bench import lm_fused_split

    folder = kernel_build.BUILD_DIR / "variants"
    folder.mkdir(parents=True, exist_ok=True)
    sources = {}
    for name, text in variants(bk.SOURCE.read_text()).items():
        sources[name] = folder / f"ba_{name}.cu"
        sources[name].write_text(text)
    jobs = [(bk.SOURCE, ()), (bk.SOURCE, bk.TIMING_DEFINES)] + [
        (path, bk.TIMING_DEFINES) for path in sources.values()]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: kernel_build.build(*j), jobs))
    out = {"card": smi, "sass_kb": sass_kb(built[0][0]), "ptxas": {}, "shapes": {}}
    libs = {"main": bk.timing_library()}
    for (name, path), (_, log) in zip(sources.items(), built[2:]):
        lib = kernel_build.load(path, {**bk._SIGNATURES, "osfm_lm_fused_stamps": [bk._P]},
                                bk.TIMING_DEFINES)
        libs[name] = lib
        out["ptxas"][name] = kernel_build.ptxas_usage(log, LM_FUSED_ENTRY)
    out["ptxas"]["main"] = kernel_build.ptxas_usage(built[1][1], LM_FUSED_ENTRY)
    print("SASS KB: " + ", ".join(f"{k} {v:.1f}" for k, v in list(out["sass_kb"].items())[:8]))
    print(f"lm_fused ptxas by build: {out['ptxas']}")
    cfg = BundleAdjustConfig(max_iterations=ITERATIONS, function_tolerance=0.0,
                             min_lambda=1e-12, max_lambda=1e30)
    device = torch.device("cuda:0")

    def f(x):
        return "-" if x is None else f"{x:.4f}"

    print("ms a working iteration: blocks, product, reduce, solve, k2, accept | barrier waits "
          "| iteration")
    for num_views, n_tracks in SHAPES:
        label = f"{num_views}x{n_tracks}"
        row = out["shapes"][label] = {
            "per_iteration_kernels_ms": per_iteration_kernels(device, num_views, n_tracks, cfg),
            "clock_mhz": clock_mhz(libs["clock"], device, num_views, n_tracks, cfg)}
        print(f"{label} per-iteration kernels: " + ", ".join(
            f"{k} {v:.4f}" for k, v in row["per_iteration_kernels_ms"].items()))
        print(f"{label} CTA 0's clock (MHz): " + ", ".join(
            f"{k} {v:.0f}" for k, v in row["clock_mhz"].items() if v))
        for name, lib in libs.items():
            if name == "clock":
                continue
            t = row[name] = lm_fused_split("quat", device, num_views, n_tracks, cfg, lib=lib)
            print(f"{label} {name:13s} " + " ".join(f(x) for x in t["stage_ms"].values()) + " | "
                  + " ".join(f(x) for x in t["barrier_wait_ms"].values())
                  + f" | {f(t['iteration_ms'])}")
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
            fh.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
