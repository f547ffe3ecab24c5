"""Builds the port's native sources (orthosfm_torch/csrc/) at first use.

A CUDA source (``*.cu``) is compiled by nvcc for sm_90a, a C++ source
(``*.cpp``) by the host C++ compiler, each into a shared library with a plain
C interface under orthosfm_torch/_build/. The library's name hashes the
source and the flags, so an edited source always rebuilds and a stale build
is never loaded. Callers bind the library with ctypes (``load``). A build
that fails raises; nothing falls back. A CUDA source that keeps its device
code under ``__CUDACC__`` can also be built for the host (``host=True``: the
host C++ compiler, as C++), where its arithmetic runs on the CPU for tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX = shutil.which("g++") or shutil.which("c++") or "g++"
CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")


# The JAX package's names of its BA implementations (orthosfm_tpu/config.py
# BundleAdjustConfig.impl), as the routes here that compute the same
IMPL_ALIASES = {"xla": "torch", "pallas": "kernel"}


def resolve_impl(impl: str, device, fused=None, use_pallas: bool = True) -> str:
    """A kernel wrapper's route: "torch" (the plain PyTorch version),
    "kernel" (the hand-written kernels) or "fused" (ba.run's whole LM solve
    in one launch). The JAX package's names map onto them: "xla" is
    "torch", "pallas" "kernel" (its per-iteration kernels) and "fused"
    "fused". `fused` says whether the caller's fused route serves this
    problem (None: the caller has none, and "fused" takes its kernels).
    "auto" gives "torch" for CPU tensors, and with `use_pallas` false
    (BundleAdjustConfig.use_pallas, which turns the JAX package's "auto"
    into XLA on every backend) on every device; else, for CUDA tensors,
    "fused" where that serves and "kernel" elsewhere. An explicit impl wins
    over `use_pallas`; an explicit "fused" that does not serve raises."""
    if impl == "auto":
        if device.type != "cuda" or not use_pallas:
            return "torch"
        return "fused" if fused else "kernel"
    impl = IMPL_ALIASES.get(impl, impl)
    if impl == "fused":
        if fused is None:
            return "kernel"
        if not fused:
            raise ValueError("impl 'fused' cannot serve this problem (the whole LM solve in one "
                             "launch serves up to 375 views, ba_kernels.FUSED_MAX_VIEWS)")
        return impl
    if impl not in ("torch", "kernel"):
        raise ValueError(f"unknown impl {impl!r} (expected auto|torch|kernel|fused, or the JAX "
                         "package's xla|pallas)")
    return impl


def _compiler(source: Path, host: bool = False) -> tuple:
    """(compiler path, flags) for a source, chosen by its suffix; `host`: a
    CUDA source built as C++ by the host compiler."""
    if source.suffix == ".cu":
        return (CXX, (*CXX_FLAGS, "-x", "c++")) if host else (NVCC, NVCC_FLAGS)
    if source.suffix == ".cpp":
        return CXX, CXX_FLAGS
    raise ValueError(f"no compiler for {source.name}")


def library_path(source: Path, defines: tuple = (), host: bool = False) -> Path:
    """Where the library of this source, its flags and `defines` (extra
    -D flags: another build of the same source) is built."""
    _, flags = _compiler(source, host)
    digest = hashlib.sha256(source.read_bytes() + " ".join((*flags, *defines)).encode()).hexdigest()
    return BUILD_DIR / f"lib{source.stem}_{digest[:16]}.so"


def build(source: Path, defines: tuple = (), host: bool = False) -> tuple:
    """Compile `source` with `defines` (once per source hash) and return
    (library path, compiler log); the log is kept beside the library, so a
    library built earlier returns it too. A missing compiler or a failed
    build raises."""
    out = library_path(source, defines, host)
    log = out.with_suffix(".log")
    if out.exists():
        return out, log.read_text() if log.exists() else ""
    cc, flags = _compiler(source, host)
    if not os.path.isfile(cc):
        raise RuntimeError(f"{Path(cc).name} not found at {cc}; {source.name} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cc, *flags, *defines, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(cc).name} failed to build {source.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def ptxas_usage(log: str, entry: str) -> dict:
    """Registers a thread, bytes of stack frame and of spill stores and
    loads of the kernel whose mangled name holds `entry`, from a build's
    -Xptxas -v log (empty where the log does not name it); for a device
    function compiled apart (__noinline__), its stack and spills (its
    registers count in its callers')."""
    out, lines = {}, log.splitlines()
    at = next((i for head in ("Compiling entry function", "Function properties for")
               for i, line in enumerate(lines) if head in line and entry in line), None)
    if at is None:
        return out
    for nxt in lines[at + 1:at + 5]:
        if "Compiling entry function" in nxt or (
                "Function properties for" in nxt and entry not in nxt):
            break  # the next function's
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
                      r"spill loads", nxt)
        if m:
            out.update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", nxt)
        if m:
            out["registers"] = int(m[1])
            break
    return out


def load(source: Path, signatures: dict, defines: tuple = (), host: bool = False) -> ctypes.CDLL:
    """Build `source` with `defines` (for the host: `host`) if needed and
    load it, declaring each C function of `signatures` ({name: argtypes}) to
    return int."""
    path, _ = build(source, defines, host)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
