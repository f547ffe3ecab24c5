"""Builds the port's native sources (orthosfm_torch/csrc/) at first use.

A CUDA source (``*.cu``) is compiled by nvcc for sm_90a, a C++ source
(``*.cpp``) by the host C++ compiler, each into a shared library with a plain
C interface under orthosfm_torch/_build/. The library's name hashes the
source and the flags, so an edited source always rebuilds and a stale build
is never loaded. Callers bind the library with ctypes (``load``). A build
that fails raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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


def resolve_impl(impl: str, device) -> str:
    """A kernel wrapper's route: "auto" gives "kernel" for CUDA tensors and
    "torch" (the plain PyTorch version) for CPU tensors."""
    if impl == "auto":
        return "kernel" if device.type == "cuda" else "torch"
    if impl not in ("torch", "kernel"):
        raise ValueError(f"unknown impl {impl!r} (expected auto|torch|kernel)")
    return impl


def _compiler(source: Path) -> tuple:
    """(compiler path, flags) for a source, chosen by its suffix."""
    if source.suffix == ".cu":
        return NVCC, NVCC_FLAGS
    if source.suffix == ".cpp":
        return CXX, CXX_FLAGS
    raise ValueError(f"no compiler for {source.name}")


def library_path(source: Path) -> Path:
    """Where the library of this source and its flags is built."""
    _, flags = _compiler(source)
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{source.stem}_{digest[:16]}.so"


def build(source: Path) -> tuple:
    """Compile `source` (once per source hash) and return (library path,
    compiler log). A missing compiler or a failed build raises."""
    out = library_path(source)
    if out.exists():
        return out, ""
    cc, flags = _compiler(source)
    if not os.path.isfile(cc):
        raise RuntimeError(f"{Path(cc).name} not found at {cc}; {source.name} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cc, *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(cc).name} failed to build {source.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def load(source: Path, signatures: dict) -> ctypes.CDLL:
    """Build `source` if needed and load it, declaring each C function of
    `signatures` ({name: argtypes}) to return int."""
    path, _ = build(source)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
