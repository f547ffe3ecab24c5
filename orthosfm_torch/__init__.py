"""orthosfm-torch: orthographic Structure-from-Motion in PyTorch, with the
bundle-adjustment inner loop in hand-written CUDA kernels for Hopper.

A port of the JAX package ``orthosfm_tpu`` that keeps its module tree and
function names, so each function here has its counterpart there. This
package imports torch, never jax.
"""

import torch as _torch

__version__ = "0.1.0"

# SfM geometry cannot tolerate reduced-precision matmuls (the reason the JAX
# package pins "highest" at orthosfm_tpu/__init__.py:19-27): rotation products
# pick up ~4e-3 non-orthogonality in TF32, and the BA normal equations lose
# the curvature detail LM needs near convergence. Pin every f32 product and
# convolution to full f32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from orthosfm_torch.config import (BundleAdjustConfig, FilterConfig,  # noqa: E402
                                   MatchingConfig, RansacConfig, ReconstructionConfig,
                                   SolverType)

__all__ = [
    "BundleAdjustConfig", "FilterConfig", "MatchingConfig", "RansacConfig",
    "ReconstructionConfig", "SolverType", "__version__",
]


def reconstruct(config: ReconstructionConfig, verbose: bool = True,
                device="cuda", mesh=None):
    """Top-level reconstruction on ``device`` (CUDA unless the caller names
    another; raises without CUDA rather than fall back to the CPU), or over
    ``mesh`` (parallel.mesh; every rank calls it). The lazy import keeps
    `import orthosfm_torch` light."""
    from orthosfm_torch.pipeline.reconstruct import reconstruct as _reconstruct

    return _reconstruct(config, verbose=verbose, device=device, mesh=mesh)
