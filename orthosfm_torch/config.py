"""Configuration for the reconstruction pipeline.

Mirrors the reference's three config tiers (reference: src/sfm/reconstruct.h:25-35,
src/app/main.cpp:28-38, plus the hard-coded algorithm constants catalogued in
SURVEY.md §5.6) as explicit dataclasses, so every magic number of the C++
pipeline is a named, overridable field here.

A copy of orthosfm_tpu/config.py, not an import of it: importing anything
from orthosfm_tpu imports jax. It accepts every field of the JAX package's
config, so a config written for it runs here unchanged, and differs in
BundleAdjustConfig.impl ("auto" | "torch" | "kernel"). Some fields are
accepted and not read, as each says: the Ceres gradient and parameter
tolerances (unread in the JAX package too), `use_pallas` (`impl` picks the
kernels here), ReconstructionConfig.camera_distance
(core.cameras.CAMERA_DISTANCE is the constant in both packages) and
MatchingConfig's SIFT constants (ops/sift.py holds them in both packages).
"""

from __future__ import annotations

import dataclasses
import enum


class SolverType(enum.IntEnum):
    """Camera parameterization selector (reference: src/data_structures/solver_type.h:14-21).

    Index values match the reference CLI ``--solver {0..3}`` flag
    (reference: src/util/common.cpp:256-272).
    """

    ORTHO_QUATERNION = 0
    ORTHO_EULER_HORIZONTAL = 1
    ORTHO_EULER_HORIZONTAL_VERTICAL = 2
    ORTHO_EULER_ALL_DOF = 3

    @property
    def is_quaternion(self) -> bool:
        return self == SolverType.ORTHO_QUATERNION

    @property
    def degrees_of_freedom(self) -> int:
        """Euler-solver dof mapping (reference:
        src/algorithms/orthographic/OrthographicReconstructionAlgorithm.cpp:15-34)."""
        return {
            SolverType.ORTHO_QUATERNION: 4,  # rotation(3 tangent) + offset; scale fixed
            SolverType.ORTHO_EULER_HORIZONTAL: 1,
            SolverType.ORTHO_EULER_HORIZONTAL_VERTICAL: 2,
            SolverType.ORTHO_EULER_ALL_DOF: 4,
        }[self]

    def describe(self) -> str:
        """Human-readable solver name (reference: src/util/common.cpp:274-287)."""
        return {
            SolverType.ORTHO_QUATERNION: "Quaternion based orthographic sfm solver",
            SolverType.ORTHO_EULER_HORIZONTAL: (
                "Euler angle based orthographic sfm solver restricted to horizontal rotation"
            ),
            SolverType.ORTHO_EULER_HORIZONTAL_VERTICAL: (
                "Euler angle based orthographic sfm solver restricted to horizontal"
                " and vertical rotation"
            ),
            SolverType.ORTHO_EULER_ALL_DOF: "Euler angle based orthographic sfm solver",
        }[self]


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """RANSAC settings for the Tomasi-Kanade initialization
    (reference: src/algorithms/tomasi_kanade.cpp:208-222)."""

    sample_size: int = 10
    success_probability: float = 0.999
    inlier_ratio: float = 0.7
    min_consensus_size: int = 25
    max_inlier_reprojection_error_px: float = 3.0
    # Validity heuristic thresholds (reference: tomasi_kanade.cpp:446-470)
    min_angle_separation_rad: float = 0.1
    min_basis_distance: float = 0.1

    @property
    def max_iterations(self) -> int:
        """Standard RANSAC iteration-count formula (reference: tomasi_kanade.cpp:212)."""
        import math

        return int(
            math.log(1.0 - self.success_probability)
            / math.log(1.0 - self.inlier_ratio**self.sample_size)
        )


@dataclasses.dataclass(frozen=True)
class BundleAdjustConfig:
    """LM solver settings matching the reference's Ceres options behaviourally
    (reference: src/bundle_adjustment/bundle_adjustment.cpp:64,126-133)."""

    huber_delta: float = 1.0
    max_iterations: int = 100
    function_tolerance: float = 1e-6
    # Accepted for the JAX package's configs, read by neither package: LM
    # stops on the function tolerance alone
    gradient_tolerance: float = 1e-10
    parameter_tolerance: float = 1e-10
    # LM damping schedule (ours; Ceres default trust-region analog)
    initial_lambda: float = 1e-4
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    min_lambda: float = 1e-12
    max_lambda: float = 1e8
    # Accepted for the JAX package's configs (which pick their Pallas kernels
    # by it), not read: `impl` picks the CUDA kernels here
    use_pallas: bool = True
    # LM stage implementation: "kernel" runs the hand-written CUDA kernels
    # (solvers/ba_kernels.py), "torch" their plain PyTorch versions, and
    # "auto" picks "kernel" for CUDA tensors and "torch" for CPU tensors.
    impl: str = "auto"  # "auto" | "torch" | "kernel"


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """Outlier-filter thresholds
    (reference: src/triangulation/outlier_filtering.cpp:97-110,140)."""

    max_reprojection_error_px: float = 1.5
    nn_sigma_threshold: float = 1.6
    nn_sigma_floor: float = 1e-3
    bounding_radius: float = 10.0


@dataclasses.dataclass(frozen=True)
class MatchingConfig:
    """Feature extraction + matching settings (defaults follow the reference's
    de-facto MVE path: src/matching/matching_mve.cpp:330-417, src/mve/sfm/sift.h:48-90)."""

    max_image_pixels: int = 6_000_000  # halve images until below this
    # Accepted, not read: ops/sift.py holds these constants (as in the JAX
    # package, whose detector does not read them either)
    sift_contrast_threshold: float = 0.02 / 3.0  # contrast / samples_per_octave
    sift_edge_ratio: float = 10.0
    sift_num_octaves: int = 5  # min_octave 0 .. max_octave 4
    sift_samples_per_octave: int = 3
    sift_base_blur: float = 1.6
    sift_inherent_blur: float = 0.5
    # -1 enables the 2x upscale octave (CudaSift always runs upscaled,
    # reference: cudaSiftH.cu:114-129, matching.cpp:47-52; MVE default is 0)
    sift_min_octave: int = 0
    max_features_per_view: int = 8192
    lowe_ratio: float = 0.8  # SIFT (reference: mve/sfm/matching_base.h:28-31)
    surf_lowe_ratio: float = 0.7  # SURF ratio (matching_base.h:30)
    use_surf: bool = True  # FEATURE_ALL = SIFT + SURF (matching_mve.cpp:333)
    lowres_feature_count: int = 500
    lowres_match_threshold: int = 5
    min_feature_matches: int = 50  # pair gate (reference: matching_mve.cpp:400-405)
    min_matching_inliers: int = 30
    # Matcher engine, the analog of MVE's Matching::MATCHER_* option
    # (matching_mve.cpp:406-408 defaults to cascade hashing). Both values
    # run the exact exhaustive matcher (the top-2 kernel), as in the JAX
    # package: cascade hashing is an approximate shortlist of the same
    # search, and the exact top-2 holds its candidates.
    matcher: str = "cascade_hashing"  # "cascade_hashing" | "exhaustive"
    ransac_f_iterations: int = 1000
    ransac_f_threshold: float = 0.0015  # on normalized coords
    min_pair_inliers_to_accept: int = 8
    # Alternate CudaSift-style verification (reference: useMveForMatching=false
    # branch, src/matching/matching.cpp:160-215): RANSAC homography at pixel
    # threshold 30 with a >50-inlier pair gate
    pair_verification: str = "fundamental"  # or "homography"
    homography_iterations: int = 10000
    homography_threshold_px: float = 30.0
    homography_find_threshold_px: float = 60.0
    homography_min_inliers: int = 50


@dataclasses.dataclass(frozen=True)
class ReconstructionConfig:
    """Programmatic pipeline API (reference: src/sfm/reconstruct.h:25-35)."""

    project_folder: str = ""
    image_folder: str = ""
    mask_folder: str = ""
    track_file: str = ""
    downscale_factor: int = 1
    solver: SolverType = SolverType.ORTHO_QUATERNION
    export_pairwise_tracks: bool = False

    # Incremental-loop constants (reference: src/sfm/reconstruct.cpp:186,
    # src/algorithms/orthographic/OrthographicReconstructionAlgorithm.cpp:144-146)
    group_size: int = 3
    global_ba_interval: int = 3
    # Accepted, not read: core.cameras.CAMERA_DISTANCE is the constant
    # (reference: OrthographicCamera.h:119)
    camera_distance: float = 10.0

    ransac: RansacConfig = dataclasses.field(default_factory=RansacConfig)
    ba: BundleAdjustConfig = dataclasses.field(default_factory=BundleAdjustConfig)
    filters: FilterConfig = dataclasses.field(default_factory=FilterConfig)
    matching: MatchingConfig = dataclasses.field(default_factory=MatchingConfig)

    # Random seed for RANSAC / TK metric-upgrade inits. The reference seeds from
    # std::random_device (nondeterministic, tomasi_kanade.cpp:232); we are
    # deterministic by default.
    seed: int = 0

    # Reference-parity escape hatch: when True, disable this framework's
    # deliberate robustness improvements over the reference so parity runs
    # reproduce reference behavior exactly. Currently gates the pristine-
    # observation initialization fallback in pipeline.incremental
    # (the reference hard-throws instead: tomasi_kanade.cpp:202-205).
    strict_reference_behavior: bool = False
