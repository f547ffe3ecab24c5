"""The benchmark's own count of a bundle adjustment solved whole on the
device (one LM solve, stopping at convergence), from the problem alone:
whatever implements it, a roofline share reads the same work. Nothing of
the program is imported.

Peaks are the H100 SXM data sheet's (dense, at its 700 W limit): f32
outside the tensor cores and HBM3 bandwidth. The floor of a solve is the
larger of its operations over the f32 peak and its bytes over the
bandwidth.

The work, in FMA (two operations each), for V cameras, T tracks, the
observations the mask holds (m_t views of track t) and the LM iterations
that ran:
- the initial cost: a residual and its robust cost, INITIAL_COST_FMA an
  observation;
- each iteration: the Schur term, the symmetric half of a rank-3 update of
  each track's (6 m_t)-square block, 3 (6m)(6m+1)/2 = 54 m^2 + 9 m a track;
  the per-observation block math of the assembly and of the point update
  and cost (OBS_FMA); the camera solve, a Cholesky and two triangular
  solves of the (6V)-square system, n^3 / 6 + n^2 at n = 6V.
Bytes: the inputs (points, observations and mask, the cameras and their
free flags) read once and the outputs (both halves of the points and the
cameras, the LM state) written once; the intermediates need never leave
the chip.
"""

F32_FLOPS = 67e12
HBM_BYTES = 3.35e12
INITIAL_COST_FMA = 18
# besides the Schur term: the assembly's projection and Jacobians (~60), the
# point block and gradient (18), U's upper triangle (42), W (36), W V^-1 (54)
# and the rhs (30); the point update's Jacobians (~60), point block (18),
# W^T dc (24) and the projection and cost through the candidate (~18)
OBS_FMA = 240 + 120


def solve_work(views: int, tracks: int, observations: int, sum_views_sq: int,
               iterations: int, optimize_points: bool = True):
    """(flops, bytes) of one whole LM solve; `sum_views_sq` is the sum over
    the tracks of m_t^2, `observations` the sum of m_t. Without point
    optimization there is no Schur term."""
    n = 6 * views
    schur = 54 * sum_views_sq + 9 * observations if optimize_points else 0
    per_iteration = 2 * (schur + OBS_FMA * observations + n ** 3 / 6 + n * n)
    flops = 2 * INITIAL_COST_FMA * observations + iterations * per_iteration
    inputs = 16 * tracks + 12 * views * tracks + 72 * views
    outputs = 2 * (16 * tracks + 48 * views) + 32
    return float(flops), float(inputs + outputs)


def floor_s(flops: float, nbytes: float) -> float:
    """The least seconds the card could take for `flops` f32 operations over
    `nbytes` bytes moved."""
    return max(flops / F32_FLOPS, nbytes / HBM_BYTES)
