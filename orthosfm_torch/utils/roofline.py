"""Work counts of the port's kernels and the least time the card could take
for them: the one count that chip_smoke.py's kernels line and
scripts/torch_roofline.py both read.

Peaks are the H100 SXM data sheet's (dense, at its 700 W limit): f32
outside the tensor cores and HBM3 bandwidth. A kernel's bound is the larger
of its operations over the f32 peak and its bytes over the bandwidth, each
input read once and each output written once, counting the work these
inputs need (the observations a mask holds, the valid rows of a pair).
"""

from __future__ import annotations

F32_FLOPS = 67e12
HBM_BYTES = 3.35e12
TF32_FLOPS = 495e12  # dense, on the tensor cores
# FMA per observation besides the Schur term, counted from the plain
# versions' formulas: K1 projection and Jacobians (~60), the point block and
# gradient (18), U's upper triangle (42), W = w Jc^T Jp (36), W V^-1 (54) and
# the rhs (30); K2 the Jacobians (~60), point block (18), W^T dc (24) and the
# projection and robust cost through the candidate cameras (~18)
K1_OBS_FMA = 240
K2_OBS_FMA = 120


def bound(flops, nbytes):
    """(bound_ms, bound_by): the least time the card could take for work of
    `flops` f32 operations over `nbytes` bytes moved."""
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def camera_solve_work(num_views: int):
    """(flops, bytes) of K3 on the (6V)² system: a Cholesky factorization
    and two triangular solves, n³/6 + n² FMA; S, dU, rhs and delta, the
    state and the cameras' rot, camp and free read or written once."""
    n = 6 * num_views
    return 2 * (n ** 3 / 6 + n * n), 4 * (n * n + 3 * n) + 32 + 4 * (6 + 4 + 8) * num_views


def grid_route_bounds(num_views: int, panel: int = 128) -> dict:
    """K3's grid route at V views, three floors in ms: its n^3 / 6 FMA on
    the f32 CUDA cores ("f32"), the same work three times over on the TF32
    tensor cores, as its 3xTF32 products run it ("tf32x3"), and the bytes
    its right-looking trailing update moves at this panel width, each lower
    entry read and written once a panel, 4 n^3 / (3 panel) ("bytes")."""
    n = 6 * num_views
    fma = n ** 3 / 6
    return {"f32": 2 * fma / F32_FLOPS * 1e3, "tf32x3": 3 * 2 * fma / TF32_FLOPS * 1e3,
            "bytes": 4 * n ** 3 / (3 * panel) / HBM_BYTES * 1e3}


def grid_route_bound(num_views: int):
    """(bound_ms, bound_by) of K3's grid route at V views: its products run
    on the TF32 tensor cores in 3xTF32, so its operations' floor is
    grid_route_bounds' "tf32x3", set against the bytes the function must
    move (camera_solve_work's)."""
    t_ops = grid_route_bounds(num_views)["tf32x3"]
    t_bytes = camera_solve_work(num_views)[1] / HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def ba_work(maskT, opt):
    """(flops, bytes) of K1, K3, K2 (with its accept tail) and K4 on this
    problem, counting the observations the mask holds (m_t views of track
    t): the Schur term is the symmetric half of a rank-3 update of the
    (6 m_t)-square block per track, 3 (6m)(6m+1)/2 FMA; the per-observation
    block math is counted as K1_OBS_FMA and K2_OBS_FMA. Each input is read
    once, each output written once; K4 lm_accept reads the summed cost and
    a state slot and writes the other."""
    V, T = maskT.shape
    n = 6 * V
    m = (maskT != 0).sum(dim=0).double()
    n_obs = float(m.sum())
    schur = float((3 * (6 * m) * (6 * m + 1) / 2).sum()) if opt else 0.0
    inputs = 16 * T + 12 * V * T + 72 * V  # pT, obsT + maskT, rot + camp + free
    k1 = (2 * (schur + K1_OBS_FMA * n_obs), inputs + 4 * (n * n + 2 * n))
    # the step, the candidate cameras, the new points, the state in and out
    k2 = (2 * K2_OBS_FMA * n_obs, inputs + 4 * 6 * V + 48 * V + 16 * T + 2 * 32)
    return {"schur_assemble": k1, "camera_solve": camera_solve_work(V),
            "point_update_cost": k2, "lm_accept": (0.0, 4 + 2 * 32)}


def lm_solve_work(maskT, opt, iterations):
    """(flops, bytes) of lm_fused's whole solve on this problem: the initial
    cost (K2's cost pass, ~18 FMA an observation) and, for each of the
    `iterations` that ran, K1 + K3 + K2 of ba_work; the inputs (pT, obsT,
    maskT, rot, camp, free) read once and the outputs (both halves of the
    points and cameras, the state) written once: the stages' intermediates
    (S, the step, the scratch) never need to leave the chip. Also the sum
    of the stages' own bounds over the iterations (`stages_bound_ms`),
    what the per-iteration kernels could reach at best."""
    V, T = maskT.shape
    w = ba_work(maskT, opt)
    n_obs = float((maskT != 0).sum())
    per_it = sum(w[k][0] for k in ("schur_assemble", "camera_solve", "point_update_cost"))
    flops = 2 * 18 * n_obs + iterations * per_it
    nbytes = 16 * T + 12 * V * T + 72 * V + 2 * (16 * T + 48 * V) + 32
    stages = iterations * sum(bound(*w[k])[0] for k in ("schur_assemble", "camera_solve",
                                                         "point_update_cost"))
    return flops, nbytes, stages


def top2_work(stack, ci, cj):
    """(flops, bytes) of one product per pair, both directions' outputs: 2 D
    FMA operations per (query, database) pair of valid rows; each valid
    descriptor read once, the six (pairs, N) outputs written once."""
    N, D = stack.shape[1:]
    ci, cj = ci.double().cpu(), cj.double().cpu()
    return (2.0 * float((ci * cj).sum()) * D,
            4.0 * (float((ci + cj).sum()) * D + 6 * ci.shape[0] * N))


# Tomasi-Kanade (csrc/tk_kernels.cu), f32 operations counted from the
# kernels' code: K5's cyclic Jacobi does TK_JACOBI_SWEEPS sweeps of n(n-1)/2
# rotations on the n = 2G Gram, each ~15 operations for its angle and 8 an
# entry pair for the 2(n - 2) rows of the Gram and the n rows of the vectors
# it turns; each of the 40 LM iterations a 9 x 9 LU with its solve and the
# cost at the candidate (~6 operations a residual: two 3-term dots and a
# square); the normal equations (J^T J and J^T r) only on an accepted step,
# which the inputs decide: the floor counts them once, at the start. K6
# per valid track and hypothesis: the normalized coordinates, origin and
# projected origin of each camera (36), the 3 x 3 solve (18), and each
# camera's local point, pixel and error (27).
TK_LM_ITERATIONS = 40
TK_JACOBI_SWEEPS = 10


def tk_factorize_work(problems: int, columns: int, views: int, gram_given: bool = False):
    """(flops, bytes) of K5 on `problems` factorizations of `views` cameras
    over `columns` columns (or a Gram given per problem): the Gram (two
    passes over D), the Jacobi sweeps, the 40 LM iterations' solves and
    costs and one pass of the normal equations (a floor: the steps accepted
    add one pass each), and the models; inputs read once (obs, q0, mask or
    the Gram), outputs written once (sol1, sol2, usable, RStar)."""
    n, m = 2 * views, 3 * views + 6
    gram = 0 if gram_given else columns * (3 * n + n * (n + 1))
    jacobi = TK_JACOBI_SWEEPS * n * (n - 1) / 2 * (15 + 8 * (2 * (n - 2) + n))
    normal = m * (2 * 45 + 2 * 9 + 12)
    lu = 2 * sum((8 - k) * (9 - k) for k in range(9)) + 2 * 45 + 18
    lm_floor = normal + TK_LM_ITERATIONS * (lu + 6 * m + 18)
    models = views * (2 * 18 + 6 + 3 * 6) + views * 9 * 5
    flops = problems * (gram + jacobi + lm_floor + models)
    inputs = 4 * n * n if gram_given else columns * (8 * views + 1)
    nbytes = problems * (inputs + 36 + 2 * 36 * views + 1 + 12 * n)
    return float(flops), float(nbytes)


def tk_score_work(hypotheses: int, tracks: int, valid_tracks: int, views: int, sample: int):
    """(flops, bytes) of K6: ~63 operations a camera and 18 for the solve,
    per valid track and hypothesis; the observations and the valid mask
    read once, each hypothesis's sol1, usable and sample once, the scores
    and consensus counts written once."""
    flops = hypotheses * valid_tracks * (63 * views + 18)
    nbytes = tracks * (8 * views + 1) + hypotheses * (36 * views + 1 + 8 * sample + 12) + 8 * views
    return float(flops), float(nbytes)


# The outlier filter's neighbour search (csrc/outlier_kernels.cu): per pair
# of pointed tracks, the plain version's expansion max(sq_i + sq_j - 2 dot,
# 0) and the running minimum, 12 f32 operations (the 4-D dot a multiply and
# three FMAs, the sum, the FMA of -2 dot, the clamp, the min; FMA as 2)
OUTLIER_PAIR_FLOPS = 12


def outlier_nn_work(tracks: int, pointed: int):
    """(flops, bytes) of outlier_nn: OUTLIER_PAIR_FLOPS a pair of pointed
    tracks; the points (16 bytes) and has_pt (1) read once, nn written
    once."""
    return float(OUTLIER_PAIR_FLOPS * pointed * pointed), float(tracks * (16 + 1 + 4))
