"""The Tomasi-Kanade kernels (orthosfm_torch/csrc/tk_kernels.cu: K5
tk_factorize, K6 tk_score; solvers/tk_kernels.py) and the TK routes through
them.

On the CPU (the Tier-1 gate): the routed robust_factorization,
score_hypothesis and factorize on CPU tensors (the plain versions) against
the JAX package with its draws injected, at G = 3, 2048 tracks and 241
hypotheses, to the tolerances of tests/test_torch_tk.py (models 1e-4,
scores 1e-3 where finite); and the kernels' own arithmetic, the CUDA
source built for the host (tk_kernels.host_library), against the plain
versions: given one RStar, models to 1e-4 and the validity heuristic equal;
RStar itself (Jacobi on the Gram against the SVD) up to each column's sign,
to 1e-4; scores to 1e-3 and consensus counts equal except tracks whose error
lies within NEAR_THRESHOLD px of the inlier threshold (their count bounds
the difference).

On the card (marked `cuda`, skipped without one; this file imports JAX only
inside the CPU tests, so there run it as
``python -m pytest --noconftest tests/test_torch_tk_kernels.py -q -m cuda``):
K5 and K6 against their plain versions on the card at 241 hypotheses x 4096
tracks, the fallback's Gram route at 50 000, robust_factorization with no
host sync (torch's sync debug mode raises on one) and through K5 and K6
only, and a refused launch raising.
"""

import functools

import numpy as np
import pytest
import torch

from orthosfm_torch import kernel_build
from orthosfm_torch.config import RansacConfig
from orthosfm_torch.data import synthetic
from orthosfm_torch.solvers import tk_kernels as tkk
from orthosfm_torch.solvers import tomasi_kanade as tk

torch.set_num_threads(2)

# px: a track this close to the inlier threshold may fall on either side
# between the kernel and its plain version: f32 pixel coordinates in
# [1024, 2048) round to 1.2e-4 px, so two roundings apart reach 2.4e-4 (a
# track 1.1e-4 px from the threshold flipped on the card at 241 x 50 000)
NEAR_THRESHOLD = 2.5e-4
# px: the same between the port and the JAX package, whose XLA atan2 and
# acos round otherwise (measured up to 4.2e-4 px at 2048 tracks)
NEAR_THRESHOLD_JAX = 1e-3
TOL_MODEL = 1e-4
TOL_SCORE = 1e-3
WIDTH = 2048.0


def _group(n_tracks, noise, views=3, seed=0):
    """A group of `views` views of the blob (numpy, seeded): obs (T, G, 2)
    with noise_px of Gaussian noise and the full-size mask, every 13th
    track invalid."""
    ds = synthetic.generate_dataset(synthetic.blob_cloud(n_tracks, seed=seed), num_views=6,
                                    seed=seed, device="cpu")
    obs = ds.tracks.obs[:, :views].numpy().copy()
    if noise:
        obs += noise * np.random.default_rng(seed + 1).standard_normal(obs.shape).astype(np.float32)
    valid = ds.tracks.obs_mask[:, :views].all(1).numpy() & ds.tracks.alive.numpy()
    valid[::13] = False
    return obs.astype(np.float32), valid


def _numpy_draws(valid, H, S, seed):
    """Sample indices (H, S) of valid tracks without replacement and inits
    (H, 9) in [-1, 1), from numpy."""
    rng = np.random.default_rng(seed)
    vi = np.flatnonzero(valid)
    samp = np.stack([rng.choice(vi, S, replace=False) for _ in range(H)])
    return samp.astype(np.int64), rng.uniform(-1, 1, (H, 9)).astype(np.float32)


def _rstar_up_to_signs(a, b):
    """max |a - b s| with s the sign of each column's agreement."""
    s = torch.sign((a * b).sum(dim=-2, keepdim=True))
    return float((a - b * s).abs().max())


def _score_agreement(score, n_con, score_ref, n_ref, err_ref, valid, thr, window=NEAR_THRESHOLD):
    """Consensus counts equal but for tracks within `window` px of the
    threshold (their number bounds the difference), and scores to TOL_SCORE
    where both are finite and no track is near; returns the near tracks."""
    gap = (err_ref - thr).abs().amin(dim=2).masked_fill(~valid[None], float("inf"))  # (H, T)
    n_near = (gap < window).sum(dim=1)
    off = ((n_con - n_ref).abs() > n_near).nonzero().flatten().tolist()
    assert not off, (f"consensus counts differ past {window} px of the threshold at hypotheses "
                     f"{off[:8]}: nearest track {[float(gap[h].min()) for h in off[:8]]} px away")
    clean = n_near == 0
    assert torch.equal(n_con[clean], n_ref[clean])
    fin = torch.isfinite(score_ref) & clean
    assert torch.equal(torch.isfinite(score)[clean], torch.isfinite(score_ref)[clean])
    if bool(fin.any()):
        assert float((score[fin] - score_ref[fin]).abs().max()) <= TOL_SCORE
    return int(n_near.sum())


def _near_threshold(model, obs, valid, thr):
    """Valid tracks within NEAR_THRESHOLD_JAX of the threshold at some
    camera under `model` (the plain version's errors)."""
    _, err = tkk._triangulate_and_errors(model[None], obs, valid, torch.full((3,), WIDTH),
                                         torch.full((3,), WIDTH))
    return int((((err[0] - thr).abs() < NEAR_THRESHOLD_JAX).any(dim=1) & valid).sum())


def _same_mirror_pair(got1, got2, ref1, ref2):
    """Each problem's mirror pair as JAX's, in its order or swapped: the
    metric upgrade from one init may land on either of the two (the SVDs'
    column signs differ between the packages)."""
    def err(a, b):
        return np.abs(a - b).reshape(a.shape[0], -1).max(axis=1)

    same = np.maximum(err(got1, ref1), err(got2, ref2))
    swapped = np.maximum(err(got1, ref2), err(got2, ref1))
    assert float(np.minimum(same, swapped).max()) <= TOL_MODEL


# ---------------------------------------------------------------------------
# The JAX package (CPU tests only)


@functools.lru_cache(maxsize=None)
def _jax():
    import jax
    import jax.numpy as jnp

    from orthosfm_tpu.config import RansacConfig as JRansacConfig
    from orthosfm_tpu.solvers import tomasi_kanade as jtk

    return jax, jnp, jtk, JRansacConfig


@functools.lru_cache(maxsize=None)
def _jax_draws_program(cfg):
    jax, jnp, jtk, _ = _jax()

    @jax.jit
    def draws(key, obs, valid):
        H = cfg.max_iterations
        keys = jax.random.split(key, H + 1)
        w = jnp.full(obs.shape[1], WIDTH)
        samp, score, n_con = jax.vmap(
            lambda k: jtk.score_hypothesis(k, obs, valid, w, w, cfg))(keys[:H])
        q0 = jax.vmap(lambda k: jax.random.uniform(jax.random.split(k)[1], (9,), minval=-1.0,
                                                   maxval=1.0))(keys[:H])
        q0_fb = jax.random.uniform(keys[H], (9,), minval=-1.0, maxval=1.0)
        return samp, q0, q0_fb, score, n_con

    return draws


def _jax_run(seed, obs, valid):
    """The JAX package's robust_factorization from PRNGKey(seed), and the
    draws, scores and consensus sizes of its hypotheses (numpy)."""
    jax, jnp, jtk, JRansacConfig = _jax()
    key = jax.random.PRNGKey(seed)
    cfg = JRansacConfig()
    ref = jtk.robust_factorization(jnp.asarray(obs), jnp.asarray(valid), jnp.full(3, WIDTH),
                                   jnp.full(3, WIDTH), key, cfg=cfg)
    draws = _jax_draws_program(cfg)(key, jnp.asarray(obs), jnp.asarray(valid))
    return ref, tuple(np.array(x) for x in draws)


@pytest.mark.parametrize("noise", [0.5, 2.0])
def test_routed_robust_factorization_matches_jax(noise):
    """The routed robust_factorization on CPU tensors (tk_factorize and
    tk_score on their plain versions) against the JAX package, its draws
    injected, 2048 tracks, 241 hypotheses."""
    obs, valid = _group(2048, noise)
    ref, (samp, q0, q0_fb, _, _) = _jax_run(3, obs, valid)
    tkk.reset_launch_counts()
    got = tk.robust_factorization(torch.from_numpy(obs), torch.from_numpy(valid), WIDTH, WIDTH,
                                  RansacConfig(), samp_idx=torch.from_numpy(samp.astype(np.int64)),
                                  q0=torch.from_numpy(q0), q0_fallback=torch.from_numpy(q0_fb))
    assert tkk.launch_counts() == {"tk_factorize": 0, "tk_score": 0}
    np.testing.assert_allclose(got.model1.numpy(), np.asarray(ref.model1), atol=TOL_MODEL)
    np.testing.assert_allclose(got.model2.numpy(), np.asarray(ref.model2), atol=TOL_MODEL)
    near = _near_threshold(got.model1, torch.from_numpy(obs), torch.from_numpy(valid),
                           RansacConfig().max_inlier_reprojection_error_px)
    assert abs(int(got.num_inliers) - int(ref.num_inliers)) <= near
    assert bool(got.found) == bool(ref.found)


def test_routed_score_hypothesis_matches_jax():
    obs, valid = _group(2048, 1.0, seed=2)
    _, (samp, q0, _, score, n_con) = _jax_run(7, obs, valid)
    w = torch.full((3,), WIDTH)
    obs_t, valid_t = torch.from_numpy(obs), torch.from_numpy(valid)
    _, got_score, got_n, sol1, _ = tk.score_hypothesis(
        obs_t, valid_t, w, w, RansacConfig(), samp_idx=torch.from_numpy(samp.astype(np.int64)),
        q0=torch.from_numpy(q0))
    assert np.isfinite(score).sum() > 100
    _, err = tkk._triangulate_and_errors(sol1, obs_t, valid_t, w, w)
    _score_agreement(got_score, got_n, torch.from_numpy(score), torch.from_numpy(n_con).long(),
                     err, valid_t, RansacConfig().max_inlier_reprojection_error_px,
                     NEAR_THRESHOLD_JAX)


def test_routed_factorize_matches_jax():
    """factorize on a batch of masked samples and on every valid track (the
    fallback's problem), against the JAX package's factorize from the same
    keys' inits."""
    jax, jnp, jtk, _ = _jax()
    obs, valid = _group(2048, 1.0, seed=4)
    samp, _ = _numpy_draws(valid, 16, 12, 5)
    mask = np.random.default_rng(6).random((16, 12)) < 0.8
    keys = jax.random.split(jax.random.PRNGKey(11), 17)
    q0 = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (9,), minval=-1.0, maxval=1.0))(keys))
    ref1, ref2 = jax.vmap(jtk.factorize)(jnp.asarray(obs[samp]), jnp.asarray(mask), keys[:16])
    got1, got2 = tk.factorize(torch.from_numpy(obs[samp]), torch.from_numpy(mask),
                              torch.from_numpy(q0[:16]))
    _same_mirror_pair(got1.numpy(), got2.numpy(), np.asarray(ref1), np.asarray(ref2))
    fb1, fb2 = jtk.factorize(jnp.asarray(obs), jnp.asarray(valid), keys[16])
    got1, got2 = tk.factorize(torch.from_numpy(obs)[None], torch.from_numpy(valid)[None],
                              torch.from_numpy(q0[16:]))
    _same_mirror_pair(got1.numpy(), got2.numpy(), np.asarray(fb1)[None], np.asarray(fb2)[None])


# ---------------------------------------------------------------------------
# The kernels' arithmetic on the host (the CUDA source built by g++)


@pytest.mark.parametrize("views", [3, 4])
def test_factorize_arithmetic_matches_plain_version(views):
    """K5's arithmetic (host build) against tk_factorize_ref: RStar up to
    column signs, and, given the plain version's RStar, the metric upgrade,
    the mirror pair and the validity heuristic, for 241 masked samples."""
    cfg = RansacConfig()
    obs, valid = _group(2048, 1.0, views=views, seed=1)
    samp, q0 = _numpy_draws(valid, cfg.max_iterations, cfg.sample_size, 2)
    o = torch.from_numpy(obs[samp])
    mask = torch.from_numpy(np.random.default_rng(3).random(samp.shape) < 0.9)
    mask[:, :8] = True
    q0 = torch.from_numpy(q0)
    ref = tkk.tk_factorize_ref(o, mask, q0, cfg)
    own = tkk.tk_factorize_host(o, mask, q0, cfg)
    assert _rstar_up_to_signs(own[3], ref[3]) <= TOL_MODEL
    got = tkk.tk_factorize_host(o, mask, q0, cfg, rstar=ref[3])
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), atol=TOL_MODEL)
    np.testing.assert_allclose(got[1].numpy(), ref[1].numpy(), atol=TOL_MODEL)
    assert torch.equal(got[2], ref[2]) and bool(ref[2].any())
    assert torch.equal(got[3], ref[3])


def test_factorize_arithmetic_validity_heuristic():
    """The validity heuristic of K5 rejects near-duplicate cameras as
    is_result_usable does: RStar rows of two cameras made equal."""
    cfg = RansacConfig()
    obs, valid = _group(2048, 1.0, seed=1)
    samp, q0 = _numpy_draws(valid, 32, cfg.sample_size, 8)
    o = torch.from_numpy(obs[samp])
    o[:16, :, 1] = o[:16, :, 0]  # camera 1 a copy of camera 0 in half the samples
    q0 = torch.from_numpy(q0)
    ref = tkk.tk_factorize_ref(o, None, q0, cfg)
    got = tkk.tk_factorize_host(o, None, q0, cfg, rstar=ref[3])
    assert torch.equal(got[2], ref[2])
    assert not bool(ref[2][:16].any()) and bool(ref[2][16:].all())


def test_fallback_gram_route_matches_plain_version():
    """The fallback over every valid track: K5 from a Gram given (the card's
    route past GRAM_INLINE_COLUMNS columns, the Gram a torch.matmul of
    centered_measurements) and from the Gram it forms itself, against the
    SVD of the plain version: RStar up to signs; the models given one RStar."""
    cfg = RansacConfig()
    obs, valid = _group(2048, 1.0, seed=5)
    o, m = torch.from_numpy(obs)[None], torch.from_numpy(valid)[None]
    q0 = torch.from_numpy(np.random.default_rng(9).uniform(-1, 1, (1, 9)).astype(np.float32))
    D = tkk.centered_measurements(o, m)
    gram = torch.matmul(D, D.transpose(1, 2))
    ref = tkk.tk_factorize_ref(o, m, q0, cfg)
    for got in (tkk.tk_factorize_host(o, m, q0, cfg, gram=gram),
                tkk.tk_factorize_host(o, m, q0, cfg)):
        assert _rstar_up_to_signs(got[3], ref[3]) <= TOL_MODEL
    got = tkk.tk_factorize_host(o, m, q0, cfg, rstar=ref[3])
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), atol=TOL_MODEL)


@pytest.mark.parametrize("views", [3, 4])
def test_score_arithmetic_matches_plain_version(views):
    """K6's arithmetic (host build) against tk_score_ref on the plain
    version's models of 241 hypotheses, 2048 tracks, other widths and
    heights a camera."""
    cfg = RansacConfig()
    obs, valid = _group(2048, 1.0, views=views, seed=3)
    samp, q0 = _numpy_draws(valid, cfg.max_iterations, cfg.sample_size, 4)
    samp_t = torch.from_numpy(samp)
    sol1, _, usable, _ = tkk.tk_factorize_ref(torch.from_numpy(obs[samp]), None,
                                              torch.from_numpy(q0), cfg)
    obs_t, valid_t = torch.from_numpy(obs), torch.from_numpy(valid)
    w, h = torch.full((views,), WIDTH), torch.full((views,), WIDTH)
    score_ref, n_ref = tkk.tk_score_ref(sol1, usable, obs_t, valid_t, w, h, samp_t, cfg)
    score, n_con = tkk.tk_score_host(sol1, usable, obs_t, valid_t, w, h, samp_t, cfg)
    _, err = tkk._triangulate_and_errors(sol1, obs_t, valid_t, w, h)
    assert bool(torch.isfinite(score_ref).any())
    _score_agreement(score, n_con, score_ref, n_ref, err, valid_t,
                     cfg.max_inlier_reprojection_error_px)


def test_score_arithmetic_other_image_sizes():
    """K6 with another width and height at each camera (each camera's
    pixels and image size scaled alike: the same normalized coordinates,
    so the same geometry), a consensus minimum no hypothesis reaches, and
    a model marked unusable."""
    cfg = RansacConfig(min_consensus_size=10_000)
    obs, valid = _group(1024, 1.0, seed=6)
    samp, q0 = _numpy_draws(valid, 64, 10, 7)
    sol1, _, usable, _ = tkk.tk_factorize_ref(torch.from_numpy(obs[samp]), None,
                                              torch.from_numpy(q0), cfg)
    usable[0] = False
    scale = np.array([[1.0, 0.75], [0.5, 0.5], [1.25, 1.0]], np.float32)
    obs = obs * scale[None]
    args = (sol1, usable, torch.from_numpy(obs), torch.from_numpy(valid),
            torch.from_numpy(WIDTH * scale[:, 0].copy()), torch.from_numpy(WIDTH * scale[:, 1].copy()),
            torch.from_numpy(samp))
    score_ref, n_ref = tkk.tk_score_ref(*args, cfg)
    score, n_con = tkk.tk_score_host(*args, cfg)
    _, err = tkk._triangulate_and_errors(args[0], *args[2:6])
    assert bool((score_ref == -torch.inf).all()) and bool((score == -torch.inf).all())
    _score_agreement(score, n_con, score_ref, n_ref, err, args[3],
                     cfg.max_inlier_reprojection_error_px)


# ---------------------------------------------------------------------------
# The wrappers on the CPU


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    """On CPU tensors the wrappers run their plain versions: the library is
    never built or loaded and no launch is counted."""
    def refuse():
        raise AssertionError("the CUDA library was loaded for CPU tensors")

    monkeypatch.setattr(tkk, "library", refuse)
    obs, valid = _group(512, 1.0)
    tkk.reset_launch_counts()
    res = tk.robust_factorization(torch.from_numpy(obs), torch.from_numpy(valid), WIDTH, WIDTH,
                                  RansacConfig(), generator=torch.Generator().manual_seed(0))
    assert bool(res.found) and res.model1.shape == (3, 3, 3)
    assert tkk.launch_counts() == {"tk_factorize": 0, "tk_score": 0}


def test_group_sizes_past_the_kernels_raise():
    """The kernels hold a problem in registers for groups of 2 to 4 views;
    another size raises, naming the bound, and is never handed to the plain
    version."""
    for G in tkk.KERNEL_GROUP_SIZES:
        tkk.check_group_size(G)
    for G in (1, 5, 8):
        with pytest.raises(ValueError, match="groups of 2 to 4 views"):
            tkk.check_group_size(G)


def test_host_build_is_a_library_of_its_own():
    """The host build of the CUDA source is named apart from the nvcc build
    (another compiler and flags)."""
    dev_lib = kernel_build.library_path(tkk.SOURCE)
    host_lib = kernel_build.library_path(tkk.SOURCE, host=True)
    assert dev_lib != host_lib and host_lib.parent == dev_lib.parent
    assert kernel_build._compiler(tkk.SOURCE, host=True)[1][-2:] == ("-x", "c++")


def test_per_camera_sizes_need_no_host_copy():
    """A number becomes a filled (G,) tensor, a tensor a broadcast view."""
    like = torch.zeros(1)
    assert torch.equal(tk.per_camera(2048.0, 3, like), torch.full((3,), 2048.0))
    x = torch.tensor([1.0, 2.0, 3.0])
    assert torch.equal(tk.per_camera(x, 3, like), x)


# ---------------------------------------------------------------------------
# On the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_group(dev, n_tracks, seed=0):
    obs, valid = _group(n_tracks, 1.0, seed=seed)
    return torch.from_numpy(obs).to(dev), torch.from_numpy(valid).to(dev)


@pytest.mark.cuda
def test_k5_matches_plain_version_on_the_card(dev):
    cfg = RansacConfig()
    obs, valid = _card_group(dev, 4096)
    samp, q0 = _numpy_draws(valid.cpu().numpy(), cfg.max_iterations, cfg.sample_size, 1)
    o, q0 = obs[torch.from_numpy(samp).to(dev)], torch.from_numpy(q0).to(dev)
    ref = tkk.tk_factorize_ref(o, None, q0, cfg)
    own = tkk.tk_factorize(o, None, q0, cfg)
    assert _rstar_up_to_signs(own[3], ref[3]) <= TOL_MODEL
    got = tkk.tk_factorize(o, None, q0, cfg, rstar=ref[3].contiguous())
    torch.cuda.synchronize()
    assert float((got[0] - ref[0]).abs().max()) <= TOL_MODEL
    assert float((got[1] - ref[1]).abs().max()) <= TOL_MODEL
    assert torch.equal(got[2], ref[2])


@pytest.mark.cuda
def test_k5_fallback_gram_route_on_the_card(dev):
    """The fallback over 50 000 tracks: the Gram by torch.matmul, then K5."""
    cfg = RansacConfig()
    obs, valid = _card_group(dev, 50000)
    q0 = torch.rand((1, 9), generator=torch.Generator(dev).manual_seed(0), device=dev) * 2 - 1
    ref = tkk.tk_factorize_ref(obs[None], valid[None], q0, cfg)
    own = tkk.tk_factorize(obs[None], valid[None], q0, cfg)
    assert _rstar_up_to_signs(own[3], ref[3]) <= TOL_MODEL
    got = tkk.tk_factorize(obs[None], valid[None], q0, cfg, rstar=ref[3].contiguous())
    assert float((got[0] - ref[0]).abs().max()) <= TOL_MODEL


@pytest.mark.cuda
@pytest.mark.parametrize("n_tracks", [4096, 50000])
def test_k6_matches_plain_version_on_the_card(dev, n_tracks):
    cfg = RansacConfig()
    obs, valid = _card_group(dev, n_tracks)
    samp, q0 = _numpy_draws(valid.cpu().numpy(), cfg.max_iterations, cfg.sample_size, 2)
    samp = torch.from_numpy(samp).to(dev)
    sol1, _, usable, _ = tkk.tk_factorize(obs[samp], None, torch.from_numpy(q0).to(dev), cfg)
    w = torch.full((3,), WIDTH, device=dev)
    score, n_con = tkk.tk_score(sol1, usable, obs, valid, w, w, samp, cfg)
    score_ref, n_ref = tkk.tk_score_ref(sol1, usable, obs, valid, w, w, samp, cfg)
    _, err = tkk._triangulate_and_errors(sol1, obs, valid, w, w)
    assert bool(torch.isfinite(score_ref).any())
    _score_agreement(score, n_con, score_ref, n_ref, err, valid,
                     cfg.max_inlier_reprojection_error_px)
    again = tkk.tk_score(sol1, usable, obs, valid, w, w, samp, cfg)
    assert torch.equal(again[0], score) and torch.equal(again[1], n_con)
    # a hypothesis's score does not depend on the launch's other hypotheses
    part = tkk.tk_score(sol1[7:90].contiguous(), usable[7:90].contiguous(), obs, valid, w, w,
                        samp[7:90].contiguous(), cfg)
    assert torch.equal(part[0], score[7:90]) and torch.equal(part[1], n_con[7:90])


@pytest.mark.cuda
def test_robust_factorization_on_the_card_makes_no_host_sync(dev, monkeypatch):
    """After a warm-up call that builds the kernels, a whole TK call runs
    under torch's sync debug mode ("error": a call that waits on the card
    raises), through K5 (the hypotheses, then the fallback) and K6 once,
    and never reaches a plain version."""
    obs, valid = _card_group(dev, 4096)
    w = torch.full((3,), WIDTH, device=dev)
    cfg = RansacConfig()
    tk.robust_factorization(obs, valid, w, w, cfg, generator=torch.Generator(dev).manual_seed(0))

    def plain(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(tkk, "tk_factorize_ref", plain)
    monkeypatch.setattr(tkk, "tk_score_ref", plain)
    gen = torch.Generator(dev).manual_seed(1)
    tkk.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = tk.robust_factorization(obs, valid, WIDTH, WIDTH, cfg, generator=gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert tkk.launch_counts() == {"tk_factorize": 2, "tk_score": 1}
    assert bool(res.found) and int(res.num_inliers) > 0.9 * int(valid.sum())
    assert bool(torch.isfinite(res.model1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["osfm_tk_factorize", "osfm_tk_score"])
def test_refused_launch_raises(dev, monkeypatch, kernel):
    """A launch the runtime refuses (the library answers 9,
    cudaErrorInvalidConfiguration) raises out of robust_factorization;
    nothing runs the plain version in its place."""
    real = tkk.library()

    class Refusing:
        def __getattr__(self, name):
            return getattr(real, name)

    setattr(Refusing, kernel, lambda self, *args: 9)
    monkeypatch.setattr(tkk, "library", lambda: Refusing())
    obs, valid = _card_group(dev, 1024)
    tkk.reset_launch_counts()
    name = kernel.removeprefix("osfm_")
    with pytest.raises(RuntimeError, match=f"{name}: CUDA error 9"):
        tk.robust_factorization(obs, valid, WIDTH, WIDTH, RansacConfig(),
                                generator=torch.Generator(dev).manual_seed(0))
    assert tkk.launch_counts()[name] == 0
