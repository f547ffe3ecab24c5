"""Parity of the port's Tomasi-Kanade RANSAC (orthosfm_torch/solvers/
tomasi_kanade.py, lm.py) with the JAX package's. torch cannot reproduce JAX's
random draws, so the JAX draws (sample indices and metric-upgrade inits) are
recomputed from the same keys and injected into the port; with them, both
must give the same model to 1e-4."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import n, t

from orthosfm_tpu.config import RansacConfig as JRansacConfig
from orthosfm_tpu.data import synthetic as jsyn
from orthosfm_tpu.solvers import lm as jlm
from orthosfm_tpu.solvers import tomasi_kanade as jtk

from orthosfm_torch.config import RansacConfig
from orthosfm_torch.solvers import lm
from orthosfm_torch.solvers import tomasi_kanade as tk


def _group(noise=0.0, views=(0, 1, 2)):
    ds = jsyn.generate_dataset(jsyn.sphere_cloud(300), num_views=6, seed=0)
    obs = np.asarray(ds.tracks.obs)[:, list(views)]
    if noise:
        obs = obs + noise * np.random.default_rng(1).standard_normal(obs.shape).astype(np.float32)
    valid = np.asarray(ds.tracks.alive).copy()
    valid[::13] = False
    return obs.astype(np.float32), valid


@functools.lru_cache(maxsize=None)
def _draws_program(cfg):
    """One jitted program per config: op by op, the vmapped hypotheses take
    seconds."""

    @jax.jit
    def draws(key, obs, valid):
        H = cfg.max_iterations
        keys = jax.random.split(key, H + 1)
        w = jnp.full(obs.shape[1], 2048.0)
        samp, score, n_con = jax.vmap(
            lambda k: jtk.score_hypothesis(k, obs, valid, w, w, cfg))(keys[:H])
        q0 = jax.vmap(lambda k: jax.random.uniform(jax.random.split(k)[1], (9,), minval=-1.0,
                                                   maxval=1.0))(keys[:H])
        q0_fb = jax.random.uniform(keys[H], (9,), minval=-1.0, maxval=1.0)
        return samp, q0, q0_fb, score, n_con

    return draws


def _jax_draws(key, obs, valid, cfg, with_scores=False):
    """The sample indices and inits robust_factorization draws from ``key``
    (and, with_scores, each hypothesis's score and consensus size)."""
    out = _draws_program(cfg)(key, jnp.asarray(obs), jnp.asarray(valid))
    return tuple(np.asarray(x) for x in (out if with_scores else out[:3]))


# Noise keeps the hypotheses' scores apart: on perfect tracks every
# hypothesis ties to within f32 rounding, and the two argmaxes may then pick
# different samples, whose mirror solutions differ.
@pytest.mark.parametrize("noise", [0.5, 2.0])
def test_robust_factorization_with_injected_draws_matches(noise):
    obs, valid = _group(noise)
    key = jax.random.PRNGKey(3)
    cfg = JRansacConfig()
    ref = jtk.robust_factorization(jnp.asarray(obs), jnp.asarray(valid), jnp.full(3, 2048.0),
                                   jnp.full(3, 2048.0), key, cfg=cfg)
    samp, q0, q0_fb = _jax_draws(key, obs, valid, cfg)
    got = tk.robust_factorization(t(obs), t(valid), 2048.0, 2048.0, RansacConfig(),
                                  samp_idx=t(samp, np.int64), q0=t(q0), q0_fallback=t(q0_fb))
    np.testing.assert_allclose(n(got.model1), n(ref.model1), atol=1e-4)
    np.testing.assert_allclose(n(got.model2), n(ref.model2), atol=1e-4)
    assert int(got.num_inliers) == int(ref.num_inliers)
    assert bool(got.found) == bool(ref.found)


def test_fallback_when_no_consensus_matches():
    """With an impossible consensus size every hypothesis fails and both fall
    back to factorizing all valid tracks."""
    obs, valid = _group()
    key = jax.random.PRNGKey(0)
    cfg = JRansacConfig(min_consensus_size=10_000)
    ref = jtk.robust_factorization(jnp.asarray(obs), jnp.asarray(valid), jnp.full(3, 2048.0),
                                   jnp.full(3, 2048.0), key, cfg=cfg)
    # the draws depend on the hypothesis count and sample size, not on the
    # consensus size
    samp, q0, q0_fb = _jax_draws(key, obs, valid, JRansacConfig())
    got = tk.robust_factorization(t(obs), t(valid), 2048.0, 2048.0,
                                  RansacConfig(min_consensus_size=10_000),
                                  samp_idx=t(samp, np.int64), q0=t(q0), q0_fallback=t(q0_fb))
    assert not bool(got.found) and not bool(ref.found)
    np.testing.assert_allclose(n(got.model1), n(ref.model1), atol=1e-4)
    assert int(got.num_inliers) == int(ref.num_inliers) == int(valid.sum())


def test_scores_match():
    obs, valid = _group(1.0)
    cfg = JRansacConfig()
    samp, q0, _, score, n_con = _jax_draws(jax.random.PRNGKey(7), obs, valid, cfg,
                                           with_scores=True)
    _, got_score, got_n, _, _ = tk.score_hypothesis(
        t(obs), t(valid), torch.full((3,), 2048.0), torch.full((3,), 2048.0), RansacConfig(),
        samp_idx=t(samp, np.int64), q0=t(q0))
    finite = np.isfinite(score)
    np.testing.assert_array_equal(np.isfinite(n(got_score)), finite)
    np.testing.assert_array_equal(n(got_n), np.asarray(n_con))
    np.testing.assert_allclose(n(got_score)[finite], score[finite], atol=1e-3)


def test_metric_upgrade_lm_matches():
    """lm.solve on the TK residual with its closed-form Jacobian against the
    JAX package's jacfwd LM, from the same inits."""
    obs, valid = _group()
    m = valid.astype(np.float32)
    D = -np.concatenate([obs[..., 0].T, obs[..., 1].T], axis=0)
    D = (D - (D * m).sum(1, keepdims=True) / m.sum()) * m
    RStar = np.linalg.svd(D, full_matrices=False)[0][:, :3].astype(np.float32)
    q0 = np.random.default_rng(0).uniform(-1, 1, (5, 9)).astype(np.float32)
    got, got_c = lm.solve(tk._tk_residual, t(q0), (t(np.broadcast_to(RStar, (5,) + RStar.shape)),))
    for b in range(5):
        ref, ref_c = jlm.solve(lambda q: jtk._tk_residual(jnp.asarray(RStar), q), q0[b], iters=40)
        np.testing.assert_allclose(n(got[b]), n(ref), atol=1e-4)
        np.testing.assert_allclose(float(got_c[b]), float(ref_c), atol=1e-8)


def test_resolve_ambiguity_and_usability_match():
    obs, valid = _group()
    key = jax.random.PRNGKey(1)
    ref = jtk.robust_factorization(jnp.asarray(obs), jnp.asarray(valid), jnp.full(3, 2048.0),
                                   jnp.full(3, 2048.0), key, cfg=JRansacConfig())
    m1, m2 = np.asarray(ref.model1), np.asarray(ref.model2)
    for gdir in (np.array([0.3, -0.2, 0.9], np.float32), np.array([-0.3, 0.2, -0.9], np.float32)):
        np.testing.assert_array_equal(
            n(tk.resolve_ambiguity(t(m1), t(m2), t(gdir))),
            np.asarray(jtk.resolve_ambiguity(m1, m2, gdir)))
    dup = np.stack([m1[0], m1[0], m1[2]])
    cfg = JRansacConfig()
    for model in (m1, dup):
        assert bool(tk.is_result_usable(t(model), RansacConfig())) == bool(
            jtk.is_result_usable(model, cfg))


def test_generator_draws_find_the_model():
    """Without injected draws the port samples from a torch.Generator: the
    same seed gives the same model, and noise-free tracks give full consensus."""
    obs, valid = _group()
    runs = [tk.robust_factorization(t(obs), t(valid), 2048.0, 2048.0, RansacConfig(),
                                    generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    np.testing.assert_array_equal(n(runs[0].model1), n(runs[1].model1))
    assert bool(runs[0].found) and int(runs[0].num_inliers) == int(valid.sum())
    samp, q0, q0_fb = tk.draw_hypotheses(t(valid), RansacConfig(), torch.Generator().manual_seed(0))
    s = n(samp)
    assert s.shape == (RansacConfig().max_iterations, RansacConfig().sample_size)
    assert valid[s].all()
    assert all(len(set(row)) == len(row) for row in s)
    assert float(q0.abs().max()) <= 1.0 and q0_fb.shape == (9,)
