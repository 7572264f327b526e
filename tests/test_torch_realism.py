"""The port's realism metrics (``ste_gan_torch/realism.py``) against the JAX
package's (``ste_gan_tpu/realism.py``) on the CPU.

The port imports no scipy: its Welch PSD is numpy (held to
``scipy.signal.welch`` through the JAX functions at rtol 1e-10) and its
Fréchet trace comes from ``eigh`` (held to ``scipy.linalg.sqrtm`` at rtol
1e-6 with at least ten frames per embedding dimension, where both are
well conditioned). Model outputs (TD features, embeddings) are held at
rtol 1e-3 / atol 2e-5 (tests/test_model_parity.py).

The one deliberate deviation: the port filters the utterance pairs once,
at ``max(hop, nperseg)`` samples, and feeds every statistic from that list;
the JAX package drops short utterances from its PSD path only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ste_gan_torch import evaluate as tev
from ste_gan_torch import interop
from ste_gan_torch import realism as TR
from ste_gan_torch.models.emg_encoder import EMGEncoderTransformer
from ste_gan_tpu import evaluate as jev
from ste_gan_tpu import realism as JR
from ste_gan_tpu.models.emg_encoder import EMGEncoderTransformer as JEncoder

from tests.test_torch_evaluate import runs  # noqa: F401 (fixture)

TOL = dict(rtol=1e-3, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _signals(rng, lengths, scale=1.0):
    return [np.tanh(scale * rng.normal(size=(n, 8))).astype(np.float32)
            for n in lengths]


def _linear_embed(dim=16, seed=5):
    """A cheap "embedding": the mean over each 16-sample hop and a fixed
    projection, shaped like ``embed_fn`` ([1, T, C] -> [1, T/16, D])."""
    proj = np.random.default_rng(seed).normal(size=(8, dim)).astype(np.float32)

    def fn(emg):
        x = np.asarray(emg)
        b, t, c = x.shape
        return x.reshape(b, t // 16, 16, c).mean(axis=2) @ proj

    return fn


def test_welch_matches_scipy():
    rng = np.random.default_rng(0)
    sigs = [rng.normal(size=(n, 8)) for n in (256, 257, 300, 511, 1000, 1601)]
    sigs.append(rng.normal(size=(200, 8)))  # below nperseg: skipped by both
    np.testing.assert_allclose(TR.average_psd(sigs), JR.average_psd(sigs),
                               rtol=1e-10, atol=0)
    got_psds, got_w = TR.per_utterance_psds(sigs)
    want_psds, want_w = JR.per_utterance_psds(sigs)
    assert got_psds.shape == want_psds.shape == (6, 129, 8)
    np.testing.assert_array_equal(got_w, want_w)
    np.testing.assert_allclose(got_psds, want_psds, rtol=1e-10, atol=0)
    with pytest.raises(ValueError, match="nperseg"):
        TR.welch_psd(sigs[-1])


def test_frechet_distance_matches_scipy():
    rng = np.random.default_rng(1)
    d = 16
    mix = rng.normal(size=(d, d))
    a = rng.normal(size=(20 * d, d)) @ mix
    b = rng.normal(0.3, 1.2, size=(10 * d, d)) @ mix + 0.5
    for x, y in ((a, b), (b, a), (a, a + 0.1 * rng.normal(size=a.shape))):
        want = JR.frechet_from_frames(x, y)
        np.testing.assert_allclose(TR.frechet_from_frames(x, y), want,
                                   rtol=1e-6)
    mu, cov = TR.gaussian_stats(a)
    assert abs(TR.frechet_distance(mu, cov, mu, cov)) < 1e-8
    # Diagonal covariances: |mu1-mu2|^2 + sum((s1-s2)^2).
    s1, s2 = np.array([1.0, 2.0, 0.5]), np.array([2.0, 1.0, 0.5])
    mu1, mu2 = np.zeros(3), np.array([1.0, 0.0, -2.0])
    got = TR.frechet_distance(mu1, np.diag(s1 ** 2), mu2, np.diag(s2 ** 2))
    assert abs(got - (np.sum((mu1 - mu2) ** 2) + np.sum((s1 - s2) ** 2))) < 1e-9


def test_td_wasserstein_matches_jax():
    rng = np.random.default_rng(2)
    real = _signals(rng, (400, 656, 1000))
    fake = _signals(rng, (400, 656, 1000), scale=1.5)
    for sigs in (real, fake):
        np.testing.assert_allclose(
            TR.pooled_td_features(sigs, device="cpu"),
            JR.pooled_td_features(sigs), **TOL)
    got = TR.td_wasserstein_report(TR.pooled_td_features(real, device="cpu"),
                                   TR.pooled_td_features(fake, device="cpu"))
    want = JR.td_wasserstein_report(JR.pooled_td_features(real),
                                    JR.pooled_td_features(fake))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)
    assert TR.wasserstein1(real[0], real[0]) < 1e-12


def test_fed_from_moments_and_lsd_from_psds_match_jax():
    rng = np.random.default_rng(3)
    emg_a = _signals(rng, [320 + 48 * i for i in range(10)])
    emg_b = _signals(rng, [320 + 48 * i for i in range(10)], scale=1.3)
    fn = _linear_embed()  # 16 dims, 10 utterances of >= 20 frames
    stats = {}
    for name, mod in (("port", TR), ("jax", JR)):
        stats[name] = [mod.embedding_moment_stats(fn, e, bucket_frames=4)
                       for e in (emg_a, emg_b)]
    assert sum(s[0] for s in stats["port"][0]) >= 10 * 16
    np.testing.assert_allclose(TR.fed_from_moments(*stats["port"]),
                               JR.fed_from_moments(*stats["jax"]), rtol=1e-6)
    idx = np.random.default_rng(4).integers(0, 10, size=10)
    np.testing.assert_allclose(TR.fed_from_moments(*stats["port"], idx),
                               JR.fed_from_moments(*stats["jax"], idx),
                               rtol=1e-6)
    # The moment path equals the frame path it resamples.
    np.testing.assert_allclose(
        TR.fed_from_moments(*stats["port"]),
        TR.frechet_from_frames(
            TR.encoder_frame_embeddings(fn, emg_a, bucket_frames=4),
            TR.encoder_frame_embeddings(fn, emg_b, bucket_frames=4)),
        rtol=1e-6)
    psd_a, w = TR.per_utterance_psds(emg_a)
    psd_b, _ = TR.per_utterance_psds(emg_b)
    jpsd_a, jw = JR.per_utterance_psds(emg_a)
    jpsd_b, _ = JR.per_utterance_psds(emg_b)
    np.testing.assert_allclose(TR.lsd_from_psds(psd_a, psd_b, w),
                               JR.lsd_from_psds(jpsd_a, jpsd_b, jw),
                               rtol=1e-10)
    np.testing.assert_allclose(TR.lsd_from_psds(psd_a, psd_b, w, idx),
                               JR.lsd_from_psds(jpsd_a, jpsd_b, jw, idx),
                               rtol=1e-10)


def test_bootstrap_matches_jax_with_the_same_seed():
    rng = np.random.default_rng(6)
    real = _signals(rng, [320] * 12)
    close = [np.tanh(np.arctanh(np.clip(x, -0.99, 0.99))
                     + rng.normal(0, 0.1, x.shape)).astype(np.float32)
             for x in real]
    far = _signals(rng, [320] * 12, scale=2.0)
    fn = _linear_embed(dim=8)
    out = {}
    for name, mod in (("port", TR), ("jax", JR)):
        m = [mod.embedding_moment_stats(fn, e, bucket_frames=4)
             for e in (real, close, far)]
        p = [mod.per_utterance_psds(e) for e in (real, close, far)]
        out[name] = mod.bootstrap_paired_realism_delta(
            *m, p[0][0], p[1][0], p[2][0], p[0][1], n_boot=40, seed=3)
    got, want = out["port"], out["jax"]
    assert got["n_utterances"] == want["n_utterances"] == 12
    assert got["n_boot"] == want["n_boot"] == 40
    for metric in ("fed", "lsd_db"):
        assert got[metric]["frac_a_better"] == want[metric]["frac_a_better"]
        np.testing.assert_allclose(
            [got[metric]["delta"], got[metric]["boot_mean"],
             *got[metric]["ci95"]],
            [want[metric]["delta"], want[metric]["boot_mean"],
             *want[metric]["ci95"]], rtol=0, atol=1e-4, err_msg=metric)
    with pytest.raises(ValueError, match="same utterances"):
        m = TR.embedding_moment_stats(fn, real, bucket_frames=4)
        psd, w = TR.per_utterance_psds(real[:-1])
        TR.bootstrap_paired_realism_delta(m, m, m, psd, psd, psd, w)


def test_embed_is_the_prehead_space():
    rng = np.random.default_rng(7)
    kw = dict(model_size=32, num_extra_res_blocks=3, num_transformer_layers=2,
              num_heads=4, dim_feedforward=64, dropout=0.0)
    jm = JEncoder(**kw)
    x = rng.normal(size=(2, 512, 8)).astype(np.float32)
    variables = jax.jit(lambda r: jm.init(r, jnp.asarray(x[:1]),
                                          train=False))(jax.random.PRNGKey(0))
    tm = EMGEncoderTransformer(**kw)
    interop.load_encoder(tm, variables)
    with torch.no_grad():
        emb = tm.embed(torch.from_numpy(x))
        su, _ = tm(torch.from_numpy(x))
        su_from_emb = emb @ tm.w_out.weight.T + tm.w_out.bias
    assert emb.shape == (2, 512 // 16, 32)
    np.testing.assert_allclose(su_from_emb.numpy(), su.numpy(), rtol=1e-5,
                               atol=1e-5)
    want = jax.jit(lambda v, e: jm.apply(v, e, method="embed"))(
        variables, jnp.asarray(x))
    np.testing.assert_allclose(emb.numpy(), np.asarray(want), **TOL)
    embed_fn = TR.encoder_embed_fn(tm)
    np.testing.assert_allclose(embed_fn(x[:1]), emb[:1].numpy(), rtol=0,
                               atol=1e-6)


def test_realism_section_matches_jax(runs):  # noqa: F811
    """Every valid utterance of the tiny run (34-60 frames, 544+ samples)
    passes both packages' filters, so the reports agree."""
    kw = dict(partition="valid", realism=True, bucket_frames=16)
    want = jev.evaluate_gan(*runs["jax"], **kw)["realism"]
    got = tev.evaluate_gan(*runs["port"], device="cpu", **kw)["realism"]
    assert got.keys() == want.keys()
    assert got["num_utterances"] == want["num_utterances"] == 5
    assert got["num_real"] == want["num_real"] == 5
    for key in want["td_wasserstein"]:
        np.testing.assert_allclose(got["td_wasserstein"][key],
                                   want["td_wasserstein"][key], **TOL)
    lsd, jlsd = got["log_spectral_distance"], want["log_spectral_distance"]
    np.testing.assert_allclose(lsd["mean_db"], jlsd["mean_db"], **TOL)
    np.testing.assert_allclose(lsd["per_channel_db"], jlsd["per_channel_db"],
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got["fed"], want["fed"], **TOL)


def test_a_short_utterance_leaves_every_statistic():
    """A 200-sample pair (12 frames, below nperseg 256) is dropped from the
    embedding, PSD and TD paths alike: the report equals the one without
    it. The JAX package keeps it in its embedding path only."""
    rng = np.random.default_rng(8)
    real = _signals(rng, (400, 656, 1000, 800))
    fake = _signals(rng, (400, 656, 1000, 800), scale=1.4)
    short_r, short_f = _signals(rng, (200, 200), scale=3.0)
    fn = _linear_embed(dim=4)
    kw = dict(embed_fn=fn, bucket_frames=4, device="cpu")
    with_short = TR.realism_from_signals(real + [short_r], fake + [short_f],
                                         **kw)
    without = TR.realism_from_signals(real, fake, **kw)
    assert with_short == without
    assert with_short["num_real"] == with_short["num_generated"] == 4
    kept_r, kept_f = TR.comparable_pairs(real + [short_r], fake + [short_f])
    assert len(kept_r) == len(kept_f) == 4
    jax_with = JR.realism_from_signals(real + [short_r], fake + [short_f],
                                       embed_fn=fn, bucket_frames=4)
    jax_without = JR.realism_from_signals(real, fake, embed_fn=fn,
                                          bucket_frames=4)
    assert (jax_with["log_spectral_distance"]
            == jax_without["log_spectral_distance"])
    assert jax_with["fed"] != jax_without["fed"]
