"""The port's five loss families and the phoneme counters against the JAX
package, on the same numpy inputs (f32, CPU).

Tolerance rtol 1e-5 / atol 1e-6 on losses and on the TD loss gradient: the
same f32 arithmetic in two frameworks, differing only in summation order.
Counters are integers and must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ste_gan_torch import constants as C
from ste_gan_torch.losses import encoder_loss as tenc
from ste_gan_torch.losses import gan_loss as tgan
from ste_gan_torch.losses import td_loss as ttd
from ste_gan_tpu.losses import encoder_loss as jenc
from ste_gan_tpu.losses import gan_loss as jgan
from ste_gan_tpu.losses import td_loss as jtd

TOL = dict(rtol=1e-5, atol=1e-6)


def _fmaps(rng, n_disc=3, n_maps=3):
    return [[rng.normal(size=(2, 4, 10 + j)).astype(np.float32)
             for j in range(n_maps)] for _ in range(n_disc)]


def _t(tree):
    return [[torch.from_numpy(x) for x in fl] for fl in tree]


def _j(tree):
    return [[jnp.asarray(x) for x in fl] for fl in tree]


def test_adversarial_and_feature_matching_losses():
    rng = np.random.default_rng(0)
    fake, real = _fmaps(rng), _fmaps(rng)
    pairs = [
        (tgan.discriminator_loss(_t(fake), _t(real)),
         jgan.discriminator_loss(_j(fake), _j(real))),
        (tgan.generator_adversarial_loss(_t(fake)),
         jgan.generator_adversarial_loss(_j(fake))),
        (tgan.feature_matching_loss(_t(fake), _t(real)),
         jgan.feature_matching_loss(_j(fake), _j(real))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), **TOL)


def test_feature_matching_detaches_real_side():
    rng = np.random.default_rng(1)
    fake, real = _t(_fmaps(rng)), _t(_fmaps(rng))
    for fl in real:
        for x in fl:
            x.requires_grad_(True)
    loss = tgan.feature_matching_loss(fake, real)
    assert not loss.requires_grad


@pytest.mark.parametrize("window,stride", jtd.DEFAULT_TD_WINDOWS)
def test_time_domain_features(window, stride):
    x = np.tanh(np.random.default_rng(2).normal(0, 0.4, (2, 512, 8))
                ).astype(np.float32)
    want = jtd.time_domain_features(jnp.asarray(x), window, stride)
    got = ttd.time_domain_features(torch.from_numpy(x), window, stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_multi_td_loss_and_gradient():
    rng = np.random.default_rng(3)
    real = np.tanh(rng.normal(0, 0.4, (2, 512, 8))).astype(np.float32)
    fake = np.tanh(rng.normal(0, 0.4, (2, 512, 8))).astype(np.float32)
    want, want_grad = jax.value_and_grad(
        lambda f: jtd.multi_time_domain_loss(jnp.asarray(real), f))(
        jnp.asarray(fake))
    ft = torch.from_numpy(fake).requires_grad_(True)
    rt = torch.from_numpy(real).requires_grad_(True)
    got = ttd.multi_time_domain_loss(rt, ft)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(want_grad), **TOL)
    assert rt.grad is None


def test_encoder_losses_and_counters():
    rng = np.random.default_rng(4)
    b, t = 3, 16
    su_target = rng.normal(size=(b, t, 256)).astype(np.float32)
    su_pred = rng.normal(size=(b, t, 256)).astype(np.float32)
    logits = rng.normal(size=(b, t, C.NUM_PHONEMES)).astype(np.float32)
    targets = rng.integers(0, C.NUM_PHONEMES, (b, t)).astype(np.int32)
    targets[0, :5] = C.SILENCE_PHONEME_INDEX
    # Make some predictions right, silence included.
    logits[0, :3, C.SILENCE_PHONEME_INDEX] += 10.0
    logits[1, np.arange(t), targets[1]] += 10.0

    want = jenc.emg_encoder_loss(
        lambda e: (jnp.asarray(su_pred), jnp.asarray(logits)), None,
        jnp.asarray(su_target), jnp.asarray(targets))
    got = tenc.emg_encoder_loss(
        lambda e: (torch.from_numpy(su_pred), torch.from_numpy(logits)), None,
        torch.from_numpy(su_target), torch.from_numpy(targets))
    np.testing.assert_allclose(float(got[0]), float(want[0]), **TOL)
    np.testing.assert_allclose(float(got[1]), float(want[1]), **TOL)
    assert set(got[2]) == set(want[2])
    for key, value in want[2].items():
        assert got[2][key].dtype == torch.int32, key
        assert int(got[2][key]) == int(value), key
    assert int(got[2]["num_correct"]) >= t + 3
