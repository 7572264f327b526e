"""Three steps of the port's fused GAN train step against the JAX step, f32
on the CPU, with the same initial weights and batches.

The JAX step runs its Pallas kernels in interpret mode
(``grouped_conv_impl="pallas"``, ``fused_optimizer=True``); the port runs
its kernels' plain versions. The tiny configuration follows
tests/test_train_step.py, with a scale spec of two grouped stride-2 layers.

Tolerances and why:
* losses and metrics per step: rtol 1e-4 / atol 1e-6. Two f32 programs
  that sum in different orders agree to ~1e-6 relative on each op; the
  losses sum a few hundred thousand terms after tens of layers.
* parameters after 3 steps: rtol 1e-4 / atol 1e-5. One AdamW step moves a
  parameter by up to lr = 2e-4, so atol is a twentieth of one step: a wrong
  gradient sign, a missing step or a wrong bias correction fails it.
* spectral u/v: rtol 1e-4 / atol 1e-6 (unit vectors after 12 power
  iterations).
* counters: equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ste_gan_torch import constants as C
from ste_gan_torch import interop
from ste_gan_torch.config import Config as TConfig
from ste_gan_torch.models.discriminator import DiscriminatorEnsemble as TDisc
from ste_gan_torch.models.emg_encoder import EMGEncoderTransformer as TEnc
from ste_gan_torch.models.generator import EMGGeneratorGanTTS as TGen
from ste_gan_torch.train import gan as tgan
from ste_gan_tpu.config import Config as JConfig
from ste_gan_tpu.models.discriminator import DiscriminatorEnsemble as JDisc
from ste_gan_tpu.models.emg_encoder import EMGEncoderTransformer as JEnc
from ste_gan_tpu.models.generator import EMGGeneratorGanTTS as JGen
from ste_gan_tpu.train import gan as jgan

TINY_PERIOD_SPEC = ((8, 3, 1, 2), (16, 3, 3, 2))
TINY_SCALE_SPEC = ((8, 15, 1, 1, 7), (16, 9, 2, 4, 4), (32, 9, 2, 8, 4),
                   (32, 5, 1, 1, 2))
GEN_KW = dict(num_sessions=4, channels=32)
DISC_KW = dict(num_multi_pool=2, num_multi_scale=2,
               period_spec_override=TINY_PERIOD_SPEC,
               scale_spec_override=TINY_SCALE_SPEC)
ENC_KW = dict(model_size=32, num_extra_res_blocks=3, num_transformer_layers=1,
              num_heads=4, dim_feedforward=64, dropout=0.0)
STEPS = 3


def _tiny(cfg):
    cfg.train.chunk_size = 512
    cfg.train.batch_size = 4
    cfg.train.mixed_precision = False
    cfg.train.generator_ema = 0.999
    cfg.train.grouped_conv_impl = "pallas"
    cfg.train.fused_optimizer = True
    cfg.model.params = {"channels": 32}
    cfg.data.num_emg_sessions = 4
    return cfg


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    b, frames = cfg.train.batch_size, cfg.train.chunk_size // C.HOPSIZE
    return {
        C.DataType.REAL_EMG: np.tanh(rng.normal(
            0, 0.4, (b, cfg.train.chunk_size, 8))).astype(np.float32),
        C.DataType.SPEECH_UNITS: rng.normal(size=(b, frames, 256)).astype(
            np.float32),
        C.DataType.PHONEMES: rng.integers(0, C.NUM_PHONEMES,
                                          (b, frames)).astype(np.int32),
        C.DataType.SESSION_INDEX: rng.integers(0, 4, (b,)).astype(np.int32),
        C.DataType.SPEAKING_MODE_INDEX: np.zeros((b,), np.int32),
    }


@pytest.fixture(scope="module")
def runs():
    jcfg = _tiny(JConfig())
    jmodels = jgan.GANModels(JGen(**GEN_KW),
                             JDisc(conv_impl="pallas", **DISC_KW),
                             JEnc(**ENC_KW))
    enc_vars = jmodels.encoder.init(jax.random.PRNGKey(1),
                                    jnp.zeros((1, 512, 8)), train=False)
    jstate = jgan.init_state(jcfg, jmodels, jax.random.PRNGKey(0))

    tcfg = _tiny(TConfig())
    tmodels = tgan.GANModels(TGen(**GEN_KW), TDisc(**DISC_KW), TEnc(**ENC_KW))
    interop.load_generator(tmodels.generator, jstate.gen_params,
                           C.DataType.SPEECH_UNITS)
    interop.load_discriminator(tmodels.discriminator, jstate.disc_params,
                               jstate.disc_spectral)
    interop.load_encoder(tmodels.encoder, enc_vars)
    tmodels.encoder.eval().requires_grad_(False)
    tstate = tgan.init_state(tcfg, tmodels)

    jstep = jax.jit(jgan.make_train_step(jcfg, jmodels))
    tstep = tgan.make_train_step(tcfg, tmodels)
    jmetrics, tmetrics = [], []
    for i in range(STEPS):
        batch = _batch(jcfg, seed=10 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, enc_vars)
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        jmetrics.append({k: np.asarray(v) for k, v in jm.items()})
        tmetrics.append({k: v.numpy() for k, v in tm.items()})
    return jstate, jmetrics, tstate, tmodels, tmetrics


def test_metrics_match_every_step(runs):
    _, jmetrics, tstate, _, tmetrics = runs
    assert tstate.step == STEPS
    for i, (jm, tm) in enumerate(zip(jmetrics, tmetrics)):
        assert set(jm) == set(tm)
        for key in jm:
            if key.startswith("count/"):
                assert int(tm[key]) == int(jm[key]), (i, key)
            else:
                np.testing.assert_allclose(tm[key], jm[key], rtol=1e-4,
                                           atol=1e-6, err_msg=f"{i} {key}")


def _compare(got_sd, want_sd):
    assert set(got_sd) == set(want_sd)
    for key, want in want_sd.items():
        np.testing.assert_allclose(got_sd[key].detach().numpy(), want,
                                   rtol=1e-4, atol=1e-5, err_msg=key)


def test_generator_params_and_ema_after_three_steps(runs):
    jstate, _, tstate, tmodels, _ = runs
    _compare(tmodels.generator.state_dict(),
             interop.generator_params_to_state_dict(
                 jstate.gen_params, C.DataType.SPEECH_UNITS))
    names = [n for n, _ in tmodels.generator.named_parameters()]
    _compare(dict(zip(names, tstate.gen_ema)),
             interop.generator_params_to_state_dict(
                 jstate.gen_ema, C.DataType.SPEECH_UNITS))


def test_discriminator_params_and_spectral_state_after_three_steps(runs):
    jstate, _, _, tmodels, _ = runs
    params = dict(tmodels.discriminator.named_parameters())
    want = interop.discriminator_params_to_state_dict(
        jstate.disc_params, jstate.disc_spectral)
    _compare(params, {k: want[k] for k in params})
    spec = interop.spectral_to_jax(tmodels.discriminator)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), rtol=1e-4, atol=1e-6), spec,
        jax.tree.map(np.asarray, jstate.disc_spectral))


def test_optimizer_moments_after_three_steps(runs):
    jstate, _, tstate, tmodels, _ = runs
    assert int(tstate.opt_g.count) == int(jstate.opt_g.count) == STEPS
    names = [n for n, _ in tmodels.generator.named_parameters()]
    want = interop.generator_params_to_state_dict(jstate.opt_g.mu,
                                                  C.DataType.SPEECH_UNITS)
    got = dict(zip(names, tstate.opt_g.exp_avg))
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value, rtol=1e-3,
                                   atol=1e-6, err_msg=key)


def test_epoch_lr_and_learning_rate_write_match_jax():
    jcfg, tcfg = _tiny(JConfig()), _tiny(TConfig())
    for epoch in (0, 1, 10, 250):
        assert tgan.epoch_lr(tcfg, epoch) == jgan.epoch_lr(jcfg, epoch)
    opt = tgan.make_optimizer(tcfg, [torch.zeros(3)])
    tgan.set_learning_rate(opt, tgan.epoch_lr(tcfg, 10))
    assert float(opt.hyper[0]) == pytest.approx(2e-4 * 0.999 ** 10, rel=1e-6)
